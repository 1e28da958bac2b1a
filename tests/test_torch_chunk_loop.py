"""train_pair's chunk loop on the CPU (splice_tpu_torch.trainer) against
eager SpliceTrainer.step calls from the same seed, draws and lambdas, with
the augmentations on: per-step losses and final parameters, bitwise. A
file of its own, beside tests/test_torch_chunk.py, so that
pytest-xdist's loadfile gives this slow test its own worker."""
import pytest
import torch

from splice_tpu_torch import losses as tlosses
from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.config import load_config
from splice_tpu_torch.data import ImagePair
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import init_vit_params
from test_torch_chunk import _img


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (see
    tests/test_torch_chunk.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)


def test_cpu_chunk_loop_matches_eager_steps_bitwise(tmp_path):
    """train_pair (chunks E0, 1-3, E4, 5) against six eager steps from the
    same seed, draws and lambdas, with the augmentations on."""
    pair = ImagePair(A=torch.from_numpy(_img(70, 90, 2)),
                     B=torch.from_numpy(_img(80, 72, 3)), canvas_A=64,
                     canvas_B=64)
    vcfg = tvit.VitConfig(**TINY_VIT)
    ext = text.VitExtractor(
        params=init_vit_params(vcfg, seed=4, device="cpu"), cfg=vcfg)
    cfg = load_config(None, dict(
        vit_compute_dtype="float32", generator_compute_dtype="float32",
        dino_global_patch_size=32, device="cpu", seed=5, entire_A_every=4,
        log_images_freq=4, cls_warmup=1))
    res = ttrainer.train_pair(cfg, 6, dataroot=str(tmp_path), pair=pair,
                              extractor=ext)
    assert res["chunks"] == [1, 3, 1, 1]
    eager = ttrainer.SpliceTrainer(cfg, pair, ext, seed=5)
    gen = torch.Generator().manual_seed(5)
    for i, got in enumerate(res["losses"]):
        parts = eager.step(ttrainer.sample_step_draws(cfg, pair, gen),
                           tlosses.lambdas_for_step(cfg, i),
                           tlosses.is_entire_step(cfg, i))
        assert got == ttrainer.fetch_scalars(
            {k: parts[k] for k in ttrainer.LOSS_KEYS}), i
    assert torch.equal(res["trainer"].flat, eager.flat)
    assert res["losses"][0]["loss_entire_ssim"] > 0
    assert res["losses"][1]["loss_entire_ssim"] == 0
