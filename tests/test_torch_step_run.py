"""train_pair and the CLI of splice_tpu_torch on the CPU, at the tiny
shapes of tests/test_torch_step.py: the loss falls over six steps and a
seeded run repeats bitwise; the CLI trains and writes its output. A file
of its own, beside tests/test_torch_step.py, so that pytest-xdist's
loadfile gives these slow tests another worker."""
import numpy as np
import pytest
import torch
from PIL import Image

from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.data import ImagePair
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import vit_params_from_numpy
from test_torch_step import CANVAS, TINY_VIT, _cfg, setup  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (see
    tests/test_torch_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(setup, tmp_path, n_steps, seed=5):
    A, B, jvp, _, _ = setup
    square = np.ascontiguousarray(A[:64, :64])
    pair = ImagePair(A=torch.from_numpy(square),
                     B=torch.from_numpy(np.ascontiguousarray(B[:64, :64])),
                     canvas_A=CANVAS, canvas_B=CANVAS)
    ext = text.VitExtractor(params=vit_params_from_numpy(jvp),
                            cfg=tvit.VitConfig(**TINY_VIT))
    # min_cover 1 on square 64-px images: every crop is the whole image
    cfg = _cfg(seed=seed, entire_A_every=1000, log_images_freq=3,
               global_A_crops_min_cover=1.0, global_B_crops_min_cover=1.0)
    return ttrainer.train_pair(cfg, n_steps, dataroot=str(tmp_path),
                               pair=pair, extractor=ext)


def test_loss_falls_and_seeded_run_repeats(setup, tmp_path):
    a = _train(setup, tmp_path, 6)
    b = _train(setup, tmp_path, 6)
    la = [s["loss"] for s in a["losses"]]
    assert la == [s["loss"] for s in b["losses"]]
    assert la[-1] < la[1]              # step 0 is an entire-A step
    assert torch.equal(a["trainer"].flat, b["trainer"].flat)
    assert (tmp_path / "out" / "output.png").exists()
    assert a["output"].shape == (64, 64, 3)


def test_cli_runs_on_cpu(tmp_path):
    rng = np.random.default_rng(1)
    for sub, hw in (("A", (64, 80)), ("B", (72, 64))):
        (tmp_path / sub).mkdir()
        Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(
            tmp_path / sub / "img.png")
    from splice_tpu_torch import train
    train.main(["--dataroot", str(tmp_path), "--n_epochs", "2", "--device",
                "cpu", "--dino_model_name", "dino_vits8",
                "--dino_global_patch_size", "32", "--seed", "1",
                "--vit_compute_dtype", "float32",
                "--generator_compute_dtype", "float32"])
    assert (tmp_path / "out" / "output.png").exists()
