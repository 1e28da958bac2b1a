"""Resume in splice_tpu_torch (CPU): 6 steps with checkpoint_every 3
against 3 steps, then a run resumed from the checkpoint at step 3: losses,
rows and parameters bitwise equal, the checkpoints and the metrics records
(with Adam and the cosine schedule, RMSprop and plateau). A file of its
own, beside tests/test_torch_run.py, so that pytest-xdist's loadfile
spreads the two slow cases over another worker."""
import json
import os

import numpy as np
import pytest
import torch

from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.config import load_config
from splice_tpu_torch.data import ImagePair
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import init_vit_params

TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (see
    tests/test_torch_run.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h, w, seed):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    pair = ImagePair(A=torch.from_numpy(_img(70, 90, 2)),
                     B=torch.from_numpy(_img(80, 72, 3)), canvas_A=64,
                     canvas_B=64)
    vcfg = tvit.VitConfig(**TINY_VIT)
    ext = text.VitExtractor(
        params=init_vit_params(vcfg, seed=4, device="cpu"), cfg=vcfg)
    return pair, ext


def _run_cfg(**kw):
    return load_config(None, dict(
        vit_compute_dtype="float32", generator_compute_dtype="float32",
        dino_global_patch_size=32, device="cpu", seed=5, entire_A_every=4,
        log_images_freq=2, cls_warmup=1, n_epochs=6, **kw))


# (optimizer, policy): Adam's moments and step count, and plateau's state
# ride in the checkpoint
@pytest.mark.parametrize("optimizer,policy", [("adam", "cosine"),
                                              ("rmsprop", "plateau")])
def test_resume_matches_uninterrupted_run(tiny, tmp_path, optimizer,
                                          policy):
    pair, ext = tiny

    def run(root, steps, **kw):
        cfg = _run_cfg(optimizer=optimizer, scheduler_policy=policy,
                       checkpoint_every=3, **kw)
        return ttrainer.train_pair(cfg, steps, dataroot=str(root),
                                   pair=pair, extractor=ext)

    whole = run(tmp_path / "a", 6, checkpoint_dir=str(tmp_path / "ca"))
    first = run(tmp_path / "b", 3, checkpoint_dir=str(tmp_path / "cb"))
    assert sorted(os.listdir(tmp_path / "cb")) == ["ckpt_3.pt"]
    rest = run(tmp_path / "b", 6, resume_from=str(tmp_path / "cb"))
    assert rest["first_step"] == 3 and len(rest["losses"]) == 3
    assert first["losses"] + rest["losses"] == whole["losses"]
    np.testing.assert_array_equal(
        np.concatenate([first["rows"], rest["rows"]]), whole["rows"])
    assert torch.equal(rest["trainer"].flat, whole["trainer"].flat)
    assert torch.equal(rest["output_u8"], whole["output_u8"])
    assert sorted(os.listdir(tmp_path / "ca")) == ["ckpt_3.pt", "ckpt_6.pt"]
    recs = [json.loads(line) for line in
            (tmp_path / "a" / "out" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 3, 5]
    assert recs[-1]["loss"] == whole["losses"][-1]["loss"]
    for r in recs:
        assert set(r) >= {"t", "lr", "steps_per_sec", *ttrainer.LOSS_KEYS}
