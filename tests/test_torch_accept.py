"""The port's acceptance run (splice_tpu_torch/tools/accept.py) against the
reference's protocol (scripts/accept.py), on the CPU.

  * score_pair against splice_tpu.tools.evaluate's psnr, ssim and lpips
    (seeded AlexNet and LPIPS heads) on the same two PNGs: the reference's
    numbers at the report's rounding, one unit of its last decimal apart
    at most (LPIPS: fp32 convolutions in another order);
  * the command end to end on both bundled pairs (temporary copies) from a
    seeded dino_vits8 .pth, 2 steps at 48 px through the port's weight
    port and CLI trainer in their own processes: exit 0, pass null, the
    reference's report keys, each pair trained with its reference output
    missing and named;
  * a run whose one pair compares against a different image with LPIPS
    weights: exit 1, pass false;
  * a run whose training fails: exit 2, trained false.
Phase 16 of chip_smoke.py runs the command on the card at full width.
"""
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import golden_vit
from child_deadline import deadline
from splice_tpu.tools import evaluate as jeval
from splice_tpu_torch.tools import accept

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPORT_KEYS = {"checkpoint", "model_name", "n_epochs", "pairs", "pass",
               "lpips_threshold"}
TRAIN_ARGS = ("--A_resize 48 --B_resize 48 --seed 9 --entire_A_every 100 "
              "--log_images_freq 3 --vit_compute_dtype float32 "
              "--use_pallas_attention false --dino_global_patch_size 32 "
              "--dino_global_max_size 64")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the run's child processes (six
    xdist workers share the host)."""
    n = torch.get_num_threads()
    env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _lpips_weights(seed):
    rng = np.random.default_rng(seed)
    shapes = {"conv1": (64, 3, 11, 11), "conv2": (192, 64, 5, 5),
              "conv3": (384, 192, 3, 3), "conv4": (256, 384, 3, 3),
              "conv5": (256, 256, 3, 3)}
    w = {}
    for i, (name, s) in enumerate(shapes.items()):
        w[f"{name}_w"] = (rng.standard_normal(s)
                          / np.sqrt(s[1] * s[2] * s[3])).astype(np.float32)
        w[f"{name}_b"] = (0.1 * rng.standard_normal(s[0])).astype(np.float32)
        w[f"lin{i + 1}_w"] = rng.random((1, s[0])).astype(np.float32)
    return w


def _png(path, hw, seed):
    rng = np.random.default_rng(seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(path)
    return path


def test_score_pair_matches_reference_evaluate(tmp_path):
    a = _png(tmp_path / "a.png", (64, 72), 1)
    b = _png(tmp_path / "b.png", (64, 72), 2)
    w = tmp_path / "w.npz"
    np.savez(w, **_lpips_weights(3))
    got = accept.score_pair(a, b, str(w), "cpu")
    x, y = jeval.load01(str(a)), jeval.load01(str(b))
    want = {"psnr": jeval.psnr(x, y), "ssim": jeval.ssim(x, y),
            "lpips": jeval.lpips(x, y, dict(np.load(w)))}
    for key, unit in (("psnr", 1e-3), ("ssim", 1e-4), ("lpips", 1e-4)):
        assert abs(got[key] - want[key]) <= unit, (key, got, want)
    assert got["lpips_pass"] == (got["lpips"] <= accept.LPIPS_THRESHOLD)
    same = accept.score_pair(a, a, str(w), "cpu")
    assert same["psnr"] == float("inf") and same["ssim"] == 1.0
    assert same["lpips"] == 0.0 and same["lpips_pass"] is True
    bare = accept.score_pair(a, b, None, "cpu")
    assert bare["lpips"] is None and "lpips_weights" in \
        bare["blocking_artifact"]
    c = _png(tmp_path / "c.png", (64, 80), 4)
    assert "shape mismatch" in accept.score_pair(a, c, None, "cpu")["error"]


def _pairs(tmp_path, names):
    root = tmp_path / "ds"
    for name in names:
        src = ROOT / "datasets" / "splicing" / name
        for side in ("A", "B"):
            shutil.copytree(src / side, root / name / side)
    return root


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded dino_vits8 checkpoint in DINO's key layout (the JAX
    pipeline test's generator)."""
    path = tmp_path_factory.mktemp("ckpt") / "dino_vits8.pth"
    torch.save({k: torch.from_numpy(v) for k, v in
                golden_vit.make_state(seed=5, dim=384).items()}, path)
    return path


def _run(tmp_path, checkpoint, root, pairs, train_args=TRAIN_ARGS,
         extra=()):
    out = tmp_path / "accept_torch.json"
    # each run trains in child processes: 10-45 s on a loaded host
    with deadline(300):
        code = accept.main(
            ["--checkpoint", str(checkpoint), "--model_name", "dino_vits8",
             "--n_epochs", "2", "--pairs", *pairs, "--datasets_root",
             str(root), "--train_args", train_args, "--out", str(out),
             "--vit_npz", str(tmp_path / "vit.npz"), "--device", "cpu",
             *extra])
    return code, json.loads(out.read_text())


def test_end_to_end_on_both_pairs(tmp_path, checkpoint):
    root = _pairs(tmp_path, accept.PAIRS)
    code, report = _run(tmp_path, checkpoint, root, accept.PAIRS)
    assert code == 0
    assert set(report) == REPORT_KEYS
    assert report["pass"] is None and report["lpips_threshold"] == 0.05
    assert report["n_epochs"] == 2 and report["model_name"] == "dino_vits8"
    assert (tmp_path / "vit.npz").exists()      # the port really ran
    assert sorted(report["pairs"]) == sorted(accept.PAIRS)
    for name, entry in report["pairs"].items():
        assert set(entry) == {"dataroot", "trained", "train_wall_s",
                              "output", "ref_available",
                              "blocking_artifact"}
        assert entry["trained"] is True and entry["ref_available"] is False
        assert "ref/output.png" in entry["blocking_artifact"]
        out = np.asarray(Image.open(entry["output"]))
        assert out.shape[2] == 3 and min(out.shape[:2]) == 48   # A_resize


def test_failed_comparison_exits_1(tmp_path, checkpoint):
    root = _pairs(tmp_path, ["cows"])
    _png(root / "cows" / "ref" / "output.png", (48, 64), 7)
    w = tmp_path / "w.npz"
    np.savez(w, **_lpips_weights(8))
    code, report = _run(tmp_path, checkpoint, root, ["cows"],
                        extra=("--lpips_weights", str(w)))
    entry = report["pairs"]["cows"]
    assert code == 1 and report["pass"] is False
    assert entry["ref_available"] is True and entry["lpips_pass"] is False
    assert entry["lpips"] > accept.LPIPS_THRESHOLD
    assert np.isfinite(entry["psnr"]) and 0.0 < abs(entry["ssim"]) < 1.0


def test_failed_training_is_a_pipeline_error(tmp_path, checkpoint):
    root = _pairs(tmp_path, ["cows"])
    code, report = _run(tmp_path, checkpoint, root, ["cows"],
                        train_args=TRAIN_ARGS + " --generator_conv bogus")
    assert code == 2 and report["pass"] is None
    entry = report["pairs"]["cows"]
    assert entry["trained"] is False and "returned non-zero" in \
        entry["error"]
