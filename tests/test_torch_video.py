"""splice_tpu_torch's video mode against splice_tpu's: load_video_frames,
and a two-frame clip on the CPU (48 px, dino_vits8 with seeded weights,
32-px loss resolution, fp32, no augmentation), as
tests/test_tools.py::TestVideoMode runs the reference's.

The warm frame starts from the first frame's final parameters, bitwise,
with a fresh optimizer state and the draws restarted from the seed, on the
first frame's program, whose rows (two: the first frame's longest chunk)
cut the warm frame's three-step chunk. Its first step (an entire-A step) from those
parameters and draws gives each loss term within rtol 1e-4 of the JAX
package's composition of the same step (fp32 through a 12-block ViT and
the default generator; the terms are means over O(10^3) products each
rounded in another order).
"""
import os
import pathlib
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from PIL import Image

from splice_tpu import losses as jlosses
from splice_tpu import video as jvideo
from splice_tpu.data import load_video_frames as j_load_video_frames
from splice_tpu.models import extractor as jext
from splice_tpu.models import unet as junet
from splice_tpu.models import vit as jvit
from splice_tpu.ops import image as jimg
from splice_tpu_torch import train as ttrain
from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch import video as tvideo
from splice_tpu_torch.config import load_config
from splice_tpu_torch.data import load_video_frames
from splice_tpu_torch.utils.tree import tree_map
from splice_tpu_torch.video import train_video

SRC = pathlib.Path("datasets/splicing/cows")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(root: pathlib.Path) -> None:
    """Two identical frames of the cows A against the cows B."""
    (root / "A").mkdir(parents=True)
    (root / "B").mkdir()
    a_img = SRC / "A" / sorted(os.listdir(SRC / "A"))[0]
    for i in range(2):
        shutil.copy(a_img, root / "A" / f"frame_{i:03d}.jpg")
    shutil.copy(SRC / "B" / sorted(os.listdir(SRC / "B"))[0], root / "B")


def _cfg(root, **kw):
    return load_config(None, dict(
        dataroot=str(root), A_resize=48, B_resize=48, seed=5, n_epochs=4,
        entire_A_every=100, log_images_freq=2, vit_compute_dtype="float32",
        generator_compute_dtype="float32", dino_model_name="dino_vits8",
        dino_global_patch_size=32, dino_global_max_size=64,
        use_augmentations=False, device="cpu", **kw))


def test_load_video_frames_matches(tmp_path):
    _clip(tmp_path)
    (tmp_path / "A" / ".hidden.jpg").write_bytes(b"")
    (tmp_path / "A" / "notes.txt").write_text("not a frame")
    cfg = _cfg(tmp_path)
    got = [(n, p.to("cpu")) for n, p in load_video_frames(cfg)]
    want = list(j_load_video_frames(cfg))
    assert [n for n, _ in got] == [n for n, _ in want] == [
        "frame_000.jpg", "frame_001.jpg"]
    assert got[0][1].B is got[1][1].B          # B loaded once
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.A.numpy(), np.asarray(w.A))
        np.testing.assert_array_equal(g.B.numpy(), np.asarray(w.B))
        assert (g.canvas_A, g.canvas_B) == (w.canvas_A, w.canvas_B)


def test_cli_dispatches_video_mode(monkeypatch):
    calls = []
    monkeypatch.setattr(ttrain, "train_video", calls.append)
    monkeypatch.setattr(ttrain, "train_pair", None)   # never reached
    ttrain.main(["--dataroot", "clip", "--video_mode", "true",
                 "--device", "cpu"])
    assert len(calls) == 1 and calls[0].video_mode
    assert calls[0].dataroot == "clip" and calls[0].video_log_frames_only


@pytest.mark.parametrize("prefetch", [jvideo._prefetch, tvideo._prefetch],
                         ids=["reference", "port"])
def test_prefetch_raises_what_the_loader_raises(prefetch):
    """A loader that exits (SystemExit, not an Exception) after one frame:
    the consumer gets the frame, then the SystemExit, within seconds (the
    loader's thread must hand it over, or the consumer waits forever)."""
    def frames():
        yield 1
        raise SystemExit(3)

    got = []

    def consume():
        try:
            for item in prefetch(frames()):
                got.append(item)
        except SystemExit as e:
            got.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive(), "the consumer still waits on the loader"
    assert got[0] == 1 and isinstance(got[1], SystemExit)
    assert got[1].code == 3


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("vid")
    _clip(root)
    cfg = _cfg(root)
    results = []
    out = train_video(cfg, first_frame_steps=4, warm_frame_steps=4,
                      on_frame=lambda i, res: results.append(res))
    return root, cfg, out, results


def test_two_frame_warm_start(clip):
    root, _, out, results = clip
    assert [f["steps"] for f in out["frames"]] == [4, 4]
    for i in range(2):
        png = np.asarray(Image.open(root / "out" / f"frame_00{i}_out.png"))
        assert png.shape == (48, 64, 3)
        np.testing.assert_array_equal(png, results[i]["output_u8"].numpy())
    first, warm = results
    assert warm["program"] is first["program"]
    assert first["chunks"] == [1, 1, 2]
    # warm frames log at their end only: one chunk of 3, cut at 2 rows
    assert warm["chunks"] == [1, 2, 1]
    assert warm["output"] is None               # want_output=False
    start = warm["start_state"]
    assert torch.equal(start["flat"], first["flat"])
    assert set(start) == {"flat", "step", "exp_avg", "exp_avg_sq"}
    assert all(not v.any() for k, v in start.items() if k != "flat")
    # the draws restart from the seed: identical frames, identical rows
    np.testing.assert_array_equal(warm["rows"][0], first["rows"][0])
    assert torch.equal(out["params"], warm["flat"])
    assert all(np.isfinite(list(l.values())).all()
               for r in results for l in r["losses"])


def _jax_losses(cfg, pair, vit_params, flat, row, step):
    """The step's loss terms by the JAX package's public functions, from
    the port's generator parameters `flat` and the draws of `row`."""
    lam_t, draws = ttrainer.unpack_row(cfg, torch.from_numpy(row))
    gcfg = junet.SkipConfig()
    _, unravel = ravel_pytree(junet.init_skip_params(jax.random.PRNGKey(0),
                                                     gcfg))
    params = unravel(jnp.asarray(flat))
    ext = jext.VitExtractor(params=jax.tree.map(jnp.asarray, vit_params),
                            cfg=jvit.get_vit_config("dino_vits8"))
    A, B = jnp.asarray(pair.A.numpy()), jnp.asarray(pair.B.numpy())
    canvas = pair.canvas_A

    def crops(img, side, tops, lefts):
        return jnp.stack([jimg.crop_and_resize(img, float(t), float(l),
                                               float(side), canvas)
                          for t, l in zip(tops, lefts)])

    def tf(x):
        return jimg.imagenet_normalize(jimg.dino_global_resize(x, 32, 64))

    def g(x):
        return junet.skip_apply_chw(params, gcfg, x, None, conv_impl="xla")

    lam = jlosses.lambdas_for_step(cfg, step)
    assert np.array_equal(lam_t.numpy(), ttrainer.lambdas_array(lam))

    @jax.jit
    def losses(A, B):
        cA, cB = crops(A, *draws.crops_A), crops(B, *draws.crops_B)
        parts, aux = jlosses.splice_losses_fused(ext, tf(g(cA)), tf(cA),
                                                 tf(g(cB)), tf(cB))
        if jlosses.is_entire_step(cfg, step):
            parts.update(jlosses.entire_losses_fused(
                ext, tf(g(A[None])), tf(A[None]), aux["cls_B"]))
        parts["loss"] = jlosses.weighted_total(parts, lam)
        return parts

    parts = losses(A, B)
    return {k: float(v) for k, v in parts.items()}


def test_warm_step_matches_the_jax_step(clip):
    _, cfg, _, (first, warm) = clip
    vit_params = tree_map(lambda t: t.numpy(),
                          warm["trainer"].extractor.params)
    want = _jax_losses(cfg, warm["trainer"].pair, vit_params,
                       first["flat"].numpy(), warm["rows"][0], 0)
    got = warm["losses"][0]
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
