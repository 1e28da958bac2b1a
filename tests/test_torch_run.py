"""The run around the step in splice_tpu_torch, against splice_tpu: the
schedulers, the optimizers, the inits, the device uint8 render, the config
keys, resume and the elastic relaunch.

  * Scheduler.lr_for_step against splice_tpu.trainer.Scheduler for every
    policy over steps 0-400 (equal floats), plateau's state over one loss
    sequence; device_lr against the reference's device_lr_fn (jitted on
    the CPU): bitwise, every step;
  * three RMSprop and three SGD updates of a seeded vector, the lr changed
    between them, against the reference's optax optimizers: rtol 1e-6 of
    the operands each parameter has summed (|p0| + |update 1| + ...);
  * the inits by their laws: each conv kernel's sample std within five
    standard errors of the law's, BN scales N(1, gain^2), and W W^T =
    gain^2 I over the smaller side for orthogonal, cout above and below
    fan_in;
  * ops.image.tensor2im against splice_tpu.ops.image.tensor2im: bitwise;
  * every config key both packages have: the same default;
  * resume: in tests/test_torch_run_resume.py;
  * train_model's callback and the metrics records;
  * the elastic relaunch: a CLI run with max_restarts 1 whose first
    attempt raises at fault_inject_step, in child processes, finishes.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from child_deadline import deadline
from splice_tpu import trainer as jtrainer
from splice_tpu.config import Config as JConfig
from splice_tpu.ops import image as jimg
from splice_tpu_torch import train as ttrain
from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.config import (INIT_TYPES, OPTIMIZERS,
                                     SCHEDULER_POLICIES)
from splice_tpu_torch.config import Config as TConfig
from splice_tpu_torch.config import load_config
from splice_tpu_torch.data import ImagePair
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import init_vit_params
from splice_tpu_torch.ops import image as timg
from splice_tpu_torch.utils.io import AsyncImageSaver

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work, in this process
    and in the relaunch test's child processes: pytest-xdist runs six
    workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
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


# the reference's defaults, and a run of 300 steps whose schedules all
# change inside steps 0-400
SCHEDULES = [dict(), dict(n_epochs=300, scheduler_n_epochs_decay=150,
                          scheduler_lr_decay_iters=40, lr=1e-3)]


@pytest.mark.parametrize("kw", SCHEDULES)
@pytest.mark.parametrize("policy", SCHEDULER_POLICIES)
def test_scheduler_matches_reference(policy, kw):
    jc = JConfig(scheduler_policy=policy, **kw)
    tc = TConfig(scheduler_policy=policy, **kw)
    js, ts = jtrainer.Scheduler(jc), ttrainer.Scheduler(tc)
    steps = range(401)
    if policy == "plateau":
        # falls, stalls for more than the patience twice, falls again
        seq = [5.0, 4.0, 3.9, 3.95, 3.97, 3.96, 3.99, 3.98, 3.97, 3.96,
               4.1, 3.9, 3.95, 3.94, 3.93, 3.92, 3.91, 3.0, 2.0]
        for loss in seq:
            js.observe(loss)
            ts.observe(loss)
            assert ts.lr_for_step(0) == js.lr_for_step(0)
            assert ts.state_dict() == {k: v.item() for k, v in
                                       js.state_dict().items()}
        assert ts.lr_for_step(0) == pytest.approx(jc.lr * 0.04)
    assert [ts.lr_for_step(i) for i in steps] == \
        [js.lr_for_step(i) for i in steps]
    if policy in ("none", "plateau"):
        assert ttrainer.chunk_lrs(tc, ts, 7, 3) == \
            [np.float32(js.lr_for_step(7))] * 3
        return
    ref = np.asarray(jax.jit(jax.vmap(jtrainer.device_lr_fn(jc)))(
        jnp.arange(401, dtype=jnp.int32)))
    got = np.asarray(ttrainer.chunk_lrs(tc, ts, 0, 401), np.float32)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _optax_updates(name, p0, grads, lrs):
    tx = jtrainer.make_optimizer(JConfig(optimizer=name))
    p = jnp.asarray(p0)
    state = tx.init(p)
    out = []
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        out.append(np.asarray(p))
    return out


@pytest.mark.parametrize("name", ["rmsprop", "sgd"])
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal(4096).astype(np.float32)
    # gradients of every size, a few exactly zero
    grads = [(rng.standard_normal(4096)
              * 10.0 ** rng.uniform(-6, 1, 4096)).astype(np.float32)
             for _ in range(3)]
    grads[1][::97] = 0.0
    lrs = [2e-3, 1.5e-3, 1e-3]
    want = _optax_updates(name, p0, grads, lrs)
    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    lr = torch.tensor(0.0)
    opt = ttrainer.make_optimizer(TConfig(optimizer=name), [p], lr)
    # rtol 1e-6 of the operands summed so far, |p0| + |update 1| + ...:
    # XLA's CPU rsqrt and torch's round an ulp apart, and a parameter that
    # an update nearly cancels shows that at more than 1e-6 of its own size
    prev, scale = p0, np.abs(p0)
    for g, step_lr, w in zip(grads, lrs, want):
        p.grad = torch.from_numpy(g)
        lr.fill_(step_lr)
        opt.step()
        scale = scale + np.abs(w - prev)
        assert (np.abs(p.detach().numpy() - w) <= 1e-6 * scale).all()
        prev = w


def _kernels(tree):
    return [(path, t) for path, t in tunet._leaves(tree)
            if path[-1] == "kernel"]


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_init_follows_its_law(init_type):
    gain = 0.02
    tree = tunet.init_skip_params(tunet.SkipConfig(), gain, seed=3,
                                  device="cpu", init_type=init_type)
    z = []
    shapes = set()
    for path, w in _kernels(tree):
        kh, kw, cin, cout = w.shape
        fan_in, fan_out = cin * kh * kw, cout * kh * kw
        mat = w.permute(3, 2, 0, 1).reshape(cout, fan_in).double()
        if init_type == "orthogonal":
            small = mat @ mat.T if cout <= fan_in else mat.T @ mat
            eye = torch.eye(min(cout, fan_in), dtype=torch.float64)
            assert torch.allclose(small, gain ** 2 * eye,
                                  atol=1e-6 * gain ** 2), path
            shapes.add(cout > fan_in)
            continue
        std = {"normal": gain,
               "xavier": gain * math.sqrt(2.0 / (fan_in + fan_out)),
               "kaiming": math.sqrt(2.0 / fan_in)}[init_type]
        n = w.numel()
        s = w.double().std().item()
        assert abs(s / std - 1.0) <= 5.0 / math.sqrt(2 * n), (path, s, std)
        assert abs(w.double().mean().item()) <= 5.0 * std / math.sqrt(n)
        z.append(w.double().flatten() / std)
    if init_type == "orthogonal":
        assert shapes == {False, True}       # both sides of the square
    else:
        z = torch.cat(z)
        assert abs(z.std().item() - 1.0) <= 5.0 / math.sqrt(2 * len(z))
    scales = torch.cat([t for path, t in tunet._leaves(tree)
                        if path[-1] == "scale"]).double()
    assert abs(scales.mean().item() - 1.0) <= 5 * gain / math.sqrt(
        len(scales))
    assert abs(scales.std().item() / gain - 1.0) <= 5 / math.sqrt(
        2 * len(scales))


def test_tensor2im_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 1.5, (37, 41, 3)).astype(np.float32)
    x[0, :, 0] = np.arange(41, dtype=np.float32) / 255.0  # exact steps
    x[1, :3, 1] = (0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)))
    got = timg.tensor2im(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jimg.tensor2im(jnp.asarray(x))))


def test_config_defaults_and_values_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(JConfig)}
    port = {f.name: f.default for f in dataclasses.fields(TConfig)}
    shared = sorted(set(ref) & set(port))
    for key in ("scheduler_n_epochs_decay", "scheduler_lr_decay_iters",
                "checkpoint_every", "checkpoint_dir", "resume_from",
                "max_restarts", "fault_inject_step", "metrics_path"):
        assert key in shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    for key, values in (("scheduler_policy", SCHEDULER_POLICIES),
                        ("optimizer", OPTIMIZERS),
                        ("init_type", INIT_TYPES)):
        for v in values:
            JConfig(**{key: v}).validate()
            assert getattr(load_config(None, {key: v}), key) == v


TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)


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


def test_train_model_calls_back_with_uint8_frames(tiny, tmp_path):
    pair, ext = tiny
    for sub, img in (("A", pair.A), ("B", pair.B)):
        (tmp_path / sub).mkdir()
        Image.fromarray((img.numpy() * 255).astype(np.uint8)).save(
            tmp_path / sub / "img.png")
    cfg = load_config(None, dict(
        dino_model_name="dino_vits16", vit_compute_dtype="float32",
        generator_compute_dtype="float32", dino_global_patch_size=32,
        device="cpu", seed=1, n_epochs=3, log_images_freq=2))
    frames = []
    res = ttrainer.train_model(str(tmp_path), frames.append, cfg)
    assert [f.dtype for f in frames] == [torch.uint8] * 2
    assert frames[-1].shape == res["output"].shape
    assert torch.equal(frames[-1], timg.tensor2im(res["output"]))
    saved = np.asarray(Image.open(tmp_path / "out" / "output.png"))
    np.testing.assert_array_equal(saved, frames[-1].numpy())


def test_callback_frame_is_the_host_png(tiny, tmp_path):
    """The callback's frame at each log boundary is a CPU uint8 [H, W, 3]
    tensor that np.asarray takes (the notebook's show_result), equal to
    the PNG written at that boundary. On the CPU a device frame would
    convert too; on CUDA only the host copy does."""
    pair, ext = tiny
    cfg = load_config(None, dict(
        vit_compute_dtype="float32", generator_compute_dtype="float32",
        dino_global_patch_size=32, device="cpu", seed=2, n_epochs=5,
        log_images_freq=2))
    saver = AsyncImageSaver()
    seen = []

    def callback(frame):
        saver.flush()      # this boundary's PNG is on disk
        png = np.asarray(Image.open(tmp_path / "out" / "output.png"))
        seen.append((frame.device.type, frame.dtype, np.asarray(frame),
                     png))

    try:
        res = ttrainer.train_pair(cfg, dataroot=str(tmp_path), pair=pair,
                                  extractor=ext, callback=callback,
                                  saver=saver)
    finally:
        saver.close()
    assert len(seen) == 3 and res["chunks"] == [1, 1, 2, 1]
    for dev, dtype, arr, png in seen:
        assert (dev, dtype, arr.dtype) == ("cpu", torch.uint8, np.uint8)
        assert arr.shape == (*res["output_u8"].shape[:2], 3)
        np.testing.assert_array_equal(arr, png)
    np.testing.assert_array_equal(seen[-1][2], res["output_u8"].numpy())
    assert not np.array_equal(seen[0][2], seen[-1][2])


def test_elastic_relaunch_finishes(tmp_path, capfd, monkeypatch):
    """The CLI with max_restarts 1 runs the training in child processes.
    The first attempt raises after step 3 (chunks end at 2 and 4, the
    checkpoint at 2 is on disk); the relaunch resumes from it and runs to
    step 6."""
    rng = np.random.default_rng(1)
    for sub, hw in (("A", (64, 80)), ("B", (72, 64))):
        (tmp_path / sub).mkdir()
        Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(
            tmp_path / sub / "img.png")
    for var in ("_SPLICE_ELASTIC_CHILD", "SPLICE_RESTART_ATTEMPT"):
        monkeypatch.delenv(var, raising=False)
    ck = tmp_path / "ck"
    # the children take about 15-35 s on a loaded host
    with deadline(300), pytest.raises(SystemExit) as done:
        ttrain.main(["--dataroot", str(tmp_path), "--n_epochs", "6",
                     "--device", "cpu", "--dino_model_name", "dino_vits16",
                     "--dino_global_patch_size", "32", "--seed", "1",
                     "--vit_compute_dtype", "float32",
                     "--generator_compute_dtype", "float32",
                     "--checkpoint_every", "2", "--checkpoint_dir", str(ck),
                     "--max_restarts", "1", "--fault_inject_step", "3",
                     "--log_images_freq", "2"])
    out, err = capfd.readouterr()
    assert done.value.code == 0, err[-3000:]
    assert "injected fault after step 3" in err
    assert "attempt 0 exited rc=1; restarting" in err
    assert f"resumed from {ck} at step 2" in out
    assert "done: 4 steps from step 2" in out
    assert sorted(os.listdir(ck)) == ["ckpt_2.pt", "ckpt_4.pt", "ckpt_6.pt"]
    assert (tmp_path / "out" / "output.png").exists()
