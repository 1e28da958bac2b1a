"""The slice as a whole: one training step of splice_tpu_torch against the
JAX composition of splice_tpu's public functions, fed the same parameters
and the same draws (use_augmentations=False, so the draws are the crops).

Tiny shapes: 64-px canvas, a 3-scale generator, a 2-block ViT of width 128
with head dim 64, 32-px loss resolution. fp32. Tolerances:
  * total loss: rtol 1e-5;
  * flat parameter gradient: relative L2 5e-3 and max error 5e-3 x its
    largest entry. This gradient is ill-conditioned in fp32 itself (the
    single-pass BatchNorm statistics cancel in the backward): at the
    448-px canvas the port's fp32 gradient differs from a float64
    evaluation of the same code by 1.2e-3 relative L2;
  * parameters after one Adam update (b1 = 0: the update is lr * g /
    (|g| + eps)): 1e-6 on every entry whose gradient is at least 1e-3 of
    the largest, and at most 2 lr elsewhere (entries whose gradient is
    rounding noise, like conv biases in front of a BatchNorm, move by
    +-lr in either package).

train_pair's seeded run and the CLI are in tests/test_torch_step_run.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree
from PIL import Image

from splice_tpu import losses as jlosses
from splice_tpu.models import extractor as jext
from splice_tpu.models import unet as junet
from splice_tpu.models import vit as jvit
from splice_tpu.ops import image as jimg
from splice_tpu_torch import resolve_device
from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.config import load_config
from splice_tpu_torch.data import ImagePair, load_pair
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models import weights as tweights
from splice_tpu_torch.models.weights import vit_params_from_numpy
from splice_tpu_torch.parallel.pair_parallel import train_pairs

TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)
TINY_UNET = dict(channels_down=(8, 8, 16), channels_up=(8, 8, 16),
                 channels_skip=(2, 2, 2))
CANVAS = 64
LR = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(use_augmentations=False, vit_compute_dtype="float32",
                generator_compute_dtype="float32",
                dino_global_patch_size=32, lr=LR, device="cpu", seed=3)
    base.update(kw)
    return load_config(None, base)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    A = rng.random((70, 90, 3)).astype(np.float32)
    B = rng.random((80, 72, 3)).astype(np.float32)
    jvp = jax.tree.map(np.asarray, jvit.init_vit_params(
        jax.random.PRNGKey(1), jvit.VitConfig(**TINY_VIT)))
    jp = junet.init_skip_params(jax.random.PRNGKey(2),
                                junet.SkipConfig(**TINY_UNET))
    jflat, unravel = ravel_pytree(jp)
    return A, B, jvp, np.asarray(jflat), unravel


_JAX_STEPS = {}


def _jax_step(setup, draws, lam, entire):
    """Loss, gradient and the parameters after one optax.adam update, by
    the JAX package's public functions in the trainer's order (computed
    once per step kind: the fused cases reuse them)."""
    key = (entire, tuple(sorted(lam.items())))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _jax_step_uncached(setup, draws, lam, entire)
    return _JAX_STEPS[key]


def _jax_step_uncached(setup, draws, lam, entire):
    A, B, jvp, jflat, unravel = setup
    ext = jext.VitExtractor(params=jvp, cfg=jvit.VitConfig(**TINY_VIT))
    gcfg = junet.SkipConfig(**TINY_UNET)
    A, B = jnp.asarray(A), jnp.asarray(B)

    def crops(img, side, tops, lefts):
        return jnp.stack([jimg.crop_and_resize(img, t, l, side, CANVAS)
                          for t, l in zip(tops, lefts)])

    def tf(x):
        return jimg.imagenet_normalize(jimg.dino_global_resize(x, 32, 480))

    def g_apply(params, x):
        return junet.skip_apply_chw(params, gcfg, x, None, conv_impl="xla")

    def loss(flat):
        params = unravel(flat)
        cA, cB = crops(A, *draws.crops_A), crops(B, *draws.crops_B)
        outs = jax.vmap(lambda xs: g_apply(params, xs))(jnp.stack([cA, cB]))
        parts, aux = jlosses.splice_losses_fused(ext, tf(outs[0]), tf(cA),
                                                 tf(outs[1]), tf(cB))
        if entire:
            parts.update(jlosses.entire_losses_fused(
                ext, tf(g_apply(params, A[None])), tf(A[None]),
                aux["cls_B"]))
        return jlosses.weighted_total(parts, lam)

    total, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(jflat))
    tx = optax.adam(LR, b1=0.0, b2=0.99, eps=1e-8)
    upd, _ = tx.update(grad, tx.init(jnp.asarray(jflat)), jnp.asarray(jflat))
    new = optax.apply_updates(jnp.asarray(jflat), upd)
    return float(total), np.asarray(grad), np.asarray(new)


def _port_trainer(setup, cfg):
    A, B, jvp, jflat, _ = setup
    pair = ImagePair(A=torch.from_numpy(A), B=torch.from_numpy(B),
                     canvas_A=CANVAS, canvas_B=CANVAS)
    ext = text.VitExtractor(params=vit_params_from_numpy(jvp),
                            cfg=tvit.VitConfig(**TINY_VIT))
    return ttrainer.SpliceTrainer(cfg, pair, ext,
                                  tunet.SkipConfig(**TINY_UNET),
                                  init_flat=torch.from_numpy(jflat))


@pytest.mark.parametrize("step_idx,entire,conv", [
    pytest.param(1, False, "auto", id="1-False"),
    pytest.param(0, True, "auto", id="0-True"),
    pytest.param(1, False, "fused", id="1-False-fused"),
    pytest.param(0, True, "fused", id="0-True-fused")])
def test_one_step_matches_jax_composition(setup, step_idx, entire, conv,
                                          monkeypatch):
    """conv "fused": generator_conv="fused" in the port, its test hook
    routing every BatchNorm consumer through the prologue kernels' plain
    versions (the routes the card takes at its wide sites), against the
    same JAX composition: deferring the BatchNorm apply changes the
    generator's function by rounding only. The fused generator itself
    meets the reference's conv_impl="fused" and its kernels in
    tests/test_torch_generator_modes.py."""
    monkeypatch.setattr(tunet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    cfg = _cfg(entire_A_every=75, generator_conv=conv)
    draws = ttrainer.StepDraws(structure=None, flip_B=False,
                               crops_A=(67.0, [2.0], [11.0]),
                               crops_B=(72.0, [5.0], [0.0]))
    lam = jlosses.lambdas_for_step(cfg, step_idx)
    assert jlosses.is_entire_step(cfg, step_idx) == entire
    jtotal, jgrad, jnew = _jax_step(setup, draws, lam, entire)

    tr = _port_trainer(setup, cfg)
    total, parts = tr.loss(draws, lam, entire)
    (grad,) = torch.autograd.grad(total, tr.flat)
    grad = grad.numpy()
    assert set(parts) >= {"loss_global_ssim", "loss_global_cls",
                          "loss_global_id_B"}
    np.testing.assert_allclose(total.item(), jtotal, rtol=1e-5)
    gmax = np.abs(jgrad).max()
    assert np.linalg.norm(grad - jgrad) <= 5e-3 * np.linalg.norm(jgrad)
    assert np.abs(grad - jgrad).max() <= 5e-3 * gmax

    tr.step(draws, lam, entire)
    new = tr.flat.detach().numpy()
    firm = np.abs(jgrad) >= 1e-3 * gmax
    assert firm.mean() > 0.5
    np.testing.assert_allclose(new[firm], jnew[firm], rtol=0, atol=1e-6)
    assert np.abs(new - jnew).max() <= 2 * LR + 1e-6


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        ttrainer.train_pair(load_config(None, {}), n_steps=1)
    with pytest.raises(RuntimeError):
        train_pairs(load_config(None, {}), ["a", "b"], n_steps=1)
    assert resolve_device("cpu").type == "cpu"
    assert dataclasses.asdict(load_config(None, {}))["device"] == "cuda"


# Each public loader -> one tensor it put on the device.
LOADERS = {
    "load_pair": lambda cfg, **kw: load_pair(cfg, **kw).A,
    "make_extractor_from_config": lambda cfg, **kw:
        ttrainer.make_extractor_from_config(cfg, **kw).params["cls_token"],
    "load_or_init_vit_params": lambda cfg, **kw:
        tweights.load_or_init_vit_params("dino_vits8", None, **kw)[
            "cls_token"],
    "init_vit_params": lambda cfg, **kw: tweights.init_vit_params(
        tvit.VitConfig(**TINY_VIT), **kw)["cls_token"],
    "init_skip_params": lambda cfg, **kw: tunet.init_skip_params(
        tunet.SkipConfig(**TINY_UNET), **kw)["out_conv"]["kernel"],
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loaders_default_to_cuda(name, tmp_path):
    """With no device given, a loader builds on cfg.device / CUDA, and
    raises without a card; device="cpu" builds on the CPU."""
    rng = np.random.default_rng(2)
    for sub in ("A", "B"):
        (tmp_path / sub).mkdir()
        Image.fromarray((rng.random((40, 48, 3)) * 255).astype(
            np.uint8)).save(tmp_path / sub / "img.png")
    cfg = load_config(None, dict(dataroot=str(tmp_path),
                                 dino_model_name="dino_vits8"))
    load = LOADERS[name]
    if torch.cuda.is_available():
        assert load(cfg).is_cuda
    else:
        with pytest.raises(RuntimeError):
            load(cfg)
    assert load(cfg, device="cpu").device.type == "cpu"
