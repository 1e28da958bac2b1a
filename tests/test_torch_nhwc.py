"""splice_tpu_torch's NHWC generator against splice_tpu.models.unet.

skip_apply (the reference's generator_layout "nhwc": its downsamplers,
activations and deviation-form BatchNorm) at fp32 on the same parameters
and input, with two stacks: groups=2 against the reference's jax.vmap over
stacks. Outputs at rtol 1e-5 with atol 1e-6 (sigmoid outputs in (0, 1));
flat parameter gradients at rtol 1e-4 with atol 1e-4 x the largest entry
(fp32 sums in another order). The nets are 2-scale and narrow so that each
case compiles in about a second; the inversion net's forward runs at its
own widths on a 128 x 136 input (its sixth scale sees 2 x 3 pixels, and a
reflection border needs more than one pixel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from splice_tpu.models import unet as junet
from splice_tpu_torch.config import load_config
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.utils.tree import tree_map

SMALL = dict(channels_down=(8, 8), channels_up=(8, 8), channels_skip=(2, 2))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(jcfg, seed):
    """The reference's init with the BatchNorm affines and the output
    conv's bias perturbed, so a dropped term shows."""
    p = junet.init_skip_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        names = [getattr(k, "key", "") for k in path]
        a = np.asarray(a)
        if (names[-2].endswith("bn") or names[-2] == "out_conv") \
                and names[-1] in ("scale", "bias"):
            return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


# (downsample_mode, act_fun, pad): every downsampler, every activation,
# reflection padding
CASES = (("stride", "LeakyReLU", "zero"),
         ("avg", "Swish", "reflection"),
         ("max", "ELU", "zero"),
         ("lanczos2", "none", "reflection"),
         ("lanczos3", "Swish", "zero"))


@pytest.mark.parametrize("mode,act_fun,pad", CASES)
def test_skip_apply_two_stacks_output_and_grads(mode, act_fun, pad):
    kw = dict(SMALL, downsample_mode=mode, act_fun=act_fun, pad=pad)
    jcfg, tcfg = junet.SkipConfig(**kw), tunet.SkipConfig(**kw)
    jp = _params(jcfg, 3)
    x = np.random.default_rng(4).random((2, 1, 20, 28, 3)).astype(np.float32)
    out_shape = jax.eval_shape(lambda a: junet.skip_apply(jp, jcfg, a),
                               jnp.asarray(x[0])).shape
    w = np.random.default_rng(5).standard_normal(
        (2, *out_shape)).astype(np.float32)

    def jf(params):
        outs = jax.vmap(lambda xs: junet.skip_apply(params, jcfg, xs))(
            jnp.asarray(x))
        return jnp.sum(outs * w), outs

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)
    jflat = np.asarray(ravel_pytree(jg)[0])
    tflat, spec = tunet.flatten_params(tree_map(torch.from_numpy, jp))
    tflat.requires_grad_(True)
    tout = tunet.skip_apply(tunet.unflatten_params(tflat, spec), tcfg,
                            torch.from_numpy(x.reshape(2, 20, 28, 3)),
                            groups=2)
    (tout * torch.from_numpy(w.reshape(tout.shape))).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout).reshape(tout.shape),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tflat.grad.numpy(), jflat, rtol=1e-4,
                               atol=1e-4 * np.abs(jflat).max())


@pytest.mark.parametrize("kind,factor", [("box", 2), ("lanczos2", 2),
                                         ("lanczos3", 2), ("gauss", 2),
                                         ("lanczos2", 4)])
def test_downsampler_kernel_is_the_reference(kind, factor):
    np.testing.assert_array_equal(tunet._downsampler_kernel(kind, factor),
                                  junet._downsampler_kernel(kind, factor))


def test_downsample_refuses_other_modes():
    x = np.zeros((1, 8, 8, 2), np.float32)
    with pytest.raises(ValueError):
        junet.downsample(jnp.asarray(x), "gauss")
    with pytest.raises(ValueError):
        tunet.downsample(torch.from_numpy(x), "gauss")
    with pytest.raises(ValueError):
        tunet.SkipConfig(downsample_mode="gauss")


def test_inversion_net_forward():
    """The inversion net (7x7/5x5/3x3, reflection) at its widths: the NHWC
    route, and the port's CHW route (conv_impl pallas: the kernels' plain
    versions on the CPU) on the same parameters, both against the
    reference's NHWC route (its CHW route is the same function; compiling
    its 49-tap shifted dots costs ten seconds)."""
    jcfg = junet.inversion_skip_config(4)
    tcfg = tunet.inversion_skip_config(4)
    assert tcfg == tunet.SkipConfig(**{
        f: getattr(jcfg, f) for f in tcfg.__dataclass_fields__})
    jp = _params(jcfg, 6)
    x = np.random.default_rng(7).standard_normal(
        (1, 128, 136, 4)).astype(np.float32)
    tp = tree_map(torch.from_numpy, jp)
    want = np.asarray(jax.jit(lambda p, a: junet.skip_apply(p, jcfg, a))(
        jp, jnp.asarray(x)))
    got = tunet.skip_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    got_chw = tunet.skip_apply_chw(tp, tcfg, torch.from_numpy(x),
                                   conv_impl="pallas")
    np.testing.assert_allclose(got_chw.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("conv_impl,mode,act_fun,route", [
    ("pallas", "avg", "LeakyReLU", "nhwc"),
    ("fused", "stride", "ELU", "auto")])
def test_chw_fallbacks(conv_impl, mode, act_fun, route, monkeypatch):
    """skip_apply_chw's two fallbacks (the reference's :633-642): a
    downsampler takes the NHWC route; fused with an activation its prologue
    lacks degrades to auto (with the CPU hook that makes fused route every
    site through the prologue, the two would differ otherwise)."""
    monkeypatch.setattr(tunet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    gcfg = tunet.SkipConfig(**SMALL, downsample_mode=mode, act_fun=act_fun)
    tree = tunet.init_skip_params(gcfg, seed=8, device="cpu")
    x = torch.rand(2, 16, 24, 3, generator=torch.Generator().manual_seed(9))
    got = tunet.skip_apply_chw(tree, gcfg, x, groups=2, conv_impl=conv_impl)
    want = (tunet.skip_apply(tree, gcfg, x, groups=2) if route == "nhwc"
            else tunet.skip_apply_chw(tree, gcfg, x, groups=2))
    assert torch.equal(got, want)


def test_trainer_routes_by_generator_layout():
    from splice_tpu_torch.trainer import SpliceTrainer
    cfg = load_config(None, dict(generator_layout="nhwc", device="cpu",
                                 generator_compute_dtype="float32"))
    with pytest.raises(ValueError):
        load_config(None, dict(generator_layout="hwc"))
    gcfg = tunet.SkipConfig(**SMALL, act_fun="Swish",
                            downsample_mode="lanczos2")
    t = SpliceTrainer.__new__(SpliceTrainer)
    t.cfg, t.gcfg, t.gdt = cfg, gcfg, torch.float32
    tree = tunet.init_skip_params(gcfg, seed=1, device="cpu")
    x = torch.rand(2, 16, 20, 3)
    assert torch.equal(t.generate(tree, x, 2),
                       tunet.skip_apply(tree, gcfg, x, groups=2))


def test_gen_noise_is_seeded():
    x = torch.zeros(2, 5, 6, 3, dtype=torch.float64)
    a = tunet.gen_noise(x, 4, torch.Generator().manual_seed(3))
    b = tunet.gen_noise(x, 4, torch.Generator().manual_seed(3))
    assert a.shape == (2, 5, 6, 4) and a.dtype == torch.float64
    assert torch.equal(a, b)
