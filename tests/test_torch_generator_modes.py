"""generator_conv = pallas | fused | xla: splice_tpu_torch.ops.conv's
prologue and stride-2 forms and models.unet's modes against splice_tpu.

The JAX side runs pallas_conv_bn_act_chw / pallas_conv_chw: on the CPU the
Pallas conv kernel (_make_conv_kernel, with its has_pro prologue, also at
k = 2 for stride 2) and the weight-gradient kernel (_make_dw_kernel) in
interpret mode, under jax.vmap over two BatchNorm stacks as the trainer
runs them. The torch side runs the same calls on CPU tensors, i.e. the
plain versions of K3/K4 in their pro and s2d forms, with [2, C] rows of
scale/shift. fp32 throughout. Tolerances:
  * single convs: rtol 1e-5 for outputs, 1e-4 for gradients, with atol
    1e-5 x the largest entry (sums of up to 900 products in another
    order; the reference's zero border under the prologue is the pre-image
    -shift/scale, exact to fp32 rounding, the port's an exact zero);
  * the whole generator: as tests/test_torch_unet.py (output rtol 1e-5,
    atol 1e-6; flat gradient rtol 1e-4 with atol 1e-4 x its largest
    entry).
Both packages' FORCE_FUSED_KERNELS_ON_CPU route every fused site through
the prologue kernels, as the card routes its wide sites.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from splice_tpu.models import unet as junet
from splice_tpu.ops import conv_pallas
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.ops import conv as tconv
from splice_tpu_torch.utils.tree import tree_map

CIN, COUT, H, W = 5, 4, 11, 14
TINY_UNET = dict(channels_down=(8, 8, 16), channels_up=(8, 8, 16),
                 channels_skip=(2, 2, 2))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


# Every pair of (stride, k, negslope, pad) values occurs (k = 1 has no
# border, so its padding modes are one case).
@pytest.mark.parametrize("stride,k,negslope,pad", [
    (1, 3, 0.2, "zero"), (1, 3, 1.0, "reflection"), (1, 1, 0.2, "zero"),
    (2, 3, 0.2, "zero"), (2, 3, 1.0, "reflection"), (2, 1, 1.0, "zero"),
    (2, 3, 0.2, "reflection")])
def test_conv_bn_act_matches_pallas_two_stacks(stride, k, negslope, pad):
    rng = np.random.default_rng(10 * stride + k)
    x = rng.standard_normal((2, CIN, H, W)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, k, CIN, COUT))).astype(np.float32)
    b = rng.standard_normal(COUT).astype(np.float32)
    scale = (rng.random((2, CIN)) + 0.5).astype(np.float32)
    scale[1, 0] *= -1.0                    # a negative BatchNorm gain
    shift = rng.standard_normal((2, CIN)).astype(np.float32)

    def jf(x, w, sc, sh):
        p = {"kernel": w, "bias": jnp.asarray(b)}
        return jax.vmap(lambda xs, s, t: conv_pallas.pallas_conv_bn_act_chw(
            xs, p, s, t, stride, pad, negslope))(x[:, None], sc, sh)[:, 0]

    g = rng.standard_normal((2, COUT, (H - 1) // stride + 1,
                             (W - 1) // stride + 1)).astype(np.float32)
    out, jgrads = jax.jit(lambda *a: (jf(*a), jax.vjp(jf, *a)[1](g)))(
        *map(jnp.asarray, (x, w, scale, shift)))

    leaves = [torch.from_numpy(t).requires_grad_(True)
              for t in (x, w, scale, shift)]
    tout = tconv.kernel_conv_bn_act_chw(
        leaves[0], {"kernel": leaves[1], "bias": torch.from_numpy(b)},
        leaves[2], leaves[3], stride, pad, negslope)
    tout.backward(torch.from_numpy(g))
    _close(tout.detach().numpy(), out, 1e-5)
    for name, t, j in zip(("x", "w", "scale", "shift"), leaves, jgrads):
        _close(t.grad.numpy(), j, 1e-4, f"d{name}")


@pytest.mark.parametrize("pad", ["zero", "reflection"])
def test_stride2_kernel_conv_matches_pallas(pad):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, CIN, H, W)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, CIN, COUT))).astype(np.float32)
    b = rng.standard_normal(COUT).astype(np.float32)
    out, vjp = jax.vjp(lambda x, w: conv_pallas.pallas_conv_chw(
        x, {"kernel": w, "bias": jnp.asarray(b)}, 2, pad),
        jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(out.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = (torch.from_numpy(t).requires_grad_(True) for t in (x, w))
    tout = tconv.kernel_conv_chw(tx, {"kernel": tw,
                                      "bias": torch.from_numpy(b)}, 2, pad)
    tout.backward(torch.from_numpy(g))
    assert tout.shape == out.shape == (2, COUT, 6, 7)
    _close(tout.detach().numpy(), out, 1e-5)
    _close(tx.grad.numpy(), jdx, 1e-4, "dx")
    _close(tw.grad.numpy(), jdw, 1e-4, "dw")


def test_s2d_kernel_scatters_taps_and_zeros_the_rest():
    w = torch.arange(1, 3 * 3 * 2 * 1 + 1, dtype=torch.float32).reshape(
        3, 3, 2, 1)
    wk = tconv.s2d_kernel(w)
    assert wk.shape == (2, 2, 8, 1)
    for dy in range(3):
        for dx in range(3):
            ph = (dy % 2) * 2 + dx % 2
            assert torch.equal(wk[dy // 2, dx // 2, ph * 2:ph * 2 + 2],
                               w[dy, dx])
    assert int((wk == 0).sum()) == wk.numel() - w.numel()


def _generator_case(seed):
    """The tiny generator's params (numpy tree), input and loss weights for
    one seed."""
    p = junet.init_skip_params(jax.random.PRNGKey(1),
                               junet.SkipConfig(**TINY_UNET))
    rng = np.random.default_rng(seed)
    # BatchNorm affines and the output bias perturbed so a dropped term
    # shows (tests/test_torch_unet.py)
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)
        if (path[-2].key.endswith("bn") or path[-2].key == "out_conv")
        and path[-1].key in ("scale", "bias") else np.asarray(a), p)
    x = rng.random((2, 1, 40, 36, 3)).astype(np.float32)
    w = rng.standard_normal((2, 1, 40, 36, 3)).astype(np.float32)
    return p, x, w


def _set_modes(mode, monkeypatch):
    """Both packages' FORCE_FUSED_KERNELS_ON_CPU on, and with a "-same"
    mode both SAME_BORDER_KERNELS; returns the generator_conv value."""
    monkeypatch.setattr(junet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    monkeypatch.setattr(tunet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    if mode.endswith("-same"):
        monkeypatch.setattr(conv_pallas, "SAME_BORDER_KERNELS", True)
        monkeypatch.setattr(tconv, "SAME_BORDER_KERNELS", True)
    return mode.removesuffix("-same")


@pytest.mark.parametrize("mode", ["fused", "xla", "fused-same",
                                  "pallas-same"])
def test_generator_mode_matches_jax_two_stacks(mode, monkeypatch):
    """"-same": both packages' SAME_BORDER_KERNELS on. For fused that adds
    the in-kernel statistics (down_conv2, up_conv), and K7 takes dw at
    up_conv s1 (18 -> 8), where _gtap_better routes it. JAX's pallas mode
    runs XLA's conv on the CPU, while the port's runs the SAME route's
    plain versions.

    pallas-same draws from seed 2. At seed 1 one LeakyReLU input (scale
    0's up1x1 output) lies 6e-8 from 0, and fp32 rounding puts it on
    either side depending on the convs' summation order: the port's pallas
    mode (SAME on or off) and its xla mode then take different sides of the
    activation's kink, and their flat gradients differ by 0.56 (max 83).
    test_fp32_pallas_and_xla_split_only_at_a_leaky_kink shows that flip,
    and test_generator_modes_agree_in_float64 runs seed 1 in float64, where
    the modes agree to rounding."""
    seed = 2 if mode == "pallas-same" else 1
    mode = _set_modes(mode, monkeypatch)
    p, x, w = _generator_case(seed)
    jcfg, tcfg = junet.SkipConfig(**TINY_UNET), tunet.SkipConfig(**TINY_UNET)

    def jf(params):
        outs = jax.vmap(lambda xs: junet.skip_apply_chw(
            params, jcfg, xs, conv_impl=mode))(jnp.asarray(x))
        return jnp.sum(outs * w), outs

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(p)
    jflat_g = np.asarray(ravel_pytree(jg)[0])

    tflat, spec = tunet.flatten_params(tree_map(torch.from_numpy, p))
    tflat.requires_grad_(True)
    tout = tunet.skip_apply_chw(tunet.unflatten_params(tflat, spec), tcfg,
                                torch.from_numpy(x.reshape(2, 40, 36, 3)),
                                groups=2, conv_impl=mode)
    (tout * torch.from_numpy(w.reshape(tout.shape))).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout).reshape(tout.shape),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tflat.grad.numpy(), jflat_g, rtol=1e-4,
                               atol=1e-4 * np.abs(jflat_g).max())


def _float64_grad(mode, p, x, w):
    """The port's generator in float64 on the CPU (two stacks): the flat
    gradient of sum(out * w), in ravel_pytree order."""
    leaves = tree_map(lambda a: torch.from_numpy(a).double()
                      .requires_grad_(True), p)
    out = tunet.skip_apply_chw(
        leaves, tunet.SkipConfig(**TINY_UNET),
        torch.from_numpy(x.reshape(2, 40, 36, 3)).double(), groups=2,
        conv_impl=mode)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(w.reshape(out.shape))).sum(),
        [t for _, t in tunet._leaves(leaves)])
    return torch.cat([g.reshape(-1) for g in grads]).numpy()


@pytest.mark.parametrize("mode", ["pallas", "pallas-same", "fused-same"])
def test_generator_modes_agree_in_float64(mode, monkeypatch):
    """Seed 1, where the fp32 pallas modes and xla sit on opposite sides of
    a LeakyReLU kink (test_generator_mode_matches_jax_two_stacks): in
    float64 the port's kernel routes (their plain versions, which keep
    float64) agree with its xla mode (F.conv2d). Tolerance 1e-9 x the
    largest entry: float64 rounding (1e-16) through a gradient whose fp32
    form amplifies rounding by up to 1e4; seen: 2e-13 on a max of 83."""
    p, x, w = _generator_case(1)
    ref = _float64_grad("xla", p, x, w)
    got = _float64_grad(_set_modes(mode, monkeypatch), p, x, w)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())


def test_fp32_pallas_and_xla_split_only_at_a_leaky_kink(monkeypatch):
    """The cause of the seed-1 fp32 gap between the port's pallas and xla
    modes: every activation input agrees to fp32 rounding (rtol and atol
    1e-5 on values of O(1)), and exactly one LeakyReLU input, within 1e-6
    of 0, has its sign flipped."""
    p, x, _ = _generator_case(1)
    monkeypatch.setattr(tunet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    act = tunet.act

    def inputs(mode):
        seen = []
        monkeypatch.setattr(tunet, "act", lambda t, f: seen.append(
            t.detach().double()) or act(t, f))
        tunet.skip_apply_chw(tree_map(torch.from_numpy, p),
                             tunet.SkipConfig(**TINY_UNET),
                             torch.from_numpy(x.reshape(2, 40, 36, 3)),
                             groups=2, conv_impl=mode)
        return seen

    flips = []
    for a, b in zip(inputs("xla"), inputs("pallas"), strict=True):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        flips += [float(v) for v in a[(a >= 0) != (b >= 0)]]
    assert len(flips) == 1 and abs(flips[0]) < 1e-6


def test_fused_mode_launches_prologue_wrappers_only_through_routes(
        monkeypatch):
    """With the test hook off, fused on CPU tensors routes no site through
    the prologue (fuse_worthwhile needs the card's kernels); with it on,
    every BatchNorm consumer takes kernel_conv_bn_act_chw."""
    cfg = tunet.SkipConfig(**TINY_UNET)
    params = tunet.init_skip_params(cfg, seed=0, device="cpu")
    x = torch.rand(1, 32, 32, 3)
    calls = []
    fused = tconv.kernel_conv_bn_act_chw
    monkeypatch.setattr(tunet, "kernel_conv_bn_act_chw",
                        lambda *a: calls.append(a[4]) or fused(*a))
    a = tunet.skip_apply_chw(params, cfg, x, conv_impl="fused")
    assert calls == []
    monkeypatch.setattr(tunet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    b = tunet.skip_apply_chw(params, cfg, x, conv_impl="fused")
    # per scale: skip, down1 (stride 2), down2, up, up1x1 take a pending
    # input, except the raw image's skip/down1 at scale 0; plus out_conv
    assert sorted(calls) == [1] * 12 + [2] * 2
    assert torch.allclose(a, b, atol=1e-5)
    with pytest.raises(ValueError):
        tunet.skip_apply_chw(params, cfg, x, conv_impl="lax")
