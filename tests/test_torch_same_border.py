"""The SAME-border conv route of splice_tpu_torch.ops.conv (ConvValidPro
with `same`: K3'' SAME, K3''' in-kernel BatchNorm statistics, K7
cotangent-tapped dw) against splice_tpu.ops.conv_pallas with its
SAME_BORDER_KERNELS on.

The JAX side runs the Pallas kernels in interpret mode on the CPU
(_make_conv_kernel in its SAME and stats_ho forms, _make_dw_kernel_gtap,
_make_dw_kernel with same=True), the statistics under jax.vmap over two
BatchNorm stacks as the trainer runs them. The torch side runs the same
calls on CPU tensors: the plain versions of the kernels. Both packages'
constants are set with monkeypatch. fp32 throughout.

Tolerances: 1e-4 x max|reference| for outputs, statistics and gradients
(sums of up to 3,600 products of O(1) values in another order; the
reference's own SAME dw differs from XLA's by 4.6e-4 absolute on sums of
this size). Under the prologue the reference's zero border is the pre-image
row v = -shift/scale, exact to fp32 rounding, the port's an exact zero, so
scales are drawn in [0.5, 1.5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.models import unet as junet
from splice_tpu.ops import conv_pallas
from splice_tpu_torch.ops import conv as tconv

B, H = 2, 9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


@pytest.fixture
def same_on(monkeypatch):
    monkeypatch.setattr(conv_pallas, "SAME_BORDER_KERNELS", True)
    monkeypatch.setattr(tconv, "SAME_BORDER_KERNELS", True)


def _spy_gtap(monkeypatch):
    """Record each call of K7's plain version (the CPU route of K7)."""
    calls = []
    plain = tconv.conv_dw_gtap_plain
    monkeypatch.setattr(tconv, "conv_dw_gtap_plain",
                        lambda *a, **kw: calls.append(a[2]) or plain(*a, **kw))
    return calls


@functools.lru_cache
def _pallas_conv_same(cin, cout, w_px):
    """One case's inputs and the reference's (out, dx, dw) with its
    SAME_BORDER_KERNELS on, built once per module."""
    rng = np.random.default_rng(cin)
    x = rng.standard_normal((B, cin, H, w_px)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    g = rng.standard_normal((B, cout, H, w_px)).astype(np.float32)
    old = conv_pallas.SAME_BORDER_KERNELS
    conv_pallas.SAME_BORDER_KERNELS = True
    try:
        out, vjp = jax.vjp(lambda x, w: conv_pallas.pallas_conv_chw(
            x, {"kernel": w, "bias": jnp.asarray(b)}, 1), jnp.asarray(x),
            jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
    finally:
        conv_pallas.SAME_BORDER_KERNELS = old
    return (x, w, b, g), tuple(map(np.asarray, (out, jdx, jdw)))


# (a) the gtap case routes dw to K7, the x-tap case to K4 with the border;
# with the port's DW_TAP_ON_N off the gtap case takes K4 too, held against
# the same reference result (the same function).
@pytest.mark.parametrize("cin,cout,w_px,tap_on_n,gtap", [
    (40, 2, 40, True, True), (40, 2, 40, False, False),
    (4, 16, 37, True, False)], ids=["gtap", "gtap-tap-off", "xtap"])
def test_kernel_conv_chw_same_matches_pallas(cin, cout, w_px, tap_on_n, gtap,
                                             same_on, monkeypatch):
    (x, w, b, g), (out, jdx, jdw) = _pallas_conv_same(cin, cout, w_px)
    monkeypatch.setattr(tconv, "DW_TAP_ON_N", tap_on_n)
    calls = _spy_gtap(monkeypatch)
    tx, tw = (torch.from_numpy(t).requires_grad_(True) for t in (x, w))
    tout = tconv.kernel_conv_chw(tx, {"kernel": tw,
                                      "bias": torch.from_numpy(b)})
    tout.backward(torch.from_numpy(g))
    assert tout.shape == out.shape == (B, cout, H, w_px)
    assert calls == ([3] if gtap else [])
    _close(tout.detach().numpy(), out, "out")
    _close(tx.grad.numpy(), jdx, "dx")
    _close(tw.grad.numpy(), jdw, "dw")


# (b) K3''' under two stacks: out, s1, s2 and the gradients of a loss that
# uses all three (the statistics' cotangents folded into g).
@pytest.mark.parametrize("negslope,cin,cout,w_px", [(0.2, 40, 2, 40),
                                                    (1.0, 6, 4, 37)],
                         ids=["ns0.2-gtap", "ns1.0-xtap"])
def test_conv_bn_act_stats_matches_pallas_two_stacks(negslope, cin, cout,
                                                     w_px, same_on):
    rng = np.random.default_rng(int(10 * negslope) + cin)
    x = rng.standard_normal((2, cin, H, w_px)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    scale = (rng.random((2, cin)) + 0.5).astype(np.float32)
    shift = rng.standard_normal((2, cin)).astype(np.float32)
    go = rng.standard_normal((2, cout, H, w_px)).astype(np.float32)
    a1, a2 = (rng.standard_normal((2, cout)).astype(np.float32) / 100
              for _ in range(2))

    def jf(x, w, b, sc, sh):
        return jax.vmap(lambda xs, s, t: conv_pallas.pallas_conv_bn_act_chw(
            xs, {"kernel": w, "bias": b}, s, t, 1, "zero", negslope,
            want_stats=True))(x[:, None], sc, sh)

    def jloss(*a):
        out, s1, s2 = jf(*a)
        return jnp.sum(out[:, 0] * go) + jnp.sum(s1 * a1) + jnp.sum(s2 * a2)

    args = tuple(map(jnp.asarray, (x, w, b, scale, shift)))
    (out, s1, s2), jgrads = jax.jit(lambda *a: (
        jf(*a), jax.grad(jloss, argnums=tuple(range(5)))(*a)))(*args)

    leaves = [torch.from_numpy(t).requires_grad_(True)
              for t in (x, w, b, scale, shift)]
    tout, ts1, ts2 = tconv.kernel_conv_bn_act_chw(
        leaves[0], {"kernel": leaves[1], "bias": leaves[2]}, leaves[3],
        leaves[4], 1, "zero", negslope, want_stats=True)
    assert ts1.shape == ts2.shape == (2, cout)
    _close(tout.detach().numpy(), np.asarray(out)[:, 0], "out")
    _close(ts1.detach().numpy(), s1, "s1")
    _close(ts2.detach().numpy(), s2, "s2")
    # the reference's statistics are those of its own output
    o64 = np.asarray(out, np.float64)[:, 0]
    _close(ts1.detach().numpy(), o64.sum(axis=(2, 3)), "s1 of out")
    _close(ts2.detach().numpy(), np.square(o64).sum(axis=(2, 3)), "s2 of out")
    (tout * torch.from_numpy(go)).sum().add(
        (ts1 * torch.from_numpy(a1)).sum()).add(
        (ts2 * torch.from_numpy(a2)).sum()).backward()
    for name, t, j in zip(("x", "w", "bias", "scale", "shift"), leaves,
                          jgrads):
        _close(t.grad.numpy(), j, f"d{name}")


# (c) K7's plain version against the reference's tap-on-N impl in its SAME
# (row-padded x) and VALID (fully padded x) modes, and against K4's.
@pytest.mark.parametrize("same,w_px", [(True, 40), (False, 126)],
                         ids=["same-W40", "valid-W126"])
@pytest.mark.parametrize("pro", [False, True], ids=["plain", "pro"])
def test_conv_dw_gtap_plain_matches_pallas_gtap(same, w_px, pro):
    k, cin, cout, ns = 3, 12, 5, 0.2
    rng = np.random.default_rng(w_px + pro)
    hx = H if same else H + 2
    x = rng.standard_normal((B, cin, hx, w_px)).astype(np.float32)
    ho, wo = (H, w_px) if same else (H, w_px - 2)
    g = rng.standard_normal((B, cout, ho, wo)).astype(np.float32)
    sc = (rng.random(cin) + 0.5).astype(np.float32) if pro else None
    sh = rng.standard_normal(cin).astype(np.float32) if pro else None
    xp = x
    if same:   # the reference's SAME input: rows padded with z's zero
        v = np.zeros(cin, np.float32) if sc is None else -sh / sc
        vrow = np.broadcast_to(v[None, :, None, None], (B, cin, 1, w_px))
        xp = np.concatenate([vrow, x, vrow], axis=2)
    jdw = conv_pallas._dw_gtap_impl(
        jnp.asarray(xp), jnp.asarray(g), k,
        None if sc is None else jnp.asarray(sc),
        None if sh is None else jnp.asarray(sh), ns, same=same)

    rows = (lambda v: None if v is None else torch.from_numpy(v)[None])
    pad = 1 if same else 0
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    got = tconv.conv_dw_gtap_plain(tx, tg, k, rows(sc), rows(sh), ns, pad)
    assert got.shape == (k, k, cin, cout)
    _close(got.numpy(), jdw, "K7 plain vs _dw_gtap_impl")
    _close(got.numpy(), tconv.conv_dw_pro_plain(
        tx, tg, k, rows(sc), rows(sh), ns, pad).numpy(), "K7 vs K4 plain")


def test_conv_dw_gtap_plain_k2_matches_conv_dw_plain():
    """k = 2 (K7 is built for k in {2, 3}): the tap reversal at an even k."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 7, 10, 13)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 9, 12)).astype(
        np.float32))
    _close(tconv.conv_dw_gtap_plain(x, g, 2).numpy(),
           tconv.conv_dw_plain(x, g, 2).numpy())


# (d) the routing predicate: the reference's, copied verbatim.
def test_gtap_better_routes_default_unet_sites_as_reference():
    cfg = junet.SkipConfig()
    n = len(cfg.channels_down)
    sites = {}
    for i in range(n):
        k_inner = cfg.channels_down[i] if i == n - 1 \
            else cfg.channels_up[i + 1]
        sites[f"up_conv s{i}"] = (cfg.channels_skip[i] + k_inner,
                                  cfg.channels_up[i])
        sites[f"down_conv2 s{i}"] = (cfg.channels_down[i],) * 2
    routed = {name for name, (cin, cout) in sites.items()
              if tconv._gtap_better(3, cin, cout)}
    assert routed == {"up_conv s0", "up_conv s1"}
    for k in (1, 2, 3):
        for cin in (3, 4, 16, 36, 68, 132):
            for cout in (2, 3, 16, 32, 64, 128):
                assert tconv._gtap_better(k, cin, cout) \
                    == conv_pallas._gtap_better(k, cin, cout)
    assert tconv.DW_TAP_ON_N == conv_pallas.DW_TAP_ON_N is True
    assert tconv.SAME_BORDER_KERNELS == conv_pallas.SAME_BORDER_KERNELS


def test_same_route_reads_the_constant_at_call_time(monkeypatch):
    """kernel_conv_chw takes the SAME route only while SAME_BORDER_KERNELS
    is on, and only for stride-1 zero-padded convs of odd k > 1."""
    calls = []
    apply = tconv.ConvValidPro.apply
    monkeypatch.setattr(tconv.ConvValidPro, "apply", lambda *a: (
        a[8] and calls.append(a[1].shape[0])) or apply(*a))
    x = torch.rand(2, 4, 8, 10)
    p3 = {"kernel": torch.rand(3, 3, 4, 5)}
    p1 = {"kernel": torch.rand(1, 1, 4, 5)}
    off = tconv.kernel_conv_chw(x, p3)
    monkeypatch.setattr(tconv, "SAME_BORDER_KERNELS", True)
    on = tconv.kernel_conv_chw(x, p3)
    for p, stride, pad in ((p1, 1, "zero"), (p3, 2, "zero"),
                           (p3, 1, "reflection")):
        tconv.kernel_conv_chw(x, p, stride, pad)
    assert calls == [3]
    assert torch.allclose(on, off, atol=1e-5)


@pytest.mark.parametrize("wrapper", ["conv_same_cuda", "conv_same_pro_cuda",
                                     "conv_same_pro_stats_cuda",
                                     "conv_dw_gtap_cuda"])
def test_same_cuda_wrappers_refuse_cpu_tensors(wrapper):
    x, w = torch.rand(2, 4, 8, 10), torch.rand(3, 3, 4, 5)
    sc, sh = torch.ones(1, 4), torch.zeros(1, 4)
    args = {"conv_same_cuda": (x, w),
            "conv_same_pro_cuda": (x, w, sc, sh),
            "conv_same_pro_stats_cuda": (x, w, sc, sh),
            "conv_dw_gtap_cuda": (x, torch.rand(2, 5, 8, 10), 3, sc, sh,
                                  1.0, 1)}[wrapper]
    with pytest.raises(ValueError):
        getattr(tconv, wrapper)(*args)
