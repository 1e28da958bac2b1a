"""Filter sizes beyond the generators' defaults: splice_tpu_torch.ops.conv's
route (conv_route, px_form, dw_px_form) and its convs at k = 6, 9 and 11 against
splice_tpu.ops.conv_pallas, whose kernels take any k.

conv_route is pure Python: every k from 1 to 13, at stride 1 and 2, SAME
and VALID, bf16 and fp32, names a kernel of the port (fp32 K3, K4 and K7
the split-TF32 forms, with a tiling that fits), and the training net's sites
keep the channel-major bf16 forms. The convs run on CPU
tensors (the
plain versions of K3 and K4) against the reference's pallas_conv_chw and
pallas_conv_bn_act_chw, whose Pallas kernels run in interpret mode on the
CPU (tests/test_torch_conv_any_k_generator.py runs a generator with 9x9
up convs). fp32 throughout. Tolerance: 1e-5 x the largest entry for
outputs and gradients (sums of up to 4 x 121 products of O(1) values in
another order; seen up to 2.4e-6 x and 2.5e-7 x max).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.ops import conv_pallas
from splice_tpu_torch.ops import conv as tconv
from splice_tpu_torch.tools import conv_forms

DTYPES = (torch.bfloat16, torch.float32)
ENTRIES = {("K3", "tc"): "conv_fwd_tc", ("K3", "px"): "conv_fwd_px",
           ("K3", "tf32"): "conv_fwd_tf32", ("K4", "tc"): "conv_dw_tc",
           ("K4", "px"): "conv_dw_px", ("K4", "tf32"): "conv_dw_tf32",
           ("K7", "tc"): "conv_dw_tc", ("K7", "px"): "conv_dw_px",
           ("K7", "tf32"): "conv_dw_tf32", ("K4", "wg"): "conv_dw_wg",
           ("K7", "wg"): "conv_dw_wg"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _routes(k, stride, same, dtype, cin=20, cout=24, batch=2, hw=37):
    """Every route of one conv of filter k: its forward, input gradient
    and weight gradient (with `same`, K7 where the reference routes it, and
    K7 asked for by name), as ConvValidPro and conv_dw_gtap_cuda ask."""
    if stride == 2:
        kk, cv = (k + 1) // 2, 4 * cin
        ho = (hw + 2 * ((k - 1) // 2) - k) // 2 + 1
    else:
        kk, cv, ho = k, cin, hw
    out = [tconv.conv_route("fwd", dtype, kk, stride, cv, cout, batch, ho,
                            ho),
           tconv.conv_route("fwd", dtype, kk, 1, cout, cv, batch, ho + kk - 1,
                            ho + kk - 1, phase=stride == 2),
           tconv.conv_route("dw", dtype, kk, stride, cv, cout, batch, ho, ho,
                            same=same)]
    if stride == 1:
        out.append(tconv.conv_route("dw", dtype, kk, 1, cv, cout, batch, ho,
                                    ho, gtap=True))
    return kk, out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride,same", [(1, False), (1, True), (2, False)])
@pytest.mark.parametrize("k", range(1, 14))
def test_route_names_a_kernel_for_every_k(k, stride, same, dtype,
                                          monkeypatch):
    """Every route names a C entry of the port and a tiling that fits its
    kernel; bf16 runs on the tensor cores in the channel-major forms
    exactly where
    px_form says no; K7 at every k >= 2 where it is wanted (bf16: conv_dw_tc
    at DW_TC_GTAP_KS, conv_dw_px's cotangent-tapped mode at the other k,
    with a tiling that fits); fp32 K3, K4 and K7 on the split-TF32 forms (a
    tiling whose tap-row groups cover k and whose shared memory fits a
    block; K7's with its cotangent's channels tapped, Cin on N, over V's
    extent). None raises."""
    monkeypatch.setattr(tconv, "DW_TAP_ON_N", True)
    kk, routes = _routes(k, stride, same, dtype)
    for i, r in enumerate(routes):
        assert ENTRIES[(r.kernel, r.form)] == r.entry
        if dtype == torch.float32:
            if r.kernel == "K7":
                assert kk >= 2
                # cotangent-tapped: Cout's channels on M, Cin on N
                assert r.tiling == tconv.dw_tf32_tiling(
                    kk, 24, 20, 2, 37 + kk - 1, 37 + kk - 1, gtap=True)
            t = r.tiling
            assert r.form == "tf32" and 1 <= t.nb <= tconv.TF32_NB
            assert t.smem <= tconv.TF32_SMEM_MAX
            if r.kernel == "K3":
                assert t.n_dyg * t.ndy >= kk > (t.n_dyg - 1) * t.ndy
                assert t.smem == tconv.fwd_tf32_smem(kk, t.ndy, t.nb)
            else:
                assert -(-kk * kk * t.cb // 16) <= t.wm * tconv.tf32_upw(t.nb)
                assert t.smem == tconv.dw_tf32_smem(kk, t.cb, t.nb, t.wm,
                                                    r.kernel == "K7")
            continue
        phase = stride == 2
        if r.kernel == "K7":
            # conv_dw_tc's instances at DW_TC_GTAP_KS, conv_dw_px's
            # cotangent-tapped mode at every other k >= 2
            assert kk >= 2
            assert r.form == ("tc" if kk in tconv.DW_TC_GTAP_KS else "px")
            if r.form == "px":
                assert r.tiling == tconv.dw_px_gtap_tiling(
                    kk, 24, 20, 2, 37 + kk - 1, 37 + kk - 1)
        else:
            # Cout 24: K4's rule is K3's (dw_px_form)
            assert r.form == ("px" if tconv.px_form(kk, phase) else "tc")
        if r.form == "px" and r.kernel == "K3":
            t = r.tiling
            assert tconv.fwd_px_smem(kk, t.ndy, t.mt,
                                     1 if t.cps == 1 else 2) <= tconv.PX_SMEM
            assert t.n_dyg * t.ndy >= kk > (t.n_dyg - 1) * t.ndy
        if r.form == "px" and r.kernel in ("K4", "K7"):
            t = r.tiling
            assert tconv.dw_px_smem(kk, t.ndy, t.nb) <= tconv.PX_SMEM
            assert -(-t.ndy * kk // 8) <= 16 // t.nb
    if stride == 1:
        # K7 asked for by name: its own kernel at every k >= 2
        assert routes[3].kernel == ("K7" if kk >= 2 else "K4")


# The training net's bf16 K3/K4 calls (k <= 3: its 3x3 and 1x1, the k2 = 2
# phase kernels of its stride-2 3x3), at the 896 canvas (batch 2), the 448
# of two pairs and 224 of config c: (k, V's channels, Cout, batch, Ho, Wo,
# stride)
TRAINING_SITES = tuple(
    (k, cv, cout, 2, hw, hw, s)
    for canvas in (896, 448, 224)
    for i, (cd, up_in) in enumerate(((16, 36), (32, 68), (64, 132),
                                     (128, 132), (128, 132)))
    for hw in (canvas >> i,)
    for k, cv, cout, s in ((3, cd, cd, 1), (3, up_in, cd, 1), (1, cd, 4, 1),
                           (1, cd, cd, 1), (2, 4 * cd, cd, 2)))

# The inversion net's sites (limes at 224 x 281, B = 1; conv_forms.INV_SITES):
# 7x7 and 5x5 at stride 1, their stride-2 phase kernels k2 = 4 and 3, as
# (name, k, V's channels, Cout, Ho, Wo, stride)
INVERSION_SITES = tuple(
    (name, (k + 1) // 2 if s == 2 else k, s * s * cin, cout,
     (h - k) // s + 1, (w - k) // s + 1, s)
    for name, cin, cout, h, w, k, s in conv_forms.INV_SITES)
# where K4 keeps conv_dw_tc (dw_px_form: Cout 16 on 280 and 126 blocks)
K4_TC_SITES = ("up_conv s0", "down_conv1 s0")


@pytest.mark.parametrize("k,cv,cout,batch,ho,wo,stride", TRAINING_SITES)
def test_training_sites_keep_the_tc_forms(k, cv, cout, batch, ho, wo,
                                          stride):
    for op in ("fwd", "dw"):
        r = tconv.conv_route(op, torch.bfloat16, k, stride, cv, cout, batch,
                             ho, wo)
        assert r.form == "tc", r
    # the input gradient (the phase kernel's k2 = 2 read at stride 1)
    r = tconv.conv_route("fwd", torch.bfloat16, k, 1, cout, cv, batch,
                         ho + k - 1, wo + k - 1, phase=stride == 2)
    assert r.form == "tc"


@pytest.mark.parametrize("name,k,cv,cout,ho,wo,stride", INVERSION_SITES)
def test_inversion_sites_take_the_px_forms(name, k, cv, cout, ho, wo,
                                           stride):
    """K3 (forward and input gradient) on the pixel-major form at every
    site, as many blocks as a cluster's worth of splits allows; K4 too,
    a block for every two SMs, except at the two Cout-16 sites whose
    channel-major grid busies the card (tests/test_torch_conv_px_tiles.py
    checks the px tiling rules)."""
    r = tconv.conv_route("fwd", torch.bfloat16, k, stride, cv, cout, 1, ho,
                         wo)
    assert r.form == "px", r
    r = tconv.conv_route("dw", torch.bfloat16, k, stride, cv, cout, 1, ho,
                         wo)
    if name in K4_TC_SITES:
        assert r.form == "tc", r
        assert tconv.dw_tc_blocks(r.tiling, cv, cout) \
            >= tconv.DW_TC_BLOCKS // 8
    else:
        assert r.form == "px", r
        assert 2 * r.tiling.blocks >= tconv.PX_WAVE, r
    r = tconv.conv_route("fwd", torch.bfloat16, k, 1, cout, cv, 1,
                         ho + k - 1, wo + k - 1, phase=stride == 2)
    assert r.form == "px"


@pytest.mark.parametrize("k", range(3, 14))
@pytest.mark.parametrize("cout", (3, 16, 17, 64))
@pytest.mark.parametrize("stride", (1, 2))
def test_k4_keeps_the_tc_form_only_at_narrow_cout_on_a_busy_grid(
        k, cout, stride):
    """dw_px_form: at k >= 4 (and the 9-tap phase kernel) K4 takes the
    pixel-major form unless Cout <= 16, conv_dw_tc has an instance at k
    and its grid reaches DW_TC_BLOCKS // 8 blocks; a 14 x 14 map never
    gives that grid, a [2, 224, 224] one always does at Cout <= 16."""
    phase = stride == 2
    for batch, hw in ((1, 14), (1, 112), (2, 224)):
        r = tconv.conv_route("dw", torch.bfloat16, k, stride, 36, cout,
                             batch, hw, hw)
        if not tconv.px_form(k, phase):
            assert r.form == "tc"
            continue
        narrow = cout <= tconv.DW_TC_NARROW and k in tconv.DW_TC_KS
        busy = narrow and tconv.dw_tc_blocks(
            tconv.dw_tc_tiling(k, 36, cout, batch, hw, hw), 36,
            cout) >= tconv.DW_TC_BLOCKS // 8
        if tconv.dw_wg_form(k, phase, 36, cout, batch, hw, hw, (hw, hw)):
            # k >= WG_MIN_K on a large map: conv_dw_wg ahead of both
            assert k >= tconv.WG_MIN_K and not phase and hw in (112, 224)
            assert (r.form, r.entry) == ("wg", "conv_dw_wg"), r
            continue
        assert r.form == ("tc" if busy else "px"), (batch, hw, r)
        assert r.entry == ("conv_dw_tc" if busy else "conv_dw_px")
        if hw == 14:
            assert r.form == "px"
        if hw == 224 and narrow:
            assert r.form == "tc"


@pytest.mark.parametrize("k", [4, 6, 8, 9, 10, 11])
@pytest.mark.parametrize("cin,cout,batch,hw", [(36, 16, 2, 896),
                                               (68, 32, 2, 448),
                                               (36, 16, 1, 900)])
def test_px_gtap_tiling_fits_the_kernel(k, cin, cout, batch, hw):
    """bf16 K7 outside DW_TC_GTAP_KS at the SAME route's up_conv sites (and
    the entire A's B = 1): conv_dw_px's cotangent-tapped mode with Cout's
    channels tapped (one 16-channel group at Cout 16, two at 32), Cin on
    N in n8 tiles of at most PX_GTAP_NB a block (its instances), over V's
    extent [Ho + k - 1, Wo + k - 1]; its ring within PX_SMEM,
    the tap-row group's taps within the 8 warps' 16 / nb, V's tile within
    the PX_ITEMS pixels a thread holds, its partials within
    PX_GTAP_PARTIAL unless each image is one strip, strips of at most
    PX_GTAP_STAGES stages (or one row of stages) where the partials allow
    it, and a grid of at least half a wave."""
    r = tconv.conv_route("dw", torch.bfloat16, k, 1, cin, cout, batch, hw,
                         hw, gtap=True)
    hp = hw + k - 1
    t = tconv.dw_px_gtap_tiling(k, cout, cin, batch, hp, hp)
    if k >= tconv.WG_MIN_K and hw % 8 == 0:
        # these maps take conv_dw_wg from k = WG_MIN_K where TMA reads their
        # rows (tests/test_torch_conv_wg_tiles.py); the px mode's tiling
        # still fits wherever the route sends other maps
        assert (r.kernel, r.form, r.entry) == ("K7", "wg", "conv_dw_wg")
    else:
        assert (r.kernel, r.form, r.entry) == ("K7", "px", "conv_dw_px")
        assert t == r.tiling
    assert t.nb <= tconv.PX_GTAP_NB
    assert tconv.dw_px_smem(k, t.ndy, t.nb) <= tconv.PX_SMEM
    assert -(-t.ndy * k // 8) <= 16 // t.nb
    assert (tconv.PX_ROWS + t.ndy - 1) * (tconv.PX_COLS + k - 1) \
        <= tconv.PX_ITEMS * tconv.PX_THREADS
    assert t.rows % tconv.PX_ROWS == 0 and t.cols % tconv.PX_COLS == 0
    assert t.slices == batch * -(-hp // t.rows) * -(-hp // t.cols)
    slice_bytes = 4 * k * k * cin * cout
    if t.slices > batch:
        assert t.slices * slice_bytes <= tconv.PX_GTAP_PARTIAL
    stages = t.rows * t.cols // (tconv.PX_ROWS * tconv.PX_COLS)
    if stages > tconv.PX_GTAP_STAGES:
        # longer only where the partials force it: one row of stages more
        # would exceed PX_GTAP_PARTIAL
        assert t.rows == tconv.PX_ROWS or batch * -(-hp // (
            t.rows - tconv.PX_ROWS)) * slice_bytes > tconv.PX_GTAP_PARTIAL
    assert t.blocks == t.slices * -(-cout // 16) * -(-k // t.ndy) \
        * -(-cin // (8 * t.nb))
    assert 2 * t.blocks >= tconv.PX_WAVE


def test_gtap_route_follows_the_reference_rule(monkeypatch):
    """With `same`, K7 exactly where _gtap_better and DW_TAP_ON_N say so,
    at every odd k > 1 (the reference's _dw_impl rule); never with
    DW_TAP_ON_N off."""
    for k in (3, 5, 7, 9, 11):
        for cin, cout in ((36, 16), (4, 64), (16, 16)):
            want = tconv._gtap_better(k, cin, cout)
            r = tconv.conv_route("dw", torch.bfloat16, k, 1, cin, cout, 2,
                                 40, 40, same=True)
            assert (r.kernel == "K7") == want
            monkeypatch.setattr(tconv, "DW_TAP_ON_N", False)
            r = tconv.conv_route("dw", torch.bfloat16, k, 1, cin, cout, 2,
                                 40, 40, same=True)
            assert r.kernel == "K4"
            monkeypatch.setattr(tconv, "DW_TAP_ON_N", True)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("k,stride,pro", [(6, 1, False), (9, 1, False),
                                          (11, 2, False), (6, 1, True),
                                          (9, 1, True), (11, 2, True)])
def test_any_k_conv_matches_pallas(k, stride, pro):
    """kernel_conv_chw (pro False) and kernel_conv_bn_act_chw (pro True)
    against the reference's pallas_conv_chw and pallas_conv_bn_act_chw:
    [2, 4, 15, 17] -> 6 channels, the output and the input and weight
    gradients."""
    rng = np.random.default_rng(10 * k + stride + pro)
    x = rng.standard_normal((2, 4, 15, 17)).astype(np.float32)
    w = (0.2 * rng.standard_normal((k, k, 4, 6))).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    sh = rng.standard_normal(4).astype(np.float32)

    def jf(x, w):
        p = {"kernel": w, "bias": jnp.asarray(b)}
        if pro:
            return conv_pallas.pallas_conv_bn_act_chw(
                x, p, jnp.asarray(sc), jnp.asarray(sh), stride, "zero", 0.2)
        return conv_pallas.pallas_conv_chw(x, p, stride)

    out, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(out.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g))

    tx, tw = (torch.from_numpy(t).requires_grad_(True) for t in (x, w))
    p = {"kernel": tw, "bias": torch.from_numpy(b)}
    if pro:
        tout = tconv.kernel_conv_bn_act_chw(tx, p, torch.from_numpy(sc),
                                            torch.from_numpy(sh), stride,
                                            "zero", 0.2)
    else:
        tout = tconv.kernel_conv_chw(tx, p, stride)
    tout.backward(torch.from_numpy(g))
    assert tout.shape == out.shape
    _close(tout.detach().numpy(), out, "out")
    _close(tx.grad.numpy(), jdx, "dx")
    _close(tw.grad.numpy(), jdw, "dw")
