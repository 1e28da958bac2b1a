"""CPU rehearsal of fp32 K7 on the tensor cores: conv_dw_tf32's
cotangent-tapped mode (csrc/conv.cu tc32::conv_dw_tf32_kernel<NB, true>).

The kernel runs only on the card. tests/test_torch_conv_tf32_tiles.py's
emulate_dw(..., gtap=True) emulates it block by block in torch, as
ops.conv.dw_tf32_tiling(..., gtap=True) splits the work: strips of V's
extent (Ho + k - 1) x (Wo + k - 1) in stages of TF32_DW_ROWS x
TF32_DW_COLS pixels, chunks of the cotangent's channels (M = the (tap',
co) rows), chunks of Cin in n8 tiles (N), the k8 steps among 8 // wm row
groups. The tapped operand is the cotangent read with a border of k - 1
(zero outside g), staged raw from up to TF32_LEAD columns left of the
stage as K4 stages V; the untapped operand is V, staged raw from up to
TF32_LEAD columns left of the stage (zero past Cin and outside x) and
split once a stage, the split pass applying the prologue (two roundings,
then leaky) to x's own elements. Memory the kernel never writes holds NaN,
so a read of it shows; products are split TF32
(tests/test_torch_tf32_split.py's rounding: three exact TF32 products
summed in fp32, a fresh fragment each k8 step), and the strips are added
and transposed in conv_dw_sum_kernel<true>'s fixed order.

Held against conv_dw_gtap_plain at k = 2 (VALID), 3, 5 and 7, at the SAME
sites' channel counts (36 -> 16, 68 -> 32) on small maps, with and without
the prologue, two BatchNorm stacks with a scale of 1e-13, W = 37 and H < k,
within 1e-5 x the largest entry (fp32 sums in another order); against
float64 within the card's 1e-4 x max gate; against the reference's
_dw_gtap_impl in interpret mode at one small SAME shape with the prologue;
and the gtap tilings against what the kernel provides at k = 2, 3, 5, 7,
9 and 11 and every site.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.ops import conv_pallas
from splice_tpu_torch.ops import conv
from test_torch_conv_tf32_tiles import DC, DR, _check, emulate_dw, mm_k8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, cin, cout, h, w, k, pad, groups=0, ns=0.2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, cin, h, w), np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (B, cout, h + 2 * pad - k + 1, w + 2 * pad - k + 1), np.float32))
    if not groups:
        return x, g, (None, None, 1.0)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (groups, cin))
                          .astype(np.float32))
    sc[0, 0] = 1e-13
    sc[groups - 1, cin - 1] = -0.7
    sh = torch.from_numpy(rng.standard_normal((groups, cin), np.float32))
    return x, g, (sc, sh, ns)


# (k, pad, Cin, Cout, H, W, BatchNorm stacks): the SAME route's two K7
# sites (up_conv s0 36 -> 16, up_conv s1 68 -> 32: Cin over two n8 chunks)
# at k = 3, 5 and 7 on small maps, with and without the prologue; W = 37
# (Wo % 4 != 0: g and V by 4-byte copies) and H < k with two stacks; VALID
# K7 (border 0 on a padded input) at k = 2 and 3
CASES = (
    (3, 1, 36, 16, 9, 40, 0),
    (3, 1, 36, 16, 9, 40, 2),
    (3, 1, 68, 32, 7, 21, 0),
    (3, 1, 68, 32, 7, 21, 2),
    (5, 2, 36, 16, 10, 37, 2),
    (5, 2, 68, 32, 6, 13, 0),
    (7, 3, 36, 16, 9, 23, 0),
    (7, 3, 68, 32, 6, 13, 2),
    (3, 1, 20, 40, 9, 37, 2),
    (3, 1, 20, 40, 2, 37, 0),
    (5, 2, 12, 20, 3, 37, 2),
    (2, 0, 20, 40, 11, 39, 2),
    (3, 0, 20, 40, 11, 39, 0),
)


@pytest.mark.parametrize("k,pad,cin,cout,h,w,groups", CASES)
def test_gtap_matches_plain(k, pad, cin, cout, h, w, groups):
    x, g, a = _inputs(k + cin + h + w, 2, cin, cout, h, w, k, pad, groups)
    r = conv.conv_route("dw", torch.float32, k, 1, cin, cout, 2,
                        g.shape[2], g.shape[3], gtap=True)
    assert (r.kernel, r.form, r.entry) == ("K7", "tf32", "conv_dw_tf32")
    _check(emulate_dw(x, g, k, pad, 1, *a, gtap=True),
           conv.conv_dw_gtap_plain(x, g, k, *a, pad))


@pytest.mark.parametrize("k", [3, 7])
def test_gtap_meets_the_fp32_gate_against_float64(k):
    """The emulated kernel against the plain version in float64 at the
    36 -> 16 site's widths, with the prologue: within 1e-4 x max (the
    card's gate); and at a strip's contraction length of up_conv s0 (4
    rows of the 898-wide V), products formed as the kernel forms them lie
    within it where one TF32 product does not."""
    x, g, a = _inputs(k, 2, 36, 16, 12, 44, k, (k - 1) // 2, 2)
    want = conv.conv_dw_gtap_plain(x.double(), g.double(), k,
                                   *(t.double() for t in a[:2]), a[2],
                                   (k - 1) // 2)
    got = emulate_dw(x, g, k, (k - 1) // 2, 1, *a, gtap=True)
    _check(got, want, 1e-4)
    rng = np.random.default_rng(k)
    L = 4 * 898
    u = torch.from_numpy(rng.standard_normal((9 * 16, L), np.float32))
    v = torch.from_numpy(rng.standard_normal((L, 40), np.float32))
    ref = u.double() @ v.double()
    top = ref.abs().max().item()
    err = (mm_k8(u, v).double() - ref).abs().max().item() / top
    one = (mm_k8(u, v, True).double() - ref).abs().max().item() / top
    assert err < 1e-4 < one, (err, one)


def test_gtap_matches_the_pallas_kernel_in_interpret_mode():
    """The emulated K7 on [2, 12, 14, 40] -> 5 channels, k = 3, SAME with
    the prologue (ns 0.2), against conv_pallas._dw_gtap_impl (the
    reference's _make_dw_kernel_gtap in interpret mode on the CPU; its
    SAME input rows padded with the prologue's pre-image), within 1e-5 x
    the largest entry."""
    k, cin, cout, ns = 3, 12, 5, 0.2
    rng = np.random.default_rng(18)
    x = rng.standard_normal((2, cin, 14, 40)).astype(np.float32)
    g = rng.standard_normal((2, cout, 14, 40)).astype(np.float32)
    sc = (rng.random(cin) + 0.5).astype(np.float32)
    sh = rng.standard_normal(cin).astype(np.float32)
    vrow = np.broadcast_to((-sh / sc)[None, :, None, None], (2, cin, 1, 40))
    xp = np.concatenate([vrow, x, vrow], axis=2)
    jdw = conv_pallas._dw_gtap_impl(jnp.asarray(xp), jnp.asarray(g), k,
                                    jnp.asarray(sc), jnp.asarray(sh), ns,
                                    same=True)
    got = emulate_dw(torch.from_numpy(x), torch.from_numpy(g), k, 1, 1,
                     torch.from_numpy(sc)[None], torch.from_numpy(sh)[None],
                     ns, gtap=True)
    _check(got, torch.from_numpy(np.array(jdw)))


def _gtap_calls():
    """fp32 K7 launches: the SAME route's sites at k = 2, 3, 5, 7, 9, 11
    (up_conv s0 [2, 36, 896, 896] -> 16 and up_conv s1 [2, 68, 448, 448]
    -> 32), the
    entire-A B = 1 shapes from 900 x 1200, VALID K7 at k = 2, and the edge
    shapes of chip_smoke's DW_EDGES: (k, Cin, Cout, B, Ho, Wo)."""
    out = []
    for k in (2, 3, 5, 7, 9, 11):
        out += [(k, 36, 16, 2, 896, 896), (k, 68, 32, 2, 448, 448),
                (k, 36, 16, 1, 900, 1200), (k, 68, 32, 1, 450, 600)]
    out += [(2, 20, 40, 2, 10, 38), (3, 20, 40, 2, 9, 37),
            (3, 20, 40, 2, 2, 37), (3, 3, 16, 2, 20, 37),
            (3, 136, 128, 2, 14, 14)]
    return out


@pytest.mark.parametrize("k,cin,cout,batch,ho,wo", _gtap_calls())
def test_gtap_tiling_fits_the_kernel(k, cin, cout, batch, ho, wo):
    """conv_route's fp32 K7 tiling fits conv_dw_tf32's gtap mode: Cout's
    channels tapped on M within the warps' m16 tiles, Cin on N in evened
    chunks of at most TF32_NB n8 tiles (68 = two chunks of five), shared
    memory (with V's raw rows tf32_rs(TF32_DW_COLS) long) within
    TF32_SMEM (two blocks an SM), at most 64 accumulators a thread, strips of whole stages
    covering V's extent, the partials within TF32_PARTIAL unless each image
    is one strip, and a grid of at least half TF32_BLOCKS where the work has
    the stages."""
    r = conv.conv_route("dw", torch.float32, k, 1, cin, cout, batch, ho, wo,
                        gtap=True)
    t = r.tiling
    hp, wp = ho + k - 1, wo + k - 1
    assert t == conv.dw_tf32_tiling(k, cout, cin, batch, hp, wp, gtap=True)
    upw = conv.tf32_upw(t.nb)
    assert 1 <= t.nb <= conv.TF32_NB and upw * t.nb * 4 <= 64
    assert 8 * t.nb * t.n_co >= cin > 8 * t.nb * (t.n_co - 1)
    if cin == 68:
        assert (t.nb, t.n_co) == (5, 2)
    assert t.wm in (1, 2, 4, 8) and -(-k * k * t.cb // 16) <= t.wm * upw
    assert t.m_chunks == -(-cout // t.cb)
    urs = conv.tf32_rs(conv.TF32_DW_COLS)
    assert urs >= conv.TF32_LEAD + conv.TF32_DW_COLS
    assert t.smem == conv.dw_tf32_smem(k, t.cb, t.nb, t.wm, True)
    assert t.smem > conv.dw_tf32_smem(k, t.cb, t.nb, t.wm)
    assert t.smem <= conv.TF32_SMEM   # two blocks an SM at every site
    assert t.rows % DR == 0 and t.cols % DC == 0
    assert t.slices == batch * -(-hp // t.rows) * -(-wp // t.cols)
    assert t.blocks == t.slices * t.m_chunks * t.n_co
    if t.slices > batch:
        assert t.slices * 4 * k * k * cin * cout <= conv.TF32_PARTIAL
    stages = batch * -(-hp // DR) * -(-wp // DC)
    assert 2 * t.blocks >= min(conv.TF32_BLOCKS, stages)
