"""CPU rehearsal of the bf16 weight-gradient form for large maps (csrc/conv.cu
namespace wgdw, conv_dw_wg: K4 and K7 on wgmma, TMA-staged).

The kernel runs only on the card. This file emulates its work split in
torch at fp32, block by block, as ops.conv.dw_wg_tiling splits it: strips
of rows of a 64-pixel band (the bands starting `lead` columns early for
K7, so that every TMA box starts on a multiple of 8 elements), one
16-channel group of the tapped operand T, a group of tg consecutive taps
issued as wg_tiles(n) m64 tiles of 8 warps' units (tile j's unit in warp w
of warpgroup g is tap t0 + j * 8 + g * 4 + w, past the group's taps its
last tap, computed and never stored), N columns of the untapped operand U
in chunks, in either contraction order (V tapped, K4's; the cotangent
tapped, K7's; dw_wg_plan runs one of them for both kernels). T's rows land
raw ([16][tw] from t_lead columns left of the band, zero outside T,
K4's prologue applied as they are turned pixel-major) into a ring of rt
rows, written and read at the slots the kernel uses (a row at vy % rt, a
stage's tap row dy at (r0 + s + dy0) % rt + dy - dy0), one stage ahead of
the products as the kernel's warps produce it; U's box [N][64] is zero
outside U and past Cu (TMA's fill), K7's prologue applied to x's own
elements; the k16 steps run from the band's first column while they start
before Wp. Memory a block never writes, the ring's padding and its unused
rows hold NaN, so a read of any of them shows. conv_dw_sum_kernel adds the
strips' partials in its fixed order; K7's sum transposes and the wrapper
reverses the taps. The results are held against the plain versions
(conv_dw_plain, conv_dw_pro_plain, conv_dw_gtap_plain) at k = 9 and 11
with 1e-5 x the largest entry (fp32 sums in another order). The tiling
tests check what each tiling declares against what the kernel provides:
shared memory for one block an SM, chains of at most WG_CHAIN pixels, a
group's taps within the warpgroups' m64 tiles, the partials' bytes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from splice_tpu_torch.ops import conv

NAN = float("nan")
BAND, CS = conv.WG_BAND, conv.WG_PIXEL
PRODUCE = 1     # csrc wgdw::PRODUCE: stages a warp produces ahead


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (pytest-xdist runs
    six workers; tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read(x, scale, shift, negslope, pad, b, chans, vys, vxs):
    """x[b] at V coordinates through a border `pad` (stride 1): fp32
    [len(chans), len(vys), len(vxs)], zero outside x and past its channels,
    the prologue (and its bf16-free fp32 arithmetic) on x's own elements."""
    B, cin, H, W = x.shape
    ch = torch.as_tensor(list(chans))
    r, c = vys - pad, vxs - pad
    ok = (((r >= 0) & (r < H))[:, None] & ((c >= 0) & (c < W))[None, :])
    ok = ok[None] & (ch < cin)[:, None, None]
    v = x[b, ch.clamp(max=cin - 1)[:, None, None], r.clamp(0, H - 1)[:, None],
          c.clamp(0, W - 1)[None, :]].float()
    if scale is not None:
        row = b // (B // scale.shape[0])
        ci = ch.clamp(max=cin - 1)
        v = v * scale[row, ci][:, None, None] + shift[row, ci][:, None, None]
        if negslope != 1.0:
            v = torch.where(v >= 0, v, v * negslope)
    return torch.where(ok, v, torch.zeros(()))


def emulate_dw_wg(x, g, k, pad=0, scale=None, shift=None, negslope=1.0,
                  gtap=False):
    """conv_dw_wg's blocks and conv_dw_sum_kernel: fp32 [k, k, Cin, Cout]
    (K4: T = V = x through its border and prologue, U = g; gtap, K7: T = g
    with a border of k - 1, U = V over [Ho + k - 1, Wo + k - 1])."""
    B, cin = x.shape[:2]
    cout, ho, wo = g.shape[1:]
    if gtap:
        cs, cu, hp, wp, lead = cout, cin, ho + k - 1, wo + k - 1, -pad % 8
        top = (g, None, None, 1.0, k - 1)
        uop = (x, scale, shift, negslope, pad)
    else:
        cs, cu, hp, wp, lead = cin, cout, ho, wo, 0
        top = (x, scale, shift, negslope, pad)
        uop = (g, None, None, 1.0, 0)
    t = conv.dw_wg_tiling(k, cs, cu, B, hp, wp, lead)
    n, tw, rt = t.n, t.tw, t.rt
    bands = -(-(wp + lead) // BAND)
    n_rs = -(-hp // t.rows)
    assert t.slices == B * n_rs * bands
    assert t.tw == conv.wg_tile_width(k) and t.rt == conv.wg_ring_rows(k, t.tg)
    partial = torch.full((t.slices, k * k * cs * cu), NAN)
    lane = torch.arange(16)
    for strip in range(t.slices):
        b, sri = divmod(strip, n_rs * bands)
        r0 = (sri // bands) * t.rows
        x0 = (sri % bands) * BAND - lead
        t_lead = (x0 - top[4]) % 8
        n_st, q1 = min(t.rows, hp - r0), min(x0 + BAND, wp)
        for cg in range(t.ncg):
            c0 = 16 * cg
            for grp in range(t.groups):
                t0 = grp * t.tg
                units = min(t.tg, k * k - t0)
                dy0 = t0 // k
                nd = (t0 + units - 1) // k - dy0 + 1
                assert nd + conv.WG_STAGES - 1 <= rt
                assert units <= 8 * t.tiles
                # tile j, warpgroup wg, warp w: unit j * 8 + wg * 4 + w;
                # every tile issued
                u_idx = torch.arange(8 * t.tiles).clamp(max=units - 1)
                taps = t0 + u_idx
                dyl, dx = taps // k - dy0, taps % k
                for chunk in range(t.chunks):
                    n0 = chunk * n
                    ring = torch.full((rt, tw, CS), NAN)
                    boxes = {}

                    def produce(s):
                        last = r0 + s + dy0 + nd - 1
                        first = r0 + dy0 if s == 0 else last
                        for vy in range(first, last + 1):
                            raw = read(*top, b, range(c0, c0 + 16),
                                       torch.tensor([vy]),
                                       torch.arange(x0 - t_lead,
                                                    x0 - t_lead + tw))[:, 0]
                            ring[vy % rt, :, :16] = raw.t()
                        boxes[s % conv.WG_STAGES] = read(
                            *uop, b, range(n0, n0 + n),
                            torch.tensor([r0 + s]),
                            torch.arange(x0, x0 + BAND))[:, 0]

                    acc = torch.zeros(8 * t.tiles, 16, n)
                    for s in range(min(PRODUCE, n_st)):
                        produce(s)
                    for s in range(n_st):
                        if s + PRODUCE < n_st:
                            produce(s + PRODUCE)
                        vb = (r0 + s + dy0) % rt
                        rows = vb + dyl
                        rows = torch.where(rows >= rt, rows - rt, rows)
                        box = boxes[s % conv.WG_STAGES]
                        for kk in range(BAND // 16):
                            if x0 + 16 * kk >= q1:
                                break
                            # A (ldmatrix.trans): 16 pixels of each unit's
                            # tap row from t_lead + 16 kk + dx, 16 channels
                            cols = t_lead + 16 * kk + dx[:, None] + lane
                            a = ring[rows[:, None], cols][:, :, :16]
                            bm = box[:, 16 * kk:16 * kk + 16]    # [n, p]
                            acc += torch.einsum("upc,np->ucn", a, bm)
                    for ui in range(units):
                        for c in range(min(16, cs - c0)):
                            o = ((t0 + ui) * cs + c0 + c) * cu + n0
                            m = min(n, cu - n0)
                            partial[strip, o:o + m] = acc[ui, c, :m]
    nw = min(32, t.slices)
    sums = [_in_order(partial[w::nw]) for w in range(nw)]
    d = _in_order(torch.stack(sums))
    if gtap:
        return conv._reverse_taps(d.reshape(-1, cu).t().contiguous(), k)
    return d.reshape(k, k, cs, cu)


def _in_order(rows):
    out = rows[0].clone()
    for r in rows[1:]:
        out = out + r
    return out


def _check(got, want):
    tol = 1e-5 * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (err, tol)


def _inputs(seed, cin, cout, h, w, ho, wo, groups):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, cin, h, w), np.float32))
    g = torch.from_numpy(rng.standard_normal((2, cout, ho, wo), np.float32))
    if not groups:
        return x, g, None, None
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (groups, cin))
                          .astype(np.float32))
    sc[groups - 1, cin - 1] = -0.7
    sh = torch.from_numpy(rng.standard_normal((groups, cin), np.float32))
    return x, g, sc, sh


# (k, pad, Cin, Cout, H, W, BatchNorm stacks, gtap, WG_FILL): the SAME
# border of k = 9 and 11 (K7's bands then start 4 and 3 columns early, T's
# tile 3 and 1 columns early), VALID on a padded input, the prologue over
# two stacks (a negative scale) in both modes, two 16-channel groups of T
# (Cs 18, 20), H < k, Cin 3 (N 16), Cout 140 (two chunks of U), two bands,
# one strip of a whole map's rows (WG_FILL 1: the ring wraps) and strips
# of few rows (the grid's fill)
CASES = ((9, 4, 20, 18, 14, 70, 2, True, conv.WG_FILL),
         (11, 5, 3, 16, 9, 40, 0, True, conv.WG_FILL),
         (9, 4, 20, 12, 12, 72, 2, False, conv.WG_FILL),
         (11, 0, 5, 140, 16, 24, 0, False, conv.WG_FILL),
         (9, 4, 12, 20, 30, 20, 2, True, 1),
         (11, 5, 17, 24, 28, 12, 0, False, 1))


@pytest.mark.parametrize("k,pad,cin,cout,h,w,groups,gtap,fill", CASES)
def test_dw_wg_matches_plain(k, pad, cin, cout, h, w, groups, gtap, fill,
                             monkeypatch):
    monkeypatch.setattr(conv, "WG_FILL", fill)
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    x, g, sc, sh = _inputs(k + cin + cout, cin, cout, h, w, ho, wo, groups)
    ns = 0.2 if groups else 1.0
    got = emulate_dw_wg(x, g, k, pad, sc, sh, ns, gtap)
    if gtap:
        want = conv.conv_dw_gtap_plain(x, g, k, sc, sh, ns, pad)
    else:
        want = conv.conv_dw_pro_plain(x, g, k, sc, sh, ns, pad, 1) \
            if groups else conv.conv_dw_plain(
                torch.nn.functional.pad(x, (pad,) * 4), g, k)
    _check(got, want)


# The generator's up convs with filter_size_up 9 or 11 (SkipConfig's
# default widths, B = 2 at the 896 canvas; chip_smoke phase 6d): (name,
# Cin, Cout, S), SAME
UP_SITES = (("up_conv s0", 36, 16, 896), ("up_conv s1", 68, 32, 448),
            ("up_conv s2", 132, 64, 224), ("up_conv s3", 132, 128, 112),
            ("up_conv s4", 132, 128, 56))
# the order dw_wg_plan runs there (the cotangent tapped, K7's, but at s4,
# whose 56 x 56 map its k - 1 halo and the bands' lead widen by a band)
GTAP_ORDER = {"up_conv s0": True, "up_conv s1": True, "up_conv s2": True,
              "up_conv s3": True, "up_conv s4": False}


@pytest.mark.parametrize("gtap", (True, False))
@pytest.mark.parametrize("name,cin,cout,hw", UP_SITES)
@pytest.mark.parametrize("k", (9, 11))
def test_up_conv_sites_take_the_wg_form(k, name, cin, cout, hw, gtap):
    """bf16 K4 and K7 at k = 9 and 11 at the five up_conv sites: conv_dw_wg
    (SAME: the input as wide as the output; VALID on an input padded by
    k - 1, its width 8 more; a width not a multiple of 8 keeps conv_dw_px),
    with dw_wg_plan's tiling: whichever order dw_wg_cost finds cheaper,
    the same for K4 and K7 (GTAP_ORDER), costed with the lead its bands
    start with at x's border (-pad mod 8 in the cotangent-tapped order),
    the very tiling _launch_dw_wg launches."""
    for in_w in (None, hw, hw + k - 1):
        r = conv.conv_route("dw", torch.bfloat16, k, 1, cin, cout, 2, hw,
                            hw, gtap=gtap, in_w=in_w)
        want = (("K7" if gtap else "K4"), "wg", "conv_dw_wg")
        if in_w is not None and in_w % 8:
            want = (want[0], "px", "conv_dw_px")
        assert (r.kernel, r.form, r.entry) == want, r
        if r.form == "wg":
            pad = (k - 1) // 2 if in_w in (None, hw) else 0
            t = conv.dw_wg_plan(k, cin, cout, 2, hw, hw, in_w or hw)
            assert r.tiling == t and t.gtap == GTAP_ORDER[name]
            assert t.lead == (-pad % 8 if t.gtap else 0)
            orders = (conv.dw_wg_tiling(k, cin, cout, 2, hw, hw),
                      conv.dw_wg_tiling(k, cout, cin, 2, hw + k - 1,
                                        hw + k - 1, -pad % 8, gtap=True))
            assert conv.dw_wg_cost(t) == min(map(conv.dw_wg_cost, orders))
    # fp32 keeps the split-TF32 form; stride 2 and the phase kernels the
    # pixel-major or channel-major ones
    assert conv.conv_route("dw", torch.float32, k, 1, cin, cout, 2, hw, hw,
                           gtap=gtap).form == "tf32"
    assert conv.conv_route("dw", torch.bfloat16, (k + 1) // 2, 2, 4 * cin,
                           cout, 2, hw // 2, hw // 2).form != "wg"


@pytest.mark.parametrize("k", range(8, 14))
@pytest.mark.parametrize("cs,cu,batch,hp,wp", [
    (16, 36, 2, 904, 904), (36, 16, 2, 896, 896), (32, 68, 2, 456, 456),
    (68, 32, 2, 448, 448), (64, 132, 2, 232, 232), (132, 64, 2, 224, 224),
    (3, 5, 2, 7, 200), (16, 3, 1, 300, 300), (5, 141, 2, 40, 64),
    (20, 13, 1, 12, 1000)])
def test_wg_tiling_fits_the_kernel(k, cs, cu, batch, hp, wp):
    """dw_wg_tiling at k = 8 to 13 at the up_conv sites (both modes) and at
    edge shapes (H < k, 3 channels, Cu not a multiple of 8, Cu past one
    chunk): n an instance that holds a chunk; a group's taps within the
    two warpgroups' wg_tiles(n) m64 tiles of 4 units each; T's ring rows
    cover the most tap rows a group spans plus the stages in flight; T's
    staged width covers 7 columns of lead, the band and the halo, an odd
    count of 16-byte units within a TMA box; shared memory within one block
    an SM (WG_SMEM); each accumulator chain (a strip) at most WG_CHAIN
    pixels; slices and blocks as the kernel's grid counts them; where
    dw_wg_form admits the shape (read as a conv's V channels, Cout and
    output), its plan's shared memory and partials within WG_SMEM and
    WG_PARTIAL."""
    for lead in (0, 3):
        t = conv.dw_wg_tiling(k, cs, cu, batch, hp, wp, lead)
        assert t.chunks * t.n >= cu and t.n <= conv.WG_NS[-1]
        assert t.n == min(v for v in conv.WG_NS
                          if v >= 8 * -(-(-(-cu // 8)) // t.chunks))
        assert t.tiles == conv.wg_tiles(t.n)
        assert t.tg <= 8 * t.tiles and t.groups * t.tg >= k * k
        assert (t.groups - 1) * t.tg < k * k
        nd = max((min(t0 + t.tg, k * k) - 1) // k - t0 // k + 1
                 for t0 in range(0, k * k, t.tg))
        assert t.rt == nd + conv.WG_STAGES - 1
        assert t.tw % 16 == 8 and t.tw >= 7 + conv.WG_BAND + k - 1
        assert t.tw <= 256
        assert t.smem == conv.wg_smem(t.n, k, t.tg) <= conv.WG_SMEM
        # registers: accumulators and two A fragments within 168
        assert t.tiles * (t.n // 2 + 8) <= 168
        assert t.rows * conv.WG_BAND <= conv.WG_CHAIN
        bands = -(-(wp + lead) // conv.WG_BAND)
        assert t.slices == batch * -(-hp // t.rows) * bands
        assert t.blocks == t.slices * t.ncg * t.groups * t.chunks
        assert t.stages == t.ncg * t.groups * t.chunks * batch * bands * hp
        assert t.ncg == -(-cs // 16)
        assert t.lead == lead
    if conv.dw_wg_form(k, False, cs, cu, batch, hp, wp, (wp, wp)):
        p = conv.dw_wg_plan(k, cs, cu, batch, hp, wp, wp)
        assert p.smem <= conv.WG_SMEM
        assert 4 * p.slices * k * k * cs * cu <= conv.WG_PARTIAL


@pytest.mark.parametrize("gtap", (True, False))
def test_wg_launch_refuses_a_plan_for_another_border(gtap):
    """_launch_dw_wg launches the tiling it is given and no other: one whose
    bands' lead is not the kernel's at this border (-pad mod 8 in the
    cotangent-tapped order, 0 V tapped), whose partials would be counted
    for other bands, raises before any launch."""
    k, pad, hw = 9, 4, 56
    x = torch.zeros(2, 16, hw, hw, dtype=torch.bfloat16)
    g = torch.zeros(2, 16, hw, hw, dtype=torch.bfloat16)
    if gtap:
        bad = conv.dw_wg_tiling(k, 16, 16, 2, hw + k - 1, hw + k - 1, 0,
                                gtap=True)
    else:
        bad = conv.dw_wg_tiling(k, 16, 16, 2, hw, hw, -pad % 8)
    with pytest.raises(ValueError, match="lead"):
        conv._launch_dw_wg(x, g, k, pad, 1, None, None, 1.0, gtap, bad,
                           "conv_dw_wg")


@pytest.mark.parametrize("variant", ["no_mma", "no_steps", "no_transpose"])
def test_wg_ablation_variants_edit_the_kernel_source(variant):
    """tools/px_ablation.py --wg builds its variants by editing
    conv_dw_wg_kernel's text in csrc/conv.cu: each edit finds its text
    there exactly once, so the variants follow the kernel as it stands, and
    each removes what it names."""
    from splice_tpu_torch.tools import px_ablation
    src = px_ablation.variant_source(variant, wg=True)
    full = (px_ablation._build.CSRC_DIR / "conv.cu").read_text()
    assert src != full
    assert ("wg_rs<N>(acc[j], a[kk & 1][j]" in src) == (variant != "no_mma")
    assert ("if (kk >= 0) break;" in src) == (variant == "no_steps")
    assert ("op < 0 * n_ops" in src) == (variant == "no_transpose")
