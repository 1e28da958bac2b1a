"""CPU rehearsal of the pixel-major bf16 conv kernels' work split.

csrc/conv.cu namespace px (conv_fwd_px: K3 at 16 taps or more and at the
k2 = 3 phase kernels; conv_dw_px: K4 there) runs only on the card. This
file emulates its index arithmetic in torch at fp32, block by block, as
ops.conv.fwd_px_tiling and dw_px_tiling split the work: the output tiles
and Cout chunks, the contraction split into tap-row groups and channel
chunks (K3) or channel groups and tap-row groups beside pixel strips (K4),
each block's shared-memory tiles laid out as the kernel lays them out (V
pixel-major, 16 channels of a chunk in a 24-element row; K3's weights
[tap][c][co] with a 16 mt + 8 row stride; K4's g tile [co][row][col] with
its padded strides), every operand read at the element address the
kernel's ldmatrix lanes give it, K3's splits added in a cluster's shared
memory in rank order (up to PX_CLUSTER splits) or through fp32 partial
slots and the second pass (conv_split_sum_kernel, with its K3''' sums),
and K4's strips through conv_dw_sum_kernel's fixed order. Memory a block
never writes holds NaN, and the tiles' padding holds NaN, so a read of
either shows. The results are held
against the plain versions at every site of the inversion net (limes at
224 x 281) and at edge shapes, with a tolerance of 1e-5 x the largest
entry (fp32 sums in another order). The tiling tests check what each
tiling declares against what the kernel provides: shared memory, the
pixels a thread holds, the accumulators, and the grid each rule aims at
where the work allows.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from splice_tpu_torch.ops import conv
from splice_tpu_torch.tools import conv_forms

NAN = float("nan")
TR, TC, CS = conv.PX_ROWS, conv.PX_COLS, conv.PX_PIXEL
GC = TC + 8
GP = conv.PX_G_PLANE


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_src(x, scale, shift, negslope, pad, stride, b, chans, vys, vxs):
    """x[b] through the kernels' Src mapping at V coordinates: channels
    chans (phase-major at stride 2; zero past V's), rows vys, columns vxs
    -> fp32 [len(chans), len(vys), len(vxs)]; zero outside x, the prologue
    on x's own pixels only."""
    B, cin, H, W = x.shape
    ch = torch.as_tensor(chans)
    cv = cin * stride * stride
    ph = ch // cin if stride == 2 else torch.zeros_like(ch)
    ci, py, px = (ch - ph * cin).clamp(max=cin - 1), ph >> 1, ph & 1
    r = stride * vys[None, :] + py[:, None] - pad
    c = stride * vxs[None, :] + px[:, None] - pad
    ok = (((r >= 0) & (r < H))[:, :, None] & ((c >= 0) & (c < W))[:, None, :]
          & (ch < cv)[:, None, None])
    v = x[b, ci[:, None, None], r.clamp(0, H - 1)[:, :, None],
          c.clamp(0, W - 1)[:, None, :]].float()
    if scale is not None:
        row = b // (B // scale.shape[0])
        v = v * scale[row, ci][:, None, None] + shift[row, ci][:, None, None]
        if negslope != 1.0:
            v = torch.where(v >= 0, v, v * negslope)
    return torch.where(ok, v, torch.zeros(()))


def v_tile(operand, b, c0, vy0, vx0, nrows, vcols):
    """load_v16 + store_v16: 16 channels from c0 of a nrows x vcols tile
    from (vy0, vx0), pixel-major with CS elements a pixel (the last 8
    NaN)."""
    v = read_src(*operand, b, range(c0, c0 + 16),
                 torch.arange(vy0, vy0 + nrows), torch.arange(vx0, vx0 + vcols))
    tile = torch.full((nrows * vcols, CS), NAN)
    tile[:, :16] = v.permute(1, 2, 0).reshape(-1, 16)
    return tile.reshape(-1)


def emulate_fwd_px(x, w, out_hw, pad=0, stride=1, scale=None, shift=None,
                   negslope=1.0, stats=False):
    """conv_fwd_px's blocks, then the sum of their splits: in a cluster's
    shared memory (up to PX_CLUSTER splits), else by the second pass: y
    (fp32), and with stats the K3''' [G, 2, Cout] sums per stack."""
    B, cin = x.shape[:2]
    k, _, cv, cout = w.shape
    ho, wo = out_hw
    t = conv.fwd_px_tiling(k, cv, cout, B, ho, wo)
    mrows, ws, vcols = 16 * t.mt, 16 * t.mt + 8, TC + k - 1
    n_cc = -(-cv // 16)
    operand = (x, scale, shift, negslope, pad, stride)
    direct = t.splits == 1 and not stats
    cluster = 1 < t.splits <= conv.PX_CLUSTER and not stats
    tiles = []
    y = torch.full((B, cout, ho, wo), NAN)
    partial = torch.full((t.splits, B, cout, ho, wo), NAN)
    wr = w.float().reshape(k * k, cv, cout)
    for b in range(B):
        for y0 in range(0, ho, TR):
            for x0 in range(0, wo, TC):
                for co0 in range(0, cout, mrows):
                    for z in range(t.splits):
                        dyg, csi = divmod(z, t.n_cs)
                        dy0 = dyg * t.ndy
                        nd = min(t.ndy, k - dy0)
                        u0 = csi * t.cps
                        acc = torch.zeros(mrows, TR, TC)
                        for u in range(u0, min(u0 + t.cps, n_cc)):
                            c0 = 16 * u
                            vt = v_tile(operand, b, c0, y0 + dy0, x0,
                                        TR + nd - 1, vcols)
                            # stage_w: [tap][c][co], zero past Cv and
                            # Cout, NaN in each row's padding
                            wt = torch.full((nd * k * 16, ws), NAN)
                            tap = dy0 * k + torch.arange(nd * k)
                            cc = (c0 + torch.arange(16)).clamp(max=cv - 1)
                            co = (co0 + torch.arange(mrows)).clamp(
                                max=cout - 1)
                            ok = ((c0 + torch.arange(16) < cv)[None, :, None]
                                  & (co0 + torch.arange(mrows)
                                     < cout)[None, None, :])
                            wt[:, :mrows] = torch.where(
                                ok, wr[tap][:, cc][:, :, co],
                                torch.zeros(())).reshape(-1, mrows)
                            wt = wt.reshape(-1)
                            tl = torch.arange(nd * k)
                            dyl, dx = tl // k, tl % k
                            c = torch.arange(16)
                            # A: ldmatrix.trans rows (tl * 16 + c) at co
                            a = wt[((tl[:, None] * 16 + c[None]) * ws)[
                                :, :, None] + torch.arange(mrows)]
                            # B: ldmatrix rows = pixels (warp row + dyl,
                            # column + dx) at channel c
                            rr = torch.arange(TR)
                            pc = torch.arange(TC)
                            idx = (((rr[None, :, None] + dyl[:, None, None])
                                    * vcols + pc[None, None, :]
                                    + dx[:, None, None]) * CS)
                            bv = vt[idx[:, None] + c[None, :, None, None]]
                            acc += torch.einsum("tcm,tcrp->mrp", a, bv)
                        rows = min(TR, ho - y0)
                        cols = min(TC, wo - x0)
                        cos = min(mrows, cout - co0)
                        blk = acc[:cos, :rows, :cols]
                        if direct:
                            y[b, co0:co0 + cos, y0:y0 + rows,
                              x0:x0 + cols] = blk
                        elif cluster:
                            # the block's tile in its shared memory: the
                            # warps of rows past Ho write nothing
                            red = torch.full((mrows, TR * TC + 8), NAN)
                            red[:, :rows * TC] = acc[:, :rows].reshape(
                                mrows, -1)
                            tiles.append(red)
                        else:
                            partial[z, b, co0:co0 + cos, y0:y0 + rows,
                                    x0:x0 + cols] = blk
                    if cluster:
                        # the cluster adds its blocks' tiles in rank order
                        out = tiles[0][:, :rows * TC].clone()
                        for red in tiles[1:]:
                            out = out + red[:, :rows * TC]
                        y[b, co0:co0 + cos, y0:y0 + rows, x0:x0 + cols] = \
                            out.reshape(mrows, rows, TC)[:cos, :, :cols]
                        tiles.clear()
    if direct or cluster:
        return y
    y = partial[0].clone()
    for z in range(1, t.splits):          # conv_split_sum_kernel's order
        y = y + partial[z]
    if not stats:
        return y
    groups = scale.shape[0]
    per = B // groups
    hw = ho * wo
    chunks = -(-hw // conv.PX_PCH)
    flat = y.reshape(B, cout, hw)
    part = torch.full((B * chunks, 2, cout), NAN)
    for b in range(B):
        for ch in range(chunks):
            seg = flat[b, :, ch * conv.PX_PCH:(ch + 1) * conv.PX_PCH]
            part[b * chunks + ch, 0] = seg.sum(1)
            part[b * chunks + ch, 1] = (seg * seg).sum(1)
    st = part.reshape(groups, per * chunks, 2, cout).sum(1)
    return y, st


def emulate_dw_px(x, g, k, pad=0, stride=1, scale=None, shift=None,
                  negslope=1.0, gtap=False):
    """conv_dw_px's blocks and conv_dw_sum_kernel: fp32 [k, k, Cs, Cu].
    gtap (K7's cotangent-tapped mode): the tapped operand is g read with a
    border of k - 1, the untapped one V over [Ho + k - 1, Wo + k - 1]
    (load_u: x through Src, the prologue on x's own pixels), Cs = Cout, Cu
    = Cin; the sum transposes to [Cin, k*k*Cout] and the taps are reversed
    as the wrapper reverses them: fp32 [k, k, Cin, Cout]."""
    B, cin = x.shape[:2]
    if gtap:
        ho, wo = g.shape[2:]
        cs, cu, hp, wp = g.shape[1], cin, ho + k - 1, wo + k - 1
        t = conv.conv_route("dw", torch.bfloat16, k, 1, cin, cs, B, ho, wo,
                            gtap=True).tiling
        assert t == conv.dw_px_gtap_tiling(k, cs, cu, B, hp, wp)
        operand = (g, None, None, 1.0, k - 1, 1)
        uop = (x, scale, shift, negslope, pad, 1)
    else:
        cu, hp, wp = g.shape[1:]
        cs = stride * stride * cin
        t = conv.dw_px_tiling(k, cs, cu, B, hp, wp)
        operand = (x, scale, shift, negslope, pad, stride)
    nb8, vcols = 8 * t.nb, TC + k - 1
    strips = [(b, r0, q0) for b in range(B) for r0 in range(0, hp, t.rows)
              for q0 in range(0, wp, t.cols)]
    assert len(strips) == t.slices
    partial = torch.full((t.slices, k * k * cs * cu), NAN)
    gf = g.float()
    for sl, (b, r0, q0) in enumerate(strips):
        r1, q1 = min(r0 + t.rows, hp), min(q0 + t.cols, wp)
        for ch0 in range(0, cs, 16):
            for dy0 in range(0, k, t.ndy):
                nd = min(t.ndy, k - dy0)
                ntaps = nd * k
                tl = torch.arange(ntaps)
                dyl, dx = tl // k, tl % k
                for n0 in range(0, cu, nb8):
                    acc = torch.zeros(ntaps, 16, nb8)
                    for y0 in range(r0, r1, TR):
                        for x0 in range(q0, q1, TC):
                            vt = v_tile(operand, b, ch0, y0 + dy0, x0,
                                        TR + nd - 1, vcols)
                            # load_g / store_g: zero past the strip and Cu,
                            # NaN in the tile's padding
                            gt = torch.full((nb8, GP), NAN)
                            view = gt[:, :TR * GC].reshape(nb8, TR, GC)
                            view[:, :, :TC] = 0.0
                            us = min(nb8, cu - n0)
                            ys, xs = min(TR, r1 - y0), min(TC, q1 - x0)
                            if gtap:
                                view[:us, :ys, :xs] = read_src(
                                    *uop, b, range(n0, n0 + us),
                                    torch.arange(y0, y0 + ys),
                                    torch.arange(x0, x0 + xs))
                            else:
                                view[:us, :ys, :xs] = gf[b, n0:n0 + us,
                                                         y0:y0 + ys,
                                                         x0:x0 + xs]
                            gt = gt.reshape(-1)
                            # the k16 steps run: stage rows before r1,
                            # 16-column blocks starting before q1
                            rows = torch.arange(ys)
                            cols = torch.arange(16 * -(-xs // 16))
                            pix = (rows[:, None] * vcols
                                   + cols[None, :]).reshape(-1)
                            gpix = (rows[:, None] * GC
                                    + cols[None, :]).reshape(-1)
                            c = torch.arange(16)
                            # A (ldmatrix.trans): V at pixel + tap offset,
                            # channel c
                            aidx = ((pix[None, :] + (dyl * vcols
                                                     + dx)[:, None]) * CS)
                            av = vt[aidx[:, :, None] + c]    # [t, p, c]
                            # B (ldmatrix): g's plane co at the pixel
                            bv = gt[torch.arange(nb8)[None, :] * GP
                                    + gpix[:, None]]          # [p, co]
                            acc += torch.einsum("tpc,pu->tcu", av, bv)
                    for i in range(ntaps):
                        tt = dy0 * k + i
                        for cc in range(min(16, cs - ch0)):
                            o = (tt * cs + ch0 + cc) * cu + n0
                            us = min(nb8, cu - n0)
                            partial[sl, o:o + us] = acc[i, cc, :us]
    # conv_dw_sum_kernel: warp w adds slices w, w + nw, ...; then the warps
    # in order
    nw = min(32, t.slices)
    s = [partial[w::nw].sum(0) if len(partial[w::nw]) == 1 else
         _in_order(partial[w::nw]) for w in range(nw)]
    d = _in_order(torch.stack(s))
    if gtap:
        # conv_dw_sum_kernel<true>: D[(t', co), ci] -> [Cin, k*k*Cout]
        return conv._reverse_taps(d.reshape(-1, cu).t().contiguous(), k)
    return d.reshape(k, k, cs, cu)


def _in_order(rows):
    out = rows[0].clone()
    for r in rows[1:]:
        out = out + r
    return out


def _inputs(seed, B, cin, h, w, k, cv, cout, groups=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, cin, h, w), np.float32))
    wt = torch.from_numpy(
        (0.2 * rng.standard_normal((k, k, cv, cout))).astype(np.float32))
    if not groups:
        return x, wt, None, None
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (groups, cin))
                          .astype(np.float32))
    sc[groups - 1, cin - 1] = -0.7
    sh = torch.from_numpy(rng.standard_normal((groups, cin), np.float32))
    return x, wt, sc, sh


def _check(got, want):
    tol = 1e-5 * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (err, tol)


# The inversion net's sites on limes at 224 x 281 (conv_forms.INV_SITES):
# (Cin, Cout, H, W of the reflection-padded input, k, stride)
INV_SITES = tuple(site[1:] for site in conv_forms.INV_SITES)


def _site(cin, cout, h, w, k, stride, seed):
    x, wt, _, _ = _inputs(seed, 1, cin, h, w, k, cin, cout)
    if stride == 2:
        wt = conv.s2d_kernel(wt)
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    return x, wt, (ho, wo)


@pytest.mark.parametrize("cin,cout,h,w,k,stride", INV_SITES)
def test_fwd_px_matches_plain_at_the_inversion_sites(cin, cout, h, w, k,
                                                     stride):
    x, wt, out_hw = _site(cin, cout, h, w, k, stride, k + cin)
    assert conv.px_form(wt.shape[0], stride == 2)
    _check(emulate_fwd_px(x, wt, out_hw, 0, stride),
           conv.conv_valid_pro_plain(x, wt, None, None, 1.0, 0, stride,
                                     out_hw))


@pytest.mark.parametrize("cin,cout,h,w,k,stride", INV_SITES)
def test_input_gradient_px_matches_plain_at_the_inversion_sites(
        cin, cout, h, w, k, stride):
    """The input gradient as ConvValidPro.backward launches it: the
    cotangent through the flipped, io-swapped kernel with the border k-1
    (stride 1, VALID) or k2 - 1 on the phase kernel, read at stride 1."""
    _, wt, (ho, wo) = _site(cin, cout, h, w, k, stride, k + cin + 1)
    kk = wt.shape[0]
    rng = np.random.default_rng(cout + k)
    g = torch.from_numpy(rng.standard_normal((1, cout, ho, wo), np.float32))
    w_flip = torch.flip(wt, dims=(0, 1)).transpose(2, 3).contiguous()
    out = conv._out_hw(g, kk, kk - 1)
    assert conv.conv_route("fwd", torch.bfloat16, kk, 1, cout, wt.shape[2],
                           1, *out, phase=stride == 2).form == "px"
    _check(emulate_fwd_px(g, w_flip, out, kk - 1),
           conv.conv_valid_plain(g, w_flip, kk - 1))


@pytest.mark.parametrize("cin,cout,h,w,k,stride", INV_SITES)
def test_dw_px_matches_plain_at_the_inversion_sites(cin, cout, h, w, k,
                                                    stride):
    x, wt, (ho, wo) = _site(cin, cout, h, w, k, stride, k + cout)
    kk = wt.shape[0]
    rng = np.random.default_rng(cin + cout + k)
    g = torch.from_numpy(rng.standard_normal((1, cout, ho, wo), np.float32))
    _check(emulate_dw_px(x, g, kk, 0, stride),
           conv.conv_dw_pro_plain(x, g, kk, None, None, 1.0, 0, stride))


# K7's cotangent-tapped mode of conv_dw_px (bf16 K7 at every k outside
# DW_TC_GTAP_KS): (k, pad, Cin, Cout, H, W, BatchNorm stacks): the SAME
# border of k = 9 and 11 with the prologue over two stacks (a negative
# scale), k = 4 and 6 with a border of 1 (even k: no SAME pad), Cin 3 and
# 40 (ragged n8 chunks of the untapped V), H < k, and widths past one
# 32-column stage
GTAP_PX_CASES = ((9, 4, 12, 20, 13, 37, 2), (11, 5, 3, 16, 9, 21, 0),
                 (4, 1, 40, 8, 10, 45, 2), (6, 1, 12, 24, 5, 40, 0))


@pytest.mark.parametrize("k,pad,cin,cout,h,w,groups", GTAP_PX_CASES)
def test_dw_px_gtap_matches_plain(k, pad, cin, cout, h, w, groups):
    x, _, sc, sh = _inputs(k + cin, 2, cin, h, w, 1, 1, 1, groups)
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    rng = np.random.default_rng(cout + k)
    g = torch.from_numpy(rng.standard_normal((2, cout, ho, wo), np.float32))
    ns = 0.2 if groups else 1.0
    route = conv.conv_route("dw", torch.bfloat16, k, 1, cin, cout, 2, ho, wo,
                            gtap=True)
    assert (route.kernel, route.form, route.entry) == ("K7", "px",
                                                       "conv_dw_px")
    _check(emulate_dw_px(x, g, k, pad, 1, sc, sh, ns, gtap=True),
           conv.conv_dw_gtap_plain(x, g, k, sc, sh, ns, pad))


# Edge shapes: (k, pad, stride, Cin, Cout, H, W, BatchNorm stacks,
# negslope, stats): the prologue with two stacks (a negative scale);
# K3''' sums through the second pass (the SAME border of k = 5); Cout 6 and
# 36 (ragged m16 tiles, weights staged element by element); Cin 3 and 20
# (ragged channel chunks); H < k; the filter sizes no generator default
# takes: 6, 9 and 13 at stride 1, 11 and 6 at stride 2 (k2 = 6, 3)
EDGE_CASES = (
    (7, 3, 1, 5, 36, 4, 37, 2, 0.2, False),
    (5, 2, 1, 20, 6, 13, 40, 2, 0.2, True),
    (5, 2, 1, 3, 16, 9, 33, 2, 1.0, True),
    (6, 2, 1, 4, 6, 15, 17, 0, 1.0, False),
    (9, 4, 1, 4, 6, 15, 17, 2, 0.2, False),
    (13, 6, 1, 3, 10, 11, 19, 0, 1.0, False),
    (11, 5, 2, 4, 6, 15, 17, 2, 0.2, False),
    (6, 2, 2, 20, 36, 21, 35, 0, 1.0, False),
    (4, 0, 1, 8, 5, 9, 39, 0, 1.0, False),
)


@pytest.mark.parametrize("k,pad,stride,cin,cout,h,w,groups,ns,stats",
                         EDGE_CASES)
def test_px_forms_match_plain_at_edge_shapes(k, pad, stride, cin, cout, h,
                                             w, groups, ns, stats):
    x, wt, sc, sh = _inputs(k + cin + w, 2, cin, h, w, k, cin, cout, groups)
    if stride == 2:
        wt = conv.s2d_kernel(wt)
    kk = wt.shape[0]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    want = conv.conv_valid_pro_plain(x, wt, sc, sh, ns, pad, stride,
                                     (ho, wo))
    got = emulate_fwd_px(x, wt, (ho, wo), pad, stride, sc, sh, ns, stats)
    if stats:
        _check(got[0], want)
        s1, s2 = conv.stack_sums(want, groups)
        _check(got[1][:, 0], s1)
        _check(got[1][:, 1], s2)
    else:
        _check(got, want)
    rng = np.random.default_rng(cout + h)
    g = torch.from_numpy(rng.standard_normal((2, cout, ho, wo), np.float32))
    _check(emulate_dw_px(x, g, kk, pad, stride, sc, sh, ns),
           conv.conv_dw_pro_plain(x, g, kk, sc, sh, ns, pad, stride))


def _calls():
    """The px tilings of the inversion net's sites (forward, input
    gradient, weight gradient; K4 also at the two sites where dw_px_form
    keeps conv_dw_tc) and of the edge filter sizes at a generator's 224
    widths: (op, k, Cv, Cout, B, Ho, Wo)."""
    out = []
    for cin, cout, h, w, k, s in INV_SITES:
        kk = (k + 1) // 2 if s == 2 else k
        cv = s * s * cin
        ho, wo = (h - k) // s + 1, (w - k) // s + 1
        out += [("fwd", kk, cv, cout, 1, ho, wo),
                ("fwd", kk, cout, cv, 1, ho + kk - 1, wo + kk - 1),
                ("dw", kk, cv, cout, 1, ho, wo)]
    for k in (4, 6, 8, 9, 11, 13):
        out += [("fwd", k, 132, 128, 2, 56, 56), ("dw", k, 132, 128, 2, 56, 56),
                ("fwd", k, 16, 3, 2, 224, 224), ("dw", k, 36, 16, 2, 224, 224)]
    return out


@pytest.mark.parametrize("op,k,cv,cout,batch,ho,wo", _calls())
def test_px_tiling_fits_the_kernel(op, k, cv, cout, batch, ho, wo):
    """What the tiling declares fits what the kernel provides: the ring in
    PX_SMEM (two blocks in the 228 KB of an SM), V's tile in the PX_ITEMS
    pixels a thread holds, at most 64 fp32 accumulators a thread (K3: mt
    m16 x 4 n8 tiles; K4: 16 / nb taps x nb n8 tiles), the splits covering
    the contraction; and the grid reaches one block per SM (PX_WAVE) where
    the work has that many blocks to give."""
    assert 2 * (conv.PX_SMEM + 1024) <= 228 * 1024
    if op == "fwd":
        t = conv.fwd_px_tiling(k, cv, cout, batch, ho, wo)
        assert 1 <= t.mt <= 4 and 16 * t.mt * 4 * 4 // 32 <= 64
        stages = 1 if t.cps == 1 else 2
        assert conv.fwd_px_smem(k, t.ndy, t.mt, stages) <= conv.PX_SMEM
        assert (conv.PX_ROWS + t.ndy - 1) * (conv.PX_COLS + k - 1) \
            <= conv.PX_ITEMS * conv.PX_THREADS
        n_cc = -(-cv // 16)
        assert t.n_dyg * t.ndy >= k > (t.n_dyg - 1) * t.ndy
        assert t.n_cs * t.cps >= n_cc > (t.n_cs - 1) * t.cps
        n_co = -(-cout // (16 * t.mt))
        tiles = batch * -(-ho // TR) * -(-wo // TC)
        assert t.blocks == tiles * n_co * t.splits
        # the fewest tap-row groups that fit: one more row a group would
        # not (at the ring it would need), then channel splits toward one
        # block per SM, a cluster's worth at most
        bigger = [d for d in conv._tap_rows(k) if d > t.ndy]
        if bigger:
            d = min(bigger)
            assert not (conv._px_tile_fits(k, d) and conv.fwd_px_smem(
                k, d, t.mt, 1) <= conv.PX_SMEM and t.cps == 1)
        most = tiles * n_co * t.n_dyg * max(1, min(
            n_cc, conv.PX_CLUSTER // t.n_dyg))
        assert t.splits <= max(conv.PX_CLUSTER, t.n_dyg)
        # evened channel groups may stop short of the wave by under half
        assert 2 * t.blocks > min(conv.PX_WAVE, most)
    else:
        t = conv.dw_px_tiling(k, cv, cout, batch, ho, wo)
        assert t.nb in (1, 2, 4) and -(-t.ndy * k // 8) <= 16 // t.nb
        assert conv.dw_px_smem(k, t.ndy, t.nb) <= conv.PX_SMEM
        assert (conv.PX_ROWS + t.ndy - 1) * (conv.PX_COLS + k - 1) \
            <= conv.PX_ITEMS * conv.PX_THREADS
        assert t.rows % TR == 0 and t.cols % TC == 0
        assert t.slices == batch * -(-ho // t.rows) * -(-wo // t.cols)
        stages = batch * -(-ho // TR) * -(-wo // TC)
        # the strips' partials within PX_PARTIAL unless each image is one
        # strip; a block for every two SMs where the work has them
        if t.slices > batch:
            assert t.slices * 4 * k * k * cv * cout <= conv.PX_PARTIAL
        most = stages * -(-cv // 16) * k * -(-cout // 8)
        assert 2 * t.blocks >= min(conv.PX_WAVE, most)


@pytest.mark.parametrize("variant", ["no_mma", "no_loads", "no_stores"])
def test_ablation_variants_edit_the_kernel_source(variant):
    """tools/px_ablation.py builds its variants by editing csrc/conv.cu's
    text: each edit finds its text there exactly once, so the variants
    follow the kernels as they stand, and each removes what it names."""
    from splice_tpu_torch.tools import px_ablation
    src = px_ablation.variant_source(variant)
    full = (px_ablation._build.CSRC_DIR / "conv.cu").read_text()
    assert src != full
    assert ("__ldg(plane" in src) == (variant != "no_loads")
    assert ("mma16816(acc[i][2 * jj]" in src) == (variant != "no_mma")
    assert ("if (Cout > 0) return;" in src) == (variant == "no_stores")

