"""CPU rehearsal of the bf16 forward conv kernel's work split.

csrc/conv.cu conv_fwd_tc (K3 in every form on the tensor cores) runs only
on the card. This file emulates its index arithmetic in torch at fp32: the
strips and output-channel chunks that ops.conv.fwd_tc_tiling gives the
wrapper, each stage's shared-memory tiles laid out as the kernel lays them
out (V's channel planes with the lead and the K-1 halo, zero planes up to a
multiple of 16 channels, the weight tile [co][tap][c] with its padded row
stride), the A fragments as ldmatrix reads them, the B fragments as each
lane builds them from four 16-bit loads at every tap shift, the padded M,
the ragged edges of the stores, and the K3''' per-strip sums with their
fixed-order reduce. Memory a stage never writes holds NaN, so a read of it
shows. The result is held against the plain versions conv_valid_pro_plain
and stack_sums.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from splice_tpu_torch.ops import conv

TR = conv.FWD_TC_ROWS
NAN = float("nan")


def read_src(x, scale, shift, negslope, pad, stride, b, chans, vys, vxs):
    """x[b] through the kernels' Src mapping at V coordinates: channels
    chans (phase-major at stride 2), rows vys, columns vxs -> fp32
    [len(chans), len(vys), len(vxs)]; zero outside x, the prologue on x's
    own pixels only."""
    B, cin, H, W = x.shape
    ch = torch.as_tensor(chans)
    ph = ch // cin if stride == 2 else torch.zeros_like(ch)
    ci, py, px = ch - ph * cin, ph >> 1, ph & 1
    r = stride * vys[None, :] + py[:, None] - pad
    c = stride * vxs[None, :] + px[:, None] - pad
    ok = (((r >= 0) & (r < H))[:, :, None]
          & ((c >= 0) & (c < W))[:, None, :])
    v = x[b, ci[:, None, None], r.clamp(0, H - 1)[:, :, None],
          c.clamp(0, W - 1)[:, None, :]].float()
    if scale is not None:
        row = b // (B // scale.shape[0])
        v = v * scale[row, ci][:, None, None] + shift[row, ci][:, None, None]
        if negslope != 1.0:
            v = torch.where(v >= 0, v, v * negslope)
    return torch.where(ok, v, torch.zeros(()))


def stage_v(dst, plane, rs, operand, b, c0, nch, vy0, vx0, nrows, ncols):
    """The element-wise stage(): nch channels x nrows rows x ncols columns
    of V from (vy0, vx0) into the flat tile dst (plane and row strides).
    The 16-byte path stages all rs columns; this one stages fewer, so a
    read past them shows as NaN."""
    v = read_src(*operand, b, range(c0, c0 + nch),
                 torch.arange(vy0, vy0 + nrows), torch.arange(vx0, vx0 + ncols))
    idx = (torch.arange(nch)[:, None, None] * plane
           + torch.arange(nrows)[None, :, None] * rs
           + torch.arange(ncols)[None, None, :])
    dst[idx] = v


def stage_w(w, ws, mrows, co0, c0, cb):
    """stage_w: weights of V's channels [c0, c0 + cb) and output channels
    [co0, co0 + mrows) into a flat [mrows][ws] tile at t * cb + c; zero
    past Cv and Cout, NaN in each row's padding."""
    k, _, cv, cout = w.shape
    dst = torch.full((mrows * ws,), NAN)
    co = torch.arange(mrows)[:, None, None]
    t = torch.arange(k * k)[None, :, None]
    c = torch.arange(cb)[None, None, :]
    ok = (co0 + co < cout) & (c0 + c < cv)
    val = w.reshape(k * k, cv, cout)[t, (c0 + c).clamp(max=cv - 1),
                                     (co0 + co).clamp(max=cout - 1)]
    dst[(co * ws + t * cb + c).reshape(-1)] = torch.where(
        ok, val, torch.zeros(())).reshape(-1)
    return dst


def emulate_fwd_tc(x, w, out_hw, pad=0, stride=1, scale=None, shift=None,
                   negslope=1.0, want_stats=False):
    """conv_fwd_tc's arithmetic: y [B, Cout, Ho, Wo] (and with want_stats
    the per-stack sums [G, 2, Cout] after the fixed-order reduce)."""
    B = x.shape[0]
    k, _, cv, cout = w.shape
    assert cv == stride * stride * x.shape[1]
    ho, wo = out_hw
    t = conv.fwd_tc_tiling(k, cv, cout, B, ho, wo)
    mt, nb = t.mt, conv.fwd_tc_nb(t.mt)
    tcw, rs, sr = 8 * nb, conv.fwd_tc_tile_cols(t.mt), TR + k - 1
    plane = conv.dw_tc_plane(sr, rs)
    ws, mrows = conv.fwd_tc_w_stride(k, t.wcb), 16 * mt
    assert 1 <= mt <= conv.FWD_TC_MT and mt * nb <= 16 and nb <= 8
    assert t.cb % 16 == 0 and t.rows % TR == 0 and t.cols % tcw == 0
    # the weight tile holds every channel (staged once) or one chunk's
    w_once = t.wcb >= cv
    assert t.wcb % 16 == 0 and (w_once or t.wcb == t.cb)
    assert conv.fwd_tc_smem(k, t.cb, t.wcb, mt) <= conv.FWD_TC_SMEM
    assert (ws // 8) % 2 == 1                 # ldmatrix: distinct banks
    lead = conv.dw_tc_lead(pad, stride)
    assert lead + tcw + k - 1 <= rs
    operand = (x, scale, shift, negslope, pad, stride)
    sy, sx = -(-ho // t.rows), -(-wo // t.cols)
    assert t.tiles == B * sy * sx
    n_co = -(-cout // mrows)
    y = torch.full((B, cout, ho, wo), NAN)
    st_part = torch.full((t.tiles, 2, cout), NAN)
    lane = torch.arange(32)
    gid, q = lane >> 2, lane & 3
    warp = torch.arange(TR)
    a_row, a_col = (lane & 7) + (lane & 8), (lane >> 4) << 3
    b_lane = 2 * q[None, :] * plane + warp[:, None] * rs + lead + gid[None, :]
    # the fragment rows each lane's four 16-bit loads fill (mma's B layout:
    # b0 = rows 2q, 2q+1 of column gid, b1 = rows 2q+8, 2q+9)
    b_krow = torch.stack([2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9], -1)
    for blk in range(B * sy * sx):
        b, syi, sxi = blk // (sy * sx), blk % (sy * sx) // sx, blk % sx
        r0, r1 = syi * t.rows, min(syi * t.rows + t.rows, ho)
        q0, q1 = sxi * t.cols, min(sxi * t.cols + t.cols, wo)
        for coc in range(n_co):
            co0 = coc * mrows
            red = torch.zeros(TR, 2, mrows)       # the warps' K3''' slots
            if w_once:
                w_t = stage_w(w, ws, mrows, co0, 0, t.wcb)
            for y0 in range(r0, r1, TR):
                live = (y0 + warp < r1)[:, None, None, None]
                for x0 in range(q0, q1, tcw):
                    # a tile's first source column on a multiple of 8
                    assert stride == 2 or (x0 - lead - pad) % 8 == 0
                    acc = torch.zeros(TR, mt, nb, 16, 8)
                    for c0 in range(0, cv, t.cb):
                        nch = min(t.cb, cv - c0)
                        nchp = -(-nch // 16) * 16
                        if not w_once:
                            w_t = stage_w(w, ws, mrows, co0, c0, t.wcb)
                        v_t = torch.full((-(-t.cb * plane // 8) * 8,), NAN)
                        stage_v(v_t, plane, rs, operand, b, c0, nch, y0,
                                x0 - lead, sr, lead + tcw + k - 1)
                        v_t[nch * plane:nchp * plane] = 0.0
                        for dy in range(k):           # taps outside,
                            for dx in range(k):       # channel steps in
                                for c16 in range(0, nchp, 16):
                                    off = (b_lane + c16 * plane + dy * rs
                                           + dx)[:, None, :] \
                                        + 8 * torch.arange(nb)[None, :, None]
                                    regs = torch.stack(
                                        [v_t[off], v_t[off + plane],
                                         v_t[off + 8 * plane],
                                         v_t[off + 9 * plane]], -1)
                                    bm = torch.full((TR, nb, 16, 8), NAN)
                                    bm[:, :, b_krow, gid[:, None]] = regs
                                    for i in range(mt):
                                        addr = ((i * 16 + a_row) * ws
                                                + (c0 if w_once else 0)
                                                + (dy * k + dx) * t.wcb
                                                + c16 + a_col)
                                        m8 = w_t[addr[:, None]
                                                 + torch.arange(8)[None, :]]
                                        m8 = m8.reshape(4, 8, 8)
                                        a = torch.cat([
                                            torch.cat([m8[0], m8[2]], 1),
                                            torch.cat([m8[1], m8[3]], 1)], 0)
                                        acc[:, i] = torch.where(
                                            live, acc[:, i] + a @ bm,
                                            acc[:, i])
                    # epilogue: lane (gid, q) holds rows gid, gid + 8 and
                    # columns 2q, 2q + 1 of each m16 x n8 tile
                    for wi in range(TR):
                        oy = y0 + wi
                        if oy >= r1:
                            continue
                        for i in range(mt):
                            for h in range(2):
                                co = co0 + 16 * i + gid + 8 * h       # [32]
                                s1 = torch.zeros(32)
                                s2 = torch.zeros(32)
                                for j in range(nb):
                                    for e in range(2):
                                        ox = x0 + 8 * j + 2 * q + e
                                        v = acc[wi, i, j, gid + 8 * h,
                                                2 * q + e]
                                        ok = (co < cout) & (ox < q1)
                                        y[b, co[ok], oy, ox[ok]] = v[ok]
                                        v = torch.where(ok, v,
                                                        torch.zeros(()))
                                        s1, s2 = s1 + v, s2 + v * v
                                # the lanes q by two xor shuffles, then
                                # lane q = 0 into the warp's slot
                                for sv, which in ((s1, 0), (s2, 1)):
                                    sv = sv + sv[lane ^ 1]
                                    sv = sv + sv[lane ^ 2]
                                    r = 16 * i + gid[q == 0] + 8 * h
                                    red[wi, which, r] += sv[q == 0]
            # the strip's sums: the warps' slots in order
            tot = red[0].clone()
            for wi in range(1, TR):
                tot = tot + red[wi]
            n = min(mrows, cout - co0)
            st_part[blk, :, co0:co0 + n] = tot[:, :n]
    if not want_stats:
        return y
    groups = scale.shape[0]
    per_group = (B // groups) * sy * sx           # a stack's strips
    stats = torch.full((groups, 2, cout), NAN)
    for g in range(groups):
        s = st_part[g * per_group]
        for tile in range(g * per_group + 1, (g + 1) * per_group):
            s = s + st_part[tile]
        stats[g] = s
    return y, stats


def _inputs(seed, B, cin, h, w, k, cv, cout, groups=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, cin, h, w), np.float32))
    wt = torch.from_numpy(
        (0.2 * rng.standard_normal((k, k, cv, cout))).astype(np.float32))
    if not groups:
        return x, wt, None, None
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (groups, cin))
                          .astype(np.float32))
    sc[0, 0] = 1e-13
    sc[groups - 1, cin - 1] = -0.7
    sh = torch.from_numpy(rng.standard_normal((groups, cin), np.float32))
    return x, wt, sc, sh


def _check(got, want):
    tol = 1e-5 * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (err, tol)


# (k, pad, stride, Cin, Cout, H, W, BatchNorm stacks, negslope, stats,
# blocks): k = 1, 2, 3; pad 0 and 1; Cin 3 and 36; Cout 3 (out_conv), 36
# (m16 tiles 3, stages 40 wide) and 68 (5 m16 tiles, padded M), 128 (two
# output-channel chunks); W = 37, 70, 75 and H < k; Cin 68 in three
# channel chunks beside resident weights, Cin 132 with Cout 128 (weights
# staged with each chunk); stride 2 as the phase image at odd
# sizes; two stacks with a scale of 1e-13 and a negative one, with and
# without the K3''' sums; strips of several stages (the last column:
# ops.conv.FWD_TC_BLOCKS, here 3 where the wrapper's grid would give each
# strip a single stage at these sizes)
B_ALL = conv.FWD_TC_BLOCKS
FWD_CASES = (
    (3, 1, 1, 36, 16, 11, 37, 0, 1.0, False, B_ALL),
    (3, 1, 1, 16, 36, 9, 70, 0, 1.0, False, B_ALL),
    (3, 1, 1, 12, 68, 10, 37, 2, 1.0, False, B_ALL),
    (3, 1, 1, 5, 6, 2, 37, 2, 0.2, True, B_ALL),
    (1, 0, 1, 16, 3, 9, 75, 2, 0.2, False, B_ALL),
    (2, 0, 1, 6, 5, 9, 39, 0, 1.0, False, B_ALL),
    (3, 0, 1, 3, 36, 12, 40, 0, 1.0, False, B_ALL),
    (3, 1, 1, 36, 16, 19, 70, 2, 1.0, True, 3),
    (3, 1, 1, 68, 32, 6, 21, 0, 1.0, False, B_ALL),
    (3, 1, 1, 132, 128, 4, 9, 2, 0.2, False, B_ALL),
    (3, 1, 1, 8, 128, 5, 21, 2, 0.2, True, B_ALL),
    (3, 1, 2, 3, 16, 13, 37, 0, 1.0, False, B_ALL),
    (3, 1, 2, 4, 6, 19, 75, 2, 0.2, False, 3),
)


@pytest.mark.parametrize("k,pad,stride,cin,cout,h,w,groups,ns,stats,blocks",
                         FWD_CASES)
def test_fwd_tiles_match_plain(k, pad, stride, cin, cout, h, w, groups, ns,
                               stats, blocks, monkeypatch):
    monkeypatch.setattr(conv, "FWD_TC_BLOCKS", blocks)
    if stride == 2:
        ho, wo = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
    else:
        ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    x, wt, sc, sh = _inputs(k + cin + w, 2, cin, h, w, k, cin, cout, groups)
    if stride == 2:
        wt = conv.s2d_kernel(wt)
    want = conv.conv_valid_pro_plain(x, wt, sc, sh, ns, pad, stride,
                                     (ho, wo))
    got = emulate_fwd_tc(x, wt, (ho, wo), pad, stride, sc, sh, ns, stats)
    if not stats:
        _check(got, want)
        return
    _check(got[0], want)
    s1, s2 = conv.stack_sums(want, groups)
    _check(got[1][:, 0], s1)
    _check(got[1][:, 1], s2)


# The input gradient as ConvValidPro.backward computes it: the cotangent
# through the same kernel with the flipped, io-swapped weights and the
# border k-1-pad (stride 1), or k2-1 on the phase kernel (stride 2, before
# the phase image is folded back): (k, pad, stride, Cin, Cout, H, W)
GRAD_CASES = (
    (3, 1, 1, 36, 16, 9, 37),
    (3, 1, 1, 68, 32, 5, 21),
    (1, 0, 1, 16, 3, 9, 75),
    (3, 1, 2, 4, 6, 13, 37),
)


@pytest.mark.parametrize("k,pad,stride,cin,cout,h,w", GRAD_CASES)
def test_input_gradient_tiles_match_plain(k, pad, stride, cin, cout, h, w):
    x, wt, _, _ = _inputs(k + cin + w + 1, 2, cin, h, w, k, cin, cout)
    if stride == 2:
        wt = conv.s2d_kernel(wt)
    kk = wt.shape[0]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    rng = np.random.default_rng(cin + cout)
    g = torch.from_numpy(rng.standard_normal((2, cout, ho, wo), np.float32))
    w_flip = torch.flip(wt, dims=(0, 1)).transpose(2, 3).contiguous()
    gpad = kk - 1 - (pad if stride == 1 else 0)
    out = conv._out_hw(g, kk, gpad)
    _check(emulate_fwd_tc(g, w_flip, out, gpad),
           conv.conv_valid_plain(g, w_flip, gpad))


# Every bf16 K3 call of the paths (896 canvas, batch 2; the entire-A
# generator at B = 1 on 900 x 1200), forward and input gradient:
# (k, V's channels, Cout, B, Ho, Wo)
PATH_CALLS = (
    (3, 36, 16, 2, 896, 896), (3, 16, 36, 2, 896, 896),
    (3, 68, 32, 2, 448, 448), (3, 32, 68, 2, 448, 448),
    (3, 16, 16, 2, 448, 448), (1, 16, 4, 2, 448, 448),
    (1, 32, 32, 2, 448, 448), (1, 16, 16, 2, 896, 896),
    (1, 16, 3, 2, 896, 896), (1, 3, 16, 2, 896, 896),
    (2, 12, 16, 2, 448, 448), (2, 16, 12, 2, 449, 449),
    (2, 64, 32, 2, 224, 224), (2, 512, 128, 2, 28, 28),
    (2, 128, 512, 2, 29, 29), (3, 132, 128, 2, 56, 56),
    (3, 128, 132, 2, 56, 56), (3, 36, 16, 1, 900, 1200),
    (2, 12, 16, 1, 450, 600), (3, 132, 128, 1, 57, 75),
    (3, 132, 64, 1, 113, 150),
)


@pytest.mark.parametrize("k,cv,cout,batch,ho,wo", PATH_CALLS)
def test_fwd_tiling_fits_the_kernel(k, cv, cout, batch, ho, wo):
    """The tiling's chunks fit the shared memory (two blocks per SM) and
    the warps' accumulators; Cout up to 80 stays in one block; strips are
    whole stages and cover the output; the grid reaches one block per SM
    where the output allows it."""
    t = conv.fwd_tc_tiling(k, cv, cout, batch, ho, wo)
    nb = conv.fwd_tc_nb(t.mt)
    assert 1 <= t.mt <= conv.FWD_TC_MT and t.mt * nb <= 16
    assert t.cb % 16 == 0 and t.cb >= 16
    assert conv.fwd_tc_smem(k, t.cb, t.wcb, t.mt) <= conv.FWD_TC_SMEM
    assert t.wcb % 16 == 0 and (t.wcb >= cv or t.wcb == t.cb)
    assert 2 * (conv.FWD_TC_SMEM + 1024) <= 228 * 1024
    n_co = -(-cout // (16 * t.mt))
    assert n_co == 1 or cout > 16 * conv.FWD_TC_MT
    assert t.rows % TR == 0 and t.cols % (8 * nb) == 0
    strips = batch * -(-ho // t.rows) * -(-wo // t.cols)
    assert t.tiles == strips
    stages = batch * -(-ho // TR) * -(-wo // (8 * nb))
    assert strips * n_co >= min(132, stages * n_co)
