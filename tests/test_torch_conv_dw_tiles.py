"""CPU rehearsal of the bf16 weight-gradient kernels' work split.

csrc/conv.cu conv_dw_tc (K4 and K7 on the tensor cores) runs only on the
card. This file emulates its index arithmetic in torch at fp32: the strips
and channel chunks that ops.conv.dw_tc_tiling gives the wrapper, each
stage's shared-memory tiles laid out as the kernel lays them out (plane and
row strides, the tapped operand's halo, zeros past the strip and past the
extent), the A operand read at each row's tap-shifted offset, the B
operand, the ragged last k16 step, and the strips' partials added in order
(transposed for K7). Memory a stage never writes holds NaN, so a read of it
shows. The result is held against the plain versions conv_dw_pro_plain and
conv_dw_gtap_plain.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from splice_tpu_torch.ops import conv

TR, TC, SC = conv.DW_TC_ROWS, conv.DW_TC_COLS, conv.DW_TC_TILE_COLS
SLACK = 16                                  # csrc dwtc::SLACK


def read_src(x, scale, shift, negslope, pad, stride, b, chans, vys, vxs):
    """x[b] through the kernels' Src mapping at V coordinates: channels
    chans (phase-major at stride 2), rows vys, columns vxs -> fp32
    [len(chans), len(vys), len(vxs)]; zero outside x, the prologue on x's
    own pixels only."""
    B, cin, H, W = x.shape
    ch = torch.as_tensor(chans)
    ph = ch // cin if stride == 2 else torch.zeros_like(ch)
    ci, py, px = ch - ph * cin, ph >> 1, ph & 1
    r = stride * vys[None, :] + py[:, None] - pad               # [C, R]
    c = stride * vxs[None, :] + px[:, None] - pad               # [C, X]
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


def stage(dst, plane, operand, b, c0, nch, vy0, vx0, nrows, ncols, ylim,
          xlim):
    """The kernel's stage(): nch channels x nrows rows x ncols columns of
    the operand from (vy0, vx0) into the flat tile dst (row stride SC),
    zero at rows >= ylim or columns >= xlim."""
    vys = torch.arange(vy0, vy0 + nrows)
    vxs = torch.arange(vx0, vx0 + ncols)
    v = read_src(*operand, b, range(c0, c0 + nch), vys, vxs)
    v = v * ((vys < ylim)[:, None] & (vxs < xlim)[None, :])
    idx = (torch.arange(nch)[:, None, None] * plane
           + torch.arange(nrows)[None, :, None] * SC
           + torch.arange(ncols)[None, None, :])
    dst[idx] = v


def cut(tile, off, e, kk):
    """Operand rows at element offsets off, k16 steps at e, as the kernel
    cuts them: 32-bit words from off // 2 + (e + 2q) // 2 (+ 4 for the
    upper 8), shifted by one element by the permute where off is odd ->
    [len(off), len(e), 16]."""
    word = ((off // 2)[:, None, None]
            + (e[None, :, None] + 2 * (kk // 2 % 4)) // 2 + 4 * (kk // 8))
    return tile[2 * word + (off % 2)[:, None, None] + kk % 2]


def emulate_dw_tc(x, g, k, scale=None, shift=None, negslope=1.0, pad=0,
                  stride=1, gtap=False):
    """conv_dw_tc's arithmetic: K4 (gtap False) -> [k, k, s*s*Cin, Cout],
    K7 (gtap True) -> [k, k, Cin, Cout] after the wrapper's tap reversal."""
    B, cin = x.shape[:2]
    cout, ho, wo = g.shape[1:]
    xs = (x, scale, shift, negslope, pad, stride)
    if gtap:
        cs, cu, hp, wp = cout, cin, ho + k - 1, wo + k - 1
        S, U = (g, None, None, 1.0, k - 1, 1), xs
    else:
        cs, cu, hp, wp = stride * stride * cin, cout, ho, wo
        S, U = xs, (g, None, None, 1.0, 0, 1)
    s_lead, u_lead = conv.dw_tc_lead(*S[4:]), conv.dw_tc_lead(*U[4:])
    t = conv.dw_tc_tiling(k, cs, cu, B, hp, wp)
    assert t.rows % TR == 0 and t.cols % TC == 0 and t.bn % 8 == 0
    upw = conv.dw_tc_units_per_warp(k, t.bn)
    assert upw >= 1 and t.wm in (1, 2, 4, 8)
    assert -(-k * t.cb // 16) <= t.wm * upw
    sr_ = TR + k - 1                        # S rows of a stage
    splane, uplane = conv.dw_tc_plane(sr_, SC), conv.dw_tc_plane(TR, SC)
    assert t.cb * 2 * splane <= conv.DW_TC_S_BYTES
    assert max(s_lead, u_lead) + TC + k - 1 <= SC
    for lead, (_, _, _, _, p, st) in ((s_lead, S), (u_lead, U)):
        # a stage starts on a multiple of 64 columns; its tile's first
        # source column must fall on a multiple of 8 for 16-byte loads
        assert st == 2 or (-lead - p) % 8 == 0
    strips_y, strips_x = -(-hp // t.rows), -(-wp // t.cols)
    assert t.slices == B * strips_y * strips_x
    n_out = k * k * cs * cu
    partial = torch.full((t.slices, n_out), float("nan"))
    kk = torch.arange(16)
    for strip in range(t.slices):
        b = strip // (strips_y * strips_x)
        sy = strip % (strips_y * strips_x) // strips_x
        r0, r1 = sy * t.rows, min(sy * t.rows + t.rows, hp)
        q0 = strip % strips_x * t.cols
        q1 = min(q0 + t.cols, wp)
        for ch0 in range(0, cs, t.cb):
            nch = min(t.cb, cs - ch0)
            # units: 16 rows sr of S, (dy, c) dy-major, each read through
            # one window for all k tap columns dx; rows past k*nch read
            # the window at `par` (row 0) and are discarded
            srows = k * nch
            units = -(-srows // 16)
            sr = torch.arange(units * 16)
            dy, c = sr // nch, sr % nch
            win = torch.where(sr < srows, c * splane + dy * SC + s_lead,
                              s_lead % 2)
            for n0 in range(0, cu, t.bn):
                nu = min(t.bn, cu - n0)
                acc = torch.zeros(k, units * 16, nu)      # [dx][sr][u]
                for y0 in range(r0, r1, TR):
                    for x0 in range(q0, q1, TC):
                        s_t = torch.full((t.cb * splane + SLACK,),
                                         float("nan"))
                        u_t = torch.full((t.bn * uplane,), float("nan"))
                        # the columns the element-wise path stages (the
                        # 16-byte path stages all SC of them)
                        stage(s_t, splane, S, b, ch0, nch, y0, x0 - s_lead,
                              sr_, s_lead + TC + k - 1, 2**31 - 1, 2**31 - 1)
                        stage(u_t, uplane, U, b, n0, nu, y0, x0 - u_lead,
                              TR, u_lead + TC, r1, q1)
                        steps = [(ry, kx) for ry in range(TR)
                                 if y0 + ry < r1 for kx in range(TC // 16)
                                 if x0 + 16 * kx < q1]
                        e = torch.tensor([ry * SC + 16 * kx
                                          for ry, kx in steps])
                        bm = cut(u_t, torch.arange(nu) * uplane + u_lead, e,
                                 kk).reshape(nu, -1)
                        for dx in range(k):
                            # the kernel loads a window of (par + k + 2)
                            # // 2 words per row and cuts dx's pair from
                            # word (par + dx) // 2 and, if odd, the next
                            o = s_lead % 2 + dx
                            assert o // 2 + o % 2 < (s_lead % 2 + k + 2) // 2
                            a = cut(s_t, win + dx, e, kk)[:srows]
                            acc[dx, :srows] += a.reshape(srows, -1) @ bm.T
                # the row groups' sums [unit, dx, 16 rows] (lr), then the
                # kernel's last loop over m = dx * srows + sr
                loc = torch.full((units * k * 16, nu), float("nan"))
                lr_of = ((sr // 16) * k)[None, :] * 16 + (sr % 16)[None, :] \
                    + 16 * torch.arange(k)[:, None]              # [dx, sr]
                loc[lr_of[:, :srows].reshape(-1)] = acc[:, :srows].reshape(
                    -1, nu)
                m = torch.arange(k * srows)
                mdx, msr = m // srows, m % srows
                lr = ((msr >> 4) * k + mdx) * 16 + (msr & 15)
                row = ((msr // nch) * k + mdx) * cs + ch0 + msr % nch
                dst = row[:, None] * cu + n0 + torch.arange(nu)[None, :]
                partial[strip, dst.reshape(-1)] = loc[lr].reshape(-1)
    dw = partial[0].clone()
    for s in range(1, t.slices):          # the fixed-order reduce
        dw += partial[s]
    if gtap:
        return conv._reverse_taps(dw.reshape(k * k * cs, cu).T, k)
    return dw.reshape(k, k, cs, cu)


def _inputs(seed, B, cin, cout, h, w, ho, wo, groups=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, cin, h, w), np.float32))
    g = torch.from_numpy(rng.standard_normal((B, cout, ho, wo), np.float32))
    if not groups:
        return x, g, None, None
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (groups, cin))
                          .astype(np.float32))
    sc[0, 0] = 1e-13
    sh = torch.from_numpy(rng.standard_normal((groups, cin), np.float32))
    return x, g, sc, sh


def _check(got, want):
    tol = 1e-5 * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (err, tol)


# (k, pad, stride, Cin, Cout, H, W, BatchNorm stacks, negslope, blocks):
# SAME and VALID borders, k = 1, 2, 3, odd widths (37, 39) and a width
# past one stage (70), H < k, the prologue with two stacks, stride 2 as
# the phase image at odd sizes, several channel chunks of either operand
# (Cin 48 -> 2 chunks of S; Cout 72 -> 2 of U), and strips of several
# stages (the last column: ops.conv.DW_TC_BLOCKS, here 3 where the
# wrapper's grid would give each strip a single stage at these sizes); the
# inversion net's k = 7 and 5 (VALID, and H < k with the prologue) and
# their stride-2 phase images (k2 = 4 and 3; Cin 36 -> 144 channels of S
# in chunks)
K4_CASES = (
    (3, 1, 1, 5, 6, 11, 37, 0, 1.0, conv.DW_TC_BLOCKS),
    (3, 1, 1, 5, 6, 2, 37, 0, 1.0, conv.DW_TC_BLOCKS),
    (2, 0, 1, 4, 3, 9, 39, 0, 1.0, conv.DW_TC_BLOCKS),
    (1, 0, 1, 6, 4, 10, 70, 0, 1.0, conv.DW_TC_BLOCKS),
    (3, 1, 1, 6, 5, 19, 70, 2, 0.2, 3),
    (3, 1, 1, 48, 24, 5, 21, 0, 1.0, conv.DW_TC_BLOCKS),
    (1, 0, 1, 5, 72, 4, 19, 2, 1.0, conv.DW_TC_BLOCKS),
    (3, 1, 2, 3, 5, 13, 37, 0, 1.0, conv.DW_TC_BLOCKS),
    (3, 1, 2, 4, 6, 19, 75, 2, 0.2, 3),
    (7, 0, 1, 5, 6, 12, 37, 0, 1.0, conv.DW_TC_BLOCKS),
    (5, 2, 1, 6, 5, 4, 39, 2, 0.2, 3),
    (7, 3, 2, 4, 6, 15, 39, 0, 1.0, conv.DW_TC_BLOCKS),
    (5, 2, 2, 36, 16, 11, 29, 0, 1.0, conv.DW_TC_BLOCKS),
)


@pytest.mark.parametrize("k,pad,stride,cin,cout,h,w,groups,ns,blocks",
                         K4_CASES)
def test_k4_tiles_match_plain(k, pad, stride, cin, cout, h, w, groups, ns,
                              blocks, monkeypatch):
    monkeypatch.setattr(conv, "DW_TC_BLOCKS", blocks)
    if stride == 2:
        ho, wo = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
        k = (k + 1) // 2                   # the phase image's k2
    else:
        ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    x, g, sc, sh = _inputs(k + cin + w, 2, cin, cout, h, w, ho, wo, groups)
    got = emulate_dw_tc(x, g, k, sc, sh, ns, pad, stride)
    _check(got, conv.conv_dw_pro_plain(x, g, k, sc, sh, ns, pad, stride))


# (k, pad, Cin, Cout, H, W, stacks, negslope, blocks): SAME (pad (k-1)/2)
# and VALID (pad 0 on the bordered input), the prologue, an odd width past
# one stage, H < k, two chunks of Cout (S) and of Cin (U)
K7_CASES = (
    (3, 1, 5, 6, 11, 37, 0, 1.0, conv.DW_TC_BLOCKS),
    (3, 1, 6, 5, 2, 37, 2, 0.2, conv.DW_TC_BLOCKS),
    (3, 0, 4, 3, 9, 39, 0, 1.0, conv.DW_TC_BLOCKS),
    (2, 0, 4, 6, 9, 39, 2, 1.0, conv.DW_TC_BLOCKS),
    (3, 1, 5, 4, 17, 70, 2, 0.2, 3),
    (3, 1, 72, 40, 4, 13, 0, 1.0, conv.DW_TC_BLOCKS),
    # k = 5 and 7 (SAME pad 2 and 3): H < k, the prologue, two stacks
    (5, 2, 5, 6, 11, 37, 0, 1.0, conv.DW_TC_BLOCKS),
    (5, 2, 6, 5, 3, 21, 2, 0.2, 3),
    (7, 3, 6, 5, 9, 39, 2, 0.2, conv.DW_TC_BLOCKS),
    (7, 3, 36, 16, 5, 70, 0, 1.0, conv.DW_TC_BLOCKS),
)


@pytest.mark.parametrize("k,pad,cin,cout,h,w,groups,ns,blocks", K7_CASES)
def test_k7_tiles_match_plain(k, pad, cin, cout, h, w, groups, ns, blocks,
                              monkeypatch):
    monkeypatch.setattr(conv, "DW_TC_BLOCKS", blocks)
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    x, g, sc, sh = _inputs(k + cin + w + 1, 2, cin, cout, h, w, ho, wo,
                           groups)
    got = emulate_dw_tc(x, g, k, sc, sh, ns, pad, gtap=True)
    _check(got, conv.conv_dw_gtap_plain(x, g, k, sc, sh, ns, pad))


# Every bf16 dw call of the paths (896 canvas, batch 2; the entire-A
# generator at B = 1 on 900 x 1200): K4 at the auto sites, K4' pro at the
# fused sites, the stride-2 phase images, the SAME route's K7
PATH_CALLS = (
    (3, 36, 16, 896, 896), (3, 68, 32, 448, 448), (3, 16, 16, 448, 448),
    (1, 16, 4, 448, 448), (1, 32, 32, 448, 448), (1, 16, 16, 896, 896),
    (1, 16, 3, 896, 896), (2, 12, 16, 448, 448), (2, 64, 32, 224, 224),
    (2, 512, 128, 28, 28), (3, 132, 128, 56, 56), (3, 16, 36, 898, 898),
    (3, 32, 68, 450, 450), (3, 36, 16, 900, 1200), (2, 12, 16, 450, 600),
    (3, 136, 128, 57, 75),
    # the inversion net on limes at 224 x 281: k = 7 and 5, and the phase
    # images' k2 = 4 and 3
    (7, 36, 16, 224, 281), (7, 16, 16, 112, 141), (7, 68, 32, 112, 141),
    (7, 32, 32, 56, 71), (5, 132, 64, 56, 71), (5, 64, 64, 28, 36),
    (5, 132, 128, 28, 36), (5, 128, 128, 14, 18), (4, 128, 16, 112, 141),
    (4, 64, 32, 56, 71), (3, 128, 64, 28, 36), (3, 256, 128, 14, 18),
    # K7 on the SAME route with filter_size_up 5 or 7, where _gtap_better
    # takes it: up_conv s0 (36 -> 16 at 896) and s1 (68 -> 32 at 448)
    (5, 16, 36, 900, 900), (5, 32, 68, 452, 452), (7, 16, 36, 902, 902),
    (7, 32, 68, 454, 454),
)


@pytest.mark.parametrize("k,cs,cu,hp,wp", PATH_CALLS)
def test_tiling_fits_the_kernel(k, cs, cu, hp, wp):
    """The tiling's channel chunks fit the warps' accumulators and the
    shared memory; strips are whole stages and cover the extent; the grid
    reaches at least one block per SM where the extent allows it."""
    t = conv.dw_tc_tiling(k, cs, cu, 2, hp, wp)
    upw = conv.dw_tc_units_per_warp(k, t.bn)
    assert upw >= 1 and t.wm in (1, 2, 4, 8)
    assert -(-k * t.cb // 16) <= t.wm * upw
    assert t.bn % 8 == 0 and t.bn <= 64 and t.bn >= min(cu, 8)
    s_bytes = t.cb * 2 * conv.dw_tc_plane(TR + k - 1, SC)
    u_bytes = t.bn * 2 * conv.dw_tc_plane(TR, SC)
    assert s_bytes <= conv.DW_TC_S_BYTES and s_bytes + u_bytes <= 227 * 1024
    assert t.rows % TR == 0 and t.cols % TC == 0
    strips = 2 * -(-hp // t.rows) * -(-wp // t.cols)
    assert t.slices == strips
    blocks = strips * -(-cs // t.cb) * -(-cu // t.bn)
    stages = 2 * -(-hp // TR) * -(-wp // TC) * -(-cs // t.cb) * -(-cu // t.bn)
    assert blocks >= min(132, stages)
