"""CPU rehearsal of the split-TF32 fp32 conv kernels' work split.

csrc/conv.cu namespace tc32 (conv_fwd_tf32: fp32 K3 in every form, its
input gradient included; conv_dw_tf32: fp32 K4, and K7 in its
cotangent-tapped mode, which tests/test_torch_conv_gtap_tf32.py holds) runs
only on the card.
This file emulates its index arithmetic in torch, block by block, as
ops.conv.fwd_tf32_tiling and dw_tf32_tiling split the work: K3's strips,
Cout chunks, stages of TF32_ROWS rows (one a warp) x 16 mt columns and
units of TF32_CK channels and ndy tap rows; K4's strips, channel chunks,
Cout chunks, stages of TF32_DW_ROWS x TF32_DW_COLS pixels, k8 steps split
among 8 // wm row groups. Each unit's shared-memory tiles are laid out as
the kernels lay them out: the raw V tile [c][row][col] from up to
TF32_LEAD columns left of the stage (the border, the phase images of
stride 2 and the prologue as the Src mapping reads them), K3's split V
planes of {hi, lo} pairs (4 mod 16 pairs), its weights in the B
fragments' order, K4's split g planes (TF32_G_PLANE pairs); memory a
kernel never writes holds NaN, so a read of it shows. Every fragment is
gathered at the address the kernel computes for its lanes at each tap
shift, and multiplied as the tensor cores do it: split TF32 (hi = x
rounded as cvt.rna rounds, lo = x - hi truncated, tests/
test_torch_tf32_split.py's tf32 and truncate), three exact TF32 products
summed in fp32. K3''' adds each strip's sums and conv_stats_reduce_kernel
its stack's strips; K4's strips are added in conv_dw_sum_kernel's fixed
order.

Held three ways: against the plain versions (at main_fp32's two auto
sites' channel counts on small maps, their input gradients, and edge
shapes: W = 37, H < k, odd stride-2 sizes, Cin 3 and 136, Cout 3 and 128,
two BatchNorm stacks with a scale of 1e-13, K3''' at ragged sizes, k = 6,
9, 11 and 13), within 1e-5 x the largest entry (fp32 sums in another
order; the split's error is about 1e-6 x max); against float64 at the
sites' contraction lengths, within the card's 1e-4 x max gate, which one
TF32 product alone misses; and at one small shape against
splice_tpu.ops.conv_pallas's kernels in interpret mode. The tiling tests
check what each tiling declares against what the kernels provide: shared
memory, accumulator registers, the launch checks, the grid.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.ops import conv_pallas
from splice_tpu_torch.ops import conv
from test_torch_tf32_split import tf32, truncate

NAN = float("nan")
CK, TR, LEAD = conv.TF32_CK, conv.TF32_ROWS, conv.TF32_LEAD
DR, DC, GP = conv.TF32_DW_ROWS, conv.TF32_DW_COLS, conv.TF32_G_PLANE
WARPS = conv.TF32_WARPS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split(v: torch.Tensor):
    """The kernels' split of fp32 v: (hi, lo as the tensor cores read it)."""
    hi = tf32(v)
    return hi, truncate(v - hi)


def products(ah, al, bh, bl, eq):
    """hi*lo + lo*hi + hi*hi, each an exact TF32 product in fp32."""
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def read_src(operand, b, c0, n, cv, vys, vxs):
    """V[b] through the kernels' Src mapping: channels [c0, c0 + n) (zero
    from cv on; phase-major at stride 2), rows vys, columns vxs (V
    coordinates) -> fp32 [n, len(vys), len(vxs)]: zero outside x, the
    prologue (x * scale + shift, two roundings, then leaky) on x's own
    elements."""
    x, scale, shift, negslope, pad, stride = operand
    B, cin, H, W = x.shape
    ch = torch.arange(c0, c0 + n)
    ph = ch // cin if stride == 2 else torch.zeros_like(ch)
    ci = (ch - ph * cin).clamp(max=cin - 1)
    r = stride * vys[None, :] + (ph >> 1)[:, None] - pad
    c = stride * vxs[None, :] + (ph & 1)[:, None] - pad
    ok = (((r >= 0) & (r < H))[:, :, None] & ((c >= 0) & (c < W))[:, None, :]
          & (ch < cv)[:, None, None])
    v = x[b, ci[:, None, None], r.clamp(0, H - 1)[:, :, None],
          c.clamp(0, W - 1)[:, None, :]].float()
    if scale is not None:
        row = b // (B // scale.shape[0])
        v = v * scale[row, ci][:, None, None]
        v = v + shift[row, ci][:, None, None]
        if negslope != 1.0:
            v = torch.where(v >= 0, v, v * negslope)
    return torch.where(ok, v, torch.zeros(()))


def _lead(pad, stride):
    return (-pad) % 4 if stride == 1 else 0


def _strip_grid(batch, hp, wp, rows, cols):
    """The blocks' strips in blockIdx.x order: (b, r0, r1, q0, q1)."""
    return [(b, r0, min(r0 + rows, hp), q0, min(q0 + cols, wp))
            for b in range(batch) for r0 in range(0, hp, rows)
            for q0 in range(0, wp, cols)]


def _stats_reduce(st_part, groups, cout):
    """conv_stats_reduce_kernel: each of 256 threads a strided run of its
    stack's strips, then a tree over the block."""
    per = st_part.shape[0] // groups
    out = torch.empty(groups, 2, cout)
    for g in range(groups):
        part = st_part[g * per:(g + 1) * per]
        red = torch.zeros(256, 2, cout)
        for i in range(per):
            red[i % 256] = red[i % 256] + part[i]
        h = 128
        while h:
            red = red[:h] + red[h:2 * h]
            h //= 2
        out[g] = red[0]
    return out


def emulate_fwd(x, w, out_hw, pad=0, stride=1, scale=None, shift=None,
                negslope=1.0, stats=False):
    """conv_fwd_tf32's blocks over x (fp32 [B, Cin, H, W]) with w [k, k,
    Cv, Cout]: y, and with stats the K3''' [G, 2, Cout] sums per stack."""
    B = x.shape[0]
    k, _, cv, cout = w.shape
    ho, wo = out_hw
    t = conv.fwd_tf32_tiling(k, cv, cout, B, ho, wo)
    mt, nb = t.mt, t.nb
    nco, tcw = 8 * nb, 16 * mt
    vr, rs = TR + t.ndy - 1, conv.tf32_rs(tcw + k - 1)
    vplane = vr * rs
    splane = conv.tf32_plane(vplane, 16)
    lead = _lead(pad, stride)
    operand = (x, scale, shift, negslope, pad, stride)
    wr = w.float().reshape(k * k, cv, cout)
    n_cc = -(-cv // CK)
    y = torch.full((B, cout, ho, wo), NAN)
    strips = _strip_grid(B, ho, wo, t.rows, t.cols)
    assert len(strips) == t.tiles
    st_part = torch.full((len(strips), 2, cout), NAN)
    c8 = torch.arange(CK)
    for blk, (b, r0, r1, q0, q1) in enumerate(strips):
        for n0 in range(0, cout, nco):
            red = torch.zeros(WARPS, 2, nco)
            for y0 in range(r0, r1, TR):
                for x0 in range(q0, q1, tcw):
                    acc = torch.zeros(WARPS, mt, 16, nb, 8)
                    for c0 in range(0, n_cc * CK, CK):
                        for dy0 in range(0, k, t.ndy):
                            nd = min(t.ndy, k - dy0)
                            ntap = nd * k
                            # the split pass: V's raw tile (written whole)
                            # into {hi, lo} planes, NaN past vplane
                            raw = read_src(operand, b, c0, CK, cv,
                                           torch.arange(y0 + dy0, y0 + dy0
                                                        + vr),
                                           torch.arange(x0 - lead,
                                                        x0 - lead + rs))
                            vs = torch.full((CK, splane, 2), NAN)
                            hi, lo = split(raw.reshape(CK, -1))
                            vs[:, :vplane, 0], vs[:, :vplane, 1] = hi, lo
                            vs = vs.reshape(-1, 2)
                            # the unit's raw weights [tap][c][co], zero past
                            # Cv and Cout, then the B fragments: lane (g, t)
                            # holds {hi b0, hi b1, lo b0, lo b1} of w[c0 +
                            # t][8j + g] and w[c0 + t + 4][8j + g]
                            wraw = torch.zeros(ntap, CK, nco)
                            cc = min(CK, cv - c0)
                            oc = min(nco, cout - n0)
                            wraw[:, :cc, :oc] = wr[dy0 * k:dy0 * k + ntap,
                                                   c0:c0 + cc, n0:n0 + oc]
                            wf = torch.full((t.ndy * k * nb * 32, 4), NAN)
                            ln = torch.arange(32)
                            for tl in range(ntap):
                                for j in range(nb):
                                    b0 = wraw[tl, ln & 3, 8 * j + (ln >> 2)]
                                    b1 = wraw[tl, (ln & 3) + 4,
                                              8 * j + (ln >> 2)]
                                    h0, l0 = split(b0)
                                    h1, l1 = split(b1)
                                    wf[(tl * nb + j) * 32 + ln] = \
                                        torch.stack([h0, h1, l0, l1], 1)
                            # B[tl, j, c, n]: lane n * 4 + c % 4, half c // 4
                            tl = torch.arange(ntap)
                            lane = (torch.arange(8)[None, :] * 4
                                    + (c8 % 4)[:, None])       # [c, n]
                            fi = ((tl[:, None, None, None] * nb
                                   + torch.arange(nb)[None, :, None, None])
                                  * 32 + lane)                 # [tl, j, c, n]
                            half = (c8 // 4)[None, None, :, None]
                            bh = wf[fi, half]
                            bl = wf[fi, 2 + half]
                            # A[w, tl, i, p, c]: V at channel c, pixel 16 i
                            # + p of warp w's row, shifted by the tap
                            dyl, dx = tl // k, tl % k
                            idx = (c8 * splane
                                   + ((torch.arange(WARPS)[:, None, None,
                                                           None, None]
                                       + dyl[None, :, None, None, None])
                                      * rs) + lead
                                   + 16 * torch.arange(mt)[None, None, :,
                                                            None, None]
                                   + torch.arange(16)[None, None, None, :,
                                                      None]
                                   + dx[None, :, None, None, None])
                            ah, al = vs[idx, 0], vs[idx, 1]
                            busy = (y0 + torch.arange(WARPS) < r1).float()
                            part = products(ah, al, bh, bl,
                                            "wtipc,tjcn->wipjn")
                            # rows past the strip: no products
                            acc += torch.where(
                                busy[:, None, None, None, None] > 0, part,
                                torch.zeros(()))
                    # the stage's epilogue: y and the K3''' sums
                    for wi in range(WARPS):
                        oy = y0 + wi
                        if oy >= r1:
                            continue
                        v = acc[wi].permute(2, 3, 0, 1).reshape(nco, tcw)
                        nox, noc = min(tcw, q1 - x0), min(nco, cout - n0)
                        y[b, n0:n0 + noc, oy, x0:x0 + nox] = v[:noc, :nox]
                        red[wi, 0, :noc] += v[:noc, :nox].sum(1)
                        red[wi, 1, :noc] += (v[:noc, :nox] ** 2).sum(1)
            tot = red[0].clone()
            for wi in range(1, WARPS):             # the warps' slots in order
                tot = tot + red[wi]
            noc = min(nco, cout - n0)
            st_part[blk, :, n0:n0 + noc] = tot[:, :noc]
    if not stats:
        return y
    return y, _stats_reduce(st_part, scale.shape[0], cout)


def emulate_dw(x, g, k, pad=0, stride=1, scale=None, shift=None,
               negslope=1.0, gtap=False):
    """conv_dw_tf32's blocks and conv_dw_sum_kernel: K4 fp32 [k, k, Cs,
    Cu], or with gtap (stride 1) K7, the cotangent-tapped mode, after the
    wrapper's tap reversal: fp32 [k, k, Cin, Cout]. The tapped operand S
    (K4: V; K7: g through a border of k - 1, no prologue) is staged raw
    with its halo and split as each A fragment is read; the untapped U
    (K4: g, zero past Cu and the strip; K7: V staged raw, zero past Cin and
    outside x, the prologue applied in the split pass) is split once a
    stage."""
    B, cin, H, W = x.shape
    if gtap:
        cs, cu = g.shape[1], cin
        hp, wp = g.shape[2] + k - 1, g.shape[3] + k - 1
        assert (hp, wp) == (H + 2 * pad, W + 2 * pad) and stride == 1
        tapped = (g, None, None, 1.0, k - 1, 1)
        lead, ulead = _lead(k - 1, 1), _lead(pad, 1)
    else:
        cu, hp, wp = g.shape[1:]
        cs = stride * stride * cin
        tapped = (x, scale, shift, negslope, pad, stride)
        lead = _lead(pad, stride)
    t = conv.dw_tf32_tiling(k, cs, cu, B, hp, wp, gtap)
    nco = 8 * t.nb
    vr, rs = DR + k - 1, conv.tf32_rs(DC + k - 1)
    vplane = conv.dw_tf32_vplane(k)
    nrg = WARPS // t.wm
    strips = _strip_grid(B, hp, wp, t.rows, t.cols)
    assert len(strips) == t.slices
    partial = torch.full((t.slices, k * k * cs * cu), NAN)
    gf = g.float()
    p8 = torch.arange(8)

    def untapped(b, n0, y0, x0, r1, q1):
        """U's [nco, DR, DC] tile as the split pass leaves it."""
        if not gtap:
            graw = torch.zeros(nco, DR, DC)
            nu = min(nco, cu - n0)
            ys, xs = min(DR, r1 - y0), min(DC, q1 - x0)
            graw[:nu, :ys, :xs] = gf[b, n0:n0 + nu, y0:y0 + ys, x0:x0 + xs]
            return graw
        # V's raw tile, written whole by stage_v (zero past Cin and outside
        # x), from ulead columns left of the stage
        ys = torch.arange(y0, y0 + DR)
        xs = torch.arange(x0 - ulead, x0 - ulead + conv.tf32_rs(DC))
        e = read_src((x, None, None, 1.0, pad, 1), b, n0, nco, cu, ys,
                     xs)[:, :, ulead:ulead + DC]
        if scale is None:
            return e
        # the prologue on x's own elements of channels below Cin
        ch = torch.arange(n0, n0 + nco)
        row = b // (B // scale.shape[0])
        z = e * scale[row, ch.clamp(max=cin - 1)][:, None, None]
        z = z + shift[row, ch.clamp(max=cin - 1)][:, None, None]
        if negslope != 1.0:
            z = torch.where(z >= 0, z, z * negslope)
        r, c = ys - pad, torch.arange(x0, x0 + DC) - pad
        inx = ((ch < cu)[:, None, None]
               & ((r >= 0) & (r < H))[None, :, None]
               & ((c >= 0) & (c < W))[None, None, :])
        return torch.where(inx, z, e)

    for sl, (b, r0, r1, q0, q1) in enumerate(strips):
        for ch0 in range(0, cs, t.cb):
            nch = min(t.cb, cs - ch0)
            M = k * k * nch
            tiles = -(-M // 16)
            assert tiles <= t.wm * conv.tf32_upw(t.nb)
            m = torch.arange(M)
            tap, cl = m // nch, m % nch
            off = cl * vplane + (tap // k) * rs + tap % k + lead
            for n0 in range(0, cu, nco):
                acc = torch.zeros(nrg, M, nco)
                for y0 in range(r0, r1, DR):
                    for x0 in range(q0, q1, DC):
                        # S's raw tile: cb planes, NaN past vr * rs and past
                        # the block's nch channels (K4: the prologue in
                        # place)
                        vb = torch.full((t.cb, vplane), NAN)
                        vb[:nch, :vr * rs] = read_src(
                            tapped, b, ch0, nch, cs,
                            torch.arange(y0, y0 + vr),
                            torch.arange(x0 - lead, x0 - lead + rs)
                        ).reshape(nch, -1)
                        vb = vb.reshape(-1)
                        # U's tile split into planes of GP pairs, NaN past
                        # DR * DC
                        us = torch.full((nco, GP, 2), NAN)
                        uh, ul = split(untapped(b, n0, y0, x0, r1, q1)
                                       .reshape(nco, -1))
                        us[:, :DR * DC, 0], us[:, :DR * DC, 1] = uh, ul
                        us = us.reshape(-1, 2)
                        for st in range(DR * DC // 8):
                            ry, cx = st // (DC // 8), 8 * (st % (DC // 8))
                            if y0 + ry >= r1 or x0 + cx >= q1:
                                continue           # U is zero there
                            # A[m, p]: S at row m's (tap, c), pixel cx + p
                            a = vb[off[:, None] + ry * rs + cx + p8]
                            ah, al = split(a)
                            # B[p, n]: U's plane n at pixel (ry, cx + p)
                            ui = (torch.arange(nco)[None, :] * GP + ry * DC
                                  + cx + p8[:, None])
                            acc[st % nrg] += products(
                                ah, al, us[ui, 0], us[ui, 1], "mp,pn->mn")
                tot = acc[0].clone()
                for r in range(1, nrg):             # the row groups in order
                    tot = tot + acc[r]
                nu = min(nco, cu - n0)
                rows = ((tap * cs + ch0 + cl) * cu + n0)[:, None] \
                    + torch.arange(nu)
                partial[sl, rows.reshape(-1)] = tot[:, :nu].reshape(-1)
    # conv_dw_sum_kernel: warp w adds slices w, w + nw, ...; then the warps
    # in order (K7: output i = (tap' * Cout + co) * Cin + ci lands at
    # [ci][tap' * Cout + co])
    nw = min(32, t.slices)
    sums = [_in_order(partial[w::nw]) for w in range(nw)]
    dw = _in_order(torch.stack(sums))
    if gtap:
        return conv._reverse_taps(dw.reshape(k * k * cs, cu).t(), k)
    return dw.reshape(k, k, cs, cu)


def _in_order(rows):
    out = rows[0].clone()
    for r in rows[1:]:
        out = out + r
    return out


def _inputs(seed, B, cin, h, w, k, cout, groups=0, ns=0.2):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, cin, h, w), np.float32))
    wt = torch.from_numpy(
        (0.1 * rng.standard_normal((k, k, cin, cout))).astype(np.float32))
    if not groups:
        return x, wt, (None, None, 1.0)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (groups, cin))
                          .astype(np.float32))
    sc[0, 0] = 1e-13
    sc[groups - 1, cin - 1] = -0.7
    sh = torch.from_numpy(rng.standard_normal((groups, cin), np.float32))
    return x, wt, (sc, sh, ns)


def _check(got, want, rel=1e-5):
    tol = rel * want.abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (err, tol)


# main_fp32's two auto sites' channels (up_conv s0 36 -> 16, up_conv s1
# 68 -> 32, k = 3, border 1) on small maps; the input gradients swap them
SITES = ((36, 16), (68, 32))


@pytest.mark.parametrize("cin,cout", SITES)
@pytest.mark.parametrize("part", ["fwd", "dx"])
def test_fwd_matches_plain_at_the_site_widths(cin, cout, part):
    """K3 (and its input gradient: the cotangent through the flipped,
    io-swapped kernel, as ConvValidPro.backward launches it) at the auto
    sites' channel counts on a [2, 11, 37] map: W % 4 != 0, a ragged last
    stage and a ragged Cout chunk where Cout is 36 or 68."""
    x, w, _ = _inputs(cin + cout, 2, cin, 11, 37, 3, cout)
    if part == "dx":
        x = torch.from_numpy(np.random.default_rng(cout).standard_normal(
            (2, cout, 11, 37), np.float32))
        w = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
    assert conv.conv_route("fwd", torch.float32, 3, 1, w.shape[2],
                           w.shape[3], 2, 11, 37).form == "tf32"
    _check(emulate_fwd(x, w, (11, 37), 1), conv.conv_valid_plain(x, w, 1))


@pytest.mark.parametrize("cin,cout", SITES)
def test_dw_matches_plain_at_the_site_widths(cin, cout):
    x, _, _ = _inputs(cin, 2, cin, 13, 40, 3, cout)
    g = torch.from_numpy(np.random.default_rng(cin + 1).standard_normal(
        (2, cout, 13, 40), np.float32))
    _check(emulate_dw(x, g, 3, 1),
           conv.conv_dw_pro_plain(x, g, 3, None, None, 1.0, 1, 1))


# Edge shapes: (k, pad, stride, Cin, Cout, H, W, BatchNorm stacks,
# negslope, K3''' sums): W = 37 and H < k with two stacks (a scale of
# 1e-13 and a negative one); Cout 3 (out_conv) and 128 with Cin 136; Cin 3
# at odd stride-2 sizes (the stem's phase images), with and without the
# prologue; k = 2 VALID; K3''' at ragged sizes and k = 5; the filter sizes
# no generator default takes: 6 and 9, 11 at stride 2 (k2 = 6), 13 (the
# tap rows in groups)
EDGE_CASES = (
    (3, 1, 1, 20, 40, 9, 37, 2, 0.2, True),
    (3, 1, 1, 20, 16, 2, 37, 2, 0.2, True),
    (1, 0, 1, 16, 3, 13, 37, 2, 0.2, False),
    (3, 1, 1, 136, 128, 6, 9, 2, 0.2, False),
    (3, 1, 2, 3, 16, 13, 37, 0, 1.0, False),
    (3, 1, 2, 16, 32, 19, 35, 2, 0.2, False),
    (2, 0, 1, 20, 24, 11, 39, 0, 1.0, False),
    (5, 2, 1, 12, 20, 14, 21, 2, 1.0, True),
    (6, 2, 1, 4, 6, 15, 17, 0, 1.0, False),
    (9, 4, 1, 4, 6, 15, 17, 2, 0.2, False),
    (11, 5, 2, 4, 6, 15, 17, 2, 0.2, False),
    (13, 6, 1, 3, 10, 11, 19, 0, 1.0, False),
)


@pytest.mark.parametrize("k,pad,stride,cin,cout,h,w,groups,ns,stats",
                         EDGE_CASES)
def test_tf32_forms_match_plain_at_edge_shapes(k, pad, stride, cin, cout,
                                               h, w, groups, ns, stats):
    """K3 (with the prologue and K3''' where asked), its input gradient and
    K4 at one edge shape each."""
    x, wt, a = _inputs(k + cin + w, 2, cin, h, w, k, cout, groups, ns)
    if stride == 2:
        wt = conv.s2d_kernel(wt)
    kk = wt.shape[0]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    want = conv.conv_valid_pro_plain(x, wt, *a, pad, stride, (ho, wo))
    got = emulate_fwd(x, wt, (ho, wo), pad, stride, *a, stats)
    if stats:
        _check(got[0], want)
        s1, s2 = conv.stack_sums(want, groups)
        _check(got[1][:, 0], s1)
        _check(got[1][:, 1], s2)
    else:
        _check(got, want)
    rng = np.random.default_rng(cout + h)
    g = torch.from_numpy(rng.standard_normal((2, cout, ho, wo), np.float32))
    _check(emulate_dw(x, g, kk, pad, stride, *a),
           conv.conv_dw_pro_plain(x, g, kk, *a, pad, stride))
    w_flip = torch.flip(wt, dims=(0, 1)).transpose(2, 3).contiguous()
    out = conv._out_hw(g, kk, kk - 1)
    _check(emulate_fwd(g, w_flip, out, kk - 1),
           conv.conv_valid_plain(g, w_flip, kk - 1))


def mm_k8(a, b, one_term=False):
    """a [M, L] @ b [L, N] as the kernels accumulate it: a k8 step at a
    time into fp32, each step hi*lo + lo*hi + hi*hi of exact TF32 products
    (one_term: one product of the operands rounded to TF32)."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for s in range(0, a.shape[1], 8):
        ak, bk = a[:, s:s + 8], b[s:s + 8]
        if one_term:
            acc = acc + tf32(ak) @ tf32(bk)
        else:
            ah, al = split(ak)
            bh, bl = split(bk)
            acc = acc + (ah @ bl + al @ bh + ah @ bh)
    return acc


@pytest.mark.parametrize("what,L", [("K3 site 0", 9 * 36),
                                    ("K3 site 1", 9 * 68),
                                    ("K4 strip", 4 * 448)])
def test_split_meets_the_fp32_gate_against_float64(what, L):
    """At the contraction lengths of the sites (K3: k*k*Cin taps and
    channels; K4: a strip's pixels, 4 rows of a 448 map), products of
    random operands (weights 0.1 x N(0, 1)) as the kernels form them lie
    within 1e-4 x max of float64, the gate the card holds them to; one
    TF32 product alone lies outside it."""
    rng = np.random.default_rng(L)
    a = torch.from_numpy(rng.standard_normal((512, L), np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal((L, 32))).astype(
        np.float32))
    want = a.double() @ b.double()
    top = want.abs().max().item()
    err = (mm_k8(a, b).double() - want).abs().max().item() / top
    one = (mm_k8(a, b, True).double() - want).abs().max().item() / top
    assert err < 1e-4 < one, (what, err, one)


def test_emulation_matches_the_pallas_kernels_in_interpret_mode():
    """The emulated K3, its input gradient and K4 on [2, 20, 18, 35] -> 8
    channels, k = 3, against conv_pallas.conv_valid_chw and its VJP (the
    reference's _make_conv_kernel and _make_dw_kernel in interpret mode on
    the CPU), fp32: within 1e-5 x the largest entry."""
    k = 3
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 20, 18, 35)).astype(np.float32)
    w = (0.2 * rng.standard_normal((k, k, 20, 8))).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: conv_pallas.conv_valid_chw(a, b, k),
                       jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(out.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tw = torch.from_numpy(w)
    ho, wo = out.shape[2:]
    _check(emulate_fwd(tx, tw, (ho, wo)), torch.from_numpy(np.array(out)))
    w_flip = torch.flip(tw, dims=(0, 1)).transpose(2, 3).contiguous()
    _check(emulate_fwd(tg, w_flip, x.shape[2:], k - 1),
           torch.from_numpy(np.array(jdx)))
    _check(emulate_dw(tx, tg, k), torch.from_numpy(np.array(jdw)))


def _calls():
    """fp32 K3/K4 launches: main_fp32's two sites (forward, input gradient,
    weight gradient), the pallas generator's other widths (k = 1, the k2 =
    2 phase kernels of the stride-2 3x3, 64-132 channels), the entire-A
    B = 1 shapes from 900 x 1200, and the edge filter sizes: (op, k, Cv,
    Cout, B, Ho, Wo)."""
    out = []
    for cin, cout, hw in ((36, 16, 896), (68, 32, 448)):
        out += [("fwd", 3, cin, cout, 2, hw, hw),
                ("fwd", 3, cout, cin, 2, hw + 2, hw + 2),
                ("dw", 3, cin, cout, 2, hw, hw)]
    out += [("fwd", 1, 16, 3, 2, 896, 896), ("dw", 1, 16, 3, 2, 896, 896),
            ("fwd", 2, 12, 16, 2, 448, 448), ("dw", 2, 12, 16, 2, 448, 448),
            ("fwd", 2, 16, 12, 2, 449, 449),
            ("fwd", 3, 132, 128, 2, 56, 56), ("dw", 3, 132, 128, 2, 56, 56),
            ("fwd", 2, 512, 128, 2, 28, 28), ("dw", 2, 512, 128, 2, 28, 28),
            ("fwd", 3, 36, 16, 1, 900, 1200), ("dw", 3, 36, 16, 1, 900, 1200)]
    for k in (5, 6, 7, 9, 11, 13):
        out += [("fwd", k, 20, 24, 2, 37, 45), ("dw", k, 20, 24, 2, 37, 45),
                ("fwd", k, 24, 80, 2, 49, 57)]
    return out


@pytest.mark.parametrize("op,k,cv,cout,batch,ho,wo", _calls())
def test_tf32_tiling_fits_the_kernel(op, k, cv, cout, batch, ho, wo):
    """What the tiling declares fits what the kernel provides: shared
    memory within TF32_SMEM_MAX (the card's 227 KB a block), within
    TF32_SMEM (two blocks an SM) where a smaller tiling would not; at most
    64 fp32 accumulators a thread (128 registers at two blocks of 256);
    the csrc launch checks (strips of whole stages, tap-row groups that
    cover k, M's tiles within the warps'); strips covering the output; and
    a grid of at least half TF32_BLOCKS where the work has the stages."""
    assert 2 * (conv.TF32_SMEM + 1024) <= 228 * 1024
    if op == "fwd":
        t = conv.fwd_tf32_tiling(k, cv, cout, batch, ho, wo)
        assert 1 <= t.nb <= conv.TF32_NB and t.mt == conv.tf32_mt(t.nb)
        assert t.mt * t.nb * 4 <= 64
        assert 8 * t.nb * t.n_co >= cout > 8 * t.nb * (t.n_co - 1)
        assert t.smem == conv.fwd_tf32_smem(k, t.ndy, t.nb)
        assert t.smem <= conv.TF32_SMEM_MAX
        # the fewest tap-row groups within TF32_SMEM, else within the most
        others = [d for d in conv._tap_rows(k)
                  if d > t.ndy or t.smem > conv.TF32_SMEM]
        assert all(conv.fwd_tf32_smem(k, d, t.nb) > conv.TF32_SMEM
                   for d in others)
        assert t.n_dyg * t.ndy >= k > (t.n_dyg - 1) * t.ndy
        assert t.rows % TR == 0 and t.cols % (16 * t.mt) == 0
        assert t.tiles == batch * -(-ho // t.rows) * -(-wo // t.cols)
        stages = batch * -(-ho // TR) * -(-wo // (16 * t.mt))
        blocks = t.tiles * t.n_co
    else:
        t = conv.dw_tf32_tiling(k, cv, cout, batch, ho, wo)
        upw = conv.tf32_upw(t.nb)
        assert 1 <= t.nb <= conv.TF32_NB and upw * t.nb * 4 <= 64
        assert t.wm in (1, 2, 4, 8)
        assert -(-k * k * t.cb // 16) <= t.wm * upw
        assert t.m_chunks == -(-cv // t.cb)
        assert t.smem == conv.dw_tf32_smem(k, t.cb, t.nb, t.wm)
        assert t.smem <= conv.TF32_SMEM_MAX
        assert t.rows % DR == 0 and t.cols % DC == 0
        assert t.slices == batch * -(-ho // t.rows) * -(-wo // t.cols)
        assert t.blocks == t.slices * t.m_chunks * t.n_co
        if t.slices > batch:
            assert t.slices * 4 * k * k * cv * cout <= conv.TF32_PARTIAL
        stages = batch * -(-ho // DR) * -(-wo // DC)
        blocks = t.blocks
    assert 2 * blocks >= min(conv.TF32_BLOCKS, stages)


@pytest.mark.parametrize("variant", ["one_term", "no_copies", "no_pass"])
def test_ablation_variants_edit_the_kernel_source(variant):
    """tools/px_ablation.py --tf32 builds its variants by editing
    csrc/conv.cu's text with csrc/tf32.cuh written in: each edit finds its
    text there exactly once, so the variants follow the kernels as they
    stand, and each removes what it names."""
    from splice_tpu_torch.tools import px_ablation
    src = px_ablation.variant_source(variant, tf32=True)
    full = (px_ablation._build.CSRC_DIR / "conv.cu").read_text()
    assert '#include "tf32.cuh"' not in src and src != full
    assert src.count("tf32::mma3_cols<NB>(s, a, bf);") == 1      # K3
    assert src.count("tf32::mma3_cols_add<NB>(acc[i], a, bf);") == 1  # K4
    assert ("mma(d[j], a.hi, b[j].lo)" in src) == (variant != "one_term")
    assert src.count(">= 0) return;") == 3 * (variant == "no_copies")
    assert src.count("< 0 * ") == 3 * (variant == "no_pass")


def test_float_reciprocal_division_is_exact():
    """csrc tc32::FDiv: n / d as int((n + 0.5f) * (1.f / d)) in fp32 (no
    fused multiply-add can form) is floor(n / d) for every n < 2^16 and at
    n near 2^21, for every divisor the kernels' index arithmetic uses (row
    strides, rows, vectors a row, channels: 1 to 600)."""
    d = np.arange(1, 601, dtype=np.int64)[:, None]
    inv = (np.float32(1) / d.astype(np.float32)).astype(np.float32)
    for n in (np.arange(1 << 16, dtype=np.int64),
              np.arange((1 << 21) - 4096, 1 << 21, dtype=np.int64)):
        q = ((n.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
        assert (q == n // d).all()
