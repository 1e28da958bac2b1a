"""Small-channel convolution in [B, C, H, W] layout.

Port of splice_tpu/ops/conv_pallas.py:706-732 (conv_valid_chw and its
custom VJP), :851-899 (conv_pro_valid_chw: the deferred-BatchNorm
prologue), :902-1004 (pallas_conv_bn_act_chw, VALID branch) and
:1007-1065 (pallas_conv_chw). On CUDA tensors the convolution and its input
gradient are kernel K3 and the weight gradient is kernel K4 (csrc/conv.cu,
replacing _make_conv_kernel and _make_dw_kernel), in three forms each:

  * plain: a VALID conv with an implicit zero border (conv_valid_cuda,
    conv_dw_cuda);
  * pro: the input read applies z = leaky_ns(x*scale + shift), one row of
    scale/shift per BatchNorm stack, with an implicit zero border of z
    (conv_valid_pro_cuda, conv_dw_pro_cuda);
  * s2d: a stride-2 conv as the stride-1 ceil(k/2) conv of the
    space-to-depth phase image, which the kernels read straight from x
    (conv_valid_s2d_cuda, conv_dw_s2d_cuda).
A stride-2 conv with a prologue is the pro form at stride 2. One autograd
Function, ConvValidPro, carries all of them.

With the reference's SAME_BORDER_KERNELS on (below), stride-1 zero-border
convs of odd k > 1 take the SAME route instead (ConvValidPro with `same`:
conv_same_chw :735-766, conv_same_pro_chw :769-813, conv_same_pro_stats_chw
:816-848):
  * K3'' SAME: K3 with the border (k-1)//2, plain or pro (conv_same_cuda,
    conv_same_pro_cuda). The reference pre-pads rows (under a prologue with
    its pre-image v = -shift/scale, :931-937) and masks columns inside its
    kernel; here the border is K3's implicit zero of z in both directions,
    exact where the reference's v rows are exact up to rounding;
  * K3''' stats: the pro form that also returns each BatchNorm stack's fp32
    sum and sum of squares of the cast output (conv_same_pro_stats_cuda);
  * the weight gradient as the reference routes it (_dw_impl :647): K7, the
    cotangent-tapped form (conv_dw_gtap_cuda, replacing
    _make_dw_kernel_gtap :455), where DW_TAP_ON_N and _gtap_better say so,
    else K4 with the border.

Every kernel routes by dtype. bf16 runs on the tensor cores (mma.sync):
K3 in every form, the input gradient included, through one implicit-GEMM
kernel (csrc/conv.cu conv_fwd_tc, tiled by fwd_tc_tiling below), K4 and
K7 through another (conv_dw_tc, tiled by dw_tc_tiling); each wrapper
counts its bf16 launches in tc_launches. fp32 runs on the CUDA cores
(conv_valid_fwd, conv_dw, conv_dw_gtap) in full fp32, which the 1e-4 gates
of the fp32 steps need.

On CPU tensors the same functions run their plain PyTorch versions below,
which materialise what the kernels' input read sees (virtual_input_plain)
and repeat their arithmetic (fp32 accumulation; a float64 input stays
float64, so the CPU checks can run a whole generator in float64). A CUDA
tensor launches the kernel or raises; there is no fallback.

The zero border under a prologue holds zeros of z. The reference gets them
by padding x with the prologue's pre-image v = -shift/scale (conv_pallas.py
:959-975), which is exact up to rounding; the kernels here zero the border
after the prologue instead, which is what that padding means, and needs no
guard for a scale near 0.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from splice_tpu_torch.ops import _build
from splice_tpu_torch.ops.image import reflect_pad

# fp32 K4/K7 split the rows of all images into about this many chunks
# (pass 1), then add the chunks' partial sums in order (pass 2).
_DW_CHUNKS = 256
_DW_ROW_TILE = 4          # rows per shared-memory tile in K4 (csrc DR)

# bf16 K4/K7 on the tensor cores (csrc/conv.cu, namespace dwtc): a block
# walks a strip of pixels in stages of DW_TC_ROWS x DW_TC_COLS, its warps
# holding at most DW_TC_ACC m16n8 accumulator tiles each; the grid aims at
# DW_TC_BLOCKS blocks (about two waves at two blocks on each of 132 SMs).
DW_TC_ROWS = 8            # csrc TR
DW_TC_COLS = 64           # csrc TC
DW_TC_WARPS = 8           # csrc WARPS
DW_TC_ACC = 16            # csrc ACC
DW_TC_TILE_COLS = DW_TC_COLS + 16   # row stride of both tiles (csrc SC)
DW_TC_S_BYTES = 96 * 1024  # shared memory for the tapped operand's tile
DW_TC_BLOCKS = 528

# The k of every kernel but K7 (csrc/conv.cu's cases): the training net's
# 3x3 and 1x1 and its stride-2 k2 = 2, the inversion net's 7x7 and 5x5
# (splice_tpu/models/unet.py:67-75) and their k2 = 4 and 3.
KERNEL_KS = (1, 2, 3, 4, 5, 7)
# K7's k: the odd k > 1 that the SAME route reaches with the generators'
# filters (3, 5, 7) and k = 2 for VALID K7 on a bordered input
GTAP_KS = (2, 3, 5, 7)

# bf16 K3 on the tensor cores (csrc/conv.cu, namespace fwdtc): a block
# holds up to FWD_TC_MT m16 tiles of Cout (wider outputs split into evened
# chunks; fewer tiles where a k = 7 weight tile would not fit) and walks a
# strip of output pixels in stages of FWD_TC_ROWS rows
# (one per warp) x 8 * fwd_tc_nb(mt) columns, staging V's channels in
# chunks that fit FWD_TC_SMEM with the weights (two blocks per SM); the
# grid aims at FWD_TC_BLOCKS blocks, as the dw kernel's.
FWD_TC_ROWS = 8           # csrc fwdtc::TR
FWD_TC_MT = 5             # csrc fwdtc::launch_k's cases
FWD_TC_SMEM = 110 * 1024
FWD_TC_BLOCKS = 528

# The reference's module constants (conv_pallas.py:41, :627), read at call
# time through this module. SAME_BORDER_KERNELS routes stride-1 zero-border
# convs of odd k > 1 through the SAME-border forms; DW_TAP_ON_N lets their
# weight gradient take K7 where _gtap_better says so (chip_smoke's phase 7
# also times the fused SAME route with it off: K4 at those sites).
SAME_BORDER_KERNELS = False
DW_TAP_ON_N = True


def _gtap_better(k: int, cin: int, cout: int) -> bool:
    """Pick the dw form with fewer MXU output-tile passes (ties keep the
    x-tapped form — it skips the z lane mask and has the larger install
    base)."""
    xtap = -(-(k * k * cin) // 128) * -(-cout // 128)
    gtap = -(-cin // 128) * -(-(k * k * cout) // 128)
    return gtap < xtap


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in the plain versions' accumulation type: fp32, or float64 for a
    float64 t."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the card's comparison)
# ---------------------------------------------------------------------------

def conv_valid_plain(x: torch.Tensor, w: torch.Tensor,
                     pad: int = 0) -> torch.Tensor:
    """VALID k x k stride-1 conv with an optional implicit zero border:
    x [B, Cin, H, W], w [k, k, Cin, Cout] -> [B, Cout, H+2pad-k+1, ...].
    One fp32 channel contraction per tap, summed in fp32, output in x's
    type (the kernel's arithmetic)."""
    k = w.shape[0]
    if pad:
        x = F.pad(x, (pad, pad, pad, pad))
    ho, wo = x.shape[2] - k + 1, x.shape[3] - k + 1
    xf, wf = wide(x), wide(w)
    out = None
    for dy in range(k):
        for dx in range(k):
            t = torch.einsum("io,bihw->bohw", wf[dy, dx],
                             xf[:, :, dy:dy + ho, dx:dx + wo])
            out = t if out is None else out + t
    return out.to(x.dtype)


def conv_dw_plain(xp: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """dw[dy, dx, ci, co] = sum_{b,y,x} xp[b,ci,y+dy,x+dx] g[b,co,y,x] in
    fp32 -> [k, k, Cin, Cout] fp32."""
    ho, wo = g.shape[2], g.shape[3]
    xf, gf = wide(xp), wide(g)
    return torch.stack([
        torch.stack([torch.einsum("bihw,bohw->io",
                                  xf[:, :, dy:dy + ho, dx:dx + wo], gf)
                     for dx in range(k)])
        for dy in range(k)])


def split_stacks(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, ...] -> [groups, B // groups, ...]: the batch's BatchNorm
    stacks."""
    return t.reshape(groups, t.shape[0] // groups, *t.shape[1:])


def _rows(v: torch.Tensor) -> torch.Tensor:
    """[G, C] scale/shift rows -> [G, 1, C, 1, 1] against split_stacks."""
    return v[:, None, :, None, None]


def prologue_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   negslope: float) -> torch.Tensor:
    """z = leaky_ns(x*scale + shift) in fp32, rounded to x's type; batch
    stack i (of scale.shape[0]) uses row i of scale/shift."""
    xs = wide(split_stacks(x, scale.shape[0]))
    z = xs * _rows(scale) + _rows(shift)
    if negslope != 1.0:
        z = torch.where(z >= 0, z, z * negslope)
    return z.reshape(x.shape).to(x.dtype)


def virtual_input_plain(x: torch.Tensor, k: int, out_hw: Tuple[int, int],
                        pad: int = 0, stride: int = 1,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        negslope: float = 1.0) -> torch.Tensor:
    """The input the kernels' read sees, materialised: the prologue (if
    scale is given), a zero border of `pad` around it, and for stride 2 the
    space-to-depth phase image (channel (py*2 + px)*Cin + ci at (i, j) is
    the bordered z at (2i + py, 2j + px)); sized for a VALID k x k conv
    with out_hw outputs."""
    if scale is not None:
        x = prologue_plain(x, scale, shift, negslope)
    hv, wv = out_hw[0] + k - 1, out_hw[1] + k - 1
    H, W = x.shape[2], x.shape[3]
    # negative pads crop what the conv never reads
    x = F.pad(x, (pad, stride * wv - W - pad, pad, stride * hv - H - pad))
    if stride == 2:
        B, C = x.shape[:2]
        x = x.reshape(B, C, hv, 2, wv, 2).permute(0, 3, 5, 1, 2, 4) \
            .reshape(B, 4 * C, hv, wv)
    return x


def conv_valid_pro_plain(x, w, scale, shift, negslope: float = 1.0,
                         pad: int = 0, stride: int = 1,
                         out_hw: Optional[Tuple[int, int]] = None):
    """K3's pro and s2d forms, plain: the VALID conv of the virtual
    input."""
    k = w.shape[0]
    out_hw = out_hw or _out_hw(x, k, pad)
    return conv_valid_plain(virtual_input_plain(
        x, k, out_hw, pad, stride, scale, shift, negslope), w)


def conv_dw_pro_plain(x, g, k: int, scale, shift, negslope: float = 1.0,
                      pad: int = 0, stride: int = 1):
    """K4's pro and s2d forms, plain: dw over the virtual input."""
    return conv_dw_plain(virtual_input_plain(
        x, k, tuple(g.shape[2:]), pad, stride, scale, shift, negslope), g, k)


def conv_same_plain(x, w, scale=None, shift=None, negslope: float = 1.0):
    """K3'' plain: the SAME conv of an odd k (zero border (k-1)//2 of z),
    with the prologue when scale is given."""
    return conv_valid_pro_plain(x, w, scale, shift, negslope,
                                (w.shape[0] - 1) // 2)


def stack_sums(y: torch.Tensor, groups: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-stack, per-channel fp32 (sum, sum of squares) [groups, C]."""
    ys = wide(split_stacks(y, groups))
    return ys.sum(dim=(1, 3, 4)), torch.square(ys).sum(dim=(1, 3, 4))


def conv_same_pro_stats_plain(x, w, scale, shift, negslope: float = 1.0):
    """K3''' plain: the SAME pro conv, then the fp32 sums of its cast output
    per stack: (out, s1 [G, Cout], s2 [G, Cout])."""
    out = conv_same_plain(x, w, scale, shift, negslope)
    return (out, *stack_sums(out, scale.shape[0]))


def _reverse_taps(dwt: torch.Tensor, k: int) -> torch.Tensor:
    """[Cin, k*k*Cout] tapped at (dy', dx') -> [k, k, Cin, Cout] with
    dy = k-1-dy', dx = k-1-dx' (conv_pallas.py:611-612)."""
    return dwt.reshape(dwt.shape[0], k, k, -1).permute(1, 2, 0, 3) \
        .flip((0, 1))


def conv_dw_gtap_plain(x, g, k: int, scale=None, shift=None,
                       negslope: float = 1.0, pad: int = 0):
    """K7 plain: the virtual input z [B, Cin, Ho+k-1, Wo+k-1] contracted
    with each tap (dy', dx') of the cotangent, g[.., r-(k-1)+dy',
    c-(k-1)+dx'] (zero outside g), into [Cin, k*k*Cout], then the tap
    reversal -> fp32 [k, k, Cin, Cout]. pad (k-1)//2 is the reference's
    SAME mode, pad 0 on a padded x its VALID mode."""
    z = wide(virtual_input_plain(x, k, tuple(g.shape[2:]), pad, 1, scale,
                                 shift, negslope))
    hv, wv = z.shape[2], z.shape[3]
    gp = F.pad(wide(g), (k - 1, k - 1, k - 1, k - 1))
    taps = [torch.einsum("bihw,bohw->io", z,
                         gp[:, :, dy:dy + hv, dx:dx + wv])
            for dy in range(k) for dx in range(k)]
    return _reverse_taps(torch.stack(taps, 1).reshape(z.shape[1], -1), k)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _out_hw(x: torch.Tensor, k: int, pad: int) -> Tuple[int, int]:
    """Output size of a stride-1 VALID k x k conv with a `pad` border."""
    return x.shape[2] + 2 * pad - k + 1, x.shape[3] + 2 * pad - k + 1


def _prologue_args(x, scale, shift):
    """Pointers and group count of the optional prologue; raises unless
    scale/shift are contiguous fp32 [G, Cin] on x's device, G | B."""
    if scale is None:
        return None, None, 1
    G, cin = scale.shape
    if shift.shape != scale.shape or cin != x.shape[1] or x.shape[0] % G:
        raise ValueError(f"conv prologue: scale {tuple(scale.shape)}, shift "
                         f"{tuple(shift.shape)} vs input {tuple(x.shape)}")
    for t in (scale, shift):
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError("conv prologue: scale/shift must be contiguous "
                             "fp32 on the input's device")
    return scale.data_ptr(), shift.data_ptr(), G


def _launch_fwd(x, w, out_hw, pad, stride, scale, shift, negslope, name,
                want_stats: bool = False):
    """K3 over the virtual input of x (see csrc/conv.cu): bf16 on the
    tensor cores (conv_fwd_tc), fp32 on the CUDA cores (conv_valid_fwd). w
    must already be in x's type. want_stats (K3''', needs the prologue):
    also the fp32 [G, 2, Cout] per-stack sums of y and y^2."""
    x, w = x.contiguous(), w.contiguous()
    dtype = _build.check_cuda_tensors(name, x, w)
    B, cin, h, wd = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != stride * stride * cin or stride not in (1, 2):
        raise ValueError(f"{name}: kernel {tuple(w.shape)} vs input "
                         f"{tuple(x.shape)}, stride {stride}")
    tc = dtype == _build.DTYPES["bfloat16"]
    if tc and k not in KERNEL_KS:
        raise ValueError(f"{name}: the bf16 kernel is built for k in "
                         f"{KERNEL_KS}, got {k}")
    ho, wo = out_hw
    sp, tp, G = _prologue_args(x, scale, shift)
    y = torch.empty(B, cout, ho, wo, dtype=x.dtype, device=x.device)
    t = fwd_tc_tiling(k, wcin, cout, B, ho, wo) if tc else None
    st_part = stats = None
    lib = _build.library("conv")
    if want_stats:
        if scale is None:
            raise ValueError(f"{name}: the statistics need the prologue")
        lib.conv_stats_scratch_tiles.argtypes = [ctypes.c_int] * 6
        tiles = lib.conv_stats_scratch_tiles(
            B, ho, wo, dtype, *((t.rows, t.cols) if tc else (0, 0)))
        st_part = torch.empty(tiles, 2, cout, dtype=torch.float32,
                              device=x.device)
        stats = torch.empty(G, 2, cout, dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), sp, tp, B, cin, h, wd,
            cout, ho, wo, k, pad, stride, G, float(negslope),
            st_part.data_ptr() if want_stats else None,
            stats.data_ptr() if want_stats else None)
    argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 \
        + [ctypes.c_float] + [ctypes.c_void_p] * 2
    if tc:
        fn = lib.conv_fwd_tc
        fn.argtypes = argtypes + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        args += (t.rows, t.cols, t.cb, t.wcb, t.mt)
    else:
        fn = lib.conv_valid_fwd
        fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(*args, _build.stream_ptr(x.device)), name)
    return (y, stats) if want_stats else y


class FwdTiling(NamedTuple):
    """The bf16 K3 kernel's work split (csrc conv_fwd_tc): strips of rows x
    cols output pixels per block, cb channels of V per shared-memory chunk
    (a multiple of 16), wcb channels per tap in the weight tile (all of V's,
    rounded up to 16 and staged once per block, or cb, staged with each
    chunk), mt m16 tiles (16 * mt output channels) per block; tiles = the
    strips, the K3''' scratch rows."""
    rows: int
    cols: int
    cb: int
    wcb: int
    mt: int
    tiles: int


def fwd_tc_nb(mt: int) -> int:
    """n8 tiles (8 output columns each) a warp holds beside mt m16 tiles:
    at most 16 accumulator tiles, at most 8 (csrc nb_of)."""
    return min(8, 16 // mt)


def fwd_tc_tile_cols(mt: int) -> int:
    """Row stride of V's tile: a stage's 8 * nb columns, the lead (<= 7)
    and the halo (<= 2) in whole 16-byte vectors (csrc tile_cols)."""
    return 8 * fwd_tc_nb(mt) + 16


def fwd_tc_w_stride(k: int, wcb: int) -> int:
    """Row stride of the weight tile [co][tap][c]: an odd count of 16-byte
    units, for conflict-free ldmatrix (csrc w_stride)."""
    return k * k * wcb + 8


def fwd_tc_smem(k: int, cb: int, wcb: int, mt: int) -> int:
    """Bytes of a block's shared memory: two buffers of V's chunk, the
    weight tile and the K3''' slots of its 8 warps (csrc smem_bytes)."""
    v = cb * dw_tc_plane(FWD_TC_ROWS + k - 1, fwd_tc_tile_cols(mt))
    return 2 * (2 * -(-v // 8) * 8 + 16 * mt * fwd_tc_w_stride(k, wcb)) \
        + 4 * 8 * 2 * 16 * mt


def fwd_tc_tiling(k: int, cv: int, cout: int, batch: int, ho: int,
                  wo: int) -> FwdTiling:
    """How conv_fwd_tc splits y[co, p] = sum_(t, c) w[t, c, co] V[c, p + t]
    over [batch, ho, wo] outputs, cv channels of V: Cout in as few evened
    chunks of at most FWD_TC_MT m16 tiles as it takes, of fewer tiles where
    a 16-channel chunk beside its weights would not fit FWD_TC_SMEM (at k =
    7 the weight tile of 49 taps allows one m16 tile); V's channels in as
    few evened chunks of a multiple of 16 as FWD_TC_SMEM allows, with every
    channel's weights resident where they fit beside a chunk, else staged
    with each chunk; strips of whole stages, full-width where the grid
    still reaches about FWD_TC_BLOCKS blocks, else split along the
    columns."""
    c_all = 16 * -(-cv // 16)
    chunks = range(c_all, 0, -16)
    for cap in range(FWD_TC_MT, 0, -1):
        n_co = -(-cout // (16 * cap))
        mt = -(-(-(-cout // n_co)) // 16)
        n_co = -(-cout // (16 * mt))
        # the widest chunk beside every channel's weights, else beside its
        # own
        cb = next((c for c in chunks
                   if fwd_tc_smem(k, c, c_all, mt) <= FWD_TC_SMEM), 0)
        resident = cb > 0
        if not resident:
            cb = next((c for c in chunks
                       if fwd_tc_smem(k, c, c, mt) <= FWD_TC_SMEM), 0)
        if cb:
            break
    else:
        raise ValueError(f"fwd_tc_tiling: no tiling of k = {k} fits "
                         f"{FWD_TC_SMEM} bytes")
    n_cc = -(-cv // cb)
    cb = 16 * -(-(-(-cv // n_cc)) // 16)
    wcb = c_all if resident else cb
    tcw = 8 * fwd_tc_nb(mt)
    sy, sx = -(-ho // FWD_TC_ROWS), -(-wo // tcw)
    per_chunk = max(1, FWD_TC_BLOCKS // n_co)
    spb = max(1, -(-batch * sy * sx // per_chunk))      # stages per block
    if spb >= sx:
        rows, cols = FWD_TC_ROWS * (spb // sx), tcw * sx
    else:
        rows = FWD_TC_ROWS
        cols = tcw * -(-sx // -(-sx // spb))
    tiles = batch * -(-ho // rows) * -(-wo // cols)
    return FwdTiling(rows, cols, cb, wcb, mt, tiles)


class DwTiling(NamedTuple):
    """The bf16 dw kernel's work split (csrc conv_dw_tc): strips of rows x
    cols pixels, cb channels of the tapped operand (all k*k taps) and bn of
    the other per block, wm warps along M and 8 // wm along a stage's pixel
    rows; slices = strips, the partial sums the fixed-order reduce adds."""
    rows: int
    cols: int
    cb: int
    bn: int
    wm: int
    slices: int


def dw_tc_plane(rows: int, cols: int) -> int:
    """Elements of one channel's rows x cols plane in shared memory: a word
    count of 4 mod 8, so 8 consecutive channels start in distinct banks
    (csrc plane_elems)."""
    w = (rows * cols + 1) // 2
    w += (4 - w) % 8
    return 2 * w


def dw_tc_lead(pad: int, stride: int) -> int:
    """Columns a tile starts left of its stage, so that its first source
    column is a multiple of 8 at stride 1 (csrc lead)."""
    return -pad % 8 if stride == 1 else 0


def dw_tc_units_per_warp(k: int, bn: int) -> int:
    """Units (16 rows of the tapped operand times its k tap columns: k m16
    tiles) a warp holds beside bn // 8 n8 tiles, at most 2 (csrc
    units_per_warp)."""
    return min(2, DW_TC_ACC // (k * (bn // 8)))


def dw_tc_tiling(k: int, cs: int, cu: int, batch: int, hp: int,
                 wp: int) -> DwTiling:
    """How conv_dw_tc splits dw[(t, s), u] = sum_p S[s, p + tap t] U[u, p]
    over the pixels p of [batch, hp, wp]: M = k*k*cs, N = cu. Chunks of U's
    channels as wide as a unit's k x bn // 8 tiles allow (at most 64),
    evened out to multiples of 8; chunks of S's channels as large as the
    warps' accumulators and the shared memory allow, evened out; warp groups
    along M: one per unit, up to 8; strips of whole stages, full-width where
    the grid still reaches about DW_TC_BLOCKS blocks, else split along
    the columns."""
    n_chunks = -(-cu // (8 * min(8, DW_TC_ACC // k)))
    bn = 8 * -(-cu // (8 * n_chunks))
    upw = dw_tc_units_per_warp(k, bn)
    plane_bytes = 2 * dw_tc_plane(DW_TC_ROWS + k - 1, DW_TC_TILE_COLS)
    cb = min(cs, 16 * DW_TC_WARPS * upw // k, DW_TC_S_BYTES // plane_bytes)
    m_chunks = -(-cs // cb)
    cb = -(-cs // m_chunks)
    units = -(-k * cb // 16)
    wm = 1
    while wm < min(DW_TC_WARPS, units):
        wm *= 2
    sy, sx = -(-hp // DW_TC_ROWS), -(-wp // DW_TC_COLS)
    per_chunk = max(1, DW_TC_BLOCKS // (m_chunks * n_chunks))
    spb = max(1, -(-batch * sy * sx // per_chunk))      # stages per block
    if spb >= sx:
        rows, cols = DW_TC_ROWS * (spb // sx), DW_TC_COLS * sx
    else:
        rows = DW_TC_ROWS
        cols = DW_TC_COLS * -(-sx // -(-sx // spb))
    slices = batch * -(-hp // rows) * -(-wp // cols)
    return DwTiling(rows, cols, cb, bn, wm, slices)


def _launch_dw_tc(x, g, k, pad, stride, scale, shift, negslope, gtap, name):
    """bf16 K4 (gtap False: fp32 [k, k, s*s*Cin, Cout]) or K7 (gtap True,
    stride 1: fp32 [Cin, k*k*Cout], taps not yet reversed) on the tensor
    cores."""
    B, cin, h, wd = x.shape
    cout, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    sp, tp, G = _prologue_args(x, scale, shift)
    if gtap:
        cs, cu, hp, wp = cout, cin, ho + k - 1, wo + k - 1
    else:
        cs, cu, hp, wp = stride * stride * cin, cout, ho, wo
    t = dw_tc_tiling(k, cs, cu, B, hp, wp)
    partial = torch.empty(t.slices, k * k * cs * cu, dtype=torch.float32,
                          device=x.device)
    shape = (cin, k * k * cout) if gtap else (k, k, cs, cout)
    dw = torch.empty(shape, dtype=torch.float32, device=x.device)
    fn = _build.library("conv").conv_dw_tc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
        + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    status = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), sp, tp, B, cin, h, wd, cout, ho, wo, k, pad,
                stride, G, float(negslope), int(gtap), t.rows, t.cols, t.cb,
                t.bn, t.wm, _build.stream_ptr(x.device))
    _build.check(status, name)
    return dw


def _launch_dw(x, g, k, pad, stride, scale, shift, negslope, name):
    """K4 over the virtual input of x: fp32 [k, k, s*s*Cin, Cout]; g must
    be in x's type. bf16 on the tensor cores, fp32 on the CUDA cores."""
    x, g = x.contiguous(), g.contiguous()
    dtype = _build.check_cuda_tensors(name, x, g)
    if k not in KERNEL_KS:
        raise ValueError(f"{name}: kernel is built for k in {KERNEL_KS}, "
                         f"got {k}")
    B, cin, h, wd = x.shape
    cout, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    if g.shape[0] != B or stride not in (1, 2):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} vs input "
                         f"{tuple(x.shape)}, stride {stride}")
    if dtype == _build.DTYPES["bfloat16"]:
        return _launch_dw_tc(x, g, k, pad, stride, scale, shift, negslope,
                             False, name)
    sp, tp, G = _prologue_args(x, scale, shift)
    cv = stride * stride * cin
    rows = -(-B * ho // _DW_CHUNKS)
    rows = -(-rows // _DW_ROW_TILE) * _DW_ROW_TILE
    n_chunks = B * -(-ho // rows)
    partial = torch.empty(n_chunks, k * k * cv * cout, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(k, k, cv, cout, dtype=torch.float32, device=x.device)
    fn = _build.library("conv").conv_dw
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), sp, tp, B, cin, h, wd, cout, ho, wo, k, pad,
                stride, G, float(negslope), rows, _build.stream_ptr(x.device))
    _build.check(status, name)
    return dw


def _launch_dw_gtap(x, g, k, pad, scale, shift, negslope, name):
    """K7 over the virtual input of x at stride 1: fp32 [k, k, Cin, Cout];
    g must be in x's type. bf16 on the tensor cores, fp32 on the CUDA
    cores."""
    x, g = x.contiguous(), g.contiguous()
    dtype = _build.check_cuda_tensors(name, x, g)
    if k not in GTAP_KS:
        raise ValueError(f"{name}: kernel is built for k in {GTAP_KS}, "
                         f"got {k}")
    B, cin, h, wd = x.shape
    cout, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    if g.shape[0] != B:
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} vs input "
                         f"{tuple(x.shape)}")
    if dtype == _build.DTYPES["bfloat16"]:
        return _reverse_taps(_launch_dw_tc(x, g, k, pad, 1, scale, shift,
                                           negslope, True, name), k)
    sp, tp, G = _prologue_args(x, scale, shift)
    hv = ho + k - 1                       # K7 splits V's rows into chunks
    rows = -(-B * hv // _DW_CHUNKS)
    rows = -(-rows // _DW_ROW_TILE) * _DW_ROW_TILE
    n_chunks = B * -(-hv // rows)
    partial = torch.empty(n_chunks, cin * k * k * cout, dtype=torch.float32,
                          device=x.device)
    dwt = torch.empty(cin, k * k * cout, dtype=torch.float32, device=x.device)
    fn = _build.library("conv").conv_dw_gtap
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dwt.data_ptr(), sp, tp, B, cin, h, wd, cout, ho, wo, k, pad,
                G, float(negslope), rows, _build.stream_ptr(x.device))
    _build.check(status, name)
    return _reverse_taps(dwt, k)


def _same_pad(w: torch.Tensor, name: str) -> int:
    """The SAME border (k-1)//2 of w's odd k > 1; raises otherwise."""
    k = w.shape[0]
    if k % 2 == 0 or k < 3:
        raise ValueError(f"{name}: SAME needs an odd k > 1, got {k}")
    return (k - 1) // 2


def conv_same_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3'' SAME on the card: the conv with the zero border (k-1)//2. w must
    already be in x's type. bf16 launches run on the tensor cores and also
    count in tc_launches (as in every K3 wrapper below)."""
    pad = _same_pad(w, "conv_same")
    y = _launch_fwd(x, w, _out_hw(x, w.shape[0], pad), pad, 1, None, None,
                    1.0, "conv_same")
    conv_same_cuda.launches += 1
    conv_same_cuda.tc_launches += x.dtype == torch.bfloat16
    return y


conv_same_cuda.launches = 0
conv_same_cuda.tc_launches = 0


def conv_same_pro_cuda(x: torch.Tensor, w: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor,
                       negslope: float = 1.0) -> torch.Tensor:
    """K3'' SAME pro on the card: the SAME conv of leaky_ns(x*scale +
    shift)."""
    pad = _same_pad(w, "conv_same_pro")
    y = _launch_fwd(x, w, _out_hw(x, w.shape[0], pad), pad, 1, scale, shift,
                    negslope, "conv_same_pro")
    conv_same_pro_cuda.launches += 1
    conv_same_pro_cuda.tc_launches += x.dtype == torch.bfloat16
    return y


conv_same_pro_cuda.launches = 0
conv_same_pro_cuda.tc_launches = 0


def conv_same_pro_stats_cuda(x: torch.Tensor, w: torch.Tensor,
                             scale: torch.Tensor, shift: torch.Tensor,
                             negslope: float = 1.0):
    """K3''' on the card: (out, s1, s2) of conv_same_pro_cuda, s1/s2 the
    fp32 [G, Cout] sums of the cast output and its square per stack."""
    pad = _same_pad(w, "conv_same_pro_stats")
    y, st = _launch_fwd(x, w, _out_hw(x, w.shape[0], pad), pad, 1, scale,
                        shift, negslope, "conv_same_pro_stats", True)
    conv_same_pro_stats_cuda.launches += 1
    conv_same_pro_stats_cuda.tc_launches += x.dtype == torch.bfloat16
    return y, st[:, 0], st[:, 1]


conv_same_pro_stats_cuda.launches = 0
conv_same_pro_stats_cuda.tc_launches = 0


def conv_dw_gtap_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None,
                      negslope: float = 1.0, pad: int = 0) -> torch.Tensor:
    """K7 on the card: fp32 [k, k, Cin, Cout] by tapping the cotangent; pad
    (k-1)//2 is SAME, pad 0 on a padded x VALID. g must be in x's type.
    bf16 launches run on the tensor cores and also count in
    tc_launches."""
    dw = _launch_dw_gtap(x, g, k, pad, scale, shift, negslope,
                         "conv_dw_gtap")
    conv_dw_gtap_cuda.launches += 1
    conv_dw_gtap_cuda.tc_launches += x.dtype == torch.bfloat16
    return dw


conv_dw_gtap_cuda.launches = 0
conv_dw_gtap_cuda.tc_launches = 0


def conv_valid_cuda(x: torch.Tensor, w: torch.Tensor,
                    pad: int = 0) -> torch.Tensor:
    """K3 on the card: VALID stride-1 conv with an implicit zero border.
    w must already be in x's type. bf16 launches run on the tensor cores
    and also count in tc_launches."""
    y = _launch_fwd(x, w, _out_hw(x, w.shape[0], pad), pad, 1, None, None,
                    1.0, "conv_valid")
    conv_valid_cuda.launches += 1
    conv_valid_cuda.tc_launches += x.dtype == torch.bfloat16
    return y


conv_valid_cuda.launches = 0
conv_valid_cuda.tc_launches = 0


def conv_valid_pro_cuda(x: torch.Tensor, w: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        negslope: float = 1.0, pad: int = 0, stride: int = 1,
                        out_hw: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """K3' pro on the card: the conv of leaky_ns(x*scale + shift) with a
    zero border of z; stride 2 takes the space-to-depth kernel."""
    y = _launch_fwd(x, w, out_hw or _out_hw(x, w.shape[0], pad), pad,
                    stride, scale, shift, negslope, "conv_valid_pro")
    conv_valid_pro_cuda.launches += 1
    conv_valid_pro_cuda.tc_launches += x.dtype == torch.bfloat16
    return y


conv_valid_pro_cuda.launches = 0
conv_valid_pro_cuda.tc_launches = 0


def conv_valid_s2d_cuda(x: torch.Tensor, w: torch.Tensor, pad: int,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """K3 at k2 on the card: the stride-2 conv of x (zero border `pad`) as
    the VALID conv of its phase image with the [k2, k2, 4Cin, Cout]
    kernel w."""
    y = _launch_fwd(x, w, out_hw, pad, 2, None, None, 1.0, "conv_valid_s2d")
    conv_valid_s2d_cuda.launches += 1
    conv_valid_s2d_cuda.tc_launches += x.dtype == torch.bfloat16
    return y


conv_valid_s2d_cuda.launches = 0
conv_valid_s2d_cuda.tc_launches = 0


def conv_dw_cuda(xp: torch.Tensor, g: torch.Tensor, k: int,
                 pad: int = 0) -> torch.Tensor:
    """K4 on the card: fp32 [k, k, Cin, Cout]; g must be in xp's type.
    bf16 launches run on the tensor cores and also count in
    tc_launches."""
    dw = _launch_dw(xp, g, k, pad, 1, None, None, 1.0, "conv_dw")
    conv_dw_cuda.launches += 1
    conv_dw_cuda.tc_launches += xp.dtype == torch.bfloat16
    return dw


conv_dw_cuda.launches = 0
conv_dw_cuda.tc_launches = 0


def conv_dw_pro_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                     scale: torch.Tensor, shift: torch.Tensor,
                     negslope: float = 1.0, pad: int = 0,
                     stride: int = 1) -> torch.Tensor:
    """K4' pro on the card: dw of the pro conv, the prologue recomputed on
    the read (bf16 on the tensor cores, also counted in tc_launches)."""
    dw = _launch_dw(x, g, k, pad, stride, scale, shift, negslope,
                    "conv_dw_pro")
    conv_dw_pro_cuda.launches += 1
    conv_dw_pro_cuda.tc_launches += x.dtype == torch.bfloat16
    return dw


conv_dw_pro_cuda.launches = 0
conv_dw_pro_cuda.tc_launches = 0


def conv_dw_s2d_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                     pad: int) -> torch.Tensor:
    """K4 at k2 on the card: dw [k2, k2, 4Cin, Cout] of the s2d conv (bf16
    on the tensor cores, also counted in tc_launches)."""
    dw = _launch_dw(x, g, k, pad, 2, None, None, 1.0, "conv_dw_s2d")
    conv_dw_s2d_cuda.launches += 1
    conv_dw_s2d_cuda.tc_launches += x.dtype == torch.bfloat16
    return dw


conv_dw_s2d_cuda.launches = 0
conv_dw_s2d_cuda.tc_launches = 0


def conv_forward(x, w, scale=None, shift=None, negslope: float = 1.0,
                 pad: int = 0, stride: int = 1,
                 out_hw: Optional[Tuple[int, int]] = None, same: bool = False,
                 want_stats: bool = False):
    """K3 for a CUDA tensor, in the form the arguments ask for: with `same`
    (stride 1, pad (k-1)//2) K3'' SAME, pro when scale is given, K3''' with
    want_stats (then (out, s1, s2)); else pro when scale is given, s2d at
    stride 2, plain. The plain version for a CPU tensor."""
    w = w.to(x.dtype)
    out_hw = out_hw or _out_hw(x, w.shape[0], pad)
    if not x.is_cuda:
        out = conv_valid_pro_plain(x, w, scale, shift, negslope, pad, stride,
                                   out_hw)
        return (out, *stack_sums(out, scale.shape[0])) if want_stats else out
    if same:
        if want_stats:
            return conv_same_pro_stats_cuda(x, w, scale, shift, negslope)
        if scale is not None:
            return conv_same_pro_cuda(x, w, scale, shift, negslope)
        return conv_same_cuda(x, w)
    if scale is not None:
        return conv_valid_pro_cuda(x, w, scale, shift, negslope, pad, stride,
                                   out_hw)
    if stride == 2:
        return conv_valid_s2d_cuda(x, w, pad, out_hw)
    return conv_valid_cuda(x, w, pad)


def conv_weight_grad(x, g, k: int, scale=None, shift=None,
                     negslope: float = 1.0, pad: int = 0, stride: int = 1,
                     same: bool = False):
    """K4 for a CUDA tensor, in the form of conv_forward; with `same`, K7
    where the reference's _dw_impl (:647) routes it: DW_TAP_ON_N and
    _gtap_better(k, Cin, Cout). The plain version for a CPU tensor. fp32
    [k, k, s*s*Cin, Cout]."""
    g = g.to(x.dtype)
    gtap = same and DW_TAP_ON_N and _gtap_better(k, x.shape[1], g.shape[1])
    if not x.is_cuda:
        if gtap:
            return conv_dw_gtap_plain(x, g, k, scale, shift, negslope, pad)
        return conv_dw_pro_plain(x, g, k, scale, shift, negslope, pad, stride)
    if gtap:
        return conv_dw_gtap_cuda(x, g, k, scale, shift, negslope, pad)
    if scale is not None:
        return conv_dw_pro_cuda(x, g, k, scale, shift, negslope, pad, stride)
    if stride == 2:
        return conv_dw_s2d_cuda(x, g, k, pad)
    return conv_dw_cuda(x, g, k, pad)


def _from_phases(dv: torch.Tensor, x_shape, pad: int) -> torch.Tensor:
    """Gradient w.r.t. the phase image [B, 4C, hv, wv] -> w.r.t. the source
    x [B, C, H, W] under a zero border `pad` (the inverse of
    virtual_input_plain's space-to-depth)."""
    B, c4, hv, wv = dv.shape
    C = c4 // 4
    d = dv.reshape(B, 2, 2, C, hv, wv).permute(0, 3, 4, 1, 5, 2) \
        .reshape(B, C, 2 * hv, 2 * wv)
    H, W = x_shape[2], x_shape[3]
    return F.pad(d, (-pad, W + pad - 2 * wv, -pad, H + pad - 2 * hv))


def _prologue_bwd(x, dz, scale, shift, negslope: float):
    """Chain rule through z = leaky_ns(x*scale + shift), in torch ops as the
    reference computes it outside its kernels (:882-893): (dx, dscale,
    dshift), the last two per stack."""
    G = scale.shape[0]
    x32, dz32 = wide(split_stacks(x, G)), wide(split_stacks(dz, G))
    sc = _rows(wide(scale))
    if negslope != 1.0:
        u = x32 * sc + _rows(wide(shift))
        du = torch.where(u >= 0, dz32, dz32 * negslope)
    else:
        du = dz32
    dx = (du * sc).reshape(x.shape).to(x.dtype)
    dscale = (du * x32).sum(dim=(1, 3, 4)).to(scale.dtype)
    dshift = du.sum(dim=(1, 3, 4)).to(shift.dtype)
    return dx, dscale, dshift


class ConvValidPro(torch.autograd.Function):
    """The conv of z = leaky_ns(x*scale + shift) with a zero border `pad`
    of z, at stride 1 or as the space-to-depth stride-2 conv (w is then the
    [k2, k2, 4Cin, Cout] phase kernel); scale None means z = x, the plain
    conv (conv_valid_chw :706-732). `same` (stride 1, odd k, pad (k-1)//2)
    takes the SAME route's kernels (conv_same_chw :735-766,
    conv_same_pro_chw :769-813); with want_stats it returns (out, s1, s2),
    the per-stack sums of out and out^2 (conv_same_pro_stats_chw
    :816-848). The backward mirrors _convp_bwd (conv_pallas.py:873-896):
    the statistics' cotangents folded into g as :834-844 does (d s1/d out =
    1, d s2/d out = 2 out, in fp32, cast to g's type), dz from K3 in the
    forward's form with the flipped kernel, the prologue's chain rule in
    torch ops, dw from K4 (with `same`, K7 where the reference routes it)
    with the prologue recomputed on the read. z is never stored."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, pad: int, stride: int,
                out_hw: Tuple[int, int], negslope: float, same: bool,
                want_stats: bool):
        x = x.contiguous()
        res = conv_forward(x, w, scale, shift, negslope, pad, stride, out_hw,
                           same, want_stats)
        ctx.save_for_backward(x, w, scale, shift,
                              res[0] if want_stats else None)
        ctx.cfg = (pad, stride, negslope, same, want_stats)
        return res

    @staticmethod
    def backward(ctx, g, *g_stats):
        x, w, scale, shift, out = ctx.saved_tensors
        pad, stride, negslope, same, want_stats = ctx.cfg
        if want_stats:
            g_s1, g_s2 = g_stats
            G = scale.shape[0]
            gf = split_stacks(wide(g), G) + _rows(g_s1) \
                + 2.0 * split_stacks(wide(out), G) * _rows(g_s2)
            g = gf.reshape(g.shape).to(g.dtype)
        k = w.shape[0]
        g = g.to(x.dtype).contiguous()
        dx = dw = dscale = dshift = None
        if any(ctx.needs_input_grad[i] for i in (0, 2, 3)):
            w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3)
            if stride == 1:
                # the (k-1-pad) border lands dz on x's own pixels
                dz = conv_forward(g, w_flip, pad=k - 1 - pad, same=same)
            else:
                dz = _from_phases(conv_forward(g, w_flip, pad=k - 1),
                                  x.shape, pad)
            if scale is None:
                dx = dz
            else:
                dx, dscale, dshift = _prologue_bwd(x, dz, scale, shift,
                                                   negslope)
        if ctx.needs_input_grad[1]:
            dw = conv_weight_grad(x, g, k, scale, shift, negslope, pad,
                                  stride, same).to(w.dtype)
        return dx, dw, dscale, dshift, None, None, None, None, None, None


def conv_valid_chw(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID k x k stride-1 conv on pre-padded [B, Cin, Hp, Wp] with
    w [k, k, Cin, Cout] -> [B, Cout, Hp-k+1, Wp-k+1] (differentiable)."""
    return ConvValidPro.apply(xp, w, None, None, 0, 1,
                              _out_hw(xp, w.shape[0], 0), 1.0, False, False)


def s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """[k, k, Cin, Cout] -> the [k2, k2, 4Cin, Cout] phase kernel, k2 =
    ceil(k/2): tap (dy, dx) lands at (dy//2, dx//2) of phase (dy%2, dx%2);
    unused taps are exactly zero (conv_pallas.py:1054-1059)."""
    k, _, cin, cout = w.shape
    k2 = (k + 1) // 2
    e = 2 * k2 - k
    wp = F.pad(w, (0, 0, 0, 0, 0, e, 0, e))
    return wp.reshape(k2, 2, k2, 2, cin, cout).permute(0, 2, 1, 3, 4, 5) \
        .reshape(k2, k2, 4 * cin, cout)


def _as_rows(v: torch.Tensor) -> torch.Tensor:
    """Prologue vector [C] (one stack) or [G, C] -> fp32 [G, C]."""
    v = wide(v)
    return (v[None] if v.dim() == 1 else v).contiguous()


def _same_route(k: int, stride: int, pad: str) -> bool:
    """The reference's SAME branch (conv_pallas.py:924-925, :1019-1020):
    SAME_BORDER_KERNELS on, stride 1, zero padding, odd k > 1."""
    return (SAME_BORDER_KERNELS and stride == 1 and pad != "reflection"
            and k > 1 and k % 2 == 1)


def _conv_any(x, w, pad: str, stride: int, scale, shift, negslope: float,
              want_stats: bool = False):
    """torch (k-1)//2 padding (zero: the kernels' implicit border), then
    ConvValidPro at stride 1 or 2; the SAME route where _same_route says
    so, with the statistics if want_stats (only there)."""
    k = w.shape[0]
    to_pad = (k - 1) // 2
    if _same_route(k, stride, pad):
        return ConvValidPro.apply(x, w, scale, shift, to_pad, 1,
                                  _out_hw(x, k, to_pad), negslope, True,
                                  want_stats)
    if to_pad and pad == "reflection":
        # reflection commutes with the per-channel prologue
        x = reflect_pad(x, to_pad)
        to_pad = 0
    if stride == 1:
        return ConvValidPro.apply(x, w, scale, shift, to_pad, 1,
                                  _out_hw(x, k, to_pad), negslope, False,
                                  False)
    if stride != 2:
        raise NotImplementedError(f"stride {stride}")
    ho = (x.shape[2] + 2 * to_pad - k) // 2 + 1
    wo = (x.shape[3] + 2 * to_pad - k) // 2 + 1
    return ConvValidPro.apply(x, s2d_kernel(w), scale, shift, to_pad, 2,
                              (ho, wo), negslope, False, False)


def _add_bias(out: torch.Tensor, p: dict) -> torch.Tensor:
    if "bias" in p:
        out = out + p["bias"].to(out.dtype)[:, None, None]
    return out


def kernel_conv_chw(x: torch.Tensor, p: dict, stride: int = 1,
                    pad: str = "zero") -> torch.Tensor:
    """Counterpart of pallas_conv_chw: torch (k-1)//2 zero or reflection
    padding, the conv (stride 2 as space-to-depth; the SAME route where
    _same_route says so), then the bias (added outside the kernel, as the
    reference does)."""
    return _add_bias(_conv_any(x, p["kernel"], pad, stride, None, None, 1.0),
                     p)


def kernel_conv_bn_act_chw(x: torch.Tensor, p: dict, scale: torch.Tensor,
                           shift: torch.Tensor, stride: int = 1,
                           pad: str = "zero", negslope: float = 0.2,
                           want_stats: bool = False):
    """Counterpart of pallas_conv_bn_act_chw: conv(leaky_ns(x*scale +
    shift)) + bias with the padding and stride of kernel_conv_chw.
    scale/shift: [C], or [G, C] for G BatchNorm stacks of B/G batch items
    each. want_stats: return (out, s1, s2), each stack's fp32 sums of out
    and out^2 [G, Cout] (the consumer BatchNorm's statistics): from K3'''
    on the SAME route, with the bias shifted in algebraically (:941-947),
    else a reduction of out."""
    sc, sh = _as_rows(scale), _as_rows(shift)
    if want_stats and _same_route(p["kernel"].shape[0], stride, pad):
        out, s1, s2 = _conv_any(x, p["kernel"], pad, stride, sc, sh,
                                negslope, True)
        if "bias" in p:
            b32 = wide(p["bias"])
            n = out.shape[0] // sc.shape[0] * out.shape[2] * out.shape[3]
            s2 = s2 + 2.0 * b32 * s1 + n * torch.square(b32)
            s1 = s1 + n * b32
        return _add_bias(out, p), s1, s2
    out = _add_bias(_conv_any(x, p["kernel"], pad, stride, sc, sh, negslope),
                    p)
    if want_stats:
        return (out, *stack_sums(out, sc.shape[0]))
    return out
