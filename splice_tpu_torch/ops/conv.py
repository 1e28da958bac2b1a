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

conv_route (below) names the kernel and form of every launch from its
shape, before the launch; every k >= 1 has one. bf16 runs on the tensor
cores (mma.sync): K3 in every form, the input gradient included, through
an implicit-GEMM kernel, K4 and K7 through another, each in two forms
(px_form picks): the channel-major forms at k <= 3 (csrc/conv.cu
conv_fwd_tc and conv_dw_tc, tiled by fwd_tc_tiling and dw_tc_tiling), the
pixel-major forms at 16 taps or more and at the 9-tap phase kernels of
stride 2 (conv_fwd_px and conv_dw_px, tiled by fwd_px_tiling and
dw_px_tiling: the contraction split across blocks, as the inversion net's
7x7 and 5x5 sites need to fill the card), except that K4 at Cout <= 16
keeps conv_dw_tc where its grid busies half the SMs (dw_px_form); K7
takes its own kernel at every k >= 2 (conv_dw_tc's cotangent-tapped
instances at k in DW_TC_GTAP_KS, conv_dw_px's cotangent-tapped mode at
every other k). fp32 K3 and K4 run
on the tensor cores too, in split TF32 (three TF32 products a product,
csrc/tf32.cuh, which keep the fp32 steps' 1e-4 gates), through one kernel
each for every form at any k (conv_fwd_tf32 and conv_dw_tf32, tiled by
fwd_tf32_tiling and dw_tf32_tiling); fp32 K7 is conv_dw_tf32's
cotangent-tapped mode (gtap). Each wrapper counts its tensor-core launches
in tc_launches: every K3, K4 and K7 launch.

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
DW_TC_KS = (1, 2, 3, 4, 5, 7)   # csrc conv_dw_tc's instances
DW_TC_NARROW = 16         # K4's Cout that may keep conv_dw_tc at k >= 4

# bf16 K7's k on conv_dw_tc's cotangent-tapped instances (the generators'
# SAME filters 3, 5, 7 and k = 2 for VALID K7 on a bordered input); every
# other k >= 2 takes conv_dw_px's cotangent-tapped mode (a run-time k).
DW_TC_GTAP_KS = (2, 3, 5, 7)

# bf16 K3 on the tensor cores at k <= 3 (csrc/conv.cu, namespace fwdtc;
# conv_route sends larger k to the pixel-major form): a block holds up to
# FWD_TC_MT m16 tiles of Cout (wider outputs split into evened chunks;
# fewer tiles where a wide k's weight tile would not fit) and walks a
# strip of output pixels in stages of FWD_TC_ROWS rows
# (one per warp) x 8 * fwd_tc_nb(mt) columns, staging V's channels in
# chunks that fit FWD_TC_SMEM with the weights (two blocks per SM); the
# grid aims at FWD_TC_BLOCKS blocks, as the dw kernel's.
FWD_TC_ROWS = 8           # csrc fwdtc::TR
FWD_TC_MT = 5             # csrc fwdtc::launch_k's cases
FWD_TC_SMEM = 110 * 1024
FWD_TC_BLOCKS = 528

# bf16 K3 and K4 at 16 taps or more and at the 9-tap phase kernels of
# stride 2 (csrc/conv.cu, namespace px; px_form): K3 tiles of PX_ROWS x
# PX_COLS output pixels, K4 stages of PX_ROWS x PX_COLS pixels; V staged
# pixel-major, PX_PIXEL elements (16 channels of a chunk and 8 of padding)
# a pixel, at most PX_ITEMS pixels of a tile a thread of PX_THREADS; each
# block's two-stage ring within PX_SMEM (two blocks per SM). K4's strips
# aim at PX_BLOCKS blocks (two on each of 132 SMs) with their partials
# within PX_PARTIAL bytes, its contraction split further only while the
# grid is under half of PX_WAVE (one a SM); K3 splits its
# contraction toward PX_WAVE blocks in at most PX_CLUSTER splits, which a
# thread-block cluster adds in shared memory (more, and the K3''' sums,
# take fp32 partials and a second pass of PX_PCH pixels a block).
PX_ROWS = 8               # csrc px::TR
PX_COLS = 32              # csrc px::TC
PX_PIXEL = 24             # csrc px::CS
PX_ITEMS = 2              # csrc px::ITEMS
PX_THREADS = 256          # csrc px::THREADS
PX_G_PLANE = PX_ROWS * (PX_COLS + 8) + 8   # csrc px::GP
PX_SMEM = 113 * 1024
PX_BLOCKS = 264
PX_WAVE = 132
PX_CLUSTER = 8            # csrc px::CLUSTER
PX_PARTIAL = 8 << 20
PX_PCH = 512              # csrc px::THREADS * px::PPT
# K7 on conv_dw_px's cotangent-tapped mode: at most PX_GTAP_NB n8 tiles of
# Cin a block (csrc conv_dw_px), strips of at most PX_GTAP_STAGES stages
# (4096 pixels: each warp's fp32 chains over at most 256 k16 steps, as the
# tensor cores truncate as they accumulate), their partials within
# PX_GTAP_PARTIAL bytes
PX_GTAP_NB = 2
PX_GTAP_STAGES = 16
PX_GTAP_PARTIAL = 64 << 20

# bf16 K4 and K7 on large maps (csrc/conv.cu, namespace wgdw: wgmma, TMA;
# dw_wg_form): a block owns a strip of at most WG_CHAIN // WG_BAND rows of a
# WG_BAND-pixel band (each fp32 accumulator chain adds at most WG_CHAIN
# pixels: the tensor cores truncate as they accumulate, and px's
# cotangent-tapped strips keep the same bound), one 16-channel group of the
# tapped operand, a group of at most 8 * wg_tiles(n) consecutive taps and n
# columns (an instance of WG_NS) of the untapped one; WG_STAGES image rows
# in flight, T staged pixel-major (WG_PIXEL elements a pixel, as px); one
# block of WG_THREADS an SM within WG_SMEM bytes; the strips shortened
# toward WG_FILL blocks where a map gives fewer; their partials within
# WG_PARTIAL bytes. The rule's thresholds (WG_MIN_K, WG_MIN_PIXELS) are
# dw_wg_form's, from the card's times.
WG_BAND = 64              # csrc wgdw::BAND
WG_PIXEL = 24             # csrc wgdw::CS
WG_STAGES = 8             # csrc wgdw::STAGES
WG_THREADS = 256          # csrc wgdw::THREADS
WG_CHAIN = 4096           # csrc wgdw::CHAIN
WG_NS = (16, 24, 32, 40, 48, 64, 72, 96, 136)   # csrc WGDW_NS
WG_SMEM = 227 * 1024
WG_FILL = 264
WG_PARTIAL = 256 << 20
WG_MIN_K = 8
WG_MIN_PIXELS = 2 * 56 * 56

# fp32 K3 and K4 on the tensor cores in split TF32 (csrc/conv.cu, namespace
# tc32). K3: a block owns a strip of output pixels and nb n8 tiles of Cout
# (at most TF32_NB); it walks the strip in stages of TF32_ROWS rows (one a
# warp) x 16 tf32_mt(nb) columns, each stage in units of TF32_CK channels
# of V and a group of ndy tap rows, V's tile staged raw (up to TF32_LEAD
# columns left of its stage, for 16-byte copies) and split into {hi, lo}
# pairs. K4: a block owns a strip of pixels, cb channels of V and nb n8
# tiles of Cout, in stages of TF32_DW_ROWS x TF32_DW_COLS pixels; wm warp
# groups split M (the (tap, c) rows), 8 // wm split a stage's k8 steps; each
# strip writes an fp32 partial within TF32_PARTIAL bytes in all. K7 is K4's
# kernel with the roles swapped (gtap): M = the (tap', co) rows of the
# cotangent, N = Cin, V untapped over its own extent, staged raw from up to
# TF32_LEAD columns left of the stage and split once a stage. Both
# grids aim at TF32_BLOCKS blocks (two waves at two blocks an SM), each
# block within TF32_SMEM bytes of shared memory where a tiling allows it
# (two blocks an SM), else within TF32_SMEM_MAX (one).
TF32_CK = 8               # csrc tc32::CK
TF32_ROWS = 8             # csrc tc32::TR
TF32_LEAD = 3             # csrc tc32::LEAD
TF32_DW_ROWS = 4          # csrc tc32::DR
TF32_DW_COLS = 32         # csrc tc32::DC
TF32_G_PLANE = TF32_DW_ROWS * TF32_DW_COLS + 4   # csrc tc32::GP
TF32_NB = 8               # csrc conv_fwd_tf32 / conv_dw_tf32 cases
TF32_WARPS = 8
TF32_SMEM = 113 * 1024
TF32_SMEM_MAX = 227 * 1024
TF32_BLOCKS = 528
TF32_PARTIAL = 16 << 20

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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(x, w, out_hw, pad, stride, scale, shift, negslope, name,
                want_stats: bool = False, phase: bool = False):
    """K3 over the virtual input of x (see csrc/conv.cu) on the kernel that
    conv_route names, on the tensor cores: bf16 conv_fwd_tc or conv_fwd_px,
    fp32 conv_fwd_tf32 (split TF32). w must already be in x's type. want_stats (K3''', needs the prologue): also the fp32
    [G, 2, Cout] per-stack sums of y and y^2. phase: w is a stride-2 phase
    kernel read at stride 1 (the input gradient of the s2d conv)."""
    x, w = x.contiguous(), w.contiguous()
    _build.check_cuda_tensors(name, x, w)
    B, cin, h, wd = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != stride * stride * cin or stride not in (1, 2):
        raise ValueError(f"{name}: kernel {tuple(w.shape)} vs input "
                         f"{tuple(x.shape)}, stride {stride}")
    if want_stats and scale is None:
        raise ValueError(f"{name}: the statistics need the prologue")
    ho, wo = out_hw
    route = conv_route("fwd", x.dtype, k, stride, wcin, cout, B, ho, wo,
                       phase=phase)
    t = route.tiling
    sp, tp, G = _prologue_args(x, scale, shift)
    y = torch.empty(B, cout, ho, wo, dtype=x.dtype, device=x.device)
    lib = _build.library("conv")
    st_part = stats = None
    if want_stats:
        tiles = B * t.chunks if route.form == "px" else t.tiles
        st_part = torch.empty(tiles, 2, cout, dtype=torch.float32,
                              device=x.device)
        stats = torch.empty(G, 2, cout, dtype=torch.float32, device=x.device)
    tail = (B, cin, h, wd, cout, ho, wo, k, pad, stride, G, float(negslope),
            _ptr(st_part), _ptr(stats))
    tail_types = [ctypes.c_int] * 11 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 2
    fn = getattr(lib, route.entry)
    if route.form == "px":
        partial = None
        if want_stats or t.splits > PX_CLUSTER:
            partial = torch.empty(t.splits * B * cout * ho * wo,
                                  dtype=torch.float32, device=x.device)
        fn.argtypes = [ctypes.c_void_p] * 6 + tail_types \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), _ptr(partial), sp,
                tp, *tail, t.mt, t.ndy, t.cps, t.n_cs, t.n_dyg)
    elif route.form == "tc":
        fn.argtypes = [ctypes.c_void_p] * 5 + tail_types \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), sp, tp, *tail,
                t.rows, t.cols, t.cb, t.wcb, t.mt)
    else:
        fn.argtypes = [ctypes.c_void_p] * 5 + tail_types \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), sp, tp, *tail,
                t.nb, t.ndy, t.rows, t.cols)
    fn.restype = ctypes.c_int
    _build.check(fn(*args, _build.stream_ptr(x.device)), name)
    return (y, stats) if want_stats else y


class ConvRoute(NamedTuple):
    """What conv_route picks: the kernel (K3, K4 or K7), its form ("tc":
    the channel-major bf16 forms, "px": the pixel-major ones, "wg": bf16 K4
    and K7 on wgmma for large maps, "tf32": fp32 in split TF32 on the
    tensor cores), the C entry in csrc/conv.cu and the tiling the wrapper
    passes it."""
    kernel: str
    form: str
    entry: str
    tiling: NamedTuple


def px_form(k: int, phase: bool) -> bool:
    """K3's bf16 rule: the pixel-major form (namespace px) for a kernel of
    16 taps or more (k >= 4), or of 9 as the stride-2 phase kernel of a
    5x5 or 6x6 filter (phase and k == 3; its forward and input gradient);
    the channel-major form for the rest (k <= 3: the training net's 3x3
    and 1x1 and its k2 = 2 phase kernels, and the inversion net's 3x3
    scales), whose grids fill the card at the 224-896 wide maps they were
    designed for. K4 starts from the same rule (dw_px_form)."""
    return k >= 4 or (phase and k == 3)


def dw_tc_blocks(t: "DwTiling", cs: int, cu: int) -> int:
    """The grid of conv_dw_tc under tiling t: strips x chunks of the
    tapped operand's cs channels x chunks of the other's cu."""
    return t.slices * -(-cs // t.cb) * -(-cu // t.bn)


def dw_px_form(k: int, phase: bool, cv: int, cout: int, batch: int,
               ho: int, wo: int) -> bool:
    """K4's bf16 rule: px_form's, except that K4 keeps the channel-major
    form (conv_dw_tc) where Cout <= DW_TC_NARROW, k has an instance there
    (DW_TC_KS) and that form's grid already busies at least half the SMs
    (DW_TC_BLOCKS // 8 blocks). At one n16 tile of Cout each V fragment
    the pixel-major form loads feeds two products and its V and g are
    restaged for every tap-row group, while conv_dw_tc shares one window
    of loads among a tap row's taps; the pixel-major form's wider split
    pays only where conv_dw_tc's grid leaves most SMs idle."""
    if not px_form(k, phase):
        return False
    if cout > DW_TC_NARROW or k not in DW_TC_KS:
        return True
    t = dw_tc_tiling(k, cv, cout, batch, ho, wo)
    return dw_tc_blocks(t, cv, cout) < DW_TC_BLOCKS // 8


def conv_route(op: str, dtype: torch.dtype, k: int, stride: int, cv: int,
               cout: int, batch: int, ho: int, wo: int, same: bool = False,
               gtap: bool = False, phase: bool = False,
               in_w: Optional[int] = None) -> ConvRoute:
    """The kernel and form that run a conv on the card, decided from its
    shape before any launch (pure Python: the CPU tests call it). op "fwd"
    is K3 (the forward and every input gradient), "dw" the weight gradient:
    K7 where it is wanted (gtap, or `same` where the reference's _dw_impl
    picks it: DW_TAP_ON_N and _gtap_better) at stride 1 and any k >= 2
    (bf16: conv_dw_tc at k in DW_TC_GTAP_KS, conv_dw_wg where dw_wg_form
    says so, conv_dw_px's cotangent-tapped mode at the others), else K4
    (bf16: conv_dw_wg where dw_wg_form says so, else dw_px_form picks). k
    is the kernel the launch reads (k2 for a stride-2
    phase kernel, which `phase` also marks at stride 1); cv the channels of
    V (s*s*Cin; for K7 the input's); [batch, ho, wo] the output; in_w the
    input's width where the caller knows it (else wo: a SAME conv's),
    which dw_wg_form reads. bf16 takes
    the tensor cores (px_form picks K3's form, dw_px_form K4's); fp32 K3,
    K4 and K7 take them too, in split TF32 (one kernel for K4 and K7); every
    k >= 1 has a kernel."""
    if k < 1 or stride not in (1, 2):
        raise ValueError(f"conv_route: k {k}, stride {stride}")
    bf16 = dtype == torch.bfloat16
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv_route: dtype {dtype}")
    phase = phase or stride == 2
    if op == "fwd":
        if not bf16:
            return ConvRoute("K3", "tf32", "conv_fwd_tf32",
                             fwd_tf32_tiling(k, cv, cout, batch, ho, wo))
        if px_form(k, phase):
            return ConvRoute("K3", "px", "conv_fwd_px",
                             fwd_px_tiling(k, cv, cout, batch, ho, wo))
        return ConvRoute("K3", "tc", "conv_fwd_tc",
                         fwd_tc_tiling(k, cv, cout, batch, ho, wo))
    if op != "dw":
        raise ValueError(f"conv_route: op {op!r}")
    gtap = gtap or (same and DW_TAP_ON_N and _gtap_better(k, cv, cout))
    widths = (wo if in_w is None else in_w, wo)
    if gtap and stride == 1 and k >= 2:
        hp, wp = ho + k - 1, wo + k - 1
        if not bf16:
            return ConvRoute("K7", "tf32", "conv_dw_tf32", dw_tf32_tiling(
                k, cout, cv, batch, hp, wp, gtap=True))
        if k in DW_TC_GTAP_KS:
            return ConvRoute("K7", "tc", "conv_dw_tc", dw_tc_tiling(
                k, cout, cv, batch, hp, wp))
        if dw_wg_form(k, phase, cv, cout, batch, ho, wo, widths):
            return ConvRoute("K7", "wg", "conv_dw_wg", dw_wg_plan(
                k, cv, cout, batch, ho, wo, widths[0]))
        return ConvRoute("K7", "px", "conv_dw_px",
                         dw_px_gtap_tiling(k, cout, cv, batch, hp, wp))
    if not bf16:
        return ConvRoute("K4", "tf32", "conv_dw_tf32",
                         dw_tf32_tiling(k, cv, cout, batch, ho, wo))
    if dw_wg_form(k, phase, cv, cout, batch, ho, wo, widths):
        return ConvRoute("K4", "wg", "conv_dw_wg",
                         dw_wg_plan(k, cv, cout, batch, ho, wo, widths[0]))
    if dw_px_form(k, phase, cv, cout, batch, ho, wo):
        return ConvRoute("K4", "px", "conv_dw_px",
                         dw_px_tiling(k, cv, cout, batch, ho, wo))
    return ConvRoute("K4", "tc", "conv_dw_tc",
                     dw_tc_tiling(k, cv, cout, batch, ho, wo))


class FwdPxTiling(NamedTuple):
    """conv_fwd_px's work split: mt m16 tiles of Cout a block; the k tap
    rows in n_dyg groups of ndy; V's 16-channel chunks in n_cs groups of
    cps; splits = n_dyg * n_cs (above 1, added by a cluster up to
    PX_CLUSTER, else, and with the K3''' sums, by the second pass);
    blocks of the grid; chunks = the second pass's blocks an image (the
    K3''' scratch rows per image)."""
    mt: int
    ndy: int
    n_dyg: int
    cps: int
    n_cs: int
    splits: int
    blocks: int
    chunks: int


def _px_tile_fits(k: int, ndy: int) -> bool:
    """V's tile of ndy tap rows (PX_ROWS + ndy - 1 rows of PX_COLS + k - 1
    pixels) in the PX_ITEMS pixels a thread holds (csrc launch checks)."""
    return (PX_ROWS + ndy - 1) * (PX_COLS + k - 1) <= PX_ITEMS * PX_THREADS


def fwd_px_smem(k: int, ndy: int, mt: int, stages: int = 2) -> int:
    """Bytes of conv_fwd_px's shared memory: its ring of `stages` stages of
    V's tile and of the weights of ndy * k taps x 16 channels x 16 mt + 8
    (one where each block has one channel chunk), or the fp32 output tile
    a cluster adds ([16 mt][PX_ROWS * PX_COLS + 8]) where that is larger
    (csrc px::fwd_smem)."""
    ring = stages * 2 * ((PX_ROWS + ndy - 1) * (PX_COLS + k - 1) * PX_PIXEL
                         + ndy * k * 16 * (16 * mt + 8))
    return max(ring, 4 * 16 * mt * (PX_ROWS * PX_COLS + 8))


def dw_px_smem(k: int, ndy: int, nb: int) -> int:
    """Bytes of conv_dw_px's ring: two stages of V's tile and g's 8 nb
    channel planes (csrc px::dw_smem)."""
    return 2 * 2 * ((PX_ROWS + ndy - 1) * (PX_COLS + k - 1) * PX_PIXEL
                    + 8 * nb * PX_G_PLANE)


def _tap_rows(k: int):
    """The distinct group sizes of k tap rows, largest first."""
    return sorted({-(-k // n) for n in range(1, k + 1)}, reverse=True)


def fwd_px_tiling(k: int, cv: int, cout: int, batch: int, ho: int,
                  wo: int) -> FwdPxTiling:
    """How conv_fwd_px splits y[co, p] = sum_(t, c) w[t, c, co] V[c, p + t]:
    Cout in as few evened chunks of at most 4 m16 tiles as it takes;
    output tiles of PX_ROWS x PX_COLS; the tap rows in as few groups as let
    the ring fit PX_SMEM (each group restages V's rows with their halo),
    with V's 16-channel chunks in evened groups toward PX_WAVE blocks, in
    at most PX_CLUSTER splits in all (a cluster adds them; only tap-row
    groups beyond PX_CLUSTER take the second pass); a block of one chunk
    needs one stage of the ring."""
    n_co = -(-cout // 64)
    mt = -(-(-(-cout // n_co)) // 16)
    n_co = -(-cout // (16 * mt))
    tiles = batch * -(-ho // PX_ROWS) * -(-wo // PX_COLS)
    n_cc = -(-cv // 16)
    for ndy in _tap_rows(k):
        n_dyg = -(-k // ndy)
        base = tiles * n_co * n_dyg
        n_cs = max(1, min(n_cc, PX_CLUSTER // n_dyg, -(-PX_WAVE // base)))
        cps = -(-n_cc // n_cs)
        n_cs = -(-n_cc // cps)
        if _px_tile_fits(k, ndy) and fwd_px_smem(
                k, ndy, mt, 1 if cps == 1 else 2) <= PX_SMEM:
            break
    else:
        raise ValueError(f"fwd_px_tiling: no tiling of k = {k} fits")
    return FwdPxTiling(mt, ndy, n_dyg, cps, n_cs, n_dyg * n_cs, base * n_cs,
                       -(-ho * wo // PX_PCH))


class DwPxTiling(NamedTuple):
    """conv_dw_px's work split: strips of rows x cols pixels (whole
    PX_ROWS x PX_COLS stages); the k tap rows in groups of ndy; nb n8
    tiles (8 nb channels) of the other operand a block; slices = strips,
    the partials conv_dw_sum_kernel adds; blocks of the grid."""
    rows: int
    cols: int
    ndy: int
    nb: int
    slices: int
    blocks: int


def dw_px_tiling(k: int, cs: int, cu: int, batch: int, hp: int,
                 wp: int, max_nb: int = 4, max_stages: int = 0,
                 partial: int = PX_PARTIAL) -> DwPxTiling:
    """How conv_dw_px splits dw[t, s, u] = sum_p V[s, p + t] U[u, p] over
    the pixels of [batch, hp, wp]: channel groups of 16 of V; chunks of nb
    n8 tiles of U (at most 4, fewer where a tap row outnumbers the warps'
    16 / nb taps each); the tap rows in groups whose taps the 8 warps hold
    and whose ring fits PX_SMEM; strips of whole stages, full-width where
    the grid still reaches PX_BLOCKS, else split along the columns, and no
    more strips than keep their fp32 partials within PX_PARTIAL bytes
    (conv_dw_sum_kernel reads them all). Where the grid stays under half
    of PX_WAVE, smaller tap-row groups (each restages V and U), then
    narrower chunks of U: the first candidate that reaches it, else the
    largest grid. max_nb caps nb, max_stages (if given) a strip's stages
    where `partial` bytes of partials allow it (K7's cotangent-tapped mode:
    dw_px_gtap_tiling)."""
    nb = min(max_nb, 1 if cu <= 8 else 2 if cu <= 16 else 4)
    sy, sx = -(-hp // PX_ROWS), -(-wp // PX_COLS)
    max_slices = max(1, partial // (4 * k * k * cs * cu))
    best = None
    while nb >= 1:
        for ndy in _tap_rows(k):
            if (-(-ndy * k // 8) > 16 // nb or not _px_tile_fits(k, ndy)
                    or dw_px_smem(k, ndy, nb) > PX_SMEM):
                continue
            base = -(-cs // 16) * -(-k // ndy) * -(-cu // (8 * nb))
            per = max(1, PX_BLOCKS // base)
            spb = max(1, -(-batch * sy * sx // per))
            if max_stages:
                spb = min(spb, max_stages)
            spb = max(spb, -(-batch * sy * sx // max_slices))
            while True:
                if spb >= sx:
                    rows, cols = PX_ROWS * (spb // sx), PX_COLS * sx
                else:
                    rows = PX_ROWS
                    cols = PX_COLS * -(-sx // -(-sx // spb))
                slices = batch * -(-hp // rows) * -(-wp // cols)
                if slices <= max(batch, max_slices):
                    break
                spb += 1
            t = DwPxTiling(rows, cols, ndy, nb, slices, slices * base)
            if 2 * t.blocks >= PX_WAVE:
                return t
            if best is None or t.blocks > best.blocks:
                best = t
        nb //= 2
    if best is None:
        raise ValueError(f"dw_px_tiling: no tiling of k = {k} fits")
    return best


def dw_px_gtap_tiling(k: int, cs: int, cu: int, batch: int, hp: int,
                      wp: int) -> DwPxTiling:
    """conv_dw_px's cotangent-tapped mode (K7: cs = Cout tapped, cu = Cin
    over [Ho + k - 1, Wo + k - 1]): dw_px_tiling with at most PX_GTAP_NB n8
    tiles a block and strips of at most PX_GTAP_STAGES stages within
    PX_GTAP_PARTIAL bytes of partials. Strips as long as dw_px_tiling's
    (38 at up_conv s0, k = 9: 43,000 pixels) put K7 5.7e-5 x max|plain|
    from its plain version, against 3.6e-6 for conv_dw_tc's K7 at k = 5."""
    return dw_px_tiling(k, cs, cu, batch, hp, wp, PX_GTAP_NB, PX_GTAP_STAGES,
                        PX_GTAP_PARTIAL)


def wg_tiles(n: int) -> int:
    """m64 tiles a warpgroup of conv_dw_wg holds at n columns: the
    accumulators (n / 2 registers a tile) and two A fragments (8) within
    168 of a thread's 255 registers, at most 10 (csrc wgdw::tiles_for)."""
    return min(10, 168 // (n // 2 + 8))


def wg_tile_width(k: int) -> int:
    """T's staged width: up to 7 columns of lead, the band and its k - 1
    halo in an odd count of 16-byte units (csrc wgdw::tile_width)."""
    return 8 * (-(-(7 + WG_BAND + k - 1) // 8) | 1)


def wg_ring_rows(k: int, tg: int) -> int:
    """Rows of T's ring: the most tap rows a group of tg consecutive taps
    spans, plus WG_STAGES - 1 (csrc wgdw::ring_rows)."""
    nd = max((min(t0 + tg, k * k) - 1) // k - t0 // k + 1
             for t0 in range(0, k * k, tg))
    return nd + WG_STAGES - 1


def wg_smem(n: int, k: int, tg: int) -> int:
    """Bytes of conv_dw_wg's shared memory: 1 KB to align, U's ring of
    WG_STAGES boxes of n x 64 bf16, T's raw [16][tw] and pixel-major
    [tw][WG_PIXEL] rings of wg_ring_rows rows, the barriers (csrc
    wgdw::smem_bytes)."""
    return (1024 + WG_STAGES * n * 128
            + wg_ring_rows(k, tg) * wg_tile_width(k) * (32 + 2 * WG_PIXEL)
            + 3 * WG_STAGES * 8)


class DwWgTiling(NamedTuple):
    """conv_dw_wg's work split: n columns (an instance of WG_NS) of the
    untapped operand in `chunks` chunks; the k*k taps in `groups` groups of
    tg; the tapped operand's ncg groups of 16 channels; strips of `rows`
    rows of a WG_BAND-pixel band (slices = strips, the partials
    conv_dw_sum_kernel adds); blocks of the grid; tiles (J) a warpgroup
    holds; T's ring rows rt and staged width tw; shared memory; gtap: the
    order it contracts in (True: the cotangent tapped, K7's; False: V
    tapped, K4's; dw_wg_plan picks one for either kernel); stages: the
    image rows all its blocks walk (dw_wg_cost); lead: the columns its
    bands start left of the extent (the kernel's own: -pad mod 8 in the
    cotangent-tapped order, 0 V tapped)."""
    n: int
    chunks: int
    tg: int
    groups: int
    ncg: int
    rows: int
    slices: int
    blocks: int
    tiles: int
    rt: int
    tw: int
    smem: int
    gtap: bool
    stages: int
    lead: int


def dw_wg_tiling(k: int, cs: int, cu: int, batch: int, hp: int,
                 wp: int, lead: int = 0, gtap: bool = False) -> DwWgTiling:
    """How conv_dw_wg splits dw[(t, c), u] = sum_p T[c, p + t] U[u, p] over
    the pixels of [batch, hp, wp] (K4: T = V, cs = Cin, U = g, cu = Cout
    over [Ho, Wo]; K7: T = g tapped with a border of k - 1, cs = Cout, U =
    V, cu = Cin over [Ho + k - 1, Wo + k - 1]): U's cu channels in as few
    evened chunks of at most WG_NS[-1] as it takes, each n = the smallest
    instance that holds it; the taps in as few evened groups as let a
    consumer warpgroup's wg_tiles(n) m64 tiles (8 tiles' taps a block) hold
    them; T's channels in groups of 16; strips of at most WG_CHAIN //
    WG_BAND rows (evened) of WG_BAND-pixel bands, shortened toward WG_FILL
    blocks where the map gives fewer. The bands start `lead` columns left
    of the extent (K7: -pad mod 8, so that each TMA box of U starts on a
    multiple of 8 elements of x; K4: 0)."""
    n8 = -(-cu // 8)
    chunks = -(-n8 // (WG_NS[-1] // 8))
    n = next(v for v in WG_NS if v >= 8 * -(-n8 // chunks))
    tiles = wg_tiles(n)
    groups = -(-k * k // (8 * tiles))
    tg = -(-k * k // groups)
    ncg = -(-cs // 16)
    bands = -(-(wp + lead) // WG_BAND)
    per = ncg * groups * chunks
    n_rs = max(-(-hp // (WG_CHAIN // WG_BAND)),
               min(hp, -(-WG_FILL // (batch * bands * per))))
    rows = -(-hp // n_rs)
    slices = batch * -(-hp // rows) * bands
    return DwWgTiling(n, chunks, tg, groups, ncg, rows, slices,
                      slices * per, tiles, wg_ring_rows(k, tg),
                      wg_tile_width(k), wg_smem(n, k, tg), gtap,
                      per * batch * bands * hp, lead)


def dw_wg_cost(t: DwWgTiling) -> float:
    """A tiling's relative time on the card: the image rows its blocks walk
    (each a fixed cost: barriers, TMA, the transposition), times 1 + 0.139
    a tile + 0.0106 a tile's column (the products): a non-negative fit to
    the 20 plans timed in both orders at up_conv s0-s4, k = 9 and 11
    (`tools/conv_forms.py --dw9`, PERF.md section 6), which ranks 9 of the
    10 pairs right (the tenth 3% apart)."""
    return t.stages * (1 + 0.139 * t.tiles + 0.0106 * t.tiles * t.n)


def dw_wg_plan(k: int, cv: int, cout: int, batch: int, ho: int,
               wo: int, in_w: int) -> DwWgTiling:
    """conv_dw_wg's plan for the weight gradient of a stride-1 conv (V's cv
    channels, Cout, output [batch, ho, wo], x in_w wide): of the two
    contraction orders, which compute the same function, the one
    dw_wg_cost finds cheaper: V tapped (K4's: Cout on N) or the cotangent
    tapped (K7's: Cin on N, over [ho + k - 1, wo + k - 1], its bands
    starting -pad mod 8 columns early, pad = x's border (wo + k - 1 -
    in_w) / 2). This plan is the one _launch_dw_wg launches. At Cout 16
    K4's order issues 3x K7's products; at up_conv s4 (a 56 x 56 map,
    which the lead and the k - 1 halo widen by a band) K7's takes 1.6x K4's
    (PERF.md)."""
    pad = (wo + k - 1 - in_w) // 2
    x_order = dw_wg_tiling(k, cv, cout, batch, ho, wo)
    g_order = dw_wg_tiling(k, cout, cv, batch, ho + k - 1, wo + k - 1,
                           -pad % 8, gtap=True)
    return min((x_order, g_order), key=dw_wg_cost)


def dw_wg_form(k: int, phase: bool, cv: int, cout: int, batch: int, ho: int,
               wo: int, widths: Tuple[int, int]) -> bool:
    """The bf16 K4 / K7 rule for conv_dw_wg (namespace wgdw): stride 1
    (no phase kernel), k >= WG_MIN_K, at least WG_MIN_PIXELS output pixels
    [batch, ho, wo] (cv: V's channels), rows of both operands (`widths`:
    x's and g's W) a multiple of 8 elements, as TMA reads them, and the
    plan it launches (dw_wg_plan) within WG_SMEM and WG_PARTIAL. From the card's times at
    the generator's up_conv sites (`tools/conv_forms.py --dw9`, PERF.md
    section 6; NVIDIA H100 80GB HBM3, 700 W): at k = 9 and 11 the form
    beat conv_dw_px at all five, B = 2 maps of 56-896 pixels (at s4,
    56 x 56 = WG_MIN_PIXELS / 2: 0.145 / 0.192 ms against 0.263 / 0.465;
    at s0 0.85 / 1.22 against 3.66 / 4.8-5.4); no smaller map was timed."""
    if phase or k < WG_MIN_K or batch * ho * wo < WG_MIN_PIXELS or any(
            w % 8 for w in widths):
        return False
    t = dw_wg_plan(k, cv, cout, batch, ho, wo, widths[0])
    return (t.smem <= WG_SMEM
            and 4 * t.slices * k * k * cv * cout <= WG_PARTIAL)


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


class Tf32FwdTiling(NamedTuple):
    """conv_fwd_tf32's work split: nb n8 tiles of Cout a block, in n_co
    chunks of Cout; mt m16 tiles a warp (a stage of TF32_ROWS x 16 mt
    output pixels); the k tap rows in n_dyg groups of ndy; strips of rows x
    cols output pixels; tiles = the strips (the K3''' scratch rows); smem =
    a block's shared memory in bytes."""
    nb: int
    mt: int
    ndy: int
    n_dyg: int
    n_co: int
    rows: int
    cols: int
    tiles: int
    smem: int


class Tf32DwTiling(NamedTuple):
    """conv_dw_tf32's work split: strips of rows x cols pixels (whole
    TF32_DW_ROWS x TF32_DW_COLS stages); cb channels of V a block (all k*k
    taps: M = k*k*cb rows), in m_chunks chunks; nb n8 tiles of Cout a
    block, in n_co chunks; wm warp groups along M; slices = the strips, the
    partials conv_dw_sum_kernel adds; blocks of the grid; smem in bytes."""
    rows: int
    cols: int
    cb: int
    m_chunks: int
    nb: int
    n_co: int
    wm: int
    slices: int
    blocks: int
    smem: int


def tf32_mt(nb: int) -> int:
    """K3's m16 tiles a warp beside nb n8 tiles: at most 64 fp32
    accumulators a thread (csrc tc32::mt_of)."""
    return 4 if nb <= 4 else 2


def tf32_upw(nb: int) -> int:
    """K4's m16 tiles a warp beside nb n8 tiles (csrc tc32::upw_of)."""
    return 4 if nb <= 2 else 3 if nb <= 4 else 2


def tf32_rs(cols: int) -> int:
    """Row stride of a staged tile whose stage reads `cols` columns: the
    lead and whole 16-byte vectors (csrc tc32::tile_rs)."""
    return (TF32_LEAD + cols + 3) // 4 * 4


def tf32_plane(n: int, m: int) -> int:
    """The least plane stride >= n that is 4 mod m (csrc tc32::plane4):
    the four lane groups t of a fragment load land in distinct banks."""
    return n + (4 - n) % m


def fwd_tf32_smem(k: int, ndy: int, nb: int) -> int:
    """Bytes of conv_fwd_tf32's shared memory: V's tile of TF32_CK
    channels split into {hi, lo} pairs and raw, the unit's weights (ndy * k
    taps) as split B fragments and raw, the K3''' slots (csrc
    tc32::FwdLayout)."""
    vr = TF32_ROWS + ndy - 1
    vplane = vr * tf32_rs(16 * tf32_mt(nb) + k - 1)
    ntap = ndy * k
    return 4 * (2 * TF32_CK * tf32_plane(vplane, 16) + 4 * ntap * nb * 32
                + TF32_CK * vplane + ntap * TF32_CK * 8 * nb
                + TF32_WARPS * 2 * 8 * nb)


def dw_tf32_vplane(k: int) -> int:
    """Floats of one channel's plane of conv_dw_tf32's V tile: TF32_DW_ROWS
    + k - 1 rows, 4 mod 32 (csrc tc32::DwLayout)."""
    return tf32_plane((TF32_DW_ROWS + k - 1)
                      * tf32_rs(TF32_DW_COLS + k - 1), 32)


def dw_tf32_smem(k: int, cb: int, nb: int, wm: int,
                 gtap: bool = False) -> int:
    """Bytes of conv_dw_tf32's shared memory: two raw tiles of the tapped
    operand's cb channels (K4's V, K7's g), the untapped operand's raw tile
    (K4's g; K7's V, its rows tf32_rs(TF32_DW_COLS) long for the lead) and
    split planes, or the row groups' sums where they are larger (csrc
    tc32::DwLayout)."""
    urs = tf32_rs(TF32_DW_COLS) if gtap else TF32_DW_COLS
    stage = (2 * cb * dw_tf32_vplane(k)
             + 8 * nb * TF32_DW_ROWS * urs
             + 2 * 8 * nb * TF32_G_PLANE)
    red = 0 if wm == TF32_WARPS else TF32_WARPS * tf32_upw(nb) * 16 * 8 * nb
    return 4 * max(stage, red)


def _n8_chunks(cout: int) -> Tuple[int, int]:
    """Cout's n8 tiles in as few evened chunks of at most TF32_NB: (nb,
    chunks)."""
    n8 = -(-cout // 8)
    n_co = -(-n8 // TF32_NB)
    return -(-n8 // n_co), n_co


def _strips(batch: int, hp: int, wp: int, srows: int, scols: int, per: int,
            max_slices: int = 0) -> Tuple[int, int, int]:
    """Strips of whole srows x scols stages over [batch, hp, wp], about
    `per` of them (full-width where that still gives `per`, else split
    along the columns), and no more than max_slices (if given) unless each
    image is one strip: (rows, cols, strips)."""
    sy, sx = -(-hp // srows), -(-wp // scols)
    spb = max(1, -(-batch * sy * sx // per))      # stages per strip
    while True:
        if spb >= sx:
            rows, cols = srows * (spb // sx), scols * sx
        else:
            rows = srows
            cols = scols * -(-sx // -(-sx // spb))
        strips = batch * -(-hp // rows) * -(-wp // cols)
        if not max_slices or strips <= max(batch, max_slices):
            return rows, cols, strips
        spb += 1


def fwd_tf32_tiling(k: int, cv: int, cout: int, batch: int, ho: int,
                    wo: int) -> Tf32FwdTiling:
    """How conv_fwd_tf32 splits y[co, p] = sum_(t, c) w[t, c, co] V[c, p +
    t] over [batch, ho, wo] outputs: Cout in as few evened chunks of at most
    TF32_NB n8 tiles as it takes; the tap rows in as few groups as let a
    block fit TF32_SMEM (two blocks an SM), else TF32_SMEM_MAX (each group
    restages V's rows with their halo); strips of whole stages toward
    TF32_BLOCKS blocks."""
    nb, n_co = _n8_chunks(cout)
    fits = [d for d in _tap_rows(k)
            if fwd_tf32_smem(k, d, nb) <= TF32_SMEM_MAX]
    if not fits:
        raise ValueError(f"fwd_tf32_tiling: no tiling of k = {k} fits")
    ndy = next((d for d in fits if fwd_tf32_smem(k, d, nb) <= TF32_SMEM),
               fits[0])
    mt = tf32_mt(nb)
    rows, cols, tiles = _strips(batch, ho, wo, TF32_ROWS, 16 * mt,
                                max(1, TF32_BLOCKS // n_co))
    return Tf32FwdTiling(nb, mt, ndy, -(-k // ndy), n_co, rows, cols, tiles,
                         fwd_tf32_smem(k, ndy, nb))


def dw_tf32_tiling(k: int, cs: int, cu: int, batch: int, hp: int,
                   wp: int, gtap: bool = False) -> Tf32DwTiling:
    """How conv_dw_tf32 splits dw[t, c, u] = sum_p S[c, p + t] U[u, p] over
    the pixels of [batch, hp, wp] (K4: S = V, U = g, cs = s*s*Cin, cu =
    Cout over [Ho, Wo]; with gtap K7: S = g tapped with a border of k - 1,
    U = V, cs = Cout, cu = Cin over [Ho + k - 1, Wo + k - 1]): cu in as few
    evened chunks of at most TF32_NB n8 tiles as it takes; S's channels in
    as few evened chunks as let the warps' m16 tiles (8 x tf32_upw(nb))
    hold M = k*k*cb rows and a block fit TF32_SMEM (else TF32_SMEM_MAX);
    wm the fewest warp groups along M that hold them; strips of whole
    stages toward TF32_BLOCKS blocks, their partials within TF32_PARTIAL
    bytes unless each image is one strip."""
    nb, n_co = _n8_chunks(cu)
    upw = tf32_upw(nb)
    cb_max = min(cs, TF32_WARPS * upw * 16 // (k * k))
    if cb_max < 1:
        raise ValueError(f"dw_tf32_tiling: k = {k} has more taps than the "
                         f"warps' tiles hold")
    best = None
    for limit in (TF32_SMEM, TF32_SMEM_MAX):
        for m_chunks in range(-(-cs // cb_max), cs + 1):
            cb = -(-cs // m_chunks)
            tiles = -(-k * k * cb // 16)
            wm = 1
            while wm * upw < tiles:
                wm *= 2
            if dw_tf32_smem(k, cb, nb, wm, gtap) <= limit:
                best = (cb, wm)
                break
        if best:
            break
    if best is None:
        raise ValueError(f"dw_tf32_tiling: no tiling of k = {k} fits")
    cb, wm = best
    m_chunks = -(-cs // cb)
    max_slices = max(1, TF32_PARTIAL // (4 * k * k * cs * cu))
    rows, cols, slices = _strips(batch, hp, wp, TF32_DW_ROWS, TF32_DW_COLS,
                                 max(1, TF32_BLOCKS // (m_chunks * n_co)),
                                 max_slices)
    return Tf32DwTiling(rows, cols, cb, m_chunks, nb, n_co, wm, slices,
                        slices * m_chunks * n_co,
                        dw_tf32_smem(k, cb, nb, wm, gtap))


def _launch_dw_tc(x, g, k, pad, stride, scale, shift, negslope, gtap, t,
                  name):
    """bf16 K4 (gtap False: fp32 [k, k, s*s*Cin, Cout]) or K7 (gtap True,
    stride 1: fp32 [Cin, k*k*Cout], taps not yet reversed) on the
    tensor-core kernel (conv_dw_tc), tiled by t (dw_tc_tiling)."""
    B, cin, h, wd = x.shape
    cout, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    sp, tp, G = _prologue_args(x, scale, shift)
    cs, cu = (cout, cin) if gtap else (stride * stride * cin, cout)
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


def _launch_dw_px(x, g, k, pad, stride, scale, shift, negslope, gtap, t,
                  name):
    """bf16 K4 (gtap False: fp32 [k, k, s*s*Cin, Cout]) or K7 (gtap True,
    stride 1: fp32 [Cin, k*k*Cout], taps not yet reversed) on the
    pixel-major kernel (conv_dw_px), tiled by t (dw_px_tiling)."""
    B, cin, h, wd = x.shape
    cout, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    sp, tp, G = _prologue_args(x, scale, shift)
    cv = stride * stride * cin
    partial = torch.empty(t.slices, k * k * cv * cout, dtype=torch.float32,
                          device=x.device)
    shape = (cin, k * k * cout) if gtap else (k, k, cv, cout)
    dw = torch.empty(shape, dtype=torch.float32, device=x.device)
    fn = _build.library("conv").conv_dw_px
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
        + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    status = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), sp, tp, B, cin, h, wd, cout, ho, wo, k, pad,
                stride, G, float(negslope), int(gtap), t.rows, t.cols, t.ndy,
                t.nb, _build.stream_ptr(x.device))
    _build.check(status, name)
    return dw


def _launch_dw_wg(x, g, k, pad, stride, scale, shift, negslope, gtap, t,
                  name):
    """bf16 K4 or K7 (the same function: fp32 [k, k, Cin, Cout]) at stride
    1 on conv_dw_wg (wgmma; TMA reads x and g) in the order t (dw_wg_plan or
    dw_wg_tiling) contracts in, t.gtap, whichever kernel gtap names. Raises
    ValueError for an operand that is not 16-byte aligned (a contiguous
    view at an odd offset), which TMA cannot read: it is never copied; and
    for a tiling whose bands' lead is not the kernel's (-pad mod 8 in the
    cotangent-tapped order, else 0), whose partials would not fit."""
    B, cin, h, wd = x.shape
    cout, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    if stride != 1 or x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"{name}: conv_dw_wg reads stride-1, 16-byte "
                         f"aligned operands by TMA")
    gtap = t.gtap
    if t.lead != (-pad % 8 if gtap else 0):
        raise ValueError(f"{name}: conv_dw_wg's tiling has lead {t.lead}, "
                         f"the kernel's border {pad} another")
    sp, tp, G = _prologue_args(x, scale, shift)
    partial = torch.empty(t.slices, k * k * cin * cout, dtype=torch.float32,
                          device=x.device)
    shape = (cin, k * k * cout) if gtap else (k, k, cin, cout)
    dw = torch.empty(shape, dtype=torch.float32, device=x.device)
    fn = _build.library("conv").conv_dw_wg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    status = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), sp, tp, B, cin, h, wd, cout, ho, wo, k, pad,
                G, float(negslope), int(gtap), t.n, t.tg, t.rows,
                _build.stream_ptr(x.device))
    _build.check(status, name)
    return _reverse_taps(dw, k) if gtap else dw


def dw_wg_info(t: DwWgTiling, k: int) -> dict:
    """What the card makes of conv_dw_wg's instance for tiling t at k
    (csrc conv_dw_wg_info): threads, stages, shared memory bytes, blocks an
    SM, registers a thread, local bytes a thread, tiles a consumer
    warpgroup holds."""
    fn = _build.library("conv").conv_dw_wg_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 7)()
    _build.check(fn(t.n, k, t.tg, out), "conv_dw_wg_info")
    return dict(zip(("threads", "stages", "smem", "blocks_per_sm",
                     "registers", "local_bytes", "tiles"), out))


def _launch_dw_tf32(x, g, k, pad, stride, scale, shift, negslope, gtap, t,
                    name):
    """fp32 K4 (gtap False: fp32 [k, k, s*s*Cin, Cout]) or K7 (gtap True,
    stride 1: fp32 [Cin, k*k*Cout], taps not yet reversed) on the tensor
    cores in split TF32 (conv_dw_tf32), tiled by t (dw_tf32_tiling)."""
    B, cin, h, wd = x.shape
    cout, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    sp, tp, G = _prologue_args(x, scale, shift)
    cv = stride * stride * cin
    partial = torch.empty(t.slices, k * k * cv * cout, dtype=torch.float32,
                          device=x.device)
    shape = (cin, k * k * cout) if gtap else (k, k, cv, cout)
    dw = torch.empty(shape, dtype=torch.float32, device=x.device)
    fn = _build.library("conv").conv_dw_tf32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
        + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    status = fn(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), sp, tp, B, cin, h, wd, cout, ho, wo, k, pad,
                stride, G, float(negslope), int(gtap), t.rows, t.cols, t.cb,
                t.nb, t.wm, _build.stream_ptr(x.device))
    _build.check(status, name)
    return dw


def _dw_route(x, g, k, stride, gtap: bool = False) -> ConvRoute:
    """conv_route's choice for the weight gradient of x [B, Cin, H, W]
    against the cotangent g."""
    return conv_route("dw", x.dtype, k, stride, stride * stride * x.shape[1],
                      g.shape[1], g.shape[0], g.shape[2], g.shape[3],
                      gtap=gtap, in_w=x.shape[3])


def _launch_dw(x, g, k, pad, stride, scale, shift, negslope, name,
               gtap: bool = False):
    """The weight gradient over the virtual input of x on the kernel that
    conv_route names: fp32 [k, k, s*s*Cin, Cout]; g must be in x's type.
    K4, or with gtap (stride 1, k >= 2) K7 (its taps reversed here); bf16
    on the tensor cores, fp32 too (split TF32)."""
    x, g = x.contiguous(), g.contiguous()
    _build.check_cuda_tensors(name, x, g)
    if g.shape[0] != x.shape[0] or stride not in (1, 2) or (
            gtap and stride != 1):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} vs input "
                         f"{tuple(x.shape)}, stride {stride}")
    route = _dw_route(x, g, k, stride, gtap)
    args = (x, g, k, pad, stride, scale, shift, negslope)
    gtap = route.kernel == "K7"
    launch = {"px": _launch_dw_px, "tc": _launch_dw_tc, "wg": _launch_dw_wg,
              "tf32": _launch_dw_tf32}[route.form]
    dw = launch(*args, gtap, route.tiling, name)
    # conv_dw_wg returns [k, k, Cin, Cout] in either order
    return _reverse_taps(dw, k) if gtap and route.form != "wg" else dw


def _same_pad(w: torch.Tensor, name: str) -> int:
    """The SAME border (k-1)//2 of w's odd k > 1; raises otherwise."""
    k = w.shape[0]
    if k % 2 == 0 or k < 3:
        raise ValueError(f"{name}: SAME needs an odd k > 1, got {k}")
    return (k - 1) // 2


def conv_same_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3'' SAME on the card: the conv with the zero border (k-1)//2. w must
    already be in x's type. Every launch runs on the tensor cores (bf16,
    and fp32 in split TF32) and also counts in tc_launches (as in every K3
    and K4 wrapper below)."""
    pad = _same_pad(w, "conv_same")
    y = _launch_fwd(x, w, _out_hw(x, w.shape[0], pad), pad, 1, None, None,
                    1.0, "conv_same")
    conv_same_cuda.launches += 1
    conv_same_cuda.tc_launches += 1
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
    conv_same_pro_cuda.tc_launches += 1
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
    conv_same_pro_stats_cuda.tc_launches += 1
    return y, st[:, 0], st[:, 1]


conv_same_pro_stats_cuda.launches = 0
conv_same_pro_stats_cuda.tc_launches = 0


def conv_dw_gtap_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None,
                      negslope: float = 1.0, pad: int = 0) -> torch.Tensor:
    """K7 on the card: fp32 [k, k, Cin, Cout] by tapping the cotangent; pad
    (k-1)//2 is SAME, pad 0 on a padded x VALID. g must be in x's type.
    Any k >= 2 (at k = 1 conv_route runs K4, the same function). Every
    launch runs on the tensor cores (bf16, and fp32 in split TF32) and also
    counts in tc_launches."""
    dw = _launch_dw(x, g, k, pad, 1, scale, shift, negslope, "conv_dw_gtap",
                    gtap=True)
    conv_dw_gtap_cuda.launches += 1
    conv_dw_gtap_cuda.tc_launches += 1
    return dw


conv_dw_gtap_cuda.launches = 0
conv_dw_gtap_cuda.tc_launches = 0


def conv_valid_cuda(x: torch.Tensor, w: torch.Tensor, pad: int = 0,
                    phase: bool = False) -> torch.Tensor:
    """K3 on the card: VALID stride-1 conv with an implicit zero border
    (phase: w is a stride-2 phase kernel, as in the s2d conv's input
    gradient). w must already be in x's type."""
    y = _launch_fwd(x, w, _out_hw(x, w.shape[0], pad), pad, 1, None, None,
                    1.0, "conv_valid", phase=phase)
    conv_valid_cuda.launches += 1
    conv_valid_cuda.tc_launches += 1
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
    conv_valid_pro_cuda.tc_launches += 1
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
    conv_valid_s2d_cuda.tc_launches += 1
    return y


conv_valid_s2d_cuda.launches = 0
conv_valid_s2d_cuda.tc_launches = 0


def conv_dw_cuda(xp: torch.Tensor, g: torch.Tensor, k: int,
                 pad: int = 0) -> torch.Tensor:
    """K4 on the card: fp32 [k, k, Cin, Cout]; g must be in xp's type."""
    dw = _launch_dw(xp, g, k, pad, 1, None, None, 1.0, "conv_dw")
    conv_dw_cuda.launches += 1
    conv_dw_cuda.tc_launches += 1
    return dw


conv_dw_cuda.launches = 0
conv_dw_cuda.tc_launches = 0


def conv_dw_pro_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                     scale: torch.Tensor, shift: torch.Tensor,
                     negslope: float = 1.0, pad: int = 0,
                     stride: int = 1) -> torch.Tensor:
    """K4' pro on the card: dw of the pro conv, the prologue recomputed on
    the read."""
    dw = _launch_dw(x, g, k, pad, stride, scale, shift, negslope,
                    "conv_dw_pro")
    conv_dw_pro_cuda.launches += 1
    conv_dw_pro_cuda.tc_launches += 1
    return dw


conv_dw_pro_cuda.launches = 0
conv_dw_pro_cuda.tc_launches = 0


def conv_dw_s2d_cuda(x: torch.Tensor, g: torch.Tensor, k: int,
                     pad: int) -> torch.Tensor:
    """K4 at k2 on the card: dw [k2, k2, 4Cin, Cout] of the s2d conv."""
    dw = _launch_dw(x, g, k, pad, 2, None, None, 1.0, "conv_dw_s2d")
    conv_dw_s2d_cuda.launches += 1
    conv_dw_s2d_cuda.tc_launches += 1
    return dw


conv_dw_s2d_cuda.launches = 0
conv_dw_s2d_cuda.tc_launches = 0


def conv_forward(x, w, scale=None, shift=None, negslope: float = 1.0,
                 pad: int = 0, stride: int = 1,
                 out_hw: Optional[Tuple[int, int]] = None, same: bool = False,
                 want_stats: bool = False, phase: bool = False):
    """K3 for a CUDA tensor, in the form the arguments ask for: with `same`
    (stride 1, pad (k-1)//2) K3'' SAME, pro when scale is given, K3''' with
    want_stats (then (out, s1, s2)); else pro when scale is given, s2d at
    stride 2, plain (phase: w is a phase kernel read at stride 1). The
    plain version for a CPU tensor."""
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
    return conv_valid_cuda(x, w, pad, phase)


def conv_weight_grad(x, g, k: int, scale=None, shift=None,
                     negslope: float = 1.0, pad: int = 0, stride: int = 1,
                     same: bool = False):
    """K4 for a CUDA tensor, in the form of conv_forward; with `same`, K7
    where the reference's _dw_impl (:647) routes it (DW_TAP_ON_N and
    _gtap_better(k, Cin, Cout)), at any k. The plain version for a CPU
    tensor. fp32 [k, k, s*s*Cin, Cout]."""
    g = g.to(x.dtype)
    if not x.is_cuda:
        if same and DW_TAP_ON_N and _gtap_better(k, x.shape[1], g.shape[1]):
            return conv_dw_gtap_plain(x, g, k, scale, shift, negslope, pad)
        return conv_dw_pro_plain(x, g, k, scale, shift, negslope, pad, stride)
    route = conv_route("dw", x.dtype, k, stride, stride * stride * x.shape[1],
                       g.shape[1], g.shape[0], g.shape[2], g.shape[3],
                       same=same, in_w=x.shape[3])
    if route.kernel == "K7":
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
                dz = _from_phases(conv_forward(g, w_flip, pad=k - 1,
                                               phase=True), x.shape, pad)
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
