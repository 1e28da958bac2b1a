"""Small-channel stride-1 convolution in [B, C, H, W] layout.

Port of splice_tpu/ops/conv_pallas.py:706-732 (conv_valid_chw and its
custom VJP) and :1007-1065 (pallas_conv_chw, stride 1). On CUDA tensors the
VALID conv and its input gradient are kernel K3 and the weight gradient is
kernel K4 (csrc/conv.cu, replacing _make_conv_kernel and _make_dw_kernel).
On CPU tensors the same functions run their plain PyTorch versions below.
A CUDA tensor launches the kernel or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from splice_tpu_torch.ops import _build

# K4 splits the output rows of all images into about this many chunks
# (pass 1), then adds the chunks' partial sums in order (pass 2).
_DW_CHUNKS = 256
_DW_ROW_TILE = 4          # rows per shared-memory tile in K4 (csrc DR)


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
    xf, wf = x.float(), w.float()
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
    xf, gf = xp.float(), g.float()
    return torch.stack([
        torch.stack([torch.einsum("bihw,bohw->io",
                                  xf[:, :, dy:dy + ho, dx:dx + wo], gf)
                     for dx in range(k)])
        for dy in range(k)])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def conv_valid_cuda(x: torch.Tensor, w: torch.Tensor,
                    pad: int = 0) -> torch.Tensor:
    """K3 on the card. w must already be in x's type."""
    x, w = x.contiguous(), w.contiguous()
    dtype = _build.check_cuda_tensors("conv_valid", x, w)
    B, cin, h, wd = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != cin:
        raise ValueError(f"conv_valid: kernel {tuple(w.shape)} vs input "
                         f"{tuple(x.shape)}")
    ho, wo = h + 2 * pad - k + 1, wd + 2 * pad - k + 1
    y = torch.empty(B, cout, ho, wo, dtype=x.dtype, device=x.device)
    fn = _build.library("conv").conv_valid_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    status = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, cin, h, wd,
                cout, k, pad, dtype, _build.stream_ptr(x.device))
    _build.check(status, "conv_valid")
    conv_valid_cuda.launches += 1
    return y


conv_valid_cuda.launches = 0


def conv_dw_cuda(xp: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """K4 on the card: fp32 [k, k, Cin, Cout]; g must be in xp's type."""
    xp, g = xp.contiguous(), g.contiguous()
    dtype = _build.check_cuda_tensors("conv_dw", xp, g)
    if k not in (1, 3):
        raise ValueError(f"conv_dw kernel is built for k in (1, 3), got {k}")
    B, cin, hp, wp = xp.shape
    cout, ho = g.shape[1], g.shape[2]
    if g.shape != (B, cout, hp - k + 1, wp - k + 1):
        raise ValueError(f"conv_dw: cotangent {tuple(g.shape)} vs input "
                         f"{tuple(xp.shape)}, k={k}")
    rows = -(-B * ho // _DW_CHUNKS)
    rows = -(-rows // _DW_ROW_TILE) * _DW_ROW_TILE
    n_chunks = B * -(-ho // rows)
    partial = torch.empty(n_chunks, k * k * cin * cout, dtype=torch.float32,
                          device=xp.device)
    dw = torch.empty(k, k, cin, cout, dtype=torch.float32, device=xp.device)
    fn = _build.library("conv").conv_dw
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    status = fn(xp.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), B, cin, hp, wp, cout, k, rows, dtype,
                _build.stream_ptr(xp.device))
    _build.check(status, "conv_dw")
    conv_dw_cuda.launches += 1
    return dw


conv_dw_cuda.launches = 0


def conv_valid(x, w, pad: int = 0):
    """K3 for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return conv_valid_cuda(x, w.to(x.dtype), pad)
    return conv_valid_plain(x, w.to(x.dtype), pad)


def conv_dw(xp, g, k: int):
    """K4 for a CUDA tensor, its plain version for a CPU tensor."""
    if xp.is_cuda:
        return conv_dw_cuda(xp, g.to(xp.dtype), k)
    return conv_dw_plain(xp, g.to(xp.dtype), k)


class ConvValid(torch.autograd.Function):
    """VALID conv whose backward is K3 (dx) and K4 (dw), as the reference's
    custom VJP (splice_tpu/ops/conv_pallas.py:715-732)."""

    @staticmethod
    def forward(ctx, xp, w):
        ctx.save_for_backward(xp, w)
        return conv_valid(xp, w.to(xp.dtype))

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        k = w.shape[0]
        g = g.to(xp.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # full correlation of g with the flipped, io-swapped kernel
            w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3)
            dx = conv_valid(g, w_flip.to(xp.dtype), pad=k - 1)
        if ctx.needs_input_grad[1]:
            dw = conv_dw(xp, g, k).to(w.dtype)
        return dx, dw


def conv_valid_chw(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID k x k stride-1 conv on pre-padded [B, Cin, Hp, Wp] with
    w [k, k, Cin, Cout] -> [B, Cout, Hp-k+1, Wp-k+1] (differentiable)."""
    return ConvValid.apply(xp, w)


def kernel_conv_chw(x: torch.Tensor, p: dict,
                    pad: str = "zero") -> torch.Tensor:
    """Stride-1 counterpart of pallas_conv_chw: torch (k-1)//2 zero or
    reflection padding, the VALID conv, then the bias (added outside the
    kernel, as the reference does)."""
    w = p["kernel"]
    to_pad = (w.shape[0] - 1) // 2
    if to_pad > 0:
        mode = "reflect" if pad == "reflection" else "constant"
        x = F.pad(x, (to_pad, to_pad, to_pad, to_pad), mode=mode)
    out = conv_valid_chw(x, w)
    if "bias" in p:
        out = out + p["bias"].to(out.dtype)[:, None, None]
    return out
