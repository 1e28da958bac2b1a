"""Multi-head attention read straight from the fused qkv projection.

Port of splice_tpu/ops/attention.py:79-101,584-660. qkv is [B, N, 3D] laid
out q | k | v with heads contiguous inside each section; the output is the
head-concatenated [B, N, D] the proj dense consumes.

On CUDA tensors the forward is kernel K1 and the backward kernel K2
(csrc/attention.cu, replacing the TPU kernels _attn_qkv_kernel and
_attn_qkv_bwd_kernel). On CPU tensors the same two functions run their plain
PyTorch versions below, which repeat the kernels' arithmetic. A CUDA tensor
launches the kernel or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from splice_tpu_torch.ops import _build

HEAD_DIM = 64


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the card's comparison)
# ---------------------------------------------------------------------------

def _split_heads(qkv: torch.Tensor, num_heads: int):
    B, N, threeD = qkv.shape
    dh = threeD // 3 // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    return q, k, v                                     # each [B, H, N, dh]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, N, H * dh)


def _probs(q, k, scale: float, n_valid: int):
    """Unnormalised fp32 probabilities and their row sums (keys >= n_valid
    masked by a -1e30 bias, as the reference does)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    N = k.shape[2]
    if 0 < n_valid < N:
        bias = torch.zeros(N, dtype=torch.float32, device=q.device)
        bias[n_valid:] = -1e30
        logits = logits + bias
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e, e.sum(dim=-1, keepdim=True)


def attention_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                        n_valid: int = 0) -> torch.Tensor:
    """Forward: fp32 logits and softmax, p rounded to the input type before
    the PV product, the division after it; output in the input type."""
    q, k, v = _split_heads(qkv, num_heads)
    e, denom = _probs(q, k, scale, n_valid)
    o = torch.einsum("bhqk,bhkd->bhqd", e.to(qkv.dtype).float(), v.float())
    return _merge_heads(o / denom).to(qkv.dtype)


def attention_qkv_bwd_plain(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int, scale: float,
                            n_valid: int = 0) -> torch.Tensor:
    """Backward from qkv alone: recompute p; dp = g v^T; dl = p (dp - sum
    p dp), cast to the input type before the dq and dk products; one
    [B, N, 3D] cotangent in the input type."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    B, H, N, dh = q.shape
    gh = g.reshape(B, N, H, dh).permute(0, 2, 1, 3).float()
    e, denom = _probs(q, k, scale, n_valid)
    p = e / denom
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, v.float())
    dl = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dl_c = dl.to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dl_c, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dl_c, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), gh)
    return torch.cat([_merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _shape(qkv: torch.Tensor, num_heads: int, n_valid: int):
    B, N, threeD = qkv.shape
    if threeD % 3 or (threeD // 3) != num_heads * HEAD_DIM:
        raise ValueError(f"attention kernels need head dim {HEAD_DIM}: "
                         f"qkv width {threeD}, {num_heads} heads")
    valid = n_valid if 0 < n_valid <= N else N
    return B, N, valid


def attn_qkv_fwd_cuda(qkv: torch.Tensor, num_heads: int, scale: float,
                      n_valid: int = 0) -> torch.Tensor:
    """K1 on the card: [B, N, 3D] -> [B, N, D]."""
    dtype = _build.check_cuda_tensors("attn_qkv_fwd", qkv)
    B, N, valid = _shape(qkv, num_heads, n_valid)
    out = torch.empty(B, N, qkv.shape[2] // 3, dtype=qkv.dtype,
                      device=qkv.device)
    lib = _build.library("attention")
    fn = lib.attn_qkv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(qkv.data_ptr(), out.data_ptr(), B, N, num_heads, valid,
                float(scale), dtype, _build.stream_ptr(qkv.device))
    _build.check(status, "attn_qkv_fwd")
    attn_qkv_fwd_cuda.launches += 1
    return out


attn_qkv_fwd_cuda.launches = 0


def attn_qkv_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                      scale: float, n_valid: int = 0) -> torch.Tensor:
    """K2 on the card: (qkv [B,N,3D], g [B,N,D]) -> dqkv [B,N,3D]. Three
    launches (row statistics, dk/dv, dq) counted as one call."""
    g = g.to(qkv.dtype).contiguous()
    dtype = _build.check_cuda_tensors("attn_qkv_bwd", qkv, g)
    B, N, valid = _shape(qkv, num_heads, n_valid)
    dqkv = torch.empty_like(qkv)
    lse = torch.empty(B, num_heads, N, dtype=torch.float32,
                      device=qkv.device)
    delta = torch.empty_like(lse)
    lib = _build.library("attention")
    fn = lib.attn_qkv_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), B, N, num_heads, valid,
                float(scale), dtype, _build.stream_ptr(qkv.device))
    _build.check(status, "attn_qkv_bwd")
    attn_qkv_bwd_cuda.launches += 1
    return dqkv


attn_qkv_bwd_cuda.launches = 0


def attn_qkv_fwd(qkv, num_heads: int, scale: float, n_valid: int = 0):
    """K1 for a CUDA tensor, its plain version for a CPU tensor."""
    if qkv.is_cuda:
        return attn_qkv_fwd_cuda(qkv, num_heads, scale, n_valid)
    return attention_qkv_plain(qkv, num_heads, scale, n_valid)


def attn_qkv_bwd(qkv, g, num_heads: int, scale: float, n_valid: int = 0):
    """K2 for a CUDA tensor, its plain version for a CPU tensor."""
    if qkv.is_cuda:
        return attn_qkv_bwd_cuda(qkv, g, num_heads, scale, n_valid)
    return attention_qkv_bwd_plain(qkv, g, num_heads, scale, n_valid)


class AttnQKV(torch.autograd.Function):
    """Attention from fused qkv; saves only qkv for the backward, as the
    reference's custom VJP does (splice_tpu/ops/attention.py:584-598)."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float, n_valid: int):
        qkv = qkv.contiguous()
        ctx.save_for_backward(qkv)
        ctx.cfg = (num_heads, scale, n_valid)
        return attn_qkv_fwd(qkv, num_heads, scale, n_valid)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return attn_qkv_bwd(qkv, g, *ctx.cfg), None, None, None


def attention_from_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                       n_valid: int = 0) -> torch.Tensor:
    """[B, N, 3D] -> [B, N, D] softmax attention (differentiable)."""
    return AttnQKV.apply(qkv, num_heads, float(scale), int(n_valid))
