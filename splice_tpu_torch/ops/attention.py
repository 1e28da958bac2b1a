"""Multi-head softmax attention for the frozen ViT.

Port of splice_tpu/ops/attention.py:79-321,584-690. Two routes, chosen as
the reference chooses them (attention_from_qkv):

  * fused qkv: qkv is [B, N, 3D] laid out q | k | v with heads contiguous
    inside each section; the output is the head-concatenated [B, N, D] the
    proj dense consumes. Forward kernel K1, backward K2 (replacing
    _attn_qkv_kernel and _attn_qkv_bwd_kernel). Taken while
    qkv_attention_supported, i.e. up to the reference's _QKV_MAX_N_PAD;
  * split tensors: above that cap (the 480-px loss resolution: 3601 tokens
    per square crop, 2701 for the entire A image), and at head widths the
    fused route does not take, the heads are split into [B, H, N, dh] q, k,
    v and multi_head_attention runs forward kernel K5 and backward K6
    (replacing _attn_kernel and _attn_bwd_kernel) at every dh % 64 == 0,
    as the reference's pallas_attention_supported; dh = 64 on the kernels
    K1/K2 share; wider heads on K5's and K6's wide passes (csrc fwd_wide
    and bwd_wide: a block over the full width, so S (and dP) are computed
    once per tile; the own rows resident up to dh = 256 (K5) and 320 (K6),
    streamed by 64-column boxes above, in column blocks of 128 to 256).

All four kernels are in csrc/attention.cu and run on the tensor cores,
each through one set of kernels for both layouts: bf16 through wgmma,
fp32 through mma.sync TF32 products in three terms (split TF32: hi*lo +
lo*hi + hi*hi of each operand's two TF32 halves, close to fp32 but not
bitwise fp32; a route by dtype, not a fallback). On CPU tensors the same
functions run their plain PyTorch versions below, which repeat the
kernels' arithmetic. A CUDA tensor launches the kernel or raises; there is
no fallback: a tensor at an address that the kernels' copies (TMA for
bf16, cp.async for fp32) cannot use (check_tma_operands) is refused, not
copied.

use_pallas=False (the config key use_pallas_attention, the reference's XLA
ablation) takes neither kernel pair: both routes go through
library_attention, PyTorch's scaled_dot_product_attention on CUDA tensors
and the reference's XLA arithmetic (xla_attention_plain) on CPU tensors.
It is a user's switch, off by default, not a fallback.

Deviation from the reference, by design: above _MAX_N_PAD the reference
leaves K5 for XLA attention, because its kernel keeps a whole head's K/V in
VMEM. K5 is flash-style and has no length cap, so the port runs it at every
N (pallas_attention_supported mirrors the reference's predicate and routes
nothing). The reference's bf16-only gate (_kernel_dtype_ok) is a Mosaic
VMEM budget and is not carried over: the kernels take fp32 too.
"""
from __future__ import annotations

import ctypes

import torch

from splice_tpu_torch.ops import _build

HEAD_DIM = 64
# the wide passes by the kind code of csrc attn_bwd_plan and attn_fwd_plan
# (PASS_*): K6's, then K5's
WIDE_PASSES = ("stats", "dq", "dkdv", "dv", "dk", "fwd")
# the values of one launch in those plans' rows, after the kind
PLAN_KEYS = ("w", "col", "threads", "stages", "smem", "blocks_per_sm",
             "rows", "keys", "kernel")
# The reference's routing constants (splice_tpu/ops/attention.py:45,607).
_QKV_MAX_N_PAD = 2048
_MAX_N_PAD = 4096


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


def attention_plain(q, k, v, scale: float, n_valid: int = 0) -> torch.Tensor:
    """K5's plain version on [B, H, N, dh] q, k, v: fp32 logits and
    softmax, p rounded to v's type before the PV product, the division
    after it; output in q's type."""
    e, denom = _probs(q, k, scale, n_valid)
    o = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(), v.float())
    return (o / denom).to(q.dtype)


def attention_bwd_plain(q, k, v, g, scale: float, n_valid: int = 0):
    """K6's plain version: recompute p; dp = g v^T; dl = p (dp - sum p dp),
    cast to the input type before the dq and dk products; (dq, dk, dv) in
    the inputs' type."""
    dt = q.dtype
    gf = g.float()
    e, denom = _probs(q, k, scale, n_valid)
    p = e / denom
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    dl = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dl_c = dl.to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dl_c, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dl_c, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), gf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                        n_valid: int = 0) -> torch.Tensor:
    """K1's plain version: K5's arithmetic on the heads of the fused
    [B, N, 3D] qkv; [B, N, D] output in the input type."""
    return _merge_heads(attention_plain(*_split_heads(qkv, num_heads),
                                        scale, n_valid))


def attention_qkv_bwd_plain(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int, scale: float,
                            n_valid: int = 0) -> torch.Tensor:
    """K2's plain version: K6's arithmetic from qkv alone; one [B, N, 3D]
    cotangent in the input type."""
    q, k, v = _split_heads(qkv, num_heads)
    B, H, N, dh = q.shape
    gh = g.to(qkv.dtype).reshape(B, N, H, dh).permute(0, 2, 1, 3)
    return torch.cat([_merge_heads(t) for t in
                      attention_bwd_plain(q, k, v, gh, scale, n_valid)],
                     dim=-1)


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


def check_tma_operands(name: str, *ts: torch.Tensor) -> None:
    """The rule of the kernels' 16-byte copies (TMA for bf16, cp.async for
    fp32) for the tensors they read and write: each address 16-byte
    aligned (a contiguous view can start anywhere in its storage). Their
    strides need no check: the wrappers take contiguous tensors only, and
    a head width that is a multiple of 64 makes every stride but the
    last a multiple of 128 bytes.
    Raises ValueError; the kernels never copy a tensor to an address they
    can read."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: the tensor-core kernels need 16-byte aligned "
                f"tensors; got address {t.data_ptr():#x}")


def attn_qkv_fwd_cuda(qkv: torch.Tensor, num_heads: int, scale: float,
                      n_valid: int = 0) -> torch.Tensor:
    """K1 on the card: [B, N, 3D] -> [B, N, D], bf16 or fp32 (split TF32),
    on the tensor cores (also counted in tc_launches)."""
    dtype = _build.check_cuda_tensors("attn_qkv_fwd", qkv)
    B, N, valid = _shape(qkv, num_heads, n_valid)
    out = torch.empty(B, N, qkv.shape[2] // 3, dtype=qkv.dtype,
                      device=qkv.device)
    check_tma_operands("attn_qkv_fwd", qkv, out)
    fn = _build.library("attention").attn_qkv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(qkv.data_ptr(), out.data_ptr(), B, N, num_heads, valid,
                float(scale), dtype, _build.stream_ptr(qkv.device))
    _build.check(status, "attn_qkv_fwd")
    attn_qkv_fwd_cuda.launches += 1
    attn_qkv_fwd_cuda.tc_launches += 1
    return out


attn_qkv_fwd_cuda.launches = 0
attn_qkv_fwd_cuda.tc_launches = 0


def attn_qkv_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                      scale: float, n_valid: int = 0) -> torch.Tensor:
    """K2 on the card: (qkv [B,N,3D], g [B,N,D]) -> dqkv [B,N,3D]. Three
    launches (row statistics, dk/dv, dq) counted as one call; bf16 and fp32
    (split TF32) on the tensor cores (also counted in tc_launches)."""
    g = g.to(qkv.dtype).contiguous()
    dtype = _build.check_cuda_tensors("attn_qkv_bwd", qkv, g)
    B, N, valid = _shape(qkv, num_heads, n_valid)
    dqkv = torch.empty_like(qkv)
    check_tma_operands("attn_qkv_bwd", qkv, g, dqkv)
    lse = torch.empty(B, num_heads, N, dtype=torch.float32,
                      device=qkv.device)
    delta = torch.empty_like(lse)
    fn = _build.library("attention").attn_qkv_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), B, N, num_heads, valid,
                float(scale), dtype, _build.stream_ptr(qkv.device))
    _build.check(status, "attn_qkv_bwd")
    attn_qkv_bwd_cuda.launches += 1
    attn_qkv_bwd_cuda.tc_launches += 1
    return dqkv


attn_qkv_bwd_cuda.launches = 0
attn_qkv_bwd_cuda.tc_launches = 0


def _split_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 n_valid: int):
    B, H, N, dh = q.shape
    if dh % HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention kernels need [B, H, N, dh] q, k, v of "
                         f"one shape, dh a multiple of {HEAD_DIM}; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    valid = n_valid if 0 < n_valid <= N else N
    return B, H, N, dh, valid


def attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, n_valid: int = 0) -> torch.Tensor:
    """K5 on the card: [B, H, N, dh] q, k, v -> [B, H, N, dh] (dh a
    multiple of 64; above 64 the launches of wide_fwd_plan: one, or a
    column block of 128 to 256 columns each from dh = 320) counted as one
    call; bf16 or fp32 (split TF32), on the tensor cores (also counted in
    tc_launches)."""
    B, H, N, dh, valid = _split_shape(q, k, v, n_valid)
    dtype = _build.check_cuda_tensors("attn_fwd", q, k, v)
    out = torch.empty_like(q)
    check_tma_operands("attn_fwd", q, k, v, out)
    fn = _build.library("attention").attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                N, H, dh, valid, float(scale), dtype,
                _build.stream_ptr(q.device))
    _build.check(status, "attn_fwd")
    attn_fwd_cuda.launches += 1
    attn_fwd_cuda.tc_launches += 1
    return out


attn_fwd_cuda.launches = 0
attn_fwd_cuda.tc_launches = 0


def attn_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, scale: float, n_valid: int = 0):
    """K6 on the card: (q, k, v, g), each [B, H, N, dh] (dh a multiple of
    64) -> (dq, dk, dv) in the inputs' type. Three launches (row
    statistics, dk/dv, dq; above dh = 64 the wide passes of wide_bwd_plan:
    dk and dv apart from dh = 192, a column block of 128 to 256 columns
    each from dh = 320) counted as one call; bf16 and fp32 (split TF32) on
    the tensor cores (also counted in tc_launches)."""
    B, H, N, dh, valid = _split_shape(q, k, v, n_valid)
    if g.shape != q.shape:
        raise ValueError(f"attn_bwd: cotangent {tuple(g.shape)} vs "
                         f"{tuple(q.shape)}")
    g = g.to(q.dtype).contiguous()
    dtype = _build.check_cuda_tensors("attn_bwd", q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    check_tma_operands("attn_bwd", q, k, v, g, dq, dk, dv)
    lse = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = _build.library("attention").attn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), B, N, H, dh, valid, float(scale), dtype,
                _build.stream_ptr(q.device))
    _build.check(status, "attn_bwd")
    attn_bwd_cuda.launches += 1
    attn_bwd_cuda.tc_launches += 1
    return dq, dk, dv


attn_bwd_cuda.launches = 0
attn_bwd_cuda.tc_launches = 0


def _plan(entry: str, dh: int, dtype: torch.dtype) -> list:
    """The launches of csrc `entry` (attn_bwd_plan or attn_fwd_plan) at
    head width dh in `dtype`, each a dict of its kind and PLAN_KEYS."""
    code = _build.DTYPES[str(dtype).removeprefix("torch.")]
    fn = getattr(_build.library("attention"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    n = fn(dh, code, None, 0)
    w = 1 + len(PLAN_KEYS)
    rows = (ctypes.c_longlong * (w * max(n, 0)))()
    if n > 0:
        n = fn(dh, code, ctypes.addressof(rows), n)
    if n < 0:
        _build.check(-n, entry)
    return [dict(kind=WIDE_PASSES[rows[w * i]],
                 **dict(zip(PLAN_KEYS, rows[w * i + 1:w * i + w])))
            for i in range(n)]


def wide_bwd_plan(dh: int, dtype: torch.dtype) -> list:
    """K6's launches at head width dh > 64 in `dtype` on the card (csrc
    attn_bwd_plan), in order: each a dict of the pass ("stats", "dq",
    "dkdv", "dv", "dk"), its output width W (0 for the statistics) and
    first output column, its threads, ring stages, dynamic shared memory
    in bytes, the blocks an SM the runtime reports, the own rows a block
    and the rows of a streamed tile, and its kernel's address (one per
    template instance). Empty where dh is not a wide head."""
    return _plan("attn_bwd_plan", dh, dtype)


def wide_fwd_plan(dh: int, dtype: torch.dtype) -> list:
    """K5's launches at head width dh > 64 in `dtype` on the card (csrc
    attn_fwd_plan), in order: each a dict as wide_bwd_plan's, of kind
    "fwd": one launch of W = dh up to dh = 256, ceil(dh / 256) column
    blocks of 128 to 256 columns above; "rows" the q rows a block, "keys"
    the key tile. Empty where dh is not a wide head."""
    return _plan("attn_fwd_plan", dh, dtype)


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


def attn_fwd(q, k, v, scale: float, n_valid: int = 0):
    """K5 for CUDA tensors, its plain version for CPU tensors."""
    if q.is_cuda:
        return attn_fwd_cuda(q, k, v, scale, n_valid)
    return attention_plain(q, k, v, scale, n_valid)


def attn_bwd(q, k, v, g, scale: float, n_valid: int = 0):
    """K6 for CUDA tensors, its plain version for CPU tensors."""
    if q.is_cuda:
        return attn_bwd_cuda(q, k, v, g, scale, n_valid)
    return attention_bwd_plain(q, k, v, g, scale, n_valid)


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


class AttnSplit(torch.autograd.Function):
    """Attention on [B, H, N, dh] tensors; saves only q, k, v for the
    backward, as the reference's custom VJP does (:307-321)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, n_valid: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (scale, n_valid)
        return attn_fwd(q, k, v, scale, n_valid)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attn_bwd(q, k, v, g.contiguous(), *ctx.cfg), None, None)


def qkv_attention_supported(qkv: torch.Tensor, num_heads: int) -> bool:
    """The reference's gate for the fused-qkv kernels (:628-635): two dh=64
    heads per 128 columns and N, padded to 8, at most _QKV_MAX_N_PAD."""
    B, N, threeD = qkv.shape
    D = threeD // 3
    if D % num_heads or D // num_heads != HEAD_DIM or D % 128:
        return False
    return -(-N // 8) * 8 <= _QKV_MAX_N_PAD


def pallas_attention_supported(q: torch.Tensor) -> bool:
    """The reference's gate for its split-tensor kernels (:663-669). The
    port routes by split_attention_supported instead: K5 has no length cap
    (module docstring)."""
    dh, N = q.shape[3], q.shape[2]
    return dh % 64 == 0 and -(-N // 128) * 128 <= _MAX_N_PAD


def split_attention_supported(q: torch.Tensor) -> bool:
    """The port's gate for K5/K6, in the reference's place (:687): the
    reference's pallas_attention_supported less its _MAX_N_PAD cap (K5 has
    no length cap), i.e. every dh % 64 == 0 (64 on the kernels K1 shares,
    128, 192, ... on K5's and K6's wide passes). Every other
    dh takes library_attention, the reference's _xla_attention route."""
    return q.shape[3] % HEAD_DIM == 0


def xla_attention_plain(q, k, v, scale: float,
                        n_valid: int = 0) -> torch.Tensor:
    """The reference's _xla_attention (:79-96) on [B, H, N, dh], by
    autograd: fp32 logits and softmax, the probabilities in v's type for
    the PV product (fp32 accumulation), the output in q's type."""
    e, denom = _probs(q, k, scale, n_valid)
    p = (e / denom).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)


def library_attention(q, k, v, scale: float,
                      n_valid: int = 0) -> torch.Tensor:
    """Attention without the port's kernels (use_pallas_attention=False,
    the reference's XLA route): PyTorch's scaled_dot_product_attention on
    CUDA tensors, xla_attention_plain on CPU tensors."""
    if not q.is_cuda:
        return xla_attention_plain(q, k, v, scale, n_valid)
    mask = None
    N = k.shape[2]
    if 0 < n_valid < N:
        # [1, N]: SDPA takes a mask of at least two dims, broadcast over
        # the queries
        mask = (torch.arange(N, device=q.device) < n_valid)[None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, n_valid: int = 0,
                         use_pallas: bool = True) -> torch.Tensor:
    """Softmax attention over [B, H, N, dh] tensors (differentiable): K5/K6
    on CUDA tensors at every N and every dh that split_attention_supported
    takes (dh % 64 == 0); library_attention without use_pallas or at
    another dh (the reference's route, :687-690)."""
    if not use_pallas or not split_attention_supported(q):
        return library_attention(q, k, v, scale, n_valid)
    return AttnSplit.apply(q, k, v, float(scale), int(n_valid))


def attention_from_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                       n_valid: int = 0,
                       use_pallas: bool = True) -> torch.Tensor:
    """[B, N, 3D] -> [B, N, D] softmax attention (differentiable), routed
    as the reference routes it (:638-660): the fused-qkv kernels K1/K2 up
    to the cap, above it split heads, K5/K6, merged heads; without
    use_pallas, split heads through library_attention."""
    if use_pallas and qkv_attention_supported(qkv, num_heads):
        return AttnQKV.apply(qkv, num_heads, float(scale), int(n_valid))
    q, k, v = _split_heads(qkv, num_heads)
    return _merge_heads(multi_head_attention(q, k, v, scale, n_valid,
                                             use_pallas))
