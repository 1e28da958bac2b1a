"""P1: the tensor-core probe kernel (csrc/probe.cu mma_repeat).

Port of scripts/mxu_k_probe.py _kernel (:24-30, launched by time_dot :36
and time_dot_mn :57): out = bf16(sum over reps of A @ B) for bf16 A [m, k]
and B [k, n], the sum in fp32. The reference timed it to ask whether a
64-deep contraction or a 64-wide output wastes half of the TPU's matrix
unit; tools/mma_k_probe.py asks the same of Hopper's tensor cores
(m64n64k16 against m64n128k16, the instructions the attention kernels
issue). No training path calls it.

mma_repeat launches the kernel on CUDA tensors and refuses anything else
(there is no CPU route: the probe measures the card). mma_repeat_plain is
its plain version, for the tests and chip_smoke's gate.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from splice_tpu_torch.ops import _build

ROWS = 64            # output rows a block (the wgmma M)
N_TILES = (64, 128)  # output columns a block (the wgmma N)
RESIDENT_K = 256     # above it A streams through a ring of KC-deep chunks
KC = 128
SMEM_CAP = 232448    # dynamic shared memory a block may ask for on sm_90


def mma_repeat_plain(a: torch.Tensor, b: torch.Tensor,
                     reps: int) -> torch.Tensor:
    """bf16(sum over reps of A @ B): each product in fp32 from the bf16
    operands, added to an fp32 sum loop by loop (the reference's
    acc += dot(..., preferred_element_type=float32)), then rounded."""
    af, bf = a.float(), b.float()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for _ in range(reps):
        acc = acc + af @ bf
    return acc.to(a.dtype)


def smem_bytes(k: int, n_tile: int) -> int:
    """The dynamic shared memory a block asks for (csrc/probe.cu launch):
    B^T resident, A resident or two streamed chunks, 1 KB to align."""
    kp = -(-k // 64) * 64
    a_bytes = 2 * ROWS * KC * 2 if k > RESIDENT_K else ROWS * kp * 2
    return n_tile * kp * 2 + a_bytes + 1024


def check_operands(a: torch.Tensor, b: torch.Tensor, reps: int,
                   n_tile: int) -> None:
    """Raise ValueError on what the kernel does not take: the type, then
    the shapes, then the device and layout."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"mma_repeat: needs bfloat16 A and B; got "
                         f"{a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mma_repeat: needs A [m, k] and B [k, n]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if n_tile not in N_TILES:
        raise ValueError(f"mma_repeat: n_tile {n_tile}; one of {N_TILES}")
    if m % ROWS or n % n_tile or k % 16 or m == 0 or n == 0 or k == 0:
        raise ValueError(f"mma_repeat: needs m % {ROWS}, n % n_tile "
                         f"({n_tile}) and k % 16 all 0; got m {m}, n {n}, "
                         f"k {k}")
    if k > RESIDENT_K and k % KC:
        raise ValueError(f"mma_repeat: above k = {RESIDENT_K} A streams in "
                         f"chunks of {KC}; got k {k}")
    if smem_bytes(k, n_tile) > SMEM_CAP:
        raise ValueError(f"mma_repeat: k {k} at n_tile {n_tile} needs "
                         f"{smem_bytes(k, n_tile)} bytes of shared memory, "
                         f"more than {SMEM_CAP}")
    if reps < 1:
        raise ValueError(f"mma_repeat: reps {reps} < 1")
    if not (a.is_cuda and b.is_cuda and a.device == b.device
            and a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"mma_repeat: needs contiguous CUDA tensors on one "
                         f"device; got {a.device}, {b.device}")


def mma_repeat(a: torch.Tensor, b: torch.Tensor, reps: int,
               n_tile: int = 128,
               stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P1 on the card: bf16 [m, n] = bf16(sum over reps of A @ B), one
    warpgroup a [64, n_tile] output tile. stats, if given, an int64 CUDA
    tensor of [m / 64, n / n_tile, 2], receives each block's cycles and
    nanoseconds of its issue loop."""
    check_operands(a, b, reps, n_tile)
    (m, k), n = a.shape, b.shape[1]
    if stats is not None and (
            stats.dtype != torch.int64 or stats.device != a.device
            or tuple(stats.shape) != (m // ROWS, n // n_tile, 2)
            or not stats.is_contiguous()):
        raise ValueError(f"mma_repeat: stats must be a contiguous int64 "
                         f"[{m // ROWS}, {n // n_tile}, 2] on {a.device}")
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    fn = _build.library("probe").mma_repeat
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with torch.cuda.device(a.device):
        status = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    stats.data_ptr() if stats is not None else None, m, n, k,
                    reps, n_tile, _build.stream_ptr(a.device))
    _build.check(status, "mma_repeat")
    mma_repeat.launches += 1
    return out


mma_repeat.launches = 0
