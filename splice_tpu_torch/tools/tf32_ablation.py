"""Ablation: what binds the split-TF32 attention kernels (fp32 K1/K2), the
tensor pipe or the work the warps issue around it?

    python -m splice_tpu_torch.tools.tf32_ablation

Each fp32 product in csrc/attention.cu (namespace tf32) is three mma.sync
m16n8k8 .tf32 instructions (hi*lo, lo*hi, hi*hi) on fragments that every
warp splits in registers (hi: two integer operations; lo = x - hi), both
from csrc/tf32.cuh. The tool builds the library as it stands
(ops._build) and three variants of its text, each made by one edit of
the source with the header written into it (VARIANTS; a missing edit
raises):
  * one_term: only hi*hi (a third of the mma.sync; lo is dead code);
  * no_split: three products of the raw fp32 bits (every mma.sync, none of
    the split's arithmetic);
  * bare: both (one product of the raw bits).
Only the full library computes the attention to fp32's accuracy (checked
here against the plain fp32 version at 1e-4 x max); the variants are
timed, not checked. If one_term runs well below the full kernel, the
tensor pipe binds; if no_split does, the split's issue slots do. Times K1
and K2 at SHAPES through the port's wrappers with each library swapped in,
in turns (ROUNDS rounds, CUDA events, the median), then prints each
variant's ptxas registers and spills, ms per shape, and one JSON line.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from typing import Dict

import torch

from splice_tpu_torch.ops import _build
from splice_tpu_torch.ops import attention as attn
from splice_tpu_torch.tools.mma_k_probe import device_ms

# name: (text in csrc/attention.cu with tf32.cuh written in at its
# #include, its replacement); each edit must match exactly once
_THREE_TERMS = """\
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.lo, b[j].hi);
"""
_SPLIT = """\
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
"""
_RAW = "  hi = lo = __float_as_uint(x);\n"
VARIANTS = {
    "one_term": ((_THREE_TERMS, ""),),
    "no_split": ((_SPLIT, _RAW),),
    "bare": ((_THREE_TERMS, ""), (_SPLIT, _RAW)),
}
# fp32 K1/K2 (B, H, N): the fp32 inversion's [1, 981] (where K2 is
# slower than SDPA's backward) and main_fp32's crops [2, 785]
SHAPES = ((1, 12, 981), (2, 12, 785))
ROUNDS = 5
ITERS = 20


_INCLUDE = '#include "tf32.cuh"\n'


def variant_source(name: str) -> str:
    """csrc/attention.cu with csrc/tf32.cuh written in at its #include (a
    variant builds from one file) and VARIANTS[name]'s edits applied."""
    src = (_build.CSRC_DIR / "attention.cu").read_text()
    if src.count(_INCLUDE) != 1:
        raise RuntimeError("tf32_ablation: attention.cu does not include "
                           "tf32.cuh exactly once")
    src = src.replace(_INCLUDE,
                      (_build.CSRC_DIR / "tf32.cuh").read_text())
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"tf32_ablation {name}: the edit's text is "
                               f"not in attention.cu exactly once")
        src = src.replace(old, new)
    return src


def build_variants() -> Dict[str, ctypes.CDLL]:
    """The full library (ops._build) and every variant, compiled together
    into _build/ablation; ptxas's registers and spills of each tf32
    kernel printed."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = out_dir / f"attention_{name}.cu"
        src.write_text(variant_source(name))
        lib = out_dir / f"libattention_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {"full": _build.library("attention")}
    logs = {"full": (_build.BUILD_DIR / "attention.log").read_text()}
    for name, (proc, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n"
                               f"{logs[name]}")
        libs[name] = ctypes.CDLL(str(lib))
    for name, log in logs.items():
        fn = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and "tf32" in fn and ("spill" in line
                                          or "registers" in line):
                print(f"  ptxas {name} {fn}: "
                      f"{line.split(':', 1)[-1].strip()}")
    return libs


def check_full(B: int, H: int, N: int) -> float:
    """The full library's K1 and K2 against the plain fp32 versions
    (matmul TF32 off): the largest error over max|plain|."""
    gen = torch.Generator().manual_seed(N)
    qkv = torch.randn(B, N, 3 * 64 * H, generator=gen).cuda()
    g = torch.randn(B, N, 64 * H, generator=gen).cuda()
    rel = 0.0
    for got, want in (
            (attn.attn_qkv_fwd_cuda(qkv, H, 0.125),
             attn.attention_qkv_plain(qkv, H, 0.125)),
            (attn.attn_qkv_bwd_cuda(qkv, g, H, 0.125),
             attn.attention_qkv_bwd_plain(qkv, g, H, 0.125))):
        rel = max(rel, ((got - want).abs().max()
                        / want.abs().max()).item())
    if not rel <= 1e-4:
        raise RuntimeError(f"fp32 K1/K2 [{B},{N},{192 * H}]: error "
                           f"{rel:.3e} x max over 1e-4")
    return rel


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    libs = build_variants()
    full = libs["full"]
    result = {"card": smi, "shapes": {}}
    for B, H, N in SHAPES:
        _build._libs["attention"] = full
        err = check_full(B, H, N)
        gen = torch.Generator().manual_seed(N)
        qkv = torch.randn(B, N, 3 * 64 * H, generator=gen).cuda()
        g = torch.randn(B, N, 64 * H, generator=gen).cuda()
        calls = {"K1": lambda: attn.attn_qkv_fwd_cuda(qkv, H, 0.125),
                 "K2": lambda: attn.attn_qkv_bwd_cuda(qkv, g, H, 0.125)}
        times = {(k, v): [] for k in calls for v in libs}
        for r in range(ROUNDS):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for v in order:
                _build._libs["attention"] = libs[v]
                for k, fn in calls.items():
                    fn()
                    times[(k, v)].append(device_ms(fn, ITERS))
        _build._libs["attention"] = full
        tag = f"[{B},{N},{192 * H}]"
        row = {"max_rel_err_full": err}
        for (k, v), ts in times.items():
            ms = statistics.median(ts)
            row[f"{k} {v}"] = ms
            print(f"  {k} {tag} {v}: {ms:.4f} ms (median of {ROUNDS}; "
                  f"{min(ts):.4f}-{max(ts):.4f})")
        result["shapes"][tag] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
