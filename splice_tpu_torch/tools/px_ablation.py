"""Ablation: what binds the pixel-major bf16 conv kernels (K3 conv_fwd_px,
K4 conv_dw_px) at the inversion net's sites, or with --tf32 the
split-TF32 fp32 ones (K3 conv_fwd_tf32, K4 and K7 conv_dw_tf32) at
main_fp32's, or with --wg bf16 K4/K7 on conv_dw_wg at the generator's up
convs?

    python -m splice_tpu_torch.tools.px_ablation [--tf32 | --wg]

The tool builds the conv library as it stands (ops._build) and three
variants of csrc/conv.cu, each made by edits of its text (VARIANTS; an edit
that does not match exactly once raises):
  * no_mma: every mma.sync of both kernels removed (the shared-memory
    fragment loads stay);
  * no_loads: the global loads that stage V and the cotangent replaced by
    constants (the weights' cp.async stays);
  * no_stores: both kernels return before their stores (K3's cluster sums
    and y, K4's partials), behind a test the compiler cannot decide, so
    the products still run.
Only the full library computes the conv (checked here against the plain
versions); the variants are timed, not checked. Times K3 (forward and the
input gradient) at every INV_SITE, and K4 where conv_route puts it on
conv_dw_px (not at the two Cout-16 sites that keep conv_dw_tc), through
the port's wrappers with each library swapped in, in turns (ROUNDS
rounds, CUDA events, the median),
then prints each variant's ptxas registers and spills for the px kernels,
the ms of each call and one JSON line. Needs a CUDA device and nvcc.

With --tf32 the variants are TF32_VARIANTS, edits of conv.cu with
csrc/tf32.cuh written in at its #include:
  * one_term: one mma.sync a product (hi*hi) instead of three;
  * no_copies: the cp.async copies that stage V, the weights and the
    cotangent removed (the shared tiles keep what they held);
  * no_pass: the pass that splits the landed tiles (K3's V and weights,
    K4's cotangent, K7's V) removed;
and the calls are fp32 K3, its input gradient, K4 and K7 (the SAME
border, k = 3) at main_fp32's two sites (conv_forms.FP32_SITES, which are
also the SAME route's K7 sites), against the plain versions at 1e-4.

With --wg the variants are WG_VARIANTS, edits of conv_dw_wg_kernel:
  * no_mma: its wgmma products removed (the A fragments' ldmatrix, the
    fences, commits and waits stay);
  * no_steps: every k16 step skipped (no fragments, no products): what is
    left is the skeleton, the barriers, TMA, the transposition, the drains,
    the partials and their sum;
  * no_transpose: the transposition of T's landed rows removed (the
    products read whatever the ring holds);
and the calls are bf16 K7 and K4 at k = 9 (the SAME border) at the up_conv
sites (conv_forms.DW9_SITES), through the route's plan, against the plain
versions at 1e-4.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from typing import Dict

import torch

from splice_tpu_torch.ops import _build
from splice_tpu_torch.ops import conv
from splice_tpu_torch.tools.conv_forms import DW9_SITES, FP32_SITES, INV_SITES
from splice_tpu_torch.tools.mma_k_probe import device_ms

_K3_MMA = """\
      mma16816(acc[i][2 * jj], a[i], bq[jj][0], bq[jj][1]);
      mma16816(acc[i][2 * jj + 1], a[i], bq[jj][2], bq[jj][3]);
"""
_K4_MMA0 = ("          for (int j = 0; j < NB; ++j) mma16816(acc[i][j], a0, "
            "bf[j][0], bf[j][1]);\n")
_K4_MMA1 = "              mma16816(acc[i + 1][j], a1, bf[j][0], bf[j][1]);\n"
_V_LOAD = "      const uint32_t raw = __ldg(plane + (size_t)rc * s.W + cc);\n"
_G_LOAD = """\
    const uint32_t lo = __ldg(gr + min(xx, Wp - 1));
    const uint32_t hi = __ldg(gr + min(xx + 1, Wp - 1));
"""
_K3_END = "    __syncthreads();                      // this stage is read\n  }\n"
_K4_END = "  float* out = partial + (size_t)blockIdx.x * k * k * Cs * Cu;\n"
VARIANTS = {
    "no_mma": ((_K3_MMA, ""), (_K4_MMA0, ""),
               (_K4_MMA1, "              (void)j;\n")),
    "no_loads": ((_V_LOAD, "      const uint32_t raw = 0x3f80u;\n"),
                 (_G_LOAD, "    const uint32_t lo = 0x3f80u, hi = 0x3f80u;\n")),
    "no_stores": ((_K3_END, _K3_END + "  if (Cout > 0) return;\n"),
                  (_K4_END, "  if (Cu > 0) return;\n" + _K4_END)),
}
_THREE_TERMS = """\
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.lo, b[j].hi);
"""
_NO_COPY = "  if (nch + ntaps >= 0) return;\n"
TF32_VARIANTS = {
    "one_term": ((_THREE_TERMS, ""),),
    "no_copies": (
        ("  const float* xb = x + (size_t)b * s.cin * s.H * s.W;\n",
         "  const float* xb = x + (size_t)b * s.cin * s.H * s.W;\n"
         + _NO_COPY.replace("ntaps", "nrows")),
        ("                                        int n0, int cout, bool vec,\n"
         "                                        float* wr) {\n",
         "                                        int n0, int cout, bool vec,\n"
         "                                        float* wr) {\n"
         + _NO_COPY.replace("nch", "c0")),
        ("                                        bool vec, float* gr) {\n",
         "                                        bool vec, float* gr) {\n"
         + _NO_COPY.replace("nch + ntaps", "n0 + Cu"))),
    "no_pass": (
        ("      for (int r4 = 4 * threadIdx.x; r4 < L.vplane; "
         "r4 += 4 * THREADS) {\n",
         "      for (int r4 = 4 * threadIdx.x; r4 < 0 * L.vplane; "
         "r4 += 4 * THREADS) {\n"),
        ("    for (int i = threadIdx.x; i < nd * k * NB * 32; i += THREADS) {\n",
         "    for (int i = threadIdx.x; i < 0 * NB; i += THREADS) {\n"),
        ("    for (int i = threadIdx.x; i < NCO * DR * DC; i += THREADS) {\n",
         "    for (int i = threadIdx.x; i < 0 * DC; i += THREADS) {\n")),
}
_WG_MMA = ("      for (int j = 0; j < J; ++j) wg_rs<N>(acc[j], a[kk & 1][j], "
           "ud + 2 * kk);\n")
_WG_STEPS = "      if (kk >= steps) break;\n"
_WG_TRANSPOSE = ("    for (int op = warp; op < (last - first + 1) * n_ops; "
                 "op += WARPS) {\n")
WG_VARIANTS = {
    "no_mma": ((_WG_MMA, ""),),
    "no_steps": ((_WG_STEPS, "      if (kk >= 0) break;\n"),),
    "no_transpose": ((_WG_TRANSPOSE, _WG_TRANSPOSE.replace(
        "(last - first + 1) * n_ops", "0 * n_ops")),),
}
_INCLUDE = '#include "tf32.cuh"\n'
ROUNDS = 5
ITERS = 20


def _variants(tf32: bool, wg: bool) -> dict:
    return TF32_VARIANTS if tf32 else WG_VARIANTS if wg else VARIANTS


def variant_source(name: str, tf32: bool = False, wg: bool = False) -> str:
    """csrc/conv.cu with VARIANTS[name]'s edits applied (with tf32,
    TF32_VARIANTS[name]'s, csrc/tf32.cuh written in at its #include; with
    wg, WG_VARIANTS[name]'s)."""
    src = (_build.CSRC_DIR / "conv.cu").read_text()
    if tf32:
        if src.count(_INCLUDE) != 1:
            raise RuntimeError("px_ablation: conv.cu does not include "
                               "tf32.cuh exactly once")
        src = src.replace(_INCLUDE,
                          (_build.CSRC_DIR / "tf32.cuh").read_text())
    for old, new in _variants(tf32, wg)[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"px_ablation {name}: the edit's text is not "
                               f"in conv.cu exactly once")
        src = src.replace(old, new)
    return src


def build_variants(tf32: bool = False,
                   wg: bool = False) -> Dict[str, ctypes.CDLL]:
    """The full library (ops._build) and every variant, compiled together
    into _build/ablation (csrc on the include path); ptxas's registers and
    spills of each ablated kernel printed."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    kind = ("_tf32_kernel" if tf32 else "conv_dw_wg_kernel" if wg
            else "_px_kernel")
    for name in _variants(tf32, wg):
        src = out_dir / f"conv_{name}.cu"
        src.write_text(variant_source(name, tf32, wg))
        lib = out_dir / f"libconv_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {"full": _build.library("conv")}
    logs = {"full": (_build.BUILD_DIR / "conv.log").read_text()}
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
            elif fn and kind in fn and ("spill" in line
                                        or "registers" in line):
                print(f"  ptxas {name} {fn}: "
                      f"{line.split(':', 1)[-1].strip()}")
    return libs


def site_calls(name, cin, cout, H, W, k, stride):
    """The bf16 K3, K3 input-gradient and (where it runs conv_dw_px) K4
    calls of one site, and the full library's check of them against the
    plain versions."""
    gen = torch.Generator().manual_seed(cin + k)
    ho, wo = (H - k) // stride + 1, (W - k) // stride + 1
    x = torch.randn(1, cin, H, W, generator=gen).to("cuda", torch.bfloat16)
    w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to(
        "cuda", torch.bfloat16)
    g = torch.randn(1, cout, ho, wo, generator=gen).to("cuda",
                                                        torch.bfloat16)
    wk = conv.s2d_kernel(w).contiguous() if stride == 2 else w
    kk = wk.shape[0]
    wf = torch.flip(wk, dims=(0, 1)).transpose(2, 3).contiguous()
    calls = {
        "K3": (lambda: conv.conv_valid_s2d_cuda(x, wk, 0, (ho, wo))
               if stride == 2 else conv.conv_valid_cuda(x, wk)),
        "K3 dx": lambda: conv.conv_valid_cuda(g, wf, kk - 1,
                                              phase=stride == 2),
        "K4": (lambda: conv.conv_dw_s2d_cuda(x, g, kk, 0)
               if stride == 2 else conv.conv_dw_cuda(x, g, kk))}
    plain = {"K3": lambda: conv.conv_valid_pro_plain(
                 x, wk, None, None, 1.0, 0, stride, (ho, wo)),
             "K3 dx": lambda: conv.conv_valid_plain(g, wf, kk - 1),
             "K4": lambda: conv.conv_dw_pro_plain(x, g, kk, None, None, 1.0,
                                                  0, stride)}
    if conv.conv_route("dw", torch.bfloat16, kk, stride, wk.shape[2], cout,
                       1, ho, wo).form != "px":
        del calls["K4"], plain["K4"]
    return calls, plain


def fp32_site_calls(name, cin, cout, S):
    """fp32 K3, its input gradient, K4 and K7 at one of main_fp32's sites
    (conv_forms.FP32_SITES: B = 2, k = 3, border 1), and their plain
    versions."""
    F = torch.nn.functional
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(2, cin, S, S, generator=gen).cuda()
    w = (0.1 * torch.randn(3, 3, cin, cout, generator=gen)).cuda()
    g = torch.randn(2, cout, S, S, generator=gen).cuda()
    wf = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
    calls = {"K3": lambda: conv.conv_valid_cuda(x, w, 1),
             "K3 dx": lambda: conv.conv_valid_cuda(g, wf, 1),
             "K4": lambda: conv.conv_dw_cuda(x, g, 3, 1),
             "K7": lambda: conv.conv_dw_gtap_cuda(x, g, 3, None, None, 1.0,
                                                  1)}
    plain = {"K3": lambda: conv.conv_valid_plain(x, w, 1),
             "K3 dx": lambda: conv.conv_valid_plain(g, wf, 1),
             "K4": lambda: conv.conv_dw_plain(F.pad(x, (1, 1, 1, 1)), g, 3),
             "K7": lambda: conv.conv_dw_gtap_plain(x, g, 3, None, None, 1.0,
                                                   1)}
    return calls, plain


def wg_site_calls(name, cin, cout, S):
    """bf16 K7 and K4 at k = 9 (the SAME border) at one of the up_conv
    sites (conv_forms.DW9_SITES: B = 2), through the route's conv_dw_wg
    plan, and their plain versions."""
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(2, cin, S, S, generator=gen).to("cuda", torch.bfloat16)
    g = torch.randn(2, cout, S, S, generator=gen).to("cuda", torch.bfloat16)
    calls = {"K7": lambda: conv.conv_dw_gtap_cuda(x, g, 9, None, None, 1.0,
                                                  4),
             "K4": lambda: conv.conv_dw_cuda(x, g, 9, 4)}
    plain = {"K7": lambda: conv.conv_dw_gtap_plain(x, g, 9, None, None, 1.0,
                                                   4),
             "K4": lambda: conv.conv_dw_plain(
                 torch.nn.functional.pad(x, (4, 4, 4, 4)), g, 9)}
    return calls, plain


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--wg", action="store_true")
    args = ap.parse_args(argv)
    tf32, wg = args.tf32, args.wg
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(tf32, wg)
    full = libs["full"]
    result = {"card": smi, "tf32": tf32, "wg": wg, "sites": {}}
    for site in (FP32_SITES if tf32 else DW9_SITES if wg else INV_SITES):
        calls, plain = (fp32_site_calls if tf32 else wg_site_calls if wg
                        else site_calls)(*site)
        _build._libs["conv"] = full
        row = {}
        for key, fn in calls.items():
            got, want = fn().float(), plain[key]().float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            tol = 1.6e-2 if key.startswith("K3") and not tf32 else 1e-4
            if not rel <= tol:
                raise RuntimeError(f"{key} {site[0]}: error {rel:.3e} x "
                                   f"max over {tol}")
            row[f"{key} max_rel_err"] = rel
        times = {(c, v): [] for c in calls for v in libs}
        for r in range(ROUNDS):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for v in order:
                _build._libs["conv"] = libs[v]
                for c, fn in calls.items():
                    fn()
                    times[(c, v)].append(device_ms(fn, ITERS))
        _build._libs["conv"] = full
        for (c, v), ts in times.items():
            ms = statistics.median(ts)
            row[f"{c} {v}"] = ms
            print(f"  {c} {site[0]} {v}: {ms:.4f} ms (median of {ROUNDS}; "
                  f"{min(ts):.4f}-{max(ts):.4f})")
        result["sites"][site[0]] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
