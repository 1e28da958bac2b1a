"""Ablation: what binds the pixel-major bf16 conv kernels (K3 conv_fwd_px,
K4 conv_dw_px) at the inversion net's sites?

    python -m splice_tpu_torch.tools.px_ablation

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
from splice_tpu_torch.tools.conv_forms import INV_SITES
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
ROUNDS = 5
ITERS = 20


def variant_source(name: str) -> str:
    """csrc/conv.cu with VARIANTS[name]'s edits applied."""
    src = (_build.CSRC_DIR / "conv.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"px_ablation {name}: the edit's text is not "
                               f"in conv.cu exactly once")
        src = src.replace(old, new)
    return src


def build_variants() -> Dict[str, ctypes.CDLL]:
    """The full library (ops._build) and every variant, compiled together
    into _build/ablation; ptxas's registers and spills of each px kernel
    printed."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = out_dir / f"conv_{name}.cu"
        src.write_text(variant_source(name))
        lib = out_dir / f"libconv_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
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
            elif fn and "_px_kernel" in fn and ("spill" in line
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


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    libs = build_variants()
    full = libs["full"]
    result = {"card": smi, "sites": {}}
    for site in INV_SITES:
        calls, plain = site_calls(*site)
        _build._libs["conv"] = full
        row = {}
        for key, fn in calls.items():
            got, want = fn().float(), plain[key]().float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            tol = 1.6e-2 if key.startswith("K3") else 1e-4
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
