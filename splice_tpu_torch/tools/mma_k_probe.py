"""Probe: does a 64-deep contraction, or a 64-wide output, cost the tensor
cores as much as a 128-wide one? (Port of scripts/mxu_k_probe.py, which
asked it of the TPU's matrix unit.)

    python -m splice_tpu_torch.tools.mma_k_probe

Runs the reference's two experiments at its shapes, reps and iterations on
the card through P1 (ops.probe.mma_repeat: reps wgmma products over
operands resident in shared memory), inputs all ones as the reference has
them:
  * the depth question: [768, K] x [K, 768] for K in 64, 128, 256, with
    output tiles of 128 columns (m64n128k16, the attention forward's S)
    and of 64 (m64n64k16, the backward's S^T and dP^T over dh = 64);
  * the width question: [768, 768] x [768, W] for W in 64, 128, each W
    its own tile (K walks through a two-buffer ring: 768 does not stay
    resident at 128 columns), and again at K = 256 resident.
Prints the reference's lines (us per product, the ratios t128/t64,
t256/t128, w128/w64, the verdicts; the width verdict only at K = 256,
since at K = 768 the ring's loads, not the instruction, set the time),
then each configuration's cycles per wgmma instruction (the median
block's clock64 count over its instructions, set against the dense rate
of 4096 bf16 flops per SM cycle that 989 TFLOP/s means over 132 SMs at
1.83 GHz) and TFLOP/s against 989, and last one JSON line of every
number. Wall times compare waves of
blocks over the SMs (at 768 the 64-column grid has 144 blocks, the
128-column one 72); cycles compare instructions. Needs a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import time

import torch

from splice_tpu_torch.ops import probe

PEAK_TFLOPS = 989.0        # H100 SXM, dense bf16
FLOPS_PER_SM_CYCLE = 4096  # 989.4e12 / (132 SMs x 1.83e9 Hz)
N = 768
REPS = 64                  # the reference's products a call
ITERS = 50                 # and its timed calls


def device_ms(fn, iters: int) -> float:
    """Device ms per call over `iters` back-to-back calls, by CUDA events,
    behind a device sleep long enough for the host to queue them all (a
    call's wrapper takes longer on the host than a short kernel on the
    card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * min(2 * host_s * iters + 2e-4, 0.1)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(m: int, k: int, n: int, n_tile: int) -> dict:
    """One configuration: us per product (one A @ B), TFLOP/s, and from one
    more call the blocks' cycles and nanoseconds of their issue loops."""
    reps = REPS
    a = torch.ones(m, k, dtype=torch.bfloat16, device="cuda")
    b = torch.ones(k, n, dtype=torch.bfloat16, device="cuda")
    ms = device_ms(lambda: probe.mma_repeat(a, b, reps, n_tile), ITERS)
    stats = torch.zeros(m // probe.ROWS, n // n_tile, 2, dtype=torch.int64,
                        device="cuda")
    out = probe.mma_repeat(a, b, reps, n_tile, stats=stats)
    # ones: every output is k * reps, exact in fp32, bf16-rounded
    want = torch.tensor(float(k * reps)).to(torch.bfloat16).item()
    if not bool((out == want).all()):
        raise RuntimeError(f"mma_repeat [{m},{k}]x[{k},{n}] n_tile {n_tile}: "
                           f"output is not {want} everywhere")
    cyc = stats[..., 0].flatten().tolist()
    ns = stats[..., 1].flatten().tolist()
    instr = reps * (-(-k // 64) * 64) // 16    # K zero-padded to 64s
    cpi = statistics.median(cyc) / instr
    flops = 2.0 * m * n * k
    return {"m": m, "k": k, "n": n, "n_tile": n_tile, "reps": reps,
            "route": "streamed" if k > probe.RESIDENT_K else "resident",
            "blocks": len(cyc), "us_per_product": ms * 1e3 / reps,
            "tflops": flops * reps / (ms * 1e-3) / 1e12,
            "of_peak": flops * reps / (ms * 1e-3) / 1e12 / PEAK_TFLOPS,
            "instr": f"m64n{n_tile}k16", "cycles_per_instr": cpi,
            "cycles_per_instr_max": max(cyc) / instr,
            "ideal_cycles": 2 * 64 * n_tile * 16 / FLOPS_PER_SM_CYCLE,
            "sm_mhz": statistics.median(
                c / t * 1e3 for c, t in zip(cyc, ns) if t > 0)}


def run() -> dict:
    """Every configuration of both questions; the ratios the reference
    printed."""
    if not torch.cuda.is_available():
        raise RuntimeError("mma_k_probe measures the card: no CUDA device")
    depth = {nt: {k: measure(N, k, N, nt)
                  for k in (64, 128, 256)} for nt in probe.N_TILES}
    width = {k: {w: measure(N, k, w, w)
                 for w in probe.N_TILES} for k in (N, 256)}
    ratios = {f"t128/t64 n{nt}": depth[nt][128]["us_per_product"]
              / depth[nt][64]["us_per_product"] for nt in probe.N_TILES}
    ratios.update({f"t256/t128 n{nt}": depth[nt][256]["us_per_product"]
                   / depth[nt][128]["us_per_product"]
                   for nt in probe.N_TILES})
    ratios.update({f"w128/w64 k{k}": width[k][128]["us_per_product"]
                   / width[k][64]["us_per_product"] for k in (N, 256)})
    return {"device": torch.cuda.get_device_name(0), "depth": depth,
            "width": width, "ratios": ratios}


def report(res: dict) -> None:
    depth, width, r = res["depth"], res["width"], res["ratios"]
    for nt in probe.N_TILES:
        t = {k: depth[nt][k]["us_per_product"] for k in (64, 128, 256)}
        print(f"output tiles of {nt} columns (m64n{nt}k16):")
        print(f"[{N},64]x[64,{N}]   : {t[64]:8.2f} us/dot")
        print(f"[{N},128]x[128,{N}] : {t[128]:8.2f} us/dot "
              f"(ratio vs K=64: {r[f't128/t64 n{nt}']:.2f})")
        print(f"[{N},256]x[256,{N}] : {t[256]:8.2f} us/dot "
              f"(ratio vs K=128: {r[f't256/t128 n{nt}']:.2f})")
        if r[f"t128/t64 n{nt}"] < 1.25:
            print("-> K=64 wastes ~half the tensor cores: packing two "
                  "dh=64 heads into one K=128 product CAN pay")
        else:
            print("-> K=64 streams efficiently: head packing is a dead "
                  "lever")
    for k in (N, 256):
        w = {nt: width[k][nt]["us_per_product"] for nt in probe.N_TILES}
        route = width[k][64]["route"]
        print(f"[{N},{k}]x[{k},64]  : {w[64]:8.2f} us/dot ({route})")
        print(f"[{N},{k}]x[{k},128] : {w[128]:8.2f} us/dot "
              f"(ratio vs W=64: {r[f'w128/w64 k{k}']:.2f})")
        if k > probe.RESIDENT_K:
            print("-> limited by loads through the ring, not by the "
                  "instruction: no verdict")
        elif r[f"w128/w64 k{k}"] < 1.25:
            print("-> 64-wide outputs waste ~half the tensor cores: pack "
                  "the PV outputs (one m64n128 product over two heads)")
        else:
            print("-> 64-wide outputs stream efficiently: leave the PV "
                  "products")
    for c in ([depth[nt][k] for nt in probe.N_TILES for k in (64, 128, 256)]
              + [width[k][w] for k in (N, 256) for w in probe.N_TILES]):
        print(f"[{c['m']},{c['k']}]x[{c['k']},{c['n']}] {c['instr']} "
              f"{c['route']}, {c['blocks']} blocks: "
              f"{c['cycles_per_instr']:.1f} cycles/instr (ideal "
              f"{c['ideal_cycles']:.0f}; slowest block "
              f"{c['cycles_per_instr_max']:.1f}), SM {c['sm_mhz']:.0f} MHz, "
              f"{c['tflops']:.1f} TFLOP/s ({100 * c['of_peak']:.1f}% of "
              f"{PEAK_TFLOPS:.0f})")


def main() -> None:
    res = run()
    report(res)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
