#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (splice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the hand-written CUDA kernels from splice_tpu_torch/csrc and
     print each kernel's registers and spills; every tensor-core kernel
     must hold tensor-core instructions (cuobjdump): wgmma (HGMMA) in the
     bf16 route of K1/K2 and K5/K6, mma.sync (HMMA) in the bf16 route of
     K3 (every form) and of K4 and K7, and neither in the fp32 conv
     kernels;
  2. hold every kernel against its plain PyTorch version at the shapes the
     training paths give it (and at small edge-case shapes; the bf16
     attention kernels also at N under a tile, one past a tile, B = 1 and
     2, 6 and 12 heads, masked key blocks and more seeds; the bf16 weight
     gradients and every bf16 K3 form at W = 37, H < k, odd stride-2
     sizes, Cin 3 and 136, Cout 3, 36, 68 and 128, k = 1, 2, 3, two
     BatchNorm stacks with a scale of 1e-13, VALID K7, K3''' at ragged
     sizes and the entire-A generator's B = 1 shapes from 900 x 1200; K2,
     K6, K3 in each form (the input gradient too), K4 in each form and K7
     twice on one input, bitwise equal),
     and time kernel, plain version and a PyTorch library call that
     computes the same function (the yardstick only); the redesigned
     kernels beside their previous kernels' times;
  3. run one regular and one entire-A step at a small size on the card
     (fp32, through the kernels) and on the CPU (plain path) from the same
     parameters and draws, and compare loss and gradient, for
     generator_conv auto, fused and pallas, and fused and pallas with the
     SAME-border route on (ops.conv.SAME_BORDER_KERNELS); RMSprop and SGD
     (the port's own optimizers) from that size's parameters and
     gradient, three updates on the card against the CPU; then, at that
     size, the captured graphs against eager steps (as in phase 4b);
  4. the main path: train_pair on the cows pair at full width (896 canvas,
     dino_vitb8 with seeded random weights, 224 loss resolution, bf16) for
     12 steps including entire-A steps, in chunks through
     trainer.SpliceProgram: each step class one captured CUDA graph,
     replayed; every loss finite, every kernel of the path launched inside
     the graphs, every K1/K2 launch on the tensor cores. Launches are
     counted on the card: each wrapper counts its calls, and a call
     recorded in a graph at capture launches once per replay, so the
     count is eager launches plus recorded calls x replays;
  4b. replay against eager at full width: from one cloned state (flat
     parameters and Adam's state), the same draws as an entire-A step,
     three regular steps and another entire-A step, eagerly twice (their
     spread: F.interpolate's bilinear backward adds with atomics) and
     through the program; per-step losses and the parameter update must
     agree within REPLAY_MULT x the eager spread plus a floor; then each
     step replayed from the eager run's state before it must give its
     losses within the floor. Then one chunk is queued under
     torch.cuda.set_sync_debug_mode("error"): no host synchronisation
     inside a chunk;
  5. where the time goes: the wall of a chunk of graph replays beside the
     eager step's, the device's span by CUDA events, and torch.profiler
     over three more replays (kernels inside the graphs, graph launches);
  6. the other paths at the same width, a few steps each including an
     entire-A step, through the program, each with its kernels launched
     inside its graphs and a profile of replays:
     the 480-px loss resolution (3601 and 2701 tokens: split-tensor
     attention K5/K6, every launch on the tensor cores; on the 224 paths
     every K1/K2 launch),
     generator_conv=fused (K3'/K4' with the BatchNorm prologue),
     generator_conv=pallas (every conv on K3/K4, stride 2 at
     k = 2), and fused and pallas with the SAME-border route on (K3'' SAME,
     K3''' in-kernel BatchNorm statistics, K7 cotangent-tapped dw), plus a
     few fused SAME steps of a generator with 3x3 skip convs, the one
     configuration whose fused sites reach K3'' SAME with a prologue and
     without statistics; on every path every bf16 attention and conv
     launch (K3 in each form, K4, K7) counts in its wrapper's
     tc_launches;
  7. the eager step time (SpliceTrainer.step, no graphs) of
     generator_conv auto, fused and pallas, fused and pallas with the SAME
     route, and fused with the SAME route but ops.conv.DW_TAP_ON_N off (K4
     for the dw that K7 takes otherwise: an ablation of the reference's
     routing on this card), at 224, measured in turns (two rounds);
  8. a run as a user runs it: train_pair on the main path for 300 steps
     at the reference's defaults (log_images_freq 10, entire_A_every 75,
     cls_warmup 1), the cosine schedule over the 300 steps, metrics_path
     and a checkpoint every 100 steps in a temporary directory. Gates:
     every step's lr bit for bit the reference's float32 schedule and the
     one the optimizer read; every loss finite; output.png [900, 1200, 3]
     and the run's last uint8 frame; 30 metrics records with the losses,
     lr and steps/s, the device memory on every tenth; checkpoints at
     100, 200 and 300; a second train_pair resumed from the checkpoint at
     200 draws rows bitwise equal to the run's 200-299 and its first
     losses bitwise equal to the run's step 200; one chunk and its log
     boundary queued under torch.cuda.set_sync_debug_mode("error"), the
     saver's and the logger's workers finishing inside the window; and
     RMSprop and SGD, four steps each at a linear schedule through the
     graphs, a replayed step's update against the optimizer's formula.
     Prints the sustained steps/s (renders, saves and checkpoints
     included), the replayed step's, the seconds at log boundaries and
     which PNG encoder ran;
  9. the DINOv2 backbones at full width: train_pair with dinov2_vitl14
     (24 layers, D 1024, 16 heads, patch 14, layer scale; 257 tokens a
     crop, 337 for the entire A) for 12 steps and dinov2_vitb14_reg (4
     register tokens; 261 tokens a crop) for 4, each with phase 4's gates,
     phase 4b's graphs against eager, and a profile of replays;
  10. video: train_video over a 3-frame clip made from the cows pair
     (identical frames), 20 + 2 x 10 steps: frames 1 and 2 capture
     nothing and replay frame 0's graphs, each starts bitwise from the
     previous frame's final parameters with a zeroed optimizer state and
     frame 0's first draws; three [900, 1200, 3] frame PNGs; each frame's
     steps/s;
  11. several pairs in one step (bench_configs.config_c on one card):
     parallel.pair_parallel.train_pairs on [cows, apples2oranges] x 4 at
     image_hw 224 (dino_vitb8 with seeded weights, bf16, generator_conv
     auto) for 12 steps including the entire-A step at 0, each step class
     one captured graph over the 8 pairs. Gates: every pair's losses
     finite; 8 output.png of [224, 224, 3] and 8 metrics.jsonl; K1/K2
     launched inside the graphs, every launch on the tensor cores; the
     graphs against eager steps from one cloned state (phase 4b's rule)
     and one chunk under the sync debug mode. Prints the replayed 8-pair
     step and pair-steps/s (replayed and train_pairs' sustained), the
     busy share, launches and the port's kernels' ms per step, peak
     memory and the top device operations. Then 4 steps of two pairs
     under generator_conv pallas (at 224) and fused (at 448: at a 224
     canvas fused routes no conv to the kernels), each with its K3/K4
     forms launched inside the pair loop's graphs on the tensor cores.
  12. the inversion tool (tools.inversion.invert) on limes at resize 224
     (224 x 281; dino_vitb8 with seeded weights, the 6-scale inversion net
     of 7x7/5x5/3x3 filters with reflection padding, bf16), feature cls,
     61 steps at log_freq 20 (chunks 1, 20, 20, 20), with the default
     generator_layout nhwc (cuDNN) and with chw + generator_conv pallas
     (K3/K4 at k = 7, 5 and the phase kernels' k2 = 4, 3). Gates: the
     logged steps 0, 20, 40, 60 and every loss finite; the PNG [224, 281,
     3]; the ViT's input (224, 281); K1/K2 and, on chw + pallas, K3 and K4
     at k = 4, 5 and 7 launched inside the graph, every bf16 launch on the
     tensor cores; the graph against eager steps from one state (phase
     4b's rule, at noise magnitude 0); then feature keys for 5 steps, an
     fp32 run (K1/K2 on the CUDA cores), evaluate's LPIPS (seeded AlexNet)
     of the output on the card against the CPU, and the main path with
     generator_layout nhwc for 4 steps through the program, its replayed
     regular step profiled beside main's. Prints
     iterations/s replayed and sustained, kernel ms per step and peak
     memory for each layout.
  13. the mesh (parallel.mesh, models.vit's tensor-parallel block):
     train_pairs over config c's eight pairs at dp = 2 x tp = 2 over
     [cuda:0] * 4 (two groups of four pairs, each group's ViT over two
     ranks of 6 heads, each group one captured graph per step class),
     MESH_STEPS steps. Gates: the rows equal phase 11's and every pair's
     losses agree with phase 11's dp = tp = 1 run within the larger of
     bf16's tolerance and 2 x the eager spreads phases 4b and 11
     measured; K1/K2 launched inside both groups' graphs on the tensor
     cores, every launch at 6 heads. Prints pair-steps/s (informational:
     the four ranks share one card). Then train_pairs with mesh_dp 2 on
     two pairs checkpoints and a dp = 1 run resumes from it with every
     pair's parameters and Adam state equal; and ViT-B/8 at tp = 4 (3
     heads a rank: K5/K6) against tp = 1, taps and input gradient;
  14. observability and ablations: the main path with profile_dir (an
     18-step run tracing steps 12-16): the trace's K1 kernels are exactly
     5 x the K1 calls of the regular graph, and tools/trace_agg.py reads
     it; the main path with use_pallas_attention=false (SDPA): no K1, K2,
     K5 or K6 launch, its replayed step beside main's; tools/ablate.py at
     the default and with xlaattn.
Phase 2 also holds K1/K2 at the mesh's tp = 2 shape (MESH_QKV) and K5/K6
at its tp = 4 shape (MESH_SPLIT). Phase 2 also holds K1/K2 at the DINOv2 paths' shapes (DINOV2_QKV), at
config c's batch of 16 (PAIRS_QKV; every launch on the tensor cores, in
the JSON line as path config_c), at the inversion's [1, 981, 2304] in bf16
and fp32 (INVERSION_QKV) and at 16 heads (QKV_EDGES), and K3 (plain, pro,
the input gradient) and K4 (plain, pro) in bf16 and fp32 at the inversion
net's sites (INV_SITES), timed in bf16 against F.conv2d and cuDNN's
gradients. Phase 3 runs a small fp32 DINOv2 (layer scale, registers) on
the card against the CPU, two pairs' regular and entire-A steps
(MultiPairTrainer) on the card against the CPU for generator_conv auto,
fused and pallas (phase 3's tolerances, or 1.25 x the input's fp32
conditioning measured beside them where that is larger), a small step of
the NHWC generator (lanczos2, Swish) and a small inversion step (nhwc and
chw + pallas, the inversion net at 128 x 160) on the card against the CPU,
and the two pairs' captured graphs against eager steps.
Prints the kernels' numbers as one JSON line, the card's name and power
limit, and last {"ok": true, "device": {...}}. With `--mesh-cards 4` (a
machine with four cards) it builds the kernels and runs phase 13 alone
over cuda:0..3, against a dp = tp = 1 run of the same steps on cuda:0. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
MAIN_STEPS = 12
# the times PERF.md records at the same shapes for the kernels that the
# tensor-core designs replaced (bf16 on the CUDA cores), printed beside
# this run's
PREVIOUS_MS = {"attn_qkv_fwd": 0.4028, "attn_qkv_bwd": 1.6666,
               "attn_fwd": 0.2454, "attn_bwd": 1.1383, "conv_dw": 1.9185,
               "conv_dw_pro": 2.1197, "conv_dw_s2d": 0.1504,
               "conv_dw_gtap": 2.1107, "conv_valid": 1.0272,
               "conv_valid_pro": 1.1573, "conv_valid_s2d": 0.0732,
               "conv_same": 1.0288, "conv_same_pro": 1.1580,
               "conv_same_pro_stats": 1.1905}
ATTENTION = ("attn_qkv_fwd", "attn_qkv_bwd", "attn_fwd", "attn_bwd")
# the conv wrappers, bf16 on the tensor cores, fp32 not: the weight
# gradients (K4 in each form, K7) and K3 in each form
DW = ("conv_dw", "conv_dw_pro", "conv_dw_s2d", "conv_dw_gtap")
K3 = ("conv_valid", "conv_valid_pro", "conv_valid_s2d", "conv_same",
      "conv_same_pro", "conv_same_pro_stats")
# (name, generator_conv, loss resolution, steps, SAME route) of the other
# paths; step 0 is an entire-A step, the rest are regular: step 1 runs
# eagerly before the regular graph's capture, the later ones replay it
PATHS = (("480", "auto", 480, 4, False), ("fused", "fused", 224, 6, False),
         ("pallas", "pallas", 224, 6, False),
         ("fused_same", "fused", 224, 6, True),
         ("pallas_same", "pallas", 224, 6, True))
SKIP3_STEPS = 3       # the fused SAME steps of the 3x3-skip generator
# replay against eager (phases 3 and 4b): the graphs' losses and update
# may differ from an eager run's by REPLAY_MULT x the spread of two eager
# runs plus a floor (relative)
REPLAY_MULT, REPLAY_LOSS_FLOOR, REPLAY_UPDATE_FLOOR = 4.0, 1e-4, 1e-3


def mark(t_start: float) -> None:
    """The seconds since the start, printed before each phase."""
    print(f"[{time.perf_counter() - t_start:.1f} s]")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2, repeats: int = 5) -> float:
    """Median over `repeats` of the mean device time of `iters`
    back-to-back calls, by CUDA events. Before each batch the stream
    sleeps until the host has queued every call of it, so the time is the
    device's alone even where a call's host work (the wrapper, ctypes)
    outlasts its kernels, as it does for K1 at 785 tokens."""
    import torch
    queue_s = []                  # host time per call, the first allocates
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        queue_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    # spin cycles at up to 2 GHz (the H100's SM clock peaks at 1.98), at
    # most 0.1 s
    cycles = int(2e9 * min(2 * min(queue_s) * iters + 2e-4, 0.1))
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, ref, rtol: float, why: str) -> float:
    """Max abs error; fails unless it is within rtol * max|ref|."""
    import torch
    torch.cuda.synchronize()
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = (g - r).abs().max().item()
    tol = rtol * max(r.abs().max().item(), 1e-30)
    status = "ok" if err <= tol else "MISMATCH"
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e} = {rtol:g} x "
          f"max|plain|; {why}) {status}")
    if err > tol:
        fail(f"{name} disagrees with its plain version")
    return err


RTOL = {"bfloat16": (1.6e-2, "bf16 output rounding, up to 4 ulps at the "
                     "largest value, plus another fp32 summation order"),
        "float32": (1e-4, "fp32 sums over up to 10^4 terms in another "
                    "order")}
DW_WHY = "fp32 output; fp32 sums over 10^5-10^6 pixels in another order"


def timed(kernel, plain, library, nbytes, flops, dtype_name, tag, shape):
    """Times of kernel, plain version and library yardstick, with the
    bound from this call's bytes and operations; printed."""
    d = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
             library_ms=time_ms(library), nbytes=nbytes, flops=flops,
             dtype=dtype_name, shape=shape)
    b, by = bound_ms(nbytes, flops, dtype_name)
    print(f"  time {tag} {shape}: kernel {d['ms']:.4f} ms "
          f"({flops / d['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{d['plain_ms']:.4f} ms, library {d['library_ms']:.4f} ms, "
          f"bound {b:.4f} ms ({by})")
    return d


def check_attention(torch, attn, rows):
    H, dh, scale = 12, 64, 0.125
    D = H * dh
    g_cpu = torch.Generator().manual_seed(1)
    errs = {"attn_qkv_fwd": 0.0, "attn_qkv_bwd": 0.0}
    main = {}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        rtol, why = RTOL[dtype_name]
        for B, N in ((2, 785), (1, 1037)):
            qkv = torch.randn(B, N, 3 * D, generator=g_cpu).to("cuda", dt)
            g = torch.randn(B, N, D, generator=g_cpu).to("cuda", dt)
            tag = f"[{B},{N},{3 * D}] {dtype_name}"
            out_k = attn.attn_qkv_fwd_cuda(qkv, H, scale)
            out_p = attn.attention_qkv_plain(qkv, H, scale)
            errs["attn_qkv_fwd"] = max(errs["attn_qkv_fwd"], compare(
                f"K1 attn_qkv_fwd {tag}", out_k, out_p, rtol, why))
            d_k = attn.attn_qkv_bwd_cuda(qkv, g, H, scale)
            d_p = attn.attention_qkv_bwd_plain(qkv, g, H, scale)
            errs["attn_qkv_bwd"] = max(errs["attn_qkv_bwd"], compare(
                f"K2 attn_qkv_bwd {tag}", d_k, d_p, rtol, why))
            if dtype_name != "bfloat16":
                continue
            check_bitwise(torch, f"K2 {tag}", (d_k,),
                          (attn.attn_qkv_bwd_cuda(qkv, g, H, scale),))
            if (B, N) != (2, 785):
                fl = 4 * B * H * N * N * dh
                time_kernel("K1", lambda: attn.attn_qkv_fwd_cuda(
                    qkv, H, scale), fl, tag)
                time_kernel("K2", lambda: attn.attn_qkv_bwd_cuda(
                    qkv, g, H, scale), 2.5 * fl, tag)
                continue
            isz = qkv.element_size()
            q, k, v = [t.contiguous() for t in attn._split_heads(qkv, H)]
            gh = g.reshape(B, N, H, dh).permute(0, 2, 1, 3).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            main["attn_qkv_fwd"] = timed(
                lambda: attn.attn_qkv_fwd_cuda(qkv, H, scale),
                lambda: attn.attention_qkv_plain(qkv, H, scale),
                lambda: sdpa(q, k, v, scale=scale),
                4 * B * N * D * isz, 4 * B * H * N * N * dh, dtype_name,
                "K1", tag)
            qr, kr, vr = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = sdpa(qr, kr, vr, scale=scale)
            main["attn_qkv_bwd"] = timed(
                lambda: attn.attn_qkv_bwd_cuda(qkv, g, H, scale),
                lambda: attn.attention_qkv_bwd_plain(qkv, g, H, scale),
                lambda: torch.autograd.grad(o, (qr, kr, vr), gh,
                                            retain_graph=True),
                7 * B * N * D * isz, 10 * B * H * N * N * dh, dtype_name,
                "K2", tag)
    for name in errs:
        rows[name].update(main[name], max_abs_err=errs[name])
        print_beside_previous(name, rows[name])


def time_kernel(kid, call, flops, tag):
    """An attention kernel timed alone at a shape `timed` leaves out,
    with TFLOP/s."""
    ms = time_ms(call)
    print(f"  time {kid} {tag}: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s)")


def print_beside_previous(name, row):
    print(f"  {name} {row['shape']}: {row['ms']:.4f} ms this run, "
          f"{PREVIOUS_MS[name]:.4f} ms for the previous kernels (PERF.md)")


def check_split_attention(torch, attn, rows):
    """K5/K6 (bf16: the tensor-core kernels) at the 480-px path's shapes:
    [2,12,3601,64] (two square crops) and [1,12,2701,64] (the entire A
    image); K6 twice on one input, bitwise equal."""
    H, dh, scale = 12, 64, 0.125
    gen = torch.Generator().manual_seed(4)
    dt, dtype_name = torch.bfloat16, "bfloat16"
    rtol, why = RTOL[dtype_name]
    errs = {"attn_fwd": 0.0, "attn_bwd": 0.0}
    for B, N in ((2, 3601), (1, 2701)):
        q, k, v, g = (torch.randn(B, H, N, dh, generator=gen).to("cuda", dt)
                      for _ in range(4))
        tag = f"[{B},{H},{N},{dh}] {dtype_name}"
        errs["attn_fwd"] = max(errs["attn_fwd"], compare(
            f"K5 attn_fwd {tag}", attn.attn_fwd_cuda(q, k, v, scale),
            attn.attention_plain(q, k, v, scale), rtol, why))
        got = attn.attn_bwd_cuda(q, k, v, g, scale)
        want = attn.attention_bwd_plain(q, k, v, g, scale)
        for part, a, b in zip(("dq", "dk", "dv"), got, want):
            errs["attn_bwd"] = max(errs["attn_bwd"], compare(
                f"K6 attn_bwd {part} {tag}", a, b, rtol, why))
        check_bitwise(torch, f"K6 {tag}", got,
                      attn.attn_bwd_cuda(q, k, v, g, scale))
        del got, want
        if N != 3601:
            fl = 4 * B * H * N * N * dh
            time_kernel("K5", lambda: attn.attn_fwd_cuda(q, k, v, scale), fl,
                        tag)
            time_kernel("K6", lambda: attn.attn_bwd_cuda(q, k, v, g, scale),
                        2.5 * fl, tag)
            continue
        isz = q.element_size()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows["attn_fwd"].update(timed(
            lambda: attn.attn_fwd_cuda(q, k, v, scale),
            lambda: attn.attention_plain(q, k, v, scale),
            lambda: sdpa(q, k, v, scale=scale),
            4 * B * H * N * dh * isz, 4 * B * H * N * N * dh, dtype_name,
            "K5", tag))
        qr, kr, vr = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = sdpa(qr, kr, vr, scale=scale)
        rows["attn_bwd"].update(timed(
            lambda: attn.attn_bwd_cuda(q, k, v, g, scale),
            lambda: attn.attention_bwd_plain(q, k, v, g, scale),
            lambda: torch.autograd.grad(o, (qr, kr, vr), g,
                                        retain_graph=True),
            7 * B * H * N * dh * isz, 10 * B * H * N * N * dh, dtype_name,
            "K6", tag))
        del o, qr, kr, vr
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]
        print_beside_previous(name, rows[name])


# (B, H, N, n_valid, seed) of the tensor-core K5/K6's edge cases: N under
# one 64-row box, one past a block of 128 and of 256 rows, B*H = 1 with
# masked keys (key blocks wholly past n_valid: zero dk, dv without a loop),
# and two more seeds at the 480 path's N = 3601
SPLIT_EDGES = ((1, 2, 17, 0, 20), (2, 3, 129, 0, 21), (2, 3, 257, 0, 22),
               (1, 1, 300, 211, 23), (2, 12, 3601, 0, 24),
               (2, 12, 3601, 0, 25))


def check_split_edge_cases(torch, attn):
    """The bf16 (tensor-core) K5/K6 at SPLIT_EDGES against their plain
    versions; masked keys get exactly zero dk and dv."""
    rtol, why = RTOL["bfloat16"]
    for B, H, N, n_valid, seed in SPLIT_EDGES:
        gen = torch.Generator().manual_seed(seed)
        q, k, v, g = (torch.randn(B, H, N, 64, generator=gen).to(
            "cuda", torch.bfloat16) for _ in range(4))
        tag = f"[{B},{H},{N},64] n_valid={n_valid} seed {seed} bfloat16"
        compare(f"K5 {tag}", attn.attn_fwd_cuda(q, k, v, 0.125, n_valid),
                attn.attention_plain(q, k, v, 0.125, n_valid), rtol, why)
        got = attn.attn_bwd_cuda(q, k, v, g, 0.125, n_valid)
        for part, a, b in zip(("dq", "dk", "dv"), got,
                              attn.attention_bwd_plain(q, k, v, g, 0.125,
                                                       n_valid)):
            compare(f"K6 {part} {tag}", a, b, rtol, why)
        if n_valid and not all(bool((t[:, :, n_valid:] == 0).all())
                               for t in got[1:]):
            fail(f"K6 {tag}: masked keys with nonzero dk or dv")


# (B, H, N, n_valid, seed) of the tensor-core K1/K2's edge cases: N under
# one 64-row box, one past a block of 128 and of 256 rows; B = 1 and 2;
# ViT-S's 6 heads (D = 384) and ViT-B's 12; masked keys, with key blocks
# wholly past n_valid in the last case
QKV_EDGES = ((1, 6, 17, 0, 30), (2, 12, 129, 0, 31), (2, 6, 257, 0, 32),
             (1, 12, 100, 77, 33), (2, 6, 300, 100, 34),
             # ViT-L/14's 16 heads (D = 1024): one row past a 64-row box,
             # and masked keys with key blocks wholly past n_valid
             (1, 16, 65, 0, 35), (2, 16, 257, 100, 36))
# The DINOv2 paths' fused-qkv shapes (B, H, N): ViT-L/14's two 224 crops
# (16 x 16 patches and CLS), its entire A (900 x 1200 resized to 224 x 298:
# 16 x 21 patches), dinov2_vitb14_reg's crops (CLS, 4 registers, 256
# patches)
DINOV2_QKV = ((2, 16, 257), (1, 16, 337), (2, 12, 261))
# Config c's fused-qkv shape (B, H, N): eight pairs' generated crops (or
# their targets) through ViT-B/8 at 785 tokens in one batch of 16
PAIRS_QKV = ((16, 12, 785),)
# The inversion's fused-qkv shape (B, H, N): limes at resize 224 is 224 x
# 281, 28 x 35 patches of 8 and CLS through ViT-B/8 (bf16 by default, fp32
# one flag away)
INVERSION_QKV = ((1, 12, 981),)


# The mesh phase's tensor-parallel attention shapes. K1/K2 (B, H, N): a
# dp = 2 group of config c's pairs (4 pairs, one generated crop each of A
# and B: a batch of 8) through ViT-B/8 at tp = 2, 6 heads a rank (local D
# 384). K5/K6 (B, H, N, dh): the same batch at tp = 4, 3 heads a rank:
# local D 192 fails the fused-qkv gate (D % 128), so the heads are split.
MESH_QKV = ((8, 6, 785),)
MESH_SPLIT = ((8, 3, 785, 64),)


def check_split_shapes(torch, attn, shapes):
    """K5/K6 (bf16) at `shapes` against their plain versions, K6 twice on
    one input (bitwise equal), timed beside the plain versions and SDPA
    with the bound of its bytes and operations, every launch on the tensor
    cores. Returns {(kernel, shape): times and max_abs_err}."""
    rtol, why = RTOL["bfloat16"]
    dt, dtype_name, scale = torch.bfloat16, "bfloat16", 0.125
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = (attn.attn_fwd_cuda, attn.attn_bwd_cuda)
    counts = [(f.launches, f.tc_launches) for f in fns]
    out = {}
    for B, H, N, dh in shapes:
        gen = torch.Generator().manual_seed(50 + N)
        q, k, v, g = (torch.randn(B, H, N, dh, generator=gen).to("cuda", dt)
                      for _ in range(4))
        tag = f"[{B},{H},{N},{dh}] {dtype_name}"
        err5 = compare(f"K5 {tag}", attn.attn_fwd_cuda(q, k, v, scale),
                       attn.attention_plain(q, k, v, scale), rtol, why)
        got = attn.attn_bwd_cuda(q, k, v, g, scale)
        want = attn.attention_bwd_plain(q, k, v, g, scale)
        err6 = max(compare(f"K6 {part} {tag}", a, b, rtol, why)
                   for part, a, b in zip(("dq", "dk", "dv"), got, want))
        check_bitwise(torch, f"K6 {tag}", got,
                      attn.attn_bwd_cuda(q, k, v, g, scale))
        del got, want
        isz, fl = q.element_size(), 4 * B * H * N * N * dh
        out[("K5", tag)] = dict(timed(
            lambda: attn.attn_fwd_cuda(q, k, v, scale),
            lambda: attn.attention_plain(q, k, v, scale),
            lambda: sdpa(q, k, v, scale=scale),
            4 * B * H * N * dh * isz, fl, dtype_name, "K5", tag),
            max_abs_err=err5)
        qr, kr, vr = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = sdpa(qr, kr, vr, scale=scale)
        out[("K6", tag)] = dict(timed(
            lambda: attn.attn_bwd_cuda(q, k, v, g, scale),
            lambda: attn.attention_bwd_plain(q, k, v, g, scale),
            lambda: torch.autograd.grad(o, (qr, kr, vr), g,
                                        retain_graph=True),
            7 * B * H * N * dh * isz, 2.5 * fl, dtype_name, "K6", tag),
            max_abs_err=err6)
        del o, qr, kr, vr
    calls = [(f.launches - n, f.tc_launches - t)
             for f, (n, t) in zip(fns, counts)]
    if any(n != t for n, t in calls):
        fail(f"K5/K6 launches off the tensor cores at {shapes}: {calls}")
    return out


def check_qkv_edge_cases(torch, attn):
    """The bf16 (tensor-core) K1/K2 at QKV_EDGES against their plain
    versions, dq, dk and dv compared apart; masked keys get exactly zero dk
    and dv."""
    rtol, why = RTOL["bfloat16"]
    for B, H, N, n_valid, seed in QKV_EDGES:
        gen = torch.Generator().manual_seed(seed)
        D = 64 * H
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda",
                                                          torch.bfloat16)
        g = torch.randn(B, N, D, generator=gen).to("cuda", torch.bfloat16)
        tag = f"[{B},{N},{3 * D}] H={H} n_valid={n_valid} seed {seed} bfloat16"
        compare(f"K1 {tag}", attn.attn_qkv_fwd_cuda(qkv, H, 0.125, n_valid),
                attn.attention_qkv_plain(qkv, H, 0.125, n_valid), rtol, why)
        got = attn.attn_qkv_bwd_cuda(qkv, g, H, 0.125, n_valid)
        want = attn.attention_qkv_bwd_plain(qkv, g, H, 0.125, n_valid)
        for i, part in enumerate(("dq", "dk", "dv")):
            sl = slice(i * D, (i + 1) * D)
            compare(f"K2 {part} {tag}", got[..., sl], want[..., sl], rtol,
                    why)
        if n_valid and not bool((got[:, n_valid:, D:] == 0).all()):
            fail(f"K2 {tag}: masked keys with nonzero dk or dv")


def check_qkv_shapes(torch, attn, shapes, dtype_name="bfloat16"):
    """K1/K2 at `shapes` against their plain versions, each twice on one
    input (bitwise equal), timed beside its plain version and SDPA
    (forward; backward by autograd) with the bound of its bytes and
    operations; in bf16 every launch on the tensor cores (fp32 runs the
    CUDA-core kernels). Returns {(kernel, shape): times and
    max_abs_err}."""
    rtol, why = RTOL[dtype_name]
    dt = getattr(torch, dtype_name)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd, bwd = attn.attn_qkv_fwd_cuda, attn.attn_qkv_bwd_cuda
    counts = [(f.launches, f.tc_launches) for f in (fwd, bwd)]
    out = {}
    for B, H, N in shapes:
        gen = torch.Generator().manual_seed(40 + N)
        D, dh, scale = 64 * H, 64, 0.125
        qkv = torch.randn(B, N, 3 * D, generator=gen).to("cuda", dt)
        g = torch.randn(B, N, D, generator=gen).to("cuda", dt)
        tag = f"[{B},{N},{3 * D}] H={H} {dtype_name}"
        o = attn.attn_qkv_fwd_cuda(qkv, H, scale)
        err1 = compare(f"K1 {tag}", o, attn.attention_qkv_plain(
            qkv, H, scale), rtol, why)
        check_bitwise(torch, f"K1 {tag}", (o,),
                      (attn.attn_qkv_fwd_cuda(qkv, H, scale),))
        d = attn.attn_qkv_bwd_cuda(qkv, g, H, scale)
        want = attn.attention_qkv_bwd_plain(qkv, g, H, scale)
        err2 = 0.0
        for i, part in enumerate(("dq", "dk", "dv")):
            sl = slice(i * D, (i + 1) * D)
            err2 = max(err2, compare(f"K2 {part} {tag}", d[..., sl],
                                     want[..., sl], rtol, why))
        check_bitwise(torch, f"K2 {tag}", (d,),
                      (attn.attn_qkv_bwd_cuda(qkv, g, H, scale),))
        del want
        isz = qkv.element_size()
        q, k, v = [t.contiguous() for t in attn._split_heads(qkv, H)]
        gh = g.reshape(B, N, H, dh).permute(0, 2, 1, 3).contiguous()
        fl = 4 * B * H * N * N * dh
        out[("K1", tag)] = dict(timed(
            lambda: attn.attn_qkv_fwd_cuda(qkv, H, scale),
            lambda: attn.attention_qkv_plain(qkv, H, scale),
            lambda: sdpa(q, k, v, scale=scale),
            4 * B * N * D * isz, fl, dtype_name, "K1", tag),
            max_abs_err=err1)
        qr, kr, vr = [t.detach().requires_grad_(True) for t in (q, k, v)]
        ro = sdpa(qr, kr, vr, scale=scale)
        out[("K2", tag)] = dict(timed(
            lambda: attn.attn_qkv_bwd_cuda(qkv, g, H, scale),
            lambda: attn.attention_qkv_bwd_plain(qkv, g, H, scale),
            lambda: torch.autograd.grad(ro, (qr, kr, vr), gh,
                                        retain_graph=True),
            7 * B * N * D * isz, 2.5 * fl, dtype_name, "K2", tag),
            max_abs_err=err2)
        del ro, qr, kr, vr
        torch.cuda.empty_cache()
    calls = [(f.launches - n, f.tc_launches - t)
             for f, (n, t) in zip((fwd, bwd), counts)]
    if dtype_name == "bfloat16" and any(n != t for n, t in calls):
        fail(f"K1/K2 launches off the tensor cores at {shapes}: {calls}")
    return out


def sass_counts(build, lib):
    """{kernel: [HGMMA, HMMA]} instruction counts of the built library
    `lib` (cuobjdump -sass), printed."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build._target(lib))],
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "HMMA" in line
    for f, (hg, hm) in counts.items():
        print(f"  sass {lib} {f}: HGMMA {hg}, HMMA {hm}")
    return counts


def check_tensor_cores(build):
    """Every tensor-core kernel (a name with "_tc") must hold its
    instructions: HGMMA (wgmma) in the attention library's (the bf16 route
    of K1/K2 and K5/K6), HMMA (mma.sync) in the conv library's (the bf16
    route of K3 and of K4/K7); each library must have such kernels, the
    conv library a forward one (conv_fwd_tc_kernel) and a weight-gradient
    one, and the fp32 conv kernels (K3's, K4's and K7's CUDA-core kernels)
    hold neither."""
    att = sass_counts(build, "attention")
    tc = [f for f in att if "_tc" in f]
    if not tc or not all(att[f][0] for f in tc):
        fail(f"attention tensor-core kernels missing or without HGMMA: {att}")
    cnv = sass_counts(build, "conv")
    tc = [f for f in cnv if "_tc" in f]
    if (not any("conv_fwd_tc_kernel" in f for f in tc)
            or not any("conv_dw_tc_kernel" in f for f in tc)
            or not all(cnv[f][1] for f in tc)):
        fail(f"conv tensor-core kernels missing or without HMMA: {cnv}")
    fp32 = [f for f in cnv if "conv_dw_partial" in f
            or "conv_dw_gtap_kernel" in f or "conv_dw_reduce" in f
            or "conv_fwd_kernel" in f]
    if (not any("conv_fwd_kernel" in f for f in fp32)
            or not any("conv_dw_partial" in f for f in fp32)
            or any(sum(cnv[f]) for f in fp32)):
        fail(f"fp32 conv kernels missing or on the tensor cores: "
             f"{ {f: cnv[f] for f in fp32} }")


def print_ptxas(build):
    """Registers, stack and spills of every kernel, from the build logs."""
    for name in build.SOURCES:
        fn = None
        for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("spill" in line or "registers" in line):
                print(f"  ptxas {name} {fn}: {line.split(':', 1)[-1].strip()}")


def check_conv(torch, conv, rows):
    """K3 (forward and dx) and K4 at the two sites the auto rule sends to
    them, as the main path calls them: the input unpadded with an implicit
    1-pixel zero border; each twice on one input, bitwise."""
    F = torch.nn.functional
    dt, dtype_name = torch.bfloat16, "bfloat16"
    rtol, why = RTOL[dtype_name]
    gen = torch.Generator().manual_seed(2)
    errs = {"conv_valid": 0.0, "conv_dw": 0.0}
    for site, (cin, cout, hw) in enumerate(((36, 16, 896), (68, 32, 448))):
        B, k = 2, 3
        x = torch.randn(B, cin, hw, hw, generator=gen).to("cuda", dt)
        w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to("cuda", dt)
        g = torch.randn(B, cout, hw, hw, generator=gen).to("cuda", dt)
        w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
        tag = f"site {site} [{B},{cin},{hw},{hw}]->[{B},{cout},{hw},{hw}] pad 1"
        for part, a, b in (("fwd", x, w), ("dx", g, w_flip)):
            y = conv.conv_valid_cuda(a, b, 1)
            errs["conv_valid"] = max(errs["conv_valid"], compare(
                f"K3 conv_valid {part} {tag}", y,
                conv.conv_valid_plain(a, b, 1), rtol, why))
            check_bitwise(torch, f"K3 conv_valid {part} {tag}", (y,),
                          (conv.conv_valid_cuda(a, b, 1),))
            del y
        dw = conv.conv_dw_cuda(x, g, k, 1)
        errs["conv_dw"] = max(errs["conv_dw"], compare(
            f"K4 conv_dw {tag}", dw,
            conv.conv_dw_plain(F.pad(x, (1, 1, 1, 1)), g, k),
            RTOL["float32"][0], DW_WHY))
        check_bitwise(torch, f"K4 {tag}", (dw,),
                      (conv.conv_dw_cuda(x, g, k, 1),))
        isz = x.element_size()
        flops = 2 * B * hw * hw * cout * cin * k * k
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        wf_oihw = w_flip.permute(3, 2, 0, 1).contiguous()
        nbytes = (x.numel() + g.numel() + w.numel()) * isz
        fwd = timed(lambda: conv.conv_valid_cuda(x, w, 1),
                    lambda: conv.conv_valid_plain(x, w, 1),
                    lambda: F.conv2d(x, w_oihw, padding=1), nbytes, flops,
                    dtype_name, "K3 fwd", tag)
        timed(lambda: conv.conv_valid_cuda(g, w_flip, 1),
              lambda: conv.conv_valid_plain(g, w_flip, 1),
              lambda: F.conv2d(g, wf_oihw, padding=1), nbytes, flops,
              dtype_name, "K3 dx", tag)
        dw = timed(lambda: conv.conv_dw_cuda(x, g, k, 1),
                   lambda: conv.conv_dw_plain(F.pad(x, (1, 1, 1, 1)), g, k),
                   lambda: torch.nn.grad.conv2d_weight(x, w_oihw.shape, g,
                                                       padding=1),
                   (x.numel() + g.numel()) * isz + w.numel() * 4, flops,
                   dtype_name, "K4", tag)
        if site == 0:
            rows["conv_valid"].update(fwd, shape=f"fwd {tag}")
            rows["conv_dw"].update(dw)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]


# The generator_conv=fused sites of the 896 canvas that take the prologue
# kernels: (name, Cin, Cout, input width, k, negslope).
FUSED_SITES = (("down_conv2 s0", 16, 16, 448, 3, 0.2),
               ("skip_conv s1", 16, 4, 448, 1, 0.2),
               ("up_conv s1", 68, 32, 448, 3, 1.0),
               ("up1x1 s1", 32, 32, 448, 1, 0.2),
               ("up_conv s0", 36, 16, 896, 3, 1.0),
               ("up1x1 s0", 16, 16, 896, 1, 0.2),
               ("out_conv", 16, 3, 896, 1, 0.2))


def check_conv_pro(torch, conv, rows):
    """K3'/K4' pro at the seven fused sites, two BatchNorm stacks (G = 2
    rows of scale/shift). The library yardsticks (F.conv2d,
    conv2d_weight) run on the already-normalised input: they exclude the
    prologue."""
    F = torch.nn.functional
    dt, dtype_name = torch.bfloat16, "bfloat16"
    rtol, why = RTOL[dtype_name]
    gen = torch.Generator().manual_seed(5)
    errs = {"conv_valid_pro": 0.0, "conv_dw_pro": 0.0}
    for name, cin, cout, hw, k, ns in FUSED_SITES:
        B, pad = 2, (k - 1) // 2
        x = torch.randn(B, cin, hw, hw, generator=gen).to("cuda", dt)
        w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to("cuda", dt)
        g = torch.randn(B, cout, hw, hw, generator=gen).to("cuda", dt)
        sc = (0.5 + torch.rand(2, cin, generator=gen)).cuda()
        sh = torch.randn(2, cin, generator=gen).cuda()
        tag = f"{name} [{B},{cin},{hw},{hw}]->[{B},{cout},{hw},{hw}] k={k} ns={ns}"
        y = conv.conv_valid_pro_cuda(x, w, sc, sh, ns, pad)
        errs["conv_valid_pro"] = max(errs["conv_valid_pro"], compare(
            f"K3' pro {tag}", y,
            conv.conv_valid_pro_plain(x, w, sc, sh, ns, pad), rtol, why))
        check_bitwise(torch, f"K3' pro {tag}", (y,),
                      (conv.conv_valid_pro_cuda(x, w, sc, sh, ns, pad),))
        del y
        dw = conv.conv_dw_pro_cuda(x, g, k, sc, sh, ns, pad)
        errs["conv_dw_pro"] = max(errs["conv_dw_pro"], compare(
            f"K4' pro {tag}", dw,
            conv.conv_dw_pro_plain(x, g, k, sc, sh, ns, pad),
            RTOL["float32"][0], DW_WHY))
        check_bitwise(torch, f"K4' pro {tag}", (dw,),
                      (conv.conv_dw_pro_cuda(x, g, k, sc, sh, ns, pad),))
        isz = x.element_size()
        flops = 2 * B * hw * hw * cout * cin * k * k + 3 * x.numel()
        z = conv.prologue_plain(x, sc, sh, ns)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        fwd = timed(lambda: conv.conv_valid_pro_cuda(x, w, sc, sh, ns, pad),
                    lambda: conv.conv_valid_pro_plain(x, w, sc, sh, ns, pad),
                    lambda: F.conv2d(z, w_oihw, padding=pad),
                    (x.numel() + g.numel() + w.numel()) * isz, flops,
                    dtype_name, "K3' pro", tag)
        dw = timed(lambda: conv.conv_dw_pro_cuda(x, g, k, sc, sh, ns, pad),
                   lambda: conv.conv_dw_pro_plain(x, g, k, sc, sh, ns, pad),
                   lambda: torch.nn.grad.conv2d_weight(z, w_oihw.shape, g,
                                                       padding=pad),
                   (x.numel() + g.numel()) * isz + w.numel() * 4, flops,
                   dtype_name, "K4' pro", tag)
        if name == "up_conv s0":
            rows["conv_valid_pro"].update(fwd)
            rows["conv_dw_pro"].update(dw)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]


def check_conv_s2d(torch, conv, rows):
    """K3/K4 at k = 2 on stride-2 sites of generator_conv=pallas: the stem
    (down_conv1 of scale 0, 3 -> 16 channels from the 896 canvas: a
    [2,12,449,449] phase image) and down_conv1 of scale 1."""
    F = torch.nn.functional
    dt, dtype_name = torch.bfloat16, "bfloat16"
    rtol, why = RTOL[dtype_name]
    gen = torch.Generator().manual_seed(6)
    errs = {"conv_valid_s2d": 0.0, "conv_dw_s2d": 0.0}
    for name, cin, cout, hw in (("stem s0", 3, 16, 896),
                                ("down_conv1 s1", 16, 32, 448)):
        B, ho = 2, hw // 2
        x = torch.randn(B, cin, hw, hw, generator=gen).to("cuda", dt)
        w = (0.1 * torch.randn(3, 3, cin, cout, generator=gen)).to("cuda", dt)
        wk = conv.s2d_kernel(w).contiguous()
        g = torch.randn(B, cout, ho, ho, generator=gen).to("cuda", dt)
        tag = (f"{name} [{B},{cin},{hw},{hw}] (phase image "
               f"[{B},{4 * cin},{ho + 1},{ho + 1}])->[{B},{cout},{ho},{ho}]")
        y = conv.conv_valid_s2d_cuda(x, wk, 1, (ho, ho))
        errs["conv_valid_s2d"] = max(errs["conv_valid_s2d"], compare(
            f"K3 s2d {tag}", y,
            conv.conv_valid_pro_plain(x, wk, None, None, 1.0, 1, 2, (ho, ho)),
            rtol, why))
        check_bitwise(torch, f"K3 s2d {tag}", (y,),
                      (conv.conv_valid_s2d_cuda(x, wk, 1, (ho, ho)),))
        # its input gradient: the flipped phase kernel over g (border
        # k2 - 1), as ConvValidPro.backward calls it
        wk_flip = torch.flip(wk, dims=(0, 1)).transpose(2, 3).contiguous()
        y = conv.conv_valid_cuda(g, wk_flip, 1)
        compare(f"K3 s2d dx {tag}", y, conv.conv_valid_plain(g, wk_flip, 1),
                rtol, why)
        check_bitwise(torch, f"K3 s2d dx {tag}", (y,),
                      (conv.conv_valid_cuda(g, wk_flip, 1),))
        del y
        dw = conv.conv_dw_s2d_cuda(x, g, 2, 1)
        errs["conv_dw_s2d"] = max(errs["conv_dw_s2d"], compare(
            f"K4 s2d {tag}", dw,
            conv.conv_dw_pro_plain(x, g, 2, None, None, 1.0, 1, 2),
            RTOL["float32"][0], DW_WHY))
        check_bitwise(torch, f"K4 s2d {tag}", (dw,),
                      (conv.conv_dw_s2d_cuda(x, g, 2, 1),))
        isz = x.element_size()
        flops = 2 * B * ho * ho * cout * cin * 9      # the 9 real taps
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        fwd = timed(lambda: conv.conv_valid_s2d_cuda(x, wk, 1, (ho, ho)),
                    lambda: conv.conv_valid_pro_plain(x, wk, None, None, 1.0,
                                                      1, 2, (ho, ho)),
                    lambda: F.conv2d(x, w_oihw, stride=2, padding=1),
                    (x.numel() + g.numel() + w.numel()) * isz, flops,
                    dtype_name, "K3 s2d", tag)
        dw = timed(lambda: conv.conv_dw_s2d_cuda(x, g, 2, 1),
                   lambda: conv.conv_dw_pro_plain(x, g, 2, None, None, 1.0, 1,
                                                  2),
                   lambda: torch.nn.grad.conv2d_weight(
                       x, w_oihw.shape, g, stride=2, padding=1),
                   (x.numel() + g.numel()) * isz + w.numel() * 4, flops,
                   dtype_name, "K4 s2d", tag)
        if name == "stem s0":
            rows["conv_valid_s2d"].update(fwd)
            rows["conv_dw_s2d"].update(dw)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]


# The inversion net's K3/K4 sites on limes at resize 224 (224 x 281;
# generator_layout chw, generator_conv pallas): (name, Cin, Cout, H, W of
# the reflection-padded input, k, stride). Reflection padding is a copy
# outside the kernels (F.pad), so every site is a VALID conv: stride 1 at
# k = 7 and 5, stride 2 as the phase image's k2 = 4 and 3.
INV_SITES = (("up_conv s0", 36, 16, 230, 287, 7, 1),
             ("down_conv2 s0", 16, 16, 118, 147, 7, 1),
             ("up_conv s2", 132, 64, 60, 75, 5, 1),
             ("down_conv2 s2", 64, 64, 32, 40, 5, 1),
             ("down_conv1 s0", 32, 16, 230, 287, 7, 2),
             ("down_conv1 s1", 16, 32, 118, 147, 7, 2),
             ("down_conv1 s2", 32, 64, 60, 75, 5, 2),
             ("down_conv1 s3", 64, 128, 32, 40, 5, 2))
# the sites whose bf16 times stand in the JSON line for (wrapper, k)
INV_ROWS = {("conv_valid", 7): "up_conv s0", ("conv_valid", 5): "up_conv s2",
            ("conv_valid_s2d", 4): "down_conv1 s0",
            ("conv_valid_s2d", 3): "down_conv1 s2",
            ("conv_dw", 7): "up_conv s0", ("conv_dw", 5): "up_conv s2",
            ("conv_dw_s2d", 4): "down_conv1 s0",
            ("conv_dw_s2d", 3): "down_conv1 s2"}


def check_conv_inversion(torch, conv):
    """K3 (plain, pro and the input gradient) and K4 (plain and pro) at
    the inversion net's sites (INV_SITES: k = 7, 5 and the stride-2 phase
    kernels' k2 = 4, 3), bf16 (tensor cores) and fp32, each twice on one
    input (bitwise), and the bf16 forms timed against F.conv2d,
    conv2d_input and conv2d_weight. Returns {(wrapper, k): row} for
    INV_ROWS, max_abs_err the largest over that wrapper's sites at that
    k."""
    F = torch.nn.functional
    gen = torch.Generator().manual_seed(12)
    rows, errs = {}, {}

    def note(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    for name, cin, cout, H, W, k, stride in INV_SITES:
        ho, wo = (H - k) // stride + 1, (W - k) // stride + 1
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            rtol, why = RTOL[dtype_name]
            x = torch.randn(1, cin, H, W, generator=gen).to("cuda", dt)
            w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to(
                "cuda", dt)
            g = torch.randn(1, cout, ho, wo, generator=gen).to("cuda", dt)
            sc = (0.5 + torch.rand(1, cin, generator=gen)).cuda()
            sh = torch.randn(1, cin, generator=gen).cuda()
            wk = conv.s2d_kernel(w).contiguous() if stride == 2 else w
            kk = wk.shape[0]
            wk_flip = torch.flip(wk, dims=(0, 1)).transpose(2, 3).contiguous()
            fwd_name = "conv_valid_s2d" if stride == 2 else "conv_valid"
            dw_name = "conv_dw_s2d" if stride == 2 else "conv_dw"
            tag = (f"{name} [1,{cin},{H},{W}]->[1,{cout},{ho},{wo}] k={k}"
                   f"{f' (phase kernel k2={kk})' if stride == 2 else ''} "
                   f"{dtype_name}")
            calls = (
                ("K3", fwd_name, lambda: (
                    conv.conv_valid_s2d_cuda(x, wk, 0, (ho, wo))
                    if stride == 2 else conv.conv_valid_cuda(x, wk)),
                 lambda: conv.conv_valid_pro_plain(
                     x, wk, None, None, 1.0, 0, stride, (ho, wo)), rtol, why),
                ("K3' pro", "conv_valid_pro", lambda: conv.conv_valid_pro_cuda(
                    x, wk, sc, sh, 0.2, 0, stride, (ho, wo)),
                 lambda: conv.conv_valid_pro_plain(
                     x, wk, sc, sh, 0.2, 0, stride, (ho, wo)), rtol, why),
                ("K3 dx", "conv_valid", lambda: conv.conv_valid_cuda(
                    g, wk_flip, kk - 1),
                 lambda: conv.conv_valid_plain(g, wk_flip, kk - 1), rtol,
                 why),
                ("K4", dw_name, lambda: (
                    conv.conv_dw_s2d_cuda(x, g, kk, 0) if stride == 2
                    else conv.conv_dw_cuda(x, g, kk)),
                 lambda: conv.conv_dw_pro_plain(x, g, kk, None, None, 1.0, 0,
                                                stride),
                 RTOL["float32"][0], DW_WHY),
                ("K4' pro", "conv_dw_pro", lambda: conv.conv_dw_pro_cuda(
                    x, g, kk, sc, sh, 0.2, 0, stride),
                 lambda: conv.conv_dw_pro_plain(x, g, kk, sc, sh, 0.2, 0,
                                                stride),
                 RTOL["float32"][0], DW_WHY))
            for kid, wrapper, kernel, plain, tol, reason in calls:
                got = kernel()
                note((wrapper, kk), compare(f"{kid} {wrapper} {tag}", got,
                                            plain(), tol, reason))
                check_bitwise(torch, f"{kid} {wrapper} {tag}", (got,),
                              (kernel(),))
                del got
            if dtype_name != "bfloat16":
                continue
            isz = x.element_size()
            flops = 2 * ho * wo * cout * cin * k * k       # the real taps
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            nbytes = (x.numel() + g.numel() + w.numel()) * isz
            fwd = timed(calls[0][2], calls[0][3],
                        lambda: F.conv2d(x, w_oihw, stride=stride), nbytes,
                        flops, dtype_name, "K3", tag)
            timed(calls[2][2], calls[2][3],
                  lambda: torch.nn.grad.conv2d_input(x.shape, w_oihw, g,
                                                     stride=stride),
                  nbytes, flops, dtype_name, "K3 dx", tag)
            dw = timed(calls[3][2], calls[3][3],
                       lambda: torch.nn.grad.conv2d_weight(
                           x, w_oihw.shape, g, stride=stride),
                       (x.numel() + g.numel()) * isz + w.numel() * 4, flops,
                       dtype_name, "K4", tag)
            for (wrapper, kr), site in INV_ROWS.items():
                if site == name and kr == kk:
                    rows[(wrapper, kr)] = dict(
                        fwd if wrapper.startswith("conv_valid") else dw,
                        shape=tag)
        torch.cuda.empty_cache()
    for key, row in rows.items():
        row["max_abs_err"] = errs[key]
        b, by = bound_ms(row["nbytes"], row["flops"], row["dtype"])
        row.update(bound_ms=b, bound_by=by)
    return rows


@contextlib.contextmanager
def same_border(on: bool, tap_on_n: bool = True):
    """ops.conv.SAME_BORDER_KERNELS set to `on` and DW_TAP_ON_N to
    `tap_on_n` inside the block, both restored after it, whatever happens
    there."""
    from splice_tpu_torch.ops import conv
    old = conv.SAME_BORDER_KERNELS, conv.DW_TAP_ON_N
    conv.SAME_BORDER_KERNELS, conv.DW_TAP_ON_N = on, tap_on_n
    try:
        yield
    finally:
        conv.SAME_BORDER_KERNELS, conv.DW_TAP_ON_N = old


def check_bitwise(torch, name, first, second) -> None:
    """Two calls on the same input must agree bit for bit."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{name}: two calls on the same input differ")
    print(f"  {name}: two calls bitwise equal")


def check_stats(torch, conv, name, got, x, w, sc, sh, ns, rtol, why):
    """K3''' (out, s1, s2) against its plain version; the sums also against
    float64 sums of the kernel's own output. Returns the largest error."""
    out, s1, s2 = got
    p_out, p1, p2 = conv.conv_same_pro_stats_plain(x, w, sc, sh, ns)
    err = compare(f"K3''' out {name}", out, p_out, rtol, why)
    why_s = ("fp32 sums over up to 8e5 outputs per stack in another order; "
             "outputs that round to the other bf16 neighbour")
    err_s = max(compare(f"K3''' s1 {name}", s1, p1, RTOL["float32"][0], why_s),
                compare(f"K3''' s2 {name}", s2, p2, RTOL["float32"][0], why_s))
    o64 = conv.split_stacks(out, sc.shape[0]).double()
    compare(f"K3''' s1 {name} vs float64 sums of its own output", s1,
            o64.sum(dim=(1, 3, 4)), RTOL["float32"][0], "fp32 sums")
    compare(f"K3''' s2 {name} vs float64 sums of its own output", s2,
            o64.square().sum(dim=(1, 3, 4)), RTOL["float32"][0], "fp32 sums")
    return max(err, err_s)


# The sites the SAME route gives K3''/K3''' (fused: with the prologue and
# the statistics) and, where _gtap_better says so, K7: (name, Cin, Cout,
# width, negslope of the fused prologue, K7).
SAME_SITES = (("down_conv2 s0", 16, 16, 448, 0.2, False),
              ("up_conv s0", 36, 16, 896, 1.0, True),
              ("up_conv s1", 68, 32, 448, 1.0, True))


def check_conv_same(torch, conv, rows):
    """K3'' SAME (plain, pro and its input gradient), K3''' and K7 at the
    SAME route's sites, two BatchNorm stacks; each twice on the same
    input, bitwise. Times at
    up_conv s0; the library yardsticks run on the normalised input (they
    exclude the prologue): F.conv2d, F.conv2d plus the two per-stack sums
    of its output for K3''', conv2d_weight for K7 (K4's time at the site
    beside it: the same function contracted the other way round)."""
    F = torch.nn.functional
    dt, dtype_name = torch.bfloat16, "bfloat16"
    rtol, why = RTOL[dtype_name]
    gen = torch.Generator().manual_seed(7)
    errs = {"conv_same": 0.0, "conv_same_pro": 0.0,
            "conv_same_pro_stats": 0.0, "conv_dw_gtap": 0.0}
    for name, cin, cout, hw, ns, gtap in SAME_SITES:
        B, k = 2, 3
        x = torch.randn(B, cin, hw, hw, generator=gen).to("cuda", dt)
        w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to("cuda", dt)
        g = torch.randn(B, cout, hw, hw, generator=gen).to("cuda", dt)
        sc = (0.5 + torch.rand(2, cin, generator=gen)).cuda()
        sh = torch.randn(2, cin, generator=gen).cuda()
        tag = f"{name} [{B},{cin},{hw},{hw}]->[{B},{cout},{hw},{hw}] ns={ns}"
        w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
        for part, a, b in (("", x, w), (" dx", g, w_flip)):
            y = conv.conv_same_cuda(a, b)
            errs["conv_same"] = max(errs["conv_same"], compare(
                f"K3'' SAME{part} {tag}", y, conv.conv_same_plain(a, b),
                rtol, why))
            check_bitwise(torch, f"K3'' SAME{part} {tag}", (y,),
                          (conv.conv_same_cuda(a, b),))
        y = conv.conv_same_pro_cuda(x, w, sc, sh, ns)
        errs["conv_same_pro"] = max(errs["conv_same_pro"], compare(
            f"K3'' SAME pro {tag}", y,
            conv.conv_same_plain(x, w, sc, sh, ns), rtol, why))
        check_bitwise(torch, f"K3'' SAME pro {tag}", (y,),
                      (conv.conv_same_pro_cuda(x, w, sc, sh, ns),))
        del y
        st = conv.conv_same_pro_stats_cuda(x, w, sc, sh, ns)
        errs["conv_same_pro_stats"] = max(
            errs["conv_same_pro_stats"],
            check_stats(torch, conv, tag, st, x, w, sc, sh, ns, rtol, why))
        check_bitwise(torch, f"K3''' {tag}", st,
                      conv.conv_same_pro_stats_cuda(x, w, sc, sh, ns))
        del st
        if not gtap:
            # K4's SAME form: the dw that _gtap_better leaves with K4
            for pro in (False, True):
                ptag = f"{tag}{' pro' if pro else ''}"

                def k4_same():
                    if pro:
                        return conv.conv_dw_pro_cuda(x, g, k, sc, sh, ns, 1)
                    return conv.conv_dw_cuda(x, g, k, 1)

                dw = k4_same()
                compare(f"K4 SAME form {ptag}", dw, conv.conv_dw_pro_plain(
                    x, g, k, *((sc, sh, ns) if pro else (None, None, 1.0)),
                    1), RTOL["float32"][0], DW_WHY)
                check_bitwise(torch, f"K4 SAME form {ptag}", (dw,),
                              (k4_same(),))
        if gtap:
            for pro in (False, True):
                a = (sc, sh, ns) if pro else (None, None, 1.0)
                ptag = f"{tag}{' pro' if pro else ''}"
                dw = conv.conv_dw_gtap_cuda(x, g, k, *a, 1)
                errs["conv_dw_gtap"] = max(errs["conv_dw_gtap"], compare(
                    f"K7 {ptag}", dw, conv.conv_dw_gtap_plain(x, g, k, *a, 1),
                    RTOL["float32"][0], DW_WHY))
                check_bitwise(torch, f"K7 {ptag}", (dw,),
                              (conv.conv_dw_gtap_cuda(x, g, k, *a, 1),))
        if name != "up_conv s0":
            continue
        isz = x.element_size()
        flops = 2 * B * hw * hw * cout * cin * k * k
        nbytes = (x.numel() + g.numel() + w.numel()) * isz
        z = conv.prologue_plain(x, sc, sh, ns)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def conv_and_sums():
            y = F.conv2d(z, w_oihw, padding=1).float().view(2, 1, cout, hw, hw)
            return y.sum(dim=(1, 3, 4)), y.square().sum(dim=(1, 3, 4))

        rows["conv_same"].update(timed(
            lambda: conv.conv_same_cuda(x, w),
            lambda: conv.conv_same_plain(x, w),
            lambda: F.conv2d(x, w_oihw, padding=1), nbytes, flops,
            dtype_name, "K3'' SAME", tag))
        rows["conv_same_pro"].update(timed(
            lambda: conv.conv_same_pro_cuda(x, w, sc, sh, ns),
            lambda: conv.conv_same_plain(x, w, sc, sh, ns),
            lambda: F.conv2d(z, w_oihw, padding=1), nbytes,
            flops + 3 * x.numel(), dtype_name, "K3'' SAME pro", tag))
        rows["conv_same_pro_stats"].update(timed(
            lambda: conv.conv_same_pro_stats_cuda(x, w, sc, sh, ns),
            lambda: conv.conv_same_pro_stats_plain(x, w, sc, sh, ns),
            conv_and_sums, nbytes + 2 * 2 * cout * 4,
            flops + 3 * x.numel() + 3 * g.numel(), dtype_name,
            "K3''' (library: F.conv2d plus the two sums)", tag))
        rows["conv_dw_gtap"].update(timed(
            lambda: conv.conv_dw_gtap_cuda(x, g, k, None, None, 1.0, 1),
            lambda: conv.conv_dw_gtap_plain(x, g, k, None, None, 1.0, 1),
            lambda: torch.nn.grad.conv2d_weight(x, w_oihw.shape, g,
                                                padding=1),
            (x.numel() + g.numel()) * isz + w.numel() * 4, flops, dtype_name,
            "K7", tag))
        k4 = time_ms(lambda: conv.conv_dw_cuda(x, g, k, 1))
        rows["conv_dw_gtap"]["k4_ms"] = k4
        print(f"  time K4 at the same site (the x-tapped order): {k4:.4f} ms")
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]


def check_same_edge_cases(torch, conv):
    """The SAME route off its paths' shapes: W = 37, Cout over two channel
    chunks, H < k, two stacks with a scale of 1e-13 and a negative one
    under the statistics, VALID-mode K7 (border 0 on a padded input) at
    k = 3 and 2; bf16 and fp32."""
    gen = torch.Generator().manual_seed(8)

    def rnd(*shape, dt, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to("cuda", dt)

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        rtol, why = RTOL[dtype_name]
        for h in (9, 2):
            x = rnd(2, 20, h, 37, dt=dt)
            w = rnd(3, 3, 20, 40, dt=dt, scale=0.2)
            g = rnd(2, 40, h, 37, dt=dt)
            sc = (0.5 + torch.rand(2, 20, generator=gen)).cuda()
            sc[0, 3], sc[1, 5] = 1e-13, -0.7
            sh = torch.randn(2, 20, generator=gen).cuda()
            tag = f"[2,20,{h},37]->[2,40,{h},37] G=2 {dtype_name}"
            compare(f"K3'' SAME {tag}", conv.conv_same_cuda(x, w),
                    conv.conv_same_plain(x, w), rtol, why)
            compare(f"K3'' SAME pro {tag}",
                    conv.conv_same_pro_cuda(x, w, sc, sh, 0.2),
                    conv.conv_same_plain(x, w, sc, sh, 0.2), rtol, why)
            check_stats(torch, conv, tag,
                        conv.conv_same_pro_stats_cuda(x, w, sc, sh, 0.2),
                        x, w, sc, sh, 0.2, rtol, why)
            for a in ((None, None, 1.0), (sc, sh, 0.2)):
                compare(f"K7 SAME {tag}{'' if a[0] is None else ' pro'}",
                        conv.conv_dw_gtap_cuda(x, g, 3, *a, 1),
                        conv.conv_dw_gtap_plain(x, g, 3, *a, 1),
                        RTOL["float32"][0], DW_WHY)
        for k in (3, 2):
            xp = rnd(2, 20, 11, 39, dt=dt)
            g = rnd(2, 40, 12 - k, 40 - k, dt=dt)
            tag = f"VALID k={k} [2,20,11,39] {dtype_name}"
            compare(f"K7 {tag}", conv.conv_dw_gtap_cuda(xp, g, k),
                    conv.conv_dw_gtap_plain(xp, g, k), RTOL["float32"][0],
                    DW_WHY)
            compare(f"K7 {tag} against K4", conv.conv_dw_gtap_cuda(xp, g, k),
                    conv.conv_dw_cuda(xp, g, k), RTOL["float32"][0], DW_WHY)


# bf16 (tensor-core) K4/K7 edge cases: (label, B, Cin, Cout, H, W, k, pad,
# stride, BatchNorm stacks, K7). W = 37 and H < k; Cout 3 (out_conv) and
# 128, Cin 3 and 136; k = 1, 2, 3; stride 2 at odd sizes; two stacks; VALID
# K7 (border 0) at k = 2 and 3; the entire-A generator at B = 1 from the
# 900 x 1200 image: widths 1200, 600 and its deeper odd ones (75), heights
# 900 and 113.
DW_EDGES = (
    ("W=37", 2, 20, 40, 9, 37, 3, 1, 1, 0, False),
    ("H<k", 2, 20, 40, 2, 37, 3, 1, 1, 2, False),
    ("out_conv", 2, 16, 3, 33, 37, 1, 0, 1, 2, False),
    ("Cin 136 Cout 128", 2, 136, 128, 14, 14, 3, 1, 1, 2, False),
    ("Cin 3", 2, 3, 16, 20, 37, 3, 1, 1, 0, False),
    ("k=2 VALID", 2, 20, 24, 11, 39, 2, 0, 1, 2, False),
    ("s2d odd", 2, 3, 16, 13, 37, 3, 1, 2, 0, False),
    ("s2d odd pro", 2, 16, 32, 19, 75, 3, 1, 2, 2, False),
    ("K7 SAME W=37", 2, 20, 40, 9, 37, 3, 1, 1, 2, True),
    ("K7 SAME H<k", 2, 20, 40, 2, 37, 3, 1, 1, 0, True),
    ("K7 VALID k=3", 2, 20, 40, 11, 39, 3, 0, 1, 2, True),
    ("K7 VALID k=2", 2, 20, 40, 11, 39, 2, 0, 1, 0, True),
    ("entire-A up_conv s0", 1, 36, 16, 900, 1200, 3, 1, 1, 1, False),
    ("entire-A up_conv s1", 1, 68, 32, 450, 600, 3, 1, 1, 1, False),
    ("entire-A up_conv s4", 1, 132, 128, 57, 75, 3, 1, 1, 1, False),
    ("entire-A stem", 1, 3, 16, 900, 1200, 3, 1, 2, 0, False),
    ("entire-A down_conv1 s3", 1, 64, 128, 113, 150, 3, 1, 2, 1, False),
    ("entire-A K7 up_conv s0", 1, 36, 16, 900, 1200, 3, 1, 1, 1, True),
)


def tc_dw_launches(conv) -> int:
    """Tensor-core launches of the weight-gradient wrappers so far."""
    return sum(getattr(conv, f"{name}_cuda").tc_launches for name in DW)


def check_dw_tc_edge_cases(torch, conv):
    """The bf16 weight-gradient kernels at DW_EDGES against their plain
    versions (fp32 sums: 1e-4 x max|plain|), every launch on the tensor
    cores; stride 2 as the k2 phase-image dw, a scale of 1e-13 and a
    negative one in the first stack."""
    gen = torch.Generator().manual_seed(9)
    rtol = RTOL["float32"][0]
    for label, B, cin, cout, h, w, k, pad, stride, G, gtap in DW_EDGES:
        x = torch.randn(B, cin, h, w, generator=gen).to("cuda", torch.bfloat16)
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        kk = (k + 1) // 2 if stride == 2 else k
        g = torch.randn(B, cout, ho, wo, generator=gen).to("cuda",
                                                           torch.bfloat16)
        a = (None, None, 1.0)
        if G:
            sc = (0.5 + torch.rand(G, cin, generator=gen)).cuda()
            sc[0, 0] = 1e-13
            sc[0, cin - 1] = -0.7
            a = (sc, torch.randn(G, cin, generator=gen).cuda(), 0.2)
        tag = (f"{label} [{B},{cin},{h},{w}]->[{B},{cout},{ho},{wo}] k={k} "
               f"pad={pad} stride={stride} G={G} bfloat16")
        tc = tc_dw_launches(conv)
        if gtap:
            got = conv.conv_dw_gtap_cuda(x, g, k, *a, pad)
            want = conv.conv_dw_gtap_plain(x, g, k, *a, pad)
            name = "K7"
        elif G:
            got = conv.conv_dw_pro_cuda(x, g, kk, *a, pad, stride)
            want = conv.conv_dw_pro_plain(x, g, kk, *a, pad, stride)
            name = "K4' pro"
        elif stride == 2:
            got = conv.conv_dw_s2d_cuda(x, g, kk, pad)
            want = conv.conv_dw_pro_plain(x, g, kk, *a, pad, 2)
            name = "K4 s2d"
        else:
            got = conv.conv_dw_cuda(x, g, kk, pad)
            want = conv.conv_dw_pro_plain(x, g, kk, *a, pad)
            name = "K4"
        compare(f"{name} {tag}", got, want, rtol, DW_WHY)
        if tc_dw_launches(conv) != tc + 1:
            fail(f"{name} {tag}: the bf16 launch was not on the tensor cores")
        del x, g, got, want


# bf16 (tensor-core) K3 edge cases: (label, form, B, Cin, Cout, H, W, k,
# pad, stride, BatchNorm stacks). Forms: valid (conv_valid), same, pro
# (conv_valid_pro, at stride 1 or 2), same_pro, s2d, stats (K3''').
# W = 37 and H < k; Cin 3 and 136; Cout 3 (out_conv), 36 (the input
# gradient at up_conv s0), 68 (at up_conv s1) and 128 (two output-channel
# chunks); k = 1, 2, 3; stride 2 at odd sizes with and without the
# prologue; two stacks (a scale of 1e-13 and a negative one); K3''' at
# ragged sizes; the entire-A generator at B = 1 from the 900 x 1200 image:
# widths 1200, 600, 150 and 75, heights 900 and 113, with the input
# gradients of up_conv s0/s1.
K3_EDGES = (
    ("W=37", "valid", 2, 20, 40, 9, 37, 3, 1, 1, 0),
    ("H<k", "same_pro", 2, 20, 40, 2, 37, 3, 1, 1, 2),
    ("out_conv", "pro", 2, 16, 3, 33, 37, 1, 0, 1, 2),
    ("Cin 136 Cout 128", "pro", 2, 136, 128, 14, 14, 3, 1, 1, 2),
    ("Cin 3", "same", 2, 3, 16, 20, 37, 3, 1, 1, 0),
    ("Cout 36", "valid", 2, 16, 36, 19, 70, 3, 1, 1, 0),
    ("Cout 68", "same", 2, 32, 68, 19, 75, 3, 1, 1, 0),
    ("k=2 VALID", "valid", 2, 20, 24, 11, 39, 2, 0, 1, 0),
    ("s2d odd", "s2d", 2, 3, 16, 13, 37, 3, 1, 2, 0),
    ("s2d odd pro", "pro", 2, 16, 32, 19, 75, 3, 1, 2, 2),
    ("K3''' W=37", "stats", 2, 20, 40, 9, 37, 3, 1, 1, 2),
    ("K3''' H<k", "stats", 2, 20, 16, 2, 70, 3, 1, 1, 2),
    ("K3''' Cout 128", "stats", 2, 36, 128, 11, 21, 3, 1, 1, 2),
    ("entire-A up_conv s0", "valid", 1, 36, 16, 900, 1200, 3, 1, 1, 0),
    ("entire-A up_conv s0 dx", "valid", 1, 16, 36, 900, 1200, 3, 1, 1, 0),
    ("entire-A up_conv s1", "stats", 1, 68, 32, 450, 600, 3, 1, 1, 1),
    ("entire-A up_conv s1 dx", "same", 1, 32, 68, 450, 600, 3, 1, 1, 0),
    ("entire-A up_conv s4", "pro", 1, 132, 128, 57, 75, 3, 1, 1, 1),
    ("entire-A stem", "s2d", 1, 3, 16, 900, 1200, 3, 1, 2, 0),
    ("entire-A down_conv1 s3", "pro", 1, 64, 128, 113, 150, 3, 1, 2, 1),
)


def tc_k3_launches(conv) -> int:
    """Tensor-core launches of the K3 wrappers so far."""
    return sum(getattr(conv, f"{name}_cuda").tc_launches for name in K3)


def check_k3_tc_edge_cases(torch, conv):
    """The bf16 K3 forms at K3_EDGES against their plain versions (bf16:
    1.6e-2 x max|plain|; K3''' sums 1e-4), every launch on the tensor
    cores; stride 2 through the k2 phase kernel."""
    gen = torch.Generator().manual_seed(10)
    rtol, why = RTOL["bfloat16"]
    for label, form, B, cin, cout, h, w, k, pad, stride, G in K3_EDGES:
        x = torch.randn(B, cin, h, w, generator=gen).to("cuda", torch.bfloat16)
        wt = 0.1 * torch.randn(k, k, cin, cout, generator=gen)
        if stride == 2:
            wt = conv.s2d_kernel(wt)
        wt = wt.contiguous().to("cuda", torch.bfloat16)
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        a = (None, None, 1.0)
        if G:
            sc = (0.5 + torch.rand(G, cin, generator=gen)).cuda()
            sc[0, 0] = 1e-13
            sc[G - 1, cin - 1] = -0.7
            a = (sc, torch.randn(G, cin, generator=gen).cuda(), 0.2)
        tag = (f"{label} [{B},{cin},{h},{w}]->[{B},{cout},{ho},{wo}] k={k} "
               f"pad={pad} stride={stride} G={G} {form} bfloat16")
        want = conv.conv_valid_pro_plain(x, wt, *a, pad, stride, (ho, wo))
        tc = tc_k3_launches(conv)
        if form == "stats":
            check_stats(torch, conv, tag,
                        conv.conv_same_pro_stats_cuda(x, wt, *a), x, wt,
                        *a, rtol, why)
        else:
            got = {"valid": lambda: conv.conv_valid_cuda(x, wt, pad),
                   "same": lambda: conv.conv_same_cuda(x, wt),
                   "pro": lambda: conv.conv_valid_pro_cuda(
                       x, wt, *a, pad, stride, (ho, wo)),
                   "same_pro": lambda: conv.conv_same_pro_cuda(x, wt, *a),
                   "s2d": lambda: conv.conv_valid_s2d_cuda(
                       x, wt, pad, (ho, wo))}[form]()
            compare(f"K3 {tag}", got, want, rtol, why)
            del got
        if tc_k3_launches(conv) != tc + 1:
            fail(f"K3 {tag}: the bf16 launch was not on the tensor cores")
        del x, want


def check_edge_cases(torch, attn, conv):
    """Small shapes off the main paths: key masking (n_valid), N a multiple
    of the tiles, k = 1, fp32, Cout over two channel chunks, G = 2 rows,
    a scale near 0, odd sizes at stride 2."""
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, dt, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to("cuda", dt)

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        rtol, why = RTOL[dtype_name]
        for N, n_valid in ((100, 77), (64, 0)):
            qkv, g = rnd(1, N, 2304, dt=dt), rnd(1, N, 768, dt=dt)
            tag = f"[1,{N},2304] n_valid={n_valid} {dtype_name}"
            compare(f"K1 {tag}", attn.attn_qkv_fwd_cuda(qkv, 12, 0.125, n_valid),
                    attn.attention_qkv_plain(qkv, 12, 0.125, n_valid),
                    rtol, why)
            compare(f"K2 {tag}",
                    attn.attn_qkv_bwd_cuda(qkv, g, 12, 0.125, n_valid),
                    attn.attention_qkv_bwd_plain(qkv, g, 12, 0.125, n_valid),
                    rtol, why)
            q, k, v, gs = (rnd(2, 3, N, 64, dt=dt) for _ in range(4))
            tag = f"[2,3,{N},64] n_valid={n_valid} {dtype_name}"
            compare(f"K5 {tag}", attn.attn_fwd_cuda(q, k, v, 0.125, n_valid),
                    attn.attention_plain(q, k, v, 0.125, n_valid), rtol, why)
            for part, a, b in zip(
                    ("dq", "dk", "dv"),
                    attn.attn_bwd_cuda(q, k, v, gs, 0.125, n_valid),
                    attn.attention_bwd_plain(q, k, v, gs, 0.125, n_valid)):
                compare(f"K6 {part} {tag}", a, b, rtol, why)
        for k, cout in ((1, 8), (3, 40)):
            x = rnd(2, 20, 34 + k - 1, 130 + k - 1, dt=dt)
            w = rnd(k, k, 20, cout, dt=dt, scale=0.2)
            g = rnd(2, cout, 34, 130, dt=dt)
            tag = f"[2,20,{34 + k - 1},{129 + k}] k={k} Cout={cout} {dtype_name}"
            compare(f"K3 {tag}", conv.conv_valid_cuda(x, w),
                    conv.conv_valid_plain(x, w), rtol, why)
            w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
            compare(f"K3 dx {tag}", conv.conv_valid_cuda(g, w_flip, k - 1),
                    conv.conv_valid_plain(g, w_flip, k - 1), rtol, why)
            compare(f"K4 {tag}", conv.conv_dw_cuda(x, g, k),
                    conv.conv_dw_plain(x, g, k), RTOL["float32"][0],
                    "fp32 output; fp32 sums in another order")
            # the prologue, two stacks, one scale near 0 and one negative
            sc = (0.5 + torch.rand(2, 20, generator=gen)).cuda()
            sc[0, 3], sc[1, 5] = 1e-13, -0.7
            sh = torch.randn(2, 20, generator=gen).cuda()
            xs = rnd(2, 20, 33, 129, dt=dt)
            for stride in (1, 2):
                pad = (k - 1) // 2
                ho = (33 + 2 * pad - k) // stride + 1
                wo = (129 + 2 * pad - k) // stride + 1
                wk = w if stride == 1 else conv.s2d_kernel(w).contiguous()
                kk = wk.shape[0]
                gk = rnd(2, cout, ho, wo, dt=dt)
                tag = (f"[2,20,33,129] k={k} stride={stride} Cout={cout} G=2 "
                       f"{dtype_name}")
                compare(f"K3' pro {tag}", conv.conv_valid_pro_cuda(
                    xs, wk, sc, sh, 0.2, pad, stride, (ho, wo)),
                    conv.conv_valid_pro_plain(xs, wk, sc, sh, 0.2, pad,
                                              stride, (ho, wo)), rtol, why)
                compare(f"K4' pro {tag}", conv.conv_dw_pro_cuda(
                    xs, gk, kk, sc, sh, 0.2, pad, stride),
                    conv.conv_dw_pro_plain(xs, gk, kk, sc, sh, 0.2, pad,
                                           stride), RTOL["float32"][0],
                    "fp32 output; fp32 sums in another order")
                if stride == 2:
                    compare(f"K3 s2d {tag}", conv.conv_valid_s2d_cuda(
                        xs, wk, pad, (ho, wo)), conv.conv_valid_pro_plain(
                        xs, wk, None, None, 1.0, pad, 2, (ho, wo)), rtol, why)
                    compare(f"K4 s2d {tag}", conv.conv_dw_s2d_cuda(
                        xs, gk, kk, pad), conv.conv_dw_pro_plain(
                        xs, gk, kk, None, None, 1.0, pad, 2),
                        RTOL["float32"][0],
                        "fp32 output; fp32 sums in another order")


def small_setup(torch, dev, mode="auto", dinov2=False):
    """Phase 3's small fp32 configuration on `dev`: (cfg, pair, extractor),
    a 448 canvas and a two-block ViT of width 128: at 64 px, patch 8; or,
    with `dinov2`, a DINOv2 (patch 14, pos_embed made at 56 px, 4 register
    tokens, layer scale drawn in [0.5, 1.5] so that it matters) at 70 px:
    5 x 5 patches for the crops and 5 x 6 for the entire A, both
    interpolated."""
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.data import load_pair
    from splice_tpu_torch.models import extractor as ext_lib
    from splice_tpu_torch.models import vit as vit_lib
    from splice_tpu_torch.models.weights import init_vit_params
    from splice_tpu_torch.utils.tree import tree_map
    if dinov2:
        vcfg = vit_lib.VitConfig(patch_size=14, embed_dim=128, depth=2,
                                 num_heads=2, img_size=56,
                                 interpolate_offset=0.0,
                                 layerscale_init=1e-5, num_register_tokens=4)
    else:
        vcfg = vit_lib.VitConfig(patch_size=8, embed_dim=128, depth=2,
                                 num_heads=2, img_size=32)
    vparams = init_vit_params(vcfg, seed=5, device="cpu")
    if dinov2:
        gen = torch.Generator().manual_seed(6)
        for blk in vparams["blocks"]:
            for k in ("ls1", "ls2"):
                blk[k] = 0.5 + torch.rand(128, generator=gen)
    cfg = load_config(None, dict(
        dataroot="datasets/splicing/cows", A_resize=448, B_resize=448,
        seed=3, vit_compute_dtype="float32",
        generator_compute_dtype="float32",
        dino_global_patch_size=70 if dinov2 else 64,
        entire_A_every=2, generator_conv=mode))
    pair = load_pair(cfg, device=torch.device(dev))
    ext = ext_lib.VitExtractor(
        params=tree_map(lambda t: t.to(dev), vparams), cfg=vcfg,
        model_name="small")
    return cfg, pair, ext


def check_small_step(torch):
    """One regular and one entire-A step's loss and gradient at a small
    size, fp32: the card (kernels) against the CPU (plain path), for each
    generator_conv that routes through kernels, and for a small DINOv2
    (layer scale, registers) at generator_conv=auto."""
    from splice_tpu_torch.losses import lambdas_for_step
    from splice_tpu_torch.trainer import SpliceTrainer, sample_step_draws

    def losses_and_grads(mode, dev, dinov2):
        cfg, pair, ext = small_setup(torch, dev, mode, dinov2)
        tr = SpliceTrainer(cfg, pair, ext, seed=3)
        gen = torch.Generator().manual_seed(11)
        out = []
        for step, entire in ((1, False), (2, True)):
            draws = sample_step_draws(cfg, pair, gen)
            total, _ = tr.loss(draws, lambdas_for_step(cfg, step), entire)
            (grad,) = torch.autograd.grad(total, tr.flat)
            out.append((total.item(), grad.cpu()))
        return out

    for mode, same, dinov2 in (("auto", False, False),
                               ("fused", False, False),
                               ("pallas", False, False),
                               ("fused", True, False), ("pallas", True, False),
                               ("auto", False, True)):
        label = (mode + (" with the SAME route" if same else "")
                 + (", DINOv2 ViT (layer scale, 4 registers)" if dinov2
                    else ""))
        with same_border(same):
            results = {dev: losses_and_grads(mode, dev, dinov2)
                       for dev in ("cuda", "cpu")}
        # Gradient tolerance: this gradient is ill-conditioned in fp32
        # itself. On the CPU the fp32 gradient of this step differs from a
        # float64 evaluation of the same code by 1.2e-3 relative L2 (8e-4 x
        # max|grad|), mostly in the first convs' weight gradients, and the
        # card's differs from the CPU's by as much with the conv kernels on
        # or every conv on cuDNN alike. A kernel fault gives errors of order
        # max|grad|.
        for (lc, gc), (lp, gp), what in zip(results["cuda"], results["cpu"],
                                            ("regular", "entire-A")):
            rel = abs(lc - lp) / abs(lp)
            gerr = (gc - gp).abs().max().item()
            gtol = 5e-3 * gp.abs().max().item()
            grel = ((gc - gp).norm() / gp.norm()).item()
            print(f"  small {what} step, generator_conv={label} (448 canvas, "
                  f"fp32): loss card {lc:.6f} cpu {lp:.6f} rel {rel:.2e} "
                  f"(tol 1e-4); grad max_abs_err {gerr:.3e} (tol {gtol:.3e} "
                  f"= 5e-3 x max|grad|), relative L2 {grel:.2e} (tol 5e-3)")
            if not (rel <= 1e-4 and gerr <= gtol and grel <= 5e-3):
                fail(f"small {what} step ({label}): card and CPU disagree")


def check_small_nhwc_step(torch):
    """check_small_step's regular and entire-A steps with the NHWC
    generator (generator_layout nhwc: every conv F.conv2d on the
    channels_last view) of lanczos2 downsampling and Swish: the card
    (cuDNN, TF32 off) against the CPU, check_small_step's tolerances."""
    import dataclasses
    from splice_tpu_torch.losses import lambdas_for_step
    from splice_tpu_torch.models import unet
    from splice_tpu_torch.trainer import SpliceTrainer, sample_step_draws
    gcfg = unet.SkipConfig(downsample_mode="lanczos2", act_fun="Swish")
    results = {}
    for dev in ("cuda", "cpu"):
        cfg, pair, ext = small_setup(torch, dev)
        cfg = dataclasses.replace(cfg, generator_layout="nhwc")
        tr = SpliceTrainer(cfg, pair, ext, gcfg, seed=3)
        gen = torch.Generator().manual_seed(11)
        results[dev] = []
        for step, entire in ((1, False), (2, True)):
            draws = sample_step_draws(cfg, pair, gen)
            total, _ = tr.loss(draws, lambdas_for_step(cfg, step), entire)
            (grad,) = torch.autograd.grad(total, tr.flat)
            results[dev].append((total.item(), grad.cpu()))
    for (lc, gc), (lp, gp), what in zip(results["cuda"], results["cpu"],
                                        ("regular", "entire-A")):
        rel = abs(lc - lp) / abs(lp)
        gerr = (gc - gp).abs().max().item() / gp.abs().max().item()
        grel = ((gc - gp).norm() / gp.norm()).item()
        print(f"  small {what} step, generator_layout=nhwc, lanczos2, Swish "
              f"(448 canvas, fp32): loss card {lc:.6f} cpu {lp:.6f} rel "
              f"{rel:.2e} (tol 1e-4); grad max_abs_err {gerr:.2e} x "
              f"max|grad| (tol 5e-3), relative L2 {grel:.2e} (tol 5e-3)")
        if not (rel <= 1e-4 and gerr <= 5e-3 and grel <= 5e-3):
            fail(f"small nhwc {what} step: card and CPU disagree")


def check_small_inversion_step(torch):
    """One inversion iteration's loss and parameter gradient
    (tools.inversion.step_loss, feature cls, noise magnitude 2, the noise
    passed in) at fp32 with the inversion net (7x7/5x5/3x3, reflection) at
    128 x 160 and a two-block ViT of width 128, on the card for
    generator_layout nhwc (cuDNN) and chw + pallas (K3/K4 at k = 7, 5, 4,
    3 on the CUDA cores), each against the CPU's float64 evaluation (the
    two layouts agree there to 1e-13). This gradient is ill-conditioned in
    fp32 itself: the CPU's fp32 evaluations lie 1.4e-3 (chw) and 3.0e-3
    (nhwc) from float64 in max error over max|grad| (3.9e-3 and 5.1e-3 at
    160 x 192). Tolerances: loss 1e-4 relative; gradient max(5e-3, 2 x the
    CPU's fp32 distance from float64, the larger layout's) in max error
    over max|grad| and in relative L2. A kernel fault gives errors of
    order max|grad|."""
    from splice_tpu_torch.models import extractor as ext_lib
    from splice_tpu_torch.models import unet, vit as vit_lib
    from splice_tpu_torch.models.weights import init_vit_params
    from splice_tpu_torch.tools import inversion as inv
    from splice_tpu_torch.utils.tree import tree_map
    vcfg = vit_lib.VitConfig(patch_size=8, embed_dim=128, depth=2,
                             num_heads=2, img_size=32)
    vparams = init_vit_params(vcfg, seed=5, device="cpu")
    gcfg = unet.inversion_skip_config(8)
    tree = unet.init_skip_params(gcfg, seed=7, device="cpu")
    gen = torch.Generator().manual_seed(8)
    H, W = 128, 160
    base = torch.randn(1, H, W, 8, generator=gen)
    noise = torch.randn(1, H, W, 8, generator=gen)
    target = torch.rand(1, H, W, 3, generator=gen)

    def loss_and_grad(layout, dev, dt):
        ext = ext_lib.VitExtractor(
            params=tree_map(lambda t: t.to(dev, dt), vparams), cfg=vcfg,
            compute_dtype=dt)
        if layout == "chw":
            def g_apply(p, x):
                return unet.skip_apply_chw(p, gcfg, x, conv_impl="pallas")
        else:
            def g_apply(p, x):
                return unet.skip_apply(p, gcfg, x)
        flat, spec = unet.flatten_params(tree)
        flat = flat.to(dev, dt).requires_grad_(True)
        with torch.no_grad():
            ref = inv.extract(ext, target.to(dev, dt), "cls", 1)
        loss = inv.step_loss(g_apply, unet.unflatten_params(flat, spec), ext,
                             ref, base.to(dev, dt), noise.to(dev, dt), 2.0,
                             "cls", 1)
        (grad,) = torch.autograd.grad(loss, flat)
        return loss.item(), grad.cpu().double()

    def gaps(a, b):
        (la, ga), (lb, gb) = a, b
        return (abs(la - lb) / abs(lb),
                (ga - gb).abs().max().item() / gb.abs().max().item(),
                ((ga - gb).norm() / gb.norm()).item())

    f32, f64 = torch.float32, torch.float64
    truth = loss_and_grad("chw", "cpu", f64)
    cpu = {lay: gaps(loss_and_grad(lay, "cpu", f32), truth)
           for lay in ("nhwc", "chw")}
    gtol = max(5e-3, 2 * max(c[1] for c in cpu.values()))
    ltol = max(5e-3, 2 * max(c[2] for c in cpu.values()))
    print(f"  small inversion step (inversion net at {H} x {W}, fp32): the "
          f"CPU's fp32 against its float64, nhwc {cpu['nhwc'][1]:.2e} / "
          f"{cpu['nhwc'][2]:.2e}, chw {cpu['chw'][1]:.2e} / "
          f"{cpu['chw'][2]:.2e} (max error over max|grad| / relative L2): "
          f"tolerance {gtol:.2e} / {ltol:.2e}")
    for lay in ("nhwc", "chw"):
        card = loss_and_grad(lay, "cuda", f32)
        rel, gmax, grel = gaps(card, truth)
        route = " + pallas (K3/K4 at k = 7, 5, 4, 3)" if lay == "chw" else ""
        print(f"  small inversion step, {lay}{route}"
              f", the card against float64: loss {card[0]:.6f} against "
              f"{truth[0]:.6f}, rel {rel:.2e} (tol 1e-4); grad {gmax:.2e} x "
              f"max|grad|, relative L2 {grel:.2e}")
        if not (rel <= 1e-4 and gmax <= gtol and grel <= ltol):
            fail(f"small inversion step ({lay}): the card disagrees")


PAIR_ROOTS = ("datasets/splicing/cows", "datasets/splicing/apples2oranges")


def pairs_setup(torch, dev, mode="auto"):
    """Phase 3's small fp32 configuration over two pairs on `dev`: (cfg,
    pairs, extractor), the cows and apples2oranges pairs loaded as the
    multi-pair trainer loads them (load_pair_batch) at 448 x 448, a 448
    canvas, the two-block ViT of width 128."""
    from splice_tpu_torch.data import ImagePair
    from splice_tpu_torch.parallel.pair_parallel import load_pair_batch
    cfg, _, ext = small_setup(torch, dev, mode)
    batch = load_pair_batch(cfg, PAIR_ROOTS, 448, dev)
    return cfg, [ImagePair(A=a, B=b, canvas_A=448, canvas_B=448)
                 for a, b in zip(batch["A"], batch["B"])], ext


def check_small_pairs_step(torch):
    """One regular and one entire-A step of two pairs (MultiPairTrainer)
    at phase 3's small size, fp32: each pair's loss and gradient on the
    card (kernels) against the CPU (plain path), from the same parameters
    and draws, for generator_conv auto, fused and pallas. Tolerances:
    check_small_step's (loss 1e-4 relative; gradient 5e-3 x max|grad| and
    5e-3 relative L2), or 1.25 x this input's fp32 conditioning where that
    is larger: the largest gap, over both steps and pairs, between two
    evaluations that share no kernel of the port, cuDNN on the card
    against the CPU (generator_conv=xla on both) and the CPU's fp32 convs
    against its float64 plain convs (xla against pallas on the CPU). The
    cows and apples2oranges pairs centre-cropped to 448 x 448 take this
    gradient's fp32 rounding up to 8e-3 x max|grad| in either (phase 3's
    own input: 1e-3); a kernel fault gives errors of order max|grad|."""
    from splice_tpu_torch.parallel.pair_parallel import MultiPairTrainer

    def losses_and_grads(mode, dev):
        cfg, pairs, ext = pairs_setup(torch, dev, mode)
        tr = MultiPairTrainer(cfg, pairs, ext, seeds=[3, 4])
        gen = torch.Generator().manual_seed(12)
        out = []
        for step, entire in ((1, False), (2, True)):
            rows = torch.from_numpy(packed_rows(cfg, pairs, step, gen,
                                                1)[0]).to(dev)
            total, _ = tr.loss(rows, entire)
            grads = torch.autograd.grad(total.sum(),
                                        [t.flat for t in tr.trainers])
            out.append((total.detach().cpu(),
                        [g.detach().cpu().double() for g in grads]))
        return out

    def errors(a, b):
        """[(step, pair, loss rel, grad max err / max|grad|, grad rel L2)]
        of a against b."""
        return [(what, p, abs(la[p] - lb[p]).item() / abs(lb[p]).item(),
                 (ga - gb).abs().max().item() / gb.abs().max().item(),
                 ((ga - gb).norm() / gb.norm()).item())
                for (la, gas), (lb, gbs), what in zip(a, b, ("regular",
                                                             "entire-A"))
                for p, (ga, gb) in enumerate(zip(gas, gbs))]

    res = {(mode, dev): losses_and_grads(mode, dev)
           for mode in ("xla", "auto", "fused", "pallas")
           for dev in ("cuda", "cpu")}
    cond = (errors(res["xla", "cuda"], res["xla", "cpu"])
            + errors(res["xla", "cpu"], res["pallas", "cpu"]))
    cmax = max(c[3] for c in cond)
    cl2 = max(c[4] for c in cond)
    gtol, ltol = max(5e-3, 1.25 * cmax), max(5e-3, 1.25 * cl2)
    print(f"  two pairs (cows, apples2oranges at 448 x 448), fp32 "
          f"conditioning: cuDNN on the card against the CPU, and the CPU's "
          f"fp32 convs against its float64 ones, up to {cmax:.2e} x "
          f"max|grad| and {cl2:.2e} relative L2: gradient tolerance "
          f"{gtol:.2e} x max|grad|, {ltol:.2e} relative L2")
    for mode in ("auto", "fused", "pallas"):
        for what, p, rel, gmax, grel in errors(res[mode, "cuda"],
                                               res[mode, "cpu"]):
            print(f"  two pairs, small {what} step, pair {p}, "
                  f"generator_conv={mode} (448 canvas, fp32), card against "
                  f"CPU: loss rel {rel:.2e} (tol 1e-4); grad max_abs_err "
                  f"{gmax:.2e} x max|grad|, relative L2 {grel:.2e}")
            if not (rel <= 1e-4 and gmax <= gtol and grel <= ltol):
                fail(f"two pairs, small {what} step ({mode}), pair {p}: "
                     f"card and CPU disagree")


def optimizer_tol(p0, updates):
    """Per-parameter tolerance of an optimizer's result: 1e-6 of the
    operands each parameter has summed, |p0| + |update 1| + ... (the
    card's rsqrtf is within 2 ulps, and a parameter that an update nearly
    cancels shows an ulp of the update at more than 1e-6 of its own size;
    the same rule holds the optimizers against optax on the CPU,
    tests/test_torch_run.py)."""
    return 1e-6 * (p0.abs() + sum(u.abs() for u in updates))


def check_small_optimizers(torch):
    """RMSprop (optax's: eps inside the square root) and SGD, the port's
    own capturable optimizers, on the card against the CPU: from phase 3's
    small fp32 parameters, three updates with that size's regular-step
    gradient (taken on the CPU and scaled by 1, -0.5 and 2, so that both
    devices apply the same gradients and RMSprop's second moment moves) at
    a linear schedule's first three lrs."""
    import dataclasses
    from splice_tpu_torch.losses import lambdas_for_step
    from splice_tpu_torch.trainer import (SpliceTrainer, device_lr,
                                          make_optimizer, sample_step_draws)
    cfg, pair, ext = small_setup(torch, "cpu")
    tr = SpliceTrainer(cfg, pair, ext, seed=3)
    draws = sample_step_draws(cfg, pair, torch.Generator().manual_seed(11))
    total, _ = tr.loss(draws, lambdas_for_step(cfg, 1), False)
    (grad,) = torch.autograd.grad(total, tr.flat)
    for name in ("rmsprop", "sgd"):
        ocfg = dataclasses.replace(cfg, optimizer=name,
                                   scheduler_policy="linear")
        lrs = [float(device_lr(ocfg, i)) for i in range(3)]
        after = {}
        for dev in ("cuda", "cpu"):
            p = tr.flat.detach().to(dev).clone().requires_grad_(True)
            lr = torch.zeros((), device=dev)
            opt = make_optimizer(ocfg, [p], lr)
            seq = []
            for scale, step_lr in zip((1.0, -0.5, 2.0), lrs):
                p.grad = grad.to(dev) * scale
                lr.fill_(step_lr)
                opt.step()
                seq.append(p.detach().cpu().clone())
            after[dev] = seq
        p0 = tr.flat.detach()
        prev, ups, worst = p0, [], 0.0
        for card, cpu in zip(after["cuda"], after["cpu"]):
            ups.append(cpu - prev)
            prev = cpu
            err = (card - cpu).abs()
            ratio = (err / optimizer_tol(p0, ups).clamp_min(1e-30)).max()
            worst = max(worst, ratio.item())
        print(f"  {name}: three updates on the card against the CPU (lrs "
              + ", ".join(f"{v:.6g}" for v in lrs) + f"): largest error "
              f"{worst:.3f} of its tolerance (1e-6 x |p0| + |updates|); "
              f"largest update {max(u.abs().max().item() for u in ups):.3e}")
        if not worst <= 1.0:
            fail(f"{name}: the card's updates disagree with the CPU's")


def trainers_of(trainer):
    """The SpliceTrainers of a trainer: itself, or a MultiPairTrainer's."""
    return getattr(trainer, "trainers", [trainer])


def pairs_of(trainer):
    """A trainer's pair, or a MultiPairTrainer's list of pairs."""
    if hasattr(trainer, "trainers"):
        return [t.pair for t in trainer.trainers]
    return trainer.pair


def packed_rows(cfg, pairs, lam_step: int, gen, n: int):
    """n packed rows with the lambdas of step lam_step, the lr cfg.lr and
    draws from `gen`: [n, row_width] for one pair, [n, P, row_width] for a
    list of P pairs (each step draws for pair 0, then pair 1, ...)."""
    import numpy as np
    from splice_tpu_torch.trainer import (lambdas_vec, pack_row,
                                          sample_step_draws)

    def row(pair):
        return pack_row(lambdas_vec(cfg, lam_step), cfg.lr,
                        sample_step_draws(cfg, pair, gen))
    if isinstance(pairs, list):
        return np.stack([np.stack([row(p) for p in pairs])
                         for _ in range(n)])
    return np.stack([row(pairs) for _ in range(n)])


# the eager-against-eager spread (losses, update) that check_replay
# measured, by label
SPREADS = {}


def check_replay(torch, label, cfg, make, pairs, spread_runs: int = 1):
    """The captured graphs against eager steps from one state: a trainer
    from make() (a SpliceTrainer over `pairs`, one pair, or a
    MultiPairTrainer over a list of pairs) takes one eager entire-A step
    (so Adam holds moments), and three clones of its flat parameters and
    Adam state run the same rows (an entire-A step, three regular steps,
    another entire-A step): 1 + spread_runs eagerly, one through
    SpliceProgram (the first step of each class eager, then its capture;
    the rest replays). Fails unless the program's per-step losses (every
    pair's) and parameter update agree with the first eager run's within
    REPLAY_MULT x the eager runs' spread (the largest distance of another
    eager run from the first) plus a floor. Then every step again as a
    replay from the state the first eager run had before it (copied in
    place into the graphs' parameters and Adam state): its losses, a
    forward pass from one state, must agree with that run's within
    REPLAY_LOSS_FLOOR. Returns the program."""
    import numpy as np
    from splice_tpu_torch.trainer import LOSS_KEYS, SpliceProgram
    gen = torch.Generator().manual_seed(21)
    base = make()
    base.step(torch.from_numpy(packed_rows(cfg, pairs, 0, gen, 1)[0]).cuda(),
              None, True)
    plan = ((True, 0, 1), (False, 5, 3), (True, 0, 1))  # entire, lam step, n
    chunks = [(entire, packed_rows(cfg, pairs, lam, gen, n))
              for entire, lam, n in plan]

    def flat_of(t):
        return torch.cat([tr.flat.detach() for tr in trainers_of(t)])

    flat0 = flat_of(base).clone()

    def clone():
        t = make()
        t.load_state_dict(base.state_dict())
        return t

    def state(t):
        return [v for tr in trainers_of(t)
                for v in (tr.flat.detach(), *tr.opt.state[tr.flat].values())]

    def eager(before=None):
        t, seq = clone(), []
        for entire, rows in chunks:
            for r in torch.from_numpy(rows).cuda():
                if before is not None:
                    before.append([v.clone() for v in state(t)])
                parts = t.step(r, None, entire)
                seq.append(torch.stack([parts[k] for k in LOSS_KEYS],
                                       dim=-1).cpu().numpy())
        return np.array(seq), flat_of(t) - flat0

    before = []
    l1, d1 = eager(before)
    others = [eager() for _ in range(spread_runs)]
    program = SpliceProgram(clone(), 3)
    lr = np.concatenate([program.run(rows, entire)
                         for entire, rows in chunks])
    dr = flat_of(program.trainer) - flat0
    same = []
    steps = [(entire, row) for entire, rows in chunks for row in rows]
    for (entire, row), snap in zip(steps, before):
        with torch.no_grad():
            for dst, src in zip(state(program.trainer), snap):
                dst.copy_(src)
        same.append(program.run(row[None], entire)[0])

    def rel_loss(a, b):
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max())

    def rel_upd(a, b):
        return ((a - b).norm() / b.norm()).item()

    spread = (max(rel_loss(l2, l1) for l2, _ in others),
              max(rel_upd(d2, d1) for _, d2 in others))
    SPREADS[label] = spread
    err = (rel_loss(lr, l1), rel_upd(dr, d1), rel_loss(np.array(same), l1))
    tol = (REPLAY_MULT * spread[0] + REPLAY_LOSS_FLOOR,
           REPLAY_MULT * spread[1] + REPLAY_UPDATE_FLOOR)
    replays = {k: c.replays for k, c in program.graphs.items()}
    print(f"  {label}: eager against eager ({spread_runs} run"
          f"{'s' if spread_runs > 1 else ''} against the first): losses "
          f"{spread[0]:.3e} "
          f"(largest relative), update {spread[1]:.3e} (relative L2); "
          f"graphs against eager: losses {err[0]:.3e} (tol {tol[0]:.3e} = "
          f"{REPLAY_MULT:g} x spread + {REPLAY_LOSS_FLOOR:g}), update "
          f"{err[1]:.3e} (tol {tol[1]:.3e} = {REPLAY_MULT:g} x spread + "
          f"{REPLAY_UPDATE_FLOOR:g}); largest parameter difference "
          f"{(dr - d1).abs().max().item():.3e}; each step replayed from the "
          f"eager run's state before it: losses {err[2]:.3e} (tol "
          f"{REPLAY_LOSS_FLOOR:g}); replays {replays}")
    if sorted(replays.values()) != [3, 5]:
        fail(f"{label}: the graphs were not replayed as planned: {replays}")
    if not (np.isfinite(lr).all() and err[0] <= tol[0] and err[1] <= tol[1]
            and err[2] <= REPLAY_LOSS_FLOOR):
        fail(f"{label}: the captured graphs disagree with eager steps")
    return program


def one_pair(cfg, pair, extractor):
    """check_replay's trainer factory over one pair."""
    from splice_tpu_torch.trainer import SpliceTrainer
    return lambda: SpliceTrainer(cfg, pair, extractor, seed=0)


def check_sync_free(torch, program, cfg):
    """One regular chunk queued (draws copied, counter reset, replays)
    under torch.cuda.set_sync_debug_mode("error"): fails if anything in it
    waits for the device."""
    import numpy as np
    rows = regular_rows(torch, cfg, pairs_of(program.trainer), 3, 22)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        n = program.dispatch(rows, False)
    except RuntimeError as e:
        fail(f"a chunk synchronised with the device while queued: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    seq = program.fetch(n)
    print(f"  a chunk of {n} regular steps queued under sync debug mode "
          f"'error': no synchronisation; its one read: losses "
          f"{', '.join(f'{v:.5f}' for v in seq[..., -1].ravel())}")
    if not np.isfinite(seq).all():
        fail("the sync-free chunk gave non-finite losses")


# Kernel names (substrings) of the port's own kernels in a profile.
OUR_KERNELS = ("attn_fwd_kernel", "attn_bwd_", "conv_fwd_kernel",
               "conv_fwd_tc", "conv_dw_", "conv_stats_")


def regular_rows(torch, cfg, pairs, n: int, seed: int):
    """n packed rows of regular steps (lambdas of step 5) from a seed, for
    one pair or a list of pairs (packed_rows)."""
    return packed_rows(cfg, pairs, 5, torch.Generator().manual_seed(seed), n)


def profile_steps(torch, program, cfg, n: int = 3) -> None:
    """Per regular step, through `program` (its regular graph captured
    first if this route has none): the host-clock wall of a chunk of
    replays as long as the path's longest (its draws, its copy and its one
    read included; the median of three chunks), beside the wall of n eager
    steps
    (SpliceTrainer.step, which the parent ran); the device's span over
    the chunk by CUDA events; then torch.profiler over a chunk of n
    replays: kernel time by name inside the graphs, and graph launches.
    Returns the replays' wall ms per step."""
    from torch.profiler import ProfilerActivity, profile
    trainer = program.trainer
    program.run(regular_rows(torch, cfg, pairs_of(trainer), 1, 0), False)
    n_wall = program.rows.shape[0]
    rows = regular_rows(torch, cfg, pairs_of(trainer), n_wall, 1)
    rows_dev = torch.from_numpy(rows[:n]).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in rows_dev:
        trainer.step(r, None, False)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / n
    walls, spans = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        k = program.dispatch(rows, False)
        end.record()
        program.fetch(k)
        walls.append((time.perf_counter() - t0) * 1e3 / k)
        spans.append(start.elapsed_time(end) / k)
    wall_ms, span_ms = sorted(walls)[1], sorted(spans)[1]
    replays = sum(c.replays for c in program.graphs.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        program.run(rows[:n], False)
        torch.cuda.synchronize()
    if sum(c.replays for c in program.graphs.values()) != replays + n:
        fail("the profiled chunk did not replay one graph per step")

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    kernel = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    rows_k = [(dev_us(e) / 1e3 / n, e.key) for e in events
              if e.device_type == kernel and dev_us(e) > 0]
    graph_launches = sum(e.count for e in events
                         if e.key == "cudaGraphLaunch") / n
    busy = sum(t for t, _ in rows_k)
    print(f"  per regular step: graph replays {wall_ms:.2f} ms wall "
          f"({1e3 / wall_ms:.3f} steps/s; chunks of {n_wall}, median of 3: "
          + ", ".join(f"{w:.2f}" for w in walls) + f"), eager step "
          f"{eager_ms:.2f} ms ({1e3 / eager_ms:.3f} steps/s); the device's "
          f"span over the chunk (CUDA events) {span_ms:.2f} ms a step; "
          f"{graph_launches:.1f} graph launches (cudaGraphLaunch) a step")
    if not rows_k:
        print("  torch.profiler attributed no kernel time inside the "
              f"graphs; busy share from the CUDA events' span: "
              f"{100 * span_ms / wall_ms:.1f}% of wall")
        return wall_ms
    ours = sum(t for t, k in rows_k if any(s in k for s in OUR_KERNELS))
    n_launch = sum(e.count for e in events
                   if e.device_type == kernel and dev_us(e) > 0) / n
    print(f"  kernels inside the graphs {busy:.2f} ms a step "
          f"({100 * busy / wall_ms:.1f}% of the replays' wall; "
          f"{n_launch:.0f} kernel launches of {len(rows_k)} kernel names), "
          f"the port's kernels {ours:.2f} ms ({100 * ours / busy:.1f}% of "
          f"kernel time)")
    k3 = sum(t for t, k in rows_k if "conv_fwd" in k or "conv_stats_" in k)
    dw = sum(t for t, k in rows_k if "conv_dw_" in k)
    print(f"  K3 kernels (every form, the statistics reduce) {k3:.3f} ms, dw "
          f"kernels (K4, K7 and their sums) {dw:.3f} ms per regular step")
    for t, k in sorted(rows_k, reverse=True)[:15]:
        print(f"    {t:8.3f} ms  {100 * t / busy:5.1f}%  {k[:90]}")
    print("  the port's kernels per regular step:")
    for e in sorted(events, key=dev_us, reverse=True):
        if e.device_type == kernel and any(s in e.key for s in OUR_KERNELS):
            print(f"    {dev_us(e) / 1e3 / n:8.3f} ms  {e.count / n:5.1f} "
                  f"launches  {e.key[:90]}")
    return wall_ms


def steps_in_turns(torch, runs, n: int = 3, rounds: int = 3) -> dict:
    """Host-clock wall time per regular step of each (label, trainer,
    cfg, SAME route, DW_TAP_ON_N) in `runs`, measured in turns (a b c c b
    a, `rounds` times, n steps a turn) after one untimed step each: the
    host's noise falls on every mode alike. Returns each label's K7
    launches in its timed turns."""
    from splice_tpu_torch.losses import lambdas_for_step
    from splice_tpu_torch.ops import conv
    from splice_tpu_torch.trainer import sample_step_draws
    gen = torch.Generator().manual_seed(2)
    lam = lambdas_for_step(runs[0][2], 5)
    times = {label: [] for label, *_ in runs}
    k7 = dict.fromkeys(times, 0)
    order = list(runs) + list(reversed(runs))
    for r in range(rounds + 1):
        for label, trainer, cfg, same, tap_on_n in order if r else runs:
            draws = [sample_step_draws(cfg, trainer.pair, gen)
                     for _ in range(n if r else 1)]
            conv.conv_dw_gtap_cuda.launches = 0
            with same_border(same, tap_on_n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for d in draws:
                    trainer.step(d, lam, False)
                torch.cuda.synchronize()
            if r:
                times[label].append((time.perf_counter() - t0) * 1e3 / n)
                k7[label] += conv.conv_dw_gtap_cuda.launches
    for label, ts in times.items():
        ts = sorted(ts)
        print(f"  {label}: median "
              f"{ts[len(ts) // 2]:.2f} ms per regular step over "
              f"{len(ts)} turns of {n} (sorted: "
              + ", ".join(f"{t:.2f}" for t in ts) + f"); K7 launches "
              f"{k7[label]}")
    return k7


def read_launches(torch, kernels, name, need, programs):
    """The launches on the card since the counts were set to 0, and the
    tensor-core ones: each wrapper's count (its eager launches, and one
    per call recorded in a graph at capture, which launches nothing) less
    the captures' records plus records x replays. Fails when a kernel in
    `need` was launched no time on the path `name`, or never inside its
    graphs. Returns (launches, tensor-core launches)."""
    torch.cuda.synchronize()
    launches, tc, in_graphs = {}, {}, {}
    for k, (fn, *_) in kernels.items():
        rec = [(c.launches.get(f"{k}_cuda", (0, 0)), c.replays)
               for p in programs for c in p.graphs.values()]
        launches[k] = fn.launches + sum(n * (r - 1) for (n, _), r in rec)
        tc[k] = (getattr(fn, "tc_launches", 0)
                 + sum(t * (r - 1) for (_, t), r in rec))
        in_graphs[k] = sum(n * r for (n, _), r in rec)
    graphs = {key: (c.replays, sum(n for n, _ in c.launches.values()))
              for p in programs for key, c in p.graphs.items()}
    print(f"  launches in the {name} path (eager + recorded x replays): "
          f"{launches}; inside graph replays: {in_graphs}; graphs "
          f"(entire, SAME route, DW_TAP_ON_N): (replays, the port's "
          f"wrapper calls recorded) {graphs}")
    missing = [k for k in need if launches[k] == 0 or in_graphs[k] == 0]
    if missing:
        fail(f"kernels never launched inside the {name} path's graphs: "
             f"{missing}")
    return launches, tc


def check_output(torch, name, out):
    if tuple(out.shape) != (900, 1200, 3) or not torch.isfinite(out).all():
        fail(f"{name}: bad output image {tuple(out.shape)}")


def zero_counts(kernels) -> None:
    for fn, *_ in kernels.values():
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0


def check_tc_launches(launches, tc, name):
    """Every launch of the path's attention kernels (K1/K2, or K5/K6 on
    the 480 path) and of its conv kernels (K3 in each form, K4 in each
    form, K7; every path runs a bf16 generator) on the tensor cores, the
    graphs' replays included: fails otherwise, or when the path launched
    no attention kernel."""
    att = [k for k in ATTENTION if launches.get(k)]
    names = att + [k for k in DW + K3 if launches.get(k)]
    tcs = {k: tc[k] for k in names}
    print(f"  tensor-core launches in the {name} path: {tcs}")
    if not att or any(n != launches[k] for k, n in tcs.items()):
        fail(f"{name} path: attention or conv launches off the tensor "
             f"cores: {tcs} of {launches}")


def run_path(torch, name, cfg, n_steps, kernels, need, same=False, **kw):
    """train_pair (with the SAME route if `same`) with every launch count
    set to 0 just before and read just after; fails on a non-finite loss or
    output, or when a kernel in `need` was launched no time inside the
    path's graphs. Prints each chunk and the peak memory, the graphs'
    pools included. Returns (result, launches)."""
    from splice_tpu_torch.trainer import train_pair
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    with same_border(same):
        res = train_pair(cfg, n_steps=n_steps, **kw)
    launches, tc = read_launches(torch, kernels, name, need,
                                 [res["program"]])
    check_tc_launches(launches, tc, name)
    print(f"  chunks {res['chunks']}; {res['steps_per_sec']:.3f} steps/s "
          f"over the run (captures included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the "
          f"graphs' pools included)")
    for i, (l, s) in enumerate(zip(res["losses"], res["step_seconds"])):
        print(f"  step {i:2d} {s * 1e3:9.2f} ms "
              + " ".join(f"{k}={v:.5f}" for k, v in l.items()))
    for i, l in enumerate(res["losses"]):
        if not all(math.isfinite(v) for v in l.values()):
            fail(f"{name}: non-finite loss at step {i}: {l}")
    check_output(torch, name, res["output"])
    return res, launches


def run_skip3(torch, cfg, pair, extractor, kernels, need):
    """SKIP3_STEPS fused steps (step 0 entire-A) with the SAME route of a
    generator with 3x3 skip convs (SkipConfig(filter_skip_size=3), which
    SpliceTrainer takes as the reference's build_program does), through a
    SpliceProgram in train_pair's chunks, the counts set to 0 just before
    and read just after. Its scale-1 skip conv reads a pending BatchNorm at
    width 448 and feeds no statistics: the fused site that reaches K3''
    SAME with a prologue alone, which no site of the default generator
    does (its down_conv2 and up_conv take K3''')."""
    import numpy as np
    from splice_tpu_torch.models.unet import SkipConfig
    from splice_tpu_torch.trainer import (LOSS_KEYS, SpliceProgram,
                                          SpliceTrainer, chunk_plan,
                                          lambdas_vec, pack_row,
                                          sample_step_draws)
    zero_counts(kernels)
    gen = torch.Generator().manual_seed(0)
    with same_border(True):
        tr = SpliceTrainer(cfg, pair, extractor,
                           gcfg=SkipConfig(filter_skip_size=3), seed=0)
        plan = chunk_plan(cfg, SKIP3_STEPS)
        program = SpliceProgram(tr, max(n for _, n, _ in plan))
        for start, n, entire in plan:
            t0 = time.perf_counter()
            rows = np.stack([pack_row(lambdas_vec(cfg, i), cfg.lr,
                                      sample_step_draws(cfg, pair, gen))
                             for i in range(start, start + n)])
            seq = program.run(rows, entire)      # the chunk's one read
            ms = (time.perf_counter() - t0) * 1e3 / n
            for i, vals in enumerate(seq, start):
                loss = dict(zip(LOSS_KEYS, map(float, vals)))
                print(f"  step {i:2d} {ms:9.2f} ms "
                      + " ".join(f"{k}={v:.5f}" for k, v in loss.items()))
                if not all(math.isfinite(v) for v in loss.values()):
                    fail(f"fused_same_skip3: non-finite loss at step {i}: "
                         f"{loss}")
        out = tr.render()
    launches, tc = read_launches(torch, kernels, "fused_same_skip3", need,
                                 [program])
    check_tc_launches(launches, tc, "fused_same_skip3")
    check_output(torch, "fused_same_skip3", out)
    return launches


RUN_STEPS = 300       # phase 8's run, at the reference's defaults
RUN_CKPT = 100
RUN_RESUME = 200      # the checkpoint the resumed run starts from
OPT_STEPS = 4         # each of RMSprop and SGD: E0, then 1 eager, 2 replays


def run_config(**kw):
    from splice_tpu_torch.config import load_config
    return load_config(None, dict(dataroot="datasets/splicing/cows", seed=0,
                                  n_epochs=RUN_STEPS, **kw))


def check_lr_column(cfg, rows, trainer, label):
    """Each step's lr in the rows, bit for bit device_lr's (the reference's
    device_lr_fn as XLA compiles it, held bitwise against it on the CPU
    by tests/test_torch_run.py), within float32 rounding of the schedule's
    float64 form (Scheduler.lr_for_step: 2^-22 x the base lr), and the lr
    tensor that the optimizer reads holding the last row's."""
    import numpy as np
    from splice_tpu_torch.trainer import LR_COLUMN, Scheduler, device_lr
    got = np.ascontiguousarray(rows[:, LR_COLUMN])
    want = np.array([device_lr(cfg, i) for i in range(len(got))], np.float32)
    sched = Scheduler(cfg)
    f64 = np.array([sched.lr_for_step(i) for i in range(len(got))])
    off = int((got.view(np.int32) != want.view(np.int32)).sum())
    dev64 = float(np.abs(got - f64).max())
    linked = all(g["lr"] is trainer.lr for g in trainer.opt.param_groups)
    last = trainer.lr.item()
    print(f"  {label}: lr of {len(got)} steps ({cfg.scheduler_policy}) from "
          f"{got[0]:.6g} to {got[-1]:.6g}: {off} rows off device_lr; "
          f"largest distance from the float64 schedule {dev64:.3e} (tol "
          f"{2 ** -22 * cfg.lr:.3e}); the optimizer reads the trainer's lr "
          f"tensor: {linked}, holding {last!r} (the last row's "
          f"{float(got[-1])!r})")
    if off or dev64 > 2 ** -22 * cfg.lr or not linked or last != got[-1]:
        fail(f"{label}: the steps' learning rates are not the schedule's")


def check_metrics(path, res, n_steps, freq):
    """One record per log boundary (step labels freq-1, 2 freq-1, ...),
    each with the loss terms (the run's own losses of that step), lr and
    steps_per_sec; the device memory on every tenth."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    steps = [r["step"] for r in recs]
    keys = {"t", "lr", "steps_per_sec", *res["losses"][0]}
    memory = [r["step"] for r in recs if "hbm_in_use_mib" in r]
    same = all({k: r[k] for k in res["losses"][0]}
               == res["losses"][r["step"] - res["first_step"]] for r in recs)
    print(f"  metrics: {len(recs)} records, steps {steps[0]}..{steps[-1]}, "
          f"memory on steps {memory} ({recs[-1].get('hbm_in_use_mib')} MiB "
          f"in use, {recs[-1].get('hbm_peak_mib')} peak, "
          f"{recs[-1].get('hbm_limit_mib')} on the card); the records' "
          f"losses are the run's: {same}")
    first = res["first_step"]
    want = list(range(first + freq - 1, n_steps, freq))
    if (steps != want or not all(keys <= set(r) for r in recs) or not same
            or memory != [s for s in want if (s + 1) // freq % 10 == 0]):
        fail(f"the metrics records are not the run's: {recs[:2]}")


def check_boundary_sync_free(torch, res, tmp):
    """One chunk and its log boundary, as train_pair queues them (the
    chunk, its losses' pinned copy and event, the uint8 render handed to
    an AsyncImageSaver, the last losses to a MetricsLogger), under
    torch.cuda.set_sync_debug_mode("error"); the workers finish inside the
    window (close() drains both). They make no call that the mode checks:
    each waits on its copy's CUDA event (cudaEventSynchronize, which the
    mode does not watch) and then reads pinned host memory, and a worker
    error would be counted. Fails on a synchronisation or a worker
    error."""
    import numpy as np
    from PIL import Image
    from splice_tpu_torch.trainer import LOSS_KEYS
    from splice_tpu_torch.utils.io import AsyncImageSaver
    from splice_tpu_torch.utils.metrics import MetricsLogger
    program, trainer = res["program"], res["trainer"]
    cfg = trainer.cfg
    rows = regular_rows(torch, cfg, trainer.pair, 10, 23)
    png, jsonl = os.path.join(tmp, "sync.png"), os.path.join(tmp, "sync.jsonl")
    saver, logger = AsyncImageSaver(), MetricsLogger(jsonl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        n = program.dispatch(rows, False)
        read = program.fetch_async(n)
        out = trainer.render_u8()
        saver.save(out, png)
        logger.log_async(n - 1, dict(zip(LOSS_KEYS, program.loss_seq[n - 1])),
                         {"lr": cfg.lr, "steps_per_sec": 0.0},
                         with_memory=True)
        seq = read.wait().numpy()
        saver.close()
        logger.close()
    except RuntimeError as e:
        fail(f"a chunk or its log boundary synchronised with the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with open(jsonl) as f:
        (rec,) = [json.loads(line) for line in f]
    img = np.asarray(Image.open(png))
    print(f"  a chunk of {n} regular steps and its log boundary (render_u8, "
          f"the pinned copies and their events, the saver, log_async with "
          f"memory), the workers finished, under sync debug mode 'error': "
          f"no synchronisation; worker errors: saver {saver.errors}, logger "
          f"{logger.errors}; png {img.shape}, record loss {rec['loss']} "
          f"(the chunk's read: {float(seq[-1, -1])})")
    if (saver.errors or logger.errors or img.shape != tuple(out.shape)
            or rec["loss"] != float(seq[-1, -1])
            or not np.isfinite(seq).all()):
        fail("the sync-free log boundary lost or corrupted its outputs")


def check_optimizer_in_graphs(torch, name, shared, tmp, kernels):
    """OPT_STEPS steps of `name` at a linear schedule through train_pair's
    graphs on the main path (an entire-A step, then the regular graph:
    one eager step, its capture, replays), then one more replayed step
    whose update is recomputed from the parameters, the optimizer state
    and the gradient (flat.grad, which the graph rewrites) the replay
    had: within optimizer_tol (the same ops on the same card: expected
    bitwise)."""
    import numpy as np
    from splice_tpu_torch.trainer import LR_COLUMN, device_lr, train_pair
    cfg = run_config(optimizer=name, scheduler_policy="linear",
                     log_images_freq=1000)
    zero_counts(kernels)
    res = train_pair(cfg, n_steps=OPT_STEPS, dataroot=tmp, **shared)
    read_launches(torch, kernels, name, ("attn_qkv_fwd", "attn_qkv_bwd",
                                         "conv_valid", "conv_dw"),
                  [res["program"]])
    tr, program = res["trainer"], res["program"]
    check_lr_column(cfg, res["rows"], tr, f"{name} run")
    rows = regular_rows(torch, cfg, tr.pair, 1, 24)
    rows[:, LR_COLUMN] = device_lr(cfg, OPT_STEPS)
    p0 = tr.flat.detach().clone()
    st0 = {k: v.clone() for k, v in tr.opt.state[tr.flat].items()}
    replays = sum(c.replays for c in program.graphs.values())
    program.run(rows, False)
    if sum(c.replays for c in program.graphs.values()) != replays + 1:
        fail(f"{name}: the step did not replay the regular graph")
    g = tr.flat.grad
    lr = torch.tensor(float(rows[0, LR_COLUMN]), device=g.device)
    if name == "rmsprop":
        keep = float(np.float32(1.0) - np.float32(0.99))
        nu = st0["nu"].mul(0.99).add_(g * g * keep)
        want = p0 - lr * (g * torch.rsqrt(nu + 1e-8))
    else:
        want = p0 - lr * g
    err = (tr.flat.detach() - want).abs()
    ratio = (err / optimizer_tol(p0, [want - p0]).clamp_min(1e-30)).max()
    losses = np.array([list(l.values()) for l in res["losses"]])
    print(f"  {name}: {OPT_STEPS} steps in chunks {res['chunks']}, losses "
          + ", ".join(f"{v:.5f}" for v in losses[:, -1]) + "; a replayed "
          f"step's update against the formula on the replay's gradient: "
          f"largest error {err.max().item():.3e} ({ratio.item():.3f} of "
          f"its tolerance), largest update {(want - p0).abs().max().item():.3e}")
    if not (np.isfinite(losses).all() and ratio.item() <= 1.0):
        fail(f"{name}: the captured graph's update is not the optimizer's")


def check_run(torch, kernels, shared):
    """Phase 8: train_pair as a user runs it on the main path (cows, 896
    canvas, dino_vitb8 seeded, 224, bf16) for RUN_STEPS steps at the
    reference's defaults (log_images_freq 10, entire_A_every 75,
    cls_warmup 1) with the cosine schedule over RUN_STEPS, metrics_path and
    checkpoints every RUN_CKPT steps in a temporary directory; then a run
    resumed from the checkpoint at RUN_RESUME, the sync-free boundary, and
    RMSprop and SGD through the graphs."""
    import shutil
    import tempfile
    import numpy as np
    from PIL import Image
    from splice_tpu_torch.trainer import train_pair
    from splice_tpu_torch.utils import pngio
    tmp = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        ck, metrics = os.path.join(tmp, "ck"), os.path.join(tmp, "m.jsonl")
        cfg = run_config(scheduler_policy="cosine", checkpoint_every=RUN_CKPT,
                         checkpoint_dir=ck, metrics_path=metrics)
        zero_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_pair(cfg, dataroot=tmp, **shared)
        wall = time.perf_counter() - t0
        launches, tc = read_launches(
            torch, kernels, "run", ("attn_qkv_fwd", "attn_qkv_bwd",
                                    "conv_valid", "conv_dw"),
            [res["program"]])
        check_tc_launches(launches, tc, "run")
        check_lr_column(cfg, res["rows"], res["trainer"], "run")
        losses = np.array([list(l.values()) for l in res["losses"]])
        secs = np.array(res["step_seconds"])
        bound = np.array(res["boundary_seconds"])
        program = res["program"]
        rows = regular_rows(torch, cfg, res["trainer"].pair, 10, 25)
        replay = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            program.run(rows, False)
            replay.append((time.perf_counter() - t1) * 1e3 / len(rows))
        replay_ms = sorted(replay)[1]
        # the boundary's render on an idle device, for its own host time
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res["trainer"].render_u8()
        render_host = time.perf_counter() - t1
        torch.cuda.synchronize()
        render_all = time.perf_counter() - t1
        steady_ms = 1e3 * secs[10:].mean()
        print(f"  {len(losses)} steps in {len(res['chunks'])} chunks, "
              f"{wall:.1f} s in train_pair (the model and pair built before "
              f"it); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"  sustained {res['steps_per_sec']:.3f} steps/s over the run "
              f"(renders, saves, metrics and checkpoints included; the "
              f"first chunks' eager steps and captures too); "
              f"{(len(secs) - 10) / secs[10:].sum():.3f} steps/s over steps "
              f"10-{len(secs) - 1}; replayed step {replay_ms:.2f} ms "
              f"({1e3 / replay_ms:.3f} steps/s; chunks of 10, median of 3: "
              + ", ".join(f"{v:.2f}" for v in replay) + ")")
        print(f"  steps 10-{len(secs) - 1}: {steady_ms:.2f} ms a step "
              f"against the replayed {replay_ms:.2f}: log boundaries and "
              f"checkpoints add {steady_ms - replay_ms:.2f} ms a step")
        print(f"  log boundaries: {len(bound)}, {bound.sum():.3f} s of the "
              f"loop's host time in all ({1e3 * bound.mean():.2f} ms each, "
              f"largest {1e3 * bound.max():.2f}: render_u8 queued behind "
              f"the chunk just queued, the frame's copy, log_async); "
              f"render_u8 on an idle device {1e3 * render_host:.2f} ms of "
              f"host time, {1e3 * render_all:.2f} ms to its end; PNG "
              f"encoder: {pngio.encoder()}")
        for i in sorted({0, 1, 9, 10, 75, RUN_RESUME - 1, RUN_RESUME,
                         RUN_STEPS - 1} & set(range(len(secs)))):
            print(f"  step {i:3d} {secs[i] * 1e3:9.2f} ms "
                  + " ".join(f"{k}={v:.5f}"
                             for k, v in res["losses"][i].items()))
        if len(losses) != RUN_STEPS or not np.isfinite(losses).all():
            fail("the run's losses are not all finite")
        check_output(torch, "run", res["output"])
        png = np.asarray(Image.open(os.path.join(tmp, "out", "output.png")))
        print(f"  output.png {png.shape}, equal to the run's last uint8 "
              f"frame: {np.array_equal(png, res['output_u8'].cpu().numpy())}")
        if not np.array_equal(png, res["output_u8"].cpu().numpy()):
            fail("output.png is not the run's last frame")
        check_metrics(metrics, res, RUN_STEPS, cfg.log_images_freq)
        saved = sorted(os.listdir(ck))
        print(f"  checkpoints: {saved}")
        if saved != [f"ckpt_{s}.pt" for s in range(RUN_STEPS - 2 * RUN_CKPT,
                                                   RUN_STEPS + 1, RUN_CKPT)]:
            fail(f"checkpoints missing: {saved}")

        resume = os.path.join(tmp, "resume")
        os.makedirs(resume)
        shutil.copy(os.path.join(ck, f"ckpt_{RUN_RESUME}.pt"), resume)
        rcfg = run_config(scheduler_policy="cosine", resume_from=resume,
                          checkpoint_every=RUN_CKPT,
                          checkpoint_dir=os.path.join(tmp, "ck2"),
                          metrics_path=os.path.join(tmp, "m2.jsonl"))
        rres = train_pair(rcfg, dataroot=os.path.join(tmp, "r"), **shared)
        same_rows = np.array_equal(rres["rows"].view(np.int32),
                                   res["rows"][RUN_RESUME:].view(np.int32))
        first = (rres["losses"][0], res["losses"][RUN_RESUME])
        print(f"  resumed from step {rres['first_step']}: "
              f"{len(rres['losses'])} steps in chunks {rres['chunks']}; rows "
              f"bitwise equal to the run's {RUN_RESUME}-{RUN_STEPS - 1}: "
              f"{same_rows}; step {RUN_RESUME}: resumed "
              + " ".join(f"{v!r}" for v in first[0].values()) + ", run "
              + " ".join(f"{v!r}" for v in first[1].values()))
        if (rres["first_step"] != RUN_RESUME or not same_rows
                or first[0] != first[1]):
            fail("the resumed run is not the uninterrupted run's")
        del rres

        check_boundary_sync_free(torch, res, tmp)
        del res, program
        torch.cuda.empty_cache()
        for name in ("rmsprop", "sgd"):
            check_optimizer_in_graphs(torch, name, shared,
                                      os.path.join(tmp, name), kernels)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The DINOv2 paths (phase 9): (name, model, steps). Step 0 and 10 are
# entire-A steps; step 1 runs eagerly before the regular graph's capture.
DINOV2_PATHS = (("vitl14", "dinov2_vitl14", MAIN_STEPS),
                ("vitb14_reg", "dinov2_vitb14_reg", 4))
VIDEO_STEPS = (20, 10)   # the first frame's steps, each later frame's


def run_dinov2(torch, kernels, base, pair):
    """Phase 9: train_pair with each of DINOV2_PATHS at full width (896
    canvas, 224 loss resolution, bf16, seeded weights) through the
    program, with run_path's gates (every K1/K2 launch on the tensor cores,
    K1/K2 and the main convs launched inside the graphs, finite losses and
    output); the graphs against eager steps (phase 4b's gate); a profile of
    replays. Returns each path's launches and replayed ms."""
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.models.vit import get_vit_config
    out = {}
    for name, model, n in DINOV2_PATHS:
        print(f"phase 9: the {name} path ({model}, 224-px loss resolution, "
              f"896 canvas), {n} steps")
        cfg = load_config(None, dict(base, dino_model_name=model))
        vcfg = get_vit_config(model)
        print(f"  {vcfg.depth} layers, D {vcfg.embed_dim}, "
              f"{vcfg.num_heads} heads, patch {vcfg.patch_size}, "
              f"{vcfg.num_register_tokens} registers, layer scale "
              f"{vcfg.layerscale_init}")
        res, launches = run_path(
            torch, name, cfg, n, kernels,
            ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid", "conv_dw"),
            pair=pair)
        ext = res["trainer"].extractor
        ms = profile_steps(torch, res["program"], cfg)
        del res
        torch.cuda.empty_cache()
        program = check_replay(torch, name, cfg, one_pair(cfg, pair, ext),
                               pair)
        del program, ext
        torch.cuda.empty_cache()
        out[name] = (launches, ms)
    return out


def run_video(torch, kernels, main_ms):
    """Phase 10: train_video over a 3-frame clip made from the cows pair as
    bench_configs.config_d makes it (identical frames; seed 0,
    log_images_freq 10), VIDEO_STEPS steps, the counts set to 0 just
    before and read just after. Gates: frames 1 and 2 capture nothing (the
    program's captures and graphs as after frame 0) and run on frame 0's
    program; each warm frame starts from the previous frame's final flat,
    bitwise, with the optimizer's moments and step at zero, and its first
    row equal to frame 0's (the draws restart); three <frame>_out.png of
    [900, 1200, 3]; every loss finite; every kernel of the main path
    launched inside the graphs, every K1/K2 and conv launch on the tensor
    cores. Prints each frame's steps/s; the last is the steady rate."""
    import shutil
    import tempfile
    import numpy as np
    from PIL import Image
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.video import train_video
    tmp = tempfile.mkdtemp(prefix="chip_smoke_video_")
    try:
        cows = "datasets/splicing/cows"
        os.makedirs(os.path.join(tmp, "A"))
        os.makedirs(os.path.join(tmp, "B"))
        src_a = sorted(os.listdir(os.path.join(cows, "A")))[0]
        src_b = sorted(os.listdir(os.path.join(cows, "B")))[0]
        ext = os.path.splitext(src_a)[1]
        for i in range(3):
            shutil.copy(os.path.join(cows, "A", src_a),
                        os.path.join(tmp, "A", f"frame_{i:03d}{ext}"))
        shutil.copy(os.path.join(cows, "B", src_b), os.path.join(tmp, "B"))
        cfg = load_config(None, dict(dataroot=tmp, seed=0, video_mode=True,
                                     log_images_freq=10))
        frames = []

        def on_frame(idx, res):
            p = res["program"]
            frames.append(dict(
                program=p, captures=p.captures, graphs=len(p.graphs),
                start=res["start_state"], flat=res["flat"],
                row0=res["rows"][0], rate=res["steps_per_sec"],
                losses=np.array([list(l.values()) for l in res["losses"]])))

        zero_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_video(cfg, *VIDEO_STEPS, on_frame=on_frame)
        wall = time.perf_counter() - t0
        program = frames[0]["program"]
        launches, tc = read_launches(
            torch, kernels, "video", ("attn_qkv_fwd", "attn_qkv_bwd",
                                      "conv_valid", "conv_dw"), [program])
        check_tc_launches(launches, tc, "video")
        print(f"  {len(frames)} frames in {wall:.1f} s (the extractor and "
              f"B built inside); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"replays {[c.replays for c in program.graphs.values()]}")
        for i, f in enumerate(frames):
            opt = {k: v for k, v in f["start"].items() if k != "flat"}
            checks = dict(
                same_program=f["program"] is program,
                captures=(f["captures"], f["graphs"]),
                finite=bool(np.isfinite(f["losses"]).all()))
            if i:
                prev = frames[i - 1]
                checks.update(
                    start_is_previous_flat=bool(torch.equal(
                        f["start"]["flat"], prev["flat"])),
                    fresh_optimizer=sorted(opt) == ["exp_avg", "exp_avg_sq",
                                                    "step"]
                    and not any(bool(v.any()) for v in opt.values()),
                    first_row_is_frame0s=bool(np.array_equal(
                        f["row0"].view(np.int32),
                        frames[0]["row0"].view(np.int32))))
            print(f"  frame {i}: {out['frames'][i]['steps']} steps, "
                  f"{f['rate']:.3f} steps/s"
                  + (" (the steady rate)" if i == len(frames) - 1 else "")
                  + f"; last loss {f['losses'][-1, -1]:.5f}; {checks}")
            if not (checks["same_program"] and checks["finite"]
                    and checks["captures"] == (frames[0]["captures"],
                                               frames[0]["graphs"])
                    and all(checks.get(k, True) for k in (
                        "start_is_previous_flat", "fresh_optimizer",
                        "first_row_is_frame0s"))):
                fail(f"video frame {i}: {checks}")
        steady = frames[-1]["rate"]
        print(f"  steady frame {steady:.3f} steps/s against the main path's "
              f"replayed {1e3 / main_ms:.3f} ({main_ms:.2f} ms a step, phase "
              f"5): {steady * main_ms / 1e3:.3f} of it")
        for i in range(3):
            path = os.path.join(tmp, "out", f"frame_{i:03d}_out.png")
            shape = np.asarray(Image.open(path)).shape
            if shape != (900, 1200, 3):
                fail(f"{path}: shape {shape}")
        print("  frame_000_out.png .. frame_002_out.png: [900, 1200, 3]")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


CONFIG_C_STEPS = 12      # phase 11: step 0 entire-A, the rest regular
PAIR_MODE_STEPS = 4      # the P = 2 pallas and fused runs
# (generator_conv, image_hw, kernels that must launch inside the graphs):
# at a 224 canvas fused routes no conv to the kernels (the reference's
# rule: a site fuses at 448 or more wide), so its P = 2 run is at 448
PAIR_MODES = (("pallas", 224, ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                               "conv_dw", "conv_valid_s2d", "conv_dw_s2d")),
              ("fused", 448, ("attn_qkv_fwd", "attn_qkv_bwd",
                              "conv_valid_pro", "conv_dw_pro")))


def copy_pairs(tmp, n: int):
    """n dataroots under tmp, pair i a copy of PAIR_ROOTS[i % 2]'s A and B
    (each pair writes its own out/)."""
    import shutil
    roots = []
    for i in range(n):
        src = PAIR_ROOTS[i % 2]
        dst = os.path.join(tmp, f"pair{i}_{os.path.basename(src)}")
        for sub in ("A", "B"):
            shutil.copytree(os.path.join(src, sub), os.path.join(dst, sub))
        roots.append(dst)
    return roots


def run_pairs(torch, name, cfg, roots, image_hw, n_steps, kernels, need,
              extractor):
    """train_pairs with every launch count set to 0 just before and read
    just after; fails on a non-finite loss, a missing or misshapen output
    or metrics file, or when a kernel in `need` was launched no time
    inside the graphs or off the tensor cores. Returns (result, launches,
    peak GiB)."""
    import json as json_lib
    import numpy as np
    from PIL import Image
    from splice_tpu_torch.parallel.pair_parallel import train_pairs
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    res = train_pairs(cfg, roots, image_hw, n_steps, extractor=extractor)
    launches, tc = read_launches(torch, kernels, name, need,
                                 [res["program"]])
    check_tc_launches(launches, tc, name)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  chunks {res['chunks']}; {res['pair_steps_per_sec']:.3f} "
          f"pair-steps/s ({res['steps_per_sec']:.3f} steps/s) over the run, "
          f"captures, renders and saves included; peak memory {peak:.2f} "
          f"GiB (the graphs' pools included)")
    seq = res["loss_seq"]
    for i, l in enumerate(seq[:, :, -1]):
        print(f"  step {i:2d} loss by pair " + " ".join(f"{v:.5f}" for v in l))
    if seq.shape[:2] != (n_steps, len(roots)) or not np.isfinite(seq).all():
        fail(f"{name}: losses {seq.shape}, finite {np.isfinite(seq).all()}")
    for root in roots:
        png = np.asarray(Image.open(os.path.join(root, "out", "output.png")))
        with open(os.path.join(root, "out", "metrics.jsonl")) as f:
            recs = [json_lib.loads(line) for line in f]
        if png.shape != (image_hw, image_hw, 3) or not recs or not all(
                "loss" in r and "lr" in r and "steps_per_sec" in r
                for r in recs):
            fail(f"{name}: {root}: output {png.shape}, {len(recs)} records")
    print(f"  {len(roots)} output.png of [{image_hw}, {image_hw}, 3] and "
          f"{len(roots)} metrics.jsonl (records at steps "
          f"{[r['step'] for r in recs]})")
    return res, launches, peak


def run_config_c(torch, kernels, extractor, main_ms):
    """Phase 11: bench_configs.config_c on one card: train_pairs on [cows,
    apples2oranges] x 4 at image_hw 224 (the reference's keys: seed 3,
    n_pairs 8, dino_vitb8 with seeded weights, bf16, generator_conv auto,
    log_images_freq 10, entire_A_every 75), CONFIG_C_STEPS steps, with
    run_pairs' gates (every K1/K2 launch inside the graphs and on the
    tensor cores); the replayed step and the device's share (profile);
    the graphs against eager steps from one cloned state (phase 4b's
    rule) and one chunk under the sync debug mode. Then PAIR_MODE_STEPS
    steps of two pairs under each of PAIR_MODES: K3/K4 in their forms
    inside the pair loop, on the tensor cores. Returns the launches by
    path, and config c's first MESH_STEPS rows and losses and its
    pair-steps/s (phase 13 holds the mesh against them)."""
    import dataclasses
    import shutil
    import tempfile
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.parallel.pair_parallel import MultiPairTrainer
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pairs_")
    launches = {}
    try:
        roots = copy_pairs(tmp, 8)
        cfg = load_config(None, dict(seed=3, n_pairs=8))
        res, launches["config_c"], _ = run_pairs(
            torch, "config_c", cfg, roots, 224, CONFIG_C_STEPS, kernels,
            ("attn_qkv_fwd", "attn_qkv_bwd"), extractor)
        first = {"rows": res["rows"][:MESH_STEPS],
                 "loss_seq": res["loss_seq"][:MESH_STEPS],
                 "pair_steps_per_sec": res["pair_steps_per_sec"]}
        replayed = {k: c.replays for k, c in res["program"].graphs.items()}
        rate = res["pair_steps_per_sec"]
        print(f"  graphs (entire, SAME route, DW_TAP_ON_N): replays "
              f"{replayed}")
        ms = profile_steps(torch, res["program"], cfg)
        first["replay_ms"] = ms
        print(f"  config c: a replayed 8-pair step {ms:.2f} ms, "
              f"{8e3 / ms:.3f} pair-steps/s replayed, {rate:.3f} sustained "
              f"by train_pairs; the main path's 1-pair step {main_ms:.2f} "
              f"ms ({1e3 / main_ms:.3f} pair-steps/s)")
        pairs = [t.pair for t in res["trainer"].trainers]
        del res
        torch.cuda.empty_cache()
        program = check_replay(
            torch, "config c", cfg,
            lambda: MultiPairTrainer(cfg, pairs, extractor,
                                     seeds=list(range(8))), pairs)
        check_sync_free(torch, program, cfg)
        del program, pairs
        torch.cuda.empty_cache()
        for mode, hw, need in PAIR_MODES:
            print(f"phase 11b: two pairs, generator_conv={mode}, image_hw "
                  f"{hw}, {PAIR_MODE_STEPS} steps")
            pres, launches[f"pairs_{mode}"], _ = run_pairs(
                torch, f"pairs_{mode}", dataclasses.replace(
                    cfg, generator_conv=mode, n_pairs=2),
                roots[:2], hw, PAIR_MODE_STEPS, kernels, need, extractor)
            del pres
            torch.cuda.empty_cache()
        return launches, first
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


INV_ITERS, INV_LOG = 61, 20    # phase 12: steps 0..60, logs at 0, 20, 40, 60
LIMES = "datasets/feature_visualization/limes.jpeg"


@contextlib.contextmanager
def k_recorder(conv):
    """Count the conv kernels' launches by (wrapper, k), split into eager
    calls and calls recorded while a graph is captured: the wrappers count
    calls, not k, and the inversion's gate is on k. Yields the two
    Counters."""
    from collections import Counter
    import torch
    eager, captured = Counter(), Counter()
    fwd, dw = conv._launch_fwd, conv._launch_dw

    def tally(name, k):
        cap = torch.cuda.is_current_stream_capturing()
        (captured if cap else eager)[(name, k)] += 1

    def rec_fwd(x, w, *a, **kw):
        tally(a[6] if len(a) > 6 else kw["name"], w.shape[0])
        return fwd(x, w, *a, **kw)

    def rec_dw(x, g, k, *a, **kw):
        tally(a[5] if len(a) > 5 else kw["name"], k)
        return dw(x, g, k, *a, **kw)

    conv._launch_fwd, conv._launch_dw = rec_fwd, rec_dw
    try:
        yield eager, captured
    finally:
        conv._launch_fwd, conv._launch_dw = fwd, dw


def lpips_weights(seed):
    """Seeded AlexNet and LPIPS-head weights in evaluate's npz layout."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shapes = {"conv1": (64, 3, 11, 11), "conv2": (192, 64, 5, 5),
              "conv3": (384, 192, 3, 3), "conv4": (256, 384, 3, 3),
              "conv5": (256, 256, 3, 3)}
    w = {}
    for i, (name, sh) in enumerate(shapes.items()):
        w[f"{name}_w"] = (rng.standard_normal(sh)
                          / np.sqrt(sh[1] * sh[2] * sh[3])).astype(np.float32)
        w[f"{name}_b"] = (0.1 * rng.standard_normal(sh[0])).astype(np.float32)
        w[f"lin{i + 1}_w"] = rng.random((1, sh[0])).astype(np.float32)
    return w


def profile_inversion(torch, program, n: int = 3):
    """Kernel ms per replayed inversion step (torch.profiler over n
    replays): every device kernel, and the port's own."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rows = np.full((n, 1), 0.5, np.float32)
    program.run(rows, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        program.run(rows, False)
        torch.cuda.synchronize()
    total = ours = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += t
        if any(k in e.key for k in OUR_KERNELS):
            ours += t
    return total / n / 1e3, ours / n / 1e3


# eager runs whose largest distance from the first measures the
# inversion's eager spread (phase 12): its losses after four Adam steps
# lie 4-16% apart from run to run and one other run's distance varies 4x
# from call to call on the H100, as phase 3's two-pair check found
INV_SPREAD_RUNS = 5


def check_inversion_replay(torch, step):
    """The inversion's graph against eager steps from one state (phase
    4b's rule): clones of the step's flat parameters, each with a fresh
    Adam, run four steps at noise magnitude 0 (so the noise each draws
    adds exactly 0), 1 + INV_SPREAD_RUNS times eagerly and once through
    SpliceProgram (one eager step, the capture, three replays); the
    program's losses and parameter update against the first eager run's,
    within REPLAY_MULT x the eager runs' spread (the largest distance of
    another eager run from the first) plus the floors. Adam's first steps
    move each parameter by about lr whatever the gradient's size, so a
    gradient entry near 0 whose sign the bilinear backward's atomics flip
    moves the run: that spread is wide. Then each step replayed from the
    state the first eager run had before it (flat and Adam's state copied
    in place) must give that run's loss within REPLAY_LOSS_FLOOR, and its
    gradient within REPLAY_MULT x the distance of two more eager steps
    from that same state to that run's gradient, plus
    REPLAY_UPDATE_FLOOR (relative L2)."""
    import numpy as np
    from splice_tpu_torch.tools.inversion import InversionStep
    from splice_tpu_torch.trainer import SpliceProgram
    flat0 = step.flat.detach().clone()

    def clone():
        s = InversionStep(step.g_apply, step.params(), step.extractor,
                          step.ref, step.base_noise, step.feature,
                          step.layer, 0.01, torch.Generator())
        with torch.no_grad():
            s.flat.copy_(flat0)
        return s

    def state(s):
        return [s.flat.detach(), *s.opt.state[s.flat].values()]

    rows = np.zeros((4, 1), np.float32)

    def eager(before=None):
        s, losses, grads = clone(), [], []
        for r in rows:
            if before is not None and s.opt.state:
                before.append([v.clone() for v in state(s)])
            losses.append(s.step(torch.from_numpy(r).cuda())["loss"].item())
            grads.append(s.flat.grad.detach().clone())
        return np.array(losses), s.flat.detach() - flat0, grads

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    def eager_grad_from(snap):
        """An eager step's gradient from a snapshot of flat and Adam's
        state (a first step gives the clone its Adam state)."""
        s = clone()
        s.step(torch.zeros(1, device="cuda"))
        with torch.no_grad():
            for dst, src in zip(state(s), snap):
                dst.copy_(src)
        s.step(torch.zeros(1, device="cuda"))
        return s.flat.grad.detach().clone()

    before = []
    l1, d1, g1 = eager(before)
    others = [eager() for _ in range(INV_SPREAD_RUNS)]
    program = SpliceProgram(clone(), 4)
    lp = program.run(rows, False)[:, 0]
    dp = program.trainer.flat.detach() - flat0
    same, gsame, geager = [], [], []
    for snap, want, gwant in zip(before, l1[1:], g1[1:]):
        with torch.no_grad():
            for dst, src in zip(state(program.trainer), snap):
                dst.copy_(src)
        same.append(abs(program.run(rows[:1], False)[0, 0] - want)
                    / abs(want))
        gsame.append(rel_l2(program.trainer.flat.grad, gwant))
        geager += [rel_l2(eager_grad_from(snap), gwant) for _ in range(2)]
    rel = float(np.max(np.abs(lp - l1) / np.maximum(np.abs(l1), 1e-12)))
    spread = max(float(np.max(np.abs(l2 - l1) / np.maximum(np.abs(l1),
                                                           1e-12)))
                 for l2, _, _ in others)
    upd = rel_l2(dp, d1)
    uspread = max(rel_l2(d2, d1) for _, d2, _ in others)
    gspread = max(geager)
    tol = (REPLAY_MULT * spread + REPLAY_LOSS_FLOOR,
           REPLAY_MULT * uspread + REPLAY_UPDATE_FLOOR,
           REPLAY_MULT * gspread + REPLAY_UPDATE_FLOOR)
    print(f"  graph against eager (4 steps at magnitude 0): eager spread "
          f"({INV_SPREAD_RUNS} runs against the first) losses {spread:.3e}, "
          f"update {uspread:.3e}; graph losses {rel:.3e} (tol "
          f"{tol[0]:.3e}), update {upd:.3e} (tol {tol[1]:.3e}); steps 1-3 "
          f"replayed from the eager run's state: losses {max(same):.3e} "
          f"(tol {REPLAY_LOSS_FLOOR:g}), gradient {max(gsame):.3e} "
          f"(relative L2; tol {tol[2]:.3e} = {REPLAY_MULT:g} x two eager "
          f"steps' distance from the same states {gspread:.3e} + "
          f"{REPLAY_UPDATE_FLOOR:g}); replays "
          f"{[c.replays for c in program.graphs.values()]}")
    if not (np.isfinite(lp).all() and rel <= tol[0] and upd <= tol[1]
            and len(same) == 3 and max(same) <= REPLAY_LOSS_FLOOR
            and max(gsame) <= tol[2]):
        fail("the inversion's captured graph disagrees with eager steps")


def run_inversion(torch, conv, kernels, inv_rows):
    """Phase 12: tools.inversion.invert on limes at resize 224 (224 x 281)
    at full width (dino_vitb8, seeded weights; the inversion net; bf16),
    feature cls, INV_ITERS steps at log_freq INV_LOG, with the default nhwc
    layout and with chw + pallas; then feature keys for a few steps, and
    evaluate's metrics of the output on the card against the CPU. Fills
    inv_rows' launches (per wrapper and k, chw + pallas) and returns the
    paths' launches."""
    import tempfile
    import numpy as np
    from PIL import Image
    from splice_tpu_torch.data import load_image
    from splice_tpu_torch.tools import evaluate, inversion as inv
    need = {"nhwc": ("attn_qkv_fwd", "attn_qkv_bwd"),
            "chw_pallas": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                           "conv_valid_s2d", "conv_dw", "conv_dw_s2d")}
    out_launches = {}
    tmp = tempfile.mkdtemp(prefix="inversion_")
    png = None
    for label, layout, mode in (("nhwc", "nhwc", "auto"),
                                ("chw_pallas", "chw", "pallas")):
        zero_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        logs = []
        png = os.path.join(tmp, f"inv_{label}.png")
        with k_recorder(conv) as (eager, captured):
            res = inv.invert(LIMES, png, n_iter=INV_ITERS, log_freq=INV_LOG,
                             generator_layout=layout, generator_conv=mode,
                             callback=lambda i, l, o: logs.append((i, l)))
        program = res["program"]
        launches, tc = read_launches(torch, kernels, f"inversion {label}",
                                     need[label], [program])
        check_tc_launches(launches, tc, f"inversion {label}")
        out_launches[f"inversion_{label}"] = launches
        replays = sum(c.replays for c in program.graphs.values())
        by_k = {key: eager[key] + captured[key] * replays
                for key in set(eager) | set(captured)}
        print(f"  {label}: chunks {res['chunks']}, logged "
              f"{[(i, round(l, 6)) for i, l in logs]}, final loss "
              f"{res['loss']:.6f}, ViT input {res['dino_input_hw']}; conv "
              f"launches by (wrapper, k): {dict(sorted(by_k.items()))}, "
              f"recorded in the graph {dict(sorted(captured.items()))}")
        img = np.asarray(Image.open(png))
        if ([i for i, _ in logs] != list(range(0, INV_ITERS, INV_LOG))
                or not all(math.isfinite(l) for _, l in logs)
                or not math.isfinite(res["loss"])):
            fail(f"inversion {label}: bad log steps or losses {logs}")
        if img.shape != (224, 281, 3) or res["dino_input_hw"] != (224, 281):
            fail(f"inversion {label}: PNG {img.shape}, ViT input "
                 f"{res['dino_input_hw']}")
        if label == "chw_pallas":
            for name in ("conv_valid", "conv_valid_s2d", "conv_dw",
                         "conv_dw_s2d"):
                if sum(n for (w, _), n in by_k.items()
                       if w == name) != launches[name]:
                    fail(f"{name}: launches by k {by_k} do not add up to "
                         f"{launches[name]}")
            for k in (4, 5, 7):
                k3 = [w for w in ("conv_valid", "conv_valid_s2d")
                      if captured[(w, k)]]
                k4 = [w for w in ("conv_dw", "conv_dw_s2d")
                      if captured[(w, k)]]
                if not k3 or not k4:
                    fail(f"chw + pallas: K3/K4 at k = {k} not launched "
                         f"inside the graph: {dict(captured)}")
            for key, row in inv_rows.items():
                row["launches"] = by_k.get(key, 0)
                if not row["launches"]:
                    fail(f"{key} never launched on the chw + pallas path")
        rows = np.full((INV_LOG, 1), 0.5, np.float32)
        program.run(rows[:1], False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.run(rows, False)
        ms = (time.perf_counter() - t0) / INV_LOG * 1e3
        dev_ms, our_ms = profile_inversion(torch, program)
        print(f"  {label}: {1e3 / ms:.2f} iterations/s replayed ({ms:.3f} "
              f"ms a step, a chunk of {INV_LOG} with its one read), "
              f"{INV_ITERS / res['wall_time']:.2f} iterations/s sustained "
              f"over the run ({res['wall_time']:.2f} s: the first step "
              f"eager, the capture, {len(res['chunks'])} chunks, "
              f"{INV_ITERS // INV_LOG + 1} renders); kernels "
              f"{dev_ms:.3f} ms a step, the port's own {our_ms:.3f} ms; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB")
        check_inversion_replay(torch, res["step"])
        del res, program
        torch.cuda.empty_cache()
    logs = []
    res = inv.invert(LIMES, os.path.join(tmp, "inv_keys.png"),
                     feature="keys", n_iter=5, log_freq=2,
                     callback=lambda i, l, o: logs.append((i, l)))
    print(f"  feature keys, 5 steps (nhwc): logged {logs}, final loss "
          f"{res['loss']:.6f}")
    if [i for i, _ in logs] != [0, 2, 4] or not all(
            math.isfinite(l) for _, l in logs):
        fail(f"inversion keys: bad log steps or losses {logs}")
    del res
    out = evaluate.load01(png)
    ref = load_image(LIMES, 224).astype(np.float64)
    w = lpips_weights(3)
    card = evaluate.lpips(out, ref, w)
    cpu = evaluate.lpips(out, ref, w, device="cpu")
    rel = abs(card - cpu) / abs(cpu)
    print(f"  evaluate on the chw + pallas output against limes: psnr "
          f"{evaluate.psnr(out, ref):.3f} dB, ssim "
          f"{evaluate.ssim(out, ref):.4f} (numpy on the host, as in the "
          f"reference); lpips (seeded "
          f"AlexNet) card {card:.6f}, CPU {cpu:.6f}, rel {rel:.2e} (tol "
          f"1e-4: fp32 convs, TF32 off, in another order)")
    if not (math.isfinite(card) and rel <= 1e-4):
        fail("lpips on the card disagrees with the CPU")
    return out_launches


def run_inversion_fp32(torch, kernels):
    """invert at compute_dtype float32 (generator and ViT), nhwc, three
    steps: K1/K2 launched inside the graph on the CUDA cores (fp32 keeps
    the port's fp32 kernels; no tc launch). Returns the launches."""
    import tempfile
    import numpy as np
    from splice_tpu_torch.tools import inversion as inv
    zero_counts(kernels)
    res = inv.invert(LIMES, os.path.join(tempfile.mkdtemp(), "inv32.png"),
                     n_iter=3, log_freq=2, compute_dtype="float32")
    launches, tc = read_launches(torch, kernels, "inversion fp32",
                                 ("attn_qkv_fwd", "attn_qkv_bwd"),
                                 [res["program"]])
    rows = np.full((2, 1), 0.5, np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        res["program"].run(rows, False)
    ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"  final loss {res['loss']:.6f}; {1e3 / ms:.2f} iterations/s "
          f"replayed ({ms:.3f} ms a step, chunks of 2); tensor-core "
          f"launches { {k: tc[k] for k in ATTENTION} }")
    if not math.isfinite(res["loss"]) or any(tc[k] for k in ATTENTION):
        fail("fp32 inversion: non-finite loss or bf16 attention launches")
    return launches


MESH_STEPS = 3     # phase 13: step 0 entire-A, steps 1-2 regular
MESH_CKPT_PAIRS = 2


@contextlib.contextmanager
def head_recorder(attn):
    """Count the attention kernels' launches by (wrapper, heads), split
    into eager calls and calls recorded while a graph is captured (the
    wrappers count calls, not heads; the mesh phase's gate is on the
    heads a tensor-parallel rank holds). Yields the two Counters."""
    from collections import Counter
    import torch
    eager, captured = Counter(), Counter()
    # the dispatchers the autograd Functions call (each calls its counted
    # _cuda wrapper on a CUDA tensor)
    names = ("attn_qkv_fwd", "attn_qkv_bwd", "attn_fwd", "attn_bwd")
    saved = {n: getattr(attn, n) for n in names}

    def wrap(name, fn):
        def rec(*a, **kw):
            heads = a[1] if name == "attn_qkv_fwd" else (
                a[2] if name == "attn_qkv_bwd" else a[0].shape[1])
            cap = torch.cuda.is_current_stream_capturing()
            (captured if cap else eager)[(name, heads)] += 1
            return fn(*a, **kw)
        return rec

    for n, fn in saved.items():
        setattr(attn, n, wrap(n, fn))
    try:
        yield eager, captured
    finally:
        for n, fn in saved.items():
            setattr(attn, n, fn)


def check_tp4_vit(torch, attn, extractor, devices=None):
    """ViT-B/8 (the main path's bf16 weights) at tp = 4 over `devices`
    (default [cuda:0] * 4) on a batch of 8 at 224 against tp = 1: the
    block and qkv taps of layer 11 and the input gradient of a seeded
    weighted sum of them. bf16 rounds each rank's row-parallel partial
    sum before the add, 24 times on the way to layer 11, so the gate is
    relative to bf16's own error: tp = 4's distance from tp = 1 (relative
    L2) at most twice tp = 1's distance from the same forward in fp32.
    Every attention launch at 3 heads on K5/K6 (local D 192 fails the
    fused-qkv gate). Returns the K5/K6 launches."""
    from splice_tpu_torch.models import vit as vit_lib
    from splice_tpu_torch.parallel import mesh as mesh_lib
    from splice_tpu_torch.utils.tree import tree_map
    cfg = extractor.cfg
    mesh = mesh_lib.make_mesh(1, 4, devices or ["cuda:0"] * 4)
    ranks = mesh_lib.shard_vit_params(mesh_lib.manual_tp_permute_vit_params(
        extractor.params, cfg, 4), mesh)[0]
    gen = torch.Generator().manual_seed(31)
    img = torch.randn(8, 224, 224, 3, generator=gen).cuda()
    N, D = 785, cfg.embed_dim
    w = {"qkv": torch.randn(8, N, 3 * D, generator=gen).cuda(),
         "block": torch.randn(8, N, D, generator=gen).cuda()}
    taps = {k: (11,) for k in w}
    runs = {}
    for name, params, devs, dt in (
            ("fp32", tree_map(lambda t: t.float(), extractor.params), None,
             torch.float32),
            ("tp1", extractor.params, None, torch.bfloat16),
            ("tp4", ranks, mesh.devices[0], torch.bfloat16)):
        x = img.clone().requires_grad_(True)
        with head_recorder(attn) as (eager, _):
            out = vit_lib.vit_forward(params, x, cfg, taps, dt,
                                      devices=devs)
            sum((out[k][11].float() * w[k]).sum() for k in w).backward()
        runs[name] = ({**{k: out[k][11].float() for k in w}, "grad": x.grad},
                      dict(eager))
    heads = runs["tp4"][1]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    ok = True
    for k in ("qkv", "block", "grad"):
        d41 = rel(runs["tp4"][0][k], runs["tp1"][0][k])
        d1 = rel(runs["tp1"][0][k], runs["fp32"][0][k])
        d4 = rel(runs["tp4"][0][k], runs["fp32"][0][k])
        ok &= d41 <= 2 * d1
        print(f"  tp=4 ViT-B/8 {k} [8,224,224,3] bf16 (relative L2): tp=4 "
              f"from tp=1 {d41:.3e} (tol {2 * d1:.3e} = 2 x tp=1 from "
              f"fp32); tp=4 from fp32 {d4:.3e}")
    print(f"  tp=4 attention launches by (wrapper, heads): {heads}")
    if not ok:
        fail("the tp = 4 ViT is further from tp = 1 than bf16's rounding")
    if set(h for _, h in heads) != {3} or not heads.get(("attn_fwd", 3)):
        fail(f"tp=4 did not run K5/K6 at 3 heads: {heads}")
    return {"attn_fwd": heads[("attn_fwd", 3)],
            "attn_bwd": heads.get(("attn_bwd", 3), 0)}


def run_mesh(torch, attn, kernels, extractor, first, devices=None):
    """Phase 13: config c's eight pairs at dp = 2 x tp = 2 over [cuda:0] *
    4 (train_pairs with a make_mesh mesh: two groups of four pairs, each
    group's ViT over two tensor-parallel ranks), MESH_STEPS steps. Gates:
    the rows equal phase 11's; every pair's losses within the tolerance
    of phase 11's dp = tp = 1 run (the larger of bf16's and 2 x the eager
    spreads phases 4b and 11 measured); K1/K2 launched inside both
    groups' graphs, on the tensor cores, every launch at 6 heads. Prints
    pair-steps/s (informational: four ranks share one card). Then
    train_pairs over two pairs with mesh_dp 2 (a dp = 2 mesh on [cuda:0]
    * 2) checkpoints, and a run at dp = 1 resumed from it holds every
    pair's parameters and Adam state, equal; and the tp = 4 ViT
    (check_tp4_vit). `devices`, four distinct cards, runs the same over
    them (--mesh-cards): each tp group then steps eagerly, so K1/K2 are
    held to launches, not graph replays. Returns the launches by path."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.parallel import mesh as mesh_lib
    from splice_tpu_torch.parallel.pair_parallel import train_pairs
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    launches = {}
    try:
        roots = copy_pairs(tmp, 8)
        cfg = load_config(None, dict(seed=3, n_pairs=8, mesh_dp=2,
                                     mesh_tp=2))
        devices = devices or ["cuda:0"] * 4
        mesh = mesh_lib.make_mesh(2, 2, devices)
        graphed = devices[0] == devices[1]
        zero_counts(kernels)
        with head_recorder(attn) as (eager, captured):
            res = train_pairs(cfg, roots, 224, MESH_STEPS,
                              extractor=extractor, mesh=mesh)
        launches["mesh"], tc = read_launches(
            torch, kernels, "mesh",
            ("attn_qkv_fwd", "attn_qkv_bwd") if graphed else (),
            res["programs"])
        check_tc_launches(launches["mesh"], tc, "mesh")
        heads = {k for k in (*eager, *captured)}
        print(f"  mesh {res['mesh'].shape}, groups of "
              f"{[t.n_pairs for t in res['trainers']]} pairs, graphed "
              f"{[p.graphed for p in res['programs']]}; attention calls by "
              f"(wrapper, heads): eager {dict(eager)}, recorded in graphs "
              f"{dict(captured)}; chunks {res['chunks']}; "
              f"{res['pair_steps_per_sec']:.3f} pair-steps/s over the run "
              f"(informational: four ranks share one card; phase 11's "
              f"dp = tp = 1 run {first['pair_steps_per_sec']:.3f} over "
              f"its {CONFIG_C_STEPS} steps)")
        if heads != {("attn_qkv_fwd", 6), ("attn_qkv_bwd", 6)} or any(
                p.graphed != graphed for p in res["programs"]):
            fail(f"mesh: K1/K2 not at 6 heads, or graphs not as the "
                 f"devices allow: {heads}")
        ms = mesh_replay_ms(torch, cfg, res)
        print(f"  a replayed 8-pair step over the mesh {ms:.2f} ms "
              f"({8e3 / ms:.3f} pair-steps/s; informational: four ranks "
              f"share one card), phase 11's dp = tp = 1 step "
              f"{first['replay_ms']:.2f} ms ({8e3 / first['replay_ms']:.3f})")
        if not np.array_equal(res["rows"], first["rows"]):
            fail("mesh: the rows differ from config c's at dp = tp = 1")
        seq, ref = res["loss_seq"][..., -1], first["loss_seq"][..., -1]
        rel = np.abs(seq - ref) / np.abs(ref)
        spread = max((SPREADS[k][0] for k in ("full width", "config c")
                      if k in SPREADS), default=0.0)
        tol = max(RTOL["bfloat16"][0], 2 * spread)
        for i in range(MESH_STEPS):
            print(f"  step {i} total by pair, mesh: "
                  + " ".join(f"{v:.5f}" for v in seq[i]) + "; dp = tp = 1: "
                  + " ".join(f"{v:.5f}" for v in ref[i])
                  + f"; largest relative difference {rel[i].max():.3e}")
        print(f"  tolerance {tol:.3e} = max(bf16's {RTOL['bfloat16'][0]:g}, "
              f"2 x the eager spread {spread:.3e} of phases 4b and 11)")
        if not (np.isfinite(seq).all() and rel.max() <= tol):
            fail(f"mesh: per-pair losses differ from dp = tp = 1 by "
                 f"{rel.max():.3e} > {tol:.3e}")
        del res
        torch.cuda.empty_cache()

        ck = os.path.join(tmp, "ck")
        ccfg = dataclasses.replace(cfg, n_pairs=MESH_CKPT_PAIRS, mesh_tp=1,
                                   checkpoint_every=2, checkpoint_dir=ck)
        dp2 = train_pairs(ccfg, roots[:MESH_CKPT_PAIRS], 224, 2,
                          extractor=extractor,
                          mesh=mesh_lib.make_mesh(2, 1, devices[::2]))
        back = train_pairs(dataclasses.replace(
            ccfg, mesh_dp=1, checkpoint_every=0, resume_from=ck),
            roots[:MESH_CKPT_PAIRS], 224, 2, extractor=extractor)

        def states(r):
            """Every pair's flat and Adam state, on the host (the two
            runs' groups may sit on different cards)."""
            return [(t.flat.detach().cpu(),
                     {k: v.cpu() for k, v in
                      t.opt.state_dict()["state"][0].items()})
                    for mp in r["trainers"] for t in mp.trainers]

        same = all(torch.equal(fa, fb) and all(
            torch.equal(sa[k], v) for k, v in sb.items())
            for (fa, sa), (fb, sb) in zip(states(back), states(dp2)))
        print(f"  mesh_dp=2 ({dp2['mesh'].shape}) checkpointed at step 2; "
              f"resumed at {back['mesh'].shape}: first step "
              f"{back['first_step']}, every pair's flat and Adam state "
              f"equal: {same}")
        if not same or back["first_step"] != 2 or back["mesh"].dp != 1:
            fail("mesh: a dp = 2 checkpoint did not resume at dp = 1")
        del dp2, back
        torch.cuda.empty_cache()
        launches["mesh_tp4"] = check_tp4_vit(torch, attn, extractor,
                                             devices)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_replay_ms(torch, cfg, res, rounds: int = 5) -> float:
    """Host-clock ms per replayed regular 8-pair step over the mesh: every
    dp group's chunk (as long as its program holds) queued, `rounds`
    times, then one read of each group; the median of three. First, where
    every group replays graphs, one chunk on every group queued under the
    sync debug mode: fails if the host waits for the device before the
    last group's replay."""
    from splice_tpu_torch.parallel import mesh as mesh_lib
    progs = res["programs"]
    groups = mesh_lib.dp_sharding(res["mesh"], 8)
    pairs = [t.pair for mp in res["trainers"] for t in mp.trainers]
    n = progs[0].rows.shape[0]
    rows = regular_rows(torch, cfg, pairs, n * rounds, 7)
    if all(p.graphed for p in progs):
        # every group's chunk queued with no host synchronisation: the
        # host reaches the last group's replay before any group's read
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for p, ids in zip(progs, groups):
                p.dispatch(rows[:n, ids.start:ids.stop], False)
        except RuntimeError as e:
            fail(f"mesh: queueing the groups' chunks synchronised: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"  one chunk of {n} steps queued on each of {len(progs)} dp "
              f"groups under sync debug mode 'error': no synchronisation")
    walls = []
    for _ in range(3):
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for r in range(rounds):
            for p, ids in zip(progs, groups):
                p.dispatch(rows[r * n:(r + 1) * n, ids.start:ids.stop],
                           False)
        for p in progs:
            p.fetch(n)
        walls.append((time.perf_counter() - t0) * 1e3 / (n * rounds))
    return sorted(walls)[1]


ABLATE_CHUNKS = 3      # phase 14's ablate runs (the tool's default: 20)


def run_observability(torch, kernels, base, shared, main_ms):
    """Phase 14: the main path with profile_dir (a window of 5 replayed
    regular steps, 12-16, in an 18-step run): the trace exists, and its
    K1 kernels are exactly 5 x the K1 calls the regular graph records, so
    the trace holds exactly the window's steps; tools/trace_agg.py on it.
    The main path with use_pallas_attention=false for MAIN_STEPS steps:
    no K1, K2, K5 or K6 launch, K3/K4 inside the graphs, the replayed
    regular step beside main's. tools/ablate.py at the default and with
    xlaattn (ABLATE_CHUNKS chunks of 10). Returns the xlaattn path's
    launches."""
    import dataclasses
    import json as json_lib
    import tempfile
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.tools import ablate, trace_agg
    from splice_tpu_torch.trainer import train_pair
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    start, n = 12, 5
    cfg = load_config(None, dict(base, profile_dir=tmp,
                                 profile_start_step=start,
                                 profile_n_steps=n))
    res = train_pair(cfg, n_steps=18, **shared)
    path = res["trace_path"]
    if not path or not os.path.exists(path):
        fail(f"profile_dir: no trace ({path})")
    with open(path) as f:
        events = trace_agg.device_events(json_lib.load(f))
    regular = [c for (entire, *_), c in res["program"].graphs.items()
               if not entire][0]
    per_step = regular.launches["attn_qkv_fwd_cuda"][0]
    k1 = sum("attn_fwd_kernel_tc<false>" in e["name"] for e in events)
    print(f"  chunks {res['chunks']}; trace {os.path.basename(path)} "
          f"({os.path.getsize(path) / 2**20:.1f} MiB): {len(events)} device "
          f"events, K1 kernels {k1} = {n} steps x {per_step} recorded in "
          f"the regular graph: {k1 == n * per_step}")
    if k1 != n * per_step or any(e.get("cat") == "cpu_op" for e in events):
        names = sorted({e["name"][:60] for e in events if "attn" in e["name"]})
        fail(f"the trace does not hold exactly {n} steps: {k1} K1 kernels, "
             f"attention kernels {names}")
    print(f"  tools/trace_agg.py {tmp} {n}:")
    trace_agg.main([tmp, str(n)])
    del res
    torch.cuda.empty_cache()

    xcfg = load_config(None, dict(base, use_pallas_attention=False))
    zero_counts(kernels)
    # the shared extractor is the main path's; this one takes the flag
    xres = train_pair(xcfg, n_steps=MAIN_STEPS, pair=shared["pair"],
                      extractor=dataclasses.replace(shared["extractor"],
                                                    use_pallas=False))
    launches, _ = read_launches(torch, kernels, "xlaattn",
                                ("conv_valid", "conv_dw"), [xres["program"]])
    if any(launches[k] for k in ATTENTION):
        fail(f"use_pallas_attention=false launched attention kernels: "
             f"{launches}")
    xms = profile_steps(torch, xres["program"], xcfg)
    print(f"  use_pallas_attention=false (SDPA): replayed regular step "
          f"{xms:.2f} ms against main's {main_ms:.2f} (K1/K2); K1/K2/K5/K6 "
          f"launches 0")
    del xres
    torch.cuda.empty_cache()
    for modes in ((), ("xlaattn",)):
        r = ablate.run(modes, chunks=ABLATE_CHUNKS)
        print(f"  tools/ablate.py {' '.join(modes)} ({ABLATE_CHUNKS} chunks "
              f"of {ablate.CHUNK}): mode={r['label']}: "
              f"{r['steps_per_sec']:.2f} steps/s  loss={r['loss']:.4f}")
        if not math.isfinite(r["loss"]):
            fail(f"ablate {modes}: non-finite loss")
        del r
        torch.cuda.empty_cache()
    return launches


def kernel_table(attn, conv):
    """name -> (wrapper, route, source, the TPU kernel it replaces, the
    path whose launches the JSON line reports)."""
    att, cnv = ("splice_tpu_torch/csrc/attention.cu",
                "splice_tpu_torch/csrc/conv.cu")
    return {
        "attn_qkv_fwd": (attn.attn_qkv_fwd_cuda, "cuda", att,
                         "splice_tpu/ops/attention.py:361", "main"),
        "attn_qkv_bwd": (attn.attn_qkv_bwd_cuda, "cuda", att,
                         "splice_tpu/ops/attention.py:447", "main"),
        "conv_valid": (conv.conv_valid_cuda, "cuda", cnv,
                       "splice_tpu/ops/conv_pallas.py:157", "main"),
        "conv_dw": (conv.conv_dw_cuda, "cuda", cnv,
                    "splice_tpu/ops/conv_pallas.py:401", "main"),
        "attn_fwd": (attn.attn_fwd_cuda, "cuda", att,
                     "splice_tpu/ops/attention.py:103", "480"),
        "attn_bwd": (attn.attn_bwd_cuda, "cuda", att,
                     "splice_tpu/ops/attention.py:191", "480"),
        "conv_valid_pro": (conv.conv_valid_pro_cuda, "cuda", cnv,
                           "splice_tpu/ops/conv_pallas.py:157", "fused"),
        "conv_dw_pro": (conv.conv_dw_pro_cuda, "cuda", cnv,
                        "splice_tpu/ops/conv_pallas.py:401", "fused"),
        "conv_valid_s2d": (conv.conv_valid_s2d_cuda, "cuda", cnv,
                           "splice_tpu/ops/conv_pallas.py:157", "pallas"),
        "conv_dw_s2d": (conv.conv_dw_s2d_cuda, "cuda", cnv,
                        "splice_tpu/ops/conv_pallas.py:401", "pallas"),
        "conv_same": (conv.conv_same_cuda, "cuda", cnv,
                      "splice_tpu/ops/conv_pallas.py:736", "pallas_same"),
        "conv_same_pro": (conv.conv_same_pro_cuda, "cuda", cnv,
                          "splice_tpu/ops/conv_pallas.py:770",
                          "fused_same_skip3"),
        "conv_same_pro_stats": (conv.conv_same_pro_stats_cuda, "cuda", cnv,
                                "splice_tpu/ops/conv_pallas.py:817",
                                "fused_same"),
        "conv_dw_gtap": (conv.conv_dw_gtap_cuda, "cuda", cnv,
                         "splice_tpu/ops/conv_pallas.py:455", "pallas_same"),
    }


def mesh_across_cards(torch, attn, conv, n: int) -> None:
    """--mesh-cards n: phase 13 alone over cuda:0..3 (n = 4 cards), held
    against a dp = tp = 1 run of the same steps on cuda:0."""
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.parallel import mesh as mesh_lib
    from splice_tpu_torch.parallel.pair_parallel import train_pairs
    from splice_tpu_torch.trainer import make_extractor_from_config
    import shutil
    import tempfile
    if n != 4 or torch.cuda.device_count() < n:
        fail(f"--mesh-cards {n}: needs 4, sees {torch.cuda.device_count()}")
    kernels = kernel_table(attn, conv)
    cfg = load_config(None, dict(seed=3, n_pairs=8))
    extractor = make_extractor_from_config(cfg, "cuda:0")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
    try:
        res = train_pairs(cfg, copy_pairs(tmp, 8), 224, MESH_STEPS,
                          extractor=extractor,
                          mesh=mesh_lib.make_mesh(1, 1, ["cuda:0"]))
        first = {"rows": res["rows"], "loss_seq": res["loss_seq"],
                 "pair_steps_per_sec": res["pair_steps_per_sec"],
                 "replay_ms": mesh_replay_ms(torch, cfg, res)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del res
    print(f"phase 13 over {n} cards: "
          f"{[torch.cuda.get_device_name(i) for i in range(n)]}")
    run_mesh(torch, attn, kernels, extractor, first,
             [f"cuda:{i}" for i in range(n)])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    cards = 0
    if sys.argv[1:2] == ["--mesh-cards"]:
        cards = int(sys.argv[2])
    t_start = time.perf_counter()
    from splice_tpu_torch.ops import _build
    from splice_tpu_torch.ops import attention as attn
    from splice_tpu_torch.ops import conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {smi}")

    mark(t_start)
    print("phase 1: build")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"  built and loaded {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    print_ptxas(_build)
    check_tensor_cores(_build)
    if cards:
        mesh_across_cards(torch, attn, conv, cards)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    kernels = kernel_table(attn, conv)
    rows = {name: {} for name in kernels}

    mark(t_start)
    print("phase 2: kernels against their plain versions")
    check_attention(torch, attn, rows)
    check_split_attention(torch, attn, rows)
    check_conv(torch, conv, rows)
    check_conv_pro(torch, conv, rows)
    check_conv_s2d(torch, conv, rows)
    check_edge_cases(torch, attn, conv)
    check_split_edge_cases(torch, attn)
    check_qkv_edge_cases(torch, attn)
    check_qkv_shapes(torch, attn, DINOV2_QKV)
    pair_rows = check_qkv_shapes(torch, attn, PAIRS_QKV)
    mesh_rows = {**check_qkv_shapes(torch, attn, MESH_QKV),
                 **check_split_shapes(torch, attn, MESH_SPLIT)}
    inv_qkv = {dt: check_qkv_shapes(torch, attn, INVERSION_QKV, dt)
               for dt in ("bfloat16", "float32")}
    torch.cuda.empty_cache()
    inv_rows = check_conv_inversion(torch, conv)
    for (name, k), r in sorted(inv_rows.items()):
        print(f"  inversion {name} k={k} {r['shape']}: kernel {r['ms']:.4f}"
              f" ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    check_conv_same(torch, conv, rows)
    check_same_edge_cases(torch, conv)
    check_dw_tc_edge_cases(torch, conv)
    check_k3_tc_edge_cases(torch, conv)
    torch.cuda.empty_cache()
    for name, r in rows.items():
        b, by = bound_ms(r["nbytes"], r["flops"], r["dtype"])
        r.update(bound_ms=b, bound_by=by)
        print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {b:.4f} ms ({by})")
        if name in DW + K3:
            print_beside_previous(name, r)

    mark(t_start)
    print("phase 3: small step, card against CPU")
    check_small_step(torch)
    check_small_optimizers(torch)
    check_small_pairs_step(torch)
    check_small_nhwc_step(torch)
    check_small_inversion_step(torch)
    print("  graphs against eager at this size (fp32, generator_conv=auto):")
    scfg, spair, sext = small_setup(torch, "cuda")
    # five eager runs measure the spread, as for two pairs below: after
    # five fp32 Adam steps one eager run's distance from another varied
    # 0.6e-2 to 1.3e-2 between calls, and the graphs' 0.1e-2 to 4.6e-2
    check_replay(torch, "small fp32", scfg, one_pair(scfg, spair, sext), spair,
                 spread_runs=5)
    from splice_tpu_torch.parallel.pair_parallel import MultiPairTrainer
    pcfg, ppairs, pext = pairs_setup(torch, "cuda")
    # two pairs' terms over five fp32 steps: the bilinear backward's
    # atomics make one eager run's distance from another vary 5x from call
    # to call (2.4e-3 to 1.2e-2 in the losses), so five runs measure it
    check_replay(torch, "small fp32, two pairs", pcfg,
                 lambda: MultiPairTrainer(pcfg, ppairs, pext, seeds=[0, 1]),
                 ppairs, spread_runs=5)
    del scfg, spair, sext, pcfg, ppairs, pext
    torch.cuda.empty_cache()

    mark(t_start)
    print(f"phase 4: main path, {MAIN_STEPS} steps on the cows pair")
    from splice_tpu_torch.config import load_config
    base = dict(dataroot="datasets/splicing/cows", seed=0,
                entire_A_every=10, log_images_freq=1000)
    cfg = load_config(None, base)
    res, main_launches = run_path(
        torch, "main", cfg, MAIN_STEPS, kernels,
        ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid", "conv_dw"))
    launches = {"main": main_launches}
    secs = res["step_seconds"]
    print(f"  replays alone: entire-A step 10 {secs[10] * 1e3:.1f} ms, "
          f"regular step 11 {secs[11] * 1e3:.1f} ms (phase 5 times a "
          f"chunk of regular replays)")
    shared = dict(pair=res["trainer"].pair, extractor=res["trainer"].extractor)

    mark(t_start)
    print("phase 4b: graphs against eager at full width (bf16, main path), "
          "and a chunk without synchronisation")
    program = check_replay(torch, "full width", cfg,
                           one_pair(cfg, shared["pair"],
                                    shared["extractor"]), shared["pair"])
    check_sync_free(torch, program, cfg)
    del program
    torch.cuda.empty_cache()

    mark(t_start)
    print("phase 5: where the time goes")
    from splice_tpu_torch.trainer import unpack_row
    main_ms = profile_steps(torch, res["program"], cfg)
    main_trainer = res["trainer"]
    _, draws = unpack_row(cfg, torch.from_numpy(
        regular_rows(torch, cfg, main_trainer.pair, 1, 3)[0]).cuda())
    aug_graph = torch.cuda.CUDAGraph()   # sample_inputs ran eagerly above
    with torch.cuda.graph(aug_graph):
        main_trainer.sample_inputs(draws)
    aug = time_ms(aug_graph.replay)
    print(f"  augmentation and crops (sample_inputs as one graph: flip, "
          f"jitter at every position, blur, both crop stacks) {aug:.3f} ms "
          f"of device time a step")
    del aug_graph
    del res
    torch.cuda.empty_cache()

    need = {"480": ("attn_fwd", "attn_bwd", "conv_valid", "conv_dw"),
            "fused": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                      "conv_valid_pro", "conv_dw_pro"),
            "pallas": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                       "conv_dw", "conv_valid_s2d", "conv_dw_s2d"),
            # the reference's routes with SAME_BORDER_KERNELS on: K3''' at
            # down_conv2 s0 and up_conv s0/s1, their dz by K3'' SAME, dw by
            # K7 at up_conv s0/s1 and by K4 at down_conv2 (a tie in
            # _gtap_better)
            "fused_same": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                           "conv_valid_pro", "conv_dw_pro", "conv_same",
                           "conv_same_pro_stats", "conv_dw_gtap"),
            "pallas_same": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                            "conv_dw", "conv_valid_s2d", "conv_dw_s2d",
                            "conv_same", "conv_dw_gtap"),
            "fused_same_skip3": ("conv_same_pro", "conv_same_pro_stats",
                                 "conv_dw_gtap")}
    turns = [("auto", main_trainer, cfg, False, True)]
    for i, (path, mode, res_px, n, same) in enumerate(PATHS):
        print(f"phase 6.{i + 1}: the {path} path (generator_conv={mode}"
              f"{', SAME route' if same else ''}, {res_px}-px loss "
              f"resolution), {n} steps")
        pcfg = load_config(None, dict(base, generator_conv=mode,
                                      dino_global_patch_size=res_px))
        pres, launches[path] = run_path(torch, path, pcfg, n, kernels,
                                        need[path], same, **shared)
        with same_border(same):
            profile_steps(torch, pres["program"], pcfg,
                          2 if res_px > 224 else 3)
        if res_px == 224:
            turns.append((path, pres["trainer"], pcfg, same, True))
        if path == "fused_same":
            # the same trainer with the reference's DW_TAP_ON_N off: K4
            # takes up_conv s0/s1's dw instead of K7
            print("  the same steps with DW_TAP_ON_N off (K4 for K7's dw):")
            with same_border(True, False):
                profile_steps(torch, pres["program"], pcfg)
            turns.append(("fused_same_tap_off", pres["trainer"], pcfg, True,
                          False))
        del pres
        torch.cuda.empty_cache()
        if path == "fused_same":
            print(f"phase 6.{i + 1}b: the fused_same_skip3 path (fused, SAME "
                  f"route, 3x3 skip convs), {SKIP3_STEPS} steps")
            launches["fused_same_skip3"] = run_skip3(
                torch, pcfg, shared["pair"], shared["extractor"], kernels,
                need["fused_same_skip3"])
            torch.cuda.empty_cache()

    mark(t_start)
    print("phase 7: generator_conv " + ", ".join(t[0] for t in turns)
          + " at 224, in turns (eager steps: SpliceTrainer.step, no graphs)")
    k7 = steps_in_turns(torch, turns, rounds=2)
    if k7["fused_same_tap_off"] or not k7["fused_same"]:
        fail(f"DW_TAP_ON_N did not route K7 as it says: {k7}")
    del turns, main_trainer
    torch.cuda.empty_cache()

    mark(t_start)
    print(f"phase 8: a run as a user runs it: train_pair on the main path, "
          f"{RUN_STEPS} steps, cosine, checkpoints, metrics")
    check_run(torch, kernels, shared)
    torch.cuda.empty_cache()

    mark(t_start)
    dinov2 = run_dinov2(torch, kernels, base, shared["pair"])
    for name, (dl, ms) in dinov2.items():
        print(f"  {name}: replayed step {ms:.2f} ms against the main path's "
              f"{main_ms:.2f}; K1/K2 launches {dl['attn_qkv_fwd']}/"
              f"{dl['attn_qkv_bwd']}")
    mark(t_start)
    print(f"phase 10: video, 3 frames of {VIDEO_STEPS[0]} + 2 x "
          f"{VIDEO_STEPS[1]} steps warm-started, one set of graphs")
    run_video(torch, kernels, main_ms)
    mark(t_start)
    print(f"phase 11: config c, 8 pairs ([cows, apples2oranges] x 4) at "
          f"224 in one step, {CONFIG_C_STEPS} steps")
    c_launches, c_first = run_config_c(torch, kernels, shared["extractor"],
                                       main_ms)
    launches.update(c_launches)
    torch.cuda.empty_cache()
    mark(t_start)
    print(f"phase 12: the inversion tool on limes at 224 x 281, full width "
          f"(dino_vitb8, seeded), {INV_ITERS} steps at log_freq {INV_LOG}, "
          f"nhwc and chw + pallas")
    launches.update(run_inversion(torch, conv, kernels, inv_rows))
    print("  fp32 (compute_dtype float32, nhwc), 3 steps: K1/K2 on the CUDA "
          "cores at the inversion shape")
    launches["inversion_fp32"] = run_inversion_fp32(torch, kernels)
    print("  the main path with generator_layout=nhwc, 4 steps")
    ncfg = load_config(None, dict(base, generator_layout="nhwc"))
    nres, launches["main_nhwc"] = run_path(
        torch, "main_nhwc", ncfg, 4, kernels,
        ("attn_qkv_fwd", "attn_qkv_bwd"), **shared)
    nhwc_ms = profile_steps(torch, nres["program"], ncfg)
    print(f"  main with generator_layout=nhwc: replayed regular step "
          f"{nhwc_ms:.2f} ms against chw's {main_ms:.2f}")
    del nres
    torch.cuda.empty_cache()
    mark(t_start)
    print(f"phase 13: the mesh, "
          f"config c's 8 pairs at dp = 2 x tp = 2 over [cuda:0] * 4, "
          f"{MESH_STEPS} steps; a mesh_dp=2 checkpoint resumed at dp = 1; "
          f"the tp = 4 ViT")
    launches.update(run_mesh(torch, attn, kernels, shared["extractor"],
                             c_first))
    torch.cuda.empty_cache()
    mark(t_start)
    print(f"phase 14: observability "
          f"and ablations: a profile window, use_pallas_attention=false, "
          f"tools/ablate.py, tools/trace_agg.py")
    launches["xlaattn"] = run_observability(torch, kernels, base, shared,
                                            main_ms)

    line = []
    for name, (fn, route, source, replaces, path) in kernels.items():
        r = rows[name]
        line.append({"name": name, "route": route, "source": source,
                     "cores": "tensor core",
                     "replaces": replaces, "launches": launches[path][name],
                     "path": path, "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    for (kid, tag), r in pair_rows.items():
        name = {"K1": "attn_qkv_fwd", "K2": "attn_qkv_bwd"}[kid]
        fn, route, source, replaces, _ = kernels[name]
        b, by = bound_ms(r["nbytes"], r["flops"], r["dtype"])
        line.append({"name": name, "route": route, "source": source,
                     "cores": "tensor core", "replaces": replaces,
                     "launches": launches["config_c"][name],
                     "path": "config_c", "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": b, "bound_by": by,
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    for (kid, tag), r in mesh_rows.items():
        name = {"K1": "attn_qkv_fwd", "K2": "attn_qkv_bwd", "K5": "attn_fwd",
                "K6": "attn_bwd"}[kid]
        path = "mesh" if kid in ("K1", "K2") else "mesh_tp4"
        fn, route, source, replaces, _ = kernels[name]
        b, by = bound_ms(r["nbytes"], r["flops"], r["dtype"])
        line.append({"name": name, "route": route, "source": source,
                     "cores": "tensor core", "replaces": replaces,
                     "launches": launches[path][name], "path": path,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": b,
                     "bound_by": by, "library_ms": r["library_ms"],
                     "shape": r["shape"]})
    for (name, k), r in sorted(inv_rows.items()):
        fn, route, source, replaces, _ = kernels[name]
        line.append({"name": name, "route": route, "source": source,
                     "cores": "tensor core", "replaces": replaces, "k": k,
                     "launches": r["launches"],
                     "path": "inversion_chw_pallas",
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    for dt, path in (("bfloat16", "inversion_nhwc"),
                     ("float32", "inversion_fp32")):
        for (kid, tag), r in inv_qkv[dt].items():
            name = {"K1": "attn_qkv_fwd", "K2": "attn_qkv_bwd"}[kid]
            fn, route, source, replaces, _ = kernels[name]
            b, by = bound_ms(r["nbytes"], r["flops"], r["dtype"])
            line.append({"name": name, "route": route, "source": source,
                         "cores": ("tensor core" if dt == "bfloat16"
                                   else "CUDA core"),
                         "replaces": replaces,
                         "launches": launches[path][name], "path": path,
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": b,
                         "bound_by": by, "library_ms": r["library_ms"],
                         "shape": r["shape"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
