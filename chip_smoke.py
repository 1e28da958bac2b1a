#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (splice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the hand-written CUDA kernels from splice_tpu_torch/csrc and
     print each kernel's registers and spills; every tensor-core kernel
     must hold tensor-core instructions (cuobjdump): wgmma (HGMMA) in the
     bf16 route of K1/K2 and K5/K6 and in the probe kernel P1, TF32
     mma.sync (HMMA ... TF32) in their fp32 route (split TF32), mma.sync
     (HMMA) in the bf16 route of K3 (every form) and of K4 and K7 (PR
     6-7's forms and the pixel-major ones), TF32 mma.sync in the fp32
     route of K3, K4 and K7 (split TF32: every instance of
     conv_fwd_tf32_kernel and conv_dw_tf32_kernel, K7 its cotangent-tapped
     ones), and no CUDA-core conv kernel left;
  2. hold every kernel against its plain PyTorch version at the shapes the
     training paths give it (and at small edge-case shapes; the bf16
     attention kernels also at N under a tile, one past a tile, B = 1 and
     2, 6 and 12 heads, masked key blocks and more seeds; the bf16 weight
     gradients and every K3 form, bf16 and fp32, at W = 37, H < k, odd
     stride-2 sizes, Cin 3 and 136, Cout 3, 36, 68 and 128, k = 1, 2, 3,
     two BatchNorm stacks with a scale of 1e-13, VALID K7, K3''' at ragged
     sizes and the entire-A generator's B = 1 shapes from 900 x 1200; K2,
     K6, K3 in each form (the input gradient too), K4 in each form and K7
     twice on one input, bitwise equal),
     and time kernel, plain version and a PyTorch library call that
     computes the same function (the yardstick only); the redesigned
     kernels beside their previous kernels' times; P1 (the probe kernel,
     ops.probe.mma_repeat) at the reference probe's shapes ([768, K] x
     [K, 768], K = 64, 128, 256; [768, 768] x [768, W], W = 64, 128, K
     streamed) at 64 reps and at m = 64, k = 16, 1 rep, on seeded random
     inputs, at output tiles of 64 and 128 columns, bitwise twice; then
     P1's path, tools/mma_k_probe.py (the probe's experiments, printed);
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
     three regular steps and another entire-A step, eagerly six times
     (the spread of five runs from the first, each printed:
     F.interpolate's bilinear backward adds with atomics) and through the
     program; per-step losses and the parameter update must agree within
     REPLAY_MULT x the eager spread plus a floor; then each
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
     (K3/K4 at k = 7, 5 and the phase kernels' k2 = 4, 3: the
     pixel-major forms, counted by (wrapper, k, form)). Gates: the
     logged steps 0, 20, 40, 60 and every loss finite; the PNG [224, 281,
     3]; the ViT's input (224, 281); K1/K2 and, on chw + pallas, K3 and K4
     at k = 4, 5 and 7 launched inside the graph, every bf16 launch on the
     tensor cores; the graph against eager steps from one state (phase
     4b's rule, at noise magnitude 0); then feature keys for 5 steps, an
     fp32 run (K1/K2 in split TF32), evaluate's LPIPS (seeded AlexNet)
     of the output on the card against the CPU, and the main path with
     generator_layout nhwc for 4 steps through the program, its replayed
     regular step profiled beside main's. Prints
     iterations/s replayed and sustained, kernel ms per step (K3's and
     K4's apart) and peak memory for each layout.
  12b. main_fp32: the main path with vit_compute_dtype and
     generator_compute_dtype float32, MAIN_FP32_STEPS steps through the
     program, phase 4's gates, every K1/K2 launch and every conv launch
     (fp32 K3/K4 at the two auto sites) on the tensor cores (split TF32);
     then pallas_fp32, the same with generator_conv=pallas for
     PALLAS_FP32_STEPS steps (every conv of the generator on fp32 K3/K4 at
     full width: the stride-2 convs as k2 = 2 phase kernels, every site's
     forward, input gradient and dw, each launch on the tensor cores);
     then fused_same_fp32 and pallas_same_fp32, fused and pallas with the
     SAME route on for SAME_FP32_STEPS steps each (fp32 K3'' SAME, K3'''
     with its statistics, fused K3' pro and K7 at up_conv s0/s1 at full
     width; phase 6's fused_same and pallas_same kernels launched inside
     the graphs, every launch on the tensor cores);
     each path's replayed step, kernel ms, launches, busy share, the fp32
     attention's ms, the conv kernels' ms and K7's ms a step;
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
     the default and with xlaattn;
  15. the notebook: Splice_tpu_torch.ipynb's code cells in order in one
     namespace on a copy of the cows pair, NOTEBOOK_STEPS steps at full
     width (no OVERRIDES: dino_vitb8 seeded, 224, bf16; IPython.display a
     stand-in that records what it receives where IPython is missing).
     Gates: every log boundary's frame reached show_result as a host
     uint8 [H, W, 3], output.png and structure_pca.png, the run on CUDA;
  16. the acceptance run: python -m splice_tpu_torch.tools.accept from a
     seeded dino_vitb8 .pth in DINO's key layout and seeded LPIPS weights
     on copies of both pairs, ACCEPT_STEPS steps each: exit 0, both pairs
     trained, no reference output and the artifact named; then score_pair
     of an output against itself with LPIPS on the card (inf, 1, 0, a
     pass). Prints each pair's train_wall_s.
Phase 2 also holds the fp32 (split-TF32) K1/K2 at FP32_QKV and K5/K6 at
FP32_SPLIT against their plain fp32 versions (matmul TF32 off), bitwise
run to run, every launch on the tensor cores, timed beside SDPA in fp32;
K7 at k = 5, 7, 9 and 11 (GTAP_SITES, bf16 and fp32; bf16 at k = 9 and 11
on conv_dw_wg, beside conv_dw_px's distance from plain) and fp32 K7 at k = 3
at both SAME sites (split TF32, with and without the prologue, bitwise
twice, timed beside conv2d_weight and K4 at the same site); bf16 K4 at k =
9 and 11 at WG_SITES (GTAP_SITES and up_conv s2, k = 9 there; also K7 at
s2) on conv_dw_wg against its plain version, with and without the prologue,
bitwise twice, timed beside conv2d_weight, each plan printed (order,
N, tap groups, stages, shared memory, blocks an SM, registers); K5/K6 at
head widths 128,
192 and 256 (WIDE_SPLIT: K5's and K6's wide passes, bf16 and fp32,
unmasked and with 2701 valid keys, bitwise twice, timed beside SDPA;
WIDE_EDGES, dh = 320, 384 and 448 among them; K5's and K6's launches with
their output width W, consumer warps, key tile, ring stages and blocks an
SM printed, one column block a head required up to dh = 256 and
ceil(dh / 256) above);
and fp32
K3 (forward
and input gradient) and K4 at the two auto sites (split TF32, bitwise
twice) against their plain versions, timed beside F.conv2d, conv2d_input
and conv2d_weight with cuDNN's TF32 off.
Phase 2 also holds K1/K2 at the mesh's tp = 2 shape
(MESH_QKV) and K5/K6 at its tp = 4 shape (MESH_SPLIT). Phase 2 also holds
K1/K2 at the DINOv2 paths' shapes (DINOV2_QKV), at
config c's batch of 16 (PAIRS_QKV; every launch on the tensor cores, in
the JSON line as path config_c), at the inversion's [1, 981, 2304] in bf16
(INVERSION_QKV; fp32 in FP32_QKV) and at 16 heads (QKV_EDGES), and K3
(plain, pro, the input gradient) and K4 (plain, pro) in bf16 and fp32 at
the inversion net's sites (tools/conv_forms.INV_SITES; bf16 K3 on the
pixel-major form, K4 on the form conv_route names: conv_dw_tc at the two
Cout-16 sites whose grid busies the card, conv_dw_px elsewhere),
bitwise twice, timed in bf16 against F.conv2d and cuDNN's gradients
(tools/conv_forms.py times the parent's forms beside these, in one
call). Phase 2 also holds
the filter sizes no generator default takes (ROADMAP C9; ANY_K: k = 6, 9
and, at stride 2, 6, 9, 11) through kernel_conv_chw and
kernel_conv_bn_act_chw, forward, input and weight gradient, bf16 and fp32,
against the CPU's plain versions with F.conv2d refused and every launch
counted; K7's route at k = 9 with SAME_BORDER_KERNELS on (K7 on its own
kernels); a generator with 9x9 up convs through skip_apply_chw pallas
and fused, with the SAME route off and on (K7 at k = 9 wherever
_gtap_better says so), against the CPU's float64; and
multi_head_attention at dh 32 (SDPA) and 64 and 128 (K5/K6, counted, SDPA
refused) against the XLA math. Phase 6c runs the port's vit_forward at
ViT-B/8's width as 6 heads of 128 (seeded; the 480 and 224 shapes, bf16
and fp32): 12 K5 and 12 K6 launches a forward and backward, SDPA
refused, the taps of layer 11 and the image gradient against the SDPA
route. Phase 6d runs the default generator with 9x9 up convs on the SAME
route at [2, 896, 896, 3] in bf16: K7 at k = 9 on conv_dw_wg at up_conv
s0-s2, its gradient against K4's runs (K4 on conv_dw_wg there), with the
weight-gradient kernels' device ms a pass beside the host wall.
Phase 3 runs a small fp32 DINOv2 (layer scale, registers) on
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

# H100 SXM, dense. fp32: the least time fp32-accurate products take on this
# card is as three TF32 products (split TF32: hi*lo + lo*hi + hi*hi) at
# 495 TFLOP/s, faster than the CUDA cores' 67 TFLOP/s of plain fp32
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
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
# the conv wrappers, on the tensor cores in bf16 and fp32 (split TF32):
# the weight gradients (K4 in each form, K7) and K3 in each form
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
# the wrappers each of those paths must launch inside its graphs
NEED = {"480": ("attn_fwd", "attn_bwd", "conv_valid", "conv_dw"),
        "fused": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                  "conv_valid_pro", "conv_dw_pro"),
        "pallas": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid", "conv_dw",
                   "conv_valid_s2d", "conv_dw_s2d"),
        # the reference's routes with SAME_BORDER_KERNELS on: K3''' at
        # down_conv2 s0 and up_conv s0/s1, their dz by K3'' SAME, dw by K7
        # at up_conv s0/s1 and by K4 at down_conv2 (a tie in _gtap_better)
        "fused_same": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                       "conv_valid_pro", "conv_dw_pro", "conv_same",
                       "conv_same_pro_stats", "conv_dw_gtap"),
        "pallas_same": ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid",
                        "conv_dw", "conv_valid_s2d", "conv_dw_s2d",
                        "conv_same", "conv_dw_gtap"),
        "fused_same_skip3": ("conv_same_pro", "conv_same_pro_stats",
                             "conv_dw_gtap")}
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
    """bf16 K1/K2 at the main path's shapes, timed at [2, 785] (the fp32
    forms: FP32_QKV)."""
    H, dh, scale = 12, 64, 0.125
    D = H * dh
    g_cpu = torch.Generator().manual_seed(1)
    errs = {"attn_qkv_fwd": 0.0, "attn_qkv_bwd": 0.0}
    main = {}
    dt, dtype_name = torch.bfloat16, "bfloat16"
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


# The fp32 attention shapes (B, H, N): main_fp32's two crops and its
# entire A (vit_compute_dtype float32 at the 224 loss resolution), the
# fp32 inversion's limes; K5/K6 (B, H, N, dh) at the 480 path's crops
FP32_QKV = ((2, 12, 785), (1, 12, 1037), (1, 12, 981))
FP32_SPLIT = ((2, 12, 3601, 64),)


# The mesh phase's tensor-parallel attention shapes. K1/K2 (B, H, N): a
# dp = 2 group of config c's pairs (4 pairs, one generated crop each of A
# and B: a batch of 8) through ViT-B/8 at tp = 2, 6 heads a rank (local D
# 384). K5/K6 (B, H, N, dh): the same batch at tp = 4, 3 heads a rank:
# local D 192 fails the fused-qkv gate (D % 128), so the heads are split.
MESH_QKV = ((8, 6, 785),)
MESH_SPLIT = ((8, 3, 785, 64),)


def check_split_shapes(torch, attn, shapes, dtype_name="bfloat16",
                       n_valid=0):
    """K5/K6 at `shapes` (keys past n_valid masked where it is given)
    against their plain versions, each twice on one input (bitwise equal),
    timed beside the plain versions and SDPA (with the key mask:
    library_attention) with the bound of its bytes and operations (the
    operations of the valid keys), every launch on the tensor cores.
    Returns {(kernel, shape): times and max_abs_err}."""
    rtol, why = RTOL[dtype_name]
    dt, scale = getattr(torch, dtype_name), 0.125
    fns = (attn.attn_fwd_cuda, attn.attn_bwd_cuda)
    counts = [(f.launches, f.tc_launches) for f in fns]
    out = {}
    nv = n_valid
    for B, H, N, dh in shapes:
        gen = torch.Generator().manual_seed(50 + N + dh - 64 + nv)
        q, k, v, g = (torch.randn(B, H, N, dh, generator=gen).to("cuda", dt)
                      for _ in range(4))
        tag = f"[{B},{H},{N},{dh}]{f' n_valid={nv}' if nv else ''} " \
            f"{dtype_name}"
        o = attn.attn_fwd_cuda(q, k, v, scale, nv)
        err5 = compare(f"K5 {tag}", o, attn.attention_plain(q, k, v, scale,
                                                            nv), rtol, why)
        check_bitwise(torch, f"K5 {tag}", (o,),
                      (attn.attn_fwd_cuda(q, k, v, scale, nv),))
        del o
        got = attn.attn_bwd_cuda(q, k, v, g, scale, nv)
        want = attn.attention_bwd_plain(q, k, v, g, scale, nv)
        err6 = max(compare(f"K6 {part} {tag}", a, b, rtol, why)
                   for part, a, b in zip(("dq", "dk", "dv"), got, want))
        check_bitwise(torch, f"K6 {tag}", got,
                      attn.attn_bwd_cuda(q, k, v, g, scale, nv))
        if nv and not all(bool((t[:, :, nv:] == 0).all()) for t in got[1:]):
            fail(f"K6 {tag}: masked keys with nonzero dk or dv")
        del got, want
        isz = q.element_size()
        fl = 4 * B * H * N * (nv or N) * dh
        out[("K5", tag)] = dict(timed(
            lambda: attn.attn_fwd_cuda(q, k, v, scale, nv),
            lambda: attn.attention_plain(q, k, v, scale, nv),
            lambda: attn.library_attention(q, k, v, scale, nv),
            4 * B * H * N * dh * isz, fl, dtype_name, "K5", tag),
            max_abs_err=err5)
        qr, kr, vr = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = attn.library_attention(qr, kr, vr, scale, nv)
        out[("K6", tag)] = dict(timed(
            lambda: attn.attn_bwd_cuda(q, k, v, g, scale, nv),
            lambda: attn.attention_bwd_plain(q, k, v, g, scale, nv),
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


# K5/K6 at head widths above 64 (their wide passes):
# the 480 path's two square crops in ViT-B/8's width as heads of 128
# (phase 6c's wide-head ViT), 192 and 256; each unmasked and with the
# entire A's 2701 valid keys (tools/attn_forms.py times the same shapes)
WIDE_SPLIT = ((2, 6, 3601, 128), (2, 4, 3601, 192), (2, 3, 3601, 256))
WIDE_VALID = 2701
# (B, H, N, dh, n_valid, seed) of the wide forms' edge cases: N under one
# 64-row tile, one past a tile and past two, B = 1, masked keys with key
# tiles wholly past n_valid (zero dk, dv without a loop), dh = 320 (K6's
# resident form's two column blocks; K5's streamed form at 192 + 128), 384
# and 448 (both streamed forms: column blocks of 192 + 192 and 256 + 192).
# Every form of K5's and K6's plans runs at one of these or WIDE_SPLIT.
WIDE_EDGES = ((1, 2, 17, 128, 0, 70), (2, 2, 65, 192, 0, 71),
              (1, 3, 129, 256, 100, 72), (1, 1, 300, 320, 211, 73),
              (1, 2, 200, 384, 130, 74), (1, 1, 129, 448, 0, 75))


def check_wide_plan(torch, attn):
    """K6's wide launches at every dh of WIDE_SPLIT and WIDE_EDGES, bf16
    and fp32 (ops.attention.wide_bwd_plan: pass, output width W and first
    column, threads, ring stages, shared memory, blocks an SM), printed;
    the dK/dV and dQ passes must cover the head in one column block of W =
    dh up to 256 and in ceil(dh / 256) of at least 128 columns above it,
    and every launch must fit an SM."""
    dhs = sorted({s[3] for s in WIDE_SPLIT} | {e[3] for e in WIDE_EDGES})
    for dtype_name in ("bfloat16", "float32"):
        for dh in dhs:
            plan = attn.wide_bwd_plan(dh, getattr(torch, dtype_name))
            for p in plan:
                print(f"  K6 wide plan dh {dh} {dtype_name}: {p['kind']} W "
                      f"{p['w']} from column {p['col']}, {p['threads']} "
                      f"threads, {p['stages']} stages, {p['smem']} bytes, "
                      f"{p['blocks_per_sm']} blocks / SM")
            blocks = {}
            for p in plan:
                if p["kind"] != "stats":
                    blocks.setdefault(p["kind"].replace("dkdv", "dk"),
                                      []).append(p)
                    if p["kind"] == "dkdv":
                        blocks.setdefault("dv", []).append(p)
            most = -(-dh // 256)
            if (not plan or plan[0]["kind"] != "stats"
                    or any(p["blocks_per_sm"] < 1 for p in plan)
                    or sorted(blocks) != ["dk", "dq", "dv"]
                    or any(len(ps) > most or sum(p["w"] for p in ps) != dh
                           or min(p["w"] for p in ps) < 128
                           for ps in blocks.values())):
                fail(f"K6's wide plan at dh {dh} {dtype_name}: {plan}")


def check_wide_fwd_plan(torch, attn):
    """K5's wide launches at every dh of WIDE_SPLIT and WIDE_EDGES, bf16
    and fp32 (ops.attention.wide_fwd_plan: output width W and first
    column, threads, q rows a block, key tile, ring stages, shared memory,
    blocks an SM), printed; they must cover the head in one launch of W =
    dh up to 256 and in ceil(dh / 256) column blocks of at least 128
    columns above it, in order, and every launch must fit an SM."""
    dhs = sorted({s[3] for s in WIDE_SPLIT} | {e[3] for e in WIDE_EDGES})
    for dtype_name in ("bfloat16", "float32"):
        for dh in dhs:
            plan = attn.wide_fwd_plan(dh, getattr(torch, dtype_name))
            for p in plan:
                print(f"  K5 wide plan dh {dh} {dtype_name}: W {p['w']} from "
                      f"column {p['col']}, {p['threads']} threads, "
                      f"{p['rows']} q rows, key tiles of {p['keys']}, "
                      f"{p['stages']} stages, {p['smem']} bytes, "
                      f"{p['blocks_per_sm']} blocks / SM")
            widths = [p["w"] for p in plan]
            starts = [sum(widths[:i]) for i in range(len(plan))]
            if (not plan or any(p["kind"] != "fwd" or p["blocks_per_sm"] < 1
                                for p in plan)
                    or [p["col"] for p in plan] != starts
                    or sum(widths) != dh
                    or len(plan) != -(-dh // 256)
                    or (dh > 256 and min(widths) < 128)):
                fail(f"K5's wide plan at dh {dh} {dtype_name}: {plan}")


def check_wide_split(torch, attn):
    """K5/K6 at WIDE_SPLIT, bf16 and fp32, unmasked and masked (through
    check_split_shapes: gated, bitwise twice, timed beside the plain
    versions and SDPA with the bound, every launch on the tensor cores),
    then at WIDE_EDGES against the plain versions. Returns {(kernel,
    shape): row}."""
    check_wide_plan(torch, attn)
    check_wide_fwd_plan(torch, attn)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        rtol, why = RTOL[dtype_name]
        dt = getattr(torch, dtype_name)
        for nv in (0, WIDE_VALID):
            rows.update(check_split_shapes(torch, attn, WIDE_SPLIT,
                                           dtype_name, nv))
            torch.cuda.empty_cache()
        for B, H, N, dh, nv, seed in WIDE_EDGES:
            gen = torch.Generator().manual_seed(seed)
            q, k, v, g = (torch.randn(B, H, N, dh, generator=gen).to(
                "cuda", dt) for _ in range(4))
            s = dh ** -0.5
            tag = f"[{B},{H},{N},{dh}] n_valid={nv} seed {seed} {dtype_name}"
            compare(f"K5 {tag}", attn.attn_fwd_cuda(q, k, v, s, nv),
                    attn.attention_plain(q, k, v, s, nv), rtol, why)
            got = attn.attn_bwd_cuda(q, k, v, g, s, nv)
            for part, a, b in zip(("dq", "dk", "dv"), got,
                                  attn.attention_bwd_plain(q, k, v, g, s,
                                                           nv)):
                compare(f"K6 {part} {tag}", a, b, rtol, why)
            check_bitwise(torch, f"K6 {tag}", got,
                          attn.attn_bwd_cuda(q, k, v, g, s, nv))
            if nv and not all(bool((t[:, :, nv:] == 0).all())
                              for t in got[1:]):
                fail(f"K6 {tag}: masked keys with nonzero dk or dv")
    return rows


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
    operations; every launch on the tensor cores, fp32's too (the
    split-TF32 kernels). Returns {(kernel, shape): times and
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
    if any(n != t for n, t in calls):
        fail(f"K1/K2 launches off the tensor cores at {shapes}: {calls}")
    return out


def sass_counts(build, lib):
    """{kernel: [HGMMA, HMMA, TF32 MMA]} instruction counts of the built
    library `lib` (cuobjdump -sass), printed."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build._target(lib))],
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "HMMA" in line
            counts[fn][2] += "MMA" in line and "TF32" in line
    for f, (hg, hm, tf) in counts.items():
        print(f"  sass {lib} {f}: HGMMA {hg}, HMMA {hm}, of them TF32 {tf}")
    return counts


# K5's and K6's wide plans at dh = 128 to 448 hold every template instance
# of their wide passes: the resident forms' (dh up to 256 for K5, 320 for
# K6) and the streamed forms' (K5 at W = 128, 192 and 256; K6's statistics,
# and dV, dK, dQ at W = 192 and 256)
WIDE_PLAN_DHS = tuple(range(128, 512, 64))
# a wide pass's kernel (csrc attn_bwd_wide_{stats,dkdv,dq}_{tc,tf32},
# attn_fwd_wide_{tc,tf32})
WIDE_PREFIX = {"stats": "attn_bwd_wide_stats_", "dq": "attn_bwd_wide_dq_",
               "dkdv": "attn_bwd_wide_dkdv_", "dv": "attn_bwd_wide_dkdv_",
               "dk": "attn_bwd_wide_dkdv_", "fwd": "attn_fwd_wide_"}
# the chunked K6 passes the wide passes replaced and their delta sum, and
# the chunked K5 forms (bf16, fp32)
WIDE_GONE = ("attn_bwd_dkdv_wide_", "attn_bwd_dq_wide_", "delta_chunk_sum",
             "attn_fwd_wide_tc_kernel", "attn_fwd_wide_tf32_kernel")


def wide_instances(torch, attn) -> dict:
    """{"bf16" | "fp32": {kernel name prefix: instances}}: the attention
    library's wide instances in each dtype, the distinct kernels of K5's
    and K6's wide plans at WIDE_PLAN_DHS (ops.attention.wide_fwd_plan and
    wide_bwd_plan) by pass."""
    out = {}
    for kind, dtype_name in (("bf16", "bfloat16"), ("fp32", "float32")):
        fns = {}
        for dh in WIDE_PLAN_DHS:
            dt = getattr(torch, dtype_name)
            for p in attn.wide_fwd_plan(dh, dt) + attn.wide_bwd_plan(dh, dt):
                fns.setdefault(WIDE_PREFIX[p["kind"]], set()).add(p["kernel"])
        out[kind] = {name: len(f) for name, f in fns.items()}
    return out


def check_tensor_cores(build, wide, n_wg):
    """Every tensor-core kernel (a name with "_tc") must hold its
    instructions: HGMMA (wgmma) in the attention library's (the bf16 route
    of K1/K2 and K5/K6, K5's and K6's wide passes among them, as many of
    each as `wide` (wide_instances) counts), HMMA (mma.sync) in the conv library's (the bf16
    route of K3 and of K4/K7); the fp32 route of K1/K2 and K5/K6 (the
    split-TF32 kernels, "tf32" in their names, the same wide instances
    among them) TF32 HMMA; the wide forms' earlier kernels gone
    (WIDE_GONE); each library
    must have such kernels, the
    conv library a forward one (conv_fwd_tc_kernel) and a weight-gradient
    one, and HMMA in each of the pixel-major forms' nine instances
    (conv_fwd_px_kernel; conv_dw_px_kernel for K4 and, cotangent-tapped,
    for K7); HGMMA in each of conv_dw_wg's instances (bf16 K4 and K7 on
    large maps, one a width of n_wg, ops.conv.WG_NS); TF32 HMMA in each of the
    split-TF32 fp32 forms' 24 instances (conv_fwd_tf32_kernel, and
    conv_dw_tf32_kernel for K4 and for K7, nb = 1 to 8 each); no CUDA-core
    conv kernel left (conv_fwd_kernel, conv_dw_partial, conv_dw_gtap_kernel,
    conv_dw_reduce_kernel); and HGMMA in each of P1's four instances (the
    probe library: 64 and 128 columns, resident and streamed)."""
    att = sass_counts(build, "attention")
    tc = [f for f in att if "_tc" in f]
    if not tc or not all(att[f][0] for f in tc):
        fail(f"attention tensor-core kernels missing or without HGMMA: {att}")
    tf32 = [f for f in att if "tf32" in f]
    for kind, fns in (("bf16", tc), ("fp32", tf32)):
        for name, n in wide[kind].items():
            got = [f for f in fns if name in f]
            if len(got) != n:
                fail(f"{kind} {name}: {len(got)} instances, want {n}: {got}")
    gone = [f for f in att if any(name in f for name in WIDE_GONE)]
    if gone:
        fail(f"the wide forms' earlier kernels still built: {gone}")
    if (len(tf32) != 4 + sum(wide["fp32"].values())
            or not all(att[f][2] for f in tf32)):
        fail(f"the fp32 attention kernels missing or without TF32 MMA: "
             f"{ {f: att[f] for f in tf32} }")
    cnv = sass_counts(build, "conv")
    tc = [f for f in cnv if "_tc" in f]
    if (not any("conv_fwd_tc_kernel" in f for f in tc)
            or not any("conv_dw_tc_kernel" in f for f in tc)
            or not all(cnv[f][1] for f in tc)):
        fail(f"conv tensor-core kernels missing or without HMMA: {cnv}")
    # the pixel-major forms: K3's four m16 widths, K4's three n8 widths and
    # K7's two (conv_dw_px_kernel<NB, GTAP>, GTAP mangled as Lb0E / Lb1E)
    px = [f for f in cnv if "_px_kernel" in f]
    px7 = [f for f in px if "conv_dw_px_kernel" in f and "Lb1E" in f]
    if len(px) != 9 or len(px7) != 2 or not all(cnv[f][1] for f in px):
        fail(f"the pixel-major conv kernels missing or without HMMA: "
             f"{ {f: cnv[f] for f in px} }")
    # the split-TF32 fp32 forms: K3's, K4's and K7's eight n8 widths each
    # (conv_dw_tf32_kernel<NB, GTAP>: GTAP mangled as Lb0E / Lb1E)
    tf = [f for f in cnv if "_tf32_kernel" in f]
    dw = [f for f in tf if "conv_dw_tf32_kernel" in f]
    k7 = [f for f in dw if "Lb1E" in f or ", true>" in f]
    if (len([f for f in tf if "conv_fwd_tf32_kernel" in f]) != 8
            or len(dw) != 16 or len(k7) != 8
            or not all(cnv[f][2] for f in tf)):
        fail(f"the split-TF32 conv kernels missing or without TF32 MMA: "
             f"{ {f: cnv[f] for f in tf} }")
    # bf16 K4 and K7 on large maps: conv_dw_wg_kernel<N>, one instance a
    # width of ops.conv.WG_NS, each on wgmma
    wg = [f for f in cnv if "conv_dw_wg_kernel" in f]
    if len(wg) != len(n_wg) or not all(cnv[f][0] for f in wg):
        fail(f"conv_dw_wg's instances missing or without HGMMA (want "
             f"{len(n_wg)}): { {f: cnv[f] for f in wg} }")
    gone = [f for f in cnv if "conv_dw_partial" in f
            or "conv_fwd_kernel" in f or "conv_dw_gtap_kernel" in f
            or "conv_dw_reduce" in f]
    if gone:
        fail(f"CUDA-core fp32 conv kernels still built: {gone}")
    prb = sass_counts(build, "probe")
    p1 = [f for f in prb if "mma_repeat_kernel" in f]
    if len(p1) != 4 or not all(prb[f][0] for f in p1):
        fail(f"P1's four instances missing or without HGMMA: {prb}")
    # ptxas says so where it had to wait on each wgmma (the probe would
    # then time a serialised pipeline)
    for line in (build.BUILD_DIR / "probe.log").read_text().splitlines():
        if "wgmma" in line.lower():
            print(f"  ptxas probe: {line.strip()}")


def print_ptxas(build):
    """Registers, stack and spills of every kernel, from the build logs.
    The wide attention instances (K5's and K6's wide passes),
    conv_dw_px's cotangent-tapped mode and conv_dw_wg's instances must
    spill nothing; ptxas's notes on conv_dw_wg's wgmma (serialised
    pipelines, C7510-C7520) are printed."""
    spilled, injected = [], 0
    for name in build.SOURCES:
        fn = None
        for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("spill" in line or "registers" in line):
                print(f"  ptxas {name} {fn}: {line.split(':', 1)[-1].strip()}")
                new = "wide" in fn or "conv_dw_wg_kernel" in fn or (
                    "conv_dw_px_kernel" in fn and "Lb1E" in fn)
                if new and "spill" in line and not line.strip().endswith(
                        "0 bytes spill stores, 0 bytes spill loads"):
                    spilled.append((fn, line.strip()))
            elif "conv_dw_wg_kernel" in line and "(C7519)" in line:
                injected += 1      # a wgmma fence ptxas added
            elif "conv_dw_wg_kernel" in line and "(C75" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"  ptxas conv: {injected} wgmma fences injected in conv_dw_wg "
          f"(C7519)")
    if spilled:
        fail(f"this slice's instances spill: {spilled}")


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


# the sites whose bf16 times stand in the JSON line for (wrapper, k)
INV_ROWS = {("conv_valid", 7): "up_conv s0", ("conv_valid", 5): "up_conv s2",
            ("conv_valid_s2d", 4): "down_conv1 s0",
            ("conv_valid_s2d", 3): "down_conv1 s2",
            ("conv_dw", 7): "up_conv s0", ("conv_dw", 5): "up_conv s2",
            ("conv_dw_s2d", 4): "down_conv1 s0",
            ("conv_dw_s2d", 3): "down_conv1 s2"}


def check_conv_inversion(torch, conv):
    """K3 (plain, pro and the input gradient) and K4 (plain and pro) at
    the inversion net's sites (conv_forms.INV_SITES: k = 7, 5 and the
    stride-2 phase
    kernels' k2 = 4, 3), bf16 (tensor cores) and fp32, each twice on one
    input (bitwise), and the bf16 forms timed against F.conv2d,
    conv2d_input and conv2d_weight. Returns {(wrapper, k): row} for
    INV_ROWS, max_abs_err the largest over that wrapper's sites at that
    k."""
    from splice_tpu_torch.tools.conv_forms import INV_SITES
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
                    g, wk_flip, kk - 1, phase=stride == 2),
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
            if dtype_name == "bfloat16":
                # K3 on the pixel-major form at every site; K4 on the form
                # conv_route names from the shape (dw_px_form)
                routes = (
                    conv.conv_route("fwd", dt, kk, stride, wk.shape[2], cout,
                                    1, ho, wo),
                    conv.conv_route("fwd", dt, kk, 1, cout, wk.shape[2], 1,
                                    ho + kk - 1, wo + kk - 1,
                                    phase=stride == 2),
                    conv.conv_route("dw", dt, kk, stride, wk.shape[2], cout,
                                    1, ho, wo))
                print(f"  routes {tag}: " + "; ".join(
                    f"{r.kernel} {r.entry} {r.tiling}" for r in routes))
                keep = not conv.dw_px_form(kk, stride == 2, wk.shape[2],
                                           cout, 1, ho, wo)
                if (routes[0].form != "px" or routes[1].form != "px"
                        or routes[2].form != ("tc" if keep else "px")):
                    fail(f"{tag}: not on the forms conv_route's rule names: "
                         f"{routes}")
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
                    k3 = wrapper.startswith("conv_valid")
                    rows[(wrapper, kr)] = dict(
                        fwd if k3 else dw, shape=tag,
                        form=routes[0 if k3 else 2].form)
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



# Filter sizes that no generator default takes (ROADMAP C9): (k, stride),
# each through kernel_conv_chw and kernel_conv_bn_act_chw with autograd
ANY_K = ((6, 1), (9, 1), (6, 2), (9, 2), (11, 2))


@contextlib.contextmanager
def no_library_conv(torch):
    """torch.nn.functional.conv2d fails inside the block: a conv on a
    kernel route must never reach it."""
    F = torch.nn.functional
    old = F.conv2d

    def refuse(*a, **kw):
        fail("a conv on a kernel route reached F.conv2d")

    F.conv2d = refuse
    try:
        yield
    finally:
        F.conv2d = old


def conv_counts(conv):
    """(launches, tensor-core launches) of every K3/K4/K7 wrapper."""
    return {n: (getattr(conv, f"{n}_cuda").launches,
                getattr(conv, f"{n}_cuda").tc_launches) for n in K3 + DW}


def counted(conv, before):
    """The wrappers' (launches, tensor-core launches) since `before`."""
    return {n: (c[0] - before[n][0], c[1] - before[n][1])
            for n, c in conv_counts(conv).items() if c != before[n]}


def check_conv_any_k(torch, conv):
    """ROADMAP C9 on the card: at k = 6 and 9 (stride 1) and 6, 9 and 11
    at stride 2 (their phase kernels k2 = 3, 5, 6), in bf16 and fp32,
    kernel_conv_chw and kernel_conv_bn_act_chw (two BatchNorm stacks)
    forward and backward ([2, 12, 37, 45] -> 20 channels, zero padding,
    the bias) against the same calls on the CPU (the plain versions), the
    output, the input gradient and the weight gradient each within phase
    2's tolerance; every conv on a kernel of the port (F.conv2d refused
    inside), K3 at least twice (forward and input gradient) and K4 once,
    each launch on the tensor cores (fp32 in split TF32). Then K7's route
    at k = 9 with
    SAME_BORDER_KERNELS on (36 -> 4 channels, where _gtap_better picks K7,
    and conv_route runs it: bf16 on conv_dw_px's cotangent-tapped mode,
    fp32 on conv_dw_tf32's): kernel_conv_chw forward and backward, and
    conv_dw_gtap_cuda itself against K7's plain version; K7 launched for
    both, K4 never."""
    gen = torch.Generator().manual_seed(16)
    for k, stride in ANY_K:
        x = torch.randn(2, 12, 37, 45, generator=gen)
        w = 0.1 * torch.randn(k, k, 12, 20, generator=gen)
        b = torch.randn(20, generator=gen)
        sc = 0.5 + torch.rand(2, 12, generator=gen)
        sh = torch.randn(2, 12, generator=gen)
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            rtol, why = RTOL[dtype_name]
            for pro in (False, True):
                def run(dev):
                    xs = x.to(dev, dt).clone().requires_grad_(True)
                    ws = w.to(dev, dt).clone().requires_grad_(True)
                    p = {"kernel": ws, "bias": b.to(dev, dt)}
                    if pro:
                        out = conv.kernel_conv_bn_act_chw(
                            xs, p, sc.to(dev), sh.to(dev), stride, "zero",
                            0.2)
                    else:
                        out = conv.kernel_conv_chw(xs, p, stride)
                    gy = torch.randn(out.shape, generator=torch.Generator()
                                     .manual_seed(k)).to(dev, dt)
                    out.backward(gy)
                    return out, xs.grad, ws.grad
                fn = "kernel_conv_bn_act_chw" if pro else "kernel_conv_chw"
                tag = f"any k: k={k} stride {stride} {fn} {dtype_name}"
                before = conv_counts(conv)
                with no_library_conv(torch):
                    got = run("cuda")
                    torch.cuda.synchronize()
                ran = counted(conv, before)
                ref = run("cpu")
                for what, gt, rf in zip(("out", "dx", "dw"), got, ref):
                    compare(f"{tag} {what}", gt, rf.to("cuda"), rtol, why)
                print(f"  {tag}: launches (all, tensor cores) {ran}")
                n3 = sum(ran.get(n, (0, 0))[0] for n in K3)
                n4 = sum(ran.get(n, (0, 0))[0] for n in DW)
                # every K3 and K4 launch, bf16 and fp32 (split TF32)
                on_tc = all(t == n for n, t in ran.values())
                if n3 < 2 or n4 < 1 or not on_tc:
                    fail(f"{tag}: K3 {n3} and K4 {n4} launches, or off the "
                         f"tensor cores: {ran}")
    # K7's route at k = 9 (SAME route, 36 -> 4: _gtap_better picks K7)
    x = torch.randn(2, 36, 29, 33, generator=gen)
    w = 0.1 * torch.randn(9, 9, 36, 4, generator=gen)
    g = torch.randn(2, 4, 29, 33, generator=gen)
    if not conv._gtap_better(9, 36, 4):
        fail("k = 9, 36 -> 4: _gtap_better no longer picks K7")
    with same_border(True):
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            rtol, why = RTOL[dtype_name]
            route = conv.conv_route("dw", dt, 9, 1, 36, 4, 2, 29, 33,
                                    same=True)
            if route.kernel != "K7":
                fail(f"K7 at k = 9 routed to {route}")

            def run(dev):
                xs = x.to(dev, dt).clone().requires_grad_(True)
                ws = w.to(dev, dt).clone().requires_grad_(True)
                out = conv.kernel_conv_chw(xs, {"kernel": ws}, 1, "zero")
                out.backward(g.to(dev, dt))
                return out, xs.grad, ws.grad
            tag = f"K7's route at k=9, SAME on, {dtype_name}"
            before = conv_counts(conv)
            with no_library_conv(torch):
                got = run("cuda")
                direct = conv.conv_dw_gtap_cuda(x.to("cuda", dt),
                                                g.to("cuda", dt), 9, pad=4)
                torch.cuda.synchronize()
            ran = counted(conv, before)
            for what, gt, rf in zip(("out", "dx", "dw"), got, run("cpu")):
                compare(f"{tag} {what}", gt, rf.to("cuda"), rtol, why)
            compare(f"{tag} conv_dw_gtap_cuda", direct,
                    conv.conv_dw_gtap_plain(x.to(dt), g.to(dt), 9,
                                            pad=4).to("cuda"),
                    RTOL["float32"][0], DW_WHY)
            print(f"  {tag}: launches (all, tensor cores) {ran}; the weight "
                  f"gradient's route {route.kernel} {route.entry}")
            if not (ran.get("conv_same", (0, 0))[0] >= 2
                    and "conv_dw" not in ran
                    and ran.get("conv_dw_gtap", (0, 0))[0] == 2):
                fail(f"{tag}: launches {ran}")


@contextlib.contextmanager
def dw_choices(conv):
    """conv_route's weight-gradient choices on the SAME route inside the
    block, as conv_weight_grad asks for them: a list of (k, Cin, Cout,
    kernel, form)."""
    rec, route = [], conv.conv_route

    def wrapped(op, dtype, k, stride, cv, cout, *a, **kw):
        r = route(op, dtype, k, stride, cv, cout, *a, **kw)
        if op == "dw" and kw.get("same"):
            rec.append((k, cv, cout, r.kernel, r.form))
        return r

    conv.conv_route = wrapped
    try:
        yield rec
    finally:
        conv.conv_route = route


def check_k7_choices(conv, tag, rec, ran, k=9):
    """Every SAME-route weight gradient at filter k took K7 exactly where
    the reference's _dw_impl would (DW_TAP_ON_N and _gtap_better), K4
    nowhere in its place, K7 at least once, and K7's wrapper launched as
    often as the route chose it."""
    at_k = [r for r in rec if r[0] == k]
    wrong = [r for r in at_k
             if (r[3] == "K7") != conv._gtap_better(k, r[1], r[2])]
    n7 = sum(r[3] == "K7" for r in at_k)
    print(f"  {tag}: SAME-route dw at k = {k}: {at_k}")
    if wrong or not n7 or ran.get("conv_dw_gtap", (0, 0))[0] != n7:
        fail(f"{tag}: K7's route at k = {k}: {wrong or at_k}; launches "
             f"{ran}")
    return n7


def check_generator_9x9(torch, conv):
    """ROADMAP C9 through the generator: a three-scale net with 9x9 up
    convs (SkipConfig filter_size_up = 9, two BatchNorm stacks) through
    skip_apply_chw with generator_conv pallas and fused, fp32, on
    [2, 64, 448, 3] (448 wide, so fused runs the prologue kernels at scale
    0, KERNEL_MIN_WIDTH), with the SAME route off and on, on the card
    against the CPU's float64 (its plain versions); F.conv2d refused on the
    card under pallas (fused takes it at its narrow sites by the
    reference's auto rule). With the SAME route on, every up conv's weight
    gradient takes K7 at k = 9 where _gtap_better says so (check_k7_choices:
    K4 nowhere in its place). Tolerances as check_small_inversion_step: the
    output 1e-4 x max|out|; the parameter gradient of sum(out * w) max(5e-3,
    2 x the CPU's fp32 distance from float64) in max error over max|grad|
    and in relative L2 (the generator's fp32 gradient is ill-conditioned in
    fp32 itself). Returns K7's launches on the SAME route (fp32)."""
    from splice_tpu_torch.models import unet
    cfg = unet.SkipConfig(channels_down=(8, 8, 16), channels_up=(8, 8, 16),
                          channels_skip=(2, 2, 2), filter_size_up=9)
    tree = unet.init_skip_params(cfg, seed=9, device="cpu")
    gen = torch.Generator().manual_seed(9)
    x = torch.rand(2, 64, 448, 3, generator=gen)
    wt = torch.randn(2, 64, 448, 3, generator=gen)

    def run(mode, dev, dt):
        flat, spec = unet.flatten_params(tree)
        flat = flat.to(dev, dt).requires_grad_(True)
        out = unet.skip_apply_chw(unet.unflatten_params(flat, spec), cfg,
                                  x.to(dev, dt), groups=2, conv_impl=mode)
        (grad,) = torch.autograd.grad((out * wt.to(dev, dt)).sum(), flat)
        return out.detach().cpu().double(), grad.cpu().double()

    def gaps(a, b):
        return ((a[0] - b[0]).abs().max().item() / b[0].abs().max().item(),
                (a[1] - b[1]).abs().max().item() / b[1].abs().max().item(),
                ((a[1] - b[1]).norm() / b[1].norm()).item())

    k7 = 0
    for same in (False, True):
        for mode in ("pallas", "fused"):
            label = f"{mode}{', SAME route' if same else ''}"
            with same_border(same):
                truth = run(mode, "cpu", torch.float64)
                cpu = gaps(run(mode, "cpu", torch.float32), truth)
                gtol, ltol = max(5e-3, 2 * cpu[1]), max(5e-3, 2 * cpu[2])
                before = conv_counts(conv)
                # pallas sends every conv to the kernels; fused only the
                # prologue sites, the rest by the reference's auto rule
                # (F.conv2d where narrow)
                with no_library_conv(torch) if mode == "pallas" \
                        else contextlib.nullcontext(), dw_choices(conv) as rec:
                    card = gaps(run(mode, "cuda", torch.float32), truth)
                    torch.cuda.synchronize()
            ran = counted(conv, before)
            print(f"  9x9 generator ({label}, fp32, [2,64,448,3]): the card "
                  f"against float64 out {card[0]:.2e} (tol 1e-4), grad "
                  f"{card[1]:.2e} / {card[2]:.2e} (tol {gtol:.2e} / "
                  f"{ltol:.2e}; the CPU's fp32 {cpu[1]:.2e} / {cpu[2]:.2e}); "
                  f"launches {ran}")
            need = ("conv_valid_pro",) if mode == "fused" \
                else ("conv_valid", "conv_dw")
            if not (card[0] <= 1e-4 and card[1] <= gtol and card[2] <= ltol):
                fail(f"9x9 generator ({label}): the card disagrees")
            if any(not ran.get(n, (0, 0))[0] for n in need):
                fail(f"9x9 generator ({label}): {need} not launched: {ran}")
            if same:
                k7 += check_k7_choices(conv, f"9x9 generator ({label})", rec,
                                       ran)
    return k7


# phase 6d: K7's run against K4's may differ by GEN9_MULT x the spread of
# two K4 runs plus the bf16 gate (RTOL's 1.6e-2 x max|K4 run's|)
GEN9_MULT = 2.0


@contextlib.contextmanager
def no_wg_form(conv):
    """conv_route sends no weight gradient to conv_dw_wg inside the block
    (its dw_wg_form admits no shape): bf16 K4 and K7 at k = 9 take the
    pixel-major forms, as the route did before conv_dw_wg."""
    form = conv.dw_wg_form
    conv.dw_wg_form = lambda *a, **kw: False
    try:
        yield
    finally:
        conv.dw_wg_form = form


def check_generator_9x9_full(torch, conv):
    """bf16 K7 at k = 9 on a path at full width: the default-width generator
    (SkipConfig(), 16-128 channels over five scales) with filter_size_up =
    9 on [2, 896, 896, 3], generator_conv pallas, the SAME route on, bf16
    compute over fp32 parameters, forward and backward of sum(out * w): K7
    at up_conv s0-s2 (36 -> 16, 68 -> 32, 132 -> 64, where _gtap_better
    picks it), K4 at s3-s4, as check_k7_choices requires, all on
    conv_dw_wg; then with DW_TAP_ON_N off (K4 at every up conv, on
    conv_dw_wg). The reference is independent of conv_dw_wg: the same
    run with DW_TAP_ON_N off on the pixel-major forms (no_wg_form), run
    twice: the bilinear backward's atomics make two such runs differ by up
    to 1% of the largest entry (bf16 rounding downstream of them), so each
    9x9 kernel's gradient and the flat gradient of the conv_dw_wg runs (and
    of K7 on the pixel-major form) must lie within GEN9_MULT x the two
    reference runs' distance plus the bf16 gate (1.6e-2 x max|reference's|)
    of the first reference run. Times forward + backward, every route (host
    wall), and the device ms a pass of the weight-gradient kernels
    (conv_dw_*: K7's and K4's kernels and their sums; torch.profiler over
    one more pass). Returns K7's launches and, with DW_TAP_ON_N off, K4's on
    conv_dw_wg (up_conv s0-s4)."""
    from splice_tpu_torch.models import unet
    cfg = unet.SkipConfig(filter_size_up=9)
    tree = unet.init_skip_params(cfg, seed=19, device="cuda")
    flat0, spec = unet.flatten_params(tree)
    gen = torch.Generator().manual_seed(19)
    x = torch.rand(2, 896, 896, 3, generator=gen).cuda()
    wt = torch.randn(2, 896, 896, 3, generator=gen).cuda()

    def run():
        # fp32 parameters, bf16 compute: as SpliceTrainer runs it
        flat = flat0.clone().requires_grad_(True)
        out = unet.skip_apply_chw(unet.unflatten_params(flat, spec), cfg, x,
                                  compute_dtype=torch.bfloat16,
                                  conv_impl="pallas")
        (grad,) = torch.autograd.grad((out.float() * wt).sum(), flat)
        return grad.float()

    res = []
    # (DW_TAP_ON_N, conv_dw_wg on): K7 and K4 on conv_dw_wg; K7 and twice
    # K4 (the reference) on the pixel-major forms
    settings = ((True, True), (False, True), (True, False), (False, False),
                (False, False))
    for tap_on_n, wg_on in settings:
        forms = contextlib.nullcontext() if wg_on else no_wg_form(conv)
        with same_border(True, tap_on_n), no_library_conv(torch), forms:
            run()
            torch.cuda.synchronize()
            for n in K3 + DW:           # counts from 0 for this path
                fn = getattr(conv, f"{n}_cuda")
                fn.launches = fn.tc_launches = 0
            before = conv_counts(conv)
            with dw_choices(conv) as rec:
                t0 = time.perf_counter()
                grad = run()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        ran = counted(conv, before)
        forms = contextlib.nullcontext() if wg_on else no_wg_form(conv)
        with same_border(True, tap_on_n), no_library_conv(torch), forms:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        dev = sum(e.device_time_total for e in prof.key_averages()
                  if "conv_dw_" in e.key) / 1e3
        res.append((grad, ms, rec, ran, dev))
        print(f"  9x9 generator at full width (bf16, SAME route, DW_TAP_ON_N "
              f"{tap_on_n}, {'conv_dw_wg' if wg_on else 'pixel-major forms'}"
              f"): forward + backward {ms:.1f} ms (host wall), "
              f"weight-gradient kernels {dev:.3f} ms of device time; "
              f"launches {ran}")
    (grad, ms, rec, ran, dev), (grad4, ms4, rec4, ran4, dev4) = res[:2]
    (grad7px, ms7px, rec7px, _, dev7px) = res[2]
    (ref, ms_px, rec_px, ran_px, dev_px), (ref2, *_) = res[3:]
    k7 = check_k7_choices(conv, "9x9 generator at full width", rec, ran)
    if any(r[4] != "wg" for r in rec if r[3] == "K7"):
        fail(f"9x9 generator at full width: bf16 K7 off conv_dw_wg: {rec}")
    k4 = [r for r in rec4 if r[0] == 9 and r[3] == "K4"]
    k4_wg = sum(r[4] == "wg" for r in k4)
    if len(k4) != 5 or k4_wg != len(k4):
        fail(f"9x9 generator at full width: with DW_TAP_ON_N off K4 at k = 9 "
             f"must run 5 times (up_conv s0-s4), each on conv_dw_wg: {rec4}")
    off = [r for r in rec7px + rec_px if r[0] == 9 and r[4] == "wg"]
    if off or any(r[4] != "px" for r in rec_px if r[0] == 9):
        fail(f"9x9 generator at full width: the reference runs reached "
             f"conv_dw_wg or left the pixel-major forms: {rec_px} {off}")
    if ran4.get("conv_dw_gtap") or ran_px.get("conv_dw_gtap"):
        fail("9x9 generator at full width: K7 with DW_TAP_ON_N off")
    rtol = RTOL["bfloat16"][0]
    parts = [("flat gradient", slice(None))]
    start = 0
    for path, shape in spec:
        n = math.prod(shape)
        if path[-1] == "kernel" and tuple(shape[:2]) == (9, 9):
            parts.append((f"{'/'.join(map(str, path))} gradient",
                          slice(start, start + n)))
        start += n
    for what, sl in parts:
        spread = (ref2[sl] - ref[sl]).abs().max().item()
        tol = GEN9_MULT * spread + rtol * ref[sl].abs().max().item()
        for run_tag, got in (("K7 (wg)", grad), ("K4 (wg)", grad4),
                             ("K7 (px)", grad7px)):
            err = (got[sl] - ref[sl]).abs().max().item()
            print(f"  9x9 generator at full width, {what}: {run_tag} against "
                  f"K4 (px) max_abs_err {err:.3e}, two K4 (px) runs "
                  f"{spread:.3e} (tol {tol:.3e} = {GEN9_MULT:g} x that + "
                  f"{rtol:g} x max|K4 (px)|)")
            if not err <= tol:
                fail(f"9x9 generator at full width, {what}: {run_tag} "
                     f"disagrees with K4 on the pixel-major forms")
    print(f"  9x9 generator at full width: forward + backward {ms:.1f} ms "
          f"with K7, {ms4:.1f} ms with K4 on conv_dw_wg, {ms7px:.1f} / "
          f"{ms_px:.1f} ms on the pixel-major forms (host wall); "
          f"weight-gradient kernels {dev:.3f} / {dev4:.3f} ms on conv_dw_wg, "
          f"{dev7px:.3f} / {dev_px:.3f} ms on the pixel-major forms, of "
          f"device time a pass")
    return k7, k4_wg


@contextlib.contextmanager
def no_sdpa(torch):
    """torch.nn.functional.scaled_dot_product_attention fails inside the
    block: attention on the kernels' route must never reach it."""
    F = torch.nn.functional
    old = F.scaled_dot_product_attention

    def refuse(*a, **kw):
        fail("attention on the kernels' route reached SDPA")

    F.scaled_dot_product_attention = refuse
    try:
        yield
    finally:
        F.scaled_dot_product_attention = old


def check_attention_dh(torch, attn):
    """multi_head_attention at dh = 32 (library_attention, SDPA), 64 and
    128 (K5/K6: dh = 128 on K5's and K6's wide passes, SDPA
    refused inside), bf16 and fp32, [2, 4, 197, dh] with 150 valid keys,
    forward and backward against the reference's XLA math
    (xla_attention_plain, by autograd, on the card) within phase 2's
    tolerances; K5 and K6 each launched once at dh = 64 and 128 and never
    at 32."""
    gen = torch.Generator().manual_seed(21)
    for dh in (32, 64, 128):
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            rtol, why = RTOL[dtype_name]
            q, k, v, g = (torch.randn(2, 4, 197, dh, generator=gen).to(
                "cuda", dt) for _ in range(4))

            def run(fn):
                ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = fn(*ts, dh ** -0.5, 150)
                out.backward(g)
                return (out, *(t.grad for t in ts))
            n0 = (attn.attn_fwd_cuda.launches, attn.attn_bwd_cuda.launches)
            with no_sdpa(torch) if dh % 64 == 0 \
                    else contextlib.nullcontext():
                got = run(attn.multi_head_attention)
                torch.cuda.synchronize()
            n = (attn.attn_fwd_cuda.launches - n0[0],
                 attn.attn_bwd_cuda.launches - n0[1])
            ref = run(attn.xla_attention_plain)
            tag = f"multi_head_attention dh={dh} {dtype_name}"
            for what, gt, rf in zip(("out", "dq", "dk", "dv"), got, ref):
                compare(f"{tag} {what}", gt, rf, rtol, why)
            want = (1, 1) if dh % 64 == 0 else (0, 0)
            print(f"  {tag}: K5/K6 launches {n} (want {want})")
            if n != want:
                fail(f"{tag}: K5/K6 launches {n}, want {want}")


# Phase 6c: ViT-B/8's width as 6 heads of 128 (a VitConfig both packages
# run; no VIT_CONFIGS name): (label, batch, image height, width, tokens) of
# the 480 loss resolution's two crops and entire A (900 x 1200 -> 360 x
# 480) and the 224 resolution's (900 x 1200 -> 224 x 296). At dh = 128 the
# fused-qkv gate fails, so every shape runs on K5/K6's wide forms.
VIT_WIDE = dict(patch_size=8, embed_dim=768, depth=12, num_heads=6)
VIT_WIDE_SHAPES = (("480 crops", 2, 480, 480, 3601),
                   ("480 entire A", 1, 360, 480, 2701),
                   ("224 crops", 2, 224, 224, 785),
                   ("224 entire A", 1, 224, 296, 1037))
# the bf16 route's distance from the fp32 library route may be this many
# times the bf16 library route's distance from it, plus VIT_WIDE_FLOOR;
# fp32 against the fp32 library route: VIT_WIDE_FP32 (taps, gradient)
VIT_WIDE_MULT, VIT_WIDE_FLOOR = 2.0, 1e-3
VIT_WIDE_FP32 = (1e-4, 1e-3)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def run_vit_wide(torch, attn):
    """Phase 6c: the port's vit_forward at VIT_WIDE with seeded weights
    (weights.init_vit_params), the qkv and block taps of layer 11 under a
    seeded linear loss, backward to the images, at VIT_WIDE_SHAPES in bf16
    and fp32, on the kernels (use_pallas, SDPA refused inside) and on the
    library route (use_pallas=False: SDPA). Gates: 12 K5 launches in the
    forward and 12 K6 in the backward, every one on the tensor cores; fp32
    taps and image gradient within VIT_WIDE_FP32 (relative L2) of the
    library route's; bf16 ones within VIT_WIDE_MULT x the bf16 library
    route's distance from the fp32 library route plus VIT_WIDE_FLOOR (both
    bf16 routes round at other places; a fault lands far outside). Prints
    forward + backward ms of both routes. Returns {dtype: {wrapper:
    launches}}."""
    from splice_tpu_torch.models import vit, weights
    cfg = vit.VitConfig(**VIT_WIDE)
    params = weights.init_vit_params(cfg, seed=23, device="cuda")
    fns = {"attn_fwd": attn.attn_fwd_cuda, "attn_bwd": attn.attn_bwd_cuda}
    taps = {"qkv": [11], "block": [11]}
    launches = {d: dict.fromkeys(fns, 0) for d in ("bfloat16", "float32")}
    for label, B, h, w, n in VIT_WIDE_SHAPES:
        gen = torch.Generator().manual_seed(n)
        img = torch.randn(B, h, w, 3, generator=gen).cuda()
        wq = torch.randn(B, n, 3 * cfg.embed_dim, generator=gen).cuda()
        wb = torch.randn(B, n, cfg.embed_dim, generator=gen).cuda()

        def run(dt, use_pallas):
            x = img.clone().requires_grad_(True)
            out = vit.vit_forward(params, x, cfg, taps, compute_dtype=dt,
                                  use_pallas=use_pallas)
            qkv, blk = out["qkv"][11].float(), out["block"][11].float()
            if qkv.shape[1] != n:
                fail(f"wide-head ViT {label}: {qkv.shape[1]} tokens, want {n}")
            ((qkv * wq).sum() + (blk * wb).sum()).backward()
            return qkv.detach(), blk.detach(), x.grad

        def wall(dt, use_pallas):
            best = math.inf
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(dt, use_pallas)
                torch.cuda.synchronize()
                best = min(best, (time.perf_counter() - t0) * 1e3)
            return best

        ref32 = None
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            tag = f"wide-head ViT (dh 128) {label} [{B},{h},{w}] {dtype_name}"
            for f in fns.values():      # counts from 0 for this path
                f.launches = f.tc_launches = 0
            with no_sdpa(torch):
                got = run(dt, True)
                torch.cuda.synchronize()
            calls = {k: (f.launches, f.tc_launches) for k, f in fns.items()}
            if any(c != (cfg.depth, cfg.depth) for c in calls.values()):
                fail(f"{tag}: K5/K6 (launches, on the tensor cores) {calls}, "
                     f"want {cfg.depth} each")
            for k, (c, _) in calls.items():
                launches[dtype_name][k] += c
            lib = run(dt, False)
            if dtype_name == "float32":
                ref32 = lib
            d_k = [rel_l2(a, b) for a, b in zip(got, ref32)]
            d_l = [rel_l2(a, b) for a, b in zip(lib, ref32)]
            d = [rel_l2(a, b) for a, b in zip(got, lib)]
            if dtype_name == "float32":
                tol = [VIT_WIDE_FP32[0]] * 2 + [VIT_WIDE_FP32[1]]
            else:
                tol = [VIT_WIDE_MULT * x + VIT_WIDE_FLOOR for x in d_l]
            print(f"  {tag}: K5/K6 launches {calls}; relative L2 (qkv, "
                  f"block, image grad) kernels against the library route "
                  f"{', '.join(f'{x:.2e}' for x in d)} (tol "
                  f"{', '.join(f'{x:.2e}' for x in tol)}); against fp32's "
                  f"library route: kernels "
                  f"{', '.join(f'{x:.2e}' for x in d_k)}, library "
                  f"{', '.join(f'{x:.2e}' for x in d_l)}")
            if not all(torch.isfinite(t).all() for t in got):
                fail(f"{tag}: non-finite taps or gradient")
            if any(x > t for x, t in zip(d if dtype_name == "float32"
                                         else d_k, tol)):
                fail(f"{tag}: the kernels' route disagrees with the library "
                     f"route")
            with no_sdpa(torch):
                k_ms = wall(dt, True)
            l_ms = wall(dt, False)
            print(f"  {tag}: forward + backward {k_ms:.2f} ms on K5/K6, "
                  f"{l_ms:.2f} ms on SDPA")
            del got, lib
        del ref32
        torch.cuda.empty_cache()
    return launches


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


# K7 at k = 5 and 7 (pad (k-1)/2): the SAME route's up convs with
# filter_size_up 5 or 7, where _gtap_better takes K7 (36 -> 16: 8 x-tap
# passes against 4 at k = 5, 14 against 7 at k = 7; 68 -> 32: 14 against 7,
# 27 against 13); in fp32 also k = 3, the default generator's SAME sites
# (fused_same_fp32, pallas_same_fp32): (name, Cin, Cout, width)
GTAP_SITES = (("up_conv s0", 36, 16, 896), ("up_conv s1", 68, 32, 448))


# bf16 K4 and K7 at k = 9 and 11 on conv_dw_wg (the generator's up convs
# with filter_size_up 9 or 11, phase 6d): GTAP_SITES and up_conv s2-s4 (k =
# 9 only there; K7 runs at s0-s2 in 6d, K4 at all five)
WG_SITES = GTAP_SITES + (("up_conv s2", 132, 64, 224),
                         ("up_conv s3", 132, 128, 112),
                         ("up_conv s4", 132, 128, 56))


def print_wg_plan(conv, tag, k, t):
    """conv_dw_wg's plan t for one launch (ops.conv.dw_wg_plan: the order
    it contracts in, its tiling, the lead its bands start with) as the card
    builds it (dw_wg_info); fails unless it is one block an SM without
    local memory."""
    info = conv.dw_wg_info(t, k)
    order = "cotangent tapped" if t.gtap else "V tapped"
    print(f"  plan {tag}: {order}, lead {t.lead}, N {t.n} x {t.chunks} "
          f"chunks, {t.groups} tap groups of {t.tg}, {t.ncg} channel "
          f"groups, m64 tiles {t.tiles} a warpgroup, 2 warpgroups, "
          f"{info['stages']} stages, strips of "
          f"{t.rows} rows ({t.slices} strips, {t.blocks} blocks), ring "
          f"{t.rt} rows of {t.tw}, smem {info['smem']} B, "
          f"{info['blocks_per_sm']} block(s) an SM, {info['registers']} "
          f"registers, {info['local_bytes']} local bytes")
    if info["blocks_per_sm"] < 1 or info["local_bytes"]:
        fail(f"conv_dw_wg's plan {tag}: {info}")


def check_wg_site(torch, conv, name, x, g, sc, sh, k, pad, rtol):
    """bf16 K4 (conv_dw_cuda, conv_dw_pro_cuda) at one of WG_SITES, with
    and without the prologue, against its plain version, twice bitwise,
    beside the distance of the pixel-major form (conv_dw_px, the form
    these sites took before conv_dw_wg) from the same plain version; both
    modes' plans printed. conv_dw_wg's other contraction order, the one
    the route did not pick there (forced: _launch_dw_wg), is held against
    the same plain version at the same gate, bitwise twice, so that both
    orders are checked wherever the route may pick either. Returns the
    larger error."""
    B, cin, hw = x.shape[0], x.shape[1], x.shape[2]
    cout = g.shape[1]
    for kind, gtap in (("K7", True), ("K4", False)):
        route = conv.conv_route("dw", x.dtype, k, 1, cin, cout, B, hw, hw,
                                gtap=gtap, in_w=hw)
        if route.form != "wg":
            fail(f"{kind} at {name} k={k}: route {route}, not conv_dw_wg")
        print_wg_plan(conv, f"{kind} {name} k={k}", k, route.tiling)
    if route.tiling.gtap:
        other = conv.dw_wg_tiling(k, cin, cout, B, hw, hw)
    else:
        other = conv.dw_wg_tiling(k, cout, cin, B, hw + k - 1, hw + k - 1,
                                  -pad % 8, gtap=True)
    print_wg_plan(conv, f"K4 {name} k={k} (the other order, forced)", k,
                  other)
    tpx = conv.dw_px_tiling(k, cin, cout, B, hw, hw)
    errs = []
    for pro in (False, True):
        a = (sc, sh, 0.2) if pro else (None, None, 1.0)
        tag = (f"K4 {name} [{B},{cin},{hw},{hw}]->[{B},{cout},{hw},{hw}] "
               f"k={k}{' pro' if pro else ''} bfloat16 (wg)")

        def run():
            if pro:
                return conv.conv_dw_pro_cuda(x, g, k, sc, sh, 0.2, pad)
            return conv.conv_dw_cuda(x, g, k, pad)
        dw = run()
        want = (conv.conv_dw_pro_plain(x, g, k, sc, sh, 0.2, pad, 1) if pro
                else conv.conv_dw_plain(
                    torch.nn.functional.pad(x, (pad,) * 4), g, k))
        errs.append(compare(tag, dw, want, rtol, DW_WHY))
        check_bitwise(torch, tag, (dw,), (run(),))
        order = "cotangent tapped" if other.gtap else "V tapped"

        def forced():
            return conv._launch_dw_wg(x, g, k, pad, 1, *a, False, other,
                                      "conv_dw_wg forced")
        ftag = f"{tag} {order} (forced)"
        errs.append(compare(ftag, forced(), want, rtol, DW_WHY))
        check_bitwise(torch, ftag, (forced(),), (forced(),))
        old = conv._launch_dw_px(x, g, k, pad, 1, *a, False, tpx, "px")
        old_err = (old.float() - want.float()).abs().max().item()
        print(f"  {tag}: conv_dw_wg {errs[-2]:.3e} from plain ({order} "
              f"forced {errs[-1]:.3e}), conv_dw_px {old_err:.3e}")
        del dw, want, old
    return max(errs)


def check_gtap_wide_k(torch, conv):
    """K7 at k = 5, 7, 9 and 11 in bf16 and fp32, and at k = 3 in fp32
    (bf16 K7 at k = 3: check_conv_same), at GTAP_SITES, with and without
    the prologue: against its plain version (an fp32 output: 1e-4 x
    max|plain|), twice on one input bitwise, every launch on the tensor
    cores (fp32 in split TF32; bf16 at k = 9 and 11 on conv_dw_wg, beside
    the distance of conv_dw_px, the form these sites took before it);
    timed against conv2d_weight (cuDNN's TF32 off) at up_conv s0, and at
    both sites fp32 at k = 3 and both dtypes at k = 9 and 11, beside K4 at
    the same site (k4_ms: the same function contracted the other way
    round). bf16 K4 at k = 9 and 11 at WG_SITES (conv_dw_wg; up_conv s2-s4
    at k = 9) and bf16 K7 at up_conv s2-s4 at k = 9, with and without the
    prologue, against their plain versions at the same gate, bitwise
    twice, timed beside conv2d_weight, with conv_dw_wg's plan of each
    printed and its other contraction order forced and checked too
    (check_wg_site). Returns ({(k, dtype, site): K7 row}, {(k, site): K4
    row})."""
    rtol = RTOL["float32"][0]
    gen = torch.Generator().manual_seed(8)
    fn = conv.conv_dw_gtap_cuda
    n0, t0 = fn.launches, fn.tc_launches
    checked = 0
    out, out4 = {}, {}
    for name, cin, cout, hw in WG_SITES:
        B = 2
        third = (name, cin, cout, hw) not in GTAP_SITES    # s2-s4
        for dtype_name in (("bfloat16",) if third
                           else ("bfloat16", "float32")):
            dt = getattr(torch, dtype_name)
            x = torch.randn(B, cin, hw, hw, generator=gen).to("cuda", dt)
            g = torch.randn(B, cout, hw, hw, generator=gen).to("cuda", dt)
            sc = (0.5 + torch.rand(2, cin, generator=gen)).cuda()
            sh = torch.randn(2, cin, generator=gen).cuda()
            for k in ((9,) if third else (3, 5, 7, 9, 11)
                      if dt == torch.float32 else (5, 7, 9, 11)):
                form = conv.conv_route("dw", dt, k, 1, cin, cout, B, hw, hw,
                                       gtap=True, in_w=hw).form
                pad = (k - 1) // 2
                wg = form == "wg"
                if dt == torch.bfloat16 and k in (9, 11) and not wg:
                    fail(f"bf16 K7 at {name} k={k} off conv_dw_wg: {form}")
                tpx = conv.dw_px_gtap_tiling(k, cout, cin, B, hw + k - 1,
                                             hw + k - 1)
                errs = []
                for pro in (False, True):
                    a = (sc, sh, 0.2) if pro else (None, None, 1.0)
                    tag = (f"{name} [{B},{cin},{hw},{hw}]->[{B},{cout},{hw},"
                           f"{hw}] k={k}{' pro' if pro else ''} {dtype_name}"
                           f" ({form})")
                    dw = fn(x, g, k, *a, pad)
                    want = conv.conv_dw_gtap_plain(x, g, k, *a, pad)
                    errs.append(compare(f"K7 {tag}", dw, want, rtol, DW_WHY))
                    check_bitwise(torch, f"K7 {tag}", (dw,),
                                  (fn(x, g, k, *a, pad),))
                    checked += 2
                    if wg:
                        old = conv._reverse_taps(conv._launch_dw_px(
                            x, g, k, pad, 1, *a, True, tpx, "px"), k)
                        old_err = (old - want.float()).abs().max().item()
                        print(f"  K7 {tag}: conv_dw_wg {errs[-1]:.3e} from "
                              f"plain, conv_dw_px {old_err:.3e}")
                        del old
                    del dw, want
                k4_err = None
                if wg:
                    k4_err = check_wg_site(torch, conv, name, x, g, sc, sh,
                                           k, pad, rtol)
                if name != "up_conv s0" and k not in (3, 9, 11):
                    continue
                w_shape = (cout, cin, k, k)
                isz = x.element_size()
                nbytes = (x.numel() + g.numel()) * isz + cin * cout * k * k * 4
                flops = 2 * B * hw * hw * cout * cin * k * k
                row = timed(
                    lambda: fn(x, g, k, None, None, 1.0, pad),
                    lambda: conv.conv_dw_gtap_plain(x, g, k, None, None, 1.0,
                                                    pad),
                    lambda: torch.nn.grad.conv2d_weight(x, w_shape, g,
                                                        padding=pad),
                    nbytes, flops, dtype_name, "K7", f"{name} k={k}")
                if k in (3, 9, 11):
                    row["k4_ms"] = time_ms(
                        lambda: conv.conv_dw_cuda(x, g, k, pad))
                    print(f"  time K4 at the same site (the x-tapped "
                          f"order): {row['k4_ms']:.4f} ms")
                out[(k, dtype_name, name)] = dict(
                    row, max_abs_err=max(errs), form=form,
                    shape=tag.replace(" pro", ""))
                if k4_err is not None:
                    row4 = dict(timed(
                        lambda: conv.conv_dw_cuda(x, g, k, pad),
                        lambda: conv.conv_dw_plain(
                            torch.nn.functional.pad(x, (pad,) * 4), g, k),
                        lambda: torch.nn.grad.conv2d_weight(x, w_shape, g,
                                                            padding=pad),
                        nbytes, flops, dtype_name, "K4", f"{name} k={k}"))
                    out4[(k, name)] = dict(
                        row4, max_abs_err=k4_err, form="wg",
                        shape=out[(k, dtype_name, name)]["shape"])
            del x, g
            torch.cuda.empty_cache()
    calls = (fn.launches - n0, fn.tc_launches - t0)
    print(f"  K7 at WG_SITES: {calls[0]} launches, {calls[1]} on the "
          f"tensor cores (checks {checked}; timing launches counted too)")
    if calls[0] < checked or calls[1] != calls[0]:
        fail(f"K7 launches off the tensor cores at WG_SITES: {calls}")
    return out, out4


def check_conv_fp32(torch, conv):
    """fp32 K3 (the forward and the input gradient: the flipped, io-swapped
    kernel over the cotangent with a 1-pixel border, as ConvValidPro.
    backward launches it) and K4 at the two sites the auto rule sends to
    them (main_fp32's), on the tensor cores in split TF32: against their
    plain versions (1e-4 x max|plain|), each twice on one input, bitwise,
    every launch counted in tc_launches; timed beside the plain version
    and F.conv2d, conv2d_input and conv2d_weight with cuDNN's TF32 off
    (torch.backends.cudnn.allow_tf32 = False: cuDNN's fp32 conv would
    otherwise round its inputs to TF32). Returns {(row, site): row},
    row in conv_valid, conv_valid_dx, conv_dw."""
    F = torch.nn.functional
    if torch.backends.cudnn.allow_tf32:
        fail("cuDNN's TF32 is on: the fp32 yardsticks would round to TF32")
    print("  fp32 K3/K4 at the auto sites (cudnn.allow_tf32 = False, "
          "matmul.allow_tf32 = False)")
    rtol, why = RTOL["float32"]
    gen = torch.Generator().manual_seed(9)
    out = {}
    for site, (cin, cout, hw) in enumerate(((36, 16, 896), (68, 32, 448))):
        B, k = 2, 3
        x = torch.randn(B, cin, hw, hw, generator=gen).cuda()
        w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).cuda()
        g = torch.randn(B, cout, hw, hw, generator=gen).cuda()
        w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        tag = (f"site {site} [{B},{cin},{hw},{hw}]->[{B},{cout},{hw},{hw}] "
               f"pad 1 float32")
        flops = 2 * B * hw * hw * cout * cin * k * k
        nbytes = (x.numel() + g.numel() + w.numel()) * 4
        before = (tc_k3_launches(conv), tc_dw_launches(conv))
        calls = {
            "conv_valid": (lambda: conv.conv_valid_cuda(x, w, 1),
                           lambda: conv.conv_valid_plain(x, w, 1),
                           lambda: F.conv2d(x, w_oihw, padding=1),
                           "K3 fp32", f"fwd {tag}", rtol, why),
            "conv_valid_dx": (lambda: conv.conv_valid_cuda(g, w_flip, 1),
                              lambda: conv.conv_valid_plain(g, w_flip, 1),
                              lambda: torch.nn.grad.conv2d_input(
                                  x.shape, w_oihw, g, padding=1),
                              "K3 fp32 dx", f"dx {tag}", rtol, why),
            "conv_dw": (lambda: conv.conv_dw_cuda(x, g, k, 1),
                        lambda: conv.conv_dw_plain(F.pad(x, (1, 1, 1, 1)),
                                                   g, k),
                        lambda: torch.nn.grad.conv2d_weight(
                            x, w_oihw.shape, g, padding=1),
                        "K4 fp32", tag, rtol, DW_WHY)}
        for name, (kern, plain, lib, label, shape, tol, wh) in calls.items():
            got = kern()
            err = compare(f"{label} {tag}", got, plain(), tol, wh)
            check_bitwise(torch, f"{label} {tag}", (got,), (kern(),))
            del got
            out[(name, site)] = dict(timed(kern, plain, lib, nbytes, flops,
                                           "float32", label, tag),
                                     max_abs_err=err, shape=shape)
        launched = (tc_k3_launches(conv) - before[0],
                    tc_dw_launches(conv) - before[1])
        # each kernel: compare, bitwise and its timed() batches
        if min(launched) < 4:
            fail(f"fp32 K3/K4 {tag}: tensor-core launches {launched}")
        del x, g
        torch.cuda.empty_cache()
    return out


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


def check_dw_tc_edge_cases(torch, conv, dtype_name="bfloat16"):
    """The weight-gradient kernels at DW_EDGES against their plain
    versions (fp32 sums: 1e-4 x max|plain|), in bf16 or fp32, every launch
    on the tensor cores (fp32 K4 and K7 in split TF32), K7 also twice on
    one input, bitwise; stride 2 as the k2 phase-image dw, a scale of 1e-13
    and a negative one in the first stack."""
    gen = torch.Generator().manual_seed(9)
    rtol = RTOL["float32"][0]
    dt = getattr(torch, dtype_name)
    for label, B, cin, cout, h, w, k, pad, stride, G, gtap in DW_EDGES:
        x = torch.randn(B, cin, h, w, generator=gen).to("cuda", dt)
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        kk = (k + 1) // 2 if stride == 2 else k
        g = torch.randn(B, cout, ho, wo, generator=gen).to("cuda", dt)
        a = (None, None, 1.0)
        if G:
            sc = (0.5 + torch.rand(G, cin, generator=gen)).cuda()
            sc[0, 0] = 1e-13
            sc[0, cin - 1] = -0.7
            a = (sc, torch.randn(G, cin, generator=gen).cuda(), 0.2)
        tag = (f"{label} [{B},{cin},{h},{w}]->[{B},{cout},{ho},{wo}] k={k} "
               f"pad={pad} stride={stride} G={G} {dtype_name}")
        tc = tc_dw_launches(conv)
        if gtap:
            got = conv.conv_dw_gtap_cuda(x, g, k, *a, pad)
            want = conv.conv_dw_gtap_plain(x, g, k, *a, pad)
            name = "K7"
            check_bitwise(torch, f"{name} {tag}", (got,),
                          (conv.conv_dw_gtap_cuda(x, g, k, *a, pad),))
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
        if tc_dw_launches(conv) != tc + 1 + gtap:
            fail(f"{name} {tag}: a launch was not on the tensor cores")
        del x, g, got, want


# bf16 (tensor-core) K3 edge cases: (label, form, B, Cin, Cout, H, W, k,
# pad, stride, BatchNorm stacks). Forms: valid (conv_valid), same, pro
# (conv_valid_pro, at stride 1 or 2), same_pro, s2d, stats (K3''').
# W = 37 and H < k; Cin 3 and 136; Cout 3 (out_conv), 36 (the input
# gradient at up_conv s0), 68 (at up_conv s1) and 128 (two output-channel
# chunks); k = 1, 2, 3; stride 2 at odd sizes with and without the
# prologue; two stacks (a scale of 1e-13 and a negative one); K3''' at
# ragged sizes and at k = 5 and 7 (the SAME 5x5 and 7x7, two stacks, on
# the pixel-major form); the entire-A generator at B = 1 from the 900 x
# 1200 image: widths 1200, 600, 150 and 75, heights 900 and 113, with the
# input gradients of up_conv s0/s1.
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
    ("K3''' k=5", "stats", 2, 32, 64, 28, 36, 5, 2, 1, 2),
    ("K3''' k=7", "stats", 2, 36, 16, 40, 57, 7, 3, 1, 2),
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


def check_k3_tc_edge_cases(torch, conv, dtype_name="bfloat16"):
    """The K3 forms at K3_EDGES against their plain versions, in bf16
    (1.6e-2 x max|plain|; K3''' sums 1e-4) or fp32 (1e-4; split TF32),
    every launch on the tensor cores; stride 2 through the k2 phase
    kernel; K3''' also bitwise twice (at k = 5 and 7 in bf16 on the
    pixel-major form: fp32 partials and the fixed-order second pass)."""
    gen = torch.Generator().manual_seed(10)
    rtol, why = RTOL[dtype_name]
    dt = getattr(torch, dtype_name)
    for label, form, B, cin, cout, h, w, k, pad, stride, G in K3_EDGES:
        x = torch.randn(B, cin, h, w, generator=gen).to("cuda", dt)
        wt = 0.1 * torch.randn(k, k, cin, cout, generator=gen)
        if stride == 2:
            wt = conv.s2d_kernel(wt)
        wt = wt.contiguous().to("cuda", dt)
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        a = (None, None, 1.0)
        if G:
            sc = (0.5 + torch.rand(G, cin, generator=gen)).cuda()
            sc[0, 0] = 1e-13
            sc[G - 1, cin - 1] = -0.7
            a = (sc, torch.randn(G, cin, generator=gen).cuda(), 0.2)
        tag = (f"{label} [{B},{cin},{h},{w}]->[{B},{cout},{ho},{wo}] k={k} "
               f"pad={pad} stride={stride} G={G} {form} {dtype_name}")
        want = conv.conv_valid_pro_plain(x, wt, *a, pad, stride, (ho, wo))
        tc = tc_k3_launches(conv)
        if form == "stats":
            got = conv.conv_same_pro_stats_cuda(x, wt, *a)
            check_stats(torch, conv, tag, got, x, wt, *a, rtol, why)
            check_bitwise(torch, f"K3''' {tag}", got,
                          conv.conv_same_pro_stats_cuda(x, wt, *a))
            tc += 1
            del got
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
            fail(f"K3 {tag}: the launch was not on the tensor cores")
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
    3, fp32 in split TF32), each against the CPU's float64 evaluation (the
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

    dists = [(rel_loss(l2, l1), rel_upd(d2, d1)) for l2, d2 in others]
    spread = (max(d[0] for d in dists), max(d[1] for d in dists))
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
    if spread_runs > 1:
        print(f"  {label}: each eager run against the first: losses "
              + ", ".join(f"{d[0]:.3e}" for d in dists) + "; update "
              + ", ".join(f"{d[1]:.3e}" for d in dists))
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
OUR_KERNELS = ("attn_fwd_kernel", "attn_bwd_", "conv_fwd_tf32",
               "conv_fwd_tc", "conv_fwd_px", "conv_split_sum", "conv_dw_",
               "conv_stats_")
# the K3 (forward and input gradient) and K4/K7 kernels among them
K3_KERNELS = ("conv_fwd_tf32", "conv_fwd_tc", "conv_fwd_px",
              "conv_split_sum", "conv_stats_")


def regular_rows(torch, cfg, pairs, n: int, seed: int):
    """n packed rows of regular steps (lambdas of step 5) from a seed, for
    one pair or a list of pairs (packed_rows)."""
    return packed_rows(cfg, pairs, 5, torch.Generator().manual_seed(seed), n)


def profile_steps(torch, program, cfg, n: int = 3, kernel_ms=None) -> float:
    """Per regular step, through `program` (its regular graph captured
    first if this route has none): the host-clock wall of a chunk of
    replays as long as the path's longest (its draws, its copy and its one
    read included; the median of three chunks), beside the wall of n eager
    steps
    (SpliceTrainer.step, which the parent ran); the device's span over
    the chunk by CUDA events; then torch.profiler over a chunk of n
    replays: kernel time by name inside the graphs (also into the dict
    kernel_ms where one is given: ms per step by kernel name), and graph
    launches. Returns the replays' wall ms per step."""
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
    if kernel_ms is not None:
        for t, k in rows_k:
            kernel_ms[k] = kernel_ms.get(k, 0.0) + t
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
    the 480 path) and of its conv kernels (K3 and K4 in every form, K7;
    bf16, and fp32 in split TF32) on the tensor cores, the graphs' replays
    included; fails otherwise, or when the path launched no attention
    kernel."""
    att = [k for k in ATTENTION if launches.get(k)]
    convs = [k for k in DW + K3 if launches.get(k)]
    tcs = {k: tc[k] for k in att + convs}
    print(f"  tensor-core launches in the {name} path: {tcs}")
    if not att or any(tc[k] != launches[k] for k in att + convs):
        fail(f"{name} path: attention or conv launches off the tensor "
             f"cores: {tcs} of {launches}")


def run_path(torch, name, cfg, n_steps, kernels, need, same=False, **kw):
    """train_pair (with the SAME route if `same`) with every launch count
    set to 0 just before and read just after; fails on a non-finite loss or
    output, or when a kernel in `need` was launched no time inside the
    path's graphs, or off the tensor cores (check_tc_launches). Prints
    each chunk and the peak memory, the graphs' pools included. Returns
    (result, launches)."""
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
    output); the graphs against eager steps (phase 4b's gate, the spread
    over five eager runs); a profile of replays. Returns each path's
    launches and replayed ms."""
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
        # the spread of five eager runs, as phases 3 and 12 take it (C4):
        # one run's distance varied 0.086-0.364 over calls on vitb14_reg
        # and once fell below a quarter of the graphs' (C8)
        program = check_replay(torch, name, cfg, one_pair(cfg, pair, ext),
                               pair, spread_runs=5)
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
        # the spread of five eager runs, as phases 3, 9 and 12 take it (C4,
        # C8, C11): one eager pair's distance sets too narrow a tolerance
        # on a run where Adam amplifies the atomics' noise
        program = check_replay(
            torch, "config c", cfg,
            lambda: MultiPairTrainer(cfg, pairs, extractor,
                                     seeds=list(range(8))), pairs,
            spread_runs=5)
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
    calls and calls recorded while a graph is captured, and the recorded
    ones also by (wrapper, k, form) as conv_route names the form: the
    wrappers count calls, not k or forms, and the inversion's gates are on
    them. Yields the three Counters."""
    from collections import Counter
    import torch
    eager, captured, forms = Counter(), Counter(), Counter()
    fwd, dw = conv._launch_fwd, conv._launch_dw

    def tally(name, k, route):
        cap = torch.cuda.is_current_stream_capturing()
        (captured if cap else eager)[(name, k)] += 1
        if cap:
            forms[(name, k, route.form)] += 1

    def rec_fwd(x, w, *a, **kw):
        out_hw, stride = a[0], a[2]
        phase = kw.get("phase", a[8] if len(a) > 8 else False)
        tally(a[6] if len(a) > 6 else kw["name"], w.shape[0],
              conv.conv_route("fwd", x.dtype, w.shape[0], stride, w.shape[2],
                              w.shape[3], x.shape[0], *out_hw, phase=phase))
        return fwd(x, w, *a, **kw)

    def rec_dw(x, g, k, *a, **kw):
        stride = a[1]
        tally(a[5] if len(a) > 5 else kw["name"], k,
              conv.conv_route("dw", x.dtype, k, stride,
                              stride * stride * x.shape[1], g.shape[1],
                              g.shape[0], g.shape[2], g.shape[3],
                              gtap=kw.get("gtap", False)))
        return dw(x, g, k, *a, **kw)

    conv._launch_fwd, conv._launch_dw = rec_fwd, rec_dw
    try:
        yield eager, captured, forms
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


def profile_inversion(torch, program, n: int = 3, top: int = 0):
    """Kernel ms per replayed inversion step (torch.profiler over n
    replays): every device kernel, the port's own, its attention kernels',
    its K3 kernels' and its K4/K7 kernels'; with top, the `top` largest
    kernels by name printed (ms and launches a step)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rows = np.full((n, 1), 0.5, np.float32)
    program.run(rows, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        program.run(rows, False)
        torch.cuda.synchronize()
    total = ours = att = k3 = k4 = 0.0
    names = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += t
        names.append((t / n / 1e3, e.count / n, e.key))
        if any(k in e.key for k in OUR_KERNELS):
            ours += t
        att += t * ("attn_" in e.key)
        k3 += t * any(k in e.key for k in K3_KERNELS)
        k4 += t * ("conv_dw_" in e.key)
    for ms, count, key in sorted(names, reverse=True)[:top]:
        print(f"    {ms:.4f} ms, {count:.0f} launches a step: {key[:100]}")
    return tuple(v / n / 1e3 for v in (total, ours, att, k3, k4))


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
        with k_recorder(conv) as (eager, captured, forms):
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
            # K3 at the 7x7 and 5x5 sites and their phase kernels (k2 =
            # 4, 3) on the pixel-major form, the 3x3 scales on the
            # channel-major one; K4 on both (dw_px_form keeps conv_dw_tc
            # at the two Cout-16 sites whose grid busies the card)
            print(f"  chw_pallas: recorded launches by (wrapper, k, form) "
                  f"{dict(sorted(forms.items()))}")
            wide = {(w, k, f) for (w, k, f) in forms
                    if k >= 4 or (w.endswith("s2d") and k == 3)}
            k3_forms = {f for (w, _, f) in wide if w.startswith("conv_valid")}
            k4_forms = {f for (w, _, f) in wide if w.startswith("conv_dw")}
            if k3_forms != {"px"} or k4_forms != {"px", "tc"}:
                fail(f"chw + pallas: the 7x7/5x5 sites not on the forms "
                     f"conv_route's rule names: {dict(forms)}")
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
        print(f"  {label}: the largest kernels of a replayed step")
        dev_ms, our_ms, _, k3_ms, k4_ms = profile_inversion(torch, program,
                                                            top=16)
        print(f"  {label}: {1e3 / ms:.2f} iterations/s replayed ({ms:.3f} "
              f"ms a step, a chunk of {INV_LOG} with its one read), "
              f"{INV_ITERS / res['wall_time']:.2f} iterations/s sustained "
              f"over the run ({res['wall_time']:.2f} s: the first step "
              f"eager, the capture, {len(res['chunks'])} chunks, "
              f"{INV_ITERS // INV_LOG + 1} renders); kernels "
              f"{dev_ms:.3f} ms a step, the port's own {our_ms:.3f} ms "
              f"(K3 {k3_ms:.3f}, K4 {k4_ms:.3f}); "
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
    steps: K1/K2 launched inside the graph, on the tensor cores (the
    split-TF32 kernels). Prints the replayed step, its kernel
    ms and its attention kernels' ms (torch.profiler). Returns (launches,
    step ms, attention ms a step)."""
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
    dev_ms, _, att_ms, _, _ = profile_inversion(torch, res["program"], 2)
    att = {k: (launches[k], tc[k]) for k in ATTENTION}
    print(f"  final loss {res['loss']:.6f}; {1e3 / ms:.2f} iterations/s "
          f"replayed ({ms:.3f} ms a step, chunks of 2); kernels "
          f"{dev_ms:.3f} ms a step, the attention kernels {att_ms:.3f} ms; "
          f"attention launches (all, tensor-core) {att}")
    if not math.isfinite(res["loss"]):
        fail("fp32 inversion: non-finite loss")
    if any(n != t for n, t in att.values()):
        fail(f"fp32 inversion: attention launches off the tensor cores: "
             f"{att}")
    return launches, ms, att_ms


MAIN_FP32_STEPS = 6   # step 0 entire-A, step 1 eager, 2-5 replays
PALLAS_FP32_STEPS = 4
SAME_FP32_STEPS = 4
# (name, generator_conv, SAME route, steps, the wrappers each must launch
# in its graphs: phase 6's lists but main's)
FP32_PATHS = (("main_fp32", "auto", False, MAIN_FP32_STEPS,
               ("attn_qkv_fwd", "attn_qkv_bwd", "conv_valid", "conv_dw")),
              ("pallas_fp32", "pallas", False, PALLAS_FP32_STEPS,
               NEED["pallas"]),
              ("fused_same_fp32", "fused", True, SAME_FP32_STEPS,
               NEED["fused_same"]),
              ("pallas_same_fp32", "pallas", True, SAME_FP32_STEPS,
               NEED["pallas_same"]))


def run_fp32_path(torch, kernels, base, pair, name, mode, same, n_steps,
                  need):
    """main_fp32 (generator_conv auto: K3 and K4 at the two auto sites),
    pallas_fp32 (generator_conv pallas: every conv on K3/K4, the stride-2
    ones as k2 = 2 phase kernels, every site's forward, input gradient and
    dw), or with `same` fused_same_fp32 and pallas_same_fp32 (the SAME
    route: K3'' SAME, K3''' with its statistics, K7 at up_conv s0/s1): the
    main path's settings (cows, 896 canvas, 224 loss resolution,
    entire_A_every 10) with vit_compute_dtype and generator_compute_dtype
    float32, n_steps steps through train_pair's program: phase 4's gates,
    every K1/K2 launch and every conv launch on the tensor cores (split
    TF32); a profile of replays. Returns (launches, replayed step ms,
    attention ms a step, conv kernels' ms a step, K7's ms a step)."""
    from splice_tpu_torch.config import load_config
    cfg = load_config(None, dict(base, generator_conv=mode,
                                 vit_compute_dtype="float32",
                                 generator_compute_dtype="float32"))
    res, launches = run_path(torch, name, cfg, n_steps, kernels, need, same,
                             pair=pair)
    by_name = {}
    with same_border(same):
        ms = profile_steps(torch, res["program"], cfg, kernel_ms=by_name)
    att = sum(t for k, t in by_name.items() if "attn_" in k)
    conv_ms = sum(t for k, t in by_name.items()
                  if "conv_fwd" in k or "conv_dw_" in k)
    # fp32 K7: conv_dw_tf32's cotangent-tapped instances and the sum that
    # adds and transposes their partials (only K7 launches it in fp32)
    k7_ms = sum(t for k, t in by_name.items()
                if ("conv_dw_tf32_kernel<" in k and ", true>" in k)
                or "conv_dw_sum_kernel<true>" in k)
    print(f"  {name}: replayed regular step {ms:.2f} ms; per step the "
          f"fp32 attention kernels {att:.3f} ms, the fp32 conv kernels "
          f"{conv_ms:.3f} ms, of them K7 {k7_ms:.3f} ms")
    if same and not k7_ms:
        fail(f"{name}: the profile shows no K7 kernel")
    del res
    torch.cuda.empty_cache()
    return launches, ms, att, conv_ms, k7_ms


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


# P1 (the probe kernel) in phase 2: (m, k, n, reps). The reference probe's
# shapes at its 64 reps (K 64/128/256 resident; K 768 through the ring),
# then both routes at 1 and 2 reps, where a missing rep or a wrong chunk
# of the ring is a large share of the output and fails the tolerance
# (at 64 reps it is about 1/64), then the smallest edge case; each at
# every output tile that divides n
PROBE_SHAPES = ((768, 64, 768, 64), (768, 128, 768, 64),
                (768, 256, 768, 64), (768, 768, 64, 64),
                (768, 768, 128, 64), (768, 768, 64, 1), (768, 768, 128, 2),
                (768, 256, 768, 1), (64, 16, 64, 1), (64, 16, 128, 1))
PROBE_TIMED = (768, 128, 768, 64)    # the PERF.md row: t128 at n_tile 128


def check_probe(torch, probe, rows):
    """P1 (ops.probe.mma_repeat) against mma_repeat_plain at PROBE_SHAPES
    on seeded random bf16 inputs (ones would hide a layout error), at
    output tiles of 64 and 128 columns, each twice on one input bitwise;
    timed at PROBE_TIMED beside the plain version and the library's one
    call of the same function: torch.matmul of A repeated reps times
    along K by B repeated reps times along K (an fp32-accumulated sum of
    the reps products, rounded to bf16 once; the repeats are built before
    timing). torch.matmul of one product is timed too, under
    one_product_ms."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    rtol, why = RTOL["bfloat16"]
    for m, k, n, reps in PROBE_SHAPES:
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        b = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
        ref = probe.mma_repeat_plain(a, b, reps)
        route = "streamed" if k > probe.RESIDENT_K else "resident"
        for nt in probe.N_TILES:
            if n % nt:
                continue
            tag = (f"P1 mma_repeat [{m},{k}]x[{k},{n}] reps {reps} n_tile "
                   f"{nt} ({route})")
            got = probe.mma_repeat(a, b, reps, nt)
            err = compare(tag, got, ref, rtol, why)
            check_bitwise(torch, tag, (got,), (probe.mma_repeat(a, b, reps,
                                                                nt),))
            if (m, k, n, reps) == PROBE_TIMED and nt == 128:
                ar, br = a.repeat(1, reps), b.repeat(reps, 1)
                rows["mma_repeat"].update(timed(
                    lambda: probe.mma_repeat(a, b, reps, nt),
                    lambda: probe.mma_repeat_plain(a, b, reps),
                    lambda: torch.matmul(ar, br),
                    (m * k + k * n + m * n) * 2, 2.0 * m * n * k * reps,
                    "bfloat16", "P1", f"[{m},{k}]x[{k},{n}] reps {reps} "
                    f"n_tile {nt}"), max_abs_err=err,
                    library="torch.matmul(A.repeat(1, reps), "
                    "B.repeat(reps, 1))",
                    one_product_ms=time_ms(lambda: torch.matmul(a, b)))
                print(f"  torch.matmul of one product: "
                      f"{rows['mma_repeat']['one_product_ms']:.4f} ms")
                del ar, br
        del a, b, ref


def run_probe_tool(torch, probe):
    """P1's path: tools/mma_k_probe.py's experiments (the reference probe's
    shapes, reps and iterations), the launch count set to 0 just before and
    read just after. Prints its lines and its JSON."""
    from splice_tpu_torch.tools import mma_k_probe
    probe.mma_repeat.launches = 0
    res = mma_k_probe.run()
    n = probe.mma_repeat.launches
    mma_k_probe.report(res)
    print(f"  probe tool: {n} P1 launches; {json.dumps(res)}")
    if n == 0:
        fail("the probe tool launched no P1")
    return {"mma_repeat": n}


NOTEBOOK = "Splice_tpu_torch.ipynb"
NOTEBOOK_STEPS = 20      # phase 15 (a user runs 2000)
ACCEPT_STEPS = 100       # phase 16 (a user runs 2000)


def display_stand_in():
    """IPython.display where IPython is not installed: a module whose
    display records what it receives and whose clear_output does nothing
    (it stands in for the screen, not for the device)."""
    import types
    shown = []
    mod = types.ModuleType("IPython.display")
    mod.display = lambda *objs, **kw: shown.extend(objs)
    mod.clear_output = lambda wait=False: None
    pkg = types.ModuleType("IPython")
    pkg.display = mod
    sys.modules["IPython"], sys.modules["IPython.display"] = pkg, mod
    return shown


def run_notebook(torch):
    """Phase 15: the notebook's code cells in order in one namespace on a
    temporary copy of the cows pair (DATAROOT rewritten as
    tests/test_notebook.py rewrites it), N_STEPS = NOTEBOOK_STEPS and no
    OVERRIDES: full width on CUDA. Gates: every log boundary's frame
    reached show_result as a host uint8 [H, W, 3] that np.asarray took
    (the callback is wrapped to record it), output.png and
    structure_pca.png exist, the run was on CUDA."""
    import shutil
    import tempfile
    import numpy as np
    from splice_tpu_torch import trainer as trainer_mod
    try:
        import IPython.display  # noqa: F401
        shown = None
    except ImportError:
        shown = display_stand_in()
    with open(NOTEBOOK) as f:
        cells = json.load(f)["cells"]
    code = ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nb_")
    root = os.path.join(tmp, "cows")
    for sub in ("A", "B"):
        shutil.copytree(os.path.join(PAIR_ROOTS[0], sub),
                        os.path.join(root, sub))
    if "'datasets/splicing/cows'" not in code[1] or \
            "OVERRIDES = {}" not in code[2]:
        fail("the notebook's DATAROOT or OVERRIDES hook moved")
    code[1] = code[1].replace("'datasets/splicing/cows'", repr(root))
    code[2] = (f"VIT_WEIGHTS = None\nN_STEPS = {NOTEBOOK_STEPS}\n"
               f"OVERRIDES = {{}}\n")
    frames = []
    train_pair = trainer_mod.train_pair

    def recording(cfg, callback=None, **kw):
        def cb(out):
            frames.append((type(out).__name__, str(out.device), out.dtype,
                           tuple(out.shape)))
            callback(out)
        return train_pair(cfg, callback=cb, **kw)

    ns = {"__name__": "__main__"}
    t0 = time.perf_counter()
    trainer_mod.train_pair = recording
    try:
        for i, src in enumerate(code):
            t = time.perf_counter()
            exec(compile(src, f"{NOTEBOOK} code cell {i}", "exec"), ns)
            print(f"  code cell {i}: {time.perf_counter() - t:.1f} s")
    finally:
        trainer_mod.train_pair = train_pair
        wall = time.perf_counter() - t0
    out_png = os.path.join(root, "out", "output.png")
    pca_png = os.path.join(root, "out", "structure_pca.png")
    res = ns["result"]
    print(f"  the notebook on the card: {wall:.1f} s ({NOTEBOOK_STEPS} "
          f"steps, {res['steps_per_sec']:.3f} steps/s, device "
          f"{ns['cfg'].device}, {ns['cfg'].dino_model_name}); frames at the "
          f"callback: {frames}; "
          + ("IPython's display" if shown is None
             else f"stand-in display received {len(shown)} images"))
    n_bound = NOTEBOOK_STEPS // ns["cfg"].log_images_freq
    if (len(frames) != n_bound
            or any(f[:3] != ("Tensor", "cpu", torch.uint8) or len(f[3]) != 3
                   or f[3][2] != 3 for f in frames)):
        fail(f"notebook: show_result did not get {n_bound} host uint8 "
             f"[H, W, 3] frames: {frames}")
    last = np.asarray(res["output_u8"].cpu())
    if not (os.path.exists(out_png) and os.path.exists(pca_png)):
        fail(f"notebook: {out_png} or {pca_png} missing")
    if ns["cfg"].device != "cuda" or not res["trainer"].flat.is_cuda:
        fail("notebook: the run was not on CUDA")
    print(f"  output.png {np.asarray(ns['Image'].open(out_png)).shape}, "
          f"last frame {last.shape}, structure_pca.png "
          f"{np.asarray(ns['Image'].open(pca_png)).shape}")
    shutil.rmtree(tmp, ignore_errors=True)
    return wall


def run_accept(torch):
    """Phase 16: python -m splice_tpu_torch.tools.accept from a seeded
    dino_vitb8 state dict in DINO's key layout (.pth) and seeded LPIPS
    weights, on temporary copies of both pairs for ACCEPT_STEPS steps each
    at the defaults (full width, CUDA). Gates: exit 0, both pairs trained,
    no reference output and the artifact named; then score_pair of the
    cows output against itself on the card: PSNR inf, SSIM 1, LPIPS <=
    1e-6 and its verdict a pass. Prints each pair's train_wall_s."""
    import shutil
    import tempfile
    import numpy as np
    from splice_tpu_torch.tools import accept
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import golden_vit    # the tests' seeded DINO-layout state dict
    tmp = tempfile.mkdtemp(prefix="chip_smoke_accept_")
    ckpt = os.path.join(tmp, "dino_vitb8.pth")
    torch.save({k: torch.from_numpy(v) for k, v in golden_vit.make_state(
        seed=0, dim=768).items()}, ckpt)
    lp = os.path.join(tmp, "lpips.npz")
    np.savez(lp, **lpips_weights(3))
    root = os.path.join(tmp, "ds")
    for src in PAIR_ROOTS:
        for sub in ("A", "B"):
            shutil.copytree(os.path.join(src, sub), os.path.join(
                root, os.path.basename(src), sub))
    out = os.path.join(tmp, "accept_torch.json")
    cmd = [sys.executable, "-m", "splice_tpu_torch.tools.accept",
           "--checkpoint", ckpt, "--lpips_weights", lp, "--n_epochs",
           str(ACCEPT_STEPS), "--datasets_root", root, "--out", out,
           "--vit_npz", os.path.join(tmp, "vit.npz")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    print(f"  accept: exit {proc.returncode} in {wall:.1f} s; stdout tail: "
          f"{proc.stdout[-1500:]}")
    if proc.returncode != 0:
        fail(f"accept exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out) as f:
        report = json.load(f)
    pairs = report["pairs"]
    if (sorted(pairs) != sorted(accept.PAIRS) or report["pass"] is not None
            or any(not e.get("trained") or e.get("ref_available") is not False
                   or "ref/output.png" not in e.get("blocking_artifact", "")
                   for e in pairs.values())):
        fail(f"accept: unexpected report {report}")
    for name, e in pairs.items():
        print(f"  {name}: train_wall_s {e['train_wall_s']} ({ACCEPT_STEPS} "
              f"steps in a process of its own, start and captures "
              f"included)")
    cows = pairs["cows"]["output"]
    same = accept.score_pair(cows, cows, lp, "cuda")
    print(f"  score_pair(cows output, itself, LPIPS on cuda): {same}")
    if not (same["psnr"] == float("inf") and same["ssim"] == 1.0
            and same["lpips"] <= 1e-6 and same["lpips_pass"] is True):
        fail(f"score_pair of an image against itself: {same}")
    shutil.rmtree(tmp, ignore_errors=True)
    return wall, {n: e["train_wall_s"] for n, e in pairs.items()}


def kernel_table(attn, conv, probe):
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
        "mma_repeat": (probe.mma_repeat, "cuda",
                       "splice_tpu_torch/csrc/probe.cu",
                       "scripts/mxu_k_probe.py:24", "probe_tool"),
    }


def mesh_across_cards(torch, attn, conv, probe, n: int) -> None:
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
    kernels = kernel_table(attn, conv, probe)
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


def fp32_attention(torch, attn):
    """The split-TF32 fp32 K1/K2 at FP32_QKV and K5/K6 at FP32_SPLIT
    against their plain fp32 versions (torch.backends.cuda.matmul.
    allow_tf32 = False: the einsums in full fp32), bitwise run to run,
    timed beside SDPA in fp32. Returns {(kernel, shape): row}."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("matmul TF32 is on: the fp32 plain versions would round")
    print("  fp32 attention (matmul.allow_tf32 = False for the plain "
          "versions and SDPA)")
    rows = check_qkv_shapes(torch, attn, FP32_QKV, "float32")
    rows.update(check_split_shapes(torch, attn, FP32_SPLIT, "float32"))
    torch.cuda.empty_cache()
    return rows


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
    from splice_tpu_torch.ops import probe
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
    check_tensor_cores(_build, wide_instances(torch, attn), conv.WG_NS)
    if cards:
        mesh_across_cards(torch, attn, conv, probe, cards)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    kernels = kernel_table(attn, conv, probe)
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
    inv_qkv = check_qkv_shapes(torch, attn, INVERSION_QKV)
    fp32_rows = fp32_attention(torch, attn)
    torch.cuda.empty_cache()
    print("  K5/K6 at head widths above 64 (their wide passes)")
    wide_rows = check_wide_split(torch, attn)
    torch.cuda.empty_cache()
    inv_rows = check_conv_inversion(torch, conv)
    for (name, k), r in sorted(inv_rows.items()):
        print(f"  inversion {name} k={k} {r['shape']}: kernel {r['ms']:.4f}"
              f" ms ({r['form']} form), plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    check_conv_any_k(torch, conv)
    launches = {"generator_9x9": {
        "conv_dw_gtap": check_generator_9x9(torch, conv)}}
    check_attention_dh(torch, attn)
    check_conv_same(torch, conv, rows)
    gtap_rows, k4_rows = check_gtap_wide_k(torch, conv)
    conv32_rows = check_conv_fp32(torch, conv)
    check_same_edge_cases(torch, conv)
    for dtype_name in ("bfloat16", "float32"):
        check_dw_tc_edge_cases(torch, conv, dtype_name)
        check_k3_tc_edge_cases(torch, conv, dtype_name)
    check_probe(torch, probe, rows)
    torch.cuda.empty_cache()
    for name, r in rows.items():
        b, by = bound_ms(r["nbytes"], r["flops"], r["dtype"])
        r.update(bound_ms=b, bound_by=by)
        print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {b:.4f} ms ({by})")
        if name in DW + K3:
            print_beside_previous(name, r)

    print("  P1's path: the probe tool (tools/mma_k_probe.py)")
    launches["probe_tool"] = run_probe_tool(torch, probe)

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
    launches["main"] = main_launches
    secs = res["step_seconds"]
    print(f"  replays alone: entire-A step 10 {secs[10] * 1e3:.1f} ms, "
          f"regular step 11 {secs[11] * 1e3:.1f} ms (phase 5 times a "
          f"chunk of regular replays)")
    shared = dict(pair=res["trainer"].pair, extractor=res["trainer"].extractor)

    mark(t_start)
    print("phase 4b: graphs against eager at full width (bf16, main path), "
          "and a chunk without synchronisation")
    # the spread of five eager runs, as phases 3, 9 and 12 take it (C4, C8):
    # against one eager pair's spread (5.6e-3) the graphs lay 3.03e-2 from
    # eager in one call while each step replayed from eager's state was 0.0
    # apart (C11)
    program = check_replay(torch, "full width", cfg,
                           one_pair(cfg, shared["pair"],
                                    shared["extractor"]), shared["pair"],
                           spread_runs=5)
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

    turns = [("auto", main_trainer, cfg, False, True)]
    for i, (path, mode, res_px, n, same) in enumerate(PATHS):
        print(f"phase 6.{i + 1}: the {path} path (generator_conv={mode}"
              f"{', SAME route' if same else ''}, {res_px}-px loss "
              f"resolution), {n} steps")
        pcfg = load_config(None, dict(base, generator_conv=mode,
                                      dino_global_patch_size=res_px))
        pres, launches[path] = run_path(torch, path, pcfg, n, kernels,
                                        NEED[path], same, **shared)
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
                NEED["fused_same_skip3"])
            torch.cuda.empty_cache()

    mark(t_start)
    print(f"phase 6c: the wide-head ViT (ViT-B/8's width as "
          f"{VIT_WIDE['num_heads']} heads of 128, seeded), taps of layer 11 "
          f"and the image gradient at the 480 and 224 shapes, bf16 and fp32, "
          f"on K5/K6 against SDPA")
    for dtype_name, n in run_vit_wide(torch, attn).items():
        launches[f"vit_wide_{dtype_name}"] = n
    torch.cuda.empty_cache()
    mark(t_start)
    print("phase 6d: the 9x9 generator at full width (bf16, SAME route, "
          "pallas): K7 at k = 9 against K4")
    k7_full, k4_full = check_generator_9x9_full(torch, conv)
    launches["generator_9x9_full"] = {"conv_dw_gtap": k7_full}
    launches["generator_9x9_full_k4"] = {"conv_dw": k4_full}
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
    print("  fp32 (compute_dtype float32, nhwc), 3 steps: K1/K2 split TF32 "
          "at the inversion shape")
    launches["inversion_fp32"], inv32_ms, inv32_att = run_inversion_fp32(
        torch, kernels)
    fp32_ms = {}
    for name, mode, same, n, need32 in FP32_PATHS:
        mark(t_start)
        print(f"phase 12b: {name} (main with generator_conv={mode}"
              f"{', SAME route' if same else ''}, vit_compute_dtype and "
              f"generator_compute_dtype float32), {n} steps")
        launches[name], *fp32_ms[name] = run_fp32_path(
            torch, kernels, base, shared["pair"], name, mode, same, n,
            need32)
    print("  fp32 steps: " + ", ".join(
        f"{name} {ms:.2f} ms replayed ({att:.3f} ms of attention, "
        f"{cms:.3f} ms of conv kernels, {k7:.3f} ms of K7)"
        for name, (ms, att, cms, k7) in fp32_ms.items())
        + f", inversion_fp32 {inv32_ms:.3f} ms ({inv32_att:.3f} ms of "
        f"attention)")
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
    del shared
    torch.cuda.empty_cache()
    mark(t_start)
    print(f"phase 15: the notebook ({NOTEBOOK}) on the card, "
          f"{NOTEBOOK_STEPS} steps at full width")
    nb_wall = run_notebook(torch)
    torch.cuda.empty_cache()
    mark(t_start)
    print(f"phase 16: the acceptance run (python -m "
          f"splice_tpu_torch.tools.accept), both pairs, {ACCEPT_STEPS} steps "
          f"each")
    acc_wall, acc_pairs = run_accept(torch)
    print(f"  walls: notebook {nb_wall:.1f} s, acceptance {acc_wall:.1f} s "
          f"(pairs {acc_pairs})")

    line = []
    for name, (fn, route, source, replaces, path) in kernels.items():
        r = rows[name]
        line.append({"name": name, "route": route, "source": source,
                     "cores": "tensor core",
                     "replaces": replaces, "launches": launches[path][name],
                     "path": path, "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"],
                     **{key: r[key] for key in ("library", "one_product_ms")
                        if key in r}})
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
                     "form": r["form"],
                     "launches": r["launches"],
                     "path": "inversion_chw_pallas",
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    extra = [(kid, r, "inversion_nhwc", "tensor core")
             for (kid, _), r in inv_qkv.items()]
    for (kid, tag), r in fp32_rows.items():
        path = ("inversion_fp32" if "[1,981," in tag else
                "main_fp32" if kid in ("K1", "K2") else "none (phase 2)")
        extra.append((kid, r, path, "tensor core (split TF32)"))
    for (k, dt, site), r in gtap_rows.items():
        fp32 = dt == "float32"
        # 6d's K7 runs at up_conv s0-s2
        full = k == 9 and site in ("up_conv s0", "up_conv s1", "up_conv s2")
        path = ("pallas_same_fp32" if fp32 and k == 3 else
                "generator_9x9" if fp32 and k == 9 else
                "generator_9x9_full" if full else "none (phase 2)")
        extra.append(("K7", dict(r, k=k), path,
                      "tensor core (split TF32)" if fp32 else "tensor core"))
    for (k, site), r in k4_rows.items():
        # K4 at up_conv s0-s4 (all on conv_dw_wg) with DW_TAP_ON_N off (6d)
        extra.append(("K4", dict(r, k=k), "generator_9x9_full_k4" if k == 9
                      else "none (phase 2)", "tensor core"))
    for (kid, tag), r in wide_rows.items():
        fp32 = "float32" in tag
        dtype_name = "float32" if fp32 else "bfloat16"
        # phase 6c's crops: 3601 tokens in heads of 128, no key mask
        path = (f"vit_wide_{dtype_name}"
                if tag == f"[2,6,3601,128] {dtype_name}" else "none (phase 2)")
        extra.append((kid, r, path,
                      "tensor core (split TF32)" if fp32 else "tensor core"))
    for (name, site), r in conv32_rows.items():
        extra.append(({"conv_valid": "K3", "conv_valid_dx": "K3",
                       "conv_dw": "K4"}[name], r, "main_fp32",
                      "tensor core (split TF32)"))
    ids = {"K1": "attn_qkv_fwd", "K2": "attn_qkv_bwd", "K5": "attn_fwd",
           "K6": "attn_bwd", "K3": "conv_valid", "K4": "conv_dw",
           "K7": "conv_dw_gtap"}
    for kid, r, path, cores in extra:
        name = ids[kid]
        fn, route, source, replaces, _ = kernels[name]
        b, by = bound_ms(r["nbytes"], r["flops"], r["dtype"])
        line.append({"name": name, "route": route, "source": source,
                     "cores": cores, "replaces": replaces,
                     "launches": launches.get(path, {}).get(name, 0),
                     "path": path, "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": b, "bound_by": by,
                     "library_ms": r["library_ms"], "shape": r["shape"],
                     **{key: r[key] for key in ("k", "form") if key in r}})
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
