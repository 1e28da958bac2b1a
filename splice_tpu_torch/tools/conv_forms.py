"""bf16 K3 and K4 at the inversion net's sites, or fp32 K3 and K4 at
main_fp32's sites, timed for one checkout.

    python splice_tpu_torch/tools/conv_forms.py [--tree DIR] [--out FILE]
        [--step] [--fp32] [--same] [--dw9]

Imports splice_tpu_torch from DIR (default: the checkout this file is in),
builds its conv library, and at each of the inversion net's sites on limes
at 224 x 281 (INV_SITES: the 7x7 and 5x5 VALID convs at stride 1 and their
stride-2 phase kernels k2 = 4 and 3; chip_smoke.py, tools/px_ablation.py
and the tests read this table) times the bf16 K3 forward, the K3 input
gradient (the flipped kernel over the cotangent, as ConvValidPro.backward
runs it) and the K4 weight gradient, beside one PyTorch call each
(F.conv2d, conv2d_input, conv2d_weight). Each time is the median of 5
batches of 10 back-to-back calls (tools/mma_k_probe.device_ms: CUDA
events, L2-warm, the stream held by a device sleep until the host has
queued the batch). With --step it also times the inversion's chw + pallas
step (tools.inversion.invert on limes, bf16, generator_layout chw,
generator_conv pallas, STEP_ITERS steps): the median of 5 host-timed
replays of a chunk of STEP_LOG steps, and the device ms a step of every
kernel, of K3's and of K4's (torch.profiler over 3 replayed steps). It
uses only s2d_kernel, conv_valid_cuda, conv_valid_s2d_cuda, conv_dw_cuda,
conv_dw_s2d_cuda, device_ms and invert, which every version of the port
that runs the inversion net has, so that two commits can be timed in
turns in one call: unpack the other by `git archive` into a git-ignored
directory (`_proof/parent`) and run this file with `--tree` for each, in
turns. Prints one JSON line ({"tree", "card", "sites": {name: {"k3",
"dx", "dw", "k3_lib", "dx_lib", "dw_lib"}}, and with --step "step": {"ms",
"kernels_ms", "k3_ms", "k4_ms"}}, ms), appended to FILE if given.

With --fp32 it times fp32 K3, its input gradient and K4 instead, at
main_fp32's two auto sites (FP32_SITES: [2, Cin, S, S] -> Cout, k = 3,
an implicit 1-pixel border), beside F.conv2d, conv2d_input and
conv2d_weight with cuDNN's and matmul's TF32 off (fp32 products, as the
port's fp32 kernels compute them), and fp32 K7 (conv_dw_gtap_cuda, the
SAME border) at k = 3 at both sites ("k7") and at k = 5 and 7 at up_conv
s0 ("k7_5", "k7_7", beside "dw5_lib", "dw7_lib"); with --step also
main_fp32's replayed regular step (train_pair on the cows pair at its
defaults with vit_compute_dtype and generator_compute_dtype float32,
FP32_STEP_ITERS steps, then 5 host-timed chunks of as many replays as its
program holds and a profile of 3) and its K3, K4 and K7 device ms; with
--same that step is pallas_same_fp32's (generator_conv pallas with
ops.conv.SAME_BORDER_KERNELS on: K3'' SAME and K7 at up_conv s0/s1). It
uses only conv_valid_cuda, conv_dw_cuda and conv_dw_gtap_cuda, which every
version of the port has, so the parent of a redesigned fp32 kernel and a
later tree can be timed in turns the same way. The JSON line then holds
"fp32": true (and "same": true).

With --dw9 it times bf16 at the generator's up_conv sites with
filter_size_up 9 and 11 (DW9_SITES: [2, Cin, S, S] -> Cout, the SAME
border): K7 (conv_dw_gtap_cuda, "k7_9"), K4 (conv_dw_cuda, "k4_9") and
conv2d_weight ("dw_lib_9"), and K3 (conv_valid_cuda, "k3_9"), its input
gradient ("dx_9") beside F.conv2d and conv2d_input ("k3_lib_9",
"dx_lib_9"), and likewise at k = 11. It uses only those wrappers, which
every version of the port since K7 took k = 9 and 11 has, so that the
parent and a later tree can be timed in turns. Where the imported tree has
conv_dw_wg (ops.conv.dw_wg_tiling) it also times the weight gradient on
each bf16 form the route chooses between, forced: conv_dw_px in each
kernel's order ("k7_px_9", "k4_px_9") and conv_dw_wg in each order
("k7_wg_9": the cotangent tapped, "k4_wg_9": V tapped), which
ops.conv.dw_wg_form's thresholds and dw_wg_cost's fit read. The JSON line
then holds "dw9": true.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

# The inversion net's K3/K4 sites on limes at resize 224 (224 x 281;
# generator_layout chw, generator_conv pallas): (name, Cin, Cout, H, W of
# the reflection-padded input, k, stride). Reflection padding is a copy
# outside the kernels, so every site is a VALID conv: stride 1 at k = 7
# and 5, stride 2 as the phase image's k2 = 4 and 3.
INV_SITES = (("up_conv s0", 36, 16, 230, 287, 7, 1),
             ("down_conv2 s0", 16, 16, 118, 147, 7, 1),
             ("up_conv s2", 132, 64, 60, 75, 5, 1),
             ("down_conv2 s2", 64, 64, 32, 40, 5, 1),
             ("down_conv1 s0", 32, 16, 230, 287, 7, 2),
             ("down_conv1 s1", 16, 32, 118, 147, 7, 2),
             ("down_conv1 s2", 32, 64, 60, 75, 5, 2),
             ("down_conv1 s3", 64, 128, 32, 40, 5, 2))
STEP_ITERS, STEP_LOG = 21, 20
LIMES = "datasets/feature_visualization/limes.jpeg"
# K3's kernels (forward and input gradient; chip_smoke.K3_KERNELS), and
# conv_fwd_kernel, the CUDA-core fp32 K3 of trees before the split-TF32
# kernels
K3_KERNELS = ("conv_fwd_tf32", "conv_fwd_kernel", "conv_fwd_tc",
              "conv_fwd_px", "conv_split_sum", "conv_stats_")
# main_fp32's K3/K4 sites (generator_conv auto on the 896 canvas, B = 2,
# k = 3, border 1), which are also the SAME route's K7 sites: (name, Cin,
# Cout, S)
FP32_SITES = (("up_conv s0", 36, 16, 896), ("up_conv s1", 68, 32, 448))
# profiler keys of fp32 K7's kernels: the split-TF32 gtap instances and
# their transposing sum, or the CUDA-core kernels of trees before them
K7_KERNELS = ("conv_dw_gtap_kernel", "conv_dw_reduce_kernel",
              "conv_dw_sum_kernel<true>")
# entire A at 0 and 10 (entire_A_every 10): the program holds chunks of 9
FP32_STEP_ITERS = 11
COWS = "datasets/splicing/cows"
# The generator's up convs (SkipConfig's default widths on the 896 canvas,
# B = 2): (name, Cin, Cout, S); K7 at s0-s2 and K4 at s3-s4 where
# filter_size_up is 9 or 11 (chip_smoke phase 6d)
DW9_SITES = (("up_conv s0", 36, 16, 896), ("up_conv s1", 68, 32, 448),
             ("up_conv s2", 132, 64, 224), ("up_conv s3", 132, 128, 112),
             ("up_conv s4", 132, 128, 56))


def profile_ms(torch, run, n: int) -> dict:
    """Device ms per step of every kernel, of K3's, of the weight
    gradients' (conv_dw_*: K4 and K7) and of K7's alone over `run` (n
    steps), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    total = k3 = k4 = k7 = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "device_time_total", 0) / (n * 1e3)
        total += t
        k3 += t * any(k in e.key for k in K3_KERNELS)
        k4 += t * ("conv_dw_" in e.key)
        k7 += t * (any(k in e.key for k in K7_KERNELS)
                   or ("conv_dw_tf32_kernel<" in e.key
                       and ", true>" in e.key))
    return {"kernels_ms": total, "k3_ms": k3, "k4_ms": k4, "k7_ms": k7}


def time_step(torch, tree: pathlib.Path) -> dict:
    """The inversion's chw + pallas step of the imported tree: host ms of
    a replayed step (the median over 5 chunks of STEP_LOG) and device ms a
    step of all kernels, of K3's and of K4's (conv_dw_*)."""
    import tempfile
    import numpy as np
    from splice_tpu_torch.tools import inversion
    tmp = tempfile.mkdtemp(prefix="conv_forms_")
    res = inversion.invert(str(tree / LIMES), f"{tmp}/inv.png",
                           n_iter=STEP_ITERS, log_freq=STEP_LOG,
                           generator_layout="chw", generator_conv="pallas")
    program = res["program"]
    rows = np.full((STEP_LOG, 1), 0.5, np.float32)
    program.run(rows[:1], False)
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        program.run(rows, False)
        host.append((time.perf_counter() - t0) / STEP_LOG * 1e3)
    prof = profile_ms(torch, lambda: program.run(rows[:3], False), 3)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"ms": statistics.median(host), **prof}


def time_fp32_step(torch, tree: pathlib.Path, same: bool = False) -> dict:
    """main_fp32's regular step for the imported tree (with `same`
    pallas_same_fp32's: generator_conv pallas, the SAME route on):
    train_pair on the cows pair (seed 0, entire_A_every 10, fp32 ViT and
    generator), then host ms of a replayed step (the median over 5 chunks
    as long as the program holds) and device ms a step of all kernels, of
    K3's, of the weight gradients' and of K7's (3 replays)."""
    import numpy as np
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.ops import conv
    from splice_tpu_torch.trainer import (lambdas_vec, pack_row,
                                          sample_step_draws, train_pair)
    cfg = load_config(None, dict(
        dataroot=str(tree / COWS), seed=0, entire_A_every=10,
        log_images_freq=1000, vit_compute_dtype="float32",
        generator_compute_dtype="float32",
        **({"generator_conv": "pallas"} if same else {})))
    conv.SAME_BORDER_KERNELS = same
    res = train_pair(cfg, n_steps=FP32_STEP_ITERS)
    program, pair = res["program"], res["trainer"].pair
    gen = torch.Generator().manual_seed(1)
    n = program.rows.shape[0]
    rows = np.stack([pack_row(lambdas_vec(cfg, 5), cfg.lr,
                              sample_step_draws(cfg, pair, gen))
                     for _ in range(n)])
    program.run(rows[:1], False)
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        program.run(rows, False)
        host.append((time.perf_counter() - t0) / n * 1e3)
    prof = profile_ms(torch, lambda: program.run(rows[:3], False), 3)
    return {"ms": statistics.median(host), **prof}


def fp32_calls(torch, conv, cin, cout, S, gen) -> dict:
    """fp32 K3, its input gradient and K4 at one of FP32_SITES, and the
    library call of each: {key: call}."""
    import torch.nn.functional as F
    x = torch.randn(2, cin, S, S, generator=gen).cuda()
    w = (0.1 * torch.randn(3, 3, cin, cout, generator=gen)).cuda()
    g = torch.randn(2, cout, S, S, generator=gen).cuda()
    wf = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
    woi = w.permute(3, 2, 0, 1).contiguous()
    return {"k3": lambda: conv.conv_valid_cuda(x, w, 1),
            "dx": lambda: conv.conv_valid_cuda(g, wf, 1),
            "dw": lambda: conv.conv_dw_cuda(x, g, 3, 1),
            "k3_lib": lambda: F.conv2d(x, woi, padding=1),
            "dx_lib": lambda: torch.nn.grad.conv2d_input(x.shape, woi, g,
                                                         padding=1),
            "dw_lib": lambda: torch.nn.grad.conv2d_weight(x, woi.shape, g,
                                                          padding=1),
            "k7": lambda: conv.conv_dw_gtap_cuda(x, g, 3, None, None, 1.0,
                                                 1)}


def k7_calls(torch, conv, cin, cout, S, gen) -> dict:
    """fp32 K7 at k = 5 and 7 (the SAME border) at one of FP32_SITES, and
    conv2d_weight at each: {key: call}."""
    x = torch.randn(2, cin, S, S, generator=gen).cuda()
    g = torch.randn(2, cout, S, S, generator=gen).cuda()
    out = {}
    for k in (5, 7):
        p = (k - 1) // 2
        out[f"k7_{k}"] = (lambda k=k, p=p: conv.conv_dw_gtap_cuda(
            x, g, k, None, None, 1.0, p))
        out[f"dw{k}_lib"] = (lambda k=k, p=p: torch.nn.grad.conv2d_weight(
            x, (cout, cin, k, k), g, padding=p))
    return out


def dw9_calls(torch, conv, cin, cout, S, k, gen) -> dict:
    """bf16 K7, K4, K3 and K3's input gradient at one of DW9_SITES with a
    k x k filter (the SAME border), each beside its library call, and where
    the tree has conv_dw_wg each weight gradient on the px and wg forms,
    forced: {key: call}."""
    import torch.nn.functional as F
    pad = (k - 1) // 2
    bf = torch.bfloat16
    x = torch.randn(2, cin, S, S, generator=gen).to("cuda", bf)
    g = torch.randn(2, cout, S, S, generator=gen).to("cuda", bf)
    w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to("cuda", bf)
    wf = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
    woi = w.permute(3, 2, 0, 1).contiguous()
    out = {f"k7_{k}": lambda: conv.conv_dw_gtap_cuda(x, g, k, None, None,
                                                     1.0, pad),
           f"k4_{k}": lambda: conv.conv_dw_cuda(x, g, k, pad),
           f"dw_lib_{k}": lambda: torch.nn.grad.conv2d_weight(
               x, woi.shape, g, padding=pad),
           f"k3_{k}": lambda: conv.conv_valid_cuda(x, w, pad),
           f"k3_lib_{k}": lambda: F.conv2d(x, woi, padding=pad),
           f"dx_{k}": lambda: conv.conv_valid_cuda(g, wf, k - 1 - pad),
           f"dx_lib_{k}": lambda: torch.nn.grad.conv2d_input(
               x.shape, woi, g, padding=pad)}
    if hasattr(conv, "dw_wg_tiling"):
        sp = S + k - 1
        forms = {
            "k7_px": (conv._launch_dw_px, True, conv.dw_px_gtap_tiling(
                k, cout, cin, 2, sp, sp)),
            "k7_wg": (conv._launch_dw_wg, True, conv.dw_wg_tiling(
                k, cout, cin, 2, sp, sp, -pad % 8, gtap=True)),
            "k4_px": (conv._launch_dw_px, False, conv.dw_px_tiling(
                k, cin, cout, 2, S, S)),
            "k4_wg": (conv._launch_dw_wg, False, conv.dw_wg_tiling(
                k, cin, cout, 2, S, S))}
        for key, (launch, gtap, t) in forms.items():
            out[f"{key}_{k}"] = (
                lambda launch=launch, gtap=gtap, t=t, key=key: launch(
                    x, g, k, pad, 1, None, None, 1.0, gtap, t, key))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = pathlib.Path(__file__).resolve().parents[2]
    ap.add_argument("--tree", default=str(here))
    ap.add_argument("--out", default=None)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--same", action="store_true")
    ap.add_argument("--dw9", action="store_true")
    args = ap.parse_args(argv)
    if args.same and not args.fp32:
        raise SystemExit("--same times pallas_same_fp32: it needs --fp32")
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    import torch.nn.functional as F
    from splice_tpu_torch.ops import _build, conv
    from splice_tpu_torch.tools.mma_k_probe import device_ms
    if not str(pathlib.Path(conv.__file__).resolve()).startswith(str(tree)):
        raise SystemExit(f"imported {conv.__file__}, not from {tree}")
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    phase = "phase" in inspect.signature(conv.conv_valid_cuda).parameters
    gen = torch.Generator().manual_seed(12)
    sites = {}
    if args.fp32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for name, cin, cout, H, W, k, stride in (() if args.fp32 or args.dw9
                                             else INV_SITES):
        ho, wo = (H - k) // stride + 1, (W - k) // stride + 1
        x = torch.randn(1, cin, H, W, generator=gen).to("cuda", torch.bfloat16)
        w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to(
            "cuda", torch.bfloat16)
        g = torch.randn(1, cout, ho, wo, generator=gen).to("cuda",
                                                            torch.bfloat16)
        wk = conv.s2d_kernel(w).contiguous() if stride == 2 else w
        kk = wk.shape[0]
        wf = torch.flip(wk, dims=(0, 1)).transpose(2, 3).contiguous()
        woi = w.permute(3, 2, 0, 1).contiguous()
        kw = {"phase": stride == 2} if phase else {}
        calls = {
            "k3": (lambda: conv.conv_valid_s2d_cuda(x, wk, 0, (ho, wo))
                   if stride == 2 else conv.conv_valid_cuda(x, wk)),
            "dx": lambda: conv.conv_valid_cuda(g, wf, kk - 1, **kw),
            "dw": (lambda: conv.conv_dw_s2d_cuda(x, g, kk, 0)
                   if stride == 2 else conv.conv_dw_cuda(x, g, kk)),
            "k3_lib": lambda: F.conv2d(x, woi, stride=stride),
            "dx_lib": lambda: torch.nn.grad.conv2d_input(
                x.shape, woi, g, stride=stride),
            "dw_lib": lambda: torch.nn.grad.conv2d_weight(
                x, woi.shape, g, stride=stride)}
        sites[name] = {}
        for key, fn in calls.items():
            fn()
            sites[name][key] = statistics.median(
                device_ms(fn, 10) for _ in range(5))
        print(f"  {name}: " + ", ".join(f"{key} {v:.4f}" for key, v
                                        in sites[name].items()),
              file=sys.stderr)
    for name, cin, cout, S in (FP32_SITES if args.fp32 else ()):
        sites[name] = {}
        calls = fp32_calls(torch, conv, cin, cout, S, gen)
        if name == FP32_SITES[0][0]:
            calls.update(k7_calls(torch, conv, cin, cout, S, gen))
        for key, fn in calls.items():
            fn()
            sites[name][key] = statistics.median(
                device_ms(fn, 10) for _ in range(5))
        print(f"  {name} fp32: " + ", ".join(
            f"{key} {v:.4f}" for key, v in sites[name].items()),
              file=sys.stderr)
        torch.cuda.empty_cache()
    for name, cin, cout, S in (DW9_SITES if args.dw9 else ()):
        sites[name] = {}
        for k in (9, 11):
            for key, fn in dw9_calls(torch, conv, cin, cout, S, k,
                                     gen).items():
                fn()
                sites[name][key] = statistics.median(
                    device_ms(fn, 10) for _ in range(5))
            torch.cuda.empty_cache()
        print(f"  {name} bf16: " + ", ".join(
            f"{key} {v:.4f}" for key, v in sites[name].items()),
              file=sys.stderr)
    result = {"tree": str(tree), "card": card, "sites": sites}
    if args.dw9:
        result["dw9"] = True
    if args.fp32:
        result["fp32"] = True
    if args.same:
        result["same"] = True
    if args.step:
        result["step"] = (time_fp32_step(torch, tree, args.same)
                          if args.fp32 else time_step(torch, tree))
        print(f"  step: {result['step']}", file=sys.stderr)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
