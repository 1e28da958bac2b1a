#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (splice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the hand-written CUDA kernels from splice_tpu_torch/csrc;
  2. hold every kernel against its plain PyTorch version at the shapes the
     training step gives it (and at small edge-case shapes), and time
     kernel, plain version and a PyTorch library call that computes the
     same function (the yardstick only);
  3. run one regular and one entire-A step at a small size on the card
     (fp32, through the kernels) and on the CPU (plain path) from the same
     parameters and draws, and compare loss and gradient;
  4. the main path: train_pair on the cows pair at full width (896 canvas,
     dino_vitb8 with seeded random weights, 224 loss resolution, bf16) for
     12 steps including entire-A steps; every loss finite, every kernel
     launched;
  5. where the time goes: torch.profiler over three more regular steps.
Prints the kernels' numbers as one JSON line, the card's name and power
limit, and last {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
MAIN_STEPS = 12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `iters` back-to-back
    calls, by CUDA events. The plain versions launch many small kernels,
    so a single batch is at the mercy of the shared host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
            if (B, N, dtype_name) != (2, 785, "bfloat16"):
                continue
            isz = qkv.element_size()
            q, k, v = [t.contiguous() for t in attn._split_heads(qkv, H)]
            gh = g.reshape(B, N, H, dh).permute(0, 2, 1, 3).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            fwd = dict(
                ms=time_ms(lambda: attn.attn_qkv_fwd_cuda(qkv, H, scale)),
                plain_ms=time_ms(
                    lambda: attn.attention_qkv_plain(qkv, H, scale)),
                library_ms=time_ms(lambda: sdpa(q, k, v, scale=scale)),
                nbytes=4 * B * N * D * isz, flops=4 * B * H * N * N * dh)
            qr, kr, vr = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = sdpa(qr, kr, vr, scale=scale)
            bwd = dict(
                ms=time_ms(lambda: attn.attn_qkv_bwd_cuda(qkv, g, H, scale)),
                plain_ms=time_ms(
                    lambda: attn.attention_qkv_bwd_plain(qkv, g, H, scale)),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    o, (qr, kr, vr), gh, retain_graph=True)),
                nbytes=7 * B * N * D * isz, flops=10 * B * H * N * N * dh)
            main["attn_qkv_fwd"] = dict(fwd, shape=tag, dtype=dtype_name)
            main["attn_qkv_bwd"] = dict(bwd, shape=tag, dtype=dtype_name)
    for name in errs:
        rows[name].update(main[name], max_abs_err=errs[name])


def check_conv(torch, conv, rows):
    F = torch.nn.functional
    dt, dtype_name = torch.bfloat16, "bfloat16"
    rtol, why = RTOL[dtype_name]
    gen = torch.Generator().manual_seed(2)
    errs = {"conv_valid": 0.0, "conv_dw": 0.0}
    for site, (cin, cout, hw) in enumerate(((36, 16, 896), (68, 32, 448))):
        B, k = 2, 3
        xp = torch.randn(B, cin, hw + 2, hw + 2, generator=gen).to("cuda", dt)
        w = (0.1 * torch.randn(k, k, cin, cout, generator=gen)).to("cuda", dt)
        g = torch.randn(B, cout, hw, hw, generator=gen).to("cuda", dt)
        w_flip = torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()
        tag = f"site {site} [{B},{cin},{hw + 2},{hw + 2}]->[{B},{cout},{hw},{hw}]"
        errs["conv_valid"] = max(errs["conv_valid"], compare(
            f"K3 conv_valid fwd {tag}", conv.conv_valid_cuda(xp, w),
            conv.conv_valid_plain(xp, w), rtol, why))
        errs["conv_valid"] = max(errs["conv_valid"], compare(
            f"K3 conv_valid dx {tag}", conv.conv_valid_cuda(g, w_flip, 2),
            conv.conv_valid_plain(g, w_flip, 2), rtol, why))
        errs["conv_dw"] = max(errs["conv_dw"], compare(
            f"K4 conv_dw {tag}", conv.conv_dw_cuda(xp, g, k),
            conv.conv_dw_plain(xp, g, k), RTOL["float32"][0],
            "fp32 output; fp32 sums over 10^5-10^6 pixels in another order"))
        isz = xp.element_size()
        flops = 2 * B * hw * hw * cout * cin * k * k
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        wf_oihw = w_flip.permute(3, 2, 0, 1).contiguous()
        t = dict(
            fwd=dict(ms=time_ms(lambda: conv.conv_valid_cuda(xp, w)),
                     plain_ms=time_ms(lambda: conv.conv_valid_plain(xp, w)),
                     library_ms=time_ms(lambda: F.conv2d(xp, w_oihw)),
                     nbytes=(xp.numel() + g.numel() + w.numel()) * isz,
                     flops=flops),
            dx=dict(ms=time_ms(lambda: conv.conv_valid_cuda(g, w_flip, 2)),
                    plain_ms=time_ms(
                        lambda: conv.conv_valid_plain(g, w_flip, 2)),
                    library_ms=time_ms(
                        lambda: F.conv2d(g, wf_oihw, padding=2)),
                    nbytes=(xp.numel() + g.numel() + w.numel()) * isz,
                    flops=flops),
            dw=dict(ms=time_ms(lambda: conv.conv_dw_cuda(xp, g, k)),
                    plain_ms=time_ms(lambda: conv.conv_dw_plain(xp, g, k)),
                    library_ms=time_ms(lambda: torch.nn.grad.conv2d_weight(
                        xp, w_oihw.shape, g)),
                    nbytes=(xp.numel() + g.numel()) * isz + w.numel() * 4,
                    flops=flops))
        for part, d in t.items():
            b, by = bound_ms(d["nbytes"], d["flops"], dtype_name)
            print(f"  time {part} {tag}: kernel {d['ms']:.4f} ms, plain "
                  f"{d['plain_ms']:.4f} ms, library {d['library_ms']:.4f} "
                  f"ms, bound {b:.4f} ms ({by})")
        if site == 0:
            rows["conv_valid"].update(t["fwd"], shape=f"fwd {tag}",
                                      dtype=dtype_name)
            rows["conv_dw"].update(t["dw"], shape=tag, dtype=dtype_name)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]


def check_edge_cases(torch, attn, conv):
    """Small shapes off the main path: key masking (n_valid), N a multiple
    of the tiles, k = 1, fp32 convs, Cout over two channel chunks."""
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


def check_small_step(torch):
    """One regular and one entire-A step's loss and gradient at a small
    size, fp32: the card (kernels K1-K4) against the CPU (plain path)."""
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.data import load_pair
    from splice_tpu_torch.losses import lambdas_for_step
    from splice_tpu_torch.models import extractor as ext_lib
    from splice_tpu_torch.models import vit as vit_lib
    from splice_tpu_torch.models.weights import init_vit_params
    from splice_tpu_torch.trainer import SpliceTrainer, sample_step_draws
    from splice_tpu_torch.utils.tree import tree_map

    cfg = load_config(None, dict(
        dataroot="datasets/splicing/cows", A_resize=448, B_resize=448,
        seed=3, vit_compute_dtype="float32",
        generator_compute_dtype="float32", dino_global_patch_size=64,
        entire_A_every=2))
    vcfg = vit_lib.VitConfig(patch_size=8, embed_dim=128, depth=2,
                             num_heads=2, img_size=32)
    vparams = init_vit_params(vcfg, seed=5, device="cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        pair = load_pair(cfg, device=torch.device(dev))
        ext = ext_lib.VitExtractor(
            params=tree_map(lambda t: t.to(dev), vparams), cfg=vcfg,
            model_name="small")
        tr = SpliceTrainer(cfg, pair, ext, seed=3)
        gen = torch.Generator().manual_seed(11)
        out = []
        for step, entire in ((1, False), (2, True)):
            draws = sample_step_draws(cfg, pair, gen)
            total, _ = tr.loss(draws, lambdas_for_step(cfg, step), entire)
            (grad,) = torch.autograd.grad(total, tr.flat)
            out.append((total.item(), grad.cpu()))
        results[dev] = out
    # Gradient tolerance: this gradient is ill-conditioned in fp32 itself.
    # On the CPU the fp32 gradient of this step differs from a float64
    # evaluation of the same code by 1.2e-3 relative L2 (8e-4 x max|grad|),
    # mostly in the first convs' weight gradients, and the card's differs
    # from the CPU's by as much with the conv kernels on or every conv on
    # cuDNN alike. A kernel fault gives errors of order max|grad|.
    for (lc, gc), (lp, gp), what in zip(results["cuda"], results["cpu"],
                                        ("regular", "entire-A")):
        rel = abs(lc - lp) / abs(lp)
        gerr = (gc - gp).abs().max().item()
        gtol = 5e-3 * gp.abs().max().item()
        grel = ((gc - gp).norm() / gp.norm()).item()
        print(f"  small {what} step (448 canvas, fp32): loss card {lc:.6f} "
              f"cpu {lp:.6f} rel {rel:.2e} (tol 1e-4); grad max_abs_err "
              f"{gerr:.3e} (tol {gtol:.3e} = 5e-3 x max|grad|), relative L2 "
              f"{grel:.2e} (tol 5e-3)")
        if not (rel <= 1e-4 and gerr <= gtol and grel <= 5e-3):
            fail(f"small {what} step: card and CPU disagree")


def profile_steps(torch, trainer, cfg, n: int = 3) -> None:
    """Device time by kernel over n regular steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from splice_tpu_torch.losses import lambdas_for_step
    from splice_tpu_torch.trainer import sample_step_draws
    gen = torch.Generator().manual_seed(1)
    draws = [sample_step_draws(cfg, trainer.pair, gen) for _ in range(n)]
    lam = lambdas_for_step(cfg, 5)
    # wall time without the profiler (which slows the host), then kernel
    # times with it, over the same steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d in draws:
        trainer.step(d, lam, False)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for d in draws:
            trainer.step(d, lam, False)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    kernel = torch.autograd.DeviceType.CUDA
    rows = [(dev_us(e) / 1e3 / n, e.key) for e in prof.key_averages()
            if e.device_type == kernel and dev_us(e) > 0]
    busy = sum(t for t, _ in rows)
    names = ("attn_fwd_kernel", "attn_bwd_", "conv_fwd_kernel", "conv_dw_")
    ours = sum(t for t, k in rows if any(s in k for s in names))
    print(f"  per regular step: wall {wall_ms:.2f} ms (no profiler), kernels "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}% of wall; "
          f"{len(rows)} kernel names), the port's four kernels "
          f"{ours:.2f} ms ({100 * ours / busy:.1f}% of kernel time)")
    for t, k in sorted(rows, reverse=True)[:15]:
        print(f"    {t:8.3f} ms  {100 * t / busy:5.1f}%  {k[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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

    print("phase 1: build")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"  built and loaded {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kernels = {
        "attn_qkv_fwd": (attn.attn_qkv_fwd_cuda, "cuda",
                         "splice_tpu_torch/csrc/attention.cu",
                         "splice_tpu/ops/attention.py:361"),
        "attn_qkv_bwd": (attn.attn_qkv_bwd_cuda, "cuda",
                         "splice_tpu_torch/csrc/attention.cu",
                         "splice_tpu/ops/attention.py:447"),
        "conv_valid": (conv.conv_valid_cuda, "cuda",
                       "splice_tpu_torch/csrc/conv.cu",
                       "splice_tpu/ops/conv_pallas.py:157"),
        "conv_dw": (conv.conv_dw_cuda, "cuda",
                    "splice_tpu_torch/csrc/conv.cu",
                    "splice_tpu/ops/conv_pallas.py:401"),
    }
    rows = {name: {} for name in kernels}

    print("phase 2: kernels against their plain versions")
    check_attention(torch, attn, rows)
    check_conv(torch, conv, rows)
    check_edge_cases(torch, attn, conv)
    for name, r in rows.items():
        b, by = bound_ms(r["nbytes"], r["flops"], r["dtype"])
        r.update(bound_ms=b, bound_by=by)
        print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {b:.4f} ms ({by})")

    print("phase 3: small step, card against CPU")
    check_small_step(torch)

    print(f"phase 4: main path, {MAIN_STEPS} steps on the cows pair")
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.trainer import train_pair
    cfg = load_config(None, dict(dataroot="datasets/splicing/cows", seed=0,
                                 entire_A_every=10, log_images_freq=1000))
    for fn, *_ in kernels.values():
        fn.launches = 0
    res = train_pair(cfg, n_steps=MAIN_STEPS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, *_) in kernels.items()}
    for i, (l, s) in enumerate(zip(res["losses"], res["step_seconds"])):
        print(f"  step {i:2d} {s * 1e3:9.2f} ms "
              + " ".join(f"{k}={v:.5f}" for k, v in l.items()))
    for i, l in enumerate(res["losses"]):
        if not all(math.isfinite(v) for v in l.values()):
            fail(f"non-finite loss at step {i}: {l}")
    out = res["output"]
    if tuple(out.shape) != (900, 1200, 3) or not torch.isfinite(out).all():
        fail(f"bad output image {tuple(out.shape)}")
    regular = [s for i, s in enumerate(res["step_seconds"])
               if i >= 2 and i % cfg.entire_A_every != 0]
    print(f"  steps/s after warm-up (regular steps 2..{MAIN_STEPS - 1}): "
          f"{len(regular) / sum(regular):.3f}; entire-A step 10: "
          f"{res['step_seconds'][10] * 1e3:.1f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches in the main path: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    print("phase 5: where the time goes")
    profile_steps(torch, res["trainer"], cfg)

    line = []
    for name, (fn, route, source, replaces) in kernels.items():
        r = rows[name]
        line.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
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
