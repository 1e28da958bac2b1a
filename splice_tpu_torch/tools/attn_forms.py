"""K6 (and K5) at the wide head widths, bf16 and fp32, timed for one
checkout beside SDPA.

    python splice_tpu_torch/tools/attn_forms.py [--tree DIR] [--out FILE]
        [--dtype bfloat16|float32]

Imports splice_tpu_torch from DIR (default: the checkout this file is in),
builds its attention library, and at each of chip_smoke.py's WIDE_SPLIT
shapes ([2, 768 / dh, 3601, dh] for dh = 128, 192, 256: ViT-B's width as
heads of dh at the 480-px crops' 3601 tokens; read from the chip_smoke.py
beside this checkout's package) and at [2, 2, 3601, 384] (K6's streamed
form), in bf16 and
fp32 (or the one --dtype names), unmasked and with WIDE_VALID = 2701 valid
keys (the entire A's), times K6 (attn_bwd_cuda) and K5 (attn_fwd_cuda)
beside SDPA's backward and forward (library_attention with the key mask;
the backward by autograd.grad of its output), with matmul's and cuDNN's
TF32 off. Each time is the median of 5 batches of 10 back-to-back calls
(tools/mma_k_probe.device_ms: CUDA events, L2-warm, the stream held by a
device sleep until the host has queued the batch). K6's largest error
against attention_bwd_plain, as a fraction of max|plain| of each gradient,
rides along ("k6_err"), so that a timed form is a right one. It uses only
attn_fwd_cuda, attn_bwd_cuda, attention_bwd_plain and library_attention,
which every version of the port that takes wide heads has, so that two
commits can be timed in turns in one call: unpack the other by `git
archive` into a git-ignored directory (`_proof/parent`) and run this file
with `--tree` for each, in turns. Prints one JSON line ({"tree", "card",
"forms": {"[B,H,N,dh] dtype n_valid=V": {"k6", "k5", "sdpa_bwd",
"sdpa_fwd", "k6_err"}}, "plan": {"dtype dh": [launch, ...]}, "fwd_plan":
{...}}, ms; "plan" and "fwd_plan" are K6's and K5's launches as
ops.attention.wide_bwd_plan and wide_fwd_plan give them, where the tree
has them), appended to FILE if given.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

# (B, H, N, dh) past the resident form's widest head: ViT-B's width as two
# heads of 384 at the 480-px crops' tokens
STREAMED = ((2, 2, 3601, 384),)
SCALE = 0.125


def gate_shapes(root: pathlib.Path):
    """chip_smoke.py's WIDE_SPLIT and WIDE_VALID, from the checkout at
    root (its top level imports only the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.WIDE_SPLIT, mod.WIDE_VALID


def rel_err(got, want) -> float:
    """The largest |got - want| over max|want|, of each pair."""
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) for a, b in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = pathlib.Path(__file__).resolve().parents[2]
    ap.add_argument("--tree", default=str(here))
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None)
    args = ap.parse_args(argv)
    wide_split, wide_valid = gate_shapes(here)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    from splice_tpu_torch.ops import _build
    from splice_tpu_torch.ops import attention as attn
    from splice_tpu_torch.tools.mma_k_probe import device_ms
    if not str(pathlib.Path(attn.__file__).resolve()).startswith(str(tree)):
        raise SystemExit(f"imported {attn.__file__}, not from {tree}")
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtypes = (args.dtype,) if args.dtype else ("bfloat16", "float32")
    forms, plan, fwd_plan = {}, {}, {}
    for dtype_name in dtypes:
        dt = getattr(torch, dtype_name)
        for B, H, N, dh in wide_split + STREAMED:
            gen = torch.Generator().manual_seed(50 + N + dh)
            q, k, v, g = (torch.randn(B, H, N, dh, generator=gen).to(
                "cuda", dt) for _ in range(4))
            for nv in (0, wide_valid):
                tag = f"[{B},{H},{N},{dh}] {dtype_name} n_valid={nv or N}"
                err = rel_err(attn.attn_bwd_cuda(q, k, v, g, SCALE, nv),
                              attn.attention_bwd_plain(q, k, v, g, SCALE,
                                                       nv))
                qr, kr, vr = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                o = attn.library_attention(qr, kr, vr, SCALE, nv)
                calls = {
                    "k6": lambda: attn.attn_bwd_cuda(q, k, v, g, SCALE, nv),
                    "sdpa_bwd": lambda: torch.autograd.grad(
                        o, (qr, kr, vr), g, retain_graph=True),
                    "k5": lambda: attn.attn_fwd_cuda(q, k, v, SCALE, nv),
                    "sdpa_fwd": lambda: attn.library_attention(
                        q, k, v, SCALE, nv)}
                row = {}
                for key, fn in calls.items():
                    fn()
                    row[key] = statistics.median(
                        device_ms(fn, 10) for _ in range(5))
                row["k6_err"] = err
                forms[tag] = row
                print(f"  {tag}: " + ", ".join(
                    f"{key} {val:.4f}" for key, val in row.items()),
                      file=sys.stderr)
                del o, qr, kr, vr
            del q, k, v, g
            torch.cuda.empty_cache()
            if hasattr(attn, "wide_bwd_plan"):
                plan[f"{dtype_name} {dh}"] = attn.wide_bwd_plan(dh, dt)
            if hasattr(attn, "wide_fwd_plan"):
                fwd_plan[f"{dtype_name} {dh}"] = attn.wide_fwd_plan(dh, dt)
    result = {"tree": str(tree), "card": card, "forms": forms}
    if plan:
        result["plan"] = plan
    if fwd_plan:
        result["fwd_plan"] = fwd_plan
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
