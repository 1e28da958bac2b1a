"""Sustained training rate of the port on one card, log boundaries and all.

    python splice_tpu_torch/tools/run_rate.py [--tree DIR] [--out FILE]
    python splice_tpu_torch/tools/run_rate.py --parts [--out FILE]

Imports splice_tpu_torch from DIR (default: the checkout this file is in)
and runs its train_pair on the cows pair at full width (896 canvas,
dino_vitb8 with seeded weights, 224 loss resolution, bf16) from one
process: at the defaults (log_images_freq 10: an output PNG, and since the
run loop's port a metrics record, every 10 steps) and with
log_images_freq 1000 (no log boundary but the run's end), 300 steps each.
It uses only load_config, load_pair,
make_extractor_from_config, train_pair(cfg, n_steps, dataroot=, pair=,
extractor=) and the result's steps_per_sec, which every version of the
port has, so that two commits can be timed in turns in one call.

A run's wall is n_steps / steps_per_sec: the loop's own clock, from its
first chunk (the captures of the two graphs included) to its last read.
A 12-step run first takes what only a process's first run pays (library
loads, the first launches); then four 300-step runs in turns (log 10,
1000, 1000, 10). Both configurations pay the same captures, so a log
boundary costs the difference of their mean walls over the 29 boundaries
that only the first has inside the loop's clock. Prints one JSON line,
and appends it to FILE if given.

--parts times the pieces of one log boundary instead, on an idle device
(each a median of 5 after one untimed call, the device synchronised
around it): the form before the run loop's port (the eager float render,
its copy to pageable memory, the host's clip and uint8 cast, a PIL PNG
save at its default level 6, into memory) and this one (render_u8, its
HostCopy, the native encoder at levels 1 and 6). It needs this
checkout's package.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time


def boundary_parts(torch, trainer, reps: int = 5) -> dict:
    """Median ms of each piece of a log boundary (see --parts)."""
    import io
    import numpy as np
    from PIL import Image
    from splice_tpu_torch.utils import pngio
    from splice_tpu_torch.utils.metrics import HostCopy

    def timed(fn):
        ts = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return out, 1e3 * sorted(ts[1:])[reps // 2]

    parts = {}
    img, parts["render"] = timed(trainer.render)
    host, parts["float_copy"] = timed(lambda: img.cpu().numpy())
    u8, parts["host_uint8"] = timed(
        lambda: (np.clip(host, 0.0, 1.0) * 255.0).astype(np.uint8))
    _, parts["pil_png_level6"] = timed(
        lambda: Image.fromarray(u8).save(io.BytesIO(), format="PNG"))
    dev_u8, parts["render_u8"] = timed(trainer.render_u8)
    _, parts["u8_host_copy"] = timed(lambda: HostCopy(dev_u8).wait())
    for level in (1, 6):
        _, parts[f"native_png_level{level}"] = timed(
            lambda: pngio.encode_png_rgb8(u8, level))
    return {"ms": parts, "encoder": pngio.encoder(),
            "shape": list(u8.shape)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    out = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("run_rate: no CUDA device")
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.data import load_pair
    from splice_tpu_torch.trainer import (SpliceTrainer,
                                          make_extractor_from_config,
                                          train_pair)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    base = dict(dataroot="datasets/splicing/cows", seed=0)
    cfg = load_config(None, base)
    pair = load_pair(cfg, device="cuda")
    extractor = make_extractor_from_config(cfg, "cuda")
    if args.parts:
        emit({"tree": tree, "card": card, "torch": torch.__version__,
              "boundary_parts": boundary_parts(
                  torch, SpliceTrainer(cfg, pair, extractor))}, out)
        return
    walls = {10: [], 1000: []}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for freq, n in ((10, 12), (10, 300), (1000, 300), (1000, 300),
                        (10, 300)):
            run_cfg = load_config(None, dict(base, log_images_freq=freq))
            t0 = time.perf_counter()
            res = train_pair(run_cfg, n_steps=n, dataroot=tmp, pair=pair,
                             extractor=extractor)
            runs.append({"log_images_freq": freq, "steps": n,
                         "loop_s": n / res["steps_per_sec"],
                         "call_s": time.perf_counter() - t0})
            if n == 300:
                walls[freq].append(n / res["steps_per_sec"])
            del res
            torch.cuda.empty_cache()
    mean = {f: sum(w) / len(w) for f, w in walls.items()}
    emit({"tree": tree, "card": card, "torch": torch.__version__,
          "steps_per_sec_300": {f"log{f}": 300 / m for f, m in mean.items()},
          "boundary_ms": 1e3 * (mean[10] - mean[1000]) / 29,
          "runs": runs}, out)


def emit(line: dict, out) -> None:
    print(json.dumps(line))
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
