"""Quality acceptance with the port: port a DINO checkpoint, train the two
bundled pairs, and score each output against the reference's stored output
(port of scripts/accept.py, which runs the same protocol on the JAX
package).

    python -m splice_tpu_torch.tools.accept --checkpoint dino_vitbase8_pretrain.pth \\
        [--lpips_weights lpips_alex.npz] [--n_epochs 2000] [--pairs cows ...] \\
        [--datasets_root datasets/splicing] [--train_args "..."] \\
        [--out accept_torch.json] [--vit_npz $TMPDIR/accept_torch_vit.npz] \\
        [--device cuda]

Steps, each a process of its own as in the reference: the weight port
(python -m splice_tpu_torch.tools.port_dino_weights), then per pair
python -m splice_tpu_torch.train --dataroot <datasets_root>/<pair>
--vit_weights <vit_npz> --dino_model_name <model_name> --n_epochs N
--device <device>, then --train_args verbatim (later flags win, e.g.
"--A_resize 224"). Each pair's <dataroot>/out/output.png is scored against
<dataroot>/ref/output.png, the reference implementation's own output for
the pair (not shipped: one run of the reference on the pair, its
out/output.png copied there), by score_pair: PSNR and SSIM on the host,
LPIPS on `--device` (tools/evaluate.py). The acceptance criterion is LPIPS
<= 0.05. Without a reference output or LPIPS weights the report names the
missing artifact.

Writes the report (the reference's keys, per pair and overall) to --out
and prints it. Exit code 0 if every comparable pair passes or nothing was
comparable, 1 on a failed comparison, 2 on a pipeline error (the weight
port, a training run, or a shape mismatch). The defaults leave the JAX
run's accept.json and accept_vit.npz alone.
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
from typing import Optional

from splice_tpu_torch.tools import evaluate as ev

REPO = pathlib.Path(__file__).resolve().parents[2]
PAIRS = ("cows", "apples2oranges")
LPIPS_THRESHOLD = 0.05


def run(cmd) -> None:
    print("+", " ".join(str(c) for c in cmd), flush=True)
    subprocess.run([str(c) for c in cmd], check=True, cwd=REPO)


def score_pair(out_png: str, ref_png: str, lpips_weights: Optional[str],
               device=None) -> dict:
    """PSNR (dB, 3 decimals) and SSIM (4) of out_png against ref_png, and
    LPIPS (4) with its verdict against LPIPS_THRESHOLD where lpips_weights
    (an .npz, evaluate.port_lpips_weights) is given, on `device` (default
    CUDA); else lpips None and the blocking artifact named. Images of
    different shapes give {"error": ...}."""
    a, b = ev.load01(str(out_png)), ev.load01(str(ref_png))
    if a.shape != b.shape:
        return {"error": f"shape mismatch {a.shape} vs {b.shape}"}
    entry = {"psnr": round(ev.psnr(a, b), 3), "ssim": round(ev.ssim(a, b), 4)}
    if lpips_weights:
        entry["lpips"] = round(ev.lpips(a, b, lpips_weights, device), 4)
        entry["lpips_pass"] = entry["lpips"] <= LPIPS_THRESHOLD
    else:
        entry["lpips"] = None
        entry["blocking_artifact"] = (
            "no --lpips_weights: LPIPS (the acceptance metric) not "
            "computed; produce the .npz with evaluate.port_lpips_weights "
            "on a box with the torch checkpoints")
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="torch DINO checkpoint (.pth), e.g. "
                         "dino_vitbase8_pretrain.pth")
    ap.add_argument("--model_name", default="dino_vitb8")
    ap.add_argument("--lpips_weights", default=None,
                    help="LPIPS .npz (evaluate.port_lpips_weights); omit to "
                         "report PSNR/SSIM only")
    ap.add_argument("--n_epochs", type=int, default=2000)
    ap.add_argument("--pairs", nargs="*", default=list(PAIRS))
    ap.add_argument("--datasets_root",
                    default=str(REPO / "datasets" / "splicing"),
                    help="directory holding the <pair>/{A,B[,ref]} trees")
    ap.add_argument("--train_args", default="",
                    help="extra flags passed verbatim to "
                         "splice_tpu_torch.train (e.g. '--A_resize 224')")
    ap.add_argument("--out", default=str(REPO / "accept_torch.json"))
    ap.add_argument("--vit_npz",
                    default=os.path.join(tempfile.gettempdir(),
                                         "accept_torch_vit.npz"),
                    help="where to write the ported weights")
    ap.add_argument("--device", default="cuda",
                    help="the weight port's, the training's and LPIPS's "
                         "(cpu for the plain path)")
    args = ap.parse_args(argv)

    report = {"checkpoint": args.checkpoint, "model_name": args.model_name,
              "n_epochs": args.n_epochs, "pairs": {}, "pass": None,
              "lpips_threshold": LPIPS_THRESHOLD}

    def finish(code: int) -> int:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=2))
        print(json.dumps(report))
        return code

    try:
        run([sys.executable, "-m", "splice_tpu_torch.tools.port_dino_weights",
             "--checkpoint", args.checkpoint, "--model_name",
             args.model_name, "--out", args.vit_npz, "--device", args.device])
    except subprocess.CalledProcessError as e:
        report["error"] = f"weight port failed: {e}"
        return finish(2)

    verdicts = []
    pipeline_error = False
    for pair in args.pairs:
        droot = pathlib.Path(args.datasets_root) / pair
        entry = {"dataroot": str(droot)}
        report["pairs"][pair] = entry
        t0 = time.time()
        try:
            run([sys.executable, "-m", "splice_tpu_torch.train",
                 "--dataroot", droot, "--vit_weights", args.vit_npz,
                 "--dino_model_name", args.model_name,
                 "--n_epochs", args.n_epochs, "--device", args.device]
                + args.train_args.split())
            entry["trained"] = True
            entry["train_wall_s"] = round(time.time() - t0, 1)
        except subprocess.CalledProcessError as e:
            # no verdict without an output: a pipeline error (exit 2), not
            # a failed comparison (exit 1)
            entry["trained"] = False
            entry["error"] = str(e)
            pipeline_error = True
            continue
        out_png = droot / "out" / "output.png"
        ref_png = droot / "ref" / "output.png"
        entry["output"] = str(out_png)
        entry["ref_available"] = ref_png.exists()
        if not ref_png.exists():
            entry["blocking_artifact"] = (
                f"{ref_png} missing: run the reference implementation on "
                f"this pair once and copy its out/output.png there")
            continue
        scores = score_pair(out_png, ref_png, args.lpips_weights,
                            args.device)
        entry.update(scores)
        if "error" in scores:
            pipeline_error = True
        elif "lpips_pass" in scores:
            verdicts.append(scores["lpips_pass"])

    report["pass"] = all(verdicts) if verdicts else None
    if pipeline_error:
        return finish(2)
    return finish(0 if report["pass"] in (True, None) else 1)


if __name__ == "__main__":
    sys.exit(main())
