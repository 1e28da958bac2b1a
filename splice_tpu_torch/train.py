"""Command line: optimise one image pair with the port.

    python -m splice_tpu_torch.train --dataroot datasets/splicing/cows \
        --n_epochs 2000

Every config key is a flag (CLI > --config YAML > defaults), e.g.
--dino_global_patch_size 480 (the long-sequence loss resolution),
--generator_conv fused, --scheduler_policy cosine or --optimizer rmsprop.
Runs on CUDA unless --device cpu is given. --checkpoint_every N
--checkpoint_dir D saves the run every N steps; --resume_from D continues
from the latest checkpoint in D; with --max_restarts R as well, the run
goes in a child process that is relaunched from the latest checkpoint
after a crash, up to R times. --video_mode true optimises the frames of
<dataroot>/A in turn against <dataroot>/B, each warm-started from the one
before (splice_tpu_torch.video.train_video). A comma-separated --dataroot
trains its pairs together, several pairs in one step at 224 x 224
(splice_tpu_torch.parallel.pair_parallel.train_pairs):

    python -m splice_tpu_torch.train \
        --dataroot datasets/splicing/cows,datasets/splicing/apples2oranges
"""
from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

from splice_tpu_torch.config import Config, add_cli_args, config_from_cli
from splice_tpu_torch.parallel.pair_parallel import train_pairs
from splice_tpu_torch.trainer import train_pair
from splice_tpu_torch.video import train_video

# the package's parent directory, so that a child imports this package
_ROOT = str(pathlib.Path(__file__).resolve().parents[1])


def run_with_restarts(cfg: Config, argv: list) -> int:
    """Elastic recovery (root train.py:20-47): run the training in a child
    process (python -m splice_tpu_torch.train with the same arguments);
    when it dies (out of memory, a lost device, an injected fault),
    relaunch it with --resume_from cfg.checkpoint_dir, up to
    cfg.max_restarts times. A process of its own, because a device
    context in a bad state cannot be revived in-process. Returns the last
    child's exit code."""
    if cfg.checkpoint_every <= 0 or not cfg.checkpoint_dir:
        raise SystemExit("--max_restarts requires --checkpoint_every > 0 "
                         "and --checkpoint_dir (the restart resumes from "
                         "the latest checkpoint)")
    path = os.environ.get("PYTHONPATH")
    rc = 1
    for attempt in range(cfg.max_restarts + 1):
        env = dict(os.environ, _SPLICE_ELASTIC_CHILD="1",
                   SPLICE_RESTART_ATTEMPT=str(attempt),
                   PYTHONPATH=_ROOT + (os.pathsep + path if path else ""))
        cmd = [sys.executable, "-m", "splice_tpu_torch.train", *argv]
        if attempt > 0:
            # argparse keeps the last occurrence: this overrides any
            # --resume_from of the user's
            cmd += ["--resume_from", cfg.checkpoint_dir]
        rc = subprocess.run(cmd, env=env).returncode
        if rc == 0:
            return 0
        left = cfg.max_restarts - attempt
        print(f"splice_tpu_torch.train: attempt {attempt} exited rc={rc}; "
              + (f"restarting from {cfg.checkpoint_dir}" if left
                 else "no restarts left"), file=sys.stderr)
    return rc


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config file")
    add_cli_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_cli(args, args.config)
    if cfg.max_restarts > 0 and not os.environ.get("_SPLICE_ELASTIC_CHILD"):
        raise SystemExit(run_with_restarts(cfg, argv))
    if cfg.video_mode:
        train_video(cfg)
        return
    if "," in cfg.dataroot:
        roots = [r.strip() for r in cfg.dataroot.split(",") if r.strip()]
        res = train_pairs(cfg, roots)
        print(f"{res['pair_steps_per_sec']:.2f} pair-steps/s over "
              f"{len(roots)} pairs; outputs {', '.join(res['output_paths'])}")
        return
    res = train_pair(cfg)
    last = res["losses"][-1] if res["losses"] else {}
    n = len(res["step_seconds"])
    print(f"done: {n} steps from step {res['first_step']} in chunks "
          f"{res['chunks']}, {res['steps_per_sec']:.2f} steps/s, last loss "
          f"{last.get('loss', float('nan')):.4f}, output "
          f"{res['output_path']}")


if __name__ == "__main__":
    main()
