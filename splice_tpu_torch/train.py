"""Command line: optimise one image pair with the port.

    python -m splice_tpu_torch.train --dataroot datasets/splicing/cows \
        --n_epochs 2000

Every config key is a flag (CLI > --config YAML > defaults), e.g.
--dino_global_patch_size 480 (the long-sequence loss resolution) or
--generator_conv fused. Runs on CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse

from splice_tpu_torch.config import add_cli_args, config_from_cli
from splice_tpu_torch.trainer import train_pair


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config file")
    add_cli_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_cli(args, args.config)
    res = train_pair(cfg)
    last = res["losses"][-1] if res["losses"] else {}
    n = len(res["step_seconds"])
    print(f"done: {n} steps in chunks {res['chunks']}, "
          f"{res['steps_per_sec']:.2f} steps/s, last loss "
          f"{last.get('loss', float('nan')):.4f}, output "
          f"{res['output_path']}")


if __name__ == "__main__":
    main()
