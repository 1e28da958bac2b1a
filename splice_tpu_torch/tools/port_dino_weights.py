"""Convert a local torch DINO or DINOv2 checkpoint into the .npz format
that both packages read (splice_tpu's save_vit_params layout).

    python -m splice_tpu_torch.tools.port_dino_weights \
        --checkpoint dino_vitbase8_pretrain.pth \
        --model_name dino_vitb8 --out dino_vitb8.npz

Accepts a torch-saved state dict, or a checkpoint that nests one under
'state_dict', 'teacher' or 'model' (the DINO release formats), with
'module.' and 'backbone.' prefixes stripped. The mapped tensors go through
`--device` (default cuda; --device cpu without a card) on their way to the
file. Then pass --vit_weights <out> to python -m splice_tpu_torch.train.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from splice_tpu_torch.models import vit as vit_lib
from splice_tpu_torch.models import weights as w_lib


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors by their DINO names. Unpickles only tensors,
    containers and argparse.Namespace (the 'args' entry of DINO's release
    checkpoints), never arbitrary objects."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "teacher", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    state = {}
    for k, v in obj.items():
        for prefix in ("module.", "backbone."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if isinstance(v, torch.Tensor):
            state[k] = v
    return state


def port_checkpoint(checkpoint: str, model_name: str, out: str,
                    device=None) -> int:
    """Map `checkpoint` onto `model_name`'s tree on `device` (default
    CUDA) and write it to `out`; returns the number of parameters."""
    cfg = vit_lib.get_vit_config(model_name)
    params = w_lib.port_dino_state_dict(load_torch_state(checkpoint), cfg,
                                        device)
    return w_lib.save_vit_params(out, params, model_name)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True,
                        help="torch checkpoint (.pth) path")
    parser.add_argument("--model_name", default="dino_vitb8",
                        help=", ".join(sorted(vit_lib.VIT_CONFIGS)))
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    n = port_checkpoint(args.checkpoint, args.model_name, args.out,
                        args.device)
    print(f"ported {args.model_name}: {n / 1e6:.1f}M params -> {args.out}")


if __name__ == "__main__":
    main()
