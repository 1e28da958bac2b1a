"""splice_tpu_torch: the PyTorch/CUDA port of splice_tpu for NVIDIA Hopper.

The layout mirrors splice_tpu/ module for module; splice_tpu stays the
reference that every ported function is tested against. This package imports
torch and never jax or splice_tpu.

Entry points run on CUDA unless the caller passes device="cpu"; without a
card they raise instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: "cuda" unless told otherwise.

    Raises when CUDA is asked for (or defaulted to) and no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "splice_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
