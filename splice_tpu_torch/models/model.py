"""The reference's model surface (port of splice_tpu/models/model.py):
define_G builds and initialises the skip generator, and Model(cfg)(inputs)
runs it on the reference's dict of inputs.

The trainer does not use this class (SpliceTrainer gates the entire-A
branch by the step class and batches the stacks); it exists so that code
written against the reference's surface ports mechanically. Inputs and
outputs are NHWC; the generator runs the NHWC route (unet.skip_apply), as
the reference's Model does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from splice_tpu_torch import resolve_device
from splice_tpu_torch.models import unet


def define_G(init_type: str = "normal", init_gain: float = 0.02,
             seed: int = 0, cfg: Optional[unet.SkipConfig] = None,
             device=None) -> Tuple[Dict[str, Any], unet.SkipConfig]:
    """Build and initialise the skip generator (the reference's define_G,
    splice_tpu/models/model.py:19-26): (params, skip config). The init is
    drawn from `seed` on the CPU (a seed gives the same weights on every
    device) and moved to `device` (default CUDA)."""
    gcfg = cfg or unet.SkipConfig()
    params = unet.init_skip_params(gcfg, init_gain, seed=seed,
                                   device=resolve_device(device),
                                   init_type=init_type)
    return params, gcfg


class Model:
    """The reference's Model (splice_tpu/models/model.py:29-56): __call__
    computes x_global (when the global cls and ssim lambdas sum above 0),
    x_entire (on entire-A steps) and always y_global."""

    def __init__(self, cfg, seed: int = 0,
                 gcfg: Optional[unet.SkipConfig] = None, device=None):
        self.cfg = cfg
        self.params, self.gcfg = define_G(cfg.init_type, cfg.init_gain, seed,
                                          gcfg, device)

    def netG(self, x: torch.Tensor) -> torch.Tensor:
        return unet.skip_apply(self.params, self.gcfg, x)

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        outputs: Dict[str, torch.Tensor] = {}
        if cfg.lambda_global_cls + cfg.lambda_global_ssim > 0:
            outputs["x_global"] = self.netG(inputs["A_global"])
        # the entire-A gate on either entire lambda, as the reference's
        # (the original Splice gates on ssim only; PARITY.md deviation 5)
        if ((cfg.lambda_entire_ssim > 0 or cfg.lambda_entire_cls > 0)
                and int(inputs["step"]) % cfg.entire_A_every == 0):
            outputs["x_entire"] = self.netG(inputs["A"])
        outputs["y_global"] = self.netG(inputs["B_global"])
        return outputs
