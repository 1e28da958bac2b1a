"""Splice losses (port of splice_tpu/losses.py:45-210).

  * structure: MSE between layer-11 key self-similarity Grams of the
    generated image and of the structure input;
  * appearance: MSE between last-block CLS tokens of the generated image
    and of the appearance target;
  * identity: MSE between raw layer-11 keys of G(B) and of B.

Per-crop reduction is the SUM of per-crop MSEs (the reference accumulates
`loss += mse` over crops). Generated images go through the ViT in one
batched forward with gradients; the targets in one forward under no_grad.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from splice_tpu_torch.models import extractor as ext

# The loss terms and their lambdas, in the reference's order
# (splice_tpu/trainer.py:219-224): the order of a step's lambda vector.
LOSS_NAMES = ("loss_global_cls", "loss_global_ssim", "loss_global_id_B",
              "loss_entire_cls", "loss_entire_ssim")
LAMBDA_ORDER = ("lambda_global_cls", "lambda_global_ssim",
                "lambda_global_identity", "lambda_entire_cls",
                "lambda_entire_ssim")
_LOSS_LAMBDA = dict(zip(LOSS_NAMES, LAMBDA_ORDER))


def lambdas_for_step(cfg, step: int) -> Dict[str, float]:
    """The reference's lambda schedule as a function of the 0-based step:
    cls always; ssim and identity from step cls_warmup on; the entire-image
    terms on every entire_A_every-th step."""
    warm = step >= cfg.cls_warmup
    entire = step % cfg.entire_A_every == 0
    return {
        "lambda_global_cls": float(cfg.lambda_global_cls),
        "lambda_global_ssim": float(cfg.lambda_global_ssim) if warm else 0.0,
        "lambda_global_identity":
            float(cfg.lambda_global_identity) if warm else 0.0,
        "lambda_entire_cls": float(cfg.lambda_entire_cls) if entire else 0.0,
        "lambda_entire_ssim": float(cfg.lambda_entire_ssim) if entire else 0.0,
    }


def is_entire_step(cfg, step: int) -> bool:
    """Entire-A steps: step % entire_A_every == 0 and either entire lambda
    positive (the reference gates on ssim only and would fail on cls)."""
    return (step % cfg.entire_A_every == 0
            and (cfg.lambda_entire_ssim > 0 or cfg.lambda_entire_cls > 0))


def per_crop_mse_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (crop) axis of per-crop MSEs, in fp32."""
    d = torch.square(a.float() - b.float())
    return d.reshape(a.shape[0], -1).mean(dim=-1).sum()


def structure_loss(gen_keys: torch.Tensor,
                   tgt_keys: torch.Tensor) -> torch.Tensor:
    return per_crop_mse_sum(ext.keys_self_sim(gen_keys),
                            ext.keys_self_sim(tgt_keys).detach())


def appearance_loss(gen_cls: torch.Tensor,
                    tgt_cls: torch.Tensor) -> torch.Tensor:
    return per_crop_mse_sum(gen_cls, tgt_cls.detach())


def identity_loss(gen_keys: torch.Tensor,
                  tgt_keys: torch.Tensor) -> torch.Tensor:
    return per_crop_mse_sum(gen_keys, tgt_keys.detach())


def _features(extractor: ext.VitExtractor, images: torch.Tensor,
              layer: int):
    cfg = extractor.cfg
    last = cfg.depth - 1
    feats = extractor.run(images, {"qkv": (layer,), "block": (last,)})
    keys = ext.keys_from_qkv(feats["qkv"][layer], cfg.num_heads)
    return keys, feats["block"][last][:, 0, :]


def splice_losses_fused(extractor: ext.VitExtractor,
                        gen_A: torch.Tensor, crops_A: torch.Tensor,
                        gen_B: torch.Tensor, crops_B: torch.Tensor,
                        ssim_layer: Optional[int] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """All three global losses from two batched ViT forwards (generated
    with gradients, targets without). Inputs: resized, normalised NHWC
    batches of one spatial shape. Returns (losses, aux)."""
    layer = extractor.cfg.depth - 1 if ssim_layer is None else ssim_layer
    n, m = gen_A.shape[0], gen_B.shape[0]
    gen_keys, gen_cls = _features(extractor, torch.cat([gen_A, gen_B]),
                                  layer)
    with torch.no_grad():
        tgt_keys, tgt_cls = _features(extractor,
                                      torch.cat([crops_A, crops_B]), layer)
    nm = min(n, m)    # the reference zips the crop stacks: truncate
    cls_B = tgt_cls[n:]
    losses = {
        "loss_global_ssim": structure_loss(gen_keys[:n], tgt_keys[:n]),
        "loss_global_cls": appearance_loss(gen_cls[:n][:nm], cls_B[:nm]),
        "loss_global_id_B": identity_loss(gen_keys[n:], tgt_keys[n:]),
    }
    return losses, {"cls_B": cls_B}


def entire_losses_fused(extractor: ext.VitExtractor,
                        gen_entire: torch.Tensor, entire_A: torch.Tensor,
                        cls_B_targets: torch.Tensor,
                        ssim_layer: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """Entire-image losses. The entire-cls target is the CLS token of the
    FIRST B crop only (the reference zips one x_entire against the crop
    stack)."""
    layer = extractor.cfg.depth - 1 if ssim_layer is None else ssim_layer
    gen_keys, gen_cls = _features(extractor, gen_entire, layer)
    with torch.no_grad():
        tgt_keys, _ = _features(extractor, entire_A, layer)
    return {
        "loss_entire_ssim": structure_loss(gen_keys, tgt_keys),
        "loss_entire_cls": appearance_loss(gen_cls[:1], cls_B_targets[:1]),
    }


def weighted_total(losses: Dict[str, torch.Tensor],
                   lambdas: Union[Dict[str, float], torch.Tensor]
                   ) -> torch.Tensor:
    """Sum of lambda-weighted loss terms. lambdas: floats by name, or a [5]
    tensor in LAMBDA_ORDER (device data, so that one captured step serves
    every step of the schedule)."""
    total = 0.0
    for name, value in losses.items():
        if isinstance(lambdas, torch.Tensor):
            lam = lambdas[LOSS_NAMES.index(name)]
        else:
            lam = lambdas.get(_LOSS_LAMBDA[name], 0.0)
        total = total + lam * value
    return total
