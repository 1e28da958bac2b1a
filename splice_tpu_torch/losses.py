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


def per_pair_mse_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[P, n, ...] -> [P]: per pair, the sum over its n crops of per-crop
    MSEs, in fp32."""
    d = torch.square(a.float() - b.float())
    return d.reshape(a.shape[0], a.shape[1], -1).mean(dim=-1).sum(dim=-1)


def per_crop_mse_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (crop) axis of per-crop MSEs, in fp32."""
    return per_pair_mse_sum(a[None], b[None])[0]


def _features(extractor: ext.VitExtractor, images: torch.Tensor,
              layer: int):
    cfg = extractor.cfg
    last = cfg.depth - 1
    feats = extractor.run(images, {"qkv": (layer,), "block": (last,)})
    keys = ext.keys_from_qkv(feats["qkv"][layer], cfg.num_heads)
    return keys, feats["block"][last][:, 0, :]


def _by_pair(t: torch.Tensor, n_pairs: int) -> torch.Tensor:
    return t.reshape(n_pairs, t.shape[0] // n_pairs, *t.shape[1:])


def splice_losses_pairs(extractor: ext.VitExtractor, gen: torch.Tensor,
                        tgt: torch.Tensor, n_A: int,
                        ssim_layer: Optional[int] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """The three global losses of P pairs, each pair's its own ([P] per
    term). gen: [P, nA + nB, h, w, 3], each pair's generated A crops, then
    its generated B crops; tgt: the crops themselves, in the same order
    (resized and normalised). Every pair's generated images go through the
    ViT as one batch with gradients, the targets as one without (the
    reference's vmap over pairs batches them so). Returns (losses, aux:
    cls_B [P, nB, D])."""
    layer = extractor.cfg.depth - 1 if ssim_layer is None else ssim_layer
    P, k = gen.shape[:2]
    gen_keys, gen_cls = _features(extractor, gen.flatten(0, 1), layer)
    with torch.no_grad():
        tgt_keys, tgt_cls = _features(extractor, tgt.flatten(0, 1), layer)
    gk, gc, tk, tc = (_by_pair(t, P)
                      for t in (gen_keys, gen_cls, tgt_keys, tgt_cls))
    nm = min(n_A, k - n_A)    # the reference zips the crop stacks: truncate
    cls_B = tc[:, n_A:]
    losses = {
        "loss_global_ssim": per_pair_mse_sum(
            ext.keys_self_sim(gk[:, :n_A]), ext.keys_self_sim(tk[:, :n_A])),
        "loss_global_cls": per_pair_mse_sum(gc[:, :nm], cls_B[:, :nm]),
        "loss_global_id_B": per_pair_mse_sum(gk[:, n_A:], tk[:, n_A:]),
    }
    return losses, {"cls_B": cls_B}


def entire_losses_pairs(extractor: ext.VitExtractor, gen_entire: torch.Tensor,
                        entire_A: torch.Tensor, cls_B: torch.Tensor,
                        ssim_layer: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """The entire-image losses of P pairs ([P] per term). gen_entire,
    entire_A: [P, H, W, 3], one image a pair; cls_B: [P, nB, D]. A pair's
    entire-cls target is the CLS token of its FIRST B crop only (the
    reference zips one x_entire against the crop stack)."""
    layer = extractor.cfg.depth - 1 if ssim_layer is None else ssim_layer
    gen_keys, gen_cls = _features(extractor, gen_entire, layer)
    with torch.no_grad():
        tgt_keys, _ = _features(extractor, entire_A, layer)
    return {
        "loss_entire_ssim": per_pair_mse_sum(
            ext.keys_self_sim(gen_keys)[:, None],
            ext.keys_self_sim(tgt_keys)[:, None]),
        "loss_entire_cls": per_pair_mse_sum(gen_cls[:, None],
                                            cls_B[:, :1]),
    }


def splice_losses_fused(extractor: ext.VitExtractor,
                        gen_A: torch.Tensor, crops_A: torch.Tensor,
                        gen_B: torch.Tensor, crops_B: torch.Tensor,
                        ssim_layer: Optional[int] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """All three global losses of one pair from two batched ViT forwards
    (generated with gradients, targets without). Inputs: resized,
    normalised NHWC batches of one spatial shape. Returns (losses, aux)."""
    losses, aux = splice_losses_pairs(
        extractor, torch.cat([gen_A, gen_B])[None],
        torch.cat([crops_A, crops_B])[None], gen_A.shape[0], ssim_layer)
    return ({k: v[0] for k, v in losses.items()},
            {"cls_B": aux["cls_B"][0]})


def entire_losses_fused(extractor: ext.VitExtractor,
                        gen_entire: torch.Tensor, entire_A: torch.Tensor,
                        cls_B_targets: torch.Tensor,
                        ssim_layer: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """Entire-image losses of one pair: gen_entire and entire_A [1, H, W,
    3], cls_B_targets [nB, D]."""
    return {k: v[0] for k, v in entire_losses_pairs(
        extractor, gen_entire, entire_A, cls_B_targets[None],
        ssim_layer).items()}


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
