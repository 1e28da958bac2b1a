"""Feature extraction over the ViT (port of splice_tpu/models/extractor.py
:18-164): the key self-similarity and the extractor object the losses
call."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from splice_tpu_torch.models import vit as vit_lib
from splice_tpu_torch.models.vit import VitConfig


def attn_cosine_sim(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine-similarity Gram [..., T, D] -> [..., T, T] in fp32, the
    denominator clamped at eps (CLS row kept)."""
    x = x.float()
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    factor = torch.clamp(norm @ norm.transpose(-1, -2), min=eps)
    return (x @ x.transpose(-1, -2)) / factor


def qkv_split(qkv: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """[..., N, 3D] -> (q, k, v), each [..., H, N, dh]."""
    *lead, N, threeD = qkv.shape
    dh = threeD // 3 // num_heads
    x = qkv.reshape(*lead, N, 3, num_heads, dh)
    n = len(lead)
    x = x.permute(*range(n), n + 1, n + 2, n, n + 3)        # [..., 3, H, N, dh]
    return x[..., 0, :, :, :], x[..., 1, :, :, :], x[..., 2, :, :, :]


def keys_from_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    return qkv_split(qkv, num_heads)[1]


def concat_heads(keys: torch.Tensor) -> torch.Tensor:
    """[..., H, N, dh] -> [..., N, H*dh]."""
    x = keys.transpose(-3, -2)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def keys_self_sim(keys: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Head-concatenated cosine Gram of keys: [..., H, N, dh] -> [..., N, N]."""
    return attn_cosine_sim(concat_heads(keys), eps)


@dataclasses.dataclass
class VitExtractor:
    """Frozen ViT parameters + config; run() returns the requested taps of
    one batched forward on [B, H, W, 3] normalised images."""
    params: Dict[str, Any]
    cfg: VitConfig
    model_name: str = "dino_vitb8"
    compute_dtype: torch.dtype = torch.float32

    def run(self, images: torch.Tensor, taps: Dict[str, Sequence[int]],
            final_norm: bool = False) -> Dict[str, Dict[int, torch.Tensor]]:
        return vit_lib.vit_forward(self.params, images, self.cfg, taps,
                                   compute_dtype=self.compute_dtype,
                                   final_norm=final_norm)
