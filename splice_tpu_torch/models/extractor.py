"""Feature extraction over the ViT (port of splice_tpu/models/extractor.py
:18-164): the key self-similarity, the extractor object the losses call,
and the reference's accessors (geometry, every block's features, qkv,
attention probabilities, keys, their self-similarity, the CLS token), each
one forward that returns only the tap it asks for."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from splice_tpu_torch import resolve_device
from splice_tpu_torch.models import vit as vit_lib
from splice_tpu_torch.models.vit import VitConfig
from splice_tpu_torch.models.weights import init_vit_params


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
    one batched forward on [B, H, W, 3] normalised images. use_pallas is
    the reference's extractor flag (:87): False runs attention without the
    port's kernels. With tp_devices, params is one tree per
    tensor-parallel rank on these devices (parallel.mesh.shard_vit_params)
    and the images and taps live on tp_devices[0] (the reference's
    tp_manual, :89-93)."""
    params: Any
    cfg: VitConfig
    model_name: str = "dino_vitb8"
    compute_dtype: torch.dtype = torch.float32
    use_pallas: bool = True
    tp_devices: Optional[Tuple[torch.device, ...]] = None

    def run(self, images: torch.Tensor, taps: Dict[str, Sequence[int]],
            final_norm: bool = False) -> Dict[str, Dict[int, torch.Tensor]]:
        return vit_lib.vit_forward(self.params, images, self.cfg, taps,
                                   compute_dtype=self.compute_dtype,
                                   final_norm=final_norm,
                                   use_pallas=self.use_pallas,
                                   devices=self.tp_devices)

    # -- geometry (splice_tpu/models/extractor.py:105-130); NHWC shapes --
    def get_patch_size(self) -> int:
        return self.cfg.patch_size

    def get_width_patch_num(self, input_shape) -> int:
        return input_shape[-2] // self.cfg.patch_size

    def get_height_patch_num(self, input_shape) -> int:
        return input_shape[-3] // self.cfg.patch_size

    def get_patch_num(self, input_shape) -> int:
        """CLS and the patches, as the reference counts them (a _reg
        model's tokens hold its registers too)."""
        return 1 + (self.get_height_patch_num(input_shape)
                    * self.get_width_patch_num(input_shape))

    def get_head_num(self) -> int:
        return self.cfg.num_heads

    def get_embedding_dim(self) -> int:
        return self.cfg.embed_dim

    # -- feature accessors (:81-87, :132-163) --
    def _every_block(self, images, kind: str) -> List[torch.Tensor]:
        out = self.run(images, {kind: tuple(range(self.cfg.depth))})
        return [out[kind][i] for i in range(self.cfg.depth)]

    def get_feature_from_input(self, images) -> List[torch.Tensor]:
        """Every block's output (pre final norm), [B, N, D] each."""
        return self._every_block(images, "block")

    def get_qkv_feature_from_input(self, images) -> List[torch.Tensor]:
        return self._every_block(images, "qkv")

    def get_attn_feature_from_input(self, images) -> List[torch.Tensor]:
        """Every block's fp32 attention probabilities, [B, H, N, N] each."""
        return self._every_block(images, "attn_probs")

    def get_keys_from_input(self, images, layer_num: int) -> torch.Tensor:
        """Keys of one layer, [B, H, N, dh] (the reference's [H, N, dh]
        with the batch axis kept)."""
        out = self.run(images, {"qkv": (layer_num,)})
        return keys_from_qkv(out["qkv"][layer_num], self.cfg.num_heads)

    def get_keys_self_sim_from_input(self, images,
                                     layer_num: int) -> torch.Tensor:
        """[B, N, N]: every token, registers included."""
        return keys_self_sim(self.get_keys_from_input(images, layer_num))

    def get_cls_token_from_input(self, images) -> torch.Tensor:
        """The last block's CLS token, [B, D]."""
        last = self.cfg.depth - 1
        return self.run(images, {"block": (last,)})["block"][last][:, 0, :]


def make_extractor(model_name: str, params: Optional[Dict[str, Any]] = None,
                   seed: int = 0,
                   compute_dtype: torch.dtype = torch.float32,
                   device=None, use_pallas: bool = True) -> VitExtractor:
    """The reference's make_extractor (:154-164): `params`, or the seeded
    random init on `device` (default CUDA)."""
    cfg = vit_lib.get_vit_config(model_name)
    if params is None:
        params = init_vit_params(cfg, seed, resolve_device(device))
    return VitExtractor(params=params, cfg=cfg, model_name=model_name,
                        compute_dtype=compute_dtype, use_pallas=use_pallas)
