"""DINO and DINOv2 Vision Transformers with feature taps (port of
splice_tpu/models/vit.py).

Parameters are a plain nested dict with the reference's names and layouts
(dense kernels [in, out], the patch-embed kernel HWIO [P, P, 3, D]), so a
parameter tree moves between the two packages as numpy arrays unchanged
(models/weights.py). The patch-embed conv and the dense layers are torch
ops (XLA in the reference); attention is ops.attention.attention_from_qkv,
routed as the reference routes it: kernels K1/K2 on the fused qkv up to
2048 tokens, K5/K6 on split heads above (the 480-px loss resolution). A
block tapped for "attn_probs" builds its fp32 probabilities explicitly and
takes its output from them, as the reference's does, and launches no
attention kernel.

DINOv2 (dinov2_vit{b,l}14[_reg]) adds layer scale (ls1, ls2: per-channel
factors on each residual branch) and, in the _reg variants, four register
tokens inserted between CLS and the patches after the position-embedding
add, with no position embedding of their own.

The frozen weights carry requires_grad=False, so autograd computes only the
input cotangent. There is no remat: an 80 GB card holds the activations.

Tensor parallelism (the reference's manual tp, :222-466): vit_forward takes
one parameter tree per rank (parallel.mesh.shard_vit_params) and their
devices; each block runs a rank's heads and MLP slice on its device and
adds the row-parallel partial sums on the first. use_pallas=False runs
attention without the port's kernels (the reference's XLA ablation).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from splice_tpu_torch.ops.attention import _split_heads, attention_from_qkv


@dataclasses.dataclass(frozen=True)
class VitConfig:
    patch_size: int = 8
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    img_size: int = 224                 # grid the stored pos_embed was made at
    interpolate_offset: float = 0.1     # DINO's +0.1 pos-embed grid offset
    layerscale_init: Optional[float] = None   # DINOv2: 1e-5; DINO: None
    num_register_tokens: int = 0              # the DINOv2 _reg variants: 4

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def base_grid(self) -> int:
        return self.img_size // self.patch_size


def _dinov2(embed_dim: int, depth: int, num_heads: int,
            registers: int = 0) -> VitConfig:
    """A DINOv2 model: patch 14, pos_embed made at 518 px (base grid 37),
    no interpolation offset, layer scale."""
    return VitConfig(patch_size=14, embed_dim=embed_dim, depth=depth,
                     num_heads=num_heads, img_size=518,
                     interpolate_offset=0.0, layerscale_init=1e-5,
                     num_register_tokens=registers)


# The reference's models (splice_tpu/models/vit.py:59-83).
VIT_CONFIGS: Dict[str, VitConfig] = {
    "dino_vitb8": VitConfig(patch_size=8, embed_dim=768, depth=12, num_heads=12),
    "dino_vits8": VitConfig(patch_size=8, embed_dim=384, depth=12, num_heads=6),
    "dino_vitb16": VitConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "dino_vits16": VitConfig(patch_size=16, embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14": _dinov2(768, 12, 12),
    "dinov2_vitl14": _dinov2(1024, 24, 16),
    "dinov2_vitb14_reg": _dinov2(768, 12, 12, registers=4),
    "dinov2_vitl14_reg": _dinov2(1024, 24, 16, registers=4),
}


def get_vit_config(model_name: str) -> VitConfig:
    if model_name not in VIT_CONFIGS:
        raise ValueError(f"unknown ViT model {model_name!r}; "
                         f"known: {sorted(VIT_CONFIGS)}")
    return VIT_CONFIGS[model_name]


def cast_params_for_compute(params: Dict[str, Any], dtype: torch.dtype
                            ) -> Dict[str, Any]:
    """Store the large frozen weights (patch embed, attention, MLP) in the
    compute dtype; LayerNorm affines, pos_embed, cls, the register tokens
    and layer scale stay fp32."""
    out = dict(params)
    cast = {k: v.to(dtype) for k, v in params["patch_embed"].items()}
    out["patch_embed"] = cast
    out["blocks"] = [
        {**blk,
         "attn": {n: {k: v.to(dtype) for k, v in d.items()}
                  for n, d in blk["attn"].items()},
         "mlp": {n: {k: v.to(dtype) for k, v in d.items()}
                 for n, d in blk["mlp"].items()}}
        for blk in params["blocks"]]
    return out


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    return y + p["bias"].to(y.dtype)


def _layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
                eps: float) -> torch.Tensor:
    """LayerNorm in fp32, result in x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def _bicubic_resize_matrix(in_size: int, out_size: int, scale: float,
                           a: float = -0.75) -> np.ndarray:
    """[out, in] weights of torch's bicubic upsampling (a=-0.75, half-pixel
    centers, replicate borders) at DINO's scale_factor convention."""
    def k(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0
        if x < 2.0:
            return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a
        return 0.0

    W = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        s = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(s))
        t = s - i0
        for m, wgt in zip(range(i0 - 1, i0 + 3),
                          (k(1.0 + t), k(t), k(1.0 - t), k(2.0 - t))):
            W[i, min(max(m, 0), in_size - 1)] += wgt
    return W.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrix_on(in_size: int, out_size: int, scale: float,
                      device) -> torch.Tensor:
    """_bicubic_resize_matrix as a float32 tensor on `device`, made once (a
    captured training step may not copy from the host)."""
    return torch.from_numpy(_bicubic_resize_matrix(in_size, out_size,
                                                   scale)).to(device)


def interpolate_pos_embed(pos_embed: torch.Tensor, cfg: VitConfig,
                          gh: int, gw: int) -> torch.Tensor:
    """Bicubic pos-embed interpolation to a (gh, gw) grid with the model's
    grid offset (scale (g + offset) / g0: DINO's 0.1, DINOv2's 0). pos_embed
    covers CLS and the patches only. Returns [1, 1 + gh*gw, D]."""
    g0 = cfg.base_grid
    if (gh, gw) == (g0, g0):
        return pos_embed
    prefix, patch = pos_embed[:, :1], pos_embed[:, 1:]
    D = pos_embed.shape[-1]
    patch = patch.reshape(g0, g0, D).float()
    dev = pos_embed.device
    wy = _resize_matrix_on(g0, gh, (gh + cfg.interpolate_offset) / g0, dev)
    wx = _resize_matrix_on(g0, gw, (gw + cfg.interpolate_offset) / g0, dev)
    out = torch.einsum("oi,iwd->owd", wy, patch)
    out = torch.einsum("oj,hjd->hod", wx, out)
    out = out.reshape(1, gh * gw, D).to(pos_embed.dtype)
    return torch.cat([prefix, out], dim=1)


def _attend(qkv: torch.Tensor, num_heads: int, head_dim: int,
            want_probs: bool, use_pallas: bool, dtype: torch.dtype):
    """Attention over qkv's heads: (o [B, N, heads * dh], the fp32
    probabilities or None). With want_probs, the reference's slow path
    (:400-425): fp32 probabilities, and the output from them, not from the
    kernel."""
    scale = head_dim ** -0.5
    if not want_probs:
        return attention_from_qkv(qkv, num_heads, scale,
                                  use_pallas=use_pallas), None
    q, k, v = (t.float() for t in _split_heads(qkv, num_heads))
    probs = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    o = (probs @ v).to(dtype)
    return o.permute(0, 2, 1, 3).reshape(*qkv.shape[:2], -1), probs


def _to_ranks(t: torch.Tensor, devs: Sequence[torch.device]):
    """t on each tensor-parallel rank's device (no copy where it is
    there already)."""
    return [t.to(d) for d in devs]


def _tp_allcat(ts: Sequence[torch.Tensor], home: torch.device,
               dim: int) -> torch.Tensor:
    """The ranks' slices concatenated along dim on `home` (the reference's
    _tp_allcat, :233-249)."""
    if len(ts) == 1:
        return ts[0]
    return torch.cat([t.to(home) for t in ts], dim=dim)


def _tp_gather_qkv(qkvs: Sequence[torch.Tensor], cfg: VitConfig,
                   home: torch.device) -> torch.Tensor:
    """The full [B, N, 3D] qkv tap from the ranks' [q_l | k_l | v_l]
    slices (the reference's _tp_gather_qkv, :252-269): [B, N, 3, H/tp,
    dh] concatenated over the heads gives the reference's q | k | v
    layout."""
    if len(qkvs) == 1:
        return qkvs[0]
    B, N, _ = qkvs[0].shape
    parts = [q.reshape(B, N, 3, -1, cfg.head_dim) for q in qkvs]
    return _tp_allcat(parts, home, 3).reshape(B, N, 3 * cfg.embed_dim)


def _dense_rowparallel(xs: Sequence[torch.Tensor],
                       ps: Sequence[Dict[str, torch.Tensor]],
                       home: torch.device) -> torch.Tensor:
    """A dense whose input dim is split over the ranks (the reference's
    _dense_rowparallel, :222-230): each rank's partial product, summed on
    `home` in rank order, then the bias once. One rank is _dense."""
    y = None
    for x, p in zip(xs, ps):
        part = torch.matmul(x, p["kernel"].to(x.dtype)).to(home)
        y = part if y is None else y + part
    return y + ps[0]["bias"].to(y.dtype)


def _block(x: torch.Tensor, bps: Sequence[Dict[str, Any]], cfg: VitConfig,
           want: Sequence[str], use_pallas: bool = True,
           devs: Optional[Sequence[torch.device]] = None):
    """One pre-LN block, with layer scale where the params have ls1/ls2
    (cast to the activation's dtype at use). Returns (x_out, taps).

    bps holds one parameter tree per tensor-parallel rank and devs their
    devices (the reference's tp_manual branches, :356-466): rank r holds
    H/tp heads of qkv and a 1/tp slice of fc1 (column-parallel), the
    matching rows of proj and fc2 (row-parallel), everything else whole
    (parallel.mesh.shard_vit_params). x and the taps live on devs[0]; each
    rank computes its heads' attention and its slice of the MLP, and the
    row-parallel partial sums meet on devs[0]. One rank is the plain
    block."""
    devs = devs or [x.device]
    home, bp0, tp = devs[0], bps[0], len(bps)
    taps = {}
    hs = _to_ranks(_layer_norm(x, bp0["norm1"], cfg.ln_eps), devs)
    qkvs = [_dense(h, bp["attn"]["qkv"]) for h, bp in zip(hs, bps)]
    if "qkv" in want:
        taps["qkv"] = _tp_gather_qkv(qkvs, cfg, home)
    outs = []
    for qkv, d in zip(qkvs, devs):
        # the attention kernels launch on the current device's context
        with torch.cuda.device(d) if tp > 1 and d.type == "cuda" \
                else contextlib.nullcontext():
            outs.append(_attend(qkv, cfg.num_heads // tp, cfg.head_dim,
                                "attn_probs" in want, use_pallas, x.dtype))
    if "attn_probs" in want:
        taps["attn_probs"] = _tp_allcat([p for _, p in outs], home, 1)
    o = _dense_rowparallel([o for o, _ in outs],
                           [bp["attn"]["proj"] for bp in bps], home)
    if "attn_out" in want:
        taps["attn_out"] = o
    if "ls1" in bp0:
        o = o * bp0["ls1"].to(o.dtype)
    x = x + o
    hs = _to_ranks(_layer_norm(x, bp0["norm2"], cfg.ln_eps), devs)
    hs = [F.gelu(_dense(h, bp["mlp"]["fc1"]), approximate="none")
          for h, bp in zip(hs, bps)]
    h = _dense_rowparallel(hs, [bp["mlp"]["fc2"] for bp in bps], home)
    if "ls2" in bp0:
        h = h * bp0["ls2"].to(h.dtype)
    x = x + h
    if "block" in want:
        taps["block"] = x
    return x, taps


def vit_forward(params: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
                images: torch.Tensor, cfg: VitConfig,
                taps: Dict[str, Sequence[int]],
                compute_dtype: torch.dtype = torch.float32,
                final_norm: bool = False, use_pallas: bool = True,
                devices: Optional[Sequence[torch.device]] = None
                ) -> Dict[str, Dict[int, torch.Tensor]]:
    """Run the ViT on [B, H, W, 3] ImageNet-normalised images and return the
    requested taps, e.g. {"qkv": [11], "block": [11]}: "qkv" is the fused
    [B, N, 3D] projection, "block" the [B, N, D] block output (pre final
    norm), "attn_out" the [B, N, D] attention branch after proj (before
    layer scale), "attn_probs" the fp32 [B, H, N, N] probabilities.
    final_norm adds {"final": {-1: LN(x)}}. N counts CLS, the register
    tokens and the patches, in that order. use_pallas=False runs attention
    without the port's kernels (ops.attention.library_attention).

    Tensor parallelism (the reference's tp_manual, :469-): `params` is a
    list of per-rank trees (parallel.mesh.shard_vit_params) and `devices`
    their devices; the images and the taps are on devices[0]. Gradients
    flow back through the copies between devices by autograd."""
    ranks = list(params) if isinstance(params, (list, tuple)) else [params]
    devs = list(devices) if devices else [images.device]
    params = ranks[0]
    B, H, W, _ = images.shape
    P = cfg.patch_size
    gh, gw = H // P, W // P
    x = F.conv2d(images.permute(0, 3, 1, 2).to(compute_dtype),
                 params["patch_embed"]["kernel"].permute(3, 2, 0, 1)
                 .to(compute_dtype), stride=P)
    x = x + params["patch_embed"]["bias"].to(compute_dtype)[:, None, None]
    x = x.flatten(2).transpose(1, 2)                       # [B, gh*gw, D]
    cls = params["cls_token"].to(compute_dtype).expand(B, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(params["pos_embed"], cfg, gh, gw
                                  ).to(compute_dtype)
    if cfg.num_register_tokens:
        # after the pos-add, between CLS and the patches (:508-515)
        reg = params["register_tokens"].to(compute_dtype).expand(
            B, cfg.num_register_tokens, cfg.embed_dim)
        x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    max_layer = max((max(v) for v in taps.values() if len(v)),
                    default=cfg.depth - 1)
    if final_norm:
        max_layer = cfg.depth - 1
    out: Dict[str, Dict[int, torch.Tensor]] = {k: {} for k in taps}
    for i in range(max_layer + 1):
        want = tuple(k for k, layers in taps.items() if i in layers)
        x, btaps = _block(x, [r["blocks"][i] for r in ranks], cfg, want,
                          use_pallas, devs)
        for k, v in btaps.items():
            out[k][i] = v
    if final_norm:
        out["final"] = {-1: _layer_norm(x, params["norm"], cfg.ln_eps)}
    return out
