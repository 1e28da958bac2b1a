"""ViT weights for the port (port of splice_tpu/models/weights.py).

Four sources of one parameter tree (the reference's names and layouts):
  * vit_params_from_numpy: the JAX package's tree as numpy arrays;
  * load_vit_npz: the .npz that splice_tpu's save_vit_params writes
    (flat keys "blocks.3.attn.qkv.kernel", ...), which save_vit_params
    here writes too;
  * port_dino_state_dict: a facebookresearch/dino or dinov2 torch state
    dict;
  * init_vit_params: seeded random init when no weights are given.
DINOv2 trees carry blocks.{i}.ls1/ls2 (layer scale) and, in the _reg
variants, register_tokens [1, R, D].
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from splice_tpu_torch import resolve_device
from splice_tpu_torch.models.vit import (VIT_CONFIGS, VitConfig,
                                         get_vit_config)
from splice_tpu_torch.utils.tree import tree_map


def vit_params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts/lists of arrays -> the same structure of float32
    tensors on `device` (None: the CPU, as torch.tensor)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), tree)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of the reference's _flatten: dotted keys, list entries
    indexed by an integer path element."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            if isinstance(node, list):
                part = int(part)
                while len(node) <= part:
                    node.append({})
                node = node[part]
                continue
            if part not in node:
                node[part] = [] if nxt.isdigit() else {}
            node = node[part]
        node[parts[-1]] = value
    return root


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """The reference's _flatten: dotted keys, a list entry's index as a
    path element."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, name + "."))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                flat.update(_flatten(item, f"{name}.{i}."))
        else:
            flat[name] = (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
    return flat


def save_vit_params(path: str, params: Dict[str, Any],
                    model_name: str) -> int:
    """Write the tree as splice_tpu's save_vit_params does (flat keys and
    __model_name__), so that either package reads it. Returns the number
    of parameters written."""
    flat = _flatten(params)
    n = sum(v.size for v in flat.values())
    flat["__model_name__"] = np.asarray(model_name)
    np.savez(path, **flat)
    return n


def _check_registers(has_registers: bool, cfg: VitConfig, what: str) -> None:
    """The reference's refusal of a checkpoint whose register tokens do not
    match the model (splice_tpu/models/weights.py:56-64,128-134): running a
    ViT on a token layout it was not trained on would go unnoticed."""
    if has_registers != bool(cfg.num_register_tokens):
        raise ValueError(
            f"register-token mismatch: {what} "
            f"{'has' if has_registers else 'lacks'} register_tokens but "
            f"the model expects {cfg.num_register_tokens}; use the matching "
            "model name (e.g. dinov2_vitb14_reg for a with-registers "
            "checkpoint)")


def load_vit_npz(path: str, model_name: Optional[str] = None,
                 device=None) -> Dict[str, Any]:
    """Read a ViT .npz written by save_vit_params (either package's) onto
    `device` (default CUDA). The model (model_name, else the one stored)
    must match the file's register tokens, where it is a registered
    model."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    stored = str(flat.pop("__model_name__")) if "__model_name__" in flat \
        else None
    if model_name and stored and model_name != stored:
        raise ValueError(f"checkpoint is for {stored}, requested {model_name}")
    name = model_name or stored
    if name in VIT_CONFIGS:
        _check_registers("register_tokens" in flat, get_vit_config(name),
                         f"checkpoint {path!r}")
    return vit_params_from_numpy(_unflatten(flat), device)


def port_dino_state_dict(state: Mapping[str, Any], cfg: VitConfig,
                         device=None) -> Dict[str, Any]:
    """facebookresearch/dino or dinov2 state dict -> parameter tree: Linear
    [out, in] -> [in, out], patch-embed conv [D, 3, p, p] -> HWIO [p, p, 3,
    D]; dinov2's blocks.{i}.ls{1,2}.gamma -> ls1/ls2 (cfg.layerscale_init
    where a layer-scale model's dict has none) and register_tokens. On
    `device` (default CUDA)."""
    device = resolve_device(device)
    s = {k: (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v, np.float32)) for k, v in state.items()}

    def ln(prefix):
        return {"scale": s[f"{prefix}.weight"], "bias": s[f"{prefix}.bias"]}

    def linear(prefix):
        return {"kernel": s[f"{prefix}.weight"].T,
                "bias": s[f"{prefix}.bias"]}

    tree: Dict[str, Any] = {
        "cls_token": s["cls_token"],
        "pos_embed": s["pos_embed"],
        "patch_embed": {
            "kernel": s["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
            "bias": s["patch_embed.proj.bias"]},
        "norm": ln("norm"),
        "blocks": [],
    }
    _check_registers("register_tokens" in s, cfg, "the state dict")
    if "register_tokens" in s:
        tree["register_tokens"] = s["register_tokens"]
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        blk = {
            "norm1": ln(f"{p}.norm1"),
            "attn": {"qkv": linear(f"{p}.attn.qkv"),
                     "proj": linear(f"{p}.attn.proj")},
            "norm2": ln(f"{p}.norm2"),
            "mlp": {"fc1": linear(f"{p}.mlp.fc1"),
                    "fc2": linear(f"{p}.mlp.fc2")},
        }
        if f"{p}.ls1.gamma" in s:
            blk["ls1"] = s[f"{p}.ls1.gamma"]
            blk["ls2"] = s[f"{p}.ls2.gamma"]
        elif cfg.layerscale_init is not None:
            blk["ls1"] = np.full(cfg.embed_dim, cfg.layerscale_init,
                                 np.float32)
            blk["ls2"] = np.full(cfg.embed_dim, cfg.layerscale_init,
                                 np.float32)
        tree["blocks"].append(blk)
    return vit_params_from_numpy(tree, device)


def init_vit_params(cfg: VitConfig, seed: int = 0,
                    device=None) -> Dict[str, Any]:
    """Seeded random init: weights ~ 0.02 * N(0,1) truncated at +-2 std,
    biases 0, LayerNorm (1, 0); layer scale at cfg.layerscale_init and the
    register tokens drawn as weights, where the model has them. Drawn on
    the CPU from a torch.Generator so a seed gives the same weights on every
    device; then moved to `device` (default CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    D, P = cfg.embed_dim, cfg.patch_size
    Hm = int(cfg.mlp_ratio * D)

    def tn(*shape):
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                                    generator=gen)
        return t

    def zeros(n):
        return torch.zeros(n)

    def ln():
        return {"scale": torch.ones(D), "bias": zeros(D)}

    tree: Dict[str, Any] = {
        "cls_token": tn(1, 1, D),
        "pos_embed": tn(1, 1 + cfg.base_grid ** 2, D),
        "patch_embed": {"kernel": tn(P, P, 3, D), "bias": zeros(D)},
        "norm": ln(),
        "blocks": [{
            "norm1": ln(),
            "attn": {"qkv": {"kernel": tn(D, 3 * D), "bias": zeros(3 * D)},
                     "proj": {"kernel": tn(D, D), "bias": zeros(D)}},
            "norm2": ln(),
            "mlp": {"fc1": {"kernel": tn(D, Hm), "bias": zeros(Hm)},
                    "fc2": {"kernel": tn(Hm, D), "bias": zeros(D)}},
        } for _ in range(cfg.depth)],
    }
    if cfg.layerscale_init is not None:
        for blk in tree["blocks"]:
            blk["ls1"] = torch.full((D,), cfg.layerscale_init)
            blk["ls2"] = torch.full((D,), cfg.layerscale_init)
    if cfg.num_register_tokens:
        tree["register_tokens"] = tn(1, cfg.num_register_tokens, D)
    return tree_map(lambda t: t.to(device), tree)


def load_or_init_vit_params(model_name: str, weights_path: Optional[str],
                            seed: int = 0, device=None) -> Dict[str, Any]:
    """.npz (JAX package format), .pth/.pt (DINO state dict), or None for
    the seeded random init, on `device` (default CUDA)."""
    device = resolve_device(device)
    cfg = get_vit_config(model_name)
    if not weights_path:
        return init_vit_params(cfg, seed, device)
    if not os.path.exists(weights_path):
        raise FileNotFoundError(f"vit_weights={weights_path!r} not found")
    if weights_path.endswith(".npz"):
        return load_vit_npz(weights_path, model_name, device)
    state = torch.load(weights_path, map_location="cpu", weights_only=True)
    return port_dino_state_dict(state, cfg, device)
