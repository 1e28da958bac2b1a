"""DIP-style skip U-Net generator in [B, C, H, W] (port of
splice_tpu/models/unet.py:29-63,82-135,297-475,620-805).

Parameters are a nested dict with the reference's names and layouts (conv
kernels [kh, kw, Cin, Cout]). flatten_params orders the leaves exactly as
jax.flatten_util.ravel_pytree does (dict keys sorted, lists in order), so
the trainer's one flat fp32 parameter vector matches the reference's
element for element.

BatchNorm is train-mode with no running statistics (the reference never
evaluates the generator in eval mode). `groups` splits the batch into
stacks that keep their own statistics: the trainer runs the A and B crop
stacks as one batch of 2 with BN per stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from splice_tpu_torch import resolve_device
from splice_tpu_torch.ops.conv import kernel_conv_chw
from splice_tpu_torch.utils.tree import tree_map

# Per-site dispatch: stride-1 k>=3 convs at least this wide with Cin > 16 go to
# the hand-written conv kernel (the reference's PALLAS_MIN_WIDTH rule).
KERNEL_MIN_WIDTH = 448


@dataclasses.dataclass(frozen=True)
class SkipConfig:
    """The reference skip() signature, restricted to what the port runs:
    stride downsampling, LeakyReLU or no activation."""
    num_input_channels: int = 3
    num_output_channels: int = 3
    channels_down: Tuple[int, ...] = (16, 32, 64, 128, 128)
    channels_up: Tuple[int, ...] = (16, 32, 64, 128, 128)
    channels_skip: Tuple[int, ...] = (4, 4, 4, 4, 4)
    filter_size_down: Union[int, Tuple[int, ...]] = 3
    filter_size_up: Union[int, Tuple[int, ...]] = 3
    filter_skip_size: int = 1
    need_sigmoid: bool = True
    need_tanh: bool = False
    need_bias: bool = True
    pad: str = "zero"                 # zero | reflection
    upsample_mode: str = "bilinear"   # bilinear | nearest
    act_fun: str = "LeakyReLU"        # LeakyReLU | none
    need1x1_up: bool = True

    def __post_init__(self):
        if not (len(self.channels_down) == len(self.channels_up)
                == len(self.channels_skip)):
            raise ValueError("channel lists differ in length")
        if self.act_fun not in ("LeakyReLU", "none"):
            raise NotImplementedError(f"act_fun {self.act_fun!r} not ported")

    @property
    def n_scales(self) -> int:
        return len(self.channels_down)

    def fdown(self, i: int) -> int:
        f = self.filter_size_down
        return f[i] if isinstance(f, (tuple, list)) else f

    def fup(self, i: int) -> int:
        f = self.filter_size_up
        return f[i] if isinstance(f, (tuple, list)) else f


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def act(x: torch.Tensor, act_fun: str) -> torch.Tensor:
    return F.leaky_relu(x, 0.2) if act_fun == "LeakyReLU" else x


def conv2d_chw(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1,
               pad: str = "zero") -> torch.Tensor:
    """The plain conv: torch (k-1)//2 zero or reflection padding, then
    F.conv2d (XLA's conv in the reference), bias added after."""
    w = p["kernel"]
    to_pad = (w.shape[0] - 1) // 2
    if to_pad > 0:
        mode = "reflect" if pad == "reflection" else "constant"
        x = F.pad(x, (to_pad, to_pad, to_pad, to_pad), mode=mode)
    out = F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride)
    if "bias" in p:
        out = out + p["bias"].to(out.dtype)[:, None, None]
    return out


def upsample2x_chw(x: torch.Tensor, method: str) -> torch.Tensor:
    """2x upsample with half-pixel centers (align_corners=False)."""
    if method == "nearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def batch_norm_chw(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   groups: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm over (B, H, W) of each of `groups` equal batch
    slices: single-pass fp32 statistics (mean and E[x^2]), then one affine
    pass in x's dtype."""
    B, C, H, W = x.shape
    xs = x.reshape(groups, B // groups, C, H, W)
    mean = xs.mean(dim=(1, 3, 4), dtype=torch.float32)             # [G, C]
    ex2 = torch.square(xs.float()).mean(dim=(1, 3, 4))
    var = torch.clamp(ex2 - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + eps) * p["scale"].float()
    shift = p["bias"].float() - mean * inv
    y = xs * inv.to(x.dtype)[:, None, :, None, None] \
        + shift.to(x.dtype)[:, None, :, None, None]
    return y.reshape(B, C, H, W)


def _center_crop_cat(branches: List[torch.Tensor]) -> torch.Tensor:
    th = min(t.shape[2] for t in branches)
    tw = min(t.shape[3] for t in branches)
    out = []
    for t in branches:
        y0, x0 = (t.shape[2] - th) // 2, (t.shape[3] - tw) // 2
        out.append(t[:, :, y0:y0 + th, x0:x0 + tw])
    return torch.cat(out, dim=1)


def skip_apply_chw(params: Dict[str, Any], cfg: SkipConfig,
                   x_nhwc: torch.Tensor, compute_dtype=None,
                   groups: int = 1) -> torch.Tensor:
    """Generator forward: [B, H, W, Cin] in [0, 1] -> [B, H', W', Cout]
    fp32, computed in CHW.

    Convs follow the reference's per-site dispatch
    (splice_tpu/models/unet.py:650-667): on CUDA tensors, stride-1 k>=3
    convs at least KERNEL_MIN_WIDTH wide with Cin > 16 go to
    kernel_conv_chw (kernels K3/K4); every other conv, and every conv of a
    CPU tensor, is conv2d_chw.
    groups: batch stacks with their own BatchNorm statistics."""
    use_kernel = x_nhwc.is_cuda

    def conv_fn(x, p, stride=1):
        k = p["kernel"].shape[0]
        if (use_kernel and stride == 1 and k >= 3
                and x.shape[3] >= KERNEL_MIN_WIDTH and x.shape[1] > 16):
            return kernel_conv_chw(x, p, cfg.pad)
        return conv2d_chw(x, p, stride, cfg.pad)

    def bn(x, p):
        return batch_norm_chw(x, p, groups)

    x = x_nhwc.permute(0, 3, 1, 2)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    n = cfg.n_scales

    def scale_fn(i: int, xin: torch.Tensor) -> torch.Tensor:
        sp = params["scales"][i]
        branches = []
        if cfg.channels_skip[i]:
            s = conv_fn(xin, sp["skip_conv"])
            branches.append(act(bn(s, sp["skip_bn"]), cfg.act_fun))
        d = conv_fn(xin, sp["down_conv1"], 2)
        d = act(bn(d, sp["down_bn1"]), cfg.act_fun)
        d = conv_fn(d, sp["down_conv2"])
        d = act(bn(d, sp["down_bn2"]), cfg.act_fun)
        inner = scale_fn(i + 1, d) if i < n - 1 else d
        branches.append(upsample2x_chw(inner, cfg.upsample_mode))
        y = bn(_center_crop_cat(branches), sp["post_bn"])
        y = act(bn(conv_fn(y, sp["up_conv"]), sp["up_bn"]), cfg.act_fun)
        if cfg.need1x1_up:
            y = act(bn(conv_fn(y, sp["up1x1_conv"]), sp["up1x1_bn"]),
                    cfg.act_fun)
        return y

    y = conv_fn(scale_fn(0, x), params["out_conv"]).float()
    if cfg.need_sigmoid:
        y = torch.sigmoid(y)
    elif cfg.need_tanh:
        y = torch.tanh(y)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Init (reference networks.py:24-53 semantics) and the flat vector
# ---------------------------------------------------------------------------

def init_skip_params(cfg: SkipConfig, init_gain: float = 0.02,
                     seed: int = 0, device=None) -> Dict[str, Any]:
    """Seeded xavier init: conv kernels N(0, gain^2 * 2 / (fan_in +
    fan_out)), conv biases 0, BN scale N(1, gain^2), BN bias 0. Drawn on
    the CPU so a seed gives the same weights on every device; then moved
    to `device` (default CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def conv(k, cin, cout):
        std = init_gain * float(np.sqrt(2.0 / ((cin + cout) * k * k)))
        p = {"kernel": std * torch.randn((k, k, cin, cout), generator=gen)}
        if cfg.need_bias:
            p["bias"] = torch.zeros(cout)
        return p

    def bn(c):
        return {"scale": 1.0 + init_gain * torch.randn(c, generator=gen),
                "bias": torch.zeros(c)}

    n = cfg.n_scales
    scales: List[Dict[str, Any]] = []
    in_ch = cfg.num_input_channels
    for i in range(n):
        cd, cu, cs = (cfg.channels_down[i], cfg.channels_up[i],
                      cfg.channels_skip[i])
        k_inner = cd if i == n - 1 else cfg.channels_up[i + 1]
        sp: Dict[str, Any] = {}
        if cs:
            sp["skip_conv"] = conv(cfg.filter_skip_size, in_ch, cs)
            sp["skip_bn"] = bn(cs)
        sp["down_conv1"] = conv(cfg.fdown(i), in_ch, cd)
        sp["down_bn1"] = bn(cd)
        sp["down_conv2"] = conv(cfg.fdown(i), cd, cd)
        sp["down_bn2"] = bn(cd)
        sp["post_bn"] = bn(cs + k_inner)
        sp["up_conv"] = conv(cfg.fup(i), cs + k_inner, cu)
        sp["up_bn"] = bn(cu)
        if cfg.need1x1_up:
            sp["up1x1_conv"] = conv(1, cu, cu)
            sp["up1x1_bn"] = bn(cu)
        scales.append(sp)
        in_ch = cd
    tree = {"scales": scales,
            "out_conv": conv(1, cfg.channels_up[0], cfg.num_output_channels)}
    return tree_map(lambda t: t.to(device), tree)


def _leaves(tree: Any, path: Tuple = ()):
    """(path, leaf) in ravel_pytree order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def flatten_params(tree: Any) -> Tuple[torch.Tensor, list]:
    """Tree -> (flat fp32 vector, spec) in ravel_pytree order."""
    leaves = list(_leaves(tree))
    flat = torch.cat([t.reshape(-1).float() for _, t in leaves])
    spec = [(path, tuple(t.shape)) for path, t in leaves]
    return flat, spec


def unflatten_params(flat: torch.Tensor, spec: list) -> Dict[str, Any]:
    """Flat vector -> tree of views into it (gradients flow to `flat`)."""
    tree: Dict[Any, Any] = {}
    off = 0
    for path, shape in spec:
        n = int(np.prod(shape)) if shape else 1
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[off:off + n].view(shape)
        off += n
    return _lists(tree)


def _lists(node: Any) -> Any:
    """Dicts keyed 0..n-1 (from list paths) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def param_count(tree: Any) -> int:
    return sum(int(np.prod(t.shape)) for _, t in _leaves(tree))
