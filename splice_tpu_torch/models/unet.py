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
stacks as one batch of 2 with BN per stack (the reference's vmap over
stacks).

skip_apply_chw runs the reference's four generator_conv modes; see there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from splice_tpu_torch import resolve_device
from splice_tpu_torch.config import GENERATOR_CONVS
from splice_tpu_torch.ops import conv as conv_ops
from splice_tpu_torch.ops.conv import (kernel_conv_bn_act_chw,
                                        kernel_conv_chw, split_stacks,
                                        stack_sums, wide)
from splice_tpu_torch.utils.tree import tree_map

# The "auto" per-site rule: stride-1 k>=3 convs at least this wide with
# Cin > 16 go to the hand-written conv kernel (the reference's
# PALLAS_MIN_WIDTH rule); "fused" routes a BatchNorm consumer to the
# prologue kernel from this operating width on (stride 2 halves it).
KERNEL_MIN_WIDTH = 448
# Test hook (the reference's, splice_tpu/models/unet.py:243): route every
# site of generator_conv="fused" on CPU tensors as the card routes its wide
# sites, so the plain versions of the prologue kernels run there.
FORCE_FUSED_KERNELS_ON_CPU = False


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


def _affine(mean, ex2, p, eps):
    var = torch.clamp(ex2 - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + eps) * wide(p["scale"])
    return inv, wide(p["bias"]) - mean * inv


def bn_affine_chw(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  groups: int = 1, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of each of `groups` equal batch slices as fp32
    (float64 for float64 x) (scale, shift) rows [groups, C]: single-pass
    statistics (mean and E[x^2] over B, H, W of the slice)."""
    xs = split_stacks(x, groups)
    mean = xs.mean(dim=(1, 3, 4), dtype=torch.promote_types(x.dtype,
                                                            torch.float32))
    ex2 = torch.square(wide(xs)).mean(dim=(1, 3, 4))
    return _affine(mean, ex2, p, eps)


def bn_affine_from_sums(s1: torch.Tensor, s2: torch.Tensor, count: int,
                        p: Dict[str, torch.Tensor], eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bn_affine_chw from per-stack fp32 sums of x and x^2 over `count`
    pixels each (the reference's :420-434)."""
    return _affine(s1 / count, s2 / count, p, eps)


def apply_affine(x: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """x * scale + shift with one [C] row per batch stack, in x's dtype."""
    xs = split_stacks(x, scale.shape[0])
    y = xs * scale.to(x.dtype)[:, None, :, None, None] \
        + shift.to(x.dtype)[:, None, :, None, None]
    return y.reshape(x.shape)


def batch_norm_chw(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   groups: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm over (B, H, W) of each of `groups` equal batch
    slices: single-pass fp32 statistics, then one affine pass in x's
    dtype."""
    return apply_affine(x, *bn_affine_chw(x, p, groups, eps))


def _center_crop_cat(branches: List[torch.Tensor]) -> torch.Tensor:
    th = min(t.shape[2] for t in branches)
    tw = min(t.shape[3] for t in branches)
    out = []
    for t in branches:
        y0, x0 = (t.shape[2] - th) // 2, (t.shape[3] - tw) // 2
        out.append(t[:, :, y0:y0 + th, x0:x0 + tw])
    return torch.cat(out, dim=1)


def _auto_conv(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int,
               pad: str, use_kernel: bool) -> torch.Tensor:
    """The reference's per-site dispatch (splice_tpu/models/unet.py:650-667):
    stride-1 k>=3 convs at least KERNEL_MIN_WIDTH wide with Cin > 16 go to
    kernel_conv_chw, every other conv to conv2d_chw."""
    k = p["kernel"].shape[0]
    if (use_kernel and stride == 1 and k >= 3
            and x.shape[3] >= KERNEL_MIN_WIDTH and x.shape[1] > 16):
        return kernel_conv_chw(x, p, 1, pad)
    return conv2d_chw(x, p, stride, pad)


def _forward(params, cfg: SkipConfig, x: torch.Tensor, groups: int,
             conv_fn) -> torch.Tensor:
    """The skip U-Net with every BatchNorm applied where it stands; returns
    the out_conv output."""
    def bn(t, p):
        return batch_norm_chw(t, p, groups)

    def scale_fn(i: int, xin: torch.Tensor) -> torch.Tensor:
        sp = params["scales"][i]
        branches = []
        if cfg.channels_skip[i]:
            s = conv_fn(xin, sp["skip_conv"], 1)
            branches.append(act(bn(s, sp["skip_bn"]), cfg.act_fun))
        d = conv_fn(xin, sp["down_conv1"], 2)
        d = act(bn(d, sp["down_bn1"]), cfg.act_fun)
        d = conv_fn(d, sp["down_conv2"], 1)
        d = act(bn(d, sp["down_bn2"]), cfg.act_fun)
        inner = scale_fn(i + 1, d) if i < cfg.n_scales - 1 else d
        branches.append(upsample2x_chw(inner, cfg.upsample_mode))
        y = bn(_center_crop_cat(branches), sp["post_bn"])
        y = act(bn(conv_fn(y, sp["up_conv"], 1), sp["up_bn"]), cfg.act_fun)
        if cfg.need1x1_up:
            y = act(bn(conv_fn(y, sp["up1x1_conv"], 1), sp["up1x1_bn"]),
                    cfg.act_fun)
        return y

    return conv_fn(scale_fn(0, x), params["out_conv"], 1)


def _fused_forward(params, cfg: SkipConfig, x: torch.Tensor, groups: int,
                   use_kernels: bool) -> torch.Tensor:
    """Port of _skip_apply_chw_fused (splice_tpu/models/unet.py:476-617):
    deferred BatchNorm. Every conv consumes its producer's RAW output plus
    the BN (scale, shift) rows, and where the site is wide enough
    (fuse_worthwhile) the normalise + activate runs in the conv kernel's
    input read (kernel_conv_bn_act_chw: K3'/K4' pro) and the normalised
    tensor is never stored. Elsewhere the pending BN is materialised and
    the conv takes the auto rule. post_bn's statistics come from per-branch
    sums. All statistics are per stack ([groups, C]). With
    conv_ops.SAME_BORDER_KERNELS on (read at call time), the fused 3x3
    stride-1 sites that feed a BatchNorm (down_conv2, up_conv) take their
    statistics from the conv itself (K3''', pend_conv and :588-600).
    Returns the out_conv output."""
    negslope = {"LeakyReLU": 0.2, "none": 1.0}[cfg.act_fun]

    def fuse_worthwhile(t, stride):
        hw = t.shape[3] // (2 if stride == 2 else 1)
        return use_kernels and (hw >= KERNEL_MIN_WIDTH
                                or FORCE_FUSED_KERNELS_ON_CPU)

    def conv_plain(t, p, stride):
        return _auto_conv(t, p, stride, cfg.pad, use_kernels)

    def materialize(src):
        if not isinstance(src, tuple):
            return src
        raw, sc, sh = src
        return act(apply_affine(raw, sc, sh), cfg.act_fun)

    def pend(raw, bn_p):
        return (raw, *bn_affine_chw(raw, bn_p, groups))

    def conv_from(src, p, stride):
        """src: raw tensor, or (raw, scale, shift) pending BN + act."""
        if isinstance(src, tuple):
            raw, sc, sh = src
            if fuse_worthwhile(raw, stride):
                return kernel_conv_bn_act_chw(raw, p, sc, sh, stride,
                                              cfg.pad, negslope)
            return conv_plain(materialize(src), p, stride)
        return conv_plain(src, p, stride)

    def same_stats(k):
        return (k > 1 and cfg.pad != "reflection"
                and conv_ops.SAME_BORDER_KERNELS)

    def pend_with_stats(src, p, bn_p, ns):
        """The fused SAME conv of a pending src, its BatchNorm pending from
        the kernel's own per-stack sums over (B/G)*H*W pixels each."""
        raw, sc, sh = src
        out, s1, s2 = kernel_conv_bn_act_chw(raw, p, sc, sh, 1, cfg.pad, ns,
                                             True)
        count = out.shape[0] // groups * out.shape[2] * out.shape[3]
        return (out, *bn_affine_from_sums(s1, s2, count, bn_p))

    def pend_conv(src, p, stride, bn_p):
        """Port of pend_conv (:536-552): conv then a pending BN, the
        statistics from the conv where the site takes the fused SAME
        kernel."""
        if (isinstance(src, tuple) and stride == 1
                and same_stats(p["kernel"].shape[0])
                and fuse_worthwhile(src[0], stride)):
            return pend_with_stats(src, p, bn_p, negslope)
        return pend(conv_from(src, p, stride), bn_p)

    def scale_fn(i: int, xin):
        """xin: raw tensor or pending; returns a pending (raw, sc, sh)."""
        sp = params["scales"][i]
        branches = []
        if cfg.channels_skip[i]:
            s_raw = conv_from(xin, sp["skip_conv"], 1)
            branches.append(materialize(pend(s_raw, sp["skip_bn"])))
        d1 = pend(conv_from(xin, sp["down_conv1"], 2), sp["down_bn1"])
        d2 = pend_conv(d1, sp["down_conv2"], 1, sp["down_bn2"])
        inner = scale_fn(i + 1, d2) if i < cfg.n_scales - 1 else d2
        branches.append(upsample2x_chw(materialize(inner),
                                       cfg.upsample_mode))
        y = _center_crop_cat(branches)
        # post_bn has no activation: an affine-only prologue (negslope 1)
        # into the up conv. Its statistics are channel sums (the
        # reference's per-branch sums, concatenated, are the same numbers).
        count = y.shape[0] // groups * y.shape[2] * y.shape[3]
        pb_sc, pb_sh = bn_affine_from_sums(*stack_sums(y, groups), count,
                                           sp["post_bn"])
        if not fuse_worthwhile(y, 1):
            y1p = pend(conv_plain(apply_affine(y, pb_sc, pb_sh),
                                  sp["up_conv"], 1), sp["up_bn"])
        elif same_stats(sp["up_conv"]["kernel"].shape[0]):
            y1p = pend_with_stats((y, pb_sc, pb_sh), sp["up_conv"],
                                  sp["up_bn"], 1.0)
        else:
            y1p = pend(kernel_conv_bn_act_chw(y, sp["up_conv"], pb_sc, pb_sh,
                                              1, cfg.pad, 1.0), sp["up_bn"])
        if not cfg.need1x1_up:
            return y1p
        return pend(conv_from(y1p, sp["up1x1_conv"], 1), sp["up1x1_bn"])

    return conv_from(scale_fn(0, x), params["out_conv"], 1)


def skip_apply_chw(params: Dict[str, Any], cfg: SkipConfig,
                   x_nhwc: torch.Tensor, compute_dtype=None,
                   groups: int = 1, conv_impl: str = "auto") -> torch.Tensor:
    """Generator forward: [B, H, W, Cin] in [0, 1] -> [B, H', W', Cout]
    fp32, computed in CHW. groups: batch stacks with their own BatchNorm
    statistics.

    conv_impl (the config's generator_conv), as in the reference
    (splice_tpu/models/unet.py:620-669):
      * "auto": the per-site rule (_auto_conv) on CUDA tensors; every conv
        of a CPU tensor is conv2d_chw;
      * "xla": every conv is conv2d_chw (F.conv2d; XLA's conv in the
        reference);
      * "pallas": every conv is kernel_conv_chw (K3/K4; stride 2 through
        their space-to-depth forms, 1x1 at k = 1);
      * "fused": deferred BatchNorm through the prologue kernels
        (_fused_forward). The reference falls back to "auto" for
        activations the prologue lacks; SkipConfig admits only
        LeakyReLU and none, which it has.
    On CPU tensors the kernel routes run their plain versions."""
    if conv_impl not in GENERATOR_CONVS:
        raise ValueError(f"conv_impl {conv_impl!r}; one of {GENERATOR_CONVS}")
    x = x_nhwc.permute(0, 3, 1, 2)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if conv_impl == "fused":
        y = _fused_forward(params, cfg, x, groups,
                           x.is_cuda or FORCE_FUSED_KERNELS_ON_CPU)
    else:
        def conv_fn(t, p, stride):
            if conv_impl == "xla":
                return conv2d_chw(t, p, stride, cfg.pad)
            if conv_impl == "pallas":
                return kernel_conv_chw(t, p, stride, cfg.pad)
            return _auto_conv(t, p, stride, cfg.pad, t.is_cuda)
        y = _forward(params, cfg, x, groups, conv_fn)
    y = y.float()
    if cfg.need_sigmoid:
        y = torch.sigmoid(y)
    elif cfg.need_tanh:
        y = torch.tanh(y)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Init (reference networks.py:24-53 semantics) and the flat vector
# ---------------------------------------------------------------------------

def _conv_kernel(shape: Tuple[int, int, int, int], init_type: str,
                 gain: float, gen: torch.Generator) -> torch.Tensor:
    """A [kh, kw, cin, cout] conv kernel by the reference's rule
    (splice_tpu/models/unet.py:717-751, torch's init semantics)."""
    kh, kw, cin, cout = shape
    fan_in, fan_out = cin * kh * kw, cout * kh * kw
    if init_type == "normal":
        return gain * torch.randn(shape, generator=gen)
    if init_type == "xavier":
        std = gain * float(np.sqrt(2.0 / (fan_in + fan_out)))
        return std * torch.randn(shape, generator=gen)
    if init_type == "kaiming":
        return float(np.sqrt(2.0 / fan_in)) * torch.randn(shape,
                                                          generator=gen)
    if init_type == "orthogonal":
        # torch.nn.init.orthogonal_: rows = cout, cols = fan_in; a wide
        # matrix (cout < fan_in) orthogonalises its transpose, so the
        # reduced QR always has enough columns (the 1x1 skip conv, cin 3
        # and cout 4, is tall). Signs from the diagonal of R.
        rows, cols = cout, fan_in
        q, r = torch.linalg.qr(torch.randn((max(rows, cols), min(rows, cols)),
                                           generator=gen))
        q = q * torch.sign(torch.diagonal(r))
        mat = q if rows >= cols else q.T                  # [cout, fan_in]
        # torch fills weight.view(cout, cin * kh * kw)
        return gain * mat.reshape(cout, cin, kh, kw).permute(2, 3, 1, 0)
    raise ValueError(f"init_type {init_type!r}")


def init_skip_params(cfg: SkipConfig, init_gain: float = 0.02,
                     seed: int = 0, device=None,
                     init_type: str = "xavier") -> Dict[str, Any]:
    """Seeded init (reference networks.py:24-53 semantics): conv kernels by
    `init_type` (normal N(0, gain^2); xavier N(0, gain^2 * 2 / (fan_in +
    fan_out)); kaiming N(0, 2 / fan_in); orthogonal, scaled by gain), conv
    biases 0, BN scale N(1, gain^2), BN bias 0. Drawn on the CPU so a seed
    gives the same weights on every device; then moved to `device`
    (default CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def conv(k, cin, cout):
        p = {"kernel": _conv_kernel((k, k, cin, cout), init_type, init_gain,
                                    gen).contiguous()}
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
