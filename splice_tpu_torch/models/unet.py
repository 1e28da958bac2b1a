"""DIP-style skip U-Net generator (port of splice_tpu/models/unet.py),
computed in [B, C, H, W] (skip_apply_chw) or in NHWC (skip_apply).

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
skip_apply is the reference's NHWC route (its generator_layout "nhwc"): the
downsamplers avg, max, lanczos2 and lanczos3, BatchNorm in the deviation
form, every conv F.conv2d on the channels_last view of the NHWC tensor (XLA's
conv in the reference). In torch NHWC is a memory format: a [B, H, W, C]
tensor permuted to NCHW is channels_last, and the conv reads it in place.
"""
from __future__ import annotations

import dataclasses
import functools
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
from splice_tpu_torch.ops.image import reflect_pad
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


ACT_FUNS = ("LeakyReLU", "Swish", "ELU", "none")
DOWNSAMPLE_MODES = ("stride", "avg", "max", "lanczos2", "lanczos3")


@dataclasses.dataclass(frozen=True)
class SkipConfig:
    """The reference skip() signature (splice_tpu/models/unet.py:29-62)."""
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
    downsample_mode: str = "stride"   # stride | avg | max | lanczos2/3
    act_fun: str = "LeakyReLU"        # LeakyReLU | Swish | ELU | none
    need1x1_up: bool = True

    def __post_init__(self):
        if not (len(self.channels_down) == len(self.channels_up)
                == len(self.channels_skip)):
            raise ValueError("channel lists differ in length")
        if self.act_fun not in ACT_FUNS:
            raise ValueError(f"act_fun {self.act_fun!r}; one of {ACT_FUNS}")
        if self.downsample_mode not in DOWNSAMPLE_MODES:
            raise ValueError(f"downsample_mode {self.downsample_mode!r}; one "
                             f"of {DOWNSAMPLE_MODES}")

    @property
    def n_scales(self) -> int:
        return len(self.channels_down)

    def fdown(self, i: int) -> int:
        f = self.filter_size_down
        return f[i] if isinstance(f, (tuple, list)) else f

    def fup(self, i: int) -> int:
        f = self.filter_size_up
        return f[i] if isinstance(f, (tuple, list)) else f


def inversion_skip_config(input_depth: int = 32) -> SkipConfig:
    """The inversion tool's 6-scale net: 7x7, 7x7, 5x5, 5x5, 3x3, 3x3
    filters with reflection padding (splice_tpu/models/unet.py:67-75)."""
    return SkipConfig(
        num_input_channels=input_depth,
        channels_down=(16, 32, 64, 128, 128, 128),
        channels_up=(16, 32, 64, 128, 128, 128),
        channels_skip=(4, 4, 4, 4, 4, 4),
        filter_size_down=(7, 7, 5, 5, 3, 3),
        filter_size_up=(7, 7, 5, 5, 3, 3),
        pad="reflection")


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def act(x: torch.Tensor, act_fun: str) -> torch.Tensor:
    """The reference's activations (splice_tpu/models/unet.py:82-92)."""
    if act_fun == "LeakyReLU":
        return F.leaky_relu(x, 0.2)
    if act_fun == "Swish":
        return x * torch.sigmoid(x)
    if act_fun == "ELU":
        return F.elu(x)
    if act_fun == "none":
        return x
    raise ValueError(act_fun)


def conv2d_chw(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1,
               pad: str = "zero") -> torch.Tensor:
    """The plain conv: torch (k-1)//2 zero or reflection padding, then
    F.conv2d (XLA's conv in the reference), bias added after."""
    w = p["kernel"]
    to_pad = (w.shape[0] - 1) // 2
    if to_pad > 0:
        x = (reflect_pad(x, to_pad) if pad == "reflection"
             else F.pad(x, (to_pad,) * 4))
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
        (_fused_forward); with an activation the prologue lacks (Swish,
        ELU) "auto", as the reference degrades it (:636-642).
    On CPU tensors the kernel routes run their plain versions. A
    downsample_mode other than "stride" takes the NHWC route (skip_apply),
    as the reference's does (:634-635)."""
    if conv_impl not in GENERATOR_CONVS:
        raise ValueError(f"conv_impl {conv_impl!r}; one of {GENERATOR_CONVS}")
    if cfg.downsample_mode != "stride":
        return skip_apply(params, cfg, x_nhwc, compute_dtype, groups)
    if conv_impl == "fused" and cfg.act_fun not in ("LeakyReLU", "none"):
        conv_impl = "auto"
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
# The NHWC route (splice_tpu/models/unet.py:95-235, 806-856)
# ---------------------------------------------------------------------------

def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> the NCHW view (channels_last for a contiguous x)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], groups: int = 1,
               eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm of NHWC x over (B, H, W) of each of `groups`
    equal batch slices, in the reference's deviation form (:95-112): the
    mean in fp32, then the mean of (x - mean)^2 with the difference in x's
    type, and one affine pass in x's type."""
    xs = split_stacks(x, groups)                      # [G, B/G, H, W, C]
    acc = torch.promote_types(x.dtype, torch.float32)
    mean = xs.mean(dim=(1, 2, 3), dtype=acc)          # [G, C]
    dev = xs - mean.to(x.dtype)[:, None, None, None]
    var = torch.square(dev).mean(dim=(1, 2, 3), dtype=acc)
    inv = torch.rsqrt(var + eps) * wide(p["scale"])
    shift = wide(p["bias"]) - mean * inv
    y = xs * inv.to(x.dtype)[:, None, None, None] \
        + shift.to(x.dtype)[:, None, None, None]
    return y.reshape(x.shape)


def conv2d(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1,
           pad: str = "zero") -> torch.Tensor:
    """The NHWC conv (:115-135): torch (k-1)//2 zero or reflection padding,
    F.conv2d on the channels_last view, the bias added after. x [B, H, W,
    Cin], kernel [kh, kw, Cin, Cout] -> [B, H', W', Cout]."""
    w = p["kernel"]
    to_pad = (w.shape[0] - 1) // 2
    xc = _nchw(x)
    if pad == "reflection" and to_pad > 0:
        xc = reflect_pad(xc, to_pad)
        to_pad = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                 padding=to_pad)
    y = _nhwc(y)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _downsampler_kernel(kernel_type: str, factor: int) -> np.ndarray:
    """The analytic box, lanczos (phase 0.5, even size 2 * support *
    factor) and gauss kernels (:138-178; reference downsampler.py:73-135),
    float64, normalised to sum 1."""
    if kernel_type == "box":
        return np.ones((factor, factor), np.float64) / factor ** 2
    if kernel_type.startswith("lanczos"):
        support = int(kernel_type[-1])
        kernel_width = 2 * support * factor + 1
        ksize = kernel_width - 1
        k = np.zeros((ksize, ksize), np.float64)
        center = (kernel_width + 1.0) / 2.0
        for i in range(1, ksize + 1):
            for j in range(1, ksize + 1):
                val = 1.0
                for d in (abs(i + 0.5 - center) / factor,
                          abs(j + 0.5 - center) / factor):
                    if d == 0:
                        continue
                    if d < support:
                        val *= (support * np.sin(np.pi * d)
                                * np.sin(np.pi * d / support)
                                / (np.pi ** 2 * d ** 2))
                    else:
                        val = 0.0
                k[i - 1, j - 1] = val
        return k / k.sum()
    if kernel_type == "gauss":
        sigma = 0.5
        ksize = int(np.ceil(sigma * 4)) * 2 + 1
        ax = np.arange(ksize) - ksize // 2
        g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
        k = np.outer(g, g)
        return k / k.sum()
    raise ValueError(kernel_type)


def downsample(x: torch.Tensor, mode: str, factor: int = 2) -> torch.Tensor:
    """The non-stride downsamplers of NHWC x (:181-205): avg and max over
    factor x factor windows, lanczos2/3 as a depthwise stride-factor conv
    after an edge (replication) pad; any other mode raises."""
    xc = _nchw(x)
    if mode == "avg":
        return _nhwc(F.avg_pool2d(xc, factor, factor))
    if mode == "max":
        return _nhwc(F.max_pool2d(xc, factor, factor))
    if mode in ("lanczos2", "lanczos3"):
        kern = _depthwise_kernel(mode, factor, x.shape[-1], x.dtype, x.device)
        ks = kern.shape[-1]
        pad = (ks - factor) // 2 + (ks - factor) % 2
        xp = F.pad(xc, (pad,) * 4, mode="replicate")
        return _nhwc(F.conv2d(xp, kern, stride=factor, groups=x.shape[-1]))
    raise ValueError(mode)


@functools.lru_cache(maxsize=None)
def _depthwise_kernel(mode: str, factor: int, c: int, dtype: torch.dtype,
                      device) -> torch.Tensor:
    """_downsampler_kernel as the [c, 1, ks, ks] weight of a depthwise
    conv, made once per device (a captured step may not copy from the
    host)."""
    k = torch.from_numpy(_downsampler_kernel(mode, factor)).to(dtype)
    return k.expand(c, 1, *k.shape).contiguous().to(device)


def gen_noise(x: torch.Tensor, dim2: int,
              generator: torch.Generator) -> torch.Tensor:
    """GenNoise (:208-212): a standard normal [B, H, W, dim2] in x's type
    and on x's device, drawn from `generator` (on its own device)."""
    b, h, w, _ = x.shape
    return torch.randn((b, h, w, dim2), generator=generator,
                       device=generator.device, dtype=x.dtype).to(x.device)


def upsample2(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x2 upsample of NHWC x (:215-220), half-pixel centres."""
    return _nhwc(upsample2x_chw(_nchw(x), mode))


def concat_crop(xs: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate NHWC branches along channels after centre-cropping each
    to the smallest height and width (:223-235)."""
    return _nhwc(_center_crop_cat([_nchw(t) for t in xs]))


def skip_apply(params: Dict[str, Any], cfg: SkipConfig, x: torch.Tensor,
               compute_dtype=None, groups: int = 1) -> torch.Tensor:
    """The reference's NHWC generator (:806-856): [B, H, W, Cin] in [0, 1]
    -> [B, H', W', Cout] fp32. groups: batch stacks with their own
    BatchNorm statistics (the reference's vmap over stacks)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)

    def bn(t, p):
        return batch_norm(t, p, groups)

    def scale_fn(i: int, xin: torch.Tensor) -> torch.Tensor:
        sp = params["scales"][i]
        branches = []
        if cfg.channels_skip[i]:
            s = conv2d(xin, sp["skip_conv"], 1, cfg.pad)
            branches.append(act(bn(s, sp["skip_bn"]), cfg.act_fun))
        if cfg.downsample_mode == "stride":
            d = conv2d(xin, sp["down_conv1"], 2, cfg.pad)
        else:
            d = downsample(conv2d(xin, sp["down_conv1"], 1, cfg.pad),
                           cfg.downsample_mode, 2)
        d = act(bn(d, sp["down_bn1"]), cfg.act_fun)
        d = act(bn(conv2d(d, sp["down_conv2"], 1, cfg.pad), sp["down_bn2"]),
                cfg.act_fun)
        inner = scale_fn(i + 1, d) if i < cfg.n_scales - 1 else d
        branches.append(upsample2(inner, cfg.upsample_mode))
        y = bn(concat_crop(branches), sp["post_bn"])
        y = act(bn(conv2d(y, sp["up_conv"], 1, cfg.pad), sp["up_bn"]),
                cfg.act_fun)
        if cfg.need1x1_up:
            y = act(bn(conv2d(y, sp["up1x1_conv"], 1, cfg.pad),
                       sp["up1x1_bn"]), cfg.act_fun)
        return y

    y = conv2d(scale_fn(0, x), params["out_conv"], 1, cfg.pad).float()
    if cfg.need_sigmoid:
        y = torch.sigmoid(y)
    elif cfg.need_tanh:
        y = torch.tanh(y)
    return y


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
