"""Image ops on the device (port of splice_tpu/ops/image.py).

Images are [..., H, W, C] float tensors in [0, 1], as in the reference.
Every random draw is an explicit argument: the trainer draws them from a
torch.Generator (sample_* helpers below), and the tests hand the same
numbers to both packages. The draws are data, as in the reference: a coin,
a factor, the jitter order or a crop window may be a Python value or a
float32 tensor on the image's device, and every coin is a torch.where (the
reference's jnp.where and lax.switch), so one captured CUDA graph of the
step serves every draw. Inside the step nothing here copies a host value
to the device: the constants are made once per device (_const).

jax.image.resize / scale_and_translate have no torch counterpart (torch's
antialiased bilinear uses another kernel support and border rule), so the
resampler here builds the same two [in, out] weight matrices JAX builds and
applies them as matmuls.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant tensor, made once per (values, dtype, device) and never
    written: a captured graph may not copy from the host, so the step reads
    constants made before its capture."""
    return torch.tensor(values, dtype=dtype, device=device)


def _data(value, device) -> torch.Tensor:
    """A draw as float32 data on `device`: a tensor passes through; a Python
    value (callers outside the step) is copied there once."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(value, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Resizing
# ---------------------------------------------------------------------------

def dino_resize_shape(h: int, w: int, size: int = 224,
                      max_size: int = 480) -> Tuple[int, int]:
    """Output (H, W) of torchvision Resize(size, max_size=max_size): shorter
    side -> size, the longer side truncated with int(); capped at
    max_size."""
    short, long = (h, w) if h <= w else (w, h)
    new_short, new_long = size, int(size * long / short)
    if max_size is not None and new_long > max_size:
        new_short = int(max_size * new_short / new_long)
        new_long = max_size
    return (new_short, new_long) if h <= w else (new_long, new_short)


def triangle_weights(in_size: int, out_size: int, scale, translation,
                     antialias: bool = True,
                     device=None) -> torch.Tensor:
    """[in, out] float32 weights of jax.image's linear (triangle) kernel for
    output = scale * input + translation with half-pixel centers.

    scale/translation may be Python floats (weights made once per device and
    sizes, then reused) or 0-d float32 tensors (the crop draws). The
    arithmetic follows jax.image.scale.compute_weight_mat step by step in
    float32, so both packages sample the same points."""
    if isinstance(scale, torch.Tensor):
        return _weights(in_size, out_size, 1.0 / scale.to(torch.float32),
                        translation, antialias, device)
    return _static_weights(in_size, out_size, float(scale),
                           float(translation), antialias, device)


@functools.lru_cache(maxsize=None)
def _static_weights(in_size: int, out_size: int, scale: float,
                    translation: float, antialias: bool,
                    device) -> torch.Tensor:
    # a Python scale: JAX takes its inverse in double precision
    f32 = torch.float32
    return _weights(in_size, out_size,
                    torch.tensor(1.0 / scale, dtype=f32, device=device),
                    torch.tensor(translation, dtype=f32, device=device),
                    antialias, device)


def _weights(in_size: int, out_size: int, inv_scale: torch.Tensor,
             translation: torch.Tensor, antialias: bool,
             device) -> torch.Tensor:
    f32 = torch.float32
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else 1.0
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
                * inv_scale - translation * inv_scale - 0.5)
    x = (sample_f[None, :]
         - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _apply_hw(img: torch.Tensor, wy, wx) -> torch.Tensor:
    """[..., H, W, C] contracted with wy [H, H'] and wx [W, W']; None leaves
    that axis alone."""
    if wy is not None:
        img = torch.einsum("...hwc,hi->...iwc", img, wy.to(img.dtype))
    if wx is not None:
        img = torch.einsum("...hwc,wj->...hjc", img, wx.to(img.dtype))
    return img


def resize(img: torch.Tensor, out_hw: Tuple[int, int],
           antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C], half-pixel centers, triangle
    antialias filter when downsampling (jax.image.resize 'bilinear')."""
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    # Like JAX, an axis whose size does not change is left alone.
    wy = (triangle_weights(h, oh, oh / h, 0.0, antialias, img.device)
          if oh != h else None)
    wx = (triangle_weights(w, ow, ow / w, 0.0, antialias, img.device)
          if ow != w else None)
    return _apply_hw(img, wy, wx)


def dino_global_resize(img: torch.Tensor, size: int = 224,
                       max_size: int = 480,
                       antialias: bool = True) -> torch.Tensor:
    """The loss-side resize policy (reference losses.py:20) on NHWC."""
    h, w = img.shape[-3], img.shape[-2]
    return resize(img, dino_resize_shape(h, w, size, max_size), antialias)


def imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
    mean = _const(IMAGENET_MEAN, img.dtype, img.device)
    std = _const(IMAGENET_STD, img.dtype, img.device)
    return (img - mean) / std


# ---------------------------------------------------------------------------
# Random crops on a static canvas
# ---------------------------------------------------------------------------

def crop_and_resize(img: torch.Tensor, top, left, size, canvas: int,
                    antialias: bool = True) -> torch.Tensor:
    """Window [top:top+size, left:left+size] of [H, W, C] -> [canvas,
    canvas, C], bilinear, over an edge pad of 2 so windows at the image
    border never read zeros (splice_tpu/ops/image.py:73-109). top, left and
    size: 0-d float32 tensors on img's device (the step's draws), or Python
    numbers."""
    pad = 2
    chw = img.permute(2, 0, 1)[None]
    imgp = torch.nn.functional.pad(chw, (pad, pad, pad, pad),
                                   mode="replicate")[0].permute(1, 2, 0)
    dev = img.device
    if not isinstance(size, torch.Tensor):
        top, left, size = _data((top, left, size), dev)
    scale = canvas / size
    ty = -(top + pad) * scale
    tx = -(left + pad) * scale
    wy = triangle_weights(imgp.shape[0], canvas, scale, ty, antialias, dev)
    wx = triangle_weights(imgp.shape[1], canvas, scale, tx, antialias, dev)
    return _apply_hw(imgp, wy, wx)


def sample_crop_draws(h: int, w: int, n_crops: int, min_cover: float,
                      gen: torch.Generator) -> Tuple[float, list, list]:
    """The random part of Global_crops: one square side
    round(U(min_cover*H, H)) clipped to W, and n_crops integer top-left
    corners uniform over the valid range."""
    u = torch.rand((), generator=gen).item()
    side = min(float(round(min_cover * h + u * (h - min_cover * h))),
               float(w))
    max_top, max_left = max(h - side, 0.0), max(w - side, 0.0)
    pos = torch.rand((n_crops, 2), generator=gen)
    tops = [float(int(p * (max_top + 1.0))) for p in pos[:, 0].tolist()]
    lefts = [float(int(p * (max_left + 1.0))) for p in pos[:, 1].tolist()]
    return side, tops, lefts


def global_crops(img: torch.Tensor, side, tops, lefts, canvas: int,
                 antialias: bool = True) -> torch.Tensor:
    """[H, W, C] -> [n_crops, canvas, canvas, C]; all crops share `side`.
    side: a 0-d tensor, tops and lefts [n_crops] tensors on img's device (the
    step's draws), or Python numbers and sequences."""
    if not isinstance(side, torch.Tensor):
        win = _data((side, *tops, *lefts), img.device)
        side, tops, lefts = win[0], win[1:1 + len(tops)], win[1 + len(tops):]
    return torch.stack([crop_and_resize(img, tops[i], lefts[i], side, canvas,
                                        antialias)
                        for i in range(tops.shape[0])])


# ---------------------------------------------------------------------------
# Augmentations (reference data/transforms.py:30-41)
# ---------------------------------------------------------------------------

def random_hflip(img: torch.Tensor, flip) -> torch.Tensor:
    """RandomHorizontalFlip on [H, W, C] with its coin given (a bool or a
    0-d tensor, nonzero flips): torch.where, as the reference's jnp.where
    (splice_tpu/ops/image.py:147)."""
    return torch.where(_data(flip, img.device) != 0,
                       torch.flip(img, dims=(1,)), img)


def _rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    w = _const((0.299, 0.587, 0.114), img.dtype, img.device)
    return (img * w).sum(dim=-1, keepdim=True)


def adjust_brightness(img, factor):
    return torch.clamp(img * factor, 0.0, 1.0)


def adjust_contrast(img, factor):
    mean = _rgb_to_grayscale(img).mean()
    return torch.clamp((img - mean) * factor + mean, 0.0, 1.0)


def adjust_saturation(img, factor):
    gray = _rgb_to_grayscale(img)
    return torch.clamp((img - gray) * factor + gray, 0.0, 1.0)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, zero, h)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def adjust_hue(img, delta):
    h, s, v = _rgb_to_hsv(img)
    return torch.clamp(_hsv_to_rgb(torch.remainder(h + delta, 1.0), s, v),
                       0.0, 1.0)


def sample_jitter_draws(gen: torch.Generator, brightness: float = 0.4,
                        contrast: float = 0.4, saturation: float = 0.2,
                        hue: float = 0.1) -> Tuple[Tuple[float, ...],
                                                   Tuple[int, ...]]:
    """ColorJitter's draws: (brightness, contrast, saturation, hue) factors
    and the order of the four ops."""
    u = torch.rand(4, generator=gen).tolist()

    def unif(x, lo, hi):
        return lo + x * (hi - lo)

    factors = (unif(u[0], max(0.0, 1 - brightness), 1 + brightness),
               unif(u[1], max(0.0, 1 - contrast), 1 + contrast),
               unif(u[2], max(0.0, 1 - saturation), 1 + saturation),
               unif(u[3], -hue, hue))
    order = tuple(torch.randperm(4, generator=gen).tolist())
    return factors, order


def color_jitter(img: torch.Tensor, factors, order) -> torch.Tensor:
    """torchvision ColorJitter with its draws given: factors (fb, fc, fs, fh)
    and the op applied at each of the four positions, `order` (0
    brightness, 1 contrast, 2 saturation, 3 hue); Python values or float32
    tensors.

    As data, like the reference's lax.switch inside a fori_loop
    (splice_tpu/ops/image.py:223-230): every position computes both
    candidates and selects one. Brightness, contrast and saturation are one
    op, clamp((x - ref) * f + ref) with ref 0, the grayscale mean and the
    grayscale (each adjust_* above to the bit); hue is the other."""
    f, order = _data(factors, img.device), _data(order, img.device)
    for pos in range(4):
        op = order[pos]
        gray = _rgb_to_grayscale(img)
        ref = torch.where(op == 0, 0.0, torch.where(op == 1, gray.mean(),
                                                    gray))
        fac = torch.where(op == 0, f[0], torch.where(op == 1, f[1], f[2]))
        blend = torch.clamp((img - ref) * fac + ref, 0.0, 1.0)
        img = torch.where(op == 3, adjust_hue(img, f[3]), blend)
    return img


def gaussian_blur3(img: torch.Tensor, sigma) -> torch.Tensor:
    """GaussianBlur(kernel_size=3) on [H, W, C], reflect padding, fp32."""
    x = _const((-1.0, 0.0, 1.0), torch.float32, img.device)
    sigma = _data(sigma, img.device)
    k1 = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    k1 = k1 / k1.sum()
    f = img.to(torch.float32)

    def tap3(t, axis):
        n = t.shape[axis]
        lo = t.narrow(axis, 1, 1)
        hi = t.narrow(axis, n - 2, 1)
        p = torch.cat([lo, t, hi], dim=axis)
        return (k1[0] * p.narrow(axis, 0, n) + k1[1] * p.narrow(axis, 1, n)
                + k1[2] * p.narrow(axis, 2, n))

    return tap3(tap3(f, 0), 1).to(img.dtype)


def structure_augment(img: torch.Tensor, flip, jitter_on, jitter_factors,
                      jitter_order, blur_on, sigma) -> torch.Tensor:
    """HFlip(0.5) -> ColorJitter(0.4,0.4,0.2,0.1)@0.5 -> GaussianBlur(3)@0.2
    with every coin and factor given (Python values or float32 tensors). The
    jitter and blur are computed on every call and selected by their coins:
    the reference's static_ctrl=False form
    (splice_tpu/ops/image.py:283-305)."""
    dev = img.device
    img = random_hflip(img, flip)
    img = torch.where(_data(jitter_on, dev) != 0,
                      color_jitter(img, jitter_factors, jitter_order), img)
    return torch.where(_data(blur_on, dev) != 0, gaussian_blur3(img, sigma),
                       img)


def texture_augment(img: torch.Tensor, flip) -> torch.Tensor:
    """dino_texture_transforms: HFlip(0.5)."""
    return random_hflip(img, flip)


def sample_structure_draws(gen: torch.Generator) -> dict:
    """All draws of structure_augment as keyword arguments."""
    flip = bool(torch.rand((), generator=gen).item() < 0.5)
    jitter_on = bool(torch.rand((), generator=gen).item() < 0.5)
    factors, order = sample_jitter_draws(gen)
    blur_on = bool(torch.rand((), generator=gen).item() < 0.2)
    sigma = 0.1 + torch.rand((), generator=gen).item() * (2.0 - 0.1)
    return dict(flip=flip, jitter_on=jitter_on, jitter_factors=factors,
                jitter_order=order, blur_on=blur_on, sigma=sigma)


# ---------------------------------------------------------------------------
# Output conversion (reference util/util.py:42-59)
# ---------------------------------------------------------------------------

def tensor2im(img: torch.Tensor) -> torch.Tensor:
    """[H, W, C] float in [0, 1] -> uint8 HWC on the image's device
    (splice_tpu/ops/image.py:316): clipped, scaled by 255 and truncated.
    The image leaves the device as uint8, a quarter of its float bytes."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
