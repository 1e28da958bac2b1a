"""Output-quality evaluation: PSNR, SSIM and LPIPS between two images (port
of splice_tpu/tools/evaluate.py).

PSNR and SSIM (Wang et al. 2004: an 11 x 11 Gaussian window of sigma 1.5,
K1 = 0.01, K2 = 0.03) are the port's own numpy copies and run on the host.
LPIPS (Zhang et al. 2018, AlexNet backbone) needs AlexNet's feature convs
and the LPIPS linear heads as an .npz (see port_lpips_weights); it runs on
CUDA unless device="cpu" (--device cpu), AlexNet's convs as F.conv2d and its
pools as F.max_pool2d (lax ops outside any kernel in the reference).

    python -m splice_tpu_torch.tools.evaluate --a out/output.png --b ref.png \\
        [--metric lpips --weights lpips_alex.npz] [--device cpu]

prints one JSON line {"psnr": ..., "ssim": ...[, "lpips": ...]}.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from splice_tpu_torch import resolve_device


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB of float images in [0, 1]."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """VALID 2-D correlation of [H, W] with the window, tap by tap."""
    k = win.shape[0]
    H, W = img.shape
    out = np.zeros((H - k + 1, W - k + 1), np.float64)
    for dy in range(k):
        for dx in range(k):
            out += win[dy, dx] * img[dy:dy + H - k + 1, dx:dx + W - k + 1]
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over the channels of [H, W(, C)] float images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    win = _gaussian_window()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mx = _filter2(x, win)
        my = _filter2(y, win)
        mx2, my2, mxy = mx * mx, my * my, mx * my
        sx = _filter2(x * x, win) - mx2
        sy = _filter2(y * y, win) - my2
        sxy = _filter2(x * y, win) - mxy
        m = ((2 * mxy + C1) * (2 * sxy + C2)) \
            / ((mx2 + my2 + C1) * (sx + sy + C2))
        vals.append(float(m.mean()))
    return float(np.mean(vals))


# LPIPS weights (.npz): AlexNet's feature convs conv1..conv5 as convN_w
# [Cout, Cin, kh, kw] and convN_b [Cout] (torchvision's layout), and the
# non-negative per-channel weights of the LPIPS heads linN_w [1, CN].
_ALEX_SPEC = (  # (name, stride, padding, max pool after)
    ("conv1", 4, 2, True),
    ("conv2", 1, 2, True),
    ("conv3", 1, 1, False),
    ("conv4", 1, 1, False),
    ("conv5", 1, 1, True),
)
# LPIPS's input scaling layer, applied to [-1, 1] images
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _alex_taps(x: torch.Tensor, weights, device) -> list:
    """x [1, 3, H, W] scaled input -> the five post-ReLU feature maps."""
    taps = []
    for i, (name, stride, pad, pool) in enumerate(_ALEX_SPEC):
        w = torch.as_tensor(np.asarray(weights[f"{name}_w"], np.float32),
                            device=device)
        b = torch.as_tensor(np.asarray(weights[f"{name}_b"], np.float32),
                            device=device)
        x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        taps.append(x)
        if pool and i + 1 < len(_ALEX_SPEC):
            # the pool only feeds the next conv
            x = F.max_pool2d(x, 3, 2)
    return taps


@torch.no_grad()
def lpips(a: np.ndarray, b: np.ndarray, weights, device=None) -> float:
    """LPIPS distance between two [H, W, 3] float images in [0, 1]:
    unit-normalise each layer's channels, squared difference, the layer's
    1x1 linear head, spatial mean, summed over the layers. weights: the
    .npz path or a loaded mapping. On `device` (default CUDA)."""
    dev = resolve_device(device)
    if isinstance(weights, str):
        weights = dict(np.load(weights))
    shift = torch.tensor(_LPIPS_SHIFT, device=dev)
    scale = torch.tensor(_LPIPS_SCALE, device=dev)

    def prep(img):
        x = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        x = (x * 2.0 - 1.0 - shift) / scale
        return x.permute(2, 0, 1)[None]

    total = torch.zeros((), device=dev)
    for i, (fa, fb) in enumerate(zip(_alex_taps(prep(a), weights, dev),
                                     _alex_taps(prep(b), weights, dev))):
        na = fa / torch.sqrt(torch.sum(fa * fa, dim=1, keepdim=True) + 1e-10)
        nb = fb / torch.sqrt(torch.sum(fb * fb, dim=1, keepdim=True) + 1e-10)
        lin = torch.as_tensor(np.asarray(weights[f"lin{i + 1}_w"],
                                         np.float32), device=dev)
        total = total + torch.mean(
            torch.sum((na - nb) ** 2 * lin[0][None, :, None, None], dim=1))
    return float(total)


def port_lpips_weights(alexnet_pth: str, lpips_lin_pth: str,
                       out_npz: str) -> str:
    """Write the LPIPS .npz from local torch checkpoints: alexnet_pth a
    torchvision AlexNet state dict (features.0/3/6/8/10), lpips_lin_pth
    LPIPS's "alex" heads (lin0..lin4.model.1.weight)."""
    alex = torch.load(alexnet_pth, map_location="cpu")
    lin = torch.load(lpips_lin_pth, map_location="cpu")
    feat_idx = {"conv1": 0, "conv2": 3, "conv3": 6, "conv4": 8, "conv5": 10}
    out = {}
    for name, idx in feat_idx.items():
        out[f"{name}_w"] = alex[f"features.{idx}.weight"].numpy()
        out[f"{name}_b"] = alex[f"features.{idx}.bias"].numpy()
    for i in range(5):
        w = lin[f"lin{i}.model.1.weight"].numpy()       # [1, C, 1, 1]
        out[f"lin{i + 1}_w"] = w.reshape(1, -1)
    np.savez(out_npz, **out)
    return out_npz


def load01(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float64) / 255.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--a", required=True, help="first image path")
    ap.add_argument("--b", required=True, help="second image path")
    ap.add_argument("--metric", default="all",
                    choices=["all", "psnr", "ssim", "lpips"])
    ap.add_argument("--weights", default=None,
                    help="LPIPS weights .npz (required for --metric lpips;"
                         " see port_lpips_weights)")
    ap.add_argument("--device", default=None,
                    help="LPIPS's device (default cuda; cpu for the plain "
                         "path)")
    args = ap.parse_args(argv)
    x, y = load01(args.a), load01(args.b)
    if x.shape != y.shape:
        raise SystemExit(f"shape mismatch: {x.shape} vs {y.shape}")
    out = {}
    if args.metric in ("all", "psnr"):
        out["psnr"] = round(psnr(x, y), 3)
    if args.metric in ("all", "ssim"):
        out["ssim"] = round(ssim(x, y), 4)
    if args.metric == "lpips" or (args.metric == "all" and args.weights):
        if not args.weights:
            raise SystemExit("--metric lpips requires --weights <npz> "
                             "(produce it with evaluate.port_lpips_weights)")
        out["lpips"] = round(lpips(x, y, args.weights, args.device), 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
