"""Single-image-pair data layer (port of splice_tpu/data.py:22-107).

The host decodes the two images once, applies the optional shorter-side
resize and the direction swap, picks the shared crop canvas, and puts both
images on the device as [H, W, 3] float32 tensors in [0, 1]. Per-step
augmentation and cropping run on the device (ops/image.py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from splice_tpu_torch import resolve_device


def load_image(path: str, shorter_side: Optional[int] = None) -> np.ndarray:
    """Decode to float32 [0,1] HWC RGB; optional shorter-side resize
    (torchvision Resize(int) semantics: the long side is truncated)."""
    img = Image.open(path).convert("RGB")
    if shorter_side is not None and shorter_side > 0:
        w, h = img.size
        if h <= w:
            nh, nw = shorter_side, int(shorter_side * w / h)
        else:
            nh, nw = int(shorter_side * h / w), shorter_side
        img = img.resize((nw, nh), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff")


def first_image_in(dir_path: str) -> str:
    """First image file (sorted), skipping hidden files and non-images."""
    names = sorted(
        n for n in os.listdir(dir_path)
        if not n.startswith(".") and n.lower().endswith(_IMAGE_EXTS)
        and os.path.isfile(os.path.join(dir_path, n)))
    if not names:
        raise FileNotFoundError(f"no images in {dir_path}")
    return os.path.join(dir_path, names[0])


def crop_canvas_size(h: int, w: int, requested: int = 0,
                     multiple: int = 32) -> int:
    """Square canvas side for the global crops: `requested` if > 0, else
    min(H, W) rounded down to a multiple of 32 (so the U-Net's five
    stride-2 scales divide it evenly)."""
    if requested > 0:
        return requested
    side = min(h, w)
    return max((side // multiple) * multiple, multiple)


@dataclasses.dataclass
class ImagePair:
    """A structure/appearance pair resident on the device."""
    A: torch.Tensor        # [Ha, Wa, 3] float32 in [0, 1]
    B: torch.Tensor        # [Hb, Wb, 3]
    canvas_A: int
    canvas_B: int

    @property
    def a_hw(self) -> Tuple[int, int]:
        return self.A.shape[0], self.A.shape[1]

    @property
    def b_hw(self) -> Tuple[int, int]:
        return self.B.shape[0], self.B.shape[1]


def load_pair(cfg, dataroot: Optional[str] = None,
              device: Optional[torch.device] = None) -> ImagePair:
    """First file of <dataroot>/A and <dataroot>/B, optional resizes, BtoA
    swap, one shared canvas min(ca, cb) so both crop stacks run through the
    generator as one batch. On `device`, default cfg.device (CUDA)."""
    device = resolve_device(device if device is not None else cfg.device)
    root = dataroot or cfg.dataroot
    a_np = load_image(first_image_in(os.path.join(root, "A")), cfg.A_resize)
    b_np = load_image(first_image_in(os.path.join(root, "B")), cfg.B_resize)
    if cfg.direction == "BtoA":
        a_np, b_np = b_np, a_np
    ca = crop_canvas_size(a_np.shape[0], a_np.shape[1], cfg.crop_canvas)
    cb = crop_canvas_size(b_np.shape[0], b_np.shape[1], cfg.crop_canvas)
    canvas = min(ca, cb)
    return ImagePair(A=torch.from_numpy(a_np).to(device),
                     B=torch.from_numpy(b_np).to(device),
                     canvas_A=canvas, canvas_B=canvas)
