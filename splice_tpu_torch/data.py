"""Image-pair data layer (port of splice_tpu/data.py:22-131): one pair, or
the frames of a video against one appearance image.

The host decodes the two images once, applies the optional shorter-side
resize and the direction swap, picks the shared crop canvas, and puts both
images on the device as [H, W, 3] float32 tensors in [0, 1]. Per-step
augmentation and cropping run on the device (ops/image.py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

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


def image_names(dir_path: str) -> list:
    """The image files of a directory in name order, hidden files and
    non-images skipped."""
    return sorted(
        n for n in os.listdir(dir_path)
        if not n.startswith(".") and n.lower().endswith(_IMAGE_EXTS)
        and os.path.isfile(os.path.join(dir_path, n)))


def first_image_in(dir_path: str) -> str:
    """First image file (sorted), skipping hidden files and non-images."""
    names = image_names(dir_path)
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

    @property
    def geometry(self) -> Tuple:
        """What a step captured for one pair fixes: the images' shapes and
        the canvases."""
        return (tuple(self.A.shape), tuple(self.B.shape), self.canvas_A,
                self.canvas_B)

    def to(self, device) -> "ImagePair":
        """The pair with both images on `device` (from pinned host memory
        without a wait)."""
        return dataclasses.replace(
            self, A=self.A.to(device, non_blocking=True),
            B=self.B.to(device, non_blocking=True))


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


def load_video_frames(cfg, dataroot: Optional[str] = None,
                      device: Optional[torch.device] = None
                      ) -> Iterator[Tuple[str, ImagePair]]:
    """Video mode (splice_tpu/data.py:110-131): every image of <root>/A, in
    name order, is a frame against the one appearance image of <root>/B.
    B is decoded and put on `device` (default cfg.device, i.e. CUDA) once,
    here; each frame's canvas is unified with B's as load_pair does.
    Returns an iterator of (frame name, pair) whose A stays on the host
    (in pinned memory when the device is CUDA): it decodes, and may run
    on a loader thread, without touching the device; pair.to(device) puts
    A there."""
    device = resolve_device(device if device is not None else cfg.device)
    root = dataroot or cfg.dataroot
    b_np = load_image(first_image_in(os.path.join(root, "B")), cfg.B_resize)
    B = torch.from_numpy(b_np).to(device)
    cb = crop_canvas_size(b_np.shape[0], b_np.shape[1], cfg.crop_canvas)
    a_dir = os.path.join(root, "A")
    names = image_names(a_dir)

    def frames():
        for name in names:
            a_np = load_image(os.path.join(a_dir, name), cfg.A_resize)
            A = torch.from_numpy(a_np)
            if device.type == "cuda":
                A = A.pin_memory()
            canvas = min(crop_canvas_size(a_np.shape[0], a_np.shape[1],
                                          cfg.crop_canvas), cb)
            yield name, ImagePair(A=A, B=B, canvas_A=canvas, canvas_B=canvas)

    return frames()
