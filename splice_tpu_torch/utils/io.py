"""Output utilities (port of splice_tpu/utils/io.py): the final image as PNG."""
from __future__ import annotations

import pathlib

import numpy as np
import torch
from PIL import Image


def tensor2im(image_01) -> np.ndarray:
    """Float image in [0, 1], [H,W,3] or [1,H,W,3] -> uint8 HWC (values
    clipped, scaled by 255 and truncated, as the reference does)."""
    if isinstance(image_01, torch.Tensor):
        image_01 = image_01.detach().float().cpu().numpy()
    arr = np.asarray(image_01)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_image(image_hwc01, path: str) -> str:
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(tensor2im(image_hwc01)).save(path)
    return path
