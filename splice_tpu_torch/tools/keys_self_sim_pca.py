"""Keys self-similarity PCA visualizer (port of
splice_tpu/tools/keys_self_sim_pca.py): the layer-L keys self-similarity
Gram of one image, projected on its first three principal components and
drawn as an RGB image over the patch grid.

    python -m splice_tpu_torch.tools.keys_self_sim_pca \
        --image_path datasets/feature_visualization/limes.jpeg \
        --save_path out/pca.png [--layer 11] [--dino_model_name dino_vitb8]

Runs the ViT on CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch
from PIL import Image

from splice_tpu_torch import resolve_device
from splice_tpu_torch.data import load_image
from splice_tpu_torch.models import extractor as ext_lib
from splice_tpu_torch.models.weights import load_or_init_vit_params
from splice_tpu_torch.ops import image as img_ops


def pca_project(x: np.ndarray, n_components: int = 3) -> np.ndarray:
    """PCA by the SVD of the centered matrix: x [N, D] -> [N, n_components]."""
    xc = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    return xc @ vt[:n_components].T


def visualize(image_path: str, save_path: str, layer: int = 11,
              dino_model_name: str = "dino_vitb8", vit_weights=None,
              resize: int = 224, device=None) -> str:
    """Write the PCA image of `image_path` (shorter side resized to
    `resize`) to `save_path`; the ViT in fp32 on `device` (default CUDA).
    The CLS row and a _reg model's register rows are left out of the grid
    (the reference drops CLS only, and a _reg model's grid does not
    reshape there)."""
    dev = resolve_device(device)
    img = load_image(image_path, resize)
    x = img_ops.imagenet_normalize(torch.from_numpy(img).to(dev))[None]
    params = load_or_init_vit_params(dino_model_name, vit_weights,
                                     device=dev)
    e = ext_lib.make_extractor(dino_model_name, params=params)
    with torch.no_grad():
        ssim = e.get_keys_self_sim_from_input(x, layer)[0]
    reduced = pca_project(ssim.cpu().numpy(), 3)
    p = e.get_patch_size()
    gh, gw = img.shape[0] // p, img.shape[1] // p
    grid = reduced[1 + e.cfg.num_register_tokens:].reshape(gh, gw, 3)
    grid = (grid - grid.min()) / max(grid.max() - grid.min(), 1e-12)
    out = Image.fromarray(np.uint8(grid * 255)).resize(
        (gw * p, gh * p), Image.BILINEAR)
    pathlib.Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    out.save(save_path)
    return save_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image_path", type=str,
                        default="datasets/feature_visualization/limes.jpeg")
    parser.add_argument("--layer", type=int, default=11)
    parser.add_argument("--dino_model_name", type=str, default="dino_vitb8")
    parser.add_argument("--vit_weights", type=str, default=None)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    path = visualize(args.image_path, args.save_path, args.layer,
                     args.dino_model_name, args.vit_weights,
                     device=args.device)
    print(f"saved {path}")


if __name__ == "__main__":
    main()
