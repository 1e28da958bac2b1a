#!/usr/bin/env python
"""Feature inversion (port of splice_tpu/tools/inversion.py): reconstruct an
image whose DINO feature, the last-layer CLS token or the keys of a layer,
matches a target image's, by optimising the 6-scale reflection-pad skip net
(unet.inversion_skip_config) fed a fixed noise tensor.

One iteration perturbs the noise (magnitude 10, then 2, then 0.5 at the
two stage marks, for feature "cls"; none for "keys"), runs the generator
and the frozen ViT, takes the MSE against the target's feature and makes an
Adam step (optax.adam's update). On CUDA the iteration is one captured
CUDA graph (trainer.SpliceProgram, the reference's scanned chunk): the
perturbation is drawn on the device inside it, the magnitude is the step's
row, and a chunk of replays ends right after each step index that is 0 mod
log_freq, where the loss is read once and the render goes to the
asynchronous saver. On the CPU the same loop runs eagerly.

    python -m splice_tpu_torch.tools.inversion --feature cls \\
        --image_path datasets/feature_visualization/limes.jpeg \\
        --save_path out/inv.png [--n_iter 20000] [--layer 11] [--device cpu]
"""
from __future__ import annotations

import time
from argparse import ArgumentParser
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from splice_tpu_torch import resolve_device
from splice_tpu_torch.data import load_image
from splice_tpu_torch.models import extractor as ext_lib
from splice_tpu_torch.models import unet, vit as vit_lib
from splice_tpu_torch.models.weights import load_or_init_vit_params
from splice_tpu_torch.ops import image as img_ops
from splice_tpu_torch.trainer import _DTYPES, SpliceProgram
from splice_tpu_torch.utils.io import AsyncImageSaver, save_image
from splice_tpu_torch.utils.metrics import HostCopy

FEATURES = ("cls", "keys")


def noise_mag_at(i: int, feature: str, noise_stage_1: int,
                 noise_stage_2: int) -> float:
    """The staged noise magnitude of step i (:109-117): 10 before stage 1,
    2 before stage 2, then 0.5; 0 for feature "keys"."""
    if feature != "cls":
        return 0.0
    return 10.0 if i < noise_stage_1 else (2.0 if i < noise_stage_2 else 0.5)


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """Aspect-preserving Resize(224) with no max size (:84-92), identity
    where the shorter side is 224 already, then ImageNet normalisation.
    x: [B, H, W, 3] in [0, 1]."""
    shape = img_ops.dino_resize_shape(x.shape[1], x.shape[2], 224, None)
    y = x if shape == (x.shape[1], x.shape[2]) else img_ops.resize(x, shape)
    return img_ops.imagenet_normalize(y)


def extract(extractor: ext_lib.VitExtractor, x: torch.Tensor, feature: str,
            layer: int) -> torch.Tensor:
    """The inverted feature of images x (:94-102): the CLS token of block
    `layer` ([B, D]), or that layer's keys ([B, H, N, dh])."""
    x = preprocess(x)
    if feature == "cls":
        return extractor.run(x, {"block": (layer,)})["block"][layer][:, 0, :]
    return extractor.get_keys_from_input(x, layer)


def step_loss(g_apply: Callable, params, extractor: ext_lib.VitExtractor,
              ref: torch.Tensor, base_noise: torch.Tensor,
              noise: torch.Tensor, mag, feature: str,
              layer: int) -> torch.Tensor:
    """One iteration's loss (:127-131): the generator on base_noise + mag *
    noise, its feature's fp32 MSE against ref."""
    out = g_apply(params, base_noise + mag * noise)
    f = extract(extractor, out, feature, layer)
    return torch.mean(torch.square(f.float() - ref.float()))


class InversionStep:
    """The inversion's state and step in the form SpliceProgram runs: the
    generator's flat fp32 parameters, Adam over them (optax.adam(lr): b1
    0.9, b2 0.999, eps 1e-8; capturable on CUDA), and step(row), whose row
    holds the step's noise magnitude. The step draws its noise on the
    device: on CUDA from the device's default generator, which a captured
    graph advances at every replay; on the CPU from `cpu_gen`."""

    row_shape = (1,)
    loss_keys = ("loss",)

    def __init__(self, g_apply: Callable, tree: Dict[str, Any],
                 extractor: ext_lib.VitExtractor, ref: torch.Tensor,
                 base_noise: torch.Tensor, feature: str, layer: int,
                 lr: float, cpu_gen: torch.Generator):
        self.g_apply, self.extractor = g_apply, extractor
        self.ref, self.base_noise = ref, base_noise
        self.feature, self.layer, self.cpu_gen = feature, layer, cpu_gen
        flat, self.spec = unet.flatten_params(tree)
        self.flat = flat.detach().clone().requires_grad_(True)
        self.opt = torch.optim.Adam([self.flat], lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, capturable=self.flat.is_cuda)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def params(self) -> Dict[str, Any]:
        return unet.unflatten_params(self.flat, self.spec)

    def noise(self) -> torch.Tensor:
        gen = None if self.device.type == "cuda" else self.cpu_gen
        return torch.randn(self.base_noise.shape, generator=gen,
                           device=self.device)

    def loss(self, mag, noise: torch.Tensor) -> torch.Tensor:
        return step_loss(self.g_apply, self.params(), self.extractor,
                         self.ref, self.base_noise, noise, mag, self.feature,
                         self.layer)

    def step(self, row: torch.Tensor, lam=None,
             entire: bool = False) -> Dict[str, torch.Tensor]:
        total = self.loss(row[0], self.noise())
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step()
        return {"loss": total.detach()}

    @torch.no_grad()
    def render(self, mag: float) -> torch.Tensor:
        """The generator's [H, W, 3] output in [0, 1] on the base noise
        perturbed at magnitude mag (:139-143)."""
        x = self.base_noise + mag * self.noise()
        return torch.clamp(self.g_apply(self.params(), x)[0], 0.0, 1.0)


def invert(image_path: str, save_path: str, feature: str = "cls",
           layer: int = 11, dino_model_name: str = "dino_vitb8",
           vit_weights=None, input_depth: int = 32, lr: float = 0.01,
           n_iter: int = 20000, noise_stage_1: int = 10000,
           noise_stage_2: int = 15000, log_freq: int = 100,
           seed: int = 0, resize: int = 224,
           callback: Optional[Callable] = None,
           compute_dtype: str = "bfloat16",
           generator_layout: str = "nhwc",
           generator_conv: str = "auto",
           use_pallas_attention=None, device=None) -> dict:
    """The reference's invert (:29-204) on `device` (default CUDA):
    n_iter steps in chunks that end after every step index 0 mod log_freq;
    at each such step the render is saved (asynchronously) to save_path and
    callback(step, loss, image) is called, the image a float CPU tensor
    [H, W, 3] in [0, 1] (the reference hands it a host array); at the
    end the noise-free render is saved. compute_dtype: the generator's and
    the ViT's; generator_layout "nhwc" (skip_apply) or "chw"
    (skip_apply_chw under generator_conv). use_pallas_attention: the
    port's attention kernels (None: on CUDA, as the reference's None means
    Pallas off the CPU, :65-66); False is the reference's XLA ablation
    (ops.attention.library_attention). Returns the last loss, the wall time, the
    parameter tree, the ViT's input size, and the chunk sizes, the
    program and the step."""
    if feature not in FEATURES:
        raise ValueError(f"feature {feature!r}; one of {FEATURES}")
    if generator_layout not in ("nhwc", "chw"):
        raise ValueError(f"generator_layout {generator_layout!r}")
    dev = resolve_device(device)
    if use_pallas_attention is None:
        use_pallas_attention = dev.type == "cuda"
    dt = _DTYPES[compute_dtype]
    img = load_image(image_path, resize)
    target = torch.from_numpy(img)[None].to(dev)
    h, w = img.shape[0], img.shape[1]

    vcfg = vit_lib.get_vit_config(dino_model_name)
    vparams = vit_lib.cast_params_for_compute(
        load_or_init_vit_params(dino_model_name, vit_weights, device=dev), dt)
    extractor = ext_lib.VitExtractor(params=vparams, cfg=vcfg,
                                     model_name=dino_model_name,
                                     compute_dtype=dt,
                                     use_pallas=use_pallas_attention)
    gcfg = unet.inversion_skip_config(input_depth)

    def g_apply(p, x):
        if generator_layout == "chw":
            return unet.skip_apply_chw(p, gcfg, x, dt,
                                       conv_impl=generator_conv)
        return unet.skip_apply(p, gcfg, x, dt)

    cpu_gen = torch.Generator().manual_seed(seed)
    tree = unet.init_skip_params(gcfg, seed=seed, device=dev)
    base_noise = torch.randn((1, h, w, input_depth), generator=cpu_gen).to(dev)
    if dev.type == "cuda":
        torch.cuda.manual_seed(seed)
    with torch.no_grad():
        ref = extract(extractor, target, feature, layer)
    step = InversionStep(g_apply, tree, extractor, ref, base_noise, feature,
                         layer, lr, cpu_gen)
    program = SpliceProgram(step, max(1, min(log_freq, n_iter)))

    def mag_at(i):
        return noise_mag_at(i, feature, noise_stage_1, noise_stage_2)

    saver = AsyncImageSaver()
    t0 = time.perf_counter()
    loss = None
    chunks = []
    i = 0
    try:
        while i < n_iter:
            # a chunk ends right after a step index 0 mod log_freq (:155-164)
            end = (i // log_freq) * log_freq + 1
            if end <= i:
                end += log_freq
            end = min(end, n_iter)
            rows = np.asarray([[mag_at(j)] for j in range(i, end)],
                              np.float32)
            loss = float(program.run(rows, False)[-1, 0])
            chunks.append(end - i)
            i = end
            last = i - 1
            if last % log_freq == 0:
                out = step.render(mag_at(last))
                saver.save(img_ops.tensor2im(out), save_path)
                if callback is not None:
                    callback(last, loss, HostCopy(out).wait())
        out = step.render(0.0)
    finally:
        saver.close()
    save_image(out.cpu().numpy(), save_path)
    return {"loss": loss, "wall_time": time.perf_counter() - t0,
            "params": step.params(),
            # what the frozen ViT saw: the aspect-preserving Resize(224)
            "dino_input_hw": img_ops.dino_resize_shape(h, w, 224, None),
            "chunks": chunks, "program": program, "step": step}


def main(argv=None) -> None:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--feature", type=str, default="cls",
                        help="cls | keys")
    parser.add_argument("--layer", type=int, default=11)
    parser.add_argument("--dino_model_name", type=str, default="dino_vitb8")
    parser.add_argument("--vit_weights", type=str, default=None)
    parser.add_argument("--image_path", type=str,
                        default="datasets/feature_visualization/limes.jpeg")
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--log_freq", type=int, default=100)
    parser.add_argument("--input_depth", type=int, default=32)
    parser.add_argument("--LR", type=float, default=0.01)
    parser.add_argument("--n_iter", type=int, default=20000)
    parser.add_argument("--reduce_noise_stage_1_iter", type=int,
                        default=10000)
    parser.add_argument("--reduce_noise_stage_2_iter", type=int,
                        default=15000)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        help="bfloat16 | float32 (generator and ViT)")
    parser.add_argument("--generator_layout", type=str, default="nhwc",
                        help="nhwc (F.conv2d) | chw (generator_conv)")
    parser.add_argument("--generator_conv", type=str, default="auto",
                        help="auto | xla | pallas | fused")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) | cpu")
    args = parser.parse_args(argv)
    res = invert(args.image_path, args.save_path, args.feature, args.layer,
                 args.dino_model_name, args.vit_weights, args.input_depth,
                 args.LR, args.n_iter, args.reduce_noise_stage_1_iter,
                 args.reduce_noise_stage_2_iter, args.log_freq,
                 compute_dtype=args.compute_dtype,
                 generator_layout=args.generator_layout,
                 generator_conv=args.generator_conv, device=args.device)
    loss_txt = "n/a" if res["loss"] is None else f"{res['loss']:.6f}"
    print(f"done: final loss {loss_txt}, {res['wall_time']:.1f}s -> "
          f"{args.save_path}")


if __name__ == "__main__":
    main()
