"""Training loop (port of splice_tpu/trainer.py:46-68,249-377,525-620).

One step: augmentation and global crops on the device -> the skip U-Net over
the A and B crop stacks as one batch of 2 (BatchNorm per stack) -> loss-side
resize and ImageNet normalisation -> the frozen ViT (generated batch with
gradients, targets without) -> the splice losses (plus the entire-image
losses on every entire_A_every-th step) -> Adam over one flat fp32
parameter vector. PyTorch runs eagerly, so there is no compiled program and
no chunking; the host draws each step's random numbers from a
torch.Generator and passes them in explicitly.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from splice_tpu_torch import losses as losses_lib
from splice_tpu_torch import resolve_device
from splice_tpu_torch.config import Config
from splice_tpu_torch.data import ImagePair, load_pair
from splice_tpu_torch.models import extractor as ext_lib
from splice_tpu_torch.models import unet, vit as vit_lib
from splice_tpu_torch.models.weights import load_or_init_vit_params
from splice_tpu_torch.ops import image as img_ops
from splice_tpu_torch.utils.io import save_image

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_optimizer(cfg: Config, params: List[torch.Tensor]
                   ) -> torch.optim.Optimizer:
    """Adam with the reference's settings (torch's update equals
    optax.adam's: eps added after the bias-corrected square root)."""
    return torch.optim.Adam(params, lr=cfg.lr, eps=1e-8,
                            betas=(cfg.optimizer_beta1, cfg.optimizer_beta2))


@dataclasses.dataclass
class StepDraws:
    """Every random number one step uses."""
    structure: Optional[Dict[str, Any]]   # structure_augment kwargs
    flip_B: bool
    crops_A: Tuple[float, list, list]     # (side, tops, lefts)
    crops_B: Tuple[float, list, list]


def sample_step_draws(cfg: Config, pair: ImagePair,
                      gen: torch.Generator) -> StepDraws:
    structure, flip_B = None, False
    if cfg.use_augmentations:
        structure = img_ops.sample_structure_draws(gen)
        flip_B = bool(torch.rand((), generator=gen).item() < 0.5)
    crops_A = img_ops.sample_crop_draws(*pair.a_hw,
                                        cfg.global_A_crops_n_crops,
                                        cfg.global_A_crops_min_cover, gen)
    crops_B = img_ops.sample_crop_draws(*pair.b_hw,
                                        cfg.global_B_crops_n_crops,
                                        cfg.global_B_crops_min_cover, gen)
    return StepDraws(structure, flip_B, crops_A, crops_B)


def make_extractor_from_config(cfg: Config, device=None,
                               seed: int = 0) -> ext_lib.VitExtractor:
    """The frozen ViT on `device` (default cfg.device, i.e. CUDA)."""
    dev = resolve_device(device if device is not None else cfg.device)
    vcfg = vit_lib.get_vit_config(cfg.dino_model_name)
    params = load_or_init_vit_params(cfg.dino_model_name, cfg.vit_weights,
                                     seed=seed, device=dev)
    dtype = _DTYPES[cfg.vit_compute_dtype]
    params = vit_lib.cast_params_for_compute(params, dtype)
    return ext_lib.VitExtractor(params=params, cfg=vcfg,
                                model_name=cfg.dino_model_name,
                                compute_dtype=dtype)


class SpliceTrainer:
    """The generator's flat parameter vector, its optimizer, and the step."""

    def __init__(self, cfg: Config, pair: ImagePair,
                 extractor: ext_lib.VitExtractor,
                 gcfg: Optional[unet.SkipConfig] = None,
                 init_flat: Optional[torch.Tensor] = None, seed: int = 0):
        self.cfg, self.pair, self.extractor = cfg, pair, extractor
        self.gcfg = gcfg or unet.SkipConfig()
        self.gdt = _DTYPES[cfg.generator_compute_dtype]
        tree = unet.init_skip_params(self.gcfg, cfg.init_gain, seed=seed,
                                     device=pair.A.device)
        flat, self.spec = unet.flatten_params(tree)
        if init_flat is not None:
            flat = init_flat.to(device=pair.A.device, dtype=torch.float32)
        self.flat = flat.detach().clone().requires_grad_(True)
        self.opt = make_optimizer(cfg, [self.flat])

    def params(self) -> Dict[str, Any]:
        return unet.unflatten_params(self.flat, self.spec)

    def generate(self, params, x_nhwc: torch.Tensor,
                 groups: int = 1) -> torch.Tensor:
        return unet.skip_apply_chw(params, self.gcfg, x_nhwc, self.gdt,
                                   groups, self.cfg.generator_conv)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Loss-side preprocessing (reference losses.py:17-24)."""
        y = img_ops.dino_global_resize(x, self.cfg.dino_global_patch_size,
                                       self.cfg.dino_global_max_size,
                                       self.cfg.antialias)
        return img_ops.imagenet_normalize(y)

    def sample_inputs(self, draws: StepDraws):
        A, B = self.pair.A, self.pair.B
        if draws.structure is not None:
            A = img_ops.structure_augment(A, **draws.structure)
            B = img_ops.texture_augment(B, draws.flip_B)
        crops_A = img_ops.global_crops(A, *draws.crops_A,
                                       self.pair.canvas_A, self.cfg.antialias)
        crops_B = img_ops.global_crops(B, *draws.crops_B,
                                       self.pair.canvas_B, self.cfg.antialias)
        return crops_A, crops_B

    def loss(self, draws: StepDraws, lam: Dict[str, float], entire: bool
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        params = self.params()
        crops_A, crops_B = self.sample_inputs(draws)
        nA = crops_A.shape[0]
        if crops_A.shape == crops_B.shape:
            # One generator pass over both stacks, BatchNorm per stack.
            outs = self.generate(params, torch.cat([crops_A, crops_B]),
                                 groups=2)
            x_global, y_global = outs[:nA], outs[nA:]
        else:
            x_global = self.generate(params, crops_A)
            y_global = self.generate(params, crops_B)
        parts, aux = losses_lib.splice_losses_fused(
            self.extractor, self.transform(x_global), self.transform(crops_A),
            self.transform(y_global), self.transform(crops_B))
        if entire:
            A = self.pair.A[None]
            parts.update(losses_lib.entire_losses_fused(
                self.extractor, self.transform(self.generate(params, A)),
                self.transform(A), aux["cls_B"]))
        total = losses_lib.weighted_total(parts, lam)
        return total, parts

    def step(self, draws: StepDraws, lam: Dict[str, float], entire: bool
             ) -> Dict[str, torch.Tensor]:
        """One optimisation step; returns the detached loss terms."""
        total, parts = self.loss(draws, lam, entire)
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step()
        out = {k: v.detach() for k, v in parts.items()}
        zero = torch.zeros((), device=total.device)
        for name in ("loss_entire_cls", "loss_entire_ssim"):
            out.setdefault(name, zero)
        out["loss"] = total.detach()
        return out

    @torch.no_grad()
    def render(self) -> torch.Tensor:
        """Full-image generator output [H, W, 3] in [0, 1]."""
        return torch.clamp(self.generate(self.params(),
                                         self.pair.A[None])[0], 0.0, 1.0)


def resolve_seed(cfg: Config) -> int:
    if cfg.seed == -1:
        return int(np.random.randint(2 ** 31 - 1))
    return cfg.seed


def train_pair(cfg: Config, n_steps: Optional[int] = None, device=None,
               dataroot: Optional[str] = None,
               pair: Optional[ImagePair] = None,
               extractor: Optional[ext_lib.VitExtractor] = None
               ) -> Dict[str, Any]:
    """Optimise one pair for n_steps (default cfg.n_epochs) steps on
    `device` (default cfg.device, i.e. CUDA). Writes
    <dataroot>/out/output.png at every log_images_freq-th step and at the
    end. Returns the per-step losses and wall seconds, the output image and
    the trainer."""
    dev = resolve_device(device if device is not None else cfg.device)
    seed = resolve_seed(cfg)
    print(f"running with seed: {seed}.")
    root = dataroot or cfg.dataroot
    if pair is None:
        pair = load_pair(cfg, root, dev)
    if extractor is None:
        extractor = make_extractor_from_config(cfg, dev)
    trainer = SpliceTrainer(cfg, pair, extractor, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    total_steps = n_steps if n_steps is not None else cfg.n_epochs
    out_png = os.path.join(root, "out", "output.png")
    losses: List[Dict[str, float]] = []
    step_seconds: List[float] = []
    for i in range(total_steps):
        t0 = time.perf_counter()
        parts = trainer.step(sample_step_draws(cfg, pair, gen),
                             losses_lib.lambdas_for_step(cfg, i),
                             losses_lib.is_entire_step(cfg, i))
        # .item() waits for the device: the step's wall time is complete
        losses.append({k: float(v.item()) for k, v in parts.items()})
        step_seconds.append(time.perf_counter() - t0)
        if (i + 1) % cfg.log_images_freq == 0 and i + 1 < total_steps:
            save_image(trainer.render(), out_png)
    output = trainer.render()
    save_image(output, out_png)
    return {"losses": losses, "step_seconds": step_seconds,
            "output": output, "trainer": trainer, "seed": seed,
            "output_path": out_png}
