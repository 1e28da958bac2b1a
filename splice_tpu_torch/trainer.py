"""Training loop (port of splice_tpu/trainer.py:46-213,219-430,525-830).

One step: augmentation and global crops on the device -> the skip U-Net over
the A and B crop stacks as one batch of 2 (BatchNorm per stack) -> loss-side
resize and ImageNet normalisation -> the frozen ViT (generated batch with
gradients, targets without) -> the splice losses (plus the entire-image
losses on every entire_A_every-th step) -> the optimizer (Adam, RMSprop or
SGD) over one flat fp32 parameter vector, at the step's learning rate.

The host draws each step's random numbers from a torch.Generator and packs
them, with the step's lambdas and learning rate, into one float32 row: the
step reads them as device data and branches on none of them. train_pair
cuts the run into chunks where the host must step in (boundaries_after, as
the reference's) and dispatches each through SpliceProgram: on CUDA the
regular step and the entire-A step are each one captured CUDA graph (the
reference's scanned chunk and jitted entire step), replayed with no host
read inside a chunk, and the chunk's losses come back in one copy. On the
CPU the program runs the same loop eagerly.

Around the chunks train_pair runs the reference's run: the scheduler, the
output PNG and the metrics JSONL from worker threads, checkpoints and
resume, and with profile_dir a device trace of profile_n_steps steps
(utils.profiling.TraceWindow). Its loop queues chunk k+1 before it reads
chunk k's losses, and nothing at a log boundary waits for the device.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import ctypes.util
import dataclasses
import functools
import math
import os
import pathlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from splice_tpu_torch import losses as losses_lib
from splice_tpu_torch import resolve_device
from splice_tpu_torch.config import Config, load_config
from splice_tpu_torch.data import ImagePair, load_pair
from splice_tpu_torch.models import extractor as ext_lib
from splice_tpu_torch.models import unet, vit as vit_lib
from splice_tpu_torch.models.weights import load_or_init_vit_params
from splice_tpu_torch.ops import attention as attn_ops
from splice_tpu_torch.ops import conv as conv_ops
from splice_tpu_torch.ops import image as img_ops
from splice_tpu_torch.utils.checkpoint import Checkpointer
from splice_tpu_torch.utils.io import AsyncImageSaver
from splice_tpu_torch.utils.metrics import (HostCopy, MetricsLogger,
                                            StepTimer, fetch_stacked)
from splice_tpu_torch.utils.profiling import TraceWindow

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(decay, eps) (optax 0.2.6 scale_by_rms, eps inside the
    square root, nu from 0): nu = (1 - decay) g^2 + decay nu, then
    p -= lr * (g * rsqrt(nu + eps)). torch.optim.RMSprop divides by
    sqrt(nu) + eps instead. lr is a 0-d tensor, read on the device, and
    every op stays on the device: a captured graph holds the update."""

    def __init__(self, params, lr: torch.Tensor, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay = group["decay"]
            # 1 - decay in float32, as optax's injected hyperparameter has it
            keep = float(np.float32(1.0) - np.float32(decay))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(decay).add_(g * g * keep)
                p.sub_(group["lr"] * (g * torch.rsqrt(nu + group["eps"])))


class SGD(torch.optim.Optimizer):
    """optax.sgd: p -= lr * g, with lr a 0-d tensor read on the device
    (torch.optim.SGD reads a tensor lr on the host)."""

    def __init__(self, params, lr: torch.Tensor):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.sub_(group["lr"] * p.grad)


def make_optimizer(cfg: Config, params: List[torch.Tensor],
                   lr: torch.Tensor) -> torch.optim.Optimizer:
    """The reference's optimizers (splice_tpu/trainer.py:46-60) at the
    learning rate `lr`, a 0-d float32 tensor on the parameters' device
    that each step sets from its row. Adam: torch's update equals
    optax.adam's (eps added after the bias-corrected square root); on CUDA
    it keeps its step count on the device (capturable, eager steps there
    too), so that a captured graph holds the update."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, eps=1e-8,
                                betas=(cfg.optimizer_beta1,
                                       cfg.optimizer_beta2),
                                capturable=params[0].is_cuda)
    if cfg.optimizer == "rmsprop":
        return RMSprop(params, lr, decay=0.99, eps=1e-8)
    if cfg.optimizer == "sgd":
        return SGD(params, lr)
    raise ValueError(cfg.optimizer)


# torch ReduceLROnPlateau's default patience; also caps a chunk under the
# plateau policy (boundaries_after).
PLATEAU_PATIENCE = 5


class Scheduler:
    """Host-side lr schedule, torch parity (splice_tpu/trainer.py:63-125).

    lr_for_step(i), 0-based, is the torch scheduler's value in effect
    during step i (schedulers step once per epoch after the optimizer)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.policy = cfg.scheduler_policy
        self.base_lr = cfg.lr
        # plateau (ReduceLROnPlateau: factor 0.2, relative threshold 0.01,
        # patience PLATEAU_PATIENCE)
        self._plateau_factor = 1.0
        self._best = math.inf
        self._bad_epochs = 0

    def observe(self, loss: float) -> None:
        if self.policy != "plateau":
            return
        if loss < self._best * (1.0 - 0.01):
            self._best = loss
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > PLATEAU_PATIENCE:
                self._plateau_factor *= 0.2
                self._bad_epochs = 0

    def state_dict(self) -> Dict[str, Any]:
        """Only plateau carries state; the other policies are closed-form
        in the step index."""
        return {"plateau_factor": self._plateau_factor, "best": self._best,
                "bad_epochs": self._bad_epochs}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self._plateau_factor = float(d["plateau_factor"])
        self._best = float(d["best"])
        self._bad_epochs = int(d["bad_epochs"])

    def lr_for_step(self, i: int) -> float:
        c = self.cfg
        if self.policy == "none":
            return self.base_lr
        if self.policy == "linear":
            return self.base_lr * max(
                0.0, 1.0 - max(0, i) / float(c.scheduler_n_epochs_decay + 1))
        if self.policy == "step":
            return self.base_lr * (0.5 ** (i // c.scheduler_lr_decay_iters))
        if self.policy == "cosine":
            return self.base_lr * 0.5 * (1.0 + math.cos(
                math.pi * i / c.n_epochs))
        if self.policy == "plateau":
            return self.base_lr * self._plateau_factor
        raise ValueError(self.policy)


class MultiPairScheduler:
    """Scheduler over P pairs (splice_tpu/trainer.py:128-182): the
    closed-form policies give every pair the same lr; plateau keeps its
    (factor, best, bad epochs) per pair, so a pair that stalls cuts its own
    lr only."""

    def __init__(self, cfg: Config, n_pairs: int):
        self.policy = cfg.scheduler_policy
        self.base_lr = cfg.lr
        self.n_pairs = n_pairs
        self._scalar = Scheduler(cfg)
        self._factor = np.ones(n_pairs)
        self._best = np.full(n_pairs, np.inf)
        self._bad = np.zeros(n_pairs, np.int64)

    def observe(self, losses) -> None:
        """One step's per-pair losses [P]: Scheduler.observe's rule,
        elementwise."""
        if self.policy != "plateau":
            return
        losses = np.asarray(losses, np.float64)
        improved = losses < self._best * (1.0 - 0.01)
        self._best = np.where(improved, losses, self._best)
        bad = np.where(improved, 0, self._bad + 1)
        cut = bad > PLATEAU_PATIENCE
        self._factor = np.where(cut, self._factor * 0.2, self._factor)
        self._bad = np.where(cut, 0, bad)

    def lr_for_step(self, i: int) -> np.ndarray:
        """The per-pair lr [P] in effect during step i."""
        if self.policy == "plateau":
            return self.base_lr * self._factor
        return np.full(self.n_pairs, self._scalar.lr_for_step(i))

    def state_dict(self) -> Dict[str, Any]:
        """Plateau's state per pair, as lists (a checkpoint holds no numpy
        arrays)."""
        return {"plateau_factor": self._factor.tolist(),
                "best": self._best.tolist(),
                "bad_epochs": self._bad.tolist()}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        factor = np.asarray(d["plateau_factor"], np.float64)
        if factor.shape != (self.n_pairs,):
            # else a checkpoint of another pair count loads and fails later
            raise ValueError(
                f"scheduler checkpoint holds {factor.shape} plateau state "
                f"but this run trains {self.n_pairs} pairs")
        self._factor = factor.copy()
        self._best = np.asarray(d["best"], np.float64).copy()
        self._bad = np.asarray(d["bad_epochs"], np.int64).copy()


@functools.lru_cache(maxsize=None)
def _cosf() -> Callable[[float], float]:
    """The C library's float32 cosine (what XLA's CPU backend calls)."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.restype, lib.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib.cosf


def device_lr(cfg: Config, i: int) -> np.float32:
    """The lr of step i under linear, step or cosine, bit for bit as the
    reference computes it in its step (device_lr_fn,
    splice_tpu/trainer.py:185-213) on XLA's CPU backend: its float32
    operations in the order XLA compiles them. There, and here: a division
    by a constant is a product with its float32 reciprocal (the cosine's
    pi is folded into that constant); 1 - x * r is one fused multiply-add
    (one rounding: exact in float64, then rounded); the cosine is the C
    library's cosf; a subnormal result is flushed to zero. A backend that
    folds, contracts or computes the cosine otherwise (the reference on a
    TPU) can round differently at any of these four places; in the cosine
    near the end of the schedule, where 1 + cos cancels, an ulp of the
    cosine is many ulps of the lr."""
    f = np.float32
    if cfg.scheduler_policy == "linear":
        r = f(1.0) / f(cfg.scheduler_n_epochs_decay + 1)
        v = f(cfg.lr) * max(f(0.0), f(1.0 - float(f(max(i, 0))) * float(r)))
    elif cfg.scheduler_policy == "step":
        v = f(cfg.lr) * np.power(f(0.5), f(i // cfg.scheduler_lr_decay_iters))
    elif cfg.scheduler_policy == "cosine":
        arg = f(i) * f(f(math.pi) * (f(1.0) / f(cfg.n_epochs)))
        v = f(cfg.lr * 0.5) * (f(1.0) + f(_cosf()(float(arg))))
    else:
        raise ValueError(f"{cfg.scheduler_policy!r} has no closed form")
    return f(0.0) if abs(v) < np.finfo(np.float32).tiny else f(v)


def chunk_lrs(cfg: Config, sched: Union[Scheduler, MultiPairScheduler],
              start: int, n: int) -> List[Any]:
    """The lr of each step of the chunk start..start+n-1: device_lr's
    per step under linear, step and cosine; under none and plateau the
    scheduler's value at the chunk's first step for all of them (the
    reference sets it once per dispatch): float32, a [P] vector from a
    MultiPairScheduler."""
    if cfg.scheduler_policy in ("none", "plateau"):
        return [np.float32(sched.lr_for_step(start))] * n
    return [device_lr(cfg, i) for i in range(start, start + n)]


@dataclasses.dataclass
class StepDraws:
    """Every random number one step uses: Python values as drawn, or the
    float32 tensors of a packed row (unpack_row)."""
    structure: Optional[Dict[str, Any]]   # structure_augment kwargs
    flip_B: Any
    crops_A: Tuple[Any, Any, Any]         # (side, tops, lefts)
    crops_B: Tuple[Any, Any, Any]


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


# A step's row: its lambdas (LAMBDA_ORDER), its lr (LR_COLUMN), then its
# draws: the structure coins and factors (flip, jitter_on, fb, fc, fs, fh,
# the jitter order, blur_on, sigma), flip_B, then each crop stack's side,
# tops and lefts.
N_LAMBDAS = len(losses_lib.LAMBDA_ORDER)
LR_COLUMN = N_LAMBDAS
_STRUCTURE = 12


def row_width(cfg: Config) -> int:
    return (N_LAMBDAS + 1 + _STRUCTURE + 1 + 2
            + 2 * (cfg.global_A_crops_n_crops + cfg.global_B_crops_n_crops))


def lambdas_vec(cfg: Config, step: int) -> np.ndarray:
    """The step's lambdas in LAMBDA_ORDER (splice_tpu/trainer.py:249)."""
    return lambdas_array(losses_lib.lambdas_for_step(cfg, step))


def lambdas_array(lam: Dict[str, float]) -> np.ndarray:
    return np.asarray([lam.get(k, 0.0) for k in losses_lib.LAMBDA_ORDER],
                      np.float32)


def pack_row(lam: np.ndarray, lr: float, draws: StepDraws) -> np.ndarray:
    """One step's lambdas, lr and draws as a float32 row (row_width
    values)."""
    st = draws.structure
    structure = ([st["flip"], st["jitter_on"], *st["jitter_factors"],
                  *st["jitter_order"], st["blur_on"], st["sigma"]]
                 if st is not None else [0.0] * _STRUCTURE)
    crops = [v for side, tops, lefts in (draws.crops_A, draws.crops_B)
             for v in (side, *tops, *lefts)]
    return np.asarray([*lam, lr, *structure, draws.flip_B, *crops],
                      np.float32)


def unpack_row(cfg: Config, row: torch.Tensor
               ) -> Tuple[torch.Tensor, StepDraws]:
    """(lambdas [5], draws), views of a packed row (its lr is
    row[LR_COLUMN])."""
    lam, d = row[:N_LAMBDAS], row[LR_COLUMN + 1:]
    structure = None
    if cfg.use_augmentations:
        structure = dict(flip=d[0], jitter_on=d[1], jitter_factors=d[2:6],
                         jitter_order=d[6:10], blur_on=d[10], sigma=d[11])
    at = _STRUCTURE + 1
    crops = []
    for n in (cfg.global_A_crops_n_crops, cfg.global_B_crops_n_crops):
        tops, lefts = at + 1, at + 1 + n
        crops.append((d[at], d[tops:lefts], d[lefts:lefts + n]))
        at = lefts + n
    return lam, StepDraws(structure, d[_STRUCTURE], *crops)


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
                                compute_dtype=dtype,
                                use_pallas=cfg.use_pallas_attention)


class SpliceTrainer:
    """The generator's flat parameter vector, its optimizer and learning
    rate, and the step."""

    def __init__(self, cfg: Config, pair: ImagePair,
                 extractor: ext_lib.VitExtractor,
                 gcfg: Optional[unet.SkipConfig] = None,
                 init_flat: Optional[torch.Tensor] = None, seed: int = 0):
        self.cfg, self.pair, self.extractor = cfg, pair, extractor
        self.gcfg = gcfg or unet.SkipConfig()
        self.gdt = _DTYPES[cfg.generator_compute_dtype]
        dev = pair.A.device
        tree = unet.init_skip_params(self.gcfg, cfg.init_gain, seed=seed,
                                     device=dev, init_type=cfg.init_type)
        flat, self.spec = unet.flatten_params(tree)
        if init_flat is not None:
            flat = init_flat.to(device=dev, dtype=torch.float32)
        self.flat = flat.detach().clone().requires_grad_(True)
        # the optimizer's lr: written from the step's row before each
        # update, so one captured graph serves every step of a schedule
        self.lr = torch.tensor(cfg.lr, dtype=torch.float32, device=dev)
        self.opt = make_optimizer(cfg, [self.flat], self.lr)
        # the shape of the packed row of one step (SpliceProgram)
        self.row_shape = (row_width(cfg),)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def params(self) -> Dict[str, Any]:
        return unet.unflatten_params(self.flat, self.spec)

    def restart(self, pair: ImagePair, init_flat: Optional[torch.Tensor],
                seed: int = 0) -> None:
        """Start a new optimisation in place (video mode's next frame): the
        pair's images copied into this trainer's, flat set to init_flat (or
        a fresh init from `seed`), the optimizer's state zeroed, which is a
        fresh state (the reference's init_state: tx.init). A captured step
        reads all of these by address, so none is rebound. The pair must
        have this trainer's geometry."""
        if pair.geometry != self.pair.geometry:
            raise ValueError(f"pair geometry {pair.geometry} differs from "
                             f"the trainer's {self.pair.geometry}")
        if init_flat is None:
            tree = unet.init_skip_params(self.gcfg, self.cfg.init_gain,
                                         seed=seed, device=self.flat.device,
                                         init_type=self.cfg.init_type)
            init_flat = unet.flatten_params(tree)[0]
        with torch.no_grad():
            for dst, src in ((self.pair.A, pair.A), (self.pair.B, pair.B),
                             (self.flat, init_flat)):
                if src is not dst:
                    dst.copy_(src, non_blocking=True)
            for state in self.opt.state.values():
                for v in state.values():
                    if isinstance(v, torch.Tensor):
                        v.zero_()

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """Copies of flat and of the optimizer's state tensors (by name)."""
        out = {"flat": self.flat.detach().clone()}
        for state in self.opt.state.values():
            out.update({k: v.clone() for k, v in state.items()
                        if isinstance(v, torch.Tensor)})
        return out

    def generate(self, params, x_nhwc: torch.Tensor,
                 groups: int = 1) -> torch.Tensor:
        """The generator by cfg.generator_layout, as the reference routes
        it (splice_tpu/trainer.py:262-266): the CHW route under
        cfg.generator_conv, or the NHWC route."""
        if self.cfg.generator_layout == "nhwc":
            return unet.skip_apply(params, self.gcfg, x_nhwc, self.gdt,
                                   groups)
        return unet.skip_apply_chw(params, self.gcfg, x_nhwc, self.gdt,
                                   groups, self.cfg.generator_conv)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Loss-side preprocessing (reference losses.py:17-24)."""
        y = img_ops.dino_global_resize(x, self.cfg.dino_global_patch_size,
                                       self.cfg.dino_global_max_size,
                                       self.cfg.antialias)
        return img_ops.imagenet_normalize(y)

    def as_row(self, draws: Union[StepDraws, torch.Tensor],
               lam: Union[Dict[str, float], torch.Tensor]) -> torch.Tensor:
        """The packed row of a step. Eager callers hand Python draws and a
        dict of lambdas (one copy to the device here; the step's lr is
        cfg.lr); the program hands rows it already holds there."""
        if isinstance(draws, torch.Tensor):
            return draws
        return torch.from_numpy(pack_row(lambdas_array(lam), self.cfg.lr,
                                         draws)).to(self.flat.device)

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

    def loss(self, draws: Union[StepDraws, torch.Tensor],
             lam: Union[Dict[str, float], torch.Tensor], entire: bool
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The step's total and loss terms. draws: Python draws with a dict
        of lambdas, or a packed row (then lam is ignored: the row holds
        them)."""
        lam, draws = unpack_row(self.cfg, self.as_row(draws, lam))
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

    def step(self, draws: Union[StepDraws, torch.Tensor],
             lam: Union[Dict[str, float], torch.Tensor], entire: bool
             ) -> Dict[str, torch.Tensor]:
        """One optimisation step; returns the detached loss terms (a regular
        step's entire terms as zeros, as the reference's) and "loss", the
        total. The one definition of a step: SpliceProgram runs it eagerly
        and captures it. The update runs at the row's lr."""
        row = self.as_row(draws, lam)
        total, parts = self.loss(row, None, entire)
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.lr.copy_(row[LR_COLUMN])
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

    def render_u8(self) -> torch.Tensor:
        """render as uint8 [H, W, 3] on the device
        (splice_tpu/trainer.py:488): a quarter of the bytes to copy off."""
        return img_ops.tensor2im(self.render())

    def state_dict(self) -> Dict[str, Any]:
        """The flat parameters and the optimizer's per-parameter state (on
        CUDA Adam's step count is a device tensor)."""
        return {"flat": self.flat.detach(),
                "opt": self.opt.state_dict()["state"]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore state_dict() in place into flat, and the optimizer's
        state under this trainer's own hyperparameters. Do this before a
        SpliceProgram captures: a graph reads the parameters and the
        optimizer's state by address."""
        with torch.no_grad():
            self.flat.copy_(state["flat"])
        self.opt.load_state_dict({
            "state": copy.deepcopy(state["opt"]),   # never shared
            "param_groups": self.opt.state_dict()["param_groups"]})
        # load_state_dict copies the groups: the optimizer must read the lr
        # tensor that each step writes
        for group in self.opt.param_groups:
            group["lr"] = self.lr


# the columns of a program's losses
LOSS_KEYS = losses_lib.LOSS_NAMES + ("loss",)


def fetch_scalars(parts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy for a dict of device scalars
    (splice_tpu/trainer.py:242)."""
    keys, vals = fetch_stacked(parts)
    return {k: float(v) for k, v in zip(keys, vals)}


def launch_counts() -> Dict[str, Tuple[int, int]]:
    """(launches, tensor-core launches) of every kernel wrapper so far."""
    return {name: (fn.launches, getattr(fn, "tc_launches", 0))
            for mod in (attn_ops, conv_ops) for name, fn in vars(mod).items()
            if name.endswith("_cuda") and hasattr(fn, "launches")}


@dataclasses.dataclass
class CapturedStep:
    """One step captured as a CUDA graph: the wrapper calls recorded in it
    (launch_counts over the capture; each launches once per replay) and
    its replays so far."""
    graph: Any
    launches: Dict[str, Tuple[int, int]]
    replays: int = 0


class SpliceProgram:
    """The reference's chunked step dispatch for one trainer
    (splice_tpu/trainer.py:227-240,361-430: step_chunk, step_entire), and
    over a parallel.pair_parallel.MultiPairTrainer its multi-pair program
    (splice_tpu/parallel/pair_parallel.py:54-249).

    run(rows, entire) runs len(rows) steps of one class, row i being step
    i's pack_row (over P pairs, [P, row_width]: each pair's), and returns
    their [n, 6] losses in LOSS_KEYS order ([n, P, 6] over P pairs): the
    reference's loss_seq, read in one copy. run(rows, False) is the
    reference's step_chunk (step_regular: one row), run(row, True) its
    step_entire (one row). dispatch and fetch are its two halves;
    fetch_async issues the read without waiting.

    On CUDA each step class is one captured graph of SpliceTrainer.step,
    keyed also by the conv route that the capture reads
    (ops.conv.SAME_BORDER_KERNELS, DW_TAP_ON_N). Its static inputs are the
    rows (filled by one copy from pinned memory per chunk) and a step
    counter on the device, by which each replay reads its row and writes
    its losses, then advances it. The first step of each key runs eagerly
    on a side stream (PyTorch's warm-up before a whole-network capture; a
    capture runs no kernel), then the key is captured and every later step
    replays. The graphs share one memory pool, as they never run together.
    A capture that fails raises: on the card there is no eager fallback. On
    the CPU the same body runs eagerly, and so does a trainer whose step
    spans several distinct cards (its `devices`: a tensor-parallel ViT),
    since a graph is captured on one device's stream.
    """

    def __init__(self, trainer, capacity: int):
        dev = trainer.device
        # a trainer across several devices (a tensor-parallel ViT over
        # distinct cards) steps eagerly: a graph is captured on one
        # device's stream
        devices = {str(d) for d in getattr(trainer, "devices", (dev,))}
        self.trainer = trainer
        self.graphed = dev.type == "cuda" and len(devices) == 1
        shape = trainer.row_shape
        # the step's loss columns (tools.inversion's step has one)
        self.keys = getattr(trainer, "loss_keys", LOSS_KEYS)
        self.rows = torch.zeros(capacity, *shape, device=dev)
        self.loss_seq = torch.zeros(capacity, *shape[:-1], len(self.keys),
                                    device=dev)
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)
        self.graphs: Dict[Tuple[bool, bool, bool], CapturedStep] = {}
        self.captures = 0
        self._pool = None

    def _body(self, entire: bool) -> None:
        row = self.rows.index_select(0, self.counter)[0]
        parts = self.trainer.step(row, None, entire)
        vals = torch.stack([parts[k] for k in self.keys], dim=-1)
        self.loss_seq.index_copy_(0, self.counter, vals[None])
        self.counter += 1

    def dispatch(self, rows: np.ndarray, entire: bool) -> int:
        """Queue len(rows) steps with no host read; returns their number."""
        n = len(rows)
        if not 0 < n <= self.rows.shape[0] or (entire and n != 1):
            raise ValueError(f"{n} rows for a program of {self.rows.shape[0]}"
                             f"{' (entire-A: 1)' if entire else ''}")
        host = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        if self.graphed:
            host = host.pin_memory()
        with _on_device(self.rows.device):
            self.rows[:n].copy_(host, non_blocking=self.graphed)
            self.counter.zero_()
            for _ in range(n):
                self._step(entire)
        return n

    def fetch(self, n: int) -> np.ndarray:
        """The last dispatch's [n, 6] ([n, P, 6]) losses: one
        device-to-host copy (a copy on the CPU too: the next dispatch
        writes loss_seq again)."""
        return self.loss_seq[:n].to("cpu", copy=True).numpy()

    def fetch_async(self, n: int) -> HostCopy:
        """The last dispatch's losses on their way to the host,
        queued behind it and ahead of the next dispatch (which writes
        loss_seq again): nothing waits until the HostCopy is read."""
        return HostCopy(self.loss_seq[:n])

    def run(self, rows: np.ndarray, entire: bool) -> np.ndarray:
        return self.fetch(self.dispatch(rows, entire))

    def _step(self, entire: bool) -> None:
        if not self.graphed:
            self._body(entire)
            return
        key = (entire, conv_ops.SAME_BORDER_KERNELS, conv_ops.DW_TAP_ON_N)
        cap = self.graphs.get(key)
        if cap is None:
            self.graphs[key] = self._capture(entire)
            return
        cap.graph.replay()
        cap.replays += 1

    def _capture(self, entire: bool) -> CapturedStep:
        """Run this step eagerly on a side stream, then capture it."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body(entire)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            self._body(entire)
        self._pool = graph.pool()
        self.captures += 1
        after = launch_counts()
        return CapturedStep(graph, {
            k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
            for k in after if after[k] != before[k]})


def _on_device(dev: torch.device):
    """The CUDA device context of dev (its current stream: the one a
    capture and a replay use), or nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def checkpointing(cfg: Config) -> bool:
    return cfg.checkpoint_every > 0 and bool(cfg.checkpoint_dir)


def boundaries_after(cfg: Config, i: int, total_steps: int) -> int:
    """Next step index (exclusive) where the host must step in after step
    i (splice_tpu/trainer.py:644-676): the run's end, the next entire-A
    step, the log boundary, the checkpoint boundary, the lambda-warmup
    switch, the profile window's marks, and under plateau the chunk
    cap."""
    cands = [total_steps]
    if cfg.lambda_entire_ssim > 0 or cfg.lambda_entire_cls > 0:
        cands.append(((i // cfg.entire_A_every) + 1) * cfg.entire_A_every)
    # a step index log_images_freq*k - 1 must END a chunk
    k = (i + 1 + cfg.log_images_freq - 1) // cfg.log_images_freq
    cands.append(k * cfg.log_images_freq)
    if checkpointing(cfg):
        k = (i + 1 + cfg.checkpoint_every - 1) // cfg.checkpoint_every
        cands.append(k * cfg.checkpoint_every)
    if i < cfg.cls_warmup:
        cands.append(cfg.cls_warmup)
    if cfg.profile_dir:
        cands += [cfg.profile_start_step,
                  cfg.profile_start_step + cfg.profile_n_steps]
    if cfg.scheduler_policy == "plateau":
        # the lr of a dispatch follows the losses before it: a cut lands
        # within one patience window
        cands.append(i + PLATEAU_PATIENCE + 1)
    return min(c for c in cands if c > i)


def chunk_plan(cfg: Config, total_steps: int, start: int = 0,
               cap: Optional[int] = None) -> List[Tuple[int, int, bool]]:
    """(first step, steps, entire) of each dispatch of a run from step
    `start` (a resumed run's first step), in order: an entire-A step
    alone, else the regular steps up to boundaries_after, and at most
    `cap` of them (a program built for shorter chunks)."""
    plan, i = [], start
    while i < total_steps:
        if losses_lib.is_entire_step(cfg, i):
            plan.append((i, 1, True))
            i += 1
        else:
            end = boundaries_after(cfg, i, total_steps)
            if cap is not None:
                end = min(end, i + cap)
            plan.append((i, end - i, False))
            i = end
    return plan


def resolve_seed(cfg: Config) -> int:
    if cfg.seed == -1:
        return int(np.random.randint(2 ** 31 - 1))
    return cfg.seed


def run_state(trainer: SpliceTrainer, sched: Scheduler,
              gen: torch.Generator) -> Dict[str, Any]:
    """What a checkpoint holds: the trainer's state, the scheduler's
    (plateau's), and the host generator's. The port draws every step from
    one sequential generator (the reference folds the step index into its
    key), so a resumed run draws what the uninterrupted run would only
    from the generator's saved state."""
    return {**trainer.state_dict(), "sched": sched.state_dict(),
            "gen": gen.get_state()}


def load_run_state(state: Dict[str, Any], trainer: SpliceTrainer,
                   sched: Scheduler, gen: torch.Generator) -> None:
    trainer.load_state_dict(state)
    sched.load_state_dict(state["sched"])
    gen.set_state(state["gen"])


def train_pair(cfg: Config, n_steps: Optional[int] = None, device=None,
               dataroot: Optional[str] = None,
               pair: Optional[ImagePair] = None,
               extractor: Optional[ext_lib.VitExtractor] = None,
               callback: Optional[Callable[[torch.Tensor], None]] = None,
               init_params: Union[torch.Tensor, Dict[str, Any], None] = None,
               program: Optional[SpliceProgram] = None,
               saver: Optional[AsyncImageSaver] = None,
               logger: Optional[MetricsLogger] = None,
               want_output: bool = True) -> Dict[str, Any]:
    """Optimise one pair to step n_steps (default cfg.n_epochs) on
    `device` (default cfg.device, i.e. CUDA), in the chunks of chunk_plan,
    each dispatched through a SpliceProgram (captured graphs on CUDA);
    from the latest checkpoint in cfg.resume_from if there is one.

    At every log_images_freq-th step and at the end (the reference's loop,
    splice_tpu/trainer.py:700-800): the output rendered to uint8 on the
    device and handed to an AsyncImageSaver for <dataroot>/out/output.png
    (must-write at the end), the chunk's last losses with the lr and
    steps/s to a MetricsLogger (cfg.metrics_path, default
    <dataroot>/out/metrics.jsonl; the device memory every tenth time),
    then callback(the uint8 frame). Both workers wait on their own copy's
    event: the boundary queues work and waits for nothing. With cfg.checkpoint_every and cfg.checkpoint_dir, a
    checkpoint every checkpoint_every steps; a save waits for the device
    once. With cfg.profile_dir, a device trace of steps
    [profile_start_step, profile_start_step + profile_n_steps) into it
    (TraceWindow: the device drains at both marks, and only there).

    On CUDA the loop queues each chunk, then reads the one before it, so
    the device always holds queued work while the host reads losses and
    draws the next rows. It reads each chunk before it queues the next
    under plateau, where the next chunk's lr follows this one's losses
    (the reference's one read per chunk), and on the CPU, where a
    dispatch computes its chunk and nothing overlaps.

    Video mode's arguments (splice_tpu/trainer.py:559-620): init_params
    (a flat vector or a parameter tree) warm-starts the generator, with a
    fresh optimizer state, and skips resume_from. `program`, the result's
    program of an earlier call on a pair of the same geometry, is reused:
    its trainer restarts in place (SpliceTrainer.restart), so on CUDA its
    captured graphs replay and nothing is captured again; a chunk longer
    than the program's rows is cut. `extractor` is then the program's.
    `saver` and `logger` are shared and left open. want_output=False skips
    the final float render and the final output.png (the uint8 frame is
    still returned).

    Returns the per-step losses (every term and the total) and seconds
    (a chunk's seconds: from the previous chunk's read to its own, over
    its steps), steps_per_sec (the sustained rate of this call's steps,
    log boundaries included), the host seconds of each log boundary's
    queueing, the rows dispatched, the output image (float and the last
    uint8 frame; output None without want_output), the trainer, the
    program, the chunk sizes, the first step, the final flat parameters
    (a copy), from before the first step, a snapshot of flat and the
    optimizer's state (start_state), and the trace's path (trace_path,
    None without one)."""
    dev = resolve_device(device if device is not None else cfg.device)
    seed = resolve_seed(cfg)
    print(f"running with seed: {seed}.")
    root = dataroot or cfg.dataroot
    if pair is None:
        pair = load_pair(cfg, root, dev)
    init_flat = init_params
    if isinstance(init_params, dict):
        init_flat = unet.flatten_params(init_params)[0]
    if program is not None:
        if init_params is None and cfg.resume_from:
            # a restore replaces the optimizer's state tensors, which the
            # program's graphs read by address
            raise ValueError("resume_from with a reused program")
        trainer = program.trainer
        trainer.restart(pair, init_flat, seed)
    else:
        if extractor is None:
            extractor = make_extractor_from_config(cfg, dev)
        trainer = SpliceTrainer(cfg, pair, extractor, init_flat=init_flat,
                                seed=seed)
    pair = trainer.pair
    gen = torch.Generator().manual_seed(seed)
    sched = Scheduler(cfg)
    first = 0
    if init_params is None and cfg.resume_from:
        rck = Checkpointer(cfg.resume_from)
        step0 = rck.latest_step()
        if step0 is not None:
            load_run_state(rck.restore(step0), trainer, sched, gen)
            first = step0
            print(f"resumed from {cfg.resume_from} at step {step0}")
    ckpt = Checkpointer(cfg.checkpoint_dir) if checkpointing(cfg) else None
    total_steps = n_steps if n_steps is not None else cfg.n_epochs
    if program is None:
        plan = chunk_plan(cfg, total_steps, first)
        program = SpliceProgram(trainer,
                                max((n for _, n, _ in plan), default=1))
    else:
        plan = chunk_plan(cfg, total_steps, first, program.rows.shape[0])
    start_state = trainer.snapshot()
    own_saver, own_logger = saver is None, logger is None
    if own_saver:
        saver = AsyncImageSaver()
    if own_logger:
        logger = MetricsLogger(
            cfg.metrics_path or os.path.join(root, "out", "metrics.jsonl"))
    out_png = os.path.join(root, "out", "output.png")
    freq = cfg.log_images_freq
    read_now = cfg.scheduler_policy == "plateau" or not program.graphed
    losses: List[Dict[str, float]] = []
    step_seconds: List[float] = []
    boundary_seconds: List[float] = []
    all_rows: List[np.ndarray] = []
    pending: List[Tuple[int, HostCopy]] = []
    out_u8 = None
    timer = StepTimer()
    window = (TraceWindow(cfg.profile_dir, cfg.profile_start_step,
                          cfg.profile_n_steps, dev)
              if cfg.profile_dir else None)

    def read_chunks(keep: int) -> None:
        """Read the dispatched chunks, oldest first (each read waits for
        its chunk), until `keep` are left unread."""
        while len(pending) > keep:
            n, read = pending.pop(0)
            seq = read.wait().numpy()
            step_seconds.extend([timer.tick(n) / n] * n)
            losses.extend(dict(zip(LOSS_KEYS, map(float, r))) for r in seq)
            for r in seq:
                sched.observe(float(r[-1]))

    try:
        for start, n, entire in plan:
            lrs = chunk_lrs(cfg, sched, start, n)
            rows = np.stack([pack_row(lambdas_vec(cfg, i), lr,
                                      sample_step_draws(cfg, pair, gen))
                             for i, lr in zip(range(start, start + n), lrs)])
            if window is not None:
                window.at(start)
            program.dispatch(rows, entire)
            all_rows.append(rows)
            pending.append((n, program.fetch_async(n)))
            step = start + n
            if (0 <= cfg.fault_inject_step < step
                    and os.environ.get("SPLICE_RESTART_ATTEMPT", "0") == "0"):
                # first attempt only: the relaunch resumes and runs through
                raise RuntimeError(
                    f"injected fault after step {cfg.fault_inject_step}")
            if read_now:
                read_chunks(0)
            if step % freq == 0 or step >= total_steps:
                t0 = time.perf_counter()
                out_u8 = trainer.render_u8()
                if want_output or step < total_steps:
                    saver.save(out_u8, out_png,
                               must_write=step >= total_steps)
                # the chunk's last losses, still on the device
                logger.log_async(
                    step - 1, dict(zip(LOSS_KEYS, program.loss_seq[n - 1])),
                    {"lr": sched.lr_for_step(step - 1),
                     "steps_per_sec": timer.rate()},
                    with_memory=(step // freq) % 10 == 0)
                if callback is not None:
                    callback(out_u8)
                boundary_seconds.append(time.perf_counter() - t0)
            if ckpt is not None and step % cfg.checkpoint_every == 0:
                ckpt.save(step, run_state(trainer, sched, gen))
            read_chunks(1)     # the chunk before this one
        read_chunks(0)
        if out_u8 is None:
            # no step to run (a resumed run already complete): the output
            # still lands
            out_u8 = trainer.render_u8()
            if want_output:
                saver.save(out_u8, out_png, must_write=True)
        output = trainer.render() if want_output else None
    finally:
        if window is not None:
            window.close()
        if own_saver:
            saver.close()
        if own_logger:
            logger.close()
        if ckpt is not None:
            ckpt.wait()
    return {"losses": losses, "step_seconds": step_seconds,
            "steps_per_sec": timer.rate(), "chunks": [n for _, n, _ in plan],
            "boundary_seconds": boundary_seconds,
            "rows": (np.concatenate(all_rows) if all_rows
                     else np.zeros((0, row_width(cfg)), np.float32)),
            "output": output, "output_u8": out_u8, "trainer": trainer,
            "program": program, "seed": seed, "first_step": first,
            "output_path": out_png, "flat": trainer.flat.detach().clone(),
            "start_state": start_state,
            "trace_path": window.path if window is not None else None}


def train_model(dataroot: Optional[str] = None,
                callback: Optional[Callable[[torch.Tensor], None]] = None,
                cfg: Optional[Config] = None) -> Dict[str, Any]:
    """Reference-parity entry point (splice_tpu/trainer.py:819-830): the
    config at conf/default/config.yaml if present (else the defaults),
    `dataroot` over it, then train_pair; callback(uint8 frame on the
    device) at every log boundary."""
    if cfg is None:
        default = pathlib.Path("conf/default/config.yaml")
        cfg = load_config(str(default) if default.exists() else None)
    if dataroot is not None:
        cfg = dataclasses.replace(cfg, dataroot=dataroot)
    return train_pair(cfg, callback=callback)
