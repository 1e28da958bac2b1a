"""Training loop (port of splice_tpu/trainer.py:46-68,219-430,525-800).

One step: augmentation and global crops on the device -> the skip U-Net over
the A and B crop stacks as one batch of 2 (BatchNorm per stack) -> loss-side
resize and ImageNet normalisation -> the frozen ViT (generated batch with
gradients, targets without) -> the splice losses (plus the entire-image
losses on every entire_A_every-th step) -> Adam over one flat fp32
parameter vector.

The host draws each step's random numbers from a torch.Generator and packs
them, with the step's lambdas, into one float32 row: the step reads its
draws and lambdas as device data and branches on none of them. train_pair
cuts the run into chunks where the host must step in (boundaries_after, as
the reference's) and dispatches each through SpliceProgram: on CUDA the
regular step and the entire-A step are each one captured CUDA graph (the
reference's scanned chunk and jitted entire step), replayed with no host
read inside a chunk, and the chunk's losses come back in one copy. On the
CPU the program runs the same loop eagerly.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from splice_tpu_torch import losses as losses_lib
from splice_tpu_torch import resolve_device
from splice_tpu_torch.config import Config
from splice_tpu_torch.data import ImagePair, load_pair
from splice_tpu_torch.models import extractor as ext_lib
from splice_tpu_torch.models import unet, vit as vit_lib
from splice_tpu_torch.models.weights import load_or_init_vit_params
from splice_tpu_torch.ops import attention as attn_ops
from splice_tpu_torch.ops import conv as conv_ops
from splice_tpu_torch.ops import image as img_ops
from splice_tpu_torch.utils.io import save_image
from splice_tpu_torch.utils.metrics import StepTimer, fetch_stacked

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_optimizer(cfg: Config, params: List[torch.Tensor]
                   ) -> torch.optim.Optimizer:
    """Adam with the reference's settings (torch's update equals
    optax.adam's: eps added after the bias-corrected square root). On CUDA
    it keeps its step count on the device (capturable), so that a captured
    graph holds the update; eager steps there use the same form."""
    return torch.optim.Adam(params, lr=cfg.lr, eps=1e-8,
                            betas=(cfg.optimizer_beta1, cfg.optimizer_beta2),
                            capturable=params[0].is_cuda)


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


# A step's row: its lambdas (LAMBDA_ORDER), then its draws: the structure
# coins and factors (flip, jitter_on, fb, fc, fs, fh, the jitter order,
# blur_on, sigma), flip_B, then each crop stack's side, tops and lefts.
N_LAMBDAS = len(losses_lib.LAMBDA_ORDER)
_STRUCTURE = 12


def row_width(cfg: Config) -> int:
    return (N_LAMBDAS + _STRUCTURE + 1 + 2
            + 2 * (cfg.global_A_crops_n_crops + cfg.global_B_crops_n_crops))


def lambdas_vec(cfg: Config, step: int) -> np.ndarray:
    """The step's lambdas in LAMBDA_ORDER (splice_tpu/trainer.py:249)."""
    return lambdas_array(losses_lib.lambdas_for_step(cfg, step))


def lambdas_array(lam: Dict[str, float]) -> np.ndarray:
    return np.asarray([lam.get(k, 0.0) for k in losses_lib.LAMBDA_ORDER],
                      np.float32)


def pack_row(lam: np.ndarray, draws: StepDraws) -> np.ndarray:
    """One step's lambdas and draws as a float32 row (row_width values)."""
    st = draws.structure
    structure = ([st["flip"], st["jitter_on"], *st["jitter_factors"],
                  *st["jitter_order"], st["blur_on"], st["sigma"]]
                 if st is not None else [0.0] * _STRUCTURE)
    crops = [v for side, tops, lefts in (draws.crops_A, draws.crops_B)
             for v in (side, *tops, *lefts)]
    return np.asarray([*lam, *structure, draws.flip_B, *crops], np.float32)


def unpack_row(cfg: Config, row: torch.Tensor
               ) -> Tuple[torch.Tensor, StepDraws]:
    """(lambdas [5], draws as views of the row) of a packed row."""
    lam, d = row[:N_LAMBDAS], row[N_LAMBDAS:]
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

    def as_row(self, draws: Union[StepDraws, torch.Tensor],
               lam: Union[Dict[str, float], torch.Tensor]) -> torch.Tensor:
        """The packed row of a step. Eager callers hand Python draws and a
        dict of lambdas (one copy to the device here); the program hands
        rows it already holds there."""
        if isinstance(draws, torch.Tensor):
            return draws
        return torch.from_numpy(pack_row(lambdas_array(lam), draws)).to(
            self.flat.device)

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
        and captures it."""
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
    (splice_tpu/trainer.py:227-240,361-430: step_chunk, step_entire).

    run(rows, entire) runs len(rows) steps of one class, row i being step
    i's pack_row, and returns their [n, 6] losses in LOSS_KEYS order: the
    reference's loss_seq, read in one copy. run(rows, False) is the
    reference's step_chunk (step_regular: one row), run(row, True) its
    step_entire (one row). dispatch and fetch are its two halves.

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
    the CPU the same body runs eagerly.
    """

    def __init__(self, trainer: SpliceTrainer, capacity: int):
        dev = trainer.flat.device
        self.trainer, self.graphed = trainer, dev.type == "cuda"
        self.rows = torch.zeros(capacity, row_width(trainer.cfg), device=dev)
        self.loss_seq = torch.zeros(capacity, len(LOSS_KEYS), device=dev)
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)
        self.graphs: Dict[Tuple[bool, bool, bool], CapturedStep] = {}
        self._pool = None

    def _body(self, entire: bool) -> None:
        row = self.rows.index_select(0, self.counter)[0]
        parts = self.trainer.step(row, None, entire)
        vals = torch.stack([parts[k] for k in LOSS_KEYS])
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
        self.rows[:n].copy_(host, non_blocking=self.graphed)
        self.counter.zero_()
        for _ in range(n):
            self._step(entire)
        return n

    def fetch(self, n: int) -> np.ndarray:
        """The last dispatch's [n, 6] losses: one device-to-host copy."""
        return self.loss_seq[:n].cpu().numpy()

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
        after = launch_counts()
        return CapturedStep(graph, {
            k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
            for k in after if after[k] != before[k]})


def boundaries_after(cfg: Config, i: int, total_steps: int) -> int:
    """Next step index (exclusive) where the host must step in after step
    i (splice_tpu/trainer.py:644-676), from the candidates whose keys the
    port has: the run's end, the next entire-A step, the log boundary and
    the lambda-warmup switch. (The reference's checkpoint, profile and
    plateau candidates come with their keys.)"""
    cands = [total_steps]
    if cfg.lambda_entire_ssim > 0 or cfg.lambda_entire_cls > 0:
        cands.append(((i // cfg.entire_A_every) + 1) * cfg.entire_A_every)
    # a step index log_images_freq*k - 1 must END a chunk
    k = (i + 1 + cfg.log_images_freq - 1) // cfg.log_images_freq
    cands.append(k * cfg.log_images_freq)
    if i < cfg.cls_warmup:
        cands.append(cfg.cls_warmup)
    return min(c for c in cands if c > i)


def chunk_plan(cfg: Config, total_steps: int) -> List[Tuple[int, int, bool]]:
    """(first step, steps, entire) of each dispatch of a run, in order: an
    entire-A step alone, else the regular steps up to boundaries_after."""
    plan, i = [], 0
    while i < total_steps:
        if losses_lib.is_entire_step(cfg, i):
            plan.append((i, 1, True))
            i += 1
        else:
            end = boundaries_after(cfg, i, total_steps)
            plan.append((i, end - i, False))
            i = end
    return plan


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
    `device` (default cfg.device, i.e. CUDA), in the chunks of chunk_plan,
    each dispatched through a SpliceProgram (captured graphs on CUDA).
    Writes <dataroot>/out/output.png at every log_images_freq-th step and
    at the end.

    Returns the per-step losses (every term and the total, from each
    chunk's one read) and wall seconds, the output image, the trainer and
    the program, the chunk sizes and steps_per_sec. A chunk's wall time
    (its draws, its dispatch and its loss read, which waits for the device)
    is divided evenly over its steps; steps_per_sec is the loop's sustained
    rate, the renders and saves at log boundaries included."""
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
    plan = chunk_plan(cfg, total_steps)
    program = SpliceProgram(trainer, max((n for _, n, _ in plan), default=1))
    out_png = os.path.join(root, "out", "output.png")
    losses: List[Dict[str, float]] = []
    step_seconds: List[float] = []
    timer = StepTimer()
    for start, n, entire in plan:
        t0 = time.perf_counter()
        rows = np.stack([pack_row(lambdas_vec(cfg, i),
                                  sample_step_draws(cfg, pair, gen))
                         for i in range(start, start + n)])
        seq = program.run(rows, entire)
        step_seconds += [(time.perf_counter() - t0) / n] * n
        timer.tick(n)
        losses += [dict(zip(LOSS_KEYS, map(float, r))) for r in seq]
        if (start + n) % cfg.log_images_freq == 0 and start + n < total_steps:
            save_image(trainer.render(), out_png)
    output = trainer.render()
    save_image(output, out_png)
    return {"losses": losses, "step_seconds": step_seconds,
            "steps_per_sec": timer.rate(), "chunks": [n for _, n, _ in plan],
            "output": output, "trainer": trainer, "program": program,
            "seed": seed, "output_path": out_png}
