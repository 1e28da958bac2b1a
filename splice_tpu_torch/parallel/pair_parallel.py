"""Several image pairs in one training step (port of
splice_tpu/parallel/pair_parallel.py, in its one-device form).

P independent pairs train together: each has its own generator (one flat
parameter vector), its own optimizer state and learning rate, and its own
random draws; one step runs every pair's generator (a loop over the pairs,
BatchNorm per crop stack as in the single-pair step), the frozen ViT once
over all pairs' generated crops with gradients and once over their targets
without, the losses reduced per pair, one backward of the sum of the pairs'
totals and each pair's update at its own lr. Nothing couples two pairs: a
pair's gradient is its own total's.

A step's draws, lambdas and lr are one packed row per pair ([P, row_width],
each pair's row laid out as trainer.pack_row's), so on CUDA each step class
is one captured CUDA graph (trainer.SpliceProgram over a MultiPairTrainer:
the reference's multi-pair program), and a chunk's losses come back as one
[n, P, 6] copy. train_pairs runs the reference's loop around it: the chunk
plan, per-pair outputs and metrics, the per-pair scheduler, checkpoints and
resume.

Over a ("dp", "tp") mesh (parallel.mesh; the reference's
build_multi_pair_program, :54-249) dp splits the P pairs into dp groups of
P/dp, each a MultiPairTrainer with its own SpliceProgram on its group's
first device; the frozen ViT is replicated over dp and, with tp > 1,
sharded over the group's tp devices (models.vit's tensor-parallel block).
Each pair draws from its own generator, keyed by its global id, so a
pair's steps do not depend on dp. The loop queues every group's chunk
before it reads any group's losses. A group on one card (tp = 1, or tp
ranks that share one card) replays captured graphs; a tensor-parallel
group across distinct cards steps eagerly.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splice_tpu_torch import losses as losses_lib
from splice_tpu_torch import resolve_device
from splice_tpu_torch.config import Config
from splice_tpu_torch.data import (ImagePair, crop_canvas_size,
                                   first_image_in, load_image)
from splice_tpu_torch.models import extractor as ext_lib
from splice_tpu_torch.models import unet
from splice_tpu_torch.ops import image as img_ops
from splice_tpu_torch.parallel import mesh as mesh_lib
from splice_tpu_torch.trainer import (LOSS_KEYS, LR_COLUMN, N_LAMBDAS,
                                      MultiPairScheduler, SpliceProgram,
                                      SpliceTrainer, checkpointing,
                                      chunk_lrs, chunk_plan, lambdas_vec,
                                      make_extractor_from_config, pack_row,
                                      resolve_seed, row_width,
                                      sample_step_draws, unpack_row)
from splice_tpu_torch.utils.checkpoint import Checkpointer
from splice_tpu_torch.utils.io import AsyncImageSaver
from splice_tpu_torch.utils.metrics import HostCopy, MetricsLogger, StepTimer


def pair_seeds(seed: int, pair_id: int) -> Tuple[int, int]:
    """(init seed, draw seed) of the pair `pair_id` of a run seeded with
    `seed`: the counterpart of the reference's per-pair keys (split for
    the inits, fold_in of the global pair id for the draws). Each pair
    draws from its own generator, so its draws do not depend on the other
    pairs."""
    init, draws = np.random.SeedSequence([seed, pair_id]).generate_state(2)
    return int(init), int(draws)


def load_pair_batch(cfg: Config, dataroots: Sequence[str], image_hw: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """Load P pairs (splice_tpu/parallel/pair_parallel.py:251-277): each
    image's shorter side resized to image_hw (the long side truncated, as
    torchvision does), then centre-cropped to image_hw x image_hw, so that
    every pair has one geometry; BtoA swaps each pair. Returns {"A": [P,
    image_hw, image_hw, 3], "B": ...} on `device` (default cfg.device)."""
    device = resolve_device(device if device is not None else cfg.device)

    def square(np_img: np.ndarray) -> torch.Tensor:
        h, w, _ = np_img.shape
        short = min(h, w)
        scale_hw = (int(h * image_hw / short), int(w * image_hw / short))
        t = img_ops.resize(torch.from_numpy(np_img), scale_hw,
                           antialias=cfg.antialias)
        top = (scale_hw[0] - image_hw) // 2
        left = (scale_hw[1] - image_hw) // 2
        return t[top:top + image_hw, left:left + image_hw]

    As, Bs = [], []
    for root in dataroots:
        a = load_image(first_image_in(os.path.join(root, "A")), cfg.A_resize)
        b = load_image(first_image_in(os.path.join(root, "B")), cfg.B_resize)
        if cfg.direction == "BtoA":
            a, b = b, a
        As.append(square(a))
        Bs.append(square(b))
    return {"A": torch.stack(As).to(device), "B": torch.stack(Bs).to(device)}


class MultiPairTrainer:
    """P pairs' generators, optimizers and learning rates (one
    SpliceTrainer each, sharing the extractor), and their joint step
    (splice_tpu/parallel/pair_parallel.py:102-157: per_pair_loss,
    per_pair_step). Every pair must have one geometry. init_flats and
    seeds, one per pair, are passed to each pair's SpliceTrainer."""

    def __init__(self, cfg: Config, pairs: Sequence[ImagePair],
                 extractor: ext_lib.VitExtractor,
                 gcfg: Optional[unet.SkipConfig] = None,
                 init_flats: Optional[Sequence[torch.Tensor]] = None,
                 seeds: Optional[Sequence[int]] = None):
        if len({p.geometry for p in pairs}) != 1:
            raise ValueError("the pairs of one step need one geometry: "
                             f"{[p.geometry for p in pairs]}")
        n = len(pairs)
        init_flats = init_flats if init_flats is not None else [None] * n
        seeds = seeds if seeds is not None else [0] * n
        self.cfg, self.extractor = cfg, extractor
        self.trainers = [SpliceTrainer(cfg, pair, extractor, gcfg, flat, s)
                         for pair, flat, s in zip(pairs, init_flats, seeds)]
        # the shape of the packed rows of one step (SpliceProgram)
        self.row_shape = (n, row_width(cfg))

    @property
    def device(self) -> torch.device:
        return self.trainers[0].device

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Every device the step runs on: the ViT's tensor-parallel ranks',
        or the pairs' one."""
        return self.extractor.tp_devices or (self.device,)

    @property
    def n_pairs(self) -> int:
        return len(self.trainers)

    def loss(self, rows: torch.Tensor, entire: bool
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Every pair's total [P] and loss terms ([P] each), from rows [P,
        row_width] on the device (row p: pair p's lambdas, lr and
        draws)."""
        gens, tgts, params = [], [], []
        for t, row in zip(self.trainers, rows):
            _, draws = unpack_row(self.cfg, row)
            p = t.params()
            crops_A, crops_B = t.sample_inputs(draws)
            if crops_A.shape == crops_B.shape:
                # one generator pass over both stacks, BatchNorm per stack
                outs = t.generate(p, torch.cat([crops_A, crops_B]), groups=2)
            else:
                outs = torch.cat([t.generate(p, crops_A),
                                  t.generate(p, crops_B)])
            gens.append(outs)
            tgts.append(torch.cat([crops_A, crops_B]))
            params.append(p)
        first = self.trainers[0]
        parts, aux = losses_lib.splice_losses_pairs(
            self.extractor, first.transform(torch.stack(gens)),
            first.transform(torch.stack(tgts)),
            self.cfg.global_A_crops_n_crops)
        if entire:
            gen_entire = torch.cat([t.generate(p, t.pair.A[None])
                                    for t, p in zip(self.trainers, params)])
            entire_A = torch.stack([t.pair.A for t in self.trainers])
            parts.update(losses_lib.entire_losses_pairs(
                self.extractor, first.transform(gen_entire),
                first.transform(entire_A), aux["cls_B"]))
        # each pair's lambdas, [5, P]: lambdas[i] weighs term i per pair
        total = losses_lib.weighted_total(parts, rows[:, :N_LAMBDAS].T)
        return total, parts

    def step(self, rows: torch.Tensor, lam: Any, entire: bool
             ) -> Dict[str, torch.Tensor]:
        """One step of every pair from rows [P, row_width] (lam is
        ignored: the rows hold the lambdas); returns the detached loss
        terms and "loss", each [P] (a regular step's entire terms as
        zeros). One backward of the sum of the pairs' totals, then each
        pair's update at its row's lr. The one definition of the step:
        SpliceProgram runs it eagerly and captures it."""
        total, parts = self.loss(rows, entire)
        for t in self.trainers:
            t.opt.zero_grad(set_to_none=True)
        total.sum().backward()
        for t, row in zip(self.trainers, rows):
            t.lr.copy_(row[LR_COLUMN])
            t.opt.step()
        out = {k: v.detach() for k, v in parts.items()}
        zero = torch.zeros(self.n_pairs, device=total.device)
        for name in ("loss_entire_cls", "loss_entire_ssim"):
            out.setdefault(name, zero)
        out["loss"] = total.detach()
        return out

    @torch.no_grad()
    def render(self) -> torch.Tensor:
        """Every pair's full-image output [P, H, W, 3] in [0, 1]."""
        return torch.stack([t.render() for t in self.trainers])

    def render_u8(self) -> torch.Tensor:
        """render as uint8 [P, H, W, 3] on the device
        (splice_tpu/parallel/pair_parallel.py:222-233)."""
        return img_ops.tensor2im(self.render())

    def state_dict(self) -> Dict[str, Any]:
        return {"pairs": [t.state_dict() for t in self.trainers]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore state_dict() in place (before a capture: the graphs read
        every pair's parameters and optimizer state by address)."""
        if len(state["pairs"]) != self.n_pairs:
            raise ValueError(f"checkpoint holds {len(state['pairs'])} pairs "
                             f"but this run trains {self.n_pairs}")
        for t, s in zip(self.trainers, state["pairs"]):
            t.load_state_dict(s)


def _group_extractors(extractor: ext_lib.VitExtractor, mesh: mesh_lib.Mesh
                      ) -> List[ext_lib.VitExtractor]:
    """Each dp group's ViT: replicated over dp (groups on the same devices
    share its tensors); with tp > 1, the reference's manual-tp layout
    sharded over the group's devices (:85-94)."""
    params = extractor.params
    if mesh.tp > 1:
        params = mesh_lib.manual_tp_permute_vit_params(params, extractor.cfg,
                                                       mesh.tp)
    ranks = mesh_lib.shard_vit_params(params, mesh)
    if mesh.tp == 1:
        return [dataclasses.replace(extractor, params=r[0]) for r in ranks]
    return [dataclasses.replace(extractor, params=r, tp_devices=devs)
            for r, devs in zip(ranks, mesh.devices)]


class _Gather:
    """The dp groups' HostCopy reads as one [n, P, ...] tensor."""

    def __init__(self, reads: Sequence[HostCopy]):
        self.reads = reads

    def wait(self) -> torch.Tensor:
        return torch.cat([r.wait() for r in self.reads], dim=1)


def train_pairs(cfg: Config, dataroots: Sequence[str], image_hw: int = 224,
                n_steps: Optional[int] = None, device=None,
                extractor: Optional[ext_lib.VitExtractor] = None,
                mesh: Optional[mesh_lib.Mesh] = None) -> Dict[str, Any]:
    """Optimise the pairs of `dataroots` together to step n_steps (default
    cfg.n_epochs) on `device` (default cfg.device, i.e. CUDA), each pair
    at image_hw x image_hw (load_pair_batch), in the chunks of
    trainer.chunk_plan (the reference's multi-pair boundaries: entire-A
    steps, the cls warm-up, logs, checkpoints, plateau's patience + 1),
    each dispatched through a SpliceProgram over a MultiPairTrainer per
    dp group: captured graphs on one card. `mesh` (parallel.mesh.make_mesh)
    lays the pairs and the ViT out over devices; without it the mesh is
    cfg.mesh_dp x cfg.mesh_tp clamped as the reference clamps it to the
    devices `device` sees, over cuda:0..n-1 (one device: `device`).
    `extractor`, the frozen ViT, defaults to cfg's on the first device.

    At every log_images_freq-th step and at the end, per pair: its output
    to <dataroot>/out/output.png through one AsyncImageSaver (must-write
    at the end) and its last losses, lr and steps/s to
    <dataroot>/out/metrics.jsonl. With cfg.checkpoint_every and
    cfg.checkpoint_dir, a checkpoint every checkpoint_every steps (every
    pair's state in global pair order whatever dp is, the scheduler's,
    every pair's draw generator); with cfg.resume_from, the run continues
    from its latest checkpoint (a checkpoint of any dp; a run already
    complete still writes the outputs). On CUDA the loop queues a chunk
    before it reads the one before it, except under plateau, where the
    next chunk's lrs follow this one's losses.

    Returns steps_per_sec and pair_steps_per_sec (this call's steps over
    its wall time, captures and boundaries included), wall_time, losses
    (the last step's terms, [P] each), loss_seq ([steps, P, 6] in
    LOSS_KEYS order), outputs ([P, H, W, 3] in [0, 1], on the first
    device), the rows dispatched ([steps, P, row_width]), the chunk
    sizes, the first step, the mesh, each dp group's trainer and program
    (trainers, programs) and the first group's (trainer, program)."""
    dev = resolve_device(device if device is not None else cfg.device)
    n_pairs = len(dataroots)
    if mesh is None:
        dp, tp = mesh_lib.resolve_mesh(cfg, n_pairs,
                                       mesh_lib.visible_devices(dev))
        mesh = mesh_lib.make_mesh(dp, tp, [dev] if dp * tp == 1 else None)
    groups = mesh_lib.dp_sharding(mesh, n_pairs)
    home = mesh.devices[0][0]
    seed = resolve_seed(cfg)
    print(f"running {n_pairs} pairs with seed: {seed}"
          + (f" on a dp={mesh.dp} x tp={mesh.tp} mesh"
             if mesh.dp * mesh.tp > 1 else "") + ".")
    batch = load_pair_batch(cfg, dataroots, image_hw, home)
    canvas = crop_canvas_size(image_hw, image_hw, cfg.crop_canvas)
    pairs = [ImagePair(A=a, B=b, canvas_A=canvas, canvas_B=canvas)
             for a, b in zip(batch["A"], batch["B"])]
    if extractor is None:
        extractor = make_extractor_from_config(cfg, home)
    seeds = [pair_seeds(seed, i) for i in range(n_pairs)]
    trainers = [MultiPairTrainer(
        cfg, [pairs[i].to(devs[0]) for i in ids], ext,
        seeds=[seeds[i][0] for i in ids])
        for ids, devs, ext in zip(groups, mesh.devices,
                                  _group_extractors(extractor, mesh))]
    gens = [torch.Generator().manual_seed(s) for _, s in seeds]
    sched = MultiPairScheduler(cfg, n_pairs)

    def load_state(state: Dict[str, Any]) -> None:
        """Every pair's state (global order) into its group's trainer."""
        for t, ids in zip(trainers, groups):
            t.load_state_dict({"pairs": [state["pairs"][i] for i in ids]})

    first = 0
    if cfg.resume_from:
        rck = Checkpointer(cfg.resume_from)
        step0 = rck.latest_step()
        if step0 is not None:
            state = rck.restore(step0)
            sched.load_state_dict(state["sched"])
            load_state(state)
            for g, s in zip(gens, state["gens"]):
                g.set_state(s)
            first = step0
            print(f"resumed {n_pairs} pairs from {cfg.resume_from} at step "
                  f"{step0}")
    ckpt = Checkpointer(cfg.checkpoint_dir) if checkpointing(cfg) else None
    total_steps = n_steps if n_steps is not None else cfg.n_epochs
    plan = chunk_plan(cfg, total_steps, first)
    capacity = max((n for _, n, _ in plan), default=1)
    programs = [SpliceProgram(t, capacity) for t in trainers]
    # pair p is pair j of group g
    where = [(g, j) for g, ids in enumerate(groups) for j in range(len(ids))]
    saver = AsyncImageSaver()
    loggers = [MetricsLogger(os.path.join(r, "out", "metrics.jsonl"))
               for r in dataroots]
    out_pngs = [os.path.join(r, "out", "output.png") for r in dataroots]
    freq = cfg.log_images_freq
    read_now = (cfg.scheduler_policy == "plateau"
                or not all(p.graphed for p in programs))
    seqs: List[np.ndarray] = []
    all_rows: List[np.ndarray] = []
    pending: List[Tuple[int, Any]] = []
    timer = StepTimer()

    def read_chunks(keep: int) -> None:
        """Read the dispatched chunks, oldest first, until `keep` are left
        unread; the scheduler observes every step's per-pair totals."""
        while len(pending) > keep:
            n, read = pending.pop(0)
            seq = read.wait().numpy()
            timer.tick(n)
            seqs.append(seq)
            for r in seq:
                sched.observe(r[:, -1])

    def save_outputs(final: bool) -> None:
        outs = [t.render_u8() for t in trainers]
        for p, path in enumerate(out_pngs):
            g, j = where[p]
            saver.save(outs[g][j], path, must_write=final)

    t0 = time.perf_counter()
    try:
        for start, n, entire in plan:
            lrs = chunk_lrs(cfg, sched, start, n)
            rows = np.stack([
                np.stack([pack_row(lambdas_vec(cfg, i), lr_p,
                                   sample_step_draws(cfg, pair, gen))
                          for pair, gen, lr_p in zip(
                              pairs, gens, np.broadcast_to(lr, n_pairs))])
                for i, lr in zip(range(start, start + n), lrs)])
            # every group's chunk is queued before any group is read
            for prog, ids in zip(programs, groups):
                prog.dispatch(rows[:, ids.start:ids.stop], entire)
            all_rows.append(rows)
            pending.append((n, _Gather([prog.fetch_async(n)
                                        for prog in programs])))
            step = start + n
            if read_now:
                read_chunks(0)
            if step % freq == 0 or step >= total_steps:
                save_outputs(final=step >= total_steps)
                lr_now = sched.lr_for_step(step - 1)
                for p, logger in enumerate(loggers):
                    g, j = where[p]
                    logger.log_async(
                        step - 1,
                        dict(zip(LOSS_KEYS, programs[g].loss_seq[n - 1, j])),
                        {"lr": float(lr_now[p]),
                         "steps_per_sec": timer.rate()},
                        with_memory=(step // freq) % 10 == 0)
            if ckpt is not None and step % cfg.checkpoint_every == 0:
                ckpt.save(step, {
                    "pairs": [s for t in trainers
                              for s in t.state_dict()["pairs"]],
                    "sched": sched.state_dict(),
                    "gens": [g.get_state() for g in gens]})
            read_chunks(1)
        read_chunks(0)
        wall = time.perf_counter() - t0
        if not plan:
            # no step to run (a resumed run already complete): the outputs
            # still land
            save_outputs(final=True)
        outputs = torch.cat([t.render().to(home) for t in trainers])
    finally:
        saver.close()
        for logger in loggers:
            logger.close()
        if ckpt is not None:
            ckpt.wait()
    done = max(total_steps - first, 0)
    loss_seq = (np.concatenate(seqs) if seqs
                else np.zeros((0, n_pairs, len(LOSS_KEYS)), np.float32))
    rate = done / wall if done else 0.0
    return {"steps_per_sec": rate, "pair_steps_per_sec": rate * n_pairs,
            "wall_time": wall,
            "losses": ({k: loss_seq[-1, :, j] for j, k in enumerate(LOSS_KEYS)}
                       if len(loss_seq) else {}),
            "loss_seq": loss_seq, "outputs": outputs,
            "rows": (np.concatenate(all_rows) if all_rows else np.zeros(
                (0, n_pairs, row_width(cfg)), np.float32)),
            "chunks": [n for _, n, _ in plan], "first_step": first,
            "output_paths": out_pngs, "mesh": mesh, "trainers": trainers,
            "programs": programs, "trainer": trainers[0],
            "program": programs[0]}
