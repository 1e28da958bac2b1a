"""Single-flag ablation bench (port of scripts/ablate.py and
scripts/ablate_attn.py).

    python -m splice_tpu_torch.tools.ablate [mode ...]

The cows pair, seed 3, bf16, the main path's configuration: one warm chunk
of 10 steps (the first runs eagerly and is captured, the rest replay),
then 20 chunks of 10 replayed regular steps through trainer.SpliceProgram,
timed from the first queued chunk to the last chunk's one read. Prints
`mode=<label>: <x> steps/s  loss=<y>`. Several modes combine, e.g.
`ablate nodwtap kw512`; no mode is the default configuration.

Modes with a counterpart on this card (the knob each sets):

  fused        generator_conv=fused
  lax          generator_conv=xla (F.conv2d everywhere: the counterpart of
               the reference's XLA strided conv, STRIDE2_CONV_MODE="lax")
  xlaattn      use_pallas_attention=False (SDPA in place of K1/K2, K5/K6)
  kw<N>        models.unet.KERNEL_MIN_WIDTH = N (the auto route's width
               threshold; the reference's PALLAS_MIN_WIDTH)
  nodwtap      ops.conv.DW_TAP_ON_N = False
  nosamekern   ops.conv.SAME_BORDER_KERNELS = False

Modes that tune the TPU program alone raise ValueError, which names the
mode and says why: slice, major, permdot (STRIDE2_PHASE_MODE), lax_stem and
phase (STRIDE2_CONV_MODE's other values), ln_save, ln_nosave, ln_inv,
ln_mean (SAVE_LN_STATS), nopack (PACK_QK_K128), padstream
(PAD_TOKEN_STREAM), bu<N> (BLOCK_SCAN_UNROLL), cu<N> (CHUNK_SCAN_UNROLL),
tb<N> (TILE_BUDGET_BYTES) and ablate_attn.py's q-block size (_BQ, a bare
number). Any other mode raises too.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

# the reference's bench configuration (scripts/ablate.py:68-71)
BENCH_KEYS = dict(dataroot="datasets/splicing/cows", seed=3,
                  vit_compute_dtype="bfloat16", use_pallas_attention=True)
CHUNK, CHUNKS = 10, 20
LAMBDA_STEP = 5         # every row carries the lambdas of step 5

_TPU_ONLY = {
    ("slice", "major", "permdot"):
        "STRIDE2_PHASE_MODE picks the Mosaic layout of the TPU's stride-2 "
        "phase split; the port's stride-2 convs are K3/K4's phase kernels "
        "or F.conv2d",
    ("lax_stem", "phase"):
        "STRIDE2_CONV_MODE's other values pick XLA's stride-2 formulation "
        "per site; the port routes whole generators (lax, fused)",
    ("ln_save", "ln_nosave", "ln_inv", "ln_mean"):
        "SAVE_LN_STATS picks what XLA's remat policy saves; the port keeps "
        "every activation (no remat)",
    ("nopack",): "PACK_QK_K128 packs two heads into the TPU's 128 lanes",
    ("padstream",): "PAD_TOKEN_STREAM pads tokens to the TPU's lane width",
}
_TPU_ONLY_PREFIXES = {
    "bu": "BLOCK_SCAN_UNROLL unrolls XLA's scan over the ViT blocks",
    "cu": "CHUNK_SCAN_UNROLL unrolls XLA's scan over a chunk's steps",
    "tb": "TILE_BUDGET_BYTES is the Pallas conv kernel's VMEM budget",
}


def _knob(mode: str) -> Tuple[Dict[str, Any], List[Tuple[Any, str, Any]]]:
    """The config keys and the (module, attribute, value) knobs of one
    mode; ValueError for a mode without a counterpart here."""
    from splice_tpu_torch.models import unet
    from splice_tpu_torch.ops import conv
    table = {"fused": ({"generator_conv": "fused"}, []),
             "lax": ({"generator_conv": "xla"}, []),
             "xlaattn": ({"use_pallas_attention": False}, []),
             "nodwtap": ({}, [(conv, "DW_TAP_ON_N", False)]),
             "nosamekern": ({}, [(conv, "SAME_BORDER_KERNELS", False)])}
    if mode in table:
        return table[mode]
    if mode.startswith("kw") and mode[2:].isdigit():
        return {}, [(unet, "KERNEL_MIN_WIDTH", int(mode[2:]))]
    for names, why in _TPU_ONLY.items():
        if mode in names:
            raise ValueError(f"ablation mode {mode!r} tunes the TPU "
                             f"program only: {why}")
    if mode[:2] in _TPU_ONLY_PREFIXES and mode[2:].isdigit():
        raise ValueError(f"ablation mode {mode!r} tunes the TPU program "
                         f"only: {_TPU_ONLY_PREFIXES[mode[:2]]}")
    if mode.isdigit():
        raise ValueError(f"ablation mode {mode!r} (ablate_attn.py's _BQ) "
                         f"tunes the TPU program only: the q-block of the "
                         f"Pallas attention kernel")
    raise ValueError(f"unknown ablation mode {mode!r}; see "
                     f"splice_tpu_torch.tools.ablate's docstring")


@contextlib.contextmanager
def ablation(modes: Sequence[str]) -> Iterator[Dict[str, Any]]:
    """Set every mode's module knobs (restored on exit) and yield the
    config keys the modes set. Every mode is checked before any knob
    moves."""
    keys: Dict[str, Any] = {}
    knobs: List[Tuple[Any, str, Any]] = []
    for mode in modes:
        k, kn = _knob(mode)
        keys.update(k)
        knobs += kn
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in knobs]
    try:
        for mod, name, value in knobs:
            setattr(mod, name, value)
        yield keys
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def bench_program(keys: Dict[str, Any], device=None):
    """The bench's (cfg, program, rows): cows at the reference's bench
    configuration plus `keys` on `device` (default CUDA), a SpliceProgram
    of CHUNK rows, and rows(n, seed): n packed regular rows."""
    from splice_tpu_torch import trainer as tr
    from splice_tpu_torch.config import load_config
    from splice_tpu_torch.data import load_pair
    cfg = load_config(None, {**BENCH_KEYS, **keys,
                             **({"device": device} if device else {})})
    pair = load_pair(cfg)
    trainer = tr.SpliceTrainer(cfg, pair, tr.make_extractor_from_config(cfg),
                               seed=cfg.seed)
    program = tr.SpliceProgram(trainer, CHUNK)
    lam = tr.lambdas_vec(cfg, LAMBDA_STEP)

    def rows(n: int, seed: int) -> np.ndarray:
        gen = torch.Generator().manual_seed(seed)
        return np.stack([tr.pack_row(lam, cfg.lr,
                                     tr.sample_step_draws(cfg, pair, gen))
                         for _ in range(n)])

    return cfg, program, rows


def run(modes: Sequence[str] = (), chunks: int = CHUNKS,
        device=None) -> Dict[str, Any]:
    """The bench under `modes`: a warm chunk, then `chunks` chunks of
    CHUNK regular steps. Returns the label, steps/s, the last loss and the
    program."""
    label = "+".join(modes) or "default"
    with ablation(modes) as keys:
        cfg, program, rows = bench_program(keys, device)
        program.run(rows(CHUNK, 4), False)          # capture and warm
        timed = [rows(CHUNK, 5 + i) for i in range(chunks)]
        t0 = time.perf_counter()
        for r in timed:
            program.dispatch(r, False)
        loss = float(program.fetch(CHUNK)[-1, -1])
        wall = time.perf_counter() - t0
    return {"label": label, "steps_per_sec": chunks * CHUNK / wall,
            "loss": loss, "program": program}


def main(argv=None) -> None:
    modes = list(sys.argv[1:] if argv is None else argv)
    res = run(modes)
    print(f"mode={res['label']}: {res['steps_per_sec']:.2f} steps/s  "
          f"loss={res['loss']:.4f}")


if __name__ == "__main__":
    main()
