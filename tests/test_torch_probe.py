"""P1, the probe kernel (splice_tpu_torch/ops/probe.py), against the
reference's scripts/mxu_k_probe.py _kernel run through pl.pallas_call in
interpret mode on the CPU (built here: the script's own calls ask for TPU
memory spaces). The same seeded bf16 inputs go to both; the plain version
sums in fp32 loop by loop as the kernel does, and both round to bf16, so
they agree within a few bf16 ulps of the largest output (8e-3 x max|ref|:
up to two ulps, the products summed in another order).

The wrapper that launches the CUDA kernel runs only on the card
(chip_smoke.py phase 2 holds it against mma_repeat_plain there); here it
must refuse what it does not take with ValueError before any build.
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from splice_tpu_torch.ops import _build
from splice_tpu_torch.ops import probe

_SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "mxu_k_probe.py"


def _reference_kernel():
    spec = importlib.util.spec_from_file_location("mxu_k_probe", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._kernel


def _reference(a, b, reps):
    fn = pl.pallas_call(
        functools.partial(_reference_kernel(), reps),
        out_shape=jax.ShapeDtypeStruct((a.shape[0], b.shape[1]),
                                       jnp.bfloat16),
        interpret=True)
    return np.asarray(fn(jnp.asarray(a, jnp.bfloat16),
                         jnp.asarray(b, jnp.bfloat16)).astype(jnp.float32))


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    # round to bf16 once, so that both sides read the same values
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    return ta, tb, ta.float().numpy(), tb.float().numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (32, 16, 48)])
def test_plain_matches_reference_kernel(m, k, n, reps, seed):
    ta, tb, a, b = _inputs(m, k, n, 10 * seed + reps)
    want = _reference(a, b, reps)
    got = probe.mma_repeat_plain(ta, tb, reps)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 8e-3 * np.abs(want).max(), err


def test_plain_sums_loop_by_loop():
    """reps products summed in fp32: ones give k * reps exactly."""
    a = torch.ones(64, 48, dtype=torch.bfloat16)
    b = torch.ones(48, 128, dtype=torch.bfloat16)
    assert bool((probe.mma_repeat_plain(a, b, 5) == 240).all())


@pytest.fixture
def no_build(monkeypatch):
    """Any build or library load fails the test: the checks come first."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "library", refuse)


BF = torch.bfloat16


@pytest.mark.parametrize("a,b,reps,n_tile,match", [
    (torch.ones(64, 64, dtype=BF), torch.ones(64, 128, dtype=BF), 1, 128,
     "CUDA"),
    (torch.ones(64, 64), torch.ones(64, 128), 1, 128, "bfloat16"),
    (torch.ones(32, 64, dtype=BF), torch.ones(64, 128, dtype=BF), 1, 128,
     "m % 64"),
    (torch.ones(64, 24, dtype=BF), torch.ones(24, 128, dtype=BF), 1, 128,
     "k % 16"),
    (torch.ones(64, 64, dtype=BF), torch.ones(64, 64, dtype=BF), 1, 128,
     "n % n_tile"),
    (torch.ones(64, 64, dtype=BF), torch.ones(64, 64, dtype=BF), 1, 32,
     "n_tile"),
    (torch.ones(64, 64, dtype=BF), torch.ones(32, 64, dtype=BF), 1, 64,
     r"A \[m, k\]"),
    (torch.ones(64, 320, dtype=BF), torch.ones(320, 64, dtype=BF), 1, 64,
     "chunks of 128"),
    (torch.ones(64, 1024, dtype=BF), torch.ones(1024, 128, dtype=BF), 1, 128,
     "shared memory"),
    (torch.ones(64, 64, dtype=BF), torch.ones(64, 64, dtype=BF), 0, 64,
     "reps"),
])
def test_wrapper_refuses_before_any_build(no_build, a, b, reps, n_tile,
                                          match):
    with pytest.raises(ValueError, match=match):
        probe.mma_repeat(a, b, reps, n_tile)


def test_smem_fits_the_reference_shapes():
    """Every shape the probe tool runs fits one block's shared memory: K up
    to 256 resident at either tile, 768 streamed at either."""
    for k in (16, 64, 128, 256, 768):
        for n_tile in probe.N_TILES:
            assert probe.smem_bytes(k, n_tile) <= probe.SMEM_CAP
    assert probe.smem_bytes(768, 128) == 128 * 768 * 2 + 2 * 64 * 128 * 2 \
        + 1024
    assert probe.smem_bytes(16, 64) == 64 * 64 * 2 + 64 * 64 * 2 + 1024


def test_probe_tool_needs_a_card(monkeypatch):
    """The probe tool measures the card: without one it raises and does
    not fall back to the CPU."""
    from splice_tpu_torch.tools import mma_k_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mma_k_probe.run()


def _probe_result(w256, w768):
    """A run() result with every per-product time 1 us except the width
    question's 128-column ones, which give the w128/w64 ratios asked."""
    from splice_tpu_torch.tools import mma_k_probe

    def cfg(k, n, nt, us=1.0):
        return {"m": mma_k_probe.N, "k": k, "n": n, "n_tile": nt,
                "reps": mma_k_probe.REPS, "blocks": 1, "route":
                "streamed" if k > probe.RESIDENT_K else "resident",
                "us_per_product": us, "tflops": 1.0, "of_peak": 0.001,
                "instr": f"m64n{nt}k16", "cycles_per_instr": 1.0,
                "cycles_per_instr_max": 1.0, "ideal_cycles": 1.0,
                "sm_mhz": 1.0}

    n, ks = mma_k_probe.N, (64, 128, 256)
    width_us = {n: w768, 256: w256}
    return {"depth": {nt: {k: cfg(k, n, nt) for k in ks}
                      for nt in probe.N_TILES},
            "width": {k: {w: cfg(k, w, w, width_us[k] if w == 128 else 1.0)
                          for w in probe.N_TILES} for k in (n, 256)},
            "ratios": {**{f"t128/t64 n{nt}": 1.0 for nt in probe.N_TILES},
                       **{f"t256/t128 n{nt}": 1.0 for nt in probe.N_TILES},
                       f"w128/w64 k{n}": w768, "w128/w64 k256": w256}}


@pytest.mark.parametrize("w256, verdict", [(1.1, "waste ~half"),
                                           (1.9, "stream efficiently")])
def test_probe_tool_width_verdict_only_where_resident(capsys, w256, verdict):
    """The width verdict follows the resident K = 256 ratio; the streamed
    K = 768 line, whose time the ring's loads set, gives none, whatever
    its ratio."""
    from splice_tpu_torch.tools import mma_k_probe
    mma_k_probe.report(_probe_result(w256, w768=1.1))
    lines = capsys.readouterr().out.splitlines()
    at = {k: next(i for i, s in enumerate(lines)
                  if s.startswith(f"[768,{k}]x[{k},128]")) for k in (768, 256)}
    assert "limited by loads through the ring" in lines[at[768] + 1]
    assert "no verdict" in lines[at[768] + 1]
    assert verdict in lines[at[256] + 1]
    assert sum("64-wide outputs" in s for s in lines) == 1
