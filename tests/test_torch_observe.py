"""splice_tpu_torch's observability and ablation paths against splice_tpu:
the config keys, the attention switch (use_pallas_attention), the profile
window of train_pair (utils/profiling.py), and the tools ablate.py,
profile_step.py and trace_agg.py.

  * the four keys with the reference's defaults; the keys unported by
    design still refused;
  * vit_forward(use_pallas=False) against the reference's
    vit_forward(use_pallas=False) (XLA attention) on the tiny ViT, fp32:
    taps and the input gradient within 1e-5 x the largest entry; the
    library route against the reference's _xla_attention with masked keys;
  * the profile marks end chunks; a CPU train_pair with profile_dir writes
    a trace of its window, which trace_agg reads;
  * trace_agg on a small synthetic trace: exclusive times, calls, shares;
  * ablate's mode table: each mode's knob, the TPU-only modes refused.
"""
import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu import config as jconfig
from splice_tpu.models import vit as jvit
from splice_tpu.ops import attention as jattn
from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.config import Config, load_config
from splice_tpu_torch.data import ImagePair
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import (init_vit_params,
                                             vit_params_from_numpy)
from splice_tpu_torch.ops import attention as tattn
from splice_tpu_torch.ops import conv as tconv
from splice_tpu_torch.tools import ablate, trace_agg
from splice_tpu_torch.utils import profiling

TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)
KEYS = {"use_pallas_attention": True, "profile_dir": None,
        "profile_start_step": 20, "profile_n_steps": 5}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (see
    tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_keys_match_reference():
    ref = jconfig.Config()
    for k, v in KEYS.items():
        assert getattr(Config(), k) == getattr(ref, k) == v, k
    cfg = load_config(None, {"use_pallas_attention": "false",
                             "profile_dir": "tr", "profile_start_step": 3,
                             "profile_n_steps": 2})
    assert (cfg.use_pallas_attention, cfg.profile_dir,
            cfg.profile_start_step, cfg.profile_n_steps) == (False, "tr", 3, 2)
    for key, value in (("remat_vit", True), ("compile_cache_dir", "/c"),
                       ("jax_platform", "cpu")):     # unported by design
        with pytest.raises(ValueError, match="unknown config keys"):
            load_config(None, {key: value})


def _tiny_params():
    jp = jvit.init_vit_params(jax.random.PRNGKey(4),
                              jvit.VitConfig(**TINY_VIT))
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(
        np.float32) for l in leaves]
    return jax.tree.unflatten(tree, leaves)


def test_vit_without_kernels_matches_reference_xla(monkeypatch):
    """Taps and the input gradient of a seeded weighted sum of them; no
    kernel wrapper runs."""
    for name in ("attn_qkv_fwd", "attn_fwd"):
        monkeypatch.setattr(tattn, name, lambda *a, **k: pytest.fail(
            "an attention kernel ran with use_pallas=False"))
    jp = _tiny_params()
    cfg = jvit.VitConfig(**TINY_VIT)
    taps = {"qkv": (0, 1), "block": (0, 1), "attn_out": (1,)}
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 48, 40, 3)).astype(np.float32)
    jout = jvit.vit_forward(jp, jnp.asarray(img), cfg, taps,
                            use_pallas=False)
    weights = {(k, i): rng.standard_normal(np.shape(jout[k][i])).astype(
        np.float32) for k, layers in taps.items() for i in layers}

    def loss(out, w):
        return sum((out[k][i] * w[(k, i)]).sum() for k, i in w)

    jgrad = np.asarray(jax.grad(lambda x: loss(
        jvit.vit_forward(jp, x, cfg, taps, use_pallas=False),
        {k: jnp.asarray(v) for k, v in weights.items()}))(jnp.asarray(img)))
    x = torch.from_numpy(img).requires_grad_(True)
    tout = tvit.vit_forward(vit_params_from_numpy(jax.tree.map(np.asarray,
                                                               jp)),
                            x, tvit.VitConfig(**TINY_VIT), taps,
                            use_pallas=False)
    loss(tout, {k: torch.from_numpy(v) for k, v in weights.items()}
         ).backward()
    for k, layers in taps.items():
        for i in layers:
            want = np.asarray(jout[k][i])
            np.testing.assert_allclose(tout[k][i].detach().numpy(), want,
                                       rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


def test_library_attention_matches_reference_xla():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jattn._xla_attention(*map(jnp.asarray, (q, k, v)),
                                           0.25, n_valid=29))
    got = tattn.multi_head_attention(*map(torch.from_numpy, (q, k, v)),
                                     0.25, 29, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _img(h, w, seed):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def _cfg(**kw):
    return load_config(None, dict(
        vit_compute_dtype="float32", generator_compute_dtype="float32",
        dino_global_patch_size=32, device="cpu", seed=5, entire_A_every=4,
        log_images_freq=6, cls_warmup=1, **kw))


@pytest.mark.parametrize("start,n,plan", [
    (2, 2, [(0, 1, True), (1, 1, False), (2, 2, False), (4, 1, True),
            (5, 1, False)]),
    (1, 5, [(0, 1, True), (1, 3, False), (4, 1, True), (5, 1, False)]),
])
def test_profile_marks_end_chunks(start, n, plan):
    """The reference's boundaries_after (splice_tpu/trainer.py:662-665)
    adds profile_start_step and the window's end; here the plain plan is
    [E0, 1-3, E4, 5]."""
    cfg = _cfg(profile_dir="tr", profile_start_step=start,
               profile_n_steps=n)
    assert ttrainer.chunk_plan(cfg, 6) == plan
    assert ttrainer.chunk_plan(dataclasses.replace(cfg, profile_dir=None),
                               6) == [(0, 1, True), (1, 3, False),
                                      (4, 1, True), (5, 1, False)]


def _convs(path):
    with open(path) as f:
        events = trace_agg.device_events(json.load(f))
    assert events and all(e["cat"] == "cpu_op" for e in events)
    return events, sum(e["name"] == "aten::convolution" for e in events)


def test_cpu_train_pair_writes_its_window(tmp_path):
    """Steps 2-3 traced (on the CPU: its operators): the trace holds twice
    the convolutions of one regular step traced alone, and trace_agg reads
    it."""
    pair = ImagePair(A=torch.from_numpy(_img(70, 90, 2)),
                     B=torch.from_numpy(_img(80, 72, 3)), canvas_A=64,
                     canvas_B=64)
    vcfg = tvit.VitConfig(**TINY_VIT)
    ext = text.VitExtractor(
        params=init_vit_params(vcfg, seed=4, device="cpu"), cfg=vcfg)
    cfg = _cfg(profile_dir=str(tmp_path / "trace"), profile_start_step=2,
               profile_n_steps=2)
    res = ttrainer.train_pair(cfg, 6, dataroot=str(tmp_path), pair=pair,
                              extractor=ext)
    assert res["chunks"] == [1, 1, 2, 1, 1]
    assert res["trace_path"].startswith(str(tmp_path / "trace"))
    events, window = _convs(res["trace_path"])
    row = torch.from_numpy(res["rows"][2])
    with profiling.maybe_trace(str(tmp_path / "one"), device="cpu"):
        res["trainer"].step(row, None, False)
    _, one = _convs(next((tmp_path / "one").glob("*.json")))
    assert one > 0 and window == 2 * one
    total, rows = trace_agg.aggregate(events, 2)
    assert total > 0 and rows[0]["share"] >= rows[-1]["share"]


def _synthetic_trace():
    """Two steps of two kernels and a copy on one stream, and host
    operators nested on a thread (exclusive times 6 and 4 us)."""
    ev = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": 7}]
    t = 0
    for _ in range(2):
        for name, cat, dur in (("gemm_kernel", "kernel", 30),
                               ("softmax_kernel", "kernel", 10),
                               ("Memcpy HtoD", "gpu_memcpy", 5)):
            ev.append({"ph": "X", "cat": cat, "name": name, "pid": 1,
                       "tid": 7, "ts": t, "dur": dur})
            t += dur + 1
    ev += [{"ph": "X", "cat": "cpu_op", "name": "outer", "pid": 0,
            "tid": 1, "ts": 0, "dur": 10},
           {"ph": "X", "cat": "cpu_op", "name": "inner", "pid": 0,
            "tid": 1, "ts": 2, "dur": 4}]
    return {"traceEvents": ev}


def test_trace_agg_reads_a_synthetic_trace(tmp_path, capsys):
    (tmp_path / "a.json").write_text(json.dumps({"traceEvents": []}))
    (tmp_path / "sub").mkdir()
    with gzip.open(tmp_path / "sub" / "b.json.gz", "wt") as f:
        json.dump(_synthetic_trace(), f)
    trace = trace_agg.load_trace(str(tmp_path))     # the newest
    total, rows = trace_agg.aggregate(trace_agg.device_events(trace), 2)
    assert total == pytest.approx(0.045)
    assert [(r["name"], r["calls"], r["ms"]) for r in rows] == [
        ("gemm_kernel", 1.0, pytest.approx(0.030)),
        ("softmax_kernel", 1.0, pytest.approx(0.010)),
        ("Memcpy HtoD", 1.0, pytest.approx(0.005))]
    assert rows[0]["share"] == pytest.approx(30 / 45)
    host = {"traceEvents": [e for e in _synthetic_trace()["traceEvents"]
                            if e.get("cat") == "cpu_op"]}
    _, rows = trace_agg.aggregate(trace_agg.device_events(host))
    assert {r["name"]: r["ms"] for r in rows} == {
        "outer": pytest.approx(0.006), "inner": pytest.approx(0.004)}
    trace_agg.main([str(tmp_path), "2"])
    assert "gemm_kernel" in capsys.readouterr().out


def test_maybe_trace_without_a_directory_traces_nothing(tmp_path):
    with profiling.maybe_trace(None) as prof:
        assert prof is None
    with profiling.maybe_trace(str(tmp_path / "t"), device="cpu") as prof:
        torch.ones(3).sum()
    assert len(list((tmp_path / "t").glob("*.json"))) == 1


@pytest.mark.parametrize("mode,keys,knob", [
    ("fused", {"generator_conv": "fused"}, None),
    ("lax", {"generator_conv": "xla"}, None),
    ("xlaattn", {"use_pallas_attention": False}, None),
    ("kw512", {}, (tunet, "KERNEL_MIN_WIDTH", 512)),
    ("nodwtap", {}, (tconv, "DW_TAP_ON_N", False)),
    ("nosamekern", {}, (tconv, "SAME_BORDER_KERNELS", False)),
])
def test_ablate_mode_sets_its_knob(mode, keys, knob, monkeypatch):
    monkeypatch.setattr(tconv, "SAME_BORDER_KERNELS", True)
    before = (tunet.KERNEL_MIN_WIDTH, tconv.DW_TAP_ON_N,
              tconv.SAME_BORDER_KERNELS)
    with ablate.ablation([mode]) as got:
        assert got == keys
        if knob is not None:
            assert getattr(knob[0], knob[1]) == knob[2]
        load_config(None, dict(ablate.BENCH_KEYS, **got))
    assert (tunet.KERNEL_MIN_WIDTH, tconv.DW_TAP_ON_N,
            tconv.SAME_BORDER_KERNELS) == before


@pytest.mark.parametrize("mode", [
    "slice", "major", "permdot", "lax_stem", "phase", "ln_save",
    "ln_nosave", "ln_inv", "ln_mean", "nopack", "padstream", "bu2", "cu4",
    "tb8", "512", "nosuchmode", "kwide"])
def test_ablate_refuses_modes_without_a_counterpart(mode):
    before = tconv.DW_TAP_ON_N
    with pytest.raises(ValueError, match=repr(mode)):
        with ablate.ablation(["nodwtap", mode]):
            pass
    assert tconv.DW_TAP_ON_N == before        # nothing moved
