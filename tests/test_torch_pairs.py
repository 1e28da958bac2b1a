"""The multi-pair trainer of splice_tpu_torch (parallel/pair_parallel.py,
parallel/mesh.py, trainer.MultiPairScheduler) against splice_tpu's.

Tiny shapes, as tests/test_torch_step.py: the bundled pairs at a 64 x 64
image and canvas, a 3-scale generator, a 2-block ViT of width 128, 32-px
loss resolution, fp32, P = 2 on a 1-device mesh.

  * load_pair_batch against the reference's: atol 5e-6
    (tests/test_torch_image.py's resample tolerance);
  * one regular and one entire-A step against the reference's
    build_multi_pair_program (augmentations on; the port's draws taken
    from the reference's per-pair keys): each pair's loss terms rtol 1e-5,
    the parameters after the update by test_torch_step's rule (1e-6 where
    the gradient is at least 1e-3 of its largest entry, at most 2 lr
    elsewhere);
  * the P-pair step against P single-pair SpliceTrainer steps from the
    same parameters and draws: the ViT runs the pairs as one batch, which
    may sum in another order, so loss terms rtol 1e-5 and parameters by
    the same rule; and nothing couples two pairs: other draws and
    parameters for pair 1 leave pair 0's terms and update bitwise equal;
  * MultiPairScheduler against the reference's on a seeded loss sequence
    for every policy: equal lr vectors;
  * train_pairs on the CPU: outputs, metrics, the chunk loop against eager
    steps and a resumed run against the uninterrupted one (bitwise), the
    plateau cut on the stalled pair only;
  * the mesh clamp (dp and tp above 1 survive it since the mesh is
    ported; tests/test_torch_mesh.py runs them), and the CLI's
    comma-separated dataroot.
"""
import concurrent.futures
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from PIL import Image

from splice_tpu import trainer as jtrainer
from splice_tpu.config import load_config as j_load_config
from splice_tpu.models import extractor as jext
from splice_tpu.models import unet as junet
from splice_tpu.models import vit as jvit
from splice_tpu.parallel import mesh as jmesh
from splice_tpu.parallel import pair_parallel as jpp
from splice_tpu_torch import losses as tlosses
from splice_tpu_torch import train as ttrain
from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.config import SCHEDULER_POLICIES, load_config
from splice_tpu_torch.data import ImagePair
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import (init_vit_params,
                                             vit_params_from_numpy)
from splice_tpu_torch.ops import image as timg
from splice_tpu_torch.parallel import mesh as tmesh
from splice_tpu_torch.parallel import pair_parallel as tpp
from splice_tpu_torch.utils.checkpoint import Checkpointer
from splice_tpu_torch.utils.tree import tree_map
from test_torch_chunk import _draws_from_key

ROOTS = ["datasets/splicing/cows", "datasets/splicing/apples2oranges"]
TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2,
                img_size=32)
TINY_UNET = dict(channels_down=(8, 8, 16), channels_up=(8, 8, 16),
                 channels_skip=(2, 2, 2))
HW = 64
LR = 2e-3
RESAMPLE_ATOL = 5e-6
KEYS = dict(use_augmentations=True, vit_compute_dtype="float32",
            generator_compute_dtype="float32", dino_global_patch_size=32,
            lr=LR, seed=3)


def _cfg(**kw):
    return load_config(None, dict(KEYS, device="cpu", **kw))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each on a shared host
    multiplied this module's CPU time about a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vit_np():
    """The tiny ViT's parameters as numpy, in the tree both packages
    take."""
    return tree_map(lambda t: t.numpy(), init_vit_params(
        tvit.VitConfig(**TINY_VIT), seed=1, device="cpu"))


def _extractor(vit_np):
    return text.VitExtractor(params=vit_params_from_numpy(vit_np),
                             cfg=tvit.VitConfig(**TINY_VIT))


@pytest.mark.parametrize("direction", ["AtoB", "BtoA"])
def test_load_pair_batch_matches_reference(direction):
    got = tpp.load_pair_batch(_cfg(direction=direction), ROOTS, HW)
    want = jpp.load_pair_batch(j_load_config(None, dict(direction=direction)),
                               ROOTS, HW)
    for k in ("A", "B"):
        assert got[k].shape == (2, HW, HW, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=RESAMPLE_ATOL)


# ---------------------------------------------------------------------------
# One step against the reference's multi-pair program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(vit_np):
    """The reference's program over 2 pairs on a 1-device mesh, run from
    _flats(4) (with a fresh Adam state) for one regular step (1) and one
    entire-A step (0) with PRNGKey(7): the two steps compile in two
    threads at once (XLA's compile releases the interpreter). Returns the
    config, the batch and, by entire, each step's loss terms and every
    pair's flat parameters after the update."""
    cfg = j_load_config(None, dict(KEYS, generator_conv="xla"))
    ext = jext.VitExtractor(params=jax.tree.map(jnp.asarray, vit_np),
                            cfg=jvit.VitConfig(**TINY_VIT))
    mesh = jmesh.make_mesh(dp=1, tp=1)
    gcfg = junet.SkipConfig(**TINY_UNET)
    program = jpp.build_multi_pair_program(cfg, ext, mesh, HW, gcfg)
    batch = jpp.load_pair_batch(cfg, ROOTS, HW)
    shapes = jax.eval_shape(lambda k: junet.init_skip_params(k, gcfg),
                            jax.random.PRNGKey(0))
    _, unravel = ravel_pytree(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    tx = jtrainer.make_optimizer(cfg)
    states = jax.jit(jax.vmap(lambda f: (lambda p: {
        "params": p, "opt_state": tx.init(p)})(unravel(f))))
    ravel = jax.jit(jax.vmap(lambda p: ravel_pytree(p)[0]))
    flats = jnp.asarray(np.stack(_flats(4)))

    def step(entire):
        with jax.set_mesh(mesh):
            run = program.step_entire if entire else program.step_regular
            i = 0 if entire else 1
            new, parts = run(states(flats), batch["A"], batch["B"],
                             jnp.int32(i), jax.random.PRNGKey(7),
                             jnp.asarray(jtrainer.lambdas_vec(cfg, i)))
            return ({k: np.asarray(v) for k, v in parts.items()},
                    np.asarray(ravel(new["params"])))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        results = dict(zip((False, True), pool.map(step, (False, True))))
    return cfg, batch, results


def _key_draws(key, img_hw, n_crops, min_cover):
    """global_crops' side, tops and lefts as the reference takes them from
    `key` (splice_tpu/ops/image.py:124-134)."""
    h, w = img_hw
    k_size, k_pos = jax.random.split(key)
    side = jnp.round(jax.random.uniform(k_size, (), jnp.float32,
                                        min_cover * h, float(h)))
    side = jnp.minimum(side, float(w))
    u = jax.random.uniform(k_pos, (n_crops, 2), jnp.float32)
    tops = jnp.floor(u[:, 0] * (jnp.maximum(h - side, 0.0) + 1.0))
    lefts = jnp.floor(u[:, 1] * (jnp.maximum(w - side, 0.0) + 1.0))
    return (float(side), np.asarray(tops).tolist(),
            np.asarray(lefts).tolist())


def _rows_from_keys(cfg, base_key, step):
    """Each pair's packed row with the draws the reference's step takes
    from fold_in(fold_in(key, step), pair id)
    (splice_tpu/parallel/pair_parallel.py:168-171, :85-98)."""
    rows = []
    for gid in range(len(ROOTS)):
        key = jax.random.fold_in(jax.random.fold_in(base_key, step), gid)
        kAa, kAc, kBa, kBc = jax.random.split(key, 4)
        st = {k: np.asarray(v).tolist()
              for k, v in _draws_from_key(kAa).items()}
        draws = ttrainer.StepDraws(
            structure=st,
            flip_B=float(jax.random.bernoulli(kBa, 0.5)),
            crops_A=_key_draws(kAc, (HW, HW), cfg.global_A_crops_n_crops,
                               cfg.global_A_crops_min_cover),
            crops_B=_key_draws(kBc, (HW, HW), cfg.global_B_crops_n_crops,
                               cfg.global_B_crops_min_cover))
        rows.append(ttrainer.pack_row(ttrainer.lambdas_vec(cfg, step), LR,
                                      draws))
    return torch.from_numpy(np.stack(rows))


def _port(vit_np, batch, flats, cfg=None):
    pairs = [ImagePair(A=torch.tensor(np.asarray(a)),
                       B=torch.tensor(np.asarray(b)), canvas_A=HW,
                       canvas_B=HW)
             for a, b in zip(batch["A"], batch["B"])]
    return tpp.MultiPairTrainer(
        cfg or _cfg(), pairs, _extractor(vit_np),
        tunet.SkipConfig(**TINY_UNET),
        init_flats=[torch.from_numpy(np.array(f)) for f in flats])


def _flats(seed):
    rng = np.random.default_rng(seed)
    tree = tunet.init_skip_params(tunet.SkipConfig(**TINY_UNET), 0.02,
                                  seed=seed, device="cpu")
    flat = tunet.flatten_params(tree)[0].numpy()
    return [flat, flat + 0.05 * rng.standard_normal(flat.shape).astype(
        np.float32)]


def _close_update(new, want, grad):
    """test_torch_step's rule for the parameters after one Adam update."""
    gmax = np.abs(grad).max()
    firm = np.abs(grad) >= 1e-3 * gmax
    assert firm.mean() > 0.5
    np.testing.assert_allclose(new[firm], want[firm], rtol=0, atol=1e-6)
    assert np.abs(new - want).max() <= 2 * LR + 1e-6


@pytest.mark.parametrize("step,entire", [(1, False), (0, True)],
                         ids=["regular", "entire"])
def test_step_matches_reference_program(reference, vit_np, step, entire):
    cfg, batch, results = reference
    parts, want_flats = results[entire]
    tr = _port(vit_np, batch, _flats(4))
    got = tr.step(_rows_from_keys(cfg, jax.random.PRNGKey(7), step), None,
                  entire)
    for k, v in parts.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, err_msg=k)
    for t, want in zip(tr.trainers, want_flats):
        _close_update(t.flat.detach().numpy(), want, t.flat.grad.numpy())


# ---------------------------------------------------------------------------
# The P-pair step against P single-pair steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_batch():
    return tpp.load_pair_batch(_cfg(), ROOTS, HW)


def _rows(cfg, batch, seed, step):
    gen = torch.Generator().manual_seed(seed)
    return torch.from_numpy(np.stack([ttrainer.pack_row(
        ttrainer.lambdas_vec(cfg, step), LR, ttrainer.sample_step_draws(
            cfg, ImagePair(A=a, B=b, canvas_A=HW, canvas_B=HW), gen))
        for a, b in zip(batch["A"], batch["B"])]))


@pytest.mark.parametrize("step,entire", [(1, False), (0, True)],
                         ids=["regular", "entire"])
def test_pairs_step_matches_single_pair_steps(vit_np, port_batch, step,
                                              entire):
    cfg = _cfg()
    flats = _flats(4)
    rows = _rows(cfg, port_batch, 9, step)
    tr = _port(vit_np, port_batch, flats)
    got = tr.step(rows, None, entire)
    for p in range(2):
        single = _port(vit_np, {k: v[p:p + 1] for k, v in port_batch.items()},
                       flats[p:p + 1]).trainers[0]
        want = single.step(rows[p], None, entire)
        for k, v in want.items():
            np.testing.assert_allclose(got[k][p].item(), v.item(),
                                       rtol=1e-5, err_msg=k)
        _close_update(tr.trainers[p].flat.detach().numpy(),
                      single.flat.detach().numpy(),
                      single.flat.grad.numpy())

    # other draws and parameters for pair 1: pair 0 as before, bitwise
    other = _rows(cfg, port_batch, 10, step)
    other[0] = rows[0]
    tr2 = _port(vit_np, port_batch, [flats[0], _flats(5)[1]])
    got2 = tr2.step(other, None, entire)
    assert not torch.equal(got2["loss"][1], got["loss"][1])
    for k in got:
        assert torch.equal(got2[k][0], got[k][0]), k
    assert torch.equal(tr2.trainers[0].flat, tr.trainers[0].flat)


# ---------------------------------------------------------------------------
# The per-pair scheduler
# ---------------------------------------------------------------------------

def _loss_sequence(steps=40, pairs=3):
    """Falling losses, pair 1 flat from step 8 (plateau cuts it), pair 2
    noisy."""
    rng = np.random.default_rng(0)
    t = np.arange(steps)[:, None]
    seq = 5.0 * np.exp(-0.05 * t) + 0.05 * rng.random((steps, pairs))
    seq[8:, 1] = seq[8, 1]
    seq[:, 2] += 0.5 * rng.random(steps)
    return seq


@pytest.mark.parametrize("policy", SCHEDULER_POLICIES)
def test_multi_pair_scheduler_matches_reference(policy):
    kw = dict(scheduler_policy=policy, n_epochs=40,
              scheduler_lr_decay_iters=7)
    got = ttrainer.MultiPairScheduler(_cfg(**kw), 3)
    want = jtrainer.MultiPairScheduler(j_load_config(None, kw), 3)
    for i, losses in enumerate(_loss_sequence()):
        np.testing.assert_array_equal(got.lr_for_step(i),
                                      want.lr_for_step(i))
        got.observe(losses)
        want.observe(losses)
    if policy == "plateau":
        factor = got.state_dict()["plateau_factor"]
        assert factor[1] < 1.0 and factor[0] == 1.0


def test_multi_pair_scheduler_state():
    cfg = _cfg(scheduler_policy="plateau")
    a = ttrainer.MultiPairScheduler(cfg, 3)
    for losses in _loss_sequence()[:20]:
        a.observe(losses)
    b = ttrainer.MultiPairScheduler(cfg, 3)
    b.load_state_dict(a.state_dict())
    ref = jtrainer.MultiPairScheduler(j_load_config(
        None, dict(scheduler_policy="plateau")), 3)
    ref.load_state_dict(a.state_dict())
    for losses in _loss_sequence()[20:]:
        for s in (a, b, ref):
            s.observe(losses)
        np.testing.assert_array_equal(b.lr_for_step(0), a.lr_for_step(0))
        np.testing.assert_array_equal(ref.lr_for_step(0), a.lr_for_step(0))
    with pytest.raises(ValueError):
        ttrainer.MultiPairScheduler(cfg, 2).load_state_dict(a.state_dict())


# ---------------------------------------------------------------------------
# train_pairs on the CPU
# ---------------------------------------------------------------------------

RUN_STEPS = 12
# Added to the totals the scheduler sees (constants: no gradient changes):
# pair 0 gets 1000 * 0.95^k after k updates, so it improves by more than
# 1% at every step whatever its own loss does; pair 1 gets STALL, so it
# never does.
STALL = 1000.0


def _run_cfg(tmp, **kw):
    return _cfg(seed=5, entire_A_every=5, log_images_freq=4,
                scheduler_policy="plateau", checkpoint_every=6,
                checkpoint_dir=str(tmp / "ck"), **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory, vit_np):
    """One train_pairs run of RUN_STEPS steps with pair 1 stalled and pair
    0 improving (constants added to their totals, which change no
    gradient), a run resumed from its checkpoint at step 6, and a run
    resumed from its last checkpoint (nothing left to do)."""
    tmp = tmp_path_factory.mktemp("pairs")
    roots = []
    for r in ROOTS:
        dst = tmp / os.path.basename(r)
        for sub in ("A", "B"):
            shutil.copytree(os.path.join(r, sub), dst / sub)
        roots.append(str(dst))
    loss = tpp.MultiPairTrainer.loss

    def stalled(self, rows, entire):
        total, parts = loss(self, rows, entire)
        first = self.trainers[0]
        state = first.opt.state.get(first.flat)
        k = float(state["step"]) if state else 0.0   # updates so far
        return total + torch.tensor([1000.0 * 0.95 ** k, STALL]), parts

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpp.MultiPairTrainer, "loss", stalled)
        cfg = _run_cfg(tmp)
        res = tpp.train_pairs(cfg, roots, HW, RUN_STEPS,
                              extractor=_extractor(vit_np))
        (tmp / "ck6").mkdir()
        shutil.copy(tmp / "ck" / "ckpt_6.pt", tmp / "ck6")
        resumed = tpp.train_pairs(
            dataclasses.replace(cfg, resume_from=str(tmp / "ck6"),
                                checkpoint_dir=None),
            roots, HW, RUN_STEPS, extractor=_extractor(vit_np))
        for r in roots:
            os.remove(os.path.join(r, "out", "output.png"))
        done = tpp.train_pairs(
            dataclasses.replace(cfg, resume_from=str(tmp / "ck"),
                                checkpoint_dir=None),
            roots, HW, RUN_STEPS, extractor=_extractor(vit_np))
    return cfg, roots, res, resumed, done, stalled


def test_train_pairs_outputs_and_metrics(run):
    cfg, roots, res, _, done, _ = run
    assert res["chunks"] == [1, 3, 1, 1, 2, 2, 1, 1]
    assert res["loss_seq"].shape == (RUN_STEPS, 2, len(ttrainer.LOSS_KEYS))
    assert np.isfinite(res["loss_seq"]).all()
    assert res["pair_steps_per_sec"] == pytest.approx(
        2 * res["steps_per_sec"])
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["ckpt_12.pt",
                                                      "ckpt_6.pt"]
    # the zero-step run (already at step 12) wrote the outputs again
    assert done["chunks"] == [] and done["first_step"] == RUN_STEPS
    for p, root in enumerate(roots):
        png = np.asarray(Image.open(os.path.join(root, "out",
                                                 "output.png")))
        np.testing.assert_array_equal(
            png, timg.tensor2im(res["outputs"][p]).numpy())
        with open(os.path.join(root, "out", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f][:3]   # the first run's
        assert [r["step"] for r in recs] == [3, 7, 11]
        for r in recs:
            row = res["loss_seq"][r["step"], p]
            for j, k in enumerate(ttrainer.LOSS_KEYS):
                assert r[k] == float(row[j]), k
            # the lr after the record's step, as the reference logs it
            ref = jtrainer.MultiPairScheduler(j_load_config(
                None, dict(scheduler_policy="plateau", lr=LR)), 2)
            for losses in res["loss_seq"][:r["step"] + 1, :, -1]:
                ref.observe(losses)
            assert r["lr"] == ref.lr_for_step(r["step"])[p]
            assert r["steps_per_sec"] > 0


def test_train_pairs_chunks_equal_eager_steps(run, vit_np, monkeypatch):
    """Steps 0-5 (two entire-A steps and chunks of 3 and 1 between them)
    eagerly from the same init: every loss, and every pair's parameters
    and Adam state at the step-6 checkpoint, bitwise."""
    cfg, roots, res, _, _, stalled = run
    monkeypatch.setattr(tpp.MultiPairTrainer, "loss", stalled)
    batch = tpp.load_pair_batch(cfg, roots, HW)
    pairs = [ImagePair(A=a, B=b, canvas_A=HW, canvas_B=HW)
             for a, b in zip(batch["A"], batch["B"])]
    tr = tpp.MultiPairTrainer(
        cfg, pairs, _extractor(vit_np),
        seeds=[tpp.pair_seeds(cfg.seed, i)[0] for i in range(2)])
    for i, rows in enumerate(res["rows"][:6]):
        parts = tr.step(torch.from_numpy(rows), None,
                        tlosses.is_entire_step(cfg, i))
        got = np.stack([parts[k].numpy() for k in ttrainer.LOSS_KEYS], -1)
        np.testing.assert_array_equal(got, res["loss_seq"][i])
    saved = Checkpointer(cfg.checkpoint_dir).restore(6)["pairs"]
    for t, want in zip(tr.trainers, saved):
        got = t.state_dict()
        assert torch.equal(got["flat"], want["flat"])
        for k, v in got["opt"][0].items():
            assert torch.equal(v, want["opt"][0][k]), k


def test_train_pairs_resume_equals_uninterrupted(run):
    _, _, res, resumed, _, _ = run
    assert resumed["first_step"] == 6
    np.testing.assert_array_equal(resumed["rows"], res["rows"][6:])
    np.testing.assert_array_equal(resumed["loss_seq"], res["loss_seq"][6:])
    for a, b in zip(resumed["trainer"].trainers, res["trainer"].trainers):
        assert torch.equal(a.flat, b.flat)


def test_train_pairs_plateau_cuts_the_stalled_pair(run):
    cfg, _, res, _, _, _ = run
    lr = res["rows"][:, :, ttrainer.LR_COLUMN]
    assert (lr[:, 0] == np.float32(LR)).all()
    assert lr[-1, 1] == np.float32(LR * 0.2)
    # the reference's scheduler, fed the run's losses chunk by chunk
    ref = jtrainer.MultiPairScheduler(j_load_config(
        None, dict(scheduler_policy="plateau", lr=LR)), 2)
    i = 0
    for n in res["chunks"]:
        want = np.float32(ref.lr_for_step(i))
        np.testing.assert_array_equal(lr[i:i + n], np.broadcast_to(
            want, (n, 2)))
        for losses in res["loss_seq"][i:i + n, :, -1]:
            ref.observe(losses)
        i += n


# ---------------------------------------------------------------------------
# The mesh, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp,pairs,devices,want", [
    (1, 1, 8, 1, (1, 1)),
    (8, 1, 8, 1, (1, 1)),          # dp clamped to the one device
    (4, 2, 8, 1, (1, 1)),          # tp to 1, then dp to 1
    (8, 1, 2, 4, (2, 1)),          # dp 2 survives
    (4, 1, 6, 4, (3, 1)),          # dp 4 -> 3, a divisor of 6
    (1, 2, 8, 2, (1, 2)),          # tp 2 survives
])
def test_mesh_clamp(dp, tp, pairs, devices, want, capsys):
    cfg = _cfg(mesh_dp=dp, mesh_tp=tp)
    assert tmesh.resolve_mesh(cfg, pairs, devices) == want
    out = capsys.readouterr().out
    if tp > devices:
        assert f"mesh tp={tp} exceeds {devices} visible device(s)" in out
    if (dp, pairs) == (4, 6):
        assert "dp=4 does not divide 6 pairs; using dp=3" in out


def test_cli_trains_comma_separated_pairs(tmp_path, capsys):
    rng = np.random.default_rng(3)
    roots = []
    for name in ("p0", "p1"):
        for sub, hw in (("A", (60, 72)), ("B", (64, 64))):
            (tmp_path / name / sub).mkdir(parents=True)
            Image.fromarray((rng.random((*hw, 3)) * 255).astype(
                np.uint8)).save(tmp_path / name / sub / "img.png")
        roots.append(str(tmp_path / name))
    ttrain.main(["--dataroot", ",".join(roots), "--n_epochs", "1",
                 "--device", "cpu", "--dino_model_name", "dino_vits8",
                 "--dino_global_patch_size", "32", "--seed", "1",
                 "--vit_compute_dtype", "float32",
                 "--generator_compute_dtype", "float32"])
    assert "pair-steps/s over 2 pairs" in capsys.readouterr().out
    for root in roots:
        png = np.asarray(Image.open(os.path.join(root, "out",
                                                 "output.png")))
        assert png.shape == (224, 224, 3)
