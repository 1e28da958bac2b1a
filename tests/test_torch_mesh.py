"""splice_tpu_torch's mesh (parallel/mesh.py), its tensor-parallel ViT
(models/vit.py) and the dp x tp multi-pair trainer (parallel/pair_parallel)
against splice_tpu's.

The reference holds its mesh on a virtual 8-CPU mesh; the port's mesh
lists the CPU once per rank (['cpu'] * n), so every reduction is an add
on one device.

  * make_mesh, and its refusal of more devices than it has (the
    counterpart of tests/test_parallel.py:25-31);
  * each rank's parameters equal the numpy slices of the reference's
    manual_tp_permute_vit_params output under its vit_param_pspecs,
    exactly; the permutation's round trip (:211-231);
  * the tp = 2 and tp = 4 ViT's taps (qkv, block, attn_probs) and input
    gradient against the reference's tp = 1 vit_forward, fp32, within
    1e-5 x the largest entry (the row-parallel partial sums add in another
    order);
  * dp = 2 x tp = 2 multi-pair steps on ['cpu'] * 4 against dp = tp = 1,
    per pair and each from one state: losses within 1e-5 relative, the
    update within 1e-4 relative L2 (LOSS_RTOL, UPDATE_RTOL below);
  * a dp = 2 checkpoint resumes at dp = 1, and back, with equal states.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.models import vit as jvit
from splice_tpu.parallel import mesh as jmesh
from splice_tpu_torch.config import load_config
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import (init_vit_params,
                                             vit_params_from_numpy)
from splice_tpu_torch.parallel import mesh as tmesh
from splice_tpu_torch.parallel import pair_parallel as tpp
from splice_tpu_torch.utils.checkpoint import Checkpointer

# the reference's tiny_cfg (tests/test_parallel.py:20-22): 8 heads of 16
TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=8,
                img_size=32)
ROOTS = ["datasets/splicing/cows", "datasets/splicing/apples2oranges"]
HW = 64
TAP_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (see
    tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    """The tiny ViT's reference parameters, biases and LayerNorm affines
    perturbed so that a dropped term shows."""
    jp = jvit.init_vit_params(jax.random.PRNGKey(0),
                              jvit.VitConfig(**TINY_VIT))
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(
        np.float32) for l in leaves]
    return jax.tree.unflatten(tree, leaves)


def test_make_mesh():
    mesh = tmesh.make_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "tp": 2}
    assert all(d == torch.device("cpu") for row in mesh.devices
               for d in row)
    assert tmesh.dp_sharding(mesh, 8) == [range(0, 2), range(2, 4),
                                          range(4, 6), range(6, 8)]


def test_too_many_devices():
    with pytest.raises(ValueError):
        tmesh.make_mesh(dp=16, tp=2, devices=["cpu"] * 8)
    # devices=None takes the visible CUDA devices: never 2 x 2 here
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError):
            tmesh.make_mesh(dp=2, tp=2)


def _leaf(tree, path):
    for key in path:
        tree = tree[getattr(key, "key", getattr(key, "idx", None))]
    return tree


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_slices_equal_reference_sharding(jparams, tp):
    """Rank r's leaf is chunk r of the reference's permuted leaf along the
    axis its PartitionSpec names 'tp' (the whole leaf under P())."""
    jcfg, tcfg = jvit.VitConfig(**TINY_VIT), tvit.VitConfig(**TINY_VIT)
    jperm = jmesh.manual_tp_permute_vit_params(jparams, jcfg, tp)
    jspecs = jmesh.vit_param_pspecs(jperm)
    tparams = vit_params_from_numpy(jax.tree.map(np.asarray, jparams))
    ranks = tmesh.shard_vit_params(
        tmesh.manual_tp_permute_vit_params(tparams, tcfg, tp),
        tmesh.make_mesh(1, tp, ["cpu"] * tp))[0]
    tspecs = tmesh.vit_param_pspecs(tparams)
    leaves = jax.tree_util.tree_flatten_with_path(jperm)[0]
    assert len(leaves) == len(jax.tree.leaves(tparams))
    for path, want in leaves:
        spec = tuple(_leaf(jspecs, path))
        axis = spec.index("tp") if "tp" in spec else None
        assert _leaf(tspecs, path) == axis, path
        want = np.asarray(want)
        for r in range(tp):
            sl = want
            if axis is not None:
                n = want.shape[axis] // tp
                sl = np.take(want, range(r * n, (r + 1) * n), axis=axis)
            np.testing.assert_array_equal(_leaf(ranks[r], path).numpy(), sl)


def test_permute_roundtrip_layout(jparams):
    """Rank s's qkv columns, regrouped [3, H/tp, dh], are the original's
    heads s*H/tp..(s+1)*H/tp (tests/test_parallel.py:211-231)."""
    cfg = tvit.VitConfig(**TINY_VIT)
    tp = 4
    params = vit_params_from_numpy(jax.tree.map(np.asarray, jparams))
    pp = tmesh.manual_tp_permute_vit_params(params, cfg, tp)
    D, H, dh = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    orig = params["blocks"][0]["attn"]["qkv"]["kernel"].reshape(D, 3, H, dh)
    kp = pp["blocks"][0]["attn"]["qkv"]["kernel"]
    hl = H // tp
    for s in range(tp):
        loc = kp[:, s * 3 * hl * dh:(s + 1) * 3 * hl * dh].reshape(
            D, 3, hl, dh)
        assert torch.equal(loc, orig[:, :, s * hl:(s + 1) * hl])
    with pytest.raises(ValueError):
        tmesh.manual_tp_permute_vit_params(params, cfg, 3)


def _tap_loss(out, weights):
    return sum((out[k][i] * w).sum() for (k, i), w in weights.items())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("taps", [{"qkv": (0, 1), "block": (0, 1)},
                                  {"attn_probs": (1,), "block": (1,)}],
                         ids=["qkv_block", "attn_probs"])
def test_tp_vit_matches_reference_tp1(jparams, tp, taps):
    """Taps and the input gradient of a seeded weighted sum of them."""
    jcfg, tcfg = jvit.VitConfig(**TINY_VIT), tvit.VitConfig(**TINY_VIT)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jout = jvit.vit_forward(jparams, jnp.asarray(img), jcfg, taps)
    weights = {(k, i): rng.standard_normal(np.shape(jout[k][i])).astype(
        np.float32) for k, layers in taps.items() for i in layers}
    jgrad = np.asarray(jax.grad(lambda x: _tap_loss(
        jvit.vit_forward(jparams, x, jcfg, taps),
        {k: jnp.asarray(w) for k, w in weights.items()}))(jnp.asarray(img)))

    mesh = tmesh.make_mesh(1, tp, ["cpu"] * tp)
    params = vit_params_from_numpy(jax.tree.map(np.asarray, jparams))
    ranks = tmesh.shard_vit_params(
        tmesh.manual_tp_permute_vit_params(params, tcfg, tp), mesh)[0]
    x = torch.from_numpy(img).requires_grad_(True)
    tout = tvit.vit_forward(ranks, x, tcfg, taps, devices=mesh.devices[0])
    _tap_loss(tout, {k: torch.from_numpy(w)
                     for k, w in weights.items()}).backward()
    for k, layers in taps.items():
        for i in layers:
            want = np.asarray(jout[k][i])
            np.testing.assert_allclose(
                tout[k][i].detach().numpy(), want, rtol=0,
                atol=TAP_RTOL * np.abs(want).max(), err_msg=f"{k}[{i}]")
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                               atol=TAP_RTOL * np.abs(jgrad).max())


# ---------------------------------------------------------------------------
# dp x tp multi-pair steps and checkpoints
# ---------------------------------------------------------------------------

MESH_STEPS = 3      # an entire-A step (0), then two regular steps
# From one state, a dp = 2 x tp = 2 step and a dp = tp = 1 step agree to
# about 2e-7 in their losses and 2e-6 (relative L2) in their gradients
# (fp32: the tp ViT's partial sums add in another order). Over several
# steps the fp32 generator gradient's conditioning (tests/test_torch_step.py)
# amplifies that to 3e-3 in the losses by step 2, so each step is compared
# from the dp = 1 run's state before it, under SGD (the update is lr x the
# gradient; Adam's first updates are about lr x its sign, which a rounding
# flips where an entry is near 0).
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-5      # relative L2 of one step's update


def _cfg(**kw):
    return load_config(None, {
        **dict(use_augmentations=True, vit_compute_dtype="float32",
               generator_compute_dtype="float32", dino_global_patch_size=32,
               lr=2e-3, seed=3, device="cpu", log_images_freq=100), **kw})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """train_pairs over two pairs: MESH_STEPS SGD steps at dp = tp = 1
    with a checkpoint after every step ("one"), and the dp = 2 x tp = 2
    grid on ['cpu'] * 4 resumed from each of one's checkpoints at 1 and 2
    for one step ("grid_from_1", ...); MESH_STEPS Adam steps on the grid
    ("grid") and at dp = tp = 1 ("one_adam"), each checkpointed at the
    end, and each checkpoint resumed at the other layout with nothing left
    to run ("grid_at_one", "one_at_grid")."""
    tmp = tmp_path_factory.mktemp("mesh")
    roots = []
    for r in ROOTS:
        dst = tmp / os.path.basename(r)
        for sub in ("A", "B"):
            shutil.copytree(os.path.join(r, sub), dst / sub)
        roots.append(str(dst))
    vcfg = tvit.VitConfig(**TINY_VIT)
    ext = text.VitExtractor(params=init_vit_params(vcfg, seed=2,
                                                   device="cpu"), cfg=vcfg)
    layouts = {"one": tmesh.make_mesh(1, 1, ["cpu"]),
               "grid": tmesh.make_mesh(2, 2, ["cpu"] * 4)}

    def run(name, layout, steps, **kw):
        runs[name] = tpp.train_pairs(_cfg(**kw), roots, HW, steps,
                                     extractor=ext, mesh=layouts[layout])

    runs = {}
    run("one", "one", MESH_STEPS, optimizer="sgd", checkpoint_every=1,
        checkpoint_dir=str(tmp / "one"))
    for k in range(1, MESH_STEPS):
        (tmp / f"one{k}").mkdir()
        shutil.copy(tmp / "one" / f"ckpt_{k}.pt", tmp / f"one{k}")
        run(f"grid_from_{k}", "grid", k + 1, optimizer="sgd",
            resume_from=str(tmp / f"one{k}"))
    # Adam's moments ride in these checkpoints
    for name in ("grid", "one_adam"):
        run(name, name.split("_")[0], MESH_STEPS,
            checkpoint_every=MESH_STEPS, checkpoint_dir=str(tmp / name))
    run("grid_at_one", "one", MESH_STEPS, resume_from=str(tmp / "grid"))
    run("one_at_grid", "grid", MESH_STEPS, resume_from=str(tmp / "one_adam"))
    runs["ckpt"] = {k: Checkpointer(str(tmp / "one")).restore(k)
                    for k in range(1, MESH_STEPS + 1)}
    return runs


def _states(res):
    return [(t.flat.detach(), t.opt.state_dict()["state"])
            for mp in res["trainers"] for t in mp.trainers]


def test_dp2_tp2_steps_match_dp1_tp1(mesh_runs):
    """Step 0 from the seeded init, each later step from the dp = 1 run's
    state: every pair's losses and update."""
    one, grid = mesh_runs["one"], mesh_runs["grid"]
    assert [len(t.trainers) for t in grid["trainers"]] == [1, 1]
    assert grid["trainers"][1].extractor.tp_devices == (
        torch.device("cpu"),) * 2
    assert grid["chunks"] == [1, 2] and one["chunks"] == [1, 1, 1]
    np.testing.assert_array_equal(grid["rows"], one["rows"])
    np.testing.assert_allclose(grid["loss_seq"][0], one["loss_seq"][0],
                               rtol=LOSS_RTOL, atol=0)
    ckpt = mesh_runs["ckpt"]
    for k in range(1, MESH_STEPS):
        res = mesh_runs[f"grid_from_{k}"]
        np.testing.assert_array_equal(res["rows"][0], one["rows"][k])
        np.testing.assert_allclose(res["loss_seq"][0], one["loss_seq"][k],
                                   rtol=LOSS_RTOL, atol=0)
        for (flat, _), before, after in zip(_states(res),
                                            ckpt[k]["pairs"],
                                            ckpt[k + 1]["pairs"]):
            want = after["flat"] - before["flat"]
            got = flat - before["flat"]
            assert ((got - want).norm() / want.norm()).item() <= UPDATE_RTOL


@pytest.mark.parametrize("name,src", [("grid_at_one", "grid"),
                                      ("one_at_grid", "one_adam")])
def test_checkpoint_resumes_at_another_dp(mesh_runs, name, src):
    """A zero-step resumed run holds the checkpointed run's final state:
    every pair's flat parameters and optimizer state, equal."""
    res, want = mesh_runs[name], mesh_runs[src]
    assert res["first_step"] == MESH_STEPS and res["chunks"] == []
    assert res["mesh"].dp != want["mesh"].dp
    for (fa, sa), (fb, sb) in zip(_states(res), _states(want)):
        assert torch.equal(fa, fb)
        assert set(sb[0]) == set(sa[0]) == {"step", "exp_avg",
                                             "exp_avg_sq"}
        for k, v in sb[0].items():
            assert torch.equal(sa[0][k], v), k
