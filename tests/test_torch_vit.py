"""splice_tpu_torch.models.vit and .weights against splice_tpu.

A tiny ViT (depth 2, width 128, 2 heads of 64) carried over with
vit_params_from_numpy must give the JAX taps at fp32 (rtol 1e-5, atol 1e-5
for O(1) activations through two blocks). The full-width ViT-B/8 loaded
through the DINO state-dict loader must reproduce tests/fixtures/
golden_vitb8.npz (an independent torch DINO implementation) at the
tolerances of tests/test_vit_golden.py.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_vit
from splice_tpu.models import vit as jvit
from splice_tpu.models import weights as jweights
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models import weights as tweights

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_vitb8.npz"
TINY = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, img_size=32)


def _tiny_params():
    jcfg = jvit.VitConfig(**TINY)
    jp = jvit.init_vit_params(jax.random.PRNGKey(4), jcfg)
    # non-zero biases and LayerNorm affines, so a dropped term shows
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(
        np.float32) for l in leaves]
    return jax.tree.unflatten(tree, leaves)


@pytest.mark.parametrize("hw", [(32, 32), (48, 40)])
def test_tiny_vit_taps_match(hw):
    jp = _tiny_params()
    img = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    taps = {"qkv": (0, 1), "block": (0, 1)}
    jout = jvit.vit_forward(jp, jnp.asarray(img), jvit.VitConfig(**TINY),
                            taps, final_norm=True)
    tp = tweights.vit_params_from_numpy(jax.tree.map(np.asarray, jp))
    tout = tvit.vit_forward(tp, torch.from_numpy(img),
                            tvit.VitConfig(**TINY), taps, final_norm=True)
    for kind in ("qkv", "block"):
        for layer in (0, 1):
            np.testing.assert_allclose(tout[kind][layer].numpy(),
                                       np.asarray(jout[kind][layer]),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout["final"][-1].numpy(),
                               np.asarray(jout["final"][-1]),
                               rtol=1e-5, atol=1e-5)


def test_interpolate_pos_embed_matches():
    pos = np.random.default_rng(2).standard_normal((1, 17, 128)).astype(
        np.float32)
    want = jvit.interpolate_pos_embed(jnp.asarray(pos),
                                      jvit.VitConfig(**TINY), 5, 7)
    got = tvit.interpolate_pos_embed(torch.from_numpy(pos),
                                     tvit.VitConfig(**TINY), 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_npz_written_by_jax_package_loads(tmp_path):
    jp = jvit.init_vit_params(jax.random.PRNGKey(1),
                              jvit.get_vit_config("dino_vits8"))
    path = str(tmp_path / "vits8.npz")
    jweights.save_vit_params(path, jp, "dino_vits8")
    tp = tweights.load_vit_npz(path, "dino_vits8", device="cpu")
    want = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tweights.load_vit_npz(path, "dino_vitb8", device="cpu")


def test_random_init_is_seeded_and_shaped():
    cfg = tvit.VitConfig(**TINY)
    a = tweights.init_vit_params(cfg, seed=3, device="cpu")
    b = tweights.init_vit_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["blocks"][1]["attn"]["qkv"]["kernel"],
                       b["blocks"][1]["attn"]["qkv"]["kernel"])
    assert a["pos_embed"].shape == (1, 17, 128)
    assert a["patch_embed"]["kernel"].shape == (8, 8, 3, 128)
    assert a["blocks"][0]["attn"]["qkv"]["kernel"].abs().max() <= 0.04


@pytest.fixture(scope="module")
def golden_out():
    golden = dict(np.load(FIXTURE))
    cfg = tvit.get_vit_config("dino_vitb8")
    state = golden_vit.make_state(int(golden["seed"]))
    params = tweights.port_dino_state_dict(state, cfg, device="cpu")
    img = torch.from_numpy(golden_vit.make_input(int(golden["seed"])))
    torch.set_num_threads(max(torch.get_num_threads(), 2))
    with torch.no_grad():
        out = tvit.vit_forward(params, img, cfg,
                               {"block": (11,), "qkv": (11,)},
                               final_norm=True)
    return golden, (out["qkv"][11][0].numpy(), out["block"][11][0].numpy(),
                    out["final"][-1][0].numpy())


def test_full_width_vitb8_matches_golden(golden_out):
    golden, (qkv11, blk11, final) = golden_out
    rows = golden["rows"]
    np.testing.assert_allclose(qkv11[rows],
                               golden["qkv11_rows"].astype(np.float32),
                               atol=4e-3, rtol=2e-3)
    np.testing.assert_allclose(blk11[rows],
                               golden["block11_rows"].astype(np.float32),
                               atol=8e-3, rtol=2e-3)
    np.testing.assert_allclose(blk11[0], golden["cls11"], atol=5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(final[rows],
                               golden["final_rows"].astype(np.float32),
                               atol=8e-3, rtol=2e-3)


def test_full_width_vitb8_moments(golden_out):
    golden, (qkv11, blk11, _) = golden_out
    assert abs(qkv11.mean() - golden["qkv11_mean"]) < 1e-4
    assert abs(qkv11.std() - golden["qkv11_std"]) < 1e-3
    assert abs(blk11.mean() - golden["block11_mean"]) < 1e-4
    assert abs(blk11.std() - golden["block11_std"]) < 1e-3
