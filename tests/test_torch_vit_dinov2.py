"""The DINOv2 backbones of splice_tpu_torch against splice_tpu: layer scale,
register tokens, every tap, the weights' four sources, the extractor's
accessors and the keys-PCA tool.

A tiny DINOv2 ViT (depth 2, width 128, 2 heads of 64, patch 14, pos_embed
made at 56 px: base grid 4), with layer scale and every other leaf set to
random values so that a dropped term shows, carried over with
vit_params_from_numpy, must give the JAX taps at fp32 within 1e-5 x the
largest entry of each (two blocks of O(1) activations; the probabilities
within 1e-5 absolute), at the base grid and at a grid that interpolates.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.models import extractor as jext
from splice_tpu.models import vit as jvit
from splice_tpu.models import weights as jweights
from splice_tpu.tools import keys_self_sim_pca as jpca
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models import weights as tweights
from splice_tpu_torch.tools import keys_self_sim_pca as tpca
from splice_tpu_torch.tools import port_dino_weights as tport

TINY = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2, img_size=56,
            interpolate_offset=0.0, layerscale_init=1e-5)
TAPS = {"qkv": (0, 1), "block": (0, 1), "attn_out": (0, 1),
        "attn_probs": (1,)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(registers):
    return (jvit.VitConfig(**TINY, num_register_tokens=registers),
            tvit.VitConfig(**TINY, num_register_tokens=registers))


def _params(registers, seed=0):
    """The JAX init with every leaf moved by noise (layer scale to O(0.5),
    so that it matters), as numpy arrays."""
    jp = jvit.init_vit_params(jax.random.PRNGKey(4), _cfgs(registers)[0])
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(
        np.float32) for l in leaves]
    p = jax.tree.unflatten(tree, leaves)
    for blk in p["blocks"]:
        for k in ("ls1", "ls2"):
            blk[k] = (0.5 + rng.random(blk[k].shape)).astype(np.float32)
    return p


def _close(got, want, what, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("registers", [0, 4])
@pytest.mark.parametrize("hw", [(56, 56), (70, 46)])
def test_tiny_dinov2_taps_match(registers, hw):
    jp = _params(registers)
    jcfg, tcfg = _cfgs(registers)
    img = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    jout = jvit.vit_forward(jp, jnp.asarray(img), jcfg, TAPS,
                            final_norm=True)
    tout = tvit.vit_forward(tweights.vit_params_from_numpy(jp),
                            torch.from_numpy(img), tcfg, TAPS,
                            final_norm=True)
    n = 1 + registers + (hw[0] // 14) * (hw[1] // 14)
    for kind, layers in TAPS.items():
        for layer in layers:
            got = tout[kind][layer]
            assert got.shape[-2] == n, (kind, got.shape)
            _close(got.numpy(), jout[kind][layer], f"{kind} {layer}")
    np.testing.assert_allclose(tout["attn_probs"][1].sum(-1).numpy(), 1.0,
                               atol=1e-5)
    _close(tout["final"][-1].numpy(), jout["final"][-1], "final")


def test_attn_probs_block_launches_no_attention_kernel(monkeypatch):
    """A block tapped for attn_probs takes its output from the explicit
    probabilities: attention_from_qkv (K1/K2 on the card) runs for the
    untapped block only."""
    calls = []
    real = tvit.attention_from_qkv
    monkeypatch.setattr(tvit, "attention_from_qkv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tp = tweights.vit_params_from_numpy(_params(4))
    img = torch.zeros(1, 56, 56, 3)
    tvit.vit_forward(tp, img, _cfgs(4)[1], {"attn_probs": (1,)})
    assert len(calls) == 1


def test_cast_keeps_layer_scale_and_registers_fp32():
    tp = tweights.vit_params_from_numpy(_params(4))
    cast = tvit.cast_params_for_compute(tp, torch.bfloat16)
    assert cast["register_tokens"].dtype == torch.float32
    assert cast["blocks"][0]["ls1"].dtype == torch.float32
    assert cast["blocks"][0]["attn"]["qkv"]["kernel"].dtype == torch.bfloat16


def test_bf16_layer_scale_rounds_at_use():
    """bf16 compute: each block's ls multiplies in the activation's dtype,
    as the reference's o * ls.astype(o.dtype) does (1.6e-2 x max|ref|:
    bf16 rounding through two blocks, summed in another order)."""
    jp = _params(4)
    jcfg, tcfg = _cfgs(4)
    img = np.random.default_rng(2).standard_normal((1, 56, 56, 3)).astype(
        np.float32)
    jout = jvit.vit_forward(
        jvit.cast_params_for_compute(jax.tree.map(jnp.asarray, jp),
                                     jnp.bfloat16),
        jnp.asarray(img), jcfg, {"block": (1,)}, compute_dtype=jnp.bfloat16)
    tout = tvit.vit_forward(
        tvit.cast_params_for_compute(tweights.vit_params_from_numpy(jp),
                                     torch.bfloat16),
        torch.from_numpy(img), tcfg, {"block": (1,)},
        compute_dtype=torch.bfloat16)
    got = tout["block"][1]
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(jout["block"][1], np.float32),
           "bf16 block 1", rtol=1.6e-2)


def test_registry_matches_the_reference():
    for name in ("dinov2_vitb14", "dinov2_vitl14", "dinov2_vitb14_reg",
                 "dinov2_vitl14_reg"):
        j, t = jvit.get_vit_config(name), tvit.get_vit_config(name)
        for f in ("patch_size", "embed_dim", "depth", "num_heads",
                  "img_size", "interpolate_offset", "layerscale_init",
                  "num_register_tokens", "base_grid"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_random_init_has_layer_scale_and_registers():
    cfg = tvit.VitConfig(**TINY, num_register_tokens=4)
    p = tweights.init_vit_params(cfg, seed=3, device="cpu")
    assert p["register_tokens"].shape == (1, 4, 128)
    assert p["pos_embed"].shape == (1, 17, 128)       # CLS and 4 x 4
    assert torch.equal(p["blocks"][1]["ls2"], torch.full((128,), 1e-5))
    assert torch.equal(p["register_tokens"], tweights.init_vit_params(
        cfg, seed=3, device="cpu")["register_tokens"])


def _state_dict(registers, seed=0):
    """A DINOv2-style torch state dict of the tiny model."""
    rng = np.random.default_rng(seed)
    D, Hm = 128, 512

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    s = {"cls_token": r(1, 1, D), "pos_embed": r(1, 17, D),
         "patch_embed.proj.weight": r(D, 3, 14, 14),
         "patch_embed.proj.bias": r(D), "norm.weight": r(D),
         "norm.bias": r(D)}
    if registers:
        s["register_tokens"] = r(1, registers, D)
    for i in range(2):
        p = f"blocks.{i}"
        for name, (o, n) in {"attn.qkv": (3 * D, D), "attn.proj": (D, D),
                             "mlp.fc1": (Hm, D), "mlp.fc2": (D, Hm)}.items():
            s[f"{p}.{name}.weight"], s[f"{p}.{name}.bias"] = r(o, n), r(o)
        for ln in ("norm1", "norm2"):
            s[f"{p}.{ln}.weight"], s[f"{p}.{ln}.bias"] = r(D), r(D)
        s[f"{p}.ls1.gamma"], s[f"{p}.ls2.gamma"] = r(D), r(D)
    return s


def _assert_trees_equal(torch_tree, jax_tree):
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), torch_tree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("registers", [0, 4])
def test_state_dict_maps_as_the_reference_does(registers):
    jcfg, tcfg = _cfgs(registers)
    state = _state_dict(registers)
    want = jweights.port_torch_state_dict(
        {k: v.numpy() for k, v in state.items()}, jcfg)
    _assert_trees_equal(tweights.port_dino_state_dict(state, tcfg, "cpu"),
                        want)
    # a layer-scale model's dict without gammas takes layerscale_init
    bare = {k: v for k, v in state.items() if ".ls" not in k}
    _assert_trees_equal(
        tweights.port_dino_state_dict(bare, tcfg, "cpu"),
        jweights.port_torch_state_dict(
            {k: v.numpy() for k, v in bare.items()}, jcfg))


def test_register_mismatch_raises_in_both():
    state = _state_dict(4)
    with pytest.raises(ValueError, match="register"):
        jweights.port_torch_state_dict(
            {k: v.numpy() for k, v in state.items()}, _cfgs(0)[0])
    with pytest.raises(ValueError, match="register"):
        tweights.port_dino_state_dict(state, _cfgs(0)[1], "cpu")
    with pytest.raises(ValueError, match="register"):
        tweights.port_dino_state_dict(_state_dict(0), _cfgs(4)[1], "cpu")


@pytest.fixture
def registered(monkeypatch):
    """The tiny models under registered names in both packages."""
    for reg, name in ((0, "_tiny_v2"), (4, "_tiny_v2_reg")):
        jcfg, tcfg = _cfgs(reg)
        monkeypatch.setitem(jvit.VIT_CONFIGS, name, jcfg)
        monkeypatch.setitem(tvit.VIT_CONFIGS, name, tcfg)


def test_npz_written_by_jax_package_loads(tmp_path, registered):
    jp = jax.tree.map(jnp.asarray, _params(4))
    path = str(tmp_path / "v2reg.npz")
    jweights.save_vit_params(path, jp, "_tiny_v2_reg")
    _assert_trees_equal(tweights.load_vit_npz(path, device="cpu"), jp)
    # the same file under a model without registers: refused by both
    with pytest.raises(ValueError):
        tweights.load_vit_npz(path, "_tiny_v2", device="cpu")
    with pytest.raises(ValueError):
        jweights.load_vit_params(path, "_tiny_v2")
    one = str(tmp_path / "v2.npz")
    jweights.save_vit_params(one, jax.tree.map(jnp.asarray, _params(0)),
                             "_tiny_v2")
    with np.load(one) as data:
        flat = dict(data)
    flat["__model_name__"] = np.asarray("_tiny_v2_reg")
    np.savez(one, **flat)
    with pytest.raises(ValueError, match="register"):
        tweights.load_vit_npz(one, device="cpu")
    with pytest.raises(ValueError, match="register"):
        jweights.load_vit_params(one)


def test_port_dino_weights_round_trip(tmp_path, registered):
    """A torch.save'd DINO release layout (the dict under 'teacher',
    'module.' prefixes, an argparse.Namespace beside it) through the
    port's tool: the JAX package reads the file equal to its own mapping of
    the same dict."""
    state = _state_dict(4, seed=3)
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"teacher": {f"module.{k}": v for k, v in state.items()},
                "args": argparse.Namespace(arch="vit")}, ckpt)
    out = str(tmp_path / "out.npz")
    n = tport.port_checkpoint(str(ckpt), "_tiny_v2_reg", out, device="cpu")
    assert n == sum(v.numel() for v in state.values())
    want = jweights.port_torch_state_dict(
        {k: v.numpy() for k, v in state.items()}, _cfgs(4)[0])
    _assert_trees_equal(
        tweights.vit_params_from_numpy(
            jax.tree.map(np.asarray,
                         jweights.load_vit_params(out, "_tiny_v2_reg"))),
        want)


def test_extractor_accessors_match():
    jp = _params(4)
    jcfg, tcfg = _cfgs(4)
    img = np.random.default_rng(5).standard_normal((1, 70, 56, 3)).astype(
        np.float32)
    je = jext.VitExtractor(params=jax.tree.map(jnp.asarray, jp), cfg=jcfg)
    te = text.VitExtractor(params=tweights.vit_params_from_numpy(jp),
                           cfg=tcfg)
    x, xt = jnp.asarray(img), torch.from_numpy(img)
    for name in ("get_patch_size", "get_head_num", "get_embedding_dim"):
        assert getattr(te, name)() == getattr(je, name)()
    for name in ("get_width_patch_num", "get_height_patch_num",
                 "get_patch_num"):
        assert getattr(te, name)(img.shape) == getattr(je, name)(img.shape)
    for name in ("get_feature_from_input", "get_qkv_feature_from_input",
                 "get_attn_feature_from_input"):
        got, want = getattr(te, name)(xt), getattr(je, name)(x)
        assert len(got) == len(want) == 2
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g.numpy(), w, f"{name}[{i}]")
    for name in ("get_keys_from_input", "get_keys_self_sim_from_input"):
        _close(getattr(te, name)(xt, 1).numpy(), getattr(je, name)(x, 1),
               name)
    _close(te.get_cls_token_from_input(xt).numpy(),
           je.get_cls_token_from_input(x), "cls")
    ssim = te.get_keys_self_sim_from_input(xt, 0)
    assert ssim.shape == (1, 1 + 4 + 5 * 4, 1 + 4 + 5 * 4)   # registers kept


def test_make_extractor_seeded_on_the_cpu(registered):
    e = text.make_extractor("_tiny_v2_reg", seed=2, device="cpu")
    assert e.params["register_tokens"].device.type == "cpu"
    assert e.cfg.num_register_tokens == 4


def test_pca_project_matches():
    x = np.random.default_rng(6).standard_normal((40, 12)).astype(np.float32)
    got, want = tpca.pca_project(x, 3), jpca.pca_project(x, 3)
    # components are defined up to sign: compare column by column
    for j in range(3):
        s = np.sign(np.dot(got[:, j], want[:, j]))
        np.testing.assert_allclose(s * got[:, j], want[:, j], rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_pca_visualize_on_the_cpu(tmp_path, registered):
    from PIL import Image
    out = tpca.visualize("datasets/feature_visualization/limes.jpeg",
                         str(tmp_path / "pca.png"), layer=1,
                         dino_model_name="_tiny_v2_reg", resize=56,
                         device="cpu")
    img = Image.open(out)
    assert img.mode == "RGB" and img.size[1] == (56 // 14) * 14
