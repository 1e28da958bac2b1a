"""The port's ViT at a head width above 64 against splice_tpu's.

A tiny VitConfig with dh = 128 (patch 8, embed_dim 256, 2 heads, depth 2)
on two 32 x 40 images (21 tokens: under one 64-row tile). At dh = 128 the
fused-qkv gate fails in both packages, so both split the heads: the
reference runs its Pallas K5/K6 (use_pallas=True, interpret mode on the
CPU) over its padded token stream (PAD_TOKEN_STREAM: 21 tokens padded to
128, keys past 21 masked), the port multi_head_attention's
AttnSplit (K5/K6's plain versions on the CPU; on the card the chunked wide
forms). Parameters from one JAX init through weights.vit_params_from_numpy,
images from one numpy seed, fp32. The qkv and block taps at both layers and
the gradient of a fixed linear function of both layer-1 taps with respect
to the images must agree within rtol 1e-5 and atol 1e-5 (the taps: O(1)
activations through two blocks) and rtol 1e-4 and atol 1e-4 x max|grad|
(the gradient: sums over every token and channel in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.models import vit as jvit
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models import weights as tweights

WIDE = dict(patch_size=8, embed_dim=256, depth=2, num_heads=2, img_size=32)
TAPS = {"qkv": (0, 1), "block": (0, 1)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    jp = jvit.init_vit_params(jax.random.PRNGKey(7), jvit.VitConfig(**WIDE))
    # non-zero biases and LayerNorm affines, so a dropped term shows
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.default_rng(3)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(
        np.float32) for l in leaves]
    return jax.tree.unflatten(tree, leaves)


def test_wide_head_vit_matches_reference(monkeypatch):
    monkeypatch.setattr(jvit, "PAD_TOKEN_STREAM", True)
    rng = np.random.default_rng(11)
    img = rng.standard_normal((2, 32, 40, 3)).astype(np.float32)
    wq = rng.standard_normal((2, 21, 768)).astype(np.float32)
    wb = rng.standard_normal((2, 21, 256)).astype(np.float32)
    jp = _params()
    jcfg = jvit.VitConfig(**WIDE)
    assert jcfg.head_dim == 128

    def jloss(images):
        out = jvit.vit_forward(jp, images, jcfg, TAPS, use_pallas=True)
        return (jnp.sum(out["qkv"][1] * wq) + jnp.sum(out["block"][1] * wb),
                out)

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(img))

    tp = tweights.vit_params_from_numpy(jax.tree.map(np.asarray, jp))
    timg = torch.from_numpy(img).requires_grad_(True)
    tout = tvit.vit_forward(tp, timg, tvit.VitConfig(**WIDE), TAPS,
                            use_pallas=True)
    (torch.sum(tout["qkv"][1] * torch.from_numpy(wq))
     + torch.sum(tout["block"][1] * torch.from_numpy(wb))).backward()
    for kind in ("qkv", "block"):
        for layer in (0, 1):
            np.testing.assert_allclose(
                tout[kind][layer].detach().numpy(),
                np.asarray(jout[kind][layer]), rtol=1e-5, atol=1e-5,
                err_msg=f"{kind} {layer}")
    want = np.asarray(jgrad)
    np.testing.assert_allclose(timg.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
