"""splice_tpu_torch.losses against splice_tpu.losses.

A tiny ViT (depth 2, width 128, 2 heads of 64) with the same weights on
both sides. Loss values at rtol 1e-5; gradients with respect to the
generated images against jax.grad at rtol 1e-4 with atol 1e-3 x the
gradient's largest entry (the Gram-matrix MSE sums many products of
cancelling terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu import losses as jlosses
from splice_tpu.config import Config as JConfig
from splice_tpu.models import extractor as jext
from splice_tpu.models import vit as jvit
from splice_tpu_torch import losses as tlosses
from splice_tpu_torch.config import Config as TConfig
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import vit_params_from_numpy

TINY = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, img_size=32)


@pytest.fixture(scope="module")
def extractors():
    jp = jvit.init_vit_params(jax.random.PRNGKey(2), jvit.VitConfig(**TINY))
    jp = jax.tree.map(np.asarray, jp)
    je = jext.VitExtractor(params=jp, cfg=jvit.VitConfig(**TINY))
    te = text.VitExtractor(params=vit_params_from_numpy(jp),
                           cfg=tvit.VitConfig(**TINY))
    return je, te


def _imgs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _check_grads(tg, jg):
    for t, j in zip(tg, jg):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                                   atol=1e-3 * np.abs(j).max())


@pytest.mark.parametrize("n,m", [(1, 1), (2, 1)])
def test_splice_losses_fused_values_and_grads(extractors, n, m):
    je, te = extractors
    gA, cA, gB, cB = _imgs([(n, 32, 32, 3), (n, 32, 32, 3), (m, 32, 32, 3),
                            (m, 32, 32, 3)], seed=n + 10 * m)
    names = ("loss_global_ssim", "loss_global_cls", "loss_global_id_B")

    def jf(a, b):
        parts, _ = jlosses.splice_losses_fused(je, a, jnp.asarray(cA), b,
                                               jnp.asarray(cB))
        return sum(parts[k] for k in names), parts

    (jtot, jparts), jg = jax.value_and_grad(jf, argnums=(0, 1),
                                            has_aux=True)(jnp.asarray(gA),
                                                          jnp.asarray(gB))
    ta = torch.from_numpy(gA).requires_grad_(True)
    tb = torch.from_numpy(gB).requires_grad_(True)
    tparts, aux = tlosses.splice_losses_fused(
        te, ta, torch.from_numpy(cA), tb, torch.from_numpy(cB))
    sum(tparts[k] for k in names).backward()
    for k in names:
        np.testing.assert_allclose(tparts[k].item(), float(jparts[k]),
                                   rtol=1e-5)
    assert aux["cls_B"].shape == (m, 128) and not aux["cls_B"].requires_grad
    _check_grads((ta.grad, tb.grad), jg)


def test_entire_losses_fused_values_and_grads(extractors):
    je, te = extractors
    gE, eA, clsB = _imgs([(1, 32, 40, 3), (1, 32, 40, 3), (2, 128)], seed=5)

    def jf(x):
        parts = jlosses.entire_losses_fused(je, x, jnp.asarray(eA),
                                            jnp.asarray(clsB))
        return parts["loss_entire_ssim"] + parts["loss_entire_cls"], parts

    (_, jparts), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(gE))
    tx = torch.from_numpy(gE).requires_grad_(True)
    tparts = tlosses.entire_losses_fused(te, tx, torch.from_numpy(eA),
                                         torch.from_numpy(clsB))
    (tparts["loss_entire_ssim"] + tparts["loss_entire_cls"]).backward()
    for k in ("loss_entire_ssim", "loss_entire_cls"):
        np.testing.assert_allclose(tparts[k].item(), float(jparts[k]),
                                   rtol=1e-5)
    _check_grads((tx.grad,), (jg,))


def test_keys_self_sim_and_per_crop_mse_sum():
    keys, other = _imgs([(2, 2, 9, 64), (2, 2, 9, 64)], seed=3)
    np.testing.assert_allclose(
        text.keys_self_sim(torch.from_numpy(keys)).numpy(),
        np.asarray(jext.keys_self_sim(jnp.asarray(keys))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        tlosses.per_crop_mse_sum(torch.from_numpy(keys),
                                 torch.from_numpy(other)).item(),
        float(jlosses.per_crop_mse_sum(jnp.asarray(keys),
                                       jnp.asarray(other))), rtol=1e-6)


@pytest.mark.parametrize("every,warmup,ssim", [(75, 1, 1.0), (10, 3, 1.0),
                                               (7, 0, 0.0)])
def test_lambda_schedule_and_entire_steps(every, warmup, ssim):
    kw = dict(entire_A_every=every, cls_warmup=warmup,
              lambda_entire_ssim=ssim)
    jc, tc = JConfig(**kw), TConfig(**kw)
    for step in range(160):
        assert tlosses.lambdas_for_step(tc, step) == \
            jlosses.lambdas_for_step(jc, step)
        assert tlosses.is_entire_step(tc, step) == \
            jlosses.is_entire_step(jc, step)


def test_weighted_total():
    parts = {"loss_global_cls": 0.5, "loss_global_ssim": 2.0,
             "loss_global_id_B": 3.0, "loss_entire_cls": 0.25}
    lam = jlosses.lambdas_for_step(JConfig(), 150)
    assert tlosses.weighted_total(parts, lam) == pytest.approx(
        float(jlosses.weighted_total(parts, lam)))
