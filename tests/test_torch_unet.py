"""splice_tpu_torch.models.unet against splice_tpu.models.unet.

The JAX side is skip_apply_chw(conv_impl="xla"); with two stacks it runs
under jax.vmap, which keeps BatchNorm statistics per stack, as the trainer
does. The torch side runs the same parameters with groups=2. fp32; the
output at rtol 1e-5 with atol 1e-6 (sigmoid outputs in (0, 1)). Parameter
gradients of the 3-scale generator: rtol 1e-4 with atol 1e-4 x the largest
entry. The default 5-scale generator on a 64-px canvas normalises its
deepest BatchNorm over 2x2 pixels per stack, which makes the gradient
ill-conditioned in fp32 itself: each package's fp32 gradient is 6.7e-3
(relative L2) from a float64 evaluation, and they are 2.8e-3 apart; that
case is held to 1e-2 in relative L2 and in max error over max entry.
The JAX side is jitted: eager dispatch of the vmapped generator's gradient
costs three times the compile.

The parameters are the JAX init with the BatchNorm affines and the output
conv's bias perturbed, so a dropped term shows. The other conv biases stay
0: each feeds a BatchNorm, which cancels it, and a bias far above the
conv's output spread (init gain 0.02) makes the single-pass statistics
E[x^2] - m^2 lose most of their digits, in JAX's jitted program as in the
port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from splice_tpu.models import unet as junet
from splice_tpu_torch.config import Config as TConfig
from splice_tpu_torch.config import load_config
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.utils.tree import tree_map

TINY_UNET = dict(channels_down=(8, 8, 16), channels_up=(8, 8, 16),
                 channels_skip=(2, 2, 2))


def _jax_params(cfg_kw, seed):
    p = junet.init_skip_params(jax.random.PRNGKey(seed),
                               junet.SkipConfig(**cfg_kw))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        names = [getattr(k, "key", "") for k in path]
        if names[-2].endswith("bn") or names[-2] == "out_conv":
            if names[-1] in ("scale", "bias"):
                return np.asarray(a) + 0.05 * rng.standard_normal(
                    a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(perturb, p)


def test_default_param_count_and_flat_order():
    cfg = tunet.SkipConfig()
    tree = tunet.init_skip_params(cfg, seed=0, device="cpu")
    assert tunet.param_count(tree) == 1_037_523
    jp = _jax_params({}, 0)
    jflat, _ = ravel_pytree(jp)
    tflat, spec = tunet.flatten_params(tree_map(torch.from_numpy, jp))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tunet.unflatten_params(tflat, spec)
    assert torch.equal(back["scales"][3]["up_conv"]["kernel"],
                       torch.from_numpy(jp["scales"][3]["up_conv"]["kernel"]))


def test_init_is_seeded():
    cfg = tunet.SkipConfig(**TINY_UNET)
    a, _ = tunet.flatten_params(tunet.init_skip_params(cfg, seed=4,
                                                       device="cpu"))
    b, _ = tunet.flatten_params(tunet.init_skip_params(cfg, seed=4,
                                                       device="cpu"))
    c, _ = tunet.flatten_params(tunet.init_skip_params(cfg, seed=5,
                                                       device="cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("cfg_kw,hw,grad_l2", [
    ({}, (64, 64), 1e-2), (dict(TINY_UNET, pad="reflection"), (40, 52), 0)])
def test_two_stacks_output_and_param_grads(cfg_kw, hw, grad_l2):
    jp = _jax_params(cfg_kw, 1)
    x = np.random.default_rng(2).random((2, 1, *hw, 3)).astype(np.float32)
    jcfg, tcfg = junet.SkipConfig(**cfg_kw), tunet.SkipConfig(**cfg_kw)
    out_shape = jax.eval_shape(lambda a: junet.skip_apply_chw(
        jp, jcfg, a, conv_impl="xla"), jnp.asarray(x[0])).shape
    w = np.random.default_rng(3).standard_normal(
        (2, *out_shape)).astype(np.float32)

    def jf(params):
        outs = jax.vmap(lambda xs: junet.skip_apply_chw(
            params, jcfg, xs, conv_impl="xla"))(jnp.asarray(x))
        return jnp.sum(outs * w), outs

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)
    jflat_g, _ = ravel_pytree(jg)

    tflat, spec = tunet.flatten_params(tree_map(torch.from_numpy, jp))
    tflat.requires_grad_(True)
    tout = tunet.skip_apply_chw(tunet.unflatten_params(tflat, spec), tcfg,
                                torch.from_numpy(x.reshape(2, *hw, 3)),
                                groups=2)
    (tout * torch.from_numpy(w.reshape(tout.shape))).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout).reshape(tout.shape),
                               rtol=1e-5, atol=1e-6)
    jflat_g, g = np.asarray(jflat_g), tflat.grad.numpy()
    if grad_l2:
        assert np.linalg.norm(g - jflat_g) <= grad_l2 * np.linalg.norm(jflat_g)
        assert np.abs(g - jflat_g).max() <= grad_l2 * np.abs(jflat_g).max()
    else:
        np.testing.assert_allclose(g, jflat_g, rtol=1e-4,
                                   atol=1e-4 * np.abs(jflat_g).max())


def test_per_stack_batch_norm_differs_from_joint():
    x = torch.randn(4, 3, 5, 6) * torch.tensor([1.0, 1.0, 3.0, 3.0])[
        :, None, None, None]
    p = {"scale": torch.ones(3), "bias": torch.zeros(3)}
    per_stack = tunet.batch_norm_chw(x, p, groups=2)
    assert torch.allclose(per_stack[:2], tunet.batch_norm_chw(x[:2], p),
                          atol=1e-6)
    assert not torch.allclose(per_stack, tunet.batch_norm_chw(x, p),
                              atol=1e-3)


def test_unported_options_raise():
    with pytest.raises(ValueError):       # a key unported by design
        load_config(None, {"compile_cache_dir": "/tmp/cache"})
    with pytest.raises(ValueError):
        TConfig(generator_conv="nhwc").validate()
    with pytest.raises(ValueError):       # a key unported by design
        load_config(None, {"remat_vit": True})
