"""A generator with 9x9 up convs (SkipConfig filter_size_up = 9, a size no
generator default takes): splice_tpu_torch.models.unet.skip_apply_chw
against splice_tpu's, the convs through the kernels' routes (the plain
versions of K3/K4 on the CPU; the reference's Pallas kernels in interpret
mode), with the SAME-border route off and on (both packages'
SAME_BORDER_KERNELS: the 9x9 up convs' weight gradient then takes K7, the
cotangent-tapped form, where _gtap_better says so: the reference's
_dw_gtap_impl at k = 9, the port's conv_dw_gtap_plain on the CPU and
conv_dw_px's cotangent-tapped mode on the card in bf16). fp32, two
BatchNorm stacks. Tolerances as
tests/test_torch_generator_modes.py: output rtol 1e-5, atol 1e-6; flat
gradient rtol 1e-4 with atol 1e-4 x its largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from splice_tpu.models import unet as junet
from splice_tpu.ops import conv_pallas
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.ops import conv as tconv
from splice_tpu_torch.utils.tree import tree_map


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_UNET = dict(channels_down=(8, 8, 16), channels_up=(8, 8, 16),
                 channels_skip=(2, 2, 2), filter_size_up=9)


@pytest.mark.parametrize("mode", ["pallas", "fused"])
def test_generator_with_9x9_up_filters_matches_jax(mode, monkeypatch):
    """skip_apply_chw with filter_size_up = 9 (a 9x9 up conv at every
    scale, the deepest on a 6 x 5 map) against the reference's generator,
    two BatchNorm stacks; both packages' FORCE_FUSED_KERNELS_ON_CPU on, so
    fused routes every BatchNorm consumer through the prologue kernels
    (JAX: the Pallas kernels in interpret mode)."""
    _check_against_jax(mode, monkeypatch)


@pytest.mark.parametrize("mode", ["pallas"])
def test_9x9_generator_on_the_same_route_matches_jax(mode, monkeypatch):
    """The same generator with both packages' SAME_BORDER_KERNELS on: the
    9x9 up convs take the SAME forms, and their weight gradient K7 (the
    cotangent-tapped form) at k = 9 wherever _gtap_better says so (every
    up conv here), as the reference's _dw_impl routes it. pallas only:
    fused adds the prologue to the same K7 sites and costs the reference
    about 40 s of interpret-mode compilation."""
    monkeypatch.setattr(conv_pallas, "SAME_BORDER_KERNELS", True)
    monkeypatch.setattr(tconv, "SAME_BORDER_KERNELS", True)
    gtap = []
    plain = tconv.conv_dw_gtap_plain
    monkeypatch.setattr(tconv, "conv_dw_gtap_plain",
                        lambda x, g, k, *a, **kw: gtap.append(k)
                        or plain(x, g, k, *a, **kw))
    _check_against_jax(mode, monkeypatch)
    assert gtap and set(gtap) == {9}


def _check_against_jax(mode, monkeypatch):
    monkeypatch.setattr(junet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    monkeypatch.setattr(tunet, "FORCE_FUSED_KERNELS_ON_CPU", True)
    jcfg, tcfg = junet.SkipConfig(**TINY_UNET), tunet.SkipConfig(**TINY_UNET)
    p = junet.init_skip_params(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(9)
    p = jax.tree_util.tree_map(np.asarray, p)
    x = rng.random((2, 1, 24, 20, 3)).astype(np.float32)
    w = rng.standard_normal((2, 1, 24, 20, 3)).astype(np.float32)

    def jf(params):
        outs = jax.vmap(lambda xs: junet.skip_apply_chw(
            params, jcfg, xs, conv_impl=mode))(jnp.asarray(x))
        return jnp.sum(outs * w), outs

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(p)
    jflat_g = np.asarray(ravel_pytree(jg)[0])

    tflat, spec = tunet.flatten_params(tree_map(torch.from_numpy, p))
    tflat.requires_grad_(True)
    tout = tunet.skip_apply_chw(tunet.unflatten_params(tflat, spec), tcfg,
                                torch.from_numpy(x.reshape(2, 24, 20, 3)),
                                groups=2, conv_impl=mode)
    (tout * torch.from_numpy(w.reshape(tout.shape))).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout).reshape(tout.shape),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tflat.grad.numpy(), jflat_g, rtol=1e-4,
                               atol=1e-4 * np.abs(jflat_g).max())
