"""The split-head attention route at every head width:
splice_tpu_torch.ops.attention.split_attention_supported and
multi_head_attention against splice_tpu.ops.attention.multi_head_attention
(use_pallas=True), which routes by pallas_attention_supported.

At dh = 32 the reference takes _xla_attention and the port
library_attention (on the CPU the reference's XLA math); at every dh % 64
== 0 (64, 128, 192, 256) both take their kernels: the reference's Pallas
K5/K6 (interpret mode on the CPU), the port's AttnSplit (K5/K6, their
plain versions on the CPU; on the card dh = 64 and the chunked wide
forms). Inputs from one numpy seed, fp32. Tolerances: rtol 1e-5 for
outputs and 1e-4 for gradients, each with an atol of 1e-6 (sums of up to
256 products of O(1) values in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.ops import attention as jattn
from splice_tpu_torch.ops import attention as tattn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dh,want", [(32, False), (64, True), (128, True),
                                     (192, True), (16, False), (48, False),
                                     (256, True), (320, True)])
def test_split_attention_supported_by_head_width(dh, want):
    q = torch.zeros(2, 3, 17, dh)
    assert tattn.split_attention_supported(q) is want


@pytest.mark.parametrize("dh", [32, 128])
def test_other_head_widths_take_library_attention(dh, monkeypatch):
    """multi_head_attention sends dh = 32 to library_attention and never to
    the kernels' route (AttnSplit); dh = 128, a multiple of 64, to
    AttnSplit and never to library_attention."""
    calls, split = [], []
    lib, apply = tattn.library_attention, tattn.AttnSplit.apply
    monkeypatch.setattr(tattn, "library_attention",
                        lambda *a, **kw: calls.append(a[0].shape[3])
                        or lib(*a, **kw))
    monkeypatch.setattr(tattn.AttnSplit, "apply",
                        lambda *a: split.append(a[0].shape[3]) or apply(*a))
    q = torch.randn(1, 2, 9, dh)
    out = tattn.multi_head_attention(q, q, q, dh ** -0.5)
    assert out.shape == q.shape
    assert (calls, split) == (([dh], []) if dh % 64 else ([], [dh]))


@pytest.mark.parametrize("dh", [64, 128, 192, 256, 320, 96])
def test_split_shape_takes_every_multiple_of_64(dh):
    """The kernels' shape check takes [B, H, N, dh] at every dh % 64 == 0
    and refuses any other width with ValueError."""
    q = torch.zeros(2, 3, 17, dh)
    if dh % 64:
        with pytest.raises(ValueError):
            tattn._split_shape(q, q, q, 0)
    else:
        assert tattn._split_shape(q, q, q, 5) == (2, 3, 17, dh, 5)


@pytest.mark.parametrize("dh,N,n_valid", [(32, 40, 0), (32, 40, 29),
                                          (128, 64, 0), (128, 64, 50),
                                          (64, 48, 31), (192, 40, 0),
                                          (192, 70, 61), (256, 40, 33)])
def test_multi_head_attention_matches_reference(dh, N, n_valid):
    rng = np.random.default_rng(dh + N + n_valid)
    q, k, v, g = (rng.standard_normal((2, 3, N, dh)).astype(np.float32)
                  for _ in range(4))
    scale = dh ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: jattn.multi_head_attention(
        a, b, c, scale, use_pallas=True, n_valid=n_valid), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    tout = tattn.multi_head_attention(tq, tk, tv, scale, n_valid)
    tout.backward(torch.from_numpy(g))
    rows = slice(None) if not n_valid else slice(0, n_valid)
    np.testing.assert_allclose(tout.detach().numpy()[:, :, rows],
                               np.asarray(out)[:, :, rows], rtol=1e-5,
                               atol=1e-6)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-6, err_msg=f"d{name}")
