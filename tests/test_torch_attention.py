"""splice_tpu_torch.ops.attention against splice_tpu.ops.attention.

The JAX side runs attention_from_qkv(use_pallas=True): on the CPU that is
the fused-qkv Pallas kernels (_attn_qkv_kernel forward,
_attn_qkv_bwd_kernel backward) in interpret mode. The torch side runs
AttnQKV on CPU tensors, i.e. the plain versions of kernels K1 and K2.
Inputs come from one numpy seed; fp32 throughout. Tolerances: rtol 1e-5 for
the forward, 1e-4 for the gradient, each with an atol of 1e-6 for entries
near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.ops import attention as jattn
from splice_tpu_torch.ops import attention as tattn

D, HEADS, SCALE = 128, 2, 64 ** -0.5


def _inputs(B, N, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    return qkv, g


def _jax(qkv, g, n_valid):
    def f(x):
        return jattn.attention_from_qkv(x, HEADS, SCALE, use_pallas=True,
                                        n_valid=n_valid)
    out, vjp = jax.vjp(f, jnp.asarray(qkv))
    (dqkv,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dqkv)


def _torch(qkv, g, n_valid):
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = tattn.attention_from_qkv(x, HEADS, SCALE, n_valid=n_valid)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("N,n_valid", [(64, 0), (100, 0), (100, 77)])
def test_forward_and_grad_match_pallas_kernels(N, n_valid):
    qkv, g = _inputs(2, N, seed=N + n_valid)
    jo, jd = _jax(qkv, g, n_valid)
    to, td = _torch(qkv, g, n_valid)
    assert jattn.qkv_attention_supported(jnp.asarray(qkv), HEADS)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-6)


def test_masked_keys_get_zero_gradient():
    """Keys and values at or beyond n_valid take no part: their k and v
    cotangents are exactly zero in both packages."""
    qkv, g = _inputs(1, 64, seed=3)
    _, td = _torch(qkv, g, 40)
    _, jd = _jax(qkv, g, 40)
    assert np.all(td[:, 40:, D:] == 0.0)
    assert np.all(jd[:, 40:, D:] == 0.0)


def test_plain_backward_matches_autograd_of_plain_forward():
    """attention_qkv_bwd_plain (K2's plain version) is the derivative of
    attention_qkv_plain (K1's) in fp32."""
    qkv, g = _inputs(2, 33, seed=5)
    x = torch.from_numpy(qkv).double().requires_grad_(True)
    tattn.attention_qkv_plain(x, HEADS, SCALE).backward(
        torch.from_numpy(g).double())
    got = tattn.attention_qkv_bwd_plain(torch.from_numpy(qkv),
                                        torch.from_numpy(g), HEADS, SCALE)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_cpu_tensors_never_reach_the_kernel_wrappers():
    qkv, _ = _inputs(1, 16, seed=1)
    before = tattn.attn_qkv_fwd_cuda.launches
    tattn.attention_from_qkv(torch.from_numpy(qkv), HEADS, SCALE)
    assert tattn.attn_qkv_fwd_cuda.launches == before
    with pytest.raises(ValueError):
        tattn.attn_qkv_fwd_cuda(torch.from_numpy(qkv), HEADS, SCALE)


@pytest.mark.parametrize("N,n_valid,heads", [
    pytest.param(64, 40, HEADS, id="64-40"),
    pytest.param(200, 0, HEADS, id="200-0"),
    pytest.param(65, 0, 16, id="65-0-16heads")])
def test_qkv_attention_bf16_matches_pallas(N, n_valid, heads):
    """bf16, the type the card's tensor-core K1/K2 take: the plain versions
    round where the reference's fused-qkv kernels round (p before the PV
    product, dl before the dq and dk products). Tolerances: 8e-3 x max|ref|
    for the output, 4e-3 x max|ref| for the gradient (two and one bf16
    ulps at the largest value: both sides round fp32 sums taken in another
    order). 16 heads is ViT-L/14's width (D = 1024), at one row past a
    64-row tile."""
    width = heads * 64
    rng = np.random.default_rng(N + n_valid + 1)
    qkv = rng.standard_normal((2, N, 3 * width)).astype(np.float32)
    g = rng.standard_normal((2, N, width)).astype(np.float32)
    jq, jg = (jnp.asarray(t, dtype=jnp.bfloat16) for t in (qkv, g))
    out, vjp = jax.vjp(lambda x: jattn.attention_from_qkv(
        x, heads, SCALE, use_pallas=True, n_valid=n_valid), jq)
    (jd,) = vjp(jg)
    assert jattn.qkv_attention_supported(jq, heads)

    x = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_(True)
    tout = tattn.attention_from_qkv(x, heads, SCALE, n_valid=n_valid)
    tout.backward(torch.from_numpy(g).to(torch.bfloat16))
    for name, t, j, rtol in (("out", tout.detach(), out, 8e-3),
                             ("dqkv", x.grad, jd, 4e-3)):
        assert t.dtype == torch.bfloat16, name
        ref = np.asarray(j.astype(jnp.float32))
        np.testing.assert_allclose(t.float().numpy(), ref, rtol=0,
                                   atol=rtol * np.abs(ref).max(),
                                   err_msg=name)
    if n_valid:   # masked keys and values take no part
        assert np.all(x.grad.float().numpy()[:, n_valid:, width:] == 0.0)


def _view(shape, offset=0):
    """A contiguous bf16 tensor of `shape` starting `offset` elements into
    its storage, as a slice of a larger buffer is."""
    base = torch.zeros(int(np.prod(shape)) + offset, dtype=torch.bfloat16)
    return base[offset:].view(*shape)


@pytest.mark.parametrize("what,view", [
    ("2-byte offset", lambda: _view((2, 16, 3 * D), offset=1)),
    ("8-byte offset", lambda: _view((2, 16, 3 * D), offset=4)),
    ("split heads at a 6-byte offset", lambda: _view((2, 2, 16, 64),
                                                      offset=3)),
])
def test_tma_check_refuses_views_the_tensor_cores_cannot_read(what, view):
    """TMA reads and writes 16-byte aligned tensors; check_tma_operands
    refuses a contiguous tensor at any other address before a launch (the
    wrappers never copy one)."""
    t = view()
    assert t.is_contiguous(), what
    with pytest.raises(ValueError, match="16-byte"):
        tattn.check_tma_operands("attn_qkv_fwd", t)


def test_tma_check_takes_the_paths_tensors():
    """Whole tensors and 16-byte-aligned slices of the layouts the kernels
    take pass: fused qkv, its cotangent, split heads, a batch of qkv."""
    qkv = _view((2, 16, 3 * D))
    batch = _view((3, 16, 3 * D), offset=16 * 3 * D)
    tattn.check_tma_operands("attn_qkv_fwd", qkv, qkv[1:], batch,
                             _view((2, 16, D)), _view((2, 2, 16, 64)))
