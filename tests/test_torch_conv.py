"""splice_tpu_torch.ops.conv against splice_tpu.ops.conv_pallas.

The JAX side runs conv_valid_chw / pallas_conv_chw: on the CPU that is the
Pallas conv kernel (_make_conv_kernel, also for dx) and the weight-gradient
kernel (_make_dw_kernel) in interpret mode. The torch side runs ConvValidPro
(no prologue) on CPU tensors, i.e. the plain versions of kernels K3 and K4.
fp32 throughout;
tolerances rtol 1e-5 for outputs and 1e-4 for gradients, each with an atol
of 1e-5 for entries near zero (sums of up to 4,420 products of O(1)
values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.ops import conv_pallas
from splice_tpu_torch.ops import conv as tconv

CIN, COUT, H, W = 20, 8, 34, 130


def _inputs(k, seed, pad_border=True):
    rng = np.random.default_rng(seed)
    hp, wp = (H + k - 1, W + k - 1) if pad_border else (H, W)
    x = rng.standard_normal((2, CIN, hp, wp)).astype(np.float32)
    w = (0.2 * rng.standard_normal((k, k, CIN, COUT))).astype(np.float32)
    b = rng.standard_normal((COUT,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("k", [1, 3])
def test_conv_valid_value_dx_dw_match_pallas(k):
    x, w, _ = _inputs(k, seed=k)
    ho, wo = x.shape[2] - k + 1, x.shape[3] - k + 1
    g = np.random.default_rng(10 + k).standard_normal(
        (2, COUT, ho, wo)).astype(np.float32)

    out, vjp = jax.vjp(lambda a, b: conv_pallas.conv_valid_chw(a, b, k),
                       jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tout = tconv.conv_valid_chw(tx, tw)
    tout.backward(torch.from_numpy(g))

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pad", ["zero", "reflection"])
def test_kernel_conv_chw_matches_pallas_conv_chw(pad):
    x, w, b = _inputs(3, seed=7, pad_border=False)
    jout = conv_pallas.pallas_conv_chw(
        jnp.asarray(x), {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
        1, pad)
    tout = tconv.kernel_conv_chw(
        torch.from_numpy(x),
        {"kernel": torch.from_numpy(w), "bias": torch.from_numpy(b)},
        pad=pad)
    assert tout.shape == jout.shape == (2, COUT, H, W)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_plain_dx_dw_match_autograd_of_f_conv2d():
    """The plain dx (the conv on the (k-1)-bordered cotangent with the
    flipped, io-swapped kernel) and dw (K4's plain version) are the
    derivatives of the conv, checked in float64."""
    x, w, _ = _inputs(3, seed=2)
    g = np.random.default_rng(4).standard_normal(
        (2, COUT, H, W)).astype(np.float32)
    tx = torch.from_numpy(x).double().requires_grad_(True)
    tw = torch.from_numpy(w).double().requires_grad_(True)
    torch.nn.functional.conv2d(tx, tw.permute(3, 2, 0, 1)).backward(
        torch.from_numpy(g).double())
    w_flip = torch.flip(torch.from_numpy(w), dims=(0, 1)).transpose(2, 3)
    dx = tconv.conv_valid_plain(torch.from_numpy(g), w_flip, pad=2)
    dw = tconv.conv_dw_plain(torch.from_numpy(x), torch.from_numpy(g), 3)
    np.testing.assert_allclose(dx.numpy(), tx.grad.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), tw.grad.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_bf16_output_dtype_and_fp32_weight_gradient():
    """Like the reference: the conv runs in the input's type and the weight
    gradient comes back in the weight's type (fp32 masters)."""
    x, w, _ = _inputs(3, seed=9)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tconv.conv_valid_chw(tx, tw)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32


def test_cuda_wrappers_refuse_cpu_tensors():
    x, w, _ = _inputs(3, seed=1)
    with pytest.raises(ValueError):
        tconv.conv_valid_cuda(torch.from_numpy(x), torch.from_numpy(w))
    with pytest.raises(ValueError):
        tconv.conv_dw_cuda(torch.from_numpy(x),
                           torch.zeros(2, COUT, H, W), 3)
