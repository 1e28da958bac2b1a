"""Reflection padding at any size: ops.image.reflect_pad against jnp.pad.

The reference pads its reflection convs with jnp.pad(mode="reflect"),
numpy's rule, which takes a pad as large as the map or larger (repeated
reflection; a 1-pixel map repeats its one value). F.pad(mode="reflect")
raises there, so the port pads through reflect_pad. Held here: the helper
against jnp.pad for map sizes 1-4 and pads 1-3, values exactly and the
gradient (its adjoint, index_add) against jax.vjp at 1e-6 x the largest
entry (sums of up to a handful of fp32 terms in another order); the gather
route against F.pad where F.pad works, values bitwise and gradients at
1e-6 x the largest entry; and the inversion tool's full
six-scale net (inversion_skip_config: 7/7/5/5/3/3 filters, reflection) at
48 x 60, where its deepest maps are 2 x 2 and 1 x 1, forward and flat
parameter gradient against the reference's skip_apply at fp32 on the CPU:
values at rtol 1e-4 with atol 1e-5 x the largest value; gradients within
1e-2 x the largest entry. That gradient is ill-conditioned in both
packages: BatchNorms over maps of 1-4 pixels divide by deviations near
zero, and from the port's float64 gradient the reference's fp32 one lies
3.9e-3 x max, the port's NHWC fp32 one 4.9e-3 x max (the two fp32
gradients 2.5e-3 x max apart), so the float64 run is what tells a fault
from rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from splice_tpu.models import unet as junet
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.ops.image import reflect_gather, reflect_pad
from splice_tpu_torch.utils.tree import tree_map


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (six xdist workers
    share the host; tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (H, W, pad): every map size 1-4 against every pad 1-3, W another size
CASES = [(h, h % 4 + 1, p) for h in range(1, 5) for p in range(1, 4)]


@pytest.mark.parametrize("h,w,pad", CASES)
def test_reflect_pad_matches_jnp_pad(h, w, pad):
    x = _rand(h * 10 + w + pad, 2, 3, h, w)
    cot = _rand(pad, 2, 3, h + 2 * pad, w + 2 * pad)
    widths = ((0, 0), (0, 0), (pad, pad), (pad, pad))
    want, vjp = jax.vjp(lambda t: jnp.pad(t, widths, mode="reflect"),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = reflect_pad(xt, pad)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(cot))
    (want_g,) = vjp(jnp.asarray(cot))
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0,
                               atol=1e-6 * np.abs(want_g).max())


F_PAD_CASES = [(2, 1), (4, 3), (5, 2), (9, 3)]


@pytest.mark.parametrize("n,pad", F_PAD_CASES)
def test_gather_equals_f_pad_where_it_works(n, pad):
    """The gather route bitwise equals F.pad's reflection where pad < n,
    so the helper's two routes are one function."""
    x = torch.from_numpy(_rand(n + pad, 2, 3, n, n + 1))
    assert torch.equal(reflect_gather(x, pad),
                       F.pad(x, (pad,) * 4, mode="reflect"))


@pytest.mark.parametrize("n,pad", F_PAD_CASES)
def test_gradient_equals_f_pad_where_it_works(n, pad):
    """The gather route's gradient (index_add) against F.pad's reflection
    gradient where pad < n, at 1e-6 x the largest entry (sums of up to a
    few fp32 terms in another order)."""
    x = torch.from_numpy(_rand(n * pad, 2, 3, n, n + 1))
    cot = torch.from_numpy(_rand(n + 2 * pad, 2, 3, n + 2 * pad,
                                 n + 1 + 2 * pad))
    grads = []
    for fn in (lambda t: reflect_gather(t, pad),
               lambda t: F.pad(t, (pad,) * 4, mode="reflect")):
        xt = x.clone().requires_grad_(True)
        fn(xt).backward(cot)
        grads.append(xt.grad)
    want = grads[1].numpy()
    np.testing.assert_allclose(grads[0].numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def inversion_net():
    """The reference's six-scale inversion net at 48 x 60 (input depth
    32): params, input, cotangent, and its output and flat gradient of
    sum(out * cot)."""
    jcfg = junet.inversion_skip_config(32)
    jp = junet.init_skip_params(jax.random.PRNGKey(5), jcfg)
    x = np.random.default_rng(6).random((1, 48, 60, 32), dtype=np.float32)
    cot = _rand(7, 1, 48, 60, 3)

    def jloss(p):
        out = junet.skip_apply(p, jcfg, jnp.asarray(x))
        return jnp.sum(out * cot), out

    (_, out), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    return jp, x, cot, np.asarray(out), np.asarray(ravel_pytree(jg)[0])


def _port_net(jp, x, cot, layout, dtype):
    """The port's inversion net in `layout` at `dtype`: output and the flat
    gradient of sum(out * cot)."""
    tcfg = tunet.inversion_skip_config(32)
    flat, spec = tunet.flatten_params(tree_map(
        torch.from_numpy, jax.tree.map(np.asarray, jp)))
    flat = flat.to(dtype).requires_grad_(True)
    p = tunet.unflatten_params(flat, spec)
    xt = torch.from_numpy(x).to(dtype)
    out = (tunet.skip_apply(p, tcfg, xt) if layout == "nhwc"
           else tunet.skip_apply_chw(p, tcfg, xt, conv_impl="pallas"))
    (out * torch.from_numpy(cot).to(dtype)).sum().backward()
    return out.detach(), flat.grad


@pytest.mark.parametrize("layout", ["nhwc", "chw"])
def test_full_inversion_net_at_48px(inversion_net, layout):
    """The port's inversion_skip_config net at 48 x 60, where F.pad's
    reflection raised (the 3x3 scales pad maps of 2 x 2 and 1 x 1 by 1, the
    5x5 ones maps of 4 x 4 by 2), in both of the port's layouts (the CHW
    net against the reference's NHWC one, the same function): the fp32
    output [1, 48, 60, 3] against the reference's; the float64 gradient
    against the reference's fp32 one within 1e-2 x its largest entry (the
    reference's own fp32 rounding: 3.9e-3 x max); and the NHWC fp32
    gradient against the reference's within the same (2.5e-3 x max). The
    CHW fp32 gradient is not held: its single-pass BatchNorm statistics
    over 1-pixel maps put it 1.4e-2 (relative L2) from its float64 run,
    which the float64 check holds to the reference."""
    jp, x, cot, want, want_g = inversion_net
    out, grad = _port_net(jp, x, cot, layout, torch.float32)
    assert tuple(out.shape) == (1, 48, 60, 3)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    tol = 1e-2 * np.abs(want_g).max()
    if layout == "nhwc":
        np.testing.assert_allclose(grad.numpy(), want_g, rtol=0, atol=tol)
    _, grad64 = _port_net(jp, x, cot, layout, torch.float64)
    np.testing.assert_allclose(grad64.numpy(), want_g, rtol=0, atol=tol)
