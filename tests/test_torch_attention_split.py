"""The split-tensor attention route of splice_tpu_torch.ops.attention (K5/K6)
against splice_tpu.ops.attention.

The JAX side runs _pallas_attention: on the CPU the split-tensor Pallas
kernels (_attn_kernel forward, _attn_bwd_kernel backward) in interpret
mode. The torch side runs multi_head_attention on CPU tensors, i.e. the
plain versions of kernels K5 and K6. Inputs come from one numpy seed; fp32
throughout. Tolerances: rtol 1e-5 for outputs and 1e-4 for gradients, each
with an atol of 1e-6 for entries near zero (sums of up to 200 products of
O(1) values, in another order).

The routing test lowers the fused-qkv cap (_QKV_MAX_N_PAD) of both packages
to 32 tokens, so a tiny ViT at 37 tokens takes the split route in both, as
the 480-px loss resolution (2701 and 3601 tokens) does at the real cap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu.models import vit as jvit
from splice_tpu.ops import attention as jattn
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models import weights as tweights
from splice_tpu_torch.ops import attention as tattn

SCALE = 64 ** -0.5
TINY = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, img_size=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("N,n_valid", [(64, 0), (64, 40), (200, 0),
                                       (200, 151)])
def test_split_attention_value_and_grads_match_pallas(N, n_valid):
    rng = np.random.default_rng(N + n_valid)
    q, k, v, g = (rng.standard_normal((2, 2, N, 64)).astype(np.float32)
                  for _ in range(4))
    out, vjp = jax.vjp(lambda a, b, c: jattn._pallas_attention(
        a, b, c, SCALE, n_valid), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    tout = tattn.multi_head_attention(tq, tk, tv, SCALE, n_valid)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-6, err_msg=f"d{name}")
    if n_valid:   # masked keys and values take no part
        assert np.all(tk.grad.numpy()[:, :, n_valid:] == 0.0)
        assert np.all(tv.grad.numpy()[:, :, n_valid:] == 0.0)


@pytest.mark.parametrize("N,n_valid", [(64, 40), (200, 0)])
def test_split_attention_bf16_matches_pallas(N, n_valid):
    """bf16, the type the card's tensor-core K5/K6 take: the plain versions
    round where the reference's kernels round (p before the PV product, dl
    before the dq and dk products). Tolerances: 8e-3 x max|ref| for the
    output, 4e-3 x max|ref| for the gradients (two and one bf16 ulps at the
    largest value: both sides round fp32 sums taken in another order)."""
    rng = np.random.default_rng(N + n_valid + 1)
    q, k, v, g = (rng.standard_normal((2, 2, N, 64)).astype(np.float32)
                  for _ in range(4))
    jq, jk, jv, jg = (jnp.asarray(t, dtype=jnp.bfloat16) for t in (q, k, v, g))
    out, vjp = jax.vjp(lambda a, b, c: jattn._pallas_attention(
        a, b, c, SCALE, n_valid), jq, jk, jv)
    jgrads = vjp(jg)

    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16).requires_grad_(True)
                  for t in (q, k, v))
    tout = tattn.multi_head_attention(tq, tk, tv, SCALE, n_valid)
    tout.backward(torch.from_numpy(g).to(torch.bfloat16))
    pairs = [("out", tout.detach(), out, 8e-3)] + [
        (f"d{name}", t.grad, j, 4e-3) for name, t, j in zip("qkv", (tq, tk, tv),
                                                         jgrads)]
    for name, t, j, rtol in pairs:
        assert t.dtype == torch.bfloat16, name
        ref = np.asarray(j.astype(jnp.float32))
        np.testing.assert_allclose(t.float().numpy(), ref, rtol=0,
                                   atol=rtol * np.abs(ref).max(),
                                   err_msg=name)
    if n_valid:
        assert np.all(tk.grad.float().numpy()[:, :, n_valid:] == 0.0)
        assert np.all(tv.grad.float().numpy()[:, :, n_valid:] == 0.0)


def test_plain_split_backward_matches_autograd_of_plain_forward():
    """attention_bwd_plain (K6's plain version) is the derivative of
    attention_plain (K5's) in fp32."""
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 33, 64))
                                   .astype(np.float32)) for _ in range(4))
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    tattn.attention_plain(*leaves, SCALE, 20).backward(g.double())
    got = tattn.attention_bwd_plain(q, k, v, g, SCALE, 20)
    for a, b in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_routing_predicates_equal_the_reference():
    for N in (1, 37, 785, 2041, 2048, 2049, 2701, 3601, 4096, 4097, 5000):
        for D, heads in ((768, 12), (384, 6), (96, 2)):
            jq = jax.ShapeDtypeStruct((1, N, 3 * D), jnp.float32)
            tq = torch.empty(1, N, 3 * D)
            assert (tattn.qkv_attention_supported(tq, heads)
                    == jattn.qkv_attention_supported(jq, heads)), (N, D)
        for dh in (64, 48):
            js = jax.ShapeDtypeStruct((1, 2, N, dh), jnp.float32)
            assert (tattn.pallas_attention_supported(torch.empty(1, 2, N, dh))
                    == jattn.pallas_attention_supported(js)), (N, dh)


def test_vit_above_the_fused_cap_takes_the_split_route(monkeypatch):
    monkeypatch.setattr(jattn, "_QKV_MAX_N_PAD", 32)
    monkeypatch.setattr(tattn, "_QKV_MAX_N_PAD", 32)
    calls = []
    split = tattn.multi_head_attention
    monkeypatch.setattr(tattn, "multi_head_attention",
                        lambda *a: calls.append(a[0].shape) or split(*a))

    rng = np.random.default_rng(3)
    jcfg, tcfg = jvit.VitConfig(**TINY), tvit.VitConfig(**TINY)
    leaves, tree = jax.tree.flatten(jvit.init_vit_params(
        jax.random.PRNGKey(4), jcfg))
    jp = jax.tree.unflatten(tree, [np.asarray(l) + 0.02 * rng.standard_normal(
        l.shape).astype(np.float32) for l in leaves])
    img = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    taps = {"qkv": (1,), "block": (1,)}
    wq = rng.standard_normal((2, 37, 384)).astype(np.float32)
    wb = rng.standard_normal((2, 37, 128)).astype(np.float32)

    def jf(x):
        out = jvit.vit_forward(jp, x, jcfg, taps, use_pallas=True)
        return (jnp.sum(out["qkv"][1] * wq) + jnp.sum(out["block"][1] * wb),
                out)

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(img))

    ti = torch.from_numpy(img).requires_grad_(True)
    tout = tvit.vit_forward(tweights.vit_params_from_numpy(
        jax.tree.map(np.asarray, jp)), ti, tcfg, taps)
    (torch.sum(tout["qkv"][1] * torch.from_numpy(wq))
     + torch.sum(tout["block"][1] * torch.from_numpy(wb))).backward()

    assert calls == [(2, 2, 37, 64)] * 2          # every block, split route
    for kind in ("qkv", "block"):
        np.testing.assert_allclose(tout[kind][1].detach().numpy(),
                                   np.asarray(jout[kind][1]), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 16, 64)
    before = tattn.attn_fwd_cuda.launches
    tattn.multi_head_attention(q, q, q, SCALE)
    assert tattn.attn_fwd_cuda.launches == before
    with pytest.raises(ValueError):
        tattn.attn_fwd_cuda(q, q, q, SCALE)
    with pytest.raises(ValueError):
        tattn.attn_bwd_cuda(q, q, q, q, SCALE)


@pytest.mark.parametrize("shape,wrong", [
    ((1, 2, 16, 48), None),                    # head dim 48
    ((1, 2, 16, 64), (1, 2, 17, 64)),          # k, v one row longer
    ((1, 2, 16, 64), (1, 3, 16, 64)),          # another head count
])
def test_cuda_wrappers_refuse_other_shapes(shape, wrong):
    """The split kernels take [B, H, N, 64] q, k, v (and g) of one shape;
    the wrappers refuse anything else before they touch a device."""
    q = torch.zeros(shape, dtype=torch.bfloat16)
    kv = torch.zeros(wrong or shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="of one shape"):
        tattn.attn_fwd_cuda(q, kv, kv, SCALE)
    with pytest.raises(ValueError, match="of one shape"):
        tattn.attn_bwd_cuda(q, kv, kv, q, SCALE)
    if wrong is None:
        return
    with pytest.raises(ValueError, match="cotangent"):
        tattn.attn_bwd_cuda(q, q, q, kv, SCALE)
