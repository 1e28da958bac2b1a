"""CPU emulation of the fp32 attention kernels' split-TF32 products.

csrc/attention.cu's fp32 kernels (K1/K2, K5/K6) multiply on the tensor
cores in TF32: each fp32 operand x splits into hi, x rounded to TF32 as
cvt.rna.tf32.f32 rounds it (the kernels do it in integer operations), and
lo = x - hi, which the tensor cores read as TF32 (its top 19 bits: lo
truncated); a*b is hi_a*lo_b + lo_a*hi_b + hi_a*hi_b, the small terms
first, into fp32 accumulators. The card cannot be asked here, so this
file rounds as the kernels do (hi: the fp32 bit pattern plus 0x1000, the
low 13 bits cleared, ties away from zero; lo: the low 13 bits cleared)
and forms the kernels' contractions with exact TF32 products and fp32
sums: S = Q K^T over d = 64, O = P V over 981 keys, dK = dS^T Q
over 981 queries, one head of ViT-B/8 at the inversion's 981 tokens, q and
k drawn at standard deviations 1 and 3 (logits spread 1 and 9: flat and
peaked softmax rows). Against float64, the split lies within 1e-4 x max
of the attention output and of dK (the gate the card holds the kernels
to, against the plain fp32 version); one TF32 product alone lies outside
it. Measured here: the split 0.9e-6 to 3.3e-6 x max (with lo rounded to
nearest instead, 1.0e-6 to 3.8e-6), plain fp32 products 0.6e-6 to 2.8e-6,
one TF32 product 5.8e-4 to 2.2e-3.
"""
import numpy as np
import pytest
import torch

from splice_tpu_torch.ops import attention as tattn

N, DH, SCALE = 981, 64, 0.125
GATE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (six xdist workers
    share the host; tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 x: round to nearest, ties away from zero,
    keeping 10 mantissa bits (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 x as the tensor cores read a .tf32 operand: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, truncate(x - hi)


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: three TF32 products, each exact in
    fp32 (11 x 11 significant bits), summed in fp32, small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bl + al @ bh + ah @ bh


def mm_one(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 product of the rounded operands."""
    return tf32(a) @ tf32(b)


def attention(q, k, v, g, mm):
    """One head's output and dK with every product through mm; softmax,
    statistics and the division in fp32, as the kernels keep them."""
    s = mm(q, k.T) * SCALE
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    o = mm(e, v) / denom
    p = e / denom
    dp = mm(g, v.T)
    delta = (g * o).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dk = mm(ds.T, q) * SCALE
    return o, dk


def reference(q, k, v, g):
    q, k, v, g = (t.double() for t in (q, k, v, g))
    p = torch.softmax(q @ k.T * SCALE, dim=-1)
    o = p @ v
    ds = p * (g @ v.T - (g * o).sum(dim=-1, keepdim=True))
    return o, ds.T @ q * SCALE


def test_tf32_rounding_is_cvt_rna():
    """Ties round away from zero; below half an ulp of TF32 rounds down;
    truncation drops the low bits."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2),
                      1 + 3 * ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert torch.equal(truncate(x), torch.tensor(
        [1.0, 1.0, -1.0, 1 + ulp, 3.0], dtype=torch.float32))
    hi, lo = split(torch.tensor([1 / 3], dtype=torch.float32))
    # hi + lo keeps at least 21 significant bits of 1/3
    assert abs(float(hi) + float(lo) - 1 / 3) < 2.0 ** -21 / 3


@pytest.mark.parametrize("std", [1.0, 3.0])
def test_split_tf32_meets_the_fp32_gate(std):
    rng = np.random.default_rng(int(std))
    q, k = (torch.from_numpy(std * rng.standard_normal((N, DH)).astype(
        np.float32)) for _ in range(2))
    v, g = (torch.from_numpy(rng.standard_normal((N, DH)).astype(
        np.float32)) for _ in range(2))
    o64, dk64 = reference(q, k, v, g)
    o_max, dk_max = o64.abs().max().item(), dk64.abs().max().item()

    def errs(o, dk):
        return ((o.double() - o64).abs().max().item() / o_max,
                (dk.double() - dk64).abs().max().item() / dk_max)

    split_o, split_dk = errs(*attention(q, k, v, g, mm_split))
    one_o, one_dk = errs(*attention(q, k, v, g, mm_one))
    assert split_o < GATE and split_dk < GATE, (split_o, split_dk)
    assert one_o > GATE and one_dk > GATE, (one_o, one_dk)
    # the plain fp32 version the card compares with lies as close
    plain = tattn.attention_plain(q[None, None], k[None, None],
                                  v[None, None], SCALE)[0, 0]
    assert (plain.double() - o64).abs().max().item() / o_max < GATE


@pytest.mark.parametrize("variant", ["one_term", "no_split", "bare"])
def test_ablation_variants_edit_the_kernel_source(variant):
    """tools/tf32_ablation.py builds its variants by editing
    csrc/attention.cu's text: each edit finds its text there exactly once
    (the split as this file emulates it: plus 0x1000, the low 13 bits
    cleared), so the variants follow the kernels as they stand."""
    from splice_tpu_torch.tools import tf32_ablation
    src = tf32_ablation.variant_source(variant)
    assert "0x1000u) & 0xFFFFE000u" in tf32_ablation._SPLIT
    full = (tf32_ablation._build.CSRC_DIR / "attention.cu").read_text()
    assert src != full
    assert src.count("mma(d[j], a.hi, b[j].hi)") == 1
    assert ("mma(d[j], a.hi, b[j].lo)" in src) == (variant == "no_split")
    assert ("0xFFFFE000u" in src) == (variant == "one_term")
