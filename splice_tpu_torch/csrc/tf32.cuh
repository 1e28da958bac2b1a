// Split TF32 on the tensor cores: the operand split and the products that
// the fp32 kernels of attention.cu (K1/K2, K5/K6) and conv.cu (K3, K4)
// share. Each source includes this file inside its anonymous namespace; it
// includes nothing itself (ops/_build.py hashes it into both libraries'
// names).
//
// Every product is mma.sync m16n8k8 .tf32 with fp32 accumulators, in three
// terms: an fp32 operand x splits into hi = x rounded to TF32 (as
// cvt.rna.tf32.f32) and lo = x - hi (read as TF32: truncated), and a*b
// accumulates as hi_a*lo_b + lo_a*hi_b + hi_a*hi_b, the small terms first.
// One TF32 term keeps about three decimal digits (errors near 1e-3 x max of
// the output); the split keeps the fp32 plain versions' 1e-4 x max with
// about two orders to spare (tests/test_torch_tf32_split.py emulates it).
// Fragments (PTX's m16n8k8 .tf32 layout, g = lane / 4, t = lane % 4): A
// a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B
// b0 (row t, col g), b1 (t + 4, g); C c0, c1 (row g, cols 2t, 2t + 1), c2,
// c3 (row g + 8, the same columns).
namespace tf32 {

// x = hi + lo. hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds a
// finite value (to nearest, ties away from zero: add half a TF32 ulp to
// the bit pattern, clear the 13 bits below), in two integer operations;
// lo = x - hi is exact in fp32 and goes to the tensor cores as it is,
// which read a .tf32 operand's top 19 bits (lo truncated to TF32: an
// error of at most 2^-22 |x|). A NaN in x stays one in lo.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a b[j] for J blocks of 8 columns in split TF32, the small terms
// first (hi*lo, lo*hi, then hi*hi): each term over every j before the
// next, so that the products into one accumulator stand J instructions
// apart.
template <int J>
__device__ __forceinline__ void mma3_cols(float (&d)[J][4], const FragA& a,
                                          const FragB (&b)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.hi, b[j].hi);
}

// d[j] += a b[j] as mma3_cols, the three products first into a zeroed
// fragment, which is then added to d in fp32 (rounded to nearest). The
// tensor cores do not round their fp32 accumulation to nearest (they
// truncate, on the generations measured in public), so a long chain of
// products into one fragment drifts: conv.cu's fp32 kernels with one
// chain over the whole contraction put chip_smoke's 9x9 generator's
// gradient 7.35e-3 x max from float64, against 1e-6 for the CUDA cores'
// fp32. A fresh fragment a step keeps each step's rounding at its own
// magnitude, for 4 J fp32 adds.
template <int J>
__device__ __forceinline__ void mma3_cols_add(float (&d)[J][4],
                                              const FragA& a,
                                              const FragB (&b)[J]) {
  float s[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  mma3_cols<J>(s, a, b);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] += s[j][e];
}

}  // namespace tf32
