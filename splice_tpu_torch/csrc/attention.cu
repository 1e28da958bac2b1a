// Multi-head softmax attention in two layouts (both sets of kernels read
// both through element strides):
//   * fused qkv, head dim 64: q, k and v are column sections of one
//     [B, N, 3D] tensor (heads contiguous inside each section); the output
//     and the cotangent g are the head-concatenated [B, N, D];
//   * split: q, k, v, the output, g and the three gradients are separate
//     [B, H, N, dh] tensors, dh any multiple of 64 (the reference's
//     pallas_attention_supported): dh = 64 on the kernels K1/K2 share;
//     wider heads on the forward's and the backward's wide passes, whose
//     blocks hold the full width (fwd_wide: the q rows resident up to dh =
//     256; bwd_wide: the own rows resident up to dh = 320; streamed above).
//
// K1 attn_qkv_fwd replaces splice_tpu/ops/attention.py _attn_qkv_kernel
// (:361, launched by _attn_qkv_fwd_impl :401). K2 attn_qkv_bwd replaces
// _attn_qkv_bwd_kernel (:447, launched by _attn_qkv_bwd_impl :529).
// K5 attn_fwd replaces _attn_kernel (:103, launched by
// _pallas_attention_fwd_impl :138). K6 attn_bwd replaces _attn_bwd_kernel
// (:191, launched by _pallas_attention_bwd_impl :260).
//
// What is kept from the TPU kernels: the fusion boundary. No logits ever
// reach device memory; the backward needs only q, k, v (no saved
// probabilities or logsumexp) and writes the gradients in the inputs' type:
// one [B, N, 3D] cotangent for K2, three [B, H, N, 64] tensors for K6. K1
// reads its head's q, k and v by column offset out of [B, N, 3D] and writes
// the [B, N, D] output the proj dense consumes. Logits and softmax are fp32,
// keys >= n_valid are masked, the division comes after the PV product, p is
// rounded to the input type before PV (p.astype(v.dtype)) and dl before the
// dq/dk products.
//
// What bounds it on the H100: the work is 4*B*H*N^2*64 flops forward and
// about 2.5x that backward; the traffic is the inputs and outputs once
// (under 20 MB at N = 785, about 90 MB at N = 3601), so the bound is
// arithmetic at every N the model runs: the tensor cores' 989 TFLOP/s for
// bf16; for fp32, three TF32 products at 495 TFLOP/s (an fp32-accurate 165
// TFLOP/s; the CUDA cores' plain fp32 is 67).
//
// Two sets of kernels, routed by dtype in every C entry:
//   * bf16, both layouts (K1/K2 on the 224-px paths, K5/K6 on the 480-px
//     path), runs on the tensor cores (namespace tc): wgmma products from
//     TMA-loaded, 128-byte-swizzled shared-memory tiles, fp32 accumulators
//     and softmax in registers, p and dl rounded to bf16 in registers as
//     the A operand of the next product. The layout is data: a 4-D tensor
//     map per operand with the view's strides, so fused qkv is read in
//     place, with no copy into split heads;
//   * fp32, both layouts, runs on the tensor cores too (namespace tf32):
//     mma.sync m16n8k8 TF32 products in three terms (split TF32, close to
//     fp32: one TF32 product alone would round the operands to 10 mantissa
//     bits) from cp.async-staged shared-memory tiles; p and dl stay fp32
//     and are split like the other operands.
//
// Design, both sets: the forward is flash-style, one block per (q tile,
// head, batch) with an online softmax over key tiles, so any N works (the
// TPU kernels kept a whole head's K/V in VMEM and so capped N; these have
// no cap) and the ragged edge is masked. The TPU backward carried dk/dv in
// scratch across a sequential q grid; GPU blocks run in no order, so the
// backward is three launches (at dh > 64, one statistics pass and a
// dK/dV and dQ pass or more a column block: bwd_wide):
//   1. per (q tile): recompute the forward to get each row's logsumexp and
//      delta = sum_d g*o (= sum_k p*dp; the wide passes sum p*dp), fp32
//      scratch [B, H, N];
//   2. per (k tile): loop over all q tiles, accumulate dk and dv in
//      registers (fp32) and write them once;
//   3. per (q tile): loop over key tiles, accumulate dq.
// Each C entry returns cudaGetLastError() after its launches (or
// cudaErrorInvalidValue when a tensor map cannot be made).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int DH = 64;        // head dim of K1/K2 and of a wide head's chunks

// Element strides of one [B, H, N, 64] operand view: row (b, h, n) starts
// at b*sb + h*sh + n*sr.
struct Strides {
  long long sb, sh, sr;
  __device__ __forceinline__ size_t at(int b, int h, int n) const {
    return (size_t)(b * sb + h * sh + n * sr);
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// q, k, v (and dq, dk, dv) share the layout `in`; the output and g share
// `os`.
template <typename T>
struct Operands {
  const T* q;
  const T* k;
  const T* v;
  Strides in;
  Strides os;
};

// Fused qkv [B, N, 3D]: q, k, v are the sections at column 0, D, 2D.
template <typename T>
Operands<T> fused_operands(const void* qkv, int N, int H) {
  const long long D = (long long)H * DH;
  const T* base = static_cast<const T*>(qkv);
  return {base, base + D, base + 2 * D, {N * 3 * D, DH, 3 * D},
          {N * D, DH, D}};
}

// Split [B, H, N, dh] tensors, all six of one layout.
template <typename T>
Operands<T> split_operands(const void* q, const void* k, const void* v,
                           int N, int H, int dh) {
  const Strides s{(long long)H * N * dh, (long long)N * dh, dh};
  return {static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), s, s};
}

// The wide passes (tc and tf32 below): K6's statistics, dQ, dK and dV
// together, dV alone, dK alone; K5's forward.
enum WidePassKind : int {
  PASS_STATS, PASS_DQ, PASS_DKDV, PASS_DV, PASS_DK, PASS_FWD
};
constexpr int WIDE_SMEM_CAP = 232448 - 1024;   // 227 KB, less a static part

// One launch of a wide pass (tc::Set::pass, tf32::Set::pass): its kernel,
// pass kind (PASS_*), output width W (0 for the statistics) and first
// output box cb (column 64 cb), threads, ring stages, dynamic shared
// memory, the own rows a block and the rows of a streamed tile.
template <typename Fn>
struct WidePass {
  Fn fn;
  int kind, w, cb, threads, stages, smem, rows, keys;
};

// K6's resident form at dh = 64 nk, 2 <= nk <= RESIDENT_MAX_NK, one table
// for both dtypes (the launches in order): pass, output boxes NC (W = 64
// NC), first output box, consumer warpgroups CW (bf16; the fp32 kernels
// have four warps). The header of tc's wide passes says why each.
struct WideSpec {
  int kind, nc, cb, cw;
};
constexpr int RESIDENT_MAX_NK = 5;
constexpr int RESIDENT_PASSES[RESIDENT_MAX_NK - 1] = {3, 4, 4, 6};
constexpr WideSpec RESIDENT_PLAN[RESIDENT_MAX_NK - 1][6] = {
    {{PASS_STATS, 0, 0, 2}, {PASS_DKDV, 2, 0, 1}, {PASS_DQ, 2, 0, 2}},
    {{PASS_STATS, 0, 0, 2}, {PASS_DV, 3, 0, 2}, {PASS_DK, 3, 0, 2},
     {PASS_DQ, 3, 0, 2}},
    {{PASS_STATS, 0, 0, 1}, {PASS_DV, 4, 0, 2}, {PASS_DK, 4, 0, 1},
     {PASS_DQ, 4, 0, 1}},
    // column blocks of 192 (boxes 0-2) and 128 (boxes 3-4)
    {{PASS_STATS, 0, 0, 1}, {PASS_DV, 3, 0, 1}, {PASS_DK, 3, 0, 1},
     {PASS_DKDV, 2, 3, 1}, {PASS_DQ, 3, 0, 1}, {PASS_DQ, 2, 3, 1}}};

template <typename Set, int NK, typename Emit, int... I>
void resident_plan(Emit& emit, std::integer_sequence<int, I...>) {
  constexpr const WideSpec* row = RESIDENT_PLAN[NK - 2];
  (emit(Set::template pass<row[I].kind, NK, row[I].nc, row[I].cw>(
       row[I].cb)), ...);
}
template <typename Set, int NK = 2, typename Emit>
int resident(int nk, Emit& emit) {
  if constexpr (NK > RESIDENT_MAX_NK) {
    return 0;
  } else {
    if (nk != NK) return resident<Set, NK + 1>(nk, emit);
    constexpr int n = RESIDENT_PASSES[NK - 2];
    resident_plan<Set, NK>(emit, std::make_integer_sequence<int, n>());
    return n;
  }
}

// K6's launches at dh = 64 nk > 1, in order, each handed to emit (a
// WidePass): the resident table up to RESIDENT_MAX_NK; above it the
// streamed form (NK = 0): its statistics, then dV, dK and dQ of each of
// ceil(nk / 4) column blocks of 3 or 4 boxes (W 192 or 256). Set::pass<
// KIND, NK, NC, CW>(cb) makes one launch. Returns the number of launches,
// 0 where nk < 2.
template <typename Set, typename Emit>
int wide_plan(int nk, Emit emit) {
  if (nk < 2) return 0;
  if (nk <= RESIDENT_MAX_NK) return resident<Set>(nk, emit);
  emit(Set::template pass<PASS_STATS, 0, 0, 1>(0));
  const int nb = (nk + 3) / 4;
  for (int i = 0, cb = 0; i < nb; ++i) {
    auto block = [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      emit(Set::template pass<PASS_DV, 0, NC, 1>(cb));
      emit(Set::template pass<PASS_DK, 0, NC, 1>(cb));
      emit(Set::template pass<PASS_DQ, 0, NC, 1>(cb));
      cb += NC;
    };
    if (nk / nb + (i < nk % nb) == 3)
      block(std::integral_constant<int, 3>());
    else
      block(std::integral_constant<int, 4>());
  }
  return 1 + 3 * nb;
}

// K5's launches at dh = 64 nk, nk > 1, each handed to emit (a WidePass):
// up to nk = 4 one launch of the resident form (NK = nk, W = dh); above it
// the streamed form (NK = 0) in ceil(nk / 4) column blocks of 2 to 4 boxes
// (W 128 to 256, the first nk % nb blocks one box wider), each computing S
// over the full width. Set::pass<PASS_FWD, NK, NC, CW>(cb) makes one
// launch (CW: bf16's consumer warpgroups). Returns the number of
// launches, 0 where nk < 2.
template <typename Set, typename Emit>
int fwd_plan(int nk, Emit emit) {
  switch (nk) {
    case 2: emit(Set::template pass<PASS_FWD, 2, 2, 2>(0)); return 1;
    case 3: emit(Set::template pass<PASS_FWD, 3, 3, 2>(0)); return 1;
    case 4: emit(Set::template pass<PASS_FWD, 4, 4, 2>(0)); return 1;
    default: break;
  }
  if (nk < 2) return 0;
  const int nb = (nk + 3) / 4;
  for (int i = 0, cb = 0; i < nb; ++i) {
    const int nc = nk / nb + (i < nk % nb);
    if (nc == 2)
      emit(Set::template pass<PASS_FWD, 0, 2, 1>(cb));
    else if (nc == 3)
      emit(Set::template pass<PASS_FWD, 0, 3, 1>(cb));
    else
      emit(Set::template pass<PASS_FWD, 0, 4, 1>(cb));
    cb += nc;
  }
  return nb;
}

// ---------------------------------------------------------------------------
// bf16 attention on the tensor cores: K1 attn_qkv_fwd and K5 attn_fwd, K2
// attn_qkv_bwd and K6 attn_bwd
// ---------------------------------------------------------------------------
// One set of kernels serves both layouts; the layout is data. Each operand
// (q, k, v, g) is read through a 4-D tensor map {64, N, H, B} with the
// byte strides of its view (row, head, batch): {128, 128 N, 128 H N} for a
// split [B, H, N, 64] tensor; {6D, 128, 6ND} for a section of fused qkv
// (its base at column 0, D or 2D); {2D, 128, 2ND} for the [B, N, D]
// cotangent g. Boxes are 64 rows x 128 bytes, 128-byte swizzled, so they
// land in shared memory alike for both layouts; rows past N arrive as
// zeros. The outputs (out; dq, dk, dv) and the statistics pass's read of g
// are plain global accesses through the element strides of Operands.
//
// A block owns 64 rows: one consumer warpgroup (warps 0-3) and one
// producer warp (warp 4) whose lane 0 issues TMA copies. The block's own
// rows of one or two operands are loaded once ("resident"); the rows it
// loops over stream through a two-stage ring guarded by full (TMA bytes
// landed) and empty (every consumer warp done) mbarriers. Two blocks fit
// an SM. Against a 128-row form (two consumer warpgroups, one block per
// SM) this form measured faster or level at every shape of the paths (785
// and 1037 tokens fused, 3601 and 2701 split; PERF.md, §6).
namespace tc {

constexpr int ROWS = 64;               // rows of a box and of a block
constexpr int BOX = ROWS * DH * 2;     // bytes of one box
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 160;
constexpr int PRODUCER_WARP = 4;
// ptxas caps registers at 168 so that two blocks fit an SM (three warps of
// the two blocks share one of the SM's four 16K-register quarters)
constexpr int MIN_BLOCKS = 2;
// dynamic shared memory, plus 1 KB to align. Forward: the resident q box,
// two stages of 128 keys (2 K boxes, 2 V boxes). Backward: 2 resident
// boxes, two stages of one box of each streamed operand.
constexpr int FWD_SMEM = 9 * BOX + 1024;
constexpr int BWD_SMEM = 6 * BOX + 1024;

struct Maps {
  CUtensorMap q, k, v, g;
};


__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Rows [row, row + 64) of head h of batch b of `map`, columns [col, col +
// 64), into the box at dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int h,
                                         int b, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// wgmma descriptor of a tile of 128-byte rows as TMA's 128-byte swizzle
// leaves it (8-row groups 1024 bytes apart, tile 1024-byte aligned). Read
// K-major, a k16 step advances it by 32 bytes (+2); read MN-major (trans-b),
// by 16 rows (+128). Both byte offsets are 1024: K-major reads neither of
// them but SBO, and an MN-major B of 64 columns (one swizzle atom) reads
// only the one between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return ((smem_addr(tile) & 0x3FFFFu) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accesses of a wgmma accumulator across
// the asynchronous product's issue and wait.
template <int n>
__device__ __forceinline__ void pin(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
// (descriptors a, b); acc = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
// (descriptors a, b); acc = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared
// memory (descriptor b, trans-b set).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A wgmma accumulator of a 64 x (4 * n) tile: thread (warp w, lane l) of the
// warpgroup holds row 16w + l/4 in d[4j], d[4j+1] and that row + 8 in
// d[4j+2], d[4j+3], at columns 8j + 2(l%4) and + 1. Rounded to bf16 and
// sliced by 16 columns, it is the register A operand of the next product
// (the layout of mma.sync's A fragment, per warp).
template <int n>
__device__ __forceinline__ void to_a(const float (&d)[n],
                                     uint32_t (&a)[n / 8][4]) {
#pragma unroll
  for (int t = 0; t < n / 8; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[t][i] = pack_bf16(d[8 * t + 2 * i], d[8 * t + 2 * i + 1]);
  }
}

// A consumer thread's place: it holds rows r and r + 8 of the block's
// 64-row tile and, in each 8-column block j, the columns 8j + c and
// 8j + c + 1.
struct Place {
  int r, c, lane;
};
__device__ __forceinline__ Place place() {
  const int lane = threadIdx.x & 31;
  return {16 * (threadIdx.x >> 5) + (lane >> 2), 2 * (lane & 3), lane};
}

// Rows row0 + r and row0 + r + 8 of a 64 x (m / 2) accumulator times mul,
// as bf16, into the rows below n of `out` (one head's rows, `stride`
// elements apart).
template <int m>
__device__ __forceinline__ void store_rows(const float (&d)[m],
                                           __nv_bfloat16* out,
                                           long long stride, int row0,
                                           const Place& p, int n, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + p.r + 8 * h;
    if (row >= n) continue;
    uint32_t* o = reinterpret_cast<uint32_t*>(out + row * stride + p.c);
#pragma unroll
    for (int j = 0; j < m / 4; ++j)
      o[4 * j] = pack_bf16(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
  }
}

// bars: resident, full[2], empty[2] (one arrival per consumer warp: `warps`
// of them). Returns the 1024-aligned dynamic shared memory.
__device__ __forceinline__ uint8_t* setup(uint8_t* raw, uint64_t* bars,
                                          int warps = 4) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    mbar_init(&bars[3], warps);
    mbar_init(&bars[4], warps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// The producer (one thread): rows [row0, row0 + 64) of ra (and rb) into
// res once; then, for i < n, `boxes` boxes of rows from i * boxes * 64 of
// sa and of sb into ring stage i % 2, once its previous tile is released.
// All of head h of batch b.
__device__ __forceinline__ void produce(
    const CUtensorMap* ra, const CUtensorMap* rb, uint8_t* res, int row0,
    const CUtensorMap* sa, const CUtensorMap* sb, uint8_t* ring, int boxes,
    int n, int h, int b, uint64_t* bars) {
  mbar_arrive_tx(&bars[0], (rb ? 2 : 1) * BOX);
  tma_load(res, ra, &bars[0], row0, h, b);
  if (rb) tma_load(res + BOX, rb, &bars[0], row0, h, b);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    if (i >= 2) mbar_wait(&bars[3 + s], ((i >> 1) - 1) & 1);
    uint8_t* st = ring + s * 2 * boxes * BOX;
    mbar_arrive_tx(&bars[1 + s], 2 * boxes * BOX);
    for (int j = 0; j < boxes; ++j) {
      const int row = (i * boxes + j) * ROWS;
      tma_load(st + j * BOX, sa, &bars[1 + s], row, h, b);
      tma_load(st + (boxes + j) * BOX, sb, &bars[1 + s], row, h, b);
    }
  }
}

// Forward (STATS = false): out = softmax(q k^T * scale) v for 64 q rows,
// over key tiles of 128 (S on m64n128k16, P V on m64n64k16 with P from
// registers), online softmax in the log2 domain. STATS = true (the
// backward's first pass): lse (natural log) and delta = g . o per row
// instead of out; g is read from global memory. out and g: strides os.
template <bool STATS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_fwd_kernel_tc(const __grid_constant__ Maps maps, Strides os,
                   const __nv_bfloat16* __restrict__ g,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ delta, int N, int H, int valid,
                   float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[5];
  uint8_t* sm = setup(smem_raw, bars);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int n_kt = (valid + 2 * ROWS - 1) / (2 * ROWS);
  if (threadIdx.x / 32 == PRODUCER_WARP) {
    if (threadIdx.x % 32 == 0)
      produce(&maps.q, nullptr, sm, q0, &maps.k, &maps.v, sm + BOX, 2, n_kt,
              h, b, bars);
    return;
  }
  const Place p = place();
  const float sl = scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint64_t dq = sw128_desc(sm);
  mbar_wait(&bars[0], 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1;
    const uint8_t* st = sm + (1 + 4 * s) * BOX;   // K: 2 boxes, then V: 2
    mbar_wait(&bars[1 + s], (kt >> 1) & 1);
    float sc[64];
    const uint64_t dk = sw128_desc(st);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss128(sc, dq + 2 * kk, dk + 2 * kk, kk);
    wg_commit();
    wg_wait();
    pin(sc);

    // keys >= valid get -inf (TMA's zero rows would give logit 0); every
    // tile holds a valid key, so each row's max is finite
    const int k0 = kt * 2 * ROWS;
    if (k0 + 2 * ROWS > valid) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (k0 + 8 * (i / 4) + p.c + (i & 1) >= valid) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mn = fmaxf(m[e], quad_max(mx[e]) * sl);
      alpha[e] = ex2(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int e = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], sl, -m[e]));
      l[e] += sc[i];   // this thread's part of the row sum, unrounded p
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[8][4];
    to_a(sc, pa);      // p rounded to bf16 before P V
    const uint64_t dv = sw128_desc(st + 2 * BOX);
    pin(o);
    wg_fence();
#pragma unroll
    for (int t = 0; t < 8; ++t) wgmma_rs64(o, pa[t], dv + 128 * t);
    wg_commit();
    wg_wait();
    pin(o);
    if (p.lane == 0) mbar_arrive(&bars[3 + s]);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = quad_sum(l[e]);
  if (!STATS) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = o[i] / l[(i >> 1) & 1];
    store_rows(o, out + os.at(b, h, 0), os.sr, q0, p, N, 1.f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + p.r + 8 * e;
    float part = 0.f;
    if (row < N) {
      const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(
          g + os.at(b, h, row) + p.c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 gv = __bfloat1622float2(gr[4 * j]);
        part += gv.x * (o[4 * j + 2 * e] / l[e]) +
                gv.y * (o[4 * j + 2 * e + 1] / l[e]);
      }
    }
    part = quad_sum(part);   // all lanes take part in the shuffle
    if (row < N && (p.lane & 3) == 0) {
      const size_t idx = ((size_t)b * H + h) * N + row;
      lse[idx] = (m[e] + log2f(l[e])) / LOG2E;
      delta[idx] = part;
    }
  }
}

// Backward, dk and dv for 64 keys, looping over q tiles of 64: per tile
// S^T = K Q^T and dP^T = V g^T (m64n64k16, both operands in shared
// memory), P^T = exp(S^T scale - lse), dL^T = P^T (dP^T - delta), then
// dV += bf16(P^T) g and dK += bf16(dL^T) Q with g and Q read MN-major.
// dk and dv: strides in.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_bwd_dkdv_tc_kernel(const __grid_constant__ Maps maps, Strides in,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk_out,
                        __nv_bfloat16* __restrict__ dv_out, int N, int H,
                        int valid, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[5];
  uint8_t* sm = setup(smem_raw, bars);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  // key tiles past n_valid: no loop, exactly zero dk and dv
  const int n_qt = k0 < valid ? (N + ROWS - 1) / ROWS : 0;
  if (threadIdx.x / 32 == PRODUCER_WARP) {
    if (threadIdx.x % 32 == 0 && n_qt)
      produce(&maps.k, &maps.v, sm, k0, &maps.q, &maps.g, sm + 2 * BOX, 1,
              n_qt, h, b, bars);
    return;
  }
  const Place p = place();
  const float sl = scale * LOG2E;
  const int kr = k0 + p.r;   // this thread's keys kr, kr + 8
  const bool key_ok[2] = {kr < valid, kr + 8 < valid};
  const float* lse_bh = lse + ((size_t)b * H + h) * N;
  const float* del_bh = delta + ((size_t)b * H + h) * N;
  const uint64_t dkd = sw128_desc(sm), dvd = sw128_desc(sm + BOX);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  if (n_qt) mbar_wait(&bars[0], 0);

  for (int qt = 0; qt < n_qt; ++qt) {
    const int s = qt & 1;
    const uint8_t* st = sm + (2 + 2 * s) * BOX;   // Q box, then g box
    mbar_wait(&bars[1 + s], (qt >> 1) & 1);
    const uint64_t dqd = sw128_desc(st), dgd = sw128_desc(st + BOX);
    float sc[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss64(sc, dkd + 2 * kk, dqd + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss64(dp, dvd + 2 * kk, dgd + 2 * kk, kk);
    wg_commit();
    // the columns' statistics, loaded while the products run
    const int qc = qt * ROWS + p.c;
    float L[16], D[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = qc + 8 * (i / 2) + (i & 1);
      L[i] = q < N ? lse_bh[q] * LOG2E : 0.f;
      D[i] = q < N ? del_bh[q] : 0.f;
    }
    wg_wait();
    pin(sc);
    pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = i / 4, e = i & 1, r = (i >> 1) & 1;
      const bool ok = key_ok[r] && qc + 8 * j + e < N;
      const float pr = ok ? ex2(fmaf(sc[i], sl, -L[2 * j + e])) : 0.f;
      dp[i] = pr * (dp[i] - D[2 * j + e]);
      sc[i] = pr;
    }
    uint32_t pa[4][4], da[4][4];
    to_a(sc, pa);
    to_a(dp, da);
    pin(dv);
    pin(dk);
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) wgmma_rs64(dv, pa[t], dgd + 128 * t);
#pragma unroll
    for (int t = 0; t < 4; ++t) wgmma_rs64(dk, da[t], dqd + 128 * t);
    wg_commit();
    wg_wait();
    pin(dv);
    pin(dk);
    if (p.lane == 0) mbar_arrive(&bars[3 + s]);
  }
  store_rows(dk, dk_out + in.at(b, h, 0), in.sr, k0, p, N, scale);
  store_rows(dv, dv_out + in.at(b, h, 0), in.sr, k0, p, N, 1.f);
}

// Backward, dq for 64 q rows, looping over key tiles of 64: S = Q K^T
// and dP = g V^T, dL = P (dP - delta), dQ += bf16(dL) K with K read
// MN-major. A pass of its own, so no atomics: K2 and K6 repeat bitwise.
// dq: strides in.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_bwd_dq_tc_kernel(const __grid_constant__ Maps maps, Strides in,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq_out, int N, int H,
                      int valid, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[5];
  uint8_t* sm = setup(smem_raw, bars);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int n_kt = (valid + ROWS - 1) / ROWS;
  if (threadIdx.x / 32 == PRODUCER_WARP) {
    if (threadIdx.x % 32 == 0)
      produce(&maps.q, &maps.g, sm, q0, &maps.k, &maps.v, sm + 2 * BOX, 1,
              n_kt, h, b, bars);
    return;
  }
  const Place p = place();
  const float sl = scale * LOG2E;
  const int qr = q0 + p.r;   // this thread's rows qr, qr + 8
  bool q_ok[2];
  float L[2], D[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    q_ok[e] = qr + 8 * e < N;
    const size_t idx = ((size_t)b * H + h) * N + (q_ok[e] ? qr + 8 * e : 0);
    L[e] = lse[idx] * LOG2E;
    D[e] = delta[idx];
  }
  const uint64_t dqd = sw128_desc(sm), dgd = sw128_desc(sm + BOX);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1;
    const uint8_t* st = sm + (2 + 2 * s) * BOX;   // K box, then V box
    mbar_wait(&bars[1 + s], (kt >> 1) & 1);
    const uint64_t dkd = sw128_desc(st), dvd = sw128_desc(st + BOX);
    float sc[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss64(sc, dqd + 2 * kk, dkd + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss64(dp, dgd + 2 * kk, dvd + 2 * kk, kk);
    wg_commit();
    wg_wait();
    pin(sc);
    pin(dp);
    const int kc = kt * ROWS + p.c;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      const bool ok = q_ok[e] && kc + 8 * (i / 4) + (i & 1) < valid;
      const float pr = ok ? ex2(fmaf(sc[i], sl, -L[e])) : 0.f;
      dp[i] = pr * (dp[i] - D[e]);
    }
    uint32_t da[4][4];
    to_a(dp, da);
    pin(dq);
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) wgmma_rs64(dq, da[t], dkd + 128 * t);
    wg_commit();
    wg_wait();
    pin(dq);
    if (p.lane == 0) mbar_arrive(&bars[3 + s]);
  }
  store_rows(dq, dq_out + in.at(b, h, 0), in.sr, q0, p, N, scale);
}

// ---------------------------------------------------------------------------
// The wide kernels' ring of `stages` stages (up to RING_MAX) guarded by
// bars[1 + s] (full: the TMA bytes landed) and bars[1 + stages + s]
// (empty: every consumer warp done); bars[0] guards the resident rows.
constexpr int RING_MAX = 4;
__device__ __forceinline__ uint8_t* setup_ring(uint8_t* raw, uint64_t* bars,
                                               int warps, int stages) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + stages + s], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}
// The producer's side: waits until item i's stage (i % stages) is free
// (item i - stages released), arms its full barrier for `bytes`, returns
// the stage and its barrier.
__device__ __forceinline__ uint8_t* ring_put(uint8_t* ring, int stage,
                                             uint64_t* bars, int i,
                                             uint32_t bytes, uint64_t** bar,
                                             int stages = 2) {
  const int s = i % stages, n = i / stages;
  if (n > 0) mbar_wait(&bars[1 + stages + s], (n - 1) & 1);
  mbar_arrive_tx(&bars[1 + s], bytes);
  *bar = &bars[1 + s];
  return ring + s * stage;
}
// The consumers' side: item i's stage once its bytes have landed.
__device__ __forceinline__ const uint8_t* ring_get(const uint8_t* ring,
                                                   int stage, uint64_t* bars,
                                                   int i, int stages = 2) {
  mbar_wait(&bars[1 + i % stages], (i / stages) & 1);
  return ring + (i % stages) * stage;
}
// Item i's stage is free (each consumer warp arrives once).
__device__ __forceinline__ void ring_release(uint64_t* bars, int i,
                                             int lane, int stages = 2) {
  if (lane == 0) mbar_arrive(&bars[1 + stages + i % stages]);
}

// ---------------------------------------------------------------------------
// K6 at head widths dh = 64 nk, nk > 1: the three passes of the dh = 64
// backward, each block over the full width, so S and dP are computed once
// per (q tile, key tile) of a column block. A block of the dK/dV and dQ
// passes owns W = 64 NC output columns (NC boxes): one column block a
// head up to dh = 256, else ceil(nk / 4) of 128 to 256 columns (wgmma's N
// stops at 256).
//   1. statistics, a block per q tile over the key tiles: lse and delta =
//      sum_k p dp (p in fp32 and dP = g V^T: the plain version's sum of
//      p * dp) by an online softmax over the full width, [B, H, N] each;
//      no output accumulator, so its registers do not grow with dh;
//   2. dK and dV, a block per key tile over the q tiles: S^T = K Q^T and
//      dP^T = V g^T, then dV += P^T g and dK += dL^T Q, each one m64nWk16
//      product a k16 step (g and Q read MN-major across the NC boxes);
//      both in one pass at W = 128 (two [64, 128] fp32 accumulators),
//      apart (PASS_DV, PASS_DK) where both accumulators do not fit;
//   3. dQ, a block per q tile over the key tiles: S and dP, then dQ +=
//      dL K as m64nWk16.
// Two forms, the same math (wide_plan above picks by nk):
//   * resident (template NK = nk, up to RESIDENT_MAX_NK = 5): a block's
//     own rows (K and V, or Q and g: NK boxes of each) are loaded once;
//     the other operand pair's full-width tiles of 64 rows stream through
//     a ring of `stages` (two, one where two do not fit) fed by a
//     producer. A tile's contraction over dh (S, dP: 4 NK k16 steps each)
//     is one commit group, waited on once. A block has CW consumer
//     warpgroups of 64 rows each: two where the shared memory holds their
//     resident rows and two stages and whose registers fit 240 a thread
//     (then three warpgroups: the producer's gives its registers to the
//     consumers by setmaxnreg, 24 and 240 a thread), else one (and a
//     producer warp: up to 255 registers a thread); one block an SM
//     either way. W, CW and stages by dh (RESIDENT_PLAN; chip_smoke's
//     phase 2 prints them from attn_bwd_plan, with the blocks an SM the
//     runtime reports):
//       dh 128: W 128; statistics CW 2, dK+dV CW 1 (at 240 registers its
//               two [64, 128] accumulators beside S^T and dP^T spilled),
//               dQ CW 2; 2 stages;
//       dh 192: W 192; statistics, dV, dK, dQ: CW 2, 2 stages;
//       dh 256: W 256; statistics CW 1, dV CW 2, dK CW 1, dQ CW 1; 2
//               stages;
//       dh 320: W 192 and 128; CW 1; 1 stage (dV at W 192: 2);
//   * streamed (template NK = 0, any nk above; the resident rows of two
//     operands, 16 nk KB, outgrow the shared memory beside a stage from nk
//     = 8): nothing is resident. For each tile, the head's nk 64-column
//     boxes stream as items of (the block's own rows' box, the tile's box)
//     of each product, then one item of the output product's operand: the
//     tile's NC boxes of the block's columns. Each box's k16 steps of S
//     and dP are a commit group, with one group left in flight, so the
//     contraction waits only for its last box. CW 1, STREAM_STAGES items
//     of 32 KB in the ring; W 192 or 256; dV and dK apart. The own rows
//     are read once per tile (from L2), so its traffic is about twice the
//     resident form's.
constexpr int STREAM_ITEM = 4 * BOX;
constexpr int STREAM_STAGES = 4;
__host__ __device__ constexpr int wide_threads(int cw) {
  return 128 * cw + (cw == 2 ? 128 : 32);
}

template <int n>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(n));
}
template <int n>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(n));
}

// A consumer thread's place in its warpgroup's 64-row tile (as place()).
__device__ __forceinline__ Place wplace() {
  const int lane = threadIdx.x & 31;
  return {16 * (int)((threadIdx.x >> 5) & 3) + (lane >> 2), 2 * (lane & 3),
          lane};
}

// wgmma descriptor of a B operand read MN-major across adjacent boxes
// (the N = 64 NC columns of a tile's boxes cb..cb + NC - 1): the 128-byte
// swizzle atom holds 64 columns, the atoms `lbo` bytes apart (the leading
// byte offset: one box, or R boxes where a 64-column chunk holds R boxes
// of rows), 8-row groups 1024 apart (the stride byte offset). A k16 step
// advances it by 16 rows (+128).
__device__ __forceinline__ uint64_t mn_desc(const void* tile, int lbo = BOX) {
  return ((smem_addr(tile) & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared
// memory (descriptor b from mn_desc), N = 128, 192, 256.
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs192(float (&d)[96],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs256(float (&d)[128],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <int NC>
__device__ __forceinline__ void wgmma_rsw(float (&d)[32 * NC],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  if constexpr (NC == 2) {
    wgmma_rs128(d, a, b);
  } else if constexpr (NC == 3) {
    wgmma_rs192(d, a, b);
  } else {
    static_assert(NC == 4, "wgmma's N is at most 256");
    wgmma_rs256(d, a, b);
  }
}

// x (+)= A B^T over NK boxes of A from a (BOX apart) against NK
// 64-column chunks of B from b, each chunk R boxes of 64 rows (64 R rows
// of B: x is [64, 64 R]), both K-major, four k16 steps a chunk; unless
// acc, the first step overwrites x. Issued, not committed.
template <int NK, int R = 1>
__device__ __forceinline__ void wide_ss(float (&x)[32 * R], const uint8_t* a,
                                        const uint8_t* b, int acc = 0) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const uint64_t da = sw128_desc(a + j * BOX);
    const uint64_t db = sw128_desc(b + j * R * BOX);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (R == 1)
        wgmma_ss64(x, da + 2 * kk, db + 2 * kk, acc || j > 0 || kk > 0);
      else
        wgmma_ss128(x, da + 2 * kk, db + 2 * kk, acc || j > 0 || kk > 0);
    }
  }
}

// Waits until at most one committed group is in flight.
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// d += A B over a 64-row tile: A's four k16 slices in registers, B the NC
// boxes from box0 read MN-major. Issued, not committed.
template <int NC>
__device__ __forceinline__ void wide_rs(float (&d)[32 * NC],
                                        const uint32_t (&a)[4][4],
                                        const uint8_t* box0) {
  const uint64_t bd = mn_desc(box0);
#pragma unroll
  for (int t = 0; t < 4; ++t) wgmma_rsw<NC>(d, a[t], bd + 128 * t);
}

// The resident form's producer (one thread): the NK boxes of the resident
// operands ra (and rb) for each of the block's CW 64-row tiles from row
// row0, into res in (operand, tile, box) order, once; then n tiles of 64 R
// rows of the streamed operands sa and sb at full width, tile i into ring
// stage i % stages as (sa's NK chunks, sb's NK chunks), a chunk the R
// boxes of its 64 columns in row order.
template <int NK, int CW, int R = 1>
__device__ __forceinline__ void produce_wide(
    const CUtensorMap* ra, const CUtensorMap* rb, uint8_t* res, int row0,
    const CUtensorMap* sa, const CUtensorMap* sb, uint8_t* ring, int n,
    int stages, int h, int b, uint64_t* bars) {
  mbar_arrive_tx(&bars[0], (rb ? 2 : 1) * CW * NK * BOX);
  for (int w = 0; w < CW; ++w)
    for (int j = 0; j < NK; ++j) {
      tma_load(res + (w * NK + j) * BOX, ra, &bars[0], row0 + ROWS * w, h, b,
               64 * j);
      if (rb)
        tma_load(res + ((CW + w) * NK + j) * BOX, rb, &bars[0],
                 row0 + ROWS * w, h, b, 64 * j);
    }
  for (int i = 0; i < n; ++i) {
    uint64_t* bar;
    uint8_t* st = ring_put(ring, 2 * NK * R * BOX, bars, i, 2 * NK * R * BOX,
                           &bar, stages);
    for (int j = 0; j < NK; ++j)
      for (int r = 0; r < R; ++r) {
        const int row = (i * R + r) * ROWS;
        tma_load(st + (j * R + r) * BOX, sa, bar, row, h, b, 64 * j);
        tma_load(st + ((NK + j) * R + r) * BOX, sb, bar, row, h, b, 64 * j);
      }
  }
}

// The streamed form's producer (one thread): for each of n tiles of 64 rows
// of sa (and sb), the head's nk boxes as items of (ra's box of the block's
// rows from row0, sa's box of the tile[, rb's, sb's]); then, where `so`,
// an item of so's tile's nc boxes from column 64 cb.
__device__ __forceinline__ void produce_stream(
    const CUtensorMap* ra, const CUtensorMap* sa, const CUtensorMap* rb,
    const CUtensorMap* sb, const CUtensorMap* so, int row0, int cb, int nc,
    uint8_t* ring, int n, int nk, int stages, int h, int b, uint64_t* bars) {
  uint64_t* bar;
  for (int i = 0, it = 0; i < n; ++i) {
    for (int j = 0; j < nk; ++j) {
      uint8_t* st = ring_put(ring, STREAM_ITEM, bars, it++,
                             (rb ? 4 : 2) * BOX, &bar, stages);
      tma_load(st, ra, bar, row0, h, b, 64 * j);
      tma_load(st + BOX, sa, bar, i * ROWS, h, b, 64 * j);
      if (rb) {
        tma_load(st + 2 * BOX, rb, bar, row0, h, b, 64 * j);
        tma_load(st + 3 * BOX, sb, bar, i * ROWS, h, b, 64 * j);
      }
    }
    if (!so) continue;
    uint8_t* st = ring_put(ring, STREAM_ITEM, bars, it++, nc * BOX, &bar,
                           stages);
    for (int c = 0; c < nc; ++c)
      tma_load(st + c * BOX, so, bar, i * ROWS, h, b, 64 * (cb + c));
  }
}

// One tile's contraction over the head: x = A B^T and, where TWO, y = C
// D^T, waited on. Resident form (NK > 0): A and C the resident boxes at ra
// and rc, B and D the stage of item `it` (NK boxes each), one commit
// group. Streamed form (NK = 0): nk items from `it`, each released once
// its products are done; then, where OUT, the output item. Returns with
// item `it` held (acquired, not released): the stage (resident), the
// output item (OUT) or the last box's item.
template <int NK, bool TWO, bool OUT>
__device__ __forceinline__ const uint8_t* contract(
    float (&x)[32], float (&y)[32], const uint8_t* ra, const uint8_t* rc,
    const uint8_t* ring, uint64_t* bars, int& it, int nk, int stages,
    int lane) {
  if constexpr (NK > 0) {
    const uint8_t* st = ring_get(ring, 2 * NK * BOX, bars, it, stages);
    wg_fence();
    wide_ss<NK>(x, ra, st);
    if constexpr (TWO) wide_ss<NK>(y, rc, st + NK * BOX);
    wg_commit();
    wg_wait();
    pin(x);
    if constexpr (TWO) pin(y);
    return st;
  } else {
    // the first box overwrites x and y (peeled, so that every product's
    // accumulate flag is known to the compiler: a run-time flag made ptxas
    // serialise the products)
    const uint8_t* st = ring_get(ring, STREAM_ITEM, bars, it, stages);
    wg_fence();
    wide_ss<1>(x, st, st + BOX);
    if constexpr (TWO) wide_ss<1>(y, st + 2 * BOX, st + 3 * BOX);
    wg_commit();
    for (int j = 1; j < nk; ++j) {
      st = ring_get(ring, STREAM_ITEM, bars, ++it, stages);
      wg_fence();
      wide_ss<1>(x, st, st + BOX, 1);
      if constexpr (TWO) wide_ss<1>(y, st + 2 * BOX, st + 3 * BOX, 1);
      wg_commit();
      wg_wait1();
      ring_release(bars, it - 1, lane, stages);
    }
    wg_wait();
    pin(x);
    if constexpr (TWO) pin(y);
    if constexpr (!OUT) {
      return st;
    } else {
      ring_release(bars, it, lane, stages);
      return ring_get(ring, STREAM_ITEM, bars, ++it, stages);
    }
  }
}

// The dK/dV pass's copy of a q tile's lse (times log2 e) and delta, per
// consumer warpgroup and tile parity: 2 x 64 floats.
constexpr int STAT_BYTES = 2 * ROWS * 4;

// Waits until the 128 threads of consumer warpgroup wg reach it (named
// barrier 1 + wg; barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
}

// The wide passes share one signature (launched through WidePass): out0
// is dQ (PASS_DQ) or dK, out1 dV; cb the first output box (column 64 cb);
// nk the head's boxes (dh / 64).
#define WIDE_TC_ARGS                                                        \
  const __grid_constant__ Maps maps, Strides in, float *__restrict__ lse, \
      float *__restrict__ delta, __nv_bfloat16 *__restrict__ out0,        \
      __nv_bfloat16 *__restrict__ out1, int N, int H, int valid,          \
      float scale, int cb, int nk, int stages

// Pass 1: lse and delta for CW 64-row q tiles (Q and g the own rows), over
// key tiles of 64 (K and V streamed).
template <int NK, int CW>
__global__ void __launch_bounds__(128 * CW + (CW == 2 ? 128 : 32), 1)
attn_bwd_wide_stats_tc(WIDE_TC_ARGS) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * RING_MAX];
  uint8_t* sm = setup_ring(smem_raw, bars, 4 * CW, stages);
  uint8_t* ring = sm + 2 * CW * NK * BOX;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS * CW;
  const int n_kt = (valid + ROWS - 1) / ROWS;
  if (threadIdx.x >= 128 * CW) {
    if constexpr (CW == 2) regs_down<24>();
    if (threadIdx.x == 128 * CW) {
      if constexpr (NK > 0)
        produce_wide<NK, CW>(&maps.q, &maps.g, sm, q0, &maps.k, &maps.v,
                             ring, n_kt, stages, h, b, bars);
      else
        produce_stream(&maps.q, &maps.k, &maps.g, &maps.v, nullptr, q0, 0,
                       0, ring, n_kt, nk, stages, h, b, bars);
    }
    return;
  }
  if constexpr (CW == 2) regs_up<240>();
  const int wg = threadIdx.x >> 7;
  const Place p = wplace();
  const float sl = scale * LOG2E;
  const uint8_t* qres = sm + wg * NK * BOX;
  const uint8_t* gres = sm + (CW + wg) * NK * BOX;
  // per row: the running max (log2 domain), sum of p and sum of p dp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  if constexpr (NK > 0) mbar_wait(&bars[0], 0);
  for (int kt = 0, it = 0; kt < n_kt; ++kt) {
    float sc[32], dp[32];
    // S = Q K^T, dP = g V^T
    contract<NK, true, false>(sc, dp, qres, gres, ring, bars, it, nk, stages,
                              p.lane);
    ring_release(bars, it++, p.lane, stages);
    // keys >= valid get -inf; every tile holds a valid key
    const int k0 = kt * ROWS;
    if (k0 + ROWS > valid) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i / 4) + p.c + (i & 1) >= valid) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mn = fmaxf(m[e], quad_max(mx[e]) * sl);
      const float alpha = ex2(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha;
      pd[e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      const float pr = ex2(fmaf(sc[i], sl, -m[e]));
      l[e] += pr;
      pd[e] += pr * dp[i];
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] = quad_sum(l[e]);
    pd[e] = quad_sum(pd[e]);
    const int row = q0 + ROWS * wg + p.r + 8 * e;
    if (row < N && (p.lane & 3) == 0) {
      const size_t idx = ((size_t)b * H + h) * N + row;
      lse[idx] = (m[e] + log2f(l[e])) / LOG2E;
      delta[idx] = pd[e] / l[e];
    }
  }
}

// Pass 2: dK (out0) and/or dV (out1), columns [64 cb, 64 (cb + NC)), for
// CW 64-row key tiles (K, and V for dK, the own rows), over q tiles of 64
// (Q and g streamed; each warpgroup copies the tile's lse and delta into
// shared memory). Key tiles past n_valid: no loop, exactly zero dk and dv.
template <int MODE, int NK, int NC, int CW>
__global__ void __launch_bounds__(128 * CW + (CW == 2 ? 128 : 32), 1)
attn_bwd_wide_dkdv_tc(WIDE_TC_ARGS) {
  constexpr bool DO_K = MODE != PASS_DV, DO_V = MODE != PASS_DK;
  static_assert(NK > 0 || MODE != PASS_DKDV, "streamed: dK, dV apart");
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * RING_MAX];
  uint8_t* sm = setup_ring(smem_raw, bars, 4 * CW, stages);
  uint8_t* ring = sm + (DO_K ? 2 : 1) * CW * NK * BOX;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS * CW;
  const int n_qt = k0 < valid ? (N + ROWS - 1) / ROWS : 0;
  if (threadIdx.x >= 128 * CW) {
    if constexpr (CW == 2) regs_down<24>();
    if (threadIdx.x == 128 * CW && n_qt) {
      if constexpr (NK > 0)
        produce_wide<NK, CW>(&maps.k, DO_K ? &maps.v : nullptr, sm, k0,
                             &maps.q, &maps.g, ring, n_qt, stages, h, b,
                             bars);
      else
        produce_stream(&maps.k, &maps.q, DO_K ? &maps.v : nullptr, &maps.g,
                       DO_K ? &maps.q : &maps.g, k0, cb, NC, ring, n_qt, nk,
                       stages, h, b, bars);
    }
    return;
  }
  if constexpr (CW == 2) regs_up<240>();
  const int wg = threadIdx.x >> 7;
  const Place p = wplace();
  const float sl = scale * LOG2E;
  const int kr = k0 + ROWS * wg + p.r;   // this thread's keys kr, kr + 8
  const bool key_ok[2] = {kr < valid, kr + 8 < valid};
  const uint8_t* kres = sm + wg * NK * BOX;
  const uint8_t* vres = sm + (CW + wg) * NK * BOX;
  const float* lse_bh = lse + ((size_t)b * H + h) * N;
  const float* del_bh = delta + ((size_t)b * H + h) * N;
  const int ring_bytes = NK > 0 ? 2 * NK * BOX : STREAM_ITEM;
  float* stats = reinterpret_cast<float*>(ring + stages * ring_bytes +
                                          wg * 2 * STAT_BYTES);
  float dk[DO_K ? 32 * NC : 1], dv[DO_V ? 32 * NC : 1];
#pragma unroll
  for (int i = 0; i < (DO_K ? 32 * NC : 1); ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DO_V ? 32 * NC : 1); ++i) dv[i] = 0.f;
  auto store = [&] {
    if constexpr (DO_K)
      store_rows(dk, out0 + in.at(b, h, 0) + 64 * cb, in.sr, k0 + ROWS * wg,
                 p, N, scale);
    if constexpr (DO_V)
      store_rows(dv, out1 + in.at(b, h, 0) + 64 * cb, in.sr, k0 + ROWS * wg,
                 p, N, 1.f);
  };
  if (!n_qt) {   // key tiles past n_valid: exactly zero dk and dv
    store();
    return;
  }
  if constexpr (NK > 0) mbar_wait(&bars[0], 0);

  for (int qt = 0, it = 0; qt < n_qt; ++qt) {
    // the tile's lse (threads 0-63 of the warpgroup) and delta (64-127),
    // loaded while the products run; a copy a tile parity, so that a
    // thread still reading tile qt - 1's is never overwritten
    const int t = threadIdx.x & 127, q = qt * ROWS + (t & 63);
    const float stat = q < N ? (t < ROWS ? lse_bh[q] * LOG2E : del_bh[q])
                             : 0.f;
    float sc[32], dp[32];
    // S^T = K Q^T, dP^T = V g^T; the stage or the output item: Q's and
    // g's boxes of the block's columns
    const uint8_t* st = contract<NK, DO_K, true>(sc, dp, kres, vres, ring,
                                                 bars, it, nk, stages, p.lane);
    const uint8_t* qo = NK > 0 ? st + cb * BOX : st;
    const uint8_t* go = NK > 0 ? st + (NK + cb) * BOX : st;
    float* L = stats + (qt & 1) * 2 * ROWS;
    const float* D = L + ROWS;
    L[t] = stat;
    wg_barrier(wg);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + p.c + (i & 1), r = (i >> 1) & 1;
      const bool ok = key_ok[r] && qt * ROWS + c < N;
      const float pr = ok ? ex2(fmaf(sc[i], sl, -L[c])) : 0.f;
      if constexpr (DO_K) dp[i] = pr * (dp[i] - D[c]);   // dL^T
      sc[i] = pr;                                         // P^T
    }
    uint32_t pa[4][4], da[4][4];
    if constexpr (DO_V) {
      to_a(sc, pa);
      pin(dv);
    }
    if constexpr (DO_K) {
      to_a(dp, da);
      pin(dk);
    }
    wg_fence();
    if constexpr (DO_V) wide_rs<NC>(dv, pa, go);   // P^T g
    if constexpr (DO_K) wide_rs<NC>(dk, da, qo);   // dL^T Q
    wg_commit();
    wg_wait();
    if constexpr (DO_V) pin(dv);
    if constexpr (DO_K) pin(dk);
    ring_release(bars, it++, p.lane, stages);
  }
  store();
}

// Pass 3: dQ (out0), columns [64 cb, 64 (cb + NC)), for CW 64-row q tiles
// (Q and g the own rows), over key tiles of 64 (K and V streamed). A pass
// of its own, so no atomics: K6 repeats bitwise.
template <int NK, int NC, int CW>
__global__ void __launch_bounds__(128 * CW + (CW == 2 ? 128 : 32), 1)
attn_bwd_wide_dq_tc(WIDE_TC_ARGS) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * RING_MAX];
  uint8_t* sm = setup_ring(smem_raw, bars, 4 * CW, stages);
  uint8_t* ring = sm + 2 * CW * NK * BOX;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS * CW;
  const int n_kt = (valid + ROWS - 1) / ROWS;
  if (threadIdx.x >= 128 * CW) {
    if constexpr (CW == 2) regs_down<24>();
    if (threadIdx.x == 128 * CW) {
      if constexpr (NK > 0)
        produce_wide<NK, CW>(&maps.q, &maps.g, sm, q0, &maps.k, &maps.v,
                             ring, n_kt, stages, h, b, bars);
      else
        produce_stream(&maps.q, &maps.k, &maps.g, &maps.v, &maps.k, q0, cb,
                       NC, ring, n_kt, nk, stages, h, b, bars);
    }
    return;
  }
  if constexpr (CW == 2) regs_up<240>();
  const int wg = threadIdx.x >> 7;
  const Place p = wplace();
  const float sl = scale * LOG2E;
  const int qr = q0 + ROWS * wg + p.r;   // this thread's rows qr, qr + 8
  bool q_ok[2];
  float L[2], D[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    q_ok[e] = qr + 8 * e < N;
    const size_t idx = ((size_t)b * H + h) * N + (q_ok[e] ? qr + 8 * e : 0);
    L[e] = lse[idx] * LOG2E;
    D[e] = delta[idx];
  }
  const uint8_t* qres = sm + wg * NK * BOX;
  const uint8_t* gres = sm + (CW + wg) * NK * BOX;
  float dq[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) dq[i] = 0.f;
  if constexpr (NK > 0) mbar_wait(&bars[0], 0);

  for (int kt = 0, it = 0; kt < n_kt; ++kt) {
    float sc[32], dp[32];
    // S = Q K^T, dP = g V^T; the stage or the output item: K's boxes of
    // the block's columns
    const uint8_t* st = contract<NK, true, true>(sc, dp, qres, gres, ring,
                                                 bars, it, nk, stages, p.lane);
    const int kc = kt * ROWS + p.c;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const bool ok = q_ok[r] && kc + 8 * (i / 4) + (i & 1) < valid;
      const float pr = ok ? ex2(fmaf(sc[i], sl, -L[r])) : 0.f;
      dp[i] = pr * (dp[i] - D[r]);
    }
    uint32_t da[4][4];
    to_a(dp, da);
    pin(dq);
    wg_fence();
    wide_rs<NC>(dq, da, NK > 0 ? st + cb * BOX : st);   // dL K
    wg_commit();
    wg_wait();
    pin(dq);
    ring_release(bars, it++, p.lane, stages);
  }
  store_rows(dq, out0 + in.at(b, h, 0) + 64 * cb, in.sr, q0 + ROWS * wg, p,
             N, scale);
}

// ---------------------------------------------------------------------------
// K5 at head widths dh = 64 nk, nk > 1: the dh = 64 forward with each
// block over the full width, so S = Q K^T is computed once per (q tile,
// key tile) up to dh = 256 (2F of work at every dh, F one N x N x dh
// product) and once per column block above. Per key tile: S over the
// whole head is one commit group (4 nk k16 steps), waited on once; the
// online softmax of the dh = 64 form; then O += P V as one m64nWk16 wgmma
// a k16 step, P from registers, V read MN-major across the block's NC
// boxes. O is [64, W] fp32 a consumer warpgroup: W / 2 registers a thread.
// Two forms (fwd_plan picks by nk; chip_smoke's phase 2 prints the launches
// from attn_fwd_plan):
//   * resident (NK = nk <= 4, W = dh): the block's q rows (NK boxes a
//     consumer warpgroup) are loaded once by TMA; K and V tiles of the full
//     width stream through the ring (as many stages as fit, up to
//     RING_MAX) from the producer. Two consumer warpgroups (128 q rows;
//     the producer's warpgroup gives its registers by setmaxnreg, 24 and
//     240, as K6's passes). Key tiles of 128 at dh = 128 (S on m64n128k16:
//     half the softmax steps, and 1.5 bytes of shared memory read a flop of
//     S where 64 keys read 2; 160 registers of O, S and P; 64-key tiles
//     measured slower) and of 64 above (S of 128 keys beside O of 96-128
//     registers would spill, and a stage of 128 keys leaves room for only
//     one): 3 stages at dh = 128 and 192, 2 at 256. Each tile waits on its
//     products: issuing the next tile's S beside P V (the softmax under
//     the products) measured slower at dh = 192 and 256;
//   * streamed (NK = 0, nk >= 5: two warpgroups' q rows beside two
//     full-width stages outgrow the shared memory from dh = 320, and one
//     warpgroup's from dh = 384): ceil(nk / 4) column blocks
//     of W = 128-256, each computing S itself; per key tile of 64, the
//     head's nk boxes stream as items of (the block's q box, the tile's K
//     box) as K6's streamed form (one commit group a box, one in flight),
//     then one item of V's NC boxes of the block's columns; one consumer
//     warpgroup, STREAM_STAGES items.
__host__ __device__ constexpr int fwd_boxes(int nk) { return nk == 2 ? 2 : 1; }

template <int NK, int NC, int CW>
__global__ void __launch_bounds__(128 * CW + (CW == 2 ? 128 : 32), 1)
attn_fwd_wide_tc(WIDE_TC_ARGS) {
  static_assert(NK == 0 ? CW == 1 : NK == NC, "resident: W = dh");
  constexpr int R = fwd_boxes(NK), KT = ROWS * R;   // keys a tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * RING_MAX];
  uint8_t* sm = setup_ring(smem_raw, bars, 4 * CW, stages);
  uint8_t* ring = sm + CW * NK * BOX;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS * CW;
  const int n_kt = (valid + KT - 1) / KT;
  if (threadIdx.x >= 128 * CW) {
    if constexpr (CW == 2) regs_down<24>();
    if (threadIdx.x == 128 * CW) {
      if constexpr (NK > 0)
        produce_wide<NK, CW, R>(&maps.q, nullptr, sm, q0, &maps.k, &maps.v,
                                ring, n_kt, stages, h, b, bars);
      else
        produce_stream(&maps.q, &maps.k, nullptr, nullptr, &maps.v, q0, cb,
                       NC, ring, n_kt, nk, stages, h, b, bars);
    }
    return;
  }
  if constexpr (CW == 2) regs_up<240>();
  const int wg = threadIdx.x >> 7;
  const Place p = wplace();
  const float sl = scale * LOG2E;
  const uint8_t* qres = sm + wg * NK * BOX;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) o[i] = 0.f;
  if constexpr (NK > 0) mbar_wait(&bars[0], 0);

  for (int kt = 0, it = 0; kt < n_kt; ++kt) {
    float sc[32 * R];
    // S = Q K^T over the head; vt: V's boxes of the block's columns
    const uint8_t* vt;
    if constexpr (NK > 0) {
      const uint8_t* st = ring_get(ring, 2 * NK * R * BOX, bars, it, stages);
      wg_fence();
      wide_ss<NK, R>(sc, qres, st);
      wg_commit();
      wg_wait();
      pin(sc);
      vt = st + NK * R * BOX;
    } else {
      vt = contract<0, false, true>(sc, sc, nullptr, nullptr, ring, bars, it,
                                    nk, stages, p.lane);
    }
    // keys >= valid get -inf; every tile holds a valid key
    const int k0 = kt * KT;
    if (k0 + KT > valid) {
#pragma unroll
      for (int i = 0; i < 32 * R; ++i)
        if (k0 + 8 * (i / 4) + p.c + (i & 1) >= valid) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32 * R; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mn = fmaxf(m[e], quad_max(mx[e]) * sl);
      alpha[e] = ex2(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int i = 0; i < 32 * R; ++i) {
      const int e = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], sl, -m[e]));
      l[e] += sc[i];   // this thread's part of the row sum, unrounded p
    }
#pragma unroll
    for (int i = 0; i < 32 * NC; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[4 * R][4];
    to_a(sc, pa);      // p rounded to bf16 before P V
    const uint64_t vd = mn_desc(vt, R * BOX);
    pin(o);
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4 * R; ++t) wgmma_rsw<NC>(o, pa[t], vd + 128 * t);
    wg_commit();
    wg_wait();
    pin(o);
    ring_release(bars, it++, p.lane, stages);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = quad_sum(l[e]);
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) o[i] = o[i] / l[(i >> 1) & 1];
  store_rows(o, out0 + in.at(b, h, 0) + 64 * cb, in.sr, q0 + ROWS * wg, p, N,
             1.f);
}
#undef WIDE_TC_ARGS

// cuTensorMapEncodeTiled from the driver the process has loaded (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// One operand view (element strides s, base at its section) as a 4-D map
// {dh, N, H, B} of 64 x 64 boxes, 128-byte swizzled; rows past N read as
// zeros. TMA refuses a base that is not 16-byte aligned or a stride that
// is not a multiple of 16 bytes: then this returns false.
bool head_map(CUtensorMap* map, const void* base, const Strides& s, int B,
              int H, int N, int dh = DH) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)N, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.sr * 2, (cuuint64_t)s.sh * 2,
                                 (cuuint64_t)s.sb * 2};
  const cuuint32_t box[4] = {DH, ROWS, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

using Op = Operands<__nv_bfloat16>;

// q, k, v through op.in; g (the backward's cotangent) through op.os. The
// forward loads no g, and its map repeats q's.
bool make_maps(Maps* maps, const Op& op, const void* g, int B, int H,
               int N, int dh = DH) {
  if (!head_map(&maps->q, op.q, op.in, B, H, N, dh) ||
      !head_map(&maps->k, op.k, op.in, B, H, N, dh) ||
      !head_map(&maps->v, op.v, op.in, B, H, N, dh))
    return false;
  if (!g) {
    maps->g = maps->q;
    return true;
  }
  return head_map(&maps->g, g, op.os, B, H, N, dh);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int smem, dim3 grid,
           cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

int fwd(const Op& op, void* out, int B, int N, int H, int valid, float scale,
        cudaStream_t stream) {
  Maps maps;
  if (!make_maps(&maps, op, nullptr, B, H, N))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + ROWS - 1) / ROWS, H, B);
  return launch(attn_fwd_kernel_tc<false>, THREADS, FWD_SMEM, grid, stream,
                maps, op.os, (const __nv_bfloat16*)nullptr,
                static_cast<__nv_bfloat16*>(out), (float*)nullptr,
                (float*)nullptr, N, H, valid, scale);
}

// dq, dk, dv share the layout of q, k, v (op.in); g that of the output.
int bwd(const Op& op, const void* g, void* dq, void* dk, void* dv,
        float* lse, float* delta, int B, int N, int H, int valid,
        float scale, cudaStream_t stream) {
  Maps maps;
  if (!make_maps(&maps, op, g, B, H, N)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + ROWS - 1) / ROWS, H, B);
  int err = launch(attn_fwd_kernel_tc<true>, THREADS, FWD_SMEM, grid, stream,
                   maps, op.os, static_cast<const __nv_bfloat16*>(g),
                   (__nv_bfloat16*)nullptr, lse, delta, N, H, valid, scale);
  if (err) return err;
  err = launch(attn_bwd_dkdv_tc_kernel, THREADS, BWD_SMEM, grid, stream, maps,
               op.in, (const float*)lse, (const float*)delta,
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), N, H, valid, scale);
  if (err) return err;
  return launch(attn_bwd_dq_tc_kernel, THREADS, BWD_SMEM, grid, stream, maps,
                op.in, (const float*)lse, (const float*)delta,
                static_cast<__nv_bfloat16*>(dq), N, H, valid, scale);
}

using WideFn = void (*)(Maps, Strides, float*, float*, __nv_bfloat16*,
                        __nv_bfloat16*, int, int, int, float, int, int, int);

// The launches of the wide passes (wide_plan's and fwd_plan's Set): one
// pass (its kernel) with its configuration, from the template arguments.
// Streamed forms (NK = 0): STREAM_STAGES items. K6's resident form: the
// most stages (two at most) whose shared memory fits; K5's: the most, up
// to RING_MAX.
struct Set {
  template <int KIND, int NK, int NC, int CW>
  static WidePass<WideFn> pass(int cb) {
    if constexpr (KIND == PASS_FWD)
      return fwd<NK, NC, CW>(cb);
    else
      return bwd<KIND, NK, NC, CW>(cb);
  }
  template <int NK, int NC, int CW>
  static WidePass<WideFn> fwd(int cb) {
    constexpr int R = fwd_boxes(NK);
    constexpr int stage = NK > 0 ? 2 * NK * R * BOX : STREAM_ITEM;
    constexpr int fixed = CW * NK * BOX + 1024;
    constexpr int fit = (WIDE_SMEM_CAP - fixed) / stage;
    static_assert(fit >= 1, "no stage fits");
    constexpr int stages = NK == 0         ? STREAM_STAGES
                           : fit > RING_MAX ? RING_MAX
                                            : fit;
    static_assert(fixed + stages * stage <= WIDE_SMEM_CAP, "ring too big");
    return {attn_fwd_wide_tc<NK, NC, CW>, PASS_FWD, 64 * NC, cb,
            wide_threads(CW), stages, fixed + stages * stage, ROWS * CW,
            ROWS * R};
  }
  template <int KIND, int NK, int NC, int CW>
  static WidePass<WideFn> bwd(int cb) {
    constexpr int stage = NK > 0 ? 2 * NK * BOX : STREAM_ITEM;
    constexpr int fixed = (KIND == PASS_DV ? 1 : 2) * CW * NK * BOX + 1024 +
                          CW * 2 * STAT_BYTES;
    static_assert(fixed + stage <= WIDE_SMEM_CAP, "no stage fits");
    constexpr int stages = NK == 0                             ? STREAM_STAGES
                           : fixed + 2 * stage <= WIDE_SMEM_CAP ? 2
                                                                : 1;
    static_assert(fixed + stages * stage <= WIDE_SMEM_CAP, "ring too big");
    WideFn fn;
    if constexpr (KIND == PASS_STATS)
      fn = attn_bwd_wide_stats_tc<NK, CW>;
    else if constexpr (KIND == PASS_DQ)
      fn = attn_bwd_wide_dq_tc<NK, NC, CW>;
    else
      fn = attn_bwd_wide_dkdv_tc<KIND, NK, NC, CW>;
    return {fn, KIND, 64 * NC, cb, wide_threads(CW), stages,
            fixed + stages * stage, ROWS * CW, ROWS};
  }
};

// K5 at dh = 64 nk, nk > 1 (split layout only): the launches of fwd_plan.
int fwd_wide(const Op& op, void* out, int B, int N, int H, int dh, int valid,
             float scale, cudaStream_t stream) {
  Maps maps;
  if (!make_maps(&maps, op, nullptr, B, H, N, dh))
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const int nk = dh / 64;
  fwd_plan<Set>(nk, [&](const WidePass<WideFn>& p) {
    if (err) return;
    const dim3 grid((N + p.rows - 1) / p.rows, H, B);
    err = launch(p.fn, p.threads, p.smem, grid, stream, maps, op.os,
                 (float*)nullptr, (float*)nullptr,
                 static_cast<__nv_bfloat16*>(out), (__nv_bfloat16*)nullptr, N,
                 H, valid, scale, p.cb, nk, p.stages);
  });
  return err;
}

// K6 at dh = 64 nk, nk > 1 (split layout only): the launches of
// wide_plan. lse, delta: fp32 scratch of B*H*N each.
int bwd_wide(const Op& op, const void* g, void* dq, void* dk, void* dv,
             float* lse, float* delta, int B, int N, int H, int dh,
             int valid, float scale, cudaStream_t stream) {
  Maps maps;
  if (!make_maps(&maps, op, g, B, H, N, dh))
    return (int)cudaErrorInvalidValue;
  int err = 0;
  const int nk = dh / 64;
  wide_plan<Set>(nk, [&](const WidePass<WideFn>& p) {
    if (err) return;
    const dim3 grid((N + p.rows - 1) / p.rows, H, B);
    err = launch(
        p.fn, p.threads, p.smem, grid, stream, maps, op.in, lse, delta,
        static_cast<__nv_bfloat16*>(p.kind == PASS_DQ ? dq : dk),
        static_cast<__nv_bfloat16*>(dv), N, H, valid, scale, p.cb, nk,
        p.stages);
  });
  return err;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 attention on the tensor cores in split TF32: K1 attn_qkv_fwd and K5
// attn_fwd, K2 attn_qkv_bwd and K6 attn_bwd
// ---------------------------------------------------------------------------
// Every product is mma.sync m16n8k8 .tf32 with fp32 accumulators, in three
// terms (split TF32: tf32.cuh, which conv.cu's fp32 kernels share). The
// probabilities p and dl are split like any other operand, never rounded
// further.
//
// What bounds it: three TF32 products at 495 TFLOP/s are an fp32-accurate
// 165 TFLOP/s, 2.5x the CUDA cores' 67; the bytes are the inputs once.
//
// A block owns 64 rows (four warps of 16) of one head, 128 threads, two
// blocks an SM. Its own rows of one or two operands are staged once; the
// rows it loops over stream in tiles of 64 through a two-stage cp.async
// ring (the copy of tile i + 1 in flight while tile i is multiplied).
// Blocks of 32 rows (two warps, four an SM: a finer grid at one image's
// 192-204 blocks) measured 4-12% slower at every shape.
// Tiles are raw fp32 in shared memory, rows padded to LDS = 68 floats, so
// that every fragment read below hits 32 distinct banks; each warp splits
// the fragments it reads in registers. Fragments (PTX's m16n8k8 .tf32
// layout, g = lane / 4, t = lane % 4):
//   * A from rows of a tile (the block's own: q, or k and v): a0 (g, t),
//     a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   * B "by row" where the contraction runs along a tile's columns (S =
//     Q K^T over d): b0 = T[n0 + g][k0 + t], b1 = T[n0 + g][k0 + t + 4];
//   * B "by column" where it runs along a tile's rows (O = P V over keys):
//     the contraction index is permuted inside each block of 8 so that an
//     accumulator C (c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row
//     g + 8) is the next product's A fragment as it stands, {c0, c2, c1,
//     c3}: b0 = T[j0 + 2t][n0 + g], b1 = T[j0 + 2t + 1][n0 + g].
// The layout is data, as in the bf16 kernels: every operand is read
// through the element strides of its view (Operands).
#include "tf32.cuh"

namespace tf32 {

constexpr int ROWS = 64;                // rows of a block and of a tile
constexpr int LDS = DH + 4;             // padded smem row, in floats
constexpr int TILE = ROWS * LDS;        // floats of one tile
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 2;
constexpr float LOG2E = 1.4426950408889634f;
// dynamic shared memory: the resident tiles, then two stages of two
constexpr int FWD_SMEM = (1 + 4) * TILE * 4;    // q | (k, v) x 2: 87,040
constexpr int BWD_SMEM = (2 + 4) * TILE * 4;    // 2 resident | 2 x 2: 104,448

// A fragment of rows r0.. of tile T (rows LD floats apart) at columns
// k0..k0 + 7.
template <int LD = LDS>
__device__ __forceinline__ FragA load_a(const float* T, int r0, int k0,
                                        int g, int t) {
  const float* p = T + (r0 + g) * LD + k0 + t;
  return split_a(p[0], p[8 * LD], p[4], p[8 * LD + 4]);
}
// B by row: contraction along the tile's columns k0.., n = rows n0...
template <int LD = LDS>
__device__ __forceinline__ FragB load_b_row(const float* T, int n0, int k0,
                                            int g, int t) {
  const float* p = T + (n0 + g) * LD + k0 + t;
  return split_b(p[0], p[4]);
}
// B by column: contraction along the tile's rows j0.. (permuted), n =
// columns n0...
template <int LD = LDS>
__device__ __forceinline__ FragB load_b_col(const float* T, int j0, int n0,
                                            int g, int t) {
  const float* p = T + (j0 + 2 * t) * LD + n0 + g;
  return split_b(p[0], p[LD]);
}
// The A fragment of an accumulator's 8 columns, in load_b_col's order.
__device__ __forceinline__ FragA acc_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(tc::smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Returns once every group but the newest is in shared memory.
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Rows [row0, row0 + R) of head h of batch b of the view (p, s), 64
// columns from p, into tile T; rows at or past n arrive as zeros. Every
// thread issues its part.
template <int R = ROWS>
__device__ __forceinline__ void load_tile(float* T, const float* p,
                                          const Strides& s, int b, int h,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < R * DH / 4; i += THREADS) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4, row = row0 + r;
    const bool ok = row < n;
    cp_async16(T + r * LDS + c, p + (ok ? s.at(b, h, row) + c : 0), ok);
  }
}

// Forward (STATS = false): out = softmax(q k^T * scale) v for 64 q rows,
// over key tiles of 64, online softmax in the log2 domain. STATS = true
// (the backward's first pass): lse (natural log) and delta = g . o per row
// instead of out; g is read from global memory. out and g: strides os.
template <bool STATS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_fwd_kernel_tf32(Operands<float> op, const float* __restrict__ g,
                     float* __restrict__ out, float* __restrict__ lse,
                     float* __restrict__ delta, int N, int H, int valid,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ring = qs + TILE;           // stage s: k, then v
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int n_kt = (valid + ROWS - 1) / ROWS;
  const float sl = scale * LOG2E;

  load_tile(qs, op.q, op.in, b, h, q0, N);
  load_tile(ring, op.k, op.in, b, h, 0, valid);
  load_tile(ring + TILE, op.v, op.in, b, h, 0, valid);
  cp_commit();

  FragA qa[DH / 8];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      float* st = ring + ((kt + 1) & 1) * 2 * TILE;
      load_tile(st, op.k, op.in, b, h, (kt + 1) * ROWS, valid);
      load_tile(st + TILE, op.v, op.in, b, h, (kt + 1) * ROWS, valid);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk)
        qa[kk] = load_a(qs, r0, 8 * kk, g8, t);
    }
    const float* ks = ring + (kt & 1) * 2 * TILE;
    const float* vs = ks + TILE;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      FragB kb[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = load_b_row(ks, 8 * j, 8 * kk, g8, t);
      mma3_cols(s, qa[kk], kb);
    }

    // keys >= valid get -inf; every tile holds a valid key, so each
    // row's max is finite
    const int k0 = kt * ROWS;
    if (k0 + ROWS > valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * j + 2 * t + (i & 1) >= valid) s[j][i] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * e], s[j][2 * e + 1]));
      const float mn = fmaxf(m[e], quad_max(mx) * sl);
      alpha[e] = tc::ex2(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = i >> 1;
        s[j][i] = tc::ex2(fmaf(s[j][i], sl, -m[e]));
        l[e] += s[j][i];   // this thread's part of the row sum
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      FragB vb[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) vb[n] = load_b_col(vs, 8 * j, 8 * n, g8, t);
      mma3_cols(o, acc_a(s[j]), vb);
    }
    __syncthreads();   // the stage is free for tile kt + 2
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = quad_sum(l[e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g8 + 8 * e;
    float part = 0.f;
    if (row < N) {
      if (!STATS) {
        float* dst = out + op.os.at(b, h, row) + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[n][2 * e] / l[e], o[n][2 * e + 1] / l[e]);
      } else {
        const float* gr = g + op.os.at(b, h, row) + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 gv = *reinterpret_cast<const float2*>(gr + 8 * n);
          part += gv.x * (o[n][2 * e] / l[e]) +
                  gv.y * (o[n][2 * e + 1] / l[e]);
        }
      }
    }
    if (STATS) {
      part = quad_sum(part);   // all lanes take part in the shuffle
      if (row < N && t == 0) {
        const size_t idx = ((size_t)b * H + h) * N + row;
        lse[idx] = (m[e] + log2f(l[e])) / LOG2E;
        delta[idx] = part;
      }
    }
  }
}

// Backward, dk and dv for 64 keys, looping over q tiles of 64: per tile
// S^T = K Q^T and dP^T = V g^T, P^T = exp(S^T scale - lse), dL^T = P^T
// (dP^T - delta), then dV += P^T g and dK += dL^T Q. dk and dv: strides in.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_bwd_dkdv_tf32_kernel(Operands<float> op, const float* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk_out,
                          float* __restrict__ dv_out, int N, int H,
                          int valid, float scale) {
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);
  float* const vs = ks + TILE;
  float* const ring = vs + TILE;           // stage s: q, then g
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  // key tiles past n_valid: no loop, exactly zero dk and dv
  const int n_qt = k0 < valid ? (N + ROWS - 1) / ROWS : 0;
  const float sl = scale * LOG2E;
  const bool key_ok[2] = {k0 + r0 + g8 < valid, k0 + r0 + g8 + 8 < valid};
  const float* lse_bh = lse + ((size_t)b * H + h) * N;
  const float* del_bh = delta + ((size_t)b * H + h) * N;

  if (n_qt) {
    load_tile(ks, op.k, op.in, b, h, k0, valid);
    load_tile(vs, op.v, op.in, b, h, k0, valid);
    load_tile(ring, op.q, op.in, b, h, 0, N);
    load_tile(ring + TILE, g, op.os, b, h, 0, N);
    cp_commit();
  }
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int qt = 0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) {
      float* st = ring + ((qt + 1) & 1) * 2 * TILE;
      load_tile(st, op.q, op.in, b, h, (qt + 1) * ROWS, N);
      load_tile(st + TILE, g, op.os, b, h, (qt + 1) * ROWS, N);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    const float* qs = ring + (qt & 1) * 2 * TILE;
    const float* gs = qs + TILE;
    // the tile's 64 q columns in two halves of 32: S^T and dP^T of one
    // half at a time keep the registers below the cap
#pragma unroll 1
    for (int c0 = 0; c0 < ROWS; c0 += 32) {
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        FragB qb[4], gb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = load_b_row(qs, c0 + 8 * j, 8 * kk, g8, t);
          gb[j] = load_b_row(gs, c0 + 8 * j, 8 * kk, g8, t);
        }
        mma3_cols(sc, load_a(ks, r0, 8 * kk, g8, t), qb);
        mma3_cols(dp, load_a(vs, r0, 8 * kk, g8, t), gb);
      }
      // the columns' statistics: q = qt * 64 + c0 + 8j + 2t + (i & 1)
      const int qc = qt * ROWS + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = qc + 8 * j + (i & 1);
          const bool ok = key_ok[i >> 1] && q < N;
          const float pr =
              ok ? tc::ex2(fmaf(sc[j][i], sl, -lse_bh[q] * LOG2E)) : 0.f;
          dp[j][i] = ok ? pr * (dp[j][i] - del_bh[q]) : 0.f;
          sc[j][i] = pr;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB b[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          b[n] = load_b_col(gs, c0 + 8 * j, 8 * n, g8, t);
        mma3_cols(dv, acc_a(sc[j]), b);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          b[n] = load_b_col(qs, c0 + 8 * j, 8 * n, g8, t);
        mma3_cols(dk, acc_a(dp[j]), b);
      }
    }
    __syncthreads();   // the stage is free for tile qt + 2
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = k0 + r0 + g8 + 8 * e;
    if (key >= N) continue;
    float* dkr = dk_out + op.in.at(b, h, key) + 2 * t;
    float* dvr = dv_out + op.in.at(b, h, key) + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) =
          make_float2(dk[n][2 * e] * scale, dk[n][2 * e + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * n) =
          make_float2(dv[n][2 * e], dv[n][2 * e + 1]);
    }
  }
}

// Backward, dq for 64 q rows, looping over key tiles of 64: S = Q K^T and
// dP = g V^T, dL = P (dP - delta), dQ += dL K. A pass of its own, so no
// atomics: K2 and K6 repeat bitwise. dq: strides in.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_bwd_dq_tf32_kernel(Operands<float> op, const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq_out, int N, int H, int valid,
                        float scale) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const gs = qs + TILE;
  float* const ring = gs + TILE;           // stage s: k, then v
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int n_kt = (valid + ROWS - 1) / ROWS;
  const float sl = scale * LOG2E;
  bool q_ok[2];
  float L[2], D[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g8 + 8 * e;
    q_ok[e] = row < N;
    const size_t idx = ((size_t)b * H + h) * N + (q_ok[e] ? row : 0);
    L[e] = lse[idx] * LOG2E;
    D[e] = delta[idx];
  }

  load_tile(qs, op.q, op.in, b, h, q0, N);
  load_tile(gs, g, op.os, b, h, q0, N);
  load_tile(ring, op.k, op.in, b, h, 0, valid);
  load_tile(ring + TILE, op.v, op.in, b, h, 0, valid);
  cp_commit();
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      float* st = ring + ((kt + 1) & 1) * 2 * TILE;
      load_tile(st, op.k, op.in, b, h, (kt + 1) * ROWS, valid);
      load_tile(st + TILE, op.v, op.in, b, h, (kt + 1) * ROWS, valid);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    const float* ks = ring + (kt & 1) * 2 * TILE;
    const float* vs = ks + TILE;

    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      FragB b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = load_b_row(ks, 8 * j, 8 * kk, g8, t);
      mma3_cols(sc, load_a(qs, r0, 8 * kk, g8, t), b);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = load_b_row(vs, 8 * j, 8 * kk, g8, t);
      mma3_cols(dp, load_a(gs, r0, 8 * kk, g8, t), b);
    }
    const int kc = kt * ROWS + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = i >> 1;
        const bool ok = q_ok[e] && kc + 8 * j + (i & 1) < valid;
        const float pr = ok ? tc::ex2(fmaf(sc[j][i], sl, -L[e])) : 0.f;
        dp[j][i] = ok ? pr * (dp[j][i] - D[e]) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      FragB b[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) b[n] = load_b_col(ks, 8 * j, 8 * n, g8, t);
      mma3_cols(dq, acc_a(dp[j]), b);
    }
    __syncthreads();   // the stage is free for tile kt + 2
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g8 + 8 * e;
    if (row >= N) continue;
    float* dst = dq_out + op.in.at(b, h, row) + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(dq[n][2 * e] * scale, dq[n][2 * e + 1] * scale);
  }
}

// K6 at dh = 64 nk, nk > 1, in split TF32: tc's three wide passes
// (statistics by sum p dp, dK/dV, dQ; the same forms, column blocks and
// split of dK and dV: wide_plan) on this set's fragments and cp.async
// ring. A block owns 64 rows (four warps of 16) and W = 64 NC output
// columns: a warp's accumulators cover [16, W], W / 8 fragments of four.
// Per tile, S and dP ([16, WQS] a warp) are each one chain over dh; the
// output product over the tile's rows goes into a fresh fragment of four
// n8 blocks at a time, added to the accumulator in fp32 (mma3_cols_add's
// rule: the tensor cores truncate as they accumulate, and a chain over
// every tile would drift).
//   * resident (NK = nk): the own rows (K and V, or Q and g) are staged
//     once at full width, raw, rows padded to LD = dh + 4 floats (every
//     fragment read hits 32 banks, as LDS); the other operand pair streams
//     in tiles of WQS<NK> rows at full width through a cp.async ring of
//     `stages` (two: tile i + 1 in flight while tile i is read; one where
//     two do not fit). W, WQS, stages and blocks per SM (attn_bwd_plan;
//     chip_smoke's phase 2 prints them; at most 255 registers a thread):
//       dh 128: W 128, WQS 16, 2 stages, 101 KB: two blocks an SM;
//       dh 192: W 192, WQS 32, 2 stages, 200 KB (dV 150 KB): one;
//       dh 256: W 256, WQS 32, 1 stage (dV 2), 200 KB: one;
//       dh 320: W 192 and 128, WQS 16, 1 stage (dV 2): one.
//     WQS 32 at dh = 128 (one block an SM) measured 10.39 ms against 8.80
//     for K6 at [2, 6, 3601, 128]; at dh = 192 and 256 it took 10.3 and
//     12.1 ms against 11.4 and 13.8, the resident rows' fragments split
//     half as often (tools/attn_forms.py on an H100 80GB HBM3 at 700 W).
//   * streamed (NK = 0, any nk above RESIDENT_MAX_NK: the own rows at full
//     width, 33 nk KB, leave no room for a stage from nk = 6): per tile of
//     32 streamed rows, the head's nk 64-column boxes come through a
//     two-stage ring as items of (the own rows' 64-row boxes, the tile's
//     boxes), each a chain over its 64 columns into S and dP, then one
//     item of the output product's operand (the tile's W columns of the
//     block); W 192 or 256, dV and dK apart, 102 KB.
template <int NK>
constexpr int WQS = NK == 0 || NK == 3 || NK == 4 ? 32 : 16;
// floats of a streamed-form stage: the box item or the output item
template <int NC>
constexpr int STREAM_ST = 2 * (ROWS + WQS<0>) * LDS > WQS<0> * (64 * NC + 4)
                              ? 2 * (ROWS + WQS<0>) * LDS
                              : WQS<0> * (64 * NC + 4);

// Rows [row0, row0 + R) of head h of batch b of the view (p, s), 64 NK
// columns from p, into T (rows 64 NK + 4 floats apart); rows at or past n
// arrive as zeros. Every thread issues its part.
template <int NK, int R>
__device__ __forceinline__ void load_rows(float* T, const float* p,
                                          const Strides& s, int b, int h,
                                          int row0, int n) {
  constexpr int LD = 64 * NK + 4, C = 16 * NK;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < R * C; i += THREADS) {
    const int r = i / C, c = (i % C) * 4, row = row0 + r;
    const bool ok = row < n;
    cp_async16(T + r * LD + c, p + (ok ? s.at(b, h, row) + c : 0), ok);
  }
}

// The wide passes' ring at item i (after the resident rows and, with two
// stages, item 0 were issued and committed): issue item i + 1 (two
// stages) or item i (one), then wait until item i and the resident rows
// are in shared memory. Returns item i's stage index.
template <typename Issue>
__device__ __forceinline__ int ring_step(int i, int n, int stages,
                                         Issue issue) {
  if (stages == 2) {
    if (i + 1 < n) issue(i + 1);
    cp_commit();
    cp_wait_all_but_one();
  } else {
    issue(i);
    cp_commit();
    cp_wait_all();
  }
  __syncthreads();
  return stages == 2 ? i & 1 : 0;
}

// s (+)= A B^T and, where TWO, d (+)= C D^T for a warp's 16 rows from r0
// of A and C (rows LDA floats apart) against QJ n8 blocks of the streamed
// rows of B and D (LDB apart), over KK k8 steps.
template <int QJ, int KK, int LDA, int LDB, bool TWO>
__device__ __forceinline__ void wide_chain(float (&s)[QJ][4],
                                           float (&d)[QJ][4], const float* A,
                                           const float* B, const float* C,
                                           const float* D, int r0, int g8,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    FragB bb[QJ], db[QJ];
#pragma unroll
    for (int n = 0; n < QJ; ++n) {
      bb[n] = load_b_row<LDB>(B, 8 * n, 8 * kk, g8, t);
      if constexpr (TWO) db[n] = load_b_row<LDB>(D, 8 * n, 8 * kk, g8, t);
    }
    mma3_cols(s, load_a<LDA>(A, r0, 8 * kk, g8, t), bb);
    if constexpr (TWO) mma3_cols(d, load_a<LDA>(C, r0, 8 * kk, g8, t), db);
  }
}

// d[c .. c + 3] += A B over a streamed tile's QS rows into a fresh
// fragment: A the tile's QJ k8 slices (accumulator fragments of its
// columns), B by column from T at output column n0 + 8 c.
template <int LD, int QJ, int NB>
__device__ __forceinline__ void wide_out(float (&d)[NB][4],
                                         const float (&a)[QJ][4],
                                         const float* T, int n0, int c,
                                         int g8, int t) {
  float s[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int jj = 0; jj < QJ; ++jj) {
    FragB bb[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      bb[n] = load_b_col<LD>(T, 8 * jj, n0 + 8 * (c + n), g8, t);
    mma3_cols(s, acc_a(a[jj]), bb);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[c + n][e] += s[n][e];
}

// One tile's contraction (as tc's contract), s = A B^T and, where TWO, d =
// C D^T, A and C the own rows. Resident (NK > 0): item `it` is the tile;
// its stage against the own rows res_a and res_c (rows LD apart; the
// stage holds B, then D). Streamed: the head's nk box items from `it`
// (each [A, C: 64 rows][B, D: WQS rows], LDS apart), each freed once read;
// then, where OUT, the output item. Returns the stage of the item left
// held (the tile's, the output item's, or the last box's), which the
// caller frees by __syncthreads.
template <int NK, bool TWO, bool OUT, int QJ, typename Issue>
__device__ __forceinline__ const float* wide_contract(
    float (&s)[QJ][4], float (&d)[QJ][4], const float* res_a,
    const float* res_c, const float* ring, int st_floats, int& it,
    int n_items, int nk, int stages, Issue issue, int r0, int g8, int t) {
#pragma unroll
  for (int n = 0; n < QJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = d[n][e] = 0.f;
  if constexpr (NK > 0) {
    constexpr int LD = 64 * NK + 4;
    const float* st = ring + ring_step(it, n_items, stages, issue) * st_floats;
    wide_chain<QJ, 8 * NK, LD, LD, TWO>(s, d, res_a, st, res_c,
                                        st + 8 * QJ * LD, r0, g8, t);
    return st;
  } else {
    const float* st = nullptr;
    for (int j = 0; j < nk; ++j) {
      if (j > 0) {
        __syncthreads();   // the previous box's stage is free
        ++it;
      }
      st = ring + ring_step(it, n_items, 2, issue) * st_floats;
      wide_chain<QJ, 8, LDS, LDS, TWO>(s, d, st, st + 2 * ROWS * LDS,
                                       st + ROWS * LDS,
                                       st + (2 * ROWS + 8 * QJ) * LDS, r0,
                                       g8, t);
    }
    if constexpr (OUT) {
      __syncthreads();
      st = ring + ring_step(++it, n_items, 2, issue) * st_floats;
    }
    return st;
  }
}

// The wide passes share one signature (launched through WidePass): out0
// is dQ (PASS_DQ) or dK, out1 dV; cb the first output box (column 64 cb);
// nk the head's boxes (dh / 64).
#define WIDE_TF32_ARGS                                                      \
  Operands<float> op, const float *__restrict__ g, float *__restrict__ lse, \
      float *__restrict__ delta, float *__restrict__ out0,                  \
      float *__restrict__ out1, int N, int H, int valid, float scale,       \
      int cb, int nk, int stages

// The streamed form's box item j, into st: the own rows' boxes of a and c
// (row0.., zeros at or past na), the tile's QR rows of b and d (row1..,
// past nb); each operand through its strides.
template <int QR = WQS<0>>
__device__ __forceinline__ void load_box_item(
    float* st, int j, int b, int h, const float* a, const Strides& sa,
    const float* c, const Strides& sc, int row0, int na, const float* bp,
    const Strides& sb, const float* d, const Strides& sd, int row1, int nb) {
  load_rows<1, ROWS>(st, a + 64 * j, sa, b, h, row0, na);
  if (c) load_rows<1, ROWS>(st + ROWS * LDS, c + 64 * j, sc, b, h, row0, na);
  load_rows<1, QR>(st + 2 * ROWS * LDS, bp + 64 * j, sb, b, h, row1, nb);
  if (d)
    load_rows<1, QR>(st + (2 * ROWS + QR) * LDS, d + 64 * j, sd, b, h, row1,
                     nb);
}

// Pass 1: lse and delta for 64 q rows (Q and g the own rows), over key
// tiles of QS (K and V streamed).
template <int NK>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_wide_stats_tf32(WIDE_TF32_ARGS) {
  constexpr int QS = WQS<NK>, QJ = QS / 8;   // streamed rows, n8 blocks
  constexpr int LD = 64 * NK + 4;
  constexpr int ST = NK > 0 ? 2 * QS * LD : STREAM_ST<0>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const gs = qs + ROWS * LD;
  float* const ring = NK > 0 ? gs + ROWS * LD : qs;   // stage: K, then V
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int n_kt = (valid + QS - 1) / QS;
  const int per = NK > 0 ? 1 : nk, n_items = n_kt * per;
  const float sl = scale * LOG2E;
  auto issue = [&](int it) {
    float* st = ring + (stages == 2 ? it & 1 : 0) * ST;
    const int i = it / per;
    if constexpr (NK > 0) {
      load_rows<NK, QS>(st, op.k, op.in, b, h, i * QS, valid);
      load_rows<NK, QS>(st + QS * LD, op.v, op.in, b, h, i * QS, valid);
    } else {
      load_box_item(st, it % per, b, h, op.q, op.in, g, op.os, q0, N, op.k,
                    op.in, op.v, op.in, i * QS, valid);
    }
  };
  if constexpr (NK > 0) {
    load_rows<NK, ROWS>(qs, op.q, op.in, b, h, q0, N);
    load_rows<NK, ROWS>(gs, g, op.os, b, h, q0, N);
    if (stages == 2) issue(0);
  } else {
    issue(0);
  }
  cp_commit();
  // per row: the running max (log2 domain), sum of p and sum of p dp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};

  for (int kt = 0, it = 0; kt < n_kt; ++kt, ++it) {
    float s[QJ][4], dp[QJ][4];
    // S = Q K^T, dP = g V^T
    wide_contract<NK, true, false>(s, dp, qs, gs, ring, ST, it, n_items, nk,
                                   stages, issue, r0, g8, t);
    __syncthreads();   // the stage is free
    // keys >= valid get -inf; every tile holds a valid key
    const int k0 = kt * QS;
    if (k0 + QS > valid) {
#pragma unroll
      for (int n = 0; n < QJ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * n + 2 * t + (e & 1) >= valid) s[n][e] = -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < QJ; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * e], s[n][2 * e + 1]));
      const float mn = fmaxf(m[e], quad_max(mx) * sl);
      const float alpha = tc::ex2(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha;
      pd[e] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < QJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = tc::ex2(fmaf(s[n][e], sl, -m[e >> 1]));
        l[e >> 1] += pr;
        pd[e >> 1] += pr * dp[n][e];
      }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] = quad_sum(l[e]);
    pd[e] = quad_sum(pd[e]);
    const int row = q0 + r0 + g8 + 8 * e;
    if (row < N && t == 0) {
      const size_t idx = ((size_t)b * H + h) * N + row;
      lse[idx] = (m[e] + log2f(l[e])) / LOG2E;
      delta[idx] = pd[e] / l[e];
    }
  }
}

// Pass 2: dK (out0) and/or dV (out1), columns [64 cb, 64 (cb + NC)), for
// 64 keys (K, and V for dK, the own rows), over q tiles of QS (Q and g
// streamed). Key tiles past n_valid: no loop, exactly zero dk and dv.
template <int MODE, int NK, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_wide_dkdv_tf32(WIDE_TF32_ARGS) {
  constexpr bool DO_K = MODE != PASS_DV, DO_V = MODE != PASS_DK;
  static_assert(NK > 0 || MODE != PASS_DKDV, "streamed: dK, dV apart");
  constexpr int QS = WQS<NK>, QJ = QS / 8;   // streamed rows, n8 blocks
  constexpr int LD = 64 * NK + 4, NB = 8 * NC;
  // the output product's B: the stage's columns from 64 cb, or the item
  constexpr int LDO = NK > 0 ? LD : 64 * NC + 4;
  constexpr int ST = NK > 0 ? 2 * QS * LD : STREAM_ST<NC>;
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);
  float* const vs = ks + ROWS * LD;                     // dK only
  // stage: Q, then g
  float* const ring = NK > 0 ? ks + (DO_K ? 2 : 1) * ROWS * LD : ks;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int n_qt = k0 < valid ? (N + QS - 1) / QS : 0;
  const int per = NK > 0 ? 1 : nk + 1, n_items = n_qt * per;
  const float sl = scale * LOG2E;
  const bool key_ok[2] = {k0 + r0 + g8 < valid, k0 + r0 + g8 + 8 < valid};
  const float* lse_bh = lse + ((size_t)b * H + h) * N;
  const float* del_bh = delta + ((size_t)b * H + h) * N;
  auto issue = [&](int it) {
    float* st = ring + (stages == 2 ? it & 1 : 0) * ST;
    const int i = it / per, j = it % per;
    if constexpr (NK > 0) {
      load_rows<NK, QS>(st, op.q, op.in, b, h, i * QS, N);
      load_rows<NK, QS>(st + QS * LD, g, op.os, b, h, i * QS, N);
    } else if (j < nk) {
      load_box_item(st, j, b, h, op.k, op.in, DO_K ? op.v : nullptr, op.in,
                    k0, valid, op.q, op.in, DO_K ? g : nullptr, op.os, i * QS,
                    N);
    } else if constexpr (DO_K) {
      load_rows<NC, QS>(st, op.q + 64 * cb, op.in, b, h, i * QS, N);
    } else {
      load_rows<NC, QS>(st, g + 64 * cb, op.os, b, h, i * QS, N);
    }
  };
  if (n_qt) {
    if constexpr (NK > 0) {
      load_rows<NK, ROWS>(ks, op.k, op.in, b, h, k0, valid);
      if constexpr (DO_K)
        load_rows<NK, ROWS>(vs, op.v, op.in, b, h, k0, valid);
      if (stages == 2) issue(0);
    } else {
      issue(0);
    }
    cp_commit();
  }
  float dk[DO_K ? NB : 1][4], dv[DO_V ? NB : 1][4];
#pragma unroll
  for (int n = 0; n < (DO_K ? NB : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (DO_V ? NB : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

  for (int qt = 0, it = 0; qt < n_qt; ++qt, ++it) {
    float sc[QJ][4], dp[QJ][4];
    // S^T = K Q^T, dP^T = V g^T; B of the output products: Q's and g's
    // columns of the block
    const float* st = wide_contract<NK, DO_K, true>(
        sc, dp, ks, vs, ring, ST, it, n_items, nk, stages, issue, r0, g8, t);
    const float* qo = st;
    const float* go = NK > 0 ? st + QS * LD : st;
    const int n0 = NK > 0 ? 64 * cb : 0;
    // the columns' statistics: q = qt * QS + 8n + 2t + (e & 1)
    const int qc = qt * QS + 2 * t;
#pragma unroll
    for (int n = 0; n < QJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = qc + 8 * n + (e & 1);
        const bool ok = key_ok[e >> 1] && q < N;
        const float pr =
            ok ? tc::ex2(fmaf(sc[n][e], sl, -lse_bh[q] * LOG2E)) : 0.f;
        if constexpr (DO_K) dp[n][e] = ok ? pr * (dp[n][e] - del_bh[q]) : 0.f;
        sc[n][e] = pr;
      }
#pragma unroll
    for (int c = 0; c < NB; c += 4) {
      if constexpr (DO_V) wide_out<LDO>(dv, sc, go, n0, c, g8, t);
      if constexpr (DO_K) wide_out<LDO>(dk, dp, qo, n0, c, g8, t);
    }
    __syncthreads();   // the stage is free
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = k0 + r0 + g8 + 8 * e;
    if (key >= N) continue;
    const size_t at = op.in.at(b, h, key) + 64 * cb + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if constexpr (DO_K)
        *reinterpret_cast<float2*>(out0 + at + 8 * n) =
            make_float2(dk[n][2 * e] * scale, dk[n][2 * e + 1] * scale);
      if constexpr (DO_V)
        *reinterpret_cast<float2*>(out1 + at + 8 * n) =
            make_float2(dv[n][2 * e], dv[n][2 * e + 1]);
    }
  }
}

// Pass 3: dQ (out0), columns [64 cb, 64 (cb + NC)), for 64 q rows (Q and
// g the own rows), over key tiles of QS (K and V streamed).
template <int NK, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_wide_dq_tf32(WIDE_TF32_ARGS) {
  constexpr int QS = WQS<NK>, QJ = QS / 8;   // streamed rows, n8 blocks
  constexpr int LD = 64 * NK + 4, NB = 8 * NC;
  constexpr int LDO = NK > 0 ? LD : 64 * NC + 4;
  constexpr int ST = NK > 0 ? 2 * QS * LD : STREAM_ST<NC>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const gs = qs + ROWS * LD;
  float* const ring = NK > 0 ? gs + ROWS * LD : qs;   // stage: K, then V
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int n_kt = (valid + QS - 1) / QS;
  const int per = NK > 0 ? 1 : nk + 1, n_items = n_kt * per;
  const float sl = scale * LOG2E;
  bool q_ok[2];
  float L[2], D[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g8 + 8 * e;
    q_ok[e] = row < N;
    const size_t idx = ((size_t)b * H + h) * N + (q_ok[e] ? row : 0);
    L[e] = lse[idx] * LOG2E;
    D[e] = delta[idx];
  }
  auto issue = [&](int it) {
    float* st = ring + (stages == 2 ? it & 1 : 0) * ST;
    const int i = it / per, j = it % per;
    if constexpr (NK > 0) {
      load_rows<NK, QS>(st, op.k, op.in, b, h, i * QS, valid);
      load_rows<NK, QS>(st + QS * LD, op.v, op.in, b, h, i * QS, valid);
    } else if (j < nk) {
      load_box_item(st, j, b, h, op.q, op.in, g, op.os, q0, N, op.k, op.in,
                    op.v, op.in, i * QS, valid);
    } else {
      load_rows<NC, QS>(st, op.k + 64 * cb, op.in, b, h, i * QS, valid);
    }
  };
  if constexpr (NK > 0) {
    load_rows<NK, ROWS>(qs, op.q, op.in, b, h, q0, N);
    load_rows<NK, ROWS>(gs, g, op.os, b, h, q0, N);
    if (stages == 2) issue(0);
  } else {
    issue(0);
  }
  cp_commit();
  float dq[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = 0, it = 0; kt < n_kt; ++kt, ++it) {
    float sc[QJ][4], dp[QJ][4];
    // S = Q K^T, dP = g V^T; B of the output product: K's columns of the
    // block
    const float* ko = wide_contract<NK, true, true>(
        sc, dp, qs, gs, ring, ST, it, n_items, nk, stages, issue, r0, g8, t);
    const int kc = kt * QS + 2 * t;
#pragma unroll
    for (int n = 0; n < QJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = q_ok[r] && kc + 8 * n + (e & 1) < valid;
        const float pr = ok ? tc::ex2(fmaf(sc[n][e], sl, -L[r])) : 0.f;
        dp[n][e] = ok ? pr * (dp[n][e] - D[r]) : 0.f;   // dL
      }
#pragma unroll
    for (int c = 0; c < NB; c += 4)
      wide_out<LDO>(dq, dp, ko, NK > 0 ? 64 * cb : 0, c, g8, t);   // dL K
    __syncthreads();   // the stage is free
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g8 + 8 * e;
    if (row >= N) continue;
    float* dst = out0 + op.in.at(b, h, row) + 64 * cb + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(dq[n][2 * e] * scale, dq[n][2 * e + 1] * scale);
  }
}

// K5 at dh = 64 nk, nk > 1, in split TF32: tc's full-width forward
// (fwd_plan's forms and column blocks) on this set's fragments. A block
// owns 64 q rows (four warps of 16) and W = 64 NC output columns, a warp's
// O [16, W] (W / 8 fragments of four). Per key tile of QS rows, S ([16,
// QS] a warp) is one chain of mma.sync over the whole head, issued before
// the softmax reads it; then O += P V over the tile's rows, four n8 blocks
// at a time into a fresh fragment added to O in fp32 (mma3_cols_add's
// rule), P's fragments split once a tile (the streamed form splits them
// at each use).
//   * resident (NK = nk <= 4, W = dh): the q rows' A fragments are read
//     from global memory and split into their TF32 halves once, into
//     shared memory in the order each thread reads them (per k8 step a
//     uint4 of hi halves and one of lo halves a thread: conflict-free
//     128-bit reads, no split per tile; 512 dh bytes, as two raw copies
//     of the rows); K and V tiles of QS rows at full width stream raw
//     through a two-stage cp.async ring (rows padded to LD = dh + 4).
//     QS 16 at dh = 128 and 256 (two blocks an SM at dh = 128; at 256 two
//     stages of 32 rows do not fit beside the halves), 32 at dh = 192:
//     97, 194 and 193 KB;
//   * streamed (NK = 0): K6's streamed items (load_box_item: the block's
//     raw q box and the tile's K box, a chain over their 64 columns each),
//     then an item of V's block columns; two stages; QS 16 (tiles of 32
//     rows were faster but spilled at W = 256).
template <int NK>
constexpr int FWD_QS = NK == 3 ? 32 : 16;

template <int NK, int NC>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_wide_tf32(WIDE_TF32_ARGS) {
  static_assert(NK == 0 || NK == NC, "resident: W = dh");
  constexpr int QS = FWD_QS<NK>, QJ = QS / 8;   // streamed rows, n8 blocks
  constexpr int LD = 64 * NK + 4, NB = 8 * NC, KS = 8 * NK;
  // V's stride: the stage's full width, or the item's block columns
  constexpr int LDV = NK > 0 ? LD : 64 * NC + 4;
  constexpr int ST = NK > 0 ? 2 * QS * LD : STREAM_ST<NC>;
  extern __shared__ float4 smem4[];
  // the q rows' split A fragments: [k8 step][thread] hi, then lo; the ring
  uint4* const qhi = reinterpret_cast<uint4*>(smem4);
  uint4* const qlo = qhi + KS * THREADS;
  float* const ring = reinterpret_cast<float*>(qlo + KS * THREADS);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int n_kt = (valid + QS - 1) / QS;
  const int per = NK > 0 ? 1 : nk + 1, n_items = n_kt * per;
  const float sl = scale * LOG2E;
  auto issue = [&](int it) {
    float* st = ring + (stages == 2 ? it & 1 : 0) * ST;
    const int i = it / per, j = it % per;
    if constexpr (NK > 0) {
      load_rows<NK, QS>(st, op.k, op.in, b, h, i * QS, valid);
      load_rows<NK, QS>(st + QS * LD, op.v, op.in, b, h, i * QS, valid);
    } else if (j < nk) {
      load_box_item<QS>(st, j, b, h, op.q, op.in, nullptr, op.in, q0, N,
                        op.k, op.in, nullptr, op.in, i * QS, valid);
    } else {
      load_rows<NC, QS>(st, op.v + 64 * cb, op.in, b, h, i * QS, valid);
    }
  };
  if (NK == 0 || stages == 2) issue(0);
  cp_commit();
  if constexpr (NK > 0) {
    // rows q0 + r0 + g8 and + 8 (clamped addresses, zeros at or past N)
    const int row = q0 + r0 + g8;
    const bool ok0 = row < N, ok1 = row + 8 < N;
    const float* p0 = op.q + op.in.at(b, h, ok0 ? row : 0) + t;
    const float* p1 = op.q + op.in.at(b, h, ok1 ? row + 8 : 0) + t;
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      const float a0 = p0[8 * kk], a1 = p1[8 * kk], a2 = p0[8 * kk + 4],
                  a3 = p1[8 * kk + 4];
      const FragA f = split_a(ok0 ? a0 : 0.f, ok1 ? a1 : 0.f,
                              ok0 ? a2 : 0.f, ok1 ? a3 : 0.f);
      qhi[kk * THREADS + threadIdx.x] =
          make_uint4(f.hi[0], f.hi[1], f.hi[2], f.hi[3]);
      qlo[kk * THREADS + threadIdx.x] =
          make_uint4(f.lo[0], f.lo[1], f.lo[2], f.lo[3]);
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = 0, it = 0; kt < n_kt; ++kt, ++it) {
    float s[QJ][4];
    // S = Q K^T over the head; vt: V's rows of the tile
    const float* vt;
    if constexpr (NK > 0) {
#pragma unroll
      for (int n = 0; n < QJ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const float* st = ring + ring_step(it, n_items, stages, issue) * ST;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        FragB kb[QJ];
#pragma unroll
        for (int n = 0; n < QJ; ++n)
          kb[n] = load_b_row<LD>(st, 8 * n, 8 * kk, g8, t);
        const uint4 hi = qhi[kk * THREADS + threadIdx.x];
        const uint4 lo = qlo[kk * THREADS + threadIdx.x];
        const FragA qa = {{hi.x, hi.y, hi.z, hi.w}, {lo.x, lo.y, lo.z, lo.w}};
        mma3_cols(s, qa, kb);
      }
      vt = st + QS * LD;
    } else {
      vt = wide_contract<0, false, true>(s, s, nullptr, nullptr, ring, ST, it,
                                         n_items, nk, 2, issue, r0, g8, t);
    }
    // keys >= valid get -inf; every tile holds a valid key
    const int k0 = kt * QS;
    if (k0 + QS > valid) {
#pragma unroll
      for (int n = 0; n < QJ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * n + 2 * t + (e & 1) >= valid) s[n][e] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < QJ; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * e], s[n][2 * e + 1]));
      const float mn = fmaxf(m[e], quad_max(mx) * sl);
      alpha[e] = tc::ex2(m[e] - mn);
      m[e] = mn;
      l[e] *= alpha[e];
    }
    // P's A fragments, split once a tile; the streamed form splits them at
    // each use (held beside its item addresses they spilled)
    FragA pa[NK > 0 ? QJ : 1];
#pragma unroll
    for (int n = 0; n < QJ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = tc::ex2(fmaf(s[n][e], sl, -m[e >> 1]));
        l[e >> 1] += s[n][e];   // this thread's part of the row sum
      }
      if constexpr (NK > 0) pa[n] = acc_a(s[n]);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    // O += P V, four n8 blocks at a time into a fresh fragment
#pragma unroll
    for (int c = 0; c < NB; c += 4) {
      float f[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < QJ; ++jj) {
        FragB vb[4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          vb[n] = load_b_col<LDV>(vt, 8 * jj, 8 * (c + n), g8, t);
        if constexpr (NK > 0)
          mma3_cols(f, pa[jj], vb);
        else
          mma3_cols(f, acc_a(s[jj]), vb);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c + n][e] += f[n][e];
    }
    __syncthreads();   // the stage is free
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) l[e] = quad_sum(l[e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = q0 + r0 + g8 + 8 * e;
    if (row >= N) continue;
    float* dst = out0 + op.os.at(b, h, row) + 64 * cb + 2 * t;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * e] / l[e], o[n][2 * e + 1] / l[e]);
  }
}
#undef WIDE_TF32_ARGS

using Op = Operands<float>;

int fwd(const Op& op, void* out, int B, int N, int H, int valid, float scale,
        cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, H, B);
  return tc::launch(attn_fwd_kernel_tf32<false>, THREADS, FWD_SMEM, grid,
                    stream, op, (const float*)nullptr,
                    static_cast<float*>(out), (float*)nullptr,
                    (float*)nullptr, N, H, valid, scale);
}

// dq, dk, dv share the layout of q, k, v (op.in); g that of the output.
int bwd(const Op& op, const void* g, void* dq, void* dk, void* dv,
        float* lse, float* delta, int B, int N, int H, int valid,
        float scale, cudaStream_t stream) {
  const float* gg = static_cast<const float*>(g);
  const dim3 grid((N + ROWS - 1) / ROWS, H, B);
  int err = tc::launch(attn_fwd_kernel_tf32<true>, THREADS, FWD_SMEM, grid,
                       stream, op, gg, (float*)nullptr, lse, delta, N, H,
                       valid, scale);
  if (err) return err;
  err = tc::launch(attn_bwd_dkdv_tf32_kernel, THREADS, BWD_SMEM, grid,
                   stream, op, gg, (const float*)lse, (const float*)delta,
                   static_cast<float*>(dk), static_cast<float*>(dv), N, H,
                   valid, scale);
  if (err) return err;
  return tc::launch(attn_bwd_dq_tf32_kernel, THREADS, BWD_SMEM, grid, stream,
                    op, gg, (const float*)lse, (const float*)delta,
                    static_cast<float*>(dq), N, H, valid, scale);
}

using WideFn = void (*)(Operands<float>, const float*, float*, float*,
                        float*, float*, int, int, int, float, int, int, int);

// The launches of the wide passes in split TF32 (as tc::Set; CW is bf16's
// alone). Streamed (NK = 0): two stages; resident: two where they fit.
struct Set {
  template <int KIND, int NK, int NC, int CW>
  static WidePass<WideFn> pass(int cb) {
    if constexpr (KIND == PASS_FWD)
      return fwd<NK, NC>(cb);
    else
      return bwd<KIND, NK, NC>(cb);
  }
  template <int NK, int NC>
  static WidePass<WideFn> fwd(int cb) {
    constexpr int QS = FWD_QS<NK>, LD = 64 * NK + 4;
    constexpr int fixed = ROWS * 64 * NK * 8;   // the q rows' TF32 halves
    constexpr int stage = (NK > 0 ? 2 * QS * LD : STREAM_ST<NC>) * 4;
    static_assert(fixed + stage <= WIDE_SMEM_CAP, "no stage fits");
    constexpr int stages =
        NK == 0 || fixed + 2 * stage <= WIDE_SMEM_CAP ? 2 : 1;
    return {attn_fwd_wide_tf32<NK, NC>, PASS_FWD, 64 * NC, cb, THREADS,
            stages, fixed + stages * stage, ROWS, QS};
  }
  template <int KIND, int NK, int NC>
  static WidePass<WideFn> bwd(int cb) {
    constexpr int LD = 64 * NK + 4;
    constexpr int fixed =
        NK > 0 ? (KIND == PASS_DV ? 1 : 2) * ROWS * LD * 4 : 0;
    constexpr int stage = (NK > 0 ? 2 * WQS<NK> * LD : STREAM_ST<NC>) * 4;
    static_assert(fixed + stage <= WIDE_SMEM_CAP, "no stage fits");
    constexpr int stages =
        NK == 0 || fixed + 2 * stage <= WIDE_SMEM_CAP ? 2 : 1;
    static_assert(fixed + stages * stage <= WIDE_SMEM_CAP, "ring too big");
    WideFn fn;
    if constexpr (KIND == PASS_STATS)
      fn = attn_bwd_wide_stats_tf32<NK>;
    else if constexpr (KIND == PASS_DQ)
      fn = attn_bwd_wide_dq_tf32<NK, NC>;
    else
      fn = attn_bwd_wide_dkdv_tf32<KIND, NK, NC>;
    return {fn, KIND, 64 * NC, cb, THREADS, stages, fixed + stages * stage,
            ROWS, WQS<NK>};
  }
};

// K5 at dh = 64 nk, nk > 1 (split layout only): the launches of fwd_plan.
int fwd_wide(const Op& op, void* out, int B, int N, int H, int dh, int valid,
             float scale, cudaStream_t stream) {
  int err = 0;
  const int nk = dh / 64;
  fwd_plan<Set>(nk, [&](const WidePass<WideFn>& p) {
    if (err) return;
    const dim3 grid((N + p.rows - 1) / p.rows, H, B);
    err = tc::launch(p.fn, p.threads, p.smem, grid, stream, op,
                     (const float*)nullptr, (float*)nullptr, (float*)nullptr,
                     static_cast<float*>(out), (float*)nullptr, N, H, valid,
                     scale, p.cb, nk, p.stages);
  });
  return err;
}

// K6 at dh = 64 nk, nk > 1 (split layout only): the launches of
// wide_plan. lse, delta: fp32 scratch of B*H*N each.
int bwd_wide(const Op& op, const void* g, void* dq, void* dk, void* dv,
             float* lse, float* delta, int B, int N, int H, int dh,
             int valid, float scale, cudaStream_t stream) {
  int err = 0;
  const int nk = dh / 64;
  wide_plan<Set>(nk, [&](const WidePass<WideFn>& p) {
    if (err) return;
    const dim3 grid((N + p.rows - 1) / p.rows, H, B);
    err = tc::launch(p.fn, p.threads, p.smem, grid, stream, op,
                     static_cast<const float*>(g), lse, delta,
                     static_cast<float*>(p.kind == PASS_DQ ? dq : dk),
                     static_cast<float*>(dv), N, H, valid, scale, p.cb, nk,
                     p.stages);
  });
  return err;
}

}  // namespace tf32


}  // namespace

// dtype: 0 = float32, 1 = bfloat16; both run on the tensor cores, bf16
// through wgmma (tc), fp32 through split-TF32 mma.sync (tf32). n_valid in
// [1, N]. Every tensor 16-byte aligned (TMA's and cp.async's rule).

// qkv: [B, N, 3D] contiguous; out: [B, N, D].
extern "C" int attn_qkv_fwd(const void* qkv, void* out, int B, int N, int H,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? tc::fwd(fused_operands<__nv_bfloat16>(qkv, N, H), out, B, N, H,
                n_valid, scale, s)
      : tf32::fwd(fused_operands<float>(qkv, N, H), out, B, N, H, n_valid,
                  scale, s);
}

// g: [B, N, D]; dqkv: [B, N, 3D], fully written; lse, delta: fp32 scratch
// of B*H*N each.
extern "C" int attn_qkv_bwd(const void* qkv, const void* g, void* dqkv,
                            float* lse, float* delta, int B, int N, int H,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t D = (size_t)H * DH;
  if (dtype == 1) {
    __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dqkv);
    return tc::bwd(fused_operands<__nv_bfloat16>(qkv, N, H), g, d, d + D,
                   d + 2 * D, lse, delta, B, N, H, n_valid, scale, s);
  }
  float* d = static_cast<float*>(dqkv);
  return tf32::bwd(fused_operands<float>(qkv, N, H), g, d, d + D, d + 2 * D,
                   lse, delta, B, N, H, n_valid, scale, s);
}

// q, k, v, out: [B, H, N, dh] contiguous, dh a multiple of 64: dh = 64 on
// the kernels K1 shares, wider heads on the full-width forward (fwd_wide).
extern "C" int attn_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int N, int H, int dh, int n_valid,
                        float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh < DH || dh % DH) return (int)cudaErrorInvalidValue;
  if (dh > DH)
    return dtype == 1
        ? tc::fwd_wide(split_operands<__nv_bfloat16>(q, k, v, N, H, dh), out,
                       B, N, H, dh, n_valid, scale, s)
        : tf32::fwd_wide(split_operands<float>(q, k, v, N, H, dh), out, B,
                         N, H, dh, n_valid, scale, s);
  return dtype == 1
      ? tc::fwd(split_operands<__nv_bfloat16>(q, k, v, N, H, DH), out, B, N,
                H, n_valid, scale, s)
      : tf32::fwd(split_operands<float>(q, k, v, N, H, DH), out, B, N, H,
                  n_valid, scale, s);
}

// q, k, v, g, dq, dk, dv: [B, H, N, dh] contiguous, dh a multiple of 64
// (dh = 64 on the kernels K2 shares, wider heads on the wide passes:
// bwd_wide), the gradients fully written; lse, delta: fp32 scratch of
// B*H*N each.
extern "C" int attn_bwd(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv,
                        float* lse, float* delta, int B, int N, int H,
                        int dh, int n_valid, float scale, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh < DH || dh % DH) return (int)cudaErrorInvalidValue;
  if (dh > DH)
    return dtype == 1
        ? tc::bwd_wide(split_operands<__nv_bfloat16>(q, k, v, N, H, dh), g,
                       dq, dk, dv, lse, delta, B, N, H, dh, n_valid, scale, s)
        : tf32::bwd_wide(split_operands<float>(q, k, v, N, H, dh), g, dq, dk,
                         dv, lse, delta, B, N, H, dh, n_valid, scale, s);
  return dtype == 1
      ? tc::bwd(split_operands<__nv_bfloat16>(q, k, v, N, H, DH), g, dq, dk,
                dv, lse, delta, B, N, H, n_valid, scale, s)
      : tf32::bwd(split_operands<float>(q, k, v, N, H, DH), g, dq, dk, dv,
                  lse, delta, B, N, H, n_valid, scale, s);
}

// The wide launches at head width dh in dtype (K5's fwd_plan where fwd,
// else K6's wide_plan), 10 values a launch into rows, for the first `cap`
// launches: pass kind (PASS_*), output width W, first output column,
// threads, ring stages, dynamic shared memory in bytes, the blocks an SM
// the runtime reports for that kernel and shared memory, the own rows a
// block, the rows of a streamed tile, and the kernel's address (one per
// template instance). Returns the number of launches (0 where dh is not a
// wide head), or minus a CUDA error.
constexpr int PLAN_ROW = 10;

template <typename Set>
int plan_rows(bool fwd, int nk, long long* rows, int cap) {
  int i = 0, err = 0;
  auto emit = [&](const auto& p) {
    if (err || i >= cap) {
      ++i;
      return;
    }
    int blocks = 0;
    cudaError_t e = cudaFuncSetAttribute(
        p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn,
                                                        p.threads, p.smem);
    err = (int)e;
    const long long row[PLAN_ROW] = {
        p.kind, p.w,    64 * p.cb, p.threads, p.stages,
        p.smem, blocks, p.rows,    p.keys,    (long long)(uintptr_t)p.fn};
    for (int j = 0; j < PLAN_ROW; ++j) rows[PLAN_ROW * i + j] = row[j];
    ++i;
  };
  const int n = fwd ? fwd_plan<Set>(nk, emit) : wide_plan<Set>(nk, emit);
  return err ? -err : n;
}

extern "C" int attn_bwd_plan(int dh, int dtype, long long* rows, int cap) {
  if (dh % DH) return 0;
  return dtype == 1 ? plan_rows<tc::Set>(false, dh / DH, rows, cap)
                    : plan_rows<tf32::Set>(false, dh / DH, rows, cap);
}

extern "C" int attn_fwd_plan(int dh, int dtype, long long* rows, int cap) {
  if (dh % DH) return 0;
  return dtype == 1 ? plan_rows<tc::Set>(true, dh / DH, rows, cap)
                    : plan_rows<tf32::Set>(true, dh / DH, rows, cap);
}
