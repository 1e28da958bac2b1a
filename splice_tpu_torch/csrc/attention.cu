// Multi-head softmax attention, head dim 64, in two layouts (both sets of
// kernels read both through element strides):
//   * fused qkv: q, k and v are column sections of one [B, N, 3D] tensor
//     (heads contiguous inside each section); the output and the cotangent
//     g are the head-concatenated [B, N, D];
//   * split: q, k, v, the output, g and the three gradients are separate
//     [B, H, N, 64] tensors.
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
// bf16, 67 TFLOP/s of fp32 on the CUDA cores.
//
// Two sets of kernels, routed by dtype in every C entry:
//   * bf16, both layouts (K1/K2 on the 224-px paths, K5/K6 on the 480-px
//     path), runs on the tensor cores (namespace tc): wgmma products from
//     TMA-loaded, 128-byte-swizzled shared-memory tiles, fp32 accumulators
//     and softmax in registers, p and dl rounded to bf16 in registers as
//     the A operand of the next product. The layout is data: a 4-D tensor
//     map per operand with the view's strides, so fused qkv is read in
//     place, with no copy into split heads;
//   * fp32, both layouts, runs the CUDA-core templates: fp32 multiply-adds
//     from shared-memory tiles (the tensor cores would round fp32 to TF32).
//
// Design, both sets: the forward is flash-style, one block per (q tile,
// head, batch) with an online softmax over key tiles, so any N works (the
// TPU kernels kept a whole head's K/V in VMEM and so capped N; these have
// no cap) and the ragged edge is masked. The TPU backward carried dk/dv in
// scratch across a sequential q grid; GPU blocks run in no order, so the
// backward is three launches:
//   1. per (q tile): recompute the forward to get each row's logsumexp and
//      delta = sum_d g*o (= sum_k p*dp), fp32 scratch [B, H, N];
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

namespace {

constexpr int DH = 64;        // head dim (the wrapper checks it)
constexpr int LD = DH + 1;    // padded smem row: rows land in distinct banks
constexpr int NT = 256;       // threads per block

// Element strides of one [B, H, N, 64] operand view: row (b, h, n) starts
// at b*sb + h*sh + n*sr.
struct Strides {
  long long sb, sh, sr;
  __device__ __forceinline__ size_t at(int b, int h, int n) const {
    return (size_t)(b * sb + h * sh + n * sr);
  }
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// Round an fp32 value to T's precision and back (x.astype(T) in the reference).
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

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

// ---------------------------------------------------------------------------
// Forward (and the backward's statistics pass)
// ---------------------------------------------------------------------------
constexpr int FQ = 64;   // q rows per block
constexpr int FK = 32;   // keys per tile

// STATS=false: out[b, h, q, :] = softmax(q k^T * scale) v.
// STATS=true: lse[b,h,q] = logsumexp of the row, delta[b,h,q] = g . o with o
// unrounded (the backward's sum_k p*dp); out is not written.
template <typename T, bool STATS>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(Operands<T> op, const T* __restrict__ g, T* __restrict__ out,
                float* __restrict__ lse, float* __restrict__ delta, int N,
                int H, int valid, float scale) {
  __shared__ float Qs[FQ][LD];
  __shared__ float Ks[FK][LD];
  __shared__ float Vs[FK][LD];
  __shared__ float Ps[FQ][FK + 1];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int tid = threadIdx.x;

  for (int i = tid; i < FQ * DH; i += NT) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    Qs[r][d] = q < N ? to_f<T>(op.q[op.in.at(b, h, q) + d]) : 0.f;
  }

  // Thread (r, c4): row r of the tile; key columns c4 + 4j of each key tile;
  // output dims c4 + 4j. The four threads of a row are adjacent lanes.
  const int r = tid >> 2, c4 = tid & 3;
  float m = -INFINITY, l = 0.f;
  float acc[DH / 4];
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) acc[j] = 0.f;

  const int n_kt = (valid + FK - 1) / FK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * FK;
    __syncthreads();
    for (int i = tid; i < FK * DH; i += NT) {
      const int c = i / DH, d = i % DH, key = k0 + c;
      const bool ok = key < valid;
      const size_t row = ok ? op.in.at(b, h, key) + d : 0;
      Ks[c][d] = ok ? to_f<T>(op.k[row]) : 0.f;
      Vs[c][d] = ok ? to_f<T>(op.v[row]) : 0.f;
    }
    __syncthreads();

    float s[FK / 4];
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qv = Qs[r][d];
#pragma unroll
      for (int j = 0; j < FK / 4; ++j) s[j] = fmaf(qv, Ks[c4 + 4 * j][d], s[j]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) {
      s[j] = (k0 + c4 + 4 * j < valid) ? s[j] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    // Every processed tile holds at least one valid key, so m_new is finite.
    const float m_new = fmaxf(m, quad_max(tmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      Ps[r][c4 + 4 * j] = STATS ? p : round_t<T>(p);
    }
    l = l * alpha + quad_sum(psum);
    m = m_new;
    __syncwarp();   // row r of Ps is written and read by the same 4 lanes
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < FK; ++c) {
      const float p = Ps[r][c];
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) acc[j] = fmaf(p, Vs[c][c4 + 4 * j], acc[j]);
    }
  }

  const int q = q0 + r;
  if (!STATS) {
    if (q < N) {
      T* o = out + op.os.at(b, h, q);
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) o[c4 + 4 * j] = from_f<T>(acc[j] / l);
    }
  } else {
    float part = 0.f;
    if (q < N) {
      const T* gr = g + op.os.at(b, h, q);
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) part += to_f<T>(gr[c4 + 4 * j]) * (acc[j] / l);
    }
    part = quad_sum(part);   // all lanes take part in the shuffle
    if (q < N && c4 == 0) {
      const size_t idx = ((size_t)b * H + h) * N + q;
      lse[idx] = m + logf(l);
      delta[idx] = part;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dk, dv per key tile
// ---------------------------------------------------------------------------
constexpr int BT = 32;   // rows per tile in both backward kernels

template <typename T>
__global__ void __launch_bounds__(NT)
attn_bwd_dkdv_kernel(Operands<T> op, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk_out,
                     T* __restrict__ dv_out, int N, int H, int valid,
                     float scale) {
  __shared__ float Ks[BT][LD];
  __shared__ float Vs[BT][LD];
  __shared__ float Qs[BT][LD];
  __shared__ float Gs[BT][LD];
  __shared__ float Ps[BT][BT + 1];
  __shared__ float DLs[BT][BT + 1];
  __shared__ float Ls[BT];
  __shared__ float Ds[BT];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const float* lse_bh = lse + ((size_t)b * H + h) * N;
  const float* del_bh = delta + ((size_t)b * H + h) * N;

  for (int i = tid; i < BT * DH; i += NT) {
    const int c = i / DH, d = i % DH, key = k0 + c;
    const bool ok = key < valid;
    const size_t row = ok ? op.in.at(b, h, key) + d : 0;
    Ks[c][d] = ok ? to_f<T>(op.k[row]) : 0.f;
    Vs[c][d] = ok ? to_f<T>(op.v[row]) : 0.f;
  }

  // Thread (kr, c8): key row kr; q columns c8 + 8j of the score tile;
  // output dims c8 + 8j. The 8 threads of a key row are adjacent lanes.
  const int kr = tid >> 3, c8 = tid & 7;
  float dk[DH / 8], dv[DH / 8];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) { dk[j] = 0.f; dv[j] = 0.f; }
  const bool key_ok = (k0 + kr) < valid;

  if (k0 < valid) {   // key tiles past n_valid get exactly zero dk, dv
    for (int q0 = 0; q0 < N; q0 += BT) {
      __syncthreads();
      for (int i = tid; i < BT * DH; i += NT) {
        const int r = i / DH, d = i % DH, q = q0 + r;
        const bool ok = q < N;
        Qs[r][d] = ok ? to_f<T>(op.q[op.in.at(b, h, q) + d]) : 0.f;
        Gs[r][d] = ok ? to_f<T>(g[op.os.at(b, h, q) + d]) : 0.f;
      }
      if (tid < BT) {
        const int q = q0 + tid;
        Ls[tid] = q < N ? lse_bh[q] : 0.f;
        Ds[tid] = q < N ? del_bh[q] : 0.f;
      }
      __syncthreads();

      float s[BT / 8], dp[BT / 8];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) { s[j] = 0.f; dp[j] = 0.f; }
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = Ks[kr][d], vv = Vs[kr][d];
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          s[j] = fmaf(kv, Qs[c8 + 8 * j][d], s[j]);
          dp[j] = fmaf(vv, Gs[c8 + 8 * j][d], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const int qc = c8 + 8 * j;
        const bool ok = key_ok && (q0 + qc) < N;
        const float p = ok ? expf(s[j] * scale - Ls[qc]) : 0.f;
        const float dl = p * (dp[j] - Ds[qc]);
        Ps[kr][qc] = round_t<T>(p);
        DLs[kr][qc] = round_t<T>(dl);
      }
      __syncwarp();   // row kr of Ps/DLs is written and read by 8 lanes
      for (int qc = 0; qc < BT; ++qc) {
        const float p = Ps[kr][qc], dl = DLs[kr][qc];
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          dv[j] = fmaf(p, Gs[qc][c8 + 8 * j], dv[j]);
          dk[j] = fmaf(dl, Qs[qc][c8 + 8 * j], dk[j]);
        }
      }
    }
  }

  const int key = k0 + kr;
  if (key < N) {
    const size_t row = op.in.at(b, h, key);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      dk_out[row + c8 + 8 * j] = from_f<T>(dk[j] * scale);
      dv_out[row + c8 + 8 * j] = from_f<T>(dv[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dq per q tile
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(Operands<T> op, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq_out,
                   int N, int H, int valid, float scale) {
  __shared__ float Qs[BT][LD];
  __shared__ float Gs[BT][LD];
  __shared__ float Ks[BT][LD];
  __shared__ float Vs[BT][LD];
  __shared__ float DLs[BT][BT + 1];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;

  for (int i = tid; i < BT * DH; i += NT) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    const bool ok = q < N;
    Qs[r][d] = ok ? to_f<T>(op.q[op.in.at(b, h, q) + d]) : 0.f;
    Gs[r][d] = ok ? to_f<T>(g[op.os.at(b, h, q) + d]) : 0.f;
  }
  // Thread (qr, c8): q row qr; key columns c8 + 8j; output dims c8 + 8j.
  const int qr = tid >> 3, c8 = tid & 7;
  const int q = q0 + qr;
  const size_t sidx = ((size_t)b * H + h) * N + (q < N ? q : 0);
  const float L = lse[sidx], Dl = delta[sidx];
  float dq[DH / 8];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) dq[j] = 0.f;

  for (int k0 = 0; k0 < valid; k0 += BT) {
    __syncthreads();
    for (int i = tid; i < BT * DH; i += NT) {
      const int c = i / DH, d = i % DH, key = k0 + c;
      const bool ok = key < valid;
      const size_t row = ok ? op.in.at(b, h, key) + d : 0;
      Ks[c][d] = ok ? to_f<T>(op.k[row]) : 0.f;
      Vs[c][d] = ok ? to_f<T>(op.v[row]) : 0.f;
    }
    __syncthreads();

    float s[BT / 8], dp[BT / 8];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) { s[j] = 0.f; dp[j] = 0.f; }
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qv = Qs[qr][d], gv = Gs[qr][d];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        s[j] = fmaf(qv, Ks[c8 + 8 * j][d], s[j]);
        dp[j] = fmaf(gv, Vs[c8 + 8 * j][d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int kc = c8 + 8 * j;
      const bool ok = q < N && (k0 + kc) < valid;
      const float p = ok ? expf(s[j] * scale - L) : 0.f;
      DLs[qr][kc] = round_t<T>(p * (dp[j] - Dl));
    }
    __syncwarp();
    for (int kc = 0; kc < BT; ++kc) {
      const float dl = DLs[qr][kc];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) dq[j] = fmaf(dl, Ks[kc][c8 + 8 * j], dq[j]);
    }
  }
  if (q < N) {
    T* row = dq_out + op.in.at(b, h, q);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) row[c8 + 8 * j] = from_f<T>(dq[j] * scale);
  }
}

template <typename T>
int launch_fwd(Operands<T> op, void* out, int B, int N, int H, int valid,
               float scale, cudaStream_t stream) {
  dim3 grid((N + FQ - 1) / FQ, H, B);
  attn_fwd_kernel<T, false><<<grid, NT, 0, stream>>>(
      op, nullptr, static_cast<T*>(out), nullptr, nullptr, N, H, valid,
      scale);
  return (int)cudaGetLastError();
}

// dq, dk, dv share the layout of q, k, v.
template <typename T>
int launch_bwd(Operands<T> op, const void* g, void* dq, void* dk, void* dv,
               float* lse, float* delta, int B, int N, int H, int valid,
               float scale, cudaStream_t stream) {
  const T* gg = static_cast<const T*>(g);
  dim3 gs((N + FQ - 1) / FQ, H, B);
  attn_fwd_kernel<T, true><<<gs, NT, 0, stream>>>(op, gg, nullptr, lse, delta,
                                                  N, H, valid, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 gt((N + BT - 1) / BT, H, B);
  attn_bwd_dkdv_kernel<T><<<gt, NT, 0, stream>>>(
      op, gg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, H,
      valid, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_dq_kernel<T><<<gt, NT, 0, stream>>>(
      op, gg, lse, delta, static_cast<T*>(dq), N, H, valid, scale);
  return (int)cudaGetLastError();
}

// Fused qkv [B, N, 3D]: q, k, v are the sections at column 0, D, 2D.
template <typename T>
Operands<T> fused_operands(const void* qkv, int N, int H) {
  const long long D = (long long)H * DH;
  const T* base = static_cast<const T*>(qkv);
  return {base, base + D, base + 2 * D, {N * 3 * D, DH, 3 * D},
          {N * D, DH, D}};
}

// Split [B, H, N, 64] tensors, all six of one layout.
template <typename T>
Operands<T> split_operands(const void* q, const void* k, const void* v,
                           int N, int H) {
  const Strides s{(long long)H * N * DH, (long long)N * DH, DH};
  return {static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), s, s};
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

// Rows [row, row + 64) of head h of batch b of `map` into the box at dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(0), "r"(row), "r"(h), "r"(b)
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

// Rows row0 + r and row0 + r + 8 of a 64 x 64 accumulator times mul, as
// bf16, into the rows below n of `out` (one head's rows, `stride` elements
// apart).
__device__ __forceinline__ void store_rows(const float (&d)[32],
                                           __nv_bfloat16* out,
                                           long long stride, int row0,
                                           const Place& p, int n, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + p.r + 8 * h;
    if (row >= n) continue;
    uint32_t* o = reinterpret_cast<uint32_t*>(out + row * stride + p.c);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[4 * j] = pack_bf16(d[4 * j + 2 * h] * mul, d[4 * j + 2 * h + 1] * mul);
  }
}

// bars: resident, full[2], empty[2] (one arrival per consumer warp).
// Returns the 1024-aligned dynamic shared memory.
__device__ __forceinline__ uint8_t* setup(uint8_t* raw, uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    mbar_init(&bars[3], 4);
    mbar_init(&bars[4], 4);
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
// {64, N, H, B} of 64 x 64 boxes, 128-byte swizzled; rows past N read as
// zeros. TMA refuses a base that is not 16-byte aligned or a stride that
// is not a multiple of 16 bytes: then this returns false.
bool head_map(CUtensorMap* map, const void* base, const Strides& s, int B,
              int H, int N) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {DH, (cuuint64_t)N, (cuuint64_t)H,
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
               int N) {
  if (!head_map(&maps->q, op.q, op.in, B, H, N) ||
      !head_map(&maps->k, op.k, op.in, B, H, N) ||
      !head_map(&maps->v, op.v, op.in, B, H, N))
    return false;
  if (!g) {
    maps->g = maps->q;
    return true;
  }
  return head_map(&maps->g, g, op.os, B, H, N);
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

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; bf16 runs on the tensor cores, fp32 on
// the CUDA cores. n_valid in [1, N].

// qkv: [B, N, 3D] contiguous; out: [B, N, D].
extern "C" int attn_qkv_fwd(const void* qkv, void* out, int B, int N, int H,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? tc::fwd(fused_operands<__nv_bfloat16>(qkv, N, H), out, B, N, H,
                n_valid, scale, s)
      : launch_fwd(fused_operands<float>(qkv, N, H), out, B, N, H, n_valid,
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
  return launch_bwd(fused_operands<float>(qkv, N, H), g, d, d + D, d + 2 * D,
                    lse, delta, B, N, H, n_valid, scale, s);
}

// q, k, v, out: [B, H, N, 64] contiguous.
extern "C" int attn_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int N, int H, int n_valid,
                        float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? tc::fwd(split_operands<__nv_bfloat16>(q, k, v, N, H), out, B, N, H,
                n_valid, scale, s)
      : launch_fwd(split_operands<float>(q, k, v, N, H), out, B, N, H,
                   n_valid, scale, s);
}

// q, k, v, g, dq, dk, dv: [B, H, N, 64] contiguous, the gradients fully
// written; lse, delta: fp32 scratch of B*H*N each.
extern "C" int attn_bwd(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv,
                        float* lse, float* delta, int B, int N, int H,
                        int n_valid, float scale, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? tc::bwd(split_operands<__nv_bfloat16>(q, k, v, N, H), g, dq, dk, dv,
                lse, delta, B, N, H, n_valid, scale, s)
      : launch_bwd(split_operands<float>(q, k, v, N, H), g, dq, dk, dv, lse,
                   delta, B, N, H, n_valid, scale, s);
}
