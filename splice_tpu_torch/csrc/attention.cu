// Multi-head softmax attention, head dim 64, in two layouts that share one
// set of kernel templates through element strides:
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
// arithmetic at every N the model runs. This first version does the
// arithmetic in fp32 on the CUDA cores from shared-memory tiles (simple and
// exact for both bf16 and fp32 inputs); the tensor-core (wgmma) version is
// later work, and PERF.md records the gap.
//
// Design: the forward is flash-style, one block per (q tile, head, batch)
// with an online softmax over key tiles, so any N works (the TPU kernels
// kept a whole head's K/V in VMEM and so capped N; these have no cap) and
// the ragged edge is masked. The TPU backward carried dk/dv in scratch
// across a sequential q grid; GPU blocks run in no order, so the backward
// is three launches:
//   1. per (q tile): recompute the forward to get each row's logsumexp and
//      delta = sum_d g*o (= sum_k p*dp), fp32 scratch [B, H, N];
//   2. per (k tile): loop over all q tiles, accumulate dk and dv in
//      registers (fp32) and write them once;
//   3. per (q tile): loop over key tiles, accumulate dq.
// Each C entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n_valid in [1, N].
extern "C" int attn_qkv_fwd(const void* qkv, void* out, int B, int N, int H,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_fwd(fused_operands<__nv_bfloat16>(qkv, N, H), out, B, N, H,
                   n_valid, scale, s)
      : launch_fwd(fused_operands<float>(qkv, N, H), out, B, N, H, n_valid,
                   scale, s);
}

// lse, delta: fp32 scratch of B*H*N each. dqkv: [B, N, 3D], fully written.
extern "C" int attn_qkv_bwd(const void* qkv, const void* g, void* dqkv,
                            float* lse, float* delta, int B, int N, int H,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t D = (size_t)H * DH;
  if (dtype == 1) {
    __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dqkv);
    return launch_bwd(fused_operands<__nv_bfloat16>(qkv, N, H), g, d, d + D,
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
      ? launch_fwd(split_operands<__nv_bfloat16>(q, k, v, N, H), out, B, N,
                   H, n_valid, scale, s)
      : launch_fwd(split_operands<float>(q, k, v, N, H), out, B, N, H,
                   n_valid, scale, s);
}

// q, k, v, g, dq, dk, dv: [B, H, N, 64] contiguous, the gradients fully
// written; lse, delta: fp32 scratch of B*H*N each.
extern "C" int attn_bwd(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv,
                        float* lse, float* delta, int B, int N, int H,
                        int n_valid, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_bwd(split_operands<__nv_bfloat16>(q, k, v, N, H), g, dq, dk,
                   dv, lse, delta, B, N, H, n_valid, scale, s)
      : launch_bwd(split_operands<float>(q, k, v, N, H), g, dq, dk, dv, lse,
                   delta, B, N, H, n_valid, scale, s);
}
