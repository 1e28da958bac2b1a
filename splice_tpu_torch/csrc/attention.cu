// Multi-head softmax attention read straight from the fused [B, N, 3D] qkv
// projection (q | k | v sections, heads contiguous, head dim 64).
//
// K1 attn_qkv_fwd replaces splice_tpu/ops/attention.py _attn_qkv_kernel
// (:361, launched by _attn_qkv_fwd_impl :401). K2 attn_qkv_bwd replaces
// _attn_qkv_bwd_kernel (:447, launched by _attn_qkv_bwd_impl :529).
//
// What is kept from the TPU kernels: the fusion boundary. Each block reads
// its head's q, k and v by column offset out of [B, N, 3D]; no [B, H, N, dh]
// tensor and no logits ever reach device memory; the forward writes the
// head-concatenated [B, N, D] output the proj dense consumes, and the
// backward needs only qkv (no saved probabilities or logsumexp) and writes
// one [B, N, 3D] cotangent. Logits and softmax are fp32, keys >= n_valid are
// masked, the division comes after the PV product, p is rounded to the input
// type before PV (p.astype(v.dtype)) and dl before the dq/dk products.
//
// What bounds it on the H100: at the main-path shapes (N = 785 or 1037,
// 12 heads, B <= 2) the work is 4*B*H*N^2*64 flops forward and about 2.5x
// that backward for under 20 MB of traffic, so the bound is arithmetic.
// This first version does the arithmetic in fp32 on the CUDA cores from
// shared-memory tiles (simple and exact for both bf16 and fp32 inputs); the
// tensor-core (wgmma) version is later work, and PERF.md records the gap.
//
// Design: the forward is flash-style, one block per (q tile, head, batch)
// with an online softmax over key tiles, so any N works and the ragged edge
// is masked. The TPU backward carried dk/dv in scratch across a sequential
// q grid; GPU blocks run in no order, so the backward is three launches:
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

// ---------------------------------------------------------------------------
// Forward (and the backward's statistics pass)
// ---------------------------------------------------------------------------
constexpr int FQ = 64;   // q rows per block
constexpr int FK = 32;   // keys per tile

// STATS=false: out[b, q, h*64:(h+1)*64] = softmax(q k^T * scale) v.
// STATS=true: lse[b,h,q] = logsumexp of the row, delta[b,h,q] = g . o with o
// unrounded (the backward's sum_k p*dp); out is not written.
template <typename T, bool STATS>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                T* __restrict__ out, float* __restrict__ lse,
                float* __restrict__ delta, int N, int H, int valid,
                float scale) {
  __shared__ float Qs[FQ][LD];
  __shared__ float Ks[FK][LD];
  __shared__ float Vs[FK][LD];
  __shared__ float Ps[FQ][FK + 1];

  const int D = H * DH;
  const int rs = 3 * D;                       // row stride of qkv
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const int tid = threadIdx.x;
  const T* base = qkv + (size_t)b * N * rs;

  for (int i = tid; i < FQ * DH; i += NT) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    Qs[r][d] = q < N ? to_f<T>(base[(size_t)q * rs + h * DH + d]) : 0.f;
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
      const size_t row = (size_t)key * rs + h * DH + d;
      Ks[c][d] = ok ? to_f<T>(base[row + D]) : 0.f;
      Vs[c][d] = ok ? to_f<T>(base[row + 2 * D]) : 0.f;
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
      T* o = out + ((size_t)b * N + q) * D + h * DH;
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) o[c4 + 4 * j] = from_f<T>(acc[j] / l);
    }
  } else {
    float part = 0.f;
    if (q < N) {
      const T* gr = g + ((size_t)b * N + q) * D + h * DH;
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
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dqkv,
                     int N, int H, int valid, float scale) {
  __shared__ float Ks[BT][LD];
  __shared__ float Vs[BT][LD];
  __shared__ float Qs[BT][LD];
  __shared__ float Gs[BT][LD];
  __shared__ float Ps[BT][BT + 1];
  __shared__ float DLs[BT][BT + 1];
  __shared__ float Ls[BT];
  __shared__ float Ds[BT];

  const int D = H * DH;
  const int rs = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const T* base = qkv + (size_t)b * N * rs;
  const T* gbase = g + (size_t)b * N * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * N;
  const float* del_bh = delta + ((size_t)b * H + h) * N;

  for (int i = tid; i < BT * DH; i += NT) {
    const int c = i / DH, d = i % DH, key = k0 + c;
    const bool ok = key < valid;
    const size_t row = (size_t)key * rs + h * DH + d;
    Ks[c][d] = ok ? to_f<T>(base[row + D]) : 0.f;
    Vs[c][d] = ok ? to_f<T>(base[row + 2 * D]) : 0.f;
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
        Qs[r][d] = ok ? to_f<T>(base[(size_t)q * rs + h * DH + d]) : 0.f;
        Gs[r][d] = ok ? to_f<T>(gbase[(size_t)q * D + h * DH + d]) : 0.f;
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
    T* row = dqkv + ((size_t)b * N + key) * rs + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      row[D + c8 + 8 * j] = from_f<T>(dk[j] * scale);
      row[2 * D + c8 + 8 * j] = from_f<T>(dv[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dq per q tile
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dqkv,
                   int N, int H, int valid, float scale) {
  __shared__ float Qs[BT][LD];
  __shared__ float Gs[BT][LD];
  __shared__ float Ks[BT][LD];
  __shared__ float Vs[BT][LD];
  __shared__ float DLs[BT][BT + 1];

  const int D = H * DH;
  const int rs = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const T* base = qkv + (size_t)b * N * rs;
  const T* gbase = g + (size_t)b * N * D;

  for (int i = tid; i < BT * DH; i += NT) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    const bool ok = q < N;
    Qs[r][d] = ok ? to_f<T>(base[(size_t)q * rs + h * DH + d]) : 0.f;
    Gs[r][d] = ok ? to_f<T>(gbase[(size_t)q * D + h * DH + d]) : 0.f;
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
      const size_t row = (size_t)key * rs + h * DH + d;
      Ks[c][d] = ok ? to_f<T>(base[row + D]) : 0.f;
      Vs[c][d] = ok ? to_f<T>(base[row + 2 * D]) : 0.f;
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
    T* row = dqkv + ((size_t)b * N + q) * rs + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) row[c8 + 8 * j] = from_f<T>(dq[j] * scale);
  }
}

template <typename T>
int launch_fwd(const void* qkv, void* out, int B, int N, int H, int valid,
               float scale, cudaStream_t stream) {
  dim3 grid((N + FQ - 1) / FQ, H, B);
  attn_fwd_kernel<T, false><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(qkv), nullptr, static_cast<T*>(out), nullptr,
      nullptr, N, H, valid, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* g, void* dqkv, float* lse,
               float* delta, int B, int N, int H, int valid, float scale,
               cudaStream_t stream) {
  const T* q = static_cast<const T*>(qkv);
  const T* gg = static_cast<const T*>(g);
  T* dq = static_cast<T*>(dqkv);
  dim3 gs((N + FQ - 1) / FQ, H, B);
  attn_fwd_kernel<T, true><<<gs, NT, 0, stream>>>(q, gg, nullptr, lse, delta,
                                                  N, H, valid, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 gt((N + BT - 1) / BT, H, B);
  attn_bwd_dkdv_kernel<T><<<gt, NT, 0, stream>>>(q, gg, lse, delta, dq, N, H,
                                                 valid, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_dq_kernel<T><<<gt, NT, 0, stream>>>(q, gg, lse, delta, dq, N, H,
                                               valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n_valid in [1, N].
extern "C" int attn_qkv_fwd(const void* qkv, void* out, int B, int N, int H,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_fwd<__nv_bfloat16>(qkv, out, B, N, H, n_valid, scale, s)
      : launch_fwd<float>(qkv, out, B, N, H, n_valid, scale, s);
}

// lse, delta: fp32 scratch of B*H*N each. dqkv: [B, N, 3D], fully written.
extern "C" int attn_qkv_bwd(const void* qkv, const void* g, void* dqkv,
                            float* lse, float* delta, int B, int N, int H,
                            int n_valid, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_bwd<__nv_bfloat16>(qkv, g, dqkv, lse, delta, B, N, H, n_valid,
                                  scale, s)
      : launch_bwd<float>(qkv, g, dqkv, lse, delta, B, N, H, n_valid, scale,
                          s);
}
