// Small-channel k x k stride-1 convolution in [B, C, H, W] layout.
//
// K3 conv_valid_fwd replaces splice_tpu/ops/conv_pallas.py _make_conv_kernel
// (:157, plain VALID form, launched by _conv_fwd_impl :276 via
// conv_valid_chw :707 / pallas_conv_chw :1007). It also computes the input
// gradient: the wrapper passes the cotangent with an implicit (k-1) zero
// border and the flipped, io-swapped kernel (_conv_bwd :719-729).
// K4 conv_dw replaces _make_dw_kernel (:401, launched by _dw_impl :630):
// dw[dy,dx,ci,co] = sum over b,y,x of xp[b,ci,y+dy,x+dx] * g[b,co,y,x].
//
// What is kept from the TPU kernels: each input element is read from device
// memory once per output-channel chunk and each output written once; the
// k*k*Cin contraction accumulates in fp32; outputs are in the input type
// (dw in fp32). The bias stays outside, as in the reference.
//
// What bounds it on the H100: at the main-path sites (Cin 36/68, Cout
// 16/32, 896x896 and 448x448 outputs, bf16) a call moves 80-170 MB and does
// 16-17 GFLOP, so at the tensor cores' rate the bound is the memory
// traffic (about 25-50 us). This first version does the multiply-adds in
// fp32 on the CUDA cores, so it is bound by arithmetic instead; PERF.md
// records the gap and the tensor-core (implicit-GEMM wgmma) version is
// later work.
//
// K3 design: a block owns an 8 x 32 tile of output pixels (one per thread)
// and a chunk of COB output channels (fp32 accumulators in registers). It
// walks Cin in chunks of 8: the input tile with its (k-1) halo and the
// weights of the chunk go to shared memory, zero-filled past the edges, so
// any height and width work (898, 1202, ...) and the implicit border of the
// dx pass costs no padded copy.
// K4 design: the TPU kernel reduced B*H*W pixels into one accumulator over a
// sequential grid. Here pass 1 splits the pixels into row chunks; a block
// owns (row chunk, Cin chunk, Cout chunk), each thread one (ci, co) pair
// with its k*k tap sums, and writes its partial sums to an fp32 scratch
// [chunks, k*k*Cin*Cout]. Pass 2 adds the chunks in a fixed order: no
// atomics, so a seeded run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

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

// ---------------------------------------------------------------------------
// K3: y[b,co,oy,ox] = sum_{ci,dy,dx} x[b,ci,oy+dy-pad,ox+dx-pad] w[dy,dx,ci,co]
// ---------------------------------------------------------------------------
constexpr int TW = 32;   // output tile width (one warp per row)
constexpr int TH = 8;    // output tile height
constexpr int CB = 8;    // input channels per smem chunk

template <typename T, int COB>
__global__ void __launch_bounds__(NT)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int Cin, int Hin, int Win, int Cout,
                int Ho, int Wo, int k, int pad, int n_co) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kk = k * k;
  const int IW = TW + k - 1, IH = TH + k - 1;
  float* ws = smem;                       // [CB][kk][COB], 16-byte rows
  float* xs = smem + CB * kk * COB;       // [CB][IH][IW]

  const int b = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * COB;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;

  float acc[COB];
#pragma unroll
  for (int c = 0; c < COB; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CB) {
    __syncthreads();
    for (int i = threadIdx.x; i < CB * IH * IW; i += NT) {
      const int c = i / (IH * IW), rem = i % (IH * IW);
      const int ci = c0 + c;
      const int iy = y0 + rem / IW - pad, ix = x0 + rem % IW - pad;
      float v = 0.f;
      if (ci < Cin && iy >= 0 && iy < Hin && ix >= 0 && ix < Win)
        v = to_f<T>(x[(((size_t)b * Cin + ci) * Hin + iy) * Win + ix]);
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < CB * kk * COB; i += NT) {
      const int c = i / (kk * COB), rem = i % (kk * COB);
      const int t = rem / COB, co = co0 + rem % COB, ci = c0 + c;
      ws[i] = (ci < Cin && co < Cout)
          ? to_f<T>(w[((size_t)t * Cin + ci) * Cout + co]) : 0.f;
    }
    __syncthreads();
    const int cmax = min(CB, Cin - c0);
    for (int c = 0; c < cmax; ++c) {
      for (int dy = 0; dy < k; ++dy) {
        const float* xrow = xs + (c * IH + ty + dy) * IW + tx;
        for (int dx = 0; dx < k; ++dx) {
          const float xv = xrow[dx];
          const float4* wr =
              reinterpret_cast<const float4*>(ws + (c * kk + dy * k + dx) * COB);
#pragma unroll
          for (int q = 0; q < COB / 4; ++q) {
            const float4 wv = wr[q];   // same address in every lane: broadcast
            acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy < Ho && ox < Wo) {
#pragma unroll
    for (int c = 0; c < COB; ++c)
      if (co0 + c < Cout)
        y[(((size_t)b * Cout + co0 + c) * Ho + oy) * Wo + ox] = from_f<T>(acc[c]);
  }
}

template <typename T, int COB>
int launch_fwd_cob(const void* x, const void* w, void* y, int B, int Cin,
                   int Hin, int Win, int Cout, int k, int pad,
                   cudaStream_t stream) {
  const int Ho = Hin + 2 * pad - k + 1, Wo = Win + 2 * pad - k + 1;
  const int n_co = (Cout + COB - 1) / COB;
  const size_t smem =
      sizeof(float) * (CB * k * k * COB + CB * (TH + k - 1) * (TW + k - 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_fwd_kernel<T, COB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * n_co);
  conv_fwd_kernel<T, COB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      Cin, Hin, Win, Cout, Ho, Wo, k, pad, n_co);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, int B, int Cin, int Hin,
               int Win, int Cout, int k, int pad, cudaStream_t stream) {
  if (Cout <= 8)
    return launch_fwd_cob<T, 8>(x, w, y, B, Cin, Hin, Win, Cout, k, pad, stream);
  if (Cout <= 16)
    return launch_fwd_cob<T, 16>(x, w, y, B, Cin, Hin, Win, Cout, k, pad, stream);
  return launch_fwd_cob<T, 32>(x, w, y, B, Cin, Hin, Win, Cout, k, pad, stream);
}

// ---------------------------------------------------------------------------
// K4 pass 1: partial[chunk][t][ci][co] over the chunk's output rows
// ---------------------------------------------------------------------------
constexpr int DR = 4;    // output rows per smem tile
constexpr int DW = 32;   // output columns per smem tile

template <typename T, int K>
__global__ void __launch_bounds__(NT)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ partial, int Cin, int Hp, int Wp,
                       int Cout, int Ho, int Wo, int rows_per_chunk,
                       int chunks_per_image, int cib, int cob) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int XH = DR + K - 1, XW = DW + K - 1;
  constexpr int GS = DR * DW + 1;         // padded g row: distinct banks
  float* xs = smem;                       // [cib][XH][XW]
  float* gs = smem + cib * XH * XW;       // [cob][GS]

  const int chunk = blockIdx.x;
  const int b = chunk / chunks_per_image;
  const int r0 = (chunk % chunks_per_image) * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, Ho);
  const int ci0 = blockIdx.y * cib, co0 = blockIdx.z * cob;
  const int col = threadIdx.x % cob, cil = threadIdx.x / cob;

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;

  for (int ty0 = r0; ty0 < r1; ty0 += DR) {
    for (int tx0 = 0; tx0 < Wo; tx0 += DW) {
      __syncthreads();
      for (int i = threadIdx.x; i < cib * XH * XW; i += NT) {
        const int c = i / (XH * XW), rem = i % (XH * XW);
        const int ci = ci0 + c, iy = ty0 + rem / XW, ix = tx0 + rem % XW;
        float v = 0.f;
        if (ci < Cin && iy < Hp && ix < Wp)
          v = to_f<T>(x[(((size_t)b * Cin + ci) * Hp + iy) * Wp + ix]);
        xs[i] = v;
      }
      for (int i = threadIdx.x; i < cob * DR * DW; i += NT) {
        const int o = i / (DR * DW), p = i % (DR * DW);
        const int co = co0 + o, oy = ty0 + p / DW, ox = tx0 + p % DW;
        float v = 0.f;
        // rows past r1 belong to the next chunk and must not count here
        if (co < Cout && oy < r1 && ox < Wo)
          v = to_f<T>(g[(((size_t)b * Cout + co) * Ho + oy) * Wo + ox]);
        gs[o * GS + p] = v;
      }
      __syncthreads();
      const float* xc = xs + cil * XH * XW;
      const float* gc = gs + col * GS;
      for (int p = 0; p < DR * DW; ++p) {
        const int r = p / DW, c = p % DW;
        const float gv = gc[p];
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            acc[dy * K + dx] = fmaf(xc[(r + dy) * XW + c + dx], gv, acc[dy * K + dx]);
      }
    }
  }
  const int ci = ci0 + cil, co = co0 + col;
  if (ci < Cin && co < Cout) {
    float* out = partial + (size_t)chunk * K * K * Cin * Cout;
#pragma unroll
    for (int t = 0; t < K * K; ++t) out[((size_t)t * Cin + ci) * Cout + co] = acc[t];
  }
}

// K4 pass 2: dw[i] = sum over chunks, in chunk order.
__global__ void __launch_bounds__(NT)
conv_dw_reduce_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int n_out, int n_chunks) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * n_out + i];
  dw[i] = s;
}

template <typename T, int K>
int launch_dw_k(const void* x, const void* g, float* partial, float* dw,
                int B, int Cin, int Hp, int Wp, int Cout, int rows_per_chunk,
                cudaStream_t stream) {
  const int Ho = Hp - K + 1, Wo = Wp - K + 1;
  const int cob = Cout <= 8 ? 8 : (Cout <= 16 ? 16 : 32);
  const int cib = NT / cob;
  const int chunks_per_image = (Ho + rows_per_chunk - 1) / rows_per_chunk;
  const int n_chunks = B * chunks_per_image;
  const size_t smem = sizeof(float) *
      (cib * (DR + K - 1) * (DW + K - 1) + cob * (DR * DW + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_dw_partial_kernel<T, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_chunks, (Cin + cib - 1) / cib, (Cout + cob - 1) / cob);
  conv_dw_partial_kernel<T, K><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, Cin, Hp,
      Wp, Cout, Ho, Wo, rows_per_chunk, chunks_per_image, cib, cob);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n_out = K * K * Cin * Cout;
  conv_dw_reduce_kernel<<<(n_out + NT - 1) / NT, NT, 0, stream>>>(
      partial, dw, n_out, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* g, float* partial, float* dw, int B,
              int Cin, int Hp, int Wp, int Cout, int k, int rows_per_chunk,
              cudaStream_t stream) {
  switch (k) {
    case 1: return launch_dw_k<T, 1>(x, g, partial, dw, B, Cin, Hp, Wp, Cout,
                                     rows_per_chunk, stream);
    case 3: return launch_dw_k<T, 3>(x, g, partial, dw, B, Cin, Hp, Wp, Cout,
                                     rows_per_chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [B,Cin,Hin,Win]; w [k,k,Cin,Cout] in
// x's type; y [B,Cout,Hin+2pad-k+1,Win+2pad-k+1]; pad = implicit zero border.
extern "C" int conv_valid_fwd(const void* x, const void* w, void* y, int B,
                              int Cin, int Hin, int Win, int Cout, int k,
                              int pad, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_fwd<__nv_bfloat16>(x, w, y, B, Cin, Hin, Win, Cout, k, pad, s)
      : launch_fwd<float>(x, w, y, B, Cin, Hin, Win, Cout, k, pad, s);
}

// x [B,Cin,Hp,Wp] (pre-padded), g [B,Cout,Hp-k+1,Wp-k+1] in x's type;
// partial: fp32 scratch [B*ceil(Ho/rows_per_chunk), k*k*Cin*Cout];
// dw: fp32 [k,k,Cin,Cout]. k in {1, 3}.
extern "C" int conv_dw(const void* x, const void* g, float* partial,
                       float* dw, int B, int Cin, int Hp, int Wp, int Cout,
                       int k, int rows_per_chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_dw<__nv_bfloat16>(x, g, partial, dw, B, Cin, Hp, Wp, Cout, k,
                                 rows_per_chunk, s)
      : launch_dw<float>(x, g, partial, dw, B, Cin, Hp, Wp, Cout, k,
                         rows_per_chunk, s);
}
