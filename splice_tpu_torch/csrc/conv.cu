// Small-channel k x k convolution in [B, C, H, W] layout.
//
// Both kernels read their input through one mapping (Src below) that turns
// the source tensor x [B, Cin, H, W] into the "virtual input" V of a VALID
// stride-1 conv:
//   * an implicit zero border of `pad` around x (no padded copy);
//   * stride 2 as the space-to-depth phase image: V has 4*Cin channels,
//     channel (py*2 + px)*Cin + ci at (i, j) is x[ci, 2i + py, 2j + px]
//     (border coordinates), so a stride-2 k x k conv is the stride-1
//     ceil(k/2) conv of V with the taps scattered into a
//     [k2, k2, 4*Cin, Cout] kernel (splice_tpu/ops/conv_pallas.py
//     :1034-1060), and V is never written to device memory;
//   * an optional prologue z = leaky_ns(x*scale + shift) in fp32, rounded
//     to x's type, with one row of scale/shift per BatchNorm stack (batch b
//     uses row b / (B / groups)); ns = 1 is the affine alone. The border
//     holds zeros of z (the prologue applies to x only), which is what the
//     reference's pre-image padding v = -shift/scale approximates
//     (conv_pallas.py:959-975).
//
// K3 conv_valid_fwd replaces _make_conv_kernel (:157, launched by
// _conv_fwd_impl :276): the plain VALID form (conv_valid_chw :707), its
// has_pro form (conv_pro_valid_chw :852) and the k2 = 2 space-to-depth
// form of pallas_conv_chw / pallas_conv_bn_act_chw. It also computes the
// input gradient: the wrapper passes the cotangent with an implicit border
// and the flipped, io-swapped kernel (_conv_bwd :719-729, _convp_bwd
// :873-896).
// K4 conv_dw replaces _make_dw_kernel (:401, launched by _dw_impl :630),
// with and without the prologue (recomputed on the read, as the TPU kernel
// does) and at k in {1, 2, 3}:
// dw[dy,dx,c,co] = sum over b,y,x of V[b,c,y+dy,x+dx] * g[b,co,y,x].
//
// The SAME-border forms (the reference's SAME_BORDER_KERNELS route) are
// these kernels with the border (k-1)/2 of an odd k:
// K3'' conv_same_chw :736 / conv_same_pro_chw :770, and K4's same=True
// form (_dw_impl :663-666). The reference pre-pads rows (with the
// prologue's pre-image under a prologue) and masks columns in the kernel;
// here the border is V's implicit zero in both directions.
// K3''' replaces the stats_ho form of _make_conv_kernel (:223-246,
// conv_same_pro_stats_chw :817): K3 with an optional epilogue that adds up
// each output value after its cast to the output type, and its square, per
// channel and BatchNorm stack. The TPU kernel carried one accumulator
// across its sequential grid; here each block writes its tile's sums to
// scratch and conv_stats_reduce_kernel adds the tiles of each stack in a
// fixed order (no atomics: a seeded run repeats bit for bit).
// K7 conv_dw_gtap replaces _make_dw_kernel_gtap (:455, launched by
// _dw_gtap_impl :522): the same dw contracted the other way round, by
// tapping the cotangent instead of the input,
//   dw[K-1-dy', K-1-dx', c, co] = sum over b,r,c' of V[b,c,r,c'] *
//                                 g[b,co, r-(K-1)+dy', c'-(K-1)+dx'],
// over V's rows and columns, with g zero outside its extent (the
// reference's top/left pad of g by K-1, :549-560). V's implicit border
// makes the reference's two modes one formula: SAME is the border (K-1)/2
// on x, VALID the border 0 on a fully padded x. Output [Cin, K*K*Cout],
// tap-major; the wrapper reverses the taps (:611-612). The reference chose
// this order for fewer MXU passes (_gtap_better); on CUDA cores it is the
// same count of multiply-adds as K4 and the routing only follows the
// reference.
//
// What is kept from the TPU kernels: each input element is read from device
// memory once per output-channel chunk and each output written once; the
// normalised tensor z and the phase image are never materialised; the
// k*k*Cin contraction accumulates in fp32; outputs are in the input type
// (dw in fp32). The bias stays outside, as in the reference.
//
// What bounds it on the H100: at the generator's sites (Cin 3-136, Cout
// 3-128, outputs up to 896x896, bf16) a call moves 10-170 MB and does up to
// 17 GFLOP, so at the tensor cores' rate the bound is the memory traffic.
// This first version does the multiply-adds in fp32 on the CUDA cores, so
// it is bound by arithmetic instead; PERF.md records the gap and the
// tensor-core (implicit-GEMM wgmma) version is later work.
//
// K3 design: a block owns an 8 x 32 tile of output pixels (one per thread)
// and a chunk of COB output channels (fp32 accumulators in registers). It
// walks the virtual channels in chunks of 8: the input tile with its (k-1)
// halo and the weights of the chunk go to shared memory through the
// mapping, so any height and width work (898, 1202, ...).
// K4 design: the TPU kernel reduced B*H*W pixels into one accumulator over a
// sequential grid. Here pass 1 splits the pixels into row chunks; a block
// owns (row chunk, Cin chunk, Cout chunk), each thread one (c, co) pair
// with its k*k tap sums, and writes its partial sums to an fp32 scratch
// [chunks, k*k*Cin*Cout]. Pass 2 adds the chunks in a fixed order: no
// atomics, so a seeded run repeats bit for bit.
// K7 design: as K4, but the chunks split V's rows, the input tile has no
// halo and the cotangent tile carries it (K-1 rows above, K-1 columns to
// the left); each thread owns one ci and the K*K (tap, co) accumulators of
// its co, so one value of z feeds K*K multiply-adds from shared memory.
// It reuses K4's pass 2. Bound like K3/K4: fp32 CUDA-core arithmetic, far
// above the bytes it must move.

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

// How the virtual input V maps onto the source tensor x.
struct Src {
  int cin, H, W;          // source channels, height, width
  int pad;                // implicit zero border, in source coordinates
  int stride;             // 1, or 2 = space-to-depth phases (4*cin channels)
  const float* scale;     // [groups, cin] prologue, or nullptr
  const float* shift;
  int per_group;          // batch items per scale/shift row
  float negslope;         // 1 = affine only
};

// V[b, c, vy, vx] for c < stride*stride*cin.
template <typename T>
__device__ __forceinline__ float load_v(const T* __restrict__ x,
                                        const Src& s, int b, int c, int vy,
                                        int vx) {
  int ci = c, py = 0, px = 0;
  if (s.stride == 2) {
    const int ph = c / s.cin;
    ci = c - ph * s.cin;
    py = ph >> 1;
    px = ph & 1;
  }
  const int r = s.stride * vy + py - s.pad, col = s.stride * vx + px - s.pad;
  if (r < 0 || r >= s.H || col < 0 || col >= s.W) return 0.f;
  float v = to_f<T>(x[(((size_t)b * s.cin + ci) * s.H + r) * s.W + col]);
  if (s.scale != nullptr) {
    const int row = (b / s.per_group) * s.cin + ci;
    // two roundings, no fma: the plain version's x*scale + shift
    float z = __fadd_rn(__fmul_rn(v, s.scale[row]), s.shift[row]);
    if (s.negslope != 1.f) z = z >= 0.f ? z : z * s.negslope;
    v = to_f<T>(from_f<T>(z));
  }
  return v;
}

// ---------------------------------------------------------------------------
// K3: y[b,co,oy,ox] = sum_{c,dy,dx} V[b,c,oy+dy,ox+dx] w[dy,dx,c,co]
// ---------------------------------------------------------------------------
constexpr int TW = 32;   // output tile width (one warp per row)
constexpr int TH = 8;    // output tile height
constexpr int CB = 8;    // virtual input channels per smem chunk

template <typename T, int COB>
__global__ void __launch_bounds__(NT)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, float* __restrict__ st_part, Src src,
                int Cin, int Cout, int Ho, int Wo, int k, int n_co) {
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
      xs[i] = c0 + c < Cin
          ? load_v(x, src, b, c0 + c, y0 + rem / IW, x0 + rem % IW) : 0.f;
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
  const bool valid = oy < Ho && ox < Wo;
  if (valid) {
#pragma unroll
    for (int c = 0; c < COB; ++c)
      if (co0 + c < Cout)
        y[(((size_t)b * Cout + co0 + c) * Ho + oy) * Wo + ox] = from_f<T>(acc[c]);
  }
  if (st_part == nullptr) return;
  // K3''' epilogue: this tile's (sum, sum of squares) of the stored (cast)
  // outputs, per channel: warp shuffles, then the 8 warps in order.
  __syncthreads();                        // smem is free again
  float* red = smem;                      // [NT/32][2][COB]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < COB; ++c) {
    const float v = valid ? to_f<T>(from_f<T>(acc[c])) : 0.f;
    float s = v, q = v * v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      red[(warp * 2 + 0) * COB + c] = s;
      red[(warp * 2 + 1) * COB + c] = q;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * COB) {
    const int which = threadIdx.x / COB, c = threadIdx.x % COB;
    float t = 0.f;
    for (int i = 0; i < NT / 32; ++i) t += red[(i * 2 + which) * COB + c];
    const size_t tile = ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (co0 + c < Cout) st_part[(tile * 2 + which) * Cout + co0 + c] = t;
  }
}

// K3''' pass 2: stats[g][which][co] = sum of the tiles of stack g (its
// images' tiles are contiguous in st_part), in a fixed order: each thread
// a strided run, then a tree over the block.
__global__ void __launch_bounds__(NT)
conv_stats_reduce_kernel(const float* __restrict__ st_part,
                         float* __restrict__ stats, int tiles_per_group,
                         int Cout) {
  __shared__ float red[NT];
  const int o = blockIdx.x;               // (g * 2 + which) * Cout + co
  const int g = o / (2 * Cout);
  const float* p = st_part + (size_t)g * tiles_per_group * 2 * Cout + o % (2 * Cout);
  float s = 0.f;
  for (int t = threadIdx.x; t < tiles_per_group; t += NT) s += p[(size_t)t * 2 * Cout];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[o] = red[0];
}

template <typename T, int COB>
int launch_fwd_cob(const void* x, const void* w, void* y, float* st_part,
                   float* stats, const Src& src, int B, int Cout, int Ho,
                   int Wo, int k, cudaStream_t stream) {
  const int Cin = src.stride * src.stride * src.cin;
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
      st_part, src, Cin, Cout, Ho, Wo, k, n_co);
  int err = (int)cudaGetLastError();
  if (err || st_part == nullptr) return err;
  const int groups = B / src.per_group;
  conv_stats_reduce_kernel<<<groups * 2 * Cout, NT, 0, stream>>>(
      st_part, stats, src.per_group * grid.x * grid.y, Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, float* st_part,
               float* stats, const Src& src, int B, int Cout, int Ho, int Wo,
               int k, cudaStream_t stream) {
  if (Cout <= 8)
    return launch_fwd_cob<T, 8>(x, w, y, st_part, stats, src, B, Cout, Ho,
                                Wo, k, stream);
  if (Cout <= 16)
    return launch_fwd_cob<T, 16>(x, w, y, st_part, stats, src, B, Cout, Ho,
                                 Wo, k, stream);
  return launch_fwd_cob<T, 32>(x, w, y, st_part, stats, src, B, Cout, Ho, Wo,
                               k, stream);
}

// ---------------------------------------------------------------------------
// K4 pass 1: partial[chunk][t][c][co] over the chunk's output rows
// ---------------------------------------------------------------------------
constexpr int DR = 4;    // output rows per smem tile
constexpr int DW = 32;   // output columns per smem tile

template <typename T, int K>
__global__ void __launch_bounds__(NT)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ partial, Src src, int Cin,
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
        xs[i] = ci0 + c < Cin
            ? load_v(x, src, b, ci0 + c, ty0 + rem / XW, tx0 + rem % XW)
            : 0.f;
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
                const Src& src, int B, int Cout, int Ho, int Wo,
                int rows_per_chunk, cudaStream_t stream) {
  const int Cin = src.stride * src.stride * src.cin;
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
      static_cast<const T*>(x), static_cast<const T*>(g), partial, src, Cin,
      Cout, Ho, Wo, rows_per_chunk, chunks_per_image, cib, cob);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n_out = K * K * Cin * Cout;
  conv_dw_reduce_kernel<<<(n_out + NT - 1) / NT, NT, 0, stream>>>(
      partial, dw, n_out, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* g, float* partial, float* dw,
              const Src& src, int B, int Cout, int Ho, int Wo, int k,
              int rows_per_chunk, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_dw_k<T, 1>(x, g, partial, dw, src, B, Cout, Ho, Wo,
                                     rows_per_chunk, stream);
    case 2: return launch_dw_k<T, 2>(x, g, partial, dw, src, B, Cout, Ho, Wo,
                                     rows_per_chunk, stream);
    case 3: return launch_dw_k<T, 3>(x, g, partial, dw, src, B, Cout, Ho, Wo,
                                     rows_per_chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K7 pass 1: the cotangent-tapped weight gradient.
// partial[chunk][ci][t'][co], t' = dy'*K + dx', over the chunk's rows r of V:
//   sum over r, c of V[b,ci,r,c] * g[b,co, r-(K-1)+dy', c-(K-1)+dx']
// (g zero outside [0,Ho) x [0,Wo)); term t' is dw's tap (K-1-dy', K-1-dx').
// ---------------------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(NT)
conv_dw_gtap_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    float* __restrict__ partial, Src src, int Cin, int Cout,
                    int Ho, int Wo, int rows_per_chunk, int chunks_per_image,
                    int cib, int cob) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int GH = DR + K - 1, GW = DW + K - 1;
  constexpr int GS = (GH * GW) | 1;       // odd stride: distinct banks
  float* zs = smem;                       // [cib][DR*DW]
  float* gs = smem + cib * DR * DW;       // [cob][GS], rows GH x GW
  const int Hv = Ho + K - 1, Wv = Wo + K - 1;

  const int chunk = blockIdx.x;
  const int b = chunk / chunks_per_image;
  const int r0 = (chunk % chunks_per_image) * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, Hv);
  const int ci0 = blockIdx.y * cib, co0 = blockIdx.z * cob;
  const int col = threadIdx.x % cob, cil = threadIdx.x / cob;

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;

  for (int ty0 = r0; ty0 < r1; ty0 += DR) {
    for (int tx0 = 0; tx0 < Wv; tx0 += DW) {
      __syncthreads();
      for (int i = threadIdx.x; i < cib * DR * DW; i += NT) {
        const int c = i / (DR * DW), p = i % (DR * DW);
        const int r = ty0 + p / DW, cc = tx0 + p % DW;
        // rows past r1 belong to the next chunk and must not count here
        zs[i] = (ci0 + c < Cin && r < r1 && cc < Wv)
            ? load_v(x, src, b, ci0 + c, r, cc) : 0.f;
      }
      for (int i = threadIdx.x; i < cob * GH * GW; i += NT) {
        const int o = i / (GH * GW), rem = i % (GH * GW);
        const int co = co0 + o;
        const int gr = ty0 - (K - 1) + rem / GW, gc = tx0 - (K - 1) + rem % GW;
        float v = 0.f;
        if (co < Cout && gr >= 0 && gr < Ho && gc >= 0 && gc < Wo)
          v = to_f<T>(g[(((size_t)b * Cout + co) * Ho + gr) * Wo + gc]);
        gs[o * GS + rem] = v;
      }
      __syncthreads();
      const float* zc = zs + cil * DR * DW;
      const float* gt = gs + col * GS;
      for (int p = 0; p < DR * DW; ++p) {
        const int r = p / DW, c = p % DW;
        const float zv = zc[p];
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            acc[dy * K + dx] = fmaf(zv, gt[(r + dy) * GW + c + dx], acc[dy * K + dx]);
      }
    }
  }
  const int ci = ci0 + cil, co = co0 + col;
  if (ci < Cin && co < Cout) {
    float* out = partial + (size_t)chunk * Cin * K * K * Cout;
#pragma unroll
    for (int t = 0; t < K * K; ++t) out[((size_t)ci * K * K + t) * Cout + co] = acc[t];
  }
}

template <typename T, int K>
int launch_dw_gtap_k(const void* x, const void* g, float* partial, float* dw,
                     const Src& src, int B, int Cout, int Ho, int Wo,
                     int rows_per_chunk, cudaStream_t stream) {
  const int Cin = src.cin;
  const int cob = Cout <= 8 ? 8 : (Cout <= 16 ? 16 : 32);
  const int cib = NT / cob;
  const int chunks_per_image = (Ho + K - 1 + rows_per_chunk - 1) / rows_per_chunk;
  const int n_chunks = B * chunks_per_image;
  constexpr int GS = ((DR + K - 1) * (DW + K - 1)) | 1;
  const size_t smem = sizeof(float) * (cib * DR * DW + cob * GS);
  dim3 grid(n_chunks, (Cin + cib - 1) / cib, (Cout + cob - 1) / cob);
  conv_dw_gtap_kernel<T, K><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, src, Cin,
      Cout, Ho, Wo, rows_per_chunk, chunks_per_image, cib, cob);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n_out = K * K * Cin * Cout;
  conv_dw_reduce_kernel<<<(n_out + NT - 1) / NT, NT, 0, stream>>>(
      partial, dw, n_out, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw_gtap(const void* x, const void* g, float* partial, float* dw,
                   const Src& src, int B, int Cout, int Ho, int Wo, int k,
                   int rows_per_chunk, cudaStream_t stream) {
  switch (k) {
    case 2: return launch_dw_gtap_k<T, 2>(x, g, partial, dw, src, B, Cout, Ho,
                                          Wo, rows_per_chunk, stream);
    case 3: return launch_dw_gtap_k<T, 3>(x, g, partial, dw, src, B, Cout, Ho,
                                          Wo, rows_per_chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Src make_src(const float* scale, const float* shift, int B, int Cin, int H,
             int W, int pad, int stride, int groups, float negslope) {
  return {Cin, H, W, pad, stride, scale, shift, B / groups, negslope};
}

}  // namespace

// The rows of K3''' scratch (one per output tile) that conv_valid_fwd
// needs for a [B, Cout, Ho, Wo] output.
extern "C" int conv_stats_scratch_tiles(int B, int Ho, int Wo) {
  return B * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
}

// dtype: 0 = float32, 1 = bfloat16. x [B,Cin,H,W]; scale/shift: fp32
// [groups, Cin] or null (no prologue); stride 1 or 2; w [k,k,s*s*Cin,Cout]
// in x's type; y [B,Cout,Ho,Wo] with Ho + k - 1 <= (H + 2pad) / stride
// rounded up, and likewise Wo. st_part/stats: null, or (K3''') fp32
// scratch [conv_stats_scratch_tiles(B, Ho, Wo), 2, Cout] and the output
// [groups, 2, Cout]: per BatchNorm stack the sum and the sum of squares of
// y.
extern "C" int conv_valid_fwd(const void* x, const void* w, void* y,
                              const float* scale, const float* shift, int B,
                              int Cin, int H, int W, int Cout, int Ho, int Wo,
                              int k, int pad, int stride, int groups,
                              float negslope, float* st_part, float* stats,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  return dtype == 1
      ? launch_fwd<__nv_bfloat16>(x, w, y, st_part, stats, src, B, Cout, Ho,
                                  Wo, k, s)
      : launch_fwd<float>(x, w, y, st_part, stats, src, B, Cout, Ho, Wo, k,
                          s);
}

// K7. x, scale, shift, pad, groups, negslope: as conv_valid_fwd at stride
// 1; g [B,Cout,Ho,Wo] in x's type; partial: fp32 scratch
// [B*ceil((Ho+k-1)/rows_per_chunk), Cin*k*k*Cout]; dw: fp32 [Cin, k*k*Cout]
// with tap t' = dy'*k + dx' holding dw's tap (k-1-dy', k-1-dx') (the
// caller reverses). k in {2, 3}.
extern "C" int conv_dw_gtap(const void* x, const void* g, float* partial,
                            float* dw, const float* scale, const float* shift,
                            int B, int Cin, int H, int W, int Cout, int Ho,
                            int Wo, int k, int pad, int groups, float negslope,
                            int rows_per_chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, 1, groups,
                           negslope);
  return dtype == 1
      ? launch_dw_gtap<__nv_bfloat16>(x, g, partial, dw, src, B, Cout, Ho, Wo,
                                      k, rows_per_chunk, s)
      : launch_dw_gtap<float>(x, g, partial, dw, src, B, Cout, Ho, Wo, k,
                              rows_per_chunk, s);
}

// x, scale, shift, pad, stride, groups, negslope: as conv_valid_fwd.
// g [B,Cout,Ho,Wo] in x's type; partial: fp32 scratch
// [B*ceil(Ho/rows_per_chunk), k*k*s*s*Cin*Cout]; dw: fp32
// [k,k,s*s*Cin,Cout]. k in {1, 2, 3}.
extern "C" int conv_dw(const void* x, const void* g, float* partial,
                       float* dw, const float* scale, const float* shift,
                       int B, int Cin, int H, int W, int Cout, int Ho, int Wo,
                       int k, int pad, int stride, int groups, float negslope,
                       int rows_per_chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  return dtype == 1
      ? launch_dw<__nv_bfloat16>(x, g, partial, dw, src, B, Cout, Ho, Wo, k,
                                 rows_per_chunk, s)
      : launch_dw<float>(x, g, partial, dw, src, B, Cout, Ho, Wo, k,
                         rows_per_chunk, s);
}
