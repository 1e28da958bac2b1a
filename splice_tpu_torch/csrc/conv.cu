// Small-channel k x k convolution in [B, C, H, W] layout.
//
// Every kernel reads its input through one mapping (Src below) that turns
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
// K3 (conv_fwd_tc in bf16, conv_valid_fwd in fp32) replaces
// _make_conv_kernel (:157, launched by
// _conv_fwd_impl :276): the plain VALID form (conv_valid_chw :707), its
// has_pro form (conv_pro_valid_chw :852) and the k2 = 2 space-to-depth
// form of pallas_conv_chw / pallas_conv_bn_act_chw. It also computes the
// input gradient: the wrapper passes the cotangent with an implicit border
// and the flipped, io-swapped kernel (_conv_bwd :719-729, _convp_bwd
// :873-896).
// K4 (conv_dw_tc in bf16, conv_dw in fp32) replaces _make_dw_kernel
// (:401, launched by _dw_impl :630),
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
// K7 (conv_dw_tc in bf16, conv_dw_gtap in fp32) replaces
// _make_dw_kernel_gtap (:455, launched by
// _dw_gtap_impl :522): the same dw contracted the other way round, by
// tapping the cotangent instead of the input,
//   dw[K-1-dy', K-1-dx', c, co] = sum over b,r,c' of V[b,c,r,c'] *
//                                 g[b,co, r-(K-1)+dy', c'-(K-1)+dx'],
// over V's rows and columns, with g zero outside its extent (the
// reference's top/left pad of g by K-1, :549-560). V's implicit border
// makes the reference's two modes one formula: SAME is the border (K-1)/2
// on x, VALID the border 0 on a fully padded x. Output [Cin, K*K*Cout],
// tap-major; the wrapper reverses the taps (:611-612). The reference chose
// this order for fewer MXU passes (_gtap_better); here it is the same
// count of multiply-adds as K4 and the routing only follows the
// reference.
//
// What is kept from the TPU kernels: the normalised tensor z and the phase
// image are never materialised; the k*k*Cin contraction accumulates in
// fp32; outputs are in the input type (dw in fp32). The bias stays
// outside, as in the reference.
//
// What bounds it on the H100: at the generator's sites (Cin 3-136, Cout
// 3-128, outputs up to 896x896, bf16) a call moves 10-170 MB and does up to
// 17 GFLOP: about 100 flop per byte, under the bf16 tensor cores' ridge of
// about 295, so on the tensor cores the bound is the memory traffic, on
// the CUDA cores the arithmetic. Two routes, chosen by dtype:
//   * bf16 runs on the tensor cores (mma.sync): K3 in every form through
//     conv_fwd_tc (namespace fwdtc), K4 and K7 through conv_dw_tc
//     (namespace dwtc). Both stage x through Src into the same bf16
//     shared-memory tiles; each is described above its kernel.
//   * fp32 runs on the CUDA cores in full fp32 (the 1e-4 gates of the
//     fp32 steps need it, not TF32): conv_valid_fwd, conv_dw, conv_dw_gtap.
//
// fp32 K3 design: a block owns an 8 x 32 tile of output pixels (one per
// thread) and a chunk of COB output channels (fp32 accumulators in
// registers). It walks the virtual channels in chunks of 8: the input tile
// with its (k-1) halo and the weights of the chunk go to shared memory
// through the mapping, so any height and width work (898, 1202, ...).
// fp32 K4 design: the TPU kernel reduced B*H*W pixels into one accumulator
// over a sequential grid. Here pass 1 splits the pixels into row chunks; a
// block owns (row chunk, Cin chunk, Cout chunk), each thread one (c, co)
// pair with its k*k tap sums, and writes its partial sums to an fp32
// scratch [chunks, k*k*Cin*Cout]. Pass 2 adds the chunks in a fixed order:
// no atomics, so a seeded run repeats bit for bit.
// fp32 K7 design: as K4, but the chunks split V's rows, the input tile has
// no halo and the cotangent tile carries it (K-1 rows above, K-1 columns to
// the left); each thread owns one ci and the K*K (tap, co) accumulators of
// its co, so one value of z feeds K*K multiply-adds from shared memory.
// It reuses K4's pass 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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
// fp32 K3: y[b,co,oy,ox] = sum_{c,dy,dx} V[b,c,oy+dy,ox+dx] w[dy,dx,c,co]
// ---------------------------------------------------------------------------
constexpr int TW = 32;   // output tile width (one warp per row)
constexpr int TH = 8;    // output tile height
constexpr int CB = 8;    // virtual input channels per smem chunk

template <int COB>
__global__ void __launch_bounds__(NT)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, float* __restrict__ st_part, Src src,
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
          ? w[((size_t)t * Cin + ci) * Cout + co] : 0.f;
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
        y[(((size_t)b * Cout + co0 + c) * Ho + oy) * Wo + ox] = acc[c];
  }
  if (st_part == nullptr) return;
  // K3''' epilogue: this tile's (sum, sum of squares) of the stored
  // outputs, per channel: warp shuffles, then the 8 warps in order.
  __syncthreads();                        // smem is free again
  float* red = smem;                      // [NT/32][2][COB]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < COB; ++c) {
    const float v = valid ? acc[c] : 0.f;
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

template <int COB>
int launch_fwd_cob(const void* x, const void* w, void* y, float* st_part,
                   float* stats, const Src& src, int B, int Cout, int Ho,
                   int Wo, int k, cudaStream_t stream) {
  const int Cin = src.stride * src.stride * src.cin;
  const int n_co = (Cout + COB - 1) / COB;
  const size_t smem =
      sizeof(float) * (CB * k * k * COB + CB * (TH + k - 1) * (TW + k - 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_fwd_kernel<COB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * n_co);
  conv_fwd_kernel<COB><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y),
      st_part, src, Cin, Cout, Ho, Wo, k, n_co);
  int err = (int)cudaGetLastError();
  if (err || st_part == nullptr) return err;
  const int groups = B / src.per_group;
  conv_stats_reduce_kernel<<<groups * 2 * Cout, NT, 0, stream>>>(
      st_part, stats, src.per_group * grid.x * grid.y, Cout);
  return (int)cudaGetLastError();
}

int launch_fwd(const void* x, const void* w, void* y, float* st_part,
               float* stats, const Src& src, int B, int Cout, int Ho, int Wo,
               int k, cudaStream_t stream) {
  if (Cout <= 8)
    return launch_fwd_cob<8>(x, w, y, st_part, stats, src, B, Cout, Ho, Wo,
                             k, stream);
  if (Cout <= 16)
    return launch_fwd_cob<16>(x, w, y, st_part, stats, src, B, Cout, Ho, Wo,
                              k, stream);
  return launch_fwd_cob<32>(x, w, y, st_part, stats, src, B, Cout, Ho, Wo, k,
                            stream);
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

// ---------------------------------------------------------------------------
// bf16 K4 and K7 on the tensor cores: one implicit GEMM for both.
//
// Both contract a tap-shifted operand S with an unshifted one U over the
// pixels p of U's extent [Hp, Wp]:
//   D[(t, s), u] = sum_p S[s, p + (dy, dx)] * U[u, p],  t = dy*K + dx,
// M = K*K*Cs rows (tap-major), N = Cu columns, the pixels the contraction.
//   * K4: S = V (x through Src: border, prologue, phases), Cs = s*s*Cin;
//     U = g, Cu = Cout, [Hp, Wp] = [Ho, Wo]. D is dw [k, k, Cs, Cout].
//   * K7: S = g read with a border of K-1 (zero outside g), Cs = Cout; U = V
//     (through Src), Cu = Cin, [Hp, Wp] = [Ho+K-1, Wo+K-1]. D[(t', co), ci]
//     is dw_t[ci, t'*Cout + co]: the reduce transposes.
// Layout of the work: mma.sync m16n8k16 (bf16 in, fp32 accumulators in
// registers). The work is memory-bound (about 100 flop per byte against
// the tensor cores' ridge of about 295), so mma.sync's rate is enough, and
// its A fragment can be built in registers: two consecutive pixels of one
// row of S, a 32-bit word at any element offset. For an odd offset (odd
// dx, or an odd column origin) the word is cut from two aligned shared-
// memory words by one byte permute (__byte_perm, prmt); a dy shift is a
// whole row. No descriptor or ldmatrix needs the 16-byte alignment that a
// one-element shift breaks. Putting Cout on M instead would waste 75% of
// each 64-row wgmma at Cout = 16.
// A block owns a strip (rows x cols pixels of one image), cb channels of S
// (all K*K taps: M = K*K*cb rows) and 8*NB channels of U. It walks the strip
// in stages of TR x TC pixels: S's tile with its (K-1) halo and U's tile
// go to shared memory as bf16 through Src, then every warp runs its
// mma.sync steps on the stage. A tile starts up to 7 columns left of its
// stage, so that its source rows are read as aligned 16-byte vectors by
// cp.async (zero-filled outside x; the prologue is then applied in shared
// memory, to x's own pixels only). Where that cannot be (stride 2's phase
// images, a width not a multiple of 8, an unaligned tensor) each warp
// reads 4 lines of up to 96 pixels element by element through Src before
// it converts and stores them. The warps split M (wm groups of units:
// K m16 tiles, one per tap column dx, whose A fragments share one window
// of each row of S; see conv_dw_tc_kernel) and the stage's pixel rows
// (8 / wm groups); each strip's block adds its row groups' sums in order through shared memory
// and writes one fp32 partial [M, N] (no atomics); conv_dw_sum_kernel adds
// the strips' partials in a fixed order, so a seeded run repeats bit for
// bit. U is zero past the strip's rows and past Wp, so a ragged last k16
// step adds zeros (rows past a strip's end belong to the next strip). The
// grid is sized by the wrapper (ops/conv.py dw_tc_tiling) to about two
// waves of blocks.
// ---------------------------------------------------------------------------
namespace dwtc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TR = 8;      // pixel rows of a stage (ops/conv.py DW_TC_ROWS)
constexpr int TC = 64;     // pixel columns of a stage (DW_TC_COLS)
constexpr int ACC = 16;    // m16n8 accumulator tiles a warp holds (DW_TC_ACC)
constexpr int LINES = 4;   // lines a warp loads before it stores them
constexpr int SLACK = 16;  // elements after S's tile: odd reads past its end

// Elements of one channel's plane of rows x cols: a word count of 4 mod 8,
// so that 8 consecutive channels start in 8 distinct groups of 4 banks
// (ops/conv.py dw_tc_plane).
__host__ __device__ constexpr int plane_elems(int rows, int cols) {
  int w = (rows * cols + 1) / 2;
  w += ((4 - w) % 8 + 8) % 8;
  return 2 * w;
}

// Row stride of both tiles: a tile starts up to 7 columns left of the
// stage (its first source column a multiple of 8, for 16-byte loads), and
// S adds a halo of K-1 <= 2, so TC + 16 columns hold every read
// (ops/conv.py DW_TC_TILE_COLS).
constexpr int SC = TC + 16;

// How far left of the stage a tile starts: its first source column
// vx0 - pad then falls on a multiple of 8 (stride 1; the phase images of
// stride 2 are read element by element from the stage itself).
__host__ __device__ __forceinline__ int lead(const Src& s) {
  return s.stride == 1 ? ((-s.pad) % 8 + 8) % 8 : 0;
}

// Units (16 rows of S times the K taps dx) a warp holds for NB n8 tiles:
// at most ACC accumulator tiles, and at most 2 (the shared memory holds
// at most 75 channels of S, under 16 units: 8 warp groups of 2 take them)
// (ops/conv.py dw_tc_units_per_warp).
__host__ __device__ constexpr int units_per_warp(int k, int nb) {
  return ACC / (k * nb) < 2 ? ACC / (k * nb) : 2;
}

// Lines (channel, row) of x read through s into dst[c][row][col] (plane
// and row strides in elements): nch channels from c0, nrows rows from vy0,
// ncols (<= 96) columns from vx0, in s's V coordinates; zero where s says
// and at rows >= ylim or columns >= xlim. The prologue and its bf16
// rounding are load_v's.
template <int NROWS>
__device__ __forceinline__ void stage(const bf16* __restrict__ x,
                                      const Src& s, int b, int c0, int nch,
                                      int vy0, int vx0, int ncols, int plane,
                                      int rs, int ylim, int xlim, bf16* dst,
                                      int warp, int lane) {
  const int nlines = nch * NROWS;
  for (int l0 = warp * LINES; l0 < nlines; l0 += WARPS * LINES) {
    bf16 raw[LINES][3];
    float sc[LINES], sh[LINES];
    bool ok[LINES][3];
#pragma unroll
    for (int u = 0; u < LINES; ++u) {
      const int line = l0 + u;
      const int c = line / NROWS, ly = line - c * NROWS;
      int ci = c0 + c, py = 0, px = 0;
      if (s.stride == 2) {
        const int ph = ci / s.cin;
        ci -= ph * s.cin;
        py = ph >> 1;
        px = ph & 1;
      }
      const int vy = vy0 + ly;
      const int r = s.stride * vy + py - s.pad;
      const bool row_ok = line < nlines && vy < ylim && r >= 0 && r < s.H;
      const size_t base = row_ok ? (((size_t)b * s.cin + ci) * s.H + r) * s.W : 0;
      sc[u] = 1.f;
      sh[u] = 0.f;
      if (s.scale != nullptr && row_ok) {
        const int row = (b / s.per_group) * s.cin + ci;
        sc[u] = s.scale[row];
        sh[u] = s.shift[row];
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int j = lane + 32 * m, vx = vx0 + j;
        const int col = s.stride * vx + px - s.pad;
        ok[u][m] = row_ok && j < ncols && vx < xlim && col >= 0 && col < s.W;
        raw[u][m] = ok[u][m] ? x[base + col] : __float2bfloat16(0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < LINES; ++u) {
      const int line = l0 + u;
      if (line >= nlines) break;
      const int c = line / NROWS, ly = line - c * NROWS;
      bf16* d = dst + c * plane + ly * rs;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int j = lane + 32 * m;
        if (j >= ncols) break;
        bf16 v = raw[u][m];
        if (ok[u][m] && s.scale != nullptr) {
          // two roundings, no fma: the plain version's x*scale + shift
          float z = __fadd_rn(__fmul_rn(__bfloat162float(v), sc[u]), sh[u]);
          if (s.negslope != 1.f) z = z >= 0.f ? z : z * s.negslope;
          v = __float2bfloat16(z);
        }
        d[j] = v;
      }
    }
  }
}

// z of one bf16 pair (a 32-bit word) through the prologue, element j
// kept where keep >> j & 1, else 0.
__device__ __forceinline__ uint32_t pro_pair(uint32_t w, const Src& s,
                                             float sc, float sh, int keep) {
  float v[2] = {__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u)};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (s.scale != nullptr) {
      // two roundings, no fma: the plain version's x*scale + shift
      v[j] = __fadd_rn(__fmul_rn(v[j], sc), sh);
      if (s.negslope != 1.f && !(v[j] >= 0.f)) v[j] *= s.negslope;
    }
    if (!(keep >> j & 1)) v[j] = 0.f;
  }
  __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// stage() by 16-byte asynchronous copies (cp.async, zero-filled where the
// vector is outside x, past ylim or from xlim on): 8 columns from vx0 + 8v
// for v < RS / 8, RS the tile's row stride. Needs stride 1, W a multiple
// of 8, x 16-byte aligned and vx0 - s.pad a multiple of 8 (a vector then
// lies wholly inside or outside x's columns). The caller commits and
// waits, then runs fix_async where the prologue or a vector across xlim
// needs it.
template <int NROWS, int RS = SC>
__device__ __forceinline__ void stage_async(const bf16* __restrict__ x,
                                            const Src& s, int b, int c0,
                                            int nch, int vy0, int vx0,
                                            int plane, int ylim, int xlim,
                                            bf16* dst) {
  constexpr int NV = RS / 8;
  const int items = nch * NROWS * NV;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int line = it / NV, v = it - line * NV;
    const int c = line / NROWS, ly = line - c * NROWS;
    const int vy = vy0 + ly, r = vy - s.pad, col = vx0 + 8 * v - s.pad;
    const bool ok = vy < ylim && vx0 + 8 * v < xlim && r >= 0 && r < s.H &&
                    col >= 0 && col < s.W;
    const bf16* src =
        ok ? x + (((size_t)b * s.cin + c0 + c) * s.H + r) * s.W + col : x;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(smem_addr(dst + c * plane + ly * RS + 8 * v)),
                    "l"(src), "r"(ok ? 16 : 0) : "memory");
  }
}

// After stage_async has landed: the prologue on the vectors read from x,
// and zeros from xlim on.
template <int NROWS, int RS = SC>
__device__ __forceinline__ void fix_async(const Src& s, int b, int c0,
                                          int nch, int vy0, int vx0,
                                          int plane, int ylim, int xlim,
                                          bf16* dst) {
  constexpr int NV = RS / 8;
  const int items = nch * NROWS * NV;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int line = it / NV, v = it - line * NV;
    const int c = line / NROWS, ly = line - c * NROWS;
    const int vy = vy0 + ly, r = vy - s.pad, col = vx0 + 8 * v - s.pad;
    const int room = xlim - (vx0 + 8 * v);       // columns before xlim
    if (!(vy < ylim && room > 0 && r >= 0 && r < s.H && col >= 0 &&
          col < s.W) ||
        (s.scale == nullptr && room >= 8))
      continue;
    float sc = 1.f, sh = 0.f;
    if (s.scale != nullptr) {
      const int row = (b / s.per_group) * s.cin + c0 + c;
      sc = s.scale[row];
      sh = s.shift[row];
    }
    uint4* p = reinterpret_cast<uint4*>(dst + c * plane + ly * RS + 8 * v);
    uint4 w = *p;
    w.x = pro_pair(w.x, s, sc, sh, (room > 0) | (room > 1) << 1);
    w.y = pro_pair(w.y, s, sc, sh, (room > 2) | (room > 3) << 1);
    w.z = pro_pair(w.z, s, sc, sh, (room > 4) | (room > 5) << 1);
    w.w = pro_pair(w.w, s, sc, sh, (room > 6) | (room > 7) << 1);
    *p = w;
  }
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dw[i] = sum over the slices of partial[slice][i], in a fixed order: a
// block of 32 outputs and blockDim.y warps, warp w adding slices w, w +
// blockDim.y, ... (128-byte rows), then warp 0 the warps' sums in order.
// TRANS (K7): partial is [m][n] and dw [n][m], n < n_cols.
template <bool TRANS>
__global__ void __launch_bounds__(1024)
conv_dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                   int n_out, int n_slices, int n_cols) {
  __shared__ float red[32][33];
  const int lane = threadIdx.x, w = threadIdx.y, nw = blockDim.y;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n_out)
    for (int c = w; c < n_slices; c += nw) s += partial[(size_t)c * n_out + i];
  red[w][lane] = s;
  __syncthreads();
  if (w != 0 || i >= n_out) return;
  float t = 0.f;
  for (int j = 0; j < nw; ++j) t += red[j][lane];
  dw[TRANS ? (i % n_cols) * (n_out / n_cols) + i / n_cols : i] = t;
}

// The A fragments of K m16 tiles (dx = 0..K-1) from one window of S: a
// lane's row at word w (its element pair at 2w + PAR + dx, one row of S
// for all K taps dx), the low 8 pixels of the k16 step at w and the high 8
// at w + 4. An odd element offset is cut out of two words by the permute.
template <int K, int PAR>
__device__ __forceinline__ void cut_window(const uint32_t* sw, int w, int h,
                                           uint32_t (&a)[K][4]) {
  constexpr int NW = (PAR + K + 2) / 2;   // words the K pairs span
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    uint32_t win[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) win[i] = sw[w + 4 * hi + i];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int o = PAR + dx;
      a[dx][h + 2 * hi] = (o & 1) ? __byte_perm(win[o >> 1], win[(o >> 1) + 1],
                                                0x5432u)
                                  : win[o >> 1];
    }
  }
}

// Output row of D for S-row sr (dy = sr / nch, channel c) at tap column dx.
__device__ __forceinline__ int d_row(int sr, int dx, int nch, int K, int Cs,
                                     int ch0) {
  const int dy = sr / nch, c = sr - dy * nch;
  return (dy * K + dx) * Cs + ch0 + c;
}

// partial[strip][(t * Cs + s) * Cu + u]: this block's M x N tile of D over
// its strip (see above). M is walked in units: 16 rows of S (dy-major
// (dy, c) pairs of the block's nch channels) times the K taps dx, i.e. K
// m16 tiles whose A fragments come from one window of each row (the K
// horizontal taps share their shared-memory loads). Warp group wmi owns
// units wmi, wmi + wm, ... (at most UPW); the 8 / wm row groups split a
// stage's pixel rows. Grid: (strips, ceil(Cs / cb), ceil(Cu / (8 * NB))).
template <int K, int NB>
__global__ void __launch_bounds__(THREADS, 2)
conv_dw_tc_kernel(const bf16* __restrict__ sx, Src ss,
                  const bf16* __restrict__ ux, Src us,
                  float* __restrict__ partial, int Cs, int Cu, int Hp, int Wp,
                  int rows, int cols, int strips_y, int strips_x, int cb,
                  int wm, int s_vec, int u_vec) {
  constexpr int UPW = units_per_warp(K, NB);
  constexpr int SR = TR + K - 1;
  const int splane = plane_elems(SR, SC);
  const int uplane = plane_elems(TR, SC);
  extern __shared__ float4 smem4[];
  bf16* s_tile = reinterpret_cast<bf16*>(smem4);       // [cb][splane]
  bf16* u_tile = s_tile + cb * splane + SLACK;         // [8 NB][uplane]
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(s_tile);
  const uint32_t* uw = reinterpret_cast<const uint32_t*>(u_tile);

  const int per_image = strips_y * strips_x;
  const int b = blockIdx.x / per_image;
  const int sy = blockIdx.x % per_image / strips_x;
  const int sxi = blockIdx.x % strips_x;
  const int r0 = sy * rows, r1 = min(r0 + rows, Hp);
  const int q0 = sxi * cols, q1 = min(q0 + cols, Wp);
  const int ch0 = blockIdx.y * cb, nch = min(cb, Cs - ch0);
  const int n0 = blockIdx.z * 8 * NB, nu = min(8 * NB, Cu - n0);
  const int srows = K * nch, units = (srows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wmi = warp % wm, wk = warp / wm, nwk = WARPS / wm;
  const int gid = lane >> 2, q = lane & 3;
  const int s_lead = lead(ss), u_lead = lead(us);
  const int par = s_lead & 1;            // of every window's first element

  // The word of the window of S-rows gid and gid + 8 of each unit of this
  // warp in a stage's S tile (rows past srows read row 0: discarded).
  int aw[UPW][2];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sr = (i * wm + wmi) * 16 + gid + 8 * h;
      int off = par;
      if (sr < srows) {
        const int dy = sr / nch, c = sr - dy * nch;
        off = c * splane + dy * SC + s_lead;
      }
      aw[i][h] = off >> 1;
    }
  }
  // B's column gid of each n8 tile, likewise (one parity for all: the
  // permute only where U's tile starts an odd number of columns early)
  const int ub = (gid * uplane + u_lead) >> 1;
  float acc[UPW][K][NB][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i)
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][dx][j][e] = 0.f;

  for (int y0 = r0; y0 < r1; y0 += TR) {
    for (int x0 = q0; x0 < q1; x0 += TC) {
      __syncthreads();
      if (s_vec)
        stage_async<SR>(sx, ss, b, ch0, nch, y0, x0 - s_lead, splane,
                        0x7fffffff, 0x7fffffff, s_tile);
      else
        stage<SR>(sx, ss, b, ch0, nch, y0, x0 - s_lead, s_lead + TC + K - 1,
                  splane, SC, 0x7fffffff, 0x7fffffff, s_tile, warp, lane);
      if (u_vec)
        stage_async<TR>(ux, us, b, n0, nu, y0, x0 - u_lead, uplane, r1, q1,
                        u_tile);
      else
        stage<TR>(ux, us, b, n0, nu, y0, x0 - u_lead, u_lead + TC, uplane,
                  SC, r1, q1, u_tile, warp, lane);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      const bool s_fix = s_vec && ss.scale != nullptr;
      const bool u_fix = u_vec && (us.scale != nullptr ||
                                   (q1 - x0 + u_lead) % 8 != 0);
      if (s_fix)
        fix_async<SR>(ss, b, ch0, nch, y0, x0 - s_lead, splane, 0x7fffffff,
                      0x7fffffff, s_tile);
      if (u_fix)
        fix_async<TR>(us, b, n0, nu, y0, x0 - u_lead, uplane, r1, q1, u_tile);
      if (s_fix || u_fix) __syncthreads();
      for (int ry = wk; ry < TR && y0 + ry < r1; ry += nwk) {
#pragma unroll
        for (int kx = 0; kx < TC / 16; ++kx) {
          if (x0 + 16 * kx >= q1) break;
          const int e = (ry * SC + 16 * kx + 2 * q) >> 1;
          uint32_t bf[NB][2];
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const int w = ub + j * 4 * uplane + e;
            if (u_lead & 1) {
              bf[j][0] = __byte_perm(uw[w], uw[w + 1], 0x5432u);
              bf[j][1] = __byte_perm(uw[w + 4], uw[w + 5], 0x5432u);
            } else {
              bf[j][0] = uw[w];
              bf[j][1] = uw[w + 4];
            }
          }
#pragma unroll
          for (int i = 0; i < UPW; ++i) {
            if (i * wm + wmi >= units) break;
            uint32_t a[K][4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (par)
                cut_window<K, 1>(sw, aw[i][h] + e, h, a);
              else
                cut_window<K, 0>(sw, aw[i][h] + e, h, a);
            }
#pragma unroll
            for (int dx = 0; dx < K; ++dx)
#pragma unroll
              for (int j = 0; j < NB; ++j)
                mma16816(acc[i][dx][j], a[dx], bf[j][0], bf[j][1]);
          }
        }
      }
    }
  }

  // this strip's partial: the row groups' sums added in order (through
  // shared memory) where there are several, else each warp's own
  float* out = partial + (size_t)blockIdx.x * K * K * Cs * Cu;
  const int mr = wm * UPW * K * 16;      // rows of the tile the warps hold
  float* red = reinterpret_cast<float*>(smem4);   // [nwk][mr][8 NB]
  if (nwk > 1) __syncthreads();          // the last stage is read
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int unit = i * wm + wmi, sr = unit * 16 + gid + 8 * h;
        const int lr = (unit * K + dx) * 16 + gid + 8 * h;
        float* orow = out + (size_t)d_row(sr, dx, nch, K, Cs, ch0) * Cu + n0;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = j * 8 + 2 * q + e;
            if (nwk > 1)
              red[(wk * mr + lr) * 8 * NB + u] = acc[i][dx][j][2 * h + e];
            else if (sr < srows && u < nu)
              orow[u] = acc[i][dx][j][2 * h + e];
          }
        }
      }
    }
  }
  if (nwk == 1) return;
  __syncthreads();
  for (int idx = threadIdx.x; idx < K * srows * nu; idx += THREADS) {
    const int m = idx / nu, u = idx - m * nu;  // m = dx * srows + sr
    const int dx = m / srows, sr = m - dx * srows;
    const int lr = ((sr >> 4) * K + dx) * 16 + (sr & 15);
    float v = 0.f;
    for (int w = 0; w < nwk; ++w) v += red[(w * mr + lr) * 8 * NB + u];
    out[(size_t)d_row(sr, dx, nch, K, Cs, ch0) * Cu + n0 + u] = v;
  }
}

// Whether stage_async can read operand x through s.
inline int vec_ok(const bf16* x, const Src& s) {
  return s.stride == 1 && s.W % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <int K, int NB>
int launch_kn(const bf16* sx, const Src& ss, const bf16* ux, const Src& us,
              float* partial, float* dw, int B, int Cs, int Cu, int Hp,
              int Wp, int rows, int cols, int cb, int wm, bool trans,
              cudaStream_t stream) {
  if constexpr (K * NB > ACC) {
    return (int)cudaErrorInvalidValue;    // a unit's tiles exceed ACC
  } else {
    const int units = (K * min(cb, Cs) + 15) / 16;
    if ((wm != 1 && wm != 2 && wm != 4 && wm != 8) || cb < 1 ||
        units > wm * units_per_warp(K, NB) || rows < TR || rows % TR ||
        cols < TC || cols % TC)
      return (int)cudaErrorInvalidValue;
    const int strips_y = (Hp + rows - 1) / rows;
    const int strips_x = (Wp + cols - 1) / cols;
    const size_t stage_bytes = sizeof(bf16) *
        ((size_t)cb * plane_elems(TR + K - 1, SC) + SLACK +
         8 * NB * plane_elems(TR, SC));
    // the row groups' sums [8 / wm][wm * UPW * K * 16][8 NB] reuse the
    // stage's shared memory
    const size_t red_bytes = wm == WARPS ? 0
        : sizeof(float) * WARPS * units_per_warp(K, NB) * K * 16 * 8 * NB;
    const size_t smem = stage_bytes > red_bytes ? stage_bytes : red_bytes;
    cudaError_t e = cudaFuncSetAttribute(
        conv_dw_tc_kernel<K, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(B * strips_y * strips_x, (Cs + cb - 1) / cb,
                    (Cu + 8 * NB - 1) / (8 * NB));
    conv_dw_tc_kernel<K, NB><<<grid, THREADS, smem, stream>>>(
        sx, ss, ux, us, partial, Cs, Cu, Hp, Wp, rows, cols, strips_y,
        strips_x, cb, wm, vec_ok(sx, ss), vec_ok(ux, us));
    int err = (int)cudaGetLastError();
    if (err) return err;
    const int n_out = K * K * Cs * Cu;
    const int n_slices = (int)grid.x;
    const dim3 rblock(32, n_slices < 32 ? n_slices : 32);
    const int rgrid = (n_out + 31) / 32;
    if (trans)
      conv_dw_sum_kernel<true><<<rgrid, rblock, 0, stream>>>(
          partial, dw, n_out, n_slices, Cu);
    else
      conv_dw_sum_kernel<false><<<rgrid, rblock, 0, stream>>>(
          partial, dw, n_out, n_slices, Cu);
    return (int)cudaGetLastError();
  }
}

template <int K>
int launch_k(const bf16* sx, const Src& ss, const bf16* ux, const Src& us,
             float* partial, float* dw, int B, int Cs, int Cu, int Hp, int Wp,
             int rows, int cols, int cb, int bn, int wm, bool trans,
             cudaStream_t stream) {
#define DWTC_NB(nb)                                                        \
  case 8 * nb:                                                             \
    return launch_kn<K, nb>(sx, ss, ux, us, partial, dw, B, Cs, Cu, Hp, Wp, \
                            rows, cols, cb, wm, trans, stream);
  switch (bn) {
    DWTC_NB(1) DWTC_NB(2) DWTC_NB(3) DWTC_NB(4)
    DWTC_NB(5) DWTC_NB(6) DWTC_NB(7) DWTC_NB(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DWTC_NB
}

}  // namespace dwtc

// ---------------------------------------------------------------------------
// bf16 K3 on the tensor cores: every form (plain, pro, SAME, s2d, K3''' and
// the input gradient) as one implicit GEMM,
//   y[co, p] = sum over (t, c) of w[t, c, co] * V[c, p + (dy, dx)],
// M = Cout (16 * MT rows a block), N = the pixels, the contraction over
// (tap t = dy*K + dx, channel c of V). mma.sync m16n8k16, fp32
// accumulators in registers, y stored in bf16.
// Layout (a) of the two that fit the CHW tile: Cout on M, pixels on N.
//   * A = the weights, staged once per block (per channel chunk when V's
//     channels take several) as [co][t][c] with an odd count of 16-byte
//     units per row: ldmatrix.x4 reads each 16 x 16 fragment aligned and
//     without bank conflicts.
//   * B = V's pairs {V[c], V[c+1]} at one pixel: two 16-bit loads from
//     two channel planes of the same staged tile that K4 uses (dwtc's
//     stage/stage_async/fix_async: the halo, the lead, the prologue on x's
//     own pixels, the phase images of stride 2). A tap shift is only an
//     element offset of a 16-bit load, so no shift breaks an alignment.
//     The plane stride (4 mod 8 words) puts the four lane groups q of one
//     load in distinct banks.
//   * The accumulators hold two adjacent pixels of one channel: y is
//     stored as 32-bit words (pairs of bf16) where Wo is even.
// Why not (b), pixels on M: it needs a transpose of every staged element
// into a pixel-major tile (a scatter with bank conflicts) and an epilogue
// through shared memory for CHW stores; (a) wastes M where Cout is not a
// multiple of 16 (Cout 3, 36, 68: 81%, 25%, 15%) and pays four 16-bit
// loads per n8 fragment, against the same staging as K4.
// What bounds it: at [2,36,896,896]->16 the call moves 167 MB (0.05 ms at
// 3.35 TB/s) for 16.6 GFLOP (0.017 ms at the bf16 tensor rate); the
// staging's halo reads about 1.25 x 1.25 of the input (mostly from L2),
// and the B loads (one 16-bit load per wavefront) are the busiest
// shared-memory traffic.
// Work: a block owns a strip of rows x cols output pixels of one image and
// MT m16 tiles of Cout (all of Cout up to 80; wider outputs split into
// evened chunks); it walks the strip in stages of TR x 8*NB pixels, warp w
// owning stage row w (NB n8 tiles, all MT m16 tiles: at most 16
// accumulator tiles). Each stage walks V's channels in chunks of cb (a
// multiple of 16, padded with zero planes), staging the tile with its K-1
// halo; the (stage, chunk) units run as a two-buffer pipeline, the next
// unit's 16-byte copies in flight during this one's products (staging, not
// the products, took most of the time before). The weights stay resident
// where they fit beside the two buffers. The K3''' epilogue adds each
// stage's bf16-rounded outputs and their squares per channel across the
// lanes q, then into the warp's own shared-memory slot; the 8 warps'
// slots are added in order into the strip's row of st_part (no atomics);
// conv_stats_reduce_kernel adds the strips of a stack. The tiling comes
// from ops/conv.py fwd_tc_tiling (about two waves of blocks).
// ---------------------------------------------------------------------------
namespace fwdtc {

using dwtc::bf16;
using dwtc::THREADS;
constexpr int TR = 8;        // output rows of a stage, one per warp (ops/conv.py FWD_TC_ROWS)
constexpr int BIG = 1 << 30;   // no row or column limit (ylim, xlim)

// n8 tiles of a warp beside MT m16 tiles: at most 16 accumulator tiles
// and 8 n8 tiles (ops/conv.py fwd_tc_nb).
__host__ __device__ constexpr int nb_of(int mt) {
  return 16 / mt < 8 ? 16 / mt : 8;
}

// Row stride of V's tile: a stage's 8*NB columns, the lead (<= 7) and the
// halo (<= 2) in whole 16-byte vectors (ops/conv.py fwd_tc_tile_cols).
__host__ __device__ constexpr int tile_cols(int mt) { return 8 * nb_of(mt) + 16; }

// Row stride of the weight tile [co][t][c] for cb channels: an odd count
// of 16-byte units (cb is a multiple of 16).
__host__ __device__ constexpr int w_stride(int k, int cb) { return k * k * cb + 8; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The weights of channels [c0, c0 + cb) and output channels [co0, co0 +
// mrows) into dst[co][t * cb + c]; zero past Cv and past Cout.
template <int K>
__device__ __forceinline__ void stage_w(const bf16* __restrict__ w, bf16* dst,
                                        int mrows, int co0, int Cout, int Cv,
                                        int c0, int cb) {
  const int ws = w_stride(K, cb), n = mrows * K * K * cb;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int co = i % mrows, rest = i / mrows;   // co fastest: coalesced
    const int c = rest % cb, t = rest / cb;
    bf16 v = __float2bfloat16(0.f);
    if (co0 + co < Cout && c0 + c < Cv)
      v = w[((size_t)t * Cv + c0 + c) * Cout + co0 + co];
    dst[co * ws + t * cb + c] = v;
  }
}

// Grid: (B * strips_y * strips_x, ceil(Cout / (16 * MT))). wcb: V's
// channels per tap in the weight tile: all of them (a multiple of 16 >= Cv,
// staged once) or cb (staged with each chunk). vec: x can be staged by
// 16-byte copies (dwtc::vec_ok); vec_out: y takes 32-bit stores.
template <int K, int MT>
__global__ void __launch_bounds__(THREADS, 2)
conv_fwd_tc_kernel(const bf16* __restrict__ x, Src src,
                   const bf16* __restrict__ w, bf16* __restrict__ y,
                   float* __restrict__ st_part, int Cv, int Cout, int Ho,
                   int Wo, int rows, int cols, int strips_y, int strips_x,
                   int cb, int wcb, int vec, int vec_out) {
  constexpr int NB = nb_of(MT), TCW = 8 * NB, RS = tile_cols(MT);
  constexpr int SR = TR + K - 1, MROWS = 16 * MT;
  // compile-time plane stride: the B loads take immediate offsets
  constexpr int plane = dwtc::plane_elems(SR, RS);
  const int ws = w_stride(K, wcb);
  extern __shared__ float4 smem4[];
  const int vbuf = (cb * plane + 7) & ~7;     // elements of a V buffer
  bf16* v_tile = reinterpret_cast<bf16*>(smem4);   // 2 x [cb][plane]
  bf16* w_tile = v_tile + 2 * vbuf;                 // [MROWS][ws]
  // K3''': [8 warps][sum, squares][MROWS], each warp's own rows
  float* red = reinterpret_cast<float*>(w_tile + MROWS * ws);

  const int per_image = strips_y * strips_x;
  const int b = blockIdx.x / per_image;
  const int sy = blockIdx.x % per_image / strips_x;
  const int sxi = blockIdx.x % strips_x;
  const int r0 = sy * rows, r1 = min(r0 + rows, Ho);
  const int q0 = sxi * cols, q1 = min(q0 + cols, Wo);
  const int co0 = blockIdx.y * MROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, q = lane & 3;
  const int lead = dwtc::lead(src);
  const bool w_once = wcb >= Cv;

  // ldmatrix: lane l gives row (l & 7) + (l & 8) and column 8 * (l >> 4)
  // of the 16 x 16 fragment (matrices a0..a3 in mma's order); m16 tile i
  // is 16 * ws elements further
  const uint32_t a_lane = dwtc::smem_addr(
      w_tile + ((lane & 7) + (lane & 8)) * ws + ((lane >> 4) << 3));
  const uint32_t a_tile = 2 * 16 * ws;     // bytes
  // B: this lane's element (channel 2q, tap (0, 0), column gid of n8
  // tile 0, stage row `warp`) in a V buffer
  const int b_lane = 2 * q * plane + warp * RS + lead + gid;

  if (st_part != nullptr)
    for (int i = threadIdx.x; i < (THREADS / 32) * 2 * MROWS; i += THREADS)
      red[i] = 0.f;
  if (w_once) stage_w<K>(w, w_tile, MROWS, co0, Cout, Cv, 0, wcb);

  // The block's units of work, (stage, chunk of V's channels) stage-major,
  // run as a pipeline over two V buffers: unit u + 1's 16-byte copies are
  // in flight while unit u's products run. (The element-wise path stages
  // each unit in its turn.)
  const int n_cc = (Cv + cb - 1) / cb;
  const int sx_n = (q1 - q0 + TCW - 1) / TCW;
  const int units = (r1 - r0 + TR - 1) / TR * sx_n * n_cc;
  const auto stage_unit = [&](int u) {
    const int s = u / n_cc, c0 = (u - s * n_cc) * cb;
    const int y0 = r0 + TR * (s / sx_n), x0 = q0 + TCW * (s % sx_n);
    bf16* dst = v_tile + (u & 1) * vbuf;
    if (vec)
      dwtc::stage_async<SR, RS>(x, src, b, c0, min(cb, Cv - c0), y0,
                                x0 - lead, plane, BIG, BIG, dst);
    else
      dwtc::stage<SR>(x, src, b, c0, min(cb, Cv - c0), y0, x0 - lead,
                      lead + TCW + K - 1, plane, RS, BIG, BIG, dst, warp,
                      lane);
  };
  if (vec) {
    stage_unit(0);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  float acc[MT][NB][4];
  for (int u = 0; u < units; ++u) {
    const int s = u / n_cc, ci = u - s * n_cc, c0 = ci * cb;
    const int y0 = r0 + TR * (s / sx_n), x0 = q0 + TCW * (s % sx_n);
    const int nch = min(cb, Cv - c0), nchp = (nch + 15) & ~15;
    bf16* buf = v_tile + (u & 1) * vbuf;
    if (vec) {
      if (u + 1 < units) stage_unit(u + 1);
      // every group but the newest (unit u + 1's) has landed
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::: "memory");
    } else {
      stage_unit(u);
    }
    if (!w_once) stage_w<K>(w, w_tile, MROWS, co0, Cout, Cv, c0, wcb);
    for (int i = threadIdx.x; i < (nchp - nch) * plane; i += THREADS)
      buf[nch * plane + i] = __float2bfloat16(0.f);
    __syncthreads();
    if (vec && src.scale != nullptr) {
      dwtc::fix_async<SR, RS>(src, b, c0, nch, y0, x0 - lead, plane, BIG,
                              BIG, buf);
      __syncthreads();
    }
    if (ci == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    const int oy = y0 + warp;
    if (oy < r1) {                        // rows past the strip: no work
      // tap-major, the 16-channel steps inside: each tap's addresses
      // live only through its loop
      const unsigned short* vu =
          reinterpret_cast<const unsigned short*>(buf) + b_lane;
      const uint32_t a_chunk = a_lane + 2 * (w_once ? c0 : 0);
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const unsigned short* vt = vu + dy * RS + dx;
          const uint32_t at = a_chunk + 2 * (dy * K + dx) * wcb;
          for (int c16 = 0; c16 < nchp; c16 += 16) {
            const unsigned short* vp = vt + c16 * plane;
            const uint32_t ap = at + 2 * c16;
            if constexpr (4 * MT <= 2 * NB) {
              // the A fragments first (fewer registers than B's)
              uint32_t a[MT][4];
#pragma unroll
              for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], ap + i * a_tile);
#pragma unroll
              for (int j = 0; j < NB; ++j) {
                const unsigned short* p = vp + 8 * j;
                const uint32_t b0 = p[0] | (uint32_t)p[plane] << 16;
                const uint32_t b1 = p[8 * plane] | (uint32_t)p[9 * plane] << 16;
#pragma unroll
                for (int i = 0; i < MT; ++i)
                  dwtc::mma16816(acc[i][j], a[i], b0, b1);
              }
            } else {
              uint32_t bf[NB][2];
#pragma unroll
              for (int j = 0; j < NB; ++j) {
                const unsigned short* p = vp + 8 * j;
                bf[j][0] = p[0] | (uint32_t)p[plane] << 16;
                bf[j][1] = p[8 * plane] | (uint32_t)p[9 * plane] << 16;
              }
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                uint32_t a[4];
                ldmatrix_x4(a, ap + i * a_tile);
#pragma unroll
                for (int j = 0; j < NB; ++j)
                  dwtc::mma16816(acc[i][j], a, bf[j][0], bf[j][1]);
              }
            }
          }
        }
      }
    }
    if (ci == n_cc - 1 && oy < r1) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = co0 + 16 * i + gid + 8 * h;
          float s1 = 0.f, s2 = 0.f;       // this stage's K3''' sums
          if (co < Cout) {
            bf16* yrow = y + (((size_t)b * Cout + co) * Ho + oy) * Wo;
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int ox = x0 + 8 * j + 2 * q;
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  acc[i][j][2 * h], acc[i][j][2 * h + 1]);
              const bool ok0 = ox < q1, ok1 = ox + 1 < q1;
              if (vec_out && ok1) {
                *reinterpret_cast<__nv_bfloat162*>(yrow + ox) = v;
              } else {
                if (ok0) yrow[ox] = v.x;
                if (ok1) yrow[ox + 1] = v.y;
              }
              // the sums of the stored (bf16-rounded) values
              const float f0 = ok0 ? __bfloat162float(v.x) : 0.f;
              const float f1 = ok1 ? __bfloat162float(v.y) : 0.f;
              s1 += f0 + f1;
              s2 += f0 * f0 + f1 * f1;
            }
          }
          if (st_part == nullptr) continue;
          // the four lanes q of the row, then into this warp's slot
          s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
          s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
          s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
          if (q == 0) {
            const int r = 16 * i + gid + 8 * h;
            red[(warp * 2 + 0) * MROWS + r] += s1;
            red[(warp * 2 + 1) * MROWS + r] += s2;
          }
        }
      }
    }
    __syncthreads();     // this buffer (and a chunk's weights) is read
  }
  if (st_part == nullptr) return;
  // K3''': the strip's sums per channel, the 8 warps' slots in order
  __syncthreads();
  if (threadIdx.x < 2 * MROWS) {
    const int which = threadIdx.x / MROWS, c = threadIdx.x % MROWS;
    float t = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) t += red[(i * 2 + which) * MROWS + c];
    if (co0 + c < Cout)
      st_part[((size_t)blockIdx.x * 2 + which) * Cout + co0 + c] = t;
  }
}

// Shared memory of a block: two buffers of V's chunk, the weight tile, the
// K3''' slots (ops/conv.py fwd_tc_smem).
__host__ __forceinline__ size_t smem_bytes(int k, int mt, int cb, int wcb) {
  const size_t v = (size_t)cb * dwtc::plane_elems(TR + k - 1, tile_cols(mt));
  return sizeof(bf16) * (2 * ((v + 7) & ~(size_t)7) + (size_t)16 * mt * w_stride(k, wcb)) +
         sizeof(float) * (THREADS / 32) * 2 * 16 * mt;
}

template <int K, int MT>
int launch_km(const bf16* x, const Src& src, const bf16* w, bf16* y,
              float* st_part, float* stats, int B, int Cout, int Ho, int Wo,
              int rows, int cols, int cb, int wcb, cudaStream_t stream) {
  constexpr int TCW = 8 * nb_of(MT);
  const int Cv = src.stride * src.stride * src.cin;
  if (rows < TR || rows % TR || cols < TCW || cols % TCW || cb < 16 ||
      cb % 16 || (wcb != cb && wcb < Cv) || wcb % 16)
    return (int)cudaErrorInvalidValue;
  const int strips_y = (Ho + rows - 1) / rows;
  const int strips_x = (Wo + cols - 1) / cols;
  const size_t smem = smem_bytes(K, MT, cb, wcb);
  cudaError_t e = cudaFuncSetAttribute(
      conv_fwd_tc_kernel<K, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * strips_y * strips_x, (Cout + 16 * MT - 1) / (16 * MT));
  const int vec_out = Wo % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  conv_fwd_tc_kernel<K, MT><<<grid, THREADS, smem, stream>>>(
      x, src, w, y, st_part, Cv, Cout, Ho, Wo, rows, cols, strips_y,
      strips_x, cb, wcb, dwtc::vec_ok(x, src), vec_out);
  int err = (int)cudaGetLastError();
  if (err || st_part == nullptr) return err;
  const int groups = B / src.per_group;
  conv_stats_reduce_kernel<<<groups * 2 * Cout, NT, 0, stream>>>(
      st_part, stats, src.per_group * strips_y * strips_x, Cout);
  return (int)cudaGetLastError();
}

// mt: m16 tiles of Cout a block holds, 1 to 5 (ops/conv.py FWD_TC_MT).
template <int K>
int launch_k(const bf16* x, const Src& src, const bf16* w, bf16* y,
             float* st_part, float* stats, int B, int Cout, int Ho, int Wo,
             int rows, int cols, int cb, int wcb, int mt,
             cudaStream_t stream) {
  switch (mt) {
    case 1: return launch_km<K, 1>(x, src, w, y, st_part, stats, B, Cout, Ho,
                                   Wo, rows, cols, cb, wcb, stream);
    case 2: return launch_km<K, 2>(x, src, w, y, st_part, stats, B, Cout, Ho,
                                   Wo, rows, cols, cb, wcb, stream);
    case 3: return launch_km<K, 3>(x, src, w, y, st_part, stats, B, Cout, Ho,
                                   Wo, rows, cols, cb, wcb, stream);
    case 4: return launch_km<K, 4>(x, src, w, y, st_part, stats, B, Cout, Ho,
                                   Wo, rows, cols, cb, wcb, stream);
    case 5: return launch_km<K, 5>(x, src, w, y, st_part, stats, B, Cout, Ho,
                                   Wo, rows, cols, cb, wcb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fwdtc

}  // namespace

// The rows of K3''' scratch (one per output tile) that a [B, Cout, Ho, Wo]
// output needs: dtype 0 (fp32, conv_valid_fwd) tiles of TH x TW, dtype 1
// (bf16, conv_fwd_tc) strips of rows x cols; an image's tiles are
// contiguous.
extern "C" int conv_stats_scratch_tiles(int B, int Ho, int Wo, int dtype,
                                        int rows, int cols) {
  if (dtype == 0) rows = TH, cols = TW;
  return B * ((Ho + rows - 1) / rows) * ((Wo + cols - 1) / cols);
}

// fp32 K3 (the CUDA cores). x [B,Cin,H,W]; scale/shift: fp32 [groups, Cin]
// or null (no prologue); stride 1 or 2; w [k,k,s*s*Cin,Cout]; y
// [B,Cout,Ho,Wo] with Ho + k - 1 <= (H + 2pad) / stride rounded up, and
// likewise Wo; all fp32. st_part/stats: null, or (K3''') fp32 scratch
// [conv_stats_scratch_tiles(B, Ho, Wo, 0, 0, 0), 2, Cout] and the output
// [groups, 2, Cout]: per BatchNorm stack the sum and the sum of squares of
// y.
extern "C" int conv_valid_fwd(const void* x, const void* w, void* y,
                              const float* scale, const float* shift, int B,
                              int Cin, int H, int W, int Cout, int Ho, int Wo,
                              int k, int pad, int stride, int groups,
                              float negslope, float* st_part, float* stats,
                              void* stream) {
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  return launch_fwd(x, w, y, st_part, stats, src, B, Cout, Ho, Wo, k,
                    static_cast<cudaStream_t>(stream));
}

// bf16 K3 on the tensor cores: as conv_valid_fwd, with x, w and y bf16 and
// k in {1, 2, 3}. The tiling comes from ops/conv.py fwd_tc_tiling: strips
// of rows x cols output pixels (rows a multiple of 8, cols of 8 *
// fwd_tc_nb(mt)), cb (a multiple of 16) channels of V per shared-memory
// chunk, wcb channels per tap in the weight tile (cb, or a multiple of 16
// >= s*s*Cin: all of them, staged once), mt in [1, 5] m16 tiles of Cout
// per block. st_part:
// [conv_stats_scratch_tiles(B, Ho, Wo, 1, rows, cols), 2, Cout].
extern "C" int conv_fwd_tc(const void* x, const void* w, void* y,
                           const float* scale, const float* shift, int B,
                           int Cin, int H, int W, int Cout, int Ho, int Wo,
                           int k, int pad, int stride, int groups,
                           float negslope, float* st_part, float* stats,
                           int rows, int cols, int cb, int wcb, int mt,
                           void* stream) {
  using fwdtc::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  switch (k) {
    case 1: return fwdtc::launch_k<1>(xb, src, wb, yb, st_part, stats, B,
                                      Cout, Ho, Wo, rows, cols, cb, wcb, mt,
                                      st);
    case 2: return fwdtc::launch_k<2>(xb, src, wb, yb, st_part, stats, B,
                                      Cout, Ho, Wo, rows, cols, cb, wcb, mt,
                                      st);
    case 3: return fwdtc::launch_k<3>(xb, src, wb, yb, st_part, stats, B,
                                      Cout, Ho, Wo, rows, cols, cb, wcb, mt,
                                      st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 K7 (the CUDA cores). x, scale, shift, pad, groups, negslope: as
// conv_valid_fwd at stride 1; x and g [B,Cout,Ho,Wo] fp32; partial: fp32
// scratch [B*ceil((Ho+k-1)/rows_per_chunk), Cin*k*k*Cout]; dw: fp32
// [Cin, k*k*Cout] with tap t' = dy'*k + dx' holding dw's tap (k-1-dy',
// k-1-dx') (the caller reverses). k in {2, 3}.
extern "C" int conv_dw_gtap(const void* x, const void* g, float* partial,
                            float* dw, const float* scale, const float* shift,
                            int B, int Cin, int H, int W, int Cout, int Ho,
                            int Wo, int k, int pad, int groups, float negslope,
                            int rows_per_chunk, void* stream) {
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, 1, groups,
                           negslope);
  return launch_dw_gtap<float>(x, g, partial, dw, src, B, Cout, Ho, Wo, k,
                               rows_per_chunk,
                               static_cast<cudaStream_t>(stream));
}

// fp32 K4 (the CUDA cores). x, scale, shift, pad, stride, groups,
// negslope: as conv_valid_fwd, x fp32; g [B,Cout,Ho,Wo] fp32; partial: fp32
// scratch [B*ceil(Ho/rows_per_chunk), k*k*s*s*Cin*Cout]; dw: fp32
// [k,k,s*s*Cin,Cout]. k in {1, 2, 3}.
extern "C" int conv_dw(const void* x, const void* g, float* partial,
                       float* dw, const float* scale, const float* shift,
                       int B, int Cin, int H, int W, int Cout, int Ho, int Wo,
                       int k, int pad, int stride, int groups, float negslope,
                       int rows_per_chunk, void* stream) {
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  return launch_dw<float>(x, g, partial, dw, src, B, Cout, Ho, Wo, k,
                          rows_per_chunk, static_cast<cudaStream_t>(stream));
}

// bf16 K4 (gtap = 0: dw [k,k,s*s*Cin,Cout], as conv_dw) and K7 (gtap = 1,
// stride 1, k in {2, 3}: dw [Cin, k*k*Cout], as conv_dw_gtap) on the tensor
// cores. x, g, scale, shift, pad, stride, groups, negslope: as conv_dw,
// x and g bf16. The tiling comes from ops/conv.py dw_tc_tiling: strips of
// rows x cols pixels of the contraction's extent (Ho x Wo for K4, (Ho+k-1)
// x (Wo+k-1) for K7), cb channels of the tapped operand and bn in {8, 16,
// ..., 64} of the other per block, wm warps along M. partial: fp32 scratch
// [B*ceil(Hp/rows)*ceil(Wp/cols), k*k*Cs*Cu].
extern "C" int conv_dw_tc(const void* x, const void* g, float* partial,
                          float* dw, const float* scale, const float* shift,
                          int B, int Cin, int H, int W, int Cout, int Ho,
                          int Wo, int k, int pad, int stride, int groups,
                          float negslope, int gtap, int rows, int cols, int cb,
                          int bn, int wm, void* stream) {
  using dwtc::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src xs = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                          negslope);
  // g through the same mapping: no prologue, zero outside its extent, and
  // for K7 the border k-1 of the tapped cotangent
  const Src gs = make_src(nullptr, nullptr, B, Cout, Ho, Wo,
                          gtap ? k - 1 : 0, 1, 1, 1.f);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  if (gtap && (stride != 1 || k < 2)) return (int)cudaErrorInvalidValue;
  const int Cs = gtap ? Cout : stride * stride * Cin;
  const int Cu = gtap ? Cin : Cout;
  const int Hp = gtap ? Ho + k - 1 : Ho, Wp = gtap ? Wo + k - 1 : Wo;
  const bf16* sx = gtap ? gb : xb;
  const bf16* ux = gtap ? xb : gb;
  const Src& ss = gtap ? gs : xs;
  const Src& us = gtap ? xs : gs;
  switch (k) {
    case 1: return dwtc::launch_k<1>(sx, ss, ux, us, partial, dw, B, Cs, Cu,
                                     Hp, Wp, rows, cols, cb, bn, wm, gtap, st);
    case 2: return dwtc::launch_k<2>(sx, ss, ux, us, partial, dw, B, Cs, Cu,
                                     Hp, Wp, rows, cols, cb, bn, wm, gtap, st);
    case 3: return dwtc::launch_k<3>(sx, ss, ux, us, partial, dw, B, Cs, Cu,
                                     Hp, Wp, rows, cols, cb, bn, wm, gtap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
