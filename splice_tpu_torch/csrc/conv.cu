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
// K3 (conv_fwd_tc or conv_fwd_px in bf16, conv_fwd_tf32 in fp32)
// replaces _make_conv_kernel (:157, launched by
// _conv_fwd_impl :276): the plain VALID form (conv_valid_chw :707), its
// has_pro form (conv_pro_valid_chw :852) and the k2 = 2 space-to-depth
// form of pallas_conv_chw / pallas_conv_bn_act_chw. It also computes the
// input gradient: the wrapper passes the cotangent with an implicit border
// and the flipped, io-swapped kernel (_conv_bwd :719-729, _convp_bwd
// :873-896).
// K4 (conv_dw_tc, conv_dw_px or conv_dw_wg in bf16, conv_dw_tf32 in fp32)
// replaces _make_dw_kernel (:401, launched by _dw_impl :630),
// with and without the prologue (recomputed on the read, as the TPU kernel
// does) and at any k, as the reference's kernels take any k (the training
// net's 3x3 and 1x1 and its stride-2 k2 = 2 on conv_dw_tc; 16 taps or more
// and the k2 = 3 phase kernels, e.g. the inversion net's 7x7 and 5x5 and
// their k2 = 4 and 3, on conv_dw_px):
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
// K7 (conv_dw_tc, conv_dw_px or conv_dw_wg in bf16, conv_dw_tf32 with gtap
// in fp32) replaces _make_dw_kernel_gtap (:455, launched by
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
// about 295, so in bf16 the bound is the memory traffic; fp32 runs three
// TF32 products a product (split TF32), 3 x the flops at 495 TFLOP/s, and
// its bound is the arithmetic. Two routes, chosen by dtype:
//   * bf16 runs on the tensor cores (mma.sync): K3 in every form through
//     conv_fwd_tc (namespace fwdtc) at k <= 3 and conv_fwd_px (namespace
//     px) at k >= 4 and the k2 = 3 phase kernels, K4 likewise through
//     conv_dw_tc (namespace dwtc) or conv_dw_px, K7 through conv_dw_tc at
//     k in {2, 3, 5, 7} and through conv_dw_px's cotangent-tapped mode at
//     every other k >= 2; on large maps at k >= 8, K4 and K7 through
//     conv_dw_wg (namespace wgdw, wgmma and TMA). fwdtc and dwtc stage x
//     through Src into the same channel-major bf16 tiles, px into
//     pixel-major ones; each is described above its kernel.
//   * fp32 K3, K4 and K7 run on the tensor cores too, in split TF32
//     (three mma.sync m16n8k8 .tf32 products a product, tf32.cuh, which
//     keep the fp32 steps' 1e-4 gates): conv_fwd_tf32 and conv_dw_tf32
//     (namespace tc32; K7 is conv_dw_tf32's cotangent-tapped mode), every
//     form at any k (K7 at any k >= 2), described above their
//     kernels.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "tf32.cuh"

constexpr int NT = 256;

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
// S adds a halo of K-1 <= 6, so TC + 16 columns hold every read
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
// rounding are the plain version's (two roundings, no fma).
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
// halo (<= 6) in whole 16-byte vectors (ops/conv.py fwd_tc_tile_cols).
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

// ---------------------------------------------------------------------------
// bf16 K3 and K4 at 16 taps or more (k >= 4), and at the 9-tap phase kernels
// of 5x5 and 6x6 filters at stride 2 (k2 = 3): namespace px, the forms that
// ops/conv.py conv_route picks there. They replace _make_conv_kernel (:157)
// and _make_dw_kernel (:401) at the inversion net's sites (its 7x7 and 5x5
// filters and their phase kernels k2 = 4 and 3) and take every such k at run
// time, so any filter size the reference's kernels take runs here.
// What bounds them: at those sites (maps of 252-62,944 output pixels, B = 1)
// a call moves 0.1-5 MB and does 0.15-3.6 GFLOP, under 6 us of either at
// the card's rates; the channel-major forms (fwdtc, dwtc) took 30-210 us,
// 4-12x the library, because their grid (strips of whole 8 x 64 stages,
// Cout on M) gave 4-42
// blocks on 132 SMs, each block walked the whole contraction (k*k taps x
// up to 256 channels) in series, re-staging its weights with each channel
// chunk where they did not fit 110 KB, and read every B fragment as four
// 16-bit loads. The design answers each:
//   * V is staged pixel-major: pixel (r, c) of the tile holds its 16
//     channels of a chunk in one 48-byte row (16 + 8 elements: 8 rows of an
//     ldmatrix land in 8 distinct 16-byte bank groups). A tap shift (dy, dx)
//     is then a row offset, so every fragment is one ldmatrix at any k:
//     K3's B (k16 = channels, n8 = pixels) by ldmatrix.x4, K4's A (m16 =
//     channels, k16 = pixels) by ldmatrix.x4.trans. mma.sync m16n8k16, not
//     wgmma: K3's M is Cout (16-132; a 64-row wgmma would waste 75% at the
//     Cout = 16 sites) and the tap shift moves B's rows by one pixel, which
//     a wgmma descriptor (8-row core matrices) cannot address.
//   * The contraction is split across blocks as well as pixels and Cout:
//     K3 by groups of tap rows dy (as few as fit) and channel chunks of 16,
//     at most 8 splits, which run as one thread-block cluster: each block
//     leaves its fp32 tile in shared memory and the cluster adds the tiles
//     in rank order through distributed shared memory and stores y (more
//     splits, or the K3''' sums, write fp32 partials that
//     conv_split_sum_kernel adds in a fixed order); K4 by channel groups
//     of 16, tap-row groups and output-channel chunks beside pixel strips
//     (conv_dw_sum_kernel adds the strips, as for dwtc). The grids aim at
//     one or two blocks per SM with little partial traffic (ops/conv.py
//     fwd_px_tiling, dw_px_tiling); a block whose split is the whole
//     contraction stores y directly. No atomics: a seeded run repeats bit
//     for bit.
//   * Every global load that feeds shared memory reads a clamped, valid
//     address and a select zeroes what lies outside (no branch between the
//     loads): with a branch after each load, a thread's 32 loads ran one
//     after another.
//   * Each block stages a channel chunk's weights for its taps once (K3:
//     [tap][c][co], co contiguous as in w, read by ldmatrix.trans), by
//     16-byte cp.async where Cout allows, into a two-stage ring; the next
//     unit's V is loaded into registers before the products of this one and
//     stored into the ring's other stage after them, so the copies overlap
//     the products. K4 walks its strip's 8 x 32 stages the same way, V and
//     g both prefetched into registers.
// ---------------------------------------------------------------------------
namespace px {

using dwtc::bf16;
using dwtc::mma16816;
using dwtc::smem_addr;
constexpr int THREADS = 256;
constexpr int TR = 8;        // K3: output rows of a tile (one a warp); K4: pixel rows of a stage (ops/conv.py PX_ROWS)
constexpr int TC = 32;       // K3: output columns of a tile (4 n8 tiles a warp); K4: pixel columns of a stage (PX_COLS)
constexpr int CS = 24;       // elements of a staged pixel: 16 channels + 8 (PX_PIXEL)
constexpr int ITEMS = 2;     // pixels of a V tile a thread holds: tiles up to 512 pixels (PX_ITEMS)
constexpr int GC = TC + 8;   // K4: row stride of g's tile [co][row][col]
constexpr int GP = TR * GC + 8;   // K4: its channel stride, 41 16-byte units (odd)
constexpr int CLUSTER = 8;   // K3: splits a cluster adds in shared memory (PX_CLUSTER)

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// Channels [c0, c0 + 16) of V at this thread's pixels p = threadIdx.x +
// THREADS * m of a tile of ncols columns from (vy0, vx0), as bf16 pairs:
// zero past cv, past npix and outside x; the prologue and its rounding as
// the plain version's (two roundings, no fma). Every load reads a clamped, valid
// address and a select zeroes what lies outside, so no branch separates
// the loads and all 16 x ITEMS are in flight together; the prologue, where
// there is one, is a second pass over the words.
__device__ __forceinline__ void load_v16(const bf16* __restrict__ x,
                                         const Src& s, int b, int c0, int cv,
                                         int vy0, int vx0, int npix,
                                         int ncols, uint32_t (&wd)[ITEMS][8]) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  int ry[ITEMS], rx[ITEMS];
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    const int p = threadIdx.x + THREADS * m, r = p / ncols;
    ry[m] = p < npix ? s.stride * (vy0 + r) - s.pad : -(1 << 28);
    rx[m] = s.stride * (vx0 + p - r * ncols) - s.pad;
  }
  uint32_t okbits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + j;
    int ci = c, py = 0, pxo = 0;
    if (s.stride == 2) {
      const int ph = c / s.cin;
      ci = c - ph * s.cin;
      py = ph >> 1;
      pxo = ph & 1;
    }
    const bool cok = c < cv;
    const unsigned short* plane =
        xs + ((size_t)b * s.cin + (cok ? ci : 0)) * s.H * s.W;
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
      const int r = ry[m] + py, col = rx[m] + pxo;
      const bool ok = cok && r >= 0 && r < s.H && col >= 0 && col < s.W;
      const int rc = min(max(r, 0), s.H - 1), cc = min(max(col, 0), s.W - 1);
      const uint32_t raw = __ldg(plane + (size_t)rc * s.W + cc);
      const uint32_t v = ok ? raw : 0u;
      okbits |= (uint32_t)ok << (j * ITEMS + m);
      if (j & 1) wd[m][j >> 1] |= v << 16;
      else wd[m][j >> 1] = v;
    }
  }
  if (s.scale == nullptr) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = min(c0 + j, cv - 1);
    const int ci = s.stride == 2 ? c - (c / s.cin) * s.cin : c;
    const int row = (b / s.per_group) * s.cin + ci;
    const float sc = s.scale[row], sh = s.shift[row];
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
      if (!(okbits >> (j * ITEMS + m) & 1)) continue;
      const int sh16 = (j & 1) * 16;
      float z = __fadd_rn(__fmul_rn(
          __uint_as_float((wd[m][j >> 1] >> sh16 & 0xffffu) << 16), sc), sh);
      if (s.negslope != 1.f) z = z >= 0.f ? z : z * s.negslope;
      const uint32_t v = __bfloat16_as_ushort(__float2bfloat16(z));
      wd[m][j >> 1] = (wd[m][j >> 1] & ~(0xffffu << sh16)) | v << sh16;
    }
  }
}

// load_v16's pixels into the pixel-major tile dst (CS elements a pixel).
__device__ __forceinline__ void store_v16(bf16* dst, int npix,
                                          const uint32_t (&wd)[ITEMS][8]) {
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    const int p = threadIdx.x + THREADS * m;
    if (p >= npix) continue;
    uint4* d = reinterpret_cast<uint4*>(dst + p * CS);
    d[0] = make_uint4(wd[m][0], wd[m][1], wd[m][2], wd[m][3]);
    d[1] = make_uint4(wd[m][4], wd[m][5], wd[m][6], wd[m][7]);
  }
}

// K3's weights of taps [t0, t0 + ntaps), channels [c0, c0 + 16) and output
// channels [co0, co0 + 16 MT) into dst[tap][c][co] (row stride 16 MT + 8):
// 16-byte cp.async where vec (Cout a multiple of 8, w 16-byte aligned),
// else element by element; zero past cv and Cout.
template <int MT>
__device__ __forceinline__ void stage_w(const bf16* __restrict__ w, bf16* dst,
                                        int t0, int ntaps, int c0, int cv,
                                        int co0, int cout, bool vec) {
  constexpr int MROWS = 16 * MT, WS = MROWS + 8, NV = 2 * MT;
  const int rows = ntaps * 16;
  if (vec) {
    for (int it = threadIdx.x; it < rows * NV; it += THREADS) {
      const int row = it / NV, v = it - row * NV;
      const int c = c0 + (row & 15), co = co0 + 8 * v;
      const bool ok = c < cv && co < cout;
      const bf16* src =
          ok ? w + ((size_t)(t0 + (row >> 4)) * cv + c) * cout + co : w;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(smem_addr(dst + row * WS + 8 * v)), "l"(src),
                      "r"(ok ? 16 : 0) : "memory");
    }
  } else {
    for (int it = threadIdx.x; it < rows * MROWS; it += THREADS) {
      const int row = it / MROWS, o = it - row * MROWS;
      const int c = c0 + (row & 15), co = co0 + o;
      dst[row * WS + o] = (c < cv && co < cout)
          ? w[((size_t)(t0 + (row >> 4)) * cv + c) * cout + co]
          : __float2bfloat16(0.f);
    }
  }
}

// The fragments of K3's tap tl: MT m16 tiles of the weights (A, by
// ldmatrix.trans from [tap][c][co]) and 4 n8 tiles of V (B, by ldmatrix
// from the pixel-major tile at the tap's shift boff, in elements).
template <int MT>
__device__ __forceinline__ void frag_fwd(uint32_t (&a)[MT][4],
                                         uint32_t (&bq)[2][4], uint32_t wb,
                                         uint32_t vb, int tl, int boff) {
  constexpr int WS = 16 * MT + 8;
#pragma unroll
  for (int i = 0; i < MT; ++i) ldsm4t(a[i], wb + 2 * (tl * 16 * WS + 16 * i));
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) ldsm4(bq[jj], vb + 2 * (boff + 16 * jj * CS));
}

template <int MT>
__device__ __forceinline__ void mma_fwd(float (&acc)[MT][4][4],
                                        const uint32_t (&a)[MT][4],
                                        const uint32_t (&bq)[2][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      mma16816(acc[i][2 * jj], a[i], bq[jj][0], bq[jj][1]);
      mma16816(acc[i][2 * jj + 1], a[i], bq[jj][2], bq[jj][3]);
    }
}

// K3: y[co, p] = sum over (t, c) of w[t, c, co] V[c, p + t] for this block's
// 8 x 32 output tile, 16 MT output channels, tap rows [dy0, dy0 + nd) and
// channel chunks [u0, u0 + nu) of 16. Warp w owns output row w (4 n8 tiles,
// MT m16 tiles). Grid: (B * tiles_y * tiles_x, ceil(Cout / 16 MT), n_dyg *
// n_cs). cluster > 1: the splits are one cluster (1, 1, n_dyg * n_cs),
// which adds them in shared memory and stores y; else partial null: y in
// bf16; else partial[split][b][co][oy][ox] fp32.
template <int MT>
__global__ void __launch_bounds__(THREADS, 2)
conv_fwd_px_kernel(const bf16* __restrict__ x, Src src,
                   const bf16* __restrict__ w, bf16* __restrict__ y,
                   float* __restrict__ partial, int B, int Cv, int Cout,
                   int Ho, int Wo, int k, int tiles_y, int tiles_x, int ndy,
                   int cps, int n_cs, int w_vec, int vec_out, int cluster) {
  constexpr int NB = 4, MROWS = 16 * MT, WS = MROWS + 8;
  const int vcols = TC + k - 1;
  const int v_el = (TR + ndy - 1) * vcols * CS, w_el = ndy * k * 16 * WS;
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);     // [V0][W0][V1][W1]

  const int per_image = tiles_y * tiles_x;
  const int b = blockIdx.x / per_image, tyx = blockIdx.x - b * per_image;
  const int y0 = (tyx / tiles_x) * TR, x0 = (tyx % tiles_x) * TC;
  const int co0 = blockIdx.y * MROWS;
  const int dyg = blockIdx.z / n_cs, csi = blockIdx.z - dyg * n_cs;
  const int dy0 = dyg * ndy, nd = min(ndy, k - dy0), ntaps = nd * k;
  const int n_cc = (Cv + 15) >> 4, u0 = csi * cps, nu = min(cps, n_cc - u0);
  const int npix = (TR + nd - 1) * vcols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, q = lane & 3;
  // ldmatrix rows: B (x4: tiles j, j + 1 x channels 0-7, 8-15) at pixel
  // (lane & 7) + 8 (lane >> 4), channel 8 ((lane >> 3) & 1); A (x4.trans:
  // channels 0-7, 8-15 x co 0-7, 8-15) at channel (lane & 7) + 8 (lane >>
  // 4), co 8 ((lane >> 3) & 1)
  const uint32_t v_lane = 2 * (((lane & 7) + ((lane >> 4) << 3)) * CS +
                               (((lane >> 3) & 1) << 3));
  const uint32_t w_lane = 2 * (((lane & 7) + ((lane >> 4) << 3)) * WS +
                               (((lane >> 3) & 1) << 3));
  const uint32_t ring_s = smem_addr(ring);
  const bool busy = y0 + warp < Ho;       // a row past Ho has no products

  float acc[MT][NB][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint32_t wd[ITEMS][8];
  stage_w<MT>(w, ring + v_el, dy0 * k, ntaps, u0 * 16, Cv, co0, Cout, w_vec);
  asm volatile("cp.async.commit_group;" ::: "memory");
  load_v16(x, src, b, u0 * 16, Cv, y0 + dy0, x0, npix, vcols, wd);
  store_v16(ring, npix, wd);
  for (int u = 0; u < nu; ++u) {
    const int cur = u & 1, nxt = cur ^ 1;
    const bool more = u + 1 < nu;
    if (more) {
      stage_w<MT>(w, ring + nxt * (v_el + w_el) + v_el, dy0 * k, ntaps,
                  (u0 + u + 1) * 16, Cv, co0, Cout, w_vec);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::: "memory");
      load_v16(x, src, b, (u0 + u + 1) * 16, Cv, y0 + dy0, x0, npix, vcols,
               wd);
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();                      // unit u's V and weights are in
    if (busy) {
      const uint32_t vb = ring_s + 2 * cur * (v_el + w_el) + v_lane +
                          2 * warp * vcols * CS;
      const uint32_t wb = ring_s + 2 * (cur * (v_el + w_el) + v_el) + w_lane;
      // two fragment sets: tap tl + 1's shared loads are in flight while
      // tap tl's products issue
      uint32_t a0[MT][4], b0[2][4];
      const auto boff = [&](int tl) { return ((tl / k) * vcols + tl % k) * CS; };
      if constexpr (MT >= 3) {
        // one set: two would take the registers of a second block an SM
        for (int tl = 0; tl < ntaps; ++tl) {
          frag_fwd<MT>(a0, b0, wb, vb, tl, boff(tl));
          mma_fwd<MT>(acc, a0, b0);
        }
      } else {
        uint32_t a1[MT][4], b1[2][4];
        frag_fwd<MT>(a0, b0, wb, vb, 0, 0);
        for (int tl = 0; tl < ntaps; tl += 2) {
          if (tl + 1 < ntaps) frag_fwd<MT>(a1, b1, wb, vb, tl + 1, boff(tl + 1));
          mma_fwd<MT>(acc, a0, b0);
          if (tl + 1 < ntaps) {
            if (tl + 2 < ntaps) frag_fwd<MT>(a0, b0, wb, vb, tl + 2, boff(tl + 2));
            mma_fwd<MT>(acc, a1, b1);
          }
        }
      }
    }
    if (more) store_v16(ring + nxt * (v_el + w_el), npix, wd);
    __syncthreads();                      // this stage is read
  }
  if (cluster > 1) {
    // the cluster's blocks are the splits of one output tile: each puts
    // its fp32 tile [MROWS][TR x TC] in its shared memory (the ring is
    // free: the loop ended at a barrier; co stride RS, so a float2 store's
    // four co rows land in distinct banks), then each adds a share of the
    // tile over the blocks' memories in rank (split) order and stores y
    constexpr int RS = TR * TC + 8;
    float* red = reinterpret_cast<float*>(smem4);
    if (busy) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NB; ++j)
            *reinterpret_cast<float2*>(
                red + (16 * i + gid + 8 * h) * RS + warp * TC + 8 * j + 2 * q) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    // each thread adds RU elements at once, so their remote loads are in
    // flight together; each element's sum stays in rank order
    constexpr int RU = 4;
    const int n_el = MROWS * TR * TC, share = (n_el + cluster - 1) / cluster;
    const int e0 = (int)cl.block_rank() * share;
    const int e1 = min(n_el, e0 + share);
    for (int eb = e0 + threadIdx.x; eb < e1; eb += RU * THREADS) {
      int idx[RU];
      size_t out[RU];
      bool ok[RU];
      float s[RU];
#pragma unroll
      for (int i = 0; i < RU; ++i) {
        const int e = eb + i * THREADS;
        const int co = e / (TR * TC), px = e - co * (TR * TC);
        const int oy = y0 + px / TC, ox = x0 + px % TC;
        ok[i] = e < e1 && co0 + co < Cout && oy < Ho && ox < Wo;
        idx[i] = ok[i] ? co * RS + px : 0;
        out[i] = (((size_t)b * Cout + co0 + co) * Ho + oy) * Wo + ox;
        s[i] = 0.f;
      }
      for (int r = 0; r < cluster; ++r) {
        const float* rem = cl.map_shared_rank(red, r);
#pragma unroll
        for (int i = 0; i < RU; ++i) s[i] += rem[idx[i]];
      }
#pragma unroll
      for (int i = 0; i < RU; ++i)
        if (ok[i]) y[out[i]] = __float2bfloat16(s[i]);
    }
    cl.sync();                            // the others have read this tile
    return;
  }
  if (!busy) return;
  const int oy = y0 + warp;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + 16 * i + gid + 8 * h;
      if (co >= Cout) continue;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int ox = x0 + 8 * j + 2 * q;
        if (ox >= Wo) continue;
        const bool ok1 = ox + 1 < Wo;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (partial != nullptr) {
          float* p = partial + (((size_t)blockIdx.z * B + b) * Cout + co) *
                                   ((size_t)Ho * Wo) +
                     (size_t)oy * Wo + ox;
          if (ok1 && !(Wo & 1)) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (ok1) p[1] = v1;
          }
        } else {
          bf16* yr = y + (((size_t)b * Cout + co) * Ho + oy) * Wo + ox;
          const __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
          if (vec_out && ok1) {
            *reinterpret_cast<__nv_bfloat162*>(yr) = pr;
          } else {
            yr[0] = pr.x;
            if (ok1) yr[1] = pr.y;
          }
        }
      }
    }
  }
}

// K3's second pass where the contraction was split: y[b, co, p] = the
// n_split partials added in split order, rounded to bf16; with st_part
// (K3''') also this chunk's sums of the rounded values and their squares,
// by a fixed tree (no atomics): st_part[(b * gridDim.x + chunk) * 2 +
// which][co]. A thread adds PPT pixels at once, its split loop unrolled,
// so its loads are in flight together. Grid: (ceil(HW / (THREADS * PPT)),
// Cout, B).
constexpr int PPT = 2;       // pixels a thread of the second pass (ops/conv.py PX_PCH = THREADS * PPT)

__global__ void __launch_bounds__(THREADS)
conv_split_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ y,
                      float* __restrict__ st_part, int n_split, int B,
                      int Cout, int HW) {
  __shared__ float red[2][THREADS / 32];
  const int b = blockIdx.z, co = blockIdx.y;
  const size_t split = (size_t)B * Cout * HW, row = ((size_t)b * Cout + co) * HW;
  int p[PPT];
  float a[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    p[i] = blockIdx.x * THREADS * PPT + threadIdx.x + THREADS * i;
    a[i] = 0.f;
  }
  const float* src = partial + row;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
#pragma unroll
    for (int i = 0; i < PPT; ++i)
      if (p[i] < HW) a[i] += src[s * split + p[i]];
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (p[i] >= HW) continue;
    const bf16 v = __float2bfloat16(a[i]);
    y[row + p[i]] = v;
    const float f = __bfloat162float(v);
    s1 += f;
    s2 += f * f;
  }
  if (st_part == nullptr) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float t = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) t += red[threadIdx.x][i];
    st_part[(((size_t)b * gridDim.x + blockIdx.x) * 2 + threadIdx.x) * Cout +
            co] = t;
  }
}

// g's pairs of the stage at (y0, x0) into registers: 8 NB channels from n0
// x TR rows x TC columns, zero past the strip (r1, q1) and past Cu; as in
// load_v16, clamped addresses and selects, no branch between the loads.
template <int NB>
__device__ __forceinline__ void load_g(const bf16* __restrict__ g, int b,
                                       int n0, int Cu, int Hp, int Wp, int y0,
                                       int x0, int r1, int q1,
                                       uint32_t (&gw)[4 * NB]) {
  const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
#pragma unroll
  for (int m = 0; m < 4 * NB; ++m) {
    const int it = threadIdx.x + THREADS * m;
    const int u = n0 + (it >> 7), yy = y0 + ((it >> 4) & 7);
    const int xx = x0 + 2 * (it & 15);
    const bool row = u < Cu && yy < r1;
    const unsigned short* gr =
        gs + (((size_t)b * Cu + min(u, Cu - 1)) * Hp + min(yy, Hp - 1)) * Wp;
    const uint32_t lo = __ldg(gr + min(xx, Wp - 1));
    const uint32_t hi = __ldg(gr + min(xx + 1, Wp - 1));
    gw[m] = (row && xx < q1 ? lo : 0u) | (row && xx + 1 < q1 ? hi : 0u) << 16;
  }
}

// K7's untapped operand U = V over its own extent [Hp, Wp] (the gtap
// mode): load_g's pairs of the stage, channels n0.. of x read through Src
// (its border `pad`, stride 1), zero in the border, past the strip and
// past Cu. Clamped addresses and selects as load_g. The prologue is
// prologue_u, applied where the pairs are stored (after the stage's
// products, so that no extra state is held across them).
__device__ __forceinline__ bool u_ok(const Src& s, int u, int Cu, int yy,
                                     int xx, int r1, int q1) {
  const int sy = yy - s.pad, sx = xx - s.pad;
  return u < Cu && yy < r1 && xx < q1 && sy >= 0 && sy < s.H && sx >= 0 &&
         sx < s.W;
}

template <int NB>
__device__ __forceinline__ void load_u(const bf16* __restrict__ x,
                                       const Src& s, int b, int n0, int Cu,
                                       int y0, int x0, int r1, int q1,
                                       uint32_t (&gw)[4 * NB]) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
#pragma unroll
  for (int m = 0; m < 4 * NB; ++m) {
    const int it = threadIdx.x + THREADS * m;
    const int u = n0 + (it >> 7), yy = y0 + ((it >> 4) & 7);
    const int xx = x0 + 2 * (it & 15);
    const int sy = yy - s.pad, sx = xx - s.pad;
    const unsigned short* xr =
        xs + (((size_t)b * s.cin + min(u, Cu - 1)) * s.H +
              min(max(sy, 0), s.H - 1)) * s.W;
    const uint32_t lo = __ldg(xr + min(max(sx, 0), s.W - 1));
    const uint32_t hi = __ldg(xr + min(max(sx + 1, 0), s.W - 1));
    gw[m] = (u_ok(s, u, Cu, yy, xx, r1, q1) ? lo : 0u) |
            (u_ok(s, u, Cu, yy, xx + 1, r1, q1) ? hi : 0u) << 16;
  }
}

// load_u's pairs of the stage at (y0, x0) through the prologue z =
// leaky_ns(x*scale + shift) with load_v16's rounding (two roundings, no
// fma), x's own elements only: the border and the zeros past the strip and
// Cu stay zero, as K7's plain version's z.
template <int NB>
__device__ __forceinline__ void prologue_u(const Src& s, int b, int n0,
                                           int Cu, int y0, int x0, int r1,
                                           int q1, uint32_t (&gw)[4 * NB]) {
  if (s.scale == nullptr) return;
#pragma unroll
  for (int m = 0; m < 4 * NB; ++m) {
    const int it = threadIdx.x + THREADS * m;
    const int u = n0 + (it >> 7), yy = y0 + ((it >> 4) & 7);
    const int xx = x0 + 2 * (it & 15);
    const int row = (b / s.per_group) * s.cin + min(u, Cu - 1);
    const float sc = s.scale[row], sh = s.shift[row];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!u_ok(s, u, Cu, yy, xx + e, r1, q1)) continue;
      float z = __fadd_rn(__fmul_rn(
          __uint_as_float((gw[m] >> (16 * e) & 0xffffu) << 16), sc), sh);
      if (s.negslope != 1.f) z = z >= 0.f ? z : z * s.negslope;
      const uint32_t v = __bfloat16_as_ushort(__float2bfloat16(z));
      gw[m] = (gw[m] & ~(0xffffu << (16 * e))) | v << (16 * e);
    }
  }
}

// load_g's pairs into g's tile dst[co][row][col] (strides GP, GC).
template <int NB>
__device__ __forceinline__ void store_g(bf16* dst,
                                        const uint32_t (&gw)[4 * NB]) {
#pragma unroll
  for (int m = 0; m < 4 * NB; ++m) {
    const int it = threadIdx.x + THREADS * m;
    *reinterpret_cast<uint32_t*>(dst + (it >> 7) * GP + ((it >> 4) & 7) * GC +
                                 2 * (it & 15)) = gw[m];
  }
}

// K4 over this block's strip (rows x cols pixels of g's extent), channel
// group [ch0, ch0 + 16) of V, tap rows [dy0, dy0 + nd) (all k columns) and
// output channels [n0, n0 + 8 NB):
//   partial[strip][(t * Cs + c) * Cu + u] = sum_p V[c, p + t] g[u, p],
// dw_tc's layout, so conv_dw_sum_kernel adds the strips. Warp w owns the
// block's taps w, w + 8, ... (at most 16 / NB), all NB n8 tiles; a k16
// step is 16 pixels of one stage row. Grid: (B * strips_y * strips_x,
// n_cg * n_dyg, ceil(Cu / 8 NB)).
// GTAP (K7, the cotangent-tapped mode, at any k >= 2; it replaces
// _make_dw_kernel_gtap :455 where conv_dw_tc has no instance): the roles
// swap as in dwtc and tc32's gtap modes. The tapped operand (x, src) is g
// read through a Src with a border of k - 1 (zero outside g), Cs = Cout;
// the untapped one (u, usrc) is V over its own extent [Hp, Wp] = [Ho + k -
// 1, Wo + k - 1] (load_u: x through Src, the prologue on x's elements
// only), Cu = Cin. The partial is D[(t', co), ci]; the sum transposes it
// to [Cin, k*k*Cout] and the caller reverses the taps.
template <int NB, bool GTAP>
__global__ void __launch_bounds__(THREADS)
conv_dw_px_kernel(const bf16* __restrict__ x, Src src,
                  const bf16* __restrict__ g, Src usrc,
                  float* __restrict__ partial,
                  int Cs, int Cu, int Hp, int Wp, int k, int rows, int cols,
                  int strips_y, int strips_x, int ndy, int n_cg) {
  constexpr int TPW = 16 / NB;            // taps a warp
  const int vcols = TC + k - 1;
  const int v_el = (TR + ndy - 1) * vcols * CS, g_el = 8 * NB * GP;
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);     // [V0][G0][V1][G1]

  const int per_image = strips_y * strips_x;
  const int b = blockIdx.x / per_image, syx = blockIdx.x - b * per_image;
  const int r0 = (syx / strips_x) * rows, r1 = min(r0 + rows, Hp);
  const int q0 = (syx % strips_x) * cols, q1 = min(q0 + cols, Wp);
  const int cgi = blockIdx.y % n_cg, dyg = blockIdx.y / n_cg;
  const int ch0 = cgi * 16, dy0 = dyg * ndy, nd = min(ndy, k - dy0);
  const int ntaps = nd * k, n0 = blockIdx.z * 8 * NB;
  const int npix = (TR + nd - 1) * vcols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, q = lane & 3;
  // ldmatrix rows: A (x4.trans: pixels 0-7, 8-15 x channels 0-7, 8-15) at
  // pixel (lane & 7) + 8 (lane >> 4), channel 8 ((lane >> 3) & 1); B (x4:
  // co 0-7, 8-15 x pixels 0-7, 8-15) at co (lane & 7) + 8 (lane >> 4),
  // pixel 8 ((lane >> 3) & 1)
  const uint32_t v_lane = 2 * (((lane & 7) + ((lane >> 4) << 3)) * CS +
                               (((lane >> 3) & 1) << 3));
  const uint32_t g_lane = 2 * (((lane & 7) + ((lane >> 4) << 3)) * GP +
                               (((lane >> 3) & 1) << 3));
  const uint32_t ring_s = smem_addr(ring);
  const int my_taps = (ntaps - warp + 7) / 8;   // taps w, w + 8, ... < ntaps
  int toff[TPW];                          // this warp's taps in V's tile
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tl = min(warp + 8 * i, ntaps - 1);
    toff[i] = ((tl / k) * vcols + tl % k) * CS;
  }
  float acc[TPW][NB][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int sxn = (q1 - q0 + TC - 1) / TC;
  const int n_st = (r1 - r0 + TR - 1) / TR * sxn;
  uint32_t wd[ITEMS][8], gw[4 * NB];
  load_v16(x, src, b, ch0, Cs, r0 + dy0, q0, npix, vcols, wd);
  if constexpr (GTAP)
    load_u<NB>(g, usrc, b, n0, Cu, r0, q0, r1, q1, gw);
  else
    load_g<NB>(g, b, n0, Cu, Hp, Wp, r0, q0, r1, q1, gw);
  store_v16(ring, npix, wd);
  if constexpr (GTAP) prologue_u<NB>(usrc, b, n0, Cu, r0, q0, r1, q1, gw);
  store_g<NB>(ring + v_el, gw);
  __syncthreads();
  for (int s = 0; s < n_st; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    const bool more = s + 1 < n_st;
    if (more) {
      const int y1 = r0 + TR * ((s + 1) / sxn), x1 = q0 + TC * ((s + 1) % sxn);
      load_v16(x, src, b, ch0, Cs, y1 + dy0, x1, npix, vcols, wd);
      if constexpr (GTAP)
        load_u<NB>(g, usrc, b, n0, Cu, y1, x1, r1, q1, gw);
      else
        load_g<NB>(g, b, n0, Cu, Hp, Wp, y1, x1, r1, q1, gw);
    }
    const int y0 = r0 + TR * (s / sxn), x0 = q0 + TC * (s % sxn);
    const uint32_t vb = ring_s + 2 * cur * (v_el + g_el) + v_lane;
    const uint32_t gb = ring_s + 2 * (cur * (v_el + g_el) + v_el) + g_lane;
    for (int ry = 0; ry < TR && y0 + ry < r1; ++ry) {
#pragma unroll
      for (int kx = 0; kx < TC / 16; ++kx) {
        if (x0 + 16 * kx >= q1) break;
        uint32_t bf[NB][2];
        if constexpr (NB == 1) {
          ldsm2(bf[0], gb + 2 * (ry * GC + 16 * kx));
        } else {
#pragma unroll
          for (int jj = 0; jj < NB / 2; ++jj) {
            uint32_t t4[4];
            ldsm4(t4, gb + 2 * (16 * jj * GP + ry * GC + 16 * kx));
            bf[2 * jj][0] = t4[0];
            bf[2 * jj][1] = t4[1];
            bf[2 * jj + 1][0] = t4[2];
            bf[2 * jj + 1][1] = t4[3];
          }
        }
        // tap i + 1's A fragment is in flight while tap i's products issue
        const uint32_t vr = vb + 2 * (ry * vcols + 16 * kx) * CS;
        uint32_t a0[4], a1[4];
        ldsm4t(a0, vr + 2 * toff[0]);
#pragma unroll
        for (int i = 0; i < TPW; i += 2) {
          if (i >= my_taps) break;
          const bool two = i + 1 < TPW && i + 1 < my_taps;
          if (two) ldsm4t(a1, vr + 2 * toff[i + 1 < TPW ? i + 1 : 0]);
#pragma unroll
          for (int j = 0; j < NB; ++j) mma16816(acc[i][j], a0, bf[j][0], bf[j][1]);
          if (two) {
            if (i + 2 < TPW && i + 2 < my_taps)
              ldsm4t(a0, vr + 2 * toff[i + 2 < TPW ? i + 2 : 0]);
#pragma unroll
            for (int j = 0; j < NB; ++j)
              mma16816(acc[i + 1][j], a1, bf[j][0], bf[j][1]);
          }
        }
      }
    }
    if (more) {
      store_v16(ring + nxt * (v_el + g_el), npix, wd);
      if constexpr (GTAP)
        prologue_u<NB>(usrc, b, n0, Cu, r0 + TR * ((s + 1) / sxn),
                       q0 + TC * ((s + 1) % sxn), r1, q1, gw);
      store_g<NB>(ring + nxt * (v_el + g_el) + v_el, gw);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * k * k * Cs * Cu;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tl = warp + 8 * i;
    if (tl >= ntaps) break;
    const int t = dy0 * k + tl;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ch0 + gid + 8 * h;
      if (c >= Cs) continue;
      float* orow = out + ((size_t)t * Cs + c) * Cu;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int u = n0 + 8 * j + 2 * q;
        if (u < Cu) orow[u] = acc[i][j][2 * h];
        if (u + 1 < Cu) orow[u + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// Shared memory of the two forms' rings, K3's of `stages` stages
// (ops/conv.py fwd_px_smem, dw_px_smem).
__host__ __forceinline__ size_t fwd_smem(int k, int ndy, int mt, int stages) {
  const size_t ring = stages * sizeof(bf16) *
      ((size_t)(TR + ndy - 1) * (TC + k - 1) * CS +
       (size_t)ndy * k * 16 * (16 * mt + 8));
  const size_t tile = sizeof(float) * 16 * mt * (TR * TC + 8);
  return ring > tile ? ring : tile;
}
__host__ __forceinline__ size_t dw_smem(int k, int ndy, int nb) {
  return 2 * sizeof(bf16) *
         ((size_t)(TR + ndy - 1) * (TC + k - 1) * CS + (size_t)8 * nb * GP);
}

template <int MT>
int launch_fwd(const bf16* x, const Src& src, const bf16* w, bf16* y,
               float* partial, float* st_part, float* stats, int B, int Cout,
               int Ho, int Wo, int k, int ndy, int cps, int n_cs, int n_dyg,
               cudaStream_t st) {
  const int Cv = src.stride * src.stride * src.cin;
  const int n_cc = (Cv + 15) / 16;
  const int n_split = n_dyg * n_cs;
  const bool direct = n_split == 1 && st_part == nullptr;
  const int cluster = !direct && n_split <= CLUSTER && st_part == nullptr
      ? n_split : 0;
  if (k < 1 || ndy < 1 || ndy > k || (n_dyg - 1) * ndy >= k ||
      n_dyg * ndy < k || cps < 1 || (n_cs - 1) * cps >= n_cc ||
      n_cs * cps < n_cc || (TR + ndy - 1) * (TC + k - 1) > ITEMS * THREADS ||
      (!direct && !cluster && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  // a block of one channel chunk (cps 1) never fills the ring's second
  // stage
  const size_t smem = fwd_smem(k, ndy, MT, cps > 1 ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(
      conv_fwd_px_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_y = (Ho + TR - 1) / TR, tiles_x = (Wo + TC - 1) / TC;
  const dim3 grid(B * tiles_y * tiles_x, (Cout + 16 * MT - 1) / (16 * MT),
                  n_split);
  const int w_vec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_out = Wo % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster ? cluster : 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, conv_fwd_px_kernel<MT>, x, src, w, y,
                         direct || cluster ? nullptr : partial, B, Cv, Cout,
                         Ho, Wo, k, tiles_y, tiles_x, ndy, cps, n_cs, w_vec,
                         vec_out, cluster);
  if (e != cudaSuccess) return (int)e;
  int err = (int)cudaGetLastError();
  if (err || direct || cluster) return err;
  const int HW = Ho * Wo, n_pch = (HW + THREADS * PPT - 1) / (THREADS * PPT);
  conv_split_sum_kernel<<<dim3(n_pch, Cout, B), THREADS, 0, st>>>(
      partial, y, st_part, n_split, B, Cout, HW);
  err = (int)cudaGetLastError();
  if (err || st_part == nullptr) return err;
  const int groups = B / src.per_group;
  conv_stats_reduce_kernel<<<groups * 2 * Cout, NT, 0, st>>>(
      st_part, stats, src.per_group * n_pch, Cout);
  return (int)cudaGetLastError();
}

// K4 (GTAP false: x, src tapped; g untapped, usrc unread) or K7 (GTAP:
// x = g through src with its border k - 1, g = the input x through usrc;
// see conv_dw_px_kernel).
template <int NB, bool GTAP>
int launch_dw(const bf16* x, const Src& src, const bf16* g, const Src& usrc,
              float* partial, float* dw, int B, int Cu, int Hp, int Wp,
              int k, int rows, int cols, int ndy, cudaStream_t st) {
  const int Cs = src.stride * src.stride * src.cin;
  if (k < 1 || ndy < 1 || ndy > k || (ndy * k + 7) / 8 > 16 / NB ||
      (TR + ndy - 1) * (TC + k - 1) > ITEMS * THREADS || rows < TR ||
      rows % TR || cols < TC || cols % TC || (GTAP && k < 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = dw_smem(k, ndy, NB);
  cudaError_t e = cudaFuncSetAttribute(
      conv_dw_px_kernel<NB, GTAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int strips_y = (Hp + rows - 1) / rows;
  const int strips_x = (Wp + cols - 1) / cols;
  const int n_cg = (Cs + 15) / 16, n_dyg = (k + ndy - 1) / ndy;
  const dim3 grid(B * strips_y * strips_x, n_cg * n_dyg,
                  (Cu + 8 * NB - 1) / (8 * NB));
  conv_dw_px_kernel<NB, GTAP><<<grid, THREADS, smem, st>>>(
      x, src, g, usrc, partial, Cs, Cu, Hp, Wp, k, rows, cols, strips_y,
      strips_x, ndy, n_cg);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n_out = k * k * Cs * Cu;
  const int n_slices = (int)grid.x;
  const dim3 rblock(32, n_slices < 32 ? n_slices : 32);
  dwtc::conv_dw_sum_kernel<GTAP><<<(n_out + 31) / 32, rblock, 0, st>>>(
      partial, dw, n_out, n_slices, Cu);
  return (int)cudaGetLastError();
}

}  // namespace px

// ---------------------------------------------------------------------------
// bf16 K4 and K7 on large maps (namespace wgdw, conv_dw_wg): the weight
// gradient of both modes,
//   D[(t, c), u] = sum_p T[c, p + t] U[u, p],
// T the tapped operand and U the untapped one over U's extent [Hp, Wp], as
// dwtc and px define them (K4: T = V, x through Src, U = g; K7: T = g with a
// border of k - 1, U = V over [Ho + k - 1, Wo + k - 1], the prologue on x's
// own elements), on wgmma. It replaces _make_dw_kernel (:401) and
// _make_dw_kernel_gtap (:455) where ops/conv.py conv_route sends them: bf16
// at stride 1, k >= 8, maps of at least WG_MIN_PIXELS pixels whose rows are
// a multiple of 8 elements (the generator's up convs with filter_size_up 9
// or 11: 36-132 channels over 224-896 maps, B = 2). Both orders compute the
// same weight gradient; ops/conv.py dw_wg_plan runs K4 and K7 alike in the
// order its cost model (fitted to this kernel's times) finds cheaper: the
// narrower operand tapped, roughly (at Cout 16, K4's order issues 3x K7's
// products).
// What bounds it: such a call does about 10^11 flops on 10^8 bytes, about
// 1,000 flops a byte against the ridge of 295, so the tensor cores. px's
// form, built for the inversion net's B = 1 maps of at most 63K pixels where
// latency and grid fill bind, reached 41-47 TFLOP/s here (one 8-warp block
// an SM at 228-254 registers, one ldmatrix of A for at most two m16n8k16
// products, 2-byte loads through registers, tiles cut to 512 pixels). This
// form answers each:
//   * U is wgmma's B, K-major from shared memory: a row of B is pixels of
//     one channel, contiguous in [B, C, H, W]. A TMA box of [N channels]
//     [1 row][64 pixels], 128-byte swizzled, lands one image row of the
//     block's 64-pixel band. TMA's zero fill outside U is K7's border of x,
//     the columns past Wp and the channels past Cu. N is Cu rounded up to a
//     multiple of 8 (one chunk up to 136 columns), so B is read once a
//     product for all of Cu, and once a warpgroup, not once a warp.
//   * T is wgmma's A, from registers: a warp's 16 rows are one tap x 16
//     channels, read by ldmatrix.x4.trans from a pixel-major tile (a pixel's
//     16 channels in a 48-byte row, as px) at the tap's pixel offset, which
//     no shared-memory descriptor can address. The per-warp A layout of
//     m64nNk16 is m16n8k16's, so px's fragment addressing feeds it
//     unchanged. A warpgroup holds J m64 tiles (4 J taps x 16 channels,
//     J = tiles_for(N)) and issues each tile's product as one m64nNk16 at
//     the instance's width N. A's fragments are double buffered: a k16
//     step's loads run beside the previous step's products.
//   * T is staged asynchronously too, with no 2-byte loads: TMA lands each
//     row of T raw ([16 channels][tw pixels], zero outside T at any border),
//     and the warps turn it pixel-major 16 x 16 at a time by ldmatrix +
//     stmatrix.trans,
//     applying K4's prologue between the two (x's own elements only). A
//     block walks its strip one image row a stage, and T's rows live in a
//     ring of rt rows (the most tap rows a group spans plus STAGES - 1), so
//     each row of T lands once per block. K7's prologue on U is one pass over
//     the landed box by the warps (fence.proxy.async before the
//     products read it): U's box is read by the tensor cores straight from
//     where TMA put it, so there is no register staging to apply it in.
//   * Warp roles: two warpgroups, each warp both producer and consumer, so
//     that a thread may hold up to 255 registers (a ninth warp shares an SM
//     quarter's 16K registers three ways: 168 a thread). Thread 0 keeps
//     AHEAD stages of TMA in flight; each warp transposes its share of the
//     stage PRODUCE ahead of the one it multiplies; STAGES image rows in
//     the ring; one block of 256 threads an SM. Two earlier layouts built
//     and ran right but slowly: a producer warpgroup whose registers went
//     to the consumers by setmaxnreg (48 / 224), and one producer warp
//     beside the consumers. ptxas held both at 168 registers a thread,
//     spilled the consumers' accumulators and serialised their wgmma
//     (C7512).
//   * The work is split by taps, not pixels alone: a block owns one strip
//     of at most 64 rows of a 64-pixel band, one 16-channel group of T, a
//     group of at most 8 J consecutive taps (tg, evened) and one chunk of N
//     channels of U. Every tile is issued: tiles past a group's taps
//     compute its last tap again and are not stored (a run-time count of
//     tiles around the products made ptxas fence each one).
//   * Precision: a strip is at most 64 rows x 64 pixels, so each
//     accumulator chain adds at most 4,096 pixels (CHAIN, ops/conv.py
//     WG_CHAIN), as px's cotangent-tapped strips (the tensor cores truncate
//     as they accumulate). Each strip writes an fp32 partial in dwtc's
//     layout and conv_dw_sum_kernel adds the strips in a fixed order (no
//     atomics: a seeded call repeats bit for bit; K7's sum transposes).
// The TMA, mbarrier and wgmma helpers are copied from
// attention.cu (a few lines each) so that attention.cu and its instances
// stay as they are.
// ---------------------------------------------------------------------------
namespace wgdw {

using bf16 = __nv_bfloat16;
using dwtc::smem_addr;
using px::ldsm4;
using px::ldsm4t;
constexpr int BAND = 64;        // pixel columns of a strip: one 128-byte box row (ops/conv.py WG_BAND)
constexpr int CS = px::CS;      // elements of a staged pixel of T (WG_PIXEL)
constexpr int STAGES = 8;       // image rows in the ring (WG_STAGES)
constexpr int PRODUCE = 1;      // stages a warp transposes ahead of the one it multiplies
constexpr int AHEAD = 6;        // stages whose TMA thread 0 issues ahead of it
constexpr int WARPS = 8;        // two warpgroups, each of them producer and consumer
constexpr int THREADS = 32 * WARPS;   // (WG_THREADS)
static_assert(STAGES > 2 * PRODUCE && AHEAD < STAGES - PRODUCE,
              "a stage's slot and ring rows are released before reuse");
constexpr int CHAIN = 4096;     // pixels an accumulator chain adds (WG_CHAIN)
constexpr int MAX_ROWS = CHAIN / BAND;
constexpr int MAX_TW = 256;     // a TMA box's widest dimension

// m64 tiles a warpgroup holds at N columns: the accumulators (N / 2
// registers a tile) and two A fragments (8) within 168 of a thread's 255
// registers, at most 10 (ops/conv.py wg_tiles).
__host__ __device__ constexpr int tiles_for(int n) {
  return 168 / (n / 2 + 8) > 10 ? 10 : 168 / (n / 2 + 8);
}

// T's staged width: up to 7 columns of lead, the band and its k - 1 halo in
// whole 16-byte units, an odd count of them so that ldmatrix's 8 channel
// rows of the raw tile fall in 8 distinct bank groups (ops/conv.py
// wg_tile_width).
__host__ __device__ constexpr int tile_width(int k) {
  return 8 * (((7 + BAND + k - 1 + 7) / 8) | 1);
}

// The ring's rows: the most tap rows one of the groups of tg taps spans,
// plus the stages in flight (ops/conv.py wg_ring_rows).
inline int ring_rows(int k, int tg) {
  int nd = 1;
  for (int t0 = 0; t0 < k * k; t0 += tg) {
    const int t1 = t0 + tg < k * k ? t0 + tg : k * k;
    nd = nd > (t1 - 1) / k - t0 / k + 1 ? nd : (t1 - 1) / k - t0 / k + 1;
  }
  return nd + STAGES - 1;
}

// Dynamic shared memory: 1 KB to align, U's ring, T's raw and pixel-major
// rings, the barriers (ops/conv.py wg_smem).
inline size_t smem_bytes(int n, int k, int tg) {
  const int tw = tile_width(k), rt = ring_rows(k, tg);
  return 1024 + (size_t)STAGES * n * 128 + (size_t)rt * tw * (32 + 2 * CS) +
         3 * STAGES * 8;
}

struct Maps {
  CUtensorMap t, u;
};

struct Plan {
  int Cs, Cu, Hp, Wp, k;
  int tg, groups, ncg, chunks;   // taps a group, groups, T's 16-channel groups, U's N chunks
  int rows, n_rs, n_bands;       // a strip's rows, strips down and bands across an image
  int tw, rt;
  int lead;                      // band 0 starts this many columns left of U's extent
};


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
// Returns once the phase of parity `parity` has completed; traps after
// 2^28 polls (tens of seconds), so that a barrier that never completes
// fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}
// The box of `map` at coordinates (c0, c1, c2, c3), innermost first.
__device__ __forceinline__ void tma4(void* dst, const CUtensorMap* map,
                                     uint64_t* bar, int c0, int c1, int c2,
                                     int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// wgmma descriptor of 128-byte rows as TMA's 128-byte swizzle leaves them
// (8-row groups 1024 bytes apart), read K-major: a k16 step is +32 bytes
// (+2), a row +128 bytes (+8).
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
template <int n>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(n) : "memory");
}
template <int n>
__device__ __forceinline__ void pin(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void stsm4t(const uint32_t (&r)[4], uint32_t a) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
               :: "r"(a), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B K-major in shared
// memory (descriptor b): one wgmma of the full width N a tile and k16
// step (split into pieces of 64, 32, ... columns, each a wgmma reading the
// same A registers, it ran slower: a wgmma's cost has a floor that narrow
// pieces pay in full). WG_R<g> names the 4 g accumulator
// registers of N = 8 g, WG_O<g> their operands.
#define WG_S0 "%0, %1, %2, %3"
#define WG_S1 "%4, %5, %6, %7"
#define WG_S2 "%8, %9, %10, %11"
#define WG_S3 "%12, %13, %14, %15"
#define WG_S4 "%16, %17, %18, %19"
#define WG_S5 "%20, %21, %22, %23"
#define WG_S6 "%24, %25, %26, %27"
#define WG_S7 "%28, %29, %30, %31"
#define WG_S8 "%32, %33, %34, %35"
#define WG_S9 "%36, %37, %38, %39"
#define WG_S10 "%40, %41, %42, %43"
#define WG_S11 "%44, %45, %46, %47"
#define WG_S12 "%48, %49, %50, %51"
#define WG_S13 "%52, %53, %54, %55"
#define WG_S14 "%56, %57, %58, %59"
#define WG_S15 "%60, %61, %62, %63"
#define WG_S16 "%64, %65, %66, %67"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R1 WG_S0
#define WG_O1 WG_F4(0)
#define WG_R2 WG_R1 ", " WG_S1
#define WG_O2 WG_O1, WG_F4(4)
#define WG_R3 WG_R2 ", " WG_S2
#define WG_O3 WG_O2, WG_F4(8)
#define WG_R4 WG_R3 ", " WG_S3
#define WG_O4 WG_O3, WG_F4(12)
#define WG_R5 WG_R4 ", " WG_S4
#define WG_O5 WG_O4, WG_F4(16)
#define WG_R6 WG_R5 ", " WG_S5
#define WG_O6 WG_O5, WG_F4(20)
#define WG_R7 WG_R6 ", " WG_S6
#define WG_O7 WG_O6, WG_F4(24)
#define WG_R8 WG_R7 ", " WG_S7
#define WG_O8 WG_O7, WG_F4(28)
#define WG_R9 WG_R8 ", " WG_S8
#define WG_O9 WG_O8, WG_F4(32)
#define WG_R10 WG_R9 ", " WG_S9
#define WG_O10 WG_O9, WG_F4(36)
#define WG_R11 WG_R10 ", " WG_S10
#define WG_O11 WG_O10, WG_F4(40)
#define WG_R12 WG_R11 ", " WG_S11
#define WG_O12 WG_O11, WG_F4(44)
#define WG_R13 WG_R12 ", " WG_S12
#define WG_O13 WG_O12, WG_F4(48)
#define WG_R14 WG_R13 ", " WG_S13
#define WG_O14 WG_O13, WG_F4(52)
#define WG_R15 WG_R14 ", " WG_S14
#define WG_O15 WG_O14, WG_F4(56)
#define WG_R16 WG_R15 ", " WG_S15
#define WG_O16 WG_O15, WG_F4(60)
#define WG_R17 WG_R16 ", " WG_S16
#define WG_O17 WG_O16, WG_F4(64)
#define WG_RS(G, N, A0, A1, A2, A3, B, ONE)                                  \
  template <>                                                                \
  __device__ __forceinline__ void wg_rs<N>(float (&d)[N / 2],                 \
                                           const uint32_t (&a)[4],            \
                                           uint64_t b) {                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ONE ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "  \
                 "{" WG_R##G "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" \
                 #B ", p, 1, 1, 0;\n}\n"                                       \
                 : WG_O##G                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),        \
                   "r"(1));                                                    \
  }
template <int N>
__device__ __forceinline__ void wg_rs(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b);
// the instances' widths (WGDW_NS)
WG_RS(2, 16, 8, 9, 10, 11, 12, 13)
WG_RS(3, 24, 12, 13, 14, 15, 16, 17)
WG_RS(4, 32, 16, 17, 18, 19, 20, 21)
WG_RS(5, 40, 20, 21, 22, 23, 24, 25)
WG_RS(6, 48, 24, 25, 26, 27, 28, 29)
WG_RS(8, 64, 32, 33, 34, 35, 36, 37)
WG_RS(9, 72, 36, 37, 38, 39, 40, 41)
WG_RS(12, 96, 48, 49, 50, 51, 52, 53)
WG_RS(17, 136, 68, 69, 70, 71, 72, 73)
#undef WG_RS

// The rows of T a stage lands: stage 0 the block's nd tap rows, each later
// stage the one new row its last tap row reaches.
__device__ __forceinline__ void stage_rows(int s, int r0, int dy0, int nd,
                                           int& first, int& last) {
  last = r0 + s + dy0 + nd - 1;
  first = s == 0 ? r0 + dy0 : last;
}

// See above. Grid: one block per (strip, T's channel group, tap group, U's
// chunk), the strip slowest so that the blocks of one strip run together
// and share its rows in L2. partial[strip][(t * Cs + c) * Cu + u].
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
conv_dw_wg_kernel(const __grid_constant__ Maps maps, Src ss, Src us, Plan pl,
                  float* __restrict__ partial) {
  constexpr int J = tiles_for(N);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* u_ring = sm;                                       // [STAGES][N][64]
  bf16* t_raw = reinterpret_cast<bf16*>(u_ring + STAGES * N * 128);  // [rt][16][tw]
  bf16* t_pix = t_raw + pl.rt * 16 * pl.tw;                   // [rt][tw][CS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(t_pix + pl.rt * pl.tw * CS);
  uint64_t* landed = bars;               // TMA's bytes of a stage
  uint64_t* full = bars + STAGES;        // its T rows transposed (and U's prologue)
  uint64_t* empty = bars + 2 * STAGES;   // every consumer warp done with it

  const int per = pl.ncg * pl.groups * pl.chunks;
  const int strip = blockIdx.x / per, rest = blockIdx.x - strip * per;
  const int chunk = rest % pl.chunks;
  const int grp = rest / pl.chunks % pl.groups;
  const int cg = rest / (pl.chunks * pl.groups);
  const int per_img = pl.n_rs * pl.n_bands;
  const int b = strip / per_img, sri = strip - b * per_img;
  const int r0 = (sri / pl.n_bands) * pl.rows;
  // a box's first column is a multiple of 8 elements in its source (TMA
  // raised an illegal instruction at other columns): U's by the bands'
  // origin -lead, T's by starting its tile t_lead columns early
  const int x0 = (sri % pl.n_bands) * BAND - pl.lead;
  const int t_lead = ((x0 - ss.pad) % 8 + 8) % 8;
  const int n_st = min(pl.rows, pl.Hp - r0), q1 = min(x0 + BAND, pl.Wp);
  const int t0 = grp * pl.tg, units = min(pl.tg, pl.k * pl.k - t0);
  const int dy0 = t0 / pl.k, nd = (t0 + units - 1) / pl.k - dy0 + 1;
  const int n0 = chunk * N, c0 = cg * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], WARPS);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* map_t = &maps.t;
  const CUtensorMap* map_u = &maps.u;
  // A stage's TMA (thread 0): U's box and T's new rows, once the slot (and
  // the ring rows it overwrites, those of stage s - STAGES) is released.
  auto issue = [&](int s) {
    const int slot = s % STAGES;
    if (s >= STAGES) mbar_wait(&empty[slot], (s / STAGES - 1) & 1);
    int first, last;
    stage_rows(s, r0, dy0, nd, first, last);
    mbar_arrive_tx(&landed[slot], N * 128 + (last - first + 1) * 32 * pl.tw);
    tma4(u_ring + slot * N * 128, map_u, &landed[slot], x0 - us.pad,
         r0 + s - us.pad, n0, b);
    for (int vy = first; vy <= last; ++vy)
      tma4(t_raw + (vy % pl.rt) * 16 * pl.tw, map_t, &landed[slot],
           x0 - t_lead - ss.pad, vy - ss.pad, c0, b);
  };
  // This warp's share of a landed stage: T's new rows pixel-major, 16
  // pixels x 16 channels an ldmatrix.x4 + stmatrix.x4.trans (a lane's
  // register m holds channel 8 (m & 1) + gid at pixels 2q, 2q + 1 of
  // group gl(m)), K4's prologue between the two; then K7's prologue on
  // U's box; every thread arrives.
  const int tw8 = pl.tw / 8, n_ops = (tw8 + 1) / 2;
  auto produce = [&](int s) {
    const int slot = s % STAGES;
    const int mi = lane >> 3, mr = lane & 7, gid = lane >> 2, q = lane & 3;
    mbar_wait(&landed[slot], (s / STAGES) & 1);
    int first, last;
    stage_rows(s, r0, dy0, nd, first, last);
    for (int op = warp; op < (last - first + 1) * n_ops; op += WARPS) {
      const int vy = first + op / n_ops, o = op % n_ops;
      const bf16* raw = t_raw + (vy % pl.rt) * 16 * pl.tw;
      bf16* pix = t_pix + (vy % pl.rt) * pl.tw * CS;
      const int sy = vy - ss.pad;
      uint32_t v[4];
      const int gl = min(2 * o + (mi >> 1), tw8 - 1);
      ldsm4(v, smem_addr(raw + (8 * (mi & 1) + mr) * pl.tw + 8 * gl));
      if (ss.scale != nullptr && sy >= 0 && sy < ss.H) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = c0 + 8 * (m & 1) + gid;
          const int sx = x0 - t_lead + 8 * min(2 * o + (m >> 1), tw8 - 1) +
                         2 * q - ss.pad;
          if (c >= pl.Cs) continue;
          const int row = (b / ss.per_group) * ss.cin + c;
          v[m] = dwtc::pro_pair(v[m], ss, ss.scale[row], ss.shift[row],
                                (sx >= 0 && sx < ss.W) |
                                    (sx + 1 >= 0 && sx + 1 < ss.W) << 1);
        }
      }
      stsm4t(v, smem_addr(pix + (8 * gl + mr) * CS + 8 * (mi & 1)));
    }
    const int sy = r0 + s - us.pad;
    if (us.scale != nullptr) {
      if (sy >= 0 && sy < us.H) {
        uint8_t* box = u_ring + slot * N * 128;
        for (int it = threadIdx.x; it < N * 8; it += THREADS) {
          // row u of the box, 16-byte unit cp; the swizzle put pixels
          // 8 (cp ^ (u & 7)) .. + 7 there
          const int u = it >> 3, cp = it & 7, c = n0 + u;
          if (c >= pl.Cu) continue;
          const int sx = x0 + 8 * (cp ^ (u & 7)) - us.pad;
          const int row = (b / us.per_group) * us.cin + c;
          const float sc = us.scale[row], sh = us.shift[row];
          uint32_t* p = reinterpret_cast<uint32_t*>(box + u * 128 + cp * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = sx + 2 * e;
            p[e] = dwtc::pro_pair(p[e], us, sc, sh,
                                  (x >= 0 && x < us.W) |
                                      (x + 1 >= 0 && x + 1 < us.W) << 1);
          }
        }
      }
      // the products read the box through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    // one arrival a warp, not 256 on one barrier
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[slot]);
  };

  const int wg = warp >> 2, w = warp & 3;
  const uint32_t pix_s = smem_addr(t_pix) +
      2 * (((lane & 7) + ((lane >> 4) << 3)) * CS + (((lane >> 3) & 1) << 3));
  const int rowb = pl.tw * CS * 2;
  // tile j's unit in this warp: tap t0 + j * 8 + wg * 4 + w (past the
  // group's taps its last tap, computed and never stored: every tile is
  // issued, as a run-time count of them made ptxas fence each product),
  // as its tap row past dy0 (high half) and its dx's byte offset (low
  // half)
  uint32_t toff[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int t = t0 + min(j * 8 + wg * 4 + w, units - 1);
    const int dy = t / pl.k;
    toff[j] = (uint32_t)(dy - dy0) << 16 | 2 * (t_lead + t - dy * pl.k) * CS;
  }
  float acc[J][N / 2];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[j][i] = 0.f;
    pin(acc[j]);
  }
  uint32_t a[2][J][4];
  if (threadIdx.x == 0)
    for (int s = 0; s < AHEAD && s < n_st; ++s) issue(s);
  __syncwarp();
  for (int s = 0; s < PRODUCE && s < n_st; ++s) produce(s);
  const int steps = min(BAND / 16, (q1 - x0 + 15) / 16);  // k16 steps before Wp
  for (int s = 0; s < n_st; ++s) {
    const int slot = s % STAGES;
    if (threadIdx.x == 0 && s + AHEAD < n_st) issue(s + AHEAD);
    __syncwarp();
    if (s + PRODUCE < n_st) produce(s + PRODUCE);
    __syncwarp();
    mbar_wait(&landed[slot], (s / STAGES) & 1);
    mbar_wait(&full[slot], (s / STAGES) & 1);
    const int vb = (r0 + s + dy0) % pl.rt;
    uint32_t off[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int row = vb + (int)(toff[j] >> 16);
      if (row >= pl.rt) row -= pl.rt;
      off[j] = pix_s + row * rowb + (toff[j] & 0xffffu);
    }
    const uint64_t ud = sw128_desc(u_ring + slot * N * 128);
    // a k16 step: each tile's A fragment (ldmatrix.x4.trans at its tap's
    // row and column), then its product, one commit group; the step before
    // the previous one is then complete, so its fragments may be reloaded.
    // Unrolled, and drained at the stage's end, so that ptxas sees that (a
    // group in flight across a loop's back edge, or a barrier arrive among
    // the steps, made it serialise the products, C7513).
#pragma unroll
    for (int kk = 0; kk < BAND / 16; ++kk) {
      if (kk >= steps) break;
#pragma unroll
      for (int j = 0; j < J; ++j)
        ldsm4t(a[kk & 1][j], off[j] + kk * 32 * CS);
      wg_fence();
#pragma unroll
      for (int j = 0; j < J; ++j) wg_rs<N>(acc[j], a[kk & 1][j], ud + 2 * kk);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) pin(acc[j]);

  float* out = partial + (size_t)strip * pl.k * pl.k * pl.Cs * pl.Cu;
  const int gid = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int uidx = j * 8 + wg * 4 + w;
    if (uidx >= units) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + gid + 8 * h;
      if (c >= pl.Cs) continue;
      float* orow = out + ((size_t)(t0 + uidx) * pl.Cs + c) * pl.Cu;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const int u = n0 + 8 * i + 2 * q;
        if (u < pl.Cu) orow[u] = acc[j][4 * i + 2 * h];
        if (u + 1 < pl.Cu) orow[u + 1] = acc[j][4 * i + 2 * h + 1];
      }
    }
  }
}

// cuTensorMapEncodeTiled from the libcuda the process has loaded (no link
// against it), as attention.cu finds it.
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

// A map of s's source tensor [B, cin, H, W] read in boxes of [box_c
// channels][1 row][box_w columns], zero outside it (negative coordinates
// included), 128-byte swizzled or not. TMA needs a 16-byte aligned base and
// rows of a multiple of 8 elements: false otherwise.
bool tensor_map(CUtensorMap* map, const bf16* base, const Src& s, int B,
                int box_w, int box_c, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(base) % 16 || s.W % 8)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)s.W, (cuuint64_t)s.H,
                              (cuuint64_t)s.cin, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.W * 2,
                                 (cuuint64_t)s.H * s.W * 2,
                                 (cuuint64_t)s.cin * s.H * s.W * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, 1, (cuuint32_t)box_c, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<bf16*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// T (tx through ss, Cs = ss.cin channels) tapped, U (ux through us, Cu =
// us.cin) untapped over [Hp, Wp]; tg taps a group, strips of `rows` rows.
// partial: [B * ceil(Hp / rows) * ceil((Wp + lead) / 64), k * k * Cs * Cu]
// (lead = -us.pad mod 8); dw as conv_dw_sum_kernel<trans> leaves it.
template <int N>
int launch(const bf16* tx, const Src& ss, const bf16* ux, const Src& us,
           float* partial, float* dw, int B, int Hp, int Wp, int k, int tg,
           int rows, bool trans, cudaStream_t st) {
  Plan pl;
  pl.Cs = ss.cin;
  pl.Cu = us.cin;
  pl.Hp = Hp;
  pl.Wp = Wp;
  pl.k = k;
  pl.tg = tg;
  pl.groups = (k * k + tg - 1) / tg;
  pl.ncg = (pl.Cs + 15) / 16;
  pl.chunks = (pl.Cu + N - 1) / N;
  pl.rows = rows;
  pl.n_rs = (Hp + rows - 1) / rows;
  pl.lead = ((-us.pad) % 8 + 8) % 8;
  pl.n_bands = (Wp + pl.lead + BAND - 1) / BAND;
  pl.tw = tile_width(k);
  pl.rt = ring_rows(k, tg);
  Maps maps;
  if (k < 2 || tg < 1 || tg > 8 * tiles_for(N) || rows < 1 ||
      rows > MAX_ROWS || ss.stride != 1 || us.stride != 1 ||
      pl.tw > MAX_TW || !tensor_map(&maps.t, tx, ss, B, pl.tw, 16, false) ||
      !tensor_map(&maps.u, ux, us, B, BAND, N, true))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, k, tg);
  cudaError_t e = cudaFuncSetAttribute(
      conv_dw_wg_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_slices = B * pl.n_rs * pl.n_bands;
  const long long blocks =
      (long long)n_slices * pl.ncg * pl.groups * pl.chunks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  conv_dw_wg_kernel<N><<<(unsigned)blocks, THREADS, smem, st>>>(
      maps, ss, us, pl, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n_out = k * k * pl.Cs * pl.Cu;
  const dim3 rblock(32, n_slices < 32 ? n_slices : 32);
  if (trans)
    dwtc::conv_dw_sum_kernel<true><<<(n_out + 31) / 32, rblock, 0, st>>>(
        partial, dw, n_out, n_slices, pl.Cu);
  else
    dwtc::conv_dw_sum_kernel<false><<<(n_out + 31) / 32, rblock, 0, st>>>(
        partial, dw, n_out, n_slices, pl.Cu);
  return (int)cudaGetLastError();
}

// What the card makes of instance N at k, tg: out = {threads, stages,
// shared memory bytes, blocks an SM, registers a thread at launch, local
// bytes a thread, J}.
template <int N>
int info(int k, int tg, int* out) {
  const size_t smem = smem_bytes(N, k, tg);
  cudaError_t e = cudaFuncSetAttribute(
      conv_dw_wg_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, conv_dw_wg_kernel<N>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, conv_dw_wg_kernel<N>);
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {THREADS, STAGES, (int)smem, blocks, attr.numRegs,
                       (int)attr.localSizeBytes, tiles_for(N)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// The instances' N (ops/conv.py WG_NS): every Cu up to 136 in one chunk,
// at most a few columns of padding
#define WGDW_NS(X) X(16) X(24) X(32) X(40) X(48) X(64) X(72) X(96) X(136)

}  // namespace wgdw

// ---------------------------------------------------------------------------
// fp32 K3, K4 and K7 on the tensor cores in split TF32 (namespace tc32):
// every form (VALID with a border, the prologue, stride 2 by phases, SAME,
// the K3''' statistics, the input gradient) at any k >= 1. They replace
// _make_conv_kernel (:157), _make_dw_kernel (:401) and
// _make_dw_kernel_gtap (:455) in fp32, as ops/conv.py conv_route sends
// every fp32 K3, K4 and K7 launch here (K7 at any k >= 2).
// Products: mma.sync m16n8k8 .tf32 in three terms (tf32.cuh: hi*lo + lo*hi
// + hi*hi, the small terms first; fp32 accumulators), which keep the fp32
// plain versions' 1e-4 x max. What bounds them: at main_fp32's sites
// ([2,36,896,896]->16 and [2,68,448,448]->32, k = 3) a call moves about 170
// and 80 MB (0.05 and 0.025 ms at 3.35 TB/s) for 16.6 and 15.8 GFLOP, which
// as three TF32 products at 495 TFLOP/s take 0.10 ms: the bound is the
// operations. mma.sync reaches a part of that rate (the fp32 attention's
// products run at about 85 TFLOP/s a term, PERF.md), so the designs keep
// the work around the products small: each operand element is split once
// where it is reused (K3's V once per stage, as it feeds every tap; its
// weights once per unit, as they feed every pixel of the stage; K4's
// cotangent once per stage, as it feeds every tap and channel), index
// arithmetic divides by run-time values through FDiv, and in fp32 every
// element is its own 32-bit register, so a tap shift is an address offset
// in a shared tile: no byte permute and no ldmatrix alignment, which the
// bf16 forms needed. The parts that remain (the products, the copies, the
// split pass) each take 10-35% of a call, so no one part binds
// (tools/px_ablation.py --tf32, PERF.md).
// Staging: raw fp32 through cp.async, 16-byte vectors where the source rows
// allow (stride 1, W % 4 == 0, x 16-byte aligned: a tile then starts up to
// LEAD columns left of its stage, so that its first source column is a
// multiple of 4), else 4-byte copies through Src (the phase images of
// stride 2, other widths); both zero-fill outside x. The prologue
// (recomputed on the read, as the TPU kernels do) and the split run in one
// pass over the landed tile; the next unit's copies are in flight during
// this unit's products. Accumulation: the products of a short run (K3: a
// tap row of one m16 tile; K4: one k8 step) go into a zeroed fragment,
// which is added to the accumulators in fp32 (tf32.cuh mma3_cols_add):
// with one chain over the whole contraction the tensor cores' truncating
// accumulation drifted past chip_smoke's 9x9 generator gate.
//   * K3 (conv_fwd_tf32_kernel<NB>): y[co, p] = sum over (tap, c) of
//     V[c, p + tap] w[tap, c, co] as one implicit GEMM with the pixels on
//     M and Cout on N: each m16 tile is 16 output pixels of a row, each n8
//     tile 8 output channels, each k8 step 8 channels of V at one tap
//     (Cout on N wastes less than on M at Cout 36 and 68, the input
//     gradients' widths). A block owns a strip of output pixels and NB n8
//     tiles of Cout; it walks the strip in stages of TR rows (one a warp) x
//     16 MT columns (MT m16 tiles a warp) and each stage in units of CK
//     channels of V and a group of ndy tap rows (all of them where the tile
//     fits: ops/conv.py fwd_tf32_tiling). A unit's V tile [CK][TR + ndy -
//     1][rs] is split into {hi, lo} pairs (float2: one 64-bit load a
//     fragment element, planes of 4 mod 16 pairs: conflict-free), its
//     weights into the B fragments' order (one 128-bit load a lane). The
//     K3''' epilogue adds each stage's outputs and their squares per
//     channel (lanes, then the warp's own shared-memory slot), the 8 warps'
//     slots in order into the strip's row of st_part (no atomics);
//     conv_stats_reduce_kernel adds a stack's strips in a fixed order.
//   * K4 (conv_dw_tf32_kernel<NB, false>): dw[tap, c, co] = sum over p of
//     V[c, p + tap] g[co, p], M = the (tap, c) rows of the block's channels
//     (tap-major, c fastest, padded to 16 once), N = Cout, the contraction
//     over the pixels in k8 steps of 8 pixels of a row. A block owns a
//     strip of pixels, cb channels of V and NB n8 tiles of Cout; it walks
//     the strip in stages of DR x DC pixels, V's tile (with its k - 1 halo)
//     raw in two buffers (an A fragment is split as it is read: V at pixel
//     + tap, any shift free), g's tile split once into {hi, lo} pairs. The
//     warps split M (wm groups, UPW m16 tiles each) and the stage's k8
//     steps (8 / wm groups, added in order through shared memory at the
//     end); each strip's block writes one fp32 partial [M, N] and
//     conv_dw_sum_kernel adds the strips in a fixed order. No atomics in
//     either: a seeded run repeats bit for bit.
//   * K7 (conv_dw_tf32_kernel<NB, true>): the same kernel with the roles
//     swapped, as dwtc swaps them in bf16: M = the (tap', co) rows of the
//     cotangent tapped with a border of k - 1 (its raw tile in two buffers,
//     split as read), N = Cin, V untapped over its own extent (Ho + k - 1)
//     x (Wo + k - 1), split once a stage with the prologue applied in that
//     pass; conv_dw_sum_kernel<true> adds the strips and transposes.
// ---------------------------------------------------------------------------
namespace tc32 {

constexpr int THREADS = 256, WARPS = 8;
constexpr int CK = 8;        // K3: V's channels a unit stages, one k8 step a tap (ops/conv.py TF32_CK)
constexpr int TR = 8;        // K3: output rows of a stage, one a warp (TF32_ROWS)
constexpr int LEAD = 3;      // most columns a tile starts left of its stage (TF32_LEAD)
constexpr int DR = 4;        // K4: pixel rows of a stage (TF32_DW_ROWS)
constexpr int DC = 32;       // K4: pixel columns of a stage (TF32_DW_COLS)
constexpr int GP = DR * DC + 4;   // K4: pairs of a split g plane, 4 mod 16 (TF32_G_PLANE)

// K3's m16 tiles a warp (16 MT output columns), K4's m16 tiles a warp,
// beside NB n8 tiles: at most 64 fp32 accumulators a thread (ops/conv.py
// tf32_mt, tf32_upw).
__host__ __device__ constexpr int mt_of(int nb) { return nb <= 4 ? 4 : 2; }
__host__ __device__ constexpr int upw_of(int nb) {
  return nb <= 2 ? 4 : (nb <= 4 ? 3 : 2);
}
// Row stride of a staged tile whose stage needs `cols` columns: the lead
// and whole 16-byte vectors (ops/conv.py tf32_rs).
__host__ __device__ constexpr int tile_rs(int cols) {
  return (LEAD + cols + 3) & ~3;
}
// The least plane stride >= n that is 4 mod m (n a multiple of 4;
// ops/conv.py tf32_plane).
__host__ __device__ constexpr int plane4(int n, int m) {
  return n + ((4 - n) % m + m) % m;
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dwtc::smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dwtc::smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// n / d for 0 <= n < 2^21 by a float reciprocal: exact there ((n + 0.5) / d
// lies at least 0.5 / d from an integer, further than the product's
// rounding error), in four instructions where a division by a run-time
// integer takes about twenty (the index arithmetic of the loops below).
struct FDiv {
  int d;
  float inv;
  __host__ __device__ explicit FDiv(int d_) : d(d_), inv(1.f / d_) {}
  __device__ __forceinline__ int div(int n) const {
    return (int)(((float)n + 0.5f) * inv);
  }
};

// Where V[b, c, vy, vx] lies in x (the caller adds b's offset): the
// element's offset in its image, its source channel ci (for the prologue's
// row); false outside x (the border, past the phase image). cin: s.cin's
// divider.
__device__ __forceinline__ bool v_pos(const Src& s, const FDiv& cin, int c,
                                      int vy, int vx, int& ci, size_t& off) {
  int py = 0, px = 0;
  ci = c;
  if (s.stride == 2) {
    const int ph = cin.div(c);
    ci = c - ph * s.cin;
    py = ph >> 1;
    px = ph & 1;
  }
  const int r = s.stride * vy + py - s.pad, col = s.stride * vx + px - s.pad;
  off = ((size_t)ci * s.H + r) * s.W + col;
  return r >= 0 && r < s.H && col >= 0 && col < s.W;
}

// The prologue on an element of x, as the plain version computes it (two
// roundings, no fma).
__device__ __forceinline__ float pro(const Src& s, int b, int ci, float v) {
  const int row = (b / s.per_group) * s.cin + ci;
  float z = __fadd_rn(__fmul_rn(v, s.scale[row]), s.shift[row]);
  if (s.negslope != 1.f) z = z >= 0.f ? z : z * s.negslope;
  return z;
}

// Raw V into dst[c][row][col] (plane and row stride rs in floats): nch
// channels from c0 (zero from cv on), nrows rows from vy0 and rs columns
// from vx0 in V's coordinates, zero outside x. vec: 16-byte copies
// (stride 1, W % 4 == 0, x 16-byte aligned, vx0 - pad a multiple of 4:
// each vector lies wholly inside or outside x's columns); else 4-byte
// copies through the mapping. The caller commits; the prologue comes
// after the copies land.
__device__ __forceinline__ void stage_v(const float* __restrict__ x,
                                        const Src& s, int b, int c0, int nch,
                                        int cv, int vy0, int nrows, int vx0,
                                        int rs, int plane, bool vec,
                                        float* dst) {
  const float* xb = x + (size_t)b * s.cin * s.H * s.W;
  const FDiv rows(nrows);
  if (vec) {
    const FDiv nv(rs >> 2);
    const int items = nch * nrows * nv.d;
    for (int it = threadIdx.x; it < items; it += THREADS) {
      const int line = nv.div(it), v = it - line * nv.d;
      const int c = rows.div(line), ly = line - c * nrows;
      const int r = vy0 + ly - s.pad, col = vx0 + 4 * v - s.pad;
      const bool ok = c0 + c < cv && r >= 0 && r < s.H && col >= 0 &&
                      col < s.W;
      const float* src =
          ok ? xb + ((size_t)(c0 + c) * s.H + r) * s.W + col : x;
      cp16(dst + c * plane + ly * rs + 4 * v, src, ok);
    }
  } else {
    const FDiv cols(rs), cin(s.cin);
    const int items = nch * nrows * rs;
    for (int it = threadIdx.x; it < items; it += THREADS) {
      const int line = cols.div(it), j = it - line * rs;
      const int c = rows.div(line), ly = line - c * nrows;
      int ci;
      size_t off;
      const bool ok = c0 + c < cv && v_pos(s, cin, c0 + c, vy0 + ly, vx0 + j,
                                           ci, off);
      cp4(dst + c * plane + ly * rs + j, ok ? xb + off : x, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

// Shared memory of conv_fwd_tf32_kernel<NB> (ops/conv.py fwd_tf32_smem):
// the split V tile, the split weight fragments, the raw V tile, the raw
// weights and the K3''' slots.
struct FwdLayout {
  int vr, rs, vplane, splane, ntap;
  __host__ __device__ FwdLayout(int k, int ndy, int nb) {
    vr = TR + ndy - 1;
    rs = tile_rs(16 * mt_of(nb) + k - 1);
    vplane = vr * rs;
    splane = plane4(vplane, 16);
    ntap = ndy * k;
  }
  __host__ __device__ size_t floats(int nb) const {
    return (size_t)2 * CK * splane + (size_t)4 * ntap * nb * 32 +
           (size_t)CK * vplane + (size_t)ntap * CK * 8 * nb +
           (size_t)WARPS * 2 * 8 * nb;
  }
};

// The raw weights of a unit, wr[tl][c][co] for its taps [t0, t0 + ntaps),
// V's channels [c0, c0 + CK) and Cout's [n0, n0 + 8 NB): zero past Cv and
// Cout; 16-byte copies where vec (Cout a multiple of 4, w 16-byte
// aligned).
template <int NB>
__device__ __forceinline__ void stage_w(const float* __restrict__ w,
                                        int t0, int ntaps, int c0, int cv,
                                        int n0, int cout, bool vec,
                                        float* wr) {
  constexpr int NCO = 8 * NB;
  if (vec) {
    const int items = ntaps * CK * (NCO / 4);
    for (int it = threadIdx.x; it < items; it += THREADS) {
      const int row = it / (NCO / 4), v = it - row * (NCO / 4);
      const int tl = row / CK, c = row - tl * CK, co = n0 + 4 * v;
      const bool ok = c0 + c < cv && co < cout;
      cp16(wr + row * NCO + 4 * v,
           ok ? w + ((size_t)(t0 + tl) * cv + c0 + c) * cout + co : w, ok);
    }
  } else {
    const int items = ntaps * CK * NCO;
    for (int it = threadIdx.x; it < items; it += THREADS) {
      const int row = it / NCO, o = it - row * NCO;
      const int tl = row / CK, c = row - tl * CK, co = n0 + o;
      const bool ok = c0 + c < cv && co < cout;
      cp4(wr + it, ok ? w + ((size_t)(t0 + tl) * cv + c0 + c) * cout + co : w,
          ok);
    }
  }
}

// A unit's products for one warp's stage row: nd rows of k taps; for each
// tap row and each of the MT m16 tiles, the row's taps into a zeroed
// fragment, which is then added to the tile's accumulators in fp32 (the
// tensor cores truncate as they accumulate: tf32.cuh mma3_cols_add). A tap
// is the B fragments of its NB n8 tiles (split weights, one 128-bit load
// a lane), the A fragment (pixels g and g + 8, channels t and t + 4 of the
// split V tile at the tap's shift: four 64-bit loads of {hi, lo}) and
// three products. KS = 3: the training net's 3x3 with every tap row in
// the unit, the loops unrolled (a tap's loads issue during the previous
// tap's products, and a row's B fragments serve every m16 tile where the
// registers hold them); KS = 0: nd and k at run time.
template <int NB, int MT, int KS>
__device__ __forceinline__ void fwd_products(float (&acc)[MT][NB][4],
                                             const float2* vw,
                                             const float4* wf, int splane,
                                             int rs, int nd, int k,
                                             int lane) {
  const int rows = KS ? KS : nd, cols = KS ? KS : k;
#pragma unroll
  for (int dyl = 0; dyl < rows; ++dyl) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int dx = 0; dx < cols; ++dx) {
        const int tl = dyl * cols + dx;
        tf32::FragB bf[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float4 f = wf[(tl * NB + j) * 32 + lane];
          bf[j].hi[0] = __float_as_uint(f.x);
          bf[j].hi[1] = __float_as_uint(f.y);
          bf[j].lo[0] = __float_as_uint(f.z);
          bf[j].lo[1] = __float_as_uint(f.w);
        }
        const float2* vt = vw + dyl * rs + dx + 16 * i;
        const float2 a0 = vt[0], a1 = vt[8];
        const float2 a2 = vt[4 * splane], a3 = vt[4 * splane + 8];
        tf32::FragA a;
        a.hi[0] = __float_as_uint(a0.x);
        a.hi[1] = __float_as_uint(a1.x);
        a.hi[2] = __float_as_uint(a2.x);
        a.hi[3] = __float_as_uint(a3.x);
        a.lo[0] = __float_as_uint(a0.y);
        a.lo[1] = __float_as_uint(a1.y);
        a.lo[2] = __float_as_uint(a2.y);
        a.lo[3] = __float_as_uint(a3.y);
        tf32::mma3_cols<NB>(s, a, bf);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += s[j][e];
    }
  }
}

// Grid: (B * strips_y * strips_x, ceil(Cout / 8 NB)). Warp w owns output
// row w of each stage: MT m16 tiles (16 MT columns) x NB n8 tiles. Units
// (stage, chunk of CK channels, group of ndy tap rows) run stage-major;
// a stage's accumulators live through its units. vec: V by 16-byte
// copies; w_vec: the weights likewise.
template <int NB>
__global__ void __launch_bounds__(THREADS, 2)
conv_fwd_tf32_kernel(const float* __restrict__ x, Src src,
                     const float* __restrict__ w, float* __restrict__ y,
                     float* __restrict__ st_part, int Cv, int Cout, int Ho,
                     int Wo, int k, int rows, int cols, int strips_y,
                     int strips_x, int ndy, int vec, int w_vec) {
  constexpr int MT = mt_of(NB), TCW = 16 * MT, NCO = 8 * NB;
  const FwdLayout L(k, ndy, NB);
  const int n_dyg = (k + ndy - 1) / ndy;
  extern __shared__ float4 smem4[];
  float2* vs = reinterpret_cast<float2*>(smem4);              // [CK][splane]
  float4* wf = reinterpret_cast<float4*>(vs + CK * L.splane);  // [ntap][NB][32]
  float* vraw = reinterpret_cast<float*>(wf + L.ntap * NB * 32);  // [CK][vplane]
  float* wraw = vraw + CK * L.vplane;                     // [ntap][CK][NCO]
  float* red = wraw + L.ntap * CK * NCO;                  // [WARPS][2][NCO]

  const int per_image = strips_y * strips_x;
  const int b = blockIdx.x / per_image;
  const int sy = blockIdx.x % per_image / strips_x;
  const int sxi = blockIdx.x % strips_x;
  const int r0 = sy * rows, r1 = min(r0 + rows, Ho);
  const int q0 = sxi * cols, q1 = min(q0 + cols, Wo);
  const int n0 = blockIdx.y * NCO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lead = src.stride == 1 ? ((-src.pad) % 4 + 4) % 4 : 0;
  const int n_cc = (Cv + CK - 1) / CK;
  const int sx_n = (q1 - q0 + TCW - 1) / TCW;
  const int per_st = n_cc * n_dyg;
  const int units = (r1 - r0 + TR - 1) / TR * sx_n * per_st;
  const FDiv rsd(L.rs), cind(src.cin);

  // unit u: stage s, V's channels [c0, c0 + CK), tap rows [dy0, dy0 + nd)
  const auto unit = [&](int u, int& y0, int& x0, int& c0, int& dy0,
                        int& nd) {
    const int s = u / per_st, rem = u - s * per_st;
    const int cc = rem / n_dyg;
    y0 = r0 + TR * (s / sx_n);
    x0 = q0 + TCW * (s % sx_n);
    c0 = cc * CK;
    dy0 = (rem - cc * n_dyg) * ndy;
    nd = min(ndy, k - dy0);
  };
  const auto stage_unit = [&](int u) {
    int y0, x0, c0, dy0, nd;
    unit(u, y0, x0, c0, dy0, nd);
    stage_v(x, src, b, c0, CK, Cv, y0 + dy0, L.vr, x0 - lead, L.rs,
            L.vplane, vec, vraw);
    stage_w<NB>(w, dy0 * k, nd * k, c0, Cv, n0, Cout, w_vec, wraw);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  if (st_part != nullptr)
    for (int i = threadIdx.x; i < WARPS * 2 * NCO; i += THREADS) red[i] = 0.f;
  float acc[MT][NB][4];
  stage_unit(0);
  for (int u = 0; u < units; ++u) {
    int y0, x0, c0, dy0, nd;
    unit(u, y0, x0, c0, dy0, nd);
    const int rem = u % per_st;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    // unit u's copies have landed; every warp is done with unit u - 1
    __syncthreads();
    // V: the prologue on x's own elements, then {hi, lo}, four elements
    // of a row at a time (rs and vplane are multiples of 4)
    for (int c = 0; c < CK; ++c) {
      for (int r4 = 4 * threadIdx.x; r4 < L.vplane; r4 += 4 * THREADS) {
        const float4 raw =
            *reinterpret_cast<const float4*>(vraw + c * L.vplane + r4);
        float e[4] = {raw.x, raw.y, raw.z, raw.w};
        if (src.scale != nullptr && c0 + c < Cv) {
          const int ly = rsd.div(r4), j = r4 - ly * L.rs;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            int ci;
            size_t off;
            if (v_pos(src, cind, c0 + c, y0 + dy0 + ly, x0 - lead + j + q,
                      ci, off))
              e[q] = pro(src, b, ci, e[q]);
          }
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) tf32::split(e[q], hi[q], lo[q]);
        float4* d = reinterpret_cast<float4*>(vs + c * L.splane + r4);
        d[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(lo[0]),
                           __uint_as_float(hi[1]), __uint_as_float(lo[1]));
        d[1] = make_float4(__uint_as_float(hi[2]), __uint_as_float(lo[2]),
                           __uint_as_float(hi[3]), __uint_as_float(lo[3]));
      }
    }
    // the weights in the B fragments' order: {hi b0, hi b1, lo b0, lo b1}
    // of lane (g, t): w[c0 + t][n] and w[c0 + t + 4][n], n = 8j + g
    for (int i = threadIdx.x; i < nd * k * NB * 32; i += THREADS) {
      const int tl = i / (NB * 32), j = i / 32 - tl * NB, ln = i & 31;
      const float* p = wraw + (tl * CK + (ln & 3)) * NCO + 8 * j + (ln >> 2);
      uint32_t h0, l0, h1, l1;
      tf32::split(p[0], h0, l0);
      tf32::split(p[4 * NCO], h1, l1);
      wf[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(l0), __uint_as_float(l1));
    }
    __syncthreads();
    if (u + 1 < units) stage_unit(u + 1);
    if (rem == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    const int oy = y0 + warp;
    if (oy < r1) {                        // rows past the strip: no work
      const float2* vw = vs + t * L.splane + warp * L.rs + lead + g;
      if (k == 3 && nd == 3)
        fwd_products<NB, MT, 3>(acc, vw, wf, L.splane, L.rs, nd, k, lane);
      else
        fwd_products<NB, MT, 0>(acc, vw, wf, L.splane, L.rs, nd, k, lane);
    }
    if (rem != per_st - 1 || oy >= r1) continue;
    // the stage's last unit: y, and the K3''' sums of the stored values
    float s1[NB][2], s2[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) s1[j][e] = s2[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = x0 + 16 * i + g + 8 * h;
        if (ox >= q1) continue;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = n0 + 8 * j + 2 * t + e;
            if (co >= Cout) continue;
            const float v = acc[i][j][2 * h + e];
            y[(((size_t)b * Cout + co) * Ho + oy) * Wo + ox] = v;
            s1[j][e] += v;
            s2[j][e] += v * v;
          }
        }
      }
    }
    if (st_part == nullptr) continue;
    // the eight lanes g of each channel, then into this warp's slot
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], o);
          s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], o);
        }
        if (g == 0) {
          red[(warp * 2 + 0) * NCO + 8 * j + 2 * t + e] += s1[j][e];
          red[(warp * 2 + 1) * NCO + 8 * j + 2 * t + e] += s2[j][e];
        }
      }
    }
  }
  if (st_part == nullptr) return;
  // K3''': the strip's sums per channel, the 8 warps' slots in order
  __syncthreads();
  if (threadIdx.x < 2 * NCO) {
    const int which = threadIdx.x / NCO, c = threadIdx.x % NCO;
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += red[(i * 2 + which) * NCO + c];
    if (n0 + c < Cout)
      st_part[((size_t)blockIdx.x * 2 + which) * Cout + n0 + c] = s;
  }
}

template <int NB>
int launch_fwd(const float* x, const Src& src, const float* w, float* y,
               float* st_part, float* stats, int B, int Cout, int Ho, int Wo,
               int k, int rows, int cols, int ndy, cudaStream_t st) {
  constexpr int TCW = 16 * mt_of(NB);
  const int Cv = src.stride * src.stride * src.cin;
  if (k < 1 || ndy < 1 || ndy > k || rows < TR || rows % TR || cols < TCW ||
      cols % TCW)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * FwdLayout(k, ndy, NB).floats(NB);
  cudaError_t e = cudaFuncSetAttribute(
      conv_fwd_tf32_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int strips_y = (Ho + rows - 1) / rows;
  const int strips_x = (Wo + cols - 1) / cols;
  const dim3 grid(B * strips_y * strips_x, (Cout + 8 * NB - 1) / (8 * NB));
  const int vec = src.stride == 1 && src.W % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  conv_fwd_tf32_kernel<NB><<<grid, THREADS, smem, st>>>(
      x, src, w, y, st_part, Cv, Cout, Ho, Wo, k, rows, cols, strips_y,
      strips_x, ndy, vec, w_vec);
  int err = (int)cudaGetLastError();
  if (err || st_part == nullptr) return err;
  const int groups = B / src.per_group;
  conv_stats_reduce_kernel<<<groups * 2 * Cout, NT, 0, st>>>(
      st_part, stats, src.per_group * strips_y * strips_x, Cout);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4 and K7
// ---------------------------------------------------------------------------

// Shared memory of conv_dw_tf32_kernel<NB, GTAP> (ops/conv.py
// dw_tf32_smem): two raw tiles of the tapped operand (cb channels), the
// untapped operand's raw tile (K4's g: DR x DC a channel; K7's V: DR rows
// of tile_rs(DC), from up to LEAD columns left of the stage) and its split
// planes; the row groups' sums at the end reuse it.
struct DwLayout {
  int vr, rs, vplane, urs;
  __host__ __device__ DwLayout(int k, bool gtap) {
    vr = DR + k - 1;
    rs = tile_rs(DC + k - 1);
    vplane = plane4(vr * rs, 32);
    urs = gtap ? tile_rs(DC) : DC;
  }
  __host__ __device__ size_t floats(int cb, int nb, int wm) const {
    const size_t stage = (size_t)2 * cb * vplane + (size_t)8 * nb * DR * urs +
                         (size_t)2 * 8 * nb * GP;
    const size_t red = wm == WARPS ? 0
        : (size_t)WARPS * upw_of(nb) * 16 * 8 * nb;
    return stage > red ? stage : red;
  }
};

// g's raw tile of the stage at (y0, x0): gr[co][row][col] for Cout's
// [n0, n0 + 8 NB), DR rows, DC columns; zero past Cu and past the strip
// (r1, q1): rows past a strip's end belong to the next. vec: 16-byte
// copies (Wp % 4 == 0, g 16-byte aligned).
template <int NB>
__device__ __forceinline__ void stage_g(const float* __restrict__ g, int b,
                                        int n0, int Cu, int Hp, int Wp,
                                        int y0, int x0, int r1, int q1,
                                        bool vec, float* gr) {
  constexpr int NCO = 8 * NB;
  if (vec) {
    for (int it = threadIdx.x; it < NCO * DR * DC / 4; it += THREADS) {
      const int line = it / (DC / 4), v = it - line * (DC / 4);
      const int co = line / DR, yy = y0 + line - co * DR, xx = x0 + 4 * v;
      const bool ok = n0 + co < Cu && yy < r1 && xx < q1;
      cp16(gr + 4 * it,
           ok ? g + (((size_t)b * Cu + n0 + co) * Hp + yy) * Wp + xx : g, ok);
    }
  } else {
    for (int it = threadIdx.x; it < NCO * DR * DC; it += THREADS) {
      const int line = it / DC, xx = x0 + it - line * DC;
      const int co = line / DR, yy = y0 + line - co * DR;
      const bool ok = n0 + co < Cu && yy < r1 && xx < q1;
      cp4(gr + it,
          ok ? g + (((size_t)b * Cu + n0 + co) * Hp + yy) * Wp + xx : g, ok);
    }
  }
}

// Both weight gradients as one implicit GEMM that contracts a tap-shifted
// operand S with an unshifted one U over the pixels p of [Hp, Wp] (dwtc's
// formulation):
//   partial[strip][(tap * Cs + s) * Cu + u] = sum over the strip's pixels
//   p of S[s, p + tap] U[u, p]
// (conv_dw_sum_kernel adds the strips; for K7 it also transposes).
//   * K4 (GTAP false): S = V (sx through ss: the border, the prologue, the
//     phases; Cs = s*s*Cin), U = g (ux, Cu = Cout, [Hp, Wp] = [Ho, Wo]).
//   * K7 (GTAP true): S = g (sx through ss: no prologue and a border of
//     k - 1, so that S[co, p + t'] = g[co, p - (k-1) + t'], zero outside
//     g; Cs = Cout), U = V (ux through us, Cu = Cin, [Hp, Wp] = V's extent
//     [Ho + k - 1, Wo + k - 1]). U's raw tile is staged as stage_v stages
//     S's (zero outside x and past Cu), from ulead columns left of the
//     stage; the split pass applies the prologue to x's own elements of
//     channels below Cu, so the border and the padded channels hold zeros
//     (NaN * 0 would be NaN). V past the strip (r1, q1: those rows belong
//     to the next strip) is staged but feeds no product: the k8 steps
//     past r1 or q1 are skipped, and q1 is a multiple of 8 from the strip's
//     start or V's edge, past which V lies outside x.
// Grid: (B * strips_y * strips_x, ceil(Cs / cb), ceil(Cu / 8 NB)). Warp
// group wmi = warp % wm owns the block's m16 tiles wmi, wmi + wm, ... (at
// most UPW); row group rg = warp / wm the stage's k8 steps rg, rg + 8 /
// wm, ... (DR * DC / 8 of them, 8 pixels of a row each). vec: S by 16-byte
// copies; u_vec: U likewise.
template <int NB, bool GTAP>
__global__ void __launch_bounds__(THREADS, 2)
conv_dw_tf32_kernel(const float* __restrict__ sx, Src ss,
                    const float* __restrict__ ux, Src us,
                    float* __restrict__ partial, int Cs, int Cu, int Hp,
                    int Wp, int k, int rows, int cols, int strips_y,
                    int strips_x, int cb, int wm, int vec, int u_vec) {
  constexpr int UPW = upw_of(NB), NCO = 8 * NB, STEPS = DR * DC / 8;
  const DwLayout L(k, GTAP);
  extern __shared__ float4 smem4[];
  float* vbuf = reinterpret_cast<float*>(smem4);            // [2][cb][vplane]
  float* uraw = vbuf + 2 * cb * L.vplane;                   // [NCO][DR][urs]
  float2* us2 = reinterpret_cast<float2*>(uraw + NCO * DR * L.urs);  // [NCO][GP]

  const int per_image = strips_y * strips_x;
  const int b = blockIdx.x / per_image;
  const int sy = blockIdx.x % per_image / strips_x;
  const int sxi = blockIdx.x % strips_x;
  const int r0 = sy * rows, r1 = min(r0 + rows, Hp);
  const int q0 = sxi * cols, q1 = min(q0 + cols, Wp);
  const int ch0 = blockIdx.y * cb, nch = min(cb, Cs - ch0);
  const int n0 = blockIdx.z * NCO;
  const int M = k * k * nch, tiles = (M + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int wmi = warp % wm, rg = warp / wm, nrg = WARPS / wm;
  const int lead = ss.stride == 1 ? ((-ss.pad) % 4 + 4) % 4 : 0;
  const int ulead = GTAP ? ((-us.pad) % 4 + 4) % 4 : 0;

  // rows gid and gid + 8 of each of this warp's m16 tiles in an S tile:
  // (tap, c) -> c's plane, the tap's shift (rows past M read element 0:
  // discarded)
  int off[UPW][2];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (i * wm + wmi) * 16 + gid + 8 * h;
      off[i][h] = 0;
      if (m < M) {
        const int tap = m / nch, c = m - tap * nch;
        off[i][h] = c * L.vplane + (tap / k) * L.rs + tap % k + lead;
      }
    }
  }
  float acc[UPW][NB][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int sx_n = (q1 - q0 + DC - 1) / DC;
  const int n_st = (r1 - r0 + DR - 1) / DR * sx_n;
  const auto stage = [&](int s) {
    const int y0 = r0 + DR * (s / sx_n), x0 = q0 + DC * (s % sx_n);
    stage_v(sx, ss, b, ch0, nch, Cs, y0, L.vr, x0 - lead, L.rs, L.vplane,
            vec, vbuf + (s & 1) * cb * L.vplane);
    if constexpr (GTAP)
      stage_v(ux, us, b, n0, NCO, Cu, y0, DR, x0 - ulead, L.urs,
              DR * L.urs, u_vec, uraw);
    else
      stage_g<NB>(ux, b, n0, Cu, Hp, Wp, y0, x0, r1, q1, u_vec, uraw);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  const FDiv cind(GTAP ? us.cin : ss.cin);
  stage(0);
  for (int s = 0; s < n_st; ++s) {
    const int y0 = r0 + DR * (s / sx_n), x0 = q0 + DC * (s % sx_n);
    float* vb = vbuf + (s & 1) * cb * L.vplane;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    // stage s has landed; every warp is done with stage s - 1
    __syncthreads();
    if (!GTAP && ss.scale != nullptr) {
      // K4: the prologue on x's own elements of V's tile, in place
      const FDiv rsd(L.rs), vrd(L.vr);
      for (int i = threadIdx.x; i < nch * L.vr * L.rs; i += THREADS) {
        const int line = rsd.div(i), j = i - line * L.rs;
        const int c = vrd.div(line), ly = line - c * L.vr;
        int ci;
        size_t o;
        float* p = vb + c * L.vplane + ly * L.rs + j;
        if (v_pos(ss, cind, ch0 + c, y0 + ly, x0 - lead + j, ci, o))
          *p = pro(ss, b, ci, *p);
      }
    }
    // U's split planes (K7: V with the prologue on x's own elements)
    for (int i = threadIdx.x; i < NCO * DR * DC; i += THREADS) {
      const int co = i / (DR * DC);
      float e;
      if constexpr (GTAP) {
        const int p = i - co * (DR * DC), ry = p / DC, cx = p - ry * DC;
        e = uraw[(co * DR + ry) * L.urs + ulead + cx];
        int ci;
        size_t o;
        if (us.scale != nullptr && n0 + co < Cu &&
            v_pos(us, cind, n0 + co, y0 + ry, x0 + cx, ci, o))
          e = pro(us, b, ci, e);
      } else {
        e = uraw[i];
      }
      uint32_t hi, lo;
      tf32::split(e, hi, lo);
      us2[co * GP + i - co * (DR * DC)] =
          make_float2(__uint_as_float(hi), __uint_as_float(lo));
    }
    __syncthreads();
    if (s + 1 < n_st) stage(s + 1);
    for (int st = rg; st < STEPS; st += nrg) {
      const int ry = st / (DC / 8), cx = 8 * (st - ry * (DC / 8));
      if (y0 + ry >= r1 || x0 + cx >= q1) continue;   // U is zero there
      tf32::FragB bf[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float2* p = us2 + (8 * j + gid) * GP + ry * DC + cx + t;
        const float2 b0 = p[0], b1 = p[4];
        bf[j].hi[0] = __float_as_uint(b0.x);
        bf[j].hi[1] = __float_as_uint(b1.x);
        bf[j].lo[0] = __float_as_uint(b0.y);
        bf[j].lo[1] = __float_as_uint(b1.y);
      }
      const float* vp = vb + ry * L.rs + cx + t;
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        if (i * wm + wmi >= tiles) break;
        const tf32::FragA a = tf32::split_a(vp[off[i][0]], vp[off[i][1]],
                                            vp[off[i][0] + 4],
                                            vp[off[i][1] + 4]);
        tf32::mma3_cols_add<NB>(acc[i], a, bf);
      }
    }
  }

  // this strip's partial: the row groups' sums added in order (through
  // shared memory) where there are several, else each warp's own
  float* const out = partial + (size_t)blockIdx.x * k * k * Cs * Cu;
  const int mr = wm * UPW * 16;           // rows of the tile the warps hold
  float* red = reinterpret_cast<float*>(smem4);   // [nrg][mr][NCO]
  if (nrg > 1) __syncthreads();           // the last stage is read
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int tile = i * wm + wmi;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = tile * 16 + gid + 8 * h;
      const int tap = m / nch, c = m - tap * nch;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 8 * j + 2 * t + e;
          if (nrg > 1)
            red[(rg * mr + m) * NCO + u] = acc[i][j][2 * h + e];
          else if (tile < tiles && m < M && n0 + u < Cu)
            out[((size_t)tap * Cs + ch0 + c) * Cu + n0 + u] =
                acc[i][j][2 * h + e];
        }
      }
    }
  }
  if (nrg == 1) return;
  __syncthreads();
  const int nu = min(NCO, Cu - n0);
  for (int idx = threadIdx.x; idx < M * nu; idx += THREADS) {
    const int m = idx / nu, u = idx - m * nu;
    const int tap = m / nch, c = m - tap * nch;
    float v = 0.f;
    for (int r = 0; r < nrg; ++r) v += red[(r * mr + m) * NCO + u];
    out[((size_t)tap * Cs + ch0 + c) * Cu + n0 + u] = v;
  }
}

// K4 (GTAP false: dw [k, k, Cs, Cu]) or K7 (GTAP true: dw [Cu, k*k*Cs], the
// reduce transposing), S = sx through ss, U = ux (through us for K7).
template <int NB, bool GTAP>
int launch_dw(const float* sx, const Src& ss, const float* ux, const Src& us,
              float* partial, float* dw, int B, int Cs, int Cu, int Hp,
              int Wp, int k, int rows, int cols, int cb, int wm,
              cudaStream_t st) {
  if (k < 1 || cb < 1 || (wm != 1 && wm != 2 && wm != 4 && wm != 8) ||
      (k * k * (cb < Cs ? cb : Cs) + 15) / 16 > wm * upw_of(NB) ||
      rows < DR || rows % DR || cols < DC || cols % DC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * DwLayout(k, GTAP).floats(cb, NB, wm);
  cudaError_t e = cudaFuncSetAttribute(
      conv_dw_tf32_kernel<NB, GTAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int strips_y = (Hp + rows - 1) / rows;
  const int strips_x = (Wp + cols - 1) / cols;
  const dim3 grid(B * strips_y * strips_x, (Cs + cb - 1) / cb,
                  (Cu + 8 * NB - 1) / (8 * NB));
  const int vec = ss.stride == 1 && ss.W % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(sx) % 16 == 0;
  const int u_vec = (GTAP ? us.stride == 1 && us.W % 4 == 0 : Wp % 4 == 0) &&
                    reinterpret_cast<uintptr_t>(ux) % 16 == 0;
  conv_dw_tf32_kernel<NB, GTAP><<<grid, THREADS, smem, st>>>(
      sx, ss, ux, us, partial, Cs, Cu, Hp, Wp, k, rows, cols, strips_y,
      strips_x, cb, wm, vec, u_vec);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n_out = k * k * Cs * Cu;
  const int n_slices = (int)grid.x;
  const dim3 rblock(32, n_slices < 32 ? n_slices : 32);
  dwtc::conv_dw_sum_kernel<GTAP><<<(n_out + 31) / 32, rblock, 0, st>>>(
      partial, dw, n_out, n_slices, Cu);
  return (int)cudaGetLastError();
}

}  // namespace tc32

}  // namespace

// fp32 K3 on the tensor cores (split TF32, namespace tc32), every form at
// any k >= 1. x [B,Cin,H,W]; scale/shift: fp32 [groups, Cin] or null (no
// prologue); stride 1 or 2; w [k,k,s*s*Cin,Cout]; y [B,Cout,Ho,Wo] with
// Ho + k - 1 <= (H + 2pad) / stride rounded up, and likewise Wo; all fp32.
// The tiling comes from ops/conv.py fwd_tf32_tiling: nb in [1, 8] n8 tiles
// of Cout a block, the tap rows in groups of ndy, strips of rows x cols
// output pixels (multiples of 8 and 16 * tf32_mt(nb)). st_part/stats:
// null, or (K3''') fp32 scratch [B * ceil(Ho / rows) * ceil(Wo / cols), 2,
// Cout] and the output [groups, 2, Cout]: per BatchNorm stack the sum and
// the sum of squares of y.
extern "C" int conv_fwd_tf32(const void* x, const void* w, void* y,
                             const float* scale, const float* shift, int B,
                             int Cin, int H, int W, int Cout, int Ho, int Wo,
                             int k, int pad, int stride, int groups,
                             float negslope, float* st_part, float* stats,
                             int nb, int ndy, int rows, int cols,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
#define TC32_FWD(n)                                                          \
  case n:                                                                    \
    return tc32::launch_fwd<n>(xf, src, wf, yf, st_part, stats, B, Cout, Ho, \
                               Wo, k, rows, cols, ndy, st);
  switch (nb) {
    TC32_FWD(1) TC32_FWD(2) TC32_FWD(3) TC32_FWD(4)
    TC32_FWD(5) TC32_FWD(6) TC32_FWD(7) TC32_FWD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC32_FWD
}

// fp32 K4 (gtap = 0) and K7 (gtap = 1) on the tensor cores (split TF32,
// namespace tc32). K4 at any k >= 1, stride 1 or 2, with and without the
// prologue: x, scale, shift, pad, stride, groups, negslope as
// conv_fwd_tf32; g [B,Cout,Ho,Wo] fp32; dw: fp32 [k,k,s*s*Cin,Cout]. K7 at
// stride 1 and any k >= 2: dw fp32
// [Cin, k*k*Cout] with tap t' = dy'*k + dx' holding dw's tap (k-1-dy',
// k-1-dx') (the caller reverses). The tiling comes from ops/conv.py
// dw_tf32_tiling: strips of rows x cols pixels of the contraction's extent
// (Ho x Wo for K4, (Ho+k-1) x (Wo+k-1) for K7; multiples of 4 and 32), cb
// channels of the tapped operand (K4: V's s*s*Cin, K7: g's Cout) and nb in
// [1, 8] n8 tiles of the other (K4: Cout, K7: Cin) a block, wm warps along
// M. partial: fp32 scratch [strips, k*k*Cs*Cu].
extern "C" int conv_dw_tf32(const void* x, const void* g, float* partial,
                            float* dw, const float* scale, const float* shift,
                            int B, int Cin, int H, int W, int Cout, int Ho,
                            int Wo, int k, int pad, int stride, int groups,
                            float negslope, int gtap, int rows, int cols,
                            int cb, int nb, int wm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src xs = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                          negslope);
  // K7's tapped cotangent: no prologue, zero outside g, a border of k - 1
  const Src gs = make_src(nullptr, nullptr, B, Cout, Ho, Wo, k - 1, 1, 1,
                          1.f);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  if (gtap && (stride != 1 || k < 2)) return (int)cudaErrorInvalidValue;
#define TC32_DW(n)                                                           \
  case n:                                                                    \
    return gtap ? tc32::launch_dw<n, true>(gf, gs, xf, xs, partial, dw, B,   \
                                           Cout, Cin, Ho + k - 1, Wo + k - 1,\
                                           k, rows, cols, cb, wm, st)        \
                : tc32::launch_dw<n, false>(xf, xs, gf, gs, partial, dw, B,  \
                                            stride * stride * Cin, Cout, Ho, \
                                            Wo, k, rows, cols, cb, wm, st);
  switch (nb) {
    TC32_DW(1) TC32_DW(2) TC32_DW(3) TC32_DW(4)
    TC32_DW(5) TC32_DW(6) TC32_DW(7) TC32_DW(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC32_DW
}

// bf16 K3 on the tensor cores: as conv_fwd_tf32, with x, w and y bf16 and
// k in {1, 2, 3} (conv_fwd_px takes the others). The tiling comes from
// ops/conv.py fwd_tc_tiling: strips
// of rows x cols output pixels (rows a multiple of 8, cols of 8 *
// fwd_tc_nb(mt)), cb (a multiple of 16) channels of V per shared-memory
// chunk, wcb channels per tap in the weight tile (cb, or a multiple of 16
// >= s*s*Cin: all of them, staged once), mt in [1, 5] m16 tiles of Cout
// per block. st_part: [B * ceil(Ho / rows) * ceil(Wo / cols), 2, Cout].
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

// bf16 K4 (gtap = 0, k in {1, 2, 3, 4, 5, 7}: dw [k,k,s*s*Cin,Cout], as
// conv_dw_tf32; at k >= 4 only where ops/conv.py dw_px_form keeps this form,
// Cout <= 16 on a grid that busies half the SMs; conv_dw_px takes the
// others) and K7 (gtap = 1,
// stride 1, k in {2, 3, 5, 7}: dw [Cin, k*k*Cout], as conv_dw_tf32's gtap) on the
// tensor cores. x, g, scale, shift, pad, stride, groups, negslope: as
// conv_dw_tf32, x and g bf16. The tiling comes from ops/conv.py dw_tc_tiling: strips of
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
    case 4: return dwtc::launch_k<4>(sx, ss, ux, us, partial, dw, B, Cs, Cu,
                                     Hp, Wp, rows, cols, cb, bn, wm, gtap, st);
    case 5: return dwtc::launch_k<5>(sx, ss, ux, us, partial, dw, B, Cs, Cu,
                                     Hp, Wp, rows, cols, cb, bn, wm, gtap, st);
    case 7: return dwtc::launch_k<7>(sx, ss, ux, us, partial, dw, B, Cs, Cu,
                                     Hp, Wp, rows, cols, cb, bn, wm, gtap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 K3 at k >= 4 and the k2 = 3 phase kernels (namespace px): as
// conv_fwd_tc, any k. The tiling comes from ops/conv.py fwd_px_tiling: mt
// in [1, 4] m16 tiles of Cout a block, tap rows in n_dyg groups of ndy,
// V's chunks of 16 channels in n_cs groups of cps. partial: fp32 scratch
// [n_dyg * n_cs, B, Cout, Ho, Wo] unless n_dyg * n_cs == 1 and st_part is
// null (then y is stored directly and partial may be null); the second
// pass adds 512 pixels a block. st_part: [B * ceil(Ho * Wo / 512), 2,
// Cout] (an image's chunks contiguous).
extern "C" int conv_fwd_px(const void* x, const void* w, void* y,
                           float* partial, const float* scale,
                           const float* shift, int B, int Cin, int H, int W,
                           int Cout, int Ho, int Wo, int k, int pad,
                           int stride, int groups, float negslope,
                           float* st_part, float* stats, int mt, int ndy,
                           int cps, int n_cs, int n_dyg, void* stream) {
  using px::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
#define PX_FWD(m)                                                            \
  case m:                                                                    \
    return px::launch_fwd<m>(xb, src, wb, yb, partial, st_part, stats, B,   \
                             Cout, Ho, Wo, k, ndy, cps, n_cs, n_dyg, st);
  switch (mt) {
    PX_FWD(1) PX_FWD(2) PX_FWD(3) PX_FWD(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PX_FWD
}

// bf16 K4 (gtap = 0) at k >= 4 and the k2 = 3 phase kernels (namespace
// px): as conv_dw_tf32, any k; and K7 (gtap = 1, stride 1, any k >= 2:
// dw [Cin, k*k*Cout], as conv_dw_tf32's gtap; ops/conv.py routes here the k
// that conv_dw_tc has no K7 instance for). The tiling comes from
// ops/conv.py dw_px_tiling: strips of rows x cols pixels of the
// contraction's extent (Ho x Wo for K4, (Ho+k-1) x (Wo+k-1) for K7;
// multiples of 8 and 32), tap rows in groups of ndy, nb in {1, 2, 4} (K7:
// {1, 2}) n8 tiles of the untapped operand (K4: Cout, K7: Cin) a block.
// partial: fp32
// scratch [B * strips_y * strips_x, k * k * Cs * Cu].
extern "C" int conv_dw_px(const void* x, const void* g, float* partial,
                          float* dw, const float* scale, const float* shift,
                          int B, int Cin, int H, int W, int Cout, int Ho,
                          int Wo, int k, int pad, int stride, int groups,
                          float negslope, int gtap, int rows, int cols,
                          int ndy, int nb, void* stream) {
  using px::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src src = make_src(scale, shift, B, Cin, H, W, pad, stride, groups,
                           negslope);
  // K7's tapped cotangent: no prologue, zero outside g, a border of k - 1
  const Src gs = make_src(nullptr, nullptr, B, Cout, Ho, Wo, k - 1, 1, 1,
                          1.f);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  if (gtap && stride != 1) return (int)cudaErrorInvalidValue;
#define PX_DW(n)                                                             \
  case n:                                                                    \
    return px::launch_dw<n, false>(xb, src, gb, gs, partial, dw, B, Cout,    \
                                   Ho, Wo, k, rows, cols, ndy, st);
#define PX_GTAP(n)                                                           \
  case n:                                                                    \
    return px::launch_dw<n, true>(gb, gs, xb, src, partial, dw, B, Cin,      \
                                  Ho + k - 1, Wo + k - 1, k, rows, cols, ndy,\
                                  st);
  // K7's mode holds at most two n8 tiles of Cin (ops/conv.py PX_GTAP_NB):
  // at four, load_u's addressing spilled
  if (gtap) {
    switch (nb) {
      PX_GTAP(1) PX_GTAP(2)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (nb) {
    PX_DW(1) PX_DW(2) PX_DW(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PX_DW
#undef PX_GTAP
}

// bf16 K4 (gtap = 0: dw [k,k,Cin,Cout]) and K7 (gtap = 1: dw [Cin,
// k*k*Cout], taps reversed by the caller) at stride 1 on wgmma (namespace
// wgdw; ops/conv.py conv_route sends bf16 k >= 8 on large maps here). x,
// g, scale, shift, pad, groups, negslope: as conv_dw_px at stride 1. The
// tiling comes from ops/conv.py dw_wg_tiling: n (one of WGDW_NS) columns of
// the untapped operand a chunk, tg taps a group, strips of `rows` (at most
// 64) rows of a 64-pixel band of the contraction's extent (Ho x Wo for K4,
// (Ho+k-1) x (Wo+k-1) for K7). partial: fp32 scratch [B * ceil(Hp / rows)
// * ceil((Wp + lead) / 64), k * k * Cs * Cu], lead = -pad mod 8 for K7 and
// 0 for K4 (the bands start at -lead). TMA reads x and g: both 16-byte
// aligned, with rows (W, Wo) of a multiple of 8 elements, else an error.
extern "C" int conv_dw_wg(const void* x, const void* g, float* partial,
                          float* dw, const float* scale, const float* shift,
                          int B, int Cin, int H, int W, int Cout, int Ho,
                          int Wo, int k, int pad, int groups, float negslope,
                          int gtap, int n, int tg, int rows, void* stream) {
  using wgdw::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src xs = make_src(scale, shift, B, Cin, H, W, pad, 1, groups,
                          negslope);
  // g: no prologue, zero outside its extent; K7's tapped g has a border of
  // k - 1
  const Src gs = make_src(nullptr, nullptr, B, Cout, Ho, Wo,
                          gtap ? k - 1 : 0, 1, 1, 1.f);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const int Hp = gtap ? Ho + k - 1 : Ho, Wp = gtap ? Wo + k - 1 : Wo;
#define WGDW_CASE(nn)                                                        \
  case nn:                                                                   \
    return gtap ? wgdw::launch<nn>(gb, gs, xb, xs, partial, dw, B, Hp, Wp,   \
                                   k, tg, rows, true, st)                    \
                : wgdw::launch<nn>(xb, xs, gb, gs, partial, dw, B, Hp, Wp,   \
                                   k, tg, rows, false, st);
  switch (n) {
    WGDW_NS(WGDW_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WGDW_CASE
}

// conv_dw_wg's instance n at k and tg taps a group as the card runs it:
// out[7] = {threads, stages, shared memory bytes, blocks an SM, registers a
// thread, local bytes a thread, m64 tiles a consumer warpgroup holds}.
extern "C" int conv_dw_wg_info(int n, int k, int tg, int* out) {
#define WGDW_INFO(nn)                                                        \
  case nn:                                                                   \
    return wgdw::info<nn>(k, tg, out);
  switch (n) {
    WGDW_NS(WGDW_INFO)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WGDW_INFO
}


