// P1 mma_repeat: out[m, n] = bf16(sum over reps of A @ B), A [m, k] and
// B [k, n] bf16 row-major, the sum in fp32. It replaces the matrix-unit
// probe's kernel, scripts/mxu_k_probe.py _kernel (:24, launched by time_dot
// :36 and time_dot_mn :57), and asks its question of Hopper's tensor
// cores: does a 64-deep contraction, or a 64-wide output, waste part of
// the unit? The port's attention runs S^T and dP^T of the backward on
// m64n64k16 over dh = 64 and the forward's S on m64n128k16.
//
// What bounds it on the H100: the same product `reps` times over operands
// that stay in shared memory, so operations (989 TFLOP/s of bf16 on the
// tensor cores); device memory is read once. What the design does about
// it: nothing but the product runs in the timed loop. A block is one
// warpgroup and owns a [64, N] output tile (N = 64 or 128, a template
// parameter). It stages its A rows and its B columns once into shared
// memory, K-major in 64-element (128-byte) rows with the 128-byte swizzle
// that the wgmma descriptors read (the layout TMA's SWIZZLE_128B leaves,
// the one the attention kernels read; K zero-padded to a multiple of 64),
// then issues reps x kp/16 wgmma.mma_async m64nNk16 into fp32 registers,
// one commit group of four a 64-deep sub-tile, and waits on the group
// before last (wait_group 1) so that a group is always queued behind the
// one running. It writes bf16 once.
//
// K up to RESIDENT_K stays resident (A 32 KB and B 64 KB at k = 256,
// N = 128). Above it A and B do not both fit the 227 KB a block may hold
// at N = 128 (k = 768: 96 + 192 KB), so B stays resident and A's K walks
// through a two-buffer ring of KC-deep chunks by cp.async, once per rep:
// chunk c + 1 loads while chunk c's products run.
//
// clock64() around the issue loop (staging excluded, the streamed route's
// loads included) and %globaltimer around the same span go to
// stats[block] = {cycles, ns}: cycles per m64nNk16 compare instructions,
// where wall times compare waves of blocks over the 132 SMs.
//
// The C entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;          // output rows a block (the wgmma M)
constexpr int THREADS = 128;      // one warpgroup
constexpr int SUB = 64;           // K elements in one 128-byte swizzled row
constexpr int RESIDENT_K = 256;   // above: the streamed route
constexpr int KC = 128;           // K of one streamed A chunk
constexpr int SMEM_CAP = 232448;  // the most dynamic shared memory a block
                                  // may ask for on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (8-row groups 1024 bytes apart, tile 1024-byte aligned); a k16
// step inside a 64-element row advances it by 32 bytes (+2). The same
// descriptor as csrc/attention.cu's sw128_desc.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return ((smem_addr(tile) & 0x3FFFFu) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
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
// generic-proxy writes to shared memory (st.shared, cp.async) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b) {
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
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a,
                                      uint64_t b) {
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
      : "l"(a), "l"(b), "r"(1));
}

// A's rows [m0, m0 + 64), columns [k0, k0 + kc) (A row-major, k columns)
// by cp.async into a K-major swizzled tile of kp / 64 sub-tiles, zeros in
// columns [kc, kp).
__device__ __forceinline__ void stage_a(uint8_t* tile,
                                        const __nv_bfloat16* a, int k,
                                        int m0, int k0, int kc, int kp) {
  const int per_row = kp / 8;
  for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
    const int r = i / per_row, c = i % per_row;
    uint8_t* dst = tile + (c / 8) * (ROWS * 128) + sw128(r, c % 8);
    if (8 * c < kc)
      cp_async16(dst, a + (size_t)(m0 + r) * k + k0 + 8 * c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// B's columns [n0, n0 + N), all k rows (B row-major, n columns), as the
// K-major tile of B^T: 8 elements of one column gathered into each 16-byte
// chunk, zeros in columns [k, kp). Once a launch; neighbouring threads
// read neighbouring columns.
template <int N>
__device__ __forceinline__ void stage_bt(uint8_t* tile,
                                         const __nv_bfloat16* b, int n,
                                         int k, int kp, int n0) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(b);
  for (int i = threadIdx.x; i < N * (kp / 8); i += THREADS) {
    const int col = i % N, c = i / N;
    uint32_t w[4] = {0, 0, 0, 0};
    if (8 * c < k) {
      const unsigned short* p = src + (size_t)(8 * c) * n + n0 + col;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = (uint32_t)__ldg(p + (size_t)(2 * j) * n) |
               ((uint32_t)__ldg(p + (size_t)(2 * j + 1) * n) << 16);
    }
    *reinterpret_cast<uint4*>(tile + (c / 8) * (N * 128) +
                              sw128(col, c % 8)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The four k16 steps of one 64-deep sub-tile: A's at descriptor da, B's
// at db. Unrolled: a wgmma in a loop of run-time length makes ptxas wait
// on each one (C7520, "serialized ... in divergent path").
template <int N>
__device__ __forceinline__ void issue64(float (&d)[N / 2], uint64_t da,
                                        uint64_t db) {
#pragma unroll
  for (int i = 0; i < SUB / 16; ++i) wgmma(d, da + 2 * i, db + 2 * i);
}

template <int N, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
mma_repeat_kernel(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ b,
                  __nv_bfloat16* __restrict__ out,
                  long long* __restrict__ stats, int n, int k, int reps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * N;
  // B^T resident first, then A: all of it, or the two ring stages; a tile
  // holds whole 64-element rows (kp), read up to k
  const int kp = (k + SUB - 1) / SUB * SUB;
  uint8_t* bt = sm;
  uint8_t* as = sm + (size_t)N * kp * 2;
  const int a_stage = ROWS * KC * 2;
  if (STREAM) {
    stage_a(as, a, k, m0, 0, KC, KC);
  } else {
    stage_a(as, a, k, m0, 0, k, kp);
  }
  cp_async_commit();
  stage_bt<N>(bt, b, n, k, kp, n0);

  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  // a sub-tile's descriptor step: 64 rows of A, N rows of B^T
  constexpr int A_SUB = ROWS * 128 / 16, B_SUB = N * 128 / 16;
  const uint64_t db = sw128_desc(bt);
  long long c0 = 0;
  uint64_t t0 = 0;
  if (!STREAM) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    const uint64_t da = sw128_desc(as);
    const int subs = kp / SUB;
    c0 = clock64();
    t0 = global_ns();
    // one commit group a 64-deep sub-tile, the one before it still queued;
    // one flat loop (j the sub-tile) around the unrolled group
    for (int g = 0, j = 0; g < reps * subs; ++g) {
      wg_fence();
      issue64<N>(d, da + j * A_SUB, db + j * B_SUB);
      wg_commit();
      wg_wait<1>();
      j = j + 1 == subs ? 0 : j + 1;
    }
  } else {
    const int chunks = k / KC, total = reps * chunks;
    c0 = clock64();
    t0 = global_ns();
    for (int c = 0; c < total; ++c) {
      cp_async_wait_all();     // chunk c is in its stage (and B^T, once)
      fence_async_smem();
      __syncthreads();
      const uint64_t da = sw128_desc(as + (c & 1) * a_stage);
      const uint64_t dbc = db + (c % chunks) * (KC / SUB) * B_SUB;
      wg_fence();
#pragma unroll
      for (int j = 0; j < KC / SUB; ++j)
        issue64<N>(d, da + j * A_SUB, dbc + j * B_SUB);
      wg_commit();
      wg_wait<1>();            // chunk c - 1's products: its stage is free
      __syncthreads();
      if (c + 1 < total)
        stage_a(as + ((c + 1) & 1) * a_stage, a, k, m0,
                ((c + 1) % chunks) * KC, KC, KC);
      cp_async_commit();
    }
  }
  wg_wait<0>();
  pin(d);
  const long long c1 = clock64();
  const uint64_t t1 = global_ns();
  if (stats && threadIdx.x == 0) {
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    stats[2 * blk] = c1 - c0;
    stats[2 * blk + 1] = (long long)(t1 - t0);
  }

  // the accumulator: thread (warp w, lane l) holds rows 16w + l/4 and + 8,
  // columns 8j + 2(l % 4) and + 1
  const int lane = threadIdx.x & 31;
  const int row = m0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        out + (size_t)(row + 8 * h) * n + col);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      o[4 * j] = __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

template <int N, bool STREAM>
int launch(const void* a, const void* b, void* out, long long* stats, int m,
           int n, int k, int reps, cudaStream_t stream) {
  const size_t kp = (k + SUB - 1) / SUB * SUB;
  const size_t smem = N * kp * 2 +
                      (STREAM ? 2 * ROWS * KC * 2 : ROWS * kp * 2) + 1024;
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  auto kernel = mma_repeat_kernel<N, STREAM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / N, m / ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), stats, n, k, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// a: [m, k], b: [k, n], out: [m, n], bf16 row-major contiguous; m % 64,
// n % n_tile and k % 16 are 0, and k % 128 above k = 256 (the streamed
// route); n_tile 64 or 128; stats: null or int64 [m / 64, n / n_tile, 2].
extern "C" int mma_repeat(const void* a, const void* b, void* out,
                          long long* stats, int m, int n, int k, int reps,
                          int n_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m % ROWS || k % 16 || reps < 1 || (k > RESIDENT_K && k % KC) ||
      (n_tile != 64 && n_tile != 128) || n % n_tile)
    return (int)cudaErrorInvalidValue;
  const bool stream_a = k > RESIDENT_K;
  if (n_tile == 64)
    return stream_a ? launch<64, true>(a, b, out, stats, m, n, k, reps, s)
                    : launch<64, false>(a, b, out, stats, m, n, k, reps, s);
  return stream_a ? launch<128, true>(a, b, out, stats, m, n, k, reps, s)
                  : launch<128, false>(a, b, out, stats, m, n, k, reps, s);
}
