// Hopper kernels of the MoE FFN: the grouped expert matmul and its backward.
//
// moe_gmm replaces the Pallas TPU kernel moe_gmm_kernel
// (src/repro/kernels/moe_gmm/kernel.py:39): out[e] = x[e] @ w[e] for every
// expert e of the dispatched (E, C, D) block, with an fp32 accumulator and the
// output in x's dtype.  The TPU grid (E, C/bm, F/bn, D/bk) carried the
// accumulator in VMEM scratch along its sequential D axis; here one block owns
// one output tile of one expert and loops over the reduction inside.
//
// The backward (the JAX package differentiates its three MoE einsums with
// XLA, src/repro/models/blocks.py:331-337; no Pallas kernel) is two more
// grouped products, for dy (E, C, F):
//   dx[e] = dy[e] @ w[e]^T   (E, C, D), a sum over F;
//   dw[e] = x[e]^T @ dy[e]   (E, D, F), a sum over the C rows.
// Each output element is one thread's or one warpgroup's fp32 sum in a fixed
// order, written once: no atomics, so equal inputs give bit-equal outputs.
// Every kernel computes out[e] (M x N) = A[e] (M x K) . B[e] (K x N), each
// operand read in place in one of two layouts, a template switch:
//   A K-major (stored (M, K)): x in the forward, dy in the FFMA dx, w in
//     the tensor-core dx^T = w . dy^T;
//   A MN-major (stored (K, M)): x, read as x^T, in dw;
//   B MN-major (stored (K, N)): w in the forward, dy in dw;
//   B K-major (stored (N, K)): w, read as w^T, in the FFMA dx; dy, read as
//     dy^T, in the tensor-core dx^T.
//
// What bounds it on an H100: at prefill (C = 640 rows per expert for
// Llama-4-Scout at 8 x 1024 tokens) the product does 2 C D F FLOPs on
// (C D + D F) inputs, ~1000 FLOP per byte in bf16, far above the tensor
// cores' ~295 FLOP/byte ridge: bound by operations, 989 TFLOP/s.  At decode
// (C = 8) it does 8 FLOP per weight byte: bound by the bytes of w, read once.
// The backward at Scout's train microbatch (C = 320) does 2 x 2 C D F FLOPs
// on x, w, dy, dx and dw: bound by operations (dw alone writes E D F bf16,
// 1.34 GB, 0.40 ms of the 0.87 ms bound).
//
// Two variants, chosen by one rule on dtype and shape (kernels/moe_gmm/
// kernel.py: route, route_bwd):
//
// * moe_gmm_tc_kernel (the forward) and moe_gmm_bwd_tc_kernel (the
//   backward, below), bf16 with D and F multiples of 8: wgmma on the tensor
//   cores fed by TMA.  TMA needs every global stride to be a multiple of 16
//   bytes, which for bf16 rows of D or F elements means D % 8 == F % 8 == 0;
//   every served and trained shape meets it.  Each operand is read through a
//   3-D tensor map (row, column, expert) with 128-byte swizzle (boxes 64
//   elements wide).  Because the maps are 3-D, rows of a box past the expert's
//   last row are out of bounds and read as zeros, never as the next expert's
//   rows: decode (C = 8) and ragged C run without padding, ragged K adds zeros
//   on both sides of the sum (in dw, K = C: rows past C add nothing), and
//   ragged M and N are never stored.  A ring of shared-memory stages, each one
//   A tile (BM x 64 of K) and one B tile (64 of K x BN), with full and empty
//   mbarriers (the forward's design from here on: one producer thread issues
//   the TMA loads, and NC consumer warpgroups (64 rows each) issue
//   wgmma.mma_async m64nBNk16 from shared memory (tnspA / tnspB name each
//   operand's layout), keeping one wgmma group in flight while the next stage
//   is waited for.  A K-major tile is one box of BM (B: BN) rows of 64 K; an
//   MN-major tile is BM / 64 (B: BN / 64) boxes of 64 K-rows.  Large M (the
//   forward at C > 64): BM 128 (two consumer warpgroups), BN 256, 4 stages of
//   48 KB; setmaxnreg gives the consumers 232 registers (the 64 x 256 fp32
//   accumulator is 128 a thread) and the producer warpgroup 40.  M <= 64
//   (decode): BM 64, of which rows >= M are TMA zeros (the padded tensor-core
//   work, ~0.09 ms at the Scout shape, stays under the 0.40 ms byte bound), BN
//   128, and 8 stages: 128 KB of B in flight per SM, so the kernel is a stream
//   of the expert weights.  The epilogue rounds the fp32 accumulator to bf16 in
//   registers and stores rows < M, columns < N).  The backward's kernel walks
//   its tiles persistently and stores through TMA: its note is below.
//
// * moe_gmm_kernel, fp32 (the tests' and the fp32 twins' dtype) and the
//   bf16 shapes TMA cannot take: the first port's FFMA design.  One block
//   owns one (BM-row, 128-column) output tile on a grid of (N tile, M tile,
//   expert) and loops over K in steps of 32: each step stages an A tile
//   (BM x 32) and a B tile (32 x 128) in shared memory as fp32, loading each
//   along its contiguous axis, and every thread keeps 8 rows x 4 columns of
//   the accumulator in registers (66.9 TFLOP/s peak on the CUDA cores).  BM
//   follows M (8, 16, 32 or 64 rows; one warp per 8 rows); ragged edges are
//   masked by bounds, and K = 0 (dw of C = 0 rows) writes zeros.
//
// Every launcher returns cudaGetLastError() after its launches (0 on
// success); the tensor-core ones may also return hopper.cuh's tensor-map
// error codes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kWarp = 32;
constexpr int kBN = 128;  // output columns per block: 32 lanes x 4
constexpr int kBK = 32;   // depth of one shared-memory step
constexpr int kRows = 8;  // output rows per thread (and per warp)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (ceil(N / 128), ceil(M / BM), E), BM / 8 warps.  Warp wr owns rows
// m0 + 8 wr .. m0 + 8 wr + 7, lane l columns n0 + 4 l .. n0 + 4 l + 3.
// A_MN: A is stored (K, M) (else (M, K)); B_K: B is stored (N, K) (else
// (K, N)).
template <typename T, int BM, bool A_MN, bool B_K>
__global__ void __launch_bounds__(BM / kRows * kWarp)
moe_gmm_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ out, int M, int K, int N) {
  constexpr int kThreads = BM / kRows * kWarp;
  __shared__ float as[BM][kBK + 1];  // row-major, padded: no bank conflicts
  // padded by 4 floats: 16-byte rows for the float4 reads, and a store
  // along K (B_K) spreads over 8 banks
  __shared__ __align__(16) float bs[kBK][kBN + 4];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const size_t e = blockIdx.z;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* ae = a + e * M * K;
  const T* be = b + e * K * N;

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are no longer read
#pragma unroll
    for (int it = 0; it < BM * kBK / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      // neighbouring threads on neighbouring addresses of A's stored rows
      const int r = A_MN ? i % BM : i / kBK, kk = A_MN ? i / BM : i % kBK;
      const int m = m0 + r, k = k0 + kk;
      as[r][kk] = (m < M && k < K)
                      ? to_f(ae[A_MN ? static_cast<size_t>(k) * M + m
                                     : static_cast<size_t>(m) * K + k])
                      : 0.f;
    }
#pragma unroll 16
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int kk = B_K ? i % kBK : i / kBN, n = B_K ? i / kBK : i % kBN;
      const int k = k0 + kk, col = n0 + n;
      bs[kk][n] = (k < K && col < N)
                      ? to_f(be[B_K ? static_cast<size_t>(col) * K + k
                                    : static_cast<size_t>(k) * N + col])
                      : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][lane * 4]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float av = as[warp * kRows + i][kk];  // one address: broadcast
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
  }

  T* oe = out + e * M * N;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + warp * kRows + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + lane * 4 + j;
      if (col < N) oe[static_cast<size_t>(m) * N + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, bool A_MN, bool B_K>
int launch_gmm(const void* a, const void* b, void* out, int E, int M, int K,
               int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, E);
  moe_gmm_kernel<T, BM, A_MN, B_K><<<grid, BM / kRows * kWarp, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// the row tile follows M: the smallest of 8, 16, 32, 64 that covers it
template <typename T, bool A_MN, bool B_K>
int dispatch_gmm(const void* a, const void* b, void* out, int E, int M, int K,
                 int N, cudaStream_t stream) {
  if (E == 0 || M == 0 || N == 0) return 0;  // nothing to write
  if (M <= 8) return launch_gmm<T, 8, A_MN, B_K>(a, b, out, E, M, K, N, stream);
  if (M <= 16)
    return launch_gmm<T, 16, A_MN, B_K>(a, b, out, E, M, K, N, stream);
  if (M <= 32)
    return launch_gmm<T, 32, A_MN, B_K>(a, b, out, E, M, K, N, stream);
  return launch_gmm<T, 64, A_MN, B_K>(a, b, out, E, M, K, N, stream);
}

// dx = dy . w^T, then dw = x^T . dy, in order on the stream
template <typename T>
int gmm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
            int E, int C, int D, int F, cudaStream_t stream) {
  const int err = dispatch_gmm<T, false, true>(dy, w, dx, E, C, F, D, stream);
  if (err) return err;
  return dispatch_gmm<T, true, false>(x, dy, dw, E, D, C, F, stream);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;             // K per stage: one 128-byte swizzled row
constexpr int kBoxBytes = 64 * 128;   // one 64 x 64 bf16 box

template <int NC, int BN, int STAGES>
struct TcGmm {
  static constexpr int BM = 64 * NC;
  static constexpr int kThreads = (NC + 1) * 128;
  static constexpr int kXBytes = BM * 128;
  static constexpr int kStage = kXBytes + (BN / 64) * kBoxBytes;
  static constexpr int kSmem = STAGES * kStage + 2 * STAGES * 8 + 1024;
};

// grid (ceil(M / BM), ceil(N / BN), E): the row tiles of one column panel of
// one expert run side by side, so the panel of B is read from device memory
// about once.  Warpgroups 0 .. NC-1 consume, warpgroup NC produces.  TA = 1:
// A is MN-major (stored (K, M)); TB = 1: B is MN-major (stored (K, N)).
template <int NC, int BN, int STAGES, int TA, int TB>
__global__ void __launch_bounds__(TcGmm<NC, BN, STAGES>::kThreads, 1)
moe_gmm_tc_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using Cfg = TcGmm<NC, BN, STAGES>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::kStage);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int n_k = (K + kTcBK - 1) / kTcBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {  // producer
    if constexpr (NC > 1) regs_dec<40>();
    if (threadIdx.x == NC * 128) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES, r = i / STAGES;
        if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
        uint8_t* as = smem + s * Cfg::kStage;
        uint8_t* bs = as + Cfg::kXBytes;
        const int k0 = i * kTcBK;
        mbar_expect_tx(&full[s], Cfg::kStage);
        if constexpr (TA == 0) {
          tma_load_3d(as, &amap, &full[s], k0, m0, e);
        } else {
#pragma unroll
          for (int j = 0; j < NC; ++j)
            tma_load_3d(as + j * kBoxBytes, &amap, &full[s], m0 + 64 * j, k0,
                        e);
        }
        if constexpr (TB == 0) {
          tma_load_3d(bs, &bmap, &full[s], k0, n0, e);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(bs + j * kBoxBytes, &bmap, &full[s], n0 + 64 * j, k0,
                        e);
        }
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg .. m0 + 64 wg + 63
    if constexpr (NC > 1) regs_inc<232>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      // K-major: rows 64 wg.. of one box; MN-major: box wg (the same offset)
      const uint8_t* as = smem + s * Cfg::kStage + wg * 64 * 128;
      const uint8_t* bs = smem + s * Cfg::kStage + Cfg::kXBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        const uint64_t ad = TA ? sw128_desc(as + kk * 16 * 128, kBoxBytes, 1024)
                               : sw128_desc(as + kk * 32, 16, 1024);
        const uint64_t bd = TB ? sw128_desc(bs + kk * 16 * 128, kBoxBytes, 1024)
                               : sw128_desc(bs + kk * 32, 16, 1024);
        mma_ss<TB, TA>(acc, ad, bd, 1);
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    __nv_bfloat16* oe = out + static_cast<size_t>(e) * M * N;
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(
              oe + static_cast<size_t>(row) * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// the 3-D tensor map of an (E, rows, cols) bf16 tensor: boxes of 64 columns
// x box_rows rows of one expert
inline int gmm_map(CUtensorMap* map, const void* base, int E, int rows,
                   int cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * rows * cols};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return hopper::bf16_map(map, base, 3, dims, strides, box);
}

// out (E, M, N) = A . B with A stored (E, M, K) (TA = 0) or (E, K, M), B
// stored (E, K, N) (TB = 1) or (E, N, K)
template <int NC, int BN, int STAGES, int TA, int TB>
int launch_gmm_tc(const void* a, const void* b, void* out, int E, int M,
                  int K, int N, cudaStream_t stream) {
  using Cfg = TcGmm<NC, BN, STAGES>;
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  CUtensorMap amap, bmap;
  int err = TA ? gmm_map(&amap, a, E, K, M, 64)
               : gmm_map(&amap, a, E, M, K, Cfg::BM);
  if (err) return err;
  err = TB ? gmm_map(&bmap, b, E, K, N, 64) : gmm_map(&bmap, b, E, N, K, BN);
  if (err) return err;
  auto* fn = moe_gmm_tc_kernel<NC, BN, STAGES, TA, TB>;
  const cudaError_t serr = hopper::allow_smem(fn, Cfg::kSmem, ready);
  if (serr != cudaSuccess) return static_cast<int>(serr);
  const dim3 grid((M + Cfg::BM - 1) / Cfg::BM, (N + BN - 1) / BN, E);
  fn<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// decode-sized M: one 64-row warpgroup, a deep ring streaming B; larger M:
// two warpgroups on 128 x 256 tiles
template <int TA, int TB>
int dispatch_gmm_tc(const void* a, const void* b, void* out, int E, int M,
                    int K, int N, cudaStream_t stream) {
  if (M <= 64)
    return launch_gmm_tc<1, 128, 8, TA, TB>(a, b, out, E, M, K, N, stream);
  return launch_gmm_tc<2, 256, 4, TA, TB>(a, b, out, E, M, K, N, stream);
}

// ---------------------------------------------------------------------------
// The backward on the tensor cores: a persistent tile walk
// ---------------------------------------------------------------------------
//
// moe_gmm_tc_kernel above was designed for the forward's K (D or F); the
// backward's shapes defeat it.  dw's K is C (320 rows at Scout's train
// microbatch): a block fills its ring for 5 k-steps, then stores 64 KB
// through registers with nothing overlapping, 20 480 blocks one after
// another on each SM.  dx's M is C: 128-row tiles compute 384 rows for 320.
// moe_gmm_bwd_tc_kernel is one kernel for both:
//
// * Persistent.  One block an SM; block b walks output tiles b, b + grid,
//   ... of a fixed order (expert slowest, then the M tile, the N tile
//   fastest, so blocks side by side share an A panel).  Every tile is
//   written by exactly one block: no split-K and no atomics, so each
//   element is one fp32 sum of the same exact products rounded once, and
//   two calls are bit-equal.  The producer's ring runs on across tiles: it
//   fills the next tile's stages while the consumers finish the last one.
// * An epilogue that overlaps.  Each consumer warpgroup rounds its 64 x BN
//   fp32 accumulator to bf16 into its own staging buffer in shared memory
//   (stmatrix, in the TMA map's 128-byte swizzle) and one thread stores it
//   with cp.async.bulk.tensor (shared -> global): the warpgroup goes on to
//   the next tile's products while the copy runs, and waits for it to have
//   read the buffer only at the next epilogue.  The store clips rows and
//   columns past the tensor, so ragged M and N need no masks.
// * dx as dx^T.  dx = dy . w^T has M = C; the kernel computes dx^T (D x C)
//   = w (D x F) . dy^T instead, both operands K-major (w as stored, dy read
//   as (C, F) rows), with C as N in tiles of BN = 160 (2 tiles for Scout's
//   320, no row wasted; C <= 64: BN 64), and stores each 8 x 8 accumulator
//   block transposed (stmatrix.trans) into dx's (C, D) rows.  dw = x^T . dy
//   stays as it was: A = x and B = dy both MN-major, BN 256.
//
// Tiles: BM 128 (two consumer warpgroups of 64 rows of D), 64-deep stages.
// Shared memory: dw 3 stages of 48 KB and 2 x 32 KB staging (214 064 bytes
// with barriers and alignment); dx 4 stages of 36 KB and 2 x 20 KB (189 504);
// dx at C <= 64 8 stages of 24 KB and 2 x 8 KB (214 144).  Registers: the
// consumers' setmaxnreg 232 holds dw's 128 accumulators a thread.
template <int BN, int STAGES>
struct BwdGmm {
  static constexpr int BM = 128;
  static constexpr int kThreads = 384;
  static constexpr int kStage = BM * 128 + BN * 128;  // A and B tiles
  static constexpr int kOutBytes = BN * 128;  // a warpgroup's 64 x BN bf16
  static constexpr int kSmem =
      STAGES * kStage + 2 * kOutBytes + 2 * STAGES * 8 + 1024;
};
static_assert(BwdGmm<256, 3>::kSmem == 214064 &&
                  BwdGmm<160, 4>::kSmem == 189504 &&
                  BwdGmm<64, 8>::kSmem == 214144,
              "the byte sums of the source note");
static_assert(BwdGmm<256, 3>::kSmem <= 232448 &&
                  BwdGmm<160, 4>::kSmem <= 232448 &&
                  BwdGmm<64, 8>::kSmem <= 232448,
              "a block's dynamic shared memory");

// out (E, M, N) = A . B, or with TOUT its transpose stored as (E, N, M);
// TA = 1: A stored (E, K, M), else (E, M, K); TB = 1: B stored (E, K, N),
// else (E, N, K).  omap: the output's map, boxes of 64 inner elements x 64
// rows (64 x BN with TOUT).  grid: min(tiles, SMs), 384 threads.
template <int BN, int STAGES, int TA, int TB, bool TOUT>
__global__ void __launch_bounds__(BwdGmm<BN, STAGES>::kThreads, 1)
moe_gmm_bwd_tc_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, int E, int M,
                      int K, int N) {
  using Cfg = BwdGmm<BN, STAGES>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* staging = smem + STAGES * Cfg::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * Cfg::kOutBytes);
  uint64_t* empty = full + STAGES;

  const int n_m = (M + Cfg::BM - 1) / Cfg::BM, n_n = (N + BN - 1) / BN;
  const int tiles = E * n_m * n_n;
  const int n_k = (K + kTcBK - 1) / kTcBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<40>();
    if (threadIdx.x == 256) {
      int i = 0;  // stage uses, counted across tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = t % n_n * BN, m0 = t / n_n % n_m * Cfg::BM;
        const int e = t / (n_n * n_m);
        for (int kb = 0; kb < n_k; ++kb, ++i) {
          const int s = i % STAGES, r = i / STAGES;
          if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
          uint8_t* as = smem + s * Cfg::kStage;
          uint8_t* bs = as + Cfg::BM * 128;
          const int k0 = kb * kTcBK;
          mbar_expect_tx(&full[s], Cfg::kStage);
          if constexpr (TA == 0) {
            tma_load_3d(as, &amap, &full[s], k0, m0, e);
          } else {
#pragma unroll
            for (int j = 0; j < Cfg::BM / 64; ++j)
              tma_load_3d(as + j * kBoxBytes, &amap, &full[s], m0 + 64 * j,
                          k0, e);
          }
          if constexpr (TB == 0) {
            tma_load_3d(bs, &bmap, &full[s], k0, n0, e);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(bs + j * kBoxBytes, &bmap, &full[s], n0 + 64 * j,
                          k0, e);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg .. m0 + 64 wg + 63
    regs_inc<232>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const bool leader = threadIdx.x % 128 == 0;  // issues the stores
    uint8_t* out = staging + wg * Cfg::kOutBytes;
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = t % n_n * BN, m0 = t / n_n % n_m * Cfg::BM;
      const int e = t / (n_n * n_m);
      float acc[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      for (int kb = 0; kb < n_k; ++kb, ++i) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        // K-major: rows 64 wg.. of one box; MN-major: box wg
        const uint8_t* as = smem + s * Cfg::kStage + wg * 64 * 128;
        const uint8_t* bs = smem + s * Cfg::kStage + Cfg::BM * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcBK / 16; ++kk) {
          const uint64_t ad =
              TA ? sw128_desc(as + kk * 16 * 128, kBoxBytes, 1024)
                 : sw128_desc(as + kk * 32, 16, 1024);
          const uint64_t bd =
              TB ? sw128_desc(bs + kk * 16 * 128, kBoxBytes, 1024)
                 : sw128_desc(bs + kk * 32, 16, 1024);
          mma_ss<TB, TA>(acc, ad, bd, 1);
        }
        wgmma_commit();
        // the previous stage's products are done: hand its buffers back
        wgmma_wait<1>();
        if (kb > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);

      // epilogue: the last tile's store has read the staging buffer
      if (leader) bulk_wait_read<0>();
      named_sync(1 + wg, 128);
      // four 8 x 8 blocks a step: columns 8 j .. 8 j + 15, rows 16 warp ..
      // 16 warp + 15; lane l addresses row l % 8 of block l / 8
      const int blk = lane / 8, rr = lane % 8;
      const int h = blk % 2;
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const uint32_t r[4] = {pack_bf16(acc[4 * j], acc[4 * j + 1]),
                               pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                               pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                               pack_bf16(acc[4 * j + 6], acc[4 * j + 7])};
        const int jj = j + blk / 2;  // the block's 8-column group
        if constexpr (TOUT) {
          // transposed: staging row = column 8 jj + rr of the tile, its 16
          // bytes the rows 16 warp + 8 h .. + 7 (chunk 2 warp + h)
          const int c = 8 * jj + rr;
          stmatrix_x4_trans(out + c * 128 + (((2 * warp + h) ^ rr) << 4), r);
        } else {
          // box jj / 8 of 64 columns, row 16 warp + 8 h + rr, chunk jj % 8
          const int m = 16 * warp + 8 * h + rr;
          stmatrix_x4(out + jj / 8 * kBoxBytes + m * 128 +
                          (((jj % 8) ^ rr) << 4),
                      r);
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (leader && m0 + 64 * wg < M) {
        if constexpr (TOUT) {
          tma_store_3d(&omap, out, m0 + 64 * wg, n0, e);
        } else {
#pragma unroll
          for (int jb = 0; jb < BN / 64; ++jb)
            if (n0 + 64 * jb < N)
              tma_store_3d(&omap, out + jb * kBoxBytes, n0 + 64 * jb,
                           m0 + 64 * wg, e);
        }
        bulk_commit();
      }
    }
    if (leader) bulk_wait<0>();
  }
}

template <int BN, int STAGES, int TA, int TB, bool TOUT>
int launch_gmm_bwd_tc(const CUtensorMap& amap, const CUtensorMap& bmap,
                      const CUtensorMap& omap, int E, int M, int K, int N,
                      cudaStream_t stream) {
  using Cfg = BwdGmm<BN, STAGES>;
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  auto* fn = moe_gmm_bwd_tc_kernel<BN, STAGES, TA, TB, TOUT>;
  cudaError_t err = hopper::allow_smem(fn, Cfg::kSmem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>(E) * ((M + Cfg::BM - 1) / Cfg::BM) *
                     ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  fn<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(amap, bmap, omap, E, M, K,
                                                  N);
  return static_cast<int>(cudaGetLastError());
}

// dx^T (E, D, C) = w . dy^T stored as dx (E, C, D), then dw (E, D, F) =
// x^T . dy, in order on the stream
int gmm_bwd_tc(const void* x, const void* w, const void* dy, void* dx,
               void* dw, int E, int C, int D, int F, cudaStream_t stream) {
  CUtensorMap amap, bmap, omap;
  const int bn = C <= 64 ? 64 : 160;
  int err = gmm_map(&amap, w, E, D, F, 128);
  if (!err) err = gmm_map(&bmap, dy, E, C, F, bn);
  if (!err) err = gmm_map(&omap, dx, E, C, D, bn);
  if (!err)
    err = bn == 64
              ? launch_gmm_bwd_tc<64, 8, 0, 0, true>(amap, bmap, omap, E, D,
                                                     F, C, stream)
              : launch_gmm_bwd_tc<160, 4, 0, 0, true>(amap, bmap, omap, E, D,
                                                      F, C, stream);
  if (err) return err;
  err = gmm_map(&amap, x, E, C, D, 64);
  if (!err) err = gmm_map(&bmap, dy, E, C, F, 64);
  if (!err) err = gmm_map(&omap, dw, E, D, F, 64);
  if (err) return err;
  return launch_gmm_bwd_tc<256, 3, 1, 1, false>(amap, bmap, omap, E, D, C, F,
                                                stream);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (the same for x, w and out)
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              int dtype, int E, int C, int D, int F,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::dispatch_gmm<float, false, false>(x, w, out, E, C, D,
                                                          F, s);
  return repro_torch::dispatch_gmm<__nv_bfloat16, false, false>(x, w, out, E,
                                                                C, D, F, s);
}

// bf16 x, w and out; D and F multiples of 8 (the caller's route)
extern "C" int moe_gmm_tc_launch(const void* x, const void* w, void* out,
                                 int E, int C, int D, int F, void* stream) {
  return repro_torch::dispatch_gmm_tc<0, 1>(x, w, out, E, C, D, F,
                                            static_cast<cudaStream_t>(stream));
}

// The backward on the CUDA cores: dx (E, C, D) and dw (E, D, F) from x
// (E, C, D), w (E, D, F) and dy (E, C, F), all of one dtype (0 = float32,
// 1 = bfloat16).
extern "C" int moe_gmm_bwd_launch(const void* x, const void* w, const void* dy,
                                  void* dx, void* dw, int dtype, int E, int C,
                                  int D, int F, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::gmm_bwd<float>(x, w, dy, dx, dw, E, C, D, F, s);
  return repro_torch::gmm_bwd<__nv_bfloat16>(x, w, dy, dx, dw, E, C, D, F, s);
}

// The backward on the tensor cores, moe_gmm_bwd_tc_kernel: bf16, D and F
// multiples of 8, C >= 1 (the caller's route).
extern "C" int moe_gmm_bwd_tc_launch(const void* x, const void* w,
                                     const void* dy, void* dx, void* dw, int E,
                                     int C, int D, int F, void* stream) {
  return repro_torch::gmm_bwd_tc(x, w, dy, dx, dw, E, C, D, F,
                                 static_cast<cudaStream_t>(stream));
}
