// Hopper kernels of the MoE FFN: the grouped expert matmul.
//
// moe_gmm replaces the Pallas TPU kernel moe_gmm_kernel
// (src/repro/kernels/moe_gmm/kernel.py:39): out[e] = x[e] @ w[e] for every
// expert e of the dispatched (E, C, D) block, with an fp32 accumulator and the
// output in x's dtype.  The TPU grid (E, C/bm, F/bn, D/bk) carried the
// accumulator in VMEM scratch along its sequential D axis; here one block owns
// one output tile of one expert and loops over D inside.
//
// What bounds it on an H100: at prefill (C = 640 rows per expert for
// Llama-4-Scout at 8 x 1024 tokens) the product does 2 C D F FLOPs on
// (C D + D F) inputs, ~1000 FLOP per byte in bf16, far above the tensor
// cores' ~295 FLOP/byte ridge: bound by operations, 989 TFLOP/s.  At decode
// (C = 8) it does 8 FLOP per weight byte: bound by the bytes of w, read once.
//
// Two variants, chosen by one rule on dtype and shape (kernels/moe_gmm/
// kernel.py: route):
//
// * moe_gmm_tc_kernel, bf16 with D and F multiples of 8: wgmma on the tensor
//   cores fed by TMA.  TMA needs every global stride to be a multiple of 16
//   bytes, which for bf16 rows of D or F elements means D % 8 == F % 8 == 0;
//   every served shape meets it.  x is read through a 3-D tensor map
//   (D, C, E) and w through (F, D, E), both with 128-byte swizzle (boxes 64
//   elements wide).  Because x's map is 3-D, the rows of a 64- or 128-row box
//   past C are out of bounds and read as zeros, never as the next expert's
//   rows: decode (C = 8) and ragged C run without padding, and so do ragged D
//   (zeros on both sides of the sum) and F (columns never stored).  A ring
//   of shared-memory stages, each one x tile (BM x 64) and one w tile
//   (64 x BN), with full and empty mbarriers; one producer thread issues the
//   TMA loads, and NC consumer warpgroups (64 rows each) issue
//   wgmma.mma_async m64nBNk16 from shared memory (w is MN-major: tnspB = 1),
//   keeping one wgmma group in flight while the next stage is waited for.
//   Prefill (C > 64): BM 128 (two consumer warpgroups), BN 256, 4 stages of
//   48 KB; setmaxnreg gives the consumers 232 registers (the 64 x 256 fp32
//   accumulator is 128 a thread) and the producer warpgroup 40.  Decode
//   (C <= 64): BM 64, of which rows >= C are TMA zeros (the padded tensor-
//   core work, ~0.09 ms at the Scout shape, stays under the 0.40 ms byte
//   bound), BN 128, and 8 stages: 128 KB of w in flight per SM, so the
//   kernel is a stream of the expert weights.  The epilogue rounds the fp32
//   accumulator to bf16 in registers and stores rows < C, columns < F.
//
// * moe_gmm_kernel, fp32 (the tests' and the Scout fp32 twin's dtype) and the
//   bf16 shapes TMA cannot take: the first port's FFMA design, unchanged.
//   One block owns one (BM-row, 128-column) output tile on a grid of
//   (F tile, C tile, expert) and loops over D in steps of 32: each step
//   stages an x tile (BM x 32) and a w tile (32 x 128) in shared memory as
//   fp32, and every thread keeps 8 rows x 4 columns of the accumulator in
//   registers (66.9 TFLOP/s peak on the CUDA cores).  BM follows C (8, 16,
//   32 or 64 rows; one warp per 8 rows); ragged edges are masked by bounds.
//
// Both launchers return cudaGetLastError() after the launch (0 on success);
// moe_gmm_tc_launch may also return hopper.cuh's tensor-map error codes.
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

// grid (ceil(F / 128), ceil(C / BM), E), BM / 8 warps.  Warp wr owns rows
// c0 + 8 wr .. c0 + 8 wr + 7, lane l columns n0 + 4 l .. n0 + 4 l + 3.
template <typename T, int BM>
__global__ void __launch_bounds__(BM / kRows * kWarp)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int C, int D, int F) {
  constexpr int kThreads = BM / kRows * kWarp;
  __shared__ float xs[BM][kBK + 1];  // row-major, padded: no bank conflicts
  __shared__ __align__(16) float ws[kBK][kBN];

  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * BM;
  const size_t e = blockIdx.z;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* xe = x + e * C * D;
  const T* we = w + e * D * F;

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are no longer read
#pragma unroll
    for (int it = 0; it < BM * kBK / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kBK, kk = i % kBK;
      const int c = c0 + r, k = k0 + kk;
      xs[r][kk] = (c < C && k < D)
                      ? to_f(xe[static_cast<size_t>(c) * D + k]) : 0.f;
    }
#pragma unroll 16
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int kk = i / kBN, n = i % kBN;
      const int k = k0 + kk, col = n0 + n;
      ws[kk][n] = (k < D && col < F)
                      ? to_f(we[static_cast<size_t>(k) * F + col]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][lane * 4]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float a = xs[warp * kRows + i][kk];  // one address: broadcast
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
  }

  T* oe = out + e * C * F;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int c = c0 + warp * kRows + i;
    if (c >= C) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + lane * 4 + j;
      if (col < F) oe[static_cast<size_t>(c) * F + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM>
int launch_gmm(const void* x, const void* w, void* out, int E, int C, int D,
               int F, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, (C + BM - 1) / BM, E);
  moe_gmm_kernel<T, BM><<<grid, BM / kRows * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, D, F);
  return static_cast<int>(cudaGetLastError());
}

// the row tile follows C: the smallest of 8, 16, 32, 64 that covers it
template <typename T>
int dispatch_gmm(const void* x, const void* w, void* out, int E, int C, int D,
                 int F, cudaStream_t stream) {
  if (C <= 8) return launch_gmm<T, 8>(x, w, out, E, C, D, F, stream);
  if (C <= 16) return launch_gmm<T, 16>(x, w, out, E, C, D, F, stream);
  if (C <= 32) return launch_gmm<T, 32>(x, w, out, E, C, D, F, stream);
  return launch_gmm<T, 64>(x, w, out, E, C, D, F, stream);
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;             // D per stage: one 128-byte swizzled row
constexpr int kBoxBytes = 64 * 128;   // one 64 x 64 bf16 box

template <int NC, int BN, int STAGES>
struct TcGmm {
  static constexpr int BM = 64 * NC;
  static constexpr int kThreads = (NC + 1) * 128;
  static constexpr int kXBytes = BM * 128;
  static constexpr int kStage = kXBytes + (BN / 64) * kBoxBytes;
  static constexpr int kSmem = STAGES * kStage + 2 * STAGES * 8 + 1024;
};

// grid (ceil(C / BM), ceil(F / BN), E): the row tiles of one column panel of
// one expert run side by side, so the panel of w is read from device memory
// about once.  Warpgroups 0 .. NC-1 consume, warpgroup NC produces.
template <int NC, int BN, int STAGES>
__global__ void __launch_bounds__(TcGmm<NC, BN, STAGES>::kThreads, 1)
moe_gmm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  using Cfg = TcGmm<NC, BN, STAGES>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::kStage);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int n_k = (D + kTcBK - 1) / kTcBK;

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
        uint8_t* xs = smem + s * Cfg::kStage;
        uint8_t* ws = xs + Cfg::kXBytes;
        mbar_expect_tx(&full[s], Cfg::kStage);
        tma_load_3d(xs, &xmap, &full[s], i * kTcBK, m0, e);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(ws + j * kBoxBytes, &wmap, &full[s], n0 + 64 * j,
                      i * kTcBK, e);
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
      const uint8_t* xs = smem + s * Cfg::kStage + wg * 64 * 128;
      const uint8_t* ws = smem + s * Cfg::kStage + Cfg::kXBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        mma_ss<1>(acc, sw128_desc(xs + kk * 32, 16, 1024),
                  sw128_desc(ws + kk * 16 * 128, kBoxBytes, 1024), 1);
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    __nv_bfloat16* oe = out + static_cast<size_t>(e) * C * F;
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= F) continue;  // F % 8 == 0: col + 1 < F as well
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < C)
          *reinterpret_cast<__nv_bfloat162*>(
              oe + static_cast<size_t>(row) * F + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int NC, int BN, int STAGES>
int launch_gmm_tc(const void* x, const void* w, void* out, int E, int C,
                  int D, int F, cudaStream_t stream) {
  using Cfg = TcGmm<NC, BN, STAGES>;
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(E)};
  const cuuint64_t xstrides[2] = {2ull * D, 2ull * C * D};
  const cuuint32_t xbox[3] = {64, Cfg::BM, 1};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(F),
                               static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(E)};
  const cuuint64_t wstrides[2] = {2ull * F, 2ull * D * F};
  const cuuint32_t wbox[3] = {64, kTcBK, 1};
  int err = hopper::bf16_map(&xmap, x, 3, xdims, xstrides, xbox);
  if (err) return err;
  err = hopper::bf16_map(&wmap, w, 3, wdims, wstrides, wbox);
  if (err) return err;
  auto* fn = moe_gmm_tc_kernel<NC, BN, STAGES>;
  const cudaError_t serr = hopper::allow_smem(fn, Cfg::kSmem, ready);
  if (serr != cudaSuccess) return static_cast<int>(serr);
  const dim3 grid((C + Cfg::BM - 1) / Cfg::BM, (F + BN - 1) / BN, E);
  fn<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (the same for x, w and out)
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              int dtype, int E, int C, int D, int F,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::dispatch_gmm<float>(x, w, out, E, C, D, F, s);
  return repro_torch::dispatch_gmm<__nv_bfloat16>(x, w, out, E, C, D, F, s);
}

// bf16 x, w and out; D and F multiples of 8 (the caller's route)
extern "C" int moe_gmm_tc_launch(const void* x, const void* w, void* out,
                                 int E, int C, int D, int F, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  // decode-sized C: one 64-row warpgroup, a deep ring streaming w;
  // prefill: two warpgroups on 128 x 256 tiles
  if (C <= 64)
    return repro_torch::launch_gmm_tc<1, 128, 8>(x, w, out, E, C, D, F, s);
  return repro_torch::launch_gmm_tc<2, 256, 4>(x, w, out, E, C, D, F, s);
}
