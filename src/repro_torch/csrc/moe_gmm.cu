// Hopper kernel of the MoE FFN: the grouped expert matmul.
//
// moe_gmm replaces the Pallas TPU kernel moe_gmm_kernel
// (src/repro/kernels/moe_gmm/kernel.py:39): out[e] = x[e] @ w[e] for every
// expert e of the dispatched (E, C, D) block, with an fp32 accumulator and the
// output in x's dtype.  The TPU grid (E, C/bm, F/bn, D/bk) carried the
// accumulator in VMEM scratch along its sequential D axis.  Here one block
// owns one (BM-row, 128-column) output tile of one expert, on a grid of
// (F tile, C tile, expert), and loops over D in steps of 32: each step stages
// an x tile (BM x 32) and a w tile (32 x 128) in shared memory as fp32, and
// every thread keeps 8 rows x 4 columns of the accumulator in registers.  The
// TPU wrapper pads C, D and F to block multiples (ops.py:16-30); here ragged
// edges are masked by bounds and nothing is padded or copied.
//
// The tile height BM follows C (8, 16, 32 or 64 rows; a block has BM / 8
// warps, one per 8 rows).  At prefill the model merges its dispatch groups
// into C = G * capacity rows per expert (640 for Llama-4-Scout at 8 x 1024
// tokens) and BM is 64.  At decode C is 8: one warp per block, each w element
// used by the 8 rows it meets, and the kernel is a stream of the expert
// weights.
//
// What bounds it on an H100: at prefill the product does 2 * C * D * F FLOPs
// per expert on (C * D + D * F) inputs, ~1000 FLOP per byte in bf16, far above
// the tensor cores' ~295 FLOP/byte ridge: bound by operations.  At decode
// (C = 8) it does 8 FLOP per weight byte: bound by the bytes of w, read once.
// This first version runs the products as fp32 FFMA on the CUDA cores from
// shared memory (66.9 TFLOP/s peak, 15x below the bf16 tensor cores); mma.sync
// or wgmma with TMA-fed tiles is later work.
//
// moe_gmm_launch returns cudaGetLastError() after its launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
