// Hopper kernel of the RG-LRU recurrent block: the diagonal linear recurrence.
//
// rglru_scan replaces the Pallas TPU kernel rglru_scan_kernel
// (src/repro/kernels/rglru_scan/kernel.py:41): h_t = a_t * h_{t-1} + x_t,
// elementwise over the R channels, from h0, every h_t written out in fp32.
// The TPU grid (B, S / chunk) walked time sequentially per batch row with the
// carry in VMEM scratch and a vectorised (8, 128)-lane update per step.  Here
// one thread owns one (b, r) channel and carries h in a register along S;
// neighbouring threads own neighbouring channels, so every load and store of a
// time step is coalesced along R.  The TPU wrapper pads R to 128 lanes and S
// to the chunk (ops.py:16-30); here a thread past R returns and S needs no
// padding.  Each step rounds the product and then the sum (no fused
// multiply-add), as the plain version and the TPU kernel's a * h + x do.
//
// What bounds it on an H100: one read of a and x and one write of h, 2 FLOPs
// per element: bound by bytes.  The time loop is sequential, so the loads of
// kUnroll steps are issued before their updates to keep enough bytes in
// flight; with B * R threads (10,240 for RecurrentGemma-2B at B = 4) the card
// has fewer warps than it can hold, and a chunked two-pass scan over S is the
// later fix if this kernel shows in the prefill.
//
// rglru_scan_launch returns cudaGetLastError() after its launch (0 on
// success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace repro_torch {
namespace {

constexpr int kThreads = 32;  // channels per block
constexpr int kUnroll = 16;   // time steps whose loads are issued together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// grid (ceil(R / kThreads), B): thread r of block (rb, b) owns channel
// rb * kThreads + r of batch row b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ out, int S,
                  int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t b = blockIdx.y;
  const size_t base = b * S * R + r;
  float h = h0[b * R + r];
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + static_cast<size_t>(t + u) * R;
      av[u] = to_f(a[i]);
      xv[u] = to_f(x[i]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      out[base + static_cast<size_t>(t + u) * R] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + static_cast<size_t>(t) * R;
    h = __fadd_rn(__fmul_rn(to_f(a[i]), h), to_f(x[i]));
    out[i] = h;
  }
}

template <typename T>
int launch_scan(const void* a, const void* x, const float* h0, float* out,
                int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0, out, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (of a and x; h0 and out are fp32)
extern "C" int rglru_scan_launch(const void* a, const void* x, const float* h0,
                                 float* out, int dtype, int B, int S, int R,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_scan<float>(a, x, h0, out, B, S, R, s);
  return repro_torch::launch_scan<__nv_bfloat16>(a, x, h0, out, B, S, R, s);
}
