// Hopper kernels of the RG-LRU recurrent block: the diagonal linear recurrence
// and its backward.
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
// rglru_scan_bwd_kernel is its backward (the JAX package differentiates an
// associative scan with XLA, src/repro/models/blocks.py:431-448; no Pallas
// kernel).  From the upstream gradient dh of every state and the saved
// states h, with g_S = 0:
//   g_t = dh_t + a_{t+1} g_{t+1}     (a reverse walk over S)
//   dx_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0),  dh0 = a_0 g_0
// One thread per (b, r) channel walks S backwards with g in a register,
// rounding the product and then the sum as the plain version
// (kernels/rglru_scan/ref.py: rglru_scan_bwd_ref) does, so the two agree bit
// for bit; one pass reads a, dh and h and writes dx and da.
//
// What bounds both on an H100: 2 FLOPs per element on one read of each input
// and one write of each output (forward: a, x, h; backward: a, dh, h, da, dx,
// 20 bytes an element in fp32): bound by bytes.  The time loop is
// sequential, so the loads of kUnroll steps are issued before their updates
// to keep enough bytes in flight; with B * R threads (10,240 for
// RecurrentGemma-2B at B = 4) the card has fewer warps than it can hold, and
// a chunked two-pass scan over S is the later fix if these kernels show.
//
// The launchers return cudaGetLastError() after their launch (0 on
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

// grid (ceil(R / kThreads), B), as the forward.  g carries a_{t+1} g_{t+1}
// down the time steps; a step's h_{t-1} is the state the forward wrote one
// step earlier (h0 at t = 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h0,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, T* __restrict__ da,
                      T* __restrict__ dx, float* __restrict__ dh0, int S,
                      int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t b = blockIdx.y;
  const size_t base = b * S * R + r;
  const float h_init = h0[b * R + r];
  float g = 0.f, a_next = 0.f;  // g_{t+1} and a_{t+1}; both 0 past S
  int t = S - 1;
  // the steps past the last whole chunk from the start, one at a time
  for (; t >= 0 && (t + 1) % kUnroll; --t) {
    const size_t i = base + static_cast<size_t>(t) * R;
    g = __fadd_rn(dh[i], __fmul_rn(a_next, g));
    const float hp = t > 0 ? h[i - R] : h_init;
    dx[i] = from_f<T>(g);
    da[i] = from_f<T>(__fmul_rn(g, hp));
    a_next = to_f(a[i]);
  }
  // whole chunks of kUnroll steps, their loads issued first
  for (; t >= 0; t -= kUnroll) {
    const int t0 = t - kUnroll + 1;
    float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + static_cast<size_t>(t0 + u) * R;
      av[u] = to_f(a[i]);
      dv[u] = dh[i];
      hv[u] = t0 + u > 0 ? h[i - R] : h_init;
    }
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u) {
      const size_t i = base + static_cast<size_t>(t0 + u) * R;
      g = __fadd_rn(dv[u], __fmul_rn(a_next, g));
      dx[i] = from_f<T>(g);
      da[i] = from_f<T>(__fmul_rn(g, hv[u]));
      a_next = av[u];
    }
  }
  dh0[b * R + r] = __fmul_rn(a_next, g);  // a_0 g_0 (0 when S = 0)
}

template <typename T>
int launch_scan_bwd(const void* a, const float* h0, const float* h,
                    const float* dh, void* da, void* dx, float* dh0, int B,
                    int S, int R, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), h0, h, dh, static_cast<T*>(da),
      static_cast<T*>(dx), dh0, S, R);
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

// dtype: 0 = float32, 1 = bfloat16 (of a, da and dx; h0, h, dh and dh0 are
// fp32)
extern "C" int rglru_scan_bwd_launch(const void* a, const float* h0,
                                     const float* h, const float* dh, void* da,
                                     void* dx, float* dh0, int dtype, int B,
                                     int S, int R, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_scan_bwd<float>(a, h0, h, dh, da, dx, dh0, B, S,
                                               R, s);
  return repro_torch::launch_scan_bwd<__nv_bfloat16>(a, h0, h, dh, da, dx, dh0,
                                                     B, S, R, s);
}
