// Backward of prefill (flash) attention on Hopper: dQ, dK and dV.
//
// The JAX package differentiates its prefill attention through a custom VJP
// whose backward is XLA (_flash_mha_bwd, src/repro/models/layers.py:189-236);
// its forward is the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:91), ported as
// flash_attention_tc.cu (bf16) and attention.cu (fp32).  Those forwards also
// write lse (B, H, Sq), the natural-log sum of the scaled scores a row sees,
// and this file computes, from q, k, v, out, dout and lse:
//
//   delta = rowsum(dout * out)                      fp32, (B, H, Sq)
//   P     = exp(S * scale - lse)   on visible pairs, exactly 0 elsewhere
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K
//
// with q (B, Sq, H, hd), k and v (B, Skv, Kv, hd), query head h reading KV
// head h / (H / Kv), the causal / window / chunk masks of the forward, and
// Sq != Skv.  Every sum is fp32 (the tensor-core variants round P and dS to
// bf16 as product operands); dQ, dK and dV are rounded once to the input
// type.  A query row that sees no key has P = 0 on every key,
// so its gradients are 0 (its lse, -1e30, is never used).
//
// Deterministic by construction (restarted training must reproduce a run):
// no atomics.  FA2's split into two kernels after the delta kernel:
//
// * a dK/dV kernel: one block per (b, KV head, key tile).  It keeps the
//   tile's K and V in shared memory and its dK and dV accumulators in
//   registers, and walks the G = H / Kv query heads of the group and, for
//   each, the query tiles that can see the tile (tiles masked whole are
//   skipped).  So the GQA sum over the group happens inside the block, in a
//   fixed order; JAX sums it through the transpose of jnp.repeat.
// * a dQ kernel: one block per (b, query head, query tile), over the KV
//   tiles the tile can see.  It recomputes S and dP (the dQ products are not
//   in the bound of chip_smoke.py, which counts the five products once: 10
//   hd FLOPs per visible pair).
//
// What bounds it on an H100: 10 hd FLOPs (14 hd with the recomputation) per
// visible (query, key) pair on 7 B S H hd inputs and outputs: bound by
// operations.  Two variants of the two kernels, one rule
// (kernels/flash_attention/kernel.py: route_bwd):
// * "tc", bf16 (every trained model's attention): the products on wgmma
//   (989 TFLOP/s bf16 peak) from TMA-fed shared memory, below:
//   flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel up to hd 128,
//   flash_bwd_dkdv_wgmma_wide_kernel and flash_bwd_dq_wgmma_wide_kernel
//   (with flash_bwd_sum_kernel where the wrapper splits a KV group's heads)
//   above, up to 256;
// * "ffma", fp32 (and bf16 by its explicit route, the yardstick): the
//   products on the CUDA cores in fp32 (66.9 TFLOP/s peak), the design of
//   the FFMA forward in attention.cu: fp32 tiles in shared memory with an
//   odd row stride (column reads hit distinct banks), 16 x 16 threads, each
//   with a register tile of the BQ x BK scores and of its rows of the
//   accumulators.
//
// flash_attention_bwd_launch returns cudaGetLastError() after its launches
// (0 on success), or hopper.cuh's tensor-map error codes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kDeltaRows = 8;  // delta kernel: rows per block, a warp each
constexpr float kLog2e = 1.4426950408889634f;

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

// rows [row0, row0 + rows) of hd elements, row r at base + r * row_stride,
// into dst[r][0..hd) (leading dimension ld) as fp32; rows at or past `valid`
// are written as zeros and not read.  16-byte loads (hd % 16 == 0).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base,
                                          size_t row_stride, int row0,
                                          int valid, int rows, int hd) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = hd / V;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * V;
    float x[V];
    if (r < valid) {
      const T* src = base + static_cast<size_t>(row0 + r) * row_stride + c;
      if constexpr (sizeof(T) == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = __bfloat162float(h[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * ld + c + e] = x[e];
  }
}

struct Masks {
  int Sq, Skv, causal, window, chunk;

  // may any query in [q_lo, q_hi] see any key in [k_lo, k_hi]
  __device__ bool live(int q_lo, int q_hi, int k_lo, int k_hi) const {
    bool ok = true;
    if (causal) ok = ok && k_lo <= q_hi;
    if (window) ok = ok && q_lo - k_hi < window;
    if (chunk)
      ok = ok && q_lo / chunk <= k_hi / chunk && k_lo / chunk <= q_hi / chunk;
    return ok;
  }
  // does every query in [q_lo, q_hi] see every key in [k_lo, k_hi] (all of
  // them in range)
  __device__ bool whole(int q_lo, int q_hi, int k_lo, int k_hi) const {
    bool ok = q_hi < Sq && k_hi < Skv;
    if (causal) ok = ok && k_hi <= q_lo;
    if (window) ok = ok && q_hi - k_lo < window;
    if (chunk)
      ok = ok && q_lo / chunk == q_hi / chunk && k_lo / chunk == k_hi / chunk &&
           q_lo / chunk == k_lo / chunk;
    return ok;
  }
  // the keys query t sees form one interval [lo, hi] (empty if hi < lo)
  __device__ void keys_of(int t, int& lo, int& hi) const {
    lo = 0;
    hi = causal ? min(t, Skv - 1) : Skv - 1;
    if (window) lo = max(lo, t - window + 1);
    if (chunk) {
      const int c0 = t / chunk * chunk;
      lo = max(lo, c0);
      hi = min(hi, c0 + chunk - 1);
    }
    if (t >= Sq) hi = lo - 1;
  }
  // the queries that see key u form one interval [lo, hi]
  __device__ void queries_of(int u, int& lo, int& hi) const {
    lo = causal ? u : 0;
    hi = Sq - 1;
    if (window) hi = min(hi, u + window - 1);
    if (chunk) {
      const int c0 = u / chunk * chunk;
      lo = max(lo, c0);
      hi = min(hi, c0 + chunk - 1);
    }
    if (u >= Skv) hi = lo - 1;
  }
  // may query t see key u (both in range)
  __device__ bool sees(int t, int u) const {
    bool ok = t < Sq && u < Skv;
    if (causal) ok = ok && t >= u;
    if (window) ok = ok && t - u < window;
    if (chunk) ok = ok && t / chunk == u / chunk;
    return ok;
  }
};

// Tiles: BK keys and BQ query rows (64 up to hd 128, 32 above, so that four
// fp32 tiles of hd + 1 columns fit in shared memory); MAXJ = hd / 16 rounded
// up to a power of two, the accumulator columns per thread (stride 16).
template <int MAXJ>
struct Tiles {
  static constexpr int B = MAXJ <= 8 ? 64 : 32;
  static constexpr int R = B / 16;  // rows (or columns) per thread
};

size_t bwd_smem_bytes(int hd, int tile, int n_score_tiles) {
  return sizeof(float) * (4 * static_cast<size_t>(tile) * (hd + 1) +
                          n_score_tiles * static_cast<size_t>(tile) *
                              (tile + 1) +
                          2 * tile);
}

// delta[b, h, t] = sum_d dout[b, t, h, d] * out[b, t, h, d] in fp32; one
// warp per (b, t, h) row.  PACK (the "tc" variant): delta is the scratch
// (B, H, 2, Sqp), Sqp = Sq rounded up to 64 rows, and the kernel writes
// lse * log2(e) at [b, h, 0, t] and delta * scale (scale = 1 / sqrt(hd)) at
// [b, h, 1, t], the units the wgmma kernels use, so that they copy 64 rows
// of both with one bulk copy each (16-byte aligned whatever Sq is); rows
// Sq .. Sqp - 1 get zeros (a masked P of 0 times them stays 0).
template <typename T, int PACK>
__global__ void __launch_bounds__(32 * kDeltaRows)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, int rows, int Sq, int Sqp,
                       int H, int hd) {
  const int row = blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // rows = B Sqp H; row = (b Sqp + t) H + h
  const int h = row % H, bt = row / H;
  const int b = bt / Sqp, t = bt % Sqp;
  const size_t bh = static_cast<size_t>(b) * H + h;
  if (t >= Sq) {  // PACK only: Sqp > Sq
    if (lane == 0) {
      delta[bh * 2 * Sqp + t] = 0.f;
      delta[(bh * 2 + 1) * Sqp + t] = 0.f;
    }
    return;
  }
  const size_t at = ((static_cast<size_t>(b) * Sq + t) * H + h) * hd;
  const T* o = out + at;
  const T* d = dout + at;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    if constexpr (PACK) {
      delta[bh * 2 * Sqp + t] = lse[bh * Sq + t] * kLog2e;
      delta[(bh * 2 + 1) * Sqp + t] = acc / sqrtf(static_cast<float>(hd));
    } else {
      delta[bh * Sq + t] = acc;
    }
  }
}

// The scores of one (BQ x BK) tile for thread (ty, tx): rows ty R + r,
// columns tx + 16 c, as A B^T of two row-major fp32 tiles in shared memory.
template <int R>
__device__ __forceinline__ void tile_products(float (&s)[R][R], const float* A,
                                              const float* Bm, int ld, int hd,
                                              int ty, int tx) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) s[r][c] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = A[(ty * R + r) * ld + d];
#pragma unroll
    for (int c = 0; c < R; ++c) b[c] = Bm[(tx + 16 * c) * ld + d];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
}

// P and dS of one tile from its S and dP products, written to shared memory
// ([BQ][BK + 1]; Ps may be null).
template <int R>
__device__ __forceinline__ void p_and_ds(const float (&s)[R][R],
                                         const float (&dp)[R][R], float* Ps,
                                         float* dSs, const float* lse_s,
                                         const float* delta_s, int q_lo,
                                         int k_lo, float scale,
                                         const Masks& mk, int ty, int tx) {
  constexpr int BT = 16 * R, ldp = BT + 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = ty * R + r;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int col = tx + 16 * c;
      const float p = mk.sees(q_lo + row, k_lo + col)
                          ? expf(s[r][c] * scale - lse_s[row])
                          : 0.f;
      if (Ps) Ps[row * ldp + col] = p;
      dSs[row * ldp + col] = p * (dp[r][c] - delta_s[row]) * scale;
    }
  }
}

// grid (ceil(Skv / BK), Kv, B), 256 threads.
template <typename T, int MAXJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Kv, int hd, float scale,
                      Masks mk) {
  constexpr int BT = Tiles<MAXJ>::B, R = Tiles<MAXJ>::R, ldp = BT + 1;
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Ks = smem;
  float* Vs = Ks + BT * ld;
  float* Qs = Vs + BT * ld;
  float* dOs = Qs + BT * ld;
  float* Ps = dOs + BT * ld;
  float* dSs = Ps + BT * ldp;
  float* lse_s = dSs + BT * ldp;
  float* delta_s = lse_s + BT;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int Sq = mk.Sq, Skv = mk.Skv;
  const int k_lo = kt * BT, k_hi = min(k_lo + BT, Skv) - 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nj = hd / 16;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Kv) * hd;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_stride +
                        static_cast<size_t>(kvh) * hd;
  load_rows(Ks, ld, k + kv_off, kv_stride, k_lo, Skv - k_lo, BT, hd);
  load_rows(Vs, ld, v + kv_off, kv_stride, k_lo, Skv - k_lo, BT, hd);

  float acc_k[R][MAXJ], acc_v[R][MAXJ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc_k[r][j] = acc_v[r][j] = 0.f;

  const int n_q = (Sq + BT - 1) / BT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_off = static_cast<size_t>(b) * Sq * q_stride +
                         static_cast<size_t>(h) * hd;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q_lo = qt * BT, q_hi = min(q_lo + BT, Sq) - 1;
      if (!mk.live(q_lo, q_hi, k_lo, k_hi)) continue;  // uniform
      __syncthreads();  // the previous tile's Q, dO, P, dS are read
      load_rows(Qs, ld, q + q_off, q_stride, q_lo, Sq - q_lo, BT, hd);
      load_rows(dOs, ld, dout + q_off, q_stride, q_lo, Sq - q_lo, BT, hd);
      for (int i = threadIdx.x; i < BT; i += blockDim.x) {
        const bool in = q_lo + i < Sq;
        lse_s[i] = in ? lse_h[q_lo + i] : 0.f;
        delta_s[i] = in ? delta_h[q_lo + i] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      tile_products<R>(s, Qs, Ks, ld, hd, ty, tx);
      tile_products<R>(dp, dOs, Vs, ld, hd, ty, tx);
      p_and_ds<R>(s, dp, Ps, dSs, lse_s, delta_s, q_lo, k_lo, scale, mk, ty,
                  tx);
      __syncthreads();
      // dV[u] += sum_t P[t][u] dO[t];  dK[u] += sum_t dS[t][u] Q[t]
      for (int t = 0; t < BT; ++t) {
        float p[R], ds[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          p[r] = Ps[t * ldp + ty * R + r];
          ds[r] = dSs[t * ldp + ty * R + r];
        }
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          if (j < nj) {
            const float o = dOs[t * ld + tx + 16 * j];
            const float x = Qs[t * ld + tx + 16 * j];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc_v[r][j] = fmaf(p[r], o, acc_v[r][j]);
              acc_k[r][j] = fmaf(ds[r], x, acc_k[r][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int u = k_lo + ty * R + r;
    if (u >= Skv) continue;
    const size_t off = kv_off + static_cast<size_t>(u) * kv_stride;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) {
        dk[off + tx + 16 * j] = from_f<T>(acc_k[r][j]);
        dv[off + tx + 16 * j] = from_f<T>(acc_v[r][j]);
      }
  }
}

// grid (ceil(Sq / BQ), H, B), 256 threads.
template <typename T, int MAXJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int Kv, int hd, float scale, Masks mk) {
  constexpr int BT = Tiles<MAXJ>::B, R = Tiles<MAXJ>::R, ldp = BT + 1;
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;
  float* dOs = Qs + BT * ld;
  float* Ks = dOs + BT * ld;
  float* Vs = Ks + BT * ld;
  float* dSs = Vs + BT * ld;
  float* lse_s = dSs + BT * ldp;
  float* delta_s = lse_s + BT;

  // the last query tiles see the most keys under a causal mask: start them
  // first so the short ones fill the tail
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int Sq = mk.Sq, Skv = mk.Skv;
  const int q_lo = qt * BT, q_hi = min(q_lo + BT, Sq) - 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nj = hd / 16;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Kv) * hd;
  const size_t q_off = static_cast<size_t>(b) * Sq * q_stride +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_stride +
                        static_cast<size_t>(kvh) * hd;
  load_rows(Qs, ld, q + q_off, q_stride, q_lo, Sq - q_lo, BT, hd);
  load_rows(dOs, ld, dout + q_off, q_stride, q_lo, Sq - q_lo, BT, hd);
  const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * Sq;
  const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * Sq;
  for (int i = threadIdx.x; i < BT; i += blockDim.x) {
    const bool in = q_lo + i < Sq;
    lse_s[i] = in ? lse_h[q_lo + i] : 0.f;
    delta_s[i] = in ? delta_h[q_lo + i] : 0.f;
  }

  float acc[R][MAXJ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[r][j] = 0.f;

  const int n_kv = (Skv + BT - 1) / BT;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * BT, k_hi = min(k_lo + BT, Skv) - 1;
    if (!mk.live(q_lo, q_hi, k_lo, k_hi)) continue;  // uniform
    __syncthreads();  // the previous tile's K and dS are read
    load_rows(Ks, ld, k + kv_off, kv_stride, k_lo, Skv - k_lo, BT, hd);
    load_rows(Vs, ld, v + kv_off, kv_stride, k_lo, Skv - k_lo, BT, hd);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_products<R>(s, Qs, Ks, ld, hd, ty, tx);
    tile_products<R>(dp, dOs, Vs, ld, hd, ty, tx);
    p_and_ds<R>(s, dp, nullptr, dSs, lse_s, delta_s, q_lo, k_lo, scale, mk,
                ty, tx);
    __syncthreads();
    // dQ[t] += sum_u dS[t][u] K[u]
    for (int u = 0; u < BT; ++u) {
      float ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ds[r] = dSs[(ty * R + r) * ldp + u];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nj) {
          const float kk = Ks[u * ld + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(ds[r], kk, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = q_lo + ty * R + r;
    if (t >= Sq) continue;
    const size_t off = q_off + static_cast<size_t>(t) * q_stride;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) dq[off + tx + 16 * j] = from_f<T>(acc[r][j]);
  }
}

// ---------------------------------------------------------------------------
// "tc" up to hd 128: bf16 on wgmma fed by TMA, fp32 accumulate
// ---------------------------------------------------------------------------
//
// The same two kernels in the shape of the tensor-core forward
// (flash_attention_tc.cu, and FA3's backward): three warpgroups, of which
// one thread of the third issues TMA loads (setmaxnreg moves registers from
// it, 24, to the two consumer warpgroups, 240), and every product on wgmma
// reading its operands straight from 128-byte-swizzled shared memory, or A
// from registers.  hd is padded to HDP = 64 or 128 by TMA's out-of-bounds
// zeros, and so are rows past Sq or Skv, which the masks then hide; the
// stores write only hd columns of in-range rows.
//
// * flash_bwd_dkdv_wgmma_kernel: one block per (b, KV head, 128-key tile),
//   each consumer warpgroup owning 64 keys.  K and V load once; Q and dO
//   stream in 64-row tiles through a two-stage ring (full and empty
//   mbarriers), each with its 64 rows of lse * log2(e) and delta * scale
//   (the packed scratch of the delta kernel, one bulk copy each).  Producer
//   and consumers walk the same fixed list: the G query heads of the group
//   and, for each, the query tiles Masks::live admits.  Per tile, in each
//   consumer warpgroup: S^T = K Q^T and dP^T = V dO^T (M 64 keys, N 64
//   queries, K HDP, both K-major); P^T = exp2(S^T scale log2(e) - lse2[q])
//   on visible pairs and exactly 0 elsewhere, dS^T = P^T (dP^T - delta[q])
//   scale, on the accumulator fragments; both rounded to bf16 and repacked
//   in registers as A operands (the m64nNk16 accumulator fragment is the
//   A-register fragment, hopper.cuh); dV += P^T dO and dK += dS^T Q (N HDP),
//   dO and Q read MN-major from the same swizzled tiles (tnspB = 1).  dK and
//   dV are 64 x HDP fp32 each in registers: 128 a thread at HDP 128.
// * flash_bwd_dq_wgmma_kernel: one block per (b, query head, 128-query
//   tile), 64 queries a consumer warpgroup, the last tile first.  Q and dO
//   load once; K and V stream in 128-key tiles through the ring (N 128:
//   S and dP are 64 fp32 a thread each).  Per tile: S = Q K^T and dP = dO
//   V^T, dS from each row's lse2 and delta (held in registers), dQ += dS K
//   with K read MN-major.
//
// The element-wise step between the products is most of what is not
// tensor-core time (PERF.md, Findings), so it is kept short: one MUFU.EX2 a
// pair (ex2.approx, below), delta pre-scaled by the delta kernel, and the
// mask reduced to each row's (or key's) one interval of visible positions,
// tested only on tiles the mask cuts (Masks::whole).  The forward's turn-
// taking of the two consumer warpgroups, a three- or four-stage ring, a
// 64-key tile in the dQ kernel, and issuing dP^T apart so that exp2 of S^T
// runs under it were each measured on the H100 and gained nothing (PERF.md,
// Findings), so the warpgroups run free.
//
// The dK/dV blocks are launched with the key tile slowest (grid z), the dQ
// blocks with the query tile slowest and the last first, so that under a
// causal mask the blocks with the most tiles start first and the short ones
// fill the tail.

// 2^x on the special-function unit (MUFU.EX2); results below 2^-126 flush
// to 0, far under what a bf16 P or dS operand can add to an fp32 sum of
// finite terms
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

using bf16 = __nv_bfloat16;
constexpr int kWgThreads = 384;  // two consumer warpgroups and a producer
constexpr int kWgOwn = 128;      // a block's own rows (keys or queries)
constexpr int kWgTile = 64;      // dK/dV: query rows of each streamed tile
constexpr int kDqKeys = 128;     // dQ: keys of each streamed tile
constexpr int kWgStages = 2;

template <int HDP>
struct WgBwd {
  static constexpr int NCH = HDP / 64;                // 64-element boxes
  static constexpr int kOwnBytes = NCH * kWgOwn * 128;    // K, V or Q, dO
  static constexpr int kTileBytes = NCH * kWgTile * 128;  // one streamed tile
  static constexpr int kLDBytes = 2 * kWgTile * 4;  // lse2 and delta, a tile
  static constexpr int kBars = (1 + 2 * kWgStages) * 8;
  static constexpr int kSmemKV = 2 * kOwnBytes +
                                 kWgStages * (2 * kTileBytes + kLDBytes) +
                                 kBars + 1024;
  static constexpr int kKeyBytes = NCH * kDqKeys * 128;  // dQ: K or V tile
  static constexpr int kSmemQ =
      2 * kOwnBytes + kWgStages * 2 * kKeyBytes + kBars + 1024;
};

// the 64 x N accumulator fragment (N / 2 floats a thread) of rows row0 and
// row0 + 8 to global memory as bf16, hd columns, rows below `rows`
template <int R>
__device__ __forceinline__ void store_fragment(bf16* base, size_t row_stride,
                                               int row0, int rows,
                                               const float (&acc)[R], int hd,
                                               int lane) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col >= hd) continue;  // hd % 16 == 0: col + 1 < hd as well
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row < rows)
        *reinterpret_cast<__nv_bfloat162*>(
            base + static_cast<size_t>(row) * row_stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

// grid (Kv, B, ceil(Skv / 128)), 384 threads: warpgroups 0 and 1 consume
// (keys k_lo + 64 wg ..), warpgroup 2 produces.  ld: the packed scratch.
template <int HDP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ ld,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, int Kv, int hd, int Sqp, float scale,
                            Masks mk) {
  using Cfg = WgBwd<HDP>;
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + Cfg::kOwnBytes;
  uint8_t* tiles = Vs + Cfg::kOwnBytes;  // stage s: Q at 2 s, dO at 2 s + 1
  float* lds = reinterpret_cast<float*>(tiles + kWgStages * 2 *
                                        Cfg::kTileBytes);  // stage s: 128
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lds + kWgStages * 2 *
                                                  kWgTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kWgStages;

  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int G = H / Kv, Sq = mk.Sq, Skv = mk.Skv;
  const int k_lo = kt * kWgOwn, k_hi = min(k_lo + kWgOwn, Skv) - 1;
  const int n_q = (Sq + kWgTile - 1) / kWgTile;
  const int wg = threadIdx.x / 128;
  auto live = [&](int qt) {
    return mk.live(qt * kWgTile, min((qt + 1) * kWgTile, Sq) - 1, k_lo, k_hi);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * Cfg::kOwnBytes);
#pragma unroll
      for (int c = 0; c < Cfg::NCH; ++c) {
        tma_load_4d(Ks + c * kWgOwn * 128, &kmap, kv_full, 64 * c, kvh, k_lo,
                    b);
        tma_load_4d(Vs + c * kWgOwn * 128, &vmap, kv_full, 64 * c, kvh, k_lo,
                    b);
      }
      int i = 0;
      for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const float* ld_h = ld + (static_cast<size_t>(b) * H + h) * 2 * Sqp;
        for (int qt = 0; qt < n_q; ++qt) {
          if (!live(qt)) continue;
          const int s = i % kWgStages, r = i / kWgStages;
          uint8_t* qs = tiles + 2 * s * Cfg::kTileBytes;
          uint8_t* ds = qs + Cfg::kTileBytes;
          float* ls = lds + 2 * s * kWgTile;
          if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
          mbar_expect_tx(&full[s], 2 * Cfg::kTileBytes + Cfg::kLDBytes);
#pragma unroll
          for (int c = 0; c < Cfg::NCH; ++c) {
            tma_load_4d(qs + c * kWgTile * 128, &qmap, &full[s], 64 * c, h,
                        qt * kWgTile, b);
            tma_load_4d(ds + c * kWgTile * 128, &dmap, &full[s], 64 * c, h,
                        qt * kWgTile, b);
          }
          bulk_load(ls, ld_h + qt * kWgTile, kWgTile * 4, &full[s]);
          bulk_load(ls + kWgTile, ld_h + Sqp + qt * kWgTile, kWgTile * 4,
                    &full[s]);
          ++i;
        }
      }
    }
  } else {  // consumer warpgroup wg: keys k_lo + 64 wg .. + 63
    regs_inc<240>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int wk_lo = k_lo + 64 * wg;
    const int key0 = wk_lo + 16 * warp + lane / 4;  // and key0 + 8
    int qlo[2], qhi[2];  // the queries that see each of the two keys
    mk.queries_of(key0, qlo[0], qhi[0]);
    mk.queries_of(key0 + 8, qlo[1], qhi[1]);
    const float scale_log2 = scale * kLog2e;
    const uint8_t* Kw = Ks + wg * 64 * 128;
    const uint8_t* Vw = Vs + wg * 64 * 128;
    float dka[HDP / 2], dva[HDP / 2];
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) dka[j] = dva[j] = 0.f;
    mbar_wait(kv_full, 0);

    int i = 0;
    for (int g = 0; g < G; ++g) {
      for (int qt = 0; qt < n_q; ++qt) {
        if (!live(qt)) continue;
        const int s = i % kWgStages;
        const uint32_t ph = (i / kWgStages) & 1;
        const uint8_t* qs = tiles + 2 * s * Cfg::kTileBytes;
        const uint8_t* ds = qs + Cfg::kTileBytes;
        const float* lse2 = lds + 2 * s * kWgTile;
        const float* dls = lse2 + kWgTile;  // delta * scale
        const int q_lo = qt * kWgTile;
        mbar_wait(&full[s], ph);

        // S^T = K Q^T and dP^T = V dO^T: rows = this warpgroup's keys
        float st[kWgTile / 2], dpt[kWgTile / 2];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < Cfg::NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_ss<0>(st, sw128_desc(Kw + c * kWgOwn * 128 + kk * 32, 16, 1024),
                      sw128_desc(qs + c * kWgTile * 128 + kk * 32, 16, 1024),
                      (c | kk) != 0);
            mma_ss<0>(dpt,
                      sw128_desc(Vw + c * kWgOwn * 128 + kk * 32, 16, 1024),
                      sw128_desc(ds + c * kWgTile * 128 + kk * 32, 16, 1024),
                      (c | kk) != 0);
          }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T in place of S^T, exactly 0 off the mask; query column col is
        // accumulator entry 4 (col / 8) + col % 2 where lane % 4 == col % 8 / 2
        const bool whole = mk.whole(q_lo, q_lo + kWgTile - 1, wk_lo,
                                    wk_lo + 63);
#pragma unroll
        for (int j = 0; j < kWgTile / 2; j += 2) {
          const int col = 8 * (j / 4) + 2 * (lane % 4);  // queries col, + 1
          const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
          float p0 = ex2(fmaf(st[j], scale_log2, -l2.x));
          float p1 = ex2(fmaf(st[j + 1], scale_log2, -l2.y));
          if (!whole) {  // uniform over the warpgroup
            const int hr = (j / 2) % 2, t = q_lo + col;
            p0 = t >= qlo[hr] && t <= qhi[hr] ? p0 : 0.f;
            p1 = t + 1 >= qlo[hr] && t + 1 <= qhi[hr] ? p1 : 0.f;
          }
          st[j] = p0;
          st[j + 1] = p1;
        }

        // dS^T = P^T (dP^T scale - delta scale); P^T and dS^T rounded to bf16
        // as A operands (query columns 16 kk .. 16 kk + 15 are accumulator
        // entries 8 kk .. 8 kk + 7)
        uint32_t pa[kWgTile / 16][4], da[kWgTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kWgTile / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = 8 * kk + 2 * r;
            const float2 dl = *reinterpret_cast<const float2*>(
                dls + 8 * (j / 4) + 2 * (lane % 4));
            pa[kk][r] = pack_bf16(st[j], st[j + 1]);
            da[kk][r] = pack_bf16(st[j] * fmaf(dpt[j], scale, -dl.x),
                                  st[j + 1] * fmaf(dpt[j + 1], scale, -dl.y));
          }

        // dV += P^T dO, dK += dS^T Q: B MN-major, 16 query rows a step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgTile / 16; ++kk) {
          mma_rs<1>(dva, pa[kk],
                    sw128_desc(ds + kk * 16 * 128, kWgTile * 128, 1024), 1);
          mma_rs<1>(dka, da[kk],
                    sw128_desc(qs + kk * 16 * 128, kWgTile * 128, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        if (lane == 0) mbar_arrive(&empty[s]);
        ++i;
      }
    }

    const size_t kv_stride = static_cast<size_t>(Kv) * hd;
    const size_t off = static_cast<size_t>(b) * Skv * kv_stride +
                       static_cast<size_t>(kvh) * hd;
    store_fragment(dk + off, kv_stride, key0, Skv, dka, hd, lane);
    store_fragment(dv + off, kv_stride, key0, Skv, dva, hd, lane);
  }
}

// grid (H, B, ceil(Sq / 128)), 384 threads: warpgroups 0 and 1 consume
// (queries q_lo + 64 wg ..), warpgroup 2 produces.
template <int HDP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const float* __restrict__ ld,
                          bf16* __restrict__ dq, int H, int Kv, int hd,
                          int Sqp, float scale, Masks mk) {
  using Cfg = WgBwd<HDP>;
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + Cfg::kOwnBytes;
  uint8_t* tiles = dOs + Cfg::kOwnBytes;  // stage s: K at 2 s, V at 2 s + 1
  uint64_t* q_full = reinterpret_cast<uint64_t*>(tiles + kWgStages * 2 *
                                                 Cfg::kKeyBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWgStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest rows first
  const int kvh = h / (H / Kv), Sq = mk.Sq, Skv = mk.Skv;
  const int q_lo = qt * kWgOwn, q_hi = min(q_lo + kWgOwn, Sq) - 1;
  const int n_kv = (Skv + kDqKeys - 1) / kDqKeys;
  const int wg = threadIdx.x / 128;
  auto live = [&](int kt) {
    return mk.live(q_lo, q_hi, kt * kDqKeys,
                   min((kt + 1) * kDqKeys, Skv) - 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * Cfg::kOwnBytes);
#pragma unroll
      for (int c = 0; c < Cfg::NCH; ++c) {
        tma_load_4d(Qs + c * kWgOwn * 128, &qmap, q_full, 64 * c, h, q_lo, b);
        tma_load_4d(dOs + c * kWgOwn * 128, &dmap, q_full, 64 * c, h, q_lo,
                    b);
      }
      int i = 0;
      for (int kt = 0; kt < n_kv; ++kt) {
        if (!live(kt)) continue;
        const int s = i % kWgStages, r = i / kWgStages;
        uint8_t* ks = tiles + 2 * s * Cfg::kKeyBytes;
        uint8_t* vs = ks + Cfg::kKeyBytes;
        if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
        mbar_expect_tx(&full[s], 2 * Cfg::kKeyBytes);
#pragma unroll
        for (int c = 0; c < Cfg::NCH; ++c) {
          tma_load_4d(ks + c * kDqKeys * 128, &kmap, &full[s], 64 * c, kvh,
                      kt * kDqKeys, b);
          tma_load_4d(vs + c * kDqKeys * 128, &vmap, &full[s], 64 * c, kvh,
                      kt * kDqKeys, b);
        }
        ++i;
      }
    }
  } else {  // consumer warpgroup wg: queries q_lo + 64 wg .. + 63
    regs_inc<240>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int wq_lo = q_lo + 64 * wg;
    const int row0 = wq_lo + 16 * warp + lane / 4;  // and row0 + 8
    int klo[2], khi[2];  // the keys each of the two rows sees
    mk.keys_of(row0, klo[0], khi[0]);
    mk.keys_of(row0 + 8, klo[1], khi[1]);
    const float scale_log2 = scale * kLog2e;
    const float* ld_h = ld + (static_cast<size_t>(b) * H + h) * 2 * Sqp;
    float lse2[2], dls[2];  // lse * log2(e) and delta * scale of each row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = row0 + 8 * hr;
      lse2[hr] = t < Sq ? ld_h[t] : 0.f;
      dls[hr] = t < Sq ? ld_h[Sqp + t] : 0.f;
    }
    const uint8_t* Qw = Qs + wg * 64 * 128;
    const uint8_t* dOw = dOs + wg * 64 * 128;
    float dqa[HDP / 2];
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) dqa[j] = 0.f;
    mbar_wait(q_full, 0);

    int i = 0;
    for (int kt = 0; kt < n_kv; ++kt) {
      if (!live(kt)) continue;
      const int s = i % kWgStages;
      const uint32_t ph = (i / kWgStages) & 1;
      const uint8_t* ks = tiles + 2 * s * Cfg::kKeyBytes;
      const uint8_t* vs = ks + Cfg::kKeyBytes;
      const int k_lo = kt * kDqKeys;
      mbar_wait(&full[s], ph);

      // S = Q K^T and dP = dO V^T: rows = this warpgroup's queries
      float sc[kDqKeys / 2], dp[kDqKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < Cfg::NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_ss<0>(sc, sw128_desc(Qw + c * kWgOwn * 128 + kk * 32, 16, 1024),
                    sw128_desc(ks + c * kDqKeys * 128 + kk * 32, 16, 1024),
                    (c | kk) != 0);
          mma_ss<0>(dp, sw128_desc(dOw + c * kWgOwn * 128 + kk * 32, 16, 1024),
                    sw128_desc(vs + c * kDqKeys * 128 + kk * 32, 16, 1024),
                    (c | kk) != 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P in place of S, exactly 0 off the mask
      const bool whole = mk.whole(wq_lo, wq_lo + 63, k_lo,
                                  k_lo + kDqKeys - 1);
#pragma unroll
      for (int j = 0; j < kDqKeys / 2; ++j) {
        const int hr = (j / 2) % 2;
        const float x = ex2(fmaf(sc[j], scale_log2, -lse2[hr]));
        const int key = k_lo + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        sc[j] = whole || (key >= klo[hr] && key <= khi[hr]) ? x : 0.f;
      }

      // dS = P (dP scale - delta scale) as bf16 A operands (key columns
      // 16 kk .. 16 kk + 15 are accumulator entries 8 kk .. 8 kk + 7)
      uint32_t da[kDqKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 8 * kk + 2 * r, hr = r % 2;
          da[kk][r] = pack_bf16(sc[j] * fmaf(dp[j], scale, -dls[hr]),
                                sc[j + 1] * fmaf(dp[j + 1], scale, -dls[hr]));
        }

      // dQ += dS K: K MN-major, 16 key rows a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk)
        mma_rs<1>(dqa, da[kk],
                  sw128_desc(ks + kk * 16 * 128, kDqKeys * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      if (lane == 0) mbar_arrive(&empty[s]);
      ++i;
    }

    const size_t q_stride = static_cast<size_t>(H) * hd;
    store_fragment(dq + static_cast<size_t>(b) * Sq * q_stride +
                       static_cast<size_t>(h) * hd,
                   q_stride, row0, Sq, dqa, hd, lane);
  }
}

template <int HDP>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* ld, void* dq, void* dk,
                     void* dv, int B, int Sq, int Skv, int H, int Kv, int hd,
                     int Sqp, const Masks& mk, cudaStream_t stream) {
  using Cfg = WgBwd<HDP>;
  using hopper::attention_map;
  static std::atomic<size_t> ready_kv[hopper::kMaxDevices];
  static std::atomic<size_t> ready_q[hopper::kMaxDevices];
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  // dK/dV: Q and dO in 64-row tiles, K and V in 128-row ones
  CUtensorMap qmap, dmap, kmap, vmap;
  int err = attention_map(&qmap, q, B, Sq, H, hd, kWgTile);
  if (!err) err = attention_map(&dmap, dout, B, Sq, H, hd, kWgTile);
  if (!err) err = attention_map(&kmap, k, B, Skv, Kv, hd, kWgOwn);
  if (!err) err = attention_map(&vmap, v, B, Skv, Kv, hd, kWgOwn);
  if (err) return err;
  auto* fkv = flash_bwd_dkdv_wgmma_kernel<HDP>;
  cudaError_t serr = hopper::allow_smem(fkv, Cfg::kSmemKV, ready_kv);
  if (serr != cudaSuccess) return static_cast<int>(serr);
  fkv<<<dim3(Kv, B, (Skv + kWgOwn - 1) / kWgOwn), kWgThreads, Cfg::kSmemKV,
        stream>>>(qmap, dmap, kmap, vmap, ld, static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv), H, Kv, hd, Sqp, scale, mk);
  serr = cudaGetLastError();
  if (serr != cudaSuccess) return static_cast<int>(serr);
  // dQ: Q and dO in 128-row tiles, K and V in 64-row ones
  err = attention_map(&qmap, q, B, Sq, H, hd, kWgOwn);
  if (!err) err = attention_map(&dmap, dout, B, Sq, H, hd, kWgOwn);
  if (!err) err = attention_map(&kmap, k, B, Skv, Kv, hd, kDqKeys);
  if (!err) err = attention_map(&vmap, v, B, Skv, Kv, hd, kDqKeys);
  if (err) return err;
  auto* fq = flash_bwd_dq_wgmma_kernel<HDP>;
  serr = hopper::allow_smem(fq, Cfg::kSmemQ, ready_q);
  if (serr != cudaSuccess) return static_cast<int>(serr);
  fq<<<dim3(H, B, (Sq + kWgOwn - 1) / kWgOwn), kWgThreads, Cfg::kSmemQ,
       stream>>>(qmap, dmap, kmap, vmap, ld, static_cast<bf16*>(dq), H, Kv,
                 hd, Sqp, scale, mk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "tc" above hd 128 (up to 256): the wide pair, wgmma fed by TMA
// ---------------------------------------------------------------------------
//
// hd is padded to HDP = 256 by TMA's zeros (hd 144 .. 256, multiples of 16).
// The hd <= 128 pair above does not carry over:
//
// * Registers.  A consumer warpgroup that owned 64 keys would hold dK and dV
//   as 2 x 64 x 256 fp32, 256 registers a thread, over the 240 setmaxnreg
//   gives it.  So in flash_bwd_dkdv_wgmma_wide_kernel both consumer
//   warpgroups own the block's same 64 keys and split the head dimension of
//   dK and dV: warpgroup w accumulates columns 128 w .. 128 w + 127 (dK, dV:
//   64 + 64 fp32 a thread).  The S^T / dP^T products of a 64-query tile are
//   split by queries instead: warpgroup w computes them for its 32 queries
//   (m64n32k16 over the full hd; 16 + 16 fp32 a thread), turns them into
//   P^T and dS^T, and writes both as bf16 into shared memory in wgmma's
//   128-byte-swizzled K-major layout (one 64-key x 64-query tile is 64 rows
//   of 128 bytes).  After a named barrier of the two warpgroups, each runs
//   dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half] with
//   both operands from shared memory (m64n128k16).  The P^T / dS^T tiles are
//   double-buffered, so one barrier a tile suffices: a warpgroup writes tile
//   i's buffer only after the barrier of tile i - 1, which the other passes
//   only after its tile i - 2 products, the last readers of that buffer, are
//   done.  Budget a consumer thread: 128 accumulators, 32 products, about 40
//   addresses, masks and loop state; within 240, no spills (the ptxas line
//   of chip_smoke.py's device phase).
// * Shared memory.  K and V resident for 64 keys (2 x 32 KB), a two-stage
//   Q / dO ring of 64-row tiles (2 x 64 KB, each stage with its 64 rows of
//   lse * log2(e) and delta * scale, 512 bytes), the two P^T / dS^T buffers
//   (2 x 16 KB), 5 mbarriers and the 1024-byte alignment slack: 231 464 of
//   the 232 448 bytes a block may have (static_assert below).
//   flash_bwd_dq_wgmma_wide_kernel keeps the hd <= 128 pair's shape, 128
//   queries a block and 64 a consumer warpgroup (dQ 64 x 256 fp32: 128 a
//   thread), with K and V tiles cut to 32 keys (S and dP m64n32k16: 16 + 16
//   a thread), so that Q and dO resident (2 x 64 KB) and a three-stage ring
//   of K / V tiles (3 x 32 KB) fit: 230 456 bytes.
// * Too few dK/dV blocks for MQA at small B.  The grid (Kv, B, Skv / 64) is
//   64 blocks at RecurrentGemma-2B's B 1 x S 4096 x 1 KV head: half of the
//   H100's 132 SMs, each block walking all G = 10 query heads.  The wrapper
//   (kernels/flash_attention/kernel.py: bwd_head_splits) cuts the G heads of
//   a group into `splits` equal contiguous runs, one block each (grid x =
//   Kv x splits), where the grid would otherwise be under one wave of
//   blocks (one block an SM: the shared memory above allows no second): the
//   fewest that make two waves, so that the SMs even out the unequal work a
//   causal or window mask gives the key tiles (RecurrentGemma: 5 runs of 2
//   heads).  Each split writes its dK and dV as fp32 partials to scratch
//   the wrapper allocates, and flash_bwd_sum_kernel adds them in split order
//   and rounds once, so two calls stay bit-equal.  With one split the block
//   rounds and stores dK and dV itself.
//
// The element-wise step is the hd <= 128 pair's: ex2.approx, delta pre-
// scaled, the mask as one interval per key (per query in the dQ kernel),
// tested only on tiles the mask cuts.
constexpr int kWideHDP = 256;
constexpr int kWideNCH = kWideHDP / 64;  // 64-element boxes per row
constexpr int kWideKeys = 64;            // dK/dV: a block's keys
constexpr int kWideTile = 64;            // dK/dV: query rows of a tile
constexpr int kWideQ = 128;              // dQ: a block's queries
constexpr int kWideDqKeys = 32;          // dQ: keys of a tile
constexpr int kWideStages = 2;           // dK/dV ring
constexpr int kWideDqStages = 3;         // dQ ring
constexpr int kSmemLimit = 232448;       // a block's dynamic shared memory
constexpr int kSumThreads = 256;

struct WgWide {
  static constexpr int kKVBytes = kWideNCH * kWideKeys * 128;    // K or V
  static constexpr int kTileBytes = kWideNCH * kWideTile * 128;  // Q or dO
  static constexpr int kLDBytes = 2 * kWideTile * 4;  // lse2 and delta
  static constexpr int kPBytes = kWideKeys * kWideTile * 2;  // P^T or dS^T
  static constexpr int kSmemKV =
      2 * kKVBytes + kWideStages * (2 * kTileBytes + kLDBytes) +
      2 * 2 * kPBytes + (1 + 2 * kWideStages) * 8 + 1024;
  static constexpr int kQBytes = kWideNCH * kWideQ * 128;        // Q or dO
  static constexpr int kKeyBytes = kWideNCH * kWideDqKeys * 128;  // K or V
  static constexpr int kSmemQ = 2 * kQBytes +
                                kWideDqStages * 2 * kKeyBytes +
                                (1 + 2 * kWideDqStages) * 8 + 1024;
};
static_assert(WgWide::kSmemKV == 231464 && WgWide::kSmemKV <= kSmemLimit,
              "dK/dV wide: K, V, the Q/dO ring and the P/dS buffers");
static_assert(WgWide::kSmemQ == 230456 && WgWide::kSmemQ <= kSmemLimit,
              "dQ wide: Q, dO and the K/V ring");

// the 64 x N fp32 accumulator fragment of rows row0 and row0 + 8 to global
// memory as fp32 (the split partials), hd columns, rows below `rows`
template <int R>
__device__ __forceinline__ void store_fragment_f32(float* base,
                                                   size_t row_stride,
                                                   int row0, int rows,
                                                   const float (&acc)[R],
                                                   int hd, int lane) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col >= hd) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row < rows)
        *reinterpret_cast<float2*>(base + static_cast<size_t>(row) *
                                              row_stride + col) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

// grid (Kv * splits, B, ceil(Skv / 64)), 384 threads: warpgroups 0 and 1
// consume (the block's 64 keys; queries 32 wg .. of each tile for S^T and
// dP^T, hd columns 128 wg .. of dK and dV), warpgroup 2 produces.  Split sp
// walks the query heads [sp G / splits, (sp + 1) G / splits) of the group.
// part: (2, splits, B, Skv, Kv, hd) fp32 when splits > 1, else unused.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap dmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const float* __restrict__ ld,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 float* __restrict__ part, int H, int Kv,
                                 int hd, int Sqp, float scale, Masks mk,
                                 int splits) {
  using Cfg = WgWide;
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + Cfg::kKVBytes;
  uint8_t* tiles = Vs + Cfg::kKVBytes;  // stage s: Q at 2 s, dO at 2 s + 1
  uint8_t* pds = tiles + kWideStages * 2 * Cfg::kTileBytes;  // buffer u:
  // P^T at 2 u, dS^T at 2 u + 1
  float* lds = reinterpret_cast<float*>(pds + 2 * 2 * Cfg::kPBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lds + kWideStages * 2 *
                                                  kWideTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kWideStages;

  const int kvh = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int b = blockIdx.y, kt = blockIdx.z;
  const int G = H / Kv, Sq = mk.Sq, Skv = mk.Skv;
  const int g0 = sp * G / splits, g1 = (sp + 1) * G / splits;
  const int k_lo = kt * kWideKeys, k_hi = min(k_lo + kWideKeys, Skv) - 1;
  const int n_q = (Sq + kWideTile - 1) / kWideTile;
  const int wg = threadIdx.x / 128;
  auto live = [&](int qt) {
    return mk.live(qt * kWideTile, min((qt + 1) * kWideTile, Sq) - 1, k_lo,
                   k_hi);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * Cfg::kKVBytes);
#pragma unroll
      for (int c = 0; c < kWideNCH; ++c) {
        tma_load_4d(Ks + c * kWideKeys * 128, &kmap, kv_full, 64 * c, kvh,
                    k_lo, b);
        tma_load_4d(Vs + c * kWideKeys * 128, &vmap, kv_full, 64 * c, kvh,
                    k_lo, b);
      }
      int i = 0;
      for (int g = g0; g < g1; ++g) {
        const int h = kvh * G + g;
        const float* ld_h = ld + (static_cast<size_t>(b) * H + h) * 2 * Sqp;
        for (int qt = 0; qt < n_q; ++qt) {
          if (!live(qt)) continue;
          const int s = i % kWideStages, r = i / kWideStages;
          uint8_t* qs = tiles + 2 * s * Cfg::kTileBytes;
          uint8_t* ds = qs + Cfg::kTileBytes;
          float* ls = lds + 2 * s * kWideTile;
          if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
          mbar_expect_tx(&full[s], 2 * Cfg::kTileBytes + Cfg::kLDBytes);
#pragma unroll
          for (int c = 0; c < kWideNCH; ++c) {
            tma_load_4d(qs + c * kWideTile * 128, &qmap, &full[s], 64 * c, h,
                        qt * kWideTile, b);
            tma_load_4d(ds + c * kWideTile * 128, &dmap, &full[s], 64 * c, h,
                        qt * kWideTile, b);
          }
          bulk_load(ls, ld_h + qt * kWideTile, kWideTile * 4, &full[s]);
          bulk_load(ls + kWideTile, ld_h + Sqp + qt * kWideTile,
                    kWideTile * 4, &full[s]);
          ++i;
        }
      }
    }
  } else {  // consumer warpgroup wg
    regs_inc<240>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row = 16 * warp + lane / 4;  // keys k_lo + row and + 8
    const int key0 = k_lo + row;
    const int qh = 32 * wg;  // this warpgroup's queries of each tile
    int qlo[2], qhi[2];  // the queries that see each of the two keys
    mk.queries_of(key0, qlo[0], qhi[0]);
    mk.queries_of(key0 + 8, qlo[1], qhi[1]);
    const float scale_log2 = scale * kLog2e;
    float dka[kWideHDP / 4], dva[kWideHDP / 4];  // columns 128 wg ..
#pragma unroll
    for (int j = 0; j < kWideHDP / 4; ++j) dka[j] = dva[j] = 0.f;
    mbar_wait(kv_full, 0);

    int i = 0;
    for (int g = g0; g < g1; ++g) {
      for (int qt = 0; qt < n_q; ++qt) {
        if (!live(qt)) continue;
        const int s = i % kWideStages;
        const uint32_t ph = (i / kWideStages) & 1;
        const uint8_t* qs = tiles + 2 * s * Cfg::kTileBytes;
        const uint8_t* ds = qs + Cfg::kTileBytes;
        const float* lse2 = lds + 2 * s * kWideTile + qh;
        const float* dls = lse2 + kWideTile;  // delta * scale
        uint8_t* pt = pds + 2 * (i % 2) * Cfg::kPBytes;
        uint8_t* dst = pt + Cfg::kPBytes;
        const int q_lo = qt * kWideTile + qh;
        mbar_wait(&full[s], ph);

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x this warpgroup's 32
        // queries, the reduction over all of hd
        float st[16], dpt[16];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kWideNCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_ss<0>(st,
                      sw128_desc(Ks + c * kWideKeys * 128 + kk * 32, 16, 1024),
                      sw128_desc(qs + c * kWideTile * 128 + qh * 128 + kk * 32,
                                 16, 1024),
                      (c | kk) != 0);
            mma_ss<0>(dpt,
                      sw128_desc(Vs + c * kWideKeys * 128 + kk * 32, 16, 1024),
                      sw128_desc(ds + c * kWideTile * 128 + qh * 128 + kk * 32,
                                 16, 1024),
                      (c | kk) != 0);
          }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T (exactly 0 off the mask) and dS^T = P^T (dP^T scale - delta
        // scale) as bf16 into the tile's K-major swizzled buffers: key row
        // r, query column c at r 128 + ((c / 8) ^ (r % 8)) 16 + (c % 8) 2
        const bool whole = mk.whole(q_lo, q_lo + 31, k_lo, k_lo + 63);
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          const int col = 8 * (j / 4) + 2 * (lane % 4);  // queries col, + 1
          const int hr = (j / 2) % 2;
          const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
          const float2 dl = *reinterpret_cast<const float2*>(dls + col);
          float p0 = ex2(fmaf(st[j], scale_log2, -l2.x));
          float p1 = ex2(fmaf(st[j + 1], scale_log2, -l2.y));
          if (!whole) {  // uniform over the warpgroup
            const int t = q_lo + col;
            p0 = t >= qlo[hr] && t <= qhi[hr] ? p0 : 0.f;
            p1 = t + 1 >= qlo[hr] && t + 1 <= qhi[hr] ? p1 : 0.f;
          }
          const int r = row + 8 * hr, c = qh + col;
          const int off = r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
          *reinterpret_cast<uint32_t*>(pt + off) = pack_bf16(p0, p1);
          *reinterpret_cast<uint32_t*>(dst + off) =
              pack_bf16(p0 * fmaf(dpt[j], scale, -dl.x),
                        p1 * fmaf(dpt[j + 1], scale, -dl.y));
        }
        fence_proxy_async();  // the writes, visible to wgmma's reads
        named_sync(1, 256);   // both halves of the tile written

        // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half]:
        // A K-major from the buffers, B MN-major, 16 query rows a step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWideTile / 16; ++kk) {
          mma_ss<1>(dva, sw128_desc(pt + kk * 32, 16, 1024),
                    sw128_desc(ds + 2 * wg * kWideTile * 128 + kk * 16 * 128,
                               kWideTile * 128, 1024),
                    1);
          mma_ss<1>(dka, sw128_desc(dst + kk * 32, 16, 1024),
                    sw128_desc(qs + 2 * wg * kWideTile * 128 + kk * 16 * 128,
                               kWideTile * 128, 1024),
                    1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        if (lane == 0) mbar_arrive(&empty[s]);
        ++i;
      }
    }

    const size_t kv_stride = static_cast<size_t>(Kv) * hd;
    const size_t off = static_cast<size_t>(b) * Skv * kv_stride +
                       static_cast<size_t>(kvh) * hd + 128 * wg;
    const int cols = hd - 128 * wg;  // > 0: hd > 128
    if (splits == 1) {
      store_fragment(dk + off, kv_stride, key0, Skv, dka, cols, lane);
      store_fragment(dv + off, kv_stride, key0, Skv, dva, cols, lane);
    } else {
      const size_t n = static_cast<size_t>(gridDim.y) * Skv * kv_stride;
      store_fragment_f32(part + sp * n + off, kv_stride, key0, Skv, dka, cols,
                         lane);
      store_fragment_f32(part + (splits + sp) * n + off, kv_stride, key0, Skv,
                         dva, cols, lane);
    }
  }
}

// dk and dv (n elements each, bf16) = the fp32 partials of part (2, splits,
// n) summed in split order, rounded once; four elements a thread (n % 4 ==
// 0: hd % 16 == 0)
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, size_t n, int splits) {
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * kSumThreads + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* p = part + static_cast<size_t>(which) * splits * n + i;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int j = 1; j < splits; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(p + j * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    bf16* out = (which ? dv : dk) + i;
    *reinterpret_cast<__nv_bfloat162*>(out) =
        __floats2bfloat162_rn(acc.x, acc.y);
    *reinterpret_cast<__nv_bfloat162*>(out + 2) =
        __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// grid (H, B, ceil(Sq / 128)), 384 threads: warpgroups 0 and 1 consume
// (queries q_lo + 64 wg ..), warpgroup 2 produces.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap dmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const float* __restrict__ ld,
                               bf16* __restrict__ dq, int H, int Kv, int hd,
                               int Sqp, float scale, Masks mk) {
  using Cfg = WgWide;
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + Cfg::kQBytes;
  uint8_t* tiles = dOs + Cfg::kQBytes;  // stage s: K at 2 s, V at 2 s + 1
  uint64_t* q_full = reinterpret_cast<uint64_t*>(tiles + kWideDqStages * 2 *
                                                 Cfg::kKeyBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWideDqStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest rows first
  const int kvh = h / (H / Kv), Sq = mk.Sq, Skv = mk.Skv;
  const int q_lo = qt * kWideQ, q_hi = min(q_lo + kWideQ, Sq) - 1;
  const int n_kv = (Skv + kWideDqKeys - 1) / kWideDqKeys;
  const int wg = threadIdx.x / 128;
  auto live = [&](int kt) {
    return mk.live(q_lo, q_hi, kt * kWideDqKeys,
                   min((kt + 1) * kWideDqKeys, Skv) - 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWideDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * Cfg::kQBytes);
#pragma unroll
      for (int c = 0; c < kWideNCH; ++c) {
        tma_load_4d(Qs + c * kWideQ * 128, &qmap, q_full, 64 * c, h, q_lo, b);
        tma_load_4d(dOs + c * kWideQ * 128, &dmap, q_full, 64 * c, h, q_lo,
                    b);
      }
      int i = 0;
      for (int kt = 0; kt < n_kv; ++kt) {
        if (!live(kt)) continue;
        const int s = i % kWideDqStages, r = i / kWideDqStages;
        uint8_t* ks = tiles + 2 * s * Cfg::kKeyBytes;
        uint8_t* vs = ks + Cfg::kKeyBytes;
        if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
        mbar_expect_tx(&full[s], 2 * Cfg::kKeyBytes);
#pragma unroll
        for (int c = 0; c < kWideNCH; ++c) {
          tma_load_4d(ks + c * kWideDqKeys * 128, &kmap, &full[s], 64 * c,
                      kvh, kt * kWideDqKeys, b);
          tma_load_4d(vs + c * kWideDqKeys * 128, &vmap, &full[s], 64 * c,
                      kvh, kt * kWideDqKeys, b);
        }
        ++i;
      }
    }
  } else {  // consumer warpgroup wg: queries q_lo + 64 wg .. + 63
    regs_inc<240>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int wq_lo = q_lo + 64 * wg;
    const int row0 = wq_lo + 16 * warp + lane / 4;  // and row0 + 8
    int klo[2], khi[2];  // the keys each of the two rows sees
    mk.keys_of(row0, klo[0], khi[0]);
    mk.keys_of(row0 + 8, klo[1], khi[1]);
    const float scale_log2 = scale * kLog2e;
    const float* ld_h = ld + (static_cast<size_t>(b) * H + h) * 2 * Sqp;
    float lse2[2], dls[2];  // lse * log2(e) and delta * scale of each row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = row0 + 8 * hr;
      lse2[hr] = t < Sq ? ld_h[t] : 0.f;
      dls[hr] = t < Sq ? ld_h[Sqp + t] : 0.f;
    }
    const uint8_t* Qw = Qs + wg * 64 * 128;
    const uint8_t* dOw = dOs + wg * 64 * 128;
    float dqa[kWideHDP / 2];
#pragma unroll
    for (int j = 0; j < kWideHDP / 2; ++j) dqa[j] = 0.f;
    mbar_wait(q_full, 0);

    int i = 0;
    for (int kt = 0; kt < n_kv; ++kt) {
      if (!live(kt)) continue;
      const int s = i % kWideDqStages;
      const uint32_t ph = (i / kWideDqStages) & 1;
      const uint8_t* ks = tiles + 2 * s * Cfg::kKeyBytes;
      const uint8_t* vs = ks + Cfg::kKeyBytes;
      const int k_lo = kt * kWideDqKeys;
      mbar_wait(&full[s], ph);

      // S = Q K^T and dP = dO V^T: this warpgroup's 64 queries x 32 keys
      float sc[kWideDqKeys / 2], dp[kWideDqKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kWideNCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_ss<0>(sc, sw128_desc(Qw + c * kWideQ * 128 + kk * 32, 16, 1024),
                    sw128_desc(ks + c * kWideDqKeys * 128 + kk * 32, 16, 1024),
                    (c | kk) != 0);
          mma_ss<0>(dp, sw128_desc(dOw + c * kWideQ * 128 + kk * 32, 16, 1024),
                    sw128_desc(vs + c * kWideDqKeys * 128 + kk * 32, 16, 1024),
                    (c | kk) != 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P in place of S, exactly 0 off the mask
      const bool whole = mk.whole(wq_lo, wq_lo + 63, k_lo,
                                  k_lo + kWideDqKeys - 1);
#pragma unroll
      for (int j = 0; j < kWideDqKeys / 2; ++j) {
        const int hr = (j / 2) % 2;
        const float x = ex2(fmaf(sc[j], scale_log2, -lse2[hr]));
        const int key = k_lo + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        sc[j] = whole || (key >= klo[hr] && key <= khi[hr]) ? x : 0.f;
      }

      // dS = P (dP scale - delta scale) as bf16 A operands
      uint32_t da[kWideDqKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWideDqKeys / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 8 * kk + 2 * r, hr = r % 2;
          da[kk][r] = pack_bf16(sc[j] * fmaf(dp[j], scale, -dls[hr]),
                                sc[j + 1] * fmaf(dp[j + 1], scale, -dls[hr]));
        }

      // dQ += dS K: K MN-major (boxes of 32 key rows), 16 keys a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWideDqKeys / 16; ++kk)
        mma_rs<1>(dqa, da[kk],
                  sw128_desc(ks + kk * 16 * 128, kWideDqKeys * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      if (lane == 0) mbar_arrive(&empty[s]);
      ++i;
    }

    const size_t q_stride = static_cast<size_t>(H) * hd;
    store_fragment(dq + static_cast<size_t>(b) * Sq * q_stride +
                       static_cast<size_t>(h) * hd,
                   q_stride, row0, Sq, dqa, hd, lane);
  }
}

int launch_bwd_wgmma_wide(const void* q, const void* k, const void* v,
                          const void* dout, const float* ld, void* dq,
                          void* dk, void* dv, float* part, int B, int Sq,
                          int Skv, int H, int Kv, int hd, int Sqp,
                          int splits, const Masks& mk, cudaStream_t stream) {
  using Cfg = WgWide;
  using hopper::attention_map;
  static std::atomic<size_t> ready_kv[hopper::kMaxDevices];
  static std::atomic<size_t> ready_q[hopper::kMaxDevices];
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  // dK/dV: every tile 64 rows
  CUtensorMap qmap, dmap, kmap, vmap;
  int err = attention_map(&qmap, q, B, Sq, H, hd, kWideTile);
  if (!err) err = attention_map(&dmap, dout, B, Sq, H, hd, kWideTile);
  if (!err) err = attention_map(&kmap, k, B, Skv, Kv, hd, kWideKeys);
  if (!err) err = attention_map(&vmap, v, B, Skv, Kv, hd, kWideKeys);
  if (err) return err;
  auto* fkv = flash_bwd_dkdv_wgmma_wide_kernel;
  cudaError_t serr = hopper::allow_smem(fkv, Cfg::kSmemKV, ready_kv);
  if (serr != cudaSuccess) return static_cast<int>(serr);
  fkv<<<dim3(Kv * splits, B, (Skv + kWideKeys - 1) / kWideKeys), kWgThreads,
        Cfg::kSmemKV, stream>>>(qmap, dmap, kmap, vmap, ld,
                                static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                part, H, Kv, hd, Sqp, scale, mk, splits);
  serr = cudaGetLastError();
  if (serr != cudaSuccess) return static_cast<int>(serr);
  if (splits > 1) {
    const size_t n = static_cast<size_t>(B) * Skv * Kv * hd;
    const size_t blocks = (n / 4 + kSumThreads - 1) / kSumThreads;
    flash_bwd_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                           stream>>>(part, static_cast<bf16*>(dk),
                                     static_cast<bf16*>(dv), n, splits);
    serr = cudaGetLastError();
    if (serr != cudaSuccess) return static_cast<int>(serr);
  }
  // dQ: Q and dO in 128-row tiles, K and V in 32-row ones
  err = attention_map(&qmap, q, B, Sq, H, hd, kWideQ);
  if (!err) err = attention_map(&dmap, dout, B, Sq, H, hd, kWideQ);
  if (!err) err = attention_map(&kmap, k, B, Skv, Kv, hd, kWideDqKeys);
  if (!err) err = attention_map(&vmap, v, B, Skv, Kv, hd, kWideDqKeys);
  if (err) return err;
  auto* fq = flash_bwd_dq_wgmma_wide_kernel;
  serr = hopper::allow_smem(fq, Cfg::kSmemQ, ready_q);
  if (serr != cudaSuccess) return static_cast<int>(serr);
  fq<<<dim3(H, B, (Sq + kWideQ - 1) / kWideQ), kWgThreads, Cfg::kSmemQ,
       stream>>>(qmap, dmap, kmap, vmap, ld, static_cast<bf16*>(dq), H, Kv,
                 hd, Sqp, scale, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PACK>
int launch_delta(const void* out, const void* dout, const float* lse,
                 float* delta, int B, int Sq, int Sqp, int H, int hd,
                 cudaStream_t stream) {
  const int rows = B * Sqp * H;  // Sqp == Sq unless PACK
  flash_bwd_delta_kernel<T, PACK><<<(rows + kDeltaRows - 1) / kDeltaRows,
                                    32 * kDeltaRows, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), lse, delta,
      rows, Sq, Sqp, H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MAXJ>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int Sq, int Skv, int H, int Kv, int hd,
               const Masks& mk, cudaStream_t stream) {
  static std::atomic<size_t> ready_kv[hopper::kMaxDevices];
  static std::atomic<size_t> ready_q[hopper::kMaxDevices];
  constexpr int BT = Tiles<MAXJ>::B;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  auto* fkv = flash_bwd_dkdv_kernel<T, MAXJ>;
  const size_t smem_kv = bwd_smem_bytes(hd, BT, 2);
  cudaError_t err =
      hopper::allow_smem(fkv, bwd_smem_bytes(16 * MAXJ, BT, 2), ready_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  fkv<<<dim3((Skv + BT - 1) / BT, Kv, B), kThreads, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H,
      Kv, hd, scale, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto* fq = flash_bwd_dq_kernel<T, MAXJ>;
  const size_t smem_q = bwd_smem_bytes(hd, BT, 1);
  err = hopper::allow_smem(fq, bwd_smem_bytes(16 * MAXJ, BT, 1), ready_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  fq<<<dim3((Sq + BT - 1) / BT, H, B), kThreads, smem_q, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), H, Kv, hd, scale, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, void* dk,
                 void* dv, int B, int Sq, int Skv, int H, int Kv, int hd,
                 const Masks& mk, cudaStream_t stream) {
  const int nj = hd / 16;
#define REPRO_BWD(MAXJ)                                                    \
  return launch_bwd<T, MAXJ>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, \
                             Skv, H, Kv, hd, mk, stream)
  if (nj <= 1) REPRO_BWD(1);
  if (nj <= 2) REPRO_BWD(2);
  if (nj <= 4) REPRO_BWD(4);
  if (nj <= 8) REPRO_BWD(8);
  REPRO_BWD(16);
#undef REPRO_BWD
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 for q, k, v, out, dout, dq, dk, dv; lse
// (B, H, Sq) is fp32.  hd a multiple of 16 up to 256.  variant: 0 "ffma",
// 1 "tc" (bf16 only: the wgmma pair up to hd 128, the wide pair above).
// delta is fp32 scratch: (B, H, Sq) for "ffma", (B, H, 2, Sqp) for "tc",
// Sqp = Sq rounded up to a multiple of 64, 16-byte aligned.  splits: the
// wide dK/dV kernel's head splits (1 otherwise); with more than one, part
// is fp32 scratch of (2, splits, B, Skv, Kv, hd).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Skv, int H, int Kv, int hd,
    int causal, int window, int chunk, int variant, int splits, float* part,
    void* stream) {
  using repro_torch::Masks;
  auto s = static_cast<cudaStream_t>(stream);
  const bool wide = variant == 1 && hd > 128;
  if (variant < 0 || variant > 1 || (variant && (dtype != 1 || hd > 256)) ||
      splits < 1 || (splits > 1 && (!wide || !part || splits > H / Kv)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Masks mk{Sq, Skv, causal, window, chunk};
  if (variant == 1) {
    const int Sqp = (Sq + 63) / 64 * 64;
    int err = repro_torch::launch_delta<__nv_bfloat16, 1>(
        out, dout, lse, delta, B, Sq, Sqp, H, hd, s);
    if (err) return err;
    if (wide)
      return repro_torch::launch_bwd_wgmma_wide(q, k, v, dout, delta, dq, dk,
                                                dv, part, B, Sq, Skv, H, Kv,
                                                hd, Sqp, splits, mk, s);
    if (hd <= 64)
      return repro_torch::launch_bwd_wgmma<64>(q, k, v, dout, delta, dq, dk,
                                               dv, B, Sq, Skv, H, Kv, hd, Sqp,
                                               mk, s);
    return repro_torch::launch_bwd_wgmma<128>(q, k, v, dout, delta, dq, dk, dv,
                                              B, Sq, Skv, H, Kv, hd, Sqp, mk,
                                              s);
  }
  int err = dtype == 0 ? repro_torch::launch_delta<float, 0>(
                             out, dout, lse, delta, B, Sq, Sq, H, hd, s)
                       : repro_torch::launch_delta<__nv_bfloat16, 0>(
                             out, dout, lse, delta, B, Sq, Sq, H, hd, s);
  if (err) return err;
  if (dtype == 0)
    return repro_torch::dispatch_bwd<float>(q, k, v, dout, lse, delta, dq, dk,
                                            dv, B, Sq, Skv, H, Kv, hd, mk, s);
  return repro_torch::dispatch_bwd<__nv_bfloat16>(
      q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kv, hd, mk, s);
}
