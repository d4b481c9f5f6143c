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
// Sq != Skv.  Every sum is fp32 (the tensor-core variant rounds P and dS to
// bf16 as product operands); dQ, dK and dV are rounded once to the input
// type.  A query row that sees no key has P = 0 on every key,
// so its gradients are 0 (its lse, -1e30, is never used).
//
// Deterministic by construction (restarted training must reproduce a run):
// no atomics.  FA2's split into two kernels after the delta kernel:
//
// * flash_bwd_dkdv_kernel: one block per (b, KV head, BK-key tile).  It
//   keeps the tile's K and V in shared memory and its dK and dV accumulators
//   in registers, and walks the G = H / Kv query heads of the group and, for
//   each, the BQ-row query tiles that can see the tile (tiles masked whole
//   are skipped).  So the GQA sum over the group happens inside the block,
//   in a fixed order; JAX sums it through the transpose of jnp.repeat.
// * flash_bwd_dq_kernel: one block per (b, query head, BQ-row query tile),
//   over the KV tiles the tile can see.  It recomputes S and dP (the dQ
//   products are not in the bound of chip_smoke.py, which counts the five
//   products once: 10 hd FLOPs per visible pair).
//
// What bounds it on an H100: 10 hd FLOPs (14 hd with the recomputation) per
// visible (query, key) pair on 7 B S H hd inputs and outputs: bound by
// operations.  Two variants of the two kernels, one rule
// (kernels/flash_attention/kernel.py: route_bwd):
// * "tc", bf16 with hd <= 128 (every trained model's attention): bf16 tiles
//   and mma.sync on the tensor cores (989 TFLOP/s peak), below;
// * "ffma", fp32 and bf16 above hd 128: the products on the CUDA cores in
//   fp32 (66.9 TFLOP/s peak), the design of the FFMA forward in
//   attention.cu: fp32 tiles in shared memory with an odd row stride (column
//   reads hit distinct banks), 16 x 16 threads, each with a register tile of
//   the BQ x BK scores and of its rows of the accumulators.
//
// flash_attention_bwd_launch returns cudaGetLastError() after its launches
// (0 on success).
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
// warp per (b, t, h) row.
template <typename T>
__global__ void __launch_bounds__(32 * kDeltaRows)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H,
                       int hd) {
  const int row = blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + static_cast<size_t>(row) * hd;
  const T* d = dout + static_cast<size_t>(row) * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const int h = row % H, bt = row / H;  // row = (b Sq + t) H + h
    const int b = bt / Sq, t = bt % Sq;
    delta[(static_cast<size_t>(b) * H + h) * Sq + t] = acc;
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
// bf16 on the tensor cores (hd <= 128): mma.sync.m16n8k16, fp32 accumulate
// ---------------------------------------------------------------------------
//
// The same two kernels with bf16 tiles in shared memory (rows padded by 16
// bytes: ldmatrix reads eight rows in eight distinct 4-bank groups, as
// decode_attention_tc.cu), filled by 16-byte cp.async copies (rows past the
// sequence are zero fills), and every product on mma.sync fed by ldmatrix.
// Each warp owns 16 rows of its block's tile: keys in the dK/dV kernel,
// queries in the dQ kernel.  The score tiles S and dP of a warp stay in
// registers, P and dS are repacked in place as the A operand of the next
// product (rounded to bf16: within 2^-9 of each term, inside the bound of
// chip_smoke.py's check), and the dK, dV or dQ accumulators of the warp's 16
// rows stay in registers for the whole block: hd / 8 fragments of 4 fp32
// each, so hd <= 128 (bf16 at larger hd takes the FFMA kernels above).  NT
// = hd / 8 is a template argument, one instantiation per head dim, so the
// fragment loops and the tile strides are compile-time constants.

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // a block's own rows: 64
constexpr int kTcOther = 32;            // rows of the tile it walks over
constexpr float kLog2e = 1.4426950408889634f;

size_t tc_smem_bytes(int hd) {
  const size_t ld = hd + 8;
  return sizeof(bf16) * 2 * (kTcRows + kTcOther) * ld +
         sizeof(float) * 2 * kTcRows;
}

// rows [row0, row0 + rows) of hd bf16, row r at base + r * row_stride, into
// dst[r] (leading dimension ld) by cp.async; rows at or past `valid` are
// zero-filled.
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* base,
                                          size_t row_stride, int row0,
                                          int valid, int rows, int hd) {
  const int per_row = hd / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool ok = r < valid;
    hopper::cp_async16(dst + r * ld + c,
                       base + static_cast<size_t>(ok ? row0 + r : row0) *
                                  row_stride + c,
                       ok ? 16 : 0);
  }
}

// D (16 x 32) = A B^T over hd: A the warp's 16 rows at A0 (row-major, ld),
// B 32 rows at B0; four n-tiles of 8 columns.
template <int NT>
__device__ __forceinline__ void warp_scores(float (&d)[4][4], const bf16* A0,
                                            const bf16* B0, int ld, int hd,
                                            int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (kk < hd / 16) {
      uint32_t a[4];
      hopper::ldmatrix_x4(a, A0 + (lane % 16) * ld + (lane / 16) * 8 + kk * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        hopper::ldmatrix_x4(
            b, B0 + (np * 16 + (lane / 16) * 8 + lane % 8) * ld +
                   ((lane / 8) % 2) * 8 + kk * 16);
        hopper::mma_16816(d[2 * np], a, b[0], b[1]);
        hopper::mma_16816(d[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc (16 x hd) += P (16 x 32, as two k16 A operands) X (32 x hd), X's 32
// rows at X0 (row-major, ld), read transposed by ldmatrix.
template <int NT>
__device__ __forceinline__ void warp_accumulate(float (&acc)[NT][4],
                                                const uint32_t (&p)[2][4],
                                                const bf16* X0, int ld, int hd,
                                                int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np < hd / 16) {
        uint32_t b[4];
        hopper::ldmatrix_x4_trans(
            b, X0 + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld +
                   np * 16 + (lane / 16) * 8);
        hopper::mma_16816(acc[2 * np], p[kk], b[0], b[1]);
        hopper::mma_16816(acc[2 * np + 1], p[kk], b[2], b[3]);
      }
    }
}

// score fragments (16 x 32) as two k16 A operands, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[2][4],
                                       const float (&d)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      a[kk][2 * n] = hopper::pack_bf16(d[2 * kk + n][0], d[2 * kk + n][1]);
      a[kk][2 * n + 1] = hopper::pack_bf16(d[2 * kk + n][2], d[2 * kk + n][3]);
    }
}

// the warp's 16 x hd accumulator rows to global memory as bf16
template <int NT>
__device__ __forceinline__ void store_rows(bf16* base, size_t row_stride,
                                           int row0, int rows_valid,
                                           const float (&acc)[NT][4], int hd,
                                           int lane) {
  const int g = lane / 4, c4 = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < hd / 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r < rows_valid)
          *reinterpret_cast<__nv_bfloat162*>(
              base + static_cast<size_t>(row0 + r) * row_stride + n * 8 +
              2 * c4) = __floats2bfloat162_rn(acc[n][2 * h],
                                              acc[n][2 * h + 1]);
      }
    }
  }
}

// grid (ceil(Skv / 64), Kv, B), 128 threads: warp w owns keys 16 w .. + 15
// of the block's tile, and walks the group's query heads and their 32-row
// query tiles.  NT = hd / 8 rounded up to a power of two (<= 16).
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int Kv, float scale,
                         Masks mk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int hd = 8 * NT, ld = hd + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* Vs = Ks + kTcRows * ld;                  // [64][ld]
  bf16* Qs = Vs + kTcRows * ld;                  // [32][ld]
  bf16* dOs = Qs + kTcOther * ld;                // [32][ld]
  float* lse_s = reinterpret_cast<float*>(dOs + kTcOther * ld);  // log2 units
  float* delta_s = lse_s + kTcOther;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv, Sq = mk.Sq, Skv = mk.Skv;
  const int k_lo = kt * kTcRows, k_hi = min(k_lo + kTcRows, Skv) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c4 = lane % 4;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Kv) * hd;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_stride +
                        static_cast<size_t>(kvh) * hd;
  copy_rows(Ks, ld, k + kv_off, kv_stride, k_lo, Skv - k_lo, kTcRows, hd);
  copy_rows(Vs, ld, v + kv_off, kv_stride, k_lo, Skv - k_lo, kTcRows, hd);
  const float scale_log2 = scale * kLog2e;

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const bf16* Kw = Ks + warp * 16 * ld;
  const bf16* Vw = Vs + warp * 16 * ld;
  const int key0 = k_lo + warp * 16 + g;  // and key0 + 8

  const int n_q = (Sq + kTcOther - 1) / kTcOther;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const size_t q_off = static_cast<size_t>(b) * Sq * q_stride +
                         static_cast<size_t>(h) * hd;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q_lo = qt * kTcOther, q_hi = min(q_lo + kTcOther, Sq) - 1;
      if (!mk.live(q_lo, q_hi, k_lo, k_hi)) continue;  // uniform
      __syncthreads();  // the previous tile's Q and dO are read
      copy_rows(Qs, ld, q + q_off, q_stride, q_lo, Sq - q_lo, kTcOther, hd);
      copy_rows(dOs, ld, dout + q_off, q_stride, q_lo, Sq - q_lo, kTcOther,
                hd);
      hopper::cp_async_commit();
      for (int i = threadIdx.x; i < kTcOther; i += blockDim.x) {
        const bool in = q_lo + i < Sq;
        lse_s[i] = in ? lse_h[q_lo + i] * kLog2e : 0.f;
        delta_s[i] = in ? delta_h[q_lo + i] : 0.f;
      }
      hopper::cp_async_wait<0>();
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: rows = this warp's keys
      float st[4][4], dpt[4][4];
      warp_scores<NT>(st, Kw, Qs, ld, hd, lane);
      warp_scores<NT>(dpt, Vw, dOs, ld, hd, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * c4 + (e & 1);  // query in the tile
          const bool ok = mk.sees(q_lo + col, key0 + 8 * (e / 2));
          const float p =
              ok ? exp2f(st[n][e] * scale_log2 - lse_s[col]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[col]) * scale;
        }
      uint32_t pa[2][4], da[2][4];
      pack_a(pa, st);
      pack_a(da, dpt);
      // dV += P^T dO, dK += dS^T Q
      warp_accumulate<NT>(acc_v, pa, dOs, ld, hd, lane);
      warp_accumulate<NT>(acc_k, da, Qs, ld, hd, lane);
    }
  }
  hopper::cp_async_wait<0>();  // K and V, when no query tile was live
  const int rows = min(16, Skv - (k_lo + warp * 16));
  store_rows<NT>(dk + kv_off, kv_stride, k_lo + warp * 16, rows, acc_k, hd,
                 lane);
  store_rows<NT>(dv + kv_off, kv_stride, k_lo + warp * 16, rows, acc_v, hd,
                 lane);
}

// grid (ceil(Sq / 64), H, B), 128 threads: warp w owns queries 16 w .. + 15
// of the block's tile, and walks the 32-key tiles they can see.
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int H, int Kv, float scale, Masks mk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int hd = 8 * NT, ld = hd + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]
  bf16* dOs = Qs + kTcRows * ld;                 // [64][ld]
  bf16* Ks = dOs + kTcRows * ld;                 // [32][ld]
  bf16* Vs = Ks + kTcOther * ld;                 // [32][ld]

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv), Sq = mk.Sq, Skv = mk.Skv;
  const int q_lo = qt * kTcRows, q_hi = min(q_lo + kTcRows, Sq) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c4 = lane % 4;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Kv) * hd;
  const size_t q_off = static_cast<size_t>(b) * Sq * q_stride +
                       static_cast<size_t>(h) * hd;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_stride +
                        static_cast<size_t>(kvh) * hd;
  copy_rows(Qs, ld, q + q_off, q_stride, q_lo, Sq - q_lo, kTcRows, hd);
  copy_rows(dOs, ld, dout + q_off, q_stride, q_lo, Sq - q_lo, kTcRows, hd);
  hopper::cp_async_commit();
  const float scale_log2 = scale * kLog2e;
  const int row0 = q_lo + warp * 16 + g;  // and row0 + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = row0 + 8 * hh;
    const size_t i = (static_cast<size_t>(b) * H + h) * Sq + t;
    lse2[hh] = t < Sq ? lse[i] * kLog2e : 0.f;
    dlt[hh] = t < Sq ? delta[i] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bf16* Qw = Qs + warp * 16 * ld;
  const bf16* dOw = dOs + warp * 16 * ld;

  const int n_kv = (Skv + kTcOther - 1) / kTcOther;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * kTcOther, k_hi = min(k_lo + kTcOther, Skv) - 1;
    if (!mk.live(q_lo, q_hi, k_lo, k_hi)) continue;  // uniform
    __syncthreads();  // the previous tile's K and V are read
    copy_rows(Ks, ld, k + kv_off, kv_stride, k_lo, Skv - k_lo, kTcOther, hd);
    copy_rows(Vs, ld, v + kv_off, kv_stride, k_lo, Skv - k_lo, kTcOther, hd);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    // S = Q K^T and dP = dO V^T: rows = this warp's queries
    float s[4][4], dp[4][4];
    warp_scores<NT>(s, Qw, Ks, ld, hd, lane);
    warp_scores<NT>(dp, dOw, Vs, ld, hd, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2;
        const bool ok = mk.sees(row0 + 8 * hh, k_lo + n * 8 + 2 * c4 + (e & 1));
        const float p = ok ? exp2f(s[n][e] * scale_log2 - lse2[hh]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dlt[hh]) * scale;
      }
    uint32_t da[2][4];
    pack_a(da, dp);
    warp_accumulate<NT>(acc, da, Ks, ld, hd, lane);  // dQ += dS K
  }
  hopper::cp_async_wait<0>();  // Q and dO, when no key tile was live
  store_rows<NT>(dq + q_off, q_stride, q_lo + warp * 16,
                 min(16, Sq - (q_lo + warp * 16)), acc, hd, lane);
}

template <int NT>
int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
                  int Kv, int hd, const Masks& mk, cudaStream_t stream) {
  static std::atomic<size_t> ready_kv[hopper::kMaxDevices];
  static std::atomic<size_t> ready_q[hopper::kMaxDevices];
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const size_t smem = tc_smem_bytes(hd);
  auto* fkv = flash_bwd_dkdv_tc_kernel<NT>;
  cudaError_t err = hopper::allow_smem(fkv, tc_smem_bytes(8 * NT), ready_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  fkv<<<dim3((Skv + kTcRows - 1) / kTcRows, Kv, B), kTcThreads, smem,
        stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  H, Kv, scale, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* fq = flash_bwd_dq_tc_kernel<NT>;
  err = hopper::allow_smem(fq, tc_smem_bytes(8 * NT), ready_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  fq<<<dim3((Sq + kTcRows - 1) / kTcRows, H, B), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), H, Kv, scale, mk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_delta(const void* out, const void* dout, float* delta, int B,
                 int Sq, int H, int hd, cudaStream_t stream) {
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T><<<(rows + kDeltaRows - 1) / kDeltaRows,
                              32 * kDeltaRows, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows,
      Sq, H, hd);
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

int dispatch_bwd_tc(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                    int H, int Kv, int hd, const Masks& mk,
                    cudaStream_t stream) {
#define REPRO_BWD_TC(NT)                                                   \
  case 8 * NT:                                                             \
    return launch_bwd_tc<NT>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, \
                             Skv, H, Kv, hd, mk, stream)
  switch (hd) {  // one instantiation per head dim: hd == 8 NT exactly
    REPRO_BWD_TC(2);
    REPRO_BWD_TC(4);
    REPRO_BWD_TC(6);
    REPRO_BWD_TC(8);
    REPRO_BWD_TC(10);
    REPRO_BWD_TC(12);
    REPRO_BWD_TC(14);
    REPRO_BWD_TC(16);
  }
#undef REPRO_BWD_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 for q, k, v, out, dout, dq, dk, dv; lse
// and the delta scratch (B, H, Sq) are fp32.  hd a multiple of 16 up to 256.
// tc: 1 runs dK/dV and dQ on the tensor cores (bf16 and hd <= 128 only),
// 0 on the FFMA kernels.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Skv, int H, int Kv, int hd,
    int causal, int window, int chunk, int tc, void* stream) {
  using repro_torch::Masks;
  auto s = static_cast<cudaStream_t>(stream);
  if (tc && (dtype != 1 || hd > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Masks mk{Sq, Skv, causal, window, chunk};
  int err = dtype == 0 ? repro_torch::launch_delta<float>(out, dout, delta, B,
                                                          Sq, H, hd, s)
                       : repro_torch::launch_delta<__nv_bfloat16>(
                             out, dout, delta, B, Sq, H, hd, s);
  if (err) return err;
  if (tc)
    return repro_torch::dispatch_bwd_tc(q, k, v, dout, lse, delta, dq, dk, dv,
                                        B, Sq, Skv, H, Kv, hd, mk, s);
  if (dtype == 0)
    return repro_torch::dispatch_bwd<float>(q, k, v, dout, lse, delta, dq, dk,
                                            dv, B, Sq, Skv, H, Kv, hd, mk, s);
  return repro_torch::dispatch_bwd<__nv_bfloat16>(
      q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, Kv, hd, mk, s);
}
