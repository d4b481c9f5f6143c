// Decode attention in bf16 on Hopper's tensor cores: the route of every
// bf16 decode_attention call with G = H / Kv <= 16 and head_dim a multiple
// of 16 (kernels/decode_attention/kernel.py: route); fp32 keeps the FFMA
// kernel of attention.cu.
//
// Replaces the Pallas TPU kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/kernel.py:77): one new token per
// sequence against a (B, W, Kv, hd) KV cache, dense or a ring of width W,
// the chunk mask, GQA.  It computes what decode_partial_kernel and
// decode_combine_kernel compute: scores, softmax and the sum of p in fp32,
// the output in bf16.  One difference: P.V takes p as a pair of bf16
// operands (hi = bf16(p), lo = bf16(p - hi)), so p keeps 16 significant
// bits where the FFMA kernel and the TPU kernel round it to bf16
// (p.astype(v.dtype)).  Rounding the unnormalised p of an online softmax
// cannot match the plain version, which rounds the normalised p: with a
// few dominant weights (a chunked ring wrapped to 5 visible slots) the two
// roundings add past the bf16 limit of the checks (2^-7 |ref| + 2^-8 P|v|),
// for the FFMA kernel as for a float64 model of the rounding; carrying p
// leaves only the plain version's own rounding.
//
// cache_len is read from device memory, so a decode loop needs no host
// sync and the step stays capturable in a CUDA graph.  A dense slot at or
// past cache_len, and a ring slot that the mask hides (kernel.py:47-53), is
// never read: its copy is a zero fill.
//
// What bounds it on an H100: the live cache is read once for 4 G FLOPs per
// element pair, so decode is bound by bytes (3.35 TB/s, about 25 B/ns per
// SM).  The FFMA kernel reached 26 % of that at the long decode: it widened
// K and V to fp32 in shared memory (66 KB a block, 3 blocks an SM), copied
// each tile synchronously, and ran 128-long serial FMA chains.  Here:
//
// * K and V tiles of 64 slots stay bf16 in shared memory, in rows padded by
//   16 bytes (ldmatrix reads eight rows in eight distinct 4-bank groups),
//   and arrive through a 3-stage cp.async ring of 16-byte copies: two
//   tiles' loads are in flight while the third is scored.  At hd 128 a
//   block holds 106 KB and two blocks share an SM, so about 136 KB of loads
//   are in flight per SM; at hd 256 one block of 206 KB, 132 KB in flight.
//   Little's law asks for about 25 B/ns times HBM's latency, under 40 KB.
// * Both small products run on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate), fed by ldmatrix.  The G query heads of one KV head are
//   padded to 16 rows (zeros).  Each of the 4 warps takes 16 slots of a
//   tile: S = Q K^T is a 16 x 16 fragment, the online softmax runs on it in
//   registers (a row lives on the 4 lanes of a quad), and p is repacked in
//   place as the A operands (hi and lo) of O += P V, so P never goes
//   through shared memory.  A 64-row wgmma would waste most of its
//   rows at G <= 16; the tensor cores are here to keep the arithmetic off
//   the critical path, not for their rate.
// * W is split across blocks as before (kernel.py: tc_splits; one wave of
//   blocks), and across the block's warps.  The warps' (m, l, acc) are
//   reduced in shared memory at the end.  With one split the block writes
//   the output itself; otherwise it writes a partial, and a small second
//   kernel combines the splits (no device-side counter to reset).
//
// Softmax state in base 2: scores are scaled by log2(e) / sqrt(hd), so
// exp2 gives the natural exponent of the unscaled score.
//
// The lse twin (decode_attention_tc_lse_launch; kTwin, a template flag, so
// the served kernel is compiled as before) runs on a slice of a cache
// sharded along its slots: the local slots are the global slots slot0 ..
// slot0 + W - 1 of a cache of `slots` slots, visible() and the dense clamp
// read global slot numbers (a ring's arithmetic and a chunk's start work on
// the global width), and lse = ln sum exp of the visible scaled scores is
// written beside the output, (B, H) fp32.  A slice with no visible slot
// (dense, wholly past cache_len) gives 0 and lse kNegInf, never NaN: its
// blocks load no tile, and every split's state stays (kNegInf, 0, 0).
//
// The launcher returns cudaGetLastError() after its launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>

#include "hopper.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // cache slots per stage
constexpr int kWarps = 4;      // 16 slots of a tile each
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kRows = 16;      // query heads, padded
constexpr float kNegInf = -1e30f;  // running-max start, as attention.cu
constexpr float kLn2 = 0.6931471805599453f;

// ln sum exp of a softmax state in base 2 (max m, sum l of 2^(s - m))
__device__ __forceinline__ float state_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : kNegInf;
}

// dynamic shared memory at head_dim hd: Q, then the K / V ring, each row
// hd + 8 bf16 (kernels/decode_attention/kernel.py: tc_smem_bytes)
__host__ __device__ inline size_t smem_bytes(int hd) {
  const size_t ld = hd + 8;
  return sizeof(bf16) * (kRows * ld + static_cast<size_t>(kStages) * 2 *
                                          kTile * ld);
}

// may the token at qpos = cache_len - 1 see slot j (kernel.py:47-53)
__device__ __forceinline__ bool visible(int slot, int cache_len, int W,
                                        int ring, int chunk_start) {
  if (!ring) return slot < cache_len;
  const int qpos = cache_len - 1;
  int back = (qpos - slot) % W;
  if (back < 0) back += W;
  const int abs_pos = qpos - back;
  return abs_pos >= 0 && abs_pos >= chunk_start;
}

// grid (n_splits, Kv, B).  Block (s, kvh, b) folds the visible slots of
// [s * split, (s + 1) * split) for query heads kvh * G .. kvh * G + G - 1.
// NT: n-tiles of 8 columns the accumulator holds (hd <= 8 NT).  kTwin: the
// lse twin (slot0, slots and lse are read only there).
template <int NT, bool kTwin>
__global__ void __launch_bounds__(kThreads)
decode_attention_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ kc,
                           const bf16* __restrict__ vc,
                           const int* __restrict__ cache_len_ptr,
                           float* __restrict__ part_m,
                           float* __restrict__ part_l,
                           float* __restrict__ part_acc, bf16* __restrict__ out,
                           int W, int H, int Kv, int hd, int split,
                           float scale_log2, int ring, int chunk, int slot0,
                           int slots, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = hd + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][ld]
  bf16* ring_base = Qs + kRows * ld;  // stage s: K [kTile][ld], then V

  const int G = H / Kv;
  const int si = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int cache_len = *cache_len_ptr;
  const int qpos = cache_len - 1;
  const int chunk_start = chunk && qpos >= 0 ? (qpos / chunk) * chunk : 0;
  const int base = kTwin ? slot0 : 0;  // global number of local slot 0
  const int width = kTwin ? slots : W;  // the ring's width
  const int lo = si * split;
  int hi = min(lo + split, W);
  // never read a slot past the cache (a slice wholly past it: hi < lo)
  if (!ring) hi = min(hi, cache_len - base);
  const int tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per_row = hd / 8;  // 16-byte pieces of one row

  const bf16* qb = q + (static_cast<size_t>(b) * H + kvh * G) * hd;
  for (int i = tid; i < kRows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < G) v = *reinterpret_cast<const uint4*>(qb + r * hd + c);
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = v;
  }

  const size_t row_stride = static_cast<size_t>(Kv) * hd;
  const bf16* kb = kc + (static_cast<size_t>(b) * W * Kv + kvh) * hd;
  const bf16* vb = vc + (static_cast<size_t>(b) * W * Kv + kvh) * hd;
  auto load_tile = [&](int t) {
    bf16* Ks = ring_base + (t % kStages) * 2 * kTile * ld;
    bf16* Vs = Ks + kTile * ld;
    const int t0 = lo + t * kTile;
    for (int i = tid; i < kTile * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * 8;
      const int slot = t0 + r;
      const bool ok = slot < hi && visible(base + slot, cache_len, width,
                                           ring, chunk_start);
      const size_t off = static_cast<size_t>(ok ? slot : 0) * row_stride + c;
      hopper::cp_async16(Ks + r * ld + c, kb + off, ok ? 16 : 0);
      hopper::cp_async16(Vs + r * ld + c, vb + off, ok ? 16 : 0);
    }
  };

  // thread (g = lane / 4, c4 = lane % 4) holds rows g and g + 8 of every
  // fragment
  const int g = lane / 4, c4 = lane % 4;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const int ksteps = hd / 16;
  // ldmatrix row addresses of this lane (see hopper.cuh: ldmatrix_x4)
  const bf16* q_addr = Qs + (lane % 16) * ld + (lane / 16) * 8;
  const int k_row = warp * 16 + (lane / 16) * 8 + lane % 8;
  const int k_col = ((lane / 8) % 2) * 8;
  const int v_row = warp * 16 + ((lane / 8) % 2) * 8 + lane % 8;
  const int v_col = (lane / 16) * 8;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(s);
    hopper::cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();  // tile t has landed (this thread)
    __syncthreads();  // ... for every thread; tile t - 1 is consumed
    if (t + kStages - 1 < tiles) load_tile(t + kStages - 1);
    hopper::cp_async_commit();  // an empty group keeps the count aligned

    const bf16* Ks = ring_base + (t % kStages) * 2 * kTile * ld;
    const bf16* Vs = Ks + kTile * ld;
    // S = Q K^T over this warp's 16 slots: two n-tiles of 8 slots
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4], bk[4];
        hopper::ldmatrix_x4(a, q_addr + kk * 16);
        hopper::ldmatrix_x4(bk, Ks + k_row * ld + k_col + kk * 16);
        hopper::mma_16816(s[0], a, bk[0], bk[1]);
        hopper::mma_16816(s[1], a, bk[2], bk[3]);
      }
    }
    // mask, and the online softmax of rows g (e < 2) and g + 8 (e >= 2)
    const int slot0 = lo + t * kTile + warp * 16 + 2 * c4;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = slot0 + n * 8 + (e & 1);
        const bool ok = slot < hi && visible(base + slot, cache_len, width,
                                             ring, chunk_start);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
    // p as two bf16 operands, hi = bf16(p) and lo = bf16(p - hi): P V
    // carries p to 16 significant bits
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[n][e] - m_run[e / 2]);  // a masked -inf gives 0
        l_run[e / 2] += p[e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row g, then row g + 8
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * h], p[2 * h + 1]);
        const float2 back = __bfloat1622float2(hi);
        pa[2 * n + h] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[2 * n + h] =
            hopper::pack_bf16(p[2 * h] - back.x, p[2 * h + 1] - back.y);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: P (16 x 16 slots) as the A operand, V^T by ldmatrix.trans
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np < ksteps) {
        uint32_t bv[4];
        hopper::ldmatrix_x4_trans(bv, Vs + v_row * ld + v_col + np * 16);
        hopper::mma_16816(acc[2 * np], pa, bv[0], bv[1]);
        hopper::mma_16816(acc[2 * np + 1], pa, bv[2], bv[3]);
        hopper::mma_16816(acc[2 * np], pl, bv[0], bv[1]);
        hopper::mma_16816(acc[2 * np + 1], pl, bv[2], bv[3]);
      }
    }
  }

  // reduce the four warps' states in shared memory (the ring is free)
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring_base);  // [kWarps][kRows][hd]
  float* red_m = red + kWarps * kRows * hd;          // [kWarps][kRows]
  float* red_l = red_m + kWarps * kRows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  if (c4 == 0) {
    red_m[warp * kRows + g] = m_run[0];
    red_m[warp * kRows + g + 8] = m_run[1];
    red_l[warp * kRows + g] = l_run[0];
    red_l[warp * kRows + g + 8] = l_run[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < 2 * ksteps) {
      float* r0 = red + (warp * kRows + g) * hd + n * 8 + 2 * c4;
      float* r1 = r0 + 8 * hd;
      r0[0] = acc[n][0];
      r0[1] = acc[n][1];
      r1[0] = acc[n][2];
      r1[1] = acc[n][3];
    }
  }
  __syncthreads();

  const size_t head0 = static_cast<size_t>(b) * H + kvh * G;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w * kRows + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(red_m[w * kRows + r] - m);
      l = fmaf(red_l[w * kRows + r], f, l);
      a = fmaf(red[(w * kRows + r) * hd + d], f, a);
    }
    if (n_splits == 1) {
      out[(head0 + r) * hd + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
      if constexpr (kTwin) {
        if (d == 0) lse[head0 + r] = state_lse(m, l);
      }
    } else {
      part_acc[((head0 + r) * n_splits + si) * hd + d] = a;
      if (d == 0) {
        part_m[(head0 + r) * n_splits + si] = m;
        part_l[(head0 + r) * n_splits + si] = l;
      }
    }
  }
}

// grid (B * H): out[b, 0, h] = sum_s 2^(m_s - m) acc_s / sum_s 2^(m_s - m) l_s
// (and the twin's lse[b, h])
template <bool kTwin>
__global__ void __launch_bounds__(kThreads)
decode_tc_combine_kernel(const float* __restrict__ part_m,
                         const float* __restrict__ part_l,
                         const float* __restrict__ part_acc,
                         bf16* __restrict__ out, int n_splits, int hd,
                         float* __restrict__ lse) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_splits;
  const float* pl = part_l + bh * n_splits;
  const float* pa = part_acc + bh * n_splits * hd;
  float m = kNegInf;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, pm[s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = exp2f(pm[s] - m);
      l = fmaf(pl[s], w, l);
      a = fmaf(pa[static_cast<size_t>(s) * hd + d], w, a);
    }
    out[bh * hd + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
    if constexpr (kTwin) {
      if (d == 0) lse[bh] = state_lse(m, l);
    }
  }
}

template <int NT, bool kTwin>
int launch(const bf16* q, const bf16* kc, const bf16* vc, const int* cache_len,
           float* part_m, float* part_l, float* part_acc, bf16* out, int B,
           int W, int H, int Kv, int hd, int split, int n_splits, int ring,
           int chunk, int slot0, int slots, float* lse, cudaStream_t stream) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  auto* fn = decode_attention_tc_kernel<NT, kTwin>;
  cudaError_t err = hopper::allow_smem(fn, smem_bytes(8 * NT), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(hd));
  fn<<<dim3(n_splits, Kv, B), kThreads, smem_bytes(hd), stream>>>(
      q, kc, vc, cache_len, part_m, part_l, part_acc, out, W, H, Kv, hd, split,
      scale_log2, ring, chunk, slot0, slots, lse);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  decode_tc_combine_kernel<kTwin><<<B * H, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, out, n_splits, hd, lse);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTwin>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const int* cache_len, float* part_m, float* part_l,
             float* part_acc, void* out, int B, int W, int H, int Kv, int hd,
             int split, int n_splits, int ring, int chunk, int slot0,
             int slots, float* lse, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const bf16*>(q);
  auto kp = static_cast<const bf16*>(k_cache);
  auto vp = static_cast<const bf16*>(v_cache);
  auto op = static_cast<bf16*>(out);
  if (hd <= 32)
    return launch<4, kTwin>(qp, kp, vp, cache_len, part_m, part_l, part_acc,
                            op, B, W, H, Kv, hd, split, n_splits, ring, chunk,
                            slot0, slots, lse, s);
  if (hd <= 64)
    return launch<8, kTwin>(qp, kp, vp, cache_len, part_m, part_l, part_acc,
                            op, B, W, H, Kv, hd, split, n_splits, ring, chunk,
                            slot0, slots, lse, s);
  if (hd <= 128)
    return launch<16, kTwin>(qp, kp, vp, cache_len, part_m, part_l, part_acc,
                             op, B, W, H, Kv, hd, split, n_splits, ring,
                             chunk, slot0, slots, lse, s);
  return launch<32, kTwin>(qp, kp, vp, cache_len, part_m, part_l, part_acc,
                           op, B, W, H, Kv, hd, split, n_splits, ring, chunk,
                           slot0, slots, lse, s);
}

}  // namespace
}  // namespace repro_torch

extern "C" size_t decode_attention_tc_smem_bytes(int hd) {
  return repro_torch::smem_bytes(hd);
}

// bf16 q (B, 1, H, hd), caches (B, W, Kv, hd), out (B, 1, H, hd); H / Kv <=
// 16, hd a multiple of 16 up to 256, every base 16-byte aligned.  part_*
// (B, H, n_splits[, hd]) fp32 scratch, unused when n_splits == 1.
extern "C" int decode_attention_tc_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const int* cache_len, float* part_m, float* part_l, float* part_acc,
    void* out, int B, int W, int H, int Kv, int hd, int split, int n_splits,
    int ring, int chunk, void* stream) {
  return repro_torch::dispatch<false>(q, k_cache, v_cache, cache_len, part_m,
                                      part_l, part_acc, out, B, W, H, Kv, hd,
                                      split, n_splits, ring, chunk, 0, W,
                                      nullptr, stream);
}

// The lse twin: the caches are global slots slot0 .. slot0 + W - 1 of a
// cache of `slots` slots; lse (B, H) fp32.
extern "C" int decode_attention_tc_lse_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const int* cache_len, float* part_m, float* part_l, float* part_acc,
    void* out, int B, int W, int H, int Kv, int hd, int split, int n_splits,
    int ring, int chunk, int slot0, int slots, float* lse, void* stream) {
  return repro_torch::dispatch<true>(q, k_cache, v_cache, cache_len, part_m,
                                     part_l, part_acc, out, B, W, H, Kv, hd,
                                     split, n_splits, ring, chunk, slot0,
                                     slots, lse, stream);
}
