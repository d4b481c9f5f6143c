// Hopper kernels of language-model serving: prefill and decode attention.
//
// flash_attention replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:91): the prefill forward of
// softmax(q k^T / sqrt(hd)) v with an fp32 online softmax over KV tiles,
// causal / sliding-window / chunked masks, and KV tiles that are masked whole
// skipped.  q (B, Sq, H, hd), k and v (B, Skv, Kv, hd), in the model's layout;
// query head h reads KV head h / (H / Kv), so the GQA repeat of the TPU
// wrapper (ops.py:42-44) is never materialised.  The TPU grid's sequential KV
// axis, which carried acc/m/l in VMEM scratch, is a loop inside one block;
// each block owns one (b, h, 64-row query tile).  Ragged Sq and Skv are
// masked by bounds: nothing is padded to 128 lanes or to the tile.  A query
// row with no visible key at all keeps l = 0 and is written as 0 (the TPU
// kernel's tile skip does the same; attention_ref would average v there).
// The causal path never has such a row.
//
// decode_attention replaces the Pallas TPU kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/kernel.py:77): one new token per
// sequence against a KV cache (B, W, Kv, hd), optionally a ring of width W.
// The TPU kernel walks W sequentially for each (b, kv head); at the served
// shape that is B * Kv = 64 programs, half of the 132 SMs.  Here W is split
// across blocks (flash-decoding): each block folds its span of slots into a
// partial (m, l, acc) for the G query heads of its KV head, and a second
// kernel combines the partials.  cache_len is read from device memory, as the
// TPU kernel takes it by scalar prefetch, so a decode loop needs no host sync.
// A dense cache never reads a slot at or past cache_len.  A ring slot j holds
// absolute position qpos - ((qpos - j) mod W) and is visible when that is
// >= 0 (and >= the chunk start for chunked attention), as kernel.py:47-53.
//
// Both compute scores, softmax and the P.V sum in fp32, round p to the
// input type before the P.V product (the TPU kernels' p.astype(v.dtype)),
// and write the input type.  head_dim is a multiple of 16 up to 256.
//
// What bounds them on an H100: causal prefill at the served shapes does
// 4 hd FLOPs per visible (query, key) pair on 3 B S H hd inputs, far above
// the card's ~295 FLOP/byte ridge: bound by operations.  Decode reads the
// whole live cache once for 4 G FLOPs per element pair: bound by bytes.
//
// Prefill has two variants, chosen by one rule on dtype (kernels/
// flash_attention/kernel.py: route):
// * bf16 (every served model) goes to flash_attention_tc_kernel in
//   flash_attention_tc.cu: wgmma on the tensor cores, K and V tiles fed by
//   TMA through an mbarrier ring, the online softmax in registers.  TMA
//   needs 16-byte global strides, which head_dim % 16 == 0 gives in bf16.
// * fp32 stays here, on flash_attention_kernel, the first port's FFMA
//   design: fp32 tiles of Q, K and V in shared memory (odd row stride, no
//   bank conflicts), a 4 x 4 register tile of scores per thread over 16 x 16
//   threads, p written to shared memory for the P.V sum, and the output
//   accumulator in registers; 66.9 TFLOP/s peak on the CUDA cores.
// Decode has two variants, chosen by one rule on dtype and group size
// (kernels/decode_attention/kernel.py: route): bf16 with G <= 16 goes to
// decode_attention_tc_kernel in decode_attention_tc.cu (bf16 tiles through
// a cp.async ring, mma.sync); the rest (fp32) stays here, on
// decode_partial_kernel + decode_combine_kernel, which stage 64-slot K and
// V tiles through shared memory as fp32 with 16-byte loads, with W split to
// about 8 blocks per SM.
//
// The prefill kernel's training variant (LSE = true, a template flag) also
// writes lse (B, H, Sq) in fp32, m + log(l) of the scaled scores (the JAX
// package's units, layers.py:173-175; -1e30 for a row that sees no key),
// for the backward in flash_attention_bwd.cu.
//
// Each launcher returns cudaGetLastError() after its launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr float kNegInf = -1e30f;  // running-max start, as the TPU kernels
constexpr int kWarp = 32;

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
// p as the P.V product sees it: rounded to the input type
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 16 bytes of T from 16-byte aligned global memory into fp32 registers.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst);
template <>
__device__ __forceinline__ void load16<float>(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* src,
                                                      float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
}

// rows [row0, row0 + rows) of hd elements, row r at base + r * row_stride,
// into dst[r][0..hd) (leading dimension ld) as fp32; rows at or past `valid`
// are written as zeros and not read.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          size_t row_stride, int row0,
                                          int valid, int rows, int hd) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = hd / V;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * V;
    float x[V];
    if (r < valid) {
      load16(base + static_cast<size_t>(row0 + r) * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * ld + c + e] = x[e];
  }
}

// reductions over the 16 lanes of a half warp
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// prefill: flash attention
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per KV tile
constexpr int kFlashThreads = 256;  // 16 x 16 threads, 4 x 4 scores each

size_t flash_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (hd + 1) +
                          kBQ * (kBK + 1));
}

// MAXJ = hd / 16 rounded up to a power of two: each thread keeps 4 rows x
// MAXJ columns (stride 16) of the output accumulator in registers.
template <typename T, int MAXJ, bool LSE>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq,
                       int Skv, int H, int Kv, int hd, float scale, int causal,
                       int window, int chunk) {
  extern __shared__ float smem[];
  const int ld = hd + 1;  // odd stride: column reads hit distinct banks
  float* Qs = smem;                // [kBQ][ld]
  float* KVs = Qs + kBQ * ld;      // [kBK][ld]: K, then V of the same tile
  float* Ps = KVs + kBK * ld;      // [kBQ][kBK + 1]
  constexpr int ldp = kBK + 1;

  // the last query tiles see the most keys under a causal mask: start them
  // first so the short ones fill the tail
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int q_lo = qt * kBQ;
  const int q_hi = min(q_lo + kBQ, Sq) - 1;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nj = hd / 16;

  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * hd;
  const T* kb = k + (static_cast<size_t>(b) * Skv * Kv + kvh) * hd;
  const T* vb = v + (static_cast<size_t>(b) * Skv * Kv + kvh) * hd;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(Kv) * hd;
  load_tile(Qs, ld, qb, q_stride, q_lo, Sq - q_lo, kBQ, hd);

  float m[4], l[4], acc[4][MAXJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[r][j] = 0.f;
  }

  const int n_kv = (Skv + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * kBK;
    const int k_hi = min(k_lo + kBK, Skv) - 1;
    // tile skip (kernel.py:39-51); the condition is uniform over the block
    bool live = true;
    if (causal) live = live && k_lo <= q_hi;
    if (window) live = live && q_lo - k_hi < window;
    if (chunk)
      live = live && q_lo / chunk <= k_hi / chunk && k_lo / chunk <= q_hi / chunk;
    if (!live) continue;

    __syncthreads();  // the previous tile's V is no longer read
    load_tile(KVs, ld, kb, kv_stride, k_lo, Skv - k_lo, kBK, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = KVs[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_lo + ty * 4 + r;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k_lo + tx + 16 * c;
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window) ok = ok && qpos - kpos < window;
        if (chunk) ok = ok && qpos / chunk == kpos / chunk;
        vis[c] = ok;
        s[r][c] *= scale;
        if (ok) mx = fmaxf(mx, s[r][c]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = vis[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        Ps[(ty * 4 + r) * ldp + tx + 16 * c] = round_to<T>(p);
      }
      sum = half_warp_sum(sum);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) acc[r][j] *= alpha;
    }

    __syncthreads();  // K is no longer read; P is complete
    load_tile(KVs, ld, vb, kv_stride, k_lo, Skv - k_lo, kBK, hd);
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(ty * 4 + r) * ldp + c];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nj) {
          const float vv = KVs[c * ld + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(p[r], vv, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q_lo + ty * 4 + r;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if constexpr (LSE) {
      if (tx == 0)
        lse[(static_cast<size_t>(b) * H + h) * Sq + qpos] =
            l[r] > 0.f ? m[r] + logf(l[r]) : kNegInf;
    }
    T* o = out + (static_cast<size_t>(b) * Sq + qpos) * q_stride +
           static_cast<size_t>(h) * hd;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) o[tx + 16 * j] = from_f<T>(acc[r][j] * inv);
  }
}

template <typename T, int MAXJ, bool LSE>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Sq, int Skv, int H, int Kv, int hd,
                 int causal, int window, int chunk, cudaStream_t stream) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  auto* fn = flash_attention_kernel<T, MAXJ, LSE>;
  const size_t smem = flash_smem_bytes(hd);
  cudaError_t err =
      hopper::allow_smem(fn, flash_smem_bytes(16 * MAXJ), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  fn<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H, Kv, hd,
      1.f / sqrtf(static_cast<float>(hd)), causal, window, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LSE>
int dispatch_flash_hd(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int Kv, int hd,
                   int causal, int window, int chunk, cudaStream_t stream) {
  const int nj = hd / 16;
#define REPRO_FLASH(MAXJ)                                                  \
  return launch_flash<T, MAXJ, LSE>(q, k, v, out, lse, B, Sq, Skv, H, Kv, \
                                    hd, causal, window, chunk, stream)
  if (nj <= 1) REPRO_FLASH(1);
  if (nj <= 2) REPRO_FLASH(2);
  if (nj <= 4) REPRO_FLASH(4);
  if (nj <= 8) REPRO_FLASH(8);
  REPRO_FLASH(16);
#undef REPRO_FLASH
}

template <typename T>
int dispatch_flash(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int Kv, int hd,
                   int causal, int window, int chunk, cudaStream_t stream) {
  if (lse)
    return dispatch_flash_hd<T, true>(q, k, v, out, lse, B, Sq, Skv, H, Kv,
                                      hd, causal, window, chunk, stream);
  return dispatch_flash_hd<T, false>(q, k, v, out, nullptr, B, Sq, Skv, H,
                                     Kv, hd, causal, window, chunk, stream);
}

// ---------------------------------------------------------------------------
// decode: split-W partials, then a combine
// ---------------------------------------------------------------------------

constexpr int kTK = 64;  // cache slots per tile
constexpr int kDecodeThreads = 128;

size_t decode_smem_bytes(int hd, int G) {
  return sizeof(float) * (2 * static_cast<size_t>(kTK) * (hd + 1) +
                          2 * static_cast<size_t>(G) * hd + G * kTK + 3 * G);
}

// grid (n_splits, Kv, B).  Block (s, kvh, b) folds slots
// [s * split, (s + 1) * split) of sequence b into (m, l, acc) for the G query
// heads kvh * G .. kvh * G + G - 1, written to part_* at [b, head, s].
// kTwin: the lse twin, on a slice of a cache sharded along its slots (the
// local slots are global slots slot0 .. slot0 + W - 1 of `slots`; the mask
// reads global slot numbers), as in decode_attention_tc.cu.
template <typename T, bool kTwin>
__global__ void __launch_bounds__(kDecodeThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc,
                      const int* __restrict__ cache_len_ptr,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int W, int H, int Kv,
                      int hd, int split, float scale, int ring, int chunk,
                      int slot0, int slots) {
  extern __shared__ float smem[];
  const int G = H / Kv;
  const int ld = hd + 1;
  float* Ks = smem;             // [kTK][ld]
  float* Vs = Ks + kTK * ld;    // [kTK][ld]
  float* Qs = Vs + kTK * ld;    // [G][hd]
  float* Ss = Qs + G * hd;      // [G][kTK]: scores, then p
  float* As = Ss + G * kTK;     // [G][hd]: running P.V sum
  float* Ms = As + G * hd;      // [G]: running max
  float* Ls = Ms + G;           // [G]: running sum of p
  float* Al = Ls + G;           // [G]: this tile's rescale of the old state

  const int si = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int cache_len = *cache_len_ptr;
  const int qpos = cache_len - 1;
  const int base = kTwin ? slot0 : 0;  // global number of local slot 0
  const int width = kTwin ? slots : W;  // the ring's width
  const int lo = si * split;
  int hi = min(lo + split, W);
  // never read a slot past the cache (a slice wholly past it: hi < lo)
  if (!ring) hi = min(hi, cache_len - base);

  const T* qb = q + (static_cast<size_t>(b) * H + kvh * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    Qs[i] = to_f(qb[i]);
    As[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  const T* kb = kc + (static_cast<size_t>(b) * W * Kv + kvh) * hd;
  const T* vb = vc + (static_cast<size_t>(b) * W * Kv + kvh) * hd;
  const size_t stride = static_cast<size_t>(Kv) * hd;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int chunk_start = chunk ? (qpos / chunk) * chunk : 0;

  for (int t0 = lo; t0 < hi; t0 += kTK) {
    const int n = min(kTK, hi - t0);
    __syncthreads();  // the previous tile is no longer read
    load_tile(Ks, ld, kb, stride, t0, n, kTK, hd);
    load_tile(Vs, ld, vb, stride, t0, n, kTK, hd);
    __syncthreads();

    for (int i = threadIdx.x; i < G * kTK; i += blockDim.x) {
      const int g = i / kTK, j = i % kTK, slot = t0 + j;
      bool ok = j < n;
      if (ring) {
        const int gslot = base + slot;
        const int abs_pos =
            qpos - (((qpos - gslot) % width) + width) % width;
        ok = ok && abs_pos >= 0;
        if (chunk) ok = ok && abs_pos >= chunk_start;
      }
      float s = -INFINITY;  // masked
      if (ok) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(Qs[g * hd + d], Ks[j * ld + d], dot);
        s = dot * scale;
      }
      Ss[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kDecodeThreads / kWarp) {
      float mx = kNegInf;
      for (int j = lane; j < kTK; j += kWarp) mx = fmaxf(mx, Ss[g * kTK + j]);
      mx = warp_max(mx);
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTK; j += kWarp) {
        const float s = Ss[g * kTK + j];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        sum += p;
        Ss[g * kTK + j] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Al[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
      const int g = i / hd, d = i % hd;
      float a = As[i] * Al[g];
      for (int j = 0; j < n; ++j) a = fmaf(Ss[g * kTK + j], Vs[j * ld + d], a);
      As[i] = a;
    }
  }
  __syncthreads();

  const size_t head0 = static_cast<size_t>(b) * H + kvh * G;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    part_acc[((head0 + g) * n_splits + si) * hd + d] = As[i];
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    part_m[(head0 + g) * n_splits + si] = Ms[g];
    part_l[(head0 + g) * n_splits + si] = Ls[g];
  }
}

// grid (B * H): out[b, 0, h] = sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s
// (the twin also writes lse[b, h] = m + ln sum_s e^(m_s - m) l_s, kNegInf
// where no slot was visible)
template <typename T, bool kTwin>
__global__ void __launch_bounds__(kDecodeThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int n_splits, int hd, float* __restrict__ lse) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_splits;
  const float* pl = part_l + bh * n_splits;
  const float* pa = part_acc + bh * n_splits * hd;
  float m = kNegInf;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, pm[s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(pm[s] - m);
      l = fmaf(pl[s], w, l);
      a = fmaf(pa[static_cast<size_t>(s) * hd + d], w, a);
    }
    out[bh * hd + d] = from_f<T>(a / fmaxf(l, 1e-30f));
    if constexpr (kTwin) {
      if (d == 0) lse[bh] = l > 0.f ? m + logf(l) : kNegInf;
    }
  }
}

template <typename T, bool kTwin>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const int* cache_len, float* part_m, float* part_l,
                  float* part_acc, void* out, int B, int W, int H, int Kv,
                  int hd, int split, int n_splits, int ring, int chunk,
                  int slot0, int slots, float* lse, cudaStream_t stream) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  auto* fn = decode_partial_kernel<T, kTwin>;
  const size_t smem = decode_smem_bytes(hd, H / Kv);
  cudaError_t err = hopper::allow_smem(fn, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3(n_splits, Kv, B), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), cache_len, part_m, part_l, part_acc, W, H,
      Kv, hd, split, 1.f / sqrtf(static_cast<float>(hd)), ring, chunk, slot0,
      slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, kTwin><<<B * H, kDecodeThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_splits, hd, lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (the same for every tensor of a call).
// flash_attention_launch's lse: null for the serving variant, else (B, H,
// Sq) fp32 (the training variant).

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int dtype, int B, int Sq, int Skv, int H,
                                      int Kv, int hd, int causal, int window,
                                      int chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::dispatch_flash<float>(q, k, v, out, lse, B, Sq, Skv,
                                              H, Kv, hd, causal, window, chunk,
                                              s);
  return repro_torch::dispatch_flash<__nv_bfloat16>(
      q, k, v, out, lse, B, Sq, Skv, H, Kv, hd, causal, window, chunk, s);
}

extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const int* cache_len, float* part_m,
                                       float* part_l, float* part_acc,
                                       void* out, int dtype, int B, int W,
                                       int H, int Kv, int hd, int split,
                                       int n_splits, int ring, int chunk,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_decode<float, false>(
        q, k_cache, v_cache, cache_len, part_m, part_l, part_acc, out, B, W,
        H, Kv, hd, split, n_splits, ring, chunk, 0, W, nullptr, s);
  return repro_torch::launch_decode<__nv_bfloat16, false>(
      q, k_cache, v_cache, cache_len, part_m, part_l, part_acc, out, B, W, H,
      Kv, hd, split, n_splits, ring, chunk, 0, W, nullptr, s);
}

// decode_attention_launch's lse twin: the caches are global slots slot0 ..
// slot0 + W - 1 of a cache of `slots` slots; lse (B, H) fp32.
extern "C" int decode_attention_lse_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const int* cache_len, float* part_m, float* part_l, float* part_acc,
    void* out, int dtype, int B, int W, int H, int Kv, int hd, int split,
    int n_splits, int ring, int chunk, int slot0, int slots, float* lse,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_decode<float, true>(
        q, k_cache, v_cache, cache_len, part_m, part_l, part_acc, out, B, W,
        H, Kv, hd, split, n_splits, ring, chunk, slot0, slots, lse, s);
  return repro_torch::launch_decode<__nv_bfloat16, true>(
      q, k_cache, v_cache, cache_len, part_m, part_l, part_acc, out, B, W, H,
      Kv, hd, split, n_splits, ring, chunk, slot0, slots, lse, s);
}
