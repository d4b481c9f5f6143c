// Hopper tensor-core kernel of prefill attention (bf16).
//
// flash_attention_tc_kernel replaces, for bf16 inputs, the Pallas TPU kernel
// flash_attention_kernel (src/repro/kernels/flash_attention/kernel.py:91):
// softmax(q k^T / sqrt(hd)) v with an fp32 online softmax over KV tiles,
// causal / sliding-window / chunked masks, and KV tiles masked whole skipped.
// q (B, Sq, H, hd), k and v (B, Skv, Kv, hd); query head h reads KV head
// h / (H / Kv) in place.  p is rounded to bf16 before the P.V product (the
// TPU kernel's p.astype(v.dtype)) while l sums the unrounded fp32 p, and a
// query row that sees no key is written as 0, all as attention.cu's FFMA
// kernel, which keeps fp32 (see its header for the routing rule).
//
// What bounds it on an H100: causal prefill at the served shapes does
// 4 hd FLOPs per visible (query, key) pair on 3 B S H hd inputs, hundreds of
// FLOPs per byte: bound by operations, the 989 TFLOP/s of bf16 wgmma.  So
// both products run on the tensor cores, their tiles never leave shared
// memory or registers, and the copies run beside them (the FA3 shape):
//
// * One block per (b, h, 128-row query tile): two consumer warpgroups of 64
//   query rows each and one producer warpgroup, of which one thread issues
//   TMA loads.  setmaxnreg moves registers from the producer (24) to the
//   consumers (240): at hd 256 the O accumulator alone is 64 x 256 fp32,
//   128 registers a thread.  The last query tile starts first (causal rows
//   late in the sequence see the most keys).
// * TMA reads q, k and v through 4-D maps (hd, heads, S, B) with 128-byte
//   swizzle, a row as hd / 64 boxes of 64 elements (hd is padded up to a
//   multiple of 64 by zeros past hd: out-of-bounds elements read as 0, and
//   so do rows past Sq or Skv, which the position masks then hide).  Q is
//   loaded once; K and V tiles of BKEYS keys (128 for hd <= 128, 64 above,
//   to fit two stages in shared memory) go through a two-stage ring with
//   full and empty barriers for K and for V apart, so the next K tile
//   lands while the last V tile is still read.  Producer and consumers walk
//   the same list of live tiles: the skip condition is uniform over the
//   block.
// * Per KV tile, in each consumer warpgroup: S = Q K^T by wgmma (M 64,
//   N BKEYS, K hd) from shared memory, K-major on both sides, issued
//   together with O += P V of the previous tile (A = P from registers, B = V
//   from shared memory, MN-major: tnspB = 1); then the scale, the masks
//   (each row sees one interval of keys, tested only on tiles that are not
//   visible whole) and the online softmax on the accumulator fragments in
//   registers, the row max reduced over the 4 threads of a quad; p rounded
//   to bf16 and repacked in registers as wgmma's A operand, and O rescaled.
// * The two consumer warpgroups take turns to issue their products (two
//   named barriers, the "ping-pong" of FA3), so one warpgroup's softmax
//   runs while the other's products hold the tensor cores.
//
// The training variant (LSE = true, a template flag, so the serving
// variant's code is unchanged) also writes lse (B, H, Sq) in fp32: the
// natural log of the sum of exp(scaled score) over the keys a row sees, the
// units of the JAX package's m + log(max(l, 1e-30)) (layers.py:173-175).  The
// softmax state runs in base 2, so lse = m ln 2 + ln l, once per row at the
// end; a row that sees no key gets -1e30.  The backward
// (flash_attention_bwd.cu) recomputes P = exp(S scale - lse) from it.
//
// flash_attention_tc_launch returns cudaGetLastError() after its launch
// (0 on success), or hopper.cuh's tensor-map error codes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr float kNegInf = -1e30f;  // running-max start, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 128;  // query rows per block: two warpgroups of 64
constexpr int kStages = 2;

template <int HDP, int BKEYS>
struct TcFlash {
  static constexpr int NCH = HDP / 64;  // 64-element boxes per row
  static constexpr int kQBytes = NCH * kBQ * 128;
  static constexpr int kKVBytes = NCH * BKEYS * 128;  // one K or V tile
  static constexpr int kSmem =
      kQBytes + kStages * 2 * kKVBytes + (1 + 4 * kStages) * 8 + 1024;
};

struct Masks {
  int Sq, Skv, causal, window, chunk;

  // may any query in [q_lo, q_hi] see any key in [k_lo, k_hi]
  // (kernel.py:39-51)
  __device__ bool live(int q_lo, int q_hi, int k_lo, int k_hi) const {
    bool ok = true;
    if (causal) ok = ok && k_lo <= q_hi;
    if (window) ok = ok && q_lo - k_hi < window;
    if (chunk)
      ok = ok && q_lo / chunk <= k_hi / chunk && k_lo / chunk <= q_hi / chunk;
    return ok;
  }
  // does every query in [q_lo, q_hi] see every key in [k_lo, k_hi]
  __device__ bool whole(int q_lo, int q_hi, int k_lo, int k_hi) const {
    bool ok = k_hi < Skv;
    if (causal) ok = ok && k_hi <= q_lo;
    if (window) ok = ok && q_hi - k_lo < window;
    if (chunk)
      ok = ok && q_lo / chunk == q_hi / chunk && k_lo / chunk == k_hi / chunk &&
           q_lo / chunk == k_lo / chunk;
    return ok;
  }
  // the keys query qpos sees form one interval [lo, hi] (empty if hi < lo)
  __device__ void keys_of(int qpos, int& lo, int& hi) const {
    lo = 0;
    hi = causal ? min(qpos, Skv - 1) : Skv - 1;
    if (window) lo = max(lo, qpos - window + 1);
    if (chunk) {
      const int c0 = qpos / chunk * chunk;
      lo = max(lo, c0);
      hi = min(hi, c0 + chunk - 1);
    }
  }
};

// grid (ceil(Sq / 128), H, B), 384 threads: warpgroups 0 and 1 consume,
// warpgroup 2 produces.  lse is written only when LSE.
template <int HDP, int BKEYS, bool LSE>
__global__ void __launch_bounds__(384, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int H, int Kv, int hd,
                          float scale_log2, Masks mk) {
  using Cfg = TcFlash<HDP, BKEYS>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* KVs = Qs + Cfg::kQBytes;  // stage s: K at 2 s, V at 2 s + 1
  uint64_t* q_full = reinterpret_cast<uint64_t*>(KVs + kStages * 2 *
                                                 Cfg::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int q_lo = qt * kBQ;
  const int q_hi = min(q_lo + kBQ, mk.Sq) - 1;
  const int n_kv = (mk.Skv + BKEYS - 1) / BKEYS;
  const int wg = threadIdx.x / 128;
  auto live = [&](int kt) {
    return mk.live(q_lo, q_hi, kt * BKEYS, min((kt + 1) * BKEYS, mk.Skv) - 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // lane 0 of every consumer warp
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Cfg::kQBytes);
#pragma unroll
      for (int c = 0; c < Cfg::NCH; ++c)
        tma_load_4d(Qs + c * kBQ * 128, &qmap, q_full, 64 * c, h, q_lo, b);
      int i = 0;
      for (int kt = 0; kt < n_kv; ++kt) {
        if (!live(kt)) continue;
        const int s = i % kStages, r = i / kStages;
        uint8_t* ks = KVs + (2 * s) * Cfg::kKVBytes;
        uint8_t* vs = ks + Cfg::kKVBytes;
        if (r > 0) mbar_wait(&k_empty[s], (r - 1) & 1);
        mbar_expect_tx(&k_full[s], Cfg::kKVBytes);
#pragma unroll
        for (int c = 0; c < Cfg::NCH; ++c)
          tma_load_4d(ks + c * BKEYS * 128, &kmap, &k_full[s], 64 * c, kvh,
                      kt * BKEYS, b);
        if (r > 0) mbar_wait(&v_empty[s], (r - 1) & 1);
        mbar_expect_tx(&v_full[s], Cfg::kKVBytes);
#pragma unroll
        for (int c = 0; c < Cfg::NCH; ++c)
          tma_load_4d(vs + c * BKEYS * 128, &vmap, &v_full[s], 64 * c, kvh,
                      kt * BKEYS, b);
        ++i;
      }
    }
  } else {  // consumer warpgroup wg: query rows q_lo + 64 wg .. + 63
    regs_inc<240>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int wq_lo = q_lo + 64 * wg;
    const int row0 = wq_lo + 16 * warp + lane / 4;  // and row0 + 8
    int key_lo[2], key_hi[2];
    mk.keys_of(row0, key_lo[0], key_hi[0]);
    mk.keys_of(row0 + 8, key_lo[1], key_hi[1]);
    int n_live = 0;
    for (int kt = 0; kt < n_kv; ++kt) n_live += live(kt);

    float o[HDP / 2];
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) o[j] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    uint32_t pa[BKEYS / 16][4];  // the previous tile's p, as wgmma's A
    // Ping-pong: the warpgroups take turns to issue their products (named
    // barrier 1 + wg is "wg's turn"), so one's softmax runs while the
    // other's products hold the tensor cores.  Warpgroup 0 goes first.
    if (wg == 1 && n_live > 0) named_arrive(1, 256);
    mbar_wait(q_full, 0);

    int i = 0, prev_s = 0;
    uint32_t prev_ph = 0;
    for (int kt = 0; kt < n_kv; ++kt) {
      if (!live(kt)) continue;
      const int k_lo = kt * BKEYS;
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint8_t* ks = KVs + (2 * s) * Cfg::kKVBytes;

      // S = Q K^T of this tile, and O += P V of the previous one
      float sc[BKEYS / 2];
      mbar_wait(&k_full[s], ph);
      if (i > 0) mbar_wait(&v_full[prev_s], prev_ph);
      named_sync(1 + wg, 256);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < Cfg::NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<0>(sc,
                    sw128_desc(Qs + c * kBQ * 128 + wg * 64 * 128 + kk * 32,
                               16, 1024),
                    sw128_desc(ks + c * BKEYS * 128 + kk * 32, 16, 1024),
                    (c | kk) != 0);
      if (i > 0) {
        const uint8_t* vs = KVs + (2 * prev_s + 1) * Cfg::kKVBytes;
#pragma unroll
        for (int kk = 0; kk < BKEYS / 16; ++kk)
          mma_rs<1>(o, pa[kk],
                    sw128_desc(vs + kk * 16 * 128, BKEYS * 128, 1024), 1);
      }
      wgmma_commit();
      if (wg == 0 || i + 1 < n_live) named_arrive(2 - wg, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(o);
      if (lane == 0) {
        mbar_arrive(&k_empty[s]);
        if (i > 0) mbar_arrive(&v_empty[prev_s]);
      }

      // scale, mask and the online softmax, in base 2
      const bool whole = mk.whole(wq_lo, wq_lo + 63, k_lo, k_lo + BKEYS - 1);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BKEYS / 2; ++j) {
        const int hr = (j / 2) % 2;
        float x = sc[j] * scale_log2;
        if (!whole) {
          const int kpos = k_lo + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
          if (kpos < key_lo[hr] || kpos > key_hi[hr]) x = -INFINITY;
        }
        sc[j] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        alpha[hr] = exp2f(m[hr] - mx[hr]);
        m[hr] = mx[hr];
        l[hr] *= alpha[hr];
      }
#pragma unroll
      for (int j = 0; j < BKEYS / 2; j += 2) {
        const int hr = (j / 2) % 2;
        const float p0 = exp2f(sc[j] - m[hr]);  // masked: exp2(-inf) = 0
        const float p1 = exp2f(sc[j + 1] - m[hr]);
        l[hr] += p0 + p1;  // this thread's columns; the quad sums at the end
        // columns 16 kk .. 16 kk + 15 are accumulator entries 8 kk .. 8 kk + 7
        pa[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) o[j] *= alpha[(j / 2) % 2];
      prev_s = s;
      prev_ph = ph;
      ++i;
    }
    if (i > 0) {  // O += P V of the last tile
      const uint8_t* vs = KVs + (2 * prev_s + 1) * Cfg::kKVBytes;
      mbar_wait(&v_full[prev_s], prev_ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKEYS / 16; ++kk)
        mma_rs<1>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, BKEYS * 128, 1024),
                  1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    const int Sq = mk.Sq;
    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      inv[hr] = 1.f / fmaxf(l[hr], 1e-30f);  // no visible key: o = 0
    }
    if constexpr (LSE) {
      if (lane % 4 == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = row0 + 8 * hr;
          if (row < Sq)
            lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
                l[hr] > 0.f ? m[hr] * kLn2 + logf(l[hr]) : kNegInf;
        }
      }
    }
    const size_t q_stride = static_cast<size_t>(H) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col >= hd) continue;  // hd % 16 == 0: col + 1 < hd as well
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              out + (static_cast<size_t>(b) * Sq + row) * q_stride +
              static_cast<size_t>(h) * hd + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * hr] * inv[hr],
                                    o[4 * j + 2 * hr + 1] * inv[hr]);
      }
    }
  }
}

template <int HDP, int BKEYS, bool LSE>
int launch_flash_tc(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int Sq, int Skv, int H, int Kv, int hd,
                    int causal, int window, int chunk, cudaStream_t stream) {
  using Cfg = TcFlash<HDP, BKEYS>;
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  using hopper::attention_map;
  CUtensorMap qmap, kmap, vmap;
  int err = attention_map(&qmap, q, B, Sq, H, hd, kBQ);
  if (!err) err = attention_map(&kmap, k, B, Skv, Kv, hd, BKEYS);
  if (!err) err = attention_map(&vmap, v, B, Skv, Kv, hd, BKEYS);
  if (err) return err;
  auto* fn = flash_attention_tc_kernel<HDP, BKEYS, LSE>;
  const cudaError_t serr = hopper::allow_smem(fn, Cfg::kSmem, ready);
  if (serr != cudaSuccess) return static_cast<int>(serr);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(hd));
  fn<<<grid, 384, Cfg::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, H, Kv, hd,
      scale_log2, Masks{Sq, Skv, causal, window, chunk});
  return static_cast<int>(cudaGetLastError());
}

template <bool LSE>
int dispatch_flash_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Sq, int Skv, int H, int Kv,
                      int hd, int causal, int window, int chunk,
                      cudaStream_t s) {
  const int hdp = (hd + 63) / 64 * 64;
  if (hdp == 64)
    return launch_flash_tc<64, 128, LSE>(q, k, v, out, lse, B, Sq, Skv, H, Kv,
                                         hd, causal, window, chunk, s);
  if (hdp == 128)
    return launch_flash_tc<128, 128, LSE>(q, k, v, out, lse, B, Sq, Skv, H,
                                          Kv, hd, causal, window, chunk, s);
  if (hdp == 192)
    return launch_flash_tc<192, 64, LSE>(q, k, v, out, lse, B, Sq, Skv, H, Kv,
                                         hd, causal, window, chunk, s);
  return launch_flash_tc<256, 64, LSE>(q, k, v, out, lse, B, Sq, Skv, H, Kv,
                                       hd, causal, window, chunk, s);
}

}  // namespace
}  // namespace repro_torch

// bf16 q, k, v and out; hd a multiple of 16 up to 256 (the caller's route).
// lse: null for the serving variant, else (B, H, Sq) fp32 (the training
// variant).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, float* lse,
                                         int B, int Sq, int Skv, int H, int Kv,
                                         int hd, int causal, int window,
                                         int chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (lse)
    return repro_torch::dispatch_flash_tc<true>(
        q, k, v, out, lse, B, Sq, Skv, H, Kv, hd, causal, window, chunk, s);
  return repro_torch::dispatch_flash_tc<false>(
      q, k, v, out, nullptr, B, Sq, Skv, H, Kv, hd, causal, window, chunk, s);
}
