// The tiled top-k core of the two selection kernels (retrieval_topk.cu and
// dsqe_score.cu): for each (B, d) fp32 query row the exact top-k of
// q . corpus_row over an (n, d) fp32 corpus under (value desc, id asc), for
// every 1 <= k <= n and every width d.  The kernels that use it are defined
// in those two files; retrieval_topk.cu also defines the host launchers of
// the similarity passes that both share (declared at the end).
//
// What bounds it on an H100: 2 B n d fp32 FLOPs on the CUDA cores against
// (B + n) d 4 bytes, so at the deployment shape (B 256, n 16384, d 256) it
// is bound by operations (66.9 TFLOP/s).  It stays in fp32 with no TF32:
// TF32 keeps about three decimal digits and flips kNN membership against
// the fp32 reference.
//
// * Similarity tiles on a register-tiled outer product (tile_loop).  A block
//   of 128 threads (8 x 16) scores 8 MI queries against 128 corpus rows;
//   thread (ty, tx) holds queries MI ty .. MI ty + MI - 1 against corpus
//   rows tx + 16 j, j < 8.  MI is 8 (64-query tiles, 64 accumulators a
//   thread), or 2 where 64-query tiles cannot give every SM a block.  Each
//   4-deep step reads 8 + MI float4 from shared memory for 32 MI FMAs; rows
//   are padded to 36 floats, so the eight lanes of one 128-bit access phase
//   hit eight distinct 4-bank groups.
// * Chunks along d (32 deep) arrive through a two-stage cp.async ring: the
//   next chunk's copy is in flight while the current one is multiplied.
//   Rows copy 16 bytes at a time where d is a multiple of 4 and both bases
//   are 16-byte aligned, else 4 bytes at a time (any d).  Rows past B or past
//   the split, and columns past d, are zero-filled and never read.
// * k <= 64 ("tiled"): the corpus is split across blocks, grid (query tile,
//   corpus split), sized by the wrapper (kernel.py: grid).  Each block keeps
//   a running list per query row in shared memory (R slots, best first, R
//   the power of two >= k, at least 16) and the row's k-th value in a
//   register.  A finished tile is folded in with bitonic networks on half
//   warps (a row's 128 scores are 8 registers of 16 lanes): when more than
//   16 scores beat the k-th value, the tile's best R by sorting runs of R and
//   folding them pairwise, then merged with the list; otherwise the few that
//   beat it are compacted to one register per lane, sorted and merged.
//   Splits share a floor: each row's k-th value, once its list is full, is a
//   lower bound on the k-th value of the whole corpus, so a block publishes
//   it (atomicMax on an order-preserving key in a zeroed (B,) scratch) and
//   every block drops candidates below the largest floor of its query.
//   Candidates equal to the floor are kept: they may still win a tie on id.
//   A merge (merge_body, one block per query) folds the splits' lists; its
//   eight half warps fold a share of the lists each, then each other's.
// * k > 64 ("select"): the same product writes the (B, n) similarity
//   block (retrieval_topk_scores_kernel; the wrapper bounds it by running B
//   in chunks), and one block per query row (select_body) finds the k-th
//   largest order-preserving key by a radix select (four 8-bit passes over
//   the row), keeps the entries above it and the lowest ids among those
//   equal to it (an ordered block-wide count), and sorts the k survivors on
//   one 64-bit key (value key, then the complemented id): a bitonic sort in
//   shared memory while they fit (kSortChunk), else a bitonic sort over a
//   global scratch whose strides below kSortChunk run in shared memory.
// * Either way the top-k is final in one block per query, and an epilogue
//   runs there once per query (WriteTopK writes it; dsqe_score.cu scores
//   the paths).
//
// Why the result is exact, ties included.  Every comparison of every
// network is on the key (value desc, id asc), so a fold or merge gives the
// exact best entries of its inputs under that key whatever order they
// arrive in.  A dropped candidate cannot be in the top-k: it is below a
// floor (a k-th value some split reached), or not above its own list's k-th
// value (then the k entries already held beat it, those of equal value
// having come from earlier tiles, with lower ids).  Empty slots (a split
// shorter than k) carry id -1 and -inf.  The select route's 64-bit key
// orders exactly as (value desc, id asc), with -0 read as +0.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "hopper.cuh"
#include "topk.cuh"  // kFull, kWarp, kNegInf

namespace repro_torch {
namespace {

constexpr int kBN = 128;         // corpus rows per tile
constexpr int kBD = 32;          // floats of d per staged chunk
constexpr int kLd = kBD + 4;     // padded row stride: 144 bytes
constexpr int kThreads = 128;    // 8 x 16 threads, an MI x 8 score tile each
constexpr int kStages = 2;
// A block scores 8 MI query rows (MI = 8, or 2 where the grid is too small
// to fill the card with 64-row tiles) against kBN corpus rows.
template <int MI>
__host__ __device__ constexpr int stage_floats() {
  return (8 * MI + kBN) * kLd;
}
constexpr int kHalves = kThreads / 16;  // half warps of a merge block
constexpr int kBig = 1 << 20;  // a bitonic stage size past every index
constexpr int kBatch = 16;  // candidates a half warp compacts into a register
constexpr int kSelectThreads = 512;  // a select block: one query row
constexpr int kSortChunk = 8192;  // 64-bit keys sorted in shared memory at once

// the chunk ring, the rows' lists of R slots, and each half warp's batch
template <int MI, int R>
size_t tiled_smem_bytes() {
  return sizeof(float) * kStages * stage_floats<MI>() +
         (static_cast<size_t>(8 * MI) * R + kThreads) *
             (sizeof(float) + sizeof(int));
}

// Stage chunk [d0, d0 + kBD) of query rows q0 .. q0 + BQ - 1 and corpus
// rows c0.. in 16-byte copies (rows past B or c_hi, and columns past d, are
// zero-filled, not read).
template <int BQ>
__device__ __forceinline__ void load_rows16(float* stage,
                                            const float* __restrict__ q,
                                            const float* __restrict__ corpus,
                                            int q0, int B, int c0, int c_hi,
                                            int d, int d0) {
  constexpr int kPerRow = kBD / 4;  // 16-byte copies per row
  const int width = min(kBD, d - d0);
  for (int i = threadIdx.x; i < (BQ + kBN) * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const float* src;
    bool ok;
    if (r < BQ) {
      ok = q0 + r < B && c < width;
      src = q + static_cast<size_t>(q0 + r) * d + d0 + c;
    } else {
      const int row = c0 + r - BQ;
      ok = row < c_hi && c < width;
      src = corpus + static_cast<size_t>(row) * d + d0 + c;
    }
    hopper::cp_async16(stage + r * kLd + c, ok ? src : q, ok ? 16 : 0);
  }
}

// The same in 4-byte copies (any d and base): thread t copies column t %
// kBD of every fourth row, so its column, and the step between its rows'
// addresses, are fixed.
template <int BQ>
__device__ __forceinline__ void load_rows4(float* stage,
                                           const float* __restrict__ q,
                                           const float* __restrict__ corpus,
                                           int q0, int B, int c0, int c_hi,
                                           int d, int d0) {
  constexpr int kRowStep = kThreads / kBD;
  static_assert(BQ % kRowStep == 0 && kBN % kRowStep == 0, "rows per pass");
  const int c = threadIdx.x % kBD, r0 = threadIdx.x / kBD;
  const bool in_width = c < min(kBD, d - d0);
  const size_t step = static_cast<size_t>(kRowStep) * d;
  const float* src = q + static_cast<size_t>(q0 + r0) * d + d0 + c;
#pragma unroll
  for (int r = r0; r < BQ; r += kRowStep, src += step) {
    const bool ok = in_width && q0 + r < B;
    hopper::cp_async4(stage + r * kLd + c, ok ? src : q, ok ? 4 : 0);
  }
  src = corpus + static_cast<size_t>(c0 + r0) * d + d0 + c;
#pragma unroll 8
  for (int r = r0; r < kBN; r += kRowStep, src += step) {
    const bool ok = in_width && c0 + r < c_hi;
    hopper::cp_async4(stage + (BQ + r) * kLd + c, ok ? src : q, ok ? 4 : 0);
  }
}

// 16-byte copies where vec4 (d % 4 == 0, 16-byte aligned bases), else
// 4-byte ones
template <int BQ>
__device__ __forceinline__ void load_chunk(float* stage,
                                           const float* __restrict__ q,
                                           const float* __restrict__ corpus,
                                           int q0, int B, int c0, int c_hi,
                                           int d, int d0, bool vec4) {
  if (vec4)
    load_rows16<BQ>(stage, q, corpus, q0, B, c0, c_hi, d, d0);
  else
    load_rows4<BQ>(stage, q, corpus, q0, B, c0, c_hi, d, d0);
}

// acc[i][j] += q row (MI ty + i) . corpus row (tx + 16 j) over the chunk's
// first `width` floats (rounded up to 4: the columns past it are zeros; all
// kBD of them when kWhole)
template <bool kWhole, int MI>
__device__ __forceinline__ void multiply(float (&acc)[MI][8], const float* qs,
                                         const float* cs, int ty, int tx,
                                         int width) {
  const int w = kWhole ? kBD : (width + 3) & ~3;
#pragma unroll 2
  for (int kk = 0; kk < w; kk += 4) {
    float4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(cs + (tx + 16 * j) * kLd + kk);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(qs + (MI * ty + i) * kLd + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = acc[i][j];
        x = fmaf(a.x, b[j].x, x);
        x = fmaf(a.y, b[j].y, x);
        x = fmaf(a.z, b[j].z, x);
        x = fmaf(a.w, b[j].w, x);
        acc[i][j] = x;
      }
    }
  }
}

// Score query rows q0 .. q0 + 8 MI - 1 against corpus tiles from c_lo up to
// c_hi, one tile at a time: when a tile's scores are complete, call
// on_tile(acc, col0) with the tile's first corpus row (every thread of the
// block calls it), then clear acc.  `smem` holds the chunk ring.
template <int MI, typename OnTile>
__device__ __forceinline__ void tile_loop(const float* __restrict__ q,
                                          const float* __restrict__ corpus,
                                          float* smem, int q0, int B,
                                          int c_lo, int c_hi, int d,
                                          bool vec4, OnTile&& on_tile) {
  constexpr int BQ = 8 * MI, kStage = stage_floats<MI>();
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles = (c_hi - c_lo + kBN - 1) / kBN;
  const int chunks = (d + kBD - 1) / kBD;
  const int steps = tiles * chunks;

  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // prologue: steps 0 .. kStages - 2
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_chunk<BQ>(smem + s * kStage, q, corpus, q0, B,
                     c_lo + (s / chunks) * kBN, c_hi, d, (s % chunks) * kBD,
                     vec4);
    hopper::cp_async_commit();
  }

  for (int t = 0; t < steps; ++t) {
    hopper::cp_async_wait<kStages - 2>();  // step t has landed (this thread)
    __syncthreads();  // ... for every thread; step t - 1 is consumed
    const int next = t + kStages - 1;
    if (next < steps)
      load_chunk<BQ>(smem + (next % kStages) * kStage, q, corpus, q0, B,
                     c_lo + (next / chunks) * kBN, c_hi, d,
                     (next % chunks) * kBD, vec4);
    hopper::cp_async_commit();  // an empty group keeps the count aligned

    const float* qs = smem + (t % kStages) * kStage;
    const float* cs = qs + BQ * kLd;
    const int chunk = t % chunks;
    const int width = min(kBD, d - chunk * kBD);
    if (width == kBD)
      multiply<true>(acc, qs, cs, ty, tx, width);
    else
      multiply<false>(acc, qs, cs, ty, tx, width);
    if (chunk != chunks - 1) continue;

    on_tile(acc, c_lo + (t / chunks) * kBN);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

// Shared thresholds: an unsigned key that orders like the float (0 is below
// every float), so atomicMax publishes the largest k-th value seen.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float key_value(unsigned key) {
  if (key == 0u) return -CUDART_INF_F;
  return __uint_as_float((key & 0x80000000u) ? key & 0x7fffffffu : ~key);
}

// -- bitonic networks over the (value, id) pairs a half warp holds --------
// Element e = 16 j + tx lives in register j of lane tx of the half warp.
// Every comparison is on (value desc, id asc), so the networks give the
// exact order of that key whatever order the pairs arrive in.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// One compare-exchange step over registers 0 .. N-1: the pair (e, e ^
// kStride), the lower index taking the better where (e & kSize) == 0 and
// the worse otherwise.  kStride < 16 pairs lanes, kStride >= 16 registers.
template <int N, int kSize, int kStride, int R>
__device__ __forceinline__ void step(float (&v)[R], int (&id)[R], int tx) {
  if constexpr (kStride >= 16) {
    constexpr int rs = kStride / 16;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j & rs) continue;
      const int l = j | rs;
      const bool up = ((16 * j) & kSize) == 0;  // kSize >= 32: j decides
      if (up ? better(v[l], id[l], v[j], id[j])
             : better(v[j], id[j], v[l], id[l])) {
        const float tv = v[j];
        const int ti = id[j];
        v[j] = v[l];
        id[j] = id[l];
        v[l] = tv;
        id[l] = ti;
      }
    }
  } else {
    const bool lower = (tx & kStride) == 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float pv = __shfl_xor_sync(kFull, v[j], kStride);
      const int pi = __shfl_xor_sync(kFull, id[j], kStride);
      const bool up = ((16 * j + tx) & kSize) == 0;
      if (better(pv, pi, v[j], id[j]) == (up == lower)) {
        v[j] = pv;
        id[j] = pi;
      }
    }
  }
}

// Bitonic merge: steps of strides kStride, kStride / 2, ..., 1.  With kSize
// = kBig every run comes out best first.
template <int N, int kSize, int kStride, int R>
__device__ __forceinline__ void merge_steps(float (&v)[R], int (&id)[R],
                                            int tx) {
  step<N, kSize, kStride>(v, id, tx);
  if constexpr (kStride > 1) merge_steps<N, kSize, kStride / 2>(v, id, tx);
}

// Sort registers 0 .. N-1 into runs of kRun, best first and worst first in
// turn (bitonic sort, stage sizes 2 .. kRun).
template <int N, int kRun, int kSize = 2, int R>
__device__ __forceinline__ void sort_runs(float (&v)[R], int (&id)[R],
                                          int tx) {
  merge_steps<N, kSize, kSize / 2>(v, id, tx);
  if constexpr (kSize < kRun) sort_runs<N, kRun, kSize * 2>(v, id, tx);
}

// Fold runs of kRun pairwise until one is left, best first, in registers 0
// .. kRun / 16 - 1.  The better of each pair of elements of a best-first and
// a worst-first run is the best kRun of the two, as a bitonic sequence.
template <int N, int kRun, int R>
__device__ __forceinline__ void fold_runs(float (&v)[R], int (&id)[R],
                                          int tx) {
  constexpr int rr = kRun / 16;
  if constexpr (N > rr) {
    constexpr int M = N / 2;
#pragma unroll
    for (int m = 0; m < M / rr; ++m)
#pragma unroll
      for (int r = 0; r < rr; ++r) {
        const int a = 2 * m * rr + r, b = a + rr;
        const bool t = better(v[b], id[b], v[a], id[a]);
        v[m * rr + r] = t ? v[b] : v[a];
        id[m * rr + r] = t ? id[b] : id[a];
      }
    merge_steps<M, (M == rr ? kBig : kRun), kRun / 2>(v, id, tx);
    fold_runs<M, kRun>(v, id, tx);
  }
}

// -- the running top-k of a query row, folded one tile at a time ----------
// A row's list is R (value, id) pairs in shared memory (R the power of two
// >= k, at least 16), sorted best first; slots k .. R - 1 are runners-up.
// The row's k-th value sits in a register.

// Fold the half warp's 128 candidates (register j: column 16 j + tx) into
// its row's list: the tile's best R (sort runs of R, fold them), then the
// better of each pair of those and the list reversed, merged.
template <int R>
__device__ __forceinline__ void reduce_merge(float (&v)[8], int (&id)[8],
                                             float* sv, int* si, int tx) {
  constexpr int rr = R / 16;
  sort_runs<8, R>(v, id, tx);
  fold_runs<8, R>(v, id, tx);
#pragma unroll
  for (int r = 0; r < rr; ++r) {
    const int back = R - 1 - (16 * r + tx);
    const float hv = sv[back];
    const int hi = si[back];
    if (better(hv, hi, v[r], id[r])) {
      v[r] = hv;
      id[r] = hi;
    }
  }
  merge_steps<rr, kBig, R / 2>(v, id, tx);
  __syncwarp();  // every lane has read the old list
#pragma unroll
  for (int r = 0; r < rr; ++r) {
    sv[16 * r + tx] = v[r];
    si[16 * r + tx] = id[r];
  }
}

// Fold the at most kBatch candidates of the half warp's row that beat its
// k-th value and reach the shared floor into its list: compact them to one
// register per lane (a prefix sum of the lanes' counts over the half
// warp), sort those 16, and merge them with the list (the batch meets the
// list's last 16 slots, reversed).
template <int R>
__device__ __forceinline__ void compact_merge(const float (&acc)[8],
                                              float kth, float floor_v,
                                              int col0, int c_hi, float* sv,
                                              int* si, float* bv, int* bi,
                                              int tx) {
  constexpr int rr = R / 16;
  int count = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    count += col0 + 16 * j + tx < c_hi && acc[j] > kth && acc[j] >= floor_v;
  int end = count;  // inclusive prefix sum over the half warp
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const int t = __shfl_up_sync(kFull, end, o, 16);
    if (tx >= o) end += t;
  }
  int w = end - count;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cid = col0 + 16 * j + tx;
    if (cid < c_hi && acc[j] > kth && acc[j] >= floor_v) {
      bv[w] = acc[j];
      bi[w] = cid;
      ++w;
    }
  }
  const int total = __shfl_sync(kFull, end, 15, 16);
  __syncwarp();
  float c[1] = {tx < total ? bv[tx] : -CUDART_INF_F};
  int ci[1] = {tx < total ? bi[tx] : -1};
  sort_runs<1, 16>(c, ci, tx);  // best first: one run
  float v[rr];
  int id[rr];
#pragma unroll
  for (int r = 0; r < rr; ++r) {
    v[r] = sv[16 * r + tx];
    id[r] = si[16 * r + tx];
  }
  // slot R - 16 + tx meets the batch's element 15 - tx
  const float cv = __shfl_xor_sync(kFull, c[0], 15);
  const int cc = __shfl_xor_sync(kFull, ci[0], 15);
  if (better(cv, cc, v[rr - 1], id[rr - 1])) {
    v[rr - 1] = cv;
    id[rr - 1] = cc;
  }
  merge_steps<rr, kBig, R / 2>(v, id, tx);
  __syncwarp();  // every lane has read the batch
#pragma unroll
  for (int r = 0; r < rr; ++r) {
    sv[16 * r + tx] = v[r];
    si[16 * r + tx] = id[r];
  }
}

// Fold a finished score tile into the lists of warp w's rows 2 MI w .. 2 MI
// w + 2 MI - 1.  Row 2 MI w + MI h + i lives in half warp h, register row i;
// for each j its 16 lanes hold 16 consecutive corpus rows.  A candidate
// counts when it beats the row's own k-th value and reaches the row's
// shared floor (the largest k-th value any split of this call has published
// for that query; `floors` is null with one split).  Rows i of both halves
// go together: when either has more than kBatch candidates (always on the
// first tile a split folds before any floor is known), both reduce the
// whole tile and merge; otherwise both compact their candidates and merge.
// Each row whose list holds k entries then publishes its k-th value.
template <int R, int MI>
__device__ __forceinline__ void select_tile(const float (&acc)[MI][8],
                                            float (&kth)[2 * MI],
                                            float* topv, int* topi,
                                            float* batch_v, int* batch_i,
                                            unsigned* floors, int q0, int B,
                                            int warp, int lane, int col0,
                                            int c_hi, int k) {
  const int tx = lane % 16, half = lane / 16;
  const int my_q = q0 + warp * 2 * MI + lane % (2 * MI);
  const float my_floor = floors && my_q < B
                             ? key_value(*((volatile unsigned*)floors + my_q))
                             : -CUDART_INF_F;  // lane r: row 2 MI w + r
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const float mine = half ? kth[MI + i] : kth[i];
    const float floor_v = __shfl_sync(kFull, my_floor, MI * half + i);
    int above[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned m = __ballot_sync(
          kFull, col0 + 16 * j + tx < c_hi && acc[i][j] > mine &&
                     acc[i][j] >= floor_v);
      above[0] += __popc(m & 0xffffu);
      above[1] += __popc(m >> 16);
    }
    const int most = max(above[0], above[1]);
    if (most == 0) continue;  // warp-uniform
    const int row0 = warp * 2 * MI + i;  // half 0; half 1: row0 + MI
    const int row = row0 + MI * half;
    __syncwarp();
    if (most > kBatch) {
      float v[8];
      int id[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cid = col0 + 16 * j + tx;
        v[j] = cid < c_hi ? acc[i][j] : -CUDART_INF_F;  // past the split:
        id[j] = cid < c_hi ? cid : -1;                  // an empty slot
      }
      reduce_merge<R>(v, id, topv + row * R, topi + row * R, tx);
    } else {
      compact_merge<R>(acc[i], mine, floor_v, col0, c_hi, topv + row * R,
                       topi + row * R,
                       batch_v + 16 * half, batch_i + 16 * half, tx);
    }
    __syncwarp();
    kth[i] = topv[row0 * R + k - 1];
    kth[MI + i] = topv[(row0 + MI) * R + k - 1];
    const float own = half ? kth[MI + i] : kth[i];
    if (floors && tx == 0 && q0 + row < B && own > floor_v)
      atomicMax(floors + q0 + row, order_key(own));
  }
}

// grid (query tiles, splits).  Block (x, s) scores queries 8 MI x .. against
// corpus tiles [s tps, (s + 1) tps) and writes each query's top-k of that
// split to out_v / out_i at [(row * splits + s) * k], best first; with one
// split that is the final (B, k) layout.  R: the power of two >= k, >= 16.
template <int R, int MI>
__global__ void __launch_bounds__(kThreads, 2)
retrieval_topk_tiled_kernel(const float* __restrict__ q,
                            const float* __restrict__ corpus,
                            float* __restrict__ out_v, int* __restrict__ out_i,
                            unsigned* __restrict__ floors, int B, int n,
                            int d, int k, int tps, bool vec4) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BQ = 8 * MI;
  float* topv = smem + kStages * stage_floats<MI>();  // [BQ][R]
  int* topi = reinterpret_cast<int*>(topv + BQ * R);
  float* batch_v = reinterpret_cast<float*>(topi + BQ * R);
  int* batch_i = reinterpret_cast<int*>(batch_v + kThreads);  // 16 a half

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int c_lo = split * tps * kBN;
  const int c_hi = min(c_lo + tps * kBN, n);

  float kth[2 * MI];
#pragma unroll
  for (int r = 0; r < 2 * MI; ++r) {
    const int row = warp * 2 * MI + r;
    for (int slot = lane; slot < R; slot += kWarp) {
      topv[row * R + slot] = -CUDART_INF_F;
      topi[row * R + slot] = -1;
    }
    kth[r] = -CUDART_INF_F;
  }

  // each finished tile is folded into the running lists
  tile_loop<MI>(q, corpus, smem, q0, B, c_lo, c_hi, d, vec4,
                [&](const float (&acc)[MI][8], int col0) {
                  select_tile<R, MI>(acc, kth, topv, topi, batch_v + 32 * warp,
                                     batch_i + 32 * warp, floors, q0, B, warp,
                                     lane, col0, c_hi, k);
                });

  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2 * MI; ++r) {
    const int row = warp * 2 * MI + r;
    if (q0 + row >= B) continue;
    const size_t base =
        (static_cast<size_t>(q0 + row) * n_splits + split) * k;
    for (int slot = lane; slot < k; slot += kWarp) {
      out_v[base + slot] = topv[row * R + slot];
      out_i[base + slot] = topi[row * R + slot];
    }
  }
}

// The select route's product: the same grid as the tiled kernel, each
// block writing its queries' scores against its split's corpus rows to the
// (B, n) block `scores`.
template <int MI>
__global__ void __launch_bounds__(kThreads, 2)
retrieval_topk_scores_kernel(const float* __restrict__ q,
                             const float* __restrict__ corpus,
                             float* __restrict__ scores, int B, int n, int d,
                             int tps, bool vec4) {
  extern __shared__ __align__(16) float smem[];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * 8 * MI;
  const int c_lo = blockIdx.y * tps * kBN;
  const int c_hi = min(c_lo + tps * kBN, n);
  tile_loop<MI>(q, corpus, smem, q0, B, c_lo, c_hi, d, vec4,
                [&](const float (&acc)[MI][8], int col0) {
#pragma unroll
                  for (int i = 0; i < MI; ++i) {
                    const int row = q0 + MI * ty + i;
                    if (row >= B) continue;
                    float* out = scores + static_cast<size_t>(row) * n;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                      const int col = col0 + 16 * j + tx;
                      if (col < c_hi) out[col] = acc[i][j];
                    }
                  }
                });
}

// -- after the top-k is final: one block per query ------------------------

struct Entry {
  float v;
  int id;
};

// Writes the top-k of row `row` to vals / ids (B, k).
struct WriteTopK {
  float* vals;
  int* ids;
  template <typename Get>
  __device__ void operator()(int row, int k, Get get) const {
    for (int s = threadIdx.x; s < k; s += blockDim.x) {
      const Entry e = get(s);
      vals[static_cast<size_t>(row) * k + s] = e.v;
      ids[static_cast<size_t>(row) * k + s] = e.id;
    }
  }
};

// One block of kThreads per query row folds the row's n_lists lists of k
// pairs (each best first): half warp h takes lists h, h + 8, ... one after
// another (the better of each pair of its list and the next list reversed,
// merged), then the eight lists are folded the same way in three rounds.
// The result goes to shared memory, and epi(row, k, get) runs on it.
template <int R, typename Epi>
__device__ __forceinline__ void merge_body(const float* __restrict__ part_v,
                                           const int* __restrict__ part_i,
                                           int n_lists, int k,
                                           const Epi& epi) {
  constexpr int rr = R / 16;
  __shared__ float buf_v[kHalves][R];
  __shared__ int buf_i[kHalves][R];
  const int row = blockIdx.x;
  const int hw = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* pv = part_v + static_cast<size_t>(row) * n_lists * k;
  const int* pi = part_i + static_cast<size_t>(row) * n_lists * k;
  float v[rr];
  int id[rr];
#pragma unroll
  for (int r = 0; r < rr; ++r) {
    const int e = 16 * r + tx;
    const bool in = hw < n_lists && e < k;
    v[r] = in ? pv[hw * k + e] : -CUDART_INF_F;
    id[r] = in ? pi[hw * k + e] : -1;
  }
  // list l reversed, loaded one round ahead of its fold
  auto load_back = [&](int l, float (&lv)[rr], int (&li)[rr]) {
#pragma unroll
    for (int r = 0; r < rr; ++r) {
      const int back = R - 1 - (16 * r + tx);
      const bool in = l < n_lists && back < k;
      lv[r] = in ? pv[static_cast<size_t>(l) * k + back] : -CUDART_INF_F;
      li[r] = in ? pi[static_cast<size_t>(l) * k + back] : -1;
    }
  };
  float nv[rr];
  int ni[rr];
  load_back(kHalves + hw, nv, ni);
  for (int l0 = kHalves; l0 < n_lists; l0 += kHalves) {  // warp-uniform
    float lv[rr];
    int li[rr];
#pragma unroll
    for (int r = 0; r < rr; ++r) {
      lv[r] = nv[r];
      li[r] = ni[r];
    }
    load_back(l0 + kHalves + hw, nv, ni);
#pragma unroll
    for (int r = 0; r < rr; ++r)
      if (better(lv[r], li[r], v[r], id[r])) {
        v[r] = lv[r];
        id[r] = li[r];
      }
    merge_steps<rr, kBig, R / 2>(v, id, tx);
  }
  // both lists of a pair come out the same (the best R of the two), so
  // every half warp folds with its partner and all hold the result
#pragma unroll
  for (int s = 1; s < kHalves; s <<= 1) {
#pragma unroll
    for (int r = 0; r < rr; ++r) {
      buf_v[hw][16 * r + tx] = v[r];
      buf_i[hw][16 * r + tx] = id[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < rr; ++r) {
      const int back = R - 1 - (16 * r + tx);
      const float ov = buf_v[hw ^ s][back];
      const int oi = buf_i[hw ^ s][back];
      if (better(ov, oi, v[r], id[r])) {
        v[r] = ov;
        id[r] = oi;
      }
    }
    merge_steps<rr, kBig, R / 2>(v, id, tx);
    __syncthreads();  // buf is read before the next round writes it
  }
  if (hw == 0) {
#pragma unroll
    for (int r = 0; r < rr; ++r) {
      buf_v[0][16 * r + tx] = v[r];
      buf_i[0][16 * r + tx] = id[r];
    }
  }
  __syncthreads();
  epi(row, k, [&](int s) { return Entry{buf_v[0][s], buf_i[0][s]}; });
}

// -- the select route: radix select, compaction, sort ---------------------
// A 64-bit key orders (value desc, id asc) as a plain descending sort: the
// value's order key above the complemented id.  Key 0 (no float maps to it)
// pads the sort and sinks to its end.
__device__ __forceinline__ unsigned select_key(float f) {
  return order_key(f == 0.f ? 0.f : f);  // -0 ties with +0, as in floats
}
__device__ __forceinline__ unsigned long long pack(unsigned key, int id) {
  return (static_cast<unsigned long long>(key) << 32) |
         (~static_cast<unsigned>(id));
}
__device__ __forceinline__ Entry unpack(unsigned long long e) {
  return Entry{key_value(static_cast<unsigned>(e >> 32)),
               static_cast<int>(~static_cast<unsigned>(e))};
}

// The k-th largest select_key of row[0 .. n) (1 <= k <= n), and how many of
// the entries equal to it the top k takes: four passes, each a histogram of
// the next 8 bits among the entries that match the bits found so far.
__device__ __forceinline__ void radix_select(const float* __restrict__ row,
                                             int n, int k, unsigned* kth_key,
                                             int* take_eq) {
  __shared__ int hist[256];
  __shared__ int found[2];  // digit, rank left within it
  const int tid = threadIdx.x, lane = tid % kWarp;
  unsigned prefix = 0u, mask = 0u;
  int left = k;  // rank of the k-th entry among those matching prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += blockDim.x) {  // block-uniform
      const int i = base + tid;
      const unsigned key = i < n ? select_key(row[i]) : 0u;
      const bool hit = i < n && (key & mask) == prefix;
      const unsigned digit = hit ? (key >> shift) & 0xffu : 256u;
      // lanes with one digit add once: the counts of a pass crowd into a
      // few bins
      const unsigned same = __match_any_sync(kFull, digit);
      if (hit && lane == __ffs(same) - 1)
        atomicAdd(&hist[digit], __popc(same));
    }
    __syncthreads();
    if (tid < kWarp) {  // lane l: bins 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;  // entries in this lane's bins and every higher bin
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      int above = incl - sum;
      if (above < left && left <= incl) {
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= left) {
            found[0] = 255 - 8 * lane - j;
            found[1] = left - above;
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(found[0]) << shift;
    mask |= 0xffu << shift;
    left = found[1];
    __syncthreads();  // found and hist are read before the next pass
  }
  *kth_key = prefix;
  *take_eq = left;
}

// One compare-exchange step of a descending bitonic sort over a[0 .. len):
// pairs (e, e + stride) with e's stride bit clear; `off` is a[0]'s index in
// the whole sequence, whose bit `size` makes a pair ascending.
__device__ __forceinline__ void sort_step(unsigned long long* a, int off,
                                          int len, int size, int stride) {
  for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
    const int e = 2 * t - (t & (stride - 1));
    const unsigned long long x = a[e], y = a[e + stride];
    const bool desc = ((off + e) & size) == 0;
    if ((x < y) == desc) {
      a[e] = y;
      a[e + stride] = x;
    }
  }
  __syncthreads();
}

// Sort buf[0 .. N) descending (N a power of two).  buf is `sm` when N <=
// kSortChunk; otherwise a global scratch, of which `sm` holds one chunk at a
// time: strides below kSortChunk never leave a chunk, so they run there.
__device__ __forceinline__ void sort_desc(unsigned long long* buf, int N,
                                          unsigned long long* sm) {
  if (N <= kSortChunk) {
    for (int size = 2; size <= N; size <<= 1)
      for (int stride = size / 2; stride > 0; stride >>= 1)
        sort_step(buf, 0, N, size, stride);
    return;
  }
  auto in_chunks = [&](int size_lo, int size_hi, int first_stride) {
    for (int c = 0; c < N; c += kSortChunk) {
      for (int i = threadIdx.x; i < kSortChunk; i += blockDim.x)
        sm[i] = buf[c + i];
      __syncthreads();
      for (int size = size_lo; size <= size_hi; size <<= 1)
        for (int stride = min(size / 2, first_stride); stride > 0;
             stride >>= 1)
          sort_step(sm, c, kSortChunk, size, stride);
      for (int i = threadIdx.x; i < kSortChunk; i += blockDim.x)
        buf[c + i] = sm[i];
      __syncthreads();
    }
  };
  in_chunks(2, kSortChunk, kSortChunk / 2);
  for (int size = 2 * kSortChunk; size <= N; size <<= 1) {
    for (int stride = size / 2; stride >= kSortChunk; stride >>= 1)
      sort_step(buf, 0, N, size, stride);
    in_chunks(size, size, kSortChunk / 2);
  }
}

// One block of kSelectThreads per row of the (rows, n) block `scores`: the
// row's top-k, best first, then epi(row0 + row, k, get).  Its keys are
// sorted in dynamic shared memory (sort_n = the power of two >= k entries)
// when sort_n <= kSortChunk, else in spill + row * sort_n (kSortChunk
// entries of dynamic shared memory).
template <typename Epi>
__device__ __forceinline__ void select_body(const float* __restrict__ scores,
                                            unsigned long long* spill, int n,
                                            int k, int sort_n, int row0,
                                            const Epi& epi) {
  extern __shared__ unsigned long long sort_smem[];
  __shared__ int warp_eq[kSelectThreads / kWarp];
  __shared__ int n_above;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const float* row = scores + static_cast<size_t>(blockIdx.x) * n;
  unsigned long long* buf =
      sort_n <= kSortChunk
          ? sort_smem
          : spill + static_cast<size_t>(blockIdx.x) * sort_n;

  unsigned kth;
  int take_eq;
  radix_select(row, n, k, &kth, &take_eq);
  const int n_gt = k - take_eq;  // entries strictly above the k-th key
  if (tid == 0) n_above = 0;
  __syncthreads();
  // entries above kth in any order; those equal to it by ascending id, the
  // first take_eq of them
  int eq_before = 0;
  for (int base = 0; base < n; base += blockDim.x) {  // block-uniform
    const int i = base + tid;
    const unsigned key = i < n ? select_key(row[i]) : 0u;
    if (i < n && key > kth) buf[atomicAdd(&n_above, 1)] = pack(key, i);
    const bool eq = i < n && key == kth;
    const unsigned ballot = __ballot_sync(kFull, eq);
    if (lane == 0) warp_eq[warp] = __popc(ballot);
    __syncthreads();
    int rank = eq_before + __popc(ballot & ((1u << lane) - 1u));
    int total = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (w < warp) rank += warp_eq[w];
      total += warp_eq[w];
    }
    if (eq && rank < take_eq) buf[n_gt + rank] = pack(key, i);
    eq_before += total;
    __syncthreads();  // warp_eq is read before the next round writes it
  }
  for (int i = k + tid; i < sort_n; i += blockDim.x) buf[i] = 0ull;
  __syncthreads();
  sort_desc(buf, sort_n, sort_smem);
  epi(row0 + blockIdx.x, k, [&](int s) { return unpack(buf[s]); });
}

// The power of two >= k, and the dynamic shared memory of a select block.
inline int sort_size(int k) {
  int n = 1;
  while (n < k) n <<= 1;
  return n;
}
inline size_t select_smem_bytes(int sort_n) {
  return sizeof(unsigned long long) *
         static_cast<size_t>(sort_n < kSortChunk ? sort_n : kSortChunk);
}

}  // namespace

// -- host launchers shared by both selection kernels (retrieval_topk.cu) --

// The tiled kernel alone: grid (q_tiles, n_splits) of query_tile (64 or 16)
// rows by tps corpus tiles; each query's top-k of each split to out_v /
// out_i (B, n_splits, k); floors (B,) zeroed where n_splits > 1, else null.
// 1 <= k <= 64.  Returns cudaGetLastError().
int launch_tiled_lists(const float* q, const float* corpus, float* out_v,
                       int* out_i, unsigned* floors, int B, int n, int d,
                       int k, bool vec4, int query_tile, int q_tiles, int tps,
                       int n_splits, cudaStream_t s);

// The select route's product: scores (B, n) on the grid of the tiled
// kernel.  Returns cudaGetLastError().
int launch_scores(const float* q, const float* corpus, float* scores, int B,
                  int n, int d, bool vec4, int query_tile, int tps,
                  int n_splits, cudaStream_t s);

}  // namespace repro_torch
