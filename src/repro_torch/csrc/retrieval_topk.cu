// Tiled retrieval top-k for Hopper: the route of every retrieval_topk call
// whose width d is a multiple of 4 (kernels/retrieval_topk/kernel.py:
// route); the warp-per-row kernel of selection.cu takes the rest.
//
// Replaces the Pallas TPU kernel retrieval_topk_kernel
// (src/repro/kernels/retrieval_topk/kernel.py:87): for each (B, d) fp32
// query row the descending top-k of q . corpus_row over an (n, d) fp32
// corpus, k <= 64, exact ties to the lowest id.
//
// What bounds it on an H100: 2 B n d fp32 FLOPs on the CUDA cores against
// (B + n) d 4 bytes, so at the deployment shape (B 256, n 16384, d 256) it
// is bound by operations (66.9 TFLOP/s).  It stays in fp32 with no TF32:
// TF32 keeps about three decimal digits and flips kNN membership against
// the fp32 reference.  The warp-per-row kernel lost its time to the grid
// (B / 4 blocks for 132 SMs), to one shared-memory load per FMA and to a
// synchronous tile copy; this design answers each:
//
// * Similarity tiles on a register-tiled outer product.  A block of 128
//   threads (8 x 16) scores 8 MI queries against 128 corpus rows; thread
//   (ty, tx) holds queries MI ty .. MI ty + MI - 1 against corpus rows tx +
//   16 j, j < 8.  MI is 8 (64-query tiles, 64 accumulators a thread), or 2
//   where 64-query tiles cannot give every SM a block (the served selection
//   shape).  Each 4-deep step reads 8 + MI float4 from shared memory for
//   32 MI FMAs; rows are padded to 36 floats, so the eight lanes of one
//   128-bit access phase hit eight distinct 4-bank groups.
// * Chunks along d (32 deep) arrive through a two-stage cp.async ring of
//   16-byte copies: the next chunk's copy is in flight while the current
//   one is multiplied.  Rows past B or past the split, and columns past d,
//   are zero-filled and never read.
// * The corpus is split across blocks: grid (query tile, corpus split),
//   sized by the wrapper (kernel.py: grid) so that at the deployment shape
//   at least two blocks per SM fill the card.  Each block keeps a running
//   list per query row in shared memory (R slots, best first) and the
//   row's k-th value in a register.  A finished tile is folded in with
//   bitonic networks on half warps (a row's 128 scores are 8 registers of
//   16 lanes): when more than 16 scores beat the k-th value, the tile's
//   best R (R the power of two >= k, at least 16) by sorting runs of R and
//   folding them pairwise, then merged with the list; otherwise the few
//   that beat it are compacted to one register per lane, sorted and merged.
//   The serial one-at-a-time inserts of the warp kernel, which cost more
//   than the products here, are gone.
// * Splits share a floor: each row's k-th value, once its list is full, is
//   a lower bound on the k-th value of the whole corpus, so a block publishes
//   it (atomicMax on an order-preserving key in a zeroed (B,) scratch) and
//   every block drops candidates below the largest floor of its query.  The
//   blocks of later waves then fold almost nothing.  Candidates equal to the
//   floor are kept: they may still win a tie on id.
// * A second kernel merges the splits' lists: one block per query, its eight
//   half warps fold a share of the lists each, then each other's.  When one
//   split covers n, the first kernel writes the final top-k and the merge
//   is not launched.
//
// Why the result is exact, ties included.  Every comparison of every
// network is on the key (value desc, id asc), so a fold or merge gives the
// exact best entries of its inputs under that key whatever order they
// arrive in.  A dropped candidate cannot be in the top-k: it is below a
// floor (a k-th value some split reached), or not above its own list's k-th
// value (then the k entries already held beat it, those of equal value
// having come from earlier tiles, with lower ids).  So every entry of the
// top-k reaches its split's list and the merge.  Empty slots (a split
// shorter than k) carry id -1 and -inf.
//
// Each launcher returns cudaGetLastError() after its launches (0 on
// success).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstddef>

#include "hopper.cuh"
#include "topk.cuh"  // kFull, kWarp

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

// the chunk ring, the rows' lists of R slots, and each half warp's batch
template <int MI, int R>
size_t tiled_smem_bytes() {
  return sizeof(float) * kStages * stage_floats<MI>() +
         (static_cast<size_t>(8 * MI) * R + kThreads) *
             (sizeof(float) + sizeof(int));
}

// Stage chunk [d0, d0 + kBD) of query rows q0 .. q0 + BQ - 1 and corpus
// rows c0.. (rows past B or c_hi, and columns past d, are zero-filled, not
// read).
template <int BQ>
__device__ __forceinline__ void load_chunk(float* stage,
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

// acc[i][j] += q row (MI ty + i) . corpus row (tx + 16 j) over the chunk's
// first `width` floats (a multiple of 4; all kBD of them when kWhole)
template <bool kWhole, int MI>
__device__ __forceinline__ void multiply(float (&acc)[MI][8], const float* qs,
                                         const float* cs, int ty, int tx,
                                         int width) {
  const int w = kWhole ? kBD : width;
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
// for each j
// its 16 lanes hold 16 consecutive corpus rows.  A candidate counts when it
// beats the row's own k-th value and reaches the row's shared floor (the
// largest k-th value any split of this call has published for that query;
// `floors` is null with one split).  Rows i of both halves go together:
// when either has more than kBatch candidates (always on the first tile a
// split folds before any floor is known), both reduce the whole tile and
// merge; otherwise both compact their candidates and merge.  Each row whose
// list holds k entries then publishes its k-th value.
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
                            int d, int k, int tps) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BQ = 8 * MI, kStage = stage_floats<MI>();
  float* topv = smem + kStages * kStage;          // [BQ][R]
  int* topi = reinterpret_cast<int*>(topv + BQ * R);
  float* batch_v = reinterpret_cast<float*>(topi + BQ * R);
  int* batch_i = reinterpret_cast<int*>(batch_v + kThreads);  // 16 a half

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int c_lo = split * tps * kBN;
  const int c_hi = min(c_lo + tps * kBN, n);
  const int tiles = (c_hi - c_lo + kBN - 1) / kBN;
  const int chunks = (d + kBD - 1) / kBD;
  const int steps = tiles * chunks;

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
                 c_lo + (s / chunks) * kBN, c_hi, d, (s % chunks) * kBD);
    hopper::cp_async_commit();
  }

  for (int t = 0; t < steps; ++t) {
    hopper::cp_async_wait<kStages - 2>();  // step t has landed (this thread)
    __syncthreads();  // ... for every thread; step t - 1 is consumed
    const int next = t + kStages - 1;
    if (next < steps)
      load_chunk<BQ>(smem + (next % kStages) * kStage, q, corpus, q0, B,
                 c_lo + (next / chunks) * kBN, c_hi, d,
                 (next % chunks) * kBD);
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

    // the tile's scores are complete: fold them into the running lists
    select_tile<R, MI>(acc, kth, topv, topi, batch_v + 32 * warp,
                   batch_i + 32 * warp, floors, q0, B, warp, lane,
                   c_lo + (t / chunks) * kBN, c_hi, k);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

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

// One block per query row folds the row's n_lists lists of k pairs (each
// best first): half warp h takes lists h, h + 8, ... one after another
// (the better of each pair of its list and the next list reversed, merged),
// then the eight lists are folded the same way in three rounds.
template <int R>
__global__ void __launch_bounds__(kThreads)
retrieval_topk_merge_kernel(const float* __restrict__ part_v,
                            const int* __restrict__ part_i,
                            float* __restrict__ vals, int* __restrict__ ids,
                            int n_lists, int k) {
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
  for (int l0 = kHalves; l0 < n_lists; l0 += kHalves) {  // warp-uniform
    const int l = l0 + hw;
#pragma unroll
    for (int r = 0; r < rr; ++r) {
      const int back = R - 1 - (16 * r + tx);
      const bool in = l < n_lists && back < k;
      const float lv = in ? pv[l * k + back] : -CUDART_INF_F;
      const int li = in ? pi[l * k + back] : -1;
      if (better(lv, li, v[r], id[r])) {
        v[r] = lv;
        id[r] = li;
      }
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
  if (hw != 0) return;
#pragma unroll
  for (int r = 0; r < rr; ++r) {
    const int e = 16 * r + tx;
    if (e < k) {
      vals[static_cast<size_t>(row) * k + e] = v[r];
      ids[static_cast<size_t>(row) * k + e] = id[r];
    }
  }
}

template <int R, int MI>
int launch_tiled(const float* q, const float* corpus, float* part_v,
                 int* part_i, unsigned* floors, float* vals, int* ids, int B,
                 int n, int d, int k, int q_tiles, int tps, int n_splits,
                 cudaStream_t s) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  const size_t smem = tiled_smem_bytes<MI, R>();
  cudaError_t err =
      hopper::allow_smem(retrieval_topk_tiled_kernel<R, MI>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool merge = n_splits > 1;
  retrieval_topk_tiled_kernel<R, MI>
      <<<dim3(q_tiles, n_splits), kThreads, smem, s>>>(
          q, corpus, merge ? part_v : vals, merge ? part_i : ids,
          merge ? floors : nullptr, B, n, d, k, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  retrieval_topk_merge_kernel<R><<<B, kThreads, 0, s>>>(part_v, part_i, vals,
                                                        ids, n_splits, k);
  return static_cast<int>(cudaGetLastError());
}

template <int MI>
int launch_rows(const float* q, const float* corpus, float* part_v,
                int* part_i, unsigned* floors, float* vals, int* ids, int B,
                int n, int d, int k, int q_tiles, int tps, int n_splits,
                cudaStream_t s) {
  if (k <= 16)
    return launch_tiled<16, MI>(q, corpus, part_v, part_i, floors, vals, ids,
                                B, n, d, k, q_tiles, tps, n_splits, s);
  if (k <= 32)
    return launch_tiled<32, MI>(q, corpus, part_v, part_i, floors, vals, ids,
                                B, n, d, k, q_tiles, tps, n_splits, s);
  return launch_tiled<64, MI>(q, corpus, part_v, part_i, floors, vals, ids, B,
                              n, d, k, q_tiles, tps, n_splits, s);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// q (B, d) and corpus (n, d) fp32, 16-byte aligned, d % 4 == 0, 1 <= k <=
// 64; grid (q_tiles, n_splits) of query_tile (64 or 16) rows by tps corpus
// tiles of 128 rows.  With n_splits == 1 the kernel writes vals / ids (B, k)
// and part_v, part_i and floors are not used; otherwise it writes part_* (B,
// n_splits, k), the splits share their k-th values through floors (B,),
// which must hold zeros, and the merge writes vals / ids.
extern "C" int retrieval_topk_tiled_launch(const float* q, const float* corpus,
                                           float* part_v, int* part_i,
                                           unsigned* floors, float* vals,
                                           int* ids, int B, int n, int d,
                                           int k, int query_tile, int q_tiles,
                                           int tps, int n_splits,
                                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (query_tile == 16)
    return launch_rows<2>(q, corpus, part_v, part_i, floors, vals, ids, B, n,
                          d, k, q_tiles, tps, n_splits, s);
  if (query_tile == 64)
    return launch_rows<8>(q, corpus, part_v, part_i, floors, vals, ids, B, n,
                          d, k, q_tiles, tps, n_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
