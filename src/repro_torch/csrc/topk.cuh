// Shared pieces of the two selection kernels (retrieval_topk, dsqe_score):
// corpus tiles staged in shared memory, one warp per query row, and the
// per-query running top-k that replaces the TPU kernels' ``topk_merge``
// (src/repro/kernels/retrieval_topk/kernel.py:38).
//
// Layout: a block of NW warps owns NW query rows.  The block walks the
// (n, d) corpus in tiles of kTileRows = 32 rows; each tile is copied to
// shared memory once and read by every warp, and lane l of each warp scores
// tile row l against its warp's query (a plain fp32 FMA dot product, no
// tensor cores).  Rows are stored with a stride of d + 1 floats so that 32
// lanes reading column j of 32 different rows hit 32 different banks.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro_torch {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kTileRows = 32;  // one tile row per lane
constexpr int kMaxK = 64;      // two running slots per lane
constexpr float kNegInf = -1e30f;  // NEG_INF of kernels/common.py

// Shared-memory floats of one block: the corpus tile plus NW query rows.
__host__ __device__ inline size_t smem_floats(int nw, int d) {
  return static_cast<size_t>(kTileRows) * (d + 1) + static_cast<size_t>(nw) * d;
}

// Copy corpus rows [row0, row0 + kTileRows) into the padded tile; rows past
// n are not read (the scorer masks them by bounds).  Warp w copies rows
// w, w + NW, ...; its lanes walk the row's columns, so reads coalesce.
__device__ inline void stage_tile(float* tile, const float* __restrict__ rows,
                                  int row0, int n, int d, int nw) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int r = warp; r < kTileRows; r += nw) {
    if (row0 + r >= n) break;
    const float* src = rows + static_cast<size_t>(row0 + r) * d;
    float* dst = tile + r * (d + 1);
    for (int j = lane; j < d; j += kWarp) dst[j] = src[j];
  }
}

// dot(query, tile row) with four independent accumulators.
__device__ inline float row_dot(const float* q, const float* row, int d) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = 0;
  for (; j + 4 <= d; j += 4) {
    a0 = fmaf(q[j], row[j], a0);
    a1 = fmaf(q[j + 1], row[j + 1], a1);
    a2 = fmaf(q[j + 2], row[j + 2], a2);
    a3 = fmaf(q[j + 3], row[j + 3], a3);
  }
  for (; j < d; ++j) a0 = fmaf(q[j], row[j], a0);
  return (a0 + a1) + (a2 + a3);
}

// A warp's running top-k, sorted by (value desc, id asc).  Lane l holds
// slot l in (v0, i0) and slot l + 32 in (v1, i1); slots >= k are scratch.
// Candidates must be offered in ascending id order: an insert then needs a
// value STRICTLY above the k-th, and lands behind every equal value already
// held, so an exact tie admits the lowest id, as ``topk_merge`` does.
struct WarpTopK {
  float v0, v1;
  int i0, i1;
  int k;
  float kth;  // value in slot k - 1: the admission threshold

  __device__ void init(int k_) {
    k = k_;
    v0 = v1 = kth = -CUDART_INF_F;
    i0 = i1 = -1;
  }

  // Value / id of slot s (warp-uniform s), broadcast to every lane.
  __device__ float value(int s) const {
    const float a = __shfl_sync(kFull, v0, s & 31);
    const float b = __shfl_sync(kFull, v1, s & 31);
    return s < kWarp ? a : b;
  }
  __device__ int id(int s) const {
    const int a = __shfl_sync(kFull, i0, s & 31);
    const int b = __shfl_sync(kFull, i1, s & 31);
    return s < kWarp ? a : b;
  }

  // Insert one warp-uniform candidate with s > kth.
  __device__ void insert(float s, int cid, int lane) {
    // entries >= s form a prefix of the sorted slots: its length is the
    // insert position
    const unsigned ge0 = __ballot_sync(kFull, lane < k && v0 >= s);
    const unsigned ge1 = __ballot_sync(kFull, lane + kWarp < k && v1 >= s);
    const int pos = __popc(ge0) + __popc(ge1);
    // slot i > pos takes old slot i - 1
    const float up_v0 = __shfl_up_sync(kFull, v0, 1);
    const int up_i0 = __shfl_up_sync(kFull, i0, 1);
    float up_v1 = __shfl_up_sync(kFull, v1, 1);
    int up_i1 = __shfl_up_sync(kFull, i1, 1);
    const float last_v0 = __shfl_sync(kFull, v0, kWarp - 1);
    const int last_i0 = __shfl_sync(kFull, i0, kWarp - 1);
    if (lane == 0) {  // slot 32 takes slot 31
      up_v1 = last_v0;
      up_i1 = last_i0;
    }
    if (lane == pos) {
      v0 = s;
      i0 = cid;
    } else if (lane > pos) {
      v0 = up_v0;
      i0 = up_i0;
    }
    if (lane + kWarp == pos) {
      v1 = s;
      i1 = cid;
    } else if (lane + kWarp > pos) {
      v1 = up_v1;
      i1 = up_i1;
    }
    kth = value(k - 1);
  }

  // Offer one candidate per lane (s, cid valid where ok); lanes carry
  // ascending ids.  Qualifying lanes are merged in lane order.
  __device__ void offer(float s, int cid, bool ok, int lane) {
    unsigned m = __ballot_sync(kFull, ok && s > kth);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cs = __shfl_sync(kFull, s, src);
      const int ci = __shfl_sync(kFull, cid, src);
      if (cs > kth) insert(cs, ci, lane);  // kth may have risen
    }
  }
};

// Stream the (n, d) rows through the block and leave each active warp's
// top-k of its query row (already staged in qs) in `tk`.  Every thread of
// the block must call this (it synchronises the block); `active` is
// warp-uniform.
__device__ inline void stream_topk(WarpTopK& tk, float* tile, const float* qs,
                                   const float* __restrict__ rows, int n,
                                   int d, int nw, bool active) {
  const int lane = threadIdx.x % kWarp;
  for (int row0 = 0; row0 < n; row0 += kTileRows) {
    __syncthreads();  // the previous tile is consumed; qs is visible
    stage_tile(tile, rows, row0, n, d, nw);
    __syncthreads();
    if (active) {
      const int cid = row0 + lane;
      const bool ok = cid < n;
      const float s = ok ? row_dot(qs, tile + lane * (d + 1), d) : 0.f;
      tk.offer(s, cid, ok, lane);
    }
  }
}

}  // namespace repro_torch
