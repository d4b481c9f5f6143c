// Path-selection scoring for Hopper on the tiled top-k core
// (tiled_topk.cuh): the routes of every dsqe_score call
// (kernels/dsqe_score/kernel.py), "tiled" for knn <= 64 and "select" above,
// by the same rule and grid as retrieval_topk.  The first port's warp kernel
// (selection.cu) stays callable by name for comparison.
//
// Replaces the Pallas TPU kernel dsqe_score_kernel
// (src/repro/kernels/dsqe_score/kernel.py:112, body _dsqe_kernel at :50):
// the kNN top-k of q . train_row over the projected train rows (exact
// ties to the lowest row), then per query the first-argmax prototype
// (critical set), the vote score[p] = prior[p] + sum_s max(v_s, 0) W[id_s,
// p] over the k neighbours, and the SLO / containment / validity mask
// (NEG_INF where it fails).  The TPU kernel scatters the votes over all N
// rows and multiplies by the whole (N, P) path-weight table held in VMEM;
// here each query gathers only the k rows it voted for.
//
// What bounds it on an H100: the similarity, 2 B N d fp32 FLOPs on the
// CUDA cores (66.9 TFLOP/s; no TF32, which flips kNN and argmax decisions).
// The rest is small beside it: 2 B K d FLOPs for the prototypes, and B k P
// gathered path weights (3.4 MB at the deployment shape, B 256, k 16, P
// 210).  So the similarity and top-k are retrieval_topk's own
// (launch_tiled_lists and launch_scores, defined in retrieval_topk.cu), and
// the scoring runs once per query where the top-k is final: in the merge
// of the splits' lists (tiled; with one split the merge folds one list), or
// in the select block (select).  Two launches a call (a chunk of B on the
// select route; one chunk unless B N > 2^24).
//
// Each launcher returns cudaGetLastError() after its launches (0 on
// success).
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

#include "hopper.cuh"
#include "tiled_topk.cuh"

namespace repro_torch {
namespace {

// The epilogue of one query row on its final top-k (get(s): slot s, best
// first): the first-argmax prototype, the vote plus the prior, the mask.
struct DsqeScore {
  const float* q;       // (B, d)
  const float* protos;  // (K, d)
  const float* path_weights;  // (N, P)
  const float* contains;      // (K, P)
  const float* lat;
  const float* cost;
  const float* prior;
  const float* valid;  // (P,) each
  const float* slo;    // (B, 2): max latency, max cost
  float* scores;       // (B, P)
  int* set_ids;        // (B,)
  int K, P, d;

  template <typename Get>
  __device__ void operator()(int row, int k, Get get) const {
    constexpr int kGroup = 4;   // prototypes a warp scores at once
    constexpr int kUnroll = 8;  // neighbours whose weights load at once
    __shared__ float best_v[32];
    __shared__ int best_i[32];
    __shared__ int set_shared;
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    const int n_warps = blockDim.x / kWarp;
    // critical set: warp w scores prototypes 4 w .. 4 w + 3, then 4 (w +
    // n_warps) .., four rows' loads in flight at once (lanes along d,
    // protos read through L2), keeping the first of equal bests; then
    // thread 0 takes the best of the warps on (value desc, index asc)
    const float* qr = q + static_cast<size_t>(row) * d;
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int p0 = kGroup * warp; p0 < K; p0 += kGroup * n_warps) {
      float s[kGroup] = {};
      for (int j = lane; j < d; j += kWarp) {
        const float x = qr[j];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (p0 + g < K)
            s[g] = fmaf(x, protos[static_cast<size_t>(p0 + g) * d + j], s[g]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        float t = s[g];
#pragma unroll
        for (int o = kWarp / 2; o > 0; o >>= 1)
          t += __shfl_xor_sync(kFull, t, o);
        if (p0 + g < K && (bi == INT_MAX || t > bv)) {
          bv = t;
          bi = p0 + g;
        }
      }
    }
    if (lane == 0) {
      best_v[warp] = bv;
      best_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = best_v[0];
      int set = best_i[0];
      for (int w = 1; w < n_warps; ++w)
        if (best_i[w] != INT_MAX &&
            (set == INT_MAX || best_v[w] > v ||
             (best_v[w] == v && best_i[w] < set))) {
          v = best_v[w];
          set = best_i[w];
        }
      set_shared = set;
      set_ids[row] = set;
    }
    __syncthreads();
    const int set = set_shared;

    // the vote: thread p gathers column p of the k neighbours' rows
    // (consecutive threads, consecutive columns), eight rows' loads in
    // flight at once, summed in slot order
    const float max_lat = slo[2 * row], max_cost = slo[2 * row + 1];
    const float* crow = contains + static_cast<size_t>(set) * P;
    float* out = scores + static_cast<size_t>(row) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      float acc = 0.f;
      for (int s0 = 0; s0 < k; s0 += kUnroll) {
        float w[kUnroll], x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const Entry e = s0 + u < k ? get(s0 + u) : Entry{0.f, -1};
          const bool real = e.id >= 0;  // an empty slot adds +0
          w[u] = real ? fmaxf(e.v, 0.f) : 0.f;
          x[u] = real ? path_weights[static_cast<size_t>(e.id) * P + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc += w[u] * x[u];
      }
      const bool feasible = crow[p] > 0.5f && valid[p] > 0.5f &&
                            lat[p] <= max_lat && cost[p] <= max_cost;
      out[p] = feasible ? acc + prior[p] : kNegInf;
    }
  }
};

template <int R>
__global__ void __launch_bounds__(kThreads)
dsqe_score_merge_kernel(const float* __restrict__ part_v,
                        const int* __restrict__ part_i, int n_lists, int k,
                        DsqeScore epi) {
  merge_body<R>(part_v, part_i, n_lists, k, epi);
}

__global__ void __launch_bounds__(kSelectThreads)
dsqe_score_select_kernel(const float* __restrict__ sims,
                         unsigned long long* spill, int n, int k, int sort_n,
                         int row0, DsqeScore epi) {
  select_body(sims, spill, n, k, sort_n, row0, epi);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// "tiled": 1 <= knn <= 64.  The tiled kernel writes each query's top-knn of
// each corpus split to part_v / part_i (B, n_splits, knn) on the grid
// (query_tile, q_tiles, tps, n_splits) of retrieval_topk's grid(B, N); the
// splits share floors (B,), zeroed, where n_splits > 1.  Then one block per
// query merges its lists and scores.  vec4: d % 4 == 0 and 16-byte aligned
// q and train.
extern "C" int dsqe_score_tiled_launch(
    const float* q, const float* protos, const float* train,
    const float* path_weights, const float* contains, const float* lat,
    const float* cost, const float* prior, const float* valid,
    const float* slo, float* part_v, int* part_i, unsigned* floors,
    float* scores, int* set_ids, int B, int K, int N, int P, int d, int knn,
    int vec4, int query_tile, int q_tiles, int tps, int n_splits,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int err = launch_tiled_lists(q, train, part_v, part_i,
                               n_splits > 1 ? floors : nullptr, B, N, d, knn,
                               vec4 != 0, query_tile, q_tiles, tps, n_splits,
                               s);
  if (err != 0) return err;
  const DsqeScore epi{q,     protos, path_weights, contains, lat,
                      cost,  prior,  valid,        slo,      scores,
                      set_ids, K,    P,            d};
  if (knn <= 16)
    dsqe_score_merge_kernel<16><<<B, kThreads, 0, s>>>(part_v, part_i,
                                                       n_splits, knn, epi);
  else if (knn <= 32)
    dsqe_score_merge_kernel<32><<<B, kThreads, 0, s>>>(part_v, part_i,
                                                       n_splits, knn, epi);
  else
    dsqe_score_merge_kernel<64><<<B, kThreads, 0, s>>>(part_v, part_i,
                                                       n_splits, knn, epi);
  return static_cast<int>(cudaGetLastError());
}

// "select": any 1 <= knn <= N.  The B rows go in chunks of `chunk`: per
// chunk the product writes sims (chunk, N) on the grid (query_tile, tps,
// n_splits) of grid(chunk, N), then one select block per row finds its
// top-knn and scores.  spill holds chunk x sort_size(knn) 64-bit keys where
// sort_size(knn) > 8192, else it is not used.
extern "C" int dsqe_score_select_launch(
    const float* q, const float* protos, const float* train,
    const float* path_weights, const float* contains, const float* lat,
    const float* cost, const float* prior, const float* valid,
    const float* slo, float* sims, void* spill, float* scores, int* set_ids,
    int B, int K, int N, int P, int d, int knn, int vec4, int chunk,
    int query_tile, int tps, int n_splits, void* stream) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  auto s = static_cast<cudaStream_t>(stream);
  const int sort_n = sort_size(knn);
  const size_t smem = select_smem_bytes(sort_n);
  const cudaError_t set =
      hopper::allow_smem(dsqe_score_select_kernel, smem, ready);
  if (set != cudaSuccess) return static_cast<int>(set);
  const DsqeScore epi{q,     protos, path_weights, contains, lat,
                      cost,  prior,  valid,        slo,      scores,
                      set_ids, K,    P,            d};
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int rows = B - b0 < chunk ? B - b0 : chunk;
    const int err = launch_scores(q + static_cast<size_t>(b0) * d, train,
                                  sims, rows, N, d, vec4 != 0, query_tile,
                                  tps, n_splits, s);
    if (err != 0) return err;
    dsqe_score_select_kernel<<<rows, kSelectThreads, smem, s>>>(
        sims, static_cast<unsigned long long*>(spill), N, knn, sort_n, b0,
        epi);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  return 0;
}
