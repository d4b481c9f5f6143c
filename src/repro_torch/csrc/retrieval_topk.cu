// Retrieval top-k for Hopper on the tiled top-k core (tiled_topk.cuh): the
// routes of every retrieval_topk call (kernels/retrieval_topk/kernel.py:
// route), "tiled" for k <= 64 and "select" above; the warp-per-row kernel of
// selection.cu stays callable by name for comparison.
//
// Replaces the Pallas TPU kernel retrieval_topk_kernel
// (src/repro/kernels/retrieval_topk/kernel.py:87, merge topk_merge at :38):
// for each (B, d) fp32 query row the descending top-k of q . corpus_row
// over an (n, d) fp32 corpus, every 1 <= k <= n, exact ties to the lowest
// id.  What bounds it, and how the design answers, is in tiled_topk.cuh.
//
// This file also defines the similarity launchers that dsqe_score.cu
// shares (launch_tiled_lists, launch_scores).  Each launcher returns
// cudaGetLastError() after its launches (0 on success).
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "hopper.cuh"
#include "tiled_topk.cuh"

namespace repro_torch {
namespace {

template <int R>
__global__ void __launch_bounds__(kThreads)
retrieval_topk_merge_kernel(const float* __restrict__ part_v,
                            const int* __restrict__ part_i,
                            float* __restrict__ vals, int* __restrict__ ids,
                            int n_lists, int k) {
  merge_body<R>(part_v, part_i, n_lists, k, WriteTopK{vals, ids});
}

__global__ void __launch_bounds__(kSelectThreads)
retrieval_topk_select_kernel(const float* __restrict__ scores,
                             unsigned long long* spill,
                             float* __restrict__ vals, int* __restrict__ ids,
                             int n, int k, int sort_n, int row0) {
  select_body(scores, spill, n, k, sort_n, row0, WriteTopK{vals, ids});
}

template <int R, int MI>
int launch_lists(const float* q, const float* corpus, float* out_v,
                 int* out_i, unsigned* floors, int B, int n, int d, int k,
                 bool vec4, int q_tiles, int tps, int n_splits,
                 cudaStream_t s) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  const size_t smem = tiled_smem_bytes<MI, R>();
  const cudaError_t err =
      hopper::allow_smem(retrieval_topk_tiled_kernel<R, MI>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  retrieval_topk_tiled_kernel<R, MI>
      <<<dim3(q_tiles, n_splits), kThreads, smem, s>>>(
          q, corpus, out_v, out_i, floors, B, n, d, k, tps, vec4);
  return static_cast<int>(cudaGetLastError());
}

template <int MI>
int launch_lists_mi(const float* q, const float* corpus, float* out_v,
                    int* out_i, unsigned* floors, int B, int n, int d, int k,
                    bool vec4, int q_tiles, int tps, int n_splits,
                    cudaStream_t s) {
  if (k <= 16)
    return launch_lists<16, MI>(q, corpus, out_v, out_i, floors, B, n, d, k,
                                vec4, q_tiles, tps, n_splits, s);
  if (k <= 32)
    return launch_lists<32, MI>(q, corpus, out_v, out_i, floors, B, n, d, k,
                                vec4, q_tiles, tps, n_splits, s);
  return launch_lists<64, MI>(q, corpus, out_v, out_i, floors, B, n, d, k,
                              vec4, q_tiles, tps, n_splits, s);
}

template <int MI>
int launch_scores_mi(const float* q, const float* corpus, float* scores,
                     int B, int n, int d, bool vec4, int tps, int n_splits,
                     cudaStream_t s) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  const size_t smem = sizeof(float) * kStages * stage_floats<MI>();
  const cudaError_t err =
      hopper::allow_smem(retrieval_topk_scores_kernel<MI>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (B + 8 * MI - 1) / (8 * MI);
  retrieval_topk_scores_kernel<MI>
      <<<dim3(q_tiles, n_splits), kThreads, smem, s>>>(q, corpus, scores, B,
                                                       n, d, tps, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_tiled_lists(const float* q, const float* corpus, float* out_v,
                       int* out_i, unsigned* floors, int B, int n, int d,
                       int k, bool vec4, int query_tile, int q_tiles, int tps,
                       int n_splits, cudaStream_t s) {
  if (k < 1 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (query_tile == 16)
    return launch_lists_mi<2>(q, corpus, out_v, out_i, floors, B, n, d, k,
                              vec4, q_tiles, tps, n_splits, s);
  if (query_tile == 64)
    return launch_lists_mi<8>(q, corpus, out_v, out_i, floors, B, n, d, k,
                              vec4, q_tiles, tps, n_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_scores(const float* q, const float* corpus, float* scores, int B,
                  int n, int d, bool vec4, int query_tile, int tps,
                  int n_splits, cudaStream_t s) {
  if (query_tile == 16)
    return launch_scores_mi<2>(q, corpus, scores, B, n, d, vec4, tps,
                               n_splits, s);
  if (query_tile == 64)
    return launch_scores_mi<8>(q, corpus, scores, B, n, d, vec4, tps,
                               n_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch

using namespace repro_torch;

// "tiled": q (B, d) and corpus (n, d) fp32, 1 <= k <= 64, vec4 = d % 4 == 0
// with 16-byte aligned bases; grid (q_tiles, n_splits) of query_tile (64 or
// 16) rows by tps corpus tiles of 128 rows.  With n_splits == 1 the kernel
// writes vals / ids (B, k) and part_v, part_i and floors are not used;
// otherwise it writes part_* (B, n_splits, k), the splits share their k-th
// values through floors (B,), which must hold zeros, and the merge writes
// vals / ids.
extern "C" int retrieval_topk_tiled_launch(const float* q, const float* corpus,
                                           float* part_v, int* part_i,
                                           unsigned* floors, float* vals,
                                           int* ids, int B, int n, int d,
                                           int k, int vec4, int query_tile,
                                           int q_tiles, int tps, int n_splits,
                                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool merge = n_splits > 1;
  int err = launch_tiled_lists(q, corpus, merge ? part_v : vals,
                               merge ? part_i : ids, merge ? floors : nullptr,
                               B, n, d, k, vec4 != 0, query_tile, q_tiles, tps,
                               n_splits, s);
  if (err != 0 || !merge) return err;
  if (k <= 16)
    retrieval_topk_merge_kernel<16><<<B, kThreads, 0, s>>>(part_v, part_i,
                                                           vals, ids,
                                                           n_splits, k);
  else if (k <= 32)
    retrieval_topk_merge_kernel<32><<<B, kThreads, 0, s>>>(part_v, part_i,
                                                           vals, ids,
                                                           n_splits, k);
  else
    retrieval_topk_merge_kernel<64><<<B, kThreads, 0, s>>>(part_v, part_i,
                                                           vals, ids,
                                                           n_splits, k);
  return static_cast<int>(cudaGetLastError());
}

// "select": any 1 <= k <= n.  The B rows go in chunks of `chunk`: per chunk
// the product writes scores (chunk, n) on the grid (query_tile, tps,
// n_splits) of grid(chunk, n), then one select block per row writes its
// top-k to vals / ids (B, k).  spill holds chunk x sort_size(k) 64-bit keys
// where sort_size(k) > kSortChunk (8192), else it is not used.
extern "C" int retrieval_topk_select_launch(const float* q,
                                            const float* corpus,
                                            float* scores, void* spill,
                                            float* vals, int* ids, int B,
                                            int n, int d, int k, int vec4,
                                            int chunk, int query_tile,
                                            int tps, int n_splits,
                                            void* stream) {
  static std::atomic<size_t> ready[hopper::kMaxDevices];
  auto s = static_cast<cudaStream_t>(stream);
  const int sort_n = sort_size(k);
  const size_t smem = select_smem_bytes(sort_n);
  const cudaError_t set =
      hopper::allow_smem(retrieval_topk_select_kernel, smem, ready);
  if (set != cudaSuccess) return static_cast<int>(set);
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int rows = B - b0 < chunk ? B - b0 : chunk;
    const int err = launch_scores(q + static_cast<size_t>(b0) * d, corpus,
                                  scores, rows, n, d, vec4 != 0, query_tile,
                                  tps, n_splits, s);
    if (err != 0) return err;
    retrieval_topk_select_kernel<<<rows, kSelectThreads, smem, s>>>(
        scores, static_cast<unsigned long long*>(spill), vals, ids, n, k,
        sort_n, b0);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  return 0;
}
