// The first port's warp-per-row selection kernels (paper Algorithm 3), the
// "row" variants of retrieval_topk and dsqe_score.  No route sends a call
// here any more: retrieval_topk.cu and dsqe_score.cu (the tiled top-k core of
// tiled_topk.cuh) take every k and d.  They stay callable by name
// (kernel.launch(..., "row")) so that chip_smoke.py can time them beside
// the redesign on the same inputs.
//
// retrieval_topk replaces the Pallas TPU kernel retrieval_topk_kernel
// (src/repro/kernels/retrieval_topk/kernel.py:87): for each query row the
// descending top-k of q . corpus_row over an (n, d) fp32 corpus, ties to the
// lowest id.  dsqe_score replaces dsqe_score_kernel
// (src/repro/kernels/dsqe_score/kernel.py:112): the same streamed kNN top-k
// over the projected train rows, then per query the first-argmax prototype,
// the kNN vote over the neighbours' path-weight rows plus the prior, and
// the SLO / containment / validity mask (NEG_INF where it fails).
//
// What bounds them on an H100: one warp per query streams 32-row corpus
// tiles through shared memory (one shared-memory load per FMA), one block
// serves kWarpsPerBlock queries (B / 4 blocks for 132 SMs), the tile copy is
// synchronous and the running top-k (topk.cuh, k <= 64) inserts one
// candidate at a time.  The shared tile grows with d: above about 1600 it
// does not fit (kernels/retrieval_topk/kernel.py: prepare refuses it).
//
// Each launcher returns cudaGetLastError() after the launch (0 on success);
// selection_prepare(d) must have run on the device first.
#include <climits>

#include "topk.cuh"

namespace repro_torch {
namespace {

constexpr int kWarpsPerBlock = 4;

template <int NW>
__global__ void __launch_bounds__(NW * kWarp)
retrieval_topk_kernel(const float* __restrict__ q,
                      const float* __restrict__ corpus,
                      float* __restrict__ vals, int* __restrict__ ids,
                      int B, int n, int d, int k) {
  extern __shared__ float smem[];
  float* tile = smem;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * NW + warp;
  const bool active = row < B;  // warp-uniform
  float* qs = smem + kTileRows * (d + 1) + warp * d;
  for (int j = lane; j < d; j += kWarp)
    qs[j] = active ? q[static_cast<size_t>(row) * d + j] : 0.f;

  WarpTopK tk;
  tk.init(k);
  stream_topk(tk, tile, qs, corpus, n, d, NW, active);
  if (!active) return;
  float* out_v = vals + static_cast<size_t>(row) * k;
  int* out_i = ids + static_cast<size_t>(row) * k;
  if (lane < k) {
    out_v[lane] = tk.v0;
    out_i[lane] = tk.i0;
  }
  if (lane + kWarp < k) {
    out_v[lane + kWarp] = tk.v1;
    out_i[lane + kWarp] = tk.i1;
  }
}

template <int NW>
__global__ void __launch_bounds__(NW * kWarp)
dsqe_score_kernel(const float* __restrict__ q, const float* __restrict__ protos,
                  const float* __restrict__ train,
                  const float* __restrict__ path_weights,
                  const float* __restrict__ contains,
                  const float* __restrict__ lat, const float* __restrict__ cost,
                  const float* __restrict__ prior,
                  const float* __restrict__ valid,
                  const float* __restrict__ slo, float* __restrict__ scores,
                  int* __restrict__ set_ids, int B, int K, int N, int P, int d,
                  int knn) {
  extern __shared__ float smem[];
  float* tile = smem;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * NW + warp;
  const bool active = row < B;  // warp-uniform
  float* qs = smem + kTileRows * (d + 1) + warp * d;
  for (int j = lane; j < d; j += kWarp)
    qs[j] = active ? q[static_cast<size_t>(row) * d + j] : 0.f;

  WarpTopK tk;
  tk.init(knn);
  stream_topk(tk, tile, qs, train, N, d, NW, active);

  // critical set: the FIRST argmax prototype.  Each lane keeps its best
  // (strictly greater wins, so its lowest index on ties), then the warp
  // reduces on (value desc, index asc).
  float best_v = -CUDART_INF_F;
  int best_k = INT_MAX;
  for (int row0 = 0; row0 < K; row0 += kTileRows) {
    __syncthreads();
    stage_tile(tile, protos, row0, K, d, NW);
    __syncthreads();
    const int kk = row0 + lane;
    if (active && kk < K) {
      const float s = row_dot(qs, tile + lane * (d + 1), d);
      if (best_k == INT_MAX || s > best_v) {
        best_v = s;
        best_k = kk;
      }
    }
  }
  if (!active) return;
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, best_v, off);
    const int ok = __shfl_down_sync(kFull, best_k, off);
    if (ov > best_v || (ov == best_v && ok < best_k)) {
      best_v = ov;
      best_k = ok;
    }
  }
  const int set = __shfl_sync(kFull, best_k, 0);

  const float max_lat = slo[2 * row], max_cost = slo[2 * row + 1];
  const float* crow = contains + static_cast<size_t>(set) * P;
  float* out = scores + static_cast<size_t>(row) * P;
  for (int p0 = 0; p0 < P; p0 += kWarp) {
    const int p = p0 + lane;
    float acc = 0.f;
    for (int s = 0; s < knn; ++s) {  // warp-uniform: slots are broadcast
      const float w = fmaxf(tk.value(s), 0.f);
      const int id = tk.id(s);
      if (p < P && id >= 0)
        acc += w * path_weights[static_cast<size_t>(id) * P + p];
    }
    if (p < P) {
      const bool feasible = crow[p] > 0.5f && valid[p] > 0.5f &&
                            lat[p] <= max_lat && cost[p] <= max_cost;
      out[p] = feasible ? acc + prior[p] : kNegInf;
    }
  }
  if (lane == 0) set_ids[row] = set;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// Dynamic shared memory one block needs at width d (the wrappers refuse a d
// whose tile does not fit the card's per-block limit).
extern "C" size_t selection_smem_bytes(int d) {
  return smem_floats(kWarpsPerBlock, d) * sizeof(float);
}

// Allow both kernels the dynamic shared memory of width d on the current
// device (above 48 KB this must be asked for).  The wrappers call it only
// when d is wider than any width made ready before on that device, never
// per launch, and never to lower the limit.
extern "C" int selection_prepare(int d) {
  const size_t smem = selection_smem_bytes(d);
  cudaError_t err = allow_smem(retrieval_topk_kernel<kWarpsPerBlock>, smem);
  if (err == cudaSuccess)
    err = allow_smem(dsqe_score_kernel<kWarpsPerBlock>, smem);
  return static_cast<int>(err);
}

extern "C" int retrieval_topk_launch(const float* q, const float* corpus,
                                     float* vals, int* ids, int B, int n,
                                     int d, int k, void* stream) {
  const size_t smem = selection_smem_bytes(d);
  auto kernel = retrieval_topk_kernel<kWarpsPerBlock>;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  kernel<<<grid, kWarpsPerBlock * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(q, corpus, vals, ids, B, n, d,
                                                k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsqe_score_row_launch(const float* q, const float* protos,
                                     const float* train,
                                     const float* path_weights,
                                     const float* contains, const float* lat,
                                     const float* cost, const float* prior,
                                     const float* valid, const float* slo,
                                     float* scores, int* set_ids, int B,
                                     int K, int N, int P, int d, int knn,
                                     void* stream) {
  const size_t smem = selection_smem_bytes(d);
  auto kernel = dsqe_score_kernel<kWarpsPerBlock>;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  kernel<<<grid, kWarpsPerBlock * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(
      q, protos, train, path_weights, contains, lat, cost, prior, valid, slo,
      scores, set_ids, B, K, N, P, d, knn);
  return static_cast<int>(cudaGetLastError());
}
