// Hopper kernels of the RG-LRU recurrent block: the diagonal linear recurrence
// and its backward.
//
// rglru_scan replaces the Pallas TPU kernel rglru_scan_kernel
// (src/repro/kernels/rglru_scan/kernel.py:41, pallas_call at :54):
// h_t = a_t * h_{t-1} + x_t, elementwise over the R channels, from h0, every
// h_t written out in fp32.  The TPU grid (B, S / chunk) walked time in order
// per batch row, one (chunk, R) block of a and x in VMEM per grid step, the
// carry in VMEM scratch and a vectorised (8, 128)-lane update per step.
// rglru_scan_bwd_kernel is its backward; the JAX package differentiates an
// associative scan with XLA (src/repro/models/blocks.py:431-448), no Pallas
// kernel.  From the upstream gradient dh of every state and the saved states
// h, with g_S = 0:
//   g_t = dh_t + a_{t+1} g_{t+1}     (a walk over S from the end)
//   dx_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0),  dh0 = a_0 g_0
//
// What bounds both on an H100: 2 (forward) or 3 (backward) FLOPs an element
// on one read of each input and one write of each output (forward: a, x, h,
// 12 bytes an element in fp32; backward: a, dh, h, da, dx, 20 bytes): bound
// by bytes, 3.35 TB/s.  At RecurrentGemma-2B's train microbatch (B 1, S
// 4096, R 2560) that is 0.038 ms forward and 0.063 ms backward.
//
// Why the first port's walk stalled: one thread owned one channel and
// issued the loads of 16 time steps, waited for them, ran the 16 dependent
// updates and only then issued the next 16 loads.  Every 16 steps paid one
// whole DRAM round trip with nothing overlapping it, 256 round trips in a
// row at S 4096; at B 1 the card held 2560 such threads (80 one-warp blocks
// on 132 SMs), a few KB in flight per block where 3.35 TB/s x ~1 us needs
// ~3.35 MB across the card.
//
// What the ring does about it: a block owns kCH = 32 consecutive channels
// of one batch row and walks all of S.  A producer warp copies tiles of T
// steps x kCH channels of every input into a ring of D stages in shared
// memory, full and empty mbarriers between it and the consumer warp (one
// lane per channel), and stays up to T x D steps ahead (the plan below: 256
// steps in the forward, 192 in the backward, ~5.2-5.9 MB in flight at B 1).
// The consumer takes a whole tile into registers, frees its stage, and runs
// the tile's steps (a whole tile without a guard on any step).  Time cannot
// be split over blocks without changing the order of the sums, so B x R /
// kCH blocks is all the parallelism there is, and the bytes in flight come
// from the ring's depth.  The backward's producer walks the tiles from the
// end of S and takes h shifted one step back (box start t0 - 1; at t0 = 0
// TMA fills row -1 with zeros, and the consumer takes h0 there).
//
// Two producers, one kernel template, chosen before launch by the plan
// (make_plan; kernels/rglru_scan/kernel.py: scan_plan is the same rule):
// * "tma": 3-D tensor maps (R, S, B), boxes of kCH x 64 steps x 1, no
//   swizzle; one lane issues them and the full barrier counts their bytes.
//   TMA needs 16-byte aligned bases and row strides R x element size that
//   are a multiple of 16 bytes.
// * "cp_async": every other shape (fp32 R 33, bf16 R 100), tiles of 32
//   steps: the 32 producer lanes copy each tile row as the 4-byte words that
//   cover it (the first may start up to 3 bytes early, the last is cut at
//   the row's end) into a row one word wider, and arrive on the full barrier
//   through cp.async.mbarrier.arrive.noinc once their copies land.
// Outputs (forward: h in fp32; backward: da and dx in a's dtype): on the
// TMA route each tile is staged in shared memory (two staging tiles an
// output) and written by one TMA store, as moe_gmm's persistent backward
// does; the cp.async route stores every step from the consumer, coalesced
// over the lanes.  Per-step stores on the TMA route took 2.4x as long at
// the train shape on the H100 (PERF.md).  What is left between the kernels
// and their bound is the consumer's serial work a step, its shared-memory
// traffic and the store path, not the bytes in flight: a deeper ring does
// not move the forward, and probes that dropped the stores halved it
// (PERF.md).
//
// Bit-equality: every step rounds the product and then the sum
// (__fmul_rn, __fadd_rn, no fused multiply-add) in the plain loops' order
// (kernels/rglru_scan/ref.py: rglru_scan_ref, rglru_scan_bwd_ref), and the
// ring changes only where the operands come from, so on the same inputs the
// kernels and the plain loops agree bit for bit, and two calls do too.  A
// chunked two-pass scan would fill the card with more threads but reorders
// the sums, and loses that.
//
// The launchers return cudaGetLastError() after their launch (0 on
// success), or a tensor map's error (hopper.cuh: kMapError, kNoEncoder);
// rglru_scan_last_route reports the producer the calling thread's last
// launch took.
#include "hopper.cuh"

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace repro_torch {
namespace {

// The plan's constants (kernels/rglru_scan/kernel.py mirrors them)
constexpr int kCH = 32;        // channels a block owns
constexpr int kStepsTma = 64;  // time steps a TMA ring tile holds
// a cp.async tile's steps: its rows' word shifts cost registers, and the
// consumer holds a whole tile of every input in registers
constexpr int kStepsCp = 32;
constexpr int kDepthFwd = 256;  // steps the ring holds ahead
constexpr int kDepthBwd = 192;
constexpr int kStaging = 2;  // staging tiles of each output (TMA route)
constexpr int kThreads = 64;  // warp 0 the consumer, warp 1 the producer
static_assert(kCH <= 32, "one consumer lane a channel");
static_assert(kStepsTma % 8 == 0 && kStepsTma <= 256,
              "a TMA box holds <= 256 rows");

__host__ __device__ constexpr int round128(int n) {
  return (n + 127) / 128 * 128;
}
// bytes of one ring row: kCH elements of es bytes, one word more for the
// cp.async producer (its copy starts at the 4-byte word holding the first)
__host__ __device__ constexpr int row_bytes(int es, bool tma) {
  return kCH * es + (tma ? 0 : 4);
}
__host__ __device__ constexpr int tile_steps(bool tma) {
  return tma ? kStepsTma : kStepsCp;
}
__host__ __device__ constexpr int tile_bytes(int es, bool tma) {
  return round128(tile_steps(tma) * row_bytes(es, tma));
}

struct Plan {
  bool tma;
  int t;     // steps a tile holds
  int d;     // ring stages
  int smem;  // dynamic shared memory bytes
};

// es: bytes of an element of a (and x, da, dx); dh and h are fp32.
// aligned: every tensor TMA would read or write starts on 16 bytes.
Plan make_plan(int S, int R, int es, bool bwd, bool aligned) {
  Plan p{};
  p.tma = aligned && (static_cast<long long>(R) * es) % 16 == 0;
  p.t = tile_steps(p.tma);
  const int tiles = (S + p.t - 1) / p.t;
  const int want = ((bwd ? kDepthBwd : kDepthFwd) + p.t - 1) / p.t;
  p.d = std::max(1, std::min(want, tiles));
  const int stage = bwd ? tile_bytes(es, p.tma) + 2 * tile_bytes(4, p.tma)
                        : 2 * tile_bytes(es, p.tma);
  const int staging =
      p.tma ? kStaging * (bwd ? 2 * round128(p.t * kCH * es)
                              : round128(p.t * kCH * 4))
            : 0;
  // 128 bytes of slack to align the base, the barriers, the ring, staging
  p.smem = 128 + round128(16 * p.d) + p.d * stage + staging;
  return p;
}

__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  return p + ((128u - (hopper::smem_u32(p) & 127u)) & 127u);
}

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

// bytes from the 4-byte word that holds p to p
__device__ __forceinline__ uint32_t word_shift(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p)) & 3u;
}

// Element c of row u of a ring tile, widened to fp32.  A cp.async row keeps
// its first element's shift past its word: sh0 for row 0, and each row adds
// the row stride's, rs (both 0 for fp32, whose elements fill whole words).
template <typename E, bool kTma>
__device__ __forceinline__ float tile_at(const uint8_t* tile, int u, int c,
                                         uint32_t sh0, uint32_t rs) {
  constexpr int kRow = row_bytes(sizeof(E), kTma);
  const uint8_t* row = tile + u * kRow + c * sizeof(E);
  if constexpr (!kTma && sizeof(E) < 4) row += (sh0 + u * rs) & 3u;
  return to_f(*reinterpret_cast<const E*>(row));
}

// The cp.async producer's copy of one tile: row u holds step t0 + u of the
// batch row starting at element row0 * R, if it lies in [0, S), channels r0
// .. min(r0 + kCH, R) - 1, as the 4-byte words that cover them (the last
// one cut at the row's end, so nothing past it is read).  The 32 lanes share
// the (row, word) pairs.
template <typename E>
__device__ __forceinline__ void copy_tile(uint8_t* tile, const E* src,
                                          size_t row0, int t0, int S, int R,
                                          int r0, int lane) {
  constexpr int kRow = row_bytes(sizeof(E), false);
  constexpr int kWords = kRow / 4;
  const int span = min(kCH, R - r0) * static_cast<int>(sizeof(E));
  for (int i = lane; i < kStepsCp * kWords; i += 32) {
    const int u = i / kWords, j = i % kWords;
    const int t = t0 + u;
    if (t < 0 || t >= S) continue;
    const char* first =
        reinterpret_cast<const char*>(src + (row0 + t) * R + r0);
    const char* word = first - word_shift(first) + 4 * j;
    const int left = static_cast<int>(first + span - word);
    if (left > 0)
      hopper::cp_async4(tile + u * kRow + 4 * j, word, min(4, left));
  }
}

// grid (ceil(R / kCH), B), kThreads threads: block (rb, b) owns channels
// rb * kCH .. + kCH - 1 of batch row b.  Ring stage: the a tile, the x tile.
template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap omap,
                  const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int S, int R, int D) {
  using namespace hopper;
  constexpr int kT = tile_steps(kTma);
  constexpr int kTile = tile_bytes(sizeof(T), kTma);
  constexpr int kStage = 2 * kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align128(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + D;
  uint8_t* ring = base + round128(16 * D);
  float* staging = reinterpret_cast<float*>(ring + D * kStage);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kCH, b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int tiles = (S + kT - 1) / kT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 1) {  // the producer (one lane for TMA, all 32 for cp.async)
    if (kTma && lane != 0) return;
    for (int k = 0; k < tiles; ++k) {
      const int s = k % D;
      if (k >= D) mbar_wait(&empty[s], (k / D - 1) & 1);
      uint8_t* st = ring + s * kStage;
      if constexpr (kTma) {
        mbar_expect_tx(&full[s], 2 * kT * kCH * sizeof(T));
        tma_load_3d(st, &amap, &full[s], r0, k * kT, b);
        tma_load_3d(st + kTile, &xmap, &full[s], r0, k * kT, b);
      } else {
        copy_tile(st, a, row0, k * kT, S, R, r0, lane);
        copy_tile(st + kTile, x, row0, k * kT, S, R, r0, lane);
        cp_async_arrive(&full[s]);
      }
    }
    if constexpr (!kTma) cp_async_wait<0>();
    return;
  }

  // the consumer: lane c carries channel r0 + c (lanes past kCH or R idle)
  const int c = lane < kCH ? lane : 0;
  const int r = r0 + lane;
  const bool live = lane < kCH && r < R;
  const uint32_t rs = (static_cast<uint32_t>(R) * sizeof(T)) & 3u;
  float h = live ? h0[static_cast<size_t>(b) * R + r] : 0.f;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % D;
    mbar_wait(&full[s], (k / D) & 1);
    const uint8_t* st = ring + s * kStage;
    const int t0 = k * kT, n = min(kT, S - t0);
    const size_t i0 = (row0 + t0) * R + r0;
    const uint32_t ws = word_shift(a + i0), xs = word_shift(x + i0);
    float av[kT], xv[kT];
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      av[u] = tile_at<T, kTma>(st, u, c, ws, rs);
      xv[u] = tile_at<T, kTma>(st + kTile, u, c, xs, rs);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the tile is in registers
    float* so = staging + (k % kStaging) * kT * kCH;
    if constexpr (kTma) {
      // the store kStaging tiles back has read its staging tile
      if (lane == 0) bulk_wait_read<kStaging - 1>();
      __syncwarp();
    }
    auto step = [&](int u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      if constexpr (kTma) {
        if (lane < kCH) so[u * kCH + lane] = h;
      } else if (live) {
        out[(row0 + t0 + u) * R + r] = h;
      }
    };
    if (n == kT) {  // a whole tile: no step guarded
#pragma unroll
      for (int u = 0; u < kT; ++u) step(u);
    } else {
#pragma unroll
      for (int u = 0; u < kT; ++u)
        if (u < n) step(u);
    }
    if constexpr (kTma) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&omap, so, r0, t0, b);  // rows past S are not written
        bulk_commit();
      }
    }
  }
  if constexpr (kTma) {
    if (lane == 0) bulk_wait<0>();
  }
}

// grid (ceil(R / kCH), B), as the forward.  Ring stage: the a tile, the dh
// tile, the h tile one step back; walked from the last tile.  g carries
// a_{t+1} g_{t+1} down the time steps.
template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap dhmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap damap,
                      const __grid_constant__ CUtensorMap dxmap,
                      const T* __restrict__ a, const float* __restrict__ h0,
                      const float* __restrict__ h,
                      const float* __restrict__ dh, T* __restrict__ da,
                      T* __restrict__ dx, float* __restrict__ dh0, int S,
                      int R, int D) {
  using namespace hopper;
  constexpr int kT = tile_steps(kTma);
  constexpr int kTileA = tile_bytes(sizeof(T), kTma);
  constexpr int kTileF = tile_bytes(4, kTma);
  constexpr int kStage = kTileA + 2 * kTileF;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align128(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + D;
  uint8_t* ring = base + round128(16 * D);
  T* staging = reinterpret_cast<T*>(ring + D * kStage);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kCH, b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int tiles = (S + kT - 1) / kT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 1) {  // the producer: the j-th tile it loads is tiles - 1 - j
    if (kTma && lane != 0) return;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % D, t0 = (tiles - 1 - j) * kT;
      if (j >= D) mbar_wait(&empty[s], (j / D - 1) & 1);
      uint8_t* st = ring + s * kStage;
      if constexpr (kTma) {
        mbar_expect_tx(&full[s], kT * kCH * (sizeof(T) + 8));
        tma_load_3d(st, &amap, &full[s], r0, t0, b);
        tma_load_3d(st + kTileA, &dhmap, &full[s], r0, t0, b);
        tma_load_3d(st + kTileA + kTileF, &hmap, &full[s], r0, t0 - 1, b);
      } else {
        copy_tile(st, a, row0, t0, S, R, r0, lane);
        copy_tile(st + kTileA, dh, row0, t0, S, R, r0, lane);
        copy_tile(st + kTileA + kTileF, h, row0, t0 - 1, S, R, r0, lane);
        cp_async_arrive(&full[s]);
      }
    }
    if constexpr (!kTma) cp_async_wait<0>();
    return;
  }

  const int c = lane < kCH ? lane : 0;
  const int r = r0 + lane;
  const bool live = lane < kCH && r < R;
  const uint32_t rs = (static_cast<uint32_t>(R) * sizeof(T)) & 3u;
  const float h_init = live ? h0[static_cast<size_t>(b) * R + r] : 0.f;
  float g = 0.f, a_next = 0.f;  // g_{t+1} and a_{t+1}; both 0 past S
  for (int j = 0; j < tiles; ++j) {
    const int s = j % D, t0 = (tiles - 1 - j) * kT;
    const int n = min(kT, S - t0);
    mbar_wait(&full[s], (j / D) & 1);
    const uint8_t* st = ring + s * kStage;
    const uint32_t ws = word_shift(a + (row0 + t0) * R + r0);
    float av[kT], dv[kT], hv[kT];
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      av[u] = tile_at<T, kTma>(st, u, c, ws, rs);
      dv[u] = tile_at<float, kTma>(st + kTileA, u, c, 0, 0);
      hv[u] = tile_at<float, kTma>(st + kTileA + kTileF, u, c, 0, 0);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    T* sda = staging + (j % kStaging) * 2 * kT * kCH;
    T* sdx = sda + kT * kCH;
    if constexpr (kTma) {
      if (lane == 0) bulk_wait_read<kStaging - 1>();
      __syncwarp();
    }
    auto step = [&](int u) {
      g = __fadd_rn(dv[u], __fmul_rn(a_next, g));
      const float hp = t0 + u > 0 ? hv[u] : h_init;
      const T gx = from_f<T>(g), ga = from_f<T>(__fmul_rn(g, hp));
      if constexpr (kTma) {
        if (lane < kCH) {
          sdx[u * kCH + lane] = gx;
          sda[u * kCH + lane] = ga;
        }
      } else if (live) {
        const size_t i = (row0 + t0 + u) * R + r;
        dx[i] = gx;
        da[i] = ga;
      }
      a_next = av[u];
    };
    if (n == kT) {  // a whole tile: no step guarded
#pragma unroll
      for (int u = kT - 1; u >= 0; --u) step(u);
    } else {
#pragma unroll
      for (int u = kT - 1; u >= 0; --u)
        if (u < n) step(u);
    }
    if constexpr (kTma) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store_3d(&damap, sda, r0, t0, b);
        tma_store_3d(&dxmap, sdx, r0, t0, b);
        bulk_commit();
      }
    }
  }
  if (live) dh0[static_cast<size_t>(b) * R + r] = __fmul_rn(a_next, g);
  if constexpr (kTma) {
    if (lane == 0) bulk_wait<0>();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename E>
CUtensorMapDataType map_type() {
  return sizeof(E) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a (B, S, R) tensor as a 3-D map (R, S, B), boxes of kCH x kStepsTma x 1
template <typename E>
int scan_map(CUtensorMap* map, const void* p, int B, int S, int R) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(R) * sizeof(E);
  const cuuint64_t strides[2] = {row, row * S};
  const cuuint32_t box[3] = {kCH, kStepsTma, 1};
  return hopper::tile_map(map, map_type<E>(), p, 3, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the shared-memory sizes already allowed, per device, for each kernel
template <typename T, bool kTma>
std::atomic<size_t> fwd_ready[hopper::kMaxDevices];
template <typename T, bool kTma>
std::atomic<size_t> bwd_ready[hopper::kMaxDevices];

// the producer of the calling thread's last launch: 1 TMA, 0 cp.async, -1
// none (no launch yet, or the last one failed)
thread_local int last_route = -1;

// one launch of `kernel` on the plan's route, its shared-memory limit
// raised first where needed
template <typename K, typename... Args>
int run(K* kernel, std::atomic<size_t>* ready, const Plan& p, dim3 grid,
        cudaStream_t stream, Args... args) {
  last_route = -1;
  const cudaError_t err = hopper::allow_smem(kernel, p.smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, p.smem, stream>>>(args...);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) last_route = p.tma ? 1 : 0;
  return static_cast<int>(launched);
}

template <typename T>
int launch_scan(const void* a, const void* x, const float* h0, float* out,
                int B, int S, int R, cudaStream_t stream) {
  const Plan p = make_plan(S, R, sizeof(T), false,
                           aligned16(a) && aligned16(x) && aligned16(out));
  CUtensorMap amap{}, xmap{}, omap{};  // unread by the cp.async producer
  auto* kernel = rglru_scan_kernel<T, false>;
  std::atomic<size_t>* ready = fwd_ready<T, false>;
  if (p.tma) {
    int err = scan_map<T>(&amap, a, B, S, R);
    if (!err) err = scan_map<T>(&xmap, x, B, S, R);
    if (!err) err = scan_map<float>(&omap, out, B, S, R);
    if (err) return err;
    kernel = rglru_scan_kernel<T, true>;
    ready = fwd_ready<T, true>;
  }
  return run(kernel, ready, p, dim3((R + kCH - 1) / kCH, B), stream,
             amap, xmap, omap, static_cast<const T*>(a),
             static_cast<const T*>(x), h0, out, S, R, p.d);
}

template <typename T>
int launch_scan_bwd(const void* a, const float* h0, const float* h,
                    const float* dh, void* da, void* dx, float* dh0, int B,
                    int S, int R, cudaStream_t stream) {
  const bool aligned = aligned16(a) && aligned16(h) && aligned16(dh) &&
                       aligned16(da) && aligned16(dx);
  const Plan p = make_plan(S, R, sizeof(T), true, aligned);
  CUtensorMap amap{}, dhmap{}, hmap{}, damap{}, dxmap{};
  auto* kernel = rglru_scan_bwd_kernel<T, false>;
  std::atomic<size_t>* ready = bwd_ready<T, false>;
  if (p.tma) {
    int err = scan_map<T>(&amap, a, B, S, R);
    if (!err) err = scan_map<float>(&dhmap, dh, B, S, R);
    if (!err) err = scan_map<float>(&hmap, h, B, S, R);
    if (!err) err = scan_map<T>(&damap, da, B, S, R);
    if (!err) err = scan_map<T>(&dxmap, dx, B, S, R);
    if (err) return err;
    kernel = rglru_scan_bwd_kernel<T, true>;
    ready = bwd_ready<T, true>;
  }
  return run(kernel, ready, p, dim3((R + kCH - 1) / kCH, B), stream,
             amap, dhmap, hmap, damap, dxmap, static_cast<const T*>(a), h0,
             h, dh, static_cast<T*>(da), static_cast<T*>(dx), dh0, S, R, p.d);
}

int scan(const void* a, const void* x, const float* h0, float* out, int dtype,
         int B, int S, int R, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_scan<float>(a, x, h0, out, B, S, R, s);
  return launch_scan<__nv_bfloat16>(a, x, h0, out, B, S, R, s);
}

int scan_bwd(const void* a, const float* h0, const float* h, const float* dh,
             void* da, void* dx, float* dh0, int dtype, int B, int S, int R,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scan_bwd<float>(a, h0, h, dh, da, dx, dh0, B, S, R, s);
  return launch_scan_bwd<__nv_bfloat16>(a, h0, h, dh, da, dx, dh0, B, S, R,
                                        s);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (of a and x; h0 and out are fp32)
extern "C" int rglru_scan_launch(const void* a, const void* x, const float* h0,
                                 float* out, int dtype, int B, int S, int R,
                                 void* stream) {
  return repro_torch::scan(a, x, h0, out, dtype, B, S, R, stream);
}

// dtype: 0 = float32, 1 = bfloat16 (of a, da and dx; h0, h, dh and dh0 are
// fp32)
extern "C" int rglru_scan_bwd_launch(const void* a, const float* h0,
                                     const float* h, const float* dh, void* da,
                                     void* dx, float* dh0, int dtype, int B,
                                     int S, int R, void* stream) {
  return repro_torch::scan_bwd(a, h0, h, dh, da, dx, dh0, dtype, B, S, R,
                               stream);
}

// The producer the calling thread's last launch of either kernel took: 1
// TMA, 0 cp.async, -1 none (no launch yet, or it failed).
extern "C" int rglru_scan_last_route() { return repro_torch::last_route; }

// The plan the launchers apply (kernels/rglru_scan/kernel.py: scan_plan is
// the same rule): out = {route (1 TMA, 0 cp.async), CH, T, D, shared bytes}.
extern "C" int rglru_scan_plan(int S, int R, int dtype, int backward,
                               int aligned, int* out) {
  const repro_torch::Plan p = repro_torch::make_plan(
      S, R, dtype == 0 ? 4 : 2, backward != 0, aligned != 0);
  out[0] = p.tma;
  out[1] = repro_torch::kCH;
  out[2] = p.t;
  out[3] = p.d;
  out[4] = p.smem;
  return 0;
}
