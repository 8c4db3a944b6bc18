// tree_histogram for Hopper (sm_90a): per-feature binned histogram, the
// scatter at the heart of histogram tree growth.
//
// Replaces the Pallas TPU kernel alink_tpu/tree/pallas_hist.py::pallas_histogram
// (pl.pallas_call at pallas_hist.py:101). Same function as the plain version
// alink_tpu_torch/tree/hist_cuda.py::histogram_ref:
//   out[s, f] = Σ_n vals[n] · (ids[n, f] == s),   s in [0, S)
// ids outside [0, S) add nothing and write nothing.
//
// Layout: ids (n, d) int32, vals (n,) fp32, out (S, d) fp32, all contiguous;
// out arrives zeroed. The caller (the forest's level program) passes
// ids = node·B + bin, S = L·B for the L nodes of a level.
//
// Design. The TPU kernel kept an (S, 128-feature) block in VMEM and, for
// every 512-row block, looped over all S segments with a compare and a
// masked sum: O(n·d·S) work, a layout workaround for a machine without a
// scatter. Here each (row, feature) pair is one atomic add, O(n·d). Where
// the partial histograms live depends on S, which spans 64 … 131,072 within
// one tree of depth 12:
//  - small S: each CTA owns a tile of dt features and a chunk of rows,
//    accumulates a private (S, dt) histogram with shared-memory atomics and
//    adds its non-zero cells to out with global atomics. The tile takes at
//    most 48 KB (four CTAs of 512 threads per SM) and at least 6 features
//    (or the whole row); a CTA covers at least 4·S rows, so its flush stays
//    small beside its rows. At the shallow levels most pairs of a binary
//    feature hit two cells: the private histogram keeps that contention
//    inside each CTA.
//  - larger S: one global atomic per pair, straight into out (at most
//    131,072 × 54 × 4 B = 28.3 MB, inside the 50 MB L2), where the pairs
//    spread over enough cells not to contend.
// The crossover comes from one H100 run of both paths at every S of a
// depth-12 tree (PERF.md): with fewer than 6 features per tile, the
// narrow strided reads and the flush cost more than global atomics save.
//
// Bound. Each pair reads 4 bytes of ids; at n = 522,911, d = 54 one call
// must move 112.9 MB of ids, 2.1 MB of vals and S·d·4 bytes of out:
// 34.3 µs at S = 64 and 42.8 µs at S = 131,072 at the H100's 3.35 TB/s,
// against ~28 M adds, so the function is memory-bound. This kernel's own
// limit is the atomics (shared or L2), not the bytes.
//
// Order of sums: atomics add in an order that changes from run to run. Sums
// of integers below 2^24 (bootstrap counts, class indicators) are exact in
// any order; real values differ from the plain version within
// count·2^-24·Σ|vals| per cell.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int SMEM_TILE = 48 * 1024;       // four CTAs per SM, no opt-in
constexpr int MIN_TILE_FEATURES = 6;       // fewer: the global path is faster
constexpr int ROWS_PER_SEGMENT = 4;        // rows per CTA ≥ 4·S
constexpr int CTAS_PER_SM = 8;             // aim of the row chunking

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

__global__ void __launch_bounds__(THREADS)
hist_shared_kernel(const int32_t* __restrict__ ids,
                   const float* __restrict__ vals, float* __restrict__ out,
                   int n, int d, int S, int dt, int rows_per_cta) {
  extern __shared__ float hist[];   // (S, w): w features of this CTA
  const int f0 = blockIdx.x * dt;
  const int w = min(dt, d - f0);
  const int r0 = blockIdx.y * rows_per_cta;
  const int r1 = min(n, r0 + rows_per_cta);
  const int cells = S * w;
  for (int i = threadIdx.x; i < cells; i += THREADS) hist[i] = 0.f;
  __syncthreads();

  // pairs (row, feature) of the tile in row-major order, so a warp reads
  // neighbouring ids
  const int pairs = (r1 - r0) * w;
  for (int e = threadIdx.x; e < pairs; e += THREADS) {
    const int dr = e / w;
    const int j = e - dr * w;
    const int r = r0 + dr;
    const int s = ids[(size_t)r * d + f0 + j];
    if ((unsigned)s < (unsigned)S) atomicAdd(&hist[s * w + j], vals[r]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += THREADS) {
    const float v = hist[i];
    if (v != 0.f) {   // adding +0 changes nothing
      const int s = i / w;
      atomicAdd(&out[(size_t)s * d + f0 + (i - s * w)], v);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
hist_global_kernel(const int32_t* __restrict__ ids,
                   const float* __restrict__ vals, float* __restrict__ out,
                   int n, int d, int S) {
  const int pairs = n * d;
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < pairs;
       e += gridDim.x * THREADS) {
    const int s = ids[e];
    if ((unsigned)s < (unsigned)S) {
      const int r = e / d;
      atomicAdd(&out[(size_t)s * d + (e - r * d)], vals[r]);
    }
  }
}

// Bytes of shared memory one CTA of the shared-memory path takes for S
// segments and d features; 0 when S is too large for it (global path).
int tree_histogram_smem_bytes(int S, int d) {
  long long dt = SMEM_TILE / (4LL * S);
  if (dt > d) dt = d;
  if (dt < 1 || (dt < d && dt < MIN_TILE_FEATURES)) return 0;
  return (int)(4LL * S * dt);
}

}  // namespace

// Adds the histogram of (ids, vals) into out (S, d), which the caller zeroed.
// Requires n·d ≤ 2^30 and S·d < 2^31. Returns the launch's CUDA status.
cudaError_t tree_histogram_launch(const int32_t* ids, const float* vals,
                                  float* out, int n, int d, int S,
                                  cudaStream_t stream) {
  if (n == 0 || d == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;

  const int smem = tree_histogram_smem_bytes(S, d);
  if (smem > 0) {
    const int dt = smem / (4 * S);
    const int tiles = ceil_div(d, dt);
    int chunks = ceil_div(CTAS_PER_SM * sms, tiles);
    const int most = n / (ROWS_PER_SEGMENT * S);   // chunks of ≥ 4·S rows
    if (chunks > most) chunks = most;
    if (chunks < 1) chunks = 1;
    if (chunks > 65535) chunks = 65535;
    const int rows = ceil_div(n, chunks);
    hist_shared_kernel<<<dim3(tiles, ceil_div(n, rows)), THREADS, smem,
                         stream>>>(ids, vals, out, n, d, S, dt, rows);
  } else {
    int blocks = ceil_div((long long)n * d, THREADS);
    if (blocks > CTAS_PER_SM * 4 * sms) blocks = CTAS_PER_SM * 4 * sms;
    hist_global_kernel<<<blocks, THREADS, 0, stream>>>(ids, vals, out, n, d,
                                                       S);
  }
  return cudaGetLastError();
}
