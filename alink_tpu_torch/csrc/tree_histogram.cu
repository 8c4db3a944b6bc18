// tree_histogram for Hopper (sm_90a): every histogram of one level of the
// forest's level program in one call, with the segment ids built in the
// kernel.
//
// Replaces the Pallas TPU kernel alink_tpu/tree/pallas_hist.py::pallas_histogram
// (pl.pallas_call at pallas_hist.py:101), which the reference's level program
// calls once per value channel on ids = node·B + bin. Same function as the
// plain version alink_tpu_torch/tree/hist_cuda.py::level_histograms_ref:
//   out[c, l, f, b] = Σ_n vals_c[n] · (node[n]·B + bins[n, f] == l·B + b)
// for the C ≤ 3 channels (g, h, counts) and the L nodes of a level; an id
// outside [0, L·B) adds nothing, so a node outside [0, L) adds nothing and
// a bin ≥ B lands where node·B + bin points, as in the plain version.
//
// Layout: bins (n, d) uint8 or int32; node (n,) int32; vals C × (n,) fp32;
// out (C, L, d, B) fp32, zeroed by the caller; int32 scratch of
// tree_histogram_scratch(n, L). All contiguous. Any d: up to 256 features
// are one block; wider tables are walked in blocks of 128 features on a
// second grid axis (the reference's kernel takes blocks of 128 too), over
// the one sort of the rows.
//
// Design. Five launches on the caller's stream.
//  - A stable counting sort of the rows by node (bucket 0 below the range,
//    k+1 for node k, L+1 above): sort_count_kernel counts each unit's rows
//    (one warp over a contiguous slice of rows) per bucket, two scan
//    kernels turn the bucket-major (bucket, unit) counts into each unit's
//    first place in each bucket, and sort_scatter_kernel writes every row
//    index to its place, units and rows in order: within a node the rows
//    stay in row order. No atomics, and no 64-bit keys or values to move
//    (a library radix sort of node took a third of the call).
//  - level_hist_kernel: the rows are taken in that order, so a run of rows
//    belongs to one node. Each CTA owns a contiguous slice of the ordered
//    rows (a small node whole, a large one in slices) and one block of
//    features (blockIdx.y; all of them up to d = 256) and, for every node
//    run in its slice, builds that node's C × d_block × B histogram in
//    shared memory (2 × 54 × 65 × 4 B = 28 KB at the forest's shape; each
//    feature's row padded to B + 1 cells so that the lanes' bins fall on
//    distinct banks), then adds its non-zero cells to out with global
//    atomics (a node cut over several CTAs sums there). Node runs shorter
//    than SMEM_MIN_ROWS, nodes outside [0, L) and every run when the
//    histogram does not fit add their pairs to out directly.
//  - Ids in the kernel: a lane reads the uint8 bin of its feature and adds
//    to cell (f, bin) of the run's node: 1 byte a pair instead of 4 bytes of
//    ids per channel, and no (n, d) ids tensor.
//  - One warp walks its rows one at a time with lane = feature (two
//    features a lane at d ≤ 64), so no two lanes of a warp ever add to one
//    cell. Each lane keeps its feature's current bin and the channels' sums
//    in registers and adds them to shared memory only when the bin
//    changes: on the 44 one-hot columns of Covertype nearly every row of a
//    node hits the same bin, so those columns cost a few shared atomics a
//    warp instead of one a row. (Hopper has no shared-memory fp32 atomic
//    add: atomicAdd compiles to a compare-and-swap loop.)
//  - Loads: a warp takes 32 row indices and their values in one coalesced
//    load each and broadcasts them by shuffles; the bins of UNROLL rows are
//    loaded before any is added, so their latencies overlap.
//
// Bound. Each input read once and out written once: at n = 522,911, d = 54,
// B = 64 and 2 distinct channels (h is c), bins 28.2 MB, node 2.1 MB, vals
// 4.2 MB and out 2·L·d·B·4 B: 10.3 µs at L = 1 and 27.2 µs at L = 2,048 at
// the H100's 3.35 TB/s, against 56 M adds: memory-bound.
//
// Order of sums: atomics add in an order that changes from run to run. Sums
// of integers below 2^24 (bootstrap counts, class indicators) are exact in
// any order; real values differ from the plain version within
// count·2^-24·Σ|vals| per cell.

#include <cuda_runtime.h>
#include <cstdint>

struct HistVals {
  const float* p[3];   // the C channels' values, (n,) each
};

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CTAS_PER_SM = 2;        // __launch_bounds__ below: 64 registers
constexpr int MIN_ROWS_PER_CTA = 256;
constexpr int MAX_ROWS_PER_CTA = 8192;  // the slice's node ids in 32 KB
constexpr int SMEM_MIN_ROWS = 64;     // shorter node runs add straight to out
constexpr int UNROLL = 8;             // rows whose bins are in flight at once
constexpr int SORT_UNITS_PER_SM = 4;  // one warp each
constexpr long long SORT_CELLS = 1 << 19;  // most bucket × unit counters
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory a CTA may use
constexpr unsigned FULL = 0xffffffffu;

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

__device__ __forceinline__ int bucket_of(int k, int L) {
  return k < 0 ? 0 : (k >= L ? L + 1 : k + 1);
}

// Stages the buckets of rows [r0, r1) into b (shared), one warp.
__device__ __forceinline__ void stage_buckets(const int32_t* __restrict__ node,
                                              int r0, int r1, int L, int* b) {
  const int lane = threadIdx.x;
#pragma unroll 8
  for (int j = lane; j < r1 - r0; j += 32) b[j] = bucket_of(node[r0 + j], L);
  __syncwarp();
}

// Sort pass 1: unit u (one warp, rows [u·rows, (u+1)·rows)) counts its rows
// per bucket into cnt[b·U + u] (bucket-major, every cell written).
__global__ void __launch_bounds__(32)
sort_count_kernel(const int32_t* __restrict__ node, int n, int L, int rows,
                  int* __restrict__ cnt) {
  extern __shared__ int sm[];
  const int M = L + 2, U = gridDim.x, u = blockIdx.x, lane = threadIdx.x;
  int* c = sm;            // M counters
  int* b = sm + M;        // the unit's buckets
  const int r0 = min(n, u * rows), r1 = min(n, r0 + rows);
  for (int i = lane; i < M; i += 32) c[i] = 0;
  stage_buckets(node, r0, r1, L, b);
  for (int base = 0; base < r1 - r0; base += 32) {
    const bool ok = base + lane < r1 - r0;
    const unsigned active = __ballot_sync(FULL, ok);
    if (ok) {
      const int k = b[base + lane];
      const unsigned peers = __match_any_sync(active, k);
      if (lane == __ffs(peers) - 1) c[k] += __popc(peers);
    }
    __syncwarp();
  }
  for (int i = lane; i < M; i += 32) cnt[(size_t)i * U + u] = c[i];
}

// Sort pass 2a: CTA p sums x[p·per, (p+1)·per) into partial[p].
__global__ void __launch_bounds__(THREADS)
scan_partial_kernel(const int* __restrict__ x, long long total, int per,
                    int* __restrict__ partial) {
  __shared__ int warp_sum[WARPS];
  const long long a = (long long)blockIdx.x * per;
  const long long e = min(total, a + per);
  int s = 0;
  for (long long i = a + threadIdx.x; i < e; i += THREADS) s += x[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < WARPS; ++w) t += warp_sum[w];
    partial[blockIdx.x] = t;
  }
}

// Sort pass 2b: exclusive prefix sums of x in place, CTA p its segment,
// starting from the sum of partial[0, p).
__global__ void __launch_bounds__(THREADS)
scan_apply_kernel(int* __restrict__ x, long long total, int per,
                  const int* __restrict__ partial) {
  __shared__ int warp_total[WARPS];
  __shared__ int base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    int t = 0;
    for (int q = 0; q < (int)blockIdx.x; ++q) t += partial[q];
    base = t;
  }
  const long long a0 = (long long)blockIdx.x * per;
  const long long e0 = min(total, a0 + per);
  const int sub = (per + THREADS - 1) / THREADS;
  const long long a = min(e0, a0 + (long long)threadIdx.x * sub);
  const long long e = min(e0, a + sub);
  int s = 0;
  for (long long i = a; i < e; ++i) s += x[i];
  int incl = s;   // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = base;
  for (int w = 0; w < warp; ++w) before += warp_total[w];
  int run = before + incl - s;
  for (long long i = a; i < e; ++i) {
    const int v = x[i];
    x[i] = run;
    run += v;
  }
}

// Sort pass 3: unit u writes each of its rows, in row order, to the next
// place of its bucket (off: the exclusive prefix sums of cnt), so rows of a
// bucket keep their order: order[pos] = row, keys[pos] = bucket.
__global__ void __launch_bounds__(32)
sort_scatter_kernel(const int32_t* __restrict__ node, int n, int L, int rows,
                    const int* __restrict__ off, int32_t* __restrict__ order,
                    int32_t* __restrict__ keys) {
  extern __shared__ int sm[];
  const int M = L + 2, U = gridDim.x, u = blockIdx.x, lane = threadIdx.x;
  int* next = sm;         // M positions
  int* b = sm + M;        // the unit's buckets
  const int r0 = min(n, u * rows), r1 = min(n, r0 + rows);
  for (int i = lane; i < M; i += 32) next[i] = off[(size_t)i * U + u];
  stage_buckets(node, r0, r1, L, b);
  for (int base = 0; base < r1 - r0; base += 32) {
    const bool ok = base + lane < r1 - r0;
    const unsigned active = __ballot_sync(FULL, ok);
    if (ok) {
      const int k = b[base + lane];
      const unsigned peers = __match_any_sync(active, k);
      const int pos = next[k] + __popc(peers & ((1u << lane) - 1u));
      __syncwarp(active);
      if (lane == __ffs(peers) - 1) next[k] += __popc(peers);
      order[pos] = r0 + base + lane;
      keys[pos] = k;
    }
    __syncwarp();
  }
}

// Adds one pair where the plain version puts it: id = k·B + bin, nothing
// when the id lies outside [0, L·B).
template <int C>
__device__ __forceinline__ void add_global(float* out, long long k,
                                           long long bin, int f,
                                           const float (&v)[C], int L, int d,
                                           int B) {
  const long long id = k * B + bin;
  if (id < 0 || id >= (long long)L * B) return;
  const long long node = id / B, b = id - node * B;
#pragma unroll
  for (int c = 0; c < C; ++c)
    atomicAdd(&out[((c * (long long)L + node) * d + f) * B + b], v[c]);
}

// Adds a run's channel sums to its cell of the shared-memory histogram
// (C × d × (B + 1), channel-major).
template <int C>
__device__ __forceinline__ void cell_add(float* hist, int f, int bin, int d,
                                         int HB, const float (&a)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(&hist[(c * d + f) * HB + bin], a[c]);
}

// The ordered rows [a, e) of bucket key straight into out: one warp per row,
// lane = feature of the block [f0, f0 + db) (bins points at feature f0 of
// row 0); the node is key - 1, or the row's own for keys 0 and L+1.
template <typename BinT, int C>
__device__ void run_direct(const BinT* __restrict__ bins,
                           const int32_t* __restrict__ order,
                           const int32_t* __restrict__ node,
                           const HistVals& vals, float* out, int a, int e,
                           int key, int d, int f0, int db, int L, int B) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = a + warp; i < e; i += WARPS) {
    const int row = order[i];
    const int k = key >= 1 && key <= L ? key - 1 : node[row];
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = vals.p[c][row];
    for (int f = lane; f < db; f += 32) {
      const int bin = (int)bins[(size_t)row * d + f];
      if (k >= 0 && k < L && (unsigned)bin < (unsigned)B) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          atomicAdd(&out[((c * (size_t)L + k) * d + f0 + f) * B + bin], v[c]);
      } else {
        add_global<C>(out, k, bin, f0 + f, v, L, d, B);
      }
    }
  }
}

// The ordered rows [a, e) of node k, features [f0, f0 + db) (bins points at
// feature f0 of row 0), through the shared-memory histogram hist
// (C × db × (B + 1)), then into out.
template <typename BinT, int FPL, int C>
__device__ void run_shared(const BinT* __restrict__ bins,
                           const int32_t* __restrict__ order,
                           const HistVals& vals, float* out, float* hist,
                           int a, int e, int k, int d, int f0, int db, int L,
                           int B) {
  const int HB = B + 1;
  const int cells = C * db * HB;
  for (int i = threadIdx.x; i < cells; i += THREADS) hist[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (e - a + WARPS - 1) / WARPS;
  const int wa = a + warp * per, we = min(e, wa + per);
  int cur[FPL];             // the bin of the lane's open run, -1: none
  float acc[FPL][C];
#pragma unroll
  for (int j = 0; j < FPL; ++j) {
    cur[j] = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  }

  for (int i = wa; i < we; i += 32) {
    const int cnt = min(32, we - i);
    const int my_row = lane < cnt ? order[i + lane] : 0;
    float my_v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) my_v[c] = lane < cnt ? vals.p[c][my_row] : 0.f;
    for (int t0 = 0; t0 < cnt; t0 += UNROLL) {
      int bb[UNROLL][FPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = __shfl_sync(FULL, my_row, (t0 + u) & 31);
#pragma unroll
        for (int j = 0; j < FPL; ++j) {
          const int f = lane + 32 * j;
          bb[u][j] = (t0 + u < cnt && f < db)
                         ? (int)bins[(size_t)row * d + f] : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[c] = __shfl_sync(FULL, my_v[c], (t0 + u) & 31);
        if (t0 + u >= cnt) continue;   // warp-uniform
#pragma unroll
        for (int j = 0; j < FPL; ++j) {
          const int f = lane + 32 * j;
          if (f >= db) continue;
          const int bin = bb[u][j];
          if ((unsigned)bin >= (unsigned)B) {
            add_global<C>(out, k, bin, f0 + f, v, L, d, B);
          } else if (bin == cur[j]) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[j][c] += v[c];
          } else {
            if (cur[j] >= 0) cell_add<C>(hist, f, cur[j], db, HB, acc[j]);
            cur[j] = bin;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[j][c] = v[c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < FPL; ++j) {
    const int f = lane + 32 * j;
    if (cur[j] >= 0 && f < db) cell_add<C>(hist, f, cur[j], db, HB, acc[j]);
  }
  __syncthreads();

  for (int cf = warp; cf < C * db; cf += WARPS) {  // (channel, feature) rows
    const float* h = hist + cf * HB;
    float* o = out + ((size_t)(cf / db) * L + k) * d * B +
               (size_t)(f0 + cf % db) * B;
    for (int b = lane; b < B; b += 32)
      if (h[b] != 0.f) atomicAdd(&o[b], h[b]);   // adding +0 changes nothing
  }
  __syncthreads();   // hist is zeroed again for the next run
}

// BLOCKED: more than one feature block (blockIdx.y walks them); without it
// the block is the whole row, f0 = 0 and db = d at compile time, the code of
// a single-block kernel.
template <typename BinT, int FPL, int C, bool BLOCKED>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
level_hist_kernel(const BinT* __restrict__ bins,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ node, HistVals vals,
                  float* __restrict__ out, int n, int d, int fb, int L,
                  int B, int rows_per_cta, int shared_hist) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(n, r0 + rows_per_cta);
  const int f0 = BLOCKED ? blockIdx.y * fb : 0;   // this CTA's feature block
  const int db = BLOCKED ? min(fb, d - f0) : d;
  if (r0 >= r1) return;
  float* hist = smem;
  int* ks = reinterpret_cast<int*>(smem + (shared_hist ? C * fb * (B + 1) : 0));
  for (int i = threadIdx.x; i < r1 - r0; i += THREADS) ks[i] = keys[r0 + i];
  __syncthreads();

  // walk the bucket runs of the slice; the key and the run's end are the
  // same in every thread, so the branches and barriers below are uniform
  for (int s = 0; s < r1 - r0;) {
    const int key = ks[s];
    int lo = s + 1, hi = r1 - r0;      // first row past the run of key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ks[mid] <= key) lo = mid + 1; else hi = mid;
    }
    if (shared_hist && key >= 1 && key <= L && lo - s >= SMEM_MIN_ROWS)
      run_shared<BinT, FPL, C>(bins + f0, order, vals, out, hist, r0 + s,
                               r0 + lo, key - 1, d, f0, db, L, B);
    else
      run_direct<BinT, C>(bins + f0, order, node, vals, out, r0 + s, r0 + lo,
                          key, d, f0, db, L, B);
    s = lo;
  }
}

template <typename BinT, int FPL, int C>
cudaError_t launch_hist(const void* bins, const int32_t* order,
                        const int32_t* keys, const int32_t* node,
                        const HistVals& vals, float* out, int n, int d, int L,
                        int B, int sms, cudaStream_t stream) {
  int ctas = ceil_div(n, MIN_ROWS_PER_CTA);
  if (ctas > CTAS_PER_SM * sms) ctas = CTAS_PER_SM * sms;
  if (ctas < ceil_div(n, MAX_ROWS_PER_CTA)) ctas = ceil_div(n, MAX_ROWS_PER_CTA);
  const int rows = ceil_div(n, ctas);
  ctas = ceil_div(n, rows);
  const int fb = d < 32 * FPL ? d : 32 * FPL;   // features of a block
  const long long hist_bytes = 4LL * C * fb * (B + 1);
  const long long node_bytes = 4LL * rows;
  const int shared_hist = hist_bytes + node_bytes <= SMEM_LIMIT;
  const int smem = (int)(node_bytes + (shared_hist ? hist_bytes : 0));
  auto kernel = level_hist_kernel<BinT, FPL, C, false>;
  if constexpr (FPL == 4) {   // the instance that walks wide tables
    if (fb < d) kernel = level_hist_kernel<BinT, FPL, C, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ctas, ceil_div(d, fb));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const BinT*>(bins), order, keys, node, vals, out, n, d, fb,
      L, B, rows, shared_hist);
  return cudaGetLastError();
}

template <typename BinT, int C>
cudaError_t launch_fpl(const void* bins, const int32_t* order,
                       const int32_t* keys, const int32_t* node,
                       const HistVals& vals, float* out, int n, int d, int L,
                       int B, int sms, cudaStream_t stream) {
  if (d <= 64)
    return launch_hist<BinT, 2, C>(bins, order, keys, node, vals, out, n, d, L, B, sms, stream);
  if (d <= 128)
    return launch_hist<BinT, 4, C>(bins, order, keys, node, vals, out, n, d, L, B, sms, stream);
  if (d <= 256)
    return launch_hist<BinT, 8, C>(bins, order, keys, node, vals, out, n, d, L, B, sms, stream);
  // wider tables: blocks of 128 features, each CTA's histogram half the
  // 256-feature one, so two CTAs still fit an SM
  return launch_hist<BinT, 4, C>(bins, order, keys, node, vals, out, n, d, L, B, sms, stream);
}

template <typename BinT>
cudaError_t launch_c(const void* bins, const int32_t* order,
                     const int32_t* keys, const int32_t* node,
                     const HistVals& vals, int C, float* out, int n, int d,
                     int L, int B, int sms, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_fpl<BinT, 1>(bins, order, keys, node, vals, out, n, d, L, B, sms, stream);
    case 2: return launch_fpl<BinT, 2>(bins, order, keys, node, vals, out, n, d, L, B, sms, stream);
    case 3: return launch_fpl<BinT, 3>(bins, order, keys, node, vals, out, n, d, L, B, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest node count the kernel takes (any feature count).
int tree_histogram_max_nodes() { return 16384; }

namespace {

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

long long scratch_ints(int n, int L, int sms) {
  const long long M = L + 2;
  long long units = (long long)SORT_UNITS_PER_SM * sms;
  if (units * M > SORT_CELLS) units = SORT_CELLS / M > 0 ? SORT_CELLS / M : 1;
  if (units > ceil_div(n, 32)) units = ceil_div(n, 32);
  if (units < 1) units = 1;
  return M * units + sms + 2LL * n;
}

}  // namespace

// Int32 scratch the launch needs for n rows and L nodes (0 if the device
// cannot be queried).
long long tree_histogram_scratch(int n, int L) {
  const int sms = sm_count();
  return sms > 0 ? scratch_ints(n, L, sms) : 0;
}

// Adds the C histograms of one level into out (C, L, d, B), which the caller
// zeroed. bins are uint8 (bin_bytes 1) or int32 (4). scratch holds
// tree_histogram_scratch(n, L, sms) int32s. Requires 1 ≤ C ≤ 3,
// L ≤ 16384, n < 2^31, ceil(d / 128) < 65536. Returns the launches' CUDA status.
cudaError_t tree_histogram_launch(const void* bins, int bin_bytes,
                                  const int32_t* node, HistVals vals, int C,
                                  float* out, int* scratch, int n, int d,
                                  int L, int B, cudaStream_t stream) {
  if (n == 0 || d == 0) return cudaSuccess;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;

  // the stable counting sort of the rows by node
  const int M = L + 2;
  const long long total = scratch_ints(n, L, sms) - sms - 2LL * n;
  const int units = (int)(total / M);
  const int rows = ceil_div(n, units);
  int* cnt = scratch;
  int* partial = scratch + total;
  int32_t* order = partial + sms;
  int32_t* keys = order + n;
  const int sort_smem = 4 * (M + rows);
  const int per = ceil_div(total, sms);
  cudaError_t err = cudaFuncSetAttribute(sort_count_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sort_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sort_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sort_smem);
  if (err != cudaSuccess) return err;
  sort_count_kernel<<<units, 32, sort_smem, stream>>>(node, n, L, rows, cnt);
  scan_partial_kernel<<<sms, THREADS, 0, stream>>>(cnt, total, per, partial);
  scan_apply_kernel<<<sms, THREADS, 0, stream>>>(cnt, total, per, partial);
  sort_scatter_kernel<<<units, 32, sort_smem, stream>>>(node, n, L, rows, cnt,
                                                        order, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (bin_bytes == 1)
    return launch_c<uint8_t>(bins, order, keys, node, vals, C, out, n, d, L, B, sms, stream);
  if (bin_bytes == 4)
    return launch_c<int32_t>(bins, order, keys, node, vals, C, out, n, d, L, B, sms, stream);
  return cudaErrorInvalidValue;
}
