// sgns_block_grads for Hopper (sm_90a): the skip-gram negative-sampling
// gradients of one block of center rows, with the APS pull of the Word2Vec
// trainer's step inside.
//
// Replaces the Pallas TPU kernel
// alink_tpu/embedding/sgns_pallas.py::sgns_block_grads (pl.pallas_call at
// sgns_pallas.py:100). Same function as the plain versions in
// alink_tpu_torch/embedding/sgns_cuda.py:
//   g_pos = σ(v_b·u_pos_b) − 1,   g_n = σ(v_b·u_neg_{b,n})
//   grad_v[b]              = g_pos·u_pos_b + Σ_n g_n·u_neg_{b,n}
//   grad_u[b]              = g_pos·v_b                 (context rows)
//   grad_u[B + b·negs + n] = g_n·v_b                   (negatives, b-major)
// grad_u's row order is the id order the push consumes,
// concat(ctx, neg.reshape(-1)).
//
// Two modes of one kernel:
//  - pull (sgns_pull_grads_ref): the rows come from the tables through the
//    step's ids, as the one-rank APS pull reads them: v_b from win at
//    center[b]; u_pos_b and u_neg_{b,n} from wctx at uids[b] and
//    uids[B + b·negs + n]. An id in [0, hot) reads the hot replica (and
//    counts one cache hit), an id in [0, rows) the table, any other id (the
//    sentinel) a zero row. The batch's hits are added to the int64 *hits.
//  - gathered rows (sgns_block_grads_ref): v (B, D), u_pos (B, D) and
//    u_neg (B, negs, D) given, as the TPU kernel takes them.
// Layout: tables (rows, D), replicas (hot, D), v, u_pos, u_neg, grad_v (B, D)
// and grad_u ((negs+1)·B, D) fp32; ids int64; all contiguous. Any B, any D
// (ragged D needs no padding), any negs ≥ 0.
//
// Design. One warp owns one center row b from start to end. Lane l holds
// elements d = l, l+32, … of a row, so a warp's loads and stores are
// coalesced. The lanes first resolve the row sources of b, one id a lane
// (the replica, the table or the zero row), and count the hot ids with one
// ballot; then the warp issues the loads of v_b and of up to GROUP context
// and negative rows before the first dot product, so their latencies
// overlap, reduces the dot products by warp shuffles, takes the sigmoids in
// fp32 with expf (not __expf, whose error would eat into the atol), writes
// each grad_u row straight to its final place and adds g·u into grad_v,
// which stays in registers in the reference kernel's order
// g_pos·u_pos + g_0·u_0 + g_1·u_1 + … and is written once. A CTA adds its
// warps' hits to *hits with one atomic. The gathered rows of the pull never
// reach device memory. Rows wider than 1,024 (32 elements a lane) do not fit
// in registers: sgns_wide_kernel walks them in chunks, a row at a time, and
// keeps grad_v in its output row instead (the reference pads D to lanes of
// 128 and has no cap either).
//
// Bound. Each input read once and each output written once: at the main
// path's (B, negs, D) = (1024, 5, 100), the 7·B ids (57 KB) and 7·B rows of
// the tables (2.87 MB) in, grad_v and grad_u (2.87 MB) out: 1.73 µs at
// 3.35 TB/s, against about 3 MFLOP — memory-bound, and short enough that
// the launch costs as much.

#include <cuda_runtime.h>
#include <cstdint>

struct SgnsArgs {
  // pull mode (center != nullptr)
  const int64_t* center;   // (B,)
  const int64_t* uids;     // ((negs+1)·B,)
  const float* win;        // (rows, D)
  const float* wctx;       // (rows, D)
  const float* rep_in;     // (hot, D) or null when hot == 0
  const float* rep_ctx;    // (hot, D) or null when hot == 0
  unsigned long long* hits;   // 0-dim int64, or null when hot == 0
  long long rows, hot;
  // gathered mode
  const float* v;          // (B, D)
  const float* u_pos;      // (B, D)
  const float* u_neg;      // (B, negs, D)
};

namespace {

constexpr int WARPS = 8;                  // rows per block
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Source of row j of center row b: j = 0 is v_b, j = 1 u_pos_b, j ≥ 2
// u_neg_{b, j-2}; null is a zero row. *hot_hit: the pull read the replica.
__device__ __forceinline__ const float* row_source(const SgnsArgs& a, int b,
                                                   int j, int B, int negs,
                                                   int D, bool* hot_hit) {
  *hot_hit = false;
  if (a.center == nullptr) {
    if (j == 0) return a.v + (size_t)b * D;
    if (j == 1) return a.u_pos + (size_t)b * D;
    return a.u_neg + ((size_t)b * negs + (j - 2)) * D;
  }
  const long long id =
      j == 0 ? a.center[b]
             : a.uids[j == 1 ? (size_t)b : (size_t)B + (size_t)b * negs + (j - 2)];
  if (id >= 0 && id < a.hot) {
    *hot_hit = true;
    return (j == 0 ? a.rep_in : a.rep_ctx) + (size_t)id * D;
  }
  if (id >= 0 && id < a.rows) return (j == 0 ? a.win : a.wctx) + (size_t)id * D;
  return nullptr;
}

// VPL: elements of a row per lane, ceil(D/32) rounded up to the instance;
// GROUP: context and negative rows loaded before their dot products.
template <int VPL, int GROUP>
__global__ void __launch_bounds__(THREADS)
sgns_block_grads_kernel(SgnsArgs a, float* __restrict__ grad_v,
                        float* __restrict__ grad_u, int B, int negs, int D) {
  __shared__ unsigned long long cta_hits;
  if (threadIdx.x == 0) cta_hits = 0;
  if (a.hits != nullptr) __syncthreads();
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;

  if (b < B) {   // whole warps skip together: shuffles stay full
    const int nrows = negs + 2;   // v, u_pos, the negatives
    // lane l resolves row l (rows past 31 are resolved where they are used)
    bool hit = false;
    const float* mine = lane < nrows
        ? row_source(a, b, lane, B, negs, D, &hit) : nullptr;
    unsigned long long warp_hits =
        __popc(__ballot_sync(0xffffffffu, hit && lane < nrows));
    auto src = [&](int j) -> const float* {
      if (j < 32)
        return reinterpret_cast<const float*>(__shfl_sync(
            0xffffffffu, reinterpret_cast<unsigned long long>(mine), j));
      bool h;
      const float* p = row_source(a, b, j, B, negs, D, &h);
      if (h) ++warp_hits;   // every lane counts it; lane 0's count is used
      return p;
    };

    float vr[VPL], acc[VPL];
    const float* pv = src(0);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int d = lane + 32 * i;
      vr[i] = (pv != nullptr && d < D) ? pv[d] : 0.f;
      acc[i] = 0.f;
    }

    for (int j0 = 1; j0 < nrows; j0 += GROUP) {
      float ur[GROUP][VPL], dot[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int j = j0 + g;
        const float* p = j < nrows ? src(j) : nullptr;   // j: warp-uniform
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int d = lane + 32 * i;
          ur[g][i] = (p != nullptr && d < D) ? p[d] : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) s += vr[i] * ur[g][i];
        dot[g] = s;
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (j0 + g < nrows) dot[g] = warp_sum(dot[g]);
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int j = j0 + g;
        if (j >= nrows) break;
        const float s = sigmoid(dot[g]);
        const float gj = j == 1 ? s - 1.0f : s;
        float* gu = grad_u + (j == 1 ? (size_t)b
                                     : (size_t)B + (size_t)b * negs + (j - 2)) *
                                 D;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int d = lane + 32 * i;
          acc[i] = j == 1 ? gj * ur[g][i] : acc[i] + gj * ur[g][i];
          if (d < D) gu[d] = gj * vr[i];
        }
      }
    }

    float* gv = grad_v + (size_t)b * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) gv[d] = acc[i];
    }
    if (a.hits != nullptr && lane == 0 && warp_hits != 0)
      atomicAdd(&cta_hits, warp_hits);
  }
  if (a.hits != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0 && cta_hits != 0) atomicAdd(a.hits, cta_hits);
  }
}

// D > 1024: one warp per center row as above, with the rows walked in
// chunks of 32 elements, lane-strided: for each context or negative row j,
// the dot product v_b·u_j over the whole row, then grad_u row j and
// grad_v[b] += g_j·u_j (read back from its output row, which only this
// warp writes), in the same order of terms as the kernel above.
__global__ void __launch_bounds__(THREADS)
sgns_wide_kernel(SgnsArgs a, float* __restrict__ grad_v,
                 float* __restrict__ grad_u, int B, int negs, int D) {
  __shared__ unsigned long long cta_hits;
  if (threadIdx.x == 0) cta_hits = 0;
  if (a.hits != nullptr) __syncthreads();
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;

  if (b < B) {
    const int nrows = negs + 2;
    bool hit = false;
    const float* mine = lane < nrows
        ? row_source(a, b, lane, B, negs, D, &hit) : nullptr;
    unsigned long long warp_hits =
        __popc(__ballot_sync(0xffffffffu, hit && lane < nrows));
    auto src = [&](int j) -> const float* {
      if (j < 32)
        return reinterpret_cast<const float*>(__shfl_sync(
            0xffffffffu, reinterpret_cast<unsigned long long>(mine), j));
      bool h;
      const float* p = row_source(a, b, j, B, negs, D, &h);
      if (h) ++warp_hits;
      return p;
    };
    const float* pv = src(0);
    float* gv = grad_v + (size_t)b * D;
    for (int j = 1; j < nrows; ++j) {
      const float* pu = src(j);
      float s = 0.f;
      if (pv != nullptr && pu != nullptr)
        for (int d = lane; d < D; d += 32) s += pv[d] * pu[d];
      s = warp_sum(s);
      const float sg = sigmoid(s);
      const float gj = j == 1 ? sg - 1.0f : sg;
      float* gu = grad_u + (j == 1 ? (size_t)b
                                   : (size_t)B + (size_t)b * negs + (j - 2)) *
                               D;
      for (int d = lane; d < D; d += 32) {
        const float u = pu != nullptr ? pu[d] : 0.f;
        gu[d] = gj * (pv != nullptr ? pv[d] : 0.f);
        gv[d] = j == 1 ? gj * u : gv[d] + gj * u;
      }
    }
    if (a.hits != nullptr && lane == 0 && warp_hits != 0)
      atomicAdd(&cta_hits, warp_hits);
  }
  if (a.hits != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0 && cta_hits != 0) atomicAdd(a.hits, cta_hits);
  }
}

template <int VPL, int GROUP>
cudaError_t launch(const SgnsArgs& a, float* grad_v, float* grad_u, int B,
                   int negs, int D, cudaStream_t stream) {
  const int blocks = (B + WARPS - 1) / WARPS;
  sgns_block_grads_kernel<VPL, GROUP><<<blocks, THREADS, 0, stream>>>(
      a, grad_v, grad_u, B, negs, D);
  return cudaGetLastError();
}

cudaError_t launch_any(const SgnsArgs& a, float* grad_v, float* grad_u, int B,
                       int negs, int D, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const int vpl = (D + 31) / 32;
  if (vpl <= 1) return launch<1, 8>(a, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 2) return launch<2, 8>(a, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 4) return launch<4, 8>(a, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 8) return launch<8, 8>(a, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 16) return launch<16, 4>(a, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 32) return launch<32, 2>(a, grad_v, grad_u, B, negs, D, stream);
  sgns_wide_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      a, grad_v, grad_u, B, negs, D);
  return cudaGetLastError();
}

}  // namespace

// Gathered-rows mode: writes grad_v (B, D) and grad_u ((negs+1)·B, D) from
// v, u_pos and u_neg. Requires D ≥ 1. Returns the launch's CUDA status.
cudaError_t sgns_block_grads_launch(const float* v, const float* u_pos,
                                    const float* u_neg, float* grad_v,
                                    float* grad_u, int B, int negs, int D,
                                    cudaStream_t stream) {
  SgnsArgs a{};
  a.v = v, a.u_pos = u_pos, a.u_neg = u_neg;
  return launch_any(a, grad_v, grad_u, B, negs, D, stream);
}

// Pull mode: the same gradients with the rows read from the tables through
// the ids (see the top of the file). Requires D ≥ 1; the replicas and hits
// only when hot > 0. Returns the launch's CUDA status.
cudaError_t sgns_pull_grads_launch(const float* win, const float* wctx,
                                   const int64_t* center, const int64_t* uids,
                                   const float* rep_in, const float* rep_ctx,
                                   int64_t* hits, long long rows,
                                   long long hot, float* grad_v,
                                   float* grad_u, int B, int negs, int D,
                                   cudaStream_t stream) {
  SgnsArgs a{};
  a.center = center, a.uids = uids, a.win = win, a.wctx = wctx;
  a.rep_in = rep_in, a.rep_ctx = rep_ctx, a.rows = rows;
  a.hot = hot > 0 ? hot : 0;
  a.hits = hot > 0 ? reinterpret_cast<unsigned long long*>(hits) : nullptr;
  return launch_any(a, grad_v, grad_u, B, negs, D, stream);
}
