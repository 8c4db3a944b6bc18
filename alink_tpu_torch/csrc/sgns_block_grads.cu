// sgns_block_grads for Hopper (sm_90a): the skip-gram negative-sampling
// gradients of one block of center rows, the device-local step between the
// APS pull and push of the Word2Vec trainer.
//
// Replaces the Pallas TPU kernel
// alink_tpu/embedding/sgns_pallas.py::sgns_block_grads (pl.pallas_call at
// sgns_pallas.py:100). Same function as the plain version
// alink_tpu_torch/embedding/sgns_cuda.py::sgns_block_grads_ref:
//   g_pos = σ(v_b·u_pos_b) − 1,   g_n = σ(v_b·u_neg_{b,n})
//   grad_v[b]              = g_pos·u_pos_b + Σ_n g_n·u_neg_{b,n}
//   grad_u[b]              = g_pos·v_b                 (context rows)
//   grad_u[B + b·negs + n] = g_n·v_b                   (negatives, b-major)
// grad_u's row order is the id order the push consumes,
// concat(ctx, neg.reshape(-1)).
//
// Layout: v (B, D), u_pos (B, D), u_neg (B, negs, D) fp32 in; grad_v (B, D),
// grad_u ((negs+1)·B, D) fp32 out; all contiguous. Any B, any D ≤ 1024
// (ragged D needs no padding), any negs ≥ 0.
//
// Design. The TPU kernel tiled 8 rows × 128 lanes in VMEM, walked the
// negatives on a sequential grid axis and revisited the grad_v block to
// accumulate it: artefacts of VMEM and of a grid that runs in order. Here
// one warp owns one row b from start to end. Each lane keeps ceil(D/32)
// elements of v_b in registers (lane l holds d = l, l+32, …, so a warp's
// loads and stores are coalesced), loads one context or negative row at a
// time, reduces its dot product by warp shuffles (every lane ends with the
// sum), takes the sigmoid in fp32 with expf (not __expf, whose error would
// eat into the atol), writes that row of grad_u straight to its final place
// and adds g·u into grad_v, which stays in registers in the reference
// kernel's order g_pos·u_pos + g_0·u_0 + g_1·u_1 + … and is written once.
// No (B, negs, D) intermediate and no concatenation touch device memory.
//
// Bound. Each input row is read once and each output row written once:
// at the default (B, negs, D) = (1024, 5, 100), 2.87 MB in and 2.87 MB out,
// 1.71 µs at 3.35 TB/s, against about 2.5 MFLOP — memory-bound, and short
// enough that the launch costs as much. This simple form keeps one row in
// flight per warp; fusing the gathers from the tables into it is the
// redesign (ROADMAP B3).

#include <cuda_runtime.h>
#include <cstdint>

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

// VPL: elements of a row per lane, ceil(D/32) rounded up to the instance.
template <int VPL>
__global__ void __launch_bounds__(THREADS)
sgns_block_grads_kernel(const float* __restrict__ v,
                        const float* __restrict__ u_pos,
                        const float* __restrict__ u_neg,
                        float* __restrict__ grad_v,
                        float* __restrict__ grad_u, int B, int negs, int D) {
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;   // whole warps leave together: shuffles stay full

  float vr[VPL], ur[VPL], acc[VPL];
  const float* vb = v + (size_t)b * D;
  const float* up = u_pos + (size_t)b * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane + 32 * i;
    vr[i] = d < D ? vb[d] : 0.f;
    ur[i] = d < D ? up[d] : 0.f;
  }

  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) dot += vr[i] * ur[i];
  const float g_pos = sigmoid(warp_sum(dot)) - 1.0f;
  float* gu = grad_u + (size_t)b * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane + 32 * i;
    acc[i] = g_pos * ur[i];
    if (d < D) gu[d] = g_pos * vr[i];
  }

  for (int n = 0; n < negs; ++n) {
    const float* un = u_neg + ((size_t)b * negs + n) * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int d = lane + 32 * i;
      ur[i] = d < D ? un[d] : 0.f;
    }
    dot = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) dot += vr[i] * ur[i];
    const float g = sigmoid(warp_sum(dot));
    gu = grad_u + ((size_t)B + (size_t)b * negs + n) * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int d = lane + 32 * i;
      acc[i] += g * ur[i];
      if (d < D) gu[d] = g * vr[i];
    }
  }

  float* gv = grad_v + (size_t)b * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) gv[d] = acc[i];
  }
}

template <int VPL>
cudaError_t launch(const float* v, const float* u_pos, const float* u_neg,
                   float* grad_v, float* grad_u, int B, int negs, int D,
                   cudaStream_t stream) {
  const int blocks = (B + WARPS - 1) / WARPS;
  sgns_block_grads_kernel<VPL><<<blocks, THREADS, 0, stream>>>(
      v, u_pos, u_neg, grad_v, grad_u, B, negs, D);
  return cudaGetLastError();
}

}  // namespace

// Largest row width the kernel takes.
int sgns_block_grads_max_dim() { return 32 * 32; }

// Writes grad_v (B, D) and grad_u ((negs+1)·B, D) for one block. Requires
// 1 ≤ D ≤ 1024. Returns the launch's CUDA status.
cudaError_t sgns_block_grads_launch(const float* v, const float* u_pos,
                                    const float* u_neg, float* grad_v,
                                    float* grad_u, int B, int negs, int D,
                                    cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const int vpl = (D + 31) / 32;
  if (vpl <= 1) return launch<1>(v, u_pos, u_neg, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 2) return launch<2>(v, u_pos, u_neg, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 4) return launch<4>(v, u_pos, u_neg, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 8) return launch<8>(v, u_pos, u_neg, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 16) return launch<16>(v, u_pos, u_neg, grad_v, grad_u, B, negs, D, stream);
  if (vpl <= 32) return launch<32>(v, u_pos, u_neg, grad_v, grad_u, B, negs, D, stream);
  return cudaErrorInvalidValue;
}
