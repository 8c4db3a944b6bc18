// flash_block_update for Hopper (sm_90a): one online-softmax step of
// attention over one K/V block.
//
// Replaces the Pallas TPU kernel alink_tpu/dl/attn_pallas.py::flash_block_update
// (pl.pallas_call at attn_pallas.py:114). Same update as the plain version
// alink_tpu_torch/dl/attn_cuda.py::flash_block_update_ref:
//   s  = q·kᵀ (rounded to the input type) · scale
//   s  = -1e30 where kvalid == 0 or qk_ok == 0
//   m' = max(m, rowmax s);  corr = exp(max(m − m', −1e30))
//   p  = exp(s − m');       l' = l·corr + Σp
//   o' = o·corr + round(round(p)·v)       (round = to the input type)
//
// Layout: q (B,H,Q,D); k, v (B,H,K,D) in fp32 or bf16; kvalid (B,K) and
// qk_ok (Q,K) int32; o (B,H,Q,D), m and l (B,H,Q) fp32. All contiguous.
//
// Design. The TPU kernel gave one grid step to each (b, h) and padded Q to 8
// sublanes and K, D to 128 lanes. Here one CTA of 256 threads owns one
// (b, h, 64-row Q tile), so B·H·⌈Q/64⌉ CTAs run at once. Each query row has
// four threads. The CTA stages its Q tile once and then walks the block's
// keys in chunks of 64 staged in shared memory: pass 1 forms the scores for
// all K keys into a shared (64 × K) tile and keeps the running row max in
// registers; pass 2 turns the tile into p in place and accumulates p·v in
// registers. Ragged edges (Q not a multiple of 64, any K, any D ≤ 128) are
// masked in the kernel; nothing is padded in memory. Products are fp32 FMA
// loops: no tensor cores yet.
//
// Bound. At the serving shape (B=32, H=12, Q=512, K=128, D=64, bf16 inputs)
// one call needs 6.4 GFLOP but moves 141.8 MB, 71 % of it the fp32 o
// accumulator read and written once per K/V block. At the H100's
// 3.35 TB/s that is ≥ 42.3 µs, against 6.5 µs of bf16 tensor-core work:
// the function is memory-bound, and the per-block interface fixes those
// bytes. This kernel reads each input once and writes each output once,
// the o round trip through shared memory so that both are coalesced. Its
// own limit is the shared-memory loads that feed the FMA loops (about one
// per FMA); fusing the K-block loop into the kernel (o kept on chip) and
// tensor cores are the redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int KC = 64;          // keys per staged chunk
constexpr int TPR = 4;          // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int KPT = KC / TPR;   // scores per thread per chunk
constexpr float NEG = -1e30f;   // the reference's finite mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// round x to the input type T and back to fp32 (identity for fp32)
template <typename T> __device__ __forceinline__ float round_t(float x);
template <> __device__ __forceinline__ float round_t<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// stage rows [r0, r0 + nrows) of a (rows, D) matrix into smem with row
// stride ld (D + 1, against bank conflicts); rows past nvalid become 0
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int nrows,
                                      int nvalid, int D, int ld) {
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    dst[r * ld + c] = r < nvalid ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
}

// DPT: output columns per thread (D ≤ TPR · DPT)
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_block_update_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int32_t* __restrict__ kvalid,
                          const int32_t* __restrict__ qk_ok,
                          const float* __restrict__ o_in,
                          const float* __restrict__ m_in,
                          const float* __restrict__ l_in,
                          float* __restrict__ o_out, float* __restrict__ m_out,
                          float* __restrict__ l_out, int H, int Q, int K,
                          int D, float scale) {
  extern __shared__ float smem[];
  const int ldd = D + 1;
  const int lds = K + 1;
  float* q_s = smem;                 // BQ × ldd: the Q tile, later p·v
  float* kv_s = q_s + BQ * ldd;      // KC × ldd: one K or V chunk
  float* s_s = kv_s + KC * ldd;      // BQ × lds: scores, then p
  float* corr_s = s_s + BQ * lds;    // BQ

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  const int r = threadIdx.x / TPR;   // this thread's row in the tile
  const int g = threadIdx.x % TPR;   // and its lane within the row
  const int qi = q0 + r;
  const bool row_ok = r < nq;
  const size_t kv0 = (size_t)bh * K * D;
  const size_t row0 = (size_t)bh * Q;

  stage(q_s, q + (row0 + q0) * D, BQ, nq, D, ldd);

  // pass 1: scores of this row against all K keys, and their max
  float mx = __int_as_float(0xff800000);  // -inf
  for (int c0 = 0; c0 < K; c0 += KC) {
    const int kc = min(KC, K - c0);
    __syncthreads();                 // Q staged / previous chunk consumed
    stage(kv_s, k + kv0 + (size_t)c0 * D, KC, kc, D, ldd);
    __syncthreads();
    float acc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) acc[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[r * ldd + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        acc[j] = fmaf(qv, kv_s[(g + TPR * j) * ldd + d], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = g + TPR * j;
      if (c < kc) {
        const int kk = c0 + c;
        float s = round_t<T>(acc[j]) * scale;
        const bool ok = kvalid[(size_t)b * K + kk] > 0 &&
                        (!row_ok || qk_ok[(size_t)qi * K + kk] > 0);
        s = ok ? s : NEG;
        s_s[r * lds + kk] = s;
        mx = fmaxf(mx, s);
      }
    }
  }
  // the four lanes of a row are adjacent in the warp
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));

  const float m_old = row_ok ? m_in[row0 + qi] : 0.f;
  const float m_new = fmaxf(m_old, mx);
  const float corr = expf(fmaxf(m_old - m_new, NEG));

  // p = exp(s − m'): l sums it in fp32, p·v takes it rounded to T. Each
  // thread rewrites exactly the scores it wrote in pass 1.
  float lsum = 0.f;
  for (int kk = g; kk < K; kk += TPR) {
    const float p = expf(s_s[r * lds + kk] - m_new);
    lsum += p;
    s_s[r * lds + kk] = round_t<T>(p);
  }
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);

  // pass 2: p·v for this thread's columns d = g + TPR·j
  float acc_o[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc_o[j] = 0.f;
  for (int c0 = 0; c0 < K; c0 += KC) {
    const int kc = min(KC, K - c0);
    __syncthreads();                 // p written / previous chunk consumed
    stage(kv_s, v + kv0 + (size_t)c0 * D, KC, kc, D, ldd);
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
      const float p = s_s[r * lds + c0 + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (g + TPR * j < D)
          acc_o[j] = fmaf(p, kv_s[c * ldd + g + TPR * j], acc_o[j]);
    }
  }

  // epilogue: p·v (rounded to T, as the reference's matmul output is)
  // through smem, so that the o read-modify-write is coalesced
#pragma unroll
  for (int j = 0; j < DPT; ++j)
    if (g + TPR * j < D) q_s[r * ldd + g + TPR * j] = round_t<T>(acc_o[j]);
  if (g == 0) corr_s[r] = corr;
  if (row_ok && g == 0) {
    m_out[row0 + qi] = m_new;
    l_out[row0 + qi] = __fadd_rn(__fmul_rn(l_in[row0 + qi], corr), lsum);
  }
  __syncthreads();
  const size_t o0 = (row0 + q0) * D;
  for (int i = threadIdx.x; i < nq * D; i += THREADS) {
    const int rr = i / D, dd = i - rr * D;
    o_out[o0 + i] =
        __fadd_rn(__fmul_rn(o_in[o0 + i], corr_s[rr]), q_s[rr * ldd + dd]);
  }
}

template <typename T, int DPT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int32_t* kvalid, const int32_t* qk_ok,
                         const float* o, const float* m, const float* l,
                         float* o_out, float* m_out, float* l_out, int B,
                         int H, int Q, int K, int D, float scale,
                         size_t smem, cudaStream_t stream) {
  auto kern = flash_block_update_kernel<T, DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kvalid, qk_ok, o, m, l, o_out, m_out, l_out,
      H, Q, K, D, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for a (K, D) block, in bytes.
size_t flash_block_update_smem_bytes(int K, int D) {
  return sizeof(float) *
         ((size_t)(BQ + KC) * (D + 1) + (size_t)BQ * (K + 1) + BQ);
}

// dtype: 0 = fp32, 1 = bf16. Returns the launch's CUDA status.
cudaError_t flash_block_update_launch(int dtype, const void* q, const void* k,
                                      const void* v, const int32_t* kvalid,
                                      const int32_t* qk_ok, const float* o,
                                      const float* m, const float* l,
                                      float* o_out, float* m_out,
                                      float* l_out, int B, int H, int Q,
                                      int K, int D, float scale,
                                      cudaStream_t stream) {
  const size_t smem = flash_block_update_smem_bytes(K, D);
#define FBU_LAUNCH(T, DPT)                                                   \
  return launch_typed<T, DPT>(q, k, v, kvalid, qk_ok, o, m, l, o_out, m_out, \
                              l_out, B, H, Q, K, D, scale, smem, stream)
  if (dtype == 0) {
    if (D <= 16 * TPR) FBU_LAUNCH(float, 16);
    FBU_LAUNCH(float, 32);
  }
  if (D <= 16 * TPR) FBU_LAUNCH(__nv_bfloat16, 16);
  FBU_LAUNCH(__nv_bfloat16, 32);
#undef FBU_LAUNCH
}
