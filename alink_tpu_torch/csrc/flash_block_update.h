// Launch arguments of the flash kernels (csrc/flash_block_update.cu), shared
// with the torch binding (csrc/bind.cpp).
#pragma once

#include <cuda_runtime_api.h>
#include <cstddef>
#include <cstdint>

struct FlashArgs {
  // q (·, Q, ·, D), k and v (·, K, ·, D) in fp32 or bf16, addressed by
  // element strides over batch, head and sequence; D has stride 1
  const void* q;
  const void* k;
  const void* v;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  // (B, K) keys: 1 = valid; null = all valid
  const int32_t* kvalid;
  // (Q, block) per-pair mask, 1 = allowed; null = all allowed
  const int32_t* qk_ok;
  int causal;  // q_pos >= key index, over the whole sequence
  // carried state (B, H, Q, D) and (B, H, Q) in fp32; null = empty state
  const float* o_in;
  const float* m_in;
  const float* l_in;
  // per-block entry: the updated state, same layout
  float* o_out;
  float* m_out;
  float* l_out;
  // fused entry (o_out null): o / max(l, 1e-30) in the input type,
  // contiguous (B, Q, H, D)
  void* out;
  int B, H, Q;
  int K;       // keys with data; keys in [K, nb·block) are zero padding
  int D;
  int block;   // keys per online-softmax step
  int nb;      // steps
  float scale;
};

// dtype: 0 = fp32, 1 = bf16
size_t flash_smem_bytes(int dtype, int block, int D);
cudaError_t flash_launch(int dtype, const FlashArgs& a, cudaStream_t stream);
