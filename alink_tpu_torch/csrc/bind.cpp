// Torch binding of the port's CUDA kernels, registered as torch.ops.alink_tpu_torch.*.
//
// This is the only source that includes PyTorch headers, and only the light
// ones (no torch/extension.h): the kernels' .cu files expose plain C++
// launchers. Each binding checks device, dtype, shape and contiguity, allocates
// the outputs with at::empty, launches on the current stream and checks the
// launch. The Python wrapper counts launches.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <limits>
#include <tuple>

size_t flash_block_update_smem_bytes(int K, int D);
cudaError_t flash_block_update_launch(int dtype, const void* q, const void* k,
                                      const void* v, const int32_t* kvalid,
                                      const int32_t* qk_ok, const float* o,
                                      const float* m, const float* l,
                                      float* o_out, float* m_out,
                                      float* l_out, int B, int H, int Q,
                                      int K, int D, float scale,
                                      cudaStream_t stream);

cudaError_t tree_histogram_launch(const int32_t* ids, const float* vals,
                                  float* out, int n, int d, int S,
                                  cudaStream_t stream);

int sgns_block_grads_max_dim();
cudaError_t sgns_block_grads_launch(const float* v, const float* u_pos,
                                    const float* u_neg, float* grad_v,
                                    float* grad_u, int B, int negs, int D,
                                    cudaStream_t stream);

namespace {

constexpr int64_t kMaxD = 128;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory, sm_90

void check_tensor(const at::Tensor& t, const char* name, at::ScalarType dtype,
                  at::IntArrayRef shape, const at::Tensor& ref) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == ref.device(), name, " is on ", t.device(),
              " but the first input is on ", ref.device());
  TORCH_CHECK(t.scalar_type() == dtype, name, " must be ", dtype, ", got ",
              t.scalar_type());
  TORCH_CHECK(t.sizes() == shape, name, " must have shape ", shape, ", got ",
              t.sizes());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> flash_block_update(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const at::Tensor& kvalid, const at::Tensor& qk_ok, const at::Tensor& o,
    const at::Tensor& m, const at::Tensor& l, double scale) {
  TORCH_CHECK(q.dim() == 4, "q must be (B, H, Q, D)");
  TORCH_CHECK(k.dim() == 4, "k must be (B, H, K, D)");
  const int64_t B = q.size(0), H = q.size(1), Q = q.size(2), D = q.size(3);
  const int64_t K = k.size(2);
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kBFloat16,
              "q, k, v must be float32 or bfloat16, got ", dt);
  TORCH_CHECK(B > 0 && H > 0 && Q > 0 && K > 0 && D > 0,
              "empty attention block");
  TORCH_CHECK(D <= kMaxD, "head dim ", D, " > ", kMaxD, " is not supported");
  TORCH_CHECK(B * H <= 65535, "B*H = ", B * H, " exceeds the grid limit");
  TORCH_CHECK(flash_block_update_smem_bytes(K, D) <= kMaxSmem, "K = ", K,
              " keys per block do not fit in shared memory");
  check_tensor(q, "q", dt, {B, H, Q, D}, q);
  check_tensor(k, "k", dt, {B, H, K, D}, q);
  check_tensor(v, "v", dt, {B, H, K, D}, q);
  check_tensor(kvalid, "kvalid", at::kInt, {B, K}, q);
  check_tensor(qk_ok, "qk_ok", at::kInt, {Q, K}, q);
  check_tensor(o, "o", at::kFloat, {B, H, Q, D}, q);
  check_tensor(m, "m", at::kFloat, {B, H, Q}, q);
  check_tensor(l, "l", at::kFloat, {B, H, Q}, q);

  c10::cuda::CUDAGuard guard(q.device());
  at::Tensor o_out = at::empty_like(o);
  at::Tensor m_out = at::empty_like(m);
  at::Tensor l_out = at::empty_like(l);
  C10_CUDA_CHECK(flash_block_update_launch(
      dt == at::kFloat ? 0 : 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
      kvalid.data_ptr<int32_t>(), qk_ok.data_ptr<int32_t>(),
      o.data_ptr<float>(), m.data_ptr<float>(), l.data_ptr<float>(),
      o_out.data_ptr<float>(), m_out.data_ptr<float>(),
      l_out.data_ptr<float>(), (int)B, (int)H, (int)Q, (int)K, (int)D,
      (float)scale, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {o_out, m_out, l_out};
}

at::Tensor tree_histogram(const at::Tensor& ids, const at::Tensor& vals,
                          int64_t num_segments) {
  TORCH_CHECK(ids.dim() == 2, "ids must be (n, d)");
  const int64_t n = ids.size(0), d = ids.size(1), S = num_segments;
  TORCH_CHECK(S > 0, "num_segments must be positive, got ", S);
  TORCH_CHECK(n * d <= (int64_t{1} << 30) &&
                  S * d <= std::numeric_limits<int32_t>::max(),
              "ids (", n, ", ", d,
              ") with ", S, " segments exceed the kernel's int32 indexing");
  check_tensor(ids, "ids", at::kInt, {n, d}, ids);
  check_tensor(vals, "vals", at::kFloat, {n}, ids);

  c10::cuda::CUDAGuard guard(ids.device());
  at::Tensor out = at::zeros({S, d}, vals.options());
  C10_CUDA_CHECK(tree_histogram_launch(
      ids.data_ptr<int32_t>(), vals.data_ptr<float>(), out.data_ptr<float>(),
      (int)n, (int)d, (int)S, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

std::tuple<at::Tensor, at::Tensor> sgns_block_grads(const at::Tensor& v,
                                                    const at::Tensor& u_pos,
                                                    const at::Tensor& u_neg) {
  TORCH_CHECK(v.dim() == 2, "v must be (B, D)");
  TORCH_CHECK(u_neg.dim() == 3, "u_neg must be (B, negs, D)");
  const int64_t B = v.size(0), D = v.size(1), negs = u_neg.size(1);
  TORCH_CHECK(D >= 1 && D <= sgns_block_grads_max_dim(), "row width D = ", D,
              " is outside [1, ", sgns_block_grads_max_dim(), "]");
  TORCH_CHECK((negs + 1) * B * D <= std::numeric_limits<int32_t>::max() &&
                  B <= std::numeric_limits<int32_t>::max() / 32,
              "block (", B, ", ", negs, ", ", D, ") is too large");
  check_tensor(v, "v", at::kFloat, {B, D}, v);
  check_tensor(u_pos, "u_pos", at::kFloat, {B, D}, v);
  check_tensor(u_neg, "u_neg", at::kFloat, {B, negs, D}, v);

  c10::cuda::CUDAGuard guard(v.device());
  at::Tensor grad_v = at::empty_like(v);
  at::Tensor grad_u = at::empty({(negs + 1) * B, D}, v.options());
  C10_CUDA_CHECK(sgns_block_grads_launch(
      v.data_ptr<float>(), u_pos.data_ptr<float>(), u_neg.data_ptr<float>(),
      grad_v.data_ptr<float>(), grad_u.data_ptr<float>(), (int)B, (int)negs,
      (int)D, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {grad_v, grad_u};
}

}  // namespace

TORCH_LIBRARY(alink_tpu_torch, m) {
  m.def(
      "flash_block_update(Tensor q, Tensor k, Tensor v, Tensor kvalid, "
      "Tensor qk_ok, Tensor o, Tensor m, Tensor l, float scale) "
      "-> (Tensor, Tensor, Tensor)");
  m.def("tree_histogram(Tensor ids, Tensor vals, int num_segments) -> Tensor");
  m.def("sgns_block_grads(Tensor v, Tensor u_pos, Tensor u_neg) "
        "-> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(alink_tpu_torch, CUDA, m) {
  m.impl("flash_block_update", &flash_block_update);
  m.impl("tree_histogram", &tree_histogram);
  m.impl("sgns_block_grads", &sgns_block_grads);
}
