// Torch binding of the port's CUDA kernels, registered as torch.ops.alink_tpu_torch.*.
//
// This is the only source that includes PyTorch headers, and only the light
// ones (no torch/extension.h): the kernels' .cu files expose plain C++
// launchers. Each binding checks device, dtype, shape and layout (contiguity,
// or for attention's q, k, v the strides the kernel reads them by), allocates
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

#include "flash_block_update.h"

#include <cstdint>
#include <limits>
#include <tuple>
#include <utility>

struct HistVals {
  const float* p[3];
};
int tree_histogram_max_nodes();
long long tree_histogram_scratch(int n, int L);
cudaError_t tree_histogram_launch(const void* bins, int bin_bytes,
                                  const int32_t* node, HistVals vals, int C,
                                  float* out, int* scratch, int n, int d,
                                  int L, int B, cudaStream_t stream);

cudaError_t sgns_block_grads_launch(const float* v, const float* u_pos,
                                    const float* u_neg, float* grad_v,
                                    float* grad_u, int B, int negs, int D,
                                    cudaStream_t stream);
cudaError_t sgns_pull_grads_launch(const float* win, const float* wctx,
                                   const int64_t* center, const int64_t* uids,
                                   const float* rep_in, const float* rep_ctx,
                                   int64_t* hits, long long rows,
                                   long long hot, float* grad_v,
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

// q, k, v of one attention call: one dtype and device, D with stride 1;
// bf16 rows are copied in 16-byte pieces, so every other stride and the
// data pointers must be 16-byte aligned
int check_qkv(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v) {
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == at::kFloat || dt == at::kBFloat16,
              "q, k, v must be float32 or bfloat16, got ", dt);
  const int64_t D = q.size(3);
  TORCH_CHECK(D > 0 && D <= kMaxD, "head dim ", D, " is outside [1, ", kMaxD,
              "]");
  TORCH_CHECK(dt == at::kFloat || D % 8 == 0, "bf16 head dim ", D,
              " must be a multiple of 8");
  const std::pair<const at::Tensor*, const char*> ts[] = {
      {&q, "q"}, {&k, "k"}, {&v, "v"}};
  for (const auto& [t, name] : ts) {
    TORCH_CHECK(t->is_cuda(), name, " must be a CUDA tensor");
    TORCH_CHECK(t->device() == q.device(), name, " is on ", t->device(),
                " but q is on ", q.device());
    TORCH_CHECK(t->scalar_type() == dt, name, " must be ", dt, ", got ",
                t->scalar_type());
    TORCH_CHECK(t->dim() == 4 && t->size(3) == D, name,
                " must be 4-d with head dim ", D, ", got ", t->sizes());
    TORCH_CHECK(t->stride(3) == 1, name, ": the head dim must have stride 1");
    if (dt == at::kBFloat16) {
      const int64_t es = t->element_size();
      for (int i = 0; i < 3; ++i)
        TORCH_CHECK(t->stride(i) * es % 16 == 0, name, ": stride ",
                    t->stride(i), " of dim ", i, " is not 16-byte aligned");
      TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0, name,
                  ": data pointer is not 16-byte aligned");
    }
  }
  return dt == at::kFloat ? 0 : 1;
}

void check_grid(int64_t B, int64_t H, int64_t Q, int64_t K) {
  TORCH_CHECK(B > 0 && H > 0 && Q > 0 && K > 0, "empty attention");
  TORCH_CHECK(B * H <= 65535, "B*H = ", B * H, " exceeds the grid limit");
  TORCH_CHECK(Q <= std::numeric_limits<int32_t>::max() / 2 &&
                  K <= std::numeric_limits<int32_t>::max() / 2,
              "sequence too long");
}

void launch(int dtype, const FlashArgs& a, const at::Tensor& q) {
  TORCH_CHECK(flash_smem_bytes(dtype, a.block, a.D) <= kMaxSmem, "blocks of ",
              a.block, " keys do not fit in shared memory");
  c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(
      flash_launch(dtype, a, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// One online-softmax step over one K/V block (nb = 1): q (B,H,Q,D), k and v
// (B,H,K,D) by strides; kvalid (B,K), qk_ok (Q,K) int32; o (B,H,Q,D), m and
// l (B,H,Q) fp32, contiguous.
std::tuple<at::Tensor, at::Tensor, at::Tensor> flash_block_update(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const at::Tensor& kvalid, const at::Tensor& qk_ok, const at::Tensor& o,
    const at::Tensor& m, const at::Tensor& l, double scale) {
  TORCH_CHECK(q.dim() == 4, "q must be (B, H, Q, D)");
  TORCH_CHECK(k.dim() == 4, "k must be (B, H, K, D)");
  const int dtype = check_qkv(q, k, v);
  const int64_t B = q.size(0), H = q.size(1), Q = q.size(2), D = q.size(3);
  const int64_t K = k.size(2);
  check_grid(B, H, Q, K);
  TORCH_CHECK(k.sizes() == at::IntArrayRef({B, H, K, D}) &&
                  v.sizes() == k.sizes(),
              "k and v must be (", B, ", ", H, ", K, ", D, "), got ",
              k.sizes(), " and ", v.sizes());
  check_tensor(kvalid, "kvalid", at::kInt, {B, K}, q);
  check_tensor(qk_ok, "qk_ok", at::kInt, {Q, K}, q);
  check_tensor(o, "o", at::kFloat, {B, H, Q, D}, q);
  check_tensor(m, "m", at::kFloat, {B, H, Q}, q);
  check_tensor(l, "l", at::kFloat, {B, H, Q}, q);

  at::Tensor o_out = at::empty_like(o);
  at::Tensor m_out = at::empty_like(m);
  at::Tensor l_out = at::empty_like(l);
  FlashArgs a{};
  a.q = q.data_ptr();
  a.k = k.data_ptr();
  a.v = v.data_ptr();
  a.q_sb = q.stride(0), a.q_sh = q.stride(1), a.q_ss = q.stride(2);
  a.k_sb = k.stride(0), a.k_sh = k.stride(1), a.k_ss = k.stride(2);
  a.v_sb = v.stride(0), a.v_sh = v.stride(1), a.v_ss = v.stride(2);
  a.kvalid = kvalid.data_ptr<int32_t>();
  a.qk_ok = qk_ok.data_ptr<int32_t>();
  a.o_in = o.data_ptr<float>();
  a.m_in = m.data_ptr<float>();
  a.l_in = l.data_ptr<float>();
  a.o_out = o_out.data_ptr<float>();
  a.m_out = m_out.data_ptr<float>();
  a.l_out = l_out.data_ptr<float>();
  a.B = (int)B, a.H = (int)H, a.Q = (int)Q, a.K = (int)K, a.D = (int)D;
  a.block = (int)K, a.nb = 1;
  a.scale = (float)scale;
  launch(dtype, a, q);
  return {o_out, m_out, l_out};
}

// The whole attention call: q (B,Sq,H,D), k and v (B,Sk,H,D) by strides,
// kmask (B,Sk) int32 or none; K/V in blocks of block_size under the online
// softmax. Returns o / l as (B,Sq,H,D) in q's dtype.
at::Tensor flash_blockwise(const at::Tensor& q, const at::Tensor& k,
                           const at::Tensor& v,
                           const c10::optional<at::Tensor>& kmask,
                           int64_t block_size, bool causal, double scale) {
  TORCH_CHECK(q.dim() == 4, "q must be (B, S, H, D)");
  TORCH_CHECK(k.dim() == 4, "k must be (B, S, H, D)");
  const int dtype = check_qkv(q, k, v);
  const int64_t B = q.size(0), Sq = q.size(1), H = q.size(2), D = q.size(3);
  const int64_t Sk = k.size(1);
  check_grid(B, H, Sq, Sk);
  TORCH_CHECK(k.sizes() == at::IntArrayRef({B, Sk, H, D}) &&
                  v.sizes() == k.sizes(),
              "k and v must be (", B, ", S, ", H, ", ", D, "), got ",
              k.sizes(), " and ", v.sizes());
  TORCH_CHECK(block_size > 0 && block_size <= std::numeric_limits<int32_t>::max() / 2,
              "block_size must be positive, got ", block_size);
  const int64_t nb = (Sk + block_size - 1) / block_size;
  TORCH_CHECK(nb * block_size <= std::numeric_limits<int32_t>::max() / 2,
              "sequence too long");
  if (kmask.has_value()) check_tensor(*kmask, "kmask", at::kInt, {B, Sk}, q);

  at::Tensor out = at::empty({B, Sq, H, D}, q.options());
  FlashArgs a{};
  a.q = q.data_ptr();
  a.k = k.data_ptr();
  a.v = v.data_ptr();
  a.q_sb = q.stride(0), a.q_ss = q.stride(1), a.q_sh = q.stride(2);
  a.k_sb = k.stride(0), a.k_ss = k.stride(1), a.k_sh = k.stride(2);
  a.v_sb = v.stride(0), a.v_ss = v.stride(1), a.v_sh = v.stride(2);
  a.kvalid = kmask.has_value() ? kmask->data_ptr<int32_t>() : nullptr;
  a.causal = causal ? 1 : 0;
  a.out = out.data_ptr();
  a.B = (int)B, a.H = (int)H, a.Q = (int)Sq, a.K = (int)Sk, a.D = (int)D;
  a.block = (int)block_size, a.nb = (int)nb;
  a.scale = (float)scale;
  launch(dtype, a, q);
  return out;
}

// One level's histograms: bins (n, d) uint8 or int32, node (n,) int32, vals
// 1..3 channels of (n,) fp32. Returns (C, L, d, B) fp32.
at::Tensor tree_histogram(const at::Tensor& bins, const at::Tensor& node,
                          at::TensorList vals, int64_t num_nodes,
                          int64_t num_bins) {
  TORCH_CHECK(bins.dim() == 2, "bins must be (n, d)");
  const int64_t n = bins.size(0), d = bins.size(1);
  const int64_t L = num_nodes, B = num_bins, C = (int64_t)vals.size();
  TORCH_CHECK(bins.scalar_type() == at::kByte || bins.scalar_type() == at::kInt,
              "bins must be uint8 or int32, got ", bins.scalar_type());
  check_tensor(bins, "bins", bins.scalar_type(), {n, d}, bins);
  check_tensor(node, "node", at::kInt, {n}, bins);
  TORCH_CHECK(C >= 1 && C <= 3, "1 to 3 value channels, got ", C);
  for (const auto& v : vals) check_tensor(v, "vals", at::kFloat, {n}, bins);
  TORCH_CHECK(L >= 1 && L <= tree_histogram_max_nodes() && B >= 1,
              "num_nodes must lie in [1, ", tree_histogram_max_nodes(),
              "] and num_bins be positive, got ", L, " and ", B);
  TORCH_CHECK(d <= 65535LL * 128, "d = ", d, " features exceed the grid");
  TORCH_CHECK(n <= std::numeric_limits<int32_t>::max() / 2 &&
                  L * B <= std::numeric_limits<int32_t>::max(),
              "(n, L·B) = (", n, ", ", L * B,
              ") exceed the kernel's int32 indexing");

  c10::cuda::CUDAGuard guard(bins.device());
  const long long scratch_ints = tree_histogram_scratch((int)n, (int)L);
  TORCH_CHECK(scratch_ints > 0, "cannot query the device's SM count");
  at::Tensor out = at::zeros({C, L, d, B}, vals[0].options());
  at::Tensor scratch = at::empty({scratch_ints}, node.options());
  HistVals hv{};
  for (int64_t c = 0; c < C; ++c) hv.p[c] = vals[c].data_ptr<float>();
  C10_CUDA_CHECK(tree_histogram_launch(
      bins.data_ptr(), (int)bins.element_size(), node.data_ptr<int32_t>(), hv,
      (int)C, out.data_ptr<float>(), scratch.data_ptr<int32_t>(), (int)n,
      (int)d, (int)L, (int)B, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

void check_sgns_block(int64_t B, int64_t negs, int64_t D) {
  TORCH_CHECK(D >= 1, "row width D = ", D, " must be positive");
  TORCH_CHECK((negs + 1) * B * D <= std::numeric_limits<int32_t>::max() &&
                  B <= std::numeric_limits<int32_t>::max() / 32,
              "block (", B, ", ", negs, ", ", D, ") is too large");
}

std::tuple<at::Tensor, at::Tensor> sgns_block_grads(const at::Tensor& v,
                                                    const at::Tensor& u_pos,
                                                    const at::Tensor& u_neg) {
  TORCH_CHECK(v.dim() == 2, "v must be (B, D)");
  TORCH_CHECK(u_neg.dim() == 3, "u_neg must be (B, negs, D)");
  const int64_t B = v.size(0), D = v.size(1), negs = u_neg.size(1);
  check_sgns_block(B, negs, D);
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



// The step's pull and gradients in one launch: win and wctx (rows, D) fp32
// tables (one tensor when tied), center (B,) and uids ((negs+1)·B,) int64;
// when hot > 0 the replicas rep_in and rep_ctx (hot, D) and the 0-dim int64
// hit counter, which the launch adds the batch's hot ids to.
std::tuple<at::Tensor, at::Tensor> sgns_pull_grads(
    const at::Tensor& win, const at::Tensor& wctx, const at::Tensor& center,
    const at::Tensor& uids, const c10::optional<at::Tensor>& rep_in,
    const c10::optional<at::Tensor>& rep_ctx,
    const c10::optional<at::Tensor>& hits, int64_t negs, int64_t rows,
    int64_t hot) {
  TORCH_CHECK(win.dim() == 2 && wctx.dim() == 2, "tables must be (rows, D)");
  TORCH_CHECK(center.dim() == 1, "center must be (B,)");
  const int64_t B = center.size(0), D = win.size(1);
  TORCH_CHECK(negs >= 0, "negs must be non-negative, got ", negs);
  check_sgns_block(B, negs, D);
  TORCH_CHECK(rows >= 0 && rows <= win.size(0) && rows <= wctx.size(0),
              "rows = ", rows, " exceeds a table's ", win.size(0), " / ",
              wctx.size(0), " rows");
  check_tensor(win, "win", at::kFloat, {win.size(0), D}, win);
  check_tensor(wctx, "wctx", at::kFloat, {wctx.size(0), D}, win);
  check_tensor(center, "center", at::kLong, {B}, win);
  check_tensor(uids, "uids", at::kLong, {(negs + 1) * B}, win);
  const float* rin = nullptr;
  const float* rctx = nullptr;
  int64_t* hp = nullptr;
  if (hot > 0) {
    TORCH_CHECK(rep_in.has_value() && rep_ctx.has_value() && hits.has_value(),
                "hot > 0 needs rep_in, rep_ctx and hits");
    check_tensor(*rep_in, "rep_in", at::kFloat, {hot, D}, win);
    check_tensor(*rep_ctx, "rep_ctx", at::kFloat, {hot, D}, win);
    check_tensor(*hits, "hits", at::kLong, {}, win);
    rin = rep_in->data_ptr<float>();
    rctx = rep_ctx->data_ptr<float>();
    hp = hits->data_ptr<int64_t>();
  }

  c10::cuda::CUDAGuard guard(win.device());
  at::Tensor grad_v = at::empty({B, D}, win.options());
  at::Tensor grad_u = at::empty({(negs + 1) * B, D}, win.options());
  C10_CUDA_CHECK(sgns_pull_grads_launch(
      win.data_ptr<float>(), wctx.data_ptr<float>(),
      center.data_ptr<int64_t>(), uids.data_ptr<int64_t>(), rin, rctx, hp,
      rows, hot, grad_v.data_ptr<float>(), grad_u.data_ptr<float>(), (int)B,
      (int)negs, (int)D, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {grad_v, grad_u};
}

}  // namespace

TORCH_LIBRARY(alink_tpu_torch, m) {
  m.def(
      "flash_block_update(Tensor q, Tensor k, Tensor v, Tensor kvalid, "
      "Tensor qk_ok, Tensor o, Tensor m, Tensor l, float scale) "
      "-> (Tensor, Tensor, Tensor)");
  m.def(
      "flash_blockwise(Tensor q, Tensor k, Tensor v, Tensor? kmask, "
      "int block_size, bool causal, float scale) -> Tensor");
  m.def(
      "tree_histogram(Tensor bins, Tensor node, Tensor[] vals, int num_nodes, "
      "int num_bins) -> Tensor");
  m.def("sgns_block_grads(Tensor v, Tensor u_pos, Tensor u_neg) "
        "-> (Tensor, Tensor)");
  m.def(
      "sgns_pull_grads(Tensor win, Tensor wctx, Tensor center, Tensor uids, "
      "Tensor? rep_in, Tensor? rep_ctx, Tensor? hits, int negs, int rows, "
      "int hot) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(alink_tpu_torch, CUDA, m) {
  m.impl("flash_block_update", &flash_block_update);
  m.impl("flash_blockwise", &flash_blockwise);
  m.impl("tree_histogram", &tree_histogram);
  m.impl("sgns_block_grads", &sgns_block_grads);
  m.impl("sgns_pull_grads", &sgns_pull_grads);
}
