// The port's four attention forward ops registered in C++, for serving an
// AOTInductor package from a process that runs libtorch alone.
//
// ops/attention.py, ops/qkv_attention.py and ops/chronos_attention.py register
// the same four ops as Python torch.library custom ops; a package compiled from
// the port's graph calls them through the dispatcher by name, so a process with
// no Python needs a registration of its own. This file is that registration:
//
//   TORCH_LIBRARY(MTT_NS)            the four schemas, character for character
//                                    those Python infers (SymInt, not int)
//   TORCH_LIBRARY_IMPL(MTT_NS, CPU)  the plain versions in ATen, the same ATen
//                                    ops in the same order as the Python plain
//                                    versions (plain_causal_attention,
//                                    plain_qkv_causal_attention,
//                                    plain_chronos_attention), output contiguous
//   TORCH_LIBRARY_IMPL(MTT_NS, CUDA) with -DMTT_WITH_CUDA: the checks of
//                                    ops/_kernels.py, then the C entry points
//                                    attention_fwd (csrc/attention_fwd.cu: B1f,
//                                    B2f, B3f) and chronos_attention_fwd
//                                    (csrc/chronos_attention.cu: B4f) of the
//                                    kernel library, linked, not recompiled, on
//                                    the current stream; each launch counted
//
// MTT_NS defaults to mtt, the Python ops' namespace: that build is for
// mtt_serve and must never load into a Python process that imported the op
// modules (the second registration of mtt::* raises). A build with
// -DMTT_NS=mtt_native registers the same ops under another name, so that a
// Python process can hold them against the Python ops (native.load_check_ops).
// Only the forwards: serving takes no gradient, as JAX's SavedModel carries none.
//
// mtt_ops_launches(name) reads an op's kernel launches, mtt_ops_reset_launches()
// sets them to 0; the plain versions count nothing.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>

#ifdef MTT_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                             void* out, int dtype, int B, int S, int H, int D, long long ld_in,
                             long long ld_out, void* stream);
extern "C" int chronos_attention_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                     int dtype, int B, int S, int H, int D, void* stream);
#endif

#ifndef MTT_NS
#define MTT_NS mtt
#endif
// One level of indirection, so that MTT_NS is expanded before the macros paste it.
#define MTT_LIBRARY(ns, m) TORCH_LIBRARY(ns, m)
#define MTT_LIBRARY_IMPL(ns, key, m) TORCH_LIBRARY_IMPL(ns, key, m)

namespace {

// The op names, in the order of the launch counters.
constexpr const char* kOps[4] = {"fused_causal_attention", "flash_causal_attention",
                                 "fused_qkv_causal_attention", "fused_chronos_attention"};
std::atomic<int64_t> g_launches[4];

constexpr float kNegInf = std::numeric_limits<float>::lowest();  // finfo(float32).min

at::Tensor f32(const at::Tensor& x) { return x.to(at::kFloat); }

// q k v: three (B, S, H, D) views of one (B, S, 3*H*D) projection.
std::array<at::Tensor, 3> split_heads(const at::Tensor& qkv, int64_t heads, int64_t dim) {
  const int64_t hd = heads * dim;
  std::array<at::Tensor, 3> out;
  for (int64_t i = 0; i < 3; ++i) out[i] = qkv.slice(-1, i * hd, (i + 1) * hd).unflatten(-1, {heads, dim});
  return out;
}

// (H, D) from the bias's head axis and qkv's width (ops/chronos_attention.py _geometry).
std::pair<int64_t, int64_t> chronos_geometry(const at::Tensor& qkv, const at::Tensor& bias) {
  TORCH_CHECK(bias.dim() == 3, "bias must be (H, S, S), got ", bias.sizes());
  const int64_t heads = bias.size(0), cols = qkv.size(-1);
  TORCH_CHECK(heads > 0 && cols % (3 * heads) == 0, "qkv has ", cols,
              " columns, not a multiple of 3*H = ", 3 * heads);
  return {heads, cols / (3 * heads)};
}

// --- The plain versions (CPU) ---------------------------------------------

// plain_causal_attention: fp32 logits of q pre-scaled, causal-future and padded
// keys at finfo.min, fp32 softmax rounded to q's dtype, fp32 PV product, one cast.
at::Tensor plain_causal(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                        const at::Tensor& key_valid) {
  const int64_t seq = q.size(1);
  at::Tensor logits = at::einsum("bqhd,bkhd->bhqk", {f32(q), f32(k)});
  at::Tensor causal = at::ones({seq, seq}, key_valid.options().dtype(at::kBool)).tril();
  at::Tensor mask = causal.unsqueeze(0).unsqueeze(0) &
                    key_valid.unsqueeze(1).unsqueeze(1);
  at::Tensor weights = at::softmax(logits.masked_fill(mask.logical_not(), kNegInf), -1).to(q.scalar_type());
  return at::einsum("bhqk,bkhd->bqhd", {f32(weights), f32(v)}).to(q.scalar_type());
}

at::Tensor causal_cpu(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                      const at::Tensor& key_valid) {
  return plain_causal(q, k, v, key_valid).contiguous();
}

at::Tensor qkv_cpu(const at::Tensor& qkv, const at::Tensor& key_valid, int64_t num_heads,
                   int64_t head_dim) {
  auto [q, k, v] = split_heads(qkv, num_heads, head_dim);
  return plain_causal(q, k, v, key_valid).flatten(-2).contiguous();
}

// plain_chronos_attention: q unscaled, fp32 logits plus the (H, S, S) bias, keys of
// another segment at finfo.min, fp32 softmax rounded to qkv's dtype, fp32 PV product.
at::Tensor chronos_cpu(const at::Tensor& qkv, const at::Tensor& seg, const at::Tensor& bias) {
  auto [heads, dim] = chronos_geometry(qkv, bias);
  auto [q, k, v] = split_heads(qkv, heads, dim);
  at::Tensor logits = at::einsum("bqhd,bkhd->bhqk", {f32(q), f32(k)}) + bias.unsqueeze(0);
  at::Tensor same = seg.unsqueeze(2) == seg.unsqueeze(1);
  at::Tensor w = at::softmax(logits.masked_fill(same.unsqueeze(1).logical_not(), kNegInf), -1)
                     .to(qkv.scalar_type());
  return at::einsum("bhqk,bkhd->bqhd", {f32(w), f32(v)}).flatten(-2).to(qkv.scalar_type()).contiguous();
}

#ifdef MTT_WITH_CUDA
// --- The kernels (CUDA) ----------------------------------------------------

int dtype_code(const at::Tensor& x) {
  if (x.scalar_type() == at::kFloat) return 0;
  if (x.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK(false, "unsupported dtype ", x.scalar_type(), "; the kernel takes float32 or bfloat16");
}

void check_device(const char* name, const at::Tensor& t, const at::Device& dev) {
  TORCH_CHECK(t.is_cuda() && t.device() == dev, name, " is on ", t.device(),
              "; the kernel needs every input on ", dev, " (CUDA)");
}

// A (B, S, H, D) view with unit-stride heads and rows row_stride apart (_check_heads_view).
void check_heads_view(const char* name, const at::Tensor& x, at::IntArrayRef shape, int64_t row_stride) {
  TORCH_CHECK(x.sizes() == shape, name, " has shape ", x.sizes(), ", expected ", shape);
  const int64_t s = shape[1], d = shape[3];
  TORCH_CHECK(x.stride(3) == 1 && x.stride(2) == d && x.stride(1) == row_stride, name, " strides ",
              x.strides(), " are not (S*ld, ld, D, 1) with ld=", row_stride, ", D=", d);
  TORCH_CHECK(shape[0] == 1 || x.stride(0) == s * row_stride, name, " batch stride ", x.stride(0),
              " != S*ld = ", s * row_stride);
}

// A side input (mask, segment ids, bias) of this dtype and shape, contiguous (_check_aux).
void check_aux(const char* name, const at::Tensor& t, at::ScalarType dtype, at::IntArrayRef shape) {
  TORCH_CHECK(t.scalar_type() == dtype && t.sizes() == shape, name, " must be ", dtype, " of shape ",
              shape, ", got ", t.scalar_type(), " ", t.sizes());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// The checks of _check_inputs on q, k, v views of one row stride; writes into out.
void launch_causal(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                   const at::Tensor& key_valid, const at::Tensor& out, int op) {
  TORCH_CHECK(q.dim() == 4, "q must be (B, S, H, D), got shape ", q.sizes());
  const at::Device dev = q.device();
  for (auto [name, t] : {std::pair<const char*, const at::Tensor&>{"q", q}, {"k", k}, {"v", v},
                         {"key_valid", key_valid}})
    check_device(name, t, dev);
  const int code = dtype_code(q);
  TORCH_CHECK(k.scalar_type() == q.scalar_type() && v.scalar_type() == q.scalar_type(),
              "k and v must have q's dtype ", q.scalar_type());
  const int64_t batch = q.size(0), seq = q.size(1), heads = q.size(2), dim = q.size(3);
  TORCH_CHECK(dim > 0 && dim <= 256, "head_dim ", dim, " outside the kernel's range 1..256");
  for (auto [name, t] : {std::pair<const char*, const at::Tensor&>{"q", q}, {"k", k}, {"v", v}})
    check_heads_view(name, t, q.sizes(), q.stride(1));
  check_aux("key_valid", key_valid, at::kBool, {batch, seq});
  check_heads_view("out", out, q.sizes(), out.stride(1));
  c10::cuda::CUDAGuard guard(dev);
  const int err = attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
                                out.data_ptr(), code, batch, seq, heads, dim, q.stride(1),
                                out.stride(1), c10::cuda::getCurrentCUDAStream(dev.index()).stream());
  TORCH_CHECK(err == 0, "attention_fwd launch failed with CUDA error ", err);
  ++g_launches[op];
}

at::Tensor causal_cuda(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                       const at::Tensor& key_valid, int op) {
  at::Tensor out = at::empty(q.sizes(), q.options());
  launch_causal(q, k, v, key_valid, out, op);
  return out;
}

at::Tensor fused_cuda(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                      const at::Tensor& key_valid) {
  return causal_cuda(q, k, v, key_valid, 0);
}

at::Tensor flash_cuda(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                      const at::Tensor& key_valid) {
  return causal_cuda(q, k, v, key_valid, 1);
}

at::Tensor qkv_cuda(const at::Tensor& qkv, const at::Tensor& key_valid, int64_t num_heads,
                    int64_t head_dim) {
  TORCH_CHECK(qkv.dim() == 3 && qkv.size(2) == 3 * num_heads * head_dim, "qkv must be (B, S, 3*H*D) with ",
              "H*D = ", num_heads * head_dim, ", got ", qkv.sizes());
  auto [q, k, v] = split_heads(qkv, num_heads, head_dim);
  at::Tensor out = at::empty({qkv.size(0), qkv.size(1), num_heads * head_dim}, qkv.options());
  launch_causal(q, k, v, key_valid, out.unflatten(-1, {num_heads, head_dim}), 2);
  return out;
}

at::Tensor chronos_cuda(const at::Tensor& qkv_in, const at::Tensor& seg, const at::Tensor& bias) {
  // The wgmma route (TMA) and the fp32 3xTF32 route (16-byte cp.async) read qkv from a 16-byte
  // aligned base (ops/_kernels.py _aligned16).
  const at::Tensor qkv = reinterpret_cast<uintptr_t>(qkv_in.data_ptr()) % 16 == 0 ? qkv_in : qkv_in.clone();
  TORCH_CHECK(qkv.dim() == 3, "qkv must be (B, S, 3*H*D), got ", qkv.sizes());
  auto [heads, dim] = chronos_geometry(qkv, bias);
  const at::Device dev = qkv.device();
  for (auto [name, t] : {std::pair<const char*, const at::Tensor&>{"qkv", qkv}, {"seg", seg}, {"bias", bias}})
    check_device(name, t, dev);
  const int code = dtype_code(qkv);
  TORCH_CHECK(qkv.is_contiguous(), "qkv must be contiguous");
  TORCH_CHECK(dim > 0 && dim <= 256, "head_dim ", dim, " outside the kernel's range 1..256");
  const int64_t batch = qkv.size(0), seq = qkv.size(1);
  check_aux("seg", seg, at::kInt, {batch, seq});
  check_aux("bias", bias, at::kFloat, {heads, seq, seq});
  at::Tensor out = at::empty({batch, seq, heads * dim}, qkv.options());
  c10::cuda::CUDAGuard guard(dev);
  const int err = chronos_attention_fwd(qkv.data_ptr(), seg.data_ptr(), bias.data_ptr(), out.data_ptr(), code,
                                        batch, seq, heads, dim,
                                        c10::cuda::getCurrentCUDAStream(dev.index()).stream());
  TORCH_CHECK(err == 0, "chronos_attention_fwd launch failed with CUDA error ", err);
  ++g_launches[3];
  return out;
}
#endif

}  // namespace

MTT_LIBRARY(MTT_NS, m) {
  m.def("fused_causal_attention(Tensor q, Tensor k, Tensor v, Tensor key_valid) -> Tensor");
  m.def("flash_causal_attention(Tensor q, Tensor k, Tensor v, Tensor key_valid) -> Tensor");
  m.def("fused_qkv_causal_attention(Tensor qkv, Tensor key_valid, SymInt num_heads, SymInt head_dim) -> Tensor");
  m.def("fused_chronos_attention(Tensor qkv, Tensor seg, Tensor bias) -> Tensor");
}

MTT_LIBRARY_IMPL(MTT_NS, CPU, m) {
  m.impl("fused_causal_attention", causal_cpu);
  m.impl("flash_causal_attention", causal_cpu);
  m.impl("fused_qkv_causal_attention", qkv_cpu);
  m.impl("fused_chronos_attention", chronos_cpu);
}

#ifdef MTT_WITH_CUDA
MTT_LIBRARY_IMPL(MTT_NS, CUDA, m) {
  m.impl("fused_causal_attention", fused_cuda);
  m.impl("flash_causal_attention", flash_cuda);
  m.impl("fused_qkv_causal_attention", qkv_cuda);
  m.impl("fused_chronos_attention", chronos_cuda);
}
#endif

extern "C" int64_t mtt_ops_launches(const char* op) {
  for (int i = 0; i < 4; ++i)
    if (std::strcmp(op, kOps[i]) == 0) return g_launches[i].load();
  return -1;
}

extern "C" void mtt_ops_reset_launches() {
  for (auto& n : g_launches) n.store(0);
}
