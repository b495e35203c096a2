// Hopper port of the TPU fused attention block, forward and backward, with or
// without an additive logits bias:
//   y = x + (softmax(q·kᵀ·scale + bias)·v)·Woᵀ + bo,   q|k|v = LN(x)·Wqkvᵀ (no bias)
// Replaces vit_tpu/ops/fused_attention_block.py::fused_attention_block (:464)
// and ::fused_attention_block_bias (:515): the forward (_forward / _fwd_kernel,
// the bias at :137-139) and the backward (_backward / _bwd_kernel, the bias at
// :209-211 and its gradient dbias at :225-228).
//
// The TPU kept a micro-batch of images in VMEM for the whole block.  On the
// H100 the forward is four hand-written kernels chained on one stream:
//   1. layernorm                                 -> xn (rows, d)
//   2. linear (no epilogue)                      -> qkv (rows, 3·inner)
//   3. mha_fwd over the packed qkv, + bias       -> oattn (rows, inner)
//   4. linear (bias + residual epilogue)         -> y (rows, d)
// xn, qkv and oattn go through device memory in scratch the wrapper
// allocates (and keeps, in training, as the TPU's save_residuals did);
// keeping them on chip, as the TPU kept them in VMEM, is the first job of a
// later performance change.  The rounding points mirror the TPU kernel: xn,
// qkv and oattn are rounded to the compute dtype, the residual adds in it.
// gamma/beta arrive in the compute dtype, as the TPU wrapper rounded them
// (fused_attention_block.py:343).  The logits bias (hb, n, n), hb ∈ {1,
// heads}, stays f32 throughout (attention.cu says why); without one, the
// attention kernels are the unbiased instances.
//
// Backward (_bwd_kernel, fused_attention_block.py:169-258), four steps, a
// fifth for dbias:
//   1. linear dy·Wo                              -> doattn = T(dy·Wo) (rows, inner)
//   2. mha_bwd over qkv and doattn (attention.cu) -> dqkv (rows, 3·inner)
//   2b. only when dbias is asked for: mha_dbias   -> dbias (hb, n, n) f32, in a fixed order
//   3. linear dqkv·Wqkv into f32                 -> dxn (rows, d)
//   4. LayerNorm backward (layernorm.cu, shared with the MLP): dx = T(dy + T(dx_ln));
//      Σ dxn·xhat, Σ dxn, Σ dy                   -> dγ, dβ, dbo
// The weight gradients dWqkv = dqkvᵀ·xn and dWo = dyᵀ·oattn stay plain GEMMs
// outside, as they were outside the Pallas kernel (:498-505).  Bound on the
// H100: the doattn and dxn GEMMs plus the attention's 10·b·heads·n²·dim_head
// FLOPs (79 GFLOP at B/16) at the 989 TFLOP/s bf16 peak, 0.08 ms.  At the
// small-dataset ViT (b=64, n=257, d=1024, 16 heads of 64) the TPU kernel's own
// FLOPs bound the forward at 0.157 ms (138.0 GFLOP of GEMMs, 17.3 of
// attention) and the backward at 0.183 ms (138.0 + 43.3).
#include "kernels.cuh"

// `bias` (hb, n, n) f32, or null with hb = 0.
extern "C" int vit_fused_attention_block_fwd(const void* x, const void* gamma,
                                             const void* beta, const void* wqkv,
                                             const void* wo, const void* bo, void* y,
                                             void* xn, void* qkv, void* oattn,
                                             const float* bias, int hb, int b,
                                             int n, int d, int heads, int dim_head,
                                             float scale, float eps, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  cudaError_t err = launch_layernorm(x, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_linear(xn, wqkv, kWeightNK, nullptr, nullptr, nullptr, qkv, nullptr, nullptr, rows,
                      3 * inner, d, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_mha_fwd(qkv, oattn, bias, hb, b, n, heads, dim_head, scale, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_linear(oattn, wo, kWeightNK, bo, x, nullptr, y, nullptr, nullptr, rows, d, inner,
                       kEpiBiasResidual, dtype, stream);
}

// Outputs dx (rows, d) and dqkv (rows, 3·inner) in the compute dtype and
// sums_d = [dγ | dβ | dbo] (3·d,) in f32.  Scratch: doattn (rows, inner) in
// the compute dtype; rowstat (b, heads, n, 2), dxn (rows, d), stats (rows, 2)
// and part_d (vit_ln_bwd_partial_rows(rows), 3·d) in f32.  `bias` (hb, n, n)
// f32, or null with hb = 0; `dbias` (hb, n, n) f32 and its scratch
// `dbias_part` (vit_attention_dbias_parts(b, n, heads, hb), hb, n, n) f32, or
// both null when dbias is not wanted.
extern "C" int vit_fused_attention_block_bwd(const void* dy, const void* x, const void* qkv,
                                             const void* gamma, const void* wqkv,
                                             const void* wo, void* dx, void* dqkv,
                                             float* sums_d, void* doattn, float* rowstat,
                                             float* dxn, float* stats, float* part_d,
                                             const float* bias, int hb, float* dbias,
                                             float* dbias_part, int b, int n, int d, int heads,
                                             int dim_head, float scale, float eps, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  if (rows <= 0 || (dbias && !bias)) return cudaErrorInvalidValue;
  cudaError_t err = launch_linear(dy, wo, kWeightKN, nullptr, nullptr, nullptr, doattn, nullptr,
                                  nullptr, rows, inner, d, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_mha_bwd(qkv, doattn, dqkv, rowstat, bias, hb, b, n, heads, dim_head, scale, dtype,
                       stream);
  if (err != cudaSuccess) return err;
  if (dbias) {
    err = launch_mha_dbias(qkv, doattn, rowstat, bias, hb, dbias_part, dbias, b, n, heads,
                           dim_head, scale, dtype, stream);
    if (err != cudaSuccess) return err;
  }
  err = launch_linear(dqkv, wqkv, kWeightKN, nullptr, nullptr, nullptr, dxn, nullptr, nullptr,
                      rows, d, 3 * inner, kEpiStoreF32, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_ln_bwd(x, dxn, gamma, dy, dx, stats, part_d, sums_d, rows, d, eps, dtype,
                       stream);
}

extern "C" int vit_attention_dbias_parts(int b, int n, int heads, int hb) {
  return vit::mha_dbias_parts(b, n, heads, hb);
}

extern "C" const char* vit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
