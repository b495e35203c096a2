// Hopper port of the TPU fused attention block (forward):
//   y = x + (softmax(q·kᵀ·scale)·v)·Woᵀ + bo,   q|k|v = LN(x)·Wqkvᵀ (no bias)
// Replaces vit_tpu/ops/fused_attention_block.py::fused_attention_block
// (_forward / _fwd_kernel).
//
// The TPU kept a micro-batch of images in VMEM for the whole block.  On the
// H100 the block is four hand-written kernels chained on one stream:
//   1. layernorm                                 -> xn (rows, d)
//   2. linear (no epilogue)                      -> qkv (rows, 3·inner)
//   3. mha_fwd over the packed qkv               -> oattn (rows, inner)
//   4. linear (bias + residual epilogue)         -> y (rows, d)
// xn, qkv and oattn go through device memory in scratch the wrapper
// allocates; keeping them on chip, as the TPU kept them in VMEM, is the first
// job of a later performance change.  The rounding points mirror the TPU kernel: xn,
// qkv and oattn are rounded to the compute dtype, the residual adds in it.
// gamma/beta arrive in the compute dtype, as the TPU wrapper rounded them
// (fused_attention_block.py:343).
#include "kernels.cuh"

extern "C" int vit_fused_attention_block_fwd(const void* x, const void* gamma,
                                             const void* beta, const void* wqkv,
                                             const void* wo, const void* bo, void* y,
                                             void* xn, void* qkv, void* oattn, int b,
                                             int n, int d, int heads, int dim_head,
                                             float scale, float eps, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  cudaError_t err = launch_layernorm(x, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_linear(xn, wqkv, nullptr, nullptr, qkv, rows, 3 * inner, d, kEpiStore, dtype,
                      stream);
  if (err != cudaSuccess) return err;
  err = launch_mha_fwd(qkv, oattn, b, n, heads, dim_head, scale, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_linear(oattn, wo, bo, x, y, rows, d, inner, kEpiBiasResidual, dtype, stream);
}

extern "C" const char* vit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
