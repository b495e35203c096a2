// Hopper port of the TPU fused MLP block (forward):
//   y = x + fc2(gelu(fc1(LN(x))))
// Replaces vit_tpu/ops/fused_mlp.py::fused_mlp / fused_mlp_3d
// (_forward, _forward3 / _fwd_kernel); the 2-D and 3-D TPU variants are one
// kernel over rows here.
//
// Three hand-written kernels chained on one stream:
//   1. layernorm                                      -> xn (rows, d)
//   2. linear (bias + exact-erf GELU epilogue)        -> h (rows, hidden)
//   3. linear (bias + residual epilogue)              -> y (rows, d)
// xn and h go through device memory in scratch the wrapper allocates; keeping
// them on chip, as the TPU kept them in VMEM, is the first job of a later
// performance change.  GELU is the exact erf form (erff): the TPU used the tanh form only
// because Mosaic has no erf (fused_mlp.py:99-118).  Rounding points mirror the
// TPU kernel: xn and gelu(h) are rounded to the compute dtype before their
// GEMMs, the residual adds in it.  gamma/beta arrive in the compute dtype, as
// the TPU wrapper rounded them (fused_mlp.py:309).
#include "kernels.cuh"

extern "C" int vit_fused_mlp_fwd(const void* x, const void* gamma, const void* beta,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* y, void* xn, void* h, int rows, int d, int hidden,
                                 float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  cudaError_t err = launch_layernorm(x, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_linear(xn, w1, b1, nullptr, h, rows, hidden, d, kEpiBiasGelu, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_linear(h, w2, b2, x, y, rows, d, hidden, kEpiBiasResidual, dtype, stream);
}
