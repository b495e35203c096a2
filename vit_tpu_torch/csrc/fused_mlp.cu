// Hopper port of the TPU fused MLP block, forward and backward:
//   y = x + fc2(gelu(fc1(LN(x))))
// Replaces vit_tpu/ops/fused_mlp.py::fused_mlp / fused_mlp_3d: the forward
// (_forward, _forward3 / _fwd_kernel) and the backward (_backward, _backward3
// / _bwd_kernel); the 2-D and 3-D TPU variants are one kernel over rows here.
//
// Forward, three hand-written kernels chained on one stream:
//   1. layernorm                                      -> xn (rows, d)
//   2. fc1 with the bias + exact-erf GELU epilogue    -> g = T(gelu(h)) (rows, hidden)
//      training: the same epilogue also keeps h = T(xn·W1ᵀ + b1), the
//      pre-activation the backward differentiates GELU at (fused_mlp.py:165-166)
//   3. fc2 with the bias + residual epilogue          -> y (rows, d)
// Both GEMMs go through launch_forward_gemm: gemm_wgmma.cu's warp-specialised
// wgmma GEMM (TMA ring, persistent CTAs, the epilogues through shared memory)
// from n = 256, linear.cu's mma.sync GEMM below it (ScalableViT's narrow
// stages: fc2 at n = 64 and 128).  xn and g go through device memory in
// scratch the wrapper allocates; keeping them on chip, as the TPU kept them in
// VMEM, would take fc1's output tile into fc2's k loop.  GELU is the exact erf
// form (erff): the TPU used the tanh form only because Mosaic has no erf
// (fused_mlp.py:99-118).  Rounding points mirror the TPU kernel
// (fused_mlp.py:162-173): xn and gelu(h) are rounded to the compute dtype
// before their GEMMs, GELU is taken of the unrounded h, and the residual adds
// as T(x + T(acc + b2)).  gamma/beta arrive in the compute dtype, as the TPU
// wrapper rounded them (fused_mlp.py:309).
// Bound on the H100: the two GEMMs (4·rows·d·hidden FLOPs; 119 GFLOP at B/16)
// at the 989 TFLOP/s bf16 peak, 0.12 ms; at bench.py's B/32 step (8320 rows,
// d 1024, hidden 2048) 69.8 GFLOP, 0.071 ms.
//
// Backward (_bwd_kernel, fused_mlp.py:177-227), three steps:
//   1. the dgrad dy·W2 with the dgelu epilogue: dh32 = (dy·W2)·gelu'(h) from
//      the stored h; dh = T(dh32); gact = T(gelu(h)) for the dW2 GEMM; per
//      64-row column sums of the f32 dh32, then colsum                -> db1
//   2. the dgrad dh·W1 with the LayerNorm backward as its epilogue: the f32
//      dxn stays on chip, as the TPU kept it in VMEM (gemm_wgmma.cu's
//      kEpiLnBwd on a thread-block cluster; launch_dgrad_ln): dx = T(dy +
//      T(dx_ln)); Σ dxn·xhat, Σ dxn, Σ dy                     -> dγ, dβ, db2
//      At widths outside ln_bwd_fused (d not a multiple of 256 in
//      256..2048), dxn goes to device memory in f32 and layernorm.cu's
//      passes read it back.
// The dgrads read the weights as they lie (nn.Linear layout, kWeightKN) on
// gemm_wgmma.cu's warp-specialised wgmma GEMM with B MN-major, or below n =
// 256 (ScalableViT's narrow stages) on linear.cu's mma.sync one
// (launch_dgrad); the weight gradients dW1 = dhᵀ·xn and dW2 = dyᵀ·gact stay
// plain GEMMs outside, as they were outside the Pallas kernel
// (fused_mlp.py:529-534).
// Bound on the H100: the two dgrad GEMMs (4·rows·d·hidden FLOPs; 119 GFLOP at
// B/16) at the 989 TFLOP/s bf16 peak, 0.12 ms.
#include "kernels.cuh"

extern "C" int vit_fused_mlp_fwd(const void* x, const void* gamma, const void* beta,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* y, void* xn, void* g, void* h, int rows, int d,
                                 int hidden, float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  cudaError_t err = launch_layernorm(x, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_forward_gemm(xn, w1, b1, nullptr, g, h, rows, hidden, d,
                            h ? kEpiBiasGeluSave : kEpiBiasGelu, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_forward_gemm(g, w2, b2, x, y, nullptr, rows, d, hidden, kEpiBiasResidual, dtype,
                             stream);
}

// Outputs dx (rows, d), dh and gact (rows, hidden) in the compute dtype;
// sums_h = db1 (hidden,) and sums_d = [dγ | dβ | db2] (3·d,) in f32.  Scratch:
// part_h (vit_linear_partial_rows(rows), hidden) and part_d
// (vit_ln_bwd_partial_rows(rows), 3·d) f32; dxn (rows, d) and stats (rows, 2)
// f32 where vit_ln_bwd_fused(d) is 0, else null.
extern "C" int vit_fused_mlp_bwd(const void* dy, const void* x, const void* h,
                                 const void* gamma, const void* w1, const void* w2, void* dx,
                                 void* dh, void* gact, float* sums_h, float* sums_d, float* dxn,
                                 float* stats, float* part_h, float* part_d, int rows, int d,
                                 int hidden, float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  if (rows <= 0) return cudaErrorInvalidValue;
  cudaError_t err = launch_dgrad(dy, w2, h, dh, gact, part_h, rows, hidden, d, kEpiDGelu, dtype,
                                 stream);
  if (err != cudaSuccess) return err;
  err = launch_colsum(part_h, linear_partial_rows(rows), hidden, sums_h, stream);
  if (err != cudaSuccess) return err;
  return launch_dgrad_ln(dh, w1, x, gamma, dy, dx, dxn, stats, part_d, sums_d, rows, d, hidden,
                         eps, dtype, stream);
}
