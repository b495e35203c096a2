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

// The ragged route: the same block at a width d that is not a multiple of 8
// (T2T-ViT's token transformers, d = hidden = 147 at 3136 tokens and 1323 at
// 784), which no 16-byte row of the GEMMs' TMA maps and mma.sync tiles takes.
// The scratch rows lie at the padded strides dp and hp (each width rounded up
// to 8: 152, 1328) and the weights come as zero-padded copies at those widths
// (gamma_p, beta_p, b2_p (dp,), w1_p (hp, dp), b1_p (hp,), w2_p (dp, hp); the
// wrapper pads them once a call, and the backward reuses them); x, y, dy and
// dx keep the module's stride d.  Every pad column of xn, h, g and the f32 dxn
// is then exactly 0 (zero weights, zero bias, gelu(0) = 0), so the GEMMs at the
// padded widths compute the block's function; the LayerNorm's statistics and
// its backward's means are taken over the true width d
// (launch_layernorm_ragged, launch_ln_bwd_ragged).  fc2's residual reads xp,
// the copy of x at stride dp that the LayerNorm pass writes beside xn, y comes
// through yp (rows, dp), copied to stride d, and the backward pads dy into dyp
// for the dy·W2 dgrad's A operand: three copies of a (rows, d) tensor a call
// that the aligned route does not make.  Both GEMMs and both dgrads run as the
// aligned route runs them (launch_forward_gemm, launch_dgrad: 152 on
// linear.cu, 1328 on gemm_wgmma); kEpiLnBwd needs d % 256 == 0, so the
// LayerNorm backward is layernorm.cu's passes over an f32 dxn, as at CvT's
// widths.  (A hidden width alone off 8 needs none of this: vit_fused_mlp_fwd
// and _bwd take zero-padded weights at hp as they are.)
// Forward: xn (rows, dp), g and, training, h (rows, hp); xp and yp (rows, dp)
// scratch.
extern "C" int vit_fused_mlp_fwd_ragged(const void* x, const void* gamma_p, const void* beta_p,
                                        const void* w1_p, const void* b1_p, const void* w2_p,
                                        const void* b2_p, void* y, void* xn, void* xp, void* g,
                                        void* h, void* yp, int rows, int d, int dp, int hp,
                                        float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  if (rows <= 0 || d % 8 == 0 || dp != (d + 7) / 8 * 8 || hp % 8 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err =
      launch_layernorm_ragged(x, gamma_p, beta_p, xn, xp, rows, d, dp, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_forward_gemm(xn, w1_p, b1_p, nullptr, g, h, rows, hp, dp,
                            h ? kEpiBiasGeluSave : kEpiBiasGelu, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_forward_gemm(g, w2_p, b2_p, xp, yp, nullptr, rows, dp, hp, kEpiBiasResidual, dtype,
                            stream);
  if (err != cudaSuccess) return err;
  return launch_copy_rows(yp, dp, y, d, rows, d, stream);
}

// Backward of the ragged route, from the forward's h (rows, hp) and the padded
// weights: dx (rows, d); dh and gact (rows, hp); sums_h (hp,) = db1 and sums_d
// (3·d,) = [dγ | dβ | db2] in f32 over the true width.  Scratch: part_h and
// part_d as vit_fused_mlp_bwd's, dxn (rows, dp) and stats (rows, 2) f32, dyp
// (rows, dp).
extern "C" int vit_fused_mlp_bwd_ragged(const void* dy, const void* x, const void* h,
                                        const void* gamma_p, const void* w1_p, const void* w2_p,
                                        void* dx, void* dh, void* gact, float* sums_h,
                                        float* sums_d, float* dxn, float* stats, float* part_h,
                                        float* part_d, void* dyp, int rows, int d, int dp,
                                        int hp, float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  if (rows <= 0 || d % 8 == 0 || dp != (d + 7) / 8 * 8 || hp % 8 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_copy_rows(dy, d, dyp, dp, rows, d, stream);
  if (err != cudaSuccess) return err;
  err = launch_dgrad(dyp, w2_p, h, dh, gact, part_h, rows, hp, dp, kEpiDGelu, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_colsum(part_h, linear_partial_rows(rows), hp, sums_h, stream);
  if (err != cudaSuccess) return err;
  err = launch_dgrad(dh, w1_p, nullptr, dxn, nullptr, nullptr, rows, dp, hp, kEpiStoreF32, dtype,
                     stream);
  if (err != cudaSuccess) return err;
  return launch_ln_bwd_ragged(x, dxn, gamma_p, dy, dx, stats, part_d, sums_d, rows, d, dp, eps,
                              dtype, stream);
}
