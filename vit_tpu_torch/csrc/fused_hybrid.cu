// Hopper ports of the row-wise kernels of the TPU's short-sequence hybrid
// layer (vit_tpu/ops/fused_hybrid.py), forward and backward:
//   ln_gemm:  out = (LN(x)·γ + β)·Wᵀ                    (the LN -> QKV pair)
//   proj_mlp: y = x + o·Woᵀ + bo;  z = y + fc2(gelu(fc1(LN(y))))
// Replaces ln_gemm's _ln_gemm_fwd_kernel (:105) and _ln_gemm_bwd_kernel
// (:125), and proj_mlp's _proj_mlp_fwd_kernel (:504) and _proj_mlp_bwd_kernel
// (:531).  The attention between them is short_attention.cu over the
// (n, b, heads·dh) rows.
//
// Both are chains of the port's device passes on one stream, as fused_mlp.cu
// composes them:
//   ln_gemm forward:  layernorm -> xn; the wgmma GEMM (gemm_wgmma.cu) -> q|k|v
//     (rows, 3·inner), which the attention reads through column strides (no
//     split copy).  xn goes through device memory: an LN prologue inside the
//     GEMM, so that it never does when serving, is later work (layernorm.cu
//     says why the block kernels took the separate pass).
//   ln_gemm backward: the dgrad dqkv·W with the LayerNorm backward, no
//     residual, as its epilogue (gemm_wgmma.cu's kEpiLnBwd, launch_dgrad_ln)
//     -> dx = T(rstd·(dxhat - m1 - xhat·m2)), Σ dγ, Σ dβ; the f32 dxn stays
//     on chip (at widths outside ln_bwd_fused, launch_dgrad into f32 and
//     layernorm.cu's passes).
//   proj_mlp forward: the wgmma GEMM with bias + residual -> y = T(x +
//     T(o·Woᵀ + bo)); layernorm -> xn; the wgmma GEMM with bias and exact-erf
//     GELU, keeping h in training -> g; the wgmma GEMM with bias and the
//     residual y -> z.  The fused MLP's chain over y, on gemm_wgmma.cu's
//     epilogues, which round where linear.cu's do.
//   proj_mlp backward (the TPU's _proj_mlp_bwd_kernel, :531): its three
//     dgrads on launch_dgrad, gemm_wgmma with W as it lies (B MN-major) from
//     n 256, as the fused MLP's and the attention block's backwards take
//     theirs: dz·W2 with the dGELU epilogue (dh, gact, db1's column
//     partials; n = hidden), dh·W1 with the LayerNorm backward as its
//     epilogue (launch_dgrad_ln, n = d) -> dy, [dγ | dβ | Σ dz = db2], dy·Wo
//     with the store epilogue -> do (n = inner); the column sums of dy ->
//     dbo.  At ViT-B/32's layer every n is 1024 or more, so all three run on
//     gemm_wgmma; linear.cu's mma.sync GEMM is left to narrower layers.
// Rounding points: the TPU kernel sums o·Wo + bo + x in one f32 expression
// and takes the LayerNorm's statistics from that unrounded y
// (fused_hybrid.py:508-513).  Here the out-projection's epilogue rounds twice,
// T(x + T(acc + bo)), as every residual block of the port does, and the
// statistics come from the stored y, which the backward recomputes them
// from too (as the TPU backward does, :560-561).  The plain versions round
// at the same points; in f32 both are vit_tpu's function.  The dy of the
// backward is T(dz + T(dx_ln)) and dbo sums that rounded dy (the TPU kernel
// rounds once and sums its f32 dy32).
//
// The weight gradients (dW of the QKV, out-projection, fc1 and fc2) stay
// plain GEMMs outside, as vit_tpu leaves them to XLA (fused_hybrid.py:271-277,
// :737-746).  Bound on the H100 at ViT-B/32's layer (8320 rows, d 1024, inner
// 1024, hidden 2048, bf16): ln_gemm 52.3 GFLOP each way (0.053 ms at 989
// TFLOP/s), proj_mlp 87.2 GFLOP each way (0.088 ms): the tensor cores bound
// both, so every GEMM here runs on gemm_wgmma.
#include "kernels.cuh"

// `xn` (rows, d) is scratch when serving and the saved residual in training;
// out (rows, n_out).
extern "C" int vit_ln_gemm_fwd(const void* x, const void* gamma, const void* beta,
                               const void* w, void* out, void* xn, int rows, int d, int n_out,
                               float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  cudaError_t err = launch_layernorm(x, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm_wgmma(xn, w, kWeightNK, nullptr, nullptr, nullptr, out, nullptr, nullptr,
                           rows, n_out, d, kEpiStore, dtype, stream);
}

// dout (rows, n_out) contiguous; outputs dx (rows, d) in the compute dtype and
// sums = [dγ | dβ] (2·d,) f32.  Scratch: part (vit_ln_bwd_partial_rows(rows),
// 3·d) f32; dxn (rows, d) and stats (rows, 2) f32 where vit_ln_bwd_fused(d) is
// 0, else null.
extern "C" int vit_ln_gemm_bwd(const void* dout, const void* x, const void* gamma,
                               const void* w, void* dx, float* sums, float* dxn, float* stats,
                               float* part, int rows, int d, int n_out, float eps, int dtype,
                               cudaStream_t stream) {
  using namespace vit;
  if (rows <= 0) return cudaErrorInvalidValue;
  return launch_dgrad_ln(dout, w, x, gamma, nullptr, dx, dxn, stats, part, sums, rows, d, n_out,
                         eps, dtype, stream);
}

// Outputs z, y (rows, d); xn (rows, d) and g (rows, hidden) are scratch when
// serving, and with `h` (rows, hidden; null when serving) the residuals the
// backward keeps.
extern "C" int vit_proj_mlp_fwd(const void* x, const void* o, const void* wo, const void* bo,
                                const void* gamma, const void* beta, const void* w1,
                                const void* b1, const void* w2, const void* b2, void* z, void* y,
                                void* xn, void* g, void* h, int rows, int d, int inner,
                                int hidden, float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  cudaError_t err = launch_gemm_wgmma(o, wo, kWeightNK, bo, x, nullptr, y, nullptr, nullptr,
                                      rows, d, inner, kEpiBiasResidual, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_layernorm(y, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm_wgmma(xn, w1, kWeightNK, b1, nullptr, nullptr, g, h, nullptr, rows, hidden,
                          d, h ? kEpiBiasGeluSave : kEpiBiasGelu, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm_wgmma(g, w2, kWeightNK, b2, y, nullptr, z, nullptr, nullptr, rows, d,
                           hidden, kEpiBiasResidual, dtype, stream);
}

// Outputs dy (rows, d), do_ (rows, inner), dh and gact (rows, hidden) in the
// compute dtype; f32 sums_h = db1 (hidden,), sums_d = [dγ | dβ | db2] (3·d,)
// and dbo (d,).  Scratch: part_h (vit_linear_partial_rows(rows), hidden) and
// part_d (vit_ln_bwd_partial_rows(rows), 3·d) f32; dxn (rows, d) and stats
// (rows, 2) f32 where vit_ln_bwd_fused(d) is 0, else null.
extern "C" int vit_proj_mlp_bwd(const void* dz, const void* y, const void* h,
                                const void* gamma, const void* wo, const void* w1,
                                const void* w2, void* dy, void* do_, void* dh, void* gact,
                                float* sums_h, float* sums_d, float* dbo, float* dxn,
                                float* stats, float* part_h, float* part_d, int rows, int d,
                                int inner, int hidden, float eps, int dtype,
                                cudaStream_t stream) {
  using namespace vit;
  if (rows <= 0) return cudaErrorInvalidValue;
  cudaError_t err = launch_dgrad(dz, w2, h, dh, gact, part_h, rows, hidden, d, kEpiDGelu, dtype,
                                 stream);
  if (err != cudaSuccess) return err;
  err = launch_colsum(part_h, linear_partial_rows(rows), hidden, sums_h, stream);
  if (err != cudaSuccess) return err;
  err = launch_dgrad_ln(dh, w1, y, gamma, dz, dy, dxn, stats, part_d, sums_d, rows, d, hidden, eps,
                        dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_dgrad(dy, wo, nullptr, do_, nullptr, nullptr, rows, inner, d, kEpiStore, dtype,
                     stream);
  if (err != cudaSuccess) return err;
  // part_d's first d columns are free again: its column sums above are done.
  return launch_column_sums(dy, part_d, dbo, rows, d, dtype, stream);
}
