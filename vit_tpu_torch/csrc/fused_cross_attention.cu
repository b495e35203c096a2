// Hopper port of the TPU fused cross-attention block, forward and backward:
//   y = x + (softmax((xn·Wqᵀ)·kᵀ·scale)·v)·Woᵀ + bo,   k, v precomputed
// Replaces vit_tpu/ops/fused_cross_attention.py::fused_cross_attention_block
// (:297): the forward (_forward :188 / _fwd_kernel :71) and the backward
// (_backward :243 / _bwd_kernel :115).  ScalableViT's SSA and Twins-SVT's
// global attention have this shape: the queries come from a tokenwise GEMM of
// the normalised stream xn, the keys and values from a strided convolution of
// it that no tokenwise kernel can hold, so k and v arrive precomputed, with
// their own head widths (dh_k 40 and dh_v 32 at ScalableViT's stages 1-3).
//
// The TPU kept a micro-batch of images in VMEM for the whole block.  On the
// H100 the forward is three hand-written kernels chained on one stream:
//   1. linear (no epilogue)                         -> q = T(xn·Wqᵀ) (rows, h·dh_k)
//   2. flash_fwd, (dh_k, dh_v) instance, reading q, k, v channel-packed through
//      their strides                                -> oattn (rows, h·dh_v), lse
//   3. linear (bias + residual epilogue)            -> y = T(x + T(oattn·Woᵀ + bo))
// q and oattn go through device memory in scratch the wrapper allocates (and
// keeps, with lse, for the backward, as the TPU's save_residuals kept q and
// oattn).  Rounding points as the TPU kernel: q and oattn rounded to the
// compute dtype, logits in f32, P rounded for P·V and the f32 row sum divided
// out after it (:98-104), the residual added in the compute dtype.
//
// Backward, four steps:
//   1. linear dy·Wo (kWeightKN)                     -> doattn = T(dy·Wo)
//   2. the (dh_k, dh_v) flash backward: D = rowsum(doattn∘oattn), dq, then dk
//      and dv from lse (no statistics pass; the TPU recomputed the softmax and
//      Σ dp·p)                                      -> dq, dk, dv
//   3. linear dq·Wq (kWeightKN)                     -> dxn = T(dq·Wq)
//   4. fixed-order column sums of dy in f32         -> dbo
// The weight gradients dWq = dqᵀ·xn and dWo = dyᵀ·oattn stay plain GEMMs
// outside, as the TPU left them to XLA (:330-338).  dk and dv flow back into
// the strided convolutions, dy straight into the residual.
//
// Bound on the H100, ScalableViT stage 1 at batch 64 (262,144 rows, c 64, 2
// heads, n_k 64, hk 80, hv 64): the forward does about 9.7 GFLOP (0.010 ms at
// 989 TFLOP/s) against about 101 MB of x, xn and y (0.030 ms at 3.35 TB/s), so
// the memory bounds it; the q and oattn round trips add 76 MB.  Keeping q and
// oattn on chip is the first job of a later performance change.  The dk/dv
// pass gets only b·heads CTAs at n_k = 64 (128 at stage 1), each looping over
// every query tile: under one wave on 132 SMs (split-q with a fixed-order
// reduction is later work).
#include "kernels.cuh"

namespace {

// (batch, head, row) element strides of a token-major (b, n, heads·d) map.
void packed_strides(long long* s, long long n, long long heads, long long d) {
  s[0] = n * heads * d;
  s[1] = d;
  s[2] = heads * d;
}

}  // namespace

// Outputs y (rows, c); residuals q (rows, hk), oattn (rows, hv) in the
// compute dtype and lse (b, heads, n) f32, rows = b·n.  x, xn (rows, c);
// k (b, n_k, hk), v (b, n_k, hv); wq (hk, c) and wo (c, hv) in nn.Linear
// layout; bo (c,).  hk = heads·dh_k, hv = heads·dh_v.
extern "C" int vit_fused_cross_attention_fwd(const void* x, const void* xn, const void* wq,
                                             const void* k, const void* v, const void* wo,
                                             const void* bo, void* y, void* q, void* oattn,
                                             float* lse, int b, int n, int n_k, int c, int heads,
                                             int dh_k, int dh_v, float scale, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, hk = heads * dh_k, hv = heads * dh_v;
  long long st[12];
  packed_strides(st, n, heads, dh_k);       // q
  packed_strides(st + 3, n_k, heads, dh_k);  // k
  packed_strides(st + 6, n_k, heads, dh_v);  // v
  packed_strides(st + 9, n, heads, dh_v);    // oattn
  cudaError_t err = launch_linear(xn, wq, kWeightNK, nullptr, nullptr, nullptr, q, nullptr,
                                  nullptr, rows, hk, c, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_flash_fwd(q, k, v, oattn, lse, st, b, heads, n, n_k, dh_k, dh_v, scale, dtype,
                         stream);
  if (err != cudaSuccess) return err;
  return launch_linear(oattn, wo, kWeightNK, bo, x, nullptr, y, nullptr, nullptr, rows, c, hv,
                       kEpiBiasResidual, dtype, stream);
}

// Outputs dxn (rows, c), dq (rows, hk), dk (b, n_k, hk), dv (b, n_k, hv) in
// the compute dtype and dbo (c,) f32, from dy (rows, c) and the forward's q,
// k, v, oattn and lse.  Scratch: doattn (rows, hv) in the compute dtype,
// dsum (b, heads, n) and part (vit_ln_bwd_partial_rows(rows), c) f32.
extern "C" int vit_fused_cross_attention_bwd(const void* dy, const void* q, const void* k,
                                             const void* v, const void* oattn, const float* lse,
                                             const void* wq, const void* wo, void* dxn, void* dq,
                                             void* dk, void* dv, float* dbo, void* doattn,
                                             float* dsum, float* part, int b, int n, int n_k,
                                             int c, int heads, int dh_k, int dh_v, float scale,
                                             int dtype, cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, hk = heads * dh_k, hv = heads * dh_v;
  if (rows <= 0) return cudaErrorInvalidValue;
  long long st[24];
  packed_strides(st, n, heads, dh_k);        // q
  packed_strides(st + 3, n_k, heads, dh_k);  // k
  packed_strides(st + 6, n_k, heads, dh_v);  // v
  packed_strides(st + 9, n, heads, dh_v);    // oattn
  packed_strides(st + 12, n, heads, dh_v);   // doattn
  packed_strides(st + 15, n, heads, dh_k);   // dq
  packed_strides(st + 18, n_k, heads, dh_k);  // dk
  packed_strides(st + 21, n_k, heads, dh_v);  // dv
  cudaError_t err = launch_linear(dy, wo, kWeightKN, nullptr, nullptr, nullptr, doattn, nullptr,
                                  nullptr, rows, hv, c, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_flash_bwd(q, k, v, oattn, lse, doattn, dq, dk, dv, dsum, st, b, heads, n, n_k, dh_k,
                         dh_v, scale, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_linear(dq, wq, kWeightKN, nullptr, nullptr, nullptr, dxn, nullptr, nullptr, rows, c,
                      hk, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_column_sums(dy, part, dbo, rows, c, dtype, stream);
}
