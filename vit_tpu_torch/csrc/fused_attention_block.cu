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
//   2. QKV GEMM, store epilogue                  -> qkv (rows, 3·inner)
//   3. the attention middle over the packed qkv  -> oattn (rows, inner), by one
//      of two routes, chosen by shape alone in the open by the caller
//      (ops/fused_attention_block.py attention_route), the same route as the
//      backward's:
//      - short (n <= 512: ViT-B/32's 65, ViT-B/16's 197, the small-dataset
//        ViT's 257 with LSA's mask), with or without the bias:
//        short_attention.cu's short_fwd (wgmma, TMA ring) over (b, heads, n,
//        dh) views of the packed qkv (batch stride n·3·inner, head stride dh,
//        row stride 3·inner; q, k and v the column thirds), writing oattn
//        through its own strides, no layout copy; in training also lse (b,
//        heads, n) f32, which the backward's short_bwd reads.  Whole rows in
//        one key tile or two passes over two to four, the exact softmax from
//        the row's own max, p = exp(s - m) / l rounded before p·v; with the
//        bias (added in f32 to the scaled logits before the max, read from L2
//        into the score fragment) one pass over the tiles with a running max,
//        the rounded unnormalised p and the divide after p·v, as the TPU
//        kernel (:146-154), so the f32 bias is read once;
//      - mha (n > 512): mha_fwd (attention.cu), mma.sync with an online
//        softmax, + bias, the rounded unnormalised p and the divide after
//        p·v, as the TPU kernel (:146-154).
//      In f32 the two are one function; in bf16 they round p at other points.
//   4. out-projection GEMM, bias + residual epilogue -> y (rows, d)
// The two GEMMs go through launch_forward_gemm (gemm_wgmma.cu's wgmma GEMM
// from n = 256, linear.cu's below).  xn, qkv and oattn go through device
// memory in scratch the wrapper allocates (and keeps, in training, as the
// TPU's save_residuals did).  The rounding points mirror the TPU kernel
// (:158-161): xn, qkv and oattn are rounded to the compute dtype, the residual
// adds as T(x + T(acc + bo)).  gamma/beta arrive in the compute dtype, as the
// TPU wrapper rounded them (fused_attention_block.py:343).  The logits bias
// (hb, n, n), hb ∈ {1, heads}, stays f32 throughout (attention.cu says why).
// Bound on the H100: the two GEMMs (8·rows·d·inner FLOPs) and the attention's
// 4·b·heads·n²·dim_head at the 989 TFLOP/s bf16 peak: 59.5 + 7.6 GFLOP at
// B/16, 0.068 ms; 69.8 + 2.2 at bench.py's B/32 step, 0.073 ms.
//
// Backward (_bwd_kernel, fused_attention_block.py:169-258), four steps, a
// fifth for dbias:
//   1. the dgrad dy·Wo                           -> doattn = T(dy·Wo) (rows, inner)
//   2. the attention backward over qkv and doattn -> dqkv (rows, 3·inner), by
//      the forward's route (attention_route):
//      - short (n <= 512, with or without the bias): short_attention.cu's
//        short_bwd over (b, heads, n, dh) views of the packed qkv (batch
//        stride n·3·inner, head stride dh, row stride 3·inner; q, k and v the
//        column thirds), of oattn and doattn as O and dO, and of dqkv,
//        written through the same strides as qkv, from the training forward's
//        lse (short_fwd writes it).  One recompute of p = exp(s·scale + bias -
//        lse) per key block, five products; dq summed inside the CTA, or over
//        two 144-key blocks at 257-288 keys (the small-dataset ViT's 257).
//        Its D = rowsum(dO∘O) comes from the stored bf16 O, where the TPU
//        kernel sums dsum = Σ p·dp in f32 (:196-238): the same quantity in
//        exact arithmetic, apart by O's rounding.  With dbias, whose sum over
//        the batch does not cancel that rounding (CrossFormer's position
//        bias trains on it), mha_row_stats (attention.cu, mha_bwd_dq's first
//        pass) first writes each row's (lse, dsum = Σ p·dp) in f32, and
//        short_bwd takes that dsum, as the TPU kernel;
//      - mha (n > 512): mha_bwd (attention.cu), the FA2 split, with dsum =
//        Σ dp·p in f32 as the TPU kernel.
//   2b. only when dbias is asked for: mha_dbias   -> dbias (hb, n, n) f32, in a
//      fixed order, from the row statistics (lse, dsum): mha_bwd's, or on
//      the short route mha_row_stats'
//   3. the dgrad dqkv·Wqkv with the LayerNorm backward as its epilogue, the
//      f32 dxn kept on chip (gemm_wgmma.cu's kEpiLnBwd; launch_dgrad_ln,
//      shared with the MLP): dx = T(dy + T(dx_ln)); Σ dxn·xhat, Σ dxn, Σ dy
//                                                -> dγ, dβ, dbo
//      (outside ln_bwd_fused's widths: dxn in f32, then layernorm.cu)
// The two dgrads read the weights as they lie (kWeightKN) on gemm_wgmma.cu's
// wgmma GEMM with B MN-major (below n = 256, linear.cu's; launch_dgrad).  The
// weight gradients dWqkv = dqkvᵀ·xn and dWo = dyᵀ·oattn stay plain GEMMs
// outside, as they were outside the Pallas kernel (:498-505).  Bound on the
// H100: the doattn and dxn GEMMs plus the attention's 10·b·heads·n²·dim_head
// FLOPs (79 GFLOP at B/16) at the 989 TFLOP/s bf16 peak, 0.08 ms.  At the
// small-dataset ViT (b=64, n=257, d=1024, 16 heads of 64) the TPU kernel's own
// FLOPs bound the forward at 0.157 ms (138.0 GFLOP of GEMMs, 17.3 of
// attention) and the backward at 0.183 ms (138.0 + 43.3).
#include "kernels.cuh"

// Outputs y (rows, d); xn (rows, d), qkv (rows, 3·inner) and oattn (rows,
// inner) in the compute dtype.  `bias` (hb, n, n) f32, or null with hb = 0.
// The attention's route:
// - short, when `short_strides` (host memory, 12 values) is not null: the
//   (batch, head, row) strides of q, k, v (the column thirds of qkv) and O =
//   oattn as short_fwd reads and writes them; `lse` (b, heads, n) f32 in
//   training, else null.
// - mha otherwise; no lse.
extern "C" int vit_fused_attention_block_fwd(const void* x, const void* gamma,
                                             const void* beta, const void* wqkv,
                                             const void* wo, const void* bo, void* y,
                                             void* xn, void* qkv, void* oattn, float* lse,
                                             const long long* short_strides,
                                             const float* bias, int hb, int b,
                                             int n, int d, int heads, int dim_head,
                                             float scale, float eps, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  const bool short_route = short_strides != nullptr;
  if (!short_route && lse) return cudaErrorInvalidValue;
  cudaError_t err = launch_layernorm(x, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_forward_gemm(xn, wqkv, nullptr, nullptr, qkv, nullptr, rows, 3 * inner, d,
                            kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  if (short_route) {
    const char* base = static_cast<const char*>(qkv);
    const size_t third = 2 * (size_t)inner;  // bytes to k's and v's columns (bf16, f16)
    err = launch_short_fwd(base, base + third, base + 2 * third, oattn, lse, short_strides, b,
                           heads, n, n, dim_head, scale, dtype, stream, bias, hb);
  } else {
    err = launch_mha_fwd(qkv, oattn, bias, hb, b, n, heads, dim_head, scale, dtype, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_forward_gemm(oattn, wo, bo, x, y, nullptr, rows, d, inner, kEpiBiasResidual,
                             dtype, stream);
}

// Outputs dx (rows, d) and dqkv (rows, 3·inner) in the compute dtype and
// sums_d = [dγ | dβ | dbo] (3·d,) in f32.  Scratch: doattn (rows, inner) in
// the compute dtype; part_d (vit_ln_bwd_partial_rows(rows), 3·d) in f32;
// dxn (rows, d) and stats (rows, 2) in f32 where vit_ln_bwd_fused(d) is 0,
// else null.  `bias` (hb, n, n) f32, or
// null with hb = 0; `dbias` (hb, n, n) f32 and its scratch `dbias_part`
// (vit_attention_dbias_parts(b, n, heads, hb), hb, n, n) f32, or both null
// when dbias is not wanted.  The attention's route:
// - short, when `short_strides` (host memory, 24 values) is not null: the
//   (batch, head, row) strides of q, k, v, O = oattn, dO = doattn, dq, dk, dv
//   as short_bwd reads them (q/k/v and dq/dk/dv the column thirds of qkv and
//   dqkv); `lse` (b, heads, n) f32 from the training forward; `dq_part`
//   (vit_short_attention_parts(n, dim_head), b, heads, n, dim_head) f32
//   scratch when that is above 1, else null; `rowstat` (b, heads, n, 2) f32
//   scratch with dbias (the rows' exact dsum), else null.
// - mha otherwise: `rowstat` (b, heads, n, 2) f32 scratch.
extern "C" int vit_fused_attention_block_bwd(const void* dy, const void* x, const void* qkv,
                                             const void* oattn, const float* lse,
                                             const void* gamma, const void* wqkv,
                                             const void* wo, void* dx, void* dqkv,
                                             float* sums_d, void* doattn,
                                             const long long* short_strides, float* dq_part,
                                             float* rowstat, float* dxn, float* stats,
                                             float* part_d, const float* bias, int hb,
                                             float* dbias, float* dbias_part, int b, int n,
                                             int d, int heads, int dim_head, float scale,
                                             float eps, int dtype, cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  const bool short_route = short_strides != nullptr;
  if (rows <= 0 || (dbias && !bias) || (short_route && (!lse || !oattn)) ||
      ((dbias || !short_route) && !rowstat))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_dgrad(dy, wo, nullptr, doattn, nullptr, nullptr, rows, inner, d,
                                 kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  if (short_route) {
    const char* base = static_cast<const char*>(qkv);
    char* dbase = static_cast<char*>(dqkv);
    const size_t third = 2 * (size_t)inner;  // bytes to k's and v's columns (bf16, f16)
    if (dbias) {  // the rows' exact dsum, which short_bwd and mha_dbias read
      err = launch_mha_row_stats(qkv, doattn, rowstat, bias, hb, b, n, heads, dim_head, scale,
                                 dtype, stream);
      if (err != cudaSuccess) return err;
    }
    err = launch_short_bwd(base, base + third, base + 2 * third, oattn, lse, doattn, dbase,
                           dbase + third, dbase + 2 * third, dq_part, short_strides, b, heads, n,
                           n, dim_head, scale, dtype, stream, bias, hb, dbias ? rowstat : nullptr);
  } else {
    err = launch_mha_bwd(qkv, doattn, dqkv, rowstat, bias, hb, b, n, heads, dim_head, scale,
                         dtype, stream);
  }
  if (err != cudaSuccess) return err;
  if (dbias) {
    err = launch_mha_dbias(qkv, doattn, rowstat, bias, hb, dbias_part, dbias, b, n, heads,
                           dim_head, scale, dtype, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_dgrad_ln(dqkv, wqkv, x, gamma, dy, dx, dxn, stats, part_d, sums_d, rows, d,
                         3 * inner, eps, dtype, stream);
}

extern "C" int vit_attention_dbias_parts(int b, int n, int heads, int hb) {
  return vit::mha_dbias_parts(b, n, heads, hb);
}

extern "C" const char* vit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
