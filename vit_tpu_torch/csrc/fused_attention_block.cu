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
//      (ops/fused_attention_block.py attention_route) and passed as `route`,
//      the same route as the backward's.  Both read (b, heads, n, dh) views
//      of the packed qkv (batch stride n·3·inner, head stride dh, row stride
//      3·inner; q, k and v the column thirds) and write oattn through its own
//      strides, no layout copy; in training both also write lse (b, heads, n)
//      f32, which the backward reads:
//      - short (n <= 512: ViT-B/32's 65, ViT-B/16's 197, the small-dataset
//        ViT's 257 with LSA's mask), with or without the bias:
//        short_attention.cu's short_fwd (wgmma, TMA ring).  Whole rows in
//        one key tile or two passes over two to four, the exact softmax from
//        the row's own max, p = exp(s - m) / l rounded before p·v; with the
//        bias (added in f32 to the scaled logits before the max, read from L2
//        into the score fragment) one pass over the tiles with a running max,
//        the rounded unnormalised p and the divide after p·v, as the TPU
//        kernel (:146-154), so the f32 bias is read once;
//      - mha (n > 512: PiT's 962, ViT-B/16's and the small-dataset ViT's 577
//        at 384 px): flash_attention.cu's flash_fwd (128-query CTAs of two
//        wgmma warpgroups, a TMA ring of 64-key tiles on mbarriers, q·kᵀ of
//        tile i in flight with p·v of tile i - 1), the online softmax with
//        the bias added in f32 before the running max, the rounded
//        unnormalised p as wgmma's register operand and the divide after p·v,
//        as the TPU kernel (:146-154).  What bounds it is the tensor cores
//        (4·b·heads·n²·dh: 243 GFLOP at PiT's stage 1, batch 64); the design
//        keeps the n x n scores in registers and the copies off the critical
//        path.
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
//      the forward's route (attention_route), each over (b, heads, n, dh)
//      views of the packed qkv, of oattn and doattn as O and dO, and of dqkv,
//      written through the same strides as qkv, from the training forward's
//      lse: p = exp(s·scale + bias - lse), and D = rowsum(dO∘O) from the
//      stored bf16 O where the TPU kernel sums dsum = Σ p·dp in f32
//      (:196-238): the same quantity in exact arithmetic, apart by O's
//      rounding.  With dbias, whose sum over the batch does not cancel that
//      rounding (CrossFormer's position bias trains on it), mha_row_stats
//      (attention.cu) first writes each row's (lse, dsum = Σ p·dp) in f32,
//      and the backward takes that dsum, as the TPU kernel:
//      - short (n <= 512, with or without the bias): short_attention.cu's
//        short_bwd.  One recompute of p per key block, five products; dq
//        summed inside the CTA, or over two 144-key blocks at 257-288 keys
//        (the small-dataset ViT's 257);
//      - mha (n > 512): flash_attention.cu's flash backward, FA2's split:
//        flash_bwd_dsum (D), then flash_bwd_dq over 128-query blocks and
//        flash_bwd_dkv over 128-key blocks, wgmma on TMA rings, each output
//        tile with one owner (no atomics: the bits repeat).  Seven n x n x dh
//        products where the TPU kernel's one pass has five: p is recomputed
//        in both halves.  The tensor cores bound it (10·b·heads·n²·dh by the
//        TPU kernel's count: 606 GFLOP at PiT's stage 1).
//   2b. only when dbias is asked for: mha_dbias   -> dbias (hb, n, n) f32, in a
//      fixed order, from mha_row_stats' (lse, dsum)
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
//
// Split forms (tensor parallelism, rank r of t over the model axis, heads / t
// heads a rank, unbiased): vit_fused_attention_block_fwd_partial and
// vit_fused_attention_block_bwd_partial stop at the reductions, each at an f32
// partial sum that the ranks add up outside (torch.distributed), the forward
// after the out-projection (then bias_residual.cu adds bo and x once), the
// backward after the qkv dgrad (then layernorm.cu's vit_ln_bwd).  vit_tpu has
// no such kernel: GSPMD gathers a Pallas call's operands and keeps the
// unsharded numbers.
#include "kernels.cuh"

// The attention middle's routes (ops/fused_attention_block.py attention_route).
enum AttentionRoute { kRouteShort = 0, kRouteMha = 1 };

namespace {

// Steps 1-3 of the forward, shared by the block and its split form: xn, qkv
// and oattn (and lse in training) from x.
cudaError_t attention_front(const void* x, const void* gamma, const void* beta, const void* wqkv,
                            void* xn, void* qkv, void* oattn, float* lse,
                            const long long* strides, int route, const float* bias, int hb,
                            int b, int n, int d, int heads, int dim_head, float scale, float eps,
                            int dtype, cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  if (!strides || (route != kRouteShort && route != kRouteMha)) return cudaErrorInvalidValue;
  cudaError_t err = launch_layernorm(x, gamma, beta, xn, rows, d, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_forward_gemm(xn, wqkv, nullptr, nullptr, qkv, nullptr, rows, 3 * inner, d,
                            kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  const char* base = static_cast<const char*>(qkv);
  const size_t third = 2 * (size_t)inner;  // bytes to k's and v's columns (bf16, f16)
  if (route == kRouteShort)
    return launch_short_fwd(base, base + third, base + 2 * third, oattn, lse, strides, b, heads,
                            n, n, dim_head, scale, dtype, stream, bias, hb);
  return launch_flash_fwd(base, base + third, base + 2 * third, oattn, lse, strides, b, heads, n,
                          n, dim_head, dim_head, scale, dtype, stream, bias, hb);
}

// Steps 1-2 of the backward, shared by the block and its split form: doattn
// = T(dy·Wo) and dqkv by the attention backward (with `rowstat`, the dbias
// call's exact row statistics first).
cudaError_t attention_back(const void* dy, const void* qkv, const void* oattn, const float* lse,
                           const void* wo, void* dqkv, void* doattn, const long long* strides,
                           int route, float* dq_part, float* dsum, float* rowstat,
                           const float* bias, int hb, int b, int n, int d, int heads,
                           int dim_head, float scale, int dtype, cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  cudaError_t err = launch_dgrad(dy, wo, nullptr, doattn, nullptr, nullptr, rows, inner, d,
                                 kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  if (rowstat) {  // which the attention backward and mha_dbias read
    err = launch_mha_row_stats(qkv, doattn, rowstat, bias, hb, b, n, heads, dim_head, scale,
                               dtype, stream);
    if (err != cudaSuccess) return err;
  }
  const char* base = static_cast<const char*>(qkv);
  char* dbase = static_cast<char*>(dqkv);
  const size_t third = 2 * (size_t)inner;  // bytes to k's and v's columns (bf16, f16)
  if (route == kRouteMha)
    return launch_flash_bwd(base, base + third, base + 2 * third, oattn, lse, doattn, dbase,
                            dbase + third, dbase + 2 * third, dsum, strides, b, heads, n, n,
                            dim_head, dim_head, scale, dtype, stream, bias, hb, rowstat);
  return launch_short_bwd(base, base + third, base + 2 * third, oattn, lse, doattn, dbase,
                          dbase + third, dbase + 2 * third, dq_part, strides, b, heads, n, n,
                          dim_head, scale, dtype, stream, bias, hb, rowstat);
}

}  // namespace

// Outputs y (rows, d); xn (rows, d), qkv (rows, 3·inner) and oattn (rows,
// inner) in the compute dtype.  `bias` (hb, n, n) f32, or null with hb = 0.
// `strides` (host memory, 12 values): the (batch, head, row) strides of q, k,
// v (the column thirds of qkv) and O = oattn as the attention reads and
// writes them; `lse` (b, heads, n) f32 in training, else null.  `route`:
// kRouteShort (short_fwd) or kRouteMha (flash_fwd).
extern "C" int vit_fused_attention_block_fwd(const void* x, const void* gamma,
                                             const void* beta, const void* wqkv,
                                             const void* wo, const void* bo, void* y,
                                             void* xn, void* qkv, void* oattn, float* lse,
                                             const long long* strides, int route,
                                             const float* bias, int hb, int b,
                                             int n, int d, int heads, int dim_head,
                                             float scale, float eps, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  cudaError_t err = attention_front(x, gamma, beta, wqkv, xn, qkv, oattn, lse, strides, route,
                                    bias, hb, b, n, d, heads, dim_head, scale, eps, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_forward_gemm(oattn, wo, bo, x, y, nullptr, b * n, d, heads * dim_head,
                             kEpiBiasResidual, dtype, stream);
}

// The split form (tensor parallelism over the model ranks), unbiased: rank
// r's heads alone, `heads` the local count, wqkv (3·inner, d) the rows of its
// heads in each of q, k and v, wo (d, inner) the columns of its heads, inner =
// heads·dim_head.  Steps 1-3 as the block's, then the out-projection stops at
// its f32 partial s = oattn·Woᵀ (rows, d), with no bias and no residual
// (kEpiStoreF32 over kWeightNK): the caller sums s over the ranks in f32 and
// ends the block with vit_bias_residual, T(x + T(Σ s + bo)), the block's own
// rounding points.  kEpiBiasResidual cannot end a split block: it would add
// bo and x once per rank.  Other arguments as vit_fused_attention_block_fwd's.
extern "C" int vit_fused_attention_block_fwd_partial(const void* x, const void* gamma,
                                                     const void* beta, const void* wqkv,
                                                     const void* wo, float* s, void* xn,
                                                     void* qkv, void* oattn, float* lse,
                                                     const long long* strides, int route, int b,
                                                     int n, int d, int heads, int dim_head,
                                                     float scale, float eps, int dtype,
                                                     cudaStream_t stream) {
  using namespace vit;
  cudaError_t err = attention_front(x, gamma, beta, wqkv, xn, qkv, oattn, lse, strides, route,
                                    nullptr, 0, b, n, d, heads, dim_head, scale, eps, dtype,
                                    stream);
  if (err != cudaSuccess) return err;
  return launch_forward_gemm(oattn, wo, nullptr, nullptr, s, nullptr, b * n, d, heads * dim_head,
                             kEpiStoreF32, dtype, stream);
}

// Outputs dx (rows, d) and dqkv (rows, 3·inner) in the compute dtype and
// sums_d = [dγ | dβ | dbo] (3·d,) in f32, from the training forward's qkv,
// oattn and `lse` (b, heads, n) f32.  Scratch: doattn (rows, inner) in the
// compute dtype; part_d (vit_ln_bwd_partial_rows(rows), 3·d) in f32; dxn
// (rows, d) and stats (rows, 2) in f32 where vit_ln_bwd_fused(d) is 0, else
// null.  `bias` (hb, n, n) f32, or null with hb = 0; `dbias` (hb, n, n) f32
// and its scratch `dbias_part` (vit_attention_dbias_parts(b, n, heads, hb),
// hb, n, n) f32, or both null when dbias is not wanted; then `rowstat` (b,
// heads, n, 2) f32 scratch receives the rows' exact (lse, dsum), else it is
// null.  `strides` (host memory, 24 values): the (batch, head, row) strides
// of q, k, v, O = oattn, dO = doattn, dq, dk, dv as the attention backward
// reads them (q/k/v and dq/dk/dv the column thirds of qkv and dqkv).
// `route` as the forward's:
// - kRouteShort (short_bwd): `dq_part` (vit_short_attention_parts(n,
//   dim_head), b, heads, n, dim_head) f32 scratch when that is above 1, else
//   null;
// - kRouteMha (the flash backward): `dsum` (b, heads, n) f32 scratch for D,
//   unless `rowstat` gives dsum.
extern "C" int vit_fused_attention_block_bwd(const void* dy, const void* x, const void* qkv,
                                             const void* oattn, const float* lse,
                                             const void* gamma, const void* wqkv,
                                             const void* wo, void* dx, void* dqkv,
                                             float* sums_d, void* doattn,
                                             const long long* strides, int route,
                                             float* dq_part, float* dsum, float* rowstat,
                                             float* dxn, float* stats, float* part_d,
                                             const float* bias, int hb, float* dbias,
                                             float* dbias_part, int b, int n, int d, int heads,
                                             int dim_head, float scale, float eps, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  const bool mha = route == kRouteMha;
  if (rows <= 0 || !strides || !lse || !oattn || (route != kRouteShort && !mha) ||
      (dbias && (!bias || !rowstat)) || (mha && !dbias && !dsum))
    return cudaErrorInvalidValue;
  cudaError_t err = attention_back(dy, qkv, oattn, lse, wo, dqkv, doattn, strides, route, dq_part,
                                   dsum, dbias ? rowstat : nullptr, bias, hb, b, n, d, heads,
                                   dim_head, scale, dtype, stream);
  if (err != cudaSuccess) return err;
  if (dbias) {
    err = launch_mha_dbias(qkv, doattn, rowstat, bias, hb, dbias_part, dbias, b, n, heads,
                           dim_head, scale, dtype, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_dgrad_ln(dqkv, wqkv, x, gamma, dy, dx, dxn, stats, part_d, sums_d, rows, d,
                         3 * inner, eps, dtype, stream);
}

// The split form's backward (its forward: vit_fused_attention_block_fwd_partial),
// unbiased: steps 1 and 2 over rank r's heads, then the dgrad dqkv·Wqkv stops
// at the f32 partial dxn (rows, d) (kEpiStoreF32, as launch_dgrad_ln's passes
// route takes it).  kEpiLnBwd cannot end it: the LayerNorm backward needs the
// whole dxn, the sum over the ranks, which the caller takes in f32 before
// vit_ln_bwd gives dx and [dγ | dβ | dbo].  Outputs dqkv (rows, 3·inner) and
// doattn (rows, inner) in the compute dtype, dxn in f32; `dq_part` and `dsum`
// as vit_fused_attention_block_bwd takes them without a bias.
extern "C" int vit_fused_attention_block_bwd_partial(const void* dy, const void* qkv,
                                                     const void* oattn, const float* lse,
                                                     const void* wqkv, const void* wo,
                                                     void* dqkv, void* doattn, float* dxn,
                                                     const long long* strides, int route,
                                                     float* dq_part, float* dsum, int b, int n,
                                                     int d, int heads, int dim_head, float scale,
                                                     int dtype, cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, inner = heads * dim_head;
  if (rows <= 0 || !strides || !lse || !oattn || !dxn ||
      (route != kRouteShort && route != kRouteMha) || (route == kRouteMha && !dsum))
    return cudaErrorInvalidValue;
  cudaError_t err = attention_back(dy, qkv, oattn, lse, wo, dqkv, doattn, strides, route, dq_part,
                                   dsum, nullptr, nullptr, 0, b, n, d, heads, dim_head, scale,
                                   dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_dgrad(dqkv, wqkv, nullptr, dxn, nullptr, nullptr, rows, d, 3 * inner,
                      kEpiStoreF32, dtype, stream);
}

extern "C" int vit_attention_dbias_parts(int b, int n, int heads, int hb) {
  return vit::mha_dbias_parts(b, n, heads, hb);
}

extern "C" const char* vit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
