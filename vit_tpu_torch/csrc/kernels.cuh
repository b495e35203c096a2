// Shared device helpers and host launchers for the Hopper ports of the
// transformer-block kernels, forward and backward (sm_90a, mma.sync m16n8k16,
// f32 accumulation).
//
// Every launcher enqueues on the given stream, allocates nothing (the Python
// wrapper passes outputs and scratch it allocated with torch.empty) and
// returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vit {

// dtype codes shared with the Python wrappers (vit_tpu_torch/ops/_build.py).
enum DType : int { kBF16 = 0, kF16 = 1 };

// Layouts of the GEMM's weight B (linear.cu): an nn.Linear weight W (n, k) read
// as Wᵀ (the forward GEMMs), or W (k, n) used as it lies (the dgrads).
enum WeightLayout : int { kWeightNK = 0, kWeightKN = 1 };

// Epilogues of the row-major GEMMs  out = epi(A · B)  (linear.cu and
// gemm_wgmma.cu alike, kEpiLnBwd gemm_wgmma.cu's alone).  kWeightNK takes the
// first four and kEpiStoreF32 (the tensor-parallel blocks' f32 partial sums of
// the out-projection and fc2), kWeightKN kEpiStore, kEpiDGelu, kEpiStoreF32 and
// kEpiLnBwd.
enum Epilogue : int {
  kEpiStore = 0,         // out = T(acc)                          (QKV; doattn = dy·Wo)
  kEpiBiasGelu = 1,      // out = T(gelu_erf(acc + b))            (fc1, serving)
  kEpiBiasResidual = 2,  // out = T(res + T(acc + b))             (out-proj, fc2)
  kEpiBiasGeluSave = 3,  // out = T(gelu_erf(acc + b)), aux = T(acc + b)   (fc1, training:
                         //   keeps the pre-activation h for the backward)
  kEpiDGelu = 4,         // out = T(acc·gelu'(h)), aux = T(gelu(h)), column sums of
                         //   acc·gelu'(h) in f32, h read from aux_in   (MLP backward)
  kEpiStoreF32 = 5,      // out = acc in f32                      (dxn where the LayerNorm
                         //   backward is a pass of its own: launch_ln_bwd; over kWeightNK
                         //   a split block's partial out-projection or fc2)
  kEpiLnBwd = 6,         // acc = dxn kept on chip; out = dx, the LayerNorm backward of
                         //   launch_ln_bwd, and its column sums   (dqkv·Wqkv, dh·W1:
                         //   launch_dgrad_ln_bwd)
};

// Launches the library counts on the host where it makes them, for the
// checks that a backward launches a kernel, or none, that many times
// (vit_take_launch_count; torch.profiler can drop a session's first records):
// gemm_wgmma.cu's kernel at every epilogue, its LayerNorm-backward instance
// alone, launch_ln_bwd's passes (one count a call), linear.cu's GEMM and
// launch_forward_gemm's f32 partial sums (kEpiStoreF32 over kWeightNK, on
// either GEMM kernel: the tensor-parallel blocks' out-projection and fc2).
enum Counted : int {
  kCountGemmWgmma = 0,
  kCountLnEpilogue = 1,
  kCountLnPasses = 2,
  kCountLinear = 3,
  kCountForwardF32 = 4,
  kCounted = 5
};
void count_launch(int which);

template <typename T>
struct Num;

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) { return to_f(from_f(v)); }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Num<__half> {
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_f(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ float round(float v) { return to_f(from_f(v)); }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Exact-erf GELU, as vit_tpu's math path (jax.nn.gelu(approximate=False)).
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Its derivative, cdf + x·pdf (vit_tpu/ops/fused_mlp.py:123-126).
__device__ __forceinline__ float dgelu_erf(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * v * v);
  return cdf + v * pdf;
}

// Both from one erf: returns gelu'(v) as dgelu_erf does and writes
// gelu_erf(v) (v·cdf) to g.
__device__ __forceinline__ float gelu_erf_and_grad(float v, float& g) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * v * v);
  g = v * cdf;
  return cdf + v * pdf;
}

// 16-byte global->shared copy that bypasses L1; src_size 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- host launchers (defined in layernorm.cu, linear.cu, gemm_wgmma.cu,
// attention.cu, short_attention.cu, flash_attention.cu) -------------------------

// xn (rows, d) = T((x - mean) * rstd * gamma + beta) per row of x (rows, d):
// f32 statistics, biased two-pass variance, eps inside the rsqrt; gamma/beta
// (d,) in the compute dtype.  d % 8 == 0.
cudaError_t launch_layernorm(const void* x, const void* gamma, const void* beta, void* xn,
                             int rows, int d, float eps, int dtype, cudaStream_t stream);

// LayerNorm backward of the blocks, given dxn (rows, d) in f32, the gradient
// at the LayerNorm's output (at widths outside ln_bwd_fused: launch_dgrad_ln).
// Per row, from recomputed statistics:
//   dx = T(dy + T(rstd·(dxhat - mean(dxhat) - xhat·mean(dxhat·xhat)))),
//   dxhat = dxn·gamma.
// Column sums in f32, in a fixed order (per-block partials, then a second
// pass): sums = [Σ dxn·xhat | Σ dxn | Σ dy], each (d,).  `stats` (rows, 2)
// and `partial` (ln_bwd_partial_rows(rows), 3·d) are f32 scratch.  A null
// `dy` (a LayerNorm with no residual around it: ln_gemm) gives
// dx = T(rstd·(...)) and sums = [Σ dxn·xhat | Σ dxn].
cudaError_t launch_ln_bwd(const void* x, const float* dxn, const void* gamma, const void* dy,
                          void* dx, float* stats, float* partial, float* sums, int rows, int d,
                          float eps, int dtype, cudaStream_t stream);
int ln_bwd_partial_rows(int rows);  // the wrappers size `partial` by vit_ln_bwd_partial_rows

// The ragged route of the fused MLP (layernorm.cu), at a width d that is not
// a multiple of 8: x (rows, d) rows d apart -> xn (rows, ld) and the copy xp
// (rows, ld) of x, their columns past d zero (ld % 8 == 0, ld >= d);
// statistics over the true width d.
cudaError_t launch_layernorm_ragged(const void* x, const void* gamma, const void* beta,
                                    void* xn, void* xp, int rows, int d, int ld, float eps,
                                    int dtype, cudaStream_t stream);
// launch_ln_bwd at a ragged width, with the residual dy: x, dy and dx (rows,
// d) rows d apart, dxn (rows, ld) f32, the means over the true width d.
cudaError_t launch_ln_bwd_ragged(const void* x, const float* dxn, const void* gamma,
                                 const void* dy, void* dx, float* stats, float* partial,
                                 float* sums, int rows, int d, int ld, float eps, int dtype,
                                 cudaStream_t stream);
// dst (rows, ldd) = the first `cols` columns of the 16-bit src (rows, lds),
// zeros past them.
cudaError_t launch_copy_rows(const void* src, int lds, void* dst, int ldd, int rows, int cols,
                             cudaStream_t stream);

// out (m,) = Σ_p partial[p, :] over `parts` rows of f32 partial sums, in order.
cudaError_t launch_colsum(const float* partial, int parts, int m, float* out,
                          cudaStream_t stream);

// out (rows, n) = epi(A · B) with A (rows, k) k-contiguous and B = Wᵀ for an
// nn.Linear weight W (n, k) (layout kWeightNK), or B = W (k, n) n-contiguous
// (kWeightKN).  `bias` (n,), `res`, `aux_in` and `aux_out` (rows, n) and the
// column partial sums `partial` (linear_partial_rows(rows), n; kEpiDGelu) as
// the epilogue needs them, null otherwise.  k % 8 == 0 and n % 8 == 0.
cudaError_t launch_linear(const void* a, const void* w, int layout, const void* bias,
                          const void* res, const void* aux_in, void* out, void* aux_out,
                          float* partial, int rows, int n, int k, int epilogue, int dtype,
                          cudaStream_t stream);
int linear_partial_rows(int rows);  // the wrappers size `partial` by vit_linear_partial_rows

// out (rows, n) = epi(A · B) on wgmma fed by TMA (gemm_wgmma.cu), A (rows, k)
// k-contiguous and B as launch_linear takes it: kWeightNK with the epilogues
// kEpiStore, kEpiBiasGelu, kEpiBiasResidual, kEpiBiasGeluSave and
// kEpiStoreF32, kWeightKN with kEpiStore, kEpiStoreF32 and kEpiDGelu
// (linear.cu's rounding points and partial-sum layout).  `bias` (n,), `res`, `aux_in` and `aux` (rows, n) and
// `partial` (linear_partial_rows(rows), n) as the epilogue needs them, null
// otherwise.  k % 8 == 0, n % 8 == 0, every matrix 16-byte aligned.
cudaError_t launch_gemm_wgmma(const void* a, const void* w, int layout, const void* bias,
                              const void* res, const void* aux_in, void* out, void* aux,
                              float* partial, int rows, int n, int k, int epilogue, int dtype,
                              cudaStream_t stream);

// The blocks' forward GEMMs, out (rows, n) = epi(A · Wᵀ) for an nn.Linear
// weight W (n, k) (kWeightNK; kEpiStore, kEpiBiasGelu, kEpiBiasResidual,
// kEpiBiasGeluSave, `aux` = h for it, or kEpiStoreF32, out in f32: a split
// block's partial sum; arguments as launch_linear's): on gemm_wgmma from n =
// 256, on linear.cu below it (gemm_wgmma.cu says why).
cudaError_t launch_forward_gemm(const void* a, const void* w, const void* bias, const void* res,
                                void* out, void* aux, int rows, int n, int k, int epilogue,
                                int dtype, cudaStream_t stream);

// The blocks' dgrad GEMMs, out (rows, n) = epi(A · W) with W (k, n) used as it
// lies (kWeightKN; kEpiStore, kEpiStoreF32 or kEpiDGelu, arguments as
// launch_linear's): on gemm_wgmma from n = 256, on linear.cu below it
// (gemm_wgmma.cu says why).
cudaError_t launch_dgrad(const void* a, const void* w, const void* aux_in, void* out, void* aux,
                         float* partial, int rows, int n, int k, int epilogue, int dtype,
                         cudaStream_t stream);

// The dgrad whose epilogue is the LayerNorm backward (gemm_wgmma.cu,
// kEpiLnBwd): dxn = A · W (A (rows, k), W (k, d) as it lies) stays on chip,
// and from it, x (rows, d) and gamma (d,), what launch_ln_bwd computes from a
// stored dxn: dx (rows, d), and sums = [Σ dxn·xhat | Σ dxn | Σ dy] (3·d,) in
// f32 in a fixed order, or [Σ dxn·xhat | Σ dxn] (2·d,) with a null dy.
// `partial` (ln_bwd_partial_rows(rows), 3·d) is f32 scratch; no dxn and no
// statistics reach device memory.  Only where ln_bwd_fused(d) holds.
cudaError_t launch_dgrad_ln_bwd(const void* a, const void* w, const void* x, const void* gamma,
                                const void* dy, void* dx, float* partial, float* sums, int rows,
                                int d, int k, float eps, int dtype, cudaStream_t stream);
// The blocks' dgrad into a LayerNorm's backward, A (rows, k) · W (k, d) ->
// dx and sums as launch_dgrad_ln_bwd gives them: by it where ln_bwd_fused(d)
// holds (dxn and stats may be null), else launch_dgrad's f32 dxn (rows, d)
// and launch_ln_bwd with `stats` (rows, 2) f32 scratch.
cudaError_t launch_dgrad_ln(const void* a, const void* w, const void* x, const void* gamma,
                            const void* dy, void* dx, float* dxn, float* stats, float* partial,
                            float* sums, int rows, int d, int k, float eps, int dtype,
                            cudaStream_t stream);
// Whether launch_dgrad_ln_bwd takes width d: 256 <= d <= 2048, d % 256 == 0
// (a cluster of d / 256 CTAs, at most 8, the portable size).  The blocks'
// backwards choose by it; other widths keep launch_dgrad's f32 dxn and
// launch_ln_bwd.  Mirrored by vit_tpu_torch/ops/_shared.py ln_bwd_fused.
bool ln_bwd_fused(int d);

// The short-attention forward (short_attention.cu) over (b, heads, n, d)
// operands read through (batch, head, row) element strides: out (width d)
// through its strides and, when `lse` is not null, lse (b, heads, n_q) f32
// contiguous, from q, k and v; `strides` (host memory) holds those of q, k, v
// and out (12 values).  n_q, n_k <= 512, d ∈ {32, 64, 128}.  `bias`, when not
// null, is an f32 (hb, n_q, n_k) logits bias, hb 1 (shared by the heads) or
// heads, added to the scaled logits.
cudaError_t launch_short_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                             const long long* strides, int b, int heads, int n_q, int n_k, int d,
                             float scale, int dtype, cudaStream_t stream,
                             const float* bias = nullptr, int hb = 0);

// The short-attention backward (short_attention.cu) over (b, heads, n, d)
// operands read through (batch, head, row) element strides: dq, dk, dv from
// q, k, v, the forward's out and f32 lse (b, heads, n_q), and dout; `strides`
// (host memory) holds those of q, k, v, out, dout, dq, dk, dv (24 values);
// `dq_part` (short_attention_parts(n_k, d), b, heads, n_q, d) f32 scratch when
// that is above 1, else null.  n_q, n_k <= 512, d ∈ {32, 64, 128}.  `bias` as
// the forward's.  Without `rowstat` each query row's dsum is D = rowsum(dO∘O)
// from the stored out; with it (b, heads, n_q, 2) f32 (a bias only: the dbias
// call), filled by launch_mha_row_stats, dsum is its Σ_j p·dp in f32.
cudaError_t launch_short_bwd(const void* q, const void* k, const void* v, const void* out,
                             const float* lse, const void* dout, void* dq, void* dk, void* dv,
                             float* dq_part, const long long* strides, int b, int heads, int n_q,
                             int n_k, int d, float scale, int dtype, cudaStream_t stream,
                             const float* bias = nullptr, int hb = 0, float* rowstat = nullptr);

// The row statistics of the biased block's dbias call (attention.cu), over
// packed qkv (b, n, 3·heads·dim_head) with q|k|v thirds and dout = dL/d(the
// attention output) (b, n, heads·dim_head): `rowstat` (b, heads, n, 2) f32
// receives each query row's log-sum-exp and dsum = Σ_j p·dp, both in f32 (dp =
// dout·vᵀ), the (hb, n, n) f32 bias (hb 1 or heads; not null) added to the
// scaled logits.  dim_head ∈ {32, 64, 128}; any n.  The attention backward of that
// call (short_bwd, or the flash backward past 512 tokens) takes its dsum from
// them.
cudaError_t launch_mha_row_stats(const void* qkv, const void* dout, float* rowstat,
                                 const float* bias, int hb, int b, int n, int heads,
                                 int dim_head, float scale, int dtype, cudaStream_t stream);

// The bias gradient dbias (hb, n, n) f32 = Σ over images (and over heads when
// hb == 1) of p·(dp - dsum), after launch_mha_row_stats has filled `rowstat`
// with (lse, dsum = Σ dp·p), in a fixed order:
// per-part sums into `partial` (mha_dbias_parts(...), hb, n, n) f32 scratch,
// then the parts added in order.
cudaError_t launch_mha_dbias(const void* qkv, const void* dout, const float* rowstat,
                             const float* bias, int hb, float* partial, float* dbias, int b,
                             int n, int heads, int dim_head, float scale, int dtype,
                             cudaStream_t stream);
int mha_dbias_parts(int b, int n, int heads, int hb);  // the wrappers use vit_attention_dbias_parts

// Flash attention over (b, heads, n, d) operands read through host arrays of
// (batch, head, row) element strides (flash_attention.cu): q and k of width
// dk, v of width dv, (dk, dv) ∈ {(32, 32), (40, 32), (64, 64), (96, 96),
// (128, 128), (192, 192)}.  The forward writes out (width dv) and lse (b, heads, n_q) f32
// through the strides of q, k, v, out (12 values); the backward writes dq, dk,
// dv from q, k, v, out, lse and dout, with dsum (b, heads, n_q) f32 scratch,
// through the strides of q, k, v, out, dout, dq, dk, dv (24 values).  `bias`,
// when not null (dk == dv ∈ {32, 64, 128}), is an f32 (hb, n_q, n_k) logits
// bias, hb 1 (shared by the heads) or heads, added to the scaled logits in
// both directions.  Without `rowstat` each query row's dsum is D =
// rowsum(dO∘O) from the stored out (written to `dsum`); with it (b, heads,
// n_q, 2) f32 (a bias only: the dbias call), filled by launch_mha_row_stats,
// dsum is its Σ_j p·dp in f32 and `dsum` is not used.
cudaError_t launch_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                             const long long* strides, int b, int heads, int n_q, int n_k, int dk,
                             int dv, float scale, int dtype, cudaStream_t stream,
                             const float* bias = nullptr, int hb = 0);
cudaError_t launch_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const float* lse, const void* dout, void* dq, void* dk, void* dv,
                             float* dsum, const long long* strides, int b, int heads, int n_q,
                             int n_k, int d_k, int d_v, float scale, int dtype,
                             cudaStream_t stream, const float* bias = nullptr, int hb = 0,
                             const float* rowstat = nullptr);

// y (rows, d) = T(x + T(s + b)) from the f32 sum s (rows, d) of a split
// block's partial out-projections or fc2s, its bias b (d,) and the residual x
// (rows, d), x, b and y in the compute dtype: the rounding points of
// kEpiBiasResidual (bias_residual.cu).  d % 8 == 0.
cudaError_t launch_bias_residual(const float* s, const void* b, const void* x, void* y, int rows,
                                 int d, int dtype, cudaStream_t stream);

// out (d,) = Σ over the rows of a (rows, d) matrix in the compute dtype, in
// f32 and in a fixed order: 64-row partial sums into `partial`
// (ln_bwd_partial_rows(rows), d) f32 scratch, then colsum (layernorm.cu).
cudaError_t launch_column_sums(const void* a, float* partial, float* out, int rows, int d,
                               int dtype, cudaStream_t stream);

}  // namespace vit
