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

// Epilogues of the row-major GEMM  out = epi(A · B)  (linear.cu).  kWeightNK
// takes the first four, kWeightKN kEpiStore, kEpiDGelu and kEpiStoreF32.
enum Epilogue : int {
  kEpiStore = 0,         // out = T(acc)                          (QKV; doattn = dy·Wo)
  kEpiBiasGelu = 1,      // out = T(gelu_erf(acc + b))            (fc1, serving)
  kEpiBiasResidual = 2,  // out = T(res + T(acc + b))             (out-proj, fc2)
  kEpiBiasGeluSave = 3,  // out = T(gelu_erf(acc + b)), aux = T(acc + b)   (fc1, training:
                         //   keeps the pre-activation h for the backward)
  kEpiDGelu = 4,         // out = T(acc·gelu'(h)), aux = T(gelu(h)), column sums of
                         //   acc·gelu'(h) in f32, h read from aux_in   (MLP backward)
  kEpiStoreF32 = 5,      // out = acc in f32                      (dxn = dqkv·Wqkv, dh·W1)
};

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

// ---- host launchers (defined in layernorm.cu, linear.cu, attention.cu) -------

// xn (rows, d) = T((x - mean) * rstd * gamma + beta) per row of x (rows, d):
// f32 statistics, biased two-pass variance, eps inside the rsqrt; gamma/beta
// (d,) in the compute dtype.  d % 8 == 0.
cudaError_t launch_layernorm(const void* x, const void* gamma, const void* beta, void* xn,
                             int rows, int d, float eps, int dtype, cudaStream_t stream);

// LayerNorm backward of both blocks, given dxn (rows, d) in f32, the gradient
// at the LayerNorm's output.  Per row, from recomputed statistics:
//   dx = T(dy + T(rstd·(dxhat - mean(dxhat) - xhat·mean(dxhat·xhat)))),
//   dxhat = dxn·gamma.
// Column sums in f32, in a fixed order (per-block partials, then a second
// pass): sums = [Σ dxn·xhat | Σ dxn | Σ dy], each (d,).  `stats` (rows, 2)
// and `partial` (ln_bwd_partial_rows(rows), 3·d) are f32 scratch.
cudaError_t launch_ln_bwd(const void* x, const float* dxn, const void* gamma, const void* dy,
                          void* dx, float* stats, float* partial, float* sums, int rows, int d,
                          float eps, int dtype, cudaStream_t stream);
int ln_bwd_partial_rows(int rows);  // the wrappers size `partial` by vit_ln_bwd_partial_rows

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

// Multi-head softmax attention over packed qkv (b, n, 3·heads·dim_head) with
// q|k|v thirds; writes (b, n, heads·dim_head).  `bias`, when not null, is a
// (hb, n, n) f32 logits bias added after the scale, shared by every head when
// hb == 1, one per head when hb == heads.  dim_head ∈ {32, 64, 128}.
cudaError_t launch_mha_fwd(const void* qkv, void* out, const float* bias, int hb, int b, int n,
                           int heads, int dim_head, float scale, int dtype,
                           cudaStream_t stream);

// Its backward: from qkv and dout = dL/d(attention output) (b, n, heads·dim_head),
// writes dqkv (b, n, 3·heads·dim_head) in the packed q|k|v layout.  `rowstat`
// (b, heads, n, 2) f32 scratch receives each query row's log-sum-exp and
// Σ_j dp·p.  `bias` as for the forward.  dim_head ∈ {32, 64, 128}; any n.
cudaError_t launch_mha_bwd(const void* qkv, const void* dout, void* dqkv, float* rowstat,
                           const float* bias, int hb, int b, int n, int heads, int dim_head,
                           float scale, int dtype, cudaStream_t stream);

// The bias gradient dbias (hb, n, n) f32 = Σ over images (and over heads when
// hb == 1) of p·(dp - dsum), after launch_mha_bwd has filled `rowstat`, in a
// fixed order: per-part sums into `partial` (mha_dbias_parts(...), hb, n, n)
// f32 scratch, then the parts added in order.
cudaError_t launch_mha_dbias(const void* qkv, const void* dout, const float* rowstat,
                             const float* bias, int hb, float* partial, float* dbias, int b,
                             int n, int heads, int dim_head, float scale, int dtype,
                             cudaStream_t stream);
int mha_dbias_parts(int b, int n, int heads, int hb);  // the wrappers use vit_attention_dbias_parts

}  // namespace vit
