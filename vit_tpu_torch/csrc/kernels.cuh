// Shared device helpers and host launchers for the Hopper ports of the
// transformer-block kernels (sm_90a, mma.sync m16n8k16, f32 accumulation).
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

// Epilogues of the row-major GEMM  out = epi(A · Wᵀ).
enum Epilogue : int {
  kEpiStore = 0,         // out = T(acc)                          (QKV)
  kEpiBiasGelu = 1,      // out = T(gelu_erf(acc + b))            (fc1)
  kEpiBiasResidual = 2,  // out = T(res + T(acc + b))             (out-proj, fc2)
};

template <typename T>
struct Num;

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
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

// ---- host launchers (defined in linear.cu / attention.cu) -----------------

// xn (rows, d) = T((x - mean) * rstd * gamma + beta) per row of x (rows, d):
// f32 statistics, biased two-pass variance, eps inside the rsqrt; gamma/beta
// (d,) in the compute dtype.  d % 8 == 0.
cudaError_t launch_layernorm(const void* x, const void* gamma, const void* beta, void* xn,
                             int rows, int d, float eps, int dtype, cudaStream_t stream);

// out (rows, n) = epi(A · Wᵀ) with A (rows, k) and W (n, k) both k-contiguous;
// `bias` (n,) and `res` (rows, n) as the epilogue needs them.
// k % 8 == 0 and n % 8 == 0.
cudaError_t launch_linear(const void* a, const void* w, const void* bias, const void* res,
                          void* out, int rows, int n, int k, int epilogue, int dtype,
                          cudaStream_t stream);

// Multi-head softmax attention over packed qkv (b, n, 3·heads·dim_head) with
// q|k|v thirds; writes (b, n, heads·dim_head).  dim_head ∈ {32, 64, 128}.
cudaError_t launch_mha_fwd(const void* qkv, void* out, int b, int n, int heads,
                           int dim_head, float scale, int dtype, cudaStream_t stream);

}  // namespace vit
