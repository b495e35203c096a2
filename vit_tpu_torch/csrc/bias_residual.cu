// The end of a tensor-parallel block's forward (the attention block's and the
// fused MLP's split forms, rows 3 and 1 of PERF.md's table):
//   y = T(x + T(s + b))
// from s (rows, d) f32, the sum over the model ranks of their partial
// out-projections (or fc2s), the replicated bias b (d,) and the residual x
// (rows, d).  These are the rounding points of kEpiBiasResidual, which the
// unsplit blocks apply inside their last GEMM: each rank's GEMM stops at its
// f32 partial (kEpiStoreF32 over kWeightNK), the ranks sum the partials in f32
// (torch.distributed all-reduce), and this pass adds the bias and the residual
// once, so a split block differs from the unsplit one only by the f32
// summation order.  It replaces no TPU kernel: vit_tpu never splits a Pallas
// call (GSPMD gathers its operands), so no Pallas kernel ends a split block.
//
// What bounds it on the H100: memory.  A pass over rows·d elements reads s (4
// bytes), x (2) and writes y (2): at ViT-B/32's 8320 rows of 1024, 67 MB, 0.020
// ms at 3.35 TB/s; its FLOPs are two adds an element.  The design is the
// plainest that moves those bytes once: eight elements a thread, each access
// 16 bytes wide (two float4 of s, one uint4 of x and of y, the bias's uint4
// from L2), a grid-stride loop over 8-element chunks.  CUDA C++ rather than
// Triton: the pass is elementwise, which Triton would serve as well, but it
// keeps the build to nvcc alone (vit_tpu_torch/ops/_build.py), with no second
// toolchain to compile on the card at first use.
#include "kernels.cuh"

namespace vit {
namespace {

template <typename T>
__global__ void __launch_bounds__(256) bias_residual_kernel(const float* __restrict__ s,
                                                            const T* __restrict__ b,
                                                            const T* __restrict__ x,
                                                            T* __restrict__ y, int chunks_per_row,
                                                            long long chunks) {
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < chunks;
       c += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(c % chunks_per_row) * 8;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(s) + 2 * c);
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(s) + 2 * c + 1);
    const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x) + c);
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b + col));
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* be = reinterpret_cast<const T*>(&bv);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = Num<T>::to_f(xe[2 * i]) + Num<T>::round(sv[2 * i] + Num<T>::to_f(be[2 * i]));
      const float hi =
          Num<T>::to_f(xe[2 * i + 1]) + Num<T>::round(sv[2 * i + 1] + Num<T>::to_f(be[2 * i + 1]));
      o[i] = Num<T>::pack2(lo, hi);
    }
    reinterpret_cast<uint4*>(y)[c] = out;
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

cudaError_t launch_bias_residual(const float* s, const void* b, const void* x, void* y, int rows,
                                 int d, int dtype, cudaStream_t stream) {
  if (rows < 0 || d <= 0 || d % 8 != 0 || !aligned(s) || !aligned(b) || !aligned(x) ||
      !aligned(y))
    return cudaErrorInvalidValue;
  const long long chunks = (long long)rows * (d / 8);
  if (chunks == 0) return cudaSuccess;
  const long long want = (chunks + 255) / 256;
  const unsigned blocks = (unsigned)(want < 16384 ? want : 16384);
  if (dtype == kBF16)
    bias_residual_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        s, static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), d / 8, chunks);
  else if (dtype == kF16)
    bias_residual_kernel<__half><<<blocks, 256, 0, stream>>>(
        s, static_cast<const __half*>(b), static_cast<const __half*>(x), static_cast<__half*>(y),
        d / 8, chunks);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace vit

// y (rows, d) = T(x + T(s + b)): s (rows, d) f32, b (d,), x and y (rows, d) in
// the compute dtype, every pointer 16-byte aligned, d % 8 == 0.
extern "C" int vit_bias_residual(const float* s, const void* b, const void* x, void* y, int rows,
                                 int d, int dtype, cudaStream_t stream) {
  return vit::launch_bias_residual(s, b, x, y, rows, d, dtype, stream);
}
