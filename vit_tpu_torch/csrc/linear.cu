// Row-major GEMM with fused epilogues, written by hand for Hopper with mma.sync
// m16n8k16 (f32 accumulation), and the LayerNorm that feeds it.  These are the
// GEMMs inside the two TPU block kernels: QKV and out-projection
// (vit_tpu/ops/fused_attention_block.py _fwd_kernel), fc1 and fc2
// (vit_tpu/ops/fused_mlp.py _fwd_kernel).
//
// Bound on the H100: at ViT-B/16, batch 64, the four GEMMs run over 12,608 rows
// of d=768 against weights of 768x2304, 768x768, 768x3072 and 3072x768 —
// hundreds of FLOPs per byte, far above the ~295 FLOP/byte ridge, so the
// tensor cores bound them.  The kernel uses 128x128x32 block tiles, eight warps
// of 64x32, a four-stage cp.async pipeline and ldmatrix, which is simple and
// right; wgmma/TMA pipelines and a persistent schedule are later work.
//
// The LayerNorm is its own memory-bound pass that writes xn in the compute
// dtype (the TPU kernel's rounding point): normalising each A tile in shared
// memory inside the GEMM sat on the critical path between the copy's wait and
// the barrier and halved the GEMM's rate (PERF.md), while the extra round trip
// of xn costs about 13 µs per block at B/16.
#include "kernels.cuh"

namespace vit {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 8;  // padded smem row (80 bytes): ldmatrix without bank conflicts
constexpr int kChunks = (kBM * kBK / 8) / kThreads;  // 16-byte chunks per thread per tile (2)
constexpr int kSmemBytes = kStages * (kBM + kBN) * kRow * 2;  // 80 KB: two blocks per SM

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

// One warp per row: f32 statistics with the biased two-pass variance and eps
// inside the rsqrt, then xn = T((x - mean) * rstd * gamma + beta).
template <typename T>
__global__ void __launch_bounds__(256) layernorm_kernel(const T* __restrict__ x,
                                                        const T* __restrict__ gamma,
                                                        const T* __restrict__ beta,
                                                        T* __restrict__ xn, int rows, int d,
                                                        float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  float sum = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += Num<T>::to_f(e[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / d;
  float sq = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = Num<T>::to_f(e[i]) - mean;
      sq += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / d + eps);
  T* outr = xn + (size_t)row * d;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 graw = *reinterpret_cast<const uint4*>(gamma + c);
    const uint4 braw = *reinterpret_cast<const uint4*>(beta + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    const T* ge = reinterpret_cast<const T*>(&graw);
    const T* be = reinterpret_cast<const T*>(&braw);
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = (Num<T>::to_f(e[i]) - mean) * rstd * Num<T>::to_f(ge[i]) + Num<T>::to_f(be[i]);
    *reinterpret_cast<uint4*>(outr + c) =
        make_uint4(Num<T>::pack2(f[0], f[1]), Num<T>::pack2(f[2], f[3]),
                   Num<T>::pack2(f[4], f[5]), Num<T>::pack2(f[6], f[7]));
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
    linear_kernel(const T* __restrict__ a, const T* __restrict__ w, const T* __restrict__ bias,
                  const T* __restrict__ res, T* __restrict__ out, int rows, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*As)[kBM][kRow] = reinterpret_cast<T(*)[kBM][kRow]>(smem_raw);
  T(*Bs)[kBN][kRow] = reinterpret_cast<T(*)[kBN][kRow]>(smem_raw + kStages * kBM * kRow * sizeof(T));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int g = lane / 4, t = lane % 4;

  // Stage one k tile of A and W; rows past `rows` / `n` and columns past k
  // land as zeros.
  auto load_stage = [&](int slot, int k0) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const int kk = k0 + col, ar = m0 + r, br = n0 + r;
      const bool va = kk < k && ar < rows, vb = kk < k && br < n;
      cp_async16(&As[slot][r][col], va ? a + (size_t)ar * k + kk : a, va);
      cp_async16(&Bs[slot][r][col], vb ? w + (size_t)br * k + kk : w, vb);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int ktiles = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();  // tile kt is visible to all; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next * kBK);  // the slot of tile kt - 1
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = warp_m * 64 + mi * 16 + (lane % 16);
        ldmatrix_x4(af[mi], &As[cur][r][ks + (lane / 16) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bf[4];
        const int r = warp_n * 32 + nj * 16 + (lane % 8) + (lane / 16) * 8;
        ldmatrix_x4(bf, &Bs[cur][r][ks + ((lane / 8) % 2) * 8]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          Num<T>::mma(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          Num<T>::mma(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the accumulator fragments: element e of tile
  // (mi, ni) sits at row g (+8 for e >= 2), columns 2t and 2t + 1.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + warp_n * 32 + ni * 8 + 2 * t;
    if (col >= n) continue;
    float b0 = 0.f, b1 = 0.f;
    if (EPI != kEpiStore) {
      b0 = Num<T>::to_f(bias[col]);
      b1 = Num<T>::to_f(bias[col + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 64 + mi * 16 + g + half * 8;
        if (row >= rows) continue;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        const size_t off = (size_t)row * n + col;
        if (EPI == kEpiBiasGelu) {
          v0 = gelu_erf(v0 + b0);
          v1 = gelu_erf(v1 + b1);
        } else if (EPI == kEpiBiasResidual) {
          // The residual adds in the compute dtype: T(res + T(acc + b)).
          const float p0 = Num<T>::to_f(Num<T>::from_f(v0 + b0));
          const float p1 = Num<T>::to_f(Num<T>::from_f(v1 + b1));
          v0 = Num<T>::to_f(res[off]) + p0;
          v1 = Num<T>::to_f(res[off + 1]) + p1;
        }
        *reinterpret_cast<uint32_t*>(out + off) = Num<T>::pack2(v0, v1);
      }
    }
  }
}

template <typename T>
cudaError_t layernorm_t(const void* x, const void* gamma, const void* beta, void* xn,
                        int rows, int d, float eps, cudaStream_t stream) {
  const int rows_per_block = 256 / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  layernorm_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(xn), rows, d, eps);
  return cudaGetLastError();
}

template <typename T, int EPI>
cudaError_t linear_t(const void* a, const void* w, const void* bias, const void* res, void* out,
                     int rows, int n, int k, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(linear_kernel<T, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  linear_kernel<T, EPI><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out), rows, n, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t linear_dispatch(const void* a, const void* w, const void* bias, const void* res,
                            void* out, int rows, int n, int k, int epi, cudaStream_t stream) {
  switch (epi) {
    case kEpiStore: return linear_t<T, kEpiStore>(a, w, bias, res, out, rows, n, k, stream);
    case kEpiBiasGelu: return linear_t<T, kEpiBiasGelu>(a, w, bias, res, out, rows, n, k, stream);
    case kEpiBiasResidual:
      return linear_t<T, kEpiBiasResidual>(a, w, bias, res, out, rows, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_layernorm(const void* x, const void* gamma, const void* beta, void* xn,
                             int rows, int d, float eps, int dtype, cudaStream_t stream) {
  if (d % 8 != 0 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == kBF16) return layernorm_t<__nv_bfloat16>(x, gamma, beta, xn, rows, d, eps, stream);
  if (dtype == kF16) return layernorm_t<__half>(x, gamma, beta, xn, rows, d, eps, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_linear(const void* a, const void* w, const void* bias, const void* res,
                          void* out, int rows, int n, int k, int epilogue, int dtype,
                          cudaStream_t stream) {
  if (k % 8 != 0 || n % 8 != 0 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == kBF16)
    return linear_dispatch<__nv_bfloat16>(a, w, bias, res, out, rows, n, k, epilogue, stream);
  if (dtype == kF16)
    return linear_dispatch<__half>(a, w, bias, res, out, rows, n, k, epilogue, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit
