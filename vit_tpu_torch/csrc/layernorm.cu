// The LayerNorm passes of both block kernels, forward and backward, and the
// fixed-order column sums of their f32 parameter gradients (and of the cross-
// attention block's dy, its dbo).
//
// Forward: the TPU kernels normalise inside the block (fused_mlp.py:152-161,
// fused_attention_block.py:111-116).  Here it is its own memory-bound pass that
// writes xn in the compute dtype (the TPU kernel's rounding point): normalising
// each A tile in shared memory inside the GEMM sat on the critical path between
// the copy's wait and the barrier and halved the GEMM's rate (PERF.md), while
// the extra round trip of xn costs about 13 µs per block at B/16.
//
// Backward (fused_mlp.py _bwd_kernel:213-227, fused_attention_block.py
// _bwd_kernel:245-258), shared by the blocks, at the widths where it is not
// the dgrad's epilogue (gemm_wgmma.cu's kEpiLnBwd takes d % 256 == 0 in
// 256..2048, ln_bwd_fused; launch_dgrad_ln chooses): one warp per row recomputes
// the statistics from x and writes dx; a column pass sums dγ = Σ dxn·xhat,
// dβ = Σ dxn and the output bias's Σ dy over 64-row chunks, and a last pass
// adds the chunks in order.  The TPU accumulated these across its sequential
// grid; blocks on the H100 run in no order, and float atomics would make the
// bits differ from run to run.  Memory-bound: at B/16 the passes move about
// 0.2 GB (x, dy, the f32 dxn and dx), some 60 µs at 3.35 TB/s.
//
// Ragged widths (fused_mlp.cu's route at a d that is not a multiple of 8:
// T2T-ViT's token transformers, 147 and 1323): x, dy and dx lie at the
// module's row stride d, which no 16-byte load takes (a 147-wide bf16 row is
// 294 bytes), and xn, the copy xp of x and the f32 dxn at the GEMMs' stride ld
// (d rounded up to 8), their columns past d zero.  One warp per row reads two
// bytes a lane; the statistics and both means are over the true width d, as
// vit_tpu's _fwd_kernel normalises over its block's d (fused_mlp.py:147-173):
// zeros in the pad would add mean² a column to the two-pass variance.
#include "kernels.cuh"

namespace vit {
namespace {

constexpr int kRowsPerBlock = 256 / 32;  // one warp per row
constexpr int kColChunk = 64;            // rows per column-sum partial
constexpr int kColThreads = 128;

template <typename T>
struct Vec8 {
  float f[8];
  __device__ __forceinline__ explicit Vec8(const T* p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = Num<T>::to_f(e[i]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 mean and rstd of one row (biased two-pass variance, eps inside the
// rsqrt), as the TPU kernels' _ln_stats; every lane gets them.
template <typename T>
__device__ __forceinline__ void row_stats(const T* xr, int d, float eps, int lane, float& mean,
                                          float& rstd) {
  float sum = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    const Vec8<T> v(xr + c);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v.f[i];
  }
  mean = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    const Vec8<T> v(xr + c);
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (v.f[i] - mean) * (v.f[i] - mean);
  }
  rstd = rsqrtf(warp_sum(sq) / d + eps);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(Num<T>::pack2(f[0], f[1]), Num<T>::pack2(f[2], f[3]),
                 Num<T>::pack2(f[4], f[5]), Num<T>::pack2(f[6], f[7]));
}

template <typename T>
__global__ void __launch_bounds__(256) layernorm_kernel(const T* __restrict__ x,
                                                        const T* __restrict__ gamma,
                                                        const T* __restrict__ beta,
                                                        T* __restrict__ xn, int rows, int d,
                                                        float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  float mean, rstd;
  row_stats(xr, d, eps, lane, mean, rstd);
  T* outr = xn + (size_t)row * d;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    const Vec8<T> v(xr + c), gv(gamma + c), bv(beta + c);
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (v.f[i] - mean) * rstd * gv.f[i] + bv.f[i];
    store8(outr + c, f);
  }
}

// dx = T(dy + T(rstd·(dxhat - m1 - xhat·m2))) with dxhat = dxn·gamma,
// m1 = mean(dxhat), m2 = mean(dxhat·xhat), or T(rstd·(...)) when dy is null
// (a LayerNorm with no residual around it); writes (mean, rstd) per row.
template <typename T>
__global__ void __launch_bounds__(256)
    ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dxn,
                       const T* __restrict__ gamma, const T* __restrict__ dy,
                       T* __restrict__ dx, float2* __restrict__ stats, int rows, int d,
                       float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  const float* gr = dxn + (size_t)row * d;
  float mean, rstd;
  row_stats(xr, d, eps, lane, mean, rstd);

  auto dxhat8 = [&](int c, float (&xh)[8], float (&dh)[8]) {
    const Vec8<T> v(xr + c), gv(gamma + c);
    const float4 g0 = *reinterpret_cast<const float4*>(gr + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gr + c + 4);
    const float dn[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xh[i] = (v.f[i] - mean) * rstd;
      dh[i] = dn[i] * gv.f[i];
    }
  };

  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float xh[8], dh[8];
    dxhat8(c, xh, dh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1 += dh[i];
      s2 += dh[i] * xh[i];
    }
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float xh[8], dh[8], f[8];
    dxhat8(c, xh, dh);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = rstd * (dh[i] - m1 - xh[i] * m2);
    if (dy) {  // the residual adds in the compute dtype
      const Vec8<T> dyv(dy + (size_t)row * d + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = dyv.f[i] + Num<T>::round(f[i]);
    }
    store8(dx + (size_t)row * d + c, f);
  }
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// partial[chunk] = [Σ dxn·xhat | Σ dxn | Σ dy] over the chunk's rows, one
// thread per column; without dy the chunk's row is [Σ dxn·xhat | Σ dxn].  x
// and dy rows lie ldx apart, dxn's ldn (both d but at ragged widths).
template <typename T>
__global__ void __launch_bounds__(kColThreads)
    ln_bwd_cols_kernel(const T* __restrict__ x, const float* __restrict__ dxn,
                       const T* __restrict__ dy, const float2* __restrict__ stats,
                       float* __restrict__ partial, int rows, int d, int ldx, int ldn) {
  __shared__ float2 st[kColChunk];
  const int r0 = blockIdx.y * kColChunk;
  const int nr = min(kColChunk, rows - r0);
  for (int i = threadIdx.x; i < nr; i += kColThreads) st[i] = stats[r0 + i];
  __syncthreads();
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= d) return;
  float sg = 0.f, sb = 0.f, sy = 0.f;
  for (int i = 0; i < nr; ++i) {
    const size_t off = (size_t)(r0 + i) * ldx + c;
    const float g = dxn[(size_t)(r0 + i) * ldn + c];
    sg += g * ((Num<T>::to_f(x[off]) - st[i].x) * st[i].y);
    sb += g;
    if (dy) sy += Num<T>::to_f(dy[off]);
  }
  float* prow = partial + (size_t)blockIdx.y * (dy ? 3 : 2) * d;
  prow[c] = sg;
  prow[d + c] = sb;
  if (dy) prow[2 * d + c] = sy;
}

// f32 mean and rstd of a row of any width d, read two bytes a lane (the
// ragged route); every lane gets them.
template <typename T>
__device__ __forceinline__ void ragged_row_stats(const T* xr, int d, float eps, int lane,
                                                 float& mean, float& rstd) {
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += Num<T>::to_f(xr[c]);
  mean = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = Num<T>::to_f(xr[c]) - mean;
    sq += v * v;
  }
  rstd = rsqrtf(warp_sum(sq) / d + eps);
}

// xn (rows, ld) = T((x - mean)·rstd·gamma + beta) over x's first d columns
// (rows d apart) and 0 past them; xp (rows, ld) x with the same zero pad (the
// residual that fc2's epilogue reads at stride ld).
template <typename T>
__global__ void __launch_bounds__(256)
    layernorm_ragged_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                            const T* __restrict__ beta, T* __restrict__ xn, T* __restrict__ xp,
                            int rows, int d, int ld, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  float mean, rstd;
  ragged_row_stats(xr, d, eps, lane, mean, rstd);
  T* outr = xn + (size_t)row * ld;
  T* copyr = xp + (size_t)row * ld;
  for (int c = lane; c < ld; c += 32) {
    const bool in = c < d;
    const T v = in ? xr[c] : Num<T>::from_f(0.f);
    outr[c] = Num<T>::from_f(in ? (Num<T>::to_f(v) - mean) * rstd * Num<T>::to_f(gamma[c]) +
                                      Num<T>::to_f(beta[c])
                                : 0.f);
    copyr[c] = v;
  }
}

// ln_bwd_rows_kernel at a ragged width, with the residual dy: x, dy and dx
// rows d apart, dxn's ld.
template <typename T>
__global__ void __launch_bounds__(256)
    ln_bwd_rows_ragged_kernel(const T* __restrict__ x, const float* __restrict__ dxn,
                              const T* __restrict__ gamma, const T* __restrict__ dy,
                              T* __restrict__ dx, float2* __restrict__ stats, int rows, int d,
                              int ld, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  const float* gr = dxn + (size_t)row * ld;
  float mean, rstd;
  ragged_row_stats(xr, d, eps, lane, mean, rstd);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dh = gr[c] * Num<T>::to_f(gamma[c]);
    s1 += dh;
    s2 += dh * (Num<T>::to_f(xr[c]) - mean) * rstd;
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
  for (int c = lane; c < d; c += 32) {
    const float xh = (Num<T>::to_f(xr[c]) - mean) * rstd;
    const float f = rstd * (gr[c] * Num<T>::to_f(gamma[c]) - m1 - xh * m2);
    dx[(size_t)row * d + c] =
        Num<T>::from_f(Num<T>::to_f(dy[(size_t)row * d + c]) + Num<T>::round(f));
  }
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// dst (rows, ldd) = the first `cols` columns of src (rows, lds), and zeros
// past them, one thread an element of dst: 16-bit values moved as bits (the
// ragged route's pad of dy and unpad of y).
__global__ void __launch_bounds__(256)
    copy_rows_kernel(const uint16_t* __restrict__ src, int lds, uint16_t* __restrict__ dst,
                     int ldd, int cols, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const long long r = i / ldd;
  const int c = (int)(i - r * ldd);
  dst[i] = c < cols ? src[r * lds + c] : 0;
}

// partial[chunk] = Σ a over the chunk's rows, one thread per column.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
    rows_cols_kernel(const T* __restrict__ a, float* __restrict__ partial, int rows, int d) {
  const int r0 = blockIdx.y * kColChunk;
  const int nr = min(kColChunk, rows - r0);
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int i = 0; i < nr; ++i) s += Num<T>::to_f(a[(size_t)(r0 + i) * d + c]);
  partial[(size_t)blockIdx.y * d + c] = s;
}

__global__ void __launch_bounds__(256)
    colsum_kernel(const float* __restrict__ partial, int parts, int m, float* __restrict__ out) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= m) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(size_t)p * m + c];
  out[c] = s;
}

template <typename T>
cudaError_t column_sums_t(const void* a, float* partial, float* out, int rows, int d,
                          cudaStream_t stream) {
  const int chunks = ln_bwd_partial_rows(rows);
  rows_cols_kernel<T><<<dim3((d + kColThreads - 1) / kColThreads, chunks), kColThreads, 0,
                        stream>>>(static_cast<const T*>(a), partial, rows, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum(partial, chunks, d, out, stream);
}

template <typename T>
cudaError_t layernorm_t(const void* x, const void* gamma, const void* beta, void* xn,
                        int rows, int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(xn), rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_bwd_t(const void* x, const float* dxn, const void* gamma, const void* dy,
                     void* dx, float* stats, float* partial, float* sums, int rows, int d,
                     float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  float2* st = reinterpret_cast<float2*>(stats);
  ln_bwd_rows_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 256, 0, stream>>>(
      xt, dxn, static_cast<const T*>(gamma), dyt, static_cast<T*>(dx), st, rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = ln_bwd_partial_rows(rows);
  dim3 grid((d + kColThreads - 1) / kColThreads, chunks);
  ln_bwd_cols_kernel<T><<<grid, kColThreads, 0, stream>>>(xt, dxn, dyt, st, partial, rows, d, d,
                                                          d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum(partial, chunks, (dy ? 3 : 2) * d, sums, stream);
}

template <typename T>
cudaError_t layernorm_ragged_t(const void* x, const void* gamma, const void* beta, void* xn,
                               void* xp, int rows, int d, int ld, float eps,
                               cudaStream_t stream) {
  layernorm_ragged_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(xn), static_cast<T*>(xp), rows, d, ld, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_bwd_ragged_t(const void* x, const float* dxn, const void* gamma, const void* dy,
                            void* dx, float* stats, float* partial, float* sums, int rows, int d,
                            int ld, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  float2* st = reinterpret_cast<float2*>(stats);
  ln_bwd_rows_ragged_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 256, 0, stream>>>(
      xt, dxn, static_cast<const T*>(gamma), dyt, static_cast<T*>(dx), st, rows, d, ld, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = ln_bwd_partial_rows(rows);
  dim3 grid((d + kColThreads - 1) / kColThreads, chunks);
  ln_bwd_cols_kernel<T><<<grid, kColThreads, 0, stream>>>(xt, dxn, dyt, st, partial, rows, d, d,
                                                          ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum(partial, chunks, 3 * d, sums, stream);
}

}  // namespace

int ln_bwd_partial_rows(int rows) { return (rows + kColChunk - 1) / kColChunk; }

cudaError_t launch_layernorm(const void* x, const void* gamma, const void* beta, void* xn,
                             int rows, int d, float eps, int dtype, cudaStream_t stream) {
  if (d % 8 != 0 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == kBF16) return layernorm_t<__nv_bfloat16>(x, gamma, beta, xn, rows, d, eps, stream);
  if (dtype == kF16) return layernorm_t<__half>(x, gamma, beta, xn, rows, d, eps, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_ln_bwd(const void* x, const float* dxn, const void* gamma, const void* dy,
                          void* dx, float* stats, float* partial, float* sums, int rows, int d,
                          float eps, int dtype, cudaStream_t stream) {
  if (d % 8 != 0 || rows <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16)
    err = ln_bwd_t<__nv_bfloat16>(x, dxn, gamma, dy, dx, stats, partial, sums, rows, d, eps,
                                  stream);
  else if (dtype == kF16)
    err = ln_bwd_t<__half>(x, dxn, gamma, dy, dx, stats, partial, sums, rows, d, eps, stream);
  if (err == cudaSuccess) count_launch(kCountLnPasses);
  return err;
}

cudaError_t launch_layernorm_ragged(const void* x, const void* gamma, const void* beta,
                                    void* xn, void* xp, int rows, int d, int ld, float eps,
                                    int dtype, cudaStream_t stream) {
  if (d <= 0 || ld < d || ld % 8 != 0 || rows < 0 || !xp) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == kBF16)
    return layernorm_ragged_t<__nv_bfloat16>(x, gamma, beta, xn, xp, rows, d, ld, eps, stream);
  if (dtype == kF16)
    return layernorm_ragged_t<__half>(x, gamma, beta, xn, xp, rows, d, ld, eps, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_ln_bwd_ragged(const void* x, const float* dxn, const void* gamma,
                                 const void* dy, void* dx, float* stats, float* partial,
                                 float* sums, int rows, int d, int ld, float eps, int dtype,
                                 cudaStream_t stream) {
  if (d <= 0 || ld < d || rows <= 0 || !dy) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16)
    err = ln_bwd_ragged_t<__nv_bfloat16>(x, dxn, gamma, dy, dx, stats, partial, sums, rows, d,
                                         ld, eps, stream);
  else if (dtype == kF16)
    err = ln_bwd_ragged_t<__half>(x, dxn, gamma, dy, dx, stats, partial, sums, rows, d, ld, eps,
                                  stream);
  if (err == cudaSuccess) count_launch(kCountLnPasses);
  return err;
}

cudaError_t launch_copy_rows(const void* src, int lds, void* dst, int ldd, int rows, int cols,
                             cudaStream_t stream) {
  if (rows < 0 || cols < 0 || cols > lds || cols > ldd) return cudaErrorInvalidValue;
  const long long total = (long long)rows * ldd;
  if (total == 0) return cudaSuccess;
  copy_rows_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint16_t*>(src), lds, static_cast<uint16_t*>(dst), ldd, cols, total);
  return cudaGetLastError();
}

cudaError_t launch_column_sums(const void* a, float* partial, float* out, int rows, int d,
                               int dtype, cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (dtype == kBF16) return column_sums_t<__nv_bfloat16>(a, partial, out, rows, d, stream);
  if (dtype == kF16) return column_sums_t<__half>(a, partial, out, rows, d, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_colsum(const float* partial, int parts, int m, float* out,
                          cudaStream_t stream) {
  if (parts <= 0 || m <= 0) return cudaErrorInvalidValue;
  colsum_kernel<<<(m + 255) / 256, 256, 0, stream>>>(partial, parts, m, out);
  return cudaGetLastError();
}

}  // namespace vit

extern "C" int vit_ln_bwd_partial_rows(int rows) { return vit::ln_bwd_partial_rows(rows); }
