// Tile helpers of the mma.sync attention kernels (attention.cu, the block's
// multi-head attention over packed qkv; short_attention.cu's backward, which
// takes the fragment helpers below and reads TMA's swizzled tiles itself).  A
// block is four warps; each warp owns 16 rows of a 64-row tile, and its
// products run on mma.sync m16n8k16 with f32 accumulation.  Tiles live in
// shared memory as rows of DH + 8 elements, so that ldmatrix's eight row
// addresses fall in distinct banks.
#pragma once

#include "kernels.cuh"

namespace vit {

constexpr int kAttnThreads = 128;

// A head width rounded up to the mma k-step of 16 (40 -> 48).
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// Stage `nrows` rows of one head (DH columns) from a row-strided source,
// starting at token r0, into shared rows of DP >= DH columns; tokens at or
// past n, and columns DH..DP-1, land as zeros (a head width that no mma
// k-step divides is padded here, never in device memory).  NT threads of
// the block take part.
template <typename T, int DH, int DP = DH, int NT = kAttnThreads>
__device__ __forceinline__ void stage_rows(T (*dst)[DP + 8], const T* src, size_t ld, int r0,
                                           int nrows, int n) {
  constexpr int kChunksPerRow = DP / 8;
  for (int c = threadIdx.x; c < nrows * kChunksPerRow; c += NT) {
    const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if ((DP == DH || col < DH) && r0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = v;
  }
}

// acc (16 x NT) += A · Bᵀ for the warp's 16 rows of A (from row a0 of As) and
// the NT rows of Bs, both DH-contiguous in shared memory.
template <typename T, int DH, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT / 8][4], T (*As)[DH + 8], int a0,
                                        T (*Bs)[DH + 8], int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, &As[a0 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int nj = 0; nj < NT / 16; ++nj) {
      uint32_t bf[4];
      ldmatrix_x4(bf, &Bs[nj * 16 + (lane % 8) + (lane / 16) * 8][kk * 16 + ((lane / 8) % 2) * 8]);
      Num<T>::mma(acc[2 * nj], af, bf[0], bf[1]);
      Num<T>::mma(acc[2 * nj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x DH) += T(P) · V with P (16 x NT) given as f32 accumulator tiles
// (those of n-tiles 2c and 2c+1 are exactly the A fragment of k16 chunk c) and
// V (NT x DH) in shared memory.
template <typename T, int DH, int NT>
__device__ __forceinline__ void mma_pv(float (&acc)[DH / 8][4], const float (&p)[NT / 8][4],
                                       T (*Vs)[DH + 8], int lane) {
#pragma unroll
  for (int c = 0; c < NT / 16; ++c) {
    uint32_t pf[4];
    pf[0] = Num<T>::pack2(p[2 * c][0], p[2 * c][1]);
    pf[1] = Num<T>::pack2(p[2 * c][2], p[2 * c][3]);
    pf[2] = Num<T>::pack2(p[2 * c + 1][0], p[2 * c + 1][1]);
    pf[3] = Num<T>::pack2(p[2 * c + 1][2], p[2 * c + 1][3]);
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, &Vs[c * 16 + (lane % 8) + ((lane / 8) % 2) * 8][dn * 16 + (lane / 16) * 8]);
      Num<T>::mma(acc[2 * dn], pf, vf[0], vf[1]);
      Num<T>::mma(acc[2 * dn + 1], pf, vf[2], vf[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// Sum over the four threads of a quad (they hold one row's columns).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store the first DH columns of the warp's 16 x DP accumulator rows (tokens
// r0 + g, r0 + g + 8) into a row-strided output, rounded; rows at or past n
// are skipped.
template <typename T, int DH, int DP = DH>
__device__ __forceinline__ void store_rows(T* dst, size_t ld, int r0, int n,
                                           const float (&acc)[DP / 8][4], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8;
    if (r >= n) continue;
    T* row = dst + (size_t)r * ld;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8 + 2 * t) =
          Num<T>::pack2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace vit
