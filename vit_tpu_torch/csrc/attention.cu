// Multi-head softmax attention forward over the packed qkv projection, written
// by hand for Hopper with mma.sync m16n8k16 (f32 accumulation).  This is the
// per-head middle of the TPU block kernel (vit_tpu/ops/fused_attention_block.py
// _fwd_kernel, lines 124-157).
//
// One block of four warps takes one (image, head, 64-query tile); each warp
// owns 16 query rows.  q/k/v are read strided straight out of the packed
// (b, n, 3·inner) qkv, so there is no transpose pass.  Key tiles of 64 stream
// through shared memory with an online softmax in f32: `scale` multiplies the
// f32 logits, keys past n get -inf before the row max (no row is ever fully
// masked), P is rounded to the compute dtype for the P·V product and the
// divide by the f32 row sum comes after it (the TPU kernel's late divide).
// n has no limit.  Ragged query rows are computed on zeros and not stored.
//
// Bound on the H100: at ViT-B/16 (n=197, dim_head=64) the two products are
// 2·2·197²·64 FLOPs per head against 4·197·64 bytes of q/k/v/out, so this part
// is small next to the block's GEMMs; keeping P in registers (never in device
// memory) is what matters, and the design does that.
#include "kernels.cuh"

namespace vit {
namespace {

constexpr int kBQ = 64, kBKV = 64, kThreads = 128;
static_assert(kBQ == kBKV, "one staging loop serves the q, k and v tiles");

template <int DH>
constexpr int smem_bytes() {
  return 3 * kBQ * (DH + 8) * 2;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    mha_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                   float scale) {
  constexpr int kRow = DH + 8;  // padded smem row: ldmatrix without bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Qs)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*Ks)[kRow] = Qs + kBQ;
  T(*Vs)[kRow] = Ks + kBKV;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t = lane % 4;
  const int inner = heads * DH;
  const size_t ld = 3 * (size_t)inner;
  const T* base = qkv + (size_t)b * n * ld;
  const T* qp = base + h * DH;
  const T* kp = base + inner + h * DH;
  const T* vp = base + 2 * inner + h * DH;

  constexpr int kChunksPerRow = DH / 8;
  // Stage a tile of kBQ rows of one of q/k/v; rows at or past n are zeros.
  auto stage = [&](T(*dst)[kRow], const T* src, int r0) {
    for (int c = tid; c < kBQ * kChunksPerRow; c += kThreads) {
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + col);
      *reinterpret_cast<uint4*>(&dst[r][col]) = v;
    }
  };

  stage(Qs, qp, q0);
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(qf[kk], &Qs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // Rows g and g + 8 of the warp's 16: running max and this thread's share of
  // the running sum (the four threads of a quad are summed at the end).
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < n; kv0 += kBKV) {
    __syncthreads();  // the previous tile's K/V reads are done
    stage(Ks, kp, kv0);
    stage(Vs, vp, kv0);
    __syncthreads();

    float s[kBKV / 8][4];
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < kBKV / 16; ++nj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[nj * 16 + (lane % 8) + (lane / 16) * 8][kk * 16 + ((lane / 8) % 2) * 8]);
        Num<T>::mma(s[2 * nj], qf[kk], kf[0], kf[1]);
        Num<T>::mma(s[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        const float v = key < n ? s[j][e] * scale : -INFINITY;
        s[j][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: the tile has a valid key
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e / 2]);
        s[j][e] = p;
        l_run[e / 2] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // P·V: the S accumulators of key tiles 2c and 2c+1 are exactly the A
    // fragment of the k16 chunk c.
#pragma unroll
    for (int c = 0; c < kBKV / 16; ++c) {
      uint32_t pf[4];
      pf[0] = Num<T>::pack2(s[2 * c][0], s[2 * c][1]);
      pf[1] = Num<T>::pack2(s[2 * c][2], s[2 * c][3]);
      pf[2] = Num<T>::pack2(s[2 * c + 1][0], s[2 * c + 1][1]);
      pf[3] = Num<T>::pack2(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DH / 16; ++dn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &Vs[c * 16 + (lane % 8) + ((lane / 8) % 2) * 8][dn * 16 + (lane / 16) * 8]);
        Num<T>::mma(o[2 * dn], pf, vf[0], vf[1]);
        Num<T>::mma(o[2 * dn + 1], pf, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int g = lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + warp * 16 + g + half * 8;
    if (q >= n) continue;
    T* orow = out + ((size_t)b * n + q) * inner + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      // (o / l) as the TPU kernel divides, then rounded to the compute dtype.
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          Num<T>::pack2(o[j][2 * half] / l_run[half], o[j][2 * half + 1] / l_run[half]);
    }
  }
}

template <typename T, int DH>
cudaError_t mha_t(const void* qkv, void* out, int b, int n, int heads, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>();
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(mha_fwd_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((n + kBQ - 1) / kBQ, heads, b);
  mha_fwd_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mha_dispatch(const void* qkv, void* out, int b, int n, int heads, int dim_head,
                         float scale, cudaStream_t stream) {
  switch (dim_head) {
    case 32: return mha_t<T, 32>(qkv, out, b, n, heads, scale, stream);
    case 64: return mha_t<T, 64>(qkv, out, b, n, heads, scale, stream);
    case 128: return mha_t<T, 128>(qkv, out, b, n, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_mha_fwd(const void* qkv, void* out, int b, int n, int heads, int dim_head,
                           float scale, int dtype, cudaStream_t stream) {
  if (b < 0 || n < 0 || heads <= 0) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  if (dtype == kBF16) return mha_dispatch<__nv_bfloat16>(qkv, out, b, n, heads, dim_head, scale, stream);
  if (dtype == kF16) return mha_dispatch<__half>(qkv, out, b, n, heads, dim_head, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit
