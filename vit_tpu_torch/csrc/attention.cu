// Multi-head softmax attention over the packed qkv projection, forward and
// backward, written by hand for Hopper with mma.sync m16n8k16 (f32
// accumulation).  These are the per-head middles of the TPU block kernels
// (vit_tpu/ops/fused_attention_block.py _fwd_kernel, lines 124-157, and
// _bwd_kernel, lines 196-238).
//
// Forward:
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
//
// Backward, the FA2 split (each CTA one (image, head, 64-row tile), so no
// atomics and no limit on n):
//   1. mha_bwd_dq, per 64-query tile: a first pass over the key tiles takes
//      each row's log-sum-exp and dsum = Σ_j dp·p (dp = do·vᵀ, both in f32, as
//      the TPU kernel at :224, not rowsum(dO∘O) over the rounded output); a
//      second pass recomputes p = exp(s - lse) and ds = T(p·(dp - dsum)·scale)
//      and accumulates dq = ds·k.  Writes lse and dsum for step 2.
//   2. mha_bwd_dkv, per 64-key tile: over every query tile, recompute pᵀ and
//      dsᵀ and accumulate dv = T(p)ᵀ·do and dk = dsᵀ·q.
// Keys past n get p = 0 (-inf logits), query rows past n get p = 0 in step 2,
// so neither adds to dq, dk or dv; rows past n are not stored.  The price of
// the split is recomputation: 9 products per element pair against the TPU
// kernel's 5.  Bound on the H100: at ViT-B/16 the 5 products are 19 GFLOP per
// layer against 1.6 ms of the step, small next to the block's GEMMs.
#include "kernels.cuh"

namespace vit {
namespace {

constexpr int kBQ = 64, kBKV = 64, kThreads = 128;
static_assert(kBQ == kBKV, "one staging loop serves the q, k and v tiles");

template <int DH>
constexpr int smem_bytes() {
  return 3 * kBQ * (DH + 8) * 2;
}

// Stage `nrows` rows of one head (DH columns) from a row-strided source,
// starting at token r0; tokens at or past n land as zeros.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(T (*dst)[DH + 8], const T* src, size_t ld, int r0,
                                           int nrows, int n) {
  constexpr int kChunksPerRow = DH / 8;
  for (int c = threadIdx.x; c < nrows * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + col);
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

// Store the warp's 16 x DH accumulator rows (tokens r0 + g, r0 + g + 8) into a
// row-strided output, rounded; rows at or past n are skipped.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* dst, size_t ld, int r0, int n,
                                           const float (&acc)[DH / 8][4], int lane) {
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

  stage_rows<T, DH>(Qs, qp, ld, q0, kBQ, n);
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
    stage_rows<T, DH>(Ks, kp, ld, kv0, kBKV, n);
    stage_rows<T, DH>(Vs, vp, ld, kv0, kBKV, n);
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


// ---- backward -----------------------------------------------------------------

// Key (query) tile of the inner loops: 32 at dim_head 128 keeps the
// accumulators in registers.
template <int DH>
constexpr int kBwdTile = DH >= 128 ? 32 : 64;

template <int DH>
constexpr int bwd_smem_bytes() {
  return (2 * kBQ + 2 * kBwdTile<DH>) * (DH + 8) * 2 + kBwdTile<DH> * 8;
}

// One CTA per (64-query tile, head, image): row statistics, then dq.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                      T* __restrict__ dqkv, float2* __restrict__ rowstat, int n, int heads,
                      float scale) {
  constexpr int kRow = DH + 8, KT = kBwdTile<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Qs)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*Ds)[kRow] = Qs + kBQ;
  T(*Ks)[kRow] = Ds + kBQ;
  T(*Vs)[kRow] = Ks + KT;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4;
  const int inner = heads * DH;
  const size_t ld = 3 * (size_t)inner;
  const T* base = qkv + (size_t)b * n * ld + h * DH;
  const T* dbase = dout + (size_t)b * n * inner + h * DH;
  const int a0 = warp * 16;

  stage_rows<T, DH>(Qs, base, ld, q0, kBQ, n);
  stage_rows<T, DH>(Ds, dbase, inner, q0, kBQ, n);

  // s = q·kᵀ·scale (keys past n: -inf) and dp = do·vᵀ for one key tile.
  float s[KT / 8][4], dp[KT / 8][4];
  auto tile = [&](int kv0) {
    __syncthreads();  // the previous tile's reads are done (and Qs/Ds are staged)
    stage_rows<T, DH>(Ks, base + inner, ld, kv0, KT, n);
    stage_rows<T, DH>(Vs, base + 2 * inner, ld, kv0, KT, n);
    __syncthreads();
    zero(s);
    zero(dp);
    mma_abt<T, DH, KT>(s, Qs, a0, Ks, lane);
    mma_abt<T, DH, KT>(dp, Ds, a0, Vs, lane);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = kv0 + j * 8 + 2 * t + (e & 1) < n ? s[j][e] * scale : -INFINITY;
  };

  // Pass 1: running max m, Σ e and Σ e·dp (e = exp(s - m)), rescaled as m
  // grows; then lse = m + log Σ e and dsum = Σ e·dp / Σ e = Σ p·dp.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, w_run[2] = {0.f, 0.f};
  for (int kv0 = 0; kv0 < n; kv0 += KT) {
    tile(kv0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: the tile has a valid key
      const float alpha = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha;
      w_run[r] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[j][e] - m_run[e / 2]);
        l_run[e / 2] += pe;
        w_run[e / 2] += pe * dp[j][e];
      }
  }
  float lse[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    lse[r] = m_run[r] + logf(l);
    dsum[r] = quad_sum(w_run[r]) / l;
    const int q = q0 + a0 + lane / 4 + r * 8;
    if (t == 0 && q < n) rowstat[((size_t)b * heads + h) * n + q] = make_float2(lse[r], dsum[r]);
  }

  // Pass 2: dq = Σ_j T(p·(dp - dsum)·scale)·k.
  float dq[DH / 8][4];
  zero(dq);
  for (int kv0 = 0; kv0 < n; kv0 += KT) {
    tile(kv0);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[j][e] - lse[e / 2]);  // 0 for keys past n
        s[j][e] = pe * (dp[j][e] - dsum[e / 2]) * scale;
      }
    mma_pv<T, DH, KT>(dq, s, Ks, lane);
  }
  store_rows<T, DH>(dqkv + (size_t)b * n * ld + h * DH, ld, q0 + a0, n, dq, lane);
}

// One CTA per (64-key tile, head, image): dk and dv over every query tile.
// Each warp owns 16 keys, so the products run transposed: sᵀ = k·qᵀ.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       T* __restrict__ dqkv, const float2* __restrict__ rowstat, int n,
                       int heads, float scale) {
  constexpr int kRow = DH + 8, QT = kBwdTile<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Ks)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*Vs)[kRow] = Ks + kBKV;
  T(*Qs)[kRow] = Vs + kBKV;
  T(*Ds)[kRow] = Qs + QT;
  float2* st = reinterpret_cast<float2*>(Ds + QT);

  const int j0 = blockIdx.x * kBKV, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4;
  const int inner = heads * DH;
  const size_t ld = 3 * (size_t)inner;
  const T* base = qkv + (size_t)b * n * ld + h * DH;
  const T* dbase = dout + (size_t)b * n * inner + h * DH;
  const float2* stats = rowstat + ((size_t)b * heads + h) * n;
  const int a0 = warp * 16;

  stage_rows<T, DH>(Ks, base + inner, ld, j0, kBKV, n);
  stage_rows<T, DH>(Vs, base + 2 * inner, ld, j0, kBKV, n);

  float dk[DH / 8][4], dv[DH / 8][4];
  zero(dk);
  zero(dv);
  for (int i0 = 0; i0 < n; i0 += QT) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, DH>(Qs, base, ld, i0, QT, n);
    stage_rows<T, DH>(Ds, dbase, inner, i0, QT, n);
    for (int i = threadIdx.x; i < QT; i += kThreads)
      st[i] = i0 + i < n ? stats[i0 + i] : make_float2(0.f, 0.f);
    __syncthreads();

    float s[QT / 8][4], dp[QT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, DH, QT>(s, Ks, a0, Qs, lane);   // sᵀ[key][query]
    mma_abt<T, DH, QT>(dp, Vs, a0, Ds, lane);  // dpᵀ[key][query] = v·do
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        const float2 rs = st[qi];
        // Query rows past n add nothing.
        const float pe = i0 + qi < n ? expf(s[j][e] * scale - rs.x) : 0.f;
        s[j][e] = pe;
        dp[j][e] = pe * (dp[j][e] - rs.y) * scale;
      }
    mma_pv<T, DH, QT>(dv, s, Ds, lane);   // dv += T(pᵀ)·do
    mma_pv<T, DH, QT>(dk, dp, Qs, lane);  // dk += T(dsᵀ)·q
  }
  T* out = dqkv + (size_t)b * n * ld + h * DH;
  store_rows<T, DH>(out + inner, ld, j0 + a0, n, dk, lane);
  store_rows<T, DH>(out + 2 * inner, ld, j0 + a0, n, dv, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DH>
cudaError_t mha_bwd_t(const void* qkv, const void* dout, void* dqkv, float* rowstat, int b,
                      int n, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = bwd_smem_bytes<DH>();
  cudaError_t err = allow_smem(mha_bwd_dq_kernel<T, DH>, bytes);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dkv_kernel<T, DH>, bytes);
  if (err != cudaSuccess) return err;
  static_assert(kBQ == kBKV, "one grid serves both kernels");
  dim3 grid((n + kBQ - 1) / kBQ, heads, b);
  float2* stats = reinterpret_cast<float2*>(rowstat);
  mha_bwd_dq_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv), stats, n,
      heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv), stats, n,
      heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mha_bwd_dispatch(const void* qkv, const void* dout, void* dqkv, float* rowstat,
                             int b, int n, int heads, int dim_head, float scale,
                             cudaStream_t stream) {
  switch (dim_head) {
    case 32: return mha_bwd_t<T, 32>(qkv, dout, dqkv, rowstat, b, n, heads, scale, stream);
    case 64: return mha_bwd_t<T, 64>(qkv, dout, dqkv, rowstat, b, n, heads, scale, stream);
    case 128: return mha_bwd_t<T, 128>(qkv, dout, dqkv, rowstat, b, n, heads, scale, stream);
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

cudaError_t launch_mha_bwd(const void* qkv, const void* dout, void* dqkv, float* rowstat,
                           int b, int n, int heads, int dim_head, float scale, int dtype,
                           cudaStream_t stream) {
  if (b < 0 || n < 0 || heads <= 0) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  if (dtype == kBF16)
    return mha_bwd_dispatch<__nv_bfloat16>(qkv, dout, dqkv, rowstat, b, n, heads, dim_head,
                                           scale, stream);
  if (dtype == kF16)
    return mha_bwd_dispatch<__half>(qkv, dout, dqkv, rowstat, b, n, heads, dim_head, scale,
                                    stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit
