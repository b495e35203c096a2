// Multi-head softmax attention over the packed qkv projection, forward and
// backward, written by hand for Hopper with mma.sync m16n8k16 (f32
// accumulation).  These are the per-head middles of the TPU block kernels
// (vit_tpu/ops/fused_attention_block.py _fwd_kernel, lines 124-157, and
// _bwd_kernel, lines 196-238), with and without the additive logits bias of
// fused_attention_block_bias (:137-139 forward, :209-211 backward) and its
// gradient dbias (:225-228).
//
// Forward:
//
// One block of four warps takes one (image, head, 64-query tile); each warp
// owns 16 query rows.  q/k/v are read strided straight out of the packed
// (b, n, 3·inner) qkv, so there is no transpose pass.  Key tiles of 64 stream
// through shared memory with an online softmax in f32: `scale` multiplies the
// f32 logits, the f32 bias (if any) is added to them, keys past n get -inf
// before the row max (no row is ever fully masked), P is rounded to the
// compute dtype for the P·V product and the divide by the f32 row sum comes
// after it (the TPU kernel's late divide).  n has no limit.  Ragged query rows
// are computed on zeros and not stored.
//
// The bias, (1 | heads, n, n) f32, is read from device memory (L2) at the
// point where the ragged-key mask is applied, one element per logit, and never
// leaves f32: LSA's self-mask is -f32.max, which bf16 (or an exp2/log2e fold)
// would turn into -inf, and -inf - (-inf) in the running max is NaN.  At
// n = 257 the last key tile holds one valid key, which for query 256 is its
// own masked diagonal: the tile max stays finite and its exp is 0.  Whether a
// kernel adds a bias is a template argument, so the unbiased instances are the
// code they were.
//
// Bound on the H100: at ViT-B/16 (n=197, dim_head=64) the two products are
// 2·2·197²·64 FLOPs per head against 4·197·64 bytes of q/k/v/out, so this part
// is small next to the block's GEMMs; keeping P in registers (never in device
// memory) is what matters, and the design does that.  At the small-dataset
// ViT (n=257, 16 heads of 64, batch 64) the products are 17.3 GFLOP and the
// bias adds 264 KB (one head) or 4.2 MB (16) of L2 reads per block.
//
// Backward, the FA2 split (each CTA one (image, head, 64-row tile), so no
// atomics and no limit on n):
//   1. mha_bwd_dq, per 64-query tile: a first pass over the key tiles takes
//      each row's log-sum-exp and dsum = Σ_j dp·p (dp = do·vᵀ, both in f32, as
//      the TPU kernel at :224, not rowsum(dO∘O) over the rounded output); a
//      second pass recomputes p = exp(s - lse) and ds = T(p·(dp - dsum)·scale)
//      and accumulates dq = ds·k.  Writes lse and dsum for step 2.
//   2. mha_bwd_dkv, per 64-key tile: over every query tile, recompute pᵀ and
//      dsᵀ and accumulate dv = T(p)ᵀ·do and dk = dsᵀ·q.  It reads the bias
//      transposed, so each (query tile × key tile) bias block is staged
//      through shared memory with row-wise loads.
//   3. only when dbias is asked for: mha_bwd_dbias, one CTA per (key tile,
//      query tile, bias head, part of the (image, head) pairs that share the
//      bias head), recomputes s and dp and sums ds0 = p·(dp - dsum) (before
//      the scale) over its pairs in a fixed order; colsum then adds the parts
//      in order.  The TPU summed dbias across its sequential grid; blocks on
//      the H100 run in no order, so there are no float atomics and the bits
//      repeat from run to run.  Memory: the parts, not per-(image, head)
//      partials (64·16·257²·4 B = 270 MB at the small-dataset shape): about
//      two waves of CTAs, 11 parts of 264 KB for a shared bias there.
// The s of steps 1-3 all carry the bias.  Keys past n get p = 0 (-inf
// logits), query rows past n get p = 0 in steps 2 and 3, so neither adds to
// dq, dk, dv or dbias; rows past n are not stored.  The price of the split is
// recomputation: 9 products per element pair against the TPU kernel's 5, 11
// with dbias.  Bound on the H100: at ViT-B/16 the 5 products are 19 GFLOP per
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

// The f32 bias row of query row q, `head_offset` into the bias (a row past n
// reads row n - 1's: its results are never stored).
__device__ __forceinline__ const float* bias_row(const float* bias, size_t head_offset, int q,
                                                 int n) {
  return bias + head_offset + (size_t)min(q, n - 1) * n;
}

// `bias` is (1 | heads, n, n) f32 with `bias_hstride` = 0 or n·n between heads;
// read only when BIAS.
template <typename T, int DH, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    mha_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                   size_t bias_hstride, T* __restrict__ out, int n, int heads, float scale) {
  constexpr int kRow = DH + 8;  // padded smem row: ldmatrix without bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Qs)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*Ks)[kRow] = Qs + kBQ;
  T(*Vs)[kRow] = Ks + kBKV;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int inner = heads * DH;
  const size_t ld = 3 * (size_t)inner;
  const T* base = qkv + (size_t)b * n * ld;
  const float* brow[2];  // bias rows of query rows g and g + 8
  if constexpr (BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias_row(bias, h * bias_hstride, q0 + warp * 16 + g + r * 8, n);
  }
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
        float v;
        if constexpr (BIAS)
          v = key < n ? s[j][e] * scale + __ldg(brow[e / 2] + key) : -INFINITY;
        else
          v = key < n ? s[j][e] * scale : -INFINITY;
        s[j][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: the tile has a valid key, and a bias is finite (-f32.max at most)
      const float m_new = fmaxf(m_run[r], mx[r]);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Head stride of a (1 | heads, n, n) bias: 0 when one bias is shared.
size_t bias_stride(int hb, int n) { return hb > 1 ? (size_t)n * n : 0; }

template <typename T, int DH, bool BIAS>
cudaError_t mha_t(const void* qkv, void* out, const float* bias, int hb, int b, int n,
                  int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>();
  cudaError_t err = allow_smem(mha_fwd_kernel<T, DH, BIAS>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBQ - 1) / kBQ, heads, b);
  mha_fwd_kernel<T, DH, BIAS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), bias, bias_stride(hb, n), static_cast<T*>(out), n, heads,
      scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t mha_bias_dispatch(const void* qkv, void* out, const float* bias, int hb, int b,
                              int n, int heads, float scale, cudaStream_t stream) {
  if (bias) return mha_t<T, DH, true>(qkv, out, bias, hb, b, n, heads, scale, stream);
  return mha_t<T, DH, false>(qkv, out, nullptr, 0, b, n, heads, scale, stream);
}

template <typename T>
cudaError_t mha_dispatch(const void* qkv, void* out, const float* bias, int hb, int b, int n,
                         int heads, int dim_head, float scale, cudaStream_t stream) {
  switch (dim_head) {
    case 32: return mha_bias_dispatch<T, 32>(qkv, out, bias, hb, b, n, heads, scale, stream);
    case 64: return mha_bias_dispatch<T, 64>(qkv, out, bias, hb, b, n, heads, scale, stream);
    case 128: return mha_bias_dispatch<T, 128>(qkv, out, bias, hb, b, n, heads, scale, stream);
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

// mha_bwd_dkv's bias tile (query tile × 64 keys) in shared memory: rows of 68
// floats, so that a warp's transposed read (8 keys × 4 queries) hits 32
// distinct banks.
constexpr int kBiasRow = kBKV + 4;

template <int DH, bool BIAS>
constexpr int dkv_smem_bytes() {
  return bwd_smem_bytes<DH>() + (BIAS ? kBwdTile<DH> * kBiasRow * 4 : 0);
}

// One CTA per (64-query tile, head, image): row statistics, then dq.
template <typename T, int DH, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                      const float* __restrict__ bias, size_t bias_hstride,
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
  const float* brow[2];  // bias rows of query rows g and g + 8 of the warp's 16
  if constexpr (BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias_row(bias, h * bias_hstride, q0 + a0 + lane / 4 + r * 8, n);
  }

  stage_rows<T, DH>(Qs, base, ld, q0, kBQ, n);
  stage_rows<T, DH>(Ds, dbase, inner, q0, kBQ, n);

  // s = q·kᵀ·scale + bias (keys past n: -inf) and dp = do·vᵀ for one key tile.
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
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        if constexpr (BIAS)
          s[j][e] = key < n ? s[j][e] * scale + __ldg(brow[e / 2] + key) : -INFINITY;
        else
          s[j][e] = key < n ? s[j][e] * scale : -INFINITY;
      }
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
template <typename T, int DH, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       const float* __restrict__ bias, size_t bias_hstride,
                       T* __restrict__ dqkv, const float2* __restrict__ rowstat, int n,
                       int heads, float scale) {
  constexpr int kRow = DH + 8, QT = kBwdTile<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Ks)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*Vs)[kRow] = Ks + kBKV;
  T(*Qs)[kRow] = Vs + kBKV;
  T(*Ds)[kRow] = Qs + QT;
  float2* st = reinterpret_cast<float2*>(Ds + QT);
  float(*Bs)[kBiasRow] = reinterpret_cast<float(*)[kBiasRow]>(st + QT);  // BIAS only

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
    if constexpr (BIAS) {
      // Bs[i][k] = bias[query i0 + i][key j0 + k], row by row (coalesced);
      // 0 past n, where nothing is summed or stored.  Unrolled, so that a
      // thread's loads are all in flight before the first store.
      const float* bt = bias + h * bias_hstride + (size_t)i0 * n + j0;
      constexpr int kPerThread = QT * kBKV / kThreads;
      static_assert(QT * kBKV % kThreads == 0 && kThreads % kBKV == 0, "whole rows per pass");
      float v[kPerThread];
      const int k = threadIdx.x % kBKV;
#pragma unroll
      for (int it = 0; it < kPerThread; ++it) {
        const int i = it * (kThreads / kBKV) + threadIdx.x / kBKV;
        v[it] = i0 + i < n && j0 + k < n ? __ldg(bt + (size_t)i * n + k) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kPerThread; ++it)
        Bs[it * (kThreads / kBKV) + threadIdx.x / kBKV][k] = v[it];
    }
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
        float pe;
        if constexpr (BIAS)
          pe = i0 + qi < n
                   ? expf(s[j][e] * scale + Bs[qi][a0 + lane / 4 + (e / 2) * 8] - rs.x)
                   : 0.f;
        else
          pe = i0 + qi < n ? expf(s[j][e] * scale - rs.x) : 0.f;
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

// dbias: one CTA per (64-key tile, 64-query tile, bias head hz × part).  It
// sums ds0 = p·(dp - dsum) (the logits' gradient before the scale) over its
// part of the (image, head) pairs that share bias head hz (every head of an
// image when one bias is shared), in order, recomputing s and dp and taking
// p = exp(s - lse) and dsum from the dq pass's row statistics; it writes its
// tile of partial[part][hz] (rows and keys past n are neither summed nor
// stored).
template <int DH>
constexpr int dbias_smem_bytes() {
  return 4 * kBQ * (DH + 8) * 2;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_dbias_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         const float2* __restrict__ rowstat, const float* __restrict__ bias,
                         float* __restrict__ partial, int b, int n, int heads, int hb, int parts,
                         float scale) {
  constexpr int kRow = DH + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Qs)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*Ds)[kRow] = Qs + kBQ;
  T(*Ks)[kRow] = Ds + kBQ;
  T(*Vs)[kRow] = Ks + kBKV;

  const int k0 = blockIdx.x * kBKV, q0 = blockIdx.y * kBQ;
  const int hz = blockIdx.z % hb, part = blockIdx.z / hb;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4;
  const int a0 = warp * 16;
  const int inner = heads * DH;
  const size_t ld = 3 * (size_t)inner, nn = (size_t)n * n;
  const int pairs = hb == 1 ? b * heads : b;
  const int per = (pairs + parts - 1) / parts;
  const int p_begin = part * per, p_end = min(pairs, p_begin + per);
  int qrow[2];
  const float* brow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + a0 + lane / 4 + r * 8;
    brow[r] = bias_row(bias, hz * nn, qrow[r], n);
  }

  float acc[kBKV / 8][4];
  zero(acc);
  for (int pi = p_begin; pi < p_end; ++pi) {
    const int img = hb == 1 ? pi / heads : pi;
    const int head = hb == 1 ? pi % heads : hz;
    const T* base = qkv + (size_t)img * n * ld + head * DH;
    __syncthreads();  // the previous pair's reads are done
    stage_rows<T, DH>(Qs, base, ld, q0, kBQ, n);
    stage_rows<T, DH>(Ds, dout + (size_t)img * n * inner + head * DH, inner, q0, kBQ, n);
    stage_rows<T, DH>(Ks, base + inner, ld, k0, kBKV, n);
    stage_rows<T, DH>(Vs, base + 2 * inner, ld, k0, kBKV, n);
    __syncthreads();
    float s[kBKV / 8][4], dp[kBKV / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, DH, kBKV>(s, Qs, a0, Ks, lane);
    mma_abt<T, DH, kBKV>(dp, Ds, a0, Vs, lane);
    const float2* stats = rowstat + ((size_t)img * heads + head) * n;
    float2 rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) rs[r] = qrow[r] < n ? stats[qrow[r]] : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1), r = e / 2;
        if (qrow[r] < n && key < n) {
          const float pe = expf(s[j][e] * scale + __ldg(brow[r] + key) - rs[r].x);
          acc[j][e] += pe * (dp[j][e] - rs[r].y);
        }
      }
  }
  float* out = partial + ((size_t)part * hb + hz) * nn;
#pragma unroll
  for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t + (e & 1), q = qrow[e / 2];
      if (q < n && key < n) out[(size_t)q * n + key] = acc[j][e];
    }
}

template <typename T, int DH, bool BIAS>
cudaError_t mha_bwd_t(const void* qkv, const void* dout, void* dqkv, float* rowstat,
                      const float* bias, int hb, int b, int n, int heads, float scale,
                      cudaStream_t stream) {
  constexpr int bytes = bwd_smem_bytes<DH>(), dkv_bytes = dkv_smem_bytes<DH, BIAS>();
  cudaError_t err = allow_smem(mha_bwd_dq_kernel<T, DH, BIAS>, bytes);
  if (err == cudaSuccess) err = allow_smem(mha_bwd_dkv_kernel<T, DH, BIAS>, dkv_bytes);
  if (err != cudaSuccess) return err;
  static_assert(kBQ == kBKV, "one grid serves both kernels");
  dim3 grid((n + kBQ - 1) / kBQ, heads, b);
  float2* stats = reinterpret_cast<float2*>(rowstat);
  const size_t hstride = bias_stride(hb, n);
  mha_bwd_dq_kernel<T, DH, BIAS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), bias, hstride,
      static_cast<T*>(dqkv), stats, n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkv_kernel<T, DH, BIAS><<<grid, kThreads, dkv_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), bias, hstride,
      static_cast<T*>(dqkv), stats, n, heads, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t mha_bwd_bias_dispatch(const void* qkv, const void* dout, void* dqkv, float* rowstat,
                                  const float* bias, int hb, int b, int n, int heads,
                                  float scale, cudaStream_t stream) {
  if (bias)
    return mha_bwd_t<T, DH, true>(qkv, dout, dqkv, rowstat, bias, hb, b, n, heads, scale,
                                  stream);
  return mha_bwd_t<T, DH, false>(qkv, dout, dqkv, rowstat, nullptr, 0, b, n, heads, scale,
                                 stream);
}

template <typename T>
cudaError_t mha_bwd_dispatch(const void* qkv, const void* dout, void* dqkv, float* rowstat,
                             const float* bias, int hb, int b, int n, int heads, int dim_head,
                             float scale, cudaStream_t stream) {
  switch (dim_head) {
    case 32:
      return mha_bwd_bias_dispatch<T, 32>(qkv, dout, dqkv, rowstat, bias, hb, b, n, heads,
                                          scale, stream);
    case 64:
      return mha_bwd_bias_dispatch<T, 64>(qkv, dout, dqkv, rowstat, bias, hb, b, n, heads,
                                          scale, stream);
    case 128:
      return mha_bwd_bias_dispatch<T, 128>(qkv, dout, dqkv, rowstat, bias, hb, b, n, heads,
                                           scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int DH>
cudaError_t mha_dbias_t(const void* qkv, const void* dout, const float* rowstat,
                        const float* bias, int hb, float* partial, int parts, float* dbias,
                        int b, int n, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = dbias_smem_bytes<DH>();
  cudaError_t err = allow_smem(mha_bwd_dbias_kernel<T, DH>, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBQ - 1) / kBQ;
  dim3 grid(tiles, tiles, hb * parts);
  mha_bwd_dbias_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      reinterpret_cast<const float2*>(rowstat), bias, partial, b, n, heads, hb, parts, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_colsum(partial, parts, hb * n * n, dbias, stream);
}

template <typename T>
cudaError_t mha_dbias_dispatch(const void* qkv, const void* dout, const float* rowstat,
                               const float* bias, int hb, float* partial, int parts,
                               float* dbias, int b, int n, int heads, int dim_head, float scale,
                               cudaStream_t stream) {
  switch (dim_head) {
    case 32:
      return mha_dbias_t<T, 32>(qkv, dout, rowstat, bias, hb, partial, parts, dbias, b, n,
                                heads, scale, stream);
    case 64:
      return mha_dbias_t<T, 64>(qkv, dout, rowstat, bias, hb, partial, parts, dbias, b, n,
                                heads, scale, stream);
    case 128:
      return mha_dbias_t<T, 128>(qkv, dout, rowstat, bias, hb, partial, parts, dbias, b, n,
                                 heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A bias is absent (nullptr), or (1 | heads, n, n).
bool bias_ok(const float* bias, int hb, int heads) {
  return bias == nullptr || hb == 1 || hb == heads;
}

}  // namespace

cudaError_t launch_mha_fwd(const void* qkv, void* out, const float* bias, int hb, int b, int n,
                           int heads, int dim_head, float scale, int dtype,
                           cudaStream_t stream) {
  if (b < 0 || n < 0 || heads <= 0 || !bias_ok(bias, hb, heads)) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  if (dtype == kBF16)
    return mha_dispatch<__nv_bfloat16>(qkv, out, bias, hb, b, n, heads, dim_head, scale, stream);
  if (dtype == kF16)
    return mha_dispatch<__half>(qkv, out, bias, hb, b, n, heads, dim_head, scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_mha_bwd(const void* qkv, const void* dout, void* dqkv, float* rowstat,
                           const float* bias, int hb, int b, int n, int heads, int dim_head,
                           float scale, int dtype, cudaStream_t stream) {
  if (b < 0 || n < 0 || heads <= 0 || !bias_ok(bias, hb, heads)) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  if (dtype == kBF16)
    return mha_bwd_dispatch<__nv_bfloat16>(qkv, dout, dqkv, rowstat, bias, hb, b, n, heads,
                                           dim_head, scale, stream);
  if (dtype == kF16)
    return mha_bwd_dispatch<__half>(qkv, dout, dqkv, rowstat, bias, hb, b, n, heads, dim_head,
                                    scale, stream);
  return cudaErrorInvalidValue;
}

int mha_dbias_parts(int b, int n, int heads, int hb) {
  if (b <= 0 || n <= 0 || heads <= 0 || hb <= 0) return 1;
  // Enough CTAs for about two waves on the current device's SMs, at most one
  // part per (image, head) pair.  The count fixes dbias's summation order:
  // the bits repeat on one kind of card, and may differ on a card with
  // another SM count.
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    (void)cudaGetLastError();
    sms = 132;
  }
  const int tiles = (n + kBQ - 1) / kBQ, per_part = tiles * tiles * hb;
  const int pairs = hb == 1 ? b * heads : b;
  const int parts = (2 * sms + per_part - 1) / per_part;
  return parts < pairs ? parts : pairs;
}

cudaError_t launch_mha_dbias(const void* qkv, const void* dout, const float* rowstat,
                             const float* bias, int hb, float* partial, float* dbias, int b,
                             int n, int heads, int dim_head, float scale, int dtype,
                             cudaStream_t stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || bias == nullptr || (hb != 1 && hb != heads))
    return cudaErrorInvalidValue;
  const int parts = mha_dbias_parts(b, n, heads, hb);
  if (dtype == kBF16)
    return mha_dbias_dispatch<__nv_bfloat16>(qkv, dout, rowstat, bias, hb, partial, parts,
                                             dbias, b, n, heads, dim_head, scale, stream);
  if (dtype == kF16)
    return mha_dbias_dispatch<__half>(qkv, dout, rowstat, bias, hb, partial, parts, dbias, b, n,
                                      heads, dim_head, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit
