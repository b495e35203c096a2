// The row statistics and the bias gradient of the attention block's dbias
// call, over the packed qkv projection, written by hand for Hopper with
// mma.sync m16n8k16 (f32 accumulation).  These are the parts of the TPU block
// backward (vit_tpu/ops/fused_attention_block.py _bwd_kernel, :169) that
// fused_attention_block_bias's gradient dbias (:225-228) needs and the flash
// and short backwards do not compute: each query row's exact dsum = Σ_j p·dp
// (the TPU kernel's, :224) and dbias = Σ p·(dp - dsum) over the images (and
// the heads, for a shared bias).  The attention itself runs elsewhere: up to
// 512 tokens on short_attention.cu's short_fwd / short_bwd, past them on
// flash_attention.cu's flash kernels (fused_attention_block.cu).
//
//   1. mha_row_stats (mha_row_stats_kernel), one CTA of four warps per
//      (64-query tile, head, image): over the key tiles, s = q·kᵀ·scale +
//      bias (keys past n: -inf) and dp = do·vᵀ, a running max m, Σ e and Σ
//      e·dp (e = exp(s - m)), rescaled as m grows; then each row's lse = m +
//      log Σ e and dsum = Σ e·dp / Σ e, both f32, into `rowstat`.  The
//      attention backward of the dbias call (short_bwd, or the biased flash
//      backward) takes that dsum in place of D = rowsum(dO∘O): D's bf16 error
//      does not cancel in dbias's sum over the batch.
//   2. mha_dbias (mha_bwd_dbias_kernel), one CTA per (key tile, query tile,
//      bias head, part of the (image, head) pairs that share the bias head):
//      recomputes s and dp and sums ds0 = p·(dp - dsum) (before the scale),
//      p = exp(s - lse) from the row statistics, over its pairs in a fixed
//      order; colsum then adds the parts in order.  The TPU summed dbias
//      across its sequential grid; blocks on the H100 run in no order, so
//      there are no float atomics and the bits repeat from run to run.
//      Memory: the parts, not per-(image, head) partials (64·16·257²·4 B =
//      270 MB at the small-dataset shape): about two waves of CTAs, 11 parts
//      of 264 KB for a shared bias there.
// The bias, (1 | heads, n, n) f32, is read from device memory (L2) where the
// ragged-key mask is applied and never leaves f32: LSA's self-mask is
// -f32.max, which bf16 (or an exp2/log2e fold) would turn into -inf, and -inf
// - (-inf) in the running max is NaN.  At n = 257 the last key tile holds one
// valid key, which for query 256 is its own masked diagonal: the tile max
// stays finite and its exp is 0.  Rows and keys past n are neither summed nor
// stored.
//
// Bound on the H100: pass 1 is two n x n x dh products (q·kᵀ, do·vᵀ), the
// dbias pass two more, all far below the tensor cores' rate next to the
// block's GEMMs at the small-dataset ViT (n 257, 16 heads of 64, batch 64:
// 4·b·heads·n²·dh = 17.3 GFLOP a pass); both stage their tiles synchronously
// through padded shared memory (Queue 2 of ROADMAP.md: their redesign).
//
// The tile helpers (staging, the mma.sync product) are in attention_tiles.cuh.
#include "attention_tiles.cuh"

namespace vit {
namespace {

constexpr int kBQ = 64, kBKV = 64, kThreads = kAttnThreads;
static_assert(kBQ == kBKV, "one staging loop serves the q, k and v tiles");

// The f32 bias row of query row q, `head_offset` into the bias (a row past n
// reads row n - 1's: its results are never stored).
__device__ __forceinline__ const float* bias_row(const float* bias, size_t head_offset, int q,
                                                 int n) {
  return bias + head_offset + (size_t)min(q, n - 1) * n;
}

// Head stride of a (1 | heads, n, n) bias: 0 when one bias is shared.
size_t bias_stride(int hb, int n) { return hb > 1 ? (size_t)n * n : 0; }

// ---- row statistics and dbias ---------------------------------------------------

// Key tile of the pass: 32 at dim_head 128 keeps the accumulators in
// registers.
template <int DH>
constexpr int kStatTile = DH >= 128 ? 32 : 64;

template <int DH>
constexpr int row_stats_smem_bytes() {
  return (2 * kBQ + 2 * kStatTile<DH>) * (DH + 8) * 2;
}

// One CTA per (64-query tile, head, image): each query row's (lse, dsum).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    mha_row_stats_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         const float* __restrict__ bias, size_t bias_hstride,
                         float2* __restrict__ rowstat, int n, int heads, float scale) {
  constexpr int kRow = DH + 8, KT = kStatTile<DH>;
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
#pragma unroll
  for (int r = 0; r < 2; ++r)
    brow[r] = bias_row(bias, h * bias_hstride, q0 + a0 + lane / 4 + r * 8, n);

  stage_rows<T, DH>(Qs, base, ld, q0, kBQ, n);
  stage_rows<T, DH>(Ds, dbase, inner, q0, kBQ, n);

  // Per key tile: s = q·kᵀ·scale + bias (keys past n: -inf) and dp = do·vᵀ;
  // a running max m, Σ e and Σ e·dp (e = exp(s - m)), rescaled as m grows.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, w_run[2] = {0.f, 0.f};
  for (int kv0 = 0; kv0 < n; kv0 += KT) {
    __syncthreads();  // the previous tile's reads are done (and Qs/Ds are staged)
    stage_rows<T, DH>(Ks, base + inner, ld, kv0, KT, n);
    stage_rows<T, DH>(Vs, base + 2 * inner, ld, kv0, KT, n);
    __syncthreads();
    float s[KT / 8][4], dp[KT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, DH, KT>(s, Qs, a0, Ks, lane);
    mma_abt<T, DH, KT>(dp, Ds, a0, Vs, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < n ? s[j][e] * scale + __ldg(brow[e / 2] + key) : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
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
  // lse = m + log Σ e and dsum = Σ e·dp / Σ e = Σ p·dp (every lane of the quad
  // takes part in the sums).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]), w = quad_sum(w_run[r]);
    const int q = q0 + a0 + lane / 4 + r * 8;
    if (t == 0 && q < n)
      rowstat[((size_t)b * heads + h) * n + q] = make_float2(m_run[r] + logf(l), w / l);
  }
}

// dbias: one CTA per (64-key tile, 64-query tile, bias head hz × part).  It
// sums ds0 = p·(dp - dsum) (the logits' gradient before the scale) over its
// part of the (image, head) pairs that share bias head hz (every head of an
// image when one bias is shared), in order, recomputing s and dp and taking
// p = exp(s - lse) and dsum from the row statistics; it writes its
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

template <typename T, int DH>
cudaError_t mha_row_stats_t(const void* qkv, const void* dout, float* rowstat, const float* bias,
                            int hb, int b, int n, int heads, float scale, cudaStream_t stream) {
  constexpr int bytes = row_stats_smem_bytes<DH>();
  cudaError_t err = allow_smem(mha_row_stats_kernel<T, DH>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBQ - 1) / kBQ, heads, b);
  mha_row_stats_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), bias, bias_stride(hb, n),
      reinterpret_cast<float2*>(rowstat), n, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mha_row_stats_dispatch(const void* qkv, const void* dout, float* rowstat,
                                   const float* bias, int hb, int b, int n, int heads,
                                   int dim_head, float scale, cudaStream_t stream) {
#define VIT_ROW_STATS(DH)                                                                      \
  if (dim_head == DH)                                                                          \
    return mha_row_stats_t<T, DH>(qkv, dout, rowstat, bias, hb, b, n, heads, scale, stream);
  VIT_ROW_STATS(32)
  VIT_ROW_STATS(64)
  VIT_ROW_STATS(128)
#undef VIT_ROW_STATS
  return cudaErrorInvalidValue;
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

// A bias is (1 | heads, n, n).
bool bias_ok(const float* bias, int hb, int heads) {
  return bias != nullptr && (hb == 1 || hb == heads);
}

}  // namespace

cudaError_t launch_mha_row_stats(const void* qkv, const void* dout, float* rowstat,
                                 const float* bias, int hb, int b, int n, int heads,
                                 int dim_head, float scale, int dtype, cudaStream_t stream) {
  if (b < 0 || n < 0 || heads <= 0 || !bias_ok(bias, hb, heads)) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  if (dtype == kBF16)
    return mha_row_stats_dispatch<__nv_bfloat16>(qkv, dout, rowstat, bias, hb, b, n, heads,
                                                 dim_head, scale, stream);
  if (dtype == kF16)
    return mha_row_stats_dispatch<__half>(qkv, dout, rowstat, bias, hb, b, n, heads, dim_head,
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
  if (b <= 0 || n <= 0 || heads <= 0 || !bias_ok(bias, hb, heads)) return cudaErrorInvalidValue;
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
