// Flash attention on Hopper: an online-softmax forward that saves each query
// row's log-sum-exp, and the two-pass backward that recomputes the softmax
// from it.  q (b, h, n_q, dk), k (b, h, n_k, dk) and v (b, h, n_k, dv), any
// n_q and n_k, (dk, dv) ∈ {(32, 32), (40, 32), (64, 64), (96, 96), (128, 128)},
// bf16 or f16 operands, f32 accumulation on mma.sync m16n8k16.
//
// Replaces the TPU kernels
//   vit_tpu/ops/flash_attention.py:51     _flash_kernel (flash_attention, K/V
//                                         resident in VMEM, n_k <= 4096)
//   vit_tpu/ops/flash_attention_v2.py:38  _kernel (flash_attention_v2, K/V
//                                         streamed over the grid)
//   vit_tpu/ops/flash_backward.py:41      _dq_kernel
//   vit_tpu/ops/flash_backward.py:72      _dkv_kernel
//   vit_tpu/ops/flash_attention_packed.py:58  _packed_kernel (q/k/v
//                                         channel-packed, dk != dv allowed)
// and is the attention inside the fused cross-attention block
// (fused_cross_attention.cu).  The TPU's v1/v2 split was whether all of K fits
// in VMEM; here one forward streams K/V tiles through shared memory at any
// n_k, and covers both.  The packed kernel unrolled the heads over lane
// slices of one VMEM block; here the packed layout is a stride: head h of a
// (b, n, heads·d) map starts h·d elements into each row.
//
// q/k and v have their own head widths (ScalableViT's SSA: 40 and 32).  A q/k
// width that no mma k-step divides is zero-filled to the next multiple of 16
// in shared memory (40 -> 48: the extra columns add 0 to every logit), never
// padded in device memory; dq and dk are stored at the true width.
//
// Bound on the H100 (989 TFLOP/s bf16): the TPU kernels' own FLOPs, 4·b·h·
// n_q·n_k·d forward and 14·b·h·n_q·n_k·d backward (the cost estimates of
// flash_backward.py:163 and :189: 6 + 8), with d the mean of dk and dv.  At
// CvT-13's shapes, batch 64:
//   stage 1 @224 (n_q 3136, n_k 784, 1 head of 64): 40.3 GFLOP forward,
//     0.041 ms; 141 GFLOP backward, 0.143 ms;
//   stage 1 @384 (9216 x 2304): 348 GFLOP, 0.352 ms; 1.22 TFLOP, 1.23 ms;
//   stage 2 @384 (2304 x 576, 3 heads), per layer: 65 GFLOP, 0.066 ms;
//     228 GFLOP, 0.231 ms.
// The bytes (q, k, v, out, lse; 189 MB at 384 stage 1, 0.056 ms at 3.35 TB/s)
// are under a third of that, so the tensor cores bound every shape.  The
// design keeps the n_q x n_k scores in registers and never in device memory:
// only O(n) state (lse, and D in the backward) goes through it.
//
// Operands are read through element strides (batch, head, row; d contiguous),
// so the caller's layout is used as it lies: CvT's q is the channels-last map
// (b, n, h·d), its k and v the two halves of one (b, n, 2·h·d) projection.
// The outputs are written through strides too: the wrapper lays out, dq, dk
// and dv token-major, (b, n, h·d), which CvT's output projection reads as it
// lies.
//
// Forward (flash_fwd): one CTA of four warps per (64-query tile, head, image);
// each warp owns 16 query rows, its q fragments in registers.  64-key tiles of
// K and V are staged through shared memory; scores s = (q·kᵀ)·scale in f32,
// keys past n_k get -inf before the row max (every tile holds a valid key,
// so the max is finite), a running max and sum rescale the accumulator, and P
// is rounded to the compute dtype for P·V (the TPU kernel kept P in f32,
// flash_attention.py:76-80; the plain version rounds where this kernel does).
// The divide by the f32 row sum comes last, and lse = m + log l.  Query rows
// past n_q are computed on zeros and not stored.
//
// Backward, FA2's split, each output tile with one owner (no atomics, so the
// bits repeat):
//   0. flash_bwd_dsum: D = rowsum(dO∘O) in f32 over the stored output (as
//      flash_backward.py:135), one warp per query row.
//   1. flash_bwd_dq, one CTA per 64-query tile: over the key tiles, s and
//      dp = dO·vᵀ, p = exp(s - lse), ds = T(p·(dp - D)·scale), dq += ds·k.
//   2. flash_bwd_dkv, one CTA per 64-key tile: over the query tiles, sᵀ and
//      dpᵀ, dv += T(p)ᵀ·dO and dk += dsᵀ·q.
// Seven n_q x n_k x d products in all, as the TPU kernels count them.  With
// lse saved, the backward needs no statistics pass (the block kernels'
// mha_bwd_dq takes one).  Keys past n_k get p = 0 in step 1; query rows past
// n_q get p = 0 in step 2; rows past n_q or n_k are not stored.  At widths
// >= 96 the inner loops take 32-row tiles, so that the accumulators stay in
// registers.
#include "attention_tiles.cuh"

namespace vit {
namespace {

constexpr int kTile = 64;  // query rows of a forward or dq CTA, keys of a dkv CTA
constexpr int kThreads = kAttnThreads;

// Element strides of a (b, h, n, d) operand whose d axis is contiguous.
struct Strides {
  long long b, h, r;
};

// The (image b, head h) slice of a strided operand (P: T or const T).
template <typename P>
__device__ __forceinline__ P* head_base(P* p, Strides s, int b, int h) {
  return p + (long long)b * s.b + (long long)h * s.h;
}

// Rows of the inner loops' tiles in the backward, for the wider of q/k (padded)
// and v.
template <int DK, int DV>
constexpr int kBwdTile = (pad16(DK) > DV ? pad16(DK) : DV) >= 96 ? 32 : 64;

// q, k (pad16(DK) + 8 elements a row) and v (DV + 8) tiles of 64 rows.
template <int DK, int DV>
constexpr int fwd_smem_bytes() {
  return kTile * (2 * (pad16(DK) + 8) + DV + 8) * 2;
}

// A 64-row q|k and dO|v tile, an inner tile of each, the inner rows' (lse, D).
template <int DK, int DV>
constexpr int bwd_smem_bytes() {
  return (kTile + kBwdTile<DK, DV>) * (pad16(DK) + DV + 16) * 2 + kBwdTile<DK, DV> * 8;
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
                     const T* __restrict__ v, Strides vs, T* __restrict__ out, Strides os,
                     float* __restrict__ lse, int heads, int n_q, int n_k, float scale) {
  constexpr int KP = pad16(DK), kRowK = KP + 8, kRowV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Qs)[kRowK] = reinterpret_cast<T(*)[kRowK]>(smem_raw);
  T(*Ks)[kRowK] = Qs + kTile;
  T(*Vs)[kRowV] = reinterpret_cast<T(*)[kRowV]>(Ks + kTile);

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4;
  const T* kp = head_base(k, ks, b, h);
  const T* vp = head_base(v, vs, b, h);

  stage_rows<T, DK, KP>(Qs, head_base(q, qs, b, h), qs.r, q0, kTile, n_q);
  __syncthreads();
  uint32_t qf[KP / 16][4];
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk)
    ldmatrix_x4(qf[kk], &Qs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);

  float o[DV / 8][4];
  zero(o);
  // Rows g and g + 8 of the warp's 16: running max and this thread's share of
  // the running sum (the quad's four shares are added at the end).
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < n_k; kv0 += kTile) {
    __syncthreads();  // the previous tile's K/V reads are done
    stage_rows<T, DK, KP>(Ks, kp, ks.r, kv0, kTile, n_k);
    stage_rows<T, DV>(Vs, vp, vs.r, kv0, kTile, n_k);
    __syncthreads();

    float s[kTile / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < kTile / 16; ++nj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[nj * 16 + (lane % 8) + (lane / 16) * 8][kk * 16 + ((lane / 8) % 2) * 8]);
        Num<T>::mma(s[2 * nj], qf[kk], kf[0], kf[1]);
        Num<T>::mma(s[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < n_k ? s[j][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
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
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e / 2]);
        s[j][e] = p;
        l_run[e / 2] += p;
      }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    mma_pv<T, DV, kTile>(o, s, Vs, lane);  // o += T(p)·v
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l_run[r]);
    const int qi = q0 + warp * 16 + lane / 4 + r * 8;
    if (t == 0 && qi < n_q) lse[((size_t)b * heads + h) * n_q + qi] = m_run[r] + logf(l[r]);
  }
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {  // the late divide, then one rounding in store_rows
    o[j][0] /= l[0];
    o[j][1] /= l[0];
    o[j][2] /= l[1];
    o[j][3] /= l[1];
  }
  store_rows<T, DV>(head_base(out, os, b, h), os.r, q0 + warp * 16, n_q, o, lane);
}

// D = rowsum(dO∘O) in f32, one warp per row of the flattened (b, h, n_q).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dsum_kernel(const T* __restrict__ o, Strides os, const T* __restrict__ dout,
                          Strides ds, float* __restrict__ dsum, int heads, int n_q, int d,
                          long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(row % n_q), h = (int)((row / n_q) % heads), b = (int)(row / n_q / heads);
  const T* orow = head_base(o, os, b, h) + (long long)i * os.r;
  const T* drow = head_base(dout, ds, b, h) + (long long)i * ds.r;
  float acc = 0.f;
  for (int c = 2 * lane; c < d; c += 64)
    acc += Num<T>::to_f(orow[c]) * Num<T>::to_f(drow[c]) +
           Num<T>::to_f(orow[c + 1]) * Num<T>::to_f(drow[c + 1]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// One CTA per (64-query tile, head, image): dq over every key tile.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
                        const T* __restrict__ v, Strides vs, const T* __restrict__ dout,
                        Strides dos, const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq, Strides dqs,
                        int heads, int n_q, int n_k, float scale) {
  constexpr int KP = pad16(DK), kRowK = KP + 8, kRowV = DV + 8, KT = kBwdTile<DK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Qs)[kRowK] = reinterpret_cast<T(*)[kRowK]>(smem_raw);
  T(*Ds)[kRowV] = reinterpret_cast<T(*)[kRowV]>(Qs + kTile);
  T(*Ks)[kRowK] = reinterpret_cast<T(*)[kRowK]>(Ds + kTile);
  T(*Vs)[kRowV] = reinterpret_cast<T(*)[kRowV]>(Ks + KT);

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4;
  const int a0 = warp * 16;
  const T* kp = head_base(k, ks, b, h);
  const T* vp = head_base(v, vs, b, h);
  stage_rows<T, DK, KP>(Qs, head_base(q, qs, b, h), qs.r, q0, kTile, n_q);
  stage_rows<T, DV>(Ds, head_base(dout, dos, b, h), dos.r, q0, kTile, n_q);
  float row_lse[2], row_d[2];  // rows g and g + 8 of the warp's 16 (0 past n_q: not stored)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + a0 + lane / 4 + r * 8;
    const size_t at = ((size_t)b * heads + h) * n_q + qi;
    row_lse[r] = qi < n_q ? lse[at] : 0.f;
    row_d[r] = qi < n_q ? dsum[at] : 0.f;
  }

  float acc[KP / 8][4];
  zero(acc);
  for (int kv0 = 0; kv0 < n_k; kv0 += KT) {
    __syncthreads();  // the previous tile's reads are done (and Qs/Ds are staged)
    stage_rows<T, DK, KP>(Ks, kp, ks.r, kv0, KT, n_k);
    stage_rows<T, DV>(Vs, vp, vs.r, kv0, KT, n_k);
    __syncthreads();
    float s[KT / 8][4], dp[KT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, KP, KT>(s, Qs, a0, Ks, lane);   // s = q·kᵀ
    mma_abt<T, DV, KT>(dp, Ds, a0, Vs, lane);  // dp = dO·vᵀ
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1), r = e / 2;
        const float p = key < n_k ? expf(s[j][e] * scale - row_lse[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_d[r]) * scale;  // ds
      }
    mma_pv<T, KP, KT>(acc, s, Ks, lane);  // dq += T(ds)·k
  }
  store_rows<T, DK, KP>(head_base(dq, dqs, b, h), dqs.r, q0 + a0, n_q, acc, lane);
}

// One CTA per (64-key tile, head, image): dk and dv over every query tile.
// Each warp owns 16 keys, so the products run transposed: sᵀ = k·qᵀ.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k,
                         Strides ks, const T* __restrict__ v, Strides vs,
                         const T* __restrict__ dout, Strides dos, const float* __restrict__ lse,
                         const float* __restrict__ dsum, T* __restrict__ dk, Strides dks,
                         T* __restrict__ dv, Strides dvs, int heads, int n_q, int n_k,
                         float scale) {
  constexpr int KP = pad16(DK), kRowK = KP + 8, kRowV = DV + 8, QT = kBwdTile<DK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Ks)[kRowK] = reinterpret_cast<T(*)[kRowK]>(smem_raw);
  T(*Vs)[kRowV] = reinterpret_cast<T(*)[kRowV]>(Ks + kTile);
  T(*Qs)[kRowK] = reinterpret_cast<T(*)[kRowK]>(Vs + kTile);
  T(*Ds)[kRowV] = reinterpret_cast<T(*)[kRowV]>(Qs + QT);
  float2* st = reinterpret_cast<float2*>(Ds + QT);  // (lse, D) of the tile's query rows

  const int j0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4;
  const int a0 = warp * 16;
  const T* qp = head_base(q, qs, b, h);
  const T* dp_src = head_base(dout, dos, b, h);
  const size_t row0 = ((size_t)b * heads + h) * n_q;
  stage_rows<T, DK, KP>(Ks, head_base(k, ks, b, h), ks.r, j0, kTile, n_k);
  stage_rows<T, DV>(Vs, head_base(v, vs, b, h), vs.r, j0, kTile, n_k);

  float dk_acc[KP / 8][4], dv_acc[DV / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int i0 = 0; i0 < n_q; i0 += QT) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, DK, KP>(Qs, qp, qs.r, i0, QT, n_q);
    stage_rows<T, DV>(Ds, dp_src, dos.r, i0, QT, n_q);
    for (int i = threadIdx.x; i < QT; i += kThreads)
      st[i] = i0 + i < n_q ? make_float2(lse[row0 + i0 + i], dsum[row0 + i0 + i])
                           : make_float2(0.f, 0.f);
    __syncthreads();

    float s[QT / 8][4], dp[QT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, KP, QT>(s, Ks, a0, Qs, lane);   // sᵀ[key][query]
    mma_abt<T, DV, QT>(dp, Vs, a0, Ds, lane);  // dpᵀ[key][query] = v·dOᵀ
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        const float2 rs = st[qi];
        const float p = i0 + qi < n_q ? expf(s[j][e] * scale - rs.x) : 0.f;  // rows past n_q add 0
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - rs.y) * scale;  // dsᵀ
      }
    mma_pv<T, DV, QT>(dv_acc, s, Ds, lane);   // dv += T(pᵀ)·dO
    mma_pv<T, KP, QT>(dk_acc, dp, Qs, lane);  // dk += T(dsᵀ)·q
  }
  store_rows<T, DK, KP>(head_base(dk, dks, b, h), dks.r, j0 + a0, n_k, dk_acc, lane);
  store_rows<T, DV>(head_base(dv, dvs, b, h), dvs.r, j0 + a0, n_k, dv_acc, lane);
}

// Strides of operand i from the wrapper's flat (b, h, row) triples.
Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int DK, int DV>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* out, float* lse,
                  const long long* st, int b, int heads, int n_q, int n_k, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = fwd_smem_bytes<DK, DV>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DK, DV>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n_q + kTile - 1) / kTile, heads, b);
  flash_fwd_kernel<T, DK, DV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), strides_at(st, 0), static_cast<const T*>(k), strides_at(st, 1),
      static_cast<const T*>(v), strides_at(st, 2), static_cast<T*>(out), strides_at(st, 3), lse,
      heads, n_q, n_k, scale);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t bwd_t(const void* q, const void* k, const void* v, const void* out,
                  const float* lse, const void* dout, void* dq, void* dk, void* dv, float* dsum,
                  const long long* st, int b, int heads, int n_q, int n_k, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = bwd_smem_bytes<DK, DV>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DK, DV>, bytes);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkv_kernel<T, DK, DV>, bytes);
  if (err != cudaSuccess) return err;
  const Strides qs = strides_at(st, 0), ks = strides_at(st, 1), vs = strides_at(st, 2),
                os = strides_at(st, 3), dos = strides_at(st, 4), dqs = strides_at(st, 5),
                dks = strides_at(st, 6), dvs = strides_at(st, 7);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *dop = static_cast<const T*>(dout);
  if (n_q > 0) {  // without queries, dq is empty and dk, dv are zeros
    const long long rows = (long long)b * heads * n_q;
    const int rows_per_cta = kThreads / 32;
    flash_bwd_dsum_kernel<T><<<(unsigned)((rows + rows_per_cta - 1) / rows_per_cta), kThreads,
                               0, stream>>>(static_cast<const T*>(out), os, dop, dos, dsum,
                                            heads, n_q, DV, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, DK, DV><<<dim3((n_q + kTile - 1) / kTile, heads, b), kThreads, bytes,
                                     stream>>>(qp, qs, kp, ks, vp, vs, dop, dos, lse, dsum,
                                               static_cast<T*>(dq), dqs, heads, n_q, n_k, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dkv_kernel<T, DK, DV><<<dim3((n_k + kTile - 1) / kTile, heads, b), kThreads, bytes,
                                    stream>>>(qp, qs, kp, ks, vp, vs, dop, dos, lse, dsum,
                                              static_cast<T*>(dk), dks, static_cast<T*>(dv), dvs,
                                              heads, n_q, n_k, scale);
  return cudaGetLastError();
}

// The (dk, dv) instances: one head width for q, k and v, and ScalableViT's
// SSA (q/k 40, v 32).
#define VIT_FLASH_WIDTHS(X) X(32, 32) X(40, 32) X(64, 64) X(96, 96) X(128, 128)

// Shapes the kernels take: a grid of (tiles, heads, b) and head widths with an
// instance.
bool shape_ok(int b, int heads, int n_q, int n_k, int dk, int dv) {
#define VIT_FLASH_IS(DK, DV) || (dk == DK && dv == DV)
  const bool widths = false VIT_FLASH_WIDTHS(VIT_FLASH_IS);
#undef VIT_FLASH_IS
  return b >= 0 && b <= 65535 && heads >= 1 && heads <= 65535 && n_q >= 0 && n_k >= 1 && widths;
}

template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
                         const long long* st, int b, int heads, int n_q, int n_k, int dk, int dv,
                         float scale, cudaStream_t stream) {
#define VIT_FLASH_FWD(DK, DV)                                                              \
  if (dk == DK && dv == DV)                                                                \
    return fwd_t<T, DK, DV>(q, k, v, out, lse, st, b, heads, n_q, n_k, scale, stream);
  VIT_FLASH_WIDTHS(VIT_FLASH_FWD)
#undef VIT_FLASH_FWD
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_dispatch(const void* q, const void* k, const void* v, const void* out,
                         const float* lse, const void* dout, void* dq, void* dk_out, void* dv_out,
                         float* dsum, const long long* st, int b, int heads, int n_q, int n_k,
                         int dk, int dv, float scale, cudaStream_t stream) {
#define VIT_FLASH_BWD(DK, DV)                                                              \
  if (dk == DK && dv == DV)                                                                \
    return bwd_t<T, DK, DV>(q, k, v, out, lse, dout, dq, dk_out, dv_out, dsum, st, b, heads, \
                            n_q, n_k, scale, stream);
  VIT_FLASH_WIDTHS(VIT_FLASH_BWD)
#undef VIT_FLASH_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                             const long long* strides, int b, int heads, int n_q, int n_k, int dk,
                             int dv, float scale, int dtype, cudaStream_t stream) {
  if (!shape_ok(b, heads, n_q, n_k, dk, dv)) return cudaErrorInvalidValue;
  if (b == 0 || n_q == 0) return cudaSuccess;
  if (dtype == kBF16)
    return fwd_dispatch<__nv_bfloat16>(q, k, v, out, lse, strides, b, heads, n_q, n_k, dk, dv,
                                       scale, stream);
  if (dtype == kF16)
    return fwd_dispatch<__half>(q, k, v, out, lse, strides, b, heads, n_q, n_k, dk, dv, scale,
                                stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const float* lse, const void* dout, void* dq, void* dk, void* dv,
                             float* dsum, const long long* strides, int b, int heads, int n_q,
                             int n_k, int d_k, int d_v, float scale, int dtype,
                             cudaStream_t stream) {
  if (!shape_ok(b, heads, n_q, n_k, d_k, d_v)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (dtype == kBF16)
    return bwd_dispatch<__nv_bfloat16>(q, k, v, out, lse, dout, dq, dk, dv, dsum, strides, b,
                                       heads, n_q, n_k, d_k, d_v, scale, stream);
  if (dtype == kF16)
    return bwd_dispatch<__half>(q, k, v, out, lse, dout, dq, dk, dv, dsum, strides, b, heads,
                                n_q, n_k, d_k, d_v, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit

// Forward: out (b, h, n_q, dv) in the compute dtype and lse (b, h, n_q) f32,
// contiguous.  `strides` (host memory) holds the (batch, head, row) element
// strides of q, k, v and out, in that order (12 values); each operand's last
// axis is contiguous, its rows 16-byte aligned.
extern "C" int vit_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       float* lse, const long long* strides, int b, int heads,
                                       int n_q, int n_k, int dk, int dv, float scale, int dtype,
                                       cudaStream_t stream) {
  return vit::launch_flash_fwd(q, k, v, out, lse, strides, b, heads, n_q, n_k, dk, dv, scale,
                               dtype, stream);
}

// Backward: dq, dk (width dk), dv (width dv) in the compute dtype from q, k, v,
// the forward's out and lse, and dout = dL/d(out).  `dsum` (b, h, n_q) f32 is
// scratch that receives D = rowsum(dO∘O).  `strides` holds the (batch, head,
// row) strides of q, k, v, out, dout, dq, dk and dv, in that order (24 values).
extern "C" int vit_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const float* lse, const void* dout,
                                       void* dq, void* dk, void* dv, float* dsum,
                                       const long long* strides, int b, int heads, int n_q,
                                       int n_k, int d_k, int d_v, float scale, int dtype,
                                       cudaStream_t stream) {
  return vit::launch_flash_bwd(q, k, v, out, lse, dout, dq, dk, dv, dsum, strides, b, heads, n_q,
                               n_k, d_k, d_v, scale, dtype, stream);
}
