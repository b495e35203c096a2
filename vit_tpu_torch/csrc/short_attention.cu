// Short-sequence attention on Hopper: an exact-softmax forward over whole rows
// of at most 512 keys, and a one-pass backward that takes dq, dk and dv from
// one recompute of the scores.  q (b, h, n_q, d), k and v (b, h, n_k, d),
// n_q, n_k <= 512, d ∈ {32, 64, 128}, bf16 or f16 operands, f32 accumulation
// on mma.sync m16n8k16.
//
// Replaces the TPU kernels
//   vit_tpu/ops/short_attention.py:82   _fwd_kernel (short_attention, whole
//                                       (head-batch, n, d) tiles in VMEM)
//   vit_tpu/ops/short_attention.py:97   _bwd_kernel
//   vit_tpu/ops/fused_hybrid.py:317     _attn_nb_fwd_kernel (attention_nb,
//                                       q/k/v in the (n, b, heads·dh) layout)
//   vit_tpu/ops/fused_hybrid.py:345     _attn_nb_bwd_kernel
// The two TPU pairs compute one function in two layouts; here the layout is a
// stride.  Every operand is read and written through (batch, head, row)
// element strides, d contiguous: (b, h, n, d) tensors as they lie, and the
// (n, b, heads·dh) rows of the hybrid layer with batch stride heads·dh (or
// 3·heads·dh for the q|k|v column views of one projection), head stride dh
// and row stride b times that.  No layout copy either way, which is what the
// TPU tier paid for around its attention middle (fused_hybrid.py:31-40).
//
// Bound on the H100: at ViT-B/32's layer (b 128, 16 heads of 64, n 65, bf16)
// the forward moves q, k, v and out, 68 MB (0.020 ms at 3.35 TB/s), against
// 2.2 GFLOP (0.002 ms at 989 TFLOP/s); the backward moves q, k, v, out, dout,
// dq, dk, dv and the f32 lse, 119 MB (0.036 ms), against 5.5 GFLOP.  Memory
// bounds it by ten times, so the design reads every operand once and keeps
// the n_q x n_k scores out of device memory.
//
// Forward (short_fwd): one CTA of four warps per (64-query tile, head,
// image), each warp 16 query rows with its q fragments in registers.  Pass 1
// streams 64-key K tiles, computes s = (q·kᵀ)·scale in f32 (keys past n_k
// -inf) and parks each thread's score fragments in its own slots of shared
// memory (64 rows x 512 keys of f32 is 128 KB) while it tracks the row max;
// pass 2 sums exp(s - m) over the whole row in f32; pass 3 streams the V
// tiles and accumulates T(exp(s - m) / l)·v.  That is the TPU kernels'
// exact softmax from the row's own maximum, with p rounded to the operand
// dtype before p·v (fused_hybrid.py:337), and no online rescale.  The
// training forward also writes lse = m + log l in f32.
//
// Backward (short_bwd): one CTA of eight warps per (128-key block, head,
// image), each warp owning 16 keys, dk and dv accumulated in registers over
// the query tiles (64 rows, 32 at d = 128).  Per query tile: D = rowsum(dO∘O)
// over the stored output (the flash backward's D, flash_backward.py:135),
// sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, p = exp(s·scale - lse), ds = p·(dp - D)·scale;
// dv += T(pᵀ)·dO, dk += T(dsᵀ)·q; T(ds) goes to shared memory query-major,
// and the eight warps take dq's tile as T(ds)·k over the block's keys.  Five
// n_q x n_k products, the TPU kernel's count (the flash backward's two-pass
// split takes seven).  Where n_k > 128 each key block writes its dq share as
// f32 partials, which short_dq_sum adds in key-block order; at n_k <= 128
// (the hybrid tier's n < 128) one CTA holds the slice and stores dq itself.
// No atomics: the bits repeat.
#include "attention_tiles.cuh"

namespace vit {
namespace {

constexpr int kMaxSeq = 512;
constexpr int kFwdRows = 64;  // query rows of a forward CTA
constexpr int kKeyTile = 64;  // keys of a staged forward tile
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kKeyBlock = 16 * kBwdWarps;  // keys of a backward CTA

struct Strides {
  long long b, h, r;
};

template <typename P>
__device__ __forceinline__ P* head_base(P* p, Strides s, int b, int h) {
  return p + (long long)b * s.b + (long long)h * s.h;
}

// Query rows of a backward step: at d = 128 the register accumulators of dk
// and dv take half the file, so the step takes 32 rows.
template <int D>
constexpr int kBwdRows = D >= 128 ? 32 : 64;

__host__ __device__ int key_tiles(int n_k) { return (n_k + kKeyTile - 1) / kKeyTile; }

// Q and a K/V tile of 64 rows, then the score slots: a float4 per (key tile,
// 8-key group, warp, lane).
template <int D>
int fwd_smem_bytes(int n_k) {
  return 2 * kFwdRows * (D + 8) * 2 + key_tiles(n_k) * 8 * 4 * 32 * 16;
}

// K and V of the key block, a q and a dO tile, T(ds) query-major, (lse, D).
template <int D>
constexpr int bwd_smem_bytes() {
  return (2 * kKeyBlock + 2 * kBwdRows<D>) * (D + 8) * 2 +
         kBwdRows<D> * (kKeyBlock + 8) * 2 + kBwdRows<D> * 8;
}

// acc (16 x NC) += A · B for the warp's 16 rows of A (from row a0 of As, K
// columns) and the K x NC block of B from column c0 of Bs, both row-major in
// shared memory (B's fragments through ldmatrix.trans, as mma_pv's V).
template <typename T, int K, int LDA, int NC, int LDB>
__device__ __forceinline__ void mma_ab(float (&acc)[NC / 8][4], T (*As)[LDA], int a0,
                                       T (*Bs)[LDB], int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, &As[a0 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int dn = 0; dn < NC / 16; ++dn) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, &Bs[kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8]
                               [c0 + dn * 16 + (lane / 16) * 8]);
      Num<T>::mma(acc[2 * dn], af, bf[0], bf[1]);
      Num<T>::mma(acc[2 * dn + 1], af, bf[2], bf[3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
    short_fwd_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
                     const T* __restrict__ v, Strides vs, T* __restrict__ out, Strides os,
                     float* __restrict__ lse, int heads, int n_q, int n_k, float scale) {
  constexpr int kRow = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Qs)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*KVs)[kRow] = Qs + kFwdRows;  // a K tile in pass 1, a V tile in pass 3
  float4* slots = reinterpret_cast<float4*>(KVs + kKeyTile);

  const int q0 = blockIdx.x * kFwdRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4;
  const int tiles = key_tiles(n_k);
  // This thread's scores of key tile `tile`, keys 8j..8j+7 of it: rows g and
  // g + 8, columns 2t and 2t + 1 of the mma fragment.
  auto slot = [&](int tile, int j) -> float4& {
    return slots[((tile * 8 + j) * 4 + warp) * 32 + lane];
  };

  stage_rows<T, D>(Qs, head_base(q, qs, b, h), qs.r, q0, kFwdRows, n_q);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], &Qs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);

  // Pass 1: the scores, and the row max (rows g and g + 8 of the warp's 16).
  const T* kp = head_base(k, ks, b, h);
  float mx[2] = {-INFINITY, -INFINITY};
  for (int tile = 0; tile < tiles; ++tile) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, D>(KVs, kp, ks.r, tile * kKeyTile, kKeyTile, n_k);
    __syncthreads();
    float s[kKeyTile / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < kKeyTile / 16; ++nj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &KVs[nj * 16 + (lane % 8) + (lane / 16) * 8][kk * 16 + ((lane / 8) % 2) * 8]);
        Num<T>::mma(s[2 * nj], qf[kk], kf[0], kf[1]);
        Num<T>::mma(s[2 * nj + 1], qf[kk], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = tile * kKeyTile + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < n_k ? s[j][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
      slot(tile, j) = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // finite: every row has a key (n_k >= 1)
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }

  // Pass 2: the f32 row sums over every key.
  float l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile)
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      const float4 sv = slot(tile, j);
      l[0] += expf(sv.x - mx[0]) + expf(sv.y - mx[0]);
      l[1] += expf(sv.z - mx[1]) + expf(sv.w - mx[1]);
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // Pass 3: o += T(p)·v with p = exp(s - m) / l.
  const T* vp = head_base(v, vs, b, h);
  float o[D / 8][4];
  zero(o);
  for (int tile = 0; tile < tiles; ++tile) {
    __syncthreads();
    stage_rows<T, D>(KVs, vp, vs.r, tile * kKeyTile, kKeyTile, n_k);
    __syncthreads();
    float p[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      const float4 sv = slot(tile, j);
      p[j][0] = expf(sv.x - mx[0]) / l[0];
      p[j][1] = expf(sv.y - mx[0]) / l[0];
      p[j][2] = expf(sv.z - mx[1]) / l[1];
      p[j][3] = expf(sv.w - mx[1]) / l[1];
    }
    mma_pv<T, D, kKeyTile>(o, p, KVs, lane);
  }
  store_rows<T, D>(head_base(out, os, b, h), os.r, q0 + warp * 16, n_q, o, lane);
  if (lse && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + warp * 16 + lane / 4 + r * 8;
      if (qi < n_q) lse[((size_t)b * heads + h) * n_q + qi] = mx[r] + logf(l[r]);
    }
  }
}

// One CTA per (128-key block, head, image): dk and dv of its keys over every
// query tile, and dq's share of its keys (stored, or f32 partials).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    short_bwd_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k, Strides ks,
                     const T* __restrict__ v, Strides vs, const T* __restrict__ o, Strides os,
                     const float* __restrict__ lse, const T* __restrict__ dout, Strides dos,
                     T* __restrict__ dq, Strides dqs, float* __restrict__ dq_part,
                     T* __restrict__ dk, Strides dks, T* __restrict__ dv, Strides dvs, int batch,
                     int heads, int n_q, int n_k, float scale) {
  constexpr int kRow = D + 8, QT = kBwdRows<D>, kRowS = kKeyBlock + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*Ks)[kRow] = reinterpret_cast<T(*)[kRow]>(smem_raw);
  T(*Vs)[kRow] = Ks + kKeyBlock;
  T(*Qs)[kRow] = Vs + kKeyBlock;
  T(*Ds)[kRow] = Qs + QT;  // dO
  T(*Ps)[kRowS] = reinterpret_cast<T(*)[kRowS]>(Ds + QT);  // T(ds)[query][key]
  float2* st = reinterpret_cast<float2*>(Ps + QT);         // (lse, D) of the tile's rows

  const int j0 = blockIdx.x * kKeyBlock, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, t = lane % 4, g = lane / 4;
  const int a0 = warp * 16;  // the warp's keys, from j0
  const T* qp = head_base(q, qs, b, h);
  const T* op = head_base(o, os, b, h);
  const T* dop = head_base(dout, dos, b, h);
  const size_t row0 = ((size_t)b * heads + h) * n_q;
  stage_rows<T, D, D, kBwdThreads>(Ks, head_base(k, ks, b, h), ks.r, j0, kKeyBlock, n_k);
  stage_rows<T, D, D, kBwdThreads>(Vs, head_base(v, vs, b, h), vs.r, j0, kKeyBlock, n_k);

  // dq's tile is split over the warps: RG groups of 16 rows, DC columns each.
  constexpr int RG = QT / 16, DC = D / (kBwdWarps / RG);
  const int r0 = (warp % RG) * 16, c0 = (warp / RG) * DC;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int i0 = 0; i0 < n_q; i0 += QT) {
    __syncthreads();  // the previous step's reads of Qs, Ds, Ps and st are done
    stage_rows<T, D, D, kBwdThreads>(Qs, qp, qs.r, i0, QT, n_q);
    stage_rows<T, D, D, kBwdThreads>(Ds, dop, dos.r, i0, QT, n_q);
    for (int r = warp; r < QT; r += kBwdWarps) {  // D = rowsum(dO∘O), one warp a row
      const int qi = i0 + r;
      float acc = 0.f;
      if (qi < n_q) {
        const T* orow = op + (long long)qi * os.r;
        const T* drow = dop + (long long)qi * dos.r;
        for (int c = 2 * lane; c < D; c += 64)
          acc += Num<T>::to_f(orow[c]) * Num<T>::to_f(drow[c]) +
                 Num<T>::to_f(orow[c + 1]) * Num<T>::to_f(drow[c + 1]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) st[r] = qi < n_q ? make_float2(lse[row0 + qi], acc) : make_float2(0.f, 0.f);
    }
    __syncthreads();

    float s[QT / 8][4], dp[QT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<T, D, QT>(s, Ks, a0, Qs, lane);   // sᵀ[key][query]
    mma_abt<T, D, QT>(dp, Vs, a0, Ds, lane);  // dpᵀ = v·dOᵀ
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        const int key = j0 + a0 + g + (e / 2) * 8;
        const float2 rs = st[qi];
        const float p =
            i0 + qi < n_q && key < n_k ? expf(s[j][e] * scale - rs.x) : 0.f;  // masked: adds 0
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - rs.y) * scale;  // dsᵀ
        Ps[qi][a0 + g + (e / 2) * 8] = Num<T>::from_f(dp[j][e]);
      }
    mma_pv<T, D, QT>(dv_acc, s, Ds, lane);   // dv += T(pᵀ)·dO
    mma_pv<T, D, QT>(dk_acc, dp, Qs, lane);  // dk += T(dsᵀ)·q
    __syncthreads();                         // Ps is complete

    float acc[DC / 8][4];
    zero(acc);
    mma_ab<T, kKeyBlock, kRowS, DC, kRow>(acc, Ps, r0, Ks, c0, lane);  // dq = T(ds)·k
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = i0 + r0 + g + half * 8;
      if (qi >= n_q) continue;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int col = c0 + j * 8 + 2 * t;
        const float lo = acc[j][2 * half], hi = acc[j][2 * half + 1];
        if (dq_part) {
          const size_t at =
              (((size_t)blockIdx.x * batch + b) * heads + h) * n_q * D + (size_t)qi * D + col;
          *reinterpret_cast<float2*>(dq_part + at) = make_float2(lo, hi);
        } else {
          *reinterpret_cast<uint32_t*>(head_base(dq, dqs, b, h) + (long long)qi * dqs.r + col) =
              Num<T>::pack2(lo, hi);
        }
      }
    }
  }
  store_rows<T, D>(head_base(dk, dks, b, h), dks.r, j0 + a0, n_k, dk_acc, lane);
  store_rows<T, D>(head_base(dv, dvs, b, h), dvs.r, j0 + a0, n_k, dv_acc, lane);
}

// dq = T(Σ_p dq_part[p]) over the key blocks in order, two columns a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    short_dq_sum_kernel(const float* __restrict__ dq_part, int parts, T* __restrict__ dq,
                        Strides dqs, int heads, int n_q, int d, long long pairs) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= pairs) return;
  const long long e = 2 * i, row = e / d;
  const int col = (int)(e % d), qi = (int)(row % n_q), h = (int)((row / n_q) % heads),
            b = (int)(row / n_q / heads);
  float lo = 0.f, hi = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float2 v = *reinterpret_cast<const float2*>(dq_part + (size_t)p * 2 * pairs + e);
    lo += v.x;
    hi += v.y;
  }
  *reinterpret_cast<uint32_t*>(head_base(dq, dqs, b, h) + (long long)qi * dqs.r + col) =
      Num<T>::pack2(lo, hi);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int D>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* out, float* lse,
                  const long long* st, int b, int heads, int n_q, int n_k, float scale,
                  cudaStream_t stream) {
  const int bytes = fwd_smem_bytes<D>(n_k);
  cudaError_t err = allow_smem(short_fwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n_q + kFwdRows - 1) / kFwdRows, heads, b);
  short_fwd_kernel<T, D><<<grid, kAttnThreads, bytes, stream>>>(
      static_cast<const T*>(q), strides_at(st, 0), static_cast<const T*>(k), strides_at(st, 1),
      static_cast<const T*>(v), strides_at(st, 2), static_cast<T*>(out), strides_at(st, 3), lse,
      heads, n_q, n_k, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_t(const void* q, const void* k, const void* v, const void* out,
                  const float* lse, const void* dout, void* dq, void* dk, void* dv,
                  float* dq_part, const long long* st, int b, int heads, int n_q, int n_k,
                  float scale, cudaStream_t stream) {
  constexpr int bytes = bwd_smem_bytes<D>();
  cudaError_t err = allow_smem(short_bwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  const int parts = (n_k + kKeyBlock - 1) / kKeyBlock;
  if (parts > 1 && !dq_part) return cudaErrorInvalidValue;
  float* part = parts > 1 ? dq_part : nullptr;
  const Strides dqs = strides_at(st, 5);
  short_bwd_kernel<T, D><<<dim3(parts, heads, b), kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(q), strides_at(st, 0), static_cast<const T*>(k), strides_at(st, 1),
      static_cast<const T*>(v), strides_at(st, 2), static_cast<const T*>(out), strides_at(st, 3),
      lse, static_cast<const T*>(dout), strides_at(st, 4), static_cast<T*>(dq), dqs, part,
      static_cast<T*>(dk), strides_at(st, 6), static_cast<T*>(dv), strides_at(st, 7), b, heads,
      n_q, n_k, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !part || n_q == 0) return err;
  const long long pairs = (long long)b * heads * n_q * D / 2;
  short_dq_sum_kernel<T><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      part, parts, static_cast<T*>(dq), dqs, heads, n_q, D, pairs);
  return cudaGetLastError();
}

bool shape_ok(int b, int heads, int n_q, int n_k, int d) {
  return b >= 0 && b <= 65535 && heads >= 1 && heads <= 65535 && n_q >= 0 && n_q <= kMaxSeq &&
         n_k >= 1 && n_k <= kMaxSeq && (d == 32 || d == 64 || d == 128);
}

#define VIT_SHORT_WIDTHS(X) X(32) X(64) X(128)

template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
                         const long long* st, int b, int heads, int n_q, int n_k, int d,
                         float scale, cudaStream_t stream) {
#define VIT_SHORT_FWD(D) \
  if (d == D) return fwd_t<T, D>(q, k, v, out, lse, st, b, heads, n_q, n_k, scale, stream);
  VIT_SHORT_WIDTHS(VIT_SHORT_FWD)
#undef VIT_SHORT_FWD
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_dispatch(const void* q, const void* k, const void* v, const void* out,
                         const float* lse, const void* dout, void* dq, void* dk, void* dv,
                         float* dq_part, const long long* st, int b, int heads, int n_q, int n_k,
                         int d, float scale, cudaStream_t stream) {
#define VIT_SHORT_BWD(D)                                                                   \
  if (d == D)                                                                              \
    return bwd_t<T, D>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, st, b, heads, n_q, n_k, \
                       scale, stream);
  VIT_SHORT_WIDTHS(VIT_SHORT_BWD)
#undef VIT_SHORT_BWD
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace vit

// Forward: out (width d) in the compute dtype through its strides and, when
// `lse` is not null, lse (b, h, n_q) f32 contiguous.  `strides` (host memory)
// holds the (batch, head, row) element strides of q, k, v and out (12
// values); each operand's last axis is contiguous, its rows 16-byte aligned.
extern "C" int vit_short_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       float* lse, const long long* strides, int b, int heads,
                                       int n_q, int n_k, int d, float scale, int dtype,
                                       cudaStream_t stream) {
  using namespace vit;
  if (!shape_ok(b, heads, n_q, n_k, d)) return cudaErrorInvalidValue;
  if (b == 0 || n_q == 0) return cudaSuccess;
  if (dtype == kBF16)
    return fwd_dispatch<__nv_bfloat16>(q, k, v, out, lse, strides, b, heads, n_q, n_k, d, scale,
                                       stream);
  if (dtype == kF16)
    return fwd_dispatch<__half>(q, k, v, out, lse, strides, b, heads, n_q, n_k, d, scale, stream);
  return cudaErrorInvalidValue;
}

// Backward: dq, dk, dv in the compute dtype from q, k, v, the forward's out
// and lse, and dout = dL/d(out).  `strides` holds the (batch, head, row)
// strides of q, k, v, out, dout, dq, dk and dv (24 values).  `dq_part`
// (vit_short_attention_parts(n_k), b, h, n_q, d) f32 is scratch for the key
// blocks' dq shares, null when there is one block.
extern "C" int vit_short_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const float* lse, const void* dout,
                                       void* dq, void* dk, void* dv, float* dq_part,
                                       const long long* strides, int b, int heads, int n_q,
                                       int n_k, int d, float scale, int dtype,
                                       cudaStream_t stream) {
  using namespace vit;
  if (!shape_ok(b, heads, n_q, n_k, d)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (dtype == kBF16)
    return bwd_dispatch<__nv_bfloat16>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, strides, b,
                                       heads, n_q, n_k, d, scale, stream);
  if (dtype == kF16)
    return bwd_dispatch<__half>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, strides, b, heads,
                                n_q, n_k, d, scale, stream);
  return cudaErrorInvalidValue;
}

// Key blocks of the backward at n_k keys: dq_part's leading extent when > 1.
extern "C" int vit_short_attention_parts(int n_k) {
  return (n_k + vit::kKeyBlock - 1) / vit::kKeyBlock;
}
