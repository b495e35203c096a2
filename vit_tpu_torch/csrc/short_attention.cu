// Short-sequence attention on Hopper: an exact-softmax forward over whole rows
// of at most 512 keys, and a one-pass backward that takes dq, dk and dv from
// one recompute of the scores.  q (b, h, n_q, d), k and v (b, h, n_k, d),
// n_q, n_k <= 512, d ∈ {32, 64, 128}, bf16 or f16 operands, f32
// accumulation: the forward on wgmma with its operands brought by TMA
// (hopper.cuh), the backward on mma.sync m16n8k16.
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
// Forward (short_fwd): one CTA per (block of up to 128 queries, head, image),
// a warpgroup per 64 query rows.  Q comes once by TMA; a 2-stage ring on
// mbarriers carries key tiles of BK ∈ {64, 80, 128} keys, and at d <= 64 also
// 208, the tile chosen by n_k (fwd_tiles: n = 65 takes one tile of 80, not
// 128; ViT-B/16's 197 one of 208).  Pass 1 takes each K tile, s =
// (q·kᵀ)·scale on wgmma (keys past n_k -inf), and keeps the row max and the rescaled row sum in
// registers; pass 2 takes K and V again, recomputes s, forms p = exp(s - m) /
// l in registers, rounds it to the operand dtype and feeds it to o += p·v as
// wgmma's register A operand.  Keys that fit one tile (n_k <= 128, or 208 at d
// <= 64; the hybrid tier's 65, ViT-B/16's 197) come once, K and V together,
// and pass 2 reuses pass 1's exponentials: two products, one exp per score.
// Longer rows take three products and read K twice (from L2 at these sizes):
// nothing is parked in shared memory, and bytes, not products, bound these
// shapes.  That is the TPU kernels' exact
// softmax from the row's own maximum, with p rounded before p·v
// (fused_hybrid.py:337), and no online rescale of o.  The training forward
// also writes lse = m + log l in f32.
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
#include "hopper.cuh"

namespace vit {
namespace {

constexpr int kMaxSeq = 512;
constexpr int kFwdStages = 2;  // depth of the forward's TMA ring
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

// Q of up to 128 query rows, the ring's K and V tiles of BK keys, the
// barriers (one, and full/empty per stage), alignment.
template <int D, int BK>
constexpr int fwd_smem_bytes() {
  return (128 + 2 * kFwdStages * BK) * D * 2 + (1 + 2 * kFwdStages) * 8 + 1024;
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

// One CTA per (block of 64·W queries, head, image), W = blockDim / 128
// warpgroups of 64 queries each.  The ring carries 2·tiles items of BK keys:
// pass 1 takes K tile i, pass 2 K and V tile i again; keys that fit one tile
// come once, K and V, as one item that both passes read.  Pass 1: s = q·kᵀ on
// shared operands, keys past n_k -inf, the row max and the rescaled row sum
// (no o to rescale).  Pass 2: s again (with one tile, pass 1's exponentials,
// kept in registers), p = exp(s - m) / l, o += T(p)·v with p the register A
// operand and v MN-major.  Thread 0 refills a
// stage once every thread has released it.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(256, 1)
    short_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, T* __restrict__ out, Strides os,
                     float* __restrict__ lse, int heads, int n_q, int n_k, float scale) {
  using QTile = hopper::Tile<128, D>;
  using KTile = hopper::Tile<BK, D>;
  constexpr int S = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align1024(smem_raw);
  unsigned char* ks = qs + QTile::kBytes;
  unsigned char* vs = ks + S * KTile::kBytes;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(vs + S * KTile::kBytes);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + S;

  const int wgs = blockDim.x / 128, q0 = blockIdx.x * 64 * wgs, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128, t = tid % 4;
  // One tile of keys (n_k <= BK) is one item, K and V, that both passes read.
  const int tiles = (n_k + BK - 1) / BK, items = tiles == 1 ? 1 : 2 * tiles;
  auto load_item = [&](int i) {
    const int s = i % S, r = (i % tiles) * BK;
    const bool with_v = i >= tiles || items == 1;
    hopper::mbar_expect_tx(&full[s], KTile::kBytes * (with_v ? 2 : 1));
    KTile::load(ks + s * KTile::kBytes, 0, &k_map, &full[s], r, h, b);
    if (with_v) KTile::load(vs + s * KTile::kBytes, 0, &v_map, &full[s], r, h, b);
  };
  auto release = [&](int i) {
    hopper::mbar_arrive(&empty[i % S]);
    if (tid == 0 && i + S < items) {
      hopper::mbar_wait(&empty[i % S], (i / S) & 1);
      load_item(i + S);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], blockDim.x);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_bar, wgs * 64 * D * 2);
    for (int w = 0; w < wgs; ++w) QTile::load(qs, 64 * w, &q_map, q_bar, q0 + 64 * w, h, b);
    for (int i = 0; i < S && i < items; ++i) load_item(i);
  }

  // s = (q·kᵀ)·scale of ring item i into sc (keys past n_k: -inf).
  float sc[BK / 2];
  auto scores = [&](int i) {
    const unsigned char* k_t = ks + (i % S) * KTile::kBytes;
    hopper::mbar_wait(&full[i % S], (i / S) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<BK, T>::ss(sc, QTile::kmajor(qs, 64 * wg, 16 * kk),
                               KTile::kmajor(k_t, 0, 16 * kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = (i % tiles) * BK + 8 * j + 2 * t + (e & 1);
        sc[4 * j + e] = key < n_k ? sc[4 * j + e] * scale : -INFINITY;
      }
  };

  // Pass 1: rows g and g + 8 of the warp's 16: max m and this thread's share of
  // l = Σ exp(s - m), rescaled as m grows (every tile holds a key: m is finite).
  // expf, as the plain version takes it: p is rounded to the operand dtype, and
  // a cheaper exponential (ex2.approx of a product with log2 e) moved that
  // rounding enough to flip top-1s of the hybrid B/32 model's random logits.
  // With one tile, m is final before the sum: sc keeps exp(s - m) for pass 2,
  // and l is the plain version's sum in another order.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(q_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    scores(i);
    if (items > 1) release(i);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2)), m[r]);
      l[r] *= expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = expf(sc[4 * j + e] - m[e / 2]);
        l[e / 2] += sc[4 * j + e];
      }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv_l[r] = 1.f / l[r];
  }

  // Pass 2: o += T(p)·v with p = exp(s - m) / l (times 1 / l: within one f32 unit).
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  for (int i = tiles; i < 2 * tiles; ++i) {
    const int it = items == 1 ? 0 : i;
    if (items > 1) {
      scores(it);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * j + e] = expf(sc[4 * j + e] - m[e / 2]);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * j + e] *= inv_l[e / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) hopper::a_fragment<T>(pa[c], sc, c);
    const unsigned char* v_t = vs + (it % S) * KTile::kBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
      hopper::Wgmma<D, T>::rs(o, pa[c], KTile::mnmajor(v_t, 16 * c));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    release(it);
  }
  hopper::store_fragment<T, D>(head_base(out, os, b, h), os.r, q0 + 64 * wg, n_q, o, lt);
  if (lse && t == 0) {
    const int row = q0 + 64 * wg + (lt / 32) * 16 + (lt % 32) / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < n_q)
        lse[((size_t)b * heads + h) * n_q + row + 8 * r] = m[r] + logf(l[r]);
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

template <typename T, int D, int BK>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* out, float* lse,
                  const long long* st, int b, int heads, int n_q, int n_k, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = fwd_smem_bytes<D, BK>(), dt = hopper::dtype_of<T>();
  constexpr int c = hopper::Tile<64, D>::kChunk;
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, short_fwd_kernel<T, D, BK>, bytes);
  CUtensorMap q_map, k_map, v_map;
  if (err == cudaSuccess) err = head_map(&q_map, q, dt, D, n_q, heads, b, st, c, 64);
  if (err == cudaSuccess) err = head_map(&k_map, k, dt, D, n_k, heads, b, st + 3, c, BK);
  if (err == cudaSuccess) err = head_map(&v_map, v, dt, D, n_k, heads, b, st + 6, c, BK);
  if (err != cudaSuccess) return err;
  const int wgs = n_q > 64 ? 2 : 1;
  dim3 grid((n_q + 64 * wgs - 1) / (64 * wgs), heads, b);
  short_fwd_kernel<T, D, BK><<<grid, 128 * wgs, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), strides_at(st, 3), lse, heads, n_q, n_k, scale);
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

// Keys per step of the forward, by n_k and d.  A row that one tile holds takes
// one step, whose exponentials stay in registers for p·v: 64 or 80 keys (the
// hybrid tier's n = 65 computes on 15 padding keys, not 63), 128, or 208 at
// d <= 64 (ViT-B/16's 197; at d = 128, o leaves no room for s).  Longer rows
// take 128-key steps.
template <typename T, int D>
cudaError_t fwd_tiles(const void* q, const void* k, const void* v, void* out, float* lse,
                      const long long* st, int b, int heads, int n_q, int n_k, float scale,
                      cudaStream_t stream) {
  if (n_k <= 64) return fwd_t<T, D, 64>(q, k, v, out, lse, st, b, heads, n_q, n_k, scale, stream);
  if (n_k <= 80) return fwd_t<T, D, 80>(q, k, v, out, lse, st, b, heads, n_q, n_k, scale, stream);
  if constexpr (D <= 64) {
    if (n_k > 128 && n_k <= 208)
      return fwd_t<T, D, 208>(q, k, v, out, lse, st, b, heads, n_q, n_k, scale, stream);
  }
  return fwd_t<T, D, 128>(q, k, v, out, lse, st, b, heads, n_q, n_k, scale, stream);
}

template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
                         const long long* st, int b, int heads, int n_q, int n_k, int d,
                         float scale, cudaStream_t stream) {
#define VIT_SHORT_FWD(D)                                                                   \
  if (d == D) return fwd_tiles<T, D>(q, k, v, out, lse, st, b, heads, n_q, n_k, scale, stream);
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
    return fwd_dispatch<__nv_bfloat16>(q, k, v, out, lse, strides, b, heads, n_q, n_k, d,
                                       scale, stream);
  if (dtype == kF16)
    return fwd_dispatch<__half>(q, k, v, out, lse, strides, b, heads, n_q, n_k, d, scale,
                                stream);
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
