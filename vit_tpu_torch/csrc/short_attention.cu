// Short-sequence attention on Hopper: an exact-softmax forward over whole rows
// of at most 512 keys, and a one-pass backward that takes dq, dk and dv from
// one recompute of the scores.  q (b, h, n_q, d), k and v (b, h, n_k, d),
// n_q, n_k <= 512, d ∈ {32, 64, 128}, bf16 or f16 operands, f32
// accumulation, the operands brought by TMA (hopper.cuh): the forward on
// wgmma, the backward on mma.sync m16n8k16.
//
// Replaces the TPU kernels
//   vit_tpu/ops/short_attention.py:82   _fwd_kernel (short_attention, whole
//                                       (head-batch, n, d) tiles in VMEM)
//   vit_tpu/ops/short_attention.py:97   _bwd_kernel
//   vit_tpu/ops/fused_hybrid.py:317     _attn_nb_fwd_kernel (attention_nb,
//                                       q/k/v in the (n, b, heads·dh) layout)
//   vit_tpu/ops/fused_hybrid.py:345     _attn_nb_bwd_kernel
// and the attention part of
//   vit_tpu/ops/fused_attention_block.py:106  _fwd_kernel and
//   vit_tpu/ops/fused_attention_block.py:169  _bwd_kernel, on
//                                       fused_attention_block.cu's short route
//                                       (the unbiased block at n <= 512, over
//                                       its packed (b, n, 3·inner) q|k|v; the
//                                       forward keeps lse for the backward)
// The TPU pairs compute one function in several layouts; here the layout is a
// stride.  Every operand is read and written through (batch, head, row)
// element strides, d contiguous: (b, h, n, d) tensors as they lie, the
// (n, b, heads·dh) rows of the hybrid layer with batch stride heads·dh (or
// 3·heads·dh for the q|k|v column views of one projection), head stride dh
// and row stride b times that, and the block's (b, n, 3·heads·dh) q|k|v
// thirds with batch stride n·3·heads·dh, head stride dh, row stride
// 3·heads·dh.  No layout copy either way, which is what the
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
// Backward (short_bwd): one CTA per (key block, head, image), dk and dv of the
// block's keys accumulated in registers over query steps.  The key block is
// sized to n_k (bwd_key_block): the whole row where one CTA holds it, so dq
// is summed inside the CTA and stored once: 64 or 80 keys (the hybrid tier's
// n = 65: five warps, one 80-row query step, two CTAs an SM), 128, or at d <=
// 64 up to 256 (ViT-B/16's 197).  Longer rows take 128-key blocks, each
// writing its dq share as f32 partials, which short_dq_sum adds in key-block
// order.  K and V come once by TMA, the steps' Q, dO and O tiles through a
// 2-stage mbarrier ring (one stage when one step covers the rows); D =
// rowsum(dO∘O) (the flash backward's D, flash_backward.py:135) is taken from
// the staged O and dO.  Per step: sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, p = exp(s·scale
// - lse), ds = p·(dp - D)·scale; dv += T(pᵀ)·dO, dk += T(dsᵀ)·q, a few
// queries at a time (none past the last group that holds a query), so that
// only dk and dv stay in registers across the step; T(ds) goes to shared
// memory query-major and dq = T(ds)·k is taken over the block's keys.  Five
// n_q x n_k products, the TPU kernel's count.  Up to 128 keys a warp takes 16
// keys on mma.sync from the swizzled TMA tiles (ldmatrix on swizzled
// addresses): a 64-row wgmma slab would pad n = 65 to 128 key rows.  From 129
// to 256 keys (d <= 64) four warpgroups take 64 keys each on wgmma
// (short_bwd_wg_kernel), which reads each B operand once a warpgroup where
// thirteen mma.sync warps read it thirteen times.  No atomics: the bits
// repeat.
#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace vit {
namespace {

constexpr int kMaxSeq = 512;
constexpr int kFwdStages = 2;  // depth of the forward's TMA ring
// Key rows and query rows of the wgmma backward's tiles (short_bwd_wg_kernel).
constexpr int kWgKeys = 256, kWgRows = 64;
// The key tile (forward) and key block (backward) of rows of 257 to 288 keys:
// two balanced halves, a multiple of 16 (the k16 chunks of p·v).
constexpr int kSplitKeys = 144;

struct Strides {
  long long b, h, r;
};

// An f32 logits bias (hb, n_q, n_k), hb 1 (shared by the heads: hstride 0) or
// heads (hstride n_q·n_k), added to the scaled logits before the row max and
// in the backward's recomputed p; read from device memory (L2) at the point
// of the fragment element it joins.  `p` is null when the instance has none.
struct Bias {
  const float* p;
  long long hstride;
};

template <typename P>
__device__ __forceinline__ P* head_base(P* p, Strides s, int b, int h) {
  return p + (long long)b * s.b + (long long)h * s.h;
}

// Q of up to 128 query rows, the ring's K and V tiles of BK keys, the
// barriers (one, and full/empty per stage), alignment.
template <int D, int BK>
constexpr int fwd_smem_bytes() {
  return (128 + 2 * kFwdStages * BK) * D * 2 + (1 + 2 * kFwdStages) * 8 + 1024;
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
// With a bias (BIAS) the kernel takes one pass over `tiles` items of K and V,
// so the f32 bias, the bytes that a second pass would read again (4.7 MB a
// head-image block's worth at the small-dataset ViT's 257 keys), is read once:
// per tile s (+ bias) and its row max, the running max m and sum l with o
// rescaled as m grows, o += T(exp(s - m))·v, and o / l after the last tile.
// That is the TPU kernel's rounding (the unnormalised probabilities rounded
// for P·V, the row sum divided after, fused_attention_block.py:146-154), with
// the flash forward's running max where a row's max lies past its first tile.
template <typename T, int D, int BK, bool BIAS>
__global__ void __launch_bounds__(256, 1)
    short_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, T* __restrict__ out, Strides os,
                     float* __restrict__ lse, Bias bias, int heads, int n_q, int n_k,
                     float scale) {
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
  // One tile of keys (n_k <= BK) is one item, K and V, that both passes read;
  // with a bias every item is a tile's K and V, read by the one pass.
  const int tiles = (n_k + BK - 1) / BK, items = tiles == 1 ? 1 : BIAS ? tiles : 2 * tiles;
  auto load_item = [&](int i) {
    const int s = i % S, r = (i % tiles) * BK;
    const bool with_v = BIAS || i >= tiles || items == 1;
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

  // The bias rows of the thread's two query rows (a row past n_q reads row
  // n_q - 1's: its results are never stored).
  const float* brow[2];
  if constexpr (BIAS) {
    const int row = q0 + 64 * wg + (lt / 32) * 16 + (lt % 32) / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias.p + h * bias.hstride + (size_t)min(row + 8 * r, n_q - 1) * n_k;
  }

  // s = (q·kᵀ)·scale (+ bias) of ring item i into sc (keys past n_k: -inf).
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
        if constexpr (BIAS)
          if (key < n_k) sc[4 * j + e] += __ldg(brow[e / 2] + key);
      }
  };

  // The output and lse of the thread's rows, once o is final.
  auto finish = [&](const float (&o)[D / 2], const float (&m)[2], const float (&l)[2]) {
    hopper::store_fragment<T, D>(head_base(out, os, b, h), os.r, q0 + 64 * wg, n_q, o, lt);
    if (lse && t == 0) {
      const int row = q0 + 64 * wg + (lt / 32) * 16 + (lt % 32) / 4;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < n_q)
          lse[((size_t)b * heads + h) * n_q + row + 8 * r] = m[r] + logf(l[r]);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(q_bar, 0);
  if constexpr (BIAS) {
    // One pass: rows g and g + 8 of the warp's 16; m and this thread's share
    // of l as pass 1 keeps them, o rescaled with l.
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int i = 0; i < tiles; ++i) {
      scores(i);
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2)), m[r]);
        alpha[r] = expf(m[r] - mx[r]);  // 0 at the first tile (m = -inf, mx finite)
        l[r] *= alpha[r];
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = expf(sc[4 * j + e] - m[e / 2]);
          l[e / 2] += sc[4 * j + e];
        }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) hopper::a_fragment<T>(pa[c], sc, c);
      const unsigned char* v_t = vs + (i % S) * KTile::kBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
        hopper::Wgmma<D, T>::rs(o, pa[c], KTile::mnmajor(v_t, 16 * c));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      release(i);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] = o[4 * j + e] / l[e / 2];
    finish(o, m, l);
  } else {
    // Pass 1: rows g and g + 8 of the warp's 16: max m and this thread's share of
    // l = Σ exp(s - m), rescaled as m grows (every tile holds a key: m is finite).
    // expf, as the plain version takes it: p is rounded to the operand dtype, and
    // a cheaper exponential (ex2.approx of a product with log2 e) moved that
    // rounding enough to flip top-1s of the hybrid B/32 model's random logits.
    // With one tile, m is final before the sum: sc keeps exp(s - m) for pass 2,
    // and l is the plain version's sum in another order.
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
    finish(o, m, l);
  }
}

// ---- backward ----------------------------------------------------------------------------

// Keys of a backward CTA at n_k keys and width d: the whole row where one CTA
// holds it (64, 80 or 128 keys on mma.sync, 256 on wgmma at d <= 64), else
// blocks whose dq shares are summed by short_dq_sum: two of 144 keys from 257
// to 288 (the small-dataset ViT's 257: 128-key blocks would leave the third
// CTA's whole query loop to one key), 128 past them.
int bwd_key_block(int n_k, int d) {
  if (n_k <= 64) return 64;
  if (n_k <= 80) return 80;
  if (d <= 64 && n_k > 128 && n_k <= kWgKeys) return kWgKeys;
  if (n_k > 256 && n_k <= 2 * kSplitKeys) return kSplitKeys;
  return 128;
}

// Query rows of a backward step: one step of 80 at the 80-key block (the
// hybrid tier's n = 65), 64 otherwise.  The step is taken 16 queries at a
// time, so registers do not grow with it.
template <int BK>
constexpr int bwd_rows() {
  return BK == 80 ? 80 : 64;
}

// Column groups of dq's QT x D tile over W warps, RG = QT / 16 row groups:
// the most that divide D / 16 with RG x CG <= W.
template <int RG, int W, int D>
__host__ __device__ constexpr int dq_col_groups() {
  int cg = 1;
  for (int c = 1; c <= D / 16; ++c)
    if ((D / 16) % c == 0 && RG * c <= W) cg = c;
  return cg;
}

// Threads that share a row of D = rowsum(dO∘O): the largest power of two at
// most the block's threads per query row (at least 1) and the row's 16-byte
// pieces (D / 8).
template <int PER_ROW, int PIECES>
__host__ __device__ constexpr int d_threads() {
  int t = 1;
  while (2 * t <= PER_ROW && 2 * t <= PIECES) t *= 2;
  return t;
}

// K and V of the key block, `stages` ring stages of (Q, dO, O) query tiles,
// T(ds) query-major, (lse, D) of a step's rows, the barriers, alignment.
template <int D, int BK, int QT>
constexpr int bwd_smem_bytes(int stages) {
  return 2 * hopper::Tile<BK, D>::kBytes + stages * 3 * hopper::Tile<QT, D>::kBytes +
         QT * (BK + 8) * 2 + QT * 8 + (1 + stages) * 8 + 1024;
}

// The shared address of element (r, c), c % 8 == 0, of an R x D tile as TMA
// writes it (hopper::Tile: 16-byte units XOR-swizzled within each 128- or
// 64-byte row span, as the map's swizzle does it).
template <int R, int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  using L = hopper::Tile<R, D>;
  const uint32_t off =
      (c / L::kChunk) * (R * L::kRowBytes) + r * L::kRowBytes + (c % L::kChunk) * 2;
  return base + (off ^ (((off >> 7) & (L::kRowBytes == 128 ? 7 : 3)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc (16 x 16) += A · Bᵀ over D: A the warp's 16 rows from row a0 of an RA x
// D tile, B rows r0..r0+15 of an NT x D tile, both swizzled, D-contiguous.
template <typename T, int D, int RA, int NT>
__device__ __forceinline__ void mma_abt16(float (&acc)[2][4], uint32_t a, int a0, uint32_t b,
                                          int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4], bf[4];
    ldsm_x4(af, tile_addr<RA, D>(a, a0 + lane % 16, kk * 16 + (lane / 16) * 8));
    ldsm_x4(bf, tile_addr<NT, D>(b, r0 + lane % 8 + (lane / 16) * 8,
                                 kk * 16 + ((lane / 8) % 2) * 8));
    Num<T>::mma(acc[0], af, bf[0], bf[1]);
    Num<T>::mma(acc[1], af, bf[2], bf[3]);
  }
}

// acc (16 x D) += T(P) · B: P (16 x 16) as two f32 accumulator tiles (one
// k16 A fragment), B rows r0..r0+15 of an NT x D swizzled tile read through
// ldmatrix.trans.
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_pv16(float (&acc)[D / 8][4], const float (&p)[2][4],
                                         uint32_t b, int r0, int lane) {
  uint32_t pf[4];
  pf[0] = Num<T>::pack2(p[0][0], p[0][1]);
  pf[1] = Num<T>::pack2(p[0][2], p[0][3]);
  pf[2] = Num<T>::pack2(p[1][0], p[1][1]);
  pf[3] = Num<T>::pack2(p[1][2], p[1][3]);
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    uint32_t vf[4];
    ldsm_x4_trans(vf, tile_addr<NT, D>(b, r0 + lane % 8 + ((lane / 8) % 2) * 8,
                                       dn * 16 + (lane / 16) * 8));
    Num<T>::mma(acc[2 * dn], pf, vf[0], vf[1]);
    Num<T>::mma(acc[2 * dn + 1], pf, vf[2], vf[3]);
  }
}

// acc (16 x DC) += T(ds) · K: the warp's 16 query rows from row r0 of Ps
// (query-major, BK keys, padded rows) and columns c0.. of the BK x D K tile.
template <typename T, int D, int BK, int DC>
__device__ __forceinline__ void mma_dq(float (&acc)[DC / 8][4], T (*Ps)[BK + 8], int r0,
                                       uint32_t k, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, &Ps[r0 + lane % 16][kk * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int dn = 0; dn < DC / 16; ++dn) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, tile_addr<BK, D>(k, kk * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                         c0 + dn * 16 + (lane / 16) * 8));
      Num<T>::mma(acc[2 * dn], af, bf[0], bf[1]);
      Num<T>::mma(acc[2 * dn + 1], af, bf[2], bf[3]);
    }
  }
}

// One CTA per (key block of BK keys, head, image), BK / 16 warps of 16 keys:
// dk and dv of its keys over every query step of QT rows, and dq's share of
// its keys (stored, or f32 partials when the row takes several blocks).
// Thread 0 brings K and V once and the steps' (Q, dO, O) tiles through a ring
// of `stages` stages by TMA; it refills a stage as soon as every thread has
// passed the step's last read of it, so the next step's tiles arrive while
// this step's dq is computed.  Per step: D = rowsum(dO∘O) from the staged
// tiles; sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, p = exp(s·scale - lse), ds = p·(dp - D)·
// scale (keys past n_k and queries past n_q: 0); dv += T(pᵀ)·dO, dk +=
// T(dsᵀ)·q; T(ds) to shared memory query-major; dq = T(ds)·k over the block's
// keys, split over the warps.
template <typename T, int D, int BK, int QT, bool BIAS>
__global__ void __launch_bounds__(2 * BK, D > 64 ? 1 : BK == 64 ? 3 : BK == 80 ? 2 : 1)
    short_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map,
                     const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                     T* __restrict__ dq, Strides dqs, float* __restrict__ dq_part,
                     T* __restrict__ dk, Strides dks, T* __restrict__ dv, Strides dvs, Bias bias,
                     float2* __restrict__ rowstat, int batch, int heads, int n_q, int n_k,
                     float scale, int stages) {
  constexpr int W = BK / 16, RG = QT / 16, CG = dq_col_groups<RG, W, D>(), DC = D / CG;
  constexpr int TPR = d_threads<32 * W / QT, D / 8>();  // threads of a row of D
  using KTile = hopper::Tile<BK, D>;
  using QTile = hopper::Tile<QT, D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = hopper::align1024(smem_raw);
  unsigned char* vs = ks + KTile::kBytes;
  unsigned char* ring = vs + KTile::kBytes;  // per stage: Q, dO, O
  T(*Ps)[BK + 8] = reinterpret_cast<T(*)[BK + 8]>(ring + stages * 3 * QTile::kBytes);
  float2* st = reinterpret_cast<float2*>(Ps + QT);  // (lse, D) of the step's rows
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(st + QT);
  uint64_t* full = kv_bar + 1;

  const int j0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, t = lane % 4, g = lane / 4;
  const int a0 = warp * 16;  // the warp's keys, from j0
  const int steps = (n_q + QT - 1) / QT;
  auto load_step = [&](int i) {
    unsigned char* tiles = ring + (i % stages) * 3 * QTile::kBytes;
    uint64_t* bar = &full[i % stages];
    hopper::mbar_expect_tx(bar, 3 * QTile::kBytes);
    QTile::load(tiles, 0, &q_map, bar, i * QT, h, b);
    QTile::load(tiles + QTile::kBytes, 0, &do_map, bar, i * QT, h, b);
    QTile::load(tiles + 2 * QTile::kBytes, 0, &o_map, bar, i * QT, h, b);
  };
  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_bar, 2 * KTile::kBytes);
    KTile::load(ks, 0, &k_map, kv_bar, j0, h, b);
    KTile::load(vs, 0, &v_map, kv_bar, j0, h, b);
    for (int i = 0; i < stages && i < steps; ++i) load_step(i);
  }

  const uint32_t k_at = smem_addr(ks), v_at = smem_addr(vs);
  const int r0 = (warp % RG) * 16, c0 = (warp / RG) * DC;  // the warp's share of dq's tile
  const size_t row0 = ((size_t)b * heads + h) * n_q;
  const float* bias_h = BIAS ? bias.p + h * bias.hstride : nullptr;
  static_assert(32 * W / TPR >= QT, "one pass of the D rows covers a step");
  const int dr = tid / TPR;  // the thread's row of D
  float lse_next = dr < QT && dr < n_q ? lse[row0 + dr] : 0.f;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  hopper::mbar_wait(kv_bar, 0);

  for (int i = 0; i < steps; ++i) {
    const int i0 = i * QT;
    const unsigned char* tiles = ring + (i % stages) * 3 * QTile::kBytes;
    const uint32_t q_at = smem_addr(tiles), do_at = q_at + QTile::kBytes;
    const float lse_r = lse_next;  // this step's, loaded a step ahead
    if (dr < QT && i + 1 < steps && i0 + QT + dr < n_q) lse_next = lse[row0 + i0 + QT + dr];
    hopper::mbar_wait(&full[i % stages], (i / stages) & 1);
    // D = rowsum(dO∘O): TPR neighbouring threads a row (one pass covers the
    // step's rows), 16-byte pieces of O and dO each, then a sum over the TPR
    // lanes.
    if (const int r = dr; r < QT) {
      float acc = 0.f;
#pragma unroll
      for (int c = 8 * (tid % TPR); c < D; c += 8 * TPR) {
        const uint32_t off = tile_addr<QT, D>(0, r, c);
        const uint4 ov = *reinterpret_cast<const uint4*>(tiles + 2 * QTile::kBytes + off);
        const uint4 dv8 = *reinterpret_cast<const uint4*>(tiles + QTile::kBytes + off);
        const T* od = reinterpret_cast<const T*>(&ov);
        const T* dd = reinterpret_cast<const T*>(&dv8);
#pragma unroll
        for (int e = 0; e < 8; e += 2)
          acc += Num<T>::to_f(od[e]) * Num<T>::to_f(dd[e]) +
                 Num<T>::to_f(od[e + 1]) * Num<T>::to_f(dd[e + 1]);
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (tid % TPR == 0) st[r] = i0 + r < n_q ? make_float2(lse_r, acc) : make_float2(0.f, 0.f);
      if constexpr (BIAS)  // (lse, D) for dbias, written by the first key block
        if (rowstat && blockIdx.x == 0 && tid % TPR == 0 && i0 + r < n_q)
          rowstat[row0 + i0 + r] = make_float2(lse_r, acc);
    }
    __syncthreads();  // st is complete; the previous step's reads of Ps are done

    const int rows = min(QT, (n_q - i0 + 15) / 16 * 16);  // the step's query rows, whole 16s
#pragma unroll 1
    for (int c0q = 0; c0q < rows; c0q += 16) {  // 16 queries at a time
      float s[2][4], dp[2][4];
      zero(s);
      zero(dp);
      mma_abt16<T, D, BK, QT>(s, k_at, a0, q_at, c0q, lane);    // sᵀ[key][query]
      mma_abt16<T, D, BK, QT>(dp, v_at, a0, do_at, c0q, lane);  // dpᵀ = v·dOᵀ
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c0q + j * 8 + 2 * t + (e & 1);
          const int key = j0 + a0 + g + (e / 2) * 8;
          const float2 rs = st[qi];
          float p;
          if constexpr (BIAS)
            p = i0 + qi < n_q && key < n_k
                    ? expf(s[j][e] * scale + __ldg(bias_h + (size_t)(i0 + qi) * n_k + key) - rs.x)
                    : 0.f;
          else
            p = i0 + qi < n_q && key < n_k ? expf(s[j][e] * scale - rs.x) : 0.f;  // masked: 0
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - rs.y) * scale;  // dsᵀ
          Ps[qi][a0 + g + (e / 2) * 8] = Num<T>::from_f(dp[j][e]);
        }
      mma_pv16<T, D, QT>(dv_acc, s, do_at, c0q, lane);  // dv += T(pᵀ)·dO
      mma_pv16<T, D, QT>(dk_acc, dp, q_at, c0q, lane);  // dk += T(dsᵀ)·q
    }
    __syncthreads();  // Ps is complete; the stage's last reads are done
    if (tid == 0 && i + stages < steps) load_step(i + stages);

    if (warp < RG * CG && r0 < rows) {
      float acc[DC / 8][4];
      zero(acc);
      mma_dq<T, D, BK, DC>(acc, Ps, r0, k_at, c0, lane);  // dq = T(ds)·k
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
            *reinterpret_cast<uint32_t*>(head_base(dq, dqs, b, h) + (long long)qi * dqs.r +
                                         col) = Num<T>::pack2(lo, hi);
          }
        }
      }
    }
  }
  store_rows<T, D>(head_base(dk, dks, b, h), dks.r, j0 + a0, n_k, dk_acc, lane);
  store_rows<T, D>(head_base(dv, dvs, b, h), dvs.r, j0 + a0, n_k, dv_acc, lane);
}

// The backward where one CTA holds 129 to 256 keys at d <= 64 (ViT-B/16's
// 197), on wgmma: four warpgroups of 64 key rows (the key tile is 256 rows,
// zeros past n_k), each holding its keys' dk and dv (m64 x d f32) across the
// steps.  Per 64-query step, 32 queries at a time: sᵀ = k·qᵀ and dpᵀ = v·dOᵀ
// on m64n32k16 from the swizzled tiles, p and ds in registers, dv += T(pᵀ)·dO
// and dk += T(dsᵀ)·q with p and ds as the register A operand and dO, q
// MN-major; T(ds) goes to a 64 x 256 query-major tile laid out as wgmma's A
// operand (four 64-key chunks, 128-byte swizzle), and one warpgroup in turn
// takes dq = T(ds)·k (m64 x d over the 256 keys, k MN-major) and stores it.
// Persistent: a CTA per SM walks the (head, image) pairs; K and V come by TMA
// into one of two buffers, the next pair's while this one is computed, and
// the (Q, dO, O) steps of all its pairs through one 2-stage ring, so no pair
// waits for its first tiles.  The same function and rounding points as
// short_bwd_kernel; each B operand is read once a warpgroup from shared
// memory, where thirteen mma.sync warps would each read it.
template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(512, 1)
    short_bwd_wg_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap o_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse, T* __restrict__ dq, Strides dqs,
                        T* __restrict__ dk, Strides dks, T* __restrict__ dv, Strides dvs,
                        Bias bias, float2* __restrict__ rowstat, int heads, int pairs, int n_q,
                        int n_k, float scale) {
  constexpr int BK = kWgKeys, QT = kWgRows, NQ = 32, S = 2;
  constexpr int TPR = d_threads<512 / QT, D / 8>();
  using KTile = hopper::Tile<BK, D>;
  using QTile = hopper::Tile<QT, D>;
  using PTile = hopper::Tile<QT, 64>;  // a 64-key chunk of T(ds)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = hopper::align1024(smem_raw);  // two (K, V) buffers
  unsigned char* ring = kv + 4 * KTile::kBytes;     // per stage: Q, dO, O
  unsigned char* ps = ring + S * 3 * QTile::kBytes;
  float2* st = reinterpret_cast<float2*>(ps + (BK / 64) * PTile::kBytes);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(st + QT);  // two
  uint64_t* full = kv_bar + 2;

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int spp = (n_q + QT - 1) / QT;  // steps a pair
  const int mine = (pairs - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * spp;  // this CTA's steps over its pairs
  auto pair_of = [&](int k) { return (int)blockIdx.x + k * (int)gridDim.x; };
  auto load_kv = [&](int k) {
    const int pi = pair_of(k);
    unsigned char* buf = kv + (k % 2) * 2 * KTile::kBytes;
    hopper::mbar_expect_tx(&kv_bar[k % 2], 2 * KTile::kBytes);
    KTile::load(buf, 0, &k_map, &kv_bar[k % 2], 0, pi % heads, pi / heads);
    KTile::load(buf + KTile::kBytes, 0, &v_map, &kv_bar[k % 2], 0, pi % heads, pi / heads);
  };
  auto load_step = [&](int gs) {
    const int pi = pair_of(gs / spp), r = (gs % spp) * QT;
    unsigned char* tiles = ring + (gs % S) * 3 * QTile::kBytes;
    uint64_t* bar = &full[gs % S];
    hopper::mbar_expect_tx(bar, 3 * QTile::kBytes);
    QTile::load(tiles, 0, &q_map, bar, r, pi % heads, pi / heads);
    QTile::load(tiles + QTile::kBytes, 0, &do_map, bar, r, pi % heads, pi / heads);
    QTile::load(tiles + 2 * QTile::kBytes, 0, &o_map, bar, r, pi % heads, pi / heads);
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&kv_bar[i], 1);
      hopper::mbar_init(&full[i], 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && mine > 0) {
    load_kv(0);
    for (int gs = 0; gs < S && gs < total; ++gs) load_step(gs);
  }

  const int fr = (lt / 32) * 16 + (lt % 32) / 4, t = lt % 4;  // fragment row, column pair
  static_assert(512 / TPR >= QT, "one pass of the D rows covers a step");
  const int dr = tid / TPR;  // the thread's row of D
  for (int k = 0; k < mine; ++k) {
    const int pi = pair_of(k), h = pi % heads, b = pi / heads;
    const float* bias_h = BIAS ? bias.p + h * bias.hstride : nullptr;
    const unsigned char* ks = kv + (k % 2) * 2 * KTile::kBytes;
    const unsigned char* vs = ks + KTile::kBytes;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hopper::mbar_wait(&kv_bar[k % 2], (k / 2) & 1);
    for (int i = 0; i < spp; ++i) {
      const int gs = k * spp + i, i0 = i * QT;
      const unsigned char* tiles = ring + (gs % S) * 3 * QTile::kBytes;
      const unsigned char* do_t = tiles + QTile::kBytes;
      const float lse_r = dr < QT && i0 + dr < n_q ? lse[(size_t)pi * n_q + i0 + dr] : 0.f;
      hopper::mbar_wait(&full[gs % S], (gs / S) & 1);
      if (const int r = dr; r < QT) {  // D = rowsum(dO∘O), TPR threads a row
        float acc = 0.f;
#pragma unroll
        for (int c = 8 * (tid % TPR); c < D; c += 8 * TPR) {
          const uint32_t off = tile_addr<QT, D>(0, r, c);
          const uint4 ov = *reinterpret_cast<const uint4*>(tiles + 2 * QTile::kBytes + off);
          const uint4 dv8 = *reinterpret_cast<const uint4*>(do_t + off);
          const T* od = reinterpret_cast<const T*>(&ov);
          const T* dd = reinterpret_cast<const T*>(&dv8);
#pragma unroll
          for (int e = 0; e < 8; e += 2)
            acc += Num<T>::to_f(od[e]) * Num<T>::to_f(dd[e]) +
                   Num<T>::to_f(od[e + 1]) * Num<T>::to_f(dd[e + 1]);
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (tid % TPR == 0) st[r] = i0 + r < n_q ? make_float2(lse_r, acc) : make_float2(0.f, 0.f);
        if constexpr (BIAS)  // (lse, D) for dbias
          if (rowstat && tid % TPR == 0 && i0 + r < n_q)
            rowstat[(size_t)pi * n_q + i0 + r] = make_float2(lse_r, acc);
      }
      // st is complete; the previous step's reads of T(ds) (and at a pair's
      // first step, every read of the previous pair's K and V) are done.
      __syncthreads();
      if (tid == 0 && i == 0 && k + 1 < mine) load_kv(k + 1);

      const int rows = min(QT, (n_q - i0 + NQ - 1) / NQ * NQ);
      for (int c0q = 0; c0q < rows; c0q += NQ) {
        float s[NQ / 2], dp[NQ / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::Wgmma<NQ, T>::ss(s, KTile::kmajor(ks, 64 * wg, 16 * kk),
                                   QTile::kmajor(tiles, c0q, 16 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::Wgmma<NQ, T>::ss(dp, KTile::kmajor(vs, 64 * wg, 16 * kk),
                                   QTile::kmajor(do_t, c0q, 16 * kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c0q + 8 * j + 2 * t + (e & 1), key = 64 * wg + fr + 8 * (e / 2);
            const float2 rs = st[qi];
            float p;
            if constexpr (BIAS)
              p = i0 + qi < n_q && key < n_k
                      ? expf(s[4 * j + e] * scale +
                             __ldg(bias_h + (size_t)(i0 + qi) * n_k + key) - rs.x)
                      : 0.f;
            else
              p = i0 + qi < n_q && key < n_k ? expf(s[4 * j + e] * scale - rs.x) : 0.f;
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - rs.y) * scale;  // dsᵀ
            const uint32_t off = qi * 128 + (key % 64) * 2;
            *reinterpret_cast<T*>(ps + (key / 64) * PTile::kBytes +
                                  (off ^ (((off >> 7) & 7) << 4))) =
                Num<T>::from_f(dp[4 * j + e]);
          }
        uint32_t pa[NQ / 16][4], da[NQ / 16][4];
#pragma unroll
        for (int c = 0; c < NQ / 16; ++c) {
          hopper::a_fragment<T>(pa[c], s, c);
          hopper::a_fragment<T>(da[c], dp, c);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < NQ / 16; ++c) {
          hopper::Wgmma<D, T>::rs(dv_acc, pa[c], QTile::mnmajor(do_t, c0q + 16 * c));
          hopper::Wgmma<D, T>::rs(dk_acc, da[c], QTile::mnmajor(tiles, c0q + 16 * c));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(pa);
        hopper::fence_regs(da);
      }
      hopper::fence_proxy_async();  // T(ds), stored by the threads, is read by wgmma
      __syncthreads();              // T(ds) is complete; the stage's last reads are done
      if (tid == 0 && gs + S < total) load_step(gs + S);

      if (wg == gs % 4) {  // dq = T(ds)·k, one warpgroup in turn
        float acc[D / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::Wgmma<D, T>::ss_t(acc, PTile::kmajor(ps + (kk / 4) * PTile::kBytes, 0,
                                                       16 * (kk % 4)),
                                    KTile::mnmajor(ks, 16 * kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        hopper::store_fragment<T, D>(head_base(dq, dqs, b, h), dqs.r, i0, n_q, acc, lt);
      }
    }
    hopper::store_fragment<T, D>(head_base(dk, dks, b, h), dks.r, 64 * wg, n_k, dk_acc, lt);
    hopper::store_fragment<T, D>(head_base(dv, dvs, b, h), dvs.r, 64 * wg, n_k, dv_acc, lt);
  }
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

Bias bias_of(const float* bias, int hb, int n_q, int n_k) {
  return Bias{bias, hb == 1 ? 0 : (long long)n_q * n_k};
}

template <typename T, int D, int BK, bool BIAS>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* out, float* lse, Bias bias,
                  const long long* st, int b, int heads, int n_q, int n_k, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = fwd_smem_bytes<D, BK>(), dt = hopper::dtype_of<T>();
  constexpr int c = hopper::Tile<64, D>::kChunk;
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, short_fwd_kernel<T, D, BK, BIAS>, bytes);
  CUtensorMap q_map, k_map, v_map;
  if (err == cudaSuccess) err = head_map(&q_map, q, dt, D, n_q, heads, b, st, c, 64);
  if (err == cudaSuccess) err = head_map(&k_map, k, dt, D, n_k, heads, b, st + 3, c, BK);
  if (err == cudaSuccess) err = head_map(&v_map, v, dt, D, n_k, heads, b, st + 6, c, BK);
  if (err != cudaSuccess) return err;
  const int wgs = n_q > 64 ? 2 : 1;
  dim3 grid((n_q + 64 * wgs - 1) / (64 * wgs), heads, b);
  short_fwd_kernel<T, D, BK, BIAS><<<grid, 128 * wgs, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), strides_at(st, 3), lse, bias, heads, n_q, n_k,
      scale);
  return cudaGetLastError();
}

template <typename T, int D, int BK, bool BIAS>
cudaError_t bwd_t(const void* q, const void* k, const void* v, const void* out,
                  const float* lse, const void* dout, void* dq, void* dk, void* dv,
                  float* dq_part, Bias bias, float2* rowstat, const long long* st, int b,
                  int heads, int n_q, int n_k, float scale, cudaStream_t stream) {
  constexpr int QT = bwd_rows<BK>(), dt = hopper::dtype_of<T>();
  constexpr int c = hopper::Tile<BK, D>::kChunk;
  const int steps = (n_q + QT - 1) / QT, stages = steps > 1 ? 2 : 1;
  const int parts = (n_k + BK - 1) / BK;
  if (parts > 1 && !dq_part) return cudaErrorInvalidValue;
  float* part = parts > 1 ? dq_part : nullptr;
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, short_bwd_kernel<T, D, BK, QT, BIAS>,
                                   bwd_smem_bytes<D, BK, QT>(2));
  // A map needs a row; with no query rows none is read.
  const int nq = n_q > 0 ? n_q : 1;
  CUtensorMap q_map, k_map, v_map, o_map, do_map;
  if (err == cudaSuccess) err = head_map(&q_map, q, dt, D, nq, heads, b, st, c, QT);
  if (err == cudaSuccess) err = head_map(&k_map, k, dt, D, n_k, heads, b, st + 3, c, BK);
  if (err == cudaSuccess) err = head_map(&v_map, v, dt, D, n_k, heads, b, st + 6, c, BK);
  if (err == cudaSuccess) err = head_map(&o_map, out, dt, D, nq, heads, b, st + 9, c, QT);
  if (err == cudaSuccess) err = head_map(&do_map, dout, dt, D, nq, heads, b, st + 12, c, QT);
  if (err != cudaSuccess) return err;
  const Strides dqs = strides_at(st, 5);
  short_bwd_kernel<T, D, BK, QT, BIAS><<<dim3(parts, heads, b), 2 * BK,
                                         bwd_smem_bytes<D, BK, QT>(stages), stream>>>(
      q_map, k_map, v_map, o_map, do_map, lse, static_cast<T*>(dq), dqs, part,
      static_cast<T*>(dk), strides_at(st, 6), static_cast<T*>(dv), strides_at(st, 7), bias,
      rowstat, b, heads, n_q, n_k, scale, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || !part || n_q == 0) return err;
  const long long pairs = (long long)b * heads * n_q * D / 2;
  short_dq_sum_kernel<T><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      part, parts, static_cast<T*>(dq), dqs, heads, n_q, D, pairs);
  return cudaGetLastError();
}

// short_bwd_wg_kernel: one persistent CTA per SM, at most one per (head, image).
template <typename T, int D, bool BIAS>
cudaError_t bwd_wg_t(const void* q, const void* k, const void* v, const void* out,
                     const float* lse, const void* dout, void* dq, void* dk, void* dv, Bias bias,
                     float2* rowstat, const long long* st, int b, int heads, int n_q, int n_k,
                     float scale, cudaStream_t stream) {
  constexpr int BK = kWgKeys, QT = kWgRows, dt = hopper::dtype_of<T>();
  constexpr int c = hopper::Tile<BK, D>::kChunk;
  constexpr int bytes = 4 * hopper::Tile<BK, D>::kBytes + 2 * 3 * hopper::Tile<QT, D>::kBytes +
                        (BK / 64) * hopper::Tile<QT, 64>::kBytes + QT * 8 + 4 * 8 + 1024;
  static_assert(bytes <= 232448, "more shared memory than a CTA may have");
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, short_bwd_wg_kernel<T, D, BIAS>, bytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int nq = n_q > 0 ? n_q : 1;  // a map needs a row; with no query rows none is read
  CUtensorMap q_map, k_map, v_map, o_map, do_map;
  if (err == cudaSuccess) err = head_map(&q_map, q, dt, D, nq, heads, b, st, c, QT);
  if (err == cudaSuccess) err = head_map(&k_map, k, dt, D, n_k, heads, b, st + 3, c, BK);
  if (err == cudaSuccess) err = head_map(&v_map, v, dt, D, n_k, heads, b, st + 6, c, BK);
  if (err == cudaSuccess) err = head_map(&o_map, out, dt, D, nq, heads, b, st + 9, c, QT);
  if (err == cudaSuccess) err = head_map(&do_map, dout, dt, D, nq, heads, b, st + 12, c, QT);
  if (err != cudaSuccess) return err;
  const int pairs = b * heads;
  short_bwd_wg_kernel<T, D, BIAS><<<pairs < sms ? pairs : sms, 512, bytes, stream>>>(
      q_map, k_map, v_map, o_map, do_map, lse, static_cast<T*>(dq), strides_at(st, 5),
      static_cast<T*>(dk), strides_at(st, 6), static_cast<T*>(dv), strides_at(st, 7), bias,
      rowstat, heads, pairs, n_q, n_k, scale);
  return cudaGetLastError();
}

// The backward at the key block bwd_key_block picks.
template <typename T, int D, bool BIAS>
cudaError_t bwd_tiles(const void* q, const void* k, const void* v, const void* out,
                      const float* lse, const void* dout, void* dq, void* dk, void* dv,
                      float* dq_part, Bias bias, float2* rowstat, const long long* st, int b,
                      int heads, int n_q, int n_k, float scale, cudaStream_t stream) {
#define VIT_SHORT_BWD_TILE(BK)                                                                \
  return bwd_t<T, D, BK, BIAS>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, bias, rowstat, st, \
                               b, heads, n_q, n_k, scale, stream)
  switch (bwd_key_block(n_k, D)) {
    case 64: VIT_SHORT_BWD_TILE(64);
    case 80: VIT_SHORT_BWD_TILE(80);
    case kSplitKeys: VIT_SHORT_BWD_TILE(kSplitKeys);
    case kWgKeys:
      if constexpr (D <= 64)
        return bwd_wg_t<T, D, BIAS>(q, k, v, out, lse, dout, dq, dk, dv, bias, rowstat, st, b,
                                    heads, n_q, n_k, scale, stream);
      break;
  }
  VIT_SHORT_BWD_TILE(128);
#undef VIT_SHORT_BWD_TILE
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
// take two passes over key tiles: two of 144 keys from 257 to 288 (the
// small-dataset ViT's 257, where 128-key tiles would take a third tile for one
// key), 128-key tiles otherwise.
template <typename T, int D, bool BIAS>
cudaError_t fwd_tiles(const void* q, const void* k, const void* v, void* out, float* lse,
                      Bias bias, const long long* st, int b, int heads, int n_q, int n_k,
                      float scale, cudaStream_t stream) {
#define VIT_SHORT_FWD_TILE(BK) \
  return fwd_t<T, D, BK, BIAS>(q, k, v, out, lse, bias, st, b, heads, n_q, n_k, scale, stream)
  if (n_k <= 64) VIT_SHORT_FWD_TILE(64);
  if (n_k <= 80) VIT_SHORT_FWD_TILE(80);
  if constexpr (D <= 64) {
    if (n_k > 128 && n_k <= 208) VIT_SHORT_FWD_TILE(208);
  }
  if (n_k > 256 && n_k <= 2 * kSplitKeys) VIT_SHORT_FWD_TILE(kSplitKeys);
  VIT_SHORT_FWD_TILE(128);
#undef VIT_SHORT_FWD_TILE
}

template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
                         Bias bias, const long long* st, int b, int heads, int n_q, int n_k,
                         int d, float scale, cudaStream_t stream) {
#define VIT_SHORT_FWD(D)                                                                       \
  if (d == D)                                                                                  \
    return bias.p ? fwd_tiles<T, D, true>(q, k, v, out, lse, bias, st, b, heads, n_q, n_k,     \
                                          scale, stream)                                       \
                  : fwd_tiles<T, D, false>(q, k, v, out, lse, bias, st, b, heads, n_q, n_k,    \
                                           scale, stream);
  VIT_SHORT_WIDTHS(VIT_SHORT_FWD)
#undef VIT_SHORT_FWD
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_dispatch(const void* q, const void* k, const void* v, const void* out,
                         const float* lse, const void* dout, void* dq, void* dk, void* dv,
                         float* dq_part, Bias bias, float2* rowstat, const long long* st, int b,
                         int heads, int n_q, int n_k, int d, float scale, cudaStream_t stream) {
#define VIT_SHORT_BWD(D)                                                                       \
  if (d == D)                                                                                  \
    return bias.p ? bwd_tiles<T, D, true>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, bias,  \
                                          rowstat, st, b, heads, n_q, n_k, scale, stream)      \
                  : bwd_tiles<T, D, false>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, bias, \
                                           nullptr, st, b, heads, n_q, n_k, scale, stream);
  VIT_SHORT_WIDTHS(VIT_SHORT_BWD)
#undef VIT_SHORT_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_short_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                             const long long* strides, int b, int heads, int n_q, int n_k, int d,
                             float scale, int dtype, cudaStream_t stream, const float* bias,
                             int hb) {
  if (!shape_ok(b, heads, n_q, n_k, d) || (bias && hb != 1 && hb != heads))
    return cudaErrorInvalidValue;
  if (b == 0 || n_q == 0) return cudaSuccess;
  const Bias bs = bias_of(bias, hb, n_q, n_k);
  if (dtype == kBF16)
    return fwd_dispatch<__nv_bfloat16>(q, k, v, out, lse, bs, strides, b, heads, n_q, n_k, d,
                                       scale, stream);
  if (dtype == kF16)
    return fwd_dispatch<__half>(q, k, v, out, lse, bs, strides, b, heads, n_q, n_k, d, scale,
                                stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_short_bwd(const void* q, const void* k, const void* v, const void* out,
                             const float* lse, const void* dout, void* dq, void* dk, void* dv,
                             float* dq_part, const long long* strides, int b, int heads, int n_q,
                             int n_k, int d, float scale, int dtype, cudaStream_t stream,
                             const float* bias, int hb, float* rowstat) {
  if (!shape_ok(b, heads, n_q, n_k, d) || (bias && hb != 1 && hb != heads) || (rowstat && !bias))
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const Bias bs = bias_of(bias, hb, n_q, n_k);
  float2* rs = reinterpret_cast<float2*>(rowstat);
  if (dtype == kBF16)
    return bwd_dispatch<__nv_bfloat16>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, bs, rs,
                                       strides, b, heads, n_q, n_k, d, scale, stream);
  if (dtype == kF16)
    return bwd_dispatch<__half>(q, k, v, out, lse, dout, dq, dk, dv, dq_part, bs, rs, strides, b,
                                heads, n_q, n_k, d, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit

// Forward: out (width d) in the compute dtype through its strides and, when
// `lse` is not null, lse (b, h, n_q) f32 contiguous.  `strides` (host memory)
// holds the (batch, head, row) element strides of q, k, v and out (12
// values); each operand's last axis is contiguous, its rows 16-byte aligned.
extern "C" int vit_short_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       float* lse, const long long* strides, int b, int heads,
                                       int n_q, int n_k, int d, float scale, int dtype,
                                       cudaStream_t stream) {
  return vit::launch_short_fwd(q, k, v, out, lse, strides, b, heads, n_q, n_k, d, scale, dtype,
                               stream);
}

// Backward: dq, dk, dv in the compute dtype from q, k, v, the forward's out
// and lse, and dout = dL/d(out).  `strides` holds the (batch, head, row)
// strides of q, k, v, out, dout, dq, dk and dv (24 values).  `dq_part`
// (vit_short_attention_parts(n_k, d), b, h, n_q, d) f32 is scratch for the key
// blocks' dq shares, null when there is one block.
extern "C" int vit_short_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const float* lse, const void* dout,
                                       void* dq, void* dk, void* dv, float* dq_part,
                                       const long long* strides, int b, int heads, int n_q,
                                       int n_k, int d, float scale, int dtype,
                                       cudaStream_t stream) {
  return vit::launch_short_bwd(q, k, v, out, lse, dout, dq, dk, dv, dq_part, strides, b, heads,
                               n_q, n_k, d, scale, dtype, stream);
}

// Key blocks of the backward at n_k keys and width d: dq_part's leading
// extent when > 1.
extern "C" int vit_short_attention_parts(int n_k, int d) {
  const int bk = vit::bwd_key_block(n_k, d);
  return (n_k + bk - 1) / bk;
}
