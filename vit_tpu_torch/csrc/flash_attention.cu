// Flash attention on Hopper: an online-softmax forward that saves each query
// row's log-sum-exp, and the two-pass backward that recomputes the softmax
// from it.  q (b, h, n_q, dk), k (b, h, n_k, dk) and v (b, h, n_k, dv), any
// n_q and n_k, (dk, dv) ∈ {(32, 32), (40, 32), (64, 64), (96, 96), (128, 128)},
// bf16 or f16 operands, f32 accumulation: every kernel on wgmma with its
// operands brought by TMA (hopper.cuh).
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
// q/k and v have their own head widths (ScalableViT's SSA: 40 and 32).  A
// width that is no swizzled tile's is zero-filled in shared memory, never
// padded in device memory: to the tile's 64 (or 128) columns, by the tensor
// map's extent (the extra columns add 0 to every logit and every output
// column past the width is dropped); the forward's q·kᵀ steps stop at the
// width padded to 16 (40 -> 48); dq and dk are stored at the true width.
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
// Forward (flash_fwd), one CTA per 128-query block (two warpgroups of 64; one
// for a block of at most 64 rows, or where one 64-key tile holds every key):
// Q once by TMA, (k, v) tiles of 64 keys through a ring of up to 4 stages on
// mbarriers; per tile s = q·kᵀ (wgmma, shared operands) scaled in f32, keys
// past n_k -inf before the row max (every tile holds a valid key, so the max
// is finite), a running max and sum rescale the accumulator, and p, rounded
// to the compute dtype (the TPU kernel kept P in f32, flash_attention.py:
// 76-80; the plain version rounds where this kernel does), is wgmma's
// register A operand of o += p·v, v MN-major.  Tile i's q·kᵀ and tile i - 1's
// p·v are in flight together, and tile i's softmax runs under p·v.  The
// divide by the f32 row sum comes last, and lse = m + log l.  Query rows past
// n_q arrive as zeros and are not stored.  Up to 64 + 64 wide its registers
// fit 128 a thread and two CTAs share an SM, so one CTA's softmax also
// overlaps the other's products (128-key tiles at one CTA an SM, and the same
// kernel without the in-flight pair, were slower at CvT-13's shapes).
//
// Backward, FA2's split, each output tile with one owner (no atomics, so the
// bits repeat):
//   0. flash_bwd_dsum: D = rowsum(dO∘O) in f32 over the stored output (as
//      flash_backward.py:135), one warp per query row.
//   1. flash_bwd_dq, one CTA per 128-query block (two warpgroups of 64): Q and
//      dO once by TMA, (k, v) tiles of 64 keys through a 3-stage ring on
//      mbarriers; per tile s = q·kᵀ and dp = dO·vᵀ (wgmma, shared operands),
//      p = exp(s - lse) and ds = T(p·(dp - D)·scale) in registers, dq +=
//      ds·k with ds as wgmma's register A operand.
//   2. flash_bwd_dkv, one CTA per 128-key block: K and V once, (q, dO) steps
//      of 32 query rows through the ring; per step sᵀ = k·qᵀ and dpᵀ = v·dOᵀ,
//      then dv += T(pᵀ)·dO and dk += T(dsᵀ)·q from registers, the
//      exponentials taken while dpᵀ is still on the tensor cores.  lse and D
//      are read per thread from device memory.  Up to 64 + 64 wide its
//      registers fit 128 a thread and two CTAs share an SM: four warpgroups,
//      whose exponentials and products interleave (64-row steps with one CTA
//      an SM were slower at CvT-13's shapes, PERF.md).
// Seven n_q x n_k x d products in all, as the TPU kernels count them.  Thread
// 0 issues every TMA load and refills a ring stage once all the CTA's threads
// have released it; there is no producer warp and no register rebalancing.
// Keys past n_k get p = 0 in step 1, query rows past n_q in step 2; TMA fills
// rows past n_q or n_k, and the columns of a 40-wide q/k past 40, with zeros
// (hopper.cuh); rows past n_q or n_k are not stored.  A block of at most 64
// rows runs one warpgroup.
#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace vit {
namespace {

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

// ---- forward on wgmma, fed by TMA -------------------------------------------------------------

// The (DK, DV) forward's shapes: q/k and v widths padded to swizzled tiles
// (40 -> 64, 96 -> 128), q·kᵀ in k16 steps over the q/k width padded to 16
// only (40 -> 48: the map's zeros past 40 add nothing, and the steps past 48
// are skipped), 64 keys per ring stage, the ring's depth, and the CTAs per
// SM: two where q/k and v of 64 + 64 or narrower keep a thread's registers
// under 128, else one.
template <int DK, int DV>
struct Fwd {
  static constexpr int PK = hopper::swizzled_width(DK), PV = hopper::swizzled_width(DV);
  static constexpr int BK = 64;
  static constexpr int kSteps = pad16(DK) / 16;
  static constexpr int kStages = 4;
  static constexpr int kBlocks = PK + PV <= 128 ? 2 : 1;
  // Q of up to 128 rows, a ring of `ring` stages of K and V tiles, the barriers (one, and
  // full/empty per stage), alignment.
  static constexpr int smem(int ring = kStages) {
    return 128 * PK * 2 + ring * BK * (PK + PV) * 2 + (1 + 2 * kStages) * 8 + 1024;
  }
};

// One CTA per (block of 64·W queries, head, image), W = blockDim / 128
// warpgroups of 64 queries each.  Q of the block comes once; (k, v) tiles of
// 64 keys stream through the ring, thread 0 refilling the stage of tile i - 2
// at the top of step i, once every thread has released it.  Per warpgroup:
// s = q·kᵀ on shared operands; s·scale with keys past n_k -inf (on the last
// tile only), the running row max m and sum l (this thread's share) with o
// rescaled as m grows, p = exp(s - m) rounded to T as wgmma's register A
// operand of o += T(p)·v, v MN-major.  Step i issues tile i's q·kᵀ and tile
// i - 1's p·v together and takes tile i's softmax while p·v is still on the
// tensor cores.  expf, as the plain version takes it (PERF.md: a cheaper
// exponential moved p's rounding enough to flip served top-1s).
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(256, Fwd<DK, DV>::kBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, T* __restrict__ out, Strides os,
                     float* __restrict__ lse, int heads, int n_q, int n_k, float scale) {
  using F = Fwd<DK, DV>;
  constexpr int BK = F::BK;
  using QTile = hopper::Tile<128, F::PK>;
  using KTile = hopper::Tile<BK, F::PK>;
  using VTile = hopper::Tile<BK, F::PV>;
  constexpr int S = F::kStages;
  // Fewer tiles than stages take a ring of one stage a tile, which never wraps.
  const int tiles = (n_k + BK - 1) / BK, ring = tiles < S ? tiles : S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align1024(smem_raw);
  unsigned char* ks = qs + QTile::kBytes;
  unsigned char* vs = ks + ring * KTile::kBytes;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(vs + ring * VTile::kBytes);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + S;

  const int wgs = blockDim.x / 128, q0 = blockIdx.x * 64 * wgs, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128, t = tid % 4;
  auto load_tile = [&](int i) {
    const int s = i % S;
    hopper::mbar_expect_tx(&full[s], KTile::kBytes + VTile::kBytes);
    KTile::load(ks + s * KTile::kBytes, 0, &k_map, &full[s], i * BK, h, b);
    VTile::load(vs + s * VTile::kBytes, 0, &v_map, &full[s], i * BK, h, b);
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
    hopper::mbar_expect_tx(q_bar, wgs * 64 * F::PK * 2);
    for (int w = 0; w < wgs; ++w) QTile::load(qs, 64 * w, &q_map, q_bar, q0 + 64 * w, h, b);
    for (int i = 0; i < S && i < tiles; ++i) load_tile(i);
  }

  float o[F::PV / 2];
#pragma unroll
  for (int i = 0; i < F::PV / 2; ++i) o[i] = 0.f;
  // Rows g and g + 8 of the warp's 16: running max, this thread's share of the
  // running sum (the quad's four shares are added at the end), o's rescale.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  auto issue_scores = [&](int i) {  // s = q·kᵀ of tile i
    const unsigned char* k_t = ks + (i % S) * KTile::kBytes;
#pragma unroll
    for (int kk = 0; kk < F::kSteps; ++kk)
      hopper::Wgmma<BK, T>::ss(sc, QTile::kmajor(qs, 64 * wg, 16 * kk),
                               KTile::kmajor(k_t, 0, 16 * kk), kk);
    hopper::wgmma_commit();
  };
  auto issue_pv = [&](int i) {  // o += T(p)·v of tile i
    const unsigned char* v_t = vs + (i % S) * VTile::kBytes;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
      hopper::Wgmma<F::PV, T>::rs(o, pa[c], VTile::mnmajor(v_t, 16 * c));
    hopper::wgmma_commit();
  };
  auto softmax = [&](int i) {  // sc <- p of tile i; m, l and alpha
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] *= scale;
    if ((i + 1) * BK > n_k) {  // the last tile: keys past n_k
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i * BK + 8 * j + 2 * t + (e & 1) >= n_k) sc[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
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
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = expf(sc[4 * j + e] - m_run[e / 2]);
        l_run[e / 2] += sc[4 * j + e];
      }
  };

  // Tile 0's scores and p; then each step i: q·kᵀ of tile i and p·v of tile i - 1.
  hopper::mbar_wait(q_bar, 0);
  hopper::mbar_wait(&full[0], 0);
  hopper::wgmma_fence();
  issue_scores(0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  softmax(0);
#pragma unroll
  for (int c = 0; c < BK / 16; ++c) hopper::a_fragment<T>(pa[c], sc, c);
  for (int i = 1; i < tiles; ++i) {
    if (tid == 0 && i >= 2 && i - 2 + S < tiles) {
      hopper::mbar_wait(&empty[(i - 2) % S], ((i - 2) / S) & 1);
      load_tile(i - 2 + S);
    }
    hopper::mbar_wait(&full[i % S], (i / S) & 1);
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    hopper::wgmma_fence();
    issue_scores(i);
    issue_pv(i - 1);
    hopper::wgmma_wait<1>();  // tile i's scores are done
    hopper::fence_regs(sc);
    softmax(i);
    hopper::wgmma_wait<0>();  // tile i - 1's p·v is done: o takes the rescale, its stage is free
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    hopper::mbar_arrive(&empty[(i - 1) % S]);
#pragma unroll
    for (int j = 0; j < F::PV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) hopper::a_fragment<T>(pa[c], sc, c);
  }
  hopper::fence_regs(o);
  hopper::fence_regs(pa);
  hopper::wgmma_fence();
  issue_pv(tiles - 1);  // the last tile's p·v
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  hopper::fence_regs(pa);

  // The late divide by the f32 row sum, one rounding in the store; lse = m + log l.
  const int row = q0 + 64 * wg + (lt / 32) * 16 + (lt % 32) / 4;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l_run[r]);
    if (t == 0 && row + 8 * r < n_q)
      lse[((size_t)b * heads + h) * n_q + row + 8 * r] = m_run[r] + logf(l[r]);
  }
#pragma unroll
  for (int j = 0; j < F::PV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] /= l[e / 2];
  hopper::store_fragment<T, DV>(head_base(out, os, b, h), os.r, q0 + 64 * wg, n_q, o, lt);
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

// ---- backward on wgmma, fed by TMA ------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// The (DK, DV) backward's shapes: q/k and v widths padded to swizzled tiles
// (40 -> 64), 32 query rows per step of the dk/dv kernel, 64 keys per step of
// the dq kernel, the depth of both kernels' TMA rings, and the dk/dv kernel's
// CTAs per SM: two where q/k and v are 64 + 64 wide or narrower (its
// registers then fit 128 a thread), one where dk and dv alone take 128.
template <int DK, int DV>
struct Bwd {
  static constexpr int PK = hopper::swizzled_width(DK), PV = hopper::swizzled_width(DV);
  static constexpr int BQ = 32;
  static constexpr int BK = 64;
  static constexpr int kStages = 3;
  static constexpr int kDkvBlocks = PK + PV <= 128 ? 2 : 1;
  // A block of up to 128 rows (two warpgroups of 64), the ring of the other side's steps, the
  // barriers (one, and full/empty per stage), alignment.
  static constexpr int kBarBytes = (1 + 2 * kStages) * 8 + 1024;
  static constexpr int dkv_smem() {
    return 128 * (PK + PV) * 2 + kStages * BQ * (PK + PV) * 2 + kBarBytes;
  }
  static constexpr int dq_smem() {
    return 128 * (PK + PV) * 2 + kStages * BK * (PK + PV) * 2 + kBarBytes;
  }
};

// The dk/dv kernel's step i into stage i % S: q and dO rows.
template <typename B>
__device__ __forceinline__ void dkv_load_step(int i, unsigned char* qs, unsigned char* os,
                                              uint64_t* full, const CUtensorMap* q_map,
                                              const CUtensorMap* do_map, int h, int b) {
  using QTile = hopper::Tile<B::BQ, B::PK>;
  using OTile = hopper::Tile<B::BQ, B::PV>;
  const int s = i % B::kStages;
  hopper::mbar_expect_tx(&full[s], QTile::kBytes + OTile::kBytes);
  QTile::load(qs + s * QTile::kBytes, 0, q_map, &full[s], i * B::BQ, h, b);
  OTile::load(os + s * OTile::kBytes, 0, do_map, &full[s], i * B::BQ, h, b);
}

// One CTA per (block of 64·W keys, head, image), W = blockDim / 128 warpgroups
// of 64 keys each: dk and dv over every query step.  K and V of the block come
// once; (q, dO) steps stream through the ring, thread 0 refilling a stage once
// every thread has released it, and each thread reads the lse and D of its
// columns while the step's first products run.  Per step and warpgroup: sᵀ = k·qᵀ
// and dpᵀ = v·dOᵀ (shared operands), p and dsᵀ in registers, dv += T(pᵀ)·dO
// and dk += T(dsᵀ)·q (register A operands, q and dO MN-major).
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(256, Bwd<DK, DV>::kDkvBlocks)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         T* __restrict__ dk, Strides dks, T* __restrict__ dv, Strides dvs,
                         int heads, int n_q, int n_k, float scale) {
  using B = Bwd<DK, DV>;
  using KTile = hopper::Tile<128, B::PK>;
  using VTile = hopper::Tile<128, B::PV>;
  using QTile = hopper::Tile<B::BQ, B::PK>;
  using OTile = hopper::Tile<B::BQ, B::PV>;
  constexpr int S = B::kStages, BQ = B::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = hopper::align1024(smem_raw);
  unsigned char* vs = ks + KTile::kBytes;
  unsigned char* qs = vs + VTile::kBytes;
  unsigned char* os = qs + S * QTile::kBytes;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(os + S * OTile::kBytes);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + S;

  const int wgs = blockDim.x / 128, j0 = blockIdx.x * 64 * wgs, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128, t = tid % 4;
  const int steps = (n_q + BQ - 1) / BQ;
  const long long run0 = ((long long)b * heads + h) * n_q;  // the (image, head)'s lse and D
  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], blockDim.x);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(kv_bar, wgs * 64 * (B::PK + B::PV) * 2);
    for (int w = 0; w < wgs; ++w) {
      KTile::load(ks, 64 * w, &k_map, kv_bar, j0 + 64 * w, h, b);
      VTile::load(vs, 64 * w, &v_map, kv_bar, j0 + 64 * w, h, b);
    }
    for (int i = 0; i < S && i < steps; ++i)
      dkv_load_step<B>(i, qs, os, full, &q_map, &do_map, h, b);
  }

  float dk_acc[B::PK / 2], dv_acc[B::PV / 2];
#pragma unroll
  for (int i = 0; i < B::PK / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < B::PV / 2; ++i) dv_acc[i] = 0.f;
  const float sl2 = scale * kLog2e;
  hopper::mbar_wait(kv_bar, 0);
  for (int i = 0; i < steps; ++i) {
    const int s = i % S;
    const uint32_t phase = (i / S) & 1;
    const unsigned char* q_t = qs + s * QTile::kBytes;
    const unsigned char* o_t = os + s * OTile::kBytes;
    // lse (in log2 units) and D of the thread's columns, 0 past n_q.
    float2 lse2[BQ / 8], dd[BQ / 8];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int qi = i * BQ + 8 * j + 2 * t;
      lse2[j] = make_float2(qi < n_q ? lse[run0 + qi] * kLog2e : 0.f,
                            qi + 1 < n_q ? lse[run0 + qi + 1] * kLog2e : 0.f);
      dd[j] = make_float2(qi < n_q ? dsum[run0 + qi] : 0.f,
                          qi + 1 < n_q ? dsum[run0 + qi + 1] : 0.f);
    }
    hopper::mbar_wait(&full[s], phase);

    float st[BQ / 2], dpt[BQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < B::PK / 16; ++kk)  // sᵀ = k·qᵀ
      hopper::Wgmma<BQ, T>::ss(st, KTile::kmajor(ks, 64 * wg, 16 * kk),
                               QTile::kmajor(q_t, 0, 16 * kk), kk);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < B::PV / 16; ++kk)  // dpᵀ = v·dOᵀ
      hopper::Wgmma<BQ, T>::ss(dpt, VTile::kmajor(vs, 64 * wg, 16 * kk),
                               OTile::kmajor(o_t, 0, 16 * kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(st);
    // p = exp(s·scale - lse) for the step's queries (the columns), 0 past n_q,
    // while dpᵀ is still on the tensor cores.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = i * BQ + 8 * j + 2 * t + (e & 1);
        st[4 * j + e] =
            qi < n_q ? exp2f(st[4 * j + e] * sl2 - ((e & 1) ? lse2[j].y : lse2[j].x)) : 0.f;
      }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) hopper::a_fragment<T>(pa[c], st, c);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c)  // dv += T(pᵀ)·dO
      hopper::Wgmma<B::PV, T>::rs(dv_acc, pa[c], OTile::mnmajor(o_t, 16 * c));
    hopper::wgmma_commit();
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // dsᵀ = p·(dpᵀ - D)·scale
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd[j].y : dd[j].x)) * scale;
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) hopper::a_fragment<T>(da[c], dpt, c);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c)  // dk += T(dsᵀ)·q
      hopper::Wgmma<B::PK, T>::rs(dk_acc, da[c], QTile::mnmajor(q_t, 16 * c));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    hopper::mbar_arrive(&empty[s]);
    if (tid == 0 && i + S < steps) {
      hopper::mbar_wait(&empty[s], phase);
      dkv_load_step<B>(i + S, qs, os, full, &q_map, &do_map, h, b);
    }
  }
  hopper::store_fragment<T, DK>(head_base(dk, dks, b, h), dks.r, j0 + 64 * wg, n_k, dk_acc, lt);
  hopper::store_fragment<T, DV>(head_base(dv, dvs, b, h), dvs.r, j0 + 64 * wg, n_k, dv_acc, lt);
}

// One CTA per (block of 64·W queries, head, image), W = blockDim / 128
// warpgroups of 64 queries each: dq over every key step.  Q and dO of the
// block come once; (k, v) steps stream through the ring.  Per step and
// warpgroup: s = q·kᵀ and dp = dO·vᵀ, p = exp(s·scale - lse) (0 past n_k) and
// ds = p·(dp - D)·scale in registers, dq += T(ds)·k (k MN-major).
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq, Strides dqs,
                        int heads, int n_q, int n_k, float scale) {
  using B = Bwd<DK, DV>;
  using QTile = hopper::Tile<128, B::PK>;
  using OTile = hopper::Tile<128, B::PV>;
  using KTile = hopper::Tile<B::BK, B::PK>;
  using VTile = hopper::Tile<B::BK, B::PV>;
  constexpr int S = B::kStages, BK = B::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align1024(smem_raw);
  unsigned char* os = qs + QTile::kBytes;
  unsigned char* ks = os + OTile::kBytes;
  unsigned char* vs = ks + S * KTile::kBytes;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(vs + S * VTile::kBytes);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + S;

  const int wgs = blockDim.x / 128, i0 = blockIdx.x * 64 * wgs, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128, t = tid % 4;
  const int steps = (n_k + BK - 1) / BK;
  auto load_step = [&](int i) {
    const int s = i % S;
    hopper::mbar_expect_tx(&full[s], KTile::kBytes + VTile::kBytes);
    KTile::load(ks + s * KTile::kBytes, 0, &k_map, &full[s], i * BK, h, b);
    VTile::load(vs + s * VTile::kBytes, 0, &v_map, &full[s], i * BK, h, b);
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
    hopper::mbar_expect_tx(q_bar, wgs * 64 * (B::PK + B::PV) * 2);
    for (int w = 0; w < wgs; ++w) {
      QTile::load(qs, 64 * w, &q_map, q_bar, i0 + 64 * w, h, b);
      OTile::load(os, 64 * w, &do_map, q_bar, i0 + 64 * w, h, b);
    }
    for (int i = 0; i < S && i < steps; ++i) load_step(i);
  }

  // lse (in log2 units) and D of the thread's rows g and g + 8 (0 past n_q: not stored).
  float lse2[2], dd[2];
  const int row = i0 + 64 * wg + (lt / 32) * 16 + (lt % 32) / 4;
  const long long run0 = ((long long)b * heads + h) * n_q;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < n_q;
    lse2[r] = in ? lse[run0 + row + 8 * r] * kLog2e : 0.f;
    dd[r] = in ? dsum[run0 + row + 8 * r] : 0.f;
  }
  float dq_acc[B::PK / 2];
#pragma unroll
  for (int i = 0; i < B::PK / 2; ++i) dq_acc[i] = 0.f;
  const float sl2 = scale * kLog2e;
  hopper::mbar_wait(q_bar, 0);
  for (int i = 0; i < steps; ++i) {
    const int s = i % S;
    const uint32_t phase = (i / S) & 1;
    const unsigned char* k_t = ks + s * KTile::kBytes;
    const unsigned char* v_t = vs + s * VTile::kBytes;
    hopper::mbar_wait(&full[s], phase);

    float sc[BK / 2], dp[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < B::PK / 16; ++kk)  // s = q·kᵀ
      hopper::Wgmma<BK, T>::ss(sc, QTile::kmajor(qs, 64 * wg, 16 * kk),
                               KTile::kmajor(k_t, 0, 16 * kk), kk);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < B::PV / 16; ++kk)  // dp = dO·vᵀ
      hopper::Wgmma<BK, T>::ss(dp, OTile::kmajor(os, 64 * wg, 16 * kk),
                               VTile::kmajor(v_t, 0, 16 * kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = i * BK + 8 * j + 2 * t + (e & 1);
        sc[4 * j + e] = key < n_k ? exp2f(sc[4 * j + e] * sl2 - lse2[e / 2]) : 0.f;
      }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // ds = p·(dp - D)·scale
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dd[e / 2]) * scale;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) hopper::a_fragment<T>(da[c], dp, c);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)  // dq += T(ds)·k
      hopper::Wgmma<B::PK, T>::rs(dq_acc, da[c], KTile::mnmajor(k_t, 16 * c));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq_acc);
    hopper::fence_regs(da);
    hopper::mbar_arrive(&empty[s]);
    if (tid == 0 && i + S < steps) {
      hopper::mbar_wait(&empty[s], phase);
      load_step(i + S);
    }
  }
  hopper::store_fragment<T, DK>(head_base(dq, dqs, b, h), dqs.r, i0 + 64 * wg, n_q, dq_acc, lt);
}

// Strides of operand i from the wrapper's flat (b, h, row) triples.
Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int DK, int DV>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* out, float* lse,
                  const long long* st, int b, int heads, int n_q, int n_k, float scale,
                  cudaStream_t stream) {
  using F = Fwd<DK, DV>;
  constexpr int dt = hopper::dtype_of<T>();
  constexpr int kc = hopper::Tile<64, F::PK>::kChunk, vc = hopper::Tile<64, F::PV>::kChunk;
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, flash_fwd_kernel<T, DK, DV>, F::smem());
  CUtensorMap q_map, k_map, v_map;
  if (err == cudaSuccess) err = head_map(&q_map, q, dt, DK, n_q, heads, b, st, kc, 64);
  if (err == cudaSuccess) err = head_map(&k_map, k, dt, DK, n_k, heads, b, st + 3, kc, F::BK);
  if (err == cudaSuccess) err = head_map(&v_map, v, dt, DV, n_k, heads, b, st + 6, vc, F::BK);
  if (err != cudaSuccess) return err;
  // One key tile (SSA's 64 keys): CTAs of one warpgroup and a one-stage ring, so that more
  // of them share an SM; K/V then comes once per 64 queries, from L2.
  const int tiles = (n_k + F::BK - 1) / F::BK;
  const int wgs = n_q > 64 && tiles > 1 ? 2 : 1;
  flash_fwd_kernel<T, DK, DV><<<dim3((n_q + 64 * wgs - 1) / (64 * wgs), heads, b), 128 * wgs,
                                F::smem(tiles < F::kStages ? tiles : F::kStages), stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), strides_at(st, 3), lse, heads, n_q, n_k, scale);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t bwd_t(const void* q, const void* k, const void* v, const void* out,
                  const float* lse, const void* dout, void* dq, void* dk, void* dv, float* dsum,
                  const long long* st, int b, int heads, int n_q, int n_k, float scale,
                  cudaStream_t stream) {
  using B = Bwd<DK, DV>;
  constexpr int dt = hopper::dtype_of<T>();
  constexpr int kc = hopper::Tile<64, B::PK>::kChunk, vc = hopper::Tile<64, B::PV>::kChunk;
  thread_local int dq_ready = -1, dkv_ready = -1;
  cudaError_t err = prepare_kernel(dq_ready, flash_bwd_dq_kernel<T, DK, DV>, B::dq_smem());
  if (err == cudaSuccess)
    err = prepare_kernel(dkv_ready, flash_bwd_dkv_kernel<T, DK, DV>, B::dkv_smem());
  if (err != cudaSuccess) return err;
  const Strides os = strides_at(st, 3), dos = strides_at(st, 4);
  // K and V in 64-row boxes: the dq kernel's steps, the dk/dv kernel's warpgroups.
  CUtensorMap k_map, v_map, q_map{}, do_map{};
  err = head_map(&k_map, k, dt, DK, n_k, heads, b, st + 3, kc, 64);
  if (err == cudaSuccess) err = head_map(&v_map, v, dt, DV, n_k, heads, b, st + 6, vc, 64);
  if (err != cudaSuccess) return err;
  if (n_q > 0) {  // without queries, dq is empty and dk, dv are zeros (the maps stay unread)
    const long long rows = (long long)b * heads * n_q;
    const int rows_per_cta = kThreads / 32;
    flash_bwd_dsum_kernel<T><<<(unsigned)((rows + rows_per_cta - 1) / rows_per_cta), kThreads,
                               0, stream>>>(static_cast<const T*>(out), os,
                                            static_cast<const T*>(dout), dos, dsum, heads, n_q,
                                            DV, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = head_map(&q_map, q, dt, DK, n_q, heads, b, st, kc, 64);
    if (err == cudaSuccess) err = head_map(&do_map, dout, dt, DV, n_q, heads, b, st + 12, vc, 64);
    if (err != cudaSuccess) return err;
    const int wgs = n_q > 64 ? 2 : 1;
    flash_bwd_dq_kernel<T, DK, DV><<<dim3((n_q + 64 * wgs - 1) / (64 * wgs), heads, b),
                                         128 * wgs, B::dq_smem(), stream>>>(
        q_map, k_map, v_map, do_map, lse, dsum, static_cast<T*>(dq), strides_at(st, 5), heads,
        n_q, n_k, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // The dk/dv kernel's query steps: BQ-row boxes of q and dO.
    err = head_map(&q_map, q, dt, DK, n_q, heads, b, st, kc, B::BQ);
    if (err == cudaSuccess)
      err = head_map(&do_map, dout, dt, DV, n_q, heads, b, st + 12, vc, B::BQ);
    if (err != cudaSuccess) return err;
  }
  const int wgs = n_k > 64 ? 2 : 1;
  flash_bwd_dkv_kernel<T, DK, DV><<<dim3((n_k + 64 * wgs - 1) / (64 * wgs), heads, b),
                                              128 * wgs, B::dkv_smem(), stream>>>(
      q_map, k_map, v_map, do_map, lse, dsum, static_cast<T*>(dk), strides_at(st, 6),
      static_cast<T*>(dv), strides_at(st, 7), heads, n_q, n_k, scale);
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
