// Hopper port of the TPU fused cross-attention block, forward and backward:
//   y = x + (softmax((xn·Wqᵀ)·kᵀ·scale)·v)·Woᵀ + bo,   k, v precomputed
// Replaces vit_tpu/ops/fused_cross_attention.py::fused_cross_attention_block
// (:297): the forward (_forward :188 / _fwd_kernel :71) and the backward
// (_backward :243 / _bwd_kernel :115).  ScalableViT's SSA and Twins-SVT's
// global attention have this shape: the queries come from a tokenwise GEMM of
// the normalised stream xn, the keys and values from a strided convolution of
// it that no tokenwise kernel can hold, so k and v arrive precomputed, with
// their own head widths (dh_k 40 and dh_v 32 at ScalableViT's stages 1-3).
//
// Forward (cross_fwd, one kernel): one CTA per (image, 64 or 128 query rows),
// a warpgroup per 64 rows.  TMA brings the CTA's xn tile once, then head by
// head, through a 2-stage ring on mbarriers, the head's rows of Wq (dh_k x c,
// zeros past dh_k to the swizzled width) and the image's k_h and v_h (n_k <=
// 128 keys, one tile, zeros past n_k); a second ring brings 64 x 64 boxes of
// Wo.  Per head, per warpgroup, all in registers:
//   q_h = xn·Wq_hᵀ on wgmma (shared operands), rounded to the compute dtype;
//   s = q_h·k_hᵀ with q_h as wgmma's register A operand (k K-major), scaled in
//     f32, keys past n_k -inf; the exact softmax over the one key tile (row
//     max, e = exp(s - m), f32 row sum l: one exp a score);
//   o_h = T(e)·v_h with T(e) as register A (v MN-major), then o_h / l rounded:
//     the TPU kernel's rounding points (:98-104: q rounded, logits f32, the
//     unnormalised probabilities rounded for P·V, the row sum divided after);
//   oattn_h goes to a shared (rows, heads·dh_v) tile, never to device memory
//     when serving.
// After the last head, y = oattn·Woᵀ on wgmma over the shared oattn tile and
// the Wo boxes, 64 output columns at a time, K = heads·dh_v: the TPU's own
// f32 sum over the heads' columns, with its epilogue y = T(x + T(acc + bo)).
// The training forward also writes q (rows, heads·dh_k), oattn (rows,
// heads·dh_v) and lse (b, heads, n) f32 in the layouts the backward's flash
// kernels read; serving writes none of them.  Bound on the H100, ScalableViT
// stage 1 at batch 64 (262,144 rows, c 64, 2 heads, n_k 64, dh_k 40, dh_v
// 32): about 9.7 GFLOP (0.010 ms at 989 TFLOP/s) against 101 MB of x, xn and
// y (0.030 ms at 3.35 TB/s): the bytes bound it, and the kernel reads x and xn
// and writes y once, k, v and the weights from L2.
//
// The shape split, decided in C before launch (cross_mode): cross_fwd takes
// (dh_k, dh_v) ∈ {(32, 32), (40, 32), (64, 64)} at n_k <= 128, every
// ScalableViT SSA shape at 256 px.
//   - c < 256 (stages 1 and 2): the whole block in the one kernel.
//   - c >= 256 (stages 3 and 4): cross_fwd writes oattn (and no y), its heads
//     spread over up to four CTAs a row block, and launch_forward_gemm
//     (gemm_wgmma, n = c >= 256) finishes y with the bias + residual
//     epilogue, the same rounding.  There the row blocks are few (256 and 64
//     CTAs at batch 64) and each would take every head and a c x heads·dh_v
//     Wo through its shared memory in turn: the fused form measured 0.1020
//     and 0.1051 ms against the earlier three launches' 0.0985 and 0.0669
//     on an H100 80GB HBM3 at 700 W (vit_tpu_torch/ab_smoke.py, PERF.md).
// Other shapes (n_k > 128, wider heads) take the three launches of the
// earlier design: linear.cu's q GEMM, the (dh_k, dh_v) flash forward over q,
// k, v channel-packed through their strides, linear.cu's output GEMM with the
// bias + residual epilogue, q and oattn through device memory.
//
// Backward (cross_bwd, route 1 up to 128 channels): one CTA of one
// warpgroup per (image, span of 64-row query blocks), the spans sized in C
// (cross_bwd_plan) so the CTAs fill the card: at ScalableViT stage 1, batch
// 64, 4 spans of 1024 rows, 256 CTAs at two an SM, where the four-step
// backward's dk/dv pass had b·heads = 128 CTAs each walking 4096 queries
// (under one wave on 132 SMs).  Heads are the outer loop, so a head's f32
// dk_h and dv_h stay in registers across the span; per head, the head's k_h,
// v_h and Wo_h columns (dh_v of them, c rows) arrive once by TMA, then per
// block, through a ring of up to 4 stages on mbarriers, the dy block and q_h:
//   doattn_h = T(dy·Wo_h) on wgmma (Wo_h MN-major), into shared memory only;
//   s = q_h·k_hᵀ, p = softmax(s·scale) over the row from its own max and sum,
//     as the TPU kernel recomputes it (the keys fit one tile, n_k <= 128; one
//     key gives p = 1 exactly), dp = doattn_h·v_hᵀ with doattn_h as register A,
//     and the TPU kernel's own dsum = Σ p·dp (:150: the whole row of p and dp
//     is in registers), not D = rowsum(dO∘O) from a stored output, which
//     this route never reads;
//   ds = T(p·(dp - dsum)·scale); dq_h = T(ds·k_h) with ds as register A,
//     stored (the dWq GEMM outside reads dq);
//   T(p) and T(ds) go to shared tiles, and dk_h += T(ds)ᵀ·q_h, dv_h +=
//     T(p)ᵀ·doattn_h run on wgmma with both operands MN-major (ss_tt).
// After the heads, per block, dxn = T(dq·Wq) over K = heads·dh_k (the TPU's
// :178-180), the span's dq blocks read back by TMA through a ring in the
// memory the head loop used, beside Wq; the dy blocks' f32 column sums (dbo)
// are taken during the first head.  Each CTA writes its f32 dk, dv and dbo
// partials to one scratch buffer (dk and dv rounded directly where one span
// takes the image); cross_bwd_reduce sums them over the spans in a fixed
// order and rounds dk and dv once: no atomics, the same bits every run.  The
// rounding points are the TPU kernel's (:138-180).
// From 129 channels (ScalableViT stages 3-4, c 256 and 512) one kernel would
// hold c / 2 f32 of dxn a thread and a Wq of up to 160 KB beside the ring,
// and past heads·dh_k 256 (Twins-SVT's global attention, 8 heads of 64 at
// every c from 64) dxn's dq blocks and Wq would not fit beside each other:
// there cross_bwd runs over head groups with doattn read by TMA and no dxn
// (route 2), between launch_dgrad's dy·Wo (n = heads·dh_v) and dq·Wq (n = c),
// gemm_wgmma from n 256 (linear.cu below), and fixed-order column sums of dy
// for dbo.  Past n_k 128 (ScalableViT at 384 px, no main path) the four steps
// of the earlier design stay (route 0): linear.cu's dy·Wo, the (dh_k, dh_v)
// flash backward (p from the forward's lse, D from the stored oattn),
// linear.cu's dq·Wq, column sums.  The weight gradients dWq = dqᵀ·xn and
// dWo = dyᵀ·oattn stay plain GEMMs outside, as the TPU left them to XLA
// (:330-338).
// Bound on the H100 at stage 1, batch 64: about 188 MB of dy, q, oattn and
// lse in and dxn and dq out (chip_smoke.py's cross_bounds, which counts
// oattn and lse though this route reads neither), 0.056 ms at 3.35 TB/s,
// against about 17 GFLOP (0.017 ms): the bytes bound it.  The kernel moves
// about 230 MB (dy a second time for the second head, dq back for dxn), its loop waits
// on wgmma and on TMA in turn with one warpgroup a CTA, and dxn's pass reads
// in a window of its own after the heads (PERF.md has the card's times).
// ptxas (sm_90a, bf16; f16 the same; chip_smoke.py's ptxas line): (40, 32)
// and 64 keys 211 registers, no spill; (32, 32) 185; (64, 64) 241; the
// 128-key instances (no ScalableViT shape at 256 px) 255 with 152-1044
// bytes spilled.
#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace vit {
namespace {

constexpr int kHeadStages = 2;  // the per-head ring (Wq_h, k_h, v_h)
constexpr int kWoStages = 2;    // the ring of 64 x 64 Wo boxes
constexpr int kWoBox = 64 * 64 * 2;
constexpr int kMaxSmem = 232448;

// (batch, head, row) element strides of a token-major (b, n, heads·d) map.
void packed_strides(long long* s, long long n, long long heads, long long d) {
  s[0] = n * heads * d;
  s[1] = d;
  s[2] = heads * d;
}

__host__ __device__ constexpr int round64(int v) { return (v + 63) / 64 * 64; }

// The shapes of a (DK, DV) instance: q/k and v widths padded to swizzled
// tiles (40 -> 64), q·kᵀ in k16 steps over DK padded to 16 only (40 -> 48:
// the steps past it would multiply zeros), NK keys in the one key tile.
template <int DK, int DV, int NK>
struct Cross {
  static constexpr int PK = hopper::swizzled_width(DK), PV = hopper::swizzled_width(DV);
  static constexpr int kSteps = pad16(DK) / 16;
  using KTile = hopper::Tile<NK, PK>;
  using VTile = hopper::Tile<NK, PV>;
  // One ring stage: Wq_h as cw / 64 chunks of PK rows, k_h, v_h.
  __host__ __device__ static constexpr int stage_bytes(int cw) {
    return (cw / 64) * PK * 128 + KTile::kBytes + VTile::kBytes;
  }
  // The xn tile, the head ring, the oattn tile and the Wo ring (both only
  // where the kernel computes y: hvp > 0), the barriers (xn; full and empty
  // per stage of each ring), alignment.
  __host__ __device__ static constexpr int smem(int rows, int cw, int hvp) {
    return rows * cw * 2 + kHeadStages * stage_bytes(cw) + rows * hvp * 2 +
           (hvp ? kWoStages * kWoBox : 0) + (1 + 2 * kHeadStages + 2 * kWoStages) * 8 + 1024;
  }
};

// The descriptor of rows r0.., K columns k0..k0+15 of a K-major shared tile of
// `rows` rows laid out as 64-column chunks (128-byte swizzle) one after another.
__device__ __forceinline__ uint64_t chunked_kmajor(const unsigned char* tile, int rows, int r0,
                                                   int k0) {
  return hopper::smem_desc(tile + (k0 / 64) * rows * 128 + r0 * 128 + (k0 % 64) * 2, 16, 1024,
                           128);
}

// One CTA per (block of 64·W query rows, image, group of gridDim.z's heads),
// W = blockDim / 128 warpgroups; the head loop and y GEMM as the top of the
// file says.  A null y: no y GEMM (the split of c >= 256), oattn to o_out.
// Thread 0 issues every TMA load and refills a ring stage once every thread
// has released it.  q_out, o_out and lse are null when serving a whole
// block.  Up to 64 + 32 wide at 64 keys a thread's registers stay under 128,
// so two CTAs share an SM where their shared memory allows it.
template <typename T, int DK, int DV, int NK>
__global__ void __launch_bounds__(256, NK == 64 && hopper::swizzled_width(DK) +
                                                       hopper::swizzled_width(DV) <= 96 ? 2 : 1)
    cross_fwd_kernel(const __grid_constant__ CUtensorMap xn_map,
                     const __grid_constant__ CUtensorMap wq_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap wo_map, const T* __restrict__ x,
                     const T* __restrict__ bo, T* __restrict__ y, T* __restrict__ q_out,
                     T* __restrict__ o_out, float* __restrict__ lse, int n, int n_k, int c,
                     int heads, float scale) {
  using C = Cross<DK, DV, NK>;
  using KTile = typename C::KTile;
  using VTile = typename C::VTile;
  constexpr int PK = C::PK, PV = C::PV;
  const int wgs = blockDim.x / 128, rows = 64 * wgs;
  const int cw = round64(c), hk = heads * DK, hv = heads * DV, hvp = y ? round64(hv) : 0;
  const int stage = C::stage_bytes(cw);
  const int hh = heads / gridDim.z, h0 = blockIdx.z * hh;  // this CTA's heads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = hopper::align1024(smem_raw);
  unsigned char* ring = xs + rows * cw * 2;
  unsigned char* os = ring + kHeadStages * stage;  // oattn, (rows, hvp)
  unsigned char* wos = os + rows * hvp * 2;
  uint64_t* xn_bar = reinterpret_cast<uint64_t*>(wos + (y ? kWoStages * kWoBox : 0));
  uint64_t* full = xn_bar + 1;
  uint64_t* empty = full + kHeadStages;
  uint64_t* wo_full = empty + kHeadStages;
  uint64_t* wo_empty = wo_full + kWoStages;

  const int q0 = blockIdx.x * rows, b = blockIdx.y;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128, t = tid % 4;
  const int wo_items = y ? (c + 63) / 64 * (hvp / 64) : 0;
  auto load_head = [&](int h) {  // head h0 + h
    const int s = h % kHeadStages;
    unsigned char* st = ring + s * stage;
    hopper::mbar_expect_tx(&full[s], stage);
    for (int cb = 0; cb < cw / 64; ++cb)
      hopper::tma_load_head(st + cb * PK * 128, &wq_map, &full[s], 64 * cb, 0, h0 + h, 0);
    KTile::load(st + (cw / 64) * PK * 128, 0, &k_map, &full[s], 0, h0 + h, b);
    VTile::load(st + (cw / 64) * PK * 128 + KTile::kBytes, 0, &v_map, &full[s], 0, h0 + h, b);
  };
  auto load_wo = [&](int i) {  // box i: output columns 64·(i / kb), K columns 64·(i % kb)
    const int s = i % kWoStages, kb = hvp / 64;
    hopper::mbar_expect_tx(&wo_full[s], kWoBox);
    hopper::tma_load_head(wos + s * kWoBox, &wo_map, &wo_full[s], 64 * (i % kb), 64 * (i / kb), 0,
                          0);
  };
  if (tid == 0) {
    hopper::mbar_init(xn_bar, 1);
    for (int s = 0; s < kHeadStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], blockDim.x);
    }
    for (int s = 0; s < kWoStages; ++s) {
      hopper::mbar_init(&wo_full[s], 1);
      hopper::mbar_init(&wo_empty[s], blockDim.x);
    }
    hopper::mbar_init_fence();
  }
  // oattn's columns past heads·dh_v are K padding of the y GEMM: zeros.
  for (int i = tid; i < rows * (hvp - hv) / 8; i += blockDim.x) {
    const int r = i / ((hvp - hv) / 8), col = hv + 8 * (i % ((hvp - hv) / 8));
    const int off = (col / 64) * rows * 128 + r * 128 + (col % 64) * 2;
    *reinterpret_cast<uint4*>(os + (off ^ ((r & 7) << 4))) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(xn_bar, rows * cw * 2);
    for (int cb = 0; cb < cw / 64; ++cb)
      hopper::tma_load_head(xs + cb * rows * 128, &xn_map, xn_bar, 64 * cb, q0, 0, b);
    for (int h = 0; h < kHeadStages && h < hh; ++h) load_head(h);
    for (int i = 0; i < kWoStages && i < wo_items; ++i) load_wo(i);
  }

  const int fr = (lt / 32) * 16 + (lt % 32) / 4;  // the thread's first fragment row
  const int row = q0 + 64 * wg + fr;              // and its token (+ 8 for the second)
  hopper::mbar_wait(xn_bar, 0);
  for (int i = 0; i < hh; ++i) {
    const int s = i % kHeadStages, h = h0 + i;
    const unsigned char* wq_t = ring + s * stage;
    const unsigned char* k_t = wq_t + (cw / 64) * PK * 128;
    const unsigned char* v_t = k_t + KTile::kBytes;
    hopper::mbar_wait(&full[s], (i / kHeadStages) & 1);

    // q_h = xn·Wq_hᵀ (64 x PK), rounded as the A operand of s = q_h·k_hᵀ; K in
    // 64-column chunks (the zeros past c add nothing).
    float qa[PK / 2];
    for (int cb = 0; cb < cw / 64; ++cb) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<PK, T>::ss(qa, chunked_kmajor(xs, rows, 64 * wg, 64 * cb + 16 * kk),
                                 chunked_kmajor(wq_t, PK, 0, 64 * cb + 16 * kk), cb + kk);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(qa);
    uint32_t qf[C::kSteps][4];
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) hopper::a_fragment<T>(qf[kk], qa, kk);
    if (q_out)
      hopper::store_fragment<T, PK>(q_out + (size_t)b * n * hk + h * DK, hk, q0 + 64 * wg, n, qa,
                                    lt, DK);

    // s = q_h·k_hᵀ·scale, keys past n_k -inf.
    float sc[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk)
      hopper::Wgmma<NK, T>::rs_k(sc, qf[kk], KTile::kmajor(k_t, 0, 16 * kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(qf);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        sc[4 * j + e] = key < n_k ? sc[4 * j + e] * scale : -INFINITY;
        m[e / 2] = fmaxf(m[e / 2], sc[4 * j + e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the row max over the quad (every row holds a key)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = expf(sc[4 * j + e] - m[e / 2]);
        l[e / 2] += sc[4 * j + e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);

    // o_h = T(e)·v_h (keys past n_k: e = 0 and zero rows of v), then / l.
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int cc = 0; cc < NK / 16; ++cc) hopper::a_fragment<T>(pa[cc], sc, cc);
    float o[PV / 2];
#pragma unroll
    for (int i = 0; i < PV / 2; ++i) o[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < NK / 16; ++cc)
      hopper::Wgmma<PV, T>::rs(o, pa[cc], VTile::mnmajor(v_t, 16 * cc));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    hopper::mbar_arrive(&empty[s]);  // this thread is done with the stage
    if (tid == 0 && i + kHeadStages < hh) {
      hopper::mbar_wait(&empty[s], (i / kHeadStages) & 1);
      load_head(i + kHeadStages);
    }
#pragma unroll
    for (int j = 0; j < PV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] = o[4 * j + e] / l[e / 2];

    // oattn_h: into the shared tile (the y GEMM's A operand) and, in training
    // or without the y GEMM, to device memory; lse in training.
    if (y)
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 64 * wg + fr + 8 * half, col = h * DV + 8 * j + 2 * t;
          const int off = (col / 64) * rows * 128 + r * 128 + (col % 64) * 2;
          *reinterpret_cast<uint32_t*>(os + (off ^ ((r & 7) << 4))) =
              Num<T>::pack2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
        }
    if (o_out)
      hopper::store_fragment<T, PV>(o_out + (size_t)b * n * hv + h * DV, hv, q0 + 64 * wg, n, o,
                                    lt, DV);
    if (lse && t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < n)
          lse[((size_t)b * heads + h) * n + row + 8 * r] = m[r] + logf(l[r]);
  }
  if (!y) return;
  hopper::fence_proxy_async();  // oattn, stored by the threads, is read by wgmma
  __syncthreads();

  // y = T(x + T(oattn·Woᵀ + bo)), 64 output columns at a time.
  const int kb = hvp / 64;
  for (int nc = 0; nc < (c + 63) / 64; ++nc) {
    float acc[32];
    for (int kc = 0; kc < kb; ++kc) {
      const int i = nc * kb + kc, s = i % kWoStages;
      const unsigned char* wo_t = wos + s * kWoBox;
      hopper::mbar_wait(&wo_full[s], (i / kWoStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<64, T>::ss(acc, chunked_kmajor(os, rows, 64 * wg, 64 * kc + 16 * kk),
                                 hopper::Tile<64, 64>::kmajor(wo_t, 0, 16 * kk), kc + kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&wo_empty[s]);
      if (tid == 0 && i + kWoStages < wo_items) {
        hopper::mbar_wait(&wo_empty[s], (i / kWoStages) & 1);
        load_wo(i + kWoStages);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= n) continue;
      const size_t at = ((size_t)b * n + r) * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nc + 8 * j + 2 * t;
        if (col >= c) continue;
        const T* xr = x + at + col;
        const float y0 = Num<T>::round(acc[4 * j + 2 * half] + Num<T>::to_f(bo[col]));
        const float y1 = Num<T>::round(acc[4 * j + 2 * half + 1] + Num<T>::to_f(bo[col + 1]));
        *reinterpret_cast<uint32_t*>(y + at + col) =
            Num<T>::pack2(Num<T>::to_f(xr[0]) + y0, Num<T>::to_f(xr[1]) + y1);
      }
    }
  }
}

// From this width on, cross_fwd leaves y to launch_forward_gemm (the split
// at the top of the file): gemm_wgmma's first width.
constexpr int kSplitC = 256;

// Warpgroups of a cross_fwd CTA at these widths: two (128 rows) where the
// image has more than 64 rows and two CTAs of them still share an SM, else
// one; 0 where one 64-row CTA's shared memory does not fit (the shape goes to
// the three-launch forward).
template <int DK, int DV, int NK>
int cross_wgs(int n, int c, int hv) {
  using C = Cross<DK, DV, NK>;
  const int cw = round64(c), hvp = c < kSplitC ? round64(hv) : 0;
  if (n > 64 && 2 * C::smem(128, cw, hvp) <= kMaxSmem) return 2;
  return C::smem(64, cw, hvp) <= kMaxSmem ? 1 : 0;
}

// Heads a cross_fwd CTA takes: all of them with the y GEMM; in the split, at
// most four (halving while even), so a row block's heads spread over CTAs.
int cross_heads_per_cta(int c, int heads) {
  int hh = heads;
  while (c >= kSplitC && hh > 4 && hh % 2 == 0) hh /= 2;
  return hh;
}

template <typename T, int DK, int DV, int NK>
cudaError_t cross_fwd_t(const void* x, const void* xn, const void* wq, const void* k,
                        const void* v, const void* wo, const void* bo, void* y, void* q,
                        void* oattn, float* lse, int b, int n, int n_k, int c, int heads,
                        float scale, cudaStream_t stream) {
  using C = Cross<DK, DV, NK>;
  constexpr int dt = hopper::dtype_of<T>();
  const int hv = heads * DV, wgs = cross_wgs<DK, DV, NK>(n, c, hv);
  const bool split = c >= kSplitC;
  if (wgs == 0 || (split && !oattn)) return cudaErrorInvalidValue;
  const int bytes = C::smem(64 * wgs, round64(c), split ? 0 : round64(hv));
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, cross_fwd_kernel<T, DK, DV, NK>, kMaxSmem);
  const long long xn_st[3] = {(long long)n * c, 8, c};
  const long long wq_st[3] = {8, (long long)DK * c, c};
  long long kv_st[6];
  packed_strides(kv_st, n_k, heads, DK);
  packed_strides(kv_st + 3, n_k, heads, DV);
  CUtensorMap xn_map, wq_map, k_map, v_map, wo_map;
  if (err == cudaSuccess) err = head_map(&xn_map, xn, dt, c, n, 1, b, xn_st, 64, 64 * wgs);
  if (err == cudaSuccess) err = head_map(&wq_map, wq, dt, c, DK, heads, 1, wq_st, 64, C::PK);
  if (err == cudaSuccess)
    err = head_map(&k_map, k, dt, DK, n_k, heads, b, kv_st, C::KTile::kChunk, NK);
  if (err == cudaSuccess)
    err = head_map(&v_map, v, dt, DV, n_k, heads, b, kv_st + 3, C::VTile::kChunk, NK);
  if (err == cudaSuccess) err = matrix_map(&wo_map, wo, dt, hv, c, hv, 64, 64);
  if (err != cudaSuccess) return err;
  dim3 grid((n + 64 * wgs - 1) / (64 * wgs), b, heads / cross_heads_per_cta(c, heads));
  cross_fwd_kernel<T, DK, DV, NK><<<grid, 128 * wgs, bytes, stream>>>(
      xn_map, wq_map, k_map, v_map, wo_map, static_cast<const T*>(x), static_cast<const T*>(bo),
      split ? nullptr : static_cast<T*>(y), static_cast<T*>(q), static_cast<T*>(oattn), lse, n,
      n_k, c, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return launch_forward_gemm(oattn, wo, bo, x, y, nullptr, b * n, c, hv, kEpiBiasResidual,
                             hopper::dtype_of<T>(), stream);
}

// The (dh_k, dh_v) instances of cross_fwd, at NK 64 or 128 keys: X(DK, DV).
#define VIT_CROSS_WIDTHS(X) X(32, 32) X(40, 32) X(64, 64)

// The forward's route at a shape (the split at the top of the file): 1, the
// one cross_fwd kernel; 2, cross_fwd writing oattn and launch_forward_gemm
// taking y (c >= 256); 0, the three launches.
int cross_mode(int b, int n, int n_k, int c, int heads, int dh_k, int dh_v) {
  if (b < 1 || b > 65535 || n < 1 || n_k < 1 || n_k > 128 || c % 8 || c < 8 || heads < 1)
    return 0;
  const int hv = heads * dh_v, fused = c < kSplitC ? 1 : 2;
#define VIT_CROSS_TAKES(DK, DV)                                                                 \
  if (dh_k == DK && dh_v == DV)                                                                 \
    return (n_k <= 64 ? cross_wgs<DK, DV, 64>(n, c, hv) : cross_wgs<DK, DV, 128>(n, c, hv)) > 0 \
               ? fused                                                                          \
               : 0;
  VIT_CROSS_WIDTHS(VIT_CROSS_TAKES)
#undef VIT_CROSS_TAKES
  return 0;
}

template <typename T>
cudaError_t cross_fwd_dispatch(const void* x, const void* xn, const void* wq, const void* k,
                               const void* v, const void* wo, const void* bo, void* y, void* q,
                               void* oattn, float* lse, int b, int n, int n_k, int c, int heads,
                               int dh_k, int dh_v, float scale, cudaStream_t stream) {
#define VIT_CROSS_FWD(DK, DV)                                                                  \
  if (dh_k == DK && dh_v == DV)                                                                \
    return n_k <= 64 ? cross_fwd_t<T, DK, DV, 64>(x, xn, wq, k, v, wo, bo, y, q, oattn, lse, b, \
                                                  n, n_k, c, heads, scale, stream)             \
                     : cross_fwd_t<T, DK, DV, 128>(x, xn, wq, k, v, wo, bo, y, q, oattn, lse,  \
                                                   b, n, n_k, c, heads, scale, stream);
  VIT_CROSS_WIDTHS(VIT_CROSS_FWD)
#undef VIT_CROSS_FWD
  return cudaErrorInvalidValue;
}

// ---- backward: cross_bwd ------------------------------------------------------------------

constexpr int kBwdMaxStages = 4;       // the deepest ring of items (one head over one 64-row block)
constexpr int kBwdFusedMaxC = 128;     // widest c whose dxn (c / 2 f32 a thread) cross_bwd keeps
constexpr int kBwdMaxHk = 256;         // dxn's K = heads·dh_k (its dq blocks, 64 x 256 at most)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemPerSM = 233472;     // an SM's shared memory (228 KB)
constexpr int kBwdMaxCtasPerSM = 2;    // 128 threads at up to 255 registers: two CTAs an SM

// The tiles of a (DK, DV, NK) instance over 64-row blocks: q_h and doattn_h
// (64 rows), T(p) and T(ds) (64 rows of NK keys), k_h and v_h (NK keys), and,
// where cross_bwd takes the dgrads (cw > 0), the dy block (64 x cw) and Wo_h
// (cw rows of the head's dh_v columns).  The ring holds what TMA brings per
// item (the dy block and q_h; q_h and doattn_h in the split); doattn_h, when
// the threads write it, and T(p), T(ds) live once, outside the ring: they are
// written and read within an item.
template <int DK, int DV, int NK>
struct CrossBwd {
  static constexpr int PK = hopper::swizzled_width(DK), PV = hopper::swizzled_width(DV);
  static constexpr int kSteps = pad16(DK) / 16;
  using QTile = hopper::Tile<64, PK>;
  using DTile = hopper::Tile<64, PV>;
  using PTile = hopper::Tile<64, NK>;
  using KTile = hopper::Tile<NK, PK>;
  using VTile = hopper::Tile<NK, PV>;
  __host__ __device__ static constexpr int head_bytes(int cw) {
    return KTile::kBytes + VTile::kBytes + cw * PV * 2;
  }
  __host__ __device__ static constexpr int item_bytes(int cw) {
    return cw ? 64 * cw * 2 + QTile::kBytes : QTile::kBytes + DTile::kBytes;
  }
  __host__ __device__ static constexpr int single_bytes(int cw) {
    return (cw ? DTile::kBytes : 0) + 2 * PTile::kBytes;
  }
  // After the head loop Wq (round64(hk) rows of cw) and a ring of dq blocks
  // (64 rows of round64(hk)) take the place of everything: at least one.
  __host__ __device__ static constexpr int region(int cw, int hk, int stages) {
    return head_bytes(cw) + single_bytes(cw) + stages * item_bytes(cw) >
                   (cw ? round64(hk) * (cw + 64) * 2 : 0)
               ? head_bytes(cw) + single_bytes(cw) + stages * item_bytes(cw)
               : round64(hk) * (cw + 64) * 2;
  }
  __host__ __device__ static constexpr int smem(int cw, int hk, int stages) {
    return region(cw, hk, stages) + (2 + 2 * kBwdMaxStages) * 8 + 1024;
  }
};

// One CTA (128 threads, one warpgroup) per (span of 64-row query blocks,
// image, group of gridDim.z's heads): the top of the file says what it
// computes.  With a null dxn it reads doattn by TMA and leaves dxn and dbo to
// the caller (the split from c > 128).  With one span (gridDim.x 1) it writes
// dk and dv rounded, else f32 partials.  Thread 0 issues every TMA load; a
// ring stage is refilled after the __syncthreads that ends its item, `stages`
// - 1 items ahead.  After the heads, dxn's ring brings back the span's dq
// blocks by TMA (the threads' stores made visible to it first).
template <typename T, int DK, int DV, int NK>
__global__ void __launch_bounds__(128, kBwdMaxCtasPerSM)
    cross_bwd_kernel(const __grid_constant__ CUtensorMap dy_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap wo_map,
                     const __grid_constant__ CUtensorMap wq_map,
                     const __grid_constant__ CUtensorMap dq_map, T* __restrict__ dq,
                     T* __restrict__ dxn, T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ part, int n, int n_k, int c,
                     int heads, int bps, int stages, float scale) {
  using C = CrossBwd<DK, DV, NK>;
  using QTile = typename C::QTile;
  using DTile = typename C::DTile;
  using PTile = typename C::PTile;
  using KTile = typename C::KTile;
  using VTile = typename C::VTile;
  constexpr int PK = C::PK, PV = C::PV;
  const bool fused = dxn != nullptr, one_span = gridDim.x == 1;
  const int cw = fused ? round64(c) : 0, hk = heads * DK, hv = heads * DV;
  const int nb = (n + 63) / 64, j0 = blockIdx.x * bps, nbs = min(nb, j0 + bps) - j0;
  const int b = blockIdx.y, images = gridDim.y, span = blockIdx.x;
  const int hh = heads / gridDim.z, h0 = blockIdx.z * hh, items = hh * nbs;
  const int item = C::item_bytes(cw), kr = round64(hk);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_t = hopper::align1024(smem_raw);  // the head's tiles
  unsigned char* v_t = k_t + KTile::kBytes;
  unsigned char* wo_t = v_t + VTile::kBytes;
  unsigned char* rest = k_t + C::head_bytes(cw);  // the single tiles, the ring; Wq after
  unsigned char* p_t = rest;
  unsigned char* s_t = p_t + PTile::kBytes;
  unsigned char* ring = s_t + PTile::kBytes + (fused ? DTile::kBytes : 0);
  const int region = C::region(cw, hk, stages);
  uint64_t* head_full = reinterpret_cast<uint64_t*>(k_t + region);
  uint64_t* wq_full = head_full + 1;
  uint64_t* full = wq_full + 1;
  uint64_t* dq_full = full + kBwdMaxStages;

  const int tid = threadIdx.x, t = tid % 4;
  const int fr = (tid / 32) * 16 + (tid % 32) / 4;  // the thread's first fragment row
  auto load_head = [&](int hi) {
    hopper::mbar_expect_tx(head_full, C::head_bytes(cw));
    KTile::load(k_t, 0, &k_map, head_full, 0, h0 + hi, b);
    VTile::load(v_t, 0, &v_map, head_full, 0, h0 + hi, b);
    if (fused) hopper::tma_load_head(wo_t, &wo_map, head_full, 0, 0, h0 + hi, 0);
  };
  auto load_item = [&](int i) {  // head h0 + i / nbs over block j0 + i % nbs
    const int s = i % stages, j = j0 + i % nbs, h = h0 + i / nbs;
    unsigned char* st = ring + s * item;
    hopper::mbar_expect_tx(&full[s], item);
    for (int cb = 0; cb < cw / 64; ++cb)
      hopper::tma_load_head(st + cb * 64 * 128, &dy_map, &full[s], 64 * cb, 64 * j, 0, b);
    QTile::load(st + 64 * cw * 2, 0, &q_map, &full[s], 64 * j, h, b);
    if (!fused) DTile::load(st + QTile::kBytes, 0, &do_map, &full[s], 64 * j, h, b);
  };
  if (tid == 0) {
    hopper::mbar_init(head_full, 1);
    hopper::mbar_init(wq_full, 1);
    for (int s = 0; s < kBwdMaxStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&dq_full[s], 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_head(0);
    for (int i = 0; i < stages && i < items; ++i) load_item(i);
  }

  // dbo (fused): the thread's column pair over its share of each block's rows.
  const int pairs = cw / 2, groups = pairs ? 128 / pairs : 1, pair = tid % (pairs ? pairs : 1),
            grp = tid / (pairs ? pairs : 1);
  float bo0 = 0.f, bo1 = 0.f;
  float dk[NK / 64][PK / 2], dv[NK / 64][PV / 2];
  const float scale_log2e = scale * kLog2e;
  for (int hi = 0, i = 0; hi < hh; ++hi) {
    const int h = h0 + hi;
    hopper::mbar_wait(head_full, hi & 1);
#pragma unroll
    for (int mt = 0; mt < NK / 64; ++mt) {
#pragma unroll
      for (int e = 0; e < PK / 2; ++e) dk[mt][e] = 0.f;
#pragma unroll
      for (int e = 0; e < PV / 2; ++e) dv[mt][e] = 0.f;
    }
    for (int jj = 0; jj < nbs; ++jj, ++i) {
      const int s = i % stages, j = j0 + jj, row = 64 * j + fr;
      unsigned char* dy_t = ring + s * item;
      unsigned char* q_t = dy_t + 64 * cw * 2;
      unsigned char* d_t = fused ? s_t + PTile::kBytes : q_t + QTile::kBytes;
      hopper::mbar_wait(&full[s], (i / stages) & 1);

      // s = q_h·k_hᵀ; with it doattn_h = T(dy·Wo_h) (fused) or dp (doattn by TMA).
      float sc[NK / 2], dp[NK / 2], oa[PV / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kSteps; ++kk)
        hopper::Wgmma<NK, T>::ss(sc, QTile::kmajor(q_t, 0, 16 * kk), KTile::kmajor(k_t, 0, 16 * kk),
                                 kk);
      if (fused) {
        for (int kk = 0; kk < cw / 16; ++kk)
          hopper::Wgmma<PV, T>::ss_t(oa, chunked_kmajor(dy_t, 64, 0, 16 * kk),
                                     DTile::mnmajor(wo_t, 16 * kk), kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          hopper::Wgmma<NK, T>::ss(dp, DTile::kmajor(d_t, 0, 16 * kk),
                                   VTile::kmajor(v_t, 0, 16 * kk), kk);
      }
      hopper::wgmma_commit();
      if (fused && hi == 0)  // dbo: the dy block's rows past n arrive as zeros
        for (int r = grp * (64 / groups); r < (grp + 1) * (64 / groups); ++r) {
          const int col = 2 * pair, off = (col / 64) * 64 * 128 + r * 128 + (col % 64) * 2;
          const uint32_t w = *reinterpret_cast<const uint32_t*>(dy_t + (off ^ ((r & 7) << 4)));
          const T* v2 = reinterpret_cast<const T*>(&w);
          bo0 += Num<T>::to_f(v2[0]);
          bo1 += Num<T>::to_f(v2[1]);
        }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::fence_regs(oa);
      uint32_t of[DV / 16][4];
      if (fused) {  // dp = T(doattn_h)·v_hᵀ from registers; T(doattn_h) to its tile for dv
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) hopper::a_fragment<T>(of[kk], oa, kk);
#pragma unroll
        for (int e = 0; e < NK / 2; ++e) dp[e] = 0.f;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)
          hopper::Wgmma<NK, T>::rs_k(dp, of[kk], VTile::kmajor(v_t, 0, 16 * kk));
        hopper::wgmma_commit();
#pragma unroll
        for (int jn = 0; jn < DV / 8; ++jn)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<uint32_t*>(d_t + DTile::at(fr + 8 * half, 8 * jn + 2 * t)) =
                Num<T>::pack2(oa[4 * jn + 2 * half], oa[4 * jn + 2 * half + 1]);
      }
      // p = softmax(s·scale) over the row, from its own max and sum (the TPU
      // kernel's _softmax, :47-50: the one key tile holds every key), base 2;
      // 0 past n_k and n.  A row of one key gives p = 1 exactly, and so ds =
      // p·(dp - Σ p·dp) = 0, as the TPU's; a p taken from the forward's lse
      // would be 1 only to the rounding of s·scale, leaving dq, dk and dxn
      // of that rounding's size where they are 0.
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < NK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * jn + 2 * t + (e & 1) < n_k) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * jn + e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the row max over the quad (every row holds a key)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] *= scale_log2e;
      }
#pragma unroll
      for (int jn = 0; jn < NK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * jn + 2 * t + (e & 1);
          sc[4 * jn + e] = key < n_k ? exp2f(sc[4 * jn + e] * scale_log2e - mx[e / 2]) : 0.f;
          sum[e / 2] += sc[4 * jn + e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // 1 / l, or 0 for a row past n
        sum[r] = quad_sum(sum[r]);
        sum[r] = row + 8 * r < n ? 1.f / sum[r] : 0.f;
      }
#pragma unroll
      for (int jn = 0; jn < NK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * jn + e] *= sum[e / 2];
      if (fused) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        hopper::fence_regs(of);
      }
      // dsum = Σ p·dp (the TPU kernel's, :150), ds = p·(dp - dsum)·scale.
      float dsum[2] = {0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < NK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e / 2] += sc[4 * jn + e] * dp[4 * jn + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) dsum[r] = quad_sum(dsum[r]);
#pragma unroll
      for (int jn = 0; jn < NK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * jn + e] = sc[4 * jn + e] * (dp[4 * jn + e] - dsum[e / 2]) * scale;
      // T(p) and T(ds) into their tiles; dq_h = T(ds)·k_h from registers.
#pragma unroll
      for (int jn = 0; jn < NK / 8; ++jn)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = PTile::at(fr + 8 * half, 8 * jn + 2 * t);
          *reinterpret_cast<uint32_t*>(p_t + at) =
              Num<T>::pack2(sc[4 * jn + 2 * half], sc[4 * jn + 2 * half + 1]);
          *reinterpret_cast<uint32_t*>(s_t + at) =
              Num<T>::pack2(dp[4 * jn + 2 * half], dp[4 * jn + 2 * half + 1]);
        }
      uint32_t dsf[NK / 16][4];
#pragma unroll
      for (int cc = 0; cc < NK / 16; ++cc) hopper::a_fragment<T>(dsf[cc], dp, cc);
      float dqa[PK / 2];
#pragma unroll
      for (int e = 0; e < PK / 2; ++e) dqa[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < NK / 16; ++cc)
        hopper::Wgmma<PK, T>::rs(dqa, dsf[cc], KTile::mnmajor(k_t, 16 * cc));
      hopper::wgmma_commit();
      // dk_h += T(ds)ᵀ·q_h and dv_h += T(p)ᵀ·doattn_h over the block's rows.
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < NK / 64; ++mt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::Wgmma<PK, T>::ss_tt(dk[mt], PTile::mnmajor(s_t + mt * 64 * 128, 16 * kk),
                                      QTile::mnmajor(q_t, 16 * kk), 1);
          hopper::Wgmma<PV, T>::ss_tt(dv[mt], PTile::mnmajor(p_t + mt * 64 * 128, 16 * kk),
                                      DTile::mnmajor(d_t, 16 * kk), 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dqa);
      hopper::fence_regs(dsf);
#pragma unroll
      for (int mt = 0; mt < NK / 64; ++mt) {
        hopper::fence_regs(dk[mt]);
        hopper::fence_regs(dv[mt]);
      }
      hopper::store_fragment<T, PK>(dq + (size_t)b * n * hk + h * DK, hk, 64 * j, n, dqa, tid, DK);
      __syncthreads();  // every thread is done with stage s and the single tiles
      if (tid == 0 && i + stages < items) load_item(i + stages);
    }
    // dk_h and dv_h, keys as the fragment rows: rounded with one span, else
    // this span's f32 partials.
    const size_t kv_at = ((size_t)span * images + b) * n_k;
    float* pk = part + kv_at * hk;
    float* pv = part + (size_t)gridDim.x * images * n_k * hk + kv_at * hv;
#pragma unroll
    for (int mt = 0; mt < NK / 64; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = 64 * mt + fr + 8 * half;
        if (key >= n_k) continue;
#pragma unroll
        for (int jn = 0; jn < PK / 8; ++jn) {
          if (8 * jn >= DK) continue;
          const size_t at = (size_t)key * hk + h * DK + 8 * jn + 2 * t;
          const float a0 = dk[mt][4 * jn + 2 * half], a1 = dk[mt][4 * jn + 2 * half + 1];
          if (one_span)
            *reinterpret_cast<uint32_t*>(dk_out + (size_t)b * n_k * hk + at) =
                Num<T>::pack2(a0, a1);
          else
            *reinterpret_cast<float2*>(pk + at) = make_float2(a0, a1);
        }
#pragma unroll
        for (int jn = 0; jn < DV / 8; ++jn) {
          const size_t at = (size_t)key * hv + h * DV + 8 * jn + 2 * t;
          const float a0 = dv[mt][4 * jn + 2 * half], a1 = dv[mt][4 * jn + 2 * half + 1];
          if (one_span)
            *reinterpret_cast<uint32_t*>(dv_out + (size_t)b * n_k * hv + at) =
                Num<T>::pack2(a0, a1);
          else
            *reinterpret_cast<float2*>(pv + at) = make_float2(a0, a1);
        }
      }
    __syncthreads();  // the head's tiles are free
    if (tid == 0 && hi + 1 < hh) load_head(hi + 1);
  }
  if (!fused) return;

  // dbo: the groups' sums in order, this span's and image's partial (c,).
  float* red = reinterpret_cast<float*>(rest);
  red[grp * cw + 2 * pair] = bo0;
  red[grp * cw + 2 * pair + 1] = bo1;
  __syncthreads();
  float* pb = part + (one_span ? 0 : (size_t)gridDim.x * images * n_k * (hk + hv)) +
              ((size_t)span * images + b) * c;
  for (int col = tid; col < c; col += 128) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += red[g * cw + col];
    pb[col] = acc;
  }
  hopper::fence_proxy_async();  // TMA writes Wq where the threads wrote and read
  __syncthreads();

  // dxn = T(dq·Wq) per block, K = heads·dh_k: Wq (kr x cw) and a ring of
  // the span's dq blocks (64 x kr) by TMA in everything's place.
  const int dq_bytes = 64 * kr * 2, wq_bytes = kr * cw * 2;
  const int stages2 = (region - wq_bytes) / dq_bytes < kBwdMaxStages
                          ? (region - wq_bytes) / dq_bytes
                          : kBwdMaxStages;
  unsigned char* dq_ring = k_t + wq_bytes;
  auto load_dq = [&](int jj) {
    unsigned char* st = dq_ring + (jj % stages2) * dq_bytes;
    hopper::mbar_expect_tx(&dq_full[jj % stages2], dq_bytes);
    for (int kb = 0; kb < kr / 64; ++kb)
      hopper::tma_load_head(st + kb * 64 * 128, &dq_map, &dq_full[jj % stages2], 64 * kb,
                            64 * (j0 + jj), 0, b);
  };
  hopper::fence_proxy_async_global();  // this thread's dq stores, read back by TMA
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(wq_full, wq_bytes);
    for (int nc = 0; nc < cw / 64; ++nc)
      for (int kc = 0; kc < kr / 64; ++kc)
        hopper::tma_load_head(k_t + nc * kr * 128 + kc * 64 * 128, &wq_map, wq_full, 64 * nc,
                              64 * kc, 0, 0);
    for (int jj = 0; jj < stages2 && jj < nbs; ++jj) load_dq(jj);
  }
  hopper::mbar_wait(wq_full, 0);
  const int steps = pad16(hk) / 16;
  for (int jj = 0; jj < nbs; ++jj) {
    const unsigned char* dqt = dq_ring + (jj % stages2) * dq_bytes;
    hopper::mbar_wait(&dq_full[jj % stages2], (jj / stages2) & 1);
    float dx[kBwdFusedMaxC / 64][32];
    hopper::wgmma_fence();
#pragma unroll
    for (int nc = 0; nc < kBwdFusedMaxC / 64; ++nc)
      if (nc < cw / 64)
        for (int kk = 0; kk < steps; ++kk)
          hopper::Wgmma<64, T>::ss_t(dx[nc], chunked_kmajor(dqt, 64, 0, 16 * kk),
                                     hopper::Tile<64, 64>::mnmajor(k_t + nc * kr * 128, 16 * kk),
                                     kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nc = 0; nc < kBwdFusedMaxC / 64; ++nc) {
      hopper::fence_regs(dx[nc]);
      if (nc < cw / 64)
        hopper::store_fragment<T, 64>(dxn + (size_t)b * n * c + 64 * nc, c, 64 * (j0 + jj), n,
                                      dx[nc], tid, min(64, c - 64 * nc));
    }
    __syncthreads();  // every thread is done with the stage
    if (tid == 0 && jj + stages2 < nbs) load_dq(jj + stages2);
  }
}

// dk, dv = T(Σ over the spans of the f32 partials) in span order, four
// elements a thread, one per thread of the first kv_blocks blocks; and
// (fused) dbo = Σ over the spans and images of theirs, a block a column:
// strided sums, then a fixed tree.  The same bits every run.  nk4, nv4: dk's
// and dv's elements / 4.
constexpr int kReduceThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    cross_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ dk,
                            T* __restrict__ dv, float* __restrict__ dbo, int spans, long long nk4,
                            long long nv4, int parts_bo, int c) {
  const float4* pk = reinterpret_cast<const float4*>(part);
  const float4* pv = pk + spans * nk4;
  const float* pb = reinterpret_cast<const float*>(pv + spans * nv4);
  const long long kv_blocks = (nk4 + nv4 + kReduceThreads - 1) / kReduceThreads;
  if (blockIdx.x < kv_blocks) {
    const long long i = blockIdx.x * (long long)kReduceThreads + threadIdx.x;
    if (i >= nk4 + nv4) return;
    const bool is_k = i < nk4;
    const long long e = is_k ? i : i - nk4, n4 = is_k ? nk4 : nv4;
    const float4* src = is_k ? pk : pv;
    float4 acc = src[e];
    for (int s = 1; s < spans; ++s) {
      const float4 v = src[s * n4 + e];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<uint2*>((is_k ? dk : dv) + 4 * e) =
        make_uint2(Num<T>::pack2(acc.x, acc.y), Num<T>::pack2(acc.z, acc.w));
    return;
  }
  __shared__ float sums[kReduceThreads];
  const int col = (int)(blockIdx.x - kv_blocks);
  float acc = 0.f;
  for (int p = threadIdx.x; p < parts_bo; p += kReduceThreads) acc += pb[(size_t)p * c + col];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) sums[threadIdx.x] += sums[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dbo[col] = sums[0];
}

// How a backward runs: route 1, cross_bwd with both dgrads and dbo inside
// (c <= 128), then the reduction; route 2, the split: gemm_wgmma's dgrad for
// doattn, cross_bwd over head groups, the dgrad for dxn, dbo's column sums,
// the reduction where the spans are more than one; route 0, the four steps
// (n_k > 128, wider heads).  `spans` x `groups` CTAs per image, a ring of
// `stages`.
struct BwdPlan {
  int route, spans, bps, groups, stages, smem;
};

int sm_count() {
  static int counts[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 132;
  if (!counts[device] &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    counts[device] = 132;
  return counts[device];
}

// The shared memory of a cross_bwd instance with a ring of `stages`.
int cross_bwd_smem_of(bool fused, int n_k, int c, int hk, int dh_k, int dh_v, int stages) {
  const int cw = fused ? round64(c) : 0;
#define VIT_CROSS_BWD_SMEM(DK, DV)                                                             \
  if (dh_k == DK && dh_v == DV)                                                                \
    return n_k <= 64 ? CrossBwd<DK, DV, 64>::smem(cw, hk, stages)                              \
                     : CrossBwd<DK, DV, 128>::smem(cw, hk, stages);
  VIT_CROSS_WIDTHS(VIT_CROSS_BWD_SMEM)
#undef VIT_CROSS_BWD_SMEM
  return kMaxSmem + 1;
}

// The route by shape (`force` -1), or the route asked for where the shape
// takes it (0 always; 2 wherever cross_bwd does; 1 where it is the shape's
// own), -1 otherwise; the ring: the deepest (up to 4) at which two CTAs
// share an SM, else 2; the grid: spans of ceil(nb / spans) blocks and head
// groups, chosen so the CTAs fill the card in the fewest rounds of the least
// work a CTA (fewer CTAs, then fewer spans, on a tie).
BwdPlan cross_bwd_plan(int b, int n, int n_k, int c, int heads, int dh_k, int dh_v, int force) {
  BwdPlan plan{0, 1, 1, 1, 2, 0};
  const int hk = heads * dh_k;
  const bool one = cross_mode(b, n, n_k, c, heads, dh_k, dh_v) != 0;
  const int own = !one ? 0
                  : c <= kBwdFusedMaxC && hk <= kBwdMaxHk &&
                          cross_bwd_smem_of(true, n_k, c, hk, dh_k, dh_v, 2) <= kMaxSmem
                      ? 1
                      : 2;
  plan.route = force < 0 ? own : force == 0 || force == own || (force == 2 && one) ? force : -1;
  if (plan.route <= 0) return plan;
  const bool fused = plan.route == 1;
  for (int stages = kBwdMaxStages; stages >= 2; --stages) {
    plan.stages = stages;
    plan.smem = cross_bwd_smem_of(fused, n_k, c, hk, dh_k, dh_v, stages);
    if (kBwdMaxCtasPerSM * (plan.smem + 1024) <= kSmemPerSM) break;
  }
  const int per_sm = kSmemPerSM / (plan.smem + 1024) < kBwdMaxCtasPerSM
                         ? kSmemPerSM / (plan.smem + 1024)
                         : kBwdMaxCtasPerSM;
  const long long slots = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  const int nb = (n + 63) / 64;
  long long best_cost = -1, best_ctas = 0;
  for (int hh = heads; hh >= 1; --hh) {
    if (heads % hh || (fused && hh != heads) || heads / hh > 65535) continue;
    for (int spans = 1; spans <= nb; ++spans) {
      const int bps = (nb + spans - 1) / spans;
      if ((nb + bps - 1) / bps != spans) continue;
      const long long ctas = (long long)b * spans * (heads / hh);
      const long long cost = (ctas + slots - 1) / slots * bps * hh;
      if (best_cost < 0 || cost < best_cost ||
          (cost == best_cost && (ctas < best_ctas || (ctas == best_ctas && spans < plan.spans)))) {
        best_cost = cost;
        best_ctas = ctas;
        plan.spans = spans;
        plan.bps = bps;
        plan.groups = heads / hh;
      }
    }
  }
  return plan;
}

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

// The scratch a route carves from one buffer, in bytes, in this order:
// route 0: doattn (rows, hv), dsum (b, heads, n) f32, the column sums' f32
// part; route 2: doattn, the column sums' part, the partials; route 1: the
// partials.  The partials, f32: dk and dv per span (more than one span only)
// and, route 1, dbo per span and image.
struct BwdScratch {
  size_t dsum, colsum, partials, total;
};

BwdScratch cross_bwd_scratch(const BwdPlan& plan, int b, int n, int n_k, int c, int heads,
                             int dh_k, int dh_v) {
  const size_t rows = (size_t)b * n, hk = (size_t)heads * dh_k, hv = (size_t)heads * dh_v;
  BwdScratch s{0, 0, 0, 0};
  const size_t doattn = plan.route != 1 ? align256(rows * hv * 2) : 0;
  const size_t dsum = plan.route == 0 ? align256((size_t)b * heads * n * 4) : 0;
  const size_t colsum = plan.route != 1 ? align256((size_t)ln_bwd_partial_rows((int)rows) * c * 4)
                                        : 0;
  s.dsum = doattn;
  s.colsum = s.dsum + dsum;
  s.partials = s.colsum + colsum;
  const size_t kv = plan.route > 0 && plan.spans > 1 ? (size_t)n_k * (hk + hv) : 0;
  const size_t bo = plan.route == 1 ? (size_t)c : 0;
  s.total = s.partials + (size_t)plan.spans * b * (kv + bo) * 4;
  return s;
}

template <typename T, int DK, int DV, int NK>
cudaError_t cross_bwd_t(const BwdPlan& plan, const void* dy, const void* q, const void* doattn,
                        const void* k, const void* v, const void* wq, const void* wo,
                        void* dxn, void* dq, void* dk, void* dv, float* dbo, float* part, int b,
                        int n, int n_k, int c, int heads, float scale, cudaStream_t stream) {
  constexpr int dt = hopper::dtype_of<T>();
  using C = CrossBwd<DK, DV, NK>;
  const bool fused = plan.route == 1;
  const int hk = heads * DK, hv = heads * DV, cw = fused ? round64(c) : 0;
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, cross_bwd_kernel<T, DK, DV, NK>, kMaxSmem);
  const long long act_st[3] = {(long long)n * c, 8, c};  // dy: (b, n, c) per image
  long long st[12], wo_st[3] = {8, DV, hv};
  packed_strides(st, n, heads, DK);        // q
  packed_strides(st + 3, n_k, heads, DK);  // k
  packed_strides(st + 6, n_k, heads, DV);  // v
  packed_strides(st + 9, n, heads, DV);    // doattn
  const long long dq_st[3] = {(long long)n * hk, 8, hk};  // dq: (b, n, hk) per image
  CUtensorMap dy_map, q_map, do_map, k_map, v_map, wo_map, wq_map, dq_map;
  if (err == cudaSuccess) err = head_map(&q_map, q, dt, DK, n, heads, b, st, C::QTile::kChunk, 64);
  if (err == cudaSuccess)
    err = head_map(&k_map, k, dt, DK, n_k, heads, b, st + 3, C::KTile::kChunk, NK);
  if (err == cudaSuccess)
    err = head_map(&v_map, v, dt, DV, n_k, heads, b, st + 6, C::VTile::kChunk, NK);
  if (err == cudaSuccess && fused) err = head_map(&dy_map, dy, dt, c, n, 1, b, act_st, 64, 64);
  if (err == cudaSuccess && fused) err = head_map(&wo_map, wo, dt, DV, c, heads, 1, wo_st, C::PV, cw);
  if (err == cudaSuccess && fused) err = matrix_map(&wq_map, wq, dt, c, hk, c, 64, 64);
  if (err == cudaSuccess && fused) err = head_map(&dq_map, dq, dt, hk, n, 1, b, dq_st, 64, 64);
  if (err == cudaSuccess && !fused)
    err = head_map(&do_map, doattn, dt, DV, n, heads, b, st + 9, C::DTile::kChunk, 64);
  if (err != cudaSuccess) return err;
  if (!fused) dy_map = wo_map = wq_map = dq_map = q_map;  // unread
  else do_map = q_map;
  dim3 grid(plan.spans, b, plan.groups);
  cross_bwd_kernel<T, DK, DV, NK><<<grid, 128, plan.smem, stream>>>(
      dy_map, q_map, do_map, k_map, v_map, wo_map, wq_map, dq_map, static_cast<T*>(dq),
      fused ? static_cast<T*>(dxn) : nullptr, static_cast<T*>(dk), static_cast<T*>(dv), part, n,
      n_k, c, heads, plan.bps, plan.stages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nk4 = plan.spans > 1 ? (long long)b * n_k * hk / 4 : 0;
  const long long nv4 = plan.spans > 1 ? (long long)b * n_k * hv / 4 : 0;
  const long long blocks = (nk4 + nv4 + kReduceThreads - 1) / kReduceThreads + (fused ? c : 0);
  if (blocks == 0) return cudaSuccess;
  cross_bwd_reduce_kernel<T><<<(unsigned)blocks, kReduceThreads, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), fused ? dbo : nullptr, plan.spans, nk4,
      nv4, plan.spans * b, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t cross_bwd_dispatch(const BwdPlan& plan, const void* dy, const void* q,
                               const void* doattn, const void* k, const void* v,
                               const void* wq, const void* wo, void* dxn, void* dq, void* dk,
                               void* dv, float* dbo, float* part, int b, int n, int n_k, int c,
                               int heads, int dh_k, int dh_v, float scale, cudaStream_t stream) {
#define VIT_CROSS_BWD(DK, DV)                                                                  \
  if (dh_k == DK && dh_v == DV)                                                                \
    return n_k <= 64 ? cross_bwd_t<T, DK, DV, 64>(plan, dy, q, doattn, k, v, wq, wo, dxn, dq,  \
                                                  dk, dv, dbo, part, b, n, n_k, c, heads,      \
                                                  scale, stream)                               \
                     : cross_bwd_t<T, DK, DV, 128>(plan, dy, q, doattn, k, v, wq, wo, dxn, dq, \
                                                   dk, dv, dbo, part, b, n, n_k, c, heads,     \
                                                   scale, stream);
  VIT_CROSS_WIDTHS(VIT_CROSS_BWD)
#undef VIT_CROSS_BWD
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace vit

// The forward's route at this shape (cross_mode): 1 when it is one cross_fwd
// launch (its residuals optional), 2 when cross_fwd writes oattn and a GEMM
// takes y (oattn required, q and lse optional), 0 when it takes the three
// launches (q, oattn and lse required).
extern "C" int vit_fused_cross_attention_fused(int b, int n, int n_k, int c, int heads, int dh_k,
                                               int dh_v) {
  return vit::cross_mode(b, n, n_k, c, heads, dh_k, dh_v);
}

// Outputs y (rows, c); residuals q (rows, hk), oattn (rows, hv) in the
// compute dtype and lse (b, heads, n) f32, rows = b·n: q and lse both null
// when serving, oattn null only when serving a shape of route 1
// (vit_fused_cross_attention_fused).  x, xn (rows, c); k (b, n_k, hk), v (b,
// n_k, hv); wq (hk, c) and wo (c, hv) in nn.Linear layout; bo (c,).  hk =
// heads·dh_k, hv = heads·dh_v.
extern "C" int vit_fused_cross_attention_fwd(const void* x, const void* xn, const void* wq,
                                             const void* k, const void* v, const void* wo,
                                             const void* bo, void* y, void* q, void* oattn,
                                             float* lse, int b, int n, int n_k, int c, int heads,
                                             int dh_k, int dh_v, float scale, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int mode = cross_mode(b, n, n_k, c, heads, dh_k, dh_v);
  if (!q != !lse || (q && !oattn) || (mode != 1 && !oattn) || (mode == 0 && !q))
    return cudaErrorInvalidValue;
  if (mode) {
    if (dtype == kBF16)
      return cross_fwd_dispatch<__nv_bfloat16>(x, xn, wq, k, v, wo, bo, y, q, oattn, lse, b, n,
                                               n_k, c, heads, dh_k, dh_v, scale, stream);
    if (dtype == kF16)
      return cross_fwd_dispatch<__half>(x, xn, wq, k, v, wo, bo, y, q, oattn, lse, b, n, n_k, c,
                                        heads, dh_k, dh_v, scale, stream);
    return cudaErrorInvalidValue;
  }
  const int rows = b * n, hk = heads * dh_k, hv = heads * dh_v;
  long long st[12];
  packed_strides(st, n, heads, dh_k);        // q
  packed_strides(st + 3, n_k, heads, dh_k);  // k
  packed_strides(st + 6, n_k, heads, dh_v);  // v
  packed_strides(st + 9, n, heads, dh_v);    // oattn
  cudaError_t err = launch_linear(xn, wq, kWeightNK, nullptr, nullptr, nullptr, q, nullptr,
                                  nullptr, rows, hk, c, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_flash_fwd(q, k, v, oattn, lse, st, b, heads, n, n_k, dh_k, dh_v, scale, dtype,
                         stream);
  if (err != cudaSuccess) return err;
  return launch_linear(oattn, wo, kWeightNK, bo, x, nullptr, y, nullptr, nullptr, rows, c, hv,
                       kEpiBiasResidual, dtype, stream);
}

// The backward's route at this shape (cross_bwd_plan): 1, cross_bwd with the
// dgrads inside, and its reduction; 2, the split (gemm_wgmma dgrads around
// cross_bwd); 0, the four steps.  `force` -1 asks for the shape's own route,
// 0, 1 or 2 for that one (the card's comparison of designs); -1 comes back
// where the shape cannot take the route asked for.
extern "C" int vit_fused_cross_attention_bwd_route(int b, int n, int n_k, int c, int heads,
                                                   int dh_k, int dh_v, int force) {
  return vit::cross_bwd_plan(b, n, n_k, c, heads, dh_k, dh_v, force).route;
}

// The bytes of the one scratch buffer the backward takes on that route.
extern "C" long long vit_fused_cross_attention_bwd_scratch(int b, int n, int n_k, int c,
                                                           int heads, int dh_k, int dh_v,
                                                           int force) {
  using namespace vit;
  const BwdPlan plan = cross_bwd_plan(b, n, n_k, c, heads, dh_k, dh_v, force);
  return plan.route < 0 ? -1
                        : (long long)cross_bwd_scratch(plan, b, n, n_k, c, heads, dh_k, dh_v).total;
}

// Outputs dxn (rows, c), dq (rows, hk), dk (b, n_k, hk), dv (b, n_k, hv) in
// the compute dtype and dbo (c,) f32, from dy (rows, c) and the forward's q,
// k, v, oattn and lse (oattn and lse read by the four steps only).
// `scratch`: the bytes vit_fused_cross_attention_bwd_scratch gives for the
// same `force`.
extern "C" int vit_fused_cross_attention_bwd(const void* dy, const void* q, const void* k,
                                             const void* v, const void* oattn, const float* lse,
                                             const void* wq, const void* wo, void* dxn, void* dq,
                                             void* dk, void* dv, float* dbo, void* scratch, int b,
                                             int n, int n_k, int c, int heads, int dh_k, int dh_v,
                                             float scale, int force, int dtype,
                                             cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, hk = heads * dh_k, hv = heads * dh_v;
  if (rows <= 0 || (dtype != kBF16 && dtype != kF16)) return cudaErrorInvalidValue;
  const BwdPlan plan = cross_bwd_plan(b, n, n_k, c, heads, dh_k, dh_v, force);
  if (plan.route < 0) return cudaErrorInvalidValue;
  const BwdScratch sc = cross_bwd_scratch(plan, b, n, n_k, c, heads, dh_k, dh_v);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  void* doattn = base;  // at 0
  float* dsum = reinterpret_cast<float*>(base + sc.dsum);
  float* colsum = reinterpret_cast<float*>(base + sc.colsum);
  float* part = reinterpret_cast<float*>(base + sc.partials);
  cudaError_t err = cudaSuccess;
  if (plan.route == 0) {
    long long st[24];
    packed_strides(st, n, heads, dh_k);         // q
    packed_strides(st + 3, n_k, heads, dh_k);   // k
    packed_strides(st + 6, n_k, heads, dh_v);   // v
    packed_strides(st + 9, n, heads, dh_v);     // oattn
    packed_strides(st + 12, n, heads, dh_v);    // doattn
    packed_strides(st + 15, n, heads, dh_k);    // dq
    packed_strides(st + 18, n_k, heads, dh_k);  // dk
    packed_strides(st + 21, n_k, heads, dh_v);  // dv
    err = launch_linear(dy, wo, kWeightKN, nullptr, nullptr, nullptr, doattn, nullptr, nullptr,
                        rows, hv, c, kEpiStore, dtype, stream);
    if (err != cudaSuccess) return err;
    err = launch_flash_bwd(q, k, v, oattn, lse, doattn, dq, dk, dv, dsum, st, b, heads, n, n_k,
                           dh_k, dh_v, scale, dtype, stream);
    if (err != cudaSuccess) return err;
    err = launch_linear(dq, wq, kWeightKN, nullptr, nullptr, nullptr, dxn, nullptr, nullptr, rows,
                        c, hk, kEpiStore, dtype, stream);
    if (err != cudaSuccess) return err;
    return launch_column_sums(dy, colsum, dbo, rows, c, dtype, stream);
  }
  if (plan.route == 2) {
    err = launch_dgrad(dy, wo, nullptr, doattn, nullptr, nullptr, rows, hv, c, kEpiStore, dtype,
                       stream);
    if (err != cudaSuccess) return err;
  }
  err = dtype == kBF16
            ? cross_bwd_dispatch<__nv_bfloat16>(plan, dy, q, doattn, k, v, wq, wo, dxn, dq, dk,
                                                dv, dbo, part, b, n, n_k, c, heads, dh_k, dh_v,
                                                scale, stream)
            : cross_bwd_dispatch<__half>(plan, dy, q, doattn, k, v, wq, wo, dxn, dq, dk, dv, dbo,
                                         part, b, n, n_k, c, heads, dh_k, dh_v, scale, stream);
  if (err != cudaSuccess || plan.route == 1) return err;
  err = launch_dgrad(dq, wq, nullptr, dxn, nullptr, nullptr, rows, c, hk, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_column_sums(dy, colsum, dbo, rows, c, dtype, stream);
}
