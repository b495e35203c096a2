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
// Backward, four steps:
//   1. linear dy·Wo (kWeightKN)                     -> doattn = T(dy·Wo)
//   2. the (dh_k, dh_v) flash backward: D = rowsum(doattn∘oattn), dq, then dk
//      and dv from lse (no statistics pass; the TPU recomputed the softmax and
//      Σ dp·p)                                      -> dq, dk, dv
//   3. linear dq·Wq (kWeightKN)                     -> dxn = T(dq·Wq)
//   4. fixed-order column sums of dy in f32         -> dbo
// The weight gradients dWq = dqᵀ·xn and dWo = dyᵀ·oattn stay plain GEMMs
// outside, as the TPU left them to XLA (:330-338).  dk and dv flow back into
// the strided convolutions, dy straight into the residual.  The dk/dv pass
// gets only b·heads CTAs at n_k = 64 (128 at stage 1), each looping over
// every query tile: under one wave on 132 SMs (split-q with a fixed-order
// reduction is later work).
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

// Outputs dxn (rows, c), dq (rows, hk), dk (b, n_k, hk), dv (b, n_k, hv) in
// the compute dtype and dbo (c,) f32, from dy (rows, c) and the forward's q,
// k, v, oattn and lse.  Scratch: doattn (rows, hv) in the compute dtype,
// dsum (b, heads, n) and part (vit_ln_bwd_partial_rows(rows), c) f32.
extern "C" int vit_fused_cross_attention_bwd(const void* dy, const void* q, const void* k,
                                             const void* v, const void* oattn, const float* lse,
                                             const void* wq, const void* wo, void* dxn, void* dq,
                                             void* dk, void* dv, float* dbo, void* doattn,
                                             float* dsum, float* part, int b, int n, int n_k,
                                             int c, int heads, int dh_k, int dh_v, float scale,
                                             int dtype, cudaStream_t stream) {
  using namespace vit;
  const int rows = b * n, hk = heads * dh_k, hv = heads * dh_v;
  if (rows <= 0) return cudaErrorInvalidValue;
  long long st[24];
  packed_strides(st, n, heads, dh_k);        // q
  packed_strides(st + 3, n_k, heads, dh_k);  // k
  packed_strides(st + 6, n_k, heads, dh_v);  // v
  packed_strides(st + 9, n, heads, dh_v);    // oattn
  packed_strides(st + 12, n, heads, dh_v);   // doattn
  packed_strides(st + 15, n, heads, dh_k);   // dq
  packed_strides(st + 18, n_k, heads, dh_k);  // dk
  packed_strides(st + 21, n_k, heads, dh_v);  // dv
  cudaError_t err = launch_linear(dy, wo, kWeightKN, nullptr, nullptr, nullptr, doattn, nullptr,
                                  nullptr, rows, hv, c, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_flash_bwd(q, k, v, oattn, lse, doattn, dq, dk, dv, dsum, st, b, heads, n, n_k, dh_k,
                         dh_v, scale, dtype, stream);
  if (err != cudaSuccess) return err;
  err = launch_linear(dq, wq, kWeightKN, nullptr, nullptr, nullptr, dxn, nullptr, nullptr, rows, c,
                      hk, kEpiStore, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_column_sums(dy, part, dbo, rows, c, dtype, stream);
}
