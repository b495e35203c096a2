// Row-major GEMM on Hopper's warpgroup MMA with fused epilogues, fed by a TMA
// ring from a producer warp:
//   out (rows, n) = epi(A (rows, k) · B),  A k-contiguous, f32 accumulation,
// B an nn.Linear weight W in one of two layouts (kernels.cuh WeightLayout):
//   kWeightNK  B = Wᵀ, W (n, k) k-contiguous: the forward GEMMs.  A and W are
//              both K-major, wgmma's shared-operand case with no transpose.
//   kWeightKN  B = W, W (k, n) n-contiguous, read as it lies: the blocks'
//              dgrads.  B is MN-major (wgmma's transpose bit): a 128-byte
//              swizzled TMA box is 64 elements wide, so a stage's 64 x 256
//              W tile arrives as four 64 x 64 boxes, one per 64 columns, that
//              lie 8 KB apart, and one m64n256k16 reads them through a
//              descriptor whose leading byte offset is that 8 KB (the next
//              64 columns) and whose stride byte offset is 1 KB (the next 8
//              k rows).  No weight is transposed, here or per step.
// The epilogues are linear.cu's, with its rounding points (kernels.cuh Epilogue):
//   kEpiStore         out = T(acc)                  (ln_gemm's QKV; doattn = dy·Wo)
//   kEpiBiasGelu      out = T(gelu(acc + b))        (fc1, serving)
//   kEpiBiasResidual  out = T(res + T(acc + b))     (out-proj, fc2)
//   kEpiBiasGeluSave  out = T(gelu(acc + b)), aux = h = T(acc + b), the GELU of
//                     the unrounded sum             (fc1, training)
//   kEpiStoreF32      out = acc in f32              (dxn = dqkv·Wqkv, dh·W1)
//   kEpiDGelu         out = dh = T(acc·gelu'(h)), aux = gact = T(gelu(h)) from
//                     the saved h (aux_in), exact erf; per 64-row f32 column
//                     sums of the unrounded acc·gelu'(h) into `partial`, as
//                     linear.cu lays them out (linear_partial_rows), so that
//                     launch_colsum adds them in a fixed order   (dy·W2)
// It runs every forward GEMM of the hybrid layer (fused_hybrid.cu: ln_gemm's
// QKV, proj_mlp's out-projection, fc1 and fc2), and, through
// launch_forward_gemm, the fused MLP's fc1 and fc2 and the attention block's
// QKV and out-projection (fused_mlp.cu, fused_attention_block.cu); through
// launch_dgrad, the dgrads of those two blocks' backwards, of proj_mlp's
// backward, and the cross-attention backward's dy·Wo and dq·Wq from 129
// channels (fused_cross_attention.cu's split).  Both send n < 256
// to linear.cu: ScalableViT's conv-MLPs have fc2 at n = 64 and 128 and dh·W1
// at n = 64 and 128 over 262,144 and 65,536 rows, where a 256-wide tile
// computes four or two times the products (the forward's threshold is a card
// measurement at ScalableViT's four stage widths and the ViT widths,
// chip_smoke.py's forward GEMM phase: from n = 256 this kernel wins, k = 64
// included; at n = 128 the two tie, at n = 64 linear.cu wins).  linear.cu's
// mma.sync kernel keeps those narrow GEMMs, the cross-attention block's
// four-step backward's (past 128 keys) and ln_gemm's backward GEMM.
//
// Bound on the H100: at ViT-B/32's hybrid layer (8320 rows, d 1024, inner
// 1024, hidden 2048, bf16) proj_mlp's three GEMMs are 87.2 GFLOP (0.088 ms at
// 989 TFLOP/s) against 76 MB of operands and outputs (0.023 ms at 3.35 TB/s);
// the fused MLP backward's two dgrads at bench.py's step (the same rows and
// widths) 69.8 GFLOP (0.071 ms) against 0.05 ms of bytes (h, dh and gact at
// their 34 MB each, the f32 dxn at 34 MB, dy 17 MB): the tensor cores bound
// them, and the design keeps them fed.
//
// Warp-specialised and persistent: one CTA per SM walks the 128 x 256 output
// tiles (row-major over the tiles, so the CTAs in flight share A's rows and
// all of W stays in L2).  Warpgroup 0 is the producer: it gives up registers
// (setmaxnreg 40) and one thread keeps a 4-stage ring of 64-column k steps of
// A and W (128-byte swizzled, 48 KB a stage) full through TMA, waiting on each
// stage's `empty` barrier, across tile boundaries, so the next tile's loads
// run under this tile's epilogue.  Warpgroups 1 and 2 take 64 rows each on
// m64n256k16 (128 f32 accumulators a thread; setmaxnreg 232 at run time,
// but ptxas fits every thread of a 384-thread CTA in 168 registers, so the
// GELU and residual epilogues spill a little), keep one k step's products
// in flight (wgmma_wait<1>) and release the step before it.
// Rows, columns and k past their extents arrive as zeros from the maps.
//
// Epilogue through shared memory: each consumer warpgroup writes its 64 x 256
// fragment in passes into a 16 KB staging tile of its own (16-byte chunks
// XOR-swizzled by row, so the fragment's writes and the 16-byte reads are free
// of bank conflicts), then stores it row by row in coalesced 16-byte pieces;
// stores past `rows` or n are skipped (n % 8 == 0: a piece is all in or all
// out).  The bf16 epilogues pass over 64 x 128 halves, with the bias (a column
// pair a load) and the GELU applied in registers and the residual read in
// 16-byte pieces.  The f32 one passes over 64 x 64 quarters (256-byte rows,
// the halves' geometry), so the 4-stage ring (192 KB) and the two staging
// tiles (32 KB) still fill the 227 KB a CTA may have.  The dGELU one works the
// accumulators in 64-column quarters too, the staging tile split in two 64 x 64
// bf16 halves: h's quarter comes in coalesced; each thread turns its
// fragment's pairs into dh (in place of h) and gact (in the other half), one
// erf and one exp a value, and adds its two rows of each column; the warp's
// lanes add their 16 rows by shuffles, the four warps' sums are added in warp
// order through shared memory, and dh and gact leave coalesced.  No atomics:
// the partial sums, and db1, repeat bit for bit.  A 3-stage ring with whole
// 64 x 256 staging tiles ran slower on the H100 for the bf16 epilogues, and
// one with whole 64 x 128 f32 staging halves for the f32 epilogue (PERF.md
// §6).
#include "hopper.cuh"

namespace vit {
namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 384;              // producer warpgroup + two consumer warpgroups
constexpr int kHalf = 128;                 // output columns of a bf16 epilogue pass
constexpr int kQuarter = 64;               // output columns of an f32 or dGELU pass
constexpr int kStageTile = 64 * kHalf * 2;  // a consumer warpgroup's staging tile (bytes)
constexpr int kDgradMinN = 256;            // launch_dgrad's narrowest n on this kernel
constexpr int kForwardMinN = 256;          // launch_forward_gemm's

using ATile = hopper::Tile<kBM, kBK>;
using WTile = hopper::Tile<kBN, kBK>;   // kWeightNK: 256 rows (n) of 64 k
using WChunk = hopper::Tile<kBK, 64>;   // kWeightKN: 64 rows (k) of 64 n, four a stage
static_assert(4 * WChunk::kBytes == WTile::kBytes, "a stage holds the same W either way");

// The ring of A and W tiles, the two staging tiles, the full/empty barriers, alignment.
constexpr int kSmemBytes =
    kStages * (ATile::kBytes + WTile::kBytes) + 2 * kStageTile + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a CTA may have");

// What an epilogue reads and writes besides the accumulators; unused ones are null.
template <typename T>
struct Operands {
  const T* bias;    // (n,)
  const T* res;     // (rows, n) residual
  const T* aux_in;  // (rows, n) saved pre-activation h (kEpiDGelu)
  void* out;        // (rows, n): T, or f32 for kEpiStoreF32
  T* aux;           // (rows, n): h (kEpiBiasGeluSave), gact (kEpiDGelu)
  float* partial;   // (linear_partial_rows(rows), n) column sums of dh (kEpiDGelu)
};

// Byte offset of 16-byte chunk c of row r in a staging tile (256-byte rows:
// kHalf bf16 or kQuarter f32 columns).
__device__ __forceinline__ int staged(int r, int c) { return r * kHalf * 2 + ((c ^ (r & 7)) << 4); }
// The same in a 64 x 64 bf16 half of it (128-byte rows).
__device__ __forceinline__ int staged64(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Eight values of a and b added in f32, rounded: T(b + a).
template <typename T>
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
  uint4 r;
  uint32_t* p = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = Num<T>::pack2(Num<T>::to_f(y[2 * i]) + Num<T>::to_f(x[2 * i]),
                         Num<T>::to_f(y[2 * i + 1]) + Num<T>::to_f(x[2 * i + 1]));
  return r;
}

// A consumer warpgroup's bf16 epilogue (kEpiStore, kEpiBiasGelu,
// kEpiBiasResidual, kEpiBiasGeluSave): its 64 x 256 fragment (rows r0..,
// columns n0..) through its staging tile, kHalf columns at a time;
// kEpiBiasGeluSave stages and stores h, then g (the accumulators die as the
// GELU pass reads them, as in kEpiBiasGelu, rather than live through it).  The
// bias pairs of a pass and the residual's pieces are loaded together before
// they are used (read-only loads: the epilogue never writes them), so their
// latencies overlap.
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[kBN / 2], unsigned char* stage,
                                         const Operands<T>& op, int r0, int n0, int rows, int n,
                                         int lt, int barrier) {
  constexpr int passes = EPI == kEpiBiasGeluSave ? 2 : 1, J = kHalf / 8, P = 64 * J / 128;
  const int fr = (lt / 32) * 16 + (lt % 32) / 4, t = lt % 4;
  T* out = static_cast<T*>(op.out);
#pragma unroll
  for (int hf = 0; hf < kBN / kHalf; ++hf) {
    uint32_t bias2[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = n0 + kHalf * hf + 8 * j + 2 * t;
      bias2[j] = EPI != kEpiStore && col < n
                     ? __ldg(reinterpret_cast<const unsigned int*>(op.bias + col)) : 0u;
    }
#pragma unroll
    for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const T* b2 = reinterpret_cast<const T*>(&bias2[j]);
        const float b0 = Num<T>::to_f(b2[0]), b1 = Num<T>::to_f(b2[1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // rows fr and fr + 8
          const int a = 4 * (J * hf + j) + 2 * e;
          float v0 = acc[a], v1 = acc[a + 1];
          if (EPI != kEpiStore) {
            v0 += b0;
            v1 += b1;
          }
          if (EPI == kEpiBiasGelu || (EPI == kEpiBiasGeluSave && pass == 1)) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          const int r = fr + 8 * e;
          *reinterpret_cast<uint32_t*>(stage + staged(r, j) + 4 * t) = Num<T>::pack2(v0, v1);
        }
      }
      hopper::named_sync(barrier, 128);
      T* dst = EPI == kEpiBiasGeluSave && pass == 0 ? op.aux : out;
      uint4 rv[P];
      if (EPI == kEpiBiasResidual) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int c = lt + 128 * i, row = r0 + c / J, col = n0 + kHalf * hf + 8 * (c % J);
          rv[i] = row < rows && col < n
                      ? __ldg(reinterpret_cast<const uint4*>(op.res + (long long)row * n + col))
                      : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int c = lt + 128 * i, r = c / J, cc = c % J;
        const int row = r0 + r, col = n0 + kHalf * hf + 8 * cc;
        if (row < rows && col < n) {
          uint4 v = *reinterpret_cast<const uint4*>(stage + staged(r, cc));
          if (EPI == kEpiBiasResidual) v = add8<T>(v, rv[i]);
          *reinterpret_cast<uint4*>(dst + (long long)row * n + col) = v;
        }
      }
      hopper::named_sync(barrier, 128);  // the staging tile is free again
    }
  }
}

// kEpiStoreF32: the fragment in f32, kQuarter columns (256-byte staged rows)
// at a time.
__device__ __forceinline__ void epilogue_f32(const float (&acc)[kBN / 2], unsigned char* stage,
                                             float* __restrict__ out, int r0, int n0, int rows,
                                             int n, int lt, int barrier) {
  constexpr int J = kQuarter / 8, P = 64 * (kQuarter / 4) / 128;
  const int fr = (lt / 32) * 16 + (lt % 32) / 4, t = lt % 4;
#pragma unroll
  for (int q = 0; q < kBN / kQuarter; ++q) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // columns 8j + 2t, + 1: chunk 2j + t / 2, 8 bytes in
        const int a = 4 * (J * q + j) + 2 * e;
        *reinterpret_cast<float2*>(stage + staged(fr + 8 * e, 2 * j + t / 2) + 8 * (t % 2)) =
            make_float2(acc[a], acc[a + 1]);
      }
    hopper::named_sync(barrier, 128);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = lt + 128 * i, r = c / 16, cc = c % 16;
      const int row = r0 + r, col = n0 + kQuarter * q + 4 * cc;
      if (row < rows && col < n)
        *reinterpret_cast<uint4*>(out + (long long)row * n + col) =
            *reinterpret_cast<const uint4*>(stage + staged(r, cc));
    }
    hopper::named_sync(barrier, 128);  // the staging tile is free again
  }
}

// kEpiDGelu, kQuarter columns at a time, the staging tile split into two
// 64 x 64 bf16 halves: hs takes h's quarter and then dh in its place, gs gact
// and then the four warps' column sums.
template <typename T>
__device__ __forceinline__ void epilogue_dgelu(const float (&acc)[kBN / 2], unsigned char* stage,
                                               const Operands<T>& op, int r0, int n0, int rows,
                                               int n, int lt, int barrier) {
  constexpr int J = kQuarter / 8, P = 64 * J / 128;
  unsigned char* hs = stage;
  unsigned char* gs = stage + kStageTile / 2;
  const int warp = lt / 32, g = (lt % 32) / 4, t = lt % 4, fr = warp * 16 + g;
  T* dh = static_cast<T*>(op.out);
#pragma unroll  // acc is indexed by q: registers only if q is a constant
  for (int q = 0; q < kBN / kQuarter; ++q) {
    const int c0 = n0 + kQuarter * q;
    uint4 hv[P];  // h's pieces, loaded together
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = lt + 128 * i, row = r0 + c / J, col = c0 + 8 * (c % J);
      hv[i] = row < rows && col < n
                  ? __ldg(reinterpret_cast<const uint4*>(op.aux_in + (long long)row * n + col))
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = lt + 128 * i;
      *reinterpret_cast<uint4*>(hs + staged64(c / J, c % J)) = hv[i];
    }
    hopper::named_sync(barrier, 128);
    // dh32 = acc·gelu'(h) for each fragment pair; dh = T(dh32) over h, gact =
    // T(gelu(h)); the warp's 16 rows of each column summed (lanes of one t
    // hold the same columns), lane (g, t) keeping n8-block g's pair.
    float keep0 = 0.f, keep1 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a = 4 * (J * q + j) + 2 * e, off = staged64(fr + 8 * e, j) + 4 * t;
        const T* hp = reinterpret_cast<const T*>(hs + off);
        float g0, g1;
        const float d0 = acc[a] * gelu_erf_and_grad(Num<T>::to_f(hp[0]), g0);
        const float d1 = acc[a + 1] * gelu_erf_and_grad(Num<T>::to_f(hp[1]), g1);
        *reinterpret_cast<uint32_t*>(hs + off) = Num<T>::pack2(d0, d1);
        *reinterpret_cast<uint32_t*>(gs + off) = Num<T>::pack2(g0, g1);
        s0 += d0;
        s1 += d1;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == j) {
        keep0 = s0;
        keep1 = s1;
      }
    }
    hopper::named_sync(barrier, 128);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = lt + 128 * i, r = c / J, cc = c % J;
      const int row = r0 + r, col = c0 + 8 * cc;
      if (row < rows && col < n) {
        const long long at = (long long)row * n + col;
        *reinterpret_cast<uint4*>(dh + at) = *reinterpret_cast<const uint4*>(hs + staged64(r, cc));
        *reinterpret_cast<uint4*>(op.aux + at) =
            *reinterpret_cast<const uint4*>(gs + staged64(r, cc));
      }
    }
    hopper::named_sync(barrier, 128);  // gs is read: it takes the column sums
    float* sums = reinterpret_cast<float*>(gs);  // [warp][kQuarter]
    *reinterpret_cast<float2*>(sums + warp * kQuarter + 8 * g + 2 * t) =
        make_float2(keep0, keep1);
    hopper::named_sync(barrier, 128);
    // One partial row per 64 rows (r0 / 64), the warps added in order.  The
    // next quarter writes gs only after its first barrier, when these reads
    // are done.
    if (lt < kQuarter && c0 + lt < n)
      op.partial[(long long)(r0 / 64) * n + c0 + lt] =
          ((sums[lt] + sums[kQuarter + lt]) + sums[2 * kQuarter + lt]) + sums[3 * kQuarter + lt];
  }
}

template <typename T, int EPI, int WL>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap w_map, const Operands<T> op, int rows,
                      int n, int k) {
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = hopper::align1024(smem_raw);
  unsigned char* ws = as + S * ATile::kBytes;
  unsigned char* cs = ws + S * WTile::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + 2 * kStageTile);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int steps = (k + kBK - 1) / kBK, tiles_n = (n + kBN - 1) / kBN;
  const int tiles = tiles_n * ((rows + kBM - 1) / kBM);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);  // every consumer thread releases a stage
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
        for (int i = 0; i < steps; ++i, ++it) {
          const int s = it % S;
          unsigned char* w_t = ws + s * WTile::kBytes;
          hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);  // a fresh barrier passes parity 1
          hopper::mbar_expect_tx(&full[s], ATile::kBytes + WTile::kBytes);
          hopper::tma_load_head(as + s * ATile::kBytes, &a_map, &full[s], i * kBK, m0, 0, 0);
          if constexpr (WL == kWeightNK) {
            hopper::tma_load_head(w_t, &w_map, &full[s], i * kBK, n0, 0, 0);
          } else {
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c)  // columns past n arrive as zeros
              hopper::tma_load_head(w_t + c * WChunk::kBytes, &w_map, &full[s], n0 + 64 * c,
                                    i * kBK, 0, 0);
          }
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // rows 64·cw.. of each tile
  unsigned char* stage = cs + cw * kStageTile;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    for (int i = 0; i < steps; ++i, ++it) {
      const int s = it % S;
      const unsigned char* a_t = as + s * ATile::kBytes;
      const unsigned char* w_t = ws + s * WTile::kBytes;
      hopper::mbar_wait(&full[s], (it / S) & 1);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {  // the tile's first product overwrites acc
        const uint64_t a_d = ATile::kmajor(a_t, 64 * cw, 16 * kk);
        if constexpr (WL == kWeightNK)
          hopper::Wgmma<kBN, T>::ss(acc, a_d, WTile::kmajor(w_t, 0, 16 * kk), i > 0 || kk > 0);
        else
          hopper::Wgmma<kBN, T>::ss_t(acc, a_d, WChunk::mnmajor(w_t, 16 * kk), i > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // step i - 1's products are done: its stage is free
      hopper::fence_regs(acc);
      if (i > 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[(it - 1) % S]);
    const int r0 = m0 + 64 * cw;
    if constexpr (EPI == kEpiStoreF32)
      epilogue_f32(acc, stage, static_cast<float*>(op.out), r0, n0, rows, n, lt, 1 + cw);
    else if constexpr (EPI == kEpiDGelu)
      epilogue_dgelu<T>(acc, stage, op, r0, n0, rows, n, lt, 1 + cw);
    else
      epilogue<T, EPI>(acc, stage, op, r0, n0, rows, n, lt, 1 + cw);
  }
}

template <typename T, int EPI, int WL>
cudaError_t run(const void* a, const void* w, const Operands<T>& op, int rows, int n, int k,
                cudaStream_t stream) {
  constexpr int dt = hopper::dtype_of<T>();
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, gemm_wgmma_kernel<T, EPI, WL>, kSmemBytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  CUtensorMap a_map, w_map;
  if (err == cudaSuccess) err = matrix_map(&a_map, a, dt, k, rows, k, kBK, kBM);
  if (err == cudaSuccess)
    err = WL == kWeightNK ? matrix_map(&w_map, w, dt, k, n, k, kBK, kBN)   // W (n, k)
                          : matrix_map(&w_map, w, dt, n, k, n, 64, kBK);  // W (k, n)
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((n + kBN - 1) / kBN) * ((rows + kBM - 1) / kBM);
  gemm_wgmma_kernel<T, EPI, WL><<<(unsigned)(tiles < sms ? tiles : sms), kThreads, kSmemBytes,
                                  stream>>>(a_map, w_map, op, rows, n, k);
  return cudaGetLastError();
}

// The instances that exist: the forward epilogues over (n, k) weights, the
// dgrad ones over (k, n) weights.
template <typename T>
cudaError_t dispatch(const void* a, const void* w, int layout, const Operands<T>& op, int rows,
                     int n, int k, int epilogue, cudaStream_t stream) {
#define VIT_GEMM(EPI, WL) return run<T, EPI, WL>(a, w, op, rows, n, k, stream)
  if (layout == kWeightNK) {
    switch (epilogue) {
      case kEpiStore: VIT_GEMM(kEpiStore, kWeightNK);
      case kEpiBiasGelu: VIT_GEMM(kEpiBiasGelu, kWeightNK);
      case kEpiBiasResidual: VIT_GEMM(kEpiBiasResidual, kWeightNK);
      case kEpiBiasGeluSave: VIT_GEMM(kEpiBiasGeluSave, kWeightNK);
    }
  } else if (layout == kWeightKN) {
    switch (epilogue) {
      case kEpiStore: VIT_GEMM(kEpiStore, kWeightKN);
      case kEpiStoreF32: VIT_GEMM(kEpiStoreF32, kWeightKN);
      case kEpiDGelu: VIT_GEMM(kEpiDGelu, kWeightKN);
    }
  }
#undef VIT_GEMM
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

cudaError_t launch_gemm_wgmma(const void* a, const void* w, int layout, const void* bias,
                              const void* res, const void* aux_in, void* out, void* aux,
                              float* partial, int rows, int n, int k, int epilogue, int dtype,
                              cudaStream_t stream) {
  const bool needs_bias = epilogue == kEpiBiasGelu || epilogue == kEpiBiasResidual ||
                          epilogue == kEpiBiasGeluSave,
             needs_res = epilogue == kEpiBiasResidual,
             needs_aux = epilogue == kEpiBiasGeluSave || epilogue == kEpiDGelu,
             dgelu = epilogue == kEpiDGelu;
  if (k % 8 != 0 || n % 8 != 0 || k <= 0 || n <= 0 || rows < 0 || !aligned16(a) ||
      !aligned16(w) || !aligned16(out) || (needs_bias && !bias) ||
      (needs_res && !(res && aligned16(res))) || (needs_aux && !(aux && aligned16(aux))) ||
      (dgelu && !(aux_in && aligned16(aux_in) && partial)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    const Operands<T> op{static_cast<const T*>(bias), static_cast<const T*>(res),
                         static_cast<const T*>(aux_in), out, static_cast<T*>(aux), partial};
    return dispatch<T>(a, w, layout, op, rows, n, k, epilogue, stream);
  }
  if (dtype == kF16) {
    using T = __half;
    const Operands<T> op{static_cast<const T*>(bias), static_cast<const T*>(res),
                         static_cast<const T*>(aux_in), out, static_cast<T*>(aux), partial};
    return dispatch<T>(a, w, layout, op, rows, n, k, epilogue, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_forward_gemm(const void* a, const void* w, const void* bias, const void* res,
                                void* out, void* aux, int rows, int n, int k, int epilogue,
                                int dtype, cudaStream_t stream) {
  if (n < kForwardMinN)
    return launch_linear(a, w, kWeightNK, bias, res, nullptr, out, aux, nullptr, rows, n, k,
                         epilogue, dtype, stream);
  return launch_gemm_wgmma(a, w, kWeightNK, bias, res, nullptr, out, aux, nullptr, rows, n, k,
                           epilogue, dtype, stream);
}

cudaError_t launch_dgrad(const void* a, const void* w, const void* aux_in, void* out, void* aux,
                         float* partial, int rows, int n, int k, int epilogue, int dtype,
                         cudaStream_t stream) {
  if (n < kDgradMinN)
    return launch_linear(a, w, kWeightKN, nullptr, nullptr, aux_in, out, aux, partial, rows, n,
                         k, epilogue, dtype, stream);
  return launch_gemm_wgmma(a, w, kWeightKN, nullptr, nullptr, aux_in, out, aux, partial, rows,
                           n, k, epilogue, dtype, stream);
}

}  // namespace vit

// One block GEMM alone, for the card tests and the measurement that sets
// launch_forward_gemm's threshold: on this kernel (`kernel` 0) or on
// linear.cu's mma.sync one (1), which take the same layouts, epilogues and
// operands.  out (rows, n) and, for kEpiBiasGeluSave and kEpiDGelu, aux
// (rows, n) from a (rows, k), w ((n, k) for kWeightNK, (k, n) for
// kWeightKN), bias (n,), res and aux_in (rows, n) as the epilogue needs them
// (null otherwise); kEpiDGelu also writes `partial`
// (vit_linear_partial_rows(rows), n) and their column sums `sums` (n,), in
// f32.
extern "C" int vit_gemm(const void* a, const void* w, int layout, const void* bias,
                        const void* res, const void* aux_in, void* out, void* aux, float* partial,
                        float* sums, int rows, int n, int k, int epilogue, int kernel, int dtype,
                        cudaStream_t stream) {
  using namespace vit;
  if ((epilogue == kEpiDGelu && !sums) || (kernel != 0 && kernel != 1))
    return cudaErrorInvalidValue;
  cudaError_t err =
      kernel == 0 ? launch_gemm_wgmma(a, w, layout, bias, res, aux_in, out, aux, partial, rows,
                                      n, k, epilogue, dtype, stream)
                  : launch_linear(a, w, layout, bias, res, aux_in, out, aux, partial, rows, n, k,
                                  epilogue, dtype, stream);
  if (err != cudaSuccess || epilogue != kEpiDGelu || rows == 0) return err;
  return launch_colsum(partial, linear_partial_rows(rows), n, sums, stream);
}
