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
// The epilogues are linear.cu's, with its rounding points (kernels.cuh Epilogue),
// and one of its own:
//   kEpiStore         out = T(acc)                  (ln_gemm's QKV; doattn = dy·Wo)
//   kEpiBiasGelu      out = T(gelu(acc + b))        (fc1, serving)
//   kEpiBiasResidual  out = T(res + T(acc + b))     (out-proj, fc2)
//   kEpiBiasGeluSave  out = T(gelu(acc + b)), aux = h = T(acc + b), the GELU of
//                     the unrounded sum             (fc1, training)
//   kEpiStoreF32      out = acc in f32              (dxn, where the LayerNorm
//                     backward is launch_ln_bwd's passes: d outside ln_bwd_fused;
//                     over kWeightNK, a tensor-parallel block's partial
//                     out-projection or fc2, summed over the ranks outside)
//   kEpiDGelu         out = dh = T(acc·gelu'(h)), aux = gact = T(gelu(h)) from
//                     the saved h (aux_in), exact erf; per 64-row f32 column
//                     sums of the unrounded acc·gelu'(h) into `partial`, as
//                     linear.cu lays them out (linear_partial_rows), so that
//                     launch_colsum adds them in a fixed order   (dy·W2)
//   kEpiLnBwd         acc = dxn stays on chip: the LayerNorm backward of
//                     launch_ln_bwd, out = dx = T(dy + T(dx_ln)) (T(dx_ln)
//                     with no dy) and per 64-row f32 column sums [Σ dxn·xhat |
//                     Σ dxn | Σ dy] into `partial` as layernorm.cu lays them
//                     out (ln_bwd_partial_rows), on a thread-block cluster
//                     (launch_dgrad_ln_bwd: dqkv·Wqkv, dh·W1, ln_gemm's dqkv·W)
// It runs every forward GEMM of the hybrid layer (fused_hybrid.cu: ln_gemm's
// QKV, proj_mlp's out-projection, fc1 and fc2), and, through
// launch_forward_gemm, the fused MLP's fc1 and fc2 and the attention block's
// QKV and out-projection (fused_mlp.cu, fused_attention_block.cu); through
// launch_dgrad, the dgrads of those two blocks' backwards, of proj_mlp's
// backward, and the cross-attention backward's dy·Wo and dq·Wq from 129
// channels (fused_cross_attention.cu's split); through launch_dgrad_ln, the
// dgrad into each LayerNorm backward (the two blocks', proj_mlp's dh·W1 and
// ln_gemm's dqkv·W), as kEpiLnBwd where ln_bwd_fused(d) holds and as
// kEpiStoreF32 before launch_ln_bwd elsewhere.  launch_forward_gemm and
// launch_dgrad send n < 256
// to linear.cu: ScalableViT's conv-MLPs have fc2 at n = 64 and 128 and dh·W1
// at n = 64 and 128 over 262,144 and 65,536 rows, where a 256-wide tile
// computes four or two times the products (the forward's threshold is a card
// measurement at ScalableViT's four stage widths and the ViT widths,
// chip_smoke.py's forward GEMM phase: from n = 256 this kernel wins, k = 64
// included; at n = 128 the two tie, at n = 64 linear.cu wins).  linear.cu's
// mma.sync kernel keeps those narrow GEMMs and the cross-attention block's
// four-step backward's (past 128 keys).
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
// m64n256k16 (128 f32 accumulators a thread; setmaxnreg 232 at run time:
// ptxas -v reports the 168 registers the 384-thread CTA launches with, and
// allocates the consumers' code within the 232; the GELU and residual
// epilogues still spill a little), keep one k step's products
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
//
// kEpiLnBwd (the TPU kernels keep the f32 dxn in VMEM and finish the
// LayerNorm backward in the dgrad's body: fused_mlp.py _bwd_kernel :213-227,
// fused_attention_block.py _bwd_kernel :245-258, fused_hybrid.py
// _ln_gemm_bwd_kernel :125-153).  A row's statistics and its two means m1, m2
// span all d columns, which one CTA's 256-column tile does not hold, so a
// thread-block cluster of d / 256 CTAs (d % 256 == 0, 256..2048: at most 8,
// the portable size; ln_bwd_fused) takes the same 128 rows, the CTA of rank r
// columns 256·r..: the persistent loop walks row blocks by cluster, as many
// clusters as fit at once (cudaOccupancyMaxActiveClusters).  Before its k
// loop a consumer warpgroup copies its 64 x 256 tile of x into its staging
// tile (cp.async, landing under the products; 32 KB, so the ring has 3
// stages: 4 would need 256 KB with the two x tiles) and fetches dy's rows
// into L2.  Its epilogue (epilogue_ln) makes each row's four partials over
// the tile's columns in one pass, swaps them with the cluster through
// distributed shared memory (a slot per warpgroup, mbarriers that peers
// arrive on: `xfull` when every slot is written, `xempty` when every peer
// has read it, so the hardware cluster barrier, which would also wait on the
// producer thread running ahead, is needed only at the start), then writes
// dx and the column partials a quarter at a time while the next quarter's dy
// loads.  No f32 dxn and no row statistics reach device memory: at ViT-B/32's
// layer the traffic is x, dy, dx and the partials (about 51 MB) where the
// f32 path moves about 188 MB.  The accumulators are zeroed at each tile's
// start, so that they die in the epilogue and free its registers.
#include "hopper.cuh"

#include <atomic>

namespace vit {
namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kThreads = 384;              // producer warpgroup + two consumer warpgroups
constexpr int kHalf = 128;                 // output columns of a bf16 epilogue pass
constexpr int kQuarter = 64;               // output columns of an f32 or dGELU pass
constexpr int kStageTile = 64 * kHalf * 2;  // a consumer warpgroup's staging tile (bytes)
constexpr int kDgradMinN = 256;            // launch_dgrad's narrowest n on this kernel
constexpr int kForwardMinN = 256;          // launch_forward_gemm's
// kEpiLnBwd: widths d / kBN CTAs a cluster can split, at most 8 (the portable size).
constexpr int kLnBwdMinD = 256, kLnBwdMaxD = 2048;
constexpr int kLnTile = 64 * kBN * 2;       // a consumer warpgroup's x tile, then dx (bytes)
constexpr int kLnSlot = 64 * 16;            // its rows' four f32 partials, read by the cluster
constexpr int kLnScratch = 2 * 3 * 4 * kQuarter * 4;  // its warps' column sums, two quarters
constexpr int kLnGamma = kBN * 2;           // its copy of gamma's 256 columns

using ATile = hopper::Tile<kBM, kBK>;
using WTile = hopper::Tile<kBN, kBK>;   // kWeightNK: 256 rows (n) of 64 k
using WChunk = hopper::Tile<kBK, 64>;   // kWeightKN: 64 rows (k) of 64 n, four a stage
static_assert(4 * WChunk::kBytes == WTile::kBytes, "a stage holds the same W either way");

// The ring's depth and a consumer warpgroup's staging tile: kEpiLnBwd stages
// the whole 64 x 256 x tile, which leaves room for three stages.
template <int EPI>
__host__ __device__ constexpr int ring_stages() {
  return EPI == kEpiLnBwd ? 3 : 4;
}
template <int EPI>
__host__ __device__ constexpr int stage_bytes() {
  return EPI == kEpiLnBwd ? kLnTile : kStageTile;
}
// Bytes past the staging tiles before the barriers: kEpiLnBwd's slots,
// scratch and gamma.
template <int EPI>
__host__ __device__ constexpr int ln_bytes() {
  return EPI == kEpiLnBwd ? 2 * (kLnSlot + kLnScratch + kLnGamma) : 0;
}
// The ring of A and W tiles, the two staging tiles, kEpiLnBwd's slots and
// scratch, the full/empty barriers (and kEpiLnBwd's four), alignment.
template <int EPI>
__host__ __device__ constexpr int smem_bytes() {
  return ring_stages<EPI>() * (ATile::kBytes + WTile::kBytes) + 2 * stage_bytes<EPI>() +
         ln_bytes<EPI>() + (2 * ring_stages<EPI>() + 4) * 8 + 1024;
}
static_assert(smem_bytes<kEpiStore>() <= 232448, "more shared memory than a CTA may have");
static_assert(smem_bytes<kEpiLnBwd>() <= 232448, "more shared memory than a CTA may have");

// What an epilogue reads and writes besides the accumulators; unused ones are null.
template <typename T>
struct Operands {
  const T* bias;    // (n,)
  const T* res;     // (rows, n) residual; kEpiLnBwd: dy, or null
  const T* aux_in;  // (rows, n) saved pre-activation h (kEpiDGelu); kEpiLnBwd: x
  void* out;        // (rows, n): T, or f32 for kEpiStoreF32; kEpiLnBwd: dx
  T* aux;           // (rows, n): h (kEpiBiasGeluSave), gact (kEpiDGelu)
  float* partial;   // (linear_partial_rows(rows), n) column sums of dh (kEpiDGelu);
                    // kEpiLnBwd: (ln_bwd_partial_rows(rows), 3·n) [Σ dxn·xhat | Σ dxn | Σ dy]
  const T* gamma;   // (n,) kEpiLnBwd
  float eps;        // kEpiLnBwd
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

// kEpiLnBwd's x tile: 64 rows of 256 columns, 512-byte rows whose 16-byte
// chunks are XOR-swizzled by row, so that the fragment's 4-byte reads and
// writes (8 rows x 4 lanes a chunk column) and the rows' 16-byte pieces are
// free of bank conflicts.  Byte offset of chunk c of row r.
__device__ __forceinline__ int ln_at(int r, int c) { return r * kBN * 2 + ((c ^ (r & 7)) << 4); }

// The sum over the four lanes of a quad (one fragment row's 256 columns).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// kEpiLnBwd, before the tile's k loop: its warpgroup's rows r0.. of x,
// columns n0.., into the staging tile by cp.async (rows past `rows` as
// zeros), landing while the products run; and dy's rows fetched into L2.
template <typename T>
__device__ __forceinline__ void ln_load_x(unsigned char* stage, const Operands<T>& op, int r0,
                                          int n0, int rows, int n, int lt) {
  const int cc = lt % 32;  // every row of a thread's pieces is at chunk cc
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = lt / 32 + 4 * i, row = r0 + r;
    const long long at = (long long)(row < rows ? row : 0) * n + n0 + 8 * cc;
    cp_async16(stage + ln_at(r, cc), op.aux_in + at, row < rows);
  }
  cp_async_commit();
  if (op.res)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 64 rows of four 128-byte lines
      const int line = lt + 128 * h, row = r0 + line / 4;
      if (row < rows)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(op.res + (long long)row * n + n0 +
                                                        64 * (line % 4)));
    }
}

// Two values of T packed in 32 bits, as floats.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t raw) {
  const T* p = reinterpret_cast<const T*>(&raw);
  return make_float2(Num<T>::to_f(p[0]), Num<T>::to_f(p[1]));
}

// kEpiLnBwd: the LayerNorm backward of launch_ln_bwd over a consumer
// warpgroup's 64 rows, from its accumulators dxn = A·W (columns n0..n0+255),
// the x tile and gamma ln_load_x staged, and the row partials of the
// cluster's other column tiles.  A thread holds rows fr and fr + 8, 64
// columns of each; per row and tile:
//   1. one pass over x: with K the row's first x in the tile and c = x - K,
//      s1 = Σ c, s2 = Σ c², D1 = Σ dxhat, DK = Σ dxhat·c (dxhat = dxn·gamma),
//      summed by the thread and its quad; hence the tile's S = 256·K + s1,
//      its mean_t = K + s1 / 256, M2 = s2 - s1² / 256 (the shifted-data
//      form of Σ (x - mean_t)², K a value of the row) and D2 = Σ dxhat·(x -
//      mean_t) = DK - (s1 / 256)·D1;
//   2. the exchange: (S, M2, D1, D2) into the CTA's slot, one arrival on each
//      cluster CTA's `xfull`; once the slots of all are in, the row's mean =
//      ΣS / n, rstd = rsqrt((Σ M2 + 256·(mean_t - mean)²) / n + eps) (the
//      biased variance of the tiles joined exactly), m1 = Σ D1 / n and m2 =
//      rstd·Σ (D2 + (mean_t - mean)·D1) / n, in one fixed order; then one
//      arrival on each CTA's `xempty`: its slot has been read;
//   3. dx_ln = rstd·(dxhat - m1 - xhat·m2), T(dx_ln) staged over x, and the
//      64-row column sums Σ dxn·xhat, Σ dxn into `partial`;
//   4. dx = T(dy + T(dx_ln)) (T(dx_ln) with no dy) stored in 16-byte pieces,
//      and the 64-row column sums of dy;
//   3 and 4 a quarter (64 columns) at a time, the next quarter's dy loading
//   meanwhile.
// The slot is written only once `xempty` says the cluster has read the last
// tile's values.  No atomics: every sum, and so dx, repeats bit for bit.
template <typename T>
__device__ __forceinline__ void epilogue_ln(const float (&acc)[kBN / 2], unsigned char* stage,
                                            float* slot, float* scratch,
                                            const unsigned char* gamma_s, uint64_t* xfull,
                                            uint64_t* xempty, const Operands<T>& op, int r0,
                                            int n0, int rows, int n, int lt, int barrier,
                                            int csize, int done) {
  const int warp = lt / 32, g = (lt % 32) / 4, t = lt % 4, fr = warp * 16 + g;
  // x's pair at (row fr + 8e, chunk j), where T(dx_ln) goes too; gamma's.
  auto xat = [&](int e, int j) { return stage + ln_at(fr + 8 * e, j) + 4 * t; };
  auto xpair = [&](int e, int j) {
    return unpack2<T>(*reinterpret_cast<const uint32_t*>(xat(e, j)));
  };
  auto gamma2 = [&](int j) {
    return unpack2<T>(*reinterpret_cast<const uint32_t*>(gamma_s + 16 * j + 4 * t));
  };
  cp_async_wait<0>();
  hopper::named_sync(barrier, 128);  // the x tile is in

  float part[2][4];  // per row: S, M2, D1, D2
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float k0 = Num<T>::to_f(*reinterpret_cast<const T*>(stage + ln_at(fr + 8 * e, 0)));
    float s1 = 0.f, s2 = 0.f, d1 = 0.f, dk = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 v = xpair(e, j), gm = gamma2(j);
      const int a = 4 * j + 2 * e;
      const float c0 = v.x - k0, c1 = v.y - k0;
      const float h0 = acc[a] * gm.x, h1 = acc[a + 1] * gm.y;
      s1 += c0 + c1;
      s2 += c0 * c0 + c1 * c1;
      d1 += h0 + h1;
      dk += h0 * c0 + h1 * c1;
    }
    s1 = quad_sum(s1);
    d1 = quad_sum(d1);
    const float sh = s1 * (1.f / kBN);
    part[e][0] = kBN * k0 + s1;
    part[e][1] = fmaxf(quad_sum(s2) - s1 * sh, 0.f);
    part[e][2] = d1;
    part[e][3] = quad_sum(dk) - sh * d1;
  }

  // The exchange.
  hopper::mbar_wait_cluster(xempty, (done & 1) ^ 1);  // a fresh barrier passes parity 1
  if (t == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(slot + 4 * (fr + 8 * e)) =
          make_float4(part[e][0], part[e][1], part[e][2], part[e][3]);
  hopper::named_sync(barrier, 128);
  if (lt < csize) hopper::mbar_arrive_peer(xfull, lt);
  hopper::mbar_wait_cluster(xfull, done & 1);
  // Lane t of a quad reads ranks t and t + 4 (each of its two rows), and the
  // quad adds them in one fixed order, ((r0 + r4) + (r1 + r5)) + ((r2 + r6)
  // + (r3 + r7)), the same in every lane and run.
  const float inv_n = 1.f / n;
  float mean[2], rstd[2], m1[2], m2[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float4 p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      p[h] = t + 4 * h < csize
                 ? hopper::ld_peer_f4(hopper::map_peer(slot + 4 * (fr + 8 * e), t + 4 * h))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    mean[e] = quad_sum(p[0].x + p[1].x) * inv_n;
    m1[e] = quad_sum(p[0].z + p[1].z) * inv_n;
    float q = 0.f, dd = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (t + 4 * h < csize) {
        const float dm = p[h].x * (1.f / kBN) - mean[e];
        q += p[h].y + kBN * dm * dm;
        dd += p[h].w + dm * p[h].z;
      }
    }
    rstd[e] = rsqrtf(quad_sum(q) * inv_n + op.eps);
    m2[e] = rstd[e] * quad_sum(dd) * inv_n;
  }

  hopper::named_sync(barrier, 128);  // the warpgroup has read the cluster's slots
  if (lt < csize) hopper::mbar_arrive_peer(xempty, lt);

  // Steps 3 and 4 a quarter (8 chunks, 64 columns) at a time: T(dx_ln) of
  // quarter q over x, then its dx stored in 16-byte pieces (thread lt: chunk
  // lt % 8 of rows lt / 8 + 16i) from dy's pieces, which load while the
  // quarter before is stored and this one computed.  The column sums of a
  // quarter: quad-row butterflies for Σ dxn·xhat and Σ dxn, shuffles over
  // the rows of a chunk for Σ dy, then the four warps in order through
  // `scratch`, whose two halves alternate by quarter, so one barrier a
  // quarter keeps them apart (Σ dy's are added after the next one).
  const int pw = (op.res ? 3 : 2) * n;  // a partial row: [Σ dxn·xhat | Σ dxn (| Σ dy)]
  float* prow = op.partial + (long long)(r0 / 64) * pw;
  T* dx = static_cast<T*>(op.out);
  constexpr int J = kQuarter / 8, P = 64 * J / 128;  // chunks a quarter, pieces a thread
  const int pc = lt % J;                              // a thread's chunk in each quarter
  uint4 dyv[P];
  auto load_dy = [&](int q) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int row = r0 + lt / J + 16 * i;
      dyv[i] = op.res && row < rows
                   ? __ldg(reinterpret_cast<const uint4*>(op.res + (long long)row * n + n0 +
                                                          kQuarter * q + 8 * pc))
                   : make_uint4(0, 0, 0, 0);
    }
  };
  auto add_dy_sums = [&](int q) {  // Σ dy of quarter q, from the warps' sums in scratch
    const float* ys = scratch + (q % 2) * 3 * 4 * kQuarter + 2 * 4 * kQuarter;
    if (op.res && r0 < rows && lt < kQuarter)
      prow[2 * n + n0 + kQuarter * q + lt] =
          ((ys[lt] + ys[kQuarter + lt]) + ys[2 * kQuarter + lt]) + ys[3 * kQuarter + lt];
  };
  load_dy(0);
  const bool b0 = g & 1, b1 = (g >> 1) & 1;
#pragma unroll
  for (int q = 0; q < kBN / kQuarter; ++q) {
    float* sums = scratch + (q % 2) * 3 * 4 * kQuarter;  // [Σ dxn·xhat, Σ dxn, Σ dy][warp][64]
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {  // four chunks
      // x's and gamma's pairs loaded first: each store of T(dx_ln) over x
      // would otherwise hold back the loads after it.
      uint32_t xr[4][2], gr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = J * q + 4 * hq + c;
        gr[c] = *reinterpret_cast<const uint32_t*>(gamma_s + 16 * j + 4 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) xr[c][e] = *reinterpret_cast<const uint32_t*>(xat(e, j));
      }
      float v4[4][4];  // [chunk][Σ dxn·xhat, its pair's; Σ dxn, its pair's] of two rows
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = J * q + 4 * hq + c;
        const float2 gm = unpack2<T>(gr[c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) v4[c][i] = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 v = unpack2<T>(xr[c][e]);
          const int a = 4 * j + 2 * e;
          const float xh0 = (v.x - mean[e]) * rstd[e], xh1 = (v.y - mean[e]) * rstd[e];
          const float f0 = rstd[e] * (acc[a] * gm.x - m1[e] - xh0 * m2[e]);
          const float f1 = rstd[e] * (acc[a + 1] * gm.y - m1[e] - xh1 * m2[e]);
          *reinterpret_cast<uint32_t*>(xat(e, j)) = Num<T>::pack2(f0, f1);
          v4[c][0] += acc[a] * xh0;
          v4[c][1] += acc[a + 1] * xh1;
          v4[c][2] += acc[a];
          v4[c][3] += acc[a + 1];
        }
      }
      // Over the warp's 8 row groups g by a transposing reduction: lanes g
      // and g ^ 1 swap half their chunks and add, then g and g ^ 2, then g
      // and g ^ 4 add their one value; lane (g, t) ends with chunk 2·(g & 1)
      // + ((g >> 1) & 1) (8 shuffles a sum where a butterfly per chunk takes
      // 12).  Selects, not indices, keep the arrays in registers.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float w2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          w2[c] = (b0 ? v4[c + 2][i] : v4[c][i]) +
                  __shfl_xor_sync(0xffffffffu, b0 ? v4[c][i] : v4[c + 2][i], 4);
        float w1 = (b1 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, b1 ? w2[0] : w2[1], 8);
        w1 += __shfl_xor_sync(0xffffffffu, w1, 16);
        if (g < 4)  // lanes g and g + 4 hold the same sums
          sums[(4 * (i / 2) + warp) * kQuarter + 8 * (4 * hq + 2 * b0 + b1) + 2 * t + i % 2] = w1;
      }
    }
    hopper::named_sync(barrier, 128);  // quarter q is staged; its sums are in
    if (r0 < rows) {  // lanes 0..63 dγ's columns, 64..127 dβ's
      const float* s4 = sums + (lt / kQuarter) * 4 * kQuarter + lt % kQuarter;
      prow[(lt / kQuarter) * n + n0 + kQuarter * q + lt % kQuarter] =
          ((s4[0] + s4[kQuarter]) + s4[2 * kQuarter]) + s4[3 * kQuarter];
    }
    if (q > 0) add_dy_sums(q - 1);
    float sy[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int r = lt / J + 16 * i, row = r0 + r;
      uint4 v = *reinterpret_cast<const uint4*>(stage + ln_at(r, J * q + pc));
      if (op.res) {
        v = add8<T>(v, dyv[i]);
        const T* y = reinterpret_cast<const T*>(&dyv[i]);
#pragma unroll
        for (int c = 0; c < 8; ++c) sy[c] += Num<T>::to_f(y[c]);
      }
      if (row < rows)
        *reinterpret_cast<uint4*>(dx + (long long)row * n + n0 + kQuarter * q + 8 * pc) = v;
    }
    if (q + 1 < kBN / kQuarter) load_dy(q + 1);
    if (op.res) {  // the warp's 16 rows of chunk pc, lanes pc + 8s, transposed as above
      const bool s0 = (lt >> 3) & 1, s1 = (lt >> 4) & 1;
      float w4[4], u2[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w4[i] = (s0 ? sy[i + 4] : sy[i]) + __shfl_xor_sync(0xffffffffu, s0 ? sy[i] : sy[i + 4], 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        u2[i] = (s1 ? w4[i + 2] : w4[i]) +
                __shfl_xor_sync(0xffffffffu, s1 ? w4[i] : w4[i + 2], 16);
      *reinterpret_cast<float2*>(sums + (8 + warp) * kQuarter + 8 * pc + 4 * s0 + 2 * s1) =
          make_float2(u2[0], u2[1]);
    }
  }
  hopper::named_sync(barrier, 128);
  add_dy_sums(kBN / kQuarter - 1);
  hopper::named_sync(barrier, 128);  // the staging tile and scratch are free again
}

template <typename T, int EPI, int WL>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap w_map, const Operands<T> op, int rows,
                      int n, int k) {
  constexpr int S = ring_stages<EPI>();
  constexpr bool kLn = EPI == kEpiLnBwd;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = hopper::align1024(smem_raw);
  unsigned char* ws = as + S * ATile::kBytes;
  unsigned char* cs = ws + S * WTile::kBytes;
  float* slots = reinterpret_cast<float*>(cs + 2 * stage_bytes<EPI>());  // kEpiLnBwd
  float* scratch = slots + 2 * kLnSlot / 4;                               // kEpiLnBwd
  unsigned char* gammas = reinterpret_cast<unsigned char*>(scratch + 2 * kLnScratch / 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + 2 * stage_bytes<EPI>() + ln_bytes<EPI>());
  uint64_t* empty = full + S;
  uint64_t* xfull = empty + S;   // kEpiLnBwd, per consumer warpgroup: the cluster's slots are in
  uint64_t* xempty = xfull + 2;  // ... and the cluster has read this CTA's slot

  // The tiles: every 128 x 256 output tile, row-major; with kEpiLnBwd a
  // cluster of n / 256 CTAs walks the row blocks, each CTA the column tile of
  // its rank, so that the CTAs of a cluster always hold the same rows.
  const int csize = kLn ? n / kBN : 1;
  const int rank = kLn ? (int)hopper::cluster_ctarank() : 0;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int steps = (k + kBK - 1) / kBK, tiles_n = kLn ? 1 : (n + kBN - 1) / kBN;
  const int tiles = tiles_n * ((rows + kBM - 1) / kBM);
  const int first = blockIdx.x / csize, stride = gridDim.x / csize;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);  // every consumer thread releases a stage
    }
    if (kLn)
      for (int c = 0; c < 4; ++c) hopper::mbar_init(&xfull[c], csize);  // xfull, xempty
    hopper::mbar_init_fence();
  }
  if constexpr (kLn) {  // the peers' barriers are ready before any arrival on them
    hopper::cluster_arrive();
    hopper::cluster_wait();
  } else {
    __syncthreads();
  }

  if (wg == 0) {  // the producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      int it = 0;
      for (int tile = first; tile < tiles; tile += stride) {
        const int m0 = tile / tiles_n * kBM, n0 = (kLn ? rank : tile % tiles_n) * kBN;
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
  unsigned char* stage = cs + cw * stage_bytes<EPI>();
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  unsigned char* gamma_s = gammas + cw * kLnGamma;  // kEpiLnBwd: its columns, rank·256..
  if (kLn && lt < kLnGamma / 16)  // lands with the first tile's x
    cp_async16(gamma_s + 16 * lt, op.gamma + rank * kBN + 8 * lt, true);
  int it = 0, done = 0;
  for (int tile = first; tile < tiles; tile += stride, ++done) {
    const int m0 = tile / tiles_n * kBM, n0 = (kLn ? rank : tile % tiles_n) * kBN;
    const int r0 = m0 + 64 * cw;
    if constexpr (kLn) {
      ln_load_x<T>(stage, op, r0, n0, rows, n, lt);
      // The last tile's values die in its epilogue, freeing their registers
      // there, rather than live on into this tile's first product.
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    }
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
    if constexpr (EPI == kEpiLnBwd)
      epilogue_ln<T>(acc, stage, slots + cw * kLnSlot / 4, scratch + cw * kLnScratch / 4,
                     gamma_s, &xfull[cw], &xempty[cw], op, r0, n0, rows, n, lt, 1 + cw, csize,
                     done);
    else if constexpr (EPI == kEpiStoreF32)
      epilogue_f32(acc, stage, static_cast<float*>(op.out), r0, n0, rows, n, lt, 1 + cw);
    else if constexpr (EPI == kEpiDGelu)
      epilogue_dgelu<T>(acc, stage, op, r0, n0, rows, n, lt, 1 + cw);
    else
      epilogue<T, EPI>(acc, stage, op, r0, n0, rows, n, lt, 1 + cw);
  }
  // kEpiLnBwd: the cluster has read this CTA's last slot, and its arrivals
  // here are in: the CTA's shared memory may go.
  if (kLn && done > 0) hopper::mbar_wait_cluster(&xempty[cw], (done & 1) ^ 1);
}

// How many clusters of csize CTAs of kEpiLnBwd's instance over T the
// current device runs at once (queried once per host thread, device and size).
template <typename T>
cudaError_t ln_clusters(int csize, int* clusters) {
  constexpr int smem = smem_bytes<kEpiLnBwd>();
  const auto kernel = gemm_wgmma_kernel<T, kEpiLnBwd, kWeightKN>;
  constexpr int sizes = kLnBwdMaxD / kBN + 1;
  thread_local int ready = -1, fits_on[sizes] = {-1, -1, -1, -1, -1, -1, -1, -1, -1}, fits[sizes];
  static_assert(sizes == 9, "one device index per cluster size");
  int device = 0;
  cudaError_t err = prepare_kernel(ready, kernel, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess && fits_on[csize] != device) {
    err = max_active_clusters(&fits[csize], kernel, csize, kThreads, smem);
    if (err == cudaSuccess) fits_on[csize] = device;
  }
  *clusters = fits[csize];
  return err;
}

template <typename T, int EPI, int WL>
cudaError_t run(const void* a, const void* w, const Operands<T>& op, int rows, int n, int k,
                cudaStream_t stream) {
  constexpr int dt = hopper::dtype_of<T>(), smem = smem_bytes<EPI>();
  const auto kernel = gemm_wgmma_kernel<T, EPI, WL>;
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, kernel, smem);
  CUtensorMap a_map, w_map;
  if (err == cudaSuccess) err = matrix_map(&a_map, a, dt, k, rows, k, kBK, kBM);
  if (err == cudaSuccess)
    err = WL == kWeightNK ? matrix_map(&w_map, w, dt, k, n, k, kBK, kBN)   // W (n, k)
                          : matrix_map(&w_map, w, dt, n, k, n, 64, kBK);  // W (k, n)
  if (err != cudaSuccess) return err;
  const long long row_blocks = (rows + kBM - 1) / kBM;
  if constexpr (EPI == kEpiLnBwd) {  // clusters of n / 256 CTAs, as many as fit at once
    const int csize = n / kBN;
    int fit = 0;
    err = ln_clusters<T>(csize, &fit);
    if (err != cudaSuccess) return err;
    const int clusters = fit < row_blocks ? fit : (int)row_blocks;
    if (clusters <= 0) return cudaErrorInvalidConfiguration;
    err = launch_cluster(kernel, clusters, csize, kThreads, smem, stream, a_map, w_map, op, rows,
                         n, k);
    if (err == cudaSuccess) {
      count_launch(kCountGemmWgmma);
      count_launch(kCountLnEpilogue);
    }
    return err;
  } else {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long tiles = (long long)((n + kBN - 1) / kBN) * row_blocks;
    kernel<<<(unsigned)(tiles < sms ? tiles : sms), kThreads, smem, stream>>>(a_map, w_map, op,
                                                                             rows, n, k);
    err = cudaGetLastError();
    if (err == cudaSuccess) count_launch(kCountGemmWgmma);
    return err;
  }
}

// The instances that exist: the forward epilogues over (n, k) weights (and
// the f32 store, a split block's partial sum), the dgrad ones over (k, n)
// weights.
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
      case kEpiStoreF32: VIT_GEMM(kEpiStoreF32, kWeightNK);
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

template <typename T>
cudaError_t dgrad_ln_bwd_t(const void* a, const void* w, const void* x, const void* gamma,
                           const void* dy, void* dx, float* partial, int rows, int d, int k,
                           float eps, cudaStream_t stream) {
  const Operands<T> op{nullptr, static_cast<const T*>(dy), static_cast<const T*>(x), dx,
                       nullptr, partial, static_cast<const T*>(gamma), eps};
  return run<T, kEpiLnBwd, kWeightKN>(a, w, op, rows, d, k, stream);
}

std::atomic<long long> launch_counts[kCounted];

}  // namespace

void count_launch(int which) { launch_counts[which].fetch_add(1, std::memory_order_relaxed); }

bool ln_bwd_fused(int d) { return d % kBN == 0 && d >= kLnBwdMinD && d <= kLnBwdMaxD; }

cudaError_t launch_dgrad_ln_bwd(const void* a, const void* w, const void* x, const void* gamma,
                                const void* dy, void* dx, float* partial, float* sums, int rows,
                                int d, int k, float eps, int dtype, cudaStream_t stream) {
  if (!ln_bwd_fused(d) || k % 8 != 0 || k <= 0 || rows <= 0 || !aligned16(a) || !aligned16(w) ||
      !aligned16(x) || !aligned16(dx) || (dy && !aligned16(dy)) || !gamma ||
      (reinterpret_cast<uintptr_t>(gamma) & 3) || !partial || !sums)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16)
    err = dgrad_ln_bwd_t<__nv_bfloat16>(a, w, x, gamma, dy, dx, partial, rows, d, k, eps, stream);
  else if (dtype == kF16)
    err = dgrad_ln_bwd_t<__half>(a, w, x, gamma, dy, dx, partial, rows, d, k, eps, stream);
  if (err != cudaSuccess) return err;
  return launch_colsum(partial, ln_bwd_partial_rows(rows), (dy ? 3 : 2) * d, sums, stream);
}

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
  const cudaError_t err =
      n < kForwardMinN
          ? launch_linear(a, w, kWeightNK, bias, res, nullptr, out, aux, nullptr, rows, n, k,
                          epilogue, dtype, stream)
          : launch_gemm_wgmma(a, w, kWeightNK, bias, res, nullptr, out, aux, nullptr, rows, n, k,
                              epilogue, dtype, stream);
  if (err == cudaSuccess && epilogue == kEpiStoreF32) count_launch(kCountForwardF32);
  return err;
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

cudaError_t launch_dgrad_ln(const void* a, const void* w, const void* x, const void* gamma,
                            const void* dy, void* dx, float* dxn, float* stats, float* partial,
                            float* sums, int rows, int d, int k, float eps, int dtype,
                            cudaStream_t stream) {
  if (ln_bwd_fused(d))
    return launch_dgrad_ln_bwd(a, w, x, gamma, dy, dx, partial, sums, rows, d, k, eps, dtype,
                               stream);
  if (!dxn || !stats) return cudaErrorInvalidValue;
  const cudaError_t err = launch_dgrad(a, w, nullptr, dxn, nullptr, nullptr, rows, d, k,
                                       kEpiStoreF32, dtype, stream);
  if (err != cudaSuccess) return err;
  return launch_ln_bwd(x, dxn, gamma, dy, dx, stats, partial, sums, rows, d, eps, dtype, stream);
}

}  // namespace vit

// The LayerNorm-backward dgrad alone (launch_dgrad_ln_bwd), for the card
// tests: dx (rows, d) and sums [dγ | dβ | Σ dy] (3·d,), or [dγ | dβ] with a
// null dy, from a (rows, k), w (k, d), x (rows, d), gamma (d,); `partial`
// (vit_ln_bwd_partial_rows(rows), 3·d) f32 scratch.
extern "C" int vit_gemm_ln_bwd(const void* a, const void* w, const void* x, const void* gamma,
                               const void* dy, void* dx, float* partial, float* sums, int rows,
                               int d, int k, float eps, int dtype, cudaStream_t stream) {
  return vit::launch_dgrad_ln_bwd(a, w, x, gamma, dy, dx, partial, sums, rows, d, k, eps, dtype,
                                  stream);
}

// How many clusters launch_dgrad_ln_bwd's kernel runs at once at width d on
// the current device (its grid is that many, or the row blocks if fewer).
extern "C" int vit_ln_bwd_clusters(int d) {
  int clusters = 0;
  if (!vit::ln_bwd_fused(d) || vit::ln_clusters<__nv_bfloat16>(d / vit::kBN, &clusters))
    return -1;
  return clusters;
}

// The launches of one Counted kind (kernels.cuh) since the last take of it,
// its count set back to 0; -1 for no such kind.
extern "C" long long vit_take_launch_count(int which) {
  if (which < 0 || which >= vit::kCounted) return -1;
  return vit::launch_counts[which].exchange(0, std::memory_order_relaxed);
}

// Whether the blocks' backwards take launch_dgrad_ln_bwd at width d (1) or
// launch_dgrad's f32 dxn and launch_ln_bwd (0).
extern "C" int vit_ln_bwd_fused(int d) { return vit::ln_bwd_fused(d) ? 1 : 0; }

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
