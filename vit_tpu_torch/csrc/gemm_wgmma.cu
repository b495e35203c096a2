// Row-major GEMM on Hopper's warpgroup MMA with fused epilogues, fed by a TMA
// ring from a producer warp:
//   out (rows, n) = epi(A (rows, k) · Wᵀ),  W (n, k) an nn.Linear weight,
// A and W k-contiguous (both K-major, wgmma's shared-operand case with no
// transpose), f32 accumulation.  The epilogues are linear.cu's first four, with
// its rounding points (csrc/kernels.cuh Epilogue):
//   kEpiStore         out = T(acc)                                (ln_gemm's QKV)
//   kEpiBiasGelu      out = T(gelu(acc + b))                      (fc1, serving)
//   kEpiBiasResidual  out = T(res + T(acc + b))                   (out-proj, fc2)
//   kEpiBiasGeluSave  out = T(gelu(acc + b)), aux = h = T(acc + b), the GELU of
//                     the unrounded sum                           (fc1, training)
// It runs every forward GEMM of the hybrid layer (fused_hybrid.cu: ln_gemm's
// QKV, proj_mlp's out-projection, fc1 and fc2); linear.cu's mma.sync kernel
// keeps the block kernels' GEMMs and every backward one.
//
// Bound on the H100: at ViT-B/32's hybrid layer (8320 rows, d 1024, inner
// 1024, hidden 2048, bf16) proj_mlp's three GEMMs are 87.2 GFLOP (0.088 ms at
// 989 TFLOP/s) against 76 MB of operands and outputs (0.023 ms at 3.35 TB/s):
// the tensor cores bound them, and the design keeps them fed.
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
// fragment in two 64 x 128 halves into a 16 KB staging tile of its own (16-byte
// chunks XOR-swizzled by row, so the fragment's 4-byte writes and the 16-byte
// reads are free of bank conflicts), with the bias (a column pair a load) and
// the GELU applied in registers, then stores it row by row in coalesced
// 16-byte pieces, reading the residual the same way; stores past `rows` or n
// are skipped (n % 8 == 0: a piece is all in or all out).  The
// 4-stage ring (192 KB) and the two staging tiles (32 KB) fill the 227 KB a
// CTA may have; a 3-stage ring with whole 64 x 256 staging tiles, the
// alternative, ran slower on the H100 (PERF.md).
#include "hopper.cuh"

namespace vit {
namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 384;              // producer warpgroup + two consumer warpgroups
constexpr int kHalf = 128;                 // output columns of one epilogue pass
constexpr int kStageTile = 64 * kHalf * 2;  // a consumer warpgroup's staging tile (bytes)

using ATile = hopper::Tile<kBM, kBK>;
using WTile = hopper::Tile<kBN, kBK>;

// The ring of A and W tiles, the two staging tiles, the full/empty barriers, alignment.
constexpr int kSmemBytes =
    kStages * (ATile::kBytes + WTile::kBytes) + 2 * kStageTile + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a CTA may have");

// Byte offset of 16-byte chunk c of row r in a staging tile (kHalf columns a row).
__device__ __forceinline__ int staged(int r, int c) { return r * kHalf * 2 + ((c ^ (r & 7)) << 4); }

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

// One consumer warpgroup's epilogue: its 64 x 256 fragment (rows r0.., columns
// n0..) through its staging tile, kHalf columns at a time; kEpiBiasGeluSave
// stages and stores h, then g (the accumulators die as the GELU pass reads
// them, as in kEpiBiasGelu, rather than live through it).  The bias pairs of a pass and the residual's
// pieces are loaded together before they are used (read-only loads: the
// epilogue never writes them), so their latencies overlap.
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[kBN / 2], unsigned char* stage,
                                         const T* __restrict__ bias, const T* __restrict__ res,
                                         T* __restrict__ out, T* __restrict__ aux, int r0, int n0,
                                         int rows, int n, int lt, int barrier) {
  constexpr int passes = EPI == kEpiBiasGeluSave ? 2 : 1, J = kHalf / 8, P = 64 * J / 128;
  const int fr = (lt / 32) * 16 + (lt % 32) / 4, t = lt % 4;
#pragma unroll
  for (int hf = 0; hf < kBN / kHalf; ++hf) {
    uint32_t bias2[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = n0 + kHalf * hf + 8 * j + 2 * t;
      bias2[j] = EPI != kEpiStore && col < n
                     ? __ldg(reinterpret_cast<const unsigned int*>(bias + col)) : 0u;
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
      T* dst = EPI == kEpiBiasGeluSave && pass == 0 ? aux : out;
      uint4 rv[P];
      if (EPI == kEpiBiasResidual) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int c = lt + 128 * i, row = r0 + c / J, col = n0 + kHalf * hf + 8 * (c % J);
          rv[i] = row < rows && col < n
                      ? __ldg(reinterpret_cast<const uint4*>(res + (long long)row * n + col))
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

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap w_map, const T* __restrict__ bias,
                      const T* __restrict__ res, T* __restrict__ out, T* __restrict__ aux,
                      int rows, int n, int k) {
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
          hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);  // a fresh barrier passes parity 1
          hopper::mbar_expect_tx(&full[s], ATile::kBytes + WTile::kBytes);
          hopper::tma_load_head(as + s * ATile::kBytes, &a_map, &full[s], i * kBK, m0, 0, 0);
          hopper::tma_load_head(ws + s * WTile::kBytes, &w_map, &full[s], i * kBK, n0, 0, 0);
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
      for (int kk = 0; kk < kBK / 16; ++kk)  // the tile's first product overwrites acc
        hopper::Wgmma<kBN, T>::ss(acc, ATile::kmajor(a_t, 64 * cw, 16 * kk),
                                  WTile::kmajor(w_t, 0, 16 * kk), i > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // step i - 1's products are done: its stage is free
      hopper::fence_regs(acc);
      if (i > 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[(it - 1) % S]);
    epilogue<T, EPI>(acc, stage, bias, res, out, aux, m0 + 64 * cw, n0, rows, n, lt, 1 + cw);
  }
}

template <typename T, int EPI>
cudaError_t run(const void* a, const void* w, const void* bias, const void* res, void* out,
                void* aux, int rows, int n, int k, cudaStream_t stream) {
  constexpr int dt = hopper::dtype_of<T>();
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, gemm_wgmma_kernel<T, EPI>, kSmemBytes);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  CUtensorMap a_map, w_map;
  if (err == cudaSuccess) err = matrix_map(&a_map, a, dt, k, rows, k, kBK, kBM);
  if (err == cudaSuccess) err = matrix_map(&w_map, w, dt, k, n, k, kBK, kBN);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((n + kBN - 1) / kBN) * ((rows + kBM - 1) / kBM);
  gemm_wgmma_kernel<T, EPI><<<(unsigned)(tiles < sms ? tiles : sms), kThreads, kSmemBytes,
                              stream>>>(a_map, w_map, static_cast<const T*>(bias),
                                        static_cast<const T*>(res), static_cast<T*>(out),
                                        static_cast<T*>(aux), rows, n, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* w, const void* bias, const void* res, void* out,
                     void* aux, int rows, int n, int k, int epilogue, cudaStream_t stream) {
  switch (epilogue) {
    case kEpiStore: return run<T, kEpiStore>(a, w, bias, res, out, aux, rows, n, k, stream);
    case kEpiBiasGelu: return run<T, kEpiBiasGelu>(a, w, bias, res, out, aux, rows, n, k, stream);
    case kEpiBiasResidual:
      return run<T, kEpiBiasResidual>(a, w, bias, res, out, aux, rows, n, k, stream);
    case kEpiBiasGeluSave:
      return run<T, kEpiBiasGeluSave>(a, w, bias, res, out, aux, rows, n, k, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

cudaError_t launch_gemm_wgmma(const void* a, const void* w, const void* bias, const void* res,
                              void* out, void* aux, int rows, int n, int k, int epilogue,
                              int dtype, cudaStream_t stream) {
  const bool needs_bias = epilogue != kEpiStore, needs_res = epilogue == kEpiBiasResidual,
             needs_aux = epilogue == kEpiBiasGeluSave;
  if (k % 8 != 0 || n % 8 != 0 || k <= 0 || n <= 0 || rows < 0 || !aligned16(out) ||
      (needs_bias && !bias) || (needs_res && !(res && aligned16(res))) ||
      (needs_aux && !(aux && aligned16(aux))))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(a, w, bias, res, out, aux, rows, n, k, epilogue, stream);
  if (dtype == kF16)
    return dispatch<__half>(a, w, bias, res, out, aux, rows, n, k, epilogue, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit

// The GEMM alone, for its card tests: out (rows, n) and, for kEpiBiasGeluSave,
// aux (rows, n) from a (rows, k), w (n, k), bias (n,) and res (rows, n) as the
// epilogue needs them (null otherwise).
extern "C" int vit_gemm_wgmma(const void* a, const void* w, const void* bias, const void* res,
                              void* out, void* aux, int rows, int n, int k, int epilogue,
                              int dtype, cudaStream_t stream) {
  return vit::launch_gemm_wgmma(a, w, bias, res, out, aux, rows, n, k, epilogue, dtype, stream);
}
