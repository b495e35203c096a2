// Row-major GEMM on Hopper's warpgroup MMA, fed by a TMA ring:
//   out (rows, n) = T(A (rows, k) · Wᵀ),  W (n, k) an nn.Linear weight,
// A and W k-contiguous (both K-major, wgmma's shared-operand case with no
// transpose), f32 accumulation, one rounding to the compute dtype.  It is the
// GEMM of ln_gemm's forward (fused_hybrid.cu: xn·Wqkvᵀ, the hybrid layer's
// q|k|v); linear.cu's mma.sync kernel keeps every other caller and epilogue.
//
// Bound on the H100: at ViT-B/32's hybrid layer (8320 rows, k 1024, n 3072,
// bf16) the product is 52.3 GFLOP (0.053 ms at 989 TFLOP/s) against 25 MB of
// A, W and out (0.008 ms at 3.35 TB/s): the tensor cores bound it.
//
// One CTA per (128 x 256 tile of out): two warpgroups of 64 rows, each on
// m64n256k16.  k steps of 64 columns (128-byte swizzled tiles of A and W)
// stream through a 4-stage ring (192 KB) on full/empty mbarriers; thread 0
// issues every TMA load, and refills the stage of step i - 1 once every
// thread has released it, after its own step i is on the tensor cores.  Each
// warpgroup keeps one step's products in flight (wgmma_wait<1>) while it
// waits for the next stage.  Rows past `rows`, columns past n and the k
// columns past k arrive as zeros from the tensor maps' extents (add 0); the
// stores are predicated.  (128 x 128 tiles at two CTAs an SM were slower at
// ViT-B/32's QKV.)
#include "hopper.cuh"

namespace vit {
namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;

using ATile = hopper::Tile<kBM, kBK>;
using WTile = hopper::Tile<kBN, kBK>;

// The ring of A and W tiles, the full/empty barriers, alignment.
constexpr int kSmemBytes = kStages * (ATile::kBytes + WTile::kBytes) + 2 * kStages * 8 + 1024;

template <typename T>
__global__ void __launch_bounds__(256, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap w_map, T* __restrict__ out, int rows,
                      int n, int k) {
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = hopper::align1024(smem_raw);
  unsigned char* ws = as + S * ATile::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + S * WTile::kBytes);
  uint64_t* empty = full + S;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int steps = (k + kBK - 1) / kBK;
  auto load_step = [&](int i) {
    const int s = i % S;
    hopper::mbar_expect_tx(&full[s], ATile::kBytes + WTile::kBytes);
    hopper::tma_load_head(as + s * ATile::kBytes, &a_map, &full[s], i * kBK, m0, 0, 0);
    hopper::tma_load_head(ws + s * WTile::kBytes, &w_map, &full[s], i * kBK, n0, 0, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], blockDim.x);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < S && i < steps; ++i) load_step(i);

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % S;
    const unsigned char* a_t = as + s * ATile::kBytes;
    const unsigned char* w_t = ws + s * WTile::kBytes;
    hopper::mbar_wait(&full[s], (i / S) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::Wgmma<kBN, T>::ss(acc, ATile::kmajor(a_t, 64 * wg, 16 * kk),
                               WTile::kmajor(w_t, 0, 16 * kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // step i - 1's products are done: its stage is free
    hopper::fence_regs(acc);
    if (i >= 1) {
      const int p = (i - 1) % S;
      hopper::mbar_arrive(&empty[p]);
      if (tid == 0 && i - 1 + S < steps) {
        hopper::mbar_wait(&empty[p], ((i - 1) / S) & 1);
        load_step(i - 1 + S);
      }
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::store_fragment<T, kBN>(out + n0, n, m0 + 64 * wg, rows, acc, lt, n - n0);
}

template <typename T>
cudaError_t run(const void* a, const void* w, void* out, int rows, int n, int k,
                cudaStream_t stream) {
  constexpr int dt = hopper::dtype_of<T>();
  thread_local int ready = -1;
  cudaError_t err = prepare_kernel(ready, gemm_wgmma_kernel<T>, kSmemBytes);
  CUtensorMap a_map, w_map;
  if (err == cudaSuccess) err = matrix_map(&a_map, a, dt, k, rows, k, kBK, kBM);
  if (err == cudaSuccess) err = matrix_map(&w_map, w, dt, k, n, k, kBK, kBN);
  if (err != cudaSuccess) return err;
  gemm_wgmma_kernel<T><<<dim3((n + kBN - 1) / kBN, (rows + kBM - 1) / kBM), 256, kSmemBytes,
                         stream>>>(a_map, w_map, static_cast<T*>(out), rows, n, k);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_gemm_wgmma(const void* a, const void* w, void* out, int rows, int n, int k,
                              int dtype, cudaStream_t stream) {
  if (k % 8 != 0 || n % 8 != 0 || k <= 0 || n <= 0 || rows < 0 ||
      (rows + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == kBF16) return run<__nv_bfloat16>(a, w, out, rows, n, k, stream);
  if (dtype == kF16) return run<__half>(a, w, out, rows, n, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace vit
