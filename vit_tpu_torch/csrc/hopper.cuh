// Hopper building blocks of the kernels that run on the tensor-core warpgroup
// MMA (flash_attention.cu's forward and backward, short_attention.cu's
// forward, gemm_wgmma.cu's GEMM, its B K-major or MN-major) or are fed by TMA
// (short_attention.cu's backward):
//   - mbarriers: init, arrive, arrive-expect-tx, wait on a phase parity;
//   - named barriers of one warpgroup, and setmaxnreg, which moves registers
//     between the warpgroups of a warp-specialised kernel;
//   - thread-block clusters: the CTA's rank, the cluster barrier, peers'
//     shared memory (mapa, ld.shared::cluster), arrivals on peers' mbarriers,
//     and the host's cluster launch and occupancy query;
//   - TMA: a tensor map per (b, h, n, d) operand read through its (batch, head,
//     row) strides, built on the host per call and passed as a __grid_constant__
//     kernel parameter; loads of 4-d boxes (one head's rows) completing on
//     an mbarrier; rows and columns past an extent arrive as zeros; a 2-d
//     (rows, cols) matrix is the map of one image and one head (matrix_map);
//   - wgmma.mma_async (m64nNk16, bf16 or f16, f32 accumulators) with A and B
//     from shared memory (both K-major) or A from registers and B from shared
//     memory MN-major (the transpose bit), and the shared-memory matrix
//     descriptors, fences and commit/wait groups around it.
//
// Shared tiles are laid out as TMA writes them with the 64- or 128-byte
// swizzle: a tile of R rows and W (32, 64 or 128) padded columns is W / C
// column chunks of C = min(W, 64) elements, each R rows of C·2 bytes (the
// swizzle span), 1024-byte aligned.  A head width between those is padded by
// the tensor map: its box is the chunk, its extent the true width, and the
// columns past it land as zeros (40 -> 64: never the next head's columns).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "kernels.cuh"

namespace vit {
namespace hopper {

// ---- mbarriers -------------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the other threads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transfers in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Waits for the `threads` threads (a multiple of 32) that use barrier `id`
// (1..15; 0 is __syncthreads's).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// This warpgroup's registers per thread, lowered (a producer that only
// issues TMA) or raised (the consumers that hold the accumulators).  Every
// warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- thread-block clusters -------------------------------------------------------------------
//
// The CTAs of a cluster (launched with cudaLaunchAttributeClusterDimension)
// run at once on neighbouring SMs and may read each other's shared memory
// (DSMEM) and arrive on each other's mbarriers.  A CTA must not exit while a
// peer may still touch its shared memory: the caller's protocol says when
// that is over.

// This CTA's rank in its cluster, 0..size-1.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The hardware cluster barrier, split: every non-exited thread of every CTA
// of the cluster arrives (release: its earlier writes, mbarrier inits among
// them, become visible cluster-wide), then waits (acquire).  Whole warps.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of p (an address in this CTA's shared memory)
// in the CTA of rank `rank`: the same offset in the peer's shared memory.
__device__ __forceinline__ uint32_t map_peer(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Four floats from a peer's shared memory (an address from map_peer).
__device__ __forceinline__ float4 ld_peer_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// One arrival on the mbarrier at bar's offset in the CTA of rank `rank`
// (this CTA's own included), releasing at cluster scope what this thread has
// written or read before it, and what the CTA's threads have before a
// barrier this thread passed.
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   map_peer(bar, rank))
               : "memory");
}

// mbar_wait for a barrier that peers arrive on: acquires at cluster scope
// what they released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA loads -------------------------------------------------------------------------------

// The box at (column c, row r, head h, image b) of a head map (head_map) into dst.
__device__ __forceinline__ void tma_load_head(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c, int r, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(r), "r"(h), "r"(b)
      : "memory");
}

// The first 1024-byte boundary at or after p in shared memory (the 128-byte
// swizzle repeats every 1024 bytes, and tiles start on its boundary).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ---- swizzled tiles and their wgmma descriptors --------------------------------------------

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets, and the swizzle of the layout (128 or 64 bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)(swizzle == 128 ? 1 : 2) << 62;
}

// The dtype code (kernels.cuh) of an operand type.
template <typename T>
__host__ __device__ constexpr int dtype_of() {
  return kBF16;
}
template <>
__host__ __device__ constexpr int dtype_of<__half>() {
  return kF16;
}

// The padded shared width of a head width: 32, 64 or 128 columns.
__host__ __device__ constexpr int swizzled_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// A tile of R rows and W padded columns as TMA writes it (see the top of the file).
template <int R, int W>
struct Tile {
  static_assert(W == 32 || W == 64 || W == 128, "a swizzled tile is 32, 64 or 128 wide");
  static_assert(R % 8 == 0, "rows come in groups of 8");
  static constexpr int kChunk = W < 64 ? W : 64;  // columns of a chunk (the TMA box)
  static constexpr int kRowBytes = 2 * kChunk;    // the swizzle span
  static constexpr int kBytes = R * W * 2;

  // Operand rows r0.. (M or N), K columns k0..k0+15, K contiguous.
  static __device__ __forceinline__ uint64_t kmajor(const void* tile, int r0, int k0) {
    const char* p = static_cast<const char*>(tile) + (k0 / kChunk) * R * kRowBytes +
                    r0 * kRowBytes + (k0 % kChunk) * 2;
    return smem_desc(p, 16, 8 * kRowBytes, kRowBytes);
  }
  // Operand rows k0..k0+15 (K) and every column (N), N contiguous (the transpose bit).
  static __device__ __forceinline__ uint64_t mnmajor(const void* tile, int k0) {
    const char* p = static_cast<const char*>(tile) + k0 * kRowBytes;
    return smem_desc(p, R * kRowBytes, 8 * kRowBytes, kRowBytes);
  }
  // The byte offset of element (r, c) as TMA lays it out (chunk, row, swizzled
  // 16-byte unit): where a thread stores a value that wgmma then reads.
  static __device__ __forceinline__ int at(int r, int c) {
    const int off = (c / kChunk) * R * kRowBytes + r * kRowBytes + (c % kChunk) * 2;
    return off ^ (((off >> 7) & (kRowBytes / 16 - 1)) << 4);
  }
  // TMA: `rows` rows from row r of (head h, image b) into tile rows t0.., one box a chunk.
  // The map's box is (kChunk, rows); the bytes arrive on `bar`.
  static __device__ __forceinline__ void load(void* tile, int t0, const CUtensorMap* map,
                                              uint64_t* bar, int r, int h, int b) {
#pragma unroll
    for (int c = 0; c < W / kChunk; ++c)
      tma_load_head(static_cast<char*>(tile) + c * R * kRowBytes + t0 * kRowBytes, map, bar,
                    c * kChunk, r, h, b);
  }
};

// ---- wgmma -----------------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes the calling thread's shared-memory stores visible to the async proxy
// (a wgmma that reads them after a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Makes the calling thread's stores to device memory visible to the async
// proxy (a TMA load of them after a barrier).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// Orders the compiler's accesses to registers that an asynchronous wgmma
// writes after the wait that completes it (and before the next one).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments that an asynchronous wgmma reads: they stay live,
// and unchanged, until the wait.
template <int C>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[C][4]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[c][i])::"memory");
}

// D (64 x N, f32, the accumulator fragment: n8-block j holds d[4j..4j+3], rows
// g and g + 8 of the warp's 16, columns 2t and 2t + 1) += A (64 x 16) · B (16 x N).
//   ss: A and B from shared memory, both K-major; acc = 0 overwrites D.
//   ss_t (N 32, 64 and 256): A K-major, B MN-major (the transpose bit), both
//       from shared memory.
//   ss_tt (N 32 and 64): A and B both MN-major (both transpose bits), from
//       shared memory: Aᵀ·B of two tiles that share their rows (K).
//   rs: A from registers (the mma.sync m16n8k16 A fragment of the warp's 16
//       rows), B from shared memory MN-major (the transpose bit).
//   rs_k (N 64 and 128): A from registers, B from shared memory K-major.
template <int N, typename T>
struct Wgmma;

#define VIT_WGMMA_32(TY, PTX) \
  template <> struct Wgmma<32, TY> { \
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
                   "%16, %17, p, 1, 1, 0, 0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void ss_t(float (&d)[16], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
                   "%16, %17, p, 1, 1, 0, 1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void ss_tt(float (&d)[16], uint64_t a, uint64_t b, \
                                               int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
                   "%16, %17, p, 1, 1, 1, 1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], \
                                              uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
                   "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
    } \
  };

#define VIT_WGMMA_64(TY, PTX) \
  template <> struct Wgmma<64, TY> { \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void ss_t(float (&d)[32], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void ss_tt(float (&d)[32], uint64_t a, uint64_t b, \
                                               int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], \
                                              uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
    } \
    static __device__ __forceinline__ void rs_k(float (&d)[32], const uint32_t (&a)[4], \
                                              uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
    } \
  };

#define VIT_WGMMA_80(TY, PTX) \
  template <> struct Wgmma<80, TY> { \
    static __device__ __forceinline__ void ss(float (&d)[40], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n80k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, " \
                   "0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
                     "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
                     "+f"(d[37]), "+f"(d[38]), "+f"(d[39]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
  };

#define VIT_WGMMA_128(TY, PTX) \
  template <> struct Wgmma<128, TY> { \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
                   "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
                   "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
                     "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
                     "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                     "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
                     "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
                     "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
                     "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
                     "+f"(d[62]), "+f"(d[63]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], \
                                              uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
                   "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
                   "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, " \
                   "1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
                     "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
                     "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                     "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
                     "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
                     "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
                     "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
                     "+f"(d[62]), "+f"(d[63]) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
    } \
    static __device__ __forceinline__ void rs_k(float (&d)[64], const uint32_t (&a)[4], \
                                              uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
                   "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
                   "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, " \
                   "0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
                     "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
                     "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                     "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
                     "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
                     "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
                     "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
                     "+f"(d[62]), "+f"(d[63]) \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
    } \
  };

#define VIT_WGMMA_144(TY, PTX) \
  template <> struct Wgmma<144, TY> { \
    static __device__ __forceinline__ void ss(float (&d)[72], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n144k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
                   "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
                   "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
                   "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
                   "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
                   "%70, %71}, %72, %73, p, 1, 1, 0, 0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
                     "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                     "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
                     "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
                     "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                     "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
                     "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
                     "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
                     "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
                     "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
  };

#define VIT_WGMMA_208(TY, PTX) \
  template <> struct Wgmma<208, TY> { \
    static __device__ __forceinline__ void ss(float (&d)[104], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n208k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
                   "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
                   "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
                   "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
                   "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
                   "%100, %101, %102, %103}, %104, %105, p, 1, 1, 0, 0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), \
                     "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
                     "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
                     "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
                     "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
                     "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                     "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
                     "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
                     "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
                     "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
                     "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), \
                     "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
                     "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), \
                     "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), \
                     "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), \
                     "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
                     "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), \
                     "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
                     "+f"(d[102]), "+f"(d[103]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
  };

#define VIT_WGMMA_256(TY, PTX) \
  template <> struct Wgmma<256, TY> { \
    static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
                   "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
                   "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
                   "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
                   "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
                   "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
                   "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
                   "%124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
                     "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                     "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
                     "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
                     "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                     "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
                     "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
                     "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
                     "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
                     "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
                     "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
                     "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
                     "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
                     "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
                     "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), \
                     "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), \
                     "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), \
                     "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
                     "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), \
                     "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
                     "+f"(d[126]), "+f"(d[127]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
    static __device__ __forceinline__ void ss_t(float (&d)[128], uint64_t a, uint64_t b, \
                                              int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32." PTX "." PTX " {" \
                   "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                   "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                   "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
                   "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
                   "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
                   "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
                   "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
                   "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
                   "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
                   "%124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n" \
                   : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                     "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                     "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
                     "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                     "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
                     "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
                     "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                     "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
                     "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
                     "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
                     "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
                     "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
                     "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
                     "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
                     "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
                     "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
                     "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), \
                     "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), \
                     "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), \
                     "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
                     "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), \
                     "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
                     "+f"(d[126]), "+f"(d[127]) \
                   : "l"(a), "l"(b), "r"(acc)); \
    } \
  };

VIT_WGMMA_32(__nv_bfloat16, "bf16")
VIT_WGMMA_64(__nv_bfloat16, "bf16")
VIT_WGMMA_80(__nv_bfloat16, "bf16")
VIT_WGMMA_128(__nv_bfloat16, "bf16")
VIT_WGMMA_144(__nv_bfloat16, "bf16")
VIT_WGMMA_208(__nv_bfloat16, "bf16")
VIT_WGMMA_32(__half, "f16")
VIT_WGMMA_64(__half, "f16")
VIT_WGMMA_80(__half, "f16")
VIT_WGMMA_128(__half, "f16")
VIT_WGMMA_144(__half, "f16")
VIT_WGMMA_208(__half, "f16")
VIT_WGMMA_256(__nv_bfloat16, "bf16")
VIT_WGMMA_256(__half, "f16")

// The A fragment of k16-chunk c from an f32 accumulator over that dimension
// (n8-blocks 2c and 2c + 1), rounded to T.
template <typename T, int R>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&d)[R], int c) {
  a[0] = Num<T>::pack2(d[8 * c], d[8 * c + 1]);
  a[1] = Num<T>::pack2(d[8 * c + 2], d[8 * c + 3]);
  a[2] = Num<T>::pack2(d[8 * c + 4], d[8 * c + 5]);
  a[3] = Num<T>::pack2(d[8 * c + 6], d[8 * c + 7]);
}

// Store the first D columns of a warpgroup's 64 x W f32 fragment to rows r0..
// of a row-strided output, rounded; rows at or past n, and n8-blocks at or
// past `cols` (a multiple of 8), are skipped.
template <typename T, int D, int R>
__device__ __forceinline__ void store_fragment(T* dst, long long ld, int r0, int n,
                                               const float (&acc)[R], int lt, int cols = D) {
  const int row = r0 + (lt / 32) * 16 + (lt % 32) / 4, col = 2 * (lt % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row + 8 * half >= n) continue;
    T* p = dst + (long long)(row + 8 * half) * ld + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < cols)
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            Num<T>::pack2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

}  // namespace hopper

// ---- host: tensor maps -----------------------------------------------------------------------

// Sets a kernel's dynamic shared-memory limit on the current device unless
// `ready_on` says it was set for that device in this host thread (the caller
// keeps one thread_local device index per kernel, -1 at first).  The call
// also loads the kernel: a first launch from a thread that has made no
// runtime call yet (autograd's backward thread) was refused as an invalid
// argument without it, at any size.
template <typename Kernel>
cudaError_t prepare_kernel(int& ready_on, Kernel kernel, int smem_bytes) {
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == ready_on) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) ready_on = device;
  return err;
}

// How many clusters of `csize` CTAs of `kernel` (threads and dynamic shared
// memory as given; prepare_kernel first) the current device runs at once.
template <typename Kernel>
cudaError_t max_active_clusters(int* clusters, Kernel kernel, int csize, int threads,
                                int smem_bytes) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// Launches `kernel` as `clusters` clusters of `csize` CTAs along x
// (cudaLaunchKernelEx: the runtime alone, no -lcuda).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int clusters, int csize, int threads, int smem_bytes,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no -lcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The map of a (b, h, n, d) operand in the compute dtype read through its
// (batch, head, row) element strides, d contiguous: extents (d, n, h, b),
// byte strides (2·row, 2·head, 2·batch), a box of (cols, rows, 1, 1) with the
// swizzle of its cols·2 bytes (64 or 128), zeros past every extent.  The
// strides must be multiples of 8 elements (ops/flash_attention.py's
// kernel_strides gives one to a size-1 axis) and the data 16-byte aligned.
inline cudaError_t head_map(CUtensorMap* map, const void* data, int dtype, int d, int n, int h,
                            int b, const long long* strides, int cols, int rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t bytes[3] = {2 * (cuuint64_t)strides[2], 2 * (cuuint64_t)strides[1],
                               2 * (cuuint64_t)strides[0]};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
      const_cast<void*>(data), dims, bytes, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a (rows, cols) matrix in the compute dtype whose rows lie `ld`
// elements apart, the columns contiguous: a head map of one image and one head
// (a size-1 axis's stride addresses nothing and goes as 8 elements).  Its
// boxes are read with tma_load_head(dst, map, bar, column, row, 0, 0).
inline cudaError_t matrix_map(CUtensorMap* map, const void* data, int dtype, int cols, int rows,
                              long long ld, int box_cols, int box_rows) {
  const long long strides[3] = {8, 8, ld};
  return head_map(map, data, dtype, cols, rows, 1, 1, strides, box_cols, box_rows);
}

}  // namespace vit
