// Row-major GEMM with fused epilogues, written by hand for Hopper with mma.sync
// m16n8k16 (f32 accumulation):  out = epi(A · B)  with A (rows, k) k-contiguous
// and B either an nn.Linear weight W (n, k), so B = Wᵀ (kWeightNK), or a
// weight used untransposed, W (k, n) with n contiguous (kWeightKN, whose B
// fragments come from ldmatrix.trans, so no weight is transposed per step as
// the TPU wrappers did at fused_mlp.py:388 and fused_attention_block.py:388).
// It was the GEMM inside the two TPU block kernels (vit_tpu/ops/fused_mlp.py
// and fused_attention_block.py _fwd_kernel and _bwd_kernel).  Those GEMMs now
// run on gemm_wgmma.cu's wgmma GEMM from n = 256 (launch_forward_gemm for the
// forwards' QKV, out-projection, fc1 and fc2; launch_dgrad for the backwards'
// dgrads), and this kernel keeps
//   the narrower ones (kWeightNK and kWeightKN below n = 256: ScalableViT's
//     stage-1 and stage-2 conv-MLPs, fc2 and dh·W1 at n 64 and 128, and small
//     test widths), with the same epilogues and rounding points;
//   the cross-attention block's GEMMs (fused_cross_attention.cu) and the
//     hybrid layer's backward GEMMs (fused_hybrid.cu).
//
// Bound on the H100: at ViT-B/16, batch 64, every GEMM of the blocks runs over
// 12,608 rows against weights of 768 x 768 to 768 x 3072 — hundreds of FLOPs
// per byte, far above the ~295 FLOP/byte ridge, so the tensor cores bound
// them.  The kernel uses 128x128x32 block tiles, eight warps of 64x32, a
// four-stage cp.async pipeline and ldmatrix, which is simple and right;
// wgmma/TMA pipelines and a persistent schedule are later work.
#include "kernels.cuh"

namespace vit {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 8;    // padded A / (n, k) B row (80 bytes): ldmatrix without bank conflicts
constexpr int kRowT = kBN + 8;   // padded (k, n) B row (272 bytes): the same for ldmatrix.trans
constexpr int kChunks = (kBM * kBK / 8) / kThreads;  // 16-byte chunks per thread per tile (2)

template <int WL>
constexpr int smem_bytes() {
  return kStages * (kBM * kRow + (WL == kWeightNK ? kBN * kRow : kBK * kRowT)) * 2;
}

// Pointers an epilogue may use; unused ones are null.
template <typename T>
struct Args {
  const T* a;
  const T* w;
  void* out;         // T, or float for kEpiStoreF32
  const T* bias;     // (n,)
  const T* res;      // (rows, n) residual
  const T* aux_in;   // (rows, n) saved pre-activation h (kEpiDGelu)
  T* aux_out;        // (rows, n) h (kEpiBiasGeluSave) or gelu(h) (kEpiDGelu)
  float* partial;    // (linear_partial_rows(rows), n) column sums of the f32 output (kEpiDGelu)
  int rows, n, k;
};

template <typename T>
__device__ __forceinline__ void load2(const T* p, float& lo, float& hi) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
  lo = Num<T>::to_f(e[0]);
  hi = Num<T>::to_f(e[1]);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = Num<T>::pack2(lo, hi);
}

template <typename T, int EPI, int WL>
__global__ void __launch_bounds__(kThreads) linear_kernel(const Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T(*As)[kBM][kRow] = reinterpret_cast<T(*)[kBM][kRow]>(smem_raw);
  unsigned char* b_raw = smem_raw + kStages * kBM * kRow * sizeof(T);
  T(*Bs)[kBN][kRow] = reinterpret_cast<T(*)[kBN][kRow]>(b_raw);     // kWeightNK: [n][k]
  T(*Bt)[kBK][kRowT] = reinterpret_cast<T(*)[kBK][kRowT]>(b_raw);   // kWeightKN: [k][n]

  const int rows = p.rows, n = p.n, k = p.k;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int g = lane / 4, t = lane % 4;

  // Stage one k tile of A and B; rows past `rows` / `n` and columns past k
  // land as zeros.
  auto load_stage = [&](int slot, int k0) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const int kk = k0 + col, ar = m0 + r;
      const bool va = kk < k && ar < rows;
      cp_async16(&As[slot][r][col], va ? p.a + (size_t)ar * k + kk : p.a, va);
      if (WL == kWeightNK) {
        const int br = n0 + r;
        const bool vb = kk < k && br < n;
        cp_async16(&Bs[slot][r][col], vb ? p.w + (size_t)br * k + kk : p.w, vb);
      } else {
        const int kr = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
        const int bk = k0 + kr, bn = n0 + nc;
        const bool vb = bk < k && bn < n;
        cp_async16(&Bt[slot][kr][nc], vb ? p.w + (size_t)bk * n + bn : p.w, vb);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int ktiles = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();  // tile kt is visible to all; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next * kBK);  // the slot of tile kt - 1
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = warp_m * 64 + mi * 16 + (lane % 16);
        ldmatrix_x4(af[mi], &As[cur][r][ks + (lane / 16) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // bf[0..1]: n tile 2·nj, bf[2..3]: n tile 2·nj + 1 (k 0-7, then 8-15).
        uint32_t bf[4];
        if (WL == kWeightNK) {
          const int r = warp_n * 32 + nj * 16 + (lane % 8) + (lane / 16) * 8;
          ldmatrix_x4(bf, &Bs[cur][r][ks + ((lane / 8) % 2) * 8]);
        } else {
          ldmatrix_x4_trans(bf, &Bt[cur][ks + (lane % 8) + ((lane / 8) % 2) * 8]
                                   [warp_n * 32 + nj * 16 + (lane / 16) * 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          Num<T>::mma(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          Num<T>::mma(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the accumulator fragments: element e of tile
  // (mi, ni) sits at row g (+8 for e >= 2), columns 2t and 2t + 1.
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + warp_n * 32 + ni * 8 + 2 * t;
    // n % 8 == 0, so this test is the same for the whole warp (the shuffles
    // below need every lane).
    if (col >= n) continue;
    float b0 = 0.f, b1 = 0.f;
    if (EPI == kEpiBiasGelu || EPI == kEpiBiasResidual || EPI == kEpiBiasGeluSave) {
      b0 = Num<T>::to_f(p.bias[col]);
      b1 = Num<T>::to_f(p.bias[col + 1]);
    }
    float cs0 = 0.f, cs1 = 0.f;  // kEpiDGelu: this thread's column sums
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 64 + mi * 16 + g + half * 8;
        if (row >= rows) continue;
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        const size_t off = (size_t)row * n + col;
        if (EPI == kEpiStore) {
          store2(out + off, v0, v1);
        } else if (EPI == kEpiBiasGelu) {
          store2(out + off, gelu_erf(v0 + b0), gelu_erf(v1 + b1));
        } else if (EPI == kEpiBiasResidual) {
          // The residual adds in the compute dtype: T(res + T(acc + b)).
          float r0, r1;
          load2(p.res + off, r0, r1);
          store2(out + off, r0 + Num<T>::round(v0 + b0), r1 + Num<T>::round(v1 + b1));
        } else if (EPI == kEpiBiasGeluSave) {
          // Training fc1: keep h = T(acc + b); GELU of the unrounded sum.
          v0 += b0;
          v1 += b1;
          store2(p.aux_out + off, v0, v1);
          store2(out + off, gelu_erf(v0), gelu_erf(v1));
        } else if (EPI == kEpiDGelu) {
          // dh32 = (dy·W2) * gelu'(h) from the stored bf16 h; dh = T(dh32);
          // gact = T(gelu(h)) for the dW2 GEMM; db1 sums the f32 dh32.
          float h0, h1;
          load2(p.aux_in + off, h0, h1);
          v0 *= dgelu_erf(h0);
          v1 *= dgelu_erf(h1);
          store2(out + off, v0, v1);
          store2(p.aux_out + off, gelu_erf(h0), gelu_erf(h1));
          cs0 += v0;
          cs1 += v1;
        } else if (EPI == kEpiStoreF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(v0, v1);
        }
      }
    }
    if (EPI == kEpiDGelu) {
      // Sum over the warp's 64 rows (lanes of equal t hold the same
      // columns), then one store per (row block, warp_m): no atomics, so
      // the reduction's order, and its bits, are fixed.
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
        cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
      }
      if (g == 0) {
        float* prow = p.partial + (size_t)(blockIdx.y * 2 + warp_m) * n;
        prow[col] = cs0;
        prow[col + 1] = cs1;
      }
    }
  }
}

template <typename T, int EPI, int WL>
cudaError_t run(const Args<T>& args, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<WL>();
  cudaError_t err = cudaFuncSetAttribute(linear_kernel<T, EPI, WL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((args.n + kBN - 1) / kBN, (args.rows + kBM - 1) / kBM);
  linear_kernel<T, EPI, WL><<<grid, kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

// The instances that exist: the forward epilogues over (n, k) weights (and
// the f32 store, a split block's partial sum), the backward ones over (k, n)
// weights.
template <typename T>
cudaError_t dispatch(const Args<T>& args, int layout, int epi, cudaStream_t stream) {
  if (layout == kWeightNK) {
    switch (epi) {
      case kEpiStore: return run<T, kEpiStore, kWeightNK>(args, stream);
      case kEpiBiasGelu: return run<T, kEpiBiasGelu, kWeightNK>(args, stream);
      case kEpiBiasResidual: return run<T, kEpiBiasResidual, kWeightNK>(args, stream);
      case kEpiBiasGeluSave: return run<T, kEpiBiasGeluSave, kWeightNK>(args, stream);
      case kEpiStoreF32: return run<T, kEpiStoreF32, kWeightNK>(args, stream);
    }
  } else if (layout == kWeightKN) {
    switch (epi) {
      case kEpiStore: return run<T, kEpiStore, kWeightKN>(args, stream);
      case kEpiDGelu: return run<T, kEpiDGelu, kWeightKN>(args, stream);
      case kEpiStoreF32: return run<T, kEpiStoreF32, kWeightKN>(args, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t typed(const void* a, const void* w, int layout, const void* bias, const void* res,
                  const void* aux_in, void* out, void* aux_out, float* partial, int rows, int n,
                  int k, int epi, cudaStream_t stream) {
  const Args<T> args{static_cast<const T*>(a), static_cast<const T*>(w), out,
                     static_cast<const T*>(bias), static_cast<const T*>(res),
                     static_cast<const T*>(aux_in), static_cast<T*>(aux_out), partial,
                     rows, n, k};
  return dispatch<T>(args, layout, epi, stream);
}

}  // namespace

int linear_partial_rows(int rows) { return 2 * ((rows + kBM - 1) / kBM); }

cudaError_t launch_linear(const void* a, const void* w, int layout, const void* bias,
                          const void* res, const void* aux_in, void* out, void* aux_out,
                          float* partial, int rows, int n, int k, int epilogue, int dtype,
                          cudaStream_t stream) {
  if (k % 8 != 0 || n % 8 != 0 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16)
    err = typed<__nv_bfloat16>(a, w, layout, bias, res, aux_in, out, aux_out, partial, rows, n,
                               k, epilogue, stream);
  else if (dtype == kF16)
    err = typed<__half>(a, w, layout, bias, res, aux_in, out, aux_out, partial, rows, n, k,
                        epilogue, stream);
  if (err == cudaSuccess) count_launch(kCountLinear);
  return err;
}

}  // namespace vit

extern "C" int vit_linear_partial_rows(int rows) { return vit::linear_partial_rows(rows); }
