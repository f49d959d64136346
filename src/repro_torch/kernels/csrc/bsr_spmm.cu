// Blocked-ELL sparse x dense product for Hopper (sm_90a): y = A @ x.
//
// Replaces repro/kernels/bsr_spmm.py::bsr_spmm, the TPU kernel of the SpMM
// offload and of the MoE experts (a block-diagonal A is a grouped matmul;
// repro/models/layers.py::_expert_ffn runs its einsum twin, the port's
// _expert_ffn calls this kernel). A has R block-rows; block-row r stores K
// dense (bm x bk) blocks vals[r, t] with block-column ids cols[r, t], and an
// id of -1 is padding that contributes zero. The TPU kernel walks an
// (R, n/bn, K) grid with K innermost and sequential, carrying the output tile
// in VMEM, scalar-prefetches the ids to pick x's tile, and multiplies a
// padding block by a zeroed operand (branchless). Here:
//
//   * one thread block owns one output tile of one block-row and walks that
//     row's K blocks itself, summing in float32 registers, and writes the
//     tile once, rounded once;
//   * a padding block (id -1) is skipped before anything is loaded, so an
//     expert that received no token costs no reads of its weights;
//   * any bm, bk and n: rows, columns and depth past the edge load as zeros
//     and are never stored. An id past x's last block reads the last block,
//     as ref.bsr_spmm's clip does.
//
// Two kernels share that walk. bf16 with bk and n multiples of 8 (the
// experts' shapes) runs on the tensor cores: 128x128 tiles, mma.sync
// m16n8k16, 32-deep slices double-buffered by cp.async (see
// bsr_spmm_mma_kernel). Everything else (f32, ragged bf16) runs a float32 FMA
// kernel: 64x64 tiles, a 4x4 micro-tile per thread, 16-deep slices of A
// (transposed) and x through shared memory.
//
// Cost on the card: at the main path's prefill (R = 64 experts, K = 1,
// bm = C = 640, bk = 2048, n = 1408, bf16) the work is 2*bm*bk*n FLOP per
// stored block, 236 GFLOP when all 64 blocks are real, against 0.5 GB of
// operands: bound by the tensor cores (0.239 ms at 989 TFLOP/s). At decode
// (bm = 8) the same weights are read for 8 rows each, so the bound is the
// bytes of the experts that received a token, at 3.35 TB/s. The mma.sync
// kernel is a first tensor-core design (two stages, no warp specialisation,
// 8 of 128 rows busy at decode); deeper cp.async/TMA pipelines, wgmma and a
// tile shaped for decode's 8 rows are the next steps (PERF.md).
//
// C interface (bound with ctypes): bsr_spmm_launch returns cudaGetLastError()
// after the launch, 0 on success, or -1 for a dtype or grid this file does not
// take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;
constexpr int kTX = 16;                // threads across the tile's columns

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int K, int bm,
                int bk, int n, int nblk) {
  using E = Elem<T>;
  __shared__ float as[kBK][kBM + 1];   // A slice, transposed
  __shared__ float xs[kBK][kBN];       // x slice

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int r = blockIdx.z;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < K; ++t) {
    int c = cols[(size_t)r * K + t];
    if (c < 0) continue;               // padding: skipped before any load
    c = min(c, nblk - 1);
    const T* a = vals + ((size_t)r * K + t) * bm * bk;
    const T* xb = x + (size_t)c * bk * n;
    for (int k0 = 0; k0 < bk; k0 += kBK) {
#pragma unroll
      for (int l = 0; l < kBM * kBK / kThreads; ++l) {
        const int idx = tid + l * kThreads;           // depth fastest
        const int rr = idx / kBK, kk = idx % kBK;
        const int gr = row0 + rr, gk = k0 + kk;
        as[kk][rr] = (gr < bm && gk < bk)
            ? E::load(a[(size_t)gr * bk + gk]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < kBK * kBN / kThreads; ++l) {
        const int idx = tid + l * kThreads;           // columns fastest
        const int kk = idx / kBN, cc = idx % kBN;
        const int gk = k0 + kk, gc = col0 + cc;
        xs[kk][cc] = (gk < bk && gc < n)
            ? E::load(xb[(size_t)gk * n + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + kTX * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[kk][tx + kTX * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + kTX * i;
    if (gr >= bm) continue;
    T* yrow = y + ((size_t)r * bm + gr) * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + kTX * j;
      if (gc < n) yrow[gc] = E::store(acc[i][j]);
    }
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------
//
// The same walk for bf16 operands whose rows start on 16 bytes (bk and n
// multiples of 8): a 128x128 output tile per block of 8 warps (2 x 4, each
// 64x32, mma.sync m16n8k16 into float32 accumulators), 32-deep slices of A
// and x double-buffered in shared memory by cp.async (zero past the edges),
// the next slice's copy in flight while the current one is multiplied;
// fragments read with ldmatrix. Rows padded by 8 elements keep the ldmatrix
// reads free of bank conflicts. (A 4-stage ring measured no faster at the
// prefill shape and slower at decode's, PERF.md.)

constexpr int kMBM = 128, kMBN = 128, kMBK = 32, kMThreads = 256;
constexpr int kALd = kMBK + 8;         // bf16 per A row in shared memory
constexpr int kXLd = kMBN + 8;         // bf16 per x row in shared memory

__global__ void __launch_bounds__(kMThreads)
bsr_spmm_mma_kernel(const int32_t* __restrict__ cols,
                    const __nv_bfloat16* __restrict__ vals,
                    const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ y, int K, int bm, int bk,
                    int n, int nblk) {
  using namespace mma_bf16;
  __shared__ __align__(16) __nv_bfloat16 as[2][kMBM][kALd];
  __shared__ __align__(16) __nv_bfloat16 xs[2][kMBK][kXLd];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int r = blockIdx.z;
  const int row0 = blockIdx.y * kMBM, col0 = blockIdx.x * kMBN;

  float acc[4][4][4];                  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < K; ++t) {
    int c = cols[(size_t)r * K + t];
    if (c < 0) continue;               // padding: skipped before any load
    c = min(c, nblk - 1);
    const __nv_bfloat16* a = vals + ((size_t)r * K + t) * bm * bk;
    const __nv_bfloat16* xb = x + (size_t)c * bk * n;
    auto load = [&](int stage, int k0) {
#pragma unroll
      for (int l = 0; l < 2; ++l) {    // A: 128 rows x 4 chunks of 8
        const int ch = tid + l * kMThreads;
        const int rr = ch >> 2, cc = (ch & 3) * 8;
        const int gr = row0 + rr, gk = k0 + cc;
        const bool ok = gr < bm && gk < bk;
        cp_async16(&as[stage][rr][cc], ok ? a + (size_t)gr * bk + gk : a, ok);
      }
#pragma unroll
      for (int l = 0; l < 2; ++l) {    // x: 32 rows x 16 chunks of 8
        const int ch = tid + l * kMThreads;
        const int kk = ch >> 4, cc = (ch & 15) * 8;
        const int gk = k0 + kk, gc = col0 + cc;
        const bool ok = gk < bk && gc < n;
        cp_async16(&xs[stage][kk][cc], ok ? xb + (size_t)gk * n + gc : xb,
                   ok);
      }
      cp_async_commit();
    };
    const int nk = (bk + kMBK - 1) / kMBK;
    load(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load((kt + 1) & 1, (kt + 1) * kMBK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int st = kt & 1;
#pragma unroll
      for (int ks = 0; ks < kMBK; ks += 16) {
        uint32_t af[4][4], xf[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldmatrix_x4(af[i], &as[st][wm * 64 + i * 16 + (lane & 15)]
                                    [ks + (lane >> 4) * 8]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4_trans(xf[j], &xs[st][ks + (lane & 15)]
                                          [wn * 32 + j * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma(acc[i][j], af[i], xf[j >> 1][(j & 1) * 2],
                xf[j >> 1][(j & 1) * 2 + 1]);
      }
      __syncthreads();                 // the stage is free for the next load
    }
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + wn * 32 + j * 8 + tq * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gr = row0 + wm * 64 + i * 16 + g + half * 8;
        if (gr < bm && gc < n)
          *reinterpret_cast<__nv_bfloat162*>(y + ((size_t)r * bm + gr) * n +
                                             gc) =
              __floats2bfloat162_rn(acc[i][j][2 * half],
                                    acc[i][j][2 * half + 1]);
      }
    }
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y, int R,
           int K, int bm, int bk, int n, int nblk, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (bm + kBM - 1) / kBM, R);
  if (grid.y > 65535 || grid.z > 65535) return -1;
  bsr_spmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), K, bm, bk, n, nblk);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* cols, const void* vals, const void* x, void* y,
               int R, int K, int bm, int bk, int n, int nblk,
               cudaStream_t stream) {
  const dim3 grid((n + kMBN - 1) / kMBN, (bm + kMBM - 1) / kMBM, R);
  if (grid.y > 65535 || grid.z > 65535) return -1;
  bsr_spmm_mma_kernel<<<grid, kMThreads, 0, stream>>>(
      static_cast<const int32_t*>(cols),
      static_cast<const __nv_bfloat16*>(vals),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      K, bm, bk, n, nblk);
  return static_cast<int>(cudaGetLastError());
}

// rows of A and x start on 16 bytes, as cp.async asks
bool mma_fits(const void* vals, const void* x, const void* y, int bk, int n) {
  return bk % 8 == 0 && n % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(x) |
          reinterpret_cast<uintptr_t>(y)) % 16 == 0;
}

}  // namespace

extern "C" int bsr_spmm_launch(const void* cols, const void* vals,
                               const void* x, void* y, int R, int K, int bm,
                               int bk, int n, int nblk, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(cols, vals, x, y, R, K, bm, bk, n, nblk, s);
    case kBF16:
      if (mma_fits(vals, x, y, bk, n))
        return launch_mma(cols, vals, x, y, R, K, bm, bk, n, nblk, s);
      return launch<__nv_bfloat16>(cols, vals, x, y, R, K, bm, bk, n, nblk, s);
  }
  return -1;
}
