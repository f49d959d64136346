// Mamba2 SSD intra-chunk contraction for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_chunk.py:51 (ssd_chunk), the TPU kernel of
// the state-space-duality scan; the port's models/layers.py::ssd_chunked runs
// its intra-chunk part here, one launch a layer a prefill. For each pair
// (g, h) of a batch-chunk index and a head, with cA = cumsum(dt * A[h]) over
// the chunk's q positions:
//
//   y[g, i, h, p]  = sum_{k <= i} (C_i . B_k) exp(cA_i - cA_k) dt_k x[k, p]
//   st[g, h, p, n] = sum_k x[k, p] exp(cA_last - cA_k) dt_k B_k[n]
//
// The TPU kernel holds one (g, h) pair's whole chunk in VMEM and runs the
// three products on the MXU. Here one thread block owns one (g, h) pair
// (a grid of G * H blocks: 64 * 80 = 5,120 at the main shape) and walks it in
// 64 x 64 tiles, so that any q up to 256 and any P, N up to 256 fit in 37 KB
// of shared memory:
//
//   * dt is staged for the chunk and warp 0 takes the cumsum of dt * A with a
//     block scan (each lane a run of positions, then a shuffle scan of the
//     runs' totals), all in float32;
//   * y, a 64-row query tile at a time: for each key tile at or below the
//     diagonal, s = C B^T (64 x 64, summed over N a 64-wide slice at a time),
//     then w = s * exp(cA_i - cA_k) * dt_k where k <= i and 0 where not: the
//     masked entries are selected, never multiplied by a 0/1 mask, since
//     exp(cA_i - cA_k) overflows to inf above the diagonal; then y += w x.
//     Key tiles above the diagonal are skipped;
//   * st, a 64 x 64 (p, n) tile at a time: st += (x * exp(cA_last - cA_k) *
//     dt_k)^T B over 64-row key tiles;
//   * every product is a 16 x 16 thread grid with a 4 x 4 float32 FMA micro-
//     tile per thread, read from shared memory as float4; x, B and C are read
//     in their own type (float32 or bfloat16) and widened on the way in, as
//     the Pallas kernel casts every input to float32 (:26-30). Outputs are
//     float32.
//
// Cost on the card: at the main path's (G, q, H, P, N) = (64, 128, 80, 64,
// 128) with x, B, C in bf16, the work the data needs is C B^T once per g over
// the causal pairs (0.14 GFLOP), w x over the causal pairs (5.4 GFLOP) and
// the states (10.7 GFLOP): about 16.3 GFLOP of float32 products, 0.24 ms at
// 67 TFLOP/s; the bytes are 84 MB of x, 4 MB of B and C, 1.3 MB of dt and
// 336 MB of float32 y and states, 0.127 ms at 3.35 TB/s. So it is bound by
// operations. Like the Pallas kernel, this one recomputes the head-independent
// C B^T for every head (the full q x q product would be 21.5 of about 43
// GFLOP; with the tiles above the diagonal skipped it does 16.1 of 34.9), and
// it runs on the CUDA cores. Computing C B^T once per g, the tensor cores
// (bf16 scores would differ from the Pallas kernel's float32 ones) and TMA
// staging are the next steps (PERF.md).
//
// C interface (bound with ctypes): ssd_chunk_launch returns cudaGetLastError()
// after the launch, 0 on success, or -1 for a dtype or shape this file does
// not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kT = 64;                 // tile edge (rows and columns)
constexpr int kLd = kT + 4;            // staged row length: float4-aligned
constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxQ = 256;             // longest chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dst[r][c] (dst[c][r] with kTrans) = src[r0 + r][c0 + c] * scale[r0 + r],
// widened to float32; rows at or past nr and columns at or past nc are 0.
template <bool kTrans, typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, size_t ld,
                                      int r0, int nr, int c0, int nc,
                                      const float* __restrict__ scale) {
  for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
    const int r = idx / kT, c = idx % kT;
    const int gr = r0 + r, gc = c0 + c;
    float v = 0.f;
    if (gr < nr && gc < nc) {
      v = to_f32(src[(size_t)gr * ld + gc]);
      if (scale != nullptr) v *= scale[gr];
    }
    if (kTrans)
      dst[c * kLd + r] = v;
    else
      dst[r * kLd + c] = v;
  }
}

// acc[i][j] += sum_k a[k][4 ty + i] * b[k][4 tx + j] over a staged pair
__device__ __forceinline__ void tile_fma(float (&acc)[4][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx) {
#pragma unroll 4
  for (int k = 0; k < kT; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

template <typename T, typename TD, typename TA>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                 const TA* __restrict__ A, const T* __restrict__ B,
                 const T* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ st, int q, int H, int P, int N) {
  __shared__ __align__(16) float buf0[kT * kLd];
  __shared__ __align__(16) float buf1[kT * kLd];
  __shared__ float dts[kMaxQ];         // dt_k
  __shared__ float cA[kMaxQ];          // cumsum of dt * A
  __shared__ float sk[kMaxQ];          // exp(cA_last - cA_k) * dt_k

  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t ldx = (size_t)H * P;    // x's row k of this head at k * ldx
  const T* xg = x + ((size_t)g * q * H + h) * P;
  const T* Bg = B + (size_t)g * q * N;
  const T* Cg = C + (size_t)g * q * N;

  // ---- dt and the cumsum of dt * A (warp 0: runs, then a shuffle scan) ----
  const float a = to_f32(A[h]);
  for (int k = tid; k < q; k += kThreads)
    dts[k] = to_f32(dt[((size_t)g * q + k) * H + h]);
  __syncthreads();
  if (tid < 32) {
    const int per = (q + 31) / 32;
    const int k0 = min(tid * per, q), k1 = min(k0 + per, q);
    float run = 0.f;
    for (int k = k0; k < k1; ++k) {
      run += dts[k] * a;
      cA[k] = run;
    }
    float incl = run;                  // inclusive scan of the runs' totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += v;
    }
    const float before = incl - run;
    for (int k = k0; k < k1; ++k) cA[k] += before;
  }
  __syncthreads();
  const float last = cA[q - 1];
  for (int k = tid; k < q; k += kThreads)
    sk[k] = expf(last - cA[k]) * dts[k];
  __syncthreads();

  // ---- y: a 64-row query tile, key tiles at or below the diagonal ----
  for (int p0 = 0; p0 < P; p0 += kT) {
    for (int i0 = 0; i0 < q; i0 += kT) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 <= i0; k0 += kT) {
        float s[4][4] = {};
        __syncthreads();               // the last product's readers are done
        for (int n0 = 0; n0 < N; n0 += kT) {
          stage<true>(buf0, Cg, N, i0, q, n0, N, nullptr);   // [n][i]
          stage<true>(buf1, Bg, N, k0, q, n0, N, nullptr);   // [n][k]
          __syncthreads();
          tile_fma(s, buf0, buf1, ty, tx);                   // C B^T
          __syncthreads();
        }
        // w^T into buf0 ([k][i]); select, never multiply, the masked part
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = i0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gk = k0 + tx * 4 + j;
            float w = 0.f;
            if (gk <= gi && gi < q)
              w = s[i][j] * expf(cA[gi] - cA[gk]) * dts[gk];
            buf0[(tx * 4 + j) * kLd + ty * 4 + i] = w;
          }
        }
        stage<false>(buf1, xg, ldx, k0, q, p0, P, nullptr);  // [k][p]
        __syncthreads();
        tile_fma(acc, buf0, buf1, ty, tx);                   // w x
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + ty * 4 + i;
        if (gi >= q) continue;
        float* row = y + (((size_t)g * q + gi) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + tx * 4 + j;
          if (p < P) row[p] = acc[i][j];
        }
      }
    }
  }

  // ---- states: a 64 x 64 (p, n) tile over 64-row key tiles ----
  for (int p0 = 0; p0 < P; p0 += kT) {
    for (int n0 = 0; n0 < N; n0 += kT) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < q; k0 += kT) {
        __syncthreads();
        stage<false>(buf0, xg, ldx, k0, q, p0, P, sk);       // [k][p]
        stage<false>(buf1, Bg, N, k0, q, n0, N, nullptr);    // [k][n]
        __syncthreads();
        tile_fma(acc, buf0, buf1, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
        if (p >= P) continue;
        float* row = st + (((size_t)g * H + h) * P + p) * N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n < N) row[n] = acc[i][j];
        }
      }
    }
  }
}

template <typename T, typename TD, typename TA>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* st, int G, int q, int H, int P,
           int N, cudaStream_t s) {
  ssd_chunk_kernel<T, TD, TA><<<G * H, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt),
      static_cast<const TA*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(st), q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD>
int launch_a(int adt, const void* x, const void* dt, const void* A,
             const void* B, const void* C, void* y, void* st, int G, int q,
             int H, int P, int N, cudaStream_t s) {
  if (adt == kF32)
    return launch<T, TD, float>(x, dt, A, B, C, y, st, G, q, H, P, N, s);
  return launch<T, TD, __nv_bfloat16>(x, dt, A, B, C, y, st, G, q, H, P, N,
                                      s);
}

template <typename T>
int launch_dt(int dtdt, int adt, const void* x, const void* dt, const void* A,
              const void* B, const void* C, void* y, void* st, int G, int q,
              int H, int P, int N, cudaStream_t s) {
  if (dtdt == kF32)
    return launch_a<T, float>(adt, x, dt, A, B, C, y, st, G, q, H, P, N, s);
  return launch_a<T, __nv_bfloat16>(adt, x, dt, A, B, C, y, st, G, q, H, P, N,
                                    s);
}

}  // namespace

extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                                const void* B, const void* C, void* y,
                                void* st, int G, int q, int H, int P, int N,
                                int xdt, int dtdt, int adt, void* stream) {
  const bool types = (xdt == kF32 || xdt == kBF16) &&
                     (dtdt == kF32 || dtdt == kBF16) &&
                     (adt == kF32 || adt == kBF16);
  if (!types || q < 1 || q > kMaxQ || G < 1 || H < 1 || P < 0 || N < 0 ||
      (long long)G * H >= (1LL << 31))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdt == kF32)
    return launch_dt<float>(dtdt, adt, x, dt, A, B, C, y, st, G, q, H, P, N,
                            s);
  return launch_dt<__nv_bfloat16>(dtdt, adt, x, dt, A, B, C, y, st, G, q, H,
                                  P, N, s);
}
