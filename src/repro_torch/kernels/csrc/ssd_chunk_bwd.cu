// The backward of the Mamba2 SSD intra-chunk contraction for Hopper (sm_90a).
//
// The TPU kernel (src/repro/kernels/ssd_chunk.py:51, ssd_chunk) has no
// backward: the JAX package trains through its pure twin (ssd_chunked in
// repro/models/layers.py) and lets XLA differentiate it. The port's forward
// runs its own kernel (ssd_chunk.cu), so its gradient is a kernel too: this
// file, called by the autograd Function SsdChunk in kernels/ssd_chunk.py.
//
// For one pair (g, h), with cA = cumsum(dt A[h]) over the chunk and i >= k
// (entries above the diagonal are selected away, never multiplied by a
// mask, so exp(cA_i - cA_k) is never taken where it may overflow):
//   L_ik = exp(cA_i - cA_k)   S_ik = C_i . B_k   W_ik = S_ik L_ik dt_k
//   E_k = exp(cA_last - cA_k)   dec_k = E_k dt_k
// and given dy (G, q, H, P) and dst (G, H, P, N), both float32:
//   dW_ik = sum_p dy_ip x_kp          U_kp = sum_n B_kn dst_pn
//   dx_kp = sum_{i>=k} W_ik dy_ip + dec_k U_kp
//   ddec_k = sum_p x_kp U_kp          M_ik = dW_ik W_ik
//   dcA_i = sum_k M_ik - sum_j M_ji - ddec_i dec_i  (+ sum_k ddec_k dec_k at
//           i = last)
//   ddt_k = sum_i dW_ik S_ik L_ik + ddec_k E_k + A sum_{i>=k} dcA_i
//   dA    = sum_{g,k} dt_k sum_{i>=k} dcA_i
//   dS_ik = sum_h dW_ik L_ik dt_k     (B and C are shared by the heads)
//   dC_i = sum_k dS_ik B_k            dB_k = sum_i dS_ik C_i
//                                            + sum_h dec_k sum_p x_kp dst_pn
//
// What bounds it on this card: at the training path's (G, q, H, P, N) =
// (64, 128, 80, 64, 128) with x, B, C in bf16 the bytes are x and dx (84 MB
// each), dy and dst (168 MB each, float32), B, C, dB, dC, dt, ddt (13 MB):
// about 518 MB, 0.155 ms at 3.35 TB/s. The work the data needs is 32.7
// GFLOP of float32 products (dW and W^T dy over the causal pairs, U and the
// states' dB term over every (k, p, n), a head: 2 x 5.4 + 2 x 10.7; S, dC and
// dB over the pairs once a g: 0.4), 0.49 ms on the CUDA cores' 67 TFLOP/s.
// So the FMA route below is bound by operations; the tensor-core route runs
// about 99 GFLOP of bf16 wgmma there (the float32 operands split into bf16
// terms, below), 0.10 ms at 989 TFLOP/s, and faces the bytes bound. Two
// routes, by input, as the forward's (ssd_chunk.cu):
//
//   * bf16 x, B, C with P = 64, N a multiple of 8 up to 128 and q up to 128
//     (mamba2's and jamba's training; tensors on 16 bytes, as TMA needs):
//     ssd_chunk_bwd_wgmma_kernel, wgmma fed by TMA (see "the tensor-core
//     route" below), then the partials' sums, dB/dC and dA;
//   * everything else (float32 inputs, other P or N, q up to 256): the
//     float32 FMA kernels described next.
//
// FMA route: float32 FMA on the CUDA cores, the forward FMA kernel's tiling
// (64 x 64 tiles staged in shared memory, 16 x 16 threads with a 4 x 4
// micro-tile each, read as float4), four launches on one stream, no atomics
// and every sum in a fixed order, so two calls give bitwise equal gradients:
// 1. ssd_chunk_bwd_head_kernel, a block a (g, h): stages dt and takes the
//    cumsum (written to a scratch (G, q, H) for the launches after it), then
//    for each key tile k and query tile i >= k recomputes S, dW, L and W
//    tile by tile, sums dx += W^T dy in registers, then adds dec U. The
//    row and column sums of M, the column sums of dW S L and the row sums
//    of x U go to shared arrays (half-warp shuffles across a row, a fixed
//    loop over the 16 thread rows down a column), one owner thread an
//    entry a tile. dcA is complete within the block, so the last steps (the
//    reverse cumsum across the 64-row tiles, ddt, dt . the reverse cumsum)
//    run there, in one warp; dA's per-(g, h) partial goes to a scratch.
//    P over 64 loops over 64-column tiles of dx, recomputing S and dW.
// 2. ssd_chunk_bwd_sum_kernel, the sums over heads, which no (g, h) block
//    can finish: a block a (g, lower tile pair) sums dS over the H heads in
//    order (dW again, times L dt from the scratch cumsum); a block a (g, key
//    tile, n tile) sums the states' dB term over heads and P. dS (G, q, q)
//    and that term (G, q, N) go to a float32 scratch: 4.2 MB each at the
//    main shape, where a per-(g, h) dS would be 335 MB.
// 3. ssd_chunk_bwd_bc_kernel, a block a (g, row tile, n tile): dC = dS B over
//    the lower tiles, dB = dS^T C plus the states' term.
// 4. ssd_chunk_bwd_da_kernel: dA, a thread a head, the partials summed over
//    g in order.
// Each gradient is stored once in its input's type. What the design costs
// beyond the bound: S is recomputed by every head (10.8 GFLOP at the main
// shape) and dW twice (5.4 more), as the forward's FMA kernel recomputes S.
//
// C interface (bound with ctypes): ssd_chunk_bwd_scratch gives the float32
// scratch a launch on these inputs needs, ssd_chunk_bwd_route which route an
// input takes (1: the tensor cores, 0: the FMA kernels), and
// ssd_chunk_bwd_launch returns the first non-zero cudaGetLastError() after
// its launches (or the error of setting the dynamic shared-memory size), 0 on
// success, -1 for a dtype or shape this file does not take, or -2
// (hopper::kTensorMapError) when a tensor map is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// the sum of v over the 16 threads of a thread row (a half warp), in a
// fixed tree: every lane gets it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over a warp in a fixed tree: every lane gets it
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the runs [k0, k1) of lane `lane` when one warp walks q entries
__device__ __forceinline__ void lane_run(int q, int lane, int& k0, int& k1) {
  const int per = (q + 31) / 32;
  k0 = min(lane * per, q);
  k1 = min(k0 + per, q);
}

template <typename T, typename TD, typename TA>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_head_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                          const TA* __restrict__ A, const T* __restrict__ B,
                          const T* __restrict__ C,
                          const float* __restrict__ dy,
                          const float* __restrict__ dst, T* __restrict__ dx,
                          TD* __restrict__ ddt, float* __restrict__ cA_out,
                          float* __restrict__ dA_part, int q, int H, int P,
                          int N) {
  __shared__ __align__(16) float buf0[kT * kLd];
  __shared__ __align__(16) float buf1[kT * kLd];
  __shared__ float dts[kMaxQ];         // dt_k
  __shared__ float cA[kMaxQ];          // cumsum of dt A
  __shared__ float E[kMaxQ];           // exp(cA_last - cA_k)
  __shared__ float rowM[kMaxQ];        // sum_k M_ik, then dcA_i
  __shared__ float colM[kMaxQ];        // sum_i M_ik
  __shared__ float tcol[kMaxQ];        // sum_i dW_ik S_ik L_ik
  __shared__ float ddec[kMaxQ];        // sum_p x_kp U_kp

  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t ldx = (size_t)H * P;    // x's row k of this head at k * ldx
  const T* xg = x + ((size_t)g * q * H + h) * P;
  const float* dyg = dy + ((size_t)g * q * H + h) * P;
  T* dxg = dx + ((size_t)g * q * H + h) * P;
  const float* dstg = dst + ((size_t)g * H + h) * P * N;   // (P, N)
  const T* Bg = B + (size_t)g * q * N;
  const T* Cg = C + (size_t)g * q * N;

  // ---- dt and the cumsum of dt A (warp 0: runs, then a shuffle scan) ----
  const float a = to_f32(A[h]);
  for (int k = tid; k < q; k += kThreads) {
    dts[k] = to_f32(dt[((size_t)g * q + k) * H + h]);
    rowM[k] = colM[k] = tcol[k] = ddec[k] = 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    int k0, k1;
    lane_run(q, tid, k0, k1);
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
  for (int k = tid; k < q; k += kThreads) {
    E[k] = expf(last - cA[k]);
    cA_out[((size_t)g * q + k) * H + h] = cA[k];
  }
  __syncthreads();

  for (int p0 = 0; p0 < P; p0 += kT) {           // dx's 64-column tiles
    const bool first = p0 == 0;                  // the sums, once
    for (int k0 = 0; k0 < q; k0 += kT) {
      float acc[4][4] = {};                      // dx[k][p]
      for (int i0 = k0; i0 < q; i0 += kT) {      // query tiles at or below
        float s[4][4] = {}, dw[4][4] = {};
        for (int n0 = 0; n0 < N; n0 += kT) {
          __syncthreads();             // the last product's readers are done
          stage<true>(buf0, Cg, N, i0, q, n0, N, nullptr);   // [n][i]
          stage<true>(buf1, Bg, N, k0, q, n0, N, nullptr);   // [n][k]
          __syncthreads();
          tile_fma(s, buf0, buf1, ty, tx);                   // C B^T
        }
        for (int c0 = 0; c0 < P; c0 += kT) {
          __syncthreads();
          stage<true>(buf0, dyg, ldx, i0, q, c0, P, nullptr);  // [p][i]
          stage<true>(buf1, xg, ldx, k0, q, c0, P, nullptr);   // [p][k]
          __syncthreads();
          tile_fma(dw, buf0, buf1, ty, tx);                  // dy x^T
        }
        __syncthreads();
        // W into buf0 ([i][k]); M's and dW S L's sums; select, never
        // multiply, the part above the diagonal
        float rm[4] = {}, cm[4] = {}, ct[4] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = i0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gk = k0 + tx * 4 + j;
            float w = 0.f;
            if (gk <= gi && gi < q) {
              const float sl = s[i][j] * expf(cA[gi] - cA[gk]);
              w = sl * dts[gk];
              const float m = dw[i][j] * w;
              rm[i] += m;
              cm[j] += m;
              ct[j] += dw[i][j] * sl;
            }
            buf0[(ty * 4 + i) * kLd + tx * 4 + j] = w;
          }
        }
        if (first) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = row_sum16(rm[i]);
            const int gi = i0 + ty * 4 + i;
            if (tx == 0 && gi < q) rowM[gi] += v;
          }
          // column partials of the 16 thread rows into buf1, then summed
          // down each column in thread-row order
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            buf1[ty * kT + tx * 4 + j] = cm[j];
            buf1[kT * 16 + ty * kT + tx * 4 + j] = ct[j];
          }
          __syncthreads();
          if (tid < 2 * kT) {
            const int c = tid % kT, which = tid / kT;
            float v = 0.f;
            for (int r = 0; r < 16; ++r) v += buf1[which * kT * 16 + r * kT + c];
            if (k0 + c < q) (which ? tcol : colM)[k0 + c] += v;
          }
          __syncthreads();
        }
        stage<false>(buf1, dyg, ldx, i0, q, p0, P, nullptr);  // [i][p]
        __syncthreads();
        tile_fma(acc, buf0, buf1, ty, tx);                    // W^T dy
      }
      // ---- U = B dst^T for this (k, p) tile: dx += dec U, ddec += x . U --
      float u[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += kT) {
        __syncthreads();
        stage<true>(buf0, Bg, N, k0, q, n0, N, nullptr);      // [n][k]
        stage<true>(buf1, dstg, N, p0, P, n0, N, nullptr);    // [n][p]
        __syncthreads();
        tile_fma(u, buf0, buf1, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = k0 + ty * 4 + i;
        float rd = 0.f;
        if (gk < q) {
          const float dec = E[gk] * dts[gk];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx * 4 + j;
            if (p < P) {
              rd += to_f32(xg[(size_t)gk * ldx + p]) * u[i][j];
              store(dxg + (size_t)gk * ldx + p, acc[i][j] + dec * u[i][j]);
            }
          }
        }
        rd = row_sum16(rd);
        if (tx == 0 && gk < q) ddec[gk] += rd;
      }
    }
  }
  __syncthreads();

  // ---- dcA, its reverse cumsum R, ddt and dt . R (warp 0) ----
  if (tid < 32) {
    int k0, k1;
    lane_run(q, tid, k0, k1);
    float tot = 0.f;                   // sum_k ddec_k dec_k
    for (int k = k0; k < k1; ++k) tot += ddec[k] * E[k] * dts[k];
    tot = warp_sum(tot);
    for (int k = k0; k < k1; ++k)
      rowM[k] = rowM[k] - colM[k] - ddec[k] * E[k] * dts[k] +
                (k == q - 1 ? tot : 0.f);
    float run = 0.f;                   // this lane's reverse running sums
    for (int k = k1 - 1; k >= k0; --k) {
      run += rowM[k];
      rowM[k] = run;
    }
    float incl = run;                  // suffix scan of the runs' totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, o);
      if (tid + o < 32) incl += v;
    }
    const float after = incl - run;
    float da = 0.f;
    for (int k = k0; k < k1; ++k) {
      const float R = rowM[k] + after;
      store(ddt + ((size_t)g * q + k) * H + h,
            tcol[k] + ddec[k] * E[k] + a * R);
      da += dts[k] * R;
    }
    da = warp_sum(da);
    if (tid == 0) dA_part[(size_t)g * H + h] = da;
  }
}

// blockIdx.y < npairs: dS for the lower tile pair (i, k) numbered
// i (i + 1) / 2 + k; else the states' dB term for a (key tile, n tile)
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_sum_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                         const float* __restrict__ dy,
                         const float* __restrict__ dst,
                         const float* __restrict__ cA,
                         float* __restrict__ dS, float* __restrict__ dBst,
                         int q, int H, int P, int N, int npairs, int ntn) {
  __shared__ __align__(16) float buf0[kT * kLd];
  __shared__ __align__(16) float buf1[kT * kLd];
  __shared__ float dec[kMaxQ];

  const int g = blockIdx.x, job = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t ldx = (size_t)H * P;
  const float* cAg = cA + (size_t)g * q * H;
  const TD* dtg = dt + (size_t)g * q * H;
  float acc[4][4] = {};
  if (job < npairs) {
    int it = 0;
    while ((it + 1) * (it + 2) / 2 <= job) ++it;
    const int i0 = it * kT, k0 = (job - it * (it + 1) / 2) * kT;
    for (int h = 0; h < H; ++h) {
      const T* xh = x + (size_t)g * q * ldx + (size_t)h * P;
      const float* dyh = dy + (size_t)g * q * ldx + (size_t)h * P;
      float dw[4][4] = {};
      for (int c0 = 0; c0 < P; c0 += kT) {
        __syncthreads();
        stage<true>(buf0, dyh, ldx, i0, q, c0, P, nullptr);  // [p][i]
        stage<true>(buf1, xh, ldx, k0, q, c0, P, nullptr);   // [p][k]
        __syncthreads();
        tile_fma(dw, buf0, buf1, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = k0 + tx * 4 + j;
          if (gk <= gi && gi < q)
            acc[i][j] += dw[i][j] *
                         expf(cAg[(size_t)gi * H + h] -
                              cAg[(size_t)gk * H + h]) *
                         to_f32(dtg[(size_t)gk * H + h]);
        }
      }
    }
    float* dSg = dS + (size_t)g * q * q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + tx * 4 + j;
        if (gi < q && gk < q) dSg[(size_t)gi * q + gk] = acc[i][j];
      }
    }
    return;
  }
  const int k0 = (job - npairs) / ntn * kT, n0 = (job - npairs) % ntn * kT;
  for (int h = 0; h < H; ++h) {
    const T* xh = x + (size_t)g * q * ldx + (size_t)h * P;
    const float* dsth = dst + ((size_t)g * H + h) * P * N;
    __syncthreads();                   // the last head's dec is read
    const float last = cAg[(size_t)(q - 1) * H + h];
    for (int k = tid; k < q; k += kThreads)
      dec[k] = expf(last - cAg[(size_t)k * H + h]) *
               to_f32(dtg[(size_t)k * H + h]);
    for (int c0 = 0; c0 < P; c0 += kT) {
      __syncthreads();
      stage<true>(buf0, xh, ldx, k0, q, c0, P, dec);         // [p][k]
      stage<false>(buf1, dsth, N, c0, P, n0, N, nullptr);    // [p][n]
      __syncthreads();
      tile_fma(acc, buf0, buf1, ty, tx);
    }
  }
  float* out = dBst + (size_t)g * q * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (gk < q && n < N) out[(size_t)gk * N + n] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_bc_kernel(const T* __restrict__ B, const T* __restrict__ C,
                        const float* __restrict__ dS,
                        const float* __restrict__ dBst, T* __restrict__ dB,
                        T* __restrict__ dC, int q, int N, int ntn) {
  __shared__ __align__(16) float buf0[kT * kLd];
  __shared__ __align__(16) float buf1[kT * kLd];

  const int g = blockIdx.x;
  const int rt = blockIdx.y / ntn, r0 = rt * kT, n0 = blockIdx.y % ntn * kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* dSg = dS + (size_t)g * q * q;
  const T* Bg = B + (size_t)g * q * N;
  const T* Cg = C + (size_t)g * q * N;
  float dc[4][4] = {}, db[4][4] = {};
  for (int k0 = 0; k0 <= r0; k0 += kT) {          // dC = dS B, tiles k <= r
    __syncthreads();
    stage<true>(buf0, dSg, q, r0, q, k0, q, nullptr);        // [k][i]
    stage<false>(buf1, Bg, N, k0, q, n0, N, nullptr);        // [k][n]
    __syncthreads();
    tile_fma(dc, buf0, buf1, ty, tx);
  }
  for (int i0 = r0; i0 < q; i0 += kT) {           // dB = dS^T C, tiles i >= r
    __syncthreads();
    stage<false>(buf0, dSg, q, i0, q, r0, q, nullptr);       // [i][k]
    stage<false>(buf1, Cg, N, i0, q, n0, N, nullptr);        // [i][n]
    __syncthreads();
    tile_fma(db, buf0, buf1, ty, tx);
  }
  const float* st = dBst + (size_t)g * q * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const size_t o = ((size_t)g * q + r) * N + n;
      store(dC + o, dc[i][j]);
      store(dB + o, db[i][j] + st[(size_t)r * N + n]);
    }
  }
}

template <typename TA>
__global__ void ssd_chunk_bwd_da_kernel(const float* __restrict__ dA_part,
                                        TA* __restrict__ dA, int G, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float v = 0.f;
  for (int g = 0; g < G; ++g) v += dA_part[(size_t)g * H + h];
  store(dA + h, v);
}

// float offsets in the scratch, each region on 16 bytes; ngrp head groups'
// partials of the tensor-core route (0 on the FMA route)
struct Scratch {
  size_t cA, dS, dBst, dA, partS, partB, total;
  Scratch(long long G, long long q, long long H, long long N,
          long long ngrp = 0) {
    auto up4 = [](long long n) { return (n + 3) / 4 * 4; };
    cA = 0;
    dS = cA + up4(G * q * H);
    dBst = dS + up4(G * q * q);
    dA = dBst + up4(G * q * N);
    partS = dA + up4(G * H);
    partB = partS + up4(G * ngrp * q * 128);
    total = partB + G * ngrp * q * N;
  }
};

template <typename T, typename TD, typename TA>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const float* dy, const float* dst, void* dx,
           void* ddt, void* dA, void* dB, void* dC, float* scratch, int G,
           int q, int H, int P, int N, cudaStream_t s) {
  const Scratch sc(G, q, H, N);
  float* cA = scratch + sc.cA;
  float* dS = scratch + sc.dS;
  float* dBst = scratch + sc.dBst;
  float* dA_part = scratch + sc.dA;
  const int nt = (q + kT - 1) / kT, ntn = (N + kT - 1) / kT;
  ssd_chunk_bwd_head_kernel<T, TD, TA><<<G * H, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt),
      static_cast<const TA*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), dy, dst, static_cast<T*>(dx),
      static_cast<TD*>(ddt), cA, dA_part, q, H, P, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int npairs = nt * (nt + 1) / 2;
  if (ntn > 0) {
    ssd_chunk_bwd_sum_kernel<T, TD><<<dim3(G, npairs + nt * ntn), kThreads,
                                      0, s>>>(
        static_cast<const T*>(x), static_cast<const TD*>(dt), dy, dst, cA, dS,
        dBst, q, H, P, N, npairs, ntn);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssd_chunk_bwd_bc_kernel<T><<<dim3(G, nt * ntn), kThreads, 0, s>>>(
        static_cast<const T*>(B), static_cast<const T*>(C), dS, dBst,
        static_cast<T*>(dB), static_cast<T*>(dC), q, N, ntn);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_chunk_bwd_da_kernel<TA><<<(H + kThreads - 1) / kThreads, kThreads, 0,
                                s>>>(dA_part, static_cast<TA*>(dA), G, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD>
int launch_a(int adt, const void* x, const void* dt, const void* A,
             const void* B, const void* C, const float* dy, const float* dst,
             void* dx, void* ddt, void* dA, void* dB, void* dC,
             float* scratch, int G, int q, int H, int P, int N,
             cudaStream_t s) {
  if (adt == kF32)
    return launch<T, TD, float>(x, dt, A, B, C, dy, dst, dx, ddt, dA, dB, dC,
                                scratch, G, q, H, P, N, s);
  return launch<T, TD, __nv_bfloat16>(x, dt, A, B, C, dy, dst, dx, ddt, dA,
                                      dB, dC, scratch, G, q, H, P, N, s);
}

template <typename T>
int launch_dt(int dtdt, int adt, const void* x, const void* dt, const void* A,
              const void* B, const void* C, const float* dy, const float* dst,
              void* dx, void* ddt, void* dA, void* dB, void* dC,
              float* scratch, int G, int q, int H, int P, int N,
              cudaStream_t s) {
  if (dtdt == kF32)
    return launch_a<T, float>(adt, x, dt, A, B, C, dy, dst, dx, ddt, dA, dB,
                              dC, scratch, G, q, H, P, N, s);
  return launch_a<T, __nv_bfloat16>(adt, x, dt, A, B, C, dy, dst, dx, ddt, dA,
                                    dB, dC, scratch, G, q, H, P, N, s);
}

// ---- the tensor-core route: wgmma fed by TMA --------------------------------
//
// ssd_chunk_bwd_wgmma_kernel: one block a (g, group of 8 heads), 640 blocks at
// the training shape, of three warpgroups (384 threads). Every product runs
// in (key k, query i) orientation, so that W^T is wgmma's register-A operand
// of dx with no transpose (an accumulator's pairs of 16 columns are the A
// registers of a product over them):
//   U = B dst^T                     (m64n64), then dx = dec_k U
//   V = x dst, dBst += dec_k V      (m64n64 over n's halves, dst MN-major)
//   S^T = B C^T, dW^T = x dy^T      (m64n32 over 32-query halves, both
//                                    operands in shared memory)
//   W^T = S^T L^T dt_k              (registers; the part above the diagonal
//                                    selected away before the exp)
//   dx += W^T dy                    (A from registers, dy MN-major)
// Warpgroup 0: one thread keeps TMA loads in flight through single-slot
// mbarrier pairs, each released by the consumers as soon as its last product
// has read it, so the next head's loads run under the rest of this head: dst
// after U and V, dy's first 64 rows after warpgroup 1's second query half,
// x and dy's other rows at the head's end; B_g and C_g once a block (SW128
// bf16 boxes), x_h (bf16), dy_h and dst_h (float32 SW128 boxes of 32
// columns). Two of its warps split each float32 tile into bf16 terms in
// place (a row's 128 bytes of each box become the same row of the hi and lo
// tiles: a warp reads four rows, __syncwarp, writes them), so dy and dst take
// no shared memory beyond their float32 tiles; rows past q are TMA's zeros,
// which are the zero terms already. Its last warp finishes each head from the
// consumers' sums (dcA, its reverse cumsum, ddt, dA's partial).
// Warpgroups 1 and 2 hold key rows 0-63 and 64-127 (the second idles at q <=
// 64) and walk the 32-query halves at or below their diagonal block (the
// first 0-3, the second 2-3; halves past q skipped). A consumer holds dB's
// states term (64 registers) across the heads, dx (32) across a head, and
// S^T, dW^T (16 each) and W's terms (16) a half, within the 168 registers
// of a 384-thread block: ptxas gave the consumers no more after setmaxnreg
// (and spilled the producer's code below it), so the kernel sets none; with
// 64-query blocks it spilled, and scaling U's accumulator in place into dx's
// serialized the wgmma (C7515). Column sums of M over a warp's 16 keys take a
// halving butterfly (7 shuffles a half, each lane keeping one column).
//
// Float32 accuracy from bf16 products: x, B and C are bf16, so S's, dW's,
// U's and V's terms are exact products. A float32 operand (dy, dst, W) v is
// split into hi = bf16(v) and lo = bf16(v - hi), |v - hi - lo| <= 2^-18 |v|.
// A product with one float32 operand takes hi and lo (two wgmma); W^T dy,
// of two, takes hi hi, hi lo and lo hi (three; the dropped lo lo is <= 2^-18
// of the product). So every term is within about 3 2^-18 of its exact
// value, summed in float32 on the tensor cores; against phase 8b's limit,
// 2^-10 of each gradient's terms' magnitudes, that leaves a factor of ~80
// (tests/test_torch_ssd_chunk.py emulates the split on the CPU).
//
// Sums over heads, no atomics, each in a fixed order: dS^T (a thread owns its
// accumulator entries in shared memory, added to head by head) and dB's
// states term (a consumer's registers) over the block's heads in order, one
// float32 partial a (g, head group) each: 42 MB each at the main shape.
// ssd_chunk_bwd_reduce_kernel sums the partials in group order (dS transposed
// back to (i, k) through a 32 x 32 tile), then the FMA route's dB/dC and dA
// kernels run on them. dW is computed once a head, S once a head and query
// half (4.2 MFLOP of the ~99 GFLOP at the main shape).

constexpr int kWQ = 128;               // longest chunk on this route
constexpr int kWHeads = 8;             // heads a block
constexpr int kWThreads = 384;         // producer + two consumer warpgroups
constexpr uint32_t kBox = 128 * 128;   // 128 rows of 128 bytes (B, C, x, dy)
constexpr uint32_t kDBox = 64 * 128;   // 64 rows of 128 bytes (dst)
constexpr float kLog2e = 1.4426950408889634f;

struct WgSmem {                        // byte offsets, 1024-aligned
  static constexpr uint32_t kC = 0;                    // C_g, 2 boxes
  static constexpr uint32_t kB = kC + 2 * kBox;        // B_g, 2 boxes
  static constexpr uint32_t kX = kB + 2 * kBox;        // x_h
  // dy_h: two float32 boxes (p 0-31, 32-63), then in place the hi and lo
  // bf16 tiles (128 rows x 64 p each)
  static constexpr uint32_t kDy = kX + kBox;
  // dst_h: four float32 boxes (n 0-31, ..., 96-127), then in place the hi
  // tile (two 64-column boxes) and the lo tile
  static constexpr uint32_t kDst = kDy + 2 * kBox;
  // dS^T's accumulators: warpgroup 1's 64 entries a thread (4 halves of
  // 16), then warpgroup 2's 32, entry e of thread t at e * 128 + t
  static constexpr uint32_t kDS = kDst + 4 * kDBox;
  static constexpr size_t kBytes = kDS + (64 + 32) * 128 * 4 + 1024;
};

__device__ __forceinline__ float wload(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the hi and lo bf16 terms of a pair (first in the low half)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// the A registers of one 16-deep step, hi and lo terms
using Terms = uint32_t[2][4];

template <int S>
__device__ __forceinline__ void keep_terms(Terms (&f)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[s][t][r]));
}

// x[k][p], x[k][p + 1] (p even) from x's SW128 tile
__device__ __forceinline__ float2 x_pair(const unsigned char* x, int k,
                                         int p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      x + hopper::sw128_offset(k, p >> 3) + (p & 7) * 2));
}

// the sum over the four lanes of a row (fixed tree)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mbarriers of a block: dy in two 64-row halves, each released as soon as
// the queries it holds are done (rows 0-63 after warpgroup 1's second
// 32-query half), so the next head's first half loads under this head's
// second
struct WgBars {
  uint64_t bc, x_full, x_empty, dst_full, dst_ready, dst_empty, dy_full[2],
      dy_ready[2], dy_empty[2], sums_full[2], sums_empty[2];
};

// By one warp, the float32 tile t's rows r0, r0 + step, ... below r1 into its
// hi (at t) and lo (at t + lo) bf16 tiles, in place: kRowsPerLane rows of 32
// / kRowsPerLane lanes at a time, each lane one 16-byte chunk of a row's
// float32 boxes (box_bytes apart; boxes at or past nboxes were not loaded
// and read as 0), four such loads before the warp writes. dst (one row at a
// time) has four float32 boxes of 32 columns, two to a bf16 box; dy (two
// rows) has two, one bf16 box.
template <int kRowsPerLane>
__device__ __forceinline__ void split_rows(unsigned char* t, int r0, int r1,
                                           int step, uint32_t box_bytes,
                                           int nboxes, uint32_t lo,
                                           int lane) {
  // lane -> (row of the pass, float32 box, chunk)
  constexpr int kLanesPerRow = 32 / kRowsPerLane;
  const int sub = lane / kLanesPerRow, b = (lane % kLanesPerRow) >> 3,
            c = lane & 7;
  const uint32_t hb = (b >> 1) * box_bytes * (kRowsPerLane == 1);
  const int chunk = (kRowsPerLane == 1 ? 4 * (b & 1) : 4 * b) + (c >> 1);
  for (int r = r0; r < r1; r += 4 * step * kRowsPerLane) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = r + (u * kRowsPerLane + sub) * step;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < r1 && b < nboxes)
        v[u] = *reinterpret_cast<const float4*>(
            t + b * box_bytes + hopper::sw128_offset(row, c));
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = r + (u * kRowsPerLane + sub) * step;
      if (row < r1) {
        uint2 h, l;
        split2(v[u].x, v[u].y, h.x, l.x);
        split2(v[u].z, v[u].w, h.y, l.y);
        const uint32_t o = hb + hopper::sw128_offset(row, chunk) + (c & 1) * 8;
        *reinterpret_cast<uint2*>(t + o) = h;
        *reinterpret_cast<uint2*>(t + lo + o) = l;
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
ssd_chunk_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_c,
                           const __grid_constant__ CUtensorMap map_dy,
                           const __grid_constant__ CUtensorMap map_dst,
                           const void* __restrict__ dt,
                           const void* __restrict__ A,
                           __nv_bfloat16* __restrict__ dx,
                           void* __restrict__ ddt,
                           float* __restrict__ dA_part,
                           float* __restrict__ partS,
                           float* __restrict__ partB, int q, int H, int N,
                           int dt_bf16, int a_bf16) {
  using namespace hopper;
  using L = WgSmem;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) WgBars bar;
  // per head of the group, float32, 0 past q (read as float2): dt_k, the
  // cumsum of dt A, exp(cA_last - cA_k) dt_k
  __shared__ __align__(16) float dts[kWHeads][kWQ];
  __shared__ __align__(16) float cA[kWHeads][kWQ];
  __shared__ __align__(16) float dec[kWHeads][kWQ];
  // a head's sums, by the head's parity: sum_k M_ki per (warpgroup, warp)
  // and sum_i M_ki, sum_i dW_ki S_ki L_ik, sum_p x_kp U_kp per key
  __shared__ float rowMp[2][2][4][kWQ];
  __shared__ float colM[2][kWQ], tcol[2][kWQ], ddec[2][kWQ];
  // 1024-aligned by an offset from the shared array itself, so that every
  // tile pointer stays in the shared window (32-bit LDS/STS addresses)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem + L::kX;
  unsigned char* dys = smem + L::kDy;
  unsigned char* dsts = smem + L::kDst;

  const int ngrp = (H + kWHeads - 1) / kWHeads;
  const int g = blockIdx.x / ngrp, grp = blockIdx.x % ngrp;
  const int h0 = grp * kWHeads, nh = min(kWHeads, H - h0);
  const int nb = (N + 63) / 64;        // 64-column boxes of B and C
  const int nbd = (N + 31) / 32;       // 32-column float32 boxes of dst
  const int tid = threadIdx.x, wg = tid / 128;
  // head h's loads: dst; x; dy's row half r (two float32 boxes of 64 rows,
  // each at the rows of the hi or lo tile it becomes)
  auto load_dst = [&](int h) {
    mbar_arrive_expect_tx(&bar.dst_full, nbd * kDBox);
    for (int b = 0; b < nbd; ++b)
      tma_load_4d(dsts + b * kDBox, &map_dst, &bar.dst_full, 32 * b, 0, h, g);
  };
  auto load_x = [&](int h) {
    mbar_arrive_expect_tx(&bar.x_full, kBox);
    tma_load_4d(xs, &map_x, &bar.x_full, 0, h, 0, g);
  };
  auto load_dy = [&](int h, int r) {
    if (64 * r >= q) {                 // rows no product reads
      mbar_arrive(&bar.dy_full[r]);
      return;
    }
    mbar_arrive_expect_tx(&bar.dy_full[r], kBox);
    for (int b = 0; b < 2; ++b)
      tma_load_4d(dys + b * kBox + r * 8192, &map_dy, &bar.dy_full[r],
                  32 * b, h, 64 * r, g);
  };

  if (tid == 0) {
    mbar_init(&bar.bc, 1);
    mbar_init(&bar.x_full, 1);
    mbar_init(&bar.dst_full, 1);
    mbar_init(&bar.dst_ready, 64);     // the two converting warps
    mbar_init(&bar.x_empty, 8);        // lane 0 of every consumer warp
    mbar_init(&bar.dst_empty, 8);
    for (int r = 0; r < 2; ++r) {
      mbar_init(&bar.dy_full[r], 1);
      mbar_init(&bar.dy_ready[r], 64);
      mbar_init(&bar.sums_full[r], 256);   // every consumer thread
      mbar_init(&bar.sums_empty[r], 1);    // the finishing warp
    }
    mbar_init(&bar.dy_empty[0], 4);    // warpgroup 1's warps: its queries
    mbar_init(&bar.dy_empty[1], 8);
    fence_barrier_init();
    // B, C and the first head's tiles are on their way during the scans
    mbar_arrive_expect_tx(&bar.bc, 2 * nb * kBox);
    for (int c = 0; c < nb; ++c) {
      tma_load_3d(smem + L::kC + c * kBox, &map_c, &bar.bc, c * 64, 0, g);
      tma_load_3d(smem + L::kB + c * kBox, &map_b, &bar.bc, c * 64, 0, g);
    }
    load_dst(h0);
    load_x(h0);
    load_dy(h0, 0);
    load_dy(h0, 1);
  }
  // dt of the group's heads, then a warp a head: the cumsum of dt A (per-
  // lane runs, then a shuffle scan of the runs' totals) and the decay to the
  // chunk's end; dS^T's accumulators start at 0
  for (int idx = tid; idx < kWHeads * kWQ; idx += kWThreads) {
    const int hh = idx / kWQ, k = idx % kWQ;
    dts[hh][k] = (hh < nh && k < q)
        ? wload(dt, ((size_t)g * q + k) * H + h0 + hh, dt_bf16) : 0.f;
  }
  {
    float* acc = reinterpret_cast<float*>(smem + L::kDS);
    for (int idx = tid; idx < (64 + 32) * 128; idx += kWThreads)
      acc[idx] = 0.f;
  }
  __syncthreads();
  if (tid / 32 < nh) {
    const int hh = tid / 32, lane = tid & 31;
    const float a = wload(A, h0 + hh, a_bf16);
    const int per = (q + 31) / 32;
    const int k0 = min(lane * per, q), k1 = min(k0 + per, q);
    float run = 0.f;
    for (int k = k0; k < k1; ++k) {
      run += dts[hh][k] * a;
      cA[hh][k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const float before = incl - run;
    for (int k = k0; k < k1; ++k) cA[hh][k] += before;
    __syncwarp();
    const float last = cA[hh][q - 1];
    for (int k = lane; k < kWQ; k += 32) {
      if (k < q) {
        dec[hh][k] = expf(last - cA[hh][k]) * dts[hh][k];
      } else {
        cA[hh][k] = 0.f;
        dec[hh][k] = 0.f;
      }
    }
  }
  __syncthreads();

  if (wg == 0) {
    const int warp = tid >> 5, lane = tid & 31;
    if (warp == 0) {
      // the producer: head it's tiles once the consumers have released
      // head it - 1's, in the order they release them
      for (int it = 1; it < nh && lane == 0; ++it) {
        const uint32_t ph = (it - 1) & 1;
        mbar_wait(&bar.dst_empty, ph);
        load_dst(h0 + it);
        mbar_wait(&bar.dy_empty[0], ph);
        load_dy(h0 + it, 0);
        mbar_wait(&bar.x_empty, ph);
        load_x(h0 + it);
        mbar_wait(&bar.dy_empty[1], ph);
        load_dy(h0 + it, 1);
      }
    } else if (warp < 3) {
      // the converters: each float32 tile into its bf16 hi and lo tiles, in
      // place (a row's bytes of the float32 boxes are the same row's bytes
      // of the two tiles), four rows a lane in flight. dy's rows past q are
      // TMA's zeros, the zero terms already
      const int cw = warp - 1;
      for (int it = 0; it < nh; ++it) {
        const uint32_t ph = it & 1;
        mbar_wait(&bar.dst_full, ph);
        split_rows<1>(dsts, cw, 64, 2, kDBox, nbd, 2 * kDBox, lane);
        fence_proxy_async();
        mbar_arrive(&bar.dst_ready);
        for (int r = 0; r < 2; ++r) {
          mbar_wait(&bar.dy_full[r], ph);
          split_rows<2>(dys, 64 * r + cw, min(q, 64 * r + 64), 2, kBox, 2,
                        kBox, lane);
          fence_proxy_async();
          mbar_arrive(&bar.dy_ready[r]);
        }
      }
    } else {
      // the finishing warp: dcA_i = sum_k M_ki - sum_i' M_ii' - ddec_i
      // dec_i (+ sum_k ddec_k dec_k at i = last), R its reverse cumsum,
      // ddt_k = tcol_k + ddec_k E_k + a R_k, dA's partial sum_k dt_k R_k
      const int per = (q + 31) / 32;   // <= 4
      const int k0 = min(lane * per, q), k1 = min(k0 + per, q);
      for (int it = 0; it < nh; ++it) {
        const int par = it & 1, h = h0 + it;
        mbar_wait(&bar.sums_full[par], (it >> 1) & 1);
        const float a = wload(A, h, a_bf16);
        float tot = 0.f;
        for (int k = k0; k < k1; ++k) tot += ddec[par][k] * dec[it][k];
        tot = wsum(tot);
        float d[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u;
          d[u] = 0.f;
          if (k < k1) {
            float rm = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) rm += rowMp[par][0][w][k];
            if (k >= 64)
#pragma unroll
              for (int w = 0; w < 4; ++w) rm += rowMp[par][1][w][k];
            d[u] = rm - colM[par][k] - ddec[par][k] * dec[it][k] +
                   (k == q - 1 ? tot : 0.f);
          }
        }
        float run = 0.f;               // this lane's reverse running sums
#pragma unroll
        for (int u = 3; u >= 0; --u)
          if (k0 + u < k1) {
            run += d[u];
            d[u] = run;
          }
        float incl = run;              // suffix scan of the runs' totals
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_down_sync(0xffffffffu, incl, o);
          if (lane + o < 32) incl += v;
        }
        const float after = incl - run;
        const float last = cA[it][q - 1];
        float da = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u;
          if (k < k1) {
            const float R = d[u] + after;
            const float v = tcol[par][k] +
                            ddec[par][k] * expf(last - cA[it][k]) + a * R;
            const size_t o = ((size_t)g * q + k) * H + h;
            if (dt_bf16)
              static_cast<__nv_bfloat16*>(ddt)[o] = __float2bfloat16_rn(v);
            else
              static_cast<float*>(ddt)[o] = v;
            da += dts[it][k] * R;
          }
        }
        da = wsum(da);
        if (lane == 0) dA_part[(size_t)g * H + h] = da;
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar.sums_empty[par]);
      }
    }
  } else {
    // ---- consumers: warpgroup 1 key rows 0-63, warpgroup 2 rows 64-127
    const int kh = wg - 1, ctid = tid & 127;
    const int lane = tid & 31, warp = ctid >> 5;
    const int g8 = lane >> 2, tq = lane & 3;
    const int ka = 64 * kh + warp * 16 + g8, kb = ka + 8;   // its keys
    const bool active = 64 * kh < q;
    const unsigned char* cs = smem + L::kC;
    const unsigned char* bs = smem + L::kB;
    float* dsacc = reinterpret_cast<float*>(smem + L::kDS) + kh * 64 * 128 +
                   ctid;
    float bst[64];                     // dB's states term: keys x 128 n
#pragma unroll
    for (int i = 0; i < 64; ++i) bst[i] = 0.f;
    mbar_wait(&bar.bc, 0);

    for (int it = 0; it < nh; ++it) {
      const uint32_t ph = it & 1;
      const int par = it & 1;
      const float* dth = dts[it];
      const float* cAh = cA[it];
      const float* dech = dec[it];
      mbar_wait(&bar.dst_ready, ph);
      float dxa[32];                   // dx: keys x 64 p
      float ddec_a = 0.f, ddec_b = 0.f;
      if (active) {
        const float ea = dech[ka], eb = dech[kb];
        // U = B dst^T: B_g's key rows against dst's hi and lo tiles
        // (K-major); x is still on its way
        float u[32];
        wgmma_fence();
        for (int kk = 0; kk < 4 * nb; ++kk) {
          const uint32_t o = (kk >> 2) * kDBox + (kk & 3) * 32;
          const uint64_t da =
              desc_kmajor(bs + (kk >> 2) * kBox + kh * 8192 + (kk & 3) * 32);
          wgmma_ss_n64<0, 0>(u, da, desc_kmajor(dsts + o), kk > 0);
          wgmma_ss_n64<0, 0>(u, da, desc_kmajor(dsts + 2 * kDBox + o), 1);
        }
        wgmma_commit();
        mbar_wait(&bar.x_full, ph);
        wgmma_wait<0>();
        fence_regs(u);
        // ddec_k = x_k . U_k, and dx starts at dec_k U_k in registers of
        // its own (C7515, above)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * tq;
          const float2 xa = x_pair(xs, ka, p), xb = x_pair(xs, kb, p);
          ddec_a += xa.x * u[4 * j] + xa.y * u[4 * j + 1];
          ddec_b += xb.x * u[4 * j + 2] + xb.y * u[4 * j + 3];
          dxa[4 * j] = ea * u[4 * j];
          dxa[4 * j + 1] = ea * u[4 * j + 1];
          dxa[4 * j + 2] = eb * u[4 * j + 2];
          dxa[4 * j + 3] = eb * u[4 * j + 3];
        }
        ddec_a = quad_sum(ddec_a);
        ddec_b = quad_sum(ddec_b);
        // dB's states term += dec_k (x dst)_k, a 64-column half of n at a
        // time: x's key rows (K-major) against dst's hi and lo tiles
        // (MN-major, K = p)
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          float v[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = desc_kmajor(xs + kh * 8192 + kk * 32);
            const uint32_t o = hb * kDBox + kk * 2048;
            wgmma_ss_n64<0, 1>(v, da, desc_mnmajor(dsts + o, kDBox), kk > 0);
            wgmma_ss_n64<0, 1>(v, da,
                               desc_mnmajor(dsts + 2 * kDBox + o, kDBox), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bst[32 * hb + 4 * j] += ea * v[4 * j];
            bst[32 * hb + 4 * j + 1] += ea * v[4 * j + 1];
            bst[32 * hb + 4 * j + 2] += eb * v[4 * j + 2];
            bst[32 * hb + 4 * j + 3] += eb * v[4 * j + 3];
          }
        }
      } else {
        mbar_wait(&bar.x_full, ph);
      }
      if (lane == 0) mbar_arrive(&bar.dst_empty);      // dst is read
      if (it >= 2) mbar_wait(&bar.sums_empty[par], ((it >> 1) + 1) & 1);
      float colm_a = 0.f, colm_b = 0.f, tc_a = 0.f, tc_b = 0.f;
      const float cka = cAh[ka], ckb = cAh[kb];
      const float dta = dth[ka], dtb = dth[kb];
      // the 32-query halves at or below the diagonal block: warpgroup 1
      // 0-3, warpgroup 2 2-3; halves past q skipped, but every warp waits
      // for and releases each dy half it owns, every head
      for (int ih = 2 * kh; ih < 4; ++ih) {
        if (!(ih & 1)) mbar_wait(&bar.dy_ready[ih >> 1], ph);
        const int i0 = 32 * ih;
        if (active && i0 < q) {
          // S^T and dW^T of this half (keys x 32 queries)
          float s[16], dw[16];
          wgmma_fence();
          for (int kk = 0; kk < 4 * nb; ++kk)
            wgmma_ss_n32<0, 0>(
                s,
                desc_kmajor(bs + (kk >> 2) * kBox + kh * 8192 + (kk & 3) * 32),
                desc_kmajor(cs + (kk >> 2) * kBox + i0 * 128 + (kk & 3) * 32),
                kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = desc_kmajor(xs + kh * 8192 + kk * 32);
            wgmma_ss_n32<0, 0>(dw, da, desc_kmajor(dys + i0 * 128 + kk * 32),
                               kk > 0);
            wgmma_ss_n32<0, 0>(
                dw, da, desc_kmajor(dys + kBox + i0 * 128 + kk * 32), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dw);
          // W^T = S^T L^T dt_k, entries i < k or i >= q selected away
          // before the exp; M = dW W's sums; dS^T += dW L dt_k; W's A terms
          Terms f[2];
          float* acc = dsacc + (ih - 2 * kh) * 16 * 128;
          float cs8[8];                // column sums of M over the 2 rows
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + 8 * j + 2 * tq;
            const float2 ci = *reinterpret_cast<const float2*>(cAh + i);
            float w[4], m[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {    // e = 2 (row b) + (column + 1)
              const int r = e >> 1, c = e & 1;
              const int k = r ? kb : ka, ii = i + c;
              const float ck = r ? ckb : cka, dk = r ? dtb : dta;
              const bool keep = ii >= k && ii < q;
              const float L =
                  exp2_approx(keep ? ((c ? ci.y : ci.x) - ck) * kLog2e
                                   : -INFINITY);
              const float sl = s[4 * j + e] * L;
              const float dwv = dw[4 * j + e];
              w[e] = sl * dk;
              m[e] = dwv * w[e];
              if (r) {
                colm_b += m[e];
                tc_b += dwv * sl;
              } else {
                colm_a += m[e];
                tc_a += dwv * sl;
              }
              acc[(4 * j + e) * 128] += dwv * L * dk;
            }
            split2(w[0], w[1], f[j >> 1][0][2 * (j & 1)],
                   f[j >> 1][1][2 * (j & 1)]);
            split2(w[2], w[3], f[j >> 1][0][2 * (j & 1) + 1],
                   f[j >> 1][1][2 * (j & 1) + 1]);
            cs8[2 * j] = m[0] + m[2];
            cs8[2 * j + 1] = m[1] + m[3];
          }
          // dx += W^T dy over this half's 32 queries: dy MN-major (K = i)
          wgmma_fence();
#pragma unroll
          for (int js = 0; js < 2; ++js) {
            const uint32_t o = (i0 + 16 * js) * 128;
            const uint64_t bh = desc_mnmajor(dys + o, kBox);
            const uint64_t bl = desc_mnmajor(dys + kBox + o, kBox);
            wgmma_rs_n64<1>(dxa, f[js][0], bh, 1);
            wgmma_rs_n64<1>(dxa, f[js][0], bl, 1);
            wgmma_rs_n64<1>(dxa, f[js][1], bh, 1);
          }
          wgmma_commit();
          // meanwhile, sum_k M_ki of the warp's 16 keys: the 8 column sums
          // of a lane over its column's 8 lanes (xor 4, 8, 16), each step
          // keeping half the columns, so lane (g8, tq) ends with column
          // 8 (j) + 2 tq + c of index 4 g8_0 + 2 g8_1 + g8_2 = 2 j + c
          {
            const bool b0 = g8 & 1, b1 = (g8 >> 1) & 1, b2 = (g8 >> 2) & 1;
            float v4[4], v2[2];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              v4[t] = (b0 ? cs8[4 + t] : cs8[t]) +
                      __shfl_xor_sync(0xffffffffu, b0 ? cs8[t] : cs8[4 + t],
                                      4);
#pragma unroll
            for (int t = 0; t < 2; ++t)
              v2[t] = (b1 ? v4[2 + t] : v4[t]) +
                      __shfl_xor_sync(0xffffffffu, b1 ? v4[t] : v4[2 + t], 8);
            const float v1 =
                (b2 ? v2[1] : v2[0]) +
                __shfl_xor_sync(0xffffffffu, b2 ? v2[0] : v2[1], 16);
            const int idx = 4 * b0 + 2 * b1 + b2;
            rowMp[par][kh][warp][i0 + 8 * (idx >> 1) + 2 * tq + (idx & 1)] =
                v1;
          }
          wgmma_wait<0>();
          keep_terms(f);
          fence_regs(dxa);
        }
        if ((ih & 1) && lane == 0) mbar_arrive(&bar.dy_empty[ih >> 1]);
      }
      if (lane == 0) mbar_arrive(&bar.x_empty);        // x is read
      if (active) {
        colm_a = quad_sum(colm_a);
        colm_b = quad_sum(colm_b);
        tc_a = quad_sum(tc_a);
        tc_b = quad_sum(tc_b);
        if (tq == 0) {
          colM[par][ka] = colm_a;
          colM[par][kb] = colm_b;
          tcol[par][ka] = tc_a;
          tcol[par][kb] = tc_b;
          ddec[par][ka] = ddec_a;
          ddec[par][kb] = ddec_b;
        }
      }
      mbar_arrive(&bar.sums_full[par]);
      if (active) {                    // dx in bf16, keys below q
        const int h = h0 + it;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * tq;
          if (ka < q)
            *reinterpret_cast<__nv_bfloat162*>(
                dx + (((size_t)g * q + ka) * H + h) * 64 + p) =
                __floats2bfloat162_rn(dxa[4 * j], dxa[4 * j + 1]);
          if (kb < q)
            *reinterpret_cast<__nv_bfloat162*>(
                dx + (((size_t)g * q + kb) * H + h) * 64 + p) =
                __floats2bfloat162_rn(dxa[4 * j + 2], dxa[4 * j + 3]);
        }
      }
    }
    // the group's partials: dS^T (keys x 128, i < q) and dB's states term
    if (active) {
      const size_t gp = (size_t)g * ngrp + grp;
      float* pS = partS + gp * q * kWQ;
      float* pB = partB + gp * q * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = 8 * j + 2 * tq;
        if (n < N) {
          if (ka < q)
            *reinterpret_cast<float2*>(pB + (size_t)ka * N + n) =
                make_float2(bst[4 * j], bst[4 * j + 1]);
          if (kb < q)
            *reinterpret_cast<float2*>(pB + (size_t)kb * N + n) =
                make_float2(bst[4 * j + 2], bst[4 * j + 3]);
        }
      }
      for (int ih = 2 * kh; ih < 4 && 32 * ih < q; ++ih) {
        const float* acc = dsacc + (ih - 2 * kh) * 16 * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 32 * ih + 8 * j + 2 * tq;
          if (i >= q) continue;
          if (ka < q)
            *reinterpret_cast<float2*>(pS + (size_t)ka * kWQ + i) =
                make_float2(acc[(4 * j) * 128], acc[(4 * j + 1) * 128]);
          if (kb < q)
            *reinterpret_cast<float2*>(pS + (size_t)kb * kWQ + i) =
                make_float2(acc[(4 * j + 2) * 128], acc[(4 * j + 3) * 128]);
        }
      }
    }
  }
}

// The partials' sums in group order: dS (G, q, q) = the transposed sum of
// the groups' dS^T where i >= k, else 0 (a 32 x 32 tile a block of
// blockIdx.y < ntq^2), and dB's states term (G, q, N) (256 entries a block
// after them), in the layout the dB/dC kernel reads.
__global__ void __launch_bounds__(256)
ssd_chunk_bwd_reduce_kernel(const float* __restrict__ partS,
                            const float* __restrict__ partB,
                            float* __restrict__ dS, float* __restrict__ dBst,
                            int q, int N, int ngrp, int ntq) {
  __shared__ float tile[32][33];
  const int g = blockIdx.x, job = blockIdx.y;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  if (job < ntq * ntq) {
    const int k0 = job / ntq * 32, i0 = job % ntq * 32;
    for (int r = ty; r < 32; r += 8) {
      const int k = k0 + r, i = i0 + tx;
      float v = 0.f;
      if (k < q && i < q && i >= k)
        for (int gr = 0; gr < ngrp; ++gr)
          v += partS[(((size_t)g * ngrp + gr) * q + k) * kWQ + i];
      tile[r][tx] = v;
    }
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {
      const int i = i0 + r, k = k0 + tx;
      if (i < q && k < q) dS[((size_t)g * q + i) * q + k] = tile[tx][r];
    }
    return;
  }
  const size_t e = (size_t)(job - ntq * ntq) * 256 + threadIdx.x;
  const size_t n = (size_t)q * N;
  if (e >= n) return;
  float v = 0.f;
  for (int gr = 0; gr < ngrp; ++gr)
    v += partB[((size_t)g * ngrp + gr) * n + e];
  dBst[(size_t)g * n + e] = v;
}

// the tensor-core route: bf16 x, B and C with P = 64, N a multiple of 8 up
// to 128 and q up to 128, tensors on 16 bytes (TMA); the forward's domain
bool wgmma_fits(const void* x, const void* B, const void* C, int q, int P,
                int N, int xdt) {
  return xdt == kBF16 && P == 64 && N % 8 == 0 && N >= 8 && N <= 128 &&
         q >= 1 && q <= kWQ &&
         (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(C)) % 16 == 0;
}

int launch_wgmma(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const float* dy, const float* dst, void* dx,
                 void* ddt, void* dA, void* dB, void* dC, float* scratch,
                 int G, int q, int H, int P, int N, int dtdt, int adt,
                 cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dst)) %
      16)
    return -1;
  const int ngrp = (H + kWHeads - 1) / kWHeads;
  const long long blocks = (long long)G * ngrp;
  if (blocks >= (1LL << 31)) return -1;
  CUtensorMap map_x, map_b, map_c, map_dy, map_dst;
  // x and dy (G, q, H, P): dims innermost first (P, H, q, G)
  const uint64_t x_dims[4] = {(uint64_t)P, (uint64_t)H, (uint64_t)q,
                              (uint64_t)G};
  const uint64_t x_strides[3] = {(uint64_t)P, (uint64_t)H * P,
                                 (uint64_t)q * H * P};
  const uint32_t x_box[4] = {64, 1, kWQ, 1};
  const uint32_t dy_box[4] = {32, 1, 64, 1};
  // B, C (G, q, N): (N, q, G)
  const uint64_t bc_dims[3] = {(uint64_t)N, (uint64_t)q, (uint64_t)G};
  const uint64_t bc_strides[2] = {(uint64_t)N, (uint64_t)q * N};
  const uint32_t bc_box[3] = {64, kWQ, 1};
  // dst (G, H, P, N): (N, P, H, G)
  const uint64_t st_dims[4] = {(uint64_t)N, (uint64_t)P, (uint64_t)H,
                               (uint64_t)G};
  const uint64_t st_strides[3] = {(uint64_t)N, (uint64_t)P * N,
                                  (uint64_t)H * P * N};
  const uint32_t st_box[4] = {32, 64, 1, 1};
  if (hopper::make_map_bf16(&map_x, x, 4, x_dims, x_strides, x_box) ||
      hopper::make_map_bf16(&map_b, B, 3, bc_dims, bc_strides, bc_box) ||
      hopper::make_map_bf16(&map_c, C, 3, bc_dims, bc_strides, bc_box) ||
      hopper::make_map_f32(&map_dy, dy, 4, x_dims, x_strides, dy_box) ||
      hopper::make_map_f32(&map_dst, dst, 4, st_dims, st_strides, st_box))
    return hopper::kTensorMapError;
  const size_t smem = WgSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Scratch sc(G, q, H, N, ngrp);
  float* dS = scratch + sc.dS;
  float* dBst = scratch + sc.dBst;
  float* dA_part = scratch + sc.dA;
  ssd_chunk_bwd_wgmma_kernel<<<(unsigned)blocks, kWThreads, smem, stream>>>(
      map_x, map_b, map_c, map_dy, map_dst, dt, A,
      static_cast<__nv_bfloat16*>(dx), ddt, dA_part, scratch + sc.partS,
      scratch + sc.partB, q, H, N, dtdt == kBF16, adt == kBF16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntq = (q + 31) / 32;
  const int nst = (int)(((long long)q * N + 255) / 256);
  ssd_chunk_bwd_reduce_kernel<<<dim3(G, ntq * ntq + nst), 256, 0, stream>>>(
      scratch + sc.partS, scratch + sc.partB, dS, dBst, q, N, ngrp, ntq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (q + kT - 1) / kT, ntn = (N + kT - 1) / kT;
  ssd_chunk_bwd_bc_kernel<__nv_bfloat16><<<dim3(G, nt * ntn), kThreads, 0,
                                           stream>>>(
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), dS, dBst,
      static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC), q, N,
      ntn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nda = (H + kThreads - 1) / kThreads;
  if (adt == kF32)
    ssd_chunk_bwd_da_kernel<float><<<nda, kThreads, 0, stream>>>(
        dA_part, static_cast<float*>(dA), G, H);
  else
    ssd_chunk_bwd_da_kernel<__nv_bfloat16><<<nda, kThreads, 0, stream>>>(
        dA_part, static_cast<__nv_bfloat16*>(dA), G, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 entries of the scratch a launch on these inputs needs (the
// tensor-core route adds its head groups' partials)
extern "C" long long ssd_chunk_bwd_scratch(const void* x, const void* B,
                                           const void* C, int G, int q, int H,
                                           int P, int N, int xdt) {
  const int ngrp = wgmma_fits(x, B, C, q, P, N, xdt)
                       ? (H + kWHeads - 1) / kWHeads : 0;
  return static_cast<long long>(Scratch(G, q, H, N, ngrp).total);
}

// 1 where an input takes the tensor-core route, 0 where the FMA kernels
extern "C" int ssd_chunk_bwd_route(const void* x, const void* B,
                                   const void* C, int q, int P, int N,
                                   int xdt) {
  return wgmma_fits(x, B, C, q, P, N, xdt) ? 1 : 0;
}

extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt,
                                    const void* A, const void* B,
                                    const void* C, const float* dy,
                                    const float* dst, void* dx, void* ddt,
                                    void* dA, void* dB, void* dC,
                                    float* scratch, int G, int q, int H,
                                    int P, int N, int xdt, int dtdt, int adt,
                                    void* stream) {
  const bool types = (xdt == kF32 || xdt == kBF16) &&
                     (dtdt == kF32 || dtdt == kBF16) &&
                     (adt == kF32 || adt == kBF16);
  if (!types || q < 1 || q > kMaxQ || G < 1 || H < 1 || P < 1 || N < 0 ||
      (long long)G * H >= (1LL << 31))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma_fits(x, B, C, q, P, N, xdt))
    return launch_wgmma(x, dt, A, B, C, dy, dst, dx, ddt, dA, dB, dC, scratch,
                        G, q, H, P, N, dtdt, adt, s);
  if (xdt == kF32)
    return launch_dt<float>(dtdt, adt, x, dt, A, B, C, dy, dst, dx, ddt, dA,
                            dB, dC, scratch, G, q, H, P, N, s);
  return launch_dt<__nv_bfloat16>(dtdt, adt, x, dt, A, B, C, dy, dst, dx, ddt,
                                  dA, dB, dC, scratch, G, q, H, P, N, s);
}
