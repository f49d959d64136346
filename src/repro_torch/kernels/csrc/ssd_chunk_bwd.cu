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
// So this route is bound by operations; a tensor-core route would face the
// bytes bound.
//
// Design: float32 FMA on the CUDA cores, the forward FMA kernel's tiling (64
// x 64 tiles staged in shared memory, 16 x 16 threads with a 4 x 4
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
// scratch the launch needs, ssd_chunk_bwd_route which kernel an input takes
// (0: this FMA kernel, the only one), and ssd_chunk_bwd_launch returns the
// first non-zero cudaGetLastError() after its launches, 0 on success, -1 for
// a dtype or shape this file does not take.

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

struct Scratch {                       // float offsets in the scratch
  size_t cA, dS, dBst, dA, total;
  Scratch(long long G, long long q, long long H, long long N) {
    cA = 0;
    dS = cA + G * q * H;
    dBst = dS + G * q * q;
    dA = dBst + G * q * N;
    total = dA + G * H;
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

}  // namespace

// float32 entries of the scratch a launch at these sizes needs
extern "C" long long ssd_chunk_bwd_scratch(int G, int q, int H, int N) {
  return static_cast<long long>(Scratch(G, q, H, N).total);
}

// 0: the float32 FMA kernel (the only route of this file)
extern "C" int ssd_chunk_bwd_route(const void* x, const void* B,
                                   const void* C, int q, int P, int N,
                                   int xdt) {
  return 0;
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
  if (xdt == kF32)
    return launch_dt<float>(dtdt, adt, x, dt, A, B, C, dy, dst, dx, ddt, dA,
                            dB, dC, scratch, G, q, H, P, N, s);
  return launch_dt<__nv_bfloat16>(dtdt, adt, x, dt, A, B, C, dy, dst, dx, ddt,
                                  dA, dB, dC, scratch, G, q, H, P, N, s);
}
