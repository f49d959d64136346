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
// Numerics are the Pallas kernel's (:25-48): every input is cast to float32,
// the cumsum, the scores, the decay and both products are float32, and the
// outputs are float32. Above the diagonal cA_i - cA_k is positive and its exp
// may overflow: those entries are selected away, never multiplied by a 0/1
// mask, so no 0 * inf reaches a sum.
//
// What bounds it on this card: at the main path's (G, q, H, P, N) = (64,
// 128, 80, 64, 128) with x, B, C in bf16 the bytes are 84 MB of x, 4 MB of B
// and C, 1.3 MB of dt and 336 MB of float32 y and states: 424.9 MB, 0.127 ms
// at 3.35 TB/s. The work the data needs is 16.3 GFLOP of float32 products
// (C B^T once per g and w x over the causal pairs, the states over every
// (k, p, n)), 0.243 ms on the CUDA cores' 67 TFLOP/s; on the tensor cores
// the route below runs about 72 GFLOP of bf16 wgmma, 0.073 ms at 989
// TFLOP/s. So the tensor-core route is bound by bytes, and the f32 route by
// operations. The TPU kernel holds one (g, h) pair's chunk in VMEM and runs
// the three products on the MXU. Two kernels, by input:
//
//   * bf16 x, B, C with P = 64, N a multiple of 8 up to 128 and q up to 128
//     (mamba2's heads; tensors on 16 bytes, as TMA needs):
//     ssd_chunk_wgmma_kernel, on wgmma fed by TMA. One block per (g, group
//     of 8 heads): 640 blocks at the main shape, of four warpgroups. First
//     one thread TMA-loads B_g and C_g (q x N, SW128 boxes of 64 columns)
//     and the first heads' x_{g,h} (q x 64) into a two-stage mbarrier
//     ring, and all sixteen warps stage dt and take the cumsum of dt A of
//     the group's heads (a warp a head: per-lane runs, then a shuffle scan
//     of their totals) and exp(cA_last - cA_k) dt_k, in float32. Then
//     warpgroup 0 streams the rest of x, one head ahead of the slowest
//     consumer, and three consumer warpgroups run at the same time, per
//     head:
//       - warpgroups 1 and 2, y for query rows 0-63 and 64-127, a 64-key
//         half at a time: S = C B^T for their rows and the half's keys,
//         wgmma m64n64k16 with both operands K-major in shared memory
//         (bf16 x bf16 products are exact in float32, so these are the
//         float32 scores); then w = S exp(cA_i - cA_k) dt_k where k <= i,
//         else 0 (selected), in registers, split into three bf16 terms
//         hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid) that
//         carry w's 24 bits; y += w x as three wgmma m64n64k16 a 16-key
//         step (A from registers, as flash's P V; x MN-major), over the
//         keys at or below the rows' diagonal only. The exact bf16 x bf16
//         products summed in float32 give the float32 product to within
//         summation order;
//       - warpgroup 3, the states (p x all of n): xw = x exp(cA_last -
//         cA_k) dt_k, read from x's shared tile and split the same way into
//         the register A operand (p x k), against B MN-major, wgmma
//         m64n128k16;
//       - each puts its result through its own shared staging (float32
//         SW128 boxes of 32 columns) to TMA stores (rows past q and columns
//         past N are not written), which run under the next head.
//     512 threads leave ptxas 128 registers a thread, so the A terms are
//     built two key steps (24 registers) at a time; a y consumer holds 32
//     score and 32 accumulator registers besides, the states' 64. With the
//     three products in three warpgroups the tensor cores, the ALU work of
//     the splits and the stores of one warpgroup overlap the others'.
//   * everything else (float32 inputs, other P, N, q up to 256):
//     ssd_chunk_kernel, float32 FMA on the CUDA cores. One block per (g, h)
//     walks the chunk in 64 x 64 tiles, so any q up to 256 and any P, N up
//     to 256 fit in 37 KB of shared memory: s = C B^T for each key tile at
//     or below the diagonal, then w = s exp(cA_i - cA_k) dt_k (selected)
//     and y += w x, tiles above the diagonal skipped; the states a 64 x 64
//     (p, n) tile at a time over 64-row key tiles; every product a 16 x 16
//     thread grid with a 4 x 4 float32 micro-tile per thread, read from
//     shared memory as float4; x, B and C widened from their own type.
//
// ssd_chunk_route says which kernel an input takes.
//
// C interface (bound with ctypes): ssd_chunk_launch returns cudaGetLastError()
// after the launch (or the error of setting the dynamic shared-memory size),
// 0 on success, -1 for a dtype or shape this file does not take, or -2
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


// ---- bf16 on the tensor cores: wgmma fed by TMA ----------------------------
//
// Thread (w, g8, tq) of a consumer warpgroup (w its warp, lane = 4 g8 + tq)
// holds rows 16 w + g8 and 16 w + g8 + 8 of its 64 (hopper.cuh's accumulator
// layout): query rows for S and y, p rows for the states.

constexpr int kWQ = 128;               // longest chunk on this route
constexpr int kWHeads = 8;             // heads a block
constexpr int kWStages = 2;            // x stages
constexpr int kWThreads = 512;         // producer + three consumers
constexpr int kNS = 2;                 // 16-key steps an A chunk holds
constexpr uint32_t kBox = 128 * 128;   // a 128-row SW128 bf16 box (B, C, x)
constexpr uint32_t kOutBox = 64 * 128; // a 64-row SW128 f32 box (32 columns)
constexpr float kLog2e = 1.4426950408889634f;

struct WgmmaSmem {                     // byte offsets, 1024-aligned
  static constexpr uint32_t kC = 0;                    // C_g, 2 boxes
  static constexpr uint32_t kB = kC + 2 * kBox;        // B_g, 2 boxes
  static constexpr uint32_t kX = kB + 2 * kBox;        // x ring
  static constexpr uint32_t kY = kX + kWStages * kBox; // y staging, 2 x 64 rows
  static constexpr uint32_t kSt = kY + 4 * kOutBox;    // states staging
  static constexpr size_t kBytes = kSt + 4 * kOutBox + 1024;  // + align
};

// a float32 value split into three bf16 terms hi + mid + lo that carry its
// 24 bits: each residual is exact in float32
struct Split3 {
  __nv_bfloat16 t[3];
};
__device__ __forceinline__ Split3 split3(float v) {
  Split3 s;
  s.t[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(s.t[0]);
  s.t[1] = __float2bfloat16_rn(r1);
  s.t[2] = __float2bfloat16_rn(r1 - __bfloat162float(s.t[1]));
  return s;
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(&lo) |
         (uint32_t)*reinterpret_cast<const uint16_t*>(&hi) << 16;
}

// an A chunk: the register A operands of kNS 16-key steps, three terms each
using Chunk = uint32_t[kNS][3][4];

// the three terms' A registers from a pair (first, second) of a row
__device__ __forceinline__ void split_pair(uint32_t (&f)[3][4], int reg,
                                           float first, float second) {
  const Split3 a = split3(first), b = split3(second);
#pragma unroll
  for (int t = 0; t < 3; ++t) f[t][reg] = pack2(a.t[t], b.t[t]);
}

// keeps the A registers of in-flight wgmma live (and unchanged) up to the
// wait that follows them
__device__ __forceinline__ void keep_regs(Chunk& f) {
#pragma unroll
  for (int i = 0; i < kNS; ++i)
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[i][t][r]));
}

// an m64nN f32 accumulator (N = 2 NA) into N / 32 SW128 f32 boxes (32
// columns each) of 64 rows
template <int NA>
__device__ __forceinline__ void stage_out(unsigned char* out,
                                          const float (&acc)[NA], int warp,
                                          int g8, int tq) {
  const int ra = warp * 16 + g8, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    unsigned char* box = out + (j / 4) * kOutBox;
    const int chunk = 2 * (j % 4) + tq / 2, off = (tq & 1) * 8;
    *reinterpret_cast<float2*>(box + hopper::sw128_offset(ra, chunk) + off) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(box + hopper::sw128_offset(rb, chunk) + off) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// S for keys 64 kh .. 64 kh + 63 of the 64 rows from rows0: C's rows
// against B's, both K-major (SW128 boxes of 64 of the N columns)
__device__ __forceinline__ void scores(float (&sacc)[32],
                                       const unsigned char* cs,
                                       const unsigned char* bs, int rows0,
                                       int kh, int nb) {
  for (int kk = 0; kk < 4 * nb; ++kk) {
    const int c = kk / 4, w32 = (kk % 4) * 32;
    hopper::wgmma_ss_n64<0, 0>(
        sacc, hopper::desc_kmajor(cs + c * kBox + rows0 * 128 + w32),
        hopper::desc_kmajor(bs + c * kBox + kh * 8192 + w32), kk > 0);
  }
}

// w = S exp(cA_i - cA_k) dt_k for chunk c (a compile-time index, so that
// sacc stays in registers) of key half kh (S of the half's 64 keys in
// sacc), 0 above the diagonal: selected, never multiplied, as exp
// overflows there
__device__ __forceinline__ void w_terms(Chunk& f, const float (&sacc)[32],
                                        int kh, int c, const float* dts,
                                        const float* cA, float ca, float cb,
                                        int row_a, int row_b, int tq) {
#pragma unroll
  for (int ks = 0; ks < kNS; ++ks) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * (kNS * c + ks) + jj;     // columns 8 j .. of S
      const int k = 64 * kh + 8 * j + 2 * tq;
      const float2 dk = *reinterpret_cast<const float2*>(dts + k);
      const float2 ck = *reinterpret_cast<const float2*>(cA + k);
      const float e0 = (ca - ck.x) * kLog2e, e1 = (ca - ck.y) * kLog2e;
      const float e2 = (cb - ck.x) * kLog2e, e3 = (cb - ck.y) * kLog2e;
      const float wa0 =
          k <= row_a ? sacc[4 * j] * hopper::exp2_approx(e0) * dk.x : 0.f;
      const float wa1 =
          k < row_a ? sacc[4 * j + 1] * hopper::exp2_approx(e1) * dk.y : 0.f;
      const float wb0 =
          k <= row_b ? sacc[4 * j + 2] * hopper::exp2_approx(e2) * dk.x : 0.f;
      const float wb1 =
          k < row_b ? sacc[4 * j + 3] * hopper::exp2_approx(e3) * dk.y : 0.f;
      split_pair(f[ks], 2 * jj, wa0, wa1);       // a0 / a2: row a
      split_pair(f[ks], 2 * jj + 1, wb0, wb1);   // a1 / a3: row b
    }
  }
}

// xw = x exp(cA_last - cA_k) dt_k for the kNS 16-key steps from step0 and
// p rows p_a, p_b (x from its SW128 tile, the scale from dec), as the A
// operand p x k
__device__ __forceinline__ void xw_terms(Chunk& f, const unsigned char* x,
                                         const float* dec, int step0, int p_a,
                                         int p_b, int tq) {
  auto xv = [&](int k, int p) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
        x + hopper::sw128_offset(k, p >> 3) + (p & 7) * 2));
  };
#pragma unroll
  for (int ks = 0; ks < kNS; ++ks) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int k = 16 * (step0 + ks) + 8 * jj + 2 * tq;
      const float2 d = *reinterpret_cast<const float2*>(dec + k);
      split_pair(f[ks], 2 * jj, xv(k, p_a) * d.x, xv(k + 1, p_a) * d.y);
      split_pair(f[ks], 2 * jj + 1, xv(k, p_b) * d.x, xv(k + 1, p_b) * d.y);
    }
  }
}

// acc += A B over the chunk's 16-key steps from step0 below `steps`: three
// wgmma a step (the three terms), B (keys x 64 or 128 columns: x's tile for
// y, B_g for the states) MN-major; then waits for them
template <int NA>
__device__ __forceinline__ void products(float (&acc)[NA], Chunk& f,
                                         const unsigned char* b, int step0,
                                         int steps) {
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kNS; ++ks)
    if (step0 + ks < steps) {
      const uint64_t db =
          hopper::desc_mnmajor(b + (step0 + ks) * 2048, kBox);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if constexpr (NA == 64)
          hopper::wgmma_rs_n128<1>(acc, f[ks][t], db, 1);
        else
          hopper::wgmma_rs_n64<1>(acc, f[ks][t], db, 1);
      }
    }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  keep_regs(f);
  hopper::fence_regs(acc);
}

__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(kWThreads, 1)
ssd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_c,
                       const __grid_constant__ CUtensorMap map_y,
                       const __grid_constant__ CUtensorMap map_st,
                       const void* __restrict__ dt, const void* __restrict__ A,
                       int q, int H, int N, int dt_bf16, int a_bf16) {
  using namespace hopper;
  using L = WgmmaSmem;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bcbar, full[kWStages], empty[kWStages];
  // per head of the group, in float32, 0 past q (read as float2): dt_k,
  // the cumsum of dt A, and exp(cA_last - cA_k) dt_k
  __shared__ __align__(16) float dts[kWHeads][kWQ];
  __shared__ __align__(16) float cA[kWHeads][kWQ];
  __shared__ __align__(16) float dec[kWHeads][kWQ];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto xs = [&](int s) { return smem + L::kX + s * kBox; };

  const int nhg = (H + kWHeads - 1) / kWHeads;
  const int g = blockIdx.x / nhg, h0 = (blockIdx.x % nhg) * kWHeads;
  const int nh = min(kWHeads, H - h0);
  const int nb = (N + 63) / 64;        // 64-column boxes of B and C
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(&bcbar, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);        // lane 0 of every consumer warp
    }
    fence_barrier_init();
    // B, C and the first heads' x are on their way during the scans
    mbar_arrive_expect_tx(&bcbar, 2 * nb * kBox);
    for (int c = 0; c < nb; ++c) {
      tma_load_3d(smem + L::kC + c * kBox, &map_c, &bcbar, c * 64, 0, g);
      tma_load_3d(smem + L::kB + c * kBox, &map_b, &bcbar, c * 64, 0, g);
    }
    for (int it = 0; it < min(kWStages, nh); ++it) {
      mbar_arrive_expect_tx(&full[it], kBox);
      tma_load_4d(xs(it), &map_x, &full[it], 0, h0 + it, 0, g);
    }
  }
  // dt of the group's heads, then a warp a head: the cumsum of dt A (per-
  // lane runs, then a shuffle scan of the runs' totals) and the decay to
  // the chunk's end
  for (int idx = tid; idx < kWHeads * kWQ; idx += kWThreads) {
    const int hh = idx / kWQ, k = idx % kWQ;
    dts[hh][k] = (hh < nh && k < q)
        ? load_f32(dt, ((size_t)g * q + k) * H + h0 + hh, dt_bf16) : 0.f;
  }
  __syncthreads();
  if (tid / 32 < nh) {
    const int hh = tid / 32, lane = tid & 31;
    const float a = load_f32(A, h0 + hh, a_bf16);
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

  if (wg == 0) {                       // producer warpgroup
    if (tid == 0) {
      for (int it = kWStages; it < nh; ++it) {
        const int s = it % kWStages;
        mbar_wait(&empty[s], ((it / kWStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kBox);
        tma_load_4d(xs(s), &map_x, &full[s], 0, h0 + it, 0, g);
      }
    }
    return;
  }

  // consumers: warpgroups 1 and 2 y of query rows 0-63 and 64-127,
  // warpgroup 3 the states
  const int cw = wg - 1, ctid = tid & 127;
  const int lane = tid & 31, warp = ctid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int r8 = warp * 16 + g8;       // this thread's rows: r8, r8 + 8
  const int steps = (q + 15) / 16;     // 16-key steps
  const unsigned char* cs = smem + L::kC;
  const unsigned char* bs = smem + L::kB;
  mbar_wait(&bcbar, 0);

  if (cw < 2) {
    const int rows0 = cw * 64;
    const int row_a = rows0 + r8, row_b = row_a + 8;
    // the key steps at or below the rows' diagonal
    const int ks_y = (min(q, rows0 + 64) + 15) / 16;
    unsigned char* ystage = smem + L::kY + cw * 2 * kOutBox;
    for (int it = 0; it < nh; ++it) {
      const int s = it % kWStages;
      const unsigned char* x = xs(s);
      mbar_wait(&full[s], (it / kWStages) & 1);
      if (rows0 < q) {
        // y += w x a 64-key half at a time: S of the half (m64n64, C and
        // B K-major), w from it in registers, kNS key steps a chunk
        float yacc[32], sacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
        const float ca = cA[it][row_a], cb = cA[it][row_b];
        for (int kh = 0; 4 * kh < ks_y; ++kh) {
          wgmma_fence();
          scores(sacc, cs, bs, rows0, kh, nb);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sacc);
#pragma unroll
          for (int c = 0; c < 4 / kNS; ++c) {
            const int s0 = 4 * kh + kNS * c;
            if (s0 >= ks_y) break;
            Chunk f;
            w_terms(f, sacc, kh, c, dts[it], cA[it], ca, cb, row_a, row_b,
                    tq);
            products(yacc, f, x, s0, ks_y);
          }
        }
        if (lane == 0) mbar_arrive(&empty[s]);   // x of stage s is free
        // the last head's stores have read the staging; then out by TMA
        // (rows past q are not written)
        if (ctid == 0) bulk_wait_read<0>();
        named_barrier(1 + cw, 128);
        stage_out(ystage, yacc, warp, g8, tq);
        fence_proxy_async();
        named_barrier(1 + cw, 128);
        if (ctid == 0) {
          for (int b = 0; b < 2; ++b)
            tma_store_4d(&map_y, ystage + b * kOutBox, 32 * b, h0 + it,
                         rows0, g);
          bulk_commit();
        }
      } else if (lane == 0) {
        mbar_arrive(&empty[s]);
      }
    }
  } else {
    // st[p, :] = (x exp(cA_last - cA_k) dt_k)^T B: p rows r8, r8 + 8, all
    // 128 columns of B (past N: zeros, or not loaded, and not stored)
    unsigned char* ststage = smem + L::kSt;
    for (int it = 0; it < nh; ++it) {
      const int s = it % kWStages;
      const unsigned char* x = xs(s);
      mbar_wait(&full[s], (it / kWStages) & 1);
      float stacc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) stacc[i] = 0.f;
      for (int s0 = 0; s0 < steps; s0 += kNS) {
        Chunk f;
        xw_terms(f, x, dec[it], s0, r8, r8 + 8, tq);
        products(stacc, f, bs, s0, steps);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
      if (ctid == 0) bulk_wait_read<0>();
      named_barrier(3, 128);
      stage_out(ststage, stacc, warp, g8, tq);
      fence_proxy_async();
      named_barrier(3, 128);
      if (ctid == 0) {
        for (int b = 0; b < 4 && 32 * b < N; ++b)
          tma_store_4d(&map_st, ststage + b * kOutBox, 32 * b, 0, h0 + it,
                       g);
        bulk_commit();
      }
    }
  }
  if (ctid == 0) bulk_wait<0>();       // the stores have landed
}

// the tensor-core route: bf16 x, B and C with P = 64, N a multiple of 8 up
// to 128 and q up to 128, tensors on 16 bytes (TMA)
bool wgmma_fits(const void* x, const void* B, const void* C, int q, int P,
                int N, int xdt) {
  return xdt == kBF16 && P == 64 && N % 8 == 0 && N >= 8 && N <= 128 &&
         q >= 1 && q <= kWQ &&
         (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(C)) % 16 == 0;
}

int launch_wgmma(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, void* st, int G, int q, int H, int P,
                 int N, int dtdt, int adt, cudaStream_t stream) {
  CUtensorMap map_x, map_b, map_c, map_y, map_st;
  // x (G, q, H, P) and y: dims innermost first (P, H, q, G)
  const uint64_t x_dims[4] = {(uint64_t)P, (uint64_t)H, (uint64_t)q,
                              (uint64_t)G};
  const uint64_t x_strides[3] = {(uint64_t)P, (uint64_t)H * P,
                                 (uint64_t)q * H * P};
  const uint32_t x_box[4] = {64, 1, kWQ, 1};
  const uint32_t y_box[4] = {32, 1, 64, 1};
  // B, C (G, q, N): (N, q, G)
  const uint64_t bc_dims[3] = {(uint64_t)N, (uint64_t)q, (uint64_t)G};
  const uint64_t bc_strides[2] = {(uint64_t)N, (uint64_t)q * N};
  const uint32_t bc_box[3] = {64, kWQ, 1};
  // st (G, H, P, N): (N, P, H, G)
  const uint64_t st_dims[4] = {(uint64_t)N, (uint64_t)P, (uint64_t)H,
                               (uint64_t)G};
  const uint64_t st_strides[3] = {(uint64_t)N, (uint64_t)P * N,
                                  (uint64_t)H * P * N};
  const uint32_t st_box[4] = {32, 64, 1, 1};
  if (hopper::make_map_bf16(&map_x, x, 4, x_dims, x_strides, x_box) ||
      hopper::make_map_bf16(&map_b, B, 3, bc_dims, bc_strides, bc_box) ||
      hopper::make_map_bf16(&map_c, C, 3, bc_dims, bc_strides, bc_box) ||
      hopper::make_map_f32(&map_y, y, 4, x_dims, x_strides, y_box) ||
      hopper::make_map_f32(&map_st, st, 4, st_dims, st_strides, st_box))
    return hopper::kTensorMapError;
  const size_t smem = WgmmaSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (long long)G * ((H + kWHeads - 1) / kWHeads);
  if (blocks >= (1LL << 31)) return -1;
  ssd_chunk_wgmma_kernel<<<(unsigned)blocks, kWThreads, smem, stream>>>(
      map_x, map_b, map_c, map_y, map_st, dt, A, q, H, N, dtdt == kBF16,
      adt == kBF16);
  return static_cast<int>(cudaGetLastError());
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

// 1 where an input takes the tensor-core kernel, 0 where the FMA kernel
extern "C" int ssd_chunk_route(const void* x, const void* B, const void* C,
                               int q, int P, int N, int xdt) {
  return wgmma_fits(x, B, C, q, P, N, xdt) ? 1 : 0;
}

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
  if (wgmma_fits(x, B, C, q, P, N, xdt))
    return launch_wgmma(x, dt, A, B, C, y, st, G, q, H, P, N, dtdt, adt, s);
  if (xdt == kF32)
    return launch_dt<float>(dtdt, adt, x, dt, A, B, C, y, st, G, q, H, P, N,
                            s);
  return launch_dt<__nv_bfloat16>(dtdt, adt, x, dt, A, B, C, y, st, G, q, H,
                                  P, N, s);
}
