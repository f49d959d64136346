// Online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the TPU kernel
// of the models' attention (repro/models/layers.py runs its pure-JAX twin
// _chunked_attention; the port's layers.attention calls this kernel). The TPU
// kernel walks a (B*H, S/bq, S/bkv) grid with the KV axis innermost and
// sequential, carrying the running max, denominator and accumulator in VMEM
// scratch from one grid step to the next, and masks the KV tiles above the
// diagonal instead of skipping them (a TPU grid cannot be triangular). Blocks
// on Hopper run in no order and share nothing, so here one thread block owns
// one (batch, head, query tile) and walks the KV tiles itself, the running
// max m, denominator l and output accumulator staying on chip for the whole
// walk, and writes the output once; under the causal mask the walk stops at
// the tile that holds the last visible key, so the tiles above the diagonal
// are never loaded (half the work at S = Skv); GQA reads KV head
// h / (H / KVH) in place; any S and Skv: rows and keys past the edge are
// zeros, masked and never stored.
//
// Numerics, those of the Pallas kernel in both kernels below: scores, max,
// sum and accumulator in float32; O rescaled by exp(m_old - m_new); p rounded
// to v's type before P V (the Pallas kernel casts p before its PV dot) but
// summed into l unrounded; a row that sees no key gives 0; the output is
// acc / max(l, 1e-30), rounded once; query i sees keys j <= i + Skv - S.
//
// What bounds it on this card: at the main path's (B, S, H, d) =
// (4, 2048, 16, 128), bf16, causal, the work is 4 B H d S(S+1)/2 = 68.75
// GFLOP against 134 MB of q, k, v and o: the tensor cores' 989 TFLOP/s
// (0.0695 ms). What the kernel does not hide is the softmax between the
// products: one instruction less per exponential bought 7 % (PERF.md).
//
// Design (bf16; d and dv multiples of 8 with 64 <= d <= 192 and 64 <= dv
// <= 128; q, k, v on 16 bytes: what TMA and the models' heads take, MLA's
// d = 192 / dv = 128 and hubert's d = 80 included): an FA3-shaped forward
// (flash_attention_wgmma_kernel<D, DV>, D and DV the head dims rounded up
// to 64-column boxes). A block of three warpgroups owns a 128-row query
// tile: warpgroup 0 is the producer, one thread of which TMA-loads the Q
// tile once and each 128-key tile of K and V into a ring gated by mbarriers
// (three stages; two at D = 192, whose three would need 289 KB of shared
// memory); warpgroups 1 and 2 (setmaxnreg: 240 registers, the producer 24)
// each own 64 rows. Per key tile a consumer runs S = Q K^T as wgmma
// m64n128k16 (Q and K K-major in shared memory, SW128 boxes of 64 columns),
// masks S only on a tile that crosses the diagonal or the end of Skv, takes
// the online softmax in registers with exp2 (scale * log2 e folded in;
// ex2.approx, one instruction), and feeds p, rounded to bf16, straight from
// the score accumulators as the register A operand of O += P V (wgmma
// m64n{DV}k16, V MN-major: the transpose bit). A head dim between the
// boxes (d = 80) needs no layout of its own: the tensor maps carry the real
// d and dv, so TMA fills the columns past them with zeros, as it fills the
// rows past S of a ragged tile; the products run over the whole boxes and
// the store drops the columns past dv. The output goes through the
// warpgroup's own (spent) Q rows, max(D, DV) columns wide, to a TMA store.
// The grid runs the heaviest query tiles first (blockIdx.y reversed, heads
// fastest), so the causal grid has no long tail. Issuing S of the next
// tile before this tile's softmax, and taking turns between the two
// consumers (FA3's overlaps), measured no faster here (PERF.md).
//
// Times on an H100 80GB HBM3 at 700 W (PERF.md §6 row 4): (4, 2048, 16,
// 128) causal 0.17 ms (SDPA 0.14); MLA's (4, 2048, 16, d 192, dv 128)
// causal 0.21 ms (SDPA 0.18-0.26); hubert's (8, 1500, 16, 80) 0.36 ms
// (SDPA 0.27), where the zero columns are 60 % more work than d = 80
// needs.
//
// Everything else (float32, head dims outside those ranges, unaligned rows)
// runs a float32 FMA kernel (flash_attention_kernel): 64-row query tiles,
// per KV tile S = Q K^T * scale as a 4x4 register micro-tile per thread (Q
// and K transposed in shared memory), then four threads per row take the
// row's max and sum with warp shuffles; it cannot come within 7 % of the
// bound (67 TFLOP/s of float32 FMA at most). flash_attention_route says
// which kernel an input takes.
//
// The row log-sum-exp: given a buffer lse (B, H, S) float32 (the autograd
// Function passes one for the backward in flash_attention_bwd.cu; serving
// passes none), each kernel also writes lse = m + log l of every real row
// in natural units, -inf for a row that sees no key.
//
// C interface (bound with ctypes): flash_attention_route returns 1 when the
// launch takes the tensor-core kernel, else 0; flash_attention_launch returns
// cudaGetLastError() after the launch (or the error of setting the dynamic
// shared-memory size), 0 on success, -1 for a dtype, head dim or grid this
// file does not take, or -2 (hopper::kTensorMapError) when a tensor map is
// refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kBQ = 64, kBK = 64;      // query rows, keys per tile
constexpr int kThreads = 256;
constexpr int kTX = 16;                // threads across a tile's columns
constexpr int kPad = kBQ + 1;          // row length of the transposed tiles

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <int DM>
constexpr size_t smem_floats() {
  // Q^T, K^T [DM][kPad]; V [kBK][DM]; scores/p [kBQ][kPad]; m, l, corr
  return 2 * DM * kPad + kBK * DM + kBQ * kPad + 3 * kBQ;
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int S, int Skv, int H,
                       int KVH, int d, int dv, float scale, int causal) {
  using E = Elem<T>;
  extern __shared__ float smem[];
  float* qs = smem;                    // Q tile, transposed: [DM][kPad]
  float* ks = qs + DM * kPad;          // K tile, transposed: [DM][kPad]
  float* vs = ks + DM * kPad;          // V tile: [kBK][DM]
  float* ps = vs + kBK * DM;           // scores, then p: [kBQ][kPad]
  float* m_s = ps + kBQ * kPad;        // running max per row
  float* l_s = m_s + kBQ;              // running denominator per row
  float* c_s = l_s + kBQ;              // this tile's correction per row

  constexpr int kJ = DM / kTX;         // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / KVH);
  const int off = Skv - S;             // query i sees keys j <= i + off

  for (int idx = tid; idx < kBQ * DM; idx += kThreads) {
    const int r = idx / DM, c = idx % DM;
    const int qr = q0 + r;
    qs[c * kPad + r] = (qr < S && c < d)
        ? E::load(q[(((size_t)b * S + qr) * H + h) * d + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;

  const int qlast = min(q0 + kBQ, S) - 1;              // last real row
  const int kend = causal ? min(Skv, qlast + off + 1) : Skv;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                   // the last tile's readers are done
    for (int idx = tid; idx < kBK * DM; idx += kThreads) {
      const int r = idx / DM, c = idx % DM;
      const int kr = k0 + r;
      const size_t row = ((size_t)b * Skv + kr) * KVH + hk;
      const bool in = kr < Skv;
      ks[c * kPad + r] = (in && c < d) ? E::load(k[row * d + c]) : 0.f;
      vs[r * DM + c] = (in && c < dv) ? E::load(v[row * dv + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c * kPad + ty + kTX * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[c * kPad + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + kTX * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + kTX * j;
        const int kr = k0 + cc;
        const bool seen = kr < Skv && (!causal || kr <= q0 + r + off);
        ps[r * kPad + cc] = seen ? sc[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    {                                  // online softmax, 4 threads a row
      const int r = tid >> 2, part = tid & 3;
      float* prow = ps + r * kPad;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj)
        mx = fmaxf(mx, prow[part + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) {
        const float p = (m_new == -INFINITY)
            ? 0.f : expf(prow[part + 4 * jj] - m_new);
        sum += p;
        prow[part + 4 * jj] = E::round(p);   // p in v's type for P V
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + kTX * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= corr;
    }
    const int kn = min(kBK, kend - k0);  // keys past kend have p = 0
    for (int kk = 0; kk < kn; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + kTX * i) * kPad + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float vv = vs[kk * DM + tx + kTX * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();                     // l_s is final (also with no tile)
  if (lse != nullptr && tid < kBQ && q0 + tid < S)   // natural log
    lse[((size_t)b * H + h) * S + q0 + tid] =
        m_s[tid] == -INFINITY ? -INFINITY : m_s[tid] + logf(l_s[tid]);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + kTX * i;
    const int qr = q0 + r;
    if (qr >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = o + (((size_t)b * S + qr) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = tx + kTX * j;
      if (c < dv) orow[c] = E::store(acc[i][j] / l);
    }
  }
}

// ---- bf16 on the tensor cores: wgmma fed by TMA (FA3-shaped) ---------------
//
// Stage s of the ring holds K and V of one key tile, each with its own
// "full" mbarrier (S = Q K^T starts before V has landed) and one "empty"
// mbarrier that counts the consumer warps done with both. Thread (w, g, q)
// of a consumer warpgroup holds rows 16 w + g and 16 w + g + 8 of its 64
// (hopper.cuh's accumulator layout).
//
// D and DV are the head dims d and dv rounded up to whole 64-column boxes
// (64, 128, 192 and 64, 128). The tensor maps carry the real d and dv, so
// the columns of a box past them load as zeros (the same zero fill that
// covers a ragged last row tile) and are never stored: d = 80 runs D = 128,
// its Q K^T summing zeros over the last 48 columns and its P V producing
// 48 zero columns the store drops.

constexpr int kFQ = 128, kFK = 128;    // query rows a block, keys a tile
constexpr int kFMaxStages = 3;         // K/V stages (fewer when they do not fit)
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

template <int D, int DV>
struct FlashSmem {
  static constexpr uint32_t kBox = 128 * 128;          // 128 rows x 64 bf16
  // the Q tile, and the O tile written through the same (spent) rows
  static constexpr uint32_t kQ = ((D > DV ? D : DV) / 64) * kBox;
  static constexpr uint32_t kK = (D / 64) * kBox;      // one K tile
  static constexpr uint32_t kV = (DV / 64) * kBox;     // one V tile
  // three stages where they fit (d = dv = 128: 225 KB); MLA's D = 192,
  // DV = 128 takes two (209 KB; three would need 289 KB)
  static constexpr int kStages =
      kQ + kFMaxStages * (kK + kV) + 1024 <= kSmemLimit - 1024 ? kFMaxStages
                                                               : 2;
  static constexpr size_t kBytes = kQ + kStages * (kK + kV) + 1024;  // + align
};

template <int D, int DV>
__global__ void __launch_bounds__(384, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_o,
                             float* __restrict__ lse, int S, int Skv, int H,
                             int KVH, float scale_log2, int causal) {
  using namespace hopper;
  using L = FlashSmem<D, DV>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qbar, kfull[kFMaxStages],
      vfull[kFMaxStages], empty[kFMaxStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  auto ks = [&](int s) { return smem + L::kQ + s * L::kK; };
  auto vs = [&](int s) {
    return smem + L::kQ + kStages * L::kK + s * L::kV;
  };

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFQ;   // heaviest first
  const int off = Skv - S;             // query i sees keys j <= i + off
  const int qlast = min(q0 + kFQ, S) - 1;
  const int kend = causal ? min(Skv, qlast + off + 1) : Skv;
  const int ntile = kend > 0 ? (kend + kFK - 1) / kFK : 0;

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);         // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&qbar, (D / 64) * L::kBox);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(qs + c * L::kBox, &map_q, &qbar, c * 64, h, q0, b);
      for (int it = 0; it < ntile; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&kfull[s], L::kK);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(ks(s) + c * L::kBox, &map_k, &kfull[s], c * 64, hk,
                      it * kFK, b);
        mbar_arrive_expect_tx(&vfull[s], L::kV);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load_4d(vs(s) + c * L::kBox, &map_v, &vfull[s], c * 64, hk,
                      it * kFK, b);
      }
    }
  } else {                             // consumer warpgroups
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int rows0 = q0 + cw * 64;    // this warpgroup's first row
    const int row_a = rows0 + warp * 16 + g, row_b = row_a + 8;

    float oacc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    mbar_wait(&qbar, 0);

    for (int it = 0; it < ntile; ++it) {
      const int s = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int k0 = it * kFK;
      float sacc[kFK / 2];
      mbar_wait(&kfull[s], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 32;
        wgmma_ss_n128<0, 0>(sacc,
                            desc_kmajor(qs + c * L::kBox + cw * 8192 + w),
                            desc_kmajor(ks(s) + c * L::kBox + w), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // the mask, only on a tile that crosses the diagonal or Skv
      if (k0 + kFK > Skv || (causal && k0 + kFK - 1 > rows0 + off)) {
        const int lim_a = causal ? min(Skv - 1, row_a + off) : Skv - 1;
        const int lim_b = causal ? min(Skv - 1, row_b + off) : Skv - 1;
#pragma unroll
        for (int j = 0; j < kFK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kc = k0 + j * 8 + tq * 2 + c;
            if (kc > lim_a) sacc[4 * j + c] = -INFINITY;
            if (kc > lim_b) sacc[4 * j + 2 + c] = -INFINITY;
          }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < kFK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a * scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * scale_log2);
      const float c_a = m_a == -INFINITY ? 0.f : exp2_approx(m_a - mn_a);
      const float c_b = m_b == -INFINITY ? 0.f : exp2_approx(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      // a row with no key seen so far keeps p = 0 (mn = -inf)
      const float sub_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float sub_b = mn_b == -INFINITY ? 0.f : mn_b;

      uint32_t pf[kFK / 16][4];        // A registers of P, 16 keys each
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int j = 0; j < kFK / 8; ++j) {
        const float p0 =
            exp2_approx(fmaf(sacc[4 * j], scale_log2, -sub_a));
        const float p1 =
            exp2_approx(fmaf(sacc[4 * j + 1], scale_log2, -sub_a));
        const float p2 =
            exp2_approx(fmaf(sacc[4 * j + 2], scale_log2, -sub_b));
        const float p3 =
            exp2_approx(fmaf(sacc[4 * j + 3], scale_log2, -sub_b));
        rs_a += p0 + p1;
        rs_b += p2 + p3;
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);       // row g
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);   // row g + 8
      }
      l_a = l_a * c_a + rs_a;
      l_b = l_b * c_b + rs_b;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        oacc[4 * j] *= c_a;
        oacc[4 * j + 1] *= c_a;
        oacc[4 * j + 2] *= c_b;
        oacc[4 * j + 3] *= c_b;
      }

      mbar_wait(&vfull[s], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFK / 16; ++kk) {
        const uint64_t dv = desc_mnmajor(vs(s) + kk * 2048, L::kBox);
        if constexpr (DV == 128)
          wgmma_rs_n128<1>(oacc, pf[kk], dv, 1);
        else
          wgmma_rs_n64<1>(oacc, pf[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      if (lane == 0) mbar_arrive(&empty[s]);   // K and V of stage s are free
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
    if (lse != nullptr && tq == 0) {   // m is in log2 units: back to ln
      float* row = lse + ((size_t)b * H + h) * S;
      if (row_a < S)
        row[row_a] = m_a == -INFINITY
            ? -INFINITY : (m_a + log2f(l_a)) * 0.6931471805599453f;
      if (row_b < S)
        row[row_b] = m_b == -INFINITY
            ? -INFINITY : (m_b + log2f(l_b)) * 0.6931471805599453f;
    }
    // the output, rounded once, into this warpgroup's own Q rows (no longer
    // read: its last Q K^T has completed; kQ holds max(D, DV) columns), then
    // TMA-stored (rows past S and columns past dv are not written)
    const int ra = warp * 16 + g, rb = ra + 8;
    unsigned char* out = qs + cw * 8192;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      unsigned char* box = out + (j / 8) * L::kBox;
      *reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(ra, j % 8) +
                                         tq * 4) =
          __floats2bfloat162_rn(oacc[4 * j] / d_a, oacc[4 * j + 1] / d_a);
      *reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(rb, j % 8) +
                                         tq * 4) =
          __floats2bfloat162_rn(oacc[4 * j + 2] / d_b, oacc[4 * j + 3] / d_b);
    }
    fence_proxy_async();
    named_barrier(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int c = 0; c < DV / 64; ++c)
        tma_store_4d(&map_o, out + c * L::kBox, c * 64, h, rows0, b);
      bulk_commit();
      bulk_wait_read<0>();             // the block's shared memory outlives it
    }
  }
}

// The maps carry the real d and dv: the columns of a box past them load as
// zeros and are not stored.
template <int D, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int Skv, int H, int KVH, int d,
                 int dv, float scale, int causal, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_o;
  const uint32_t box[4] = {64, 1, 128, 1};
  const uint64_t q_dims[4] = {(uint64_t)d, (uint64_t)H, (uint64_t)S,
                              (uint64_t)B};
  const uint64_t q_strides[3] = {(uint64_t)d, (uint64_t)H * d,
                                 (uint64_t)S * H * d};
  const uint64_t k_dims[4] = {(uint64_t)d, (uint64_t)KVH, (uint64_t)Skv,
                              (uint64_t)B};
  const uint64_t k_strides[3] = {(uint64_t)d, (uint64_t)KVH * d,
                                 (uint64_t)Skv * KVH * d};
  const uint64_t v_dims[4] = {(uint64_t)dv, (uint64_t)KVH, (uint64_t)Skv,
                              (uint64_t)B};
  const uint64_t v_strides[3] = {(uint64_t)dv, (uint64_t)KVH * dv,
                                 (uint64_t)Skv * KVH * dv};
  const uint64_t o_dims[4] = {(uint64_t)dv, (uint64_t)H, (uint64_t)S,
                              (uint64_t)B};
  const uint64_t o_strides[3] = {(uint64_t)dv, (uint64_t)H * dv,
                                 (uint64_t)S * H * dv};
  const uint32_t out_box[4] = {64, 1, 64, 1};
  if (hopper::make_map_bf16(&map_q, q, 4, q_dims, q_strides, box) ||
      hopper::make_map_bf16(&map_k, k, 4, k_dims, k_strides, box) ||
      hopper::make_map_bf16(&map_v, v, 4, v_dims, v_strides, box) ||
      hopper::make_map_bf16(&map_o, o, 4, o_dims, o_strides, out_box))
    return hopper::kTensorMapError;
  const size_t smem = FlashSmem<D, DV>::kBytes;
  auto kern = flash_attention_wgmma_kernel<D, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntq = (S + kFQ - 1) / kFQ;
  if (ntq > 65535) return -1;
  const dim3 grid(B * H, ntq);
  kern<<<grid, 384, smem, stream>>>(
      map_q, map_k, map_v, map_o, lse, S, Skv, H, KVH,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma_dv(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int S, int Skv, int H, int KVH, int d,
                    int dv, float scale, int causal, cudaStream_t s) {
  return dv > 64 ? launch_wgmma<D, 128>(q, k, v, o, lse, B, S, Skv, H, KVH, d,
                                        dv, scale, causal, s)
                 : launch_wgmma<D, 64>(q, k, v, o, lse, B, S, Skv, H, KVH, d,
                                       dv, scale, causal, s);
}

// the tensor-core route: bf16; d and dv multiples of 8 (rows on 16 bytes, as
// TMA's strides must be) with 64 <= d <= 192 and 64 <= dv <= 128 (a
// narrower head would fill most of its 64-column box with zeros; a wider d
// or dv does not fit shared memory or the registers); q, k and v on 16
// bytes; and at least one key (a tensor map has no empty dimension). The
// output is the wrapper's own fresh tensor: its map is refused, and the
// launch fails, were it not on 16 bytes.
bool wgmma_fits(const void* q, const void* k, const void* v, int d, int dv,
                int Skv, int dtype) {
  return dtype == kBF16 && d % 8 == 0 && dv % 8 == 0 && d >= 64 &&
         d <= 192 && dv >= 64 && dv <= 128 && Skv > 0 &&
         (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v)) %
                 16 == 0;
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Skv, int H, int KVH, int d, int dv, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<DM>() * sizeof(float);
  auto kern = flash_attention_kernel<T, DM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Skv, H, KVH, d,
      dv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dm(const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int S, int Skv, int H, int KVH, int d, int dv,
              float scale, int causal, cudaStream_t s) {
  const int dm = d > dv ? d : dv;
  if (dm <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv, scale,
                         causal, s);
  if (dm <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv, scale,
                         causal, s);
  if (dm <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv, scale,
                          causal, s);
  if (dm <= 256)
    return launch<T, 256>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv, scale,
                          causal, s);
  return -1;
}

}  // namespace

// 1 when flash_attention_launch takes the tensor-core route for these
// inputs, else 0 (the float32 FMA kernel)
extern "C" int flash_attention_route(const void* q, const void* k,
                                     const void* v, int d, int dv, int Skv,
                                     int dtype) {
  return wgmma_fits(q, k, v, d, dv, Skv, dtype) ? 1 : 0;
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int S, int Skv, int H, int KVH,
                                      int d, int dv, float scale, int causal,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H > 65535 || KVH <= 0 || H % KVH) return -1;
  if (wgmma_fits(q, k, v, d, dv, Skv, dtype)) {
    if (d > 128)
      return launch_wgmma_dv<192>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv,
                                  scale, causal, s);
    if (d > 64)
      return launch_wgmma_dv<128>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv,
                                  scale, causal, s);
    return launch_wgmma_dv<64>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv,
                               scale, causal, s);
  }
  switch (dtype) {
    case kF32:
      return launch_dm<float>(q, k, v, o, lse, B, S, Skv, H, KVH, d, dv,
                              scale, causal, s);
    case kBF16:
      return launch_dm<__nv_bfloat16>(q, k, v, o, lse, B, S, Skv, H, KVH, d,
                                      dv, scale, causal, s);
  }
  return -1;
}
