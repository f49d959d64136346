// Online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the TPU kernel
// of the models' attention (repro/models/layers.py runs its pure-JAX twin
// _chunked_attention; the port's layers.attention calls this kernel). The TPU
// kernel walks a (B*H, S/bq, S/bkv) grid with the KV axis innermost and
// sequential, carrying the running max, denominator and accumulator in VMEM
// scratch from one grid step to the next, and masks the KV tiles above the
// diagonal instead of skipping them (a TPU grid cannot be triangular). Blocks
// on Hopper run in no order and share nothing, so here:
//
//   * one thread block owns one (batch, head, 64-row query tile) and walks
//     the KV tiles itself in a loop; the running max m, denominator l and the
//     output accumulator live in shared memory and registers for the whole
//     walk, and the output is written once;
//   * under the causal mask the loop stops at the tile that holds the tile's
//     last visible key: the tiles above the diagonal are never loaded, which
//     halves the work at S = Skv;
//   * GQA without a repeat: query head h reads KV head h / (H / KVH);
//   * any S, Skv and head dims up to 256: rows and keys past the edge load as
//     zeros, are masked and never stored; the head dim is padded to the
//     template's DM (32, 64, 128 or 256) with zeros, which add nothing.
//
// Two kernels share that walk. bf16 with d == dv in {64, 128} (the models'
// heads) runs on the tensor cores: mma.sync m16n8k16 into float32, K/V tiles
// copied by cp.async, p repacked from the score accumulators into the A
// fragments of P V (see flash_attention_mma_kernel). Everything else (f32,
// other head dims, unaligned rows) runs a float32 FMA kernel: per KV tile,
// S = Q K^T * scale as a 4x4 register micro-tile per thread (Q and K
// transposed in shared memory), then four threads per row take the row's max
// and sum with warp shuffles. Both rescale by corr = exp(m_old - m_new),
// round p = exp(s - m_new) to v's type before P V (as the Pallas kernel casts
// p before its PV dot) but sum the unrounded p into l, keep scores, max, sum
// and accumulator in float32, and write acc / max(l, 1e-30), rounded once.
//
// Cost on the card: at the main path's (B, S, H, d) = (4, 2048, 16, 128),
// bf16, causal, the work is 4*B*H*d*S(S+1)/2 = 68.75 GFLOP against 134 MB of
// q, k, v and o, so the bound is the tensor cores' 989 TFLOP/s (0.0695 ms).
// The mma.sync kernel is a first tensor-core design: one K/V stage (blocks on
// the same SM overlap each other's loads), a 64-row query tile per block, no
// warp specialisation. wgmma with TMA and a larger query tile are the next
// steps (PERF.md). The FMA kernel cannot come
// within 7 % of that bound (67 TFLOP/s of float32 FMA at most).
//
// C interface (bound with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch (or the error of setting the dynamic
// shared-memory size), 0 on success, or -1 for a dtype or head dim this file
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Skv, int H, int KVH, int d, int dv, float scale,
                       int causal) {
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

// ---- bf16 on the tensor cores ---------------------------------------------
//
// The same walk for bf16 with d == dv in {64, 128}: a block of 4 warps owns
// 64 query rows, 16 per warp. Q's fragments stay in registers; each 64-key
// tile of K and V comes into shared memory by cp.async (zero past Skv). A
// second K/V buffer measured slower: its 87 KB of shared memory leaves room
// for fewer blocks per SM, which overlapped each other's loads (PERF.md).
// S = Q K^T is mma.sync m16n8k16 into float32 (K read with ldmatrix as the
// col-major B operand), the row max and sum are reduced across the 4 lanes
// that share a row, p is rounded to bf16 and repacked from the S
// accumulators straight into the A fragments of P V (V read with
// ldmatrix.trans). l keeps per-lane partial sums of the unrounded p, summed
// across the row's lanes at the end.

constexpr int kWQ = 16;                // query rows per warp
constexpr int kMThreads = 128;

template <int D>
constexpr size_t mma_smem_bytes() {
  return 3 * kBQ * (D + 8) * sizeof(__nv_bfloat16);   // Q, K, V tiles
}

// three blocks an SM: registers capped at 168 a thread (174 uncapped left
// room for two, 20 % slower at the main shape, PERF.md)
template <int D>
__global__ void __launch_bounds__(kMThreads, 3)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int S, int Skv,
                           int H, int KVH, float scale, int causal) {
  using namespace mma_bf16;
  constexpr int kLd = D + 8;           // padded row: conflict-free ldmatrix
  constexpr int kChunks = D / 8;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * kLd;
  __nv_bfloat16* vs = ks + kBK * kLd;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / KVH);
  const int off = Skv - S;

  for (int ch = tid; ch < kBQ * kChunks; ch += kMThreads) {
    const int rr = ch / kChunks, cc = (ch % kChunks) * 8;
    const int qr = q0 + rr;
    const bool ok = qr < S;
    cp_async16(qs + rr * kLd + cc,
               ok ? q + (((size_t)b * S + qr) * H + h) * D + cc : q, ok);
  }
  cp_async_commit();

  const int qlast = min(q0 + kBQ, S) - 1;
  const int kend = causal ? min(Skv, qlast + off + 1) : Skv;
  const int ntile = kend > 0 ? (kend + kBK - 1) / kBK : 0;
  auto load_kv = [&](int k0) {
    for (int ch = tid; ch < kBK * kChunks; ch += kMThreads) {
      const int rr = ch / kChunks, cc = (ch % kChunks) * 8;
      const int kr = k0 + rr;
      const bool ok = kr < Skv;
      const size_t row = ((size_t)b * Skv + kr) * KVH + hk;
      cp_async16(ks + rr * kLd + cc, ok ? k + row * D + cc : k, ok);
      cp_async16(vs + rr * kLd + cc, ok ? v + row * D + cc : v, ok);
    }
  };
  cp_async_wait<0>();                  // Q has landed
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * kWQ + (lane & 15)) * kLd + kk * 16 +
                            (lane >> 4) * 8);

  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int qrow0 = q0 + warp * kWQ + g, qrow1 = qrow0 + 8;

  for (int it = 0; it < ntile; ++it) {
    const int k0 = it * kBK;
    load_kv(k0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kBK / 8][4];               // this warp's 16 x 64 scores
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = k0 + j * 8 + tq * 2 + e;
        const bool in = kc < Skv;
        s[j][e] = (in && (!causal || kc <= qrow0 + off))
            ? s[j][e] * scale : -INFINITY;
        s[j][2 + e] = (in && (!causal || kc <= qrow1 + off))
            ? s[j][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = (m0 == -INFINITY) ? 0.f : expf(m0 - mn0);
    const float c1 = (m1 == -INFINITY) ? 0.f : expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[kBK / 16][4];          // A fragments of P, 16 keys each
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = (mn0 == -INFINITY) ? 0.f : expf(s[j][0] - mn0);
      const float p1 = (mn0 == -INFINITY) ? 0.f : expf(s[j][1] - mn0);
      const float p2 = (mn1 == -INFINITY) ? 0.f : expf(s[j][2] - mn1);
      const float p3 = (mn1 == -INFINITY) ? 0.f : expf(s[j][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);       // row g
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);   // row g + 8
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[j][0] *= c0;
      oacc[j][1] *= c0;
      oacc[j][2] *= c1;
      oacc[j][3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 15)) * kLd + dp * 16 +
                                  (lane >> 4) * 8);
        mma(oacc[2 * dp], pf[kk], vf[0], vf[1]);
        mma(oacc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    __syncthreads();                   // the tile is free for the next copy
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + tq * 2;
    if (qrow0 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (((size_t)b * S + qrow0) * H + h) * D + c) =
          __floats2bfloat162_rn(oacc[j][0] / d0, oacc[j][1] / d0);
    if (qrow1 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (((size_t)b * S + qrow1) * H + h) * D + c) =
          __floats2bfloat162_rn(oacc[j][2] / d1, oacc[j][3] / d1);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Skv, int H, int KVH, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kern = flash_attention_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kMThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Skv, H, KVH, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core path: bf16, d == dv in {64, 128}, rows on 16 bytes
bool mma_fits(const void* q, const void* k, const void* v, const void* o,
              int d, int dv) {
  return d == dv && (d == 64 || d == 128) &&
         (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
                 16 == 0;
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Skv, int H, int KVH, int d, int dv, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_floats<DM>() * sizeof(float);
  auto kern = flash_attention_kernel<T, DM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, KVH, d, dv,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dm(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Skv, int H, int KVH, int d, int dv, float scale,
              int causal, cudaStream_t s) {
  const int dm = d > dv ? d : dv;
  if (dm <= 32)
    return launch<T, 32>(q, k, v, o, B, S, Skv, H, KVH, d, dv, scale, causal, s);
  if (dm <= 64)
    return launch<T, 64>(q, k, v, o, B, S, Skv, H, KVH, d, dv, scale, causal, s);
  if (dm <= 128)
    return launch<T, 128>(q, k, v, o, B, S, Skv, H, KVH, d, dv, scale, causal,
                          s);
  if (dm <= 256)
    return launch<T, 256>(q, k, v, o, B, S, Skv, H, KVH, d, dv, scale, causal,
                          s);
  return -1;
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Skv, int H, int KVH, int d, int dv,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H > 65535 || KVH <= 0 || H % KVH) return -1;
  switch (dtype) {
    case kF32:
      return launch_dm<float>(q, k, v, o, B, S, Skv, H, KVH, d, dv, scale,
                              causal, s);
    case kBF16:
      if (mma_fits(q, k, v, o, d, dv))
        return d == 64
            ? launch_mma<64>(q, k, v, o, B, S, Skv, H, KVH, scale, causal, s)
            : launch_mma<128>(q, k, v, o, B, S, Skv, H, KVH, scale, causal, s);
      return launch_dm<__nv_bfloat16>(q, k, v, o, B, S, Skv, H, KVH, d, dv,
                                      scale, causal, s);
  }
  return -1;
}
