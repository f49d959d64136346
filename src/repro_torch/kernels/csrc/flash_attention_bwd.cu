// The backward of online-softmax attention for Hopper (sm_90a).
//
// The TPU kernel (repro/kernels/flash_attention.py::flash_attention) has no
// backward: the JAX package trains through its pure twin _chunked_attention
// and lets XLA differentiate it. The port's forward runs its own kernel
// (flash_attention.cu), so its gradient is a kernel too: this file, called
// by the autograd Function in kernels/flash_attention.py, which hands it
// the forward's output o and row log-sum-exp lse (B, H, S) float32.
//
// For one head, with P = exp(scale Q K^T - lse) (0 where masked):
//   Delta = rowsum(dO o O)            dV = P^T dO
//   dS = P o (dO V^T - Delta)         dK = scale dS^T Q,  dQ = scale dS K
// Three launches, deterministic, no atomics (each kernel's name starts with
// flash_attention_bwd_):
// 1. ..._delta_kernel: one warp a (b, h, s) row, Delta in float32 (for the
//    tensor-core route also lse log2 e, both over rows padded to whole
//    128-row tiles).
// 2. dK and dV: one block a (key tile, b, KV head). It loops over the query
//    heads of its GQA group and the query tiles that the causal mask lets
//    see one of its keys (bottom-right aligned: query i sees key
//    j <= i + Skv - S), recomputes P and dS for each (query tile x key
//    tile) and sums dK and dV in registers; the group's sum stays in the
//    block.
// 3. dQ: one block a (query tile, b, head), looping over the key tiles it
//    sees: dQ in registers.
// A row that sees no key has lse = -inf and P = 0, so no gradient. Sums in
// float32, one rounding to the input type at each store.
//
// What bounds it: operations. Five S x d products a visible (query, key)
// pair against the forward's two: 2 (3 d + 2 dv) FLOP, 343.6 GFLOP at
// (2, 4096, 16, 128) causal, 0.347 ms at the bf16 tensor cores' peak. The
// split into a dK/dV pass and a dQ pass computes Q K^T and dO V^T in both:
// 2 (4 d + 3 dv) FLOP a pair, 1.4 times the bound's count (0.49 ms).
//
// Design of the tensor-core route (bf16, d == dv a multiple of 8 in
// 64..128: the registry's heads and the training path; d = 80 runs D = 128
// over TMA's zero columns, as the forward): wgmma fed by TMA, the building
// blocks of the forward (hopper.cuh). flash_attention_bwd_dkdv_wgmma_kernel
// holds a 128-key tile of K and V in shared memory and takes a ring of
// (Q, dO, lse, Delta) 64-query tiles; each of its two consumer warpgroups
// owns 64 keys and computes S^T = K Q^T and dP^T = V dO^T, so that P^T and
// dS^T land in the accumulator layout that is the register A operand of
// dV += P^T dO and dK += dS^T Q (dO and Q read MN-major, the transpose
// bit, as V in the forward): no transpose through shared memory.
// flash_attention_bwd_dq_wgmma_kernel holds a 128-row Q and dO tile and
// takes a ring of 64-key K and V tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
// P^T and dS are rounded to bf16 for their products (the forward rounds p
// the same way); P, dS, the sums and lse stay float32. Both kernels run
// three warpgroups, the producer at setmaxnreg 24, the consumers at 240.
// What holds the dK/dV kernel back at d = 128 is registers: a consumer
// holds dK and dV (2 x 64 a thread) beside S^T and dP^T (2 x 32) and the
// P and dS operands (2 x 16). ptxas reports 168 registers for the launch;
// after setmaxnreg the consumers' code uses more, but it still spills 300
// bytes and serializes the wgmma (ptxas C7512, printed in chip_smoke.py's
// phase 1). The kernel takes 0.91 of the 1.34 ms, dQ 0.39 with three
// quarters of its work (PERF.md §6 row 4). Variants tried and not kept,
// none faster: one producer warp instead of a warpgroup (288 threads),
// other setmaxnreg splits, and S^T and dP^T over 32-query halves.
// Time at (2, 4096, 16, 128) bf16 causal on an H100 80GB HBM3 at 700 W:
// 1.34 ms against SDPA's backward 0.91.
//
// The float32 FMA kernels (flash_attention_bwd_dkdv_kernel and
// flash_attention_bwd_dq_kernel) take float32 inputs and every shape the
// tensor-core route does not (MLA's d = 192 with dv = 128 among them): 4 x 4
// register micro-tiles on the CUDA cores, tiles transposed in shared
// memory, Q K^T and dO V^T recomputed in both passes, P not rounded.
// flash_attention_bwd_route says which route an input takes.
//
// Layouts: q, dq (B, S, H, d); k, dk (B, Skv, KVH, d); v, dv (B, Skv, KVH,
// dv); o, do (B, S, H, dv); lse (B, H, S). The wrapper's scratch `delta`
// holds 2 B H roundup(S, 128) floats: Delta (B, H, S) for the FMA route;
// Delta and lse log2 e, each (B, H, roundup(S, 128)), for the tensor-core
// route. FMA head dims up to 256: DM = 32, 64 or 128 take 64-row query
// tiles, DM = 256 32-row ones (shared memory: 163 KB and 213 KB a block).
//
// C interface (bound with ctypes): flash_attention_bwd_route returns 1 for
// the tensor-core route, else 0; flash_attention_bwd_launch returns
// cudaGetLastError() after the last launch (or the first error of a launch
// or of setting a dynamic shared-memory size), 0 on success, -1 for a
// dtype, head dim or grid this file does not take, or -2
// (hopper::kTensorMapError) when a tensor map is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;
constexpr int kTX = 16;                // threads across a tile's columns
constexpr int kBK = 64;                // keys a tile
constexpr int kKP = kBK + 1;           // row length of key-major tiles

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

// Delta = rowsum(dO o O) of each (b, h, s) row, one warp a row, written at
// (b H + h) Sp + s for s < Sp: rows past S get Delta = 0. Given lse2 (the
// tensor-core route), also lse2 = lse log2 e there, +inf for a row that sees
// no key (lse = -inf) and for the rows past S, so that exp2(s' - lse2) is 0
// on them with no test.
template <typename T>
__global__ void flash_attention_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ lse2, long long rows, int S, int Sp, int H, int dv) {
  using E = Elem<T>;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / Sp;
  const int s = (int)(row % Sp);
  float acc = 0.f;
  if (s < S) {
    const int b = (int)(bh / H), h = (int)(bh % H);
    const size_t at = (((size_t)b * S + s) * H + h) * dv;
    for (int c = lane; c < dv; c += 32)
      acc = fmaf(E::load(o[at + c]), E::load(dout[at + c]), acc);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    delta[row] = acc;
    if (lse2 != nullptr) {
      const float l = s < S ? lse[bh * S + s] : -INFINITY;
      lse2[row] = l == -INFINITY ? INFINITY : l * 1.4426950408889634f;
    }
  }
}

// Shared memory of both passes, in floats: Q and dO of a query tile and K
// and V of a key tile, each transposed ([DM][rows + 1]: feature-major, so
// a thread's micro-tile reads broadcast along one axis and run along the
// other); P and dS of the (query x key) tile; lse and Delta of the rows.
template <int DM, int BQ>
struct Tiles {
  static constexpr int kQP = BQ + 1;
  static constexpr size_t kFloats =
      2 * DM * kQP + 2 * DM * kKP + 2 * BQ * kKP + 2 * BQ;
  float *qT, *doT, *kT, *vT, *ps, *dss, *lse_s, *dl_s;
  __device__ explicit Tiles(float* smem) {
    qT = smem;
    doT = qT + DM * kQP;
    kT = doT + DM * kQP;
    vT = kT + DM * kKP;
    ps = vT + DM * kKP;
    dss = ps + BQ * kKP;
    lse_s = dss + BQ * kKP;
    dl_s = lse_s + BQ;
  }
};

// Q and dO rows q0.. of head h (zeros past S and past d / dv), with their
// lse (-inf past S: no gradient) and Delta.
template <typename T, int DM, int BQ>
__device__ void load_query_tile(const Tiles<DM, BQ>& t, const T* q,
                                const T* dout, const float* lse,
                                const float* delta, int b, int h, int q0,
                                int S, int H, int d, int dv) {
  using E = Elem<T>;
  constexpr int QP = BQ + 1;
  for (int idx = threadIdx.x; idx < BQ * DM; idx += kThreads) {
    const int r = idx / DM, c = idx % DM;
    const int qr = q0 + r;
    const size_t row = ((size_t)b * S + qr) * H + h;
    const bool in = qr < S;
    t.qT[c * QP + r] = (in && c < d) ? E::load(q[row * d + c]) : 0.f;
    t.doT[c * QP + r] = (in && c < dv) ? E::load(dout[row * dv + c]) : 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int qr = q0 + r;
    const size_t at = ((size_t)b * H + h) * S + qr;
    t.lse_s[r] = qr < S ? lse[at] : -INFINITY;
    t.dl_s[r] = qr < S ? delta[at] : 0.f;
  }
}

// K and V rows k0.. of KV head hk (zeros past Skv and past d / dv).
template <typename T, int DM, int BQ>
__device__ void load_key_tile(const Tiles<DM, BQ>& t, const T* k, const T* v,
                              int b, int hk, int k0, int Skv, int KVH, int d,
                              int dv) {
  using E = Elem<T>;
  for (int idx = threadIdx.x; idx < kBK * DM; idx += kThreads) {
    const int r = idx / DM, c = idx % DM;
    const int kr = k0 + r;
    const size_t row = ((size_t)b * Skv + kr) * KVH + hk;
    const bool in = kr < Skv;
    t.kT[c * kKP + r] = (in && c < d) ? E::load(k[row * d + c]) : 0.f;
    t.vT[c * kKP + r] = (in && c < dv) ? E::load(v[row * dv + c]) : 0.f;
  }
}

// P and dS of the loaded (query tile x key tile) into shared memory. Thread
// (tx, ty) computes rows ty + 16 i, keys tx + 16 j of S = Q K^T and
// dP = dO V^T.
template <int DM, int BQ>
__device__ void p_and_ds(const Tiles<DM, BQ>& t, int q0, int k0, int S,
                         int Skv, int d, int dv, float scale, int causal) {
  constexpr int QP = BQ + 1, RI = BQ / kTX;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  float sc[RI][4], dp[RI][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float a[RI], bk[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = t.qT[c * QP + ty + kTX * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bk[j] = t.kT[c * kKP + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
  }
#pragma unroll 4
  for (int c = 0; c < dv; ++c) {
    float a[RI], bv[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = t.doT[c * QP + ty + kTX * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = t.vT[c * kKP + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], bv[j], dp[i][j]);
  }
  const int off = Skv - S;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + kTX * i, qr = q0 + r;
    const float L = t.lse_s[r], dl = t.dl_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = tx + kTX * j, kr = k0 + cc;
      const bool seen = qr < S && kr < Skv && (!causal || kr <= qr + off) &&
                        L != -INFINITY;
      const float p = seen ? expf(fmaf(sc[i][j], scale, -L)) : 0.f;
      t.ps[r * kKP + cc] = p;
      t.dss[r * kKP + cc] = p * (dp[i][j] - dl);
    }
  }
}

template <typename T, int DM, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dvo,
    int S, int Skv, int H, int KVH, int d, int dv, float scale, int causal) {
  using E = Elem<T>;
  extern __shared__ float smem[];
  const Tiles<DM, BQ> t(smem);
  constexpr int QP = BQ + 1, KJ = DM / kTX;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / KVH, hk = blockIdx.y % KVH;
  const int rep = H / KVH;
  // the first query that sees key k0: i + Skv - S >= k0
  const int qfirst = causal ? max(0, k0 - (Skv - S)) : 0;

  load_key_tile<T, DM, BQ>(t, k, v, b, hk, k0, Skv, KVH, d, dv);
  float acc_k[4][KJ], acc_v[4][KJ];    // keys ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    for (int q0 = qfirst / BQ * BQ; q0 < S; q0 += BQ) {
      __syncthreads();                 // the last tile's readers are done
      load_query_tile<T, DM, BQ>(t, q, dout, lse, delta, b, h, q0, S, H, d,
                                 dv);
      __syncthreads();
      p_and_ds<DM, BQ>(t, q0, k0, S, Skv, d, dv, scale, causal);
      __syncthreads();
      const int qn = min(BQ, S - q0);
      for (int r = 0; r < qn; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = t.ps[r * kKP + ty + kTX * i];
          ds[i] = t.dss[r * kKP + ty + kTX * i];
        }
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int c = tx + kTX * j;
          const float dov = t.doT[c * QP + r], qv = t.qT[c * QP + r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] = fmaf(p[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + kTX * i;
    if (kr >= Skv) continue;
    const size_t row = ((size_t)b * Skv + kr) * KVH + hk;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = tx + kTX * j;
      if (c < d) dk[row * d + c] = E::store(acc_k[i][j] * scale);
      if (c < dv) dvo[row * dv + c] = E::store(acc_v[i][j]);
    }
  }
}

template <typename T, int DM, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int Skv, int H,
    int KVH, int d, int dv, float scale, int causal) {
  using E = Elem<T>;
  extern __shared__ float smem[];
  const Tiles<DM, BQ> t(smem);
  constexpr int RI = BQ / kTX, KJ = DM / kTX;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / KVH);
  const int qlast = min(q0 + BQ, S) - 1;
  const int kend = causal ? min(Skv, qlast + (Skv - S) + 1) : Skv;

  load_query_tile<T, DM, BQ>(t, q, dout, lse, delta, b, h, q0, S, H, d, dv);
  float acc[RI][KJ];                   // rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                   // the last tile's readers are done
    load_key_tile<T, DM, BQ>(t, k, v, b, hk, k0, Skv, KVH, d, dv);
    __syncthreads();
    p_and_ds<DM, BQ>(t, q0, k0, S, Skv, d, dv, scale, causal);
    __syncthreads();
    const int kn = min(kBK, kend - k0);  // keys past kend have dS = 0
    for (int kk = 0; kk < kn; ++kk) {
      float ds[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = t.dss[(ty + kTX * i) * kKP + kk];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float kv = t.kT[(tx + kTX * j) * kKP + kk];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qr = q0 + ty + kTX * i;
    if (qr >= S) continue;
    T* row = dq + (((size_t)b * S + qr) * H + h) * d;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = tx + kTX * j;
      if (c < d) row[c] = E::store(acc[i][j] * scale);
    }
  }
}

template <typename T, int DM, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int B, int S, int Skv, int H, int KVH, int d, int dvd, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = Tiles<DM, BQ>::kFloats * sizeof(float);
  auto kkv = flash_attention_bwd_dkdv_kernel<T, DM, BQ>;
  auto kq = flash_attention_bwd_dq_kernel<T, DM, BQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  if (Skv > 0) {
    kkv<<<dim3((Skv + kBK - 1) / kBK, B * KVH), kThreads, smem, stream>>>(
        qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        S, Skv, H, KVH, d, dvd, scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kq<<<dim3((S + BQ - 1) / BQ, B * H), kThreads, smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), S, Skv, H, KVH, d,
      dvd, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on the tensor cores: wgmma fed by TMA -----------------------------
//
// Both kernels: a block of three warpgroups, warpgroup 0 the producer (one
// thread keeps TMA loads in flight; setmaxnreg 24), warpgroups 1 and 2 the
// consumers (240 registers), each owning 64 rows of the block's tile.
// Operands sit in shared memory as SW128 boxes of 64 rows x 64 columns
// (8 KB); a 128-row tile is two such boxes a column chunk, one after the
// other, which is the layout of one 128-row box. The maps carry the real d:
// columns past it load as zeros and are not stored. Thread (w, g, q) of a
// consumer holds accumulator rows 16 w + g and 16 w + g + 8 (hopper.cuh).
// P and dS, rounded to bf16 from their float32 accumulators, are the
// register A operand of the next product, as P is in the forward.

constexpr uint32_t kHalf = 64 * 128;   // an SW128 box: 64 rows x 64 bf16
constexpr int kMaxStages = 4;
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
constexpr int kKT = 128;               // keys a dK/dV block (2 x 64)
constexpr int kQT = 64;                // queries a dK/dV step
constexpr int kQR = 128;               // query rows a dQ block (2 x 64)
constexpr int kKS = 64;                // keys a dQ step

template <int D>
struct DkdvSmem {
  static constexpr uint32_t kKV = (D / 64) * 2 * kHalf;  // K or V, 128 keys
  static constexpr uint32_t kQ = (D / 64) * kHalf;       // Q or dO, 64 rows
  // a stage: Q, dO, then lse2 and Delta of its 64 rows (256 bytes each,
  // padded to keep the next stage's boxes on 1024 bytes)
  static constexpr uint32_t kStage = 2 * kQ + 1024;
  static constexpr int kFit =
      (int)((kSmemLimit - 2048 - 2 * kKV) / kStage);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes = 2 * kKV + kStages * kStage + 1024;
};

template <int D>
struct DqSmem {
  static constexpr uint32_t kQ = (D / 64) * 2 * kHalf;   // Q or dO, 128 rows
  static constexpr uint32_t kKV = (D / 64) * kHalf;      // K or V, 64 keys
  static constexpr int kFit = (int)((kSmemLimit - 2048 - 2 * kQ) / (2 * kKV));
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes = 2 * kQ + kStages * 2 * kKV + 1024;
};

// m64 x D += (64 x 16, registers) x (16 x D, MN-major in shared memory)
template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float (&acc)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (D == 128)
    hopper::wgmma_rs_n128<1>(acc, a, db, 1);
  else
    hopper::wgmma_rs_n64<1>(acc, a, db, 1);
}

// this warpgroup's accumulator rows (64 x D, times `mul`), rounded to bf16,
// into its 64 rows of a tile whose column chunks lie `chunk` bytes apart
template <int D>
__device__ __forceinline__ void acc_to_smem(unsigned char* rows,
                                            uint32_t chunk,
                                            const float (&acc)[D / 2],
                                            float mul, int warp, int g,
                                            int tq) {
  const int ra = warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* box = rows + (j / 8) * chunk;
    *reinterpret_cast<__nv_bfloat162*>(box + hopper::sw128_offset(ra, j % 8) +
                                       tq * 4) =
        __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(box + hopper::sw128_offset(rb, j % 8) +
                                       tq * 4) =
        __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// One block a (128-key tile, b, KV head): K and V of the tile loaded once,
// then a ring of (Q, dO, lse2, Delta) for every head of the GQA group and
// every 64-query tile that sees one of the tile's keys (bottom-right
// causal). A consumer computes, for its 64 keys and each query tile, the
// transposed products so that P and dS come out as the A operand:
//   S^T = K Q^T, dP^T = V dO^T (both K-major), P^T = exp2(S^T scale log2 e
//   - lse2), dS^T = P^T o (dP^T - Delta); dV += P^T dO, dK += dS^T Q (dO
//   and Q MN-major: the transpose bit).
// dK (times scale) and dV go out once, through the block's own K and V rows.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_attention_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_lse2,
    const __grid_constant__ CUtensorMap map_delta,
    const __grid_constant__ CUtensorMap map_dk,
    const __grid_constant__ CUtensorMap map_dv, int S, int Skv, int H,
    int KVH, float scale, float scale_log2, int causal) {
  using namespace hopper;
  using L = DkdvSmem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kvbar, full[kMaxStages], empty[kMaxStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::kKV;
  auto qs = [&](int s) { return smem + 2 * L::kKV + s * L::kStage; };
  auto dos = [&](int s) { return qs(s) + L::kQ; };
  auto stat = [&](int s) {
    return reinterpret_cast<float*>(qs(s) + 2 * L::kQ);
  };

  const int wg = threadIdx.x / 128;
  const int b = blockIdx.x / KVH, hk = blockIdx.x % KVH;
  const int k0 = blockIdx.y * kKT;     // the lowest keys (most queries) first
  const int rep = H / KVH;
  const int off = Skv - S;             // query i sees keys j <= i + off
  const int qfirst = causal ? max(0, k0 - off) : 0;   // first query of k0
  const int qt0 = qfirst / kQT;
  const int nqt = qfirst < S ? (S + kQT - 1) / kQT - qt0 : 0;
  const int nit = rep * nqt;

  if (threadIdx.x == 0) {
    mbar_init(&kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);         // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&kvbar, 2 * L::kKV);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t at = c * 2 * kHalf + half * kHalf;
          tma_load_4d(ks + at, &map_k, &kvbar, c * 64, hk, k0 + half * 64,
                      b);
          tma_load_4d(vs + at, &map_v, &kvbar, c * 64, hk, k0 + half * 64,
                      b);
        }
      for (int it = 0; it < nit; ++it) {
        const int s = it % kStages;
        const int h = hk * rep + it / nqt;
        const int q0 = (qt0 + it % nqt) * kQT;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kQ + 2 * kQT * 4);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(qs(s) + c * kHalf, &map_q, &full[s], c * 64, h, q0, b);
          tma_load_4d(dos(s) + c * kHalf, &map_do, &full[s], c * 64, h, q0,
                      b);
        }
        tma_load_2d(stat(s), &map_lse2, &full[s], q0, b * H + h);
        tma_load_2d(stat(s) + kQT, &map_delta, &full[s], q0, b * H + h);
      }
    }
  } else {                             // consumer warpgroups
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int kc0 = k0 + cw * 64;      // this warpgroup's first key
    const int key_a = kc0 + warp * 16 + g, key_b = key_a + 8;
    unsigned char* kw = ks + cw * kHalf;   // its K rows (and V rows in vs)
    unsigned char* vw = vs + cw * kHalf;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(&kvbar, 0);

    for (int it = 0; it < nit; ++it) {
      const int s = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int q0 = (qt0 + it % nqt) * kQT;
      mbar_wait(&full[s], par);
      // the tile's last row sees none of this warpgroup's keys: nothing
      if (causal && q0 + kQT - 1 + off < kc0) {
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      float st[32], dpt[32];           // S^T and dP^T: 64 keys x 64 queries
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(st, desc_kmajor(kw + c * 2 * kHalf + w),
                           desc_kmajor(qs(s) + c * kHalf + w), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dpt, desc_kmajor(vw + c * 2 * kHalf + w),
                           desc_kmajor(dos(s) + c * kHalf + w), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const float* lse2 = stat(s);
      const float* dl = stat(s) + kQT;
      const bool mask = causal && kc0 + 63 > q0 + off;
      uint32_t pf[4][4], df[4][4];     // A registers, 16 queries each
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * tq;   // query q0 + col and q0 + col + 1
        const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
        const float2 dd = *reinterpret_cast<const float2*>(dl + col);
        float p0 = exp2_approx(fmaf(st[4 * j], scale_log2, -l.x));
        float p1 = exp2_approx(fmaf(st[4 * j + 1], scale_log2, -l.y));
        float p2 = exp2_approx(fmaf(st[4 * j + 2], scale_log2, -l.x));
        float p3 = exp2_approx(fmaf(st[4 * j + 3], scale_log2, -l.y));
        if (mask) {                    // key j is hidden from query i when
          const int lim = q0 + col + off;   // j > i + off
          if (key_a > lim) p0 = 0.f;
          if (key_a > lim + 1) p1 = 0.f;
          if (key_b > lim) p2 = 0.f;
          if (key_b > lim + 1) p3 = 0.f;
        }
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);       // key row g
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);   // key row g + 8
        df[j >> 1][(j & 1) * 2] =
            pack_bf16(p0 * (dpt[4 * j] - dd.x), p1 * (dpt[4 * j + 1] - dd.y));
        df[j >> 1][(j & 1) * 2 + 1] = pack_bf16(
            p2 * (dpt[4 * j + 2] - dd.x), p3 * (dpt[4 * j + 3] - dd.y));
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk)
        wgmma_rs_nd<D>(dv, pf[kk], desc_mnmajor(dos(s) + kk * 2048, kHalf));
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk)
        wgmma_rs_nd<D>(dk, df[kk], desc_mnmajor(qs(s) + kk * 2048, kHalf));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(&empty[s]);   // stage s is free
    }

    // dK and dV into this warpgroup's own K and V rows (only its own
    // products read them), then TMA-stored (keys past Skv are not written)
    acc_to_smem<D>(kw, 2 * kHalf, dk, scale, warp, g, tq);
    acc_to_smem<D>(vw, 2 * kHalf, dv, 1.f, warp, g, tq);
    fence_proxy_async();
    named_barrier(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_store_4d(&map_dk, kw + c * 2 * kHalf, c * 64, hk, kc0, b);
        tma_store_4d(&map_dv, vw + c * 2 * kHalf, c * 64, hk, kc0, b);
      }
      bulk_commit();
      bulk_wait_read<0>();             // the block's shared memory outlives it
    }
  }
}

// One block a (128-row query tile, b, h): Q and dO loaded once, then a ring
// of 64-key K and V tiles up to the last key the tile sees. A consumer
// computes, for its 64 rows: S = Q K^T, dP = dO V^T (both K-major),
// P = exp2(S scale log2 e - lse2), dS = P o (dP - Delta), dQ += dS K (K
// MN-major); dQ times scale goes out once, through its own Q rows.
template <int D>
__global__ void __launch_bounds__(384, 1)
flash_attention_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_dq,
    const float* __restrict__ lse2, const float* __restrict__ delta, int S,
    int Skv, int H, int KVH, int Sp, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qbar, full[kMaxStages], empty[kMaxStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* dos = smem + L::kQ;
  auto ks = [&](int s) { return smem + 2 * L::kQ + s * 2 * L::kKV; };
  auto vs = [&](int s) { return ks(s) + L::kKV; };

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQR;   // heaviest first
  const int off = Skv - S;
  const int qlast = min(q0 + kQR, S) - 1;
  const int kend = causal ? min(Skv, qlast + off + 1) : Skv;
  const int ntile = kend > 0 ? (kend + kKS - 1) / kKS : 0;

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // producer warpgroup
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&qbar, 2 * L::kQ);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t at = c * 2 * kHalf + half * kHalf;
          tma_load_4d(qs + at, &map_q, &qbar, c * 64, h, q0 + half * 64, b);
          tma_load_4d(dos + at, &map_do, &qbar, c * 64, h, q0 + half * 64,
                      b);
        }
      for (int it = 0; it < ntile; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(ks(s) + c * kHalf, &map_k, &full[s], c * 64, hk,
                      it * kKS, b);
          tma_load_4d(vs(s) + c * kHalf, &map_v, &full[s], c * 64, hk,
                      it * kKS, b);
        }
      }
    }
  } else {                             // consumer warpgroups
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int rows0 = q0 + cw * 64;
    const int row_a = rows0 + warp * 16 + g, row_b = row_a + 8;
    unsigned char* qw = qs + cw * kHalf;   // its Q rows (and dO rows)
    unsigned char* dw = dos + cw * kHalf;
    // rows past S read the padding: lse2 = +inf (P = 0), Delta = 0
    const size_t at = (size_t)bh * Sp;
    const float l_a = lse2[at + row_a], l_b = lse2[at + row_b];
    const float dl_a = delta[at + row_a], dl_b = delta[at + row_b];
    const int lim_a = causal ? min(Skv - 1, row_a + off) : Skv - 1;
    const int lim_b = causal ? min(Skv - 1, row_b + off) : Skv - 1;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(&qbar, 0);

    for (int it = 0; it < ntile; ++it) {
      const int s = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int k0 = it * kKS;
      mbar_wait(&full[s], par);
      // every key of the tile hidden from this warpgroup's rows: nothing
      if (causal && k0 > rows0 + 63 + off) {
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      float sa[32], dp[32];            // S and dP: 64 rows x 64 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(sa, desc_kmajor(qw + c * 2 * kHalf + w),
                           desc_kmajor(ks(s) + c * kHalf + w), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, w = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dp, desc_kmajor(dw + c * 2 * kHalf + w),
                           desc_kmajor(vs(s) + c * kHalf + w), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dp);

      // keys past Skv and, on a tile across the diagonal, hidden keys get
      // P = 0 (past Skv, K's zero rows would give exp2(-lse2), not 0)
      const bool mask = k0 + kKS > Skv || (causal && k0 + kKS - 1 > rows0 + off);
      uint32_t df[4][4];               // A registers of dS, 16 keys each
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = k0 + 8 * j + 2 * tq;
        float p0 = exp2_approx(fmaf(sa[4 * j], scale_log2, -l_a));
        float p1 = exp2_approx(fmaf(sa[4 * j + 1], scale_log2, -l_a));
        float p2 = exp2_approx(fmaf(sa[4 * j + 2], scale_log2, -l_b));
        float p3 = exp2_approx(fmaf(sa[4 * j + 3], scale_log2, -l_b));
        if (mask) {
          if (kc > lim_a) p0 = 0.f;
          if (kc + 1 > lim_a) p1 = 0.f;
          if (kc > lim_b) p2 = 0.f;
          if (kc + 1 > lim_b) p3 = 0.f;
        }
        df[j >> 1][(j & 1) * 2] =
            pack_bf16(p0 * (dp[4 * j] - dl_a), p1 * (dp[4 * j + 1] - dl_a));
        df[j >> 1][(j & 1) * 2 + 1] = pack_bf16(
            p2 * (dp[4 * j + 2] - dl_b), p3 * (dp[4 * j + 3] - dl_b));
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKS / 16; ++kk)
        wgmma_rs_nd<D>(dq, df[kk], desc_mnmajor(ks(s) + kk * 2048, kHalf));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[s]);   // stage s is free
    }

    // dQ into this warpgroup's own Q rows (its last S has completed), then
    // TMA-stored (rows past S are not written)
    acc_to_smem<D>(qw, 2 * kHalf, dq, scale, warp, g, tq);
    fence_proxy_async();
    named_barrier(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_4d(&map_dq, qw + c * 2 * kHalf, c * 64, h, rows0, b);
      bulk_commit();
      bulk_wait_read<0>();
    }
  }
}

// the tensor-core route: bf16, d == dv a multiple of 8 in 64..128 (d = 80
// runs D = 128 over zero columns), q, k and v on 16 bytes, at least one key.
// The other operands are the wrapper's (o, dq, dk, dv fresh; dO copied onto
// 16 bytes when it is not): a map refused on them fails the launch.
bool wgmma_fits(const void* q, const void* k, const void* v, int d, int dv,
                int Skv, int dtype) {
  return dtype == kBF16 && d == dv && d % 8 == 0 && d >= 64 && d <= 128 &&
         Skv > 0 &&
         (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v)) %
                 16 == 0;
}

// rows of the padded (B, H, Sp) float32 buffers: whole 128-row tiles
inline int padded_rows(int S) { return (S + kQR - 1) / kQR * kQR; }

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, float* scratch, void* dq,
                 void* dk, void* dv, int B, int S, int Skv, int H, int KVH,
                 int d, float scale, int causal, cudaStream_t stream) {
  const int Sp = padded_rows(S);
  const int nkt = (Skv + kKT - 1) / kKT, nqt = (S + kQR - 1) / kQR;
  if (nkt > 65535 || nqt > 65535) return -1;
  const long long rows = (long long)B * H * Sp;
  if ((rows + 7) / 8 > 2147483647LL) return -1;
  float* delta = scratch;
  float* lse2 = scratch + rows;
  flash_attention_bwd_delta_kernel<__nv_bfloat16>
      <<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, lse2, rows, S, Sp,
      H, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap map_q, map_k, map_v, map_do, map_dq, map_dk, map_dv, map_lse2,
      map_delta;
  const uint32_t box[4] = {64, 1, 64, 1};
  const uint64_t q_dims[4] = {(uint64_t)d, (uint64_t)H, (uint64_t)S,
                              (uint64_t)B};
  const uint64_t q_strides[3] = {(uint64_t)d, (uint64_t)H * d,
                                 (uint64_t)S * H * d};
  const uint64_t k_dims[4] = {(uint64_t)d, (uint64_t)KVH, (uint64_t)Skv,
                              (uint64_t)B};
  const uint64_t k_strides[3] = {(uint64_t)d, (uint64_t)KVH * d,
                                 (uint64_t)Skv * KVH * d};
  const uint64_t stat_dims[2] = {(uint64_t)Sp, (uint64_t)B * H};
  const uint64_t stat_strides[1] = {(uint64_t)Sp};
  const uint32_t stat_box[2] = {kQT, 1};
  using hopper::make_map_bf16;
  if (make_map_bf16(&map_q, q, 4, q_dims, q_strides, box) ||
      make_map_bf16(&map_do, dout, 4, q_dims, q_strides, box) ||
      make_map_bf16(&map_dq, dq, 4, q_dims, q_strides, box) ||
      make_map_bf16(&map_k, k, 4, k_dims, k_strides, box) ||
      make_map_bf16(&map_v, v, 4, k_dims, k_strides, box) ||
      make_map_bf16(&map_dk, dk, 4, k_dims, k_strides, box) ||
      make_map_bf16(&map_dv, dv, 4, k_dims, k_strides, box) ||
      hopper::make_map_f32_rows(&map_lse2, lse2, 2, stat_dims, stat_strides,
                                stat_box) ||
      hopper::make_map_f32_rows(&map_delta, delta, 2, stat_dims,
                                stat_strides, stat_box))
    return hopper::kTensorMapError;

  auto kkv = flash_attention_bwd_dkdv_wgmma_kernel<D>;
  auto kq = flash_attention_bwd_dq_wgmma_kernel<D>;
  const size_t smem_kv = DkdvSmem<D>::kBytes, smem_q = DqSmem<D>::kBytes;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * 1.4426950408889634f;
  kkv<<<dim3(B * KVH, nkt), 384, smem_kv, stream>>>(
      map_q, map_k, map_v, map_do, map_lse2, map_delta, map_dk, map_dv, S,
      Skv, H, KVH, scale, scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kq<<<dim3(B * H, nqt), 384, smem_q, stream>>>(
      map_q, map_k, map_v, map_do, map_dq, lse2, delta, S, Skv, H, KVH, Sp,
      scale, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, float* delta, void* dq,
               void* dk, void* dv, int B, int S, int Skv, int H, int KVH,
               int d, int dvd, float scale, int causal, cudaStream_t s) {
  const long long rows = (long long)B * S * H;
  if (rows == 0) return 0;
  if ((rows + 7) / 8 > 2147483647LL) return -1;
  flash_attention_bwd_delta_kernel<T>
      <<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      nullptr, rows, S, S, H, dvd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int dm = d > dvd ? d : dvd;
  if (dm <= 32)
    return launch<T, 32, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Skv,
                             H, KVH, d, dvd, scale, causal, s);
  if (dm <= 64)
    return launch<T, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Skv,
                             H, KVH, d, dvd, scale, causal, s);
  if (dm <= 128)
    return launch<T, 128, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S,
                              Skv, H, KVH, d, dvd, scale, causal, s);
  if (dm <= 256)
    return launch<T, 256, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, S,
                              Skv, H, KVH, d, dvd, scale, causal, s);
  return -1;
}

}  // namespace

// 1 when flash_attention_bwd_launch takes the tensor-core route for these
// inputs, else 0 (the float32 FMA kernels)
extern "C" int flash_attention_bwd_route(const void* q, const void* k,
                                         const void* v, int d, int dv,
                                         int Skv, int dtype) {
  return wgmma_fits(q, k, v, d, dv, Skv, dtype) ? 1 : 0;
}

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int Skv, int H, int KVH, int d, int dvd,
    float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H > 65535 || KVH <= 0 || H % KVH) return -1;
  if (wgmma_fits(q, k, v, d, dvd, Skv, dtype)) {
    if (B * S == 0) return 0;
    return d > 64 ? launch_wgmma<128>(q, k, v, o, lse, dout, delta, dq, dk,
                                      dv, B, S, Skv, H, KVH, d, scale, causal,
                                      s)
                  : launch_wgmma<64>(q, k, v, o, lse, dout, delta, dq, dk, dv,
                                     B, S, Skv, H, KVH, d, scale, causal, s);
  }
  switch (dtype) {
    case kF32:
      return launch_all<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, S,
                               Skv, H, KVH, d, dvd, scale, causal, s);
    case kBF16:
      return launch_all<__nv_bfloat16>(q, k, v, o, lse, dout, delta, dq, dk,
                                       dv, B, S, Skv, H, KVH, d, dvd, scale,
                                       causal, s);
  }
  return -1;
}
