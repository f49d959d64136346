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
// Three launches, deterministic, no atomics:
// 1. ..._delta_kernel: one warp a (b, s, h) row, Delta in float32.
// 2. ..._dkdv_kernel: one block a (64-key tile, b, KV head). It loops over
//    the query heads of its GQA group and the query tiles that the causal
//    mask lets see one of its keys (bottom-right aligned: query i sees key
//    j <= i + Skv - S), recomputes P and dS for each (query tile x key
//    tile) and sums dK and dV in registers; the group's sum stays in the
//    block.
// 3. ..._dq_kernel: one block a (query tile, b, head), looping over the
//    key tiles it sees: dQ in registers.
// (Each kernel's name starts with flash_attention_bwd_.)
// A row that sees no key has lse = -inf and P = 0, so no gradient. Sums in
// float32, one rounding to the input type at each store; P is not rounded.
//
// What bounds it: operations. Five S x d products a visible (query, key)
// pair against the forward's two: 2 (3 d + 2 dv) FLOP, 343.6 GFLOP at
// (2, 4096, 16, 128) causal, 0.347 ms at the bf16 tensor cores' peak. This
// first design runs on the CUDA cores in float32 (the forward's FMA
// kernel's 4 x 4 register micro-tiles, tiles transposed in shared memory)
// and recomputes Q K^T and dO V^T in both passes: simple and right first,
// far from the bound (PERF.md).
//
// Layouts: q, dq (B, S, H, d); k, dk (B, Skv, KVH, d); v, dv (B, Skv, KVH,
// dv); o, do (B, S, H, dv); lse, delta (B, H, S). Head dims up to 256:
// DM = 32, 64 or 128 take 64-row query tiles, DM = 256 32-row ones (shared
// memory: 163 KB and 213 KB a block).
//
// C interface (bound with ctypes): flash_attention_bwd_launch returns
// cudaGetLastError() after the last launch (or the first error of a launch
// or of setting a dynamic shared-memory size), 0 on success, -1 for a
// dtype, head dim or grid this file does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
__global__ void flash_attention_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, int rows, int S, int H, int dv) {
  using E = Elem<T>;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * dv;
  const T* drow = dout + (size_t)row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32)
    acc = fmaf(E::load(orow[c]), E::load(drow[c]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {                     // row = (b * S + s) * H + h
    const int h = row % H, bs = row / H;
    delta[((size_t)(bs / S) * H + h) * S + bs % S] = acc;
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
      static_cast<const T*>(o), static_cast<const T*>(dout), delta,
      (int)rows, S, H, dvd);
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

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int Skv, int H, int KVH, int d, int dvd,
    float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H > 65535 || KVH <= 0 || H % KVH) return -1;
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
