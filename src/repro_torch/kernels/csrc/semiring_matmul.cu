// Dense-tile semiring matmul for Hopper (sm_90a): C = A (+).(x) B.
//
// Replaces repro/kernels/semiring_matmul.py::semiring_matmul, the TPU kernel
// behind the dense-accumulator local SpGEMM (spgemm_dense): the (i, j) slot of
// the output tile is the hash bucket of the paper's hash-table SpGEMM,
// collision-free by construction. The TPU kernel keeps one output tile in
// VMEM across a sequential K grid axis and asks M, N, K to divide its blocks.
// Blocks on Hopper run in no order and share nothing, so here:
//
//   * each thread block owns one 64x64 output tile; its 256 threads hold a
//     4x4 register micro-tile each (rows ty + 16 i, columns tx + 16 j, so
//     that the stores of a half-warp are contiguous);
//   * the block walks K in a loop of its own, staging a 64x16 slice of A
//     (transposed) and a 16x64 slice of B through shared memory;
//   * the accumulators start at the algebra's identity, and the inner loop
//     stops at K: padded k never enters a product, so no padding value can
//     beat a real one (a zero-padded k would give 0 + 0 = 0 under min_plus);
//   * any M, N and K are taken: rows and columns past the edge are loaded as
//     zeros and never stored.
//
// Algebras, by the kind code of the wrapper (kernels/semiring_matmul.py):
//   0 plus_times  acc += a * b          f32, f64, bf16 (f32 accumulator,
//                                       rounded once at the store), i32, i64
//                                       (two's complement wrap)
//   1 min_plus    acc = min(acc, a + b) f32, f64
//   2 max_min     acc = max(acc, min(a, b)) f32, f64
//   3 or_and      acc |= a & b          bool
// min and max propagate NaN as torch.minimum / torch.maximum do (and as
// jnp.minimum does): comparisons, never fminf/fmaxf, which drop NaN.
// Integer min_plus/max_min have no +-inf identity and are refused by the
// wrapper (the TPU kernel fills its int accumulator with inf cast to int).
//
// Cost on the card: bound by operations. At M = N = K = 2048 the operands are
// 3 x 16 MiB against 8.6e9 semiring steps: plus_times is one FMA a step
// (132 SMs x 128 FP32 lanes a clock), min_plus/max_min two non-fused
// operations a step at the same lanes, or_and one 32-bit logic op (LOP3,
// acc | a & b) per 32 steps on the integer lanes (64 a clock an SM) once K is
// bit-packed. This simple design leaves on the table: bit-packing for or_and
// (it spends one byte-wide logic op a step, 32 times the work the bound
// counts), tensor cores (plus_times in bf16/TF32 would go through wgmma, at
// the cost of exactness), cp.async/TMA pipelining of the K slices, and vector
// loads from shared memory (each step issues 8 scalar shared loads for 16
// combines, so the loop is bound by shared-memory issue before the FP32
// lanes).
//
// C interface (bound with ctypes): semiring_matmul_launch returns
// cudaGetLastError() after the launch, 0 on success, or -1 for a kind/dtype
// pair or grid this file does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Kind { kPlusTimes = 0, kMinPlus = 1, kMaxMin = 2, kOrAnd = 3 };
enum DType { kF32 = 0, kF64 = 1, kBF16 = 2, kI32 = 3, kI64 = 4, kBool = 5 };

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kTX = kBN / kTN;                        // 16 threads across

// ---- element types: what is loaded, what is accumulated, what is stored ----

template <typename T> struct Elem {                   // f32, f64, i32, i64
  using Acc = T;
  static __device__ __forceinline__ Acc load(T v) { return v; }
  static __device__ __forceinline__ T store(Acc v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Elem<uint8_t> {                    // torch.bool, 0 or 1
  using Acc = uint32_t;
  static __device__ __forceinline__ uint32_t load(uint8_t v) { return v; }
  static __device__ __forceinline__ uint8_t store(uint32_t v) {
    return v ? 1 : 0;
  }
};

// ---- algebras -------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T nan_min(T x, T y) {      // NaN wins, as torch
  return (x != x || x < y) ? x : y;
}
template <typename T>
__device__ __forceinline__ T nan_max(T x, T y) {
  return (x != x || x > y) ? x : y;
}

template <int KIND, typename A> struct Alg;

template <typename A> struct Alg<kPlusTimes, A> {
  static __device__ __forceinline__ A identity() { return A(0); }
  static __device__ __forceinline__ void step(A& acc, A a, A b) {
    acc += a * b;                                     // contracts to an FMA
  }
};
// integer sums wrap in two's complement (unsigned arithmetic: no UB)
template <> struct Alg<kPlusTimes, int32_t> {
  static __device__ __forceinline__ int32_t identity() { return 0; }
  static __device__ __forceinline__ void step(int32_t& acc, int32_t a,
                                              int32_t b) {
    acc = (int32_t)((uint32_t)acc + (uint32_t)a * (uint32_t)b);
  }
};
template <> struct Alg<kPlusTimes, int64_t> {
  static __device__ __forceinline__ int64_t identity() { return 0; }
  static __device__ __forceinline__ void step(int64_t& acc, int64_t a,
                                              int64_t b) {
    acc = (int64_t)((uint64_t)acc + (uint64_t)a * (uint64_t)b);
  }
};
template <typename A> struct Alg<kMinPlus, A> {
  static __device__ __forceinline__ A identity() { return A(INFINITY); }
  static __device__ __forceinline__ void step(A& acc, A a, A b) {
    acc = nan_min(a + b, acc);
  }
};
template <typename A> struct Alg<kMaxMin, A> {
  static __device__ __forceinline__ A identity() { return A(-INFINITY); }
  static __device__ __forceinline__ void step(A& acc, A a, A b) {
    acc = nan_max(nan_min(a, b), acc);
  }
};
template <typename A> struct Alg<kOrAnd, A> {
  static __device__ __forceinline__ A identity() { return A(0); }
  static __device__ __forceinline__ void step(A& acc, A a, A b) {
    acc |= a & b;
  }
};

// ---- the kernel -----------------------------------------------------------

template <int KIND, typename T>
__global__ void __launch_bounds__(kThreads)
semiring_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       T* __restrict__ c, int m, int n, int k) {
  using E = Elem<T>;
  using A = typename E::Acc;
  using G = Alg<KIND, A>;
  __shared__ A as[kBK][kBM + 1];                      // A slice, transposed
  __shared__ A bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  A acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = G::identity();

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kBM * kBK / kThreads; ++l) {
      const int idx = tid + l * kThreads;             // k fastest: coalesced
      const int r = idx / kBK, kk = idx % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? E::load(a[(size_t)gr * k + gk]) : A(0);
    }
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int idx = tid + l * kThreads;             // columns fastest
      const int kk = idx / kBN, cc = idx % kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? E::load(b[(size_t)gk * n + gc]) : A(0);
    }
    __syncthreads();
    const int kmax = min(kBK, k - k0);                // padded k never enters
    if (kmax == kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        A av[kTM], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + kTX * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + kTX * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) G::step(acc[i][j], av[i], bv[j]);
      }
    } else {
      for (int kk = 0; kk < kmax; ++kk) {
        A av[kTM], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + kTX * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + kTX * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) G::step(acc[i][j], av[i], bv[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + kTX * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int cc = col0 + tx + kTX * j;
      if (cc < n) c[(size_t)r * n + cc] = E::store(acc[i][j]);
    }
  }
}

template <int KIND, typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return -1;
  semiring_matmul_kernel<KIND, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int semiring_matmul_launch(const void* a, const void* b, void* c,
                                      int m, int n, int k, int kind,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPlusTimes:
      switch (dtype) {
        case kF32: return launch<kPlusTimes, float>(a, b, c, m, n, k, s);
        case kF64: return launch<kPlusTimes, double>(a, b, c, m, n, k, s);
        case kBF16:
          return launch<kPlusTimes, __nv_bfloat16>(a, b, c, m, n, k, s);
        case kI32: return launch<kPlusTimes, int32_t>(a, b, c, m, n, k, s);
        case kI64: return launch<kPlusTimes, int64_t>(a, b, c, m, n, k, s);
      }
      return -1;
    case kMinPlus:
      switch (dtype) {
        case kF32: return launch<kMinPlus, float>(a, b, c, m, n, k, s);
        case kF64: return launch<kMinPlus, double>(a, b, c, m, n, k, s);
      }
      return -1;
    case kMaxMin:
      switch (dtype) {
        case kF32: return launch<kMaxMin, float>(a, b, c, m, n, k, s);
        case kF64: return launch<kMaxMin, double>(a, b, c, m, n, k, s);
      }
      return -1;
    case kOrAnd:
      if (dtype == kBool)
        return launch<kOrAnd, uint8_t>(a, b, c, m, n, k, s);
      return -1;
  }
  return -1;
}
