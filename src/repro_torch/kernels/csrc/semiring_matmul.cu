// Dense-tile semiring matmul for Hopper (sm_90a): C = A (+).(x) B.
//
// Replaces src/repro/kernels/semiring_matmul.py:58 (semiring_matmul), the
// TPU kernel behind the dense-accumulator local SpGEMM (spgemm_dense): the
// (i, j) slot of the output tile is the hash bucket of the paper's hash-table
// SpGEMM, collision-free by construction. The TPU kernel keeps one output
// tile in VMEM across a sequential K grid axis and asks M, N, K to divide its
// blocks. Blocks on Hopper run in no order and share nothing, so each block
// here owns an output tile and walks K itself; any M, N and K are taken (rows
// and columns past the edge load as zeros and are never stored), and the
// accumulators start at the algebra's identity.
//
// What bounds it on this card: operations. At M = N = K = 2048 the operands
// are 48 MiB against 8.6e9 semiring steps: plus_times is one FMA a step
// (132 SMs x 128 FP32 lanes a clock), min_plus/max_min two non-fused
// operations a step on the same lanes, or_and one 32-bit logic op (LOP3,
// acc | a & b) per 32 steps on the integer lanes once K is bit-packed. The
// tensor cores are no way round it: plus_times is held to f32's summation-
// order bound (TF32 breaks it, 3xTF32 may), and min/max/or are not products.
// Three kernels, by input:
//
//   * f32 plus_times, min_plus, max_min (the dense SpGEMM's weighted path):
//     semiring_matmul_f32_kernel. A 128 x 128 output tile per block of 256
//     threads, each holding an 8 x 8 register micro-tile as 2 x 2 groups of
//     4 x 4 (rows ty*4 + i and 64 + ty*4 + i, columns likewise with tx), so
//     that each k step reads both operand fragments as four float4 loads
//     (LDS.128) from shared memory: a half-warp reads one A address
//     (broadcast) and 256 contiguous bytes of B, with no bank conflict. K is
//     walked in 16-deep slices through a two-stage cp.async ring (LDGSTS):
//     the copy of slice t + 1 is issued before slice t is computed, one
//     barrier a slice (on the card this beat 8-deep slices in three or four
//     stages). A lands transposed (k-major, rows padded to 132 floats, so
//     the 4-byte copies of a warp meet at most two to a bank); B lands as
//     it is, in 16-byte copies where N % 4 == 0 and the tensors sit on 16
//     bytes (4-byte copies otherwise). min and max are one instruction each,
//     min.NaN.f32 / max.NaN.f32: NaN propagates as in torch.minimum, and
//     -0 orders below +0, so a tie of the two zeros gives -0 under min and
//     +0 under max whatever the order of k (the plain version does the
//     same). The loop stops at K: a padded k never enters a min_plus or
//     max_min step (a zero-padded k would give 0 + 0 = 0);
//   * bool or_and: semiring_matmul_or_and_kernel. A 128 x 128 output tile
//     per block; K in slices of 256, packed into 32-bit words while staging:
//     a row of A is read 16 bytes a lane and packed with two multiplies, a
//     column of B by __ballot_sync over 32 lanes that each read 16 columns
//     of one row. The inner step is acc |= a_word & b_word over 8 x 8
//     words a thread (the words read as uint4), one LOP3 per 32 k. A K that
//     32 does not divide leaves zero bits, neutral under or/and. One launch,
//     no separate packing pass. torch.bool holds 0 or 1;
//   * everything else (f64 for the three arithmetic algebras, bf16 plus_times
//     with an f32 accumulator rounded once, i32/i64 plus_times wrapping in
//     two's complement): semiring_matmul_kernel, the first design: a 64 x 64
//     tile, a 4 x 4 micro-tile a thread, K in 16-deep slices through shared
//     memory with scalar loads. Its f64 min/max are compare-and-select, with
//     the same NaN and signed-zero rules.
//
// Integer min_plus/max_min have no +-inf identity and are refused by the
// wrapper (the TPU kernel fills its int accumulator with inf cast to int).
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async (LDGSTS): `bytes` (0 or the full size) are read from src, the
// rest of the 4 or 16 bytes at dst are zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// at most N groups of this thread's copies are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ==== f32 plus_times, min_plus, max_min: 128 x 128 tiles, cp.async ring ====

constexpr int kFM = 128, kFN = 128, kFK = 16;  // output tile, K slice
constexpr int kFStages = 2;
constexpr int kFThreads = 256;                 // 16 x 16, 8 x 8 outputs each
constexpr int kFLd = kFM + 4;                  // A slice row (transposed)
static_assert(kFK * kFN % (4 * kFThreads) == 0 && kFM * kFK % kFThreads == 0,
              "every thread copies the same number of elements");

// min.NaN / max.NaN (sm_80+): NaN if either input is NaN; -0 < +0
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int KIND> struct F32Alg;
template <> struct F32Alg<kPlusTimes> {
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc = fmaf(a, b, acc);
  }
};
template <> struct F32Alg<kMinPlus> {
  static __device__ __forceinline__ float identity() { return INFINITY; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc = min_nan(acc, a + b);
  }
};
template <> struct F32Alg<kMaxMin> {
  static __device__ __forceinline__ float identity() { return -INFINITY; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc = max_nan(acc, min_nan(a, b));
  }
};

// one k step of the 8 x 8 micro-tile: four float4 loads, 64 combines
template <typename G>
__device__ __forceinline__ void step8x8(float (&acc)[8][8],
                                        const float* __restrict__ ak,
                                        const float* __restrict__ bk, int ty,
                                        int tx) {
  const float4 a0 = *reinterpret_cast<const float4*>(ak + ty * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(bk + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + tx * 4);
  const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) G::step(acc[i][j], ar[i], br[j]);
}

// kVec: N % 4 == 0 and b, c on 16 bytes (16-byte copies of B, float4
// stores of C)
template <int KIND, bool kVec>
__global__ void __launch_bounds__(kFThreads)
semiring_matmul_f32_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, float* __restrict__ c,
                           int m, int n, int k) {
  using G = F32Alg<KIND>;
  __shared__ __align__(16) float as[kFStages][kFK][kFLd];   // A, k-major
  __shared__ __align__(16) float bs[kFStages][kFK][kFN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kFM, col0 = blockIdx.x * kFN;

  // the copies of the K slice at k0 into stage s
  auto load = [&](int s, int k0) {
#pragma unroll
    for (int l = 0; l < kFM * kFK / kFThreads; ++l) {
      const int idx = tid + l * kFThreads;          // k fastest: a row's
      const int r = idx / kFK, kk = idx % kFK;      // 64 bytes together
      const int gr = row0 + r, gk = k0 + kk;
      const bool in = gr < m && gk < k;
      cp_async4(&as[s][kk][r], in ? a + (size_t)gr * k + gk : a, in ? 4 : 0);
    }
    if (kVec) {
#pragma unroll
      for (int l = 0; l < kFK * kFN / 4 / kFThreads; ++l) {
        const int idx = tid + l * kFThreads;
        const int kk = idx / (kFN / 4), cc = (idx % (kFN / 4)) * 4;
        const int gk = k0 + kk, gc = col0 + cc;
        const bool in = gk < k && gc < n;           // all four or none
        cp_async16(&bs[s][kk][cc], in ? b + (size_t)gk * n + gc : b,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int l = 0; l < kFK * kFN / kFThreads; ++l) {
        const int idx = tid + l * kFThreads;
        const int kk = idx / kFN, cc = idx % kFN;
        const int gk = k0 + kk, gc = col0 + cc;
        const bool in = gk < k && gc < n;
        cp_async4(&bs[s][kk][cc], in ? b + (size_t)gk * n + gc : b,
                  in ? 4 : 0);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = G::identity();

  const int nk = (k + kFK - 1) / kFK;
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) load(s, s * kFK);
    cp_async_commit();                 // a group a slice, empty or not
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kFStages - 2>();     // slice t has landed (this thread's
    __syncthreads();                   // copies; the barrier: everyone's),
    const int tn = t + kFStages - 1;   // and slice t - 1 is computed, so its
    if (tn < nk) load(tn % kFStages, tn * kFK);   // stage takes the next
    cp_async_commit();
    const int s = t % kFStages;
    const int kmax = min(kFK, k - t * kFK);       // padded k never enters
    if (kmax == kFK) {
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk)
        step8x8<G>(acc, as[s][kk], bs[s][kk], ty, tx);
    } else {
      for (int kk = 0; kk < kmax; ++kk)
        step8x8<G>(acc, as[s][kk], bs[s][kk], ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= m) continue;
    float* crow = c + (size_t)r * n;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int cc = col0 + jh * 64 + tx * 4;
      if (kVec && cc + 3 < n) {
        *reinterpret_cast<float4*>(crow + cc) =
            make_float4(acc[i][4 * jh], acc[i][4 * jh + 1],
                        acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cc + j < n) crow[cc + j] = acc[i][4 * jh + j];
      }
    }
  }
}

template <int KIND>
int launch_f32(const void* a, const void* b, void* c, int m, int n, int k,
               cudaStream_t stream) {
  const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
  if (grid.y > 65535) return -1;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  if (n % 4 == 0 && aligned16(b) && aligned16(c))
    semiring_matmul_f32_kernel<KIND, true>
        <<<grid, kFThreads, 0, stream>>>(fa, fb, fc, m, n, k);
  else
    semiring_matmul_f32_kernel<KIND, false>
        <<<grid, kFThreads, 0, stream>>>(fa, fb, fc, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ==== bool or_and: K packed into 32-bit words while staging ====

constexpr int kBM = 128, kBN = 128;            // output tile
constexpr int kBW = 8;                         // words a K slice (256 k)
constexpr int kBThreads = 256;

// 16 bytes of row `row` of a row-major (nrows, ncols) byte matrix from
// column `col` on; zeros past either edge. kVec: ncols % 16 == 0 and p on 16
// bytes, so a 16-byte load is whole or out.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        int row, int col, int nrows,
                                        int ncols) {
  if (row >= nrows || col >= ncols) return make_uint4(0, 0, 0, 0);
  const uint8_t* src = p + (size_t)row * ncols + col;
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (col + i < ncols) w[i / 4] |= (uint32_t)src[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of 0 or 1 -> 16 bits, byte i to bit i: the multiply gathers the
// low bit of each byte of a 64-bit word into its top byte (the partial
// products land on distinct bits, so nothing carries)
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  constexpr uint64_t kMagic = 0x0102040810204080ull;
  const uint64_t lo = (uint64_t)v.y << 32 | v.x;
  const uint64_t hi = (uint64_t)v.w << 32 | v.z;
  return (uint32_t)((lo * kMagic) >> 56) | (uint32_t)((hi * kMagic) >> 56) << 8;
}

template <bool kVec>
__global__ void __launch_bounds__(kBThreads)
semiring_matmul_or_and_kernel(const uint8_t* __restrict__ a,
                              const uint8_t* __restrict__ b,
                              uint8_t* __restrict__ c, int m, int n, int k) {
  // bit i of word w: k = k0 + 32 w + i
  __shared__ __align__(16) uint32_t ap[kBW][kBM];     // rows of A
  __shared__ __align__(16) uint32_t bp[kBW][kBN];     // columns of B

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  uint32_t acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < k; k0 += 32 * kBW) {
    __syncthreads();                   // the last slice's readers are done
    // A: 16 lanes a row, 16 k a lane; the even lane of a pair takes its
    // neighbour's 16 bits as the high half of the word
#pragma unroll
    for (int it = 0; it < kBM / 16; ++it) {
      const int r = it * 16 + warp * 2 + (lane >> 4), ch = lane & 15;
      const uint32_t bits =
          pack16(load16<kVec>(a, row0 + r, k0 + 16 * ch, m, k));
      const uint32_t high = __shfl_down_sync(0xffffffffu, bits, 1);
      if ((ch & 1) == 0) ap[ch >> 1][r] = bits | high << 16;
    }
    // B: lane l reads 16 columns of row k0 + 32 w + l; a ballot a column
#pragma unroll
    for (int it = 0; it < kBW * (kBN / 16) / 8; ++it) {
      const int job = it * 8 + warp;
      const int w = job / (kBN / 16), cb = (job % (kBN / 16)) * 16;
      const uint4 v = load16<kVec>(b, k0 + 32 * w + lane, col0 + cb, k, n);
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
      uint32_t mine = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const uint32_t col = __ballot_sync(
            0xffffffffu, (vw[q / 4] >> (8 * (q % 4))) & 1u);
        if (lane == q) mine = col;
      }
      if (lane < 16) bp[w][cb + lane] = mine;
    }
    __syncthreads();
    const int nw = min(kBW, (k - k0 + 31) / 32);
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(&ap[w][ty * 4]);
      const uint4 a1 = *reinterpret_cast<const uint4*>(&ap[w][64 + ty * 4]);
      const uint4 b0 = *reinterpret_cast<const uint4*>(&bp[w][tx * 4]);
      const uint4 b1 = *reinterpret_cast<const uint4*>(&bp[w][64 + tx * 4]);
      const uint32_t ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] |= ar[i] & br[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= m) continue;
    uint8_t* crow = c + (size_t)r * n;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int cc = col0 + jh * 64 + tx * 4;
      if (kVec && cc + 3 < n) {
        *reinterpret_cast<uint32_t*>(crow + cc) =
            (uint32_t)(acc[i][4 * jh] != 0u) |
            (uint32_t)(acc[i][4 * jh + 1] != 0u) << 8 |
            (uint32_t)(acc[i][4 * jh + 2] != 0u) << 16 |
            (uint32_t)(acc[i][4 * jh + 3] != 0u) << 24;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cc + j < n) crow[cc + j] = acc[i][4 * jh + j] != 0u;
      }
    }
  }
}

int launch_or_and(const void* a, const void* b, void* c, int m, int n, int k,
                  cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return -1;
  const uint8_t* ua = static_cast<const uint8_t*>(a);
  const uint8_t* ub = static_cast<const uint8_t*>(b);
  uint8_t* uc = static_cast<uint8_t*>(c);
  if (k % 16 == 0 && n % 16 == 0 && aligned16(a) && aligned16(b) &&
      aligned16(c))
    semiring_matmul_or_and_kernel<true>
        <<<grid, kBThreads, 0, stream>>>(ua, ub, uc, m, n, k);
  else
    semiring_matmul_or_and_kernel<false>
        <<<grid, kBThreads, 0, stream>>>(ua, ub, uc, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ==== the other types: 64 x 64 tiles, 4 x 4 micro-tiles (the first design)

constexpr int kBM0 = 64, kBN0 = 64, kBK0 = 16;
constexpr int kTM = 4, kTN = 4;
constexpr int kThreads = (kBM0 / kTM) * (kBN0 / kTN);  // 256
constexpr int kTX = kBN0 / kTN;                        // 16 threads across

// ---- element types: what is loaded, what is accumulated, what is stored ----

template <typename T> struct Elem {                   // f64, i32, i64
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

// ---- algebras -------------------------------------------------------------

// NaN wins, as in torch.minimum / maximum, and -0 orders below +0, as
// min.NaN / max.NaN do: comparisons, never fmin/fmax, which drop NaN
template <typename T>
__device__ __forceinline__ T nan_min(T x, T y) {
  return (x != x || x < y || (x == y && signbit(x))) ? x : y;
}
template <typename T>
__device__ __forceinline__ T nan_max(T x, T y) {
  return (x != x || x > y || (x == y && !signbit(x))) ? x : y;
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

// ---- the kernel -----------------------------------------------------------

template <typename G, typename A>
__device__ __forceinline__ void step4x4(A (&acc)[kTM][kTN],
                                        const A* __restrict__ ak,
                                        const A* __restrict__ bk, int ty,
                                        int tx) {
  A av[kTM], bv[kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) av[i] = ak[ty + kTX * i];
#pragma unroll
  for (int j = 0; j < kTN; ++j) bv[j] = bk[tx + kTX * j];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) G::step(acc[i][j], av[i], bv[j]);
}

template <int KIND, typename T>
__global__ void __launch_bounds__(kThreads)
semiring_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       T* __restrict__ c, int m, int n, int k) {
  using E = Elem<T>;
  using A = typename E::Acc;
  using G = Alg<KIND, A>;
  __shared__ A as[kBK0][kBM0 + 1];                    // A slice, transposed
  __shared__ A bs[kBK0][kBN0];

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int row0 = blockIdx.y * kBM0, col0 = blockIdx.x * kBN0;

  A acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = G::identity();

  for (int k0 = 0; k0 < k; k0 += kBK0) {
#pragma unroll
    for (int l = 0; l < kBM0 * kBK0 / kThreads; ++l) {
      const int idx = tid + l * kThreads;             // k fastest: coalesced
      const int r = idx / kBK0, kk = idx % kBK0;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? E::load(a[(size_t)gr * k + gk]) : A(0);
    }
#pragma unroll
    for (int l = 0; l < kBK0 * kBN0 / kThreads; ++l) {
      const int idx = tid + l * kThreads;             // columns fastest
      const int kk = idx / kBN0, cc = idx % kBN0;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? E::load(b[(size_t)gk * n + gc]) : A(0);
    }
    __syncthreads();
    const int kmax = min(kBK0, k - k0);               // padded k never enters
    if (kmax == kBK0) {
#pragma unroll
      for (int kk = 0; kk < kBK0; ++kk)
        step4x4<G>(acc, as[kk], bs[kk], ty, tx);
    } else {
      for (int kk = 0; kk < kmax; ++kk)
        step4x4<G>(acc, as[kk], bs[kk], ty, tx);
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
  const dim3 grid((n + kBN0 - 1) / kBN0, (m + kBM0 - 1) / kBM0);
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
        case kF32: return launch_f32<kPlusTimes>(a, b, c, m, n, k, s);
        case kF64: return launch<kPlusTimes, double>(a, b, c, m, n, k, s);
        case kBF16:
          return launch<kPlusTimes, __nv_bfloat16>(a, b, c, m, n, k, s);
        case kI32: return launch<kPlusTimes, int32_t>(a, b, c, m, n, k, s);
        case kI64: return launch<kPlusTimes, int64_t>(a, b, c, m, n, k, s);
      }
      return -1;
    case kMinPlus:
      switch (dtype) {
        case kF32: return launch_f32<kMinPlus>(a, b, c, m, n, k, s);
        case kF64: return launch<kMinPlus, double>(a, b, c, m, n, k, s);
      }
      return -1;
    case kMaxMin:
      switch (dtype) {
        case kF32: return launch_f32<kMaxMin>(a, b, c, m, n, k, s);
        case kF64: return launch<kMaxMin, double>(a, b, c, m, n, k, s);
      }
      return -1;
    case kOrAnd:
      if (dtype == kBool) return launch_or_and(a, b, c, m, n, k, s);
      return -1;
  }
  return -1;
}
