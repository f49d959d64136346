// Blocked-ELL sparse x dense product for Hopper (sm_90a): y = A @ x.
//
// Replaces repro/kernels/bsr_spmm.py::bsr_spmm, the TPU kernel of the SpMM
// offload and of the MoE experts (a block-diagonal A is a grouped matmul;
// repro/models/layers.py::_expert_ffn runs its einsum twin, the port's
// _expert_ffn calls this kernel). A has R block-rows; block-row r stores K
// dense (bm x bk) blocks vals[r, t] with block-column ids cols[r, t], and an
// id of -1 is padding that contributes zero. The TPU kernel walks an
// (R, n/bn, K) grid with K innermost and sequential, carrying the output tile
// in VMEM, scalar-prefetches the ids to pick x's tile, and multiplies a
// padding block by a zeroed operand (branchless). Here a block owns output
// tiles of one block-row and walks that row's K blocks itself, summing in
// float32 registers; a padding block (id -1) is skipped before anything is
// loaded, so an expert that received no token costs no reads of its
// weights, and a row of padding alone still writes its zeros; an id past
// x's last block reads the last block, as ref.bsr_spmm's clip does; rows,
// columns and depth past the edge are zeros and never stored.
//
// What bounds it on this card. At the main path's prefill (R = 64 experts,
// K = 1, bm = C = 640, bk = 2048 or 1408, n = 1408 or 2048, bf16) the work
// is 2 bm bk n FLOP per stored block, 221.5 GFLOP with 60 experts real,
// against 0.62 GB of operands and output: the tensor cores bound it (0.224
// ms at 989 TFLOP/s). At decode (bm = 8) each weight is read for 8 rows,
// some 8 FLOP a byte: the bytes of the experts that received a token bound
// it (3.35 TB/s).
//
// Design (bf16 with bk and n multiples of 8 and 16-byte aligned tensors,
// what TMA takes): a warp-specialised wgmma GEMM fed by TMA
// (bsr_spmm_wgmma_kernel). Warpgroup 0 is the producer, one thread of which
// TMA-loads 64-deep slices of A and x into a ring of shared-memory stages
// gated by mbarriers; one or two consumer warpgroups run wgmma m64nNk16 from
// shared memory into float32 registers (setmaxnreg: 40 registers for the
// producer, 232 for the consumers), one slice's group in flight while the
// next is issued. Every operand lands in 128-byte-swizzled (SW128) boxes of
// 64 columns, which the wgmma descriptors describe (hopper.cuh); x is
// row-major (bk, n), so it is the MN-major B operand (the transpose bit).
// The tile is rounded once to bf16 into swizzled staging boxes and written
// by a TMA store, which runs on while the next tile's products start (the
// threads' own stores, one bf16 pair each, had cost over a quarter of the
// kernel's time, PERF.md). The maps are rank 3, (R*K, bm, bk) for A,
// (nblk, bk, n) for x and (R, bm, n) for y, so TMA zero-fills rows past bm,
// depth past bk and columns past n instead of reading a neighbouring block,
// and never writes past the edge.
//   * prefill (bm > 64): 128-row tiles (two consumer warpgroups) by 256
//     columns where 256 divides n, else 128 (each measured the faster at
//     its shape); 3 or 6 stages; one persistent block an SM walks the
//     tiles, row tiles fastest, so the blocks that run together share x's
//     columns in L2.
//   * decode (bm <= 64): 64-row tiles by 64 columns, one consumer
//     warpgroup, 4 stages, a tile a block and three blocks an SM, so the
//     real experts' weights stream from every SM at once.
// Everything else (f32; bf16 that TMA cannot take: bk or n not a multiple of
// 8, a pointer off 16 bytes) runs a float32 FMA kernel: 64x64 tiles, a 4x4
// micro-tile per thread, 16-deep slices of A (transposed) and x through
// shared memory.
//
// C interface (bound with ctypes): bsr_spmm_launch returns cudaGetLastError()
// after the launch, 0 on success, -1 for a dtype or grid this file does not
// take, or -2 (hopper::kTensorMapError) when a tensor map is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;
constexpr int kTX = 16;                // threads across the tile's columns

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
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int K, int bm,
                int bk, int n, int nblk) {
  using E = Elem<T>;
  __shared__ float as[kBK][kBM + 1];   // A slice, transposed
  __shared__ float xs[kBK][kBN];       // x slice

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int r = blockIdx.z;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < K; ++t) {
    int c = cols[(size_t)r * K + t];
    if (c < 0) continue;               // padding: skipped before any load
    c = min(c, nblk - 1);
    const T* a = vals + ((size_t)r * K + t) * bm * bk;
    const T* xb = x + (size_t)c * bk * n;
    for (int k0 = 0; k0 < bk; k0 += kBK) {
#pragma unroll
      for (int l = 0; l < kBM * kBK / kThreads; ++l) {
        const int idx = tid + l * kThreads;           // depth fastest
        const int rr = idx / kBK, kk = idx % kBK;
        const int gr = row0 + rr, gk = k0 + kk;
        as[kk][rr] = (gr < bm && gk < bk)
            ? E::load(a[(size_t)gr * bk + gk]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < kBK * kBN / kThreads; ++l) {
        const int idx = tid + l * kThreads;           // columns fastest
        const int kk = idx / kBN, cc = idx % kBN;
        const int gk = k0 + kk, gc = col0 + cc;
        xs[kk][cc] = (gk < bk && gc < n)
            ? E::load(xb[(size_t)gk * n + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + kTX * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[kk][tx + kTX * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + kTX * i;
    if (gr >= bm) continue;
    T* yrow = y + ((size_t)r * bm + gr) * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + kTX * j;
      if (gc < n) yrow[gc] = E::store(acc[i][j]);
    }
  }
}

// ---- bf16 on the tensor cores: wgmma fed by TMA ---------------------------
//
// A tile is kWG * 64 rows of one block-row's output by kBN columns; tile t
// is (r, column tile, row tile) with row tiles fastest. The producer walks
// each tile's stored blocks and their 64-deep slices: A's (kWG*64 x 64) and
// x's (64 x kBN) slices land in stage s, whose "full" mbarrier counts the
// bytes and whose "empty" one counts the consumer warps that are done with
// it. Consumer warpgroup w multiplies rows 64 w.. of the tile.

template <int kWG, int kBN>
struct WgmmaTile {
  static constexpr int kBM = 64 * kWG;                 // rows a tile
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kStages = kWG == 1 ? 4 : (kBN == 256 ? 3 : 6);
  static constexpr uint32_t kABytes = kBM * 64 * 2;    // A slice
  static constexpr uint32_t kXBytes = 64 * kBN * 2;    // x slice
  static constexpr uint32_t kStageBytes = kABytes + kXBytes;
  static constexpr uint32_t kOutBytes = 64 * kBN * 2;  // a warpgroup's rows
  static constexpr size_t kSmem =
      kStages * kStageBytes + kWG * kOutBytes + 1024;  // + alignment
};

template <int kWG, int kBN>
__global__ void __launch_bounds__(WgmmaTile<kWG, kBN>::kThreads,
                                  kWG == 2 ? 1 : 3)
bsr_spmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_y,
                      const int32_t* __restrict__ cols, int K, int bk,
                      int nblk, int mtiles, int ntiles_n, int ntiles) {
  using namespace hopper;
  using T = WgmmaTile<kWG, kBN>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  auto a_stage = [&](int s) { return smem + s * T::kStageBytes; };
  auto x_stage = [&](int s) { return smem + s * T::kStageBytes + T::kABytes; };
  // tile t: block-row r, then column tiles, then row tiles fastest (the
  // blocks that run together share x's columns)
  auto tile_of = [&](int t, int& r, int& mi, int& ni) {
    r = t / (mtiles * ntiles_n);
    mi = t % mtiles;
    ni = t / mtiles % ntiles_n;
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int nk = (bk + 63) / 64;

  if (wg == 0) {                       // producer warpgroup
    if constexpr (kWG == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int r, mi, ni;
        tile_of(t, r, mi, ni);
        for (int b = 0; b < K; ++b) {
          int c = cols[(size_t)r * K + b];
          if (c < 0) continue;         // padding: skipped before any load
          c = min(c, nblk - 1);
          for (int ks = 0; ks < nk; ++ks) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], T::kStageBytes);
            tma_load_3d(a_stage(stage), &map_a, &full[stage], ks * 64,
                        mi * T::kBM, r * K + b);
#pragma unroll
            for (int h = 0; h < kBN / 64; ++h)
              tma_load_3d(x_stage(stage) + h * 8192, &map_x, &full[stage],
                          ni * kBN + h * 64, ks * 64, c);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {                             // consumer warpgroups
    if constexpr (kWG == 2) setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int wtid = threadIdx.x & 127, lane = threadIdx.x & 31;
    const int warp = wtid >> 5, g = lane >> 2, tq = lane & 3;
    unsigned char* out = smem + kStages * T::kStageBytes + cw * T::kOutBytes;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int r, mi, ni;
      tile_of(t, r, mi, ni);
      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);                 // no group in flight here
      int prev = -1;
      for (int b = 0; b < K; ++b) {
        if (cols[(size_t)r * K + b] < 0) continue;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(&full[stage], phase);
          wgmma_fence();
          const unsigned char* a = a_stage(stage) + cw * 8192;
          const unsigned char* xs = x_stage(stage);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = desc_kmajor(a + kk * 32);
            const uint64_t dx = desc_mnmajor(xs + kk * 2048, 8192);
            if constexpr (kBN == 256)
              wgmma_ss_n256<0, 1>(acc, da, dx, 1);
            else if constexpr (kBN == 128)
              wgmma_ss_n128<0, 1>(acc, da, dx, 1);
            else
              wgmma_ss_n64<0, 1>(acc, da, dx, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();             // the previous slice's group is done
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // the epilogue: the warpgroup's 64 rows, rounded once to bf16, into
      // its SW128 staging boxes (conflict-free: the 8 rows of a store fall
      // on 8 chunks), then one thread TMA-stores them (rows past bm and
      // columns past n are not written) while the next tile starts
      if (wtid == 0) bulk_wait_read<0>();  // the last store has read it
      named_barrier(1 + cw, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = warp * 16 + g + 8 * i;
          *reinterpret_cast<__nv_bfloat162*>(
              out + (j / 8) * 8192 + sw128_offset(row, j % 8) + tq * 4) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i],
                                    acc[4 * j + 2 * i + 1]);
        }
      fence_proxy_async();
      named_barrier(1 + cw, 128);
      if (wtid == 0) {
#pragma unroll
        for (int h = 0; h < kBN / 64; ++h)
          tma_store_3d(&map_y, out + h * 8192, ni * kBN + h * 64,
                       mi * T::kBM + cw * 64, r);
        bulk_commit();
      }
    }
    if (wtid == 0) bulk_wait<0>();
  }
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y, int R,
           int K, int bm, int bk, int n, int nblk, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (bm + kBM - 1) / kBM, R);
  if (grid.y > 65535 || grid.z > 65535) return -1;
  bsr_spmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), K, bm, bk, n, nblk);
  return static_cast<int>(cudaGetLastError());
}

// bm > 64: tiles of 128 rows (two consumer warpgroups) by 256 columns where
// 256 divides n, else 128, one persistent block an SM. bm <= 64 (decode,
// bm = C = 8): tiles of 64 rows by 64 columns, a tile a block and three
// blocks an SM, so that the weights of the experts with tokens stream from
// every SM.
template <int kWG, int kBN>
int launch_wgmma(const void* cols, const void* vals, const void* x, void* y,
                 int R, int K, int bm, int bk, int n, int nblk,
                 cudaStream_t stream) {
  using T = WgmmaTile<kWG, kBN>;
  CUtensorMap map_a, map_x, map_y;
  const uint64_t a_dims[3] = {(uint64_t)bk, (uint64_t)bm, (uint64_t)R * K};
  const uint64_t a_strides[2] = {(uint64_t)bk, (uint64_t)bm * bk};
  const uint32_t a_box[3] = {64, T::kBM, 1};
  const uint64_t x_dims[3] = {(uint64_t)n, (uint64_t)bk, (uint64_t)nblk};
  const uint64_t x_strides[2] = {(uint64_t)n, (uint64_t)bk * n};
  const uint64_t y_dims[3] = {(uint64_t)n, (uint64_t)bm, (uint64_t)R};
  const uint64_t y_strides[2] = {(uint64_t)n, (uint64_t)bm * n};
  const uint32_t box64[3] = {64, 64, 1};
  if (hopper::make_map_bf16(&map_a, vals, 3, a_dims, a_strides, a_box) ||
      hopper::make_map_bf16(&map_x, x, 3, x_dims, x_strides, box64) ||
      hopper::make_map_bf16(&map_y, y, 3, y_dims, y_strides, box64))
    return hopper::kTensorMapError;
  auto kern = bsr_spmm_wgmma_kernel<kWG, kBN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int mtiles = (bm + T::kBM - 1) / T::kBM;
  const int ntiles_n = (n + kBN - 1) / kBN;
  const long long ntiles = (long long)R * mtiles * ntiles_n;
  if (ntiles >= (1ll << 31)) return -1;
  int grid = (int)ntiles;
  if (kWG == 2 && grid > hopper::sm_count()) grid = hopper::sm_count();
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(
      map_a, map_x, map_y, static_cast<const int32_t*>(cols), K, bk, nblk,
      mtiles, ntiles_n, (int)ntiles);
  return static_cast<int>(cudaGetLastError());
}

// TMA takes it: rows of A, x and y on 16 bytes (bk, n multiples of 8), the
// three tensors on 16 bytes; at least one stored block a row
bool wgmma_fits(const void* vals, const void* x, const void* y, int K, int bk,
                int n) {
  return K > 0 && bk % 8 == 0 && n % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(x) |
          reinterpret_cast<uintptr_t>(y)) % 16 == 0;
}

}  // namespace

extern "C" int bsr_spmm_launch(const void* cols, const void* vals,
                               const void* x, void* y, int R, int K, int bm,
                               int bk, int n, int nblk, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(cols, vals, x, y, R, K, bm, bk, n, nblk, s);
    case kBF16:
      if (wgmma_fits(vals, x, y, K, bk, n)) {
        if (bm <= 64)
          return launch_wgmma<1, 64>(cols, vals, x, y, R, K, bm, bk, n, nblk,
                                     s);
        if (n % 256 == 0)
          return launch_wgmma<2, 256>(cols, vals, x, y, R, K, bm, bk, n,
                                      nblk, s);
        return launch_wgmma<2, 128>(cols, vals, x, y, R, K, bm, bk, n, nblk,
                                    s);
      }
      return launch<__nv_bfloat16>(cols, vals, x, y, R, K, bm, bk, n, nblk, s);
  }
  return -1;
}
