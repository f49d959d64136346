// Segmented semiring reduce for Hopper (sm_90a).
//
// Replaces repro/kernels/segreduce.py::segment_reduce_pallas, the TPU kernel
// that keeps an output tile resident in VMEM and sweeps the input past it.
// Two routes; the Python wrapper's route() names the one a call takes.
//
// ATOMIC ROUTE (any id order, scalar or vector values): the first design,
// right for ANY id order, not fast:
//
//   1. segreduce_init   fills out[0:S*D) with the accumulator fill of the tag
//                       (0 for sum, the dtype extreme for min/max) and, when
//                       a touch count is asked for, touched[0:S) with 0;
//   2. segreduce_accum  one thread per input element: ids outside [0, S) are
//                       dropped; otherwise the value is combined atomically
//                       into out[id] and, when counted, touched[id] gains 1.
//
// Values are rows of D elements (D = 1 for a scalar stream; vector values
// reduce element by element, one touch per row). touched may be null: the
// Python wrapper asks for it only when it must write the monoid's declared
// identity into min/max segments whose touch count is 0 (segreduce.py:136-139
// of the TPU kernel); a sum, or a min/max that keeps the fill, skips both its
// init store and its per-element atomic.
//
// Combines, by type:
//   sum  f32/f64       atomicAdd (the f32 sum order follows the atomics, so
//                      it varies from run to run: the error bound is the one
//                      of any summation order, (count-1)*eps*sum|v| per segment;
//                      integer-valued inputs below 2^24 stay exact)
//   sum  i32/i64       atomicAdd (two's complement wraps, like the plain path)
//   min/max i32/i64    atomicMin / atomicMax
//   min/max f32/f64    compare-and-swap loop; NaN propagates like jnp.minimum
//   min/max bool       an idempotent byte store: lor (max) stores true for a
//                      true input, land (min) stores false for a false input;
//                      every writer of a segment writes the same byte, so the
//                      race is benign and no atomic is needed (a bool sum is
//                      a logical or: the wrapper launches it as max)
//
// Sorted ids put equal ids in one warp, so the atomics of a run serialise on
// one address, and the f32 sum's order changes from launch to launch.
//
// SORTED ROUTE (a non-decreasing id stream, scalar values, every dtype and
// tag): an atomic-free segmented reduce over the runs of equal ids. What
// bounds it is memory: it reads the in-range ids and values once and writes
// each of the S output slots once (a scalar f32 sum at N = S = 2^24 moves
// 0.201 GB, 60 us at 3.35 TB/s). The design:
//
//   segreduce_sorted_tiles  one wave of persistent blocks of 256 threads
//       (as many as fit on the card at once) walks the tiles of 2048
//       elements, block b taking tiles b, b + grid, ... It first reads the
//       two ends and the two neighbours of up to 256 of its tiles at once;
//       a tile whose first id is >= S, or whose last id is < 0, holds no
//       in-range id and is done without reading its values (the sorted
//       padding tail of the merge engine's run ids, ~90 % of its input).
//       A live tile is read with 16-byte vector loads (8 ids and 8 values
//       a thread); each thread reduces its own elements serially, a
//       segmented scan over (head flag, partial) across the warp (shuffles)
//       and the block (shared memory) gives each thread the partial of the
//       run open at its first element, and the thread that holds a run's
//       last element writes the run's reduction, once.
//   segreduce_sorted_carry  one warp per run that crosses a tile edge: the
//       tile where the run starts lists it (a counter, never values); the
//       warp combines that tile's last_val with first_val of the tiles
//       after it, 32 tiles a step, in tile order, until the run ends, and
//       writes the run's slot (a segment of 2^20 elements spans 512 tiles).
//
// Each slot of [0, S) has one writer. A tile owns the slots from its first
// id (or the one after it, when its first run continues from the previous
// tile; 0 for the first tile) up to the id after the tile (up to its last
// id, when its last run continues into the next tile): its runs' results
// and the gaps among them, slots that no id names. Gaps take the declared
// identity for min/max (the dtype extreme without one) and 0 for a sum, in
// the same pass: the first 4096 owned slots are staged in shared memory,
// filled with the gap value, overwritten by the results and written out
// coalesced; past that window, results are stored directly and a gap is
// stored by the thread after whose run it lies when it is at most 32 slots,
// else cut into 2048-slot pieces that the carry kernel's warps fill in
// parallel (the merge engine's tail gap is some 400,000 slots). A slot
// holding a run's reduction is never combined with the gap value, so a run
// whose values lie beyond the declared identity (MAX_INT's -(2^31)+1) keeps
// its true reduction; no touch count, no pass afterwards.
//
// Every combine happens in a fixed order (serial within a thread, a fixed
// shuffle tree within a warp, warp order within a block, tile order across
// tiles), so the result of every dtype and tag, f32 sums included, is
// bitwise the same from launch to launch. Ties and NaN: min returns -0 and
// max +0 on a tie of -0 and +0, whatever their order; NaN propagates as
// jnp.minimum/jnp.maximum do (the first NaN in id order); a float sum of
// zeros is +0, as in the plain version.
//
// Ids are clamped in registers to [-1, S] (an id < 0 is -1, an id >= S is
// S; S < 2^31 - 1, so S + 1 fits an int), so the order of a sorted stream
// with out-of-range ids on both sides is kept. The neighbour compares that
// find the runs also find a descent: one atomicOr sets the caller's device
// flag, only when one is seen (a tile without an in-range id compares its
// ends alone). A broken promise gives wrong values but never writes outside
// out or the scratch.
//
// C interface (bound with ctypes): segreduce_launch (atomic route) and
// segreduce_sorted_launch return cudaGetLastError() after their launches, 0
// on success; segreduce_sorted_scratch_bytes sizes the sorted route's
// scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Tag { kSum = 0, kMin = 1, kMax = 2 };
enum DType { kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3, kBool = 4 };

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ float pick_f32(int tag, float cur, float v) {
  if (cur != cur) return cur;              // NaN already stored
  if (v != v) return v;                    // NaN input
  return tag == kMin ? (v < cur ? v : cur) : (v > cur ? v : cur);
}

__device__ __forceinline__ double pick_f64(int tag, double cur, double v) {
  if (cur != cur) return cur;
  if (v != v) return v;
  return tag == kMin ? (v < cur ? v : cur) : (v > cur ? v : cur);
}

template <typename T>
__device__ __forceinline__ void combine(int tag, T* addr, T v);

template <>
__device__ __forceinline__ void combine<float>(int tag, float* addr, float v) {
  if (tag == kSum) {
    atomicAdd(addr, v);
    return;
  }
  int* a = reinterpret_cast<int*>(addr);
  int old = *a;
  int assumed;
  do {
    assumed = old;
    int want = __float_as_int(pick_f32(tag, __int_as_float(assumed), v));
    if (want == assumed) return;
    old = atomicCAS(a, assumed, want);
  } while (old != assumed);
}

template <>
__device__ __forceinline__ void combine<double>(int tag, double* addr, double v) {
  if (tag == kSum) {
    atomicAdd(addr, v);
    return;
  }
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  unsigned long long assumed;
  do {
    assumed = old;
    unsigned long long want = static_cast<unsigned long long>(__double_as_longlong(
        pick_f64(tag, __longlong_as_double(static_cast<long long>(assumed)), v)));
    if (want == assumed) return;
    old = atomicCAS(a, assumed, want);
  } while (old != assumed);
}

template <>
__device__ __forceinline__ void combine<int>(int tag, int* addr, int v) {
  if (tag == kSum) atomicAdd(addr, v);
  else if (tag == kMin) atomicMin(addr, v);
  else atomicMax(addr, v);
}

template <>
__device__ __forceinline__ void combine<long long>(int tag, long long* addr, long long v) {
  if (tag == kSum) {
    atomicAdd(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(v));
  } else if (tag == kMin) {
    atomicMin(addr, v);
  } else {
    atomicMax(addr, v);
  }
}

template <>
__device__ __forceinline__ void combine<bool>(int tag, bool* addr, bool v) {
  // idempotent store (see the header); a bool sum arrives as max
  if (tag == kMax && v) *addr = true;
  else if (tag == kMin && !v) *addr = false;
}

template <typename T>
__global__ void segreduce_init(T* __restrict__ out, long long len,
                               int* __restrict__ touched, long long s, T fill) {
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long lim = len > s ? len : s;       // len < s only for rows of D = 0
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < lim; i += stride) {
    if (i < len) out[i] = fill;
    if (touched != nullptr && i < s) touched[i] = 0;
  }
}

template <typename T>
__global__ void segreduce_accum(const T* __restrict__ values,
                                const int* __restrict__ ids, long long len,
                                long long d, T* __restrict__ out,
                                int* __restrict__ touched, long long s, int tag) {
  long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    long long row = d == 1 ? i : i / d;
    int id = ids[row];
    if (id < 0 || id >= s) continue;       // out-of-range ids are dropped
    long long col = i - row * d;
    combine<T>(tag, out + static_cast<long long>(id) * d + col, values[i]);
    if (touched != nullptr && col == 0) atomicAdd(touched + id, 1);
  }
}

inline unsigned int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned int>(b);
}

template <typename T>
void launch(const void* values, const int* ids, long long n, long long d,
            void* out, int* touched, long long s, int tag, T fill,
            cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  long long init_len = s * d > s ? s * d : s;
  if (init_len > 0) {
    segreduce_init<T><<<blocks_for(init_len), kThreads, 0, stream>>>(
        o, s * d, touched, s, fill);
  }
  if (n * d > 0) {
    segreduce_accum<T><<<blocks_for(n * d), kThreads, 0, stream>>>(
        static_cast<const T*>(values), ids, n * d, d, o, touched, s, tag);
  }
}

}  // namespace

// values: n rows of d elements; out: num_segments rows of d elements;
// touched: num_segments ints, or null when no touch count is wanted.
extern "C" int segreduce_launch(const void* values, const void* ids,
                                long long n, long long d, void* out,
                                void* touched, long long num_segments, int tag,
                                int dtype, const void* fill, void* stream) {
  const int* id = static_cast<const int*>(ids);
  int* t = static_cast<int*>(touched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch<float>(values, id, n, d, out, t, num_segments, tag,
                    *static_cast<const float*>(fill), st);
      break;
    case kF64:
      launch<double>(values, id, n, d, out, t, num_segments, tag,
                     *static_cast<const double*>(fill), st);
      break;
    case kI32:
      launch<int>(values, id, n, d, out, t, num_segments, tag,
                  *static_cast<const int*>(fill), st);
      break;
    case kI64:
      launch<long long>(values, id, n, d, out, t, num_segments, tag,
                        *static_cast<const long long*>(fill), st);
      break;
    case kBool:
      launch<bool>(values, id, n, d, out, t, num_segments, tag,
                   *static_cast<const bool*>(fill), st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Sorted route
// ---------------------------------------------------------------------------

namespace sorted_route {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // elements a thread
constexpr int kTile = kThreads * kItems;      // elements a block
constexpr int kSmallGap = 32;                 // a gap up to this: one thread
constexpr int kGapChunk = 2048;               // a longer gap: pieces, a warp each
constexpr int kWindow = 4096;                 // output slots staged a tile
constexpr long long kMaxCarryBlocks = 264;    // 2 per SM: crossing runs, gap pieces
constexpr unsigned kFull = 0xffffffffu;

// -- combines (TAG is kSum, kMin or kMax; a bool sum arrives as max) --------

__device__ __forceinline__ float vmin(float a, float b) {
  if (a != a) return a;                       // NaN propagates
  if (b != b) return b;
  if (a == b) return __float_as_int(a) < 0 ? a : b;   // -0 below +0
  return a < b ? a : b;
}
__device__ __forceinline__ float vmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return __float_as_int(a) < 0 ? b : a;   // +0 above -0
  return a > b ? a : b;
}
__device__ __forceinline__ double vmin(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return __double_as_longlong(a) < 0 ? a : b;
  return a < b ? a : b;
}
__device__ __forceinline__ double vmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return __double_as_longlong(a) < 0 ? b : a;
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a < b ? b : a; }

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ double vadd(double a, double b) { return a + b; }
__device__ __forceinline__ int vadd(int a, int b) {       // wraps
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ long long vadd(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ unsigned char vadd(unsigned char a, unsigned char b) {
  return a | b;                               // never launched: bool sum is max
}

template <int TAG, typename T>
__device__ __forceinline__ T op(T a, T b) {
  if constexpr (TAG == kSum) return vadd(a, b);
  else if constexpr (TAG == kMin) return vmin(a, b);
  else return vmax(a, b);
}

// a float sum of zeros is +0, as the plain version's 0 + v + ... gives
template <int TAG, typename T>
__device__ __forceinline__ T finalize(T v) {
  if constexpr (TAG == kSum && std::is_floating_point<T>::value)
    return v + T(0);
  else
    return v;
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  if constexpr (sizeof(T) < 4)
    return static_cast<T>(__shfl_up_sync(kFull, static_cast<int>(v), d));
  else
    return __shfl_up_sync(kFull, v, d);
}
template <typename T>
__device__ __forceinline__ T shfl_down(T v, int d) {
  if constexpr (sizeof(T) < 4)
    return static_cast<T>(__shfl_down_sync(kFull, static_cast<int>(v), d));
  else
    return __shfl_down_sync(kFull, v, d);
}
template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int lane) {
  if constexpr (sizeof(T) < 4)
    return static_cast<T>(__shfl_sync(kFull, static_cast<int>(v), lane));
  else
    return __shfl_sync(kFull, v, lane);
}

// an id < 0 is -1 and an id >= S is S: a sorted stream stays sorted
__device__ __forceinline__ int clamp_id(int id, int s) {
  return id < 0 ? -1 : (id > s ? s : id);
}

// 8 consecutive elements from a 16-byte aligned address (8 bytes for bool)
template <typename T>
__device__ __forceinline__ void load_items(const T* p, T (&v)[kItems]) {
  constexpr int kBytes = kItems * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    union { int4 q[kBytes / 16]; T e[kItems]; } u;
    const int4* src = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) u.q[i] = src[i];
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = u.e[i];
  } else {
    union { uint2 q; T e[kItems]; } u;
    u.q = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] = u.e[i];
  }
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Slots [lo, hi) that no id names take the gap value, stored directly when
// the gap is short, else appended in kGapChunk pieces for the carry kernel.
template <typename T>
__device__ __noinline__ void fill_gap(int lo, int hi, T* __restrict__ out,
                                      T gap, int2* __restrict__ gaps,
                                      int* __restrict__ gap_count,
                                      long long gap_cap) {
  if (hi - lo <= kSmallGap) {
    for (int j = lo; j < hi; ++j) out[j] = gap;
    return;
  }
  const int pieces = static_cast<int>((static_cast<long long>(hi) - lo +
                                       kGapChunk - 1) / kGapChunk);
  const long long at = atomicAdd(gap_count, pieces);
  for (int c = 0; c < pieces && at + c < gap_cap; ++c) {
    const int lo_c = lo + c * kGapChunk;
    gaps[at + c] = make_int2(lo_c, imin(hi - lo_c, kGapChunk));
  }
}

// A tile owns the output slots [A, B): from its first id (the one after it
// when its first run continues from the left; 0 for tile 0) to the id after
// it (its last id when its last run continues into the next tile). Every
// slot of [0, S) has one owner, or is a crossing run's, which the carry
// kernel writes. The owner writes the run results and the gaps among them.
struct Ends {
  int first, last, next, prev;                // prev = -2 before the stream
};

__device__ __forceinline__ int own_lo(const Ends& e, long long tile, int s) {
  return tile == 0 ? 0 : imin(imax(imax(e.first, e.prev + 1), 0), s);
}
__device__ __forceinline__ int own_hi(const Ends& e, int lo, int s) {
  return imax(imin(e.next == e.last ? e.last : e.next, s), lo);
}

template <typename T, int TAG>
__global__ void __launch_bounds__(kThreads)
segreduce_sorted_tiles(const T* __restrict__ values, const int* __restrict__ ids,
                       long long n, int s, long long tiles,
                       T* __restrict__ out, T ident, T gap,
                       T* __restrict__ first_val, T* __restrict__ last_val,
                       int2* __restrict__ cross, int* __restrict__ counts,
                       int2* __restrict__ gaps, long long gap_cap,
                       int* __restrict__ descent, int vec) {
  __shared__ int s_first[kWarps], s_last[kWarps], s_flag[kWarps];
  __shared__ T s_agg[kWarps];
  __shared__ T s_out[kWindow];                // the owned slots, staged
  __shared__ Ends s_ends[kThreads];           // the probed tiles' ends
  int* gap_count = counts;
  int* cross_count = counts + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long stride = gridDim.x;
  // tiles blockIdx.x, + stride, + 2 stride, ...: their ends probed
  // kThreads at a time, so tiles without an in-range id cost one load round
  for (long long t0 = blockIdx.x; t0 < tiles; t0 += stride * kThreads) {
    const long long pt = t0 + tid * stride;
    if (pt < tiles) {
      const long long st = pt * kTile;
      const long long en = st + kTile < n ? st + kTile : n;
      s_ends[tid] = Ends{st < n ? clamp_id(ids[st], s) : s,
                         en > st ? clamp_id(ids[en - 1], s) : s,
                         en < n ? clamp_id(ids[en], s) : s,
                         st > 0 ? clamp_id(ids[st - 1], s) : -2};
    }
    __syncthreads();
    const long long left = (tiles - t0 + stride - 1) / stride;
    const int count = left < kThreads ? static_cast<int>(left) : kThreads;
    for (int k = 0; k < count; ++k) {
      const long long tile = t0 + k * stride;
      const Ends e = s_ends[k];
      const int A = own_lo(e, tile, s);
      const int B = own_hi(e, A, s);
      if (e.first >= s || e.last < 0) {      // no in-range id: values unread
        if (tid == 0) {
          if (e.last < e.first || e.prev > e.first) atomicOr(descent, 1);
          if (B > A) fill_gap(A, B, out, gap, gaps, gap_count, gap_cap);
        }
        continue;
      }
      const long long start = tile * kTile;
      const long long end = start + kTile < n ? start + kTile : n;
      const long long base = start + static_cast<long long>(tid) * kItems;
      int id[kItems];
      T v[kItems];
      if (vec && end - start == kTile) {
        load_items(ids + base, id);
        load_items(values + base, v);
      } else {
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const bool in = base + i < end;
          id[i] = in ? ids[base + i] : s;    // past the end: padding, id S
          v[i] = in ? values[base + i] : ident;
        }
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) id[i] = clamp_id(id[i], s);
      // the first kWindow owned slots start as gaps; results overwrite them
      const int wlen = imin(B - A, kWindow);
      for (int j = tid; j < wlen; j += kThreads) s_out[j] = gap;

      if (lane == 0) s_first[warp] = id[0];
      if (lane == 31) s_last[warp] = id[kItems - 1];
      __syncthreads();
      const int up = __shfl_up_sync(kFull, id[kItems - 1], 1);
      const int down = __shfl_down_sync(kFull, id[0], 1);
      const int before = lane > 0 ? up : (warp > 0 ? s_last[warp - 1] : e.prev);
      const int after = lane < 31 ? down
                                  : (warp < kWarps - 1 ? s_first[warp + 1] : e.next);
      bool bad = before > id[0];
      // the partial from the chunk's last run head (the tile's first
      // element always opens one)
      const bool head0 = tid == 0 || id[0] != before;
      int flag = head0;
      T agg = v[0];
#pragma unroll
      for (int i = 1; i < kItems; ++i) {
        bad |= id[i] < id[i - 1];
        if (id[i] != id[i - 1]) {
          flag = 1;
          agg = v[i];
        } else {
          agg = op<TAG>(agg, v[i]);
        }
      }
      // segmented inclusive scan of (flag, partial) across the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int f2 = __shfl_up_sync(kFull, flag, d);
        const T a2 = shfl_up(agg, d);
        if (lane >= d) {
          if (!flag) agg = op<TAG>(a2, agg);
          flag |= f2;
        }
      }
      const int eflag = __shfl_up_sync(kFull, flag, 1);
      const T eagg = shfl_up(agg, 1);
      if (lane == 31) {
        s_flag[warp] = flag;
        s_agg[warp] = agg;
      }
      __syncthreads();
      // the partial of the run open before this thread's first element:
      // the earlier warps in order, then the earlier lanes (thread 0 has
      // none: its first element is a head)
      T carry = ident;
      if (warp > 0) {
        carry = s_agg[0];
        for (int w = 1; w < warp; ++w)
          carry = s_flag[w] ? s_agg[w] : op<TAG>(carry, s_agg[w]);
      }
      if (lane > 0) carry = (warp == 0 || eflag) ? eagg : op<TAG>(carry, eagg);

      // this thread's elements inside the stream, and whether it holds the
      // tile's last one
      const long long rest = end - base;
      const int valid = rest <= 0 ? 0 : (rest >= kItems ? kItems : static_cast<int>(rest));
      const bool holds_end = base + kItems >= end;
      const long long wend = static_cast<long long>(A) + kWindow;
      T run = head0 ? v[0] : op<TAG>(carry, v[0]);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (i >= valid) break;
        if (i > 0) run = id[i] != id[i - 1] ? v[i] : op<TAG>(run, v[i]);
        const int x = id[i];
        const int nx = i + 1 < kItems ? id[i + 1] : after;
        const bool tile_last = holds_end && i == valid - 1;
        if (nx != x || tile_last) {          // the run ends here, or the tile
          if (static_cast<unsigned>(x) < static_cast<unsigned>(s)) {
            if (x == e.first || tile_last) {   // the tile's first or last run
              const bool from_left = x == e.first && e.prev == x;
              const bool to_right = tile_last && e.next == x;
              if (from_left) first_val[tile] = run;
              if (to_right) {
                last_val[tile] = run;
                if (!from_left)              // it starts here: list it
                  cross[atomicAdd(cross_count, 1)] =
                      make_int2(static_cast<int>(tile), x);
              }
              if (!from_left && !to_right) {
                if (static_cast<unsigned>(x - A) < kWindow) s_out[x - A] = finalize<TAG>(run);
                else out[x] = finalize<TAG>(run);
              }
            } else if (static_cast<unsigned>(x - A) < kWindow) {
              s_out[x - A] = finalize<TAG>(run);   // (x < A only if ids descend)
            } else {
              out[x] = finalize<TAG>(run);
            }
          }
          // the gap after the run, past the window
          if (nx > x + 1 && nx > wend) {
            const int lo = static_cast<int>(x + 1 > wend ? x + 1 : wend);
            const int hi = imin(nx, s);
            if (hi > lo) fill_gap(lo, hi, out, gap, gaps, gap_count, gap_cap);
          }
        }
      }
      if (tile == 0 && tid == 0 && e.first > wend)   // the head gap, past it
        fill_gap(static_cast<int>(wend), e.first, out, gap, gaps, gap_count,
                 gap_cap);
      if (bad) atomicOr(descent, 1);
      __syncthreads();
      for (int j = tid; j < wlen; j += kThreads) out[A + j] = s_out[j];
      __syncthreads();                       // shared memory is reused
    }
    __syncthreads();                         // before the next probe
  }
}

template <typename T, int TAG>
__global__ void __launch_bounds__(kThreads)
segreduce_sorted_carry(const int* __restrict__ ids, long long n, int s,
                       long long tiles, T* __restrict__ out, T ident, T gap,
                       const T* __restrict__ first_val,
                       const T* __restrict__ last_val,
                       const int2* __restrict__ cross,
                       const int* __restrict__ counts,
                       const int2* __restrict__ gaps, long long gap_cap) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  // each listed run: last_val of the tile where it starts, then first_val
  // of the tiles after it, 32 a step, in tile order, until it ends
  const long long runs = counts[1] < tiles ? counts[1] : tiles;
  for (long long p = warp; p < runs; p += warps) {
    const int2 c = cross[p];
    const long long t = c.x;
    const int x = c.y;
    T acc = last_val[t];
    for (long long u0 = t + 1;; u0 += 32) {
      const long long u = u0 + lane;
      bool ends = true;
      T v = ident;
      if (u < tiles) {
        const long long ue = (u + 1) * kTile < n ? (u + 1) * kTile : n;
        ends = !(ue < n && clamp_id(ids[ue - 1], s) == x &&
                 clamp_id(ids[ue], s) == x);
        v = first_val[u];
      }
      const unsigned m = __ballot_sync(kFull, ends);
      if (m != 0 && lane > __ffs(m) - 1) v = ident;   // past the run's end
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = op<TAG>(v, shfl_down(v, off));
      acc = op<TAG>(acc, shfl_idx(v, 0));
      if (m != 0) break;
    }
    if (lane == 0) out[x] = finalize<TAG>(acc);
  }
  // the long gaps, a piece a warp
  const long long pieces = counts[0] < gap_cap ? counts[0] : gap_cap;
  for (long long p = warp; p < pieces; p += warps) {
    const int2 g = gaps[p];
    for (int j = lane; j < g.y; j += 32) out[static_cast<long long>(g.x) + j] = gap;
  }
}

// Scratch: first_val and last_val (one value a tile), the crossing runs
// (one a tile at most), the counters of gap pieces and crossing runs, the
// gap pieces. Gaps longer than kSmallGap are disjoint in [0, S), so there
// are at most min(N + 1, S / (kSmallGap + 1)) of them, in at most that many
// plus S / kGapChunk pieces.
struct Layout {
  long long tiles, gap_cap, last_off, cross_off, count_off, gaps_off, bytes;
};

inline Layout layout(long long n, long long s, long long item) {
  auto up16 = [](long long x) { return (x + 15) / 16 * 16; };
  Layout L;
  L.tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  const long long long_gaps = s / (kSmallGap + 1) < n + 1 ? s / (kSmallGap + 1)
                                                           : n + 1;
  L.gap_cap = long_gaps + s / kGapChunk + 1;
  L.last_off = up16(L.tiles * item);
  L.cross_off = L.last_off + up16(L.tiles * item);
  L.count_off = L.cross_off + up16(L.tiles * static_cast<long long>(sizeof(int2)));
  L.gaps_off = L.count_off + 16;
  L.bytes = L.gaps_off + L.gap_cap * static_cast<long long>(sizeof(int2));
  return L;
}

template <typename T, int TAG>
int launch(const void* values, const int* ids, long long n, int s, void* out,
           char* scratch, const Layout& L, T ident, T gap, int* descent,
           cudaStream_t st) {
  // one wave of tile blocks (their count a device attribute, read once)
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segreduce_sorted_tiles<T, TAG>, kThreads, 0);
    wave = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  T* o = static_cast<T*>(out);
  T* first_val = reinterpret_cast<T*>(scratch);
  T* last_val = reinterpret_cast<T*>(scratch + L.last_off);
  int2* cross = reinterpret_cast<int2*>(scratch + L.cross_off);
  int* counts = reinterpret_cast<int*>(scratch + L.count_off);
  int2* gaps = reinterpret_cast<int2*>(scratch + L.gaps_off);
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(values) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(ids) % 16 == 0);
  const long long grid = L.tiles < wave ? L.tiles : wave;
  segreduce_sorted_tiles<T, TAG><<<static_cast<unsigned>(grid), kThreads, 0,
                                   st>>>(
      static_cast<const T*>(values), ids, n, s, L.tiles, o, ident, gap,
      first_val, last_val, cross, counts, gaps, L.gap_cap, descent, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // warps for the crossing runs (at most one a tile) and the gap pieces
  const long long work = L.tiles > L.gap_cap ? L.tiles : L.gap_cap;
  long long blocks = (work + kWarps - 1) / kWarps;
  if (blocks > kMaxCarryBlocks) blocks = kMaxCarryBlocks;
  segreduce_sorted_carry<T, TAG><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   st>>>(
      ids, n, s, L.tiles, o, ident, gap, first_val, last_val, cross, counts,
      gaps, L.gap_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tag(int tag, const void* values, const int* ids, long long n, int s,
               void* out, char* scratch, const Layout& L, const void* ident,
               const void* gap, int* descent, cudaStream_t st) {
  const T id = *static_cast<const T*>(ident);
  const T g = *static_cast<const T*>(gap);
  switch (tag) {
    case kSum:
      return launch<T, kSum>(values, ids, n, s, out, scratch, L, id, g, descent, st);
    case kMin:
      return launch<T, kMin>(values, ids, n, s, out, scratch, L, id, g, descent, st);
    case kMax:
      return launch<T, kMax>(values, ids, n, s, out, scratch, L, id, g, descent, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline long long item_size(int dtype) {
  switch (dtype) {
    case kF32: case kI32: return 4;
    case kF64: case kI64: return 8;
    case kBool: return 1;
    default: return 0;
  }
}

}  // namespace sorted_route

// Bytes of scratch the sorted route needs for n elements onto s segments of
// dtype (0 for an unknown dtype).
extern "C" long long segreduce_sorted_scratch_bytes(long long n, long long s,
                                                     int dtype) {
  const long long item = sorted_route::item_size(dtype);
  return item ? sorted_route::layout(n, s, item).bytes : 0;
}

// values: n scalars; ids: n int32, non-decreasing once clamped to [-1, S];
// out: num_segments values; scratch: segreduce_sorted_scratch_bytes(...)
// bytes, 16-byte aligned; ident: the combine's neutral element (0 for sum,
// the dtype extreme for min/max); gap: the value of untouched slots; descent:
// a device int that is set to 1 when the ids are seen to descend. A bool sum
// is launched as max (a logical or).
extern "C" int segreduce_sorted_launch(const void* values, const void* ids,
                                       long long n, long long num_segments,
                                       void* out, void* scratch, int tag,
                                       int dtype, const void* ident,
                                       const void* gap, void* descent,
                                       void* stream) {
  using namespace sorted_route;
  if (num_segments <= 0) return 0;
  if (num_segments > 0x7ffffffeLL || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long item = item_size(dtype);
  if (item == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(n, num_segments, item);
  const int* id = static_cast<const int*>(ids);
  const int s = static_cast<int>(num_segments);
  char* sc = static_cast<char*>(scratch);
  int* d = static_cast<int*>(descent);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_tag<float>(tag, values, id, n, s, out, sc, L, ident, gap, d, st);
    case kF64:
      return launch_tag<double>(tag, values, id, n, s, out, sc, L, ident, gap, d, st);
    case kI32:
      return launch_tag<int>(tag, values, id, n, s, out, sc, L, ident, gap, d, st);
    case kI64:
      return launch_tag<long long>(tag, values, id, n, s, out, sc, L, ident, gap, d, st);
    case kBool:                             // a bool sum is a logical or
      return launch_tag<unsigned char>(tag == kSum ? kMax : tag, values, id, n,
                                       s, out, sc, L, ident, gap, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
