// Segmented semiring reduce for Hopper (sm_90a).
//
// Replaces repro/kernels/segreduce.py::segment_reduce_pallas, the TPU kernel
// that keeps an output tile resident in VMEM and sweeps the input past it.
// Here the design is the simplest one that is right for ANY id order:
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
// Cost on the card: bound by memory. A sum over scalars reads 8 B per input
// (value + id) and writes 4 B per segment (out): at N = S = 2^24 about
// 0.201 GB, ~60 us at 3.35 TB/s; a min/max with a touch count adds 4 B per
// segment. Sorted ids put equal ids in one warp, so the atomics of a run
// serialise on one address; a segmented warp-level reduce for sorted ids,
// with no atomics, is the next step for speed.
//
// C interface (bound with ctypes): segreduce_launch returns
// cudaGetLastError() after both launches, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

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
