// K9 seg_minmax: per-group min or max of group-sorted, contribution-masked
// values.
//
// Replaces: trino_tpu/exec/kernels.py:seg_minmax_scan (:384), driven by
// trino_tpu/exec/aggregates.py:_Reducer.minmax, including the decimal(38)
// limb path (hi limb, then lo limb among the rows at the extreme hi).
// Group g owns sorted positions [starts[g], ends[g]); rows past
// ends[capacity - 1] (dead or overflowed) are not read. Non-contributing
// rows carry the fill value (+inf/-inf, the type's max/min), which every
// reduction absorbs.
//
// Semantics of the reduction, as jnp.minimum/jnp.maximum on XLA: a NaN
// anywhere in a group makes the group's result NaN (CUDA's fmin/fmax
// would drop it), and -0.0 is below +0.0 (min of the two is -0.0, max is
// +0.0), which makes the result independent of the reduction order.
//
// Bound on an H100 (3.35 TB/s): each value read once, ends read and the
// results written once: 60M int64 rows in 4 groups ~ 60M x 8 B, ~0.15 ms.
//
// Design: as K2 seg_sum. One block per tile of THREADS*ITEMS rows; a tile
// inside one group reduces in the block (warp shuffles) and combines once;
// other tiles give each thread ITEMS consecutive rows that it walks group
// by group. Partial results combine into the output with atomics: native
// atomicMin/atomicMax for 32- and 64-bit integers, a compare-and-swap loop
// for floats (the NaN-propagating, sign-of-zero-aware min/max above).
// Narrow integers (int8, int16) accumulate in int32; the wrapper narrows.
#include <cuda_runtime.h>

#include <cstring>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::WARPS;
constexpr int ITEMS = 8;
constexpr long long TILE = (long long)THREADS * ITEMS;

// first g in [lo, hi] with ends[g] > row
__device__ __forceinline__ long long find_group(const long long* ends,
                                                long long lo, long long hi,
                                                long long row) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ends[mid] > row) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ T reduce(T a, T b, bool is_min) {
  return is_min ? (b < a ? b : a) : (b > a ? b : a);
}

template <typename F>
__device__ __forceinline__ F freduce(F a, F b, bool is_min) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) {  // equal values: only the sign of zero can differ
    const bool b_neg = signbit(b);
    return (is_min ? b_neg : !b_neg) ? b : a;
  }
  return is_min ? (b < a ? b : a) : (b > a ? b : a);
}

__device__ __forceinline__ double reduce(double a, double b, bool is_min) {
  return freduce(a, b, is_min);
}

__device__ __forceinline__ float reduce(float a, float b, bool is_min) {
  return freduce(a, b, is_min);
}

__device__ __forceinline__ void combine(int* at, int v, bool is_min) {
  if (is_min) {
    atomicMin(at, v);
  } else {
    atomicMax(at, v);
  }
}

__device__ __forceinline__ void combine(long long* at, long long v, bool is_min) {
  if (is_min) {
    atomicMin(at, v);
  } else {
    atomicMax(at, v);
  }
}

__device__ __forceinline__ void combine(double* at, double v, bool is_min) {
  unsigned long long* a = (unsigned long long*)at;
  unsigned long long old = *a;
  while (true) {
    const double cur = __longlong_as_double((long long)old);
    const double nv = freduce(cur, v, is_min);
    const unsigned long long nb = (unsigned long long)__double_as_longlong(nv);
    if (nb == old) return;
    const unsigned long long seen = atomicCAS(a, old, nb);
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void combine(float* at, float v, bool is_min) {
  unsigned int* a = (unsigned int*)at;
  unsigned int old = *a;
  while (true) {
    const float cur = __uint_as_float(old);
    const float nv = freduce(cur, v, is_min);
    const unsigned int nb = __float_as_uint(nv);
    if (nb == old) return;
    const unsigned int seen = atomicCAS(a, old, nb);
    if (seen == old) return;
    old = seen;
  }
}

// Block-wide reduction of one value per thread; valid in thread 0.
template <typename A>
__device__ __forceinline__ A block_reduce(A v, bool is_min) {
  __shared__ A warp_vals[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = reduce(v, (A)__shfl_down_sync(0xffffffffu, v, d), is_min);
  }
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_vals[lane < WARPS ? lane : 0];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      v = reduce(v, (A)__shfl_down_sync(0xffffffffu, v, d), is_min);
    }
  }
  return v;
}

// T: the value type read; A: the accumulator and output type.
template <typename T, typename A>
__global__ void seg_minmax_kernel(const T* vals, const long long* ends,
                                  long long capacity, A fill, int is_min_i,
                                  A* out) {
  __shared__ long long s_g0, s_g1;
  const bool is_min = is_min_i != 0;
  const long long n_end = ends[capacity - 1];
  const long long t0 = (long long)blockIdx.x * TILE;
  if (t0 >= n_end) return;  // uniform across the block
  const long long t1 = t0 + TILE < n_end ? t0 + TILE : n_end;
  if (threadIdx.x == 0) {
    s_g0 = find_group(ends, 0, capacity - 1, t0);
    s_g1 = find_group(ends, s_g0, capacity - 1, t1 - 1);
  }
  __syncthreads();
  const long long g0 = s_g0, g1 = s_g1;
  if (g0 == g1) {
    A acc = fill;
    for (long long p = t0 + threadIdx.x; p < t1; p += THREADS) {
      acc = reduce(acc, (A)vals[p], is_min);
    }
    acc = block_reduce<A>(acc, is_min);
    if (threadIdx.x == 0) combine(&out[g0], acc, is_min);
    return;
  }
  long long p = t0 + (long long)threadIdx.x * ITEMS;
  const long long pend = p + ITEMS < t1 ? p + ITEMS : t1;
  if (p >= pend) return;
  long long g = find_group(ends, g0, g1, p);
  A acc = fill;
  for (; p < pend; ++p) {
    if (ends[g] <= p) {
      combine(&out[g], acc, is_min);
      acc = fill;
      do {
        ++g;
      } while (ends[g] <= p);
    }
    acc = reduce(acc, (A)vals[p], is_min);
  }
  combine(&out[g], acc, is_min);
}

template <typename T, typename A>
int launch(const void* vals, const void* ends, long long n, long long capacity,
           A fill, long long is_min, void* out, void* stream) {
  if (n > 0 && capacity > 0) {
    seg_minmax_kernel<T, A><<<ttk::blocks_for(n, (int)TILE), THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const T*)vals, (const long long*)ends, capacity, fill, (int)is_min,
        (A*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vals: [n] group-sorted values (non-contributing rows hold the fill);
// ends: [capacity] group ends (group 0 starts at 0, each group at the
// previous one's end); out: [capacity] of the accumulator type, holding
// the fill on entry (empty groups keep it). type: ColType of vals (I64,
// I32, I16, I8, F64, F32); fill_bits: the fill value's bits in the
// accumulator type (int64 for I64, int32 for the narrower integers,
// double and float bits for F64 and F32). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported type.
extern "C" int seg_minmax_launch(const void* vals, const void* ends,
                                 long long type, long long n,
                                 long long capacity, long long fill_bits,
                                 long long is_min, void* out, void* stream) {
  switch (type) {
    case ttk::T_I64:
      return launch<long long, long long>(vals, ends, n, capacity, fill_bits,
                                          is_min, out, stream);
    case ttk::T_I32:
      return launch<int, int>(vals, ends, n, capacity, (int)fill_bits,
                              is_min, out, stream);
    case ttk::T_I16:
      return launch<short, int>(vals, ends, n, capacity, (int)fill_bits,
                                is_min, out, stream);
    case ttk::T_I8:
      return launch<signed char, int>(vals, ends, n, capacity, (int)fill_bits,
                                      is_min, out, stream);
    case ttk::T_F64: {
      double fill;
      memcpy(&fill, &fill_bits, sizeof(fill));
      return launch<double, double>(vals, ends, n, capacity, fill, is_min,
                                    out, stream);
    }
    case ttk::T_F32: {
      const unsigned int b = (unsigned int)fill_bits;
      float fill;
      memcpy(&fill, &b, sizeof(fill));
      return launch<float, float>(vals, ends, n, capacity, fill, is_min, out,
                                  stream);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
