// M2 segment_reduce: scatter reductions (sum, min, max) of values by group
// id into num_segments slots; ids outside [0, num_segments) are dropped.
//
// Replaces: trino_tpu/exec/kernels.py:seg_sum (:650), seg_min (:656) and
// seg_max (:662), jax.ops.segment_* into num_segments + 1 slots with the
// last one cut. Callers: the distributed group-by's PARTIAL and FINAL
// (trino_tpu/parallel/groupby.py:34, :54), the mesh's per-destination
// histogram (trino_tpu/exec/mesh.py:_dest_counts, :1054) and the
// single-chip q1_step (__graft_entry__.py:42).
//
// Semantics held to XLA:CPU's: an empty slot holds the identity (0 for a
// sum; the dtype's maximum, +inf for float64, for a min; the minimum,
// -inf, for a max). int64 sums wrap mod 2^64 (an unsigned atomicAdd, so
// the order of the adds does not matter). float64 sums add in whatever
// order the atomics land: relative 1e-12 against any other order. int64
// min/max are signed 64-bit atomicMin/atomicMax. float64 min/max run the
// same atomics on a total-order key of the bits (negative values with
// every bit but the sign flipped), under which -0.0 < +0.0; a NaN maps to
// the key that wins (the least for a min, the greatest for a max), so a
// NaN in a slot makes it NaN, as XLA's min/max propagate NaN; a last pass
// turns the keys back into doubles (every NaN the canonical quiet NaN).
//
// Bound on an H100 (3.35 TB/s): values and ids read once and the slots
// written once: 60M int64 values with int64 ids into 16 slots is 960 MB,
// ~0.29 ms. Bytes bound it, unless atomics on few addresses serialize:
// for num_segments up to SMEM_SEGS each warp of a block accumulates into
// its own copy of the slots in shared memory, and the block adds its
// copies into the global slots once at the end, so 60M rows on 16 slots
// cost one global atomic per block and slot. More slots go straight to
// global atomics (1.5M slots spread the contention).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::WARPS;
constexpr int SMEM_SEGS = 2048;
constexpr unsigned int MAX_GRID = 132 * 16;
constexpr long long I64_MAX = 0x7FFFFFFFFFFFFFFFll;
constexpr long long I64_MIN = -I64_MAX - 1;

enum Op : int { SUM = 0, MIN = 1, MAX = 2 };

// float64 bits -> signed total-order key (an involution on non-NaN bits)
__device__ __forceinline__ long long order_key(long long b) {
  return b >= 0 ? b : (b ^ I64_MAX);
}

template <typename V, int OP>
struct Red;

template <>
struct Red<long long, SUM> {
  typedef long long Acc;
  __device__ static Acc identity() { return 0; }
  __device__ static Acc load(const long long* v, long long i) { return v[i]; }
  __device__ static void atomic(Acc* at, Acc x) {
    atomicAdd((unsigned long long*)at, (unsigned long long)x);
  }
};

template <int OP>
struct IntMinMax {
  typedef long long Acc;
  __device__ static Acc identity() { return OP == MIN ? I64_MAX : I64_MIN; }
  __device__ static Acc load(const long long* v, long long i) { return v[i]; }
  __device__ static void atomic(Acc* at, Acc x) {
    if (OP == MIN) {
      atomicMin(at, x);
    } else {
      atomicMax(at, x);
    }
  }
};

template <>
struct Red<long long, MIN> : IntMinMax<MIN> {};
template <>
struct Red<long long, MAX> : IntMinMax<MAX> {};

template <>
struct Red<double, SUM> {
  typedef double Acc;
  __device__ static Acc identity() { return 0.0; }
  __device__ static Acc load(const double* v, long long i) { return v[i]; }
  __device__ static void atomic(Acc* at, Acc x) { atomicAdd(at, x); }
};

// float64 min/max accumulate order keys (long long)
template <int OP>
struct FloatMinMax {
  typedef long long Acc;
  __device__ static Acc identity() {
    // key of +inf for a min, of -inf for a max
    return OP == MIN ? 0x7FF0000000000000ll
                     : order_key((long long)0xFFF0000000000000ull);
  }
  __device__ static Acc load(const double* v, long long i) {
    const double x = v[i];
    if (x != x) return OP == MIN ? I64_MIN : I64_MAX;
    return order_key(__double_as_longlong(x));
  }
  __device__ static void atomic(Acc* at, Acc x) {
    if (OP == MIN) {
      atomicMin(at, x);
    } else {
      atomicMax(at, x);
    }
  }
};

template <>
struct Red<double, MIN> : FloatMinMax<MIN> {};
template <>
struct Red<double, MAX> : FloatMinMax<MAX> {};

template <typename V, typename G, int OP>
__global__ void reduce_smem(const V* vals, const G* group, long long n,
                            long long n_seg, typename Red<V, OP>::Acc* out) {
  typedef Red<V, OP> R;
  typedef typename R::Acc Acc;
  extern __shared__ unsigned char smem_raw[];
  Acc* acc = (Acc*)smem_raw;  // [WARPS][n_seg]
  const long long slots = (long long)WARPS * n_seg;
  for (long long s = threadIdx.x; s < slots; s += THREADS) acc[s] = R::identity();
  __syncthreads();
  Acc* mine = acc + (long long)(threadIdx.x >> 5) * n_seg;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const long long g = (long long)group[i];
    if (g >= 0 && g < n_seg) R::atomic(&mine[g], R::load(vals, i));
  }
  __syncthreads();
  for (long long s = threadIdx.x; s < n_seg; s += THREADS) {
    Acc a = acc[s];
    bool touched = a != R::identity();
    for (int w = 1; w < WARPS; ++w) {
      const Acc b = acc[(long long)w * n_seg + s];
      if (b != R::identity()) {
        touched = true;
        if (OP == SUM) {
          a += b;
        } else if (OP == MIN) {
          a = b < a ? b : a;
        } else {
          a = b > a ? b : a;
        }
      }
    }
    if (touched) R::atomic(&out[s], a);
  }
}

template <typename V, typename G, int OP>
__global__ void reduce_global(const V* vals, const G* group, long long n,
                              long long n_seg, typename Red<V, OP>::Acc* out) {
  typedef Red<V, OP> R;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const long long g = (long long)group[i];
    if (g >= 0 && g < n_seg) R::atomic(&out[g], R::load(vals, i));
  }
}

template <typename Acc>
__global__ void fill_kernel(Acc* out, long long n_seg, Acc v) {
  for (long long s = (long long)blockIdx.x * THREADS + threadIdx.x; s < n_seg;
       s += (long long)gridDim.x * THREADS) {
    out[s] = v;
  }
}

// order keys back to doubles, in place
__global__ void unkey_kernel(long long* out, long long n_seg) {
  for (long long s = (long long)blockIdx.x * THREADS + threadIdx.x; s < n_seg;
       s += (long long)gridDim.x * THREADS) {
    const long long b = order_key(out[s]);
    const double x = __longlong_as_double(b);
    out[s] = x != x ? (long long)ttk::NAN64_BITS : b;
  }
}

template <typename V, typename G, int OP>
int launch(const void* vals, const void* group, long long n, long long n_seg,
           void* out, cudaStream_t s) {
  typedef Red<V, OP> R;
  typedef typename R::Acc Acc;
  if (n_seg <= 0) return (int)cudaGetLastError();
  const unsigned int fill_grid =
      ttk::blocks_for(n_seg, THREADS) < MAX_GRID ? ttk::blocks_for(n_seg, THREADS)
                                                 : MAX_GRID;
  Acc identity;
  if (OP == SUM) {
    identity = Acc(0);
  } else if (sizeof(V) == 8 && V(0.5) != V(0)) {  // float64 min/max keys
    identity = OP == MIN ? (Acc)0x7FF0000000000000ll
                         : (Acc)(0x800FFFFFFFFFFFFFull);
  } else {
    identity = OP == MIN ? (Acc)I64_MAX : (Acc)I64_MIN;
  }
  fill_kernel<Acc><<<fill_grid, THREADS, 0, s>>>((Acc*)out, n_seg, identity);
  if (n > 0) {
    const unsigned int blocks = ttk::blocks_for(n, THREADS);
    const unsigned int grid = blocks < MAX_GRID ? blocks : MAX_GRID;
    if (n_seg <= SMEM_SEGS) {
      const size_t bytes = (size_t)WARPS * n_seg * sizeof(Acc);
      if (bytes > 48 * 1024) {
        cudaFuncSetAttribute(reduce_smem<V, G, OP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
      }
      reduce_smem<V, G, OP><<<grid, THREADS, bytes, s>>>(
          (const V*)vals, (const G*)group, n, n_seg, (Acc*)out);
    } else {
      reduce_global<V, G, OP><<<grid, THREADS, 0, s>>>(
          (const V*)vals, (const G*)group, n, n_seg, (Acc*)out);
    }
  }
  if (OP != SUM && V(0.5) != V(0)) {
    unkey_kernel<<<fill_grid, THREADS, 0, s>>>((long long*)out, n_seg);
  }
  return (int)cudaGetLastError();
}

template <typename V, typename G>
int by_op(int op, const void* vals, const void* group, long long n,
          long long n_seg, void* out, cudaStream_t s) {
  switch (op) {
    case SUM: return launch<V, G, SUM>(vals, group, n, n_seg, out, s);
    case MIN: return launch<V, G, MIN>(vals, group, n, n_seg, out, s);
    case MAX: return launch<V, G, MAX>(vals, group, n, n_seg, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vals: [n] int64 (is_float 0) or float64 (is_float 1); group: [n] int32
// (wide_ids 0) or int64 (wide_ids 1) ids; op: 0 sum, 1 min, 2 max; out:
// [n_seg] of the values' dtype, written whole (no zero fill needed).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unknown op.
extern "C" int segment_reduce_launch(const void* vals, const void* group,
                                     long long n, long long n_seg,
                                     long long is_float, long long wide_ids,
                                     long long op, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int o = (int)op;
  if (is_float) {
    return wide_ids ? by_op<double, long long>(o, vals, group, n, n_seg, out, s)
                    : by_op<double, int>(o, vals, group, n, n_seg, out, s);
  }
  return wide_ids ? by_op<long long, long long>(o, vals, group, n, n_seg, out, s)
                  : by_op<long long, int>(o, vals, group, n, n_seg, out, s);
}
