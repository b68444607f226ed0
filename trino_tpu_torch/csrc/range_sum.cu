// W2 range_sum: per-row sums over window frames [lo, hi) of sorted rows,
// one or more value lanes in one launch.
//
// Replaces: trino_tpu/exec/window.py:_range_sum (:429), which every window
// count, sum and avg runs through (window.py:288-371): a float64 lane by a
// segmented scan with the partition check at lo-1 (:438-461), int64 lanes
// (counts, short decimals, and the hi and lo limbs of a decimal(38)
// argument, whose carry the caller folds as s_hi + (s_lo >> 32),
// s_lo & 0xFFFFFFFF, window.py:309-314) by a cumsum difference.
//
// Per lane: cs = the segmented inclusive scan of the values by partition
// id (seg_scan.cuh); out[p] = cs[hi-1] - cs[lo-1], where the cs[lo-1] term
// counts only when lo > 0 and row lo-1 lies in p's partition; an empty
// frame (hi <= lo) gives 0. Integer lanes add in unsigned 64-bit, so they
// wrap as the JAX package's int64 cumsum does and equal its global cumsum
// difference exactly. Float lanes never add across a partition boundary,
// so a small partition keeps its precision beside a huge one
// (tests/test_window_setops.py::test_window_float_sum_cross_partition_precision);
// their order of addition differs from jax.lax.associative_scan's.
//
// Bound on an H100 (3.35 TB/s): per lane the values (8 B) in and the sums
// (8 B) out, plus gid, lo and hi (24 B) once: for ds_range7 at SF10
// (28.8M rows, a count lane and a sum lane) ~1.7 GB, ~0.5 ms. Bytes bound
// it; the design reads the values twice and gathers cs at lo-1 and hi-1.
//
// Design: per lane the three seg_scan passes into a scratch cs, then one
// thread per row gathers the frame's two ends.
#include <cuda_runtime.h>

#include "common.cuh"
#include "seg_scan.cuh"

namespace {

using ttk::THREADS;
using ttk::u64;
constexpr int MAX_LANES = 8;

struct SumF64 {
  using T = double;
  __device__ __forceinline__ T identity() const { return 0.0; }
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

struct SumU64 {
  using T = u64;
  __device__ __forceinline__ T identity() const { return 0ull; }
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

template <typename T>
__global__ void frame_sum(const T* cs, const long long* gid,
                          const long long* lo, const long long* hi,
                          long long n, T* out) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const long long l = lo[p], h = hi[p];
    T r = T(0);
    if (h > l) {
      r = cs[h - 1];
      if (l > 0 && gid[l - 1] == gid[p]) r = r - cs[l - 1];
    }
    out[p] = r;
  }
}

template <typename Op>
void lane(const void* vals, void* out, const long long* gid,
          const long long* lo, const long long* hi, long long n, int* tile_f,
          void* tile_v, void* cs, cudaStream_t s) {
  using T = typename Op::T;
  ttk::seg_scan(Op{}, (const T*)vals, gid, n, tile_f, (T*)tile_v, (T*)cs, s);
  const long long blocks = (n + THREADS - 1) / THREADS;
  const unsigned int grid = (unsigned int)(blocks < 132 * 32 ? blocks : 132 * 32);
  frame_sum<T><<<grid, THREADS, 0, s>>>((const T*)cs, gid, lo, hi, n, (T*)out);
}

}  // namespace

// desc: k rows of 3 int64s on the host: values pointer ([n], contiguous),
// type (ColType: I64 or F64), output pointer ([n], same type). gid: [n]
// non-decreasing partition ids of the sorted rows; lo, hi: [n] frame
// bounds, each clipped to its row's partition. Scratch: tile_f
// (ceil(n / 2048) int32), tile_v (ceil(n / 2048) x 8 B), cs ([n] x 8 B),
// shared by the lanes, which run one after another on the stream.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for k outside
// [1, MAX_LANES] or a lane of another type.
extern "C" int range_sum_launch(const long long* desc, long long k,
                                const void* gid, const void* lo,
                                const void* hi, long long n, void* tile_f,
                                void* tile_v, void* cs, void* stream) {
  if (k < 1 || k > MAX_LANES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (long long j = 0; j < k; ++j) {
    const int type = (int)desc[3 * j + 1];
    if (type != ttk::T_I64 && type != ttk::T_F64) return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  for (long long j = 0; j < k; ++j) {
    const void* vals = (const void*)desc[3 * j];
    void* out = (void*)desc[3 * j + 2];
    if ((int)desc[3 * j + 1] == ttk::T_F64) {
      lane<SumF64>(vals, out, (const long long*)gid, (const long long*)lo,
                   (const long long*)hi, n, (int*)tile_f, tile_v, cs, s);
    } else {
      lane<SumU64>(vals, out, (const long long*)gid, (const long long*)lo,
                   (const long long*)hi, n, (int*)tile_f, tile_v, cs, s);
    }
  }
  return (int)cudaGetLastError();
}
