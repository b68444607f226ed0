// W4 seg_searchsorted: per-row binary search of a target inside the row's
// own sorted partition.
//
// Replaces: trino_tpu/exec/window.py:_seg_searchsorted (:412), which turns
// RANGE frames with offsets (`range between 6 preceding and current row`)
// into positions (window.py:226-262): for row i, the first position q in
// [lo0[i], hi0[i]) with w[q] >= target[i] (`left`) or w[q] > target[i],
// hi0[i] when there is none. w is the direction-normalized ORDER BY key in
// sorted order (negated for DESC, INT64_MIN wrapping as in the JAX
// package; NULL keys hold the sentinel of window.py:149-150) and target is
// w plus the scaled offset. The JAX package runs a fixed log2(n) steps of
// the same bisection over the whole page; stopping when lo meets hi gives
// the same position.
//
// Bound on an H100 (3.35 TB/s): w, target, lo0 and hi0 read once and the
// positions written once: 28.8M rows (ds_range7 at SF10) x 40 B ~1.15 GB,
// ~0.34 ms. The kernel makes ~log2(partition rows) dependent random reads
// of w per row (about 18-25 here, as K3 does), so latency, not bytes,
// holds it above the bound.
//
// Design: one thread per row in a grid-stride loop.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

template <typename T>
__global__ void seg_search(const T* w, const T* target, const long long* lo0,
                           const long long* hi0, long long n, int left,
                           long long* out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long lo = lo0[i], hi = hi0[i];
    const T t = target[i];
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      const T vm = w[mid];
      const bool go = left ? (vm < t) : (vm <= t);
      if (go) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[i] = lo;
  }
}

}  // namespace

// w, target: [n] int64 or float64 (type: ColType I64 or F64); lo0, hi0:
// [n] int64 search ranges inside [0, n); left: 1 for the first position
// with w >= target, 0 for the first with w > target; out: [n] int64.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another type.
extern "C" int seg_searchsorted_launch(const void* w, const void* target,
                                       long long type, const void* lo0,
                                       const void* hi0, long long n,
                                       long long left, void* out,
                                       void* stream) {
  if (type != ttk::T_I64 && type != ttk::T_F64) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    const unsigned int grid = (unsigned int)(blocks < 132 * 32 ? blocks : 132 * 32);
    cudaStream_t s = (cudaStream_t)stream;
    if (type == ttk::T_I64) {
      seg_search<long long><<<grid, THREADS, 0, s>>>(
          (const long long*)w, (const long long*)target, (const long long*)lo0,
          (const long long*)hi0, n, (int)left, (long long*)out);
    } else {
      seg_search<double><<<grid, THREADS, 0, s>>>(
          (const double*)w, (const double*)target, (const long long*)lo0,
          (const long long*)hi0, n, (int)left, (long long*)out);
    }
  }
  return (int)cudaGetLastError();
}
