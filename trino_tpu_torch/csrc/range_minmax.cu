// W3 range_minmax: running min or max over prefix window frames of sorted
// rows.
//
// Replaces: trino_tpu/exec/window.py:_range_minmax (:464) and
// _range_minmax_limbs (:486), the window min/max (window.py:372-380),
// which the frame checks restrict to frames starting UNBOUNDED PRECEDING:
// a segmented running min/max by partition id, read at hi-1; an empty
// frame (hi <= lo) gives the fill (window.py:_fill_for, :517). TPC-DS q51's
// two `max(...) over (... rows between unbounded preceding and current
// row)` over decimal(38,2) run the limb form.
//
// Values arrive contribution-masked: rows that do not contribute hold the
// fill, the reduction's identity (+inf / the type's max for min, -inf /
// min for max). Floats reduce as jnp.minimum/jnp.maximum: a NaN propagates
// (fmin/fmax would drop it), and -0.0 is below +0.0, which makes the
// result independent of the order of the reduction (as K9 seg_minmax).
// The limb form compares (hi signed, lo canonical in [0, 2^32))
// lexicographically, which is the numeric order of a decimal(38).
//
// Bound on an H100 (3.35 TB/s): values in, results out, gid, lo and hi
// once: q51 at SF10 (~5.5M rows of two limbs) ~0.3 GB, ~0.1 ms. Bytes bound
// it.
//
// Design: the three seg_scan passes (seg_scan.cuh) into a scratch scan,
// then one thread per row gathers the scan at hi-1.
#include <cuda_runtime.h>

#include <cstring>

#include "common.cuh"
#include "seg_scan.cuh"

namespace {

using ttk::THREADS;

// type code of the limb form (beside ColType's I64 and F64)
constexpr int T_LIMBS = 100;

struct Limb {
  long long h, l;
};

struct MinMaxI64 {
  using T = long long;
  T fill;
  int is_min;
  __device__ __forceinline__ T identity() const { return fill; }
  __device__ __forceinline__ T operator()(T a, T b) const {
    return is_min ? (b < a ? b : a) : (b > a ? b : a);
  }
};

struct MinMaxF64 {
  using T = double;
  T fill;
  int is_min;
  __device__ __forceinline__ T identity() const { return fill; }
  __device__ __forceinline__ T operator()(T a, T b) const {
    if (a != a) return a;
    if (b != b) return b;
    if (a == b) {  // equal values: only the sign of zero can differ
      const bool b_neg = signbit(b);
      return (is_min ? b_neg : !b_neg) ? b : a;
    }
    return is_min ? (b < a ? b : a) : (b > a ? b : a);
  }
};

struct MinMaxLimb {
  using T = Limb;
  T fill;
  int is_min;
  __device__ __forceinline__ T identity() const { return fill; }
  __device__ __forceinline__ T operator()(T a, T b) const {
    const bool a_better =
        is_min ? (a.h < b.h || (a.h == b.h && a.l < b.l))
               : (a.h > b.h || (a.h == b.h && a.l > b.l));
    return a_better ? a : b;
  }
};

template <typename T>
__global__ void frame_last(const T* scan, const long long* lo,
                           const long long* hi, long long n, T fill, T* out) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const long long h = hi[p];
    out[p] = h > lo[p] ? scan[h - 1] : fill;
  }
}

template <typename Op>
int run(const Op& op, const void* vals, const long long* gid,
        const long long* lo, const long long* hi, long long n, int* tile_f,
        void* tile_v, void* scan, void* out, cudaStream_t s) {
  using T = typename Op::T;
  if (n > 0) {
    ttk::seg_scan(op, (const T*)vals, gid, n, tile_f, (T*)tile_v, (T*)scan, s);
    const long long blocks = (n + THREADS - 1) / THREADS;
    const unsigned int grid = (unsigned int)(blocks < 132 * 32 ? blocks : 132 * 32);
    frame_last<T><<<grid, THREADS, 0, s>>>((const T*)scan, lo, hi, n, op.fill,
                                          (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vals: [n] int64 or float64, or [n, 2] int64 limbs (type 100), contiguous
// and contribution-masked; gid: [n] non-decreasing partition ids; lo, hi:
// [n] frame bounds (lo at the partition start). fill_hi: the fill's bits
// (int64, or the double's bits), fill_lo: the limb form's lo fill. out:
// like vals. Scratch: tile_f (ceil(n / 2048) int32), tile_v
// (ceil(n / 2048) values), scan (like vals). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for another type.
extern "C" int range_minmax_launch(const void* vals, long long type,
                                   const void* gid, const void* lo,
                                   const void* hi, long long n,
                                   long long fill_hi, long long fill_lo,
                                   long long is_min, void* tile_f,
                                   void* tile_v, void* scan, void* out,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long* g = (const long long*)gid;
  const long long* l = (const long long*)lo;
  const long long* h = (const long long*)hi;
  switch ((int)type) {
    case ttk::T_I64: {
      const MinMaxI64 op{fill_hi, (int)is_min};
      return run(op, vals, g, l, h, n, (int*)tile_f, tile_v, scan, out, s);
    }
    case ttk::T_F64: {
      double fill;
      memcpy(&fill, &fill_hi, sizeof(fill));
      const MinMaxF64 op{fill, (int)is_min};
      return run(op, vals, g, l, h, n, (int*)tile_f, tile_v, scan, out, s);
    }
    case T_LIMBS: {
      const MinMaxLimb op{Limb{fill_hi, fill_lo}, (int)is_min};
      return run(op, vals, g, l, h, n, (int*)tile_f, tile_v, scan, out, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
