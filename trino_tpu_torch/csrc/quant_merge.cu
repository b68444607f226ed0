// A6 quant_merge: the FINAL combine of approx_percentile's summaries.
//
// Replaces: trino_tpu/exec/aggregates.py:_quant_merge (:555). Its sorts
// (the n * k points by value bits, then stably by group) stay torch.sort
// in the wrapper; this kernel is everything after them.
//
// Each partial row's k points weigh w = cnt / k when the row contributes
// and its count is positive, else 0. One warp per group scans the
// group's run [seg_lo, seg_hi) of the sorted points twice: first for the
// group's total weight, then, 32 points at a time (a warp inclusive
// scan), for the first point whose running weight reaches
// q * total - 1e-9 and whose own weight is positive. It writes the value
// there (the last point of all when there is none, as the plain
// version's clip), and has = total > 0.
//
// Exactness: k is a power of two (256 grouped, 1024 global), so every
// weight cnt / k is a dyadic rational that float64 holds exactly, and so
// is every sum of them while the total count stays below 2^53 / k. The
// warp's running sums therefore equal the plain version's global cumsum
// minus each group's base bit for bit, in any order of addition. The
// target's product and difference are __dmul_rn and __dsub_rn, so nvcc
// cannot fuse them into one rounding.
//
// Bound on an H100 (3.35 TB/s): the sorted order p (8 B a point), each
// partial row's count lane and flag, the picked value and the outputs:
// 900K rows x 256 points ~ 1.85 GB ~ 0.55 ms.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

__device__ __forceinline__ double weight(const double* states, long long k,
                                         const unsigned char* eff,
                                         long long row) {
  if (!eff[row]) return 0.0;
  const double c = states[row * (k + 1) + k];
  return c > 0.0 ? __ddiv_rn(c, (double)k) : 0.0;
}

__global__ void quant_merge_kernel(const double* states, long long k,
                                   long long n, const unsigned char* eff,
                                   const long long* p, const long long* seg_lo,
                                   const long long* seg_hi, long long caps,
                                   const double* q, double* out,
                                   unsigned char* has) {
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= caps) return;  // uniform across the warp
  const long long lo = seg_lo[g];
  const long long hi = seg_hi[g];
  const long long nk = n * k;
  double total = 0.0;
  for (long long j = lo + lane; j < hi; j += 32) {
    total += weight(states, k, eff, p[j] / k);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, d);
  }
  const double target = __dsub_rn(__dmul_rn(q[0], total), 1e-9);
  long long first = nk;
  double run = 0.0;
  for (long long base = lo; base < hi; base += 32) {
    const long long j = base + lane;
    const double w = j < hi ? weight(states, k, eff, p[j] / k) : 0.0;
    double s = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += t;
    }
    const bool reached = j < hi && w > 0.0 && run + s >= target;
    const unsigned int ballot = __ballot_sync(0xffffffffu, reached);
    if (ballot != 0u) {
      first = base + __ffs(ballot) - 1;
      break;
    }
    run += __shfl_sync(0xffffffffu, s, 31);
  }
  if (lane == 0) {
    const long long at = first > nk - 1 ? nk - 1 : first;
    const long long flat = p[at];
    const long long row = flat / k;
    out[g] = states[row * (k + 1) + (flat - row * k)];
    has[g] = total > 0.0;
  }
}

}  // namespace

// states: float64[n, k + 1] summaries (k points, then the count); eff:
// [n] bool; p: [n * k] int64 sorted order of the flat points (index
// row * k + i); seg_lo, seg_hi: [caps] int64 run of each group in p; q:
// one float64 on the device; out: [caps] float64; has: [caps] bool.
// Returns cudaGetLastError().
extern "C" int quant_merge_launch(const void* states, long long k,
                                  long long n, const void* eff, const void* p,
                                  const void* seg_lo, const void* seg_hi,
                                  long long caps, const void* q, void* out,
                                  void* has, void* stream) {
  if (caps > 0 && n > 0 && k > 0) {
    const long long threads = caps * 32;
    quant_merge_kernel<<<ttk::blocks_for(threads, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const double*)states, k, n, (const unsigned char*)eff,
        (const long long*)p, (const long long*)seg_lo,
        (const long long*)seg_hi, caps, (const double*)q, (double*)out,
        (unsigned char*)has);
  }
  return (int)cudaGetLastError();
}
