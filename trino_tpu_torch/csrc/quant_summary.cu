// A5 quant_summary: approx_percentile's PARTIAL state, k evenly spaced
// order statistics per group and a count lane.
//
// Replaces: trino_tpu/exec/aggregates.py:_quant_summary (:527), after
// _quant_sorted_perm (:515), whose three stable sorts stay torch.sort.
//
// One thread per (group, lane): lane i < k reads sorted position
// starts[g] + off of p, off = clip(rint((i + 0.5) / k * cnt - 0.5), 0,
// max(cnt - 1, 0)), and writes that row's value as float64; lane k
// writes cnt. The offset arithmetic, the two-level gather vd[p[.]] and
// the count lane are one pass.
//
// Exactness against the plain version (torch.round, numpy's round): the
// rounding is half to even, so rint, not round (which CUDA rounds half
// away from zero); (i + 0.5) / k * cnt - 0.5 lands on x.5 for many
// counts. The product and the difference are __dmul_rn and __dsub_rn so
// that nvcc cannot contract them into one fused multiply-add, which
// would round once where the plain version rounds twice. int64 values
// convert with __ll2double_rn, as numpy and torch do.
//
// Bound on an H100 (3.35 TB/s): starts and cnt (16 B a group) and, per
// point, p (8 B) and the value (8 B) read once; the summary written once:
// 180K groups x 257 lanes ~ 0.74 GB ~ 0.22 ms.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

__global__ void quant_summary_kernel(const void* vd, int is_f64,
                                     const long long* p, long long n,
                                     const long long* starts,
                                     const long long* cnt, long long caps,
                                     long long k, double* out) {
  const long long lanes = k + 1;
  const long long total = caps * lanes;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const double kd = (double)k;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long g = t / lanes;
    const long long i = t - g * lanes;
    const long long c = cnt[g];
    if (i == k) {
      out[t] = __ll2double_rn(c);
      continue;
    }
    if (n == 0) {
      out[t] = 0.0;
      continue;
    }
    const double frac = __ddiv_rn((double)i + 0.5, kd);
    double x = rint(__dsub_rn(__dmul_rn(frac, __ll2double_rn(c)), 0.5));
    const double hi = __ll2double_rn(c - 1 > 0 ? c - 1 : 0);
    x = x < 0.0 ? 0.0 : x;
    x = x > hi ? hi : x;
    long long at = starts[g] + (long long)x;
    at = at < 0 ? 0 : (at > n - 1 ? n - 1 : at);
    const long long row = p[at];
    out[t] = is_f64 ? ((const double*)vd)[row]
                    : __ll2double_rn(((const long long*)vd)[row]);
  }
}

}  // namespace

// vd: [n] int64 (is_f64 0) or float64 (is_f64 1) values in original row
// order; p: [n] int64 sorted order; starts, cnt: [caps] int64; out:
// float64[caps, k + 1]. Returns cudaGetLastError().
extern "C" int quant_summary_launch(const void* vd, long long is_f64,
                                    const void* p, long long n,
                                    const void* starts, const void* cnt,
                                    long long caps, long long k, void* out,
                                    void* stream) {
  const long long total = caps * (k + 1);
  if (total > 0) {
    unsigned int blocks = ttk::blocks_for(total, THREADS * 4);
    quant_summary_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        vd, (int)is_f64, (const long long*)p, n, (const long long*)starts,
        (const long long*)cnt, caps, k, (double*)out);
  }
  return (int)cudaGetLastError();
}
