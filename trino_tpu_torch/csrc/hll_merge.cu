// A4 hll_merge: the FINAL combine of approx_distinct's partial states.
//
// Replaces: trino_tpu/exec/aggregates.py:_hll_merge (:503).
//
// out[g, r] = max(states[i, r]) over the contributing partial rows i of
// group g (a non-contributing row counts as 0; the output starts at 0,
// and registers are never negative). Partial rows are few per group (one
// per chunk), and arrive in their original order.
//
// Design: one thread per (partial row, 4-register word), in original row
// order: consecutive threads read consecutive words of a row, so every
// state is read once, coalesced, with no gather through the FINAL's
// group permutation. The update is A1's skip-after-read compare-and-swap
// (csrc/hll.cu), on the whole 32-bit word at once: __vmaxs4 takes the
// four byte maxima, the thread reads the output word first and stops
// when it already dominates, and only a word that grows is CAS'd. Max is
// order-free, so the result is exact whatever order the CASes land in.
// Chosen over a CAS-free pass over the FINAL's sorted group runs because
// it needs no permutation, serves the global form (one [1, m] row) with
// the same kernel, and stays cheap when one group holds every partial
// row: once that group's words saturate, the other rows' threads end
// after one read that the L2 serves.
//
// Bound on an H100 (3.35 TB/s): the states (m B a row), contrib (1 B)
// and the group id (8 B) read once, the registers written once: 900K
// partial rows x 512 into 180K x 512 ~ 0.46 GB + 92 MB ~ 0.17 ms.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

constexpr int ITEMS = 4;

__global__ void hll_merge_kernel(const unsigned int* states,
                                 const unsigned char* contrib,
                                 const long long* group, long long n,
                                 long long words, long long caps,
                                 unsigned int* out) {
  const long long total = n * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / words;
    if (!contrib[row]) continue;
    const unsigned int v = states[t];
    if (v == 0u) continue;
    long long g = group == nullptr ? 0 : group[row];
    g = g < 0 ? 0 : (g >= caps ? caps - 1 : g);
    unsigned int* dst = out + g * words + (t - row * words);
    unsigned int old = *((volatile unsigned int*)dst);
    while (true) {
      const unsigned int nw = __vmaxs4(old, v);
      if (nw == old) break;
      const unsigned int seen = atomicCAS(dst, old, nw);
      if (seen == old) break;
      old = seen;
    }
  }
}

}  // namespace

// states: int8[n, m] (m a multiple of 4, rows 4-byte aligned); contrib:
// [n] bool; group: [n] int64 group ids (clipped into [0, caps)) or null
// (every row in group 0); out: int8[caps, m], zero on entry. Returns
// cudaGetLastError().
extern "C" int hll_merge_launch(const void* states, const void* contrib,
                                const void* group, long long n, long long m,
                                long long caps, void* out, void* stream) {
  if (n <= 0 || caps <= 0 || m <= 0) return (int)cudaGetLastError();
  const long long words = m / 4;
  unsigned int blocks = ttk::blocks_for(n * words, THREADS * ITEMS);
  if (blocks == 0) blocks = 1;
  hll_merge_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned int*)states, (const unsigned char*)contrib,
      (const long long*)group, n, words, caps, (unsigned int*)out);
  return (int)cudaGetLastError();
}
