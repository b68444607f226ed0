// K3 join_probe: per-probe match range in the key-sorted build side.
//
// Replaces: trino_tpu/exec/kernels.py:join_ranges (:577), the part after
// the build sort: lo = left bound and hi = right bound of each probe key
// among the sorted build keys, both clamped to the live prefix of
// n_build_live rows, and cnt = hi - lo for live probe rows, 0 for dead
// ones. Keys are unsigned 64-bit (the JAX package's uint64 words); the
// torch side carries the same bits in int64 tensors.
//
// Bound on an H100 (3.35 TB/s): it must read each probe key and flag
// (9 B) and the build keys once (8 B/row) and write lo and cnt (16 B):
// ~25 B per probe row, ~0.5 ms for 60M probes against 15M build keys.
//
// Design: one thread per probe row, two binary searches over the live
// prefix only, so the dead tail needs no pinning to the maximum key
// (the JAX package pins it so that its searchsorted sees one sorted
// array; the clamped results are the same). The top levels of every
// search hit the same few keys and stay in L1/L2; the last levels are
// the random reads that bound it in practice.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

__global__ void probe(const unsigned long long* keys, const long long* n_build_live,
                      const unsigned long long* probe_keys,
                      const unsigned char* probe_live, long long n_probe,
                      long long* lo_out, long long* cnt_out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_probe) return;
  const long long m = *n_build_live;
  const unsigned long long k = probe_keys[i];
  long long a = 0, b = m;
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (keys[mid] < k) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const long long lo = a;
  b = m;
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (keys[mid] <= k) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  lo_out[i] = lo;
  cnt_out[i] = probe_live[i] ? a - lo : 0;
}

}  // namespace

// keys: [m] build keys in sorted order (live rows first); n_build_live: [1];
// probe_keys: [n]; probe_live: [n] bool. Outputs lo, cnt: [n] int64.
// Returns cudaGetLastError().
extern "C" int join_probe_launch(const void* keys, const void* n_build_live,
                                 const void* probe_keys, const void* probe_live,
                                 long long n_probe, void* lo, void* cnt,
                                 void* stream) {
  if (n_probe > 0) {
    probe<<<ttk::blocks_for(n_probe, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)keys, (const long long*)n_build_live,
        (const unsigned long long*)probe_keys, (const unsigned char*)probe_live,
        n_probe, (long long*)lo, (long long*)cnt);
  }
  return (int)cudaGetLastError();
}
