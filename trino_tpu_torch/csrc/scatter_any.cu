// K6 scatter_any: per-slot "any flagged index lands here".
//
// Replaces: trino_tpu/exec/kernels.py:scatter_any (:502). For b in
// [0, capacity): out[b] = any(flags[j] for idx[j] == b). FULL joins read
// it with idx = the expansion's build rows and flags = the live matches,
// to find the build rows no probe row matched.
//
// Bound on an H100 (3.35 TB/s): it must read flags (1 B/position), idx
// (8 B) only where the flag is set, and write out (1 B/slot).
//
// Design: the JAX version sorts the flagged indices and probes every
// slot with a binary search, because scatters are slow on a TPU. On the
// card a scatter of idempotent byte stores is the whole job: the
// wrapper zero-fills out, then one thread per position stores 1 at
// out[idx[j]] where flags[j] is set. Racing stores all write the same
// value, so no atomics are needed. idx is read only under a set flag:
// dead expansion positions carry clamped placeholders. Indices outside
// [0, capacity) mark nothing, as in the JAX version.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

__global__ void mark(const long long* idx, const unsigned char* flags,
                     long long m, long long capacity, unsigned char* out) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= m || !flags[j]) return;
  const long long b = idx[j];
  if (b >= 0 && b < capacity) out[b] = 1;
}

}  // namespace

// idx: [m] int64, flags: [m] bool; out: [capacity] bool, zero-filled by
// the caller. Returns cudaGetLastError().
extern "C" int scatter_any_launch(const void* idx, const void* flags,
                                  long long m, long long capacity, void* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m > 0 && capacity > 0) {
    mark<<<ttk::blocks_for(m, THREADS), THREADS, 0, s>>>(
        (const long long*)idx, (const unsigned char*)flags, m, capacity,
        (unsigned char*)out);
  }
  return (int)cudaGetLastError();
}
