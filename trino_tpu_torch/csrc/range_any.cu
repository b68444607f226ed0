// K5 range_any: per-probe "any live expanded match in my range".
//
// Replaces: trino_tpu/exec/kernels.py:range_any (:489). Probe row p owns
// the expanded positions [off[p], off[p] + cnt[p]), off being the
// exclusive prefix sum of cnt, both ends clamped to out_live's length m;
// matched[p] = any(out_live over that range). Semi joins (after the
// residual filter) and the probe-unmatched rows of LEFT/FULL joins read
// it.
//
// Bound on an H100 (3.35 TB/s): it must read cnt (8 B/probe row), write
// matched (1 B/probe row) and read out_live (1 B/position) up to the
// first live position of each range: a range whose first position is
// live needs one byte. The offsets the kernel also reads (8 B/probe
// row) are the wrapper's intermediate.
//
// Design: the JAX version takes two prefix sums over out_live, a full
// pass the card does not need. The exclusive prefix sum of cnt stays a
// torch cumsum outside the kernel (as for K4). Then
//   1. one thread per probe row scans the first `short_len` bytes of its
//      range (64, set by the wrapper) and stops at the first live one.
//      On TPC-H (1-7 lines per order) every range fits, and neighbouring
//      threads read neighbouring bytes. A row whose range is longer and
//      whose head is dead appends itself to a list (an atomic counter);
//   2. a fixed grid of blocks walks that list. Each long range is cut
//      into CHUNK-byte chunks that all blocks share, read as 16-byte
//      vectors, so one hot key owning millions of positions spreads over
//      the whole card instead of stalling one thread. A block stops a
//      range as soon as any block has marked it.
// Ranges never overlap, so at most m / short_len + 1 rows reach the list.
#include <cuda_runtime.h>

#include <stdint.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

constexpr long long CHUNK = 16384;  // bytes of one long range per block step

__device__ __forceinline__ long long min_ll(long long a, long long b) {
  return a < b ? a : b;
}

__global__ void short_pass(const long long* cnt, const long long* offsets,
                           long long n, const unsigned char* live, long long m,
                           long long short_len, unsigned char* matched,
                           long long* long_rows, long long long_cap,
                           unsigned long long* n_long) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long off = offsets[i];
  const long long lo = min_ll(off, m);
  const long long hi = min_ll(off + cnt[i], m);
  const long long end = min_ll(hi, lo + short_len);
  unsigned char any = 0;
  for (long long j = lo; j < end; ++j) {
    if (live[j]) {
      any = 1;
      break;
    }
  }
  if (!any && hi - lo > short_len) {
    const unsigned long long slot = atomicAdd(n_long, 1ull);
    if ((long long)slot < long_cap) long_rows[slot] = i;
  }
  matched[i] = any;
}

// Does any byte of live[a, b) hold a non-zero value? Each thread of the
// block reads its share: the 16-byte-aligned interior as uint4 vectors,
// the ragged ends byte by byte. Returns the block-wide answer.
__device__ __forceinline__ int block_range_any(const unsigned char* live,
                                               long long a, long long b) {
  const uintptr_t base = (uintptr_t)live;
  long long va = a + (long long)((16 - ((base + a) & 15)) & 15);
  long long vb = b - (long long)((base + b) & 15);
  if (va > b) va = b;
  if (vb < va) vb = va;
  int found = 0;
  for (long long j = a + threadIdx.x; j < va; j += THREADS) found |= live[j];
  for (long long j = vb + threadIdx.x; j < b; j += THREADS) found |= live[j];
  const uint4* vec = (const uint4*)(live + va);
  const long long nvec = (vb - va) / 16;
  for (long long k = threadIdx.x; k < nvec; k += THREADS) {
    const uint4 v = vec[k];
    found |= (v.x | v.y | v.z | v.w) != 0u;
  }
  return __syncthreads_or(found);
}

__global__ void long_pass(const long long* cnt, const long long* offsets,
                          const unsigned char* live, long long m,
                          long long short_len, unsigned char* matched,
                          const long long* long_rows, long long long_cap,
                          const unsigned long long* n_long) {
  const long long rows = min_ll((long long)*n_long, long_cap);
  for (long long r = 0; r < rows; ++r) {
    const long long p = long_rows[r];
    const long long off = offsets[p];
    // the short pass already read the first short_len bytes
    const long long lo = min_ll(off, m) + short_len;
    const long long hi = min_ll(off + cnt[p], m);
    const long long chunks = (hi - lo + CHUNK - 1) / CHUNK;
    for (long long k = blockIdx.x; k < chunks; k += gridDim.x) {
      // a block that finds the row marked by another block stops
      const int done =
          __syncthreads_or(*(volatile const unsigned char*)(matched + p));
      if (done) break;
      const long long a = lo + k * CHUNK;
      if (block_range_any(live, a, min_ll(a + CHUNK, hi))) {
        if (threadIdx.x == 0) matched[p] = 1;
        break;
      }
    }
  }
}

}  // namespace

// cnt, offsets (exclusive prefix sum of cnt): [n] int64; out_live: [m]
// bool; short_len >= 1. Outputs matched: [n] bool. Scratch: long_rows
// [long_cap] int64 (long_cap >= min(n, m / short_len + 1)) and n_long [1]
// int64, zeroed by the caller. Returns cudaGetLastError().
extern "C" int range_any_launch(const void* cnt, const void* offsets,
                                long long n, const void* out_live, long long m,
                                long long short_len, void* matched,
                                void* long_rows, long long long_cap,
                                void* n_long, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  short_pass<<<ttk::blocks_for(n, THREADS), THREADS, 0, s>>>(
      (const long long*)cnt, (const long long*)offsets, n,
      (const unsigned char*)out_live, m, short_len, (unsigned char*)matched,
      (long long*)long_rows, long_cap, (unsigned long long*)n_long);
  int err = (int)cudaGetLastError();
  if (err != 0 || m <= short_len) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned int grid = (unsigned int)(sms > 0 ? 4 * sms : 512);
  long_pass<<<grid, THREADS, 0, s>>>(
      (const long long*)cnt, (const long long*)offsets,
      (const unsigned char*)out_live, m, short_len, (unsigned char*)matched,
      (const long long*)long_rows, long_cap,
      (const unsigned long long*)n_long);
  return (int)cudaGetLastError();
}
