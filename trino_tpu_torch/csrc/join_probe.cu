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
// What holds a probe back is latency, not bytes: two full binary
// searches over 7.5M live keys are ~46 dependent reads, most of them
// random 32-byte sectors of HBM, each waiting on the last.
//
// Design: a key-range directory, then a short search inside one bucket.
// 1. `directory` (one thread per entry): B = 2^log_b entries, a power of
//    two, one per 8 to 16 build rows, sized on the host from the capacity
//    m, positions in int32 while m < 2^31 (at m = 15M: 2^20 entries, 4
//    MB, well inside the 50 MB L2; these bytes are not in the bound
//    above). A bucket's few keys still share a sector or two, and on an
//    H100 this size probed faster than one entry per build row (2^23).
//    kmin = keys[0], kmax = keys[n_live - 1] and the shift that maps
//    [kmin, kmax] onto [0, B) by (k - kmin) >> shift are read and
//    computed on the device by every thread, so the wrapper never syncs.
//    dir[b] is the first live position whose key's bucket is >= b, the
//    lower bound of kmin + (b << shift); dir[B] = n_live. Neighbouring
//    threads search neighbouring targets, so a warp's searches share
//    their path down to the last few levels and hit L1/L2.
// 2. `probe` (one thread per probe row): a key below kmin gives lo = 0, a
//    key above kmax lo = n_live, both with no match. Otherwise the
//    bucket b is monotone in the key, so every key of a bucket below b
//    is smaller and every key of a bucket above b larger: both bounds
//    lie in [dir[b], dir[b + 1]]. lo is a binary search in that span,
//    hi a gallop from lo (1, 2, 4, ... GALLOP steps, then bisection), not
//    a second full search. Per probe: two adjacent directory entries
//    (L2) and one or two key sectors (HBM), not ~46 dependent reads.
//
// A key distribution that defeats the directory (one outlier key far
// above a dense range puts the range into bucket 0; one hot key fills
// its own bucket) only widens the span: the searches stay exact, since
// the span is a superset of the answer, and cost at most one binary
// search over the live keys plus GALLOP steps, what the old design paid
// for its two searches, plus the directory pass. There is no fallback.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::u64;

// galloping steps from lo before hi is found by bisection
constexpr int GALLOP = 6;

// Right shift that maps [0, range] onto [0, 2^log_b).
__device__ __forceinline__ int shift_for(u64 range, int log_b) {
  const int bits = range ? 64 - __clzll((long long)range) : 0;
  return bits > log_b ? bits - log_b : 0;
}

// First position in [a, b) whose key is >= k (b if none).
__device__ __forceinline__ long long lower_bound(const u64* __restrict__ keys,
                                                 long long a, long long b, u64 k) {
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (keys[mid] < k) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

// First position in [lo, e] whose key is > k, given that every key in
// [lo, e) is >= k and every key from e on is > k.
__device__ __forceinline__ long long upper_from(const u64* __restrict__ keys,
                                               long long lo, long long e, u64 k) {
  if (lo == e || keys[lo] != k) return lo;
  long long a = lo + 1, b = e;  // keys before a are k, keys from b on > k
  long long step = 1;
#pragma unroll 1
  for (int s = 0; s < GALLOP; ++s) {
    const long long at = lo + step;
    if (at >= b) break;
    if (keys[at] != k) {
      b = at;
      break;
    }
    a = at + 1;
    step <<= 1;
  }
  while (a < b) {
    const long long mid = (a + b) >> 1;
    if (keys[mid] == k) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

template <typename Pos>
__global__ void directory(const u64* __restrict__ keys,
                          const long long* __restrict__ n_build_live, int log_b,
                          Pos* __restrict__ dir) {
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nb = 1ll << log_b;
  if (b > nb) return;
  const long long nl = *n_build_live;
  if (nl == 0) {
    dir[b] = 0;
    return;
  }
  const u64 kmin = keys[0];
  const u64 range = keys[nl - 1] - kmin;
  const int shift = shift_for(range, log_b);
  // b < nb: b << shift < 2^(log_b + shift) <= 2^64, no overflow
  if (b == nb || ((u64)b << shift) > range) {
    dir[b] = (Pos)nl;
    return;
  }
  dir[b] = (Pos)lower_bound(keys, 0, nl, kmin + ((u64)b << shift));
}

template <typename Pos>
__global__ void probe(const u64* __restrict__ keys,
                      const long long* __restrict__ n_build_live,
                      const Pos* __restrict__ dir, int log_b,
                      const u64* __restrict__ probe_keys,
                      const unsigned char* __restrict__ probe_live,
                      long long n_probe, long long* __restrict__ lo_out,
                      long long* __restrict__ cnt_out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_probe) return;
  const long long nl = *n_build_live;
  const u64 k = probe_keys[i];
  long long lo = 0, hi = 0;
  if (nl > 0) {
    const u64 kmin = keys[0];
    const u64 kmax = keys[nl - 1];
    if (k > kmax) {
      lo = hi = nl;
    } else if (k >= kmin) {
      const long long b = (long long)((k - kmin) >> shift_for(kmax - kmin, log_b));
      lo = lower_bound(keys, (long long)dir[b], (long long)dir[b + 1], k);
      hi = upper_from(keys, lo, (long long)dir[b + 1], k);
    }
  }
  lo_out[i] = lo;
  cnt_out[i] = probe_live[i] ? hi - lo : 0;
}

template <typename Pos>
void run(const void* keys, const void* n_build_live, const void* probe_keys,
         const void* probe_live, long long n_probe, int log_b, void* dir,
         void* lo, void* cnt, cudaStream_t s) {
  const long long entries = (1ll << log_b) + 1;
  directory<Pos><<<ttk::blocks_for(entries, THREADS), THREADS, 0, s>>>(
      (const u64*)keys, (const long long*)n_build_live, log_b, (Pos*)dir);
  if (n_probe > 0) {
    probe<Pos><<<ttk::blocks_for(n_probe, THREADS), THREADS, 0, s>>>(
        (const u64*)keys, (const long long*)n_build_live, (const Pos*)dir,
        log_b, (const u64*)probe_keys, (const unsigned char*)probe_live,
        n_probe, (long long*)lo, (long long*)cnt);
  }
}

}  // namespace

// keys: [m] build keys in sorted order (live rows first); n_build_live: [1];
// probe_keys: [n]; probe_live: [n] bool. Scratch: dir [2^log_b + 1],
// int64 when wide_dir, else int32 (1 <= log_b <= 62). Outputs lo, cnt:
// [n] int64. Returns cudaGetLastError().
extern "C" int join_probe_launch(const void* keys, const void* n_build_live,
                                 const void* probe_keys, const void* probe_live,
                                 long long n_probe, long long log_b, void* dir,
                                 long long wide_dir, void* lo, void* cnt,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wide_dir) {
    run<long long>(keys, n_build_live, probe_keys, probe_live, n_probe,
                   (int)log_b, dir, lo, cnt, s);
  } else {
    run<int>(keys, n_build_live, probe_keys, probe_live, n_probe, (int)log_b,
             dir, lo, cnt, s);
  }
  return (int)cudaGetLastError();
}
