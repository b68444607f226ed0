// K4 expand_matches: expand per-probe match ranges into output pairs.
//
// Replaces: trino_tpu/exec/kernels.py:expand_matches (:620). Output
// position j < total belongs to the probe row whose range covers it;
// probe_idx[j] is that row and build_idx[j] = order[lo + (j - offset)].
// out_live[j] = j < total. Positions past total are dead; their indices
// are set to in-range placeholders (the JAX package leaves them
// arbitrary too, and callers read them only under out_live).
//
// Bound on an H100 (3.35 TB/s): it must read lo, cnt and the offsets
// (24 B/probe row) and write probe_idx, build_idx and out_live
// (17 B/output), plus one gather from `order` (8 B) per match.
//
// Design: the exclusive prefix sum of cnt is a torch cumsum outside the
// kernel (as jnp.cumsum is outside in the JAX package). Then one thread
// per probe row writes its cnt pairs at its offset, so no output
// position does a binary search over the offsets; a second grid over
// the output capacity writes out_live and the dead tail. On Q3 every
// count is 0 or 1 (key-foreign-key joins), so a thread per row, not a
// warp, is the right grain.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;

__global__ void pairs(const long long* order, const long long* lo,
                      const long long* cnt, const long long* offsets,
                      long long n_probe, long long out_cap, long long* probe_idx,
                      long long* build_idx) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_probe) return;
  const long long c = cnt[i];
  const long long off = offsets[i];
  const long long l = lo[i];
  for (long long k = 0; k < c && off + k < out_cap; ++k) {
    probe_idx[off + k] = i;
    build_idx[off + k] = order[l + k];
  }
}

__global__ void tail(const long long* total, long long n_probe, long long out_cap,
                     long long* probe_idx, long long* build_idx,
                     unsigned char* out_live) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= out_cap) return;
  const bool live = j < *total;
  out_live[j] = live ? 1 : 0;
  if (!live) {
    probe_idx[j] = n_probe > 0 ? n_probe - 1 : 0;
    build_idx[j] = 0;
  }
}

}  // namespace

// order: [m] sorted build row ids; lo, cnt, offsets (exclusive prefix sum
// of cnt): [n]; total: [1]. Outputs probe_idx, build_idx: [out_cap] int64,
// out_live: [out_cap] bool. Returns cudaGetLastError().
extern "C" int expand_matches_launch(const void* order, const void* lo,
                                     const void* cnt, const void* offsets,
                                     const void* total, long long n_probe,
                                     long long out_cap, void* probe_idx,
                                     void* build_idx, void* out_live,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (out_cap > 0) {
    tail<<<ttk::blocks_for(out_cap, THREADS), THREADS, 0, s>>>(
        (const long long*)total, n_probe, out_cap, (long long*)probe_idx,
        (long long*)build_idx, (unsigned char*)out_live);
  }
  if (n_probe > 0 && out_cap > 0) {
    pairs<<<ttk::blocks_for(n_probe, THREADS), THREADS, 0, s>>>(
        (const long long*)order, (const long long*)lo, (const long long*)cnt,
        (const long long*)offsets, n_probe, out_cap, (long long*)probe_idx,
        (long long*)build_idx);
  }
  return (int)cudaGetLastError();
}
