// K1 group_ids: dense group ids and group ranges from key-sorted rows.
//
// Replaces: trino_tpu/exec/kernels.py:sort_group, the pass after the sort
// (:243-263): boundary flags -> cumsum -> gid_sorted (clamped to
// capacity), the inverse permutation, starts/ends by searchsorted, owner
// and num_groups; and the per-row representative flag of
// trino_tpu/exec/stage.py:_dedupe (:504), owner[group[i]] == i for a live
// row i, written as `rep` in the pass that writes group when the caller
// asks for it (a DISTINCT's dedupe does; a GROUP BY does not pay for the
// second scattered store). The packing of
// the keys is K8 pack_words; the stable sort stays torch.sort, as the JAX
// package leaves lax.sort to XLA.
//
// Bound on an H100 (3.35 TB/s): per row it must read the sorted word or
// the `same` flag (8 or 1 B), live_s (1 B) and perm (8 B) and write
// gid_sorted and group (8 B each) and rep (1 B, when asked for), plus
// 3 x 8 B per capacity slot: about 33-34 B/row, so ~0.06 ms at 6M rows and ~0.6 ms at
// 60M rows. Bytes, not operations, bound it.
//
// Design: a two-level scan. Pass 1 gives each block a tile of
// THREADS*ITEMS rows, marks boundaries, scans them within the block and
// writes the tile's running count plus the tile total. Pass 2 (one
// block) turns tile totals into tile offsets and num_groups. Pass 3
// adds the offset, writes gid_sorted, scatters group[perm[p]] (the
// inverse permutation of a sort is a plain scatter here, not a second
// sort), marks the row at each group's first position as its
// representative and records that position. Pass 4 runs over the
// capacity slots: unused slots start at n_live, ends are the next
// start, owner is perm[start]. Ids are int64 (the port's index type).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
constexpr int ITEMS = 8;
constexpr long long TILE = (long long)THREADS * ITEMS;

__device__ __forceinline__ int boundary(long long p, const long long* words,
                                        const unsigned char* same,
                                        const unsigned char* live) {
  if (!live[p]) return 0;
  if (p == 0) return 1;
  if (words != nullptr) return words[p] != words[p - 1] ? 1 : 0;
  return same[p] ? 0 : 1;
}

__global__ void tile_scan(const long long* words, const unsigned char* same,
                          const unsigned char* live, long long n,
                          long long* gid1, long long* tile_sums) {
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  int flags[ITEMS];
  long long local = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = base + i;
    flags[i] = p < n ? boundary(p, words, same, live) : 0;
    local += flags[i];
  }
  long long total;
  const long long incl = ttk::block_inclusive_scan<long long>(local, &total);
  long long run = incl - local;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = base + i;
    run += flags[i];
    if (p < n) gid1[p] = run;
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: exclusive scan of the tile totals in place; num_groups.
__global__ void scan_tiles(long long* tile_sums, long long num_tiles,
                           long long* num_groups) {
  long long carry = 0;
  for (long long c = 0; c < num_tiles; c += THREADS) {
    const long long i = c + threadIdx.x;
    const long long v = i < num_tiles ? tile_sums[i] : 0;
    long long total;
    const long long incl = ttk::block_inclusive_scan<long long>(v, &total);
    if (i < num_tiles) tile_sums[i] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) *num_groups = carry;
}

__device__ __forceinline__ long long gid_at(long long q, const long long* gid1,
                                            const long long* tile_off,
                                            const unsigned char* live,
                                            long long capacity) {
  if (!live[q]) return capacity;
  const long long g = gid1[q] + tile_off[q / TILE] - 1;
  return g < capacity ? g : capacity;
}

__global__ void assign(const long long* gid1, const long long* tile_off,
                       const unsigned char* live, const long long* perm,
                       long long n, long long capacity, long long* gid_sorted,
                       long long* group, unsigned char* rep, long long* starts,
                       long long* n_live) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  const long long g = gid_at(p, gid1, tile_off, live, capacity);
  gid_sorted[p] = g;
  const long long row = perm[p];
  group[row] = g;
  const long long prev = p > 0 ? gid_at(p - 1, gid1, tile_off, live, capacity) : -1;
  // the representative of a group is the row at its first sorted position
  if (rep != nullptr) rep[row] = (g != prev && g < capacity) ? 1 : 0;
  if (g != prev) {
    // gid_sorted is non-decreasing: each id < capacity starts once, and
    // the first position at capacity (dead or overflow rows) is unique
    if (g < capacity) {
      starts[g] = p;
    } else {
      *n_live = p;
    }
  }
}

__global__ void slots(long long* starts, long long* ends, long long* owner,
                      const long long* perm, const long long* num_groups,
                      const long long* n_live, long long n, long long capacity) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= capacity) return;
  const long long ng = *num_groups;
  const long long used = ng < capacity ? ng : capacity;
  const long long nl = *n_live;
  const long long s = g < used ? starts[g] : nl;
  const long long e = (g + 1 < used) ? starts[g + 1] : nl;
  long long at = s < 0 ? 0 : s;
  if (at > n - 1) at = n - 1 < 0 ? 0 : n - 1;
  owner[g] = (g < ng && n > 0) ? perm[at] : n;
  ends[g] = e;
  starts[g] = s;
}

}  // namespace

// words: sorted packed key words (or null, then `same` flags are read);
// live: live_s flags in sorted order; perm: the sort permutation.
// Scratch: gid1 [n], tile_sums [ceil(n / TILE)]. Outputs: gid_sorted [n],
// group [n], rep [n] (bool; null when not wanted), starts/ends/owner
// [capacity], num_groups [1], n_live [1] (n_live must hold n on entry).
// Returns cudaGetLastError().
extern "C" int group_ids_launch(const void* words, const void* same,
                                const void* live, const void* perm, long long n,
                                long long capacity, void* gid1, void* tile_sums,
                                void* gid_sorted, void* group, void* rep,
                                void* starts,
                                void* ends, void* owner, void* num_groups,
                                void* n_live, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long num_tiles = (n + TILE - 1) / TILE;
  if (n > 0) {
    tile_scan<<<(unsigned int)num_tiles, THREADS, 0, s>>>(
        (const long long*)words, (const unsigned char*)same,
        (const unsigned char*)live, n, (long long*)gid1, (long long*)tile_sums);
  }
  scan_tiles<<<1, THREADS, 0, s>>>((long long*)tile_sums, num_tiles,
                                   (long long*)num_groups);
  if (n > 0) {
    assign<<<ttk::blocks_for(n, THREADS), THREADS, 0, s>>>(
        (const long long*)gid1, (const long long*)tile_sums,
        (const unsigned char*)live, (const long long*)perm, n, capacity,
        (long long*)gid_sorted, (long long*)group, (unsigned char*)rep,
        (long long*)starts, (long long*)n_live);
  }
  if (capacity > 0) {
    slots<<<ttk::blocks_for(capacity, THREADS), THREADS, 0, s>>>(
        (long long*)starts, (long long*)ends, (long long*)owner,
        (const long long*)perm, (const long long*)num_groups,
        (const long long*)n_live, n, capacity);
  }
  return (int)cudaGetLastError();
}
