// Segmented inclusive scans over rows grouped by a non-decreasing id (a
// window's sorted partition ids, where dead rows share one id at the
// end): the machinery that W2 range_sum and W3 range_minmax share.
//
// A row starts a segment when it is the first row or its id differs from
// the previous row's; the scan restarts there, so no value crosses from
// one partition into another (a float sum never adds a large neighbour's
// values and takes them away again).
//
// Three passes, as K1 runs its cumsum. Pass 1: each block reduces a tile
// of THREADS*SEG_ITEMS rows (each thread SEG_ITEMS consecutive rows) to
// (a segment starts in the tile, the value since the tile's last start).
// Pass 2: one block scans the tile aggregates into each tile's carry-in.
// Pass 3: each block rescans its tile from its carry and writes the
// running value of every row. Op supplies T, identity() and
// operator()(earlier, later), which must be associative.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace ttk {

constexpr int SEG_ITEMS = 8;
constexpr long long SEG_TILE = (long long)THREADS * SEG_ITEMS;

template <typename T>
struct Seg {
  int f;  // a segment starts inside: the value restarted there
  T v;
};

// (f_a, a) followed by (f_b, b)
template <typename Op>
struct SegOp {
  Op op;
  __device__ __forceinline__ Seg<typename Op::T> operator()(
      const Seg<typename Op::T>& a, const Seg<typename Op::T>& b) const {
    Seg<typename Op::T> r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : op(a.v, b.v);
    return r;
  }
};

__device__ __forceinline__ bool seg_head(const long long* gid, long long p) {
  return p == 0 || gid[p] != gid[p - 1];
}

// One thread's aggregate over its SEG_ITEMS rows from `base`.
template <typename Op>
__device__ __forceinline__ Seg<typename Op::T> seg_thread(
    const Op& op, const typename Op::T* vals, const long long* gid,
    long long n, long long base) {
  Seg<typename Op::T> a;
  a.f = 0;
  a.v = op.identity();
  for (int i = 0; i < SEG_ITEMS; ++i) {
    const long long p = base + i;
    if (p >= n) break;
    if (seg_head(gid, p)) {
      a.f = 1;
      a.v = vals[p];
    } else {
      a.v = op(a.v, vals[p]);
    }
  }
  return a;
}

template <typename Op>
__global__ void seg_tile_reduce(Op op, const typename Op::T* vals,
                                const long long* gid, long long n,
                                int* tile_f, typename Op::T* tile_v) {
  using T = typename Op::T;
  const long long base =
      (long long)blockIdx.x * SEG_TILE + (long long)threadIdx.x * SEG_ITEMS;
  Seg<T> a = seg_thread(op, vals, gid, n, base);
  Seg<T> excl, total;
  bool has;
  block_scan_op(a, SegOp<Op>{op}, false, &excl, &has, &total);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_v[blockIdx.x] = total.v;
  }
}

// One block: the tile aggregates in tile_v become each tile's carry-in
// (the running value at the end of the tiles before it), in place.
template <typename Op>
__global__ void seg_scan_tiles(Op op, const int* tile_f,
                               typename Op::T* tile_v, long long num_tiles) {
  using T = typename Op::T;
  const SegOp<Op> sop{op};
  Seg<T> carry;
  carry.f = 0;
  carry.v = op.identity();
  for (long long c = 0; c < num_tiles; c += THREADS) {
    const long long i = c + threadIdx.x;
    Seg<T> a;
    a.f = 0;
    a.v = op.identity();
    if (i < num_tiles) {
      a.f = tile_f[i];
      a.v = tile_v[i];
    }
    Seg<T> excl, total;
    bool has;
    block_scan_op(a, sop, false, &excl, &has, &total);
    const Seg<T> before = has ? sop(carry, excl) : carry;
    if (i < num_tiles) tile_v[i] = before.v;
    carry = sop(carry, total);
  }
}

template <typename Op>
__global__ void seg_tile_apply(Op op, const typename Op::T* vals,
                               const long long* gid, long long n,
                               const typename Op::T* tile_carry,
                               typename Op::T* out) {
  using T = typename Op::T;
  const SegOp<Op> sop{op};
  const long long base =
      (long long)blockIdx.x * SEG_TILE + (long long)threadIdx.x * SEG_ITEMS;
  Seg<T> a = seg_thread(op, vals, gid, n, base);
  Seg<T> excl, total;
  bool has;
  block_scan_op(a, sop, false, &excl, &has, &total);
  Seg<T> carry;
  carry.f = 1;
  carry.v = tile_carry[blockIdx.x];
  T run = (has ? sop(carry, excl) : carry).v;
  for (int i = 0; i < SEG_ITEMS; ++i) {
    const long long p = base + i;
    if (p >= n) break;
    run = seg_head(gid, p) ? vals[p] : op(run, vals[p]);
    out[p] = run;
  }
}

inline long long seg_tiles(long long n) { return (n + SEG_TILE - 1) / SEG_TILE; }

// out[p] = op-reduction of vals over [start of p's segment, p].
// Scratch: tile_f and tile_v, seg_tiles(n) entries each.
template <typename Op>
void seg_scan(const Op& op, const typename Op::T* vals, const long long* gid,
              long long n, int* tile_f, typename Op::T* tile_v,
              typename Op::T* out, cudaStream_t s) {
  if (n <= 0) return;
  const long long tiles = seg_tiles(n);
  seg_tile_reduce<Op><<<(unsigned int)tiles, THREADS, 0, s>>>(
      op, vals, gid, n, tile_f, tile_v);
  seg_scan_tiles<Op><<<1, THREADS, 0, s>>>(op, tile_f, tile_v, tiles);
  seg_tile_apply<Op><<<(unsigned int)tiles, THREADS, 0, s>>>(
      op, vals, gid, n, tile_v, out);
}

}  // namespace ttk
