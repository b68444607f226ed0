// A6 quant_merge: the FINAL combine of approx_percentile's summaries.
//
// Replaces: trino_tpu/exec/aggregates.py:_quant_merge (:555), the whole
// pick after the partial rows are grouped: the JAX package's two stable
// sorts of the n * k points (by value bits, then by group), its cumsum
// and its searchsorted. The wrapper orders the n partial rows (not the
// points) by group with one stable torch.sort, which keeps each group's
// rows in row order, and takes each group's row range from a bincount.
//
// Each point of partial row r weighs w = cnt[r] / k when eff[r] holds and
// cnt[r] > 0, else 0. In a group, the points are ordered by
// (order bits of the value, flat index r * k + i); the group answers the
// first point in that order whose running weight reaches
// t = q * total - 1e-9 and whose own weight is positive, that is the
// least key among the positive-weight points whose weight at or below it
// reaches t. With no such point (no positive weight, or t above the
// total, or t NaN) it answers the last point of the whole order, as the
// plain version's clip does: the largest (group, bits, flat index) over
// every row of the largest group present. has = total > 0.
//
// Exactness: k is a power of two and the counts are integers (a count
// lane) with k * (sum of counts) below 2^53, so every weight is cnt units
// of 1 / k and every sum of weights is an integer number of units, held
// exactly in a u64 here and exactly as a float64 by the plain version's
// cumsum, in any order of addition. The kernel sums units and compares
// W / k (exact: a power-of-two scale) with t, computed as the plain
// version computes it: __dmul_rn then __dsub_rn, so nvcc cannot fuse
// them into one rounding. So its picks equal the plain version's bit for
// bit. The design relies on this: a radix select sums the weights of a
// digit's points in whatever order the atomics land.
//
// Bound on an H100 (3.35 TB/s): the summaries read once (8 B a point and
// a count), the flags and group ids of the rows, a value and a flag
// written per group: 900K rows x 257 x 8 B ~ 1.85 GB ~ 0.55 ms.
//
// Design: one block of THREADS threads per group.
// 1. `last_point` (one block) finds the last point of the whole order
//    first: the argmax of (bits, flat index) over the rows of the group
//    of the last sorted row.
// 2. `merge_groups`: a group whose rows * k points fit in cap_pts has
//    warp 0 list its positive-weight rows in row order (a ballot per 32
//    rows) and stages their points' keys (the monotone u64 form of
//    order_bits) in dynamic shared memory, LOADS reads in flight a
//    thread; a larger group reads its points from device memory on
//    every pass (the same code over another source) and skips the rows
//    of no weight. On an H100 that costs a group about twice staging
//    it, and staging room beyond what a group needs costs blocks an SM,
//    so the wrapper sizes cap_pts to the rows of 99% of the groups, and
//    the launch clamps it to what a block's shared memory holds. One block reduction gives the AND
//    and OR of the positive points' keys and the group's total units. A
//    weighted radix select then fixes the key 8 bits at a time from the
//    highest bit that varies among those points to the lowest: each
//    pass builds a histogram of units (and of points) over the digit of
//    the points still matching the chosen prefix, in shared memory with
//    32-bit atomics (units as a low word plus carries into a high
//    word); lanes of a warp hold consecutive points of one row (equal
//    weights), and a run of equal digits adds once. Warp 0 then scans
//    the 256 bins for the first whose cumulative units reach t and
//    clears them: two barriers a pass. Ties on the bits are broken by
//    the point's place p in the group's rows (flat index order), digits
//    of p after those of the bits. A pass whose chosen bin holds one
//    point ends the select.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::u64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
// Bin b lives at b + b / 8, so that a lane reading 8 consecutive bins
// meets no bank conflict.
constexpr int PADDED_BINS = BINS + BINS / 8;
constexpr int LOADS = 8;  // point reads a thread has in flight when staging
constexpr unsigned FULL = 0xffffffffu;
// Holds `merge_groups` to 48 registers a thread, ten blocks an SM (a
// group's latency is mostly barriers and shared-memory atomics, so more
// groups in flight hide it; at 40 registers it spills).
constexpr int MIN_BLOCKS = 10;

// order_bits as an unsigned key: -0.0 == +0.0, every NaN one NaN above
// +inf (trino_tpu/exec/kernels.py:order_bits, unsigned form).
__device__ __forceinline__ u64 sort_key(double v) {
  const u64 b = v != v ? ttk::NAN64_BITS
                       : (v == 0.0 ? 0ull : (u64)__double_as_longlong(v));
  return (b >> 63) ? ~b : (b | (1ull << 63));
}

// One group: its rows are rows[first .. first + R) (rows null: the
// identity); point p = j * k + i is value i of its j-th row.
struct Group {
  const double* states;
  const unsigned char* eff;
  const long long* rows;
  long long k, first, R, npts;
  int lk;
};

__device__ __forceinline__ long long row_of(const Group& g, long long j) {
  return g.rows != nullptr ? g.rows[g.first + j] : g.first + j;
}

// cnt of a contributing row with a positive count (the weight of each of
// its points in units of 1 / k), else 0
__device__ __forceinline__ u64 row_units(const Group& g, long long row) {
  if (!g.eff[row]) return 0;
  const double c = g.states[row * (g.k + 1) + g.k];
  return c > 0.0 ? (u64)c : 0;
}

__device__ __forceinline__ double point_value(const Group& g, long long row,
                                              long long i) {
  return g.states[row * (g.k + 1) + i];
}

// A group's positive-weight rows staged in shared memory in row order:
// point p = c * k + i is value i of the c-th of them.
struct Staged {
  u64* keys;         // [cap_pts]
  u64* units;        // [cap_rows]
  long long* rowid;  // [cap_rows]
};

// Point p's units (0: it weighs nothing) and, when positive, its key.
template <bool SMEM>
__device__ __forceinline__ void point(const Group& g, const Staged& s,
                                      long long p, u64* key, u64* units) {
  if (SMEM) {
    *units = s.units[p >> g.lk];
    *key = s.keys[p];
  } else {
    const long long row = row_of(g, p >> g.lk);
    *units = row_units(g, row);
    if (*units) *key = sort_key(point_value(g, row, p & (g.k - 1)));
  }
}

__device__ __forceinline__ int bin_at(unsigned b) { return b + (b >> 3); }

struct Hist {
  unsigned lo[PADDED_BINS], hi[PADDED_BINS], cnt[PADDED_BINS];
  unsigned p[PADDED_BINS];  // a point of the bin: the only one when cnt is 1
};

// What a pass decides, for the whole block.
struct Decision {
  u64 below;  // units of the positive points before the chosen bin
  long long p;
  unsigned digit, cnt;
};

// A block's shared state besides the staged points.
struct Block {
  Hist h;
  Decision dec;
  u64 red[3][WARPS];
  long long np;  // the staged points
};

// Adds `len` points of `units` each to bin d: the units as a low word and
// the carries out of it into a high word, so 32-bit atomics sum u64s.
__device__ __forceinline__ void hist_add(Hist& h, unsigned d, u64 units,
                                         unsigned len, long long p) {
  const int b = bin_at(d);
  atomicAdd(&h.cnt[b], len);
  const u64 v = units * len;
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(&h.lo[b], lo);
  const unsigned hi = (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) atomicAdd(&h.hi[b], hi);
  h.p[b] = (unsigned)p;
}

// The AND and OR of a, o and the sum of sum over the block, in place.
__device__ void block_and_or_sum(Block& b, u64* a, u64* o, u64* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    *a &= __shfl_xor_sync(FULL, *a, d);
    *o |= __shfl_xor_sync(FULL, *o, d);
    *sum += __shfl_xor_sync(FULL, *sum, d);
  }
  if (lane == 0) {
    b.red[0][warp] = *a;
    b.red[1][warp] = *o;
    b.red[2][warp] = *sum;
  }
  __syncthreads();
  *a = ~0ull;
  *o = *sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    *a &= b.red[0][w];
    *o |= b.red[1][w];
    *sum += b.red[2][w];
  }
  __syncthreads();  // red may be reused
}

// The greatest v over the block.
template <typename T>
__device__ T block_max(T v, T* scratch) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const T x = __shfl_xor_sync(FULL, v, d);
    v = x > v ? x : v;
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) v = scratch[w] > v ? scratch[w] : v;
  __syncthreads();
  return v;
}

// One radix pass over the digit [shift, shift + width) of the key (of p
// once `on_p`), among the positive points that match `prefix` above it
// (and, once on p, whose key is `prefix` and whose p matches `pprefix`
// above it). Returns the decision: the first bin whose cumulative units
// reach t.
template <bool SMEM>
__device__ __forceinline__ Decision radix_pass(
    const Group& g, const Staged& s, Block& blk, bool on_p, u64 prefix,
    long long pprefix, int shift, int width, u64 below, double inv_k,
    double t) {
  Hist& h = blk.h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int top = shift + width;  // bits at and above top are fixed
  const u64 above = top >= 64 ? 0ull : ~0ull << top;
  const unsigned dmask = (1u << width) - 1u;
  // the histogram is clear on entry; a warp-uniform loop, so that every
  // lane takes part in the run detection
  for (long long base = (long long)warp * 32; base < g.npts;
       base += THREADS) {
    const long long p = base + lane;
    u64 key = 0, units = 0;
    if (p < g.npts) point<SMEM>(g, s, p, &key, &units);
    bool act = units != 0;
    unsigned d = 0;
    if (act) {
      if (!on_p) {
        act = ((key ^ prefix) & above) == 0;
        d = (unsigned)(key >> shift) & dmask;
      } else {
        act = key == prefix && (((u64)(p ^ pprefix)) & above) == 0;
        d = (unsigned)((u64)p >> shift) & dmask;
      }
    }
    // runs of adjacent lanes with the same row and digit add once
    const u64 run = act ? (((u64)(p >> g.lk) << 8) | d) : ~0ull;
    const u64 prev = __shfl_up_sync(FULL, run, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || run != prev);
    const unsigned later = heads & ~((2u << lane) - 1u);
    const int end = later ? __ffs(later) - 1 : 32;
    if (act && ((heads >> lane) & 1u)) {
      hist_add(h, d, units, (unsigned)(end - lane), p);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // lane l scans bins 8l .. 8l + 7, then clears them for the next pass
    u64 v[8];
    u64 sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = bin_at(8 * lane + i);
      v[i] = ((u64)h.hi[b] << 32) | h.lo[b];
      sum += v[i];
    }
    u64 ex = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 x = __shfl_up_sync(FULL, ex, d);
      if (lane >= d) ex += x;
    }
    ex -= sum;
    auto reach = [&](u64 w) { return __dmul_rn((double)w, inv_k) >= t; };
    // the first non-empty bin reaching t: no earlier bin of the pass did
    int win = -1;
    u64 win_below = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (win < 0 && v[i] && reach(below + ex + v[i]) &&
          (ex == 0 || !reach(below + ex))) {
        win = i;
        win_below = below + ex;
      }
      ex += v[i];
    }
    if (win >= 0) {
      const int b = bin_at(8 * lane + win);
      blk.dec = Decision{win_below, (long long)h.p[b],
                         (unsigned)(8 * lane + win), h.cnt[b]};
    }
    if (__ballot_sync(FULL, win >= 0) == 0 && lane == 0) blk.dec.cnt = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = bin_at(8 * lane + i);
      h.lo[b] = h.hi[b] = h.cnt[b] = 0;
    }
  }
  __syncthreads();
  return blk.dec;  // rewritten only after the next pass's first barrier
}

// The pick of one group, a p of the points it walks (or -1), and its
// total units.
template <bool SMEM>
__device__ __forceinline__ long long group_pick(Group g, const Staged& s,
                                                Block& blk, double q,
                                                u64* total_units) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double inv_k = 1.0 / (double)g.k;
  for (int b = threadIdx.x; b < PADDED_BINS; b += THREADS) {
    blk.h.lo[b] = blk.h.hi[b] = blk.h.cnt[b] = 0;
  }
  u64 a = ~0ull, o = 0, sum = 0;
  if (SMEM) {
    // warp 0 stages the positive rows in row order, then every thread
    // their keys, each with LOADS reads in flight
    if (warp == 0) {
      long long staged = 0;
      for (long long j0 = 0; j0 < g.R; j0 += 32) {
        const long long j = j0 + lane;
        long long row = 0;
        u64 units = 0;
        if (j < g.R) {
          row = row_of(g, j);
          units = row_units(g, row);
        }
        const unsigned positive = __ballot_sync(FULL, units != 0);
        if (units) {
          const long long at = staged + __popc(positive & ((1u << lane) - 1u));
          s.rowid[at] = row;
          s.units[at] = units;
        }
        staged += __popc(positive);
        sum += units * (u64)g.k;
      }
      if (lane == 0) blk.np = staged * g.k;
    }
    __syncthreads();
    g.npts = blk.np;
    for (long long p0 = threadIdx.x; p0 < g.npts; p0 += LOADS * THREADS) {
      double v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const long long p = p0 + u * THREADS;
        if (p < g.npts) v[u] = point_value(g, s.rowid[p >> g.lk], p & (g.k - 1));
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const long long p = p0 + u * THREADS;
        if (p < g.npts) {
          const u64 key = sort_key(v[u]);
          s.keys[p] = key;
          a &= key;
          o |= key;
        }
      }
    }
  } else {
    for (long long j = threadIdx.x; j < g.R; j += THREADS) {
      sum += row_units(g, row_of(g, j)) * (u64)g.k;
    }
    for (long long p = threadIdx.x; p < g.npts; p += THREADS) {
      u64 key = 0, units = 0;
      point<false>(g, s, p, &key, &units);
      if (units) {
        a &= key;
        o |= key;
      }
    }
  }
  block_and_or_sum(blk, &a, &o, &sum);  // its barriers publish the staging
  *total_units = sum;
  const double total = __dmul_rn((double)sum, inv_k);
  const double t = __dsub_rn(__dmul_rn(q, total), 1e-9);
  if (sum == 0 || !(total >= t)) return -1;
  if (g.npts == 1) return 0;
  u64 prefix = a;  // the bits every positive point shares
  u64 below = 0;
  const u64 vary = a ^ o;
  if (vary) {
    const int l = __ffsll((long long)vary) - 1;
    for (int hb = 63 - __clzll((long long)vary); hb >= l;) {
      const int shift = hb - 7 > l ? hb - 7 : l;
      const int width = hb - shift + 1;
      const Decision d = radix_pass<SMEM>(g, s, blk, false, prefix, 0, shift,
                                          width, below, inv_k, t);
      if (d.cnt == 0) return -1;  // unreachable: the total reaches t
      below = d.below;
      prefix = (prefix & ~((u64)((1u << width) - 1u) << shift)) |
               ((u64)d.digit << shift);
      if (d.cnt == 1) return d.p;
      hb = shift - 1;
    }
  }
  // ties on every bit: the first in p order (flat index order)
  long long pprefix = 0;
  const int pbits = 64 - __clzll((long long)(g.npts - 1));
  for (int hb = pbits - 1; hb >= 0;) {
    const int shift = hb - 7 > 0 ? hb - 7 : 0;
    const int width = hb - shift + 1;
    const Decision d = radix_pass<SMEM>(g, s, blk, true, prefix, pprefix,
                                        shift, width, below, inv_k, t);
    if (d.cnt == 0) return -1;
    below = d.below;
    pprefix |= (long long)d.digit << shift;
    if (d.cnt == 1) return d.p;
    hb = shift - 1;
  }
  return -1;  // unreachable: p is unique
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) merge_groups(
    const double* __restrict__ states, long long k, int lk, long long n,
    const unsigned char* __restrict__ eff, const long long* __restrict__ rows,
    const long long* __restrict__ seg_lo, const long long* __restrict__ seg_hi,
    long long cap_pts, const double* __restrict__ q,
    const long long* __restrict__ last_flat, double* __restrict__ out,
    unsigned char* __restrict__ has) {
  extern __shared__ u64 dyn[];
  __shared__ Block blk;
  const long long grp = blockIdx.x;
  Group g;
  g.states = states;
  g.eff = eff;
  g.rows = rows;
  g.k = k;
  g.lk = lk;
  // no ranges: one group (0) of every row in row order
  g.first = seg_lo != nullptr ? seg_lo[grp] : (grp == 0 ? 0 : n);
  g.R = (seg_hi != nullptr ? seg_hi[grp] : n) - g.first;
  g.npts = g.R * k;
  const long long cap_rows = cap_pts >> lk;
  const Staged s{dyn, dyn + cap_pts, (long long*)(dyn + cap_pts + cap_rows)};
  const bool staged = g.npts <= cap_pts;
  u64 total_units = 0;
  const long long p = staged
                          ? group_pick<true>(g, s, blk, q[0], &total_units)
                          : group_pick<false>(g, s, blk, q[0], &total_units);
  if (threadIdx.x == 0) {
    long long flat = *last_flat;
    if (p >= 0) {
      const long long j = p >> lk;
      flat = (staged ? s.rowid[j] : row_of(g, j)) * k + (p & (k - 1));
    }
    out[grp] = states[(flat >> lk) * (k + 1) + (flat & (k - 1))];
    has[grp] = total_units > 0;
  }
}

// The flat index of the last point of the whole order: the greatest
// (bits, flat index) over every row of the last sorted row's group.
__global__ void __launch_bounds__(THREADS) last_point(
    const double* __restrict__ states, long long k, int lk, long long n,
    const long long* __restrict__ rows, const long long* __restrict__ seg_lo,
    const long long* __restrict__ group, long long caps,
    long long* __restrict__ last_flat) {
  __shared__ u64 keys[WARPS];
  __shared__ long long ps[WARPS];
  const long long grp = group != nullptr ? *group : 0;
  Group g;
  g.states = states;
  g.rows = rows;
  g.k = k;
  g.lk = lk;
  g.first = seg_lo == nullptr ? 0 : (grp >= 0 && grp < caps ? seg_lo[grp] : n);
  g.R = n - g.first;
  g.npts = g.R * k;
  u64 best = 0;
  for (long long p = threadIdx.x; p < g.npts; p += THREADS) {
    const u64 key = sort_key(point_value(g, row_of(g, p >> lk), p & (k - 1)));
    best = key > best ? key : best;
  }
  best = block_max(best, keys);
  long long pm = -1;
  for (long long p = threadIdx.x; p < g.npts; p += THREADS) {
    const u64 key = sort_key(point_value(g, row_of(g, p >> lk), p & (k - 1)));
    if (key == best) pm = p;
  }
  pm = block_max(pm, ps);
  if (threadIdx.x == 0) {
    *last_flat = pm >= 0 ? row_of(g, pm >> lk) * k + (pm & (k - 1)) : 0;
  }
}

}  // namespace

// states: float64[n, k + 1] summaries (k points, then the count), k a
// power of two; eff: [n] bool; rows: [n] int64 partial rows ordered by
// group, stably; seg_lo, seg_hi: [caps] int64 each group's range in rows;
// last_group: [1] int64 the group of the last row in that order (rows,
// seg_lo, seg_hi and last_group all null: group 0 holds every row in row
// order, the global form); cap_pts: the most points a group stages in
// shared memory (clamped here to what a block can have); q: one float64
// on the device. Scratch last_flat: [1] int64. Outputs out: [caps]
// float64, has: [caps] bool. Returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int quant_merge_launch(const void* states, long long k,
                                  long long n, const void* eff,
                                  const void* rows, const void* seg_lo,
                                  const void* seg_hi, const void* last_group,
                                  long long caps, long long cap_pts,
                                  const void* q, void* last_flat, void* out,
                                  void* has, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (caps <= 0 || n <= 0 || k <= 0) return (int)cudaGetLastError();
  int lk = 0;
  while ((1ll << lk) < k) ++lk;
  // a staged row takes k keys, its units and its row id
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  cudaFuncAttributes fa;
  const cudaError_t fe = cudaFuncGetAttributes(&fa, merge_groups);
  if (fe != cudaSuccess) return (int)fe;
  const long long room_rows =
      ((long long)optin - (long long)fa.sharedSizeBytes) /
      ((k + 2) * (long long)sizeof(u64));
  if (cap_pts > (room_rows << lk)) cap_pts = room_rows << lk;
  const long long cap_rows = cap_pts >> lk;
  const size_t smem = (size_t)(cap_pts + 2 * cap_rows) * sizeof(u64);
  if (smem > (48u << 10)) {
    // past the default 48 KB: allowed per function and per device, so on
    // every such call (the caller's device may change between calls)
    const cudaError_t e = cudaFuncSetAttribute(
        merge_groups, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  last_point<<<1, THREADS, 0, s>>>(
      (const double*)states, k, lk, n, (const long long*)rows,
      (const long long*)seg_lo, (const long long*)last_group, caps,
      (long long*)last_flat);
  merge_groups<<<(unsigned int)caps, THREADS, smem, s>>>(
      (const double*)states, k, lk, n, (const unsigned char*)eff,
      (const long long*)rows, (const long long*)seg_lo,
      (const long long*)seg_hi, cap_pts, (const double*)q,
      (const long long*)last_flat, (double*)out, (unsigned char*)has);
  return (int)cudaGetLastError();
}
