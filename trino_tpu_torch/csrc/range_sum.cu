// W2 range_sum: per-row sums over window frames [lo, hi) of sorted rows,
// up to eight value lanes in one launch.
//
// Replaces: trino_tpu/exec/window.py:_range_sum (:429), which every window
// count, sum and avg runs through (window.py:288-371): a float64 lane by a
// segmented scan with the partition check at lo-1 (:438-461), int64 lanes
// (counts, short decimals, and the hi and lo limbs of a decimal(38)
// argument, whose carry the caller folds as s_hi + (s_lo >> 32),
// s_lo & 0xFFFFFFFF, window.py:309-314) by a cumsum difference.
//
// Per lane: cs = the inclusive scan of the values, global for an int64
// lane (as the JAX package's cumsum; unsigned 64-bit adds, so it wraps
// alike and the difference is exact) and restarting at every partition
// head for a float64 lane, so a float sum never adds a neighbouring
// partition's values (a small partition keeps its precision beside a
// huge one, tests/test_window_setops.py::
// test_window_float_sum_cross_partition_precision). out[p] = cs[hi-1] -
// cs[lo-1], where the cs[lo-1] term counts when lo > 0 and, for a float
// lane, when row lo-1 lies in p's partition; an empty frame (hi <= lo)
// gives 0. lo and hi are clipped to p's partition (window.py:292-293), so
// for a non-empty frame row lo-1 lies in p's partition exactly when row
// lo is not a partition head.
//
// Float lanes give the same bits from call to call: every addition runs
// in an order fixed by the input's length alone (a reduce-then-scan,
// never a look-back whose result would depend on timing). That order
// differs from jax.lax.associative_scan's.
//
// Bound on an H100 (3.35 TB/s): per lane the values (8 B) in and the sums
// (8 B) out, plus lo and hi (16 B) once, and gid (8 B) when a lane is
// float64 (int lanes never need it): for ds_range7 at SF10 (28.8M rows, a
// count lane and a sum lane, both int64) ~1.38 GB, ~0.41 ms. Bytes bound
// it.
//
// Design: four launches that carry every lane at once.
// 1. `tile_reduce`: per tile of THREADS * ITEMS rows, read gid once (only
//    when a float lane needs partition heads) and write the heads as one
//    bit per row; per lane, the sum of the tile's values after its last
//    head (all of them for an int lane) and whether it has a head.
// 2. `tile_carries`: one block scans those per-tile aggregates, lane by
//    lane, into each tile's carry-in.
// 3. `tile_scan`: per tile, read the head bits (1/64 of gid's bytes) and
//    each lane's values again (the next lane's loads in flight while one
//    is scanned), scan them per warp with shuffles from the tile's carry
//    and the earlier warps' aggregates, and write each lane's cs.
// 4. `frame_sums`: read lo and hi once per row, and per lane gather
//    cs[hi-1] and cs[lo-1], which lie near row p for offset frames and at
//    the partition start for running frames (L1/L2 hits), and write out.
// Warps own 32 * ITEMS consecutive rows, read 32 at a time (coalesced).
// Per row that is 8 B of gid (float lanes only) and 40 B per lane (two
// reads of the values, cs written and read, out written) plus lo and hi:
// the cs scratch and the second read keep it above the bound (for
// ds_range7 `tile_scan` and `frame_sums` take ~0.30 and ~0.34 ms of
// ~0.85, PERF.md §6).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::WARPS;
using ttk::u64;
constexpr int ITEMS = 8;
constexpr int WARP_ROWS = 32 * ITEMS;
constexpr int TILE = THREADS * ITEMS;
constexpr int MAX_LANES = 8;
constexpr int CARRY_THREADS = 1024;
constexpr int CARRY_WARPS = CARRY_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Lanes {
  const void* in[MAX_LANES];
  void* out[MAX_LANES];
  void* cs[MAX_LANES];
  int f64[MAX_LANES];
  int k;
  int any_f64;
};

__device__ __forceinline__ u64 bits_of(u64 v) { return v; }
__device__ __forceinline__ u64 bits_of(double v) {
  return (u64)__double_as_longlong(v);
}
template <typename T> __device__ __forceinline__ T from_bits(u64 b);
template <> __device__ __forceinline__ u64 from_bits<u64>(u64 b) { return b; }
template <> __device__ __forceinline__ double from_bits<double>(u64 b) {
  return __longlong_as_double((long long)b);
}

// Sum of one value per lane of a warp, in a fixed order; valid in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(FULL, v, s);
  return v;
}

// The heads of the warp's rows written as one word per 32 rows (bit =
// lane); returns the position of the warp's last head among its rows
// (-1 for none).
__device__ __forceinline__ int warp_heads(const long long* gid, long long n,
                                          long long wbase, unsigned* heads) {
  const int lane = threadIdx.x & 31;
  int last = -1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long r = wbase + i * 32 + lane;
    bool h = false;
    if (r < n) h = r == 0 || gid[r] != gid[r - 1];
    const unsigned word = __ballot_sync(FULL, h);
    if (lane == 0 && wbase + i * 32 < n) heads[(wbase >> 5) + i] = word;
    if (word) last = i * 32 + 31 - __clz((int)word);
  }
  return last;
}

// Lane j's values at the warp's rows; 0 past the end.
template <typename T>
__device__ __forceinline__ void load_rows(const T* vals, long long n,
                                          long long wbase, T v[ITEMS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long r = wbase + i * 32 + lane;
    v[i] = r < n ? vals[r] : T(0);
  }
}

// The warp's aggregate of lane values: the sum of its rows from position
// `from` on (0: all of them); valid in lane 0.
template <typename T>
__device__ __forceinline__ T warp_aggregate(const T v[ITEMS], int from) {
  const int lane = threadIdx.x & 31;
  T s = T(0);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i * 32 + lane >= from) s += v[i];
  }
  return warp_sum(s);
}

template <typename T>
__device__ __forceinline__ void reduce_lane(const Lanes& L, int j, long long n,
                                            long long wbase, int last,
                                            u64 (*wsum)[WARPS]) {
  T v[ITEMS];
  load_rows((const T*)L.in[j], n, wbase, v);
  const T s = warp_aggregate(v, L.f64[j] && last > 0 ? last : 0);
  if ((threadIdx.x & 31) == 0) wsum[j][threadIdx.x >> 5] = bits_of(s);
}

// Per lane, (tile has a head, the tile's value since its last head).
__global__ void __launch_bounds__(THREADS) tile_reduce(
    Lanes L, const long long* __restrict__ gid, long long n,
    unsigned* __restrict__ heads, int* __restrict__ tile_f,
    u64* __restrict__ tile_v, long long tiles) {
  __shared__ u64 wsum[MAX_LANES][WARPS];
  __shared__ int wlast[WARPS];
  const int t = threadIdx.x, warp = t >> 5;
  const long long tile = blockIdx.x;
  const long long wbase = tile * TILE + (long long)warp * WARP_ROWS;
  const int last = L.any_f64 ? warp_heads(gid, n, wbase, heads) : -1;
  if ((t & 31) == 0) wlast[warp] = last;
  for (int j = 0; j < L.k; ++j) {
    if (L.f64[j]) {
      reduce_lane<double>(L, j, n, wbase, last, wsum);
    } else {
      reduce_lane<u64>(L, j, n, wbase, last, wsum);
    }
  }
  __syncthreads();
  if (t < L.k) {
    const bool seg = L.f64[t];
    u64 acc = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (seg) {
        const double a = from_bits<double>(acc), b = from_bits<double>(wsum[t][w]);
        acc = bits_of(wlast[w] >= 0 ? b : a + b);
      } else {
        acc += wsum[t][w];
      }
    }
    tile_v[t * tiles + tile] = acc;
  }
  if (t == 0) {
    int f = 0;
    for (int w = 0; w < WARPS; ++w) f |= wlast[w] >= 0;
    tile_f[tile] = f;
  }
}

// Segmented combine of (f, v) pairs: `b` after `a`.
template <typename T>
struct SegVal {
  int f;
  T v;
};

template <typename T>
__device__ __forceinline__ SegVal<T> seg_add(SegVal<T> a, SegVal<T> b) {
  return SegVal<T>{a.f | b.f, b.f ? b.v : a.v + b.v};
}

template <typename T>
__device__ __forceinline__ SegVal<T> shfl_up_seg(SegVal<T> a, int d) {
  return SegVal<T>{__shfl_up_sync(FULL, a.f, d), __shfl_up_sync(FULL, a.v, d)};
}

template <typename T>
__device__ void carry_lane(const int* tile_f, T* carry, long long tiles,
                           bool seg, SegVal<T>* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  SegVal<T> chunk{0, T(0)};
  for (long long c0 = 0; c0 < tiles; c0 += (long long)CARRY_THREADS * ITEMS) {
    const long long first = c0 + (long long)t * ITEMS;
    SegVal<T> item[ITEMS];
    SegVal<T> own{0, T(0)};
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long x = first + i;
      item[i] = SegVal<T>{0, T(0)};
      if (x < tiles) item[i] = SegVal<T>{seg ? tile_f[x] : 0, carry[x]};
      own = seg_add(own, item[i]);
    }
    // the threads' aggregates scanned across the block in a fixed order
    SegVal<T> incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const SegVal<T> up = shfl_up_seg(incl, d);
      if (lane >= d) incl = seg_add(up, incl);
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      SegVal<T> w = warp_tot[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const SegVal<T> up = shfl_up_seg(w, d);
        if (lane >= d) w = seg_add(up, w);
      }
      warp_tot[lane] = w;
    }
    __syncthreads();
    SegVal<T> before = shfl_up_seg(incl, 1);
    SegVal<T> run = chunk;
    if (warp > 0) run = seg_add(run, warp_tot[warp - 1]);
    if (lane > 0) run = seg_add(run, before);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long x = first + i;
      if (x < tiles) carry[x] = run.v;
      run = seg_add(run, item[i]);
    }
    chunk = seg_add(chunk, warp_tot[CARRY_WARPS - 1]);
    __syncthreads();  // warp_tot is reused by the next chunk
  }
}

// One block: each lane's tile aggregates become the tiles' carry-in (the
// running value at the end of the tiles before), in place.
__global__ void __launch_bounds__(CARRY_THREADS) tile_carries(
    Lanes L, const int* __restrict__ tile_f, u64* tile_v, long long tiles) {
  __shared__ SegVal<double> tot_f[CARRY_WARPS];
  __shared__ SegVal<u64> tot_u[CARRY_WARPS];
  for (int j = 0; j < L.k; ++j) {
    if (L.f64[j]) {
      carry_lane<double>(tile_f, (double*)(tile_v + j * tiles), tiles, true, tot_f);
    } else {
      carry_lane<u64>(tile_f, tile_v + j * tiles, tiles, false, tot_u);
    }
  }
}

template <typename T>
__device__ __forceinline__ void scan_lane(
    const Lanes& L, int j, long long n, long long tile, long long tiles,
    long long wbase, int last, const signed char start[ITEMS],
    const u64 bits[ITEMS], const u64* tile_v, u64* wsum, const int* wlast) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool seg = L.f64[j];
  T v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) v[i] = from_bits<T>(bits[i]);
  const T s = warp_aggregate(v, seg && last > 0 ? last : 0);
  if (lane == 0) wsum[warp] = bits_of(s);
  __syncthreads();
  // the running value before the warp's rows: the tile's carry, then the
  // earlier warps in order
  T c = from_bits<T>(tile_v[j * tiles + tile]);
  for (int w = 0; w < warp; ++w) {
    const T a = from_bits<T>(wsum[w]);
    c = seg && wlast[w] >= 0 ? a : c + a;
  }
  T* cs = (T*)L.cs[j];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int st = seg ? start[i] : -1;
    const int floor = st < 0 ? 0 : st;  // this row's segment starts there
    T x = v[i];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T up = __shfl_up_sync(FULL, x, d);
      if (lane - d >= floor) x = up + x;
    }
    if (st < 0) x = c + x;
    const long long r = wbase + i * 32 + lane;
    if (r < n) cs[r] = x;
    c = __shfl_sync(FULL, x, 31);
  }
  __syncthreads();  // wsum is reused by the next lane
}

// Every lane's inclusive scan cs, from the tile carries.
__global__ void __launch_bounds__(THREADS) tile_scan(
    Lanes L, const unsigned* __restrict__ heads, long long n,
    const u64* __restrict__ tile_v, long long tiles) {
  __shared__ u64 wsum[WARPS];
  __shared__ int wlast[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile = blockIdx.x;
  const long long wbase = tile * TILE + (long long)warp * WARP_ROWS;
  // per row of 32: the lane of the latest head at or before this lane
  signed char start[ITEMS];
  int last = -1;
  const unsigned upto = lane == 31 ? FULL : (2u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    unsigned w = 0;
    if (L.any_f64 && wbase + i * 32 < n) w = heads[(wbase >> 5) + i];
    const unsigned m = w & upto;
    start[i] = (signed char)(m ? 31 - __clz((int)m) : -1);
    if (w) last = i * 32 + 31 - __clz((int)w);
  }
  if (lane == 0) wlast[warp] = last;
  // each lane's values as raw bits, the next lane's loaded while this
  // one is scanned
  u64 cur[ITEMS], nxt[ITEMS];
  load_rows((const u64*)L.in[0], n, wbase, cur);
  for (int j = 0; j < L.k; ++j) {
    if (j + 1 < L.k) load_rows((const u64*)L.in[j + 1], n, wbase, nxt);
    if (L.f64[j]) {
      scan_lane<double>(L, j, n, tile, tiles, wbase, last, start, cur,
                        tile_v, wsum, wlast);
    } else {
      scan_lane<u64>(L, j, n, tile, tiles, wbase, last, start, cur, tile_v,
                     wsum, wlast);
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) cur[i] = nxt[i];
  }
}

__global__ void __launch_bounds__(THREADS) frame_sums(
    Lanes L, const unsigned* __restrict__ heads,
    const long long* __restrict__ lo, const long long* __restrict__ hi,
    long long n) {
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n;
       p += (long long)gridDim.x * THREADS) {
    const long long l = lo[p], h = hi[p];
    const bool full = h > l;
    const bool bot = full && l > 0;
    // float lanes: row l-1 in p's partition (l is not a head)
    const bool bot_f = bot && L.any_f64 && !((heads[l >> 5] >> (l & 31)) & 1u);
    for (int j = 0; j < L.k; ++j) {
      if (L.f64[j]) {
        const double* cs = (const double*)L.cs[j];
        double r = 0.0;
        if (full) r = cs[h - 1] - (bot_f ? cs[l - 1] : 0.0);
        ((double*)L.out[j])[p] = r;
      } else {
        const u64* cs = (const u64*)L.cs[j];
        u64 r = 0;
        if (full) r = cs[h - 1] - (bot ? cs[l - 1] : 0ull);
        ((u64*)L.out[j])[p] = r;
      }
    }
  }
}

}  // namespace

// desc: k rows of 3 int64s on the host: values pointer ([n], contiguous),
// type (ColType: I64 or F64), output pointer ([n], same type). gid: [n]
// non-decreasing partition ids of the sorted rows (read only when a lane
// is float64); lo, hi: [n] frame bounds, each clipped to its row's
// partition. Scratch: heads (ceil(n / 32) uint32), tile_f
// (ceil(n / 2048) int32), tile_v (k * ceil(n / 2048) x 8 B), cs
// (k * n x 8 B). Returns cudaGetLastError(), or cudaErrorInvalidValue for
// k outside [1, MAX_LANES] or a lane of another type.
extern "C" int range_sum_launch(const long long* desc, long long k,
                                const void* gid, const void* lo,
                                const void* hi, long long n, void* heads,
                                void* tile_f, void* tile_v, void* cs,
                                void* stream) {
  if (k < 1 || k > MAX_LANES) return (int)cudaErrorInvalidValue;
  Lanes L;
  L.k = (int)k;
  L.any_f64 = 0;
  for (int j = 0; j < L.k; ++j) {
    const int type = (int)desc[3 * j + 1];
    if (type != ttk::T_I64 && type != ttk::T_F64) return (int)cudaErrorInvalidValue;
    L.in[j] = (const void*)desc[3 * j];
    L.out[j] = (void*)desc[3 * j + 2];
    L.cs[j] = (void*)((u64*)cs + j * n);
    L.f64[j] = type == ttk::T_F64;
    L.any_f64 |= L.f64[j];
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + TILE - 1) / TILE;
  tile_reduce<<<(unsigned int)tiles, THREADS, 0, s>>>(
      L, (const long long*)gid, n, (unsigned*)heads, (int*)tile_f,
      (u64*)tile_v, tiles);
  tile_carries<<<1, CARRY_THREADS, 0, s>>>(L, (const int*)tile_f,
                                           (u64*)tile_v, tiles);
  tile_scan<<<(unsigned int)tiles, THREADS, 0, s>>>(
      L, (const unsigned*)heads, n, (const u64*)tile_v, tiles);
  const long long blocks = (n + THREADS - 1) / THREADS;
  const unsigned int grid = (unsigned int)(blocks < 132 * 16 ? blocks : 132 * 16);
  frame_sums<<<grid, THREADS, 0, s>>>(L, (const unsigned*)heads,
                                      (const long long*)lo,
                                      (const long long*)hi, n);
  return (int)cudaGetLastError();
}
