// K4 expand_matches: expand per-probe match ranges into output pairs.
//
// Replaces: trino_tpu/exec/kernels.py:expand_matches (:620). Output
// position j < total belongs to the probe row whose range covers it;
// probe_idx[j] is that row and build_idx[j] = order[lo + (j - offset)].
// out_live[j] = j < total. Positions past total are dead; their indices
// are set to in-range placeholders (the JAX package leaves them
// arbitrary too, and callers read them only under out_live).
//
// Bound on an H100 (3.35 TB/s): it must read cnt (8 B/probe row), lo
// (8 B where cnt > 0) and one `order` entry per match, and write
// probe_idx, build_idx and out_live (17 B/output slot). No array of
// offsets is part of the function, so none is written: the exclusive
// prefix of cnt lives in shared memory, one tile at a time.
//
// Design: one single-pass kernel over tiles of TILE probe rows, then one
// short grid for the heavy rows and the dead tail.
// 1. `tiles`: each block takes the next tile id from a counter (tiles
//    start in order, so a block only waits on running blocks), reads the
//    tile's cnt in coalesced stripes, and lo where a row has 1..HEAVY
//    matches, and scans cnt in shared memory twice with
//    ttk::block_inclusive_scan: every count, for each row's offset in the
//    tile, and the light counts (cnt <= HEAVY), for each row's place
//    among the tile's light outputs. It publishes its count for the
//    look-back, then gathers its first PREFETCH light outputs a thread
//    from `order` (consecutive threads on consecutive outputs, each
//    finding its owning row by a binary search over the light offsets in
//    shared memory), so that those random reads are in flight while warp
//    0 takes the tile's base from ttk::look_back. Then it stores
//    probe_idx, build_idx and out_live at base + offset, coalesced; the
//    last tile writes total.
// 2. A heavy row (cnt > HEAVY) is not written by its tile: its thread
//    appends one descriptor (output start, order start, row, length
//    below out_cap) at a slot that one atomic per block reserves, with
//    the row's first CHUNK-sized chunk number packed in the same counter
//    word, so descriptors lie in chunk order.
// 3. `fill`: one resident wave of warps splits the heavy rows' chunks
//    evenly, each warp a contiguous run of chunks (one binary search for
//    its first descriptor, then a forward walk), so no thread and no
//    single block carries one hot row's range; its lanes write each
//    chunk coalesced and read `order` contiguously. The same grid then
//    writes the dead tail [min(total, out_cap), out_cap), which only
//    exists once total is known on the card. Nothing syncs with the host.
// A tile therefore writes at most TILE * HEAVY outputs itself, and a
// probe row with 10^6 matches is ~10^3 chunks spread over every SM. On
// the card most of the time is the random reads of `order` (PERF.md).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::u64;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // probe rows per tile
// Per-row shared arrays are indexed r + r / 8: a thread's ITEMS
// consecutive rows then fall in distinct banks.
constexpr int PADDED = TILE + TILE / 8;
// The largest count a tile writes itself (a warp's width); larger rows go
// through the fill grid. exec/kernels.py sizes the descriptor buffer
// from it (EXPAND_HEAVY).
constexpr long long HEAVY = 32;
constexpr long long CHUNK = 1024;  // outputs a warp writes per descriptor chunk
// The heavy counter word: descriptor count << ROW_SHIFT | chunk count.
constexpr int ROW_SHIFT = 36;
constexpr u64 CHUNK_MASK = (1ull << ROW_SHIFT) - 1;
// Light outputs a thread gathers before the look-back, so that the
// gathers from `order` are in flight while the tile waits for its base
// (a tile of 0-1 match rows has about one a thread).
constexpr int PREFETCH = 4;
// Holds `tiles` to 48 registers a thread (five blocks an SM; its 46 KB
// of shared arrays allow four): unbounded, the prefetch takes 83 and
// leaves three blocks an SM.
constexpr int MIN_BLOCKS = 5;
// Outputs of a heavy chunk a lane reads from `order` before it stores.
constexpr int FILL_LOADS = 4;

__device__ __forceinline__ int pad(int r) { return r + (r >> 3); }

// A heavy row: its first chunk number, its first output position, its
// first position in `order`, the probe row, and its length below out_cap.
struct Heavy {
  long long chunk0, out, src, row, len;
};

__device__ __forceinline__ long long chunks_of(long long len) {
  return (len + CHUNK - 1) / CHUNK;
}

// The tile row that owns light output k: the last row whose light offset
// is <= k (rows with no light outputs share their successor's offset).
__device__ __forceinline__ int owner(const int* lex, int k) {
  int r = 0;
#pragma unroll
  for (int step = TILE / 2; step > 0; step >>= 1) {
    if (lex[pad(r + step)] <= k) r += step;
  }
  return r;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) tiles(
    const long long* __restrict__ order, const long long* __restrict__ lo,
    const long long* __restrict__ cnt, long long n, long long out_cap,
    u64* words, unsigned int* next_tile, long long* total, u64* heavy_count,
    Heavy* __restrict__ heavy, long long* __restrict__ probe_idx,
    long long* __restrict__ build_idx, unsigned char* __restrict__ out_live) {
  // the tile's counts, then each row's exclusive offset in the tile (and
  // the tile's total after the last row)
  __shared__ long long fex[PADDED + 1];
  // each row's exclusive offset among the tile's light outputs
  __shared__ int lex[PADDED];
  __shared__ long long los[PADDED];  // lo of the tile's light rows
  __shared__ long long tile_s, base_s;
  __shared__ u64 heavy_s;
  const int t = threadIdx.x;
  if (t == 0) tile_s = atomicAdd(next_tile, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long row0 = tile * TILE;

  // 1. counts in coalesced stripes, then lo where a light row reads it
  {
    long long cs[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int l = i * THREADS + t;
      const long long p = row0 + l;
      cs[i] = p < n ? cnt[p] : 0;
      fex[pad(l)] = cs[i];
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int l = i * THREADS + t;
      if (cs[i] > 0 && cs[i] <= HEAVY) los[pad(l)] = lo[row0 + l];
    }
  }
  __syncthreads();

  // 2. offsets in the tile: ITEMS consecutive rows a thread
  long long tile_full;
  int tile_light;
  {
    long long c[ITEMS];
    long long full = 0;
    int light = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      c[i] = fex[pad(t * ITEMS + i)];
      full += c[i];
      light += c[i] <= HEAVY ? (int)c[i] : 0;
    }
    long long fe = ttk::block_inclusive_scan(full, &tile_full) - full;
    int le = ttk::block_inclusive_scan(light, &tile_light) - light;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = pad(t * ITEMS + i);
      fex[r] = fe;
      lex[r] = le;
      fe += c[i];
      le += c[i] <= HEAVY ? (int)c[i] : 0;
    }
    if (t == THREADS - 1) fex[pad(TILE)] = tile_full;
  }
  if (t == 0) ttk::look_back_publish(words, tile, 1, tile_full);
  __syncthreads();

  // 3. the first light outputs' pairs, gathered before the tile's base is
  // known: their position in the tile, probe row and build row
  long long at[PREFETCH], row[PREFETCH], got[PREFETCH];
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) {
    const int k = t + u * THREADS;
    at[u] = -1;
    if (k < tile_light) {
      const int r = owner(lex, k);
      const int d = k - lex[pad(r)];
      at[u] = fex[pad(r)] + d;
      row[u] = row0 + r;
      got[u] = order[los[pad(r)] + d];
    }
  }

  // 4. the tile's base (warp 0)
  if (t < 32) {
    const long long excl = ttk::look_back(words, tile, 1, tile_full);
    if (t == 0) {
      base_s = excl;
      if (tile == (long long)gridDim.x - 1) *total = excl + tile_full;
    }
  }
  __syncthreads();
  const long long base = base_s;

  // 5. heavy rows: one descriptor each, in chunk order
  int hr = 0;
  long long hc = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long off = fex[pad(t * ITEMS + i)];
    const long long c = fex[pad(t * ITEMS + i + 1)] - off;
    if (c > HEAVY && base + off < out_cap) {
      const long long len = c < out_cap - base - off ? c : out_cap - base - off;
      ++hr;
      hc += chunks_of(len);
    }
  }
  if (__syncthreads_or(hr)) {
    const u64 mine = ((u64)hr << ROW_SHIFT) | (u64)hc;
    u64 block_total;
    const u64 incl = ttk::block_inclusive_scan(mine, &block_total);
    if (t == 0) heavy_s = atomicAdd((unsigned long long*)heavy_count, block_total);
    __syncthreads();
    // no carry crosses the two fields: chunk counts stay below 2^ROW_SHIFT
    const u64 ex = heavy_s + incl - mine;
    long long slot = (long long)(ex >> ROW_SHIFT);
    long long chunk = (long long)(ex & CHUNK_MASK);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long off = fex[pad(t * ITEMS + i)];
      const long long c = fex[pad(t * ITEMS + i + 1)] - off;
      if (c > HEAVY && base + off < out_cap) {
        const long long len = c < out_cap - base - off ? c : out_cap - base - off;
        const long long r = row0 + t * ITEMS + i;
        heavy[slot] = Heavy{chunk, base + off, lo[r], r, len};
        ++slot;
        chunk += chunks_of(len);
      }
    }
  }

  // 6. the light outputs, consecutive threads on consecutive positions:
  // the prefetched ones, then the rest
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) {
    const long long j = base + at[u];
    if (at[u] >= 0 && j < out_cap) {
      probe_idx[j] = row[u];
      build_idx[j] = got[u];
      out_live[j] = 1;
    }
  }
  for (int k = t + PREFETCH * THREADS; k < tile_light; k += THREADS) {
    const int r = owner(lex, k);
    const int d = k - lex[pad(r)];
    const long long j = base + fex[pad(r)] + d;
    if (j < out_cap) {
      probe_idx[j] = row0 + r;
      build_idx[j] = order[los[pad(r)] + d];
      out_live[j] = 1;
    }
  }
}

__global__ void __launch_bounds__(THREADS) fill(
    const long long* __restrict__ order, long long n, long long out_cap,
    const long long* total, const u64* heavy_count,
    const Heavy* __restrict__ heavy, long long* __restrict__ probe_idx,
    long long* __restrict__ build_idx, unsigned char* __restrict__ out_live) {
  const u64 hcount = *heavy_count;
  const long long rows = (long long)(hcount >> ROW_SHIFT);
  const long long chunks = (long long)(hcount & CHUNK_MASK);
  const long long warps = (long long)gridDim.x * (THREADS / 32);
  const long long w = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  long long c = chunks * w / warps;
  const long long c_end = chunks * (w + 1) / warps;
  if (c < c_end) {
    // the last descriptor whose first chunk is <= c (heavy[0].chunk0 == 0)
    long long a = 0, b = rows - 1;
    while (a < b) {
      const long long m = (a + b + 1) >> 1;
      if (heavy[m].chunk0 <= c) a = m; else b = m - 1;
    }
    for (; c < c_end; ++c) {
      while (a + 1 < rows && heavy[a + 1].chunk0 <= c) ++a;
      const Heavy h = heavy[a];
      const long long off = (c - h.chunk0) * CHUNK;
      const long long len = h.len - off < CHUNK ? h.len - off : CHUNK;
      for (long long i0 = lane; i0 < len; i0 += 32 * FILL_LOADS) {
        long long b[FILL_LOADS];
#pragma unroll
        for (int u = 0; u < FILL_LOADS; ++u) {
          const long long i = i0 + 32 * u;
          if (i < len) b[u] = order[h.src + off + i];
        }
#pragma unroll
        for (int u = 0; u < FILL_LOADS; ++u) {
          const long long i = i0 + 32 * u;
          if (i < len) {
            const long long j = h.out + off + i;
            probe_idx[j] = h.row;
            build_idx[j] = b[u];
            out_live[j] = 1;
          }
        }
      }
    }
  }
  // the dead tail: in-range placeholders
  const long long tot = *total;
  const long long dead0 = tot < out_cap ? tot : out_cap;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long pn = n > 0 ? n - 1 : 0;
  for (long long j = dead0 + (long long)blockIdx.x * THREADS + threadIdx.x;
       j < out_cap; j += stride) {
    probe_idx[j] = pn;
    build_idx[j] = 0;
    out_live[j] = 0;
  }
}

}  // namespace

// order: [m] sorted build row ids; lo, cnt: [n]. Scratch: state, of
// state_len 64-bit words, at least ceil(n / TILE) + 3 (reset here: the
// tiles' look-back words, the tile counter, total, the heavy counter);
// heavy, of heavy_len descriptors of 5 int64 each, at least
// min(n, out_cap / (HEAVY + 1) + 1) (each heavy row below out_cap covers
// more than HEAVY slots). out_cap must stay below 2^33. Outputs
// probe_idx, build_idx: [out_cap] int64, out_live: [out_cap] bool.
// Returns cudaErrorInvalidValue, launching nothing, when a scratch
// buffer is too small, else cudaGetLastError().
extern "C" int expand_matches_launch(const void* order, const void* lo,
                                     const void* cnt, long long n,
                                     long long out_cap, void* state,
                                     long long state_len, void* heavy,
                                     long long heavy_len, void* probe_idx,
                                     void* build_idx, void* out_live,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (out_cap <= 0) return (int)cudaGetLastError();
  const long long n_tiles = (n + TILE - 1) / TILE;
  const long long heavy_rows = out_cap / (HEAVY + 1) + 1;
  if (state_len < n_tiles + 3 || heavy_len < (n < heavy_rows ? n : heavy_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  u64* words = (u64*)state;
  unsigned int* next_tile = (unsigned int*)(words + n_tiles);
  long long* total = (long long*)(words + n_tiles + 1);
  u64* heavy_count = words + n_tiles + 2;
  cudaMemsetAsync(state, 0, (size_t)(n_tiles + 3) * sizeof(u64), s);
  if (n_tiles > 0) {
    tiles<<<(unsigned int)n_tiles, THREADS, 0, s>>>(
        (const long long*)order, (const long long*)lo, (const long long*)cnt,
        n, out_cap, words, next_tile, total, heavy_count, (Heavy*)heavy,
        (long long*)probe_idx, (long long*)build_idx,
        (unsigned char*)out_live);
  }
  // `fill` walks its work with as many blocks as the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fill, THREADS, 0);
  unsigned int blocks = ttk::blocks_for(out_cap, THREADS * 8);
  const unsigned int resident = (unsigned int)(sms * per_sm);
  if (blocks > resident && resident > 0) blocks = resident;
  fill<<<blocks, THREADS, 0, s>>>(
      (const long long*)order, n, out_cap, total, heavy_count,
      (const Heavy*)heavy, (long long*)probe_idx, (long long*)build_idx,
      (unsigned char*)out_live);
  return (int)cudaGetLastError();
}
