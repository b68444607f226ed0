// W1 window_peers: peer-group starts and ends (and the running peer-group
// count for dense_rank) of a window's sorted rows.
//
// Replaces: trino_tpu/exec/window.py:94-122 (peer boundaries, the
// peer_start max-scan and the peer_end reverse min-scan) and :181-182 (the
// boundary cumsum of dense_rank); rank, row_number and every RANGE frame
// read these. Every window runs it.
//
// In sorted order a row is a peer boundary when it is the first row, its
// partition id differs from the previous row's, or any ORDER BY key part
// differs from the previous row's: the normalized key bits
// (normalize_key, window.py:105: -0.0 equals +0.0, every NaN equals every
// NaN, NULL data zeroed) or the NULL flag, for parts that carry validity
// (the hi limb of a decimal(38) does, its lo limb does not, as in the JAX
// package). peer_start[p] is the last boundary at or before p; peer_end[p]
// is the first boundary after p (n when none), capped at pend[p]; dense[p]
// counts the boundaries at or before p.
//
// Bound on an H100 (3.35 TB/s): gid, perm and pend (24 B) and each key part
// (8 B) read once, peer_start and peer_end (16 B) and dense (8 B) written
// once: 28.8M rows and one key (ds_range7 at SF10) ~1.4 GB, ~0.4 ms. Bytes
// bound it. The key reads through perm are random, each at least a 32 B
// sector from DRAM (the column is larger than L2): on the card they take
// more than half of the time (PERF.md).
//
// Design: a pack of the validity masks, one look-back pass over tiles of
// TILE rows, then a short pass for the rows whose next boundary lies in a
// later tile.
// 0. `pack_valid`: each key part's validity, read once coalesced, becomes
//    a bitmap an eighth of its size, so that its random reads stay in L2
//    while the random reads of the keys pass through it.
// 1. `peers`: a block takes the next tile from a counter. Each warp owns
//    256 consecutive rows, 32 at a time, so gid, perm and pend are read
//    and the outputs written coalesced. Each key part of each row is
//    gathered once through perm; a lane compares with the previous row's
//    bits by a shuffle (lane 0 with the last lane of the warp's previous
//    32 rows, or with the row before the warp, read once by the warp).
//    Ballots count the boundaries: each row's count in the tile, and the
//    tile's boundaries in order in shared memory. A row's peer start is
//    then the boundary at its count, or the last boundary before the
//    tile; its peer end, the next boundary in the tile. The last boundary
//    before the tile (a max) and the boundaries before it (a sum) come
//    from ttk::look_back, warps 0 and 1 at once; both are integers, so
//    the results do not depend on the order tiles finish in.
// 2. Rows from the tile's last boundary on are open: their next boundary
//    is the first of a later tile. `peers` leaves their peer_end and
//    stores the tile's first boundary and first open row. `close_open`
//    takes groups of CLOSE_TILES tiles from the last to the first, finds
//    the first boundary after each group by a reverse look-back (a max
//    of n - boundary) and writes the open rows' peer_end, a warp a tile.
//    A peer group over many tiles is written by the warps of those tiles,
//    not by the tile that closes it. Each output is written once.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::WARPS;
using ttk::u64;
constexpr int ITEMS = 8;
constexpr int WARP_ROWS = ITEMS * 32;
constexpr int TILE = THREADS * ITEMS;
constexpr int MAX_KEYS = 32;
constexpr int CLOSE_TILES = WARPS;  // tiles of a `close_open` block, a warp each
constexpr unsigned FULL = 0xffffffffu;

// The key parts; `valid` is each part's validity as a pack_flags bitmap
// (null: no NULLs).
struct Keys {
  const void* data[MAX_KEYS];
  const unsigned int* valid[MAX_KEYS];
  long long stride[MAX_KEYS];
  int type[MAX_KEYS];
  int k;
};

__global__ void __launch_bounds__(THREADS) pack_valid(
    const unsigned char* __restrict__ valid, long long n,
    unsigned int* __restrict__ bits) {
  ttk::pack_flags(valid, n, bits);
}

// words: the look-back words, the max and the sum of tile j at 2j and
// 2j + 1; rec: each tile's first boundary (n: none), then from n_tiles
// each tile's first open row. Four blocks an SM (64 registers a thread).
__global__ void __launch_bounds__(THREADS, 4) peers(
    Keys keys, const long long* __restrict__ gid,
    const long long* __restrict__ perm, const long long* __restrict__ pend,
    long long n, long long n_tiles, u64* words, unsigned int* next_tile,
    long long* __restrict__ rec, long long* __restrict__ peer_start,
    long long* __restrict__ peer_end, long long* __restrict__ dense) {
  __shared__ int bpos[TILE];  // the tile's boundaries in order (tile rows)
  __shared__ int warp_cnt[WARPS];
  __shared__ long long tile_s, start_s, dense_s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(next_tile, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long t0 = tile * TILE;
  const int l0 = warp * WARP_ROWS + lane;  // row i of this lane: l0 + 32 i
  const long long before = t0 + warp * WARP_ROWS - 1;
  const bool has_before = before >= 0 && before < n;

  // 1. boundaries: partition ids, then each key part through perm
  long long r[ITEMS];
  bool b[ITEMS];
  {
    long long g[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = t0 + l0 + 32 * i;
      g[i] = p < n ? gid[p] : 0;
      r[i] = p < n ? perm[p] : 0;
    }
    long long last = has_before ? gid[before] : 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = t0 + l0 + 32 * i;
      long long prev = __shfl_up_sync(FULL, g[i], 1);
      if (lane == 0) prev = last;
      last = __shfl_sync(FULL, g[i], 31);
      b[i] = p < n && (p == 0 || g[i] != prev);
    }
  }
  const long long r_before = has_before ? perm[before] : 0;
  for (int j = 0; j < keys.k; ++j) {
    const void* data = keys.data[j];
    const unsigned int* valid = keys.valid[j];
    const long long stride = keys.stride[j];
    const int type = keys.type[j];
    u64 bits[ITEMS];
    int nul[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const bool in = t0 + l0 + 32 * i < n;
      nul[i] = in && valid != nullptr && !ttk::flag_bit(valid, r[i]);
      bits[i] = in ? ttk::key_bits(data, type, r[i] * stride) : 0;
    }
    int last_nul = has_before && valid != nullptr && !ttk::flag_bit(valid, r_before);
    u64 last = has_before && !last_nul ? ttk::key_bits(data, type, r_before * stride) : 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (nul[i]) bits[i] = 0;
      u64 prev = __shfl_up_sync(FULL, bits[i], 1);
      int prev_nul = __shfl_up_sync(FULL, nul[i], 1);
      if (lane == 0) {
        prev = last;
        prev_nul = last_nul;
      }
      last = __shfl_sync(FULL, bits[i], 31);
      last_nul = __shfl_sync(FULL, nul[i], 31);
      const long long p = t0 + l0 + 32 * i;
      if (p > 0 && p < n && (bits[i] != prev || nul[i] != prev_nul)) b[i] = true;
    }
  }

  // 2. each row's boundary count in the tile (inclusive), and the tile's
  // boundaries in order
  int c[ITEMS];
  {
    int run = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned m = __ballot_sync(FULL, b[i]);
      c[i] = run + __popc(m & ((2u << lane) - 1u));
      run += __popc(m);
    }
    if (lane == 0) warp_cnt[warp] = run;
  }
  __syncthreads();
  int nb = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = warp_cnt[w];
    if (w < warp) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) c[i] += v;
    }
    nb += v;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (b[i]) bpos[c[i] - 1] = l0 + 32 * i;
  }
  __syncthreads();

  // 3. the carries (warp 0: the last boundary before the tile, plus one;
  // warp 1: the boundaries before it), while the rows up to the tile's
  // last boundary take their peer end from the tile
  const long long last_b = nb > 0 ? t0 + bpos[nb - 1] : -1;
  if (warp == 0) {
    if (lane == 0) ttk::look_back_publish(words, tile, 2, last_b + 1);
    const long long e = ttk::look_back<ttk::LB_MAX>(words, tile, 2, last_b + 1);
    if (lane == 0) {
      start_s = e - 1;
      rec[tile] = nb > 0 ? t0 + bpos[0] : n;
      rec[n_tiles + tile] = nb > 0 ? last_b : t0;
    }
  } else if (warp == 1 && dense != nullptr) {
    if (lane == 0) ttk::look_back_publish(words + 1, tile, 2, nb);
    const long long e = ttk::look_back<ttk::LB_SUM>(words + 1, tile, 2, nb);
    if (lane == 0) dense_s = e;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = t0 + l0 + 32 * i;
    if (p < n && c[i] < nb) {
      const long long next = t0 + bpos[c[i]];
      const long long cap = pend[p];
      peer_end[p] = next < cap ? next : cap;
    }
  }
  __syncthreads();
  const long long start_before = start_s;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = t0 + l0 + 32 * i;
    if (p < n) {
      peer_start[p] = c[i] > 0 ? t0 + bpos[c[i] - 1] : start_before;
      if (dense != nullptr) dense[p] = dense_s + c[i];
    }
  }
}

// The open rows of each tile (from its first open row to its end): their
// peer end is the first boundary of a later tile (n when none).
__global__ void __launch_bounds__(THREADS) close_open(
    const long long* __restrict__ pend, long long n, long long n_tiles,
    const long long* __restrict__ rec, u64* words, unsigned int* next_group,
    long long* __restrict__ peer_end) {
  __shared__ long long first_s[CLOSE_TILES], next_s[CLOSE_TILES];
  __shared__ long long group_s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long groups = (n_tiles + CLOSE_TILES - 1) / CLOSE_TILES;
  if (t == 0) group_s = atomicAdd(next_group, 1u);
  __syncthreads();
  const long long s = group_s;  // scan order: the last tiles first
  const long long tile0 = (groups - 1 - s) * CLOSE_TILES;
  if (warp == 0) {
    const long long tl = tile0 + lane;
    const long long fb = lane < CLOSE_TILES && tl < n_tiles ? rec[tl] : n;
    if (lane < CLOSE_TILES) first_s[lane] = fb;
    // the group's first boundary as a max of n - boundary (0: none)
    long long v = n - fb;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long o = __shfl_xor_sync(FULL, v, d);
      v = o > v ? o : v;
    }
    if (lane == 0) ttk::look_back_publish(words, s, 1, v);
    const long long after = n - ttk::look_back<ttk::LB_MAX>(words, s, 1, v);
    __syncwarp();
    if (lane == 0) {
      long long next = after;
      for (int w = CLOSE_TILES - 1; w >= 0; --w) {
        next_s[w] = next;
        if (first_s[w] < next) next = first_s[w];
      }
    }
  }
  __syncthreads();
  const long long tl = tile0 + warp;
  if (warp < CLOSE_TILES && tl < n_tiles) {
    const long long next = next_s[warp];
    const long long end = (tl + 1) * TILE < n ? (tl + 1) * TILE : n;
#pragma unroll 4
    for (long long p = rec[n_tiles + tl] + lane; p < end; p += 32) {
      const long long cap = pend[p];
      peer_end[p] = next < cap ? next : cap;
    }
  }
}

}  // namespace

// desc: k rows of 4 int64s on the host, one per ORDER BY key part in
// original row order: data pointer, validity pointer (0 = none), stride in
// elements, type (ColType); k may be 0. gid: [n] sorted partition ids;
// perm: [n] the sort permutation; pend: [n] each sorted row's partition
// end. state: int64 scratch of state_len >= 4 * tiles + groups + 2 +
// nullable * ceil(n / 64), with tiles = ceil(n / TILE), groups =
// ceil(tiles / CLOSE_TILES) and nullable the key parts with a validity
// (the look-back words and counters, reset here, the tiles' records, then
// a validity bitmap for each nullable part).
// Outputs: peer_start, peer_end [n]; dense [n] or null. Returns
// cudaErrorInvalidValue, launching nothing, for k outside [0, MAX_KEYS]
// or too small a state, else cudaGetLastError().
extern "C" int window_peers_launch(const long long* desc, long long k,
                                   const void* gid, const void* perm,
                                   const void* pend, long long n, void* state,
                                   long long state_len, void* peer_start,
                                   void* peer_end, void* dense, void* stream) {
  if (k < 0 || k > MAX_KEYS) return (int)cudaErrorInvalidValue;
  const long long n_tiles = n > 0 ? (n + TILE - 1) / TILE : 0;
  const long long groups = (n_tiles + CLOSE_TILES - 1) / CLOSE_TILES;
  const long long reset = 2 * n_tiles + groups + 2;
  const long long bitmap = n > 0 ? (n + 63) / 64 : 0;  // int64 words a bitmap
  int nullable = 0;
  for (int j = 0; j < k; ++j) nullable += desc[4 * j + 1] != 0;
  if (state_len < reset + 2 * n_tiles + nullable * bitmap) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  Keys keys;
  keys.k = (int)k;
  unsigned int* bits = (unsigned int*)((long long*)state + reset + 2 * n_tiles);
  const unsigned int pack_blocks = ttk::blocks_for(n + 3, (int)ttk::PACK_BLOCK);
  for (int j = 0; j < keys.k; ++j) {
    keys.data[j] = (const void*)desc[4 * j];
    keys.valid[j] = nullptr;
    const unsigned char* valid = (const unsigned char*)desc[4 * j + 1];
    if (valid != nullptr) {
      pack_valid<<<pack_blocks, THREADS, 0, s>>>(valid, n, bits);
      keys.valid[j] = bits;
      bits += 2 * bitmap;
    }
    keys.stride[j] = desc[4 * j + 2];
    keys.type[j] = (int)desc[4 * j + 3];
  }
  u64* words = (u64*)state;
  u64* close_words = words + 2 * n_tiles;
  unsigned int* next_tile = (unsigned int*)(close_words + groups);
  unsigned int* next_group = (unsigned int*)(close_words + groups + 1);
  long long* rec = (long long*)state + reset;
  cudaMemsetAsync(state, 0, (size_t)reset * sizeof(u64), s);
  peers<<<(unsigned int)n_tiles, THREADS, 0, s>>>(
      keys, (const long long*)gid, (const long long*)perm,
      (const long long*)pend, n, n_tiles, words, next_tile, rec,
      (long long*)peer_start, (long long*)peer_end, (long long*)dense);
  close_open<<<(unsigned int)groups, THREADS, 0, s>>>(
      (const long long*)pend, n, n_tiles, rec, close_words, next_group,
      (long long*)peer_end);
  return (int)cudaGetLastError();
}
