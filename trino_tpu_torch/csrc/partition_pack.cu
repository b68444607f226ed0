// M1 partition_pack: one shard's rows packed stably into per-destination
// buckets, the send side of the mesh's hash and range exchanges.
//
// Replaces: trino_tpu/parallel/exchange.py:partition_exchange (:25) up to
// its all_to_all, as trino_tpu/exec/mesh.py:exchange_by_dest (:656) runs
// it for hash_exchange (:584) and range_exchange (:594). For every live
// row with destination d in [0, n_parts): pos = the number of earlier
// live rows with destination d (row order: the JAX one-hot cumsum), and
// when pos < B the row's payload goes to bucket slot d * B + pos and its
// sent-live flag is set. Rows with pos >= B are dropped (mode="drop");
// counts[d] reports every live row of d, so counts[d] > B is the
// overflow that escalates the bucket capacity. Every other slot holds
// zeros and a false flag.
//
// Bound on an H100 (3.35 TB/s): live read for every row, dest only for
// live rows and each payload column only for the live rows that fit,
// each bucket column and the sent-live mask written once (the tails of
// zeros included); chip_smoke.py prints it for a 7.5M-row shard of Q3's
// lineitem payload (SF10 on 8 shards). Bytes, not operations, bound it:
// most of them are the bucket tails, which a 2x-capacity bucket makes
// about three quarters of every slot. What holds it back (PERF.md §6,
// torch.profiler on the card): the pass over the rows before the payload
// (live and dest, the ranks, the sort, the look-back) is a chain of
// dependent steps per tile at two blocks an SM, about a third of
// `pack`'s time for a tenth of its bytes, while each payload column runs
// near the card's rate; and `tails` writes at ~2.5 TB/s where a memset
// of the same bytes reaches ~3.1.
//
// Design: one pass over the rows, then one pass over the bucket tails;
// every byte of the buckets and flags is written once, so the caller
// allocates them uninitialised.
// 1. `pack`: each block takes the next tile id from a counter, so tiles
//    start in order and a block only waits on tiles whose blocks already
//    run (it reads `live` for the tile of its own block index meanwhile,
//    which the counter mostly hands it). A tile is THREADS * ITEMS = 4096
//    rows read in stripes of THREADS consecutive rows; `live` is read for
//    every row and `dest` (int32 or int64, as the caller has it) only for
//    live rows. The tile is sorted stably by destination in shared
//    memory: one ballot per destination bit finds a row's peers among its
//    warp's rows of one stripe and ranks it among them, the
//    per-(destination, stripe, warp) counts are scanned in destination-
//    major order, and each row's position in the sorted tile is its
//    group's offset plus its rank. The tile publishes its per-destination
//    counts as status-tagged 64-bit words (n_parts <= 64) and each warp
//    looks back over its predecessors' words, 32 tiles at a time, for the
//    exclusive offsets of its destinations (common.cuh's look_back, which
//    K1 group_ids shares). The sent-live flags, then
//    each payload column (staged in shared memory in row order by
//    coalesced loads), go out run by run from the sorted order:
//    consecutive threads store consecutive slots of one destination, so
//    the stores fill whole sectors. The last tile writes counts.
// 2. `tails`: zeros into slots [min(counts[d], B), B) of every bucket
//    column and false into the flags, read from counts on the card (no
//    host sync); blocks take contiguous shares of a tail and store 16
//    bytes at a time over its aligned middle.
#include <cuda_runtime.h>

#include <stdint.h>

#include "common.cuh"

namespace {

using ttk::u64;
// `pack`: 512 threads of 8 rows each, so the fixed steps of a tile (the
// counter, the scan, the look-back, the barriers) are paid once per 4096
// rows; two blocks per SM (at most 64 registers a thread).
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int PACK_BLOCKS = 2;
constexpr int TAIL_THREADS = 256;
constexpr int MAX_PARTS = 64;
constexpr int MAX_COLS = 32;
// counts per (destination, stripe, warp): SLOTS per destination
constexpr int SLOTS = ITEMS * WARPS;
// the stage holds a column's rows of at least 8 bytes, and first the
// per-(destination, stripe, warp) counts
constexpr int MIN_STAGE_WIDTH = 8;
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_PARTS * SLOTS * 4 <= TILE * MIN_STAGE_WIDTH, "counts fit the stage");

struct Cols {
  const void* in[MAX_COLS];
  void* out[MAX_COLS];
  int width[MAX_COLS];
  int k;
};

struct alignas(8) Pair {
  u64 a, b;
};

template <int W> struct Elem;
template <> struct Elem<1> { using T = unsigned char; };
template <> struct Elem<2> { using T = unsigned short; };
template <> struct Elem<4> { using T = unsigned int; };
template <> struct Elem<8> { using T = u64; };
template <> struct Elem<16> { using T = Pair; };

// The live rows' bits of the tile: bit i for row i * THREADS + t.
__device__ __forceinline__ unsigned live_bits(const unsigned char* live,
                                              long long base, int rows) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = i * THREADS + (int)threadIdx.x;
    if (r < rows && live[base + r]) m |= 1u << i;
  }
  return m;
}

#define PP_BY_WIDTH(w, call)        \
  switch (w) {                      \
    case 1: call(1); break;         \
    case 2: call(2); break;         \
    case 4: call(4); break;         \
    case 8: call(8); break;         \
    default: call(16);              \
  }

// A payload column's live rows staged in shared memory in row order, W
// bytes each; all of a thread's loads go out before its stores. A
// 16-byte row goes as two 8-byte halves (its source may be only 8-byte
// aligned).
template <int W>
__device__ __forceinline__ void stage_column(const void* in, long long base,
                                             unsigned lvm,
                                             unsigned char* stage) {
  using T = typename Elem<W <= 8 ? W : 8>::T;
  constexpr int HALVES = W <= 8 ? 1 : 2;
  const T* col = reinterpret_cast<const T*>(in) + base * HALVES;
  T* buf = reinterpret_cast<T*>(stage);
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    T v[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if ((lvm >> i) & 1u) v[i] = col[(i * THREADS + threadIdx.x) * HALVES + h];
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if ((lvm >> i) & 1u) buf[(i * THREADS + threadIdx.x) * HALVES + h] = v[i];
    }
  }
}

// The staged column written from the sorted order, run by run:
// consecutive threads store consecutive slots of one destination.
template <int W>
__device__ __forceinline__ void write_column(
    void* out, const unsigned char* stage, int tile_live, long long bucket,
    const unsigned short* src, const unsigned char* dsort,
    const int* run_start, const long long* excl) {
  using T = typename Elem<W>::T;
  const T* buf = reinterpret_cast<const T*>(stage);
  T* dst = reinterpret_cast<T*>(out);
  for (int p = threadIdx.x; p < tile_live; p += THREADS) {
    const int d = dsort[p];
    const long long rank = excl[d] + (p - run_start[d]);
    if (rank < bucket) dst[(long long)d * bucket + rank] = buf[src[p]];
  }
}

template <typename D>
__global__ void __launch_bounds__(THREADS, PACK_BLOCKS) pack(
    const D* __restrict__ dest, const unsigned char* __restrict__ live,
    long long n, int n_parts, long long bucket, long long n_tiles, Cols cols,
    unsigned char* __restrict__ sent_live, long long* __restrict__ counts,
    u64* state, unsigned int* next_tile) {
  // the per-(destination, stripe, warp) counts, then each payload
  // column's stage: TILE * max(widest column, MIN_STAGE_WIDTH) bytes
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ unsigned short src[TILE];  // sorted position -> row in tile
  __shared__ unsigned char dsort[TILE];  // sorted position -> destination
  __shared__ int run_start[MAX_PARTS + 1];
  __shared__ long long excl[MAX_PARTS];
  __shared__ long long tile_s;
  int* cnt = reinterpret_cast<int*>(stage);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(next_tile, 1u);
  // tiles are mostly handed out in block order: read `live` for this
  // block's own tile while the counter answers, again if it differs
  long long base = (long long)blockIdx.x * TILE;
  int rows = (int)(n - base < TILE ? n - base : TILE);
  unsigned lvm = rows > 0 ? live_bits(live, base, rows) : 0u;
  const int entries = n_parts * SLOTS;
  for (int i = t; i < entries; i += THREADS) cnt[i] = 0;
  __syncthreads();
  const long long tile = tile_s;
  if (tile != blockIdx.x) {
    base = tile * TILE;
    rows = (int)(n - base < TILE ? n - base : TILE);
    lvm = live_bits(live, base, rows);
  }

  // 1. each row's destination (`dest` read for live rows only) and rank
  // among its warp's rows of one stripe
  const unsigned lt = (1u << lane) - 1u;
  long long dv[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    dv[i] = (lvm >> i) & 1u ? (long long)dest[base + i * THREADS + t] : -1;
  }
  // per row: (destination + 1) << 5 | rank, 0 for none. A row's peers
  // (the warp's rows of its destination) are the AND of one ballot per
  // destination bit, cheaper than __match_any_sync.
  int dbits = 0;
  while ((1 << dbits) < n_parts) ++dbits;
  unsigned short info[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int d = dv[i] >= 0 && dv[i] < n_parts ? (int)dv[i] : -1;
    unsigned peers = __ballot_sync(FULL, d >= 0);
    for (int b = 0; b < dbits; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned set = __ballot_sync(FULL, bit);
      peers &= bit ? set : ~set;
    }
    const int rank = __popc(peers & lt);
    if (d >= 0 && rank == 0) cnt[d * SLOTS + i * WARPS + warp] = __popc(peers);
    info[i] = (unsigned short)(((d + 1) << 5) | rank);
  }
  __syncthreads();

  // 2. the counts scanned in destination-major order: each entry becomes
  // the sorted position of its (destination, stripe, warp) group
  const int per = (entries + THREADS - 1) / THREADS;
  const int first = t * per;
  const int end = first + per < entries ? first + per : entries;
  int sum = 0;
  for (int e = first; e < end; ++e) sum += cnt[e];
  int total;
  int run = ttk::block_inclusive_scan<int, THREADS>(sum, &total) - sum;
  for (int e = first; e < end; ++e) {
    const int c = cnt[e];
    cnt[e] = run;
    run += c;
  }
  __syncthreads();
  const int tile_live = total;
  if (t <= n_parts) run_start[t] = t < n_parts ? cnt[t * SLOTS] : tile_live;
  __syncthreads();
  // publish the tile's counts as early as possible
  if (t < n_parts) {
    ttk::look_back_publish(state + t, tile, n_parts, run_start[t + 1] - run_start[t]);
    if (tile == 0) excl[t] = 0;
  }

  // 3. the sorted tile: each position's row and destination
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int d = (info[i] >> 5) - 1;
    if (d >= 0) {
      const int p = cnt[d * SLOTS + i * WARPS + warp] + (info[i] & 31);
      src[p] = (unsigned short)(i * THREADS + t);
      dsort[p] = (unsigned char)d;
    }
  }
  // 4. the exclusive offsets of each destination (warp w takes d = w,
  // w + WARPS, ...)
  if (tile > 0) {
    for (int d = warp; d < n_parts; d += WARPS) {
      const long long agg = run_start[d + 1] - run_start[d];
      const long long e = ttk::look_back(state + d, tile, n_parts, agg);
      if (lane == 0) excl[d] = e;
    }
  }
  __syncthreads();
  if (tile == n_tiles - 1 && t < n_parts) {
    counts[t] = excl[t] + (run_start[t + 1] - run_start[t]);
  }
  if (tile_live == 0) return;

  // 5. the flags, then every payload column: staged, then written run by
  // run
  if (sent_live != nullptr) {
    for (int p = t; p < tile_live; p += THREADS) {
      const int d = dsort[p];
      const long long rank = excl[d] + (p - run_start[d]);
      if (rank < bucket) sent_live[(long long)d * bucket + rank] = 1;
    }
  }
  for (int c = 0; c < cols.k; ++c) {
    const int w = cols.width[c];
#define PP_STAGE(W) stage_column<W>(cols.in[c], base, lvm, stage)
    PP_BY_WIDTH(w, PP_STAGE)
#undef PP_STAGE
    __syncthreads();
#define PP_WRITE(W) \
  write_column<W>(cols.out[c], stage, tile_live, bucket, src, dsort, run_start, excl)
    PP_BY_WIDTH(w, PP_WRITE)
#undef PP_WRITE
    __syncthreads();  // the stage is reused by the next column
  }
}

// Zero bytes [b0, b1) of p, 16 bytes at a time over the aligned middle;
// block x of gridDim.x takes the x-th contiguous share of it.
__device__ __forceinline__ void zero_range(unsigned char* p, long long b0,
                                           long long b1) {
  const uintptr_t at = (uintptr_t)p;
  long long a0 = (long long)(((at + b0 + 15) & ~(uintptr_t)15) - at);
  long long a1 = (long long)(((at + b1) & ~(uintptr_t)15) - at);
  if (a0 > a1) a0 = a1 = b1;  // too short for an aligned middle
  if (blockIdx.x == 0) {
    for (long long b = b0 + threadIdx.x; b < a0; b += TAIL_THREADS) p[b] = 0;
    for (long long b = a1 + threadIdx.x; b < b1; b += TAIL_THREADS) p[b] = 0;
  }
  uint4* v = reinterpret_cast<uint4*>(p + a0);
  const long long words = (a1 - a0) / 16;
  const long long share = (words + gridDim.x - 1) / gridDim.x;
  const long long w0 = blockIdx.x * share;
  const long long w1 = w0 + share < words ? w0 + share : words;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (long long w = w0 + threadIdx.x; w < w1; w += TAIL_THREADS) v[w] = z;
}

// grid: (chunks, (k + 1) * n_parts): blockIdx.y = column * n_parts + d,
// the column k being the sent-live flags; each tail in gridDim.x shares.
__global__ void __launch_bounds__(TAIL_THREADS) tails(
    const long long* __restrict__ counts, int n_parts, long long bucket,
    Cols cols, unsigned char* sent_live) {
  const int col = blockIdx.y / n_parts;
  const int d = blockIdx.y % n_parts;
  unsigned char* out;
  int width;
  if (col < cols.k) {
    out = (unsigned char*)cols.out[col];
    width = cols.width[col];
  } else {
    if (sent_live == nullptr) return;
    out = sent_live;
    width = 1;
  }
  const long long used = counts[d] < bucket ? counts[d] : bucket;
  zero_range(out, ((long long)d * bucket + used) * width,
             ((long long)d * bucket + bucket) * width);
}

}  // namespace

// dest: [n] int32 (dest64 = 0) or int64 (dest64 = 1) destinations; live:
// [n] bool; state: scratch of ceil(n / 4096) * n_parts + 1 int64s (the
// look-back words and the tile counter; cleared here); counts: [n_parts]
// int64 out (every live row of each destination, dropped ones included);
// desc: k rows of 3 int64s on the host (payload pointer, bucket pointer,
// element width in bytes, each pointer aligned to min(width, 8)); the
// buckets ([n_parts * bucket] elements each) and sent_live
// ([n_parts * bucket], or null to leave the flags alone) are written
// whole, so they need no initial value. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for n_parts outside [1, 64], k outside [0, 32], a
// width other than 1, 2, 4, 8 or 16 or a misaligned pointer.
extern "C" int partition_pack_launch(const void* dest, long long dest64,
                                     const void* live, long long n,
                                     long long n_parts, long long bucket,
                                     void* state, void* counts,
                                     const long long* desc, long long k,
                                     void* sent_live, void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS || k < 0 || k > MAX_COLS) {
    return (int)cudaErrorInvalidValue;
  }
  Cols cols;
  cols.k = (int)k;
  int max_width = 1;
  for (int c = 0; c < cols.k; ++c) {
    cols.in[c] = (const void*)desc[3 * c];
    cols.out[c] = (void*)desc[3 * c + 1];
    cols.width[c] = (int)desc[3 * c + 2];
    const int w = cols.width[c];
    if (w != 1 && w != 2 && w != 4 && w != 8 && w != 16) {
      return (int)cudaErrorInvalidValue;
    }
    const uintptr_t align = (uintptr_t)(w < 8 ? w : 8) - 1;
    if (((uintptr_t)cols.in[c] & align) || ((uintptr_t)cols.out[c] & align)) {
      return (int)cudaErrorInvalidValue;
    }
    if (w > max_width) max_width = w;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + TILE - 1) / TILE;
  if (n_tiles == 0) {
    cudaMemsetAsync(counts, 0, n_parts * sizeof(long long), s);
  } else {
    u64* words = (u64*)state;
    unsigned int* next_tile = (unsigned int*)(words + n_tiles * n_parts);
    cudaMemsetAsync(state, 0, (n_tiles * n_parts + 1) * sizeof(u64), s);
    const int stage_width = max_width > MIN_STAGE_WIDTH ? max_width : MIN_STAGE_WIDTH;
    const int smem = TILE * stage_width;
    if (smem > (48 << 10)) {
      // past the default 48 KB: allowed per function and per device, so
      // on every such call (the caller's device may change between calls)
      const cudaError_t e = dest64
          ? cudaFuncSetAttribute(pack<long long>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
          : cudaFuncSetAttribute(pack<int>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    if (dest64) {
      pack<long long><<<(unsigned int)n_tiles, THREADS, smem, s>>>(
          (const long long*)dest, (const unsigned char*)live, n, (int)n_parts,
          bucket, n_tiles, cols, (unsigned char*)sent_live,
          (long long*)counts, words, next_tile);
    } else {
      pack<int><<<(unsigned int)n_tiles, THREADS, smem, s>>>(
          (const int*)dest, (const unsigned char*)live, n, (int)n_parts,
          bucket, n_tiles, cols, (unsigned char*)sent_live,
          (long long*)counts, words, next_tile);
    }
  }
  const long long regions = (k + 1) * n_parts;
  if (bucket > 0) {
    // ~16 blocks per SM over all tails, each tail's share at least 64 KB
    const long long per_region = (bucket * max_width + (64 << 10) - 1) >> 16;
    long long chunks = (132 * 16 + regions - 1) / regions;
    if (chunks > per_region) chunks = per_region;
    if (chunks < 1) chunks = 1;
    tails<<<dim3((unsigned int)chunks, (unsigned int)regions), TAIL_THREADS, 0, s>>>(
        (const long long*)counts, (int)n_parts, bucket, cols,
        (unsigned char*)sent_live);
  }
  return (int)cudaGetLastError();
}
