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
// counts the boundaries at or before p. The keys are read in original row
// order through perm (no sorted copy of them is made), each row's once:
// a thread walks consecutive rows and carries the previous row's bits.
//
// Bound on an H100 (3.35 TB/s): gid, perm and pend (24 B) and each key part
// (8 B) read once, peer_start and peer_end (16 B) and dense (8 B) written
// once: 28.8M rows and one key (ds_range7 at SF10) ~1.4 GB, ~0.4 ms. Bytes
// bound it; the key reads through perm are random.
//
// Design: a two-level scan, as K1 runs its cumsum. Pass 1 gives each block
// a tile of THREADS*ITEMS rows: it writes the boundary flags and the
// tile's last boundary, first boundary and boundary count. Pass 2 (one
// block) turns those into each tile's carries: the last boundary before
// it (a max-scan), the first boundary after it (a reverse min-scan) and
// the boundaries before it (a sum). Pass 3 rescans each tile's flags from
// its carries and writes the outputs.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::u64;
constexpr int ITEMS = 8;
constexpr long long TILE = (long long)THREADS * ITEMS;
constexpr int MAX_KEYS = 32;

struct Keys {
  const void* data[MAX_KEYS];
  const unsigned char* valid[MAX_KEYS];
  long long stride[MAX_KEYS];
  int type[MAX_KEYS];
  int k;
};

struct MaxOp {
  __device__ __forceinline__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};

struct MinOp {
  __device__ __forceinline__ long long operator()(long long a, long long b) const {
    return a < b ? a : b;
  }
};

struct AddOp {
  __device__ __forceinline__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};

__global__ void peer_flags(Keys keys, const long long* gid, const long long* perm,
                           long long n, unsigned char* flag, long long* tile_last,
                           long long* tile_first, long long* tile_cnt) {
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  bool b[ITEMS];
  long long row[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = base + i;
    b[i] = p < n && (p == 0 || gid[p] != gid[p - 1]);
    row[i] = p < n ? perm[p] : 0;
  }
  // each key part of each row read once: the previous row's carried over
  const long long before = base > 0 && base < n ? perm[base - 1] : -1;
  for (int j = 0; j < keys.k; ++j) {
    const void* data = keys.data[j];
    const unsigned char* valid = keys.valid[j];
    bool prev_null = false;
    u64 prev = 0;
    if (before >= 0) {
      prev_null = valid != nullptr && !valid[before];
      if (!prev_null) prev = ttk::key_bits(data, keys.type[j], before * keys.stride[j]);
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = base + i;
      if (p >= n) break;
      const bool is_null = valid != nullptr && !valid[row[i]];
      const u64 bits =
          is_null ? 0ull : ttk::key_bits(data, keys.type[j], row[i] * keys.stride[j]);
      if (p > 0 && (is_null != prev_null || bits != prev)) b[i] = true;
      prev_null = is_null;
      prev = bits;
    }
  }
  long long last = -1, first = n, cnt = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = base + i;
    if (p >= n) break;
    flag[p] = b[i] ? 1 : 0;
    if (b[i]) {
      last = p;
      if (first == n) first = p;
      ++cnt;
    }
  }
  long long excl, total;
  bool has;
  ttk::block_scan_op(last, MaxOp{}, false, &excl, &has, &total);
  if (threadIdx.x == 0) tile_last[blockIdx.x] = total;
  ttk::block_scan_op(first, MinOp{}, false, &excl, &has, &total);
  if (threadIdx.x == 0) tile_first[blockIdx.x] = total;
  ttk::block_scan_op(cnt, AddOp{}, false, &excl, &has, &total);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = total;
}

// One block: tile_last becomes the last boundary before each tile (-1),
// tile_first the first boundary after it (n), tile_cnt the boundaries
// before it, all in place.
__global__ void peer_carries(long long* tile_last, long long* tile_first,
                             long long* tile_cnt, long long num_tiles, long long n) {
  long long excl, total;
  bool has;
  long long carry = -1;
  for (long long c = 0; c < num_tiles; c += THREADS) {
    const long long i = c + threadIdx.x;
    const long long v = i < num_tiles ? tile_last[i] : -1;
    ttk::block_scan_op(v, MaxOp{}, false, &excl, &has, &total);
    if (i < num_tiles) tile_last[i] = has && excl > carry ? excl : carry;
    carry = total > carry ? total : carry;
  }
  long long sum = 0;
  for (long long c = 0; c < num_tiles; c += THREADS) {
    const long long i = c + threadIdx.x;
    const long long v = i < num_tiles ? tile_cnt[i] : 0;
    ttk::block_scan_op(v, AddOp{}, false, &excl, &has, &total);
    if (i < num_tiles) tile_cnt[i] = sum + (has ? excl : 0);
    sum += total;
  }
  // from the last chunk to the first, each scanned from its last thread
  carry = n;
  const long long chunks = (num_tiles + THREADS - 1) / THREADS;
  for (long long ch = chunks - 1; ch >= 0; --ch) {
    const long long i = ch * THREADS + threadIdx.x;
    const long long v = i < num_tiles ? tile_first[i] : n;
    ttk::block_scan_op(v, MinOp{}, true, &excl, &has, &total);
    if (i < num_tiles) tile_first[i] = has && excl < carry ? excl : carry;
    carry = total < carry ? total : carry;
  }
}

__global__ void peer_apply(const unsigned char* flag, const long long* pend,
                           const long long* start_carry, const long long* end_carry,
                           const long long* cnt_carry, long long n,
                           long long* peer_start, long long* peer_end,
                           long long* dense) {
  const long long base = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  unsigned char b[ITEMS];
  long long last = -1, first = n, cnt = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = base + i;
    b[i] = p < n ? flag[p] : 0;
    if (b[i]) {
      last = p;
      if (first == n) first = p;
      ++cnt;
    }
  }
  long long excl, total;
  bool has;
  ttk::block_scan_op(last, MaxOp{}, false, &excl, &has, &total);
  long long run_last = start_carry[blockIdx.x];
  if (has && excl > run_last) run_last = excl;
  ttk::block_scan_op(first, MinOp{}, true, &excl, &has, &total);
  long long next = end_carry[blockIdx.x];
  if (has && excl < next) next = excl;
  ttk::block_scan_op(cnt, AddOp{}, false, &excl, &has, &total);
  long long run_cnt = cnt_carry[blockIdx.x] + (has ? excl : 0);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long p = base + i;
    if (p >= n) break;
    if (b[i]) {
      run_last = p;
      ++run_cnt;
    }
    peer_start[p] = run_last;
    if (dense != nullptr) dense[p] = run_cnt;
  }
#pragma unroll
  for (int i = ITEMS - 1; i >= 0; --i) {
    const long long p = base + i;
    if (p < n) {
      const long long cap = pend[p];
      peer_end[p] = next < cap ? next : cap;
      if (b[i]) next = p;
    }
  }
}

}  // namespace

// desc: k rows of 4 int64s on the host, one per ORDER BY key part in
// original row order: data pointer, validity pointer (0 = none), stride in
// elements, type (ColType); k may be 0. gid: [n] sorted partition ids;
// perm: [n] the sort permutation; pend: [n] each sorted row's partition
// end. Scratch: flag [n] bytes, tile_last, tile_first, tile_cnt
// (ceil(n / 2048) int64 each). Outputs: peer_start, peer_end [n]; dense
// [n] or null. Returns cudaGetLastError(), or cudaErrorInvalidValue for k
// outside [0, MAX_KEYS].
extern "C" int window_peers_launch(const long long* desc, long long k,
                                   const void* gid, const void* perm,
                                   const void* pend, long long n, void* flag,
                                   void* tile_last, void* tile_first,
                                   void* tile_cnt, void* peer_start,
                                   void* peer_end, void* dense, void* stream) {
  if (k < 0 || k > MAX_KEYS) return (int)cudaErrorInvalidValue;
  Keys keys;
  keys.k = (int)k;
  for (int j = 0; j < keys.k; ++j) {
    keys.data[j] = (const void*)desc[4 * j];
    keys.valid[j] = (const unsigned char*)desc[4 * j + 1];
    keys.stride[j] = desc[4 * j + 2];
    keys.type[j] = (int)desc[4 * j + 3];
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + TILE - 1) / TILE;
  peer_flags<<<(unsigned int)tiles, THREADS, 0, s>>>(
      keys, (const long long*)gid, (const long long*)perm, n,
      (unsigned char*)flag, (long long*)tile_last, (long long*)tile_first,
      (long long*)tile_cnt);
  peer_carries<<<1, THREADS, 0, s>>>((long long*)tile_last, (long long*)tile_first,
                                     (long long*)tile_cnt, tiles, n);
  peer_apply<<<(unsigned int)tiles, THREADS, 0, s>>>(
      (const unsigned char*)flag, (const long long*)pend,
      (const long long*)tile_last, (const long long*)tile_first,
      (const long long*)tile_cnt, n, (long long*)peer_start,
      (long long*)peer_end, (long long*)dense);
  return (int)cudaGetLastError();
}
