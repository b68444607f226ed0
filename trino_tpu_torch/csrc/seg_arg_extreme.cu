// A3 seg_arg_extreme: the row of each group's key-extremal contributing
// row (max_by / min_by).
//
// Replaces: trino_tpu/exec/kernels.py:seg_arg_extreme (:414), with
// order_bits (:401) fused into the key read. The JAX package runs one
// segmented associative scan over (group, contributing, key, position)
// tuples; its tie rule is: a contributing row beats one that does not
// contribute, whatever its key; among contributing rows the better key
// wins; equal keys go to the first sorted position. A group with no
// contributing row takes its first position (the JAX package returns
// another garbage row there; both are masked by count > 0).
// Keys are read through the group permutation in their own type and
// encoded as order_bits: integers as their value, bools 0/1, floats with
// -0.0 equal to +0.0 and every NaN one value above +inf.
//
// Bound on an H100 (3.35 TB/s): perm (8 B) and contrib (1 B) read once per
// live row, the key (8 B) once per contributing live row, group starts
// and ends read and the rows written once (8 B a slot each). In the
// TPC-DS SF10 cases (28.8M rows, 97% live, 58% live and contributing)
// that is ~0.39 GB, ~0.12 ms. The key and contrib reads go through perm,
// so they are random: each costs at least a 32 B sector, and the key's
// come from DRAM (the column is larger than L2). On the card the key's
// random reads take most of the time (PERF.md).
//
// Design: a pack of contrib, one pass over the sorted positions in tiles
// of TILE, then a short fix-up.
// 0. `pack_contrib`: contrib, read once coalesced, becomes a bitmap an
//    eighth of its size, so that its random reads stay in L2 while the
//    random reads of the keys pass through it.
// 1. `tiles`: a block reads its tile's perm coalesced (consecutive
//    threads on consecutive positions), then the contrib bits through
//    it, then the key of the contributing rows only. Warps 0 and 1 find
//    the tile's first and last group in `ends` (32 probes a step), and
//    the tile's group ends are staged in shared memory, where each row
//    finds its group (group ranges are dense, so a tile meets at most
//    TILE groups). A row is the tuple (key, position) with the
//    key flipped for max (~key reverses signed order), so the best row
//    is the least tuple; a row that does not contribute is (max, none).
//    Each warp reduces its 32 consecutive rows by group with shuffles
//    (one butterfly when all 32 share a group), and the first lane of
//    each run combines into the group's shared slot: a 64-bit atomic
//    min of the key, a barrier, then an atomic min of the position for
//    the runs at that key. A group that starts and ends in the tile is
//    finished there: perm[position] is written directly.
// 2. At most two groups cross a tile's edges: its first (started in an
//    earlier tile) and its last (ends in a later one). The tile stores
//    a carry (key, position) for each, and the id of the group it
//    closes (its first, when that ends inside it).
// 3. `fixup`: one warp per closing tile combines the carries of the
//    tiles its group spans, 32 tiles a step, and writes the group's row;
//    the same grid writes every empty group's row (its first position).
// Nothing is read twice from memory, and no per-row search touches
// device memory.
#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::u64;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // sorted positions per tile
constexpr u64 SIGN = 0x8000000000000000ull;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ROW = INT_MAX;          // no contributing row (in a tile)
constexpr long long NO_POS = LLONG_MAX;  // no contributing row (a carry)

// order_bits of element i in the signed form (u64 order bits ^ bit 63)
__device__ __forceinline__ long long order_key(const void* keys, int type,
                                               long long i) {
  const u64 c = ttk::key_bits(keys, type, i);
  switch (type) {
    case ttk::T_BOOL:
      return (long long)(c ^ SIGN);
    case ttk::T_F64:
      return (long long)((c >> 63) ? (~c ^ SIGN) : c);
    case ttk::T_F32: {
      const u64 u = (c & 0x80000000ull) ? (c ^ 0xFFFFFFFFull)
                                        : (c ^ 0x80000000ull);
      return (long long)(u ^ SIGN);
    }
    default:  // integers: the sign-extended value
      return (long long)c;
  }
}

// (kb, pb) is the better row: the lesser key, then the first position
template <typename P>
__device__ __forceinline__ bool beats(long long kb, P pb, long long ka, P pa) {
  return kb < ka || (kb == ka && pb < pa);
}

// The first g in [lo, hi] with ends[g] > x (hi when none): one warp, all
// lanes, 32 probes a step.
__device__ long long warp_upper(const long long* ends, long long lo,
                                long long hi, long long x) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long span = hi - lo;
    const unsigned above = __ballot_sync(FULL, ends[lo + (span * lane >> 5)] > x);
    if (above & 1u) return lo;
    if (above == 0) {
      lo += (span * 31 >> 5) + 1;
    } else {
      const int f = __ffs(above) - 1;
      hi = lo + (span * f >> 5);
      lo += (span * (f - 1) >> 5) + 1;
    }
  }
  return lo;
}

// The first j in [lo, hi] with e[j] > x (hi when none).
__device__ __forceinline__ int upper(const long long* e, int lo, int hi,
                                     long long x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] > x) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// The carries of tile b (each an array of n_tiles): the key and position
// of its first group's rows in it, and of its last group's, and the group
// it closes (-1 if none).
struct Carries {
  long long *first_key, *first_pos, *last_key, *last_pos, *closes;
};

__global__ void __launch_bounds__(THREADS) pack_contrib(
    const unsigned char* __restrict__ contrib, long long n,
    unsigned int* __restrict__ bits) {
  ttk::pack_flags(contrib, n, bits);
}

// Four blocks an SM (64 registers a thread): the random reads of more
// rows in flight.
__global__ void __launch_bounds__(THREADS, 4) tiles(
    const void* keys, int type, const unsigned int* __restrict__ contrib,
    const long long* __restrict__ perm, const long long* __restrict__ starts,
    const long long* __restrict__ ends, long long capacity, int is_min,
    Carries carry, long long* __restrict__ out) {
  // the tile's group ends while rows find their group, then each group's
  // best key; a tile holds at most TILE groups (dense group ranges)
  __shared__ long long s_key[TILE];
  __shared__ int s_pos[TILE];
  __shared__ long long s_g[2];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long n_end = ends[capacity - 1];
  const long long t0 = (long long)blockIdx.x * TILE;
  if (t0 >= n_end) return;  // uniform across the block
  const long long t1 = t0 + TILE < n_end ? t0 + TILE : n_end;
  const int rows = (int)(t1 - t0);

  // 1. perm coalesced, contrib through it, the key of contributing rows
  long long kk[ITEMS];
  int pp[ITEMS];
  {
    long long r[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int l = i * THREADS + t;
      r[i] = l < rows ? perm[t0 + l] : -1;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      pp[i] = r[i] >= 0 && ttk::flag_bit(contrib, r[i]) ? i * THREADS + t : NO_ROW;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      kk[i] = LLONG_MAX;
      if (pp[i] != NO_ROW) {
        const long long k = order_key(keys, type, r[i]);
        kk[i] = is_min ? k : ~k;
      }
    }
  }
  // the tile's first and last groups (warps 0 and 1 together)
  if (warp < 2) {
    const long long g = warp_upper(ends, 0, capacity - 1, warp == 0 ? t0 : t1 - 1);
    if (lane == 0) s_g[warp] = g;
  }
  __syncthreads();
  const long long g0 = s_g[0];
  const int ng = (int)(s_g[1] - g0 + 1);
  for (int j = t; j < ng; j += THREADS) s_key[j] = ends[g0 + j];
  __syncthreads();

  // 2. each row's group in the tile (-1 past its end)
  int lg[ITEMS];
  {
    int lo = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int l = i * THREADS + t;
      lg[i] = -1;
      if (l < rows) {
        lo = upper(s_key, lo, ng - 1, t0 + l);
        lg[i] = lo;
      }
    }
  }
  __syncthreads();  // s_key is reused below

  // 3. each warp's runs of one group: the run's best row at its first lane
  bool head[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    long long k = kk[i];
    int p = pp[i];
    const int g = lg[i];
    if (__all_sync(FULL, g == __shfl_sync(FULL, g, 0))) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const long long ok = __shfl_xor_sync(FULL, k, d);
        const int op = __shfl_xor_sync(FULL, p, d);
        if (beats(ok, op, k, p)) {
          k = ok;
          p = op;
        }
      }
      head[i] = lane == 0;
    } else {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long ok = __shfl_down_sync(FULL, k, d);
        const int op = __shfl_down_sync(FULL, p, d);
        const int og = __shfl_down_sync(FULL, g, d);
        if (og == g && beats(ok, op, k, p)) {
          k = ok;
          p = op;
        }
      }
      const int before = __shfl_up_sync(FULL, g, 1);
      head[i] = lane == 0 || before != g;
    }
    head[i] = head[i] && g >= 0;
    kk[i] = k;
    pp[i] = p;
  }

  // 4. the runs into their group's slot
  for (int j = t; j < ng; j += THREADS) {
    s_key[j] = LLONG_MAX;
    s_pos[j] = NO_ROW;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (head[i] && pp[i] != NO_ROW) atomicMin(&s_key[lg[i]], kk[i]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (head[i] && pp[i] != NO_ROW && kk[i] == s_key[lg[i]]) {
      atomicMin(&s_pos[lg[i]], pp[i]);
    }
  }
  __syncthreads();
  // 5. groups inside the tile are done; the edge groups leave carries
  for (int j = t; j < ng; j += THREADS) {
    const long long g = g0 + j;
    const long long s = starts[g];
    const long long e = ends[g];
    if (j == 0) carry.closes[blockIdx.x] = s < t0 && e <= t1 ? g : -1;
    const long long best = s_pos[j] == NO_ROW ? NO_POS : t0 + s_pos[j];
    if (s >= t0 && e <= t1) {
      out[g] = perm[best == NO_POS ? s : best];
      continue;
    }
    if (s < t0) {
      carry.first_key[blockIdx.x] = s_key[j];
      carry.first_pos[blockIdx.x] = best;
    }
    if (e > t1) {
      carry.last_key[blockIdx.x] = s_key[j];
      carry.last_pos[blockIdx.x] = best;
    }
  }
}

__global__ void __launch_bounds__(THREADS) fixup(
    const long long* __restrict__ perm, const long long* __restrict__ starts,
    const long long* __restrict__ ends, long long n, long long capacity,
    Carries carry, long long* __restrict__ out) {
  const long long n_end = ends[capacity - 1];
  const long long used = (n_end + TILE - 1) / TILE;
  const int lane = threadIdx.x & 31;
  const long long thread = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  // a group over several tiles: the warp of the tile that closes it
  for (long long b = thread >> 5; b < used; b += stride >> 5) {
    const long long g = carry.closes[b];
    if (g < 0) continue;  // uniform across the warp
    const long long s = starts[g];
    const long long a = s / TILE;
    long long k = LLONG_MAX, p = NO_POS;
    if (lane == 0) {
      k = carry.last_key[a];
      p = carry.last_pos[a];
    }
    for (long long j = a + 1 + lane; j <= b; j += 32) {
      const long long kj = carry.first_key[j];
      const long long pj = carry.first_pos[j];
      if (beats(kj, pj, k, p)) {
        k = kj;
        p = pj;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long ok = __shfl_xor_sync(FULL, k, d);
      const long long op = __shfl_xor_sync(FULL, p, d);
      if (beats(ok, op, k, p)) {
        k = ok;
        p = op;
      }
    }
    if (lane == 0) out[g] = perm[p == NO_POS ? s : p];
  }
  // empty groups take their first position
  for (long long g = thread; g < capacity; g += stride) {
    const long long s = starts[g];
    if (s != ends[g]) continue;
    const long long p = s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
    out[g] = n > 0 ? perm[p] : 0;
  }
}

}  // namespace

// keys: [n] raw key column in original row order, type its ColType;
// contrib: [n] bool, original row order; perm: [n] the group sort
// permutation; starts/ends: [capacity] dense contiguous group ranges of
// sorted positions (dense: no empty group before a used one, as group_by
// gives them); state: int64 scratch of state_len >= 5 * ceil(n / TILE) +
// ceil(n / 64) (the tiles' carries, then the contrib bitmap;
// nothing to reset); out: [capacity]
// the original row of each group's best contributing row. Returns
// cudaErrorInvalidValue, launching nothing, when state is too small, else
// cudaGetLastError().
extern "C" int seg_arg_extreme_launch(const void* keys, long long type,
                                      const void* contrib, const void* perm,
                                      const void* starts, const void* ends,
                                      long long n, long long capacity,
                                      long long is_min, void* state,
                                      long long state_len, void* out,
                                      void* stream) {
  if (capacity <= 0) return (int)cudaGetLastError();
  const long long n_tiles = (n + TILE - 1) / TILE;
  if (state_len < 5 * n_tiles + (n + 63) / 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* st = (long long*)state;
  const Carries carry{st, st + n_tiles, st + 2 * n_tiles, st + 3 * n_tiles,
                      st + 4 * n_tiles};
  unsigned int* bits = (unsigned int*)(st + 5 * n_tiles);
  if (n_tiles > 0) {
    pack_contrib<<<ttk::blocks_for(n + 3, (int)ttk::PACK_BLOCK), THREADS, 0, s>>>(
        (const unsigned char*)contrib, n, bits);
    tiles<<<(unsigned int)n_tiles, THREADS, 0, s>>>(
        keys, (int)type, bits, (const long long*)perm,
        (const long long*)starts, (const long long*)ends, capacity,
        (int)is_min, carry, (long long*)out);
  }
  const long long work = n_tiles * 32 > capacity ? n_tiles * 32 : capacity;
  unsigned int blocks = ttk::blocks_for(work, THREADS);
  if (blocks > 4096) blocks = 4096;
  fixup<<<blocks, THREADS, 0, s>>>(
      (const long long*)perm, (const long long*)starts, (const long long*)ends,
      n, capacity, carry, (long long*)out);
  return (int)cudaGetLastError();
}
