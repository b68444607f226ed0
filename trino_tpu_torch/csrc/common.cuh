// Shared helpers of the hand-written kernels: block-wide scans and sums
// built from warp shuffles (no library collectives), the decoupled
// look-back of the single-pass scans (K1 group_ids, K4 expand_matches,
// M1 partition_pack, W1 window_peers), the flag bitmaps that keep random
// flag reads in L2 (A3, W1), and the key-bit reading that the hashing,
// packing and ordering kernels share.
#pragma once

#include <cuda_runtime.h>

namespace ttk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Inclusive prefix sum of one value per thread across a block of BLOCK
// threads (at most 1024). Every thread of the block must call it. *total
// receives the block's sum.
template <typename T, int BLOCK = THREADS>
__device__ __forceinline__ T block_inclusive_scan(T v, T* total) {
  constexpr int NW = BLOCK / 32;
  static_assert(BLOCK % 32 == 0 && NW <= 32, "one warp scans the warp sums");
  __shared__ T warp_sums[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NW ? warp_sums[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < NW) warp_sums[lane] = w;
  }
  __syncthreads();
  T out = v + (warp > 0 ? warp_sums[warp - 1] : T(0));
  *total = warp_sums[NW - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return out;
}

// Sum of one value per thread across a THREADS-wide block; the result
// is valid in thread 0. Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  T out = T(0);
  if (warp == 0) {
    out = lane < WARPS ? warp_sums[lane] : T(0);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) out += __shfl_down_sync(0xffffffffu, out, d);
  }
  __syncthreads();
  return out;
}

// Scan of one value per thread across a THREADS-wide block under an
// associative op(earlier, later), in shared memory (Hillis-Steele). With
// `reverse` the scan runs from the last thread to the first. Returns the
// inclusive value; *excl receives the inclusive value of the thread just
// before in scan order (*has_excl false for the first), *total the whole
// block's. Every thread of the block must call it.
template <typename T, typename Op>
__device__ __forceinline__ T block_scan_op(T v, const Op& op, bool reverse,
                                           T* excl, bool* has_excl, T* total) {
  __shared__ T buf[THREADS];
  const int i = reverse ? THREADS - 1 - (int)threadIdx.x : (int)threadIdx.x;
  buf[i] = v;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {
    T prev = v;
    if (i >= d) prev = buf[i - d];
    __syncthreads();
    if (i >= d) {
      v = op(prev, v);
      buf[i] = v;
    }
    __syncthreads();
  }
  *has_excl = i > 0;
  if (i > 0) *excl = buf[i - 1];
  *total = buf[THREADS - 1];
  __syncthreads();  // buf may be reused by the next call
  return v;
}

typedef unsigned long long u64;

// Decoupled look-back (single-pass prefix over tiles taken in order from
// a counter). Each tile publishes a word per value it carries: the status
// in the top two bits, the value below; 0 means not published yet. A
// value is a count carried as a sum (LB_SUM) or a non-negative value
// carried as a max (LB_MAX); 0 is the identity of both.
constexpr u64 LB_AGGREGATE = 1ull << 62;  // the tile's own value
constexpr u64 LB_INCLUSIVE = 2ull << 62;  // the prefix through the tile
constexpr u64 LB_VALUE = (1ull << 62) - 1;

enum LookBackOp : int { LB_SUM = 0, LB_MAX = 1 };

// Publishes tile `tile`'s own value `agg` at words[tile * stride]: as its
// inclusive prefix for tile 0, else as an aggregate. One thread calls it.
__device__ __forceinline__ void look_back_publish(volatile u64* words,
                                                  long long tile,
                                                  long long stride,
                                                  long long agg) {
  words[tile * stride] = (tile == 0 ? LB_INCLUSIVE : LB_AGGREGATE) | (u64)agg;
}

// Exclusive prefix (sum or max, by OP) of tile `tile`, whose own value is
// `agg`, over the words of the tiles before it (tile j's at
// words[j * stride]); called by the 32 lanes of one warp. Lane j reads
// tile last - j, 32 tiles at a time, and combines back to the nearest
// inclusive word, waiting while one of those is unpublished (its block
// is running: tiles start in order). Publishes the tile's inclusive
// prefix; 0 for tile 0.
template <LookBackOp OP = LB_SUM>
__device__ inline long long look_back(volatile u64* words, long long tile,
                                      long long stride, long long agg) {
  if (tile == 0) return 0;
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  long long last = tile - 1;
  for (;;) {
    const long long at = last - lane;
    u64 word = LB_INCLUSIVE;  // before tile 0: an inclusive prefix of 0
    if (at >= 0) word = words[at * stride];
    const unsigned inclusive = __ballot_sync(0xffffffffu, (word >> 62) == 2);
    const unsigned unset = __ballot_sync(0xffffffffu, (word >> 62) == 0);
    // lanes up to the nearest inclusive word (all lanes if none)
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    const unsigned needed = stop == 31 ? 0xffffffffu : (2u << stop) - 1u;
    if (unset & needed) continue;  // a predecessor has not published yet
    long long v = lane <= stop ? (long long)(word & LB_VALUE) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long o = __shfl_down_sync(0xffffffffu, v, d);
      v = OP == LB_SUM ? v + o : (o > v ? o : v);
    }
    const long long w = __shfl_sync(0xffffffffu, v, 0);
    excl = OP == LB_SUM ? excl + w : (w > excl ? w : excl);
    if (inclusive) break;
    last -= 32;
  }
  const long long incl = OP == LB_SUM ? excl + agg : (agg > excl ? agg : excl);
  if (lane == 0) words[tile * stride] = LB_INCLUSIVE | (u64)incl;
  return excl;
}

// Flags a block of pack_flags packs.
constexpr long long PACK_BLOCK = (long long)THREADS * 32;

// Packs block blockIdx.x's share of flags[0, n) (nonzero = set) into bits
// (bit i % 32 of word i / 32), so that random reads of the flags hit a
// bitmap an eighth of their size, which stays in L2. Every thread of a
// THREADS-wide block calls it, and every alignment of flags takes the
// same path: a warp reads 1024 bytes from the 4-byte word that holds
// flags[0] on, 4 a load (the first and last words a byte at a time), 8
// loads in flight; each 8 lanes OR their nibbles into the mask of 32
// bytes, and a funnel shift by flags' address mod 4 with the next mask
// gives the word of 32 flags. The warp's lanes 0-7 read the next 32
// bytes too, for its last word.
__device__ __forceinline__ void pack_flags(const unsigned char* flags,
                                           long long n, unsigned int* bits) {
  constexpr int LOADS = 8;
  constexpr long long WARP_BYTES = 128 * LOADS;
  static_assert(PACK_BLOCK == WARPS * WARP_BYTES, "a warp packs 1024 bytes");
  const int shift = (int)((size_t)flags & 3);
  const unsigned char* word0 = flags - shift;  // 4-byte aligned
  const long long m = n + shift;               // flags end in word0's bytes
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * PACK_BLOCK +
                         (long long)(threadIdx.x >> 5) * WARP_BYTES;
  unsigned int f[LOADS + 1];
#pragma unroll
  for (int k = 0; k <= LOADS; ++k) {
    const long long i = base + 128 * k + 4 * lane;
    unsigned int v = 0;
    if (k < LOADS || lane < 8) {
      if (i >= shift && i + 3 < m) {
        v = *(const unsigned int*)(word0 + i);
      } else {
        for (int b = 0; b < 4; ++b) {
          if (i + b >= shift && i + b < m) v |= (unsigned int)word0[i + b] << (8 * b);
        }
      }
    }
    f[k] = ((v & 0xFFu) != 0) | ((v & 0xFF00u) != 0) << 1 |
           ((v & 0xFF0000u) != 0) << 2 | ((v & 0xFF000000u) != 0) << 3;
  }
#pragma unroll
  for (int k = 0; k <= LOADS; ++k) {
    unsigned int g = f[k] << 4 * (lane & 7);
    g |= __shfl_xor_sync(0xffffffffu, g, 1);
    g |= __shfl_xor_sync(0xffffffffu, g, 2);
    g |= __shfl_xor_sync(0xffffffffu, g, 4);
    f[k] = g;
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    // the mask after this group's: the next group's, or for lanes 24-31
    // the next load's first
    const unsigned int next = __shfl_sync(0xffffffffu, lane < 8 ? f[k + 1] : f[k],
                                          (lane + 8) & 31);
    const long long w = (base + 128 * k) / 32 + (lane >> 3);
    if ((lane & 7) == 0 && 32 * w < n) bits[w] = __funnelshift_r(f[k], next, shift);
  }
}

// Bit i of a pack_flags bitmap.
__device__ __forceinline__ bool flag_bit(const unsigned int* bits, long long i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

inline unsigned int blocks_for(long long n, int per_block) {
  return (unsigned int)((n + per_block - 1) / per_block);
}

// Column element types, as the wrappers in exec/kernels.py number them
// (_TYPE_CODES).
enum ColType : int {
  T_I64 = 0, T_I32 = 1, T_I16 = 2, T_I8 = 3, T_BOOL = 4, T_F64 = 5, T_F32 = 6,
};

// The canonical quiet NaN of numpy/torch/jax (float("nan")).
constexpr u64 NAN64_BITS = 0x7FF8000000000000ull;
constexpr unsigned int NAN32_BITS = 0x7FC00000u;

// Element i of a column (stride in elements) as the u64 key bits of
// trino_tpu/exec/kernels.py:_to_bits: integers sign-extend, bools are
// 0/1, floats are canonicalized (-0.0 -> +0.0, every NaN -> one NaN)
// and reinterpreted; float32 bits zero-extend.
__device__ __forceinline__ u64 key_bits(const void* data, int type,
                                        long long i) {
  switch (type) {
    case T_I64: return (u64)((const long long*)data)[i];
    case T_I32: return (u64)(long long)((const int*)data)[i];
    case T_I16: return (u64)(long long)((const short*)data)[i];
    case T_I8: return (u64)(long long)((const signed char*)data)[i];
    case T_BOOL: return ((const unsigned char*)data)[i] ? 1ull : 0ull;
    case T_F64: {
      const double v = ((const double*)data)[i];
      if (v != v) return NAN64_BITS;
      return v == 0.0 ? 0ull : (u64)__double_as_longlong(v);
    }
    default: {  // T_F32
      const float v = ((const float*)data)[i];
      if (v != v) return (u64)NAN32_BITS;
      return v == 0.0f ? 0ull : (u64)__float_as_uint(v);
    }
  }
}

}  // namespace ttk
