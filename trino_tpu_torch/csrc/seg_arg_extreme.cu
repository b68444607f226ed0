// A3 seg_arg_extreme: the row of each group's key-extremal contributing
// row (max_by / min_by).
//
// Replaces: trino_tpu/exec/kernels.py:seg_arg_extreme (:414), with
// order_bits (:401) fused into the key read. The JAX package runs one
// segmented associative scan over (group, contributing, key, position)
// tuples; its tie rule is: a contributing row beats one that does not
// contribute, whatever its key; among contributing rows the better key
// wins; equal keys go to the first sorted position. The tuple is 128
// bits wide, so no single atomic compares it. Here it is two passes in
// K9's tile structure (csrc/seg_minmax.cu) and a finish over the groups:
//   1. the best order-bits key of each group's contributing rows, by a
//      64-bit atomic min/max of the signed form (the u64 bits with bit 63
//      flipped), starting from the worst key;
//   2. the least sorted position among the contributing rows at that
//      key, by an atomic min;
//   3. perm[position]; a group with no contributing row takes its first
//      position (the JAX package returns another garbage row there; both
//      are masked by count > 0).
// A contributing row whose key equals the start value still wins, since
// pass 2 tests the contribution flag, not the key alone.
// Keys are read through the group permutation in their own type and
// encoded as order_bits: integers as their value, bools 0/1, floats with
// -0.0 equal to +0.0 and every NaN one value above +inf.
//
// Bound on an H100 (3.35 TB/s): perm (8 B), the key (8 B) and contrib
// (1 B) read once per row, group ends and the rows written once:
// 28.8M rows ~ 28.8M x 17 B ~ 0.15 ms.
#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::WARPS;
using ttk::u64;
constexpr int ITEMS = 8;
constexpr long long TILE = (long long)THREADS * ITEMS;
constexpr u64 SIGN = 0x8000000000000000ull;

// first g in [lo, hi] with ends[g] > row
__device__ __forceinline__ long long find_group(const long long* ends,
                                                long long lo, long long hi,
                                                long long row) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ends[mid] > row) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

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

__device__ __forceinline__ long long better(long long a, long long b,
                                            bool is_min) {
  return is_min ? (b < a ? b : a) : (b > a ? b : a);
}

// Block-wide min (is_min) or max of one value per thread; valid in thread 0.
__device__ __forceinline__ long long block_reduce(long long v, bool is_min) {
  __shared__ long long warp_vals[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = better(v, __shfl_down_sync(0xffffffffu, v, d), is_min);
  }
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_vals[lane < WARPS ? lane : 0];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      v = better(v, __shfl_down_sync(0xffffffffu, v, d), is_min);
    }
  }
  return v;
}

__device__ __forceinline__ void combine(long long* at, long long v,
                                        bool is_min) {
  if (is_min) {
    atomicMin(at, v);
  } else {
    atomicMax(at, v);
  }
}

__global__ void init_kernel(long long* best, long long* pos, long long capacity,
                            long long worst) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < capacity) {
    best[g] = worst;
    pos[g] = LLONG_MAX;
  }
}

// PASS 1 (find_pos false): best[g] = the best key of g's contributing
// rows. PASS 2 (find_pos true): pos[g] = the least sorted position of
// g's contributing rows whose key is best[g].
template <bool FIND_POS>
__global__ void pass_kernel(const void* keys, int type,
                            const unsigned char* contrib,
                            const long long* perm, const long long* ends,
                            long long capacity, int is_min_i, long long worst,
                            long long* best, long long* pos) {
  __shared__ long long s_g0, s_g1;
  const bool is_min = is_min_i != 0;
  // pass 2 reduces positions by min; pass 1 keys by min or max
  const bool red_min = FIND_POS ? true : is_min;
  const long long none = FIND_POS ? LLONG_MAX : worst;
  const long long n_end = ends[capacity - 1];
  const long long t0 = (long long)blockIdx.x * TILE;
  if (t0 >= n_end) return;  // uniform across the block
  const long long t1 = t0 + TILE < n_end ? t0 + TILE : n_end;
  if (threadIdx.x == 0) {
    s_g0 = find_group(ends, 0, capacity - 1, t0);
    s_g1 = find_group(ends, s_g0, capacity - 1, t1 - 1);
  }
  __syncthreads();
  const long long g0 = s_g0, g1 = s_g1;
  long long* out = FIND_POS ? pos : best;
  if (g0 == g1) {
    long long acc = none;
    const long long target = FIND_POS ? best[g0] : 0;
    for (long long p = t0 + threadIdx.x; p < t1; p += THREADS) {
      const long long r = perm[p];
      if (!contrib[r]) continue;
      const long long k = order_key(keys, type, r);
      if (FIND_POS) {
        if (k == target && p < acc) acc = p;
      } else {
        acc = better(acc, k, is_min);
      }
    }
    acc = block_reduce(acc, red_min);
    if (threadIdx.x == 0 && acc != none) combine(&out[g0], acc, red_min);
    return;
  }
  long long p = t0 + (long long)threadIdx.x * ITEMS;
  const long long pend = p + ITEMS < t1 ? p + ITEMS : t1;
  if (p >= pend) return;
  long long g = find_group(ends, g0, g1, p);
  long long acc = none;
  long long target = FIND_POS ? best[g] : 0;
  for (; p < pend; ++p) {
    if (ends[g] <= p) {
      if (acc != none) combine(&out[g], acc, red_min);
      acc = none;
      do {
        ++g;
      } while (ends[g] <= p);
      if (FIND_POS) target = best[g];
    }
    const long long r = perm[p];
    if (!contrib[r]) continue;
    const long long k = order_key(keys, type, r);
    if (FIND_POS) {
      if (k == target && acc == none) acc = p;  // rows walk in order
    } else {
      acc = better(acc, k, is_min);
    }
  }
  if (acc != none) combine(&out[g], acc, red_min);
}

__global__ void finish_kernel(const long long* perm, const long long* starts,
                              long long n, long long capacity,
                              long long* pos) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= capacity) return;
  long long p = pos[g];
  if (p == LLONG_MAX) p = starts[g];
  if (p < 0) p = 0;
  if (p > n - 1) p = n - 1;
  pos[g] = n > 0 ? perm[p] : 0;
}

}  // namespace

// keys: [n] raw key column in original row order, type its ColType;
// contrib: [n] bool, original row order; perm: [n] the group sort
// permutation; starts/ends: [capacity] dense contiguous group ranges of
// sorted positions; best: [capacity] int64 scratch; out: [capacity] the
// original row of each group's best contributing row. Returns
// cudaGetLastError().
extern "C" int seg_arg_extreme_launch(const void* keys, long long type,
                                      const void* contrib, const void* perm,
                                      const void* starts, const void* ends,
                                      long long n, long long capacity,
                                      long long is_min, void* best, void* out,
                                      void* stream) {
  if (capacity <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long worst = is_min ? LLONG_MAX : LLONG_MIN;
  const unsigned int gblocks = ttk::blocks_for(capacity, THREADS);
  init_kernel<<<gblocks, THREADS, 0, s>>>((long long*)best, (long long*)out,
                                          capacity, worst);
  if (n > 0) {
    const unsigned int blocks = ttk::blocks_for(n, (int)TILE);
    pass_kernel<false><<<blocks, THREADS, 0, s>>>(
        keys, (int)type, (const unsigned char*)contrib,
        (const long long*)perm, (const long long*)ends, capacity,
        (int)is_min, worst, (long long*)best, (long long*)out);
    pass_kernel<true><<<blocks, THREADS, 0, s>>>(
        keys, (int)type, (const unsigned char*)contrib,
        (const long long*)perm, (const long long*)ends, capacity,
        (int)is_min, worst, (long long*)best, (long long*)out);
  }
  finish_kernel<<<gblocks, THREADS, 0, s>>>(
      (const long long*)perm, (const long long*)starts, n, capacity,
      (long long*)out);
  return (int)cudaGetLastError();
}
