// Shared helpers of the hand-written kernels: block-wide scans and sums
// built from warp shuffles (no library collectives), and the key-bit
// reading that the hashing, packing and ordering kernels share.
#pragma once

#include <cuda_runtime.h>

namespace ttk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Inclusive prefix sum of one value per thread across a THREADS-wide
// block. Every thread of the block must call it. *total receives the
// block's sum.
template <typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* total) {
  __shared__ T warp_sums[WARPS];
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
    T w = lane < WARPS ? warp_sums[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  T out = v + (warp > 0 ? warp_sums[warp - 1] : T(0));
  *total = warp_sums[WARPS - 1];
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

inline unsigned int blocks_for(long long n, int per_block) {
  return (unsigned int)((n + per_block - 1) / per_block);
}

// Column element types, as the wrappers in exec/kernels.py number them
// (_TYPE_CODES).
enum ColType : int {
  T_I64 = 0, T_I32 = 1, T_I16 = 2, T_I8 = 3, T_BOOL = 4, T_F64 = 5, T_F32 = 6,
};

typedef unsigned long long u64;

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
