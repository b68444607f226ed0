// A1 hll_registers and A2 hll_estimate: approx_distinct's HyperLogLog.
//
// Replaces: trino_tpu/exec/aggregates.py:_hll_registers (:460) with
// dev_hash64 (:436) and _clz64 (:424) fused, and _hll_estimate (:489).
//
// A1. Each contributing row's 64-bit hash h (the lane itself, or the
// splitmix64 finalizer of an int64 or float64 value, -0.0 folded into
// +0.0 and NaN payloads kept, as dev_hash64) picks the register
// bucket = h >> (64 - b) of its group and offers rho = clz(h << b) + 1,
// clamped to [1, 64 - b + 1]; each register keeps the largest rho. The
// JAX package sorts key * 64 + 63 - rho because XLA has no scatter-max
// worth using; here every row updates its register directly, in original
// row order, so there is no sort. CUDA has no byte atomics: a register
// update is a 32-bit compare-and-swap on the word that holds the byte,
// skipped when the stored byte is already >= rho, so a hot value costs
// one read. The global form (one group, m <= 8192) keeps a block-private
// table of m 32-bit registers in shared memory and merges it into the
// int8 output once per block. The output stays int8[caps, m], as in the
// JAX package (an int32 state at 1.5M groups x 512 would be 3 GB).
//
// A2. One warp per register row: the float64 sum of 2^-reg and the count
// of zero registers, then alpha m^2 / sum, the linear-counting branch
// m log(m / v) when that is <= 2.5 m and v > 0, rounded half to even.
// Each term 2^-r is built from its exponent bits, so it is exact; the
// sum is exact in any order while the largest register is <= 53 - log2 m
// (41 for m = 4096, 44 for m = 512), so the estimate equals the plain
// version's up to the last ulp of log().
//
// Bound on an H100 (3.35 TB/s): A1 reads the lane (8 B), contrib (1 B)
// and the group id (8 B) once per row and writes the registers once:
// 28.8M rows into 180K x 512 registers ~ 28.8M x 17 B + 92 MB ~ 0.17 ms.
// A2 reads the registers once: 92 MB ~ 0.03 ms.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::u64;

constexpr int GLOBAL_MAX_M = 8192;
constexpr int ITEMS = 8;

__device__ __forceinline__ u64 splitmix(u64 v) {
  v ^= v >> 30;
  v *= 0xBF58476D1CE4E5B9ull;
  v ^= v >> 27;
  v *= 0x94D049BB133111EBull;
  v ^= v >> 31;
  return v;
}

// mode 0: the lane is the hash; 1: hash an int64 value; 2: hash a float64
__device__ __forceinline__ u64 lane_hash(const void* lane, int mode,
                                         long long i) {
  u64 v = (u64)((const long long*)lane)[i];
  if (mode == 0) return v;
  if (mode == 2 && (v << 1) == 0) v = 0;  // -0.0 -> +0.0 (only)
  return splitmix(v);
}

__device__ __forceinline__ void bucket_rho(u64 h, int b, long long* bucket,
                                           unsigned int* rho) {
  *bucket = (long long)(h >> (64 - b));
  const u64 w = h << b;
  const int top = 64 - b + 1;
  const int r = w == 0 ? top : __clzll((long long)w) + 1;
  *rho = (unsigned int)(r < top ? r : top);
}

// reg[idx] = max(reg[idx], v) on a byte, by CAS on its aligned word
__device__ __forceinline__ void byte_max(unsigned char* reg, long long idx,
                                         unsigned int v) {
  unsigned char* p = reg + idx;
  if (*((volatile unsigned char*)p) >= v) return;
  unsigned int* word = (unsigned int*)((size_t)p & ~(size_t)3);
  const unsigned int shift = (unsigned int)((size_t)p & 3) * 8u;
  unsigned int old = *((volatile unsigned int*)word);
  while (true) {
    if (((old >> shift) & 0xFFu) >= v) return;
    const unsigned int nw = (old & ~(0xFFu << shift)) | (v << shift);
    const unsigned int seen = atomicCAS(word, old, nw);
    if (seen == old) return;
    old = seen;
  }
}

__global__ void hll_grouped_kernel(const void* lane, int mode,
                                   const unsigned char* contrib,
                                   const long long* group, long long n,
                                   int b, long long caps,
                                   unsigned char* reg) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!contrib[i]) continue;
    const long long g = group == nullptr ? 0 : group[i];
    if (g < 0 || g >= caps) continue;
    long long bucket;
    unsigned int rho;
    bucket_rho(lane_hash(lane, mode, i), b, &bucket, &rho);
    byte_max(reg, (g << b) + bucket, rho);
  }
}

__global__ void hll_global_kernel(const void* lane, int mode,
                                  const unsigned char* contrib, long long n,
                                  int b, unsigned char* reg) {
  extern __shared__ unsigned int s_reg[];
  const int m = 1 << b;
  for (int j = threadIdx.x; j < m; j += blockDim.x) s_reg[j] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!contrib[i]) continue;
    long long bucket;
    unsigned int rho;
    bucket_rho(lane_hash(lane, mode, i), b, &bucket, &rho);
    if (s_reg[bucket] < rho) atomicMax(&s_reg[bucket], rho);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    if (s_reg[j] != 0) byte_max(reg, j, s_reg[j]);
  }
}

__global__ void hll_estimate_kernel(const signed char* reg, long long c, int m,
                                    long long* out) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= c) return;  // uniform across the warp
  const signed char* r = reg + row * (long long)m;
  double s = 0.0;
  int zeros = 0;
  for (int j = lane; j < m; j += 32) {
    const int v = r[j];
    s += __longlong_as_double((long long)(1023 - v) << 52);  // 2^-v
    zeros += v == 0;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, d);
    zeros += __shfl_down_sync(0xffffffffu, zeros, d);
  }
  if (lane == 0) {
    const double md = (double)m;
    const double alpha = 0.7213 / (1.0 + 1.079 / md);
    const double raw = alpha * md * md / s;
    const double v = (double)zeros;
    const double est = (raw <= 2.5 * md && v > 0.0) ? md * log(md / v) : raw;
    out[row] = (long long)rint(est);
  }
}

int log2_of(long long m) {
  int b = 0;
  while ((1LL << b) < m) ++b;
  return b;
}

}  // namespace

// lane: [n] int64 (mode 0: u64 hash bits; 1: int64 values to hash) or
// float64 values to hash (mode 2); contrib: [n] bool; group: [n] int64
// group ids or null (every row in group 0); reg: int8[caps, m], zero on
// entry, m a power of two. Returns cudaGetLastError().
extern "C" int hll_registers_launch(const void* lane, long long mode,
                                    const void* contrib, const void* group,
                                    long long n, long long m, long long caps,
                                    void* reg, void* stream) {
  if (n <= 0 || caps <= 0) return (int)cudaGetLastError();
  const int b = log2_of(m);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int blocks = ttk::blocks_for(n, THREADS * ITEMS);
  if (group == nullptr && caps == 1 && m <= GLOBAL_MAX_M) {
    // block-private tables: few enough blocks that the merges stay small
    if (blocks > 132 * 8) blocks = 132 * 8;
    const size_t shmem = sizeof(unsigned int) * (size_t)m;
    hll_global_kernel<<<blocks, THREADS, shmem, s>>>(
        lane, (int)mode, (const unsigned char*)contrib, n, b,
        (unsigned char*)reg);
  } else {
    hll_grouped_kernel<<<blocks, THREADS, 0, s>>>(
        lane, (int)mode, (const unsigned char*)contrib,
        (const long long*)group, n, b, caps, (unsigned char*)reg);
  }
  return (int)cudaGetLastError();
}

// reg: int8[c, m] registers; out: [c] int64 estimates.
extern "C" int hll_estimate_launch(const void* reg, long long c, long long m,
                                   void* out, void* stream) {
  if (c > 0) {
    const long long threads = c * 32;
    hll_estimate_kernel<<<ttk::blocks_for(threads, THREADS), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const signed char*)reg, c, (int)m, (long long*)out);
  }
  return (int)cudaGetLastError();
}
