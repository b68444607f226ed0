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
// overflow that escalates the bucket capacity.
//
// Bound on an H100 (3.35 TB/s): live read for every row, dest only for
// live rows and each payload column only for the live rows that fit,
// each bucket column and the sent-live mask written once (the buckets'
// zero fill included); chip_smoke.py prints it for a 7.5M-row shard of
// Q3's lineitem payload (SF10 on 8 shards). Bytes, not operations, bound it.
//
// Design: three launches. (1) count: each block of TILE rows counts its
// live rows per destination in shared memory (n_parts <= 64) and writes
// one row of the [blocks, n_parts] table. (2) scan: one block per
// destination turns its column of the table into exclusive block offsets
// and the destination's total. (3) scatter: each block walks its tile in
// row order, THREADS rows at a time; __match_any_sync ranks a row among
// its warp's rows of the same destination, per-warp counts in shared
// memory offset later warps, and a running count per destination carries
// from one step to the next, so a row's slot is its rank in row order.
// Every payload column is written by the same launch through a by-value
// table of column pointers and element widths (1, 2, 4, 8 or 16 bytes).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::WARPS;
constexpr int ITEMS = 8;
constexpr long long TILE = (long long)THREADS * ITEMS;
constexpr int MAX_PARTS = 64;
constexpr int MAX_COLS = 32;

struct Cols {
  const void* in[MAX_COLS];
  void* out[MAX_COLS];
  int width[MAX_COLS];
  int k;
};

__device__ __forceinline__ int dest_of(const int* dest, const bool* live,
                                       long long row, int n_parts) {
  if (!live[row]) return -1;
  const int d = dest[row];
  return (d >= 0 && d < n_parts) ? d : -1;
}

__global__ void count_kernel(const int* dest, const bool* live, long long n,
                             int n_parts, long long* block_counts) {
  __shared__ int cnt[MAX_PARTS];
  for (int d = threadIdx.x; d < n_parts; d += THREADS) cnt[d] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long t1 = t0 + TILE < n ? t0 + TILE : n;
  for (long long row = t0 + threadIdx.x; row < t1; row += THREADS) {
    const int d = dest_of(dest, live, row, n_parts);
    if (d >= 0) atomicAdd(&cnt[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_parts; d += THREADS) {
    block_counts[(long long)blockIdx.x * n_parts + d] = cnt[d];
  }
}

// one block per destination: exclusive offsets over the blocks, in place
__global__ void scan_kernel(long long* block_counts, long long n_blocks,
                            int n_parts, long long* counts) {
  const int d = blockIdx.x;
  long long running = 0;
  for (long long base = 0; base < n_blocks; base += THREADS) {
    const long long b = base + threadIdx.x;
    const long long v = b < n_blocks ? block_counts[b * n_parts + d] : 0;
    long long total;
    const long long incl = ttk::block_inclusive_scan<long long>(v, &total);
    if (b < n_blocks) block_counts[b * n_parts + d] = running + incl - v;
    running += total;
  }
  if (threadIdx.x == 0) counts[d] = running;
}

__device__ __forceinline__ void copy_elem(const void* in, void* out, int width,
                                          long long row, long long slot) {
  switch (width) {
    case 1:
      ((unsigned char*)out)[slot] = ((const unsigned char*)in)[row];
      break;
    case 2:
      ((unsigned short*)out)[slot] = ((const unsigned short*)in)[row];
      break;
    case 4:
      ((unsigned int*)out)[slot] = ((const unsigned int*)in)[row];
      break;
    case 8:
      ((unsigned long long*)out)[slot] = ((const unsigned long long*)in)[row];
      break;
    default: {  // 16: two 8-byte lanes (two-limb decimals, hash-coded varchar)
      const unsigned long long* src = (const unsigned long long*)in + 2 * row;
      unsigned long long* dst = (unsigned long long*)out + 2 * slot;
      dst[0] = src[0];
      dst[1] = src[1];
    }
  }
}

__global__ void scatter_kernel(const int* dest, const bool* live, long long n,
                               int n_parts, long long bucket,
                               const long long* block_offsets, Cols cols,
                               bool* sent_live) {
  __shared__ long long running[MAX_PARTS];
  __shared__ int warp_cnt[WARPS][MAX_PARTS];
  for (int d = threadIdx.x; d < n_parts; d += THREADS) {
    running[d] = block_offsets[(long long)blockIdx.x * n_parts + d];
    for (int w = 0; w < WARPS; ++w) warp_cnt[w][d] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int lt = (1u << lane) - 1u;
  const long long t0 = (long long)blockIdx.x * TILE;
  const long long t1 = t0 + TILE < n ? t0 + TILE : n;
  for (long long base = t0; base < t1; base += THREADS) {
    const long long row = base + threadIdx.x;
    const int d = row < t1 ? dest_of(dest, live, row, n_parts) : -1;
    const unsigned int peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lt);
    if (d >= 0 && rank == 0) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();
    long long pos = 0;
    if (d >= 0) {
      pos = running[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_cnt[w][d];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n_parts; e += THREADS) {
      long long add = 0;
      for (int w = 0; w < WARPS; ++w) {
        add += warp_cnt[w][e];
        warp_cnt[w][e] = 0;
      }
      running[e] += add;
    }
    __syncthreads();
    if (d >= 0 && pos < bucket) {
      const long long slot = (long long)d * bucket + pos;
      sent_live[slot] = true;
      for (int c = 0; c < cols.k; ++c) {
        copy_elem(cols.in[c], cols.out[c], cols.width[c], row, slot);
      }
    }
  }
}

}  // namespace

// dest: [n] int32 destinations; live: [n] bool; block_counts: scratch of
// ceil(n / TILE) * n_parts int64s; counts: [n_parts] int64 out (every live
// row of each destination, dropped ones included); desc: k rows of 3
// int64s on the host (payload pointer, bucket pointer, element width in
// bytes); the buckets ([n_parts * bucket] elements each) and sent_live
// ([n_parts * bucket]) are zero on entry. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for n_parts outside [1, 64], k outside [0, 32] or
// a width other than 1, 2, 4, 8 or 16.
extern "C" int partition_pack_launch(const void* dest, const void* live,
                                     long long n, long long n_parts,
                                     long long bucket, void* block_counts,
                                     void* counts, const long long* desc,
                                     long long k, void* sent_live,
                                     void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS || k < 0 || k > MAX_COLS) {
    return (int)cudaErrorInvalidValue;
  }
  Cols cols;
  cols.k = (int)k;
  for (int c = 0; c < cols.k; ++c) {
    cols.in[c] = (const void*)desc[3 * c];
    cols.out[c] = (void*)desc[3 * c + 1];
    cols.width[c] = (int)desc[3 * c + 2];
    const int w = cols.width[c];
    if (w != 1 && w != 2 && w != 4 && w != 8 && w != 16) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_blocks = (n + TILE - 1) / TILE;
  if (n_blocks == 0) {
    cudaMemsetAsync(counts, 0, n_parts * sizeof(long long), s);
    return (int)cudaGetLastError();
  }
  count_kernel<<<(unsigned int)n_blocks, THREADS, 0, s>>>(
      (const int*)dest, (const bool*)live, n, (int)n_parts,
      (long long*)block_counts);
  scan_kernel<<<(unsigned int)n_parts, THREADS, 0, s>>>(
      (long long*)block_counts, n_blocks, (int)n_parts, (long long*)counts);
  scatter_kernel<<<(unsigned int)n_blocks, THREADS, 0, s>>>(
      (const int*)dest, (const bool*)live, n, (int)n_parts, bucket,
      (const long long*)block_counts, cols, (bool*)sent_live);
  return (int)cudaGetLastError();
}
