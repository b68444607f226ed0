// K7 hash_keys: the combined 64-bit hash of k key parts, one pass.
//
// Replaces: trino_tpu/exec/kernels.py:hash_columns (:124) with _mix64
// (:65), _canonical_float (:75), _to_bits (:84) and normalize_key (:115),
// which the JAX package runs as ~10 elementwise ops per key part. Every
// multi-key join hashes its keys through it (exec/local.py:_join_keys).
//
// Per row: h = 0 (or the carried hash of an earlier batch of parts); for
// each part, bits = the part's canonical key bits, a NULL part's bits are
// the salt, h = mix64(h ^ mix64(bits)). The arithmetic is unsigned 64-bit:
// shifts are logical and multiplies wrap, as in the JAX package's uint64.
// The wrapper carries the same bits in int64 tensors.
//
// Bound on an H100 (3.35 TB/s): each part read once and the hash written
// once: 60M rows x (2 x 8 B + 8 B) = 1.44 GB, ~0.43 ms (Q9's two-key
// lineitem-partsupp join at SF10). Bytes, not operations, bound it.
//
// Design: one thread per row in a grid-stride loop; the parts' pointers,
// types, strides and validity pointers ride in a by-value kernel
// parameter (no device-side descriptor copy).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::u64;
constexpr int MAX_PARTS = 32;

constexpr u64 MIX_1 = 0xFF51AFD7ED558CCDull;
constexpr u64 MIX_2 = 0xC4CEB9FE1A85EC53ull;
constexpr u64 NULL_SALT = 0x9E3779B97F4A7C15ull;

struct Parts {
  const void* data[MAX_PARTS];
  const unsigned char* valid[MAX_PARTS];
  long long stride[MAX_PARTS];
  int type[MAX_PARTS];
  int k;
};

__device__ __forceinline__ u64 mix64(u64 h) {
  h ^= h >> 33;
  h *= MIX_1;
  h ^= h >> 33;
  h *= MIX_2;
  h ^= h >> 33;
  return h;
}

__global__ void hash_keys_kernel(Parts parts, const u64* h_in, long long n,
                                 u64* out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    u64 h = h_in != nullptr ? h_in[i] : 0ull;
    for (int p = 0; p < parts.k; ++p) {
      const long long at = i * parts.stride[p];
      u64 bits;
      if (parts.valid[p] != nullptr && !parts.valid[p][i]) {
        bits = NULL_SALT;
      } else {
        bits = ttk::key_bits(parts.data[p], parts.type[p], at);
      }
      h = mix64(h ^ mix64(bits));
    }
    out[i] = h;
  }
}

}  // namespace

// desc: k rows of 4 int64s on the host: data pointer, validity pointer
// (0 = no NULLs), stride in elements, type (ColType). h_in: [n] hash of
// earlier parts to continue from, or null to start at 0. out: [n].
// Returns cudaGetLastError(), or cudaErrorInvalidValue for k outside
// [1, MAX_PARTS].
extern "C" int hash_keys_launch(const long long* desc, long long k,
                                const void* h_in, long long n, void* out,
                                void* stream) {
  if (k < 1 || k > MAX_PARTS) return (int)cudaErrorInvalidValue;
  Parts parts;
  parts.k = (int)k;
  for (int p = 0; p < parts.k; ++p) {
    parts.data[p] = (const void*)desc[4 * p];
    parts.valid[p] = (const unsigned char*)desc[4 * p + 1];
    parts.stride[p] = desc[4 * p + 2];
    parts.type[p] = (int)desc[4 * p + 3];
  }
  if (n > 0) {
    const long long blocks = (n + ttk::THREADS - 1) / ttk::THREADS;
    const unsigned int grid = (unsigned int)(blocks < 132 * 32 ? blocks : 132 * 32);
    hash_keys_kernel<<<grid, ttk::THREADS, 0, (cudaStream_t)stream>>>(
        parts, (const u64*)h_in, n, (u64*)out);
  }
  return (int)cudaGetLastError();
}
