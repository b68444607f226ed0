// K10 order_words: the ORDER BY sort words of every key, one pass.
//
// Replaces: the per-key word building inside
// trino_tpu/exec/kernels.py:sort_perm (:515): order_bits (:401),
// _float_sort_bits (:558) and _invert (:552), and the null-flag and
// dead-row bytes. Every ORDER BY and TopN runs it; the stable sort passes
// over the words stay torch.sort (last key first, data then flag, then
// dead), as in the JAX package.
//
// Per row and key:
// - the order word, whose signed order is the key's order: integers as
//   they are, negated in their own width for DESC (INT_MIN stays INT_MIN,
//   as the JAX package's wrapping -x); bools 0/1, complemented for DESC;
//   floats as monotone bits (-0.0 == +0.0, every NaN one value above
//   +inf), complemented for DESC, with bit 31 or 63 flipped so the
//   unsigned order becomes the signed one. Keys of 64-bit types give
//   int64 words, narrower keys int32 words;
// - for a nullable key, its null-flag byte: 1 for NULL (-1 when NULLs come
//   first), 0 otherwise;
// - the dead-row byte: 1 for a dead row.
//
// Bound on an H100 (3.35 TB/s): keys, validity and live read once, words
// and bytes written once. 15M orders rows, o_totalprice (float64,
// nullable) DESC and o_orderdate (int32) ASC: 15M x (8+1+4+1 in,
// 8+1+4+1 out) = 0.42 GB, ~0.13 ms. Bytes bound it.
//
// Design: one thread per row in a grid-stride loop; the key descriptors
// ride in a by-value kernel parameter.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::u64;
constexpr int MAX_KEYS = 32;

struct Keys {
  const void* data[MAX_KEYS];
  const unsigned char* valid[MAX_KEYS];
  void* word[MAX_KEYS];
  signed char* flag[MAX_KEYS];
  long long stride[MAX_KEYS];
  int type[MAX_KEYS];
  int ascending[MAX_KEYS];
  int nulls_first[MAX_KEYS];
  int k;
};

// The monotone signed word of one float key (float64: 64 bits; float32:
// 32 bits in an int32), as _float_sort_bits then ~ for DESC then the sign
// flip.
__device__ __forceinline__ long long f64_word(u64 bits, bool asc) {
  const bool negative = (bits >> 63) != 0;
  u64 m = bits ^ (negative ? ~0ull : 0x8000000000000000ull);
  if (!asc) m = ~m;
  return (long long)(m ^ 0x8000000000000000ull);
}

__device__ __forceinline__ int f32_word(unsigned int bits, bool asc) {
  const bool negative = (bits >> 31) != 0;
  unsigned int m = bits ^ (negative ? 0xFFFFFFFFu : 0x80000000u);
  if (!asc) m = ~m;
  return (int)(m ^ 0x80000000u);
}

__global__ void order_words_kernel(Keys keys, const unsigned char* live,
                                   long long n, signed char* dead) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    for (int c = 0; c < keys.k; ++c) {
      const bool asc = keys.ascending[c] != 0;
      const long long at = i * keys.stride[c];
      const void* d = keys.data[c];
      switch (keys.type[c]) {
        case ttk::T_I64: {
          const long long v = ((const long long*)d)[at];
          ((long long*)keys.word[c])[i] =
              asc ? v : (long long)(0ull - (u64)v);
          break;
        }
        case ttk::T_I32: {
          const int v = ((const int*)d)[at];
          ((int*)keys.word[c])[i] = asc ? v : (int)(0u - (unsigned int)v);
          break;
        }
        case ttk::T_I16: {
          const short v = ((const short*)d)[at];
          ((int*)keys.word[c])[i] =
              asc ? (int)v : (int)(short)(0u - (unsigned int)(unsigned short)v);
          break;
        }
        case ttk::T_I8: {
          const signed char v = ((const signed char*)d)[at];
          ((int*)keys.word[c])[i] =
              asc ? (int)v
                  : (int)(signed char)(0u - (unsigned int)(unsigned char)v);
          break;
        }
        case ttk::T_BOOL: {
          const int v = ((const unsigned char*)d)[at] ? 1 : 0;
          ((int*)keys.word[c])[i] = asc ? v : 1 - v;
          break;
        }
        case ttk::T_F64:
          ((long long*)keys.word[c])[i] =
              f64_word(ttk::key_bits(d, ttk::T_F64, at), asc);
          break;
        default:  // T_F32
          ((int*)keys.word[c])[i] =
              f32_word((unsigned int)ttk::key_bits(d, ttk::T_F32, at), asc);
          break;
      }
      if (keys.flag[c] != nullptr) {
        const bool is_null = !keys.valid[c][i];
        keys.flag[c][i] = is_null ? (keys.nulls_first[c] ? -1 : 1) : 0;
      }
    }
    dead[i] = live[i] ? 0 : 1;
  }
}

}  // namespace

// desc: k rows of 8 int64s on the host: data pointer, validity pointer (0
// = not nullable), word pointer ([n] int64 for I64/F64 keys, [n] int32
// otherwise), flag pointer ([n] int8; 0 when not nullable), stride in
// elements, type (ColType), ascending (0/1), nulls_first (0/1). live: [n]
// bool; dead: [n] int8 out. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for k outside [0, MAX_KEYS].
extern "C" int order_words_launch(const long long* desc, long long k,
                                  const void* live, long long n, void* dead,
                                  void* stream) {
  if (k < 0 || k > MAX_KEYS) return (int)cudaErrorInvalidValue;
  Keys keys;
  keys.k = (int)k;
  for (int c = 0; c < keys.k; ++c) {
    keys.data[c] = (const void*)desc[8 * c];
    keys.valid[c] = (const unsigned char*)desc[8 * c + 1];
    keys.word[c] = (void*)desc[8 * c + 2];
    keys.flag[c] = (signed char*)desc[8 * c + 3];
    keys.stride[c] = desc[8 * c + 4];
    keys.type[c] = (int)desc[8 * c + 5];
    keys.ascending[c] = (int)desc[8 * c + 6];
    keys.nulls_first[c] = (int)desc[8 * c + 7];
    if ((keys.flag[c] == nullptr) != (keys.valid[c] == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (n > 0) {
    const long long blocks = (n + ttk::THREADS - 1) / ttk::THREADS;
    const unsigned int grid = (unsigned int)(blocks < 132 * 32 ? blocks : 132 * 32);
    order_words_kernel<<<grid, ttk::THREADS, 0, (cudaStream_t)stream>>>(
        keys, (const unsigned char*)live, n, (signed char*)dead);
  }
  return (int)cudaGetLastError();
}
