// K8 pack_words: GROUP BY keys, their null flags and the live bit packed
// into u64 sort words, one pass.
//
// Replaces: trino_tpu/exec/kernels.py:_pack_words (:266) with the
// normalize_key (:115) in front of it, which sit before every GROUP BY's
// sort (sort_group, :166) and every DISTINCT's dedupe sort.
//
// Per row and key: bits = the key's canonical bits (a NULL key's bits are
// 0), piece = bits & (2^w - 1) for a width w < 64, shifted into the word,
// then the null flag (1 = NULL) shifted in when the key is nullable. When
// the whole pack is one word with a bit to spare, the word starts from
// the dead bit (1 = dead), so it lands above every key bit and dead rows
// sort last. A word starts from its first key (or the dead bit), never
// from a zero shifted by the full 64 bits. The greedy chunking of keys
// into words stays in Python (exec/kernels.py:_word_layout); one launch
// packs one word, which holds at most 64 keys.
//
// Bound on an H100 (3.35 TB/s): keys read once, words written once. Q18's
// l_orderkey at SF10 narrowed to its value range, live bit folded in:
// 60M x (8 + 1 + 8) B = 1.02 GB, ~0.30 ms. Bytes bound it.
//
// Design: one thread per row in a grid-stride loop; the key descriptors
// ride in a by-value kernel parameter (64 keys x 36 B fit its 4 KB).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::u64;
constexpr int MAX_KEYS = 64;

struct Keys {
  const void* data[MAX_KEYS];
  const unsigned char* valid[MAX_KEYS];
  long long stride[MAX_KEYS];
  int type[MAX_KEYS];
  int width[MAX_KEYS];
  int flagged[MAX_KEYS];  // 1 when the key carries a null-flag bit
  int k;
  int live_folded;
};

__global__ void pack_words_kernel(Keys keys, const unsigned char* live,
                                  long long n, u64* out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    bool started = keys.live_folded != 0;
    u64 packed = started ? (live[i] ? 0ull : 1ull) : 0ull;
    for (int c = 0; c < keys.k; ++c) {
      const bool is_null = keys.valid[c] != nullptr && !keys.valid[c][i];
      u64 bits = is_null ? 0ull
                         : ttk::key_bits(keys.data[c], keys.type[c],
                                         i * keys.stride[c]);
      const int w = keys.width[c];
      if (w < 64) bits &= (1ull << w) - 1ull;
      // w == 64 only for a word's first key (the chunking guarantees it)
      packed = started ? ((packed << w) | bits) : bits;
      started = true;
      if (keys.flagged[c]) packed = (packed << 1) | (is_null ? 1ull : 0ull);
    }
    out[i] = packed;
  }
}

}  // namespace

// desc: k rows of 6 int64s on the host, the keys of one word in
// significance order: data pointer, validity pointer (0 = no NULLs),
// stride in elements, type (ColType), width in bits, flagged (0/1).
// live: [n] bool, read when live_folded; out: [n] packed words.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for k outside
// [1, MAX_KEYS] or a width outside [1, 64].
extern "C" int pack_words_launch(const long long* desc, long long k,
                                 const void* live, long long live_folded,
                                 long long n, void* out, void* stream) {
  if (k < 1 || k > MAX_KEYS) return (int)cudaErrorInvalidValue;
  Keys keys;
  keys.k = (int)k;
  keys.live_folded = (int)live_folded;
  for (int c = 0; c < keys.k; ++c) {
    keys.data[c] = (const void*)desc[6 * c];
    keys.valid[c] = (const unsigned char*)desc[6 * c + 1];
    keys.stride[c] = desc[6 * c + 2];
    keys.type[c] = (int)desc[6 * c + 3];
    keys.width[c] = (int)desc[6 * c + 4];
    keys.flagged[c] = (int)desc[6 * c + 5];
    if (keys.width[c] < 1 || keys.width[c] > 64) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (n > 0) {
    const long long blocks = (n + ttk::THREADS - 1) / ttk::THREADS;
    const unsigned int grid = (unsigned int)(blocks < 132 * 32 ? blocks : 132 * 32);
    pack_words_kernel<<<grid, ttk::THREADS, 0, (cudaStream_t)stream>>>(
        keys, (const unsigned char*)live, n, (u64*)out);
  }
  return (int)cudaGetLastError();
}
