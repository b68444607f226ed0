// K1 group_ids: dense group ids and group ranges from key-sorted rows.
//
// Replaces: trino_tpu/exec/kernels.py:sort_group, the pass after the sort
// (:243-263): boundary flags -> cumsum -> gid_sorted (clamped to
// capacity), the inverse permutation, starts/ends by searchsorted, owner
// and num_groups; and the per-row representative flag of
// trino_tpu/exec/stage.py:_dedupe (:504), owner[group[i]] == i for a live
// row i, written as `rep` in the pass that writes group when the caller
// asks for it (a DISTINCT's dedupe does; a GROUP BY does not pay for the
// second scattered store). The packing of the keys is K8 pack_words; the
// stable sort stays torch.sort, as the JAX package leaves lax.sort to XLA.
//
// Bound on an H100 (3.35 TB/s): per row it must read the sorted word or
// the `same` flag (8 or 1 B), live_s (1 B) and perm (8 B) and write
// gid_sorted and group (8 B each) and rep (1 B, when asked for), plus
// 3 x 8 B per capacity slot: about 33-34 B/row, so ~0.06 ms at 6M rows
// and ~0.6 ms at 60M rows. Bytes, not operations, bound it. What holds
// it back is the inverse permutation, group[perm[p]] = gid_sorted[p]
// (the JAX package pays it as an argsort and a gather): stored straight
// from sorted order, every 8-byte store is a partial 32-byte sector of a
// row far from its neighbours', which the card writes back by reading
// the sector first. A bare index_put_ of it takes longer than all the
// rest of K1 (chip_smoke.py's `scatter_ms`).
//
// Design: a single-pass scan with decoupled look-back, fused with the
// assignment, and the inverse permutation in two steps that store whole
// sectors.
// 1. `scan_assign`: each block takes the next tile id from a counter, so
//    tiles start in order and a block only ever waits on tiles whose
//    blocks are already running (no deadlock). A tile is THREADS*ITEMS
//    rows read in stripes of THREADS consecutive rows (coalesced); the
//    words go to shared memory with the row before the tile (read once
//    per tile), boundaries become one warp ballot per stripe, and the
//    64 per-warp popcounts are scanned by one warp. That warp publishes
//    the tile's count and then its inclusive prefix as status-tagged
//    64-bit words and looks back over its predecessors 32 at a time for
//    its exclusive prefix. In the same pass the block writes gid_sorted,
//    starts[g] at each group's first position and n_live at the first
//    position at capacity; the last tile writes num_groups. Each row's
//    (id, rep flag, row in its window) goes as one 8-byte word into the
//    region of its row window (as many slots as the window has rows), at a
//    slot that one atomic per window and warp reserves: consecutive
//    slots, so the stores fill whole sectors while the few open sectors
//    of each window sit in L2.
// 2. `windows`: one block per row window unpacks its words in shared
//    memory and writes group (and rep) in row order, coalesced.
// 3. `slots`: unused slots start at n_live, ends are the next start,
//    owner is perm[start].
// No per-row count is written and read back, and no single block walks
// the tile totals. Ids are int64 (the port's index type).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ttk::THREADS;
using ttk::WARPS;
using ttk::u64;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr unsigned FULL = 0xffffffffu;
// Rows per window of the inverse permutation's two-step scatter: 2^9 to
// 2^12, the least that keeps n / window under WINDOWS windows. A random
// permutation makes one atomic per row on its window's fill count, and
// the atomics on one count run one after another: small windows spread
// them over more counts, large ones keep fewer open sectors in L2 (on an
// H100 2^9 was the fastest at 8M rows in 2M groups, 2^12 at 60M rows in
// 1.5M groups).
constexpr int MIN_WINDOW_BITS = 9;
constexpr int MAX_WINDOW_BITS = 12;
constexpr long long WINDOWS = 1 << 14;
static_assert(ITEMS * WARPS == 64, "one warp scans two counts per lane");

__global__ void __launch_bounds__(THREADS) scan_assign(
    const long long* __restrict__ words, const unsigned char* __restrict__ same,
    const unsigned char* __restrict__ live, const long long* __restrict__ perm,
    long long n, long long capacity, u64* state, unsigned int* next_tile,
    unsigned int* __restrict__ fill, int window_bits,
    long long* __restrict__ gid_sorted,
    u64* __restrict__ staged, long long* __restrict__ starts,
    long long* __restrict__ num_groups, long long* __restrict__ n_live) {
  __shared__ long long buf[TILE];  // the tile's words, then its ids
  __shared__ unsigned int pre[ITEMS * WARPS];  // per (stripe, warp) counts
  __shared__ long long tile_s, excl_s, before_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(next_tile, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long base = tile * TILE;

  // 1. boundary flags, one ballot per warp and stripe
  if (words != nullptr) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = base + i * THREADS + t;
      buf[i * THREADS + t] = p < n ? words[p] : 0;
    }
    if (t == 0) before_s = base > 0 ? words[base - 1] : 0;
    __syncthreads();
  }
  bool lv[ITEMS];
  unsigned int mask[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int l = i * THREADS + t;
    const long long p = base + l;
    lv[i] = p < n && live[p];
    bool flag = false;
    if (lv[i]) {
      if (p == 0) {
        flag = true;
      } else if (words != nullptr) {
        flag = buf[l] != (l > 0 ? buf[l - 1] : before_s);
      } else {
        flag = !same[p];
      }
    }
    mask[i] = __ballot_sync(FULL, flag);
    if (lane == 0) pre[i * WARPS + warp] = __popc(mask[i]);
  }
  __syncthreads();

  // 2. the tile's count and exclusive prefix (warp 0)
  if (warp == 0) {
    const unsigned int a = pre[2 * lane], b = pre[2 * lane + 1];
    const unsigned int own = a + b;
    unsigned int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned int x = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += x;
    }
    pre[2 * lane] = incl - own;
    pre[2 * lane + 1] = incl - own + a;
    const long long total = __shfl_sync(FULL, incl, 31);
    if (lane == 0) ttk::look_back_publish(state, tile, 1, total);
    const long long excl = ttk::look_back(state, tile, 1, total);
    if (lane == 0) {
      excl_s = excl;
      if (tile == (long long)gridDim.x - 1) *num_groups = excl + total;
    }
  }
  __syncthreads();
  const long long excl = excl_s;

  // 3. ids: gid_sorted = live ? min(count of boundaries to here - 1,
  // capacity) : capacity, the plain version's formula
  long long g[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long count = excl + pre[i * WARPS + warp] +
                            __popc(mask[i] & ((2u << lane) - 1u));
    const long long c = count - 1 < capacity ? count - 1 : capacity;
    g[i] = lv[i] ? c : capacity;
    buf[i * THREADS + t] = g[i];
  }
  long long g_before = capacity;  // the id of the row before the tile
  if (t == 0 && base > 0 && live[base - 1]) {
    g_before = excl - 1 < capacity ? excl - 1 : capacity;
  }
  __syncthreads();

  // 4. stores; the inverse permutation goes through the row windows
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int l = i * THREADS + t;
    const long long p = base + l;
    const bool valid = p < n;
    const long long row = valid ? perm[p] : -1;
    const long long window = valid ? row >> window_bits : -1;
    // one slot reservation per window and warp: the lanes of a warp that
    // share a window take consecutive slots of its region
    const unsigned int peers = __match_any_sync(FULL, window);
    const int leader = __ffs(peers) - 1;
    unsigned int slot = 0;
    if (valid && lane == leader) slot = atomicAdd(&fill[window], __popc(peers));
    slot = __shfl_sync(FULL, slot, leader) + __popc(peers & ((1u << lane) - 1u));
    if (!valid) continue;
    const long long gp = l > 0 ? buf[l - 1] : g_before;
    const bool first = p == 0 || g[i] != gp;
    gid_sorted[p] = g[i];
    // the representative of a group is the row at its first position
    const u64 is_rep = first && g[i] < capacity ? 1 : 0;
    staged[(window << window_bits) + slot] =
        ((u64)g[i] << (window_bits + 1)) | (is_rep << window_bits) |
        (u64)(row & ((1ll << window_bits) - 1));
    if (first) {
      // gid_sorted is non-decreasing: each id < capacity starts once, and
      // the first position at capacity (dead or overflow rows) is unique
      if (g[i] >= capacity) {
        *n_live = p;
      } else if (g[i] >= 0) {
        starts[g[i]] = p;
      }
    }
  }
}

// One block per row window: its staged (id, rep, row) entries, exactly
// one per row of the window, are unpacked in shared memory and written
// to group (and rep) in row order.
__global__ void __launch_bounds__(THREADS) windows(
    const u64* __restrict__ staged, long long n, int window_bits,
    long long* __restrict__ group, unsigned char* __restrict__ rep) {
  __shared__ long long ids[1 << MAX_WINDOW_BITS];
  __shared__ unsigned char reps[1 << MAX_WINDOW_BITS];
  const long long window = 1ll << window_bits;
  const long long r0 = (long long)blockIdx.x * window;
  const int rows = (int)(n - r0 < window ? n - r0 : window);
  for (int j = threadIdx.x; j < rows; j += THREADS) {
    const u64 e = staged[r0 + j];
    const int at = (int)(e & (window - 1));
    ids[at] = (long long)e >> (window_bits + 1);  // arithmetic: ids may be < 0
    reps[at] = (unsigned char)((e >> window_bits) & 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += THREADS) {
    group[r0 + j] = ids[j];
    if (rep != nullptr) rep[r0 + j] = reps[j];
  }
}

__global__ void slots(long long* starts, long long* ends, long long* owner,
                      const long long* perm, const long long* num_groups,
                      const long long* n_live, long long n, long long capacity) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= capacity) return;
  const long long ng = *num_groups;
  const long long used = ng < capacity ? ng : capacity;
  const long long nl = *n_live;
  const long long s = g < used ? starts[g] : nl;
  const long long e = (g + 1 < used) ? starts[g + 1] : nl;
  long long at = s < 0 ? 0 : s;
  if (at > n - 1) at = n - 1 < 0 ? 0 : n - 1;
  owner[g] = (g < ng && n > 0) ? perm[at] : n;
  ends[g] = e;
  starts[g] = s;
}

}  // namespace

// words: sorted packed key words (or null, then `same` flags are read);
// live: live_s flags in sorted order; perm: the sort permutation.
// Scratch: state [ceil(n / 2048) + 1 + ceil(n / 512) / 2 + 1] 64-bit
// words (reset here), staged [n]. Outputs: gid_sorted [n], group [n],
// rep [n] (bool; null when not wanted), starts/ends/owner [capacity],
// num_groups [1], n_live [1] (n_live must hold n on entry). Returns
// cudaGetLastError().
extern "C" int group_ids_launch(const void* words, const void* same,
                                const void* live, const void* perm, long long n,
                                long long capacity, void* state, void* staged,
                                void* gid_sorted, void* group, void* rep,
                                void* starts, void* ends, void* owner,
                                void* num_groups, void* n_live, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + TILE - 1) / TILE;
  int window_bits = MIN_WINDOW_BITS;
  while (window_bits < MAX_WINDOW_BITS && (n >> window_bits) >= WINDOWS) {
    ++window_bits;
  }
  const long long windows_n = (n + (1ll << window_bits) - 1) >> window_bits;
  if (n > 0) {
    // the tile words, the tile counter, the window fill counts
    u64* words_at = (u64*)state;
    unsigned int* counter = (unsigned int*)(words_at + tiles);
    unsigned int* fill = (unsigned int*)(words_at + tiles + 1);
    cudaMemsetAsync(state, 0,
                    (size_t)(tiles + 1) * sizeof(u64) +
                        (size_t)windows_n * sizeof(unsigned int), s);
    scan_assign<<<(unsigned int)tiles, THREADS, 0, s>>>(
        (const long long*)words, (const unsigned char*)same,
        (const unsigned char*)live, (const long long*)perm, n, capacity,
        words_at, counter, fill, window_bits, (long long*)gid_sorted,
        (u64*)staged,
        (long long*)starts, (long long*)num_groups, (long long*)n_live);
    windows<<<(unsigned int)windows_n, THREADS, 0, s>>>(
        (const u64*)staged, n, window_bits, (long long*)group,
        (unsigned char*)rep);
  } else {
    cudaMemsetAsync(num_groups, 0, sizeof(long long), s);
  }
  if (capacity > 0) {
    slots<<<ttk::blocks_for(capacity, THREADS), THREADS, 0, s>>>(
        (long long*)starts, (long long*)ends, (long long*)owner,
        (const long long*)perm, (const long long*)num_groups,
        (const long long*)n_live, n, capacity);
  }
  return (int)cudaGetLastError();
}
