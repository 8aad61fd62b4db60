// XLA-CPU's unstable sort of walk rows, for Hopper (sm_90a).
//
// Replaces the XLA op of sph_tpu/ops/walks.py::_accumulate,
// jax.lax.sort((ids, wts, cts), num_keys=1, dimension=1, is_stable=False)
// (no Pallas source).  XLA's CPU backend sorts each row with libstdc++'s
// std::sort, comparing the int32 ids alone, and the walk rows' run sums
// (cumsum minus the running run base) depend on where equal ids land.  So
// this kernel leaves each row in exactly that order: libstdc++ 12's
// std::sort (bits/stl_algo.h, bits/stl_heap.h) over (key, position) pairs
// with a key-only `<`.  native/xla_sort.cpp, which calls std::sort itself,
// is the twin it is held against.
//
//   __introsort_loop      depth limit 2 * __lg(n), runs of <= 16 left; the
//                         recursion on [cut, last) becomes a stack of
//                         (first, last, depth): each subrange is sorted by
//                         its own content and depth, so the order in which
//                         subranges are taken, and who takes them, changes
//                         nothing;
//   __unguarded_partition_pivot
//                         __move_median_to_first(first, first + 1, mid,
//                         last - 1) in one lane, then
//                         __unguarded_partition(first + 1, last, first) with
//                         every stop at once (below); a range of <=
//                         kLaneRange keys is finished by one lane alone,
//                         libstdc++'s loop as written, 32 such ranges at a
//                         time in a warp;
//   __partial_sort(first, last, last)
//                         at depth 0, in one lane: __make_heap, then
//                         __sort_heap through __pop_heap, __adjust_heap and
//                         __push_heap (only adversarial rows get there);
//   __final_insertion_sort
//                         __insertion_sort of the first 16, then
//                         __unguarded_insertion_sort of the rest: a stable
//                         insertion sort of the whole row.  Every key left
//                         of a leaf (a range of <= 16 keys the loop leaves)
//                         is <= every key in it, so no key crosses a leaf's
//                         edge and the pass is a stable sort of each leaf:
//                         the lane that finishes a short range sorts it so.
//
// The partition by ballots.  With the pivot p at `first`, a left stop is a
// key >= p and a right stop a key <= p in [first + 1, last).  Let rankL(i)
// count the left stops in [first + 1, i) and sufR(i) the right stops in
// (i, last), and R[k] be the right stop with k right stops to its right.
// Hoare's scan swaps its k-th left stop with R[k] while the left stop lies
// left of it, so: the left stop at i swaps iff sufR(i) > rankL(i), with
// R[rankL(i)]; R[k] is used iff rankL(R[k]) > k; the swapping pairs are
// disjoint (K of them), and the cut is L[0] if K = 0, else min(L[K],
// R[K - 1]), L[K] the first left stop that does not swap.  One pass counts
// the right stops; a second gives each key rankL and sufR from ballots and
// the popcounts below its lane and writes R[k] at table[first + k] and
// L[k] at table[last - 1 - k] (2K < last - first: the two never meet); a
// third swaps the K pairs.  ops/walk_sort.ballot_partition_reference is
// the same rule in numpy.
//
// A pair is one 64-bit word, the key in the high half and the position in
// the low half; a swap moves the word, a comparison reads the high half as
// a signed int.
//
// Layout.  Rows of <= kWarpCols keys: a warp a row, kWarpsPerBlock rows a
// block, each row staged in shared memory with a table of 16-bit positions;
// ranges of <= 32 * kRegChunks + 1 keys are partitioned from registers;
// the warp's partitions leave many short ranges, whose fixed costs (the
// median, the stack, three passes for a chunk or two) a lane sorting 32 of
// them side by side does not pay.
// Wider rows: a block a row.  Ranges wider than a stage (kStageCols keys;
// half of it when rows wider than kStageCols number two or more an SM, so
// that two blocks share an SM) are partitioned by the whole block in the
// caller's int64 order buffer (the words), with the table in the int32
// scratch [R, S]; the ranges of at most a stage they leave come out left
// to right, and runs of them are staged together in shared memory (a
// window), where the block partitions those above a split (a sixteenth of
// the window, at least kBlockSplit) and then its warps take the rest from
// a queue, largest first, with the narrow path's code.  Finished keys go
// out in one coalesced pass.
// What bounds it: 16 bytes an entry move in and out (the key read, the
// sorted key and the int64 order written); the sort itself is shared-memory
// passes, about 2.5 reads of a range's words a partition level, and the
// per-range steps (median, stack, leaves) of the many short ranges.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned long long word_t;
typedef unsigned short tab_t;  // positions in a staged row or window

constexpr int kThreshold = 16;        // std::sort's _S_threshold
constexpr int kWarpCols = 2048;       // rows a warp sorts whole
constexpr int kStageCols = 16384;     // keys a block stages in shared memory
constexpr int kBlockSplit = 256;      // in a window, ranges above at least
                                      // this: the block
constexpr int kWarpsPerBlock = 4;     // narrow path: rows (warps) a block
constexpr int kBlockThreads = 512;    // wide path: threads a block
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockItems = 4;        // a block-level tile: keys a thread
constexpr int kTile = kBlockThreads * kBlockItems;
constexpr int kSwapItems = 2;         // pairs a thread swaps at a time
constexpr int kRegChunks = 2;         // register partition: 2 x 32 keys
constexpr int kLaneRange = 32;        // ranges a lane sorts alone
constexpr int kWindowRanges = 512;    // ranges a window takes at most
constexpr int kQueue = 1024;          // a window's warp queue
constexpr int kBigStack = 96;         // a window's block-level ranges
constexpr int kStack = 64;            // > 2 * lg(2^31) + 1 pending ranges
constexpr unsigned kFull = 0xffffffffu;

static_assert(kStageCols <= 65536 && kWarpCols <= kStageCols,
              "positions in shared memory must fit 16 bits");
static_assert(kLaneRange >= kThreshold && kLaneRange <= 16 << 7,
              "a lane's stack holds 8 ranges");

__device__ __forceinline__ int key_of(word_t w) {
  return static_cast<int>(static_cast<unsigned>(w >> 32));
}

__device__ __forceinline__ bool less(word_t a, word_t b) {
  return key_of(a) < key_of(b);
}

__device__ __forceinline__ word_t pack(int key, int pos) {
  return (static_cast<word_t>(static_cast<unsigned>(key)) << 32) |
         static_cast<unsigned>(pos);
}

__device__ __forceinline__ void iter_swap(word_t* a, int i, int j) {
  const word_t t = a[i];
  a[i] = a[j];
  a[j] = t;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int lg(int n) { return 31 - __clz(n); }

// __move_median_to_first(result, a, b, c)
__device__ void move_median_to_first(word_t* v, int result, int a, int b,
                                     int c) {
  if (less(v[a], v[b])) {
    if (less(v[b], v[c]))
      iter_swap(v, result, b);
    else if (less(v[a], v[c]))
      iter_swap(v, result, c);
    else
      iter_swap(v, result, a);
  } else if (less(v[a], v[c])) {
    iter_swap(v, result, a);
  } else if (less(v[b], v[c])) {
    iter_swap(v, result, c);
  } else {
    iter_swap(v, result, b);
  }
}

// __push_heap(first, holeIndex, topIndex, value)
__device__ void push_heap(word_t* v, int first, int hole, int top,
                          word_t value) {
  int parent = (hole - 1) / 2;
  while (hole > top && less(v[first + parent], value)) {
    v[first + hole] = v[first + parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  v[first + hole] = value;
}

// __adjust_heap(first, holeIndex, len, value)
__device__ void adjust_heap(word_t* v, int first, int hole, int len,
                            word_t value) {
  const int top = hole;
  int second = hole;
  while (second < (len - 1) / 2) {
    second = 2 * (second + 1);
    if (less(v[first + second], v[first + second - 1])) second--;
    v[first + hole] = v[first + second];
    hole = second;
  }
  if ((len & 1) == 0 && second == (len - 2) / 2) {
    second = 2 * (second + 1);
    v[first + hole] = v[first + second - 1];
    hole = second - 1;
  }
  push_heap(v, first, hole, top, value);
}

// __partial_sort(first, last, last) = __heap_select (here __make_heap
// alone: no element lies past `middle`) + __sort_heap
__device__ void heap_sort(word_t* v, int first, int last) {
  const int len = last - first;
  if (len >= 2) {
    int parent = (len - 2) / 2;
    while (true) {
      adjust_heap(v, first, parent, len, v[first + parent]);
      if (parent == 0) break;
      parent--;
    }
  }
  while (last - first > 1) {
    --last;
    const word_t value = v[last];
    v[last] = v[first];
    adjust_heap(v, first, 0, last - first, value);
  }
}

// __unguarded_partition(first, last, pivot), in one lane
__device__ int unguarded_partition(word_t* v, int first, int last,
                                   int pivot) {
  while (true) {
    while (less(v[first], v[pivot])) ++first;
    --last;
    while (less(v[pivot], v[last])) --last;
    if (!(first < last)) return first;
    iter_swap(v, first, last);
    ++first;
  }
}

// A stable insertion sort of [first, last), in one lane.
__device__ void leaf_sort(word_t* v, int first, int last) {
  for (int i = first + 1; i < last; ++i) {
    const word_t val = v[i];
    const int key = key_of(val);
    int j = i;
    while (j > first && key < key_of(v[j - 1])) {
      v[j] = v[j - 1];
      --j;
    }
    v[j] = val;
  }
}

// ------------------------------------------------------------- a warp

// One 32-key chunk of the second pass: lane's key at i (valid below the
// range's end); carries and counts are warp-uniform.
__device__ __forceinline__ void warp_chunk(tab_t* tab, int first, int last,
                                           int base, int i, bool valid,
                                           int key, int pk, int total_r,
                                           int& carry_l, int& carry_r,
                                           int& swaps, int& lk) {
  const bool isl = valid && key >= pk;
  const bool isr = valid && key <= pk;
  const unsigned ml = __ballot_sync(kFull, isl);
  const unsigned mr = __ballot_sync(kFull, isr);
  const unsigned lt = lanemask_lt();
  const int rank_l = carry_l + __popc(ml & lt);
  const int suf_r = total_r - carry_r - __popc(mr & lt) - (isr ? 1 : 0);
  const bool swap = isl && suf_r > rank_l;
  if (swap) tab[last - 1 - rank_l] = static_cast<tab_t>(i);
  if (isr && rank_l > suf_r) tab[first + suf_r] = static_cast<tab_t>(i);
  const unsigned ms = __ballot_sync(kFull, swap);
  swaps += __popc(ms);
  const unsigned stay = ml & ~ms;
  if (lk == INT_MAX && stay) lk = base + __ffs(stay) - 1;
  carry_l += __popc(ml);
  carry_r += __popc(mr);
}

// __unguarded_partition(first + 1, last, first) by one warp, the words and
// the table in shared memory; returns the cut.
__device__ int warp_partition(word_t* v, tab_t* tab, int first, int last,
                              int lane) {
  const int lo = first + 1, hi = last;
  const int pk = key_of(v[first]);
  int carry_l = 0, carry_r = 0, swaps = 0, lk = INT_MAX;
  if (hi - lo <= 32 * kRegChunks) {
    int key[kRegChunks];
    int total_r = 0;
#pragma unroll
    for (int e = 0; e < kRegChunks; ++e) {
      const int i = lo + 32 * e + lane;
      key[e] = i < hi ? key_of(v[i]) : 0;
      total_r += __popc(__ballot_sync(kFull, i < hi && key[e] <= pk));
    }
#pragma unroll
    for (int e = 0; e < kRegChunks; ++e) {
      const int base = lo + 32 * e;
      if (base < hi)
        warp_chunk(tab, first, last, base, base + lane, base + lane < hi,
                   key[e], pk, total_r, carry_l, carry_r, swaps, lk);
    }
  } else {
    int count = 0;
#pragma unroll 4
    for (int i = lo + lane; i < hi; i += 32) count += key_of(v[i]) <= pk;
    const int total_r = __reduce_add_sync(kFull, count);
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const bool valid = i < hi;
      warp_chunk(tab, first, last, base, i, valid,
                 valid ? key_of(v[i]) : 0, pk, total_r, carry_l, carry_r,
                 swaps, lk);
    }
  }
  __syncwarp();
  const int cut = swaps == 0 ? lk : min(lk, static_cast<int>(
                                                tab[first + swaps - 1]));
  for (int k = lane; k < swaps; k += 32)
    iter_swap(v, tab[last - 1 - k], tab[first + k]);
  __syncwarp();
  return cut;
}

// std::sort's loop and its final insertion sort over one short range, in
// one lane: the partitions as libstdc++ writes them (the pending side on
// a stack of the larger halves, so at most lg(kLaneRange / 16) + 1 deep),
// then one stable insertion sort of the whole range, which is the stable
// sort of each of its leaves.
__device__ void lane_sort(word_t* v, int first0, int last0, int depth0) {
  int sf[8], sl[8], sd[8];
  int top = 0;
  int first = first0, last = last0, depth = depth0;
  while (true) {
    while (last - first > kThreshold) {
      if (depth == 0) {
        heap_sort(v, first, last);
        break;
      }
      --depth;
      move_median_to_first(v, first, first + 1, first + (last - first) / 2,
                           last - 1);
      const int cut = unguarded_partition(v, first + 1, last, first);
      sd[top] = depth;
      if (cut - first < last - cut) {
        sf[top] = cut;
        sl[top] = last;
        last = cut;
      } else {
        sf[top] = first;
        sl[top] = cut;
        first = cut;
      }
      ++top;
    }
    if (top == 0) break;
    --top;
    first = sf[top];
    last = sl[top];
    depth = sd[top];
  }
  leaf_sort(v, first0, last0);
}

// Short ranges (<= kLaneRange keys) queued one a lane; each lane sorts its
// own once 32 are queued.
struct Shorts {
  int first, last, depth, count;
};

__device__ __forceinline__ void shorts_flush(word_t* v, Shorts& q, int lane) {
  if (lane < q.count) lane_sort(v, q.first, q.last, q.depth);
  __syncwarp();
  q.count = 0;
}

__device__ __forceinline__ void shorts_push(word_t* v, Shorts& q, int first,
                                            int last, int depth, int lane) {
  if (last - first < 2) return;
  if (lane == q.count) {
    q.first = first;
    q.last = last;
    q.depth = depth;
  }
  if (++q.count == 32) shorts_flush(v, q, lane);
}

// __introsort_loop over [first, last) of a staged row or window by one
// warp, down to ranges of <= kLaneRange keys, which go to the lanes.  The
// stack is spread over the lanes: entry t in lane t % 32, slot t / 32, as
// (first | last << 16, depth).
__device__ void warp_sort_range(word_t* v, tab_t* tab, int first0, int last0,
                                int depth0, int lane, Shorts& q) {
  int span0 = 0, span1 = 0, deep0 = 0, deep1 = 0;
  int top = 0;
  int first = first0, last = last0, depth = depth0;
  while (true) {
    bool heap = false;
    while (last - first > kLaneRange) {
      if (depth == 0) {
        if (lane == 0) heap_sort(v, first, last);
        __syncwarp();
        heap = true;
        break;
      }
      --depth;
      if (lane == 0)
        move_median_to_first(v, first, first + 1,
                             first + (last - first) / 2, last - 1);
      __syncwarp();
      const int cut = warp_partition(v, tab, first, last, lane);
      if (lane == (top & 31)) {
        if (top < 32) {
          span0 = cut | (last << 16);
          deep0 = depth;
        } else {
          span1 = cut | (last << 16);
          deep1 = depth;
        }
      }
      ++top;
      last = cut;
    }
    if (!heap) shorts_push(v, q, first, last, depth, lane);
    if (top == 0) break;
    --top;
    const int s = __shfl_sync(kFull, top < 32 ? span0 : span1, top & 31);
    depth = __shfl_sync(kFull, top < 32 ? deep0 : deep1, top & 31);
    first = s & 0xffff;
    last = static_cast<int>(static_cast<unsigned>(s) >> 16);
  }
}

// Rows of <= kWarpCols keys: a warp a row, staged in shared memory.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sort_warp(const int* __restrict__ keys, long long rows, int cols,
          int row_bytes, int* __restrict__ sorted_keys,
          long long* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= rows) return;
  word_t* v = reinterpret_cast<word_t*>(smem + warp * row_bytes);
  tab_t* tab = reinterpret_cast<tab_t*>(v + cols);
  const long long base = row * cols;
  for (int i = lane; i < cols; i += 32) v[i] = pack(keys[base + i], i);
  __syncwarp();
  Shorts q{0, 0, 0, 0};
  warp_sort_range(v, tab, 0, cols, 2 * lg(cols), lane, q);
  shorts_flush(v, q, lane);
  for (int i = lane; i < cols; i += 32) {
    const word_t w = v[i];
    sorted_keys[base + i] = key_of(w);
    order[base + i] = static_cast<long long>(w & 0xffffffffull);
  }
}

// ------------------------------------------------------------- a block

struct BlockShared {
  // a tile's stops by sub-tile and warp: left | right << 16
  int counts[2][kBlockItems][kBlockWarps];
  int sums[kBlockWarps];
  int lk;
  int queue_head;
  int queue_size;
  int big_size;
  int big_first[kBigStack], big_last[kBigStack], big_depth[kBigStack];
  int stack_first[kStack], stack_last[kStack], stack_depth[kStack];
  int win_first[kWindowRanges], win_last[kWindowRanges];
  unsigned char win_depth[kWindowRanges];
};

// A block's shared memory when it stages `stage` keys: the words, the
// table, the warp queue and the rest.
__host__ __device__ constexpr size_t block_smem(int stage) {
  return (sizeof(word_t) + sizeof(tab_t)) * stage + sizeof(int2) * kQueue +
         sizeof(BlockShared);
}
static_assert(kWindowRanges <= kQueue - 2 && kQueue % kBlockThreads == 0,
              "a window's ranges fit the queue");
static_assert(block_smem(kStageCols) <= 232448,
              "a block has 227 KB of shared memory");

// The block's sum of one int a thread (two __syncthreads).
__device__ __forceinline__ int block_sum(int x, BlockShared& s) {
  x = __reduce_add_sync(kFull, x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s.sums[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) total += s.sums[w];
  return total;
}

// __unguarded_partition(first + 1, last, first) by the whole block: the
// words in shared memory (a window) or in the order buffer, the table in
// shared memory or in the scratch.  A tile is kBlockItems sub-tiles of one
// key a thread, their loads in flight together; block-wide rankL and sufR
// come from each warp's ballots and one exchange of the warps' counts a
// tile; the swaps run kSwapItems pairs a thread at a time (the pairs are
// disjoint, so their loads may go before the stores).
template <typename Tab>
__device__ int block_partition(word_t* v, Tab* tab, int first, int last,
                               BlockShared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = first + 1, hi = last;
  const int pk = key_of(v[first]);
  int count = 0;
  for (int base = lo + tid; base < hi; base += kTile) {
    int key[kBlockItems];
#pragma unroll
    for (int e = 0; e < kBlockItems; ++e) {
      const int i = base + e * kBlockThreads;
      key[e] = i < hi ? key_of(v[i]) : 0;
    }
#pragma unroll
    for (int e = 0; e < kBlockItems; ++e)
      count += base + e * kBlockThreads < hi && key[e] <= pk;
  }
  if (tid == 0) s.lk = INT_MAX;
  const int total_r = block_sum(count, s);
  const unsigned lt = lanemask_lt();
  int carry_l = 0, carry_r = 0, swaps = 0, buf = 0;
  for (int base = lo + tid; base - tid < hi; base += kTile, buf ^= 1) {
    int key[kBlockItems];
#pragma unroll
    for (int e = 0; e < kBlockItems; ++e) {
      const int i = base + e * kBlockThreads;
      key[e] = i < hi ? key_of(v[i]) : 0;
    }
#pragma unroll
    for (int e = 0; e < kBlockItems; ++e) {
      const bool valid = base + e * kBlockThreads < hi;
      const int c = __popc(__ballot_sync(kFull, valid && key[e] >= pk)) |
                    (__popc(__ballot_sync(kFull, valid && key[e] <= pk))
                     << 16);
      if (lane == e) s.counts[buf][e][warp] = c;
    }
    __syncthreads();
    int before = 0;  // the tile's stops in its earlier sub-tiles, packed
#pragma unroll
    for (int e = 0; e < kBlockItems; ++e) {
      const int c = lane < kBlockWarps ? s.counts[buf][e][lane] : 0;
      const int below = __reduce_add_sync(kFull, lane < warp ? c : 0);
      const int i = base + e * kBlockThreads;
      const bool valid = i < hi;
      const bool isl = valid && key[e] >= pk;
      const bool isr = valid && key[e] <= pk;
      const unsigned ml = __ballot_sync(kFull, isl);
      const unsigned mr = __ballot_sync(kFull, isr);
      const int rank_l = carry_l + (before & 0xffff) + (below & 0xffff) +
                         __popc(ml & lt);
      const int suf_r = total_r - carry_r - (before >> 16) - (below >> 16) -
                        __popc(mr & lt) - (isr ? 1 : 0);
      const bool swap = isl && suf_r > rank_l;
      if (swap) {
        tab[last - 1 - rank_l] = static_cast<Tab>(i);
        ++swaps;
      }
      if (isr && rank_l > suf_r) tab[first + suf_r] = static_cast<Tab>(i);
      const unsigned stay = __ballot_sync(kFull, isl && !swap);
      if (stay && lane == __ffs(stay) - 1) atomicMin(&s.lk, i);
      before += __reduce_add_sync(kFull, c);
    }
    carry_l += before & 0xffff;
    carry_r += before >> 16;
  }
  const int k = block_sum(swaps, s);
  const int lk = s.lk;
  const int cut = k == 0 ? lk : min(lk, static_cast<int>(tab[first + k - 1]));
  for (int j0 = tid; j0 < k; j0 += kBlockThreads * kSwapItems) {
    int a[kSwapItems], b[kSwapItems];
    word_t wa[kSwapItems], wb[kSwapItems];
#pragma unroll
    for (int e = 0; e < kSwapItems; ++e) {
      const int j = j0 + e * kBlockThreads;
      a[e] = j < k ? static_cast<int>(tab[last - 1 - j]) : 0;
      b[e] = j < k ? static_cast<int>(tab[first + j]) : 0;
    }
#pragma unroll
    for (int e = 0; e < kSwapItems; ++e) {
      if (j0 + e * kBlockThreads < k) {
        wa[e] = v[a[e]];
        wb[e] = v[b[e]];
      }
    }
#pragma unroll
    for (int e = 0; e < kSwapItems; ++e) {
      if (j0 + e * kBlockThreads < k) {
        v[a[e]] = wb[e];
        v[b[e]] = wa[e];
      }
    }
  }
  __syncthreads();
  return cut;
}

// The warps take the queued ranges of a window, largest first (each
// thread ranks its entries by size), and sort each with the narrow path's
// code; then the queue is empty.
__device__ void drain_queue(word_t* sv, tab_t* stab, int2* queue,
                            BlockShared& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = s.queue_size;
  if (n > 1) {
    constexpr int kPer = kQueue / kBlockThreads;
    int2 e[kPer];
    int rank[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int at = tid + j * kBlockThreads;
      rank[j] = -1;
      if (at < n) {
        e[j] = queue[at];
        const int size = (e[j].x >> 16) - (e[j].x & 0xffff);
        int r = 0;
        for (int m = 0; m < n; ++m) {
          const int x = queue[m].x;
          const int other = (x >> 16) - (x & 0xffff);
          r += other > size || (other == size && m < at);
        }
        rank[j] = r;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (rank[j] >= 0) queue[rank[j]] = e[j];
    __syncthreads();
  }
  Shorts q{0, 0, 0, 0};
  while (true) {
    int at = 0;
    if (lane == 0) at = atomicAdd(&s.queue_head, 1);
    at = __shfl_sync(kFull, at, 0);
    if (at >= n) break;
    const int2 e = queue[at];
    warp_sort_range(sv, stab, e.x & 0xffff, e.x >> 16, e.y, lane, q);
  }
  shorts_flush(sv, q, lane);
  __syncthreads();
  if (tid == 0) {
    s.queue_size = 0;
    s.queue_head = 0;
  }
  __syncthreads();
}

// Sorts the staged window sv[0, n) (row positions [w0, w0 + n)) from the
// ranges s.win_* (row positions): the block partitions those above
// `split` (n / kBlockWarps, at least kBlockSplit: a piece or two a warp),
// the warps take the rest from the queue (also whenever it is about to
// fill); then writes the window out.
__device__ void sort_window(word_t* sv, tab_t* stab, int2* queue,
                            BlockShared& s, int w0, int n, int ranges,
                            long long base, int* sorted_keys,
                            long long* order) {
  const int tid = threadIdx.x;
  const int split = max(kBlockSplit, n / kBlockWarps);
  if (tid == 0) {
    s.big_size = 0;
    s.queue_size = 0;
    s.queue_head = 0;
    for (int r = 0; r < ranges; ++r) {
      const int f = s.win_first[r] - w0, l = s.win_last[r] - w0;
      if (l - f > split) {
        s.big_first[s.big_size] = f;
        s.big_last[s.big_size] = l;
        s.big_depth[s.big_size++] = s.win_depth[r];
      } else {
        queue[s.queue_size++] = make_int2(f | (l << 16), s.win_depth[r]);
      }
    }
  }
  __syncthreads();
  while (s.big_size > 0) {
    const int top = s.big_size - 1;
    int first = s.big_first[top], last = s.big_last[top];
    int depth = s.big_depth[top];
    __syncthreads();
    if (tid == 0) s.big_size = top;
    bool heap = false;
    while (last - first > split) {
      if (depth == 0) {
        if (tid == 0) heap_sort(sv, first, last);
        heap = true;
        break;
      }
      __syncthreads();
      if (s.queue_size > kQueue - 2) drain_queue(sv, stab, queue, s);
      --depth;
      if (tid == 0)
        move_median_to_first(sv, first, first + 1,
                             first + (last - first) / 2, last - 1);
      __syncthreads();
      const int cut = block_partition(sv, stab, first, last, s);
      if (tid == 0) {
        if (last - cut > split) {
          s.big_first[s.big_size] = cut;
          s.big_last[s.big_size] = last;
          s.big_depth[s.big_size++] = depth;
        } else {
          queue[s.queue_size++] = make_int2(cut | (last << 16), depth);
        }
      }
      last = cut;
    }
    if (!heap && tid == 0)
      queue[s.queue_size++] = make_int2(first | (last << 16), depth);
    __syncthreads();
  }
  drain_queue(sv, stab, queue, s);
  for (int i = tid; i < n; i += kBlockThreads) {
    const word_t w = sv[i];
    sorted_keys[base + w0 + i] = key_of(w);
    order[base + w0 + i] = static_cast<long long>(w & 0xffffffffull);
  }
  __syncthreads();
}

// Rows of more than kWarpCols keys: a block a row.
// `stage` (a multiple of 32, <= kStageCols) keys are staged at a time.
__global__ void __launch_bounds__(kBlockThreads)
sort_block(const int* __restrict__ keys, int cols, int stage,
           int* __restrict__ sorted_keys, long long* __restrict__ order,
           int* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  word_t* sv = reinterpret_cast<word_t*>(smem);
  tab_t* stab = reinterpret_cast<tab_t*>(sv + stage);
  int2* queue = reinterpret_cast<int2*>(stab + stage);
  BlockShared& s = *reinterpret_cast<BlockShared*>(queue + kQueue);
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * cols;
  if (cols <= stage) {
    for (int i = tid; i < cols; i += kBlockThreads)
      sv[i] = pack(keys[base + i], i);
    if (tid == 0) {
      s.win_first[0] = 0;
      s.win_last[0] = cols;
      s.win_depth[0] = static_cast<unsigned char>(2 * lg(cols));
    }
    __syncthreads();
    sort_window(sv, stab, queue, s, 0, cols, 1, base, sorted_keys, order);
    return;
  }
  // the words in the order buffer, partitioned there down to `stage`
  word_t* gv = reinterpret_cast<word_t*>(order + base);
  int* gtab = scratch + base;
  for (int i = tid; i < cols; i += kBlockThreads)
    gv[i] = pack(keys[base + i], i);
  if (tid == 0) {
    s.stack_first[0] = 0;
    s.stack_last[0] = cols;
    s.stack_depth[0] = 2 * lg(cols);
  }
  int top = 1;                        // uniform
  int win0 = 0, win1 = 0, wins = 0;   // the window being gathered, uniform
  while (top > 0) {
    __syncthreads();
    --top;
    int first = s.stack_first[top], last = s.stack_last[top];
    int depth = s.stack_depth[top];
    bool heap = false;
    while (last - first > stage) {
      if (depth == 0) {
        if (tid == 0) heap_sort(gv, first, last);
        __syncthreads();
        for (int i = first + tid; i < last; i += kBlockThreads) {
          const word_t w = gv[i];
          sorted_keys[base + i] = key_of(w);
          order[base + i] = static_cast<long long>(w & 0xffffffffull);
        }
        heap = true;
        break;
      }
      --depth;
      if (tid == 0)
        move_median_to_first(gv, first, first + 1,
                             first + (last - first) / 2, last - 1);
      __syncthreads();
      const int cut = block_partition(gv, gtab, first, last, s);
      if (tid == 0) {
        s.stack_first[top] = cut;
        s.stack_last[top] = last;
        s.stack_depth[top] = depth;
      }
      ++top;
      last = cut;
    }
    if (heap) continue;
    // ranges of <= `stage` keys come out left to right; a window takes a
    // run of them that fits
    if (wins > 0 && (first != win1 || last - win0 > stage ||
                     wins == kWindowRanges)) {
      __syncthreads();
      for (int i = tid; i < win1 - win0; i += kBlockThreads)
        sv[i] = gv[win0 + i];
      __syncthreads();
      sort_window(sv, stab, queue, s, win0, win1 - win0, wins, base,
                  sorted_keys, order);
      wins = 0;
    }
    if (wins == 0) win0 = first;
    if (tid == 0) {
      s.win_first[wins] = first;
      s.win_last[wins] = last;
      s.win_depth[wins] = static_cast<unsigned char>(depth);
    }
    ++wins;
    win1 = last;
  }
  if (wins > 0) {
    __syncthreads();
    for (int i = tid; i < win1 - win0; i += kBlockThreads)
      sv[i] = gv[win0 + i];
    __syncthreads();
    sort_window(sv, stab, queue, s, win0, win1 - win0, wins, base,
                sorted_keys, order);
  }
}

}  // namespace

// keys [rows, cols] int32 -> order [rows, cols] int64 and the sorted keys
// [rows, cols] int32; scratch [rows, cols] int32 for rows of more than
// kStageCols keys (else unused, may be null).
extern "C" int walk_row_sort_launch(const void* keys, long long rows,
                                    int cols, void* sorted_keys, void* order,
                                    void* scratch, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  int* sk = static_cast<int*>(sorted_keys);
  long long* o = static_cast<long long*>(order);
  if (cols <= kWarpCols) {
    // a row's words, then its 16-bit table, 8-byte aligned
    const int row_bytes = static_cast<int>(
        sizeof(word_t) * cols + ((sizeof(tab_t) * cols + 7) & ~7));
    const size_t smem = static_cast<size_t>(row_bytes) * kWarpsPerBlock;
    cudaError_t err = cudaFuncSetAttribute(
        sort_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sort_warp<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, smem,
                st>>>(k, rows, cols, row_bytes, sk, o);
  } else {
    if (cols > kStageCols && scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    // Rows wider than a stage: with a row or more for every SM, half the
    // stage, so that two blocks share an SM.
    int stage = kStageCols;
    if (cols > kStageCols) {
      int device = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (rows >= 2LL * sms) stage = kStageCols / 2;
    }
    const size_t smem = block_smem(stage);
    cudaError_t err = cudaFuncSetAttribute(
        sort_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(block_smem(kStageCols)));
    if (err != cudaSuccess) return static_cast<int>(err);
    sort_block<<<static_cast<unsigned>(rows), kBlockThreads, smem, st>>>(
        k, cols, stage, sk, o, static_cast<int*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}
