// XLA-CPU's unstable sort of walk rows, for Hopper (sm_90a).
//
// Replaces the XLA op of sph_tpu/ops/walks.py::_accumulate,
// jax.lax.sort((ids, wts, cts), num_keys=1, dimension=1, is_stable=False)
// (no Pallas source).  XLA's CPU backend sorts each row with libstdc++'s
// std::sort, comparing the int32 ids alone, and the walk rows' run sums
// (cumsum minus the running run base) depend on where equal ids land.  So
// this kernel leaves each row in exactly that order: it transcribes
// std::sort from bits/stl_algo.h and bits/stl_heap.h (libstdc++ 12),
// function by function, over (key, position) pairs with a key-only `<`.
// native/xla_sort.cpp, which calls std::sort itself, is the twin it is
// held against.
//
//   __introsort_loop      depth limit 2 * __lg(n), runs of <= 16 left;
//                         the recursion on [cut, last) becomes an explicit
//                         stack of (first, last, depth): each subrange is
//                         sorted by its own content and depth, so the order
//                         in which subranges are taken changes nothing;
//   __unguarded_partition_pivot
//                         __move_median_to_first(first, first + 1, mid,
//                         last - 1), __unguarded_partition(first + 1, last,
//                         first);
//   __partial_sort(first, last, last)
//                         at depth 0: __make_heap, then __sort_heap through
//                         __pop_heap, __adjust_heap and __push_heap;
//   __final_insertion_sort
//                         __insertion_sort of the first 16, then
//                         __unguarded_insertion_sort of the rest.
//
// A pair is one 64-bit word, the key in the high half and the position in
// the low half; a swap or a move moves the word, a comparison reads the
// high half as a signed int.
//
// Layout.  One thread sorts one row.  Rows of up to kSharedCols keys are
// staged in shared memory, kRowsPerBlock rows a block, loaded and stored by
// the whole block in coalesced passes; wider rows (the explorer's 500 walks
// of 100 steps) are sorted in place in the caller's int64 order buffer.
// What bounds it: the sort is a chain of dependent loads and compares in
// each thread, so latency, not bytes (16 B an entry move in and out: the
// key read, the sorted key and the int64 order written).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long word_t;

constexpr int kThreshold = 16;        // std::sort's _S_threshold
constexpr int kRowsPerBlock = 8;      // shared path: rows (threads) a block
constexpr int kSharedCols = 3072;     // 8 x 3072 x 8 B = 192 KiB a block
constexpr int kGlobalThreads = 128;   // global path: threads a block
constexpr int kStack = 64;            // > 2 * lg(2^31) + 1 pending ranges

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

// __unguarded_partition(first, last, pivot)
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

// __unguarded_linear_insert(last)
__device__ void unguarded_linear_insert(word_t* v, int last) {
  const word_t val = v[last];
  int next = last - 1;
  while (less(val, v[next])) {
    v[last] = v[next];
    last = next;
    --next;
  }
  v[last] = val;
}

// __insertion_sort(first, last)
__device__ void insertion_sort(word_t* v, int first, int last) {
  if (first == last) return;
  for (int i = first + 1; i != last; ++i) {
    if (less(v[i], v[first])) {
      const word_t val = v[i];
      for (int j = i; j > first; --j) v[j] = v[j - 1];  // move_backward
      v[first] = val;
    } else {
      unguarded_linear_insert(v, i);
    }
  }
}

// std::sort(v, v + n): __introsort_loop, then __final_insertion_sort
__device__ void xla_sort_row(word_t* v, int n) {
  if (n <= 0) return;
  int sf[kStack], sl[kStack], sd[kStack];
  sf[0] = 0;
  sl[0] = n;
  sd[0] = 2 * (31 - __clz(n));  // 2 * __lg(n)
  int top = 1;
  while (top > 0) {
    --top;
    const int first = sf[top];
    int last = sl[top];
    int depth = sd[top];
    while (last - first > kThreshold) {
      if (depth == 0) {
        heap_sort(v, first, last);
        break;
      }
      --depth;
      const int mid = first + (last - first) / 2;
      move_median_to_first(v, first, first + 1, mid, last - 1);
      const int cut = unguarded_partition(v, first + 1, last, first);
      sf[top] = cut;
      sl[top] = last;
      sd[top] = depth;
      ++top;
      last = cut;
    }
  }
  if (n > kThreshold) {
    insertion_sort(v, 0, kThreshold);
    for (int i = kThreshold; i != n; ++i) unguarded_linear_insert(v, i);
  } else {
    insertion_sort(v, 0, n);
  }
}

// Rows of <= kSharedCols keys: kRowsPerBlock rows a block in shared memory.
__global__ void __launch_bounds__(kRowsPerBlock)
sort_shared(const int* __restrict__ keys, long long rows, int cols,
            int* __restrict__ sorted_keys, long long* __restrict__ order) {
  extern __shared__ word_t rows_s[];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const int nrows = static_cast<int>(
      rows - r0 < kRowsPerBlock ? rows - r0 : kRowsPerBlock);
  const long long base = r0 * cols;
  const int count = nrows * cols;
  for (int i = threadIdx.x; i < count; i += kRowsPerBlock)
    rows_s[i] = pack(keys[base + i], i % cols);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nrows)
    xla_sort_row(rows_s + threadIdx.x * cols, cols);
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kRowsPerBlock) {
    const word_t w = rows_s[i];
    order[base + i] = static_cast<long long>(w & 0xffffffffull);
    sorted_keys[base + i] = key_of(w);
  }
}

// Wider rows: each thread sorts its row in place in the order buffer.
__global__ void __launch_bounds__(kGlobalThreads)
sort_global(const int* __restrict__ keys, long long rows, int cols,
            int* __restrict__ sorted_keys, long long* __restrict__ order) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (r >= rows) return;
  const long long base = r * cols;
  word_t* v = reinterpret_cast<word_t*>(order + base);
  for (int i = 0; i < cols; ++i) v[i] = pack(keys[base + i], i);
  xla_sort_row(v, cols);
  for (int i = 0; i < cols; ++i) {
    const word_t w = v[i];
    sorted_keys[base + i] = key_of(w);
    order[base + i] = static_cast<long long>(w & 0xffffffffull);
  }
}

}  // namespace

// keys [rows, cols] int32 -> order [rows, cols] int64 and the sorted keys
// [rows, cols] int32.
extern "C" int walk_row_sort_launch(const void* keys, long long rows,
                                    int cols, void* sorted_keys, void* order,
                                    void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  int* sk = static_cast<int*>(sorted_keys);
  long long* o = static_cast<long long*>(order);
  if (cols <= kSharedCols) {
    const size_t smem = sizeof(word_t) * kRowsPerBlock * cols;
    cudaError_t err = cudaFuncSetAttribute(
        sort_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    sort_shared<<<static_cast<unsigned>(blocks), kRowsPerBlock, smem, s>>>(
        k, rows, cols, sk, o);
  } else {
    const long long blocks = (rows + kGlobalThreads - 1) / kGlobalThreads;
    sort_global<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, s>>>(
        k, rows, cols, sk, o);
  }
  return static_cast<int>(cudaGetLastError());
}
