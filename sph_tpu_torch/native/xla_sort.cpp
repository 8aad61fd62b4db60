// The order in which XLA's CPU backend sorts a row of int32 keys under
// jax.lax.sort(..., num_keys=1, is_stable=False).
//
// XLA-CPU sorts each row with std::sort over the row's operands, comparing
// the keys alone with `<`.  The permutation that std::sort leaves depends
// only on the outcome of those comparisons, so sorting (key, position)
// pairs with a key-only `<` gives the same order, equal keys included.
// libstdc++'s std::sort is an introsort (median-of-3 quicksort down to
// runs of 16, heapsort past a depth of 2 * lg(n), then one insertion
// sort); csrc/walk_row_sort.cu transcribes it for the card, and this is the
// order it is held against.
//
// Rows are independent: each is sorted by one thread, and a row's order
// does not depend on how rows are spread over threads.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <utility>
#include <vector>

namespace {

void sort_rows(const int32_t* keys, int64_t cols, int64_t r0, int64_t r1,
               int64_t* order, int32_t* sorted_keys) {
  std::vector<std::pair<int32_t, int64_t>> row(cols);
  for (int64_t r = r0; r < r1; ++r) {
    const int32_t* k = keys + r * cols;
    for (int64_t i = 0; i < cols; ++i) row[i] = {k[i], i};
    std::sort(row.begin(), row.end(),
              [](const std::pair<int32_t, int64_t>& a,
                 const std::pair<int32_t, int64_t>& b) {
                return a.first < b.first;
              });
    for (int64_t i = 0; i < cols; ++i) {
      order[r * cols + i] = row[i].second;
      sorted_keys[r * cols + i] = row[i].first;
    }
  }
}

}  // namespace

// keys [rows, cols] -> order [rows, cols] and the sorted keys, rows spread
// over `threads` threads.
extern "C" void xla_sort_order(const int32_t* keys, int64_t rows,
                               int64_t cols, int64_t threads, int64_t* order,
                               int32_t* sorted_keys) {
  if (rows <= 0 || cols <= 0) return;
  threads = std::max<int64_t>(1, std::min(threads, rows));
  if (threads == 1) {
    sort_rows(keys, cols, 0, rows, order, sorted_keys);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t per = (rows + threads - 1) / threads;
  for (int64_t r0 = 0; r0 < rows; r0 += per)
    pool.emplace_back(sort_rows, keys, cols, r0, std::min(rows, r0 + per),
                      order, sorted_keys);
  for (auto& t : pool) t.join();
}
