// Run sums of the sparse merges, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the segment-combine of the JAX
// package's device merge, sph_tpu/ops/device_merge.py::_merge_flatten
// (:56-108: a scatter-add or scatter-min of the sorted entries into their
// runs, and a scatter-add of the children's weights into their parents),
// an XLA program.  It is written by hand because the port's merges must
// give the host C++ merge's bits (native/graphops.cpp merge_sum,
// merge_min): that merge sums each run left to right in the stable key
// order, `s += v` in float32, and each parent's weight over its children
// in ascending child order.  index_add_ and scatter_add_ on a CUDA tensor
// add by atomics in no fixed order, and no torch call sums runs left to
// right.
//
// Input (ops/device_merge.py builds it with torch ops):
//   keys [E] int64, sorted (stable) parent_row * num_merged + parent_col;
//   vals [E] float32, the entries' values in the same order (already
//        multiplied by their child row's weight where the merge weights
//        by size: one rounding, as the host does);
//   run_start [U + 1] int64, where each run of equal keys begins, and E;
//   child_w [C] float32, the children's weights grouped by parent in
//        ascending child order, and parent_start [P + 1] int64 where each
//        parent's children begin (only where the merge weights by size).
// Output: merged_w [P] float32, and per run its row, column (int64) and
// value (float32): the sum divided by max(merged_w[row - parent0], 1), or
// the minimum.
//
// Two kernels on the caller's stream: one thread a parent sums its
// children's weights, then one thread a run folds the run's values in
// order.  The additions and the division are __fadd_rn / __fdiv_rn, so the
// compiler cannot contract or reassociate them; a minimum is taken as
// std::min takes it, (v < m) ? v : m.
//
// Bound: bytes.  Each entry's value is read once (4 B); each run's start
// and first key are read and its row, column and value written once
// (36 B); each child's weight and parent's start are read and each
// parent's weight written once.  Only a run's first key is read.
// A run is a handful of entries on the hierarchy's merges, so threads of a
// warp read neighbouring runs: the reads are near-contiguous.  One thread
// a run is the simple design; a run of many thousand entries (a single
// parent) is summed by one thread alone.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
parent_weights(const float* __restrict__ child_w,
               const long long* __restrict__ parent_start, long long parents,
               float* __restrict__ merged_w) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= parents) return;
  const long long end = parent_start[p + 1];
  float s = 0.0f;
  for (long long c = parent_start[p]; c < end; ++c)
    s = __fadd_rn(s, child_w[c]);
  merged_w[p] = s;
}

template <bool kMin, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
run_combine(const long long* __restrict__ keys,
            const float* __restrict__ vals,
            const long long* __restrict__ run_start, long long runs,
            long long num_merged, long long parent0,
            const float* __restrict__ merged_w,
            long long* __restrict__ out_row, long long* __restrict__ out_col,
            float* __restrict__ out_val) {
  const long long u = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (u >= runs) return;
  const long long b = run_start[u];
  const long long e = run_start[u + 1];
  float acc;
  if (kMin) {
    acc = vals[b];
    for (long long i = b + 1; i < e; ++i) {
      const float v = vals[i];
      acc = (v < acc) ? v : acc;
    }
  } else {
    acc = 0.0f;
    for (long long i = b; i < e; ++i) acc = __fadd_rn(acc, vals[i]);
  }
  const long long key = keys[b];
  const long long row = key / num_merged;
  if (kWeighted) {
    const float mw = merged_w[row - parent0];
    acc = __fdiv_rn(acc, mw > 1.0f ? mw : 1.0f);
  }
  out_row[u] = row;
  out_col[u] = key - row * num_merged;
  out_val[u] = acc;
}

template <bool kMin, bool kWeighted>
void launch_runs(const long long* keys, const float* vals,
                 const long long* run_start, long long runs,
                 long long num_merged, long long parent0,
                 const float* merged_w, long long* out_row,
                 long long* out_col, float* out_val, cudaStream_t st) {
  const long long blocks = (runs + kThreads - 1) / kThreads;
  run_combine<kMin, kWeighted><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 st>>>(keys, vals, run_start, runs,
                                       num_merged, parent0, merged_w,
                                       out_row, out_col, out_val);
}

}  // namespace

// combine_min: 1 for the min merge, 0 for the sum.  child_w and
// parent_start may be null (parents 0): no weights, no division.
extern "C" int merge_runs_launch(const void* keys, const void* vals,
                                 const void* run_start, long long runs,
                                 long long num_merged, int combine_min,
                                 const void* child_w,
                                 const void* parent_start, long long parents,
                                 long long parent0, void* merged_w,
                                 void* out_row, void* out_col, void* out_val,
                                 void* stream) {
  if (num_merged <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool weighted = parents > 0;
  if (weighted && (combine_min || child_w == nullptr ||
                   parent_start == nullptr || merged_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* mw = static_cast<float*>(merged_w);
  if (weighted) {
    const long long blocks = (parents + kThreads - 1) / kThreads;
    parent_weights<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(child_w),
        static_cast<const long long*>(parent_start), parents, mw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (runs > 0) {
    const long long* k = static_cast<const long long*>(keys);
    const float* v = static_cast<const float*>(vals);
    const long long* rs = static_cast<const long long*>(run_start);
    long long* orow = static_cast<long long*>(out_row);
    long long* ocol = static_cast<long long*>(out_col);
    float* oval = static_cast<float*>(out_val);
    if (combine_min)
      launch_runs<true, false>(k, v, rs, runs, num_merged, parent0, mw, orow,
                               ocol, oval, st);
    else if (weighted)
      launch_runs<false, true>(k, v, rs, runs, num_merged, parent0, mw, orow,
                               ocol, oval, st);
    else
      launch_runs<false, false>(k, v, rs, runs, num_merged, parent0, mw,
                                orow, ocol, oval, st);
  }
  return static_cast<int>(cudaGetLastError());
}
