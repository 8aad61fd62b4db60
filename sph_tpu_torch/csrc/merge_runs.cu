// The sparse merges of the hierarchy, for Hopper (sm_90a): each parent's
// children's rows merged into the parent's row in shared memory.
//
// Replaces no Pallas kernel.  It replaces the JAX package's device merge,
// sph_tpu/ops/device_merge.py::_merge_flatten (:56-108: the children's rows
// flattened, a two-key stable sort by (parent row, parent column), the runs
// of equal keys and a scatter-add or scatter-min into them, and a
// scatter-add of the children's weights into their parents), an XLA
// program.  It is written by hand because the port's merges must give the
// host C++ merge's bits (native/graphops.cpp merge_sum, merge_min): that
// merge folds each parent column's values in ascending child id, then in
// ascending slot of the child's row (its LSD radix sort is stable), `s += v`
// from 0 in float32 or the running std::min, and each parent's weight over
// its children in ascending child order.  index_add_ and scatter_add_ on a
// CUDA tensor add by atomics in no fixed order, and no torch call folds a
// run left to right.
//
// Input (ops/device_merge.py builds the N- and M-sized ones with torch ops):
//   idx [N, W] int64 and val [N, W] float32, the children's rows as they
//        lie (pads idx < 0; an entry is live where idx >= 0 and val != 0);
//   par [N] int32, each row's parent (columns map through it too);
//   order [N] int64, the rows grouped by parent, ascending within a parent,
//        and child_start [M + 1] int64, where each parent's rows begin;
//   by_size [M] int64, the parents, most children first;
//   combine (sum or min) and, for a sum, whether it weights by size (each
//        child's values times its live count, one rounding as the host's
//        `vrow[j] * w`, and each parent's sums divided by max(summed live
//        counts, 1)).
// Output: each parent's runs in ascending parent column, its column (int32)
// and value (float32), from out[child_start[p] * W] on (the parent's padded
// slots bound its runs); run_count [M] int32; where it weights, nnz [N]
// int32 (each row's live count) and merged_w [M] float32; two state words,
// zero before: [0] set where a live column lies outside [0, N), [1] the
// windows taken.  A second entry point, merge_runs_pack_launch, lays the
// runs out as [M, width] rows (int64 columns, -1 and 0 at pads) once the
// caller has read the widest count.
//
// Design.  Where it weights, row_scan counts each row's live slots (a warp
// a row) and parent_scan sums each parent's counts in child order (a
// thread a parent), as the host sums them; where the parent columns pass
// the window, the two also find each parent's smallest column, where its
// first window starts.  Then merge_rows:
// persistent blocks of 256 threads take the parents most children first,
// by_size[block], by_size[block + blocks], ..., so a giant parent of the
// top levels does not start last.  A block keeps a window of its parent's
// columns in shared memory: a float accumulator a column and an occupancy
// bit.  It reads the children's slots in flattened order (child, then
// slot), 1024 a tile, a warp's lanes on neighbouring slots of a row (12 B
// a slot, coalesced), drops pads and zeros and maps each column through
// par (N x 4 B, in L1 and L2); a tile's slots are fetched while the tile
// before is folded, and a parent's first tile while the parent before
// writes its runs.  The tile's entries in the window are partitioned
// stably among the 8 warps by column (column & 7: each warp owns its
// columns; ballots count them) and staged in shared memory; each warp then
// folds its entries in order, 32 at a time: lanes holding one column are
// found with __match_any_sync, the lowest lane of each group takes the
// accumulator (or, at the column's first entry, the value itself) and
// folds its group's values in lane order from the staged tile.  So every
// column's values are folded in flattened order, as the host's stable sort
// orders them.  After the last tile the block scans the occupancy bits
// between the smallest and the largest column it set, writes the columns
// in ascending order with their values (a sum divided by max(merged
// weight, 1)) and clears the bits.  A parent whose columns pass the window
// takes another pass from the smallest column above it (tracked in the
// pass), so the runs still come out in ascending column; no parent leaves
// the kernel.  Arithmetic is __fmul_rn / __fadd_rn / __fdiv_rn, so
// nothing is contracted or reassociated; a minimum is taken as std::min
// takes it, (v < m) ? v : m.
//
// Bound: bytes (chip_smoke.merge_runs_bound).  Each padded slot of the
// children's rows is read once (12 B: its int64 index and float32 value),
// each row's parent and place in the grouping, each parent's two starts and
// its place in by_size, and each slot of the [M, width] rows written once
// (12 B), beside the run counts and the merged weights.  The kernels read
// the slots again (the live counts, a parent's windows past the first) and
// write and read the runs once between the fold and the layout (8 B a run).  A run of one column
// is folded by one lane at a time in its order: a parent whose entries are
// all one column (a top merge into one parent) is a serial chain of adds.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;       // also the column buckets
constexpr int kItems = 4;                   // slots a thread a tile
constexpr int kTile = kThreads * kItems;    // slots a tile
constexpr int kMinBlocks = 4;               // blocks an SM: <= 64 registers
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps * kItems * kWarps == kThreads,
              "one partition count a thread");

template <bool kMin>
__device__ __forceinline__ float fold(float acc, float v) {
  if (kMin) return (v < acc) ? v : acc;
  return __fadd_rn(acc, v);
}

// Exclusive prefix sum of v over the block in thread order; *total gets the
// block's sum.  Every thread of the block calls it, and a barrier comes
// between two calls (wsum is read after the call's one barrier).
__device__ __forceinline__ int block_exclusive_sum(int v, int* total,
                                                   int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = wsum[w];
    before += (w < warp) ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// Each row's live slots (idx >= 0 and val != 0) where kCount, and the
// smallest parent column of its live entries (INT_MAX where none) where
// kFirst: a warp a row.
template <bool kCount, bool kFirst>
__global__ void __launch_bounds__(kThreads)
row_scan(const long long* __restrict__ idx, const float* __restrict__ val,
         long long n, int width, const int* __restrict__ par,
         int* __restrict__ nnz, int* __restrict__ rowmin) {
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const int lane = threadIdx.x & 31;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
       row < n; row += warps) {
    const long long* ir = idx + row * width;
    const float* vr = val + row * width;
    int c = 0, first = INT_MAX;
#pragma unroll 8
    for (int j = lane; j < width; j += 32) {
      const long long id = ir[j];
      if (id >= 0 && vr[j] != 0.0f) {
        ++c;
        if (kFirst && id < n) first = min(first, par[id]);
      }
    }
    if (kCount) c = __reduce_add_sync(kFull, c);
    if (kFirst) first = __reduce_min_sync(kFull, first);
    if (lane == 0) {
      if (kCount) nnz[row] = c;
      if (kFirst) rowmin[row] = first;
    }
  }
}

// Each parent's weight where kWeights: the float32 sum of its children's
// live counts in ascending child order, as the host sums it; and where
// kFirst its smallest column, where its first window starts (a thread a
// parent).
template <bool kWeights, bool kFirst>
__global__ void __launch_bounds__(kThreads)
parent_scan(const int* __restrict__ nnz, const int* __restrict__ rowmin,
            const long long* __restrict__ order,
            const long long* __restrict__ child_start, int parents,
            float* __restrict__ merged_w, int* __restrict__ pmin) {
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < parents; p += static_cast<long long>(gridDim.x) * kThreads) {
    const long long end = child_start[p + 1];
    float s = 0.0f;
    int first = INT_MAX;
#pragma unroll 4
    for (long long c = child_start[p]; c < end; ++c) {
      const long long row = order[c];
      if (kWeights) s = __fadd_rn(s, __int2float_rn(nnz[row]));
      if (kFirst) first = min(first, rowmin[row]);
    }
    if (kWeights) merged_w[p] = s;
    if (kFirst) pmin[p] = first;
  }
}

// A block's work items are (parent, first column of a window): its parents
// are by_size[blockIdx.x], by_size[blockIdx.x + gridDim.x], ..., each in as
// many windows as its columns need.  The first tile of the next item is
// fetched before the current item's runs are written.
template <bool kMin, bool kWeighted>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_rows(const long long* __restrict__ idx, const float* __restrict__ val,
           long long n, int width, const int* __restrict__ par,
           const long long* __restrict__ order,
           const long long* __restrict__ child_start,
           const long long* __restrict__ by_size, int parents, int window,
           const int* __restrict__ nnz, const float* __restrict__ merged_w,
           const int* __restrict__ pmin, int* __restrict__ out_col,
           float* __restrict__ out_val, int* __restrict__ run_count,
           unsigned long long* state) {
  extern __shared__ float smem[];
  float* acc = smem;                                            // [window]
  unsigned* bits = reinterpret_cast<unsigned*>(acc + window);   // [window/32]
  int* scol = reinterpret_cast<int*>(bits + window / 32);       // [kTile]
  float* sv = reinterpret_cast<float*>(scol + kTile);           // [kTile]
  __shared__ int cnt[kThreads];      // partition counts, then destinations
  __shared__ int bstart[kWarps + 1];
  __shared__ int wsum[kWarps];
  __shared__ int s_cmin, s_cmax, s_next;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int dq = kThreads / width, dr = kThreads % width;
  for (int w = tid; w < window / 32; w += kThreads) bits[w] = 0u;

  // the current item, and the slots of its next tile as read
  long long t = blockIdx.x, p = 0, c0 = 0, nchild = 0;
  float div = 1.0f;
  int lo = 0;
  long long k = 0;
  int j = 0;
  long long frow[kItems], fid[kItems];
  float fw[kItems], fx[kItems];
  auto take_parent = [&]() {
    p = by_size[t];
    c0 = child_start[p];
    nchild = child_start[p + 1] - c0;
    lo = 0;
    if (pmin != nullptr) {        // the first window at the first column
      lo = pmin[p];
      if (lo == INT_MAX) nchild = 0;
    }
    if (kWeighted) {
      const float mw = merged_w[p];
      div = mw > 1.0f ? mw : 1.0f;
    }
  };
  auto fetch = [&]() {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      frow[i] = -1;
      fid[i] = -1;
      fx[i] = 0.0f;
      fw[i] = 1.0f;
      if (k < nchild) {
        frow[i] = order[c0 + k];
        fid[i] = idx[frow[i] * width + j];
        fx[i] = val[frow[i] * width + j];
        if (kWeighted) fw[i] = __int2float_rn(nnz[frow[i]]);
      }
      j += dr;
      k += dq;
      if (j >= width) {
        j -= width;
        ++k;
      }
    }
  };
  auto first_tile = [&]() {
    k = tid / width;
    j = tid % width;
    fetch();
  };
  if (t >= parents) return;
  take_parent();
  first_tile();
  int runs = 0, passes = 0;
  for (;;) {
    const int hi = (parents - lo < window) ? parents : lo + window;
    if (tid == 0) {
      s_cmin = INT_MAX;
      s_cmax = -1;
      s_next = INT_MAX;
    }
    int my_cmin = INT_MAX, my_cmax = -1, my_next = INT_MAX;
    const long long nslots = nchild * width;
    for (long long tile = 0; tile < nslots; tile += kTile) {
      int col[kItems];
      float v[kItems];
      bool ok[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        ok[i] = false;
        col[i] = 0;
        v[i] = 0.0f;
        const long long id = fid[i];
        const float x = fx[i];
        if (frow[i] >= 0 && id >= 0 && x != 0.0f) {
          if (id >= n) {
            atomicOr(&state[0], 1ull);
          } else {
            const int c = par[id];
            if (c >= lo && c < hi) {
              ok[i] = true;
              col[i] = c;
              v[i] = kWeighted ? __fmul_rn(x, fw[i]) : x;
            } else if (c >= hi) {
              my_next = min(my_next, c);
            }
          }
        }
      }
      if (tile + kTile < nslots) fetch();   // in flight while this folds
      // stable partition of the tile's entries among the warps by column:
      // counts by (bucket, item, warp), scanned in that order
      int rank[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int b = col[i] & (kWarps - 1);
        unsigned mine = 0u;
#pragma unroll
        for (int bb = 0; bb < kWarps; ++bb) {
          const unsigned m = __ballot_sync(kFull, ok[i] && b == bb);
          if (b == bb) mine = m;
          if (lane == bb) cnt[(bb * kItems + i) * kWarps + warp] = __popc(m);
        }
        rank[i] = __popc(mine & lanes_below);
      }
      __syncthreads();
      {
        int total;
        const int at = block_exclusive_sum(cnt[tid], &total, wsum);
        cnt[tid] = at;
        if (lane == 0) bstart[warp] = at;
        if (tid == 0) bstart[kWarps] = total;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (ok[i]) {
          const int b = col[i] & (kWarps - 1);
          const int d = cnt[(b * kItems + i) * kWarps + warp] + rank[i];
          scol[d] = col[i];
          sv[d] = v[i];
        }
      }
      __syncthreads();
      // each warp folds its columns' entries in order
      const int end = bstart[warp + 1];
      for (int base = bstart[warp]; base < end; base += 32) {
        const int pos = base + lane;
        const bool live = pos < end;
        const int c = live ? scol[pos] : 0;
        const float x = live ? sv[pos] : 0.0f;
        const unsigned grp = __match_any_sync(kFull, live ? c : -1 - lane);
        if (live && __ffs(grp) - 1 == lane) {      // the group's lowest lane
          const int o = c - lo;
          const unsigned bit = 1u << (o & 31);
          float a;
          if (atomicOr(&bits[o >> 5], bit) & bit) {
            a = fold<kMin>(acc[o], x);
          } else {
            a = x;      // 0 + x and min(x) are x: x is not 0
            my_cmin = min(my_cmin, c);
            my_cmax = max(my_cmax, c);
          }
          // the group's other lanes, in lane order
          for (unsigned rest = grp & (grp - 1u); rest; rest &= rest - 1u)
            a = fold<kMin>(a, sv[base + __ffs(rest) - 1]);
          acc[o] = a;
        }
      }
      __syncthreads();
    }
    my_cmin = __reduce_min_sync(kFull, my_cmin);
    my_cmax = __reduce_max_sync(kFull, my_cmax);
    my_next = __reduce_min_sync(kFull, my_next);
    if (lane == 0) {
      atomicMin(&s_cmin, my_cmin);
      atomicMax(&s_cmax, my_cmax);
      atomicMin(&s_next, my_next);
    }
    __syncthreads();
    const int cmin = s_cmin, cmax = s_cmax, next = s_next;
    // the next item: this parent's next window, or the block's next parent;
    // its first tile is fetched before this item's runs are written
    const long long out_p = p, out_base = c0 * width;
    const int out_lo = lo;
    const float out_div = div;
    const bool more = next != INT_MAX;
    if (more) {
      lo = next;
    } else {
      t += gridDim.x;
      if (t < parents) take_parent();
    }
    if (more || t < parents) first_tile();
    ++passes;
    if (cmax >= 0) {
      // the set bits between cmin and cmax, in order: a thread a run of
      // words, its first output slot from a block scan of the counts
      const int w0 = (cmin - out_lo) >> 5, w1 = (cmax - out_lo) >> 5;
      const int per = (w1 - w0 + kThreads) / kThreads;
      const int a0 = w0 + tid * per;
      const int a1 = min(a0 + per, w1 + 1);
      int mine = 0;
      for (int w = a0; w < a1; ++w) mine += __popc(bits[w]);
      int total;
      long long o = out_base + runs + block_exclusive_sum(mine, &total, wsum);
      for (int w = a0; w < a1; ++w) {
        unsigned m = bits[w];
        bits[w] = 0u;
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1u;
          const int off = (w << 5) + b;
          float a = acc[off];
          if (kWeighted) a = __fdiv_rn(a, out_div);
          out_col[o] = out_lo + off;
          out_val[o] = a;
          ++o;
        }
      }
      runs += total;
    }
    if (!more) {
      if (tid == 0) {
        run_count[out_p] = runs;
        atomicAdd(&state[1], static_cast<unsigned long long>(passes));
      }
      runs = 0;
      passes = 0;
    }
    __syncthreads();
    if (!more && t >= parents) break;
  }
}

__global__ void __launch_bounds__(kThreads)
pack_rows(const int* __restrict__ out_col, const float* __restrict__ out_val,
          const long long* __restrict__ child_start, int width_in,
          const int* __restrict__ run_count, long long parents, int width,
          long long* __restrict__ dst_idx, float* __restrict__ dst_val) {
  for (long long p = blockIdx.x; p < parents; p += gridDim.x) {
    const long long src = child_start[p] * width_in;
    const int count = run_count[p];
    long long* di = dst_idx + p * width;
    float* dv = dst_val + p * width;
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      const bool in = j < count;
      di[j] = in ? static_cast<long long>(out_col[src + j]) : -1ll;
      dv[j] = in ? out_val[src + j] : 0.0f;
    }
  }
}

template <bool kMin, bool kWeighted>
int launch_rows(const long long* idx, const float* val, long long n,
                int width, const int* par, const long long* order,
                const long long* child_start, const long long* by_size,
                int parents, int window, int* nnz, int* rowmin, int* pmin,
                int* out_col, float* out_val, int* run_count,
                float* merged_w, unsigned long long* state,
                cudaStream_t st) {
  cudaError_t err;
  const bool first = rowmin != nullptr;
  if (kWeighted || first) {
    const long long rows = (n + kWarps - 1) / kWarps;
    const unsigned row_blocks =
        static_cast<unsigned>(rows < 65536 ? rows : 65536);
    const unsigned parent_blocks =
        static_cast<unsigned>((parents + kThreads - 1) / kThreads);
    if (kWeighted && first) {
      row_scan<true, true><<<row_blocks, kThreads, 0, st>>>(
          idx, val, n, width, par, nnz, rowmin);
      parent_scan<true, true><<<parent_blocks, kThreads, 0, st>>>(
          nnz, rowmin, order, child_start, parents, merged_w, pmin);
    } else if (kWeighted) {
      row_scan<true, false><<<row_blocks, kThreads, 0, st>>>(
          idx, val, n, width, par, nnz, rowmin);
      parent_scan<true, false><<<parent_blocks, kThreads, 0, st>>>(
          nnz, rowmin, order, child_start, parents, merged_w, pmin);
    } else {
      row_scan<false, true><<<row_blocks, kThreads, 0, st>>>(
          idx, val, n, width, par, nnz, rowmin);
      parent_scan<false, true><<<parent_blocks, kThreads, 0, st>>>(
          nnz, rowmin, order, child_start, parents, merged_w, pmin);
    }
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  auto kernel = merge_rows<kMin, kWeighted>;
  const size_t smem = static_cast<size_t>(window) * 4 + window / 8 +
                      static_cast<size_t>(kTile) * 8;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long most = static_cast<long long>(sms) * per_sm;
  const unsigned blocks =
      static_cast<unsigned>(parents < most ? parents : most);
  kernel<<<blocks, kThreads, smem, st>>>(idx, val, n, width, par, order,
                                         child_start, by_size, parents,
                                         window, nnz, merged_w, pmin,
                                         out_col, out_val, run_count, state);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// combine_min: 1 for the min merge, 0 for the sum; weighted: 1 where the sum
// weights by size (nnz [N] and merged_w [M] then hold the live counts and
// the weights).  window: the columns a block holds at once, a multiple of
// 32.  rowmin [N] and pmin [M]: where given (a window narrower than the
// columns), each row's and parent's first column, and a parent's first
// window starts there.  state: 2 words, zero.
extern "C" int merge_runs_launch(const void* idx, const void* val,
                                 long long n, int width, const void* par,
                                 const void* order, const void* child_start,
                                 const void* by_size, int parents,
                                 int window, int combine_min, int weighted,
                                 void* nnz, void* rowmin, void* pmin,
                                 void* out_col, void* out_val,
                                 void* run_count, void* merged_w, void* state,
                                 void* stream) {
  if (n <= 0 || width <= 0 || parents <= 0 || window < 32 || window % 32 ||
      (combine_min && weighted) ||
      (weighted && (nnz == nullptr || merged_w == nullptr)) ||
      ((rowmin == nullptr) != (pmin == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* i = static_cast<const long long*>(idx);
  const float* v = static_cast<const float*>(val);
  const int* pr = static_cast<const int*>(par);
  const long long* o = static_cast<const long long*>(order);
  const long long* cs = static_cast<const long long*>(child_start);
  const long long* bs = static_cast<const long long*>(by_size);
  int* nz = static_cast<int*>(nnz);
  int* rm = static_cast<int*>(rowmin);
  int* pm = static_cast<int*>(pmin);
  int* oc = static_cast<int*>(out_col);
  float* ov = static_cast<float*>(out_val);
  int* rc = static_cast<int*>(run_count);
  float* mw = static_cast<float*>(merged_w);
  unsigned long long* s = static_cast<unsigned long long*>(state);
  if (combine_min)
    return launch_rows<true, false>(i, v, n, width, pr, o, cs, bs, parents,
                                    window, nz, rm, pm, oc, ov, rc, mw, s,
                                    st);
  if (weighted)
    return launch_rows<false, true>(i, v, n, width, pr, o, cs, bs, parents,
                                    window, nz, rm, pm, oc, ov, rc, mw, s,
                                    st);
  return launch_rows<false, false>(i, v, n, width, pr, o, cs, bs, parents,
                                   window, nz, rm, pm, oc, ov, rc, mw, s, st);
}

// The runs of merge_runs_launch as [parents, width] rows: int64 columns
// (-1 at pads) and float32 values (0 at pads); width >= every run count.
extern "C" int merge_runs_pack_launch(const void* out_col,
                                      const void* out_val,
                                      const void* child_start, int width_in,
                                      const void* run_count, long long parents,
                                      int width, void* dst_idx, void* dst_val,
                                      void* stream) {
  if (parents <= 0 || width <= 0 || width_in <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>(parents < 65535 ? parents : 65535);
  pack_rows<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(out_col), static_cast<const float*>(out_val),
      static_cast<const long long*>(child_start), width_in,
      static_cast<const int*>(run_count), parents, width,
      static_cast<long long*>(dst_idx), static_cast<float*>(dst_val));
  return static_cast<int>(cudaGetLastError());
}
