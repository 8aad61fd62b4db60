// One Jacobi sweep of multi-source Bellman-Ford over node-major distance
// fields, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  It is the relax body of the JAX package's XLA
// program sph_tpu/ops/shortest_path.py::_bellman_ford (no Pallas source),
// which the port ran as a chain of torch ops (ops/shortest_path.py
// relax_reference, its twin).  For the fields d [N + 1, F] float32 (row N
// the +inf sentinel) and each node v's live in-edges (u, w), in
// FieldGraph's rank order:
//
//   d'[v, f]    = min(d[v, f], min over v's in-edges of d[u, f] + w)
//   frontier[f] = min of d'[v, f] over the v where d'[v, f] < d[v, f]
//                 (+inf where no node was lowered)
//
// Each candidate is one float32 add and min is exact, so d' and the
// frontier are bit-equal to the twin's whatever the order.  The sweep reads
// d and writes d' to another buffer (Jacobi): relaxing in place would be
// Gauss-Seidel and change the sweep counts.  Build without fast-math flags.
//
// What bounds it: bytes.  A full sweep's compulsory bytes are d read once
// and d' written once, (N + 1) F 4 each, the in-edges' 8 bytes and the
// frontier: 146 MB at rgb_geo's level 0 (N = 57600, E = 3,513,962 in-edges,
// F = 256), 0.044 ms at 3.35 TB/s.  Gathering every in-edge's source row is
// E F 4 = 3.60 GB a sweep there, served mostly from the 50 MB L2 (the
// table is 59 MB), whose rate then bounds the sweep.  Only fewer gathered
// bytes make it faster, and most of them cannot lower anything:
//
// The delta sweep (the batch path).  If d_t[u, f] = d_{t-1}[u, f], then
// d_t[v, f] <= d_{t-1}[u, f] + w = d_t[u, f] + w by the same float32 add,
// so at sweep t + 1 the candidate from u cannot lower v: only sources
// that changed in the sweep before can.  The fields of a chunk of 256 are
// split into 32 sectors of 8 contiguous fields (32 bytes, the unit in
// which L2 serves a read), one a lane, and each sweep writes one word a
// node a chunk whose bit l says that sector l of the node changed
// (`out_changed`, [chunks, N + 1]).  The next sweep reads those words
// (`changed`): each in-edge's word is broadcast with its id and weight, an
// edge whose word is 0 is skipped, and a lane loads its sector of the
// source only when its bit is set.  The fields alternate between two
// caller-owned buffers; the one written holds the sweep before last, so
// only the sectors in changed[v] | out_changed[v] are rewritten (a sector
// unchanged in both sweeps already holds the value).  d', the frontier and
// the sweep counts are those of the full sweep, bit for bit.  The first
// sweep of a batch starts from masks that mark every sector holding a
// finite value, and the buffer it writes starts as a copy of the fields.
//
// The stop test runs in the kernel: the block that finishes last (an
// atomic ticket after __threadfence) writes `stop` = no finite frontier
// value, or, with evaluated values, every one at or below its field's
// frontier; then sets the next sweep's frontier to +inf and the ticket
// back to 0.  A batch's sweep is one launch and one 4-byte copy of `stop`.
//
// A stateless sweep (the entry point ``relax``) passes no masks: every
// sector is gathered and written, the frontier filled with +inf by the
// caller, no stop test.
//
// Layout.  One warp a node (a grid-stride loop), its lanes over a chunk,
// 8 contiguous fields a lane (two float4 loads when the row pitch `ld` is
// a multiple of 4 and the rows are 16-byte aligned, else 8 scalars; a
// batch pads its rows to a multiple of 8 fields, so it always takes the
// float4 loads).  The warp reads the node's in-edge ids, weights and
// words from the CSR (live slots only), 32 at a time, one a lane.
//
// The gathers are latency-bound: a warp's loads in flight, over the
// latency of L2, set the rate (the full sweep's 7.2 TB/s is about 64 KB in
// flight an SM), so the warp takes the in-edges with a nonzero word
// kGroup at a time, each lane loading its sector of a source where its
// bit is set, and keeps the running minima in registers.  A delta sweep
// thus costs one round trip a kGroup of in-edges whose word is nonzero
// (0.64-0.72 of them mid-batch at rgb_geo's level 0, with 0.2-0.3 of the
// sectors): its time follows those edges more than its bytes.  The warps
// take the nodes in FieldGraph's schedule (`order`, a reverse
// Cuthill-McKee order of the graph) rather than in row order: the warps in
// flight then hold a compact region of the graph, whose in-neighbours
// they share, so more gathers hit in L1 and L2 and fewer go to device
// memory.  The rows keep their layout (the twin's), and the order of the
// nodes changes no bit.  Each lane keeps the least lowered value of its
// fields over its warp's nodes; the block merges its warps' by
// shared-memory atomicMin, then issues one global atomicMin a field.  The
// values are non-negative floats, ordered as their bits are as unsigned
// integers, so the atomics give the same bits in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLane = 8;               // fields a lane holds: one sector
constexpr int kChunk = 32 * kLane;     // fields a chunk, one a thread
constexpr int kGroup = 4;              // in-edges gathered at once
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;

static_assert(kChunk == kThreads, "one frontier slot a thread");

struct Sweep {
  const float* d;            // [n + 1, ld] the fields before the sweep
  const int* src;            // [E] the in-edges' source rows
  const float* w;            // [E] their weights
  const long long* off;      // [n + 1]: row v's in-edges at off[v]..off[v+1]
  const int* order;          // [n] the rows in the order the warps take them
  float* out;                // [n + 1, ld] the fields after the sweep
  unsigned* frontier;        // [f] float bits, +inf on entry
  // the batch path; all null for a stateless sweep
  const unsigned* changed;   // [chunks, n + 1] the sweep before's sectors
  unsigned* out_changed;     // [chunks, n + 1] this sweep's
  unsigned* next_frontier;   // [f] set to +inf for the next sweep
  int* ticket;               // blocks finished; 0 on entry and on exit
  int* stop;                 // the stop test's result
  const int* eval_rows;      // [n_eval] evaluated values (null: none)
  const int* eval_cols;
  int n, f, ld, n_eval;      // ld: the fields' row pitch (>= f)
};

// a lane's sector: fields at .. at + 7 of `row`, +inf past f
template <bool kVec>
__device__ __forceinline__ void load_sector(const float* __restrict__ row,
                                            int at, int f,
                                            float (&v)[kLane]) {
  const float inf = __int_as_float(0x7f800000);
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kLane / 4; ++h) {
      float4 q = make_float4(inf, inf, inf, inf);
      if (at + 4 * h < f)
        q = __ldg(reinterpret_cast<const float4*>(row + at + 4 * h));
      v[4 * h] = q.x;
      v[4 * h + 1] = q.y;
      v[4 * h + 2] = q.z;
      v[4 * h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLane; ++k) v[k] = at + k < f ? __ldg(row + at + k)
                                                      : inf;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_sector(float* __restrict__ row, int at,
                                             int f, const float (&v)[kLane]) {
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kLane / 4; ++h)
      if (at + 4 * h < f)
        *reinterpret_cast<float4*>(row + at + 4 * h) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kLane; ++k)
      if (at + k < f) row[at + k] = v[k];
  }
}

// one slot of 32 in-edges, a lane's edge (u, m, w): the edges with a
// nonzero word kGroup at a time, each lane loading its sector of a source
// where its bit is set
template <bool kVec>
__device__ __forceinline__ void gather(
    const Sweep& s, int at, unsigned bit, int my_u, unsigned my_m,
    float my_w, float (&best)[kLane]) {
  const float inf = __int_as_float(0x7f800000);
  unsigned todo = __ballot_sync(kAll, my_m != 0);
  while (todo) {
    float cand[kGroup][kLane];
    float wq[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const bool any = todo != 0;
      const int j = any ? __ffs(todo) - 1 : 0;
      todo &= todo - 1;
      const int u = __shfl_sync(kAll, my_u, j);
      wq[q] = __shfl_sync(kAll, my_w, j);
      const unsigned m = __shfl_sync(kAll, my_m, j);
      if (any && (m & bit)) {
        load_sector<kVec>(s.d + static_cast<long long>(u) * s.ld, at, s.f,
                          cand[q]);
      } else {
#pragma unroll
        for (int k = 0; k < kLane; ++k) cand[q][k] = inf;
      }
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
#pragma unroll
      for (int k = 0; k < kLane; ++k)
        best[k] = fminf(best[k], __fadd_rn(cand[q][k], wq[q]));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) relax_kernel(const Sweep s) {
  __shared__ unsigned s_front[kChunk];
  __shared__ int s_last;
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const unsigned bit = 1u << lane;
  const long long ld = s.ld;
  const long long rows = static_cast<long long>(s.n) + 1;
  const long long first =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (int c0 = 0, c = 0; c0 < s.f; c0 += kChunk, ++c) {
    const unsigned* __restrict__ chg =
        s.changed ? s.changed + c * rows : nullptr;
    unsigned* __restrict__ chg_out =
        s.out_changed ? s.out_changed + c * rows : nullptr;
    const int at = c0 + kLane * lane;
    s_front[threadIdx.x] = kInfBits;
    __syncthreads();
    float low[kLane];
#pragma unroll
    for (int k = 0; k < kLane; ++k) low[k] = inf;
    for (long long i = first; i < rows; i += stride) {
      const long long v = i < s.n ? __ldg(s.order + i) : i;
      const unsigned own = chg ? __ldg(chg + v) : kAll;
      float best[kLane];
#pragma unroll
      for (int k = 0; k < kLane; ++k) best[k] = inf;
      unsigned seen = 0;     // the OR of the in-edges' words
      // row N, the sentinel, has no in-edges
      const long long e0 = v < s.n ? __ldg(s.off + v) : 0;
      const long long e1 = v < s.n ? __ldg(s.off + v + 1) : 0;
      for (long long e = e0; e < e1; e += 32) {
        int my_u = 0;
        unsigned my_m = 0;
        float my_w = 0.f;
        if (e + lane < e1) {
          my_u = __ldg(s.src + e + lane);
          my_w = __ldg(s.w + e + lane);
          my_m = chg ? __ldg(chg + my_u) : kAll;
        }
        seen |= __reduce_or_sync(kAll, my_m);
        gather<kVec>(s, at, bit, my_u, my_m, my_w, best);
      }
      bool lowered = false;
      if ((seen | own) & bit) {
        float old[kLane];
        load_sector<kVec>(s.d + v * ld, at, s.f, old);
#pragma unroll
        for (int k = 0; k < kLane; ++k) {
          const float b = fminf(old[k], best[k]);
          if (b < old[k]) {
            lowered = true;
            low[k] = fminf(low[k], b);
          }
          best[k] = b;
        }
        // the written buffer holds the sweep before last: rewrite the
        // sectors that changed in that sweep or in this one
        if (lowered || (own & bit))
          store_sector<kVec>(s.out + v * ld, at, s.f, best);
      }
      if (chg_out) {
        const unsigned word = __ballot_sync(kAll, lowered);
        if (lane == 0) chg_out[v] = word;
      }
    }
#pragma unroll
    for (int k = 0; k < kLane; ++k)
      if (low[k] < inf) atomicMin(&s_front[kLane * lane + k],
                                  __float_as_uint(low[k]));
    __syncthreads();
    const int fi = c0 + threadIdx.x;
    if (fi < s.f && s_front[threadIdx.x] != kInfBits)
      atomicMin(s.frontier + fi, s_front[threadIdx.x]);
    __syncthreads();    // before the next chunk resets s_front
  }
  if (!s.ticket) return;

  // the stop test, in the block that finishes last
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(s.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int going = 0;
  for (int i = threadIdx.x; i < s.f; i += kThreads)
    going |= __ldcg(s.frontier + i) != kInfBits;
  int stop = !__syncthreads_or(going);
  if (s.eval_rows) {
    int late = 0;
    for (int j = threadIdx.x; j < s.n_eval; j += kThreads) {
      const int col = __ldg(s.eval_cols + j);
      const float val = __ldcg(s.out + __ldg(s.eval_rows + j) * ld + col);
      late |= !(val <= __uint_as_float(__ldcg(s.frontier + col)));
    }
    stop |= !__syncthreads_or(late);
  }
  for (int i = threadIdx.x; i < s.f; i += kThreads)
    s.next_frontier[i] = kInfBits;
  if (threadIdx.x == 0) {
    *s.stop = stop;
    *s.ticket = 0;
  }
}

template <bool kVec>
int launch(const Sweep& s, int sms, cudaStream_t stream) {
  // blocks resident on an SM, from the occupancy calculator, once a process
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, relax_kernel<kVec>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
  }
  const long long rows = static_cast<long long>(s.n) + 1;
  const long long want = (rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  relax_kernel<kVec><<<blocks, kThreads, 0, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d, out [n + 1, f] float32 rows `ld` floats apart; src [E] int32 rows of
// the in-edges' sources and w [E] float32 their weights, row v's at
// off[v] .. off[v + 1] (off int64 [n + 1]); order int32 [n], a
// permutation of the rows; frontier [f] float32, +inf on entry; sms: the
// card's SMs.  The batch path: changed, out_changed int32
// [ceil(f / 256), n + 1]; next_frontier [f] float32; ticket int32, 0; stop
// int32; eval_rows, eval_cols int32 [n_eval] (both null when no value is
// evaluated).  A stateless sweep passes null for changed and all that
// follows.
extern "C" int bellman_ford_relax_launch(
    const void* d, const void* src, const void* w, const void* off,
    const void* order, int n, int f, int ld, int sms, void* out,
    void* frontier, const void* changed,
    void* out_changed, void* next_frontier, void* ticket, void* stop,
    const void* eval_rows, const void* eval_cols, int n_eval, void* stream) {
  if (f <= 0 || n < 0) return 0;
  if (ld < f || !order || (changed && !(out_changed && next_frontier &&
                                        ticket && stop)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool batch = changed != nullptr;
  const Sweep s{static_cast<const float*>(d),
                static_cast<const int*>(src),
                static_cast<const float*>(w),
                static_cast<const long long*>(off),
                static_cast<const int*>(order),
                static_cast<float*>(out),
                static_cast<unsigned*>(frontier),
                static_cast<const unsigned*>(changed),
                static_cast<unsigned*>(batch ? out_changed : nullptr),
                static_cast<unsigned*>(batch ? next_frontier : nullptr),
                static_cast<int*>(batch ? ticket : nullptr),
                static_cast<int*>(batch ? stop : nullptr),
                static_cast<const int*>(batch ? eval_rows : nullptr),
                static_cast<const int*>(batch ? eval_cols : nullptr),
                n, f, ld, n_eval};
  const bool vec = ld % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(s, sms, st) : launch<false>(s, sms, st);
}
