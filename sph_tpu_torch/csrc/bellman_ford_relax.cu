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
// What bounds it: bytes.  The compulsory bytes are d read once and d'
// written once, (N + 1) F 4 each, the in-edges' 8 bytes (id, weight) and
// the frontier: 146 MB at rgb_geo's level 0 (N = 57600, E = 3,513,962
// in-edges, F = 256), 0.044 ms at 3.35 TB/s.  The gathered bytes are far
// more: every in-edge reads its source's F values, E F 4 = 3.60 GB a sweep
// there.  The [N + 1, 256] table (59 MB) is about the size of the 50 MB L2,
// so most of those reads are served from L2, whose rate bounds the sweep.
//
// Design.  One warp a node, its lanes over a chunk of 256 fields, 8 a lane
// (two float4 loads when F % 4 == 0 and the rows are 16-byte aligned, else
// 8 scalars 32 fields apart), so each in-edge is one coalesced read of the
// source's row.  The warp reads the node's in-edge ids and weights from
// the CSR (live slots only), 32 at a time, one a lane, and broadcasts each
// with __shfl_sync; the running minima stay in registers, so no
// [rows, slots, F] candidate buffer goes through device memory.  Each lane
// keeps the least lowered value of its fields over every node its warp
// takes (a grid-stride loop); the block merges its warps' by shared-memory
// atomicMin, then issues one global atomicMin a field into the caller's
// frontier, which the wrapper fills with +inf before the launch.  The
// values are non-negative floats, ordered as their bits are as unsigned
// integers, so the atomics give the same bits in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLane = 8;               // fields a lane holds
constexpr int kChunk = 32 * kLane;     // fields a chunk, one a thread
constexpr unsigned kInfBits = 0x7f800000u;

static_assert(kChunk == kThreads, "one frontier slot a thread");

// the chunk slot of a lane's k-th field
template <bool kVec>
__device__ __forceinline__ int slot(int lane, int k) {
  return kVec ? 4 * (lane + 32 * (k >> 2)) + (k & 3) : lane + 32 * k;
}

template <bool kVec>
__device__ __forceinline__ void load_fields(const float* __restrict__ row,
                                            int c0, int lane, int f,
                                            float (&v)[kLane]) {
  const float inf = __int_as_float(0x7f800000);
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kLane / 4; ++h) {
      const int at = c0 + 4 * (lane + 32 * h);
      float4 q = make_float4(inf, inf, inf, inf);
      if (at < f) q = __ldg(reinterpret_cast<const float4*>(row + at));
      v[4 * h] = q.x;
      v[4 * h + 1] = q.y;
      v[4 * h + 2] = q.z;
      v[4 * h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const int at = c0 + lane + 32 * k;
      v[k] = at < f ? __ldg(row + at) : inf;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_fields(float* __restrict__ row, int c0,
                                             int lane, int f,
                                             const float (&v)[kLane]) {
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kLane / 4; ++h) {
      const int at = c0 + 4 * (lane + 32 * h);
      if (at < f)
        *reinterpret_cast<float4*>(row + at) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const int at = c0 + lane + 32 * k;
      if (at < f) row[at] = v[k];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
relax_kernel(const float* __restrict__ d, const int* __restrict__ src,
             const float* __restrict__ w, const long long* __restrict__ off,
             int n, int f, float* __restrict__ out,
             unsigned* __restrict__ frontier) {
  __shared__ unsigned s_front[kChunk];
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(n) + 1;
  const long long first =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (int c0 = 0; c0 < f; c0 += kChunk) {
    s_front[threadIdx.x] = kInfBits;
    __syncthreads();
    float low[kLane];
#pragma unroll
    for (int k = 0; k < kLane; ++k) low[k] = inf;
    for (long long v = first; v < rows; v += stride) {
      float old[kLane], best[kLane];
      load_fields<kVec>(d + v * f, c0, lane, f, old);
#pragma unroll
      for (int k = 0; k < kLane; ++k) best[k] = old[k];
      // row N, the sentinel, has no in-edges
      const long long e0 = v < n ? off[v] : 0;
      const long long e1 = v < n ? off[v + 1] : 0;
      for (long long e = e0; e < e1; e += 32) {
        const int cnt = static_cast<int>(e1 - e < 32 ? e1 - e : 32);
        int my_u = 0;
        float my_w = 0.f;
        if (lane < cnt) {
          my_u = __ldg(src + e + lane);
          my_w = __ldg(w + e + lane);
        }
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const int u = __shfl_sync(0xffffffffu, my_u, j);
          const float wj = __shfl_sync(0xffffffffu, my_w, j);
          float cand[kLane];
          load_fields<kVec>(d + static_cast<long long>(u) * f, c0, lane, f,
                            cand);
#pragma unroll
          for (int k = 0; k < kLane; ++k)
            best[k] = fminf(best[k], __fadd_rn(cand[k], wj));
        }
      }
      store_fields<kVec>(out + v * f, c0, lane, f, best);
#pragma unroll
      for (int k = 0; k < kLane; ++k)
        if (best[k] < old[k]) low[k] = fminf(low[k], best[k]);
    }
#pragma unroll
    for (int k = 0; k < kLane; ++k)
      if (low[k] < inf) atomicMin(&s_front[slot<kVec>(lane, k)],
                                  __float_as_uint(low[k]));
    __syncthreads();
    const int at = c0 + threadIdx.x;
    if (at < f && s_front[threadIdx.x] != kInfBits)
      atomicMin(frontier + at, s_front[threadIdx.x]);
    __syncthreads();    // before the next chunk resets s_front
  }
}

template <bool kVec>
int launch(const void* d, const void* src, const void* w, const void* off,
           int n, int f, int sms, void* out, void* frontier,
           cudaStream_t stream) {
  // blocks resident on an SM, from the occupancy calculator, once a process
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, relax_kernel<kVec>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
  }
  const long long rows = static_cast<long long>(n) + 1;
  const long long want = (rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  relax_kernel<kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(d), static_cast<const int*>(src),
      static_cast<const float*>(w), static_cast<const long long*>(off), n, f,
      static_cast<float*>(out), static_cast<unsigned*>(frontier));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d, out [n + 1, f] float32; src [E] int32 rows of the in-edges' sources
// and w [E] float32 their weights, row v's at off[v] .. off[v + 1] (off
// int64 [n + 1]); frontier [f] float32, +inf on entry; sms: the card's SMs.
extern "C" int bellman_ford_relax_launch(const void* d, const void* src,
                                         const void* w, const void* off,
                                         int n, int f, int sms, void* out,
                                         void* frontier, void* stream) {
  if (f <= 0 || n < 0) return 0;
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(d, src, w, off, n, f, sms, out, frontier, s)
             : launch<false>(d, src, w, off, n, f, sms, out, frontier, s);
}
