// The sparse t-SNE attraction over P's support, for Hopper (sm_90a).
//
// Replaces the XLA program sph_tpu/models/tsne.py::_attractive_forces (no
// Pallas source: on the TPU it is a gather fused with its elementwise
// arithmetic).  For each P row r (point i = row0 + r of y) it sums over the
// row's padded entries (j, p), ids of -1 adding nothing:
//
//   attr_r = sum_j p * w * (y_i - y_j),   w = 1 / (1 + |y_i - y_j|^2).
//
// y_j comes from y [Npad, 2] (float32), or, packed, from the u16 table
// [Npad] built by ops/packing.py: the word (q0 << 16) | q1 unpacks to
// (fma(q0, s0, lo0), fma(q1, s1, lo1)) with prm = (lo0, s0, lo1, s1), as
// the JAX package unpacks it on the grid tier.
//
// What bounds it: bytes.  The ids and values are read once, 8 bytes an
// entry (rows x W x 8: 512 MB at the 1M grid tier's 1,000,448 x 64, about
// 0.15 ms at 3.35 TB/s); the gathered table (4 MB packed, 8 MB of y
// unpacked, at 10^6 points) stays in the 50 MB L2, where each gather costs
// a 32-byte sector for 4 or 8 bytes.
//
// Design.  One group of G lanes owns one row (G = the row's 4-entry vectors
// rounded up to a power of two, at most 32: 16 at W = 64, two rows a warp).
// Each lane reads its ids and values with 16-byte loads, gathers its four
// neighbours (four independent loads in flight a lane), sums them in
// registers in entry order, and the group reduces its lanes with xor
// shuffles in a fixed order.  So every row is summed in one order that
// depends only on W: no atomics, two calls give the same bits, and a row's
// result does not depend on how many rows the call covers (a shard's
// window equals the full call row for row).  Rows whose width is not a
// multiple of 4, or whose arrays are not 16-byte aligned, take one entry a
// lane in the same scheme.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int kVec>
__device__ __forceinline__ void load_entries(const int* ids, const float* vals,
                                             int at, int (&id)[kVec],
                                             float (&pv)[kVec]) {
  if constexpr (kVec == 4) {
    const int4 a = *reinterpret_cast<const int4*>(ids + at);
    const float4 b = *reinterpret_cast<const float4*>(vals + at);
    id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
    pv[0] = b.x; pv[1] = b.y; pv[2] = b.z; pv[3] = b.w;
  } else {
    id[0] = ids[at];
    pv[0] = vals[at];
  }
}

template <bool kPacked, int kVec>
__global__ void __launch_bounds__(kThreads)
attraction_kernel(const float2* __restrict__ y,
                  const uint32_t* __restrict__ table,
                  const float* __restrict__ prm, const int* __restrict__ p_idx,
                  const float* __restrict__ p_val, int rows, int width,
                  long long row0, int group, float2* __restrict__ out) {
  const int sub = threadIdx.x & (group - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / group) +
      threadIdx.x / group;
  const bool live = row < rows;
  float ax = 0.f, ay = 0.f;
  if (live) {
    float lo0 = 0.f, s0 = 0.f, lo1 = 0.f, s1 = 0.f;
    if (kPacked) {
      lo0 = prm[0];
      s0 = prm[1];
      lo1 = prm[2];
      s1 = prm[3];
    }
    const float2 yi = y[row0 + row];
    const int* ids = p_idx + row * width;
    const float* vals = p_val + row * width;
    for (int at = sub * kVec; at < width; at += group * kVec) {
      int id[kVec];
      float pv[kVec];
      load_entries<kVec>(ids, vals, at, id, pv);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int j = id[v];
        if (j < 0) continue;
        float nx, ny;
        if (kPacked) {
          const uint32_t g = __ldg(table + j);
          nx = fmaf(static_cast<float>(g >> 16), s0, lo0);
          ny = fmaf(static_cast<float>(g & 0xffffu), s1, lo1);
        } else {
          const float2 q = __ldg(y + j);
          nx = q.x;
          ny = q.y;
        }
        const float dx = yi.x - nx;
        const float dy = yi.y - ny;
        const float w = 1.0f / (1.0f + dx * dx + dy * dy);
        const float c = pv[v] * w;
        ax = fmaf(c, dx, ax);
        ay = fmaf(c, dy, ay);
      }
    }
  }
  // every lane of the warp takes part, rows past the end with zeros
  for (int off = group >> 1; off > 0; off >>= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, off);
    ay += __shfl_xor_sync(0xffffffffu, ay, off);
  }
  if (live && sub == 0) out[row] = make_float2(ax, ay);
}

template <bool kPacked, int kVec>
void launch(const void* y, const void* table, const void* prm,
            const void* p_idx, const void* p_val, int rows, int width,
            long long row0, int group, void* out, cudaStream_t stream) {
  const int rows_per_block = kThreads / group;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  attraction_kernel<kPacked, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float2*>(y), static_cast<const uint32_t*>(table),
      static_cast<const float*>(prm), static_cast<const int*>(p_idx),
      static_cast<const float*>(p_val), rows, width, row0, group,
      static_cast<float2*>(out));
}

}  // namespace

// Lanes a row: the row's vectors of kVec entries, rounded up to a power of
// two, at most 32.
extern "C" int tsne_attraction_group(int width, int vec) {
  const int vectors = (width + vec - 1) / vec;
  int group = 1;
  while (group < vectors && group < 32) group <<= 1;
  return group;
}

// table == nullptr: unpacked (y_j from y), else packed (prm required).
extern "C" int tsne_attraction_launch(const void* y, const void* table,
                                      const void* prm, const void* p_idx,
                                      const void* p_val, int rows, int width,
                                      long long row0, void* out,
                                      void* stream) {
  if (rows <= 0) return 0;
  const bool aligned =
      width % 4 == 0 && reinterpret_cast<uintptr_t>(p_idx) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p_val) % 16 == 0;
  const int vec = aligned ? 4 : 1;
  const int group = tsne_attraction_group(width, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table != nullptr) {
    if (aligned)
      launch<true, 4>(y, table, prm, p_idx, p_val, rows, width, row0, group,
                      out, s);
    else
      launch<true, 1>(y, table, prm, p_idx, p_val, rows, width, row0, group,
                      out, s);
  } else {
    if (aligned)
      launch<false, 4>(y, table, prm, p_idx, p_val, rows, width, row0, group,
                       out, s);
    else
      launch<false, 1>(y, table, prm, p_idx, p_val, rows, width, row0, group,
                       out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
