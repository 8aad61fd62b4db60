// Exact t-SNE repulsion over all pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel sph_tpu/ops/pallas/tsne_kernels.py::tsne_repulsion
// (kernel body _rep_kernel), the repulsion of the exact sparse-P t-SNE tier.
// For every row i < n_valid it sums over the columns j != i, j < n_valid,
// with the Student-t weight w = 1 / (1 + dx^2 + dy^2) of the direct
// differences dx = y_ix - y_jx, dy = y_iy - y_jy:
//
//   z = sum w,   s2 = sum w^2,   ax = sum w^2 y_jx,   ay = sum w^2 y_jy,
//
// and writes rep_i = s2 y_i - (ax, ay) and the row's z.  Rows >= n_valid
// (up to npad) come out exactly 0.  The caller sums z to Z.
//
// What bounds it: arithmetic, with no P to read.  Each pair costs about ten
// FP32 operations and one reciprocal, and a call visits n_valid^2 pairs:
// 1e12 at 1M points.  The reciprocal runs on the SFU, 16 a clock per SM,
// about 4e12 a second on 132 SMs: 0.25 s a call.  The FP32 pipes give about
// 0.3 s.  Prediction before the first run on an H100: 0.4-0.6 s a call at
// 1M points.
//
// Design.  The TPU kernel walks all column blocks inside one grid step per
// row block; here a block of 128 threads owns 512 rows (four per thread, for
// independent work in flight) and loops over all valid columns itself, so
// nothing carries between blocks and no atomics are needed.  Columns are
// staged through shared memory in tiles of 1024 points; every thread reads
// the same column at once, a broadcast.  Columns >= n_valid are never
// visited.  Only the tiles that hold one of the block's own rows (the
// diagonal) or the ragged end of the columns take the masked loop.
//
// Accuracy.  A single running float32 sum over 1e6 terms drifts by about
// sqrt(N) eps.  Each row instead sums 128 columns at a time into chunk-local
// partials (at most 128 eps relative, worst case), and folds each partial
// into its running sum with Kahan compensation.
//
// The reciprocal is __fdividef(1, d), the SFU's approximate reciprocal
// (2 ulp), not the IEEE division that 1.0f / d compiles to without fast
// math (a refinement sequence several times longer).  d >= 1 always, far
// below the 2^126 where __fdividef returns 0.
//
// Requirements, checked by the Python wrapper: y is [npad, 2] float32,
// contiguous and 8-byte aligned; 0 <= n_valid <= npad.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;                      // rows per thread
constexpr int kBlockRows = kThreads * kRows;  // 512 rows per block
constexpr int kTile = 1024;                   // columns staged per pass
constexpr int kChunk = 128;                   // columns per partial sum

struct Acc {
  float z, s2, ax, ay;
};

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

template <bool kMasked>
__device__ __forceinline__ void chunk_sums(const float2* __restrict__ tile,
                                           int j0, int col0, int n_valid,
                                           const float (&xi)[kRows],
                                           const float (&yi)[kRows],
                                           const int (&ri)[kRows],
                                           Acc (&part)[kRows]) {
#pragma unroll 4
  for (int j = j0; j < j0 + kChunk; ++j) {
    const float2 c = tile[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dx = xi[r] - c.x;
      const float dy = yi[r] - c.y;
      float w = __fdividef(1.0f, 1.0f + (dx * dx + dy * dy));
      if (kMasked) {
        const int col = col0 + j;
        w = (col < n_valid && col != ri[r]) ? w : 0.0f;
      }
      const float w2 = w * w;
      part[r].z += w;
      part[r].s2 += w2;
      part[r].ax += w2 * c.x;
      part[r].ay += w2 * c.y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
repulsion_kernel(const float2* __restrict__ y, int npad, int n_valid,
                 float2* __restrict__ rep, float* __restrict__ zrow) {
  __shared__ __align__(16) float2 tile[kTile];

  const int block_lo = blockIdx.x * kBlockRows;
  const int block_hi = block_lo + kBlockRows;

  int ri[kRows];
  float xi[kRows], yi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    ri[r] = block_lo + r * kThreads + threadIdx.x;
    const float2 v = ri[r] < n_valid ? y[ri[r]] : make_float2(0.f, 0.f);
    xi[r] = v.x;
    yi[r] = v.y;
  }

  Acc sum[kRows], comp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    sum[r] = Acc{0.f, 0.f, 0.f, 0.f};
    comp[r] = Acc{0.f, 0.f, 0.f, 0.f};
  }

  // the whole block is padding: the branch is uniform, before any barrier
  if (block_lo < n_valid) {
    for (int c0 = 0; c0 < n_valid; c0 += kTile) {
      __syncthreads();                          // previous tile consumed
      for (int t = threadIdx.x; t < kTile; t += kThreads) {
        const int col = c0 + t;
        tile[t] = col < n_valid ? y[col] : make_float2(0.f, 0.f);
      }
      __syncthreads();
      const bool masked = c0 + kTile > n_valid ||
                          (c0 < block_hi && block_lo < c0 + kTile);
      for (int j0 = 0; j0 < kTile; j0 += kChunk) {
        if (c0 + j0 >= n_valid) break;          // uniform across the block
        Acc part[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] = Acc{0.f, 0.f, 0.f, 0.f};
        if (masked) {
          chunk_sums<true>(tile, j0, c0, n_valid, xi, yi, ri, part);
        } else {
          chunk_sums<false>(tile, j0, c0, n_valid, xi, yi, ri, part);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          kahan_add(sum[r].z, comp[r].z, part[r].z);
          kahan_add(sum[r].s2, comp[r].s2, part[r].s2);
          kahan_add(sum[r].ax, comp[r].ax, part[r].ax);
          kahan_add(sum[r].ay, comp[r].ay, part[r].ay);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ri[r];
    if (row >= npad) continue;
    if (row < n_valid) {
      const float z = sum[r].z - comp[r].z;
      const float s2 = sum[r].s2 - comp[r].s2;
      const float ax = sum[r].ax - comp[r].ax;
      const float ay = sum[r].ay - comp[r].ay;
      rep[row] = make_float2(s2 * xi[r] - ax, s2 * yi[r] - ay);
      zrow[row] = z;
    } else {
      rep[row] = make_float2(0.f, 0.f);
      zrow[row] = 0.f;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tsne_repulsion_launch(const void* y, int npad, int n_valid,
                                     void* rep, void* zrow, void* stream) {
  const int blocks = (npad + kBlockRows - 1) / kBlockRows;
  if (blocks > 0) {
    repulsion_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(y), npad, n_valid,
        static_cast<float2*>(rep), static_cast<float*>(zrow));
  }
  return static_cast<int>(cudaGetLastError());
}
