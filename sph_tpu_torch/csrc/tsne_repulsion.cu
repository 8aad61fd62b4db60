// Exact t-SNE repulsion over all pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel sph_tpu/ops/pallas/tsne_kernels.py::tsne_repulsion
// (kernel body _rep_kernel), the repulsion of the exact sparse-P t-SNE tier
// and the Z of the KL divergence on the card.  For every row i < n_valid it
// sums over the columns j != i, j < n_valid, with the Student-t weight
// w = 1 / (1 + dx^2 + dy^2) of the direct differences dx = y_ix - y_jx,
// dy = y_iy - y_jy:
//
//   z = sum w,   fx = sum w^2 dx,   fy = sum w^2 dy,
//
// and writes rep_i = (fx, fy) and the row's z.  Rows >= n_valid (up to npad)
// come out exactly 0 and are never read.  The caller sums z to Z.
//
// What bounds it: arithmetic, with no P to read.  A call visits n_valid^2
// pairs, 1e12 at 1M points.  Three floors on an H100 SXM (132 SMs, 1.98 GHz):
//   - operations: 14 float32 operations a pair at 67 TFLOP/s, 0.209 s
//     (14 counts the TPU kernel's s2 form, the yardstick chip_smoke.py
//     keeps; the direct form below does 13, 0.194 s);
//   - SFU: one reciprocal a pair, 16 a clock per SM, 0.239 s;
//   - issue: each pair costs a warp scheduler 9 instruction slots (below),
//     4 schedulers an SM each issuing one warp instruction a clock:
//     9 n^2 / (32 x 4 x 132 x 1.98e9) = 0.27 s.
// The issue floor is the one that binds.  By the pipes' rates (not read on
// the card), the SFU takes 8 clocks for each warp-wide reciprocal, so it
// would be busy 8 of every 9 issue clocks: the two run nearly full
// together.  The design below aims at the issue floor; on an H100 SXM at
// 700 W it reaches 86-87 % of the floor of the loop as built (0.324-0.327 s
// a call at 1M points; PERF.md).
//
// The inner loop, per column and row (9 slots):
//   dx = xi - cx; dy = yi - cy            2 FADD
//   q = fma(dx, dx, 1); q = fma(dy, dy, q) 2 FFMA (the "1 +" folded in)
//   w = rcp.approx.ftz(q)                  1 MUFU.RCP (q >= 1: none flushed)
//   w2 = w * w                             1 FMUL
//   z += w; fx = fma(w2, dx, fx); fy = ...  1 FADD, 2 FFMA
// plus one shared-memory load for two columns, shared by the thread's rows,
// and the loop's own counter and branch.  As built (cuobjdump -sass of the
// library; scripts/repulsion_readout.py prints it), the unmasked loop is
// 151 instructions for 16 pairs, 9.44 a pair (issue floor 0.282 s at 1M).
// The direct differences replace the TPU kernel's s2 y - (sum w^2 y_j)
// form: one accumulator fewer and no cancellation of two large sums.
//
// Layout.  A block of 128 threads owns a tile of 512 rows, 4 a thread (4
// independent reciprocals in flight, one column load for 4 pairs), and one
// range of columns: 96 registers, 5 blocks an SM.  8 rows a thread (twice
// the work in flight, half the loads) needs 167 registers to keep its
// accumulators without spilling, so 3 blocks an SM; it measured 4 % slower
// at 65536 and 1M points and no faster below (PERF.md), and was dropped.
//
// The columns are split too, so that there are (tile, split) units for
// several blocks an SM at every size the paths use, not only at 1M, and so
// that the last wave is a small part of the call; the plan is computed in
// Python (ops/tsne_kernels.py: repulsion_plan) and each block is one unit.
// Columns are staged through shared memory in tiles of 2048 points; every
// thread reads the same column at once, a broadcast.  Columns past n_valid
// are staged as a far point whose weight is exactly 0, so the loop has no
// ragged end.  Only the chunks that hold one of the tile's own rows (the
// diagonal) take the masked loop.
//
// With one split the unit writes rep and z itself.  With more, each unit
// writes its partial (fx, fy, z) to scratch [scenes, splits, rows, 3] and a
// second kernel sums the splits of each row in a fixed order, in float64.
// No atomics: two calls give the same bits.
//
// Accuracy.  A single running float32 sum over 1e6 terms drifts by about
// sqrt(N) eps.  Each row instead sums 128 columns at a time into chunk-local
// partials, and folds each partial into its running sum with Kahan
// compensation.
//
// What does not apply here:
//   - Tensor cores (wgmma): the only product is the rank-2 y_i . y_j of the
//     expansion |y_i|^2 + |y_j|^2 - 2 y_i . y_j, which cancels for near
//     pairs: at 1M, |y| reaches 35, |y|^2 ~ 1250, while a neighbour's d^2 is
//     ~1e-2, so w would be off by more than the 1e-5 tolerance even in full
//     float32, let alone TF32.
//   - TMA or cp.async: y is 8 MB at 1M and stays in the 50 MB L2; a block
//     reads 16 KB of columns for every 2M pairs it computes.
//   - Two reciprocals per MUFU issue (h2rcp): f16 keeps about 3 decimal
//     digits, far outside the 1e-5 tolerance against the float64 twin.
//
// Scenes and a row window.  One launch serves S independent layouts of one
// n_valid (the multi-scene t-SNE: y [S, npad, 2], blockIdx.y the scene), and
// may be asked for the rows [row_lo, row_hi) only (a row shard of the
// sharded t-SNE step; every column is still read).  The window runs only
// the row tiles that cover it, with the tiles, splits and masked chunks of
// the full call, so each row's sums are bit-equal to those of a one-scene,
// full-window call; the outputs hold the window's rows only.  These calls
// take scene_units and scene_reduce_splits; the one-scene, all-rows call
// keeps repulsion_units and reduce_splits as they were.
//
// Requirements, checked by the Python wrapper and again here: y is
// [scenes, npad, 2] float32, contiguous and 8-byte aligned; 0 <= n_valid <=
// npad; 0 <= row_lo <= row_hi <= npad; split_cols a positive multiple of 128
// with (splits - 1) split_cols < n_valid <= splits split_cols; scratch
// [scenes, splits, row_hi - row_lo, 3] float32 when splits > 1; rep
// [scenes, row_hi - row_lo, 2] and zrow [scenes, row_hi - row_lo].  The tile
// is 512 rows (ops/tsne_kernels.py: REPULSION_TILE).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;           // rows a thread
constexpr int kTileRows = kThreads * kRows;
constexpr int kChunk = 128;        // columns per partial sum; splits align
constexpr int kTileCols = 2048;    // columns staged per pass (16 KB)
constexpr float kFar = 1e30f;      // a staged column past n_valid: w == 0

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// One chunk of kChunk staged columns against the thread's kRows rows.
// kMasked: the chunk holds one of the tile's rows, whose own column is left
// out.
template <bool kMasked>
__device__ __forceinline__ void chunk_sums(const float2* __restrict__ cols,
                                           int col0, int row0,
                                           const float (&xi)[kRows],
                                           const float (&yi)[kRows],
                                           float (&z)[kRows],
                                           float (&fx)[kRows],
                                           float (&fy)[kRows]) {
#pragma unroll 4
  for (int j = 0; j < kChunk; ++j) {
    const float2 c = cols[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dx = xi[r] - c.x;
      const float dy = yi[r] - c.y;
      float w = rcp_approx(fmaf(dy, dy, fmaf(dx, dx, 1.0f)));
      if (kMasked) w = (col0 + j == row0 + r * kThreads) ? 0.0f : w;
      const float w2 = w * w;
      z[r] += w;
      fx[r] = fmaf(w2, dx, fx[r]);
      fy[r] = fmaf(w2, dy, fy[r]);
    }
  }
}

// One block = one unit (row tile, column split): blockIdx.x = tile * splits
// + split.  partial == nullptr: write rep and zrow directly (one split).
__global__ void __launch_bounds__(kThreads, 4)
repulsion_units(const float2* __restrict__ y, int npad, int n_valid,
                int split_cols, int splits, float* __restrict__ partial,
                float2* __restrict__ rep, float* __restrict__ zrow) {
  __shared__ __align__(16) float2 cols[kTileCols];

  const int tile = blockIdx.x / splits;
  const int split = blockIdx.x - tile * splits;
  const int tile_lo = tile * kTileRows;
  const int row0 = tile_lo + threadIdx.x;     // row r is row0 + r kThreads
  const int c_lo = split * split_cols;
  const int c_hi = min(c_lo + split_cols, n_valid);

  float xi[kRows], yi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
    const float2 v = row < n_valid ? y[row] : make_float2(0.f, 0.f);
    xi[r] = v.x;
    yi[r] = v.y;
  }

  float zs[kRows], zc[kRows], xs[kRows], xc[kRows], ys[kRows], yc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    zs[r] = zc[r] = xs[r] = xc[r] = ys[r] = yc[r] = 0.f;
  }

  // c_lo, c_hi and everything below that branches are uniform in the block
  for (int t0 = c_lo; t0 < c_hi; t0 += kTileCols) {
    const int count = min(kTileCols, c_hi - t0);
    const int staged = (count + kChunk - 1) / kChunk * kChunk;
    __syncthreads();                            // previous tile consumed
    for (int t = threadIdx.x; t < staged; t += kThreads) {
      cols[t] = t < count ? y[t0 + t] : make_float2(kFar, kFar);
    }
    __syncthreads();
    for (int j0 = 0; j0 < staged; j0 += kChunk) {
      const int col0 = t0 + j0;
      float z[kRows], fx[kRows], fy[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) z[r] = fx[r] = fy[r] = 0.f;
      if (col0 < tile_lo + kTileRows && tile_lo < col0 + kChunk) {
        chunk_sums<true>(cols + j0, col0, row0, xi, yi, z, fx, fy);
      } else {
        chunk_sums<false>(cols + j0, col0, row0, xi, yi, z, fx, fy);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        kahan_add(zs[r], zc[r], z[r]);
        kahan_add(xs[r], xc[r], fx[r]);
        kahan_add(ys[r], yc[r], fy[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
    if (row >= n_valid) continue;
    const float z = zs[r] - zc[r];
    const float fx = xs[r] - xc[r];
    const float fy = ys[r] - yc[r];
    if (partial != nullptr) {
      float* p = partial + (static_cast<size_t>(split) * npad + row) * 3;
      p[0] = fx;
      p[1] = fy;
      p[2] = z;
    } else {
      rep[row] = make_float2(fx, fy);
      zrow[row] = z;
    }
  }
}

// Sums each row's split partials in split order, in float64, rounding once.
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ partial, int npad, int n_valid,
              int splits, float2* __restrict__ rep,
              float* __restrict__ zrow) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_valid) return;
  double fx = 0.0, fy = 0.0, z = 0.0;
  for (int s = 0; s < splits; ++s) {
    const float* p = partial + (static_cast<size_t>(s) * npad + row) * 3;
    fx += p[0];
    fy += p[1];
    z += p[2];
  }
  rep[row] = make_float2(static_cast<float>(fx), static_cast<float>(fy));
  zrow[row] = static_cast<float>(z);
}

// The same units over S scenes and a row window (see the top): blockIdx.x =
// (tile - tile0) * splits + split, blockIdx.y = scene, rows written at
// row - row_lo.  The one-scene, all-rows call takes repulsion_units above:
// one kernel for both, with the window and scene arithmetic around the
// same pair loop, measured 2-5 % slower on that call on an H100
// (PERF.md).  The two run the same per-pair arithmetic in the same order.
__global__ void __launch_bounds__(kThreads, 4)
scene_units(const float2* __restrict__ y, int npad, int n_valid, int row_lo,
            int row_hi, int tile0, int split_cols, int splits,
            float* __restrict__ partial, float2* __restrict__ rep,
            float* __restrict__ zrow) {
  __shared__ __align__(16) float2 cols[kTileCols];

  const int tile = tile0 + blockIdx.x / splits;
  const int split = blockIdx.x - (blockIdx.x / splits) * splits;
  const int scene = blockIdx.y;
  const int wrows = row_hi - row_lo;
  y += static_cast<size_t>(scene) * npad;
  const int tile_lo = tile * kTileRows;
  const int row0 = tile_lo + threadIdx.x;     // row r is row0 + r kThreads
  const int c_lo = split * split_cols;
  const int c_hi = min(c_lo + split_cols, n_valid);

  float xi[kRows], yi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
    const float2 v = row < n_valid ? y[row] : make_float2(0.f, 0.f);
    xi[r] = v.x;
    yi[r] = v.y;
  }

  float zs[kRows], zc[kRows], xs[kRows], xc[kRows], ys[kRows], yc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    zs[r] = zc[r] = xs[r] = xc[r] = ys[r] = yc[r] = 0.f;
  }

  // c_lo, c_hi and everything below that branches are uniform in the block
  for (int t0 = c_lo; t0 < c_hi; t0 += kTileCols) {
    const int count = min(kTileCols, c_hi - t0);
    const int staged = (count + kChunk - 1) / kChunk * kChunk;
    __syncthreads();                            // previous tile consumed
    for (int t = threadIdx.x; t < staged; t += kThreads) {
      cols[t] = t < count ? y[t0 + t] : make_float2(kFar, kFar);
    }
    __syncthreads();
    for (int j0 = 0; j0 < staged; j0 += kChunk) {
      const int col0 = t0 + j0;
      float z[kRows], fx[kRows], fy[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) z[r] = fx[r] = fy[r] = 0.f;
      if (col0 < tile_lo + kTileRows && tile_lo < col0 + kChunk) {
        chunk_sums<true>(cols + j0, col0, row0, xi, yi, z, fx, fy);
      } else {
        chunk_sums<false>(cols + j0, col0, row0, xi, yi, z, fx, fy);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        kahan_add(zs[r], zc[r], z[r]);
        kahan_add(xs[r], xc[r], fx[r]);
        kahan_add(ys[r], yc[r], fy[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
    if (row >= n_valid || row < row_lo || row >= row_hi) continue;
    const float z = zs[r] - zc[r];
    const float fx = xs[r] - xc[r];
    const float fy = ys[r] - yc[r];
    const int wrow = row - row_lo;
    const size_t out = static_cast<size_t>(scene) * wrows + wrow;
    if (partial != nullptr) {
      float* p = partial +
                 ((static_cast<size_t>(scene) * splits + split) * wrows +
                  wrow) * 3;
      p[0] = fx;
      p[1] = fy;
      p[2] = z;
    } else {
      rep[out] = make_float2(fx, fy);
      zrow[out] = z;
    }
  }
}

// reduce_splits over rows row_lo .. min(row_hi, n_valid) of scene
// blockIdx.y.
__global__ void __launch_bounds__(256)
scene_reduce_splits(const float* __restrict__ partial, int n_valid,
                    int row_lo, int row_hi, int splits,
                    float2* __restrict__ rep, float* __restrict__ zrow) {
  const int row = row_lo + blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_valid || row >= row_hi) return;
  const int scene = blockIdx.y;
  const int wrows = row_hi - row_lo;
  double fx = 0.0, fy = 0.0, z = 0.0;
  for (int s = 0; s < splits; ++s) {
    const float* p = partial +
                     ((static_cast<size_t>(scene) * splits + s) * wrows +
                      (row - row_lo)) * 3;
    fx += p[0];
    fy += p[1];
    z += p[2];
  }
  const size_t out = static_cast<size_t>(scene) * wrows + (row - row_lo);
  rep[out] = make_float2(static_cast<float>(fx), static_cast<float>(fy));
  zrow[out] = static_cast<float>(z);
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int tsne_repulsion_launch(const void* y, int scenes, int npad,
                                     int n_valid, int row_lo, int row_hi,
                                     int split_cols, int splits,
                                     void* scratch, void* rep, void* zrow,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool plan_ok =
      n_valid == 0 ||
      (split_cols > 0 && split_cols % kChunk == 0 && splits >= 1 &&
       static_cast<long long>(split_cols) * splits >= n_valid &&
       static_cast<long long>(split_cols) * (splits - 1) < n_valid &&
       (splits == 1 || scratch != nullptr));
  if (scenes < 1 || scenes > 65535 || n_valid < 0 || n_valid > npad ||
      row_lo < 0 || row_lo > row_hi || row_hi > npad || !plan_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wrows = row_hi - row_lo;
  if (wrows == 0) return static_cast<int>(cudaGetLastError());
  float2* rep2 = static_cast<float2*>(rep);
  float* z = static_cast<float*>(zrow);
  // window rows at or past n_valid are pad rows: exactly 0
  const int live_hi = min(row_hi, n_valid);
  const int pad_lo = max(row_lo, n_valid) - row_lo;   // first pad slot
  if (pad_lo < wrows) {
    for (int sc = 0; sc < scenes; ++sc) {
      const size_t base = static_cast<size_t>(sc) * wrows + pad_lo;
      cudaError_t err = cudaMemsetAsync(rep2 + base, 0,
                                        sizeof(float2) * (wrows - pad_lo), s);
      if (err == cudaSuccess) {
        err = cudaMemsetAsync(z + base, 0, sizeof(float) * (wrows - pad_lo),
                              s);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (live_hi <= row_lo) return static_cast<int>(cudaGetLastError());
  float* partial = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  const int tile0 = row_lo / kTileRows;
  const int tile1 = (live_hi + kTileRows - 1) / kTileRows;
  if (scenes == 1 && row_lo == 0 && row_hi == npad) {
    const int tiles = (n_valid + kTileRows - 1) / kTileRows;
    repulsion_units<<<tiles * splits, kThreads, 0, s>>>(
        static_cast<const float2*>(y), npad, n_valid, split_cols, splits,
        partial, rep2, z);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    reduce_splits<<<(n_valid + 255) / 256, 256, 0, s>>>(
        partial, npad, n_valid, splits, rep2, z);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((tile1 - tile0) * splits, scenes);
  scene_units<<<grid, kThreads, 0, s>>>(
      static_cast<const float2*>(y), npad, n_valid, row_lo, row_hi, tile0,
      split_cols, splits, partial, rep2, z);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const dim3 rgrid((live_hi - row_lo + 255) / 256, scenes);
  scene_reduce_splits<<<rgrid, 256, 0, s>>>(partial, n_valid, row_lo, row_hi,
                                            splits, rep2, z);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the unit kernel resident on one SM (the occupancy calculator),
// or minus a CUDA error code.
extern "C" int tsne_repulsion_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, repulsion_units, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
