// The charge deposit of the grid t-SNE tier, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the deposit of the JAX package's
// grid repulsion, sph_tpu/ops/tsne_grid.py::deposit_charges (:104), an XLA
// program that spreads the charges (1, y_x, y_y) of the points onto a
// G x G grid with cubic-Lagrange weights as dense [c, G] weight rows
// multiplied on the TPU's matrix unit (14 N G^2 flops an iteration with the
// interpolation).  Here each point has 4 x 4 nonzero taps, so the work is
// 48 multiply-adds a point, and the twin (ops/tsne_grid.py
// grid_deposit_reference) fixes the order of every sum:
//
//   the points are stably sorted by base cell (u0, v0) = (floor(t_y) - 1,
//   floor(t_x) - 1); the tap (du, dv) of a point lands on node
//   (u0 + du, v0 + dv) with weight wy[du] * (q * wx[dv]);
//   a base cell's tap sums run over its points in that order, in pieces of
//   64 points: each piece from 0 left to right, then the cell from 0 over
//   its pieces left to right;
//   a node sums the 16 base cells that cover it from 0, (du, dv) in
//   row-major order, skipping the cells that would lie off the grid.
//
// So two calls give the same bits, and this kernel gives the twin's bits:
// every operation is an IEEE round-to-nearest intrinsic (__fadd_rn,
// __fmul_rn, __fdiv_rn), which the compiler neither contracts into a fused
// multiply-add nor reorders, and the twin's division by 6 is the
// multiplication by float32(1/6) that it spells out.
//
// Input (ops/tsne_grid.py grid_deposit builds it with torch ops):
//   y [n, 2] float32, the valid rows; lo [2], h [2] float32, the box;
//   keys [n] int32, the base cells u0 * G + v0 sorted, and order [n] int64,
//   the points' stable order by base cell (torch.sort(stable=True));
//   workspace: ys [n, 2] float32; cell_start, cell_end, dense_row [G * G]
//   and a row counter, int32; the row list [rows, 2] int32 and the piece
//   table [rows, 48] float32, rows = 2 min(G^2, n / (dense + 1)) + n / 64
//   + 1 (at 10^6 points and dense 4: 9.3 MB on the 128 grid, 28 MB on the
//   256, 80 MB from the 1024 up).
// Output: charges [3, G, G] float32.
//
// Design.  t-SNE clusters put thousands of points in one cell (7760 in the
// fullest cell of the 1M layout's end on the 256 grid) while most cells of
// a fine grid hold none or one, so the kernel splits the cells by load.
// Six steps on the caller's stream:
//   1. the cell bounds and the row counter are zeroed;
//   2. one thread a sorted point copies its row into ys in sorted order and
//      marks where its base cell's run begins and ends;
//   3. one thread a cell: a cell of more than `dense` points (4 by
//      default) reserves a header row and one row a piece in the piece
//      table (one atomic a warp: the rows' places depend on timing, the
//      sums in them do not) and lists them;
//   4. threads striding over the listed rows sum each piece's 48 tap
//      charges over its points in order, the taps recomputed in registers
//      (no tap table), into its row: a crowded cell is spread over as many
//      threads as it has pieces;
//   5. threads striding over (header row, tap) fold each dense cell's
//      pieces in order into its header row;
//   6. one thread a grid node sums its 16 cells in order: a dense cell's
//      three taps from its header row, a sparse cell's (at most `dense`
//      points, one piece) over its points with the weights at this node.
// No [c, 48] or [G^2, 48] table is written: the piece table holds only the
// dense cells' rows.
//
// What bounds it: bytes.  The function reads y (8 bytes a point) and writes
// the charges (12 G^2 bytes): 8.8 MB at 10^6 points on the 256 grid, about
// 2.6 us at 3.35 TB/s; its operations (about 150 flops a point) take about
// 2.2 us at the float32 rate.  The kernel moves more: the sorted copy, the
// cell bounds, the dense cells' rows, and a sparse cell's points read by
// each of its 16 nodes (from L1 and L2, a cell's points being contiguous
// in ys).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 64;            // ops/tsne_grid.py _PIECE
constexpr int kTaps = 48;             // (charge, du, dv), the twin's layout
constexpr float kMargin = 3.0f;       // ops/tsne_grid.py _MARGIN
// float32(1 / 6), ops/tsne_grid.py _SIXTH
__device__ __forceinline__ float sixth() { return __int_as_float(0x3E2AAAAB); }

// (y - lo) / h + 3, rounded step by step as the twin's torch ops round
__device__ __forceinline__ float coord(float y, float lo, float h) {
  return __fadd_rn(__fdiv_rn(__fsub_rn(y, lo), h), kMargin);
}

// the twin's _cardinal: the 4-point Lagrange weight at distance s >= 0
__device__ __forceinline__ float cardinal(float s) {
  if (s < 1.0f)
    return __fmul_rn(__fmul_rn(__fmul_rn(__fadd_rn(s, 1.0f),
                                         __fsub_rn(s, 1.0f)),
                               __fsub_rn(s, 2.0f)),
                     0.5f);
  if (s < 2.0f)
    return __fmul_rn(__fmul_rn(__fmul_rn(-__fsub_rn(s, 1.0f),
                                         __fsub_rn(s, 2.0f)),
                               __fsub_rn(s, 3.0f)),
                     sixth());
  return 0.0f;
}

// the weights of nodes floor(t) - 1 .. floor(t) + 2 (the twin's _taps)
__device__ __forceinline__ void weights(float t, float (&w)[4]) {
  const float first = __fsub_rn(floorf(t), 1.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = cardinal(fabsf(__fsub_rn(t, __fadd_rn(first,
                                                 static_cast<float>(j)))));
}

__global__ void __launch_bounds__(kThreads)
mark_cells(const float2* __restrict__ y, const int* __restrict__ keys,
           const long long* __restrict__ order, int n, int cells,
           float2* __restrict__ ys, int* __restrict__ cell_start,
           int* __restrict__ cell_end) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  ys[i] = y[order[i]];
  const int k = keys[i];
  if (k < 0 || k >= cells) return;      // off the grid: no cell holds it
  if (i == 0 || keys[i - 1] != k) cell_start[k] = i;
  if (i == n - 1 || keys[i + 1] != k) cell_end[k] = i + 1;
}

__global__ void __launch_bounds__(kThreads)
reserve_rows(const int* __restrict__ start, const int* __restrict__ end,
             int cells, int dense, int* __restrict__ counter,
             int* __restrict__ dense_row, int2* __restrict__ rows) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool active = c < cells;
  const int len = active ? end[c] - start[c] : 0;
  const int need = (active && len > dense) ? 1 + (len + kPiece - 1) / kPiece
                                           : 0;
  int incl = need;                      // the warp's inclusive prefix
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int base = 0;
  if (lane == 0 && total) base = atomicAdd(counter, total);
  base = __shfl_sync(0xffffffffu, base, 0);
  if (!active) return;
  const int at = base + incl - need;
  dense_row[c] = need ? at : -1;
  if (!need) return;
  rows[at] = make_int2(c, -1);          // the header row
  for (int p = 0; p + 1 < need; ++p) rows[at + 1 + p] = make_int2(c, p);
}

__global__ void __launch_bounds__(kThreads)
piece_sums(const float2* __restrict__ ys, const int* __restrict__ start,
           const int* __restrict__ end, const float* __restrict__ lo,
           const float* __restrict__ h, const int* __restrict__ counter,
           const int2* __restrict__ rows, float* __restrict__ table) {
  const int count = *counter;
  const float lo0 = lo[0], lo1 = lo[1], h0 = h[0], h1 = h[1];
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < count;
       r += gridDim.x * kThreads) {
    const int2 e = rows[r];
    if (e.y < 0) continue;              // a header row
    const int b = start[e.x] + e.y * kPiece;
    const int stop = min(b + kPiece, end[e.x]);
    float s[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) s[j] = 0.0f;
    for (int i = b; i < stop; ++i) {
      const float2 p = ys[i];
      float wx[4], wy[4];
      weights(coord(p.x, lo0, h0), wx);
      weights(coord(p.y, lo1, h1), wy);
#pragma unroll
      for (int dv = 0; dv < 4; ++dv) {
        // the twin's wy * (q * wx), q = (1, y_x, y_y); 1 * wx is wx
        const float qx[3] = {wx[dv], __fmul_rn(p.x, wx[dv]),
                             __fmul_rn(p.y, wx[dv])};
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int du = 0; du < 4; ++du) {
            float& acc = s[q * 16 + du * 4 + dv];
            acc = __fadd_rn(acc, __fmul_rn(wy[du], qx[q]));
          }
      }
    }
    float4* out = reinterpret_cast<float4*>(table + static_cast<long long>(r)
                                            * kTaps);
#pragma unroll
    for (int j = 0; j < kTaps / 4; ++j)
      out[j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
cell_sums(const int* __restrict__ start, const int* __restrict__ end,
          const int* __restrict__ counter, const int2* __restrict__ rows,
          float* __restrict__ table) {
  const long long work = static_cast<long long>(*counter) * kTaps;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       w < work; w += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = w / kTaps;
    const int j = static_cast<int>(w % kTaps);
    const int2 e = rows[r];
    if (e.y >= 0) continue;             // a piece row
    const int pieces = (end[e.x] - start[e.x] + kPiece - 1) / kPiece;
    float acc = 0.0f;
    for (int p = 1; p <= pieces; ++p)
      acc = __fadd_rn(acc, table[(r + p) * kTaps + j]);
    table[r * kTaps + j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
node_sums(const float2* __restrict__ ys, const int* __restrict__ start,
          const int* __restrict__ end, const float* __restrict__ lo,
          const float* __restrict__ h, int grid,
          const int* __restrict__ dense_row, const float* __restrict__ table,
          float* __restrict__ charges) {
  const long long g2 = static_cast<long long>(grid) * grid;
  const long long node = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  if (node >= g2) return;
  const int u = static_cast<int>(node / grid);
  const int v = static_cast<int>(node % grid);
  const float nu = static_cast<float>(u), nv = static_cast<float>(v);
  const float lo0 = lo[0], lo1 = lo[1], h0 = h[0], h1 = h[1];
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
#pragma unroll
  for (int du = 0; du < 4; ++du) {
#pragma unroll
    for (int dv = 0; dv < 4; ++dv) {
      if (u < du || v < dv) continue;   // the base cell lies off the grid
      const int c = (u - du) * grid + (v - dv);
      const int row = dense_row[c];
      float c0, c1, c2;
      if (row >= 0) {
        const float* t = table + static_cast<long long>(row) * kTaps +
                         du * 4 + dv;
        c0 = t[0];
        c1 = t[16];
        c2 = t[32];
      } else {                          // one piece, then the cell from 0
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        const int stop = end[c];
        for (int i = start[c]; i < stop; ++i) {
          const float2 p = ys[i];
          const float wx =
              cardinal(fabsf(__fsub_rn(coord(p.x, lo0, h0), nv)));
          const float wy =
              cardinal(fabsf(__fsub_rn(coord(p.y, lo1, h1), nu)));
          s0 = __fadd_rn(s0, __fmul_rn(wy, wx));
          s1 = __fadd_rn(s1, __fmul_rn(wy, __fmul_rn(p.x, wx)));
          s2 = __fadd_rn(s2, __fmul_rn(wy, __fmul_rn(p.y, wx)));
        }
        c0 = __fadd_rn(0.0f, s0);
        c1 = __fadd_rn(0.0f, s1);
        c2 = __fadd_rn(0.0f, s2);
      }
      n0 = __fadd_rn(n0, c0);
      n1 = __fadd_rn(n1, c1);
      n2 = __fadd_rn(n2, c2);
    }
  }
  charges[node] = n0;
  charges[g2 + node] = n1;
  charges[2 * g2 + node] = n2;
}

}  // namespace

// dense: a cell of more than `dense` points is summed in pieces through the
// table (0 <= dense <= 64); ints: cell_start, cell_end, dense_row [G * G]
// and the row counter, in that order; blocks: the striding passes' blocks
// (a few an SM).  n >= 1; 8 <= grid <= 32768.
extern "C" int grid_deposit_launch(const void* y, const void* lo,
                                   const void* h, const void* keys,
                                   const void* order, int n, int grid,
                                   int dense, int blocks, void* ys,
                                   void* ints, void* rows, void* table,
                                   void* charges, void* stream) {
  if (n <= 0 || grid < 8 || grid > 32768 || dense < 0 || dense > kPiece ||
      blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(grid) * grid;
  int* start = static_cast<int*>(ints);
  int* end = start + cells;
  int* dense_row = end + cells;
  int* counter = dense_row + cells;
  cudaError_t err = cudaMemsetAsync(start, 0, 2 * cells * sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float2* ysp = static_cast<const float2*>(ys);
  const float* lop = static_cast<const float*>(lo);
  const float* hp = static_cast<const float*>(h);
  int2* rowp = static_cast<int2*>(rows);
  float* tab = static_cast<float*>(table);
  const unsigned cell_blocks =
      static_cast<unsigned>((cells + kThreads - 1) / kThreads);
  mark_cells<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float2*>(y), static_cast<const int*>(keys),
      static_cast<const long long*>(order), n, static_cast<int>(cells),
      static_cast<float2*>(ys), start, end);
  reserve_rows<<<cell_blocks, kThreads, 0, st>>>(
      start, end, static_cast<int>(cells), dense, counter, dense_row, rowp);
  piece_sums<<<blocks, kThreads, 0, st>>>(ysp, start, end, lop, hp, counter,
                                          rowp, tab);
  cell_sums<<<blocks, kThreads, 0, st>>>(start, end, counter, rowp, tab);
  node_sums<<<cell_blocks, kThreads, 0, st>>>(ysp, start, end, lop, hp, grid,
                                              dense_row, tab,
                                              static_cast<float*>(charges));
  return static_cast<int>(cudaGetLastError());
}
