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
// multiplication by float32(1/6) that it spells out.  No float is summed
// with an atomic.
//
// Input: y [n, 2] float32, the valid rows; lo [2], h [2] float32, the box
// (each point inside it, as grid_box makes it: a base cell off the grid is
// clamped onto it).  Workspace (ops/tsne_grid.py GridWorkspace, caller-owned
// and reused from call to call): keys [n] int32; pairs [n] int4 (key,
// index, x, y in the first pass's order); order [n] int32, the points'
// stable order by base cell (an output, held against torch.sort's by the
// tests), and ys [n] float2, the points in that order; counts [G^2] (0 between
// calls), start [G^2 + 1] int32; dense_row [G^2] int32 (a dense cell's
// first row, read only at dense cells); small [6 + 1024] int32 (the rows'
// and the large cells' counters, two tile tickets, the low digits'
// histogram, 0 between calls); status [ceil(G^2 / 2048) + ceil(n / 2048) * (2^low +
// 2^high)] uint32 (low + high = ceil(log2 G^2) bits); large [n / 513]
// int2 (a large cell's first row and pieces); rows [R] int2 (a piece's
// points [b, e) in the order), R = n / 64 + min(G^2, n / (dense + 1));
// table [R, 48] float32.
// Output: charges [3, G, G] float32.
//
// Design.  Six launches on the caller's stream, no host synchronisation,
// no library sort, no workspace cleared by the host:
//   1. bin_points, a tile of 2048 points a block: each point's base cell
//      (key u0 * G + v0, at most 20 bits since G <= 1024) from its own
//      coordinates, the cells' counts (integer atomics, one a warp for
//      each distinct key via __match_any_sync) and the histogram of the
//      keys' low digits (shared atomics, then one global atomic a digit a
//      block); it also clears the look-back words of launches 2 and 3;
//   2. order_pass<1>: blocks take tile tickets in launch order.  The first
//      ceil(G^2 / 2048) tiles scan the cells' counts into start (a
//      decoupled look-back over the tiles) and list the dense cells (more
//      than `dense` points) with their rows, a row a piece of 64 points,
//      and the large ones (more than 8 pieces); the others are the first
//      pass of a stable LSD radix sort of the keys (the low digit): each
//      warp ranks its 256 points round by round (the peers of a digit from
//      a ballot a bit, and a histogram a warp in shared memory, so equal
//      digits keep the index order), the warps' counts are scanned a digit
//      at a time and each tile's offset among the tiles comes from a
//      decoupled look-back (Onesweep, Adinets and Merrill 2022) that reads
//      16 tiles' words at once; the tile writes (key, index, point);
//   3. order_pass<2>: the second pass (the high digit), the buckets'
//      starts read from start; it writes the order and the points in it
//      (ys), all read in the first pass's order, none gathered;
//   4. piece_sums, a half-warp a row of the table (a piece of a dense
//      cell): the 16 lanes of a half are the 16 taps (du, dv), each with
//      its 3 charges; the lanes stage the weights of 16 points at once in
//      shared memory and then each adds its taps point after point, the
//      warp's two halves in step;
//   5. fold_cells, a block a large cell: its pieces' rows staged in shared
//      memory 128 at a time, 48 threads adding them in order into its first
//      row;
//   6. node_sums, a block a tile of 8 x 32 nodes: the 48 tap sums of the
//      11 x 35 cells that cover it staged in shared memory, a thread a cell
//      (a sparse cell's points summed, a dense cell's rows added, a large
//      cell's folded row read), then each node sums its 16 cells from there
//      in (du, dv) order.
// The order equals torch.sort(keys, stable=True)'s index for index.  The
// threshold `dense` (0 .. 64) moves cells between steps 4-5 and step 6 and
// never the bits.
//
// What bounds it: bytes.  The function reads y (8 bytes a point) and writes
// the charges (12 G^2 bytes): 8.8 MB at 10^6 points on the 256 grid, about
// 2.6 us at 3.35 TB/s; its operations (about 166 flops a point) take about
// 2.5 us at the float32 rate.  The kernel moves more: the keys and the
// sort's two passes (about 48 bytes a point), the sorted copy, the cell
// bounds, the dense cells' rows and the staged halos; the order passes'
// look-back is a chain of dependent loads through L2, and a piece's 64
// points are a chain of dependent adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // points (or cells) a thread a tile
constexpr int kTile = kThreads * kItems;   // 2048 points (or cells) a tile
constexpr int kMaxBins = 1024;             // 10-bit digits
constexpr int kPiece = 64;                 // ops/tsne_grid.py _PIECE
constexpr int kTaps = 48;                  // (charge, du, dv), the twin's layout
constexpr int kRows = 8, kCols = 32;       // a node tile
constexpr int kHaloCols = kCols + 3;
constexpr int kHalo = (kRows + 3) * kHaloCols;   // 385 cells cover a tile
constexpr int kNodeBytes = kTaps * kHalo * static_cast<int>(sizeof(float));
// a dense cell of at most kInlineFold pieces is folded by each node tile
// that stages it; a larger one once, by fold_cells, kFoldChunk pieces at a
// time staged in shared memory
constexpr int kInlineFold = 8;
constexpr int kFoldChunk = 128;
constexpr float kMargin = 3.0f;            // ops/tsne_grid.py _MARGIN
// small[]: the rows' and the large cells' counters, the order passes' tile
// tickets, then the histogram of the keys' low digits
constexpr int kRowCount = 0, kLarge = 1, kTicket1 = 2, kTicket2 = 3;
constexpr int kLowHist = 6;
// a look-back status word: a flag (the tile's own count, or the inclusive
// prefix through the tile) and a 30-bit value; 0 until published
constexpr unsigned kAggregate = 1u << 30, kPrefix = 2u << 30;
constexpr unsigned kValue = (1u << 30) - 1;
constexpr int kWindow = 16;                // look-back words read at once
constexpr unsigned kSpinLimit = 1u << 24;
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

// the first tap node floor(t) - 1 (the twin's base_cells), on the grid
__device__ __forceinline__ int first_node(float t, int grid) {
  const int f = static_cast<int>(__fsub_rn(floorf(t), 1.0f));
  return min(max(f, 0), grid - 1);
}

// s[q * 16 + du * 4 + dv] += wy[du] * (q * wx[dv]) for one point, as the
// twin rounds it (q = (1, y_x, y_y); 1 * wx is wx)
__device__ __forceinline__ void add_point(float2 p, float lo0, float lo1,
                                          float h0, float h1,
                                          float (&s)[kTaps]) {
  float wx[4], wy[4];
  weights(coord(p.x, lo0, h0), wx);
  weights(coord(p.y, lo1, h1), wy);
#pragma unroll
  for (int dv = 0; dv < 4; ++dv) {
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

// the 48 tap sums of the points ys[b, e), from 0 in point order, the next
// point's load in flight while one is added
__device__ __forceinline__ void sum_points(const float2* __restrict__ ys,
                                           int b, int e, float lo0,
                                           float lo1, float h0, float h1,
                                           float (&s)[kTaps]) {
#pragma unroll
  for (int j = 0; j < kTaps; ++j) s[j] = 0.0f;
  if (b >= e) return;
  float2 p = ys[b];
  for (int i = b + 1; i <= e; ++i) {
    const float2 next = i < e ? ys[i] : p;
    add_point(p, lo0, lo1, h0, h1, s);
    p = next;
  }
}

__device__ __forceinline__ unsigned read_status(const unsigned* at) {
  return *reinterpret_cast<const volatile unsigned*>(at);
}

__device__ __forceinline__ void publish(unsigned* at, unsigned flag,
                                        unsigned value) {
  *reinterpret_cast<volatile unsigned*>(at) = flag | value;
}

// the sum of column `col` over tiles 0 .. tile - 1 of a status table with
// `stride` columns: walk back until a tile's inclusive prefix, reading a
// window of kWindow tiles' words at once (one load latency a window while
// the tiles before publish), waiting on a tile until it has published.
// The tile tickets make every tile waited on a running block, so a wait is
// short; one that is not (a fault) stops the kernel with an error instead
// of hanging the card
__device__ unsigned look_back(const unsigned* status, int tile, int stride,
                              int col) {
  unsigned sum = 0;
  for (int top = tile - 1; top >= 0; top -= kWindow) {
    unsigned w[kWindow];
#pragma unroll
    for (int e = 0; e < kWindow; ++e) {
      const int p = top - e;
      w[e] = p >= 0 ? read_status(status + static_cast<long long>(p) *
                                               stride + col)
                    : kPrefix;
    }
#pragma unroll
    for (int e = 0; e < kWindow; ++e) {
      const int p = top - e;
      if (p < 0) return sum;
      unsigned spins = 0;
      while (!(w[e] & (kAggregate | kPrefix))) {
        if (++spins == kSpinLimit) __trap();
        w[e] = read_status(status + static_cast<long long>(p) * stride + col);
      }
      sum += w[e] & kValue;
      if (w[e] & kPrefix) return sum;
    }
  }
  return sum;
}

// the lanes of the warp whose `bits`-bit digit d equals this lane's (d < 0:
// no digit; such lanes match each other), from a ballot a bit
__device__ __forceinline__ unsigned digit_peers(int d, int bits) {
  unsigned peers = __ballot_sync(0xffffffffu, d >= 0);
  if (d < 0) peers = ~peers;
  for (int b = 0; b < bits; ++b) {
    const unsigned set = __ballot_sync(0xffffffffu, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += x;
  }
  return v;
}

// the exclusive prefix of `v` over the block, the block's total in *total
__device__ int block_exclusive(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive(v, lane);
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = sh[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

struct OrderArgs {
  const float2* y;
  const int* keys;
  int4* pairs;                  // (key, index, x, y) in pass 1's order
  int* order;
  float2* ys;
  int* counts;
  int* start;
  int* dense_row;
  int* small;
  unsigned* status;             // the scan's tiles, then each pass's
  int2* large;                  // (first row, pieces) of the large cells
  int2* rows;                   // each piece's points [b, e) in the order
  int n, grid, low_bits, high_bits, dense, scan_tiles, pass_tiles;
};

struct Shared {
  int warp_hist[kWarps][kMaxBins];   // each warp's digit counts, then offsets
  int base[kMaxBins];                // each digit's first place in the output
  int misc[kWarps + 1];
};

// scan tile `tile` of the cells' counts: start, and the list of the cells
// of more than `dense` points with their rows (one a piece)
__device__ void scan_tile(const OrderArgs& a, int tile, Shared& sh) {
  const int cells = a.grid * a.grid;
  const int lane = threadIdx.x & 31;
  const int k0 = tile * kTile + threadIdx.x * kItems;
  int c[kItems], sum = 0, rows = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int k = k0 + e;
    c[e] = k < cells ? a.counts[k] : 0;
    if (k < cells) a.counts[k] = 0;          // 0 again for the next call
    sum += c[e];
    if (c[e] > a.dense) rows += (c[e] + kPiece - 1) / kPiece;
  }
  // the dense cells' rows: one atomic a warp (their places depend on
  // timing, the sums in them do not)
  const int rows_incl = warp_inclusive(rows, lane);
  int got = 0;
  if (lane == 31 && rows_incl)
    got = atomicAdd(&a.small[kRowCount], rows_incl);
  int row_at = __shfl_sync(0xffffffffu, got, 31) + rows_incl - rows;
  // the counts: the block's scan, then the tiles' look-back
  int total;
  int at = block_exclusive(sum, sh.misc, &total);
  if (threadIdx.x == 0) {
    unsigned before = 0;
    if (tile == 0) {
      publish(a.status, kPrefix, total);
    } else {
      publish(a.status + tile, kAggregate, total);
      before = look_back(a.status, tile, 1, 0);
      publish(a.status + tile, kPrefix, before + total);
    }
    sh.misc[kWarps] = static_cast<int>(before);
  }
  __syncthreads();
  at += sh.misc[kWarps];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int k = k0 + e;
    if (k >= cells) break;
    a.start[k] = at;
    if (c[e] > a.dense) {
      const int pieces = (c[e] + kPiece - 1) / kPiece;
      a.dense_row[k] = row_at;
      if (pieces > kInlineFold)                // rare: one atomic a cell
        a.large[atomicAdd(&a.small[kLarge], 1)] = make_int2(row_at, pieces);
      for (int p = 0; p < pieces; ++p)
        a.rows[row_at + p] = make_int2(at + p * kPiece,
                                       min(at + (p + 1) * kPiece, at + c[e]));
      row_at += pieces;
    }
    at += c[e];
  }
}

// one tile of a stable LSD pass over the keys: pass 1 by the low digit
// from the keys in index order, pass 2 by the high digit from pass 1's
// (key, index) pairs
template <int kPass>
__device__ void radix_tile(const OrderArgs& a, int tile, Shared& sh) {
  const int bits = kPass == 1 ? a.low_bits : a.high_bits;
  const int bins = 1 << bits;
  const int shift = kPass == 1 ? 0 : a.low_bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* status = a.status + a.scan_tiles +
                     (kPass == 1 ? 0
                                 : static_cast<long long>(a.pass_tiles)
                                       << a.low_bits);
  int* hist = sh.warp_hist[warp];
  for (int d = lane; d < bins; d += 32) hist[d] = 0;
  // each digit's first place in the output, over all tiles
  if (kPass == 1) {
    int v[kMaxBins / kThreads], sum = 0;
#pragma unroll
    for (int e = 0; e < kMaxBins / kThreads; ++e) {
      const int d = threadIdx.x * (kMaxBins / kThreads) + e;
      v[e] = d < bins ? a.small[kLowHist + d] : 0;
      sum += v[e];
    }
    int total;
    int at = block_exclusive(sum, sh.misc, &total);
#pragma unroll
    for (int e = 0; e < kMaxBins / kThreads; ++e) {
      const int d = threadIdx.x * (kMaxBins / kThreads) + e;
      if (d < bins) sh.base[d] = at;
      at += v[e];
    }
  } else {
    const int cells = a.grid * a.grid;
    for (int d = threadIdx.x; d < bins; d += kThreads)
      sh.base[d] = a.start[min(d << shift, cells)];
  }
  __syncwarp();
  // rank the warp's 256 points round by round, in index order
  const long long first = static_cast<long long>(tile) * kTile +
                          warp * (kTile / kWarps) + lane;
  int key[kItems], idx[kItems], rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long j = first + r * 32;
    key[r] = -1;
    idx[r] = static_cast<int>(j);
    if (j < a.n) {
      if (kPass == 1) {
        key[r] = a.keys[j];
      } else {
        const int4 e = a.pairs[j];
        key[r] = e.x;
        idx[r] = e.y;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int d = key[r] >= 0 ? (key[r] >> shift) & (bins - 1) : -1;
    const unsigned peers = digit_peers(d, bits);
    const int below = __popc(peers & ((1u << lane) - 1u));
    const int had = d >= 0 ? hist[d] : 0;
    __syncwarp();
    if (d >= 0 && below == 0) hist[d] = had + __popc(peers);
    __syncwarp();
    rank[r] = had + below;
  }
  __syncthreads();
  // each digit: the warps' offsets in the tile, the tile's count published
  int count[kMaxBins / kThreads];
#pragma unroll
  for (int e = 0; e < kMaxBins / kThreads; ++e) {
    const int d = threadIdx.x + e * kThreads;
    count[e] = 0;
    if (d >= bins) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = sh.warp_hist[w][d];
      sh.warp_hist[w][d] = s;
      s += v;
    }
    count[e] = s;
    publish(status + static_cast<long long>(tile) * bins + d,
            tile == 0 ? kPrefix : kAggregate, s);
  }
  // ... and the tiles before it
  if (tile > 0) {
#pragma unroll 1
    for (int e = 0; e < kMaxBins / kThreads; ++e) {
      const int d = threadIdx.x + e * kThreads;
      if (d >= bins) continue;
      const unsigned before = look_back(status, tile, bins, d);
      publish(status + static_cast<long long>(tile) * bins + d, kPrefix,
              before + count[e]);
      sh.base[d] += static_cast<int>(before);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (key[r] < 0) continue;
    const int d = (key[r] >> shift) & (bins - 1);
    const int pos = sh.base[d] + sh.warp_hist[warp][d] + rank[r];
    // the point rides along: read in index order here, in pass 1's order in
    // pass 2, never gathered
    const long long j = first + r * 32;
    if (kPass == 1) {
      const float2 p = a.y[j];
      a.pairs[pos] = make_int4(key[r], idx[r], __float_as_int(p.x),
                               __float_as_int(p.y));
    } else {
      const int4 e = a.pairs[j];
      a.order[pos] = idx[r];
      a.ys[pos] = make_float2(__int_as_float(e.z), __int_as_float(e.w));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bin_points(const float2* __restrict__ y, const float* __restrict__ lo,
           const float* __restrict__ h, int n, int grid, int low_bits,
           int* __restrict__ keys, int* __restrict__ counts,
           int* __restrict__ start, int* __restrict__ small,
           unsigned* __restrict__ status, long long status_words) {
  __shared__ int hist[kMaxBins];
  const int bins = 1 << low_bits;
  for (int d = threadIdx.x; d < bins; d += kThreads) hist[d] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    small[kRowCount] = 0;
    small[kTicket1] = 0;
    small[kTicket2] = 0;
    small[kLarge] = 0;
    start[grid * grid] = n;
  }
  // the order passes' look-back words, 0 (unpublished) again
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       w < status_words; w += static_cast<long long>(gridDim.x) * kThreads)
    status[w] = 0;
  __syncthreads();
  const float lo0 = lo[0], lo1 = lo[1], h0 = h[0], h1 = h[1];
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int r = 0; r < kItems; ++r) {
    const long long i = static_cast<long long>(blockIdx.x) * kTile +
                        r * kThreads + threadIdx.x;
    int key = -1;
    if (i < n) {
      const float2 p = y[i];
      const int v0 = first_node(coord(p.x, lo0, h0), grid);
      const int u0 = first_node(coord(p.y, lo1, h1), grid);
      key = u0 * grid + v0;
      keys[i] = key;
      atomicAdd(&hist[key & (bins - 1)], 1);
    }
    // one atomic a warp for each distinct key (a crowded cell's points
    // would otherwise queue on one address)
    const unsigned same_key = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(same_key) - 1)
      atomicAdd(&counts[key], __popc(same_key));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < bins; e += kThreads)
    if (hist[e]) atomicAdd(&small[kLowHist + e], hist[e]);
}

template <int kPass>
// three blocks an SM (at most 85 registers a thread; the look-back window
// holds 16)
__global__ void __launch_bounds__(kThreads, 3)
order_pass(OrderArgs a) {
  __shared__ Shared sh;
  if (threadIdx.x == 0)
    sh.misc[0] = atomicAdd(&a.small[kPass == 1 ? kTicket1 : kTicket2], 1);
  __syncthreads();
  const int ticket = sh.misc[0];
  __syncthreads();
  if (kPass == 2 && ticket == 0)             // pass 1 has read it: 0 again
    for (int d = threadIdx.x; d < (1 << a.low_bits); d += kThreads)
      a.small[kLowHist + d] = 0;
  if (kPass == 1 && ticket < a.scan_tiles)
    scan_tile(a, ticket, sh);
  else
    radix_tile<kPass>(a, kPass == 1 ? ticket - a.scan_tiles : ticket, sh);
}

// each row of the table: one piece of a dense cell, a half-warp a row.  The
// 16 lanes of a half are the taps (du, dv) = (lane / 4, lane % 4), each with
// its three charges; the lanes stage the weights of 16 points at once in
// shared memory (wx, y_x wx, y_y wx, wy), then each adds its taps point by
// point.  The warp's two halves step together (the longer piece's rounds,
// the other's lanes idle), so the warp never diverges
constexpr int kRec = 16;                   // floats a point's staged weights
__global__ void __launch_bounds__(kThreads)
piece_sums(const float2* __restrict__ ys, const float* __restrict__ lo,
           const float* __restrict__ h, const int* __restrict__ small,
           const int2* __restrict__ rows, float* __restrict__ table) {
  __shared__ float rec[kThreads / 16][16 * kRec];
  const int count = small[kRowCount];
  const float lo0 = lo[0], lo1 = lo[1], h0 = h[0], h1 = h[1];
  const int half = threadIdx.x >> 4, hl = threadIdx.x & 15;
  const int du = hl >> 2, dv = hl & 3;
  float* mine = rec[half];
  const int halves = gridDim.x * (kThreads / 16);
  // rows 2w and 2w + 1 to warp w's halves, whole warps striding
  for (int r0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * 2;
       r0 < count; r0 += halves) {
    const int r = r0 + (half & 1);
    int b = 0, e = 0;
    if (r < count) {
      const int2 row = rows[r];
      b = row.x;
      e = row.y;
    }
    const int len = e - b;
    const int most = max(len, __shfl_xor_sync(0xffffffffu, len, 16));
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    float2 pts[kPiece / 16];                 // the piece's points, all in flight
#pragma unroll
    for (int j = 0; j < kPiece / 16; ++j)
      if (16 * j + hl < len) pts[j] = ys[b + 16 * j + hl];
#pragma unroll
    for (int round = 0; round < kPiece / 16; ++round) {
      const int i0 = 16 * round;
      if (i0 >= most) break;
      if (i0 + hl < len) {
        const float2 p = pts[round];
        float wx[4], wy[4];
        weights(coord(p.x, lo0, h0), wx);
        weights(coord(p.y, lo1, h1), wy);
        float* at = mine + hl * kRec;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          at[j] = wx[j];
          at[4 + j] = __fmul_rn(p.x, wx[j]);
          at[8 + j] = __fmul_rn(p.y, wx[j]);
          at[12 + j] = wy[j];
        }
      }
      __syncwarp();
      const int m = min(16, len - i0);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k < m) {
          const float* at = mine + k * kRec;
          const float w = at[12 + du];
          a0 = __fadd_rn(a0, __fmul_rn(w, at[dv]));
          a1 = __fadd_rn(a1, __fmul_rn(w, at[4 + dv]));
          a2 = __fadd_rn(a2, __fmul_rn(w, at[8 + dv]));
        }
      }
      __syncwarp();
    }
    if (r < count) {
      float* out = table + static_cast<long long>(r) * kTaps;
      out[hl] = a0;
      out[16 + hl] = a1;
      out[32 + hl] = a2;
    }
  }
}

// the pieces of each dense cell of more than kInlineFold pieces added in
// order from 0 into its first row (read before it is written)
__global__ void __launch_bounds__(kThreads)
fold_cells(const int* __restrict__ small, const int2* __restrict__ large,
           float* __restrict__ table) {
  __shared__ float4 chunk[kFoldChunk * kTaps / 4];
  if (static_cast<int>(blockIdx.x) >= small[kLarge]) return;
  const int2 cell = large[blockIdx.x];
  const long long first = cell.x;
  const int pieces = cell.y;
  const float4* rows4 = reinterpret_cast<const float4*>(table) +
                        first * (kTaps / 4);
  const float* staged = reinterpret_cast<const float*>(chunk);
  float acc = 0.0f;
  for (int p0 = 0; p0 < pieces; p0 += kFoldChunk) {
    const int m = min(kFoldChunk, pieces - p0);
    for (int e = threadIdx.x; e < m * (kTaps / 4); e += kThreads)
      chunk[e] = rows4[static_cast<long long>(p0) * (kTaps / 4) + e];
    __syncthreads();
    if (threadIdx.x < kTaps)
      for (int p = 0; p < m; ++p)
        acc = __fadd_rn(acc, staged[p * kTaps + threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.x < kTaps) table[first * kTaps + threadIdx.x] = acc;
}

// one cell's 48 tap sums into the stage: a sparse cell's points (one piece,
// since dense <= 64) from 0; a dense cell's piece rows added from 0 (or
// its first row, which fold_cells made the sum of a large cell's pieces).
// The cell's sum is the twin's 0 + its pieces; 0 + x is x but for the sign
// of a zero, which no node sum keeps (each starts from +0)
__device__ __forceinline__ void stage_cell(
    const float2* __restrict__ ys, const int* __restrict__ start,
    const int* __restrict__ dense_row, const float* __restrict__ table,
    float lo0, float lo1, float h0,
    float h1, int grid, int dense, int cu, int cv, float* slot) {
  float c[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) c[j] = 0.0f;
  if (cu >= 0 && cv >= 0 && cu < grid && cv < grid) {
    const int k = cu * grid + cv;
    const int b = start[k], e = start[k + 1];
    if (e - b > dense) {
      const int pieces = (e - b + kPiece - 1) / kPiece;
      const float4* row = reinterpret_cast<const float4*>(table) +
                          static_cast<long long>(dense_row[k]) * (kTaps / 4);
      for (int p = 0; p < (pieces > kInlineFold ? 1 : pieces); ++p) {
        float4 v[kTaps / 4];
#pragma unroll
        for (int j = 0; j < kTaps / 4; ++j) v[j] = row[p * (kTaps / 4) + j];
#pragma unroll
        for (int j = 0; j < kTaps / 4; ++j) {
          c[4 * j] = __fadd_rn(c[4 * j], v[j].x);
          c[4 * j + 1] = __fadd_rn(c[4 * j + 1], v[j].y);
          c[4 * j + 2] = __fadd_rn(c[4 * j + 2], v[j].z);
          c[4 * j + 3] = __fadd_rn(c[4 * j + 3], v[j].w);
        }
      }
    } else {
      sum_points(ys, b, e, lo0, lo1, h0, h1, c);
    }
  }
#pragma unroll
  for (int j = 0; j < kTaps; ++j) slot[j * kHalo] = c[j];
}

__global__ void __launch_bounds__(kThreads)
node_sums(const float2* __restrict__ ys, const int* __restrict__ start,
          const int* __restrict__ dense_row, const float* __restrict__ table, const float* __restrict__ lo,
          const float* __restrict__ h, int grid, int dense,
          float* __restrict__ charges) {
  extern __shared__ float stage[];           // [kTaps][kHalo]
  const int u_top = blockIdx.y * kRows, v_left = blockIdx.x * kCols;
  const float lo0 = lo[0], lo1 = lo[1], h0 = h[0], h1 = h[1];
  // the 48 tap sums of each cell that covers the tile, a thread a cell
  for (int s = threadIdx.x; s < kHalo; s += kThreads)
    stage_cell(ys, start, dense_row, table, lo0, lo1, h0, h1,
               grid, dense, u_top - 3 + s / kHaloCols,
               v_left - 3 + s % kHaloCols, stage + s);
  __syncthreads();
  const int ly = threadIdx.x / kCols, lx = threadIdx.x % kCols;
  const int u = u_top + ly, v = v_left + lx;
  if (u >= grid || v >= grid) return;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
#pragma unroll
  for (int du = 0; du < 4; ++du) {
#pragma unroll
    for (int dv = 0; dv < 4; ++dv) {
      if (u < du || v < dv) continue;        // the base cell lies off the grid
      const int s = (ly + 3 - du) * kHaloCols + (lx + 3 - dv);
      const int j = du * 4 + dv;
      n0 = __fadd_rn(n0, stage[j * kHalo + s]);
      n1 = __fadd_rn(n1, stage[(16 + j) * kHalo + s]);
      n2 = __fadd_rn(n2, stage[(32 + j) * kHalo + s]);
    }
  }
  const long long g2 = static_cast<long long>(grid) * grid;
  const long long node = static_cast<long long>(u) * grid + v;
  charges[node] = n0;
  charges[g2 + node] = n1;
  charges[2 * g2 + node] = n2;
}

}  // namespace

// n in [1, 2^30); 8 <= grid <= 1024; 0 <= dense <= 64 (a cell of more
// than `dense` points is summed in pieces through the table); blocks: the piece
// pass's blocks (a few an SM).  The workspace as the header says.
namespace {

// launches 1-3 (the order passes) on `st`; fills `a` for the later ones
int launch_order(const void* y, const void* lo, const void* h, int n,
                 int grid, int dense, int blocks, void* keys, void* pairs,
                 void* order, void* ys, void* counts, void* start,
                 void* dense_row, void* small, void* status, void* large,
                 void* rows, cudaStream_t st, OrderArgs& a) {
  if (n <= 0 || n >= (1 << 30) || grid < 8 || grid > 1024 || dense < 0 ||
      dense > kPiece || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = grid * grid;
  const int bits = 32 - __builtin_clz(static_cast<unsigned>(cells - 1));
  a.y = static_cast<const float2*>(y);
  a.keys = static_cast<const int*>(keys);
  a.pairs = static_cast<int4*>(pairs);
  a.order = static_cast<int*>(order);
  a.ys = static_cast<float2*>(ys);
  a.counts = static_cast<int*>(counts);
  a.start = static_cast<int*>(start);
  a.dense_row = static_cast<int*>(dense_row);
  a.small = static_cast<int*>(small);
  a.status = static_cast<unsigned*>(status);
  a.large = static_cast<int2*>(large);
  a.rows = static_cast<int2*>(rows);
  a.n = n;
  a.grid = grid;
  a.low_bits = bits / 2;
  a.high_bits = bits - bits / 2;
  a.dense = dense;
  a.scan_tiles = (cells + kTile - 1) / kTile;
  a.pass_tiles = (n + kTile - 1) / kTile;
  const long long status_words =
      a.scan_tiles + (static_cast<long long>(a.pass_tiles) << a.low_bits) +
      (static_cast<long long>(a.pass_tiles) << a.high_bits);
  cudaError_t err;
  bin_points<<<a.pass_tiles, kThreads, 0, st>>>(
      a.y, static_cast<const float*>(lo), static_cast<const float*>(h), n,
      grid, a.low_bits, static_cast<int*>(keys), a.counts, a.start, a.small,
      a.status, status_words);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  order_pass<1><<<a.scan_tiles + a.pass_tiles, kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  order_pass<2><<<a.pass_tiles, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The order passes alone (launches 1-3): the order, the points in it and
// the lists of the dense and large cells, the charges untouched; for
// timing them apart.  The workspace is left as a whole deposit leaves it.
extern "C" int grid_deposit_order_launch(
    const void* y, const void* lo, const void* h, int n, int grid, int dense,
    int blocks, void* keys, void* pairs, void* order, void* ys, void* counts,
    void* start, void* dense_row, void* small, void* status, void* large,
    void* rows, void* stream) {
  OrderArgs a;
  return launch_order(y, lo, h, n, grid, dense, blocks, keys, pairs, order,
                      ys, counts, start, dense_row, small, status, large,
                      rows, static_cast<cudaStream_t>(stream), a);
}

extern "C" int grid_deposit_launch(
    const void* y, const void* lo, const void* h, int n, int grid, int dense,
    int blocks, void* keys, void* pairs, void* order, void* ys, void* counts,
    void* start, void* dense_row, void* small, void* status, void* large,
    void* rows, void* table, void* charges, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  OrderArgs a;
  int code = launch_order(y, lo, h, n, grid, dense, blocks, keys, pairs,
                          order, ys, counts, start, dense_row, small, status,
                          large, rows, st, a);
  if (code != 0) return code;
  const int cells = grid * grid;
  const int max_dense = min(cells, n / (dense + 1));
  const float* lop = static_cast<const float*>(lo);
  const float* hp = static_cast<const float*>(h);
  const int max_large = n / (kInlineFold * kPiece + 1);
  float* table_f = static_cast<float*>(table);
  cudaError_t err;
  if (max_dense > 0) {
    piece_sums<<<blocks, kThreads, 0, st>>>(a.ys, lop, hp, a.small, a.rows,
                                            table_f);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (max_large > 0) {
    fold_cells<<<max_large, kThreads, 0, st>>>(a.small, a.large, table_f);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  static bool wide_stage[64] = {};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess)
    return static_cast<int>(err);
  if (device < 64 && !wide_stage[device]) {
    err = cudaFuncSetAttribute(node_sums,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kNodeBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide_stage[device] = true;
  }
  const dim3 tiles((grid + kCols - 1) / kCols, (grid + kRows - 1) / kRows);
  node_sums<<<tiles, kThreads, kNodeBytes, st>>>(
      a.ys, a.start, a.dense_row, table_f, lop, hp, grid, dense,
      static_cast<float*>(charges));
  return static_cast<int>(cudaGetLastError());
}
