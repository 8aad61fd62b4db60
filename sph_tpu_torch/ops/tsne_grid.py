"""Grid-interpolated t-SNE repulsion, the O(N + G^2 log G) large-N tier.

Port of sph_tpu/ops/tsne_grid.py (the FIt-SNE family, Linderman et al.
2019).  Both repulsion terms are convolutions of point charges with smooth
shift-invariant kernels,

    F_i = sum_j k2(y_i - y_j) (y_i - y_j),   k2(r) = 1/(1+|r|^2)^2
        = y_i * (k2 * 1)(y_i) - (k2 * y)(y_i)
    Z   = sum_{i != j} k1(y_i - y_j),        k1(r) = 1/(1+|r|^2)

so the charges (1, y_x, y_y) are spread onto a regular G x G grid with
cubic-Lagrange weights, convolved with the kernels sampled at the grid
offsets (FFT on the zero-padded [2G, 2G] grid) and the fields interpolated
back at the points with the same weights.  The only error is the cubic
interpolation error of the smooth kernels, O(h^4).

The JAX package writes the spreading and the interpolation as dense
[c, G] Lagrange-weight matmuls, 14 N G^2 flops an iteration, because
scatters serialize on a TPU.  Here each point has its 4 x 4 taps, and two
CUDA kernels do the point work on the card, the taps recomputed in
registers (no tap table):

- ``grid_deposit`` (``csrc/grid_deposit.cu``): the charges onto the grid in
  six launches: the points' stable order by base cell by a counting (LSD
  radix) sort written in the kernel, a dense base cell's 48 tap sums once
  in pieces spread over threads and then folded, then a block a tile of
  nodes summing the cells that cover it from shared memory, in the order
  below.  Its buffers, the order included, live in a caller-owned
  ``GridWorkspace``;
- ``grid_interpolate`` (``csrc/grid_interpolate.cu``): the fields back at
  the points, one thread a point, 16 taps of 16 bytes each.

The convolution between them is ``torch.fft.rfft2`` / ``irfft2``, as the
JAX package leaves its ``jnp.fft`` outside any kernel.  Each wrapper
launches its kernel on a CUDA tensor (counted in ``<wrapper>.launches``) and
takes its twin (``grid_deposit_reference``, ``grid_interpolate_reference``:
the same sums as plain torch ops, in the same order) on a CPU one; a CUDA
tensor never reaches a twin.

Order of the sums, the twins' and the kernels': the deposit adds in a fixed
order, so two calls on the same input give the same bits.  A point's 16
taps are its base cell (the tap u0, v0) shifted by (du, dv), du, dv in
0..3.  The points are stably sorted by base cell once; each base cell's 48
weighted tap charges are summed over its points in that order, in pieces
of at most 64 points whose sums are then added in turn
(``torch.segment_reduce`` twice: one sequential sum a segment and column),
and each grid node then sums the taps of the base cells that cover it in
(du, dv) row-major order (16 shifted adds).  A scatter-add (``index_add_``)
would add with atomics on the card, in no fixed order.  The interpolation
contracts the y taps first, then the x taps, each as ordered adds.  Every
step is one rounded float32 operation (the cardinal's division by 6 is the
multiplication by float32(1/6) that XLA-CPU makes of it), which the
kernels copy with IEEE intrinsics, so each kernel gives its twin's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import _launch, sm_count

# tap margin: cubic Lagrange uses nodes floor(t)-1 .. floor(t)+2, so points
# map into grid coordinates [3, G-4] and every tap stays on the grid
_MARGIN = 3
_BIG = 3.4e38
# the most points of one base cell that the deposit sums in one sequence
_PIECE = 64
# float32(1 / 6) (bits 0x3E2AAAAB): the cardinal's division by 6 as the
# multiplication that XLA-CPU makes of it, the same on every device (torch
# divides by a scalar exactly on the CPU and by its reciprocal on the card)
_SIXTH = float(np.float32(1.0 / 6.0))
# the most points of a base cell that the deposit kernel's node pass sums
# itself, in the tile that stages the cell; a denser cell is summed once, in
# pieces over many threads (csrc/grid_deposit.cu).  Every value in
# 0 .. 64 gives the same bits (scripts/grid_deposit_readout.py times
# several; 4 was the fastest of 0, 4, 16 and 64 on the 128 and 256 grids)
DEPOSIT_DENSE_POINTS = 4
# blocks of the deposit kernel's piece pass for each SM
DEPOSIT_BLOCKS_PER_SM = 4
# the deposit kernel's limits: keys of at most 20 bits (two 10-bit digits)
# and a look-back value of 30 bits
DEPOSIT_MAX_GRID = 1024
DEPOSIT_MAX_POINTS = (1 << 30) - 1
# points (and cells) a tile of the deposit kernel's order passes
_ORDER_TILE = 2048
# the deposit kernel's small words: two counters, two tickets, two spare,
# then the low digits' histogram (at most 1024 digits)
_SMALL_WORDS = 6 + 1024
# the most pieces of a dense cell that the deposit kernel's node tiles fold
# themselves (csrc/grid_deposit.cu kInlineFold); a cell of more is folded
# once by its fold pass
_INLINE_FOLD = 8


def pick_grid_size(span: float, target_h: float = 0.35,
                   min_g: int = 128, max_g: int = 1024) -> int:
    """Grid nodes per dim for a given embedding span: pow2 bucket keeping
    the node spacing h <= target_h (FIt-SNE's default density is ~3 nodes
    per unit length; the kernels have curvature scale ~1)."""
    need = max(int(np.ceil(span / max(target_h, 1e-6))) + 2 * _MARGIN + 2,
               min_g)
    g = 1 << int(np.ceil(np.log2(need)))
    return int(np.clip(g, min_g, max_g))


def _cardinal(s: torch.Tensor) -> torch.Tensor:
    """The even cardinal function of 4-point Lagrange interpolation on a
    uniform grid at distance s >= 0 (JAX: _lagrange_rows)."""
    inner = (s + 1.0) * (s - 1.0) * (s - 2.0) * 0.5
    outer = -(s - 1.0) * (s - 2.0) * (s - 3.0) * _SIXTH
    return torch.where(s < 1.0, inner, torch.where(s < 2.0, outer, 0.0))


def _taps(t: torch.Tensor):
    """First node floor(t) - 1 [c] and the weights of nodes first..first+3
    [c, 4] for continuous grid coordinates t [c]."""
    first = torch.floor(t) - 1.0
    nodes = first[:, None] + torch.arange(4, dtype=t.dtype, device=t.device)
    return first.long(), _cardinal(torch.abs(t[:, None] - nodes))


def grid_box(y: torch.Tensor, n_valid: int, grid: int):
    """(lo [2], h [2]): the bounding box of the valid rows and the node
    spacing that maps it onto nodes 3 .. G-4."""
    n_valid = int(n_valid)
    if n_valid > 0:
        lo, hi = torch.aminmax(y[:n_valid], dim=0)
    else:
        lo = torch.full((2,), _BIG, dtype=y.dtype, device=y.device)
        hi = -lo
    usable = float(grid - 2 * _MARGIN - 1)
    return lo, torch.clamp((hi - lo) / usable, min=1e-6)


def grid_coords(y: torch.Tensor, lo: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """Continuous grid coordinates [c, 2] (x, y) of the points y [c, 2]."""
    return (y - lo) / h + float(_MARGIN)


def base_cells(t: torch.Tensor, grid: int) -> torch.Tensor:
    """[c] int32: each point's base cell u0 * G + v0, (u0, v0) the first
    y and x nodes of its taps, from its grid coordinates t [c, 2]."""
    first = (torch.floor(t) - 1.0).to(torch.int32)
    return first[:, 1] * grid + first[:, 0]


def grid_taps(y: torch.Tensor, lo: torch.Tensor, h: torch.Tensor,
              grid: int):
    """For the points y [c, 2]: the flat cell ids of their 16 taps [c, 16]
    (u * G + v, u the y node, v the x node) and the x and y weights
    [c, 4] each (the twins' taps)."""
    t = grid_coords(y, lo, h)
    vx, wx = _taps(t[:, 0])
    uy, wy = _taps(t[:, 1])
    ar = torch.arange(4, device=y.device)
    cells = ((uy[:, None] + ar)[:, :, None] * grid
             + (vx[:, None] + ar)[:, None, :])
    return cells.reshape(-1, 16), wx, wy


def _check_box(name: str, y: torch.Tensor, lo: torch.Tensor,
               h: torch.Tensor, grid: int):
    if y.dim() != 2 or y.shape[1] != 2:
        raise ValueError(f"{name}: y must be [rows, 2], got "
                         f"{tuple(y.shape)}")
    if not (y.dtype == lo.dtype == h.dtype == torch.float32):
        raise TypeError(f"{name}: y, lo and h must be float32")
    if lo.numel() != 2 or h.numel() != 2:
        raise ValueError(f"{name}: lo and h must hold 2 values each")
    if not (y.device == lo.device == h.device):
        raise ValueError(f"{name}: y, lo and h lie on different devices")
    if not 8 <= grid <= 32768:
        raise ValueError(f"{name}: grid {grid} outside [8, 32768]")


def _on_card(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if any(t.data_ptr() % 8 for t in tensors if t.numel()):
        raise ValueError(f"{name}: inputs must be 8-byte aligned")
    return dev


# ---------------------------------------------------------------------------
# the deposit
# ---------------------------------------------------------------------------

def cell_sums(y: torch.Tensor, cells: torch.Tensor, wx: torch.Tensor,
              wy: torch.Tensor, grid: int) -> torch.Tensor:
    """[G*G, 48] the weighted tap charges of each base cell's points,
    laid out (charge, du, dv), summed in a fixed order (see the module
    doc): segment sums in the points' stably sorted order, in pieces."""
    c = y.shape[0]
    base = cells[:, 0].to(torch.int32)                       # u0 * G + v0
    bases, order = torch.sort(base, stable=True)
    # each point's charges and weights, gathered once in that order
    ones = torch.ones((c, 1), dtype=y.dtype, device=y.device)
    packed = torch.index_select(torch.cat([ones, y, wx, wy], 1), 0, order)
    q, wxs, wys = packed[:, :3], packed[:, 3:7], packed[:, 7:]
    # weight order of the JAX package's rows: wy * (q * wx)
    qx = q[:, :, None] * wxs[:, None, :]                     # [c, 3, 4(v)]
    src = (wys[:, None, :, None] * qx[:, :, None, :]).reshape(c, 48)
    # each cell's points in pieces of at most _PIECE: the sums of the pieces
    # (level 1), then of each cell's pieces (level 2), so that no thread of
    # segment_reduce walks a whole crowded cell alone
    rank = torch.arange(c, device=y.device) - torch.searchsorted(bases, bases)
    piece = torch.cumsum(rank % _PIECE == 0, 0) - 1
    pieces = grid * grid + c // _PIECE            # at least the pieces made
    bounds = torch.searchsorted(piece, torch.arange(pieces + 1,
                                                    device=y.device))
    # unsafe: the bounds are valid by construction, and the checks of the
    # safe call would wait on the card twice
    part = torch.segment_reduce(src, "sum", offsets=bounds, axis=0,
                                unsafe=True, initial=0.0)
    made = bounds[:-1] < c                        # unused pieces stay empty
    cell = torch.where(made, bases[bounds[:-1].clamp(max=c - 1)],
                       grid * grid)
    bounds = torch.searchsorted(cell, torch.arange(
        grid * grid + 1, dtype=torch.int32, device=y.device))
    return torch.segment_reduce(part, "sum", offsets=bounds, axis=0,
                                unsafe=True, initial=0.0)


def deposit_charges(y: torch.Tensor, cells: torch.Tensor, wx: torch.Tensor,
                    wy: torch.Tensor, grid: int) -> torch.Tensor:
    """[3, G, G] charge grids (unit, y_x, y_y), laid out [u, v], from the
    points y [c, 2] with their taps: each base cell's summed tap charges
    (``cell_sums``) added onto the nodes they cover, (du, dv) in row-major
    order, each node from 0."""
    if y.shape[0] == 0:
        return torch.zeros((3, grid, grid), dtype=y.dtype, device=y.device)
    sums = cell_sums(y, cells, wx, wy, grid).T.reshape(3, 4, 4, grid, grid)
    out = torch.zeros((3, grid + 3, grid + 3), dtype=y.dtype,
                      device=y.device)
    for du in range(4):
        for dv in range(4):
            out[:, du:du + grid, dv:dv + grid] += sums[:, du, dv]
    return out[:, :grid, :grid]


def grid_deposit_reference(y: torch.Tensor, lo: torch.Tensor,
                           h: torch.Tensor, grid: int) -> torch.Tensor:
    """The plain PyTorch twin of ``grid_deposit``, on whatever device the
    tensors lie: the taps as a table, the cell sums, the shifted adds."""
    _check_box("grid_deposit", y, lo, h, grid)
    return deposit_charges(y, *grid_taps(y, lo, h, grid), grid)


def dense_cells_bound(n: int, grid: int, dense: int) -> int:
    """The most cells of more than `dense` of n points on a G x G grid."""
    return min(grid * grid, n // (dense + 1))


def large_cells_bound(n: int) -> int:
    """The most cells of more than _INLINE_FOLD pieces: the deposit
    kernel's list of the cells that its fold pass folds (first row and
    pieces each)."""
    return n // (_INLINE_FOLD * _PIECE + 1)


def deposit_rows(n: int, grid: int, dense: int) -> int:
    """Rows of the deposit kernel's piece table: a row for each piece of
    64 points of a dense cell, at most n // 64 + one more a dense cell."""
    return n // _PIECE + dense_cells_bound(n, grid, dense)


def order_status_words(n: int, grid: int) -> int:
    """Look-back words of the deposit kernel's order passes: one a tile of
    the cells' scan, one a tile and digit of each radix pass (keys of
    ceil(log2 G^2) bits split into a low and a high digit)."""
    bits = max(grid * grid - 1, 1).bit_length()
    tiles = -(-n // _ORDER_TILE)
    return (-(-grid * grid // _ORDER_TILE)
            + tiles * ((1 << (bits // 2)) + (1 << (bits - bits // 2))))


class GridWorkspace:
    """Caller-owned buffers of ``grid_deposit`` on one card, reused from
    call to call: the keys, the first radix pass's records, the order, the
    points in it, the cells' counts, starts and first rows, the look-back
    words, the large cells' list, the pieces' point ranges and the piece
    table.  They grow to the largest n and grid served; one call at a time
    may use them (one stream).  After a call ``order`` [n] int32 is its
    points' stable order by base cell; the next call overwrites it.  The counts and the
    small words are 0 between calls (the kernel clears what it used, and
    its first pass clears the look-back words), so nothing is cleared from
    the host."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.type != "cuda":
            raise ValueError(f"GridWorkspace: no kernel for {device}")
        self.device = device
        self.order = None
        self._size = {}
        self._blocks = DEPOSIT_BLOCKS_PER_SM * sm_count(device)

    def _grow(self, name: str, size: int, shape, dtype, zero: bool = False):
        """Make buffer `name` anew when it holds fewer than `size` rows."""
        if self._size.get(name, 0) < size:
            make = torch.zeros if zero else torch.empty
            setattr(self, name, make(shape, dtype=dtype, device=self.device))
            self._size[name] = size

    def _buffers(self, n: int, grid: int, dense: int) -> list:
        """The launch's buffer pointers for (n, grid, dense), growing the
        buffers that are too small."""
        i32, f32, cells = torch.int32, torch.float32, grid * grid
        large = max(large_cells_bound(n), 1)
        rows = max(deposit_rows(n, grid, dense), 1)
        words = order_status_words(n, grid)
        for name, size, shape, dtype, zero in (
                ("keys", n, n, i32, False), ("pairs", n, (n, 4), i32, False),
                ("_order", n, n, i32, False), ("ys", n, (n, 2), f32, False),
                ("counts", cells, cells, i32, True),
                ("start", cells, cells + 1, i32, False),
                ("dense_row", cells, cells, i32, False),
                ("small", 1, _SMALL_WORDS, i32, True),
                ("status", words, words, i32, False),
                ("large", large, (large, 2), i32, False),
                ("rows", rows, (rows, 2), i32, False),
                ("table", rows, (rows, 48), f32, False)):
            self._grow(name, size, shape, dtype, zero)
        return [getattr(self, name).data_ptr() for name in (
            "keys", "pairs", "_order", "ys", "counts", "start", "dense_row",
            "small", "status", "large", "rows")]

    def launch(self, y: torch.Tensor, lo: torch.Tensor, h: torch.Tensor,
               grid: int, dense: int, out: torch.Tensor = None):
        """One deposit (six kernels) into `out` [3, G, G] on the current
        stream, or with `out` None its order passes alone (the first
        three); the inputs are checked by the caller."""
        n = y.shape[0]
        args = self._buffers(n, grid, dense)
        if out is not None:
            args += [self.table.data_ptr(), out.data_ptr()]
        try:
            _launch("grid_deposit", self.device, y.data_ptr(),
                    lo.data_ptr(), h.data_ptr(), n, grid, dense,
                    self._blocks, *args,
                    entry="" if out is not None else "grid_deposit_order")
        except RuntimeError:
            # a launch that did not run may leave counts behind: clear them
            self.counts.zero_()
            self.small.zero_()
            raise
        self.order = self._order[:n]

    def order_passes(self, y: torch.Tensor, lo: torch.Tensor,
                     h: torch.Tensor, grid: int):
        """The deposit's first three kernels alone (its order passes) on
        the points y [n, 2] (1 <= n) in the box, leaving ``order`` as a
        deposit leaves it and computing no charges: for timing them apart.
        Not counted in ``grid_deposit.launches``."""
        _check_box("grid_deposit", y, lo, h, int(grid))
        y, lo, h = y.contiguous(), lo.contiguous(), h.contiguous()
        if _on_card("grid_deposit", y, lo, h) != self.device:
            raise ValueError("grid_deposit: y lies on another card")
        self.launch(y, lo, h, int(grid), DEPOSIT_DENSE_POINTS)


def grid_deposit(y: torch.Tensor, lo: torch.Tensor, h: torch.Tensor,
                 grid: int, workspace: GridWorkspace = None) -> torch.Tensor:
    """[3, G, G] charge grids (unit, y_x, y_y), laid out [u, v], of the
    points y [c, 2] in the box (lo, h) (``grid_box``).

    On a CUDA tensor the kernel ``csrc/grid_deposit.cu`` (counted in
    ``grid_deposit.launches``; G <= 1024): the points' stable order by base
    cell sorted in the kernel, a base cell of more than
    DEPOSIT_DENSE_POINTS points summed once in pieces and folded, the
    nodes summed tile by tile.  Its buffers are ``workspace``'s, a
    ``GridWorkspace`` on y's card that the caller keeps (required there),
    whose ``order`` then holds the points' order.  On a CPU tensor the
    twin ``grid_deposit_reference``.  Both give the same bits on one
    device, whatever the threshold.  No rows: zero charges, and no
    launch."""
    grid = int(grid)
    if y.device.type == "cpu":
        return grid_deposit_reference(y, lo, h, grid)
    _check_box("grid_deposit", y, lo, h, grid)
    y, lo, h = y.contiguous(), lo.contiguous(), h.contiguous()
    dev = _on_card("grid_deposit", y, lo, h)
    if workspace is None:
        raise ValueError("grid_deposit: a GridWorkspace is required on "
                         f"{dev}")
    if workspace.device != dev:
        raise ValueError(f"grid_deposit: y lies on {dev}, the workspace on "
                         f"{workspace.device}")
    if grid > DEPOSIT_MAX_GRID:
        raise ValueError(f"grid_deposit: the kernel takes grid <= "
                         f"{DEPOSIT_MAX_GRID}, got {grid}")
    c = y.shape[0]
    if c > DEPOSIT_MAX_POINTS:
        raise ValueError(f"grid_deposit: the kernel takes at most "
                         f"{DEPOSIT_MAX_POINTS} points, got {c}")
    out = torch.empty((3, grid, grid), dtype=torch.float32, device=dev)
    if c == 0:
        workspace.order = torch.empty(0, dtype=torch.int32, device=dev)
        return out.zero_()
    workspace.launch(y, lo, h, grid, DEPOSIT_DENSE_POINTS, out)
    grid_deposit.launches += 1
    return out


grid_deposit.launches = 0


# ---------------------------------------------------------------------------
# the convolution
# ---------------------------------------------------------------------------

def _kernel_spectra(h: torch.Tensor, grid: int):
    """rfft2 of k2 and k1 sampled at the wrapped offsets of the [2G, 2G]
    grid (circular convolution of the zero-padded charges)."""
    two_g = 2 * grid
    ar = torch.arange(two_g, device=h.device)
    off = torch.where(ar < grid, ar, ar - two_g).to(torch.float32)
    dy = (off * h[1])[:, None]
    dx = (off * h[0])[None, :]
    k1 = 1.0 / (1.0 + (dx * dx + dy * dy))
    return torch.fft.rfft2(torch.stack([k1 * k1, k1]))


def field_grids(charges: torch.Tensor, h: torch.Tensor,
                grid: int) -> torch.Tensor:
    """Convolve the [3, G, G] charges with the kernels by FFT -> [4, G, G]
    fields: k2 * (unit, y_x, y_y) and k1 * unit."""
    two_g = 2 * grid
    padded = torch.zeros((3, two_g, two_g), dtype=charges.dtype,
                         device=charges.device)
    padded[:, :grid, :grid] = charges
    cf = torch.fft.rfft2(padded)
    kf = _kernel_spectra(h, grid)
    spectra = torch.cat([cf * kf[0], (cf[0] * kf[1])[None]])
    return torch.fft.irfft2(spectra, s=(two_g, two_g))[:, :grid, :grid]


# ---------------------------------------------------------------------------
# the interpolation
# ---------------------------------------------------------------------------

def interpolate_fields(fields: torch.Tensor, cells: torch.Tensor,
                       wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """The [4, G, G] fields at the points: a 16-tap gather -> [c, 4]
    (phi0, phi_yx, phi_yy, phi_z).  Contracts the y taps first, then the x
    taps, as the JAX package's matmuls do, each as adds in tap order."""
    c = cells.shape[0]
    flat = fields.reshape(4, -1).T                            # [G*G, 4]
    cells = cells.reshape(c, 4, 4)                            # [c, u, v]
    tv = None                                                 # [c, v, q]
    for du in range(4):
        term = wy[:, du, None, None] * flat[cells[:, du]]
        tv = term if tv is None else tv + term
    phi = None                                                # [c, q]
    for dv in range(4):
        term = wx[:, dv, None] * tv[:, dv]
        phi = term if phi is None else phi + term
    return phi


def _check_fields(name: str, fields: torch.Tensor, y: torch.Tensor,
                  n_valid: int):
    if (fields.dim() != 3 or fields.shape[0] != 4
            or fields.shape[1] != fields.shape[2]):
        raise ValueError(f"{name}: fields must be [4, G, G], got "
                         f"{tuple(fields.shape)}")
    if fields.dtype != torch.float32 or fields.device != y.device:
        raise ValueError(f"{name}: fields must be float32 on y's device")
    if not 0 <= n_valid <= y.shape[0]:
        raise ValueError(f"{name}: n_valid {n_valid} outside "
                         f"[0, {y.shape[0]}]")


def grid_interpolate_reference(fields: torch.Tensor, y: torch.Tensor,
                               n_valid: int, lo: torch.Tensor,
                               h: torch.Tensor):
    """The plain PyTorch twin of ``grid_interpolate``, on whatever device
    the tensors lie: the taps as a table and the gathered [c, 4, 4] values
    contracted in tap order."""
    n_valid = int(n_valid)
    grid = fields.shape[-1]
    _check_box("grid_interpolate", y, lo, h, grid)
    _check_fields("grid_interpolate", fields, y, n_valid)
    yv = y[:n_valid]
    cells, wx, wy = grid_taps(yv, lo, h, grid)
    phi = interpolate_fields(fields, cells, wx, wy)
    rep = torch.zeros_like(y)
    rep[:n_valid] = yv * phi[:, 0:1] - phi[:, 1:3]
    return rep, phi[:, 3].contiguous().sum()


def grid_interpolate(fields: torch.Tensor, y: torch.Tensor, n_valid: int,
                     lo: torch.Tensor, h: torch.Tensor):
    """The [4, G, G] fields (``field_grids``) at the valid rows of y
    [Npad, 2] in the box (lo, h): (rep [Npad, 2], y_i phi0 - phi_y, pad rows
    0; the sum of phi_z over the valid rows, a 0-d tensor).

    On a CUDA tensor the kernel ``csrc/grid_interpolate.cu`` (counted in
    ``grid_interpolate.launches``) on a node-major [G, G, 4] copy of the
    fields, its phi_z summed by the twin's torch call; on a CPU tensor the
    twin ``grid_interpolate_reference``.  Both give the same bits on one
    device.  No valid rows: zeros, and no launch."""
    n_valid = int(n_valid)
    if y.device.type == "cpu":
        return grid_interpolate_reference(fields, y, n_valid, lo, h)
    grid = fields.shape[-1]
    _check_box("grid_interpolate", y, lo, h, grid)
    _check_fields("grid_interpolate", fields, y, n_valid)
    y, lo, h = y.contiguous(), lo.contiguous(), h.contiguous()
    node_major = fields.permute(1, 2, 0).contiguous()         # [G, G, 4]
    dev = _on_card("grid_interpolate", y, lo, h, node_major)
    if n_valid == 0:
        return (torch.zeros_like(y),
                torch.zeros((), dtype=torch.float32, device=dev))
    rep = torch.empty_like(y)
    phi_z = torch.empty(n_valid, dtype=torch.float32, device=dev)
    _launch("grid_interpolate", dev, y.data_ptr(), n_valid, y.shape[0],
            lo.data_ptr(), h.data_ptr(), node_major.data_ptr(), grid,
            rep.data_ptr(), phi_z.data_ptr())
    grid_interpolate.launches += 1
    return rep, phi_z.sum()


grid_interpolate.launches = 0


def grid_repulsion(y: torch.Tensor, n_valid: int, grid: int,
                   workspace: GridWorkspace = None):
    """Approximate Student-t repulsion via kernel-interpolated grid
    convolution: y [Npad, 2] -> (rep [Npad, 2], Z 0-d tensor), the
    semantics of the exact repulsion (rep_i = sum_j k2 (y_i - y_j),
    Z = sum_{i != j} k1).  Pad rows (>= n_valid) carry no charge and get
    zero force.  On a card the deposit's buffers are ``workspace``'s (a
    ``GridWorkspace`` the caller keeps, required there)."""
    n_valid = int(n_valid)
    lo, h = grid_box(y, n_valid, grid)
    charges = grid_deposit(y[:n_valid], lo, h, grid, workspace)
    rep, z = grid_interpolate(field_grids(charges, h, grid), y, n_valid, lo,
                              h)
    return rep, torch.clamp(z - float(n_valid), min=1e-12)
