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

- ``grid_deposit`` (``csrc/grid_deposit.cu``): the charges onto the grid,
  a dense base cell's 48 tap sums once in pieces spread over threads, then
  one thread a grid node summing the 16 base cells that cover it, in the
  order below;
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
# directly at each of the cell's 16 nodes; a denser cell is summed once, in
# pieces, by the piece pass (csrc/grid_deposit.cu).  4 was the fastest of
# 0, 4, 16 and 64 at 10^6 points on the 1024 grid and as fast as any on
# the 128-512 grids (scripts/grid_deposit_readout.py, PERF.md)
DEPOSIT_DENSE_POINTS = 4
# blocks of the deposit kernel's striding passes for each SM
DEPOSIT_BLOCKS_PER_SM = 4


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


def deposit_rows(n: int, grid: int, dense: int) -> int:
    """Rows of the deposit kernel's piece table: each cell of more than
    `dense` points takes a header row and a row a piece, at most
    2 min(G^2, n // (dense + 1)) + n // 64 in all."""
    return 2 * min(grid * grid, n // (dense + 1)) + n // _PIECE + 1


def grid_deposit(y: torch.Tensor, lo: torch.Tensor, h: torch.Tensor,
                 grid: int) -> torch.Tensor:
    """[3, G, G] charge grids (unit, y_x, y_y), laid out [u, v], of the
    points y [c, 2] in the box (lo, h) (``grid_box``).

    On a CUDA tensor the kernel ``csrc/grid_deposit.cu`` (counted in
    ``grid_deposit.launches``), after the points' stable sort by base cell
    (``torch.sort``); a base cell of more than DEPOSIT_DENSE_POINTS points
    is summed once in pieces, the others at each node they cover.  On a
    CPU tensor the twin ``grid_deposit_reference``.  Both give the same
    bits on one device, whatever the threshold.  No rows: zero charges,
    and no launch."""
    grid = int(grid)
    if y.device.type == "cpu":
        return grid_deposit_reference(y, lo, h, grid)
    _check_box("grid_deposit", y, lo, h, grid)
    y, lo, h = y.contiguous(), lo.contiguous(), h.contiguous()
    dev = _on_card("grid_deposit", y, lo, h)
    c = y.shape[0]
    out = torch.empty((3, grid, grid), dtype=torch.float32, device=dev)
    if c == 0:
        return out.zero_()
    keys, order = torch.sort(base_cells(grid_coords(y, lo, h), grid),
                             stable=True)
    dense = DEPOSIT_DENSE_POINTS
    rows = deposit_rows(c, grid, dense)
    ys = torch.empty((c, 2), dtype=torch.float32, device=dev)
    ints = torch.empty(3 * grid * grid + 1, dtype=torch.int32, device=dev)
    row_list = torch.empty((rows, 2), dtype=torch.int32, device=dev)
    table = torch.empty((rows, 48), dtype=torch.float32, device=dev)
    _launch("grid_deposit", dev, y.data_ptr(), lo.data_ptr(), h.data_ptr(),
            keys.data_ptr(), order.data_ptr(), c, grid, dense,
            DEPOSIT_BLOCKS_PER_SM * sm_count(dev), ys.data_ptr(),
            ints.data_ptr(), row_list.data_ptr(), table.data_ptr(),
            out.data_ptr())
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


def grid_repulsion(y: torch.Tensor, n_valid: int, grid: int):
    """Approximate Student-t repulsion via kernel-interpolated grid
    convolution: y [Npad, 2] -> (rep [Npad, 2], Z 0-d tensor), the
    semantics of the exact repulsion (rep_i = sum_j k2 (y_i - y_j),
    Z = sum_{i != j} k1).  Pad rows (>= n_valid) carry no charge and get
    zero force."""
    n_valid = int(n_valid)
    lo, h = grid_box(y, n_valid, grid)
    charges = grid_deposit(y[:n_valid], lo, h, grid)
    rep, z = grid_interpolate(field_grids(charges, h, grid), y, n_valid, lo,
                              h)
    return rep, torch.clamp(z - float(n_valid), min=1e-12)
