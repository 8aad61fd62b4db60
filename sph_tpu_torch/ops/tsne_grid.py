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
scatters serialize on a TPU.  Here each point has its 4 x 4 taps: the
charges go onto the grid by sorted segment sums (below), and the fields
come back with one 16-tap gather; the convolution is ``torch.fft.rfft2`` /
``irfft2``.  These are torch ops (the JAX program has no Pallas source); a
hand-written kernel waits until a profile names one.

Order of the sums: the deposit adds in a fixed order, so two calls on the
same input give the same bits.  A point's 16 taps are its base cell (the
tap u0, v0) shifted by (du, dv), du, dv in 0..3.  The points are stably
sorted by base cell once; each base cell's 48 weighted tap charges are
summed over its points in that order, in pieces of at most 64 points
whose sums are then added in turn (``torch.segment_reduce`` twice: one
sequential sum a segment and column), and each grid node then sums the
taps of the base cells that cover it (``torch.nn.functional.fold``: a
gather over the covering cells in a fixed order).  A scatter-add
(``index_add_``) would add with atomics on the card, in no fixed order.
"""

from __future__ import annotations

import numpy as np
import torch

# tap margin: cubic Lagrange uses nodes floor(t)-1 .. floor(t)+2, so points
# map into grid coordinates [3, G-4] and every tap stays on the grid
_MARGIN = 3
_BIG = 3.4e38
# the most points of one base cell that the deposit sums in one sequence
_PIECE = 64


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
    outer = -(s - 1.0) * (s - 2.0) * (s - 3.0) / 6.0
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
    valid = (torch.arange(y.shape[0], device=y.device) < n_valid)[:, None]
    lo = torch.where(valid, y, _BIG).amin(0)
    hi = torch.where(valid, y, -_BIG).amax(0)
    usable = float(grid - 2 * _MARGIN - 1)
    return lo, torch.clamp((hi - lo) / usable, min=1e-6)


def grid_taps(y: torch.Tensor, lo: torch.Tensor, h: torch.Tensor,
              grid: int):
    """For the points y [c, 2]: the flat cell ids of their 16 taps [c, 16]
    (u * G + v, u the y node, v the x node) and the x and y weights
    [c, 4] each."""
    t = (y - lo) / h + float(_MARGIN)
    vx, wx = _taps(t[:, 0])
    uy, wy = _taps(t[:, 1])
    ar = torch.arange(4, device=y.device)
    cells = ((uy[:, None] + ar)[:, :, None] * grid
             + (vx[:, None] + ar)[:, None, :])
    return cells.reshape(-1, 16), wx, wy


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
    (``cell_sums``) folded onto the grid."""
    sums = cell_sums(y, cells, wx, wy, grid)
    out = torch.nn.functional.fold(sums.T[None], (grid + 3, grid + 3),
                                   kernel_size=4)
    return out[0, :, :grid, :grid]


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


def interpolate_fields(fields: torch.Tensor, cells: torch.Tensor,
                       wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """The [4, G, G] fields at the points: a 16-tap gather -> [c, 4]
    (phi0, phi_yx, phi_yy, phi_z).  Contracts the y taps first, then the x
    taps, as the JAX package's matmuls do."""
    c = cells.shape[0]
    flat = fields.reshape(4, -1).T                            # [G*G, 4]
    vals = flat[cells].reshape(c, 4, 4, 4)                    # [c, u, v, q]
    t = (wy[:, :, None, None] * vals).sum(1)                  # [c, v, q]
    return (wx[:, :, None] * t).sum(1)


def grid_repulsion(y: torch.Tensor, n_valid: int, grid: int):
    """Approximate Student-t repulsion via kernel-interpolated grid
    convolution: y [Npad, 2] -> (rep [Npad, 2], Z 0-d tensor), the
    semantics of the exact repulsion (rep_i = sum_j k2 (y_i - y_j),
    Z = sum_{i != j} k1).  Pad rows (>= n_valid) carry no charge and get
    zero force."""
    n_valid = int(n_valid)
    lo, h = grid_box(y, n_valid, grid)
    yv = y[:n_valid]
    cells, wx, wy = grid_taps(yv, lo, h, grid)
    fields = field_grids(deposit_charges(yv, cells, wx, wy, grid), h, grid)
    f = interpolate_fields(fields, cells, wx, wy)
    rep = torch.zeros_like(y)
    rep[:n_valid] = yv * f[:, 0:1] - f[:, 1:3]
    z = f[:, 3].sum() - float(n_valid)
    return rep, torch.clamp(z, min=1e-12)
