"""t-SNE gradient descent: the dense-P, exact sparse-P and grid tiers.

Port of sph_tpu/models/tsne.py (reference: sph/EmbedTsne.cpp — HDILib's
gradient descent with exaggeration factor clamp(4 + N/60000, 4, 20),
:138-139).  Momentum, gains and the exaggeration schedule follow HDILib's
TsneParameters defaults (minimum gain 0.1, eta 200, momentum 0.2 -> 0.8 at
iteration 250, exaggeration removed at 250 with exponential decay over 150).

The tier is chosen as the JAX package chooses it with its kernels on
(``select_tier``, sph_tpu/models/tsne.py:410-437), from the same environment
switches read at the same moment:

- dense: the joint P densified once to [Npad, Npad]; every iteration takes
  one fused pass over it (``tsne_forces_dense``);
- exact: the sparse attraction gathered over P's support
  (``attractive_forces``) plus the exact all-pairs repulsion
  (``tsne_repulsion``);
- grid: the sparse attraction plus the grid-interpolated repulsion
  (ops/tsne_grid.py), the default above 32768 points.  P is cut to 64
  entries a row (``SPH_TSNE_GRID_P_WIDTH``), and the grid size is picked
  from the layout's span once per dispatch chunk of
  ``DISPATCH_BUDGET // Npad`` iterations, where the JAX package picks it.

The attraction (``tsne_attraction``) reads the neighbours' positions in
float32, or, packed, from a u16 fixed-point table over the layout's
bounding box (ops/packing.py), as the JAX package does: ``SPH_TSNE_ATTR_
PACKED`` "auto" (the default) packs on the grid tier only, "1" on every
sparse tier, "0" never.  The KL always reads float32 positions.

The kernels (ops/tsne_kernels.py) run on the card for a tensor there and
their plain twins for one on the CPU.  The iterations are a Python loop of
torch ops on the device.  P comes either as a symmetrized probability
matrix or from a kNN graph (``set_neighbor_graph``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.packing import pack_positions
from ..ops.sparse import SparseRows, topk_rows
from ..ops.tsne_grid import GridWorkspace, grid_repulsion, pick_grid_size
from ..ops.tsne_kernels import (ATTR_FUSE_MAX, ATTR_PIECE, DenseForces,
                                attraction_chunk, tsne_attraction,
                                tsne_forces_dense, tsne_repulsion)
from ..utils.logging import Log

# defaults of the JAX package's environment switches
DENSE_P_MAX = 32768      # SPH_TSNE_DENSE_P_MAX
GRID_MIN = 32768         # SPH_TSNE_GRID_MIN
P_WIDTH_CAP = 1024       # SPH_TSNE_P_WIDTH_CAP
GRID_P_WIDTH = 64        # SPH_TSNE_GRID_P_WIDTH
GRID_MAX = 1024          # SPH_TSNE_GRID_MAX
# row-iterations per device program in the JAX package
# (SPH_TSNE_DISPATCH_BUDGET); on the grid tier it sets how often the grid
# size is picked again
DISPATCH_BUDGET = 1 << 24
SPARSE_BLOCK = 512       # TsneComputation(block=512): the exact tier's padding


@dataclass
class TsneParameters:
    """HDILib hdi::dr::TsneParameters defaults (wired through
    TsneEmbeddingParameters, EmbedTsne.hpp:37-46)."""

    perplexity: float = 30.0
    perplexity_multiplier: int = 3
    num_iterations: int = 1000
    eta: float = 200.0
    momentum: float = 0.2
    final_momentum: float = 0.8
    mom_switching_iter: int = 250
    exaggeration_factor: float = 4.0     # overridden by N-dependent clamp
    remove_exaggeration_iter: int = 250
    exponential_decay_iter: int = 150
    minimum_gain: float = 0.1
    embedding_dims: int = 2


def default_exaggeration(num_points: int) -> float:
    """Reference: EmbedTsne.cpp:138-139."""
    return float(np.clip(4.0 + num_points / 60_000.0, 4.0, 20.0))


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dense_npad(n: int) -> int:
    """Rows of the dense P tile for n points: a multiple of the column
    block min(1024, n rounded up to 256), as the JAX package pads it."""
    return _ceil_to(n, min(1024, _ceil_to(n, 256)))


def sparse_npad(n: int) -> int:
    """Rows of the exact sparse tier for n points: a multiple of the block
    min(512, n rounded up to 8), as the JAX package pads it."""
    return _ceil_to(n, min(SPARSE_BLOCK, _ceil_to(n, 8)))


def _switch(name: str) -> Optional[bool]:
    """An SPH_TSNE_* force switch: "1" on, "0" off, anything else auto."""
    return {"1": True, "0": False}.get(os.environ.get(name, "auto"))


def select_tier(n: int) -> str:
    """"dense", "exact" or "grid" for n points, from SPH_TSNE_DENSE_P,
    SPH_TSNE_DENSE_P_MAX, SPH_TSNE_GRID and SPH_TSNE_GRID_MIN, as the JAX
    package's _init_gradient_descent picks with its kernels on
    (sph_tpu/models/tsne.py:414-437): the grid wins over dense P."""
    dense = _switch("SPH_TSNE_DENSE_P")
    if dense is None:
        dense = n <= int(os.environ.get("SPH_TSNE_DENSE_P_MAX",
                                        str(DENSE_P_MAX)))
    grid = _switch("SPH_TSNE_GRID")
    if grid is None:
        grid = n > int(os.environ.get("SPH_TSNE_GRID_MIN", str(GRID_MIN)))
    return "grid" if grid else "dense" if dense else "exact"


def _row_chunk(npts: int, width: int) -> int:
    """Rows per piece of a gather over P's support: all rows up to
    ATTR_FUSE_MAX entries, else pieces of about ATTR_PIECE entries.  The
    pieces bound memory and leave the result as it is."""
    return attraction_chunk(npts, width, ATTR_FUSE_MAX, ATTR_PIECE)


def _neighbor_diffs(y: torch.Tensor, p_idx: torch.Tensor, r0: int, r1: int):
    """(y_i - y_j) by coordinate and w = 1 / (1 + |y_i - y_j|^2) over P's
    support for P rows r0..r1, each [r1 - r0, R]: the KL's float32 reads
    (JAX: _neighbor_diffs)."""
    idx = torch.clamp(p_idx[r0:r1], min=0)
    d0 = y[r0:r1, 0:1] - y[:, 0][idx]
    d1 = y[r0:r1, 1:2] - y[:, 1][idx]
    return d0, d1, 1.0 / (1.0 + d0 * d0 + d1 * d1)


def attractive_forces(y: torch.Tensor, p_idx: torch.Tensor,
                      p_val: torch.Tensor, row0: int = 0,
                      packed: bool = False) -> torch.Tensor:
    """Sparse attraction sum_j p_ij w_ij (y_i - y_j) over P's support (JAX:
    _attractive_forces): the ``tsne_attraction`` kernel, or its twin on
    the CPU in row pieces that bound the gathered [rows, R] buffers.  P's
    rows are the points row0 .. row0 + len(p_idx) of y (a row shard, whose
    column ids are global); the kernel takes int32 ids.  packed=True reads
    the neighbours from the u16 table of all of y's rows, pad rows
    included, as the JAX package packs its padded layout."""
    table = prm = None
    if packed:
        table, prm = pack_positions(y[:, 0], y[:, 1])
    return tsne_attraction(y, p_idx, p_val, row0, table, prm,
                           _row_chunk(*p_idx.shape))


def repulsive_forces(y: torch.Tensor, n_valid: int, block: int = 1024):
    """Exact O(N^2) Student-t repulsion in row blocks: (rep [Np, 2] =
    sum_j w_ij^2 (y_i - y_j), Z = sum_{i != j} w_ij).  Pad rows (>= n_valid)
    contribute nothing.  Distances use the |y_i|^2 + |y_j|^2 - 2 y_i.y_j
    expansion of the JAX package's ``_repulsive_forces``."""
    npad = y.shape[0]
    sq = torch.sum(y * y, dim=1)
    ids = torch.arange(npad, device=y.device)
    col_ok = ids < n_valid
    rep = torch.zeros_like(y)
    z = torch.zeros((), dtype=torch.float32, device=y.device)
    for r0 in range(0, npad, block):
        r1 = min(r0 + block, npad)
        yb = y[r0:r1]
        d2 = sq[r0:r1, None] + sq[None, :] - 2.0 * (yb @ y.T)
        w = 1.0 / (1.0 + torch.clamp(d2, min=0.0))
        rows = ids[r0:r1, None]
        valid = (ids[None, :] != rows) & col_ok[None, :] & (rows < n_valid)
        w = torch.where(valid, w, 0.0)
        z = z + w.sum()
        w2 = w * w
        rep[r0:r1] = w2.sum(1)[:, None] * yb - w2 @ y
    return rep, z


def tsne_kl_divergence(y: torch.Tensor, p_idx: torch.Tensor,
                       p_val: torch.Tensor, n_valid: int,
                       grid: int = 0, workspace=None) -> torch.Tensor:
    """KL(P || Q) over P's off-diagonal support: sum p log(p / q), q = w/Z,
    with P renormalized over that support (Q gives i == j no mass).

    grid > 0 (the grid tier) takes Z from ``grid_repulsion`` with that many
    nodes, as the JAX package does (on a card with ``workspace``, the
    computation's ``GridWorkspace``).  Otherwise Z comes from the
    ``tsne_repulsion`` kernel on the card and from ``repulsive_forces``,
    the counterpart of the JAX package's XLA repulsion, on the CPU.  The
    support is visited in the row pieces of ``attractive_forces``."""
    if grid > 0:
        _, z = grid_repulsion(y, n_valid, grid, workspace)
    elif y.device.type == "cpu":
        _, z = repulsive_forces(y, n_valid)
    else:
        _, z = tsne_repulsion(y, n_valid)
    npts, width = p_idx.shape
    rows = torch.arange(npts, device=y.device)[:, None]
    valid = (p_idx >= 0) & (p_val > 0) & (p_idx != rows)
    p_mass = torch.where(valid, p_val, 0.0).sum()
    chunk = _row_chunk(npts, width)
    kl = torch.zeros((), dtype=torch.float32, device=y.device)
    for r0 in range(0, npts, chunk):
        r1 = min(r0 + chunk, npts)
        _, _, w = _neighbor_diffs(y, p_idx, r0, r1)
        pn = p_val[r0:r1] / torch.clamp(p_mass, min=1e-12)
        q = torch.clamp(w / torch.clamp(z, min=1e-12), min=1e-38)
        p = torch.clamp(pn, min=1e-38)
        kl = kl + torch.where(valid[r0:r1],
                              pn * (torch.log(p) - torch.log(q)), 0.0).sum()
    return kl


class TsneComputation:
    """Reference: sph/EmbedTsne.hpp:62 TsneComputation — compute /
    continueGradientDescent / stop, with a probability distribution or a kNN
    graph as input."""

    def __init__(self, params: Optional[TsneParameters] = None,
                 device=None):
        self.params = params or TsneParameters()
        self.device = resolve_device(device)
        self._p: Optional[SparseRows] = None
        self._knn = None
        self.tier: Optional[str] = None
        self._n = 0
        self._initial_embedding: Optional[np.ndarray] = None
        self._should_stop = False
        self._initialized = False
        self._iteration = 0

    # ------------------------------------------------------------------

    def set_probability_distribution(self, p: SparseRows):
        """P must already be row-normalized / symmetrized upstream
        (reference: setProbabilityDistribution, EmbedTsne.cpp:294-301)."""
        self._p = p
        self._knn = None
        self._n = p.num_rows
        self._initialized = False

    def set_neighbor_graph(self, indices: np.ndarray, distances: np.ndarray):
        """Compute P from a kNN graph (reference: initProbabilityDistribution
        EmbedTsne.cpp:96-123 — Gaussian rows with the configured
        perplexity)."""
        self._knn = (indices, distances)
        self._p = None
        self._n = indices.shape[0]
        self._initialized = False

    def set_initial_embedding(self, emb: np.ndarray):
        if emb.shape[0] != self._n:
            Log.warn("TsneComputation: initial embedding has wrong size, "
                     "ignoring")
            return
        self._initial_embedding = np.asarray(emb, dtype=np.float32)

    def stop(self):
        self._should_stop = True

    def reset_stop(self):
        self._should_stop = False

    # ------------------------------------------------------------------

    def _ensure_p(self, cap: int = 0) -> Optional[float]:
        """P from the kNN graph, on this computation's device: Gaussian rows
        without the self column, then (P + P^T) / 2 (JAX: _ensure_p), with
        rows wider than `cap` cut to their largest entries as they are
        packed (the JAX package cuts them right after; a hub row's full
        width would otherwise be allocated for every row).  Returns P's mass
        before the cut, or None when P was given and not made here."""
        if self._p is not None:
            return None
        from ..ops.distributions import gaussian_row_distributions
        from ..ops.sparse import symmetrize_tsne
        idx, dist = self._knn
        mask = idx >= 0
        # the reference feeds the graph's distances to the beta search as-is
        # (EmbedTsne.cpp:117: already sqrt'd euclidean)
        p = gaussian_row_distributions(
            torch.as_tensor(np.where(mask, dist, 0.0).astype(np.float32),
                            device=self.device),
            torch.as_tensor(mask, device=self.device),
            self.params.perplexity, ignore_first=True,
            sum_width=idx.shape[1])        # the JAX package pads nothing here
        rows = SparseRows(np.where(mask, idx, -1), p, self._n,
                          device=self.device)
        self._p = symmetrize_tsne(rows, cap if cap > 0 else None)
        return float(p.sum())

    def _init_gradient_descent(self):
        n = self._n
        tier = select_tier(n)
        self.tier = tier
        # the u16-packed neighbour gather: the grid tier's default
        packed = os.environ.get("SPH_TSNE_ATTR_PACKED", "auto")
        self.attr_packed = packed == "1" or (packed != "0" and tier == "grid")
        # bound the padded P width: one hub row otherwise sets the width of
        # every row; keep the largest-probability entries.  0 disables.
        cap = int(os.environ.get("SPH_TSNE_P_WIDTH_CAP", str(P_WIDTH_CAP)))
        mass = self._ensure_p(cap)
        dev = self.device
        p = SparseRows(self._p.idx, self._p.val, self._p.num_cols,
                       device=dev)
        if cap > 0 and p.width > cap:        # a P given directly
            mass = float(p.row_sums().sum())
            p = topk_rows(p, cap)
        if mass is not None and cap > 0 and p.width == cap:
            kept = float(p.row_sums().sum()) / max(mass, 1e-12)
            Log.info("t-SNE: P width capped to %d (%.4f%% of mass kept)",
                     cap, 100.0 * kept)
        self._grid = 0
        self.grid_history: list[tuple[int, int]] = []
        # the grid deposit's buffers and order on a card, once a run
        self._grid_ws = (GridWorkspace(dev) if tier == "grid"
                         and torch.device(dev).type == "cuda" else None)
        if tier == "grid":
            Log.info("t-SNE: grid-interpolated repulsion (N=%d)", n)
            # the attraction's gathers dominate this tier: a harder cap
            gcap = int(os.environ.get("SPH_TSNE_GRID_P_WIDTH",
                                      str(GRID_P_WIDTH)))
            if gcap > 0 and p.width > gcap:
                before = float(p.row_sums().sum())
                p = topk_rows(p, gcap)
                kept = float(p.row_sums().sum()) / max(before, 1e-12)
                Log.info("t-SNE grid tier: P width %d (%.2f%% mass kept)",
                         gcap, 100.0 * kept)
        self.params.exaggeration_factor = default_exaggeration(n)
        Log.info("t-SNE: exaggeration %.2f for %d iters, decay over %d",
                 self.params.exaggeration_factor,
                 self.params.remove_exaggeration_iter,
                 self.params.exponential_decay_iter)

        npad = dense_npad(n) if tier == "dense" else sparse_npad(n)
        self._npad = npad

        if self._initial_embedding is None:
            from ..ops.math import random_disk_init
            self._initial_embedding = random_disk_init(n, 0.1, seed=0)
        y = torch.zeros((npad, 2), dtype=torch.float32, device=dev)
        y[:n] = torch.as_tensor(self._initial_embedding, device=dev)

        # joint-P convention: the whole matrix sums to 1
        total = float(torch.where(p.idx >= 0, p.val, 0.0).sum())
        pv = p.val / max(total, 1e-12)
        w0 = p.width
        self._p_idx = torch.full((npad, w0), -1, dtype=torch.int64,
                                 device=dev)
        self._p_val = torch.zeros((npad, w0), dtype=torch.float32,
                                  device=dev)
        self._p_idx[:n] = p.idx
        self._p_val[:n] = pv
        # the attraction kernel's ids (the JAX package keeps P in int32)
        self._p_idx32 = self._p_idx.to(torch.int32)
        self._p_dense = None
        if tier == "dense":
            live = self._p_idx >= 0
            rows = torch.arange(npad, device=dev)[:, None].expand_as(live)
            self._p_dense = torch.zeros((npad, npad), dtype=torch.float32,
                                        device=dev)
            self._p_dense.index_put_((rows[live], self._p_idx[live]),
                                     self._p_val[live], accumulate=True)
            # the kernel's outputs and workspace, once a run
            self._forces_out = DenseForces(npad, dev)
        self._y = y
        self._vel = torch.zeros_like(y)
        self._gain = torch.ones_like(y)
        self._row_valid = (torch.arange(npad, device=dev) < n)[:, None]
        self._iteration = 0
        self._initialized = True

    def compute(self, iterations: Optional[int] = None, verbose: bool = True):
        """Reference: TsneComputation::compute (EmbedTsne.cpp:267-283)."""
        if self._n == 1:
            self._single_point()
            return
        self._should_stop = False
        if not self._initialized:
            self._init_gradient_descent()
        self.continue_gradient_descent(
            iterations if iterations is not None
            else self.params.num_iterations, verbose)

    def continue_gradient_descent(self, iterations: int,
                                  verbose: bool = True):
        if self._n == 1 or self._should_stop or iterations < 1:
            return
        if not self._initialized:
            self._init_gradient_descent()
        # the grid tier picks its size afresh for each dispatch chunk, at the
        # iterations where the JAX package starts a device program
        chunk = (max(1, DISPATCH_BUDGET // self._npad) if self.tier == "grid"
                 else iterations)
        for start in range(0, iterations, chunk):
            if self.tier == "grid":
                self._grid = self._current_grid()
                self.grid_history.append((self._iteration, self._grid))
            for _ in range(min(chunk, iterations - start)):
                self._step()

    def _current_grid(self) -> int:
        """Grid nodes per dim for the next chunk (JAX: _current_grid): the
        span of the current layout (pad rows included) x 1.3, at least 1,
        with room for growth during the chunk."""
        y = self._y
        span = float((y.amax(0) - y.amin(0)).max())
        max_g = int(os.environ.get("SPH_TSNE_GRID_MAX", str(GRID_MAX)))
        return pick_grid_size(max(span, 1.0) * 1.3, max_g=max_g)

    def _step(self):
        """One iteration (JAX: the body of tsne_iterations, :226-272)."""
        self._update(*self._forces())

    def _forces(self):
        """(attraction, repulsion, Z) at the current layout, on the tier."""
        if self.tier == "dense":
            return tsne_forces_dense(self._y, self._p_dense, self._n,
                                     out=self._forces_out)
        attr = attractive_forces(self._y, self._p_idx32, self._p_val,
                                 packed=self.attr_packed)
        if self.tier == "grid":
            return (attr, *grid_repulsion(self._y, self._n, self._grid,
                                          self._grid_ws))
        return (attr, *tsne_repulsion(self._y, self._n))

    def _update(self, attr: torch.Tensor, rep: torch.Tensor,
                z: torch.Tensor):
        """The gradient step with gains and momentum, pad rows kept at 0
        and the layout re-centred."""
        prm = self.params
        it = float(self._iteration)
        decay = math.exp(-4.6 * max(it - prm.remove_exaggeration_iter, 0.0)
                         / max(prm.exponential_decay_iter, 1.0))
        exag = 1.0 + (prm.exaggeration_factor - 1.0) * (
            1.0 if it < prm.remove_exaggeration_iter else decay)
        momentum = (prm.momentum if it < prm.mom_switching_iter
                    else prm.final_momentum)
        grad = 4.0 * (exag * attr - rep / torch.clamp(z, min=1e-12))
        same_sign = torch.sign(grad) == torch.sign(self._vel)
        gain = torch.where(same_sign, self._gain * 0.8, self._gain + 0.2)
        self._gain = torch.clamp(gain, min=prm.minimum_gain)
        self._vel = momentum * self._vel - prm.eta * self._gain * grad
        y = torch.where(self._row_valid, self._y + self._vel, 0.0)
        # zero-mean each iteration: per-point gains break force symmetry, so
        # without centering the cloud drifts and loses float32 precision
        mean = y.sum(0, keepdim=True) / max(float(self._n), 1.0)
        self._y = torch.where(self._row_valid, y - mean, 0.0)
        self._iteration += 1

    def _single_point(self):
        self._y = torch.zeros((1, 2), dtype=torch.float32, device=self.device)
        self._npad = 1
        self._iteration = 0
        self._initialized = True

    # ------------------------------------------------------------------

    @property
    def embedding(self) -> np.ndarray:
        return self._y[:self._n].cpu().numpy()

    @property
    def current_iteration(self) -> int:
        return self._iteration

    def kl_divergence(self) -> float:
        if self._n <= 1:
            return 0.0
        grid = self._current_grid() if self.tier == "grid" else 0
        return float(tsne_kl_divergence(self._y, self._p_idx, self._p_val,
                                        self._n, grid, self._grid_ws))
