"""UMAP gradient descent: the dense and rows tiers.

Port of sph_tpu/models/umap.py (reference: sph/EmbedUmap.cpp — umappp's
fuzzy union, spectral init with a random fallback (:192-202), find_ab,
choose_num_epochs and similarities_to_epochs (:204-221), then one
optimisation epoch after another (:233-269)).

The JAX package replaces umappp's sequential per-edge SGD by batched
epochs: every epoch updates all edges due in it at once, with
epochs-per-sample scheduling kept per edge.  Its three tiers are here:

- dense (N <= SPH_UMAP_DENSE_MAX, 4096): the schedule on an [N, N] grid;
  the negative samples are replaced by their expectation over all points,
  so the tier is deterministic;
- rows: each row sums its own updates over its neighbour slots (the fuzzy
  union is symmetric, so an edge's tail update is its mirror's head
  update), rows cut to their SPH_UMAP_ROWS_WIDTH (128) strongest edges,
  and SPH_UMAP_NEG_BUDGET (64) uniform negatives a row standing for the
  row's active slots x negative_sample_rate draws.  The negatives are
  jax.random.randint(fold_in(key, epoch), (rows, draws), 0, n) drawn with
  ops/rng.py, bit for bit.

- edges (SPH_UMAP_EDGE_PATH=1, or ``init_optimization(edge_path=True)``):
  the flat list of the memberships' directed edges; each epoch moves both
  ends of every due edge, then draws negative_sample_rate rounds of one
  negative an edge, jax.random.randint(fold_in(fold_in(key, epoch), r), (E,),
  0, n), each round reading the positions the previous one left.  The JAX
  package scatters with ``.at[src].add``, which XLA-CPU adds one update
  after another in edge order; ``index_add_`` on the card adds atomically,
  in no fixed order.  So the updates are gathered into a [N, W] layout of
  each point's edges in edge order (a stable sort by target, once): the
  CPU folds them onto the point column by column, XLA-CPU's sequence of
  float32 adds; the card sums each row in a fixed order and adds the sum.
  Two runs give the same bits on either.  The sharded UMAP
  (parallel/sharded.py) runs on this tier.

The rows tier reads the neighbours' and the negatives' positions from a
u16 fixed-point table of the layout (ops/packing.py), packed again after
the attraction, as the JAX package's default does (SPH_UMAP_PACKED, read
at each run_for_epochs call; "0" gathers float32).  The JAX package packs
its layout padded with rows of 0 to a power of two (at least 64), so the
table's bounding box takes in 0 exactly when that padding has rows.  The
dense and edge tiers gather float32, as in the JAX package.

The JAX package runs its epochs in fixed-length device programs whose
epochs past the end are masked to no-ops (alpha 0, the schedule held);
the keys and the schedule follow the absolute epoch.  So the port runs the
live epochs one by one and gets the same epochs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import rng
from ..ops.numerics import _fma, fused_row_sum, pow, row_sum
from ..ops.packing import pack_positions, unpack_positions
from ..ops.sparse import SparseRows, symmetrize_umap
from ..utils.logging import Log

DENSE_MAX = 4096          # SPH_UMAP_DENSE_MAX
ROWS_WIDTH = 128          # SPH_UMAP_ROWS_WIDTH
NEG_BUDGET = 64           # SPH_UMAP_NEG_BUDGET


@dataclass
class UmapParameters:
    """Reference: EmbedUmap.hpp:17-23 + umappp::Options defaults."""

    num_epochs: int = 500
    output_dims: int = 2
    min_dist: float = 0.1
    spread: float = 1.0
    negative_sample_rate: int = 5
    initial_alpha: float = 1.0
    seed: int = 123456
    preset_embedding: bool = False


def find_ab(spread: float = 1.0, min_dist: float = 0.1) -> tuple[float, float]:
    """Fit the 1/(1 + a d^{2b}) curve to the target exp decay (reference:
    umappp::find_ab / umap-learn find_ab_params)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros_like(xv)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def choose_num_epochs(requested: int, n: int) -> int:
    """Reference: umappp::choose_num_epochs — requested if >= 0, else 500
    for small data, 200 for large."""
    if requested >= 0:
        return requested
    return 500 if n < 10_000 else 200


def make_epochs_per_sample(weights: np.ndarray, n_epochs: int) -> np.ndarray:
    """Reference: umappp similarities_to_epochs / umap-learn
    make_epochs_per_sample: an edge of weight w is sampled every
    w_max / w epochs.  No weights (a level whose memberships were all
    pruned) give no edges, and the layout stays where it starts; the JAX
    package raises there."""
    if weights.size == 0:
        return np.empty(0, dtype=np.float64)
    w_max = weights.max()
    out = np.full(weights.shape, np.inf, dtype=np.float64)
    n_samples = n_epochs * (weights / w_max)
    ok = n_samples > 0
    out[ok] = n_epochs / n_samples[ok]
    return out


def _next_pow2(x: int, lo: int) -> int:
    return 1 << (max(int(x), lo) - 1).bit_length()


def _attract_coeff(d2: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """umap-learn's attractive gradient coefficient (rdist form); the
    powers as XLA-CPU takes them (ops/numerics.pow), and a d^2b + 1 as the
    fused multiply-add its code generator makes of it."""
    return torch.where(d2 > 0, (-2.0 * a * b * pow(d2, b - 1.0))
                       / _fma(a, pow(d2, b), 1.0), 0.0)


def _clip4(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -4.0, 4.0)


def _sq_len(e0: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
    """e0^2 + e1^2 as XLA-CPU's code generator contracts it: the second
    square rounded, the first fused into the add."""
    return _fma(e0, e0, e1 * e1)


def _repel(e0: torch.Tensor, e1: torch.Tensor, a: float, b: float,
           true_division: bool = False):
    """Clipped repulsive updates of umap-learn; a coincident pair
    (e2 == 0) gets the constant +4 push per dimension.  With
    `true_division` the coefficient 2b / den is an IEEE division, as XLA
    computes it (the dense tier, which follows XLA-CPU bit for bit);
    without, torch's form of a number over a tensor, the reciprocal times
    the number, an ulp off at times (the rows and edge tiers, which follow
    it within their tolerances)."""
    e2 = _sq_len(e0, e1)
    den = (0.001 + e2) * _fma(a, pow(e2, b), 1.0)
    gcn = (torch.full_like(den, 2.0 * b) / den if true_division
           else (2.0 * b) / den)
    pos = e2 > 0
    return (torch.where(pos, _clip4(gcn * e0), 4.0),
            torch.where(pos, _clip4(gcn * e1), 4.0))


class FoldLayout:
    """Each point's entries of an edge-length target list, in edge order:
    ``pos`` [N, W] holds the edge ids (E, a zero slot, past a point's
    last), from a stable sort by target.  ``add(base, vals)`` is the
    scatter-add base.at[targets].add(vals): on the CPU as XLA-CPU adds it,
    each point's values one after another in edge order onto the point's
    own value; on the card as one row sum of the gathered [N, W] values in
    a fixed order, added to the point (other bits than the CPU's, the same
    from run to run)."""

    def __init__(self, targets: torch.Tensor, n: int):
        e = targets.numel()
        dev = targets.device
        self.e = e
        if e == 0:
            self.pos = torch.zeros((n, 0), dtype=torch.int64, device=dev)
            return
        sorted_t, order = torch.sort(targets, stable=True)
        first = torch.searchsorted(sorted_t, torch.arange(n, device=dev))
        rank = torch.arange(e, device=dev) - first[sorted_t]
        width = int(rank.max()) + 1
        self.pos = torch.full((n, width), e, dtype=torch.int64, device=dev)
        self.pos[sorted_t, rank] = order

    def add(self, base: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        if self.e == 0:
            return base
        table = torch.cat([vals, vals.new_zeros(1)])[self.pos]
        if base.device.type != "cpu":
            # on the card: one fixed-order row sum (no atomics), then one add
            return base + table.sum(1)
        acc = base
        for j in range(table.shape[1]):
            acc = acc + table[:, j]
        return acc


def edge_attraction(y0, y1, src, dst, active, alpha: float, a: float,
                    b: float):
    """The attractive steps of the edges (src -> dst), 0 where an edge is
    not due: (s0, s1), each [E] (JAX: _epoch_update's first half)."""
    d0 = y0[src] - y0[dst]
    d1 = y1[src] - y1[dst]
    gc = _attract_coeff(_sq_len(d0, d1), a, b)
    amask = torch.where(active, alpha, 0.0)
    return amask * _clip4(gc * d0), amask * _clip4(gc * d1)


def edge_repulsion(y0, y1, src, negs, active, alpha: float, a: float,
                   b: float):
    """The repulsive steps of one negative an edge, 0 where the edge is
    not due or drew its own head: (r0, r1), each [E]."""
    r0, r1 = _repel(y0[src] - y0[negs], y1[src] - y1[negs], a, b)
    nmask = torch.where(active & (negs != src), alpha, 0.0)
    return nmask * r0, nmask * r1


class UmapComputation:
    """Reference: sph/EmbedUmap.hpp:34 UmapComputation."""

    def __init__(self, params: Optional[UmapParameters] = None, device=None):
        self.params = params or UmapParameters()
        self.device = resolve_device(device)
        self._p: Optional[SparseRows] = None
        self._p_device_path = False
        self._graph = None
        self._preset_memberships: Optional[SparseRows] = None
        self._n = 0
        self._embedding: Optional[np.ndarray] = None
        self._preset = False
        self._should_stop = False
        self._initialized = False
        self.tier: Optional[str] = None
        self.n_epochs = 0
        self.current_epoch = 0
        # the symmetrized fuzzy memberships the layout is optimised against
        self.memberships: Optional[SparseRows] = None

    # ------------------------------------------------------------------

    def set_neighbor_matrix(self, p: SparseRows, device_path: bool = False):
        """Similarities computed upstream (reference: setNeighborMatrix);
        combined with the fuzzy union here, on the JAX package's device path
        where `device_path` (``symmetrize_umap``)."""
        self._p, self._graph, self._preset_memberships = p, None, None
        self._p_device_path = device_path
        self._n = p.num_rows
        self._preset = False

    def set_neighbor_graph(self, indices: np.ndarray, distances: np.ndarray):
        """A distance graph (reference: setNeighborGraph): smooth-knn
        similarities are computed here, as umappp::initialize does."""
        self._graph, self._p, self._preset_memberships = (
            (indices, distances), None, None)
        self._n = indices.shape[0]
        self._preset = False

    def set_memberships(self, m: SparseRows):
        """Already-symmetrized fuzzy memberships, used as they are."""
        self._p, self._graph, self._preset_memberships = None, None, m
        self._n = m.num_rows

    def set_initial_embedding(self, emb: np.ndarray):
        if emb.shape[0] != self._n:
            Log.warn("UmapComputation: initial embedding wrong size, "
                     "ignoring")
            return
        self._embedding = np.asarray(emb, np.float32).copy()
        self._preset = True

    def stop(self):
        self._should_stop = True

    # ------------------------------------------------------------------

    def _memberships(self) -> SparseRows:
        if self._preset_memberships is not None:
            return self._preset_memberships
        if self._p is not None:
            # fuzzy union (reference: combine_neighbor_sets with mix 0.5)
            return symmetrize_umap(SparseRows(
                self._p.idx, self._p.val, self._p.num_cols,
                device=self.device), device_path=self._p_device_path)
        from ..ops.distributions import smooth_knn_distributions
        idx, dist = self._graph
        mask = idx >= 0
        mask[:, 0] = False  # self edge
        mask_t = torch.as_tensor(mask, device=self.device)
        sims = smooth_knn_distributions(
            torch.as_tensor(np.asarray(dist, np.float32), device=self.device),
            mask_t)
        return symmetrize_umap(SparseRows(np.where(mask, idx, -1), sims,
                                          self._n, device=self.device))

    def _init_embedding(self, m_idx: np.ndarray, m_val: np.ndarray):
        if self._preset and self._embedding is not None:
            return
        from ..ops.math import spectral_embedding
        # the memberships as padded rows behind a self column
        idx = np.concatenate(
            [np.arange(self._n, dtype=np.int32)[:, None], m_idx], axis=1)
        val = np.concatenate(
            [np.zeros((self._n, 1), np.float32), m_val], axis=1)
        emb, ok = spectral_embedding(idx, val, self.params.output_dims)
        if not ok:
            Log.warn("UmapComputation: spectral init failed, random "
                     "fallback (reference: EmbedUmap.cpp:192-202)")
        noise = np.random.default_rng(self.params.seed).standard_normal(
            emb.shape).astype(np.float32) * 1e-4
        self._embedding = emb + noise

    def init_optimization(self, edge_path: Optional[bool] = None):
        """Memberships, layout and the edge schedule (reference:
        initProbabilityDistribution, :52-231).  edge_path True or False
        pins the edge-list tier on or off; None reads SPH_UMAP_EDGE_PATH,
        as the JAX package does."""
        if edge_path is None:
            edge_path = os.environ.get("SPH_UMAP_EDGE_PATH") == "1"
        m = self.memberships = self._memberships()
        m_idx, m_val = m.indices, m.values
        self._init_embedding(m_idx, m_val)

        self._a, self._b = find_ab(self.params.spread, self.params.min_dist)
        self.n_epochs = choose_num_epochs(self.params.num_epochs, self._n)
        Log.info("UMAP: a=%.4f b=%.4f epochs=%d", self._a, self._b,
                 self.n_epochs)
        mask = (m_idx >= 0) & (m_val > 0)
        if not mask.any():
            Log.warn("UMAP: no memberships among %d points, so the layout "
                     "stays where it starts (the JAX package raises here; "
                     "see ROADMAP)", self._n)
        eps_flat = make_epochs_per_sample(m_val[mask], self.n_epochs
                                          ).astype(np.float32)
        dense_max = int(os.environ.get("SPH_UMAP_DENSE_MAX", str(DENSE_MAX)))
        self.tier = ("edges" if edge_path
                     else "dense" if self._n <= dense_max else "rows")
        Log.info("UMAP: optimizer tier %s (n=%d)", self.tier, self._n)
        n, dev = self._n, self.device

        if self.tier == "edges":
            src = np.broadcast_to(np.arange(n)[:, None], m_idx.shape)[mask]
            self._src = torch.as_tensor(np.ascontiguousarray(src), device=dev)
            self._dst = torch.as_tensor(m_idx[mask].astype(np.int64),
                                        device=dev)
            self._src_fold = FoldLayout(self._src, n)
            self._dst_fold = FoldLayout(self._dst, n)
            eps = eps_flat
        elif self.tier == "dense":
            src = np.broadcast_to(np.arange(n)[:, None], m_idx.shape)[mask]
            eps = np.full((n, n), np.inf, np.float32)
            eps[src, m_idx[mask]] = eps_flat
        else:
            # keep each row's strongest edges: the shed tail has the largest
            # epochs-per-sample, the least often sampled edges
            cap = int(os.environ.get("SPH_UMAP_ROWS_WIDTH", str(ROWS_WIDTH)))
            if 0 < cap < m_idx.shape[1]:
                total = float(m_val[mask].sum())
                vals = np.where(mask, m_val, -np.inf)
                order = np.argsort(-vals, axis=1, kind="stable")[:, :cap]
                rr = np.arange(n)[:, None]
                m_idx = np.where(np.isfinite(vals[rr, order]),
                                 m_idx[rr, order], -1)
                m_val = np.where(m_idx >= 0, m_val[rr, order], 0.0)
                mask = m_idx >= 0
                Log.info("UMAP rows tier: width cap %d -> %d keeps %.2f%% "
                         "of membership mass", vals.shape[1], cap,
                         100.0 * float(m_val.sum()) / max(total, 1e-30))
                eps_flat = make_epochs_per_sample(
                    m_val[mask], self.n_epochs).astype(np.float32)
            # the padded width sets the per-slot draw count, so it follows
            # the JAX package's power-of-two padding
            wpad = _next_pow2(m_idx.shape[1], lo=8)
            eps = np.full((n, wpad), np.inf, np.float32)
            eps[:, :m_idx.shape[1]][mask] = eps_flat
            nbr = np.full((n, wpad), -1, np.int64)
            nbr[:, :m_idx.shape[1]] = np.where(mask, m_idx, -1)
            self._nbr = torch.as_tensor(nbr, device=dev).clamp(min=0)
            budget = int(os.environ.get("SPH_UMAP_NEG_BUDGET",
                                        str(NEG_BUDGET)))
            # a budget at least as large as the per-slot draws is no budget
            self._neg_budget = (
                budget if budget < wpad * self.params.negative_sample_rate
                else 0)
            # the JAX package's layout has zero pad rows up to this count
            self._pads = _next_pow2(n, lo=64) > n
        self._eps = torch.as_tensor(eps, device=dev)
        self._next_sample = self._eps.clone()
        self._y = torch.as_tensor(self._embedding, device=dev)
        self._key = rng.prng_key(self.params.seed)
        self.current_epoch = 0
        self._initialized = True

    def run_for_epochs(self, epochs: int):
        """Incremental optimisation (reference:
        runGradientDescentForEpochs, :271-287)."""
        if not self._initialized:
            self.init_optimization()
        end = min(self.current_epoch + epochs, self.n_epochs)
        self.packed = os.environ.get("SPH_UMAP_PACKED", "1") != "0"
        for epoch in range(self.current_epoch, end):
            if self._should_stop:
                break
            if self.tier == "dense":
                self._dense_epoch(epoch)
            elif self.tier == "edges":
                self._edges_epoch(epoch)
            else:
                self._rows_epoch(epoch)
            self.current_epoch = epoch + 1
        self._embedding = self._y.cpu().numpy()

    def _alpha(self, epoch: int) -> np.float32:
        f32 = np.float32
        return f32(self.params.initial_alpha) * (
            f32(1.0) - f32(epoch) / f32(self.n_epochs))

    def _rows_epoch(self, epoch: int):
        """One epoch of the rows tier (JAX: _run_epochs_rows' body)."""
        a, b = float(np.float32(self._a)), float(np.float32(self._b))
        alpha = float(self._alpha(epoch))
        rate = self.params.negative_sample_rate
        n, w = self._nbr.shape
        active = self._next_sample <= float(epoch)
        y0, y1 = self._y[:, 0], self._y[:, 1]
        n0, n1 = self._gather(y0, y1, self._nbr)
        d0 = y0[:, None] - n0
        d1 = y1[:, None] - n1
        gc = _attract_coeff(_sq_len(d0, d1), a, b)
        # head update of (i, j) plus the tail update of its mirror (j, i);
        # on the CPU in XLA-CPU's arithmetic, so the positions the second
        # gather packs are the JAX package's bit for bit
        att0 = 2.0 * fused_row_sum(torch.where(active, _clip4(gc * d0),
                                                0.0))
        att1 = 2.0 * fused_row_sum(torch.where(active, _clip4(gc * d1),
                                                0.0))
        y0m = _fma(alpha, att0, y0)
        y1m = _fma(alpha, att1, y1)

        draws = self._neg_budget or w * rate
        negs = rng.randint(rng.fold_in(self._key, epoch), (n, draws), 0, n,
                           self._y.device)
        g0, g1 = self._gather(y0m, y1m, negs)
        r0, r1 = _repel(y0m[:, None] - g0, y1m[:, None] - g1, a, b)
        rows = torch.arange(n, device=self._y.device)[:, None]
        if self._neg_budget:
            # a self draw adds nothing but counts as a draw
            notself = negs != rows
            scale = active.sum(1).to(torch.float32) * rate / float(draws)
            rep0 = scale * torch.where(notself, r0, 0.0).sum(1)
            rep1 = scale * torch.where(notself, r1, 0.0).sum(1)
        else:
            keep = (torch.repeat_interleave(active, rate, dim=1)
                    & (negs != rows))
            rep0 = torch.where(keep, r0, 0.0).sum(1)
            rep1 = torch.where(keep, r1, 0.0).sum(1)
        self._y = torch.stack([y0m + alpha * rep0, y1m + alpha * rep1], 1)
        self._next_sample = torch.where(active, self._next_sample + self._eps,
                                        self._next_sample)

    def _gather(self, y0: torch.Tensor, y1: torch.Tensor, ids: torch.Tensor):
        """Both coordinates at `ids` for the rows tier: from a u16 table of
        (y0, y1) when packed (JAX: _pack_positions, _unpack_positions),
        else in float32."""
        if not self.packed:
            return y0[ids], y1[ids]
        table, prm = pack_positions(y0, y1, with_zero=self._pads)
        return unpack_positions(table[ids], prm)

    def _edges_epoch(self, epoch: int):
        """One epoch of the edge-list tier (JAX: _epoch_update)."""
        a, b = float(np.float32(self._a)), float(np.float32(self._b))
        alpha = float(self._alpha(epoch))
        src, dst = self._src, self._dst
        active = self._next_sample <= float(epoch)
        y0, y1 = self._y[:, 0], self._y[:, 1]
        s0, s1 = edge_attraction(y0, y1, src, dst, active, alpha, a, b)
        y0 = self._dst_fold.add(self._src_fold.add(y0, s0), -s0)
        y1 = self._dst_fold.add(self._src_fold.add(y1, s1), -s1)
        key = rng.fold_in(self._key, epoch)
        for r in range(self.params.negative_sample_rate):
            negs = rng.randint(rng.fold_in(key, r), (src.numel(),), 0,
                               self._n, self._y.device)
            r0, r1 = edge_repulsion(y0, y1, src, negs, active, alpha, a, b)
            y0 = self._src_fold.add(y0, r0)
            y1 = self._src_fold.add(y1, r1)
        self._y = torch.stack([y0, y1], 1)
        self._next_sample = torch.where(active, self._next_sample + self._eps,
                                        self._next_sample)

    def _dense_epoch(self, epoch: int):
        """One epoch of the dense tier (JAX: _run_epochs_dense' body): the
        negatives' expectation over every other point, scaled by the row's
        draw count c = active edges x negative_sample_rate over N.  As
        XLA-CPU computes it: squared lengths and the position updates as
        fused multiply-adds, and the row sums over the JAX package's
        power-of-two padded width (its pad columns add 0)."""
        a, b = float(np.float32(self._a)), float(np.float32(self._b))
        alpha = float(self._alpha(epoch))
        n = self._n
        width = _next_pow2(n, lo=64)
        active = self._next_sample <= float(epoch)
        y0, y1 = self._y[:, 0], self._y[:, 1]
        d0 = y0[:, None] - y0[None, :]
        d1 = y1[:, None] - y1[None, :]
        gc = _attract_coeff(_sq_len(d0, d1), a, b)
        att0 = 2.0 * row_sum(torch.where(active, _clip4(gc * d0), 0.0), width)
        att1 = 2.0 * row_sum(torch.where(active, _clip4(gc * d1), 0.0), width)
        y0m = _fma(alpha, att0, y0)
        y1m = _fma(alpha, att1, y1)
        r0, r1 = _repel(y0m[:, None] - y0m[None, :],
                        y1m[:, None] - y1m[None, :], a, b,
                        true_division=True)
        notself = ~torch.eye(n, dtype=torch.bool, device=self._y.device)
        scale = (active.sum(1).to(torch.float32)
                 * self.params.negative_sample_rate / float(max(n, 1)))
        rep0 = scale * row_sum(torch.where(notself, r0, 0.0), width)
        rep1 = scale * row_sum(torch.where(notself, r1, 0.0), width)
        self._y = torch.stack([_fma(alpha, rep0, y0m),
                               _fma(alpha, rep1, y1m)], 1)
        self._next_sample = torch.where(active, self._next_sample + self._eps,
                                        self._next_sample)

    def compute(self):
        """Reference: UmapComputation::compute (:289-300)."""
        if self._n == 1:
            self._embedding = np.zeros((1, 2), np.float32)
            return
        self._should_stop = False
        self._initialized = False
        self.init_optimization()
        self.run_for_epochs(self.n_epochs)

    # ------------------------------------------------------------------

    @property
    def embedding(self) -> np.ndarray:
        return self._embedding
