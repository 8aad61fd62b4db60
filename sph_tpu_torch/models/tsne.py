"""t-SNE gradient descent, dense-P tier.

Port of sph_tpu/models/tsne.py (reference: sph/EmbedTsne.cpp — HDILib's
gradient descent with exaggeration factor clamp(4 + N/60000, 4, 20),
:138-139).  Momentum, gains and the exaggeration schedule follow HDILib's
TsneParameters defaults (minimum gain 0.1, eta 200, momentum 0.2 -> 0.8 at
iteration 250, exaggeration removed at 250 with exponential decay over 150).

Whenever N <= 32768 the joint P is densified once to [Npad, Npad] and every
iteration takes one fused pass over it (ops/tsne_kernels.py): the CUDA
kernel for a tensor on the card, its plain twin for one on the CPU.  The
iterations are a Python loop of torch ops on the device.  Larger N needs the
grid-interpolated tier, which is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sparse import SparseRows, topk_rows
from ..ops.tsne_kernels import tsne_forces_dense
from ..utils.logging import Log

DENSE_P_MAX = 32768      # sph_tpu's SPH_TSNE_DENSE_P_MAX default
P_WIDTH_CAP = 1024       # sph_tpu's SPH_TSNE_P_WIDTH_CAP default


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
                       p_val: torch.Tensor, n_valid: int) -> torch.Tensor:
    """KL(P || Q) over P's off-diagonal support: sum p log(p / q), q = w/Z,
    with P renormalized over that support (Q gives i == j no mass)."""
    _, z = repulsive_forces(y, n_valid)
    idx = torch.clamp(p_idx, min=0)
    d0 = y[:, 0:1] - y[:, 0][idx]
    d1 = y[:, 1:2] - y[:, 1][idx]
    w = 1.0 / (1.0 + d0 * d0 + d1 * d1)
    rows = torch.arange(p_idx.shape[0], device=y.device)[:, None]
    valid = (p_idx >= 0) & (p_val > 0) & (p_idx != rows)
    p_mass = torch.where(valid, p_val, 0.0).sum()
    pn = p_val / torch.clamp(p_mass, min=1e-12)
    q = torch.clamp(w / torch.clamp(z, min=1e-12), min=1e-38)
    p = torch.clamp(pn, min=1e-38)
    return torch.where(valid, pn * (torch.log(p) - torch.log(q)), 0.0).sum()


class TsneComputation:
    """Reference: sph/EmbedTsne.hpp:62 TsneComputation — compute /
    continueGradientDescent / stop, with a symmetrized probability
    distribution as input."""

    def __init__(self, params: Optional[TsneParameters] = None,
                 device=None):
        self.params = params or TsneParameters()
        self.device = resolve_device(device)
        self._p: Optional[SparseRows] = None
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
        self._n = p.num_rows
        self._initialized = False

    def set_neighbor_graph(self, indices: np.ndarray, distances: np.ndarray):
        raise NotImplementedError(
            "t-SNE from a kNN graph not ported yet; see ROADMAP")

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

    def _init_gradient_descent(self):
        n = self._n
        if n > DENSE_P_MAX:
            raise NotImplementedError(
                f"t-SNE for N = {n} > {DENSE_P_MAX} needs the grid tier, "
                "not ported yet; see ROADMAP")
        dev = self.device
        p = SparseRows(self._p.idx, self._p.val, self._p.num_cols,
                       device=dev)
        # bound the padded P width: one hub row otherwise sets the width of
        # every row; keep the largest-probability entries
        if p.width > P_WIDTH_CAP:
            before = p.row_sums().sum()
            p = topk_rows(p, P_WIDTH_CAP)
            kept = p.row_sums().sum() / max(before, 1e-12)
            Log.info("t-SNE: P width capped to %d (%.4f%% of mass kept)",
                     P_WIDTH_CAP, 100.0 * kept)
        self.params.exaggeration_factor = default_exaggeration(n)
        Log.info("t-SNE: exaggeration %.2f for %d iters, decay over %d",
                 self.params.exaggeration_factor,
                 self.params.remove_exaggeration_iter,
                 self.params.exponential_decay_iter)

        npad = dense_npad(n)
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
        live = self._p_idx >= 0
        rows = torch.arange(npad, device=dev)[:, None].expand_as(live)
        self._p_dense = torch.zeros((npad, npad), dtype=torch.float32,
                                    device=dev)
        self._p_dense.index_put_((rows[live], self._p_idx[live]),
                                 self._p_val[live], accumulate=True)
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
        for _ in range(iterations):
            self._step()

    def _step(self):
        """One iteration (JAX: the body of tsne_iterations, :226-272)."""
        prm = self.params
        it = float(self._iteration)
        decay = math.exp(-4.6 * max(it - prm.remove_exaggeration_iter, 0.0)
                         / max(prm.exponential_decay_iter, 1.0))
        exag = 1.0 + (prm.exaggeration_factor - 1.0) * (
            1.0 if it < prm.remove_exaggeration_iter else decay)
        momentum = (prm.momentum if it < prm.mom_switching_iter
                    else prm.final_momentum)

        attr, rep, z = tsne_forces_dense(self._y, self._p_dense, self._n)
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
        return float(tsne_kl_divergence(self._y, self._p_idx, self._p_val,
                                        self._n))
