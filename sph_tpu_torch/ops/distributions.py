"""Distance -> probability kernels (the Gaussian / t-SNE scheme).

Port of sph_tpu/ops/distributions.py (reference: sph/utils/GraphNormalization
.cpp — Gaussian rows with the perplexity beta search and tiny-sigma
fallbacks, :38-338; the search itself is HDILibHelper.hpp:23-109).

The per-row binary search runs on all rows at once, one [N, K] step per
iteration, until every row has met the entropy tolerance or stopped moving
(the float32 fix-point exit), or 200 iterations pass.

Row layout: ``values [N, K]`` with a parallel ``mask [N, K]`` (True = valid
entry), both tensors on one device.  ``ignore_first=True`` excludes column 0
(the self edge).  The UMAP and LINEAR schemes are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..settings import NormalizationScheme
from .numerics import (_f32, exp, flush_subnormals as _ftz, log, row_sum,
                       sqrt)

_MIN_SIGMA = 0.001     # reference: GraphNormalization.cpp:96,249
_MIN_VAL = 1.0e-10     # values below are dropped (GraphNormalization.cpp:133)
_F32_MAX = float(np.finfo(np.float32).max)


def gaussian_row_distributions(values: torch.Tensor, mask: torch.Tensor,
                               perplexity: float,
                               ignore_first: bool = True,
                               max_iter: int = 200,
                               tol: float = 1e-6) -> torch.Tensor:
    """Per-row Gaussian kernel with fixed perplexity.

    perplexity <= 0 means "use row_size / 3" (GraphNormalization.cpp:75-79;
    row_size excludes the ignored column).  Returns probabilities [N, K]
    with each valid row summing to 1 (ignored / masked columns are 0): the
    HDILib search (beta = 1 start, doubling/halving until bracketed, then
    bisection, entropy tolerance 1e-6), uniform rows where it does not
    converge, and the tiny-sigma fallback chain (copy distances ->
    unit-normalize -> invert -> renormalize).  As in the JAX package, the
    self slot of an all-zero row stays 0 so every returned row sums to 1.
    """
    n, k = values.shape
    dev = values.device
    # the JAX package runs this on rows padded to a power-of-two width of
    # at least 32; summing over that width keeps its float32 association
    wpad = max(32, 1 << (k - 1).bit_length())
    eff_mask = mask.clone()
    if ignore_first and k > 0:
        eff_mask[:, 0] = False

    row_sizes = eff_mask.sum(1).to(torch.float32)
    perp = torch.full((n,), float(perplexity), dtype=torch.float32,
                      device=dev)
    # XLA compiles the JAX package's `row_sizes / 3.0` as a multiply by
    # float32(1/3); so does this
    perp = torch.where(perp > 0, perp,
                       torch.clamp(row_sizes * _f32(1.0 / 3.0), min=1.0))
    log_perp = log(perp)
    vals = torch.where(eff_mask, values, 0.0).to(torch.float32)

    beta = torch.ones(n, dtype=torch.float32, device=dev)
    lo = torch.full((n,), -_F32_MAX, dtype=torch.float32, device=dev)
    hi = torch.full((n,), _F32_MAX, dtype=torch.float32, device=dev)
    # empty / single-entry rows can never meet the tolerance: done up front
    found = row_sizes <= 1
    done = found.clone()
    it = 0
    while it < max_iter and not bool(done.all()):
        # the JAX package adds 1e-38 here, a subnormal that flushes to 0
        p = torch.where(eff_mask, _ftz(exp(-beta[:, None] * vals)),
                        0.0)
        s = row_sum(p, wpad)
        h = _ftz(_ftz(row_sum(_ftz(p * vals), wpad) * beta) / s) + log(s)
        hdiff = h - log_perp
        new_found = found | (torch.abs(hdiff) < tol)

        go_up = hdiff > 0
        new_lo = torch.where(go_up, beta, lo)
        new_hi = torch.where(go_up, hi, beta)
        beta_up = torch.where(torch.abs(hi) >= _F32_MAX, beta * 2.0,
                              (beta + hi) / 2.0)
        beta_dn = torch.where(torch.abs(lo) >= _F32_MAX, beta / 2.0,
                              (beta + lo) / 2.0)
        new_beta = torch.where(go_up, beta_up, beta_dn)
        # f32 fix-point: an unchanged (beta, lo, hi) can never change again,
        # so the row stops without being marked converged
        pinned = (new_beta == beta) & (new_lo == lo) & (new_hi == hi)
        new_done = done | new_found | pinned
        freeze = new_found | done
        beta = torch.where(freeze, beta, new_beta)
        lo = torch.where(freeze, lo, new_lo)
        hi = torch.where(freeze, hi, new_hi)
        found, done = new_found, new_done
        it += 1
    found = found & (row_sizes > 1)

    p = torch.where(eff_mask, _ftz(exp(-beta[:, None] * vals)), 0.0)
    s = row_sum(p, wpad)
    prob = torch.where(s[:, None] > 0, _ftz(p / s[:, None]), 0.0)

    # not found -> uniform over valid entries (HDILibHelper.hpp:98-104)
    uniform = torch.where(
        eff_mask, 1.0 / torch.clamp(row_sizes, min=1.0)[:, None], 0.0)
    prob = torch.where(found[:, None], prob, uniform)

    sigma = torch.where(found, sqrt(_ftz(1.0 / (2.0 * beta))), 0.0)

    # tiny-sigma fallback chain (GraphNormalization.cpp:96-130)
    degenerate = sigma < _MIN_SIGMA
    dsum = row_sum(vals, wpad)
    all_zero = dsum == 0.0
    fb = torch.where(eff_mask, vals / torch.clamp(dsum, min=1e-38)[:, None],
                     0.0)
    fb = torch.where(eff_mask, 1.0 - fb, 0.0)
    fb_sum = row_sum(fb, wpad)
    fb_zero = fb_sum == 0.0
    fb = torch.where(eff_mask, fb / torch.clamp(fb_sum, min=1e-38)[:, None],
                     0.0)
    fallback = torch.where((all_zero | fb_zero)[:, None], uniform, fb)
    prob = torch.where(degenerate[:, None], fallback, prob)

    # drop numerically-zero entries (GraphNormalization.cpp minVal 1e-10)
    prob = torch.where(prob < _MIN_VAL, 0.0, prob)

    # a row with a single valid entry gives it probability 1
    single = (row_sizes <= 1) & (row_sizes > 0)
    return torch.where(single[:, None] & eff_mask, 1.0, prob)


def distance_rows_to_probabilities(values: torch.Tensor, mask: torch.Tensor,
                                   scheme: NormalizationScheme,
                                   perplexity: float = -1.0,
                                   ignore_first: bool = True
                                   ) -> torch.Tensor:
    """The distance-rows -> probability-rows dispatcher (reference:
    normalizeKnnDistances, GraphNormalization.hpp:36-53)."""
    if scheme != NormalizationScheme.TSNE:
        raise NotImplementedError(
            f"normalization {scheme.value} not ported yet; see ROADMAP")
    return gaussian_row_distributions(values, mask, perplexity,
                                      ignore_first=ignore_first)


def normalize_knn_distances(distances: np.ndarray,
                            scheme: NormalizationScheme,
                            perplexity: float = -1.0,
                            device=None) -> np.ndarray:
    """Dispatcher over a fixed-k kNN graph's distance rows.  Column 0 is the
    self edge and is excluded; returns [N, K] probabilities with column 0 ==
    0."""
    d = torch.as_tensor(np.asarray(distances, np.float32),
                        device=resolve_device(device))
    if scheme == NormalizationScheme.NONE:
        p = d.clone()
        p[:, 0] = 0.0
    else:
        p = distance_rows_to_probabilities(
            d, torch.ones_like(d, dtype=torch.bool), scheme, perplexity)
    return p.cpu().numpy()
