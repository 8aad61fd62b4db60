"""Random-walk engine.

Port of sph_tpu/ops/walks.py (reference: sph/utils/SparseMatrixAlgorithms.cpp
doRandomWalks :34-290): per point, `num_random_walks` walks of
`single_walk_length` steps, each step sampling the next node by inverse CDF
over the similarity row in ascending column order; importance weighting,
pruning, diagonal removal and row normalization follow.

All C * W walkers advance together, one step at a time.  Each step draws the
JAX package's uniforms bit for bit (ops/rng.py) and counts ``cum <= u`` over
the row's float32 cumulative sum.  That cumulative sum is taken with the
same association as XLA's CPU lowering of ``jnp.cumsum`` (ops/numerics.py),
so on equal inputs the CPU walks visit the same nodes as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..settings import ImportanceWeighting, RandomWalkSettings
from ..utils.logging import Log
from . import rng
from .distributions import bucket_width
from .numerics import _f32, _fma, cumsum, exp, row_sum
from .sparse import PAD, SparseRows, compact, shrink_width


def step_linear(step, walk_length):
    """Reference: SparseMatrixAlgorithms.hpp:60-61."""
    return 1.0 - step / walk_length


def step_normal(step, walk_length):
    """Reference: SparseMatrixAlgorithms.hpp:64-70 (3 sigma over the walk)."""
    x = step * 3.0 / walk_length
    return np.exp(-0.5 * x * x)


def derive_prune_value(settings: RandomWalkSettings) -> float:
    """Reference: doRandomWalks prune-steps logic (:41-62)."""
    prune_value = settings.prune_value
    if settings.prune_steps > 0:
        length = settings.single_walk_length
        prune_step = min(length - 1, settings.prune_steps)
        prune_step_inv = length - prune_step
        iw = settings.importance_weighting
        if iw == ImportanceWeighting.LINEAR:
            prune_value = step_linear(prune_step_inv, length)
        elif iw == ImportanceWeighting.NORMAL:
            prune_value = step_normal(prune_step_inv, length)
        elif iw == ImportanceWeighting.CONSTANT:
            prune_value = float(prune_step_inv)
        elif iw == ImportanceWeighting.FIRST_VISIT:
            prune_value = float(prune_step) / length
        if prune_value > 0.5:
            Log.warn("doRandomWalks: derived prune value %.3f clamped to 0.5",
                     prune_value)
            prune_value = 0.5
    return float(prune_value)


def simulate(indices: torch.Tensor, values: torch.Tensor, seed: int,
             num_walks: int, walk_length: int) -> torch.Tensor:
    """Advance all walkers; returns visited nodes [walk_length, C * W].

    u ~ U(0,1); next = first column j (in ascending index order) with
    u < cumsum(row)[j]; if none, stay.  The walker axis is chunked so the
    [walkers, R] row gathers stay near 2^26 entries; every step still draws
    its uniforms for all walkers at once, so chunking does not change them.
    """
    c, r = indices.shape
    dev = indices.device
    cum = cumsum(torch.where(indices >= 0, values, 0.0))
    total = c * num_walks
    nodes = torch.arange(c, device=dev).repeat_interleave(num_walks)
    key = rng.prng_key(seed)
    chunk = min(total, max(8192, (1 << 26) // max(r, 1)))
    visited = torch.empty((walk_length, total), dtype=torch.int64,
                          device=dev)
    for t in range(walk_length):
        u = rng.uniform(rng.fold_in(key, t), total, dev)
        nxt = torch.empty_like(nodes)
        for i0 in range(0, total, chunk):
            nc = nodes[i0:i0 + chunk]
            pos = (cum[nc] <= u[i0:i0 + chunk, None]).sum(1)
            cand = indices[nc].gather(1, pos.clamp(max=r - 1)[:, None])[:, 0]
            nxt[i0:i0 + chunk] = torch.where((pos < r) & (cand >= 0), cand,
                                             nc)
        nodes = nxt
        visited[t] = nodes
    return visited


def _step_weights(weighting: str, walk_length: int, steps: int,
                  device) -> torch.Tensor:
    """Per-step visit weights.  XLA compiles the JAX package's division by
    the (constant) walk length as a multiply by its float32 reciprocal, and
    so does this."""
    s = torch.arange(steps, dtype=torch.float32, device=device)
    inv_len = _f32(1.0 / walk_length)
    if weighting == "constant":
        return torch.ones(steps, dtype=torch.float32, device=device)
    if weighting == "linear":
        return 1.0 - s * inv_len
    if weighting == "normal":
        x = s * 3.0 * inv_len
        return exp(-0.5 * x * x)
    if weighting == "onlylast":
        return torch.where(s == steps - 1, 1.0, 0.0)
    return s + 1.0   # first_visit


def _run_totals(x: torch.Tensor, new_run: torch.Tensor) -> torch.Tensor:
    """Per-run sums of x (x >= 0), read at each run's end: the row's running
    sum minus the running sum before the run, as the JAX package forms
    them."""
    cum = cumsum(x)
    base = torch.where(new_run, cum - x, -torch.inf)
    return cum - torch.cummax(base, dim=1).values


def accumulate(visited: torch.Tensor, num_walks: int, walk_length: int,
               weighting: str, out_width: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Turn the visit record [L, C*W] into weighted per-start-point rows
    (indices [C, out_width], values [C, out_width]): unique columns per row,
    summed per the weighting scheme.  FIRST_VISIT averages the step of each
    walk's first visit and inverts it (reference: :151-201)."""
    steps, cw = visited.shape
    w = num_walks
    c = cw // w
    dev = visited.device
    step_w = _step_weights(weighting, walk_length, steps, dev)

    if weighting == "first_visit":
        start = torch.arange(c, device=dev).repeat_interleave(w)
        sorted_v, order = torch.sort(visited, dim=0, stable=True)
        new_run = torch.ones_like(sorted_v, dtype=torch.bool)
        new_run[1:] = sorted_v[1:] != sorted_v[:-1]
        first_sorted = new_run & (sorted_v != start[None, :])
        first_mask = torch.zeros_like(first_sorted).scatter_(
            0, order, first_sorted)
        weights = torch.where(first_mask, step_w[:, None], 0.0)
        counts = first_mask.to(torch.float32)
    else:
        weights = step_w[:, None].expand(steps, cw)
        counts = torch.ones((steps, cw), dtype=torch.float32, device=dev)

    # per-start-point sample lists [C, W*L]
    def per_start(x):
        return x.reshape(steps, c, w).permute(1, 2, 0).reshape(c, w * steps)

    ids = per_start(visited)
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    wts_s = per_start(weights).gather(1, order)
    cts_s = per_start(counts).gather(1, order)

    new_run = torch.ones_like(ids_s, dtype=torch.bool)
    new_run[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    run_end = torch.ones_like(new_run)
    run_end[:, :-1] = new_run[:, 1:]
    sum_w = _run_totals(wts_s, new_run)
    sum_c = _run_totals(cts_s, new_run)
    valid_run = run_end

    if weighting == "first_visit":
        avg = torch.where(sum_c > 0, sum_w / torch.clamp(sum_c, min=1.0), 0.0)
        # XLA fuses m * avg + b into one multiply-add; so does this
        m = _f32(-1.0 / (walk_length - 1.0))
        b = _f32(walk_length / (walk_length - 1.0))
        val = torch.clamp(_fma(avg, m, b), min=0.0)
        valid_run = valid_run & (sum_c > 0)
    else:
        val = sum_w

    val = torch.where(valid_run, val, 0.0)
    run_ids = torch.where(valid_run & (val > 0), ids_s, PAD)
    if out_width < w * steps:
        # largest values first, ties to the lower column
        neg_v, top = torch.sort(-val, dim=1, stable=True)
        return run_ids.gather(1, top[:, :out_width]), -neg_v[:, :out_width]
    return run_ids, val


def postprocess(idx: torch.Tensor, val: torch.Tensor, prune_value: float,
                do_remove_diagonal: bool, do_normalize: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prune <= prune_value, remove the diagonal (keeping single-entry rows),
    sort by column id with pads last, row-normalize."""
    c = idx.shape[0]
    valid = (idx >= 0) & (val > 0) & (val > prune_value)
    if do_remove_diagonal:
        rows = torch.arange(c, device=idx.device)[:, None]
        diag = valid & (idx == rows)
        nnz = valid.sum(1, keepdim=True)
        valid = valid & (~diag | (nnz <= 1))
    out = compact(torch.where(valid, idx, PAD), torch.where(valid, val, 0.0),
                  c)
    idx_s, val_s = out.idx, out.val
    if do_normalize:
        s = row_sum(val_s)[:, None]
        val_s = torch.where(s > 0, val_s / torch.clamp(s, min=1e-38), 0.0)
    return idx_s, val_s


def out_width(num_rows: int, settings: RandomWalkSettings) -> int:
    """Slots a walk row is accumulated into: max_row_nnz, else the walks'
    visits capped at 2048, and never more than the rows."""
    w, length = int(settings.num_random_walks), int(settings.single_walk_length)
    cap = settings.max_row_nnz or min(w * length, 2048)
    return min(cap, w * length, num_rows)


def stored_width(need: int, num_rows: int, settings: RandomWalkSettings
                 ) -> int:
    """The width the JAX package stores walk rows at: the widest live row
    (`need`) rounded up to its power-of-two bucket, within ``out_width``.
    The port stores `need`; sums that the JAX package takes over its
    stored width use this to place their zero padding."""
    return min(bucket_width(need), out_width(num_rows, settings))


def do_random_walks(similarities: SparseRows,
                    settings: RandomWalkSettings,
                    verbose: bool = False) -> SparseRows:
    """Full doRandomWalks semantics (reference:
    SparseMatrixAlgorithms.cpp:34-290): simulate, weight, prune, remove
    diagonal (keeping single-entry rows), row-normalize, all on the rows'
    device; the stored width shrinks to the widest surviving row."""
    c = similarities.num_rows
    w = int(settings.num_random_walks)
    length = int(settings.single_walk_length)
    Log.info("Random walks: %d walks with %d steps each using %s weighting",
             w, length, settings.importance_weighting.value)
    prune_value = derive_prune_value(settings)
    if prune_value > 0:
        Log.info("Random walks: pruning all values below %s", prune_value)

    visited = simulate(similarities.idx, similarities.val,
                       int(settings.random_seed), w, length)
    idx, val = accumulate(visited, w, length,
                          settings.importance_weighting.value,
                          out_width(c, settings))
    idx, val = postprocess(idx, val, prune_value, settings.remove_diagonal,
                           settings.normalize)
    rows = SparseRows(idx, val, c)
    nnz_rows = rows.row_nnz()
    empty = int((nnz_rows == 0).sum())
    if empty:
        Log.warn("doRandomWalks: %d rows have no effective entries", empty)
    return shrink_width(rows, int(nnz_rows.max()) if nnz_rows.size else 1)

