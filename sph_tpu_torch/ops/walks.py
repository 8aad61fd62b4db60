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

import math

import numpy as np
import torch

from ..settings import ImportanceWeighting, RandomWalkSettings
from ..utils.logging import Log
from . import rng
from .distributions import bucket_width
from .numerics import _f32, _fma, cumsum, exp, exp_unfused, row_sum
from .walk_sort import xla_sort_order
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
    """Per-step visit weights of the schemes whose weights are small
    integers (CONSTANT, ONLYLAST, FIRST_VISIT): exact in any arithmetic.
    LINEAR and NORMAL take ``xla_step_weights``."""
    s = torch.arange(steps, dtype=torch.float32, device=device)
    if weighting == "constant":
        return torch.ones(steps, dtype=torch.float32, device=device)
    if weighting == "onlylast":
        return torch.where(s == steps - 1, 1.0, 0.0)
    if weighting == "first_visit":
        return s + 1.0
    raise ValueError(f"_step_weights: {weighting!r} takes xla_step_weights")


def _vector_part(n: int, unrolled_max: int) -> int:
    """How many of a fused loop's `n` elements XLA-CPU computes at run time
    in its 32-wide vector body (four 8-lane vectors): none when the loop has
    at most `unrolled_max` such iterations (LLVM unrolls it and folds every
    element at compile time), else the whole iterations; the remainder is
    folded."""
    blocks = n // 32
    return 0 if blocks <= unrolled_max else 32 * blocks


def xla_step_weights(weighting: str, walk_length: int, steps: int,
                     num_walks: int) -> torch.Tensor:
    """The LINEAR or NORMAL visit weight of each slot of a start point's
    visit list [num_walks * steps] (slot w * steps + t is walk w's step t),
    as the JAX package's ``_accumulate`` computes them on XLA-CPU (CPU
    tensor, float32).

    ``step_w`` depends on constants only, so XLA's CPU backend compiles it
    into loops that LLVM partly evaluates at compile time, and a weight's
    last bits depend on which part of the loop computes it.  Code that runs
    contracts a multiply and an add into one fused multiply-add; a constant
    that LLVM folds rounds each operation on its own.

    LINEAR: ``1 - s / L`` is fused into the loop that broadcasts the
    weights over the [C, num_walks * steps] visit lists, with the division
    by the constant L made a multiply by f32(1/L).  Along a list of
    n = num_walks * steps slots, the 32-wide vector iterations run
    (``fma(-s, 1/L, 1)``), unless there are at most 10 of them, and the
    remainder is folded (``1 - s * (1/L)``, two roundings).  With exactly 7
    vector iterations, an 8-wide vector epilogue runs too.

    NORMAL: ``exp(-0.5 * (s * 3 / L)^2)`` is its own [steps] loop,
    simplified by XLA to ``exp((s * c1) * (s * c2))`` with c2 =
    f32(3 * f32(1/L)) and c1 = -c2 / 2.  Up to 38 steps LLVM unrolls the
    loop and folds ``exp`` itself in double precision (the C library's
    exp, rounded to float32).  Longer loops are vectorised first: from
    288 steps (9 vector iterations) the 32-wide iterations run (XLA's exp
    polynomial with fused multiply-adds, ``numerics.exp``); the 32-wide
    iterations that do not run and the 4-wide epilogue up to 4 * (steps //
    4) are folded through the same polynomial, each operation rounded
    (``numerics.exp_unfused``); the last steps are folded as scalars in
    double precision.

    Held against ``_accumulate`` itself, every step of L = 1 to 100 and
    lengths up to 350, by tests/test_torch_walk_sort.py."""
    s = torch.arange(steps, dtype=torch.float32)
    inv_len = _f32(1.0 / walk_length)
    if weighting == "linear":
        n = num_walks * steps
        s_row = s.repeat(num_walks)
        runs = _vector_part(n, 10)
        if n // 32 == 7:
            runs = 8 * (n // 8)
        out = 1.0 - s_row * inv_len
        out[:runs] = _fma(-s_row[:runs], inv_len, 1.0)
        return out
    if weighting != "normal":
        raise ValueError(f"xla_step_weights: no folded form for "
                         f"{weighting!r}")
    c2 = _f32(_f32(3.0) * inv_len)
    arg = (s * _f32(-0.5 * c2)) * (s * c2)
    out = torch.tensor([math.exp(a) for a in arg.tolist()],
                       dtype=torch.float64).float()
    if steps > 38:
        runs = _vector_part(steps, 8)
        folded = 4 * (steps // 4)
        out[runs:folded] = exp_unfused(arg[runs:folded])
        out[:runs] = exp(arg[:runs])
    return out.repeat(num_walks)


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

    # per-start-point sample lists [C, W*L]
    def per_start(x):
        return x.reshape(steps, c, w).permute(1, 2, 0).reshape(c, w * steps)

    ids = per_start(visited)
    cts_s = None
    if weighting in ("linear", "normal"):
        # the JAX package's unstable sort, in XLA-CPU's order; every slot
        # carries the weight XLA computed for it
        row_w = xla_step_weights(weighting, walk_length, steps, w).to(dev)
        order, ids_s = xla_sort_order(ids)
        ids_s = ids_s.to(ids.dtype)
        wts_s = row_w[order]
    else:
        # weights and counts are small integers: every run sum is exact,
        # so any order of equal ids gives the JAX package's sums
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
            counts = None
        ids_s, order = torch.sort(ids, dim=1, stable=True)
        wts_s = per_start(weights).gather(1, order)
        if counts is not None:
            cts_s = per_start(counts).gather(1, order)

    new_run = torch.ones_like(ids_s, dtype=torch.bool)
    new_run[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    run_end = torch.ones_like(new_run)
    run_end[:, :-1] = new_run[:, 1:]
    sum_w = _run_totals(wts_s, new_run)
    valid_run = run_end

    if weighting == "first_visit":
        sum_c = _run_totals(cts_s, new_run)
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

