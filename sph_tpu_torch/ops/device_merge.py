"""The sparse merges and the kNN-graph symmetrization on the rows' device.

Port of sph_tpu/ops/device_merge.py, the JAX package's accelerator path for
the per-level merges of walk rows (sum) and of distance rows (min), and for
the kNN graph's symmetrization.  The JAX package takes it on its
accelerator, because downloading the rows, merging them on one host core
and uploading the result was the last host step of the hierarchy loop.
The port takes it wherever the rows lie on the card (``on_card``), so they
never leave it; rows on the CPU take the host C++ merge.

What comes out is the port's host path bit for bit (``ops/sparse.py``'s
C++ merges and ``native.symmetrize``), which the JAX package's host path
also gives: the same entries, the same values, and rows of the exact
widest width.  The JAX package's device path differs from that in three
ways, which the port does not copy:

- it pads rows to a power-of-two width (a bucket for XLA's compiled
  programs, as ``ops/bucketing.py`` is, which the port does not have);
- it floors a width cap to a power of two (:388-396), so where the cap
  bites below a width that is not a power of two it keeps fewer entries
  than its host path; the port keeps ``max_width`` entries, as the host;
- it sums each run in the scatter's order.

A merge (``merge_by_parents_device``): the live entries (index >= 0 and
value != 0) of each parent's children, in ascending child order, are
flattened row by row, keyed ``parent[row] * num_merged + parent[col]`` and
sorted stably (the host's LSD radix sort is stable too, so equal keys keep
the same order); flags mark where each run of equal keys starts; the kernel
``csrc/merge_runs.cu`` (``merge_runs``) folds each run in that order and
sums each parent's weights over its children, as the host C++ does; then
``pack_coo`` lays the rows out, keeping each row's largest sums (smallest
minima) where ``max_width`` bites, ties to the lower column.  The parents
are processed in ranges that fit ``MERGE_MEMORY_BUDGET``.

The symmetrization (``symmetrize_graph_device``) has no sums: stable sorts,
first-of-run flags, ranks in a row and a scatter, as torch ops.

``_merge_lanes`` (:182-262), the JAX package's opt-in lane merge
(``SPH_MERGE_LANE_BUDGET``, off by default), is a TPU layout of the same
result and is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda_build import _launch

# bytes a merge's parent range may hold at once; parents are merged in
# ranges that fit.  A range holds, for each padded slot of its children's
# rows, the gathered index (int64), value (float32) and live flag (13 B),
# and for each live entry its ids, key, value and the stable sort's
# buffers: 48 B, above the 46.8 B measured on an H100 at salinas_walks'
# widest merge in one range (chip_smoke.merge_peak_bytes: the range's peak
# less 13 B a slot, over its live entries; PERF.md section 6)
MERGE_MEMORY_BUDGET = 2 << 30
_BYTES_PER_SLOT = 13
_BYTES_PER_ENTRY = 48


def on_card(device) -> bool:
    """Whether rows on `device` merge and symmetrize there (on a CUDA
    device); elsewhere they take the host C++ path."""
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# the kernel and its twin
# ---------------------------------------------------------------------------

def _check_runs(keys, vals, run_start, child_w, parent_start):
    if keys.dtype != torch.int64 or run_start.dtype != torch.int64:
        raise TypeError("merge_runs: keys and run_start must be int64")
    if vals.dtype != torch.float32:
        raise TypeError("merge_runs: vals must be float32")
    if keys.dim() != 1 or keys.shape != vals.shape or run_start.dim() != 1:
        raise ValueError("merge_runs: keys [E], vals [E] and run_start "
                         "[U + 1] must be 1-D")
    if (child_w is None) != (parent_start is None):
        raise ValueError("merge_runs: child_w and parent_start come together")
    if child_w is not None and (child_w.dtype != torch.float32
                                or parent_start.dtype != torch.int64):
        raise TypeError("merge_runs: child_w must be float32, parent_start "
                        "int64")
    dev = keys.device
    for t in (vals, run_start, child_w, parent_start):
        if t is not None and t.device != dev:
            raise ValueError("merge_runs: all tensors on one device")


def merge_runs(keys: torch.Tensor, vals: torch.Tensor,
               run_start: torch.Tensor, num_merged: int, combine: str,
               child_w: Optional[torch.Tensor] = None,
               parent_start: Optional[torch.Tensor] = None,
               parent0: int = 0):
    """Each run of equal keys folded in order, as the host C++ merge folds
    it: keys [E] int64 (sorted, ``row * num_merged + col``), vals [E]
    float32, run_start [U + 1] int64 (each run's first entry, then E).
    combine "sum": ``s += v`` from 0 in float32; with child_w [C] float32
    (the children's weights grouped by parent, ascending within a parent)
    and parent_start [P + 1] int64, each parent's weight is summed the same
    way and a run's sum divided by max(weight of row - parent0, 1).
    combine "min": the smallest value (no weights).

    Returns (rows [U] int64, cols [U] int64, out [U] float32, merged_w [P]
    float32 or None).  The kernel ``csrc/merge_runs.cu`` on a CUDA tensor
    (counted in ``merge_runs.launches``), the twin ``merge_runs_reference``
    on a CPU one."""
    if combine not in ("sum", "min"):
        raise ValueError(f"merge_runs: combine must be 'sum' or 'min', got "
                         f"{combine!r}")
    if combine == "min" and child_w is not None:
        raise ValueError("merge_runs: the min merge takes no weights")
    _check_runs(keys, vals, run_start, child_w, parent_start)
    dev = keys.device
    if dev.type == "cpu":
        return merge_runs_reference(keys, vals, run_start, num_merged,
                                    combine, child_w, parent_start, parent0)
    if dev.type != "cuda":
        raise ValueError(f"merge_runs: no kernel for {dev}")
    keys, vals, run_start = (keys.contiguous(), vals.contiguous(),
                             run_start.contiguous())
    runs = run_start.numel() - 1
    rows = torch.empty(runs, dtype=torch.int64, device=dev)
    cols = torch.empty(runs, dtype=torch.int64, device=dev)
    out = torch.empty(runs, dtype=torch.float32, device=dev)
    parents = 0 if parent_start is None else parent_start.numel() - 1
    merged_w = None
    if parent_start is not None:
        child_w, parent_start = child_w.contiguous(), parent_start.contiguous()
        merged_w = torch.empty(parents, dtype=torch.float32, device=dev)
    if runs > 0 or parents > 0:
        _launch("merge_runs", dev, keys.data_ptr(), vals.data_ptr(),
                run_start.data_ptr(), runs, int(num_merged),
                1 if combine == "min" else 0,
                None if parents == 0 else child_w.data_ptr(),
                None if parents == 0 else parent_start.data_ptr(), parents,
                int(parent0), None if parents == 0 else merged_w.data_ptr(),
                rows.data_ptr(), cols.data_ptr(),
                out.data_ptr())
        merge_runs.launches += 1
    return rows, cols, out, merged_w


# launches of merge_runs (the kernel), counted where the kernel launches
merge_runs.launches = 0


def _fold_segments(vals: torch.Tensor, starts: torch.Tensor, combine: str
                   ) -> torch.Tensor:
    """Each segment [starts[i], starts[i + 1]) of vals folded left to right
    (``s += v`` from 0, or the running ``(v < m) ? v : m``): the segments
    laid side by side as the columns of a [segments, longest] matrix, longest
    first, and the matrix folded column by column over the segments still
    running."""
    count = starts.numel() - 1
    dev = vals.device
    if count <= 0:
        return torch.empty(0, dtype=torch.float32, device=dev)
    lengths = starts[1:] - starts[:-1]
    order = torch.sort(lengths, descending=True, stable=True).indices
    ls, st = lengths[order], starts[:-1][order]
    longest = int(ls[0])
    # running[j]: the segments longer than j, a prefix of the sorted order
    running = count - torch.cumsum(
        torch.bincount(ls, minlength=longest + 1), 0).cpu().numpy()
    if combine == "sum":
        acc = torch.zeros(count, dtype=torch.float32, device=dev)
        first = 0
    else:                  # runs are never empty
        acc = vals[st].clone()
        first = 1
    for j in range(first, longest):
        m = int(running[j])
        v = vals[st[:m] + j]
        if combine == "sum":
            acc[:m] = acc[:m] + v
        else:
            acc[:m] = torch.where(v < acc[:m], v, acc[:m])
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def merge_runs_reference(keys: torch.Tensor, vals: torch.Tensor,
                         run_start: torch.Tensor, num_merged: int,
                         combine: str,
                         child_w: Optional[torch.Tensor] = None,
                         parent_start: Optional[torch.Tensor] = None,
                         parent0: int = 0):
    """The twin of ``merge_runs`` in torch ops: runs (and parents) folded
    column by column (``_fold_segments``); the same float32 additions, in
    the same order, and the same true division."""
    _check_runs(keys, vals, run_start, child_w, parent_start)
    merged_w = None
    if parent_start is not None:
        merged_w = _fold_segments(child_w, parent_start, "sum")
    out = _fold_segments(vals, run_start, combine)
    first = keys[run_start[:-1]]
    rows = torch.div(first, num_merged, rounding_mode="floor")
    cols = first - rows * num_merged
    if merged_w is not None and out.numel():
        out = out / torch.clamp_min(merged_w[rows - parent0], 1.0)
    return rows, cols, out, merged_w


# ---------------------------------------------------------------------------
# the merges
# ---------------------------------------------------------------------------

def _parent_ranges(par_cost: torch.Tensor, budget: int) -> list:
    """[p0, p1) ranges of parents, in order, whose summed cost is at most
    budget (a parent above it alone)."""
    m = par_cost.numel()
    cum = torch.cumsum(par_cost, 0)
    total = int(cum[-1]) if m else 0
    if total <= budget:
        return [(0, m)]
    cum = cum.cpu().numpy()
    out, p0 = [], 0
    while p0 < m:
        base = cum[p0 - 1] if p0 else 0
        p1 = int(np.searchsorted(cum, base + budget, side="right"))
        p1 = min(max(p1, p0 + 1), m)
        out.append((p0, p1))
        p0 = p1
    return out


def merge_kernel_inputs(sr, parents: np.ndarray, num_merged: int,
                        weight_by_size: bool, combine: str,
                        memory_budget: int = MERGE_MEMORY_BUDGET):
    """The calls of ``merge_runs`` that merge the rows of `sr` into their
    parents (see ``merge_by_parents_device``): for each range of parents
    that fits `memory_budget` bytes (``_BYTES_PER_SLOT`` a padded slot of
    its children's rows, ``_BYTES_PER_ENTRY`` a live entry), in order, the
    pair (args, kwargs).  Raises ValueError on a parent or a live column outside
    the domain, as the C++ merge rejects it."""
    if combine not in ("sum", "min"):
        raise ValueError(f"merge_by_parents_device: combine must be 'sum' or "
                         f"'min', got {combine!r}")
    dev = sr.device
    n = sr.num_rows
    parents = np.asarray(parents, dtype=np.int64)
    if parents.shape != (n,):
        raise ValueError(f"merge_by_parents_device: parents must be [{n}], "
                         f"got {parents.shape}")
    if num_merged <= 0 or (n and (int(parents.min()) < 0
                                  or int(parents.max()) >= num_merged)):
        raise ValueError("merge_by_parents_device: a parent id lies outside "
                         f"[0, {num_merged})")
    live = (sr.idx >= 0) & (sr.val != 0)
    if n and bool((live & (sr.idx >= n)).any()):
        raise ValueError("merge_by_parents_device: a column id lies outside "
                         f"[0, {n})")
    par = torch.as_tensor(parents, device=dev)
    weighted = combine == "sum" and weight_by_size
    nnz = live.sum(1)
    weight = nnz.to(torch.float32)
    # children grouped by parent, ascending within a parent
    order = torch.sort(par, stable=True).indices
    child_start = torch.zeros(num_merged + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(par, minlength=num_merged), 0,
                 out=child_start[1:])
    par_cost = torch.zeros(num_merged, dtype=torch.int64, device=dev)
    par_cost.index_add_(0, par, nnz * _BYTES_PER_ENTRY
                        + sr.width * _BYTES_PER_SLOT)
    cs = child_start.cpu().numpy()
    for p0, p1 in _parent_ranges(par_cost, memory_budget):
        rows = order[int(cs[p0]):int(cs[p1])]
        idx_c, live_c = sr.idx[rows], live[rows]
        child = rows[:, None].expand_as(idx_c)[live_c]
        v = sr.val[rows][live_c]
        if weighted:
            v = v * weight[child]
        key = par[child] * num_merged + par[idx_c[live_c]]
        del idx_c, live_c
        key, perm = torch.sort(key, stable=True)
        v = v[perm]
        del perm, child
        first = torch.ones(key.numel(), dtype=torch.bool, device=dev)
        first[1:] = key[1:] != key[:-1]
        run_start = torch.cat([
            torch.nonzero(first).flatten(),
            torch.tensor([key.numel()], dtype=torch.int64, device=dev)])
        del first
        extra = {}
        if weighted:
            extra = {"child_w": weight[rows],
                     "parent_start": (child_start[p0:p1 + 1]
                                      - child_start[p0]),
                     "parent0": p0}
        yield (key, v, run_start, num_merged, combine), extra


def merge_by_parents_device(sr, parents: np.ndarray, num_merged: int,
                            weight_by_size: bool, combine: str,
                            max_width: Optional[int] = None,
                            memory_budget: int = MERGE_MEMORY_BUDGET):
    """Merge the rows of `sr` (a SparseRows) into `num_merged` parent rows,
    mapping rows and columns through `parents` [N]: "sum" adds duplicate
    entries (each child row weighted by its live count and each merged row
    divided by its children's summed counts, where weight_by_size), "min"
    keeps the smallest.  Rows wider than max_width keep their largest sums
    or smallest minima, ties to the lower column.  Returns a SparseRows on
    the input's device, equal bit for bit to the host C++ path's
    (``ops/sparse.merge_rows_by_parents`` / ``merge_rows_min_by_parents``
    on CPU rows).  A parent or a live column outside the domain raises
    ValueError, as the C++ merge rejects it."""
    from .sparse import pack_coo
    got = [merge_runs(*args, **extra)[:3] for args, extra in
           merge_kernel_inputs(sr, parents, num_merged, weight_by_size,
                               combine, memory_budget)]
    rows = torch.cat([g[0] for g in got])
    cols = torch.cat([g[1] for g in got])
    vals = torch.cat([g[2] for g in got])
    return pack_coo(rows, cols, vals, num_merged, num_merged, max_width,
                    largest=combine == "sum",
                    log_as="merge_by_parents_device")


# ---------------------------------------------------------------------------
# the kNN graph's symmetrization
# ---------------------------------------------------------------------------

def _sortable(d: torch.Tensor) -> torch.Tensor:
    """float32 values as int64 keys in [0, 2^32) ordered as the floats
    compare with `<` (-0.0 and 0.0 equal; NaN not expected)."""
    b = (d + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b) + (1 << 31)


def symmetrize_graph_device(indices: torch.Tensor, distances: torch.Tensor,
                            max_width: int = 0):
    """The undirected union of a padded kNN graph (indices [N, K], pads < 0,
    and their distances), each duplicate edge with its smaller distance;
    each row the self edge first (distance 0), then its neighbours by
    (distance, column); rows of more than max_width - 1 neighbours keep
    their closest (max_width 0: no cap).  Returns (out_idx [N, w] int32,
    out_dist [N, w] float32, counts [N] int32) on the inputs' device, w the
    exact widest row: ``native.symmetrize`` (graphops.cpp
    collect_canonical_edges and symmetrize_fill) bit for bit.  An id at or
    above N raises ValueError, as the C++ rejects it."""
    if indices.dim() != 2 or distances.shape != indices.shape:
        raise ValueError("symmetrize_graph_device: indices and distances "
                         "must be [N, K] alike")
    dev = indices.device
    n, k = indices.shape
    idx = indices.to(torch.int64)
    dist = distances.to(device=dev, dtype=torch.float32)
    if idx.numel() and bool((idx >= n).any()):
        raise ValueError("symmetrize_graph_device: a neighbour id lies "
                         f"outside [0, {n})")
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)
    valid = (idx >= 0) & (idx != rows)
    a = torch.minimum(rows, idx)[valid]
    b = torch.maximum(rows, idx)[valid]
    d = dist[valid]
    # dedup (a, b) keeping the smallest distance: by distance, then by key
    key = a * n + b
    o = torch.sort(_sortable(d), stable=True).indices
    o = o[torch.sort(key[o], stable=True).indices]
    key, d = key[o], d[o]
    first = torch.ones(key.numel(), dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    key, d = key[first], d[first]
    ua = torch.div(key, n, rounding_mode="floor")
    ub = key - ua * n
    r = torch.cat([ua, ub])
    c = torch.cat([ub, ua])
    d = torch.cat([d, d])
    # each row by (distance, column): by column, then by (row, distance)
    o = torch.sort(c, stable=True).indices
    o = o[torch.sort((r[o] << 32) + _sortable(d[o]), stable=True).indices]
    r, c, d = r[o], c[o], d[o]
    deg = torch.bincount(r, minlength=n)
    width = (int(deg.max()) if n else 0) + 1
    if max_width > 0:
        width = min(width, max_width)
    starts = torch.cumsum(deg, 0) - deg
    slot = torch.arange(r.numel(), device=dev) - starts[r] + 1
    keep = slot < width
    out_idx = torch.full((n, width), -1, dtype=torch.int32, device=dev)
    out_dist = torch.full((n, width), float("inf"), dtype=torch.float32,
                          device=dev)
    out_idx[r[keep], slot[keep]] = c[keep].to(torch.int32)
    out_dist[r[keep], slot[keep]] = d[keep]
    out_idx[:, 0] = torch.arange(n, dtype=torch.int32, device=dev)
    out_dist[:, 0] = 0.0
    counts = (1 + torch.clamp(deg, max=width - 1)).to(torch.int32)
    return out_idx, out_dist, counts
