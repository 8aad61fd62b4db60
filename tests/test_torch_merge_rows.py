"""The merge kernel's design and its twin, without the JAX package.

``merge_runs`` (csrc/merge_runs.cu) merges each parent's children's rows in
shared memory; its twin ``merge_runs_reference`` is the torch pipeline of
sorted entries.  On the CPU: ``kernel_transcription``, the kernel's loops in
numpy float32 (tiles of 1024 slots in flattened order, the stable partition
of a tile among 8 warps by column, groups of 32 entries whose lowest lane
takes the accumulator or, at a column's first entry, its value and folds
its group in lane order, windows of columns from the parent's first
column, the next window from the smallest column past the last, the runs
written in ascending column, the
weights folded in child order), held against the twin bit for bit at
windows of 32 to 8192 columns; the twin and ``keep_best`` against the port's host C++ merge.
On the card (tests marked ``cuda``): the kernel against the twin bit for
bit at the same cases and windows, a parent past 2^24 live entries, a whole
device merge against the host path, the launch count and the column check.
"""

import numpy as np
import pytest
import torch

from sph_tpu_torch.ops import device_merge as tdm
from sph_tpu_torch.ops import sparse as tsp

CPU = torch.device("cpu")
THREADS, WARPS, ITEMS = 256, 8, 4        # merge_runs.cu's kThreads, ...
TILE = THREADS * ITEMS


def walk_rows(c: int, width: int, seed: int, num_cols: int = 0):
    """c rows of 0..width distinct ascending columns of num_cols (c by
    default), values summing to one; row 3 keeps its columns with all-zero
    values, row 4 is empty."""
    r = np.random.default_rng(seed)
    n = num_cols or c
    idx = np.full((c, width), -1, np.int64)
    val = np.zeros((c, width), np.float32)
    for i in range(c):
        m = int(r.integers(0, width + 1))
        idx[i, :m] = np.sort(r.choice(n, m, replace=False))
        v = np.ceil(r.random(m) * 64.0).astype(np.float32)
        val[i, :m] = v / max(float(v.sum()), 1.0)
    val[3] = 0.0
    idx[4], val[4] = -1, 0.0
    return idx, val


def case(name: str):
    """(idx [N, W] int64, val [N, W] float32, parents [N], num_merged) of
    a named case."""
    r = np.random.default_rng(sum(map(ord, name)))
    if name == "walks":
        idx, val = walk_rows(400, 30, seed=1)
        par = r.integers(0, 41, 400)
        par[:41] = np.arange(41)
        return idx, val, par, 41
    if name == "one_child":          # every parent has one child
        idx, val = walk_rows(300, 20, seed=2)
        return idx, val, r.permutation(300), 300
    if name == "one_parent":         # every row into one parent: one run
        idx, val = walk_rows(200, 24, seed=3)
        return idx, val, np.zeros(200, np.int64), 1
    if name == "half_into_one":      # one parent takes half the rows, its
        idx, val = walk_rows(1200, 40, seed=4)    # columns span 600 parents
        par = np.concatenate([np.zeros(600, np.int64), np.arange(1, 601)])
        return idx, val, par, 601
    if name == "repeated_columns":   # a row's columns map to few parents
        idx, val = walk_rows(500, 60, seed=5)
        return idx, val, r.integers(0, 7, 500) * 3 + (np.arange(500) < 21), 21
    if name == "holes":              # pads, zeros and -0.0 inside rows
        idx, val = walk_rows(300, 32, seed=6)
        hole = r.random(idx.shape) < 0.2
        idx[hole & (r.random(idx.shape) < 0.5)] = -1
        val[hole] = np.where(r.random(idx.shape) < 0.5, 0.0, -0.0)[hole]
        val[idx < 0] = r.random(idx.shape)[idx < 0].astype(np.float32)
        par = r.integers(0, 37, 300)
        par[:37] = np.arange(37)
        return idx, val, par, 37
    if name == "wide_parents":       # more parent columns than a window
        idx, val = walk_rows(3000, 40, seed=7)
        par = r.integers(0, 2500, 3000)
        par[:2500] = np.arange(2500)
        return idx, val, par, 2500
    raise KeyError(name)


CASES = ["walks", "one_child", "one_parent", "half_into_one",
         "repeated_columns", "holes", "wide_parents"]
COMBINES = [("sum", True), ("sum", False), ("min", False)]


def inputs(idx, val, par, m, combine, weighted, device=CPU):
    sr = tsp.SparseRows(idx, val, idx.shape[0], device=device)
    return tdm.merge_kernel_inputs(sr, par, m, weighted, combine)


def fold(a, x, combine):
    if combine == "min":
        return x if x < a else a
    return np.float32(a + x)


def kernel_transcription(args: dict, window: int):
    """merge_rows' loops (csrc/merge_runs.cu) in numpy float32, parent by
    parent: returns (idx [M, width], val [M, width], merged_w or None)."""
    idx, val = args["idx"].numpy(), args["val"].numpy()
    par, order = args["par"].numpy(), args["order"].numpy()
    child_start = args["child_start"].numpy()
    m, combine, weighted = (args["num_merged"], args["combine"],
                            args["weighted"])
    n, w = idx.shape
    merged_w = np.zeros(m, np.float32) if weighted else None
    runs = {}
    for p in args["by_size"].numpy():
        rows = order[child_start[p]:child_start[p + 1]]
        live_rows = (idx[rows] >= 0) & (val[rows] != 0)
        counts = live_rows.sum(1)
        div = np.float32(1.0)
        if weighted:                  # parent_weights: in child order
            mw = np.float32(0.0)
            for c in counts:
                mw = np.float32(mw + np.float32(c))
            merged_w[p] = mw
            div = max(mw, np.float32(1.0))
        nslots = rows.size * w
        s = np.arange(nslots)
        r_of, j_of = rows[s // w], s % w
        ids, x = idx[r_of, j_of], val[r_of, j_of]
        live = (ids >= 0) & (x != 0)
        assert not np.any(live & (ids >= n))
        col = np.where(live, par[np.clip(ids, 0, n - 1)], -1)
        if weighted:
            x = (x * counts[s // w].astype(np.float32)).astype(np.float32)
        out_c, out_v = [], []
        lo = 0
        if m > window:          # the first window at the parent's first column
            lo = int(col[col >= 0].min()) if (col >= 0).any() else m
        while nslots and lo < m:
            hi = min(lo + window, m)
            acc = np.zeros(window, np.float32)
            occ = np.zeros(window, bool)
            for tile in range(0, nslots, TILE):
                pos = np.arange(tile, min(tile + TILE, nslots))
                pos = pos[(col[pos] >= lo) & (col[pos] < hi)]
                for b in range(WARPS):              # warp b's columns
                    mine = pos[col[pos] % WARPS == b]
                    for g in range(0, mine.size, 32):
                        group = mine[g:g + 32]
                        a, leaders = {}, set()
                        for q in group:             # the leaders first
                            c = int(col[q])
                            if c in a:
                                continue
                            leaders.add(q)
                            o = c - lo
                            a[c] = fold(acc[o], x[q], combine) if occ[o] \
                                else x[q]
                            occ[o] = True
                        for q in group:             # then lane order
                            if q not in leaders:
                                c = int(col[q])
                                a[c] = fold(a[c], x[q], combine)
                        for c, v in a.items():
                            acc[c - lo] = v
            for o in np.nonzero(occ)[0]:
                out_c.append(lo + o)
                out_v.append(np.float32(acc[o] / div) if weighted
                             else acc[o])
            past = col[col >= hi]
            if not past.size:
                break
            lo = int(past.min())
        runs[p] = (out_c, out_v)
    width = max([len(c) for c, _ in runs.values()] + [1])
    out_idx = np.full((m, width), -1, np.int64)
    out_val = np.zeros((m, width), np.float32)
    for p, (c, v) in runs.items():
        out_idx[p, :len(c)] = c
        out_val[p, :len(v)] = v
    return out_idx, out_val, merged_w


def same_bits(a, b) -> bool:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.int32) if a.dtype == np.float32 else a,
        b.view(np.int32) if b.dtype == np.float32 else b)


def assert_same_merge(got, want):
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    assert (got[2] is None) == (want[2] is None)
    if got[2] is not None:
        assert same_bits(got[2], want[2])


@pytest.mark.parametrize("window", [32, 64, 8192])
@pytest.mark.parametrize("combine,weighted", COMBINES,
                         ids=["weighted", "sum", "min"])
@pytest.mark.parametrize("name", CASES)
def test_transcription_equals_the_twin(name, combine, weighted, window):
    """The kernel's loops give the twin's bits at every window: several
    windows a parent (32 columns), one window (8192), columns folded in
    the flattened order whichever warp and group they land in."""
    idx, val, par, m = case(name)
    args = inputs(idx, val, par, m, combine, weighted)
    want = tdm.merge_runs_reference(**args)
    assert_same_merge(kernel_transcription(args, window), want)


@pytest.mark.parametrize("combine,weighted", COMBINES,
                         ids=["weighted", "sum", "min"])
@pytest.mark.parametrize("name", CASES)
def test_twin_equals_the_host_merge(name, combine, weighted):
    """merge_runs on CPU tensors (the twin) against the port's host C++
    merge (native merge_sum / merge_min and its packing), bit for bit."""
    idx, val, par, m = case(name)
    got = tdm.merge_runs(**inputs(idx, val, par, m, combine, weighted))
    sr = tsp.SparseRows(idx, val, idx.shape[0], device=CPU)
    if combine == "sum":
        want = tsp.merge_rows_by_parents(sr, par, m, weight_by_size=weighted)
    else:
        want = tsp.merge_rows_min_by_parents(sr, par, m)
    assert same_bits(got[0], want.idx) and same_bits(got[1], want.val)


@pytest.mark.parametrize("cap", [1, 5, 8, 11])
@pytest.mark.parametrize("combine", ["sum", "min"])
def test_caps_keep_the_host_paths_rows(combine, cap):
    """keep_best on the twin's rows against the host path under a cap that
    bites, a power of two or not: each row's largest sums (smallest
    minima), ties to the lower column, in ascending column."""
    idx, val, par, m = case("repeated_columns")
    val = np.round(val * 8) / 8            # ties among the merged values
    sr = tsp.SparseRows(idx, val, idx.shape[0], device=CPU)
    got = tdm.merge_by_parents_device(sr, par, m, combine == "sum", combine,
                                      cap)
    if combine == "sum":
        want = tsp.merge_rows_by_parents(sr, par, m, max_width=cap)
    else:
        want = tsp.merge_rows_min_by_parents(sr, par, m, max_width=cap)
    assert got.width == cap
    assert same_bits(got.idx, want.idx) and same_bits(got.val, want.val)


def test_weights_past_2_24_fold_in_child_order():
    """A parent's weight is the float32 sum of its children's counts in
    child order (the kernel's parent_weights, the twin's
    ``_fold_segments``): the exact integer while that stays at most 2^24
    (every partial sum is an integer below it), another number past it."""
    r = np.random.default_rng(9)
    counts = r.integers(0, 5000, 3000).astype(np.float32)
    assert counts.sum() <= 2 ** 24
    seq = np.float32(0.0)
    for c in counts:
        seq = np.float32(seq + c)
    assert seq == np.float32(int(counts.astype(np.int64).sum()))
    big = np.array([2.0 ** 24, 1.0, 1.0, 1.0, 1.0], np.float32)
    got = tdm._fold_segments(torch.from_numpy(big),
                             torch.tensor([0, 5]), "sum")
    assert float(got[0]) == 2.0 ** 24 != int(big.astype(np.int64).sum())


def test_merge_runs_checks_its_arguments():
    idx, val, par, m = case("walks")
    args = inputs(idx, val, par, m, "sum", True)
    with pytest.raises(ValueError, match="weights"):
        tdm.merge_runs(**{**args, "combine": "min"})
    with pytest.raises(TypeError, match="int32"):
        tdm.merge_runs(**{**args, "par": args["par"].long()})
    with pytest.raises(ValueError, match="child_start"):
        tdm.merge_runs(**{**args, "child_start": args["child_start"][:-1]})
    bad = idx.copy()
    bad[7, 0], val[7, 0] = 400, 0.5
    with pytest.raises(ValueError, match="column"):
        tdm.merge_runs(**inputs(bad, val, par, m, "sum", True))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [32, 1024, tdm.MERGE_WINDOW])
@pytest.mark.parametrize("combine,weighted", COMBINES,
                         ids=["weighted", "sum", "min"])
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_equals_the_twin(card, name, combine, weighted, window):
    """merge_runs on the card against its twin on the same inputs, bit for
    bit, one launch a merge."""
    idx, val, par, m = case(name)
    args = inputs(idx, val, par, m, combine, weighted, device=card)
    before = tdm.merge_runs.launches
    got = tdm.merge_runs(**args, window=window)
    assert tdm.merge_runs.launches == before + 1
    assert_same_merge(got, tdm.merge_runs_reference(**args))
    if name == "wide_parents" and window == 32:
        assert tdm.merge_runs.windows > m      # parents of several windows


@pytest.mark.cuda
def test_cuda_parent_past_2_24_entries(card):
    """One parent of 5000 rows of 4096 slots, 3000-4096 of them live (17.7M
    live entries, so its children's counts sum past 2^24, where the float32
    fold in child order rounds), whose columns span 2048 parents: the
    kernel against the twin and the host C++ merge."""
    r = np.random.default_rng(11)
    kids, others, w = 5000, 2048, 4096
    n = kids + others
    idx = np.full((n, w), -1, np.int64)
    idx[:kids] = r.integers(kids, n, (kids, w))
    idx[:kids][np.arange(w) >= r.integers(3000, w + 1, kids)[:, None]] = -1
    idx[kids:, :8] = r.integers(0, n, (others, 8))
    val = np.where(idx >= 0, r.random((n, w)) + 0.5, 0).astype(np.float32)
    par = np.concatenate([np.zeros(kids, np.int64), np.arange(1, others + 1)])
    counts = (idx[:kids] >= 0).sum(1)
    fold = np.float32(0.0)
    for c in counts:
        fold = np.float32(fold + np.float32(c))
    assert counts.sum() > 2 ** 24 and fold != counts.sum()
    args = inputs(idx, val, par, others + 1, "sum", True, device=card)
    got = tdm.merge_runs(**args)
    assert float(got[2][0]) == float(fold)
    assert_same_merge(got, tdm.merge_runs_reference(**args))
    sr = tsp.SparseRows(idx, val, n, device=CPU)
    host = tsp.merge_rows_by_parents(sr, par, others + 1)
    assert same_bits(got[0], host.idx) and same_bits(got[1], host.val)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["sum", "min"])
def test_cuda_device_merge_equals_the_host_path(card, combine):
    """A whole device merge on the card, under a cap that bites and one
    that does not, against the host C++ path; a live column outside the
    domain raises."""
    idx, val = walk_rows(3000, 60, seed=18)
    r = np.random.default_rng(19)
    par = r.integers(0, 301, 3000)
    par[:301] = np.arange(301)
    sr = tsp.SparseRows(idx, val, 3000, device=card)
    for cap in (None, 40):
        got = tdm.merge_by_parents_device(sr, par, 301, combine == "sum",
                                          combine, cap)
        host = tsp.SparseRows(idx, val, 3000, device=CPU)
        want = (tsp.merge_rows_by_parents(host, par, 301, max_width=cap)
                if combine == "sum" else
                tsp.merge_rows_min_by_parents(host, par, 301, max_width=cap))
        assert same_bits(got.idx, want.idx) and same_bits(got.val, want.val)
    idx[9, 0], val[9, 0] = 3000, 0.5
    with pytest.raises(ValueError, match="column"):
        tdm.merge_by_parents_device(
            tsp.SparseRows(idx, val, 3000, device=card), par, 301, False,
            combine)
