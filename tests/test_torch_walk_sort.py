"""Walk rows under LINEAR and NORMAL step weights, bit for bit against the
JAX package on the CPU.

The JAX package's ``_accumulate`` co-sorts each start point's visits by
node id with an unstable sort and sums each id's weights as differences of
one running sum over the whole sorted row, so the port must put equal ids
where XLA-CPU puts them (``ops/walk_sort.xla_sort_order``: the C++ twin
``native/xla_sort.cpp`` on the CPU, the kernel ``csrc/walk_row_sort.cu``
on the card) and give each visit the weight XLA-CPU computes for its slot
(``ops/walks.xla_step_weights``).  Held here:

- the twin's order against ``jax.lax.sort(..., is_stable=False)`` on rows
  of 1 to 50000 keys: heavy repeats, all equal, sorted, reverse-sorted and
  a median-of-3 adversary (McIlroy's) that drives std::sort to its heap
  path;
- the Python transcription of std::sort's steps against the twin;
- the kernel's partition by ballots (``ballot_partition_reference``)
  against ``_unguarded_partition`` (cut, swaps, array) on seeded ranges,
  and its whole-row order (``ballot_introsort_order_reference``: leaves
  sorted stably when made, the heap path at depth 0) against the twin,
  at the kernel's path limits and one key past each;
- the slot weights against those ``_accumulate`` folds (read out through
  rows whose smallest id sits in a chosen slot);
- ``accumulate`` against ``_accumulate`` for LINEAR and NORMAL, full rows
  and top-k rows, and for CONSTANT, ONLYLAST and FIRST_VISIT, whose
  integer sums are exact in any order;
- the wrapper's device rules; on the card (marked ``cuda``) the kernel
  against the twin on both of its paths.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sph_tpu.ops import walks as jwalks
from sph_tpu_torch import native
from sph_tpu_torch.ops import walk_sort, walks
from test_torch_reference_native import use_reference_native

use_reference_native()

LENGTHS = [1, 2, 16, 17, 500, 1350, 20000, 50000]
KINDS = ["repeats", "equal", "sorted", "reversed", "adversary"]


@functools.lru_cache(maxsize=None)
def median_of_3_adversary(n: int) -> np.ndarray:
    return walk_sort.median_of_3_adversary(n)


def make_keys(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rows = max(1, min(16, 100000 // n))
    rng = np.random.default_rng(seed + n)
    if kind == "repeats":
        return rng.integers(0, max(2, n // 10), (rows, n)).astype(np.int32)
    if kind == "equal":
        return np.full((rows, n), 7, np.int32)
    if kind == "sorted":
        return np.tile(np.arange(n, dtype=np.int32) // 3, (rows, 1))
    if kind == "reversed":
        return np.tile(np.arange(n, dtype=np.int32)[::-1] // 3, (rows, 1))
    return median_of_3_adversary(n)[None, :]


def xla_order(keys: np.ndarray) -> np.ndarray:
    """XLA-CPU's order: the iota operand of an unstable three-operand sort,
    as ``_accumulate`` sorts (ids, weights, counts)."""
    r, s = keys.shape
    iota = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (r, s))
    payload = jnp.asarray(np.random.default_rng(1).random((r, s),
                                                         dtype=np.float32))
    _, order, _ = jax.lax.sort((jnp.asarray(keys), iota, payload),
                               num_keys=1, dimension=1, is_stable=False)
    return np.asarray(order)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_twin_order_equals_xla_unstable_sort(n, kind):
    keys = make_keys(kind, n)
    order, sorted_keys = native.xla_sort_order(keys)
    assert np.array_equal(order, xla_order(keys))
    assert np.array_equal(sorted_keys,
                          np.take_along_axis(keys, order, axis=1))


def test_adversary_reaches_the_heap_path():
    for n in (64, 500, 1350):
        stats = {}
        walk_sort.introsort_order_reference(median_of_3_adversary(n), stats)
        assert stats.get("heap", 0) > 0, n
    stats = {}
    walk_sort.introsort_order_reference(make_keys("repeats", 500)[0], stats)
    assert stats.get("heap", 0) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_transcription_equals_twin(kind):
    """The kernel's steps in Python against std::sort on rows of 0 to 300
    keys (the adversary's at 17 to 300)."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 3, 15, 16, 17, 18, 33, 64, 100, 257, 300):
        if kind == "adversary" and n < 17:
            continue
        if kind == "repeats":
            keys = rng.integers(-5, 6, (4, n)).astype(np.int32)
        else:
            keys = make_keys(kind, max(n, 1))[:1, :n]
        want, _ = native.xla_sort_order(keys)
        for r in range(keys.shape[0]):
            assert walk_sort.introsort_order_reference(keys[r]) == \
                want[r].tolist(), (kind, n)


PARTITION_KINDS = ["few", "many", "sorted", "reversed", "equal"]


def partition_range(kind: str, n: int, rng) -> np.ndarray:
    """Keys [n] of one kind, the pivot moved to the front as std::sort's
    __move_median_to_first leaves it."""
    if kind == "few":
        keys = rng.integers(0, 1 + int(rng.integers(1, 5)), n)
    elif kind == "many":
        keys = rng.integers(0, int(rng.integers(n // 2 + 1, 1002)), n)
    elif kind == "sorted":
        keys = np.sort(rng.integers(0, int(rng.integers(2, 300)), n))
    elif kind == "reversed":
        keys = np.sort(rng.integers(0, int(rng.integers(2, 300)), n))[::-1]
    else:
        keys = np.full(n, 3)
    items = [(int(k), i) for i, k in enumerate(keys)]
    walk_sort._median_to_first(items, lambda a, b: a[0] < b[0], 0, 1,
                               n // 2, n - 1)
    return np.array([k for k, _ in items], dtype=np.int64)


@pytest.mark.parametrize("kind", PARTITION_KINDS)
def test_ballot_partition_equals_unguarded_partition(kind):
    """The rule, all stops at once, against Hoare's scan as libstdc++
    writes it on 1500 seeded ranges of 17 to 300 keys: the same cut, the
    same pairs swapped (the scan's, in its order) and the same array."""
    rng = np.random.default_rng(PARTITION_KINDS.index(kind))
    for _ in range(1500):
        n = int(rng.integers(17, 301))
        keys = partition_range(kind, n, rng)
        want = keys.tolist()
        swaps = []

        def less(a, b):
            return a < b
        first = 1
        last = n
        while True:
            while less(want[first], want[0]):
                first += 1
            last -= 1
            while less(want[0], want[last]):
                last -= 1
            if not first < last:
                break
            swaps.append((first, last))
            want[first], want[last] = want[last], want[first]
            first += 1
        cut_scan = walk_sort._unguarded_partition(keys.tolist(), less, 1, n,
                                                  0)
        cut, pairs, k, out = walk_sort.ballot_partition_reference(keys, 0, n)
        assert cut == first == cut_scan, (kind, n)
        assert k == len(swaps) and pairs.tolist() == [list(p) for p in swaps]
        assert out.tolist() == want


BALLOT_LENGTHS = LENGTHS + [walk_sort.WARP_COLS, walk_sort.WARP_COLS + 1,
                            walk_sort.STAGE_COLS, walk_sort.STAGE_COLS + 1]


@pytest.mark.parametrize("lane_range", [walk_sort.THRESHOLD,
                                        walk_sort.LANE_RANGE])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", BALLOT_LENGTHS)
def test_ballot_order_equals_twin(n, kind, lane_range):
    """The kernel's algorithm, row by row, against std::sort, with every
    range above THRESHOLD partitioned by the rule, or those of up to
    LANE_RANGE keys finished as the kernel's lanes finish them; the
    adversary's rows reach the heap path."""
    keys = make_keys(kind, n)[:2]
    want, _ = native.xla_sort_order(keys)
    for r in range(keys.shape[0]):
        stats = {}
        got = walk_sort.ballot_introsort_order_reference(keys[r], stats,
                                                         lane_range)
        assert got == want[r].tolist(), (kind, n, r)
        if kind == "adversary" and n >= 64:
            assert stats.get("heap", 0) > 0


def test_twin_rows_do_not_depend_on_threads():
    keys = make_keys("repeats", 500)
    keys = np.tile(keys, (40, 1))
    one, k1 = native.xla_sort_order(keys, threads=1)
    eight, k8 = native.xla_sort_order(keys, threads=8)
    assert np.array_equal(one, eight) and np.array_equal(k1, k8)


def test_wrapper_device_rules():
    keys = torch.from_numpy(make_keys("repeats", 500).astype(np.int64))
    before = walk_sort.xla_sort_order.launches
    order, sk = walk_sort.xla_sort_order(keys)
    assert order.dtype == torch.int64 and order.device.type == "cpu"
    assert sk.dtype == torch.int32
    assert np.array_equal(order.numpy(),
                          native.xla_sort_order(keys.numpy())[0])
    assert torch.equal(sk.long(), keys.gather(1, order))
    # the twin is not a launch
    assert walk_sort.xla_sort_order.launches == before
    with pytest.raises(ValueError):
        walk_sort.xla_sort_order(keys.to("meta"))
    with pytest.raises(ValueError):
        walk_sort.xla_sort_order(keys[0])
    with pytest.raises(TypeError):
        walk_sort.xla_sort_order(keys.float())


# ------------------------------------------------------------ step weights

def slot_readout(weighting: str, w: int, length: int, slots) -> np.ndarray:
    """The weight ``_accumulate`` gives each of `slots` (slot w * L + t of
    a start point's visit list): row c's ids are all distinct and its
    smallest sits in slots[c], so that run's sum is the first of the
    sorted row, the weight itself."""
    tc = w * length
    slots = np.asarray(slots)
    c = len(slots)
    ids = (np.arange(tc)[None, :] - slots[:, None]) % tc
    vis = ids.reshape(c, w, length).transpose(2, 0, 1).reshape(length, c * w)
    idx, val = jwalks._accumulate(jnp.asarray(vis.astype(np.int32)), w,
                                  length, weighting, tc)
    idx, val = np.asarray(idx), np.asarray(val)
    assert (idx[:, 0] == 0).all()
    return val[:, 0]


def boundary_slots(tc: int) -> np.ndarray:
    """The first 40 slots and the last 72: every place where XLA-CPU's
    code may change lies at the start or within the last 32-wide block
    and the remainder after it."""
    return np.array(sorted(set(range(min(tc, 40)))
                           | set(range(max(0, tc - 72), tc))))


@pytest.mark.parametrize("block", range(10))
def test_normal_step_weights_equal_folded(block):
    """NORMAL, every step of L = 1 to 100 (ten lengths a case)."""
    for length in range(10 * block + 1, 10 * block + 11):
        got = walks.xla_step_weights("normal", length, length, 1).numpy()
        want = slot_readout("normal", 1, length, np.arange(length))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            length


def test_normal_step_weights_equal_folded_long():
    """NORMAL past the explorer's lengths, across the length (288) from
    which XLA's vector loop runs instead of folding."""
    for length in (150, 287, 288, 289, 300, 350):
        got = walks.xla_step_weights("normal", length, length, 1).numpy()
        want = slot_readout("normal", 1, length, np.arange(length))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            length


@pytest.mark.parametrize("block", range(10))
def test_linear_step_weights_equal_folded(block):
    """LINEAR at 50 walks, L = 1 to 100 (ten lengths a case): rows of 50 to
    5000 slots, through every regime of xla_step_weights."""
    for length in range(10 * block + 1, 10 * block + 11):
        tc = 50 * length
        slots = boundary_slots(tc)
        got = walks.xla_step_weights("linear", length, length, 50).numpy()
        want = slot_readout("linear", 50, length, slots)
        assert np.array_equal(got[slots].view(np.uint32),
                              want.view(np.uint32)), length


@pytest.mark.parametrize("w", [1, 7, 11, 20, 22, 23, 24, 25, 32, 33, 36, 90])
def test_linear_step_weights_equal_folded_walks(w):
    """LINEAR at L = 10 and 15 for walk counts around the regimes' edges
    (rows of 10 to 1350 slots), every slot."""
    for length in (10, 15):
        tc = w * length
        got = walks.xla_step_weights("linear", length, length, w).numpy()
        want = slot_readout("linear", w, length, np.arange(tc))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            length


# ------------------------------------------------------------- accumulate

SHAPES = [(50, 10), (50, 5), (90, 15), (20, 40), (10, 100)]
C = 40


def visit_record(w: int, length: int, seed: int) -> np.ndarray:
    """A visit record [L, C * W] of C = 40 start points whose walks stay
    near their start (heavy repeats within each row)."""
    rng = np.random.default_rng(seed)
    start = np.repeat(np.arange(C), w)
    steps = rng.integers(-3, 4, (length, C * w)).cumsum(0)
    return np.clip(start[None, :] + steps, 0, C - 1).astype(np.int32)


def _accumulate_both(visited, w, length, weighting, out_width):
    ij, vj = jwalks._accumulate(jnp.asarray(visited), w, length, weighting,
                                out_width)
    it, vt = walks.accumulate(torch.from_numpy(visited.astype(np.int64)), w,
                              length, weighting, out_width)
    return (np.asarray(ij), np.asarray(vj)), (it.numpy(), vt.numpy())


@pytest.mark.parametrize("topk", [False, True])
@pytest.mark.parametrize("weighting", ["linear", "normal"])
@pytest.mark.parametrize("w,length", SHAPES)
def test_accumulate_bit_equal(w, length, weighting, topk):
    visited = visit_record(w, length, seed=w + length)
    out_width = C if topk else w * length
    (ij, vj), (it, vt) = _accumulate_both(visited, w, length, weighting,
                                          out_width)
    assert np.array_equal(ij, it)
    assert np.array_equal(vj.view(np.uint32), vt.view(np.uint32))


@pytest.mark.parametrize("weighting", ["constant", "onlylast",
                                       "first_visit"])
@pytest.mark.parametrize("w,length", [(50, 10), (90, 15), (10, 100)])
def test_integer_weights_equal_in_either_order(w, length, weighting):
    """The stable order the port keeps for these schemes gives XLA's sums:
    their weights and counts are small integers, exact in any order."""
    visited = visit_record(w, length, seed=3 * w + length)
    (ij, vj), (it, vt) = _accumulate_both(visited, w, length, weighting,
                                          w * length)
    assert np.array_equal(ij, it)
    assert np.array_equal(vj.view(np.uint32), vt.view(np.uint32))


# ----------------------------------------------------------------- on card

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 500, 1350, walk_sort.WARP_COLS,
                               walk_sort.WARP_COLS + 1, 3072,
                               walk_sort.STAGE_COLS,
                               walk_sort.STAGE_COLS + 1, 20000, 50000])
def test_cuda_kernel_equals_twin(n):
    """The kernel's order and sorted keys against the twin on its three
    paths (a warp a row up to WARP_COLS keys, a block a row staged up to
    STAGE_COLS, partitioned in the order buffer above), every kind of
    row, one launch each; the adversary up to one key past STAGE_COLS
    (its heap path runs in one lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for kind in KINDS:
        if kind == "adversary" and n > walk_sort.STAGE_COLS + 1:
            continue
        keys = make_keys(kind, n)
        want, _ = native.xla_sort_order(keys)
        before = walk_sort.xla_sort_order.launches
        order, sk = walk_sort.xla_sort_order(torch.from_numpy(keys).cuda())
        assert walk_sort.xla_sort_order.launches == before + 1
        assert np.array_equal(order.cpu().numpy(), want), kind
        assert np.array_equal(sk.cpu().numpy(),
                              np.take_along_axis(keys, want, axis=1))


@pytest.mark.cuda
def test_cuda_accumulate_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for weighting in ("linear", "normal"):
        visited = torch.from_numpy(visit_record(50, 10, 1).astype(np.int64))
        ic, vc = walks.accumulate(visited, 50, 10, weighting, 500)
        ig, vg = walks.accumulate(visited.cuda(), 50, 10, weighting, 500)
        assert torch.equal(ic, ig.cpu())
        assert torch.equal(vc.view(torch.int32), vg.cpu().view(torch.int32))


# ------------------------------------------------- chip_smoke.py's helpers

def _chip_smoke():
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke
    return chip_smoke


def test_smoke_walk_sort_bound():
    """16 bytes an entry at 3.35 TB/s: 0.050 ms at the eval grids' level
    0 (21025 rows of 500 keys)."""
    b = _chip_smoke().walk_sort_bound(21025, 500)
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] - 16 * 21025 * 500 / 3.35e12 * 1e3) < 1e-12
    assert 0.0501 < b["bound_ms"] < 0.0503


def test_smoke_synthetic_rows(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEV", "cpu")
    keys = cs.walk_sort_synthetic(walk_sort, 500, rows=3)
    assert tuple(keys.shape) == (12, 500) and keys.dtype == torch.int32
    assert (keys[:3] == 7).all()
    assert torch.equal(keys[3], torch.arange(500, dtype=torch.int32) // 3)
    assert torch.equal(keys[6], keys[3].flip(0))
    assert np.array_equal(keys[9].numpy(),
                          walk_sort.median_of_3_adversary(500))
    wide = cs.walk_like_rows(4, 1000)
    assert tuple(wide.shape) == (4, 1000)
    assert ((wide - 1000 * torch.arange(4)[:, None]).abs() <= 200).all()


def test_smoke_first_visit_record_captures_level_rows():
    """The capture hands over the per-start visit lists that the sort
    takes, and leaves accumulate's results and the module as they were."""
    cs = _chip_smoke()
    w, length = 50, 10
    visited = torch.from_numpy(visit_record(w, length, 4).astype(np.int64))
    keep = {}
    inner = walks.accumulate
    with cs.first_visit_record(walks, C, keep):
        got = walks.accumulate(visited, w, length, "normal", w * length)
        walks.accumulate(visited[:, :w * 10], w, length, "normal", 5)
    assert walks.accumulate is inner
    want = walks.accumulate(visited, w, length, "normal", w * length)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert keep["walks"] == w and keep["length"] == length
    ids = keep["ids"]
    assert tuple(ids.shape) == (C, w * length)
    assert torch.equal(ids[3, 2 * length:3 * length],
                       visited[:, 3 * w + 2])


def test_kernel_source_and_registry():
    """The source names what it replaces, what bounds it and the steps of
    std::sort it takes; the build registry holds it with its C entry
    point, and the path limits match the wrapper's."""
    from sph_tpu_torch.ops import cuda_build
    with open(cuda_build.source("walk_row_sort")) as f:
        src = f.read()
    assert "sph_tpu/ops/walks.py::_accumulate" in src and "bound" in src
    for step in ("__introsort_loop", "__move_median_to_first",
                 "__unguarded_partition", "__make_heap", "__sort_heap",
                 "__adjust_heap", "__push_heap", "__final_insertion_sort",
                 "__unguarded_insertion_sort"):
        assert step in src, step
    assert 'extern "C" int walk_row_sort_launch' in src
    assert "__ballot_sync" in src and "kSharedCols" not in src
    assert f"kWarpCols = {walk_sort.WARP_COLS};" in src
    assert f"kStageCols = {walk_sort.STAGE_COLS};" in src
    assert f"kThreshold = {walk_sort.THRESHOLD};" in src
    assert f"kLaneRange = {walk_sort.LANE_RANGE};" in src
    assert "walk_row_sort" in cuda_build.ALL_KERNELS
    assert len(cuda_build._SIGNATURES["walk_row_sort"]) == 7
