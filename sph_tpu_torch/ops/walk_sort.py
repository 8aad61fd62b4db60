"""XLA-CPU's unstable-sort order of walk rows: the CUDA kernel and its twin.

The JAX package co-sorts each walk row's visits by node id with
``jax.lax.sort(..., num_keys=1, is_stable=False)``
(sph_tpu/ops/walks.py ``_accumulate``), and XLA's CPU backend sorts each
row with libstdc++'s std::sort, comparing the ids alone.  The run sums
that follow are ``cumsum(x) - cummax(base)`` over the whole sorted row, so
every prefix, and with it every weighted run total, depends on where equal
ids land.  ``xla_sort_order`` gives that order:

- on a CUDA tensor the kernel ``csrc/walk_row_sort.cu`` (std::sort's
  introsort with each partition taken by ballots: a warp a row up to
  ``WARP_COLS`` keys, a block a row above, staged in shared memory
  ``STAGE_COLS`` keys at a time; counted in ``xla_sort_order.launches``);
- on a CPU tensor the C++ twin ``native/xla_sort.cpp``, which calls
  std::sort itself.

No torch op gives this order (``torch.sort(stable=False)`` and CUB's
segmented sorts leave equal keys in orders of their own), so the twin is
the plain version.  ``introsort_order_reference`` is std::sort in Python,
step for step; ``ballot_introsort_order_reference`` sorts a row as the
kernel does (``ballot_partition_reference`` for each partition, each leaf
sorted stably as it is made); the tests hold both against the twin where
there is no nvcc.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import _launch

THRESHOLD = 16       # std::sort's _S_threshold
LANE_RANGE = 32      # the kernel's lanes finish ranges of up to this many
                     # keys alone (kLaneRange)
WARP_COLS = 2048     # rows of up to this many keys: a warp a row (kWarpCols)
STAGE_COLS = 16384   # wider rows, a block a row: ranges of up to this many
                     # keys (half as many when such rows number two or more
                     # an SM) are sorted in shared memory (kStageCols),
                     # wider ones partitioned in the order buffer with a
                     # table in the int32 scratch [R, S]


def _check_keys(keys: torch.Tensor):
    if keys.dim() != 2:
        raise ValueError(f"xla_sort_order: keys must be [R, S], got "
                         f"{tuple(keys.shape)}")
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"xla_sort_order: keys must be int32 or int64, got "
                        f"{keys.dtype}")


def xla_sort_order(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The order [R, S] (int64) in which XLA-CPU's unstable sort leaves each
    row of `keys` [R, S] (int32 values; int64 tensors are narrowed, as the
    JAX package's int32 ids are), and the sorted keys [R, S] (int32).  The
    kernel on a CUDA tensor, the C++ twin on a CPU one; a CUDA tensor never
    takes the twin."""
    _check_keys(keys)
    if keys.device.type == "cpu":
        return walk_row_sort_reference(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"xla_sort_order: no kernel for {keys.device}")
    k32 = keys.to(torch.int32).contiguous()
    rows, cols = k32.shape
    order = torch.empty((rows, cols), dtype=torch.int64, device=keys.device)
    out = torch.empty((rows, cols), dtype=torch.int32, device=keys.device)
    # the partition tables of ranges wider than a block stages
    scratch = (torch.empty((rows, cols), dtype=torch.int32,
                           device=keys.device) if cols > STAGE_COLS else None)
    if rows and cols:
        _launch("walk_row_sort", keys.device, k32.data_ptr(), rows, cols,
                out.data_ptr(), order.data_ptr(),
                None if scratch is None else scratch.data_ptr())
        xla_sort_order.launches += 1
    return order, out


# launches of walk_row_sort (the kernel), counted where the kernel launches
xla_sort_order.launches = 0


def walk_row_sort_reference(keys: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The twin of ``xla_sort_order``: libstdc++'s std::sort over (key,
    position) pairs, row by row, in C++ (``native.xla_sort_order``); the
    order and the sorted keys on the keys' device."""
    from .. import native
    _check_keys(keys)
    k = keys.detach().to(device="cpu", dtype=torch.int32).numpy()
    order, out = native.xla_sort_order(k)
    return (torch.from_numpy(order).to(keys.device),
            torch.from_numpy(out).to(keys.device))


# ---------------------------------------------------------------- reference
# libstdc++'s std::sort (bits/stl_algo.h, bits/stl_heap.h) as the kernel
# runs it, over a list of items compared with `less`.  `stats` (a dict)
# counts the ranges that reached the depth limit (the heap path).

def _median_to_first(v, less, result, a, b, c):
    if less(v[a], v[b]):
        if less(v[b], v[c]):
            v[result], v[b] = v[b], v[result]
        elif less(v[a], v[c]):
            v[result], v[c] = v[c], v[result]
        else:
            v[result], v[a] = v[a], v[result]
    elif less(v[a], v[c]):
        v[result], v[a] = v[a], v[result]
    elif less(v[b], v[c]):
        v[result], v[c] = v[c], v[result]
    else:
        v[result], v[b] = v[b], v[result]


def _unguarded_partition(v, less, first, last, pivot):
    while True:
        while less(v[first], v[pivot]):
            first += 1
        last -= 1
        while less(v[pivot], v[last]):
            last -= 1
        if not first < last:
            return first
        v[first], v[last] = v[last], v[first]
        first += 1


def _push_heap(v, less, first, hole, top, value):
    parent = (hole - 1) // 2
    while hole > top and less(v[first + parent], value):
        v[first + hole] = v[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    v[first + hole] = value


def _adjust_heap(v, less, first, hole, length, value):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(v[first + second], v[first + second - 1]):
            second -= 1
        v[first + hole] = v[first + second]
        hole = second
    if length % 2 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        v[first + hole] = v[first + second - 1]
        hole = second - 1
    _push_heap(v, less, first, hole, top, value)


def _heap_sort(v, less, first, last):
    length = last - first
    if length >= 2:
        parent = (length - 2) // 2
        while True:
            _adjust_heap(v, less, first, parent, length, v[first + parent])
            if parent == 0:
                break
            parent -= 1
    while last - first > 1:
        last -= 1
        value = v[last]
        v[last] = v[first]
        _adjust_heap(v, less, first, 0, last - first, value)


def _unguarded_linear_insert(v, less, last):
    val = v[last]
    nxt = last - 1
    while less(val, v[nxt]):
        v[last] = v[nxt]
        last = nxt
        nxt -= 1
    v[last] = val


def _insertion_sort(v, less, first, last):
    if first == last:
        return
    for i in range(first + 1, last):
        if less(v[i], v[first]):
            val = v[i]
            v[first + 1:i + 1] = v[first:i]
            v[first] = val
        else:
            _unguarded_linear_insert(v, less, i)


def introsort(v: list, less, stats: dict | None = None,
              depth: int | None = None) -> list:
    """Sort `v` in place as libstdc++'s std::sort does, with an explicit
    stack for the recursion on [cut, last), from depth limit `depth`
    (std::sort's 2 * lg(n) by default; a subrange's own within a larger
    sort); returns `v`."""
    n = len(v)
    if n == 0:
        return v
    stack = [(0, n, 2 * (n.bit_length() - 1) if depth is None else depth)]
    while stack:
        first, last, depth = stack.pop()
        while last - first > THRESHOLD:
            if depth == 0:
                if stats is not None:
                    stats["heap"] = stats.get("heap", 0) + 1
                _heap_sort(v, less, first, last)
                break
            depth -= 1
            mid = first + (last - first) // 2
            _median_to_first(v, less, first, first + 1, mid, last - 1)
            cut = _unguarded_partition(v, less, first + 1, last, first)
            stack.append((cut, last, depth))
            last = cut
    if n > THRESHOLD:
        _insertion_sort(v, less, 0, THRESHOLD)
        for i in range(THRESHOLD, n):
            _unguarded_linear_insert(v, less, i)
    else:
        _insertion_sort(v, less, 0, n)
    return v


def introsort_order_reference(keys, stats: dict | None = None) -> list:
    """The order std::sort leaves one row of keys in (a list of positions),
    in pure Python."""
    items = [(int(k), i) for i, k in enumerate(keys)]
    introsort(items, lambda a, b: a[0] < b[0], stats)
    return [i for _, i in items]


def ballot_partition_reference(keys, first: int, last: int):
    """``_unguarded_partition(first + 1, last, first)`` of `keys` by the
    kernel's rule, all stops at once.  With p = keys[first], a left stop is
    a key >= p and a right stop a key <= p in [first + 1, last);
    rankL(i) counts the left stops in [first + 1, i) and sufR(i) the right
    stops in (i, last).  A left stop swaps iff sufR(i) > rankL(i), with
    R[rankL(i)] (R[k]: the right stop with k right stops to its right); R[k]
    is needed iff rankL(R[k]) > k.  The kernel's table holds R[k] at
    first + k and L[k] at last - 1 - k for k < K, which never meet
    (2K < last - first).  The cut is L[0] for K = 0, else min(L[K],
    R[K - 1]), L[K] the first left stop that does not swap.

    Returns (cut, pairs [K, 2] of (L[k], R[k]), K, the keys after the
    swaps)."""
    keys = np.asarray(keys)
    p = keys[first]
    pos = np.arange(first + 1, last)
    seg = keys[first + 1:last]
    left, right = seg >= p, seg <= p
    rank_l = np.cumsum(left) - left
    suf_r = np.cumsum(right[::-1])[::-1] - right
    swap = left & (suf_r > rank_l)
    need_r = right & (rank_l > suf_r)
    k = int(swap.sum())
    table = np.full(last - first, -1, np.int64)
    table[last - 1 - first - rank_l[swap]] = pos[swap]
    table[suf_r[need_r]] = pos[need_r]
    assert int(need_r.sum()) == k and 2 * k < last - first
    pairs = np.stack([table[last - 1 - first - np.arange(k)],
                      table[np.arange(k)]], axis=1)
    stay = pos[left & ~swap]
    lk = int(stay[0]) if stay.size else last
    cut = lk if k == 0 else min(lk, int(pairs[k - 1, 1]))
    out = keys.copy()
    out[pairs[:, 0]], out[pairs[:, 1]] = keys[pairs[:, 1]], keys[pairs[:, 0]]
    return cut, pairs, k, out


def ballot_introsort_order_reference(keys, stats: dict | None = None,
                                     lane_range: int = THRESHOLD) -> list:
    """The order std::sort leaves one row of keys in, computed as the kernel
    computes it: introsort's loop with each partition by
    ``ballot_partition_reference``, each leaf (a range of <= THRESHOLD keys
    that the loop leaves) sorted stably as soon as it is made, the heap path
    at depth 0 as std::sort takes it.  std::sort's final insertion sort
    moves no key across a leaf's edge (every key left of a leaf is <= every
    key in it), so it is the stable sort of each leaf.  A range of <=
    `lane_range` keys is finished as the kernel's lanes finish theirs
    (LANE_RANGE): std::sort's loop with libstdc++'s own partition, then a
    stable sort of the range."""
    k = np.array(keys, dtype=np.int64)
    pos = np.arange(len(k))
    n = len(k)
    if n == 0:
        return []
    less = lambda a, b: a[0] < b[0]  # noqa: E731
    stack = [(0, n, 2 * (n.bit_length() - 1))]
    while stack:
        first, last, depth = stack.pop()
        if THRESHOLD < last - first <= lane_range:
            # std::sort's final insertion sort over the range alone is the
            # stable sort of its leaves
            items = introsort(list(zip(k[first:last].tolist(),
                                       pos[first:last].tolist())),
                              less, stats, depth)
            k[first:last] = [a for a, _ in items]
            pos[first:last] = [b for _, b in items]
            continue
        while last - first > THRESHOLD:
            if depth == 0:
                if stats is not None:
                    stats["heap"] = stats.get("heap", 0) + 1
                items = list(zip(k[first:last].tolist(),
                                 pos[first:last].tolist()))
                _heap_sort(items, less, 0, len(items))
                k[first:last] = [a for a, _ in items]
                pos[first:last] = [b for _, b in items]
                break
            depth -= 1
            four = [first, first + 1, first + (last - first) // 2, last - 1]
            sub = [(int(k[i]), int(pos[i])) for i in four]
            _median_to_first(sub, less, 0, 1, 2, 3)
            k[four] = [a for a, _ in sub]
            pos[four] = [b for _, b in sub]
            cut, pairs, _, k = ballot_partition_reference(k, first, last)
            pos[pairs[:, 0]], pos[pairs[:, 1]] = (pos[pairs[:, 1]],
                                                  pos[pairs[:, 0]])
            stack.append((cut, last, depth))
            last = cut
        else:
            leaf = np.argsort(k[first:last], kind="stable") + first
            k[first:last], pos[first:last] = k[leaf], pos[leaf]
    return pos.tolist()


def median_of_3_adversary(n: int):
    """Keys [n] int32 that drive std::sort to its depth limit (the heap
    path): McIlroy's adversary ("A killer adversary for quicksort", 1999)
    played against ``introsort``, which compares as std::sort does."""
    gas = n
    val = [gas] * n
    state = {"solid": 0, "candidate": 0}

    def less(x, y):
        if val[x] == gas and val[y] == gas:
            z = x if x == state["candidate"] else y
            val[z] = state["solid"]
            state["solid"] += 1
        if val[x] == gas:
            state["candidate"] = x
        elif val[y] == gas:
            state["candidate"] = y
        return val[x] < val[y]

    introsort(list(range(n)), less)
    return np.asarray(val, dtype=np.int32)
