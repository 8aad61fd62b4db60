"""XLA-CPU's unstable-sort order of walk rows: the CUDA kernel and its twin.

The JAX package co-sorts each walk row's visits by node id with
``jax.lax.sort(..., num_keys=1, is_stable=False)``
(sph_tpu/ops/walks.py ``_accumulate``), and XLA's CPU backend sorts each
row with libstdc++'s std::sort, comparing the ids alone.  The run sums
that follow are ``cumsum(x) - cummax(base)`` over the whole sorted row, so
every prefix, and with it every weighted run total, depends on where equal
ids land.  ``xla_sort_order`` gives that order:

- on a CUDA tensor the kernel ``csrc/walk_row_sort.cu`` (std::sort
  transcribed function by function, one thread a row; counted in
  ``xla_sort_order.launches``);
- on a CPU tensor the C++ twin ``native/xla_sort.cpp``, which calls
  std::sort itself.

No torch op gives this order (``torch.sort(stable=False)`` and CUB's
segmented sorts leave equal keys in orders of their own), so the twin is
the plain version.  ``introsort_order_reference`` is the same algorithm in
Python, step for step as the kernel runs it; the tests hold it against the
twin where there is no nvcc.
"""

from __future__ import annotations

import torch

from .cuda_build import _launch

THRESHOLD = 16       # std::sort's _S_threshold
SHARED_COLS = 3072   # the kernel stages rows of up to this many keys in
                     # shared memory (kSharedCols), sorts wider ones in place


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
    if rows and cols:
        _launch("walk_row_sort", keys.device, k32.data_ptr(), rows, cols,
                out.data_ptr(), order.data_ptr())
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


def introsort(v: list, less, stats: dict | None = None) -> list:
    """Sort `v` in place as libstdc++'s std::sort does, with the explicit
    stack of ``csrc/walk_row_sort.cu``; returns `v`."""
    n = len(v)
    if n == 0:
        return v
    stack = [(0, n, 2 * (n.bit_length() - 1))]
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


def median_of_3_adversary(n: int):
    """Keys [n] int32 that drive std::sort to its depth limit (the heap
    path): McIlroy's adversary ("A killer adversary for quicksort", 1999)
    played against ``introsort``, which compares as std::sort does."""
    import numpy as np
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
