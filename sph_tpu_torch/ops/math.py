"""Host numeric helpers the main path uses (copied from sph_tpu/ops/math.py,
which uses no jax; reference: sph/utils/Math.hpp/.cpp)."""

from __future__ import annotations

from typing import Iterable

import numpy as np


def compute_quantile(data: np.ndarray, quantile: float,
                     ignore_vals: Iterable[float] = (),
                     interpolation: int = 0) -> float:
    """Quantile with ignore values (reference: Math.cpp:133-165).

    interpolation == 1: linear between neighbors; otherwise midpoint.
    Returns a negative value if no data remains after filtering (callers treat
    that as "could not find percentile", ImageHierarchy.cpp:379-385).
    """
    arr = np.asarray(data, dtype=np.float32).ravel()
    ignore_vals = list(ignore_vals)
    if ignore_vals:
        mask = np.ones(arr.shape, dtype=bool)
        for v in ignore_vals:
            mask &= arr != np.float32(v)
        arr = arr[mask]
    if arr.size == 0:
        return -1.0
    arr = np.sort(arr)
    rank = quantile * (arr.size - 1)
    lo = int(np.floor(rank))
    hi = int(np.ceil(rank))
    if lo == hi:
        return float(arr[lo])
    frac = rank - lo
    if interpolation == 1:
        return float(arr[lo] + (arr[hi] - arr[lo]) * frac)
    return float(0.5 * (arr[lo] + arr[hi]))


def random_disk_init(n: int, radius: float, seed: int = 0) -> np.ndarray:
    """Uniform random points in a disk of given radius via polar sampling
    (reference: Math.cpp:264-277 randomVec — sqrt(u) radial distribution)."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.random(n, dtype=np.float32))
    t = 2.0 * np.pi * rng.random(n, dtype=np.float32)
    return np.stack([r * np.cos(t), r * np.sin(t)], axis=1).astype(np.float32)
