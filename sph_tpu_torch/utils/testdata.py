"""Seeded synthetic image stacks (copied from sph_tpu/utils/testdata.py, which
uses no jax).  numpy-based and deterministic given the seed, so both packages
build bit-identical inputs."""

from __future__ import annotations

import numpy as np


def create_hyperspectral_scene(rows: int, cols: int, channels: int = 200,
                               num_classes: int = 16, seed: int = 0,
                               noise: float = 0.02) -> np.ndarray:
    """Synthetic hyperspectral stack with Indian-Pines-like structure:
    a smooth multi-region class map (voronoi over random seeds) with
    per-class smooth spectral signatures plus noise."""
    rng = np.random.default_rng(seed)
    # voronoi-ish region map
    centers = rng.uniform(0, 1, (num_classes, 2))
    centers[:, 0] *= rows
    centers[:, 1] *= cols
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d = ((rr[..., None] - centers[:, 0]) ** 2
         + (cc[..., None] - centers[:, 1]) ** 2)
    # jitter boundaries so regions are irregular
    d = d * rng.uniform(0.7, 1.3, num_classes)
    cls = np.argmin(d, axis=-1)
    # smooth spectral signatures: sum of random gaussians over the band axis
    bands = np.linspace(0, 1, channels)
    sigs = np.zeros((num_classes, channels), dtype=np.float32)
    for c in range(num_classes):
        for _ in range(4):
            mu, sg, amp = rng.uniform(0, 1), rng.uniform(0.03, 0.3), (
                rng.uniform(0.2, 1.0))
            sigs[c] += amp * np.exp(-0.5 * ((bands - mu) / sg) ** 2)
    img = sigs[cls]  # [rows, cols, channels]
    img = img + noise * rng.standard_normal(img.shape).astype(np.float32)
    return img.astype(np.float32)


def create_checker_image(rows: int, cols: int, channels: int = 3,
                         block: int = 2, noise: float = 0.0,
                         seed: int = 1) -> np.ndarray:
    """Small synthetic image stack for hierarchy tests: a checkerboard of
    `block`-sized tiles with distinct channel signatures per tile class.
    Shape [rows, cols, channels] float32."""
    rng = np.random.default_rng(seed)
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    cls = ((rr // block) + (cc // block)) % 2
    base = np.stack([np.where(cls == 0, 0.1 * (c + 1), 1.0 - 0.1 * (c + 1))
                     for c in range(channels)], axis=-1)
    img = base.astype(np.float32)
    if noise:
        img = img + noise * rng.standard_normal(img.shape).astype(np.float32)
    return img


def create_clustered_points(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Clustered points in the recipe of benchmarks/bench_recall.py (the data
    behind the JAX package's recall records): max(32, sqrt(n) / 4) gaussian
    blobs with centres of scale 4 and unit noise, [n, d] float32."""
    rng = np.random.default_rng(seed)
    ncl = max(32, int(np.sqrt(n) / 4))
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 4.0
    labels = rng.integers(0, ncl, n)
    return (centers[labels]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(
                np.float32)
