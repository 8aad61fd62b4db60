"""Data containers and input scalers.

Reference: sph/utils/Data.hpp:33-115 (flat row-major float matrix numPoints x
numDimensions) and sph/utils/Scaler.cpp:15-47 (NONE/STANDARD/UNIFORM/ROBUST).

A copy of sph_tpu/data.py (it uses no jax): the "flat matrix + image shape"
model, with the matrix kept as one host [N, D] float32 array that each stage
moves to its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .settings import Scaler
from .utils.logging import Log


@dataclass
class ImageStack:
    """A hyperspectral or RGB image as a pixel-major data matrix.

    data: [num_points, num_dims] float32, pixel-major (row * cols + col)
    rows/cols: spatial extent; data.shape[0] == rows * cols
    name: identifier used for cache keys / output folders
    """

    data: np.ndarray
    rows: int
    cols: int
    name: str = ""

    def __post_init__(self):
        self.data = np.ascontiguousarray(self.data, dtype=np.float32)
        if self.data.ndim == 3:
            r, c, d = self.data.shape
            if self.rows in (0, None):
                self.rows, self.cols = r, c
            self.data = self.data.reshape(r * c, d)
        assert self.data.ndim == 2
        assert self.data.shape[0] == self.rows * self.cols, (
            f"data has {self.data.shape[0]} points, expected "
            f"{self.rows}x{self.cols}")

    @property
    def num_points(self) -> int:
        return self.data.shape[0]

    @property
    def num_dimensions(self) -> int:
        return self.data.shape[1]

    @classmethod
    def from_array(cls, img: np.ndarray, name: str = "") -> "ImageStack":
        """Build from an [rows, cols, channels] array."""
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = img[:, :, None]
        r, c, d = img.shape
        return cls(img.reshape(r * c, d), r, c, name)

    def to_image(self) -> np.ndarray:
        return self.data.reshape(self.rows, self.cols, self.num_dimensions)


def scale(data: np.ndarray, scaler: Scaler) -> np.ndarray:
    """Scale a [N, D] data matrix (reference: sph/utils/Scaler.cpp:15-47).

    STANDARD: channel-wise (x - mean) / std
    UNIFORM:  channel-wise x / max   (reference normalizeUniform divides by the
              channel max; zero-max channels are left untouched)
    ROBUST:   clamp to the global 95-percentile then divide by it
    """
    data = np.asarray(data, dtype=np.float32)
    if scaler == Scaler.NONE:
        return data
    if scaler == Scaler.STANDARD:
        mean = data.mean(axis=0)
        std = data.std(axis=0, ddof=0)
        std = np.where(std == 0, 1.0, std)
        return ((data - mean) / std).astype(np.float32)
    if scaler == Scaler.UNIFORM:
        mx = data.max(axis=0)
        mx = np.where(mx == 0, 1.0, mx)
        return (data / mx).astype(np.float32)
    if scaler == Scaler.ROBUST:
        from .ops.math import compute_quantile
        q95 = compute_quantile(data.ravel(), 0.95, interpolation=1)
        if q95 == 0:
            Log.warn("scale(ROBUST): 95-percentile is 0, returning data as-is")
            return data
        return (np.clip(data, 0.0, q95) / q95).astype(np.float32)
    raise ValueError(f"unknown scaler {scaler}")
