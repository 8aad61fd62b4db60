"""Host graph ops and the LZ4 block codec in C++, bound with ctypes.

The port builds its own copy of the JAX package's C++ source,
``sph_tpu_torch/native/graphops.cpp`` (held byte-equal to
``sph_tpu/native/graphops.cpp`` by a test), with g++ into
``sph_tpu_torch/_build/`` at first use, ``libm_pow.c``, the C
library's float32 pow over an array, with gcc, and ``xla_sort.cpp``,
XLA-CPU's unstable-sort order of int32 rows, with g++.  The library is
named by the source's content hash, so an edited source is rebuilt.  A
failed build raises: these ops have no Python fallback in the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "graphops.cpp")
LIBM_POW_SRC = os.path.join(_PKG, "native", "libm_pow.c")
XLA_SORT_SRC = os.path.join(_PKG, "native", "xla_sort.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_lib: Optional[ctypes.CDLL] = None


def _build(src: str = SRC, name: str = "graphops",
           flags: tuple = ("g++", "-O3", "-march=native", "-std=c++17")
           ) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [*flags, "-shared", "-fPIC", src, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native: building {src} failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


_libm_pow: Optional[ctypes.CDLL] = None


def powf(x: np.ndarray, e: float) -> np.ndarray:
    """float32 x ** e element by element through the C library's powf
    (``libm_pow.c``): XLA-CPU's pow, bit for bit, where torch's CPU pow
    (SLEEF) differs by an ulp in about one element in ten."""
    global _libm_pow
    if _libm_pow is None:
        lib = ctypes.CDLL(_build(LIBM_POW_SRC, "libm_pow",
                                 ("gcc", "-O2", "-fno-fast-math")))
        lib.powf_array.restype = None
        lib.powf_array.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_float,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
        _libm_pow = lib
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty_like(x)
    _libm_pow.powf_array(x, x.size, e, out)
    return out


_xla_sort: Optional[ctypes.CDLL] = None


def xla_sort_order(keys: np.ndarray, threads: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The order in which XLA-CPU's unstable sort (``jax.lax.sort(...,
    num_keys=1, is_stable=False)``) leaves each row of int32 keys [R, S]:
    libstdc++'s std::sort over (key, position) pairs with a key-only `<`
    (``xla_sort.cpp``).  Returns the order [R, S] int64 and the sorted
    keys [R, S] int32.  Rows are spread over `threads` threads (0: the
    machine's cores); the result does not depend on it."""
    global _xla_sort
    if _xla_sort is None:
        lib = ctypes.CDLL(_build(XLA_SORT_SRC, "xla_sort",
                                 ("g++", "-O2", "-std=c++17", "-pthread")))
        lib.xla_sort_order.restype = None
        lib.xla_sort_order.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        _xla_sort = lib
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    if keys.ndim != 2:
        raise ValueError(f"native.xla_sort_order: keys must be [R, S], got "
                         f"{keys.shape}")
    rows, cols = keys.shape
    order = np.empty((rows, cols), dtype=np.int64)
    out = np.empty((rows, cols), dtype=np.int32)
    threads = int(threads) or (os.cpu_count() or 1)
    # a thread is worth starting for about 2^16 keys
    threads = max(1, min(threads, rows * cols >> 16))
    _xla_sort.xla_sort_order(keys, rows, cols, threads, order, out)
    return order, out


def get_lib() -> ctypes.CDLL:
    """Load the library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    i64 = ctypes.c_int64
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.weak_components.restype = i64
    lib.weak_components.argtypes = [i64, i64, p_i32, p_i64]
    lib.edge_list_components.restype = i64
    lib.edge_list_components.argtypes = [i64, i64, p_i64, p_i64, p_i64]
    lib.symmetrize_degrees.restype = i64
    lib.symmetrize_degrees.argtypes = [i64, i64, p_i32, p_f32, p_i64]
    lib.symmetrize_fill.restype = None
    lib.symmetrize_fill.argtypes = [i64, i64, p_i32, p_f32, i64, p_i32,
                                    p_f32, p_i32]
    lib.argsort_i64.restype = None
    lib.argsort_i64.argtypes = [p_i64, i64, p_i64]
    lib.merge_sum.restype = i64
    lib.merge_sum.argtypes = [i64, i64, p_i32, p_f32, p_i64, i64,
                              ctypes.c_int, p_i64, p_i32, p_f32]
    lib.merge_min.restype = i64
    lib.merge_min.argtypes = [i64, i64, p_i32, p_f32, p_i64, i64,
                              p_i64, p_i32, p_f32]
    lib.pack_rows.restype = None
    lib.pack_rows.argtypes = [i64, p_i64, p_i32, p_f32, i64, i64, p_i32,
                              p_f32]
    lib.umap_sequential.restype = None
    lib.umap_sequential.argtypes = [i64, p_f32, i64, p_i32, p_i32, p_f32,
                                    i64, ctypes.c_float, ctypes.c_float,
                                    ctypes.c_float, i64, ctypes.c_uint64]
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.lz4_compress_bound.restype = i64
    lib.lz4_compress_bound.argtypes = [i64]
    lib.lz4_compress.restype = i64
    lib.lz4_compress.argtypes = [p_u8, i64, p_u8, i64]
    lib.lz4_decompress.restype = i64
    lib.lz4_decompress.argtypes = [p_u8, i64, p_u8, i64]
    _lib = lib
    return lib


def _checked(count: int, what: str) -> int:
    if count < 0:
        raise ValueError(f"native.{what}: a neighbor or endpoint id lies "
                         "outside [0, num_nodes)")
    return int(count)


def weak_components(indices: np.ndarray) -> tuple[int, np.ndarray]:
    """Weak CC over a padded [n, k] adjacency (-1 pads); labels in order of
    first appearance."""
    n, k = indices.shape
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    labels = np.empty(n, dtype=np.int64)
    ncc = _checked(get_lib().weak_components(n, k, idx, labels),
                   "weak_components")
    return ncc, labels


def edge_list_components(num_nodes: int, src: np.ndarray, dst: np.ndarray
                         ) -> tuple[int, np.ndarray]:
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    labels = np.empty(num_nodes, dtype=np.int64)
    ncc = _checked(get_lib().edge_list_components(num_nodes, len(src), src,
                                                  dst, labels),
                   "edge_list_components")
    return ncc, labels


def merge_sum(indices: np.ndarray, values: np.ndarray, parents: np.ndarray,
              num_merged: int, weight_by_size: bool) -> tuple:
    """Sparse merge accumulation: (rows i64, cols i32, sums f32) sorted by
    (row, col)."""
    n, r = indices.shape
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    val = np.ascontiguousarray(values, dtype=np.float32)
    par = np.ascontiguousarray(parents, dtype=np.int64)
    cap = n * r
    out_rows = np.empty(cap, dtype=np.int64)
    out_cols = np.empty(cap, dtype=np.int32)
    out_vals = np.empty(cap, dtype=np.float32)
    m = _checked(get_lib().merge_sum(n, r, idx, val, par, num_merged,
                                     1 if weight_by_size else 0,
                                     out_rows, out_cols, out_vals),
                 "merge_sum")
    return out_rows[:m], out_cols[:m], out_vals[:m]


def merge_min(indices: np.ndarray, values: np.ndarray, parents: np.ndarray,
              num_merged: int) -> tuple:
    """Min-merge accumulation; see merge_sum."""
    n, r = indices.shape
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    val = np.ascontiguousarray(values, dtype=np.float32)
    par = np.ascontiguousarray(parents, dtype=np.int64)
    cap = n * r
    out_rows = np.empty(cap, dtype=np.int64)
    out_cols = np.empty(cap, dtype=np.int32)
    out_vals = np.empty(cap, dtype=np.float32)
    m = _checked(get_lib().merge_min(n, r, idx, val, par, num_merged,
                                     out_rows, out_cols, out_vals),
                 "merge_min")
    return out_rows[:m], out_cols[:m], out_vals[:m]


def argsort_i64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative int64 keys (an LSD radix sort of
    (key, index) composites); raises on a negative key."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if keys.size and int(keys.min()) < 0:
        raise ValueError("native.argsort_i64: the radix sort takes "
                         "non-negative keys only")
    order = np.empty(len(keys), dtype=np.int64)
    get_lib().argsort_i64(keys, len(keys), order)
    return order


def pack_rows(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              n: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Ragged -> padded packing of row-sorted (row, col, val) triples."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    out_idx = np.empty((n, width), dtype=np.int32)
    out_val = np.empty((n, width), dtype=np.float32)
    get_lib().pack_rows(len(rows), rows, cols, vals, n, width, out_idx,
                        out_val)
    return out_idx, out_val


def umap_sequential(embedding: np.ndarray, src: np.ndarray,
                    dst: np.ndarray, eps: np.ndarray, n_epochs: int,
                    a: float, b: float, initial_alpha: float = 1.0,
                    neg_rate: int = 5, seed: int = 42) -> np.ndarray:
    """Sequential UMAP layout optimisation, the oracle of the batched
    epochs (models/umap.py): umappp's per-edge order (reference:
    EmbedUmap.cpp:233-269), one edge after another, with its own negative
    sample stream.  Edges (src, dst, eps = epochs per sample) must cover
    both directions.  Returns the optimised [n, 2] layout."""
    emb = np.ascontiguousarray(embedding, dtype=np.float32).copy()
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    eps = np.ascontiguousarray(eps, dtype=np.float32)
    get_lib().umap_sequential(emb.shape[0], emb, len(src), src, dst, eps,
                              n_epochs, a, b, initial_alpha, neg_rate, seed)
    return emb


def symmetrize(indices: np.ndarray, distances: np.ndarray,
               max_width: int = 0) -> tuple:
    """Undirected union with min-distance dedup; returns (out_idx, out_dist,
    counts).  max_width > 0 caps the row width (hub rows keep their closest
    edges)."""
    n, k = indices.shape
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    dist = np.ascontiguousarray(distances, dtype=np.float32)
    degrees = np.empty(n, dtype=np.int64)
    lib = get_lib()
    max_deg = _checked(lib.symmetrize_degrees(n, k, idx, dist, degrees),
                       "symmetrize")
    width = max_deg + 1
    if max_width > 0:
        width = min(width, max_width)
    out_idx = np.empty((n, width), dtype=np.int32)
    out_dist = np.empty((n, width), dtype=np.float32)
    counts = np.empty(n, dtype=np.int32)
    lib.symmetrize_fill(n, k, idx, dist, width, out_idx, out_dist, counts)
    return out_idx, out_dist, counts


def lz4_compress_bound(n: int) -> int:
    """The most bytes an LZ4 block of `n` input bytes can take."""
    return int(get_lib().lz4_compress_bound(int(n)))


def lz4_compress(data: bytes | np.ndarray) -> bytes:
    """LZ4 block-compress raw bytes (graphops.cpp's codec, the JAX package's
    bytes)."""
    src = (np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes)
           else np.ascontiguousarray(data, dtype=np.uint8).ravel())
    cap = lz4_compress_bound(src.size)
    dst = np.empty(max(cap, 1), dtype=np.uint8)
    m = get_lib().lz4_compress(src if src.size else np.zeros(1, np.uint8),
                               src.size, dst, cap)
    if m < 0:
        raise ValueError("native.lz4_compress: output buffer too small")
    return dst[:m].tobytes()


def lz4_decompress(data: bytes, original_size: int) -> bytes:
    """Decompress an LZ4 block of known decompressed size; raises on a
    malformed block."""
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(max(int(original_size), 1), dtype=np.uint8)
    m = get_lib().lz4_decompress(src if src.size else np.zeros(1, np.uint8),
                                 src.size, dst, int(original_size))
    if m != original_size:
        raise ValueError("native.lz4_decompress: corrupt LZ4 block")
    return dst[:original_size].tobytes()
