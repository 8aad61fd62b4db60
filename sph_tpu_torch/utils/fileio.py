"""LZ4-compressed binary (de)serialization.

Port of sph_tpu/utils/fileio.py (reference: sph/utils/FileIO.hpp —
writeCompressedVecToBinary / readCompressedVecFromBinary and the vec-of-vec
/ Graph / sparse-matrix wrappers, chunked above lz4's INT_MAX bound,
FileIO.hpp:207-292).  The container is the JAX package's, so archives either
package writes load in the other (little-endian):

  magic 'SPH4' | u32 version | u8 codec | dtype tag (8 bytes, NUL-padded)
  u64 total_bytes | u64 num_items | u32 num_chunks
  per chunk: u64 raw_bytes | u64 comp_bytes | payload

Writing always takes codec 1, the LZ4 block codec of the port's
native/graphops.cpp, and raises if that library does not build.  Reading
takes codec 1 and codec 0 (zlib), which the JAX package writes when its own
native library is missing.  SPH_FILEIO_CHUNK overrides the chunk size.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import BinaryIO, List, Sequence

import numpy as np

from .. import native

_MAGIC = b"SPH4"
_VERSION = 1
_CODEC_ZLIB = 0
_CODEC_LZ4 = 1
_HEADER = "<IB8sQQI"
# lz4's c_int bound, less slack for expansion (FileIO.hpp:207-292)
_DEFAULT_CHUNK = (1 << 31) - (1 << 24)


def _chunk_bytes() -> int:
    return int(os.environ.get("SPH_FILEIO_CHUNK", _DEFAULT_CHUNK))


def _decompress(codec: int, comp: bytes, raw_size: int) -> bytes:
    if codec == _CODEC_LZ4:
        return native.lz4_decompress(comp, raw_size)
    if codec == _CODEC_ZLIB:
        raw = zlib.decompress(comp)
        if len(raw) != raw_size:
            raise ValueError("corrupt zlib chunk: size mismatch")
        return raw
    raise ValueError(f"unknown codec {codec}")


def write_compressed_vec(f: BinaryIO | str, arr: np.ndarray) -> None:
    """Compressed dump of `arr`'s flat bytes, in chunks above the lz4
    bound."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            write_compressed_vec(fh, arr)
        return
    arr = np.ascontiguousarray(arr)
    raw = arr.tobytes()
    chunk = max(_chunk_bytes(), 1)
    n_chunks = max(1, (len(raw) + chunk - 1) // chunk)
    dtag = arr.dtype.str.encode()[:8].ljust(8, b"\0")
    pieces = [raw[i * chunk:(i + 1) * chunk] for i in range(n_chunks)]
    f.write(_MAGIC)
    f.write(struct.pack(_HEADER, _VERSION, _CODEC_LZ4, dtag, len(raw),
                        arr.size, n_chunks))
    for piece in pieces:
        comp = native.lz4_compress(piece)
        f.write(struct.pack("<QQ", len(piece), len(comp)))
        f.write(comp)


def read_compressed_vec(f: BinaryIO | str) -> np.ndarray:
    """Inverse of write_compressed_vec; returns a 1-D array."""
    if isinstance(f, str):
        with open(f, "rb") as fh:
            return read_compressed_vec(fh)
    magic = f.read(4)
    if magic != _MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    version, codec, dtag, total, num_items, n_chunks = struct.unpack(
        _HEADER, f.read(struct.calcsize(_HEADER)))
    if version != _VERSION:
        raise ValueError(f"unsupported version {version}")
    out = bytearray()
    for _ in range(n_chunks):
        raw_size, comp_size = struct.unpack("<QQ", f.read(16))
        out += _decompress(codec, f.read(comp_size), raw_size)
    if len(out) != total:
        raise ValueError("corrupt file: payload size mismatch")
    arr = np.frombuffer(bytes(out), dtype=np.dtype(dtag.rstrip(b"\0")
                                                   .decode()))
    if arr.size != num_items:
        raise ValueError("corrupt file: item count mismatch")
    return arr


def write_compressed_vec_of_vec(f: BinaryIO | str,
                                vecs: Sequence[np.ndarray]) -> None:
    """Ragged list of 1-D arrays: a lengths section, then the flat
    concatenation, both compressed."""
    if isinstance(f, str):
        with open(f, "wb") as fh:
            write_compressed_vec_of_vec(fh, vecs)
        return
    lengths = np.array([len(v) for v in vecs], dtype=np.int64)
    flat = (np.concatenate([np.asarray(v).ravel() for v in vecs])
            if len(vecs) else np.empty(0, np.float32))
    write_compressed_vec(f, lengths)
    write_compressed_vec(f, flat)


def read_compressed_vec_of_vec(f: BinaryIO | str) -> List[np.ndarray]:
    if isinstance(f, str):
        with open(f, "rb") as fh:
            return read_compressed_vec_of_vec(fh)
    lengths = read_compressed_vec(f)
    flat = read_compressed_vec(f)
    offs = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])
    return [flat[offs[i]:offs[i + 1]] for i in range(len(lengths))]


def _write_sections(path: str, *arrays) -> None:
    with open(path, "wb") as f:
        for a in arrays:
            write_compressed_vec(f, a)


def write_knn_graph(path: str, graph) -> None:
    """KnnGraph (fixed k; reference writeGraphToBinary for KGraph)."""
    _write_sections(path, np.array(graph.indices.shape, dtype=np.int64),
                    graph.indices, graph.distances)


def read_knn_graph(path: str):
    from ..ops.graph import KnnGraph
    with open(path, "rb") as f:
        n, k = read_compressed_vec(f)
        idx = read_compressed_vec(f).reshape(n, k)
        dist = read_compressed_vec(f).reshape(n, k)
    return KnnGraph(idx, dist)


def write_padded_graph(path: str, graph) -> None:
    """PaddedGraph (variable k; reference writeGraphToBinary for Graph)."""
    _write_sections(path, np.array(graph.indices.shape, dtype=np.int64),
                    graph.indices, graph.distances, graph.counts)


def read_padded_graph(path: str):
    from ..ops.graph import PaddedGraph
    with open(path, "rb") as f:
        n, w = read_compressed_vec(f)
        idx = read_compressed_vec(f).reshape(n, w)
        dist = read_compressed_vec(f).reshape(n, w)
        counts = read_compressed_vec(f)
    return PaddedGraph(idx, dist, counts)


def write_sparse_rows(path: str, rows) -> None:
    """SparseRows, host copies in the JAX package's dtypes (reference
    writeSparseMatrixToBinary)."""
    _write_sections(path, np.array([rows.num_rows, rows.width,
                                    rows.num_cols], dtype=np.int64),
                    rows.indices, rows.values)


def read_sparse_rows(path: str, device=None):
    from ..ops.sparse import SparseRows
    with open(path, "rb") as f:
        n, w, num_cols = read_compressed_vec(f)
        idx = read_compressed_vec(f).reshape(n, w)
        val = read_compressed_vec(f).reshape(n, w)
    return SparseRows(idx, val, int(num_cols), device=device)


def write_dict(path: str, arrays: dict) -> None:
    """Named-array archive (LZ4 per section): the StageCache payload."""
    index = {k: [np.asarray(v).dtype.str, list(np.asarray(v).shape)]
             for k, v in arrays.items()}
    blob = np.frombuffer(json.dumps(index).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        write_compressed_vec(f, blob)
        for k in index:
            write_compressed_vec(f, np.ascontiguousarray(arrays[k]).ravel())


def read_dict(path: str) -> dict:
    out = {}
    with open(path, "rb") as f:
        index = json.loads(read_compressed_vec(f).tobytes().decode())
        for k, (dstr, shape) in index.items():
            out[k] = read_compressed_vec(f).astype(
                np.dtype(dstr), copy=False).reshape(shape)
    return out
