"""t-SNE forces over a dense joint P: the CUDA kernel and its plain twin.

Replaces sph_tpu/ops/pallas/tsne_kernels.py::tsne_forces_dense, the TPU
kernel the t-SNE dense-P tier calls on every iteration.  The kernel is
``csrc/tsne_forces_dense.cu``, compiled with nvcc for sm_90a into a shared
library with a plain C entry point and loaded with ctypes.  Its source notes
what bounds it and how it is laid out.

``tsne_forces_dense`` launches the kernel for CUDA tensors and counts each
launch in ``tsne_forces_dense.launches``.  A CPU tensor goes to
``tsne_forces_dense_reference``, the same seven row sums as plain torch ops;
a CUDA tensor never does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "tsne_forces_dense.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("tsne_forces_dense: nvcc not found (looked on "
                           f"PATH and at {path})")
    return path


def build() -> str:
    """Compile the kernel into BUILD_DIR (once per source content and
    flags) and return the library's path."""
    with open(SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR,
                      f"libtsne_forces_dense_{key.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SRC],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError("tsne_forces_dense: nvcc failed:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.tsne_forces_dense_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check_inputs(y: torch.Tensor, p_dense: torch.Tensor, n_valid: int):
    npad = y.shape[0]
    if y.dim() != 2 or y.shape[1] != 2:
        raise ValueError(f"tsne_forces_dense: y must be [Npad, 2], got "
                         f"{tuple(y.shape)}")
    if tuple(p_dense.shape) != (npad, npad):
        raise ValueError(f"tsne_forces_dense: P must be [{npad}, {npad}], "
                         f"got {tuple(p_dense.shape)}")
    if y.dtype != torch.float32 or p_dense.dtype != torch.float32:
        raise TypeError("tsne_forces_dense: y and P must be float32")
    if y.device != p_dense.device:
        raise ValueError("tsne_forces_dense: y and P lie on different "
                         f"devices ({y.device}, {p_dense.device})")
    if not 0 <= n_valid <= npad:
        raise ValueError(f"tsne_forces_dense: n_valid {n_valid} outside "
                         f"[0, {npad}]")


def tsne_forces_dense(y: torch.Tensor, p_dense: torch.Tensor, n_valid: int):
    """Fused attraction and repulsion over a dense joint P.

    y [Npad, 2], p_dense [Npad, Npad] (zero off the support and on pads),
    n_valid the number of real rows -> (attr [Npad, 2], rep [Npad, 2],
    Z 0-d tensor).  Pad rows come out 0.
    """
    n_valid = int(n_valid)
    _check_inputs(y, p_dense, n_valid)
    if y.device.type == "cpu":
        return tsne_forces_dense_reference(y, p_dense, n_valid)
    if y.device.type != "cuda":
        raise ValueError(f"tsne_forces_dense: no kernel for {y.device}")
    npad = y.shape[0]
    if npad % 128:
        raise ValueError(f"tsne_forces_dense: Npad {npad} is not a multiple "
                         "of 128")
    if not (y.is_contiguous() and p_dense.is_contiguous()):
        raise ValueError("tsne_forces_dense: y and P must be contiguous")
    lib = _library()
    attr = torch.empty_like(y)
    rep = torch.empty_like(y)
    zrow = torch.empty(npad, dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tsne_forces_dense_launch(
            y.data_ptr(), p_dense.data_ptr(), npad, n_valid,
            attr.data_ptr(), rep.data_ptr(), zrow.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tsne_forces_dense: launch failed with CUDA "
                           f"error {err}")
    tsne_forces_dense.launches += 1
    return attr, rep, zrow.sum()


tsne_forces_dense.launches = 0


def tsne_forces_dense_reference(y: torch.Tensor, p_dense: torch.Tensor,
                                n_valid: int, row_block: int = 1024):
    """The plain PyTorch twin: the same seven row sums over row blocks of
    the dense tile, on whatever device the tensors lie."""
    n_valid = int(n_valid)
    _check_inputs(y, p_dense, n_valid)
    npad = y.shape[0]
    ids = torch.arange(npad, device=y.device)
    col_ok = ids < n_valid
    yx, yy = y[:, 0], y[:, 1]
    sums = torch.zeros((7, npad), dtype=torch.float32, device=y.device)
    for r0 in range(0, npad, row_block):
        r1 = min(r0 + row_block, npad)
        rows = ids[r0:r1, None]
        dx = yx[r0:r1, None] - yx[None, :]
        dy = yy[r0:r1, None] - yy[None, :]
        w = 1.0 / (1.0 + dx * dx + dy * dy)
        valid = (rows != ids[None, :]) & col_ok[None, :] & (rows < n_valid)
        w = torch.where(valid, w, 0.0)
        pw = torch.where(valid, p_dense[r0:r1], 0.0) * w
        w2 = w * w
        sums[:, r0:r1] = torch.stack([
            w2.sum(1), (w2 * yx).sum(1), (w2 * yy).sum(1), w.sum(1),
            pw.sum(1), (pw * yx).sum(1), (pw * yy).sum(1)])
    s2, ax, ay, zrow, sa, bx, by = sums
    row_ok = (ids < n_valid)[:, None]
    rep = torch.where(row_ok, torch.stack([s2 * yx - ax, s2 * yy - ay], 1),
                      0.0)
    attr = torch.where(row_ok, torch.stack([sa * yx - bx, sa * yy - by], 1),
                       0.0)
    return attr, rep, zrow.sum()
