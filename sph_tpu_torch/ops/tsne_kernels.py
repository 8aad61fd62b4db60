"""t-SNE forces on the card: the CUDA kernels and their plain twins.

Replaces the two TPU kernels of sph_tpu/ops/pallas/tsne_kernels.py:

- ``tsne_forces_dense`` (``csrc/tsne_forces_dense.cu``): attraction and
  repulsion over a dense joint P, every iteration of the dense-P tier;
- ``tsne_repulsion`` (``csrc/tsne_repulsion.cu``): the exact all-pairs
  repulsion, every iteration of the exact sparse-P tier and the Z of the
  KL divergence on the card.

Each ``.cu`` under ``csrc/`` is compiled with nvcc for sm_90a into its own
content-hashed shared library in ``_build/`` (all missing ones at once, one
nvcc each), with a plain C entry point loaded with ctypes.  The sources note
what bounds each kernel and how it is laid out.

A wrapper launches its kernel for CUDA tensors and counts each launch in
``<wrapper>.launches``.  A CPU tensor goes to the ``*_reference`` twin, the
same sums as plain torch ops; a CUDA tensor never does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel name -> argument types of its C entry point ``<name>_launch``
_SIGNATURES = {
    "tsne_forces_dense": [_P, _P, _I, _I, _P, _P, _P, _P],
    "tsne_repulsion": [_P, _I, _I, _P, _P, _P],
}
KERNELS = tuple(_SIGNATURES)

_libs: dict[str, ctypes.CDLL] = {}


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("tsne_kernels: nvcc not found (looked on PATH and "
                           f"at {path})")
    return path


def library_path(name: str) -> str:
    """Where the kernel's library lives: one file per source content and
    flags."""
    with open(source(name), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{key.hexdigest()[:16]}.so")


def build(*names: str) -> dict[str, str]:
    """Compile the named kernels (all when none is named) into BUILD_DIR,
    one nvcc each, all started together; return each library's path."""
    names = names or KERNELS
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not os.path.exists(paths[name])]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = f"{paths[name]}.{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("tsne_kernels: nvcc failed for "
                               + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(build(name)[name])
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _libs[name] = lib
    return _libs[name]


def _launch(name: str, device: torch.device, *args):
    """Call the kernel's C entry point on `device`'s current stream and raise
    on the launch error it returns."""
    fn = getattr(_library(name), f"{name}_launch")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def _check_y(name: str, y: torch.Tensor, n_valid: int):
    if y.dim() != 2 or y.shape[1] != 2:
        raise ValueError(f"{name}: y must be [Npad, 2], got "
                         f"{tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"{name}: y must be float32, got {y.dtype}")
    if not 0 <= n_valid <= y.shape[0]:
        raise ValueError(f"{name}: n_valid {n_valid} outside "
                         f"[0, {y.shape[0]}]")


def _check_kernel_device(name: str, *tensors: torch.Tensor):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


# ---------------------------------------------------------------------------
# tsne_forces_dense
# ---------------------------------------------------------------------------

def _check_inputs(y: torch.Tensor, p_dense: torch.Tensor, n_valid: int):
    npad = y.shape[0]
    _check_y("tsne_forces_dense", y, n_valid)
    if tuple(p_dense.shape) != (npad, npad):
        raise ValueError(f"tsne_forces_dense: P must be [{npad}, {npad}], "
                         f"got {tuple(p_dense.shape)}")
    if p_dense.dtype != torch.float32:
        raise TypeError("tsne_forces_dense: y and P must be float32")
    if y.device != p_dense.device:
        raise ValueError("tsne_forces_dense: y and P lie on different "
                         f"devices ({y.device}, {p_dense.device})")


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
    _check_kernel_device("tsne_forces_dense", y, p_dense)
    npad = y.shape[0]
    if npad % 128:
        raise ValueError(f"tsne_forces_dense: Npad {npad} is not a multiple "
                         "of 128")
    attr = torch.empty_like(y)
    rep = torch.empty_like(y)
    zrow = torch.empty(npad, dtype=torch.float32, device=y.device)
    _launch("tsne_forces_dense", y.device, y.data_ptr(), p_dense.data_ptr(),
            npad, n_valid, attr.data_ptr(), rep.data_ptr(), zrow.data_ptr())
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


# ---------------------------------------------------------------------------
# tsne_repulsion
# ---------------------------------------------------------------------------

def tsne_repulsion_rows(y: torch.Tensor, n_valid: int):
    """Exact all-pairs repulsion per row: y [Npad, 2] (any Npad >= n_valid;
    rows at or past n_valid may hold anything) -> (rep [Npad, 2], zrow
    [Npad]) with rep_i = sum_j w_ij^2 (y_i - y_j) and zrow_i = sum_j w_ij
    over j != i, j < n_valid.  Pad rows come out 0.  The kernel on a CUDA
    tensor (counted in ``tsne_repulsion.launches``), the twin on a CPU one.
    """
    n_valid = int(n_valid)
    _check_y("tsne_repulsion", y, n_valid)
    if y.device.type == "cpu":
        return tsne_repulsion_reference(y, n_valid)
    _check_kernel_device("tsne_repulsion", y)
    if y.data_ptr() % 8:
        raise ValueError("tsne_repulsion: y must be 8-byte aligned")
    npad = y.shape[0]
    rep = torch.empty_like(y)
    zrow = torch.empty(npad, dtype=torch.float32, device=y.device)
    _launch("tsne_repulsion", y.device, y.data_ptr(), npad, n_valid,
            rep.data_ptr(), zrow.data_ptr())
    tsne_repulsion.launches += 1
    return rep, zrow


def tsne_repulsion(y: torch.Tensor, n_valid: int):
    """Exact all-pairs repulsion: y [Npad, 2] -> (rep [Npad, 2], Z 0-d
    tensor), Z = sum_{i != j} w_ij summed from the per-row partials outside
    the kernel, as the TPU kernel's caller sums them."""
    rep, zrow = tsne_repulsion_rows(y, n_valid)
    return rep, zrow.sum()


tsne_repulsion.launches = 0


def tsne_repulsion_reference(y: torch.Tensor, n_valid: int, rows=None,
                             max_elements: int = 1 << 26):
    """The plain PyTorch twin of ``tsne_repulsion_rows``, in the direct
    difference form of the TPU kernel, over row blocks of at most
    `max_elements` pairs.

    rows=(r0, r1) computes only those rows (against all columns) and returns
    (rep [r1 - r0, 2], zrow [r1 - r0]).  The weights are float32, as in the
    kernel; the row sums are taken in float64 and rounded once, so that a
    comparison measures the kernel's summation error and not the twin's.
    """
    n_valid = int(n_valid)
    _check_y("tsne_repulsion", y, n_valid)
    npad = y.shape[0]
    r0, r1 = (0, npad) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 <= r1 <= npad:
        raise ValueError(f"tsne_repulsion: rows {rows} outside [0, {npad}]")
    dev = y.device
    rep = torch.zeros((r1 - r0, 2), dtype=torch.float32, device=dev)
    zrow = torch.zeros(r1 - r0, dtype=torch.float32, device=dev)
    cx, cy = y[:n_valid, 0], y[:n_valid, 1]
    cols = torch.arange(n_valid, device=dev)
    block = max(1, max_elements // max(n_valid, 1))
    f64 = torch.float64
    for b0 in range(r0, min(r1, n_valid), block):
        b1 = min(b0 + block, r1, n_valid)
        bx, by = y[b0:b1, 0:1], y[b0:b1, 1:2]
        dx = bx - cx[None, :]
        dy = by - cy[None, :]
        w = 1.0 / (1.0 + (dx * dx + dy * dy))
        self_pair = cols[None, :] == torch.arange(b0, b1, device=dev)[:, None]
        w = torch.where(self_pair, 0.0, w)
        w2 = w * w
        s2 = w2.sum(1, dtype=f64)
        ax = (w2 * cx[None, :]).sum(1, dtype=f64)
        ay = (w2 * cy[None, :]).sum(1, dtype=f64)
        rep[b0 - r0:b1 - r0] = torch.stack(
            [s2 * bx[:, 0].to(f64) - ax, s2 * by[:, 0].to(f64) - ay],
            1).float()
        zrow[b0 - r0:b1 - r0] = w.sum(1, dtype=f64).float()
    return rep, zrow
