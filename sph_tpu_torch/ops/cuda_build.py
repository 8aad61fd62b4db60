"""Building and calling the port's CUDA kernels.

Each ``.cu`` under ``csrc/`` is compiled with nvcc for sm_90a into its own
content-hashed shared library in ``_build/`` at first use (all missing ones
at once, one nvcc each), with a plain C entry point ``<name>_launch`` that
is loaded with ctypes and returns the launch's CUDA error.  The wrappers
live beside their twins: the t-SNE kernels in ``ops/tsne_kernels.py``, the
grid tier's deposit and interpolation in ``ops/tsne_grid.py``, the
Bellman-Ford relax in ``ops/shortest_path.py``, the walk rows' sort in
``ops/walk_sort.py``, the merges' run sums in ``ops/device_merge.py``.
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
    "tsne_forces_dense": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P],
    "tsne_repulsion": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "tsne_attraction": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _P,
                        _P],
    "grid_deposit": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P],
    "grid_interpolate": [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P,
                         _P, _I, _P, _P, _P],
    "bellman_ford_relax": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _I, _P],
    "walk_row_sort": [_P, ctypes.c_longlong, _I, _P, _P, _P, _P],
    "merge_runs": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _P,
                   _P, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P, _P,
                   _P],
}
# every kernel of the port
ALL_KERNELS = tuple(_SIGNATURES)

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
        raise RuntimeError("cuda_build: nvcc not found (looked on PATH and "
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
    names = names or ALL_KERNELS
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
            raise RuntimeError("cuda_build: nvcc failed for "
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


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
