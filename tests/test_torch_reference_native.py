"""The JAX package's C++ graph ops, as the port's parity tests reach them.

A port test that calls a JAX function which reaches ``sph_tpu.native``
holds the port against that function's result.  The JAX package builds
``libgraphops.so`` in place with g++ (sph_tpu/native/__init__.py), so under
parallel test workers one worker can load a file another is still
writing; that worker's loader then keeps ``get_lib()`` None and every JAX
function it runs afterwards takes its numpy fallbacks, which are not the
C++ ops' bits (``argsort_i64`` returns None; the merge is an ulp off).
A parity test would then fail against a reference that silently fell back.

``use_reference_native()`` gives such tests the library through a build
that no worker can see half-written: ``sph_tpu/native/graphops.cpp`` with
the JAX package's own g++ flags, into a private file named by the hash of
the source and the flags under the git-ignored ``sph_tpu_torch/_build/``,
written under an ``fcntl`` lock to a temporary name and moved into place
with ``os.replace``.  It points ``sph_tpu.native._SO`` at that file,
resets the loader and loads it.  If the JAX package's loader still
returns None (``SPH_TPU_NO_NATIVE`` set, or the library does not load),
it raises: a reference without its C++ ops is a fault of the test set-up,
never a parity failure and never a skip.

Every port test module that imports ``sph_tpu`` calls it at import, so it
holds whatever order the workers run the files in: each worker imports
every test module while it collects, before it runs any test.  Those
workers' later calls into ``sph_tpu.native`` (the JAX package's own tests
included) load the same file.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

from sph_tpu import native as jnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "sph_tpu", "native", "graphops.cpp")
BUILD_DIR = os.path.join(REPO, "sph_tpu_torch", "_build")
# sph_tpu/native/__init__.py's _build: g++ -O3 -march=native -shared -fPIC
# -std=c++17 <source> -o <library>
GXX_FLAGS = ("g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def reference_library_path() -> str:
    """The private library's path: one file per source content and flags."""
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libgraphops_reference_{key.hexdigest()[:16]}.so")


def build_reference_library() -> str:
    """Build the library once for all workers and return its path.  The
    lock makes the other workers wait for the one that builds; the build
    goes to a temporary name, so the library's path only ever holds a
    whole file."""
    so = reference_library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{so}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([*GXX_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError("building the JAX package's graphops.cpp "
                                   f"failed:\n{proc.stderr}")
            os.replace(tmp, so)
        # the JAX package's loader rebuilds (in place) a library older
        # than its source, as after a checkout that touched the source
        if os.path.getmtime(so) < os.path.getmtime(SOURCE):
            os.utime(so)
    return so


def use_reference_native() -> ctypes.CDLL:
    """Point the JAX package's loader at the private library and load it;
    raise if the loader gives None."""
    so = build_reference_library()
    if jnative._SO != so or jnative._lib is None:
        jnative._SO = so
        jnative._lib = None
        jnative._tried = False
    lib = jnative.get_lib()
    if lib is None:
        raise RuntimeError(
            "the JAX package's native library did not load from "
            f"{so} (SPH_TPU_NO_NATIVE={os.environ.get('SPH_TPU_NO_NATIVE')!r})"
            ": the port's parity tests need its C++ ops, not its numpy "
            "fallbacks")
    return lib


use_reference_native()


def test_reference_library_is_private_and_whole():
    """The loader reads the private build, named by its content, and no
    temporary file is left beside it."""
    so = reference_library_path()
    assert jnative._SO == so and os.path.exists(so)
    assert jnative.get_lib() is not None
    assert not [name for name in os.listdir(BUILD_DIR)
                if name.startswith(os.path.basename(so)) and
                name.endswith(".tmp")]


def test_reference_ops_are_the_cpp_ones():
    """The C++ argsort is there (the numpy fallback returns None) and sorts
    stably."""
    keys = np.array([5, 1, 5, 0, 1], np.int64)
    order = jnative.argsort_i64(keys)
    assert order is not None
    assert np.array_equal(order, np.argsort(keys, kind="stable"))


def test_a_fallen_back_loader_is_repaired(monkeypatch):
    """A worker whose loader kept None (a half-written in-place build) is
    pointed at the private library again."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert jnative.get_lib() is None
    assert use_reference_native() is jnative.get_lib() is not None


def test_no_native_raises(monkeypatch):
    """With the C++ ops switched off the helper raises instead of letting
    the reference fall back."""
    monkeypatch.setenv("SPH_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    try:
        use_reference_native()
    except RuntimeError as exc:
        assert "SPH_TPU_NO_NATIVE='1'" in str(exc)
    else:
        raise AssertionError("use_reference_native did not raise")
