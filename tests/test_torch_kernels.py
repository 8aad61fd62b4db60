"""tsne_forces_dense: the port's plain twin against the JAX package's Pallas
kernel (interpret mode on the CPU) and against a numpy oracle; the CUDA
kernel against the twin on the card.  The wrapper routes CPU tensors to the
twin, so the CPU tests reach it through the public wrapper."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sph_tpu.ops.pallas.tsne_kernels import tsne_forces_dense as jax_forces
from sph_tpu_torch.ops import tsne_kernels
from sph_tpu_torch.ops.tsne_kernels import (tsne_forces_dense,
                                            tsne_forces_dense_reference)

INTERPRET = jax.default_backend() != "tpu"


def _inputs(n, npad, seed=2):
    """The fixture of tests/test_pallas_kernels.py:42-52: y and a sparse
    symmetric joint P with zero diagonal and pads."""
    rng = np.random.default_rng(seed)
    y = np.zeros((npad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2)).astype(np.float32) * 3
    p = np.zeros((npad, npad), np.float32)
    sup = rng.random((n, n)) < 0.05
    p[:n, :n] = np.where(sup | sup.T, rng.random((n, n)), 0).astype(np.float32)
    p[:n, :n] = (p[:n, :n] + p[:n, :n].T) / 2
    np.fill_diagonal(p, 0.0)
    p /= max(p.sum(), 1e-12)
    return y, p


def _assert_close(attr, rep, z, attr_ref, rep_ref, z_ref, n):
    assert np.isclose(float(z), float(z_ref), rtol=1e-5)
    for got, ref in ((rep, rep_ref), (attr, attr_ref)):
        scale = max(float(np.abs(ref[:n]).max()), 1e-30)
        assert np.abs(got[:n] - ref[:n]).max() <= 1e-5 * scale
        assert np.all(got[n:] == 0)


@pytest.mark.parametrize("n,npad", [(100, 256), (256, 256)])
def test_forces_twin_matches_pallas_interpret(n, npad):
    y, p = _inputs(n, npad)
    attr_j, rep_j, z_j = jax_forces(jnp.asarray(y), jnp.asarray(p),
                                    jnp.int32(n), row_block=128,
                                    col_block=256, interpret=INTERPRET)
    attr, rep, z = tsne_forces_dense(torch.from_numpy(y), torch.from_numpy(p),
                                     n)
    _assert_close(attr.numpy(), rep.numpy(), z, np.asarray(attr_j),
                  np.asarray(rep_j), z_j, n)


@pytest.mark.parametrize("n,npad", [(100, 256), (256, 256)])
def test_forces_twin_matches_numpy_oracle(n, npad):
    y, p = _inputs(n, npad)
    d2 = ((y[:n, None, :] - y[None, :n, :]) ** 2).sum(-1)
    w = 1.0 / (1.0 + d2)
    np.fill_diagonal(w, 0.0)
    diff = y[:n, None, :] - y[None, :n, :]
    rep_ref = np.zeros_like(y)
    attr_ref = np.zeros_like(y)
    rep_ref[:n] = ((w ** 2)[:, :, None] * diff).sum(1)
    attr_ref[:n] = ((p[:n, :n] * w)[:, :, None] * diff).sum(1)
    attr, rep, z = tsne_forces_dense(torch.from_numpy(y), torch.from_numpy(p),
                                     n)
    _assert_close(attr.numpy(), rep.numpy(), z, attr_ref, rep_ref, w.sum(), n)


def test_forces_cpu_tensor_takes_twin_and_counts_no_launch():
    y, p = _inputs(50, 128)
    before = tsne_forces_dense.launches
    out = tsne_forces_dense(torch.from_numpy(y), torch.from_numpy(p), 50)
    ref = tsne_forces_dense_reference(torch.from_numpy(y),
                                      torch.from_numpy(p), 50)
    assert tsne_forces_dense.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["shape", "dtype", "n_valid"])
def test_forces_rejects_what_the_kernel_does_not_take(bad):
    y = torch.zeros((128, 2))
    p = torch.zeros((128, 128))
    n = 10
    if bad == "shape":
        p = torch.zeros((128, 64))
    elif bad == "dtype":
        y = y.double()
    else:
        n = 129
    with pytest.raises((ValueError, TypeError)):
        tsne_forces_dense(y, p, n)


def test_kernel_source_notes_the_tpu_kernel_it_replaces():
    assert tsne_kernels.KERNELS == ("tsne_forces_dense", "tsne_repulsion")
    for name in tsne_kernels.KERNELS:
        with open(tsne_kernels.source(name)) as f:
            src = f.read()
        assert "sph_tpu/ops/pallas/tsne_kernels.py" in src and name in src
        assert f'extern "C" int {name}_launch' in src
        # one library per kernel and source content
        assert os.path.basename(tsne_kernels.library_path(name)).startswith(
            f"lib{name}_")
    assert "sm_90a" in " ".join(tsne_kernels.NVCC_FLAGS)


@pytest.mark.cuda
@pytest.mark.parametrize("n,npad", [(1000, 1024), (5284, 6144)])
def test_forces_cuda_kernel_matches_twin(n, npad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    y, p = _inputs(n, npad, seed=5)
    y_d, p_d = torch.from_numpy(y).cuda(), torch.from_numpy(p).cuda()
    before = tsne_forces_dense.launches
    attr, rep, z = tsne_forces_dense(y_d, p_d, n)
    attr_r, rep_r, z_r = tsne_forces_dense_reference(y_d, p_d, n)
    torch.cuda.synchronize()
    assert tsne_forces_dense.launches == before + 1
    _assert_close(attr.cpu().numpy(), rep.cpu().numpy(), z.cpu(),
                  attr_r.cpu().numpy(), rep_r.cpu().numpy(), z_r.cpu(), n)
