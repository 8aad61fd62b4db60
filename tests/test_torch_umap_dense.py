"""UMAP's dense tier bit for bit against the JAX package on the CPU.

The JAX package runs the dense tier's epochs (``_run_epochs_dense``) as
XLA-CPU compiles them: the squared lengths as fused multiply-adds, the row
sums over its power-of-two padded width in windows of 32, the position
updates as fused multiply-adds and a true division for the repulsive
coefficient.  The port's ``_dense_epoch`` takes the same steps, so from
one kNN graph and initial layout every epoch of the schedule ends in the
JAX package's layout, bits included (the evaluation driver embeds small
levels on this tier, where a last-bit difference grows into another map
within a few hundred epochs)."""

import numpy as np
import pytest
import torch

from sph_tpu.models import umap as jumap
from sph_tpu.ops.knn import knn_bruteforce
from sph_tpu.utils.testdata import create_3d_gaussians
from sph_tpu_torch.models import umap as tumap
from test_torch_reference_native import use_reference_native

use_reference_native()


@pytest.fixture
def float32_gathers(monkeypatch):
    for name in ("SPH_UMAP_DENSE_MAX", "SPH_UMAP_ROWS_WIDTH",
                 "SPH_UMAP_NEG_BUDGET", "SPH_UMAP_EDGE_PATH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SPH_UMAP_PACKED", "0")


@pytest.mark.parametrize("n,epochs", [(43, 300), (192, 60), (600, 15)])
def test_dense_tier_layout_bit_equal(float32_gathers, n, epochs):
    """Point counts below, at and above a power of two's padding (64, 256,
    1024 columns), each through its whole schedule."""
    centers = np.array([[0, 0, 0], [14, 0, 0], [0, 14, 0], [9, 9, 9]])
    pos, _ = create_3d_gaussians(n, random_state=9, centers=centers)
    idx, dist = knn_bruteforce(pos, 15)
    init = (np.random.default_rng(7).standard_normal((n, 2))
            * 10).astype(np.float32)
    uj = jumap.UmapComputation(jumap.UmapParameters(num_epochs=epochs,
                                                    seed=3))
    ut = tumap.UmapComputation(tumap.UmapParameters(num_epochs=epochs,
                                                    seed=3), device="cpu")
    for u in (uj, ut):
        u.set_neighbor_graph(idx, dist)
        u.set_initial_embedding(init)
        u.init_optimization()
    assert ut.tier == "dense"
    uj.run_for_epochs(epochs)
    ut.run_for_epochs(epochs)
    want = np.asarray(uj._y)[:n]
    got = ut._y.numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_repulsive_coefficient_is_a_true_division():
    """2b / den as IEEE division: torch's Python-number-over-tensor form
    (the tensor's reciprocal times the number) is an ulp off at times."""
    rng = np.random.default_rng(0)
    e0 = torch.from_numpy((rng.standard_normal(4096) * 5).astype(np.float32))
    e1 = torch.from_numpy((rng.standard_normal(4096) * 5).astype(np.float32))
    a, b = float(np.float32(1.5769)), float(np.float32(0.8951))
    r0, _ = tumap._repel(e0, e1, a, b, true_division=True)
    e2 = tumap._sq_len(e0, e1)
    den = ((0.001 + e2) * tumap._fma(a, tumap.pow(e2, b), 1.0)).double()
    gcn = ((2.0 * b) / den).float()     # one rounding of the quotient
    want = torch.where(e2 > 0, torch.clamp(gcn * e0, -4.0, 4.0), 4.0)
    assert torch.equal(r0.view(torch.int32), want.view(torch.int32))
