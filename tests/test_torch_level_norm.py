"""Level normalization in the port against the JAX package: the LINEAR,
NONE and bucketed UMAP rows, the kNN-graph dispatcher under every scheme,
level probdists under each scheme on small NEIGH_WALKS and EUCLID_CENTROID
hierarchies, the level-0 probdist from the data graph alone, the UMAP
symmetrization of the level output, and pca."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sph_tpu as J
from sph_tpu.ops import distributions as jdist
from sph_tpu.ops import math as jmath
from sph_tpu.ops.knn import knn_bruteforce
import sph_tpu_torch as T
from sph_tpu_torch.ops import distributions as tdist
from sph_tpu_torch.ops import math as tmath
from sph_tpu_torch.ops.numerics import np_row_sum
from sph_tpu_torch.utils.testdata import (create_checker_image,
                                          create_hyperspectral_scene)
from test_torch_reference_native import use_reference_native

use_reference_native()

RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small torch ops: one thread each keeps parallel test
    workers from stalling one another's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SCHEMES = ("TSNE", "UMAP", "LINEAR", "NONE")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-12)


@pytest.fixture(scope="module")
def rows():
    x = np.random.default_rng(0).standard_normal((300, 10)).astype(
        np.float32)
    idx, dist = knn_bruteforce(x, 40)
    dist = np.asarray(dist)
    mask = np.ones(dist.shape, bool)
    mask[5, 20:] = False          # a short row
    mask[9, 2:] = False           # a single-entry row
    return np.asarray(idx), dist, mask


@pytest.mark.parametrize("width", [7, 33, 40])
def test_linear_rows(rows, width):
    _, dist, mask = rows
    d, m = dist[:, :width], mask[:, :width].copy()
    m[:, 0] = False
    want = np.asarray(jdist.linear_row_distributions(jnp.asarray(d),
                                                     jnp.asarray(m)))
    got = tdist.linear_row_distributions(torch.from_numpy(d),
                                         torch.from_numpy(m)).numpy()
    _close(got, want)
    live = m.any(1)
    assert np.allclose(got[live].sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("scheme", ["LINEAR", "NONE"])
def test_dispatcher_linear_and_none(rows, scheme):
    """NONE is no probability kernel: both packages fall back to Gaussian
    rows (the reference's default branch)."""
    _, dist, mask = rows
    want = jdist.distance_rows_to_probabilities(
        dist, mask, J.NormalizationScheme[scheme], perplexity=-1.0,
        ignore_first=True)
    got = tdist.distance_rows_to_probabilities(
        torch.from_numpy(dist), torch.from_numpy(mask),
        T.NormalizationScheme[scheme], ignore_first=True).numpy()
    _close(got, want)
    assert np.all(got[:, 0] == 0)


@pytest.mark.parametrize("width", [5, 31, 33, 40])
def test_bucketed_umap_rows(rows, width):
    """smooth_knn_rows_bucketed sums at the JAX package's bucket width: bit
    for bit with XLA-CPU on both sides of a 32-term window."""
    _, dist, mask = rows
    d, m = dist[:, :width], mask[:, :width].copy()
    m[:, 0] = False
    want = jdist.smooth_knn_rows_bucketed(d, m)
    got = tdist.smooth_knn_rows_bucketed(torch.from_numpy(d),
                                         torch.from_numpy(m)).numpy()
    assert np.array_equal(got, want)
    assert tdist.bucket_width(width) == max(32, 1 << (width - 1).bit_length())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_normalize_knn_distances(rows, scheme):
    _, dist, _ = rows
    want = jdist.normalize_knn_distances(dist, J.NormalizationScheme[scheme],
                                         10.0)
    got = tdist.normalize_knn_distances(dist, T.NormalizationScheme[scheme],
                                        10.0, device="cpu")
    assert np.array_equal(got, want)


def test_umap_row_norm_takes_numpy_sums(rows):
    """The row normalization of UMAP rows for the walks: numpy's row sums
    (pairwise over blocks of 8), with subnormal quotients at 0."""
    _, dist, mask = rows
    want = jdist.distance_rows_to_probabilities(
        dist, mask, J.NormalizationScheme.UMAP, ignore_first=True,
        umap_row_norm=True)
    got = tdist.distance_rows_to_probabilities(
        torch.from_numpy(dist), torch.from_numpy(mask),
        T.NormalizationScheme.UMAP, ignore_first=True,
        umap_row_norm=True).numpy()
    tiny = np.abs(want) < 2.0 ** -126
    assert np.array_equal(got[~tiny], want[~tiny]) and np.all(got[tiny] == 0)
    x = np.random.default_rng(2).random((20, 300)).astype(np.float32)
    for w in (1, 7, 8, 9, 127, 128, 129, 300):
        assert np.array_equal(np_row_sum(torch.from_numpy(x[:, :w])).numpy(),
                              x[:, :w].sum(axis=1))


# ---------------------------------------------------------------------------
# level probdists
# ---------------------------------------------------------------------------

def _hierarchy(P, sim, scheme, symmetric="NONE", image=True, **kw):
    """A small hierarchy with the level scheme `scheme` (the data level
    keeps TSNE, so every case merges the same levels).  EUCLID_CENTROID
    takes tests/test_torch_euclid.py's scene and settings (8 samples,
    k = 11), on which the two packages' Hausdorff kNN graphs are
    bit-equal."""
    if sim == "NEIGH_WALKS":
        img = create_checker_image(12, 12, channels=4, block=3, noise=0.05)
        data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
        rows = cols = 12
        ihs = P.ImageHierarchySettings(component_sim=P.ComponentSim[sim])
        lss = P.LevelSimilaritiesSettings(component_sim=P.ComponentSim[sim],
                                          ks=[10])
        rws = P.RandomWalkSettings(num_random_walks=10,
                                   single_walk_length=5, random_seed=1)
        nns = P.NearestNeighborsSettings(num_nearest_neighbors=10)
    else:
        import chip_smoke
        rows, cols = 20, 16
        img = create_hyperspectral_scene(rows, cols, 12, seed=13)
        data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.NONE)
        ihs, lss, rws, nns = chip_smoke.salinas_settings(P)
        ihs.num_geodesic_samples = 8
        lss.ks = [11]
        nns.num_nearest_neighbors = 11
    lss.normalize_prob_dist = P.NormalizationScheme[scheme]
    lss.compute_symmetric_prob_dist = P.NormalizationScheme[symmetric]
    ch = P.ComputeHierarchy(**kw).init(data, rows, cols, ihs=ihs, lss=lss,
                                       rws=rws, nns=nns)
    ch.compute_knn_graph()
    ch.compute_image_hierarchy()
    if not image:
        ch.level_similarities._image_hierarchy = None
        ch.level_similarities.compute(ch._lss)
        return ch
    ch.compute_level_similarities()
    return ch


def _probdists(ch):
    ls = ch.level_similarities
    return [ls.get_prob_dist(i).to_dense()
            for i in range(ch.image_hierarchy.hierarchy.num_levels)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("sim", ["NEIGH_WALKS", "EUCLID_CENTROID"])
def test_level_probdists_under_each_scheme(sim, scheme):
    """Walk levels take the scheme (LINEAR and NONE leave the pairwise walk
    similarities as they are); kNN levels always take Gaussian rows."""
    chj = _hierarchy(J, sim, scheme)
    cht = _hierarchy(T, sim, scheme, device="cpu")
    levels = cht.image_hierarchy.hierarchy.num_components
    assert levels == chj.image_hierarchy.hierarchy.num_components
    assert len(levels) >= 3
    for got, want in zip(_probdists(cht), _probdists(chj)):
        _close(got, want)
    assert (cht.level_similarities.stats.to_dict()
            == chj.level_similarities.stats.to_dict())


@pytest.mark.parametrize("scheme", ["TSNE", "UMAP", "LINEAR"])
def test_level_zero_probdist_from_the_data_graph(scheme):
    """Without the image hierarchy's rows, level 0 normalizes the data kNN
    graph itself with the level scheme and perplexity."""
    chj = _hierarchy(J, "NEIGH_WALKS", scheme, image=False)
    cht = _hierarchy(T, "NEIGH_WALKS", scheme, image=False, device="cpu")
    got = _probdists(cht)[0]
    _close(got, _probdists(chj)[0])
    assert np.all(np.diag(got) == 0)


@pytest.mark.parametrize("sim", ["NEIGH_WALKS", "EUCLID_CENTROID"])
def test_umap_symmetrized_level_output(sim):
    """compute_symmetric_prob_dist UMAP: each level's fuzzy union."""
    chj = _hierarchy(J, sim, "UMAP", symmetric="UMAP")
    cht = _hierarchy(T, sim, "UMAP", symmetric="UMAP", device="cpu")
    assert cht.level_similarities._symmetric == T.NormalizationScheme.UMAP
    for got, want in zip(_probdists(cht), _probdists(chj)):
        _close(got, want)
        assert np.allclose(got, got.T)


def test_linear_level_output_is_not_symmetrized():
    cht = _hierarchy(T, "NEIGH_WALKS", "LINEAR", symmetric="LINEAR",
                     device="cpu")
    chj = _hierarchy(J, "NEIGH_WALKS", "LINEAR", symmetric="LINEAR")
    for got, want in zip(_probdists(cht), _probdists(chj)):
        _close(got, want)


@pytest.mark.parametrize("shape", [(400, 200), (50, 3), (3, 5)])
def test_pca_bit_equal(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    got, ok = tmath.pca(x, 2)
    want, ok_j = jmath.pca(x, 2)
    assert ok and ok_j and got.dtype == np.float32
    assert np.array_equal(got, want)
