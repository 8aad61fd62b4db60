"""The PyTorch port's surface: it imports no jax, its settings copy matches
the JAX package's, devices are explicit, what is not ported raises, and the
interop helpers carry the JAX package's settings and arrays across."""

import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sph_tpu as J
import sph_tpu.settings as jset
import sph_tpu_torch as T
import sph_tpu_torch.settings as tset
from sph_tpu_torch import interop
from sph_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import sys, sph_tpu_torch, sph_tpu_torch.interop, "
            "sph_tpu_torch.ops.tsne_kernels, sph_tpu_torch.ops.tsne_grid, "
            "sph_tpu_torch.models.umap, sph_tpu_torch.ops.component_knn; "
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') "
            "or m.startswith('sph_tpu.') or m == 'sph_tpu' "
            "for m in sys.modules) else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_the_port_sources():
    root = os.path.join(REPO, "sph_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src


def _enums(mod):
    return {name: obj for name, obj in vars(mod).items()
            if isinstance(obj, type) and issubclass(obj, enum.Enum)
            and obj is not enum.Enum}


def test_settings_copy_matches_jax_package():
    je, te = _enums(jset), _enums(tset)
    assert set(je) == set(te)
    for name in je:
        assert ([(m.name, m.value) for m in je[name]]
                == [(m.name, m.value) for m in te[name]])
    for name in ("RandomWalkSettings", "NearestNeighborsSettings",
                 "ImageHierarchySettings", "LevelSimilaritiesSettings",
                 "CacheSettings"):
        jf = [(f.name, f.type, f.default if f.default is not dataclasses.MISSING
               else f.default_factory())
              for f in dataclasses.fields(getattr(jset, name))]
        tf = [(f.name, f.type, f.default if f.default is not dataclasses.MISSING
               else f.default_factory())
              for f in dataclasses.fields(getattr(tset, name))]
        assert [(a, b, c.value if isinstance(c, enum.Enum) else c)
                for a, b, c in jf] == [
            (a, b, c.value if isinstance(c, enum.Enum) else c)
            for a, b, c in tf]


def test_settings_from_jax_round_trip():
    ihs = J.ImageHierarchySettings(component_sim=J.ComponentSim.NEIGH_WALKS,
                                   max_levels=7, min_reduction=98.0)
    got = interop.settings_from_jax(ihs)
    assert isinstance(got, T.ImageHierarchySettings)
    assert got.component_sim is T.ComponentSim.NEIGH_WALKS
    assert got.max_levels == 7 and got.min_reduction == 98.0
    assert tset.settings_to_json(got) == jset.settings_to_json(ihs)


def test_interop_arrays():
    idx = np.array([[0, 2, -1], [1, -1, -1]], np.int32)
    val = np.array([[0.5, 0.5, 0.0], [1.0, 0.0, 0.0]], np.float32)
    sr = interop.sparse_rows_from_numpy(idx, val, 3, device="cpu")
    assert sr.device == torch.device("cpu") and sr.idx.dtype == torch.int64
    assert np.array_equal(sr.indices, idx) and np.array_equal(sr.values, val)
    g = interop.graph_from_numpy(idx, val)
    assert isinstance(g, T.KnnGraph)
    pg = interop.graph_from_numpy(idx, val, np.array([2, 1], np.int32))
    assert isinstance(pg, T.PaddedGraph) and pg.num_edges() == 3


def test_default_device_is_cuda_or_a_clear_error():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ComputeHierarchy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ComputeEmbedding()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SparseRows(np.zeros((1, 1), np.int32), np.ones((1, 1)), 1)
    assert T.ComputeHierarchy(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("change", [
    {"component_sim": "geo_centroid"},
    {"component_sim": "neigh_walks_single_overlap"},
    {"rw_handling": "merge_rw_new_walks"},
    {"level_sim": "neigh_walks_single_overlap"},
])
def test_unported_branches_raise(change, monkeypatch):
    """The level_sim case: NEIGH_WALKS_SINGLE_OVERLAP level similarities
    (with the approximate threshold at 4 components, as for any level
    metric), which are not ported."""
    from sph_tpu_torch.utils.testdata import create_checker_image
    img = create_checker_image(6, 6, channels=3, block=2, noise=0.02)
    data = T.scale(T.ImageStack.from_array(img).data, T.Scaler.STANDARD)
    kw = {"component_sim": T.ComponentSim.NEIGH_WALKS}
    lss = T.LevelSimilaritiesSettings(ks=[6])
    if "component_sim" in change:
        kw["component_sim"] = T.ComponentSim(change["component_sim"])
    elif "level_sim" in change:
        lss.component_sim = T.ComponentSim(change["level_sim"])
        monkeypatch.setenv("SPH_APPROX_KNN_THRESHOLD", "4")
    else:
        kw["rw_handling"] = T.RandomWalkHandling(change["rw_handling"])
    ch = T.ComputeHierarchy(device="cpu").init(
        data, 6, 6, ihs=T.ImageHierarchySettings(**kw), lss=lss,
        rws=T.RandomWalkSettings(num_random_walks=4, single_walk_length=3),
        nns=T.NearestNeighborsSettings(num_nearest_neighbors=6))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ch.compute()


def test_stage_cache_not_ported():
    with pytest.raises(NotImplementedError):
        T.ComputeHierarchy(device="cpu").init(
            np.zeros((4, 2), np.float32), 2, 2,
            cache=T.CacheSettings(path="x", cache_active=True))
