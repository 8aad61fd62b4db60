"""The PyTorch port's surface: it imports no jax, its settings copy matches
the JAX package's, devices are explicit, what is not ported raises (and
what was, runs), and the
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
from test_torch_reference_native import use_reference_native

use_reference_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# port modules that import matplotlib at module level, which the card's
# machine does not have: checked by an AST scan of their imports instead
_AST_CHECKED = ("sph_tpu_torch.vis",)


def _port_modules() -> list[str]:
    out = []
    root = os.path.join(REPO, "sph_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), REPO)[:-3]
            mod = rel.replace(os.sep, ".")
            out.append(mod[:-len(".__init__")] if mod.endswith(".__init__")
                       else mod)
    return sorted(out)


def _ast_imports(mod: str) -> set[str]:
    import ast
    path = os.path.join(REPO, *mod.split(".")) + ".py"
    found = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module)
    return found


def test_import_leaves_jax_out():
    """Every module of the port imports without jax or the JAX package:
    all of them in one subprocess, but for those that need matplotlib,
    whose own imports are read from their source."""
    mods = _port_modules()
    assert "sph_tpu_torch.parallel.sharded" in mods
    imported = [m for m in mods if m not in _AST_CHECKED]
    assert set(imported) | set(_AST_CHECKED) == set(mods)
    code = ("import sys, importlib\n"
            f"for m in {imported!r}: importlib.import_module(m)\n"
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') "
            "or m.startswith('sph_tpu.') or m == 'sph_tpu' "
            "for m in sys.modules) else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for mod in _AST_CHECKED:
        names = _ast_imports(mod)
        assert not any(n == "jax" or n.startswith("jax.") or n == "sph_tpu"
                       or n.startswith("sph_tpu.") for n in names), names


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


def test_graphops_copy_matches_jax_package():
    """The port builds its own copy of the JAX package's host graph ops."""
    from sph_tpu_torch import native
    with open(native.SRC, "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "sph_tpu", "native", "graphops.cpp"),
              "rb") as f:
        assert port == f.read()
    assert os.path.dirname(native.SRC).startswith(
        os.path.join(REPO, "sph_tpu_torch"))


def test_graphops_builds_without_the_jax_package(tmp_path):
    """sph_tpu_torch/ copied alone (no sph_tpu/ beside it, no built
    library) builds its graph ops with g++ and runs them."""
    import shutil
    shutil.copytree(os.path.join(REPO, "sph_tpu_torch"),
                    tmp_path / "sph_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = ("import numpy as np; from sph_tpu_torch import native; "
            "n, lab = native.weak_components(np.array([[0, 1], [1, 0], "
            "[2, -1]], np.int32)); assert n == 2, n; "
            "assert native.SRC.startswith(%r)" % str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert not (tmp_path / "sph_tpu").exists()
    assert list((tmp_path / "sph_tpu_torch" / "_build").glob("*.so"))


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
    {"level_pair_sims": False},
    {"component_sim": "neigh_walks_single_overlap"},
    {"rw_handling": "merge_rw_new_walks"},
    {"level_sim": "neigh_walks_single_overlap"},
])
def test_unported_branches_raise(change, monkeypatch):
    """The branches that raised until the walk options were ported now run
    and equal the JAX package's: the level_sim case,
    NEIGH_WALKS_SINGLE_OVERLAP level similarities over NEIGH_WALKS levels
    (with the approximate threshold at 4 components, as for any level
    metric); the level_pair_sims case, walk levels' probdists from their
    top-k walk rows instead of pairwise walk similarities."""
    from sph_tpu_torch.utils.testdata import create_checker_image
    img = create_checker_image(6, 6, channels=3, block=2, noise=0.02)
    if "level_sim" in change:
        monkeypatch.setenv("SPH_APPROX_KNN_THRESHOLD", "4")
    out = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.STANDARD)
        ihs = P.ImageHierarchySettings(
            component_sim=P.ComponentSim.NEIGH_WALKS)
        lss = P.LevelSimilaritiesSettings(ks=[6])
        if "component_sim" in change:
            ihs.component_sim = P.ComponentSim(change["component_sim"])
        elif "level_sim" in change:
            lss.component_sim = P.ComponentSim(change["level_sim"])
        elif "level_pair_sims" in change:
            lss.component_sim = P.ComponentSim.NEIGH_WALKS
            lss.random_walk_pair_sims = change["level_pair_sims"]
        else:
            ihs.rw_handling = P.RandomWalkHandling(change["rw_handling"])
        ch = P.ComputeHierarchy(**kw).init(
            data, 6, 6, ihs=ihs, lss=lss,
            rws=P.RandomWalkSettings(num_random_walks=4,
                                     single_walk_length=3),
            nns=P.NearestNeighborsSettings(num_nearest_neighbors=6))
        ch.compute()
        h = ch.image_hierarchy.hierarchy
        out.append((list(h.num_components),
                    [ch.level_similarities.get_prob_dist(lv).to_dense()
                     for lv in range(h.num_levels)]))
    (jl, jp), (tl, tp) = out
    assert tl == jl and len(tl) >= 2
    for a, b in zip(jp, tp):
        assert np.abs(np.asarray(a) - b).max() <= 1e-6

