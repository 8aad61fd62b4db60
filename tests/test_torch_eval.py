"""The port's run_evaluation against the JAX package's: grid parsing,
run expansion and hash names, the IO and segmentation scores, whole grid
runs end to end (port on device="cpu" against sph_tpu on JAX-CPU, a 20x16x8 TIFF
through a TSNE and a UMAP grid), and the CLI's exit codes."""

import dataclasses
import enum
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sph_tpu as J
from sph_tpu.evaluation import run_evaluation as jre
from sph_tpu.evaluation import segmentation as jseg
from sph_tpu.evaluation import settings as jes
from sph_tpu.ops import sparse as jsparse
from sph_tpu.utils import io as jio
import sph_tpu_torch as T
from sph_tpu_torch.evaluation import run_evaluation as tre
from sph_tpu_torch.evaluation import segmentation as tseg
from sph_tpu_torch.evaluation import settings as tes
from sph_tpu_torch.ops import sparse as tsparse
from sph_tpu_torch.utils import io as tio
from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
from test_torch_reference_native import use_reference_native

use_reference_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KL_RTOL = 0.01          # tests/test_torch_pipeline.py:129
# levels held to KL_RTOL: below ~100 points the schedule's 500 iterations at
# perplexity 10 part the two packages' float32 trajectories within ten
# iterations and end in different local minima (port against JAX from one
# P and one layout: 1e-5 apart after one step, KLs 11-30 % apart at 26 and
# 10 points after 500)
KL_MIN_POINTS = 100
STATS_ATOL = 1e-6
MEMBERSHIP_ATOL = 1e-6
# the walk levels' memberships: their inputs, the pairwise walk
# similarities, already differ in float32 summation order (the walks' visit
# sums: 2e-7 on this scene, 3e-6 in level 1's t-SNE P, see
# tests/test_torch_pipeline.py), which the smooth-knn sigma search carries
# to 8e-5 in level 1's memberships
WALK_MEMBERSHIP_ATOL = 1e-4

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small torch ops: one thread each keeps parallel test
    workers from stalling one another's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY_GRID = {
    "inputPath": "data", "cachePathBase": "out/tiny", "imgFormat": "TIFFSTACK",
    "imageNames": ["scene.tiff", "other.tiff"],
    "componentSim": ["NEIGH_WALKS", "GEO_CENTROID", "NEIGH_OVERLAP"],
    "dataInputNorm": ["NONE", "STANDARD"], "dataDistNorm": ["TSNE", "UMAP"],
    "neighborConnection": ["FOUR", "EIGHT"], "neighborSymmetries": [True],
    "nKnns": [0, 30], "knnMetric": ["L2", "COSINE"],
    "randomWalkNums": [20, 500], "randomWalkLens": [8],
    "randomWalkStepWeight": ["NORMAL", "CONSTANT"],
    "randomWalkHandling": ["MERGE_RW_ONLY"], "randomWalkPairSims": [True],
    "initEmbeddingDataLevel": "SPECTRAL", "skipEmbeddingUMAP": True,
    "initLevelEmbWithPrevious": True, "skipExistingSettings": False}


def _plain(obj):
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _grid_files(tmp_path):
    tiny = tmp_path / "tiny.json"
    tiny.write_text(json.dumps(TINY_GRID))
    return {"pines_embed": os.path.join(REPO, "configs", "pines_embed.json"),
            "rgb_bus_geo": os.path.join(REPO, "configs", "rgb_bus_geo.json"),
            "tiny": str(tiny)}


@pytest.mark.parametrize("grid", ["pines_embed", "rgb_bus_geo", "tiny"])
def test_grid_parsing_and_run_names_equal(tmp_path, grid):
    path = _grid_files(tmp_path)[grid]
    js, ts = jes.load_eval_settings(path), tes.load_eval_settings(path)
    assert _plain(dataclasses.asdict(ts)) == _plain(dataclasses.asdict(js))
    jruns, truns = list(jes.expand_runs(js)), list(tes.expand_runs(ts))
    assert len(truns) == len(jruns) >= 1
    for jr, tr in zip(jruns, truns):
        assert _plain(tr) == _plain(jr)
        assert tes.settings_string(tr) == jes.settings_string(jr)
        assert (tio.create_short_hash(tes.settings_string(tr))
                == jio.create_short_hash(jes.settings_string(jr)))
        assert (tes.only_geodesic_settings(tr["component_sim"])
                == jes.only_geodesic_settings(jr["component_sim"]))


def test_run_schedules_equal():
    for n in (1, 5, 99, 100, 1000, 99_999, 100_000, 199_999, 250_000):
        assert tre.tsne_iterations_for(n) == jre.tsne_iterations_for(n)
        assert tre.default_k(n) == jre.default_k(n)
        for prev in (False, True):
            assert (tre.umap_epochs_for(n, prev)
                    == jre.umap_epochs_for(n, prev))
    assert tre.MEM_LIMIT == jre.MEM_LIMIT


# ---------------------------------------------------------------------------
# IO and segmentation
# ---------------------------------------------------------------------------

def _labels(rows=9, cols=7, seed=0):
    return np.random.default_rng(seed).integers(0, 5, rows * cols)


def test_label_images_byte_equal_and_cross_read(tmp_path):
    lab = _labels()
    tio.save_label_image(lab, 9, 7, str(tmp_path / "t.tiff"))
    jio.save_label_image(lab, 9, 7, str(tmp_path / "j.tiff"))
    assert (tmp_path / "t.tiff").read_bytes() == (
        tmp_path / "j.tiff").read_bytes()
    from PIL import Image
    with Image.open(tmp_path / "t.tiff") as im:
        assert np.array_equal(np.asarray(im).ravel(), lab.astype(np.float32))
    assert np.array_equal(tio.load_label_image(str(tmp_path / "j.tiff")),
                          lab.astype(np.float32))


def test_level_images_byte_equal(tmp_path):
    h = T.Hierarchy()
    h.init_first_level(63)
    h.pixel_components.append(_labels(seed=1))
    h.num_components.append(5)
    tio.save_level_images(h, 9, 7, str(tmp_path / "t"))
    jio.save_level_images(h, 9, 7, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == ["level_0.tiff", "level_1.tiff"]
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()


def test_tiff_stacks_and_rgb_images_read_equal(tmp_path):
    img = create_hyperspectral_scene(9, 7, 5, seed=2)
    tio.save_tiff_stack(str(tmp_path / "s.tiff"), img)
    a = tio.load_image(str(tmp_path / "s.tiff"))
    b = jio.load_image(str(tmp_path / "s.tiff"))
    assert (a.rows, a.cols, a.num_points) == (b.rows, b.cols, b.num_points)
    assert np.array_equal(a.data, b.data)
    assert np.array_equal(a.data, img.reshape(-1, 5))
    from PIL import Image
    rgb = np.random.default_rng(3).integers(0, 256, (6, 8, 3), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "c.png")
    a = tio.load_image(str(tmp_path / "c.png"), "rgb")
    b = jio.load_image(str(tmp_path / "c.png"), "rgb")
    assert np.array_equal(a.data, b.data) and a.data.shape == (48, 3)


def test_binary_and_text_outputs_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((11, 2)).astype(np.float32)
    vecs = [np.arange(4), rng.integers(0, 9, 7), np.zeros(0, np.int64)]
    for pkg, sub in ((tio, "t"), (jio, "j")):
        os.makedirs(tmp_path / sub)
        pkg.write_embedding(str(tmp_path / sub / "e.bin"), emb)
        pkg.write_vec_of_vec(str(tmp_path / sub / "v.bin"), vecs)
        pkg.save_setting_hashes(str(tmp_path / sub / "h.json"),
                                [("ab12", "x=1"), ("cd34", "y=2")])
    tio.save_settings_snapshot(str(tmp_path / "t" / "s.txt"),
                               T.NearestNeighborsSettings(),
                               T.ImageHierarchySettings())
    jio.save_settings_snapshot(str(tmp_path / "j" / "s.txt"),
                               J.NearestNeighborsSettings(),
                               J.ImageHierarchySettings())
    for name in ("e.bin", "v.bin", "h.json", "s.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()
    assert np.array_equal(tio.read_embedding(str(tmp_path / "j" / "e.bin")),
                          emb)
    for a, b in zip(tio.read_vec_of_vec(str(tmp_path / "j" / "v.bin")),
                    vecs):
        assert np.array_equal(a, b)


def test_segmentation_scores_equal():
    rows, cols = 18, 14
    labels = (np.arange(rows * cols) // 37) % 4
    h = T.Hierarchy()
    h.init_first_level(rows * cols)
    for seed, count in ((5, 40), (6, 9)):
        comp = np.random.default_rng(seed).integers(0, count, rows * cols)
        h.pixel_components.append(comp)
        h.num_components.append(count)
    assert (tseg.score_hierarchy(h, labels, rows, cols)
            == jseg.score_hierarchy(h, labels, rows, cols))
    comp = h.pixel_components[1]
    assert tseg.nmi(comp, labels) == jseg.nmi(comp, labels)
    assert (tseg.boundary_recall(comp, labels, rows, cols)
            == jseg.boundary_recall(comp, labels, rows, cols))
    assert (tseg.majority_accuracy(comp, labels)
            == jseg.majority_accuracy(comp, labels))


# ---------------------------------------------------------------------------
# whole grid runs end to end
# ---------------------------------------------------------------------------

def _e2e_grid(root, norm: str) -> dict:
    return {
        "inputPath": str(root / "data"), "imgFormat": "TIFFSTACK",
        "imageNames": ["scene.tiff"], "componentSim": ["NEIGH_WALKS"],
        "dataInputNorm": ["NONE"], "dataDistNorm": [norm],
        "neighborConnection": ["FOUR"], "neighborSymmetries": [True],
        "neighborConnectComponents": [True], "knnMetric": ["L2"],
        "nKnns": [30], "randomWalkNums": [20], "randomWalkLens": [8],
        "randomWalkStepWeight": ["NORMAL"],
        "randomWalkHandling": ["MERGE_RW_ONLY"],
        "randomWalkReduction": ["PROPORTIONAL_COMPONENT_REDUCTION"],
        "randomWalkWeightSize": [True], "randomWalkPairSims": [True],
        "weightTransitionBySize": [False], "initEmbeddingDataLevel": "PCA",
        "skipEmbeddingTSNE": norm == "UMAP",
        "skipEmbeddingUMAP": norm != "UMAP",
        "initLevelEmbWithPrevious": True}


def _run_both(root, norm: str) -> dict:
    """Both packages' run_evaluation on one 20x16x8 TIFF, each under its own output base;
    every embedding's input and (t-SNE) final KL kept."""
    os.makedirs(root / "data", exist_ok=True)
    tio.save_tiff_stack(str(root / "data" / "scene.tiff"),
                        create_hyperspectral_scene(20, 16, 8, seed=7))
    seen = {"jax": [], "port": []}

    class JaxEmbedding(jre.ComputeEmbedding):
        def compute_tsne(self, inp, track_kl=False):
            emb = super().compute_tsne(inp, track_kl=True)
            seen["jax"].append({"kl": float(self.last_kl)})
            return emb

        def compute_umap(self, inp):
            seen["jax"].append(
                {"m": jsparse.symmetrize_umap(inp).to_dense()})
            return super().compute_umap(inp)

    class PortEmbedding(tre.ComputeEmbedding):
        def compute_umap(self, inp, device_path=False):
            seen["port"].append({"m": tsparse.symmetrize_umap(
                inp, device_path=device_path).to_dense()})
            return super().compute_umap(inp, device_path=device_path)

    out = {"seen": seen}
    for name, mod, load, kw in (
            ("jax", jre, jes.load_eval_settings, {}),
            ("port", tre, tes.load_eval_settings,
             {"device": "cpu", "report": []})):
        grid = dict(_e2e_grid(root, norm),
                    cachePathBase=str(root / f"out_{name}"))
        path = root / f"grid_{name}.json"
        path.write_text(json.dumps(grid))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "ComputeEmbedding",
                       JaxEmbedding if name == "jax" else PortEmbedding)
            try:
                mod.run_evaluation(load(str(path)), **kw)
                out[f"{name}_raised"] = None
            except ValueError as exc:
                out[f"{name}_raised"] = exc
        (out[name],) = glob.glob(str(root / f"out_{name}" / "scene"
                                     / "neigh_walks_*"))
        out[f"{name}_report"] = kw.get("report")
    return out


@pytest.fixture(scope="module")
def tsne_runs(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("tsne"), "TSNE")


@pytest.fixture(scope="module")
def umap_runs(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("umap"), "UMAP")


def _hierarchy_outputs_equal(runs):
    jdir, tdir = runs["jax"], runs["port"]
    # the run folder: <sim>_<handling>_<hash>_<time>_<run>, the same hash
    assert (os.path.basename(tdir).rsplit("_", 2)[0]
            == os.path.basename(jdir).rsplit("_", 2)[0])
    names = sorted(os.listdir(jdir))
    levels = [n for n in names if n.startswith("level_")]
    assert len(levels) >= 4
    for name in levels + ["component.tiff", "MapFromLevelToBottom.bin",
                          "MapFromBottomToLevel.bin", "sph_settings.txt"]:
        with open(os.path.join(jdir, name), "rb") as a, open(
                os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    for name in ("sph_stats_imh.txt", "sph_stats_ls.txt"):
        with open(os.path.join(jdir, name)) as a, open(
                os.path.join(tdir, name)) as b:
            ja, tb = json.load(a), json.load(b)
        assert ja.keys() == tb.keys()
        for key in ja:
            assert np.allclose(np.asarray(tb[key], float),
                               np.asarray(ja[key], float), rtol=0,
                               atol=STATS_ATOL), (name, key)
    return levels


def test_tsne_grid_end_to_end(tsne_runs):
    """Level images and maps byte-equal, stats within 1e-6, the final
    t-SNE KL of every level of at least KL_MIN_POINTS points within 1 % of
    the JAX package's and below its starting layout's, and every layout
    finite."""
    assert tsne_runs["jax_raised"] is None is tsne_runs["port_raised"]
    levels = _hierarchy_outputs_equal(tsne_runs)
    report = tsne_runs["port_report"][0]
    assert report["levels"][0] == 320 and len(report["levels"]) == len(
        levels)
    assert not report["knn_loaded_from_cache"]
    jkl = [s["kl"] for s in tsne_runs["seen"]["jax"]]
    emb = report["embeddings"]
    assert [e["level"] for e in emb] == list(range(len(levels)))
    assert len(jkl) == len(emb)
    held = 0
    for e, want in zip(emb, jkl):
        assert e["method"] == "tsne" and np.isfinite(e["kl"])
        if e["n"] >= KL_MIN_POINTS:
            assert abs(e["kl"] - want) <= KL_RTOL * want, (e, want)
            assert e["kl"] < e["kl_start"]
            held += 1
    assert held >= 1
    for lv in range(len(levels)):
        a = tio.read_embedding(os.path.join(tsne_runs["port"],
                                            f"emb_tsne_{lv}.bin"))
        assert a.shape == (report["levels"][lv], 2) and np.all(
            np.isfinite(a))


def test_umap_grid_end_to_end(umap_runs):
    """Level images and maps byte-equal, stats within 1e-6, the data
    level's memberships (the fuzzy union of its probdist) within 1e-6 and
    the walk levels' within 1e-4, on the same support.  The JAX
    package's run_evaluation raises on the first level whose memberships were all
    pruned (make_epochs_per_sample of no weights); the port embeds every
    level and leaves that one at its starting layout."""
    levels = _hierarchy_outputs_equal(umap_runs)
    assert umap_runs["port_raised"] is None
    assert isinstance(umap_runs["jax_raised"], ValueError)
    jm = [s["m"] for s in umap_runs["seen"]["jax"]]
    tm = [s["m"] for s in umap_runs["seen"]["port"]]
    assert len(tm) == len(levels)
    assert 2 <= len(jm) <= len(tm)
    for level, (a, b) in enumerate(zip(tm, jm)):
        assert np.array_equal(a > 0, b > 0)
        assert np.abs(a - b).max() <= (MEMBERSHIP_ATOL if level == 0
                                       else WALK_MEMBERSHIP_ATOL)
    empty = len(jm) - 1
    assert not tm[empty].any() and jm[empty].size and not jm[empty].any()
    report = umap_runs["port_report"][0]
    # the report counts that level's memberships as 0, and the log warns
    counts = [e["memberships"] for e in report["embeddings"]]
    assert counts[empty] == 0 and all(c > 0 for c in counts[:empty])
    (log,) = glob.glob(os.path.join(
        os.path.dirname(os.path.dirname(umap_runs["port"])), "Log_*.txt"))
    with open(log) as f:
        assert "UMAP: no memberships among" in f.read()
    h_parents = tio.read_vec_of_vec(os.path.join(umap_runs["port"],
                                                 "MapFromBottomToLevel.bin"))
    prev = tio.read_embedding(os.path.join(umap_runs["port"],
                                           f"emb_umap_{empty - 1}.bin"))
    got = tio.read_embedding(os.path.join(umap_runs["port"],
                                          f"emb_umap_{empty}.bin"))
    # the starting layout: the mean of each component's children, scaled
    parents = np.zeros(report["levels"][empty - 1], np.int64)
    parents[h_parents[empty - 1]] = h_parents[empty]
    want = T.scale_embedding_to_one(T.average_position_of_children(
        prev, parents, report["levels"][empty]))
    assert np.array_equal(got, want)
    for e in report["embeddings"]:
        assert e["method"] == "umap"
        assert e["epochs"] == (500 if e["level"] == 0 else 175)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "sph_tpu_torch.evaluation.run_evaluation",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=600)


@pytest.mark.parametrize("argv,code", [
    ([], 2), (["a.json", "b.json"], 2), (["--device"], 2),
    (["a.json", "--device", "tpu"], 2), (["missing.json"], 1),
    (["bad.json", "--device", "cpu"], 1)])
def test_cli_exit_codes(tmp_path, argv, code):
    (tmp_path / "bad.json").write_text("{not json")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert tre.main(argv) == code
    finally:
        os.chdir(cwd)


def test_cli_runs_a_grid_on_the_cpu(tmp_path):
    grid = dict(_e2e_grid(tmp_path, "TSNE"), cachePathBase="out",
                skipEmbeddingTSNE=True)
    os.makedirs(tmp_path / "data")
    tio.save_tiff_stack(str(tmp_path / "data" / "scene.tiff"),
                        create_hyperspectral_scene(10, 8, 4, seed=1))
    (tmp_path / "grid.json").write_text(json.dumps(grid))
    proc = _cli(["grid.json", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    (run,) = glob.glob(str(tmp_path / "out" / "scene" / "neigh_walks_*"))
    assert os.path.exists(os.path.join(run, "MapFromBottomToLevel.bin"))
    assert glob.glob(str(tmp_path / "out" / "scene" / "knn" / "*" /
                         "scene_nns_payload.sph4"))
    assert glob.glob(str(tmp_path / "out" / "scene" / "*_hashes.json"))


def test_without_a_card_run_evaluation_raises_the_port_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is CUDA")
    (tmp_path / "grid.json").write_text(json.dumps(
        dict(_e2e_grid(tmp_path, "TSNE"), cachePathBase=str(tmp_path))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tre.main([str(tmp_path / "grid.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tre.run_evaluation(tes.load_eval_settings(
            str(tmp_path / "grid.json")))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_tiny_levels_embed_as_the_jax_package(n):
    """Pines' last levels (17, 5, 1 components): one point is not
    embedded (a zero layout, KL 0); from 2 points on both packages take
    the dense tier at the same padding, and one iteration from one layout
    agrees to the float32 band."""
    rng = np.random.default_rng(n)
    idx = np.stack([np.roll(np.arange(n), -i) for i in range(n)]).astype(
        np.int32)
    val = rng.random((n, n)).astype(np.float32)
    val[:, 0] = 0.0               # column 0 is each row's self entry
    val /= np.maximum(val.sum(1, keepdims=True), 1e-12)
    pj = jsparse.symmetrize_tsne(J.SparseRows(idx, val, n))
    pt = tsparse.symmetrize_tsne(T.SparseRows(idx, val, n, device="cpu"))
    init = (rng.standard_normal((n, 2)) * 1e-2).astype(np.float32)
    out = []
    for P, p, kw in ((J, pj, {}), (T, pt, {"device": "cpu"})):
        es = P.ComputeEmbeddingSettings()
        es.tsne.num_iterations = 1
        ce = P.ComputeEmbedding(es, **kw)
        ce.init_embedding(n, init)
        out.append((ce.compute_tsne(p, track_kl=True), ce.last_kl))
    (ej, kj), (et, kt) = out
    assert et.shape == ej.shape == (n, 2)
    if n == 1:
        assert not et.any() and kt == kj == 0.0
        return
    scale = float(np.abs(ej).max())
    assert np.abs(et - ej).max() <= 1e-5 * max(scale, 1e-3)
    assert abs(kt - kj) <= 1e-5 * max(abs(kj), 1e-3)


def test_sparse_matrix_stats_equal():
    from sph_tpu.utils.stats import SparseMatrixStats as JStats
    from sph_tpu_torch.utils.stats import SparseMatrixStats as TStats
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 30, (30, 5)).astype(np.int32)
    idx[:, 0] = np.arange(30)
    dist = np.sort(rng.random((30, 5)).astype(np.float32), 1)
    counts = rng.integers(1, 6, 30).astype(np.int32)
    pidx = np.where(np.arange(5)[None, :] < counts[:, None], idx, -1)
    sval = np.where(pidx >= 0, dist, 0.0).astype(np.float32)
    for jobj, tobj in (
            (J.KnnGraph(idx, dist), T.KnnGraph(idx, dist)),
            (J.PaddedGraph(pidx, np.where(pidx >= 0, dist, np.inf), counts),
             T.PaddedGraph(pidx, np.where(pidx >= 0, dist, np.inf), counts)),
            (J.SparseRows(pidx, sval, 40),
             T.SparseRows(pidx, sval, 40, device="cpu"))):
        assert (dataclasses.asdict(TStats.of(tobj))
                == dataclasses.asdict(JStats.of(jobj)))
