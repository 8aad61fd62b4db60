#!/usr/bin/env python3
"""Where the port's results on the card first part from its results on the
CPU, for the two places where the card's results drift from the JAX-CPU
records: multi_scene's data-level walk rows and the memberships of Pines
level 0 under UMAP normalisation.

    python3 scripts/card_divergence_readout.py [--out FILE] [--only multi,umap]

Needs a CUDA card.  On the CPU the port equals the JAX package in both
places (tests/test_torch_parallel.py, tests/test_torch_eval.py), so each
part runs the same function on the card and on the CPU and compares step
by step; where a step's inputs differ, it also runs the step on the CPU
from the card's inputs, so that a difference is placed in the step that
makes it, not in one that only carries it.

multi: scene 0 of multi_scene's stack (create_hyperspectral_scene(145,
145, 200, seed=7), the flagship settings, k = 91) through
parallel.sharded.multi_scene_stage1 on [cuda] and on [cpu]: the kNN ids,
the distances in ulps, the probabilities, the walk rows under CONSTANT
step weights (bit-equal to the JAX package's on the CPU) and under NORMAL
ones; then the card's batched kNN (_scene_knn, torch.bmm) against the
one-scene kNN (ops/knn._knn_rows, torch.mm) on the card.

umap: Pines level 0 as configs/pines_embed.json with dataDistNorm UMAP
builds it (k = 91, symmetric, connected, L2): the kNN graph, the
smooth-knn rows (distance_rows_to_probabilities, UMAP), the level's P
after the zero-drop, the fuzzy union (symmetrize_umap) and the count of
memberships UmapComputation keeps (values > 0), on the card and on the
CPU, with the rows that differ.

Writes one JSON object (default out/card_divergence.json) and
prints a line for each part.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINES_SHAPE = (145, 145, 200)
SEED = 7
K = 91
CARD = "cuda"       # --card cpu rehearses the script small on the CPU


def ulps(a, b) -> dict:
    """Distance in float32 units in the last place between equal-shaped
    arrays: the largest, the count of differing entries and the rows
    holding one."""
    import numpy as np
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = np.abs(ia - ib)
    rows = d.reshape(d.shape[0], -1).any(1) if d.ndim > 1 else d > 0
    return {"max_ulps": int(d.max()) if d.size else 0,
            "entries_differing": int((d > 0).sum()),
            "entries": int(d.size), "rows_differing": int(rows.sum())}


def rows_equal(ia, va, ib, vb) -> dict:
    """Sparse rows (ids, values; -1 or 0 pads) against each other: rows
    with equal live ids, rows bit-equal, the largest total variation."""
    import numpy as np
    same_ids = same_bits = 0
    tv_max = 0.0
    for r in range(ia.shape[0]):
        oa = (ia[r] >= 0) & (va[r] != 0)
        ob = (ib[r] >= 0) & (vb[r] != 0)
        ga, gb = ia[r][oa], ib[r][ob]
        xa, xb = va[r][oa], vb[r][ob]
        if ga.size == gb.size and np.array_equal(ga, gb):
            same_ids += 1
            same_bits += int(np.array_equal(xa, xb))
        cols = np.union1d(ga, gb)
        a = np.zeros(cols.size)
        b = np.zeros(cols.size)
        a[np.searchsorted(cols, ga)] = xa
        b[np.searchsorted(cols, gb)] = xb
        tv_max = max(tv_max, 0.5 * float(np.abs(a - b).sum()))
    return {"rows": int(ia.shape[0]), "rows_ids_equal": same_ids,
            "rows_bit_equal": same_bits, "total_variation_max": tv_max}


def multi_part() -> dict:
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import _knn_rows, KnnMetric
    from sph_tpu_torch.ops.walks import do_random_walks
    from sph_tpu_torch.parallel import sharded
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    rows, cols, bands = PINES_SHAPE
    data = create_hyperspectral_scene(rows, cols, bands, seed=SEED).reshape(
        1, rows * cols, bands).astype(np.float32)
    n = data.shape[1]
    out = {"scene": "create_hyperspectral_scene(145, 145, 200, seed=7)",
           "k": K}
    runs = {}
    for dev in (CARD, "cpu"):
        t = time.perf_counter()
        r = {}
        for weight in ("CONSTANT", "NORMAL"):
            rws = T.RandomWalkSettings(
                num_random_walks=50, single_walk_length=10, random_seed=1,
                importance_weighting=getattr(T.ImportanceWeighting, weight))
            res = sharded.multi_scene_stage1(data, K, rws,
                                             T.NormalizationScheme.TSNE,
                                             mesh=[torch.device(dev)])
            r.setdefault("idx", res["idx"][0])
            r.setdefault("dist", res["dist"][0])
            r.setdefault("probs", res["probs"][0])
            r[weight] = (res["walks_idx"][0], res["walks_val"][0])
        r["seconds"] = time.perf_counter() - t
        runs[dev] = r
    g, c = runs[CARD], runs["cpu"]
    out["seconds"] = {d: runs[d]["seconds"] for d in runs}
    out["knn_ids_equal"] = bool(np.array_equal(g["idx"], c["idx"]))
    out["knn_id_rows_differing"] = int((g["idx"] != c["idx"]).any(1).sum())
    out["dist_card_vs_cpu"] = ulps(g["dist"], c["dist"])
    out["probs_card_vs_cpu"] = ulps(g["probs"], c["probs"])
    # the probabilities from the card's distances, computed on the CPU:
    # equal to the card's -> the search itself is bit-equal on both
    probs_cpu_of_card = sharded._scene_probs(
        torch.as_tensor(g["dist"]), T.NormalizationScheme.TSNE).numpy()
    out["probs_card_vs_cpu_from_card_dist"] = ulps(g["probs"],
                                                   probs_cpu_of_card)
    for weight in ("CONSTANT", "NORMAL"):
        out[f"walks_{weight.lower()}_card_vs_cpu"] = rows_equal(
            *g[weight], *c[weight])
    # the walks from one P (the CPU's) on both: equal -> the draws are
    p_cpu = T.SparseRows(np.where(c["probs"] > 0, c["idx"], -1),
                         c["probs"], n, device="cpu")
    for weight in ("CONSTANT", "NORMAL"):
        rws = T.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10, random_seed=1,
            importance_weighting=getattr(T.ImportanceWeighting, weight))
        walks = []
        for dev in (CARD, "cpu"):
            w = do_random_walks(T.SparseRows(p_cpu.indices, p_cpu.values, n,
                                             device=dev), rws)
            walks += [w.indices, w.values]
        out[f"walks_{weight.lower()}_same_p_card_vs_cpu"] = rows_equal(
            *walks)
    # the batched kNN against the one-scene kNN, both on the card
    x = torch.as_tensor(data, device=CARD)
    bi, bd = sharded._scene_knn(x, K, n, sharded.SCENE_MEMORY_BUDGET)
    oi, od = _knn_rows(x[0], torch.arange(n, device=CARD), K,
                       KnnMetric.L2, False, 1 << 30)
    out["card_scene_knn_vs_knn_rows"] = {
        "ids_equal": bool(torch.equal(bi[0], oi)),
        "dist": ulps(bd[0].cpu().numpy(), od.cpu().numpy())}
    return out


def pines_level0(device: str, graph=None):
    """Pines level 0 under dataDistNorm UMAP, as run_evaluation wires
    configs/pines_embed.json: the kNN graph (or `graph`, the rows of
    another run's), the smooth-knn rows, the level's P and the fuzzy
    union."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.models.image_hierarchy import _graph_rows
    from sph_tpu_torch.models.umap import UmapComputation
    from sph_tpu_torch.ops.distributions import distance_rows_to_probabilities
    from sph_tpu_torch.ops.sparse import drop_zero_entries, shrink_width
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    out = {}
    if graph is None:
        img = create_hyperspectral_scene(*PINES_SHAPE, seed=SEED)
        data = T.scale(img.reshape(-1, PINES_SHAPE[2]).astype(np.float32),
                       T.Scaler.NONE)
        nns = T.NearestNeighborsSettings(
            num_nearest_neighbors=K, symmetric_neighbors=True,
            compute_connect_components=True,
            neighbor_connect_components=True, knn_metric=T.KnnMetric.L2)
        ihs = T.ImageHierarchySettings(
            component_sim=T.ComponentSim.NEIGH_WALKS,
            norm_knn_distances=T.NormalizationScheme.UMAP)
        ch = T.ComputeHierarchy(device=device).init(
            data, PINES_SHAPE[0], PINES_SHAPE[1], ihs,
            T.LevelSimilaritiesSettings(ks=[K]), T.RandomWalkSettings(), nns)
        ch.compute_knn_graph()
        graph = _graph_rows(ch.image_hierarchy._graph)
    idx, dist, mask = graph
    out["graph"] = graph
    n = idx.shape[0]
    mask_t = torch.as_tensor(mask, device=device)
    probs = distance_rows_to_probabilities(
        torch.as_tensor(np.asarray(dist, np.float32), device=device),
        mask_t, T.NormalizationScheme.UMAP, perplexity=-1.0,
        ignore_first=True, umap_row_norm=True)
    out["probs"] = probs.cpu().numpy()
    idx_t = torch.as_tensor(np.asarray(idx, np.int64), device=device)
    pd = drop_zero_entries(T.SparseRows(torch.where(mask_t, idx_t, -1),
                                        probs, n), shrink=False)
    nnz = pd.row_nnz()
    pd = shrink_width(pd, int(nnz.max()))
    out["p"] = (pd.indices, pd.values)
    u = UmapComputation(device=device)
    u.set_neighbor_matrix(pd)
    m = u._memberships()
    live = m.val[m.idx >= 0]
    out["union"] = (m.indices, m.values)
    out["memberships"] = int((live > 0).sum())
    return out


def umap_part() -> dict:
    import numpy as np
    g = pines_level0(CARD)
    c = pines_level0("cpu")
    # the CPU's functions on the card's kNN graph: where the card's rows
    # part from these, the step on the card differs on equal inputs
    gc = pines_level0("cpu", graph=g["graph"])
    out = {"memberships": {"card": g["memberships"], "cpu": c["memberships"],
                           "cpu_from_card_graph": gc["memberships"]}}
    gi, gd, _ = g["graph"]
    ci, cd, _ = c["graph"]
    out["knn_ids_equal"] = bool(np.array_equal(gi, ci))
    out["knn_id_rows_differing"] = int((gi != ci).any(1).sum())
    out["knn_dist_card_vs_cpu"] = ulps(gd, cd)
    out["smooth_knn_card_vs_cpu"] = ulps(g["probs"], c["probs"])
    out["smooth_knn_card_vs_cpu_from_card_graph"] = ulps(g["probs"],
                                                         gc["probs"])
    out["p_card_vs_cpu"] = rows_equal(*g["p"], *c["p"])
    out["p_card_vs_cpu_from_card_graph"] = rows_equal(*g["p"], *gc["p"])
    out["union_card_vs_cpu"] = rows_equal(*g["union"], *c["union"])
    out["union_card_vs_cpu_from_card_graph"] = rows_equal(*g["union"],
                                                          *gc["union"])
    # the entries behind the count: kept (> 0) on one side only
    def kept(u):
        ids, vals = u
        r = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)
        ok = (ids >= 0) & (vals > 0)
        return r[ok].astype(np.int64) * ids.shape[0] + ids[ok]
    kg, kc = kept(g["union"]), kept(c["union"])
    only_g, only_c = np.setdiff1d(kg, kc), np.setdiff1d(kc, kg)
    n = gi.shape[0]
    out["entries_only_on_card"] = int(only_g.size)
    out["entries_only_on_cpu"] = int(only_c.size)
    out["rows_with_entries_on_one_side"] = int(np.unique(np.concatenate(
        [only_g, only_c]) // n).size)
    out["sample_only_on_card"] = [[int(e // n), int(e % n)]
                                  for e in only_g[:8]]
    return out


def jax_multi_part() -> dict:
    """Scene 0's stage 1 on the card against the JAX package's
    multi_scene_stage1 on JAX-CPU, CONSTANT and NORMAL step weights."""
    import numpy as np
    import torch
    import sph_tpu as J
    import sph_tpu_torch as T
    from sph_tpu.parallel.sharded import multi_scene_stage1 as jax_stage1
    from sph_tpu_torch.parallel import sharded
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    rows, cols, bands = PINES_SHAPE
    data = create_hyperspectral_scene(rows, cols, bands, seed=SEED).reshape(
        1, rows * cols, bands).astype(np.float32)
    out = {}
    for weight in ("CONSTANT", "NORMAL"):
        got = sharded.multi_scene_stage1(
            data, K, T.RandomWalkSettings(
                num_random_walks=50, single_walk_length=10, random_seed=1,
                importance_weighting=getattr(T.ImportanceWeighting, weight)),
            T.NormalizationScheme.TSNE, mesh=[torch.device(CARD)])
        t = time.perf_counter()
        want = jax_stage1(data, K, rws=J.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10, random_seed=1,
            importance_weighting=getattr(J.ImportanceWeighting, weight)),
            norm=J.NormalizationScheme.TSNE)
        w = weight.lower()
        out[f"jax_seconds_{w}"] = time.perf_counter() - t
        if weight == "CONSTANT":
            out["knn_ids_equal"] = bool(np.array_equal(
                got["idx"][0], np.asarray(want["idx"])[0]))
            out["dist_card_vs_jax"] = ulps(got["dist"][0],
                                           np.asarray(want["dist"])[0])
            out["probs_card_vs_jax"] = ulps(got["probs"][0],
                                            np.asarray(want["probs"])[0])
        out[f"walks_{w}_card_vs_jax"] = rows_equal(
            got["walks_idx"][0], got["walks_val"][0],
            np.asarray(want["walks_idx"])[0], np.asarray(want["walks_val"])[0])
    return out


def jax_driver_level0():
    """The JAX package's evaluation driver on JAX-CPU on the Pines grid
    with dataDistNorm UMAP (scripts/eval_pines_reference.py's counting
    pass, which made the record): (its ComputeHierarchy, level 0's P as
    the driver hands it to UMAP, seconds)."""
    import shutil
    import tempfile
    import numpy as np
    import chip_smoke
    from sph_tpu.evaluation import run_evaluation as jre
    from sph_tpu.evaluation.settings import load_eval_settings
    from sph_tpu.utils.testdata import create_hyperspectral_scene
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from eval_pines_reference import write_stack
    seen = {"ch": [], "p": []}

    class Hierarchy(jre.ComputeHierarchy):
        def init(self, *a, **kw):
            seen["ch"].append(self)
            return super().init(*a, **kw)

    class Embedding(jre.ComputeEmbedding):
        def compute_umap(self, inp):
            seen["p"].append(inp)
            self.current_embedding = np.zeros((int(inp.num_rows), 2),
                                              np.float32)
            return self.current_embedding

    saved = jre.ComputeHierarchy, jre.ComputeEmbedding
    jre.ComputeHierarchy, jre.ComputeEmbedding = Hierarchy, Embedding
    root = tempfile.mkdtemp(prefix="card_divergence_")
    try:
        img = create_hyperspectral_scene(*PINES_SHAPE, seed=SEED)
        grid = chip_smoke.eval_grid(root, img, write_stack, "pines_umap",
                                    **chip_smoke.EVAL_UMAP)
        t = time.perf_counter()
        jre.run_evaluation(load_eval_settings(grid), max_runs=1)
        seconds = time.perf_counter() - t
    finally:
        jre.ComputeHierarchy, jre.ComputeEmbedding = saved
        shutil.rmtree(root, ignore_errors=True)
    return seen["ch"][0], seen["p"][0], seconds


def jax_umap_part() -> dict:
    """Pines level 0 under UMAP: the JAX package's evaluation driver on
    JAX-CPU (``jax_driver_level0``: level 0's P, its graph and its
    data-level rows) against the port's chain on the card."""
    import numpy as np
    from sph_tpu.ops.sparse import symmetrize_umap as jax_union
    ch, p0, jax_s = jax_driver_level0()
    g = pines_level0(CARD)
    out = {"jax_driver_seconds": jax_s}
    graph = ch.image_hierarchy._graph
    jmask = (np.asarray(graph.mask) if hasattr(graph, "mask")
             else np.ones_like(graph.indices, bool))
    jidx = np.where(jmask, graph.indices, -1)
    jdist = np.where(jmask, graph.distances, 0.0).astype(np.float32)
    gi, gd, gm = g["graph"]
    out["graph_shapes"] = {"card": list(gi.shape), "jax": list(jidx.shape)}
    if gi.shape == jidx.shape:
        out["knn_ids_equal"] = bool(np.array_equal(np.where(gm, gi, -1),
                                                   jidx))
        out["knn_dist_card_vs_jax"] = ulps(np.where(gm, gd, 0.0), jdist)
        jp = ch.image_hierarchy.data_level_probdist
        out["smooth_knn_card_vs_jax"] = ulps(
            g["probs"], np.where(jmask, np.asarray(jp.values), 0.0))
    jp_idx = np.where(np.asarray(p0.mask), p0.indices, -1)
    out["p_card_vs_jax"] = rows_equal(*g["p"], jp_idx,
                                      np.asarray(p0.values))
    ju = jax_union(p0)
    ju_idx = np.where(np.asarray(ju.mask), ju.indices, -1)
    ju_val = np.asarray(ju.values)
    out["union_card_vs_jax"] = rows_equal(*g["union"], ju_idx, ju_val)
    out["memberships"] = {"card": g["memberships"], "jax": int(np.sum(
        (ju_idx >= 0) & (ju_val > 0)))}
    n = jp_idx.shape[0]
    for name, mine, theirs in (("p", g["p"], (jp_idx, np.asarray(p0.values))),
                               ("union", g["union"], (ju_idx, ju_val))):
        out[f"{name}_entries"] = entry_diff(mine, theirs, n)
    return out


ISA_VARIANTS = ("", "--xla_cpu_max_isa=AVX2", "--xla_cpu_max_isa=AVX512")


def jax_level0(dump: str) -> dict:
    """Level 0's P and fuzzy union from ``jax_driver_level0``, saved to
    `dump`."""
    import numpy as np
    from sph_tpu.ops.sparse import symmetrize_umap
    _, p0, seconds = jax_driver_level0()
    u = symmetrize_umap(p0)
    u_idx = np.where(np.asarray(u.mask), u.indices, -1)
    u_val = np.asarray(u.values)
    np.savez(dump, p_idx=np.where(np.asarray(p0.mask), p0.indices, -1),
             p_val=np.asarray(p0.values), u_idx=u_idx, u_val=u_val)
    return {"memberships": int(((u_idx >= 0) & (u_val > 0)).sum()),
            "seconds": seconds}


def jax_isa_part() -> dict:
    """Pines level 0's P and fuzzy union by the JAX package's driver on
    JAX-CPU with XLA's CPU code generator capped at each instruction set in
    ISA_VARIANTS (each in a process of its own), against the port's chain
    on the card: whether JAX-CPU's own bits move with the host's vector
    units."""
    import subprocess
    import tempfile
    import numpy as np
    g = pines_level0(CARD)
    out = {"cpu": _cpu_model(), "port_card_memberships": g["memberships"]}
    for flags in ISA_VARIANTS:
        with tempfile.TemporaryDirectory() as tmp:
            dump = os.path.join(tmp, "level0.npz")
            env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": flags}
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--only",
                 "jax_level0", "--dump", dump, "--card", "cpu",
                 "--side", str(PINES_SHAPE[0])],
                env=env, capture_output=True, text=True, timeout=1200)
            rec = {"seconds": time.perf_counter() - t,
                   "rc": proc.returncode}
            if proc.returncode != 0:
                rec["stderr"] = proc.stderr[-2000:]
                out[flags or "default"] = rec
                continue
            z = np.load(dump)
            n = z["p_idx"].shape[0]
            rec["p_entries"] = entry_diff(g["p"], (z["p_idx"], z["p_val"]), n)
            rec["union_entries"] = entry_diff(g["union"],
                                              (z["u_idx"], z["u_val"]), n)
            rec["memberships"] = int(((z["u_idx"] >= 0)
                                      & (z["u_val"] > 0)).sum())
        out[flags or "default"] = rec
    return out


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read()
    except OSError:
        return "unknown"
    model = next((ln.split(":", 1)[1].strip() for ln in text.splitlines()
                  if ln.startswith("model name")), "unknown")
    flags = next((ln.split(":", 1)[1].split() for ln in text.splitlines()
                  if ln.startswith("flags")), [])
    return f"{model}; avx512f {'avx512f' in flags}; avx2 {'avx2' in flags}"


def entry_diff(mine, theirs, n: int) -> dict:
    """Sparse rows (ids, values) against each other entry by entry: the
    entries present (nonzero) on one side only, with their values' range
    and how many are float32 subnormals; on the entries both hold, how many
    differ and by how many ulps at most."""
    import numpy as np

    def keyed(ids, vals):
        ids = np.asarray(ids)
        vals = np.asarray(vals, np.float32)
        r = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)
        ok = (ids >= 0) & (vals != 0)
        keys = r[ok].astype(np.int64) * n + ids[ok]
        order = np.argsort(keys)
        return keys[order], vals[ok][order]

    km, vm = keyed(*mine)
    kt, vt = keyed(*theirs)
    out = {}
    for side, (ka, va, kb) in (("card_only", (km, vm, kt)),
                               ("jax_only", (kt, vt, km))):
        only = ~np.isin(ka, kb)
        v = va[only]
        out[side] = {"entries": int(only.sum()),
                     "rows": int(np.unique(ka[only] // n).size),
                     "abs_min": float(np.abs(v).min()) if v.size else None,
                     "abs_max": float(np.abs(v).max()) if v.size else None,
                     "subnormal": int((np.abs(v) < 2.0 ** -126).sum()),
                     "sample": [[int(k // n), int(k % n), float(x)]
                                for k, x in zip(ka[only][:6], v[:6])]}
    both_m = np.isin(km, kt)
    both_t = np.isin(kt, km)
    out["both"] = {"entries": int(both_m.sum()),
                   **ulps(vm[both_m], vt[both_t])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "out", "card_divergence.json"))
    ap.add_argument("--only", default="multi,umap")
    ap.add_argument("--card", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--dump", default="", help=argparse.SUPPRESS)
    ap.add_argument("--side", type=int, default=145, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    global CARD, PINES_SHAPE
    CARD = args.card
    PINES_SHAPE = (args.side, args.side, PINES_SHAPE[2])
    if CARD == "cuda" and not torch.cuda.is_available():
        print("card_divergence_readout: needs a CUDA card", file=sys.stderr)
        return 2
    from sph_tpu_torch.utils.logging import set_level
    set_level("WARNING")
    result = {"device": (torch.cuda.get_device_name(0) if CARD == "cuda"
                         else "cpu (a rehearsal: both sides on the CPU)"),
              "shape": list(PINES_SHAPE)}
    if "jax" in args.only:
        os.environ["JAX_PLATFORMS"] = "cpu"      # the JAX package on the CPU
    if args.only == "jax_level0":
        print(json.dumps(jax_level0(args.dump)), flush=True)
        return 0
    for part, fn in (("multi", multi_part), ("umap", umap_part),
                     ("jax_multi", jax_multi_part),
                     ("jax_umap", jax_umap_part),
                     ("jax_isa", jax_isa_part)):
        if part in args.only.split(","):
            t = time.perf_counter()
            result[part] = fn()
            result[part]["part_seconds"] = time.perf_counter() - t
            print(json.dumps({part: result[part]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
