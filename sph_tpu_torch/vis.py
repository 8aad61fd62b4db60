"""Visualization — the headless counterpart of the reference's interactive
OpenGL explorer.  Port of sph_tpu/vis.py: the plots are the same numpy and
matplotlib code; ``demo`` runs the port's kNN, walks and geodesic fields on
``device`` (the card by default).

Reference: vis/ (SPHVisualization) — GLFW/ImGui point-cloud explorer over
synthetic data with live kNN, shortest-path overlays and random-walk
colormaps (Renderer.cpp:467-551).  A compute node has no display, so this
module renders the same views headlessly to PNG with matplotlib (Agg):
embeddings colored by hierarchy level / labels, per-level superpixel maps,
kNN edges, shortest-path overlays, and random-walk mass over a point cloud.
The `demo()` entry mirrors the reference vis app's synthetic-manifold flow.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_embedding(emb: np.ndarray, labels: Optional[np.ndarray] = None,
                   path: str = "embedding.png", title: str = "",
                   point_size: float = 4.0):
    """Scatter an embedding colored by labels (viridis, like the reference
    vis colormap)."""
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    c = labels if labels is not None else "k"
    ax.scatter(emb[:, 0], emb[:, 1], c=c, s=point_size, cmap="viridis",
               linewidths=0)
    ax.set_title(title)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_level_map(pixel_components: np.ndarray, rows: int, cols: int,
                   path: str = "level.png", title: str = "",
                   seed: int = 0):
    """Superpixel label image with randomized colors (reference:
    saveLevelImages label dumps rendered for humans)."""
    rng = np.random.default_rng(seed)
    n = int(pixel_components.max()) + 1
    perm = rng.permutation(n)
    img = perm[pixel_components].reshape(rows, cols)
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    ax.imshow(img, cmap="tab20" if n <= 20 else "viridis",
              interpolation="nearest")
    ax.set_title(title)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_hierarchy_levels(hierarchy, rows: int, cols: int, out_dir: str,
                          prefix: str = "level"):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for level in range(hierarchy.num_levels):
        p = os.path.join(out_dir, f"{prefix}_{level}.png")
        plot_level_map(hierarchy.pixel_components[level], rows, cols, p,
                       title=f"level {level} "
                             f"({hierarchy.num_components[level]} comps)",
                       seed=level)
        paths.append(p)
    return paths


def plot_knn_edges(points: np.ndarray, indices: np.ndarray,
                   path: str = "knn.png", max_edges: int = 5000,
                   colors: Optional[np.ndarray] = None):
    """Point cloud with kNN edges (reference vis: live kNN view).  3D points
    are projected to their first two coordinates."""
    p2 = points[:, :2]
    n, k = indices.shape
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    segs = []
    cnt = 0
    for i in range(n):
        for j in indices[i, 1:]:
            if j < 0:
                continue
            segs.append([p2[i], p2[j]])
            cnt += 1
            if cnt >= max_edges:
                break
        if cnt >= max_edges:
            break
    from matplotlib.collections import LineCollection
    ax.add_collection(LineCollection(segs, colors="0.7", linewidths=0.3))
    ax.scatter(p2[:, 0], p2[:, 1], c=colors if colors is not None else "k",
               s=4, cmap="viridis" if colors is not None else None,
               zorder=2, linewidths=0)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_shortest_path(points: np.ndarray, field: np.ndarray,
                       start: int, end: int, path_nodes: np.ndarray,
                       path: str = "geodesic.png"):
    """Distance-field coloring + highlighted path (reference vis:
    shortest-path overlay)."""
    p2 = points[:, :2]
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    finite = np.isfinite(field)
    ax.scatter(p2[finite, 0], p2[finite, 1], c=field[finite], s=4,
               cmap="viridis", linewidths=0)
    if len(path_nodes):
        ax.plot(p2[path_nodes, 0], p2[path_nodes, 1], "r-", lw=1.5)
    ax.scatter(p2[[start, end], 0], p2[[start, end], 1], c="red", s=30,
               zorder=3)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_walk_mass(points: np.ndarray, walks, source: int,
                   path: str = "walks.png"):
    """Random-walk visitation mass from one source (reference vis:
    random-walk colormap view)."""
    p2 = points[:, :2]
    mass = np.zeros(len(points))
    row_idx = walks.indices[source]
    row_val = walks.values[source]
    ok = row_idx >= 0
    mass[row_idx[ok]] = row_val[ok]
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    ax.scatter(p2[:, 0], p2[:, 1], c=mass, s=5, cmap="viridis",
               linewidths=0)
    ax.scatter(p2[source, 0], p2[source, 1], c="red", s=40, zorder=3)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def demo(out_dir: str = "vis_out", n_samples: int = 1500,
         dataset: str = "swiss_roll", k: int = 10, seed: int = 1234,
         device=None):
    """Synthetic-manifold demo mirroring the reference vis app (vis/Vis.cpp:
    swiss roll / S-curve / gaussians with kNN + walks + geodesics)."""
    from .ops.distributions import normalize_knn_distances
    from .ops.graph import KnnGraph
    from .ops.knn import knn_bruteforce
    from .ops.shortest_path import shortest_path_fields
    from .ops.sparse import SparseRows
    from .ops.walks import do_random_walks
    from .settings import NormalizationScheme, RandomWalkSettings
    from .utils.testdata import (create_3d_gaussians, create_s_curve,
                                 create_swiss_roll)

    os.makedirs(out_dir, exist_ok=True)
    if dataset == "swiss_roll":
        pos, t = create_swiss_roll(n_samples, random_state=seed)
    elif dataset == "s_curve":
        pos, t = create_s_curve(n_samples, random_state=seed)
    else:
        pos, t = create_3d_gaussians(
            n_samples, random_state=seed,
            centers=np.array([[0, 0, 0], [6, 6, 0], [0, 6, 6]]))

    idx, dist = knn_bruteforce(pos, k, device=device)
    plot_knn_edges(pos, idx, os.path.join(out_dir, "knn.png"), colors=t)

    probs = normalize_knn_distances(dist, NormalizationScheme.TSNE,
                                    device=device)
    rows = SparseRows(idx.astype(np.int32), probs.astype(np.float32),
                      len(pos), device=device)
    walks = do_random_walks(rows, RandomWalkSettings(
        num_random_walks=50, single_walk_length=10, random_seed=seed))
    plot_walk_mass(pos, walks, source=0,
                   path=os.path.join(out_dir, "walks.png"))

    field = shortest_path_fields(KnnGraph(idx, dist), np.array([0]),
                                 device=device)[0]
    plot_shortest_path(pos, field, 0, int(np.nanargmax(
        np.where(np.isfinite(field), field, -1))), np.array([]),
        os.path.join(out_dir, "geodesic.png"))
    return out_dir
