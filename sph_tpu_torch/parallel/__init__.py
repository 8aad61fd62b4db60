"""Sharded kNN, t-SNE and UMAP and multi-scene batching over a device list.

Port of sph_tpu/parallel/: the reference has no distributed layer (its
parallelism is OpenMP shared memory); the JAX package scales over a device
mesh, and the port over a list of devices in one process (mesh.py).
"""

from .mesh import make_mesh, replicate, shard_rows
from .sharded import (make_sharded_grid_tsne_step, make_sharded_tsne_step,
                      make_sharded_umap_epoch, multi_scene_tsne,
                      sharded_grid_tsne, sharded_knn, sharded_tsne,
                      sharded_umap)

__all__ = [
    "make_mesh", "replicate", "shard_rows",
    "make_sharded_grid_tsne_step", "make_sharded_tsne_step",
    "make_sharded_umap_epoch", "multi_scene_tsne", "sharded_grid_tsne",
    "sharded_knn", "sharded_tsne", "sharded_umap",
]
