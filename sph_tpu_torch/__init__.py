"""sph_tpu_torch: the PyTorch/CUDA port of sph_tpu.

Superpixel hierarchies and t-SNE embeddings for high-dimensional images, for
one NVIDIA H100, behind sph_tpu's public surface:

    ImageStack -> ComputeHierarchy{NearestNeighbors -> ImageHierarchy ->
    LevelSimilarities} -> ComputeEmbedding{t-SNE | UMAP}

The JAX package ``sph_tpu`` stays beside it as the reference each ported
function is tested against.  This package imports torch and never jax.  Entry
points take an explicit ``device`` (default CUDA; see device.py).  What the
JAX package has and this one does not (XLA and TPU workarounds) is listed
in ROADMAP.md.
"""

from . import device as _device  # noqa: F401  (sets the float32 precision)
from .data import ImageStack, scale
from .settings import (CacheSettings, ComponentSim, EmbeddingInit,
                       ImageHierarchySettings, ImportanceWeighting, KnnIndex,
                       KnnMetric, LevelSimilaritiesSettings,
                       NearestNeighborsSettings, NeighConnection,
                       NormalizationScheme, NormType, RandomWalkHandling,
                       RandomWalkReduction, RandomWalkSettings, Scaler)
from .models.compute_embedding import (ComputeEmbedding,
                                       ComputeEmbeddingSettings,
                                       average_position_of_children,
                                       broadcast_parent_positions,
                                       scale_embedding_to_one)
from .models.compute_hierarchy import ComputeHierarchy
from .models.hierarchy import Hierarchy
from .models.image_hierarchy import ImageHierarchy
from .models.level_similarities import LevelSimilarities
from .models.nearest_neighbors import NearestNeighbors
from .models.tsne import TsneComputation, TsneParameters
from .models.umap import UmapComputation, UmapParameters
from .ops.graph import KnnGraph, PaddedGraph
from .ops.sparse import SparseRows

__version__ = "0.1.0"

__all__ = [
    "ImageStack", "scale",
    "ComputeHierarchy", "ComputeEmbedding", "ComputeEmbeddingSettings",
    "NearestNeighbors", "ImageHierarchy", "LevelSimilarities", "Hierarchy",
    "TsneComputation", "TsneParameters", "UmapComputation", "UmapParameters",
    "KnnGraph", "PaddedGraph", "SparseRows",
    "CacheSettings", "ComponentSim", "EmbeddingInit",
    "ImageHierarchySettings", "ImportanceWeighting", "KnnIndex", "KnnMetric",
    "LevelSimilaritiesSettings", "NearestNeighborsSettings",
    "NeighConnection", "NormalizationScheme", "NormType",
    "RandomWalkHandling", "RandomWalkReduction", "RandomWalkSettings",
    "Scaler", "scale_embedding_to_one", "average_position_of_children",
    "broadcast_parent_positions",
]
