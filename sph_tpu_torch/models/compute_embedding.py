"""ComputeEmbedding — the embedding facade (t-SNE path).

Port of sph_tpu/models/compute_embedding.py (reference:
sph/ComputeEmbedding.hpp:37-81 / .cpp — random disk init of radius 0.1 via
polar sampling (:25-50), chunked t-SNE (:85-129), 1-point short-circuit
(:69-74)).  UMAP is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..ops.math import random_disk_init
from ..ops.sparse import SparseRows
from ..utils.logging import Log
from .tsne import TsneComputation, TsneParameters


@dataclass
class ComputeEmbeddingSettings:
    """Reference: ComputeEmbedding.hpp:25-29 (t-SNE part)."""

    tsne: TsneParameters = field(default_factory=TsneParameters)
    init_radius: float = 0.1
    seed: int = 0


class ComputeEmbedding:
    """Reference: sph/ComputeEmbedding.hpp:37."""

    def __init__(self, settings: Optional[ComputeEmbeddingSettings] = None,
                 device=None):
        self.settings = settings or ComputeEmbeddingSettings()
        self.device = resolve_device(device)
        self._init_embedding: Optional[np.ndarray] = None
        self.current_embedding: Optional[np.ndarray] = None
        self.last_kl: Optional[float] = None

    def init_embedding(self, num_points: int,
                       embedding: Optional[np.ndarray] = None):
        """Random disk init r=0.1 (reference: :25-50) or a user-provided
        layout (e.g. previous-level average)."""
        if embedding is not None:
            assert embedding.shape == (num_points, 2)
            self._init_embedding = np.asarray(embedding, np.float32)
        else:
            self._init_embedding = random_disk_init(
                num_points, self.settings.init_radius, self.settings.seed)

    def compute_tsne(self, inp: SparseRows, track_kl: bool = False
                     ) -> np.ndarray:
        """Reference: computeTSNE (:52-129).  `inp` is a symmetrized
        probability SparseRows."""
        if not isinstance(inp, SparseRows):
            raise NotImplementedError(
                "t-SNE from a kNN graph not ported yet; see ROADMAP")
        tsne = TsneComputation(self.settings.tsne, device=self.device)
        tsne.set_probability_distribution(inp)
        n = inp.num_rows
        if n == 1:
            Log.info("ComputeEmbedding: only 1 point, not embedding")
            self.current_embedding = np.zeros((1, 2), np.float32)
            if track_kl:
                self.last_kl = 0.0
            return self.current_embedding
        if self._init_embedding is None or len(self._init_embedding) != n:
            self.init_embedding(n)
        tsne.set_initial_embedding(self._init_embedding)

        # chunks of 50, as the JAX package runs them
        total = self.settings.tsne.num_iterations
        chunk = 50
        tsne.compute(min(chunk, total), verbose=False)
        done = min(chunk, total)
        while done < total:
            step = min(chunk, total - done)
            tsne.continue_gradient_descent(step, verbose=False)
            done += step
        self.current_embedding = tsne.embedding
        if track_kl:
            self.last_kl = tsne.kl_divergence()
            Log.info("t-SNE: final KL divergence %.6f", self.last_kl)
        self._init_embedding = None
        return self.current_embedding

    def compute_umap(self, inp):
        raise NotImplementedError("UMAP not ported yet; see ROADMAP")

    def get_embedding(self) -> np.ndarray:
        return self.current_embedding


def scale_embedding_to_one(emb: np.ndarray) -> np.ndarray:
    """Reference: utils/Embedding.cpp scaleEmbeddingToOne (:88)."""
    mx = np.abs(emb).max()
    return emb / mx if mx > 0 else emb
