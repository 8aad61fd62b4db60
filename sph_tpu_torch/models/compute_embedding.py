"""ComputeEmbedding — the embedding facade (t-SNE and UMAP).

Port of sph_tpu/models/compute_embedding.py (reference:
sph/ComputeEmbedding.hpp:37-81 / .cpp — random disk init of radius 0.1 via
polar sampling (:25-50), chunked t-SNE (:85-129), UMAP (:131-174), 1-point
short-circuit (:69-74)).

``compute_tsne`` keeps the wall seconds of its parts in ``seconds``: the
set-up (P from a kNN graph, padding, the initial state), the iterations and
the final KL, each ending with the device synchronised.  Its
``TsneComputation`` stays in ``last_computation`` (tier, padded state).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.math import random_disk_init
from ..ops.sparse import SparseRows
from ..utils.logging import Log
from .tsne import TsneComputation, TsneParameters
from .umap import UmapComputation, UmapParameters


@dataclass
class ComputeEmbeddingSettings:
    """Reference: ComputeEmbedding.hpp:25-29."""

    tsne: TsneParameters = field(default_factory=TsneParameters)
    umap: UmapParameters = field(default_factory=UmapParameters)
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
        self.seconds: dict[str, float] = {}
        self.last_computation: Optional[Union[TsneComputation,
                                              UmapComputation]] = None

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

    def _lap(self, name: str, t0: float) -> float:
        """Charge the time since t0 to `name` once the device is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.seconds[name] = t - t0
        return t

    def compute_tsne(self, inp: Union[SparseRows, tuple],
                     track_kl: bool = False,
                     progress: Optional[Callable[[TsneComputation], None]]
                     = None) -> np.ndarray:
        """Reference: computeTSNE (:52-129).  `inp` is a symmetrized
        probability SparseRows or an (indices, distances) kNN graph tuple.
        `progress`, when given, is called with the computation after the
        set-up and after each chunk of iterations (the reference reports
        progress per chunk); its time counts to the iterations."""
        tsne = TsneComputation(self.settings.tsne, device=self.device)
        if isinstance(inp, SparseRows):
            tsne.set_probability_distribution(inp)
            n = inp.num_rows
        else:
            tsne.set_neighbor_graph(*inp)
            n = inp[0].shape[0]
        self.seconds = {}
        self.last_computation = tsne
        if n == 1:
            Log.info("ComputeEmbedding: only 1 point, not embedding")
            self.current_embedding = np.zeros((1, 2), np.float32)
            if track_kl:
                self.last_kl = 0.0
            return self.current_embedding
        if self._init_embedding is None or len(self._init_embedding) != n:
            self.init_embedding(n)
        tsne.set_initial_embedding(self._init_embedding)

        t = time.perf_counter()
        tsne.compute(0, verbose=False)        # P and the initial state
        t = self._lap("set_up", t)
        # chunks of 50, as the JAX package runs them
        total = self.settings.tsne.num_iterations
        chunk = 50
        done = 0
        if progress is not None:
            progress(tsne)
        while done < total:
            step = min(chunk, total - done)
            tsne.continue_gradient_descent(step, verbose=False)
            done += step
            if progress is not None:
                progress(tsne)
        self.current_embedding = tsne.embedding
        t = self._lap("iterations", t)
        if track_kl:
            self.last_kl = tsne.kl_divergence()
            self._lap("kl", t)
            Log.info("t-SNE: final KL divergence %.6f", self.last_kl)
        self._init_embedding = None
        return self.current_embedding

    def compute_umap(self, inp: Union[SparseRows, tuple]) -> np.ndarray:
        """Reference: computeUMAP (:131-174).  `inp` is a similarity
        SparseRows (combined with the fuzzy union) or an (indices,
        distances) kNN graph tuple.  Keeps the wall seconds of the set-up
        and of the epochs in ``seconds`` and the computation in
        ``last_computation``."""
        umap = UmapComputation(self.settings.umap, device=self.device)
        if isinstance(inp, SparseRows):
            umap.set_neighbor_matrix(inp)
            n = inp.num_rows
        else:
            umap.set_neighbor_graph(*inp)
            n = inp[0].shape[0]
        self.seconds = {}
        self.last_computation = umap
        if n == 1:
            Log.info("ComputeEmbedding: only 1 point, not embedding")
            self.current_embedding = np.zeros((1, 2), np.float32)
            return self.current_embedding
        if self._init_embedding is not None and len(
                self._init_embedding) == n:
            umap.set_initial_embedding(self._init_embedding)
        t = time.perf_counter()
        umap.init_optimization()       # memberships, layout, schedule
        t = self._lap("set_up", t)
        umap.run_for_epochs(umap.n_epochs)
        self._lap("epochs", t)
        self.current_embedding = umap.embedding
        self._init_embedding = None
        return self.current_embedding

    def get_embedding(self) -> np.ndarray:
        return self.current_embedding


def scale_embedding_to_one(emb: np.ndarray) -> np.ndarray:
    """Reference: utils/Embedding.cpp scaleEmbeddingToOne (:88)."""
    mx = np.abs(emb).max()
    return emb / mx if mx > 0 else emb


def average_position_of_children(emb_fine: np.ndarray,
                                 parents: np.ndarray,
                                 num_parents: Optional[int] = None
                                 ) -> np.ndarray:
    """Fine-to-coarse init: each coarse component starts at the mean of its
    children's embedded positions (reference:
    averageEmbeddingPositionOfChildren, utils/Embedding.cpp:131; the
    run_evaluation.py seeds level L from level L-1's embedding).  Sums in
    float64, as the JAX package's numpy does: [num_parents, 2] float32."""
    parents = np.asarray(parents)
    if num_parents is None:
        num_parents = int(parents.max()) + 1
    sums = np.zeros((num_parents, emb_fine.shape[1]), dtype=np.float64)
    np.add.at(sums, parents, emb_fine)
    counts = np.bincount(parents, minlength=num_parents)[:, None]
    return (sums / np.maximum(counts, 1)).astype(np.float32)


def broadcast_parent_positions(emb_coarse: np.ndarray,
                               parents: np.ndarray) -> np.ndarray:
    """Coarse-to-fine init: each fine component starts at its parent's
    position (the inverse warm start, for embedding coarse levels first)."""
    return emb_coarse[parents]
