#!/usr/bin/env python3
"""The spread of tests/test_torch_pipeline.py's t-SNE KL, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/pipeline_kl_spread.py \
        [--iters 1000] [--every 250] [--nudges 8] [--out FILE]

The test embeds level 1 of its 24x24x200 scene (the JAX package's P) with
the JAX package's dense tier (Pallas in interpret mode) and with the port's
dense tier on the CPU, and compares the KLs.  Here the same P is embedded
several times, and the KL is read every `--every` iterations:

- ``jax``: the JAX package, as the test runs it;
- ``twin``: the port as it runs on the CPU (Z as torch's sum of the rows' z);
- ``kernel_z``: the port with Z summed in csrc/tsne_forces_dense.cu's order
  (``forces_z`` of tests/test_torch_kernels.py), as the card sums it;
- ``nudge_<k>``: the port with every iteration's Z moved by k ulps
  (k = +-1, +-2, ...): the trajectory's own sensitivity to Z's last bit;
- three faults a port could make: ``fault_exaggeration_200`` (the
  exaggeration ends at iteration 200, not 250), ``fault_p_half`` (the
  input P halved: the port normalizes P, so this run is the twin's) and
  ``fault_attraction_half`` (the normalized P halved inside the optimizer,
  as a port that divides by 2N where it should divide by N would).

Writes one JSON object (default docs/torch_port_pipeline_kl_spread.json):
the KLs of each run at each checkpoint, and for each checkpoint the largest
relative distance of a faithful run (twin, kernel_z, the nudges) from the
JAX package's KL and from the twin's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def port_kls(p1, iters: int, every: int, z_of=None, p_scale: float = 1.0,
             exaggeration_end: int = 250, attraction_scale: float = 1.0
             ) -> dict:
    """The port's KL at every `every` iterations on the CPU; `z_of` (rows'
    z -> Z) replaces the twin's Z on every iteration; `attraction_scale`
    scales the optimizer's normalized P after the set-up."""
    import numpy as np
    import sph_tpu_torch as T
    from sph_tpu_torch.models import tsne as ttsne
    from sph_tpu_torch.ops import tsne_kernels
    from test_torch_pipeline import twin_zrow
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    es.tsne.remove_exaggeration_iter = exaggeration_end
    ce = T.ComputeEmbedding(es, device="cpu")
    kls = {}

    def progress(comp):
        it = comp.current_iteration
        if it == 0 and attraction_scale != 1.0:
            comp._p_dense.mul_(attraction_scale)
        if it % every == 0:
            kls[str(it)] = float(comp.kl_divergence())

    twin = tsne_kernels.tsne_forces_dense

    def forces(y, p, n, out=None):
        attr, rep, _ = tsne_kernels.tsne_forces_dense_reference(y, p, n)
        return attr, rep, z_of(twin_zrow(y, n))

    vals = np.asarray(p1.values, np.float32) * np.float32(p_scale)
    p = T.SparseRows(p1.indices, vals, p1.num_cols, device="cpu")
    if z_of is not None:
        ttsne.tsne_forces_dense = forces
    try:
        emb = ce.compute_tsne(p, track_kl=True, progress=progress)
    finally:
        ttsne.tsne_forces_dense = twin
    assert np.all(np.isfinite(emb))
    return kls


def nudged(k: int):
    """Z moved by k ulps (torch's sum of the rows' z first)."""
    import torch

    def z_of(zrow):
        z = zrow.sum()
        step = torch.tensor(float("inf") if k > 0 else 0.0)
        for _ in range(abs(k)):
            z = torch.nextafter(z, step)
        return z
    return z_of


def jax_kls(p1, iters: int, every: int) -> dict:
    """The JAX package's KL every `every` iterations, its dense tier on the
    Pallas kernel in interpret mode (as the test runs it), in chunks of 50
    (as its ComputeEmbedding runs them)."""
    import functools
    import sph_tpu as J
    import sph_tpu.ops.pallas.tsne_kernels as jax_kernels
    os.environ["SPH_TSNE_USE_PALLAS"] = "1"
    jax_kernels.tsne_forces_dense = functools.partial(
        jax_kernels.tsne_forces_dense, interpret=True)
    es = J.ComputeEmbeddingSettings()
    ce = J.ComputeEmbedding(es)
    ce.init_embedding(p1.num_rows)
    tsne = J.TsneComputation(es.tsne)
    tsne.set_probability_distribution(p1)
    tsne.set_initial_embedding(ce._init_embedding)
    kls = {}
    tsne.compute(50, verbose=False)
    done = 50
    while True:
        if done % every == 0:
            kls[str(done)] = float(tsne.kl_divergence())
        if done >= iters:
            return kls
        tsne.continue_gradient_descent(50, verbose=False)
        done += 50


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--every", type=int, default=250)
    ap.add_argument("--nudges", type=int, default=8,
                    help="ulps of Z: runs at +-1 .. +-(nudges / 2)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "torch_port_pipeline_kl_spread.json"))
    args = ap.parse_args()
    import torch
    from test_torch_kernels import forces_z
    from test_torch_pipeline import SIDE, _hierarchy
    import sph_tpu as J
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    from sph_tpu.utils.logging import set_level
    set_level("WARNING")
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    scene = create_hyperspectral_scene(SIDE, SIDE, 200, seed=7)
    p1 = _hierarchy(J, scene, SIDE, SIDE).level_similarities.get_prob_dist(1)
    runs, seconds = {}, {}
    t = time.perf_counter()
    runs["jax"] = jax_kls(p1, args.iters, args.every)
    seconds["jax"] = time.perf_counter() - t
    half = args.nudges // 2
    plan = {"twin": {}, "kernel_z": {"z_of": forces_z},
            **{f"nudge_{k:+d}": {"z_of": nudged(k)}
               for k in [*range(-half, 0), *range(1, half + 1)]},
            "fault_exaggeration_200": {"exaggeration_end": 200},
            "fault_p_half": {"p_scale": 0.5},
            "fault_attraction_half": {"attraction_scale": 0.5}}
    for name, kw in plan.items():
        t = time.perf_counter()
        runs[name] = port_kls(p1, args.iters, args.every, **kw)
        seconds[name] = time.perf_counter() - t
    faithful = [n for n in runs if n not in ("jax",)
                and not n.startswith("fault")]
    spread = {}
    for it, want in runs["jax"].items():
        spread[it] = {
            "from_jax": max(abs(runs[n][it] - want) / want
                            for n in faithful),
            "from_twin": max(abs(runs[n][it] - runs["twin"][it])
                             / runs["twin"][it] for n in faithful),
            "faults_from_jax": {n: abs(runs[n][it] - want) / want
                                for n in runs if n.startswith("fault")}}
    out = {"points": int(p1.num_rows), "iters": args.iters,
           "every": args.every, "kl": runs, "spread": spread,
           "seconds": seconds, "seconds_total": time.perf_counter() - t0}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["spread"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
