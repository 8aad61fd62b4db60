#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sph_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line, and each raising on failure:

1. device  — CUDA and exactly one visible card; its name and the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build   — compile every CUDA kernel from csrc/ (one nvcc each, started
   together), and the host graph ops from the port's own
   sph_tpu_torch/native/graphops.cpp and the walk sort's twin
   native/xla_sort.cpp.
3. kernel_vs_twin — each kernel against its plain PyTorch twin on the card
   at the paths' shapes, with the time per call of both (CUDA events):
   tsne_forces_dense's reciprocal against IEEE 1 / x on every float32 in
   [1, 2^126), the kernel at FORCES_SHAPES (Npad 512 to 28672; Z from the
   kernel, two calls bit-equal, pad rows 0), tsne_repulsion at
   (n, Npad) = (1000, 1024), (5358, 6144) (the Pines KL's), (21025, 21504)
   (a Pines-sized scene, one of multi_scene's 16) and
   (65536, 65536) in full and at (1000000, 1000448) on 4096 sampled rows,
   two calls bit-equal, its launch plan and its SFU floor; walk_row_sort
   against its twin (std::sort, native/xla_sort.cpp), every row's order
   and sorted keys equal, on synthetic rows of each of its paths (500,
   2048 and 2049, 4096, 16384 and 16385 keys: a warp a row up to 2048, a
   block a row staged whole up to 16384, partitioned in the order buffer
   above; all equal, sorted, reverse-sorted, McIlroy's median-of-3
   adversary, which reaches the heap path), on 64 explorer-wide rows of
   50000 keys and on the explorer's widest answer at the Pines level 1
   (5358 rows of 50000 keys, 256 sampled rows held), with the twin's ms,
   the 16-byte-an-entry bound and torch.sort(stable=True)'s ms (another
   order).  tsne_attraction is held
   at the P its paths give it (phases 12 and 15), bellman_ford_relax at
   rgb_geo's graphs (phase 9), walk_row_sort at eval_pines_walks'
   level-0 visit record (phase 20), and merge_runs (the merges' run sums,
   ops/device_merge.py) at the merges the paths give it: Pines' level-0 ->
   1 walk-row merge, again with a cap that bites and is not a power of two
   (phase 4), salinas_walks' widest merge (phase 8) and eval_pines_walks'
   first MERGE_DATA_NEW_WALKS min merge (phase 20); at each the kernel
   against its twin over every parent range (bit-equal), both timed
   beside the bytes bound and index_add_'s ms, and the whole device merge
   (and its normalization) against the host path (download, C++ merge,
   numpy, upload), bit-equal, both timed, with the device merge's peak
   memory (whole, and in one parent range).  symmetrize_graph's device path
   is held against native.symmetrize on the Pines and Salinas kNN graphs,
   both timed.  grid_deposit and grid_interpolate are held at the 1M run's
   layouts (phase 12) and grid_vs_exact's (phase 15).
4. main    — the Pines configuration of bench.py:89-136 at 145x145x200
   through ComputeHierarchy(device="cuda") and 2000 level-1 t-SNE
   iterations through ComputeEmbedding(device="cuda"), counting kernel
   launches (walk_row_sort's on its NORMAL walks, merge_runs' on its walk
   merges, at least one each); then tsne_forces_dense against its twin
   once more at the level-1 size the path produced.  merge_runs is also
   counted, at least once, on salinas_walks, eval_pines_walks and
   multi_scene, whose lines list their merges (how many, the most live
   entries, the largest summed weight of a parent against 2^24).
5. checks  — monotone levels, a symmetric level-1 P whose conditional rows
   each sum to 1, a finite embedding,
   the kernel on the main path, the KL gate of bench.py:344-360 against
   docs/anchors_pines.json, and the levels against the JAX-on-CPU record in
   docs/torch_port_pines_reference.json.
6. umap    — the same level 1 through ComputeEmbedding.compute_umap for
   the reference's 500 epochs (rows tier), on the default u16-packed
   gathers and again with float32 ones (SPH_UMAP_PACKED=0): seconds,
   epochs/s, an epoch's milliseconds packed and float32 in turns, and the
   trustworthiness at k = 10 against the components' mean spectra, at
   least 0.99 x the JAX-on-CPU record of the same gathers
   (docs/torch_port_packed_reference.json, whose run is the JAX package's
   defaults, and docs/torch_port_pines_umap_reference.json's, whose
   headline run is too; its float32 run for the float32 one).
   Then explorer: sph_tpu_torch.vis_server.ExplorerServer on the card over
   the same hierarchy with level 1's embedding, served on 127.0.0.1 at a
   free port: the page and /api/meta; /api/knn at level 0 (k = 16) and
   level 1 (k = 16, 91), first and cached, each equal to a direct
   knn_walks call, level 1's k = 91 rows against float64 Bhattacharyya on
   64 rows; /api/walks at level 1 (50 x 10, seed 1) equal to the port's
   do_random_walks on the CPU; /api/path at level 1 against scipy's
   Dijkstra over the answered edges; a level above the cap answers 400;
   each latency.
7. scene_overlap — the same recipe at 256x256x200 on default level
   settings (NEIGH_OVERLAP, exact_knn False) with knn_index =
   index_heuristic(65536), IVF_FLAT: the levels against the JAX-on-CPU
   record in docs/torch_port_scene_overlap_reference.json (level 1 within
   2 %, later levels of at least 100 components within 10 %), level 1 above
   SPH_APPROX_KNN_THRESHOLD on the approximate component kNN, its recall
   against the exact knn_neighbor_overlap (at least the record's - 0.01),
   stage 1's recall against the exact kNN, P's checks, and 2000 dense-tier
   t-SNE iterations of level 1 with a falling KL; seconds by stage; the
   exact knn_neighbor_overlap's own peak memory (at most 2 GiB); then
   tsne_forces_dense against its twin at level 1's shape.
8. salinas_euclid — EUCLID_CENTROID in both stages on the Salinas-shaped
   scene (512x217x224, bench_salinas.py:41-75; run_evaluation.py's
   ImageHierarchySettings with 100 samples): the levels against the
   JAX-on-CPU record in docs/torch_port_salinas_euclid_reference.json,
   level 1 on the approximate Hausdorff kNN and its recall against the
   exact Hausdorff (at least the record's - 0.01), level 2's exact kNN
   against float64 on 64 rows, P's checks, 2000 dense-tier t-SNE
   iterations of levels 1, 2 and 3 (each after the first from the level
   below's layout) with falling KLs, UMAP of level 1 for 500 epochs;
   seconds and peak memory by stage and part; tsne_forces_dense against
   its twin at level 1's shape.  Then salinas_walks: bench_salinas.py:
   41-75's NEIGH_WALKS recipe on the same scene (exact kNN k = 31, 50 x
   10 NORMAL walks), stage 1 once and shared through a kNN cache by two
   hierarchies: MERGE_RW_ONLY, its levels against the JAX-on-CPU record
   in docs/torch_port_salinas_walks_reference.json and 2000 dense-tier
   t-SNE iterations of level 1 (Npad 28672) under the KL gate of
   bench_salinas.py:116-129 against docs/anchors_salinas.json; and
   MERGE_RW_NEW_WALKS_AND_KNN, its levels against the record, level 1 on
   the approximate walk kNN with recall on 256 rows against the exact
   knn_walks at least the record's - 0.01, level 2 on the exact one
   against float64 on 64 rows, P's checks and a falling KL; both kernels
   against their twins at level 1's shape.
9. rgb_geo — GEO_CENTROID in both stages on a 240x240 RGB scene
   (create_hyperspectral_scene(240, 240, 3, seed=13), 57600 pixels;
   configs/rgb_bus_geo.json through run_evaluation.py's wiring, 100
   samples): stages 1-3 (level 1 takes the geodesic sketch in stage 2 and
   the contracted component graph in stage 3), 2000 dense-tier t-SNE
   iterations of levels 1, 2 and 3 from random layouts (tsne_forces_dense
   launched 3 x 2000 times) with falling KLs and P's checks; the port's
   fields from 64 pixels against scipy's float64 Dijkstra within hops x
   2^-23 relative; the level-1 sketch path's values against the exact
   fields on 200 pairs (Spearman >= 0.99, argmin agreement >= 0.95), and
   the sketch alone on every level-1 neighbour pair where it meets (at
   least 100 pairs, none below exact x (1 - 16 x 2^-23), the same two
   rank gates); levels strictly falling over at least 4; seconds, peak
   memory and the geodesic log (field batches, sweeps, unresolved level-0
   pairs, the sketch build) by stage; bellman_ford_relax launched once a
   sweep of each stage's field batches (and in stages 2 and 3); both t-SNE
   kernels against their twins at the shapes of levels 1-3.  Then
   bellman_ford_relax against its twin, d' and the frontier equal: at the
   level-0 field graph (57600 nodes) with 256 and 37 fields and at stage
   3's contracted level-1 graph with 256, each from 256 (37) sources
   relaxed 10 sweeps by the twin, ms a call against the bytes bound; and
   two whole field batches as the paths run them, the first level-0
   pair-value batch (256 fields) and stage 3's first contracted-graph
   batch: each through converge on the kernel and on the twins (equal
   values, equal sweeps, a launch a sweep) and sweep by sweep four ways
   (the kernel's delta sweeps and full sweeps, both twins: fields,
   frontier, stop word and sector words equal), the delta sweeps' summed
   ms against the full-sweep loop's and the delta bound, and each sweep's
   gathered and written sector shares.  Then rgb_geo_record:
   GEO_CENTROID and GEO_WALKS at 96x80x3 with CONTRACT_THRESHOLD 512
   against the JAX-on-CPU
   record in docs/torch_port_rgb_geo_reference.json (levels; where the
   level count agrees, the kNN ids of 64 rows of levels 1-2 and the sketch
   Hausdorff of the record's 200 sampled pixel sets within 1e-5).
10. large_graph — BASELINE config 4 (benchmarks/bench_1m.py): a
   1000x1000x100 synthetic stack and its exact kNN graph (k = 16, once for
   both tiers below); kNN invariants and exactness against float64
   distances on 1024 sampled rows.
11. large_ivf — the same stack through compute_knn on its size tier
   (HNSW, flat IVF) twice: seconds and peak memory beside the exact kNN's,
   recall@16 over all rows against the exact graph, a complete graph, the
   two results bit-equal.
12. large_grid — t-SNE from that graph at perplexity 5 on the default tier,
   the grid, for the reference's 4000 iterations: seconds, iterations/s,
   the grid sizes, the KL at iterations 0, 250, 1000 and 4000, the grid's
   Z against tsne_repulsion's (at most 1e-3 apart) and the final KL with
   the exact Z, milliseconds an iteration by part (the box, grid_deposit
   with its keys and sort, the FFT, grid_interpolate, the attraction, the
   update), the points in the fullest base cell on each grid size, two
   calls of the grid's repulsion bit-equal (the deposit sums in a fixed
   order), peak memory; the iterations launch tsne_attraction (on the
   u16-packed table, the default), grid_deposit and grid_interpolate once
   each an iteration and no other kernel, each KL grid_deposit and
   grid_interpolate once (counted apart).  Then tsne_attraction against
   its twin at this P (1,000,448 x 64) and layout, unpacked and packed:
   within 1e-5 x max|twin|, two calls bit-equal, two row windows equal to
   the full call's rows; ms against the bound; and grid_deposit and
   grid_interpolate against their twins at the final layout on its grid
   and at iteration 1000's layout on the 128 grid (crowded cells): each
   bit-equal to its twin and from call to call, ms, the twin's ms, the
   bound and the share of it.
13. large  — the same graph on the exact sparse-P tier (SPH_TSNE_GRID=0),
   cut to 10 iterations; the KL before and after, the launches
   (tsne_attraction, float32, and tsne_repulsion on every iteration).
14. large_checks — a symmetric P whose conditional rows sum to 1, the
   exact tier (tsne_repulsion on every iteration, tsne_forces_dense never),
   a falling KL, a finite embedding with zero pad rows, and tsne_repulsion
   against its twin at the embedding the path produced.
15. grid_vs_exact — the 1M recipe at 256x256 (65536 points), 1000
   iterations on the grid and the exact tier from the same P and initial
   layout, both scored under that P with the exact Z: KL_grid <= 1.001 x
   KL_exact (the grid tier on its defaults, so its attraction reads the
   packed table); tsne_attraction once an iteration of each, grid_deposit
   and grid_interpolate once an iteration of the grid tier (and for its
   final KL); then tsne_attraction against its twin at this P, as in phase
   12, and both grid kernels at the grid tier's final layout.
16. ivf_recall — benchmarks/bench_recall.py's clustered data at 10^6 x
   100 (seed 0), a full self-kNN on HNSW, HNSWSQ and HNSW_IVFPQ, recall@16
   on 1024 sampled rows against float64 distances, each at least the JAX
   package's record less 0.01; seconds, peak memory and the IVF layout.

17. eval_pines_tsne — the evaluation CLI's entry point, as a user runs it
   (sph_tpu_torch.evaluation.run_evaluation on the card), on
   configs/pines_embed.json uncut: make_data.py's 145x145x200 pines_synth
   written by the port's io into a temporary directory, NEIGH_WALKS, k =
   91, 50 x 10 walks, PCA init of level 0, t-SNE of every level from the
   level below's layout.  Gates: both maps byte-equal to the JAX-CPU
   record of the same grid run (docs/torch_port_eval_pines_reference.json)
   or, if the card's sums moved a merge, the levels by the Pines rule
   (level 1 within 2 %, the count within one); every output file read back
   by the port's readers; each level of at least 100 components with a
   finite KL (through tsne_repulsion) below its starting layout's;
   tsne_forces_dense launched once an iteration of the schedule, summed
   over the levels.  Then the same grid again under the same base: its kNN
   stage loads from the shared cache, and its levels and
   MapFromBottomToLevel.bin equal the first run's.  Seconds by stage and by
   level embedding.
18. eval_pines_umap — the same grid with dataDistNorm UMAP and UMAP of
   every level (500 epochs at level 0, 175 from the level below after
   that): the maps against the record's second entry as above, the levels
   without UMAP memberships exactly the record's (where the JAX package's
   UMAP raises; the port keeps their starting layout), level 0's
   memberships exactly the record's count (the fuzzy union of a
   device-resident P takes the JAX package's device path, its reverse
   cap included), every membership in (0, 1], finite layouts, level 1's
   trustworthiness at k = 10.
19. eval_record — both grids through run_evaluation at 64x64x200, where
   JAX-CPU runs the whole grid: the maps as above, each level of at least
   100 components with its t-SNE KL within 1 % of the record's, the UMAP
   levels without memberships the record's, level 1's UMAP
   trustworthiness at least 0.99 x the record's (the UMAP grid with
   float32 gathers, SPH_UMAP_PACKED=0, as the record was made).  Then
   both kernels against their twins at every shape the t-SNE levels of
   eval_pines_tsne and eval_record gave them (n >= 2, Npad of the dense
   tier).
20. eval_pines_walks — the evaluation driver on configs/pines_walk_variants
   .json (NEIGH_WALKS and NEIGH_WALKS_SINGLE_OVERLAP, each with
   MERGE_RW_NEW_WALKS, MERGE_RW_NEW_WALKS_AND_KNN and MERGE_DATA_NEW_WALKS)
   and configs/pines_walk_topk.json (MERGE_RW_ONLY with top-k walk rows)
   at 145x145x200: each run's maps byte-equal to the JAX-CPU record in
   docs/torch_port_pines_walks_reference.json (a run named in
   WALK_MAPS_EXCEPTIONS, with its traced cause, by the Pines rule), its
   walk length on each level against the record's, every output read
   back, the KL of each level of at least 100 components below its
   start, tsne_forces_dense once an iteration of each grid's schedule,
   walk_row_sort launched; its level-0 visit record (21025 rows of 500
   visits) through walk_row_sort against the twin; then both t-SNE
   kernels against their twins at the new shapes its levels gave them.
21. multi_scene — BASELINE config 5 (benchmarks/bench_multiscene.py) at
   full width: 16 scenes create_hyperspectral_scene(145, 145, 200, seed=7
   + i) (scene 0 the Pines image) with bench.py:97-122's flagship settings
   through sph_tpu_torch.parallel.sharded.multi_scene_hierarchy on
   [cuda] (batched stage 1, then each scene's levels), then every scene's
   level-0 P through multi_scene_tsne for 1000 iterations (one
   tsne_repulsion launch an iteration for all 16; the attraction over P's
   live entries in torch ops); bench_multiscene.py's
   A/B (batched against a serial loop of the one-scene stage 1) on 4
   scenes.  Gates: each scene's stage 1 against the JAX-CPU record
   (docs/torch_port_multiscene_reference.json, scripts/multiscene_
   reference.py): equal kNN id hashes, else both row sets the float64
   top-k up to
   the float32 band (the walk rows' agreement printed: on the card the
   distances' last bits move the walk draws); 64 kNN rows of scenes 0 and
   15 against float64;
   the recorded scenes' levels by the Pines rule; scenes 0 and 15
   bit-equal to one-scene calls with seed + i; every KL finite and below
   its start.  Then tsne_repulsion batched (16 scenes at 21025 / 21504)
   against the one-scene calls and its twin.
22. multi_scene_record — bench_multiscene.py's defaults (4 scenes of
   48x48x32, k = 16, 20 x 6 walks): levels by the Pines rule and each
   scene's KL after 1000 iterations within 1 % of the record's (250
   iterations printed beside the record's).
23. sharded — the sharded entry points on [cuda] and [cuda, cuda] (two
   logical shards): sharded_knn on the Pines scene (ids equal),
   sharded_tsne and sharded_grid_tsne for 100 iterations on
   grid_vs_exact's 65536-point P (KL of 2 shards within 0.5 % of 1
   shard's, each with the exact Z; tsne_attraction once a shard and an
   iteration, on the shard's rows; on the grid tier grid_deposit and
   grid_interpolate too), sharded_umap for 200 epochs on Pines
   level 1's memberships beside the one-card edge-list tier (two runs
   bit-equal) (the Pines path's level 1, phase 4, whose memberships are
   connected): trustworthiness at k = 10 at least 0.99 x the edge tier's;
   then the edge tier against native.umap_sequential on 8 seeds
   (SHARDED_SEEDS) for 100 epochs at the rehearsal's scene (32x32x8, the
   Pines recipe at k = 31), each seed's trustworthiness ratio printed:
   their mean at least 0.99, each at least the lowest of 32 seeds measured
   on the CPU less 0.01.  Then tsne_repulsion over both row windows of a
   2-shard split at 65536, each bit-equal to the full call's rows.
   The script raises if it ran longer than 1000 s.

Then the kernels line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero before that line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

_STARTED = time.perf_counter()

REPO = os.path.dirname(os.path.abspath(__file__))
KL_SLACK = 1.01            # bench.py:344-360: KL <= 1.01 x sklearn anchor
LEVEL1_TOLERANCE = 0.02    # level-1 count within 2 % of the JAX record
# scene_overlap's levels past 1 with at least DEEP_LEVEL_MIN components in
# the record: within 10 % of it (the card's k-means sums part from XLA-CPU's
# by ulps, which moves the stage-1 IVF graph and so the later merges; with
# the JAX clustering replayed the levels are equal, PERF.md)
DEEP_LEVEL_TOLERANCE = 0.10
DEEP_LEVEL_MIN = 100
LARGE_ITERS = 10           # 1M exact tier: a depth cut (0.6 s an iteration)
GRID_ITERS = 4000          # 1M grid tier: the reference's schedule above 200k
GRID_KL_AT = (0, 250, 1000)
MID_ITERS = 1000           # 65536 points: the reference's schedule below 100k
GRID_STEP_MS_INDEX_ADD = (7.37, 7.43)   # 1M grid step, index_add_ deposit
GRID_LAYOUT_AT = 1000      # the 1M run's layout kept here (on the 128 grid)
GRID_KERNEL_CALLS = 20     # grid_deposit / grid_interpolate calls timed
GRID_TWIN_CALLS = 3        # their twins'
Z_GAP_MAX = 1e-3           # grid Z against the exact Z at 1M, relative
KL_RATIO_MAX = 1.001       # 65536 points: KL_grid / KL_exact
# tsne_repulsion against its twin: (n, Npad, calls timed, twin calls timed,
# sampled rows); the Pines KL's shape, a Pines-sized scene's (multi_scene's
# one-scene shape), grid_vs_exact's, the 1M path's
REPULSION_SHAPES = ((1000, 1024, 200, 100, False),
                    (5358, 6144, 200, 20, False),
                    (21025, 21504, 200, 20, False),
                    (65536, 65536, 100, 2, False),
                    (1_000_000, 1_000_448, 5, 0, True))
UMAP_TRUST_SLACK = 0.99    # Pines UMAP trustworthiness vs the JAX-CPU record
IVF_N = 1_000_000          # ivf_recall: bench_recall.py's clustered data
# recall@16 gates of the approximate tiers on that data: the JAX package's
# records (BASELINE.md:129-136, 263-267, on a TPU) less 0.01
IVF_RECALL_GATES = {"hnsw": 0.9899, "hnswsq": 0.9238, "hnsw_ivfpq": 0.9679}
SCENE_SIDE = 256           # scene_overlap: 65536 points, level 1 above 8192
RECALL_SLACK = 0.01        # component kNN recall vs the JAX-CPU record
SALINAS_SHAPE = (512, 217, 224)    # bench_salinas.py:42, 111104 pixels
SALINAS_K = 31                     # bench_salinas.py:44
SALINAS_TSNE_LEVELS = (1, 2, 3)    # each from the level below's layout
SALINAS_SAMPLED_ROWS = 1024        # level-1 component kNN recall rows
SALINAS_EXACT_ROWS = 64            # level-2 exact kNN rows vs float64
EXACT_OVERLAP_PEAK_MAX = 2 << 30   # exact NEIGH_OVERLAP kNN's own peak bytes
RGB_GEO_SIDE = 240                 # rgb_geo: docs/geo_rgb_scale.json's scene
RGB_GEO_K = 51                     # configs/rgb_bus_geo.json: nKnns 50 + self
RGB_GEO_RECORD_SHAPE = (96, 80)    # rgb_geo_record: the JAX-CPU record's scene
RGB_GEO_RECORD_THRESHOLD = 512     # its SPH_CONTRACT_THRESHOLD
RGB_GEO_KNN_ROWS = 64
RGB_GEO_SKETCH_PAIRS = 200
SKETCH_SPEARMAN_MIN = 0.99         # docs/geo_salinas_validation.json: 1.0
SKETCH_ARGMIN_MIN = 0.95           # (the JAX package's, at 7680 px)
SKETCH_MET_MIN = 100               # level-1 pairs where the sketch meets
SKETCH_PATH_EDGES = 16             # a sketch path's most edges: 2 x 2^3
RECORD_KNN_IDS_MIN = 0.95
RELAX_FIELDS = 256                 # the geodesic paths' field batch
RELAX_ODD_FIELDS = 37              # a field count that is not a multiple of 4
RELAX_START_SWEEPS = 10            # twin sweeps before a comparison
RELAX_CALLS = 20
RECORD_SKETCH_RTOL = 1e-5
EVAL_GRID = "configs/pines_embed.json"   # the evaluation CLI's Pines grid
EVAL_PINES_SHAPE = (145, 145, 200)       # scripts/make_data.py's pines_synth
EVAL_RECORD_SHAPE = (64, 64, 200)        # eval_record: JAX-CPU runs it whole
EVAL_SEED = 7
EVAL_UMAP = {"dataDistNorm": ["UMAP"], "skipEmbeddingTSNE": True,
             "skipEmbeddingUMAP": False}
EVAL_KL_RTOL = 0.01        # tests/test_torch_pipeline.py:129
# the walk-variant grids (eval_pines_walks), each a run of the driver
EVAL_WALK_GRIDS = ("configs/pines_walk_variants.json",
                   "configs/pines_walk_topk.json")
SALINAS_WALKS_TSNE_ITERS = 2000    # bench_salinas.py:43's default
SALINAS_WALKS_KNN_ITERS = 1000     # the driver's schedule below 100k points
SALINAS_WALKS_RECALL_ROWS = 256    # level-1 walk kNN recall rows
SALINAS_WALKS_EXACT_ROWS = 64      # exact walk kNN rows vs float64
EXPLORER_KNN = ((0, 16), (1, 16), (1, 91))   # /api/knn (level, k)
EXPLORER_EXACT_ROWS = 64
# the switches of the t-SNE tier choice, all unset for the default path
TSNE_SWITCHES = ("SPH_TSNE_DENSE_P", "SPH_TSNE_DENSE_P_MAX", "SPH_TSNE_GRID",
                 "SPH_TSNE_GRID_MIN", "SPH_TSNE_GRID_MAX",
                 "SPH_TSNE_P_WIDTH_CAP", "SPH_TSNE_GRID_P_WIDTH",
                 "SPH_TSNE_ATTR_PACKED")
# BASELINE config 5 (multi_scene): 16 Pines-sized scenes, bench.py's
# flagship settings, then 1000 t-SNE iterations of every scene's level 0
MULTI_SCENE_SHAPE = (145, 145, 200)
MULTI_SCENES = 16
MULTI_SCENE_K = 91
MULTI_SCENE_ITERS = 1000
MULTI_SERIAL = 4           # bench_multiscene.py's A/B: batched vs serial
# multi_scene_record: bench_multiscene.py's defaults against JAX-CPU
MULTI_RECORD_SHAPE = (48, 48, 32)
MULTI_RECORD_SCENES = 4
MULTI_RECORD_ITERS = (250, 1000)
SHARDED_TSNE_ITERS = 100   # sharded: grid_vs_exact's P, 1 and 2 shards
SHARDED_UMAP_EPOCHS = 200
SHARDED_KL_RTOL = 0.005    # KL with 2 shards within 0.5 % of 1 shard's
# the edge tier against the sequential oracle, seed by seed, on the
# rehearsal's scene (create_hyperspectral_scene(32, 32, 8, seed=7), the
# Pines recipe at k = 31, 259 level-1 components), 100 epochs from one
# layout: over 32 seeds on the CPU the trustworthiness ratio ran
# 0.9838-1.0042 (mean 0.9952, 2 below 0.99) with the host union, the
# phase's, and 0.9842-1.0048 (mean 0.9935, 7 below) with the device union
# (scripts/umap_edge_spread.py, docs/torch_port_umap_edge_spread.json), so
# one seed's ratio says little; the gate holds the mean over the seeds to
# 0.99 and each seed to the host union's lowest less 0.01.  100 epochs, as
# the rehearsal runs its UMAP: 8 seeds of 200 cost 31.5 s on the card,
# past the phase's 15 s budget; at 50 the edge tier lags the oracle on
# the CPU (mean 0.9868)
SHARDED_SEEDS = tuple(range(8))
SHARDED_SEED_EPOCHS = 100
SEED_SCENE = (32, 32, 8)
SEED_SCENE_K = 31
EDGE_ORACLE_MEAN_MIN = 0.99
EDGE_ORACLE_SEED_MIN = 0.9737
SMOKE_SECONDS_MAX = 1000   # the whole script, builds included
DEV = "cuda"               # the helpers' device; "cpu" rehearses them small
WALK_SORT_COLS = 500       # the walk grids' and Pines' 50 walks of 10 steps
WALK_SORT_WIDE = (64, 50000)   # /api/walks' widest rows: 500 walks x 100 steps
WALK_SORT_BLOCK_COLS = 4096    # a width on the block path, staged whole
WALK_SORT_SYNTH_ROWS = 16      # rows of each synthetic kind
# /api/walks' widest answer at the Pines level 1 that `explorer` serves:
# its 5358 components' rows of 500 walks x 100 steps, held against the twin
# on WALK_SORT_SAMPLED rows (the twin on all takes seconds of host time)
WALK_SORT_EXPLORER = (5358, 50000)
WALK_SORT_SAMPLED = 256
# eval_pines_walks runs whose maps may differ from the JAX-CPU record, each
# with the traced op outside the walk rows that makes them differ (ROADMAP
# queue 3); every other run's maps must be byte-equal
WALK_MAPS_EXCEPTIONS: dict = {}
MERGE_CALLS = 20           # merge_runs calls timed at each merge shape
MERGE_TWIN_CALLS = 2       # its twin's
MERGE_PATH_CALLS = 2       # whole device-path merges timed (host clock)
MERGE_CAP_SHARE = 0.75     # the cap-biting merge: Pines' level-0 merge cut
                           # to this share of its width, made odd
SYM_CALLS = 2              # symmetrizations timed on each path


# the card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# float32 operations a pair (a fused multiply-add counts two, the
# reciprocal one), counted on the TPU kernel's s2 form, which is the
# yardstick kept for comparing versions: dx, dy 2; d^2 3; 1 + d^2 1; 1/d 1;
# w^2 1; the sums z, s2 2 and ax, ay 4 -> 14 (the CUDA kernel's direct form
# needs 13); the dense pass adds p w 1, its sum 1 and two more
# multiply-adds 4 -> 20
REPULSION_FLOPS_PER_PAIR = 14
FORCES_FLOPS_PER_PAIR = 20
# tsne_forces_dense's own shapes in kernel_vs_twin, (n, Npad): the driver's
# small levels (launch-bound), a walk variant's level 1, rgb_geo's level 2,
# the Pines main path's level 1, the driver's Pines level 0 and
# salinas_walks' level 1
FORCES_SHAPES = ((402, 512), (1286, 2048), (3306, 4096), (5284, 6144),
                 (21025, 21504), (28548, 28672))


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def forces_bound(n: int, npad: int) -> dict:
    """tsne_forces_dense: the n x n block of P that the function reads
    (rows and columns past n are pads it does not need) and y's n rows
    read once, attr and rep [npad, 2] and Z written once; n^2 pairs.
    The kernel's own workspace (the column splits' partial sums) is not
    counted: it is not an input or an output of the function."""
    return bound(4 * n * n + 8 * n + 16 * npad + 4,
                 FORCES_FLOPS_PER_PAIR * n * n)


def repulsion_bound(n: int, npad: int) -> dict:
    """tsne_repulsion: y read once, rep and the row Z written once; n^2
    pairs."""
    return bound(8 * npad + 12 * npad, REPULSION_FLOPS_PER_PAIR * n * n)


def attraction_bound(rows: int, width: int, npad: int, live: int,
                     packed: bool) -> dict:
    """tsne_attraction: P's ids and values read once (8 bytes an entry),
    the gathered positions once (the u16 table's 4 bytes a point packed,
    y's 8 unpacked), each row's own y read and its attr written once; 12
    flops a live entry (16 with the unpack's two multiply-adds)."""
    return bound(8 * rows * width + (4 if packed else 8) * npad + 16 * rows,
                 (16 if packed else 12) * live)


def grid_repulsion_bound(n: int, npad: int, grid: int) -> dict:
    """The grid tier's repulsion (ops/tsne_grid.py) at n points on a
    grid x grid grid, each stage's inputs read once and outputs written
    once: the deposit reads y (8 bytes a point) and writes the [3, G, G]
    charges; the FFT convolution reads them and writes the [4, G, G]
    fields; the interpolation reads the fields and y and writes rep
    [npad, 2] and Z.  Operations: nine real 2-D FFTs of [2G, 2G] (three
    forward of the charges, two of the kernels, four inverse) at 2.5 m
    log2 m flops each for m = 4 G^2, the spectral products (6 flops a
    complex product, four [2G, G + 1] of them), and about 300 flops a
    point for the taps' weights, the 48 deposit and 80 interpolation
    multiply-adds."""
    import math
    g2 = grid * grid
    nbytes = (8 * n + 12 * g2) + (12 * g2 + 16 * g2) + (16 * g2 + 8 * n
                                                        + 8 * npad + 4)
    m = 4 * g2
    flops = (9 * 2.5 * m * math.log2(m) + 6 * 4 * (2 * grid) * (grid + 1)
             + 300 * n)
    return {**bound(nbytes, flops), "bytes": nbytes, "flops": flops,
            "grid": grid}


# float32 operations a point of the grid tier's kernels (a multiply-add
# counts two): the grid coordinates (3 each), the eight cardinal weights
# (the distance and the cardinal's 3 differences and 3 products, 7 each),
# then for the deposit the charges times the x weights (8) and the 48 tap
# products and sums (96); for the interpolation the y contraction (16
# products and 12 sums for each of 4 fields), the x contraction (4 and 3 for
# each field) and rep (2 products and 2 differences)
GRID_DEPOSIT_FLOPS_PER_POINT = 6 + 56 + 8 + 96
GRID_INTERPOLATE_FLOPS_PER_POINT = 6 + 56 + 4 * 28 + 4 * 7 + 4


def grid_deposit_bound(n: int, grid: int) -> dict:
    """grid_deposit: y's n rows (8 bytes each) and the box (16 bytes) read
    once, the [3, G, G] charges written once; 166 flops a point."""
    nbytes = 8 * n + 16 + 12 * grid * grid
    flops = GRID_DEPOSIT_FLOPS_PER_POINT * n
    return {**bound(nbytes, flops), "bytes": nbytes, "flops": flops}


def grid_interpolate_bound(n: int, npad: int, grid: int) -> dict:
    """grid_interpolate: the [4, G, G] fields, y's n rows and the box read
    once, rep [npad, 2] and Z written once; 206 flops a point."""
    nbytes = 16 * grid * grid + 8 * n + 16 + 8 * npad + 4
    flops = GRID_INTERPOLATE_FLOPS_PER_POINT * n
    return {**bound(nbytes, flops), "bytes": nbytes, "flops": flops}


def sfu_floor_ms(n: int, sms: int, clock_hz: float) -> float:
    """tsne_repulsion's floor beside its operations bound: its reciprocals,
    one a pair, at 16 a clock on each of `sms` SMs at `clock_hz`."""
    return float(n) * n / (16 * sms * clock_hz) * 1e3


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it was written, in
    seconds since the script started (``t_s``), so that a slow run shows
    which phases took the time."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _STARTED}
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader" + ("" if units else ",nounits")],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    return float(nvidia_smi("clocks.max.sm", units=False)) * 1e6


def cuda_ms(fn, calls: int, warmup: int = 10) -> float:
    """Mean milliseconds per call from CUDA events around `calls` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def random_joint_p(n: int, npad: int, seed: int):
    """A seeded sparse symmetric joint P (about 90 neighbours a row), zero
    diagonal and pads, summing to 1, and a layout with pad rows 0, both
    made on DEV from a torch generator (a numpy P of 28672^2 would take
    seconds to build and copy)."""
    import torch
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    rows = torch.arange(n, device=DEV).repeat_interleave(45)
    cols = torch.randint(0, n, (rows.numel(),), generator=g, device=DEV)
    vals = torch.rand(rows.numel(), generator=g, device=DEV)
    p = torch.zeros((npad, npad), dtype=torch.float32, device=DEV)
    p.index_put_((rows, cols), vals, accumulate=True)
    p[:n, :n] += p[:n, :n].T.clone()
    p.fill_diagonal_(0.0)
    p /= p.sum()
    y = torch.zeros((npad, 2), dtype=torch.float32, device=DEV)
    y[:n] = torch.randn((n, 2), generator=g, device=DEV) * 5.0
    return y, p


def forces_checks(got, again, ref, n: int, name: str) -> dict:
    """A tsne_forces_dense result against its twin's: Z within 1e-5 of the
    twin's, relative; attr and rep within 1e-5 x max|twin|; pad rows 0;
    two calls bit-equal.  Raises on any; returns the largest error."""
    import torch
    z, z_r = float(got[2]), float(ref[2])
    if not abs(z - z_r) <= 1e-5 * abs(z_r):
        raise AssertionError(f"{name} n={n}: Z {z} vs twin {z_r}")
    err = 0.0
    for label, g, r in (("attr", got[0], ref[0]), ("rep", got[1], ref[1])):
        scale = float(r.abs().max())
        e = float((g - r).abs().max())
        if not e <= 1e-5 * scale:
            raise AssertionError(f"{name} n={n}: {label} max error {e} > "
                                 f"1e-5 x {scale}")
        if bool((g[n:] != 0).any()):
            raise AssertionError(f"{name} n={n}: {label} pad rows are not 0")
        err = max(err, e)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} n={n}: two calls differ")
    return {"max_abs_err": err, "z_rel_err": abs(z - z_r) / abs(z_r),
            "bits_equal_two_calls": True}


def check_forces_kernel(n: int, npad: int, seed: int, calls: int = 200,
                        plain_calls: int = 0) -> dict:
    """tsne_forces_dense against its twin (``forces_checks``), Z from the
    kernel; ms a call of the kernel into caller-owned buffers, as the dense
    tier calls it (back-to-back calls: the host's cost shows where it is the
    larger), and of the twin over `plain_calls` calls (up to 20 to Npad
    8192, else 5), with the shape's bound and the launch plan."""
    from sph_tpu_torch.ops.tsne_kernels import (DenseForces,
                                                tsne_forces_dense,
                                                tsne_forces_dense_reference)
    y, p = random_joint_p(n, npad, seed)
    bufs = (DenseForces(npad, y.device), DenseForces(npad, y.device))
    got = tsne_forces_dense(y, p, n, out=bufs[0])
    again = tsne_forces_dense(y, p, n, out=bufs[1])
    ref = tsne_forces_dense_reference(y, p, n)
    sync()
    out = {"n": n, "npad": npad, **forces_checks(got, again, ref, n,
                                                 "tsne_forces_dense")}
    plain_calls = plain_calls or (min(calls, 20) if npad <= 8192 else 5)
    ms = cuda_ms(lambda: tsne_forces_dense(y, p, n, out=bufs[0]), calls)
    plain_ms = cuda_ms(lambda: tsne_forces_dense_reference(y, p, n),
                       plain_calls, warmup=min(10, plain_calls))
    plan = bufs[0].plan
    return {**out, "ms": ms, "plain_ms": plain_ms, "calls_timed": calls,
            "plain_calls_timed": plain_calls,
            "plan": {"tiles": plan.tiles, "splits": plan.splits,
                     "split_cols": plan.split_cols, "blocks": plan.blocks},
            **forces_bound(n, npad)}


def check_attraction_kernel(y, p_idx, p_val, calls: int = 20,
                            twin_calls: int = 3, windows: int = 2) -> dict:
    """tsne_attraction against its twin at one path's P (ids int32) and
    layout, unpacked and packed: the largest error (raises above 1e-5 x
    max|twin|), two calls bit-equal and `windows` row windows (a shard's
    rows with row0) bit-equal to the full call's rows (raises otherwise),
    ms a call of the kernel, of the twin and of the packing, each against
    the bound."""
    import torch
    from sph_tpu_torch.ops.packing import pack_positions
    from sph_tpu_torch.ops.tsne_kernels import (tsne_attraction,
                                                tsne_attraction_reference)
    rows, width = p_idx.shape
    npad = y.shape[0]
    live = int((p_idx >= 0).sum())
    out = {"rows": rows, "width": width, "npad": npad, "live_entries": live}
    for packed in (False, True):
        table, prm = (pack_positions(y[:, 0], y[:, 1]) if packed
                      else (None, None))
        got = tsne_attraction(y, p_idx, p_val, 0, table, prm)
        again = tsne_attraction(y, p_idx, p_val, 0, table, prm)
        ref = tsne_attraction_reference(y, p_idx, p_val, 0, table, prm)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        name = "packed" if packed else "unpacked"
        if not err <= 1e-5 * scale:
            raise AssertionError(f"tsne_attraction {name} at {rows} x "
                                 f"{width}: error {err} > 1e-5 x {scale}")
        if not torch.equal(got, again):
            raise AssertionError(f"tsne_attraction {name}: two calls differ")
        cuts = [rows * i // windows for i in range(windows + 1)]
        for r0, r1 in zip(cuts, cuts[1:]):
            part = tsne_attraction(y, p_idx[r0:r1], p_val[r0:r1], r0, table,
                                   prm)
            if not torch.equal(part, got[r0:r1]):
                raise AssertionError(f"tsne_attraction {name}: rows {r0} .. "
                                     f"{r1} differ from the full call's")
        run = {"max_abs_err": err, "max_abs_ref": scale,
               "bits_equal_two_calls": True, "windows_equal_full": windows,
               "ms": cuda_ms(lambda: tsne_attraction(
                   y, p_idx, p_val, 0, table, prm), calls, 3),
               "plain_ms": cuda_ms(lambda: tsne_attraction_reference(
                   y, p_idx, p_val, 0, table, prm), twin_calls, 1),
               "calls_timed": calls,
               **attraction_bound(rows, width, npad, live, packed)}
        if packed:
            run["pack_ms"] = cuda_ms(lambda: pack_positions(y[:, 0], y[:, 1]),
                                     calls, 3)
        out[name] = run
    return out


def repulsion_layout(n: int, npad: int, seed: int):
    """A seeded layout of n points (normal, scale 5) with garbage in the pad
    rows, which the kernel must not read."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((npad, 2), dtype=np.float32) * 50.0
    y[:n] = rng.standard_normal((n, 2), dtype=np.float32) * 5.0
    return y


def sample_ranges(npad: int, count: int = 4, width: int = 1024):
    """`count` row ranges of `width` rows spread evenly over [0, npad): the
    first starts at 0, the last ends at npad (the last real rows and the
    pad rows)."""
    width = min(width, npad // count)
    return [(s, s + width) for s in
            (i * (npad - width) // (count - 1) for i in range(count))]


def check_repulsion_kernel(y, n: int, calls: int = 0, twin_calls: int = 0,
                           sampled: bool = False,
                           clock_hz: float | None = None) -> dict:
    """tsne_repulsion against its twin on the card, in full or on sampled
    rows, and two calls bit-equal; raises on disagreement.  calls > 0 also
    times the kernel with CUDA events and gives its SFU floor at the card's
    SM count and `clock_hz` (twin_calls > 0 times the full twin)."""
    import torch
    from sph_tpu_torch.ops.tsne_kernels import (REPULSION_TILE,
                                                repulsion_plan,
                                                tsne_repulsion_reference,
                                                tsne_repulsion_rows)
    npad = y.shape[0]
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if DEV == "cuda" else 132)
    plan = repulsion_plan(n, sms)
    rep, zrow = tsne_repulsion_rows(y, n)
    rep2, zrow2 = tsne_repulsion_rows(y, n)
    if sampled:
        ranges = sample_ranges(npad)
    else:
        ranges = [(0, npad)]
    refs = [tsne_repulsion_reference(y, n, rows=r) for r in ranges]
    sync()
    name = f"tsne_repulsion n={n} npad={npad}"
    if not (torch.equal(rep, rep2) and torch.equal(zrow, zrow2)):
        raise AssertionError(f"{name}: two calls differ")
    got_rep = torch.cat([rep[a:b] for a, b in ranges])
    got_z = torch.cat([zrow[a:b] for a, b in ranges])
    ref_rep = torch.cat([r for r, _ in refs])
    ref_z = torch.cat([z for _, z in refs])
    scale = float(ref_rep.abs().max())
    err = float((got_rep - ref_rep).abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{name}: rep max error {err} > 1e-5 x {scale}")
    live = ref_z > 0
    z_rel = float(((got_z - ref_z).abs()[live] / ref_z[live]).max())
    if not z_rel <= 1e-5:
        raise AssertionError(f"{name}: zrow relative error {z_rel} > 1e-5")
    if bool((rep[n:] != 0).any()) or bool((zrow[n:] != 0).any()):
        raise AssertionError(f"{name}: pad rows are not 0")
    out = {"n": n, "npad": npad, "max_abs_err": err,
           "rep_err_over_max": err / scale, "zrow_rel_err": z_rel,
           "rows_checked": sum(b - a for a, b in ranges),
           "bits_equal_across_calls": True,
           "plan": {"tile": REPULSION_TILE, "splits": plan.splits,
                    "split_cols": plan.split_cols, "blocks": plan.blocks}}
    if not sampled:
        z, z_ref = float(zrow.sum()), float(ref_z.double().sum())
        out["z_rel_err"] = abs(z - z_ref) / z_ref
        if not out["z_rel_err"] <= 1e-5:
            raise AssertionError(f"{name}: Z {z} vs twin {z_ref}")
    if calls:
        out["ms"] = cuda_ms(lambda: tsne_repulsion_rows(y, n), calls,
                            warmup=min(10, calls // 10))
        out["calls_timed"] = calls
        out["sfu_floor_ms"] = sfu_floor_ms(n, sms, clock_hz)
        out["sms"], out["sm_clock_hz"] = sms, clock_hz
    if twin_calls:
        out["plain_ms"] = cuda_ms(lambda: tsne_repulsion_reference(y, n),
                                  twin_calls, warmup=1)
        out["plain_calls_timed"] = twin_calls
    return out


def knn_exactness(data, idx, k: int, rows) -> dict:
    """The kNN's neighbour sets on `rows` against float64 distances on the
    card; raises unless a row differs from the float64 top-k only by
    swapping a point e in for a point m with d(e) - d(m) <= b(e) + b(m).
    b is an a-priori bound on the float32 rounding of the kNN's
    |x|^2 + |y|^2 - 2 x.y: sqrt(D) eps (|x|^2 + |y|^2) for D channels, as
    each of its three float32 sums of D terms gathers about sqrt(D)
    roundings of its size.  Also counts the rows outside the rule "k-th and
    (k+1)-th float64 distances within 1e-6 relative", and measures the
    float32 expansion's error on the card against eps (|x|^2 + |y|^2)."""
    import numpy as np
    import torch
    x32 = torch.as_tensor(data, device=DEV)
    x64 = x32.double()
    sq32, sq64 = (x32 * x32).sum(1), (x64 * x64).sum(1)
    eps = float(np.finfo(np.float32).eps)
    c = float(np.sqrt(x32.shape[1]))
    idx_t = torch.as_tensor(idx, device=DEV).long()
    differ = beyond_1e6 = 0
    worst_swap = worst_err = 0.0
    for c0 in range(0, len(rows), 128):
        q = torch.as_tensor(rows[c0:c0 + 128], device=DEV).long()
        ar = torch.arange(q.numel(), device=DEV)
        d64 = (sq64[q, None] + sq64[None, :] - 2.0 * (x64[q] @ x64.T))
        d64.clamp_(min=0.0)[ar, q] = 0.0
        d32 = (sq32[q, None] + sq32[None, :] - 2.0 * (x32[q] @ x32.T))
        d32.clamp_(min=0.0)[ar, q] = 0.0
        top = torch.topk(d64, k + 1, dim=1, largest=False, sorted=True)
        for r in range(q.numel()):
            got = set(idx_t[q[r]].tolist())
            want = set(top.indices[r, :k].tolist())
            cand = torch.tensor(sorted(got | want), device=DEV)
            norm = sq64[q[r]] + sq64[cand]
            worst_err = max(worst_err, float(
                ((d32[r, cand].double() - d64[r, cand]).abs()
                 / (eps * norm)).max()))
            if got == want:
                continue
            differ += 1
            dk, dk1 = float(top.values[r, k - 1]), float(top.values[r, k])
            if dk1 - dk >= 1e-6 * dk1:
                beyond_1e6 += 1
            extra = torch.tensor(sorted(got - want), device=DEV)
            missed = torch.tensor(sorted(want - got), device=DEV)
            b_e = c * eps * (sq64[q[r]] + sq64[extra])
            b_m = c * eps * (sq64[q[r]] + sq64[missed])
            swap = float(((d64[r, extra][:, None] - d64[r, missed][None, :])
                          / (b_e[:, None] + b_m[None, :])).max())
            worst_swap = max(worst_swap, swap)
            if swap > 1.0:
                raise AssertionError(
                    f"kNN row {int(q[r])}: neighbours differ from the "
                    f"float64 top-{k} by {swap} x the float32 band")
        del d64, d32
    return {"rows": len(rows), "rows_differing": differ,
            "rows_outside_1e-6_rule": beyond_1e6,
            "band_eps_factor": c, "max_swap_over_band": worst_swap,
            "max_f32_err_over_eps_norm": worst_err}


def recall_at_k(idx, truth, block: int = 65536) -> float:
    """benchmarks/bench_recall.py:116-119's count: the ids each row of
    `idx` shares with the same row of `truth`, over rows x k.  A kNN row
    holds distinct ids, so the shared ids are the entries of `idx` found in
    `truth`'s row; counted in blocks of rows."""
    hits = 0
    for r0 in range(0, truth.shape[0], block):
        a, b = idx[r0:r0 + block], truth[r0:r0 + block]
        hits += int((a[:, :, None] == b[:, None, :]).any(2).sum())
    return hits / truth.size


def overlap_recall(ids, dists, kth) -> float:
    """An approximate component kNN's recall against the exact one, counted
    by distance: a neighbour counts when its distance (the exact pair
    metric) is at most the exact kNN's k-th distance on its row, `kth`; over
    rows x k.  NEIGH_OVERLAP distances tie in runs (1 - |A^B| / min), so
    which of the tied components the exact kNN keeps is arbitrary."""
    import numpy as np
    hits = ((ids >= 0) & (dists <= np.asarray(kth)[:, None])).sum()
    return float(hits) / ids.size


def p_checks(p, idx, dist, perplexity: float) -> dict:
    """The kNN path's P as t-SNE holds it: (P + P^T) / 2 with rows cut to
    the width cap.  Every entry's mirror is there with the same value,
    unless the mirror's row is a full (capped) row; and the conditional
    Gaussian rows it came from each sum to 1."""
    import numpy as np
    import torch
    from sph_tpu_torch.ops.distributions import gaussian_row_distributions
    out = p_mirror_checks(p)
    mask = idx >= 0
    cond = gaussian_row_distributions(
        torch.as_tensor(np.where(mask, dist, 0.0).astype(np.float32),
                        device=DEV),
        torch.as_tensor(mask, device=DEV), perplexity, ignore_first=True)
    worst = float((cond.sum(1) - 1.0).abs().max())
    if not worst <= 1e-3:
        raise AssertionError(f"conditional P rows do not sum to 1: {worst}")
    return {**out, "conditional_row_sum_err": worst}


def keeping_conditional_rows(ch, level: int, kept: dict):
    """Stage 3 of `ch` (compute_level_similarities), with a copy of the
    level's conditional rows, taken just before they are symmetrized, in
    kept[level] (for ``shed_reverse_keys``)."""
    ls = ch.level_similarities
    symmetrize = ls.symmetrize_output

    def keep_then_symmetrize(method):
        if ls.prob_dists[level] is not None:
            kept[level] = ls.prob_dists[level].copy()
        symmetrize(method)

    ls.symmetrize_output = keep_then_symmetrize
    try:
        ch.compute_level_similarities()
    finally:
        del ls.symmetrize_output


def shed_reverse_keys(cond):
    """The reverse entries that the JAX package's device path
    (ops/sparse.symmetrize_device_path) sheds when it symmetrizes the
    conditional rows `cond`, worked out here on the host: the rows first
    cut to SPH_SYM_P_WIDTH_CAP by value where the matrix passes
    SPH_SYM_FLAT_BUDGET elements (t-SNE renormalizes them), then each
    entry (i, j, v) goes to row j as a reverse entry, and row j keeps its
    ``reverse_width`` largest (ties to the lower i).  Returns the sorted
    keys j * n + i of the P entries (j, i) that lost i's reverse value."""
    import numpy as np
    import torch
    from sph_tpu_torch.ops.sparse import (normalize_rows, reverse_width,
                                          topk_rows)
    n = cond.num_rows
    budget = int(os.environ.get("SPH_SYM_FLAT_BUDGET", str(48 * 2**20)))
    wcap = int(os.environ.get("SPH_SYM_P_WIDTH_CAP", "256"))
    if 0 < wcap < cond.width and n * cond.width > budget:
        cond = normalize_rows(topk_rows(cond, wcap))
    idx, val = cond.indices, cond.values
    live = (idx >= 0) & (val != 0)
    rows = np.broadcast_to(np.arange(n)[:, None], idx.shape)[live]
    cols, vals = idx[live].astype(np.int64), val[live]
    in_degree = np.bincount(cols, minlength=n)
    wrev = reverse_width(n, cond.width,
                         int(in_degree.max()) if cols.size else 0)
    order = np.lexsort((rows, -vals, cols))     # by column, value, row
    starts = np.cumsum(in_degree) - in_degree
    rank = np.empty(cols.size, np.int64)
    rank[order] = np.arange(cols.size) - starts[cols[order]]
    shed = rank >= wrev
    keys = np.sort(cols[shed] * n + rows[shed])
    return torch.as_tensor(keys)


def p_mirror_checks(p, shed_keys=None) -> dict:
    """A joint P as t-SNE holds it: every entry's mirror is there with the
    same value, unless the mirror's row is a full (capped) row; its nnz,
    width, cut rows and mass a row.  shed_keys: for a P symmetrized on the
    JAX package's device path, the entries that lost their reverse value
    there (``shed_reverse_keys``): a pair one of whose two entries is
    among them may lack its mirror or differ from it; every other pair,
    hub rows' included, must match."""
    import torch
    n = p.num_rows
    live = p._live()
    nnz = live.sum(1)
    rows = torch.arange(n, device=p.device)[:, None].expand_as(p.idx)[live]
    cols, vals = p.idx[live], p.val[live]
    keys, order = torch.sort(rows * n + cols)
    vals = vals[order]
    rows, cols = keys // n, keys % n
    mirror = cols * n + rows
    pos = torch.searchsorted(keys, mirror)
    pos.clamp_(max=keys.numel() - 1)
    found = keys[pos] == mirror
    excused = torch.zeros_like(found)
    shed_n = 0
    if shed_keys is not None and shed_keys.numel():
        shed_keys = shed_keys.to(p.device)
        shed_n = shed_keys.numel()

        def among(k):
            at = torch.searchsorted(shed_keys, k).clamp_(max=shed_n - 1)
            return shed_keys[at] == k

        excused = among(keys) | among(mirror)
    if not bool((found | (nnz[cols] == p.width) | excused).all()):
        raise AssertionError("P: an entry's mirror is missing from a row "
                             "that was not cut")
    both = found & ~excused
    asym = (float((vals[both] - vals[pos[both]]).abs().max())
            if bool(both.any()) else 0.0)
    if not asym <= 1e-6 * float(vals.abs().max()):
        raise AssertionError(f"P is not symmetric: {asym}")
    return {"p_nnz": int(live.sum()), "p_width": p.width,
            "p_rows_cut_to_width": int((nnz == p.width).sum()),
            "p_mirrors_cut": int((~found).sum()),
            "p_mass_kept": float(vals.sum()) / n, "p_asymmetry": asym,
            "p_reverse_entries_shed": shed_n,
            "p_entries_excused": int(excused.sum())}


@contextlib.contextmanager
def env(**values):
    """Set (a string) or unset (None) environment variables for the block,
    then restore them."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def zero_launches(tsne_kernels) -> None:
    for name in tsne_kernels.KERNELS:
        getattr(tsne_kernels, name).launches = 0


def read_launches(tsne_kernels) -> dict:
    return {name: getattr(tsne_kernels, name).launches
            for name in tsne_kernels.KERNELS}


def scene_graph(rows: int, cols: int, k: int = 16) -> dict:
    """A synthetic rows x cols x 100 stack (Scaler.NONE) and its exact kNN
    graph (BASELINE config 4's recipe); seconds of both and the kNN's peak
    memory."""
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import compute_knn
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    seconds = {}
    t = time.perf_counter()
    img = create_hyperspectral_scene(rows, cols, 100, seed=7)
    data = T.scale(T.ImageStack.from_array(img, name="synthetic").data,
                   T.Scaler.NONE)
    seconds["data"] = time.perf_counter() - t
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    idx, dist = compute_knn(data, k, T.KnnIndex.BRUTE_FORCE, device=DEV)
    seconds["knn"] = time.perf_counter() - t
    knn_peak = (torch.cuda.max_memory_allocated() if DEV == "cuda"
                else "not measured")
    return {"data": data, "idx": idx, "dist": dist, "seconds": seconds,
            "knn_peak": knn_peak}


def tsne_settings(iters: int, k: int):
    import sph_tpu_torch as T
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    es.tsne.perplexity = (k - 1) / 3.0       # HDILib's perplexity multiplier
    return es


def large_path(tsne_kernels, iters: int, k: int = 16, rows: int = 1000,
               cols: int = 1000, graph: dict = None) -> dict:
    """BASELINE config 4 at full width (benchmarks/bench_1m.py) on the tier
    the environment selects, from `graph` (made here when None): returns
    its timings, results and what its checks need.  Kernel counts are set
    to 0 just before the t-SNE and read just after."""
    import sph_tpu_torch as T
    graph = graph or scene_graph(rows, cols, k)
    seconds = dict(graph["seconds"])
    zero_launches(tsne_kernels)
    es = tsne_settings(iters, k)
    ce = T.ComputeEmbedding(es, device=DEV)
    emb = ce.compute_tsne((graph["idx"], graph["dist"]), track_kl=True)
    launches = read_launches(tsne_kernels)
    seconds["p_and_set_up"] = ce.seconds["set_up"]
    seconds["tsne"] = ce.seconds["iterations"]
    seconds["kl"] = ce.seconds["kl"]
    return {"data": graph["data"], "idx": graph["idx"],
            "dist": graph["dist"], "emb": emb, "ce": ce, "es": es,
            "seconds": seconds, "knn_peak": graph["knn_peak"],
            "launches": launches, "kl": float(ce.last_kl)}


def fullest_cell(y, n: int, grid: int) -> int:
    """The most points in one base cell of the grid tier's deposit at the
    layout y [Npad, 2] on a grid x grid grid."""
    import torch
    from sph_tpu_torch.ops import tsne_grid as G
    lo, h = G.grid_box(y, n, grid)
    return int(torch.bincount(G.base_cells(G.grid_coords(y[:n], lo, h),
                                           grid)).max())


def launch_diff(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


def grid_path(tsne_kernels, graph: dict, iters: int,
              kl_at=(0, 250, 1000), keep_at: int = GRID_LAYOUT_AT) -> dict:
    """t-SNE from `graph` on the default tier (the grid above 32768 points)
    through ComputeEmbedding, with the KL at the iterations `kl_at` (chunk
    ends) and at the end.  Kernel counts are set to 0 just before and read
    just after; the seconds of the KLs taken on the way are kept apart
    from the iterations', and so are their launches: those of each KL on
    the way, and the final KL's, counted as one of those.  Also the points
    in the fullest base cell after the first chunk on each grid size and
    at the end, and the layout after iteration `keep_at` with its grid."""
    import torch
    import sph_tpu_torch as T
    k = graph["idx"].shape[1]
    zero_launches(tsne_kernels)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ce = T.ComputeEmbedding(tsne_settings(iters, k), device=DEV)
    kls, kl_seconds, kl_launches, fullest, kept = {}, [0.0], [], [], {}

    def progress(comp):
        it = comp.current_iteration
        if it > 0 and (not fullest or fullest[-1][1] != comp._grid):
            fullest.append([it, comp._grid,
                            fullest_cell(comp._y, comp._n, comp._grid)])
        if it == keep_at:
            kept.update(y=comp._y.clone(), grid=comp._grid, iteration=it)
        if it in kl_at:
            t = time.perf_counter()
            before = read_launches(tsne_kernels)
            kls[it] = comp.kl_divergence()
            kl_launches.append(launch_diff(read_launches(tsne_kernels),
                                           before))
            kl_seconds[0] += time.perf_counter() - t

    with env(**{name: None for name in TSNE_SWITCHES}):
        emb = ce.compute_tsne((graph["idx"], graph["dist"]), track_kl=True,
                              progress=progress)
    launches = read_launches(tsne_kernels)
    peak = (torch.cuda.max_memory_allocated() if DEV == "cuda"
            else "not measured")
    kls[iters] = float(ce.last_kl)
    comp = ce.last_computation
    fullest.append([iters, comp._grid, fullest_cell(comp._y, comp._n,
                                                    comp._grid)])
    seconds = {"p_and_set_up": ce.seconds["set_up"],
               "tsne": ce.seconds["iterations"] - kl_seconds[0],
               "kl_on_the_way": kl_seconds[0], "kl": ce.seconds["kl"]}
    return {"emb": emb, "ce": ce, "kls": kls, "seconds": seconds,
            "launches": launches, "kl_launches": kl_launches,
            "iteration_launches": grid_iteration_launches(launches,
                                                          kl_launches),
            "fullest_cell_by_grid": fullest, "kept_layout": kept,
            "peak_memory_bytes": peak}


def grid_iteration_launches(launches: dict, kl_launches: list) -> dict:
    """The launches of a grid-tier run's iterations: the run's less its
    KLs' (those on the way, and the final one, which launches what each of
    them launched).  Raises if the KLs on the way launched differently."""
    if any(d != kl_launches[0] for d in kl_launches):
        raise AssertionError(f"the grid tier's KLs launched differently: "
                             f"{kl_launches}")
    per_kl = kl_launches[0] if kl_launches else {n: 0 for n in launches}
    return {name: launches[name] - (len(kl_launches) + 1) * per_kl[name]
            for name in launches}


def grid_launch_gate(iteration_launches: dict, kl_launches: list,
                     iters: int, name: str = "large_grid") -> None:
    """The grid tier's iterations launch tsne_attraction, grid_deposit and
    grid_interpolate once each an iteration and no other kernel; each KL
    launches grid_deposit and grid_interpolate once (its Z) and nothing
    else."""
    want = {"tsne_attraction": iters, "grid_deposit": iters,
            "grid_interpolate": iters}
    got = {k: v for k, v in iteration_launches.items() if v}
    if got != want:
        raise AssertionError(f"{name}: the iterations launched {got}, not "
                             f"{want}")
    for d in kl_launches:
        if {k: v for k, v in d.items() if v} != {"grid_deposit": 1,
                                                 "grid_interpolate": 1}:
            raise AssertionError(f"{name}: a KL launched {d}")


def grid_sizes(history) -> list:
    """[first iteration, G] for each change of the grid size."""
    out = []
    for it, g in history:
        if not out or out[-1][1] != g:
            out.append([it, g])
    return out


def z_gap(comp) -> dict:
    """Z of the layout from the grid (the size the KL used) and from the
    exact tsne_repulsion kernel, and the final KL with the exact Z: with
    P renormalized over its support, KL(Z') = KL(Z) + log(Z' / Z)."""
    import math
    from sph_tpu_torch.ops.tsne_grid import grid_repulsion
    from sph_tpu_torch.ops.tsne_kernels import tsne_repulsion
    g = comp._current_grid()
    _, z_grid = grid_repulsion(comp._y, comp._n, g)
    _, z_exact = tsne_repulsion(comp._y, comp._n)
    z_grid, z_exact = float(z_grid), float(z_exact)
    return {"grid": g, "z_grid": z_grid, "z_exact": z_exact,
            "z_rel_gap": abs(z_grid - z_exact) / z_exact,
            "log_z_ratio": math.log(z_exact / z_grid)}


def grid_split(comp, calls: int = 10) -> dict:
    """Milliseconds of one grid-tier iteration by part at the computation's
    layout, CUDA events: the attraction as _forces calls it (the packed
    table and the tsne_attraction kernel), the same unpacked, the packing
    alone, the box, the deposit (grid_deposit: its keys and sort, timed
    alone too, and its kernel), the FFT convolution, the interpolation
    (grid_interpolate), the update, and the whole step; and the points in
    the fullest base cell.  The state is put back afterwards."""
    import torch
    from sph_tpu_torch.models.tsne import attractive_forces
    from sph_tpu_torch.ops import tsne_grid as G
    from sph_tpu_torch.ops.packing import pack_positions
    y, n, g = comp._y, comp._n, comp._grid
    lo, h = G.grid_box(y, n, g)
    yv = y[:n]
    charges = G.grid_deposit(yv, lo, h, g)
    fields = G.field_grids(charges, h, g)
    state = (comp._y, comp._vel, comp._gain, comp._iteration)
    forces = comp._forces()

    def update():
        comp._update(*forces)
        comp._y, comp._vel, comp._gain, comp._iteration = state

    ms = {"grid": g, "attraction_packed": comp.attr_packed,
        "attraction": cuda_ms(lambda: attractive_forces(
            y, comp._p_idx32, comp._p_val, packed=comp.attr_packed), calls,
            2),
        "attraction_unpacked": cuda_ms(lambda: attractive_forces(
            y, comp._p_idx32, comp._p_val), calls, 2),
        "pack": cuda_ms(lambda: pack_positions(y[:, 0], y[:, 1]), calls, 2),
        "box": cuda_ms(lambda: G.grid_box(y, n, g), calls, 2),
        "deposit": cuda_ms(lambda: G.grid_deposit(yv, lo, h, g), calls, 2),
        "deposit_keys_and_sort": cuda_ms(lambda: torch.sort(G.base_cells(
            G.grid_coords(yv, lo, h), g), stable=True), calls, 2),
        "fft": cuda_ms(lambda: G.field_grids(charges, h, g), calls, 2),
        "interpolation": cuda_ms(lambda: G.grid_interpolate(
            fields, y, n, lo, h), calls, 2),
        "update": cuda_ms(update, calls, 2)}
    ms["deposit_kernel"] = ms["deposit"] - ms["deposit_keys_and_sort"]
    ms["box_deposit_interpolation"] = (ms["box"] + ms["deposit"]
                                       + ms["interpolation"])
    ms["step"] = cuda_ms(comp._step, calls, 2)
    comp._y, comp._vel, comp._gain, comp._iteration = state
    ms["points_in_fullest_cell"] = fullest_cell(y, n, g)
    return ms


def check_grid_kernels(y, n: int, grid: int, label: str,
                       calls: int = GRID_KERNEL_CALLS,
                       twin_calls: int = GRID_TWIN_CALLS) -> tuple:
    """grid_deposit and grid_interpolate against their twins at the layout
    y [Npad, 2] on a grid x grid grid: each kernel's result bit-equal to
    its twin's on the same inputs and two calls bit-equal (raises
    otherwise); with calls > 0, ms a call of each kernel's wrapper and of
    its twin (CUDA events), each against its bound.  Returns the two
    kernel_vs_twin lines (deposit, interpolation)."""
    import torch
    from sph_tpu_torch.ops import tsne_grid as G
    npad = y.shape[0]
    lo, h = G.grid_box(y, n, grid)
    yv = y[:n]
    dep = G.grid_deposit(yv, lo, h, grid)
    dep2 = G.grid_deposit(yv, lo, h, grid)
    dep_ref = G.grid_deposit_reference(yv, lo, h, grid)
    fields = G.field_grids(dep_ref, h, grid)
    got = G.grid_interpolate(fields, y, n, lo, h)
    again = G.grid_interpolate(fields, y, n, lo, h)
    ref = G.grid_interpolate_reference(fields, y, n, lo, h)
    sync()
    name = f"{label} (n={n}, G={grid})"
    if not torch.equal(dep, dep_ref):
        raise AssertionError(f"grid_deposit {name}: differs from its twin by"
                             f" {float((dep - dep_ref).abs().max())}")
    if not torch.equal(dep, dep2):
        raise AssertionError(f"grid_deposit {name}: two calls differ")
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"grid_interpolate {name}: differs from its "
                             f"twin by {float((got[0] - ref[0]).abs().max())}"
                             f" (rep), {float(got[1])} vs {float(ref[1])} "
                             "(Z)")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"grid_interpolate {name}: two calls differ")
    if bool((got[0][n:] != 0).any()):
        raise AssertionError(f"grid_interpolate {name}: pad rows are not 0")
    common = {"path_shape": label, "n": n, "npad": npad, "grid": grid,
              "bits_equal_twin": True, "bits_equal_two_calls": True,
              "max_abs_err": 0.0}
    deposit = {**common, "points_in_fullest_cell": fullest_cell(y, n, grid),
               "dense_points": G.DEPOSIT_DENSE_POINTS,
               **grid_deposit_bound(n, grid)}
    interp = {**common, **grid_interpolate_bound(n, npad, grid)}
    if calls:
        for line, fn, twin in (
                (deposit, lambda: G.grid_deposit(yv, lo, h, grid),
                 lambda: G.grid_deposit_reference(yv, lo, h, grid)),
                (interp, lambda: G.grid_interpolate(fields, y, n, lo, h),
                 lambda: G.grid_interpolate_reference(fields, y, n, lo,
                                                      h))):
            line["ms"] = cuda_ms(fn, calls, 3)
            line["plain_ms"] = cuda_ms(twin, twin_calls, 1)
            line["calls_timed"] = calls
            line["plain_calls_timed"] = twin_calls
            line["share_of_bound"] = line["bound_ms"] / line["ms"]
        deposit["keys_and_sort_ms"] = cuda_ms(lambda: torch.sort(
            G.base_cells(G.grid_coords(yv, lo, h), grid), stable=True),
            calls, 3)
    return deposit, interp


def grid_kernel_line(name: str, checks: list, launches_by_path: list) -> dict:
    """The kernels line's entry of grid_deposit or grid_interpolate from
    ``check_grid_kernels``' lines (the first, the 1M run's final layout,
    gives ms, twin ms and bound) and the launches of each path (the first,
    the 1M run's iterations, gives launches)."""
    i = ("grid_deposit", "grid_interpolate").index(name)
    main = checks[0][i]
    jax_fn = ("sph_tpu/ops/tsne_grid.py:104 deposit_charges",
              "sph_tpu/ops/tsne_grid.py:149 interpolate_fields")[i]
    return {
        "name": name, "route": "cuda",
        "source": f"sph_tpu_torch/csrc/{name}.cu",
        "replaces": f"{jax_fn} (an XLA program: no pallas_call)",
        "launches": launches_by_path[0]["launches"],
        "max_abs_err": max(c[i]["max_abs_err"] for c in checks),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call takes the points and the "
                        "box to the charges or the fields to the forces",
        "shape": [main["n"], main["grid"]],
        "launches_by_path": launches_by_path,
        "at_shapes": [{k: c[i][k] for k in (
            "path_shape", "n", "grid", "ms", "plain_ms", "bound_ms",
            "bound_by", "share_of_bound", "max_abs_err")
            if k in c[i]} for c in checks]}


def scatter_repeatability(comp) -> dict:
    """Two grid_repulsion calls on the same layout: whether they give the
    same bits (the deposit sums in a fixed order), and how far apart they
    are if not."""
    from sph_tpu_torch.ops.tsne_grid import grid_repulsion
    g = comp._current_grid()
    r1, z1 = grid_repulsion(comp._y, comp._n, g)
    r2, z2 = grid_repulsion(comp._y, comp._n, g)
    return {"grid": g, "bits_equal": bool((r1 == r2).all() and z1 == z2),
            "rep_max_rel_diff": float((r1 - r2).abs().max()
                                      / r1.abs().max()),
            "z_rel_diff": abs(float(z1) - float(z2)) / float(z1)}


def grid_vs_exact(tsne_kernels, rows: int = 256, cols: int = 256,
                  iters: int = 1000, k: int = 16) -> dict:
    """The 1M recipe at rows x cols: `iters` iterations on the grid tier
    (the default above 32768 points) and on the exact tier
    (SPH_TSNE_GRID=0), from the same P and initial layout: the grid tier's
    cut of P to 64 entries a row is switched off (SPH_TSNE_GRID_P_WIDTH=0),
    so the grid's repulsion is the one difference.  Both layouts are scored
    under that P with the exact Z."""
    import sph_tpu_torch as T
    from sph_tpu_torch.models.tsne import tsne_kl_divergence
    graph = scene_graph(rows, cols, k)
    out = {"n": graph["idx"].shape[0], "k": k, "iterations": iters,
           "seconds": dict(graph["seconds"])}
    runs = {}
    for tier, switches in (("grid", {"SPH_TSNE_GRID_P_WIDTH": "0"}),
                           ("exact", {"SPH_TSNE_GRID": "0"})):
        zero_launches(tsne_kernels)
        ce = T.ComputeEmbedding(tsne_settings(iters, k), device=DEV)
        with env(**{**{name: None for name in TSNE_SWITCHES}, **switches}):
            ce.compute_tsne((graph["idx"], graph["dist"]), track_kl=True)
        runs[tier] = ce.last_computation
        out[tier] = {"tier": ce.last_computation.tier,
                     "p_width": ce.last_computation._p_val.shape[1],
                     "seconds": ce.seconds["iterations"],
                     "iters_per_s": iters / ce.seconds["iterations"],
                     "kl_own": float(ce.last_kl),
                     "launches": read_launches(tsne_kernels)}
    exact = runs["exact"]
    for tier, comp in runs.items():
        out[tier]["kl_scored"] = float(tsne_kl_divergence(
            comp._y, exact._p_idx, exact._p_val, exact._n))
    out["kl_ratio"] = out["grid"]["kl_scored"] / out["exact"]["kl_scored"]
    out["grid"]["grid_sizes"] = grid_sizes(runs["grid"].grid_history)
    out["exact_computation"] = exact      # the sharded phase's P (not printed)
    out["grid_computation"] = runs["grid"]   # its layout (not printed)
    return out


def exact_rows64(data, rows, k: int):
    """The float64 top-k ids of `rows` against all of `data`, on DEV, 128
    rows at a time: the ground truth of the recall phases."""
    import numpy as np
    import torch
    x = torch.as_tensor(data, device=DEV).double()
    sq = (x * x).sum(1)
    out = []
    for r0 in range(0, len(rows), 128):
        q = torch.as_tensor(np.asarray(rows[r0:r0 + 128]), device=DEV).long()
        d = sq[q, None] + sq[None, :] - 2.0 * (x[q] @ x.T)
        out.append(torch.topk(d, k, dim=1, largest=False).indices.cpu())
    return torch.cat(out).numpy()


def graph_invariants(idx, dist, name: str) -> None:
    """A complete kNN graph: the point itself in slot 0, no -1 left,
    finite distances ascending along each row; raises otherwise."""
    import numpy as np
    if not np.array_equal(idx[:, 0], np.arange(idx.shape[0])):
        raise AssertionError(f"{name}: slot 0 is not the point itself")
    if np.any(idx < 0):
        raise AssertionError(f"{name}: {int((idx < 0).sum())} slots are -1")
    if not (np.all(np.isfinite(dist)) and np.all(np.diff(dist, axis=1) >= 0)):
        raise AssertionError(f"{name}: distances not finite and ascending")


def timed_knn(data, k: int, index, **kw):
    """compute_knn on DEV with its seconds, peak memory and IVF layout."""
    import torch
    from sph_tpu_torch.ops.knn import compute_knn
    stats = {}
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    idx, dist = compute_knn(data, k, index, device=DEV, stats=stats, **kw)
    sync()
    stats["seconds"] = time.perf_counter() - t
    stats["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                  if DEV == "cuda" else "not measured")
    return idx, dist, stats


def ivf_recall(n: int = IVF_N, d: int = 100, k: int = 16,
               queries: int = 1024, tiers=IVF_RECALL_GATES) -> dict:
    """benchmarks/bench_recall.py's clustered data at n x d (seed 0), a full
    self-kNN on each approximate tier in `tiers`, and recall@k on `queries`
    rows (default_rng(1)) against float64 distances on DEV."""
    import numpy as np
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_clustered_points
    t = time.perf_counter()
    data = create_clustered_points(n, d, seed=0)
    rows = np.random.default_rng(1).choice(n, queries, replace=False)
    out = {"n": n, "d": d, "k": k, "queries": queries,
           "data_seconds": time.perf_counter() - t}
    t = time.perf_counter()
    truth = exact_rows64(data, rows, k)
    out["truth_seconds"] = time.perf_counter() - t
    for index in tiers:
        idx, dist, stats = timed_knn(data, k, T.KnnIndex(index))
        graph_invariants(idx, dist, f"ivf_recall {index}")
        out[index] = {**stats, "recall": recall_at_k(idx[rows], truth)}
    return out


def large_ivf(graph: dict, runs: int = 2) -> dict:
    """The 1M scene of `graph` through compute_knn on its size tier
    (index_heuristic: HNSW, flat IVF) `runs` times: seconds and peak memory
    of each, recall@k over all rows against the exact graph, two results
    bit-equal."""
    import numpy as np
    from sph_tpu_torch.ops.knn import index_heuristic
    data, exact = graph["data"], graph["idx"]
    index = index_heuristic(data.shape[0])
    results, out = [], {"n": data.shape[0], "index": index.value,
                        "exact_knn_seconds": graph["seconds"]["knn"],
                        "exact_knn_peak_memory_bytes": graph["knn_peak"]}
    for run in range(runs):
        idx, dist, stats = timed_knn(data, exact.shape[1], index)
        graph_invariants(idx, dist, f"large_ivf run {run}")
        results.append((idx, dist))
        out[f"run_{run}"] = stats
    out["bits_equal_across_runs"] = all(
        np.array_equal(i, results[0][0]) and np.array_equal(d, results[0][1])
        for i, d in results[1:])
    out["recall_all_rows"] = recall_at_k(results[0][0], exact)
    return out


def scene_hierarchy(side: int, device: str, k: int = 91):
    """The bench.py:89-136 Pines recipe at side x side x 200 on default
    level settings, as an initialised (not yet computed) ComputeHierarchy:
    create_hyperspectral_scene(seed=7), Scaler.NONE, k neighbours
    symmetrized and connected with knn_index = index_heuristic(side^2),
    50 walks x 10 steps, ImageHierarchySettings() and
    LevelSimilaritiesSettings(ks=[k]) (NEIGH_OVERLAP, exact_knn False).
    Returns it and the data matrix."""
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.knn import index_heuristic
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(side, side, 200, seed=7)
    data = T.scale(T.ImageStack.from_array(img, name="scene_overlap").data,
                   T.Scaler.NONE)
    ch = T.ComputeHierarchy(device=device).init(
        data, side, side, ihs=T.ImageHierarchySettings(),
        lss=T.LevelSimilaritiesSettings(ks=[k]),
        rws=T.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=T.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=T.NearestNeighborsSettings(
            num_nearest_neighbors=k, knn_index=index_heuristic(side * side),
            symmetric_neighbors=True, compute_connect_components=True,
            neighbor_connect_components=True))
    return ch, data


def scene_overlap(tsne_kernels, side: int = SCENE_SIDE, iters: int = 2000,
                  k: int = 91, sampled: int = 2048) -> dict:
    """The user path on default level settings: `scene_hierarchy` through
    ComputeHierarchy(device=DEV), then `iters` t-SNE iterations of level 1
    through ComputeEmbedding.  Kernel counts are set to 0 before the
    hierarchy and read after the t-SNE.  Also: stage 1's recall against the exact kNN (all rows, and the
    `sampled` rows of the JAX record), level 1's component kNN recall
    against the exact knn_neighbor_overlap, P's checks, the KL at
    iterations 0, iters / 2 and iters."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.component_knn import knn_neighbor_overlap
    from sph_tpu_torch.ops.knn import compute_knn, index_heuristic
    from sph_tpu_torch.ops.similarities import build_union_neighborhoods
    seconds = {}
    t = time.perf_counter()
    ch, data = scene_hierarchy(side, DEV, k)
    seconds["data"] = time.perf_counter() - t
    zero_launches(tsne_kernels)
    for name, stage in (("stage1_knn", ch.compute_knn_graph),
                        ("stage2_hierarchy", ch.compute_image_hierarchy),
                        ("stage3_level_similarities",
                         ch.compute_level_similarities)):
        t = time.perf_counter()
        stage()
        sync()
        seconds[name] = time.perf_counter() - t
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    ls = ch.level_similarities
    p1 = ls.get_prob_dist(1)
    kls = {}

    def progress(comp):
        if comp.current_iteration in (0, iters // 2):
            kls[comp.current_iteration] = comp.kl_divergence()

    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    ce = T.ComputeEmbedding(es, device=DEV)
    t = time.perf_counter()
    with env(**{name: None for name in TSNE_SWITCHES}):
        emb = ce.compute_tsne(p1, track_kl=True, progress=progress)
    sync()
    seconds["tsne"] = time.perf_counter() - t
    launches = read_launches(tsne_kernels)
    kls[iters] = float(ce.last_kl)

    t = time.perf_counter()
    exact_idx, _ = compute_knn(data, k, T.KnnIndex.BRUTE_FORCE, device=DEV)
    seconds["exact_knn"] = time.perf_counter() - t
    ivf_idx = ch.knn_stage.knn_graph.indices
    rows = np.sort(np.random.default_rng(1).choice(side * side, sampled,
                                                   replace=False))
    ids, dists = ls.distance_graphs[1]
    graph = ch.knn_stage.connected_graph
    unions = build_union_neighborhoods(
        np.where(graph.mask, graph.indices, -1), h.pixel_components[1],
        levels[1], device=DEV)
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t = time.perf_counter()
    _, exact_d = knn_neighbor_overlap(unions, ids.shape[1])
    seconds["exact_component_knn"] = time.perf_counter() - t
    exact_peak = (torch.cuda.max_memory_allocated() - held
                  if DEV == "cuda" else "not measured")
    return {"n": side * side, "size": [side, side, 200],
            "knn_index": index_heuristic(side * side).value,
            "levels": levels,
            "knn_tiers": ls.knn_tiers, "level_1_k": int(ids.shape[1]),
            "stage1_recall_all_rows": recall_at_k(ivf_idx, exact_idx),
            "stage1_recall_sampled_rows": recall_at_k(ivf_idx[rows],
                                                      exact_idx[rows]),
            "level_1_component_knn_recall": overlap_recall(
                ids, dists, exact_d[:, -1]),
            "exact_component_knn_peak_bytes": exact_peak,
            "p": p_checks(p1, ids, dists, ls.perplexity_on_level[1]),
            "tsne_tier": ce.last_computation.tier, "tsne_iterations": iters,
            "kl_at": {str(i): v for i, v in sorted(kls.items())},
            "launches": launches, "seconds": seconds,
            "embedding_finite": bool(np.all(np.isfinite(emb))),
            "embedding_shape": list(emb.shape)}


def deep_levels_gate(levels, ref_levels, name: str) -> None:
    """Levels 2 and up whose record has at least DEEP_LEVEL_MIN components
    within DEEP_LEVEL_TOLERANCE of the record; raises otherwise."""
    for level in range(2, min(len(levels), len(ref_levels))):
        want = ref_levels[level]
        if want >= DEEP_LEVEL_MIN and (
                abs(levels[level] - want) > DEEP_LEVEL_TOLERANCE * want):
            raise AssertionError(
                f"{name} level {level}: {levels[level]} components, not "
                f"within {DEEP_LEVEL_TOLERANCE:.0%} of the JAX record {want}")


def salinas_settings(P, level_to_compute: int = -1):
    """The salinas_euclid configuration for package P (sph_tpu_torch here;
    the JAX package in scripts/salinas_euclid_reference.py): stage 1 the
    exact kNN (FLAT), k = 31, symmetric and connected (bench_salinas.py:44,
    70-73); stage 2 run_evaluation.py's ImageHierarchySettings
    (sph_tpu/evaluation/run_evaluation.py:150-159) with EUCLID_CENTROID and
    num_geodesic_samples 100, FOUR connectivity, random_seed 1; stage 3
    EUCLID_CENTROID, ks = [31], TSNE normalisation and symmetrisation
    (bench_salinas.py:61-65).  Returns (ihs, lss, rws, nns)."""
    euclid = P.ComponentSim.EUCLID_CENTROID
    ihs = P.ImageHierarchySettings(
        component_sim=euclid, neighbor_connection=P.NeighConnection.FOUR,
        merge_multiple=False, use_percentile=False, max_dist=0.0,
        min_num_comp=1, min_reduction=98.0, num_geodesic_samples=100,
        max_levels=10)
    lss = P.LevelSimilaritiesSettings(
        component_sim=euclid, ks=[SALINAS_K],
        normalize_prob_dist=P.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=P.NormalizationScheme.TSNE,
        level_to_compute=level_to_compute)
    rws = P.RandomWalkSettings(random_seed=1)
    nns = P.NearestNeighborsSettings(
        num_nearest_neighbors=SALINAS_K, knn_index=P.KnnIndex.FLAT,
        symmetric_neighbors=True, compute_connect_components=True,
        neighbor_connect_components=True)
    return ihs, lss, rws, nns


def rgb_geo_settings(P, component_sim=None):
    """The rgb_geo configuration for package P: configs/rgb_bus_geo.json
    through run_evaluation.py's wiring (sph_tpu/evaluation/
    run_evaluation.py:141-180, with the grid's defaults
    of sph_tpu/evaluation/settings.py:50-66 for the walk axes): stage 1 the
    exact L2 kNN (FLAT), nKnns 50 (k = 51 with self), symmetric and
    connected; stage 2 `component_sim` (GEO_CENTROID by default) with
    num_geodesic_samples 100, FOUR connectivity, TSNE-normalised kNN
    distances, min_reduction 98, max_levels 10, random_seed 1; stage 3 the
    same similarity, ks = [51], TSNE normalisation and symmetrisation (as
    salinas_settings).  Returns (ihs, lss, rws, nns)."""
    cs = component_sim or P.ComponentSim.GEO_CENTROID
    ihs = P.ImageHierarchySettings(
        component_sim=cs, neighbor_connection=P.NeighConnection.FOUR,
        merge_multiple=False, use_percentile=False, max_dist=0.0,
        min_num_comp=1, min_reduction=98.0, num_geodesic_samples=100,
        max_levels=10, rw_handling=P.RandomWalkHandling.MERGE_RW_ONLY,
        rw_weight_merge_by_size=True,
        rw_reduction=P.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION,
        norm_knn_distances=P.NormalizationScheme.TSNE)
    lss = P.LevelSimilaritiesSettings(
        component_sim=cs, ks=[RGB_GEO_K], random_walk_pair_sims=True,
        weight_transition_by_size=False,
        normalize_prob_dist=P.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=P.NormalizationScheme.TSNE)
    rws = P.RandomWalkSettings(
        num_random_walks=90, single_walk_length=15,
        importance_weighting=P.ImportanceWeighting.CONSTANT, random_seed=1)
    nns = P.NearestNeighborsSettings(
        num_nearest_neighbors=RGB_GEO_K, knn_index=P.KnnIndex.FLAT,
        knn_metric=P.KnnMetric.L2, symmetric_neighbors=True,
        compute_connect_components=True, neighbor_connect_components=True)
    return ihs, lss, rws, nns


def geo_knn_rows(ls, level: int) -> dict:
    """The ids of RGB_GEO_KNN_ROWS rows (np.random.default_rng(1)) of a
    level's stage-3 kNN."""
    import numpy as np
    ids = ls.distance_graphs[level][0]
    c = ids.shape[0]
    rows = np.sort(np.random.default_rng(1).choice(
        c, min(RGB_GEO_KNN_ROWS, c), replace=False))
    return {"components": int(c), "rows": rows.tolist(),
            "ids": np.asarray(ids)[rows].tolist()}


def sketch_samples(sims, h, level: int, a, b, num_samples: int,
                   seed: int):
    """Each side's sampled pixels [E, S] (-1 padded) of component pairs
    (a, b) of `level`, drawn as sketch_geodesic_pairs draws them:
    ``sample_represented`` of module `sims` over the pairs' components, S
    the largest set capped at `num_samples`, seed + level."""
    import numpy as np
    reps = h.represented_points(level)
    s = min(max(len(r) for r in reps), num_samples)
    comp = np.unique(np.concatenate([a, b]))
    samples = sims.sample_represented(reps, comp, s, seed=seed + level)
    return (samples[np.searchsorted(comp, a)],
            samples[np.searchsorted(comp, b)])


def geo_sketch_pairs(P, ch, level: int = 1) -> dict:
    """The sketch Hausdorff (package P's sketch_hausdorff_pairs) of
    RGB_GEO_SKETCH_PAIRS spatial-neighbour component pairs a < b of `level`
    (np.random.default_rng(2)), with each side's sampled pixels, so that
    another run can query its own sketch with the same pixels."""
    import importlib
    import numpy as np
    sp = importlib.import_module(P.__name__ + ".ops.shortest_path")
    sims = importlib.import_module(P.__name__ + ".ops.similarities")
    gs = importlib.import_module(P.__name__ + ".ops.geo_sketch")
    ih = ch.image_hierarchy
    a, b = neighbour_pairs(ih.hierarchy, level)
    pick = np.sort(np.random.default_rng(2).choice(
        len(a), min(RGB_GEO_SKETCH_PAIRS, len(a)), replace=False))
    a, b = a[pick], b[pick]
    ra, rb = sketch_samples(sims, ih.hierarchy, level, a, b,
                            ih._ihs.num_geodesic_samples, ih._rws.random_seed)
    kw = {"device": DEV} if P.__name__ == "sph_tpu_torch" else {}
    si, sd = sp.get_geo_sketch(ih._graph, **kw)
    return {"level": level, "a": a.tolist(), "b": b.tolist(),
            "rep_a": [r[r >= 0].tolist() for r in ra],
            "rep_b": [r[r >= 0].tolist() for r in rb],
            "sketch_hausdorff": [float(v) for v in
                                 gs.sketch_hausdorff_pairs(si, sd, ra, rb)]}


def neighbour_pairs(h, level: int):
    """Every spatial-neighbour component pair a < b of `level`."""
    import numpy as np
    adj = h.spatial_neighbors_of(level)
    a = np.repeat(np.arange(adj.shape[0]), adj.shape[1])
    b = adj.ravel()
    ok = (b >= 0) & (a < b)
    return a[ok], b[ok]


def geo_record_run(P, cs: str, shape=RGB_GEO_RECORD_SHAPE, replay=None,
                   **kw) -> dict:
    """Stages 1-3 of rgb_geo_settings with similarity `cs` through package
    P's ComputeHierarchy(**kw) on create_hyperspectral_scene(*shape, 3,
    seed=13), Scaler.UNIFORM: the levels, each level's largest set, the
    kNN rows of levels 1 and 2 (where the level has a kNN), the level-1
    sketch pairs, the seconds of each stage.  With `replay` (a record's
    sketch pairs), this run's sketch Hausdorff of the record's sampled
    pixels ("replayed_sketch_hausdorff") in place of its own sketch
    pairs."""
    import importlib
    import numpy as np
    testdata = importlib.import_module(P.__name__ + ".utils.testdata")
    rows, cols = shape
    img = testdata.create_hyperspectral_scene(rows, cols, 3, seed=13)
    data = P.scale(P.ImageStack.from_array(img).data, P.Scaler.UNIFORM)
    ihs, lss, rws, nns = rgb_geo_settings(P, P.ComponentSim(cs))
    ch = P.ComputeHierarchy(**kw).init(data, rows, cols, ihs=ihs, lss=lss,
                                       rws=rws, nns=nns)
    seconds = {}
    for name, stage in (("stage1_knn", ch.compute_knn_graph),
                        ("stage2_hierarchy", ch.compute_image_hierarchy),
                        ("stage3_level_similarities",
                         ch.compute_level_similarities)):
        t = time.perf_counter()
        stage()
        seconds[name] = time.perf_counter() - t
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    ls = ch.level_similarities
    knn = {str(level): geo_knn_rows(ls, level) for level in (1, 2)
           if level < len(levels) and ls.distance_graphs[level] is not None}
    pairs = None
    if replay is None and len(levels) > 1:
        t = time.perf_counter()
        pairs = geo_sketch_pairs(P, ch)
        seconds["sketch_pairs"] = time.perf_counter() - t
    out = {"levels": levels,
           "largest_set_by_level": [
               int(np.bincount(h.pixel_components[lv]).max())
               for lv in range(len(levels))],
           "knn": knn, "sketch_pairs": pairs, "seconds": seconds}
    if replay is not None:
        sp = importlib.import_module(P.__name__ + ".ops.shortest_path")
        gs = importlib.import_module(P.__name__ + ".ops.geo_sketch")
        si, sd = sp.get_geo_sketch(ch.image_hierarchy._graph, **kw)
        rep_a, rep_b = padded_lists(replay["rep_a"], replay["rep_b"])
        out["replayed_sketch_hausdorff"] = [
            float(v) for v in gs.sketch_hausdorff_pairs(si, sd, rep_a,
                                                        rep_b)]
    return out


def padded_lists(*groups) -> list:
    """Each group of id lists -> [len, longest of all groups] int64, -1
    padded (sketch_hausdorff_pairs takes both sides at one width)."""
    import numpy as np
    width = max(len(r) for lists in groups for r in lists)
    out = []
    for lists in groups:
        arr = np.full((len(lists), width), -1, np.int64)
        for i, r in enumerate(lists):
            arr[i, :len(r)] = r
        out.append(arr)
    return out


def geo_log_summary(log) -> list:
    """shortest_path.LOG grouped by call (each geodesic entry point logs
    its name and level first): the field batches, the fields, the sweeps
    per batch (max and mean), the host seconds inside the batches'
    ``converge``, and what the call logged besides (the level-0 unresolved
    pairs and unique sources, the sketch's build and fallback pairs)."""
    import numpy as np
    calls, cur = [], None
    for e in log:
        if e["what"] == "call" or cur is None:
            cur = {"fn": e.get("fn", "other"), "level": e.get("level"),
                   "batches": 0, "fields": 0, "sweeps": []}
            calls.append(cur)
            if e["what"] == "call":
                continue
        if "sweeps" in e:
            cur["batches"] += 1
            cur["seconds"] = cur.get("seconds", 0.0) + e.get("seconds", 0.0)
            cur["fields"] += e["fields"]
            cur["nodes"] = e["nodes"]
            cur["sweeps"].append(e["sweeps"])
        else:
            cur[e["what"]] = {k: v for k, v in e.items() if k != "what"}
    for c in calls:
        sw = c.pop("sweeps")
        c["seconds_in_batches"] = c.pop("seconds", 0.0)
        c["sweeps_max"] = int(max(sw)) if sw else 0
        c["sweeps_mean"] = float(np.mean(sw)) if sw else 0.0
        c["sweeps_total"] = int(sum(sw))
    return calls


def path_hops(pred) -> "np.ndarray":
    """Hop counts of the shortest-path trees of scipy's predecessor rows
    [S, N] (-9999 at sources and unreachable nodes)."""
    import numpy as np
    hops = np.zeros(pred.shape, np.int64)
    has = pred >= 0
    safe = np.where(has, pred, 0)
    while True:
        nxt = np.where(has, np.take_along_axis(hops, safe, 1) + 1, 0)
        if np.array_equal(nxt, hops):
            return hops
        hops = nxt


def geodesic_exactness(graph, sources, fields) -> dict:
    """The port's fields [S, N] from `sources` over a graph (KnnGraph or
    PaddedGraph) against scipy's float64 Dijkstra on the same float32
    weights: unreachable must match, and each reachable value lie within
    hops * 2^-23 of the float64 distance, relative, where hops is the
    float64 path's edge count (each float32 add rounds by at most 2^-24 of
    its partial sum).  Raises otherwise."""
    import numpy as np
    import scipy.sparse as sps
    from scipy.sparse.csgraph import dijkstra
    idx = np.asarray(graph.indices)
    mask = idx >= 0
    n = idx.shape[0]
    rows = np.broadcast_to(np.arange(n)[:, None], idx.shape)
    keep = mask & (idx != rows)
    r, c = rows[keep], idx[keep].astype(np.int64)
    w = np.asarray(graph.distances)[keep].astype(np.float64)
    first = np.lexsort((w, c, r))             # one edge per (r, c): the least
    r, c, w = r[first], c[first], w[first]
    uniq = np.ones(len(r), bool)
    uniq[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    m = sps.csr_matrix((w[uniq], (r[uniq], c[uniq])), shape=(n, n))
    d64, pred = dijkstra(m, directed=True, indices=np.asarray(sources),
                         return_predecessors=True)
    hops = path_hops(pred)
    got = np.asarray(fields, np.float64)
    reach = np.isfinite(d64)
    if not np.array_equal(reach, np.isfinite(got)):
        raise AssertionError(
            f"geodesics: {int((reach != np.isfinite(got)).sum())} nodes "
            "reachable in one of the port and float64 Dijkstra only")
    err = np.abs(got[reach] - d64[reach])
    bound = hops[reach] * 2.0 ** -23 * d64[reach]
    if not np.all(err <= bound):
        worst = int(np.argmax(err - bound))
        raise AssertionError(
            f"geodesics off float64 Dijkstra by {err[worst]} > "
            f"{hops[reach][worst]} hops x 2^-23 x {d64[reach][worst]}")
    ratio = err[bound > 0] / bound[bound > 0]
    return {"sources": len(sources),
            "reachable_fraction": float(reach.mean()),
            "max_hops": int(hops.max()),
            "max_err_over_bound": float(ratio.max()) if ratio.size else 0.0,
            "bit_equal_fraction": float((err == 0).mean())}


def sketch_fidelity(sketch, exact, a) -> dict:
    """The sketch's geodesic Hausdorff against the exact fields' on the
    same component pairs (sources `a`): the Spearman rank correlation over
    the pairs where both are finite (below FLOAT_MAX), and the share of
    sources (with at least two such pairs) whose nearest neighbour is the
    same under both."""
    import numpy as np
    from scipy.stats import spearmanr
    fmax = np.finfo(np.float32).max
    sketch, exact, a = map(np.asarray, (sketch, exact, a))
    fin = (sketch < fmax) & (exact < fmax)
    rho = float(spearmanr(sketch[fin], exact[fin])[0]) if fin.sum() > 1 \
        else float("nan")
    agree = total = 0
    for s in np.unique(a):
        m = (a == s) & fin
        if m.sum() < 2:
            continue
        total += 1
        agree += int(np.argmin(sketch[m]) == np.argmin(exact[m]))
    return {"pairs": int(len(a)), "finite_pairs": int(fin.sum()),
            "finite_fraction": float(fin.mean()), "spearman": rho,
            "argmin_sources": total,
            "argmin_agreement": agree / total if total else float("nan")}


def sketch_fidelity_gate(fid: dict) -> None:
    """Spearman >= SKETCH_SPEARMAN_MIN and argmin agreement >=
    SKETCH_ARGMIN_MIN (NaN, where nothing could be compared, fails)."""
    if not (fid["spearman"] >= SKETCH_SPEARMAN_MIN
            and fid["argmin_agreement"] >= SKETCH_ARGMIN_MIN):
        raise AssertionError(f"sketch fidelity below the gates: {fid}")


def met_sketch_fidelity(raw, path, exact, a, b) -> dict:
    """The sketch where it meets (raw sketch_hausdorff_pairs values that
    are finite) against the exact fields' Hausdorff of the same pairs
    (a, b): how many met; whether the path's values (sketch_geodesic_pairs)
    equal the raw ones there bit for bit, that is, no fallback touched
    them; the met pairs whose sketch lies below exact x (1 -
    SKETCH_PATH_EDGES x 2^-23), which none may (a met value is the float32
    length of a real path of at most 16 edges, summed in at most 4 rounds,
    and the exact field is at most that path's left-to-right float32 sum,
    at most 15 roundings above it; Hausdorff's max and min keep the bound);
    the Spearman rank correlation; the argmin agreement over the
    components that have at least two met pairs, on either side."""
    import numpy as np
    from scipy.stats import spearmanr
    raw, path, exact, a, b = map(np.asarray, (raw, path, exact, a, b))
    met = np.isfinite(raw)
    r = raw[met].astype(np.float64)
    x = exact[met].astype(np.float64)
    am, bm = a[met], b[met]
    low = r < x * (1 - SKETCH_PATH_EDGES * 2.0 ** -23)
    pos = x > 0
    rho = float(spearmanr(r, x)[0]) if met.sum() > 1 else float("nan")
    agree = total = 0
    for c in np.unique(np.concatenate([am, bm])):
        m = (am == c) | (bm == c)
        if m.sum() < 2:
            continue
        total += 1
        agree += int(np.argmin(r[m]) == np.argmin(x[m]))
    return {"pairs": int(len(raw)), "met_pairs": int(met.sum()),
            "path_equals_sketch": bool(np.array_equal(path[met], raw[met])),
            "below_bound": int(low.sum()),
            "min_ratio": float((r[pos] / x[pos]).min()) if pos.any()
            else float("nan"),
            "spearman": rho, "argmin_sources": total,
            "argmin_agreement": agree / total if total else float("nan")}


def met_sketch_gate(met: dict) -> None:
    """At least SKETCH_MET_MIN met pairs, the path's values there the
    sketch's, none below the bound, Spearman >= SKETCH_SPEARMAN_MIN and,
    where components have two met pairs or more, argmin agreement >=
    SKETCH_ARGMIN_MIN."""
    if not met["met_pairs"] >= SKETCH_MET_MIN:
        raise AssertionError(f"the sketch met on {met['met_pairs']} pairs, "
                             f"fewer than {SKETCH_MET_MIN}")
    if not met["path_equals_sketch"]:
        raise AssertionError("sketch_geodesic_pairs changed a met pair's "
                             "sketch value")
    if met["below_bound"]:
        raise AssertionError(f"{met['below_bound']} met sketch values below "
                             "the exact geodesic Hausdorff's bound")
    if not (met["spearman"] >= SKETCH_SPEARMAN_MIN and (
            met["argmin_sources"] == 0
            or met["argmin_agreement"] >= SKETCH_ARGMIN_MIN)):
        raise AssertionError(f"met sketch fidelity below the gates: {met}")


def fidelity_pairs(h, level: int, count: int, seed: int = 7):
    """Spatial-neighbour pairs (a, b) of `level` for the sketch-fidelity
    check: sources in a random order (default_rng(seed)), each with all
    its neighbours, until `count` pairs."""
    import numpy as np
    adj = h.spatial_neighbors_of(level)
    a, b = [], []
    for s in np.random.default_rng(seed).permutation(adj.shape[0]):
        nb = adj[s][adj[s] >= 0]
        a.extend([s] * len(nb))
        b.extend(nb.tolist())
        if len(a) >= count:
            break
    return np.asarray(a[:count], np.int64), np.asarray(b[:count], np.int64)


def hausdorff_kth(data, rep, rows, k: int):
    """The exact Hausdorff kNN's k-th distance of each of `rows` over every
    component (self at 0 included), from the port's pair metric on DEV;
    rep [C, S] holds the components' sampled points."""
    import numpy as np
    from sph_tpu_torch.ops.similarities import component_hausdorff
    c = rep.shape[0]
    rows = np.asarray(rows, np.int64)
    d = component_hausdorff(data, rep, np.repeat(rows, c),
                            np.tile(np.arange(c), len(rows)), device=DEV)
    d = d.reshape(len(rows), c)
    d[np.arange(len(rows)), rows] = 0.0
    return np.partition(d, k - 1, axis=1)[:, k - 1]


def hausdorff_exactness(data, rep, ids, dists, rows) -> dict:
    """An exact Hausdorff kNN's `rows` against float64 on DEV; raises unless
    each row differs from the float64 top k only by swapping a component e
    in for a component m with h(e)^2 - h(m)^2 <= b(e) + b(m), and each
    squared distance lies within b of its float64 value.  b is the float32
    band sqrt(D) eps (|x|^2 + |y|^2) of the expansion (knn_exactness) at the
    largest squared norms among the two sets' samples, plus the float32
    root's own rounding."""
    import numpy as np
    import torch
    eps = float(np.finfo(np.float32).eps)
    x = torch.as_tensor(np.asarray(data, np.float32), device=DEV).double()
    rep_t = torch.as_tensor(np.asarray(rep, np.int64), device=DEV)
    ok = rep_t >= 0
    pts = x[rep_t.clamp(min=0)]                         # [C, S, D]
    c, s, d = pts.shape
    sq = (pts * pts).sum(2)
    top = torch.where(ok, sq, 0.0).amax(1)              # [C]
    sq = torch.where(ok, sq, torch.inf)
    flat = pts.reshape(c * s, d)
    root_d = float(np.sqrt(d))
    differ, worst_swap, worst_dist = 0, 0.0, 0.0
    k = ids.shape[1]
    for r in np.asarray(rows, np.int64):
        d2 = (sq[r][:, None] + sq.reshape(1, -1)
              - 2.0 * (pts[r] @ flat.T)).view(s, c, s)
        h1 = torch.where(ok[r][:, None], d2.amin(2), -torch.inf).amax(0)
        h2 = torch.where(ok, d2.amin(0), -torch.inf).amax(1)
        h = torch.maximum(h1, h2).clamp(min=0.0)
        h[r] = 0.0
        band = root_d * eps * (top[r] + top) + 2.0 * eps * h
        got = torch.as_tensor(np.asarray(ids[r], np.int64), device=DEV)
        got_d2 = torch.as_tensor(np.asarray(dists[r], np.float64),
                                 device=DEV) ** 2
        worst_dist = max(worst_dist, float(
            ((got_d2 - h[got]).abs() / band[got]).max()))
        want = torch.sort(h, stable=True).indices[:k]
        extra = sorted(set(got.tolist()) - set(want.tolist()))
        missed = sorted(set(want.tolist()) - set(got.tolist()))
        if not extra:
            continue
        differ += 1
        e = torch.tensor(extra, device=DEV)
        m = torch.tensor(missed, device=DEV)
        swap = float(((h[e][:, None] - h[m][None, :])
                      / (band[e][:, None] + band[m][None, :])).max())
        worst_swap = max(worst_swap, swap)
        if swap > 1.0:
            raise AssertionError(
                f"Hausdorff kNN row {int(r)}: neighbours differ from the "
                f"float64 top-{k} by {swap} x the float32 band")
    if worst_dist > 1.0:
        raise AssertionError(f"Hausdorff kNN distances off float64 by "
                             f"{worst_dist} x the float32 band")
    return {"rows": len(rows), "rows_differing": differ,
            "max_swap_over_band": worst_swap,
            "max_dist2_err_over_band": worst_dist}


def salinas_euclid(tsne_kernels, shape=SALINAS_SHAPE, iters: int = 2000,
                   tsne_levels=SALINAS_TSNE_LEVELS, umap_epochs: int = 500,
                   sampled: int = SALINAS_SAMPLED_ROWS,
                   exact_rows: int = SALINAS_EXACT_ROWS) -> dict:
    """EUCLID_CENTROID in both stages on the Salinas-shaped scene
    (create_hyperspectral_scene(*shape, seed=13), Scaler.NONE,
    ``salinas_settings``) through ComputeHierarchy(device=DEV); then `iters`
    t-SNE iterations of each level in `tsne_levels`, each after the first
    starting from average_position_of_children of the level below scaled
    to a largest coordinate of 1 (run_evaluation.py's
    init_level_emb_with_previous), and UMAP
    of level 1 for `umap_epochs` epochs.  Kernel counts are set to 0 before
    the hierarchy and read after each embedding.  Also: seconds and peak
    memory by stage and part (the SPH_PHASE_TIMERS phases), level 1's
    component kNN recall on `sampled` rows against the exact Hausdorff over
    all components, level 2's exact kNN against float64 on `exact_rows`
    rows, P's checks on the embedded levels."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    from sph_tpu_torch.utils.timer import phase_totals
    rows, cols, bands = shape
    seconds, parts, peaks = {}, {}, {}
    t = time.perf_counter()
    img = create_hyperspectral_scene(rows, cols, bands, seed=13)
    data = T.scale(T.ImageStack.from_array(img, name="salinas_euclid").data,
                   T.Scaler.NONE)
    seconds["data"] = time.perf_counter() - t
    ihs, lss, rws, nns = salinas_settings(T)
    ch = T.ComputeHierarchy(device=DEV).init(data, rows, cols, ihs=ihs,
                                             lss=lss, rws=rws, nns=nns)
    zero_launches(tsne_kernels)
    with env(SPH_PHASE_TIMERS="1"):
        phase_totals()
        for name, stage in (("stage1_knn", ch.compute_knn_graph),
                            ("stage2_hierarchy", ch.compute_image_hierarchy),
                            ("stage3_level_similarities",
                             ch.compute_level_similarities)):
            if DEV == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            stage()
            sync()
            seconds[name] = time.perf_counter() - t
            parts[name] = phase_totals()
            peaks[name] = (torch.cuda.max_memory_allocated()
                           if DEV == "cuda" else "not measured")
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    ls = ch.level_similarities

    tsne, prev = {}, None
    for level in tsne_levels:
        if level >= len(levels):
            break
        n = levels[level]
        es = T.ComputeEmbeddingSettings()
        es.tsne.num_iterations = iters
        ce = T.ComputeEmbedding(es, device=DEV)
        if prev is not None:     # run_evaluation.py:253-261
            ce.init_embedding(n, T.scale_embedding_to_one(
                T.average_position_of_children(prev, h.parents[level - 1],
                                               n)))
        kls = {}

        def progress(comp, kls=kls):
            if comp.current_iteration == 0:
                kls[0] = comp.kl_divergence()

        before = read_launches(tsne_kernels)
        t = time.perf_counter()
        with env(**{name: None for name in TSNE_SWITCHES}):
            emb = ce.compute_tsne(ls.get_prob_dist(level), track_kl=True,
                                  progress=progress)
        sync()
        wall = time.perf_counter() - t
        kls[iters] = float(ce.last_kl)
        after = read_launches(tsne_kernels)
        comp = ce.last_computation
        tsne[level] = {
            "n": n, "npad": int(comp._y.shape[0]), "tier": comp.tier,
            "init": ("random disk" if prev is None
                     else "average_position_of_children"),
            "seconds": wall, "iterations_seconds": ce.seconds["iterations"],
            "iters_per_s": iters / ce.seconds["iterations"],
            "kl_at": {str(i): v for i, v in sorted(kls.items())},
            "launches": {kk: after[kk] - before[kk] for kk in after},
            "embedding_finite": bool(np.all(np.isfinite(emb))),
            "embedding_shape": list(emb.shape)}
        prev = emb
    before = read_launches(tsne_kernels)
    umap = pines_umap(ch, data, umap_epochs)
    after = read_launches(tsne_kernels)
    umap_out = {kk: v for kk, v in umap.items() if kk != "emb"}
    umap_out["embedding_finite"] = bool(np.all(np.isfinite(umap["emb"])))
    umap_out["launches"] = {kk: after[kk] - before[kk] for kk in after}
    launches = read_launches(tsne_kernels)

    ids1, d1 = ls.distance_graphs[1]
    rep1 = ls._rep_samples(1)
    pick = np.sort(np.random.default_rng(1).choice(
        levels[1], min(sampled, levels[1]), replace=False))
    t = time.perf_counter()
    kth = hausdorff_kth(data, rep1, pick, ids1.shape[1])
    seconds["exact_kth_sampled_rows"] = time.perf_counter() - t
    exact2 = None
    if len(levels) > 2 and ls.knn_tiers[2] == "exact":
        pick2 = np.sort(np.random.default_rng(2).choice(
            levels[2], min(exact_rows, levels[2]), replace=False))
        t = time.perf_counter()
        exact2 = hausdorff_exactness(data, ls._rep_samples(2),
                                     *ls.distance_graphs[2], pick2)
        seconds["level_2_exactness"] = time.perf_counter() - t
    p = {level: p_checks(ls.get_prob_dist(level),
                         *ls.distance_graphs[level],
                         ls.perplexity_on_level[level])
         for level in tsne}
    return {"n": rows * cols, "size": list(shape), "levels": levels,
            "largest_set_by_level": [
                int(np.bincount(h.pixel_components[lv]).max())
                for lv in range(len(levels))],
            "knn_tiers": ls.knn_tiers, "level_1_k": int(ids1.shape[1]),
            "level_1_samples": int(rep1.shape[1]),
            "level_1_component_knn_recall": overlap_recall(
                ids1[pick], d1[pick], kth),
            "level_2_exactness": exact2, "p": p, "tsne": tsne,
            "umap": umap_out, "launches": launches, "seconds": seconds,
            "seconds_by_part": parts, "peak_memory_bytes": peaks}


def rgb_geo(tsne_kernels, side: int = RGB_GEO_SIDE, iters: int = 2000,
            tsne_levels=(1, 2, 3), sources: int = 64,
            fidelity: int = RGB_GEO_SKETCH_PAIRS) -> dict:
    """GEO_CENTROID in both stages on create_hyperspectral_scene(side,
    side, 3, seed=13), Scaler.UNIFORM, ``rgb_geo_settings``, through
    ComputeHierarchy(device=DEV); then `iters` t-SNE iterations of each of
    `tsne_levels` from a random layout (the config's initEmbeddingDataLevel
    RANDOM).  Kernel counts are set to 0 before the hierarchy and read after
    each embedding.  Also: seconds, peak memory and the geodesic log
    (``geo_log_summary``) of each stage; the port's fields from `sources`
    sampled pixels against float64 Dijkstra (``geodesic_exactness``); the
    path's sketch values against the exact fields on `fidelity` level-1
    pairs (``sketch_fidelity``), and the sketch alone on every level-1 pair
    where it meets (``met_sketch_run``); P's checks on the embedded
    levels."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops import shortest_path as sp
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    from sph_tpu_torch.utils.timer import phase_totals
    seconds, parts, peaks, geo = {}, {}, {}, {}
    t0 = time.perf_counter()
    img = create_hyperspectral_scene(side, side, 3, seed=13)
    data = T.scale(T.ImageStack.from_array(img, name="rgb_geo").data,
                   T.Scaler.UNIFORM)
    seconds["data"] = time.perf_counter() - t0
    ihs, lss, rws, nns = rgb_geo_settings(T)
    ch = T.ComputeHierarchy(device=DEV).init(data, side, side, ihs=ihs,
                                             lss=lss, rws=rws, nns=nns)
    zero_launches(tsne_kernels)
    relax_launches = {}
    with env(SPH_PHASE_TIMERS="1"):
        phase_totals()
        for name, stage in (("stage1_knn", ch.compute_knn_graph),
                            ("stage2_hierarchy", ch.compute_image_hierarchy),
                            ("stage3_level_similarities",
                             ch.compute_level_similarities)):
            if DEV == "cuda":
                torch.cuda.reset_peak_memory_stats()
            sp.LOG.clear()
            sp.relax.launches = 0
            t = time.perf_counter()
            stage()
            sync()
            seconds[name] = time.perf_counter() - t
            relax_launches[name] = sp.relax.launches
            parts[name] = phase_totals()
            geo[name] = geo_log_summary(sp.LOG)
            peaks[name] = (torch.cuda.max_memory_allocated()
                           if DEV == "cuda" else "not measured")
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    ls = ch.level_similarities

    tsne = {}
    for level in tsne_levels:
        if level >= len(levels):
            break
        es = T.ComputeEmbeddingSettings()
        es.tsne.num_iterations = iters
        ce = T.ComputeEmbedding(es, device=DEV)
        kls = {}

        def progress(comp, kls=kls):
            if comp.current_iteration == 0:
                kls[0] = comp.kl_divergence()

        before = read_launches(tsne_kernels)
        t = time.perf_counter()
        with env(**{name: None for name in TSNE_SWITCHES}):
            emb = ce.compute_tsne(ls.get_prob_dist(level), track_kl=True,
                                  progress=progress)
        sync()
        wall = time.perf_counter() - t
        kls[iters] = float(ce.last_kl)
        after = read_launches(tsne_kernels)
        comp = ce.last_computation
        tsne[level] = {
            "n": levels[level], "npad": int(comp._y.shape[0]),
            "tier": comp.tier, "init": "random", "seconds": wall,
            "iterations_seconds": ce.seconds["iterations"],
            "kl_at": {str(i): v for i, v in sorted(kls.items())},
            "launches": {kk: after[kk] - before[kk] for kk in after},
            "embedding_finite": bool(np.all(np.isfinite(emb))),
            "embedding_shape": list(emb.shape)}
    launches = read_launches(tsne_kernels)
    seconds["path"] = time.perf_counter() - t0

    graph = ch.image_hierarchy._graph
    src = np.sort(np.random.default_rng(3).choice(levels[0], sources,
                                                  replace=False))
    t = time.perf_counter()
    fields = sp.shortest_path_fields(graph, src, device=DEV)
    seconds["exact_fields"] = time.perf_counter() - t
    t = time.perf_counter()
    exact = geodesic_exactness(graph, src, fields)
    seconds["dijkstra_check"] = time.perf_counter() - t

    a, b = fidelity_pairs(h, 1, fidelity)
    kw = dict(num_samples=ihs.num_geodesic_samples,
              component_labels=ch.image_hierarchy.component_labels,
              seed=rws.random_seed, device=DEV)
    sp.LOG.clear()
    t = time.perf_counter()
    sk = sp.sketch_geodesic_pairs(graph, h, data, 1, a, b, **kw)
    ex = sp.geodesic_component_distances(graph, data, h, 1, a, b, **kw)
    seconds["sketch_fidelity"] = time.perf_counter() - t
    fid = sketch_fidelity(sk, ex, a)
    fid["fallback_pairs"] = next((e["fallback_pairs"] for e in sp.LOG
                                  if e["what"] == "sketch_pairs"), None)
    # the sketch alone: every level-1 neighbour pair where it meets
    t = time.perf_counter()
    fid["met"] = met_sketch_run(graph, data, h, ihs, rws, kw)
    seconds["met_sketch_fidelity"] = time.perf_counter() - t
    p = {level: p_checks(ls.get_prob_dist(level),
                         *ls.distance_graphs[level],
                         ls.perplexity_on_level[level])
         for level in tsne}
    return {"n": side * side, "size": [side, side, 3], "levels": levels,
            "largest_set_by_level": [
                int(np.bincount(h.pixel_components[lv]).max())
                for lv in range(len(levels))],
            "knn_tiers": ls.knn_tiers,
            "contract_threshold": sp.CONTRACT_THRESHOLD,
            "geodesic_log": geo, "exact_geodesics": exact,
            "sketch_fidelity": fid, "p": p, "tsne": tsne,
            "launches": launches, "relax_launches": relax_launches,
            "seconds": seconds, "seconds_by_part": parts,
            "peak_memory_bytes": peaks,
            # for the relax checks after the phase (not printed)
            "objects": {"graph": graph, "hierarchy": h, "data": data,
                        "num_samples": ihs.num_geodesic_samples,
                        "seed": rws.random_seed}}


def met_sketch_run(graph, data, h, ihs, rws, kw: dict) -> dict:
    """met_sketch_fidelity on the level-1 spatial-neighbour pairs where the
    port's sketch meets (its raw sketch_hausdorff_pairs finite), against
    geodesic_component_distances of those pairs; `kw` the two functions'
    sampling and device keywords."""
    import numpy as np
    from sph_tpu_torch.ops import geo_sketch as gs
    from sph_tpu_torch.ops import shortest_path as sp
    from sph_tpu_torch.ops import similarities as sims
    a, b = neighbour_pairs(h, 1)
    si, sd = sp.get_geo_sketch(graph, device=DEV)

    def raw(a, b):
        ra, rb = sketch_samples(sims, h, 1, a, b, ihs.num_geodesic_samples,
                                rws.random_seed)
        return gs.sketch_hausdorff_pairs(si, sd, ra, rb)

    met = np.isfinite(raw(a, b))
    out = {"neighbour_pairs": int(len(a)), "met_pairs": int(met.sum())}
    if out["met_pairs"]:
        am, bm = a[met], b[met]
        out.update(met_sketch_fidelity(
            raw(am, bm), sp.sketch_geodesic_pairs(graph, h, data, 1, am, bm,
                                                  **kw),
            sp.geodesic_component_distances(graph, data, h, 1, am, bm, **kw),
            am, bm))
    return out


def rgb_geo_gates(run: dict, iters: int) -> None:
    """rgb_geo's gates; raises on the first that fails (the Dijkstra gate
    raises inside geodesic_exactness)."""
    import numpy as np
    levels = run["levels"]
    if len(levels) < 4 or any(x <= y for x, y in zip(levels, levels[1:])):
        raise AssertionError(f"rgb_geo levels not strictly falling over at "
                             f"least 4 levels: {levels}")
    if not levels[1] > run["contract_threshold"] or (
            run["knn_tiers"][1] != "contracted"):
        raise AssertionError("rgb_geo level 1 did not take the sketch and "
                             f"the contracted graph: {run['knn_tiers']}")
    sketch_fidelity_gate(run["sketch_fidelity"])
    met_sketch_gate(run["sketch_fidelity"]["met"])
    if len(run["tsne"]) != 3:
        raise AssertionError("rgb_geo did not embed levels 1-3")
    for level, t in run["tsne"].items():
        kl = t["kl_at"]
        if not (np.all(np.isfinite(list(kl.values())))
                and kl[str(iters)] < kl["0"]):
            raise AssertionError(f"rgb_geo level {level}: KL not finite "
                                 f"and falling: {kl}")
        if not t["embedding_finite"]:
            raise AssertionError(f"rgb_geo level {level}: the embedding is "
                                 "not finite")
        if t["tier"] != "dense":
            raise AssertionError(f"rgb_geo level {level} took the "
                                 f"{t['tier']} t-SNE tier")
        if t["launches"]["tsne_repulsion"] < 1:
            raise AssertionError(f"rgb_geo level {level}: the KL's Z did "
                                 "not come from tsne_repulsion")
    if run["launches"]["tsne_forces_dense"] != 3 * iters:
        raise AssertionError(
            f"rgb_geo: tsne_forces_dense launched "
            f"{run['launches']['tsne_forces_dense']} times, not 3 x {iters}")
    relax_launch_gate(run)


def relax_launch_gate(run: dict) -> None:
    """bellman_ford_relax launched once a sweep in each stage (the sweeps
    that shortest_path.LOG's field batches record), and in stages 2-3 at
    least once."""
    for name, calls in run["geodesic_log"].items():
        sweeps = sum(c["sweeps_total"] for c in calls)
        if run["relax_launches"][name] != sweeps:
            raise AssertionError(
                f"rgb_geo {name}: bellman_ford_relax launched "
                f"{run['relax_launches'][name]} times for {sweeps} sweeps")
    if not (run["relax_launches"]["stage2_hierarchy"]
            and run["relax_launches"]["stage3_level_similarities"]):
        raise AssertionError("rgb_geo: bellman_ford_relax was not launched "
                             f"in stages 2 and 3: {run['relax_launches']}")


def relax_bound(n: int, edges: int, f: int) -> dict:
    """bellman_ford_relax: d read once and d' written once ((N + 1) F 4
    bytes each), each in-edge's id and weight once (8 bytes), the frontier
    (4 F); one add and one min a candidate, E F of them.  Beside it the
    gathered bytes, E F 4: each in-edge reads its source's row."""
    nbytes = 2 * (n + 1) * f * 4 + 8 * edges + 4 * f
    return {**bound(nbytes, 2 * edges * f), "bytes": nbytes,
            "gathered_bytes": 4 * edges * f}


def relax_start(g, f: int, seed: int, sweeps: int = RELAX_START_SWEEPS):
    """[N + 1, f] fields from f single sources drawn with `seed`, relaxed
    `sweeps` sweeps by the twin, so that many nodes still change."""
    import numpy as np
    from sph_tpu_torch.ops import shortest_path as sp
    src = np.random.default_rng(seed).choice(g.n, f, replace=g.n < f)
    d = g.init(src[:, None])
    for _ in range(sweeps):
        d, _ = sp.relax_reference(d, g)
    return d


def relax_compare(g, d) -> dict:
    """The wrapper (the kernel on the card) and the twin on the same d: d'
    and the frontier equal, the largest difference, what the sweep
    lowered."""
    import torch
    from sph_tpu_torch.ops import shortest_path as sp
    got, front = sp.relax(d, g)
    want, want_front = sp.relax_reference(d, g)
    err = torch.where(got == want, 0.0, (got - want).abs())
    return {"n": g.n, "edges": int(g.csr_src.numel()), "fields": d.shape[1],
            "d_equal": bool(torch.equal(got, want)),
            "frontier_equal": bool(torch.equal(front, want_front)),
            "max_abs_err": float(err.max()),
            "lowered_values": int((want < d).sum()),
            "lowered_fields": int(torch.isfinite(want_front).sum())}


def relax_gate(c: dict, name: str) -> None:
    if not (c["d_equal"] and c["frontier_equal"]):
        raise AssertionError(f"bellman_ford_relax at {name}: the kernel "
                             f"differs from its twin: {c}")
    if not c["lowered_values"]:
        raise AssertionError(f"bellman_ford_relax at {name}: the start "
                             "lowered no value")


def check_relax_kernel(g, d, name: str, calls: int = RELAX_CALLS) -> dict:
    """relax_compare and its gate, then on the card ms a call of the
    wrapper (kernel, its output and the frontier's +inf fill) and of the
    twin from CUDA events, warm: the same d every call, so the table is as
    warm in L2 as 50 MB allows."""
    from sph_tpu_torch.ops import shortest_path as sp
    c = relax_compare(g, d)
    relax_gate(c, name)
    c["path_shape"] = name
    c.update(relax_bound(g.n, c["edges"], c["fields"]))
    if DEV == "cuda":
        c["ms"] = cuda_ms(lambda: sp.relax(d, g), calls, warmup=3)
        c["plain_ms"] = cuda_ms(lambda: sp.relax_reference(d, g), 3,
                                warmup=1)
        c["gathered_tb_per_s"] = (c["gathered_bytes"] / (c["ms"] * 1e-3)
                                  / 1e12)
    c["l2"] = ("warm: one d for every call; the table is "
               f"{(g.n + 1) * c['fields'] * 4 / 1e6:.1f} MB, L2 50 MB")
    c["library_ms"] = None
    return c


@contextlib.contextmanager
def twin_relax():
    """shortest_path's sweeps on the twins for the block, whatever the
    tensors' device: ``relax`` on ``relax_reference``, ``relax_delta`` (a
    card's batches) on ``relax_delta_reference``."""
    from sph_tpu_torch.ops import shortest_path as sp
    kept = sp.relax, sp.relax_delta
    sp.relax, sp.relax_delta = sp.relax_reference, sp.relax_delta_reference
    try:
        yield
    finally:
        sp.relax, sp.relax_delta = kept


def both_ways(call) -> tuple:
    """`call()`, a geodesic op over field batches, through the wrapper and
    with shortest_path's sweeps on the twins: each way's seconds, the
    LOG's sweeps and the launches; whether the values are equal.  Returns
    (that dict, the wrapper's values as numpy)."""
    import numpy as np
    from sph_tpu_torch.ops import shortest_path as sp
    out, runs = {}, {}
    for how in ("kernel", "twin"):
        sp.LOG.clear()
        before = sp.relax.launches
        t = time.perf_counter()
        with (twin_relax() if how == "twin" else contextlib.nullcontext()):
            vals = call()
        sync()
        out[f"seconds_{how}"] = time.perf_counter() - t
        out[f"sweeps_{how}"] = [e["sweeps"] for e in sp.LOG if "sweeps" in e]
        out[f"launches_{how}"] = sp.relax.launches - before
        runs[how] = np.asarray(vals.cpu() if hasattr(vals, "cpu") else vals)
    out["values_equal"] = bool(np.array_equal(runs["kernel"], runs["twin"]))
    return out, runs["kernel"]


def pair_batch_inputs(g, graph, a, b, batch: int = RELAX_FIELDS) -> tuple:
    """The first field batch of geodesic_component_distances' level-0 pair
    values for pairs (a, b) over `graph`: (the arguments of
    _pair_values_batched for it, its field samples [F, 1], its evaluated
    (rows, fields) as _fields_pair_values gives them to converge, what it
    holds)."""
    import torch
    from sph_tpu_torch.ops import shortest_path as sp
    idx, dist, mask = sp._graph_arrays(graph)
    _, todo, srcs, field_pos, eval_nodes = sp.level0_pairs(idx, dist, mask,
                                                           a, b)
    sel = field_pos < batch
    args = (g, srcs[:batch], field_pos[sel], eval_nodes[sel], batch)
    evaluate = (g.rows(torch.as_tensor(eval_nodes[sel], device=g.device)),
                torch.as_tensor(field_pos[sel], device=g.device))
    meta = {"unresolved_pairs": int(todo.size), "fields": len(args[1]),
            "lookups": int(sel.sum())}
    return args, srcs[:batch, None], evaluate, meta


def pair_batch_both_ways(g, graph, a, b,
                         batch: int = RELAX_FIELDS) -> dict:
    """The first field batch of geodesic_component_distances' level-0 pair
    values for pairs (a, b) over `graph`, once through the wrapper (on the
    card ``converge``'s delta sweeps, the kernel) and once on the twins:
    the values, the sweeps and the launches."""
    import numpy as np
    from sph_tpu_torch.ops import shortest_path as sp
    args, _, _, meta = pair_batch_inputs(g, graph, a, b, batch)
    out, vals = both_ways(lambda: sp._pair_values_batched(*args))
    out.update(meta)
    out["finite_values"] = int(np.isfinite(vals).sum())
    return out


def pair_batch_gate(r: dict, name: str = "level-0 pair batch") -> None:
    if not r["values_equal"]:
        raise AssertionError(f"{name}: the kernel's values differ from the "
                             "twin's")
    if r["sweeps_kernel"] != r["sweeps_twin"]:
        raise AssertionError(f"{name}: sweeps {r['sweeps_kernel']} on the "
                             f"kernel, {r['sweeps_twin']} on the twin")
    if not (r["launches_kernel"] == sum(r["sweeps_kernel"]) > 0
            and r["launches_twin"] == 0):
        raise AssertionError(
            f"{name}: bellman_ford_relax launched {r['launches_kernel']} "
            f"and {r['launches_twin']} times for {r['sweeps_kernel']} "
            "sweeps")


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def sector_popcounts(words):
    """Set bits of each int32 word of `words`, int64, same shape."""
    import torch
    x = words.to(torch.int64) & 0xFFFFFFFF
    return ((x[..., None] >> torch.arange(32, device=x.device)) & 1).sum(-1)


def delta_sweep_sectors(g, prev, new) -> tuple:
    """(gathered, written): the sectors a delta sweep whose sweep before
    changed `prev` and which changed `new` ([chunks, N + 1] words) gathers
    (each live in-edge's source sectors marked in prev) and rewrites (each
    node's sectors marked in either)."""
    gathered = int(sector_popcounts(prev)[:, g.csr_src.long()].sum())
    written = int(sector_popcounts(prev | new)[:, :g.n].sum())
    return gathered, written


def relax_delta_bound(n: int, edges: int, f: int, sweeps: int,
                      gathered_sectors: int, written_sectors: int) -> dict:
    """A field batch's delta sweeps (bellman_ford_relax's batch path),
    summed over its sweeps: what any implementation must move, each sweep
    reading the CSR's ids (4 E B) and the sweep before's words (4 (N + 1)
    B a chunk of 256 fields) and writing its own words (the same), each
    written sector once (32 B) and the frontier (4 F B); and one add and
    one min a field of each gathered sector (8 fields).  The gathered
    sectors' bytes (32 each, mostly from L2) stand beside it, not in it."""
    chunks = -(-f // 256)
    nbytes = (sweeps * (4 * edges + 8 * (n + 1) * chunks + 4 * f)
              + 32 * written_sectors)
    return {**bound(nbytes, 2 * 8 * gathered_sectors), "bytes": nbytes,
            "gathered_bytes": 32 * gathered_sectors}


def delta_lockstep(g, d0, evaluate, sweeps: int) -> dict:
    """`sweeps` sweeps of one field batch from d0, four ways on the same
    start: the delta sweeps of a RelaxBatch through ``relax_delta`` (the
    kernel on the card) and through ``relax_delta_reference``, the full
    twin ``relax_reference`` and the stateless ``relax`` (the kernel's
    full sweep on the card); each sweep's fields, frontier, stop word and
    sector words compared, and the first sweep whose stop test holds.
    Also each sweep's gathered and written sectors
    (``delta_sweep_sectors``) as shares of a full sweep's."""
    from sph_tpu_torch.ops import shortest_path as sp
    f = d0.shape[1]
    kern = sp.RelaxBatch(g, d0.clone(), evaluate)
    twin = sp.RelaxBatch(g, d0.clone(), evaluate)
    d, full = d0.clone(), d0.clone()
    edges, sectors = int(g.csr_src.numel()), -(-f // 8)
    out = {"n": g.n, "edges": edges, "fields": f, "sweeps": sweeps,
           "evaluated": 0 if evaluate is None else int(evaluate[0].numel()),
           "sweeps_equal": 0, "first_unequal": None, "stopped_at": None,
           "gathered_sectors": 0, "written_sectors": 0,
           "gathered_share": [], "written_share": []}
    for t in range(sweeps):
        sp.relax_delta(kern)
        sp.relax_delta_reference(twin)
        want, want_front = sp.relax_reference(d, g)
        full, full_front = sp.relax(full, g)
        stop = bool(sp.stop_test(want, want_front, evaluate))
        checks = {
            "d": same_bits(kern.d, want) and same_bits(twin.d, want)
            and same_bits(full, want),
            "frontier": same_bits(kern.frontier, want_front)
            and same_bits(twin.frontier, want_front)
            and same_bits(full_front, want_front),
            "words": bool((kern.changed == twin.changed).all()
                          and (kern.changed
                               == sp.sector_masks(want < d)).all()),
            "stop": bool(kern.stop) == bool(twin.stop) == stop}
        if all(checks.values()):
            out["sweeps_equal"] += 1
        elif out["first_unequal"] is None:
            out["first_unequal"] = {"sweep": t + 1, **checks}
        if stop and out["stopped_at"] is None:
            out["stopped_at"] = t + 1
        gathered, written = delta_sweep_sectors(g, kern.out_changed,
                                                kern.changed)
        out["gathered_sectors"] += gathered
        out["written_sectors"] += written
        out["gathered_share"].append(gathered / (edges * sectors))
        out["written_share"].append(written / (g.n * sectors))
        d = want
    return out


def delta_batch_ms(g, d0, evaluate, sweeps: int, rounds: int = 2,
                   twin: bool = True) -> dict:
    """The batch's `sweeps` sweeps from d0 timed from CUDA events on DEV,
    in turns (delta, full, delta, full for 2 rounds): the kernel's delta
    sweeps (``relax_delta`` on a new RelaxBatch), summed over the sweeps,
    with each sweep's ms; the same sweeps as stateless full sweeps
    (``relax`` called here, each on the last's output); with `twin`, the
    delta twin's once.  Milliseconds of the whole batch."""
    import torch
    from sph_tpu_torch.ops import shortest_path as sp

    def timed(step, state, n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        for i in range(n):
            state = step(state)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]

    def delta(b):
        sp.relax_delta(b)
        return b

    def delta_twin(b):
        sp.relax_delta_reference(b)
        return b

    out = {"delta_ms": [], "full_loop_ms": []}
    for _ in range(rounds):
        per = timed(delta, sp.RelaxBatch(g, d0.clone(), evaluate), sweeps)
        out["delta_ms"].append(sum(per))
        out["full_loop_ms"].append(sum(timed(lambda d: sp.relax(d, g)[0],
                                             d0.clone(), sweeps)))
    out["delta_ms_by_sweep"] = per
    if twin:
        out["twin_ms"] = sum(timed(delta_twin, sp.RelaxBatch(
            g, d0.clone(), evaluate), sweeps))
    return out


def delta_batch_check(g, d0, evaluate, sweeps: int, name: str) -> dict:
    """``delta_lockstep`` of one field batch over the `sweeps` sweeps the
    path ran it, its delta bound, and on the card its times
    (``delta_batch_ms``): the delta sweeps' ms against the full-sweep
    loop's and against the bound."""
    c = delta_lockstep(g, d0, evaluate, sweeps)
    c["path_shape"] = name
    c.update(relax_delta_bound(g.n, c["edges"], c["fields"], sweeps,
                               c["gathered_sectors"], c["written_sectors"]))
    c["mean_gathered_share"] = sum(c["gathered_share"]) / sweeps
    c["mean_written_share"] = sum(c["written_share"]) / sweeps
    if DEV == "cuda":
        ms = delta_batch_ms(g, d0, evaluate, sweeps)
        c.update(ms)
        c["ms"] = min(ms["delta_ms"])
        c["plain_ms"] = ms["twin_ms"]
        c["of_full_loop"] = c["ms"] / min(ms["full_loop_ms"])
        c["share_of_bound"] = c["bound_ms"] / c["ms"]
        c["gathered_tb_per_s"] = c["gathered_bytes"] / (c["ms"] * 1e-3) / 1e12
    c["library_ms"] = None
    return c


def delta_batch_gate(c: dict, name: str) -> None:
    """Every sweep of the lockstep equal, and the path's sweeps one past
    the first stop on the card (where converge reads the stop a sweep
    late), at it on the CPU, or the batch's cap."""
    if c["sweeps_equal"] != c["sweeps"]:
        raise AssertionError(f"{name}: the delta sweeps differ from the "
                             f"twins: {c['first_unequal']}, "
                             f"{c['sweeps_equal']} of {c['sweeps']} equal")
    lag = 1 if DEV == "cuda" else 0
    if c["stopped_at"] is None or c["sweeps"] != min(c["stopped_at"] + lag,
                                                     c["n"]):
        raise AssertionError(f"{name}: converge ran {c['sweeps']} sweeps, "
                             f"the stop test first held at "
                             f"{c['stopped_at']}")


def relax_graphs(objects: dict) -> tuple:
    """rgb_geo's level-0 field graph and stage 3's contracted level-1
    component graph, from the phase's objects."""
    from sph_tpu_torch.ops import shortest_path as sp
    g0 = sp.FieldGraph.from_graph(objects["graph"], DEV)
    gc = sp._contracted_graph(objects["hierarchy"], objects["data"], 1,
                              objects["num_samples"], objects["seed"], DEV)
    return g0, gc


def relax_checks(objects: dict) -> dict:
    """bellman_ford_relax against its twins at rgb_geo's shapes: the
    stateless sweep at its level-0 field graph at F = RELAX_FIELDS and
    RELAX_ODD_FIELDS and at the contracted component graph of stage 3's
    level 1 at RELAX_FIELDS (each from a start relaxed RELAX_START_SWEEPS
    sweeps); then the two whole field batches of
    ``relax_batch_checks``."""
    g0, gc = relax_graphs(objects)
    checks = [check_relax_kernel(g0, relax_start(g0, RELAX_FIELDS, 1),
                                 "rgb_geo_level_0"),
              check_relax_kernel(g0, relax_start(g0, RELAX_ODD_FIELDS, 2),
                                 f"rgb_geo_level_0_f{RELAX_ODD_FIELDS}"),
              check_relax_kernel(gc, relax_start(gc, RELAX_FIELDS, 3),
                                 "rgb_geo_contracted_level_1")]
    return {"checks": checks, **relax_batch_checks(objects, g0, gc)}


def relax_batch_checks(objects: dict, g0, gc) -> dict:
    """Two whole field batches as the paths run them, each through
    converge both ways (``both_ways``: values, sweeps, launches) and sweep
    by sweep (``delta_batch_check``): the first level-0 pair-value batch
    over the level's spatial-neighbour pairs on `g0`, and stage 3's first
    contracted-graph batch on `gc` (components 0-255 as sources, to the
    fixed point) through _fields_component_max."""
    import numpy as np
    import torch
    from sph_tpu_torch.ops import shortest_path as sp
    graph = objects["graph"]
    a, b = neighbour_pairs(objects["hierarchy"], 0)
    batch = pair_batch_both_ways(g0, graph, a, b)
    pair_batch_gate(batch)
    _, samples, evaluate, _ = pair_batch_inputs(g0, graph, a, b)
    pair_delta = delta_batch_check(g0, g0.init(samples), evaluate,
                                   batch["sweeps_kernel"][0],
                                   "rgb_geo_level_0_pair_batch")
    delta_batch_gate(pair_delta, "level-0 pair batch")
    sources = np.arange(min(RELAX_FIELDS, gc.n))[:, None]
    comps = torch.arange(gc.n, device=gc.device)[:, None]
    comp, _ = both_ways(lambda: sp._fields_component_max(gc, sources, comps,
                                                         gc.n))
    comp["fields"] = len(sources)
    pair_batch_gate(comp, "contracted-graph batch")
    comp_delta = delta_batch_check(gc, gc.init(sources), None,
                                   comp["sweeps_kernel"][0],
                                   "rgb_geo_contracted_level_1_batch")
    delta_batch_gate(comp_delta, "contracted-graph batch")
    return {"pair_batch": batch, "component_batch": comp,
            "batches": [pair_delta, comp_delta]}


def rgb_geo_record(ref: dict) -> dict:
    """The record's scene and settings on the card for GEO_CENTROID and
    GEO_WALKS (the port's CONTRACT_THRESHOLD set to the record's for the
    runs), each with the record's sketch pairs replayed."""
    from sph_tpu_torch.ops import shortest_path as sp
    import sph_tpu_torch as T
    kept = sp.CONTRACT_THRESHOLD
    sp.CONTRACT_THRESHOLD = ref["contract_threshold"]
    try:
        out = {}
        for cs in ("geo_centroid", "geo_walks"):
            t = time.perf_counter()
            out[cs] = geo_record_run(T, cs, tuple(ref["size"][:2]),
                                     replay=ref[cs]["sketch_pairs"],
                                     device=DEV)
            out[cs]["seconds"]["total"] = time.perf_counter() - t
    finally:
        sp.CONTRACT_THRESHOLD = kept
    return out


def rgb_geo_record_gates(run: dict, ref: dict) -> dict:
    """Each similarity against the JAX-CPU record: level 1 within 2 %,
    levels of at least 100 components within 10 %, the level count within
    one; where the level counts agree, the kNN rows' ids (levels whose
    component count agrees) at least RECORD_KNN_IDS_MIN equal as sets, and
    the replayed sketch Hausdorff within RECORD_SKETCH_RTOL of the record's
    (and infinite where it is).  Raises on failure; returns what it
    compared."""
    import numpy as np
    out = {}
    for cs in ("geo_centroid", "geo_walks"):
        got, want = run[cs], ref[cs]
        levels, ref_levels = got["levels"], want["levels"]
        name = f"rgb_geo_record {cs}"
        if abs(levels[1] - ref_levels[1]) > LEVEL1_TOLERANCE * ref_levels[1]:
            raise AssertionError(f"{name} level 1 {levels[1]} not within "
                                 f"2 % of the JAX record {ref_levels[1]}")
        if abs(len(levels) - len(ref_levels)) > 1:
            raise AssertionError(f"{name}: {len(levels)} levels vs "
                                 f"{len(ref_levels)} in the JAX record")
        deep_levels_gate(levels, ref_levels, name)
        res = {"levels": levels, "jax_cpu_levels": ref_levels}
        if len(levels) == len(ref_levels):
            for level, rk in want["knn"].items():
                gk = got["knn"].get(level)
                if gk is None or gk["components"] != rk["components"]:
                    res[f"knn_level_{level}"] = "component counts differ"
                    continue
                same = sum(len(set(x) & set(y))
                           for x, y in zip(gk["ids"], rk["ids"]))
                share = same / sum(len(y) for y in rk["ids"])
                res[f"knn_level_{level}_ids_equal"] = share
                if share < RECORD_KNN_IDS_MIN:
                    raise AssertionError(f"{name} level {level}: kNN ids "
                                         f"{share} equal to the record's")
            g = np.asarray(got["replayed_sketch_hausdorff"], np.float64)
            w = np.asarray(want["sketch_pairs"]["sketch_hausdorff"],
                           np.float64)
            if not np.array_equal(np.isfinite(g), np.isfinite(w)):
                raise AssertionError(f"{name}: the sketch meets other pairs "
                                     "than the record's")
            fin = np.isfinite(w)
            rel = np.abs(g[fin] - w[fin]) / np.maximum(np.abs(w[fin]),
                                                       1e-30)
            res["sketch_pairs"] = int(len(w))
            res["sketch_max_rel_err"] = float(rel.max()) if rel.size else 0.0
            res["sketch_bit_equal_fraction"] = float(
                (g[fin] == w[fin]).mean()) if rel.size else 1.0
            if rel.size and rel.max() > RECORD_SKETCH_RTOL:
                raise AssertionError(f"{name}: sketch Hausdorff off the "
                                     f"record by {rel.max()} relative")
        out[cs] = res
    return out


def salinas_gates(sal: dict, ref: dict) -> None:
    """salinas_euclid's gates against the JAX-CPU record `ref`; raises on
    the first that fails."""
    import numpy as np
    levels, ref_levels = sal["levels"], ref["levels"]
    if sal["size"] != ref["size"]:
        raise AssertionError(f"salinas_euclid at {sal['size']}, the JAX "
                             f"record at {ref['size']}")
    if abs(levels[1] - ref_levels[1]) > LEVEL1_TOLERANCE * ref_levels[1]:
        raise AssertionError(f"salinas_euclid level 1 {levels[1]} not "
                             f"within 2 % of the JAX record {ref_levels[1]}")
    if abs(len(levels) - len(ref_levels)) > 1:
        raise AssertionError(f"salinas_euclid: {len(levels)} levels vs "
                             f"{len(ref_levels)} in the JAX record")
    threshold = ref["approx_knn_threshold"]
    for level in range(1, len(levels)):
        want = "approximate" if levels[level] > threshold else "exact"
        if sal["knn_tiers"][level] != want:
            raise AssertionError(f"salinas_euclid level {level} "
                                 f"({levels[level]} components) took the "
                                 f"{sal['knn_tiers'][level]} kNN")
    if not levels[1] > threshold:
        raise AssertionError("salinas_euclid level 1 is not above the "
                             "approximate threshold")
    recall = sal["level_1_component_knn_recall"]
    if not recall >= ref["level_1_component_knn_recall"] - RECALL_SLACK:
        raise AssertionError(
            f"salinas_euclid level-1 component kNN recall {recall} < the "
            f"JAX record's {ref['level_1_component_knn_recall']} - "
            f"{RECALL_SLACK}")
    if len(levels) > 2 and sal["level_2_exactness"] is None:
        raise AssertionError("salinas_euclid level 2 was not checked "
                             "against float64")
    for level, run in sal["tsne"].items():
        kl = run["kl_at"]
        if not (np.all(np.isfinite(list(kl.values())))
                and kl[max(kl, key=int)] < kl["0"]):
            raise AssertionError(f"salinas_euclid level {level}: KL not "
                                 f"finite and falling: {kl}")
        if not run["embedding_finite"]:
            raise AssertionError(f"salinas_euclid level {level}: the "
                                 "embedding is not finite")
        iters = int(max(kl, key=int))
        if run["tier"] == "dense" and (
                run["launches"]["tsne_forces_dense"] < iters):
            raise AssertionError(
                f"salinas_euclid level {level}: tsne_forces_dense "
                f"launched {run['launches']['tsne_forces_dense']} times in "
                f"{iters} iterations")
        if run["launches"]["tsne_repulsion"] < 1:
            raise AssertionError(f"salinas_euclid level {level}: the KL's "
                                 "Z did not come from tsne_repulsion")
    if sal["tsne"][1]["tier"] != "dense":
        raise AssertionError("salinas_euclid level 1 did not take the "
                             "dense t-SNE tier")
    if not sal["umap"]["embedding_finite"]:
        raise AssertionError("the salinas_euclid UMAP embedding is not "
                             "finite")


def eval_grid(root: str, img, writer, name: str, grid_file: str = EVAL_GRID,
              **changes) -> str:
    """`grid_file` (configs/pines_embed.json by default) with its image
    (`img`, written by `writer` as <root>/data/pines_synth.tiff unless
    already there) and its output base under `root`, and the keys in
    `changes` replaced; returns the path of the grid file written as
    <root>/<name>.json."""
    with open(os.path.join(REPO, grid_file)) as f:
        grid = json.load(f)
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    image = os.path.join(data_dir, grid["imageNames"][0])
    if not os.path.exists(image):
        writer(image, img)
    grid.update(inputPath=data_dir, cachePathBase=os.path.join(root, "out"),
                **changes)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(grid, f, indent=2)
    return path


def eval_outputs(out_dir: str, read_vec_of_vec, read_embedding) -> dict:
    """A run_evaluation run's folder read back by the given readers: the levels
    (from MapFromBottomToLevel.bin), the sha256 of both maps, and the
    embeddings by method and level."""
    import hashlib
    maps = {}
    for name in ("MapFromBottomToLevel", "MapFromLevelToBottom"):
        with open(os.path.join(out_dir, f"{name}.bin"), "rb") as f:
            maps[name] = hashlib.sha256(f.read()).hexdigest()
    pix = read_vec_of_vec(os.path.join(out_dir, "MapFromBottomToLevel.bin"))
    embs = {}
    for fname in sorted(os.listdir(out_dir)):
        if fname.startswith("emb_") and fname.endswith(".bin"):
            _, method, level = fname[:-4].split("_")
            embs.setdefault(method, {})[int(level)] = read_embedding(
                os.path.join(out_dir, fname))
    return {"levels": [int(p.max()) + 1 for p in pix], "maps_sha256": maps,
            "pixel_components": pix, "embeddings": embs}


def eval_read_back(out_dir: str, run: dict, got: dict) -> dict:
    """Every file of a run_evaluation run present and read back by the port's
    readers: the level images against the pixel maps, the component image,
    each level's pixels once in MapFromLevelToBottom.bin, the stats files,
    and each embedding finite at its level's size; raises otherwise."""
    import numpy as np
    from sph_tpu_torch.utils import io as tio
    levels = got["levels"]
    if levels != run["levels"]:
        raise AssertionError(f"maps give levels {levels}, the run "
                             f"{run['levels']}")
    n = levels[0]
    for level, pix in enumerate(got["pixel_components"]):
        img = tio.load_label_image(os.path.join(out_dir,
                                                f"level_{level}.tiff"))
        if not np.array_equal(img, pix.astype(np.float32)):
            raise AssertionError(f"level_{level}.tiff differs from the map")
    if tio.load_label_image(os.path.join(out_dir, "component.tiff")
                            ).size != n:
        raise AssertionError("component.tiff has the wrong size")
    for level, flat in enumerate(tio.read_vec_of_vec(
            os.path.join(out_dir, "MapFromLevelToBottom.bin"))):
        if not np.array_equal(np.sort(flat), np.arange(n)):
            raise AssertionError(f"MapFromLevelToBottom level {level} is "
                                 "not a permutation of the pixels")
    for name in ("sph_stats_imh.txt", "sph_stats_ls.txt"):
        with open(os.path.join(out_dir, name)) as f:
            stats = json.load(f)
        if name == "sph_stats_imh.txt" and stats["numComponents"] != levels:
            raise AssertionError(f"{name}: {stats['numComponents']}")
    with open(os.path.join(out_dir, "sph_settings.txt")) as f:
        if not f.read().strip():
            raise AssertionError("sph_settings.txt is empty")
    files = 0
    for e in run["embeddings"]:
        emb = got["embeddings"][e["method"]][e["level"]]
        if emb.shape != (e["n"], 2) or not np.all(np.isfinite(emb)):
            raise AssertionError(f"emb_{e['method']}_{e['level']}.bin: "
                                 f"shape {emb.shape}, finite "
                                 f"{bool(np.all(np.isfinite(emb)))}")
        files += 1
    return {"files": sorted(os.listdir(out_dir)), "embeddings_read": files}


def eval_run(tsne_kernels, grid: str) -> dict:
    """The port's run_evaluation once on `grid`, as a user calls it
    (run_evaluation with no device: the card), with the kernels' counts
    set to 0 just before and read just after; its summary, wall seconds
    and outputs read back."""
    from sph_tpu_torch.evaluation import run_evaluation as tre
    from sph_tpu_torch.evaluation.settings import load_eval_settings
    from sph_tpu_torch.utils import io as tio
    settings = load_eval_settings(grid)
    report = []
    zero_launches(tsne_kernels)
    t = time.perf_counter()
    dirs = tre.run_evaluation(settings, report=report,
                              device=None if DEV == "cuda" else DEV)
    sync()
    seconds = time.perf_counter() - t
    launches = read_launches(tsne_kernels)
    if len(dirs) != 1 or len(report) != 1:
        raise AssertionError(f"the grid ran {len(dirs)} runs, not 1")
    run = report[0]
    got = eval_outputs(dirs[0], tio.read_vec_of_vec, tio.read_embedding)
    return {"run": run, "seconds": seconds, "launches": launches,
            "outputs": got, "read_back": eval_read_back(dirs[0], run, got),
            "out_dir": dirs[0]}


def eval_summary(r: dict) -> dict:
    """A run_evaluation run for the phase line: seconds by stage and by level
    embedding, launches, levels and the maps' sha256."""
    run = r["run"]
    return {"levels": run["levels"], "seconds_total": r["seconds"],
            "seconds_by_stage": run["seconds"],
            "knn_loaded_from_cache": run["knn_loaded_from_cache"],
            "embeddings": run["embeddings"], "launches": r["launches"],
            "maps_sha256": r["outputs"]["maps_sha256"],
            "files": r["read_back"]["files"]}


def eval_levels_gate(levels, ref_levels, name: str) -> None:
    """The Pines phase's rule: level 1 within 2 % of the record, the level
    count within one."""
    if abs(levels[1] - ref_levels[1]) > LEVEL1_TOLERANCE * ref_levels[1]:
        raise AssertionError(f"{name} level 1 {levels[1]} not within 2 % "
                             f"of the JAX record {ref_levels[1]}")
    if abs(len(levels) - len(ref_levels)) > 1:
        raise AssertionError(f"{name}: {len(levels)} levels vs "
                             f"{len(ref_levels)} in the JAX record")


def eval_maps_gate(r: dict, want: dict, name: str) -> bool:
    """Both maps byte-equal to the JAX record's or, if the card's sums moved
    a merge, the levels by the Pines rule; returns whether they were
    equal."""
    equal = r["outputs"]["maps_sha256"] == want["maps_sha256"]
    if not equal:
        eval_levels_gate(r["run"]["levels"], want["levels"], name)
    return equal


def eval_umap_empty_gate(r: dict, want: dict, maps_equal: bool,
                         name: str) -> dict:
    """The levels whose UMAP had no memberships (the port keeps their
    starting layout; the JAX package's UMAP raises there) against the
    record's: the same levels where the maps or the level sizes equal the
    record's, else none larger than the record's largest such level."""
    got = [e["level"] for e in r["run"]["embeddings"]
           if e["method"] == "umap" and e["memberships"] == 0]
    ref = [lv for lv, m in enumerate(want["umap_memberships"]) if m == 0]
    levels, sizes = r["run"]["levels"], want["levels"]
    if maps_equal or levels == sizes:
        if got != ref:
            raise AssertionError(f"{name}: UMAP levels {got} have no "
                                 f"memberships, the JAX record's {ref}")
    elif any(levels[lv] > max((sizes[x] for x in ref), default=0)
             for lv in got):
        raise AssertionError(f"{name}: UMAP levels {got} of sizes "
                             f"{[levels[lv] for lv in got]} have no "
                             f"memberships, the JAX record's {ref}")
    return {"umap_empty_levels": got, "jax_cpu_umap_empty_levels": ref,
            "umap_memberships": [e["memberships"]
                                 for e in r["run"]["embeddings"]],
            "jax_cpu_umap_memberships": want["umap_memberships"]}


def umap_level0_gate(r: dict, want: dict, name: str) -> dict:
    """Level 0's UMAP memberships exactly the record's count.  Level 0's P
    is the JAX package's bit for bit, and its driver unions that
    device-resident P on its device path, which keeps at most
    SPH_SYM_WREV_MAX reverse entries a row; so does the port's."""
    got = [e["memberships"] for e in r["run"]["embeddings"]
           if e["method"] == "umap" and e["level"] == 0]
    ref = want["umap_memberships"][0]
    if got != [ref]:
        raise AssertionError(f"{name}: level 0 has {got} UMAP memberships, "
                             f"the JAX record {ref}")
    return {"level_0_umap_memberships": ref,
            "level_0_umap_memberships_equal_to_record": True}


def eval_tsne_gates(r: dict, name: str) -> None:
    """A run's t-SNE levels: ``tsne_level_gates`` and
    ``tsne_launch_gates``."""
    tsne_level_gates(r["run"]["embeddings"], name)
    tsne_launch_gates(r["run"]["embeddings"], r["launches"], name)


def tsne_level_gates(embeddings: list, name: str) -> None:
    """Every level of 2 or more points on the dense tier, and every level
    of at least 100 components with a finite KL below its starting
    layout's."""
    import numpy as np
    for e in embeddings:
        if e["n"] < 2:
            continue
        if e["tier"] != "dense":
            raise AssertionError(f"{name} level {e['level']} took the "
                                 f"{e['tier']} t-SNE tier")
        if e["n"] >= DEEP_LEVEL_MIN and not (
                np.isfinite(e["kl"]) and e["kl"] < e["kl_start"]):
            raise AssertionError(f"{name} level {e['level']}: KL "
                                 f"{e['kl']} not finite and below its "
                                 f"start {e['kl_start']}")


def tsne_launch_gates(embeddings: list, launches: dict, name: str) -> None:
    """tsne_forces_dense launched once an iteration of the schedule summed
    over the levels of 2 or more points, and tsne_repulsion twice a level
    (the two KLs)."""
    embedded = [e for e in embeddings if e["n"] >= 2]
    want = sum(e["iterations"] for e in embedded)
    if launches["tsne_forces_dense"] != want:
        raise AssertionError(
            f"{name}: tsne_forces_dense launched "
            f"{launches['tsne_forces_dense']} times, the schedule has "
            f"{want} iterations")
    if launches["tsne_repulsion"] != 2 * len(embedded):
        raise AssertionError(
            f"{name}: tsne_repulsion launched "
            f"{launches['tsne_repulsion']} times for the KLs of "
            f"{len(embedded)} levels")


def eval_pines_tsne(tsne_kernels, ref: dict) -> dict:
    """configs/pines_embed.json uncut through run_evaluation, twice under one
    base: the second run's kNN stage loads from the shared cache."""
    import shutil
    import tempfile
    from sph_tpu_torch.utils import io as tio
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    root = tempfile.mkdtemp(prefix="eval_pines_tsne_")
    img = create_hyperspectral_scene(*EVAL_PINES_SHAPE, seed=EVAL_SEED)
    grid = eval_grid(root, img, tio.save_tiff_stack, "pines_tsne")
    first = eval_run(tsne_kernels, grid)
    second = eval_run(tsne_kernels, grid)
    shutil.rmtree(root, ignore_errors=True)
    out = {"first": eval_summary(first), "second": eval_summary(second),
           "jax_cpu_levels": ref["levels"]}
    for run, key, name in ((first, "first", "eval_pines_tsne"),
                           (second, "second", "eval_pines_tsne second run")):
        out[key]["maps_equal_to_record"] = eval_maps_gate(run, ref, name)
        eval_tsne_gates(run, name)
    if first["run"]["knn_loaded_from_cache"]:
        raise AssertionError("eval_pines_tsne: the first run found a kNN "
                             "cache in a new base")
    if not second["run"]["knn_loaded_from_cache"]:
        raise AssertionError("eval_pines_tsne: the second run's kNN stage "
                             "did not load from the shared cache")
    if (second["run"]["levels"] != first["run"]["levels"]
            or second["outputs"]["maps_sha256"]["MapFromBottomToLevel"]
            != first["outputs"]["maps_sha256"]["MapFromBottomToLevel"]):
        raise AssertionError(
            "eval_pines_tsne: the cached run's levels or "
            "MapFromBottomToLevel.bin differ from the first run's: "
            f"{second['run']['levels']} vs {first['run']['levels']}")
    return out


def eval_pines_umap(tsne_kernels, ref: dict) -> dict:
    """The same grid with dataDistNorm UMAP and UMAP of every level: the
    levels, memberships in (0, 1], finite layouts, and level 1's
    trustworthiness at k = 10 against the components' mean spectra."""
    import shutil
    import tempfile
    import numpy as np
    from sph_tpu_torch.utils import io as tio
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    root = tempfile.mkdtemp(prefix="eval_pines_umap_")
    img = create_hyperspectral_scene(*EVAL_PINES_SHAPE, seed=EVAL_SEED)
    grid = eval_grid(root, img, tio.save_tiff_stack, "pines_umap",
                     **EVAL_UMAP)
    r = eval_run(tsne_kernels, grid)
    shutil.rmtree(root, ignore_errors=True)
    levels = r["run"]["levels"]
    maps_equal = eval_maps_gate(r, ref, "eval_pines_umap")
    empty = eval_umap_empty_gate(r, ref, maps_equal, "eval_pines_umap")
    empty.update(umap_level0_gate(r, ref, "eval_pines_umap"))
    for e in r["run"]["embeddings"]:
        rng = e.get("membership_range")
        if rng is not None and not (rng[0] > 0.0 and rng[1] <= 1.0):
            raise AssertionError(f"eval_pines_umap level {e['level']}: "
                                 f"memberships in {rng}")
    if sorted(r["outputs"]["embeddings"].get("umap", {})) != list(
            range(len(levels))):
        raise AssertionError("eval_pines_umap: not every level embedded")
    data = img.reshape(-1, img.shape[2]).astype(np.float64)
    t = time.perf_counter()
    trust = trustworthiness(component_means(
        data, r["outputs"]["pixel_components"][1], levels[1]),
        r["outputs"]["embeddings"]["umap"][1], 10)
    return {**eval_summary(r), "jax_cpu_levels": ref["levels"],
            "maps_equal_to_record": maps_equal, **empty,
            "level_1_trustworthiness_k10": trust,
            "trustworthiness_seconds": time.perf_counter() - t}


def eval_record(tsne_kernels, ref: dict) -> dict:
    """Both grids through run_evaluation at 64x64x200 against the JAX-CPU
    record of the whole grid run: the maps byte-equal to the record's or, if
    the card's sums moved a merge, levels by the salinas_euclid rule; the
    final t-SNE KL of each level of at least 100 components (and the
    record's size) within 1 % of the record's; level 1's UMAP
    trustworthiness at least 0.99 x the record's."""
    import shutil
    import tempfile
    import numpy as np
    from sph_tpu_torch.utils import io as tio
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    img = create_hyperspectral_scene(*EVAL_RECORD_SHAPE, seed=EVAL_SEED)
    out = {}
    # the record's UMAP ran with float32 gathers (SPH_UMAP_PACKED=0)
    for name, changes, pins in (
            ("record_tsne", {}, {}),
            ("record_umap", EVAL_UMAP, {"SPH_UMAP_PACKED": "0"})):
        want = ref["runs"][name]
        root = tempfile.mkdtemp(prefix=f"eval_{name}_")
        grid = eval_grid(root, img, tio.save_tiff_stack, name, **changes)
        with env(**pins):
            r = eval_run(tsne_kernels, grid)
        shutil.rmtree(root, ignore_errors=True)
        levels = r["run"]["levels"]
        maps_equal = eval_maps_gate(r, want, f"eval_record {name}")
        rec = {**eval_summary(r), "maps_equal_to_record": maps_equal,
               "jax_cpu_levels": want["levels"],
               "jax_cpu_raised": want["raised"]}
        if name == "record_tsne":
            eval_tsne_gates(r, f"eval_record {name}")
            kls = {}
            for e in r["run"]["embeddings"]:
                w = want["tsne_kl"].get(str(e["level"]))
                if w is None or w["n"] != e["n"] or e["n"] < DEEP_LEVEL_MIN:
                    continue
                kls[e["level"]] = {"n": e["n"], "kl": e["kl"],
                                   "jax_cpu_kl": w["kl"]}
                if not abs(e["kl"] - w["kl"]) <= EVAL_KL_RTOL * w["kl"]:
                    raise AssertionError(
                        f"eval_record level {e['level']}: KL {e['kl']} not "
                        f"within 1 % of the JAX record {w['kl']}")
            if not kls:
                raise AssertionError("eval_record: no level's KL compared")
            rec["kl_held"] = kls
        else:
            rec.update(eval_umap_empty_gate(r, want, maps_equal,
                                            f"eval_record {name}"))
            data = img.reshape(-1, img.shape[2]).astype(np.float64)
            trust = trustworthiness(component_means(
                data, r["outputs"]["pixel_components"][1], levels[1]),
                r["outputs"]["embeddings"]["umap"][1], 10)
            rec["level_1_trustworthiness_k10"] = trust
            rec["jax_cpu_trustworthiness_k10"] = want[
                "umap_level_1_trustworthiness_k10"]
            if not trust >= UMAP_TRUST_SLACK * rec[
                    "jax_cpu_trustworthiness_k10"]:
                raise AssertionError(
                    f"eval_record UMAP trustworthiness {trust} < "
                    f"{UMAP_TRUST_SLACK} x the record's "
                    f"{rec['jax_cpu_trustworthiness_k10']}")
        out[name] = rec
    return out


def walk_run_name(run: dict) -> str:
    """A walk-variant run's key in its record: its similarity and walk
    handling, and "+topk" without pair similarities."""
    name = f"{run['component_sim']}+{run['rw_handling']}"
    return name if run["rw_pair_sims"] else name + "+topk"


def eval_grid_runs(tsne_kernels, grid: str) -> dict:
    """The port's run_evaluation once on a grid of several runs, as a user
    calls it, with the kernels' counts set to 0 just before and read just
    after: each run's report with its outputs read back (by
    ``walk_run_name``), the grid's wall seconds and launches."""
    from sph_tpu_torch.evaluation import run_evaluation as tre
    from sph_tpu_torch.evaluation.settings import load_eval_settings
    from sph_tpu_torch.utils import io as tio
    report = []
    zero_launches(tsne_kernels)
    t = time.perf_counter()
    dirs = tre.run_evaluation(load_eval_settings(grid), report=report,
                              device=None if DEV == "cuda" else DEV)
    sync()
    seconds = time.perf_counter() - t
    launches = read_launches(tsne_kernels)
    if not report or len(dirs) != len(report):
        raise AssertionError(f"{grid}: {len(dirs)} run folders, "
                             f"{len(report)} reports")
    runs = {}
    for run in report:
        got = eval_outputs(run["out_dir"], tio.read_vec_of_vec,
                           tio.read_embedding)
        runs[walk_run_name(run)] = {
            "run": run, "outputs": got,
            "read_back": eval_read_back(run["out_dir"], run, got)}
    return {"runs": runs, "seconds": seconds, "launches": launches}


def walk_lengths_gate(run: dict, want: dict, maps_equal: bool,
                      name: str) -> int:
    """The walk length of each level against the record's: all of them
    where the maps are the record's, else those of the leading levels
    whose sizes are the record's (a level's length follows from the
    sizes up to it).  Returns the levels compared."""
    levels, ref = run["levels"], want["levels"]
    same = len(levels) if maps_equal else next(
        (i for i, (a, b) in enumerate(zip(levels, ref)) if a != b),
        min(len(levels), len(ref)))
    got = run["walk_lengths"][:same]
    if got != want["walk_lengths"][:same]:
        raise AssertionError(f"{name}: walk lengths {run['walk_lengths']}, "
                             f"the JAX record's {want['walk_lengths']}")
    return len(got)


def walk_sort_bound(rows: int, cols: int) -> dict:
    """walk_row_sort: each int32 key read once, the sorted key (int32) and
    the order (int64) written once, 16 bytes an entry; no float work."""
    return bound(16 * rows * cols, 0)


def walk_sort_path(walk_sort, cols: int) -> str:
    """Which of walk_row_sort's paths takes rows of `cols` keys."""
    if cols <= walk_sort.WARP_COLS:
        return "a warp a row"
    if cols <= walk_sort.STAGE_COLS:
        return "a block a row, staged whole"
    return "a block a row, partitioned in the order buffer, then staged"


def check_walk_sort(walk_sort, native, keys, label: str,
                    repeats: int = 5, sample: int = 0) -> dict:
    """walk_row_sort on the card against its twin (native/xla_sort.cpp,
    std::sort on the host) on `keys` [R, S]: every row's order and sorted
    keys equal (with `sample`, that many rows drawn from a seed); the
    wrapper's mean ms over `repeats` calls (CUDA events; run outside the
    paths' launch counts), the twin's ms on the rows it was given (host
    clock, its threads), the 16-byte-an-entry bound, and
    torch.sort(stable=True)'s ms on the same keys (another order of equal
    keys: not the same function)."""
    import numpy as np
    import torch
    keys = keys.to(torch.int32).contiguous()
    rows, cols = keys.shape
    order, got_keys = walk_sort.xla_sort_order(keys)
    ms = cuda_ms(lambda: walk_sort.xla_sort_order(keys), calls=repeats,
                 warmup=0)
    pick = (np.sort(np.random.default_rng(rows + cols).choice(
        rows, sample, replace=False)) if sample else np.arange(rows))
    pick_t = torch.from_numpy(pick).to(keys.device)
    host = keys[pick_t].cpu().numpy()
    t = time.perf_counter()
    want, want_keys = native.xla_sort_order(host)
    plain_ms = (time.perf_counter() - t) * 1e3
    got = order[pick_t].cpu().numpy()
    rows_differ = int((got != want).any(axis=1).sum())
    keys_differ = int((got_keys[pick_t].cpu().numpy() != want_keys).any(
        axis=1).sum())
    del order, got_keys
    torch_ms = cuda_ms(lambda: torch.sort(keys, dim=1, stable=True),
                       calls=max(1, repeats), warmup=1)
    out = {"path_shape": label, "rows": rows, "cols": cols,
           "kernel_path": walk_sort_path(walk_sort, cols),
           "rows_held": len(pick),
           "rows_differ": rows_differ, "sorted_key_rows_differ": keys_differ,
           "max_abs_err": float(np.abs(got - want).max()) if got.size
           else 0.0, "ms": ms, "plain_ms": plain_ms,
           "plain_rows": len(pick),
           **walk_sort_bound(rows, cols),
           "torch_sort_stable_ms": torch_ms,
           "torch_sort_stable_is": "another order of equal keys"}
    if rows_differ or keys_differ:
        raise AssertionError(f"walk_row_sort {label}: {rows_differ} rows' "
                             f"orders and {keys_differ} rows' keys differ "
                             "from std::sort's")
    return out


def walk_sort_synthetic(walk_sort, cols: int,
                        rows: int = WALK_SORT_SYNTH_ROWS):
    """Rows of `cols` keys, `rows` of each kind: all equal, sorted (each
    key thrice), reverse-sorted, and McIlroy's median-of-3 adversary, which
    drives std::sort to its heap path.  [4 * rows, cols] int32 on DEV."""
    import numpy as np
    import torch
    ramp = np.arange(cols, dtype=np.int32) // 3
    kinds = [np.full(cols, 7, np.int32), ramp, ramp[::-1].copy(),
             walk_sort.median_of_3_adversary(cols)]
    stats = {}
    walk_sort.introsort_order_reference(kinds[-1], stats)
    if not stats.get("heap"):
        raise AssertionError(f"the adversary of {cols} keys does not reach "
                             "the heap path")
    return torch.from_numpy(np.repeat(np.stack(kinds), rows, axis=0)).to(DEV)


def walk_like_rows(rows: int, cols: int, seed: int = 5):
    """Rows of `cols` visits that stay near their start point (each row's
    ids within +-200 of its own, heavy repeats), as long walks give them:
    [rows, cols] int32 on DEV."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ids = rng.integers(-200, 201, (rows, cols)) + 1000 * np.arange(rows)[:, None]
    return torch.from_numpy(ids.astype(np.int32)).to(DEV)


@contextlib.contextmanager
def first_visit_record(twalks, rows: int, keep: dict):
    """While open, the first LINEAR or NORMAL visit record of `rows` start
    points that ops.walks.accumulate is given lands in keep["ids"], as the
    per-start visit lists [rows, W * L] the sort takes."""
    inner = twalks.accumulate

    def wrapped(visited, num_walks, walk_length, weighting, out_width):
        steps, cw = visited.shape
        if ("ids" not in keep and cw == rows * num_walks
                and weighting in ("linear", "normal")):
            keep["ids"] = visited.reshape(steps, rows, num_walks).permute(
                1, 2, 0).reshape(rows, num_walks * steps).clone()
            keep["walks"], keep["length"] = num_walks, walk_length
        return inner(visited, num_walks, walk_length, weighting, out_width)

    twalks.accumulate = wrapped
    try:
        yield keep
    finally:
        twalks.accumulate = inner


def merge_runs_bound(entries: int, runs: int, children: int = 0,
                     parents: int = 0) -> dict:
    """merge_runs: each entry's float32 value read once (4 bytes); each
    run's int64 start and int64 first key read and its row and column
    (int64) and value (float32) written once (36 bytes), and the last run's
    end (8); where the merge weights by size, each child's float32 weight
    and each parent's int64 start read and its float32 weight written once
    (4 and 12 bytes, and the last parent's end); one float add an entry."""
    return bound(4 * entries + 36 * runs + 8 + 4 * children + 12 * parents
                 + (8 if parents else 0), entries)


def device_ms(fn, calls: int, warmup: int = 1) -> float:
    """Mean ms a call: CUDA events on the card (``cuda_ms``), the host
    clock where DEV is the CPU (the rehearsals)."""
    if DEV == "cuda":
        return cuda_ms(fn, calls, warmup)
    for _ in range(warmup):
        fn()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) * 1e3 / calls


def wall_ms(fn, calls: int) -> list:
    """Each call's ms on the host clock, the card synchronised before and
    after it: paths that wait on the host between their launches."""
    out = []
    for _ in range(calls):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return out


@contextlib.contextmanager
def merge_record(keep: dict):
    """While open, every merge the paths send to the device path
    (ops/sparse's ``merge_by_parents_device``) is listed in keep["calls"]
    as its arguments and its output width: references and a copy of the
    parents on the host, no work on the card, so the timed stages carry
    no cost of it (``merge_summary`` reads them after the stage).  The
    first kNN graph stage 1 symmetrizes lands in keep["knn"] (indices,
    distances)."""
    import numpy as np
    from sph_tpu_torch.models import nearest_neighbors as tnn
    from sph_tpu_torch.ops import sparse as tsp
    inner, inner_sym = tsp.merge_by_parents_device, tnn.symmetrize_graph
    keep.setdefault("calls", [])

    def merged(sr, parents, num_merged, weight_by_size, combine,
               max_width=None, **kw):
        out = inner(sr, parents, num_merged, weight_by_size, combine,
                    max_width, **kw)
        keep["calls"].append(((sr, np.array(parents, np.int64),
                               int(num_merged), bool(weight_by_size),
                               combine, max_width), out.width))
        return out

    def symmetrized(graph, device=None):
        if "knn" not in keep:
            keep["knn"] = (np.array(graph.indices), np.array(graph.distances))
        return inner_sym(graph, device=device)

    tsp.merge_by_parents_device = merged
    tnn.symmetrize_graph = symmetrized
    try:
        yield keep
    finally:
        tsp.merge_by_parents_device = inner
        tnn.symmetrize_graph = inner_sym


def merge_summary(keep: dict, pick: str = "") -> dict:
    """The merges ``merge_record`` listed, read after the stage: each
    call's shape, combine, cap, live entries, the largest summed child
    weight of a parent (a float32 sum that is exact in any order below
    2^24) and its output width replace its arguments in keep["calls"].
    One merge's arguments land in keep["inputs"] and its live entries in
    keep["entries"]: the first (pick "first"), the first min merge
    ("first_min") or the one of the most live entries ("widest").
    Returns the merges in short: how many, the most live entries, and the
    largest summed weight of a parent, which tells whether any reached
    2^24 (where the order of a float32 sum of counts starts to matter)."""
    import torch
    calls = []
    for args, out_width in keep.get("calls", []):
        sr, parents, num_merged, weight_by_size, combine, max_width = args
        live = (sr.idx >= 0) & (sr.val != 0)
        par = torch.as_tensor(parents, device=sr.device)
        weight = torch.zeros(num_merged, dtype=torch.int64,
                             device=sr.device).index_add_(0, par, live.sum(1))
        call = {"rows": sr.num_rows, "width": sr.width,
                "num_merged": num_merged, "combine": combine,
                "weight_by_size": weight_by_size, "max_width": max_width,
                "entries": int(live.sum()),
                "widest_parent_weight": int(weight.max()),
                "out_width": out_width}
        calls.append(call)
        take = {"": False, "first": "inputs" not in keep,
                "first_min": "inputs" not in keep and combine == "min",
                "widest": call["entries"] > keep.get("entries", -1)}[pick]
        if take:
            keep["inputs"], keep["entries"] = args, call["entries"]
    keep["calls"] = calls
    top = max((c["widest_parent_weight"] for c in calls), default=0)
    return {"merges": len(calls),
            "sum_merges": sum(c["combine"] == "sum" for c in calls),
            "min_merges": sum(c["combine"] == "min" for c in calls),
            "most_entries": max((c["entries"] for c in calls), default=0),
            "widest_parent_weight": top,
            "weight_above_2_24": top > 2 ** 24}


def merge_peak_bytes(inputs: tuple) -> dict:
    """The device merge's peak memory on the card above what was allocated
    before it, at one merge (``merge_record``'s inputs): the whole merge
    (merge_by_parents_device at the module's budget, the packed output
    included), and its kernel inputs and merge_runs with every parent in
    one range (the budget lifted), beside that range's live entries and
    padded slots.  "one_range_peak_bytes_per_entry" is that range's peak
    less device_merge._BYTES_PER_SLOT a slot, over its entries: what
    device_merge._BYTES_PER_ENTRY should hold.  Nones off the card."""
    import torch
    from sph_tpu_torch.ops import device_merge as tdm
    if DEV != "cuda":
        return {"peak_bytes": None, "one_range_peak_bytes": None,
                "one_range_peak_bytes_per_entry": None}
    sr, parents, num_merged, wbs, combine, cap = inputs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = tdm.merge_by_parents_device(sr, parents, num_merged, wbs, combine,
                                      cap)
    torch.cuda.synchronize()
    whole = torch.cuda.max_memory_allocated() - base
    del out
    torch.cuda.reset_peak_memory_stats()
    got = [tdm.merge_runs(*a, **e) for a, e in tdm.merge_kernel_inputs(
        sr, parents, num_merged, wbs, combine, memory_budget=1 << 62)]
    torch.cuda.synchronize()
    one = torch.cuda.max_memory_allocated() - base
    del got
    entries = int(((sr.idx >= 0) & (sr.val != 0)).sum())
    slots = sr.num_rows * sr.width
    return {"peak_bytes": whole, "one_range_peak_bytes": one,
            "one_range_entries": entries, "one_range_slots": slots,
            "one_range_peak_bytes_per_entry":
                (one - tdm._BYTES_PER_SLOT * slots) / max(entries, 1),
            "bytes_per_entry_set": tdm._BYTES_PER_ENTRY,
            "bytes_per_slot_set": tdm._BYTES_PER_SLOT}


def check_merge(inputs: tuple, label: str, calls: int = MERGE_CALLS,
                twin_calls: int = MERGE_TWIN_CALLS,
                path_calls: int = MERGE_PATH_CALLS) -> dict:
    """One merge of the paths (``merge_record``'s inputs: rows, parents,
    parent count, weight_by_size, combine, cap), four ways on the same
    inputs:

    - merge_runs, the kernel, against its twin merge_runs_reference on DEV
      over every parent range the merge takes: rows, columns, values and
      merged weights bit-equal; both timed, beside ``merge_runs_bound`` and
      index_add_'s (scatter_reduce's for a min) ms on the same runs, which
      adds in another order (not the same function);
    - the device path (merge_by_parents_device, then
      normalize_merged_device for a sum, as the hierarchy normalizes it)
      against the host path (the rows downloaded to the CPU, where the
      merges take the C++ merge, the packing and numpy's normalization,
      and the results uploaded): indices, values and width bit-equal,
      merged and normalized; both timed on the host clock, the host path
      on the call compared (seconds at the largest merges), the device
      path on `path_calls` more;
    - the device merge's peak memory (``merge_peak_bytes``)."""
    import numpy as np
    import torch
    from sph_tpu_torch.ops import device_merge as tdm
    from sph_tpu_torch.ops import sparse as tsp
    sr, parents, num_merged, wbs, combine, cap = inputs
    ranges = list(tdm.merge_kernel_inputs(sr, parents, num_merged, wbs,
                                          combine))
    differ, err, rows_out = 0, 0.0, []
    for args, extra in ranges:
        got = tdm.merge_runs(*args, **extra)
        want = tdm.merge_runs_reference(*args, **extra)
        for a, b in zip(got, want):
            if a is None or b is None:
                differ += (a is None) != (b is None)
                continue
            differ += not (same_bits(a, b) if a.dtype == torch.float32
                           else bool(torch.equal(a, b)))
            if a.numel():
                err = max(err, float((a.double() - b.double()).abs().max()))
        rows_out.append(got[0])
    n_ranges = len(ranges)
    entries = sum(a[0].numel() for a, _ in ranges)
    runs = sum(a[2].numel() - 1 for a, _ in ranges)
    children = sum(e["child_w"].numel() for _, e in ranges if e)
    parents_n = sum(e["parent_start"].numel() - 1 for _, e in ranges if e)
    full_width = int(torch.bincount(torch.cat(rows_out),
                                    minlength=num_merged).max())
    del rows_out
    ms = device_ms(lambda: [tdm.merge_runs(*a, **e) for a, e in ranges],
                   calls)
    plain_ms = device_ms(lambda: [tdm.merge_runs_reference(*a, **e)
                                  for a, e in ranges], twin_calls, warmup=0)
    segs = [torch.repeat_interleave(
        torch.arange(a[2].numel() - 1, device=a[2].device), a[2].diff())
        for a, _ in ranges]

    def scatter():
        for (a, _), seg in zip(ranges, segs):
            out = torch.zeros(a[2].numel() - 1, device=seg.device)
            if combine == "sum":
                out.index_add_(0, seg, a[1])
            else:
                out.scatter_reduce_(0, seg, a[1], "amin", include_self=False)

    scatter_ms = device_ms(scatter, calls)
    del ranges, segs

    def device_path():
        out = tdm.merge_by_parents_device(sr, parents, num_merged, wbs,
                                          combine, cap)
        return out, (tsp.normalize_merged_device(out) if combine == "sum"
                     else None)

    keep = []

    def host_path():
        rows = tsp.SparseRows(sr.idx.cpu(), sr.val.cpu(), sr.num_cols)
        if combine == "sum":
            out = tsp.merge_rows_by_parents(rows, parents, num_merged,
                                            weight_by_size=wbs,
                                            max_width=cap)
            outs = out, tsp.normalize_merged(out)
        else:
            outs = tsp.merge_rows_min_by_parents(rows, parents, num_merged,
                                                 max_width=cap), None
        return tuple(None if o is None else tsp.SparseRows(
            o.idx, o.val, o.num_cols, device=sr.device) for o in outs)

    got = device_path()
    host_path_ms = wall_ms(lambda: keep.append(host_path()), 1)
    want = keep.pop()
    paths_equal = all(
        a is None and b is None or (
            a.width == b.width and bool(torch.equal(a.idx.cpu(), b.idx.cpu()))
            and same_bits(a.val.cpu(), b.val.cpu()))
        for a, b in zip(got, want))
    width = got[0].width
    del got, want
    device_path_ms = wall_ms(device_path, path_calls)
    peak = merge_peak_bytes(inputs)
    b = merge_runs_bound(entries, runs, children, parents_n)
    out = {"path_shape": label, "rows": sr.num_rows, "width": sr.width,
           "num_merged": num_merged, "combine": combine,
           "weight_by_size": wbs, "max_width": cap,
           "untruncated_width": full_width, "width_out": width,
           "cap_bites": cap is not None and full_width > cap,
           "entries": entries, "runs": runs, "parent_ranges": n_ranges,
           "children": children, "parents": parents_n,
           "kernel_outputs_differ": differ, "max_abs_err": err,
           "paths_bit_equal": paths_equal, "ms": ms, "plain_ms": plain_ms,
           **b, "share_of_bound": b["bound_ms"] / ms if ms else None,
           "scatter_ms": scatter_ms,
           "scatter_is": "index_add_ / scatter_reduce_: atomics, another "
                         "order of additions",
           "device_path_ms": device_path_ms, "host_path_ms": host_path_ms,
           "host_path_is": "download, C++ merge, packing, numpy "
                           "normalization, upload", **peak}
    if differ or err or not paths_equal:
        raise AssertionError(f"merge_runs {label}: {differ} kernel outputs "
                             f"differ from the twin's (max {err}); device "
                             f"and host paths bit-equal: {paths_equal}")
    return out


def check_symmetrize(knn: tuple, label: str, calls: int = SYM_CALLS) -> dict:
    """symmetrize_graph on a path's kNN graph both ways: the device path
    (device DEV named: the graph uploaded, symmetrize_graph_device, the
    result downloaded) against the host path (no device: native.
    symmetrize): indices, distances and counts bit-equal; each timed on
    the host clock."""
    import numpy as np
    from sph_tpu_torch.ops import graph as tgraph
    idx, dist = knn
    g = tgraph.KnnGraph(idx, dist)

    def run(on_device):
        return tgraph.symmetrize_graph(g, device=DEV if on_device else None)

    dev, host = run(True), run(False)
    equal = (np.array_equal(dev.indices, host.indices)
             and np.array_equal(dev.distances.view(np.int32),
                                host.distances.view(np.int32))
             and np.array_equal(dev.counts, host.counts))
    if not equal:
        raise AssertionError(f"symmetrize_graph {label}: the device path "
                             "differs from native.symmetrize")
    return {"path_shape": label, "n": int(idx.shape[0]),
            "k": int(idx.shape[1]), "width": int(dev.indices.shape[1]),
            "bit_equal": True, "device_path_ms": wall_ms(lambda: run(True),
                                                         calls),
            "host_path_ms": wall_ms(lambda: run(False), calls)}


def eval_pines_walks(tsne_kernels, ref: dict) -> dict:
    """The evaluation driver on both walk-variant grids (EVAL_WALK_GRIDS)
    at 145x145x200: each run's maps against the JAX-CPU record's (else
    levels by the Pines rule), its walk lengths against the record's,
    every output read back, the t-SNE levels' KLs, tsne_forces_dense once
    an iteration of each grid's schedule, and under
    MERGE_RW_NEW_WALKS_AND_KNN a component kNN on every level above 0."""
    import shutil
    import tempfile
    from sph_tpu_torch.utils import io as tio
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    root = tempfile.mkdtemp(prefix="eval_pines_walks_")
    img = create_hyperspectral_scene(*EVAL_PINES_SHAPE, seed=EVAL_SEED)
    out = {"grids": {}, "runs": {}}
    for grid_file in EVAL_WALK_GRIDS:
        name = os.path.splitext(os.path.basename(grid_file))[0]
        g = eval_grid_runs(tsne_kernels, eval_grid(
            root, img, tio.save_tiff_stack, name, grid_file=grid_file))
        tsne_launch_gates([e for r in g["runs"].values()
                           for e in r["run"]["embeddings"]],
                          g["launches"], f"eval_pines_walks {name}")
        out["grids"][name] = {"runs": sorted(g["runs"]),
                              "seconds_total": g["seconds"],
                              "launches": g["launches"]}
        for key, r in g["runs"].items():
            run, want = r["run"], ref["runs"].get(key)
            if want is None:
                raise AssertionError(f"eval_pines_walks: no record of {key}")
            label = f"eval_pines_walks {key}"
            maps_equal = eval_maps_gate(r, want, label)
            if not maps_equal and key not in WALK_MAPS_EXCEPTIONS:
                raise AssertionError(f"{label}: the maps differ from the "
                                     "JAX-CPU record's")
            tsne_level_gates(run["embeddings"], label)
            compared = walk_lengths_gate(run, want, maps_equal, label)
            if run["rw_handling"] == "merge_rw_new_walks_and_knn" and not all(
                    run["knn_tiers"][1:]):
                raise AssertionError(f"{label}: a level without a "
                                     f"component kNN: {run['knn_tiers']}")
            out["runs"][key] = {
                "grid": name, "levels": run["levels"],
                "jax_cpu_levels": want["levels"],
                "maps_equal_to_record": maps_equal,
                "walk_lengths": run["walk_lengths"],
                "jax_cpu_walk_lengths": want["walk_lengths"],
                "walk_lengths_compared": compared,
                "knn_tiers": run["knn_tiers"],
                "seconds_by_stage": run["seconds"],
                "embeddings": run["embeddings"],
                "files_read_back": len(r["read_back"]["files"])}
    shutil.rmtree(root, ignore_errors=True)
    equal = [k for k, r in out["runs"].items() if r["maps_equal_to_record"]]
    out["maps_equal_to_record"] = f"{len(equal)} of {len(out['runs'])}"
    out["maps_exceptions"] = {k: WALK_MAPS_EXCEPTIONS[k]
                              for k in out["runs"]
                              if k in WALK_MAPS_EXCEPTIONS}
    return out


def salinas_walks_settings(P, handling: str, level_to_compute: int = -1):
    """benchmarks/bench_salinas.py:41-75's recipe for package P: stage 1
    the exact kNN (FLAT), k = 31, symmetric and connected; stage 2
    NEIGH_WALKS with `handling` (a RandomWalkHandling value), 50 walks of
    10 steps, NORMAL weighting, min_reduction 98, max_levels 10,
    PROPORTIONAL_COMPONENT_REDUCTION, TSNE data normalisation; stage 3
    NEIGH_WALKS with pair similarities, ks = [31], TSNE normalisation and
    symmetrisation.  Returns (ihs, lss, rws, nns)."""
    walks = P.ComponentSim.NEIGH_WALKS
    ihs = P.ImageHierarchySettings(
        component_sim=walks, merge_multiple=False, use_percentile=False,
        max_dist=0.0, min_num_comp=1, min_reduction=98.0, max_levels=10,
        rw_handling=P.RandomWalkHandling(handling),
        rw_reduction=P.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION,
        norm_knn_distances=P.NormalizationScheme.TSNE)
    lss = P.LevelSimilaritiesSettings(
        component_sim=walks, ks=[SALINAS_K], random_walk_pair_sims=True,
        normalize_prob_dist=P.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=P.NormalizationScheme.TSNE,
        level_to_compute=level_to_compute)
    rws = P.RandomWalkSettings(
        num_random_walks=50, single_walk_length=10,
        importance_weighting=P.ImportanceWeighting.NORMAL, random_seed=1)
    nns = P.NearestNeighborsSettings(
        num_nearest_neighbors=SALINAS_K, knn_index=P.KnnIndex.FLAT,
        symmetric_neighbors=True, compute_connect_components=True,
        neighbor_connect_components=True)
    return ihs, lss, rws, nns


def walks_band(walks) -> float:
    """The float32 band of a Bhattacharyya distance of these walk rows: a
    sum of at most `width` products of square roots, each within a few
    ulps, whose total is at most 1."""
    return (walks.width + 2) * 2.0 ** -23


def bhattacharyya_f64(walks, rows):
    """1 - min(BC, 1) in float64 from each of `rows` to every row of the
    walks (self 0): [len(rows), C]."""
    import numpy as np
    import scipy.sparse as sp
    idx, val = walks.indices, walks.values.astype(np.float64)
    c = walks.num_rows
    ok = idx >= 0
    s = sp.csr_matrix((np.sqrt(np.maximum(val[ok], 0.0)),
                       (np.nonzero(ok)[0], idx[ok])), shape=(c, c))
    bc = np.asarray((s[rows] @ s.T).todense())
    d = 1.0 - np.minimum(bc, 1.0)
    d[np.arange(len(rows)), rows] = 0.0
    return d


def walks_knn_exactness(walks, ids, dists, rows) -> dict:
    """A Bhattacharyya walk kNN's `rows` against float64: each returned
    distance within the float32 band of its float64 value, and no
    neighbour farther than the float64 k-th distance plus the band."""
    import numpy as np
    band = walks_band(walks)
    d64 = bhattacharyya_f64(walks, rows)
    k = ids.shape[1]
    kth = np.partition(d64, k - 1, axis=1)[:, k - 1]
    got = np.take_along_axis(d64, ids[rows].astype(np.int64), 1)
    value_err = float(np.abs(got - dists[rows]).max())
    beyond = float((got - kth[:, None]).max())
    if not value_err <= band:
        raise AssertionError(f"walk kNN distances {value_err} from float64, "
                             f"band {band}")
    if not beyond <= band:
        raise AssertionError(f"a walk kNN neighbour lies {beyond} beyond "
                             f"the float64 k-th distance, band {band}")
    return {"rows": len(rows), "k": int(k), "band": band,
            "max_value_err": value_err, "max_beyond_kth": beyond}


def salinas_walks(tsne_kernels, shape=SALINAS_SHAPE,
                  iters: int = SALINAS_WALKS_TSNE_ITERS,
                  knn_iters: int = SALINAS_WALKS_KNN_ITERS,
                  recall_rows: int = SALINAS_WALKS_RECALL_ROWS,
                  exact_rows: int = SALINAS_WALKS_EXACT_ROWS) -> dict:
    """bench_salinas.py:41-75's NEIGH_WALKS recipe (``salinas_walks_
    settings``) on create_hyperspectral_scene(*shape, seed=13) through
    ComputeHierarchy(device=DEV), twice from one stage 1 (the second
    hierarchy loads it from a shared kNN cache): (i) MERGE_RW_ONLY and
    `iters` t-SNE iterations of level 1; (ii) MERGE_RW_NEW_WALKS_AND_KNN,
    level 1's component kNN (approximate above the threshold) and its
    recall on `recall_rows` sampled rows against the exact knn_walks,
    level 2's against float64 on `exact_rows` rows, P's checks and
    `knn_iters` t-SNE iterations of level 1.  Kernel counts are set to 0
    before each hierarchy and read after its t-SNE."""
    import shutil
    import tempfile
    import numpy as np
    import sph_tpu_torch as T
    from sph_tpu_torch.models.tsne import dense_npad
    from sph_tpu_torch.ops.component_knn import knn_walks
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    rows, cols, bands = shape
    t = time.perf_counter()
    img = create_hyperspectral_scene(rows, cols, bands, seed=13)
    data = T.scale(T.ImageStack.from_array(img, name="salinas_walks").data,
                   T.Scaler.NONE)
    out = {"size": list(shape), "data_seconds": time.perf_counter() - t}
    root = tempfile.mkdtemp(prefix="salinas_walks_")
    cache = T.CacheSettings(path=os.path.join(root, "knn"),
                            file_name="salinas_walks", cache_active=True)
    for key, handling, n_iter in (
            ("rw_only", "merge_rw_only", iters),
            ("new_walks_and_knn", "merge_rw_new_walks_and_knn", knn_iters)):
        ihs, lss, rws, nns = salinas_walks_settings(T, handling)
        ch = T.ComputeHierarchy(device=DEV).init(
            data, rows, cols, ihs=ihs, lss=lss, rws=rws, nns=nns,
            knn_cache=cache)
        zero_launches(tsne_kernels)
        seconds = {}
        conditional = {}
        for name, stage in (("stage1_knn", ch.compute_knn_graph),
                            ("stage2_hierarchy", ch.compute_image_hierarchy),
                            ("stage3_level_similarities",
                             lambda: keeping_conditional_rows(
                                 ch, 1, conditional))):
            t = time.perf_counter()
            stage()
            sync()
            seconds[name] = time.perf_counter() - t
        h = ch.image_hierarchy.hierarchy
        ls = ch.level_similarities
        levels = [int(c) for c in h.num_components]
        es = T.ComputeEmbeddingSettings()
        es.tsne.num_iterations = n_iter
        ce = T.ComputeEmbedding(es, device=DEV)
        kls = {}

        def progress(comp, kls=kls):
            if comp.current_iteration == 0:
                kls[0] = comp.kl_divergence()

        p1 = ls.get_prob_dist(1)
        t = time.perf_counter()
        with env(**{name: None for name in TSNE_SWITCHES}):
            emb = ce.compute_tsne(p1, track_kl=True, progress=progress)
        sync()
        seconds["tsne_level_1"] = time.perf_counter() - t
        kls[n_iter] = float(ce.last_kl)
        comp = ce.last_computation
        run = {"levels": levels, "walk_lengths": list(
                   ch.image_hierarchy._rw_lengths),
               "knn_tiers": ls.knn_tiers,
               "knn_loaded_from_cache": ch.knn_loaded_from_cache,
               "seconds": seconds,
               "tsne": {"n": levels[1], "npad": int(comp._y.shape[0]),
                        "want_npad": dense_npad(levels[1]),
                        "tier": comp.tier, "iterations": n_iter,
                        "iters_per_s": n_iter / ce.seconds["iterations"],
                        "kl_at": {str(i): v for i, v in sorted(kls.items())},
                        "embedding_finite": bool(np.all(np.isfinite(emb)))},
               "launches": read_launches(tsne_kernels)}
        if handling == "merge_rw_only":
            # pairwise walk similarities: the JAX package's rows are
            # device-resident, so level 1 took its device path, which sheds
            # hub rows' faintest reverse entries
            if not ls.device_path(1):
                raise AssertionError("salinas_walks level 1: pairwise walk "
                                     "rows did not take the device path")
            run["p"] = p_mirror_checks(p1, shed_reverse_keys(conditional[1]))
        else:
            walks1 = h.random_walks[1]
            ids1, d1 = ls.distance_graphs[1]
            run["p"] = p_checks(p1, ids1, d1, ls.perplexity_on_level[1])
            pick = np.sort(np.random.default_rng(1).choice(
                levels[1], min(recall_rows, levels[1]), replace=False))
            t = time.perf_counter()
            ei, ed = knn_walks(walks1, ids1.shape[1])
            sync()
            seconds["exact_knn_walks_level_1"] = time.perf_counter() - t
            run["level_1_k"] = int(ids1.shape[1])
            run["level_1_exact_equals_float64"] = walks_knn_exactness(
                walks1, ei, ed, pick[:exact_rows])
            run["level_1_recall"] = overlap_recall(
                ids1[pick], d1[pick], ed[pick, -1] + walks_band(walks1))
            if len(levels) > 2 and ls.knn_tiers[2] == "exact":
                pick2 = np.sort(np.random.default_rng(2).choice(
                    levels[2], min(exact_rows, levels[2]), replace=False))
                run["level_2_exactness"] = walks_knn_exactness(
                    h.random_walks[2], *ls.distance_graphs[2], pick2)
        out[key] = run
        del ch, ls, h, ce, comp, p1, emb
    shutil.rmtree(root, ignore_errors=True)
    return out


def salinas_walks_gates(sal: dict, ref: dict) -> dict:
    """(i)'s and (ii)'s levels against the JAX-CPU record (level 1 within
    2 %, the count within one); (i) on the dense tier at its Npad with the
    KL gate of bench_salinas.py:116-129 against docs/anchors_salinas.json;
    (ii)'s level 1 on the approximate tier with recall at least the
    record's - 0.01, level 2 exact against float64, a falling KL; both
    P's checks and tsne_forces_dense once an iteration."""
    import numpy as np
    with open(os.path.join(REPO, "docs", "anchors_salinas.json")) as f:
        anchor = json.load(f)["kl_under_p_sklearn_bh"]
    gates = {"kl_gate": KL_SLACK * anchor}
    for key in ("rw_only", "new_walks_and_knn"):
        run, want = sal[key], ref["runs"][key]
        eval_levels_gate(run["levels"], want["levels"], f"salinas_walks "
                         f"{key}")
        tsne, kl = run["tsne"], run["tsne"]["kl_at"]
        if tsne["tier"] != "dense" or tsne["npad"] != tsne["want_npad"]:
            raise AssertionError(f"salinas_walks {key}: level 1 took the "
                                 f"{tsne['tier']} tier at {tsne['npad']}")
        if run["launches"]["tsne_forces_dense"] != tsne["iterations"]:
            raise AssertionError(f"salinas_walks {key}: tsne_forces_dense "
                                 f"launched {run['launches']} times")
        final = kl[str(tsne["iterations"])]
        if not (np.isfinite(final) and final < kl["0"]
                and tsne["embedding_finite"]):
            raise AssertionError(f"salinas_walks {key}: KL {kl}")
        if key == "rw_only" and not final <= gates["kl_gate"]:
            raise AssertionError(f"salinas_walks: level-1 KL {final} > "
                                 f"{KL_SLACK} x anchor {anchor}")
    knn = sal["new_walks_and_knn"]
    want = ref["runs"]["new_walks_and_knn"]
    if knn["knn_tiers"][1] != "approximate":
        raise AssertionError(f"salinas_walks: level 1 took the "
                             f"{knn['knn_tiers'][1]} walk kNN")
    if not knn["level_1_recall"] >= want["level_1_recall"] - RECALL_SLACK:
        raise AssertionError(f"salinas_walks: level-1 recall "
                             f"{knn['level_1_recall']} < the JAX record's "
                             f"{want['level_1_recall']} - {RECALL_SLACK}")
    if knn.get("level_2_exactness") is None:
        raise AssertionError("salinas_walks: level 2 did not take the "
                             f"exact walk kNN: {knn['knn_tiers']}")
    if not knn["knn_loaded_from_cache"]:
        raise AssertionError("salinas_walks: the second hierarchy did not "
                             "load stage 1 from the shared cache")
    gates["jax_cpu_level_1_recall"] = want["level_1_recall"]
    return gates


def http_get(url: str):
    """(status, body bytes, milliseconds) of one GET."""
    import urllib.error
    import urllib.request
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=600) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read()
    return status, body, (time.perf_counter() - t) * 1e3


def knn_edges(ids, dists) -> list:
    """The explorer's kNN edges from a kNN graph: each pair once, lower id
    first, similarity 1 - distance rounded to 6 places."""
    n = ids.shape[0]
    edges = []
    for i in range(n):
        for j in range(1, ids.shape[1]):
            t = int(ids[i, j])
            if 0 <= t < n and t > i:
                edges.append([i, t, round(max(0.0, 1.0 - float(dists[i, j])),
                                          6)])
    return edges


def explorer(ch, emb, requests=EXPLORER_KNN,
             exact_rows: int = EXPLORER_EXACT_ROWS) -> dict:
    """ExplorerServer on DEV over a computed hierarchy with level 1's
    embedding, on 127.0.0.1 at a free port: the page and /api/meta; each
    /api/knn of `requests` (level, k), first and cached, equal to a direct
    knn_walks call, the largest k's level-1 rows against float64 on
    `exact_rows` rows; /api/walks at level 1 (50 x 10, seed 1) equal to
    the port's do_random_walks on the CPU; /api/path at level 1 against
    scipy's Dijkstra over the answered edges; a request above the cap
    answers 400.  Latencies in milliseconds."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.component_knn import knn_walks
    from sph_tpu_torch.ops.sparse import SparseRows, host_normalize
    from sph_tpu_torch.ops.walks import do_random_walks
    from sph_tpu_torch.vis_server import ExplorerServer
    h = ch.image_hierarchy.hierarchy
    levels = [int(c) for c in h.num_components]
    srv = ExplorerServer(ch, embeddings={1: emb}, device=DEV)
    url = srv.start(port=0)
    out = {"levels": levels, "ms": {}}
    try:
        for name in ("", "api/meta"):
            for attempt in ("first", "cached"):
                status, body, ms = http_get(url + name)
                if status != 200:
                    raise AssertionError(f"explorer /{name}: {status}")
                out["ms"][f"/{name} {attempt}"] = ms
        meta = json.loads(body)
        if meta["num_components"] != levels:
            raise AssertionError(f"explorer meta: {meta}")
        out["page_bytes"] = len(http_get(url)[1])
        for level, k in requests:
            q = f"api/knn?level={level}&k={k}"
            got = []
            for attempt in ("first", "cached"):
                status, body, ms = http_get(url + q)
                if status != 200:
                    raise AssertionError(f"explorer /{q}: {status} {body}")
                out["ms"][f"/{q} {attempt}"] = ms
                got.append(json.loads(body)["edges"])
            walks = h.random_walks[level]
            ids, dists = knn_walks(walks, k)
            if not got[0] == got[1] == knn_edges(ids, dists):
                raise AssertionError(f"explorer /{q}: edges differ from a "
                                     "direct knn_walks call")
            out[f"knn_level_{level}_k{k}_edges"] = len(got[0])
        level, k = max((r for r in requests if r[0] == 1),
                       key=lambda r: r[1])
        pick = np.sort(np.random.default_rng(5).choice(
            levels[level], min(exact_rows, levels[level]), replace=False))
        out["knn_exactness"] = walks_knn_exactness(
            h.random_walks[level], *knn_walks(h.random_walks[level], k),
            pick)
        q = "api/walks?level=1&num=50&len=10&seed=1"
        for attempt in ("first", "cached"):
            status, body, ms = http_get(url + q)
            if status != 200:
                raise AssertionError(f"explorer /{q}: {status} {body}")
            out["ms"][f"/{q} {attempt}"] = ms
        rows = h.random_walks[1]
        cpu = SparseRows(rows.indices, host_normalize(rows.indices,
                                                      rows.values),
                         rows.num_cols, device="cpu")
        ref = do_random_walks(cpu, T.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=T.ImportanceWeighting.NORMAL,
            random_seed=1))
        ri, rv = ref.indices, ref.values
        want = [[[int(c) for c in ri[i][ri[i] >= 0]],
                 [round(float(v), 6) for v in rv[i][ri[i] >= 0]]]
                for i in range(levels[1])]
        if json.loads(body)["walks"] != want:
            raise AssertionError("explorer /api/walks differs from "
                                 "do_random_walks on the CPU")
        # a pair joined in the live k = 16 graph: node 0 and the node
        # farthest from it by scipy's Dijkstra over the answered edges
        e = np.array(json.loads(http_get(
            url + "api/knn?level=1&k=16")[1])["edges"])
        w = -np.log(np.maximum(e[:, 2], 1e-12))
        g = sp.coo_matrix((np.concatenate([w, w]), (
            np.concatenate([e[:, 0], e[:, 1]]).astype(np.int64),
            np.concatenate([e[:, 1], e[:, 0]]).astype(np.int64))),
            shape=(levels[1],) * 2).tocsr()
        dist = dijkstra(g, indices=0)
        a, b = 0, int(np.argmax(np.where(np.isfinite(dist), dist, -1.0)))
        q = f"api/path?level=1&a={a}&b={b}&k=16"
        status, body, ms = http_get(url + q)
        out["ms"][f"/api/path?level=1 first"] = ms
        path = json.loads(body)
        ends = path["path"][:1] + path["path"][-1:]
        if (status != 200 or b == a or ends != [a, b]
                or path["distance"] != round(float(dist[b]), 6)):
            raise AssertionError(f"explorer /{q}: {status} {path}, scipy "
                                 f"{dist[b]}")
        out["path"] = {"a": a, "b": b, "hops": len(path["path"]) - 1,
                       "distance": path["distance"],
                       "scipy_distance": float(dist[b])}
    finally:
        srv.stop()
    capped = ExplorerServer(ch, device=DEV,
                            max_live_components=levels[0] - 1)
    url = capped.start(port=0)
    try:
        status, body, ms = http_get(url + "api/knn?level=0&k=16")
    finally:
        capped.stop()
    if status != 400:
        raise AssertionError(f"explorer above the cap: {status} {body}")
    out["above_cap"] = {"status": status, "ms": ms}
    return out


def trustworthiness(x, emb, k: int = 10, block: int = 512) -> float:
    """sklearn.manifold.trustworthiness in numpy (the card's machine has no
    sklearn): 1 - 2 / (n k (2n - 3k - 1)) times the sum, over each point's
    k nearest neighbours in `emb`, of how far past k their ranks by
    distance in `x` go.  Distances in float64, rows in blocks."""
    import numpy as np
    x = np.asarray(x, np.float64)
    e = np.asarray(emb, np.float64)
    n = x.shape[0]
    sqx, sqe = (x * x).sum(1), (e * e).sum(1)
    total = 0
    for r0 in range(0, n, block):
        rows = np.arange(r0, min(r0 + block, n))
        ar = np.arange(rows.size)
        dx = sqx[rows, None] + sqx[None, :] - 2.0 * (x[rows] @ x.T)
        de = sqe[rows, None] + sqe[None, :] - 2.0 * (e[rows] @ e.T)
        dx[ar, rows] = np.inf
        de[ar, rows] = np.inf
        near = np.argpartition(de, k, axis=1)[:, :k]
        at = np.take_along_axis(dx, near, 1)
        ranks = (dx[:, None, :] < at[:, :, None]).sum(2) + 1 - k
        total += int(ranks[ranks > 0].sum())
    return 1.0 - total * 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))


def component_means(data, labels, count: int):
    """The mean spectrum of each component: [count, channels] float64."""
    import numpy as np
    sums = np.zeros((count, data.shape[1]))
    np.add.at(sums, labels, data)
    return sums / np.bincount(labels, minlength=count)[:, None]


def rows_epoch_ms(comp, epochs: int = 50) -> dict:
    """Milliseconds an epoch of a rows-tier UmapComputation with the packed
    gathers and with float32 ones, in turns (packed, float32, float32,
    packed), CUDA events over `epochs` epochs each from the computation's
    state, which is put back after each turn."""
    state = (comp._y, comp._next_sample, comp.packed)
    epoch = comp.n_epochs // 2
    out = {"packed": [], "float32": []}
    for packed in (True, False, False, True):
        comp.packed = packed
        out["packed" if packed else "float32"].append(
            cuda_ms(lambda: comp._rows_epoch(epoch), epochs, 2))
        comp._y, comp._next_sample = state[:2]
    comp.packed = state[2]
    return out


def pines_umap(ch, data, epochs: int = 500, packed: bool = True) -> dict:
    """UMAP of the Pines hierarchy's level 1 through
    ComputeEmbedding.compute_umap (the fuzzy union of the level's P, the
    reference's 500 epochs), its rows tier's gathers packed (the default)
    or float32 (SPH_UMAP_PACKED=0); its seconds, the trustworthiness at
    k = 10 of the layout against the components' mean spectra and, on the
    rows tier, an epoch's milliseconds packed and float32."""
    import sph_tpu_torch as T
    es = T.ComputeEmbeddingSettings()
    es.umap.num_epochs = epochs
    ce = T.ComputeEmbedding(es, device=DEV)
    ls = ch.level_similarities
    with env(SPH_UMAP_PACKED=None if packed else "0"):
        emb = ce.compute_umap(ls.get_prob_dist(1),
                              device_path=ls.device_path(1))
    comp = ce.last_computation
    h = ch.image_hierarchy.hierarchy
    t = time.perf_counter()
    trust = trustworthiness(component_means(
        data, h.pixel_components[1], h.num_components[1]), emb, 10)
    out = {"n": emb.shape[0], "tier": comp.tier, "epochs": comp.n_epochs,
           "packed": comp.packed, "width": tuple(comp._eps.shape)[1],
           "seconds": ce.seconds,
           "epochs_per_s": comp.n_epochs / ce.seconds["epochs"],
           "trustworthiness_k10": trust,
           "trustworthiness_seconds": time.perf_counter() - t, "emb": emb}
    if comp.tier == "rows" and DEV == "cuda":
        out["epoch_ms"] = rows_epoch_ms(comp)
    return out


# ---------------------------------------------------------------------------
# BASELINE config 5: batched multi-scene evaluation and the sharded paths
# ---------------------------------------------------------------------------

def multi_scene_settings(T, k: int, walks: int, length: int,
                         flagship: bool):
    """scripts/multiscene_reference.py's settings: bench.py:97-122's
    flagship ones (NORMAL walk weights), or benchmarks/bench_multiscene.py's
    (the settings' defaults)."""
    if flagship:
        ihs = T.ImageHierarchySettings(
            component_sim=T.ComponentSim.NEIGH_WALKS, merge_multiple=False,
            use_percentile=False, max_dist=0.0, min_num_comp=1,
            min_reduction=98.0, max_levels=10,
            rw_handling=T.RandomWalkHandling.MERGE_RW_ONLY,
            rw_reduction=(
                T.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION),
            norm_knn_distances=T.NormalizationScheme.TSNE)
        rws = T.RandomWalkSettings(
            num_random_walks=walks, single_walk_length=length,
            random_seed=1, importance_weighting=T.ImportanceWeighting.NORMAL)
    else:
        ihs = T.ImageHierarchySettings(
            component_sim=T.ComponentSim.NEIGH_WALKS, merge_multiple=False,
            use_percentile=False)
        rws = T.RandomWalkSettings(num_random_walks=walks,
                                   single_walk_length=length, random_seed=1)
    lss = T.LevelSimilaritiesSettings(
        component_sim=T.ComponentSim.NEIGH_WALKS, ks=[k],
        random_walk_pair_sims=True,
        normalize_prob_dist=T.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=T.NormalizationScheme.TSNE)
    return ihs, rws, lss


def scene_stack(shape, scenes: int, seed0: int):
    """`scenes` scenes create_hyperspectral_scene(rows, cols, bands,
    seed=seed0 + i) as [S, rows x cols, bands] float32."""
    import numpy as np
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    rows, cols, bands = shape
    return np.stack([create_hyperspectral_scene(
        rows, cols, bands, seed=seed0 + i).reshape(rows * cols, bands)
        for i in range(scenes)]).astype(np.float32)


def level0_p(results, n: int):
    """Every scene's level-0 P padded to the widest: [S, N, R] ids and
    values, as benchmarks/bench_multiscene.py:120-128 builds them."""
    import numpy as np
    width = max(ls.get_prob_dist(0).width for _, ls in results)
    s = len(results)
    pi = np.full((s, n, width), -1, np.int32)
    pv = np.zeros((s, n, width), np.float32)
    for i, (_, ls) in enumerate(results):
        m = ls.get_prob_dist(0)
        pi[i, :, :m.width] = m.indices
        pv[i, :, :m.width] = m.values
    return pi, pv


def scene_kls(embs, pi, pv, seed: int = 0) -> dict:
    """Each scene's KL under its normalised P, at its start layout
    (random_disk_init(N, 0.1, seed + i)) and at `embs`, with the exact Z
    (tsne_repulsion on the card)."""
    import numpy as np
    import torch
    from sph_tpu_torch.models.tsne import tsne_kl_divergence
    from sph_tpu_torch.ops.math import random_disk_init
    s, n, _ = embs.shape
    start, final = [], []
    for i in range(s):
        p = pv[i] / max(float(pv[i].sum()), 1e-12)
        p_idx = torch.as_tensor(pi[i].astype(np.int64), device=DEV)
        p_val = torch.as_tensor(p.astype(np.float32), device=DEV)
        for out, y in ((start, random_disk_init(n, 0.1, seed + i)),
                       (final, embs[i])):
            out.append(float(tsne_kl_divergence(
                torch.as_tensor(np.ascontiguousarray(y), device=DEV), p_idx,
                p_val, n)))
    return {"start": start, "final": final}


def serial_stage1(datas, k: int, rws, norm):
    """benchmarks/bench_multiscene.py:82-92's serial A/B arm: each scene's
    one-scene stage 1 (compute_knn FLAT, the data-level probabilities, the
    walks) one after another on DEV."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.ops.distributions import distance_rows_to_probabilities
    from sph_tpu_torch.ops.knn import compute_knn
    from sph_tpu_torch.ops.walks import do_random_walks
    n = datas.shape[1]
    for i in range(datas.shape[0]):
        idx, dist = compute_knn(datas[i], k, T.KnnIndex.FLAT, device=DEV)
        mask = torch.ones(idx.shape, dtype=torch.bool, device=DEV)
        probs = distance_rows_to_probabilities(
            torch.as_tensor(dist, device=DEV), mask, norm, perplexity=-1.0,
            ignore_first=True, umap_row_norm=True)
        idx_t = torch.as_tensor(idx.astype(np.int64), device=DEV)
        do_random_walks(T.SparseRows(torch.where(probs > 0, idx_t, -1),
                                     probs, n), rws)
    sync()


def stage1_fingerprint(ih, rows) -> dict:
    """A scene's stage 1 as the hierarchy holds it: the sha256 of its kNN
    ids (int32, C order), and on `rows` the kNN ids and the walk rows'
    nonzero ids and values."""
    import hashlib
    import numpy as np
    idx = np.ascontiguousarray(ih._graph.indices, dtype=np.int32)
    walks = ih.hierarchy.random_walks[0]
    widx, wval = walks.indices[rows], walks.values[rows]
    ok = (widx >= 0) & (wval != 0)
    return {"knn_ids_sha256": hashlib.sha256(idx.tobytes()).hexdigest(),
            "knn_ids": idx[rows], "all_knn_ids": idx,
            "walk_ids": [w[o] for w, o in zip(widx, ok)],
            "walk_vals": [v[o] for v, o in zip(wval, ok)]}


def walk_rows_compare(got: dict, want: dict) -> dict:
    """The walk rows of the sampled rows against the record's: rows whose
    id hashes are the record's (all sampled rows), and on the rows the
    record keeps whole, those with the same ids, the largest value error
    among them, and each row's total variation distance (half the L1
    distance of the two rows as distributions over their columns)."""
    import numpy as np
    import hashlib
    hashes = [hashlib.sha256(np.asarray(g, np.int32).tobytes()).hexdigest()
              for g in got["walk_ids"]]
    equal_rows, worst, tv = 0, 0.0, []
    # the record keeps whole walk rows for the first of its sampled rows
    for gi, gv, wi, wv in zip(got["walk_ids"], got["walk_vals"],
                              want["walk_ids"], want["walk_vals"]):
        wv = np.asarray(wv, np.float32)
        if len(gi) == len(wi) and np.array_equal(gi, wi):
            equal_rows += 1
            worst = max(worst, float(np.abs(gv - wv).max()) if len(gv)
                        else 0.0)
        cols = np.union1d(gi, wi)
        a = np.zeros(cols.size)
        b = np.zeros(cols.size)
        a[np.searchsorted(cols, gi)] = gv
        b[np.searchsorted(cols, wi)] = wv
        tv.append(0.5 * float(np.abs(a - b).sum()))
    return {"walk_rows_compared": len(want["walk_ids"]),
            "walk_rows_ids_equal": equal_rows,
            "walk_id_hashes_equal": sum(a == b for a, b in zip(
                hashes, want["walk_ids_sha256"])),
            "walk_max_abs_err_where_ids_equal": worst,
            "walk_total_variation_mean": float(np.mean(tv)),
            "walk_total_variation_max": float(np.max(tv))}


def fingerprint_gate(data, got: dict, want: dict, rows, k: int,
                     exact_walks: bool) -> dict:
    """A scene's stage 1 against the JAX-CPU record.  The kNN: equal id
    hashes, else (the card sums the distances in another order than
    XLA-CPU, so ties within the float32 band can fall the other way) the
    record's rows and the card's must each be the float64 top-k up to that
    band (knn_exactness).  The walk rows of the recorded rows: with
    `exact_walks` (equal hashes and walks that can be bit-equal, as on the
    CPU) the record's ids and values within 1e-6; otherwise compared and
    reported only.  On the card the distances' last bits move the
    perplexity search's probabilities and so the walk draws (PERF.md, PR
    10); every recorded row must still be a distribution (ids in range,
    values summing to 1)."""
    import numpy as np
    same_hash = got["knn_ids_sha256"] == want["knn_ids_sha256"]
    out = {"knn_ids_hash_equal": same_hash,
           "knn_rows_equal": int((got["knn_ids"] == np.asarray(
               want["knn_ids"])).all(1).sum()),
           **walk_rows_compare(got, want)}
    for gi, gv in zip(got["walk_ids"], got["walk_vals"]):
        if not (len(gi) and gi.min() >= 0 and gi.max() < data.shape[0]
                and abs(float(gv.sum(dtype=np.float64)) - 1.0) <= 1e-5):
            raise AssertionError(f"a recorded walk row is not a "
                                 f"distribution over the scene: {gi}, {gv}")
    if exact_walks and same_hash:
        if not (out["walk_id_hashes_equal"] == len(rows)
                and out["walk_rows_ids_equal"] == out["walk_rows_compared"]
                and out["walk_max_abs_err_where_ids_equal"] <= 1e-6):
            raise AssertionError(f"stage 1 equal to the record's kNN but "
                                 f"walk rows differ: {out}")
    if same_hash:
        return out
    out["card_exactness"] = knn_exactness(data, got["all_knn_ids"], k, rows)
    # the record's rows, checked in the same float64 frame
    rec = np.zeros((data.shape[0], k), np.int64)
    rec[np.asarray(rows)] = np.asarray(want["knn_ids"])
    out["record_exactness"] = knn_exactness(data, rec, k, rows)
    return out


def multi_scene(tsne_kernels, ref: dict, shape=MULTI_SCENE_SHAPE,
                scenes: int = MULTI_SCENES, k: int = MULTI_SCENE_K,
                iters: int = MULTI_SCENE_ITERS, serial: int = MULTI_SERIAL,
                seed0: int = 7) -> dict:
    """BASELINE config 5 on one card: `scenes` scenes through
    multi_scene_hierarchy on a one-device mesh (batched stage 1, each
    scene's levels), then every scene's level-0 P through multi_scene_tsne
    for `iters` iterations; kernel counts set to 0 just before each part
    and read just after.  Plus bench_multiscene.py's stage-1 A/B on the
    first `serial` scenes, the fingerprints against the record, 64 kNN rows
    of the first and last scene against float64, and S = 1 calls of the
    first and last scene for bit-equality."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.parallel import sharded
    rows, cols, bands = shape
    n = rows * cols
    mesh = [torch.device(DEV)]
    ihs, rws, lss = multi_scene_settings(T, k, 50, 10, flagship=True)
    seconds = {}
    t = time.perf_counter()
    datas = scene_stack(shape, scenes, seed0)
    seconds["data"] = time.perf_counter() - t

    # bench_multiscene.py's A/B: batched against serial, the same scenes
    sub = datas[:serial]
    sharded.multi_scene_stage1(sub[:1], k, rws=rws,
                               norm=ihs.norm_knn_distances, mesh=mesh)
    sync()
    t = time.perf_counter()
    sharded.multi_scene_stage1(sub, k, rws=rws, norm=ihs.norm_knn_distances,
                               mesh=mesh)
    sync()
    seconds[f"stage1_batched_{serial}_scenes"] = time.perf_counter() - t
    t = time.perf_counter()
    serial_stage1(sub, k, rws, ihs.norm_knn_distances)
    seconds[f"stage1_serial_{serial}_scenes"] = time.perf_counter() - t

    zero_launches(tsne_kernels)
    part = {}
    t = time.perf_counter()
    results = sharded.multi_scene_hierarchy(datas, rows, cols, k, ihs=ihs,
                                            rws=rws, lss=lss, mesh=mesh,
                                            seconds=part)
    sync()
    seconds["hierarchy"] = time.perf_counter() - t
    seconds["stage1_batched"] = part["stage1"]
    seconds["levels_by_scene"] = part["levels"]
    hier_launches = read_launches(tsne_kernels)
    levels = [list(ih.hierarchy.num_components) for ih, _ in results]

    sample = np.asarray(ref["sample_rows"])
    prints = [stage1_fingerprint(ih, sample) for ih, _ in results]
    gates = [fingerprint_gate(datas[i], prints[i], ref["stage1"][i], sample,
                              k, exact_walks=DEV == "cpu")
             for i in range(scenes)]
    exact = {str(i): knn_exactness(datas[i], results[i][0]._graph.indices,
                                   k, sample) for i in (0, scenes - 1)}

    pi, pv = level0_p(results, n)
    zero_launches(tsne_kernels)
    sync()
    t = time.perf_counter()
    embs = sharded.multi_scene_tsne(pi, pv, iters, mesh=mesh)
    sync()
    seconds["tsne_batched"] = time.perf_counter() - t
    tsne_launches = read_launches(tsne_kernels)
    single = {}
    for i in (0, scenes - 1):
        one = sharded.multi_scene_tsne(pi[i:i + 1], pv[i:i + 1], iters,
                                       mesh=mesh, seed=i)
        single[str(i)] = bool(np.array_equal(one[0], embs[i]))
    kls = scene_kls(embs, pi, pv)
    return {"scenes": scenes, "shape": list(shape), "k": k,
            "points": scenes * n, "data_bytes": int(datas.nbytes),
            "levels": levels, "seconds": seconds,
            "stage1_speedup_vs_serial":
                seconds[f"stage1_serial_{serial}_scenes"]
                / seconds[f"stage1_batched_{serial}_scenes"],
            "tsne_iterations": iters, "p_width": int(pi.shape[2]),
            "scene_iterations_per_s": scenes * iters
                                      / seconds["tsne_batched"],
            "launches_hierarchy": hier_launches,
            "launches_tsne": tsne_launches,
            "fingerprints": gates, "knn_exactness": exact,
            "scene_equals_one_scene_call": single, "kl": kls,
            "embeddings_finite": bool(np.all(np.isfinite(embs))),
            "pines": {"data": datas[0], "ih": results[0][0],
                      "ls": results[0][1]}}


def multi_scene_gates(run: dict, ref: dict) -> None:
    """The multi_scene phase's gates (PERF.md section 2)."""
    import numpy as np
    want = ref["levels"]
    for i, levels in want.items():
        got = run["levels"][int(i)]
        if abs(got[1] - levels[1]) > LEVEL1_TOLERANCE * levels[1]:
            raise AssertionError(f"multi_scene scene {i}: level 1 {got[1]} "
                                 f"not within 2 % of the record {levels[1]}")
        if abs(len(got) - len(levels)) > 1:
            raise AssertionError(f"multi_scene scene {i}: {len(got)} levels "
                                 f"vs {len(levels)} in the record")
    for levels in run["levels"]:
        if not all(a > b for a, b in zip(levels, levels[1:])):
            raise AssertionError(f"multi_scene levels not falling: {levels}")
    if run["launches_tsne"]["tsne_repulsion"] != run["tsne_iterations"]:
        raise AssertionError(
            f"multi_scene_tsne launched tsne_repulsion "
            f"{run['launches_tsne']['tsne_repulsion']} times in "
            f"{run['tsne_iterations']} iterations (one a batch)")
    if not all(run["scene_equals_one_scene_call"].values()):
        raise AssertionError("a scene of the batched t-SNE differs from its "
                             f"one-scene call: "
                             f"{run['scene_equals_one_scene_call']}")
    start, final = run["kl"]["start"], run["kl"]["final"]
    if not (np.all(np.isfinite(final)) and all(
            f < s for f, s in zip(final, start))):
        raise AssertionError(f"multi_scene KLs not finite and falling: "
                             f"{run['kl']}")
    if not run["embeddings_finite"]:
        raise AssertionError("multi_scene embeddings are not finite")


def multi_scene_record(tsne_kernels, ref: dict,
                       shape=MULTI_RECORD_SHAPE,
                       scenes: int = MULTI_RECORD_SCENES,
                       iters=MULTI_RECORD_ITERS) -> dict:
    """benchmarks/bench_multiscene.py's defaults (4 scenes of 48 x 48 x 32,
    seed i, k = 16, 20 x 6 walks) against the JAX-CPU record: the levels,
    then multi_scene_tsne for each of `iters` and each scene's KL."""
    import numpy as np
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.parallel import sharded
    rows, cols, _ = shape
    k = 16
    mesh = [torch.device(DEV)]
    ihs, rws, lss = multi_scene_settings(T, k, 20, 6, flagship=False)
    datas = scene_stack(shape, scenes, 0)
    part = {}
    t = time.perf_counter()
    results = sharded.multi_scene_hierarchy(datas, rows, cols, k, ihs=ihs,
                                            rws=rws, lss=lss, mesh=mesh,
                                            seconds=part)
    sync()
    seconds = {"hierarchy": time.perf_counter() - t, **part}
    pi, pv = level0_p(results, rows * cols)
    kl, launches = {}, {}
    for it in iters:
        zero_launches(tsne_kernels)
        t = time.perf_counter()
        embs = sharded.multi_scene_tsne(pi, pv, it, mesh=mesh)
        sync()
        seconds[f"tsne_{it}"] = time.perf_counter() - t
        launches[str(it)] = read_launches(tsne_kernels)
        kl[str(it)] = scene_kls(embs, pi, pv)["final"]
    return {"levels": [list(ih.hierarchy.num_components)
                       for ih, _ in results],
            "p_width": int(pi.shape[2]), "kl": kl, "launches": launches,
            "seconds": seconds, "jax_cpu_levels": ref["levels"],
            "jax_cpu_kl": ref["kl"]}


def multi_scene_record_gates(run: dict, ref: dict) -> None:
    """Levels by the Pines rule; each scene's KL after 1000 iterations
    within 1 % of the record's (at 250 iterations, the end of the
    exaggeration, a KL moves by more than that under a 2e-7 change of the
    layout, PERF.md; it is printed beside the record's)."""
    for i, (got, want) in enumerate(zip(run["levels"], ref["levels"])):
        if abs(got[1] - want[1]) > LEVEL1_TOLERANCE * want[1]:
            raise AssertionError(f"multi_scene_record scene {i}: level 1 "
                                 f"{got[1]} vs the record's {want[1]}")
        if abs(len(got) - len(want)) > 1:
            raise AssertionError(f"multi_scene_record scene {i}: {got} vs "
                                 f"{want}")
    for i, (got, want) in enumerate(zip(run["kl"]["1000"],
                                        ref["kl"]["1000"])):
        if not abs(got - want) <= EVAL_KL_RTOL * want:
            raise AssertionError(f"multi_scene_record scene {i}: KL {got} "
                                 f"not within 1 % of the record's {want}")


def sharded_paths(tsne_kernels, mid: dict, pines: dict, seed_scene: dict,
                  iters: int = SHARDED_TSNE_ITERS,
                  epochs: int = SHARDED_UMAP_EPOCHS, k: int = 91,
                  seeds=SHARDED_SEEDS,
                  seed_epochs: int = SHARDED_SEED_EPOCHS) -> dict:
    """The sharded entry points on one card, over the meshes [card] and
    [card, card] (two logical shards): sharded_knn on the Pines scene;
    sharded_tsne and sharded_grid_tsne for `iters` iterations on
    grid_vs_exact's 65536-point P, each scored with the exact Z; and
    sharded_umap for `epochs` epochs beside the one-card edge-list tier
    (twice, for bit-equality), all on the memberships of the Pines path's
    level 1 (its host-path union), each scored by trustworthiness at k =
    10.  Then the edge tier against the sequential oracle for each of
    `seeds` on `seed_scene`'s level 1 (``edge_oracle_ratios``).  `pines`
    and `seed_scene` each hold a scene's data, its level 1's P ("p1"),
    pixel labels and component count."""
    import numpy as np
    import torch
    from sph_tpu_torch.models.tsne import tsne_kl_divergence
    from sph_tpu_torch.models.umap import UmapComputation
    from sph_tpu_torch.parallel import sharded
    dev = torch.device(DEV)
    meshes = {"1": [dev], "2": [dev, dev]}
    out = {"knn": {}, "tsne": {}, "grid_tsne": {}, "umap": {}}
    data = pines["data"]
    ids = {}
    for name, mesh in meshes.items():
        sync()
        t = time.perf_counter()
        ids[name], _ = sharded.sharded_knn(data, k, mesh=mesh)
        sync()
        out["knn"][name] = {"seconds": time.perf_counter() - t}
    out["knn"]["ids_equal_1_2"] = bool(np.array_equal(ids["1"], ids["2"]))

    comp = mid["exact_computation"]
    p = comp._p
    n = p.num_rows
    for key, fn in (("tsne", sharded.sharded_tsne),
                    ("grid_tsne", sharded.sharded_grid_tsne)):
        for name, mesh in meshes.items():
            zero_launches(tsne_kernels)
            sync()
            t = time.perf_counter()
            emb = fn(p.indices, p.values, iters, mesh=mesh)
            sync()
            secs = time.perf_counter() - t
            run_launches = read_launches(tsne_kernels)
            y = torch.zeros((comp._npad, 2), dtype=torch.float32, device=dev)
            y[:n] = torch.as_tensor(emb, device=dev)
            zero_launches(tsne_kernels)
            kl = float(tsne_kl_divergence(y, comp._p_idx, comp._p_val, n))
            out[key][name] = {"seconds": secs, "iterations": iters,
                              "iters_per_s": iters / secs, "kl": kl,
                              "launches": run_launches,
                              "kl_launches": read_launches(tsne_kernels),
                              "finite": bool(np.all(np.isfinite(emb)))}
        a, b = out[key]["1"]["kl"], out[key]["2"]["kl"]
        out[key]["kl_rel_gap_1_2"] = abs(a - b) / a

    x = component_means(data, pines["labels"], pines["count"])
    # the memberships of level 1's P by the host union
    # (UmapComputation's default): the edge tier's oracle and the sharded
    # epochs take them as a given input, whichever union made them
    uc = UmapComputation(device=dev)
    uc.set_neighbor_matrix(pines["p1"])
    m = uc._memberships()
    umap = out["umap"]
    for name, mesh in meshes.items():
        sync()
        t = time.perf_counter()
        emb = sharded.sharded_umap(m.indices, m.values, epochs, mesh=mesh)
        sync()
        umap[f"sharded_{name}"] = {
            "seconds": time.perf_counter() - t,
            "trustworthiness_k10": trustworthiness(x, emb, 10),
            "finite": bool(np.all(np.isfinite(emb)))}
    runs = []
    init = None
    for _ in range(2):
        u = UmapComputation(device=dev)
        u.params.num_epochs = epochs
        u.set_memberships(m)
        if init is not None:
            u.set_initial_embedding(init)
        sync()
        t = time.perf_counter()
        u.init_optimization(edge_path=True)
        if init is None:
            init = u._embedding.copy()
        u.run_for_epochs(epochs)
        sync()
        runs.append((u, time.perf_counter() - t))
    (u, secs), (u2, _) = runs
    umap["edge_tier"] = {
        "seconds": secs, "epochs_per_s": epochs / secs, "edges":
            int(u._src.numel()), "fold_width": int(u._src_fold.pos.shape[1]),
        "trustworthiness_k10": trustworthiness(x, u.embedding, 10),
        "bits_equal_across_runs": bool(np.array_equal(u.embedding,
                                                      u2.embedding))}
    umap["n"] = int(pines["count"])
    t = time.perf_counter()
    umap["edge_vs_oracle"] = edge_oracle_ratios(
        scene_memberships(seed_scene), scene_means(seed_scene), seeds,
        seed_epochs)
    umap["edge_vs_oracle"]["seconds"] = time.perf_counter() - t
    return out


def scene_memberships(scene: dict, device_path: bool = False):
    """A scene's level-1 UMAP memberships: the fuzzy union of its level-1
    P, the host union (UmapComputation's default) or the JAX package's
    device path."""
    from sph_tpu_torch.models.umap import UmapComputation
    uc = UmapComputation(device=DEV)
    uc.set_neighbor_matrix(scene["p1"], device_path=device_path)
    return uc._memberships()


def scene_means(scene: dict):
    """The level-1 components' mean spectra (trustworthiness's space)."""
    return component_means(scene["data"], scene["labels"], scene["count"])


def seed_scene(device: str, shape=SEED_SCENE, k: int = SEED_SCENE_K) -> dict:
    """The edge-tier seed gate's scene, the rehearsal's: scene 0 of
    multi_scene at `shape` (create_hyperspectral_scene(rows, cols, bands,
    seed=7), the flagship settings, 50 x 10 walks) through
    multi_scene_hierarchy on [device]: its data, level-1 P, pixel labels
    and component count."""
    import torch
    import sph_tpu_torch as T
    from sph_tpu_torch.parallel import sharded
    rows, cols, _ = shape
    ihs, rws, lss = multi_scene_settings(T, k, 50, 10, flagship=True)
    data = scene_stack(shape, 1, 7)
    (ih, ls), = sharded.multi_scene_hierarchy(
        data, rows, cols, k, ihs=ihs, rws=rws, lss=lss,
        mesh=[torch.device(device)])
    return {"data": data[0], "p1": ls.get_prob_dist(1),
            "labels": ih.hierarchy.pixel_components[1],
            "count": ih.hierarchy.num_components[1]}


def edge_oracle_ratios(m, x, seeds, epochs: int) -> dict:
    """For each seed: the edge-list tier for `epochs` epochs
    (UmapComputation with params.seed = seed, its PRNG's) and
    native.umap_sequential with seed = seed, both on the memberships `m`
    from one layout (the first seed's spectral layout and noise); each
    one's trustworthiness at k = 10 against `x` and the ratio edge /
    oracle."""
    import numpy as np
    from sph_tpu_torch import native
    from sph_tpu_torch.models.umap import UmapComputation
    edge, seq = [], []
    init = None
    for seed in seeds:
        u = UmapComputation(device=DEV)
        u.params.num_epochs = epochs
        u.params.seed = int(seed)
        u.set_memberships(m)
        if init is not None:
            u.set_initial_embedding(init)
        u.init_optimization(edge_path=True)
        if init is None:
            init = u._embedding.copy()
        u.run_for_epochs(epochs)
        oracle = native.umap_sequential(
            init, u._src.cpu().numpy(), u._dst.cpu().numpy(),
            u._eps.cpu().numpy(), epochs, u._a, u._b, seed=int(seed))
        edge.append(trustworthiness(x, u.embedding, 10))
        seq.append(trustworthiness(x, oracle, 10))
    ratios = [a / b for a, b in zip(edge, seq)]
    return {"n": int(m.num_rows), "epochs": epochs,
            "seeds": [int(v) for v in seeds], "edge_tier": edge,
            "sequential": seq, "ratios": ratios,
            "mean_ratio": float(np.mean(ratios)),
            "min_ratio": float(np.min(ratios))}


def edge_oracle_gate(r: dict) -> None:
    """At least 8 seeds, their mean ratio at least EDGE_ORACLE_MEAN_MIN and
    each seed's at least EDGE_ORACLE_SEED_MIN."""
    if len(r["seeds"]) < 8:
        raise AssertionError(f"edge tier vs oracle on {len(r['seeds'])} "
                             "seeds, fewer than 8")
    if not r["mean_ratio"] >= EDGE_ORACLE_MEAN_MIN:
        raise AssertionError(
            f"edge tier trustworthiness: mean ratio {r['mean_ratio']} to the "
            f"sequential oracle's < {EDGE_ORACLE_MEAN_MIN} over seeds "
            f"{r['seeds']}")
    bad = {s: q for s, q in zip(r["seeds"], r["ratios"])
           if not q >= EDGE_ORACLE_SEED_MIN}
    if bad:
        raise AssertionError(f"edge tier trustworthiness: seed ratios {bad} "
                             f"to the sequential oracle's < "
                             f"{EDGE_ORACLE_SEED_MIN}")


def sharded_gates(run: dict) -> None:
    if not run["knn"]["ids_equal_1_2"]:
        raise AssertionError("sharded_knn: 1 and 2 shards give other ids")
    for key in ("tsne", "grid_tsne"):
        if not run[key]["kl_rel_gap_1_2"] <= SHARDED_KL_RTOL:
            raise AssertionError(f"sharded {key}: KL 1 vs 2 shards "
                                 f"{run[key]['1']['kl']} vs "
                                 f"{run[key]['2']['kl']}")
        for name in ("1", "2"):
            if not run[key][name]["finite"]:
                raise AssertionError(f"sharded {key} {name}: not finite")
    for name in ("1", "2"):
        want = run["tsne"][name]["iterations"] * int(name)
        if run["tsne"][name]["launches"]["tsne_repulsion"] != want:
            raise AssertionError(f"sharded_tsne on {name} shards launched "
                                 f"{run['tsne'][name]['launches']}")
        for key in ("tsne", "grid_tsne"):
            got = run[key][name]["launches"]["tsne_attraction"]
            if got != want:
                raise AssertionError(f"sharded {key} on {name} shards "
                                     f"launched tsne_attraction {got} times,"
                                     f" not {want}")
        # each shard deposits its points and interpolates at them
        for kernel in ("grid_deposit", "grid_interpolate"):
            got = run["grid_tsne"][name]["launches"][kernel]
            if got != want:
                raise AssertionError(f"sharded_grid_tsne on {name} shards "
                                     f"launched {kernel} {got} times, not "
                                     f"{want}")
    u = run["umap"]
    edge = u["edge_tier"]["trustworthiness_k10"]
    for name in ("1", "2"):
        got = u[f"sharded_{name}"]["trustworthiness_k10"]
        if not (u[f"sharded_{name}"]["finite"]
                and got >= UMAP_TRUST_SLACK * edge):
            raise AssertionError(f"sharded_umap on {name} shards: "
                                 f"trustworthiness {got} < 0.99 x {edge}")
    edge_oracle_gate(u["edge_vs_oracle"])
    if not u["edge_tier"]["bits_equal_across_runs"]:
        raise AssertionError("two runs of the UMAP edge tier differ")


def check_repulsion_scenes(y, n: int, calls: int, twin_calls: int,
                           clock_hz) -> dict:
    """tsne_repulsion on y [S, Npad, 2] in one launch: each scene's rows
    bit-equal to its one-scene call, the first and last scene against the
    twin; the batched time beside the S one-scene calls' and the twin's."""
    import torch
    from sph_tpu_torch.ops.tsne_kernels import (tsne_repulsion_reference,
                                                tsne_repulsion_rows)
    s, npad, _ = y.shape
    rep, zrow = tsne_repulsion_rows(y, n)
    scenes = [y[i].contiguous() for i in range(s)]
    for i in range(s):
        r1, z1 = tsne_repulsion_rows(scenes[i], n)
        if not (torch.equal(rep[i], r1) and torch.equal(zrow[i], z1)):
            raise AssertionError(f"batched tsne_repulsion scene {i} differs "
                                 "from its one-scene call")
    err = scale = 0.0
    for i in (0, s - 1):
        ref_rep, _ = tsne_repulsion_reference(scenes[i], n)
        scale = max(scale, float(ref_rep.abs().max()))
        err = max(err, float((rep[i] - ref_rep).abs().max()))
    if not err <= 1e-5 * scale:
        raise AssertionError(f"batched tsne_repulsion: error {err} > 1e-5 x "
                             f"{scale}")
    b = bound(repulsion_scene_bytes(s, npad),
              REPULSION_FLOPS_PER_PAIR * s * n * n)
    return {"n": n, "npad": npad, "scenes": s, "max_abs_err": err,
            "rep_err_over_max": err / scale,
            "scenes_bit_equal_to_one_scene_calls": True,
            "ms": cuda_ms(lambda: tsne_repulsion_rows(y, n), calls),
            "ms_one_scene_calls": cuda_ms(
                lambda: [tsne_repulsion_rows(v, n) for v in scenes],
                max(1, calls // s)),
            "ms_one_scene": cuda_ms(lambda: tsne_repulsion_rows(
                scenes[0], n), calls),
            "plain_ms": cuda_ms(lambda: tsne_repulsion_reference(y, n),
                                twin_calls, warmup=1),
            "sfu_floor_ms": s * sfu_floor_ms(
                n, torch.cuda.get_device_properties(0).multi_processor_count,
                clock_hz), **b}


def repulsion_scene_bytes(s: int, npad: int) -> int:
    """Bytes a batched tsne_repulsion moves: y read, rep and zrow
    written once, for each scene."""
    return s * (8 * npad + 12 * npad)


def check_repulsion_window(y, n: int, shards: int, calls: int,
                           clock_hz) -> dict:
    """tsne_repulsion over the row windows of a `shards`-way split of y:
    each window's rows bit-equal to the full call's, against the twin on
    those rows; each window's time beside the full call's."""
    import torch
    from sph_tpu_torch.ops.tsne_kernels import (tsne_repulsion_reference,
                                                tsne_repulsion_rows)
    npad = y.shape[0]
    full_rep, full_z = tsne_repulsion_rows(y, n)
    step = npad // shards
    err = scale = 0.0
    ms = []
    for i in range(shards):
        rows = (i * step, (i + 1) * step)
        rep, zrow = tsne_repulsion_rows(y, n, rows=rows)
        if not (torch.equal(rep, full_rep[rows[0]:rows[1]])
                and torch.equal(zrow, full_z[rows[0]:rows[1]])):
            raise AssertionError(f"tsne_repulsion window {rows} differs from "
                                 "the full call's rows")
        sample = (rows[0], rows[0] + 1024)
        ref_rep, _ = tsne_repulsion_reference(y, n, rows=sample)
        scale = max(scale, float(ref_rep.abs().max()))
        err = max(err, float((rep[:1024] - ref_rep).abs().max()))
        ms.append(cuda_ms(lambda: tsne_repulsion_rows(y, n, rows=rows),
                          calls))
    if not err <= 1e-5 * scale:
        raise AssertionError(f"windowed tsne_repulsion: error {err} > 1e-5 x "
                             f"{scale}")
    b = bound(repulsion_scene_bytes(1, npad) // shards + 8 * npad,
              REPULSION_FLOPS_PER_PAIR * n * n / shards)
    return {"n": n, "npad": npad, "windows": shards, "max_abs_err": err,
            "rep_err_over_max": err / scale, "rows_bit_equal_to_full": True,
            "ms": ms[0], "ms_by_window": ms,
            "ms_full": cuda_ms(lambda: tsne_repulsion_rows(y, n), calls),
            "plain_ms": cuda_ms(lambda: tsne_repulsion_reference(
                y, n, rows=(0, step)), 2, warmup=1),
            "sfu_floor_ms": sfu_floor_ms(
                n, torch.cuda.get_device_properties(0).multi_processor_count,
                clock_hz) / shards, **b}


def pines_hierarchy(device: str, shape=(145, 145, 200)):
    """The bench.py:89-136 configuration at 145x145x200 (or `shape`) as an
    initialised (not yet computed) ComputeHierarchy; returns it with its
    level settings and the data matrix."""
    import sph_tpu_torch as T
    from sph_tpu_torch.utils.testdata import create_hyperspectral_scene
    rows, cols, bands = shape
    img = create_hyperspectral_scene(rows, cols, bands, seed=7)
    data = T.scale(T.ImageStack.from_array(img, name="pines_synth").data,
                   T.Scaler.NONE)
    k = 91
    lss_main = T.LevelSimilaritiesSettings(
        component_sim=T.ComponentSim.NEIGH_WALKS, ks=[k],
        random_walk_pair_sims=True,
        normalize_prob_dist=T.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=T.NormalizationScheme.TSNE)
    ch = T.ComputeHierarchy(device=device).init(
        data, rows, cols,
        ihs=T.ImageHierarchySettings(
            component_sim=T.ComponentSim.NEIGH_WALKS,
            merge_multiple=False, use_percentile=False, max_dist=0.0,
            min_num_comp=1, min_reduction=98.0, max_levels=10,
            rw_handling=T.RandomWalkHandling.MERGE_RW_ONLY,
            rw_reduction=T.RandomWalkReduction.PROPORTIONAL_COMPONENT_REDUCTION,
            norm_knn_distances=T.NormalizationScheme.TSNE),
        lss=lss_main,
        rws=T.RandomWalkSettings(
            num_random_walks=50, single_walk_length=10,
            importance_weighting=T.ImportanceWeighting.NORMAL,
            random_seed=1),
        nns=T.NearestNeighborsSettings(
            num_nearest_neighbors=k, symmetric_neighbors=True,
            compute_connect_components=True,
            neighbor_connect_components=True))
    return ch, lss_main, data


def main() -> int:
    started = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    count = torch.cuda.device_count()
    if count != 1:
        print(f"chip_smoke: needs exactly one visible card, found {count}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import sph_tpu_torch as T
    from sph_tpu_torch import native
    from sph_tpu_torch.ops import shortest_path as sp
    from sph_tpu_torch.ops import device_merge, tsne_kernels, walk_sort
    from sph_tpu_torch.ops import walks as twalks
    from sph_tpu_torch.utils.logging import set_level
    set_level("WARNING")

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = tsne_kernels.build()      # one nvcc per kernel, all at once
    build_s = time.perf_counter() - t0
    for name, so in libs.items():
        emit({"phase": "build", "kernel": name, "seconds": build_s,
              "built_together": sorted(libs), "library": os.path.basename(so)})
    # the host graph ops (g++), built here so no stage below times the build
    t0 = time.perf_counter()
    native.get_lib()
    emit({"phase": "build", "library": "graphops (host, g++)",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    native.xla_sort_order(np.zeros((1, 1), np.int32))
    emit({"phase": "build", "library": "xla_sort (host, g++)",
          "seconds": time.perf_counter() - t0})

    # the kernel's branch-free reciprocal against IEEE 1 / x on every
    # float32 in [1, 2^126): one launch
    t0 = time.perf_counter()
    rcp_bad = tsne_kernels.forces_rcp_mismatches()
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "reciprocal_mismatches_in_1_to_2e126": rcp_bad,
          "seconds": time.perf_counter() - t0})
    if rcp_bad:
        raise AssertionError(f"tsne_forces_dense: the reciprocal differs "
                             f"from IEEE 1 / x on {rcp_bad} floats")
    checks = [check_forces_kernel(n, npad, seed=11 + i)
              for i, (n, npad) in enumerate(FORCES_SHAPES)]
    for c in checks:
        emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense", **c})

    clock_hz = sm_clock_hz()
    rep_checks = []
    for n, npad, calls, twin_calls, sampled in REPULSION_SHAPES:
        y = torch.from_numpy(repulsion_layout(n, npad, seed=n)).cuda()
        rep_checks.append(check_repulsion_kernel(
            y, n, calls, twin_calls, sampled, clock_hz))
        del y
        emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
              **rep_checks[-1], **({} if twin_calls else {
                  "plain_ms": "not measured: a full twin call at this size "
                              "takes tens of seconds"})})

    # walk_row_sort: each of its paths on synthetic rows (the heap path
    # included), at each path's limit and one key past it, and at the
    # explorer's widest rows; the paths' own visit records follow in
    # eval_pines_walks
    t0 = time.perf_counter()
    sort_checks = []
    for cols in (WALK_SORT_COLS, walk_sort.WARP_COLS,
                 walk_sort.WARP_COLS + 1, WALK_SORT_BLOCK_COLS,
                 walk_sort.STAGE_COLS, walk_sort.STAGE_COLS + 1):
        sort_checks.append(check_walk_sort(
            walk_sort, native, walk_sort_synthetic(walk_sort, cols),
            f"synthetic_{cols}: equal, sorted, reversed, adversary",
            repeats=5 if cols <= WALK_SORT_BLOCK_COLS else 2))
    sort_checks.append(check_walk_sort(
        walk_sort, native, walk_like_rows(*WALK_SORT_WIDE),
        "explorer_wide_500_walks_x_100_steps", repeats=5))
    sort_checks.append(check_walk_sort(
        walk_sort, native, walk_like_rows(*WALK_SORT_EXPLORER),
        "explorer_widest_answer_pines_level_1", repeats=3,
        sample=WALK_SORT_SAMPLED))
    torch.cuda.empty_cache()
    for c in sort_checks:
        emit({"phase": "kernel_vs_twin", "kernel": "walk_row_sort", **c,
              "seconds_all": time.perf_counter() - t0})

    # ---- the main path: bench.py:89-136 at full size --------------------
    ch, lss_main, data = pines_hierarchy("cuda")
    tsne_kernels.tsne_forces_dense.launches = 0
    tsne_kernels.tsne_repulsion.launches = 0
    walk_sort.xla_sort_order.launches = 0
    device_merge.merge_runs.launches = 0
    seconds = {}
    pines_merges = {}
    with merge_record(pines_merges):
        for name, stage in (("stage1_knn", ch.compute_knn_graph),
                            ("stage2_hierarchy", ch.compute_image_hierarchy),
                            ("stage3_level_similarities",
                             ch.compute_level_similarities)):
            t = time.perf_counter()
            stage()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
    main_sort_launches = walk_sort.xla_sort_order.launches
    merge_launches = {"pines": device_merge.merge_runs.launches}
    if not main_sort_launches:
        raise AssertionError("walk_row_sort: the Pines path's NORMAL walks "
                             "launched it no time")
    if not merge_launches["pines"]:
        raise AssertionError("merge_runs: the Pines path's walk-row merges "
                             "launched it no time")
    levels = list(ch.image_hierarchy.hierarchy.num_components)
    p1 = ch.level_similarities.get_prob_dist(1)
    iters = 2000
    es = T.ComputeEmbeddingSettings()
    es.tsne.num_iterations = iters
    ce = T.ComputeEmbedding(es, device="cuda")
    t = time.perf_counter()
    emb = ce.compute_tsne(p1, track_kl=True)
    torch.cuda.synchronize()
    seconds["tsne"] = time.perf_counter() - t
    launches = tsne_kernels.tsne_forces_dense.launches
    main_rep_launches = tsne_kernels.tsne_repulsion.launches
    kl = float(ce.last_kl)
    emit({"phase": "main", "levels": levels, "level_1_kl": kl,
          "seconds": seconds, "tsne_iterations": iters,
          "tsne_iters_per_s": iters / seconds["tsne"],
          "tsne_tier": ce.last_computation.tier,
          "tsne_forces_dense_launches": launches,
          "tsne_repulsion_launches": main_rep_launches,
          "walk_row_sort_launches": main_sort_launches,
          "merge_runs_launches": merge_launches["pines"],
          "merges": merge_summary(pines_merges, "first")})

    # the kernel once more at the level-1 size the main path just gave it
    from sph_tpu_torch.models.tsne import dense_npad
    checks.append(check_forces_kernel(levels[1], dense_npad(levels[1]),
                                      seed=13))
    main_shape = checks[-1]
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "main_path_shape": True, **checks[-1]})
    # merge_runs and the whole device merge at the Pines path's level-0 ->
    # 1 walk-row merge, and again with a cap that bites and is not a power
    # of two; the symmetrization of its kNN graph both ways
    merge_checks = [check_merge(pines_merges["inputs"],
                                "pines_level_0_to_1")]
    cap_inputs = pines_merges.pop("inputs")
    cut = int(merge_checks[0]["untruncated_width"] * MERGE_CAP_SHARE) | 1
    merge_checks.append(check_merge((*cap_inputs[:5], cut),
                                    f"pines_level_0_to_1_cap_{cut}"))
    del cap_inputs
    if not merge_checks[-1]["cap_bites"]:
        raise AssertionError(f"merge_runs: the cap {cut} does not bite")
    sym_checks = [check_symmetrize(pines_merges.pop("knn"), "pines_knn_91")]
    for c in merge_checks:
        emit({"phase": "kernel_vs_twin", "kernel": "merge_runs", **c})
    emit({"phase": "kernel_vs_twin", "kernel": "symmetrize_graph_device",
          **sym_checks[-1]})

    # ---- checks ----------------------------------------------------------
    if not all(a > b for a, b in zip(levels, levels[1:])):
        raise AssertionError(f"component counts do not decrease: {levels}")
    if len(levels) < 2 or levels[1] <= 1:
        raise AssertionError(f"level 1 has no structure: {levels}")
    # the t-SNE input is the symmetrized (P + P^T) / 2: symmetric, with the
    # total mass of the conditional rows, each of which sums to 1
    dense = torch.from_numpy(p1.to_dense())
    asym = float((dense - dense.T).abs().max())
    if not asym <= 1e-6:
        raise AssertionError(f"level-1 P is not symmetric: {asym}")
    mean_sum = float(dense.sum()) / levels[1]
    if not abs(mean_sum - 1.0) <= 1e-3:
        raise AssertionError(f"level-1 P mass {mean_sum} per row, not 1")
    lss = T.LevelSimilaritiesSettings(
        component_sim=T.ComponentSim.NEIGH_WALKS,
        ks=list(lss_main.ks), level_to_compute=1,
        random_walk_pair_sims=True,
        normalize_prob_dist=T.NormalizationScheme.TSNE,
        compute_symmetric_prob_dist=T.NormalizationScheme.NONE)
    cond = T.LevelSimilarities(ch.image_hierarchy.hierarchy,
                               ch.knn_stage.connected_graph, data, lss,
                               device="cuda")
    cond.set_image_hierarchy(ch.image_hierarchy)
    cond.compute(lss)
    sums = cond.get_prob_dist(1).row_sums()
    if not np.all(np.abs(sums - 1.0) <= 1e-3):
        raise AssertionError("level-1 conditional P rows do not sum to 1: "
                             f"worst {float(np.abs(sums - 1.0).max())}")
    if not np.all(np.isfinite(emb)):
        raise AssertionError("the embedding is not finite")
    if launches < iters:
        raise AssertionError(f"tsne_forces_dense launched {launches} times "
                             f"in {iters} iterations")
    if main_rep_launches < 1:
        raise AssertionError("tsne_repulsion did not give the level-1 KL "
                             "its Z")
    with open(os.path.join(REPO, "docs", "anchors_pines.json")) as f:
        anchor = json.load(f)["kl_under_p_sklearn_bh"]
    if not kl <= KL_SLACK * anchor:
        raise AssertionError(f"level-1 KL {kl} > {KL_SLACK} x anchor {anchor}")
    with open(os.path.join(REPO, "docs",
                           "torch_port_pines_reference.json")) as f:
        ref = json.load(f)
    ref_levels = ref["levels"]
    if abs(levels[1] - ref_levels[1]) > LEVEL1_TOLERANCE * ref_levels[1]:
        raise AssertionError(f"level-1 count {levels[1]} not within 2 % of "
                             f"the JAX record {ref_levels[1]}")
    if abs(len(levels) - len(ref_levels)) > 1:
        raise AssertionError(f"{len(levels)} levels vs {len(ref_levels)} in "
                             "the JAX record")
    if ce.last_computation.tier != "dense":
        raise AssertionError("the Pines level 1 did not take the dense tier")
    emit({"phase": "checks", "passed": True, "kl_gate": KL_SLACK * anchor,
          "jax_cpu_levels": ref_levels, "jax_cpu_level_1_kl":
              ref["level_1_kl"]})

    # ---- UMAP of the same level 1, packed (the default) and float32 -------
    with open(os.path.join(REPO, "docs",
                           "torch_port_pines_umap_reference.json")) as f:
        umap_ref = json.load(f)
    with open(os.path.join(REPO, "docs",
                           "torch_port_packed_reference.json")) as f:
        packed_ref = json.load(f)
    # each run against the JAX-CPU record made with the same gathers
    umap_gates = {True: [packed_ref["trustworthiness_k10"],
                         umap_ref["trustworthiness_k10"]],
                  False: [umap_ref["runs"]["unpacked"]["trustworthiness_k10"]]}
    umap_runs = {}
    for packed in (True, False):
        zero_launches(tsne_kernels)
        umap = pines_umap(ch, data, packed=packed)
        umap_runs[packed] = umap
        emit({"phase": "umap", **{k: v for k, v in umap.items() if k != "emb"},
              "jax_cpu_trustworthiness_k10": umap_gates[packed],
              "launches": read_launches(tsne_kernels)})
        if umap["tier"] != "rows" or umap["n"] != levels[1]:
            raise AssertionError(f"UMAP of level 1 took the {umap['tier']} "
                                 "tier")
        if umap["packed"] != packed:
            raise AssertionError(f"UMAP of level 1 packed {umap['packed']}")
        if not np.all(np.isfinite(umap["emb"])):
            raise AssertionError("the UMAP embedding is not finite")
        for want in umap_gates[packed]:
            if not umap["trustworthiness_k10"] >= UMAP_TRUST_SLACK * want:
                raise AssertionError(
                    f"UMAP (packed {packed}) trustworthiness "
                    f"{umap['trustworthiness_k10']} < {UMAP_TRUST_SLACK} x "
                    f"the JAX package's {want}")
    umap = umap_runs[True]

    # ---- the live explorer server on the same hierarchy -----------------
    t = time.perf_counter()
    walk_sort.xla_sort_order.launches = 0
    live = explorer(ch, emb)
    sort_launches = {"explorer": walk_sort.xla_sort_order.launches}
    emit({"phase": "explorer", **live,
          "walk_row_sort_launches": sort_launches["explorer"],
          "seconds": time.perf_counter() - t})
    h1 = ch.image_hierarchy.hierarchy
    pines_l1 = {"data": data, "p1": p1, "labels": h1.pixel_components[1],
                "count": h1.num_components[1]}
    del ch, cond, dense, emb, ce, umap, umap_runs, h1

    # ---- default level settings: the approximate kNN tiers on the path ---
    walk_sort.xla_sort_order.launches = 0
    scene = scene_overlap(tsne_kernels)
    sort_launches["scene_overlap"] = walk_sort.xla_sort_order.launches
    with open(os.path.join(REPO, "docs",
                           "torch_port_scene_overlap_reference.json")) as f:
        scene_ref = json.load(f)
    emit({"phase": "scene_overlap", **scene,
          "jax_cpu_levels": scene_ref["levels"],
          "jax_cpu_stage1_recall_sampled_rows":
              scene_ref["stage1_recall_at_91"],
          "jax_cpu_level_1_component_knn_recall":
              scene_ref["level_1_component_knn_recall"],
          "approx_knn_threshold": scene_ref["approx_knn_threshold"]})
    s_levels, s_ref = scene["levels"], scene_ref["levels"]
    if scene["size"] != scene_ref["size"]:
        raise AssertionError(f"scene_overlap at {scene['size']}, the JAX "
                             f"record at {scene_ref['size']}")
    if abs(s_levels[1] - s_ref[1]) > LEVEL1_TOLERANCE * s_ref[1]:
        raise AssertionError(f"scene_overlap level 1 {s_levels[1]} not "
                             f"within 2 % of the JAX record {s_ref[1]}")
    if abs(len(s_levels) - len(s_ref)) > 1:
        raise AssertionError(f"scene_overlap: {len(s_levels)} levels vs "
                             f"{len(s_ref)} in the JAX record")
    deep_levels_gate(s_levels, s_ref, "scene_overlap")
    if not (s_levels[1] > scene_ref["approx_knn_threshold"]
            and scene["knn_tiers"][1] == "approximate"):
        raise AssertionError("scene_overlap level 1 did not take the "
                             "approximate component kNN: "
                             f"{scene['knn_tiers']}")
    if not scene["level_1_component_knn_recall"] >= (
            scene_ref["level_1_component_knn_recall"] - RECALL_SLACK):
        raise AssertionError(
            f"level-1 component kNN recall "
            f"{scene['level_1_component_knn_recall']} < the JAX record's "
            f"{scene_ref['level_1_component_knn_recall']} - {RECALL_SLACK}")
    s_kl = scene["kl_at"]
    if scene["tsne_tier"] != "dense":
        raise AssertionError(f"scene_overlap level 1 took the "
                             f"{scene['tsne_tier']} t-SNE tier")
    if scene["launches"]["tsne_forces_dense"] < scene["tsne_iterations"]:
        raise AssertionError("tsne_forces_dense launched "
                             f"{scene['launches']['tsne_forces_dense']} "
                             f"times in {scene['tsne_iterations']} iterations")
    if not (np.all(np.isfinite(list(s_kl.values())))
            and s_kl[str(scene["tsne_iterations"])] < s_kl["0"]):
        raise AssertionError(f"scene_overlap KL not finite and falling: "
                             f"{s_kl}")
    if not scene["embedding_finite"]:
        raise AssertionError("the scene_overlap embedding is not finite")
    if not scene["exact_component_knn_peak_bytes"] <= EXACT_OVERLAP_PEAK_MAX:
        raise AssertionError(
            "the exact NEIGH_OVERLAP kNN of level 1 held "
            f"{scene['exact_component_knn_peak_bytes']} bytes above what "
            f"was allocated before it, over {EXACT_OVERLAP_PEAK_MAX}")

    # tsne_forces_dense at the level-1 shape scene_overlap gave it
    checks.append(check_forces_kernel(s_levels[1], dense_npad(s_levels[1]),
                                      seed=14, calls=50))
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "path_shape": "scene_overlap", **checks[-1]})

    # ---- EUCLID_CENTROID in both stages, Salinas-shaped -----------------
    sal = salinas_euclid(tsne_kernels)
    with open(os.path.join(REPO, "docs",
                           "torch_port_salinas_euclid_reference.json")) as f:
        sal_ref = json.load(f)
    emit({"phase": "salinas_euclid", **sal,
          "jax_cpu_levels": sal_ref["levels"],
          "jax_cpu_level_1_component_knn_recall":
              sal_ref["level_1_component_knn_recall"],
          "approx_knn_threshold": sal_ref["approx_knn_threshold"]})
    sal_levels = sal["levels"]
    checks.append(check_forces_kernel(sal_levels[1],
                                      dense_npad(sal_levels[1]), seed=15,
                                      calls=50))
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "path_shape": "salinas_euclid", **checks[-1]})
    salinas_gates(sal, sal_ref)

    # ---- NEIGH_WALKS on the Salinas-shaped scene, two walk handlings -----
    with open(os.path.join(REPO, "docs",
                           "torch_port_salinas_walks_reference.json")) as f:
        salw_ref = json.load(f)
    t = time.perf_counter()
    walk_sort.xla_sort_order.launches = 0
    device_merge.merge_runs.launches = 0
    salw_merges = {}
    with merge_record(salw_merges):
        salw = salinas_walks(tsne_kernels)
    sort_launches["salinas_walks"] = walk_sort.xla_sort_order.launches
    merge_launches["salinas_walks"] = device_merge.merge_runs.launches
    salw["seconds_total"] = time.perf_counter() - t
    emit({"phase": "salinas_walks", **salw,
          "merge_runs_launches": merge_launches["salinas_walks"],
          "merges": merge_summary(salw_merges, "widest"),
          "jax_cpu": salw_ref["runs"]})
    if not merge_launches["salinas_walks"]:
        raise AssertionError("merge_runs: salinas_walks launched it no time")
    merge_checks.append(check_merge(salw_merges.pop("inputs"),
                                    "salinas_walks_widest"))
    emit({"phase": "kernel_vs_twin", "kernel": "merge_runs",
          **merge_checks[-1]})
    sym_checks.append(check_symmetrize(salw_merges.pop("knn"),
                                       "salinas_knn_31"))
    emit({"phase": "kernel_vs_twin", "kernel": "symmetrize_graph_device",
          **sym_checks[-1]})
    torch.cuda.empty_cache()
    salw_n = salw["rw_only"]["levels"][1]
    checks.append(check_forces_kernel(salw_n, dense_npad(salw_n), seed=17,
                                      calls=50))
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
          "path_shape": "salinas_walks", **checks[-1]})
    y = torch.from_numpy(repulsion_layout(salw_n, dense_npad(salw_n),
                                          seed=salw_n)).cuda()
    rep_checks.append(check_repulsion_kernel(y, salw_n, 50, 5,
                                             clock_hz=clock_hz))
    del y
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
          "path_shape": "salinas_walks_kl", **rep_checks[-1]})
    emit({"phase": "salinas_walks_gates", **salinas_walks_gates(
        salw, salw_ref)})

    # ---- GEO_CENTROID in both stages, 240x240 RGB ------------------------
    t = time.perf_counter()
    geo = rgb_geo(tsne_kernels)
    geo_objects = geo.pop("objects")
    emit({"phase": "rgb_geo", **geo})
    rgb_geo_gates(geo, 2000)
    # bellman_ford_relax against its twin at the path's shapes
    relax = relax_checks(geo_objects)
    del geo_objects
    for c in relax["checks"]:
        emit({"phase": "kernel_vs_twin", "kernel": "bellman_ford_relax",
              **c})
    emit({"phase": "kernel_vs_twin", "kernel": "bellman_ford_relax",
          "path_shape": "rgb_geo_level_0_pair_batch_converge",
          **relax["pair_batch"]})
    emit({"phase": "kernel_vs_twin", "kernel": "bellman_ford_relax",
          "path_shape": "rgb_geo_contracted_level_1_batch_converge",
          **relax["component_batch"]})
    for c in relax["batches"]:
        emit({"phase": "kernel_vs_twin", "kernel": "bellman_ford_relax",
              "delta": True, **c})
    # both kernels at the shapes rgb_geo's t-SNE levels gave them
    for level, run in geo["tsne"].items():
        checks.append(check_forces_kernel(run["n"], run["npad"],
                                          seed=16 + level, calls=50))
        emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
              "path_shape": f"rgb_geo_level_{level}", **checks[-1]})
        y = torch.from_numpy(repulsion_layout(run["n"], run["npad"],
                                              seed=run["n"])).cuda()
        rep_checks.append(check_repulsion_kernel(y, run["n"], 50, 5,
                                                 clock_hz=clock_hz))
        del y
        emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
              "path_shape": f"rgb_geo_level_{level}_kl", **rep_checks[-1]})
    with open(os.path.join(REPO, "docs",
                           "torch_port_rgb_geo_reference.json")) as f:
        geo_ref = json.load(f)
    sp.relax.launches = 0
    record = rgb_geo_record(geo_ref)
    record_relax_launches = sp.relax.launches
    emit({"phase": "rgb_geo_record",
          **{cs: {k: v for k, v in r.items() if k not in (
              "knn", "sketch_pairs", "replayed_sketch_hausdorff")}
             for cs, r in record.items()},
          "gates": rgb_geo_record_gates(record, geo_ref),
          "seconds_with_rgb_geo": time.perf_counter() - t})

    # ---- the 1M path: BASELINE config 4, one kNN graph for both tiers ----
    graph = scene_graph(1000, 1000)
    n_large = graph["idx"].shape[0]
    emit({"phase": "large_graph", "n": n_large, "d": graph["data"].shape[1],
          "k": graph["idx"].shape[1], "seconds": graph["seconds"],
          "knn_peak_memory_bytes": graph["knn_peak"]})
    idx, dist = graph["idx"], graph["dist"]
    graph_invariants(idx, dist, "kNN")
    if not np.all(dist[:, 0] == 0):
        raise AssertionError("kNN: the self distance is not 0")
    sample = np.sort(np.random.default_rng(3).choice(n_large, 1024,
                                                     replace=False))
    exact = knn_exactness(graph["data"], idx, idx.shape[1], sample)
    emit({"phase": "large_graph_checks", "passed": True,
          "knn_exactness": exact})

    # the same scene on its size tier, the approximate kNN (flat IVF)
    livf = large_ivf(graph)
    emit({"phase": "large_ivf", **livf})
    if not livf["bits_equal_across_runs"]:
        raise AssertionError("large_ivf: two runs differ")

    # the default tier (grid) at the reference's depth
    grid = grid_path(tsne_kernels, graph, GRID_ITERS, GRID_KL_AT)
    gcomp = grid["ce"].last_computation
    zero_launches(tsne_kernels)
    gap = z_gap(gcomp)
    gap["launches"] = read_launches(tsne_kernels)
    split = grid_split(gcomp)
    repeat = scatter_repeatability(gcomp)
    # tsne_attraction at the 1M grid tier's P and final layout
    att_checks = [{"path_shape": "large_grid", **check_attraction_kernel(
        gcomp._y, gcomp._p_idx32, gcomp._p_val)}]
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_attraction",
          **att_checks[-1]})
    # grid_deposit and grid_interpolate at the final layout on its grid and
    # at the layout of iteration GRID_LAYOUT_AT on its (the 128) grid,
    # where the clusters crowd the cells
    kept = grid["kept_layout"]
    grid_checks = [check_grid_kernels(gcomp._y, n_large, gcomp._grid,
                                      "large_grid_final"),
                   check_grid_kernels(kept["y"], n_large, kept["grid"],
                                      f"large_grid_iteration_"
                                      f"{kept['iteration']}")]
    del kept["y"]
    for dep, interp in grid_checks:
        emit({"phase": "kernel_vs_twin", "kernel": "grid_deposit", **dep})
        emit({"phase": "kernel_vs_twin", "kernel": "grid_interpolate",
              **interp})
    kls = grid["kls"]
    emit({"phase": "large_grid", "n": n_large, "tsne_tier": gcomp.tier,
          "tsne_iterations": GRID_ITERS, "seconds": grid["seconds"],
          "tsne_iters_per_s": GRID_ITERS / grid["seconds"]["tsne"],
          "p_width": gcomp._p_val.shape[1],
          "grid_sizes": grid_sizes(gcomp.grid_history),
          "grid_picks": len(gcomp.grid_history),
          "points_in_fullest_cell_by_grid": grid["fullest_cell_by_grid"],
          "repulsion_bound_at_last_grid": grid_repulsion_bound(
              n_large, gcomp._npad, gcomp.grid_history[-1][1]),
          "kl_at": {str(i): v for i, v in sorted(kls.items())},
          "kl_final_exact_z": kls[GRID_ITERS] + gap["log_z_ratio"],
          "z": gap, "ms_per_iteration_by_part": split,
          "step_ms_with_index_add_deposit": GRID_STEP_MS_INDEX_ADD,
          "scatter_repeatability": repeat,
          "peak_memory_bytes": grid["peak_memory_bytes"],
          "embedding_max_abs": float(np.abs(grid["emb"]).max()),
          "launches": grid["launches"],
          "iteration_launches": grid["iteration_launches"],
          "kl_launches_each": grid["kl_launches"][0],
          "kls_taken": len(grid["kl_launches"]) + 1})
    grid_att_launches = grid["launches"]["tsne_attraction"]
    grid_launches = grid["iteration_launches"]
    grid_kl_each = grid["kl_launches"][0]
    grid_kls = len(grid["kl_launches"]) + 1
    if not repeat["bits_equal"]:
        raise AssertionError(f"the grid tier's repulsion differs from call "
                             f"to call: {repeat}")
    if gcomp.tier != "grid":
        raise AssertionError(f"the 1M default took the {gcomp.tier} tier")
    grid_launch_gate(grid_launches, grid["kl_launches"], GRID_ITERS)
    if not gcomp.attr_packed:
        raise AssertionError("the 1M grid tier did not pack its gathers")
    if not kls[GRID_ITERS] < kls[0]:
        raise AssertionError(f"grid tier: KL {kls[GRID_ITERS]} not below "
                             f"iteration 0's {kls[0]}")
    if gap["launches"]["tsne_repulsion"] != 1:
        raise AssertionError("the exact Z at 1M did not come from "
                             "tsne_repulsion")
    if not gap["z_rel_gap"] <= Z_GAP_MAX:
        raise AssertionError(f"grid Z {gap['z_grid']} vs exact "
                             f"{gap['z_exact']}: gap {gap['z_rel_gap']}")
    if not (np.all(np.isfinite(grid["emb"]))
            and grid["emb"].shape == (n_large, 2)):
        raise AssertionError("the 1M grid embedding is not finite [N, 2]")
    if bool((gcomp._y[n_large:] != 0).any()):
        raise AssertionError("the 1M grid embedding's pad rows are not 0")
    del grid, gcomp

    # the exact tier, cut in depth
    with env(SPH_TSNE_GRID="0"):          # the exact tier above 32768
        large = large_path(tsne_kernels, LARGE_ITERS, graph=graph)
        comp = large["ce"].last_computation
        # the KL at iteration 0, computed the same way: the path's P at the
        # initial layout
        t = time.perf_counter()
        t0_tsne = T.TsneComputation(large["es"].tsne, device="cuda")
        t0_tsne.set_probability_distribution(comp._p)
        from sph_tpu_torch.ops.math import random_disk_init
        t0_tsne.set_initial_embedding(random_disk_init(n_large, 0.1, 0))
        t0_tsne._init_gradient_descent()
        kl0 = t0_tsne.kl_divergence()
        kl0_s = time.perf_counter() - t
        t0_tier = t0_tsne.tier
        del t0_tsne
    sec = large["seconds"]
    large_launches = large["launches"]
    emit({"phase": "large", "n": n_large, "d": large["data"].shape[1],
          "k": large["idx"].shape[1],
          "perplexity": large["es"].tsne.perplexity,
          "tsne_tier": comp.tier,
          "tsne_iterations": LARGE_ITERS, "seconds": sec,
          "seconds_total": sum(sec.values()),
          "tsne_iters_per_s": LARGE_ITERS / sec["tsne"],
          "kl_iteration_0": kl0, "kl_iteration_0_seconds": kl0_s,
          "kl_final": large["kl"],
          "embedding_max_abs": float(np.abs(large["emb"]).max()),
          "launches": large_launches})

    # ---- checks of the exact tier at 1M ----------------------------------
    emb = large["emb"]
    pc = p_checks(comp._p, idx, dist, large["es"].tsne.perplexity)
    if comp.tier != "exact" or t0_tier != "exact":
        raise AssertionError(f"the 1M path took the {comp.tier} tier")
    if large_launches["tsne_forces_dense"] != 0:
        raise AssertionError("tsne_forces_dense launched on the 1M path")
    for name in ("tsne_repulsion", "tsne_attraction"):
        if large_launches[name] < LARGE_ITERS:
            raise AssertionError(f"{name} launched {large_launches[name]} "
                                 f"times in {LARGE_ITERS} iterations")
    if not large["kl"] < kl0:
        raise AssertionError(f"KL {large['kl']} not below iteration 0's "
                             f"{kl0}")
    if not np.all(np.isfinite(emb)) or emb.shape != (n_large, 2):
        raise AssertionError("the 1M embedding is not finite [N, 2]")
    if bool((comp._y[n_large:] != 0).any()):
        raise AssertionError("the 1M embedding's pad rows are not 0")
    # the kernel once more, at the embedding the path produced
    rep_checks.append(check_repulsion_kernel(comp._y.contiguous(), n_large,
                                             sampled=True))
    emit({"phase": "large_checks", "passed": True, **pc,
          "npad": comp._npad,
          "kernel_vs_twin_at_final_embedding": rep_checks[-1]})
    del large, comp, graph, emb

    # ---- the grid against the exact tier at 65536 points -----------------
    mid = grid_vs_exact(tsne_kernels, iters=MID_ITERS)
    emit({"phase": "grid_vs_exact",
          **{k: v for k, v in mid.items()
             if k not in ("exact_computation", "grid_computation")}})
    if mid["grid"]["tier"] != "grid" or mid["exact"]["tier"] != "exact":
        raise AssertionError(f"65536 points took the {mid['grid']['tier']} "
                             f"and {mid['exact']['tier']} tiers")
    if mid["grid"]["p_width"] != mid["exact"]["p_width"]:
        raise AssertionError("65536 points: the tiers ran on different P")
    if mid["exact"]["launches"]["tsne_repulsion"] < MID_ITERS:
        raise AssertionError("tsne_repulsion did not run every exact "
                             "iteration at 65536 points")
    for tier in ("grid", "exact"):
        if mid[tier]["launches"]["tsne_attraction"] != MID_ITERS:
            raise AssertionError(f"tsne_attraction did not run every {tier}"
                                 " iteration at 65536 points")
    # tsne_attraction at grid_vs_exact's P and the exact tier's layout, in
    # two shard windows
    ex = mid["exact_computation"]
    att_checks.append({"path_shape": "grid_vs_exact",
                       **check_attraction_kernel(ex._y, ex._p_idx32,
                                                 ex._p_val, calls=50,
                                                 twin_calls=10)})
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_attraction",
          **att_checks[-1]})
    if not mid["kl_ratio"] <= KL_RATIO_MAX:
        raise AssertionError(f"KL_grid / KL_exact = {mid['kl_ratio']} > "
                             f"{KL_RATIO_MAX} at 65536 points")
    for tier in ("grid", "exact"):
        want = MID_ITERS + 1 if tier == "grid" else 0   # the final KL's Z
        for name in ("grid_deposit", "grid_interpolate"):
            if mid[tier]["launches"][name] != want:
                raise AssertionError(f"grid_vs_exact {tier}: {name} launched"
                                     f" {mid[tier]['launches'][name]} times,"
                                     f" not {want}")
    # both grid kernels at the grid tier's final layout there
    gx = mid.pop("grid_computation")
    grid_checks.append(check_grid_kernels(gx._y, gx._n, gx._grid,
                                          "grid_vs_exact_final"))
    del gx
    emit({"phase": "kernel_vs_twin", "kernel": "grid_deposit",
          **grid_checks[-1][0]})
    emit({"phase": "kernel_vs_twin", "kernel": "grid_interpolate",
          **grid_checks[-1][1]})

    # ---- BASELINE config 5: 16 scenes batched on the card ---------------
    with open(os.path.join(REPO, "docs",
                           "torch_port_multiscene_reference.json")) as f:
        ms_ref = json.load(f)
    t = time.perf_counter()
    walk_sort.xla_sort_order.launches = 0
    device_merge.merge_runs.launches = 0
    ms_merges = {}
    with merge_record(ms_merges):
        ms = multi_scene(tsne_kernels, ms_ref["full"])
    sort_launches["multi_scene"] = walk_sort.xla_sort_order.launches
    merge_launches["multi_scene"] = device_merge.merge_runs.launches
    del ms["pines"]
    emit({"phase": "multi_scene", **ms,
          "merge_runs_launches": merge_launches["multi_scene"],
          "merges": merge_summary(ms_merges),
          "jax_cpu_levels": ms_ref["full"]["levels"],
          "jax_cpu_seconds": ms_ref["seconds"],
          "seconds_total": time.perf_counter() - t})
    if not merge_launches["multi_scene"]:
        raise AssertionError("merge_runs: multi_scene launched it no time")
    multi_scene_gates(ms, ms_ref["full"])
    ms_n = MULTI_SCENE_SHAPE[0] * MULTI_SCENE_SHAPE[1]
    from sph_tpu_torch.models.tsne import _ceil_to
    ms_npad = _ceil_to(ms_n, 512)
    y = torch.from_numpy(np.stack([repulsion_layout(ms_n, ms_npad, seed=i)
                                   for i in range(MULTI_SCENES)])).cuda()
    rep_scenes = check_repulsion_scenes(y, ms_n, 50, 2, clock_hz)
    del y
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
          "path_shape": "multi_scene_batched", **rep_scenes})
    t = time.perf_counter()
    walk_sort.xla_sort_order.launches = 0
    msr = multi_scene_record(tsne_kernels, ms_ref["record"])
    sort_launches["multi_scene_record"] = walk_sort.xla_sort_order.launches
    emit({"phase": "multi_scene_record", **msr,
          "seconds_total": time.perf_counter() - t})
    multi_scene_record_gates(msr, ms_ref["record"])

    # ---- the sharded entry points on one card: 1 and 2 logical shards ---
    t = time.perf_counter()
    sh = sharded_paths(tsne_kernels, mid, pines_l1, seed_scene(DEV))
    emit({"phase": "sharded", **sh, "seconds_total": time.perf_counter() - t})
    sharded_gates(sh)
    y = torch.from_numpy(repulsion_layout(mid["n"], mid["n"],
                                          seed=mid["n"])).cuda()
    rep_window = check_repulsion_window(y, mid["n"], 2, 20, clock_hz)
    sh_n = mid["n"]
    del y, pines_l1, mid["exact_computation"]
    emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
          "path_shape": "sharded_tsne_window", **rep_window})

    # ---- the approximate tiers' recall at 10^6 points --------------------
    recall = ivf_recall()
    emit({"phase": "ivf_recall", **recall})
    for index, gate in IVF_RECALL_GATES.items():
        if not recall[index]["recall"] >= gate:
            raise AssertionError(f"ivf_recall {index}: recall@16 "
                                 f"{recall[index]['recall']} < {gate}")

    # ---- the evaluation CLI's path: configs/pines_embed.json -----------
    with open(os.path.join(REPO, "docs",
                           "torch_port_eval_pines_reference.json")) as f:
        eval_ref = json.load(f)
    ev_tsne = eval_pines_tsne(tsne_kernels, eval_ref["runs"]["pines_tsne"])
    emit({"phase": "eval_pines_tsne", **ev_tsne})
    ev_umap = eval_pines_umap(tsne_kernels, eval_ref["runs"]["pines_umap"])
    emit({"phase": "eval_pines_umap", **ev_umap})
    ev_record = eval_record(tsne_kernels, eval_ref)
    emit({"phase": "eval_record", **ev_record})
    # both kernels at the shapes the driver's t-SNE levels gave them
    for path, ev in (("eval_pines_tsne", ev_tsne["first"]),
                     ("eval_record_tsne", ev_record["record_tsne"])):
        for e in ev["embeddings"]:
            if e["n"] < 2:
                continue
            n, npad = e["n"], dense_npad(e["n"])
            checks.append(check_forces_kernel(n, npad, seed=21 + e["level"],
                                              calls=20))
            emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
                  "path_shape": f"{path}_level_{e['level']}",
                  **checks[-1]})
            y = torch.from_numpy(repulsion_layout(n, npad, seed=n)).cuda()
            rep_checks.append(check_repulsion_kernel(y, n, 50, 5,
                                                     clock_hz=clock_hz))
            del y
            emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
                  "path_shape": f"{path}_level_{e['level']}_kl",
                  **rep_checks[-1]})
    with open(os.path.join(REPO, "docs",
                           "torch_port_pines_walks_reference.json")) as f:
        walks_ref = json.load(f)
    t = time.perf_counter()
    walk_sort.xla_sort_order.launches = 0
    device_merge.merge_runs.launches = 0
    level0 = {}
    walks_merges = {}
    with first_visit_record(twalks, EVAL_PINES_SHAPE[0] * EVAL_PINES_SHAPE[1],
                            level0), merge_record(walks_merges):
        ev_walks = eval_pines_walks(tsne_kernels, walks_ref)
    sort_launches["eval_pines_walks"] = walk_sort.xla_sort_order.launches
    merge_launches["eval_pines_walks"] = device_merge.merge_runs.launches
    emit({"phase": "eval_pines_walks", **ev_walks,
          "walk_row_sort_launches": sort_launches["eval_pines_walks"],
          "merge_runs_launches": merge_launches["eval_pines_walks"],
          "merges": merge_summary(walks_merges, "first_min"),
          "seconds": time.perf_counter() - t})
    if not merge_launches["eval_pines_walks"] or "inputs" not in walks_merges:
        raise AssertionError("merge_runs: the walk grids launched it "
                             f"{merge_launches['eval_pines_walks']} times, a "
                             "MERGE_DATA_NEW_WALKS min merge seen: "
                             f"{'inputs' in walks_merges}")
    merge_checks.append(check_merge(walks_merges.pop("inputs"),
                                    "eval_pines_walks_merge_data_min"))
    emit({"phase": "kernel_vs_twin", "kernel": "merge_runs",
          **merge_checks[-1]})
    if not sort_launches["eval_pines_walks"] or "ids" not in level0:
        raise AssertionError("walk_row_sort: the walk grids launched it "
                             f"{sort_launches['eval_pines_walks']} times, "
                             f"level 0's record seen: {'ids' in level0}")
    sort_checks.append(check_walk_sort(
        walk_sort, native, level0.pop("ids"),
        f"eval_pines_walks_level_0_{level0['walks']}_walks_x_"
        f"{level0['length']}_steps"))
    emit({"phase": "kernel_vs_twin", "kernel": "walk_row_sort",
          **sort_checks[-1]})
    # both kernels at the shapes the walk variants' t-SNE levels gave them
    # (each shape once, and none already held above)
    seen = {(c["n"], c["npad"]) for c in checks}
    for key, run in ev_walks["runs"].items():
        for e in run["embeddings"]:
            n, npad = e["n"], dense_npad(e["n"])
            if n < 2 or (n, npad) in seen:
                continue
            seen.add((n, npad))
            checks.append(check_forces_kernel(n, npad, seed=31 + n,
                                              calls=20))
            emit({"phase": "kernel_vs_twin", "kernel": "tsne_forces_dense",
                  "path_shape": f"eval_pines_walks {key} level "
                                f"{e['level']}", **checks[-1]})
            y = torch.from_numpy(repulsion_layout(n, npad, seed=n)).cuda()
            rep_checks.append(check_repulsion_kernel(y, n, 20, 3,
                                                     clock_hz=clock_hz))
            del y
            emit({"phase": "kernel_vs_twin", "kernel": "tsne_repulsion",
                  "path_shape": f"eval_pines_walks {key} level "
                                f"{e['level']}_kl", **rep_checks[-1]})
    eval_paths = [("eval_pines_tsne", ev_tsne["first"]),
                  ("eval_pines_tsne_cached", ev_tsne["second"]),
                  ("eval_pines_umap", ev_umap),
                  ("eval_record_tsne", ev_record["record_tsne"]),
                  ("eval_record_umap", ev_record["record_umap"])]

    emit({"phase": "elapsed", "seconds": time.perf_counter() - started,
          "limit": SMOKE_SECONDS_MAX})
    salw_runs = [(key, salw[key]) for key in ("rw_only",
                                              "new_walks_and_knn")]
    rep_main = rep_checks[1]            # the Pines KL's shape
    relax_main = relax["batches"][0]    # one level-0 pair batch, delta
    relax_main_launches = sum(geo["relax_launches"][name] for name in (
        "stage2_hierarchy", "stage3_level_similarities"))
    rep_timed = [c for c in rep_checks if "ms" in c]
    grid_paths = {name: [
        {"path": "large_grid", "n": n_large,
         "launches": grid_launches[name]},
        {"path": "large_grid_kls", "n": n_large, "kls": grid_kls,
         "launches": grid_kls * grid_kl_each[name]},
        {"path": "large_grid_z_gap", "n": n_large,
         "launches": gap["launches"][name]},
        {"path": "grid_vs_exact_grid", "n": mid["n"],
         "launches": mid["grid"]["launches"][name]},
        *({"path": "sharded_grid_tsne", "n": sh_n, "shards": int(shards),
           "launches": sh["grid_tsne"][shards]["launches"][name]}
          for shards in ("1", "2"))]
        for name in ("grid_deposit", "grid_interpolate")}
    emit({"kernels": [{
        "name": "tsne_forces_dense", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_forces_dense.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:167",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        **forces_bound(main_shape["n"], main_shape["npad"]),
        "library_ms": None,
        "shape": [main_shape["n"], main_shape["npad"]],
        "launches_by_path": [
            {"path": "pines", "launches": launches, "n": levels[1]},
            {"path": "scene_overlap", "n": s_levels[1],
             "launches": scene["launches"]["tsne_forces_dense"]},
            *({"path": f"salinas_euclid_level_{level}", "n": run["n"],
               "launches": run["launches"]["tsne_forces_dense"]}
              for level, run in sal["tsne"].items()),
            *({"path": f"rgb_geo_level_{level}", "n": run["n"],
               "launches": run["launches"]["tsne_forces_dense"]}
              for level, run in geo["tsne"].items()),
            *({"path": path, "n": ev["levels"][0],
               "launches": ev["launches"]["tsne_forces_dense"]}
              for path, ev in eval_paths),
            *({"path": f"salinas_walks_{key}", "n": run["tsne"]["n"],
               "launches": run["launches"]["tsne_forces_dense"]}
              for key, run in salw_runs),
            *({"path": f"eval_pines_walks_{name}", "n": EVAL_PINES_SHAPE[0]
               * EVAL_PINES_SHAPE[1],
               "launches": g["launches"]["tsne_forces_dense"]}
              for name, g in ev_walks["grids"].items())],
        "at_shapes": [{
            "shape": [c["n"], c["npad"]], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"]} for c in checks]}, {
        "name": "tsne_repulsion", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_repulsion.cu",
        "replaces": "sph_tpu/ops/pallas/tsne_kernels.py:80",
        "launches": main_rep_launches,
        "max_abs_err": max(c["max_abs_err"] for c in
                           [*rep_checks, rep_scenes, rep_window]),
        "ms": rep_main["ms"], "plain_ms": rep_main["plain_ms"],
        **repulsion_bound(rep_main["n"], rep_main["npad"]),
        "library_ms": None,
        "shape": [rep_main["n"], rep_main["npad"]],
        # the paths' launches, each with its point count (the top-level
        # launches, ms and bound are the main path's, at the Pines KL's)
        "launches_by_path": [
            {"path": "pines_kl", "launches": main_rep_launches,
             "n": rep_main["n"]},
            {"path": "scene_overlap_kl", "n": s_levels[1],
             "launches": scene["launches"]["tsne_repulsion"]},
            *({"path": f"salinas_euclid_level_{level}_kl", "n": run["n"],
               "launches": run["launches"]["tsne_repulsion"]}
              for level, run in sal["tsne"].items()),
            *({"path": f"rgb_geo_level_{level}_kl", "n": run["n"],
               "launches": run["launches"]["tsne_repulsion"]}
              for level, run in geo["tsne"].items()),
            {"path": "large_grid_z_gap", "n": n_large,
             "launches": gap["launches"]["tsne_repulsion"]},
            {"path": "large_exact", "n": n_large,
             "launches": large_launches["tsne_repulsion"]},
            {"path": "grid_vs_exact", "n": mid["n"],
             "launches": mid["exact"]["launches"]["tsne_repulsion"]},
            *({"path": f"{path}_kl", "n": ev["levels"][0],
               "launches": ev["launches"]["tsne_repulsion"]}
              for path, ev in eval_paths),
            *({"path": f"salinas_walks_{key}_kl", "n": run["tsne"]["n"],
               "launches": run["launches"]["tsne_repulsion"]}
              for key, run in salw_runs),
            *({"path": f"eval_pines_walks_{name}_kl",
               "n": EVAL_PINES_SHAPE[0] * EVAL_PINES_SHAPE[1],
               "launches": g["launches"]["tsne_repulsion"]}
              for name, g in ev_walks["grids"].items()),
            {"path": "multi_scene", "n": ms_n, "scenes": MULTI_SCENES,
             "launches": ms["launches_tsne"]["tsne_repulsion"]},
            *({"path": f"multi_scene_record_{it}",
               "n": MULTI_RECORD_SHAPE[0] * MULTI_RECORD_SHAPE[1],
               "scenes": MULTI_RECORD_SCENES,
               "launches": lc["tsne_repulsion"]}
              for it, lc in msr["launches"].items()),
            *({"path": "sharded_tsne", "n": sh_n, "shards": int(name),
               "launches": sh["tsne"][name]["launches"]["tsne_repulsion"]}
              for name in ("1", "2")),
            *({"path": "sharded_grid_tsne_z", "n": sh_n, "shards": int(name),
               "launches":
                   sh["grid_tsne"][name]["kl_launches"]["tsne_repulsion"]}
              for name in ("1", "2"))],
        "at_shapes": [*({
            "shape": [c["n"], c["npad"]], "plan": c["plan"], "ms": c["ms"],
            "plain_ms": c.get("plain_ms", "not measured"),
            "bound_ms": repulsion_bound(c["n"], c["npad"])["bound_ms"],
            "sfu_floor_ms": c["sfu_floor_ms"]} for c in rep_timed),
            *({"shape": [c["n"], c["npad"]], "scenes": c.get("scenes", 1),
               "windows": c.get("windows", 1), "ms": c["ms"],
               "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
               "bound_by": c["bound_by"], "sfu_floor_ms": c["sfu_floor_ms"]}
              for c in (rep_scenes, rep_window))]}, {
        # the JAX package's XLA attraction (no pallas_call); its main path
        # is the 1M grid run, packed, with one launch an iteration
        "name": "tsne_attraction", "route": "cuda",
        "source": "sph_tpu_torch/csrc/tsne_attraction.cu",
        "replaces": "sph_tpu/models/tsne.py:128",
        "launches": grid_att_launches,
        "max_abs_err": max(c[m]["max_abs_err"] for c in att_checks
                           for m in ("packed", "unpacked")),
        "ms": att_checks[0]["packed"]["ms"],
        "plain_ms": att_checks[0]["packed"]["plain_ms"],
        "bound_ms": att_checks[0]["packed"]["bound_ms"],
        "bound_by": att_checks[0]["packed"]["bound_by"],
        "library_ms": None,
        "shape": [att_checks[0]["rows"], att_checks[0]["width"]],
        "launches_by_path": [
            {"path": "large_grid", "n": n_large, "packed": True,
             "launches": grid_att_launches},
            {"path": "large_exact", "n": n_large,
             "launches": large_launches["tsne_attraction"]},
            *({"path": f"grid_vs_exact_{tier}", "n": mid["n"],
               "packed": tier == "grid",
               "launches": mid[tier]["launches"]["tsne_attraction"]}
              for tier in ("grid", "exact")),
            *({"path": f"sharded_{key}", "n": sh_n, "shards": int(name),
               "launches": sh[key][name]["launches"]["tsne_attraction"]}
              for key in ("tsne", "grid_tsne") for name in ("1", "2"))],
        "at_shapes": [{
            "path_shape": c["path_shape"], "shape": [c["rows"], c["width"]],
            "packed": m == "packed", "ms": c[m]["ms"],
            "plain_ms": c[m]["plain_ms"], "bound_ms": c[m]["bound_ms"],
            "bound_by": c[m]["bound_by"], "max_abs_err": c[m]["max_abs_err"]}
            for c in att_checks for m in ("unpacked", "packed")]},
        *(grid_kernel_line(name, grid_checks, grid_paths[name])
          for name in ("grid_deposit", "grid_interpolate")), {
        # the JAX package's XLA Bellman-Ford (no pallas_call); its main
        # path is rgb_geo's stages 2-3, one launch a sweep
        "name": "bellman_ford_relax", "route": "cuda",
        "source": "sph_tpu_torch/csrc/bellman_ford_relax.cu",
        "replaces": "sph_tpu/ops/shortest_path.py:62 _bellman_ford (an XLA "
                    "program: no pallas_call)",
        "launches": relax_main_launches,
        "max_abs_err": max(c["max_abs_err"] for c in relax["checks"]),
        # the whole batch: its sweeps' delta launches summed, the delta
        # twin's, and the delta bound (relax_delta_bound) of those sweeps
        "unit": f"one level-0 pair batch, {relax_main['sweeps']} sweeps",
        "ms": relax_main["ms"], "plain_ms": relax_main["plain_ms"],
        "bound_ms": relax_main["bound_ms"],
        "bound_by": relax_main["bound_by"], "library_ms": None,
        "full_loop_ms": min(relax_main["full_loop_ms"]),
        "shape": [relax_main["n"], relax_main["edges"],
                  relax_main["fields"]],
        "gathered_bytes": relax_main["gathered_bytes"],
        "gathered_tb_per_s": relax_main["gathered_tb_per_s"],
        "launches_by_path": [
            *({"path": f"rgb_geo_{name}", "n": geo["levels"][0],
               "launches": n_launch}
              for name, n_launch in geo["relax_launches"].items()),
            {"path": "rgb_geo_record", "n": RGB_GEO_RECORD_SHAPE[0]
             * RGB_GEO_RECORD_SHAPE[1], "launches": record_relax_launches}],
        "at_shapes": [{
            "path_shape": c["path_shape"],
            "shape": [c["n"], c["edges"], c["fields"]], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "gathered_bytes": c["gathered_bytes"],
            "gathered_tb_per_s": c["gathered_tb_per_s"],
            "max_abs_err": c["max_abs_err"]} for c in relax["checks"]],
        "batches": [{
            "path_shape": c["path_shape"],
            "shape": [c["n"], c["edges"], c["fields"]],
            "sweeps": c["sweeps"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "full_loop_ms": min(c["full_loop_ms"]),
            "of_full_loop": c["of_full_loop"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "share_of_bound": c["share_of_bound"],
            "gathered_bytes": c["gathered_bytes"],
            "mean_gathered_share": c["mean_gathered_share"],
            "mean_written_share": c["mean_written_share"]}
            for c in relax["batches"]]}, {
        # the JAX package's unstable sort of walk rows (an XLA op: no
        # pallas_call); its main path is the Pines path's NORMAL walks, one
        # launch a walk call; ms and bound at eval_pines_walks' level 0
        "name": "walk_row_sort", "route": "cuda",
        "source": "sph_tpu_torch/csrc/walk_row_sort.cu",
        "replaces": "sph_tpu/ops/walks.py:186 jax.lax.sort(..., "
                    "is_stable=False) in _accumulate (an XLA op: no "
                    "pallas_call)",
        "launches": main_sort_launches,
        "max_abs_err": max(c["max_abs_err"] for c in sort_checks),
        "ms": sort_checks[-1]["ms"], "plain_ms": sort_checks[-1]["plain_ms"],
        "plain": "native/xla_sort.cpp (std::sort on the host)",
        "bound_ms": sort_checks[-1]["bound_ms"],
        "bound_by": sort_checks[-1]["bound_by"], "library_ms": None,
        "torch_sort_stable_ms": sort_checks[-1]["torch_sort_stable_ms"],
        "shape": [sort_checks[-1]["rows"], sort_checks[-1]["cols"]],
        "launches_by_path": [
            {"path": "pines", "n": levels[0], "launches": main_sort_launches},
            *({"path": path, "launches": n_launch}
              for path, n_launch in sort_launches.items())],
        "at_shapes": [{
            "path_shape": c["path_shape"], "shape": [c["rows"], c["cols"]],
            "kernel_path": c["kernel_path"], "ms": c["ms"],
            "rows_held": c["rows_held"], "plain_ms": c["plain_ms"],
            "plain_rows": c["plain_rows"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "torch_sort_stable_ms": c["torch_sort_stable_ms"],
            "max_abs_err": c["max_abs_err"]} for c in sort_checks]}, {
        # the JAX package's segment-combine of its device merge (an XLA
        # program: no pallas_call); its main path is the Pines path's
        # MERGE_RW_ONLY walk-row merges, one launch a parent range of a
        # merge; ms and bound at the level-0 -> 1 merge
        "name": "merge_runs", "route": "cuda",
        "source": "sph_tpu_torch/csrc/merge_runs.cu",
        "replaces": "sph_tpu/ops/device_merge.py:56 _merge_flatten's "
                    "scatter-add / scatter-min segment-combine (an XLA "
                    "program: no pallas_call)",
        "launches": merge_launches["pines"],
        "max_abs_err": max(c["max_abs_err"] for c in merge_checks),
        "ms": merge_checks[0]["ms"], "plain_ms": merge_checks[0]["plain_ms"],
        "bound_ms": merge_checks[0]["bound_ms"],
        "bound_by": merge_checks[0]["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call sums runs in the host's order; "
                        "index_add_ (atomics) is scatter_ms",
        "shape": [merge_checks[0]["entries"], merge_checks[0]["runs"]],
        "launches_by_path": [
            {"path": path, "launches": n_launch}
            for path, n_launch in merge_launches.items()],
        "at_shapes": [{
            "path_shape": c["path_shape"], "combine": c["combine"],
            "entries": c["entries"], "runs": c["runs"],
            "cap_bites": c["cap_bites"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "share_of_bound": c["share_of_bound"],
            "scatter_ms": c["scatter_ms"],
            "device_path_ms": c["device_path_ms"],
            "host_path_ms": c["host_path_ms"],
            "max_abs_err": c["max_abs_err"]} for c in merge_checks],
        "symmetrize_graph_device": sym_checks}]})
    elapsed = time.perf_counter() - started
    if not elapsed <= SMOKE_SECONDS_MAX:
        raise AssertionError(f"chip_smoke took {elapsed} s, over "
                             f"{SMOKE_SECONDS_MAX}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
