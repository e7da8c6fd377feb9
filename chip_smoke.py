#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

needs one NVIDIA card and runs, in order:

1. the card's name and power limit (``nvidia-smi``);
2. builds the six hand-written kernel sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together: ten kernels, the fp32,
   bf16 and int8 forms of ``gather_distance`` and ``fused_expand``, the
   fp32 and the two bf16-operand forms of ``pairwise_distance``, SIMT and
   tensor-core, and ``tile_topk``, the brute tile's running top-k, which
   is held bit for bit and timed at the exact cell's, the recall audit's
   and a router request's tile beside ``torch.topk`` on an int64 key) and
   holds each kernel against its plain
   PyTorch version on the card: at a small shape for each of the five
   metrics and at the main path's shapes, distances to ``rtol=1e-5,
   atol=1e-3`` on Gaussian data and bit for bit on integer-valued data
   (for the bf16 and int8 forms: under l2 and ip, and l1 at bf16); prints
   each kernel's time, its plain version's time, its bound from the bytes
   of its storage type and, for ``pairwise_distance``, ``torch.mm(q, x.T)``
   in IEEE fp32 (the library time) and ``torch.cdist`` as yardsticks.  The
   gather is also held against its plain version, and timed, at a second
   shape, a large candidate count (B=256, C=512, d=256 over 2^18 rows,
   ``bench_gather.large_c_inputs``: exact on integer rows, to the tolerance
   on N(0,1) rows).  At both shapes each timed gather call reads its own
   queries and ids (``bench_gather.timing_sets``), so its rows come from
   device memory and not from the L2 the call before it filled; the replay
   of one set (warm) is printed beside it, and the same timer reads an
   empty kernel launched with the gather's grid, the floor of any gather's
   time.  Then the serving searches' shapes: the gather at B in {1, 4, 37,
   64} (4: a router request) with C=44 coarse seeds (T + T·M + p = 4 + 32 +
   8) and ``fused_expand`` at the same B with C=60, e=64, H=2048, each
   storage type against its plain version (exact on integer rows), B=64
   timed, and ``pairwise_distance``, norms uncached, at the recall audit's
   tile (96 queries against 8,192 rows), ``nearest_landmark``'s chunk (4,096
   rows against 4,000 landmarks) and the router's brute tile (4 queries
   against 8,192 rows), exact on integer rows, to the tolerance on clustered
   rows, each timed.
   Last, the merge's second-hop gather (``ops.merge_proposals``): one row
   chunk of 16,384 queries x C = HOP_TOP * k = 400 ids over the 10^6 rows,
   exact on integer rows, to the tolerance on clustered rows, timed.  The
   router's request shapes are timed too: ``fused_expand`` at B=4, C=60,
   e=64, H=2048 and the seed gather of a shard's search (B=4, C=8 over a
   250,000-row shard).  The bf16-operand ``pairwise_distance`` is held
   against its plain version at the small shapes and at the 4,096² tile
   (bit for bit on integer rows); where its tensor-core form runs (l2 and
   ip at d % 8 == 0, its own count moves), also against the fp32 kernel on
   the widened rows (bit for bit on integer rows, within WGMMA_RTOL of
   ‖q‖² + ‖x‖² on clustered ones).  It is timed at the 4,096² tile beside
   its SIMT form on the same rows, the fp32 kernel and ``torch.mm`` on the
   bf16 rows with fp32 output (the library time), and at the data_bf16
   build's 1,024² x 32 tile and 256² seed graph.
   (2e) The kernels at d=3, atom positions: the atom graph's build (k=8,
   l2, LGD, W=1024) over 24,576 atoms at integer positions in [0, 64)^3 and
   its exact graph, through the kernels and through the plain versions from
   the same draws, every graph array, counter and exact id identical; then
   each kernel against its plain version, bit for bit, on arguments that
   build gave it (``Smoke.capture``: the seed gather B=1024, C=8, an
   expansion B=1024, C=24, the 1,024² intra-wave tile and an 24,576×8,192
   tile of the exact graph), each timed there;
3. an n=20,000, d=32 integer-valued build with the kernels and the same
   build with the plain versions, from the same injected seeds, at fp32,
   int8 and bf16: every graph array and the counters must be identical.  On
   the fp32 graph one churn script runs twice, with the kernels and with the
   plain versions: remove 2,000 rows, compact, insert 1,024 rows from
   injected seeds, and a ``seed_mode="coarse"`` build from injected
   landmarks and seeds; every graph array, the id map, the coarse level and
   ``n_comps`` must be identical.  Then the divide-and-conquer script twice,
   kernels and plain: ``build_parallel`` (3 blocks, one refine round), a
   3-shard router's add, remove, compact, graph and brute retrieval and
   ``merge_shards``, every draw injected; every array, table and answer
   identical.  Two more builds, kernels against plain: ``intra_wave=False``
   at W=64 on the first 10,000 of the rows (a cut of its depth, for the
   run's time aim), and ``data_bf16`` (the rows stored bf16) at W=1024;
4. the online LGD build at full width (the knn-lgd config: k=20, l2, W=4096,
   beam 40, 8 seeds, d=128) over n=1,000,000 clustered rows, then graph
   recall@10 over 10,000 strided rows against ``brute_force_knn`` run
   through the pairwise kernel, self-match excluded; then the same build
   through the plain versions on the card, same data and seeds.  The
   kernels' recall must reach 0.90, or, where the plain build misses 0.90
   too (the algorithm's own floor at this wave width), the plain recall
   less 0.01;
5. the same build at ``precision="int8"`` and at ``"bf16"``, on phase 4's
   data and seeds, through the variant kernels: rows/s, scanning rate, peak
   memory and recall@10 over the same rows, which must reach phase 4's
   recall less 0.05 (the reference's own int8 tolerance).  Then 4,096
   held-out queries search phase 4's graph at fp32 and at pq: with
   ``rerank_factor=1000`` ids and distances equal the fp32 search bit for
   bit, and at the default factor the top-k ids overlap by >= 0.9.  Neither
   prunes at this config (C = k + 2k = 60 <= 80 kept), so the pruning factor
   1 is held to an overlap with fp32 and against itself on the CPU: the
   card's PQ codes against the CPU's encoder, and the whole search, run
   again on the CPU with the card's codes, graph and entry points.  And the
   build with the rows stored bf16 (``data_bf16``: bf16 tables, bf16-operand
   tile and seed graph), held to the same recall floor, every one of its
   pairwise launches through the tensor-core form;
6. serving at full width: phase 4's graph as an ``OnlineIndex`` at capacity
   10^6 behind a ``ServingLoop`` (top_k 10, beam 64, waves of up to 64,
   a 96-query recall reservoir sampling every 5th query), one untimed
   warm-up round, then 24 rounds of 40 held-out queries; every 4th round
   (and the warm-up) removes 4,096 random live rows and adds 4,096 fresh
   ones, so each churn event runs remove, compact and one insertion wave.
   The same traffic then runs through the plain versions on the card, from
   the same seeds.  It prints p50/p99 latency, QPS, comps per query,
   scanning rate, the ``hash_full`` share and the fresh and served
   recall@10, and holds the kernels' fresh recall >= plain - 0.01, the
   capacity at 10^6, the graph's invariants and no removed row served.
   Then a snapshot round trip of the churned index (bit-equal arrays, one
   64-query wave bit-identical before and after), ``derive_coarse`` with
   4,000 landmarks and the reservoir searched at ``seed_mode="coarse"``
   (kernels >= plain - 0.01, beside random seeding), a ``JsonlTracker``
   trace holding the loop's and the index's spans, and one wave served
   with the tracker on bit-identical to the wave with it off;
7. the sharded router and the divide-and-conquer build at full width:
   (a) ``build_parallel`` of phase 4's rows in 4 blocks at the knn-lgd
   config, one refine round, cross searches in chunks of 16,384: seconds by
   span (sub-builds, each merge level, folds, refine) and the device time of
   the refine's whole-capacity ``merge_candidates`` calls, comps, peak
   memory, recall@10 over phase 4's rows, which must reach the sequential
   recall less 0.02 (the reference's tolerance), or, where it misses, the
   same build through the plain versions less 0.01; invariants and the
   canonical λ.  (b) A 4-shard ``ShardedIndex`` of the same rows under 8
   of phase 6's rounds (a third of them: a cut of its depth, for the run's
   time aim) in requests of 4 queries through ``retrieve`` (churn:
   4,096 random live ids removed, 4,096 fresh rows added in batches that
   fit the least-filled shard, ``compact()``): p50/p99 per request, QPS,
   comps/query, the ``router/shard<s>`` spans, recall@10 against brute
   force; no removed id served, capacity 10^6, the id tables following
   every compaction, the brute router equal to ``retrieve_brute`` over one
   index of the same live rows, a bit-exact snapshot round trip.  (c)
   ``merge_shards`` of the churned router: every sampled live id resolves
   to its own row, no removed id served, one round served;
8. the device mesh at full width: 4 ranks of a gloo group on the one card
   (``_mesh_rank``, spawned), each owning a 250,000-row shard of phase 4's
   rows: (a) per-shard exact seed graphs and the shard step in lockstep
   waves of W=4096 (seconds, waves, all-reduced comps); (b) the
   scatter-gather search of phase 5's 4,096 held-out queries in waves of 64
   (recall@10 against brute force over all 10^6 rows, latency per wave),
   then with shard 0 blanked, which must serve none of its rows;
   (c) ``build_parallel(mesh=group, shards=4)`` with one refine round
   (seconds by span, recall@10 over phase 4's rows, which must reach phase
   7a's less 0.02, the same graph on every rank).  A rank that fails fails
   the run;
9. the recommender serving path at the published widths: (a) each of
   deepfm, xdeepfm, bst and mind at ``full_config()`` (tables of 39e6x10,
   39e6x10, 1e7x32 and 1e7x64 drawn on the card, one arch at a time):
   ``serve_scores`` at serve_p99 (B=512) and serve_bulk (B=262,144, in row
   chunks) from ``recsys_data`` batches, and its retrieval_cand scorer over
   10^6 candidates, each call timed to its synchronize after a warm-up
   with its peak memory; every score finite and the first 256 rows within
   rtol 1e-4, atol 1e-5 of the same parameters on the CPU in float64.
   (b) The MIND table's first 10^6 rows, L2-normalised, indexed with
   ``retrieval.build_index(metric="ip", k=16, wave=4096, beam=40)``; 256
   users' histories through ``mind_interests`` (4 interests, normalised),
   each served with ``retrieve(top_k=20, beam=48)``, against
   ``retrieve_brute`` (overlap@20 mean and minimum printed), p50/p99 per
   request, comps per query and the launch counts; 4,096 fresh rows added
   and 4,096 ids removed, the first 64 requests served again (a cut of
   depth, for the phase's time aim) with no withdrawn id;
   the same requests through the plain versions on the card must return
   the same ids.  Each kernel is then held against its plain version, and
   timed, at the shapes this path gave it (arguments captured from the
   build, B=4096, and from a request, B=4: d=64, ip).  (c)
   ``examples/retrieval_serving_torch.py`` at its own size (8,000 items,
   d=16, W=512) with mean overlap@20 >= 0.90;
10. training on the card: (a) deepfm, xdeepfm, bst and mind at
   ``full_config()``, AdamW over the shared 65,536-row ``train_batch`` from
   the skip-ahead loader (xdeepfm in 2 microbatches), the first step on the
   first 256 rows against the CPU in float64 (the loss, and every gradient
   leaf within 1e-4 of its largest element), then one warm-up and 2 timed
   steps (ms per step, peak memory, finite losses); (b) the paper's graph
   over 10^5 atoms uniform in a box at the example's density (k=8, W=1024):
   build seconds, scanning rate, launches, edge recall@8 against the exact
   graph (the pairwise kernel), the same build through the plain versions
   (recall within 0.01), MACE at full_config("molecule") over its edges
   (energy and forces timed, peak memory) and against the CPU in float64
   on a slab of the box, then ``examples/molecule_graphs_torch.py``;
   (c) MACE training at full_graph_sm (a cora-size ``random_graph``) and
   molecule (128 molecules, 2-NN edges), AdamW, 3 timed steps each;
   (d) the two-level data-parallel step on 4 gloo ranks on the one card
   (2 pods x 2 data ranks, ``_train_rank``), MACE molecule, 20 SGD steps
   with the pod hop compressed and 20 without: every rank's parameters
   equal, uncompressed equal to one process within 1e-5 of each leaf's
   scale, compressed within 0.05 of uncompressed;
11. the LM family on the card, parameters and tokens drawn from seeds:
   (a) gemma3-1b at ``full_config()`` (26 layers, d 1152, vocab 262,144,
   bf16, ~1.0B parameters): ``prefill`` of 2 x 32,768 tokens (prefill_32k's
   length, the batch cut from 32), seconds, tokens/s, peak memory, finite
   logits, the cache in the reference's (L, B, S, KV, dh) layout; (b) the
   reference's decode tests at full width: 640 teacher-forced steps at
   batch 2 through ``decode_step`` and ``decode_step_split`` from empty
   caches of 1,024 positions (past the 512-slot rings' wrap), every step's
   logits within ``LM_SPLIT_TOL`` of its largest, and ``prefill(1023)`` plus
   one step against ``forward(1024)`` within ``LM_FWD_TOL``; (c) decode_32k:
   batch 128 through the split caches at max_seq 32,768 (4 dense layers of
   17.2 GB, 22 rings of 1.5 GB), filled from a seed to 32,736, 32 greedy
   steps timed beside the step's byte bound; (d) AdamW through
   ``make_train_step`` at train_4k's 4,096 tokens, remat on, 8 rows in 8
   microbatches, 3 timed steps; (e) the fp32 forward on 64 tokens against
   the CPU's float64 (``LM_F64_TOL``) and the bf16 one against it
   (``LM_BF16_TOL``); (f) stablelm-1.6b and qwen2.5-3b whole, mixtral-8x7b
   on 4 of its 32 layers and arctic-480b on 1 of its 35 (the whole models
   do not fit 80 GB), one prefill of 4,096 tokens (mixtral 8,192, twice its
   window) and 16 decode steps each (mixtral through ring caches), the MoE
   drop rates; (g) ``launch.serve --mode lm`` for the five archs, ``launch.
   train --arch gemma3-1b`` at the smoke and the full config, and
   ``examples/train_lm_torch.py --tiny``, whose loss must fall.  The LM path
   launches no hand kernel (its counts stay 0);
12. the paper's three core examples in-process on the card at the
   reference's sizes, their own asserts the gate:
   ``examples/quickstart_torch.py`` (5,000 clustered rows, d=32, k=10, an
   LGD build with the coarse level, coarse- and random-seeded search
   against brute force, 500 rows inserted and 100 removed),
   ``examples/lifecycle_torch.py`` (4,000 rows, d=16, k=16: build, a
   snapshot restored to a bit-identical replica, churn at fixed capacity,
   coalesced ingest, compact) and ``examples/parallel_build_torch.py``
   (6,000 rows, d=16, k=16, 4 shards: sequential and parallel builds, the
   spelled-out merge and refine, a router collapsed by ``merge_shards``).
   Each example's launch counts are zeroed just before it and each of the
   three fp32 kernels must have launched in it; no plain version of a
   kernel may run on a CUDA tensor meanwhile; each kernel is held against
   its plain version, within the real-valued tolerance, on arguments
   captured from each example (its seed gather, an expansion and the
   intra-wave tile at d = 16 and 32; the parallel build's first merge's
   cross-search expansion and second-hop gather too); and a metric
   registered for the phase must be refused by ``ops.pairwise_distance``,
   ``ops.gather_distance`` and ``ops.expand_step`` on CUDA tensors before
   any launch;
13. the dry run held against the card: (a) knn-lgd ``search_4k``'s step
   (``configs.cells.knn_search_step``: ``init_state``, one ``step``, the
   shards' all-gather and merge) planned on a world of 1 at phase 4's graph
   (10^6 rows, d=128) and a batch of 64 (``cells.lower``, fakes only), then
   run on the card over a gloo group of 1: planned against measured peak
   bytes (the arguments plus ``torch.cuda.max_memory_allocated`` over the
   step from a reset, less what was allocated before), which must agree
   within 25%, the planned kernel calls against the launch counts, which
   must be equal, and the planned FLOPs and bytes with their bound time
   beside the step's measured time; (b) gemma3-1b ``decode_32k`` at batch 2
   planned on a (1, 1) mesh and one ``decode_step`` run on the card from a
   dense 32,768-position cache: planned against measured peak;
14. a ``kernels`` JSON line: each kernel's launches in the build of its own
   precision (phase 4 for fp32, phase 5 for bf16 and int8, the ``data_bf16``
   build for the bf16-operand pairwise, whose tensor-core form has a record
   of its own) and, for the three fp32 kernels, in
   the serving run (``serve_launches``) and in each phase 7 and 8 path
   (``parallel_launches``, ``router_launches``, ``merge_shards_launches``,
   ``mesh_build_launches``, ``mesh_search_launches``,
   ``mesh_parallel_launches``, summed over the ranks), phase 9b's
   (``retrieval_launches``), phase 10b's atom path (``atom_launches``) and
   each phase 12 example (``example_quickstart_launches``,
   ``example_lifecycle_launches``, ``example_parallel_build_launches``),
   its error against the plain version, times and bound (phase 9b's shapes
   under ``mind_`` keys, phase 2e's d=3 shapes under ``atom_``, phase
   10b's exact-graph tile under ``atom_brute_``, and the bf16-operand
   tile's other shapes under ``tile1024_`` and ``seed_``, with the SIMT
   form's time on the same rows as ``simt_ms``).

It exits non-zero, printing no result, when any phase fails, when no CUDA
device is present, or when it is run without the rest of the repository.
The last line of its output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

RTOL, ATOL = 1e-5, 1e-3
# the bf16-operand pairwise kernel's tensor-core form on real-valued rows:
# each distance within this share of ‖q‖² + ‖x‖² of the fp32 kernel on the
# widened rows (exact products, fp32 sums in the tensor cores' order)
WGMMA_RTOL = 1e-5
METRICS = ("l2", "ip", "cosine", "l1", "chi2")
EXACT_METRICS = ("l2", "ip", "l1")  # exact fp32 sums on integer-valued data
VARIANTS = ("bf16", "int8")  # the compressed tables of gather and expand
QUERY_SEED, SEARCH_SEED = 17, 19  # phase 5's held-out queries and entry points
# phase 6: the served queries and the fresh rows (held-out samples of the
# same mixture), the loop's entry points, the victims, the coarse landmarks
SERVE_QUERY_SEED, FRESH_SEED, LOOP_SEED, VICTIM_SEED, LANDMARK_SEED = 29, 23, 31, 37, 41
SERVE_ROUNDS, SERVE_BURST, CHURN, CHURN_EVERY = 24, 40, 4096, 4
# phase 7b serves a third of phase 6's rounds (its 4-query requests pay the
# host loop once per shard), which keeps the run inside its time aim
ROUTER_ROUNDS = 8
# phase 3: rows of the build without the intra-wave tile (a cut of its depth)
INTRA_OFF_ROWS = 10_000
SERVE_LANDMARKS = 4000
# phase 5's pruning PQ search (rerank_factor=1): its top-k overlap with the
# fp32 search (0.8946 in two runs on an H100 80GB HBM3 at 700 W), and its
# agreement with the same search on the CPU, where only last-bit differences
# of fp32 sums and ADC tables may move a near tie; and the share of the
# card's PQ codes that the CPU's encoder gives too (ties only)
PQ_PRUNE_OVERLAP, PQ_CPU_AGREE, PQ_CODES_AGREE = 0.88, 0.99, 0.999

# phase 7: blocks of the parallel build and shards of the router, the host
# path's merge cross searches' batch (7a, 7c; 16,384 lanes: a merge level's
# host iterations fall with the batch, 4x fewer than at the wave's width of
# 4,096 and 32x fewer than at the reference's default 512; the mesh path of
# 8c searches each side in one batch), queries per router request (a
# user's interests, as the serving launcher sends them), the router's draws,
# and the live ids looked up after merge_shards
PAR_SHARDS, ROUTER_SHARDS, MERGE_CHUNK, REQUEST = 4, 4, 16384, 4
ROUTER_SEED, LOOKUP_SEED, LOOKUPS = 43, 47, 8192
FP32_KERNELS = ("gather_distance", "fused_expand", "pairwise_distance")
# phase 8: ranks of the process group on the one card, queries per search
# wave of the sharded search
MESH_RANKS, MESH_WAVE = 4, 64
# lanes per slice of the plain expansion where a batch is larger
PLAIN_LANES = 65536
# phase 9: the recommender serving path.  Each arch's parameters and
# batches are drawn on the card from these seeds; its scores on the first
# CHECK_ROWS rows (or candidates) are held against the same parameters on
# the CPU in float64, |card - cpu| <= SCORE_ATOL + SCORE_RTOL * |cpu| (fp32
# sums in another order: the CPU's own fp32 differs from its float64 by at
# most 8.2e-7 at these widths)
RECSYS_ARCHS = ("deepfm", "xdeepfm", "bst", "mind")
RECSYS_PARAM_SEED, RECSYS_DATA_SEED = 53, 59
CHECK_ROWS, SCORE_RTOL, SCORE_ATOL = 256, 1e-4, 1e-5
# the MIND index: the table's first MIND_ROWS rows, L2-normalised, built at
# the knn-lgd wave (W=4096: the example's W=512 would take eight times the
# waves), k=16, beam 40; MIND_USERS users' 4 interests each served top-20
# at beam 48 (entry points seeded MIND_QUERY_SEED + user); then MIND_CHURN
# fresh rows added and as many ids removed.  The kernels' copies of each
# kernel's arguments are taken at the CAPTURE_CALL-th call of each shape
MIND_ROWS, MIND_USERS, MIND_CHURN, MIND_WAVE = 1_000_000, 256, 4096, 4096
MIND_K, MIND_BUILD_BEAM, MIND_TOP_K, MIND_BEAM = 16, 40, 20, 48
MIND_INDEX_SEED, MIND_USER_SEED, MIND_FRESH_SEED, MIND_VICTIM_SEED = 61, 67, 71, 73
MIND_QUERY_SEED, CAPTURE_CALL = 1000, 3
# users served again after the churn (a cut of depth, for the phase's time aim)
MIND_AFTER_USERS = 64
# examples/retrieval_serving_torch.py at its own size: mean overlap@20 with
# exact retrieval, the near-exact top-20 the example claims
EXAMPLE_OVERLAP = 0.90
# phase 2e: the kernels at d=3 on an atom build's states: ATOM_INT_N atoms
# at integer positions in [0, ATOM_INT_HIGH)^3 (a cut of phase 10b's depth,
# where distances tie often), k=8, l2, LGD, W=1024; three full tiles of the
# exact graph's 8,192 rows, so the captured (CAPTURE_CALL-th) tile is full
ATOM_K, ATOM_WAVE, ATOM_INT_N, ATOM_INT_HIGH = 8, 1024, 3 * 8192, 64
ATOM_INT_SEED, ATOM_BUILD_SEED = 83, 97
# phase 10: training.  (a) each recommender at full_config() on the shared
# train_batch (65,536 rows), AdamW, one warm-up and TRAIN_STEPS timed steps;
# xDeepFM's CIN keeps a (rows, 10, 200*39) product per layer for the backward
# pass (312 KB a row), so it accumulates over XDEEPFM_ACCUM microbatches of
# 32,768 rows (about 22 GB of saved products, where one pass would need 45
# GB of them and 20 GB more while the backward runs).  The first step on the
# first CHECK_ROWS rows is held against the CPU in float64: the loss within
# GRAD_RTOL of itself, each gradient leaf within GRAD_RTOL of its largest
# element (fp32 sums in another order)
TRAIN_SEED, TRAIN_LR, TRAIN_STEPS, XDEEPFM_ACCUM, GRAD_RTOL = 89, 1e-3, 2, 2, 1e-4
# (b) the paper's graph under MACE: ATOM_N atoms uniform in a box at the
# example's density (3,000 atoms in 30^3), k=8, W=1024; MACE at
# full_config("molecule") over its edges; the CPU's float64 check on the
# atoms of a slab of ATOM_CUT of the box (about 4,000 atoms), energy and
# forces within MACE_RTOL of their largest magnitude
ATOM_N, ATOM_SEED, ATOM_CUT, MACE_RTOL = 100_000, 79, 0.04, 1e-4
# the exact graph's pairwise tile at real-valued positions, kernel against
# plain: each distance within ATOM_PAIR_RTOL of |q|^2 + |x|^2 (about 8 fp32
# ulps: both compute |q|^2 + |x|^2 - 2 q.x, whose three terms and two sums
# each round within a few ulps of that), and each atom's k exact distances
# within the same of |q|^2 + max |x|^2
ATOM_PAIR_RTOL = 1e-6
ATOM_SIDE = 30.0 * (ATOM_N / 3000) ** (1.0 / 3.0)
MACE_PARAM_SEED, MACE_DATA_SEED = 101, 103
# (c) MACE training at full_graph_sm and molecule (MOLECULES of 30 atoms,
# k=MOL_K nearest neighbours each: 60 edges, the nearest a k-NN list comes
# to the shape's 64), one warm-up and MACE_STEPS timed steps
MACE_STEPS, MOLECULES, MOL_K = 3, 128, 2
# (d) the two-level data-parallel step on DP_RANKS gloo ranks (DP_PODS pods)
# on the one card: DP_STEPS SGD steps with the pod hop compressed and as
# many uncompressed; uncompressed equals one process on the whole batch
# within DP_RTOL of each leaf's largest element, compressed tracks it within
# DP_TRACK (the reference's bound, tests/test_distributed.py)
DP_RANKS, DP_PODS, DP_STEPS, DP_LR, DP_RTOL, DP_TRACK = 4, 2, 20, 0.05, 1e-5, 0.05

# phase 11: the LM family.  Parameters and tokens are drawn on the card from
# these seeds.  (a) gemma3-1b's prefill at prefill_32k's length, the batch
# cut from 32 to LM_PREFILL_B; (b) LM_PARITY_STEPS teacher-forced decode
# steps at batch 2 from empty caches of LM_PARITY_SEQ positions, split
# against dense, and prefill + one step against forward at that length;
# (c) decode_32k at batch LM_DECODE_B, caches filled from a seed to
# LM_DECODE_LEN; (d) AdamW at train_4k's sequence, the batch cut from 256 to
# LM_TRAIN_BATCH in LM_TRAIN_ACCUM microbatches; (e) LM_F64_TOKENS tokens
# against the CPU's float64; (f) the other archs, mixtral and arctic cut in
# depth (a mixtral layer is 2.9 GB of bf16 and an arctic layer 26.8 GB: the
# whole models do not fit 80 GB), each one prefill and LM_OTHER_STEPS
# decode steps; (g) the example's steps
LM_ARCHS = ("mixtral-8x7b", "arctic-480b", "stablelm-1.6b", "qwen2.5-3b", "gemma3-1b")
LM_PARAM_SEED, LM_DATA_SEED = 107, 109
LM_PREFILL_B, LM_PREFILL_S = 2, 32768
LM_PARITY_SEQ, LM_PARITY_STEPS = 1024, 640
LM_DECODE_B, LM_DECODE_SEQ, LM_DECODE_LEN, LM_DECODE_STEPS = 128, 32768, 32736, 32
LM_TRAIN_BATCH, LM_TRAIN_ACCUM, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 8, 4096, 3
LM_F64_TOKENS = 64
LM_DEPTH_CUT = {"mixtral-8x7b": 4, "arctic-480b": 1}
LM_OTHER_SEQ = {"stablelm-1.6b": 4096, "qwen2.5-3b": 4096, "mixtral-8x7b": 8192,
                "arctic-480b": 4096}
LM_OTHER_STEPS, LM_EXAMPLE_STEPS = 16, 40
# tolerances, each a share of the largest logit: split against dense (the
# dense step rounds its logits to bf16 before the softcap, the split one
# after; ring and dense attention sum in other orders), prefill/decode
# against forward (bf16 probabilities rounded at other points), fp32 on the
# card against float64 (fp32 sums in another order), bf16 against fp32
LM_SPLIT_TOL, LM_FWD_TOL, LM_F64_TOL, LM_BF16_TOL = 2.0 ** -5, 2.0 ** -5, 1e-4, 2.0 ** -3
LM_HBM_BYTES_S = 3.35e12  # the H100 SXM's published memory rate
# phase 12: each core example's wave (the rows of its seed gathers,
# expansions and intra-wave tiles), and the merge searches' chunk of lanes
# (``construct.build_parallel``'s ``search_chunk``)
EXAMPLE_WAVES = {"quickstart": 256, "lifecycle": 512, "parallel_build": 256}
MERGE_SEARCH_CHUNK = 512
# ``--host-times``: phase 6's traffic served this many times after one
# build, a median against the host's noise
HOST_SERVE_RUNS = 3

# the kernels, the CUDA sources that replace the TPU kernels, and the
# pallas_call sites with the storage type each form takes
_GATHER, _EXPAND = "src/repro_torch/csrc/gather_dist.cu", "src/repro_torch/csrc/expand.cu"
KERNELS = {
    "gather_distance": (_GATHER, "src/repro/kernels/gather_dist.py:329 (fp32)"),
    "gather_distance.bf16": (_GATHER, "src/repro/kernels/gather_dist.py:329 (bf16 table, x.dtype branch :295-310)"),
    "gather_distance.int8": (_GATHER, "src/repro/kernels/gather_dist.py:329 (int8 table + row_scale, :295-310)"),
    "fused_expand": (_EXPAND, "src/repro/kernels/expand.py:412 (fp32)"),
    "fused_expand.bf16": (_EXPAND, "src/repro/kernels/expand.py:412 (bf16 table, x_eng :367)"),
    "fused_expand.int8": (_EXPAND, "src/repro/kernels/expand.py:412 (int8 table + gathered scale, :368, :396-398)"),
    "pairwise_distance": ("src/repro_torch/csrc/distance.cu", "src/repro/kernels/distance.py:223 (fp32)"),
    "pairwise_distance.bf16": ("src/repro_torch/csrc/distance_bf16.cu",
                               "src/repro/kernels/distance.py:223 (bf16 operands, widened in-kernel "
                               ":51-52, :81-82, :107-108)"),
    "pairwise_distance.bf16_wgmma": ("src/repro_torch/csrc/distance_wgmma.cu",
                                     "src/repro/kernels/distance.py:223 (bf16 operands, l2/ip on the "
                                     "MXU bodies :41, :70)"),
    "tile_topk": ("src/repro_torch/csrc/tile_topk.cu",
                  "none (the brute tile's running top-k, lax.top_k in the reference)"),
}


def kernel_name(kernel, precision):
    return kernel if precision == "fp32" else f"{kernel}.{precision}"


def exact_for(metric, precision):
    """Where a kernel equals its plain version bit for bit on integer data."""
    if precision == "fp32":
        return metric in EXACT_METRICS
    return metric in ("l2", "ip") or (metric == "l1" and precision == "bf16")


def simt_bf16(cuda, q, x, metric, xn):
    """The SIMT form of the bf16-operand pairwise kernel on rows the
    wrapper would give the tensor-core form: timed beside it, its launch
    uncounted."""
    import torch
    from repro_torch.kernels import distance

    fn = cuda.function("distance_bf16", "launch_pairwise_distance_bf16", distance._ARGTYPES)
    out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32, device=q.device)
    cuda.launch("pairwise_distance.bf16", fn, q.device, cuda.ptr(q), cuda.ptr(x), cuda.ptr(xn),
                cuda.ptr(out), q.shape[0], x.shape[0], q.shape[1],
                distance.KERNEL_METRIC[metric], count=False)
    return out


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_times(root: Path) -> dict:
    """Phase 4's knn-lgd build and phase 6's serving run through the
    kernels, with the ``chip_smoke.py`` and the package of the checkout at
    ``root`` (its phases' own code, data and seeds), after one untimed
    build of 20,000 rows: the build's seconds and, for ``HOST_SERVE_RUNS``
    runs of the same traffic, each run's serving p50/p99 and the median p50.
    Run once per checkout, each in its own process, to compare two trees on
    one host."""
    import importlib.util

    import torch

    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("smoke_at_root", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from repro_torch.configs import knn_lgd
    from repro_torch.data import synthetic
    from repro_torch.launch import build_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = mod.Smoke(torch)
    smoke.build_kernels()
    cfg = knn_lgd.full_config()
    smoke.xf = build_graph.make_data(20_000, knn_lgd.D, "l2", smoke.dev)
    smoke.build_full(cfg)
    smoke.xf = build_graph.make_data(knn_lgd.N_ROWS, knn_lgd.D, "l2", smoke.dev)
    smoke.g32, _, t_build = smoke.build_full(cfg)
    events = mod.SERVE_ROUNDS // mod.CHURN_EVERY + 1
    smoke.serve_queries = synthetic.clustered(
        smoke.gen(build_graph.DATA_SEED), (mod.SERVE_ROUNDS + 1) * mod.SERVE_BURST, knn_lgd.D,
        sample_generator=smoke.gen(mod.SERVE_QUERY_SEED))
    smoke.serve_fresh = synthetic.clustered(
        smoke.gen(build_graph.DATA_SEED), events * mod.CHURN, knn_lgd.D,
        sample_generator=smoke.gen(mod.FRESH_SEED))
    reps = [smoke.serve_run()[2] for _ in range(HOST_SERVE_RUNS)]
    p50 = [r["p50_latency_ms"] for r in reps]
    return {"root": str(root), "build_s": t_build, "serve_p50_ms": p50,
            "serve_p50_median_ms": sorted(p50)[len(p50) // 2],
            "serve_p99_ms": [r["p99_latency_ms"] for r in reps]}


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--host-times":
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 1
        print(f"device: {nvidia_smi_line()}", flush=True)
        print(json.dumps(host_times(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)
    smoke = Smoke(torch)
    t0 = time.perf_counter()
    try:
        for phase in (smoke.build_kernels, smoke.phase_kernels, smoke.phase_atom_kernels,
                      smoke.phase_build_parity, smoke.phase_full, smoke.phase_compressed,
                      smoke.phase_serving, smoke.phase_parallel, smoke.phase_router,
                      smoke.phase_merge_shards, smoke.phase_mesh, smoke.phase_recsys,
                      smoke.phase_train, smoke.phase_lm, smoke.phase_examples,
                      smoke.phase_dryrun):
            phase()
            print(f"  [{phase.__name__} done at {time.perf_counter() - t0:.1f} s]", flush=True)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": smoke.kernel_records()}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def _mesh_rank(rank, world, port, run_dir, device, n_rows):
    """One rank of phase 8 (spawned; every rank runs the same calls): joins
    the gloo group, makes phase 4's rows on the card from the launcher's
    seed, and runs (a) the sharded build, (b) the sharded search and (c)
    ``build_parallel`` on the group, each timed between barriers with the
    launch counts zeroed just before it.  Rank 0 writes what the parent
    checks to ``run_dir/mesh.pt``.  ``device``/``n_rows`` are the card and
    phase 4's row count (a CPU rehearsal passes "cpu" and fewer rows)."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    from repro_torch.configs import knn_lgd
    from repro_torch.core import construct, distributed
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.graph import graph_invariants_ok
    from repro_torch.kernels import ops
    from repro_torch.launch import build_graph, mesh
    from repro_torch.obs import InMemoryTracker

    run_dir = Path(run_dir)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    grp = mesh.init_group(rank, world, "gloo", port, timeout_s=900)
    x = build_graph.make_data(n_rows, knn_lgd.D, "l2", dev)
    q = torch.load(run_dir / "queries.pt").to(dev)
    n = x.shape[0]
    cfg = knn_lgd.full_config()

    def timed(fn):
        dist.barrier(grp)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        dist.barrier(grp)
        return out, time.perf_counter() - t0

    def gathered(obj):
        objs = [None] * world
        dist.all_gather_object(objs, obj, group=grp)
        return objs

    def valid(g):
        return all(bool(v.all()) for v in graph_invariants_ok(g).values())

    # (a) per-shard exact seed graphs, then the shard step in lockstep waves
    def sharded_build():
        g, xs = distributed.init_sharded_state(grp, x, cfg, device=dev)
        n_seed = g.n_valid
        step = distributed.make_distributed_build_step(grp, cfg)
        draws, pos, comps, edges, waves = TorchDraws(build_graph.BUILD_SEED), n_seed, 0, 0, 0
        while pos < xs.shape[0]:
            nr = min(cfg.wave, xs.shape[0] - pos)
            draws, sub = draws.split()
            g, c, e = step(g, xs, pos, nr, sub)
            comps, edges, pos, waves = comps + c, edges + e, pos + nr, waves + 1
        return g, xs, comps + world * (n_seed * (n_seed - 1) // 2), edges, waves

    ops.reset_launch_counts()
    (g, xs, comps, edges, waves), t = timed(sharded_build)
    out = {"x_sum": float(x.double().sum())}
    out["build"] = dict(seconds=t, waves=waves, comps=comps, edges=edges,
                        launches=gathered(ops.launch_counts()), n_valid=gathered(g.n_valid),
                        invariants_ok=gathered(valid(g)))

    # (b) the scatter-gather search in waves, then with shard 0 blanked
    search = distributed.make_distributed_search(grp, cfg.search_config())

    def serve(graph):
        ids, lat = [], []
        for w in range(0, q.shape[0], MESH_WAVE):
            sync()
            t0 = time.perf_counter()
            i, _ = search(graph, xs, q[w:w + MESH_WAVE], TorchDraws(SEARCH_SEED).fold_in(w))
            sync()
            lat.append((time.perf_counter() - t0) * 1e3)
            ids.append(i)
        return torch.cat(ids), lat

    ops.reset_launch_counts()
    ids, lat = serve(g)
    counts = gathered(ops.launch_counts())
    blanked = g._replace(alive=torch.zeros_like(g.alive)) if rank == 0 else g
    blank_ids, _ = serve(blanked)
    out["search"] = dict(ids=ids.cpu(), blank_ids=blank_ids.cpu(), latency_ms=lat, launches=counts)
    del g, xs, blanked

    # (c) build_parallel on the group
    ops.reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    trk = InMemoryTracker()
    (gp, st), t = timed(lambda: construct.build_parallel(
        x, cfg, TorchDraws(build_graph.BUILD_SEED), shards=world, refine_rounds=1,
        mesh=grp, tracker=trk, device=dev))
    spans = {}
    for e in trk.span_events:
        spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur_s"]
    rows = torch.arange(0, n, max(1, n // 10_000), device=dev)[:10_000]
    mine = gp.nbr_ids[rows].cpu()
    sums = gathered([float(getattr(gp, f).double().sum()) for f in ("nbr_ids", "nbr_dist", "nbr_lam")])
    out["parallel"] = dict(
        seconds=t, spans=spans, comps=int(st.n_comps), waves=st.n_waves,
        launches=gathered(ops.launch_counts()), invariants_ok=gathered(valid(gp)),
        peak=gathered(torch.cuda.max_memory_allocated() if on_card else 0), nbr_ids_rows=mine,
        same_on_every_rank=all(s == sums[0] for s in sums))
    if rank == 0:
        torch.save(out, run_dir / "mesh.pt")
    dist.barrier(grp)
    mesh.close_group()


def _train_rank(rank, world, port, run_dir, device):
    """One rank of phase 10d (spawned): joins the gloo group, splits it into
    ``DP_PODS`` pods (``launch.mesh.dp_groups``), draws phase 10c's molecule
    batch and MACE's parameters from their seeds, and trains on its rows
    ``DP_STEPS`` SGD steps with the pod hop compressed, then as many
    uncompressed, each run timed between barriers.  Rank 0 writes what the
    parent checks to ``run_dir/train_dp.pt``, with the same steps in one
    process on the whole batch.  ``device`` is the card ("cpu" in a CPU
    rehearsal)."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    from repro_torch.launch import mesh
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_loop

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    grp = mesh.init_group(rank, world, "gloo", port, timeout_s=600)
    groups = mesh.dp_groups(DP_PODS)
    params0, batch, loss = molecule_problem(torch, dev)
    ocfg = opt_lib.OptConfig(name="sgd", lr=DP_LR)
    out = {}
    for compress in (True, False):
        p, opt = params0, opt_lib.init_opt_state(params0, ocfg)
        err = train_loop.init_pod_error_state(p)
        step = train_loop.make_sharded_train_step(loss, ocfg, groups, compress_pod=compress)
        local = groups.local_rows(batch)
        p, opt, err, m = step(p, opt, err, local)  # warm-up, counted among the steps
        sync()
        dist.barrier(grp)
        t0 = time.perf_counter()
        for _ in range(DP_STEPS - 1):
            p, opt, err, m = step(p, opt, err, local)
        sync()
        dist.barrier(grp)
        tag = "comp" if compress else "full"
        out[tag + "_ms"] = (time.perf_counter() - t0) * 1e3 / (DP_STEPS - 1)
        out[tag + "_loss"] = float(m["loss"])
        mine = {k: v.cpu() for k, v in p.items()}
        everyone = [None] * world
        dist.all_gather_object(everyone, mine, group=grp)
        out[tag + "_replicated"] = all(torch.equal(o[k], mine[k]) for o in everyone for k in mine)
        out[tag + "_params"] = mine
    if rank == 0:
        p, opt = params0, opt_lib.init_opt_state(params0, ocfg)
        step = train_loop.make_train_step(loss, ocfg)
        for _ in range(DP_STEPS):
            p, opt, m = step(p, opt, batch)
        out["single_params"] = {k: v.cpu() for k, v in p.items()}
        out["single_loss"] = float(m["loss"])
        torch.save(out, Path(run_dir) / "train_dp.pt")
    dist.barrier(grp)
    mesh.close_group()


def molecule_problem(torch, dev):
    """(params, batch, loss_fn) of MACE at full_config("molecule") on
    ``MOLECULES`` molecules of 30 atoms with ``MOL_K``-NN edges and random
    target energies, drawn from ``MACE_*_SEED`` on ``dev``."""
    from repro_torch.configs import mace_cfg
    from repro_torch.data import graphs
    from repro_torch.models import mace

    cfg = mace_cfg.full_config("molecule")
    g = torch.Generator(device=dev).manual_seed(MACE_DATA_SEED)
    n_atoms = mace_cfg.SHAPES["molecule"]["n_nodes"]
    pos, spec = graphs.molecules(g, MOLECULES, n_atoms, n_species=cfg.n_species)
    edges = [graphs.knn_edges_from_positions(x, MOL_K) for x in pos]
    batch = dict(positions=pos, species=spec, senders=torch.stack([e[0] for e in edges]),
                 receivers=torch.stack([e[1] for e in edges]),
                 energy=torch.randn((MOLECULES,), generator=g, device=dev))
    params = mace.init_params(torch.Generator(device=dev).manual_seed(MACE_PARAM_SEED), cfg)

    def loss(p, b):
        return mace.energy_loss(p, b, cfg)

    return params, batch, loss


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.rec = {name: {"max_abs_err": 0.0} for name in KERNELS}
        self.launches = {}  # kernel -> launches in the build of its precision
        self.serve_launches = {}  # kernel -> launches in the serving run
        self.path_launches = {}  # phase 7 path -> its launch counts
        from repro_torch.kernels import _cuda, ops
        from repro_torch.launch import bench_gather, profile_build

        self._cuda, self.ops, self.profile, self.bench = _cuda, ops, profile_build, bench_gather

    # ------------------------------------------------------------------ utils
    def gen(self, seed):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    def compare(self, kernel, got, want, *, exact, what):
        torch = self.torch
        got, want = got.float(), want.float()
        check(got.shape == want.shape, f"{kernel} {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)), f"{kernel} {what}: +inf pattern differs")
        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
        if exact:
            check(torch.equal(got, want), f"{kernel} {what}: not bit-identical (max err {err})")
        else:
            ok = torch.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
            check(ok, f"{kernel} {what}: max abs err {err} beyond rtol={RTOL} atol={ATOL}")
            self.rec[kernel]["max_abs_err"] = max(self.rec[kernel]["max_abs_err"], err)
        return err

    def data(self, n, d, seed, *, integer=False, metric="l2"):
        torch = self.torch
        g = self.gen(seed)
        if integer:
            return torch.randint(0, 16, (n, d), generator=g, device=self.dev).float()
        x = torch.randn((n, d), generator=g, device=self.dev)
        return x.abs() if metric == "chi2" else x

    # ---------------------------------------------------------------- phase 1
    def build_kernels(self):
        t0 = time.perf_counter()
        built = self._cuda.build()
        print(f"kernels built in {time.perf_counter() - t0:.3f} s: "
              + ", ".join(sorted(built)), flush=True)

    # ---------------------------------------------------------------- phase 2
    def phase_kernels(self):
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core.graph import squared_norms
        from repro_torch.launch import build_graph
        from repro_torch.kernels import distance, ref
        from repro_torch.kernels.precision import encode_dataset

        t0 = time.perf_counter()
        for metric in METRICS:
            for integer in (False, True):
                # 16-byte loads at every storage type, and the scalar path
                for d in (80, 70):
                    x = self.data(500, d, 1, integer=integer, metric=metric)
                    q = self.data(33, d, 2, integer=integer, metric=metric)
                    sq = squared_norms(x)
                    idx = torch.randint(-1, 500, (33, 19), generator=self.gen(3), device=self.dev).int()
                    what = f"{metric} d={d} {'int' if integer else 'gauss'}"
                    for precision in ("fp32",) + VARIANTS:
                        enc = encode_dataset(x, precision)
                        exact = integer and exact_for(metric, precision)
                        self.compare(kernel_name("gather_distance", precision),
                                     self.ops.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc,
                                                              precision=precision),
                                     ref.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc,
                                                         precision=precision),
                                     exact=exact, what=what)
                        self.check_expand(x, q, sq, metric, integer, B=33, C=23, e=16, H=64, P=4,
                                          steps=3, enc=enc, precision=precision)
                    for xn in ((None, sq) if metric == "l2" else (None,)):
                        xn = None if xn is None else xn[:130]
                        self.compare("pairwise_distance",
                                     distance.pairwise_distance(q, x[:130], metric, x_sq_norms=xn),
                                     ref.pairwise_distance(q, x[:130], metric, x_sq_norms=xn),
                                     exact=integer and metric in EXACT_METRICS,
                                     what=what + (" cached" if xn is not None else ""))
                        # bf16 operands (cosine normalizes in fp32: the fp32 kernel)
                        qb, xb = q.bfloat16(), x[:130].bfloat16()
                        bwhat = what + " bf16 operands" + (" cached" if xn is not None else "")
                        if metric == "cosine":
                            self.compare("pairwise_distance",
                                         distance.pairwise_distance(qb, xb, metric, x_sq_norms=xn),
                                         ref.pairwise_distance(qb, xb, metric, x_sq_norms=xn),
                                         exact=integer and metric in EXACT_METRICS, what=bwhat)
                        else:
                            self.check_bf16_pair(qb, xb, metric, xn,
                                                 exact=integer and metric in EXACT_METRICS,
                                                 what=bwhat)
        print(f"phase 2a: small shapes, five metrics, fp32/bf16/int8 tables, fp32 and bf16 "
              f"pairwise operands: kernels agree with plain ({time.perf_counter() - t0:.3f} s)",
              flush=True)

        # main-path shapes (l2, d=128): seed gather B=4096 C=8, expansion
        # B=4096 C=60 e=40 H=2048 P=8, intra-wave tile 4096², brute tile
        d = knn_lgd.D
        xf = build_graph.make_data(knn_lgd.N_ROWS, d, "l2", self.dev)
        xi = self.data(200_000, d, 8, integer=True)
        for x, integer in ((xf, False), (xi, True)):
            sq = squared_norms(x)
            q, idx = self.bench.main_inputs(x)
            sets = None if integer else self.bench.timing_sets("main", x)
            for precision in ("fp32",) + VARIANTS:
                enc = encode_dataset(x, precision)
                what = f"main shape {precision} {'int' if integer else 'clustered'}"
                got = self.ops.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                want = ref.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                self.compare(kernel_name("gather_distance", precision), got, want,
                             exact=integer, what=what)
                if not integer:
                    self.time_gather(x, sets, precision)
                self.check_expand(x, q, sq, "l2", integer, B=4096, C=60, e=40, H=2048, P=8,
                                  steps=1, timed=not integer, enc=enc, precision=precision)
            del sets
            xq = x[:4096]
            sqq = sq[:4096]
            got = distance.pairwise_distance(xq, xq, "l2", x_sq_norms=sqq)
            self.compare("pairwise_distance", got, ref.pairwise_distance(xq, xq, "l2", x_sq_norms=sqq),
                         exact=integer, what=f"intra-wave tile {'int' if integer else 'clustered'}")
            xqb = xq.bfloat16()
            sqb = squared_norms(xqb)
            form = self.check_bf16_pair(
                xqb, xqb, "l2", sqb, exact=integer,
                what=f"intra-wave tile, bf16 operands {'int' if integer else 'clustered'}")
            check(form == "wgmma", "the bf16 intra-wave tile did not take the tensor-core form")
            if not integer:
                self.time_pairwise(xq, xq, sqq, prefix="")
                self.time_pairwise(xqb, xqb, sqb, prefix="")
                self.time_pairwise(x[::100][:10_000].contiguous(), x[:8192], sq[:8192])
                self.tile_topk_shapes(x)
                # the data_bf16 build's own bf16 shapes: phase 3's intra-wave
                # tile (W=1024, d=32) and the knn-lgd build's seed graph
                # (its 256 first rows, one brute tile)
                x32 = x[:1024, :32].bfloat16()
                self.time_pairwise(x32, x32, squared_norms(x32), prefix="tile1024_")
                self.time_pairwise(xqb[:256], xqb[:256], sqb[:256], prefix="seed_")
        self.xf = xf
        print("phase 2b: main-path shapes: kernels agree with plain", flush=True)

        # the gather at a large candidate count (refine's, the serving
        # searches'), where a query's candidates are split over warps
        for integer in (False, True):
            x, q, idx = self.bench.large_c_inputs(self.dev, integer=integer)
            sq = squared_norms(x)
            for precision in ("fp32",) + VARIANTS:
                enc = encode_dataset(x, precision)
                what = f"large C {precision} {'int' if integer else 'gauss'}"
                got = self.ops.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                want = ref.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                self.compare(kernel_name("gather_distance", precision), got, want,
                             exact=integer, what=what)
                if not integer:
                    self.time_gather(x, self.bench.timing_sets("large_c", x), precision,
                                     prefix="large_c_")
            del x, enc
        print("phase 2b: gather at a large candidate count: kernels agree with plain", flush=True)
        self.serving_shapes(xi)
        self.merge_shapes(xi)

    def merge_shapes(self, xi):
        """The merge's shapes over the 10^6 rows, d=128: the second-hop
        gather of ``ops.merge_proposals`` (one row chunk,
        ``MERGE_PROPOSAL_ROWS`` queries x C = HOP_TOP * k = 400 ids, 5% of
        them -1) and the cross searches' seed gather and expansion
        (``cross_search_shapes``); timed on clustered rows."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core.graph import squared_norms
        from repro_torch.core.merge import HOP_TOP
        from repro_torch.kernels import ref

        B, C = self.ops.MERGE_PROPOSAL_ROWS, HOP_TOP * knn_lgd.full_config().k
        for x, integer in ((self.xf, False), (xi, True)):
            n = x.shape[0]
            sq = squared_norms(x)
            sets = []
            for k in range(1 if integer else 10):
                g = self.gen(70 + k)
                q = x[torch.randint(0, n, (B,), generator=g, device=self.dev)]
                idx = torch.randint(0, n, (B, C), generator=g, device=self.dev).int()
                drop = torch.rand((B, C), generator=g, device=self.dev) < 0.05
                sets.append((q, torch.where(drop, -1, idx)))
            q, idx = sets[0]
            self.compare("gather_distance", self.ops.gather_distance(q, x, idx, "l2", sq_norms=sq),
                         ref.gather_distance(q, x, idx, "l2", sq_norms=sq), exact=integer,
                         what=f"merge_proposals B={B} C={C} {'int' if integer else 'clustered'}")
            if not integer:
                self.time_gather(x, sets, "fp32", prefix="merge_")
            del sets
            self.cross_search_shapes(x, sq, integer)
        print(f"phase 2d: the merge's second-hop gather (B={B} C={C} d=128) and its cross "
              f"searches' seed gather and expansion (B = {MERGE_CHUNK}, the host path's chunk; "
              f"{knn_lgd.N_ROWS // MESH_RANKS} and {knn_lgd.N_ROWS // 2}, the mesh path's sides): "
              "kernels agree with plain", flush=True)

    def cross_search_shapes(self, x, sq, integer):
        """The merge levels' cross searches at phase 4's 10^6 rows: the host
        path's chunk of ``MERGE_CHUNK`` lanes (phases 7a, 7c) and the mesh
        path's whole sides, n/4 lanes at level 0 and n/2 at level 1 (phase
        8c): the seed gather of n_seeds random entry points and the
        expansion at the build's search shape (C = k + R, e = beam, H,
        P = hash_probes), fp32; timed on clustered rows, the chunk's gather
        over cold sets, the sides' over four (each reads far more rows than
        the L2 holds)."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.kernels import ref

        cfg = knn_lgd.full_config()
        scfg = cfg.search_config()
        C = cfg.k + (cfg.rev_cap or 2 * cfg.k)  # a row's forward and reverse lists
        p, n = scfg.n_seeds, x.shape[0]
        for B, prefix in ((MERGE_CHUNK, "merge_chunk_"),
                          (knn_lgd.N_ROWS // MESH_RANKS, "merge_mesh0_"),
                          (knn_lgd.N_ROWS // 2, "merge_mesh1_")):
            sets = []
            for k in range(1 if integer else (self.bench.COLD_SETS if B <= MERGE_CHUNK else 4) + 2):
                g = self.gen(80 + k)
                sets.append((x[torch.randint(0, n, (B,), generator=g, device=self.dev)],
                             torch.randint(0, n, (B, p), generator=g, device=self.dev).int()))
            q, idx = sets[0]
            what = f"cross search B={B} {'int' if integer else 'clustered'}"
            self.compare("gather_distance", self.ops.gather_distance(q, x, idx, "l2", sq_norms=sq),
                         ref.gather_distance(q, x, idx, "l2", sq_norms=sq), exact=integer,
                         what=f"{what} seed gather C={p}")
            if not integer:
                self.time_gather(x, sets, "fp32", prefix=prefix + "seed_")
            del sets
            self.check_expand(x, q, sq, "l2", integer, B=B, C=C, e=scfg.beam, H=scfg.hash_slots,
                              P=scfg.hash_probes, steps=1, timed=not integer, enc=None,
                              precision="fp32", prefix=prefix)
            del q, idx
            torch.cuda.empty_cache()

    def serving_shapes(self, xi):
        """The serving searches' shapes: the coarse seed gather (C=44) and
        the expansion at beam 64 (C=60, e=64, H=2048), at B = 1, 37, 64;
        the pairwise tiles of the recall audit and of nearest_landmark."""
        torch = self.torch
        from repro_torch.core.graph import squared_norms
        from repro_torch.core.search import auto_hash_slots
        from repro_torch.kernels import distance, ref
        from repro_torch.kernels.precision import encode_dataset

        H = auto_hash_slots(64, 60)
        for x, integer in ((self.xf, False), (xi, True)):
            sq = squared_norms(x)
            n = x.shape[0]
            for B in (1, 4, 37, 64):
                g = self.gen(50 + B)
                q = x[torch.randint(0, n, (B,), generator=g, device=self.dev)]
                idx = torch.randint(-1, n, (B, 44), generator=g, device=self.dev).int()
                timed = B == 64 and not integer
                # the router's request (B=4): the expansion timed at fp32
                router = B == REQUEST and not integer
                for precision in ("fp32",) + VARIANTS:
                    enc = encode_dataset(x, precision)
                    what = f"serving B={B} C=44 {precision} {'int' if integer else 'clustered'}"
                    kw = dict(sq_norms=sq, enc=enc, precision=precision)
                    self.compare(kernel_name("gather_distance", precision),
                                 self.ops.gather_distance(q, x, idx, "l2", **kw),
                                 ref.gather_distance(q, x, idx, "l2", **kw), exact=integer, what=what)
                    if timed:
                        sets = [(x[torch.randint(0, n, (B,), generator=g, device=self.dev)],
                                 torch.randint(0, n, (B, 44), generator=g, device=self.dev).int())
                                for _ in range(self.bench.COLD_SETS + 2)]
                        self.time_gather(x, sets, precision, prefix="serve_")
                    self.check_expand(x, q, sq, "l2", integer, B=B, C=60, e=64, H=H, P=8,
                                      steps=2, timed=timed, enc=enc, precision=precision,
                                      prefix="serve_")
                    if router and precision == "fp32":
                        self.check_expand(x, q, sq, "l2", integer, B=B, C=60, e=64, H=H, P=8,
                                          steps=1, timed=True, enc=enc, precision=precision,
                                          prefix="router_")
            if not integer:
                self.router_seed_gather(x, sq)
            # the recall audit's brute tile (the reservoir's 96 queries
            # against 8192 rows, norms not cached), nearest_landmark's chunk
            # (4096 rows against 4000 landmarks, uncached) and the router's
            # brute tile (one request's 4 queries against 8192 rows)
            g = self.gen(60)
            rows = torch.randperm(n, generator=g, device=self.dev)
            for m, nt, what, prefix in ((96, 8192, "audit tile", None),
                                        (4096, 4000, "nearest_landmark", None),
                                        (REQUEST, 8192, "router brute tile", "router_")):
                q, xt = x[rows[:m]], x[rows[m:m + nt]]
                self.compare("pairwise_distance", distance.pairwise_distance(q, xt, "l2"),
                             ref.pairwise_distance(q, xt, "l2"), exact=integer,
                             what=f"{what} m={m} n={nt} {'int' if integer else 'clustered'}")
                if not integer:
                    self.time_pairwise(q, xt, None, prefix=prefix)
        print(f"phase 2c: serving shapes (B in 1, 4, 37, 64; gather C=44; expand C=60 e=64 H={H}; "
              f"pairwise 96x8192, 4096x4000 and {REQUEST}x8192 uncached): kernels agree with plain",
              flush=True)

    def router_seed_gather(self, x, sq):
        """The seed gather of one router request as ``ShardedIndex.retrieve``
        runs it: each shard's search scores B=4 queries' p=8 random entry
        points over its block of the rows (n / 4), fp32; held against plain
        and timed over cold sets."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.kernels import ref

        shard = x[: x.shape[0] // ROUTER_SHARDS]
        sq = sq[: shard.shape[0]]
        p = knn_lgd.full_config().n_seeds
        g = self.gen(90)
        sets = [(x[torch.randint(0, x.shape[0], (REQUEST,), generator=g, device=self.dev)],
                 torch.randint(0, shard.shape[0], (REQUEST, p), generator=g, device=self.dev).int())
                for _ in range(self.bench.COLD_SETS + 2)]
        q, idx = sets[0]
        self.compare("gather_distance", self.ops.gather_distance(q, shard, idx, "l2", sq_norms=sq),
                     ref.gather_distance(q, shard, idx, "l2", sq_norms=sq), exact=False,
                     what=f"router seed gather B={REQUEST} C={p}")
        self.time_gather(shard, sets, "fp32", prefix="router_")

    def time_gather(self, x, sets, precision, prefix="", metric="l2"):
        """Time the gather over the query and id ``sets`` of one shape
        (``bench_gather.measure``: kernel cold and warm, empty launch at its
        grid, ``index_select``, plain version, bound) into the record's
        ``prefix`` keys."""
        m = self.bench.measure(x, sets, precision, metric)
        B, C, d = m["B"], m["C"], m["d"]
        keys = ("ms", "warm_ms", "plain_ms", "floor_ms", "index_select_ms", "bound_ms",
                "bound_by")
        rec = {prefix + k: m[k] for k in keys}
        rec[prefix + "shape"] = f"B={B} C={C} d={d}" + ("" if metric == "l2" else f" {metric}")
        self.rec[kernel_name("gather_distance", precision)].update(rec, library_ms=None)
        print(f"{kernel_name('gather_distance', precision)} B={B} C={C} d={d}"
              + ("" if metric == "l2" else f" {metric}") + ": kernel "
              f"{m['ms']:.6f} ms (warm {m['warm_ms']:.6f} ms), plain {m['plain_ms']:.6f} ms, "
              f"empty launch {m['floor_ms']:.6f} "
              f"ms, index_select {m['index_select_ms']:.6f} ms, bound {m['bound_ms']:.6f} ms "
              f"({m['bound_by']})", flush=True)

    def time_pairwise(self, q, x, xn, *, prefix=None, metric="l2"):
        """Time the pairwise kernel (a bf16-operand form for bf16 rows), its
        plain version, the library's product and ``torch.cdist`` at one
        shape under ``metric``; with a ``prefix``, into the record's keys
        under it.  The library time is ``torch.mm`` in IEEE fp32 for fp32
        rows, and for bf16 rows ``torch.mm`` with fp32 output on the bf16
        rows (the same function: exact products, fp32 sums), the fp32
        ``torch.mm`` on the widened rows beside it (``widened_mm_ms``).
        Where the tensor-core form runs, its record takes the same times and
        the SIMT form's time on the same rows (``simt_ms``, a launch that
        does not count)."""
        torch = self.torch
        from repro_torch.kernels import distance, ref

        m, d = q.shape
        n = x.shape[0]
        bf16 = q.dtype == torch.bfloat16
        name = "pairwise_distance.bf16" if bf16 else "pairwise_distance"
        wgmma = bf16 and distance.bf16_form(metric, d, True) == "wgmma"
        ms = self.profile.time_ms([lambda: distance.pairwise_distance(q, x, metric, x_sq_norms=xn)] * 12)
        plain_ms = self.profile.time_ms([lambda: ref.pairwise_distance(q, x, metric, x_sq_norms=xn)] * 12)
        # the product alone in IEEE fp32 (TF32 is off), and the library's
        # own distance, which takes square roots and reduces its own norms
        qf, xf = q.float(), x.float()
        mm_ms = self.profile.time_ms([lambda: torch.mm(qf, xf.T)] * 12)
        cdist_ms = self.profile.time_ms([lambda: torch.cdist(qf, xf)] * 12)
        extra = {}
        if bf16:
            extra["widened_mm_ms"] = mm_ms
            mm_ms = self.profile.time_ms([lambda: torch.mm(q, x.T, out_dtype=torch.float32)] * 12)
        if wgmma:
            extra["simt_ms"] = self.profile.time_ms([lambda: simt_bf16(self._cuda, q, x, metric, xn)] * 12)
        # each input read once in its storage type (the x norms only where
        # cached), the output written once
        nbytes = q.element_size() * (m * d + n * d) + 4 * ((0 if xn is None else n) + m * n)
        b, how = self.profile.bound_ms(nbytes, 2 * m * n * d, "bf16" if bf16 else "fp32")
        print(f"{name}{'_wgmma' if wgmma else ''} m={m} n={n} d={d} {metric}: kernel {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms, torch.mm {mm_ms:.6f} ms"
              + "".join(f", {k} {v:.6f}" for k, v in extra.items())
              + f", torch.cdist {cdist_ms:.6f} ms, bound {b:.6f} ms ({how})", flush=True)
        if prefix is not None:
            shape = f"m={m} n={n} d={d} {'cached' if xn is not None else 'uncached'} {metric}"
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=how, library_ms=mm_ms,
                       cdist_ms=cdist_ms, shape=shape, **extra)
            for key in (name, "pairwise_distance.bf16_wgmma") if wgmma else (name,):
                self.rec[key].update({prefix + k: v for k, v in rec.items()})

    def tile_topk_shapes(self, x):
        """The running top-k of a brute tile at the exact cell's shape
        (10,000 queries, 8,192-row tiles, k=10), the recall audit's (96,
        k=10) and a router request's (4, k=20), on the pairwise kernel's own
        distances over clustered rows: three chained tiles held against the
        plain version bit for bit (ids and distance bits), then the kernel
        timed on the first tile (from the empty best) and on the third (from
        the running best of two), the plain version, and ``torch.topk`` on
        the int64 key ``(sort_key(d) << 32) | column`` of the concatenation,
        the library yardstick (checked against plain, never called by the
        port), beside the bound: the tile read once, the best read and
        written once."""
        torch = self.torch
        from repro_torch.kernels import ref

        n = x.shape[0]
        rows = torch.randperm(n, generator=self.gen(61), device=self.dev)
        T = 8192
        tiles = [x[rows[i * T:(i + 1) * T]] for i in range(3)]

        def library(dt, best_d, best_i, lo):
            m, k = best_d.shape
            cat_d = torch.cat([best_d, dt], dim=1)
            cat_i = torch.cat([best_i, (lo + torch.arange(T, dtype=torch.int32, device=self.dev))
                               .expand(m, T)], dim=1)
            col = torch.arange(k + T, dtype=torch.int64, device=self.dev)
            key = (ref.sort_key(cat_d).long() << 32) | col
            order = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
            return torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)

        for m, k, what, prefix in ((10_000, 10, "exact cell's tile", ""),
                                   (96, 10, "audit tile", "audit_"),
                                   (REQUEST, 20, "router brute tile", "router_")):
            q = x[rows[-m:]]
            dts = [self.ops.pairwise_distance(q, xt, "l2") for xt in tiles]
            empty = (torch.full((m, k), float("inf"), device=self.dev),
                     torch.full((m, k), -1, dtype=torch.int32, device=self.dev))
            got = want = empty
            for t, dt in enumerate(dts):
                before = self.ops.launch_counts()["tile_topk"]
                got = self.ops.tile_topk(dt, *got, t * T, n)
                check(self.ops.launch_counts()["tile_topk"] == before + 1,
                      f"tile_topk {what}: not launched")
                want = ref.tile_topk(dt, *want, t * T, n)
                check(torch.equal(got[1], want[1])
                      and torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
                      f"tile_topk {what} tile {t}: not bit-identical to plain")
            run = ref.tile_topk(dts[1], *ref.tile_topk(dts[0], *empty, 0, n), T, n)
            lib = library(dts[2], *run, 2 * T)
            check(torch.equal(lib[1], want[1]) and torch.equal(lib[0], want[0]),
                  f"tile_topk {what}: the torch.topk yardstick differs from plain")
            first_ms = self.profile.time_ms([lambda: self.ops.tile_topk(dts[0], *empty, 0, n)] * 22)
            ms = self.profile.time_ms([lambda: self.ops.tile_topk(dts[2], *run, 2 * T, n)] * 22)
            plain_ms = self.profile.time_ms([lambda: ref.tile_topk(dts[2], *run, 2 * T, n)] * 8)
            lib_ms = self.profile.time_ms([lambda: library(dts[2], *run, 2 * T)] * 8)
            b, how = self.profile.bound_ms(m * T * 4 + 2 * m * k * 8, 0)
            print(f"tile_topk m={m} T={T} k={k} ({what}): kernel {ms:.6f} ms (first tile "
                  f"{first_ms:.6f} ms), plain {plain_ms:.6f} ms, torch.topk on the int64 key "
                  f"{lib_ms:.6f} ms, bound {b:.6f} ms ({how})", flush=True)
            self.rec["tile_topk"].update({prefix + key: v for key, v in dict(
                ms=ms, first_ms=first_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                bound_by=how, shape=f"m={m} T={T} k={k}").items()})

    def check_bf16_pair(self, q, x, metric, xn, *, exact, what):
        """The bf16-operand pairwise kernel against its plain version
        (``compare``); where the wrapper's form is the tensor-core one, its
        own count must move and it is also held against the fp32 kernel on
        the widened rows: equal on integer rows, else within WGMMA_RTOL of
        ‖q‖² + ‖x‖².  Returns the form."""
        torch = self.torch
        from repro_torch.kernels import distance, ref

        name = "pairwise_distance.bf16_wgmma"
        aligned = q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
        form = distance.bf16_form(metric, q.shape[1], aligned)
        before = self.ops.launch_counts()[name]
        got = distance.pairwise_distance(q, x, metric, x_sq_norms=xn)
        ran = self.ops.launch_counts()[name] - before
        check(ran == (form == "wgmma"), f"pairwise_distance.bf16 {what}: form {form}, {ran} "
              f"launches of the tensor-core form")
        want = ref.pairwise_distance(q, x, metric, x_sq_norms=xn)
        self.compare("pairwise_distance.bf16", got, want, exact=exact, what=what)
        if form == "wgmma":
            widened = distance.pairwise_distance(q.float(), x.float(), metric, x_sq_norms=xn)
            if exact:
                check(torch.equal(got, widened),
                      f"{name} {what}: not bit-identical to the fp32 kernel on the widened rows")
            else:
                scale = (q.float() ** 2).sum(-1)[:, None] + (x.float() ** 2).sum(-1)[None, :]
                rel = float(((got - widened).abs() / scale.clamp_min(1e-30)).max())
                check(rel <= WGMMA_RTOL, f"{name} {what}: {rel:.3e} of |q|^2 + |x|^2 from the fp32 "
                      f"kernel on the widened rows, beyond {WGMMA_RTOL:.0e}")
                self.rec[name]["max_abs_err"] = max(self.rec[name]["max_abs_err"],
                                                    float((got - want).abs().max()))
                self.rec[name]["max_rel_fp32"] = max(self.rec[name].get("max_rel_fp32", 0.0), rel)
        return form

    def plain_expand(self, q, x, *lanes, **kw):
        """``expand.expand_reference(q, x, cands, beam..., hash...)`` in
        lane slices of ``PLAIN_LANES``: a lane's step reads and writes only
        its own rows, so the slices give the whole batch's result, and the
        plain version's (B, C, d) gather stays a few GB at the mesh's
        500,000 lanes."""
        torch = self.torch
        from repro_torch.kernels import expand

        B = q.shape[0]
        if B <= PLAIN_LANES:
            return expand.expand_reference(q, x, *lanes, **kw)
        parts = [expand.expand_reference(q[lo:lo + PLAIN_LANES], x,
                                         *(t[lo:lo + PLAIN_LANES] for t in lanes), **kw)
                 for lo in range(0, B, PLAIN_LANES)]
        return tuple(torch.cat(ts) for ts in zip(*parts))

    def expand_state(self, x, q, sq, metric, B, C, e, H, P, warm, enc, precision):
        """A mid-search state: ``warm`` plain expansion steps from random
        candidates, then candidates half already visited, some -1."""
        torch = self.torch

        n = x.shape[0]
        g = self.gen(11)
        beam_ids = torch.full((B, e), -1, dtype=torch.int32, device=self.dev)
        beam_dist = torch.full((B, e), float("inf"), device=self.dev)
        beam_exp = torch.ones((B, e), dtype=torch.bool, device=self.dev)
        vis_ids = torch.full((B, H), -1, dtype=torch.int32, device=self.dev)
        vis_dist = torch.full((B, H), float("inf"), device=self.dev)

        def cands():
            c = torch.randint(0, n, (B, C), generator=g, device=self.dev).int()
            seen = torch.gather(vis_ids, 1, torch.randint(0, H, (B, C), generator=g, device=self.dev))
            half = torch.rand((B, C), generator=g, device=self.dev) < 0.5
            c = torch.where(half & (seen >= 0), seen, c)
            return torch.where(torch.rand((B, C), generator=g, device=self.dev) < 0.15, -1, c)

        for _ in range(warm):
            beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, _ = self.plain_expand(
                q, x, cands(), beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
                metric=metric, probes=P, sq_norms=sq, enc=enc, precision=precision)
        return cands(), beam_ids, beam_dist, beam_exp, vis_ids, vis_dist

    def check_expand(self, x, q, sq, metric, integer, *, B, C, e, H, P, steps, enc, precision,
                     timed=False, prefix=""):

        name = kernel_name("fused_expand", precision)
        exact = integer and exact_for(metric, precision)
        state = self.expand_state(x, q, sq, metric, B, C, e, H, P, 2 if H < 1024 else 6,
                                  enc, precision)
        if timed:
            self.time_expand(x, q, sq, state, P, enc, precision, prefix)
        for step in range(steps):
            cands, bi, bd, be, vi, vd = state
            kw = dict(metric=metric, sq_norms=sq, enc=enc, precision=precision)
            got = self.ops.expand_step(q, x, cands, bi, bd, be, vi.clone(), vd.clone(),
                                       hash_probes=P, **kw)
            want = self.plain_expand(q, x, cands, bi, bd, be, vi.clone(), vd.clone(),
                                           probes=P, **kw)
            what = (f"{metric} B={B} C={C} e={e} H={H} step {step} "
                    f"{'int' if integer else 'float'}")
            # which ids win the beam depends on the distances' last bits
            # where they are not exact (int8 l1/chi2 sums its dequantized
            # elements in another order)
            self.compare_expand(name, got, want, what, exact=exact,
                                beam_ids=integer and (exact or precision == "fp32"))
            state = (cands.roll(1, dims=1),) + tuple(want[:5])

    def compare_expand(self, name, got, want, what, *, exact, beam_ids):
        """One expansion step's outputs, kernel against plain: the hash ids
        and comps exactly (they never depend on distance values), the
        distances bit for bit where ``exact`` and to the tolerance
        elsewhere, the beam's ids and flags where ``beam_ids``."""
        for i, field in ((3, "vis_ids"), (5, "comps")):
            self.compare(name, got[i], want[i], exact=True, what=f"{what} {field}")
        err = max(self.compare(name, got[i], want[i], exact=exact, what=f"{what} {field}")
                  for i, field in ((1, "beam_dist"), (4, "vis_dist")))
        if beam_ids:
            for i, field in ((0, "beam_ids"), (2, "beam_exp")):
                self.compare(name, got[i], want[i], exact=True, what=f"{what} {field}")
        return err

    def time_expand(self, x, q, sq, state, P, enc, precision, prefix="", metric="l2"):

        name = kernel_name("fused_expand", precision)
        cands, bi, bd, be, vi, vd = state
        kw = dict(metric=metric, sq_norms=sq, enc=enc, precision=precision)
        # every call gets its own copy of the hash it updates in place: 12
        # calls (2 warm-up), fewer where the copies would pass 8 GB (the
        # mesh's sides, 4-8 GB a hash), never under 3
        reps = max(3, min(12, int(8e9 // (vi.numel() * 8))))
        hashes = [(vi.clone(), vd.clone()) for _ in range(reps)]
        ms = self.profile.time_ms([lambda h=h: self.ops.expand_step(q, x, cands, bi, bd, be, *h,
                                                                  hash_probes=P, **kw)
                                 for h in hashes], warmup=min(2, reps - 2))
        del hashes
        hashes = [(vi.clone(), vd.clone()) for _ in range(reps)]
        plain_ms = self.profile.time_ms([lambda h=h: self.plain_expand(
            q, x, cands, bi, bd, be, *h, probes=P, **kw) for h in hashes],
            warmup=min(2, reps - 2))
        del hashes
        out = self.plain_expand(q, x, cands, bi, bd, be, vi.clone(), vd.clone(), probes=P, **kw)
        B, C = cands.shape
        e, d = bi.shape[1], x.shape[1]
        fresh = int(out[5].sum())
        valid = int((cands >= 0).sum())
        inserted = int((out[3] >= 0).sum() - (vi >= 0).sum())
        nbytes = self.profile.expand_bytes(B, C, e, d, P, precision, fresh, valid, inserted)
        b, how = self.profile.bound_ms(nbytes, 2 * d * fresh)
        rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=how,
                   shape=f"B={B} C={C} e={e} H={vi.shape[1]} P={P} d={d}"
                   + ("" if metric == "l2" else f" {metric}"))
        self.rec[name].update({prefix + k: v for k, v in rec.items()}, library_ms=None)
        print(f"{name} B={B} C={C} e={e} H={vi.shape[1]} P={P} d={d} {metric} "
              f"(fresh {fresh}, inserted {inserted}): kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b:.6f} ms ({how})", flush=True)

    def atom_build(self, pos, generator_seed):
        """The atom graph's LGD build (k=8, l2, W=1024) of ``pos`` on the
        card, entry points from a generator seeded ``generator_seed``:
        (graph, stats, seconds)."""
        torch = self.torch
        from repro_torch.core import construct

        cfg = construct.BuildConfig(k=ATOM_K, metric="l2", wave=ATOM_WAVE, lgd=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, st = construct.build(pos, cfg, generator=self.gen(generator_seed), device=self.dev)
        torch.cuda.synchronize()
        return g, st, time.perf_counter() - t0

    def exact_atom_graph(self, pos):
        """The exact k-NN ids of every atom (self excluded), through the
        pairwise kernel."""
        torch = self.torch
        from repro_torch.core import brute

        n = pos.shape[0]
        self_ids = torch.arange(n, dtype=torch.int32, device=self.dev)
        return brute.brute_force_knn(pos, pos, ATOM_K, "l2", exclude_ids=self_ids, device=self.dev)

    def phase_atom_kernels(self):
        """2e: the three kernels at d=3.  The atom build over ``ATOM_INT_N``
        integer positions (where distances tie often) and its exact graph,
        through the kernels and through the plain versions from the same
        draws: every graph array, the counters and the exact ids and
        distances bit for bit.  Then each kernel against its plain version,
        bit for bit, on arguments captured from that build (the seed gather,
        an expansion, the intra-wave tile and the exact graph's tile), and
        timed at those shapes but the last, which phase 10b times at its
        own 10^5 rows."""
        torch = self.torch
        from repro_torch import convert
        from repro_torch.kernels import ref

        n = ATOM_INT_N
        pos = torch.randint(0, ATOM_INT_HIGH, (n, 3), generator=self.gen(ATOM_INT_SEED),
                            device=self.dev).float()
        shapes = {"seed_gather": ("gather_distance", ATOM_WAVE),
                  "expand": ("expand_step", ATOM_WAVE),
                  "tile": ("pairwise_distance", ATOM_WAVE),
                  "brute_tile": ("pairwise_distance", n)}
        captured = {}
        self.ops.reset_launch_counts()
        with self.capture(shapes, captured):
            g_k, st_k, t_k = self.atom_build(pos, ATOM_BUILD_SEED)
            ids_k, d_k = self.exact_atom_graph(pos)
        counts = self.ops.launch_counts()
        for name in FP32_KERNELS:
            check(counts[name] > 0, f"phase 2e: the d=3 atom build launched no {name}")
        with self.plain_versions():
            g_p, st_p, t_p = self.atom_build(pos, ATOM_BUILD_SEED)
            ids_p, d_p = self.exact_atom_graph(pos)
        check(self.ops.launch_counts() == counts,
              "phase 2e: the plain atom build launched a kernel")
        a, b = convert.graph_to_numpy(g_k), convert.graph_to_numpy(g_p)
        for name in a:
            check((a[name] == b[name]).all(), f"phase 2e: d=3 atom graph field {name} differs, "
                                              "kernels vs plain")
        for name in ("n_comps", "n_inserted_edges"):
            check(int(getattr(st_k, name)) == int(getattr(st_p, name)),
                  f"phase 2e: d=3 atom build {name} differs, kernels vs plain")
        check(torch.equal(ids_k, ids_p) and torch.equal(d_k, d_p),
              "phase 2e: d=3 exact graph differs, kernels vs plain")
        print(f"phase 2e: {n} atoms at integer positions in [0, {ATOM_INT_HIGH})^3, k={ATOM_K}, "
              f"W={ATOM_WAVE}: graph arrays, n_comps={int(st_k.n_comps)}, edges and the exact "
              f"graph identical, kernels vs plain (kernels {t_k:.3f} s, plain {t_p:.3f} s)",
              flush=True)
        for label in shapes:
            check(label in captured, f"phase 2e: no call of {label}'s shape was seen")
            a = captured[label]
            if label == "seed_gather":
                q, x, idx, metric = a["q"], a["x"], a["idx"], a["metric"]
                self.compare("gather_distance",
                             self.ops.gather_distance(q, x, idx, metric, sq_norms=a["sq_norms"]),
                             ref.gather_distance(q, x, idx, metric, sq_norms=a["sq_norms"]),
                             exact=True, what=f"phase 2e d=3 B={q.shape[0]} C={idx.shape[1]}")
                g = self.gen(85)
                B, C = idx.shape
                sets = [(torch.randint(0, ATOM_INT_HIGH, (B, 3), generator=g,
                                       device=self.dev).float(),
                         torch.randint(0, n, (B, C), generator=g, device=self.dev).int())
                        for _ in range(self.bench.COLD_SETS + 2)]
                self.time_gather(x, sets, "fp32", prefix="atom_")
            elif label == "expand":
                args = [a[k] for k in ("q", "x", "cands", "beam_ids", "beam_dist", "beam_exp",
                                       "vis_ids", "vis_dist")]
                kw = dict(metric=a["metric"], sq_norms=a["sq_norms"])
                got = self.ops.expand_step(*args[:6], args[6].clone(), args[7].clone(),
                                           hash_probes=a["hash_probes"], **kw)
                want = self.plain_expand(*args[:6], args[6].clone(), args[7].clone(),
                                         probes=a["hash_probes"], **kw)
                B, C = args[2].shape
                self.compare_expand("fused_expand", got, want, f"phase 2e d=3 B={B} C={C}",
                                    exact=True, beam_ids=True)
                self.time_expand(args[1], args[0], a["sq_norms"], tuple(args[2:]),
                                 a["hash_probes"], None, "fp32", prefix="atom_")
            else:
                q, x, metric, xn = a["q"], a["x"], a["metric"], a["x_sq_norms"]
                self.compare("pairwise_distance",
                             self.ops.pairwise_distance(q, x, metric, x_sq_norms=xn),
                             ref.pairwise_distance(q, x, metric, x_sq_norms=xn), exact=True,
                             what=f"phase 2e d=3 m={q.shape[0]} n={x.shape[0]}")
                if label == "tile":
                    self.time_pairwise(q, x, xn, metric=metric, prefix="atom_")
        print("phase 2e: gather, expansion and pairwise at the atom build's shapes (d=3): "
              "kernels equal plain bit for bit", flush=True)

    # ---------------------------------------------------------------- phase 3
    @contextlib.contextmanager
    def plain_versions(self):
        """Route the build through the plain versions (on the card)."""
        from repro_torch.kernels import expand, ref

        ops = self.ops
        saved = (ops.pairwise_distance, ops.gather_distance, ops.expand_step, ops.tile_topk)

        def expand_step(*args, hash_probes=8, rerank_keep=0, **kw):
            return expand.expand_reference(*args, probes=hash_probes, **kw)

        ops.pairwise_distance, ops.gather_distance, ops.expand_step, ops.tile_topk = (
            ref.pairwise_distance, ref.gather_distance, expand_step, ref.tile_topk)
        try:
            yield
        finally:
            ops.pairwise_distance, ops.gather_distance, ops.expand_step, ops.tile_topk = saved

    def phase_build_parity(self):
        torch = self.torch
        from repro_torch import convert
        from repro_torch.configs import knn_lgd
        from repro_torch.core import construct

        n, d = 20_000, 32
        x = self.data(n, d, 12, integer=True)
        base = dataclasses.replace(knn_lgd.full_config(), wave=1024)
        # (what, config, kernels its build must launch, rows): the three
        # engine precisions, the build without the intra-wave tile (W=64, on
        # the first INTRA_OFF_ROWS rows: its 152 waves keep the run inside
        # its time aim), and the dataset stored bf16 (its tables, tile and
        # seed graph through bf16 kernels)
        builds = [(f"precision={p}", dataclasses.replace(base, precision=p),
                   (kernel_name("gather_distance", p), kernel_name("fused_expand", p)), x)
                  for p in ("fp32",) + VARIANTS]
        builds += [("intra_wave=False", dataclasses.replace(base, wave=64, intra_wave=False),
                    FP32_KERNELS, x[:INTRA_OFF_ROWS]),
                   ("data_bf16", dataclasses.replace(base, data_bf16=True),
                    ("gather_distance.bf16", "fused_expand.bf16", "pairwise_distance.bf16",
                     "pairwise_distance.bf16_wgmma"), x)]
        for what, cfg, kernels, rows in builds:

            def seed_fn(wave, pos, W, n_valid):
                g = torch.Generator().manual_seed(1000 + wave)
                return torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=g,
                                     dtype=torch.int32)

            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g, st = construct.build(rows, cfg, seed_fn=seed_fn, device=self.dev)
                torch.cuda.synchronize()
                return g, st, time.perf_counter() - t0

            self.ops.reset_launch_counts()
            g_k, st_k, t_k = run()
            counts = self.ops.launch_counts()
            for name in kernels:
                check(counts[name] > 0, f"n={n} {what} build launched no {name}")
            with self.plain_versions():
                g_p, st_p, t_p = run()
            check(self.ops.launch_counts() == counts, f"n={n} {what} plain build launched a kernel")
            a, b = convert.graph_to_numpy(g_k), convert.graph_to_numpy(g_p)
            for name in a:
                check((a[name] == b[name]).all(),
                      f"n={n} {what} build: field {name} differs, kernels vs plain")
            for name in ("n_comps", "n_inserted_edges"):
                check(int(getattr(st_k, name)) == int(getattr(st_p, name)),
                      f"n={n} {what} build: {name} differs, kernels vs plain")
            print(f"phase 3: n={rows.shape[0]} d={d} integer build, W={cfg.wave}, {what}: graph "
                  f"arrays, n_comps={int(st_k.n_comps)} and edges identical, kernels vs plain "
                  f"(kernels {t_k:.3f} s, plain {t_p:.3f} s)", flush=True)
            if what == "precision=fp32":
                g32, cfg32 = g_k, cfg
        self.churn_parity(g32, x, cfg32)
        self.divide_parity(x, cfg32)

    def churn_script(self, g, x, cfg):
        """Remove 2,000 rows, compact, insert 1,024 rows, then a coarse
        build, every draw injected; returns each result as numpy arrays."""
        torch = self.torch
        from repro_torch import convert
        from repro_torch.core import construct, dynamic, hierarchy

        def cpu(seed):
            return torch.Generator().manual_seed(seed)

        def seed_fn(base, n_landmarks=None):
            def fn(wave, pos, W, n_valid):
                gen = cpu(base + wave)
                seeds = torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=gen,
                                      dtype=torch.int32)
                if n_landmarks is None:
                    return seeds
                return seeds, torch.randint(0, n_landmarks, (W, cfg.n_seeds), generator=gen,
                                            dtype=torch.int32)
            return fn

        n, d = x.shape
        out = {}
        victims = torch.randperm(n, generator=cpu(2001))[:2000].to(self.dev)
        g1 = dynamic.remove(g, x, victims, cfg.metric)
        g2, x2, id_map = dynamic.compact(g1, x)
        new = torch.randint(0, 16, (1024, d), generator=cpu(2002)).float().to(self.dev)
        n0 = g2.n_valid
        x3 = torch.cat([x2[:n0], new, x2[n0 + 1024:]])
        g3, st3 = dynamic.insert(g2, x3, 1024, cfg, seed_fn=seed_fn(3000), device=self.dev)
        ccfg = dataclasses.replace(cfg, seed_mode="coarse")
        L = hierarchy.default_landmarks(n)
        g4, st4, c4 = construct.build(
            x, ccfg, seed_fn=seed_fn(5000, L), landmark_seed_fn=seed_fn(6000),
            landmark_rows=torch.randperm(n, generator=cpu(4001))[:L], return_coarse=True,
            device=self.dev)
        for i, gi in enumerate((g1, g2, g3, g4), 1):
            out.update({f"g{i}.{k}": v for k, v in convert.graph_to_numpy(gi).items()})
        out.update({f"coarse.{k}": v for k, v in convert.coarse_to_numpy(c4).items()
                    if k != "graph"})
        out.update({f"coarse.graph.{k}": v for k, v in convert.coarse_to_numpy(c4)["graph"].items()})
        out["id_map"], out["x2"] = id_map.cpu().numpy(), x2.cpu().numpy()
        out["n_comps.insert"], out["n_comps.coarse"] = int(st3.n_comps), int(st4.n_comps)
        return out

    def churn_parity(self, g, x, cfg):
        """The churn script with the kernels and with the plain versions."""
        self.ops.reset_launch_counts()
        t0 = time.perf_counter()
        a = self.churn_script(g, x, cfg)
        t_k = time.perf_counter() - t0
        counts = self.ops.launch_counts()
        for kernel in ("gather_distance", "fused_expand", "pairwise_distance"):
            check(counts[kernel] > 0, f"churn script launched no {kernel}")
        t0 = time.perf_counter()
        with self.plain_versions():
            b = self.churn_script(g, x, cfg)
        t_p = time.perf_counter() - t0
        check(self.ops.launch_counts() == counts, "plain churn script launched a kernel")
        for name in a:
            check(bool((a[name] == b[name]).all()) if hasattr(a[name], "shape")
                  else a[name] == b[name], f"churn script: {name} differs, kernels vs plain")
        print(f"phase 3: churn script on the n={x.shape[0]} fp32 graph (remove 2,000, compact, "
              f"insert 1,024, coarse build with {a['coarse.landmark_rows'].shape[0]} landmarks): "
              f"graphs, id map, coarse level and n_comps ({a['n_comps.insert']}, "
              f"{a['n_comps.coarse']}) identical, kernels vs plain (kernels {t_k:.3f} s, "
              f"plain {t_p:.3f} s; launches {json.dumps(counts)})", flush=True)

    def divide_script(self, x, cfg):
        """build_parallel (3 blocks, one refine round), then a 3-shard
        router: add 1,024 rows, remove 2,000 ids, compact, graph and brute
        retrieval, merge_shards; every draw injected.  Returns each result
        as numpy arrays and ints."""
        import numpy as np

        torch = self.torch
        from repro_torch import convert
        from repro_torch.core import construct
        from repro_torch.core import draws as draws_lib
        from repro_torch.core.draws import TorchDraws
        from repro_torch.index import ShardedIndex

        def cpu(seed):
            return torch.Generator().manual_seed(seed)

        n, d = x.shape
        out = {}
        g, st = construct.build_parallel(x, cfg, TorchDraws(7000), shards=3, refine_rounds=1,
                                         search_chunk=1024, device=self.dev)
        out.update({f"parallel.{k}": v for k, v in convert.graph_to_numpy(g).items()})
        out["parallel.n_comps"] = int(st.n_comps)
        r = ShardedIndex.build(x, 3, cfg, draws=TorchDraws(7001), device=self.dev)
        new = torch.randint(0, 16, (1024, d), generator=cpu(7002)).float().to(self.dev)
        r.add(new, seed_fn=draws_lib.wave_seed_fn(TorchDraws(7003), cfg.n_seeds, device=self.dev))
        r.remove(torch.randperm(n + 1024, generator=cpu(7004))[:2000].numpy())
        r.compact()
        q = torch.randint(0, 16, (16, d), generator=cpu(7005)).float().to(self.dev)
        out["router.ids"], out["router.scores"] = r.retrieve(q, 10, beam=64, draws=TorchDraws(7006))
        out["router.brute_ids"], out["router.brute_scores"] = r.retrieve(q, 10, brute=True)
        for s, sh in enumerate(r.shards):
            out.update({f"router{s}.{k}": v for k, v in convert.graph_to_numpy(sh.graph).items()})
            out[f"router{s}.gids"] = r.gids[s]
        r.merge_shards(refine_rounds=1, draws=TorchDraws(7007))
        out.update({f"merged.{k}": v for k, v in convert.graph_to_numpy(r.shards[0].graph).items()})
        out["merged.gids"], out["merged.items"] = r.gids[0], r.shards[0].items.cpu().numpy()
        out["merged.ids"], _ = r.retrieve(q, 10, beam=64, draws=TorchDraws(7008))
        check(len(np.unique(r.gids[0])) == n + 1024 - 2000, "merge_shards lost a live id")
        return out

    def divide_parity(self, x, cfg):
        """The divide-and-conquer script with the kernels and the plain
        versions: every array and count identical."""
        self.ops.reset_launch_counts()
        t0 = time.perf_counter()
        a = self.divide_script(x, cfg)
        t_k = time.perf_counter() - t0
        counts = self.ops.launch_counts()
        for kernel in FP32_KERNELS:
            check(counts[kernel] > 0, f"divide-and-conquer script launched no {kernel}")
        t0 = time.perf_counter()
        with self.plain_versions():
            b = self.divide_script(x, cfg)
        t_p = time.perf_counter() - t0
        check(self.ops.launch_counts() == counts, "plain divide-and-conquer script launched a kernel")
        for name in a:
            check(bool((a[name] == b[name]).all()) if hasattr(a[name], "shape")
                  else a[name] == b[name], f"divide-and-conquer script: {name} differs, kernels vs plain")
        print(f"phase 3: divide-and-conquer on the n={x.shape[0]} integer rows (build_parallel of "
              f"3 blocks with a refine round, n_comps {a['parallel.n_comps']}; a 3-shard router: "
              "add 1,024, remove 2,000, compact, graph and brute retrieval, merge_shards): every "
              f"graph array, id table and answer identical, kernels vs plain (kernels {t_k:.3f} s, "
              f"plain {t_p:.3f} s; launches {json.dumps(counts)})", flush=True)

    # ---------------------------------------------------------------- phase 4
    def build_full(self, cfg):
        """The knn-lgd build over phase 2's rows from the launcher's entry
        point seed: (graph, stats, seconds)."""
        torch = self.torch
        from repro_torch.core import construct
        from repro_torch.launch import build_graph

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, stats = construct.build(self.xf, cfg, generator=self.gen(build_graph.BUILD_SEED),
                                   device=self.dev)
        torch.cuda.synchronize()
        return g, stats, time.perf_counter() - t0

    def counted_build(self, cfg, kernels, record=None):
        """The main path at ``cfg``: launch counts zeroed just before the
        build and read just after; every kernel in ``kernels`` must have
        launched, and those in ``record`` (default: all of them) keep this
        build's count as their main-path launches.  Returns (graph, stats,
        seconds, peak bytes)."""
        torch = self.torch

        torch.cuda.reset_peak_memory_stats()
        self.ops.reset_launch_counts()
        g, stats, t_build = self.build_full(cfg)
        peak = torch.cuda.max_memory_allocated()
        counts = self.ops.launch_counts()
        what = cfg.precision + (" data_bf16" if cfg.data_bf16 else "")
        print(f"launches on the {what} main path: {json.dumps(counts)}", flush=True)
        for name in kernels:
            check(counts[name] > 0, f"kernel {name} was not launched on the {what} main path")
        for name in kernels if record is None else record:
            self.launches[name] = counts[name]
        return g, stats, t_build, peak

    def check_graph(self, g, what):
        torch = self.torch
        from repro_torch.core import graph as graph_lib

        n = self.xf.shape[0]
        inv = graph_lib.graph_invariants_ok(g)
        bad = [k for k, v in inv.items() if not bool(v.all())]
        check(not bad, f"{what}: graph invariants violated: {bad}")
        check(g.n_valid == n, f"{what}: n_valid {g.n_valid} != {n}")
        check(bool(torch.isfinite(g.nbr_dist).all()), f"{what}: a row has fewer than k neighbours")

    def phase_full(self):
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, construct

        x = self.xf  # the launcher's rows, which phase 2 gathered from
        n = x.shape[0]
        cfg = knn_lgd.full_config()
        g, stats, t_build, peak = self.counted_build(
            cfg, ("gather_distance", "fused_expand", "pairwise_distance", "tile_topk"))
        t1 = time.perf_counter()
        rows = torch.arange(0, n, max(1, n // 10_000), device=self.dev)[:10_000]
        truth, _ = brute.brute_force_knn(x, x[rows], 10, "l2", exclude_ids=rows.int(),
                                         sq_norms=g.sq_norms, device=self.dev)
        recall = brute.recall_at_k(g.nbr_ids[rows], truth, 10)
        torch.cuda.synchronize()
        t_recall = time.perf_counter() - t1
        rate = construct.scanning_rate(stats, n)
        print(f"phase 4: knn-lgd build n={n} d=128 W={cfg.wave}: {t_build:.3f} s, "
              f"{n / t_build:.1f} rows/s, {stats.n_waves} waves, scanning rate {rate:.6f}, "
              f"peak memory {peak / 2**30:.3f} GiB", flush=True)
        print(f"phase 4: graph recall@10 over {rows.numel()} strided rows = {recall:.4f} "
              f"(brute force {t_recall:.3f} s)", flush=True)
        self.check_graph(g, "fp32 build")

        # the same build through the plain versions, same data and seeds:
        # where both miss 0.90 the floor is the algorithm's, plain - 0.01
        with self.plain_versions():
            g_p, stats_p, t_plain = self.build_full(cfg)
        recall_p = brute.recall_at_k(g_p.nbr_ids[rows], truth, 10)
        same = float((g_p.nbr_ids == g.nbr_ids).float().mean())
        floor = min(0.90, recall_p - 0.01)
        print(f"phase 4: plain versions on the card: {t_plain:.3f} s, scanning rate "
              f"{construct.scanning_rate(stats_p, n):.6f}, recall@10 = {recall_p:.4f}, "
              f"{same:.4f} of neighbour ids equal to the kernels' graph; recall floor "
              f"{floor:.4f}", flush=True)
        check(recall >= floor, f"graph recall@10 {recall:.4f} < floor {floor:.4f}")
        self.g32, self.rows, self.truth, self.recall32 = g, rows, truth, recall
        self.t_seq = t_build

    # ---------------------------------------------------------------- phase 5
    def phase_compressed(self):
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, construct

        n = self.xf.shape[0]
        for precision in ("int8", "bf16"):
            cfg = dataclasses.replace(knn_lgd.full_config(), precision=precision)
            g, stats, t_build, peak = self.counted_build(
                cfg, tuple(kernel_name(k, precision) for k in ("gather_distance", "fused_expand")))
            recall = brute.recall_at_k(g.nbr_ids[self.rows], self.truth, 10)
            same = float((g.nbr_ids == self.g32.nbr_ids).float().mean())
            print(f"phase 5: knn-lgd build n={n} d=128 W={cfg.wave} precision={precision}: "
                  f"{t_build:.3f} s, {n / t_build:.1f} rows/s, scanning rate "
                  f"{construct.scanning_rate(stats, n):.6f}, peak memory {peak / 2**30:.3f} GiB, "
                  f"recall@10 over {self.rows.numel()} strided rows = {recall:.4f} (fp32 "
                  f"{self.recall32:.4f}), {same:.4f} of neighbour ids equal to the fp32 graph",
                  flush=True)
            self.check_graph(g, f"{precision} build")
            check(recall >= self.recall32 - 0.05,
                  f"{precision} recall@10 {recall:.4f} < fp32 {self.recall32:.4f} - 0.05")
            del g
        self.phase_bf16_data()
        self.phase_pq_search()

    def phase_bf16_data(self):
        """The knn-lgd build over phase 4's rows stored bf16 (``data_bf16``,
        the reference's ``launch/perf.py`` bf16-data variant): every
        distance widens bf16 rows and accumulates in fp32, through the bf16
        table kernels and the bf16-operand pairwise kernel, whose every
        launch (the 4,096² tiles and the seed graph) takes the tensor-core
        form."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, construct

        n = self.xf.shape[0]
        cfg = dataclasses.replace(knn_lgd.full_config(), data_bf16=True)
        pair = ("pairwise_distance.bf16", "pairwise_distance.bf16_wgmma")
        g, stats, t_build, peak = self.counted_build(
            cfg, ("gather_distance.bf16", "fused_expand.bf16") + pair, record=pair)
        check(self.launches[pair[1]] == self.launches[pair[0]],
              f"data_bf16 build: {self.launches[pair[0]]} bf16-operand pairwise launches, "
              f"{self.launches[pair[1]]} through the tensor-core form")
        recall = brute.recall_at_k(g.nbr_ids[self.rows], self.truth, 10)
        same = float((g.nbr_ids == self.g32.nbr_ids).float().mean())
        print(f"phase 5: knn-lgd build n={n} d=128 W={cfg.wave}, rows stored bf16 (data_bf16): "
              f"{t_build:.3f} s, {n / t_build:.1f} rows/s, scanning rate "
              f"{construct.scanning_rate(stats, n):.6f}, peak memory {peak / 2**30:.3f} GiB, "
              f"recall@10 over {self.rows.numel()} strided rows = {recall:.4f} (fp32 "
              f"{self.recall32:.4f}), {same:.4f} of neighbour ids equal to the fp32 graph",
              flush=True)
        self.check_graph(g, "data_bf16 build")
        check(recall >= self.recall32 - 0.05,
              f"data_bf16 recall@10 {recall:.4f} < fp32 {self.recall32:.4f} - 0.05")
        del g

    def phase_pq_search(self):
        """Held-out queries on phase 4's graph: fp32 against pq at three
        re-rank widths, from the same entry points."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, search
        from repro_torch.data import synthetic
        from repro_torch.kernels.precision import encode_dataset
        from repro_torch.launch import build_graph

        x, g, m = self.xf, self.g32, 4096
        q = synthetic.clustered(self.gen(build_graph.DATA_SEED), m, x.shape[1],
                                sample_generator=self.gen(QUERY_SEED))
        scfg = knn_lgd.full_config().search_config()
        seeds = search.random_seeds(m, scfg.n_seeds, g.n_valid, self.gen(SEARCH_SEED), self.dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode_dataset(x, "pq")
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        truth, _ = brute.brute_force_knn(x, q, scfg.k, "l2", sq_norms=g.sq_norms, device=self.dev)
        self.held_q, self.held_truth = q, truth

        def run(cfg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = search.search(g, x, q, cfg, seeds=seeds, enc=enc, device=self.dev)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        def overlap(a, b):
            hit = (a.ids[:, :, None] == b.ids[:, None, :]).any(-1)
            return float(hit.float().mean())

        r32, t32 = run(scfg)
        print(f"phase 5: {m} held-out queries on the fp32 graph, fp32 search: {t32:.3f} s, "
              f"recall@{scfg.k} {brute.recall_at_k(r32.ids, truth, scfg.k):.4f}, "
              f"comps/query {float(r32.n_comps.float().mean()):.1f} (pq encode of {x.shape[0]} "
              f"rows {t_enc:.3f} s, M={enc.codes.shape[1]})", flush=True)
        for factor in (1000, scfg.rerank_factor, 1):
            cfg = dataclasses.replace(scfg, precision="pq", rerank_factor=factor)
            rpq, tpq = run(cfg)
            ov = overlap(rpq, r32)
            print(f"phase 5: pq search, rerank_factor={factor} (keeps {factor * scfg.k} of "
                  f"<= {scfg.k + g.rev_capacity} candidates): {tpq:.3f} s, recall@{scfg.k} "
                  f"{brute.recall_at_k(rpq.ids, truth, scfg.k):.4f}, top-{scfg.k} overlap with "
                  f"fp32 {ov:.4f}, comps/query {float(rpq.n_comps.float().mean()):.1f}", flush=True)
            if factor == 1000:
                check(torch.equal(rpq.ids, r32.ids) and torch.equal(rpq.dists, r32.dists),
                      "pq search with rerank_factor=1000 differs from the fp32 search")
            if factor == scfg.rerank_factor:
                check(ov >= 0.9, f"pq search at the default factor: overlap {ov:.4f} < 0.9")
            if factor == 1:
                check(ov >= PQ_PRUNE_OVERLAP,
                      f"pq search at factor 1: overlap {ov:.4f} with fp32 < {PQ_PRUNE_OVERLAP}")
                self.pq_against_cpu(x, g, q, seeds, enc, cfg, rpq)

    def pq_against_cpu(self, x, g, q, seeds, enc, cfg, rpq):
        """The card's PQ codes and its pruning search, held against the CPU."""
        torch = self.torch
        from repro_torch.core import search
        from repro_torch.kernels.precision import pq_encode

        cpu = torch.device("cpu")
        t0 = time.perf_counter()
        x_cpu, enc_cpu = x.to(cpu), enc.to(cpu)
        codes_agree = float((pq_encode(x_cpu, enc_cpu.codebook) == enc_cpu.codes).float().mean())
        t_codes = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = search.search(g, x_cpu, q.to(cpu), cfg, seeds=seeds.to(cpu), enc=enc_cpu, device=cpu)
        t_search = time.perf_counter() - t0
        card_ids = rpq.ids.to(cpu)
        agree = float((card_ids[:, :, None] == r.ids[:, None, :]).any(-1).float().mean())
        rows_equal = float((card_ids == r.ids).all(1).float().mean())
        print(f"phase 5: pq on the CPU ({torch.get_num_threads()} threads): codes of "
              f"{x.shape[0]} rows {codes_agree:.6f} equal to the card's ({t_codes:.3f} s); "
              f"rerank_factor=1 search {t_search:.3f} s, top-{cfg.k} overlap with the card's "
              f"{agree:.6f}, {rows_equal:.4f} of queries with identical ids", flush=True)
        check(codes_agree >= PQ_CODES_AGREE,
              f"pq codes: {codes_agree:.6f} equal to the CPU's < {PQ_CODES_AGREE}")
        check(agree >= PQ_CPU_AGREE,
              f"pq search at factor 1: overlap {agree:.6f} with the CPU's < {PQ_CPU_AGREE}")

    # ---------------------------------------------------------------- phase 6
    def serve_run(self, tracker=None):
        """Phase 4's graph as an ``OnlineIndex`` behind a ``ServingLoop``
        under the churned traffic; returns (index, loop, report, waves,
        seconds), ``waves`` each wave's (ids, dists, alive mask) as served."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.index import OnlineIndex
        from repro_torch.serve.loop import ServeLoopConfig, ServingLoop

        waves = []

        class RecordingLoop(ServingLoop):
            def _search(self, q):
                res = super()._search(q)
                waves.append((res.ids, res.dists, self.index.graph.alive))
                return res

        index = OnlineIndex(graph=self.g32, items=self.xf, build_cfg=knn_lgd.full_config(),
                            auto_compact=True)
        loop = RecordingLoop(index, ServeLoopConfig(top_k=10, beam=64, max_batch=64,
                                                    recall_reservoir=96, recall_sample_every=5),
                             tracker=tracker, seed=LOOP_SEED)
        victim_gen = torch.Generator(device=self.dev).manual_seed(VICTIM_SEED)
        queries, fresh = self.serve_queries, self.serve_fresh

        def round_(r, churn):
            if churn:
                alive = torch.nonzero(index.graph.alive)[:, 0]
                pick = torch.randperm(alive.numel(), generator=victim_gen, device=self.dev)
                loop.remove(alive[pick[:CHURN]])
                e = r // CHURN_EVERY
                loop.add(fresh[e * CHURN:(e + 1) * CHURN])
            loop.submit(queries[r * SERVE_BURST:(r + 1) * SERVE_BURST])
            loop.pump()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_(0, True)  # the warm-up round, outside the window
        loop.reset_window()
        for r in range(1, SERVE_ROUNDS + 1):
            round_(r, r % CHURN_EVERY == 0)
        rep = loop.report(audit_k=10)
        torch.cuda.synchronize()
        return index, loop, rep, waves, time.perf_counter() - t0

    def phase_serving(self):
        torch = self.torch
        from repro_torch.core import graph as graph_lib
        from repro_torch.data import synthetic
        from repro_torch.launch import build_graph
        from repro_torch.obs import JsonlTracker, load_events

        n, d = self.xf.shape
        events = SERVE_ROUNDS // CHURN_EVERY + 1
        self.serve_queries = synthetic.clustered(
            self.gen(build_graph.DATA_SEED), (SERVE_ROUNDS + 1) * SERVE_BURST, d,
            sample_generator=self.gen(SERVE_QUERY_SEED))
        self.serve_fresh = synthetic.clustered(
            self.gen(build_graph.DATA_SEED), events * CHURN, d,
            sample_generator=self.gen(FRESH_SEED))
        trace = ROOT / "build" / "serve_trace.jsonl"
        trace.parent.mkdir(exist_ok=True)
        trace.unlink(missing_ok=True)
        tracker = JsonlTracker(str(trace), run_meta={"run": "chip_smoke phase 6"})
        self.ops.reset_launch_counts()
        index, loop, rep, waves, t_k = self.serve_run(tracker)
        counts = self.ops.launch_counts()
        tracker.finish()
        print(f"launches on the serving path: {json.dumps(counts)}", flush=True)
        for name in ("gather_distance", "fused_expand", "pairwise_distance"):
            self.serve_launches[name] = counts[name]
            check(counts[name] > 0, f"kernel {name} was not launched on the serving path")
        with self.plain_versions():
            index_p, loop_p, rep_p, waves_p, t_p = self.serve_run()
        check(self.ops.launch_counts() == counts, "the plain serving run launched a kernel")
        for what, r, t in (("kernels", rep, t_k), ("plain versions", rep_p, t_p)):
            print(f"phase 6: serving n={n} d={d} through the {what}: {r['n_served']} queries in "
                  f"{r['n_waves']} waves, p50 {r['p50_latency_ms']:.3f} ms, p99 "
                  f"{r['p99_latency_ms']:.3f} ms, {r['qps']:.1f} QPS, comps/query "
                  f"{r['comps_per_query']:.1f}, scanning rate {r['scanning_rate']:.6f}, hash_full "
                  f"share {r['hash_saturation_ratio']:.4f}, recall@10 fresh {r['recall_at_10']:.4f} "
                  f"served {r['recall_at_10_served']:.4f} over {r['n_audited']} queries "
                  f"({t:.3f} s with {events} churn events of {CHURN})", flush=True)
        self.serve_rep = rep
        check(rep["recall_at_10"] >= rep_p["recall_at_10"] - 0.01,
              f"serving recall@10 {rep['recall_at_10']:.4f} < plain {rep_p['recall_at_10']:.4f} - 0.01")
        for idx, ws, what in ((index, waves, "kernels"), (index_p, waves_p, "plain")):
            check(idx.capacity == n, f"serving ({what}) grew the index to {idx.capacity}")
            inv = graph_lib.graph_invariants_ok(idx.graph)
            bad = [k for k, v in inv.items() if not bool(v.all())]
            check(not bad, f"serving ({what}): graph invariants violated: {bad}")
            empty = 0
            for ids, _, alive in ws:
                found = ids[ids >= 0].long()
                empty += ids.numel() - found.numel()
                check(bool(alive[found].all()), f"serving ({what}): a wave served a removed row")
            print(f"phase 6: {what}: {len(ws)} searches served only live rows ({empty} empty "
                  f"result slots); capacity stays at {n}; graph invariants hold", flush=True)
        spans = {}
        for e in load_events(str(trace)):
            if e.get("event") == "span":
                spans.setdefault(e["name"], []).append(e["dur_s"])
        want = {"serve/step", "serve/search", "index/flush", "index/remove", "index/compact"}
        check(want <= set(spans), f"serving trace lacks spans {sorted(want - set(spans))}")
        print(f"phase 6: trace {trace.relative_to(ROOT)}, host seconds by span (count, total, "
              "mean ms): " + ", ".join(
                  f"{name} ({len(d)}, {sum(d):.3f}, {1e3 * sum(d) / len(d):.3f})"
                  for name, d in sorted(spans.items())), flush=True)
        self.serving_checks(index, loop)

    def serving_checks(self, index, loop):
        """On the churned index: tracker on vs off, the snapshot round trip
        and coarse seeding."""
        import shutil
        import tempfile

        import numpy as np

        torch = self.torch
        from repro_torch.index import OnlineIndex
        from repro_torch.obs import InMemoryTracker
        from repro_torch.serve.loop import ServeLoopConfig, ServingLoop

        q = torch.from_numpy(np.stack(loop._res_q[:64])).to(self.dev)

        def wave(idx, tracker=None):
            lp = ServingLoop(idx.clone(), ServeLoopConfig(top_k=10, beam=64, max_batch=64),
                             tracker=tracker, seed=LOOP_SEED)
            out = []
            orig = lp._search
            lp._search = lambda b: out.append(orig(b)) or out[-1]
            lp.submit(q)
            lp.step()
            return out[0]

        off, on = wave(index), wave(index, InMemoryTracker())
        check(torch.equal(off.ids, on.ids) and torch.equal(off.dists, on.dists),
              "a wave served with the tracker on differs from the wave with it off")
        print("phase 6: one 64-query wave with the tracker on is bit-identical to it off",
              flush=True)
        tmp = tempfile.mkdtemp(dir=ROOT / "build")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.save(os.path.join(tmp, "snap"))
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = OnlineIndex.load(os.path.join(tmp, "snap"), device=self.dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(tmp, "snap", f))
                       for f in os.listdir(os.path.join(tmp, "snap")))
        finally:
            shutil.rmtree(tmp)
        for name in index.graph._fields:
            a, b = getattr(index.graph, name), getattr(back.graph, name)
            check(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b,
                  f"snapshot round trip: {name} differs")
        check(torch.equal(index.items, back.items), "snapshot round trip: items differ")
        w0, w1 = wave(index), wave(back)
        check(torch.equal(w0.ids, w1.ids) and torch.equal(w0.dists, w1.dists),
              "snapshot round trip: a wave differs before and after")
        print(f"phase 6: snapshot of the churned index, {size / 2**30:.3f} GiB: save "
              f"{t_save:.3f} s, load {t_load:.3f} s, every array bit-equal, one 64-query wave "
              "bit-identical before and after", flush=True)
        self.coarse_serving(index, np.stack(loop._res_q))

    def coarse_search(self, index, q, truth):
        """derive_coarse with SERVE_LANDMARKS landmarks, then q at
        seed_mode="coarse": (recall@10, comps/query, seconds to derive)."""
        torch = self.torch
        from repro_torch.core import brute, hierarchy

        cidx = index.clone()
        cidx.build_cfg = dataclasses.replace(index.build_cfg, seed_mode="coarse",
                                             coarse_landmarks=SERVE_LANDMARKS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cidx.coarse = hierarchy.derive_coarse(cidx.graph, cidx.items, cidx.build_cfg,
                                              generator=self.gen(LANDMARK_SEED), device=self.dev)
        torch.cuda.synchronize()
        t_derive = time.perf_counter() - t0
        res = cidx.search(q, 10, beam=64, generator=self.gen(LOOP_SEED))
        return (brute.recall_at_k(res.ids, truth, 10), float(res.n_comps.float().mean()),
                t_derive, cidx.coarse)

    def coarse_serving(self, index, q_np):
        """The reservoir's queries at coarse and at random seeding."""
        torch = self.torch
        from repro_torch.core import brute

        from repro_torch.configs import knn_lgd
        from repro_torch.core import graph as graph_lib
        from repro_torch.index import OnlineIndex

        q = torch.from_numpy(q_np).to(self.dev)
        # the same queries on phase 4's graph before any churn
        fresh = OnlineIndex(graph=self.g32, items=self.xf, build_cfg=knn_lgd.full_config())
        truth0, _ = brute.brute_force_knn(self.xf, q, 10, "l2", sq_norms=self.g32.sq_norms,
                                          device=self.dev)
        r0 = fresh.search(q, 10, beam=64, generator=self.gen(LOOP_SEED))
        # and on that graph with its reverse lists rebuilt as compact() does
        rebuilt = fresh.clone()
        rebuilt.graph = graph_lib.rebuild_reverse(self.g32)
        r1 = rebuilt.search(q, 10, beam=64, generator=self.gen(LOOP_SEED))
        truth, _ = brute.brute_force_knn(index.items, q, 10, "l2", n_valid=index.graph.n_valid,
                                         alive=index.graph.alive, device=self.dev)
        rand = index.search(q, 10, beam=64, generator=self.gen(LOOP_SEED))
        r_rand = brute.recall_at_k(rand.ids, truth, 10)
        r_k, c_k, t_k, lvl_k = self.coarse_search(index, q, truth)
        with self.plain_versions():
            r_p, c_p, t_p, lvl_p = self.coarse_search(index, q, truth)
        same = bool(torch.equal(lvl_k.landmark_rows, lvl_p.landmark_rows))
        print(f"phase 6: derive_coarse, {SERVE_LANDMARKS} landmarks over {index.graph.n_valid} "
              f"rows: kernels {t_k:.3f} s, plain {t_p:.3f} s (same landmarks: {same}); "
              f"{q.shape[0]} reservoir queries: coarse seeding recall@10 {r_k:.4f}, comps/query "
              f"{c_k:.1f} (plain {r_p:.4f}, {c_p:.1f}); random seeding recall@10 {r_rand:.4f}, "
              f"comps/query {float(rand.n_comps.float().mean()):.1f}; before the churn, random "
              f"seeding recall@10 {brute.recall_at_k(r0.ids, truth0, 10):.4f}, comps/query "
              f"{float(r0.n_comps.float().mean()):.1f}, and {brute.recall_at_k(r1.ids, truth0, 10):.4f}"
              f" with the reverse lists rebuilt canonically", flush=True)
        check(r_k >= r_p - 0.01, f"coarse serving recall@10 {r_k:.4f} < plain {r_p:.4f} - 0.01")

    # ---------------------------------------------------------------- phase 7
    def path_counts(self, path, what):
        """Read the launch counts of a phase 7 path (zeroed just before it)
        and require each fp32 kernel to have launched."""
        counts = self.ops.launch_counts()
        print(f"launches on {what}: {json.dumps(counts)}", flush=True)
        for name in FP32_KERNELS:
            check(counts[name] > 0, f"kernel {name} was not launched on {what}")
        self.path_launches[path] = counts

    def parallel_build(self):
        """build_parallel over phase 4's rows at the knn-lgd config: the
        graph, stats, seconds, host seconds by span, and the device seconds
        between CUDA events around each ``merge_candidates`` call of the
        refine (no sync added) with the count of those calls."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import construct, merge
        from repro_torch.core.draws import TorchDraws
        from repro_torch.launch import build_graph
        from repro_torch.obs import InMemoryTracker

        trk = InMemoryTracker()
        events = []
        inner = merge.merge_candidates

        def timed(*args, **kw):
            if trk._stack[-1:] != ["parallel/refine"]:
                return inner(*args, **kw)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = inner(*args, **kw)
            ev[1].record()
            events.append(ev)
            return out

        merge.merge_candidates = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, st = construct.build_parallel(
                self.xf, knn_lgd.full_config(), TorchDraws(build_graph.BUILD_SEED),
                shards=PAR_SHARDS, refine_rounds=1, search_chunk=MERGE_CHUNK, tracker=trk,
                device=self.dev)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        finally:
            merge.merge_candidates = inner
        spans = {}
        for e in trk.span_events:
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur_s"]
        sort_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        return g, st, t, spans, sort_s, len(events)

    def phase_parallel(self):
        """7a: the divide-and-conquer build of phase 4's rows."""
        torch = self.torch
        from repro_torch.core import brute, construct, nndescent

        x, n = self.xf, self.xf.shape[0]
        torch.cuda.reset_peak_memory_stats()
        self.ops.reset_launch_counts()
        g, st, t, spans, sort_s, n_sorts = self.parallel_build()
        self.t_par = t
        peak = torch.cuda.max_memory_allocated()
        self.path_counts("parallel", "the parallel build")
        recall = brute.recall_at_k(g.nbr_ids[self.rows], self.truth, 10)
        print(f"phase 7a: build_parallel n={n} d={x.shape[1]} knn-lgd, {PAR_SHARDS} blocks, one refine "
              f"round, cross-search chunk {MERGE_CHUNK}: {t:.3f} s ({n / t:.1f} rows/s; phase 4's "
              f"sequential build {self.t_seq:.3f} s), {st.n_waves} waves, n_comps "
              f"{int(st.n_comps)}, scanning rate {construct.scanning_rate(st, n):.6f}, peak memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        print("phase 7a: host seconds by span: " + ", ".join(
            f"{name} {sec:.3f}" for name, sec in spans.items()) + f"; the refine's {n_sorts} "
            f"merge_candidates calls {sort_s:.3f} s of device time between events "
            f"({sort_s / spans['parallel/refine']:.4f} of the refine, {sort_s / t:.4f} of the build)",
            flush=True)
        print(f"phase 7a: recall@10 over {self.rows.numel()} strided rows = {recall:.4f} "
              f"(phase 4's sequential build {self.recall32:.4f})", flush=True)
        self.recall_par = recall
        self.check_graph(g, "parallel build")
        lam, _ = nndescent.recompute_lambda(g.nbr_ids, g.nbr_dist, x, "l2")
        check(torch.equal(lam, g.nbr_lam), "parallel build: nbr_lam is not the canonical λ of "
              "the final lists")
        if recall < self.recall32 - 0.02:
            # the second arm: the same build through the plain versions
            with self.plain_versions():
                g_p, _, t_p, _, _, _ = self.parallel_build()
            recall_p = brute.recall_at_k(g_p.nbr_ids[self.rows], self.truth, 10)
            print(f"phase 7a: plain versions on the card: {t_p:.3f} s, recall@10 {recall_p:.4f}; "
                  f"floor {recall_p - 0.01:.4f}", flush=True)
            check(recall >= recall_p - 0.01, f"parallel recall@10 {recall:.4f} < sequential "
                  f"{self.recall32:.4f} - 0.02 and < plain {recall_p:.4f} - 0.01")

    def check_tables(self, router, live, source, what):
        """The id tables against the live set: each shard full, every live
        id held once, and sampled ids naming rows that hold their vectors."""
        import numpy as np

        torch = self.torch
        held = []
        for s, sh in enumerate(router.shards):
            table = router.gids[s]
            nv = sh.graph.n_valid
            check(len(table) == sh.capacity and (table[nv:] == -1).all(),
                  f"{what}: shard {s} table does not match its capacity")
            check(bool(sh.graph.alive[:nv].all()) and (table[:nv] >= 0).all(),
                  f"{what}: shard {s} has a dead or untabled row after compaction")
            held.append(np.stack([table[:nv], np.full(nv, s), np.arange(nv)], 1))
        held = np.concatenate(held)
        check(np.array_equal(np.sort(held[:, 0]), np.nonzero(live)[0]),
              f"{what}: the tables do not hold exactly the live ids")
        pick = held[np.random.RandomState(len(held)).choice(len(held), 1024, replace=False)]
        for gid, s, row in pick:
            check(torch.equal(router.shards[s].items[row], source(gid)),
                  f"{what}: global id {gid} names a row of shard {s} with another vector")

    def phase_router(self):
        """7b: phase 4's rows in a 4-shard router under phase 6's traffic."""
        import numpy as np

        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import draws as draws_lib
        from repro_torch.core.draws import TorchDraws
        from repro_torch.index import ShardedIndex
        from repro_torch.launch import build_graph
        from repro_torch.obs import InMemoryTracker

        x, n = self.xf, self.xf.shape[0]
        cfg = knn_lgd.full_config()
        queries, fresh = self.serve_queries, self.serve_fresh
        self.ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router = ShardedIndex.build(x, ROUTER_SHARDS, cfg, draws=TorchDraws(build_graph.BUILD_SEED),
                                    device=self.dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        trk = InMemoryTracker()
        router.tracker = trk
        for sh in router.shards:
            sh.tracker = trk
        live = np.zeros(n + fresh.shape[0], bool)
        live[:n] = True
        removed = np.zeros_like(live)
        victims_rng = np.random.RandomState(VICTIM_SEED)

        def source(gid):
            return x[gid] if gid < n else fresh[gid - n]

        def churn(e):
            victims = victims_rng.choice(np.nonzero(live)[0], CHURN, replace=False)
            check(router.remove(victims) == CHURN, "router: a removal missed a live id")
            live[victims], removed[victims] = False, True
            added = 0
            while added < CHURN:  # batches that fit the least-filled shard's free rows
                s = int(np.argmin([sh.n_items for sh in router.shards]))
                m = min(router.shards[s].free_slots, CHURN - added)
                check(m > 0, "router: no free rows left for an add")
                gids = router.add(fresh[e * CHURN + added:e * CHURN + added + m],
                                  seed_fn=draws_lib.wave_seed_fn(
                                      TorchDraws(ROUTER_SEED).fold_in(e).fold_in(added),
                                      cfg.n_seeds, device=self.dev))
                check(np.array_equal(gids, n + e * CHURN + added + np.arange(m)),
                      "router: add handed out unexpected global ids")
                live[gids] = True
                added += m
            router.compact()
            self.check_tables(router, live, source, f"router churn event {e}")

        lat, recall, served_dead, comps = [], [], 0, 0
        t_churn = 0.0

        def round_(r, measured):
            nonlocal served_dead, comps, t_churn
            if r % CHURN_EVERY == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                churn(r // CHURN_EVERY)
                torch.cuda.synchronize()
                t_churn += time.perf_counter() - t0
            for j in range(SERVE_BURST // REQUEST):
                q = queries[r * SERVE_BURST + j * REQUEST:r * SERVE_BURST + (j + 1) * REQUEST]
                t0 = time.perf_counter()
                ids, _, stats = router.retrieve(q, 10, beam=64, with_stats=True,
                                                draws=TorchDraws(LOOP_SEED).fold_in(r).fold_in(j))
                dt = time.perf_counter() - t0  # the answer is a host array: synced
                served_dead += int(removed[ids[ids >= 0]].sum())
                if measured:
                    lat.append(dt)
                    comps += stats.total_comps
                    truth, _ = router.retrieve(q, 10, brute=True)
                    recall.append(len(set(ids.tolist()) & set(truth.tolist())) / 10)

        round_(0, False)  # the warm-up round, outside the window
        trk.events.clear()
        for r in range(1, ROUTER_ROUNDS + 1):
            round_(r, True)
        counts_path = "the router (build, churn, graph and brute retrieval)"
        self.path_counts("router", counts_path)
        lat_ms = np.asarray(lat) * 1e3
        served = len(lat) * REQUEST
        spans = {}
        for e in trk.span_events:
            spans.setdefault(e["name"], []).append(e["dur_s"])
        print(f"phase 7b: router of {ROUTER_SHARDS} shards over n={n}: build {t_build:.3f} s; "
              f"{len(lat)} requests of {REQUEST} queries ({served} queries) in {ROUTER_ROUNDS} "
              f"rounds of {SERVE_BURST}: p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.3f} ms per request, {served / lat_ms.sum() * 1e3:.1f} "
              f"QPS (queries over the summed request latencies), comps/query "
              f"{comps / served:.1f} (all shards), recall@10 {np.mean(recall):.4f} against brute "
              f"force over the live catalog; {ROUTER_ROUNDS // CHURN_EVERY + 1} churn events of "
              f"{CHURN} in {t_churn:.3f} s (phase 6's single index: p50 "
              f"{self.serve_rep['p50_latency_ms']:.3f} ms, p99 "
              f"{self.serve_rep['p99_latency_ms']:.3f} ms, {self.serve_rep['qps']:.1f} QPS)",
              flush=True)
        print("phase 7b: host seconds by span (count, total, mean ms): " + ", ".join(
            f"{name} ({len(d)}, {sum(d):.3f}, {1e3 * sum(d) / len(d):.3f})"
            for name, d in sorted(spans.items())), flush=True)
        check(served_dead == 0, f"router served {served_dead} removed global ids")
        cap = sum(sh.capacity for sh in router.shards)
        check(cap == n, f"router capacity grew to {cap}")
        self.router_brute_check(router, queries, cfg)
        self.router_snapshot(router, queries)
        self.router, self.live, self.removed, self.source = router, live, removed, source
        self.router_recall = float(np.mean(recall))

    def router_brute_check(self, router, queries, cfg):
        """retrieve(brute=True) on 4 requests against retrieve_brute over
        one index of the same live rows."""
        import numpy as np

        torch = self.torch
        from repro_torch.core import graph as graph_lib
        from repro_torch.index import OnlineIndex
        from repro_torch.serve import retrieval

        items = torch.cat([sh.items[:sh.graph.n_valid] for sh in router.shards])
        table = np.concatenate([router.gids[s][:sh.graph.n_valid]
                                for s, sh in enumerate(router.shards)])
        g = graph_lib.empty_graph(items.shape[0], cfg.k, device=self.dev)
        g = g._replace(alive=torch.ones_like(g.alive), n_valid=items.shape[0])
        single = OnlineIndex(graph=g, items=items, build_cfg=cfg)
        mismatch = worst = 0
        for j in range(4):
            q = queries[j * REQUEST:(j + 1) * REQUEST]
            ids, scores = router.retrieve(q, 10, brute=True)
            sids, sscores = retrieval.retrieve_brute(single, q, 10)
            sids, sscores = table[sids.cpu().numpy()], sscores.cpu().numpy()
            check(np.allclose(scores, sscores, rtol=1e-6, atol=0),
                  f"router brute distances differ from the unsharded brute: {scores} {sscores}")
            worst = max(worst, float(np.max(np.abs(scores - sscores) / np.abs(sscores))))
            tied = np.zeros(10, bool)
            tied[1:] |= scores[1:] == scores[:-1]
            tied[:-1] |= scores[:-1] == scores[1:]
            mismatch += int(((ids != sids) & ~tied).sum())
        print(f"phase 7b: brute retrieval of 4 requests through the router equals retrieve_brute "
              f"over one index of the {items.shape[0]} live rows: {mismatch} untied id mismatches, "
              f"largest relative distance difference {worst:.3g}", flush=True)
        check(mismatch == 0, f"router brute ids differ from the unsharded brute at {mismatch} "
              "untied places")

    def router_snapshot(self, router, queries):
        """Save and load the churned router: tables and shard arrays
        bit-equal, one request's answer identical."""
        import shutil
        import tempfile

        import numpy as np

        torch = self.torch
        from repro_torch.core.draws import TorchDraws
        from repro_torch.index import ShardedIndex

        tmp = tempfile.mkdtemp(dir=ROOT / "build")
        try:
            t0 = time.perf_counter()
            router.save(os.path.join(tmp, "router"))
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = ShardedIndex.load(os.path.join(tmp, "router"), device=self.dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(dp, f))
                       for dp, _, fs in os.walk(tmp) for f in fs)
        finally:
            shutil.rmtree(tmp)
        check(back.next_gid == router.next_gid and back.n_shards == router.n_shards,
              "router snapshot: manifest differs")
        for s, (a, b) in enumerate(zip(router.shards, back.shards)):
            check(np.array_equal(router.gids[s], back.gids[s]), f"router snapshot: table {s} differs")
            for name in a.graph._fields:
                u, v = getattr(a.graph, name), getattr(b.graph, name)
                check(torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v,
                      f"router snapshot: shard {s} {name} differs")
            check(torch.equal(a.items, b.items), f"router snapshot: shard {s} items differ")
        q = queries[:REQUEST]
        before = router.retrieve(q, 10, beam=64, draws=TorchDraws(ROUTER_SEED))
        after = back.retrieve(q, 10, beam=64, draws=TorchDraws(ROUTER_SEED))
        check(all(np.array_equal(u, v) for u, v in zip(before, after)),
              "router snapshot: a request's answer differs before and after")
        print(f"phase 7b: router snapshot, {size / 2**30:.3f} GiB: save {t_save:.3f} s, load "
              f"{t_load:.3f} s, tables and every shard array bit-equal, one request identical "
              "before and after", flush=True)

    def phase_merge_shards(self):
        """7c: the churned router collapsed into one index."""
        import numpy as np

        torch = self.torch
        from repro_torch.core import brute
        from repro_torch.core import graph as graph_lib
        from repro_torch.core.draws import TorchDraws
        from repro_torch.index import ShardedIndex

        router, live, removed = self.router, self.live, self.removed
        self.ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router.merge_shards(refine_rounds=1, draws=TorchDraws(ROUTER_SEED + 1),
                            search_chunk=MERGE_CHUNK)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        idx, table = router.shards[0], router.gids[0]
        check(router.n_shards == 1 and idx.graph.n_valid == int(live.sum()),
              "merge_shards: not one index over the live rows")
        check(np.array_equal(np.sort(table), np.nonzero(live)[0]),
              "merge_shards: the table does not hold exactly the live ids")
        inv = graph_lib.graph_invariants_ok(idx.graph)
        bad = [k for k, v in inv.items() if not bool(v.all())]
        check(not bad, f"merge_shards: graph invariants violated: {bad}")
        # every live id resolves: brute force over the merged rows finds
        # each sampled id's own vector at the row its table entry names
        pick = np.random.RandomState(LOOKUP_SEED).choice(np.nonzero(live)[0], LOOKUPS, replace=False)
        vecs = torch.stack([self.source(int(gid)) for gid in pick])
        rows, _ = brute.brute_force_knn(idx.items, vecs, 1, "l2", n_valid=idx.graph.n_valid,
                                        device=self.dev)
        found = table[rows[:, 0].cpu().numpy()]
        check(np.array_equal(found, pick),
              f"merge_shards: {int((found != pick).sum())} of {LOOKUPS} live ids do not resolve")
        # the merged graph's own recall@10 over 2,048 of those rows
        own = rows[:2048, 0]
        truth, _ = brute.brute_force_knn(idx.items, vecs[:2048], 10, "l2", n_valid=idx.graph.n_valid,
                                         exclude_ids=own, device=self.dev)
        graph_recall = brute.recall_at_k(idx.graph.nbr_ids[own.long()], truth, 10)
        queries = self.serve_queries

        def serve(r):
            """One round of requests through ``r``: (recall@10, removed ids served)."""
            recall, dead = [], 0
            for j in range(SERVE_BURST // REQUEST):
                q = queries[j * REQUEST:(j + 1) * REQUEST]
                ids, _ = r.retrieve(q, 10, beam=64, draws=TorchDraws(LOOP_SEED).fold_in(j))
                truth, _ = r.retrieve(q, 10, brute=True)
                dead += int(removed[ids[ids >= 0]].sum())
                recall.append(len(set(ids.tolist()) & set(truth.tolist())) / 10)
            return float(np.mean(recall)), dead

        recall, served_dead = serve(router)
        self.path_counts("merge_shards", "merge_shards and the merged index's serving")
        # the same round seeded from a coarse level of the merged index
        # (derived at the first search, SERVE_LANDMARKS landmarks)
        cidx = idx.clone()
        cidx.build_cfg = dataclasses.replace(idx.build_cfg, seed_mode="coarse",
                                             coarse_landmarks=SERVE_LANDMARKS)
        recall_c, dead_c = serve(ShardedIndex([cidx], [table], router.next_gid))
        print(f"phase 7c: merge_shards of the churned router ({idx.graph.n_valid} live rows, one "
              f"refine round, cross-search chunk {MERGE_CHUNK}): {t:.3f} s; {LOOKUPS} sampled "
              f"live ids resolve to their own rows; one round of {SERVE_BURST} queries served, "
              f"recall@10 {recall:.4f} from random entry points (the router's "
              f"{self.router_recall:.4f}), {recall_c:.4f} seeded from {SERVE_LANDMARKS} "
              f"landmarks; the merged graph's recall@10 over 2,048 of its rows "
              f"{graph_recall:.4f}", flush=True)
        check(served_dead + dead_c == 0,
              f"the merged index served {served_dead + dead_c} removed global ids")

    # ---------------------------------------------------------------- phase 8
    def phase_mesh(self):
        """8: the device mesh at full size, a gloo group of ``MESH_RANKS``
        ranks on the one card over phase 4's rows (``_mesh_rank``): (a) the
        per-shard exact seed graphs and the shard step in lockstep waves,
        (b) the scatter-gather search of phase 5's held-out queries, then
        with shard 0 blanked, (c) ``build_parallel`` on the group.  A rank
        that fails fails the run."""
        import numpy as np

        torch = self.torch
        import torch.multiprocessing as mp

        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute
        from repro_torch.launch.mesh import free_port

        run_dir = ROOT / "build" / "mesh"
        run_dir.mkdir(parents=True, exist_ok=True)
        for old in run_dir.glob("*.pt"):
            old.unlink()
        torch.save(self.held_q.cpu(), run_dir / "queries.pt")
        torch.cuda.empty_cache()  # the ranks share the card with this process
        print(f"phase 8: backend gloo: {MESH_RANKS} ranks share the one card, and nccl needs a "
              "card per rank; gloo stages each collective's tensors through the host", flush=True)
        t0 = time.perf_counter()
        mp.spawn(_mesh_rank, args=(MESH_RANKS, free_port(), str(run_dir), self.dev.type,
                                   self.xf.shape[0]), nprocs=MESH_RANKS, join=True)
        t_world = time.perf_counter() - t0
        res = torch.load(run_dir / "mesh.pt")
        n, n_local = self.xf.shape[0], self.xf.shape[0] // MESH_RANKS
        check(res["x_sum"] == float(self.xf.double().sum()),
              "phase 8: the ranks' rows differ from phase 4's")

        def launches(path, kernels):
            counts = {k: sum(c[k] for c in res[path]["launches"]) for k in res[path]["launches"][0]}
            print(f"launches on the mesh {path} (all ranks): {json.dumps(counts)}", flush=True)
            for name in kernels:
                check(counts[name] > 0, f"kernel {name} was not launched on the mesh {path}")
            self.path_launches[f"mesh_{path}"] = counts

        b = res["build"]
        launches("build", FP32_KERNELS)
        check(b["n_valid"] == [n_local] * MESH_RANKS and all(b["invariants_ok"]),
              f"phase 8a: shard graphs incomplete or invalid: {b['n_valid']}")
        print(f"phase 8a: {MESH_RANKS} shards of {n_local} rows, exact seed graphs then lockstep "
              f"waves of W={knn_lgd.full_config().wave} per shard: {b['seconds']:.3f} s, "
              f"{b['waves']} waves, all-reduced n_comps {b['comps']}, edges {b['edges']}",
              flush=True)

        s_ = res["search"]
        launches("search", ("gather_distance", "fused_expand"))
        ids, blank = s_["ids"].to(self.dev), s_["blank_ids"].to(self.dev)
        truth = self.held_truth
        recall = brute.recall_at_k(ids, truth, 10)
        recall_b = brute.recall_at_k(blank, truth, 10)
        served0 = int(((blank >= 0) & (blank < n_local)).sum())
        lat = np.asarray(s_["latency_ms"])
        print(f"phase 8b: scatter-gather search of {ids.shape[0]} held-out queries in waves of "
              f"{MESH_WAVE}: recall@10 {recall:.4f} against brute force over all {n} rows; "
              f"latency per wave p50 {np.percentile(lat, 50):.3f} ms, mean {lat.mean():.3f} ms, "
              f"p99 {np.percentile(lat, 99):.3f} ms", flush=True)
        print(f"phase 8b: shard 0 blanked: {served0} of its rows served, recall@10 "
              f"{recall_b:.4f} (drop {recall - recall_b:.4f})", flush=True)
        check(served0 == 0, f"phase 8b: the blanked shard served {served0} rows")
        check(bool((blank >= 0).all()), "phase 8b: the live shards left an answer short")

        p = res["parallel"]
        launches("parallel", FP32_KERNELS)
        check(all(p["invariants_ok"]) and p["same_on_every_rank"],
              "phase 8c: the mesh build_parallel graph is invalid or differs between ranks")
        recall_p = brute.recall_at_k(p["nbr_ids_rows"].to(self.dev), self.truth, 10)
        print(f"phase 8c: build_parallel on the group, {MESH_RANKS} shards, one refine round, "
              f"each side's cross search one batch ({n_local} lanes at level 0, {2 * n_local} at "
              f"level 1): {p['seconds']:.3f} s (phase 7a's "
              f"host path {self.t_par:.3f} s), {p['waves']} waves, n_comps {p['comps']}, peak "
              f"memory per rank {max(p['peak']) / 2**30:.3f} GiB; host seconds by span (rank 0): "
              + ", ".join(f"{k} {v:.3f}" for k, v in p["spans"].items()), flush=True)
        print(f"phase 8c: recall@10 over {self.rows.numel()} strided rows = {recall_p:.4f} "
              f"(phase 7a {self.recall_par:.4f}); the whole world {t_world:.3f} s with its "
              "start-up", flush=True)
        check(recall_p >= self.recall_par - 0.02,
              f"phase 8c: recall@10 {recall_p:.4f} < phase 7a {self.recall_par:.4f} - 0.02")

    # ---------------------------------------------------------------- phase 9
    def phase_recsys(self):
        """9: the recommender serving path at the published widths: (a) each
        arch's scoring at serve_p99, serve_bulk and retrieval_cand against
        the CPU in float64, (b) the MIND table's first 10^6 rows as an ip
        index serving 256 users' interests (kernels against plain, against
        brute, churn), with the three kernels held against plain at the
        shapes that path gave them, (c) the example at its own size."""
        torch = self.torch
        for arch in RECSYS_ARCHS:
            params, cfg = self.recsys_scoring(arch)
            if arch != "mind":
                del params
                torch.cuda.empty_cache()
        self.mind_index(params, cfg)
        del params
        torch.cuda.empty_cache()
        self.retrieval_example()

    def recsys_scoring(self, arch):
        """9a: one arch at ``full_config()``, parameters drawn on the card;
        ``serve_scores`` at serve_p99 and serve_bulk (in row chunks) from
        ``recsys_data`` batches, then the arch's retrieval_cand scorer over
        10^6 candidates.  Returns (params, cfg)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.data import recsys_data
        from repro_torch.models import common, recsys

        mod = configs.get(arch)
        cfg = mod.full_config()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = recsys.init_params(self.gen(RECSYS_PARAM_SEED), cfg)
        torch.cuda.synchronize()
        n_par = common.count_params(params)
        print(f"phase 9a: {arch} full_config(): {n_par} parameters ({4 * n_par / 2**30:.3f} GiB) "
              f"drawn on the card in {time.perf_counter() - t0:.3f} s", flush=True)
        g = self.gen(RECSYS_DATA_SEED)
        ctr = arch in ("deepfm", "xdeepfm")
        # the warm-up call scores the first two row chunks
        w = 2 * recsys.default_chunk(cfg)

        def serve(p, b):
            return recsys.serve_scores(p, b, cfg)

        for shape in ("serve_p99", "serve_bulk"):
            B = mod.SHAPES[shape]["batch"]
            batch = (recsys_data.ctr_batch(g, B, cfg.n_sparse, cfg.vocab_per_field) if ctr else
                     recsys_data.behavior_batch(g, B, cfg.seq_len, cfg.vocab_per_field))
            scores = self.timed_scores(arch, shape, serve, params, batch,
                                       {k: v[:w] for k, v in batch.items()}, B)
            self.check_scores(arch, shape, scores, params, cfg,
                              {k: v[:CHECK_ROWS] for k, v in batch.items()}, serve)
            del batch, scores
        N = mod.SHAPES["retrieval_cand"]["n_candidates"]
        if arch == "mind":
            rb = recsys_data.retrieval_batch(g, N, cfg.embed_dim, seq_len=cfg.seq_len,
                                             vocab=cfg.vocab_per_field)
            head = {"hist": rb["hist"], "candidates": rb["candidates"][:CHECK_ROWS]}
            warm = {"hist": rb["hist"], "candidates": rb["candidates"][:w]}

            def fn(p, b):
                return recsys.retrieval_scores(p, b["hist"], b["candidates"], cfg)
        else:
            if ctr:
                user = recsys_data.ctr_batch(g, 1, cfg.n_sparse, cfg.vocab_per_field)
                rb = {"dense": user["dense"], "sparse": user["sparse"]}
            else:
                rb = {"hist": recsys_data.zipf_ids(g, (1, cfg.seq_len), cfg.vocab_per_field)}
            rb["cand"] = recsys_data.zipf_ids(g, (N,), cfg.vocab_per_field)
            head = {**rb, "cand": rb["cand"][:CHECK_ROWS]}
            warm = {**rb, "cand": rb["cand"][:w]}
            scorer = recsys.ctr_retrieval_scores if ctr else recsys.bst_retrieval_scores

            def fn(p, b):
                return scorer(p, b, cfg)
        scores = self.timed_scores(arch, "retrieval_cand", fn, params, rb, warm, N)
        self.check_scores(arch, "retrieval_cand", scores, params, cfg, head, fn)
        return params, cfg

    def timed_scores(self, arch, shape, fn, params, batch, warm, n):
        """``fn(params, batch)`` timed to its synchronize after a warm-up
        call on the rows ``warm``, with the peak memory it reached; the
        scores must be n finite values."""
        torch = self.torch
        fn(params, warm)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        check(tuple(out.shape) == (n,), f"{arch} {shape}: scores of shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{arch} {shape}: non-finite scores")
        print(f"phase 9a: {arch} {shape} ({n} rows): {ms:.3f} ms, peak {peak / 2**30:.3f} GiB "
              f"({(peak - base) / 2**30:.3f} GiB over the parameters and inputs)", flush=True)
        return out

    def check_scores(self, arch, shape, scores, params, cfg, head, fn):
        """The card's first ``CHECK_ROWS`` scores against ``fn`` on the same
        parameters and input rows (``head``) on the CPU in float64."""
        torch = self.torch
        from repro_torch.models import recsys

        ids = [recsys.field_ids(v, cfg).reshape(-1) if k == "sparse" else v.reshape(-1).long()
               for k, v in head.items() if not v.is_floating_point()]
        ids = torch.cat(ids)
        p64 = self.cpu64(params, torch.unique(ids[ids >= 0]))
        b64 = {k: v.to("cpu", torch.float64) if v.is_floating_point() else v.cpu()
               for k, v in head.items()}
        want = fn(p64, b64)
        got = scores[:CHECK_ROWS].to("cpu", torch.float64)
        err = (got - want).abs()
        worst = float((err / (SCORE_ATOL + SCORE_RTOL * want.abs())).max())
        print(f"phase 9a: {arch} {shape}: first {got.numel()} scores against the CPU in float64: "
              f"max abs err {float(err.max()):.3e} ({worst:.3f} of the tolerance rtol={SCORE_RTOL}, "
              f"atol={SCORE_ATOL})", flush=True)
        check(worst <= 1.0, f"{arch} {shape}: card scores differ from the CPU's float64 by "
                            f"{float(err.max()):.3e}")

    def cpu64(self, tree, rows):
        """``tree`` on the CPU in float64.  Of each table only ``rows`` are
        copied, into a tensor whose other rows are left unset: the checked
        rows' lookups read no other row, and a whole 10^7-row table in
        float64 would take 5 GB of host memory for 256 rows."""
        torch = self.torch
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = self.cpu64(v, rows)
            elif k in ("table", "lin_table"):
                t = torch.empty(tuple(v.shape), dtype=torch.float64)
                t[rows.cpu()] = v[rows].to("cpu", torch.float64)
                out[k] = t
            else:
                out[k] = v.to("cpu", torch.float64)
        return out

    @contextlib.contextmanager
    def capture(self, shapes, out):
        """Within the block, keep the arguments of one call of an ``ops``
        function for each label of ``shapes`` (label -> (function name,
        rows of its first argument[, n])): its n-th call at those rows
        (default ``CAPTURE_CALL``, a search some steps in).  Tensors are
        copied before the call (the expansion updates its hash in place),
        except the item table, which no call writes."""
        import inspect

        torch = self.torch
        saved, seen = {}, {}
        for name in {fn for fn, *_ in shapes.values()}:
            saved[name] = getattr(self.ops, name)

            def wrapper(*args, _fn=saved[name], _name=name, **kw):
                for label, (fname, rows, *nth) in shapes.items():
                    if fname != _name or rows != args[0].shape[0] or label in out:
                        continue
                    seen[label] = seen.get(label, 0) + 1
                    if seen[label] == (nth[0] if nth else CAPTURE_CALL):
                        bound = inspect.signature(_fn).bind(*args, **kw)
                        bound.apply_defaults()
                        out[label] = {k: v.clone() if torch.is_tensor(v) and v.numel() < 1 << 24
                                      else v for k, v in bound.arguments.items()}
                return _fn(*args, **kw)

            setattr(self.ops, name, wrapper)
        try:
            yield out
        finally:
            for name, fn in saved.items():
                setattr(self.ops, name, fn)

    def serve_users(self, index, interests):
        """One ``retrieve`` per user (top-20 of its interests at beam 48,
        entry points seeded by the user): (ids on the host, seconds per
        request to the ids on the host, comps per query)."""
        from repro_torch.serve import retrieval

        got, secs, comps = [], [], []
        for u, q in enumerate(interests):
            t0 = time.perf_counter()
            ids, _, res = retrieval.retrieve(index, q, MIND_TOP_K, beam=MIND_BEAM,
                                             generator=self.gen(MIND_QUERY_SEED + u),
                                             with_stats=True)
            ids = ids.cpu()
            secs.append(time.perf_counter() - t0)
            got.append(ids)
            comps.append(float(res.n_comps.float().mean()))
        return got, secs, comps

    def mind_index(self, params, cfg):
        """9b: the MIND table's first 10^6 rows, L2-normalised, indexed with
        ``retrieval.build_index(metric="ip")``; 256 users' ``behavior_batch``
        histories through ``mind_interests`` (normalised) served through the
        kernels, against ``retrieve_brute`` and against the same requests
        through the plain versions; churn; then each kernel held against its
        plain version at the shapes this path gave it."""
        import numpy as np

        torch = self.torch
        from repro_torch.data import recsys_data
        from repro_torch.models import recsys
        from repro_torch.serve import retrieval

        def normalize(v):
            return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-9)

        items = normalize(params["table"][:MIND_ROWS])
        K = cfg.n_interests
        shapes = {"build_gather": ("gather_distance", MIND_WAVE),
                  "serve_gather": ("gather_distance", K),
                  "build_expand": ("expand_step", MIND_WAVE),
                  "serve_expand": ("expand_step", K),
                  "build_tile": ("pairwise_distance", MIND_WAVE),
                  "brute_tile": ("pairwise_distance", K)}
        captured = {}
        self.ops.reset_launch_counts()
        with self.capture(shapes, captured):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index = retrieval.build_index(items, k=MIND_K, metric="ip", wave=MIND_WAVE,
                                          beam=MIND_BUILD_BEAM, capacity=MIND_ROWS + MIND_CHURN,
                                          generator=self.gen(MIND_INDEX_SEED), device=self.dev)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            at_build = self.ops.launch_counts()
            hist = recsys_data.behavior_batch(self.gen(MIND_USER_SEED), MIND_USERS, cfg.seq_len,
                                              cfg.vocab_per_field)["hist"]
            interests = normalize(recsys.mind_interests(params, hist, cfg))
            got, secs, comps = self.serve_users(index, interests)
            at_serve = self.ops.launch_counts()
            t0 = time.perf_counter()
            exact = [retrieval.retrieve_brute(index, q, MIND_TOP_K)[0].cpu() for q in interests]
            t_brute = time.perf_counter() - t0
            fresh = normalize(torch.randn((MIND_CHURN, cfg.embed_dim),
                                          generator=self.gen(MIND_FRESH_SEED), device=self.dev))
            victims = torch.randperm(MIND_ROWS, generator=self.gen(MIND_VICTIM_SEED),
                                     device=self.dev)[:MIND_CHURN]
            t0 = time.perf_counter()
            churned = retrieval.remove_items(retrieval.add_items(index, fresh), victims)
            torch.cuda.synchronize()
            t_churn = time.perf_counter() - t0
            after, secs_after, _ = self.serve_users(churned, interests[:MIND_AFTER_USERS])
        self.path_counts("retrieval", f"phase 9b's MIND index path (build, {MIND_USERS} requests, "
                                      f"brute, churn, {MIND_AFTER_USERS} requests)")
        print("phase 9b: fp32 launches in the build / in the first "
              f"{MIND_USERS} requests: "
              + ", ".join(f"{k} {at_build[k]} / {at_serve[k] - at_build[k]}" for k in FP32_KERNELS),
              flush=True)
        print(f"phase 9b: MIND table's first {MIND_ROWS} rows (d={cfg.embed_dim}, ip, k={MIND_K}, "
              f"W={MIND_WAVE}, beam {MIND_BUILD_BEAM}) indexed in {t_build:.3f} s "
              f"({MIND_ROWS / t_build:.1f} rows/s)", flush=True)
        overlap = np.array([len(set(a.tolist()) & set(b.tolist())) / MIND_TOP_K
                            for a, b in zip(got, exact)])
        ms = np.sort(np.array(secs)) * 1e3
        print(f"phase 9b: {MIND_USERS} users x {K} interests, top-{MIND_TOP_K} at beam {MIND_BEAM}: "
              f"overlap@{MIND_TOP_K} with brute mean {overlap.mean():.4f}, min {overlap.min():.4f}; "
              f"p50 {np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms per request; "
              f"comps/query {np.mean(comps):.1f}; retrieve_brute {t_brute:.3f} s for all "
              f"{MIND_USERS}", flush=True)
        check(all(ids.numel() == MIND_TOP_K and ids.unique().numel() == MIND_TOP_K for ids in got),
              "a request returned fewer than top-k distinct ids")
        check(churned.capacity == MIND_ROWS + MIND_CHURN,
              f"the churn grew the index to {churned.capacity} rows")
        vict = victims.cpu()
        leaked = sum(int(torch.isin(ids, vict).sum()) for ids in after)
        check(leaked == 0, f"{leaked} withdrawn ids served after the churn")
        ms_after = np.sort(np.array(secs_after)) * 1e3
        print(f"phase 9b: churn +{MIND_CHURN} / -{MIND_CHURN} in {t_churn:.3f} s, then the first "
              f"{len(after)} requests again: p50 {np.percentile(ms_after, 50):.3f} ms, no "
              f"withdrawn id served",
              flush=True)
        with self.plain_versions():
            t0 = time.perf_counter()
            plain, _, _ = self.serve_users(index, interests)
            t_plain = time.perf_counter() - t0
        same = sum(torch.equal(a, b) for a, b in zip(got, plain))
        print(f"phase 9b: the same {MIND_USERS} requests through the plain versions on the card "
              f"({t_plain:.3f} s, kernels {sum(secs):.3f} s): {same} of {MIND_USERS} return the "
              f"same ids", flush=True)
        check(same == MIND_USERS, f"{MIND_USERS - same} requests differ between kernels and plain")
        self.check_captured(captured)

    def check_captured(self, captured):
        """Each kernel against its plain version on the arguments the MIND
        path gave it, then timed at those shapes (gathers over cold sets of
        random rows and ids of the same shape)."""
        torch = self.torch
        from repro_torch.kernels import ref

        for label in ("build_gather", "serve_gather", "build_expand", "serve_expand",
                      "build_tile", "brute_tile"):
            check(label in captured, f"phase 9b: no call of {label}'s shape was seen")
            a = captured[label]
            prefix = "mind_" + label.split("_")[0] + "_"
            if label.endswith("gather"):
                q, x, idx, metric = a["q"], a["x"], a["idx"], a["metric"]
                kw = dict(sq_norms=a["sq_norms"])
                self.compare("gather_distance", self.ops.gather_distance(q, x, idx, metric, **kw),
                             ref.gather_distance(q, x, idx, metric, **kw), exact=False,
                             what=f"phase 9 {label} B={q.shape[0]} C={idx.shape[1]} {metric}")
                # cold sets: unit queries and ids over the indexed rows
                g = self.gen(80 + q.shape[0])
                B, C = idx.shape
                sets = [(torch.nn.functional.normalize(
                             torch.randn((B, x.shape[1]), generator=g, device=self.dev), dim=1),
                         torch.randint(0, MIND_ROWS, (B, C), generator=g, device=self.dev).int())
                        for _ in range(self.bench.COLD_SETS + 2)]
                self.time_gather(x, sets, "fp32", prefix=prefix, metric=metric)
            elif label.endswith("expand"):
                args = [a[k] for k in ("q", "x", "cands", "beam_ids", "beam_dist", "beam_exp",
                                       "vis_ids", "vis_dist")]
                kw = dict(metric=a["metric"], sq_norms=a["sq_norms"])
                got = self.ops.expand_step(*args[:6], args[6].clone(), args[7].clone(),
                                           hash_probes=a["hash_probes"], **kw)
                want = self.plain_expand(*args[:6], args[6].clone(), args[7].clone(),
                                         probes=a["hash_probes"], **kw)
                B, C = args[2].shape
                self.compare_expand("fused_expand", got, want,
                                    f"phase 9 {label} B={B} C={C} {a['metric']}",
                                    exact=False, beam_ids=False)
                self.time_expand(args[1], args[0], a["sq_norms"], tuple(args[2:]),
                                 a["hash_probes"], None, "fp32", prefix=prefix, metric=a["metric"])
            else:
                q, x, metric, xn = a["q"], a["x"], a["metric"], a["x_sq_norms"]
                self.compare("pairwise_distance",
                             self.ops.pairwise_distance(q, x, metric, x_sq_norms=xn),
                             ref.pairwise_distance(q, x, metric, x_sq_norms=xn), exact=False,
                             what=f"phase 9 {label} m={q.shape[0]} n={x.shape[0]} {metric}")
                self.time_pairwise(q, x, xn, prefix=prefix, metric=metric)
        print("phase 9b: gather, expansion and pairwise at the MIND path's shapes (d=64, ip; "
              "build B=4096, serving B=4): kernels agree with plain", flush=True)

    def retrieval_example(self):
        """9c: ``examples/retrieval_serving_torch.py`` at its own size on the
        card (8,000 items, d=16, W=512): mean overlap@20 with exact
        retrieval >= ``EXAMPLE_OVERLAP``, no withdrawn item after its churn."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "retrieval_serving_torch", ROOT / "examples" / "retrieval_serving_torch.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        rec = example.main([])
        print(f"phase 9c: examples/retrieval_serving_torch.py on {rec['device']}: "
              f"{rec['n_items']} items, overlap@20 mean {rec['overlap_mean']:.4f}, "
              f"min {rec['overlap_min']:.4f}, build {rec['build_s']:.3f} s", flush=True)
        check(rec["overlap_mean"] >= EXAMPLE_OVERLAP,
              f"the example's mean overlap@20 {rec['overlap_mean']:.4f} < {EXAMPLE_OVERLAP}")

    # --------------------------------------------------------------- phase 10
    def phase_train(self):
        """10: training on the card.  (a) each recommender at the published
        widths, (b) the paper's graph over 10^5 atoms under MACE, (c) MACE
        training at full_graph_sm and molecule, (d) the compressed
        data-parallel step on 4 gloo ranks."""
        torch = self.torch
        for arch in RECSYS_ARCHS:
            self.recsys_training(arch)
            torch.cuda.empty_cache()
        self.atom_graph()
        torch.cuda.empty_cache()
        self.mace_training()
        torch.cuda.empty_cache()
        self.compressed_dp()

    def timed_steps(self, what, step, state, batches):
        """``state = step(*state, batch)`` over ``batches``, each step timed
        (host clock to a synchronize; the batch made before the clock
        starts), with the peak memory over them: (state, ms per step,
        metrics per step)."""
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = [], []
        for make in batches:
            batch = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *state, m = step(*state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated()
        check(all(all(map(math.isfinite, m.values())) for m in metrics),
              f"{what}: non-finite metrics {metrics}")
        return state, ms, metrics, peak

    def split_step(self, loss, state, batch, ocfg, accum=1):
        """One more step in its two layers, each timed to a synchronize: the
        gradients (forward and backward of every microbatch) and the
        optimizer's update (clip and AdamW): (gradients ms, update ms)."""
        torch = self.torch
        from repro_torch.train import optimizer as opt_lib
        from repro_torch.train import train_loop

        params, opt = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = train_loop.step_grads(loss, params, batch, accum)[2]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt_lib.apply_updates(params, grads, opt, ocfg)
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    def recsys_training(self, arch):
        """10a: one arch at ``full_config()``, parameters drawn on the card,
        AdamW over ``train_batch`` batches from the skip-ahead loader: the
        first step on the first rows against the CPU in float64, then one
        warm-up and ``TRAIN_STEPS`` timed steps."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.data import loader, recsys_data
        from repro_torch.models import common, recsys
        from repro_torch.train import optimizer as opt_lib
        from repro_torch.train import train_loop

        mod = configs.get(arch)
        cfg = mod.full_config()
        B = mod.SHAPES["train_batch"]["batch"]
        accum = XDEEPFM_ACCUM if arch == "xdeepfm" else 1
        params = recsys.init_params(self.gen(RECSYS_PARAM_SEED), cfg)
        ctr = arch in ("deepfm", "xdeepfm")

        def rows(g):
            if ctr:
                return recsys_data.ctr_batch(g, B, cfg.n_sparse, cfg.vocab_per_field)
            return recsys_data.behavior_batch(g, B, cfg.seq_len, cfg.vocab_per_field)

        def loss(p, b):
            return recsys.loss_fn(p, b, cfg)

        data = loader.LoaderSpec(rows, seed=TRAIN_SEED, device=self.dev)
        self.check_train_grads(arch, cfg, params, data.batch(0), loss)
        ocfg = opt_lib.OptConfig(name="adamw", lr=TRAIN_LR)
        step = train_loop.make_train_step(loss, ocfg, accum_steps=accum)
        state = (params, opt_lib.init_opt_state(params, ocfg))
        del params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, m0 = step(*state, data.batch(0))
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        state, ms, metrics, peak = self.timed_steps(
            f"phase 10a {arch}", step, state,
            [lambda s=s: data.batch(s) for s in range(1, TRAIN_STEPS + 1)])
        n_par = common.count_params(state[0])
        t_g, t_u = self.split_step(loss, state, data.batch(TRAIN_STEPS + 1), ocfg, accum)
        print(f"phase 10a: {arch} full_config() training, {n_par} parameters, AdamW (dense: every "
              f"table row decays), train_batch {B} rows in {accum} microbatch(es) of {B // accum}: "
              f"{sum(ms) / len(ms):.3f} ms per step (steps {', '.join(f'{t:.3f}' for t in ms)}; "
              f"warm-up {warm:.3f}), peak {peak / 2**30:.3f} GiB; loss "
              f"{float(m0['loss']):.4f} -> {metrics[-1]['loss']:.4f}, grad_norm "
              f"{metrics[-1]['grad_norm']:.4f}; one more step split: gradients {t_g:.3f} ms, "
              f"clip and AdamW {t_u:.3f} ms", flush=True)
        if accum > 1:
            check(peak < 60 * 2**30, f"phase 10a: {arch} at accum_steps={accum} peaked at "
                                     f"{peak / 2**30:.3f} GiB")
        del state

    @contextlib.contextmanager
    def relu_masks(self, masks, replay):
        """Within the block every ReLU of the recommenders (``torch.relu``
        and ``common.ACTIVATIONS["relu"]``) either appends its mask
        (input > 0) to ``masks`` or, with ``replay``, multiplies its input
        by the next mask of ``masks``: a float64 pass then takes the branch
        an fp32 pass took at every unit, also where the input lies within
        fp32 rounding of 0, so the two differ only by rounding."""
        torch = self.torch
        from repro_torch.models import common

        saved = torch.relu, common.ACTIVATIONS["relu"]
        seen = iter(masks) if replay else None

        def relu(x):
            if not replay:
                masks.append((x > 0).cpu())
                return saved[0](x)
            m = next(seen, None)
            check(m is not None and tuple(m.shape) == tuple(x.shape),
                  "phase 10a: the float64 pass ran another ReLU than the fp32 pass")
            return x * m.to(x.device, x.dtype)

        torch.relu, common.ACTIVATIONS["relu"] = relu, relu
        try:
            yield
        finally:
            torch.relu, common.ACTIVATIONS["relu"] = saved
        check(seen is None or next(seen, None) is None,
              "phase 10a: the float64 pass ran fewer ReLUs than the fp32 pass")

    def check_train_grads(self, arch, cfg, params, batch, loss):
        """The first step's loss and gradients on the batch's first
        ``CHECK_ROWS`` rows, card against the CPU in float64 (tables copied
        only on the rows those rows read): the loss within ``GRAD_RTOL``,
        every dense leaf and the read rows of each table within
        ``GRAD_RTOL`` of the leaf's largest element.  A ReLU whose input
        lies within fp32 rounding of 0 may take the other side in fp32 than
        in float64, which moves a whole term of a gradient (BST's 1,024-wide
        MLP on some batches: up to 7% of a leaf's largest element), so the
        float64 pass replays the card's ReLU masks (``relu_masks``); the
        units whose float64 input lies on the other side are counted."""
        torch = self.torch
        from repro_torch.launch.train import flatten
        from repro_torch.models import recsys
        from repro_torch.train import train_loop

        head = {k: v[:CHECK_ROWS] for k, v in batch.items()}
        ids = [recsys.field_ids(v, cfg).reshape(-1) if k == "sparse" else v.reshape(-1).long()
               for k, v in head.items() if not v.is_floating_point()]
        ids = torch.cat(ids)
        rows = torch.unique(ids[ids >= 0])

        def grads(p, b):
            (l, _), g = train_loop.value_and_grad(loss, p, b)
            g = {k: (v[rows.to(v.device)] if k.rsplit("/", 1)[-1] in ("table", "lin_table")
                     else v).to("cpu", torch.float64) for k, v in flatten(g).items()}
            return float(l), g

        masks, masks64 = [], []
        with self.relu_masks(masks, replay=False):
            l32, g32 = grads(params, head)
        p64 = self.cpu64(params, rows)
        b64 = {k: v.to("cpu", torch.float64) if v.is_floating_point() else v.cpu()
               for k, v in head.items()}
        with self.relu_masks(masks, replay=True):
            l64, g64 = grads(p64, b64)
        with self.relu_masks(masks64, replay=False), torch.no_grad():
            loss(p64, b64)
        flipped = sum(int((a != b).sum()) for a, b in zip(masks, masks64))
        units = sum(m.numel() for m in masks)
        worst = {}
        for name, want in g64.items():
            scale = float(want.abs().max()) or 1.0
            worst[name] = float((g32[name] - want).abs().max()) / scale
        err_l = abs(l32 - l64) / abs(l64)
        name, w = max(worst.items(), key=lambda kv: kv[1])
        print(f"phase 10a: {arch} first step on the first {CHECK_ROWS} rows against the CPU in "
              f"float64 on the card's {len(masks)} ReLU masks ({units} units, {flipped} of them "
              f"on the other side of 0 in float64): loss {l64:.6f} (rel err {err_l:.3e}), "
              f"{len(worst)} gradient leaves, worst {name} at {w:.3e} of its largest element "
              f"(tolerance {GRAD_RTOL})", flush=True)
        check(err_l <= GRAD_RTOL and w <= GRAD_RTOL,
              f"phase 10a: {arch} gradients differ from the CPU's: {name} {w:.3e}, "
              f"loss {err_l:.3e}")

    def atom_graph(self):
        """10b: the paper's graph over ``ATOM_N`` atoms uniform in a box of
        side ``ATOM_SIDE`` (the example's density): the LGD build (k=8, l2,
        W=1024) through the kernels and its exact graph through the pairwise
        kernel; the exact graph and the build again through the plain
        versions, both builds scored against the plain exact graph (recall
        within 0.01; phase 2e held the ids bit for bit on integer
        positions); the pairwise kernel against plain on one full tile of
        the exact graph, captured, within ``ATOM_PAIR_RTOL``, and timed;
        then MACE at full_config("molecule") over the graph's edges, energy
        and forces timed, and held against the CPU in float64 on a slab of
        the box."""
        torch = self.torch
        from repro_torch.configs import mace_cfg
        from repro_torch.core import brute, construct
        from repro_torch.models import mace

        n = ATOM_N
        pos = torch.rand((n, 3), generator=self.gen(ATOM_SEED), device=self.dev) * ATOM_SIDE
        captured = {}
        self.ops.reset_launch_counts()
        g_k, st_k, t_k = self.atom_build(pos, ATOM_BUILD_SEED)
        at_build = self.ops.launch_counts()
        t0 = time.perf_counter()
        with self.capture({"brute_tile": ("pairwise_distance", n)}, captured):
            exact_k, dist_k = self.exact_atom_graph(pos)
        torch.cuda.synchronize()
        t_exact = time.perf_counter() - t0
        self.path_counts("atom", f"phase 10b's atom path (the build of {n} atoms, then its exact "
                                 "graph)")
        rate = construct.scanning_rate(st_k, n)
        with self.plain_versions():
            exact, dist_p = self.exact_atom_graph(pos)
            g_p, st_p, t_p = self.atom_build(pos, ATOM_BUILD_SEED)
        # the exact graphs: the same k distances per atom within the tile's
        # tolerance (ids may swap only where two distances lie that close)
        norms = (pos * pos).sum(1)
        slack = ATOM_PAIR_RTOL * (norms + norms.max())
        err_d = float(((dist_k - dist_p).abs() / slack[:, None]).max())
        agree = brute.recall_at_k(exact_k, exact, ATOM_K)
        recall_k = brute.recall_at_k(g_k.nbr_ids[:n], exact, ATOM_K)
        recall_p = brute.recall_at_k(g_p.nbr_ids[:n], exact, ATOM_K)
        print(f"phase 10b: LGD graph over {n} atoms (d=3, box side {ATOM_SIDE:.3f}, k={ATOM_K}, "
              f"W={ATOM_WAVE}): {t_k:.3f} s ({n / t_k:.1f} atoms/s), scanning rate {rate:.6f}, "
              f"edge recall@{ATOM_K} {recall_k:.4f} against the plain versions' exact graph; "
              f"fp32 launches in the build: "
              + ", ".join(f"{k} {at_build[k]}" for k in FP32_KERNELS), flush=True)
        print(f"phase 10b: the exact graph through the pairwise kernel in {t_exact:.3f} s: ids "
              f"{agree:.6f} of the plain versions', distances within {err_d:.3e} of the "
              f"tolerance ({ATOM_PAIR_RTOL} of |q|^2 + max |x|^2)", flush=True)
        print(f"phase 10b: the same build through the plain versions on the card: {t_p:.3f} s, "
              f"scanning rate {construct.scanning_rate(st_p, n):.6f}, recall@{ATOM_K} "
              f"{recall_p:.4f}", flush=True)
        check(err_d <= 1.0, f"phase 10b: the exact graph's distances, kernel vs plain, "
                            f"{err_d:.3e} of the tolerance")
        check(abs(recall_k - recall_p) <= 0.01,
              f"phase 10b: kernels' recall {recall_k:.4f} vs plain {recall_p:.4f}")
        del g_p, exact, exact_k, dist_k, dist_p
        self.atom_brute_tile(captured)
        # --- MACE over the graph's edges ---------------------------------------
        cfg = mace_cfg.full_config("molecule")
        params = mace.init_params(self.gen(MACE_PARAM_SEED), cfg)
        species = torch.randint(0, cfg.n_species, (n,), generator=self.gen(MACE_DATA_SEED),
                                device=self.dev)
        nbr = g_k.nbr_ids[:n]
        valid = (nbr >= 0).reshape(-1)
        senders = nbr.reshape(-1)[valid]
        receivers = torch.arange(n, device=self.dev).repeat_interleave(ATOM_K)[valid]
        mace.energy(params, pos[:64], species[:64], senders[:0], receivers[:0], cfg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        e = mace.energy(params, pos, species, senders, receivers, cfg)
        torch.cuda.synchronize()
        t_e = (time.perf_counter() - t0) * 1e3
        peak_e = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        f = mace.forces(params, pos, species, senders, receivers, cfg)
        torch.cuda.synchronize()
        t_f = (time.perf_counter() - t0) * 1e3
        peak_f = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(e)) and bool(torch.isfinite(f).all()),
              "phase 10b: non-finite MACE energy or forces")
        print(f"phase 10b: MACE full_config('molecule') (d_hidden {cfg.d_hidden}, correlation "
              f"{cfg.correlation}) over the graph's {senders.numel()} edges: energy "
              f"{float(e):.4f} in {t_e:.3f} ms (peak {peak_e / 2**30:.3f} GiB), forces (energy "
              f"and its gradient) in {t_f:.3f} ms (peak {peak_f / 2**30:.3f} GiB), max |F| "
              f"{float(f.abs().max()):.4f}", flush=True)
        # --- the CPU's float64 on a slab of the box ------------------------------
        keep = pos[:, 0] < ATOM_CUT * ATOM_SIDE
        new_id = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        new_id[keep] = torch.arange(int(keep.sum()), device=self.dev)
        s2, r2 = new_id[senders], new_id[receivers]
        inside = (s2 >= 0) & (r2 >= 0)
        cut = (pos[keep], species[keep], s2[inside], r2[inside])
        e32 = mace.energy(params, *cut, cfg)
        f32 = mace.forces(params, *cut, cfg)
        p64 = {k: v.to("cpu", torch.float64) for k, v in params.items()}
        c64 = [t.to("cpu", torch.float64) if t.is_floating_point() else t.cpu() for t in cut]
        t0 = time.perf_counter()
        e64 = mace.energy(p64, *c64, cfg)
        f64 = mace.forces(p64, *c64, cfg)
        t_cpu = time.perf_counter() - t0
        err_e = abs(float(e32) - float(e64)) / abs(float(e64))
        err_f = float((f32.cpu().double() - f64).abs().max()) / float(f64.abs().max())
        print(f"phase 10b: the slab x < {ATOM_CUT * ATOM_SIDE:.3f} ({cut[0].shape[0]} atoms, "
              f"{cut[2].numel()} edges) against the CPU in float64 ({t_cpu:.3f} s): energy rel err "
              f"{err_e:.3e}, forces max err {err_f:.3e} of the largest |F| (tolerance "
              f"{MACE_RTOL})", flush=True)
        check(err_e <= MACE_RTOL and err_f <= MACE_RTOL,
              f"phase 10b: MACE on the card differs from the CPU's float64 (energy {err_e:.3e}, "
              f"forces {err_f:.3e})")
        self.molecule_example()

    def atom_brute_tile(self, captured):
        """10b: the pairwise kernel against its plain version on a full tile
        of the exact atom graph (10^5 real-valued positions against 8,192),
        each distance within ``ATOM_PAIR_RTOL`` of |q|^2 + |x|^2, then timed
        at that shape (``atom_brute_`` keys)."""
        torch = self.torch
        from repro_torch.kernels import ref

        check("brute_tile" in captured, "phase 10b: no tile of the exact graph was captured")
        a = captured.pop("brute_tile")
        q, x, metric, xn = a["q"], a["x"], a["metric"], a["x_sq_norms"]
        got = self.ops.pairwise_distance(q, x, metric, x_sq_norms=xn)
        want = ref.pairwise_distance(q, x, metric, x_sq_norms=xn)
        what = f"phase 10b d=3 m={q.shape[0]} n={x.shape[0]}"
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(want).all()),
              f"pairwise_distance {what}: shape {tuple(got.shape)} or a non-finite value")
        got -= want
        got.abs_()
        err = float(got.max())
        got /= (q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :]
        rel = float(got.max())
        del got, want
        print(f"pairwise_distance {what}: max abs err {err:.6e}, {rel:.3e} of |q|^2 + |x|^2 "
              f"(tolerance {ATOM_PAIR_RTOL})", flush=True)
        check(rel <= ATOM_PAIR_RTOL, f"pairwise_distance {what}: {rel:.3e} of |q|^2 + |x|^2 "
                                     f"beyond {ATOM_PAIR_RTOL}")
        self.rec["pairwise_distance"]["max_abs_err"] = max(
            self.rec["pairwise_distance"]["max_abs_err"], err)
        self.time_pairwise(q, x, xn, metric=metric, prefix="atom_brute_")

    def molecule_example(self):
        """10b: ``examples/molecule_graphs_torch.py`` at its own size (3,000
        atoms) on the card."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "molecule_graphs_torch", ROOT / "examples" / "molecule_graphs_torch.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        rec = example.main(["--device", str(self.dev)])
        print(f"phase 10b: examples/molecule_graphs_torch.py on {rec['device']}: {rec['n_atoms']} "
              f"atoms, build {rec['build_s']:.3f} s, scanning rate {rec['scanning_rate']:.4f}, "
              f"edge recall {rec['recall']:.4f}, MACE energy and forces {rec['mace_s']:.3f} s",
              flush=True)
        check(bool(self.torch.isfinite(rec["forces"]).all()),
              "phase 10b: the example's forces are not finite")

    def mace_training(self):
        """10c: MACE training at full_config("full_graph_sm") on a cora-size
        ``random_graph`` and at full_config("molecule") on ``MOLECULES``
        molecules with k-NN edges: AdamW, one warm-up and ``MACE_STEPS``
        timed steps each."""
        torch = self.torch
        from repro_torch.configs import mace_cfg
        from repro_torch.data import graphs
        from repro_torch.models import mace
        from repro_torch.train import optimizer as opt_lib
        from repro_torch.train import train_loop

        ocfg = opt_lib.OptConfig(name="adamw", lr=TRAIN_LR)
        s = mace_cfg.SHAPES["full_graph_sm"]
        cfg = mace_cfg.full_config("full_graph_sm")
        g = graphs.random_graph(self.gen(MACE_DATA_SEED), s["n_nodes"], s["n_edges"], s["d_feat"],
                                n_classes=s["n_classes"])
        n = s["n_nodes"]
        cora = dict(positions=torch.zeros((n, 3), device=self.dev),
                    species=torch.zeros((n,), dtype=torch.int32, device=self.dev),
                    senders=g.senders, receivers=g.receivers, node_feat=g.features,
                    labels=g.labels)
        params = mace.init_params(self.gen(MACE_PARAM_SEED), cfg)
        mol_params, mol_batch, mol_loss = molecule_problem(torch, self.dev)
        runs = [("full_graph_sm", params, cora, lambda p, b: mace.node_class_loss(p, b, cfg),
                 f"{n} nodes, {s['n_edges']} edges, d_feat {s['d_feat']}, "
                 f"{s['n_classes']} classes"),
                ("molecule", mol_params, mol_batch, mol_loss,
                 f"{MOLECULES} molecules x 30 atoms, {MOL_K}-NN edges "
                 f"({mol_batch['senders'].shape[1]} a molecule)")]
        for shape, p, batch, loss, what in runs:
            step = train_loop.make_train_step(loss, ocfg)
            state = (p, opt_lib.init_opt_state(p, ocfg))
            *state, m0 = step(*state, batch)  # warm-up
            state, ms, metrics, peak = self.timed_steps(
                f"phase 10c {shape}", step, state, [lambda: batch] * MACE_STEPS)
            t_g, t_u = self.split_step(loss, state, batch, ocfg)
            print(f"phase 10c: MACE {shape} ({what}), AdamW: {sum(ms) / len(ms):.3f} ms per step "
                  f"(steps {', '.join(f'{t:.3f}' for t in ms)}), peak {peak / 2**30:.3f} GiB; "
                  f"loss {float(m0['loss']):.4f} -> {metrics[-1]['loss']:.4f}; one more step "
                  f"split: gradients {t_g:.3f} ms, clip and AdamW {t_u:.3f} ms", flush=True)

    def compressed_dp(self):
        """10d: the two-level data-parallel step on ``DP_RANKS`` gloo ranks
        on the one card (``_train_rank``), MACE molecule: every rank ends
        with rank 0's parameters, uncompressed equals one process on the
        whole batch within ``DP_RTOL``, compressed tracks uncompressed within
        ``DP_TRACK``."""
        torch = self.torch
        import torch.multiprocessing as mp

        from repro_torch.launch.mesh import free_port

        run_dir = ROOT / "build" / "train_dp"
        run_dir.mkdir(parents=True, exist_ok=True)
        for old in run_dir.glob("*.pt"):
            old.unlink()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.spawn(_train_rank, args=(DP_RANKS, free_port(), str(run_dir), self.dev.type),
                 nprocs=DP_RANKS, join=True)
        t_world = time.perf_counter() - t0
        res = torch.load(run_dir / "train_dp.pt")
        for tag in ("comp", "full"):
            check(res[tag + "_replicated"], f"phase 10d: ranks' parameters differ ({tag})")

        def worst(a, b):
            return max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
                       for k in b)

        rel = worst(res["full_params"], res["single_params"])
        dw = max(float((res["comp_params"][k] - res["full_params"][k]).abs().max())
                 for k in res["full_params"])
        print(f"phase 10d: {DP_RANKS} gloo ranks on the one card, {DP_PODS} pods x "
              f"{DP_RANKS // DP_PODS} data ranks, MACE molecule, {MOLECULES // DP_RANKS} molecules "
              f"a rank, SGD lr {DP_LR}, {DP_STEPS} steps: compressed pod hop "
              f"{res['comp_ms']:.3f} ms per step (loss {res['comp_loss']:.4f}), uncompressed "
              f"{res['full_ms']:.3f} ms per step (loss {res['full_loss']:.4f}); one process on the "
              f"whole batch: loss {res['single_loss']:.4f}, worst leaf {rel:.3e} of its largest "
              f"element from the uncompressed ranks (tolerance {DP_RTOL}); compressed vs "
              f"uncompressed max |dw| {dw:.3e} (bound {DP_TRACK}); every rank's parameters equal "
              f"rank 0's; the world {t_world:.3f} s", flush=True)
        check(rel <= DP_RTOL, f"phase 10d: uncompressed ranks differ from one process by {rel:.3e}")
        check(dw < DP_TRACK, f"phase 10d: compressed drifts {dw:.3e} from uncompressed")

    # --------------------------------------------------------------- phase 11
    def phase_lm(self):
        """11: the LM family on the card, parameters drawn from seeds: (a)
        gemma3-1b's prefill at prefill_32k's length, (b) decode parity at
        full width (split against dense past the ring's wrap, prefill plus
        one step against forward), (c) decode_32k on the split cache, (d)
        training, (e) fp32 against the CPU's float64 and bf16 against fp32,
        (f) the other four archs at full width (mixtral and arctic cut in
        depth), (g) the entry points.  The LM path launches no hand kernel:
        its counts stay 0."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.models import transformer as tfm

        self.ops.reset_launch_counts()
        cfg = configs.get("gemma3-1b").full_config()
        params = tfm.init_params(self.gen(LM_PARAM_SEED), cfg)
        n_par = sum(v.numel() for v in params.values())
        check(n_par == cfg.param_count(), f"phase 11: gemma3-1b has {n_par} parameters, "
                                          f"param_count() {cfg.param_count()}")
        self.lm_prefill(cfg, params)
        self.lm_decode_parity(cfg, params)
        self.lm_decode_32k(cfg, params)
        self.lm_against_f64(cfg, params)
        del params
        torch.cuda.empty_cache()
        self.lm_train(cfg)
        torch.cuda.empty_cache()
        for arch in LM_OTHER_SEQ:
            self.lm_other(arch)
            torch.cuda.empty_cache()
        self.lm_entry_points()
        counts = self.ops.launch_counts()
        check(not any(counts.values()), f"phase 11: the LM path launched kernels {counts}")

    def lm_tokens(self, cfg, shape, seed):
        return self.torch.randint(0, cfg.vocab, shape, generator=self.gen(seed), device=self.dev,
                                  dtype=self.torch.int32)

    def lm_prefill(self, cfg, params):
        """11a: ``prefill`` of LM_PREFILL_B x LM_PREFILL_S tokens (a 1,024-token
        prefill first warms the library handles)."""
        torch = self.torch
        from repro_torch.models import transformer as tfm

        toks = self.lm_tokens(cfg, (LM_PREFILL_B, LM_PREFILL_S), LM_DATA_SEED)
        with torch.no_grad():
            tfm.prefill(params, toks[:, :1024], cfg)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, cache = tfm.prefill(params, toks, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        shape = (cfg.n_layers, LM_PREFILL_B, LM_PREFILL_S, cfg.n_kv_heads, cfg.head_dim)
        check(tuple(cache["k"].shape) == shape and tuple(cache["v"].shape) == shape
              and cache["k"].dtype == torch.bfloat16, f"phase 11a: cache {tuple(cache['k'].shape)}")
        check(tuple(logits.shape) == (LM_PREFILL_B, cfg.vocab)
              and bool(torch.isfinite(logits).all()), "phase 11a: prefill logits not finite")
        n = LM_PREFILL_B * LM_PREFILL_S
        print(f"phase 11a: gemma3-1b full_config() ({cfg.param_count()} parameters, bf16) prefill "
              f"{LM_PREFILL_B} x {LM_PREFILL_S} tokens: {secs:.3f} s ({n / secs:.1f} tokens/s), "
              f"peak {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB over the parameters "
              f"and tokens); cache {shape} bf16, {2 * cache['k'].numel() * 2 / 2**30:.3f} GiB",
              flush=True)

    def lm_decode_parity(self, cfg, params):
        """11b: the reference's two decode tests at full width.  (1) From
        empty caches at max_seq LM_PARITY_SEQ, LM_PARITY_STEPS teacher-forced
        steps at batch 2 through ``decode_step`` (dense) and
        ``decode_step_split`` (22 rings of 512 slots, 4 dense layers): every
        step's logits within LM_SPLIT_TOL of the step's largest.  (2)
        ``prefill`` of LM_PARITY_SEQ - 1 tokens, the cache padded by one, one
        ``decode_step``: its logits, and the prefill's, against ``forward``
        over all LM_PARITY_SEQ tokens, within LM_FWD_TOL of the largest."""
        torch = self.torch
        from repro_torch.models import transformer as tfm

        S = LM_PARITY_SEQ
        toks = self.lm_tokens(cfg, (2, S), LM_DATA_SEED + 1)
        dense = tfm.init_cache(cfg, 2, S, device=self.dev)
        split = tfm.init_split_cache(cfg, 2, S, device=self.dev)
        check(split["k_loc"].shape[2] == cfg.local_window, "phase 11b: ring != window")
        worst = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(LM_PARITY_STEPS):
                ld, dense = tfm.decode_step(params, dense, toks[:, t], cfg)
                ls, split = tfm.decode_step_split(params, split, toks[:, t], cfg)
                err = float((ld - ls).abs().max()) / float(ld.abs().max())
                worst = max(worst, err)
                check(bool(torch.isfinite(ls).all()), f"phase 11b: step {t} logits not finite")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"phase 11b: {LM_PARITY_STEPS} teacher-forced steps at batch 2, max_seq {S} (the "
              f"{cfg.local_window}-slot rings wrap at step {cfg.local_window}): split against "
              f"dense, worst step {worst:.3e} of the largest logit (tolerance {LM_SPLIT_TOL:.3e}); "
              f"{secs:.3f} s for both paths "
              f"({1e3 * secs / (2 * LM_PARITY_STEPS):.3f} ms a step)", flush=True)
        check(worst <= LM_SPLIT_TOL, f"phase 11b: split differs from dense by {worst:.3e}")
        del dense, split
        with torch.no_grad():
            pre, cache = tfm.prefill(params, toks[:, :S - 1], cfg)
            pad = (0, 0, 0, 0, 0, 1)
            cache = {"k": torch.nn.functional.pad(cache["k"], pad),
                     "v": torch.nn.functional.pad(cache["v"], pad), "len": cache["len"]}
            dec, _ = tfm.decode_step(params, cache, toks[:, S - 1], cfg)
            full = tfm.forward(params, toks, cfg)[0].float()
        e_dec = float((dec - full[:, -1]).abs().max()) / float(full[:, -1].abs().max())
        e_pre = float((pre - full[:, -2]).abs().max()) / float(full[:, -2].abs().max())
        print(f"phase 11b: prefill({S - 1}) + one decode step against forward({S}): last logits "
              f"within {e_dec:.3e} of the largest, the prefill's within {e_pre:.3e} (tolerance "
              f"{LM_FWD_TOL:.3e})", flush=True)
        check(max(e_dec, e_pre) <= LM_FWD_TOL,
              f"phase 11b: prefill/decode differ from forward by {max(e_dec, e_pre):.3e}")

    def lm_decode_32k(self, cfg, params):
        """11c: decode_32k: batch LM_DECODE_B through ``decode_step_split``
        at max_seq LM_DECODE_SEQ, caches filled from a seed with len
        LM_DECODE_LEN, LM_DECODE_STEPS greedy steps, each timed, beside the
        step's byte bound (every cache byte a step reads, the parameters,
        the logits written) at the card's 3.35 TB/s."""
        torch = self.torch
        from repro_torch.models import transformer as tfm

        B, S = LM_DECODE_B, LM_DECODE_SEQ
        cache = tfm.init_split_cache(cfg, B, S, device=self.dev)
        g = self.gen(LM_DATA_SEED + 2)
        for name in ("k_loc", "v_loc", "k_glob", "v_glob"):
            for layer in cache[name]:
                layer.copy_(torch.randn(layer.shape, generator=g, device=self.dev,
                                        dtype=torch.bfloat16))
        cache["len"].fill_(LM_DECODE_LEN)
        cache_bytes = sum(cache[n].numel() * 2 for n in ("k_loc", "v_loc", "k_glob", "v_glob"))
        tok = self.lm_tokens(cfg, (B,), LM_DATA_SEED + 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        with torch.no_grad():
            for _ in range(LM_DECODE_STEPS):
                t0 = time.perf_counter()
                logits, cache = tfm.decode_step_split(params, cache, tok, cfg)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                check(bool(torch.isfinite(logits).all()), "phase 11c: logits not finite")
        peak = torch.cuda.max_memory_allocated()
        n_loc, n_glob = cache["k_loc"].shape[0], cache["k_glob"].shape[0]
        # bytes a step must move: the K/V it reads (the rings whole, the
        # dense layers up to len), every parameter but the embedding's
        # unread rows (the tied head reads all of them), the logits
        read_kv = 2 * B * cfg.n_kv_heads * cfg.head_dim * 2 * (
            n_loc * cfg.local_window + n_glob * (LM_DECODE_LEN + LM_DECODE_STEPS // 2))
        par_bytes = sum(v.numel() * v.element_size() for v in params.values())
        bound_ms = (read_kv + par_bytes + B * cfg.vocab * 4) / LM_HBM_BYTES_S * 1e3
        mean = sum(ms[1:]) / len(ms[1:])
        print(f"phase 11c: decode_32k, gemma3-1b batch {B}, max_seq {S}, len {LM_DECODE_LEN}: split "
              f"caches {cache_bytes / 1e9:.3f} GB ({n_glob} dense layers "
              f"{cache['k_glob'].numel() * 4 / 1e9:.3f} GB, {n_loc} rings "
              f"{cache['k_loc'].numel() * 4 / 1e9:.3f} GB; a dense cache would be "
              f"{2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 2 / 1e9:.3f} GB): "
              f"{mean:.3f} ms per step over steps 2-{LM_DECODE_STEPS} (first {ms[0]:.3f} ms; "
              f"{B / mean * 1e3:.1f} tokens/s) against a byte bound of {bound_ms:.3f} ms "
              f"({(read_kv + par_bytes) / 1e9:.3f} GB at 3.35 TB/s); peak "
              f"{peak / 2**30:.3f} GiB", flush=True)

    def lm_against_f64(self, cfg, params):
        """11e: the forward at compute_dtype float32 (TF32 off) on 1 x
        LM_F64_TOKENS tokens against the same parameters in float64 on the
        CPU: within LM_F64_TOL of the largest logit.  The configured bf16
        forward against that fp32 forward: within LM_BF16_TOL."""
        torch = self.torch
        from repro_torch.models import transformer as tfm

        toks = self.lm_tokens(cfg, (1, LM_F64_TOKENS), LM_DATA_SEED + 4)
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        c64 = dataclasses.replace(cfg, compute_dtype="float64")
        with torch.no_grad():
            f32 = tfm.forward(params, toks, c32)[0]
            bf = tfm.forward(params, toks, cfg)[0].float()
            t0 = time.perf_counter()
            p64 = {k: v.to("cpu", torch.float64) for k, v in params.items()}
            f64 = tfm.forward(p64, toks.cpu(), c64)[0]
            t_cpu = time.perf_counter() - t0
            del p64
        e32 = float((f32.cpu().double() - f64).abs().max()) / float(f64.abs().max())
        ebf = float((bf - f32).abs().max()) / float(f32.abs().max())
        print(f"phase 11e: gemma3-1b forward on {LM_F64_TOKENS} tokens: fp32 on the card against "
              f"float64 on the CPU ({t_cpu:.1f} s there) within {e32:.3e} of the largest logit "
              f"(tolerance {LM_F64_TOL:.0e}); the bf16 forward against the fp32 one within "
              f"{ebf:.3e} (tolerance {LM_BF16_TOL:.3e})", flush=True)
        check(e32 <= LM_F64_TOL, f"phase 11e: fp32 differs from float64 by {e32:.3e}")
        check(ebf <= LM_BF16_TOL, f"phase 11e: bf16 differs from fp32 by {ebf:.3e}")

    def lm_train(self, cfg):
        """11d: AdamW through ``make_train_step`` at train_4k's sequence,
        remat on: LM_TRAIN_BATCH rows in LM_TRAIN_ACCUM microbatches, one
        warm-up and LM_TRAIN_STEPS timed steps (skip-ahead batches)."""
        torch = self.torch
        from repro_torch.data import loader
        from repro_torch.models import transformer as tfm
        from repro_torch.train import optimizer as opt_lib
        from repro_torch.train import train_loop

        check(cfg.remat, "phase 11d: gemma3-1b's full config trains without remat")
        params = tfm.init_params(self.gen(LM_PARAM_SEED), cfg)
        ocfg = opt_lib.OptConfig(name="adamw", lr=TRAIN_LR)
        step = train_loop.make_train_step(lambda p, b: tfm.loss_fn(p, b["tokens"], cfg), ocfg,
                                          accum_steps=LM_TRAIN_ACCUM)
        data = loader.lm_batches(LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab, seed=TRAIN_SEED,
                                 device=self.dev)
        state = (params, opt_lib.init_opt_state(params, ocfg))
        del params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, m0 = step(*state, data.batch(0))
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        state, ms, metrics, peak = self.timed_steps(
            "phase 11d gemma3-1b", step, state,
            [lambda s=s: data.batch(s) for s in range(1, LM_TRAIN_STEPS + 1)])
        n = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        mean = sum(ms) / len(ms)
        print(f"phase 11d: gemma3-1b full_config() training, AdamW, remat, {LM_TRAIN_BATCH} x "
              f"{LM_TRAIN_SEQ} tokens a step in {LM_TRAIN_ACCUM} microbatches: {mean:.3f} ms per "
              f"step (steps {', '.join(f'{t:.3f}' for t in ms)}; warm-up {warm:.3f}), "
              f"{n / mean * 1e3:.1f} tokens/s, peak {peak / 2**30:.3f} GiB; loss "
              f"{float(m0['loss']):.4f} -> {metrics[-1]['loss']:.4f}, grad_norm "
              f"{', '.join(f'{m['grad_norm']:.4f}' for m in metrics)}", flush=True)
        del state

    def lm_other(self, arch):
        """11f: one of the other four archs at its published widths
        (mixtral and arctic cut to LM_DEPTH_CUT layers): one prefill of
        LM_OTHER_SEQ tokens (mixtral twice its window) and LM_OTHER_STEPS
        greedy decode steps (mixtral through ring caches of its window,
        filled from the prefill's cache), the MoE drop rates read from
        the prefill's dispatches."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.models import moe as moe_lib
        from repro_torch.models import transformer as tfm

        full = configs.get(arch).full_config()
        cfg = dataclasses.replace(full, n_layers=LM_DEPTH_CUT.get(arch, full.n_layers))
        S = LM_OTHER_SEQ[arch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tfm.init_params(self.gen(LM_PARAM_SEED), cfg)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        toks = self.lm_tokens(cfg, (1, S), LM_DATA_SEED + 5)
        drops, apply = [], moe_lib.apply_moe

        def recording(*args, **kw):
            out, aux = apply(*args, **kw)
            drops.append(aux["moe_drop_rate"])
            return out, aux

        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            moe_lib.apply_moe = recording
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = tfm.prefill(params, toks, cfg)
                torch.cuda.synchronize()
                t_pre = time.perf_counter() - t0
            finally:
                moe_lib.apply_moe = apply
            n_moe = len(drops)
            split = cfg.window is not None
            if split:  # the prefill's last window of positions into rings
                W = cfg.window
                ring = tfm.init_split_cache(cfg, 1, S + LM_OTHER_STEPS, device=self.dev)
                slots = torch.arange(S - W, S, device=self.dev) % W
                ring["k_loc"][:, :, slots] = cache["k"][:, :, S - W:]
                ring["v_loc"][:, :, slots] = cache["v"][:, :, S - W:]
                ring["len"] = cache["len"]
                cache, step_fn = ring, tfm.decode_step_split
            else:
                pad = (0, 0, 0, 0, 0, LM_OTHER_STEPS)
                cache = {"k": torch.nn.functional.pad(cache["k"], pad),
                         "v": torch.nn.functional.pad(cache["v"], pad), "len": cache["len"]}
                step_fn = tfm.decode_step
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LM_OTHER_STEPS):
                logits, cache = step_fn(params, cache, tok, cfg)
                tok = logits.argmax(-1).to(torch.int32)
                check(bool(torch.isfinite(logits).all()), f"phase 11f: {arch} logits not finite")
            torch.cuda.synchronize()
            t_dec = (time.perf_counter() - t0) * 1e3 / LM_OTHER_STEPS
        peak = torch.cuda.max_memory_allocated()
        n_par = sum(v.numel() for v in params.values())
        drop = ""
        if n_moe:
            rates = torch.stack(drops[:n_moe]).float().cpu()
            drop = (f"; MoE ({cfg.moe.n_experts} experts, top-{cfg.moe.top_k}) drop rate over "
                    f"the prefill's {n_moe} layer(s): mean {float(rates.mean()):.4f}, max "
                    f"{float(rates.max()):.4f}")
        print(f"phase 11f: {arch} full widths, {cfg.n_layers} of {full.n_layers} layers ({n_par} "
              f"parameters, {n_par * 2 / 1e9:.3f} GB bf16, drawn in {t_init:.3f} s): prefill 1 x {S} "
              f"tokens {t_pre:.3f} s ({S / t_pre:.1f} tokens/s); {LM_OTHER_STEPS} decode steps "
              f"through {'ring caches of its ' + str(cfg.window) + '-token window' if split else 'the dense cache'} "
              f"{t_dec:.3f} ms per step; peak {peak / 2**30:.3f} GiB{drop}", flush=True)
        del params, cache

    def lm_entry_points(self):
        """11g: the launchers' ``main`` on the card, as ``python -m`` runs
        them: ``serve --mode lm`` for each LM arch, ``train --arch
        gemma3-1b`` at the smoke config and at ``--full-config``, and
        ``examples/train_lm_torch.py --tiny``, whose loss must fall."""
        import importlib.util

        from repro_torch.launch import serve, train

        for arch in LM_ARCHS:
            rec = serve.main(["--mode", "lm", "--arch", arch])
            check(tuple(rec["tokens"].shape) == (4, 16), f"phase 11g: serve {arch}")
        for argv in (["--steps", "3"], ["--full-config", "--steps", "2"]):
            rec = train.main(["--arch", "gemma3-1b", *argv])
            check(all(math.isfinite(float(v)) for v in rec["metrics"].values()),
                  f"phase 11g: train {argv}: {rec['metrics']}")
        spec = importlib.util.spec_from_file_location("train_lm_torch",
                                                      ROOT / "examples" / "train_lm_torch.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        rec = example.main(["--tiny", "--steps", str(LM_EXAMPLE_STEPS),
                            "--ckpt", str(ROOT / "build" / "lm_ckpt")])
        print(f"phase 11g: serve --mode lm for {len(LM_ARCHS)} archs, train --arch gemma3-1b "
              f"(smoke, then --full-config), examples/train_lm_torch.py --tiny: loss "
              f"{rec['first']:.4f} -> {rec['last']:.4f} in {LM_EXAMPLE_STEPS} steps, "
              f"{rec['seconds']:.3f} s", flush=True)

    # --------------------------------------------------------------- phase 12
    def phase_examples(self):
        """The three core examples at the reference's sizes, in-process, each
        with its launch counts zeroed just before it and every fp32 kernel
        required to launch; no plain version of a kernel on a CUDA tensor
        meanwhile.  Each kernel against its plain version on arguments
        captured from each example (the seed gather, an expansion and the
        intra-wave tile; for the parallel build also the first merge's
        cross-search expansion and second-hop gather), within the real-valued
        tolerance.  Then a registered metric refused on CUDA tensors before
        any launch."""
        import importlib.util

        from repro_torch.kernels import expand, ref

        plain_on_card = []

        def watched(fn, name):
            def wrapper(*args, **kw):
                if any(isinstance(a, self.torch.Tensor) and a.is_cuda for a in args):
                    plain_on_card.append(name)
                return fn(*args, **kw)
            return wrapper

        plains = ((ref, "gather_distance"), (ref, "pairwise_distance"),
                  (expand, "expand_reference"))
        saved = [getattr(mod, name) for mod, name in plains]
        captured = {}
        for mod, name in plains:
            setattr(mod, name, watched(getattr(mod, name), name))
        try:
            for name, wave in EXAMPLE_WAVES.items():
                spec = importlib.util.spec_from_file_location(
                    f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
                example = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(example)
                shapes = {"seed_gather": ("gather_distance", wave),
                          "expand": ("expand_step", wave),
                          "tile": ("pairwise_distance", wave)}
                if name == "parallel_build":
                    # the first merge: a cross search's chunk of lanes, and
                    # the second-hop proposals of one shard's rows
                    shapes.update(merge_expand=("expand_step", MERGE_SEARCH_CHUNK, 1),
                                  merge_gather=("gather_distance", example.N // example.SHARDS, 1))
                captured[name] = {}
                self.torch.cuda.synchronize()
                self.ops.reset_launch_counts()
                t0 = time.perf_counter()
                with self.capture(shapes, captured[name]):
                    try:
                        rec = example.main([])
                    except AssertionError as exc:
                        raise PhaseError(f"phase 12: examples/{name}_torch.py: assert failed: "
                                         f"{exc!r}") from exc
                self.torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                check(rec["device"].startswith("cuda"), f"phase 12: {name} ran on {rec['device']}")
                self.path_counts(f"example_{name}", f"examples/{name}_torch.py")
                self.example_line(name, rec, seconds)
                for label in shapes:
                    check(label in captured[name],
                          f"phase 12: {name}: no call of {label}'s shape was seen")
        finally:
            for (mod, name), fn in zip(plains, saved):
                setattr(mod, name, fn)
        check(not plain_on_card,
              f"phase 12: plain versions ran on CUDA tensors: {sorted(set(plain_on_card))}")
        for name, calls in captured.items():
            errs = {label: self.hold_captured(a, f"phase 12 {name} {label}")
                    for label, a in calls.items()}
            print(f"phase 12: examples/{name}_torch.py: each kernel within rtol={RTOL} "
                  f"atol={ATOL} of its plain version on the example's own arguments, max abs "
                  f"err {json.dumps(errs)}", flush=True)
        self.registered_metric_refused()

    def hold_captured(self, a, what):
        """One captured ``ops`` call (a gather, an expansion or a pairwise
        tile on real-valued rows) against its plain version on the same
        arguments: the largest absolute error."""
        from repro_torch.kernels import ref

        if "cands" in a:
            args = [a[k] for k in ("q", "x", "cands", "beam_ids", "beam_dist", "beam_exp",
                                   "vis_ids", "vis_dist")]
            kw = dict(metric=a["metric"], sq_norms=a["sq_norms"])
            got = self.ops.expand_step(*args[:6], args[6].clone(), args[7].clone(),
                                       hash_probes=a["hash_probes"], **kw)
            want = self.plain_expand(*args[:6], args[6].clone(), args[7].clone(),
                                     probes=a["hash_probes"], **kw)
            B, C = args[2].shape
            return self.compare_expand("fused_expand", got, want, f"{what} B={B} C={C}",
                                       exact=False, beam_ids=False)
        if "idx" in a:
            q, x, idx, metric = a["q"], a["x"], a["idx"], a["metric"]
            return self.compare("gather_distance",
                                self.ops.gather_distance(q, x, idx, metric, sq_norms=a["sq_norms"]),
                                ref.gather_distance(q, x, idx, metric, sq_norms=a["sq_norms"]),
                                exact=False, what=f"{what} B={q.shape[0]} C={idx.shape[1]}")
        q, x, metric, xn = a["q"], a["x"], a["metric"], a["x_sq_norms"]
        return self.compare("pairwise_distance",
                            self.ops.pairwise_distance(q, x, metric, x_sq_norms=xn),
                            ref.pairwise_distance(q, x, metric, x_sq_norms=xn), exact=False,
                            what=f"{what} m={q.shape[0]} n={x.shape[0]}")

    def example_line(self, name, rec, seconds):
        scalars = {k: v for k, v in rec.items() if isinstance(v, (int, float))}
        print(f"phase 12: examples/{name}_torch.py in {seconds:.3f} s: {json.dumps(scalars)}",
              flush=True)

    def registered_metric_refused(self):
        """A metric registered for the phase (L-infinity) on CUDA tensors:
        each ``ops`` entry raises ``KeyError`` naming it, and nothing
        launches."""
        torch = self.torch
        from repro_torch.core import metrics

        @metrics.register("linf_probe")
        def _linf(q, x):
            return (q[..., :, None, :] - x[..., None, :, :]).abs().amax(-1)

        try:
            x, q = self.data(64, 16, 1), self.data(4, 16, 2)
            idx = torch.randint(0, 64, (4, 12), generator=self.gen(3), device=self.dev,
                                dtype=torch.int32)
            B, e, H = 4, 8, 64
            beam = (torch.full((B, e), -1, dtype=torch.int32, device=self.dev),
                    torch.full((B, e), float("inf"), device=self.dev),
                    torch.zeros((B, e), dtype=torch.bool, device=self.dev),
                    torch.full((B, H), -1, dtype=torch.int32, device=self.dev),
                    torch.full((B, H), float("inf"), device=self.dev))
            self.ops.reset_launch_counts()
            calls = {"pairwise_distance": lambda: self.ops.pairwise_distance(q, x, "linf_probe"),
                     "gather_distance": lambda: self.ops.gather_distance(q, x, idx, "linf_probe"),
                     "expand_step": lambda: self.ops.expand_step(q, x, idx, *beam,
                                                                 metric="linf_probe")}
            for name, call in calls.items():
                try:
                    call()
                except KeyError as exc:
                    check("linf_probe" in str(exc), f"phase 12: {name}'s refusal: {exc}")
                else:
                    raise PhaseError(f"phase 12: ops.{name} ran a registered metric on the card")
            counts = self.ops.launch_counts()
            check(not any(counts.values()), f"phase 12: launches while refusing: {counts}")
            print("phase 12: a registered metric on CUDA tensors is refused by "
                  f"{', '.join('ops.' + n for n in calls)} before any launch", flush=True)
        finally:
            del metrics._REGISTRY["linf_probe"]

    # --------------------------------------------------------------- phase 13
    def phase_dryrun(self):
        """The dry run's plans held against the card: (a) knn-lgd
        search_4k's step at phase 4's graph and 64 queries on a world of 1;
        (b) gemma3-1b decode_32k at batch 2 on a (1, 1) mesh."""
        torch = self.torch
        from repro_torch.configs import cells, knn_lgd
        from repro_torch.core import search
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.launch import roofline

        def planned(arch, shape, dims, names, opts):
            mesh_lib.fake_world(1)
            try:
                mesh = torch.distributed.device_mesh.init_device_mesh(
                    "cpu", dims, mesh_dim_names=names)
                cell = cells.plan(arch, shape, mesh, opts)
                t0 = time.perf_counter()
                low = cells.lower(cell)
                return cell, low, roofline.analyze(low, mesh), time.perf_counter() - t0
            finally:
                from repro_torch.models import sharding

                sharding.set_mesh(None)
                mesh_lib.close_group()

        def measured_peak(step, arg_bytes):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() - before + arg_bytes
            del out
            return peak, ms

        # (a) the k-NN search step: planned, then run on the card
        B = 64
        g, x = self.g32, self.xf
        cell, low, rec, t_plan = planned("knn-lgd", "search_4k", (1,), ("data",),
                                         {"n_total": x.shape[0], "batch": B})
        scfg = dataclasses.replace(knn_lgd.full_config().search_config(), seed_mode="random")
        q = self.serve_queries[:B].contiguous()
        seeds = search.random_seeds(B, scfg.n_seeds, g.n_valid, self.gen(SEARCH_SEED), self.dev)
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in (*[f for f in g if isinstance(f, torch.Tensor)], x, q, seeds))
        group = mesh_lib.init_group(0, 1, "gloo", mesh_lib.free_port())
        try:
            self.ops.reset_launch_counts()
            peak, ms = measured_peak(
                lambda: cells.knn_search_step(g, x, q, seeds, scfg, group), arg_bytes)
            counts = self.ops.launch_counts()
        finally:
            mesh_lib.close_group()
        launched = {f"repro_torch::{k}": v for k, v in counts.items() if v}
        t_bound = max(rec["t_memory_s"], rec["t_compute_s"])
        print(f"phase 13a: knn-lgd search_4k step (1 iteration) at n={x.shape[0]} B={B}, planned in "
              f"{t_plan:.3f} s: planned peak {low.peak_bytes / 2**30:.4f} GiB (arguments "
              f"{low.arg_bytes / 2**30:.4f} GiB) vs measured {peak / 2**30:.4f} GiB, ratio "
              f"{low.peak_bytes / peak:.4f}; planned kernel calls {json.dumps(low.kernels)} vs "
              f"launched {json.dumps(launched)}; planned {rec['hlo_gflops']:.6f} GFLOP "
              f"({rec['gflops_fp32']:.6f} fp32) and {rec['hlo_gbytes']:.6f} GB, bound "
              f"{t_bound * 1e3:.6f} ms vs the step's {ms:.3f} ms", flush=True)
        check(low.kernels == launched, f"phase 13a: planned kernel calls {low.kernels} != "
              f"launched {launched}")
        check(abs(low.peak_bytes / peak - 1.0) <= 0.25,
              f"phase 13a: planned peak {low.peak_bytes} is more than 25% from measured {peak}")
        self.dryrun_rec = {"knn_planned_peak": low.peak_bytes, "knn_measured_peak": peak}

        # (b) gemma3-1b decode_32k at batch 2: planned, then one step on the card
        from repro_torch.configs import gemma3_1b
        from repro_torch.models import transformer

        LB, S = 2, gemma3_1b.SHAPES["decode_32k"]["seq"]
        _, low_lm, _, t_plan = planned("gemma3-1b", "decode_32k", (1, 1), ("data", "model"),
                                       {"batch": LB})
        cfg = gemma3_1b.full_config()
        params = transformer.init_params(self.gen(LM_PARAM_SEED), cfg)
        cache = transformer.init_cache(cfg, LB, S, device=self.dev)
        cache["len"].fill_(S // 2)
        tokens = torch.randint(0, cfg.vocab, (LB,), generator=self.gen(LM_DATA_SEED),
                               device=self.dev, dtype=torch.int32)
        lm_args = sum(t.numel() * t.element_size()
                      for t in (*params.values(), *cache.values(), tokens))
        with torch.no_grad():
            peak_lm, ms_lm = measured_peak(
                lambda: transformer.decode_step(params, cache, tokens, cfg)[0], lm_args)
        print(f"phase 13b: gemma3-1b decode_32k step at batch {LB} (dense cache of {S}), planned "
              f"in {t_plan:.3f} s: planned peak {low_lm.peak_bytes / 2**30:.4f} GiB (arguments "
              f"{low_lm.arg_bytes / 2**30:.4f} GiB) vs measured {peak_lm / 2**30:.4f} GiB, ratio "
              f"{low_lm.peak_bytes / peak_lm:.4f}; the step took {ms_lm:.3f} ms", flush=True)
        self.dryrun_rec.update(lm_planned_peak=low_lm.peak_bytes, lm_measured_peak=peak_lm)
        del params, cache
        torch.cuda.empty_cache()

    def kernel_records(self):
        out = []
        for name, (source, replaces) in KERNELS.items():
            r = self.rec[name]
            rec = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": self.launches[name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "cdist_ms": r.get("cdist_ms"), "shape": r["shape"],
            }
            # the gathers: the empty launch and index_select at the main
            # shape, and the large-C shape
            rec.update({k: v for k, v in r.items()
                        if k in ("warm_ms", "floor_ms", "index_select_ms", "simt_ms",
                                 "widened_mm_ms", "max_rel_fp32", "first_ms")
                        or k.startswith(("large_c_", "serve_", "merge_", "router_", "mind_",
                                         "atom_", "tile1024_", "seed_", "audit_"))})
            if name in self.serve_launches:
                rec["serve_launches"] = self.serve_launches[name]
            for path, counts in self.path_launches.items():
                if name in FP32_KERNELS:
                    rec[f"{path}_launches"] = counts[name]
            out.append(rec)
        return out


if __name__ == "__main__":
    sys.exit(main())
