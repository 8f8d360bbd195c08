#!/usr/bin/env python3
"""Smoke test of pgvectorscale_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each reported on a timestamped, flushed line:

0. device: card name and count, torch and CUDA versions, power limit,
   maximum SM clock (the operations bounds use it).
1. kernel build: compiles every CUDA kernel from its source into a fresh
   directory (nvcc, plain C interface, ctypes), one nvcc per source, all
   started together, and prints each kernel's ``-Xptxas -v`` lines
   (registers, shared memory, stack and spill bytes).
2. kernel vs plain: each kernel equals its plain PyTorch version exactly
   at the main paths' shapes and the TPU kernel tests' shapes (the edge
   gather also at odd W and W % 4 != 0, over random graphs with 23% of
   the slots invalid, as the built graph has them); times of both beside
   the least time the card could take (the larger of the bytes over the
   memory rate and the operations on the quicker of the CUDA cores' popc
   pipe and the tensor cores' 1-bit path) and, for the Hamming matrix, two
   popcount-dot yardsticks (an fp16 matmul, and cuBLASLt's int8 product
   through ``torch._int_mm`` on bits expanded beforehand; the faster is
   ``library_ms``), the int8 product alone beside them.  The Hamming
   matrix is also checked on constant codes and misaligned tables; the
   edge gather also at the code widths of 2,000-16,000-dim indexes (W =
   63, 96, 125, 250, 500), aligned and 4 bytes off a 16-byte boundary.
   Then both kernels at the 4- and 8-bit tiers' code widths
   (TIER_EDGE_CASES: W = 16 and 32 over 1M slots, W = 192 over 100k,
   aligned and offset; TIER_MATRIX_CASES: W = 16, 32, 25 and 192), each
   equal to its plain version and timed beside its bound.  The two loop
   kernels: beam_search bit-equal to ``beam_search_plain`` on every output
   at BEAM_CASES (the search shapes at E = 4 and 2, the "scored" window
   of 1,510, the "beam" strategy's L = 2,010 in shared memory and in the
   scratch buffer, 1- and 2-label filtered searches, a build wave with its
   history, W = 16, 192 and 500, every code word equal in a narrow and a
   wide row, 64 and 128 slots, E*R = 520, over random graphs), prune_scan
   bit-equal to its plain version at PRUNE_CASES (B = 4,096, C = 166 and
   332, unlabeled and labeled); each timed (kernel, plain, one query or
   row alone) beside its bound.
3. build: a 100,000 x 768 SBQ index (cosine, 2 bits/dim, R=50, L=100,
   build_distance "exact-prune") of the seeded "cohere" corpus, through
   ``DiskannIndex.build``; checks full reachability, no orphans, degree
   <= r_max, and prints ``build_stats`` (fails without a wave).
4. search: 1,024 queries at k=10, L=100, rescore 50 and 300 through
   ``DiskannIndex.search``; QPS, recall@10 against ``ExactIndex``
   (fails below 0.80 at rescore 300); the build must launch beam_search
   and prune_scan, the searches beam_search; one more search inside
   ``stats.profiler_trace``, whose trace must hold one beam_search
   kernel for each launch.
5. loops agreement (outside the path): on phase 3's index, a search at
   rescore 300 and a searched wave of 4,096 rows through the two loop
   kernels and through their plain versions on the card: the search's
   ids, distances and SearchResult, and the wave's adjacency, bit-equal.
   agreement: the beam search on the card equals the same beam search
   run by the plain versions on the CPU, for 64 queries; so do
   ``last_search_stats`` of ``DiskannIndex.search`` on those queries, and
   ``estimate_query_cost`` answers "measured".
6. storage build and search: the same corpus and queries with
   build_distance "storage" (the reference's build: Hamming everywhere);
   the same graph checks and recall floor, and the Hamming matrix,
   beam_search and prune_scan launched.
5b. windows, on the exact-prune index of phase 3: the "expand", "beam" and
   "scored" rescore windows at L=100, rescore 300 (recall floor, valid
   results, no id twice in a row), then the JAX package's ``bench.py``
   wide points, L=200, rescore 1,500, E=2, for all three (recall, QPS
   best of 3, peak device memory); beam_search must launch in every
   search.
6. storage build and search: the same corpus and queries with
   build_distance "storage" (the reference's build: Hamming everywhere);
   the same graph checks and recall floor, and the Hamming matrix,
   beam_search and prune_scan launched.
7. life cycle, 768 wide, storage build: ``build`` on 2,048 rows, 8
   ``add`` batches of 4,096 (the first one's seed wave launches the
   Hamming matrix), ``delete`` of 10%, an ``add`` of 2,048 that lands on
   tombstones, a search that returns no deleted row and holds the recall
   floor over the live rows, ``save``/``load`` with bit-equal search
   results, and ``compact`` (count == live rows, all reachable), with
   the Hamming matrix, beam_search and prune_scan launched.  The
   reuse add must leave a reader's ``arrays`` (checksum of every tensor)
   and ``external_ids`` as they were and publish new arrays.
8. refine: the exact-prune build of phase 3 with ``refine_passes=1``
   (seconds split into ingest / waves / finalize+refine, beam_search
   launched inside the refinement pass), the graph checks, and the search
   of phase 4 beside the unrefined build's recall.
9. exact: an SBQ build with build_distance "exact" (full-precision
   traversal) of the first 95,904 rows, the search of phase 4 over them,
   then one ``add`` of the last 4,096 rows and the graph checks; the
   build and the add launch only prune_scan, the search beam_search.
10. plain: a plain-storage cosine build of the corpus (full-precision
   traversal, no codes) and a search at L=100 (no rescore: the traversal
   distances are exact), recall against ``ExactIndex``; no Hamming or
   beam-search kernel launches on this path, only prune_scan.  Then, outside the path, the device time of
   full-precision traversal's gather-dot at a build and a search step.
11. filtered: the JAX suite's filtered deployment (benchmarks/suite.py
   ``run_filtered``: 100 labels with popularity 1/rank, 1-2 a row, bf16
   vectors, 2 bits/dim) on the corpus, built exact-prune (R=50, L=100):
   the graph checks, every label's start node on a row with its label;
   1,024 one-label and 1,024 two-label queries at L=100, rescore 300,
   E=4 and at the suite's first point, L=150, rescore 300, E=2 (recall@10
   against a filtered exact top-10 computed on the card, floor 0.50 at
   the suite's point; QPS best of 3; every result carries a query label,
   no id twice; beam_search launched in the build and every search); 64
   queries on each of the 5 rarest labels get 10 ids carrying it, and
   each label's reach (its rows a filtered search can reach from its
   start nodes, a host BFS) stays at or above its measured floor; label
   98, whose rows label-aware pruning leaves unlinked (in the JAX package
   as in the port), gets min(10, reach) ids; the filtered beam search on
   the card equals the CPU's plain path for 32 one-label and 32
   two-label queries.
12. filtered life cycle: phase 7 on a labeled bf16 storage index (labeled
   adds, the first one's seed wave through the Hamming matrix; a reuse
   add with new labels leaves no label start entry on a row without its
   label; a filtered search returns no deleted row and holds every
   filter; save/load bit-equal; compact keeps labels and external ids).
13. int8 scale: the JAX repo's capacity deployment (benchmarks/scale.py:
   "cohere" 768 dims, seed 42, cosine, SBQ 1 bit/dim, int8 rows, R=50,
   L=100, 1,024 queries), cut to SCALE_N = 1,000,000 rows (the script's
   default is 5,000,000) and built with the library's max_wave of 4,096
   (the script's 2,048 was chosen for a 16 GB chip).  The host corpus is
   3.07 GB of float32, so ``build`` must take the chunked ingest: 6 chunks
   of 175,104 rows (fails if the one-shot ingest runs).  Seconds for
   ingest / waves / finalize, the scatter BFS alone, the graph checks; the
   chunked quantizer statistics against one ``sbq.train`` pass over the
   whole corpus on the card (mean within 1e-4 of its largest magnitude,
   M2 within 1e-4 relative per dimension) and the share of code words
   equal under the two; then scale.py's five (L, rescore, E, strategy,
   visit_factor) points: recall@10 against the exact top-10 over the
   float32 corpus (computed on the card in query chunks), QPS best of 3,
   peak device memory, beam_search launches (> 0 each); the floor
   SCALE_MIN_RECALL holds at the widest "expand" point.  Then, outside the
   path, the rescore (``index._exact_batch_distances``) at
   benchmarks/kernels.py's "rescore-tiers" shape (n = 1M, d = 768,
   q = 1,024, m = 310 random ids, L2, standard-normal rows) for f32, bf16
   and int8 tables, CUDA events behind the device sleep, beside each
   one's byte bound; the int8 : f32 ratio.
14. stream, on phase 13's index: ``WHERE flag ORDER BY emb <=> q LIMIT 10``
   post-filtered through ``search_iter`` (reference query defaults,
   L=100, rescore 50), ``flag`` a seeded column true on 1% of rows; 8
   queries each pull until 10 rows pass.  Hard checks: no id twice in a
   stream, no deleted id, each yielded distance within 1e-5 of the int8
   exact rescore of its id.  Recall@10 against the filtered exact top-10,
   rows pulled, visits (``total_visits``), microseconds per visit and
   edge_gather launches per visit.  Then ``iter_step`` on the card emits
   the CPU plain path's ids over 3 refills for 4 queries (a CPU copy of
   the index), and a full-table scan of a 4,096-row int8 index with 10%
   deleted yields every live row once in at most
   ``count`` visits.
15. int8 life cycle: phase 7 with ``vector_dtype="int8"`` (the reader's
   arrays it checks include ``vec_scales``).
16. durable life cycle: a child process on the card (loading phase 1's
   kernels) builds phase 7's index, calls ``enable_durability``, runs
   phase 7's adds, delete and reuse add (10 journal records) and kills
   itself with SIGKILL; ``DiskannIndex.load`` replays the journal (the
   Hamming matrix, beam_search and prune_scan launched) to phase 7's index after its reuse add: count, live
   rows, external ids, a checksum of every tensor and the searches at
   rescore 50 and 300, bit-equal.  Then ``enable_durability`` with
   ``auto_checkpoint_every`` 8,192 and two adds of 4,096: the journal is
   empty after the second, and ``load`` gives the same live rows.
   Seconds of the base checkpoint, each append (MB/s), the replay and the
   checkpoints.
17. host graph and tools: on phase 13's 1M adjacency (copied to the host
   before that index is freed) the native BFS (``native/``, g++) equals
   the device BFS; with the in-edges of 1,000 seeded rows cleared,
   ``repair_orphans_host`` leaves no orphan within the degree bound.
   The CLI on the card through ``cli.main`` in this process: ``bench``
   at its defaults (100k cohere, 1,000 queries; recall at L=200 at least
   0.80), then build / info / search / add / delete / compact / info on
   20,000 rows (``info``: all reachable, no orphans); ``search`` runs as a
   ``python -m`` subprocess, whose ids equal the library's on the same
   checkpoint.  The debug helpers on phase 3's index (run
   before it is freed): all reachable, no orphans.
18. high dim: a 16,000-dim SBQ index (cosine, R=16, L=32, 500-word codes)
   of 8,192 low-rank rows, max_wave 1,024 (the re-measure's rows: 4.19
   GB); recall@10 against ``ExactIndex`` at the JAX test's L=50, rescore
   100 and at L=100, rescore 200 (floor 0.9 there), beam_search launched
   at W=500, the peak device memory.
19. sharded: ``ShardedDiskannIndex`` on a mesh of SHARDS = 4 positions
   (``parallel.mesh.make_mesh``: one shard a card on a machine with four
   cards or more, else all four on cuda:0; the line says how many
   distinct cards).  Scale: phase 13's config over the first SHARD_N =
   500,000 rows of its corpus, row-sharded (125,000 rows a shard),
   seconds (train + ingest / waves / finalize), peak device memory of
   each card, every shard's graph checks and every shard tensor on its
   position's device; scale.py's first two "expand" points, recall@10 of
   the external ids (against the exact top-10 over those rows) at no
   less than phase 13's over 1M rows at the same point minus 0.05, QPS
   best of 3, beam_search launched.  Life cycle:
   phase 7's storage config and sizes on the mesh (the shards' seed waves
   launch the Hamming matrix), delete through ``delete_external``, the
   reuse add leaving a reader's shards as they were, searches with no
   deleted row and the recall floor, a 50-row ``search_iter`` stream,
   save -> load bit-equal, compact keeping the live external ids,
   ``create_index`` on the mesh, and ``enable_durability`` over two adds
   and a delete replayed by ``load`` bit-equal; the Hamming matrix,
   beam_search and prune_scan launched.
   Processes: on a machine with two cards or more, two ``nccl`` processes
   (one card each, the PGVS_TPU_* variables) build and search their
   shards of the life-cycle rows and must equal the one-process index;
   with one card it is not run.
20. sift 4-bit 1M: the JAX repo's SIFT-1M deployment at 4 bits
   (benchmarks/suite.py ``run_sift1m``, SUITE_BITS=4, SUITE_REFINE=1): the
   seeded "sift" corpus, 1,000,000 x 128 and 2,048 queries, L2, L=100, 4
   bits a dimension (W = 16), ``refine_passes=1``, library defaults
   otherwise; build seconds (ingest / waves / finalize + refine), peak
   device memory, launches (beam_search and prune_scan in the build,
   beam_search in the refinement), the graph checks; the exact top-10 through
   ``ExactIndex``; SIFT_POINTS of the suite's sweep, recall@10 against it
   (each at least the JAX package's record in results/sift1m.jsonl less
   0.03), QPS best of 3, peak memory, launches.  Then, outside the path,
   the strict-rank SBQ ceiling (suite.py ``_sbq_ceiling``) at rescore 50,
   300, 600 and 1,500 through the Hamming-matrix kernel in chunks of 256
   queries: within 0.003 of the record, and a 2-bit encode of the same
   corpus beside it.
21. 8-bit storage 100k: phase 6's corpus, queries and storage build at 8
   bits a dimension (W = 192, 6,144 code bits: the storage prune's
   wide-code blocks, the seed wave's Hamming matrix at W = 192); build
   seconds, peak device memory, the Hamming matrix, beam_search and
   prune_scan launched, the graph checks;
   phase 4's searches (floor 0.80 at rescore 300) beside phase 6's 2-bit
   recall.

Phases 20-21 run after phase 18, and phase 19 last.  ``python3
chip_smoke.py --only-sharded`` runs phases 0-2, 13 and 19 alone (for a
machine with several cards); ``--only-tiers`` runs phases 0-2, 20 and 21.
Each path (phases 3-4, 5b, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
18, 20, 21, and 19's scale and life cycle) is
driven with the kernels' launch counts set to 0 just before it and read
just after; the kernels line sums them.  The peak device memory
(``torch.cuda.max_memory_allocated``) is reset at the start of each
build, each search, each add and the life cycle, and read at its end; the
summary line carries it.
The run must end within BUDGET_S seconds; each phase has a deadline and
the builds check it after every wave.  Any failed check exits non-zero.
Without a CUDA device, or without the package beside this script, it
exits non-zero and prints no result.  The last lines are the kernels'
JSON record, the card's name and power limit, and the result line.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
BUDGET_S = 600
# Seconds since start by which each phase must have ended.
DEADLINES = {
    "device": 60,
    "kernel build": 130,
    "kernel vs plain": 175,
    "build": 195,
    "search": 203,
    "loops agreement": 208,
    "agreement": 208,
    "windows": 220,
    "storage build": 235,
    "storage search": 241,
    "life cycle": 257,
    "refine build": 275,
    "refine search": 281,
    "exact build": 293,
    "exact search": 299,
    "exact add": 305,
    "plain build": 317,
    "plain search": 323,
    "filtered build": 325,
    "filtered search": 335,
    "filtered agreement": 340,
    "filtered life cycle": 355,
    "int8 build": 360,
    "int8 search": 375,
    "rescore tiers": 380,
    "stream": 405,
    "int8 life cycle": 415,
    "durable life cycle": 445,
    "host graph": 450,
    "cli": 500,
    "high dim": 505,
    "sift build": 530,
    "sift search": 555,
    "8-bit build": 570,
    "8-bit search": 575,
    "sharded build": 590,
    "sharded search": 594,
    "sharded life cycle": 598,
    "sharded processes": 599,
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# Device sleep in front of each timed run of calls (cuda_time_ms): 20 ms at
# 1.98 GHz, four times longer on each retry when the host was slower.
QUEUE_SLEEP_CYCLES = 39_600_000
QUEUE_SLEEP_TRIES = 4
# Per-SM instruction rates per clock, compute capability 9.0 (CUDA C Programming
# Guide, arithmetic instruction throughput): 32-bit integer add and
# logical operations, and population count.  They run in separate pipes,
# so on the CUDA cores the slower of the two bounds.
INT32_OPS_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
# Bit pairs a second of the tensor cores' 1-bit path (mma.sync m16n8k256
# .b1 .and.popc), the quickest way the card has to the dot of
# pop(a) + pop(b) - 2 * dot(a, b), the Hamming distance over 0/1 bits.
# The data sheet gives no 1-bit rate: this is the best that
# microbench/mma_rates.cu measured on an NVIDIA H100 80GB HBM3 at 700 W
# (the int8 path there: 0.66e15 bit pairs a second with mma.sync, and the
# data sheet's dense int8 wgmma peak of 1,979 TOP/s is 0.99e15).
B1_TENSOR_BIT_PAIRS_PER_S = 5.113304e15
N, NQ, DIM, SEED = 100_000, 1024, 768, 0
# Share of INVALID_ID adjacency slots in phase 2's random graphs: the
# built 100k graph's mean degree is 49.99 of 65 slots.
INVALID_EDGE_SHARE = 0.23
MIN_RECALL = 0.80
# Life cycle: the first build, the add batches, the delete share, the
# tombstone-reusing add.
LC_BUILD, LC_BATCH, LC_BATCHES, LC_DELETE, LC_REUSE = 2048, 4096, 8, 0.10, 2048
# The "exact" path builds on all but the last EXACT_ADD rows and adds them.
EXACT_ADD = 4096
# Window phase: (L, rescore, E) points; the wide one is bench.py's.
WINDOW_POINTS = ((100, 300, 4), (200, 1500, 2))
WINDOW_STRATEGIES = ("expand", "beam", "scored")
# Phase 11, the JAX suite's filtered deployment (benchmarks/suite.py
# run_filtered): label count and the seed of the label draws; search points
# (L, rescore, E), phase 4's and then the suite's first.
FILTER_LABELS, FILTER_SEED = 100, 7
FILTER_POINTS = ((100, 300, 4), (150, 300, 2))
# Floor of filtered recall@10 at the suite's point, for each query set: it
# catches a broken filter or start lookup, not a weak graph.
MIN_FILTERED_RECALL = 0.50
# The labels that the fewest rows carry, and the queries filtered on each:
# each query must get 10 rows carrying its label.  Reach (label_reach) is
# the label's rows that a filtered search can reach from its start nodes;
# each rare label's reach must stay at or above its floor, the value
# measured on an H100 for this seed.  Label 98 has reach 1 (label-aware
# pruning leaves its rows unlinked from its start node, in the JAX package
# as in the port), so its queries must get min(10, reach) rows.
RARE_LABELS, RARE_QUERIES = 5, 64
RARE_REACH_FLOOR = {96: 209, 99: 271, 95: 269, 94: 277, 98: 1}
KERNELS = ("edge_gather", "hamming_matrix", "beam_search", "prune_scan")
# The kernels every build path with searched waves launches: the beam
# search (each searched wave) and the prune (every wave).  Since the beam
# loop is a kernel, edge_gather serves only the "expand" rescore window and
# the streaming iterator.
BUILD_KERNELS = ("beam_search", "prune_scan")
# The life cycles' kernels: seed waves through the Hamming matrix, then the
# build kernels.
LIFE_KERNELS = ("hamming_matrix",) + BUILD_KERNELS
# Phase 13, benchmarks/scale.py's deployment: rows (cut from 5,000,000),
# seed, and the (L, rescore, E, strategy, visit_factor) points; the recall
# floor holds at the widest "expand" point.  Ground truth runs in chunks
# of GT_CHUNK queries.
SCALE_N, SCALE_SEED = 1_000_000, 42
SCALE_POINTS = ((100, 150, 4, "expand", 1.0), (150, 300, 2, "expand", 1.0),
                (150, 600, 2, "expand", 2.0), (300, 1500, 2, "expand", 2.0),
                (300, 1500, 2, "beam", 2.0))
SCALE_MIN_RECALL = 0.80
GT_CHUNK = 128
# Tolerances of the chunked quantizer statistics against one pass.
STATS_RTOL = 1e-4
# benchmarks/kernels.py "rescore-tiers": candidate ids a query.
TIER_M = 310
# Phase 14: queries streamed, rows each must find, the flag column's share
# and seed; the agreement's queries and refills; the full scan's rows and
# deleted share.
STREAM_QUERIES, STREAM_K, FLAG_SHARE, FLAG_SEED = 8, 10, 0.01, 13
AGREE_QUERIES, AGREE_REFILLS = 4, 3
SCAN_N, SCAN_DELETE = 4096, 0.10
# Phase 16: the second journal's auto-checkpoint bound (rows), reached by
# its second add of LC_BATCH rows.
DUR_AUTO_EVERY = 8192
# Phase 17: rows whose in-edges are cleared on the 1M adjacency; the CLI's
# index rows, rows added and external ids deleted.
ORPHANS = 1000
CLI_N, CLI_ADD, CLI_DELETE = 20_000, 1000, 10
# Phase 18: the 16,000-dim index (test_highdim.py's settings), its rows,
# queries and waves (the re-measure gathers max_wave x C x d x 4 B of
# rows: 4.19 GB at 1,024, 16.8 GB at the library's 4,096), the recall
# floor of the JAX test, and the (L, rescore) points searched: the JAX
# test's, then twice as wide.  The floor holds at the last: the JAX test
# searches 128 rows with L=50, a beam of 39% of them, and no beam that
# covers 8,192 rows alike is a query point (tests/test_torch_highdim.py
# holds the port's 16,000-dim graph and ids equal to the JAX package's).
HD_N, HD_DIM, HD_QUERIES, HD_MAX_WAVE, HD_MIN_RECALL = 8192, 16_000, 256, 1024, 0.9
HD_POINTS = ((50, 100), (100, 200))
# Phase 19: the mesh's positions (one shard a card on a machine with
# SHARDS cards or more, else all on cuda:0), scale.py's first two "expand"
# points, the recall margin against phase 13's one-device index
# (tests/test_sharded.py's), and the rows the life cycle's stream pulls.
# The 1M build is cut to its first SHARD_N rows (125,000 a shard) for the
# run's budget: their floor is still phase 13's recall over 1M rows.
SHARDS, SHARD_N = 4, 500_000
SHARD_POINTS = SCALE_POINTS[:2]
SHARD_RECALL_MARGIN = 0.05
SHARD_STREAM = 50
# Phase 20, the JAX repo's SIFT-1M deployment at 4 bits (benchmarks/suite.py
# run_sift1m with SUITE_BITS=4, SUITE_REFINE=1): rows, queries, seed, bits
# and refinement passes; the rescores of the strict-rank SBQ ceiling,
# computed in chunks of CEILING_CHUNK queries, and the JAX package's
# ceiling there (results/sift1m.jsonl), which the port's must equal within
# CEILING_TOL; the sweep's (L, rescore, E, strategy, visit_factor) points
# searched, each with the record's recall@10, which the port's must reach
# less SIFT_RECALL_MARGIN.
SIFT_N, SIFT_NQ, SIFT_SEED, SIFT_BITS, SIFT_REFINE = 1_000_000, 2048, 42, 4, 1
CEILING_RECORD = {50: 0.8401, 300: 0.9777, 600: 0.9924, 1500: 0.9984}
CEILING_TOL, CEILING_CHUNK = 0.003, 256
SIFT_POINTS = {
    (100, 50, 4, "expand", 1.0): 0.8131,
    (100, 150, 4, "expand", 1.0): 0.9236,
    (150, 300, 2, "expand", 1.0): 0.9657,
    (150, 600, 2, "expand", 2.0): 0.9766,
    (300, 1500, 2, "expand", 1.0): 0.9906,
    (200, 1500, 2, "scored", 2.0): 0.9914,
    (200, 1500, 2, "beam", 2.0): 0.9952,
    (400, 2000, 2, "beam", 2.0): 0.9983,
}
SIFT_RECALL_MARGIN = 0.03
# The 2-bit ceiling of results/sift1m_2bit_r4.jsonl, printed beside the
# port's 2-bit encode for information: that harness ranked with one
# tie-break, not the strict rank.
CEILING_2BIT_RECORD = {50: 0.5777, 300: 0.8231, 600: 0.8964, 1500: 0.9553}
# Phase 21: phase 6's corpus and storage build at 8 bits a dimension (W =
# 192, 6,144 code bits: the storage prune's wide-code blocks, the seed
# waves' Hamming matrix at W = 192).
WIDE_BITS = 8
# Phase 2 at the tiers' code widths: edge_gather (q, e, r_max, w, cap), each
# aligned and 4 bytes off (W = 16 and 32: 128 dims at 4 and 8 bits over
# phase 20's 1M slots; W = 192: 768 dims at 8 bits over phase 21's 100k),
# and hamming_matrix (q, n, w): phase 20's ceiling chunk (W = 16), a seed
# wave at W = 32 and 192, and 100 dims at 8 bits (W = 25: off the 8-word
# step, 4-byte copies).
SIFT_CAP = ((SIFT_N + 1023) // 1024) * 1024
TIER_EDGE_CASES = [(1024, 4, 65, 16, SIFT_CAP), (1024, 4, 65, 32, SIFT_CAP),
                   (256, 4, 65, 192, ((N + 1023) // 1024) * 1024)]
TIER_MATRIX_CASES = [(256, 65536, 16), (4096, 8192, 32), (333, 1000, 25), (4096, 8192, 192)]
# Phase 2, the beam-search kernel against beam_search_plain: (name,
# check_inputs arguments, search arguments).  The main path's search shapes
# (Q=1,024, L=100, visit budget 166, E=4 and 2, W=48, R_max=65 over phase
# 3's cap), bench.py's wide point with the "scored" window (L=416 and
# Wn=1,510 at L=200, rescore 1,500), the "beam" strategy at SIFT's widest
# point (L=2,010, budget 1,216), in shared memory and in the scratch buffer
# (the wrapper's shared_limit at 0), 1- and 2-label filtered searches, a
# build wave (B=4,096, the history kept) and W=16 (over phase 20's 1M
# slots: a wide row over ids above 2**20, the id tie-break's key width),
# 192 and 500.  Then the inputs that stress the kernel's hashed dedup and
# sort: every code word equal (every distance ties, so the tie-break alone
# orders), in a narrow (E*R = 130) and a wide row (260); 64 and 128 slots
# (adjacency rows full of repeated ids, colliding hash slots); E*R = 520
# with no empty slot (two expansion passes, more keys than the register
# sort holds).  "search" and "build wave" are timed.
BEAM_CASES = [
    ("search", dict(q=1024, w=48, r=65), dict(search_list_size=100, max_iters=166,
                                               expand_factor=4, track_hist=False)),
    ("search E=2", dict(q=1024, w=48, r=65), dict(search_list_size=100, max_iters=166,
                                                   expand_factor=2, track_hist=False)),
    ("scored window", dict(q=256, w=48, r=65),
     dict(search_list_size=416, max_iters=316, expand_factor=2, track_hist=False,
          window_n=1510)),
    ("beam L=2010", dict(q=128, w=16, r=65),
     dict(search_list_size=2010, max_iters=1216, expand_factor=2, track_hist=False)),
    ("1-label", dict(q=1024, w=48, r=65, s=2, lm=2, lq=1),
     dict(search_list_size=100, max_iters=166, expand_factor=4, track_hist=False)),
    ("2-label", dict(q=1024, w=48, r=65, s=3, lm=2, lq=2),
     dict(search_list_size=150, max_iters=241, expand_factor=2, track_hist=False)),
    ("build wave", dict(q=4096, w=48, r=65), dict(search_list_size=100, max_iters=166,
                                                   expand_factor=4, track_hist=True)),
    ("W=16 1M", dict(q=1024, w=16, r=65, cap=SIFT_CAP),
     dict(search_list_size=100, max_iters=166, expand_factor=4, track_hist=False)),
    ("W=192", dict(q=256, w=192, r=65), dict(search_list_size=100, max_iters=166,
                                              expand_factor=4, track_hist=False)),
    ("W=500", dict(q=64, w=500, r=21, cap=4096), dict(search_list_size=50, max_iters=91,
                                                       expand_factor=2, track_hist=True)),
    ("ties narrow", dict(q=1024, w=48, r=65, word_values=1),
     dict(search_list_size=100, max_iters=166, expand_factor=2, track_hist=True,
          window_n=300)),
    ("ties wide", dict(q=1024, w=48, r=65, word_values=1),
     dict(search_list_size=100, max_iters=166, expand_factor=4, track_hist=False)),
    ("cap 64", dict(q=256, w=48, r=65, cap=64, word_values=4),
     dict(search_list_size=100, max_iters=166, expand_factor=4, track_hist=True)),
    ("cap 128", dict(q=256, w=48, r=65, cap=128, word_values=4),
     dict(search_list_size=50, max_iters=91, expand_factor=2, track_hist=True, window_n=100)),
    ("E=8", dict(q=256, w=16, r=65, invalid_share=0.0),
     dict(search_list_size=64, max_iters=96, expand_factor=8, track_hist=True)),
]
# Phase 2, the prune kernel against its plain version: (B, C, Lm) at a
# wave's B and R: C=166 (a searched wave's deduped visit history), C=332
# (a labeled wave's two histories), unlabeled and with 2 labels.  The
# first is timed.
PRUNE_CASES = [(4096, 166, 0), (4096, 332, 0), (4096, 166, 2), (4096, 332, 2)]
PRUNE_R, PRUNE_MAX_ALPHA = 50, 1.2
# Per-SM f32 operations a clock (CUDA C Programming Guide, compute
# capability 9.0): the prune's factor arithmetic.
F32_OPS_PER_CLK_SM = 128


def elapsed() -> float:
    return time.perf_counter() - T0


def say(msg: str) -> None:
    print(f"[{elapsed():8.2f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.stderr.flush()
    sys.exit(1)


def check_deadline(phase: str) -> None:
    limit = DEADLINES[phase]
    if elapsed() > limit:
        say(f"FAIL: phase '{phase}' passed its deadline of {limit}s")
        sys.stderr.flush()
        sys.exit(3)


def require(launches: dict, kernels, what: str) -> None:
    """Fail unless each of ``kernels`` launched at least once in ``launches``."""
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"{what} did not launch {', '.join(missing)}")


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, CUDA events.
    The calls are queued behind a device sleep of QUEUE_SLEEP_CYCLES, so a
    kernel shorter than the host's launch overhead runs back to back
    instead of waiting for the host.  If the sleep ended before the host
    had queued them all, the run is discarded and repeated behind a sleep
    four times longer; fails after QUEUE_SLEEP_TRIES runs."""
    import torch

    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = QUEUE_SLEEP_CYCLES
    for _ in range(QUEUE_SLEEP_TRIES):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        if not start.query():
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail(f"the device sleep ({cycles // 4} cycles) ended before the host had "
         f"queued {iters} calls, {QUEUE_SLEEP_TRIES} times")


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = nvidia_smi("name,power.limit")
    clock_line = nvidia_smi("clocks.max.sm")
    sm_hz = float(clock_line.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"phase 0 device: {name} x{count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvidia-smi: {smi_line}; {sms} SMs, "
        f"max SM clock {clock_line} (clocks.max.sm)")
    check_deadline("device")
    return name, count, smi_line, dict(sms=sms, sm_hz=sm_hz)


def hamming_ops_ms(card: dict, pairs: int, words: int) -> dict:
    """Least time for the operations of ``pairs`` Hamming distances of
    ``words`` 32-bit words each, on the quicker of the card's two ways:
    the CUDA cores (one XOR, ``popc`` and add per word pair, at the
    per-SM issue rates) or the tensor cores' 1-bit path (32 bit pairs per
    word pair, at B1_TENSOR_BIT_PAIRS_PER_S)."""
    per_s = card["sms"] * card["sm_hz"]
    n = pairs * words
    cores = max(n / (per_s * POPC_PER_CLK_SM),
                2 * n / (per_s * INT32_OPS_PER_CLK_SM)) * 1e3
    tensor = n * 32 / B1_TENSOR_BIT_PAIRS_PER_S * 1e3
    return dict(ms=min(cores, tensor), cores_ms=cores, tensor_ms=tensor,
                way="popc on the CUDA cores" if cores <= tensor
                else "1-bit tensor cores")


def bound(nbytes: int, ops: dict) -> tuple[float, str, str]:
    """The bound, what bounds it, and a line that says how."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    by = "bytes" if bytes_ms >= ops["ms"] else "operations"
    how = (f"bytes {bytes_ms:.4f} ms ({nbytes} B); operations {ops['ms']:.4f} ms "
           f"by {ops['way']}")
    if ops.get("tensor_ms") is not None:
        how += (f" (CUDA cores {ops['cores_ms']:.4f} ms, 1-bit tensor cores "
                f"{ops['tensor_ms']:.4f} ms)")
    return max(bytes_ms, ops["ms"]), by, how


def phase_kernel_build(build_dir: Path) -> None:
    from pgvectorscale_tpu_torch.ops import _build

    for rec in _build.build(KERNELS, build_dir=build_dir):
        if not rec["compiled"]:
            fail(f"{rec['name']} was not compiled from a cold directory")
        say(f"phase 1 kernel build: {rec['name']} compiled in {rec['seconds']:.2f}s")
        for line in rec["ptxas"]:
            say(f"  {line}")
        _build.load(rec["name"], build_dir=build_dir)
    check_deadline("kernel build")


def phase_kernel_check(cap_main: int, card: dict) -> dict:
    return {"edge_gather": check_edge_gather(cap_main, card),
            "hamming_matrix": check_hamming_matrix(card),
            "beam_search": check_beam_search(cap_main, card),
            "prune_scan": check_prune_scan(card)}


def event_ms(fn) -> float:
    """Device time of one call of ``fn`` between two CUDA events, for a
    plain loop that reads the device from the host each step (it cannot
    queue behind a device sleep)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def max_abs_diff(a, b) -> float:
    """Largest |a - b| over two equal-shape tensors, +inf - +inf as 0."""
    import torch

    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0).max()) if d.numel() else 0.0


def check_beam_search(cap_main: int, card: dict) -> dict:
    """The beam-search kernel against ``beam_search_plain`` on the card at
    every BEAM_CASES shape, over random graphs with INVALID_EDGE_SHARE of
    the slots empty: every output bit-equal.  The timed shapes: the
    kernel's device time (CUDA events behind the device sleep), the plain
    loop's (events around one call), one query's loop alone (Q=1: the
    chain of dependent iterations) and the bound from the search's own
    visits (``ops.beam_search.bound_bytes``: distinct frontier rows,
    distinct neighbour rows, inputs and outputs once; operations: the
    scored pairs' Hamming words)."""
    import torch

    from pgvectorscale_tpu_torch.ops import _build
    from pgvectorscale_tpu_torch.ops import beam_search as bs

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    timed, max_err = {}, 0.0
    for name, inputs, search in BEAM_CASES:
        inputs = dict(dict(cap=cap_main, invalid_share=INVALID_EDGE_SHARE), **inputs)
        arrays, qc, starts, ql = bs.check_inputs(**inputs, device="cuda", generator=g)
        plain = bs.beam_search_codes_plain(arrays, qc, starts, ql,
                                           **dict(dict(window_n=0, track_hist=True), **search))
        limits = [_build.MAX_SHARED_BYTES] + ([0] if name == "beam L=2010" else [])
        state = bs.state_bytes(search["search_list_size"], search.get("window_n", 0),
                               search["expand_factor"], inputs["r"])
        for limit in limits:
            got = bs.beam_search_codes(arrays, qc, starts, ql, shared_limit=limit, **search)
            torch.cuda.synchronize()
            bad = bs.results_equal(got, plain)
            err = max(max_abs_diff(getattr(got, f), getattr(plain, f))
                      for f in bs.RESULT_FIELDS)
            max_err = max(max_err, err)
            where = ("shared memory" if state + bs.query_bytes(inputs["w"], inputs.get("lq", 0))
                     <= limit else "scratch")
            say(f"  beam_search {name} Q={inputs['q']} W={inputs['w']} "
                f"L={search['search_list_size']} E={search['expand_factor']}: state {state} B "
                f"in {where}, {got.iters} iterations: "
                f"{'equal' if not bad else 'DIFFERENT in ' + ', '.join(bad)} "
                f"(max abs err {err})")
            if bad:
                fail(f"beam_search differs from beam_search_plain at {name}: {bad}")
        if name in ("search", "build wave"):
            timed[name] = time_beam_search(arrays, qc, starts, ql, search, card)
        del arrays, qc, starts, ql, plain, got
    say(f"phase 2 kernel vs plain: beam_search equal at all {len(BEAM_CASES)} shapes")
    check_deadline("kernel vs plain")
    timing = dict(timed["search"])
    timing["max_abs_err"] = max_err
    timing["build_wave"] = {k: v for k, v in timed["build wave"].items() if k != "bound_how"}
    return timing


def time_beam_search(arrays, qc, starts, ql, search: dict, card: dict) -> dict:
    import torch

    from pgvectorscale_tpu_torch.ops import beam_search as bs

    kw = dict(dict(window_n=0, track_hist=True), **search)
    ms = cuda_time_ms(lambda i: bs.launch(arrays, qc, starts, ql, **kw), 10)
    one = [t[:1] for t in (qc, starts, ql)]
    chain_ms = cuda_time_ms(lambda i: bs.launch(arrays, *one, **kw), 10)
    plain_ms = event_ms(lambda: bs.beam_search_codes_plain(arrays, qc, starts, ql, **kw))
    # The visits, for the bound: the same search with its history kept.
    res = bs.beam_search_codes(arrays, qc, starts, ql, **dict(kw, track_hist=True))
    visited = torch.unique(res.hist_ids[res.hist_ids >= 0])
    nbrs = arrays.adjacency[visited.long()]
    nbr_rows = int(torch.unique(nbrs[nbrs >= 0]).numel())
    out, _ = bs.launch(arrays, qc, starts, ql, **kw)
    out_bytes = sum(t.numel() * t.element_size() for t in out.values()) + qc.shape[0] * 4
    (q, w), (s, lq) = qc.shape, (starts.shape[1], ql.shape[1])
    r, lm = arrays.adjacency.shape[1], arrays.node_labels.shape[1]
    nbytes = bs.bound_bytes(q, w, r, s, lq, lm, out_bytes, int(visited.numel()), nbr_rows)
    pairs = int(res.n_dist_comps.sum())
    bound_ms, bound_by, how = bound(nbytes, hamming_ops_ms(card, pairs, w))
    say(f"  beam_search timing at Q={q} W={w} L={kw['search_list_size']} "
        f"E={kw['expand_factor']}: kernel {ms:.4f} ms ({res.iters} iterations), one query "
        f"alone {chain_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {how}; {int(visited.numel())} distinct frontier rows, {nbr_rows} "
        f"distinct neighbour rows, {pairs} scored pairs; the 100k code table and "
        f"adjacency fit in the 50 MB L2)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, bound_how=how, chain_ms=chain_ms, iters=res.iters,
                shape=dict(q=q, w=w, r=r, cap=arrays.adjacency.shape[0],
                           l=kw["search_list_size"], h=kw["max_iters"], e=kw["expand_factor"],
                           visited_rows=int(visited.numel()), nbr_rows=nbr_rows,
                           scored_pairs=pairs))


def check_prune_scan(card: dict) -> dict:
    """The prune kernel against its plain version on the card at every
    PRUNE_CASES shape (``ops.prune_scan.check_inputs``: ties, zero
    distances, the node among its candidates, padding, sentinel-padded
    labels): ``sel`` bit-equal.  The first shape is timed: the kernel
    (CUDA events behind the device sleep), the plain version (events
    around one call), one row alone (B=1: the chain of dependent steps)
    and the bound from its picks (``ops.prune_scan.bound_bytes``)."""
    import torch

    from pgvectorscale_tpu_torch.graph.prune import alpha_schedule, sort_candidates
    from pgvectorscale_tpu_torch.ops import prune_scan as ps

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    kw = dict(num_neighbors=PRUNE_R, alphas=alpha_schedule(PRUNE_MAX_ALPHA))
    timing = None
    for b, c, lm in PRUNE_CASES:
        node, cand, cd, pair, cl, nl = ps.check_inputs(b, c, lm, "cuda", g)
        args = (*sort_candidates(node, cand, cd), cl, nl)
        order, ids, d, valid, tq = args[:5]
        got = ps.prune_scan(order, pair, d, ids, valid, tq, cl, nl, **kw)
        want = ps.prune_scan_plain(order, pair, d, ids, valid, tq, cl, nl, **kw)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err = max_abs_diff(got, want)
        picks = int((got != ps.UNSELECTED).sum())
        say(f"  prune_scan B={b} C={c} Lm={lm} R={PRUNE_R}: {picks} picks, "
            f"{'equal' if ok else 'DIFFERENT'} (max abs err {err})")
        if not ok:
            fail(f"prune_scan differs from its plain version at {(b, c, lm)}")
        if timing is None:
            ms = cuda_time_ms(lambda i: ps.prune_scan(order, pair, d, ids, valid, tq, cl, nl,
                                                      **kw), 20)
            one = [None if t is None else t[:1] for t in (order, pair, d, ids, valid, tq, cl, nl)]
            chain_ms = cuda_time_ms(lambda i: ps.prune_scan(*one, **kw), 20)
            plain_ms = event_ms(lambda: ps.prune_scan_plain(order, pair, d, ids, valid, tq, cl,
                                                            nl, **kw))
            per_s = card["sms"] * card["sm_hz"] * F32_OPS_PER_CLK_SM
            ops_ms = picks * c * 6 / per_s * 1e3  # compare, divide, max: about 6 a pair
            nbytes = ps.bound_bytes(b, c, picks, lm)
            bound_ms, bound_by, how = bound(nbytes, dict(ms=ops_ms, way="f32 on the CUDA cores"))
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, bound_how=how, chain_ms=chain_ms, max_abs_err=err,
                          shape=dict(b=b, c=c, lm=lm, r=PRUNE_R, picks=picks,
                                     n_alphas=len(kw["alphas"])))
            say(f"  prune_scan timing at B={b} C={c}: kernel {ms:.4f} ms, one row alone "
                f"{chain_ms:.4f} ms ({len(kw['alphas'])} x {c} dependent steps), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {how})")
        timing["max_abs_err"] = max(timing["max_abs_err"], err)
        del node, cand, cd, pair, cl, nl, args, got, want
    say(f"phase 2 kernel vs plain: prune_scan equal at all {len(PRUNE_CASES)} shapes")
    check_deadline("kernel vs plain")
    return timing


def check_edge_gather(cap_main: int, card: dict) -> dict:
    import torch

    from pgvectorscale_tpu_torch.ops import edge_gather as eg

    g = torch.Generator(device="cuda").manual_seed(SEED)
    # (q, e, r_max, w, cap, offset): the search and build shapes of the
    # main path (timed), then the shapes of the TPU kernel's own tests, then
    # odd W and W % 4 != 0 (the kernel's 4-byte-load path), then the code
    # widths of 2,000-16,000-dim indexes, aligned and 4 bytes past a
    # 16-byte boundary (``HIGH_DIM_CASES``: 16 and 32 lanes a slot, more
    # than one pass of a lane's loop).
    shapes = [
        (1024, 4, 65, 48, cap_main, False),
        (4096, 4, 65, 48, cap_main, False),
        (256, 1, 65, 8, 4096, False),
        (256, 2, 65, 8, 4096, False),
        (128, 2, 65, 16, 4096, False),
        (128, 2, 65, 32, 4096, False),
        (128, 2, 65, 24, 4096, False),
        (64, 3, 65, 1, 4096, False),
        (64, 2, 65, 25, 4096, False),
        (64, 2, 65, 6, 4096, False),
    ] + [(q, e, r, w, 4096, off) for q, e, r, w, off in eg.HIGH_DIM_CASES]

    max_err = 0.0
    timed = {}
    for q, e, r, w, cap, offset in shapes:
        codes, adj, sel, qc = eg.check_tables(q, e, r, w, cap, offset, INVALID_EDGE_SHARE,
                                              "cuda", g)
        got = eg.hamming_edge_gather(codes, adj, sel, qc)
        want = eg.hamming_edge_gather_plain(codes, adj, sel, qc)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        ok = torch.equal(got, want)
        say(f"  edge_gather Q={q} E={e} R={r} W={w} cap={cap}{' offset' if offset else ''}: "
            f"{'equal' if ok else 'DIFFERENT'} (max abs err {err})")
        if not ok:
            fail(f"edge_gather differs from its plain version at {(q, e, r, w, offset)}")
        if cap == cap_main:
            timed[q] = time_edge_gather(codes, adj, qc, e, card, g, plain=True)
        del codes, adj, sel, qc, got, want
    say(f"phase 2 kernel vs plain: edge_gather equal at all {len(shapes)} shapes")
    check_deadline("kernel vs plain")
    timing = dict(timed[1024])  # the kernels line reports the search shape
    timing["max_abs_err"] = max_err
    timing["by_q"] = {str(q): {k: v for k, v in t.items() if k != "bound_how"}
                      for q, t in timed.items()}
    return timing


def time_edge_gather(codes, adj, qc, e: int, card: dict, g, plain: bool) -> dict:
    """Device time of edge_gather over one codes table and adjacency, 8
    random frontier draws of [Q, E] rows in turn, as a search meets them
    (and of its plain version with ``plain``), beside the bound of the
    bytes each draw must move from its own distinct rows."""
    import torch

    from pgvectorscale_tpu_torch.ops import edge_gather as eg

    (cap, r), (q, w) = adj.shape, qc.shape
    sels = [torch.randint(0, cap, (q, e), dtype=torch.int32, device="cuda", generator=g)
            for _ in range(8)]
    ms = cuda_time_ms(lambda i: eg.hamming_edge_gather(codes, adj, sels[i % 8], qc), 48)
    plain_ms = (cuda_time_ms(lambda i: eg.hamming_edge_gather_plain(codes, adj, sels[i % 8], qc),
                             16) if plain else None)
    draws = []
    for s in sels:
        nbrs = adj[s.long()].clamp(0, cap - 1)
        draws.append((int(torch.unique(s).numel()), int(torch.unique(nbrs).numel())))
    nbytes = sum(eg.bound_bytes(q, e, r, w, a, b) for a, b in draws) // len(draws)
    bound_ms, bound_by, how = bound(nbytes, hamming_ops_ms(card, q * e * r, w))
    l2 = eg.l2_bytes(q, e, r, w)
    say(f"  edge_gather timing at Q={q} E={e} W={w} cap={cap}: kernel {ms:.4f} ms"
        + (f", plain {plain_ms:.4f} ms" if plain else "")
        + f", bound {bound_ms:.4f} ms ({bound_by}: {how}); code-row bytes the lanes read, "
        f"L2 hits included: {l2} B (for information, no rate claimed)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, bound_how=how, l2_bytes=l2,
                shape=dict(q=q, e=e, r=r, w=w, cap=cap, sel_rows=[a for a, _ in draws],
                           nbr_rows=[b for _, b in draws]))


def check_tier_widths(card: dict) -> dict:
    """Phase 2 at the code widths of the 4- and 8-bit tiers
    (TIER_EDGE_CASES, TIER_MATRIX_CASES): each kernel equal to its plain
    version (the Hamming matrix's computed in query blocks of at most
    2**26 word pairs), its device time beside its bound.  Returns the
    times by kernel and shape."""
    import torch

    from pgvectorscale_tpu_torch.ops import edge_gather as eg
    from pgvectorscale_tpu_torch.ops import hamming_matrix as hm

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    out = {"edge_gather": {}, "hamming_matrix": {}}
    for q, e, r, w, cap in TIER_EDGE_CASES:
        for offset in (False, True):
            codes, adj, sel, qc = eg.check_tables(q, e, r, w, cap, offset, INVALID_EDGE_SHARE,
                                                  "cuda", g)
            ok = torch.equal(eg.hamming_edge_gather(codes, adj, sel, qc),
                             eg.hamming_edge_gather_plain(codes, adj, sel, qc))
            say(f"  edge_gather Q={q} E={e} R={r} W={w} cap={cap}"
                f"{' offset' if offset else ''}: {'equal' if ok else 'DIFFERENT'}")
            if not ok:
                fail(f"edge_gather differs from its plain version at {(q, e, r, w, cap, offset)}")
            if not offset:
                t = time_edge_gather(codes, adj, qc, e, card, g, plain=False)
                out["edge_gather"][f"Q={q} E={e} W={w} cap={cap}"] = {
                    k: v for k, v in t.items() if k != "bound_how"}
            del codes, adj, sel, qc
    for q, n, w in TIER_MATRIX_CASES:
        qc, cc, _ = hm.check_codes(q, n, w, None, "cuda", g)
        got = hm.hamming_matrix(qc, cc)
        step = max(1, (1 << 26) // (n * w))
        ok = all(torch.equal(got[i : i + step], hm.hamming_matrix_plain(qc[i : i + step], cc))
                 for i in range(0, q, step))
        ms = cuda_time_ms(lambda i: hm.hamming_matrix(qc, cc), 20)
        bound_ms, bound_by, how = bound(hm.bound_bytes(q, n, w), hamming_ops_ms(card, q * n, w))
        out["hamming_matrix"][f"Q={q} N={n} W={w}"] = dict(ms=ms, bound_ms=bound_ms,
                                                           bound_by=bound_by)
        say(f"  hamming_matrix Q={q} N={n} W={w}: {'equal' if ok else 'DIFFERENT'}; kernel "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {how})")
        if not ok:
            fail(f"hamming_matrix differs from its plain version at {(q, n, w)}")
        del qc, cc, got
    say(f"phase 2 kernel vs plain: both kernels equal at the tiers' widths "
        f"({2 * len(TIER_EDGE_CASES)} edge_gather and {len(TIER_MATRIX_CASES)} "
        f"hamming_matrix shapes)")
    check_deadline("kernel vs plain")
    return out


def checksum(t) -> int:
    """A position-weighted sum of a tensor's 32-bit words (or bytes, for
    1-byte types), mod 2**64."""
    import torch

    x = t.contiguous().view(-1)
    x = (x.view(torch.int32) if x.element_size() == 4 else x.view(torch.uint8)).to(torch.int64)
    weights = torch.arange(x.numel(), dtype=torch.int64, device=x.device) % 65521 + 1
    return int((x * weights).sum())


def popcount_dot(qc, cc, bits: int):
    """The Hamming matrix as a library matrix product (a yardstick, not
    used by the port): unpack to 0/1 fp16, one fp16 matmul with fp32
    accumulation (exact while bits <= 2,048), pop_a + pop_b - 2 * dot."""
    import torch

    from pgvectorscale_tpu_torch.graph.prune import unpack_code_bits

    a = unpack_code_bits(qc, bits).half()
    b = unpack_code_bits(cc, bits).half()
    dot = torch.matmul(a, b.T).to(torch.int32)
    pa = a.sum(dim=1, dtype=torch.int32)
    pb = b.sum(dim=1, dtype=torch.int32)
    return pa[:, None] + pb[None, :] - 2 * dot


def int8_popcount_dot(a, pa, b, pb):
    """The same formula on bits expanded beforehand to int8 0/1
    (``expand_code_bits_plain``): cuBLASLt's int8 product on the tensor
    cores through ``torch._int_mm`` (a yardstick, not used by the port)."""
    import torch

    return pa[:, None] + pb[None, :] - 2 * torch._int_mm(a, b.T)


def check_hamming_matrix(card: dict) -> dict:
    import torch

    from pgvectorscale_tpu_torch.ops import hamming_matrix as hm

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # The kernel's check cases (``CHECK_CASES``, shared with the card
    # tests); the first, the 100k storage build's seed wave, is timed.
    shapes = hm.CHECK_CASES
    max_err = 0
    timing = None
    for q, n, w, fill in shapes:
        qc, cc, const = hm.check_codes(q, n, w, fill, "cuda", g)
        got = hm.hamming_matrix(qc, cc)
        want = hm.hamming_matrix_plain(qc, cc)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        if const is not None:
            ok = ok and bool((got == const).all())
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        say(f"  hamming_matrix Q={q} N={n} W={w}{'' if fill is None else ' ' + fill}: "
            f"{'equal' if ok else 'DIFFERENT'} (max abs err {err})")
        if not ok:
            fail(f"hamming_matrix differs from its plain version at {(q, n, w, fill)}")
        if timing is None:
            prev = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
            try:
                fp16_ok = torch.equal(popcount_dot(qc, cc, 32 * w), got)
                (a, pa), (b, pb) = hm.expand_code_bits_plain(qc), hm.expand_code_bits_plain(cc)
                int8_ok = torch.equal(int8_popcount_dot(a, pa, b, pb), got)
                ms = cuda_time_ms(lambda i: hm.hamming_matrix(qc, cc), 50)
                plain_ms = cuda_time_ms(lambda i: hm.hamming_matrix_plain(qc, cc), 3, 1)
                fp16_ms = cuda_time_ms(lambda i: popcount_dot(qc, cc, 32 * w), 50)
                int8_ms = cuda_time_ms(lambda i: int8_popcount_dot(a, pa, b, pb), 50)
                gemm_ms = cuda_time_ms(lambda i: torch._int_mm(a, b.T), 50)
            finally:
                torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = prev
            if not (fp16_ok and int8_ok):
                fail(f"a popcount-dot yardstick differs from the kernel (fp16 equal "
                     f"{fp16_ok}, int8 equal {int8_ok})")
            del a, b
            nbytes = hm.bound_bytes(q, n, w)
            bound_ms, bound_by, how = bound(nbytes, hamming_ops_ms(card, q * n, w))
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=min(fp16_ms, int8_ms), bound_how=how,
                          shape=dict(q=q, n=n, w=w),
                          yardsticks_ms=dict(fp16_popcount_dot=fp16_ms,
                                             int8_popcount_dot=int8_ms,
                                             int8_int_mm_alone=gemm_ms))
            say(f"  hamming_matrix timing at Q={q} N={n} W={w}: kernel {ms:.4f} ms (one "
                f"launch: the dot on the 1-bit tensor-core path, no expansion kernel), "
                f"plain {plain_ms:.4f} ms; popcount-dot yardsticks, both equal to the "
                f"kernel: fp16 matmul {fp16_ms:.4f} ms, int8 torch._int_mm on bits "
                f"expanded beforehand {int8_ms:.4f} ms (the int8 product alone "
                f"{gemm_ms:.4f} ms); bound {bound_ms:.4f} ms ({bound_by}: {how})")
        del qc, cc, got, want
    say(f"phase 2 kernel vs plain: hamming_matrix equal at all {len(shapes)} shapes")
    check_deadline("kernel vs plain")
    timing["max_abs_err"] = max_err
    return timing


def check_graph(index, label: str) -> str:
    """Full reachability from the start node and degree <= r_max, or fail;
    returns a one-line summary."""
    from pgvectorscale_tpu_torch.graph.build import reachable_on_device

    n = index.count
    reach = int(reachable_on_device(index.arrays)[:n].sum())
    deg = (index.arrays.adjacency[:n] != -1).sum(dim=1)
    max_deg, min_deg = int(deg.max()), int(deg.min())
    r_max = index.config.max_neighbors_during_build
    if reach != n:
        fail(f"{label}: {n - reach} rows are unreachable")
    if max_deg > r_max:
        fail(f"{label}: max degree {max_deg} exceeds r_max {r_max}")
    return (f"reachable {reach}/{n}, orphans {n - reach}, degree {min_deg}..{max_deg} "
            f"(r_max {r_max}), mean {float(deg.float().mean()):.2f}")


def phase_build(vectors, phase: str, counts=None, refine_passes: int = 0, labels=None,
                **config_kw):
    """``DiskannIndex.build`` of ``vectors`` (and their ``labels``) with
    ``IndexConfig(vectors' width, **config_kw)``; seconds split at the progress marks
    (the finalize share includes the refinement passes), the graph checks,
    and, with ``counts``, the kernels' launches between the end of the
    waves and the end of the build."""
    import torch

    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig

    config = IndexConfig(num_dimensions=vectors.shape[1], **config_kw)
    label = ("plain" if not config.uses_sbq else config.build_distance) + (
        f", refine_passes={refine_passes}" if refine_passes else "") + (
        f", labeled, {config.vector_dtype}" if labels is not None else "") + (
        f", {config.bits_per_dimension} bits/dim" if config.num_bits_per_dimension else "")
    marks = {}

    def progress(stage, done, total):
        torch.cuda.synchronize()
        if stage == "training quantizer":
            marks["ingest"] = elapsed()
            say(f"  ingest done ({total} rows, W={config.num_code_words if config.uses_sbq else 0} "
                f"words)")
        elif stage == "inserting tuples":
            say(f"  wave: {done}/{total} rows in the graph")
        elif done == 0:
            marks["waves"] = elapsed()
            marks["waves_counts"] = counts() if counts else None
            say("  waves done, finalizing" + (", refining" if refine_passes else ""))
        else:
            marks["finalize"] = elapsed()
            marks["finalize_counts"] = counts() if counts else None
        check_deadline(phase)

    t = elapsed()
    index = DiskannIndex.build(vectors, config, progress_callback=progress,
                               refine_passes=refine_passes, labels=labels)
    torch.cuda.synchronize()
    fin = "finalize_refine_s" if refine_passes else "finalize_s"
    times = {
        "ingest_s": marks["ingest"] - t,
        "waves_s": marks["waves"] - marks["ingest"],
        fin: marks["finalize"] - marks["waves"],
        "total_s": elapsed() - t,
    }
    if counts:
        times["launches_after_waves"] = {
            k: marks["finalize_counts"][k] - marks["waves_counts"][k]
            for k in marks["waves_counts"]}
    say(f"{phase}: {label}, {index.count} rows, ingest {times['ingest_s']:.2f}s, "
        f"waves {times['waves_s']:.2f}s, {fin[:-2].replace('_', '+')} {times[fin]:.2f}s; "
        f"{check_graph(index, phase)}")
    check_deadline(phase)
    return index, times


def recall_at_10(ids, gt) -> float:
    hits = (ids[:, :, None] == gt[:, None, :]).any(dim=2).sum()
    return float(hits) / (ids.shape[0] * 10)


def ground_truth(vectors, queries, config):
    """Exact top-10 ids of the queries over ``vectors`` (``ExactIndex``)."""
    from pgvectorscale_tpu_torch import ExactIndex

    exact = ExactIndex.build(vectors, config)
    gt, _ = exact.search(queries, 10)
    return gt


def timed_search(index, qdev, params, query_labels=None):
    """Three runs of one top-10 search; (ids, dists, host seconds of each)."""
    import torch

    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, dists = index.search(qdev, 10, params, query_labels=query_labels)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    return ids, dists, secs


def phase_search(index, vectors, queries, phase: str, rescores=(50, 300)):
    """Searches at k=10, L=100 and each rescore, three times each; the
    recall floor holds at the last rescore."""
    import torch

    from pgvectorscale_tpu_torch import QueryParams

    gt = ground_truth(vectors, queries, index.config)
    qdev = torch.as_tensor(queries).cuda()
    torch.cuda.reset_peak_memory_stats()  # the searches' peak, without the oracle's
    results = {}
    for rescore in rescores:
        ids, dists, secs = timed_search(
            index, qdev, QueryParams(search_list_size=100, rescore=rescore))
        if ids.shape != (NQ, 10) or not bool(torch.isfinite(dists).all()):
            fail(f"search at rescore {rescore} returned bad shape or distances")
        recall = recall_at_10(ids, gt)
        best = min(secs)
        results[rescore] = dict(recall=recall, qps=NQ / best, seconds=secs,
                                iters=index.last_search.iters)
        say(f"  rescore {rescore}: recall@10 {recall:.4f}, QPS {NQ / best:.1f} "
            f"(best of {[round(s, 4) for s in secs]} s), beam iterations "
            f"{index.last_search.iters}")
    if results[rescores[-1]]["recall"] < MIN_RECALL:
        fail(f"{phase}: recall@10 at rescore {rescores[-1]} is below {MIN_RECALL}")
    peak = torch.cuda.max_memory_allocated()
    say(f"  {phase}: peak device memory {peak} B")
    check_deadline(phase)
    return results, peak


def search_point(index, qdev, params, gt, name: str, phase: str) -> dict:
    """One search point: ``timed_search`` (best of 3) with the peak device
    memory and beam_search launches of its runs; fails on invalid results
    (shape, finite distances, ids in range, no id twice in a row) or no
    launch; returns recall@10 against ``gt``, QPS and the rest."""
    import torch

    from pgvectorscale_tpu_torch.ops import beam_search

    nq = qdev.shape[0]
    before = beam_search.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ids, dists, secs = timed_search(index, qdev, params)
    peak = torch.cuda.max_memory_allocated()
    launches = beam_search.launches - before
    if launches == 0:
        fail(f"{phase}: {name} did not launch beam_search")
    s_ids = torch.sort(ids, dim=1).values
    if (ids.shape != (nq, 10) or not bool(torch.isfinite(dists).all())
            or bool(((ids < 0) | (ids >= index.count)).any())
            or bool((s_ids[:, 1:] == s_ids[:, :-1]).any())):
        fail(f"{phase}: {name} returned invalid results")
    recall = recall_at_10(ids, gt)
    out = dict(recall=recall, qps=nq / min(secs), seconds=secs, peak_bytes=peak,
               beam_search_launches=launches, iters=index.last_search.iters)
    say(f"  {name}: recall@10 {recall:.4f}, QPS {nq / min(secs):.1f} (best of "
        f"{[round(t, 4) for t in secs]} s), {index.last_search.iters} beam "
        f"iterations, beam_search launches {launches}, peak device memory {peak} B")
    check_deadline(phase)
    return out


def phase_windows(index, vectors, queries) -> dict:
    """Every window strategy at each WINDOW_POINTS (L, rescore, E) on the
    exact-prune index: valid results (ids in range, no id twice in a row,
    finite distances), recall (floor at rescore 300), QPS best of 3, the
    peak device memory of each search, and beam_search launched in each."""
    import torch

    from pgvectorscale_tpu_torch import QueryParams

    phase = "windows"
    gt = ground_truth(vectors, queries, index.config)
    qdev = torch.as_tensor(queries).cuda()
    out = {}
    for l, rescore, e in WINDOW_POINTS:
        for strategy in WINDOW_STRATEGIES:
            params = QueryParams(search_list_size=l, rescore=rescore, expand=e,
                                 window_strategy=strategy)
            name = f"{strategy} L={l} rescore={rescore} E={e}"
            out[name] = search_point(index, qdev, params, gt, name, phase)
            if rescore == 300 and out[name]["recall"] < MIN_RECALL:
                fail(f"{phase}: {name} recall@10 is below {MIN_RECALL}")
    return out


def time_gather_dot(index) -> dict:
    """Device time of full-precision traversal's gather-dot
    (``distance.row_distances``, cosine, no kernel of its own) at a build
    wave's beam step (Q=4,096) and a search step (Q=1,024), E*R = 260
    random neighbour ids each, beside the least bytes it must move: each
    distinct row read once, the ids and queries read, the distances
    written."""
    import torch

    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.distance import row_distances

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    vecs = index.arrays.vectors
    out = {}
    for q in (4096, 1024):
        ids = [torch.randint(0, index.count, (q, 260), dtype=torch.int32, device="cuda",
                             generator=g) for _ in range(4)]
        qv = vecs[torch.randint(0, index.count, (q,), device="cuda", generator=g)]
        ms = cuda_time_ms(lambda i: row_distances(vecs, qv, ids[i % 4], DistanceType.COSINE), 8)
        rows = sum(int(torch.unique(t).numel()) for t in ids) // len(ids)
        nbytes = rows * DIM * 4 + q * 260 * 8 + q * DIM * 4
        out[str(q)] = dict(ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
                           gathered_bytes=q * 260 * DIM * 4)
        say(f"  gather-dot Q={q} x 260 x {DIM}: {ms:.4f} ms on the card, bytes bound "
            f"{out[str(q)]['bound_ms']:.4f} ms ({nbytes} B; it writes and reads "
            f"{q * 260 * DIM * 4} B of gathered rows)")
    return out


def phase_exact(vectors, queries, counts) -> dict:
    """An SBQ build with build_distance "exact" of all but the last
    EXACT_ADD rows, its search, then one add of those rows; the build and
    the add traverse in full precision (no Hamming or beam-search kernel)
    and prune through prune_scan, the search launches beam_search."""
    import numpy as np
    import torch

    out = {}
    n0 = N - EXACT_ADD
    start = counts()
    torch.cuda.reset_peak_memory_stats()
    index, out["build_s"] = phase_build(vectors[:n0], "exact build", build_distance="exact")
    out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    after_build = counts()
    out["search"], out["search_peak_bytes"] = phase_search(
        index, vectors[:n0], queries, "exact search")
    after_search = counts()
    torch.cuda.reset_peak_memory_stats()
    t = elapsed()
    ids = index.add(vectors[n0:])
    torch.cuda.synchronize()
    out["add_s"] = elapsed() - t
    out["add_peak_bytes"] = torch.cuda.max_memory_allocated()
    after_add = counts()
    if not np.array_equal(ids, np.arange(n0, N)):
        fail("exact add: unexpected ids")
    out["launches"] = {
        "build": {k: after_build[k] - start[k] for k in start},
        "search": {k: after_search[k] - after_build[k] for k in start},
        "add": {k: after_add[k] - after_search[k] for k in start},
    }
    say(f"  exact add: {EXACT_ADD} rows in {out['add_s']:.2f}s, peak device memory "
        f"{out['add_peak_bytes']} B; {check_graph(index, 'exact add')}; "
        f"launches {out['launches']}")
    for step in ("build", "add"):
        if any(out["launches"][step][k] for k in ("edge_gather", "hamming_matrix",
                                                   "beam_search")):
            fail(f"the exact {step} launched a Hamming kernel: traversal must be full "
                 f"precision")
        require(out["launches"][step], ("prune_scan",), f"the exact {step}")
    require(out["launches"]["search"], ("beam_search",), "the exact index's search")
    check_deadline("exact add")
    return out


def phase_life_cycle(vectors, queries, phase: str = "life cycle", **config_kw):
    """Build small, stream adds, delete, reuse tombstones, search, save and
    load, compact: the index life cycle in storage mode, 768 wide, with
    ``IndexConfig(**config_kw)`` (phase 15: the int8 tier).  Returns the
    results and a snapshot of the index after the reuse add (count, live
    rows, external ids, checksums of its tensors, the searches at rescore
    50 and 300 on the host), which phase 16's replay must reproduce."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import DiskannIndex, ExactIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch import store
    from pgvectorscale_tpu_torch.ops import hamming_matrix

    config = IndexConfig(num_dimensions=DIM, build_distance="storage", **config_kw)
    out = {}
    t = elapsed()
    index = DiskannIndex.build(vectors[:LC_BUILD], config)
    out["build_s"] = elapsed() - t
    if index.arrays.vectors.dtype != store.vector_dtype(config.vector_dtype):
        fail(f"{phase}: the rows are stored as {index.arrays.vectors.dtype}")
    # Internal id -> the input row stored there, from the ids that build
    # and add return: the recall oracle is built from the input, not from
    # what the index stored.
    row_of = {i: i for i in range(LC_BUILD)}
    pos = LC_BUILD
    t = elapsed()
    for b in range(LC_BATCHES):
        before = hamming_matrix.launches
        ids = index.add(vectors[pos : pos + LC_BATCH])
        torch.cuda.synchronize()
        if b == 0:
            out["first_add_hamming_matrix_launches"] = hamming_matrix.launches - before
            if hamming_matrix.launches == before:
                fail(f"{phase}: the first add's seed wave did not launch hamming_matrix")
        if not np.array_equal(ids, np.arange(pos, pos + LC_BATCH)):
            fail(f"{phase}: add batch {b} returned unexpected ids")
        row_of.update(zip(ids.tolist(), range(pos, pos + LC_BATCH)))
        pos += LC_BATCH
        check_deadline(phase)
    out["adds_s"] = elapsed() - t
    say(f"  {phase}: built {LC_BUILD} rows in {out['build_s']:.2f}s, added "
        f"{LC_BATCHES} x {LC_BATCH} in {out['adds_s']:.2f}s; "
        f"{check_graph(index, phase)}")

    rng = np.random.default_rng(SEED)
    doomed = rng.choice(index.count, int(LC_DELETE * index.count), replace=False)
    index.delete(doomed)
    # What a concurrent reader holds: the add must leave it as it was.
    held, held_ext = index.arrays, index.external_ids
    held_ext_copy = held_ext.copy()
    sums = arrays_checksums(index)
    t = elapsed()
    reused = index.add(vectors[pos : pos + LC_REUSE])
    torch.cuda.synchronize()
    out["reuse_add_s"] = elapsed() - t
    sums_after = {f: checksum(v) for f, v in zip(held._fields, held)
                  if isinstance(v, torch.Tensor)}
    if index.arrays is held:
        fail(f"{phase}: the reuse add did not publish new arrays")
    if sums_after != sums:
        fail(f"{phase}: the reuse add wrote a reader's arrays: {sums} -> {sums_after}")
    if not np.array_equal(held_ext, held_ext_copy):
        fail(f"{phase}: the reuse add wrote a reader's external ids")
    out["snapshot_checksums"] = sums
    say(f"  {phase}: a reader's arrays ({', '.join(sums)}) and external ids are "
        f"unchanged by the reuse add; new arrays published")
    row_of.update(zip(reused.tolist(), range(pos, pos + LC_REUSE)))
    pos += LC_REUSE
    if not np.isin(reused, doomed).all() or len(np.unique(reused)) != LC_REUSE:
        fail(f"{phase}: the add did not land on {LC_REUSE} tombstoned ids")
    say(f"  {phase}: deleted {len(doomed)} rows, added {LC_REUSE} onto tombstones in "
        f"{out['reuse_add_s']:.2f}s; {index.num_deleted} tombstones left, "
        f"{index.num_live} live; {check_graph(index, phase)}")

    live_np = np.nonzero(~index._deleted_np[: index.count])[0]
    live = torch.from_numpy(live_np).cuda()
    exact = ExactIndex.build(vectors[[row_of[i] for i in live_np.tolist()]], config)
    gt = live[exact.search(queries, 10)[0].long()].to(torch.int32)
    del exact
    qdev = torch.as_tensor(queries).cuda()
    deleted = index.arrays.deleted
    snap = dict(count=index.count, num_live=index.num_live,
                external_ids=index.external_ids.copy(), checksums=arrays_checksums(index),
                searches={})
    for rescore in (50, 300):
        ids, dists = index.search(qdev, 10, QueryParams(search_list_size=100, rescore=rescore))
        torch.cuda.synchronize()
        snap["searches"][rescore] = (ids.cpu(), dists.cpu())
        if ids.shape != (NQ, 10) or not bool(torch.isfinite(dists).all()):
            fail(f"{phase}: search at rescore {rescore} returned bad shape or distances")
        if bool(deleted[ids.clamp_min(0).long()].any()):
            fail(f"{phase}: a search returned a deleted row")
        out[f"recall_{rescore}"] = recall_at_10(ids, gt)
    say(f"  {phase}: recall@10 over {index.num_live} live rows {out['recall_50']:.4f} "
        f"(rescore 50), {out['recall_300']:.4f} (rescore 300); no deleted row returned")
    if out["recall_300"] < MIN_RECALL:
        fail(f"{phase}: recall@10 at rescore 300 is below {MIN_RECALL}")

    with tempfile.TemporaryDirectory() as td:
        t = elapsed()
        index.save(Path(td) / "index")
        out["save_s"] = elapsed() - t
        out["checkpoint_bytes"] = (Path(td) / "index.npz").stat().st_size
        t = elapsed()
        loaded = DiskannIndex.load(Path(td) / "index")
        torch.cuda.synchronize()
        out["load_s"] = elapsed() - t
    ids2, dists2 = loaded.search(qdev, 10, QueryParams(search_list_size=100, rescore=300))
    if not (torch.equal(ids, ids2) and torch.equal(dists, dists2)):
        fail(f"{phase}: the loaded index searches differently")
    if not np.array_equal(loaded.external_ids, index.external_ids):
        fail(f"{phase}: the loaded index lost its external ids")
    del loaded

    t = elapsed()
    compacted = index.compact()
    torch.cuda.synchronize()
    out["compact_s"] = elapsed() - t
    if compacted.count != index.num_live:
        fail(f"{phase}: compact kept {compacted.count} rows, not {index.num_live}")
    if not np.array_equal(compacted.external_ids,
                          index.external_ids[live.cpu().numpy()]):
        fail(f"{phase}: compact did not keep the external ids")
    say(f"  {phase}: save {out['save_s']:.2f}s ({out['checkpoint_bytes']} bytes), load "
        f"{out['load_s']:.2f}s, searches bit-equal; compact to {compacted.count} rows "
        f"in {out['compact_s']:.2f}s, {check_graph(compacted, phase)}")
    check_deadline(phase)
    return out, snap


def arrays_checksums(index) -> dict:
    """``checksum`` of every tensor of the index's arrays."""
    import torch

    a = index.arrays
    return {f: checksum(v) for f, v in zip(a._fields, a) if isinstance(v, torch.Tensor)}


def state_on(index, dev):
    """The index's arrays and SBQ statistics, copied to ``dev``."""
    import torch

    from pgvectorscale_tpu_torch.ops import sbq

    arrays = index.arrays._replace(**{
        f: v.to(dev) for f, v in zip(index.arrays._fields, index.arrays)
        if isinstance(v, torch.Tensor)})
    stats = sbq.SbqStats(index.sbq_stats.count, index.sbq_stats.mean.to(dev),
                         index.sbq_stats.m2.to(dev))
    return arrays, stats


def phase_agreement(index, queries, query_labels=None, phase: str = "agreement") -> None:
    """The beam search on the card equals the same search by the plain
    versions on the CPU for 64 queries; with ``query_labels``, the
    filtered search from the default and label start nodes."""
    import torch

    from pgvectorscale_tpu_torch.distance import preprocess_query
    from pgvectorscale_tpu_torch.graph.search import beam_search, get_start_ids
    from pgvectorscale_tpu_torch.labels import make_label_array
    from pgvectorscale_tpu_torch.ops import sbq

    cfg = index.config
    q = torch.as_tensor(queries[:64])
    outs = []
    for dev in ("cuda", "cpu"):
        arrays, stats = state_on(index, dev)
        qv = preprocess_query(q.to(dev), cfg.distance_type)
        qc = sbq.encode(qv, stats, cfg.bits_per_dimension)
        ql = None
        if query_labels is not None:
            ql = torch.from_numpy(make_label_array(query_labels[:64], 2)).to(dev)
        res = beam_search(
            arrays, qc, get_start_ids(arrays, qv.shape[0], ql),
            search_list_size=100, max_iters=166, expand_factor=4,
            query_labels=ql,
        )
        outs.append((qc.cpu(), res.beam_ids.cpu(), res.beam_dists.cpu(),
                     res.hist_ids.cpu()))
    same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    kind = "filtered beam search" if query_labels is not None else "beam search"
    say(f"{'phase 11' if query_labels is not None else 'phase 5'} {phase}: {kind} on "
        f"the card vs the CPU's plain path for 64 queries: "
        f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        fail(f"the card's {kind} differs from the CPU's")
    check_deadline(phase)


@contextlib.contextmanager
def plain_loops():
    """Within: every beam search and prune of the package runs its plain
    version (the beam loop and the prune scan as Python loops), on the
    card as anywhere."""
    from pgvectorscale_tpu_torch.graph import prune, search
    from pgvectorscale_tpu_torch.ops import beam_search as bs
    from pgvectorscale_tpu_torch.ops import prune_scan as ps

    saved = search.beam_search_codes, prune.prune_scan
    search.beam_search_codes, prune.prune_scan = bs.beam_search_codes_plain, ps.prune_scan_plain
    try:
        yield
    finally:
        search.beam_search_codes, prune.prune_scan = saved


def phase_loops_agreement(index, queries) -> dict:
    """On phase 3's index, on the card: ``DiskannIndex.search`` of the
    queries at L=100, rescore 300 and one searched wave of 4,096 rows
    (``graph.build.insert_wave`` re-inserting the 4,096 rows from the
    middle of the index over the whole graph, which writes new arrays and
    leaves the index as it is),
    once through the two loop kernels and once through their plain
    versions: the ids, distances and every SearchResult field of the
    search, and the wave's adjacency (neighbour lists, backlinks and
    overflow prunes), bit-equal.  Seconds of each, host clock."""
    import torch

    from pgvectorscale_tpu_torch import QueryParams
    from pgvectorscale_tpu_torch.graph import build
    from pgvectorscale_tpu_torch.ops import beam_search as bs

    phase = "loops agreement"
    qdev = torch.as_tensor(queries).cuda()
    ctx = build.BuildContext(index.config)
    nodes = torch.arange(index.count // 2, index.count // 2 + 4096, dtype=torch.int32,
                         device="cuda")
    runs, out = [], {}
    for way in ("kernels", "plain"):
        with plain_loops() if way == "plain" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t = time.perf_counter()
            ids, dists = index.search(qdev, 10, QueryParams(search_list_size=100, rescore=300))
            torch.cuda.synchronize()
            t_search = time.perf_counter() - t
            res = index.last_search
            t = time.perf_counter()
            adj = build.insert_wave(index.arrays, ctx, nodes, prefix_rows=index.count,
                                    snap_adjacency=index.arrays.adjacency).adjacency
            torch.cuda.synchronize()
            t_wave = time.perf_counter() - t
        runs.append((ids, dists, res, adj))
        out[way] = dict(search_s=t_search, wave_s=t_wave, iters=res.iters)
    (ids, dists, res, adj), (p_ids, p_dists, p_res, p_adj) = runs
    bad = bs.results_equal(res, p_res)
    out["search_equal"] = torch.equal(ids, p_ids) and torch.equal(dists, p_dists) and not bad
    out["wave_equal"] = torch.equal(adj, p_adj)
    out["wave_rows_changed"] = int((adj != index.arrays.adjacency).any(dim=1).sum())
    say(f"phase 5 {phase}: search through the kernels {out['kernels']['search_s']:.4f}s, the "
        f"plain loops {out['plain']['search_s']:.4f}s ({res.iters} iterations): "
        f"{'equal' if out['search_equal'] else 'DIFFERENT ' + str(bad)}; wave of "
        f"{nodes.numel()} rows through the kernels {out['kernels']['wave_s']:.4f}s, the plain "
        f"loops {out['plain']['wave_s']:.4f}s ({out['wave_rows_changed']} rows written): "
        f"{'equal' if out['wave_equal'] else 'DIFFERENT'}")
    if not (out["search_equal"] and out["wave_equal"]):
        fail(f"{phase}: the kernels and the plain loops disagree")
    check_deadline(phase)
    return out


def suite_labels(n: int, rng):
    """benchmarks/suite.py ``run_filtered``'s label draw: two labels a row
    with popularity 1/rank, kept as 1 or 2 distinct labels.  Returns the
    label lists, the same as an int32 [n, 2] array (-1 padded) and the
    popularity."""
    import numpy as np

    pop = 1.0 / np.arange(1, FILTER_LABELS + 1)
    pop /= pop.sum()
    l1 = rng.choice(FILTER_LABELS, size=n, p=pop)
    l2 = rng.choice(FILTER_LABELS, size=n, p=pop)
    arr = np.stack([l1, np.where(l1 == l2, -1, l2)], axis=1).astype(np.int32)
    lists = [[int(a)] if b < 0 else [int(a), int(b)] for a, b in arr]
    return lists, arr, pop


def label_rows(qlabels, width: int = 2):
    """Query label lists -> int32 [Q, width] on the card, padded with -2
    (no row label and no row padding equals it)."""
    import numpy as np
    import torch

    out = np.full((len(qlabels), width), -2, np.int32)
    for i, ls in enumerate(qlabels):
        out[i, : len(ls)] = ls
    return torch.from_numpy(out).cuda()


def filtered_ground_truth(vectors, queries, row_labels, qlabels):
    """Filtered exact top-10 ids on the card: cosine over the float32
    normalized corpus with every row that carries none of the query's
    labels masked out, as benchmarks/suite.py computes it (the checker's
    own code, not the port's)."""
    import torch

    vn = torch.nn.functional.normalize(torch.as_tensor(vectors).cuda(), dim=1)
    qn = torch.nn.functional.normalize(torch.as_tensor(queries).cuda(), dim=1)
    rows = torch.as_tensor(row_labels).cuda()
    ql = label_rows(qlabels)
    out = []
    for i in range(0, qn.shape[0], 128):
        allowed = (rows[None, :, :, None] == ql[i : i + 128, None, None, :]).any(-1).any(-1)
        d = torch.where(allowed, 1.0 - qn[i : i + 128] @ vn.T, torch.inf)
        out.append(torch.topk(d, 10, dim=1, largest=False).indices)
    return torch.cat(out).to(torch.int32)


def check_filtered(ids, dists, ql, row_labels, name: str) -> None:
    """Every returned id carries one of its query's labels (``ql`` [Q, Lq]
    against ``row_labels`` [rows, Lm] on the card, paddings that match
    nothing), its distance is finite, and no id appears twice in a row."""
    import torch

    valid = ids >= 0
    got = row_labels[ids.clamp_min(0).long()]  # [Q, 10, Lm]
    ok = (got[:, :, :, None] == ql[:, None, None, :]).any(-1).any(-1)
    if bool((valid & ~ok).any()):
        fail(f"{name}: a returned row carries none of its query's labels")
    if bool((valid & ~torch.isfinite(dists)).any()):
        fail(f"{name}: a returned row has no finite distance")
    col = torch.arange(ids.shape[1], device=ids.device)
    s_ids = torch.sort(torch.where(valid, ids, -1 - col), dim=1).values
    if bool((s_ids[:, 1:] == s_ids[:, :-1]).any()):
        fail(f"{name}: an id appears twice in a row")


def check_label_starts(index, name: str) -> int:
    """Every label start entry points at a row that carries the label;
    returns the number of entries."""
    import torch

    from pgvectorscale_tpu_torch.labels import LABEL_SENTINEL

    keys = index.arrays.label_start_keys
    real = keys != LABEL_SENTINEL
    rows = index.arrays.node_labels[index.arrays.label_start_ids[real].long()]
    if not bool((rows == keys[real][:, None]).any(dim=1).all()):
        fail(f"{name}: a label start entry points at a row without the label")
    return int(real.sum())


def label_reach(index, label: int) -> int:
    """Rows carrying ``label`` that a search filtered on it can reach:
    from the default start and the label's start node, through edges into
    rows that carry the label (a breadth-first search on the host over the
    built graph, the checker's own code).  A filtered search with a beam
    wider than k returns min(k, reach) rows."""
    import numpy as np

    n = index.count
    adj = index.arrays.adjacency[:n].cpu().numpy()
    has = (index.arrays.node_labels[:n] == label).any(dim=1).cpu().numpy()
    keys = index.arrays.label_start_keys.cpu().numpy()
    starts = [index.arrays.default_start] + [
        int(i) for i in index.arrays.label_start_ids.cpu().numpy()[keys == label]]
    seen = np.zeros(n, bool)
    seen[starts] = True
    front = np.asarray(starts)
    while len(front):
        nb = adj[front].reshape(-1)
        nb = nb[nb >= 0]
        nb = np.unique(nb[has[nb] & ~seen[nb]])
        seen[nb] = True
        front = nb
    return int((seen & has).sum())


def phase_filtered(vectors, queries, counts) -> dict:
    """Phase 11: the JAX suite's filtered deployment at 100k rows (labels
    from benchmarks/suite.py ``run_filtered``, bf16 vectors, 2 bits/dim,
    exact-prune, R=50, L=100): the build and its checks, both query sets
    at each FILTER_POINTS with recall against the filtered exact top-10,
    the rare-label check and the filtered agreement."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import QueryParams
    from pgvectorscale_tpu_torch.ops import beam_search

    rng = np.random.default_rng(FILTER_SEED)
    labels, row_labels, pop = suite_labels(N, rng)
    qsets = {m: [sorted(rng.choice(FILTER_LABELS, size=m, replace=False, p=pop).tolist())
                 for _ in range(NQ)] for m in (1, 2)}
    out = {}
    start = counts()
    torch.cuda.reset_peak_memory_stats()
    index, out["build_s"] = phase_build(
        vectors, "filtered build", labels=labels, build_distance="exact-prune",
        vector_dtype="bf16", max_labels_per_vector=2)
    out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    after = counts()
    out["build_launches"] = {k: after[k] - start[k] for k in start}
    require(out["build_launches"], BUILD_KERNELS, "the filtered build")
    n_starts = check_label_starts(index, "filtered build")
    if n_starts != len(np.unique(row_labels[row_labels >= 0])):
        fail(f"filtered build: {n_starts} label start entries for "
             f"{len(np.unique(row_labels[row_labels >= 0]))} labels")
    say(f"  filtered build: launches {out['build_launches']}, peak device memory "
        f"{out['build_peak_bytes']} B, {n_starts} label start nodes, each on a row with "
        f"its label")
    check_deadline("filtered build")

    rows_t = torch.as_tensor(row_labels).cuda()
    gts = {m: filtered_ground_truth(vectors, queries, row_labels, qsets[m]) for m in qsets}
    qdev = torch.as_tensor(queries).cuda()
    out["search"] = {}
    for l, rescore, e in FILTER_POINTS:
        for m, ql in qsets.items():
            params = QueryParams(search_list_size=l, rescore=rescore, expand=e)
            before = beam_search.launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ids, dists, secs = timed_search(index, qdev, params, query_labels=ql)
            peak = torch.cuda.max_memory_allocated()
            launches = beam_search.launches - before
            name = f"{m}-label L={l} rescore={rescore} E={e}"
            if launches == 0:
                fail(f"filtered search {name} did not launch beam_search")
            check_filtered(ids, dists, label_rows(ql), rows_t, name)
            recall = recall_at_10(ids, gts[m])
            out["search"][name] = dict(
                recall=recall, qps=NQ / min(secs), seconds=secs, peak_bytes=peak,
                beam_search_launches_3_runs=launches, iters=index.last_search.iters,
                missing=int((ids < 0).sum()))
            say(f"  filtered {name}: recall@10 {recall:.4f}, QPS {NQ / min(secs):.1f} "
                f"(best of {[round(t, 4) for t in secs]} s), {index.last_search.iters} beam "
                f"iterations, beam_search launches {launches} in 3 runs, peak device "
                f"memory {peak} B, {int((ids < 0).sum())} missing results")
            if (l, rescore, e) == FILTER_POINTS[-1] and recall < MIN_FILTERED_RECALL:
                fail(f"filtered search {name}: recall@10 {recall:.4f} is below "
                     f"{MIN_FILTERED_RECALL}")
            check_deadline("filtered search")
    del gts

    per_label = np.bincount(row_labels[row_labels >= 0], minlength=FILTER_LABELS)
    rare = np.argsort(per_label, kind="stable")[:RARE_LABELS]
    rare_ql = [[int(lab)] for lab in rare for _ in range(RARE_QUERIES)]
    ids, dists = index.search(qdev[:RARE_QUERIES].repeat(RARE_LABELS, 1), 10,
                              QueryParams(search_list_size=100, rescore=300),
                              query_labels=rare_ql)
    check_filtered(ids, dists, label_rows(rare_ql), rows_t, "rare labels")
    found = (ids >= 0).sum(dim=1).view(RARE_LABELS, RARE_QUERIES).cpu().numpy()
    if sorted(int(lab) for lab in rare) != sorted(RARE_REACH_FLOOR):
        fail(f"the {RARE_LABELS} rarest labels are {sorted(rare.tolist())}, not "
             f"{sorted(RARE_REACH_FLOOR)}: the label draw changed")
    out["rare_labels"] = {}
    for lab, got in zip(rare, found):
        reach, floor = label_reach(index, int(lab)), RARE_REACH_FLOOR[int(lab)]
        want = 10 if floor >= 10 else min(10, reach)
        out["rare_labels"][int(lab)] = dict(rows=int(per_label[lab]), reach=reach,
                                            found_min=int(got.min()), found_max=int(got.max()))
        if reach < floor:
            fail(f"rare label {lab}: {reach} of its rows are reachable from its start "
                 f"nodes, fewer than the measured {floor}")
        if not (got == want).all():
            fail(f"rare label {lab}: queries found {sorted(set(got.tolist()))} rows, "
                 f"not {want}")
    say(f"  filtered: the {RARE_LABELS} rarest labels, {RARE_QUERIES} queries each: every "
        f"query got 10 ids (min(10, reach) on label 98), all carrying the label, and "
        f"every reach at or above its floor {RARE_REACH_FLOOR} (label: rows, reach from "
        f"the default and the label's start node, found) {out['rare_labels']}")
    check_deadline("filtered search")
    # The path ends here; the agreement's launches compare the card with
    # the plain versions and are not the path's.
    out["launches"] = counts()
    phase_agreement(index, queries, qsets[1][:32] + qsets[2][32:64],
                    phase="filtered agreement")
    return out


def phase_filtered_life_cycle(vectors, queries) -> dict:
    """Phase 12: the life cycle of phase 7 on a labeled bf16 storage index:
    labeled build and adds (hamming_matrix in the first add's seed wave),
    delete, a reuse add with freshly drawn labels (no label start entry
    left on a row without its label), a filtered search (no deleted row,
    every result on its filter), save/load (bit-equal search) and compact
    (each live row's labels and external id kept); graph checks after
    every step."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch.ops import hamming_matrix

    phase = "filtered life cycle"
    config = IndexConfig(num_dimensions=DIM, build_distance="storage", vector_dtype="bf16",
                         max_labels_per_vector=2)
    rng = np.random.default_rng(FILTER_SEED + 1)
    labels, _, pop = suite_labels(LC_BUILD + LC_BATCHES * LC_BATCH, rng)
    out = {}
    t = elapsed()
    index = DiskannIndex.build(vectors[:LC_BUILD], config, labels=labels[:LC_BUILD])
    out["build_s"] = elapsed() - t
    check_graph(index, phase)
    pos = LC_BUILD
    t = elapsed()
    for b in range(LC_BATCHES):
        before = hamming_matrix.launches
        ids = index.add(vectors[pos : pos + LC_BATCH], labels=labels[pos : pos + LC_BATCH])
        torch.cuda.synchronize()
        if b == 0:
            out["first_add_hamming_matrix_launches"] = hamming_matrix.launches - before
            if hamming_matrix.launches == before:
                fail(f"{phase}: the first add's seed wave did not launch hamming_matrix")
        if not np.array_equal(ids, np.arange(pos, pos + LC_BATCH)):
            fail(f"{phase}: add batch {b} returned unexpected ids")
        pos += LC_BATCH
        check_graph(index, phase)
        check_deadline(phase)
    out["adds_s"] = elapsed() - t
    say(f"  {phase}: built {LC_BUILD} labeled rows in {out['build_s']:.2f}s, added "
        f"{LC_BATCHES} x {LC_BATCH} in {out['adds_s']:.2f}s; {check_graph(index, phase)}")

    doomed = rng.choice(index.count, int(LC_DELETE * index.count), replace=False)
    index.delete(doomed)
    check_graph(index, phase)
    fresh, fresh_rows, _ = suite_labels(LC_REUSE, rng)
    t = elapsed()
    reused = index.add(vectors[pos : pos + LC_REUSE], labels=fresh)
    torch.cuda.synchronize()
    out["reuse_add_s"] = elapsed() - t
    if not np.isin(reused, doomed).all() or len(np.unique(reused)) != LC_REUSE:
        fail(f"{phase}: the add did not land on {LC_REUSE} tombstoned ids")
    stored = index.arrays.node_labels[torch.as_tensor(reused).cuda().long()].cpu().numpy()
    want = np.sort(np.where(fresh_rows < 0, np.iinfo(np.int32).max, fresh_rows), axis=1)
    if not np.array_equal(stored, want):
        fail(f"{phase}: the reused rows do not hold their new labels")
    out["label_starts"] = check_label_starts(index, phase)
    say(f"  {phase}: deleted {len(doomed)} rows, added {LC_REUSE} onto tombstones with new "
        f"labels in {out['reuse_add_s']:.2f}s; {out['label_starts']} label start entries, "
        f"each on a row with its label; {check_graph(index, phase)}")

    qlabels = [[int(x)] for x in rng.choice(FILTER_LABELS, size=NQ, p=pop)]
    qdev = torch.as_tensor(queries).cuda()
    params = QueryParams(search_list_size=100, rescore=300)
    ids, dists = index.search(qdev, 10, params, query_labels=qlabels)
    torch.cuda.synchronize()
    if bool(index.arrays.deleted[ids.clamp_min(0).long()][ids >= 0].any()):
        fail(f"{phase}: a search returned a deleted row")
    check_filtered(ids, dists, label_rows(qlabels), index.arrays.node_labels, phase)
    out["missing_results"] = int((ids < 0).sum())

    with tempfile.TemporaryDirectory() as td:
        index.save(Path(td) / "index")
        out["checkpoint_bytes"] = (Path(td) / "index.npz").stat().st_size
        loaded = DiskannIndex.load(Path(td) / "index")
    check_graph(loaded, phase)
    ids2, dists2 = loaded.search(qdev, 10, params, query_labels=qlabels)
    if not (torch.equal(ids, ids2) and torch.equal(dists, dists2)):
        fail(f"{phase}: the loaded index searches differently")
    if not (np.array_equal(loaded.external_ids, index.external_ids)
            and torch.equal(loaded.arrays.label_start_ids, index.arrays.label_start_ids)):
        fail(f"{phase}: the loaded index lost its external ids or label table")
    del loaded

    live = np.nonzero(~index._deleted_np[: index.count])[0]
    t = elapsed()
    compacted = index.compact()
    torch.cuda.synchronize()
    out["compact_s"] = elapsed() - t
    n = compacted.count
    if n != index.num_live or not np.array_equal(compacted.external_ids,
                                                 index.external_ids[live]):
        fail(f"{phase}: compact did not keep the live rows' external ids")
    if not torch.equal(compacted.arrays.node_labels[:n],
                       index.arrays.node_labels[torch.as_tensor(live).cuda()]):
        fail(f"{phase}: compact did not keep the live rows' labels")
    check_label_starts(compacted, phase)
    say(f"  {phase}: filtered search returned no deleted row, every result on its "
        f"filter ({out['missing_results']} missing); save ({out['checkpoint_bytes']} B) "
        f"and load search bit-equal; compact to {n} rows in {out['compact_s']:.2f}s "
        f"keeping labels and external ids, {check_graph(compacted, phase)}")
    check_deadline(phase)
    return out


def scale_oracles(vectors, queries, flag, index) -> dict:
    """On the card, from the float32 corpus: the exact top-10 of every
    query (cosine, GT_CHUNK queries at a time), the filtered exact top-10
    of the stream's queries over the ``flag`` rows, and the chunked
    quantizer statistics held against one ``sbq.train`` pass (mean within
    STATS_RTOL of its largest magnitude, M2 within STATS_RTOL relative per
    dimension), with the share of code words equal under the two."""
    import torch

    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.distance import distance_matrix, preprocess_query
    from pgvectorscale_tpu_torch.ops import sbq

    cfg = index.config
    vn = preprocess_query(torch.from_numpy(vectors).cuda(), DistanceType.COSINE)
    qn = preprocess_query(torch.as_tensor(queries).cuda(), DistanceType.COSINE)
    gt = torch.cat([
        torch.topk(distance_matrix(qn[i : i + GT_CHUNK], vn, DistanceType.COSINE), 10,
                   largest=False).indices
        for i in range(0, NQ, GT_CHUNK)]).to(torch.int32)
    fidx = torch.from_numpy(flag.nonzero()[0]).cuda()
    fd = distance_matrix(qn[:STREAM_QUERIES], vn[fidx], DistanceType.COSINE)
    fgt = fidx[torch.topk(fd, STREAM_K, largest=False).indices]
    one = sbq.train(vn)
    got = index.sbq_stats
    mean_err = float((got.mean - one.mean).abs().max() / one.mean.abs().max())
    m2_err = float(((got.m2 - one.m2).abs() / one.m2.abs()).max())
    equal = 0
    for i in range(0, SCALE_N, 1 << 17):
        part = vn[i : i + (1 << 17)]
        codes = sbq.encode(part, one, cfg.bits_per_dimension)
        equal += int((codes == index.arrays.codes[i : i + part.shape[0]]).sum())
    share = equal / (SCALE_N * cfg.num_code_words)
    del vn
    torch.cuda.empty_cache()
    say(f"  int8 scale: chunked statistics vs one pass on the card: mean off by "
        f"{mean_err:.3e} of its largest magnitude, M2 by {m2_err:.3e} relative at most; "
        f"{share:.6f} of the code words equal")
    if mean_err > STATS_RTOL or m2_err > STATS_RTOL:
        fail(f"int8 scale: the chunked statistics differ from one pass by more than "
             f"{STATS_RTOL}")
    return dict(gt=gt, filtered_gt=fgt.cpu().numpy(),
                stats=dict(mean_err=mean_err, m2_err=m2_err, equal_code_words=share))


def phase_scale(counts):
    """Phase 13: benchmarks/scale.py's int8 deployment at SCALE_N rows
    through the chunked ingest, its oracles and its five search points.
    Returns (index, corpus, queries, flag, filtered top-10, exact top-10,
    results)."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import QueryParams
    from pgvectorscale_tpu_torch import index as index_mod
    from pgvectorscale_tpu_torch.graph.build import reachable_on_device
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

    t = elapsed()
    vectors, queries = synthetic_corpus("cohere", SCALE_N, NQ, seed=SCALE_SEED)
    vectors = np.ascontiguousarray(vectors)
    out = dict(corpus_s=elapsed() - t)
    say(f"phase 13 int8 scale: corpus cohere {vectors.shape} ({vectors.nbytes} B on the "
        f"host) + {queries.shape} queries, seed {SCALE_SEED}, made in {out['corpus_s']:.2f}s")
    ingests = {"chunks": 0, "one-shot": 0}
    real_chunk, real_one = index_mod._ingest_chunk, index_mod._ingest

    def chunk_spy(*a, **k):
        ingests["chunks"] += 1
        return real_chunk(*a, **k)

    def one_spy(*a, **k):
        ingests["one-shot"] += 1
        return real_one(*a, **k)

    index_mod._ingest_chunk, index_mod._ingest = chunk_spy, one_spy
    try:
        start = counts()
        torch.cuda.reset_peak_memory_stats()
        index, out["build_s"] = phase_build(vectors, "int8 build", counts=counts,
                                            num_bits_per_dimension=1, vector_dtype="int8")
        out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        index_mod._ingest_chunk, index_mod._ingest = real_chunk, real_one
    out["build_launches"] = {k: v - start[k] for k, v in counts().items()}
    out["ingest_chunks"] = ingests["chunks"]
    a = index.arrays
    out["store_bytes"] = {f: v.numel() * v.element_size() for f, v in zip(a._fields, a)
                          if isinstance(v, torch.Tensor)}
    torch.cuda.synchronize()
    t = elapsed()
    reach = int(reachable_on_device(a)[: index.count].sum())
    torch.cuda.synchronize()
    out["bfs_s"] = elapsed() - t
    say(f"  int8 build: {ingests['chunks']} ingest chunks, one-shot ingests "
        f"{ingests['one-shot']}; scatter BFS over {index.count} rows {out['bfs_s']:.3f}s "
        f"({reach} reachable); launches {out['build_launches']}; peak device memory "
        f"{out['build_peak_bytes']} B; store {out['store_bytes']}")
    if ingests["one-shot"] or ingests["chunks"] != -(-SCALE_N // index_mod._ingest_chunk_rows(
            SCALE_N, DIM)):
        fail("int8 build: the build did not take the chunked ingest")
    if a.vectors.dtype != torch.int8:
        fail("int8 build: int8 rows expected")
    require(out["build_launches"], BUILD_KERNELS, "the int8 build")

    flag = np.random.default_rng(FLAG_SEED).random(SCALE_N) < FLAG_SHARE
    oracles = scale_oracles(vectors, queries, flag, index)
    out["stats"] = oracles["stats"]
    qdev = torch.as_tensor(queries).cuda()
    out["search"] = {}
    for l, rescore, e, strategy, vf in SCALE_POINTS:
        params = QueryParams(search_list_size=l, rescore=rescore, expand=e,
                             window_strategy=strategy, visit_factor=vf)
        name = f"{strategy} L={l} rescore={rescore} E={e} visit_factor={vf}"
        out["search"][name] = search_point(index, qdev, params, oracles["gt"], name,
                                           "int8 search")
    widest = max((p for p in SCALE_POINTS if p[3] == "expand"), key=lambda p: p[:2])
    name = "{3} L={0} rescore={1} E={2} visit_factor={4}".format(*widest)
    if out["search"][name]["recall"] < SCALE_MIN_RECALL:
        fail(f"int8 search: recall@10 at {name} is below {SCALE_MIN_RECALL}")
    return index, vectors, queries, flag, oracles["filtered_gt"], oracles["gt"], out


def phase_rescore_tiers() -> dict:
    """The rescore at benchmarks/kernels.py's "rescore-tiers" shape (n =
    SCALE_N, d = 768, q = NQ, m = TIER_M random ids, L2 on standard-normal
    rows) for f32, bf16 and int8 tables; CUDA events behind the device
    sleep; each beside its byte bound (every gathered row read once, ids,
    scales and queries read, distances written; the distinct rows, about
    27% fewer, are the floor if rows were read once each)."""
    import torch

    from pgvectorscale_tpu_torch import store
    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.index import _exact_batch_distances

    g = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randn((SCALE_N, DIM), device="cuda", generator=g)
    ids = [torch.randint(0, SCALE_N, (NQ, TIER_M), dtype=torch.int32, device="cuda",
                         generator=g) for _ in range(4)]
    qv = torch.randn((NQ, DIM), device="cuda", generator=g)
    distinct = sum(int(torch.unique(t).numel()) for t in ids) // len(ids)
    out = {}
    for tier in ("f32", "bf16", "int8"):
        if tier == "int8":
            vecs, scales = store.quantize_rows(base)
        else:
            vecs = base.to(store.vector_dtype(tier))
            scales = torch.ones((SCALE_N,), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(
            lambda i: _exact_batch_distances(vecs, scales, qv, ids[i % 4], DistanceType.L2), 8)
        peak = torch.cuda.max_memory_allocated()
        row = DIM * vecs.element_size()
        small = NQ * TIER_M * 4 * (3 if tier == "int8" else 2) + NQ * DIM * 4
        nbytes = NQ * TIER_M * row + small
        out[tier] = dict(ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_bytes=nbytes,
                         distinct_rows_bound_ms=(distinct * row + small) / HBM_BYTES_PER_S * 1e3,
                         peak_bytes=peak)
        say(f"  rescore tiers, {tier}: {ms:.4f} ms (q={NQ}, m={TIER_M}, d={DIM}, n={SCALE_N}, "
            f"L2), byte bound {out[tier]['bound_ms']:.4f} ms ({nbytes} B; "
            f"{out[tier]['distinct_rows_bound_ms']:.4f} ms over the {distinct} distinct rows); "
            f"peak device memory {peak} B")
        del vecs, scales
    out["int8_speedup"] = out["f32"]["ms"] / out["int8"]["ms"]
    out["bf16_speedup"] = out["f32"]["ms"] / out["bf16"]["ms"]
    say(f"phase 13 rescore tiers: int8 : f32 speed {out['int8_speedup']:.3f}, bf16 : f32 "
        f"{out['bf16_speedup']:.3f}")
    del base
    torch.cuda.empty_cache()
    check_deadline("rescore tiers")
    return out


def stream_one(index, query, flag) -> dict:
    """One post-filtered stream: pull from ``search_iter`` until STREAM_K
    rows pass ``flag``; no id twice, no deleted id, every distance within
    1e-5 of the int8 exact rescore of its id."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import QueryParams
    from pgvectorscale_tpu_torch.distance import preprocess_query
    from pgvectorscale_tpu_torch.ops import edge_gather

    torch.cuda.synchronize()
    t = time.perf_counter()
    before = edge_gather.launches
    it = index.search_iter(query, QueryParams(search_list_size=100, rescore=50))
    ids, dists, hits = [], [], []
    for nid, d in it:
        ids.append(nid)
        dists.append(d)
        if flag[nid]:
            hits.append(nid)
            if len(hits) == STREAM_K:
                break
    visits = it.total_visits
    secs = time.perf_counter() - t
    launches = edge_gather.launches - before
    if len(set(ids)) != len(ids):
        fail("stream: an id came twice")
    if index._deleted_np[ids].any():
        fail("stream: a deleted id came out")
    qv = preprocess_query(torch.as_tensor(query[None, :]).cuda(), index.config.distance_type)
    exact = index.exact_distances_for(qv[0], np.asarray(ids))
    err = float(np.abs(exact - np.asarray(dists, np.float32)).max())
    if err > 1e-5:
        fail(f"stream: yielded distances differ from the int8 rescore by {err}")
    return dict(ids=ids, hits=hits, pulled=len(ids), visits=visits, seconds=secs,
                launches=launches, dist_err=err)


def iterate_agreement(index, queries) -> bool:
    """``iter_step`` on the card and on a CPU copy of the index (plain
    versions) emit the same ids and distances over AGREE_REFILLS refills
    (the iterator's window doubling from 128) for AGREE_QUERIES queries."""
    import torch

    from pgvectorscale_tpu_torch.distance import preprocess_query
    from pgvectorscale_tpu_torch.graph import iterate
    from pgvectorscale_tpu_torch.graph.search import get_start_ids
    from pgvectorscale_tpu_torch.ops import sbq

    cfg = index.config
    kw = dict(distance_type=cfg.distance_type, use_codes=True)
    copies = {dev: state_on(index, dev) for dev in ("cuda", "cpu")}
    same = True
    for qi in range(AGREE_QUERIES):
        outs = []
        for dev, (arrays, stats) in copies.items():
            qv = preprocess_query(torch.as_tensor(queries[qi : qi + 1]).to(dev),
                                  cfg.distance_type)[0]
            qc = sbq.encode(qv[None], stats, cfg.bits_per_dimension)[0]
            state = iterate.init_state(arrays, qv, qc, get_start_ids(arrays, 1)[0],
                                       frontier=256, **kw)
            emitted = []
            emit_n = 128
            for _ in range(AGREE_REFILLS):
                state, ids, d = iterate.iter_step(state, arrays, qv, qc, emit_n=emit_n,
                                                  visit_budget=4 * emit_n, **kw)
                emitted += [ids.cpu(), d.cpu()]
                emit_n *= 2
            outs.append(emitted + [state.n_visits.cpu()])
        same = same and all(torch.equal(a, b) for a, b in zip(*outs))
    del copies
    return same


def phase_stream(index, queries, flag, filtered_gt) -> dict:
    """Phase 14 on phase 13's index: the post-filtered streams, the
    card-CPU agreement of ``iter_step``, and a full-table scan of a
    SCAN_N-row int8 index with SCAN_DELETE of its rows deleted."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
    from pgvectorscale_tpu_torch.ops import edge_gather

    phase = "stream"
    out = dict(queries=[])
    for qi in range(STREAM_QUERIES):
        r = stream_one(index, queries[qi], flag)
        r["recall"] = len(set(r["hits"]) & set(filtered_gt[qi].tolist())) / STREAM_K
        del r["ids"], r["hits"]
        out["queries"].append(r)
        check_deadline(phase)
    qs = out["queries"]
    visits = sum(r["visits"] for r in qs)
    out.update(recall=float(np.mean([r["recall"] for r in qs])),
               pulled_mean=float(np.mean([r["pulled"] for r in qs])),
               visits_mean=visits / len(qs),
               us_per_visit=sum(r["seconds"] for r in qs) / visits * 1e6,
               launches_per_visit=sum(r["launches"] for r in qs) / visits)
    say(f"phase 14 stream: {STREAM_QUERIES} post-filtered streams (flag on "
        f"{int(flag.sum())} rows): recall@10 {out['recall']:.4f} against the filtered exact "
        f"top-10; rows pulled {out['pulled_mean']:.1f}, visits {out['visits_mean']:.1f} a "
        f"query (pulled {[r['pulled'] for r in qs]}); {out['us_per_visit']:.1f} us a visit, "
        f"edge_gather launches a visit {out['launches_per_visit']:.3f}; no id twice, no "
        f"deleted id, distances within {max(r['dist_err'] for r in qs):.2e} of the rescore")
    if min(r["visits"] for r in qs) <= 0 or out["launches_per_visit"] < 1:
        fail("stream: the iterator did not traverse through edge_gather")

    t = elapsed()
    out["agreement"] = iterate_agreement(index, queries)
    say(f"  stream: iter_step on the card vs the CPU's plain path, {AGREE_QUERIES} queries x "
        f"{AGREE_REFILLS} refills: {'equal' if out['agreement'] else 'DIFFERENT'} "
        f"({elapsed() - t:.2f}s)")
    if not out["agreement"]:
        fail("stream: the card's iter_step differs from the CPU's")
    check_deadline(phase)

    vectors, _ = synthetic_corpus("cohere", SCAN_N, 1, seed=SCALE_SEED)
    small = DiskannIndex.build(vectors, IndexConfig(num_dimensions=DIM, num_bits_per_dimension=1,
                                                    vector_dtype="int8"))
    doomed = np.random.default_rng(SEED).choice(SCAN_N, int(SCAN_DELETE * SCAN_N),
                                                replace=False)
    small.delete(doomed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    before = edge_gather.launches
    it = small.search_iter(vectors[0], QueryParams(search_list_size=100, rescore=50))
    got = [nid for nid, _ in it]
    secs = time.perf_counter() - t
    live = set(range(SCAN_N)) - set(doomed.tolist())
    scan = dict(rows=len(got), live=len(live), visits=it.total_visits, seconds=secs,
                us_per_visit=secs / max(it.total_visits, 1) * 1e6,
                launches=edge_gather.launches - before)
    out["full_scan"] = scan
    say(f"  stream: full scan of {SCAN_N} int8 rows, {len(doomed)} deleted: {len(got)} rows "
        f"({len(set(got))} distinct) in {secs:.2f}s, {scan['visits']} visits, "
        f"{scan['us_per_visit']:.1f} us a visit, edge_gather launches {scan['launches']}")
    if len(got) != len(set(got)) or set(got) != live:
        fail("stream: the full scan did not yield every live row exactly once")
    if not 0 < scan["visits"] <= small.count:
        fail(f"stream: the full scan took {scan['visits']} visits over {small.count} rows")
    check_deadline(phase)
    return out


def check_build_stats(index, phase: str) -> dict:
    """``build_stats`` of a fresh build: printed, and at least one wave."""
    import dataclasses

    st = index.build_stats
    if st is None or st.num_waves <= 0 or st.num_nodes != index.count:
        fail(f"{phase}: build_stats {st} lacks its rows or waves")
    out = {k: v for k, v in dataclasses.asdict(st).items() if k != "started"}
    say(f"  {phase}: build_stats {out}")
    return out


def check_trace(index, queries) -> dict:
    """One search at L=100, rescore 50 inside ``stats.profiler_trace``: the
    trace written into a temporary directory must hold the beam_search
    kernel, once for each launch the wrapper counted in that search."""
    import torch

    from pgvectorscale_tpu_torch import QueryParams
    from pgvectorscale_tpu_torch.ops import beam_search
    from pgvectorscale_tpu_torch.stats import profiler_trace

    qdev = torch.as_tensor(queries).cuda()
    with tempfile.TemporaryDirectory() as td:
        before = beam_search.launches
        with profiler_trace(td):
            index.search(qdev, 10, QueryParams(search_list_size=100, rescore=50))
        launches = beam_search.launches - before
        files = list(Path(td).iterdir())
        events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [e for e in kernels if "beam_search" in e.get("name", "")]
    out = dict(files=len(files), kernel_events=len(kernels), beam_search_events=len(ours),
               beam_search_launches=launches,
               beam_search_device_us=sum(float(e.get("dur", 0)) for e in ours),
               name=ours[0]["name"] if ours else None)
    say(f"  search trace (stats.profiler_trace): {out}")
    if not ours or len(ours) != launches:
        fail(f"the profiler trace holds {len(ours)} beam_search kernels for {launches} launches")
    return out


def phase_search_stats(index, queries) -> dict:
    """Phase 5's 64 queries through ``DiskannIndex.search`` (L=100, rescore
    50) on the card and on a CPU copy of the index (plain versions): equal
    ``last_search_stats``; ``estimate_query_cost`` answers "measured"."""
    import dataclasses

    from pgvectorscale_tpu_torch import DiskannIndex, QueryParams

    params = QueryParams(search_list_size=100, rescore=50)
    index.search(queries[:64], 10, params)
    card = dataclasses.asdict(index.last_search_stats)
    estimate = index.estimate_query_cost(params)
    arrays, stats = state_on(index, "cpu")
    cpu = DiskannIndex(index.config, arrays, stats)
    cpu.search(queries[:64], 10, params, device="cpu")
    plain = dataclasses.asdict(cpu.last_search_stats)
    say(f"phase 5 search stats: card {card}, CPU plain path {plain}: "
        f"{'equal' if card == plain else 'DIFFERENT'}; estimate_query_cost {estimate}")
    if card != plain:
        fail("the card's last_search_stats differ from the CPU's")
    if estimate["basis"] != "measured":
        fail("estimate_query_cost did not use the measured search")
    return dict(card=card, cpu=plain, estimate=estimate)


def phase_debug_helpers(index) -> dict:
    """Phase 17, the debug helpers on phase 3's index (run before it is
    freed): every row reachable, no row without an in-edge."""
    from pgvectorscale_tpu_torch.debug import count_reachable_nodes, degree_histogram

    t = elapsed()
    out = dict(reachable=count_reachable_nodes(index), degrees=degree_histogram(index))
    out["seconds"] = elapsed() - t
    say(f"phase 17 debug helpers on phase 3's index ({index.count} rows): {out}")
    if out["reachable"] != index.count or out["degrees"]["orphans"] != 0:
        fail("debug helpers: phase 3's index has unreachable rows or orphans")
    return out


def download_graph(index) -> dict:
    """Phase 13's adjacency on the host for phase 17, with the device
    BFS's reachable set and seconds (read before the index is freed)."""
    import torch

    from pgvectorscale_tpu_torch.graph.build import reachable_on_device

    n = index.count
    torch.cuda.synchronize()
    t = elapsed()
    reach = reachable_on_device(index.arrays)[:n].cpu().numpy()
    device_bfs_s = elapsed() - t
    t = elapsed()
    adj = index.arrays.adjacency[:n].cpu().numpy()
    say(f"  host copy of phase 13's adjacency: {adj.nbytes} B in {elapsed() - t:.2f}s")
    return dict(adj=adj, start=int(index.arrays.default_start), device_reach=reach,
                device_bfs_s=device_bfs_s, r_max=index.config.max_neighbors_during_build)


# Phase 16's child: build phase 7's storage index, attach a journal, run
# phase 7's adds, delete and reuse add, print a JSON line and SIGKILL
# itself without saving.  argv: repo root, kernel build directory, vectors
# (.npy), checkpoint path, sizes (JSON).
_DURABLE_CHILD = r"""
import json, os, signal, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from pgvectorscale_tpu_torch.ops import _build, beam_search, edge_gather, hamming_matrix, prune_scan
for name in ("edge_gather", "hamming_matrix", "beam_search", "prune_scan"):
    _build.load(name, build_dir=sys.argv[2])
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, durability

sizes = json.loads(sys.argv[5])
vectors = np.load(sys.argv[3])
appends = []
real_append = durability.MutationJournal._append

def timed_append(self, payload):
    t = time.perf_counter()
    real_append(self, payload)
    appends.append([time.perf_counter() - t, sum(v.nbytes for v in payload.values())])

durability.MutationJournal._append = timed_append
index = DiskannIndex.build(vectors[: sizes["build"]],
                           IndexConfig(num_dimensions=vectors.shape[1], build_distance="storage"))
torch.cuda.synchronize()
t = time.perf_counter()
index.enable_durability(sys.argv[4])
base_s = time.perf_counter() - t
pos = sizes["build"]
for _ in range(sizes["batches"]):
    index.add(vectors[pos : pos + sizes["batch"]])
    pos += sizes["batch"]
rng = np.random.default_rng(sizes["seed"])
index.delete(rng.choice(index.count, int(sizes["delete"] * index.count), replace=False))
index.add(vectors[pos : pos + sizes["reuse"]])
torch.cuda.synchronize()
print(json.dumps({"base_checkpoint_s": base_s, "appends": appends,
                  "launches": {m.__name__.rsplit(".", 1)[1]: m.launches
                               for m in (edge_gather, hamming_matrix, beam_search, prune_scan)},
                  "count": index.count, "num_live": index.num_live}), flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def phase_durable(vectors, queries, build_dir: Path, snap: dict, counts) -> dict:
    """Phase 16: a child process on the card runs phase 7's life cycle with
    a journal attached and is killed; ``DiskannIndex.load`` replays its
    journal to phase 7's index, bit for bit (``snap``).  Then a second
    journal with ``auto_checkpoint_every=DUR_AUTO_EVERY`` over two adds
    of LC_BATCH rows: empty after the second, and ``load`` gives the same
    live rows."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import DiskannIndex, QueryParams

    phase = "durable life cycle"
    n_lc = LC_BUILD + LC_BATCH * LC_BATCHES + LC_REUSE
    sizes = dict(build=LC_BUILD, batch=LC_BATCH, batches=LC_BATCHES, delete=LC_DELETE,
                 reuse=LC_REUSE, seed=SEED)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        vec_path, path = Path(td) / "rows.npy", Path(td) / "durable.npz"
        np.save(vec_path, vectors[:n_lc])
        t = elapsed()
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _DURABLE_CHILD, str(ROOT), str(build_dir),
                 str(vec_path), str(path), json.dumps(sizes)],
                capture_output=True, text=True,
                timeout=max(DEADLINES[phase] - elapsed(), 1))
        except subprocess.TimeoutExpired:
            fail(f"{phase}: the child did not end before the phase's deadline")
        out["child_s"] = elapsed() - t
        if proc.returncode != -9 or not proc.stdout.strip():
            fail(f"{phase}: the child ended with {proc.returncode}, not SIGKILL: "
                 f"{proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        records = sorted(os.listdir(f"{path}.journal"))
        rates = [b / s / 1e6 for s, b in child["appends"]]
        out.update(child=child, records=len(records),
                   journal_bytes=sum(os.path.getsize(f"{path}.journal/{r}") for r in records),
                   append_mb_per_s=rates)
        say(f"phase 16 {phase}: the child (killed with SIGKILL, {out['child_s']:.2f}s "
            f"from start to kill) wrote a base checkpoint of {LC_BUILD} rows in "
            f"{child['base_checkpoint_s']:.2f}s and {len(records)} journal records "
            f"({out['journal_bytes']} B on disk); appends "
            f"{[round(s, 3) for s, _ in child['appends']]} s at "
            f"{[round(r, 1) for r in rates]} MB/s of record arrays; its launches "
            f"{child['launches']}")
        if len(records) != LC_BATCHES + 2:
            fail(f"{phase}: {len(records)} journal records, not {LC_BATCHES + 2}")

        start = counts()
        torch.cuda.synchronize()
        t = elapsed()
        index = DiskannIndex.load(path)
        torch.cuda.synchronize()
        out["load_replay_s"] = elapsed() - t
        out["replay_launches"] = {k: v - start[k] for k, v in counts().items()}
        qdev = torch.as_tensor(queries).cuda()
        same = dict(count=index.count == snap["count"], num_live=index.num_live == snap["num_live"],
                    external_ids=np.array_equal(index.external_ids, snap["external_ids"]),
                    checksums=arrays_checksums(index) == snap["checksums"])
        for rescore, (ids, dists) in snap["searches"].items():
            got_ids, got_d = index.search(qdev, 10, QueryParams(search_list_size=100,
                                                                rescore=rescore))
            same[f"search_{rescore}"] = (torch.equal(got_ids.cpu(), ids)
                                         and torch.equal(got_d.cpu(), dists))
        out["equal_to_phase_7"] = same
        say(f"  {phase}: load + replay of {len(records)} records in {out['load_replay_s']:.2f}s, "
            f"launches in the replay {out['replay_launches']}; against phase 7's index "
            f"after its reuse add: {same}")
        if not all(same.values()):
            fail(f"{phase}: the replayed index differs from phase 7's: {same}")
        require(out["replay_launches"], LIFE_KERNELS, f"{phase}: the replay")

        path2 = Path(td) / "auto.npz"
        out["checkpoint_rows"] = index.count
        t = elapsed()
        index.enable_durability(path2, auto_checkpoint_every=DUR_AUTO_EVERY)
        out["checkpoint_s"] = elapsed() - t
        out["checkpoint_bytes"] = path2.stat().st_size
        ckpt_s = []
        real_checkpoint = index.checkpoint

        def timed_checkpoint():
            t0 = elapsed()
            real_checkpoint()
            ckpt_s.append(elapsed() - t0)

        index.checkpoint = timed_checkpoint
        pos = n_lc
        journal_after = []
        for _ in range(2):
            index.add(vectors[pos : pos + LC_BATCH])
            pos += LC_BATCH
            journal_after.append(len(index._journal))
        out.update(auto_checkpoint_s=ckpt_s, journal_after_adds=journal_after,
                   auto_checkpoint_bytes=path2.stat().st_size)
        t = elapsed()
        loaded = DiskannIndex.load(path2)
        out["load_s"] = elapsed() - t
        say(f"  {phase}: enable_durability checkpoint of {out['checkpoint_rows']} rows in "
            f"{out['checkpoint_s']:.2f}s ({out['checkpoint_bytes']} B); journal records after "
            f"two adds of {LC_BATCH}: {journal_after} (auto_checkpoint_every "
            f"{DUR_AUTO_EVERY}); auto-checkpoint {[round(x, 2) for x in ckpt_s]} s "
            f"({out['auto_checkpoint_bytes']} B); load {out['load_s']:.2f}s, live rows "
            f"{loaded.num_live} (index {index.num_live})")
        if journal_after != [1, 0] or len(ckpt_s) != 1 or loaded.num_live != index.num_live:
            fail(f"{phase}: the auto-checkpoint did not consolidate the journal")
    check_deadline(phase)
    return out


def phase_host_graph(graph: dict) -> dict:
    """Phase 17, host graph: on phase 13's 1M adjacency the native BFS's
    reachable set equals the device BFS's; on a copy with the in-edges of
    ORPHANS seeded rows cleared, ``repair_orphans_host`` (native) leaves
    no orphan and keeps the degree bound."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import native
    from pgvectorscale_tpu_torch.graph.build import reachable_on_device, repair_orphans_host
    from pgvectorscale_tpu_torch.store import GraphArrays

    phase = "host graph"
    if not native.available():
        fail(f"{phase}: the native host runtime did not build (g++)")
    adj, start = graph["adj"], graph["start"]
    n = adj.shape[0]
    t = elapsed()
    reach = native.bfs_reachable(adj, start)
    out = dict(rows=n, native_bfs_s=elapsed() - t, device_bfs_s=graph["device_bfs_s"],
               equal=bool(np.array_equal(reach, graph["device_reach"])))
    rng = np.random.default_rng(SEED + 17)
    victims = rng.choice(np.setdiff1d(np.arange(n), [start]), ORPHANS, replace=False)
    hit = np.zeros(n + 1, bool)
    hit[victims] = True
    cut = adj.copy()
    cut[hit[np.where(cut >= 0, cut, n)]] = -1
    out["orphans_before"] = int((~native.bfs_reachable(cut, start)).sum())
    dev = torch.device("cuda")
    arrays = GraphArrays(
        vectors=torch.zeros((n, 0), device=dev), codes=torch.zeros((n, 0), dtype=torch.int32,
                                                                  device=dev),
        adjacency=torch.from_numpy(cut).to(dev), deleted=torch.zeros(n, dtype=torch.bool,
                                                                     device=dev),
        count=n, default_start=start,
        node_labels=torch.zeros((n, 0), dtype=torch.int32, device=dev),
        label_start_keys=torch.zeros(1, dtype=torch.int32, device=dev),
        label_start_ids=torch.zeros(1, dtype=torch.int32, device=dev),
        vec_scales=torch.ones(n, device=dev),
    )
    torch.cuda.synchronize()
    t = elapsed()
    repaired = repair_orphans_host(arrays)
    torch.cuda.synchronize()
    out["host_repair_s"] = elapsed() - t
    out["orphans_after"] = int((~reachable_on_device(repaired)[:n]).sum())
    out["max_degree"] = int((repaired.adjacency != -1).sum(dim=1).max())
    say(f"phase 17 {phase}: phase 13's adjacency ({n} rows), native BFS {out['native_bfs_s']:.3f}s vs device "
        f"scatter BFS {out['device_bfs_s']:.3f}s, reachable sets "
        f"{'equal' if out['equal'] else 'DIFFERENT'} ({int(reach.sum())} rows); in-edges of "
        f"{ORPHANS} rows cleared: {out['orphans_before']} orphans, host repair "
        f"{out['host_repair_s']:.3f}s (download, native repair, upload) -> "
        f"{out['orphans_after']} orphans, max degree {out['max_degree']} (r_max "
        f"{graph['r_max']})")
    if not out["equal"] or out["orphans_before"] < ORPHANS:
        fail(f"{phase}: the native BFS differs from the device's, or the cut left too few orphans")
    if out["orphans_after"] or out["max_degree"] > graph["r_max"]:
        fail(f"{phase}: the host repair left orphans or broke the degree bound")
    check_deadline(phase)
    return out


def run_cli(*args, subprocess_: bool = False, phase: str = "cli") -> tuple[list, float]:
    """The port's CLI with ``args`` (on the card): ``cli.main(args)`` in
    this process, its standard output captured, or with ``subprocess_``
    ``python -m pgvectorscale_tpu_torch.cli <args>`` from the repository
    root.  Its stdout's JSON lines and the seconds it took."""
    import contextlib
    import io

    from pgvectorscale_tpu_torch import cli

    t = elapsed()
    if subprocess_:
        try:
            proc = subprocess.run([sys.executable, "-m", "pgvectorscale_tpu_torch.cli", *args],
                                  cwd=ROOT, capture_output=True, text=True,
                                  timeout=max(DEADLINES[phase] - elapsed(), 1))
        except subprocess.TimeoutExpired:
            fail(f"{phase}: cli {args[0]} did not end before the phase's deadline")
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    else:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(args))
        stdout, stderr = buf.getvalue(), ""
    secs = elapsed() - t
    if rc != 0:
        fail(f"{phase}: cli {' '.join(args)} exited {rc}: {stderr[-3000:]}")
    try:
        if args[0] == "info":
            lines = [json.loads(stdout)]
        else:
            lines = [json.loads(ln) for ln in stdout.strip().splitlines()]
    except json.JSONDecodeError:
        fail(f"{phase}: cli {args[0]} printed a line that is not JSON: {stdout[-2000:]}")
    say(f"  cli {' '.join(a if len(a) < 40 else Path(a).name for a in args)}"
        f"{' (a subprocess)' if subprocess_ else ''}: {secs:.2f}s, "
        f"{json.dumps(lines[-1])[:400] if args[0] != 'search' else f'{len(lines)} lines'}")
    return lines, secs


def phase_cli(vectors, queries, build_dir: Path) -> dict:
    """Phase 17, the CLI on the card through ``cli.main`` in this process:
    ``bench`` at its defaults (recall at its widest L at least MIN_RECALL),
    then build / info / search / add / delete / compact / info on CLI_N
    rows (``info``: every row reachable, no orphan, both times); ``search``
    runs as a subprocess (``python -m pgvectorscale_tpu_torch.cli``,
    loading the kernels from csrc/_build/).  The CLI's search ids equal
    the library's on the same checkpoint."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import DiskannIndex, QueryParams
    from pgvectorscale_tpu_torch.ops import _build

    phase = "cli"
    # The search subprocess loads the kernels from csrc/_build/: put phase
    # 1's libraries there (same names: a hash of source and flags).
    copied = []
    for rec in _build.build(KERNELS, build_dir=build_dir):
        dst = _build.BUILD_DIR / Path(rec["library"]).name
        if not dst.exists():
            shutil.copy2(rec["library"], dst)
            copied.append(dst)
    out = {"seconds": {}}
    try:
        lines, out["seconds"]["bench"] = run_cli("bench")
        out["bench"] = lines
        widest = max(lines, key=lambda r: r["L"])
        if len(lines) != 3 or widest["recall"] < MIN_RECALL:
            fail(f"{phase}: bench recall {widest['recall']} at L={widest['L']} is below "
                 f"{MIN_RECALL} (or not 3 lines)")
        with tempfile.TemporaryDirectory() as td:
            base, adds, qs = (Path(td) / f for f in ("base.npy", "add.npy", "q.npy"))
            idx = Path(td) / "idx.npz"
            np.save(base, vectors[:CLI_N])
            np.save(adds, vectors[CLI_N : CLI_N + CLI_ADD])
            np.save(qs, queries[:64])
            for cmd in (["build", str(base), "-o", str(idx)], ["info", str(idx)],
                        ["search", str(idx), str(qs), "--show", "64"],
                        ["add", str(idx), str(adds)],
                        ["delete", str(idx), *[str(i) for i in range(0, 10 * CLI_DELETE, 10)]],
                        ["compact", str(idx)], ["info", str(idx)]):
                key = cmd[0] if cmd[0] != "info" or "info" not in out else "info_after"
                lines, out["seconds"][key] = run_cli(*cmd, subprocess_=cmd[0] == "search")
                out[key] = len(lines) if cmd[0] == "search" else lines[-1]
                if cmd[0] == "info":
                    info = lines[-1]
                    if info["reachable"] != info["count"] or info["degrees"]["orphans"]:
                        fail(f"{phase}: info reports {info['reachable']} of {info['count']} "
                             f"reachable, {info['degrees']['orphans']} orphans")
                if cmd[0] == "search":
                    # The library on the same checkpoint, here.
                    index = DiskannIndex.load(idx)
                    ids, _ = index.search(torch.as_tensor(queries[:64]).cuda(), 10,
                                          QueryParams())
                    want = index.to_external(ids).tolist()
                    got = [r["ids"] for r in lines]
                    out["search_equal_to_library"] = got == want
                    del index
            info, after = out["info"], out["info_after"]
            expect = CLI_N + CLI_ADD - CLI_DELETE
            say(f"phase 17 cli: bench {out['bench']}; build of {CLI_N} rows, info "
                f"reachable {info['reachable']}/{info['count']}, search ids equal to the "
                f"library's: {out['search_equal_to_library']}; after add "
                f"{CLI_ADD}, delete {CLI_DELETE}, compact: {after['count']} rows, reachable "
                f"{after['reachable']}, orphans {after['degrees']['orphans']}")
            if not out["search_equal_to_library"]:
                fail(f"{phase}: the CLI's search ids differ from the library's")
            if after["count"] != expect or out["compact"]["after"] != expect:
                fail(f"{phase}: {after['count']} rows after compact, not {expect}")
    finally:
        for dst in copied:
            dst.unlink(missing_ok=True)
    check_deadline(phase)
    return out


def phase_high_dim(counts) -> dict:
    """Phase 18: a 16,000-dim SBQ index (the JAX test's settings: cosine,
    R=16, L=32; 500-word codes) over HD_N low-rank rows, built with
    max_wave HD_MAX_WAVE; recall@10 at each HD_POINTS against
    ``ExactIndex`` (floor HD_MIN_RECALL, the JAX test's, at the last),
    edge_gather launched at W=500 in each search, the peak device
    memory."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.graph.build import MAX_OVERFLOW_ROWS, INCOMING_CAP, _build_max_iters

    phase = "high dim"
    rng = np.random.default_rng(SEED + 18)
    basis = rng.standard_normal((32, HD_DIM)).astype(np.float32)
    vectors = rng.standard_normal((HD_N, 32)).astype(np.float32) @ basis
    queries = rng.standard_normal((HD_QUERIES, 32)).astype(np.float32) @ basis
    config = IndexConfig(num_dimensions=HD_DIM, distance_type=DistanceType.COSINE,
                         num_neighbors=16, search_list_size=32)
    c = _build_max_iters(config.search_list_size)
    r_max = config.max_neighbors_during_build
    out = dict(
        words=config.num_code_words,
        remeasure_bytes=HD_MAX_WAVE * c * HD_DIM * 4,
        overflow_prune_bytes_at_most=MAX_OVERFLOW_ROWS * (r_max + INCOMING_CAP) * HD_DIM * 4,
    )
    say(f"phase 18 {phase}: {HD_N} x {HD_DIM} low-rank rows, W={config.num_code_words}; "
        f"max_wave {HD_MAX_WAVE}: the re-measure and the prune gather a wave x C x d x 4 B "
        f"= {HD_MAX_WAVE} x {c} x {HD_DIM} x 4 = {out['remeasure_bytes']} B of rows (at the "
        f"library's 4,096: {4096 * c * HD_DIM * 4} B); an overflow prune at most "
        f"{out['overflow_prune_bytes_at_most']} B")
    start = counts()
    torch.cuda.reset_peak_memory_stats()
    t = elapsed()
    index = DiskannIndex.build(vectors, config, max_wave=HD_MAX_WAVE)
    torch.cuda.synchronize()
    out.update(build_s=elapsed() - t, build_peak_bytes=torch.cuda.max_memory_allocated())
    out["graph"] = check_graph(index, phase)
    out["build_launches"] = {k: v - start[k] for k, v in counts().items()}
    gt = ground_truth(vectors, queries, config)
    say(f"  {phase}: build {out['build_s']:.2f}s, peak device memory {out['build_peak_bytes']} B, "
        f"{out['graph']}; launches in the build {out['build_launches']}")
    qdev = torch.as_tensor(queries).cuda()
    out["search"] = {}
    for l, rescore in HD_POINTS:
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        t = elapsed()
        ids, dists = index.search(qdev, 10, QueryParams(search_list_size=l, rescore=rescore))
        torch.cuda.synchronize()
        res = dict(seconds=elapsed() - t, peak_bytes=torch.cuda.max_memory_allocated(),
                   recall=recall_at_10(ids, gt),
                   launches={k: v - before[k] for k, v in counts().items()})
        out["search"][f"L={l} rescore={rescore}"] = res
        say(f"  {phase}: search of {HD_QUERIES} queries at L={l}, rescore {rescore}: "
            f"{res['seconds']:.3f}s, recall@10 {res['recall']:.4f}, launches "
            f"{res['launches']}, peak {res['peak_bytes']} B")
        if index.arrays.codes.shape[1] != 500 or res["launches"]["beam_search"] == 0:
            fail(f"{phase}: beam_search did not launch on 500-word codes")
        if not bool(torch.isfinite(dists).all()):
            fail(f"{phase}: a search returned a distance that is not finite")
    if res["recall"] < HD_MIN_RECALL:
        fail(f"{phase}: recall@10 {res['recall']:.4f} at L={l}, rescore {rescore} is below "
             f"{HD_MIN_RECALL}")
    check_deadline(phase)
    return out


def strict_ranks(query_codes, codes, gt, chunk: int = CEILING_CHUNK):
    """For each query and each of its exact top-k rows, the number of rows
    whose code distance to the query is strictly smaller than that row's:
    int64[Q, k].  Each chunk's [chunk, N] distances come from the
    Hamming-matrix kernel (its plain version on the CPU)."""
    import torch

    from pgvectorscale_tpu_torch.ops.hamming_matrix import hamming_matrix

    out = []
    for i in range(0, query_codes.shape[0], chunk):
        d = hamming_matrix(query_codes[i : i + chunk], codes)
        g = torch.gather(d, 1, gt[i : i + chunk].long())
        out.append(torch.stack([(d < g[:, j : j + 1]).sum(dim=1) for j in range(g.shape[1])],
                               dim=1))
        del d
    return torch.cat(out)


def sbq_ceiling(ranks, rescores) -> dict:
    """benchmarks/suite.py ``_sbq_ceiling``: the share of exact top-k rows
    that fewer than rescore + k rows beat, strictly, in code distance (the
    recall of a window of the rescore + k nearest codes under any
    tie-break), for each rescore."""
    k = ranks.shape[1]
    return {r: float((ranks < r + k).double().mean()) for r in rescores}


def phase_sift(counts):
    """Phase 20: benchmarks/suite.py ``run_sift1m`` at SUITE_BITS=4: the
    seeded "sift" corpus (SIFT_N x 128, SIFT_NQ queries), L2, L=100, 4 bits
    a dimension (W = 16), library defaults otherwise, ``refine_passes=1``;
    build seconds (ingest / waves / finalize + refine), launches, peak
    device memory, graph checks; the exact top-10 through ``ExactIndex``;
    then SIFT_POINTS, each held at the record's recall@10 less
    SIFT_RECALL_MARGIN.  Returns (index, corpus, queries on the card,
    exact top-10, results)."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import ExactIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

    t = elapsed()
    vectors, queries = synthetic_corpus("sift", SIFT_N, SIFT_NQ, seed=SIFT_SEED)
    vectors = np.ascontiguousarray(vectors)
    out = dict(corpus_s=elapsed() - t)
    say(f"phase 20 sift 4-bit 1M: corpus sift {vectors.shape} + {queries.shape} queries, seed "
        f"{SIFT_SEED}, made in {out['corpus_s']:.2f}s")
    start = counts()
    torch.cuda.reset_peak_memory_stats()
    index, out["build_s"] = phase_build(
        vectors, "sift build", counts=counts, refine_passes=SIFT_REFINE,
        distance_type=DistanceType.L2, search_list_size=100, num_bits_per_dimension=SIFT_BITS)
    out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["build_launches"] = {k: v - start[k] for k, v in counts().items()}
    w = index.config.num_code_words
    refine_eg = out["build_s"]["launches_after_waves"]["beam_search"]
    say(f"  sift build: W={w}, launches {out['build_launches']} ({refine_eg} beam_search in "
        f"finalize+refine); peak device memory {out['build_peak_bytes']} B")
    if w != 16 or refine_eg == 0:
        fail("sift build: W=16 and beam_search launches in the refinement expected")
    require(out["build_launches"], BUILD_KERNELS, "the sift build")

    phase = "sift search"
    t = elapsed()
    qdev = torch.as_tensor(queries).cuda()
    exact = ExactIndex.build(vectors, IndexConfig(num_dimensions=vectors.shape[1],
                                                  distance_type=DistanceType.L2))
    gt = exact.search(qdev, 10)[0]
    del exact
    torch.cuda.synchronize()
    out["ground_truth_s"] = elapsed() - t
    say(f"  sift ground truth: exact top-10 of {SIFT_NQ} queries over {SIFT_N} rows "
        f"(ExactIndex) in {out['ground_truth_s']:.2f}s")
    out["search"] = {}
    for (l, rescore, e, strategy, vf), record in SIFT_POINTS.items():
        params = QueryParams(search_list_size=l, rescore=rescore, expand=e,
                             window_strategy=strategy, visit_factor=vf)
        name = f"{strategy} L={l} rescore={rescore} E={e} visit_factor={vf}"
        res = search_point(index, qdev, params, gt, name, phase)
        res["record"] = record
        out["search"][name] = res
        say(f"    record (results/sift1m.jsonl) {record:.4f}: port - record "
            f"{res['recall'] - record:+.4f}")
        if res["recall"] < record - SIFT_RECALL_MARGIN:
            fail(f"{phase}: recall@10 {res['recall']:.4f} at {name} is below the record "
                 f"{record} less {SIFT_RECALL_MARGIN}")
    return index, vectors, qdev, gt, out


def phase_ceiling(index, vectors, qdev, gt) -> dict:
    """Phase 20, outside the path: the strict-rank SBQ ceiling of the
    index's 4-bit codes at CEILING_RECORD's rescores (fails off the record
    by more than CEILING_TOL), and of a 2-bit encode of the same corpus
    with the same statistics (no graph) beside it."""
    import torch

    from pgvectorscale_tpu_torch.ops import hamming_matrix, sbq

    before = hamming_matrix.launches
    torch.cuda.synchronize()
    t = elapsed()
    stats, bits = index.sbq_stats, index.config.bits_per_dimension
    ranks = strict_ranks(sbq.encode(qdev, stats, bits), index.arrays.codes[: index.count], gt)
    out = dict(ceiling=sbq_ceiling(ranks, CEILING_RECORD))
    torch.cuda.synchronize()
    out["seconds"] = elapsed() - t
    vdev = torch.from_numpy(vectors).cuda()
    codes2 = torch.cat([sbq.encode(vdev[i : i + (1 << 17)], stats, 2)
                        for i in range(0, vdev.shape[0], 1 << 17)])
    del vdev
    out["ceiling_2bit"] = sbq_ceiling(strict_ranks(sbq.encode(qdev, stats, 2), codes2, gt),
                                      CEILING_RECORD)
    out["hamming_matrix_launches"] = hamming_matrix.launches - before
    for r, rec in CEILING_RECORD.items():
        say(f"  sift ceiling at rescore {r}: {bits}-bit {out['ceiling'][r]:.4f} (record "
            f"{rec}, port - record {out['ceiling'][r] - rec:+.4f}); 2-bit encode "
            f"{out['ceiling_2bit'][r]:.4f} (results/sift1m_2bit_r4.jsonl, one tie-break: "
            f"{CEILING_2BIT_RECORD[r]})")
    say(f"  sift ceiling: {out['seconds']:.2f}s for the {bits}-bit ranks, "
        f"{out['hamming_matrix_launches']} hamming_matrix launches (W=16 and W=8, chunks of "
        f"{CEILING_CHUNK} queries)")
    off = {r: out["ceiling"][r] - rec for r, rec in CEILING_RECORD.items()
           if abs(out["ceiling"][r] - rec) > CEILING_TOL}
    if off:
        fail(f"sift ceiling: off the JAX package's record by more than {CEILING_TOL}: {off}")
    check_deadline("sift search")
    return out


def phase_wide(vectors, queries, counts) -> dict:
    """Phase 21: phase 6's storage build of the 100k corpus at WIDE_BITS
    bits a dimension (W = 192): build seconds, launches (LIFE_KERNELS in
    the build), peak device memory, graph checks; phase 4's searches
    (recall floor MIN_RECALL at rescore 300)."""
    import torch

    out = {}
    start = counts()
    torch.cuda.reset_peak_memory_stats()
    index, out["build_s"] = phase_build(vectors, "8-bit build", build_distance="storage",
                                        num_bits_per_dimension=WIDE_BITS)
    out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["build_launches"] = {k: v - start[k] for k, v in counts().items()}
    w = index.config.num_code_words
    say(f"  8-bit build: W={w}, launches {out['build_launches']}; peak device memory "
        f"{out['build_peak_bytes']} B")
    if w != DIM * WIDE_BITS // 32:
        fail("8-bit build: W=192 expected")
    require(out["build_launches"], LIFE_KERNELS, "the 8-bit build")
    out["search"], out["search_peak_bytes"] = phase_search(index, vectors, queries,
                                                           "8-bit search")
    return out


def sync_all() -> None:
    """Synchronize every card (a mesh may span them)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_cards(mesh) -> list:
    """The distinct cards a mesh's positions are on."""
    return sorted({str(d) for d in mesh.devices.ravel()})


def check_shards(index, label: str) -> str:
    """Every shard: full reachability from its start node, degree <= r_max,
    and every tensor on its mesh position's device, or fail."""
    import torch

    from pgvectorscale_tpu_torch.graph.build import reachable_on_device

    r_max = index.config.max_neighbors_during_build
    parts = []
    for p, (arrays, dev) in enumerate(zip(index.shards, index.mesh.devices.ravel())):
        for f, t in zip(arrays._fields, arrays):
            if isinstance(t, torch.Tensor) and t.device != dev:
                fail(f"{label}: shard {p}'s {f} is on {t.device}, its position on {dev}")
        n = arrays.count
        reach = int(reachable_on_device(arrays)[:n].sum())
        deg = (arrays.adjacency[:n] != -1).sum(dim=1)
        if reach != n:
            fail(f"{label}: shard {p} has {n - reach} unreachable rows")
        if int(deg.max()) > r_max:
            fail(f"{label}: shard {p}'s max degree {int(deg.max())} exceeds r_max {r_max}")
        parts.append(f"{reach}/{n} reachable, degree {int(deg.min())}..{int(deg.max())}")
    return (f"every shard's tensors on its position's device; per shard: "
            f"{'; '.join(parts)} (r_max {r_max})")


def phase_sharded_scale(vectors, queries, single: dict, counts) -> dict:
    """Phase 19, scale: phase 13's config over ``vectors`` (the first
    SHARD_N rows of its corpus) row-sharded over SHARDS mesh positions
    (``ShardedDiskannIndex.build``; one shard a card where there are SHARDS
    cards, else all on cuda:0): seconds, peak device memory of each card,
    the shards' graph checks and placement; then SHARD_POINTS, recall@10
    of the external ids against the exact top-10 over these rows
    (``ExactIndex``), held at phase 13's single-device recall over 1M rows
    at the same point minus SHARD_RECALL_MARGIN; QPS best of 3;
    beam_search launched."""
    import torch

    from pgvectorscale_tpu_torch import ExactIndex, IndexConfig, QueryParams, ShardedDiskannIndex
    from pgvectorscale_tpu_torch.ops import beam_search
    from pgvectorscale_tpu_torch.parallel.mesh import make_mesh

    phase = "sharded build"
    mesh = make_mesh(SHARDS, axis_name="n")
    cards = mesh_cards(mesh)
    out = dict(positions=[str(d) for d in mesh.devices.ravel()], distinct_cards=len(cards))
    say(f"phase 19 sharded: a mesh of {SHARDS} positions {out['positions']} on "
        f"{len(cards)} distinct card(s)" + ("" if len(cards) > 1 else
                                          ": shards run one after another on the card"))
    config = IndexConfig(num_dimensions=DIM, num_bits_per_dimension=1, vector_dtype="int8")
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    start = counts()
    sync_all()
    t = elapsed()
    index = ShardedDiskannIndex.build(vectors, config, mesh, max_wave=4096)
    sync_all()
    total = elapsed() - t
    bs = index.build_stats
    out["build_s"] = dict(ingest_s=total - bs.insert_s - bs.finalize_s, waves_s=bs.insert_s,
                          finalize_s=bs.finalize_s, total_s=total)
    out["waves"] = bs.num_waves
    out["build_peak_bytes"] = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    out["build_launches"] = {k: v - start[k] for k, v in counts().items()}
    out["graph"] = check_shards(index, phase)
    say(f"  sharded build: {index.count} rows, {SHARDS} x {index.shard_capacity} slots; "
        f"train + ingest {out['build_s']['ingest_s']:.2f}s, {bs.num_waves} waves a shard "
        f"{bs.insert_s:.2f}s, finalize {bs.finalize_s:.2f}s; peak device memory "
        f"{out['build_peak_bytes']}; launches {out['build_launches']}; {out['graph']}")
    require(out["build_launches"], BUILD_KERNELS, "the sharded build")
    check_deadline(phase)

    phase = "sharded search"
    qdev = torch.as_tensor(queries).cuda()
    gt = ExactIndex.build(vectors, config).search(qdev, 10)[0]
    torch.cuda.empty_cache()
    out["search"] = {}
    for l, rescore, e, strategy, vf in SHARD_POINTS:
        params = QueryParams(search_list_size=l, rescore=rescore, expand=e,
                             window_strategy=strategy, visit_factor=vf)
        name = f"{strategy} L={l} rescore={rescore} E={e} visit_factor={vf}"
        before = beam_search.launches
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        secs = []
        for _ in range(3):
            sync_all()
            t0 = time.perf_counter()
            ids, dists = index.search(qdev, 10, params)
            sync_all()
            secs.append(time.perf_counter() - t0)
        ext = torch.from_numpy(index.to_external(ids)).to(qdev.device)
        s_ext = torch.sort(ext, dim=1).values
        if (ids.shape != (NQ, 10) or not bool(torch.isfinite(dists).all())
                or bool((ext < 0).any()) or bool((s_ext[:, 1:] == s_ext[:, :-1]).any())):
            fail(f"{phase}: {name} returned invalid results")
        recall = recall_at_10(ext, gt)
        floor = single[name]["recall"] - SHARD_RECALL_MARGIN
        stats = index.last_search_stats
        res = dict(recall=recall, floor=floor, single_recall=single[name]["recall"],
                   qps=NQ / min(secs), seconds=secs,
                   peak_bytes={c: torch.cuda.max_memory_allocated(c) for c in cards},
                   beam_search_launches=beam_search.launches - before,
                   iters=stats.iterations, visits_per_query=stats.total_visits / NQ)
        out["search"][name] = res
        say(f"  sharded {name}: recall@10 {recall:.4f} (phase 13, one device: "
            f"{res['single_recall']:.4f}; floor {floor:.4f}), QPS {res['qps']:.1f} (best of "
            f"{[round(s, 4) for s in secs]} s; phase 13: {single[name]['qps']:.1f}), "
            f"{res['visits_per_query']:.1f} visits a query over the shards, "
            f"{res['iters']} iterations at most, beam_search launches "
            f"{res['beam_search_launches']}, peak {res['peak_bytes']}")
        if res["beam_search_launches"] == 0:
            fail(f"{phase}: {name} did not launch beam_search")
        if recall < floor:
            fail(f"{phase}: recall@10 {recall:.4f} at {name} is below phase 13's "
                 f"{res['single_recall']:.4f} - {SHARD_RECALL_MARGIN}")
        check_deadline(phase)
    del index
    torch.cuda.empty_cache()
    return out


def phase_sharded_life_cycle(vectors, queries, counts) -> dict:
    """Phase 19, life cycle: phase 7's storage config and sizes on the
    SHARDS-position mesh: build, 8 adds, delete 10% through
    ``delete_external``, a reuse add onto tombstones (a reader's shards
    untouched), searches (no deleted row; the recall floor over the live
    rows), a short ``search_iter`` stream (no id twice, no deleted id),
    save -> load bit-equal, compact (the live external ids kept); then
    ``create_index`` on the mesh, whose index takes ``enable_durability``
    over two adds and a delete that ``load`` replays bit-equal.  Both
    kernels must launch."""
    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import (ExactIndex, IndexConfig, QueryParams,
                                         ShardedDiskannIndex, create_index)
    from pgvectorscale_tpu_torch.parallel.mesh import make_mesh

    phase = "sharded life cycle"
    mesh = make_mesh(SHARDS, axis_name="n")
    config = IndexConfig(num_dimensions=DIM, build_distance="storage")
    out = {}
    start = counts()
    t = elapsed()
    index = ShardedDiskannIndex.build(vectors[:LC_BUILD], config, mesh)
    sync_all()
    out["build_s"] = elapsed() - t
    out["build_launches"] = {k: v - start[k] for k, v in counts().items()}
    if out["build_launches"]["hamming_matrix"] == 0:
        fail(f"{phase}: the shards' seed waves did not launch hamming_matrix")
    pos = LC_BUILD
    t = elapsed()
    for _ in range(LC_BATCHES):
        index.add(vectors[pos : pos + LC_BATCH])
        pos += LC_BATCH
        check_deadline(phase)
    sync_all()
    out["adds_s"] = elapsed() - t
    say(f"  {phase}: built {LC_BUILD} rows over {SHARDS} shards in {out['build_s']:.2f}s "
        f"(launches {out['build_launches']}), added {LC_BATCHES} x {LC_BATCH} in "
        f"{out['adds_s']:.2f}s; {check_shards(index, phase)}")

    rng = np.random.default_rng(SEED)
    doomed = rng.choice(np.concatenate(index.external_ids), int(LC_DELETE * index.count),
                        replace=False)
    index.delete_external(doomed)
    count0, deleted0, held = index.count, index.num_deleted, index.shards
    held_sums = [{f: checksum(v) for f, v in zip(a._fields, a) if isinstance(v, torch.Tensor)}
                 for a in held]
    t = elapsed()
    index.add(vectors[pos : pos + LC_REUSE])
    sync_all()
    out["reuse_add_s"] = elapsed() - t
    pos += LC_REUSE
    if index.count != count0 or index.num_deleted != deleted0 - LC_REUSE:
        fail(f"{phase}: the reuse add did not land on {LC_REUSE} tombstones")
    if index.shards is held or held_sums != [
            {f: checksum(v) for f, v in zip(a._fields, a) if isinstance(v, torch.Tensor)}
            for a in held]:
        fail(f"{phase}: the reuse add wrote a reader's shards or published none")
    # External ids are the input rows' positions (build and add number
    # them on).
    all_ext = np.concatenate([e[~index._deleted_np[s, : len(e)]]
                              for s, e in enumerate(index.external_ids)])
    live = np.zeros(pos, dtype=bool)
    live[all_ext] = True
    say(f"  {phase}: deleted {len(doomed)} rows by external id, added {LC_REUSE} onto "
        f"tombstones in {out['reuse_add_s']:.2f}s; a reader's shards unchanged; "
        f"{index.num_live} live; {check_shards(index, phase)}")

    live_rows = np.nonzero(live)[0]
    exact = ExactIndex.build(vectors[live_rows], config)
    gt = torch.from_numpy(live_rows).cuda()[exact.search(queries, 10)[0].long()]
    del exact
    qdev = torch.as_tensor(queries).cuda()
    searches = {}
    for rescore in (50, 300):
        ids, dists = index.search(qdev, 10, QueryParams(search_list_size=100, rescore=rescore))
        ext = index.to_external(ids)
        if ids.shape != (NQ, 10) or not bool(torch.isfinite(dists).all()) or (ext < 0).any():
            fail(f"{phase}: search at rescore {rescore} returned invalid results")
        if not live[ext].all():
            fail(f"{phase}: a search returned a deleted row")
        searches[rescore] = (ids, dists)
        out[f"recall_{rescore}"] = recall_at_10(torch.from_numpy(ext).cuda(), gt)
    say(f"  {phase}: recall@10 over {index.num_live} live rows {out['recall_50']:.4f} "
        f"(rescore 50), {out['recall_300']:.4f} (rescore 300); no deleted row returned")
    if out["recall_300"] < MIN_RECALL:
        fail(f"{phase}: recall@10 at rescore 300 is below {MIN_RECALL}")

    it = index.search_iter(queries[0], QueryParams(search_list_size=100, rescore=50))
    stream = [g for g, _ in itertools.islice(it, SHARD_STREAM)]
    s_ext = index.to_external(np.asarray(stream))
    out["stream_rows"] = len(stream)
    if len(stream) != SHARD_STREAM or len(set(stream)) != len(stream) or not live[s_ext].all():
        fail(f"{phase}: the sharded stream yielded an id twice, a deleted id or too few rows")

    with tempfile.TemporaryDirectory() as td:
        t = elapsed()
        index.save(Path(td) / "sharded")
        out["save_s"] = elapsed() - t
        out["checkpoint_bytes"] = (Path(td) / "sharded.npz").stat().st_size
        t = elapsed()
        loaded = ShardedDiskannIndex.load(Path(td) / "sharded", mesh)
        sync_all()
        out["load_s"] = elapsed() - t
        ids2, dists2 = loaded.search(qdev, 10, QueryParams(search_list_size=100, rescore=300))
        if not (torch.equal(ids2, searches[300][0]) and torch.equal(dists2, searches[300][1])):
            fail(f"{phase}: the loaded index searches differently")
        del loaded
        t = elapsed()
        compacted = index.compact()
        sync_all()
        out["compact_s"] = elapsed() - t
        if (compacted.count != index.num_live
                or set(np.concatenate(compacted.external_ids).tolist()) != set(all_ext.tolist())):
            fail(f"{phase}: compact did not keep the live external ids")
        say(f"  {phase}: stream of {SHARD_STREAM} rows, no id twice, none deleted; save "
            f"{out['save_s']:.2f}s ({out['checkpoint_bytes']} B), load {out['load_s']:.2f}s, "
            f"searches bit-equal; compact to {compacted.count} rows in "
            f"{out['compact_s']:.2f}s, {check_shards(compacted, phase)}")
        del index, compacted

        made = create_index(vectors[:LC_BUILD], config, mesh=mesh)
        if not isinstance(made, ShardedDiskannIndex) or made.mesh is not mesh:
            fail(f"{phase}: create_index did not build a ShardedDiskannIndex on the mesh")
        path = Path(td) / "durable"
        t = elapsed()
        made.enable_durability(path)
        out["durable_checkpoint_s"] = elapsed() - t
        for _ in range(2):
            made.add(vectors[pos : pos + LC_BATCH])
            pos += LC_BATCH
        made.delete_external(np.arange(0, LC_BUILD, 7))
        records = len(made._journal)
        t = elapsed()
        replayed = ShardedDiskannIndex.load(path, mesh)
        sync_all()
        out["replay_s"] = elapsed() - t
        same = dict(count=replayed.count == made.count, num_live=replayed.num_live == made.num_live)
        for rescore in (50, 300):
            p = QueryParams(search_list_size=100, rescore=rescore)
            a, da = replayed.search(qdev, 10, p)
            b, db = made.search(qdev, 10, p)
            same[f"search_{rescore}"] = torch.equal(a, b) and torch.equal(da, db)
        out["replay_equal"] = same
        say(f"  {phase}: create_index on the mesh built a ShardedDiskannIndex of {LC_BUILD} "
            f"rows; enable_durability checkpoint {out['durable_checkpoint_s']:.2f}s; "
            f"{records} journal records (two adds of {LC_BATCH}, a delete) replayed by load "
            f"in {out['replay_s']:.2f}s: {same}")
        if records != 3 or not all(same.values()):
            fail(f"{phase}: the replayed index differs from the live one: {same}")
        del replayed, made
    check_deadline(phase)
    return out


_SHARDED_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from pgvectorscale_tpu_torch.ops import _build
for name in ("edge_gather", "hamming_matrix", "beam_search", "prune_scan"):
    _build.load(name, build_dir=sys.argv[2])
from pgvectorscale_tpu_torch import IndexConfig, QueryParams, ShardedDiskannIndex
from pgvectorscale_tpu_torch.parallel import multihost

assert multihost.initialize_from_env()
rank, size = multihost.world()
mesh = multihost.global_mesh(axis_name="n")
vectors = np.load(sys.argv[3])
queries = np.load(sys.argv[4])
index = ShardedDiskannIndex.build(vectors, IndexConfig(num_dimensions=vectors.shape[1],
                                                       build_distance="storage"), mesh)
assert [s is not None for s in index.shards] == [p == rank for p in range(size)]
ids, dists = index.search(torch.from_numpy(queries).cuda(), 10,
                          QueryParams(search_list_size=100, rescore=300))
np.savez(sys.argv[5] + f"/rank{rank}.npz", ids=ids.cpu().numpy(), dists=dists.cpu().numpy())
torch.distributed.destroy_process_group()
print(json.dumps({"rank": rank, "positions": [str(d) for d in mesh.devices.ravel()]}))
"""


def phase_sharded_processes(vectors, queries, build_dir: Path) -> dict:
    """Phase 19, processes: where the machine has two cards or more, two
    processes (one card each) join an ``nccl`` world from the PGVS_TPU_*
    variables, each builds its own shard of phase 19's life-cycle rows
    and searches; both must return the single-process 2-position index's
    ids and distances.  With one card it is not run (NCCL takes one rank
    a card; tests/test_torch_mesh.py runs the path with ``gloo``)."""
    import socket

    import numpy as np
    import torch

    from pgvectorscale_tpu_torch import IndexConfig, QueryParams, ShardedDiskannIndex
    from pgvectorscale_tpu_torch.parallel.mesh import make_mesh

    phase = "sharded processes"
    if torch.cuda.device_count() < 2:
        say(f"phase 19 {phase}: not run: one card, and NCCL takes one rank a card "
            f"(tests/test_torch_mesh.py runs four gloo processes on the CPU)")
        return dict(run=False)
    n = LC_BUILD + LC_BATCHES * LC_BATCH
    with tempfile.TemporaryDirectory() as td, socket.socket() as sock:
        np.save(Path(td) / "rows.npy", vectors[:n])
        np.save(Path(td) / "queries.npy", queries)
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        procs = []
        t = elapsed()
        for rank in range(2):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(rank),
                       PGVS_TPU_COORDINATOR=f"localhost:{port}",
                       PGVS_TPU_PROCESS_ID=str(rank), PGVS_TPU_NUM_PROCESSES="2")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SHARDED_CHILD, str(ROOT), str(build_dir),
                 str(Path(td) / "rows.npy"), str(Path(td) / "queries.npy"), td],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=max(DEADLINES[phase] - elapsed(), 1))
                    for p in procs]
        except subprocess.TimeoutExpired:
            outs = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if outs is None:
            fail(f"{phase}: the processes did not end before the phase's deadline")
        for p, (o, e) in zip(procs, outs):
            if p.returncode != 0:
                fail(f"{phase}: a process ended with {p.returncode}: {e[-3000:]}")
        secs = elapsed() - t
        mesh = make_mesh(2, axis_name="n")
        index = ShardedDiskannIndex.build(
            vectors[:n], IndexConfig(num_dimensions=DIM, build_distance="storage"), mesh)
        ids, dists = index.search(torch.as_tensor(queries).cuda(), 10,
                                  QueryParams(search_list_size=100, rescore=300))
        same = []
        for rank in range(2):
            with np.load(Path(td) / f"rank{rank}.npz") as z:
                same.append(bool(np.array_equal(z["ids"], ids.cpu().numpy())
                                 and np.array_equal(z["dists"], dists.cpu().numpy())))
    say(f"phase 19 {phase}: 2 nccl processes, one card each, {n} rows in 2 shards: build + "
        f"search in {secs:.2f}s (start-up included); each equal to the one-process "
        f"2-card index: {same}")
    if not all(same):
        fail(f"{phase}: the processes' search differs from one process's")
    check_deadline(phase)
    return dict(run=True, seconds=secs, equal=same)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only-sharded"], ["--only-tiers"]):
        print("usage: chip_smoke.py [--only-sharded | --only-tiers]", file=sys.stderr)
        return 2
    only = argv[0] if argv else None
    if not (ROOT / "pgvectorscale_tpu_torch").is_dir():
        print("chip_smoke.py: the pgvectorscale_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from pgvectorscale_tpu_torch.config import StorageLayout
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
    from pgvectorscale_tpu_torch.ops import (_build, beam_search, edge_gather, hamming_matrix,
                                             prune_scan)

    modules = {"edge_gather": edge_gather, "hamming_matrix": hamming_matrix,
               "beam_search": beam_search, "prune_scan": prune_scan}

    def reset_counts() -> None:
        for m in modules.values():
            m.launches = 0

    def read_counts() -> dict:
        return {k: m.launches for k, m in modules.items()}

    def run_tiers(vectors, queries, two_bit=None) -> dict:
        """Phases 20 and 21, each path counted from 0; ``two_bit``: phase
        6's searches, printed beside phase 21's."""
        reset_counts()  # the sift 4-bit 1M path starts here
        sift_index, sift_vectors, sift_q, sift_gt, sift = phase_sift(read_counts)
        paths["sift 4-bit 1M"] = read_counts()  # the sift 4-bit 1M path ends here
        peaks["sift build"] = sift["build_peak_bytes"]
        peaks["sift search"] = max(v["peak_bytes"] for v in sift["search"].values())
        say(f"phase 20 sift 4-bit 1M: launches {paths['sift 4-bit 1M']} "
            f"({sift['build_launches']} in the build); peak device memory of the build "
            f"{peaks['sift build']} B, of a search up to {peaks['sift search']} B")
        sift["ceiling"] = phase_ceiling(sift_index, sift_vectors, sift_q, sift_gt)  # outside
        del sift_index, sift_vectors, sift_q, sift_gt
        torch.cuda.empty_cache()

        reset_counts()  # the 8-bit storage path starts here
        wide = phase_wide(vectors, queries, read_counts)
        paths["8-bit storage 100k"] = read_counts()  # the 8-bit storage path ends here
        peaks["8-bit build"] = wide["build_peak_bytes"]
        peaks["8-bit search"] = wide["search_peak_bytes"]
        beside = ("not run" if two_bit is None else
                  f"{two_bit[50]['recall']:.4f} / {two_bit[300]['recall']:.4f}")
        say(f"phase 21 8-bit storage 100k: recall@10 {wide['search'][50]['recall']:.4f} "
            f"(rescore 50), {wide['search'][300]['recall']:.4f} (rescore 300); phase 6, 2 "
            f"bits: {beside}; launches {paths['8-bit storage 100k']}; peak device memory "
            f"of the build {peaks['8-bit build']} B")
        torch.cuda.empty_cache()
        return {"sift_4bit_1m": sift,
                "wide_8bit_100k": {**wide, "search": {str(k): v for k, v in
                                                      wide["search"].items()}}}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi_line, card = phase_device()

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    build_dir = Path(tempfile.mkdtemp(prefix="cold-", dir=_build.BUILD_DIR))
    paths = {}  # path -> launches per kernel, counted from 0 around the path
    peaks = {}  # path -> torch.cuda.max_memory_allocated(), reset at its start
    try:
        phase_kernel_build(build_dir)
        cap_main = ((N + 1023) // 1024) * 1024
        timing = phase_kernel_check(cap_main, card)
        tier_widths = check_tier_widths(card)

        vectors, queries = synthetic_corpus("cohere", N, NQ, seed=SEED)
        vectors = np.ascontiguousarray(vectors)
        say(f"  corpus: cohere {vectors.shape} + {queries.shape} queries, seed {SEED}")
        if only == "--only-tiers":
            summary = {"card": card, "launches_by_path": paths, "tier_widths_ms": tier_widths,
                       **run_tiers(vectors, queries), "peak_memory_bytes": peaks,
                       "elapsed_s": elapsed()}
        elif only == "--only-sharded":
            reset_counts()  # the int8 scale path starts here
            s_index, scale_vectors, s_queries, _, _, _, scale = phase_scale(read_counts)
            paths["int8 scale"] = read_counts()  # the int8 scale path ends here
            del s_index
            torch.cuda.empty_cache()
            summary = {"card": card, "launches_by_path": paths, "int8_scale": scale}
        else:
            reset_counts()  # the exact-prune path starts here
            torch.cuda.reset_peak_memory_stats()
            index, build_times = phase_build(vectors, "build", build_distance="exact-prune")
            peaks["exact-prune build"] = torch.cuda.max_memory_allocated()
            in_build = read_counts()
            say(f"phase 3 build: launches {in_build}; peak device memory "
                f"{peaks['exact-prune build']} B")
            build_stats = check_build_stats(index, "phase 3 build")
            search, peaks["exact-prune search"] = phase_search(index, vectors, queries, "search")
            trace = check_trace(index, queries)
            paths["exact-prune"] = read_counts()  # the exact-prune path ends here
            in_search = {k: paths["exact-prune"][k] - in_build[k] for k in in_build}
            say(f"phase 4 search: recall@10 {search[50]['recall']:.4f} (rescore 50), "
                f"{search[300]['recall']:.4f} (rescore 300); launches {in_build} in the "
                f"build, {in_search} in the searches")
            require(in_build, BUILD_KERNELS, "the exact-prune build")
            require(in_search, ("beam_search",), "the exact-prune searches")
            loops = phase_loops_agreement(index, queries)
            phase_agreement(index, queries)
            search_stats = phase_search_stats(index, queries)

            reset_counts()  # the windows path starts here
            windows = phase_windows(index, vectors, queries)
            paths["windows"] = read_counts()  # the windows path ends here
            peaks["windows"] = max(w["peak_bytes"] for w in windows.values())
            say(f"phase 5b windows: launches {paths['windows']}; peak device memory of a "
                f"search up to {peaks['windows']} B")
            debug_helpers = phase_debug_helpers(index)
            del index
            torch.cuda.empty_cache()

            reset_counts()  # the storage path starts here
            torch.cuda.reset_peak_memory_stats()
            s_index, s_build_times = phase_build(vectors, "storage build", build_distance="storage")
            peaks["storage build"] = torch.cuda.max_memory_allocated()
            s_in_build = read_counts()
            say(f"phase 6 storage build: launches {s_in_build}; peak device memory "
                f"{peaks['storage build']} B")
            s_search, peaks["storage search"] = phase_search(
                s_index, vectors, queries, "storage search")
            paths["storage"] = read_counts()  # the storage path ends here
            say(f"phase 6 storage search: recall@10 {s_search[50]['recall']:.4f} "
                f"(rescore 50), {s_search[300]['recall']:.4f} (rescore 300); "
                f"launches {paths['storage']}")
            require(s_in_build, LIFE_KERNELS, "the storage build")
            del s_index
            torch.cuda.empty_cache()

            reset_counts()  # the life-cycle path starts here
            torch.cuda.reset_peak_memory_stats()
            life, life_snap = phase_life_cycle(vectors, queries)
            paths["life cycle"] = read_counts()  # the life-cycle path ends here
            peaks["life cycle"] = torch.cuda.max_memory_allocated()
            say(f"phase 7 life cycle: launches {paths['life cycle']}; peak device memory "
                f"{peaks['life cycle']} B")
            require(paths["life cycle"], LIFE_KERNELS, "the life cycle")
            torch.cuda.empty_cache()

            reset_counts()  # the refine path starts here
            torch.cuda.reset_peak_memory_stats()
            r_index, r_build_times = phase_build(vectors, "refine build", counts=read_counts,
                                                 refine_passes=1, build_distance="exact-prune")
            peaks["refine build"] = torch.cuda.max_memory_allocated()
            r_search, peaks["refine search"] = phase_search(r_index, vectors, queries,
                                                            "refine search")
            paths["refine"] = read_counts()  # the refine path ends here
            in_refine = r_build_times["launches_after_waves"]["beam_search"]
            say(f"phase 8 refine: recall@10 {r_search[300]['recall']:.4f} at rescore 300 "
                f"(unrefined build {search[300]['recall']:.4f}), {r_search[50]['recall']:.4f} at "
                f"rescore 50 (unrefined {search[50]['recall']:.4f}); launches {paths['refine']}, "
                f"beam_search {in_refine} in finalize+refine; peak device memory "
                f"{peaks['refine build']} B")
            if in_refine == 0:
                fail("the refinement pass did not launch beam_search")
            del r_index
            torch.cuda.empty_cache()

            reset_counts()  # the exact path starts here
            exact = phase_exact(vectors, queries, read_counts)
            paths["exact"] = read_counts()  # the exact path ends here
            peaks.update({f"exact {k[:-11]}": exact[k] for k in
                          ("build_peak_bytes", "search_peak_bytes", "add_peak_bytes")})
            say(f"phase 9 exact: recall@10 {exact['search'][50]['recall']:.4f} (rescore 50), "
                f"{exact['search'][300]['recall']:.4f} (rescore 300); launches {paths['exact']}; "
                f"peak device memory of the build {exact['build_peak_bytes']} B")
            torch.cuda.empty_cache()

            reset_counts()  # the plain path starts here
            torch.cuda.reset_peak_memory_stats()
            p_index, p_build_times = phase_build(vectors, "plain build",
                                                 storage_layout=StorageLayout.PLAIN)
            peaks["plain build"] = torch.cuda.max_memory_allocated()
            p_search, peaks["plain search"] = phase_search(p_index, vectors, queries,
                                                           "plain search", rescores=(50,))
            paths["plain"] = read_counts()  # the plain path ends here
            say(f"phase 10 plain: recall@10 {p_search[50]['recall']:.4f} at L=100; launches "
                f"{paths['plain']}; peak device memory of the build {peaks['plain build']} B")
            if any(paths["plain"][k] for k in ("edge_gather", "hamming_matrix", "beam_search")):
                fail("the plain path launched a Hamming kernel")
            require(paths["plain"], ("prune_scan",), "the plain path")
            gather_dot = time_gather_dot(p_index)
            del p_index
            torch.cuda.empty_cache()

            reset_counts()  # the filtered path starts here
            filtered = phase_filtered(vectors, queries, read_counts)
            paths["filtered"] = filtered["launches"]  # read before its agreement check
            peaks["filtered build"] = filtered["build_peak_bytes"]
            peaks["filtered search"] = max(v["peak_bytes"] for v in filtered["search"].values())
            point = "L={} rescore={} E={}".format(*FILTER_POINTS[-1])
            say(f"phase 11 filtered: recall@10 {filtered['search']['1-label ' + point]['recall']:.4f} "
                f"(1 label), {filtered['search']['2-label ' + point]['recall']:.4f} (2 labels) at "
                f"{point}; launches {paths['filtered']} ({filtered['build_launches']} in the "
                f"build); peak device memory of the build {peaks['filtered build']} B")
            torch.cuda.empty_cache()

            reset_counts()  # the filtered life-cycle path starts here
            torch.cuda.reset_peak_memory_stats()
            f_life = phase_filtered_life_cycle(vectors, queries)
            paths["filtered life cycle"] = read_counts()  # the filtered life cycle ends here
            peaks["filtered life cycle"] = torch.cuda.max_memory_allocated()
            say(f"phase 12 filtered life cycle: launches {paths['filtered life cycle']}; peak "
                f"device memory {peaks['filtered life cycle']} B")
            require(paths["filtered life cycle"], LIFE_KERNELS, "the filtered life cycle")
            torch.cuda.empty_cache()

            reset_counts()  # the int8 scale path starts here
            s_index, scale_vectors, s_queries, flag, filtered_gt, _, scale = phase_scale(
                read_counts)
            paths["int8 scale"] = read_counts()  # the int8 scale path ends here
            peaks["int8 build"] = scale["build_peak_bytes"]
            peaks["int8 search"] = max(v["peak_bytes"] for v in scale["search"].values())
            say(f"phase 13 int8 scale: launches {paths['int8 scale']} "
                f"({scale['build_launches']} in the build); peak device memory of the build "
                f"{peaks['int8 build']} B, of a search up to {peaks['int8 search']} B")
            tiers = phase_rescore_tiers()  # outside the path

            reset_counts()  # the stream path starts here
            torch.cuda.reset_peak_memory_stats()
            stream = phase_stream(s_index, s_queries, flag, filtered_gt)
            paths["stream"] = read_counts()  # the stream path ends here
            peaks["stream"] = torch.cuda.max_memory_allocated()
            say(f"phase 14 stream: launches {paths['stream']}; peak device memory "
                f"{peaks['stream']} B")
            graph_1m = download_graph(s_index)
            del s_index
            torch.cuda.empty_cache()

            reset_counts()  # the int8 life-cycle path starts here
            torch.cuda.reset_peak_memory_stats()
            i_life, _ = phase_life_cycle(vectors, queries, phase="int8 life cycle",
                                         vector_dtype="int8")
            paths["int8 life cycle"] = read_counts()  # the int8 life cycle ends here
            peaks["int8 life cycle"] = torch.cuda.max_memory_allocated()
            say(f"phase 15 int8 life cycle: launches {paths['int8 life cycle']}; peak device "
                f"memory {peaks['int8 life cycle']} B")
            require(paths["int8 life cycle"], LIFE_KERNELS, "the int8 life cycle")
            torch.cuda.empty_cache()

            reset_counts()  # the durable life-cycle path starts here
            torch.cuda.reset_peak_memory_stats()
            durable = phase_durable(vectors, queries, build_dir, life_snap, read_counts)
            paths["durable life cycle"] = read_counts()  # the durable life cycle ends here
            peaks["durable life cycle"] = torch.cuda.max_memory_allocated()
            say(f"phase 16 durable life cycle: launches {paths['durable life cycle']} "
                f"({durable['replay_launches']} in the replay); peak device memory "
                f"{peaks['durable life cycle']} B")
            torch.cuda.empty_cache()

            reset_counts()  # the host graph and tools path starts here
            host_graph = phase_host_graph(graph_1m)
            del graph_1m
            cli = phase_cli(vectors, queries, build_dir)
            paths["host graph and tools"] = read_counts()  # the path ends here
            say(f"phase 17 host graph and tools: launches {paths['host graph and tools']} (the "
                f"CLI's commands in this process and the library's search of its checkpoint; the "
                f"search subprocess counts its own)")
            require(paths["host graph and tools"], ("beam_search",), "phase 17")
            torch.cuda.empty_cache()

            reset_counts()  # the high-dim path starts here
            high_dim = phase_high_dim(read_counts)
            paths["high dim"] = read_counts()  # the high-dim path ends here
            peaks["high dim build"] = high_dim["build_peak_bytes"]
            say(f"phase 18 high dim: launches {paths['high dim']}")
            tiers = run_tiers(vectors, queries, s_search)
            summary = {
                "card": card, "launches_by_path": paths,
                "kernel_timing_shapes": {k: timing[k]["shape"] for k in KERNELS},
                "kernel_bounds": {k: timing[k]["bound_how"] for k in KERNELS},
                "edge_gather_by_q": timing["edge_gather"]["by_q"],
                "beam_search_build_wave": timing["beam_search"]["build_wave"],
                "chain_ms": {k: timing[k]["chain_ms"] for k in BUILD_KERNELS},
                "loops_agreement": loops,
                "hamming_matrix_yardsticks_ms": timing["hamming_matrix"]["yardsticks_ms"],
                "peak_memory_bytes": peaks,
                "build_s": build_times, "search": {str(k): v for k, v in search.items()},
                "storage_build_s": s_build_times,
                "storage_search": {str(k): v for k, v in s_search.items()},
                "life_cycle": life, "windows": windows,
                "refine_build_s": r_build_times,
                "refine_search": {str(k): v for k, v in r_search.items()},
                "exact": {**exact, "search": {str(k): v for k, v in exact["search"].items()}},
                "plain_build_s": p_build_times,
                "plain_search": {str(k): v for k, v in p_search.items()},
                "gather_dot_ms": gather_dot,
                "filtered": filtered, "filtered_life_cycle": f_life,
                "int8_scale": scale, "rescore_tiers": tiers, "stream": stream,
                "int8_life_cycle": i_life,
                "build_stats": build_stats, "search_trace": trace, "search_stats": search_stats,
                "durable_life_cycle": durable, "host_graph": host_graph, "cli": cli,
                "debug_helpers": debug_helpers, "high_dim": high_dim,
                "tier_widths_ms": tier_widths, **tiers,
                "elapsed_s": elapsed(),
            }

        if only != "--only-tiers":
            reset_counts()  # the sharded scale path starts here
            sharded = phase_sharded_scale(scale_vectors[:SHARD_N], s_queries, scale["search"],
                                          read_counts)
            paths["sharded scale"] = read_counts()  # the sharded scale path ends here
            say(f"phase 19 sharded scale: launches {paths['sharded scale']}")
            del scale_vectors
            torch.cuda.empty_cache()
            reset_counts()  # the sharded life-cycle path starts here
            sharded["life_cycle"] = phase_sharded_life_cycle(vectors, queries, read_counts)
            paths["sharded life cycle"] = read_counts()  # the sharded life cycle ends here
            say(f"phase 19 sharded life cycle: launches {paths['sharded life cycle']}")
            require(paths["sharded life cycle"], LIFE_KERNELS, "the sharded life cycle")
            torch.cuda.empty_cache()
            sharded["processes"] = phase_sharded_processes(vectors, queries, build_dir)
            summary.update(sharded=sharded, elapsed_s=elapsed())
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)

    replaces = {"edge_gather": "pgvectorscale_tpu/ops/pallas_hamming.py:183",
                "hamming_matrix": "pgvectorscale_tpu/ops/pallas_hamming.py:52",
                "beam_search": "pgvectorscale_tpu/graph/search.py:580",
                "prune_scan": "pgvectorscale_tpu/graph/prune.py:157"}
    kernels = {"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"pgvectorscale_tpu_torch/csrc/{k}.cu",
        "replaces": replaces[k],
        "launches": sum(p[k] for p in paths.values()),
        "max_abs_err": timing[k]["max_abs_err"],
        "ms": timing[k]["ms"],
        "plain_ms": timing[k]["plain_ms"],
        "bound_ms": timing[k]["bound_ms"],
        "bound_by": timing[k]["bound_by"],
        "library_ms": timing[k]["library_ms"],
    } for k in KERNELS]}
    say(f"summary {json.dumps(summary)}")
    if elapsed() > BUDGET_S:
        fail(f"the run took {elapsed():.1f}s, over its budget of {BUDGET_S}s")
    print(json.dumps(kernels))
    print(smi_line)
    sys.stderr.flush()
    sys.stdout.flush()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
