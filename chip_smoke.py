#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``repro_torch.TriangleEngine.count()`` / ``.list()``,
``repro_torch.QueryEngine`` and ``repro_torch.embedding_bag`` on the card,
builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, holds
every kernel against its plain PyTorch version, and checks the results
against independent oracles. Every phase prints one JSON line; any failure
raises and exits non-zero. Each main-path phase sets every kernel's launch
count to 0 just before it drives the entry point and reads the counts just
after. Run from the repository root:

    python3 chip_smoke.py                 # full run (one card)
    python3 chip_smoke.py --quick         # build + kernel checks only

Phases (the kernels each main-path phase must launch in brackets):
  1. device     — card name and power limit, kernel build (one nvcc per
                  source, in parallel) with the ptxas report.
  2. kernels    — each kernel against its plain version on ragged and edge
                  shapes: intersect (exact, CSR form against
                  ``intersect_rows_ref`` per pair and in total, padded
                  form against ``intersect_count_ref``: empty rows,
                  degree-0 keys, 0/1/8,191/8,192/8,193 pairs, hub pairs
                  with and without a window that fits shared memory, 10^5
                  tiny pairs, tile edges) and dense (exact), the fused
                  count and listing kernels (exact, the listing at
                  capacities below and at the total, and once from a
                  workspace too small, which must regrow; also against
                  the scalar ``fused_ref``; two counts on two side
                  streams at once, and a listing on one stream while a
                  count runs on another, each equal to its serial run)
                  and embedding_bag in both modes (within BAG_ATOL;
                  "onehot" on the variant ops.onehot_route picks, equal
                  to "dma" bit for bit; int32 and int64 indices read in
                  place, int64 PAD values past 2^31; a negative index in
                  a child process per kernel must fail); embedding_bag on
                  bfloat16 tables (both kernels, both "onehot" variants,
                  float32 output, equal to the plain version bit for bit
                  at L = 1); embedding_bag_backward against its plain
                  version on the CPU copy of the same inputs, equal bit
                  for bit at float32 and bfloat16 output (int32 and int64
                  indices, L = 1 and 8, V from 3 to 2^20, 65,536 bags into
                  3 rows, every bag on one row, PAD, a strided gradient,
                  untouched rows zero over NaN-filled memory; runs at the
                  column-split threshold and one past it, runs starting at
                  a tile's last position and crossing many tiles, D = 130,
                  16 and 8, a skewed 512-row field with a run of >= 7,000
                  slots with and without a caller-given sort, the train
                  step's case with every row touched).
 2a. dryrun     — the fabric dry run (``repro_torch.launch.dryrun``) at
                  the reference test's size and the CLI's defaults, and
                  its CLI in a child process that sees no card; no launch.
 2b. dlrm       — DLRM serving at the full dlrm-mlperf width (26 bfloat16
                  tables, 187,775,488 rows x 128, initialised on the card):
                  ``serve_step`` at serve_p99 (B = 512) and serve_bulk (B =
                  262,144), ``retrieval_score`` at retrieval_cand (one
                  query, 1,000,000 candidates), and ``serve_step`` at
                  serve_p99 with the tables row-sharded over the card
                  repeated twice [embedding_bag "dma" 11 and "onehot" 15
                  a forward]; each against ``use_kernels=False``: lookups
                  equal bit for bit, scores within 1e-6, top-100 indices
                  equal, the sharded scores equal the unsharded; the peak
                  below 80 GB; timed; the tables freed.
 2c. train      — DLRM training: ``make_sparse_train_step`` at the full
                  dlrm-mlperf width, B = 65,536, each table capped at 2^23
                  rows (46,013,952 rows: 11.78 GB of bfloat16 tables, 47.12
                  GB of float32 moments), TRAIN_STEPS steps [embedding_bag
                  26 and embedding_bag_backward 26 a step], timed, finite
                  losses, host syncs a step, the peak below 80 GB; at 2^20
                  rows and lr 1e-2 a step with the kernels against
                  use_kernels=False with its backward's plain version on
                  the CPU copy (equal in the loss and every param and
                  moment) and row-sharded over the card twice (equal); the
                  train CLI in child processes (30 steps with checkpoints,
                  --resume to 40, --compress int8): the plain and int8
                  runs' final loss below their first, each run's
                  held-out loss below its initial params'.
 2d. gnn        — GNN training: graphcast's full CONFIG (16 layers, 512
                  wide, 227 variables) on the refinement-6 icosahedral
                  multimesh (40,962 nodes, 163,830 edges) with
                  examples/weather_sim.py's inputs, 10 ``gnn.train_step``
                  calls [embedding_bag_backward 48 a step: each layer's
                  aggregation and its two gathers' backwards], 0 host syncs
                  a step, the loss falling, the peak below 80 GB, one step
                  profiled; its largest segment sum (163,830 x 512 -> 40,962
                  rows) timed against ``index_add_``; at 2 layers, and for
                  gcn-cora (full_graph_sm, minibatch_lg), gin-tu and schnet
                  (molecule) at their full CONFIG, a kernel step equal bit
                  for bit to the plain step (sums on the CPU copy) and to
                  itself repeated.
 2e. lm         — LM serving (no kernel of the port lies on this path:
                  plain PyTorch GEMMs, cuBLAS bfloat16 with float32
                  accumulation, bfloat16 reduced-precision reductions and
                  TF32 off): (a) qwen2-7b's full CONFIG (28 layers, d_model
                  3,584, vocab 152,064: 15.23 GB of bfloat16 params from a
                  seeded generator on the card) serves LM_BATCH prompts of
                  LM_PROMPT tokens (``TokenStream(vocab, seed=0)``) with
                  LM_GEN greedy tokens through ``launch.serve.generate``;
                  prefill and decode timed and profiled, the peak below 80
                  GB; prefill's last logits against ``forward(prompt)[:,
                  -1]``, each decode step's logits against the teacher-forced
                  ``forward`` at its position, both within LM_LOGIT_REL of
                  the row's largest |logit|, the greedy token equal to the
                  forward's argmax wherever its top-2 margin exceeds that
                  bound; one prefill of LM_LONG tokens at B = 1 with
                  attn_q_chunk = LM_Q_CHUNK against the unchunked one within
                  the bound. (b) deepseek-v2-236b at full width cut to
                  LM_DS_LAYERS layers (MLA, the dense prefix and two MoE
                  layers of 160 experts, top-6, on ``moe_ffn_sorted``:
                  18.66 GB): prefill = forward within the bound, the
                  prefill run twice equal bit for bit, LM_DS_GEN greedy
                  tokens with every decode logit finite. (c) the five
                  SMOKE_CONFIGs at float32: forward, loss_fn, prefill and
                  LM_SMOKE_DECODES decode steps on the card against the CPU
                  from the same params within LM_SMOKE_REL, every MoE
                  routing equal (a flip names the token). (d) the serve CLI
                  (``python -m repro_torch.launch.serve --arch yi-6b
                  --smoke``) in a child process. No launch of a kernel.
 2f. lm_train   — LM training (GEMMs accumulating in float32): (a)
                  qwen2-7b's full-width CONFIG cut to LM_TRAIN_LAYERS
                  layers, one LM_TRAIN_SEQ-token sequence a step from
                  ``TokenStream(vocab, seed=1)``, remat "layer",
                  AdamW(LM_TRAIN_OPT), LM_TRAIN_STEPS
                  ``transformer.train_step`` calls [embedding_bag_backward
                  1 a step: the token embedding's gradient], timed, host
                  syncs a step (0 after the first), finite losses and
                  gradient norms, every leaf moved, the peak below
                  LM_TRAIN_PEAK_LIMIT, 6·N·T model flops against the
                  card's bfloat16 peak, one more step profiled; that
                  step's embedding gradient alone (its bytes bound,
                  ``index_add_``, equal to the plain version on the CPU
                  copy). (b) At LM_TRAIN_CHECK_LAYERS layers: the step
                  equal to the step repeated bit for bit in the loss and
                  every param and moment, the embedding gradient equal to
                  its plain version on the CPU copy, remat "none",
                  "layer" and "dots" equal bit for bit with their peaks,
                  the bfloat16 gradient within LM_GRAD_REL relative L2 of
                  a float32 gradient of the same params, leaf by leaf.
                  (c) The five SMOKE_CONFIGs at float32, and the two MoE
                  ones on "gathered" and "gathered_sort" with routes
                  dropped: the loss and every gradient, card against CPU,
                  within LM_SMOKE_REL, every routing equal. (d) The train
                  CLI in child processes (``--arch qwen2-7b --smoke
                  --steps 15 --batch 4 --seq 64``, plain with a
                  checkpoint, ``--compress int8``, then ``--resume`` to
                  20): the final loss below the first.
 2g. launch     — the launch layer (``repro_torch.launch.steps``, the
                  dry run's model cells, ``launch.perf``): (a)
                  ``build_cell`` and the single / multi records of all 80
                  (cell x production grid) pairs, per-device bytes <=
                  whole bytes <= per-device bytes x n_chips, the 62
                  records of the cells a grid runs with their
                  collectives (reckoned on ``meta`` blocks); (b)
                  ``run_cell(..., "card")`` at full shape, the launch
                  counts zeroed before each cell and read after it:
                  dlrm-mlperf serve_p99 [embedding_bag "dma" 11 and
                  "onehot" 15 a step; scores within DLRM_SCORE_ATOL of
                  use_kernels=False], gcn-cora full_graph_sm and graphcast
                  molecule [embedding_bag_backward 10 and 48 a step;
                  finite losses], qwen2-7b long_500k with its probes at 2
                  and 3 layers (finite logits; whole and extrapolated step
                  and peak), deepseek-v2-236b train_4k (not run: its
                  arguments exceed the card); (c) ``python -m
                  repro_torch.launch.dryrun --all`` in a child process that
                  sees no card (80 records); (d) ``python -m
                  repro_torch.launch.perf --cell dlrm_train`` in a child
                  process (4 records, every one run).
 2h. grid       — cells split over a named grid of places
                  (``launch.steps.Cell.sharded``: one process drives every
                  place, ``parallel.spmd``), GRID_PLACES places on the card
                  repeated: (a) each collective (all-gather,
                  reduce-scatter, all-reduce at float32 and bfloat16,
                  all-to-all, fetch) against its plain loop on CPU copies
                  in grid order, bit for bit; (b) graphcast's full CONFIG
                  on the refinement-6 multimesh, padded to whole 512-row
                  blocks, on a (2, 2) grid, GRID_GNN_STEPS steps
                  [embedding_bag_backward 4 x 48 a step], step ms, each
                  device's peak, the ledger's bytes a step, the last step
                  run again from its saved state equal bit for bit, and at
                  GRID_GNN_CHECK_LAYERS layers the grid step within
                  GRID_GNN_REL_L2 relative L2 of the whole step a leaf;
                  (c) dlrm-mlperf serve_p99 at CONFIG on a (1, 4) grid,
                  the tables' row blocks views of the whole tables
                  (48.07 GB held once) [embedding_bag 4 x 26 a step, each
                  block's mode as "auto" picks it], scores within
                  DLRM_SCORE_ATOL of the whole step; (d) qwen2-7b's CONFIG
                  at GRID_LM_LAYERS layers on a (1, 4) grid: prefill of
                  GRID_LM_BATCH x GRID_LM_PROMPT tokens, GRID_LM_GEN decode
                  steps fed the whole model's greedy tokens, logits within
                  LM_LOGIT_REL of the row's largest |logit|, the grid's
                  greedy token (an argmax over places) equal where the
                  top-2 margin exceeds that, ms a token, the ledger's
                  bytes; (e) where four cards are visible, (b)-(d) on
                  cuda:0..3, else ``"distinct_cards": "not run: <n>
                  visible"``. The phase's line carries the nvidia-smi
                  line. No new kernel.
 2i. grid_train — dense-LM training split over a (2, 2) grid
                  (``Cell.sharded`` of qwen2-7b's train_4k cell: FSDP over
                  ``data``, tensor parallelism over ``model``, the
                  gradient through every collective, grid-wide remat),
                  four places on the card repeated, bfloat16 with float32
                  accumulation: (a) the full width at GRID_TRAIN_LAYERS
                  layers, the arguments made on their places (one whole
                  leaf at a time on the card), GRID_TRAIN_BATCH x
                  GRID_TRAIN_SEQ tokens, AdamW from step GRID_OPT_STEP,
                  GRID_TRAIN_STEPS steps [embedding_bag_backward 4 a step:
                  each place's vocabulary block], step ms, each device's
                  peak below GRID_TRAIN_PEAK_LIMIT, the ledger of a step,
                  every leaf moved, the first step's loss and gradient
                  norm within GRID_TRAIN_REL of the whole
                  ``transformer.train_step``; one place's embedding
                  gradient timed alone; (b) at GRID_TRAIN_CHECK_LAYERS
                  layers remat "none", "layer" and "dots" equal bit for
                  bit, float32 gradients within GRID_TRAIN_REL_L2
                  relative L2 a leaf of the whole model's split by
                  sequence, and of the unsplit whole model's (or twice
                  the split one's distance from it), one float32 grid
                  step's moments against the whole step's and its params
                  the AdamW update of their own moments bit for bit,
                  bfloat16 within LM_GRAD_REL of float32, the grid step
                  repeated bit for bit; the one-card part within
                  GRID_TRAIN_PHASE_LIMIT_S; (c) where four cards are
                  visible, all 28 layers on cuda:0..3, each card below
                  GRID_TRAIN_PEAK_LIMIT and the whole params and
                  moments, within GRID_TRAIN_CARDS_LIMIT_S, else
                  ``"distinct_cards": "not run: <n> visible"``. No new
                  kernel.
                  dryrun, dlrm, train, gnn, lm, lm_train, launch, grid and
                  grid_train run first, on an empty card.
  3. rmat       — Graph500-style RMAT, ``backend="auto"`` [intersect]; the
                  count must equal the plain torch ``binary`` lane.
  4. clustered  — triangle-rich planted-partition graph [triangle_dense];
                  the int64 count (> 2^31) must equal a per-cluster
                  float64 oracle.
  5. listing    — ``list()`` on the card equals ``list()`` on the CPU byte
                  for byte (by SHA-256; the CPU's runs in a child process
                  beside the earlier phases: HostChildren), with forced
                  rescans; counts equal the host lane and a scipy-sparse
                  oracle [intersect, triangle_dense].
  6. skew       — phase 3's graph, hub-first labels, ``skew="heavy_light"``
                  [lftj_fused]; the count must equal phase 3's.
  7. fused      — ``backend="fused"`` on phase 4's and phase 5's graphs
                  [lftj_fused]; the counts must equal their oracles.
  8. query      — ``QueryEngine``: the triangle on phase 5's graph, on the
                  degree planner's boxes, count equal to phase 5's
                  [intersect]; four-clique and diamond on ``auto`` [the
                  diamond: intersect] and ``backend="fused"`` [lftj_fused]
                  at QUERY_SCALE, each equal to its scipy oracle.
  9. outofcore  — phase 3's graph ingested into an edge store by
                  ``TriangleEngine.ingest`` (spilled runs; sha256 equal to
                  ``write_edge_store_csr``'s), counted from the store with
                  ``degree_bins`` and a ``SliceCache`` at 1 and 4 workers
                  [intersect]: counts equal to phase 3's, one I/O ledger;
                  phase 5's graph listed from a store with forced rescans
                  (bytes equal to phase 5's); the diamond from a store on
                  ``backend="fused"`` [lftj_fused], count equal to phase
                  8's.
 10. query_listing — four-clique ``list()`` on ``backend="fused"``
                  [lftj_fused_list]: bytes equal the CPU's (by SHA-256,
                  from HostChildren) and a forced-rescan run's; total
                  equal to the host backend and the scipy oracle.
 11. api        — the public triangle API: ``count_triangles`` vectorized
                  on phase 3's graph in minmax orientation and on phase
                  5's in degree orientation [intersect, one launch each], dense on phase 4's [triangle_dense, one
                  8,192² call], boxed_vec and auto with a budget on phase
                  5's, each equal to that phase's count; MGT on phase 3's
                  graph [intersect, one launch a chunk] at phase 3's
                  budget, its count equal and its walls and block reads
                  beside phase 9's store count; the Prop. 4 instance on
                  the host (faithful and boxed, block reads) and on the
                  card (vectorized, boxed_vec and mgt agreeing); the three
                  measured crossovers at two box widths [triangle_dense,
                  intersect, lftj_fused] in a temporary cache, and an
                  engine on 'measured' thresholds; a traced TriangleEngine
                  count and a traced store-backed diamond on the fused lane
                  (spans per box, kernel.launch events = launches, counts
                  unchanged, Chrome trace exported). Calls of this phase
                  are not recorded for the timing phase.
 12. shard      — sharded execution and the box fabric, four shards on
                  the one card (its device repeated):
                  ``TriangleEngine(shard=True)`` on phase 3's graph, unbinned
                  and binned [intersect], and from a store (counts equal to
                  phase 3's; the store read in one sequential pass; the
                  padded (n_shards, R, K) slice never allocated); the
                  sharded ``list()`` of phase 5's graph, unbinned and
                  binned, with rescans (bytes equal to phase 5's);
                  ``Fabric``: the triangle on phase 5's graph, host and mesh
                  reductions [intersect], the diamond from phase 9's query
                  store on ``backend="fused"`` [lftj_fused] (every shard's
                  ledger equal to its oracle engine's), the four-clique
                  ``list()`` of phase 10's graph on ``fused``
                  [lftj_fused_list] (bytes equal to phase 10's); the worker
                  CLI, two processes on the card at once, its merged count
                  equal to the in-process fabric's. Calls of this phase are
                  not recorded for the timing phase.
 13. serve      — the query server, its queries as threads of one process
                  on the card's default stream: Server A
                  (``Server.from_graph`` on phase 8's scale-13 graph,
                  ``auto``) serves SERVE_CLIENTS clients at once, each
                  query at its admitted share of the pool [intersect],
                  equal to its serial ``solo_run`` (listings row for row)
                  and to scipy, block reads within 2x the solo envelopes;
                  Server B (phase 8's graph as a store, ``fused``) serves
                  two diamonds at once, one with a fault injected once
                  (one retry round) [lftj_fused], then the diamond through
                  the box fabric from a ``Session`` (each shard's ledger
                  equal to its oracle engine's); Server C (phase 10's
                  graph, ``fused``) counts and streams the four-clique
                  [lftj_fused, lftj_fused_list], pages equal to phase 10's
                  bytes, a second stream cancelled after its first page.
                  No query but the injected one retries; every thread the
                  phase starts is joined. Calls of this phase are not
                  recorded for the timing phase.
 14. embedding_bag — "auto" on the dlrm-mlperf configuration's largest
                  field (20.5 GB) [embedding_bag "dma"], its seventh
                  (3.7 MB) [embedding_bag "onehot", the row gather] and
                  its eighteenth (512 KB) [embedding_bag "onehot", the
                  column-sliced kernel], B = 65,536, L = 1 and 8, int64
                  indices, within BAG_ATOL of the plain version, "onehot"
                  equal to "dma" bit for bit; each timed (the public call,
                  calls back to back, the launch alone, host syncs per
                  call), freed.
 15. timing     — each kernel at the largest input the main path gave it,
                  against its plain version, a library call where one
                  exists, and its roofline bound; intersect, the dense
                  kernel, the fused count and the listing kernel also at
                  the main path's median call (``median_ms``), with the
                  host synchronisations of one call where they matter
                  (``host_syncs_per_call``, PyTorch's sync debug mode;
                  the fused count's over a whole ``fused_count`` call)
                  and the launches of each phase (``launches_by_phase``).
                  The dense kernel's yardsticks are a float32 product
                  (TF32 off) and ``torch._int_mm`` with the masked sum.

The last three lines are the ``kernels`` JSON line, the ``nvidia-smi``
name/power-limit line and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, int8
# tensor-core rate, and the float32 rate outside the tensor cores (used as
# the scalar integer-operation peak of the intersect kernel)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SCALAR_OPS_PER_S = 67e12

# the main-path graphs (sizes and the reasons for them are in PERF.md §4):
# Graph500-style RMAT at scale 20 with edge factor 16, planned at 2^21
# words (2^22 leaves no box in the intersect band); two 4096-vertex
# clusters at p_in = 0.5 (~2.86e9 triangles, above 2^31, and a vertex
# count small enough for the dense lane's feasibility guard); the listing
# graph, RMAT at scale 16
RMAT_SCALE, RMAT_MEM_WORDS = 20, 1 << 21
CLUSTERS, CLUSTER_SIZE, P_IN, CLUSTERED_MEM_WORDS = 2, 4096, 0.5, 1 << 20
LIST_SCALE, LIST_MEM_WORDS = 16, 1 << 18
# the skew phase's worker threads: the host lane it routes light and mixed
# boxes to is numpy, which releases the GIL
SKEW_WORKERS = 8
TIMING_REPS = 20
# the query phase's four-clique and diamond graph, RMAT at QUERY_SCALE with
# the rmat phase's boxes per edge (PERF.md §4 says why it is cut), and the
# query-listing phase's four-clique listing graph
QUERY_SCALE, QUERY_MEM_WORDS = 13, 1 << 14
QUERY_LIST_SCALE, QUERY_LIST_MEM_WORDS = 12, 1 << 14
# the query phase's worker threads on `auto` (its host lane is numpy,
# which releases the GIL), as in the skew phase; the fused runs take one:
# every box synchronises with the card twice, and threads sharing its
# stream wait on each other (four-clique at scale 13 with 8 workers:
# PERF.md §7)
QUERY_WORKERS = 8
# host work that no device path waits on runs in child processes that see
# no card (HostChildren), started when HOST_CHILDREN_START begins, so that
# it overlaps the device-bound phases; each phase reads its child's result.
# The rmat phase's graph generation (RMAT_CHILD: 46 s of host time on an
# H100 host, PERF.md §5), and the listing and query_listing phases' CPU
# listings (CPU_LISTING_CHILD: the whole listing through the kernels'
# plain versions, 73 and 38 s). CPU_LISTING_THREADS torch threads a
# listing child leave the parent cores of its own
HOST_CHILDREN_START = "lm_train"
CPU_LISTING_THREADS = 3
HOST_CHILD_TIMEOUT_S = 600
RMAT_CHILD = """
import json, sys, time
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.data.graphs import rmat_graph
t0 = time.perf_counter()
src, dst = rmat_graph(1 << {scale}, 16 << {scale}, seed=0)
s = time.perf_counter() - t0
np.save({out!r} + "/src.npy", src)
np.save({out!r} + "/dst.npy", dst)
print("RESULT " + json.dumps({{"s": s}}), flush=True)
"""
CPU_LISTING_CHILD = """
import hashlib, json, sys, time
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads({threads})
from repro_torch.data.graphs import rmat_graph
src, dst = rmat_graph(1 << {scale}, 16 << {scale}, seed=1)
if {kind!r} == "listing":
    from repro_torch.core.engine import TriangleEngine
    t0 = time.perf_counter()
    rows = TriangleEngine(src, dst, mem_words={mem_words},
                          torch_device="cpu").list()
else:
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    from repro_torch.data.edgestore import InMemoryEdgeSource
    from repro_torch.query import QueryEngine, patterns
    a, b = orient_edges(src, dst)
    csr = csr_from_edges(a, b, n_nodes=int(max(a.max(), b.max())) + 1)
    t0 = time.perf_counter()
    rows = QueryEngine(patterns.four_clique(),
                       relations={{"E": InMemoryEdgeSource(
                           *csr, orientation="minmax")}},
                       mem_words={mem_words}, backend="fused",
                       torch_device="cpu").list()
print("RESULT " + json.dumps({{
    "dtype": str(rows.dtype), "shape": list(rows.shape),
    "sha256": hashlib.sha256(rows.tobytes()).hexdigest(),
    "s": time.perf_counter() - t0}}), flush=True)
"""
# embedding_bag: the dlrm-mlperf configuration's largest field (Criteo's
# 39,979,771 rows padded to 512), its seventh (7,120 padded to 512: 3.7 MB,
# where "auto" picks "onehot" and "onehot" the row gather) and its
# eighteenth (976 padded to 1,024: 512 KB, "onehot" on the column-sliced
# kernel), D = 128 float32, B = 65,536 bags of L = 1 (the configuration's
# `hot`) and of L = 8 with ~10 % PAD slots
BAG_V_LARGEST, BAG_V_SMALL, BAG_V_SLICED = 39_980_032, 7_168, 1_024
BAG_D, BAG_B = 128, 65_536
BAG_LS, BAG_PAD_SHARE = (1, 8), 0.1
# launches a CUDA graph holds to time the embedding_bag kernels alone
BAG_GRAPH_LAUNCHES = 20
# the dlrm phase: dlrm-mlperf's full CONFIG (26 bfloat16 tables,
# 187,775,488 padded rows x 128 = 48.07 GB) served on the card at its
# cells' shapes (RECSYS_SHAPES: serve_p99 B = 512, serve_bulk B = 262,144,
# retrieval_cand one query against 1,000,000 candidates), batches from the
# Criteo-like generator at the config's hot = 1, params and candidates
# from seeded generators; the p99 batch once more with the tables
# row-sharded over the card repeated twice; the peak must stay below the
# card's 80 GB; the kernels line's bfloat16 rows time the lookup at L = 1,
# B = BAG_B on the largest field (table 19) and the eighteenth (table 17)
DLRM_ARCH, DLRM_SEED = "dlrm-mlperf", 0
DLRM_TABLE_ROWS = 187_775_488
DLRM_SHARD_DEVICES = 2
DLRM_PEAK_LIMIT = 80e9
DLRM_SCORE_ATOL = 1e-6
DLRM_BF16_FIELDS = (("largest", 19), ("eighteenth", 17))
# kernels by device time in the profile of one serve step
DLRM_PROFILE_TOP = 12
# the train phase (PERF.md §4): make_sparse_train_step at the full
# dlrm-mlperf width (D = 128, bottom 13-512-256-128, top 479-1024-1024-512-
# 256-1, hot = 1, bfloat16 tables, float32 AdamW moments) at train_batch
# (B = 65,536), the reference's OPT_CFG (AdamWConfig()); each table's rows
# capped at TRAIN_CAP_ROWS, which cuts the five largest fields (tables and
# two moments at the full 187,775,488 rows would take 240 GB): 46,013,952
# rows, 11.78 GB of tables and 47.12 GB of moments; TRAIN_STEPS steps, the
# first a warm-up; then one step with the kernels, one with
# use_kernels=False and one row-sharded over the card twice, from copies of
# one state at TRAIN_CHECK_CAP rows a table; then the train CLI on the
# smoke config in child processes (30 steps with checkpoints, --resume to
# 40, and --compress int8), each judged on a held-out batch
TRAIN_CAP_ROWS, TRAIN_ROWS = 1 << 23, 46_013_952
TRAIN_STEPS = 5
TRAIN_CHECK_CAP = 1 << 20
# the CPU tests' optimizer: lr 1e-2 from the first step, so a table
# element moves by about lr, far above a bfloat16 step of its value
TRAIN_CHECK_OPT = {"lr": 1e-2, "warmup_steps": 1}
TRAIN_CHECK_MOVED = 0.5  # least share of touched table elements moved
TRAIN_SHARD_DEVICES = 2
TRAIN_FIELDS = (("largest", 19), ("smallest", 5))
TRAIN_CLI_STEPS, TRAIN_CLI_RESUME_STEPS, TRAIN_CLI_BATCH = 30, 40, 64
TRAIN_HELD_OUT_BATCH, TRAIN_HELD_OUT_SEED = 4096, 7
TRAIN_CLI_TIMEOUT_S = 300
# the backward kernel's cases in the kernels phase: (V, B, L, D)
BAG_BWD_CASES = ((3, 65_536, 1, 128), (3, 4096, 8, 128),
                 (1000, 4096, 8, 128), (7168, 65_536, 1, 128),
                 (1 << 20, 65_536, 1, 128), (1 << 20, 8192, 8, 128),
                 (5000, 777, 3, 130), (37, 300, 2, 16), (1, 100, 2, 128),
                 (300, 4096, 1, 8), (2048, 65_536, 1, 16))
# the backward kernel's segment-sum cases (the gnn phase's sums: L = 1,
# the segment ids as indices): both sides of the refinement-4 multimesh
# (2,562 nodes, 10,230 edges: the in-degree runs of GraphCast's mesh) at
# these widths, and a hub run of HUB_RUN slots at D = 1 and 7
SEG_MESH_REFINEMENT, SEG_WIDTHS = 4, (1, 7, 16, 64, 512)
HUB_RUN = 200
# the gnn phase (PERF.md §4): graphcast's full CONFIG (16 layers, 512
# wide, 227 variables, d_edge 4) on the refinement-6 icosahedral multimesh
# (40,962 nodes, 163,830 edges) with examples/weather_sim.py's inputs and
# optimizer, GNN_STEPS steps; the kernel-vs-plain check at the same mesh and
# widths with GNN_CHECK_LAYERS layers; the other three archs at their full
# CONFIG on their cells' graphs: gcn-cora on full_graph_sm (RAND 2,708 x
# 10,556, seed 0) and on minibatch_lg (a sampled block of GNN_MB_SEEDS seeds
# over RAND 232,965 x 2^22, seed 2), gin-tu and schnet on molecule (128
# graphs of RAND 30 x 64, seed i), each at its cell's input_specs shapes
GNN_ARCH, GNN_REFINEMENT, GNN_SEED = "graphcast", 6, 0
GNN_STEPS = 10
GNN_OPT = {"lr": 3e-3, "warmup_steps": 3, "total_steps": 10}
GNN_CHECK_LAYERS = 2
GNN_PEAK_LIMIT = 80e9
GNN_MB_NODES, GNN_MB_EDGES, GNN_MB_SEEDS = 232_965, 1 << 22, 1024
# the lm phase (PERF.md §4): qwen2-7b's full CONFIG serving LM_BATCH
# prompts of LM_PROMPT tokens with LM_GEN greedy tokens each, and one
# prefill of LM_LONG tokens at B = 1, unchunked and with attn_q_chunk =
# LM_Q_CHUNK; deepseek-v2-236b at full width cut to LM_DS_LAYERS layers with
# LM_DS_GEN greedy tokens; logits held to within LM_LOGIT_REL of the row's
# largest |logit|; the smoke configs card against CPU within LM_SMOKE_REL
LM_ARCH, LM_SEED = "qwen2-7b", 0
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 32
LM_LONG, LM_Q_CHUNK = 8192, 1024
LM_DS_ARCH, LM_DS_LAYERS, LM_DS_GEN = "deepseek-v2-236b", 3, 16
LM_LOGIT_REL = 2.0 ** -4
LM_SMOKE_ARCHS = ("qwen2-7b", "yi-6b", "qwen1.5-32b", "deepseek-v2-236b",
                  "llama4-maverick-400b-a17b")
LM_SMOKE_REL, LM_SMOKE_DECODES = 1e-4, 4
LM_PEAK_LIMIT = 80e9
LM_CLI_TIMEOUT_S = 300
# the profiles' device-time sums by kernel-name part: cuBLAS's Hopper GEMMs
# ("nvjet", "gemm"), the softmax, the elementwise passes
LM_PROFILE_SUMS = {"nvjet": "nvjet", "gemm": "gemm", "softmax": "softmax",
                   "elementwise": "elementwise"}
# the lm_train phase (PERF.md §4): qwen2-7b's full-width CONFIG cut to
# LM_TRAIN_LAYERS layers (the most whose step stays below
# LM_TRAIN_PEAK_LIMIT), one LM_TRAIN_SEQ-token sequence a step (the
# train_4k cell's sequence; its batch of 256 does not fit one card) from
# TokenStream(vocab, seed=1), remat "layer", LM_TRAIN_STEPS steps of
# AdamW(LM_TRAIN_OPT); the checks at LM_TRAIN_CHECK_LAYERS layers: the
# bfloat16 gradient within LM_GRAD_REL relative L2 error of a float32
# gradient of the same params, leaf by leaf; the smoke configs' gradients
# card against CPU within LM_SMOKE_REL; the train CLI at the reference
# test's flags
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 18, 1, 4096
LM_TRAIN_STEPS = 5
LM_TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 2, "total_steps": 10}
LM_TRAIN_PEAK_LIMIT = 75e9
LM_TRAIN_CHECK_LAYERS = 2
LM_GRAD_REL = 2.0 ** -4
LM_TRAIN_MOE_IMPLS = ("gathered", "gathered_sort")
LM_TRAIN_CLI = ("--arch", "qwen2-7b", "--smoke", "--steps", "15", "--batch",
                "4", "--seq", "64")
LM_TRAIN_CLI_RESUME_STEPS = 20
# the card's dense bfloat16 peak (NVIDIA's H100 SXM data sheet, at 700 W)
H100_BF16_FLOPS = 989e12
# the dryrun phase: the fabric dry run at the reference test's sizes and at
# its CLI's defaults
DRYRUN_SHARDS = (3, 4)
# the launch phase (PERF.md §4): the cells run on the card at full shape
# (arch, shape, probes), and the embedding_bag_backward launches a step of
# the two GNN cells: gcn-cora's two degree sums and, in each of its 2
# layers, two aggregations and two gathers' backwards; graphcast's three a
# layer (the aggregation and the two gathers' backwards) in 16 layers
LAUNCH_CARD_CELLS = (("dlrm-mlperf", "serve_p99", False),
                     ("gcn-cora", "full_graph_sm", False),
                     ("graphcast", "molecule", False),
                     ("qwen2-7b", "long_500k", True),
                     ("deepseek-v2-236b", "train_4k", True))
LAUNCH_BACKWARDS = {"gcn-cora": 2 + 4 * 2, "graphcast": 3 * 16}
LAUNCH_CLI_TIMEOUT_S = 600
# the grid phase (PERF.md §4): cells split over a grid of four places on
# the card repeated (and on four cards where there are four); graphcast's
# batch padded to whole 512-row blocks, as the cells' input specs pad
# theirs; AdamW's step started past the warmup so that the step moves the
# params; the 2-layer check against the whole step in relative L2 a leaf;
# qwen2-7b's depth, prompt and decode
GRID_PLACES = 4
GRID_GNN_STEPS = 3
GRID_GNN_PAD = 512
GRID_OPT_STEP = 50
GRID_GNN_CHECK_LAYERS = 2
GRID_GNN_REL_L2 = 1e-5
GRID_LM_LAYERS = 28
GRID_LM_BATCH, GRID_LM_PROMPT, GRID_LM_GEN = 4, 512, 16
GRID_PHASE_LIMIT_S = 60
# the grid_train phase (PERF.md §4): qwen2-7b's train_4k cell split over a
# (2, 2) grid of four places on the card: its full width cut to the most
# layers whose grid step and the whole step it is held to both stay below
# GRID_TRAIN_PEAK_LIMIT (the grid step's peak, scripts/grid_train_depth.py:
# 44.7 GB at 8 layers and 2.8 GB a layer more; the whole step's, this
# phase at 8 layers: 55.8 GB), the sequence of 4,096 tokens with the
# batch cut to one sequence a dp row, AdamW from
# step GRID_OPT_STEP, remat "layer"; its loss and gradient norm against
# the whole step within GRID_TRAIN_REL; the checks at
# GRID_TRAIN_CHECK_LAYERS layers (float32 gradients within
# GRID_TRAIN_REL_L2 relative L2 a leaf of the whole step split by
# sequence, and of the unsplit whole step or twice the split one's
# distance from it; bfloat16 within LM_GRAD_REL of float32); where four
# cards are visible, all 28 layers
# on cuda:0..3. Its own time limits: the one-card part (a)-(b), and the
# four-card run (c) (28 layers made on their places and 2 steps)
GRID_TRAIN_LAYERS = 14
GRID_TRAIN_BATCH, GRID_TRAIN_SEQ = 2, 4096
GRID_TRAIN_STEPS = 3
GRID_TRAIN_SEED = 1
GRID_TRAIN_REL = 2.0 ** -7
GRID_TRAIN_CHECK_LAYERS = 2
GRID_TRAIN_REL_L2 = 1e-5
GRID_TRAIN_PEAK_LIMIT = 75e9
GRID_TRAIN_PHASE_LIMIT_S = 60
GRID_TRAIN_CARDS_LIMIT_S = 120
# the fused kernel's plain version is timed on the largest main-path input
# whose padded (R, K) atoms hold at most this many words
FUSED_PLAIN_WORDS_CAP = 1 << 30
# the outofcore phase's slice caches: 2^20 words beside the rmat phase's
# 2^21-word box budget (the scale-20 store is ~7.5x that budget); its store
# diamond at 2^16 words with a 2^15-word cache (179 boxes), not the query
# phase's 2^14 (7,429 boxes, up to 86 s of host work: PERF.md §4)
OOC_CACHE_WORDS = 1 << 20
OOC_QUERY_MEM_WORDS, OOC_QUERY_CACHE_WORDS = 1 << 16, 1 << 15
# TriangleEngine.ingest's default budget: below the scale-20 graph's edges,
# so the external sort spills runs and merges them
OOC_INGEST_BUDGET_WORDS = 1 << 22
# the api phase: MGT on the rmat graph at the rmat phase's box budget with
# the store count's block size and cache (budget / block); the Prop. 4
# instance at the test size of tests/test_boxing.py (host joins) and at a
# card size, its boxed_vec and mgt budget; the calibrations' box widths
# (the reference's 256 and a card-sized one); the traced store diamond's
# budget and cache (the outofcore phase's: PERF.md §4 says why)
MGT_BLOCK_WORDS = 4096
ADV_TEST = (1600, 400, 16)
ADV_CARD, ADV_CARD_BUDGET = (1 << 22, 1 << 16, 64), 1 << 21
CALIBRATION_NVS = (256, 4096)
TRACE_QUERY_MEM_WORDS, TRACE_QUERY_CACHE_WORDS = 1 << 16, 1 << 15
# the traced runs' ring buffer: room for every span and cache event
TRACE_CAPACITY = 1 << 20
# the shard phase: four shards on the one card (the device repeated), the
# listing graph's list() at a capacity far below each shard's total (so
# every sharded listing rescans), the fabric's store diamond at the traced
# run's budget and cache (PERF.md §4), and the worker CLI's shard count
SHARD_DEVICES, SHARD_LIST_CAPACITY = 4, 1 << 10
CLI_SHARDS, CLI_TIMEOUT_S = 5, 300
# the serve phase (PERF.md §4): Server A on the query phase's graph, a
# 2^18-word pool split four ways (each submit asks for 2^16 words, so four
# queries hold grants at once), SERVE_CLIENTS clients of SERVE_QUERIES
# queries each, round-robin from SERVE_MIX (benchmarks/serve_load.py's mix
# less the four-clique, which Server C runs), aggregate block reads within
# SERVE_ENVELOPE_FACTOR (serve_load.py's) of the solo envelopes; Server B
# on the query store, two diamonds at once at the outofcore diamond's
# budget with its cache as each one's floor (so that run is their solo
# run), and the fabric's four shards; Server C on the query-listing graph
# at that phase's budget, pages of 65,536 rows, two in the queue
SERVE_MEM_WORDS, SERVE_WANT_WORDS = 1 << 18, 1 << 16
SERVE_MAX_ACTIVE, SERVE_QUEUE_DEPTH, SERVE_WORKERS = 4, 8, 2
SERVE_CLIENTS, SERVE_QUERIES = 4, 2
SERVE_MIX = (("triangle", "count"), ("path3", "count"), ("triangle", "list"))
SERVE_ENVELOPE_FACTOR = 2.0
SERVE_B_MAX_ACTIVE, SERVE_FABRIC_SHARDS = 2, 4
SERVE_B_MEM_WORDS, SERVE_B_WANT_WORDS = 1 << 17, OOC_QUERY_MEM_WORDS
SERVE_B_CACHE_WORDS = SERVE_B_MAX_ACTIVE * OOC_QUERY_CACHE_WORDS
SERVE_C_MEM_WORDS, SERVE_C_PAGE_ROWS, SERVE_C_PAGE_DEPTH = 1 << 16, 65_536, 2
SERVE_TIMEOUT_S = 300



def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tensor_shapes(*args):
    return tuple(tuple(a.shape) for a in args if a is not None)


class Recorder:
    """Wraps a kernel wrapper in its ops module: records the shapes of every
    call the main path makes and keeps the inputs of the largest one by
    ``rank`` (default: ``size``; and, with ``fits``, of the largest one
    ``fits`` accepts). For the median call it records every call's size
    and keeps the first call of each power-of-two size bucket (the last
    with ``keep_last``)."""

    def __init__(self, module, attr: str, size, shape=tensor_shapes,
                 fits=None, rank=None, keep_last=False):
        self.module, self.attr, self.size = module, attr, size
        self.shape, self.fits = shape, fits
        self.rank = size if rank is None else rank
        self.keep_last = keep_last
        self.orig = getattr(module, attr)
        self.shapes = Counter()
        self.largest = None
        self.largest_kw = {}
        self.largest_size = -1
        self.largest_fitting = None
        self.largest_fitting_size = -1
        self.sizes = []
        self.by_bucket = {}
        # a paused recorder passes calls through unrecorded (the api
        # phase's whole-graph calls are timed in its own line)
        self.paused = False
        setattr(module, attr, self)

    def keep(self, size, args, kw) -> None:
        self.sizes.append(size)
        bucket = max(0, int(size)).bit_length()
        if self.keep_last or bucket not in self.by_bucket:
            self.by_bucket[bucket] = (size, args, kw)

    def median(self):
        """(size, args, kw) of a kept call in the median call's size
        bucket, and the median size itself."""
        med = statistics.median_low(self.sizes)
        return self.by_bucket[max(0, int(med)).bit_length()], med

    def summary(self) -> dict:
        """Call count, distinct shapes, and the largest extent of every
        argument dimension over the recorded calls."""
        dims = {}
        for shape in self.shapes:
            for i, s in enumerate(shape):
                for j, n in enumerate(s):
                    dims[f"arg{i}.dim{j}"] = max(dims.get(f"arg{i}.dim{j}", 0),
                                                 n)
        largest = None if self.largest is None else self.shape(*self.largest)
        return {"calls": sum(self.shapes.values()),
                "distinct_shapes": len(self.shapes), "max_extent": dims,
                "largest": largest}

    def __call__(self, *args, **kw):
        if self.paused:
            return self.orig(*args, **kw)
        self.shapes[self.shape(*args)] += 1
        self.keep(self.size(*args), args, kw)
        size = self.rank(*args)
        if size > self.largest_size:
            self.largest_size, self.largest = size, args
            self.largest_kw = kw
        if self.fits is not None and size > self.largest_fitting_size \
                and self.fits(*args):
            self.largest_fitting_size, self.largest_fitting = size, args
        return self.orig(*args, **kw)


class ListRecorder(Recorder):
    """A Recorder of ``fused_list`` that keeps the call emitting the most
    rows (known only after the call), with its keyword arguments."""

    def __call__(self, *args, **kw):
        if self.paused:
            return self.orig(*args, **kw)
        self.shapes[self.shape(*args)] += 1
        total, rows = self.orig(*args, **kw)
        self.keep(len(rows), args, kw)
        if len(rows) > self.largest_size:
            self.largest_size, self.largest = len(rows), args
            self.largest_kw = kw
        return total, rows


SYNC_SITES = Counter()


def count_syncs(torch, fn):
    """(fn(), the host synchronisations it made), counted by PyTorch's
    sync debug mode, which warns at every synchronising call; each
    warning's Python call site is tallied in SYNC_SITES."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        out = fn()
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    for w in syncs:
        SYNC_SITES[f"{Path(w.filename).name}:{w.lineno}"] += 1
    return out, len(syncs)


def profile_count(torch, eng, label: str, top: int = 10) -> dict:
    """Device time by kernel name over one more ``eng.count()`` under
    ``torch.profiler`` (``profile_call``)."""
    return profile_call(torch, eng.count, label, top)


def profile_call(torch, fn, label: str, top: int = 10,
                 sums: "dict | None" = None) -> dict:
    """Device time by kernel name over one ``fn()`` under
    ``torch.profiler``; ``idle_share`` is the share of the wall time in
    which no kernel or copy ran; ``device_launches`` counts the kernels,
    copies and memsets; ``sums``: {label: substring} gives the
    device ms and calls of the kernels whose names hold each substring."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the operator
    # events that launched them report the same time again
    rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    out = {"phase": "profile", "of": label, "wall_ms": wall_ms,
           "device_ms": device_ms,
           "device_launches": sum(r[2] for r in rows),
           "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
           "top": [{"name": k[:80], "calls": c, "ms": ms}
                   for ms, k, c in rows[:top]]}
    if sums:
        out["sums"] = {
            name: {"ms": sum(r[0] for r in rows if part in r[1]),
                   "calls": sum(r[2] for r in rows if part in r[1])}
            for name, part in sums.items()}
    return out


def demangle(name: str) -> str:
    """A kernel's short name from its Itanium-mangled symbol: the last
    identifier of its (nested) name, with an int template argument as
    ``<n>``: ``_ZN12_GLOBAL__N_112count_kernelILi3EEEvNS_4DescE`` ->
    ``count_kernel<3>``."""
    import re
    i = 2 + (name[2:3] == "N")
    last = name
    while i < len(name) and name[i].isdigit():
        m = re.match(r"\d+", name[i:])
        n = int(m.group())
        i += len(m.group())
        last = name[i:i + n]
        i += n
    arg = re.match(r"ILi(\d+)E", name[i:])
    return f"{last}<{arg.group(1)}>" if arg else last


def ptxas_report(log: str) -> dict:
    """{function: registers, static shared memory bytes, stack bytes,
    spill stores and loads} of every function ptxas reports in an ``nvcc
    -Xptxas=-v`` log."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = demangle(m.group(1))
            out[cur] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = demangle(m.group(1))
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[cur]["smem"] = int(m.group(1))
    return out


def lane_stats(stats) -> dict:
    return {"binary": stats.n_binary_boxes, "dense": stats.n_dense_boxes,
            "intersect": stats.n_intersect_boxes, "host": stats.n_host_boxes,
            "fused": stats.n_fused_boxes}


def reset_launches(ops: dict) -> None:
    for counter in ops.values():
        counter.reset()


def read_launches(ops: dict) -> dict:
    return {name: counter.n for name, counter in ops.items()}


def state_of(eng) -> dict:
    """An engine's CSR and box plan, for ``engine_from_state``: a later
    phase reuses a graph without generating or planning it again."""
    return {"indptr": eng.indptr, "indices": eng.indices,
            "orientation": eng.orientation, "nv": eng.nv,
            "plan": eng.plan()}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions on ragged and edge shapes
# ---------------------------------------------------------------------------

def sorted_rows(rng, e: int, k: int, hi: int, np):
    """(e, k) int32 rows: sorted distinct values < hi, SENTINEL-padded, of
    random real length (empty and full rows included)."""
    out = np.full((e, k), 2 ** 31 - 1, np.int32)
    lens = rng.integers(0, min(k, hi) + 1, size=e)
    lens[:: 7] = 0
    lens[1:: 11] = min(k, hi)
    for i, n in enumerate(lens):
        out[i, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    return out


def csr_rows(np, rng, degs, hi: int):
    """Compact CSR (int64 offsets, int32 values) whose row r holds degs[r]
    sorted distinct values below hi."""
    off = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    vals = [np.sort(rng.choice(hi, size=int(d), replace=False))
            for d in degs]
    return off, np.concatenate(vals + [np.zeros(0, np.int64)]) \
        .astype(np.int32)


def csr_pair_cases(np):
    """The intersect kernel's CSR cases: {name: ((off_a, vals_a, pos_a),
    (off_b, vals_b, pos_b))}: empty rows, positions on degree-0 keys, 0, 1,
    8,191, 8,192 and 8,193 pairs, a hub pair whose wide window exceeds the
    kernel's shared buffer and one whose windows fit, 10^5 pairs of 0-3
    values, and pair lengths that put tile edges inside and between
    pairs."""
    def random_pairs(seed, n_pairs, n_keys, max_deg, hi, zero_share=0.2):
        rng = np.random.default_rng(seed)
        sides = []
        for _ in range(2):
            degs = rng.integers(0, max_deg + 1, size=n_keys)
            degs[rng.random(n_keys) < zero_share] = 0
            off, vals = csr_rows(np, rng, degs, hi)
            sides.append((off, vals, rng.integers(0, n_keys, n_pairs)
                          .astype(np.int64)))
        return sides

    def fixed_pairs(seed, degs_a, degs_b, hi):
        rng = np.random.default_rng(seed)
        return [csr_rows(np, rng, np.array(d), hi)
                + (np.arange(len(d), dtype=np.int64),)
                for d in (degs_a, degs_b)]

    empty = random_pairs(1, 50, 30, 6, 40)
    empty[0] = (np.zeros(31, np.int64), np.zeros(0, np.int32), empty[0][2])
    cases = {"empty_rows": empty,
             "degree0_positions": random_pairs(2, 64, 20, 9, 30, 0.5)}
    for i, n in enumerate((0, 1, 8191, 8192, 8193)):
        cases[f"pairs_{n}"] = random_pairs(3 + i, n, 300, 40, 100)
    cases["hub_wide_window"] = fixed_pairs(8, [60_000], [50_000], 1_000_000)
    cases["hub_window_fits"] = fixed_pairs(9, [60_000], [50_000], 80_000)
    cases["many_tiny"] = random_pairs(10, 100_000, 5000, 3, 8, 0.1)
    cases["tile_edges"] = fixed_pairs(
        11, [2047, 1, 0, 2048, 3000, 5, 4096, 1, 2049, 0, 700],
        [2100, 1, 9, 2048, 3100, 2, 4200, 3, 2049, 4, 800], 12_000)
    return cases


def padded_of(torch, off, vals):
    """The SENTINEL-padded (rows, max(1, widest)) matrix of a CSR."""
    deg = off[1:] - off[:-1]
    k = max(1, int(deg.max()) if deg.numel() else 1)
    out = torch.full((deg.numel(), k), 2 ** 31 - 1, dtype=torch.int32,
                     device=vals.device)
    if vals.numel():
        rr = torch.repeat_interleave(torch.arange(deg.numel(),
                                                  device=vals.device), deg)
        out[rr, torch.arange(vals.numel(), device=vals.device) - off[rr]] = \
            vals
    return out


def check_csr_cases(torch, np, intersect_ops) -> int:
    """The kernel against intersect_rows_ref (per pair and in total) in
    the CSR form, and against intersect_count_ref in the padded form with
    row indices, on every csr_pair_cases case, exactly."""
    from repro_torch.kernels.intersect.ref import (intersect_count_ref,
                                                   intersect_rows_ref)
    n_cases = 0
    for name, sides in sorted(csr_pair_cases(np).items()):
        t = [torch.from_numpy(a).to("cuda") for side in sides for a in side]
        off_a, vals_a, pos_a, off_b, vals_b, pos_b = t
        want = intersect_rows_ref(*t)
        total = intersect_ops.intersect_count_csr(*t)
        assert int(total) == int(want.sum(dtype=torch.int64)), name
        n = pos_a.numel()
        if n:
            _, per_pair = intersect_ops._launch(
                (off_a, off_a[1:], vals_a, pos_a),
                (off_b, off_b[1:], vals_b, pos_b), n, per_pair=True)
            assert torch.equal(per_pair, want), name
        a, b = padded_of(torch, off_a, vals_a), padded_of(torch, off_b,
                                                          vals_b)
        ia, ib = pos_a.int(), pos_b.int()
        got = intersect_ops.intersect_count(a, b, ia, ib)
        assert torch.equal(got, intersect_count_ref(a, b, ia, ib)), name
        assert torch.equal(got, want), name
        n_cases += 3
    return n_cases


# dense shapes (nx, ny, d, density): ragged and degenerate ones, widths
# that are not a multiple of 16 (the wrapper pads them), and the kernel's
# tile edges: nx and ny at and around multiples of 64 and 128 (a
# warpgroup's rows, a block's tile), d at multiples of 16 around the
# 128-byte stage and the split-K chunks, up to a few thousand
DENSE_CASES = ((1, 7, 64, 0.3), (100, 140, 300, 0.15), (257, 129, 641, 0.2),
               (64, 64, 1, 0.5), (65, 3, 4099, 0.9), (300, 500, 2, 1.0),
               (63, 65, 16, 0.5), (64, 128, 112, 0.4), (127, 129, 128, 0.3),
               (128, 127, 144, 0.3), (129, 256, 512, 0.2),
               (255, 257, 1008, 0.2), (256, 256, 2048, 0.1),
               (384, 191, 4096, 0.1), (513, 640, 3072, 0.05),
               (192, 64, 16, 1.0))


def phase_kernel_cases(torch, np, intersect_ops, dense_ops) -> dict:
    from repro_torch.kernels.intersect.ref import intersect_count_ref
    from repro_torch.kernels.triangle_dense.ref import triangle_count_ref
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    n_cases = check_csr_cases(torch, np, intersect_ops)
    for e, ka, kb, hi in ((1, 1, 1, 4), (37, 13, 100, 120),
                          (1000, 128, 128, 500), (513, 300, 7, 900),
                          (4099, 1024, 33, 5000)):
        a = torch.from_numpy(sorted_rows(rng, e, ka, hi, np)).to(dev)
        b = torch.from_numpy(sorted_rows(rng, e, kb, hi, np)).to(dev)
        got = intersect_ops.intersect_count(a, b)
        want = intersect_count_ref(a, b)
        assert torch.equal(got, want), ("intersect", e, ka, kb)
        # index form: random pairs of rows, as the engine lane passes them
        ia = torch.from_numpy(rng.integers(0, e, 3 * e).astype(np.int32))
        ib = torch.from_numpy(rng.integers(0, e, 3 * e).astype(np.int32))
        ia, ib = ia.to(dev), ib.to(dev)
        got = intersect_ops.intersect_count(a, b, ia, ib)
        want = intersect_count_ref(a, b, ia, ib)
        assert torch.equal(got, want), ("intersect idx", e, ka, kb)
        n_cases += 2
    for nx, ny, d, p in DENSE_CASES:
        a = torch.from_numpy((rng.random((nx, d)) < p).astype(np.uint8))
        b = torch.from_numpy((rng.random((ny, d)) < p).astype(np.uint8))
        m = torch.from_numpy((rng.random((nx, ny)) < 0.5).astype(np.uint8))
        a, b, m = a.to(dev), b.to(dev), m.to(dev)
        got = dense_ops.triangle_count(a, b, m)
        want = triangle_count_ref(a, b, m)
        assert int(got) == int(want), ("dense", nx, ny, d, int(got),
                                       int(want))
        # a view offset by one byte takes the kernel's unaligned loads
        buf = torch.zeros(nx * d + 1, dtype=torch.uint8, device=dev)
        a_off = buf[1:].view(nx, d)
        a_off.copy_(a)
        assert int(dense_ops.triangle_count(a_off, b, m)) == int(want)
        n_cases += 2
    torch.cuda.synchronize()
    return {"phase": "kernels", "of": ["intersect", "triangle_dense"],
            "cases": n_cases, "exact": True}


# atom shapes over the variable order, as the reference's query planner
# emits them: the diamond leaves variable 1 starts-only
FUSED_DIMS = {
    "triangle": ((0, 1), (0, 2), (1, 2)),
    "four_clique": ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
    "diamond": ((1, 2), (1, 3), (0, 2), (0, 3)),
}
TRIANGLE = FUSED_DIMS["triangle"]


def er_graph(np, n: int, p: float, seed: int):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, k=1))
    return src.astype(np.int64), dst.astype(np.int64)


def star_graph(np, hubs: int, leaves: int, seed: int):
    """A few hubs adjacent to every leaf plus a sprinkle of leaf-leaf
    edges: a couple of huge rows over tiny ones."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(hubs), leaves)
    dst = hubs + np.tile(np.arange(leaves), hubs)
    extra = rng.integers(hubs, hubs + leaves, size=(leaves, 2))
    extra = extra[extra[:, 0] < extra[:, 1]]
    uniq = np.unique(np.concatenate([src, extra[:, 0]]) * (hubs + leaves)
                     + np.concatenate([dst, extra[:, 1]]))
    return uniq // (hubs + leaves), uniq % (hubs + leaves)


def graph_csr(np, src, dst):
    """Oriented (u < v) adjacency as (keys, off, vals) compact CSR."""
    u, v = np.minimum(src, dst), np.maximum(src, dst)
    keep = u != v
    stride = int(max(v.max(initial=0), 1)) + 1
    uniq = np.unique(u[keep] * stride + v[keep])
    u, v = uniq // stride, uniq % stride
    keys, counts = np.unique(u, return_counts=True)
    off = np.concatenate([np.zeros(1, np.int64),
                          np.cumsum(counts, dtype=np.int64)])
    return keys.astype(np.int64), off, v.astype(np.int32)


def on_card(torch, np, csrs):
    return [tuple(torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                  for a in csr) for csr in csrs]


def fused_case_graphs(np):
    from repro_torch.data.graphs import rmat_graph
    return {"er": lambda seed: er_graph(np, 150, 0.08, seed),
            "rmat": lambda seed: rmat_graph(256, 2000, seed=seed),
            "star": lambda seed: star_graph(np, 3, 100, seed)}


def hub_row_csrs(np, hub: int):
    """One depth-0 row whose depth-1 list is hub-sized: vertex 0 adjacent
    to 1..hub, the leaves a path i -> i+1, so the triangles are (0, i,
    i+1): the (R, S, T) atoms of the triangle pattern."""
    row0 = (np.zeros(1, np.int64), np.array([0, hub], np.int64),
            np.arange(1, hub + 1, dtype=np.int32))
    path = (np.arange(1, hub, dtype=np.int64),
            np.arange(hub, dtype=np.int64),
            np.arange(2, hub + 1, dtype=np.int32))
    return [row0, row0, path]


def phase_fused_cases(torch, np, fused_ops) -> dict:
    """The fused kernel against its plain version on the card and against
    the scalar oracle ``fused_ref``: every pattern on every graph, plus an
    empty frontier, an empty starts-only depth, one depth-0 row with a
    hub-sized depth-1 list, and two-variable patterns."""
    from repro_torch.kernels.lftj_fused.ref import fused_count_ref, fused_ref

    def check(dims, csrs, want=None):
        n = max(sd for _, sd in dims) + 1
        card = on_card(torch, np, csrs)
        before = fused_ops.LAUNCHES.n
        got = fused_ops.fused_count(dims, card, n)
        launched = fused_ops.LAUNCHES.n - before
        layout = fused_ops.padded_layout(dims, card, n)
        plain = 0 if layout is None else \
            int(fused_count_ref(dims, *layout, n).sum())
        if want is None:
            want = fused_ref(dims, csrs, n)[0]
        assert got == plain == want, (dims, got, plain, want)
        assert launched == (0 if layout is None else 1), launched
        return got

    n_cases = 0
    counts = {}
    for gname, make in sorted(fused_case_graphs(np).items()):
        for seed in (0, 1):
            csr = graph_csr(np, *make(seed))
            for pname, dims in sorted(FUSED_DIMS.items()):
                counts[f"{pname}/{gname}/{seed}"] = check(dims,
                                                          [csr] * len(dims))
                n_cases += 1
    csr = graph_csr(np, *er_graph(np, 120, 0.2, 3))
    shifted = (csr[0] + 10_000, csr[1], csr[2])
    # empty depth-0 frontier, and an empty starts-only depth: no launch
    assert check(TRIANGLE, [csr, shifted, csr]) == 0
    assert check(FUSED_DIMS["diamond"], [csr, shifted, csr, csr]) == 0
    hub = 1 << 15
    counts["hub_row"] = check(TRIANGLE, hub_row_csrs(np, hub), want=hub - 1)
    # two variables: one atom, and two atoms on (0, 1) pruning each other
    other = graph_csr(np, *er_graph(np, 120, 0.2, 4))
    counts["two_vars"] = check(((0, 1),), [csr])
    counts["two_vars_pruned"] = check(((0, 1), (0, 1)), [csr, other])
    n_cases += 5
    # frontier regions of 1, 7 and 100 entries (every frontier expanded in
    # chunks, depth first over them) and the default ones
    cap = fused_ops._COUNT_CAP
    csr = graph_csr(np, *fused_case_graphs(np)["rmat"](0))
    try:
        for size in (1, 7, 100, None):
            fused_ops._COUNT_CAP = cap if size is None else (size, size)
            for pname, dims in sorted(LIST_DIMS.items()):
                check(dims, [csr] * len(dims))
                n_cases += 1
            check(TRIANGLE, hub_row_csrs(np, 1 << 10), want=(1 << 10) - 1)
            n_cases += 1
    finally:
        fused_ops._COUNT_CAP = cap
    torch.cuda.synchronize()
    return {"phase": "kernels", "of": ["lftj_fused"], "cases": n_cases,
            "chunked_caps": [1, 7, 100],
            "exact": True, "counts": counts}


# every pattern of the query package, as the reference planner orders it
LIST_DIMS = dict(FUSED_DIMS, path3=((0, 1), (1, 2), (2, 3)),
                 cycle4=((0, 1), (1, 2), (2, 3), (0, 3)))


def phase_list_cases(torch, np, fused_ops) -> dict:
    """The listing kernel against its plain version ``fused_list_ref`` on
    the card (the total and the rows, byte for byte, at capacities below
    and at the total) and against ``fused_ref``'s count: every pattern on
    every graph, plus the empty and hub-row cases of the count kernel."""
    from repro_torch.kernels.lftj_fused.ref import fused_list_ref, fused_ref

    def check(dims, csrs, want=None):
        n = max(sd for _, sd in dims) + 1
        card = on_card(torch, np, csrs)
        layout = fused_ops.padded_layout(dims, card, n)
        if want is None:
            want = fused_ref(dims, csrs, n)[0]
        for cap in (1, 7, max(1, want)):
            before = fused_ops.LIST_LAUNCHES.n
            total, rows = fused_ops.fused_list(dims, card, n, capacity=cap)
            launched = fused_ops.LIST_LAUNCHES.n - before
            if layout is None:
                plain_total, plain = 0, np.zeros((0, n), np.int64)
            else:
                plain_total, plain = fused_list_ref(dims, *layout, n, cap)
                plain = plain.cpu().numpy()
            assert total == plain_total == want, (dims, cap, total,
                                                  plain_total, want)
            assert rows.dtype == plain.dtype and rows.shape == plain.shape
            assert rows.tobytes() == plain.tobytes(), (dims, cap)
            assert launched == (0 if layout is None else 1), launched
        if layout is not None:
            regrow_check(dims, card, n, layout, max(1, want))
        return want

    regrowths = []

    def regrow_check(dims, card, n, layout, cap):
        """A run from a workspace of only the fixed words: the kernel
        overflows, reports its need, the workspace grows and the call
        runs once more; rows byte-equal to the plain version, at most
        two host synchronisations."""
        prep = fused_ops._prepare(dims, card, n)
        dev = prep[2].device
        lib = fused_ops._library()
        base = lib.lftj_list_base_words(fused_ops._list_grid(lib, dev))
        plain_total, plain = fused_list_ref(dims, *layout, n, cap)
        syncs = []
        # twice: the process's first sync-debug window may hold a one-time
        # synchronisation of PyTorch's own (SYNC_SITES names it), so the
        # second run's count is the call's
        start_words = fused_ops._start_words
        fused_ops._start_words = lambda *_: base
        key = (dev, fused_ops._build.stream_ptr(dev))
        for _ in range(2):
            fused_ops._workspaces.pop(key, None)
            (total, rows), k = count_syncs(
                torch, lambda: fused_ops.launch_list(prep, cap))
            assert total == plain_total, (dims, total, plain_total)
            assert rows.long().cpu().numpy().tobytes() == \
                plain.cpu().numpy().tobytes(), dims
            syncs.append(k)
        fused_ops._start_words = start_words
        grown = fused_ops._workspaces[key].ws.numel()
        assert grown > base, (grown, base)
        regrowths.append({"base_words": base, "grown_words": grown,
                          "syncs": syncs[1], "first_run_syncs": syncs[0]})

    n_cases = 0
    counts = {}
    for gname, make in sorted(fused_case_graphs(np).items()):
        for seed in (0, 1):
            csr = graph_csr(np, *make(seed))
            for pname, dims in sorted(LIST_DIMS.items()):
                counts[f"{pname}/{gname}/{seed}"] = check(dims,
                                                          [csr] * len(dims))
                n_cases += 1
    csr = graph_csr(np, *er_graph(np, 120, 0.2, 3))
    shifted = (csr[0] + 10_000, csr[1], csr[2])
    assert check(TRIANGLE, [csr, shifted, csr]) == 0
    assert check(FUSED_DIMS["diamond"], [csr, shifted, csr, csr]) == 0
    hub = 1 << 15
    counts["hub_row"] = check(TRIANGLE, hub_row_csrs(np, hub), want=hub - 1)
    other = graph_csr(np, *er_graph(np, 120, 0.2, 4))
    counts["two_vars"] = check(((0, 1),), [csr])
    counts["two_vars_pruned"] = check(((0, 1), (0, 1)), [csr, other])
    n_cases += 5
    torch.cuda.synchronize()
    return {"phase": "kernels", "of": ["lftj_fused_list"], "cases": n_cases,
            "capacities": "1, 7, total", "exact": True, "counts": counts,
            "regrowth_runs": len(regrowths),
            "regrowth_max_syncs": max(r["syncs"] for r in regrowths),
            "regrowth_example": regrowths[0]}


def phase_stream_cases(torch, np, fused_ops) -> dict:
    """The fused kernels on two side streams at once: two counts of two
    different boxes enqueued on two streams before either is read, then a
    listing on one stream while a count runs on the other; each total and
    the listing's rows equal the serial run's on the default stream (each
    stream has its own workspace)."""
    from repro_torch.data.graphs import rmat_graph
    boxes = {}
    for name, dims, seed in (("triangle", TRIANGLE, 0),
                             ("diamond", FUSED_DIMS["diamond"], 1),
                             ("four_clique", FUSED_DIMS["four_clique"], 2)):
        csr = graph_csr(np, *rmat_graph(1 << 11, 16 << 11, seed=seed))
        n = max(sd for _, sd in dims) + 1
        boxes[name] = (dims, n, fused_ops._prepare(
            dims, on_card(torch, np, [csr] * len(dims)), n))
    serial = {k: int(fused_ops.launch_count(p)) for k, (_, _, p)
              in boxes.items()}
    cap = 4096
    list_total, list_rows = fused_ops.launch_list(boxes["four_clique"][2],
                                                  cap)
    list_rows = list_rows.cpu().numpy()
    torch.cuda.synchronize()
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    with torch.cuda.stream(side[0]):
        a = fused_ops.launch_count(boxes["triangle"][2])
    with torch.cuda.stream(side[1]):
        b = fused_ops.launch_count(boxes["diamond"][2])
    torch.cuda.synchronize()
    assert (int(a), int(b)) == (serial["triangle"], serial["diamond"]), (
        int(a), int(b), serial)
    with torch.cuda.stream(side[1]):
        c = fused_ops.launch_count(boxes["diamond"][2])
    with torch.cuda.stream(side[0]):
        total, rows = fused_ops.launch_list(boxes["four_clique"][2], cap)
        rows = rows.cpu().numpy()
    torch.cuda.synchronize()
    assert int(c) == serial["diamond"], (int(c), serial)
    assert total == list_total and rows.tobytes() == list_rows.tobytes()
    keys = {k for k in fused_ops._workspaces if k[0].type == "cuda"}
    assert {st.cuda_stream for st in side} <= {k[1] for k in keys}, keys
    return {"phase": "kernels", "of": ["lftj_fused streams"],
            "counts": serial, "listed": int(total), "capacity": cap,
            "workspaces": len(keys), "exact": True}


# embedding_bag shapes (V, D, B, L): single row and slot, ragged, the
# dlrm-mlperf width D = 128, the seventh Criteo field padded to 512 rows,
# a width that takes the 4-byte loads, empty bags, bags longer than a warp;
# then the "onehot" variants at the edges of their rule (ops.onehot_route:
# the column-sliced kernel for slices of w >= 32 floats, at D = 128 up to
# 1,816 rows): the largest dlrm-mlperf "onehot" field (7,680 rows, w = 4)
# and the seventh at L = 1 (w = 8) on the row gather; 512 rows (w = 64),
# the widest slice (454 rows, w = 128), the tallest w = 32 table (1,816
# rows) and one row more (w = 16: the row gather) at L = 8 and 1, L = 0
# and L = 40 on the sliced kernel, fewer bags than its grid has ranges;
# the tallest table with any slice (14,528 rows, w = 4) and one row more
BAG_CASES = ((1, 1, 1, 1), (100, 16, 37, 5), (1000, 128, 64, 8),
             (7168, 128, 1000, 3), (5000, 130, 513, 9), (300, 64, 8, 0),
             (50, 4, 10, 40), (7680, 128, 2000, 8), (7168, 128, 2000, 1),
             (512, 128, 777, 8), (454, 128, 300, 3), (1816, 128, 500, 8),
             (1817, 128, 500, 8), (1816, 128, 500, 1), (1817, 128, 500, 1),
             (1024, 128, 300, 0), (1024, 128, 300, 40), (1024, 128, 5, 8),
             (14528, 128, 500, 8), (14529, 128, 500, 8))
# bfloat16 tables (V, D, B, L): D = 1 and a width no 8-value vector
# divides (one element a load), D = 8 and 16 (slices narrower than the
# route takes: the row gather's 16-byte loads), the dlrm-mlperf width D =
# 128 at the edges of each bfloat16 slice width (908 rows: w = 128; 909
# and 1,816: w = 64; 3,632: w = 32; 3,633 and 7,264: w = 16; 14,528: w =
# 8; 14,529: no slice), the eighteenth field (1,024 rows) at L = 1, L = 0
# and L = 40, fewer bags than the grid has ranges, the largest bfloat16
# "onehot" field (13,312 rows) at L = 1
BAG_BF16_CASES = ((1, 1, 1, 1), (1000, 12, 50, 3), (5000, 130, 513, 9),
                  (50, 8, 10, 40), (100, 16, 37, 5), (908, 128, 300, 3),
                  (909, 128, 300, 8), (1816, 128, 500, 8),
                  (3632, 128, 500, 8), (3633, 128, 500, 1),
                  (7264, 128, 500, 8), (14528, 128, 500, 8),
                  (14529, 128, 500, 8), (1024, 128, 2000, 1),
                  (1024, 128, 300, 0), (1024, 128, 300, 40),
                  (1024, 128, 5, 8), (13312, 128, 2000, 1))
# the reference test's bound (tests/test_kernels.py): the kernel adds in
# slot order, the plain version in PyTorch's order
BAG_ATOL = 1e-4
# PAD values past int32: int64 indices the kernels must read as empty
BAG_WIDE_PADS = (2 ** 31, 2 ** 31 + 5, 2 ** 62)
# a child process that calls embedding_bag with one negative index on the
# card and must fail (the kernel traps) before it prints a result
BAG_NEGATIVE_CHILD = """
import sys
import torch
sys.path.insert(0, {src!r})
from repro_torch import embedding_bag
table = torch.rand(({v}, 128), device="cuda")
idx = torch.full((4096, 8), 3, dtype=torch.int64, device="cuda")
idx[1000, 5] = -1
out = embedding_bag(table, idx, mode={mode!r})
torch.cuda.synchronize()
print("RESULT", float(out.sum()), flush=True)
"""


def bag_indices(np, rng, v: int, b: int, ll: int):
    """(b, ll) int64 indices: about 10 % PAD (== v) or past it, bag 0 all
    PAD, duplicate slots in bag 1."""
    idx = rng.integers(0, v, size=(b, ll))
    pad = rng.random((b, ll)) < 0.1
    idx[pad] = v + rng.integers(0, 3, size=int(pad.sum()))
    if ll:
        idx[0, :] = v
        if b > 1 and ll > 1:
            idx[1, 1] = idx[1, 0] = min(idx[1, 0], v - 1)
    return idx


def bag_modes(torch, bag_ops, table, idx, want) -> dict:
    """Both modes on one input: each within BAG_ATOL of ``want``, one
    launch of its mode, "onehot" on the variant the rule picks and equal
    to "dma" bit for bit. Returns the worst error and the variant."""
    v, d = table.shape
    w = bag_ops.onehot_route(v, d, table.data_ptr() % 16 == 0,
                             table.element_size())
    variant = "slices" if w else "rows"
    got = {}
    worst = 0.0
    for mode in ("dma", "onehot"):
        before = bag_ops.LAUNCHES[mode].n
        before_v = bag_ops.ONEHOT_LAUNCHES[variant].n
        got[mode] = bag_ops.embedding_bag(table, idx, mode=mode)
        assert bag_ops.LAUNCHES[mode].n == before + 1, mode
        if mode == "onehot":
            assert bag_ops.ONEHOT_LAUNCHES[variant].n == before_v + 1, \
                (v, d, variant)
        assert got[mode].shape == want.shape
        assert got[mode].dtype == want.dtype
        err = float((got[mode] - want).abs().max()) \
            if want.numel() else 0.0
        assert err <= BAG_ATOL, (v, d, tuple(idx.shape), idx.dtype, mode,
                                 err)
        worst = max(worst, err)
    assert torch.equal(got["onehot"], got["dma"]), (v, d, tuple(idx.shape))
    return {"err": worst, "variant": variant, "w": w}


def start_bag_negative_children() -> dict:
    """One negative index on the card, in a child process per kernel (the
    device-side fault leaves the CUDA context unusable): "onehot" on the
    eighteenth field's shape (the column-sliced kernel) and "dma" (the row
    gather). Started once the kernels are built, so that they run beside
    the other kernel checks; bag_negative_results reads them."""
    procs = {}
    for mode in ("onehot", "dma"):
        code = BAG_NEGATIVE_CHILD.format(src=str(ROOT / "src"),
                                         v=BAG_V_SLICED, mode=mode)
        procs[mode] = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return procs


def bag_negative_results(procs: dict) -> dict:
    """Each child must exit non-zero without a result."""
    out = {}
    for mode, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode != 0 and "RESULT" not in stdout, \
            (mode, proc.returncode, stdout, stderr[-2000:])
        tail = [line for line in stderr.splitlines() if line.strip()]
        out[mode] = {"rc": proc.returncode,
                     "error": tail[-1][-300:] if tail else ""}
    return out


def phase_bag_cases(torch, np, bag_ops, children: dict) -> dict:
    """The embedding_bag kernels in both modes against their plain version
    on ragged and edge shapes, within BAG_ATOL, with int64 and int32
    indices read in place, PAD values past 2^31, an unaligned table view;
    "onehot" on the variant its rule picks and equal to "dma" bit for bit;
    a negative index fails on the card in a child process."""
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    worst = 0.0
    n_cases = 0
    variants = Counter()
    for v, d, b, ll in BAG_CASES:
        table = torch.rand((v, d), generator=gen, device=dev)
        idx = torch.from_numpy(bag_indices(np, rng, v, b, ll)).to(dev)
        want = embedding_bag_ref(table, idx)
        for ix in (idx, idx.to(torch.int32)):
            r = bag_modes(torch, bag_ops, table, ix, want)
            worst = max(worst, r["err"])
            variants[r["variant"]] += 1
            n_cases += 1
    # int64 PAD values past 2^31 (about a third of the PAD slots), on the
    # column-sliced kernel and the row gather
    for v, d in ((BAG_V_SLICED, 128), (5000, 130)):
        table = torch.rand((v, d), generator=gen, device=dev)
        host = bag_indices(np, rng, v, 600, 8)
        wide = (host >= v) & (rng.random(host.shape) < 0.4)
        host[wide] = rng.choice(BAG_WIDE_PADS, size=int(wide.sum()))
        host[2, :] = 2 ** 62
        idx = torch.from_numpy(host).to(dev)
        want = embedding_bag_ref(table, torch.from_numpy(
            np.minimum(host, v)).to(dev))
        assert float(want[2].abs().max()) == 0.0
        r = bag_modes(torch, bag_ops, table, idx, want)
        worst = max(worst, r["err"])
        variants[r["variant"]] += 1
        n_cases += 1
    # a table view offset by one float takes the 4-byte loads, and "onehot"
    # takes the row gather (no 16-byte copy of a slice)
    buf = torch.rand(1000 * 128 + 1, generator=gen, device=dev)
    table = buf[1:].view(1000, 128)
    idx = torch.from_numpy(bag_indices(np, rng, 1000, 77, 6)).to(dev)
    r = bag_modes(torch, bag_ops, table, idx, embedding_bag_ref(table, idx))
    assert r["variant"] == "rows", r
    worst = max(worst, r["err"])
    variants[r["variant"]] += 1
    n_cases += 1
    bf16 = bag_bf16_cases(torch, np, bag_ops, gen, rng)
    torch.cuda.synchronize()
    negative = bag_negative_results(children)
    return {"phase": "kernels", "of": ["embedding_bag"],
            "cases": n_cases, "onehot_variants": dict(variants),
            "atol": BAG_ATOL, "max_abs_err": worst,
            "onehot_equals_dma": True, "bf16": bf16,
            "negative_index": negative}


def bag_bf16_cases(torch, np, bag_ops, gen, rng) -> dict:
    """bfloat16 tables: both kernels and both "onehot" variants on
    BAG_BF16_CASES with int64 and int32 indices, and an unaligned view
    (2 bytes in: one element a load, "onehot" on the row gather), each
    within BAG_ATOL of the plain version (float32 output), "onehot" equal
    to "dma" bit for bit; at L = 1 both equal the plain version bit for
    bit (a bag is one widened row)."""
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    dev = torch.device("cuda")
    worst = 0.0
    n_cases = 0
    variants = Counter()
    widths = Counter()
    for v, d, b, ll in BAG_BF16_CASES:
        table = torch.randn((v, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        idx = torch.from_numpy(bag_indices(np, rng, v, b, ll)).to(dev)
        want = embedding_bag_ref(table, idx)
        assert want.dtype == torch.float32
        for ix in (idx, idx.to(torch.int32)):
            r = bag_modes(torch, bag_ops, table, ix, want)
            if ll == 1:
                assert torch.equal(bag_ops.embedding_bag(table, ix), want), \
                    (v, d, b)
            worst = max(worst, r["err"])
            variants[r["variant"]] += 1
            widths[r["w"]] += 1
            n_cases += 1
    buf = torch.randn(1000 * 128 + 1, generator=gen, device=dev) \
        .to(torch.bfloat16)
    table = buf[1:].view(1000, 128)
    idx = torch.from_numpy(bag_indices(np, rng, 1000, 77, 6)).to(dev)
    r = bag_modes(torch, bag_ops, table, idx, embedding_bag_ref(table, idx))
    assert r["variant"] == "rows", r
    worst = max(worst, r["err"])
    variants[r["variant"]] += 1
    n_cases += 1
    assert variants["slices"] and variants["rows"], variants
    return {"cases": n_cases, "onehot_variants": dict(variants),
            "slice_widths": {str(w): n for w, n in sorted(widths.items())},
            "max_abs_err": worst, "onehot_equals_dma": True}


def zipf_indices(np, rng, v: int, size) -> "np.ndarray":
    """The train data's power-law draw (``CriteoLikeGenerator``): row
    ``floor(v^u - 1)`` for u uniform, so row 0 takes ln 2 / ln v of the
    slots (11 % at v = 512)."""
    u = rng.random(size)
    return np.clip(np.floor(v ** u - 1).astype(np.int64), 0, v - 1)


def run_indices(np, rng, lengths) -> "np.ndarray":
    """(sum(lengths), 1) indices whose sorted runs have these lengths
    (keys 0, 1, ...), in shuffled bag order."""
    x = np.repeat(np.arange(len(lengths)), lengths)
    rng.shuffle(x)
    return x.reshape(-1, 1)


def bag_backward_run_cases(grad_ops) -> dict:
    """The run lengths that reach the kernel's edges, by name: around
    LONG_RUN (a run of more slots is split by columns over blocks), runs
    starting at the last position of a SPAN-position tile (one of them
    long), and runs crossing many tiles."""
    t, w = grad_ops.LONG_RUN, grad_ops.SPAN
    return {
        "threshold": [t - 1, t, t + 1, 1, 2, t, t + 1, w - 1, w, w + 1],
        # runs start at positions w - 1 (short) and 4 w - 1 (long)
        "span_end": [w - 1, w + 8, 2 * w - 8, 3 * t, 1, w - 2, t + 1],
        "many_spans": [5, 30 * w, 3, t, 7 * w, 7],
    }


def phase_bag_backward_cases(torch, np, grad_ops) -> dict:
    """embedding_bag_backward on the card against its plain version on the
    CPU copy of the same inputs: both add each row's slots in (b, s) order
    from 0 in float32, so they are equal bit for bit at float32 output and
    after the one cast at bfloat16. Each case with int64 and int32 indices
    and both outputs, through the wrapper and once more through the C
    entry into an output filled with NaN (the kernel writes every row,
    zeros where no slot names one):
    BAG_BWD_CASES (about 10 % PAD, bag 0 all PAD: bag_indices; V from 3
    to 2^20, 65,536 bags into 3 rows, L = 1 and 8, D = 128, 130, 16);
    every bag on one row; a strided grad_out; the run lengths of
    bag_backward_run_cases at D = 128, 130, 16 and 8; a skewed 512-row
    field (a Zipf draw, B = 65,536, L = 1, one run of >= 7,000 slots)
    with and without a caller-given ``order``, and at D = 130, 16 and 8
    (B = 8,192); the
    train step's case (``dlrm.unique_with_order`` of a Zipf draw over 2^23
    rows: every row touched, the step's ``order``); the gnn phase's segment
    sums (L = 1): the in-degree runs of both sides of a refinement-4
    multimesh at D in SEG_WIDTHS, and a hub run of HUB_RUN slots with a
    run just past LONG_RUN at D = 1 and 7. Two launches a case."""
    from repro_torch.data.graphs import icosahedral_mesh
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    from repro_torch.models.dlrm import unique_with_order
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    n_cases = 0
    names = []

    def check(g, idx, v, name=None, order=None):
        nonlocal n_cases
        g_cpu, idx_cpu = g.cpu(), idx.cpu()
        for ix, ix_cpu in ((idx, idx_cpu),
                           (idx.to(torch.int32), idx_cpu.to(torch.int32))):
            sort = None if order is None else (order[0].to(ix.dtype),
                                               order[1])
            keys, perm = sort or torch.sort(ix.reshape(-1), stable=True)
            for dtype in (torch.float32, torch.bfloat16):
                want = embedding_bag_backward_ref(g_cpu, ix_cpu, v, dtype)
                before = grad_ops.BACKWARD_LAUNCHES.n
                got = grad_ops.embedding_bag_backward(g, ix, v, dtype,
                                                      order=sort)
                assert got.dtype == dtype and torch.equal(got.cpu(), want), \
                    (name, v, tuple(ix.shape), ix.dtype, dtype)
                # the C entry once more, into memory that holds NaN
                nan_out = torch.full((v, g.shape[1]), float("nan"),
                                     dtype=dtype, device=dev)
                grad_ops._launch_sorted(g, keys, perm, ix.shape[1], v, dtype,
                                        out=nan_out)
                assert grad_ops.BACKWARD_LAUNCHES.n == before + 2
                assert torch.equal(nan_out.cpu(), want), \
                    (name, v, tuple(ix.shape), ix.dtype, dtype, "nan_out")
                n_cases += 1
        if name:
            names.append(name)
        return got

    untouched = 0
    for v, b, ll, d in BAG_BWD_CASES:
        idx = torch.from_numpy(bag_indices(np, rng, v, b, ll)).to(dev)
        g = torch.randn((b, d), generator=gen, device=dev)
        got = check(g, idx, v)
        live = idx[idx < v]
        mask = torch.ones(v, dtype=torch.bool, device=dev)
        mask[live] = False
        assert not got[mask].any()
        untouched += int(mask.sum())
    # every bag on one row, L = 1 and 8; a strided grad_out (a column slice
    # of a wider matrix, read in place)
    for ll in (1, 8):
        idx = torch.full((BAG_B, ll), 5, dtype=torch.int64, device=dev)
        check(torch.randn((BAG_B, 128), generator=gen, device=dev), idx, 11)
    wide = torch.randn((4096, 3 * 128), generator=gen, device=dev)
    idx = torch.from_numpy(bag_indices(np, rng, 999, 4096, 4)).to(dev)
    check(wide[:, 128:256], idx, 999)
    # the run lengths at the kernel's edges
    for name, lengths in bag_backward_run_cases(grad_ops).items():
        idx = torch.from_numpy(run_indices(np, rng, lengths)).to(dev)
        v = len(lengths) + 2  # two rows no slot names
        for d in (128, 130, 16, 8):
            g = torch.randn((idx.shape[0], d), generator=gen, device=dev)
            check(g, idx, v, f"{name}/D{d}")
    # a skewed 512-row field: one run of >= 7,000 of 65,536 slots
    idx = torch.from_numpy(zipf_indices(np, rng, 512, (BAG_B, 1))).to(dev)
    longest = int(torch.bincount(idx.reshape(-1)).max())
    assert longest >= 7000, longest
    g = torch.randn((BAG_B, 128), generator=gen, device=dev)
    check(g, idx, 512, "skewed512")
    check(g, idx, 512, "skewed512/order",
          order=torch.sort(idx.reshape(-1), stable=True))
    for d in (130, 16, 8):
        idx = torch.from_numpy(zipf_indices(np, rng, 512, (8192, 1))).to(dev)
        check(torch.randn((8192, d), generator=gen, device=dev), idx, 512,
              f"skewed512/B8192/D{d}")
    # the train step's case: every row touched, the step's sort
    x = torch.from_numpy(zipf_indices(np, rng, 1 << 23, BAG_B)).to(dev)
    uniq, inv, order = unique_with_order(x)
    g = torch.randn((BAG_B, 128), generator=gen, device=dev)
    check(g, inv.view(BAG_B, 1), uniq.numel(), "step", order=order)
    # segment sums: the multimesh's in-degree runs by either side (dst on
    # the batch's sort, as edge_orders makes it; src on the wrapper's own)
    # and a hub run
    _, msrc, mdst = icosahedral_mesh(SEG_MESH_REFINEMENT)
    nv = int(max(msrc.max(), mdst.max())) + 1
    for side, seg in (("dst", mdst), ("src", msrc)):
        idx = torch.from_numpy(seg).to(dev).view(-1, 1)
        sort = torch.sort(idx.reshape(-1), stable=True) \
            if side == "dst" else None
        for d in SEG_WIDTHS:
            g = torch.randn((idx.shape[0], d), generator=gen, device=dev)
            check(g, idx, nv, f"mesh_{side}/D{d}", order=sort)
    idx = torch.from_numpy(run_indices(np, rng, [HUB_RUN, 1, 3,
                                                  grad_ops.LONG_RUN + 1,
                                                  2])).to(dev)
    for d in (1, 7):
        g = torch.randn((idx.shape[0], d), generator=gen, device=dev)
        check(g, idx, 7, f"hub{HUB_RUN}/D{d}")
    torch.cuda.synchronize()
    return {"phase": "kernels", "of": ["embedding_bag_backward"],
            "cases": n_cases, "exact": True, "untouched_rows_zero": untouched,
            "run_cases": names, "long_run": grad_ops.LONG_RUN,
            "skewed512_longest_run": longest}


# ---------------------------------------------------------------------------
# phases 3-7: the main path through TriangleEngine
# ---------------------------------------------------------------------------

def phase_rmat(torch, np, ops, shared, mem_words: int,
               profile: bool) -> dict:
    """The RMAT_SCALE graph (generated by HostChildren) counted on
    ``backend="auto"``, against the ``binary`` lane."""
    from repro_torch.core.engine import TriangleEngine
    gen = shared["host_children"].result("rmat")
    src, dst = gen.pop("graph")
    t0 = time.perf_counter()
    eng = TriangleEngine(src, dst, mem_words=mem_words)
    eng.plan()
    t_plan = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ops)
    stats = eng.stats
    assert stats.n_intersect_boxes > 0, lane_stats(stats)
    assert launches["intersect"] > 0, launches
    peak = torch.cuda.max_memory_allocated()
    if profile:
        emit(profile_count(torch, eng, "rmat"))
    eng.backend = "binary"
    t0 = time.perf_counter()
    want = eng.count()
    torch.cuda.synchronize()
    wall_binary = time.perf_counter() - t0
    assert count == want, (count, want)
    shared["rmat"] = {"src": src, "dst": dst, "count": count,
                      "count_s": wall, "csr": (eng.indptr, eng.indices),
                      "plan": eng.plan(),
                      "padded_words": stats.padded_words,
                      "actual_words": stats.actual_words,
                      "boxes": stats.n_boxes}
    return {"phase": "rmat", "scale": RMAT_SCALE, "edges": int(len(src)),
            "mem_words": mem_words, "boxes": stats.n_boxes,
            "lanes": lane_stats(stats), "count": count,
            "count_binary_lane": want, "launches": launches,
            "device_invocations": stats.device_invocations,
            "padded_words": stats.padded_words,
            "actual_words": stats.actual_words, "gen_s": gen["s"],
            "gen_wait_s": gen["wait_s"],
            "plan_s": t_plan, "count_s": wall, "binary_count_s": wall_binary,
            "max_memory_allocated": peak}


def cluster_oracle(torch, src, dst, n_clusters: int, size: int) -> int:
    """Σ over clusters of Σ A_c ⊙ (A_c A_cᵀ) on each oriented size×size
    block, in float64 on the card; the inter-cluster chain closes no
    triangle."""
    dev = torch.device("cuda")
    a = torch.from_numpy(src).to(dev)
    b = torch.from_numpy(dst).to(dev)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    same = (lo // size) == (hi // size)
    lo, hi = lo[same], hi[same]
    total = 0
    for c in range(n_clusters):
        sel = (lo // size) == c
        blk = torch.zeros((size, size), dtype=torch.float64, device=dev)
        blk[lo[sel] - c * size, hi[sel] - c * size] = 1.0
        total += int((blk * (blk @ blk.T)).sum().item())
    return total


def phase_clustered(torch, np, ops, shared, n_clusters: int, size: int,
                    p_in: float, mem_words: int, profile: bool) -> dict:
    from repro_torch.core.engine import TriangleEngine
    from repro_torch.data.graphs import clustered_graph
    t0 = time.perf_counter()
    src, dst = clustered_graph(n_clusters, size, seed=0, p_in=p_in)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = TriangleEngine(src, dst, mem_words=mem_words)
    eng.plan()
    t_plan = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ops)
    stats = eng.stats
    assert stats.n_dense_boxes > 0, lane_stats(stats)
    assert launches["triangle_dense"] > 0, launches
    peak = torch.cuda.max_memory_allocated()
    if profile:
        emit(profile_count(torch, eng, "clustered"))
    want = cluster_oracle(torch, src, dst, n_clusters, size)
    assert count == want, (count, want)
    assert count > 2 ** 31, count
    shared["clustered"] = {"state": state_of(eng), "oracle": want,
                           "mem_words": mem_words, "count_s": wall}
    return {"phase": "clustered", "clusters": n_clusters,
            "cluster_size": size, "p_in": p_in, "edges": int(len(src)),
            "mem_words": mem_words, "boxes": stats.n_boxes,
            "lanes": lane_stats(stats), "count": count, "oracle": want,
            "launches": launches,
            "device_invocations": stats.device_invocations,
            "gen_s": t_gen, "plan_s": t_plan, "count_s": wall,
            "max_memory_allocated": peak}


class HostChildren:
    """The host work of HOST_CHILDREN_START's comment, each in a child
    process that sees no card, started once by ``start`` and read by the
    phase that needs it (``result``); the rmat graph passes through .npy
    files in a temporary directory."""

    LISTING_SIZES = {"listing": (LIST_SCALE, LIST_MEM_WORDS),
                     "query_listing": (QUERY_LIST_SCALE,
                                       QUERY_LIST_MEM_WORDS)}

    def __init__(self, names):
        self.kinds = [k for k in ("rmat", *self.LISTING_SIZES)
                      if k in names]
        self.procs = {}
        self.tmp = None

    def _code(self, kind: str) -> str:
        if kind == "rmat":
            return RMAT_CHILD.format(src=str(ROOT / "src"), scale=RMAT_SCALE,
                                     out=self.tmp)
        scale, mem_words = self.LISTING_SIZES[kind]
        return CPU_LISTING_CHILD.format(
            src=str(ROOT / "src"), threads=CPU_LISTING_THREADS, scale=scale,
            kind=kind, mem_words=mem_words)

    def start(self) -> None:
        import os
        import tempfile
        if self.tmp is None:
            self.tmp = tempfile.mkdtemp(prefix="host_children_")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        for kind in self.kinds:
            if kind not in self.procs:
                self.procs[kind] = subprocess.Popen(
                    [sys.executable, "-c", self._code(kind)], env=env,
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)

    def result(self, kind: str) -> dict:
        """The child's RESULT (a listing's dtype, shape, SHA-256 of its
        bytes and seconds; the rmat graph's seconds of generation), how
        long the phase waited for it, and for "rmat" the graph."""
        import numpy as np
        self.start()
        t0 = time.perf_counter()
        proc = self.procs[kind]
        stdout, stderr = proc.communicate(timeout=HOST_CHILD_TIMEOUT_S)
        assert proc.returncode == 0, (kind, proc.returncode, stderr[-2000:])
        line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
        assert len(line) == 1, (kind, stdout[-2000:])
        out = json.loads(line[0][len("RESULT "):])
        if kind == "rmat":
            out["graph"] = (np.load(Path(self.tmp, "src.npy")),
                            np.load(Path(self.tmp, "dst.npy")))
        return dict(out, wait_s=time.perf_counter() - t0)

    def close(self) -> None:
        import shutil
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


def same_listing(rows, cpu: dict) -> bool:
    """``rows`` (the card's listing) equal to a HostChildren result: dtype,
    shape and the SHA-256 of the bytes."""
    return (str(rows.dtype) == cpu["dtype"]
            and list(rows.shape) == cpu["shape"]
            and hashlib.sha256(rows.tobytes()).hexdigest() == cpu["sha256"])


def phase_listing(torch, np, ops, shared, scale: int,
                  mem_words: int) -> dict:
    import scipy.sparse as sp
    from repro_torch.core.engine import TriangleEngine
    from repro_torch.core.lftj_torch import orient_edges
    from repro_torch.data.graphs import rmat_graph
    src, dst = rmat_graph(1 << scale, 16 << scale, seed=1)
    reset_launches(ops)
    eng = TriangleEngine(src, dst, mem_words=mem_words)
    t0 = time.perf_counter()
    count = eng.count()
    t_count = time.perf_counter() - t0
    count_lanes = lane_stats(eng.stats)
    t0 = time.perf_counter()
    tris = eng.list()
    t_list = time.perf_counter() - t0
    rescans_default = eng.stats.n_rescans
    # a capacity well below the mean per-box total forces rescans in the
    # boxes above it
    cap = max(1, min(256, count // (4 * max(1, eng.stats.n_boxes))))
    forced = eng.list(capacity=cap)
    rescans_forced = eng.stats.n_rescans
    launches = read_launches(ops)
    assert rescans_forced > 0, rescans_forced
    assert forced.tobytes() == tris.tobytes()
    assert len(tris) == count, (len(tris), count)
    cpu = shared["host_children"].result("listing")
    assert same_listing(tris, cpu), cpu
    eng.backend = "host"
    count_host = eng.count()
    assert count_host == count, (count_host, count)
    a, b = orient_edges(src, dst)
    n = int(max(a.max(), b.max())) + 1
    adj = sp.csr_matrix((np.ones(len(a), np.int64), (a, b)), shape=(n, n))
    oracle = int(adj.multiply(adj @ adj.T).sum())
    assert oracle == count, (oracle, count)
    shared["listing"] = {"state": state_of(eng), "oracle": oracle,
                         "src": src, "dst": dst,
                         "mem_words": mem_words, "count_s": t_count,
                         "list_sha256": hashlib.sha256(tris.tobytes())
                         .hexdigest(), "list_s": t_list}
    return {"phase": "listing", "scale": scale, "edges": int(len(src)),
            "mem_words": mem_words, "count": count, "listed": len(tris),
            "count_lanes": count_lanes, "launches": launches,
            "rescans_default": rescans_default,
            "forced_capacity": cap, "rescans_forced": rescans_forced,
            "count_s": t_count, "list_s": t_list, "cpu_list_s": cpu["s"],
            "cpu_list_wait_s": cpu["wait_s"],
            "count_host_lane": count_host, "scipy_oracle": oracle}


def hub_first_csr(np, src, dst):
    """The graph in degree orientation (each edge from its lower- to its
    higher-degree end, ``orient_edges(..., "degree")``) with vertices
    renumbered by descending out-degree, edge directions kept. The hubs
    then hold one contiguous id range, so heavy/light class cuts leave
    whole hub ranges; raw RMAT ids scatter the hubs over the ids with few
    one-bits and cut every hub range to a few ids. The orientation stays
    acyclic, so every triangle is counted once, as in phase 3; its edges
    no longer run from a smaller to a larger id, so the engine is told
    ``orientation="degree"`` and plans without the minmax pruning."""
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    a, b = orient_edges(src, dst, "degree")
    n = int(max(a.max(), b.max())) + 1
    outdeg = np.bincount(a, minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.argsort(-outdeg, kind="stable")] = np.arange(n)
    return csr_from_edges(rank[a], rank[b], n_nodes=n)


def hub_box_routes(np, eng) -> dict:
    """Boxes of a heavy_light engine's plan, its hub boxes, and the hub
    boxes ``_pick_backend`` sends to the fused lane, from the plan and
    the CSR alone (nothing is counted)."""
    ip, ind, nv = eng.indptr, eng.indices, eng.nv
    plan = eng.plan()
    n_hub = n_fused = fused_edges = 0
    for box in plan:
        if eng._box_lane.get(box) != "hub":
            continue
        n_hub += 1
        lx, hx, ly, hy = box
        hx, hy = min(hx, nv - 1), min(hy, nv - 1)
        v = ind[ip[lx]:ip[hx + 1]]
        n_edges = int(((v >= ly) & (v <= hy)).sum())
        if n_edges and eng._pick_backend(n_edges, hx - lx + 1, hy - ly + 1,
                                         box) == "fused":
            n_fused += 1
            fused_edges += n_edges
    return {"threshold": eng._skew_threshold, "boxes": len(plan),
            "hub": n_hub, "fused": n_fused, "fused_edges": fused_edges}


def reckon_heavy_threshold(np, make_engine, degrees) -> tuple:
    """The default hub threshold when it routes a hub box to the fused
    lane, else the largest out-degree value that does (bisection over the
    sorted distinct values, taking fewer hubs as routing fewer boxes).
    Returns (threshold, every probe's routes)."""
    probes = [hub_box_routes(np, make_engine(None))]
    if probes[0]["fused"]:
        return None, probes
    values = np.unique(degrees[degrees > 0])
    lo, hi = 0, len(values) - 1          # values[lo] must route one
    probes.append(hub_box_routes(np, make_engine(int(values[lo]))))
    if not probes[-1]["fused"]:
        raise AssertionError(f"no heavy_threshold routes a hub box to the "
                             f"fused lane: {probes}")
    while hi > lo:
        mid = (lo + hi + 1) // 2
        probes.append(hub_box_routes(np, make_engine(int(values[mid]))))
        if probes[-1]["fused"]:
            lo = mid
        else:
            hi = mid - 1
    return int(values[lo]), probes


def phase_skew(torch, np, ops, shared, mem_words: int, workers: int,
               profile: bool) -> dict:
    from repro_torch.core.engine import TriangleEngine
    rmat = shared["rmat"]
    # raw ids, the reference plan at the default cut: how many hub boxes
    # reach the fused lane without the hub-first labels
    raw = TriangleEngine(csr=rmat["csr"], orientation="minmax",
                         mem_words=mem_words, skew="heavy_light")
    raw_routes = hub_box_routes(np, raw)
    del raw
    t0 = time.perf_counter()
    indptr, indices = hub_first_csr(np, rmat["src"], rmat["dst"])
    t_relabel = time.perf_counter() - t0

    def make_engine(thr):
        eng = TriangleEngine(csr=(indptr, indices), orientation="degree",
                             mem_words=mem_words, skew="heavy_light",
                             heavy_threshold=thr, workers=workers)
        eng.plan()
        return eng

    t0 = time.perf_counter()
    thr, probes = reckon_heavy_threshold(np, make_engine, np.diff(indptr))
    t_reckon = time.perf_counter() - t0
    eng = make_engine(thr)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ops)
    stats = eng.stats
    assert stats.n_fused_boxes > 0, lane_stats(stats)
    assert launches["lftj_fused"] > 0, launches
    assert count == rmat["count"], (count, rmat["count"])
    if profile:
        emit(profile_count(torch, eng, "skew"))
    return {"phase": "skew", "scale": RMAT_SCALE, "mem_words": mem_words,
            "orientation": "degree, hub-first ids", "workers": workers,
            "heavy_threshold": stats.heavy_threshold,
            "threshold_probes": probes, "raw_ids_default_cut": raw_routes,
            "boxes": stats.n_boxes, "hub_boxes": stats.n_hub_boxes,
            "light_boxes": stats.n_light_boxes,
            "mixed_boxes": stats.n_mixed_boxes, "lanes": lane_stats(stats),
            "count": count, "count_rmat_phase": rmat["count"],
            "launches": launches,
            "device_invocations": stats.device_invocations,
            "padded_words": stats.padded_words,
            "actual_words": stats.actual_words,
            "uniform_plan": {"boxes": rmat["boxes"],
                             "padded_words": rmat["padded_words"],
                             "actual_words": rmat["actual_words"]},
            "relabel_s": t_relabel, "reckon_s": t_reckon, "count_s": wall,
            "compute_s": stats.compute_s,
            "worker_utilization": stats.worker_utilization,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_fused(torch, np, ops, shared, profile: bool) -> dict:
    """``backend="fused"`` on the clustered and listing graphs, with their
    CSRs and plans carried over (no generation or planning again)."""
    from repro_torch.convert import engine_from_state
    out = {"phase": "fused"}
    for name in ("clustered", "listing"):
        g = shared[name]
        eng = engine_from_state(g["state"], mem_words=g["mem_words"],
                                backend="fused")
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = eng.count()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(ops)
        stats = eng.stats
        assert stats.n_fused_boxes > 0, lane_stats(stats)
        assert launches["lftj_fused"] > 0, launches
        assert count == g["oracle"], (name, count, g["oracle"])
        if profile:
            emit(profile_count(torch, eng, f"fused/{name}"))
        out[name] = {"boxes": stats.n_boxes, "lanes": lane_stats(stats),
                     "count": count, "oracle": g["oracle"],
                     "launches": launches,
                     "device_invocations": stats.device_invocations,
                     "count_s": wall, "auto_count_s": g["count_s"],
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated()}
    assert out["clustered"]["count"] > 2 ** 31
    out["launches"] = {k: out["clustered"]["launches"][k]
                       + out["listing"]["launches"][k]
                       for k in out["clustered"]["launches"]}
    return out


def oriented_adjacency(np, src, dst):
    """The minmax-oriented graph as a scipy CSR matrix of ones."""
    import scipy.sparse as sp
    from repro_torch.core.lftj_torch import orient_edges
    a, b = orient_edges(src, dst)
    n = int(max(a.max(), b.max())) + 1
    adj = sp.csr_matrix((np.ones(len(a), np.int64), (a, b)), shape=(n, n))
    adj.sort_indices()
    return adj


def four_clique_oracle(np, adj, chunk: int = 1 << 16) -> int:
    """4-cliques of the oriented graph: for each edge (u, v), the edges
    among the common out-neighbours C of u and v (Q = A[u] ⊙ A[v] per
    edge, then Σ (Q A) ⊙ Q), in chunks of edges."""
    u = np.repeat(np.arange(adj.shape[0]), np.diff(adj.indptr))
    v = adj.indices
    total = 0
    for s in range(0, len(u), chunk):
        q = adj[u[s:s + chunk]].multiply(adj[v[s:s + chunk]]).tocsr()
        total += int((q @ adj).multiply(q).sum())
    return total


def diamond_oracle(adj) -> int:
    """Diamonds E(x,y) E(x,z) E(y,w) E(z,w) of the oriented graph: the sum
    over (x, w) of the squared number of 2-paths, Σ (A²)[x, w]²."""
    a2 = adj @ adj
    return int(a2.multiply(a2).sum())


def query_source(np, csr):
    from repro_torch.data.edgestore import InMemoryEdgeSource
    return {"E": InMemoryEdgeSource(*csr, orientation="minmax")}


def query_stats(stats) -> dict:
    return {"boxes": stats.n_boxes, "kernel": stats.n_kernel_boxes,
            "fused": stats.n_fused_boxes, "host": stats.n_host_boxes,
            "device_invocations": stats.device_invocations,
            "max_frontier": stats.max_frontier}


def drive(torch, ops, fn):
    """(fn(), wall seconds, launches): every launch count set to 0 just
    before ``fn`` drives the entry point and read just after."""
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches(ops)


def run_query_count(torch, ops, eng) -> tuple:
    return drive(torch, ops, eng.count)


def phase_query(torch, np, ops, shared, scale: int, mem_words: int) -> dict:
    """QueryEngine counts on the card: the triangle pattern on phase 5's
    graph (its plan must be the triangle degree planner's,
    ``plan_boxes_from_degrees``, box for box, and its count phase 5's),
    then the four-clique and the diamond on `auto` and
    on `fused` at ``scale``, each equal to its scipy oracle."""
    from repro_torch.core.boxing import plan_boxes_from_degrees
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.query import QueryEngine, patterns
    listing = shared["listing"]
    state = listing["state"]
    out = {"phase": "query", "runs": {}}
    t0 = time.perf_counter()
    eng = QueryEngine(patterns.triangle(),
                      relations=query_source(
                          np, (state["indptr"], state["indices"])),
                      mem_words=listing["mem_words"], workers=QUERY_WORKERS)
    plan = eng.plan()
    t_plan = time.perf_counter() - t0
    boxes = [(b[0][0], b[0][1], b[1][0], b[1][1]) for b in plan.boxes]
    want = plan_boxes_from_degrees(state["indptr"], listing["mem_words"])
    assert boxes == [tuple(b) for b in want], (len(boxes), len(want))
    count, wall, launches = run_query_count(torch, ops, eng)
    assert launches["intersect"] > 0, launches
    assert count == listing["oracle"], (count, listing["oracle"])
    out["runs"]["triangle/auto"] = {
        "scale": LIST_SCALE, "mem_words": listing["mem_words"],
        "workers": QUERY_WORKERS, "count": count,
        "count_listing_phase": listing["oracle"], "boxes": len(boxes),
        "plan_s": t_plan, "count_s": wall, "launches": launches,
        "lanes": query_stats(eng.stats)}
    runs = [launches]
    t0 = time.perf_counter()
    src, dst = rmat_graph(1 << scale, 16 << scale, seed=0)
    a, b = orient_edges(src, dst)
    csr = csr_from_edges(a, b, n_nodes=int(max(a.max(), b.max())) + 1)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj = oriented_adjacency(np, src, dst)
    oracles = {"four_clique": four_clique_oracle(np, adj),
               "diamond": diamond_oracle(adj)}
    out.update(scale=scale, mem_words=mem_words, edges=int(len(a)),
               gen_s=t_gen, oracle_s=time.perf_counter() - t0,
               oracles=oracles)
    shared["query"] = {"csr": csr, "oracles": oracles, "src": src,
                       "dst": dst}
    for name in ("four_clique", "diamond"):
        for backend in ("auto", "fused"):
            workers = QUERY_WORKERS if backend == "auto" else 1
            eng = QueryEngine(patterns.PATTERNS[name](),
                              relations=query_source(np, csr),
                              mem_words=mem_words, backend=backend,
                              workers=workers)
            count, wall, launches = run_query_count(torch, ops, eng)
            stats = eng.stats
            assert count == oracles[name], (name, backend, count,
                                            oracles[name])
            if backend == "fused":
                assert stats.n_fused_boxes > 0, query_stats(stats)
                assert launches["lftj_fused"] > 0, launches
            elif name == "diamond":
                # the four-clique's innermost variable has three bound
                # atoms, which the host lane intersects (as in the
                # reference); the diamond's has two: the intersect kernel
                assert launches["intersect"] > 0, launches
            out["runs"][f"{name}/{backend}"] = {
                "count": count, "count_s": wall, "workers": workers,
                "launches": launches,
                "lanes": query_stats(stats)}
            runs.append(launches)
    shared["query"]["diamond_fused_s"] = out["runs"]["diamond/fused"][
        "count_s"]
    out["launches"] = {k: sum(r[k] for r in runs) for k in ops}
    return out


def file_sha256(path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    return digest.hexdigest()


def io_ledger(stats) -> dict:
    return {f: getattr(stats, f) for f in (
        "block_reads", "block_writes", "word_reads", "cache_hits",
        "cache_misses", "cache_hit_words")}


def phase_outofcore(torch, np, ops, shared) -> dict:
    """The main path out of core: phase 3's graph ingested into an edge
    store (the external sort spills runs; the file's sha256 equals
    ``write_edge_store_csr``'s of phase 3's CSR) and counted from it with
    ``degree_bins`` and a ``SliceCache`` at 1 and 4 workers (counts equal
    to phase 3's, identical I/O ledgers); phase 5's graph listed from a
    store (bytes equal to phase 5's card listing); the diamond counted from
    a store on the fused lane (count equal to phase 8's)."""
    import tempfile
    from repro_torch import (QueryEngine, TriangleEngine, patterns,
                             write_edge_store_csr)
    rmat, listing, query = shared["rmat"], shared["listing"], shared["query"]
    out = {"phase": "outofcore", "scale": RMAT_SCALE,
           "mem_words": RMAT_MEM_WORDS, "cache_words": OOC_CACHE_WORDS}
    runs = []
    with tempfile.TemporaryDirectory(prefix="outofcore-") as tmp:
        tmp = Path(tmp)
        reset_launches(ops)
        t0 = time.perf_counter()
        eng = TriangleEngine.ingest(tmp / "ingest.csr",
                                    (rmat["src"], rmat["dst"]),
                                    ingest_budget_words=(
                                        OOC_INGEST_BUDGET_WORDS),
                                    mem_words=RMAT_MEM_WORDS,
                                    degree_bins=True,
                                    cache_words=OOC_CACHE_WORDS)
        t_ingest = time.perf_counter() - t0
        runs.append(read_launches(ops))
        assert eng.n_spill_runs >= 2, eng.n_spill_runs
        t0 = time.perf_counter()
        write_edge_store_csr(tmp / "csr.csr", *rmat["csr"],
                             orientation="minmax")
        t_csr = time.perf_counter() - t0
        sha = {"ingest": file_sha256(tmp / "ingest.csr"),
               "write_edge_store_csr": file_sha256(tmp / "csr.csr")}
        assert sha["ingest"] == sha["write_edge_store_csr"], sha
        store_bytes = (tmp / "ingest.csr").stat().st_size
        graph_words = int(eng.indptr[-1]) + eng.nv + 1
        out.update(ingest_s=t_ingest, write_csr_s=t_csr,
                   spill_runs=eng.n_spill_runs, store_bytes=store_bytes,
                   ingest_budget_words=OOC_INGEST_BUDGET_WORDS,
                   sha256=sha["ingest"],
                   graph_words=graph_words,
                   graph_over_budget=graph_words / RMAT_MEM_WORDS,
                   counts={})
        ledgers = []
        for workers in (1, 4):
            eng = TriangleEngine(store=tmp / "ingest.csr",
                                 mem_words=RMAT_MEM_WORDS, degree_bins=True,
                                 cache_words=OOC_CACHE_WORDS,
                                 workers=workers)
            t0 = time.perf_counter()
            boxes = eng.plan()
            t_plan = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            reset_launches(ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            count = eng.count()
            torch.cuda.synchronize()
            t_count = time.perf_counter() - t0
            launches = read_launches(ops)
            runs.append(launches)
            stats = eng.stats
            assert count == rmat["count"], (workers, count, rmat["count"])
            assert stats.source == "edgestore", stats.source
            assert stats.n_binary_boxes > 0 and stats.padded_words > 0, \
                lane_stats(stats)
            assert launches["intersect"] > 0, launches
            ledgers.append(io_ledger(stats))
            out["counts"][f"workers{workers}"] = {
                "count": count, "count_rmat_phase": rmat["count"],
                "boxes": len(boxes), "boxes_rmat_phase": rmat["boxes"],
                "plan_s": t_plan, "count_s": t_count,
                "whole_s": t_plan + t_count, "lanes": lane_stats(stats),
                "padded_words": stats.padded_words,
                "actual_words": stats.actual_words, "io": ledgers[-1],
                "cache_hit_rate": stats.cache_hit_rate,
                "launches": launches,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        assert ledgers[0] == ledgers[1], ledgers
        shared["outofcore"] = {"io": ledgers[0],
                               "count_s": out["counts"]["workers1"]
                               ["count_s"]}
        del eng
        # phase 5's graph from a store: list() with forced rescans
        state = listing["state"]
        write_edge_store_csr(tmp / "listing.csr", state["indptr"],
                             state["indices"],
                             orientation=state["orientation"])
        eng = TriangleEngine(store=tmp / "listing.csr",
                             mem_words=listing["mem_words"])
        reset_launches(ops)
        t0 = time.perf_counter()
        tris = eng.list()
        t_list = time.perf_counter() - t0
        count = len(tris)
        cap = max(1, min(256, count // (4 * max(1, eng.stats.n_boxes))))
        forced = eng.list(capacity=cap)
        runs.append(read_launches(ops))
        assert eng.stats.n_rescans > 0, eng.stats.n_rescans
        assert forced.tobytes() == tris.tobytes()
        digest = hashlib.sha256(tris.tobytes()).hexdigest()
        assert digest == listing["list_sha256"], digest
        assert count == listing["oracle"], (count, listing["oracle"])
        out["listing"] = {"scale": LIST_SCALE,
                          "mem_words": listing["mem_words"],
                          "boxes": eng.stats.n_boxes, "listed": count,
                          "list_s": t_list, "list_s_in_memory":
                          listing["list_s"], "forced_capacity": cap,
                          "rescans_forced": eng.stats.n_rescans,
                          "io": io_ledger(eng.stats)}
        del eng, tris, forced
        # the diamond from a store on the fused lane
        write_edge_store_csr(tmp / "query.csr", *query["csr"],
                             orientation="minmax")
        qe = QueryEngine(patterns.diamond(), store=tmp / "query.csr",
                         mem_words=OOC_QUERY_MEM_WORDS, backend="fused",
                         cache_words=OOC_QUERY_CACHE_WORDS)
        count, wall, launches = run_query_count(torch, ops, qe)
        runs.append(launches)
        assert count == query["oracles"]["diamond"], (
            count, query["oracles"]["diamond"])
        assert qe.stats.n_fused_boxes > 0, query_stats(qe.stats)
        assert launches["lftj_fused"] > 0, launches
        shared["outofcore"]["diamond_s"] = wall
        shared["outofcore"]["diamond_io"] = io_ledger(qe.stats)
        out["diamond"] = {"scale": QUERY_SCALE,
                          "mem_words": OOC_QUERY_MEM_WORDS,
                          "cache_words": OOC_QUERY_CACHE_WORDS,
                          "order": list(qe.order), "count": count,
                          "count_s": wall,
                          "count_s_in_memory": query["diamond_fused_s"],
                          "launches": launches,
                          "lanes": query_stats(qe.stats),
                          "io": io_ledger(qe.stats),
                          "cache_hit_rate": qe.stats.cache_hit_rate}
    out["launches"] = {k: sum(r[k] for r in runs) for k in ops}
    return out


def phase_query_listing(torch, np, ops, shared, scale: int,
                        mem_words: int) -> dict:
    """four-clique ``list()`` on ``backend="fused"``: the listing kernel
    must launch; its bytes equal the same call on the CPU and a run at a
    capacity that forces rescans; its total equals the host backend and
    the scipy oracle."""
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.query import QueryEngine, patterns
    src, dst = rmat_graph(1 << scale, 16 << scale, seed=1)
    a, b = orient_edges(src, dst)
    csr = csr_from_edges(a, b, n_nodes=int(max(a.max(), b.max())) + 1)

    def engine(**kw):
        return QueryEngine(patterns.four_clique(),
                           relations=query_source(np, csr),
                           mem_words=mem_words, **kw)

    eng = engine(backend="fused")
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = eng.list()
    torch.cuda.synchronize()
    t_list = time.perf_counter() - t0
    rescans_default = eng.stats.n_rescans
    stats = query_stats(eng.stats)
    # a capacity well below the mean per-box total forces rescans
    cap = max(1, min(1024, len(rows) // (4 * max(1, eng.stats.n_boxes))))
    forced = eng.list(capacity=cap)
    rescans_forced = eng.stats.n_rescans
    launches = read_launches(ops)
    assert launches["lftj_fused_list"] > 0, launches
    assert rescans_forced > rescans_default, (rescans_forced,
                                              rescans_default)
    assert forced.tobytes() == rows.tobytes()
    cpu = shared["host_children"].result("query_listing")
    assert same_listing(rows, cpu), cpu
    count_host = engine(backend="host").count()
    oracle = four_clique_oracle(np, oriented_adjacency(np, src, dst))
    assert len(rows) == count_host == oracle, (len(rows), count_host,
                                               oracle)
    shared["query_listing"] = {"csr": csr, "mem_words": mem_words,
                               "src": src, "dst": dst,
                               "list_s": t_list, "listed": len(rows),
                               "list_sha256": hashlib.sha256(
                                   rows.tobytes()).hexdigest()}
    return {"phase": "query_listing", "scale": scale, "edges": int(len(a)),
            "mem_words": mem_words, "listed": len(rows), "lanes": stats,
            "launches": launches, "rescans_default": rescans_default,
            "forced_capacity": cap, "rescans_forced": rescans_forced,
            "list_s": t_list, "cpu_list_s": cpu["s"],
            "cpu_list_wait_s": cpu["wait_s"],
            "count_host_backend": count_host, "scipy_oracle": oracle}


def csr_edges(np, indptr, indices):
    """The (src, dst) edge arrays of a CSR."""
    return (np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                      np.diff(indptr)), np.asarray(indices, np.int64))


def span_seconds(tracer) -> dict:
    """{span name: [count, summed seconds]} over a tracer's B/E pairs."""
    begin, out = {}, {}
    for e in tracer.snapshot():
        if e["ph"] == "B":
            begin[e["sid"]] = e
        elif e["ph"] == "E" and e["sid"] in begin:
            b = begin.pop(e["sid"])
            acc = out.setdefault(b["name"], [0, 0.0])
            acc[0] += 1
            acc[1] += (e["ts"] - b["ts"]) * 1e-6
    return out


def traced_run(torch, ops, make, lanes_of, tmp, label: str) -> dict:
    """One untraced and one traced count of the engines ``make`` builds:
    the counts equal, one ``box.fetch`` span per planned box, one
    ``box.compute`` span per box a lane counted, ``kernel.launch`` events
    summing to ``device_invocations``; the trace exported to ``tmp``."""
    from repro_torch import MetricsRegistry, Tracer
    plain = make()
    want, wall, _ = drive(torch, ops, plain.count)
    tracer, reg = Tracer(capacity=TRACE_CAPACITY), MetricsRegistry()
    eng = make(tracer=tracer, metrics=reg)
    got, traced_wall, launches = drive(torch, ops, eng.count)
    assert got == want, (label, got, want)
    assert tracer.dropped == 0, tracer.dropped
    spans = span_seconds(tracer)
    events = [e for e in tracer.snapshot() if e["ph"] == "i"]
    kernel_events = sum(e["args"]["invocations"] for e in events
                        if e["name"] == "kernel.launch")
    stats = eng.stats
    n_boxes = stats.n_boxes
    assert spans["box.fetch"][0] == n_boxes, (spans, n_boxes)
    assert spans["box.compute"][0] == sum(lanes_of(stats).values()), \
        (spans, lanes_of(stats))
    assert kernel_events == stats.device_invocations, (
        kernel_events, stats.device_invocations)
    path = tracer.export_chrome(str(tmp / f"{label}.trace.json"))
    return {"count": got, "boxes": n_boxes, "wall_s": wall,
            "traced_wall_s": traced_wall,
            "stage_s": {k: spans.get(k, [0, 0.0])[1]
                        for k in ("box.fetch", "box.build", "box.compute")},
            "spans": {k: v[0] for k, v in spans.items()},
            "kernel_launch_events": kernel_events,
            "device_invocations": stats.device_invocations,
            "cache_events": sum(1 for e in events
                                if e["name"].startswith("cache.")),
            "trace_bytes": Path(path).stat().st_size, "launches": launches,
            "metrics_kernel_invocations": sum(
                reg.series("kernel.invocations").values())}


def phase_api(torch, np, ops, shared, recorders) -> dict:
    """The paper's public API on the card: ``count_triangles`` methods
    vectorized [intersect] on the rmat graph in both orientations, dense
    [triangle_dense] on the clustered graph, boxed_vec and auto on the
    listing graph, each equal to its phase's count; MGT [intersect] on the
    rmat graph beside the out-of-core store count; the Prop. 4 instance on
    the host at test size and on the card; the three measured crossovers
    [triangle_dense, intersect, lftj_fused]; traced TriangleEngine and
    store-backed QueryEngine runs."""
    import os
    import tempfile
    from repro_torch import (QueryEngine, adversarial_graph, count_triangles,
                             mgt_triangle_count, patterns,
                             write_edge_store_csr)
    from repro_torch.convert import engine_from_state
    from repro_torch.core import engine as core_engine
    from repro_torch.core.iomodel import BlockDevice
    from repro_torch.core.lftj_torch import orient_edges
    rmat, clustered, listing = (shared["rmat"], shared["clustered"],
                                shared["listing"])
    query, ooc = shared["query"], shared["outofcore"]
    for rec in recorders:
        rec.paused = True
    runs, out = [], {"phase": "api"}
    try:
        # vectorized: one intersect launch over every oriented edge, in
        # minmax orientation on phase 3's graph and in degree orientation
        # on phase 5's (PERF.md §4 says why)
        vec = {}
        for orientation, graph, want in (
                ("minmax", rmat, rmat["count"]),
                ("degree", listing, listing["oracle"])):
            count, wall, launches = drive(torch, ops, lambda: count_triangles(
                graph["src"], graph["dst"], method="vectorized",
                orientation=orientation))
            runs.append(launches)
            assert count == want, (orientation, count, want)
            assert launches["intersect"] == 1, launches
            vec[orientation] = {"count": count, "wall_s": wall,
                                "edges": int(len(graph["src"]))}
        dev = torch.device("cuda")
        a, b = csr_edges(np, *rmat["csr"])
        off = torch.from_numpy(rmat["csr"][0]).to(dev)
        vals = torch.from_numpy(rmat["csr"][1]).to(dev)
        eu, ev = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        from repro_torch.kernels.intersect import ops as intersect_ops
        vec["minmax"]["launch_ms"] = cuda_ms(
            lambda: intersect_ops.intersect_count_csr(off, vals, eu, off,
                                                      vals, ev), 5)
        vec["edges"] = len(a)
        del off, vals, eu, ev
        out["vectorized"] = vec
        # LFTJ against MGT: the same graph, budget and block size
        mgt_dev = BlockDevice(block_words=MGT_BLOCK_WORDS,
                              cache_blocks=RMAT_MEM_WORDS // MGT_BLOCK_WORDS)
        (count, info), wall, launches = drive(
            torch, ops, lambda: mgt_triangle_count(
                rmat["src"], rmat["dst"], RMAT_MEM_WORDS, device=mgt_dev))
        runs.append(launches)
        assert count == rmat["count"], (count, rmat["count"])
        # one launch per chunk with pivots that have neighbors
        assert 0 < launches["intersect"] <= info["n_chunks"], (launches,
                                                               info)
        lftj_reads = ooc["io"]["block_reads"]
        out["mgt"] = {"count": count, "mem_words": RMAT_MEM_WORDS,
                      "block_words": MGT_BLOCK_WORDS, **info,
                      "block_reads": mgt_dev.stats.block_reads,
                      "word_reads": mgt_dev.stats.word_reads, "wall_s": wall,
                      "lftj_store_count_s": ooc["count_s"],
                      "lftj_in_memory_count_s": rmat["count_s"],
                      "lftj_block_reads": lftj_reads,
                      "lftj_word_reads": ooc["io"]["word_reads"],
                      "wall_ratio_mgt_over_lftj_store":
                          wall / ooc["count_s"],
                      "wall_ratio_mgt_over_lftj_in_memory":
                          wall / rmat["count_s"],
                      "block_read_ratio_mgt_over_lftj":
                          mgt_dev.stats.block_reads / lftj_reads}
        # dense: one triangle_dense call on the clustered graph's adjacency
        st = clustered["state"]
        c_src, c_dst = csr_edges(np, st["indptr"], st["indices"])
        count, wall, launches = drive(torch, ops, lambda: count_triangles(
            c_src, c_dst, method="dense"))
        runs.append(launches)
        assert count == clustered["oracle"] and count > 2 ** 31, count
        assert launches["triangle_dense"] == 1, launches
        from repro_torch.kernels.triangle_dense import ops as dense_ops
        ca, cb = orient_edges(c_src, c_dst)
        n = int(max(ca.max(), cb.max())) + 1
        adj = torch.zeros((n, n), dtype=torch.uint8, device=dev)
        adj[torch.from_numpy(ca).to(dev), torch.from_numpy(cb).to(dev)] = 1
        out["dense"] = {"count": count, "vertices": n, "wall_s": wall,
                        "adjacency_bytes": n * n,
                        "call_ms": cuda_ms(lambda: dense_ops.triangle_count(
                            adj, adj, adj), 5)}
        del adj
        # boxed_vec and auto with a budget on the listing graph
        st = listing["state"]
        l_src, l_dst = csr_edges(np, st["indptr"], st["indices"])
        out["budgeted"] = {}
        for method in ("boxed_vec", "auto"):
            count, wall, launches = drive(torch, ops, lambda: count_triangles(
                l_src, l_dst, method=method, mem_words=listing["mem_words"]))
            runs.append(launches)
            assert count == listing["oracle"], (method, count)
            out["budgeted"][method] = {"count": count, "wall_s": wall,
                                       "launches": launches}
        # the Prop. 4 instance: host joins with block reads at test size
        n_e, m, bsz = ADV_TEST
        g_src, g_dst = adversarial_graph(n_e, m, bsz)
        adv = {"test": {"n": n_e, "m": m, "b": bsz, "edges": len(g_src)}}
        for method in ("faithful", "boxed"):
            bdev = BlockDevice(block_words=bsz, cache_blocks=m // bsz)
            t0 = time.perf_counter()
            count = count_triangles(g_src, g_dst, method=method,
                                    mem_words=m, device=bdev)
            adv["test"][method] = {"count": count,
                                   "block_reads": bdev.stats.block_reads,
                                   "wall_s": time.perf_counter() - t0}
        assert adv["test"]["faithful"]["count"] \
            == adv["test"]["boxed"]["count"], adv
        assert adv["test"]["faithful"]["block_reads"] >= len(g_src), adv
        # ... and on the card at a card size
        n_e, m, bsz = ADV_CARD
        g_src, g_dst = adversarial_graph(n_e, m, bsz)
        adv["card"] = {"n": n_e, "m": m, "b": bsz, "edges": len(g_src),
                       "budget": ADV_CARD_BUDGET}
        for method in ("vectorized", "boxed_vec", "mgt"):
            count, wall, launches = drive(torch, ops, lambda: count_triangles(
                g_src, g_dst, method=method, mem_words=ADV_CARD_BUDGET))
            runs.append(launches)
            adv["card"][method] = {"count": count, "wall_s": wall,
                                   "launches": launches}
        counts = {adv["card"][k]["count"]
                  for k in ("vectorized", "boxed_vec", "mgt")}
        assert len(counts) == 1, adv["card"]
        out["adversarial"] = adv
        with tempfile.TemporaryDirectory(prefix="api-") as tmp:
            tmp = Path(tmp)
            # the measured crossovers, kept in the port's cache under tmp
            os.environ["REPRO_TORCH_CACHE_DIR"] = str(tmp / "cache")
            cal = {"static": {"dense": 0.05, "intersect": 0.05 / 4,
                              "fused": None}}
            for nv in CALIBRATION_NVS:
                def measure():
                    return {name: fn(nv=nv) for name, fn in (
                        ("dense", core_engine.measure_dense_crossover),
                        ("intersect",
                         core_engine.measure_intersect_crossover),
                        ("fused", core_engine.measure_fused_crossover))}
                got, wall, launches = drive(torch, ops, measure)
                runs.append(launches)
                for name, kernel in (("dense", "triangle_dense"),
                                     ("intersect", "intersect"),
                                     ("fused", "lftj_fused")):
                    assert launches[kernel] > 0, (name, launches)
                cal[f"nv{nv}"] = dict(got, wall_s=wall, launches=launches)
            cal["cache"] = json.loads(
                (tmp / "cache" / "crossover.json").read_text())
            eng = engine_from_state(
                listing["state"], mem_words=listing["mem_words"],
                dense_threshold="measured", intersect_threshold="measured",
                fused_threshold="measured")
            count, wall, launches = drive(torch, ops, eng.count)
            runs.append(launches)
            assert count == listing["oracle"], count
            cal["listing_measured"] = {
                "count": count, "count_s": wall,
                "count_s_static": listing["count_s"],
                "thresholds": [eng.dense_threshold, eng.intersect_threshold,
                               eng.fused_threshold],
                "lanes": lane_stats(eng.stats)}
            del os.environ["REPRO_TORCH_CACHE_DIR"]
            out["calibration"] = cal
            # traced runs: TriangleEngine on the listing graph, the diamond
            # from a store on the fused lane
            trace = {}
            trace["engine"] = traced_run(
                torch, ops, lambda **kw: engine_from_state(
                    listing["state"], mem_words=listing["mem_words"], **kw),
                lane_stats, tmp, "engine")
            runs.append(trace["engine"].pop("launches"))
            assert trace["engine"]["count"] == listing["oracle"]
            write_edge_store_csr(tmp / "query.csr", *query["csr"],
                                 orientation="minmax")
            trace["diamond"] = traced_run(
                torch, ops, lambda **kw: QueryEngine(
                    patterns.diamond(), store=tmp / "query.csr",
                    mem_words=TRACE_QUERY_MEM_WORDS, backend="fused",
                    cache_words=TRACE_QUERY_CACHE_WORDS, **kw),
                query_lane_counts, tmp, "diamond")
            runs.append(trace["diamond"].pop("launches"))
            assert trace["diamond"]["count"] \
                == query["oracles"]["diamond"], trace["diamond"]
            assert trace["diamond"]["cache_events"] > 0, trace["diamond"]
            trace["diamond"]["mem_words"] = TRACE_QUERY_MEM_WORDS
            trace["diamond"]["outofcore_phase_s"] = ooc["diamond_s"]
            out["trace"] = trace
    finally:
        for rec in recorders:
            rec.paused = False
        os.environ.pop("REPRO_TORCH_CACHE_DIR", None)
    out["launches"] = {k: sum(r[k] for r in runs) for k in ops}
    return out


# ---------------------------------------------------------------------------
# phase: sharded execution and the box fabric
# ---------------------------------------------------------------------------

def shard_stats(stats) -> dict:
    """A sharded run's shard layout: the shards' edges and rows, and the
    reference's padded (n_shards, R, K) slice with the bytes it would
    take (int32), which the port never allocates."""
    shape = stats.local_npad_shape
    return {"n_shards": stats.n_shards, "shard_edges": stats.shard_edges,
            "shard_rows": stats.shard_rows,
            "local_npad_shape": list(shape) if shape else None,
            "local_npad_bytes": 4 * shape[0] * shape[1] * shape[2]
            if shape else None,
            "lanes": lane_stats(stats), "n_rescans": stats.n_rescans}


def fabric_ledgers_equal_oracles(fab) -> list:
    """Each shard of the fabric's last count against its solo oracle
    engine (the same boxes over the full store on a fresh device): the
    per-box counts and every ledger field byte for byte. Returns the
    shards' block reads."""
    fields = ("block_reads", "block_writes", "word_reads", "cache_hits",
              "cache_misses", "cache_hit_words", "slice_words_read",
              "n_results")
    reads = []
    for rep in fab.reports:
        orc = fab.oracle_engine(rep.shard)
        want = orc.run_boxes("count")
        assert [r for r in rep.results] == want, rep.shard
        for f in fields:
            assert getattr(rep.stats, f) == getattr(orc.stats, f), (
                rep.shard, f, getattr(rep.stats, f), getattr(orc.stats, f))
        reads.append(rep.stats.block_reads)
    return reads


def run_fabric_workers(tmp, scale: int, mem_words: int,
                       torch_device: str = "cuda") -> tuple:
    """The worker CLI, two processes on the card at once, each running its
    half of a CLI_SHARDS-shard triangle fabric on the RMAT graph at
    ``scale`` (the listing phase's seed); (merged count, wall s, each
    process's shards). No process group: NCCL takes one rank a card."""
    import os
    from repro_torch.parallel.fabric import Fabric
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_FABRIC_")}
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    outs = [tmp / f"part{p}.json" for p in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.parallel.fabric",
         "--pattern", "triangle", "--graph", "rmat", "--nv", str(1 << scale),
         "--ne", str(16 << scale), "--seed", "1", "--shards",
         str(CLI_SHARDS), "--mem-words", str(mem_words),
         "--process-index", str(p), "--n-processes", "2",
         "--torch-device", torch_device, "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for p, out in enumerate(outs)]
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            assert proc.returncode == 0, stderr[-3000:]
            assert "FABRIC-PARTIAL-OK" in stdout, stdout[-2000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    parts = [json.loads(out.read_text()) for out in outs]
    return (Fabric.merge_partials(parts), wall,
            [len(part["shards"]) for part in parts])


def phase_shard(torch, np, ops, shared, recorders) -> dict:
    """Sharded execution and the box fabric on the card, SHARD_DEVICES
    shards on cuda:0 repeated: ``TriangleEngine(shard=True)`` on phase 3's
    graph in memory, unbinned and binned [intersect], and from a store
    (its count equal to phase 3's, its block reads one sequential pass);
    the sharded ``list()`` of phase 5's graph, unbinned and binned, with
    rescans (bytes equal to phase 5's); ``Fabric``: the triangle on phase
    5's graph with host and mesh reductions [intersect], the diamond from
    phase 9's query store on the fused lane [lftj_fused] with every shard's
    ledger equal to its oracle engine's, the four-clique ``list()`` of
    phase 10's graph on the fused lane [lftj_fused_list]; the worker CLI,
    two processes on the card at once, merged. Calls of this phase are not
    recorded for the timing phase."""
    import tempfile
    import warnings
    from repro_torch import Fabric, TriangleEngine, patterns
    from repro_torch import write_edge_store_csr
    from repro_torch.convert import engine_from_state
    from repro_torch.core.iomodel import BlockDevice
    from repro_torch.data.edgestore import EdgeStore
    from repro_torch.launch.mesh import fabric_mesh
    rmat, listing = shared["rmat"], shared["listing"]
    query, qlist = shared["query"], shared["query_listing"]
    devices = fabric_mesh(SHARD_DEVICES,
                          devices=[torch.device("cuda", 0)] * SHARD_DEVICES)
    for rec in recorders:
        rec.paused = True
    runs, out = [], {"phase": "shard", "n_shards": SHARD_DEVICES,
                     "devices": [str(d) for d in devices]}
    try:
        # TriangleEngine(shard=True) on the scale-20 graph, in memory
        state = {"indptr": rmat["csr"][0], "indices": rmat["csr"][1],
                 "orientation": "minmax", "nv": len(rmat["csr"][0]) - 1,
                 "plan": rmat["plan"]}
        mem = {}
        for bins in (False, True):
            eng = engine_from_state(state, mem_words=RMAT_MEM_WORDS,
                                    shard=True, devices=devices,
                                    degree_bins=bins)
            torch.cuda.reset_peak_memory_stats()
            count, wall, launches = drive(torch, ops, eng.count)
            runs.append(launches)
            peak = torch.cuda.max_memory_allocated()
            assert count == rmat["count"], (bins, count, rmat["count"])
            assert eng.stats.n_shards == SHARD_DEVICES, eng.stats.n_shards
            assert launches["intersect"] > 0, launches
            row = dict(shard_stats(eng.stats), count=count, count_s=wall,
                       count_s_unsharded=rmat["count_s"], launches=launches,
                       max_memory_allocated=peak)
            if not bins:
                # the padded slice is never allocated: the peak is below
                # even one shard's (R, K) int32 matrix
                _, r, k = eng.stats.local_npad_shape
                assert peak < 4 * r * k, (peak, r, k)
            mem["binned" if bins else "unbinned"] = row
        out["memory"] = mem
        del eng
        with tempfile.TemporaryDirectory(prefix="shard-") as tmp:
            tmp = Path(tmp)
            # the same engine from phase 9's store (written from phase 3's
            # CSR: phase 9 checks it equals the ingested file byte for byte)
            write_edge_store_csr(tmp / "rmat.csr", *rmat["csr"],
                                 orientation="minmax")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                eng = TriangleEngine(store=tmp / "rmat.csr",
                                     mem_words=RMAT_MEM_WORDS,
                                     degree_bins=True,
                                     cache_words=OOC_CACHE_WORDS,
                                     shard=True, devices=devices)
            torch.cuda.reset_peak_memory_stats()
            count, wall, launches = drive(torch, ops, eng.count)
            runs.append(launches)
            assert count == rmat["count"], (count, rmat["count"])
            assert launches["intersect"] > 0, launches
            one_pass = BlockDevice(eng.device.B,
                                   eng.device.cache_blocks)
            whole = EdgeStore(tmp / "rmat.csr", device=one_pass)
            whole.read_rows(0, whole.n_nodes - 1)
            io = io_ledger(eng.stats)
            assert io["block_reads"] == one_pass.stats.block_reads, io
            assert io["word_reads"] == one_pass.stats.word_reads, io
            assert io["cache_hits"] == io["cache_misses"] == 0, io
            out["store"] = dict(shard_stats(eng.stats), count=count,
                                count_s=wall, io=io,
                                one_pass_block_reads=(
                                    one_pass.stats.block_reads),
                                launches=launches,
                                max_memory_allocated=(
                                    torch.cuda.max_memory_allocated()))
            del eng, whole
            # sharded list() on phase 5's graph, at a capacity that rescans
            lst = {}
            for bins in (False, True):
                eng = engine_from_state(listing["state"],
                                        mem_words=listing["mem_words"],
                                        shard=True, devices=devices,
                                        degree_bins=bins)
                tris, wall, launches = drive(
                    torch, ops, lambda: eng.list(
                        capacity=SHARD_LIST_CAPACITY))
                runs.append(launches)
                digest = hashlib.sha256(tris.tobytes()).hexdigest()
                assert digest == listing["list_sha256"], (bins, digest)
                assert len(tris) == listing["oracle"], (bins, len(tris))
                assert eng.stats.n_rescans > 0, eng.stats.n_rescans
                lst["binned" if bins else "unbinned"] = dict(
                    shard_stats(eng.stats), listed=len(tris), list_s=wall,
                    list_s_unsharded=listing["list_s"],
                    capacity=SHARD_LIST_CAPACITY, launches=launches)
            out["listing"] = lst
            del eng, tris
            # the fabric: the triangle on phase 5's graph
            fab_out = {}
            lstate = listing["state"]
            fab = Fabric(patterns.triangle(),
                         relations=query_source(
                             np, (lstate["indptr"], lstate["indices"])),
                         mem_words=listing["mem_words"], mesh=devices)
            for reduce in ("host", "mesh"):
                count, wall, launches = drive(
                    torch, ops, lambda: fab.count(reduce=reduce))
                runs.append(launches)
                assert count == listing["oracle"], (reduce, count)
                assert launches["intersect"] > 0, launches
                fab_out[f"triangle/{reduce}"] = {
                    "count": count, "count_s": wall, "launches": launches,
                    "boxes": fab.stats.n_boxes,
                    "shard_boxes": fab.stats.shard_boxes,
                    "shard_mass": fab.stats.shard_mass,
                    "balance": fab.stats.balance}
            # the diamond from phase 9's query store, fused
            write_edge_store_csr(tmp / "query.csr", *query["csr"],
                                 orientation="minmax")
            fab = Fabric(patterns.diamond(), store=tmp / "query.csr",
                         mem_words=TRACE_QUERY_MEM_WORDS,
                         cache_words=TRACE_QUERY_CACHE_WORDS,
                         backend="fused", mesh=devices)
            count, wall, launches = drive(torch, ops, fab.count)
            runs.append(launches)
            assert count == query["oracles"]["diamond"], count
            assert launches["lftj_fused"] > 0, launches
            t0 = time.perf_counter()
            reads = fabric_ledgers_equal_oracles(fab)
            fab_out["diamond/store/fused"] = {
                "count": count, "count_s": wall, "launches": launches,
                "mem_words": TRACE_QUERY_MEM_WORDS,
                "cache_words": TRACE_QUERY_CACHE_WORDS,
                "boxes": fab.stats.n_boxes,
                "shard_boxes": fab.stats.shard_boxes,
                "shard_block_reads": reads,
                "shipped_words": fab.stats.shipped_words,
                "oracles_s": time.perf_counter() - t0}
            # the four-clique list() of phase 10's graph, fused
            fab = Fabric(patterns.four_clique(),
                         relations=query_source(np, qlist["csr"]),
                         mem_words=qlist["mem_words"], backend="fused",
                         mesh=devices)
            rows, wall, launches = drive(torch, ops, fab.list)
            runs.append(launches)
            digest = hashlib.sha256(rows.tobytes()).hexdigest()
            assert digest == qlist["list_sha256"], digest
            assert launches["lftj_fused_list"] > 0, launches
            fab_out["four_clique/list/fused"] = {
                "listed": len(rows), "list_s": wall,
                "list_s_unsharded": qlist["list_s"], "launches": launches,
                "boxes": fab.stats.n_boxes,
                "shard_boxes": fab.stats.shard_boxes}
            out["fabric"] = fab_out
            # the worker CLI: two processes on the card at once
            merged, wall, shards = run_fabric_workers(
                tmp, LIST_SCALE, listing["mem_words"])
            assert merged == fab_out["triangle/host"]["count"], merged
            out["worker_cli"] = {"processes": 2, "shards": CLI_SHARDS,
                                 "shards_per_process": shards,
                                 "merged_count": merged, "wall_s": wall}
    finally:
        for rec in recorders:
            rec.paused = False
    out["launches"] = {k: sum(r[k] for r in runs) for k in ops}
    return out


# ---------------------------------------------------------------------------
# phase: the query server (concurrent queries, admission, shared caches,
# streamed listing, retry rounds)
# ---------------------------------------------------------------------------

def live_threads_since(before: set) -> list:
    """Threads started since ``before`` (a set of idents) still alive,
    after up to 10 s for them to wind down."""
    import threading
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive()]
        if not left or time.monotonic() > deadline:
            return [t.name for t in left]
        time.sleep(0.01)


def latency_quantiles(reg, modes) -> dict:
    """p50/p90/p99 of the ``serve.latency_s`` histogram per mode (queries
    that finished), read from the server's MetricsRegistry."""
    return {mode: {f"p{int(q * 100)}": reg.quantile(
        "serve.latency_s", q, mode=mode, status="done")
        for q in (0.5, 0.9, 0.99)} for mode in modes}


def tags_sum_to_global(device) -> bool:
    """The device's per-query ledgers sum exactly to its global ledger."""
    tags = device.all_tag_stats().values()
    return all(sum(getattr(t, f) for t in tags) == getattr(device.stats, f)
               for f in ("block_reads", "block_writes", "word_reads"))


def serve_line(srv, reg, n_queries: int, wall: float, launches: dict,
               solo_reads: int, solo_wall: float, modes,
               reads=None) -> dict:
    """A server's JSON record: throughput, latency quantiles, admission
    peak, block reads (default: the device's, every query's) against the
    solo envelopes, plan cache, retry rounds and the kernels' launches."""
    if reads is None:
        reads = srv.device.stats.block_reads
    return {"queries": n_queries, "wall_s": wall,
            "queries_per_s": n_queries / wall if wall else None,
            "latency_s": latency_quantiles(reg, modes),
            "mem_words": srv.mem_words,
            "peak_reserved": srv.admission.peak_reserved,
            "peak_active": srv.admission.peak_active,
            "block_reads": reads, "solo_block_reads": solo_reads,
            "envelope_ratio": reads / solo_reads if solo_reads else None,
            "plan_hits": srv.plan_hits, "plan_misses": srv.plan_misses,
            "launches": launches, "solo_wall_sum_s": solo_wall,
            "served_over_solo_wall": wall / solo_wall if solo_wall else None}


def serve_check_common(srv, handles, line: dict) -> None:
    assert line["peak_reserved"] <= srv.mem_words, line
    assert tags_sum_to_global(srv.device), srv.device.all_tag_stats()
    assert srv.admission.reserved_words == 0 and srv.admission.active == 0
    for h in handles:
        assert h.status in ("done", "cancelled"), (h.qid, h.status)


def serve_a(torch, np, ops, shared) -> dict:
    """Server A: the query phase's graph in memory on ``auto``; clients
    submit round-robin from SERVE_MIX at once, each query held to its
    serial ``solo_run`` at the same admitted budget and to the scipy
    oracle; block reads within SERVE_ENVELOPE_FACTOR of the solo sum."""
    import threading
    from repro_torch import MetricsRegistry
    from repro_torch.serve import Server
    query = shared["query"]
    adj = oriented_adjacency(np, query["src"], query["dst"])
    # path3: each edge (y, z) with any in-neighbour of y and any
    # out-neighbour of z
    indeg = np.asarray(adj.sum(axis=0)).ravel()
    outdeg = np.asarray(adj.sum(axis=1)).ravel()
    oracles = {"triangle": int(adj.multiply(adj @ adj.T).sum()),
               "path3": int(indeg @ (adj @ outdeg))}
    reg = MetricsRegistry()
    before = {t.ident for t in threading.enumerate()}
    srv = Server.from_graph(query["src"], query["dst"],
                            mem_words=SERVE_MEM_WORDS,
                            max_active=SERVE_MAX_ACTIVE,
                            queue_depth=SERVE_QUEUE_DEPTH,
                            workers_per_query=SERVE_WORKERS, metrics=reg)
    records, errors, handles = [], [], []
    lock, gate = threading.Lock(), threading.Event()

    def client(c: int) -> None:
        try:
            gate.wait(SERVE_TIMEOUT_S)
            for k in range(SERVE_QUERIES):
                name, mode = SERVE_MIX[(c + k) % len(SERVE_MIX)]
                stream = mode == "list"
                t0 = time.perf_counter()
                h = srv.submit(name, mode, want_words=SERVE_WANT_WORDS,
                               stream=stream, timeout=SERVE_TIMEOUT_S)
                with lock:
                    handles.append(h)
                pages = list(h.pages()) if stream else None
                result = h.result(SERVE_TIMEOUT_S)
                if stream:
                    # the pages in plan order are the whole listing
                    assert pages and np.concatenate(pages).tobytes() \
                        == result.tobytes(), h.qid
                with lock:
                    records.append({
                        "name": name, "mode": mode, "result": result,
                        "words": h.admitted_words, "qid": h.qid,
                        "retry_rounds": h.retry_rounds,
                        "pages": None if pages is None else len(pages),
                        "latency_s": time.perf_counter() - t0})
        except Exception as e:                   # noqa: BLE001
            with lock:
                errors.append(f"client {c}: {e!r}")

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"serve-client-{c}")
               for c in range(SERVE_CLIENTS)]
    try:
        reset_launches(ops)
        torch.cuda.synchronize()
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        gate.set()
        for t in threads:
            t.join(SERVE_TIMEOUT_S * SERVE_QUERIES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(ops)
        assert not any(t.is_alive() for t in threads), "client hung"
        assert not errors, errors
        assert len(records) == SERVE_CLIENTS * SERVE_QUERIES, len(records)
        # the serial oracle: one solo run per (pattern, mode, budget)
        solos = {}
        reset_launches(ops)
        for r in records:
            key = (r["name"], r["mode"], r["words"])
            if key not in solos:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, st = srv.solo_run(r["name"], r["mode"], words=r["words"])
                torch.cuda.synchronize()
                solos[key] = (out, st.block_reads, time.perf_counter() - t0)
        solo_launches = read_launches(ops)
        for r in records:
            want, _, _ = solos[(r["name"], r["mode"], r["words"])]
            assert r["retry_rounds"] == 0, r["qid"]
            if r["mode"] == "count":
                assert r["result"] == want == oracles[r["name"]], (
                    r["qid"], r["name"], r["result"], want)
            else:
                assert r["result"].tobytes() == want.tobytes(), r["qid"]
                assert len(want) == oracles["triangle"], len(want)
        solo_reads = sum(solos[(r["name"], r["mode"], r["words"])][1]
                         for r in records)
        solo_wall = sum(solos[(r["name"], r["mode"], r["words"])][2]
                        for r in records)
        reg.collect()
        line = serve_line(srv, reg, len(records), wall, launches,
                          solo_reads, solo_wall, ("count", "list"))
        assert line["block_reads"] \
            <= SERVE_ENVELOPE_FACTOR * solo_reads, line
        assert srv.plan_hits > 0, line
        assert launches["intersect"] > 0, launches
        serve_check_common(srv, handles, line)
    finally:
        srv.close()
    left = live_threads_since(before)
    assert not left, left
    line.update(scale=QUERY_SCALE, edges=int(adj.nnz),
                admitted_words=sorted({r["words"] for r in records}),
                oracles=oracles,
                pages=sum(r["pages"] or 0 for r in records),
                retry_rounds=sum(r["retry_rounds"] for r in records),
                client_latency_s={m: sorted(r["latency_s"] for r in records
                                            if r["mode"] == m)
                                  for m in ("count", "list")},
                solo_launches=solo_launches)
    return {"line": line, "runs": [launches, solo_launches]}


def serve_b(torch, np, ops, shared) -> dict:
    """Server B: the query phase's graph as a store on ``fused``; two
    diamond counts at once, one with a fault injected once into the work
    stage of one box (exactly one retry round), held to the outofcore
    phase's store diamond (the same query, budget, cache and store: the
    solo envelope); then the diamond through the box fabric from a
    Session, every shard's ledger equal to its oracle engine's."""
    import tempfile
    from repro_torch import write_edge_store_csr
    query = shared["query"]
    with tempfile.TemporaryDirectory(prefix="serve-") as tmp:
        path = Path(tmp) / "query.csr"
        write_edge_store_csr(path, *query["csr"], orientation="minmax")
        return serve_b_store(torch, ops, path, query["oracles"]["diamond"],
                             shared["outofcore"])


def serve_b_store(torch, ops, path, want: int, ooc: dict) -> dict:
    """Server B over the store at ``path`` (serve_b); ``want`` is the
    query phase's scipy diamond count, ``ooc`` the outofcore phase's
    results."""
    import threading
    from repro_torch import Fabric, MetricsRegistry, patterns
    from repro_torch.serve import Server, Session
    reg = MetricsRegistry()
    before = {t.ident for t in threading.enumerate()}
    srv = Server({"E": str(path)}, mem_words=SERVE_B_MEM_WORDS,
                 cache_words=SERVE_B_CACHE_WORDS,
                 max_active=SERVE_B_MAX_ACTIVE, backend="fused",
                 metrics=reg)
    fired, lock = [], threading.Lock()

    def fault(stage, qid, i):
        if stage == "work" and qid == "q0":
            with lock:
                if not fired:
                    fired.append(i)
                    raise RuntimeError(f"injected fault in box {i}")

    runs = []
    try:
        srv.fault_hook = fault
        reset_launches(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [srv.submit("diamond", want_words=SERVE_B_WANT_WORDS)
                   for _ in range(2)]
        counts = [h.result(SERVE_TIMEOUT_S) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(ops)
        runs.append(launches)
        srv.fault_hook = None
        assert counts == [want, want], (counts, want)
        assert len(fired) == 1, fired
        assert [h.retry_rounds for h in handles] == [1, 0], [
            h.retry_rounds for h in handles]
        assert srv.admission.peak_active == 2, srv.admission.peak_active
        assert launches["lftj_fused"] > 0, launches
        words = handles[0].admitted_words
        assert handles[1].admitted_words == words
        # solo_run at this grant is the outofcore phase's store diamond
        assert (words, srv.floor_words) == (
            OOC_QUERY_MEM_WORDS, OOC_QUERY_CACHE_WORDS), words
        solo_reads = ooc["diamond_io"]["block_reads"]
        reg.collect()
        line = serve_line(srv, reg, len(handles), wall, launches,
                          2 * solo_reads, 2 * ooc["diamond_s"], ("count",))
        assert line["block_reads"] \
            <= SERVE_ENVELOPE_FACTOR * line["solo_block_reads"], line
        serve_check_common(srv, handles, line)
        line.update(retry_rounds=[h.retry_rounds for h in handles],
                    injected_box=fired[0], admitted_words=words,
                    cache_words=SERVE_B_CACHE_WORDS,
                    floor_words=srv.floor_words)
        # the box fabric over the server's warm store, from a Session;
        # the server's fabric_run is wrapped to keep the FabricStats that
        # Session.fabric_count drops
        fabric_runs, fabric_run = [], srv.fabric_run
        srv.fabric_run = lambda *a, **kw: fabric_runs.append(
            fabric_run(*a, **kw)) or fabric_runs[-1]
        with Session(srv, n_shards=SERVE_FABRIC_SHARDS,
                     want_words=SERVE_B_WANT_WORDS) as ses:
            count_f, wall_f, launches_f = drive(
                torch, ops, lambda: ses.fabric_count("diamond"))
        runs.append(launches_f)
        assert count_f == want, (count_f, want)
        assert launches_f["lftj_fused"] > 0, launches_f
        assert len(fabric_runs) == 1, len(fabric_runs)
        fstats = fabric_runs[0][1]
        # each shard's ledger against its oracle engine: the same
        # restricted plan over the full store on a fresh device
        fab = Fabric(patterns.diamond(), store=str(path),
                     order=srv._order_for(patterns.diamond()),
                     n_shards=SERVE_FABRIC_SHARDS,
                     mem_words=SERVE_B_WANT_WORDS,
                     cache_words=srv.floor_words,
                     io_block_words=srv.device.B, backend="fused",
                     workers=srv.workers_per_query)
        reset_launches(ops)
        oracle_reads, oracle_count = [], 0
        for s in range(SERVE_FABRIC_SHARDS):
            orc = fab.oracle_engine(s)
            oracle_count += sum(int(r) for r in orc.run_boxes("count")
                                if r is not None)
            oracle_reads.append([orc.stats.block_reads,
                                 orc.stats.word_reads])
        runs.append(read_launches(ops))
        assert oracle_count == want, (oracle_count, want)
        assert [list(x) for x in zip(fstats.shard_block_reads,
                                     fstats.shard_word_reads)] \
            == oracle_reads, (fstats, oracle_reads)
        assert srv.admission.reserved_words == 0
        line["fabric"] = {"shards": fstats.n_shards, "count": count_f,
                          "session_wall_s": wall_f, "launches": launches_f,
                          "shard_boxes": fstats.shard_boxes,
                          "shard_block_reads": fstats.shard_block_reads,
                          "balance": fstats.balance}
    finally:
        srv.close()
    left = live_threads_since(before)
    assert not left, left
    return {"line": line, "runs": runs}


def serve_c(torch, np, ops, shared) -> dict:
    """Server C: the query-listing phase's graph in memory on ``fused``; a
    four-clique count, then a streamed four-clique listing consumed slowly
    enough that its page queue fills (pages equal to that phase's bytes),
    then a streamed listing cancelled after its first page (its consumer
    gets QueryCancelled) and a count after it, still exact."""
    import threading
    from repro_torch import MetricsRegistry
    from repro_torch.serve import QueryCancelled, Server
    qlist = shared["query_listing"]
    words = qlist["mem_words"]
    reg = MetricsRegistry()
    before = {t.ident for t in threading.enumerate()}
    srv = Server.from_graph(qlist["src"], qlist["dst"],
                            mem_words=SERVE_C_MEM_WORDS, backend="fused",
                            page_rows=SERVE_C_PAGE_ROWS,
                            page_queue_depth=SERVE_C_PAGE_DEPTH,
                            metrics=reg)
    handles, runs = [], []
    try:
        reset_launches(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = srv.submit("four_clique", want_words=words)
        handles.append(h)
        count = h.result(SERVE_TIMEOUT_S)
        assert count == qlist["listed"], (count, qlist["listed"])
        # the streamed listing: the consumer waits at each page until the
        # queue is full (the box workers then block on it) or the query
        # has finished
        h = srv.submit("four_clique", "list", stream=True, want_words=words)
        handles.append(h)
        digest, n_rows, n_pages, full_seen = hashlib.sha256(), 0, 0, 0
        for page in h.pages():
            q = h._stream._q
            while not q.full() and not h.done():
                time.sleep(0.001)
            full_seen += q.full()
            digest.update(page.tobytes())
            n_rows += len(page)
            n_pages += 1
        rows = h.result(SERVE_TIMEOUT_S)
        assert digest.hexdigest() == qlist["list_sha256"], n_rows
        assert hashlib.sha256(rows.tobytes()).hexdigest() \
            == qlist["list_sha256"]
        assert n_rows == qlist["listed"] and n_pages == h._stream.n_pages
        assert full_seen > 0, full_seen
        # a streamed listing cancelled after its first page
        h = srv.submit("four_clique", "list", stream=True, want_words=words)
        handles.append(h)
        pages = h.pages()
        first = next(pages)
        h.cancel()
        cancelled = False
        try:
            for _ in pages:
                pass
        except QueryCancelled:
            cancelled = True
        assert cancelled and h.wait(SERVE_TIMEOUT_S), h.status
        assert h.status == "cancelled", h.status
        h = srv.submit("four_clique", want_words=words)
        handles.append(h)
        after = h.result(SERVE_TIMEOUT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(ops)
        runs.append(launches)
        assert after == qlist["listed"], (after, qlist["listed"])
        assert launches["lftj_fused"] > 0, launches
        assert launches["lftj_fused_list"] > 0, launches
        for h in handles:
            assert h.retry_rounds == 0, (h.qid, h.retry_rounds)
        # the counts' solo envelope (the listing's bytes are held to phase
        # 10's run of the same query at the same budget, whose wall stands
        # for its solo wall)
        reset_launches(ops)
        t0 = time.perf_counter()
        solo, solo_st = srv.solo_run("four_clique", words=words)
        torch.cuda.synchronize()
        solo_count_s = time.perf_counter() - t0
        runs.append(read_launches(ops))
        assert solo == qlist["listed"], solo
        counts = [h for h in handles if h.mode == "count"]
        reg.collect()
        line = serve_line(
            srv, reg, len(handles), wall, launches,
            len(counts) * solo_st.block_reads,
            len(counts) * solo_count_s + qlist["list_s"], ("count", "list"),
            reads=sum(h.stats.block_reads for h in counts))
        assert line["block_reads"] \
            <= SERVE_ENVELOPE_FACTOR * line["solo_block_reads"], line
        serve_check_common(srv, handles, line)
        line.update(scale=QUERY_LIST_SCALE, admitted_words=words,
                    listed=n_rows, pages=n_pages, page_rows=SERVE_C_PAGE_ROWS,
                    page_queue_depth=SERVE_C_PAGE_DEPTH,
                    queue_full_at_pages=full_seen,
                    cancelled_after_rows=len(first),
                    list_block_reads=handles[1].stats.block_reads,
                    device_block_reads=srv.device.stats.block_reads,
                    retry_rounds=sum(h.retry_rounds for h in handles))
    finally:
        srv.close()
    left = live_threads_since(before)
    assert not left, left
    return {"line": line, "runs": runs}


def phase_serve(torch, np, ops, shared, recorders) -> dict:
    """The query server on the card: Server A (in memory, ``auto``,
    concurrent clients), Server B (a store, ``fused``, a fault injected
    once, the box fabric from a Session) and Server C (in memory,
    ``fused``, streamed four-clique listings, one cancelled). Calls of
    this phase are not recorded for the timing phase."""
    for rec in recorders:
        rec.paused = True
    out, runs = {"phase": "serve"}, []
    try:
        for name, run in (("server_a", serve_a), ("server_b", serve_b),
                          ("server_c", serve_c)):
            t0 = time.perf_counter()
            res = run(torch, np, ops, shared)
            res["line"]["server_s"] = time.perf_counter() - t0
            out[name] = res["line"]
            runs.extend(res["runs"])
    finally:
        for rec in recorders:
            rec.paused = False
    out["launches"] = {k: sum(r[k] for r in runs) for k in ops}
    for k in ("intersect", "lftj_fused", "lftj_fused_list"):
        assert out["launches"][k] > 0, (k, out["launches"])
    return out


def query_lane_counts(stats) -> dict:
    """Boxes a QueryEngine lane counted: each box join is one of these."""
    return {"fused": stats.n_fused_boxes, "kernel": stats.n_kernel_boxes,
            "host": stats.n_host_boxes}


def bag_inputs(torch, gen, v: int, ll: int):
    """(BAG_B, ll) int64 indices on the card, about BAG_PAD_SHARE of the
    slots PAD (== v) when ll > 1."""
    idx = torch.randint(0, v, (BAG_B, ll), generator=gen, device="cuda")
    if ll > 1:
        pad = torch.rand((BAG_B, ll), generator=gen,
                         device="cuda") < BAG_PAD_SHARE
        idx[pad] = v
    return idx


def time_bag(torch, bag_ops, table, idx, reps: int) -> dict:
    """One mode ("auto"'s) on one input: ``ms``, the public call
    ``embedding_bag(table, idx)`` on the phase's int64 indices between
    CUDA events (its host work before the launch included); ``calls_ms``,
    BAG_GRAPH_LAUNCHES public calls back to back, per call; ``kernel_ms``,
    the launch alone (BAG_GRAPH_LAUNCHES launches in one CUDA graph, per
    launch); the host synchronisations of one public call; the plain version and the library yardstick; the
    bytes bound (each distinct non-PAD row read once, the indices, the
    output written once; the additions, one per non-PAD element at the
    float32 rate, take far less) beside the L2 bytes the row gather reads
    (every live slot's row)."""
    import torch.nn.functional as F
    from repro_torch import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    v, d = table.shape
    elem = table.element_size()
    mode = bag_ops.resolve_mode(table, "auto")
    w = bag_ops.onehot_route(v, d, elem=elem) if mode == "onehot" else 0
    got, syncs = count_syncs(torch, lambda: embedding_bag(table, idx))
    ms = cuda_ms(lambda: embedding_bag(table, idx), reps)
    calls_ms = cuda_ms(lambda: [embedding_bag(table, idx)
                                for _ in range(BAG_GRAPH_LAUNCHES)],
                       reps) / BAG_GRAPH_LAUNCHES
    kernel_ms = graph_ms(torch, lambda: [bag_ops._launch(table, idx, mode)
                                         for _ in range(BAG_GRAPH_LAUNCHES)],
                         reps) / BAG_GRAPH_LAUNCHES
    plain_ms = cuda_ms(lambda: embedding_bag_ref(table, idx), reps)
    live = idx < v
    safe = idx.clamp(max=v - 1)
    weights = live.to(table.dtype)
    lib_ms = cuda_ms(lambda: F.embedding_bag(
        safe, table, mode="sum", per_sample_weights=weights), reps)
    lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=weights)
    lib_err = float((got - lib).abs().max())
    lookups = int(live.sum())
    rows = int(torch.unique(idx[live]).numel())
    n_bytes = elem * rows * d + idx.element_size() * idx.numel() \
        + 4 * got.numel()
    n_ops = float(lookups * d)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return {"mode": mode, "variant": ("slices" if w else "rows"),
            "slice_w": w, "ms": ms, "calls_ms": calls_ms,
            "kernel_ms": kernel_ms,
            "syncs_per_call": syncs, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            "library_dtype": str(lib.dtype),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": {"table": [v, d], "idx": list(idx.shape),
                      "idx_dtype": str(idx.dtype)},
            "bytes": n_bytes, "ops": n_ops, "lookups": lookups,
            "table_dtype": str(table.dtype),
            "row_gather_l2_bytes": elem * lookups * d}


def phase_embedding_bag(torch, np, ops, shared, bag_ops) -> dict:
    """``embedding_bag`` with mode "auto" on the dlrm-mlperf configuration's
    largest field (auto picks "dma"), its seventh (auto picks "onehot",
    which routes to the row gather) and its eighteenth ("onehot" on the
    column-sliced kernel), at B = 65,536 with L = 1 and L = 8 (about 10 %
    PAD), int64 indices, each within BAG_ATOL of the plain version,
    "onehot" equal to "dma" bit for bit; every input is timed, then its
    table freed."""
    from repro_torch import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"phase": "embedding_bag", "B": BAG_B, "D": BAG_D, "runs": {}}
    runs = []
    timing = {}
    for field, v in (("largest", BAG_V_LARGEST), ("seventh", BAG_V_SMALL),
                     ("eighteenth", BAG_V_SLICED)):
        t0 = time.perf_counter()
        table = torch.rand((v, BAG_D), generator=gen, device="cuda")
        torch.cuda.synchronize()
        t_table = time.perf_counter() - t0
        mode = bag_ops.resolve_mode(table, "auto")
        for ll in BAG_LS:
            idx = bag_inputs(torch, gen, v, ll)
            reset_launches(ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = embedding_bag(table, idx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(ops)
            assert launches[f"embedding_bag_{mode}"] == 1, launches
            if mode == "onehot":
                variant = "slices" if bag_ops.onehot_route(v, BAG_D) \
                    else "rows"
                assert variant == ("slices" if v == BAG_V_SLICED
                                   else "rows"), (v, ll, variant)
                assert launches[f"embedding_bag_onehot_{variant}"] == 1, \
                    launches
            want = embedding_bag_ref(table, idx)
            err = float((got - want).abs().max())
            assert err <= BAG_ATOL, (field, ll, err)
            assert bool(torch.isfinite(got).all())
            run = {"V": v, "L": ll, "mode": mode, "table_bytes":
                   v * BAG_D * 4, "pad_share": float((idx >= v).float()
                                                     .mean()),
                   "max_abs_err": err, "call_s": wall, "launches": launches,
                   "table_s": t_table}
            if mode == "onehot":
                run["equals_dma"] = torch.equal(
                    got, bag_ops.embedding_bag(table, idx, mode="dma"))
                assert run["equals_dma"], (field, ll)
            out["runs"][f"{field}/L{ll}"] = run
            runs.append(launches)
            timing.setdefault(field, {})[f"L{ll}"] = dict(
                time_bag(torch, bag_ops, table, idx, TIMING_REPS),
                max_abs_err=err)
        del table, idx, got, want
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(r[k] for r in runs) for k in ops}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    shared["bag_timing"] = timing
    return out


# ---------------------------------------------------------------------------
# the dlrm and dryrun phases
# ---------------------------------------------------------------------------

def dlrm_expected_launches(bag_ops, cfg, n_devices: int) -> dict:
    """The embedding_bag launches one forward makes, by mode and "onehot"
    variant, from the wrapper's rules: per field (per block of a
    row-sharded field) "auto" by bytes, then the "onehot" route."""
    from repro_torch.parallel.sharding import table_row_block
    out = Counter()
    for v in cfg.table_sizes:
        blk = table_row_block(v, n_devices)
        rows, copies = (blk, n_devices) if blk else (v, 1)
        nbytes = rows * cfg.embed_dim * 2
        mode = "onehot" if nbytes <= bag_ops.ONEHOT_MAX_BYTES else "dma"
        out[f"embedding_bag_{mode}"] += copies
        if mode == "onehot":
            w = bag_ops.onehot_route(rows, cfg.embed_dim, elem=2)
            out[f"embedding_bag_onehot_{'slices' if w else 'rows'}"] += \
                copies
    return dict(out)


def lookups_equal(torch, a, b) -> bool:
    return len(a) == len(b) and all(x.dtype == y.dtype == torch.float32
                                    and torch.equal(x, y)
                                    for x, y in zip(a, b))


def host_step_ms(torch, fn, calls: int) -> float:
    """Host milliseconds a call of ``fn`` takes to enqueue its work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def phase_dlrm(torch, np, ops, shared, bag_ops) -> dict:
    """DLRM serving at the full dlrm-mlperf width: ``init_params`` on the
    card (26 bfloat16 tables), ``serve_step`` at serve_p99 and serve_bulk,
    ``retrieval_score`` at retrieval_cand, and ``serve_step`` at serve_p99
    with the tables row-sharded (``dlrm_param_placement``) over the card
    repeated DLRM_SHARD_DEVICES times [embedding_bag "dma" and "onehot",
    26 launches a forward unsharded]. Each run is held against the same
    call with ``use_kernels=False``: the lookups equal bit for bit (at
    hot = 1 a bag is one widened row), scores within DLRM_SCORE_ATOL, the
    top-100 indices equal; the sharded run equals the unsharded one. Then
    timed (median of TIMING_REPS event-timed steps), and the tables
    freed."""
    import gc

    from repro_torch.configs import get_arch, input_specs
    from repro_torch.data.recsys import CriteoLikeGenerator
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import dlrm
    from repro_torch.parallel.sharding import dlrm_param_placement

    bundle = get_arch(DLRM_ARCH)
    cfg = bundle.config
    assert sum(cfg.table_sizes) == DLRM_TABLE_ROWS, sum(cfg.table_sizes)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "dlrm", "arch": DLRM_ARCH, "config": cfg.name,
           "params": cfg.params_count(), "table_rows": DLRM_TABLE_ROWS,
           "embed_dim": cfg.embed_dim, "hot": cfg.hot,
           "allocated_at_start": torch.cuda.memory_allocated(),
           "tf32": torch.backends.cuda.matmul.allow_tf32}
    gen = torch.Generator(device="cuda").manual_seed(DLRM_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = dlrm.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    tables = [params[f"table{t}"] for t in range(cfg.n_sparse)]
    assert all(t.dtype == torch.bfloat16 for t in tables)
    out["table_bytes"] = sum(t.numel() * t.element_size() for t in tables)
    data = CriteoLikeGenerator(cfg.table_sizes, n_dense=cfg.n_dense,
                               hot=cfg.hot, seed=DLRM_SEED)
    want = dlrm_expected_launches(bag_ops, cfg, 1)
    assert want["embedding_bag_dma"] == 11 and \
        want["embedding_bag_onehot"] == 15, want
    out["expected_launches"] = want
    launches = Counter()
    runs = {}

    def batch_of(shape):
        step, specs = input_specs(DLRM_ARCH, shape)
        b = specs["dense"].shape[0]
        host = data.batch(b, with_labels=False)
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
        for k, spec in specs.items():
            if k == "candidates":
                batch[k] = torch.randn(tuple(spec.shape), generator=gen,
                                       device="cuda", dtype=spec.dtype)
            assert batch[k].shape == spec.shape and \
                batch[k].dtype == spec.dtype, (k, batch[k].shape, spec)
        return step, batch

    def check_launches(got, expect):
        seen = {k: n for k, n in got.items() if n}
        assert seen == {k: n for k, n in expect.items() if n}, (got, expect)
        launches.update(got)
        return seen

    # serve_p99 and serve_bulk
    for shape in ("serve_p99", "serve_bulk"):
        step, batch = batch_of(shape)
        assert step == "serve"
        b = batch["dense"].shape[0]
        scores, wall, got = drive(
            torch, ops, lambda: dlrm.serve_step(cfg, params, batch))
        run = {"B": b, "call_s": wall, "launches": check_launches(got, want)}
        plain = dlrm.serve_step(cfg, params, batch, use_kernels=False)
        assert scores.shape == (b,) and scores.dtype == torch.float32
        assert bool(torch.isfinite(scores).all())
        assert bool(((scores >= 0) & (scores <= 1)).all())
        run["max_abs_err"] = float((scores - plain).abs().max())
        assert run["max_abs_err"] <= DLRM_SCORE_ATOL, (shape, run)
        sparse = batch["sparse"]
        run["lookups_equal"] = lookups_equal(
            torch, dlrm.embedding_lookups(cfg, params, sparse),
            dlrm.embedding_lookups(cfg, params, sparse, use_kernels=False))
        assert run["lookups_equal"], shape
        run["ms"] = cuda_ms(lambda: dlrm.serve_step(cfg, params, batch),
                            TIMING_REPS)
        run["plain_ms"] = cuda_ms(lambda: dlrm.serve_step(
            cfg, params, batch, use_kernels=False), TIMING_REPS)
        run["samples_per_s"] = b / (run["ms"] / 1e3)
        run["lookups_ms"] = cuda_ms(
            lambda: dlrm.embedding_lookups(cfg, params, sparse),
            TIMING_REPS)
        run["lookups_share"] = run["lookups_ms"] / run["ms"]
        run["host_ms"] = host_step_ms(
            torch, lambda: dlrm.serve_step(cfg, params, batch), TIMING_REPS)
        run["profile"] = profile_call(
            torch, lambda: dlrm.serve_step(cfg, params, batch), shape,
            DLRM_PROFILE_TOP)
        if shape == "serve_p99":
            run["device_ms"] = graph_ms(
                torch, lambda: dlrm.serve_step(cfg, params, batch),
                TIMING_REPS)
            p99 = (batch, scores)
        runs[shape] = run
        del plain, sparse
        if shape == "serve_bulk":
            del batch, scores

    # retrieval_cand
    step, batch = batch_of("retrieval_cand")
    assert step == "retrieval"
    (top_s, top_i), wall, got = drive(
        torch, ops, lambda: dlrm.retrieval_score(cfg, params, batch))
    run = {"C": batch["candidates"].shape[0], "call_s": wall,
           "launches": check_launches(got, want)}
    plain_s, plain_i = dlrm.retrieval_score(cfg, params, batch,
                                            use_kernels=False)
    assert top_i.shape == (1, 100) and bool(torch.isfinite(top_s).all())
    assert bool((top_s[0, 1:] <= top_s[0, :-1]).all())
    run["indices_equal"] = torch.equal(top_i, plain_i)
    run["max_abs_err"] = float((top_s - plain_s).abs().max())
    assert run["indices_equal"] and run["max_abs_err"] <= DLRM_SCORE_ATOL, \
        run
    run["lookups_equal"] = lookups_equal(
        torch, dlrm.embedding_lookups(cfg, params, batch["sparse"]),
        dlrm.embedding_lookups(cfg, params, batch["sparse"],
                               use_kernels=False))
    assert run["lookups_equal"]
    run["ms"] = cuda_ms(lambda: dlrm.retrieval_score(cfg, params, batch),
                        TIMING_REPS)
    run["plain_ms"] = cuda_ms(lambda: dlrm.retrieval_score(
        cfg, params, batch, use_kernels=False), TIMING_REPS)
    runs["retrieval_cand"] = run
    del batch

    # serve_p99 with the tables row-sharded over the card repeated
    devices = ["cuda:0"] * DLRM_SHARD_DEVICES
    sharded = dlrm_param_placement(params, devices)
    for t in range(cfg.n_sparse):
        base = params[f"table{t}"].untyped_storage().data_ptr()
        assert all(s.untyped_storage().data_ptr() == base
                   for s in sharded[f"table{t}"]), t     # views, no copies
    want_sh = dlrm_expected_launches(bag_ops, cfg, DLRM_SHARD_DEVICES)
    batch, scores = p99
    got_s, wall, got = drive(
        torch, ops, lambda: dlrm.serve_step(cfg, sharded, batch,
                                            devices=devices))
    run = {"devices": devices, "B": batch["dense"].shape[0], "call_s": wall,
           "launches": check_launches(got, want_sh),
           "row_sharded_tables": sum(
               len(sharded[f"table{t}"]) > 1
               and sharded[f"table{t}"][0].shape[0] < cfg.table_sizes[t]
               for t in range(cfg.n_sparse))}
    run["max_abs_err"] = float((got_s - scores).abs().max())
    assert run["max_abs_err"] <= DLRM_SCORE_ATOL, run
    run["lookups_equal"] = lookups_equal(
        torch, dlrm.embedding_lookups(cfg, sharded, batch["sparse"],
                                      devices=devices),
        dlrm.embedding_lookups(cfg, params, batch["sparse"]))
    assert run["lookups_equal"]
    run["ms"] = cuda_ms(lambda: dlrm.serve_step(cfg, sharded, batch,
                                                devices=devices),
                        TIMING_REPS)
    runs["serve_p99_sharded"] = run
    del sharded, batch, scores, p99, got_s

    # the kernels line's bfloat16 rows: the lookup alone at L = 1 on the
    # dlrm tables, as the embedding_bag phase times its float32 fields
    timing = {}
    for field, t in DLRM_BF16_FIELDS:
        table = params[f"table{t}"]
        idx = bag_inputs(torch, gen, table.shape[0], 1)
        got_b = bag_ops.embedding_bag(table, idx)
        err = float((got_b - embedding_bag_ref(table, idx)).abs().max())
        assert err <= BAG_ATOL, (field, err)
        timing[field] = {"L1": dict(time_bag(torch, bag_ops, table, idx,
                                             TIMING_REPS),
                                    max_abs_err=err, table=t)}
        del idx, got_b
    shared["bag_timing_bf16"] = timing
    out["runs"] = runs
    out["launches"] = {k: launches.get(k, 0) for k in ops}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    assert out["max_memory_allocated"] < DLRM_PEAK_LIMIT, out
    del params, tables
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    return out


def capped_config(cfg, cap: int):
    """``cfg`` with each table's rows capped at ``cap``."""
    import dataclasses
    return dataclasses.replace(
        cfg, table_sizes=tuple(min(v, cap) for v in cfg.table_sizes))


def train_batches(torch, cfg, n: int, b: int, seed: int) -> list:
    from repro_torch.data.recsys import CriteoLikeGenerator
    data = CriteoLikeGenerator(cfg.table_sizes, n_dense=cfg.n_dense,
                               hot=cfg.hot, seed=seed)
    return [{k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch(b).items()} for _ in range(n)]


def sm_clocks_mhz() -> dict:
    """The card's SM clock now and its maximum, MHz, by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return {"sm": float(now), "max_sm": float(top)}


def time_bag_backward(torch, grad_ops, sparse, t: int) -> dict:
    """The backward kernel at the sparse step's shape for field ``t`` of a
    train batch: the gathered-row table of its unique rows (bfloat16) and
    the batch's inverse indices (int32, L = hot), as the step makes them
    (``dlrm.unique_with_order``, whose sort the step hands on as
    ``order``), a float32 grad_out.
    ``ms``: the wrapper call with its own stable sort (one memset and two
    kernels after it) between CUDA events; ``ms_with_order``: the wrapper
    given the step's sort; ``kernel_ms``: the C entry alone on that sort
    (BAG_GRAPH_LAUNCHES calls in one CUDA graph, per call); the plain
    version (``index_add_`` into float32 zeros, then the cast) and one
    ``index_add_`` call on the same inputs (the library yardstick:
    ``library_ms`` eager, between events, to set beside ``ms`` and
    ``ms_with_order``; ``library_graph_ms`` in a CUDA graph as
    ``kernel_ms`` is); the host synchronisations of one call; the bytes
    bound (each slot's index and gradient row read once, the V x D
    output written once) and, beside it, the floor that exactness sets:
    the longest run's chain of float32 adds, 4 cycles each at the card's
    maximum SM clock."""
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    from repro_torch.models.dlrm import unique_with_order
    b, hot = sparse.shape[0], sparse.shape[2]
    uniq, inv, order = unique_with_order(sparse[:, t, :].reshape(-1))
    idx = inv.to(torch.int32).view(b, hot)
    v, d = uniq.numel(), 128
    gen = torch.Generator(device="cuda").manual_seed(t)
    g = torch.randn((b, d), generator=gen, device="cuda")
    dtype = torch.bfloat16
    got, syncs = count_syncs(
        torch, lambda: grad_ops.embedding_bag_backward(g, idx, v, dtype))
    want = embedding_bag_backward_ref(g.cpu(), idx.cpu(), v, dtype)
    exact = torch.equal(got.cpu(), want)
    with_order, syncs_order = count_syncs(
        torch, lambda: grad_ops.embedding_bag_backward(g, idx, v, dtype,
                                                       order=order))
    exact = exact and torch.equal(with_order.cpu(), want)
    err = float((got.float().cpu() - want.float()).abs().max())
    on_card = embedding_bag_backward_ref(g, idx, v, dtype)
    err_card = float((got.float() - on_card.float()).abs().max())
    ms = cuda_ms(lambda: grad_ops.embedding_bag_backward(g, idx, v, dtype),
                 TIMING_REPS)
    ms_with_order = cuda_ms(lambda: grad_ops.embedding_bag_backward(
        g, idx, v, dtype, order=order), TIMING_REPS)
    out = torch.empty((v, d), dtype=dtype, device="cuda")
    work = torch.empty(grad_ops._workspace_bytes(idx.numel(), v, d),
                       dtype=torch.uint8, device="cuda")
    kernel_ms = graph_ms(torch, lambda: [
        grad_ops._launch_sorted(g, *order, hot, v, dtype, out=out, work=work)
        for _ in range(BAG_GRAPH_LAUNCHES)], TIMING_REPS) / BAG_GRAPH_LAUNCHES
    exact = exact and torch.equal(out.cpu(), want)
    plain_ms = cuda_ms(lambda: embedding_bag_backward_ref(g, idx, v, dtype),
                       TIMING_REPS)
    acc = torch.zeros((v, d), dtype=torch.float32, device="cuda")
    flat, rows = idx.reshape(-1), g.repeat_interleave(hot, dim=0)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, rows), TIMING_REPS)
    lib_graph_ms = graph_ms(torch, lambda: [
        acc.index_add_(0, flat, rows) for _ in range(BAG_GRAPH_LAUNCHES)],
        TIMING_REPS) / BAG_GRAPH_LAUNCHES
    n_bytes = idx.numel() * (idx.element_size() + 4 * d) \
        + v * d * got.element_size()
    longest = int(torch.bincount(flat.long(), minlength=v).max())
    clocks = sm_clocks_mhz()
    return {"field": t, "ms": ms, "ms_with_order": ms_with_order,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": n_bytes, "longest_run": longest,
            "longest_run_floor_ms": longest * 4 / (clocks["max_sm"] * 1e3),
            "sm_clock_mhz": clocks, "syncs_per_call": syncs,
            "syncs_per_call_with_order": syncs_order,
            "exact_vs_plain_on_cpu": exact, "max_abs_err": err,
            "max_abs_err_vs_plain_on_card": err_card,
            "device_ops_per_call": "memset + bag_backward_plan + "
                                   "bag_backward_runs (+ the sort "
                                   "without order)",
            "shape": {"rows": v, "idx": list(idx.shape), "d": d,
                      "out_dtype": "bfloat16"}}


def clone_state(torch, params, opt_state):
    from repro_torch.optim.adamw import OptState
    return ({k: v.clone() for k, v in params.items()},
            OptState(opt_state.step.clone(),
                     {k: v.clone() for k, v in opt_state.m.items()},
                     {k: v.clone() for k, v in opt_state.v.items()}))


@contextlib.contextmanager
def plain_backward_on_cpu(grad_ops):
    """Within it, the plain version of the lookup's backward (the one a
    ``use_kernels=False`` step calls) runs on the CPU copy of its inputs,
    where ``index_add_`` adds in index order, and returns to their device:
    on the card it adds with atomics, in no fixed order."""
    ref = grad_ops.embedding_bag_backward_ref

    def on_cpu(grad_out, idx, v, dtype):
        return ref(grad_out.cpu(), idx.cpu(), v, dtype).to(grad_out.device)

    grad_ops.embedding_bag_backward_ref = on_cpu
    try:
        yield
    finally:
        grad_ops.embedding_bag_backward_ref = ref


def start_train_cli(tmp, name: str, *extra) -> tuple:
    """``python -m repro_torch.launch.train`` on the smoke config, on the
    card, in a child process writing its checkpoints under tmp/name."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           DLRM_ARCH, "--smoke", "--batch", str(TRAIN_CLI_BATCH),
           "--ckpt-dir", str(Path(tmp) / name), *extra]
    return cmd, subprocess.Popen(cmd, env=env, cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def finish_train_cli(run) -> dict:
    cmd, proc = run
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=TRAIN_CLI_TIMEOUT_S)
    assert proc.returncode == 0, (cmd, err[-2000:])
    final = [line for line in out.splitlines() if line.startswith("final")]
    first = float(final[-1].split("(first ")[1].rstrip(")"))
    last = float(final[-1].split()[2])
    return {"argv": cmd[3:], "wait_s": time.perf_counter() - t0,
            "first_loss": first, "final_loss": last,
            "final_below_first": last < first, "stdout": out[-600:]}


def held_out_losses(torch, tmp, name: str, step: int) -> dict:
    """The smoke config's loss on a held-out batch (TRAIN_HELD_OUT_BATCH
    rows, seed TRAIN_HELD_OUT_SEED) under the CLI's initial params (its
    generator: the card's, seeded 0, float32 params as ``--smoke`` sets)
    and under its checkpoint at ``step``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm, layers
    from repro_torch.optim import adamw
    cfg = get_arch(DLRM_ARCH).smoke_config
    saved = layers.PDTYPE, layers.ADTYPE
    layers.set_dtypes(torch.float32, torch.float32)
    try:
        init = dlrm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    finally:
        layers.set_dtypes(*saved)
    mgr = CheckpointManager(Path(tmp) / name)
    (trained, _), at = mgr.restore((init, adamw.init(init)), step)
    held = train_batches(torch, cfg, 1, TRAIN_HELD_OUT_BATCH,
                         TRAIN_HELD_OUT_SEED)[0]
    with torch.no_grad():
        before = float(dlrm.loss_fn(cfg, init, held)[0])
        after = float(dlrm.loss_fn(cfg, trained, held)[0])
    assert after < before, (name, before, after)
    return {"checkpoint_step": at, "held_out_before": before,
            "held_out_after": after}


def phase_train(torch, np, ops, shared, grad_ops) -> dict:
    """DLRM training on the card. (a) ``make_sparse_train_step`` at the
    full dlrm-mlperf width with each table capped at TRAIN_CAP_ROWS rows
    (init on the card, B = 65,536, OPT_CFG): TRAIN_STEPS steps [per step
    embedding_bag 26 (forward, on each field's gathered rows) and
    embedding_bag_backward 26], each timed with the card synchronised on
    both sides (the first is a warm-up), losses finite, host
    synchronisations of a step, one more step under the profiler, the
    peak below 80 GB; the backward kernel timed at two fields' shapes.
    (b) At TRAIN_CHECK_CAP rows and TRAIN_CHECK_OPT (an update far above
    a bfloat16 step of the tables), one step from copies of one state with
    the kernels, with ``use_kernels=False`` and row-sharded over the card
    twice. The plain step's backward runs its plain version on the CPU
    copy of its inputs (``plain_backward_on_cpu``: ordered float32 sums,
    which the kernel equals bit for bit), so the kernel step equals the
    plain step bit for bit in the loss and every param and moment; the
    step moved most of the touched table elements (``moved_fraction``).
    Sharded equals unsharded in every param and moment. (c) The train
    CLI in child processes on the card: 30 steps with checkpoints,
    ``--resume`` to 40, and ``--compress int8``; the plain and int8 runs'
    final loss below their first (the reference's
    ``test_dlrm_loss_decreases``), and each run's held-out loss below its
    initial params'. Everything allocated is freed."""
    import gc
    import tempfile

    from repro_torch.configs import get_arch, input_specs
    from repro_torch.models import dlrm
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (dlrm_opt_state_placement,
                                               dlrm_param_placement)
    t_phase = time.perf_counter()
    full = get_arch(DLRM_ARCH).config
    cfg = capped_config(full, TRAIN_CAP_ROWS)
    assert sum(cfg.table_sizes) == TRAIN_ROWS, sum(cfg.table_sizes)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_kind, specs = input_specs(DLRM_ARCH, "train_batch")
    assert step_kind == "train"
    b = specs["dense"].shape[0]
    out = {"phase": "train", "arch": DLRM_ARCH, "B": b,
           "embed_dim": cfg.embed_dim, "bot_mlp": list(cfg.bot_mlp),
           "top_mlp": list(cfg.top_mlp), "hot": cfg.hot,
           "reduced": {"table_cap_rows": TRAIN_CAP_ROWS,
                       "fields_cut": [t for t, v in
                                      enumerate(full.table_sizes)
                                      if v > TRAIN_CAP_ROWS],
                       "rows": TRAIN_ROWS,
                       "full_rows": sum(full.table_sizes)},
           "allocated_at_start": torch.cuda.memory_allocated(),
           "tf32": torch.backends.cuda.matmul.allow_tf32}
    opt_cfg = adamw.AdamWConfig()
    gen = torch.Generator(device="cuda").manual_seed(DLRM_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = dlrm.init_params(cfg, gen, device="cuda")
    opt_state = adamw.init(params)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    tables = [params[f"table{t}"] for t in range(cfg.n_sparse)]
    assert all(t.dtype == torch.bfloat16 for t in tables)
    out["table_bytes"] = sum(t.numel() * t.element_size() for t in tables)
    out["moment_bytes"] = sum(m.numel() * 4 for k, m in opt_state.m.items()
                              if k.startswith("table")) * 2
    batches = train_batches(torch, cfg, TRAIN_STEPS + 1, b, DLRM_SEED)
    step = dlrm.make_sparse_train_step(cfg, opt_cfg)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = batches[i]
        if i == 0:
            (res, syncs), wall, got = drive(torch, ops, lambda: count_syncs(
                torch, lambda: step(params, opt_state, batch)))
            out["host_syncs_per_step"] = syncs
        else:
            res, wall, got = drive(torch, ops,
                                   lambda: step(params, opt_state, batch))
        fwd = got["embedding_bag_dma"] + got["embedding_bag_onehot"]
        assert fwd == cfg.n_sparse and \
            got["embedding_bag_backward"] == cfg.n_sparse, got
        loss = float(res[2]["loss"])
        assert np.isfinite(loss), (i, loss)
        steps.append({"s": wall, "loss": loss,
                      "grad_norm": float(res[2]["grad_norm"]),
                      "launches": {k: n for k, n in got.items() if n}})
    assert int(opt_state.step) == TRAIN_STEPS
    out["steps"] = steps
    out["losses"] = [x["loss"] for x in steps]
    out["ms_per_step"] = statistics.median(x["s"] for x in steps[1:]) * 1e3
    out["samples_per_s"] = b / (out["ms_per_step"] / 1e3)
    out["profile"] = profile_call(
        torch, lambda: step(params, opt_state, batches[-1]), "train_step",
        DLRM_PROFILE_TOP, sums={"embedding_bag_backward": "bag_backward_",
                                "radix_sort": "RadixSort"})
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    assert out["max_memory_allocated"] < DLRM_PEAK_LIMIT, out
    shared["bag_backward_timing"] = {
        name: time_bag_backward(torch, grad_ops, batches[-1]["sparse"], t)
        for name, t in TRAIN_FIELDS}
    del params, opt_state, tables, batches, step, res
    gc.collect()
    torch.cuda.empty_cache()
    out["full_width_s"] = time.perf_counter() - t_phase

    # (c) started now, beside (b): the CLI's plain run and its int8 run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    plain = start_train_cli(tmp, "plain", "--steps", str(TRAIN_CLI_STEPS))
    int8 = start_train_cli(tmp, "int8", "--steps", str(TRAIN_CLI_STEPS),
                           "--compress", "int8")
    try:
        # (b) kernels against plain, sharded against unsharded
        t0 = time.perf_counter()
        cfg_b = capped_config(full, TRAIN_CHECK_CAP)
        check_cfg = adamw.AdamWConfig(**TRAIN_CHECK_OPT)
        gen = torch.Generator(device="cuda").manual_seed(DLRM_SEED + 1)
        params = dlrm.init_params(cfg_b, gen, device="cuda")
        opt_state = adamw.init(params)
        bb = train_batches(torch, cfg_b, 2, b, DLRM_SEED + 1)
        dlrm.make_sparse_train_step(cfg_b, check_cfg)(params, opt_state,
                                                      bb[0])
        plain_state = clone_state(torch, params, opt_state)
        sh_params, sh_opt = clone_state(torch, params, opt_state)
        before = {k: t.clone() for k, t in params.items()
                  if k.startswith("table")}
        devices = ["cuda:0"] * TRAIN_SHARD_DEVICES
        sharded = (dlrm_param_placement(sh_params, devices),
                   dlrm_opt_state_placement(sh_opt, devices))
        _, _, mk = dlrm.make_sparse_train_step(cfg_b, check_cfg)(
            params, opt_state, bb[1])
        with plain_backward_on_cpu(grad_ops):
            _, _, mp = dlrm.make_sparse_train_step(
                cfg_b, check_cfg, use_kernels=False)(*plain_state, bb[1])
        reset_launches(ops)
        _, _, ms = dlrm.make_sparse_train_step(
            cfg_b, check_cfg, devices=devices)(*sharded, bb[1])
        torch.cuda.synchronize()
        sh_launches = read_launches(ops)
        check = {"rows": sum(cfg_b.table_sizes), "opt": TRAIN_CHECK_OPT,
                 "lr": float(mk["lr"]),
                 "sharded_launches": {k: n for k, n in sh_launches.items()
                                      if n}}
        assert torch.equal(mk["loss"], mp["loss"]), (mk, mp)
        for k, p in params.items():
            for got_t, want_t in ((p, plain_state[0][k]),
                                  (opt_state.m[k], plain_state[1].m[k]),
                                  (opt_state.v[k], plain_state[1].v[k])):
                assert torch.equal(got_t, want_t), k
        touched, moved, steps_abs = 0, 0, []
        for t in range(cfg_b.n_sparse):
            k, v = f"table{t}", cfg_b.table_sizes[t]
            uniq = torch.unique(bb[1]["sparse"][:, t, :])
            touched += int((uniq < v).sum()) * cfg_b.embed_dim
            diff = (params[k].float() - before[k].float()).abs()
            moved += int((diff > 0).sum())
            steps_abs.append(diff[diff > 0])
        steps_abs = torch.cat(steps_abs)
        check["kernels_vs_plain"] = {
            "equal": True, "touched_elements": touched,
            "moved_elements": moved, "moved_fraction": moved / touched,
            "update_abs_median": float(steps_abs.median()),
            "update_abs_min": float(steps_abs.min())}
        assert moved / touched >= TRAIN_CHECK_MOVED, check
        del before, steps_abs
        for k in params:
            for got_t, want_t in ((sh_params[k], params[k]),
                                  (sh_opt.m[k], opt_state.m[k]),
                                  (sh_opt.v[k], opt_state.v[k])):
                assert torch.equal(got_t, want_t), k
        assert torch.equal(sh_opt.step, opt_state.step)
        assert torch.equal(ms["loss"], mk["loss"])
        check["sharded_equals_unsharded"] = True
        check["row_sharded_tables"] = sum(
            len(sharded[0][f"table{t}"]) == TRAIN_SHARD_DEVICES and
            sharded[0][f"table{t}"][0].shape[0] < cfg_b.table_sizes[t]
            for t in range(cfg_b.n_sparse))
        check["s"] = time.perf_counter() - t0
        out["check"] = check
        del params, opt_state, plain_state, sh_params, sh_opt, sharded, bb
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the CLI: the plain run, then --resume from its checkpoint,
        # then the int8 run
        t0 = time.perf_counter()
        cli = {"plain": finish_train_cli(plain)}
        assert cli["plain"]["final_below_first"], cli["plain"]
        cli["plain"].update(held_out_losses(torch, tmp, "plain",
                                            TRAIN_CLI_STEPS))
        resume = start_train_cli(tmp, "plain", "--steps",
                                 str(TRAIN_CLI_RESUME_STEPS), "--resume")
        cli["resume"] = finish_train_cli(resume)
        assert f"resumed from step {TRAIN_CLI_STEPS}" in \
            cli["resume"]["stdout"], cli["resume"]
        cli["resume"].update(held_out_losses(torch, tmp, "plain",
                                             TRAIN_CLI_RESUME_STEPS))
        cli["int8"] = finish_train_cli(int8)
        assert cli["int8"]["final_below_first"], cli["int8"]
        cli["int8"].update(held_out_losses(torch, tmp, "int8",
                                           TRAIN_CLI_STEPS))
        cli["s"] = time.perf_counter() - t0
        out["cli"] = cli
    finally:
        for _, proc in (plain, int8):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = {k: sum(x["launches"].get(k, 0) for x in steps)
                       for k in ops}
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    return out


def bag_backward_kernel_row(timing, gnn_timing, lm_timing,
                            by_phase: dict, grid_lm_timing=None) -> dict:
    """The backward kernel's line: its launches by phase (train, gnn,
    lm_train, grid, grid_train), its times at the largest train field's
    shape (both fields under ``by_field``) or, where the train phase did
    not run, at the gnn phase's largest segment sum, else the lm_train
    phase's token embedding, else one grid_train place's vocabulary
    block; ``by_gnn_shape``, ``by_lm_shape`` and ``by_grid_lm_shape``
    hold those three."""
    shapes = dict(timing or {})
    if gnn_timing:
        shapes["gnn"] = gnn_timing
    if lm_timing:
        shapes["lm"] = lm_timing
    if grid_lm_timing:
        shapes["grid_lm"] = grid_lm_timing
    top = timing["largest"] if timing else \
        gnn_timing or lm_timing or grid_lm_timing
    launches = by_phase["embedding_bag_backward"]
    row = {"name": "embedding_bag_backward", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag_backward.cu",
           "replaces": "none: the XLA scatter-add of jnp.take's gradient "
                       "(src/repro/models/dlrm.py:211, "
                       "src/repro/models/transformer.py:194) and "
                       "jax.ops.segment_sum (src/repro/models/gnn.py:135)",
           "launches": sum(launches.values()),
           "launches_by_phase": launches,
           "max_abs_err": max(t["max_abs_err"] for t in shapes.values()),
           "ms": top["ms"], "ms_with_order": top["ms_with_order"],
           "kernel_ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
           "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
           "longest_run_floor_ms": top["longest_run_floor_ms"],
           "library_ms": top["library_ms"],
           "library_graph_ms": top["library_graph_ms"],
           "host_syncs_per_call": max(
               max(t["syncs_per_call"], t["syncs_per_call_with_order"])
               for t in shapes.values()),
           "exact": all(t["exact_vs_plain_on_cpu"] for t in shapes.values()),
           "shape": top["shape"]}
    if timing:
        row["by_field"] = timing
    if gnn_timing:
        row["by_gnn_shape"] = {"mesh_r6_d512": gnn_timing}
    if lm_timing:
        row["by_lm_shape"] = {"qwen2_7b_embed_4096": lm_timing}
    if grid_lm_timing:
        row["by_grid_lm_shape"] = {
            "qwen2_7b_embed_block_4096": grid_lm_timing}
    return row


def time_segment_sum(torch, grad_ops, x, seg, n: int, order=None,
                     dtype=None) -> dict:
    """The backward kernel as an L = 1 sum calls it: (E, D) float32 values
    summed by (E,) ids into n rows of ``dtype`` (default float32): the gnn
    phase's largest segment sum, the lm_train phase's token embedding.
    ``ms``: the wrapper with its own stable sort, ``ms_with_order``: given
    the caller's sort (``order``: the batch's ``edge_orders``; None where
    the caller has none), between CUDA events; ``kernel_ms``: the C entry
    alone on that sort (BAG_GRAPH_LAUNCHES calls in one CUDA graph, per
    call); the plain version on the card and one ``index_add_`` into a
    float32 (n, D) table (eager: ``library_ms``; in a graph:
    ``library_graph_ms``); the host synchronisations of one call; equality
    with the plain version on the CPU copy; the bytes bound (each id and
    each value row it keeps read once, the n x D output written once:
    every row, the untouched ones zero) and the longest run's add chain,
    4 cycles a slot at the card's maximum SM clock. Ids >= n (a
    grid_train place's tokens outside its vocabulary block) add nothing:
    ``index_add_``, which has no such skip, is given the kept slots
    alone."""
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    dtype = torch.float32 if dtype is None else dtype
    idx = seg.view(-1, 1)
    e, d = x.shape
    want = embedding_bag_backward_ref(x.cpu(), idx.cpu(), n, dtype)
    got, syncs = count_syncs(
        torch, lambda: grad_ops.embedding_bag_backward(x, idx, n, dtype))
    exact = torch.equal(got.cpu(), want)
    err = float((got.cpu().float() - want.float()).abs().max())
    del got
    ms = cuda_ms(lambda: grad_ops.embedding_bag_backward(x, idx, n, dtype),
                 TIMING_REPS)
    ms_with_order, syncs_order = None, 0
    if order is not None:
        with_order, syncs_order = count_syncs(
            torch, lambda: grad_ops.embedding_bag_backward(
                x, idx, n, dtype, order=order))
        exact = exact and torch.equal(with_order.cpu(), want)
        del with_order
        ms_with_order = cuda_ms(lambda: grad_ops.embedding_bag_backward(
            x, idx, n, dtype, order=order), TIMING_REPS)
    keys, perm = order if order is not None else \
        torch.sort(seg, stable=True)
    out = torch.empty((n, d), dtype=dtype, device="cuda")
    work = torch.empty(grad_ops._workspace_bytes(e, n, d),
                       dtype=torch.uint8, device="cuda")
    kernel_ms = graph_ms(torch, lambda: [
        grad_ops._launch_sorted(x, keys, perm, 1, n, dtype, out=out,
                                work=work)
        for _ in range(BAG_GRAPH_LAUNCHES)], TIMING_REPS) / BAG_GRAPH_LAUNCHES
    exact = exact and torch.equal(out.cpu(), want)
    del out, work, want
    plain_ms = cuda_ms(lambda: embedding_bag_backward_ref(x, idx, n, dtype),
                       TIMING_REPS)
    keep = seg < n
    seg_in, x_in = seg[keep], x[keep]
    acc = torch.zeros((n, d), dtype=torch.float32, device="cuda")
    lib_ms = cuda_ms(lambda: acc.index_add_(0, seg_in, x_in), TIMING_REPS)
    lib_graph_ms = graph_ms(torch, lambda: [
        acc.index_add_(0, seg_in, x_in) for _ in range(BAG_GRAPH_LAUNCHES)],
        TIMING_REPS) / BAG_GRAPH_LAUNCHES
    del acc
    item = torch.empty((), dtype=dtype).element_size()
    e_in = seg_in.shape[0]
    n_bytes = e * seg.element_size() + e_in * 4 * d + n * d * item
    counts = torch.bincount(seg_in.long(), minlength=n)
    del seg_in, x_in
    longest = int(counts.max())
    clocks = sm_clocks_mhz()
    return {"ms": ms, "ms_with_order": ms_with_order,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": n_bytes, "longest_run": longest,
            "median_run": float(counts.float().median()),
            "distinct_ids": int((counts > 0).sum()),
            "longest_run_floor_ms": longest * 4 / (clocks["max_sm"] * 1e3),
            "sm_clock_mhz": clocks, "syncs_per_call": syncs,
            "syncs_per_call_with_order": syncs_order,
            "exact_vs_plain_on_cpu": exact, "max_abs_err": err,
            "device_ops_per_call": "memset + bag_backward_plan + "
                                   "bag_backward_runs (+ the sort "
                                   "without order)",
            "skipped_slots": e - e_in,
            "shape": {"rows": n, "idx": [e, 1], "d": d,
                      "out_dtype": str(dtype).replace("torch.", "")}}


def weather_batch(torch, np, verts, src, dst, n_vars: int) -> dict:
    """examples/weather_sim.py's inputs on the multimesh, as CUDA tensors:
    a smooth synthetic state of ``n_vars`` variables (numpy seed 0), its
    target (one diffusion step along the mesh edges: 0.7 state + 0.3 the
    mean of the neighbours' states; the neighbour sums by a scipy sparse
    product), the edge features (the vertex difference and its norm) and
    unit masks."""
    import scipy.sparse as sp
    n = len(verts)
    rng = np.random.default_rng(0)
    state = np.tanh(verts @ rng.standard_normal((3, n_vars))).astype(
        np.float32)
    adj = sp.csr_matrix((np.ones(len(src), np.float32), (dst, src)),
                        shape=(n, n))
    agg = adj @ state + adj.T @ state
    deg = np.bincount(np.concatenate([src, dst]), minlength=n)[:, None]
    target = 0.7 * state + 0.3 * agg / np.maximum(deg, 1)
    diff = verts[src] - verts[dst]
    edge_feat = np.concatenate(
        [diff, np.linalg.norm(diff, axis=1, keepdims=True)], axis=1)
    batch = {"node_feat": state, "edge_src": src.astype(np.int32),
             "edge_dst": dst.astype(np.int32),
             "edge_feat": edge_feat.astype(np.float32),
             "edge_mask": np.ones(len(src), np.float32),
             "node_mask": np.ones(n, np.float32),
             "targets": target.astype(np.float32)}
    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


def assert_spec_shapes(torch, arrays: dict, specs: dict) -> None:
    """``arrays`` hold exactly the keys of the cell's ``input_specs``, each
    at the spec's shape and dtype (``make_gnn_batch(pad_to=512)`` and
    ``NeighborSampler.padded_batch`` give them; ``molecule_batch`` pads
    its edges on to them)."""
    assert set(arrays) == set(specs), (sorted(arrays), sorted(specs))
    for k, spec in specs.items():
        a = torch.from_numpy(arrays[k][:0])
        assert arrays[k].shape == tuple(spec.shape) and \
            a.dtype == spec.dtype, (k, arrays[k].shape, a.dtype, spec)


def molecule_batch(np, dims: dict) -> dict:
    """The molecule cell's batch: ``dims["batch"]`` graphs of
    RAND(n_nodes, n_edges, seed=i) with node ids offset by i * n_nodes and
    ``graph_id`` i, through ``make_gnn_batch`` (seeded features, positions
    and per-node targets; padded to 512). The spec counts the edges before
    simplification (128 x 64), so the edge arrays are padded on to its
    8,192 with more of ``make_gnn_batch``'s padding edges (node 0 to node
    0, mask 0)."""
    from repro_torch.data.graphs import make_gnn_batch, random_graph
    nn_, n_graphs = dims["n_nodes"], dims["batch"]
    parts = [random_graph(nn_, dims["n_edges"], seed=i)
             for i in range(n_graphs)]
    src = np.concatenate([s + i * nn_ for i, (s, _) in enumerate(parts)])
    dst = np.concatenate([d + i * nn_ for i, (_, d) in enumerate(parts)])
    n = nn_ * n_graphs
    batch = make_gnn_batch(src, dst, n, dims["d_feat"],
                           d_target=dims["d_target"], pad_to=512, seed=0)
    batch["graph_id"][:n] = np.repeat(np.arange(n_graphs), nn_)
    e_pad = -(-dims["n_edges"] * n_graphs // 512) * 512
    for k in ("edge_src", "edge_dst", "edge_mask"):
        a = batch[k]
        batch[k] = np.concatenate([a, np.zeros(e_pad - len(a), a.dtype)])
    return batch


def minibatch_batch(np, dims: dict) -> tuple:
    """The minibatch_lg cell's batch: ``NeighborSampler`` (fanout (15, 10),
    seed 2) over RAND(232,965, 2^22, seed=2) made symmetric, GNN_MB_SEEDS
    seeds, padded to the spec's block; and the sampler's host ms. The
    symmetric CSR is one sort of the (row, column) keys: the pairs are
    distinct, so the rows come out as ``csr_from_edges`` sorts them. The
    features follow ``synthetic_features``' law (uniform labels over 41
    classes, class centres of scale 2, unit noise; 602 wide), drawn for the
    block's rows only: the graph's 232,965 x 602 would take seconds of
    host time for the ~94 k rows a block reads."""
    from repro_torch.data.graphs import random_graph
    from repro_torch.data.sampler import NeighborSampler
    n, d_feat = GNN_MB_NODES, dims["d_feat"]
    src, dst = random_graph(n, GNN_MB_EDGES, seed=2)
    key = np.sort(np.concatenate([src * n + dst, dst * n + src]))
    rows = key // n
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    indices = (key - rows * n).astype(np.int32)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, dims["n_classes"], n).astype(np.int32)
    centers = (rng.standard_normal((dims["n_classes"], d_feat)) * 2.0
               ).astype(np.float32)
    sampler = NeighborSampler(indptr, indices, fanout=dims["fanout"], seed=2)
    seeds = np.random.default_rng(2).choice(n, GNN_MB_SEEDS, replace=False)
    t0 = time.perf_counter()
    batch = sampler.padded_batch(seeds, np.empty((n, 0), np.float32), labels,
                                 dims["blk_nodes"], dims["blk_edges"])
    sampler_ms = (time.perf_counter() - t0) * 1e3
    live = int(batch["node_mask"].sum())
    feat = np.zeros((dims["blk_nodes"], d_feat), np.float32)
    feat[:live] = centers[batch["labels"][:live]] + rng.standard_normal(
        (live, d_feat), dtype=np.float32)
    batch["node_feat"] = feat
    return batch, sampler_ms


def gnn_check_steps(torch, gnn, adamw, grad_ops, cfg, batch, seed) -> dict:
    """From one state (params from a seeded generator on the card and one
    step taken, so the moments are not zero): a step with the kernels, the
    same step once more from a copy of that state, and one with
    ``use_kernels=False`` whose plain sums run on the CPU copy
    (``plain_backward_on_cpu``: ordered float32 sums, which the kernel
    equals bit for bit). All three must be equal bit for bit in the loss
    and in every param and moment. Returns the launches of the kernel step
    and the loss."""
    from repro_torch.pytree import leaves, tree_map
    opt_cfg = adamw.AdamWConfig(**GNN_OPT)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = gnn.init_params(cfg, gen, device="cuda")
    opt_state = adamw.init(params)
    gnn.train_step(cfg, opt_cfg, params, opt_state, batch)
    again = tree_map(torch.clone, (params, opt_state))
    plain = tree_map(torch.clone, (params, opt_state))
    before = grad_ops.BACKWARD_LAUNCHES.n
    _, _, mk = gnn.train_step(cfg, opt_cfg, params, opt_state, batch)
    torch.cuda.synchronize()
    launches = grad_ops.BACKWARD_LAUNCHES.n - before
    _, _, ma = gnn.train_step(cfg, opt_cfg, *again, batch)
    with plain_backward_on_cpu(grad_ops):
        _, _, mp = gnn.train_step(cfg, opt_cfg, *plain, batch,
                                  use_kernels=False)
    assert grad_ops.BACKWARD_LAUNCHES.n == before + 2 * launches
    assert torch.equal(mk["loss"], mp["loss"]), (mk, mp)
    assert torch.equal(mk["loss"], ma["loss"]), (mk, ma)
    state = leaves((params, opt_state))
    for name, other in (("plain", plain), ("again", again)):
        for a, b in zip(state, leaves(other)):
            assert torch.equal(a, b), (cfg.name, name)
    return {"equal_to_plain": True, "equal_when_repeated": True,
            "leaves": len(state), "loss": float(mk["loss"]),
            "embedding_bag_backward_launches": launches}


def phase_gnn(torch, np, ops, shared, grad_ops) -> dict:
    """GNN training on the card. (a) graphcast's full CONFIG (16 layers,
    512 wide, 227 variables) on the refinement-6 multimesh with
    examples/weather_sim.py's state, diffusion target and edge features,
    params from a seeded generator on the card, AdamW (lr 3e-3, 3 warmup
    steps of 10): GNN_STEPS ``gnn.train_step`` calls, each on its two edge
    sorts [embedding_bag_backward 48 a step: each layer's aggregation and
    the backwards of its two gathers], each with its host syncs (sync
    debug mode; 0), finite losses, the last below the first, the peak below
    80 GB, one step profiled by kernel. (d) that step's largest segment
    sum alone (``time_segment_sum``). (b) the same mesh and widths at
    GNN_CHECK_LAYERS layers: kernel step = plain step = repeated kernel
    step, bit for bit (``gnn_check_steps``). (c) the other three archs at
    their full CONFIG, each the same check: gcn-cora on full_graph_sm and
    on minibatch_lg (a sampled block, the sampler's host ms), gin-tu and
    schnet on molecule; each batch at its cell's ``input_specs`` shapes."""
    import dataclasses
    import gc
    from repro_torch.configs import config_for_shape, get_arch, input_specs
    from repro_torch.data.graphs import (icosahedral_mesh, make_gnn_batch,
                                         random_graph)
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(GNN_ARCH).config
    t0 = time.perf_counter()
    verts, src, dst = icosahedral_mesh(GNN_REFINEMENT)
    mesh_s = time.perf_counter() - t0
    batch = weather_batch(torch, np, verts, src, dst, cfg.d_in)
    # the grid phase trains on the same inputs
    shared["weather_batch"] = {k: v.cpu() for k, v in batch.items()}
    n, e = len(verts), len(src)
    out = {"phase": "gnn", "arch": GNN_ARCH, "n_layers": cfg.n_layers,
           "d_hidden": cfg.d_hidden, "d_in": cfg.d_in, "d_out": cfg.d_out,
           "d_edge": cfg.d_edge, "nodes": n, "edges": e,
           "mesh_s": mesh_s, "data_s": time.perf_counter() - t0,
           "opt": GNN_OPT, "tf32": torch.backends.cuda.matmul.allow_tf32,
           "allocated_at_start": torch.cuda.memory_allocated()}
    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    params = gnn.init_params(cfg, gen, device="cuda")
    opt_state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(**GNN_OPT)

    def step():
        return gnn.train_step(cfg, opt_cfg, params, opt_state, batch)

    steps = []
    per_step = 3 * cfg.n_layers
    for i in range(GNN_STEPS):
        (res, syncs), wall, got = drive(torch, ops,
                                        lambda: count_syncs(torch, step))
        assert got["embedding_bag_backward"] == per_step and \
            sum(got.values()) == per_step, got
        assert syncs == 0, (i, syncs, dict(SYNC_SITES))
        loss = float(res[2]["loss"])
        assert np.isfinite(loss), (i, loss)
        steps.append({"s": wall, "loss": loss,
                      "grad_norm": float(res[2]["grad_norm"]),
                      "syncs": syncs,
                      "launches": {k: c for k, c in got.items() if c}})
    out["steps"] = steps
    out["losses"] = [x["loss"] for x in steps]
    assert out["losses"][-1] < out["losses"][0], out["losses"]
    out["host_syncs_per_step"] = max(x["syncs"] for x in steps)
    out["embedding_bag_backward_per_step"] = per_step
    out["ms_per_step"] = statistics.median(x["s"] for x in steps[1:]) * 1e3
    out["nodes_per_s"] = n / (out["ms_per_step"] / 1e3)
    out["edges_per_s"] = e / (out["ms_per_step"] / 1e3)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    assert out["max_memory_allocated"] < GNN_PEAK_LIMIT, out
    out["profile"] = profile_call(
        torch, step, "gnn_train_step", DLRM_PROFILE_TOP,
        sums={"embedding_bag_backward": "bag_backward_", "gemm": "gemm",
              "gather": "gather_kernel"})
    out["launches"] = {k: sum(x["launches"].get(k, 0) for x in steps)
                       for k in ops}
    # (d) the largest segment sum alone: a layer's aggregation
    x = torch.randn((e, cfg.d_hidden), generator=gen, device="cuda")
    shared["gnn_segment_timing"] = time_segment_sum(
        torch, grad_ops, x, batch["edge_dst"], n,
        gnn.edge_orders(batch)["dst"])
    del params, opt_state, res, x
    gc.collect()
    torch.cuda.empty_cache()
    out["full_width_s"] = time.perf_counter() - t0

    # (b) the same mesh and widths at GNN_CHECK_LAYERS layers
    t1 = time.perf_counter()
    cfg_b = dataclasses.replace(cfg, n_layers=GNN_CHECK_LAYERS)
    out["check"] = dict(gnn_check_steps(torch, gnn, adamw, grad_ops, cfg_b,
                                        batch, GNN_SEED + 1),
                        n_layers=GNN_CHECK_LAYERS,
                        s=time.perf_counter() - t1)
    assert out["check"]["embedding_bag_backward_launches"] == \
        3 * GNN_CHECK_LAYERS, out["check"]
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the other three archs at their full CONFIG
    t1 = time.perf_counter()
    g_src, g_dst = random_graph(2708, 10556, seed=0)
    cells = [("gcn-cora", "full_graph_sm",
              make_gnn_batch(g_src, g_dst, 2708, 1433, n_classes=7,
                             pad_to=512))]
    mol = molecule_batch(np, get_arch("gin-tu").shapes["molecule"].dims)
    cells += [("gin-tu", "molecule", mol), ("schnet", "molecule", mol)]
    mb_dims = get_arch("gcn-cora").shapes["minibatch_lg"].dims
    mb, sampler_ms = minibatch_batch(np, mb_dims)
    cells.append(("gcn-cora", "minibatch_lg", mb))
    others = {"data_s": time.perf_counter() - t1,
              "minibatch_sampler_ms": sampler_ms}
    for i, (arch, shape, arrays) in enumerate(cells):
        c = config_for_shape(arch, shape)
        assert_spec_shapes(torch, arrays, input_specs(arch, shape)[1])
        cell_batch = {k: torch.from_numpy(v).to("cuda")
                      for k, v in arrays.items()}
        t2 = time.perf_counter()
        res = gnn_check_steps(torch, gnn, adamw, grad_ops, c, cell_batch,
                              GNN_SEED + 2 + i)
        live = arrays["edge_mask"] > 0
        others[f"{arch}/{shape}"] = dict(
            res, nodes=int(arrays["node_mask"].sum()),
            edges=int(live.sum()), padded=list(arrays["node_feat"].shape)
            + [len(arrays["edge_src"])],
            longest_dst_run=int(np.bincount(arrays["edge_dst"]).max()),
            longest_src_run=int(np.bincount(arrays["edge_src"]).max()),
            s=time.perf_counter() - t2)
    out["other_archs"] = others
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    return out


def logits_err(torch, got, want) -> float:
    """max over rows of max |got - want| / the row's largest |want|."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(dim=-1, keepdim=True)
    return float(((got - want).abs() / scale).amax())


def lm_serve(torch, M, cfg, params, tok, n_gen: int) -> dict:
    """The steps ``generate`` takes, each step's logits kept: a warm-up
    prefill, a timed one, then n_gen timed greedy decode steps."""
    max_len = tok.shape[1] + n_gen
    M.prefill(cfg, params, tok, max_len=max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, last = M.prefill(cfg, params, tok, max_len=max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cur = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    toks, steps = [], []
    t0 = time.perf_counter()
    for i in range(n_gen):
        toks.append(cur[:, 0])
        lg, cache = M.decode_step(cfg, params, cache, cur, tok.shape[1] + i)
        steps.append(lg)
        cur = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"cache": cache, "last": last, "steps": torch.stack(steps, 1),
            "tokens": torch.stack(toks, 1), "next": cur,
            "prefill_ms": prefill_ms, "decode_ms_per_token":
            decode_s * 1e3 / n_gen,
            "tokens_per_s": tok.shape[0] * n_gen / decode_s}


def lm_generate_check(torch, np, generate, cfg, params, prompts, run) -> dict:
    """``launch.serve.generate`` (the entry point) timed, and equal token
    for token to the steps ``lm_serve`` took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = generate(cfg, params, prompts, run["tokens"].shape[1])
    wall = time.perf_counter() - t0
    assert np.array_equal(got, run["tokens"].cpu().numpy()), "generate"
    return {"generate_s": wall, "sample_row": got[0][:16].tolist()}


def lm_qwen(torch, np, M, generate, TokenStream) -> dict:
    """(a) qwen2-7b's full CONFIG on the card (phase_lm)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.pytree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(LM_ARCH).config
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(LM_SEED), "cuda")
    torch.cuda.synchronize()
    out = {"arch": LM_ARCH, "params": cfg.params_count(),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(params)),
           "init_s": time.perf_counter() - t0, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "gen": LM_GEN}
    prompts = TokenStream(cfg.vocab, seed=0).batch(LM_BATCH,
                                                   LM_PROMPT)["tokens"]
    tok = torch.from_numpy(prompts).cuda()
    run = lm_serve(torch, M, cfg, params, tok, LM_GEN)
    out.update({k: run[k] for k in ("prefill_ms", "decode_ms_per_token",
                                    "tokens_per_s")})
    out.update(lm_generate_check(torch, np, generate, cfg, params, prompts,
                                 run))
    # prefill's last logits against forward(prompt)[:, -1]
    fwd, _ = M.forward(cfg, params, tok)
    out["prefill_vs_forward_err"] = logits_err(torch, run["last"],
                                               fwd[:, -1])
    out["prefill_equals_forward_bits"] = bool(torch.equal(run["last"],
                                                          fwd[:, -1]))
    assert out["prefill_vs_forward_err"] <= LM_LOGIT_REL, out
    del fwd
    # each decode step against the teacher-forced forward at its position
    seq = torch.cat([tok, run["tokens"].to(tok.dtype)], dim=1)
    full, _ = M.forward(cfg, params, seq)
    teacher = full[:, LM_PROMPT:]                      # (B, gen, V)
    steps = run["steps"]
    assert bool(torch.isfinite(steps).all()), "decode logits"
    out["decode_vs_forward_err"] = logits_err(torch, steps, teacher)
    assert out["decode_vs_forward_err"] <= LM_LOGIT_REL, out
    # the greedy tokens against the forward's argmax where its margin is
    # above the bound: token i+1 from step i, token 0 from position S-1
    rows = full[:, LM_PROMPT - 1:-1]                   # predicts tokens
    top2 = torch.topk(rows, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / rows.abs().amax(dim=-1)
    sure = margin > LM_LOGIT_REL
    agree = torch.argmax(rows, dim=-1) == run["tokens"]
    out["greedy_checked"] = int(sure.sum())
    out["greedy_agree_all"] = int(agree.sum())
    assert bool(agree[sure].all()), (out, agree, sure)
    del full, teacher, rows, seq
    out["profile_decode"] = profile_call(
        torch, lambda: M.decode_step(cfg, params, run["cache"], run["next"],
                                     LM_PROMPT + LM_GEN - 1),
        "lm_decode_step", DLRM_PROFILE_TOP, sums=LM_PROFILE_SUMS)
    out["profile_prefill"] = profile_call(
        torch, lambda: M.prefill(cfg, params, tok, max_len=LM_PROMPT
                                 + LM_GEN), "lm_prefill", DLRM_PROFILE_TOP,
        sums=LM_PROFILE_SUMS)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    # one long prefill, unchunked and on query chunks
    long_tok = torch.from_numpy(TokenStream(cfg.vocab, seed=1).batch(
        1, LM_LONG)["tokens"]).cuda()
    longs = {}
    for name, c in (("unchunked", cfg),
                    ("chunked", dataclasses.replace(
                        cfg, attn_q_chunk=LM_Q_CHUNK))):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, last = M.prefill(c, params, long_tok)
        torch.cuda.synchronize()
        longs[name] = (last, {"ms": (time.perf_counter() - t0) * 1e3,
                              "max_memory_allocated":
                              torch.cuda.max_memory_allocated()})
    out["long_prefill"] = dict({k: v[1] for k, v in longs.items()},
                               tokens=LM_LONG, q_chunk=LM_Q_CHUNK)
    out["long_prefill"]["chunked_vs_unchunked_err"] = logits_err(
        torch, longs["chunked"][0], longs["unchunked"][0])
    assert out["long_prefill"]["chunked_vs_unchunked_err"] <= LM_LOGIT_REL
    out["max_memory_allocated"] = max(
        torch.cuda.max_memory_allocated(),
        *(v[1]["max_memory_allocated"] for v in longs.values()))
    assert out["max_memory_allocated"] < LM_PEAK_LIMIT, out
    del params, longs, long_tok
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_deepseek(torch, np, M, generate, TokenStream) -> dict:
    """(b) deepseek-v2-236b at full width, LM_DS_LAYERS layers (phase_lm)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.pytree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(LM_DS_ARCH).config,
                              n_layers=LM_DS_LAYERS)
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(LM_SEED), "cuda")
    torch.cuda.synchronize()
    out = {"arch": LM_DS_ARCH, "n_layers": LM_DS_LAYERS,
           "moe_impl": cfg.moe_impl, "params": cfg.params_count(),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(params)),
           "init_s": time.perf_counter() - t0, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "gen": LM_DS_GEN}
    prompts = TokenStream(cfg.vocab, seed=0).batch(LM_BATCH,
                                                   LM_PROMPT)["tokens"]
    tok = torch.from_numpy(prompts).cuda()
    run = lm_serve(torch, M, cfg, params, tok, LM_DS_GEN)
    out.update({k: run[k] for k in ("prefill_ms", "decode_ms_per_token",
                                    "tokens_per_s")})
    assert bool(torch.isfinite(run["steps"]).all()), "decode logits"
    out.update(lm_generate_check(torch, np, generate, cfg, params, prompts,
                                 run))
    # the prefill again: the same bits, cache and logits
    cache2, last2 = M.prefill(cfg, params, tok,
                              max_len=LM_PROMPT + LM_DS_GEN)
    _, last1 = M.prefill(cfg, params, tok, max_len=LM_PROMPT + LM_DS_GEN)
    out["prefill_repeat_equal_bits"] = bool(torch.equal(last1, last2))
    assert out["prefill_repeat_equal_bits"], out
    fwd, _ = M.forward(cfg, params, tok)
    out["prefill_vs_forward_err"] = logits_err(torch, last1, fwd[:, -1])
    out["prefill_equals_forward_bits"] = bool(torch.equal(last1,
                                                          fwd[:, -1]))
    assert out["prefill_vs_forward_err"] <= LM_LOGIT_REL, out
    fwd2, _ = M.forward(cfg, params, tok)
    out["forward_repeat_equal_bits"] = bool(torch.equal(fwd, fwd2))
    assert out["forward_repeat_equal_bits"], out
    out["profile_decode"] = profile_call(
        torch, lambda: M.decode_step(cfg, params, run["cache"], run["next"],
                                     LM_PROMPT + LM_DS_GEN - 1),
        "lm_deepseek_decode_step", DLRM_PROFILE_TOP, sums=LM_PROFILE_SUMS)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    assert out["max_memory_allocated"] < LM_PEAK_LIMIT, out
    del params, run, cache2, fwd, fwd2
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recording_routes(moe, log: list):
    """Records the top-k expert ids of every MoE routing (``moe.route``)."""
    route = moe.route

    def recorded(p, x, k):
        res = route(p, x, k)
        log.append(res[2].cpu())
        return res
    moe.route = recorded
    try:
        yield
    finally:
        moe.route = route


def lm_smoke_run(torch, M, moe, cfg, params, tokens, targets) -> tuple:
    """forward, loss_fn, prefill and LM_SMOKE_DECODES decode steps of one
    smoke config on the params' device: ({name: tensor}, the routes)."""
    from repro_torch.pytree import flatten_with_path
    routes, res = [], {}
    s = tokens.shape[1]
    with recording_routes(moe, routes):
        res["logits"], res["aux"] = M.forward(cfg, params, tokens)
        loss, m = M.loss_fn(cfg, params, {"tokens": tokens,
                                          "targets": targets})
        res.update(loss=loss, nll=m["nll"])
        cache, res["last"] = M.prefill(cfg, params, tokens[:, :s // 2],
                                       max_len=s // 2 + LM_SMOKE_DECODES)
        for i in range(LM_SMOKE_DECODES):
            pos = s // 2 + i
            res[f"decode{i}"], cache = M.decode_step(
                cfg, params, cache, tokens[:, pos:pos + 1], pos)
        res.update({f"cache/{'/'.join(path)}": t
                    for path, t in flatten_with_path(cache)})
    return res, routes


def lm_smoke_configs(torch, np, M, TokenStream) -> dict:
    """(c) each LM SMOKE_CONFIG at float32 (TF32 off) on the card and on
    the CPU from the same params (phase_lm)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.pytree import tree_map
    out = {}
    for i, arch in enumerate(LM_SMOKE_ARCHS):
        cfg = get_arch(arch).smoke_config
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator().manual_seed(i), "cpu")
        batch = TokenStream(cfg.vocab, seed=i).batch(2, 16)
        runs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            tok = torch.from_numpy(batch["tokens"]).to(dev)
            tgt = torch.from_numpy(batch["targets"]).to(dev)
            runs[dev] = lm_smoke_run(torch, M, moe, cfg, p, tok, tgt)
        (want, want_routes), (got, got_routes) = runs["cpu"], runs["cuda"]
        assert len(got_routes) == len(want_routes), arch
        for j, (g, w) in enumerate(zip(got_routes, want_routes)):
            flips = (g != w).nonzero().tolist()
            assert not flips, (arch, f"routing call {j}: the token at "
                               f"(index..., rank) {flips[0]} routes to "
                               f"{g[tuple(flips[0])]} on the card, "
                               f"{w[tuple(flips[0])]} on the CPU")
        errs = {}
        for k, w in want.items():
            g = got[k].cpu()
            scale = max(float(w.abs().max()), 1e-30)
            errs[k] = float((g - w).abs().max()) / scale
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LM_SMOKE_REL, (arch, worst, errs[worst])
        out[arch] = {"max_rel_err": errs[worst], "worst": worst,
                     "routings": len(got_routes),
                     "s": time.perf_counter() - t0}
    return out


def lm_cli(torch) -> dict:
    """(d) the serve CLI on the card in a child process (phase_lm)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
         "--smoke"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=LM_CLI_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "generated (4, 32)" in res.stdout, res.stdout[-500:]
    return {"s": time.perf_counter() - t0,
            "stdout": res.stdout.strip()[-200:]}


def phase_lm(torch, np, ops, shared) -> dict:
    """LM serving on the card: (a) qwen2-7b's full CONFIG, (b)
    deepseek-v2-236b at full width and LM_DS_LAYERS layers, (c) the five
    smoke configs card against CPU, (d) the serve CLI (the module
    docstring's phase 2e). cuBLAS keeps float32 accumulation: bfloat16
    reduced-precision reductions and TF32 off for the phase
    (``layers.float32_accumulation``)."""
    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M
    mm = torch.backends.cuda.matmul
    saved = (L.PDTYPE, L.ADTYPE)
    out = {"phase": "lm", "allocated_at_start": torch.cuda.memory_allocated()}
    reset_launches(ops)
    with L.float32_accumulation():
        out["allow_bf16_reduced_precision_reduction"] = \
            mm.allow_bf16_reduced_precision_reduction
        out["allow_tf32"] = mm.allow_tf32
        try:
            L.set_dtypes(torch.bfloat16, torch.bfloat16)
            t0 = time.perf_counter()
            out["qwen"] = dict(lm_qwen(torch, np, M, generate, TokenStream),
                               s=time.perf_counter() - t0)
            t0 = time.perf_counter()
            out["deepseek"] = dict(lm_deepseek(torch, np, M, generate,
                                               TokenStream),
                                   s=time.perf_counter() - t0)
            L.set_dtypes(torch.float32, torch.float32)
            t0 = time.perf_counter()
            out["smoke_configs"] = dict(lm_smoke_configs(torch, np, M,
                                                         TokenStream),
                                        s=time.perf_counter() - t0)
            out["cli"] = lm_cli(torch)
        finally:
            L.set_dtypes(*saved)
    out["launches"] = read_launches(ops)
    assert not any(out["launches"].values()), out["launches"]
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    return out


def leaf_checksums(torch, adamw, tree) -> list:
    """Each leaf's float64 sum, taken over ``adamw.pieces`` slices (no
    whole-leaf temporary): a leaf whose sum changed moved."""
    from repro_torch.pytree import leaves
    return [float(sum(torch.sum(t[at].double()) for at in
                      adamw.pieces(t.shape))) for t in leaves(tree)]


@contextlib.contextmanager
def recording_bag_backward(grad_ops, log: list):
    """Records the inputs of every ``embedding_bag_backward`` call (the
    token embedding's gradient: grad_out, idx, rows, dtype)."""
    backward = grad_ops.embedding_bag_backward

    def recorded(grad_out, idx, v, dtype, order=None):
        log.append((grad_out, idx, v, dtype))
        return backward(grad_out, idx, v, dtype, order=order)
    grad_ops.embedding_bag_backward = recorded
    try:
        yield
    finally:
        grad_ops.embedding_bag_backward = backward


def lm_batches(torch, vocab: int, n: int, b: int, s: int) -> list:
    from repro_torch.data import TokenStream
    stream = TokenStream(vocab, seed=1)
    return [{k: torch.from_numpy(v).cuda() for k, v in
             stream.batch(b, s).items()} for _ in range(n)]


def lm_train_full(torch, np, ops, grad_ops) -> tuple:
    """(a) of phase_lm_train: qwen2-7b's full width at LM_TRAIN_LAYERS
    layers. Returns (its line, the step's embedding-gradient inputs)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as M
    from repro_torch.optim import adamw
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(LM_ARCH).config
    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS, remat="layer")
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(LM_SEED), "cuda")
    opt_state = adamw.init(params)
    torch.cuda.synchronize()
    n_params, tokens = cfg.params_count(), LM_TRAIN_BATCH * LM_TRAIN_SEQ
    out = {"arch": LM_ARCH, "n_layers": cfg.n_layers, "remat": cfg.remat,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
           "state_bytes": torch.cuda.memory_allocated(),
           "init_s": time.perf_counter() - t0, "batch": LM_TRAIN_BATCH,
           "seq": LM_TRAIN_SEQ, "opt": LM_TRAIN_OPT,
           "reduced": {"n_layers": [full.n_layers, cfg.n_layers],
                       "batch": [256, LM_TRAIN_BATCH]}}
    opt_cfg = adamw.AdamWConfig(**LM_TRAIN_OPT)
    batches = lm_batches(torch, cfg.vocab, LM_TRAIN_STEPS + 1,
                         LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    before = leaf_checksums(torch, adamw, params)
    steps, seen = [], []
    for i, batch in enumerate(batches[:LM_TRAIN_STEPS]):
        log = seen if i == LM_TRAIN_STEPS - 1 else []
        with recording_bag_backward(grad_ops, log):
            (res, syncs), wall, got = drive(torch, ops, lambda: count_syncs(
                torch, lambda: M.train_step(cfg, opt_cfg, params, opt_state,
                                            batch)))
        assert got["embedding_bag_backward"] == 1 and \
            sum(got.values()) == 1, got
        m = res[2]
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        assert np.isfinite(loss) and np.isfinite(gnorm), (i, loss, gnorm)
        steps.append({"s": wall, "loss": loss, "grad_norm": gnorm,
                      "syncs": syncs,
                      "launches": {k: c for k, c in got.items() if c}})
    out["steps"] = steps
    out["losses"] = [x["loss"] for x in steps]
    out["host_syncs_per_step"] = [x["syncs"] for x in steps]
    assert all(x["syncs"] == 0 for x in steps[1:]), \
        (out["host_syncs_per_step"], dict(SYNC_SITES))
    out["embedding_bag_backward_per_step"] = 1
    step_s = statistics.median(x["s"] for x in steps[1:])
    out["ms_per_step"] = step_s * 1e3
    out["tokens_per_s"] = tokens / step_s
    out["model_flops_per_step"] = 6 * n_params * tokens
    out["model_flops_share"] = out["model_flops_per_step"] / step_s \
        / H100_BF16_FLOPS
    out["peak_flops"] = {"bfloat16_dense": H100_BF16_FLOPS,
                         "source": "NVIDIA H100 SXM data sheet, 700 W"}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    assert out["max_memory_allocated"] < LM_TRAIN_PEAK_LIMIT, out
    after = leaf_checksums(torch, adamw, params)
    out["leaves"] = len(before)
    out["leaves_moved"] = sum(a != b for a, b in zip(before, after))
    assert out["leaves_moved"] == len(before), out
    out["profile"] = profile_call(
        torch, lambda: M.train_step(cfg, opt_cfg, params, opt_state,
                                    batches[-1]), "lm_train_step",
        DLRM_PROFILE_TOP,
        sums=dict(LM_PROFILE_SUMS, embedding_bag_backward="bag_backward_"))
    # the profiled step's one call: its plan and runs kernels
    out["embedding_bag_backward_in_step_ms"] = \
        out["profile"]["sums"]["embedding_bag_backward"]["ms"]
    (grad_out, idx, v, dtype), = seen
    embed = (grad_out.detach().clone(), idx.clone(), v, dtype)
    del params, opt_state, res, batches, seen, grad_out, idx
    gc.collect()
    torch.cuda.empty_cache()
    return out, embed


def grads_of(torch, L, M, cfg, params, batch) -> tuple:
    loss, _, grads = L.value_and_grad(lambda p: M.loss_fn(cfg, p, batch),
                                      params)
    return loss, grads


def lm_train_checks(torch, np, grad_ops) -> dict:
    """(b) of phase_lm_train, at LM_TRAIN_CHECK_LAYERS layers of the full
    width: the step repeated bit for bit, the embedding's gradient against
    its plain version on the CPU copy, the three remat settings' bits and
    peaks, the bfloat16 gradient against a float32 one."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M
    from repro_torch.optim import adamw
    from repro_torch.pytree import flatten_with_path, leaves, tree_map
    cfg = dataclasses.replace(get_arch(LM_ARCH).config,
                              n_layers=LM_TRAIN_CHECK_LAYERS, remat="layer")
    out = {"n_layers": cfg.n_layers}
    opt_cfg = adamw.AdamWConfig(**LM_TRAIN_OPT)
    first, batch = lm_batches(torch, cfg.vocab, 2, LM_TRAIN_BATCH,
                              LM_TRAIN_SEQ)
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(LM_SEED + 1), "cuda")
    opt_state = adamw.init(params)
    M.train_step(cfg, opt_cfg, params, opt_state, first)
    # the step and the same step again from a copy of its state
    again = tree_map(torch.clone, (params, opt_state))
    _, _, mk = M.train_step(cfg, opt_cfg, params, opt_state, batch)
    _, _, ma = M.train_step(cfg, opt_cfg, *again, batch)
    assert torch.equal(mk["loss"], ma["loss"]), (mk, ma)
    state = leaves((params, opt_state))
    for a, b in zip(state, leaves(again)):
        assert torch.equal(a, b)
    out["equal_when_repeated"] = True
    out["leaves_compared"] = len(state)
    del again, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    # the embedding's gradient against its plain version on the CPU copy;
    # the remat settings' bits and peaks
    runs, peaks = {}, {}
    for remat in ("layer", "none", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        log = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with recording_bag_backward(grad_ops, log):
            runs[remat] = grads_of(torch, L, M, c, params, batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        if remat == "layer":
            (grad_out, idx, v, dtype), = log
            want = embedding_bag_backward_ref(grad_out.cpu(), idx.cpu(), v,
                                              dtype)
            out["embed_grad_equals_plain_on_cpu"] = bool(torch.equal(
                runs[remat][1]["embed"].cpu(), want))
            assert out["embed_grad_equals_plain_on_cpu"]
            del grad_out, idx, want
        del log
    ref = [runs["layer"][0]] + leaves(runs["layer"][1])
    for remat in ("none", "dots"):
        got = [runs[remat][0]] + leaves(runs[remat][1])
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), remat
    out["remat_equal_bits"] = True
    out["remat_peak_bytes_over_state"] = peaks
    loss_bf16, g_bf16 = runs["layer"]
    del runs, ref, got
    gc.collect()
    torch.cuda.empty_cache()
    # the bfloat16 gradient against a float32 gradient of the same params
    saved = L.PDTYPE, L.ADTYPE
    L.set_dtypes(torch.float32, torch.float32)
    try:
        p32 = tree_map(lambda t: t.float(), params)
        del params
        loss_f32, g_f32 = grads_of(torch, L, M, cfg, p32, batch)
    finally:
        L.set_dtypes(*saved)
    errs = {}
    for (path, a), b in zip(flatten_with_path(g_bf16), leaves(g_f32)):
        errs["/".join(path)] = float(torch.linalg.vector_norm(
            a.float() - b) / torch.linalg.vector_norm(b))
    worst = max(errs, key=errs.get)
    out["bf16_vs_f32"] = {"bound": LM_GRAD_REL, "worst_leaf": worst,
                          "worst_rel_l2": errs[worst], "rel_l2": errs,
                          "loss_bf16": float(loss_bf16),
                          "loss_f32": float(loss_f32)}
    assert errs[worst] <= LM_GRAD_REL, out["bf16_vs_f32"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del p32, g_f32, g_bf16
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_smoke_configs(torch, np) -> dict:
    """(c) of phase_lm_train: each LM SMOKE_CONFIG at float32 (TF32 off),
    and the two MoE ones on the capacity forms (routes dropped at the
    default capacity factor): the loss and every gradient on the card
    against the CPU from the same params, within LM_SMOKE_REL of each
    leaf's largest |value|, every routing equal."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer as M
    from repro_torch.pytree import flatten_with_path, tree_map
    cases = [(arch, None) for arch in LM_SMOKE_ARCHS]
    cases += [(arch, impl) for arch in LM_SMOKE_ARCHS
              if get_arch(arch).smoke_config.n_experts
              for impl in LM_TRAIN_MOE_IMPLS]
    out = {}
    for i, (arch, impl) in enumerate(cases):
        cfg = get_arch(arch).smoke_config
        if impl:
            cfg = dataclasses.replace(cfg, moe_impl=impl)
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator().manual_seed(i), "cpu")
        batch = TokenStream(cfg.vocab, seed=i).batch(2, 16)
        runs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            bt = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            routes = []
            with recording_routes(moe, routes):
                loss, grads = grads_of(torch, L, M, cfg, p, bt)
            runs[dev] = ({"loss": loss, **{"/".join(k): g for k, g in
                                           flatten_with_path(grads)}},
                         routes)
        (want, want_routes), (got, got_routes) = runs["cpu"], runs["cuda"]
        assert len(got_routes) == len(want_routes), arch
        for j, (g, w) in enumerate(zip(got_routes, want_routes)):
            assert torch.equal(g, w), (arch, impl, f"routing call {j}")
        errs = {k: float((got[k].cpu() - w).abs().max())
                / max(float(w.abs().max()), 1e-30) for k, w in want.items()}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= LM_SMOKE_REL, (arch, impl, worst, errs[worst])
        name = arch if impl is None else f"{arch}/{impl}"
        out[name] = {"max_rel_err": errs[worst], "worst": worst,
                     "routings": len(got_routes),
                     "s": time.perf_counter() - t0}
        if impl:
            b, s = batch["tokens"].shape
            cap = moe._capacity(s, cfg.top_k, cfg.n_experts, 1.25)
            dropped = sum(int((moe._ranks_cumsum(
                r.reshape(b, s * cfg.top_k), cfg.n_experts) >= cap).sum())
                for r in want_routes)
            out[name]["dropped_routes"] = dropped
            assert dropped > 0, (name, "no route dropped")
    return out


def start_lm_train_cli(tmp, *extra) -> tuple:
    """``python -m repro_torch.launch.train`` with LM_TRAIN_CLI's flags on
    the card, in a child process."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *LM_TRAIN_CLI,
           *extra]
    return cmd, subprocess.Popen(cmd, env=env, cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def phase_lm_train(torch, np, ops, shared, grad_ops) -> dict:
    """LM training on the card (the module docstring's phase 2f): (a)
    qwen2-7b's full width at LM_TRAIN_LAYERS layers, one 4,096-token
    sequence a step, remat "layer": LM_TRAIN_STEPS ``transformer.train_step``
    calls [embedding_bag_backward 1 a step: the token embedding's
    gradient], timed, host syncs a step, finite losses and gradient norms,
    every leaf moved, the peak below LM_TRAIN_PEAK_LIMIT, one more step
    profiled; the step's embedding gradient alone (``time_segment_sum``).
    (b) ``lm_train_checks`` at LM_TRAIN_CHECK_LAYERS layers. (c)
    ``lm_train_smoke_configs``. (d) the train CLI in child processes
    (LM_TRAIN_CLI; ``--compress int8``; ``--ckpt-dir`` then ``--resume``
    to LM_TRAIN_CLI_RESUME_STEPS): the final loss below the first. GEMMs
    accumulate in float32 (``layers.float32_accumulation``)."""
    import gc
    import tempfile
    from repro_torch.models import layers as L
    out = {"phase": "lm_train",
           "allocated_at_start": torch.cuda.memory_allocated()}
    saved = L.PDTYPE, L.ADTYPE
    tmp = tempfile.mkdtemp(prefix="lm_train_cli_")
    children = []
    with L.float32_accumulation():
        try:
            L.set_dtypes(torch.bfloat16, torch.bfloat16)
            t0 = time.perf_counter()
            full, embed = lm_train_full(torch, np, ops, grad_ops)
            out["full_width"] = dict(full, s=time.perf_counter() - t0)
            # the CLI's processes run beside the rest of the phase (not
            # beside (a), whose peak leaves the card little room)
            t_cli = time.perf_counter()
            plain = start_lm_train_cli(tmp, "--ckpt-dir", f"{tmp}/plain")
            int8 = start_lm_train_cli(tmp, "--compress", "int8")
            children += [plain, int8]
            reset_launches(ops)
            t0 = time.perf_counter()
            grad_out, idx, v, dtype = embed
            shared["lm_embed_timing"] = time_segment_sum(
                torch, grad_ops, grad_out, idx.view(-1), v, dtype=dtype)
            del grad_out, idx
            del embed
            gc.collect()
            torch.cuda.empty_cache()
            out["embed_backward_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["check"] = dict(lm_train_checks(torch, np, grad_ops),
                                s=time.perf_counter() - t0)
            L.set_dtypes(torch.float32, torch.float32)
            t0 = time.perf_counter()
            out["smoke_configs"] = dict(lm_train_smoke_configs(torch, np),
                                        s=time.perf_counter() - t0)
            t0 = time.perf_counter()
            cli = {"plain": finish_train_cli(plain)}
            resume = start_lm_train_cli(
                tmp, "--ckpt-dir", f"{tmp}/plain", "--resume", "--steps",
                str(LM_TRAIN_CLI_RESUME_STEPS))
            children.append(resume)
            cli["int8"] = finish_train_cli(int8)
            cli["resume"] = finish_train_cli(resume)
            assert "resumed from step 15" in cli["resume"]["stdout"], cli
            for name in ("plain", "int8"):
                assert cli[name]["final_below_first"], cli[name]
            cli["s"] = time.perf_counter() - t0
            cli["s_from_start"] = time.perf_counter() - t_cli
            out["cli"] = cli
        finally:
            L.set_dtypes(*saved)
            for _, proc in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {k: sum(x["launches"].get(k, 0) for x in
                              out["full_width"]["steps"]) for k in ops}
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    return out


def launch_grid_records(tmp) -> dict:
    """(a) of phase_launch: ``run_cell`` on both production grids for every
    cell, in this process; per-device bytes <= whole bytes <= per-device
    bytes x n_chips."""
    from repro_torch.configs import all_arch_ids, get_arch
    from repro_torch.launch.dryrun import run_cell
    n, largest, coll = 0, (0, ""), 0
    for aid in all_arch_ids():
        for shp in get_arch(aid).shape_names():
            for grid in ("single", "multi"):
                rec = run_cell(aid, shp, grid, Path(tmp) / "grids")
                per, whole = rec["argument_size_in_bytes"], \
                    rec["argument_bytes_whole"]
                assert rec["ok"] and per <= whole <= per * rec["n_chips"], rec
                largest = max(largest, (per, f"{aid}/{shp}/{grid}"))
                coll += bool(rec.get("collectives"))
                n += 1
    assert n == 80, n
    # the records of the cells a grid runs carry their collectives: the
    # GNN (16), DLRM serving (3) and dense-LM (12: training, prefill and
    # the two decodes of three archs) cells, each grid
    assert coll == 2 * (16 + 3 + 12), coll
    return {"records": n, "largest_per_device": largest,
            "with_collectives": coll}


def launch_card_cell(torch, ops, bag_ops, tmp, arch: str, shape: str,
                     probes: bool) -> tuple:
    """(b) of phase_launch: one cell through ``run_cell(..., "card")`` with
    the launch counts zeroed before it and read after it; the launches a
    step each cell's model makes; the DLRM scores against the
    ``use_kernels=False`` step (which launches nothing) within
    DLRM_SCORE_ATOL."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import dlrm

    def dlrm_check(cell, args, out):
        params, batch = args
        want = dlrm.serve_step(cell.cfg, params, batch, use_kernels=False)
        err = float((out - want).abs().max())
        assert err <= DLRM_SCORE_ATOL, err
        return {"max_abs_err": err}

    reset_launches(ops)
    rec = run_cell(arch, shape, "card", Path(tmp) / "card", probes=probes,
                   check=dlrm_check if arch == "dlrm-mlperf" else None)
    got = read_launches(ops)
    assert rec["ok"], rec
    calls = rec.get("step_calls", 0)
    line = {k: rec.get(k) for k in (
        "ran", "fits_one_card", "reason", "argument_size_in_bytes",
        "step_ms", "peak_bytes", "counted_flops", "model_flops_global",
        "useful_flops_ratio", "bf16_peak_share", "finite", "loss",
        "step_calls", "check", "wall_s")}
    line["launches"] = {k: v for k, v in got.items() if v}
    if arch == "dlrm-mlperf":
        per_step = dlrm_expected_launches(bag_ops, get_arch(arch).config, 1)
        assert per_step["embedding_bag_dma"] == 11 and \
            per_step["embedding_bag_onehot"] == 15, per_step
    elif arch in LAUNCH_BACKWARDS:
        per_step = {"embedding_bag_backward": LAUNCH_BACKWARDS[arch]}
    else:
        per_step = {}
    if rec["ran"]:
        assert rec["finite"], rec
        assert got == {k: per_step.get(k, 0) * calls for k in ops}, \
            (arch, got, per_step, calls)
        line["launches_a_step"] = per_step
    else:
        assert not any(got.values()), got
    if probes:
        line["probes"] = {k: {x: v.get(x) for x in (
            "ran", "reason", "argument_size_in_bytes", "step_ms",
            "peak_bytes", "counted_flops")} for k, v in rec.get(
            "probes", {}).items()}
        line["extrapolated"] = rec.get("extrapolated")
    return rec, got, line


def phase_launch(torch, np, ops, shared, bag_ops) -> dict:
    """The launch layer (``repro_torch.launch.steps`` / ``dryrun`` /
    ``perf``): (a) ``build_cell`` and the ``single`` / ``multi`` records
    for all 80 (cell x grid) pairs; (b) ``run_cell(..., "card")`` at full
    shape for LAUNCH_CARD_CELLS, each with the launch counts zeroed before
    it and read after it: dlrm-mlperf serve_p99 [embedding_bag "dma" 11,
    "onehot" 15 a step; scores against use_kernels=False], gcn-cora
    full_graph_sm and graphcast molecule [embedding_bag_backward 10 and 48
    a step; finite losses], qwen2-7b long_500k with probes (finite logits;
    whole and extrapolated step and peak), deepseek-v2-236b train_4k (not
    run: its arguments exceed the card); (c) ``python -m
    repro_torch.launch.dryrun --all`` in a child process that sees no card
    (80 records), started first and run beside (a)-(b); (d) ``python -m
    repro_torch.launch.perf --cell dlrm_train`` in a child process on the
    card, after (b): 4 records, every one run."""
    import os
    import shutil
    import tempfile
    out = {"phase": "launch",
           "allocated_at_start": torch.cuda.memory_allocated()}
    tmp = tempfile.mkdtemp(prefix="launch_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = []
    totals = Counter()
    try:
        all_cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--all", "--out", f"{tmp}/all"]
        all_proc = subprocess.Popen(
            all_cmd, env=dict(env, CUDA_VISIBLE_DEVICES=""), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        children.append(all_proc)
        t0 = time.perf_counter()
        out["grids"] = dict(launch_grid_records(tmp),
                            s=time.perf_counter() - t0)
        out["cells"] = {}
        for arch, shape, probes in LAUNCH_CARD_CELLS:
            rec, got, line = launch_card_cell(torch, ops, bag_ops, tmp, arch,
                                              shape, probes)
            totals.update(got)
            out["cells"][f"{arch}/{shape}"] = line
        qwen = out["cells"]["qwen2-7b/long_500k"]
        assert qwen["ran"] and qwen["extrapolated"], qwen
        assert all(p["ran"] for p in qwen["probes"].values()), qwen
        deepseek = out["cells"]["deepseek-v2-236b/train_4k"]
        assert not deepseek["ran"] and deepseek["reason"] == \
            "arguments exceed the card", deepseek
        t0 = time.perf_counter()
        perf_cmd = [sys.executable, "-m", "repro_torch.launch.perf",
                    "--cell", "dlrm_train", "--out", f"{tmp}/perf"]
        res = subprocess.run(perf_cmd, env=env, cwd=ROOT,
                             capture_output=True, text=True,
                             timeout=LAUNCH_CLI_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-2000:]
        recs = [json.loads(f.read_text())
                for f in sorted(Path(tmp, "perf").glob("*.json"))]
        assert len(recs) == 4 and all(r["ok"] and r["ran"] for r in recs), \
            [r.get("reason", r.get("error")) for r in recs]
        out["perf_dlrm_train"] = {
            "s": time.perf_counter() - t0,
            "reduced": recs[0]["reduced"],
            "records": {r["variant"]: {k: r.get(k) for k in (
                "step_ms", "peak_bytes", "counted_flops",
                "useful_flops_ratio", "loss")} for r in recs}}
        t0 = time.perf_counter()
        stdout, stderr = all_proc.communicate(timeout=LAUNCH_CLI_TIMEOUT_S)
        assert all_proc.returncode == 0, stderr[-2000:]
        n_all = len(list(Path(tmp, "all").glob("*.json")))
        assert n_all == 80 and "80 ok, 0 failed" in stdout, (n_all, stdout)
        out["dryrun_all_cli"] = {"records": n_all,
                                 "wait_s": time.perf_counter() - t0,
                                 "stdout": stdout.strip()[-120:]}
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {k: totals.get(k, 0) for k in ops}
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    return out


def grid_collective_cases(torch, spmd, grid) -> dict:
    """(a) of phase_grid: each collective on the grid's places against its
    plain loop on CPU copies, in grid order (place 0 first), bit for bit;
    the bytes the ledger counted."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def blocks(shape, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for _ in range(GRID_PLACES)]

    def loop_sum(xs, g):
        acc = xs[g[0]].cpu().float().clone()
        for m in g[1:]:
            acc += xs[m].cpu().float()
        return acc

    out = {}
    for axes in ("model", ("data", "model")):
        k = spmd.axis_size(grid, axes)
        groups = spmd.groups(grid, axes)
        name = "+".join(spmd.axes_of(axes))
        checks = {}
        xs = blocks((4 * k, 96))
        spmd.reset_ledger()
        got = spmd.all_gather(xs, grid, axes, 1)
        checks["all_gather"] = all(torch.equal(
            got[m].cpu(), torch.cat([xs[i].cpu() for i in g], 1))
            for g in groups for m in g)
        got = spmd.reduce_scatter(xs, grid, axes, 0)
        checks["reduce_scatter"] = all(torch.equal(
            got[m].cpu(), loop_sum(xs, g)[r * 4:(r + 1) * 4])
            for g in groups for r, m in enumerate(g))
        for dtype in (torch.float32, torch.bfloat16):
            ys = blocks((64, 96), dtype)
            got = spmd.all_reduce(ys, grid, axes)
            checks[f"all_reduce_{str(dtype)[6:]}"] = all(torch.equal(
                got[m].cpu(), loop_sum(ys, g).to(dtype))
                for g in groups for m in g)
        got = spmd.all_to_all(xs, grid, axes, 0, 1)
        checks["all_to_all"] = all(torch.equal(got[m].cpu(), torch.cat(
            [torch.chunk(xs[i].cpu(), k, 0)[r] for i in g], 1))
            for g in groups for r, m in enumerate(g))
        want = [[(0, 5), (96 * (k - 1), 96 * k - 1)]] * GRID_PLACES
        got = spmd.fetch(xs, grid, axes, 1, 96, want)
        checks["fetch"] = all(torch.equal(got[m].cpu(), torch.cat(
            [torch.cat([xs[i].cpu() for i in g], 1)[:, a:b]
             for a, b in want[m]], 1)) for g in groups for m in g)
        assert all(checks.values()), (name, checks)
        out[name] = {"equal_bits": checks, "ledger": spmd.ledger()}
    return out


def grid_pad_graph(torch, batch: dict, multiple: int) -> dict:
    """The graph batch with its node and edge rows padded to ``multiple``,
    as the cells' input specs pad theirs: zero rows, masks 0, padding
    edges from node 0 to node 0."""
    out = {}
    n, e = batch["node_feat"].shape[0], batch["edge_src"].shape[0]
    for k, v in batch.items():
        rows = e if k.startswith("edge_") else n
        pad = -rows % multiple
        out[k] = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
    return out


def rel_l2(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-300))


def grid_gnn(torch, np, ops, devs, shared) -> dict:
    """(b) of phase_grid: graphcast's full CONFIG on the refinement-6
    multimesh (the gnn phase's inputs, kept in ``shared`` where that phase
    ran, padded to whole GRID_GNN_PAD-row blocks) on a (2, 2) grid of
    ``devs``, through ``Cell.sharded``:
    GRID_GNN_STEPS steps [embedding_bag_backward 48 a place a step], step
    ms, peaks, the ledger of a step; the last step run again from its
    saved state, equal bit for bit; at GRID_GNN_CHECK_LAYERS layers the
    grid step against the whole step in relative L2 a leaf, within
    GRID_GNN_REL_L2 or twice what the whole step moves when only the
    order of its float32 sums changes (its edges reversed), whichever is
    larger: from a state one whole step has warmed, the loss, params and
    moments; from the fresh state the loss and moments (AdamW's first
    update of a near-zero gradient is its sign, so rounding decides
    it)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import icosahedral_mesh
    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import spmd
    from repro_torch.pytree import flatten_with_path, tree_map

    t0 = time.perf_counter()
    cfg = get_arch(GNN_ARCH).config
    if "weather_batch" not in shared:
        shared["weather_batch"] = weather_batch(
            torch, np, *icosahedral_mesh(GNN_REFINEMENT), cfg.d_in)
    batch = grid_pad_graph(torch, {k: v.to(devs[0]) for k, v in
                                   shared["weather_batch"].items()},
                           GRID_GNN_PAD)
    grid = make_grid((2, 2), devs)
    distinct = list(dict.fromkeys(devs))

    def cell_of(c):
        cell = build_cell(GNN_ARCH, "molecule", grid,
                          cfg_transform=lambda _: c)
        return dataclasses.replace(cell, in_shardings=(
            cell.in_shardings[0], cell.in_shardings[1],
            SH.gnn_batch_sharding(grid, batch)))

    def state_of(c, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = gnn.init_params(c, gen, device=devs[0])
        state = adamw.init(params)
        state.step.fill_(GRID_OPT_STEP)
        return params, state

    def sync():
        for d in distinct:
            torch.cuda.synchronize(d)

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    cell = cell_of(cfg)
    params, state = state_of(cfg, GNN_SEED)
    out = {"arch": GNN_ARCH, "grid": [2, 2], "devices": devs,
           "nodes_padded": batch["node_feat"].shape[0],
           "edges_padded": batch["edge_src"].shape[0],
           "batch_specs": {k: str(ns.spec) for k, ns in
                           cell.in_shardings[2].items()},
           "data_s": time.perf_counter() - t0}
    assert all(ns.spec != () for ns in cell.in_shardings[2].values()), out
    step = cell.sharded()
    per_step = GRID_PLACES * 3 * cfg.n_layers
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    steps, saved = [], None
    for i in range(GRID_GNN_STEPS):
        if i == GRID_GNN_STEPS - 1:
            saved = clone((params, state))
        placed = cell.place((params, state, batch))
        spmd.reset_ledger()
        res, wall, got = drive(torch, ops, lambda: (step(*placed), sync()))
        assert got["embedding_bag_backward"] == per_step and \
            sum(got.values()) == per_step, got
        loss = float(res[0][2]["loss"].blocks[0])
        assert np.isfinite(loss), (i, loss)
        steps.append({"ms": wall * 1e3, "loss": loss,
                      "ledger": spmd.ledger(),
                      "launches": {k: c for k, c in got.items() if c}})
    out["steps"] = steps
    out["launches"] = dict(sum((Counter(x["launches"]) for x in steps),
                               Counter()))
    out["ms_per_step"] = statistics.median(x["ms"] for x in steps[1:])
    out["embedding_bag_backward_per_step"] = per_step
    out["ledger_bytes_per_step"] = sum(
        v["bytes"] for v in steps[-1]["ledger"].values())
    out["peak_bytes"] = {str(d): torch.cuda.max_memory_allocated(d)
                         for d in distinct}
    last = clone((params, state))
    again = cell.place((*saved, batch))
    step(*again)
    out["repeat_equal_bits"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(last),
            flatten_with_path(spmd.gather_tree(again[:2]))))
    assert out["repeat_equal_bits"], "grid step repeated"
    del params, state, saved, last, again, placed, res
    gc.collect()
    torch.cuda.empty_cache()

    # at GRID_GNN_CHECK_LAYERS layers: the grid step against the whole
    # step, from a state one whole step has warmed (from zero moments,
    # AdamW's first update is the gradient's sign wherever |g| >> eps, so
    # a zero-initialised bias's component whose gradient cancels to
    # rounding size moves by a full step either way)
    c2 = dataclasses.replace(cfg, n_layers=GRID_GNN_CHECK_LAYERS)
    cell2 = cell_of(c2)
    opt = adamw.AdamWConfig()
    params, state = state_of(c2, GNN_SEED + 1)
    # the yardstick: the whole step on the same graph with its edges in
    # reverse order, which changes only the order of the float32 sums
    flipped = {k: v.flip(0) if k.startswith("edge_") else v
               for k, v in batch.items()}
    kinds = {"params": "0/", "m": "1/.m/", "v": "1/.v/"}

    def errors(got, want):
        errs = {"loss": rel_l2(torch, got[2]["loss"], want[2]["loss"])}
        for (path, a), (_, b) in zip(flatten_with_path(got[:2]),
                                     flatten_with_path(want[:2])):
            if a.is_floating_point():
                errs["/".join(path)] = rel_l2(torch, a, b)
        worst = sorted(errs, key=errs.get)[-3:]
        return dict({k: max(e for n, e in errs.items() if n.startswith(pre))
                     for k, pre in kinds.items()}, loss=errs["loss"],
                    worst={n: errs[n] for n in worst}, leaves=len(errs))

    checks = {}
    for warm in (False, True):
        if warm:
            gnn.train_step(c2, opt, params, state, batch)
        whole = gnn.train_step(c2, opt, *clone((params, state)), batch)
        grid_out = spmd.gather_tree(cell2.sharded()(*cell2.place(
            clone((params, state)) + (batch,))))
        reordered = gnn.train_step(c2, opt, *clone((params, state)),
                                   flipped)
        checks["warm" if warm else "cold"] = {
            "grid": errors(grid_out, whole),
            "reordered_sums": errors(reordered, whole)}
    out["check_2_layers"] = checks
    for name, c in checks.items():
        for k in ("loss", *kinds):
            if name == "cold" and k == "params":
                continue
            bound = max(GRID_GNN_REL_L2, 2 * c["reordered_sums"][k])
            assert c["grid"][k] <= bound, (name, k, checks)
    del params, state, whole, grid_out
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def grid_expected_launches(bag_ops, cfg, k: int) -> dict:
    """The embedding_bag launches of one grid serve step on a (1, k) grid:
    every place looks every field up, in its row block of a table split
    over ``model`` (its rows divide by k) or in the whole table, each
    launch's mode as "auto" picks it for those rows' bytes."""
    out = Counter()
    for v in cfg.table_sizes:
        rows = v // k if v % k == 0 else v
        nbytes = rows * cfg.embed_dim * 2
        mode = "onehot" if nbytes <= bag_ops.ONEHOT_MAX_BYTES else "dma"
        out[f"embedding_bag_{mode}"] += k
        if mode == "onehot":
            w = bag_ops.onehot_route(rows, cfg.embed_dim, elem=2)
            out[f"embedding_bag_onehot_{'slices' if w else 'rows'}"] += k
    return dict(out)


def grid_dlrm(torch, np, ops, bag_ops, devs) -> dict:
    """(c) of phase_grid: dlrm-mlperf serve_p99 at CONFIG on a (1, 4) grid
    of ``devs``, the tables from ``init_params`` on the first device and
    their row blocks views of them where a place lies there; scores
    within DLRM_SCORE_ATOL of the whole ``serve_step``; embedding_bag
    launches a step: per field a block a place, each block's mode as
    "auto" picks it for the block's bytes (``grid_expected_launches``)."""
    import gc
    from repro_torch.data.recsys import CriteoLikeGenerator
    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import dlrm
    from repro_torch.parallel import spmd

    t0 = time.perf_counter()
    grid = make_grid((1, GRID_PLACES), devs)
    distinct = list(dict.fromkeys(devs))
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)

    def run():
        got = step(*placed)
        for d in distinct:
            torch.cuda.synchronize(d)
        return got
    cell = build_cell(DLRM_ARCH, "serve_p99", grid)
    cfg = cell.cfg
    gen = torch.Generator(device="cuda").manual_seed(DLRM_SEED)
    params = dlrm.init_params(cfg, gen, device=devs[0])
    b = cell.arg_specs[1]["dense"].shape[0]
    data = CriteoLikeGenerator(cfg.table_sizes, n_dense=cfg.n_dense,
                               hot=cfg.hot, seed=DLRM_SEED)
    batch = {k: torch.from_numpy(v).to(devs[0])
             for k, v in data.batch(b, with_labels=False).items()}
    out = {"arch": DLRM_ARCH, "grid": [1, GRID_PLACES], "devices": devs,
           "batch": b, "table_bytes": sum(
               params[f"table{t}"].numel() * 2 for t in range(cfg.n_sparse))}
    placed = cell.place((params, batch))
    views = 0
    for t in range(cfg.n_sparse):
        whole_ptr = params[f"table{t}"].untyped_storage().data_ptr()
        views += sum(blk.untyped_storage().data_ptr() == whole_ptr
                     for blk in placed[0][f"table{t}"].blocks)
    out["table_blocks_that_are_views"] = views
    if len(distinct) == 1:
        assert views == GRID_PLACES * cfg.n_sparse, views
    want = dlrm.serve_step(cfg, params, batch)
    step = cell.sharded()
    expect = grid_expected_launches(bag_ops, cfg, GRID_PLACES)
    assert sum(v for k, v in expect.items() if k in (
        "embedding_bag_dma", "embedding_bag_onehot")) == \
        GRID_PLACES * cfg.n_sparse, expect
    spmd.reset_ledger()
    got_scores, wall, got = drive(torch, ops, run)
    assert {k: v for k, v in got.items() if v} == \
        {k: v for k, v in expect.items() if v}, (got, expect)
    launches_a = dict(got)
    err = float((spmd.gather(got_scores).to(want.device) - want).abs().max())
    assert err <= DLRM_SCORE_ATOL, err
    out.update(max_abs_err=err, launches_a_step={k: v for k, v in
                                                 got.items() if v},
               ledger=spmd.ledger(), first_ms=wall * 1e3)
    launches = Counter(got)
    times = []
    for _ in range(5):
        _, wall, got = drive(torch, ops, run)
        assert got == launches_a, got
        launches.update(got)
        times.append(wall * 1e3)
    out["launches"] = dict(launches)
    out["ms_per_step"] = statistics.median(times)
    out["whole_ms"] = cuda_ms(lambda: dlrm.serve_step(cfg, params, batch), 5)
    out["peak_bytes"] = {str(d): torch.cuda.max_memory_allocated(d)
                         for d in distinct}
    del params, placed, batch, want, got_scores
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def grid_lm(torch, np, ops, devs) -> dict:
    """(d) of phase_grid: qwen2-7b's CONFIG cut to GRID_LM_LAYERS layers
    on a (1, 4) grid of ``devs``: ``transformer_sharded.prefill`` of
    GRID_LM_BATCH x GRID_LM_PROMPT tokens into a cache of GRID_LM_GEN more
    positions, then GRID_LM_GEN steps of the decode cell's
    ``Cell.sharded`` fed the whole model's greedy tokens; each step's
    logits within LM_LOGIT_REL of the row's largest |logit| of the whole
    model's, the grid's greedy token (an argmax over places) equal to the
    whole model's wherever the top-2 margin exceeds that bound; ms a
    token and the ledger's bytes. GEMMs accumulate in float32
    (``layers.float32_accumulation``)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M
    from repro_torch.models import transformer_sharded as TFS
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import spmd
    from repro_torch.pytree import leaves

    t0 = time.perf_counter()
    grid = make_grid((1, GRID_PLACES), devs)
    distinct = list(dict.fromkeys(devs))
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)

    def sync():
        for d in distinct:
            torch.cuda.synchronize(d)

    cut = lambda c: dataclasses.replace(c, n_layers=GRID_LM_LAYERS)
    pre = build_cell(LM_ARCH, "prefill_32k", grid, cfg_transform=cut)
    dec = build_cell(LM_ARCH, "decode_32k", grid, cfg_transform=cut)
    cfg = dec.cfg
    out = {"arch": LM_ARCH, "n_layers": cfg.n_layers,
           "full_layers": get_arch(LM_ARCH).config.n_layers,
           "grid": [1, GRID_PLACES], "devices": devs,
           "batch": GRID_LM_BATCH, "prompt": GRID_LM_PROMPT,
           "gen": GRID_LM_GEN}
    max_len = GRID_LM_PROMPT + GRID_LM_GEN
    with L.float32_accumulation():
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(LM_SEED),
            devs[0])
        out["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in leaves(params))
        tok = torch.from_numpy(TokenStream(cfg.vocab, seed=0).batch(
            GRID_LM_BATCH, GRID_LM_PROMPT)["tokens"]).to(devs[0])
        # the whole model: prefill, then greedy decode
        cache, last = M.prefill(cfg, params, tok, max_len=max_len)
        want_logits, want_tokens = [last], []
        cur = last.argmax(-1).to(torch.int32)[:, None]
        for i in range(GRID_LM_GEN):
            want_tokens.append(cur)
            lg, cache = M.decode_step(cfg, params, cache, cur,
                                      GRID_LM_PROMPT + i)
            want_logits.append(lg)
            cur = lg.argmax(-1).to(torch.int32)[:, None]
        del cache
        # the grid: prefill, then the decode cell fed the same tokens
        p_sh = pre.place((params, tok))
        cache_sh = SH.lm_cache_sharding(grid, M.cache_specs(
            cfg, GRID_LM_BATCH, max_len))
        spmd.reset_ledger()
        sync()
        t1 = time.perf_counter()
        per_place = TFS.prefill(cfg, p_sh[0], p_sh[1], cache_sh, max_len)
        sync()
        out["prefill_ms"] = (time.perf_counter() - t1) * 1e3
        out["prefill_ledger"] = spmd.ledger()
        cache_g = spmd.assemble([c for c, _ in per_place], cache_sh)
        logits_g = spmd.assemble([lg for _, lg in per_place],
                                 pre.out_shardings[1])
        step = dec.sharded()
        errs, margins_ok, times, ledgers = [], [], [], []
        for i in range(GRID_LM_GEN + 1):
            lg = spmd.gather(logits_g)
            ref = want_logits[i]
            errs.append(logits_err(torch, lg, ref))
            greedy = spmd.gather(spmd.assemble(
                TFS.greedy(logits_g), dec.in_shardings[2]))[:, 0]
            top2 = ref.float().topk(2, dim=-1).values
            scale = ref.float().abs().amax(-1)
            sure = (top2[:, 0] - top2[:, 1]) > LM_LOGIT_REL * scale
            margins_ok.append(bool(torch.equal(
                greedy[sure].long(), ref.argmax(-1)[sure])))
            if i == GRID_LM_GEN:
                break
            token = spmd.place(want_tokens[i], dec.in_shardings[2])
            pos = spmd.place(torch.tensor(GRID_LM_PROMPT + i,
                                          dtype=torch.int32, device=devs[0]),
                             dec.in_shardings[3])
            spmd.reset_ledger()
            sync()
            t1 = time.perf_counter()
            logits_g, cache_g = step(p_sh[0], cache_g, token, pos)
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
            ledgers.append(spmd.ledger())
    out["max_logit_err"] = max(errs)
    out["greedy_equal_where_sure"] = all(margins_ok)
    assert out["max_logit_err"] <= LM_LOGIT_REL, errs
    assert out["greedy_equal_where_sure"], margins_ok
    out["decode_ms_per_token"] = statistics.median(times)
    out["decode_ms_all"] = times
    out["decode_ledger"] = ledgers[-1]
    out["decode_ledger_bytes"] = sum(v["bytes"] for v in ledgers[-1].values())
    out["peak_bytes"] = {str(d): torch.cuda.max_memory_allocated(d)
                         for d in distinct}
    del params, cache_g, logits_g, p_sh, per_place
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def phase_grid(torch, np, ops, shared, bag_ops) -> dict:
    """Cells split over a named grid (``launch.steps.Cell.sharded``, one
    process driving every place, ``parallel.spmd``): (a) each collective
    on ``["cuda:0"] * 4`` against its plain loop, bit for bit; (b)
    graphcast's full CONFIG training on a (2, 2) grid (``grid_gnn``); (c)
    dlrm-mlperf serve_p99 at CONFIG on a (1, 4) grid (``grid_dlrm``); (d)
    qwen2-7b serving on a (1, 4) grid (``grid_lm``); (e) where four cards
    are visible, (b)-(d) again on ``cuda:0..3``, else the line says why
    not. The launch counts are zeroed before each grid step and read after
    it (``drive``)."""
    import gc
    from repro_torch.launch.mesh import make_grid
    from repro_torch.parallel import spmd
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = ["cuda:0"] * GRID_PLACES
    out = {"phase": "grid", "nvidia_smi": nvidia_smi_line(),
           "allocated_at_start": torch.cuda.memory_allocated()}
    out["collectives"] = grid_collective_cases(torch, spmd,
                                               make_grid((2, 2), one))
    runs = [("gnn", lambda d: grid_gnn(torch, np, ops, d, shared)),
            ("dlrm", lambda d: grid_dlrm(torch, np, ops, bag_ops, d)),
            ("lm", lambda d: grid_lm(torch, np, ops, d))]
    for name, run in runs:
        out[name] = run(one)
    n = torch.cuda.device_count()
    if n >= GRID_PLACES:
        cards = [f"cuda:{i}" for i in range(GRID_PLACES)]
        out["distinct_cards"] = {name: run(cards) for name, run in runs}
    else:
        out["distinct_cards"] = f"not run: {n} visible"
    totals = Counter()
    for res in [out[name] for name, _ in runs] + (
            list(out["distinct_cards"].values())
            if isinstance(out["distinct_cards"], dict) else []):
        totals.update(res.get("launches", {}))
    out["launches"] = {k: totals.get(k, 0) for k in ops}
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    out["s"] = time.perf_counter() - t0
    assert out["s"] <= GRID_PHASE_LIMIT_S or n >= GRID_PLACES, out["s"]
    return out


def grid_train_cell(n_layers: int, devs):
    """qwen2-7b's train_4k cell at its full width cut to ``n_layers``
    layers, remat "layer", on a (2, 2) grid of ``devs``, its batch
    GRID_TRAIN_BATCH x GRID_TRAIN_SEQ."""
    import dataclasses
    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.steps import build_cell
    return build_cell(
        LM_ARCH, "train_4k", make_grid((2, 2), devs),
        cfg_transform=lambda c: dataclasses.replace(c, n_layers=n_layers,
                                                    remat="layer"),
        dims={"batch": GRID_TRAIN_BATCH, "seq": GRID_TRAIN_SEQ})


def grid_train_args(torch, cell, seed: int) -> tuple:
    """The cell's params and AdamW state made on their places
    (``dryrun.make_placed_args``: each leaf drawn whole on the first
    device, its blocks copied out and the leaf freed before the next),
    the state's step set to GRID_OPT_STEP."""
    from repro_torch.launch import dryrun
    params, state, _ = dryrun.make_placed_args(cell, seed=seed)
    for b in state.step.blocks:
        b.fill_(GRID_OPT_STEP)
    return params, state


def sharded_checksums(torch, adamw, spmd, tree) -> list:
    """``leaf_checksums`` of each ``spmd.Sharded`` leaf's blocks: a leaf
    whose sums changed moved."""
    from repro_torch.pytree import leaves
    return [leaf_checksums(torch, adamw, list(sh.blocks)) for sh in
            leaves(tree, is_leaf=lambda x: isinstance(x, spmd.Sharded))]


def grid_train_run(torch, np, ops, grad_ops, devs, n_layers: int,
                   n_steps: int, record_embed: bool = False,
                   peak_limit: float = GRID_TRAIN_PEAK_LIMIT) -> tuple:
    """(a) and (c) of phase_grid_train: qwen2-7b's train_4k cell at
    ``n_layers`` layers on a (2, 2) grid of ``devs`` through
    ``Cell.sharded``, the arguments made on their places
    (``grid_train_args``); ``n_steps`` steps [embedding_bag_backward 4 a
    step: each place's vocabulary block], step ms with every device
    synchronised, each device's peak (making the arguments, and in the
    steps; each below ``peak_limit``), the ledger of a step, finite losses
    and gradient norms with the same bits on every place, every leaf
    moved. Returns (its line,
    the first step's loss and gradient norm, place 0's
    embedding-gradient inputs of the last step where ``record_embed``)."""
    import gc
    from repro_torch.optim import adamw
    from repro_torch.parallel import spmd
    from repro_torch.pytree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    distinct = list(dict.fromkeys(devs))

    def sync():
        for d in distinct:
            torch.cuda.synchronize(d)

    def peaks():
        return {str(d): torch.cuda.max_memory_allocated(d) for d in distinct}

    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    cell = grid_train_cell(n_layers, devs)
    cfg = cell.cfg
    params, state = grid_train_args(torch, cell, GRID_TRAIN_SEED)
    sync()
    n_params = cfg.params_count()
    out = {"arch": LM_ARCH, "grid": [2, 2], "devices": devs,
           "n_layers": cfg.n_layers, "remat": cfg.remat, "params": n_params,
           "batch": GRID_TRAIN_BATCH, "seq": GRID_TRAIN_SEQ,
           "opt_step": GRID_OPT_STEP, "init_s": time.perf_counter() - t0,
           "state_bytes": {str(d): torch.cuda.memory_allocated(d)
                           for d in distinct},
           "init_peak_bytes": peaks(),
           "largest_leaf_bytes": max(t.numel() * t.element_size()
                                     for t in leaves(cell.arg_specs[0]))}
    batches = [spmd.place_tree(b, cell.in_shardings[2]) for b in lm_batches(
        torch, cfg.vocab, n_steps, GRID_TRAIN_BATCH, GRID_TRAIN_SEQ)]
    before = sharded_checksums(torch, adamw, spmd, params)
    step = cell.sharded()
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    steps, seen = [], []
    for i, batch in enumerate(batches):
        log = seen if record_embed and i == n_steps - 1 else []
        spmd.reset_ledger()
        with recording_bag_backward(grad_ops, log):
            res, wall, got = drive(torch, ops, lambda: (
                step(params, state, batch), sync()))
        assert got["embedding_bag_backward"] == GRID_PLACES and \
            sum(got.values()) == GRID_PLACES, got
        m = res[0][2]
        for name in ("loss", "grad_norm", "lr"):
            assert all(torch.equal(b.cpu(), m[name].blocks[0].cpu())
                       for b in m[name].blocks), (i, name)
        loss = float(m["loss"].blocks[0])
        gnorm = float(m["grad_norm"].blocks[0])
        assert np.isfinite(loss) and np.isfinite(gnorm), (i, loss, gnorm)
        steps.append({"ms": wall * 1e3, "loss": loss, "grad_norm": gnorm,
                      "lr": float(m["lr"].blocks[0]),
                      "ledger": spmd.ledger(),
                      "launches": {k: c for k, c in got.items() if c}})
        del res, m
    out["steps"] = steps
    out["losses"] = [x["loss"] for x in steps]
    step_ms = statistics.median(x["ms"] for x in steps[1:] or steps)
    tokens = GRID_TRAIN_BATCH * GRID_TRAIN_SEQ
    out["ms_per_step"] = step_ms
    out["tokens_per_s"] = tokens / step_ms * 1e3
    out["model_flops_per_step"] = 6 * n_params * tokens
    out["model_flops_share"] = out["model_flops_per_step"] / step_ms * 1e3 \
        / (H100_BF16_FLOPS * len(distinct))
    out["ledger"] = steps[-1]["ledger"]
    out["ledger_bytes_per_step"] = sum(
        v["bytes"] for v in steps[-1]["ledger"].values())
    out["embedding_bag_backward_per_step"] = GRID_PLACES
    out["launches"] = dict(sum((Counter(x["launches"]) for x in steps),
                               Counter()))
    out["peak_bytes"] = peaks()
    for peak in (out["init_peak_bytes"], out["peak_bytes"]):
        assert max(peak.values()) < peak_limit, out
    after = sharded_checksums(torch, adamw, spmd, params)
    out["leaves"] = len(before)
    out["leaves_moved"] = sum(a != b for a, b in zip(before, after))
    assert out["leaves_moved"] == len(before), out
    embed = None
    if record_embed:
        grad_out, idx, v, dtype = seen[0]
        embed = (grad_out.detach().clone(), idx.clone(), v, dtype)
    first = {"loss": steps[0]["loss"], "grad_norm": steps[0]["grad_norm"]}
    del params, state, batches, seen, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, first, embed


def grid_train_whole(torch, ops, n_layers: int) -> dict:
    """The yardstick of (a): the whole ``transformer.train_step`` of the
    same cell on the first card, on the params the grid made (the same
    generator and draws, ``layers.materialize``) and the grid's first
    batch: its loss, gradient norm, ms and peak."""
    import gc
    from repro_torch.launch.steps import OPT_CFG
    from repro_torch.models import transformer as M
    from repro_torch.optim import adamw
    cfg = grid_train_cell(n_layers, ["cuda:0"] * GRID_PLACES).cfg
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        GRID_TRAIN_SEED), "cuda")
    state = adamw.init(params)
    state.step.fill_(GRID_OPT_STEP)
    batch, = lm_batches(torch, cfg.vocab, 1, GRID_TRAIN_BATCH,
                        GRID_TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    res, wall, got = drive(torch, ops, lambda: M.train_step(
        cfg, OPT_CFG, params, state, batch))
    out = {"loss": float(res[2]["loss"]),
           "grad_norm": float(res[2]["grad_norm"]), "ms": wall * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": {k: c for k, c in got.items() if c}}
    del params, state, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rel_l2_sliced(torch, adamw, got, want, fn=lambda t: t) -> float:
    """``rel_l2`` of ``fn(got)`` against ``fn(want)``, taken over
    ``adamw.pieces`` slices (no whole-leaf float64 temporary)."""
    num = den = 0.0
    for at in adamw.pieces(got.shape):
        g, w = fn(got[at]).double(), fn(want[at]).double()
        num += float(torch.sum(torch.square(g - w)))
        den += float(torch.sum(torch.square(w)))
    return math.sqrt(num) / max(math.sqrt(den), 1e-300)


def adamw_from_moments(torch, adamw, opt_cfg, p, m, v, step):
    """The param ``adamw.apply`` makes of ``p`` from its new moments ``m``
    and ``v`` at ``step`` (the step after its increment): the same float32
    operations in the same order, so a block updated once from its own
    moments equals it bit for bit."""
    lr = adamw.schedule(opt_cfg, step)
    bc1, bc2 = adamw.bias_corrections(opt_cfg, step)
    delta = (m / bc1) / (torch.sqrt(v / bc2) + opt_cfg.eps)
    if opt_cfg.weight_decay and p.dim() >= 2:
        delta = delta + opt_cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype)


def grid_train_step_check(torch, cell, p32, batch, bounds: dict) -> dict:
    """One float32 grid step (``Cell.sharded``) against the whole
    ``transformer.train_step``, both from ``p32`` and zero moments at step
    GRID_OPT_STEP: each leaf's first moment, and the square root of its
    second (``|g|`` moves no further than ``g``), within ``bounds`` (the
    leaf's gradient bound) plus the two gradient norms' relative distance
    (the clip's scale); every param equal bit for bit to the AdamW update
    of ``p32`` from its own new moments (``adamw_from_moments``), on the
    grid and in the whole step, so each distinct block was updated once
    from its own moments; the updates' relative L2 to the whole step's
    recorded (AdamW's first update is nearly the gradient's sign, so a
    component whose gradient is at rounding size flips)."""
    from repro_torch.launch.steps import OPT_CFG
    from repro_torch.models import transformer as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import spmd
    from repro_torch.pytree import flatten_with_path, leaves, tree_map
    is_sh = lambda x: isinstance(x, spmd.Sharded)

    def fresh():
        state = adamw.init(p32)
        state.step.fill_(GRID_OPT_STEP)
        return tree_map(torch.clone, p32), state

    pw, sw, mw = M.train_step(cell.cfg, OPT_CFG, *fresh(), batch)
    pg, sg, mg = cell.sharded()(*cell.place((*fresh(), batch)))
    norms = {"grid": float(mg["grad_norm"].blocks[0]),
             "whole": float(mw["grad_norm"])}
    norm_rel = abs(norms["grid"] - norms["whole"]) / norms["whole"]
    step = torch.full((), GRID_OPT_STEP + 1, dtype=torch.int32,
                      device=batch["tokens"].device)
    errs, own = {}, {}
    for (path, p0), g, w, gm, wm, gv, wv in zip(
            flatten_with_path(p32), leaves(pg, is_leaf=is_sh), leaves(pw),
            leaves(sg.m, is_leaf=is_sh), leaves(sw.m),
            leaves(sg.v, is_leaf=is_sh), leaves(sw.v)):
        n = "/".join(path)
        g, gm, gv = spmd.gather(g), spmd.gather(gm), spmd.gather(gv)
        errs[n] = {
            "m": rel_l2_sliced(torch, adamw, gm, wm),
            "sqrt_v": rel_l2_sliced(torch, adamw, gv, wv, torch.sqrt),
            "update": rel_l2_sliced(torch, adamw, g - p0, w - p0),
            "bound": bounds[n] + norm_rel}
        own[n] = all(
            torch.equal(x[at], adamw_from_moments(
                torch, adamw, OPT_CFG, p0[at], xm[at], xv[at], step))
            for x, xm, xv in ((g, gm, gv), (w, wm, wv))
            for at in adamw.pieces(p0.shape))
        del g, gm, gv
    del pg, sg, pw, sw
    over = {n: e for n, e in errs.items()
            if max(e["m"], e["sqrt_v"]) > e["bound"]}
    worst = max(errs, key=lambda n: errs[n]["update"])
    out = {"leaves": len(errs), "grad_norms": norms,
           "loss": {"grid": float(mg["loss"].blocks[0]),
                    "whole": float(mw["loss"])},
           "max_m": max(e["m"] for e in errs.values()),
           "max_sqrt_v": max(e["sqrt_v"] for e in errs.values()),
           "params_equal_own_moments_update": all(own.values()),
           "worst_update": {"leaf": worst, **errs[worst]},
           "over": over}
    assert not over and all(own.values()), (
        out, [n for n, ok in own.items() if not ok])
    return out


def grid_train_checks(torch, np, devs) -> dict:
    """(b) of phase_grid_train, at GRID_TRAIN_CHECK_LAYERS layers of the
    full width on a (2, 2) grid of ``devs``, the params made on their
    places: remat "layer", "none" and "dots" give the same loss, norm and
    gradient blocks bit for bit; the grid step run twice from one state,
    equal bit for bit in the params, moments and metrics; the same params
    in float32: each leaf's gradient gathered from the grid within
    GRID_TRAIN_REL_L2 relative L2 of the whole model's with the batch's
    mean split by sequence (each sequence's gradient alone, the two
    added, as the grid's data-parallel step splits them), and within
    GRID_TRAIN_REL_L2 of the whole model's, or within twice the split
    whole model's own distance from it where that is larger; the loss
    likewise; one float32 grid step against the whole step
    (``grid_train_step_check``); the bfloat16 grid gradient within
    LM_GRAD_REL of the whole float32 one."""
    import dataclasses
    import gc
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M
    from repro_torch.models import transformer_sharded as TFS
    from repro_torch.parallel import spmd
    from repro_torch.pytree import flatten_with_path, leaves, tree_map
    is_sh = lambda x: isinstance(x, spmd.Sharded)
    cell = grid_train_cell(GRID_TRAIN_CHECK_LAYERS, devs)
    cfg = cell.cfg
    params, state = grid_train_args(torch, cell, GRID_TRAIN_SEED + 1)
    batch, = lm_batches(torch, cfg.vocab, 1, GRID_TRAIN_BATCH,
                        GRID_TRAIN_SEQ)
    placed = spmd.place_tree(batch, cell.in_shardings[2])
    out = {"n_layers": cfg.n_layers}

    def grid_grads(c, p):
        losses, grads, norms = TFS.loss_and_grad(c, p, placed)
        return [losses[0], norms[0]] + [
            b for sh in leaves(grads, is_leaf=is_sh) for b in sh.blocks], \
            grads

    ref, g_bf16 = grid_grads(cfg, params)
    for remat in ("none", "dots"):
        got, _ = grid_grads(dataclasses.replace(cfg, remat=remat), params)
        assert len(got) == len(ref) and all(
            torch.equal(a, b) for a, b in zip(got, ref)), remat
        del got
    out["remat_equal_bits"] = True
    out["blocks_compared"] = len(ref)
    loss_bf16 = float(ref[0])
    del ref
    p32 = tree_map(lambda sh: spmd.gather(sh).float(), params,
                   is_leaf=is_sh)
    # the grid step twice from one state
    step = cell.sharded()
    copy = cell.place((*spmd.gather_tree((params, state)), batch))
    a = step(params, state, placed)
    b = step(*copy)
    pairs = list(zip(leaves(a, is_leaf=is_sh), leaves(b, is_leaf=is_sh)))
    out["repeat_equal_bits"] = all(
        torch.equal(x, y) for sa, sb in pairs
        for x, y in zip(sa.blocks, sb.blocks))
    out["repeat_leaves_compared"] = len(pairs)
    assert out["repeat_equal_bits"], "grid train step repeated"
    del params, state, copy, a, b, pairs, step
    gc.collect()
    torch.cuda.empty_cache()
    # float32: the whole model, the whole model split by sequence and the
    # grid, each leaf's distances taken as each gradient comes
    names = ["/".join(path) for path, _ in flatten_with_path(p32)]
    errs = {n: {} for n in names}

    def distances(key, grads, want, back=lambda g: g):
        for n, g, w in zip(names, leaves(grads, is_leaf=is_sh),
                           leaves(want)):
            errs[n][key] = rel_l2(torch, back(g), w)

    saved = L.PDTYPE, L.ADTYPE
    L.set_dtypes(torch.float32, torch.float32)
    try:
        loss_w, g_whole = grads_of(torch, L, M, cfg, p32, batch)
        distances("bf16", g_bf16, g_whole, lambda g: spmd.gather(g).float())
        del g_bf16
        # the batch's mean as the mean of each sequence's mean (equal
        # lengths; the division by the batch is exact)
        loss_s, g_split = grads_of(torch, L, M, cfg, p32, {
            k: v[:1] for k, v in batch.items()})
        for i in range(1, GRID_TRAIN_BATCH):
            loss_i, g_i = grads_of(torch, L, M, cfg, p32, {
                k: v[i:i + 1] for k, v in batch.items()})
            loss_s = loss_s + loss_i
            for x, y in zip(leaves(g_split), leaves(g_i)):
                x.add_(y)
            del g_i
        loss_s = loss_s / GRID_TRAIN_BATCH
        for x in leaves(g_split):
            x.div_(GRID_TRAIN_BATCH)
        distances("split", g_split, g_whole)
        flat32, g_grid = grid_grads(cfg, spmd.place_tree(
            p32, cell.in_shardings[0]))
        loss_grid = float(flat32[0])
        del flat32
        distances("grid", g_grid, g_whole, spmd.gather)
        distances("grid_vs_split", g_grid, g_split, spmd.gather)
        del g_grid, g_split, g_whole
        gc.collect()
        torch.cuda.empty_cache()
        for e in errs.values():
            e["bound"] = max(GRID_TRAIN_REL_L2, 2 * e["split"])
        over = {n: e for n, e in errs.items() if e["grid"] > e["bound"]
                or e["grid_vs_split"] > GRID_TRAIN_REL_L2}
        top = sorted(errs, key=lambda n: errs[n]["grid"])[-3:]
        losses = {"grid": loss_grid, "whole": float(loss_w),
                  "split": float(loss_s)}
        out["f32_grid_vs_whole"] = {
            "bound": GRID_TRAIN_REL_L2, "leaves": len(errs),
            "worst": {n: errs[n] for n in top},
            "max_grid": max(e["grid"] for e in errs.values()),
            "max_grid_vs_split": max(e["grid_vs_split"]
                                     for e in errs.values()),
            "max_split": max(e["split"] for e in errs.values()),
            "losses": losses}
        assert not over, (over, out["f32_grid_vs_whole"])
        rel = {k: abs(v - losses["whole"]) / losses["whole"]
               for k, v in losses.items()}
        assert rel["grid"] <= max(GRID_TRAIN_REL_L2, 2 * rel["split"]) \
            and abs(loss_grid - losses["split"]) / losses["split"] <= \
            GRID_TRAIN_REL_L2, losses
        out["f32_step"] = grid_train_step_check(
            torch, cell, p32, batch, {n: e["bound"] for n, e in errs.items()})
        del p32
    finally:
        L.set_dtypes(*saved)
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(errs, key=lambda n: errs[n]["bf16"])
    out["bf16_grid_vs_f32_whole"] = {
        "bound": LM_GRAD_REL, "worst_leaf": worst,
        "worst_rel_l2": errs[worst]["bf16"], "loss_bf16": loss_bf16,
        "loss_f32": losses["whole"]}
    assert errs[worst]["bf16"] <= LM_GRAD_REL, out["bf16_grid_vs_f32_whole"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def phase_grid_train(torch, np, ops, shared, grad_ops) -> dict:
    """Dense-LM training split over a named grid (``Cell.sharded`` of
    qwen2-7b's train_4k cell: FSDP over ``data``, tensor parallelism over
    ``model``, the gradient through every collective, grid-wide remat),
    four places on the card repeated, in bfloat16 with float32
    accumulation (``layers.float32_accumulation``): (a) GRID_TRAIN_LAYERS
    layers, ``grid_train_run`` [embedding_bag_backward 4 a step], its
    first step's loss and gradient norm within GRID_TRAIN_REL of the
    whole ``transformer.train_step`` (``grid_train_whole``); one place's
    embedding gradient alone (``time_segment_sum``: its block of 76,032
    rows, ids outside it skipped); (b) ``grid_train_checks`` at
    GRID_TRAIN_CHECK_LAYERS layers; (c) where four cards are visible, all
    28 layers on cuda:0..3 (each card's peak below GRID_TRAIN_PEAK_LIMIT
    and below the whole params and moments), else ``"distinct_cards":
    "not run: <n> visible"``. The launch counts are zeroed before each
    grid step and read after it (``drive``)."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = ["cuda:0"] * GRID_PLACES
    n = torch.cuda.device_count()
    out = {"phase": "grid_train", "nvidia_smi": nvidia_smi_line(),
           "allocated_at_start": torch.cuda.memory_allocated()}
    runs = []
    saved = L.PDTYPE, L.ADTYPE
    with L.float32_accumulation():
        try:
            L.set_dtypes(torch.bfloat16, torch.bfloat16)
            t1 = time.perf_counter()
            full, first, embed = grid_train_run(
                torch, np, ops, grad_ops, one, GRID_TRAIN_LAYERS,
                GRID_TRAIN_STEPS, record_embed=True)
            runs.append(full)
            whole = grid_train_whole(torch, ops, GRID_TRAIN_LAYERS)
            rel = {k: abs(first[k] - whole[k]) / abs(whole[k])
                   for k in ("loss", "grad_norm")}
            full["whole"] = dict(whole, grid_first_step=first, rel=rel,
                                 bound=GRID_TRAIN_REL)
            assert max(rel.values()) <= GRID_TRAIN_REL, full["whole"]
            full["s"] = time.perf_counter() - t1
            out["one_card"] = full
            t1 = time.perf_counter()
            grad_out, idx, v, dtype = embed
            del embed
            shared["grid_train_embed_timing"] = time_segment_sum(
                torch, grad_ops, grad_out, idx.view(-1), v, dtype=dtype)
            del grad_out, idx
            out["embed_backward_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            out["check"] = dict(grid_train_checks(torch, np, one),
                                s=time.perf_counter() - t1)
            out["one_card_s"] = time.perf_counter() - t0
            assert out["one_card_s"] <= GRID_TRAIN_PHASE_LIMIT_S, \
                out["one_card_s"]
            if n >= GRID_PLACES:
                t1 = time.perf_counter()
                cards = [f"cuda:{i}" for i in range(GRID_PLACES)]
                res, _, _ = grid_train_run(
                    torch, np, ops, grad_ops, cards,
                    get_arch(LM_ARCH).config.n_layers, 2)
                # AdamW's state alone: bfloat16 params and two float32
                # moments, 10 B a param
                res["whole_state_bytes"] = 10 * res["params"]
                for peak in (res["init_peak_bytes"], res["peak_bytes"]):
                    assert max(peak.values()) < res["whole_state_bytes"], res
                res["s"] = time.perf_counter() - t1
                runs.append(res)
                out["distinct_cards"] = res
                assert res["s"] <= GRID_TRAIN_CARDS_LIMIT_S, res["s"]
            else:
                out["distinct_cards"] = f"not run: {n} visible"
        finally:
            L.set_dtypes(*saved)
    totals = Counter()
    for res in runs:
        totals.update(res["launches"])
    out["launches"] = {k: totals.get(k, 0) for k in ops}
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_at_end"] = torch.cuda.memory_allocated()
    out["s"] = time.perf_counter() - t0
    return out


def phase_dryrun(torch, ops, shared) -> dict:
    """The fabric dry run (``repro_torch.launch.dryrun``): ``fabric_dryrun``
    in this process at the reference test's size (3 shards, 64 vertices,
    200 edges) and at the CLI's defaults, then ``python -m
    repro_torch.launch.dryrun --fabric`` in a child process that sees no
    card. Each record is consistent (boxes and mass summed over the
    shards) and equal to its JSON file; no kernel is launched."""
    import os
    import tempfile

    from repro_torch.launch.dryrun import fabric_dryrun
    out = {"phase": "dryrun", "records": {}}
    reset_launches(ops)
    with tempfile.TemporaryDirectory() as tmp:
        for n in DRYRUN_SHARDS:
            kw = {"nv": 64, "ne": 200} if n == 3 else {}
            rec = fabric_dryrun(Path(tmp), n_shards=n, **kw)
            on_disk = json.loads((Path(tmp) / f"fabric__triangle__s{n}.json")
                                 .read_text())
            assert on_disk == rec and rec["ok"] and rec["n_shards"] == n
            assert len(rec["shards"]) == n
            assert sum(x["boxes"] for x in rec["shards"]) == rec["n_boxes"]
            assert sum(x["mass"] for x in rec["shards"]) == rec["total_mass"]
            out["records"][f"s{n}"] = {k: rec[k] for k in (
                "n_boxes", "rank", "total_mass", "shards", "wall_s")}
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=str(ROOT / "src"))
        cli = Path(tmp) / "cli"
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--fabric",
             "--fabric-shards", "2", "--out", str(cli)], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        rec = json.loads((cli / "fabric__triangle__s2.json").read_text())
        assert rec["ok"] and rec["n_shards"] == 2
        out["cli"] = {"s": time.perf_counter() - t0,
                      "n_boxes": rec["n_boxes"],
                      "stdout": res.stdout.strip()[-200:]}
    out["launches"] = read_launches(ops)
    assert not any(out["launches"].values()), out["launches"]
    return out


# ---------------------------------------------------------------------------
# phase 8: kernel timing at the main path's largest inputs
# ---------------------------------------------------------------------------

def intersect_bound(torch, args) -> tuple:
    """(bytes, comparisons) one intersect_count_csr call needs: each
    referenced row's values, its two offsets and the pair positions read
    once, the total written once; per pair of lengths lo <= hi,
    lo·log2(1 + hi/lo) comparisons, the least that any comparison-based
    intersection of two sorted sets needs (a merge, a binary search per
    probe or a gallop from hit to hit all need at least as many)."""
    off_a, vals_a, pos_a, off_b, vals_b, pos_b = args
    deg_a = off_a[pos_a + 1] - off_a[pos_a]
    deg_b = off_b[pos_b + 1] - off_b[pos_b]
    real = 0
    for off, pos in ((off_a, pos_a), (off_b, pos_b)):
        rows = torch.unique(pos)
        real += 4 * int((off[rows + 1] - off[rows]).sum()) + 16 * len(rows)
    lo = torch.minimum(deg_a, deg_b).double()
    hi = torch.maximum(deg_a, deg_b).double()
    steps = torch.where(lo > 0, torch.log2(1 + hi / lo.clamp(min=1)), 0)
    return real + 16 * len(pos_a) + 8, float((lo * steps).sum())


def intersect_bound_per_probe(torch, args) -> float:
    """The comparisons of a coarser bound for the same call, one full
    binary search per probe: min(deg)·ceil(log2(max deg + 1)). Printed
    beside the bound so that readings taken against it can be compared."""
    off_a, _, pos_a, off_b, _, pos_b = args
    deg_a = off_a[pos_a + 1] - off_a[pos_a]
    deg_b = off_b[pos_b + 1] - off_b[pos_b]
    lo, hi = torch.minimum(deg_a, deg_b), torch.maximum(deg_a, deg_b)
    steps = torch.ceil(torch.log2(hi.double() + 1))
    return float((lo.double() * steps).sum())


def time_intersect(torch, rec, rows_rec, launches: int, reps: int,
                   rmat_args=None) -> dict:
    """intersect_count_csr at the main path's largest call (by pairs), at
    its median call and at the rmat phase's largest call, against
    intersect_rows_ref and the bound; host synchronisations of one
    intersect_count_rows call at its largest."""
    from repro_torch.kernels.intersect.ref import intersect_rows_ref

    def measure(args):
        got = int(rec.orig(*args))
        want = int(intersect_rows_ref(*args).sum(dtype=torch.int64))
        return abs(got - want), cuda_ms(lambda: rec.orig(*args), reps)

    args = rec.largest
    err, ms = measure(args)
    plain_ms = cuda_ms(lambda: intersect_rows_ref(*args), max(1, reps // 10))
    (med_size, med_args, _), med_all = rec.median()
    med_err, med_ms = measure(med_args)
    syncs = None
    if rows_rec.largest is not None:
        _, syncs = count_syncs(torch,
                               lambda: rows_rec.orig(*rows_rec.largest))
    rmat = None
    if rmat_args is not None:
        rmat_err, rmat_ms = measure(rmat_args)
        err = max(err, rmat_err)
        rb, ro = intersect_bound(torch, rmat_args)
        ro_probe = intersect_bound_per_probe(torch, rmat_args)
        t_rb = rb / HBM_BYTES_PER_S * 1e3
        t_ro = ro / SCALAR_OPS_PER_S * 1e3
        rmat = {"pairs": int(len(rmat_args[2])), "ms": rmat_ms,
                "plain_ms": cuda_ms(lambda: intersect_rows_ref(*rmat_args),
                                    max(1, reps // 10)),
                "bound_ms": max(t_rb, t_ro),
                "bound_by": "bytes" if t_rb >= t_ro else "operations",
                "bytes_ms": t_rb, "ops_ms": t_ro,
                "per_probe_ops_ms": ro_probe / SCALAR_OPS_PER_S * 1e3,
                "bytes": rb, "ops": ro, "per_probe_ops": ro_probe,
                "max_abs_err": rmat_err}
    n_bytes, n_ops = intersect_bound(torch, args)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    off_a, vals_a, pos_a, off_b, vals_b, _ = args
    return {"name": "intersect", "route": "cuda",
            "source": "src/repro_torch/csrc/intersect.cu",
            "replaces": "src/repro/kernels/intersect/kernel.py:33",
            "launches": launches, "max_abs_err": max(err, med_err),
            "exact": err == 0 and med_err == 0, "ms": ms, "kernel_ms": ms,
            "median_ms": med_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "host_syncs_per_call": syncs,
            "shape": {"pairs": int(len(pos_a)),
                      "values": [int(len(vals_a)), int(len(vals_b))],
                      "keys": [int(len(off_a)) - 1, int(len(off_b)) - 1]},
            "median_call": {"pairs": med_size, "median_pairs": med_all,
                            "calls": len(rec.sizes)},
            "rmat_largest": rmat, "bytes": n_bytes, "ops": n_ops}


def graph_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of the kernels ``fn`` launches, without its
    host work: ``fn`` captured once into a CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def int_mm_masked(torch, a, b, m):
    """Σ m ⊙ (a · bᵀ) by ``torch._int_mm`` (int8 tensor cores, int32 out)
    and the masked sum, as a callable, with its inputs padded once to the
    shapes ``_int_mm`` takes (rows above 16, widths a multiple of 8; zero
    rows and columns add nothing); None where it refuses them."""
    def pad(n, k):
        return max(k, -(-n // k) * k)

    nx, d = a.shape
    ny = b.shape[0]
    px, py, pd = pad(nx, 32), pad(ny, 8), pad(d, 8)
    a8 = torch.zeros((px, pd), dtype=torch.int8, device=a.device)
    b8 = torch.zeros((py, pd), dtype=torch.int8, device=a.device)
    m32 = torch.zeros((px, py), dtype=torch.int32, device=a.device)
    a8[:nx, :d] = a
    b8[:ny, :d] = b
    m32[:nx, :ny] = m
    fn = lambda: (m32 * torch._int_mm(a8, b8.T)).sum(dtype=torch.int64)
    try:
        fn()
    except RuntimeError:
        return None
    return fn


def dense_bytes_bound(nx: int, ny: int, d: int) -> tuple:
    """(bytes, operations) of one triangle_count call: each operand byte
    read once, the partial written once; 2·nx·ny·d byte operations."""
    return nx * d + ny * d + nx * ny + 8, 2.0 * nx * ny * d


def time_dense(torch, rec, launches: dict, reps: int) -> dict:
    """The dense kernel at the main path's largest and median call, against
    its plain version, two exact library yardsticks (a float32 product with
    TF32 off, exact while a cell stays below 2^24; ``torch._int_mm`` and
    the masked sum) and its bound. ``ms`` times the wrapper call,
    ``kernel_ms`` the kernels it launches alone (a CUDA graph replay), and
    ``library_int_mm_kernel_ms`` the ``_int_mm`` yardstick's the same
    way."""
    from repro_torch.kernels.triangle_dense.ref import triangle_count_ref
    from repro_torch.models.layers import float32_accumulation
    a, b, m = rec.largest
    got = int(rec.orig(a, b, m))
    want = int(triangle_count_ref(a, b, m))
    ms = cuda_ms(lambda: rec.orig(a, b, m), reps)
    kernel_ms = graph_ms(torch, lambda: rec.orig(a, b, m), reps)
    plain_ms = cuda_ms(lambda: triangle_count_ref(a, b, m), reps)
    (med_size, (ma, mb, mm), _), med_all = rec.median()
    med_err = abs(int(rec.orig(ma, mb, mm)) - int(triangle_count_ref(ma, mb,
                                                                     mm)))
    med_ms = cuda_ms(lambda: rec.orig(ma, mb, mm), reps)
    med_kernel_ms = graph_ms(torch, lambda: rec.orig(ma, mb, mm), reps)
    af, bf, mf = a.float(), b.float(), m.float()
    with float32_accumulation():
        f32_ms = cuda_ms(lambda: (mf * (af @ bf.T)).sum(), reps)
    int_mm = int_mm_masked(torch, a, b, m)
    int_mm_ms = int_mm_kernel_ms = None
    if int_mm is not None:
        assert int(int_mm()) == want, (int(int_mm()), want)
        int_mm_ms = cuda_ms(int_mm, reps)
        int_mm_kernel_ms = graph_ms(torch, int_mm, reps)
    nx, d = a.shape
    ny = b.shape[0]
    n_bytes, n_ops = dense_bytes_bound(nx, ny, d)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    mb_bytes, mb_ops = dense_bytes_bound(ma.shape[0], mb.shape[0],
                                         ma.shape[1])
    return {"name": "triangle_dense", "route": "cuda",
            "source": "src/repro_torch/csrc/triangle_dense.cu",
            "replaces": "src/repro/kernels/triangle_dense/kernel.py:29",
            "launches": sum(launches.values()),
            "launches_by_phase": launches,
            "max_abs_err": max(abs(got - want), med_err),
            "exact": got == want and med_err == 0, "ms": ms,
            "kernel_ms": kernel_ms, "median_ms": med_ms,
            "median_kernel_ms": med_kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": min(t for t in (f32_ms, int_mm_ms)
                              if t is not None),
            "library_f32_ms": f32_ms, "library_int_mm_ms": int_mm_ms,
            "library_int_mm_kernel_ms": int_mm_kernel_ms,
            "shape": {"a": list(a.shape), "b": list(b.shape)},
            "median_call": {"a": list(ma.shape), "b": list(mb.shape),
                            "bound_ms": max(mb_bytes / HBM_BYTES_PER_S,
                                            mb_ops / INT8_OPS_PER_S) * 1e3,
                            "size": med_size, "median_size": med_all,
                            "calls": len(rec.sizes)},
            "bytes": n_bytes, "ops": n_ops}


def fused_csr_words(dims, csrs, n_vars) -> int:
    return sum(int(k.numel()) + int(v.numel()) for k, _, v in csrs)


def fused_shape(dims, csrs, n_vars) -> tuple:
    return tuple((int(k.numel()), int(v.numel())) for k, _, v in csrs)


def fused_padded_fits(dims, csrs, n_vars) -> bool:
    """The plain version's padded (R, K) atoms hold at most
    FUSED_PLAIN_WORDS_CAP words."""
    words = 0
    for k, o, _ in csrs:
        deg = o[1:] - o[:-1]
        words += int(k.numel()) * max(1, int(deg.max()) if deg.numel()
                                      else 1)
    return words <= FUSED_PLAIN_WORDS_CAP


def fused_bound(torch, prep) -> tuple:
    """(bytes, comparisons, per-probe comparisons) the triangle box join
    needs: each touched CSR row's real entries once plus the frontier and
    the output; per in-box edge (x, y) with bound rows of lengths lo <= hi,
    lo·log2(1 + hi/lo) comparisons, the least any comparison-based
    intersection needs (the same count as the intersect bound). The
    coarser min(deg)·⌈log2(max deg + 1)⌉ of one binary search a probe is
    printed beside it."""
    dims, csrs, c0, _ = prep
    assert dims == TRIANGLE, dims
    (kr, orr, vr), (ks, os_, vs), (kt, ot, vt) = csrs

    def degree_of(keys, off, v):
        pos = torch.searchsorted(keys, v).clamp_(max=max(0, keys.numel() - 1))
        hit = keys[pos] == v
        return torch.where(hit, off[pos + 1] - off[pos],
                           torch.zeros_like(off[pos]))

    x = torch.repeat_interleave(kr, orr[1:] - orr[:-1])
    du, dv = degree_of(ks, os_, x), degree_of(kt, ot, vr)
    lo = torch.minimum(du, dv).double()
    hi = torch.maximum(du, dv).double()
    n_ops = float((lo * torch.where(lo > 0, torch.log2(1 + hi / lo.clamp(
        min=1)), 0)).sum())
    per_probe = float((lo * torch.ceil(torch.log2(hi + 1))).sum())
    touched = int(vr.numel()) + int(degree_of(ks, os_, c0).sum()) \
        + int(degree_of(kt, ot, torch.unique(vr)).sum())
    return 4 * touched + 4 * int(c0.numel()) + 8, n_ops, per_probe


def fused_call_bytes(prep) -> int:
    """Bytes a fused_count call must move at least: its atoms' compact CSR
    and the depth-0 and constant rows read once, the count written."""
    dims, csrs, c0, consts = prep
    return sum(4 * k.numel() + 8 * o.numel() + 4 * v.numel()
               for k, o, v in csrs) + 4 * c0.numel() \
        + sum(4 * c.numel() for c in consts) + 8


def time_fused(torch, rec, launches: dict, reps: int) -> dict:
    """The count kernel at the main path's largest triangle box and at its
    median call (a QueryEngine box), against its plain version and its
    bound; host synchronisations of a whole fused_count call."""
    from repro_torch.kernels.lftj_fused import ops as fused_ops
    from repro_torch.kernels.lftj_fused.ref import fused_count_ref

    def run(args):
        dims, csrs, n = args
        prep = fused_ops._prepare(dims, csrs, n)
        got = int(fused_ops.launch_count(prep))
        ms = cuda_ms(lambda: fused_ops.launch_count(prep), reps)
        return prep, got, ms

    def plain(args):
        layout = fused_ops.padded_layout(*args)
        return int(fused_count_ref(args[0], *layout, args[2]).sum())

    prep, got, ms = run(rec.largest)
    plain_args = rec.largest if rec.largest_fitting is rec.largest \
        else rec.largest_fitting
    pdims, pcsrs, pn = plain_args
    layout = fused_ops.padded_layout(pdims, pcsrs, pn)
    want = int(fused_count_ref(pdims, *layout, pn).sum())
    plain_ms = cuda_ms(lambda: fused_count_ref(pdims, *layout, pn),
                       max(1, reps // 10))
    out = {}
    if plain_args is rec.largest:
        err = abs(got - want)
    else:
        # the plain version does not fit at the largest input: both are
        # compared and the plain one timed at the largest input that fits
        _, got_fit, ms_fit = run(plain_args)
        err = abs(got_fit - want)
        out["plain_at"] = {"shape": fused_shape(*plain_args),
                           "kernel_ms": ms_fit,
                           "padded_words_cap": FUSED_PLAIN_WORDS_CAP}
    (med_size, med_args, _), med_all = rec.median()
    mprep, med_got, med_ms = run(med_args)
    err = max(err, abs(med_got - plain(med_args)))
    # a whole fused_count call, twice: the process's first sync-debug
    # window may hold a one-time synchronisation of PyTorch's own
    syncs = [count_syncs(torch, lambda: rec.orig(*a))[1]
             for a in (rec.largest, rec.largest, med_args)]
    n_bytes, n_ops, per_probe = fused_bound(torch, prep)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    med_bytes = fused_call_bytes(mprep)
    out.update({
        "name": "lftj_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/lftj_fused.cu",
        "replaces": "src/repro/kernels/lftj_fused/kernel.py:110",
        "launches": sum(launches.values()), "launches_by_phase": launches,
        "max_abs_err": err, "exact": err == 0,
        "ms": ms, "kernel_ms": ms, "median_ms": med_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "count": got,
        "host_syncs_per_call": syncs[1],
        "host_syncs_first_call": syncs[0],
        "host_syncs_median_call": syncs[2],
        "shape": {"atoms_keys_vals": fused_shape(*rec.largest),
                  "frontier": int(prep[2].numel())},
        "median_call": {"dims": [list(x) for x in med_args[0]],
                        "atoms_keys_vals": fused_shape(*med_args),
                        "words": med_size, "median_words": med_all,
                        "calls": len(rec.sizes), "bytes": med_bytes,
                        "bound_ms": med_bytes / HBM_BYTES_PER_S * 1e3,
                        "bound_by": "bytes"},
        "bytes": n_bytes, "ops": n_ops, "per_probe_ops": per_probe,
        "per_probe_ops_ms": per_probe / SCALAR_OPS_PER_S * 1e3})
    return out


def time_fused_list(torch, rec, launches: int, reps: int) -> dict:
    """The listing kernel at the main path's largest ``fused_list`` call
    (by emitted rows), against its plain version on the same input and
    against its bound: the atoms' CSR bytes read once and the int32 rows
    written once; at least one membership probe per emitted binding and
    further atom bound at the innermost depth."""
    from repro_torch.kernels.lftj_fused import ops as fused_ops
    from repro_torch.kernels.lftj_fused.ref import fused_list_ref
    dims, csrs, n = rec.largest
    cap = rec.largest_kw["capacity"]
    prep = fused_ops._prepare(dims, csrs, n)
    fused_ops.launch_list(prep, cap)    # the workspace grows, if at all
    (total, rows), syncs = count_syncs(
        torch, lambda: fused_ops.launch_list(prep, cap))
    ms = cuda_ms(lambda: fused_ops.launch_list(prep, cap), reps)
    (med_rows, (mdims, mcsrs, mn), mkw), med_all = rec.median()
    mprep = fused_ops._prepare(mdims, mcsrs, mn)
    med_ms = cuda_ms(lambda: fused_ops.launch_list(mprep, mkw["capacity"]),
                     reps)
    layout = fused_ops.padded_layout(dims, csrs, n)
    plain_total, plain = fused_list_ref(dims, *layout, n, cap)
    plain_ms = cuda_ms(lambda: fused_list_ref(dims, *layout, n, cap),
                       max(1, reps // 10))
    exact = total == plain_total and torch.equal(rows.long(), plain)
    in_bytes = sum(4 * k.numel() + 8 * o.numel() + 4 * v.numel()
                   for k, o, v in csrs)
    n_bytes = in_bytes + 4 * rows.numel() + 8
    last = n - 1
    probes = max(1, sum(1 for _, sd in dims if sd == last) - 1)
    n_ops = float(total * probes)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return {"name": "lftj_fused_list", "route": "cuda",
            "source": "src/repro_torch/csrc/lftj_fused.cu",
            "replaces": "src/repro/kernels/lftj_fused/kernel.py:264",
            "launches": launches, "max_abs_err": 0 if exact else None,
            "exact": exact, "ms": ms, "kernel_ms": ms, "median_ms": med_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "host_syncs_per_call": syncs,
            "median_call": {"rows": med_rows, "median_rows": med_all,
                            "calls": len(rec.sizes)},
            "total": total, "capacity": cap,
            "shape": {"atoms_keys_vals": fused_shape(dims, csrs, n),
                      "frontier": int(prep[2].numel()),
                      "rows": list(rows.shape)},
            "bytes": n_bytes, "ops": n_ops}


def bag_kernel_rows(timing: dict, by_phase: dict) -> list:
    """The embedding_bag kernels' float32 lines: "dma" (the row gather, on
    the largest field) and "onehot" (the column-sliced kernel, on the
    eighteenth field), each at L = 8 with both L under ``by_L``; the
    seventh field's "onehot" calls (the row gather) under ``by_field``;
    the launches are the embedding_bag phase's (``by_phase``: by counter,
    by phase)."""
    rows = []
    for mode, line, field in (("dma", 35, "largest"),
                              ("onehot", 83, "eighteenth")):
        top = timing[field][f"L{max(BAG_LS)}"]
        fields = {f: t for f, t in timing.items()
                  if t[f"L{max(BAG_LS)}"]["mode"] == mode}
        runs = [t for f in fields.values() for t in f.values()]
        row = {"name": f"embedding_bag_{mode}", "route": "cuda",
               "source": "src/repro_torch/csrc/embedding_bag.cu",
               "replaces": f"src/repro/kernels/embedding_bag/kernel.py:"
                           f"{line}",
               "launches": by_phase[f"embedding_bag_{mode}"].get(
                   "embedding_bag", 0),
               "max_abs_err": max(t["max_abs_err"] for t in runs),
               "ms": top["ms"], "kernel_ms": top["kernel_ms"],
               "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
               "bound_by": top["bound_by"], "library_ms": top["library_ms"],
               "host_syncs_per_call": max(t["syncs_per_call"] for t in runs),
               "field": field, "by_L": timing[field], "by_field": fields}
        if mode == "onehot":
            row["launches_by_variant"] = {
                k: by_phase[f"embedding_bag_onehot_{k}"].get(
                    "embedding_bag", 0) for k in ("slices", "rows")}
        row["exact"] = row["max_abs_err"] <= BAG_ATOL
        rows.append(row)
    return rows


def bag_bf16_kernel_rows(timing: dict, by_phase: dict) -> list:
    """The embedding_bag kernels' bfloat16 lines, from the dlrm phase's
    tables at L = 1 (``timing``): "dma" (the row gather) on the largest
    field, "onehot" on the eighteenth (the variant its route takes), each
    with the dlrm phase's launches of its mode. The library time is
    ``F.embedding_bag`` on the same bfloat16 table, whose output is
    bfloat16 (the kernels' is float32)."""
    rows = []
    for mode, line, field in (("dma", 35, "largest"),
                              ("onehot", 83, "eighteenth")):
        top = timing[field]["L1"]
        assert top["mode"] == mode, (field, top["mode"])
        row = {"name": f"embedding_bag_{mode}_bf16", "route": "cuda",
               "source": "src/repro_torch/csrc/embedding_bag.cu",
               "replaces": f"src/repro/kernels/embedding_bag/kernel.py:"
                           f"{line}",
               "launches": by_phase[f"embedding_bag_{mode}"].get("dlrm", 0),
               "max_abs_err": top["max_abs_err"], "ms": top["ms"],
               "kernel_ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
               "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
               "library_ms": top["library_ms"],
               "library_dtype": top["library_dtype"],
               "host_syncs_per_call": top["syncs_per_call"],
               "field": field, "table": top["table"], "variant":
               top["variant"], "slice_w": top["slice_w"],
               "shape": top["shape"], "bytes": top["bytes"],
               "launches_by_phase": {
                   k: by_phase[k] for k in by_phase
                   if k.startswith(f"embedding_bag_{mode}")}}
        row["exact"] = row["max_abs_err"] <= BAG_ATOL
        rows.append(row)
    return rows


PHASES = ("dryrun", "dlrm", "train", "gnn", "lm", "lm_train", "launch",
          "grid", "grid_train", "rmat",
          "clustered", "listing",
          "skew", "fused", "query", "outofcore", "query_listing", "api", "shard", "serve",
          "embedding_bag")
# the phases whose graphs and results a phase reuses
NEEDS = {"skew": ("rmat",), "fused": ("clustered", "listing"),
         "query": ("listing",), "outofcore": ("rmat", "listing", "query"),
         "api": ("rmat", "clustered", "listing", "query", "outofcore"),
         "shard": ("rmat", "listing", "query", "query_listing"),
         "serve": ("listing", "query", "outofcore", "query_listing")}


def with_needs(names) -> list:
    """The phases ``names`` and every phase they reuse, in PHASES order."""
    want, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in PHASES:
            raise SystemExit(f"chip_smoke: unknown phase {name!r}")
        if name not in want:
            want.add(name)
            todo.extend(NEEDS.get(name, ()))
    return [p for p in PHASES if p in want]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel checks only")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="main-path phases to run (default: all "
                         "twenty-one), "
                         "with the phases they reuse (NEEDS)")
    ap.add_argument("--profile", action="store_true",
                    help="repeat each main-path count under "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import grad as grad_ops
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.intersect import ops as intersect_ops
    from repro_torch.kernels.lftj_fused import ops as fused_ops
    from repro_torch.kernels.triangle_dense import ops as dense_ops
    # every kernel's launch counter (embedding_bag keeps one per mode, and
    # one per "onehot" variant)
    ops = {"intersect": intersect_ops.LAUNCHES,
           "triangle_dense": dense_ops.LAUNCHES,
           "lftj_fused": fused_ops.LAUNCHES,
           "lftj_fused_list": fused_ops.LIST_LAUNCHES,
           "embedding_bag_dma": bag_ops.LAUNCHES["dma"],
           "embedding_bag_onehot": bag_ops.LAUNCHES["onehot"],
           "embedding_bag_onehot_slices": bag_ops.ONEHOT_LAUNCHES["slices"],
           "embedding_bag_onehot_rows": bag_ops.ONEHOT_LAUNCHES["rows"],
           "embedding_bag_backward": grad_ops.BACKWARD_LAUNCHES}

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(log)
             for name, log in _build.BUILD_LOG.items()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_flags": list(_build.NVCC_FLAGS),
          "ptxas": ptxas,
          "count_kernels": {k: v for k, v in ptxas.get("lftj_fused", {})
                            .items() if k.startswith("count_kernel")}})
    children = start_bag_negative_children()
    try:
        t0 = time.perf_counter()
        emit(phase_kernel_cases(torch, np, intersect_ops, dense_ops))
        emit(dict(phase_fused_cases(torch, np, fused_ops),
                  phase_s=time.perf_counter() - t0))
        t0 = time.perf_counter()
        list_cases = dict(phase_list_cases(torch, np, fused_ops),
                          phase_s=time.perf_counter() - t0)
        emit(list_cases)
        t0 = time.perf_counter()
        emit(dict(phase_stream_cases(torch, np, fused_ops),
                  phase_s=time.perf_counter() - t0))
        t0 = time.perf_counter()
        emit(dict(phase_bag_cases(torch, np, bag_ops, children),
                  phase_s=time.perf_counter() - t0))
        t0 = time.perf_counter()
        emit(dict(phase_bag_backward_cases(torch, np, grad_ops),
                  phase_s=time.perf_counter() - t0))
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    kernels = []
    if not args.quick:
        # every intersect launch of the main path goes through
        # intersect_count_csr (the triangle lane and intersect_count_rows);
        # the largest call is the one with the most pairs
        rec_i = Recorder(intersect_ops, "intersect_count_csr",
                         lambda *args: args[2].numel())
        rec_r = Recorder(intersect_ops, "intersect_count_rows",
                         lambda *args: args[2].numel())
        rec_d = Recorder(dense_ops, "triangle_count",
                         lambda a, b, m: a.shape[0] * b.shape[0]
                         * a.shape[1])
        # the fused kernel is timed at its largest triangle box, the input
        # its bound is written for (fused_bound), and at its median call,
        # a QueryEngine box (the query phase makes most of the calls and
        # the last ones)
        rec_f = Recorder(fused_ops, "fused_count", fused_csr_words,
                         shape=fused_shape, fits=fused_padded_fits,
                         rank=lambda dims, csrs, n:
                         fused_csr_words(dims, csrs, n)
                         if tuple(dims) == TRIANGLE else -1, keep_last=True)
        rec_l = ListRecorder(fused_ops, "fused_list", None,
                             shape=fused_shape)
        shared = {}
        phases = {
            "rmat": lambda: phase_rmat(
                torch, np, ops, shared, RMAT_MEM_WORDS, args.profile),
            "clustered": lambda: phase_clustered(
                torch, np, ops, shared, CLUSTERS, CLUSTER_SIZE, P_IN,
                CLUSTERED_MEM_WORDS, args.profile),
            "listing": lambda: phase_listing(
                torch, np, ops, shared, LIST_SCALE, LIST_MEM_WORDS),
            "skew": lambda: phase_skew(
                torch, np, ops, shared, RMAT_MEM_WORDS, SKEW_WORKERS,
                args.profile),
            "fused": lambda: phase_fused(torch, np, ops, shared,
                                         args.profile),
            "query": lambda: phase_query(torch, np, ops, shared,
                                         QUERY_SCALE, QUERY_MEM_WORDS),
            "outofcore": lambda: phase_outofcore(torch, np, ops, shared),
            "query_listing": lambda: phase_query_listing(
                torch, np, ops, shared, QUERY_LIST_SCALE,
                QUERY_LIST_MEM_WORDS),
            "api": lambda: phase_api(torch, np, ops, shared,
                                     [rec_i, rec_r, rec_d, rec_f, rec_l]),
            "shard": lambda: phase_shard(torch, np, ops, shared,
                                         [rec_i, rec_r, rec_d, rec_f,
                                          rec_l]),
            "serve": lambda: phase_serve(torch, np, ops, shared,
                                         [rec_i, rec_r, rec_d, rec_f,
                                          rec_l]),
            "embedding_bag": lambda: phase_embedding_bag(
                torch, np, ops, shared, bag_ops),
            "dryrun": lambda: phase_dryrun(torch, ops, shared),
            "dlrm": lambda: phase_dlrm(torch, np, ops, shared, bag_ops),
            "train": lambda: phase_train(torch, np, ops, shared, grad_ops),
            "gnn": lambda: phase_gnn(torch, np, ops, shared, grad_ops),
            "lm": lambda: phase_lm(torch, np, ops, shared),
            "lm_train": lambda: phase_lm_train(torch, np, ops, shared,
                                               grad_ops),
            "launch": lambda: phase_launch(torch, np, ops, shared, bag_ops),
            "grid": lambda: phase_grid(torch, np, ops, shared, bag_ops),
            "grid_train": lambda: phase_grid_train(torch, np, ops, shared,
                                                   grad_ops),
        }
        runs = []
        names = with_needs(args.phases.split(","))
        shared["host_children"] = HostChildren(names)
        try:
            for name in names:
                if PHASES.index(name) >= PHASES.index(HOST_CHILDREN_START):
                    shared["host_children"].start()
                t0 = time.perf_counter()
                runs.append(phases[name]())
                runs[-1]["phase_s"] = time.perf_counter() - t0
                emit(runs[-1])
                if name == "rmat":
                    # the rmat phase's largest intersect call: a
                    # triangle-lane box, timed beside the main path's
                    # largest call
                    shared["rmat_intersect"] = rec_i.largest
        finally:
            shared["host_children"].close()
        launches = {k: sum(r["launches"][k] for r in runs) for k in ops}
        by_phase = {k: {r["phase"]: r["launches"][k] for r in runs
                        if r["launches"][k]} for k in ops}
        emit({"phase": "launch_shapes", "intersect": rec_i.summary(),
              "intersect_count_rows": rec_r.summary(),
              "triangle_dense": rec_d.summary(),
              "lftj_fused": rec_f.summary(),
              "lftj_fused_list": rec_l.summary()})
        if rec_i.largest is not None:
            kernels.append(time_intersect(torch, rec_i, rec_r,
                                          launches["intersect"], TIMING_REPS,
                                          shared.get("rmat_intersect")))
        if rec_d.largest is not None:
            kernels.append(time_dense(torch, rec_d, by_phase["triangle_dense"],
                                      TIMING_REPS))
        if rec_f.largest is not None:
            kernels.append(time_fused(torch, rec_f, by_phase["lftj_fused"],
                                      TIMING_REPS))
        if rec_l.largest is not None:
            kernels.append(time_fused_list(torch, rec_l,
                                           launches["lftj_fused_list"],
                                           TIMING_REPS))
        if "bag_timing" in shared:
            kernels.extend(bag_kernel_rows(shared["bag_timing"], by_phase))
        if "bag_timing_bf16" in shared:
            kernels.extend(bag_bf16_kernel_rows(shared["bag_timing_bf16"],
                                                by_phase))
        if any(k in shared for k in ("bag_backward_timing",
                                     "gnn_segment_timing",
                                     "lm_embed_timing",
                                     "grid_train_embed_timing")):
            kernels.append(bag_backward_kernel_row(
                shared.get("bag_backward_timing"),
                shared.get("gnn_segment_timing"),
                shared.get("lm_embed_timing"), by_phase,
                shared.get("grid_train_embed_timing")))
        for k in kernels:
            assert k["exact"], k
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start,
          "sync_sites": dict(SYNC_SITES)})
    emit({"kernels": kernels})
    # host synchronisations: one per intersect_count_rows and launch_list
    # call, two when the listing workspace regrows; two per fused_count
    # call (the envelope and the total)
    assert list_cases["regrowth_max_syncs"] <= 2, list_cases
    # none per embedding_bag call
    for k in kernels:
        limit = {"lftj_fused": 2, "embedding_bag_dma": 0,
                 "embedding_bag_onehot": 0, "embedding_bag_dma_bf16": 0,
                 "embedding_bag_onehot_bf16": 0,
                 "embedding_bag_backward": 0}.get(k["name"], 1)
        assert k.get("host_syncs_per_call") in (None, *range(limit + 1)), k
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
