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
                  a child process per kernel must fail).
  3. rmat       — Graph500-style RMAT, ``backend="auto"`` [intersect]; the
                  count must equal the plain torch ``binary`` lane.
  4. clustered  — triangle-rich planted-partition graph [triangle_dense];
                  the int64 count (> 2^31) must equal a per-cluster
                  float64 oracle.
  5. listing    — ``list()`` on the card equals ``list()`` on the CPU byte
                  for byte, with forced rescans; counts equal the host lane
                  and a scipy-sparse oracle [intersect, triangle_dense].
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
                  [lftj_fused_list]: bytes equal the CPU's and a forced-
                  rescan run's; total equal to the host backend and the
                  scipy oracle.
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
import hashlib
import json
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
    ``torch.profiler``; ``idle_share`` is the share of the wall time in
    which no kernel or copy ran."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.count()
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
    return {"phase": "profile", "of": label, "wall_ms": wall_ms,
            "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
            "top": [{"name": k[:80], "calls": c, "ms": ms}
                    for ms, k, c in rows[:top]]}


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
    """{function: registers, stack bytes, spill stores and loads} of every
    function ptxas reports in an ``nvcc -Xptxas=-v`` log."""
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
    w = bag_ops.onehot_route(v, d, table.data_ptr() % 16 == 0)
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
    torch.cuda.synchronize()
    negative = bag_negative_results(children)
    return {"phase": "kernels", "of": ["embedding_bag"],
            "cases": n_cases, "onehot_variants": dict(variants),
            "atol": BAG_ATOL, "max_abs_err": worst,
            "onehot_equals_dma": True, "negative_index": negative}


# ---------------------------------------------------------------------------
# phases 3-7: the main path through TriangleEngine
# ---------------------------------------------------------------------------

def phase_rmat(torch, np, ops, shared, scale: int, mem_words: int,
               profile: bool) -> dict:
    from repro_torch.core.engine import TriangleEngine
    from repro_torch.data.graphs import rmat_graph
    t0 = time.perf_counter()
    src, dst = rmat_graph(1 << scale, 16 << scale, seed=0)
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
    return {"phase": "rmat", "scale": scale, "edges": int(len(src)),
            "mem_words": mem_words, "boxes": stats.n_boxes,
            "lanes": lane_stats(stats), "count": count,
            "count_binary_lane": want, "launches": launches,
            "device_invocations": stats.device_invocations,
            "padded_words": stats.padded_words,
            "actual_words": stats.actual_words, "gen_s": t_gen,
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
    t0 = time.perf_counter()
    cpu = TriangleEngine(src, dst, mem_words=mem_words, torch_device="cpu")
    tris_cpu = cpu.list()
    t_cpu = time.perf_counter() - t0
    assert tris.dtype == tris_cpu.dtype and tris.shape == tris_cpu.shape
    assert tris.tobytes() == tris_cpu.tobytes()
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
            "count_s": t_count, "list_s": t_list, "cpu_list_s": t_cpu,
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
    t0 = time.perf_counter()
    cpu = engine(backend="fused", torch_device="cpu").list()
    t_cpu = time.perf_counter() - t0
    assert cpu.dtype == rows.dtype and cpu.shape == rows.shape
    assert cpu.tobytes() == rows.tobytes()
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
            "list_s": t_list, "cpu_list_s": t_cpu,
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
    mode = bag_ops.resolve_mode(table, "auto")
    w = bag_ops.onehot_route(v, d) if mode == "onehot" else 0
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
    weights = live.float()
    lib_ms = cuda_ms(lambda: F.embedding_bag(
        safe, table, mode="sum", per_sample_weights=weights), reps)
    lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=weights)
    lib_err = float((got - lib).abs().max())
    lookups = int(live.sum())
    rows = int(torch.unique(idx[live]).numel())
    n_bytes = 4 * rows * d + idx.element_size() * idx.numel() \
        + 4 * got.numel()
    n_ops = float(lookups * d)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return {"mode": mode, "variant": ("slices" if w else "rows"),
            "slice_w": w, "ms": ms, "calls_ms": calls_ms,
            "kernel_ms": kernel_ms,
            "syncs_per_call": syncs, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": {"table": [v, d], "idx": list(idx.shape),
                      "idx_dtype": str(idx.dtype)},
            "bytes": n_bytes, "ops": n_ops, "lookups": lookups,
            "row_gather_l2_bytes": 4 * lookups * d}


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
    torch.backends.cuda.matmul.allow_tf32 = False
    af, bf, mf = a.float(), b.float(), m.float()
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


def bag_kernel_rows(timing: dict, launches: dict) -> list:
    """The embedding_bag kernels' lines: "dma" (the row gather, on the
    largest field) and "onehot" (the column-sliced kernel, on the
    eighteenth field), each at L = 8 with both L under ``by_L``; the
    seventh field's "onehot" calls (the row gather) under ``by_field``."""
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
               "launches": launches[f"embedding_bag_{mode}"],
               "max_abs_err": max(t["max_abs_err"] for t in runs),
               "ms": top["ms"], "kernel_ms": top["kernel_ms"],
               "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
               "bound_by": top["bound_by"], "library_ms": top["library_ms"],
               "host_syncs_per_call": max(t["syncs_per_call"] for t in runs),
               "field": field, "by_L": timing[field], "by_field": fields}
        if mode == "onehot":
            row["launches_by_variant"] = {
                k: launches[f"embedding_bag_onehot_{k}"]
                for k in ("slices", "rows")}
        row["exact"] = row["max_abs_err"] <= BAG_ATOL
        rows.append(row)
    return rows


PHASES = ("rmat", "clustered", "listing", "skew", "fused", "query",
          "outofcore", "query_listing", "api", "shard", "serve",
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
                    help="main-path phases to run (default: all twelve), "
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
           "embedding_bag_onehot_rows": bag_ops.ONEHOT_LAUNCHES["rows"]}

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
                torch, np, ops, shared, RMAT_SCALE, RMAT_MEM_WORDS,
                args.profile),
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
        }
        runs = []
        for name in with_needs(args.phases.split(",")):
            t0 = time.perf_counter()
            runs.append(phases[name]())
            runs[-1]["phase_s"] = time.perf_counter() - t0
            emit(runs[-1])
            if name == "rmat":
                # the rmat phase's largest intersect call: a triangle-lane
                # box, timed beside the main path's largest call
                shared["rmat_intersect"] = rec_i.largest
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
            kernels.extend(bag_kernel_rows(shared["bag_timing"], launches))
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
                 "embedding_bag_onehot": 0}.get(k["name"], 1)
        assert k.get("host_syncs_per_call") in (None, *range(limit + 1)), k
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
