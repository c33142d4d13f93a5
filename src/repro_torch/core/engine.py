"""TriangleEngine: planner + facade over the streaming box executor.

The engine is split into two layers:

  * **planner** (this module) — orientation/CSR preparation, the box plan
    (``core.boxing.plan_boxes`` over a ``TrieArray`` of the oriented
    edges in memory, ``plan_boxes_from_degrees`` from the resident degree
    index when the graph lives in a ``data.edgestore.EdgeStore``, or
    ``plan_boxes_heavy_light`` under ``skew="heavy_light"``) and per-box
    lane dispatch by edge density or by the box's hub/light class.
  * **streaming executor** (``core.executor.StreamingExecutor``) — pulls
    boxes from a work queue and materializes, per box, a vertex-renumbered
    *compacted* neighbor slice, overlapping host-side slice construction
    with device compute via ``data.pipeline.Prefetcher``. With a
    ``core.iomodel.BlockDevice`` attached, source reads are charged to it
    and ``EngineStats`` carries the measured block I/Os.

Sharded (``shard=True``, or ``devices=`` with more than one device), the
binary boxes' edges are LPT-scheduled onto shards, each holding only the
rows its edges reference, as compact CSR on its device
(``parallel.sharding``); the partials are summed as int64.

Out of core (``store=``), only the (V+1)-word degree index is resident and
every box's slice is read from the store, charged to a ``BlockDevice``.
With ``cache_words > 0`` the source is wrapped in an LRU
``core.executor.SliceCache``, so row blocks that adjacent boxes re-read
are served from host memory. ``TriangleEngine.ingest`` builds the store
itself with bounded memory (``data.edgestore.EdgeStoreWriter``).

The lanes run on ``torch_device``, which is the CUDA card unless the
caller asks for the CPU: there the dense, intersect and fused lanes launch
the hand-written CUDA kernels of ``kernels/``. Counts are int64 end to
end. The three density thresholds take ``'measured'``: a calibration
timed on the engine's device and kept per device in the port's own
crossover cache (``$REPRO_TORCH_CACHE_DIR/crossover.json``, default
``~/.cache/repro_torch``). ``tracer=`` / ``metrics=`` take an
``obs.trace.Tracer`` and an ``obs.metrics.MetricsRegistry``.

Usage::

    eng = TriangleEngine(src, dst, mem_words=1 << 16)        # on the card
    eng = TriangleEngine(src, dst, torch_device="cpu")       # on the CPU
    eng = TriangleEngine(src, dst, mem_words=1 << 16,        # 4 shards on
                         devices=["cuda:0"] * 4)             # one card
    eng = TriangleEngine.ingest("graph.csr", (src, dst),     # out of core
                                mem_words=1 << 16, cache_words=1 << 14,
                                degree_bins=True)
    n   = eng.count()
    tri = eng.list()          # (n, 3) canonical (min, mid, max) rows
    eng.stats                 # boxes, lanes, padding, launches, block I/Os
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.edgestore import (EdgeStore, EdgeStoreWriter,
                                        InMemoryEdgeSource)
from repro_torch.data.pipeline import Prefetcher, edge_batches
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.lftj_fused import ops as fused_ops
from repro_torch.kernels.triangle_dense import ops as dense_ops
from repro_torch.parallel.sharding import (ShardSlice, balanced_box_schedule,
                                           box_mass_costs, box_mesh,
                                           iter_shard_local_csr,
                                           local_slice_shape)

from .executor import SliceCache, StreamingExecutor, _pow2
from .iomodel import BlockDevice
from .lftj_torch import (_count_chunked, _count_rows_chunked,
                         _list_csr_chunked, _list_pairs_chunked,
                         csr_from_edges, orient_edges, pad_neighbors,
                         pad_neighbors_binned)

BACKENDS = ("auto", "binary", "dense", "intersect", "host", "fused")

# dense-path feasibility guard: one-hot words per box (slice-scaled estimate)
_DENSE_WORDS_CAP = 64_000_000


@dataclass
class EngineStats:
    """What one ``count()`` / ``list()`` call actually executed.

    The engine resets this on every ``count()`` / ``list()`` entry and
    fills it as the run proceeds, so after a call it is a faithful record
    of *that* run: the box plan size, the lane mix the density dispatch
    chose, streaming working-set peaks, kernel launches, and the block
    I/Os measured on an attached ``iomodel.BlockDevice``. All counters are
    plain ints/lists — cheap to snapshot or serialize.
    """

    n_boxes: int = 0
    n_dense_boxes: int = 0
    n_binary_boxes: int = 0
    n_intersect_boxes: int = 0
    n_host_boxes: int = 0
    n_fused_boxes: int = 0             # whole box on the fused lane
    # per-box device ledger (kernels/ledger): launches + transfer bytes of
    # the kernel lanes that note them (intersect)
    device_invocations: int = 0
    device_transfer_bytes: int = 0
    max_box_device_invocations: int = 0
    n_shards: int = 1
    n_rescans: int = 0
    dense_threshold: float = 0.0
    shard_edges: List[int] = field(default_factory=list)
    # skew-aware planning: the plan's lane mix plus the padded-vs-actual
    # word ledger
    skew: str = "uniform"
    heavy_threshold: int = 0           # hub degree cut the plan used
    n_hub_boxes: int = 0               # both ranges heavy
    n_light_boxes: int = 0             # both ranges light
    n_mixed_boxes: int = 0             # one heavy side
    padded_words: int = 0              # materialized padded-matrix words
    actual_words: int = 0              # real neighbor entries processed
    # async box scheduler (workers > 1): queue-wait/overlap/utilization
    # telemetry plus the observed in-flight peaks (the budget the window
    # promises to respect)
    n_workers: int = 1
    inflight_boxes: int = 0            # configured window (0 = serial run)
    queue_wait_s: float = 0.0          # worker-seconds spent waiting
    build_s: float = 0.0               # worker-seconds building slices
    compute_s: float = 0.0             # worker-seconds in lanes
    overlap_s: float = 0.0             # busy-seconds hidden by overlap
    # busy / (workers * wall); None when the run finished too fast to
    # measure (wall == 0 at perf_counter granularity — never a 0/0)
    worker_utilization: Optional[float] = None
    max_inflight_boxes: int = 0        # peak resident materialized slices
    max_inflight_words: int = 0        # peak resident raw slice words
    # streaming executor accounting
    n_streamed_boxes: int = 0
    slice_words_read: int = 0          # raw CSR words read across all boxes
    max_slice_words: int = 0           # largest single-box read (working set)
    max_slice_padded_words: int = 0    # largest box-local padded matrix
    # measured block I/O on the attached BlockDevice
    block_reads: int = 0
    block_writes: int = 0
    word_reads: int = 0
    # LRU slice cache (cache_words > 0): hits skip the device entirely,
    # so they show up as missing block_reads relative to a cache-off run
    cache_hits: int = 0
    cache_misses: int = 0
    cache_hit_words: int = 0
    # sharded-path shapes: the reference's padded (n_shards, R, K) slice
    # layout and each shard's referenced rows, from host metadata (the
    # port's shards hold compact CSR, never that padded slice)
    local_npad_shape: Optional[Tuple[int, int, int]] = None
    shard_rows: List[int] = field(default_factory=list)
    source: str = "memory"

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def padding_ratio(self) -> float:
        """Materialized padded words per actual neighbor word (1.0 = no
        padded matrix was ever built beyond the real entries)."""
        return self.padded_words / self.actual_words \
            if self.actual_words else 0.0

    def as_info(self) -> dict:
        """Short info dict."""
        return {"n_boxes": self.n_boxes, "n_dense_boxes": self.n_dense_boxes,
                "n_shards": self.n_shards, "n_rescans": self.n_rescans}


def resolve_torch_device(torch_device) -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the default
    everywhere) raises when no CUDA device is available: nothing carries on
    on the CPU unless the caller asked for it."""
    dev = torch.device(torch_device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"torch_device {torch_device!r}: only 'cuda' and "
                         "'cpu' are supported")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torch_device={str(dev)!r} but CUDA is not available; pass "
            "torch_device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# measured density crossovers (binary lane vs the dense, intersect and fused
# lanes), persisted per torch device under ~/.cache/repro_torch
# ---------------------------------------------------------------------------

_crossover_memo: dict = {}


def _crossover_cache_file() -> str:
    base = os.environ.get("REPRO_TORCH_CACHE_DIR") \
        or os.path.join(os.path.expanduser("~"), ".cache", "repro_torch")
    return os.path.join(base, "crossover.json")


class _crossover_file_lock:
    """Inter-process lock for the crossover cache's read-modify-write.

    The JSON store itself is written atomically (tmp + ``os.replace``), but
    two processes measuring at once still race load → merge → store, and
    the slower one would drop the faster one's entries (lost update). An
    ``flock`` on a sibling ``.lock`` file serializes the whole
    read-modify-write; without ``fcntl`` (or with an unwritable cache
    directory) it degrades to no lock rather than failing the run."""

    def __init__(self):
        self._f = None

    def __enter__(self):
        try:
            import fcntl
            path = _crossover_cache_file() + ".lock"
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._f = open(path, "a+")
            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
        except (ImportError, OSError):
            if self._f is not None:
                self._f.close()
                self._f = None
        return self

    def __exit__(self, *exc):
        if self._f is not None:
            try:
                import fcntl
                fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)
            except (ImportError, OSError):
                pass
            self._f.close()
            self._f = None
        return False


def _crossover_load() -> dict:
    try:
        with open(_crossover_cache_file()) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _crossover_store(data: dict) -> None:
    path = _crossover_cache_file()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only home must never break execution


def _calibration_device(torch_device=None) -> torch.device:
    """The device a calibration runs on: ``torch_device`` resolved, or,
    when None, the card if this process has one and the CPU otherwise."""
    if torch_device is None:
        torch_device = "cuda" if torch.cuda.is_available() else "cpu"
    return resolve_torch_device(torch_device)


def _active_prefix(torch_device=None) -> str:
    """Calibration namespace of the device: ``cuda:<card name>`` or
    ``cpu:cpu``. Every crossover entry is keyed under it, so values timed
    on the CPU never steer the card and values of one card model never
    steer another."""
    dev = _calibration_device(torch_device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu:cpu"


_remeasured_prefixes: set = set()


def _maybe_clear_remeasure(torch_device=None) -> None:
    """``REPRO_TORCH_CROSSOVER_REMEASURE=1``: drop the active device's
    cached entries once per process (other devices' calibrations in the
    shared file survive), then fall through to the normal measure and
    store, so a forced remeasure happens once, not on every call."""
    prefix = _active_prefix(torch_device) + ":"
    if prefix in _remeasured_prefixes:
        return
    _remeasured_prefixes.add(prefix)
    if os.environ.get("REPRO_TORCH_CROSSOVER_REMEASURE", "") in ("", "0"):
        return
    with _crossover_file_lock():
        data = _crossover_load()
        kept = {k: v for k, v in data.items() if not k.startswith(prefix)}
        if len(kept) != len(data):
            _crossover_store(kept)
    for k in list(_crossover_memo):
        if k.startswith(prefix):
            del _crossover_memo[k]


def _cached_crossover(suffix: str, nv: int, measure,
                      torch_device=None) -> float:
    """Process-memoized, file-persisted crossover of the active device:
    ``measure()`` runs only when neither the memo nor the JSON cache has a
    valid entry for ``<device prefix>:nv<nv><suffix>``."""
    _maybe_clear_remeasure(torch_device)
    key = f"{_active_prefix(torch_device)}:nv{nv}{suffix}"
    if key in _crossover_memo:
        return _crossover_memo[key]
    cached = _crossover_load().get(key)
    if isinstance(cached, (int, float)) and 0.0 < cached <= 1.0:
        _crossover_memo[key] = float(cached)
        return float(cached)
    value = measure()
    _crossover_memo[key] = value
    # merge under the lock: reload inside it so a concurrent process's
    # freshly stored keys survive this store
    with _crossover_file_lock():
        data = _crossover_load()
        data[key] = value
        _crossover_store(data)
    return value


def _time(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _calibration_graph(rng, nv: int, d: float, dev: torch.device):
    """One calibration box: a random upper-triangular 0/1 graph of density
    ``d`` on ``nv`` vertices, with its CSR and the binary lane's padded
    matrix and edge lists on ``dev``; None when it has no edge."""
    adj = np.triu(rng.random((nv, nv)) < d, k=1)
    src, dst = np.nonzero(adj)
    if len(src) == 0:
        return None
    indptr, indices = csr_from_edges(src, dst, n_nodes=nv)
    npad = torch.from_numpy(pad_neighbors(indptr, indices)).to(dev)
    eu = torch.from_numpy(src.astype(np.int64)).to(dev)
    ev = torch.from_numpy(dst.astype(np.int64)).to(dev)
    return adj, indptr, indices, npad, eu, ev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lowest_winning_density(nv: int, repeats: int, seed: int,
                            dev: torch.device, densities, make_lane) -> float:
    """The lowest density at which ``make_lane(graph)`` (a callable that
    runs the lane once) beats the binary lane, min of ``repeats`` timings
    each, with the device synchronized around every run; 1.0 when it never
    wins on the grid."""
    rng = np.random.default_rng(seed)
    for d in densities:
        g = _calibration_graph(rng, nv, d, dev)
        if g is None:
            continue
        _, _, _, npad, eu, ev = g

        def t_binary():
            _count_chunked(npad, eu, ev, chunk=2048)
            _sync(dev)

        lane = make_lane(g)

        def t_lane():
            lane()
            _sync(dev)

        t_binary(); t_lane()    # builds and first launches stay untimed
        tb = min(_time(t_binary) for _ in range(repeats))
        tl = min(_time(t_lane) for _ in range(repeats))
        if tl < tb:
            return d
    return 1.0


def measure_dense_crossover(nv: int = 256, repeats: int = 3,
                            seed: int = 0, torch_device="cuda") -> float:
    """Lowest box density at which the dense lane beats the binary lane,
    measured once per device: on the card the ``triangle_dense`` kernel,
    on the CPU its plain version, against the plain ``_count_chunked``.

    The value is kept in a JSON cache (``$REPRO_TORCH_CACHE_DIR/
    crossover.json``, default ``~/.cache/repro_torch``) keyed by the
    device (``cuda:<card name>`` or ``cpu:cpu``), so processes on the same
    hardware calibrate once. ``REPRO_TORCH_CROSSOVER_REMEASURE=1`` drops
    the active device's entries and measures afresh; other devices'
    entries are kept. 1.0 (never dense) if dense never wins on the grid.
    """
    dev = resolve_torch_device(torch_device)

    def dense_lane(g):
        a = torch.from_numpy(g[0].astype(np.uint8)).to(dev)
        return lambda: dense_ops.triangle_count(a, a, a)

    return _cached_crossover(
        "", nv, lambda: _lowest_winning_density(
            nv, repeats, seed, dev, (0.01, 0.02, 0.05, 0.10, 0.20, 0.40),
            dense_lane), dev)


def measure_intersect_crossover(nv: int = 256, repeats: int = 3,
                                seed: int = 0, torch_device="cuda") -> float:
    """Lowest box density at which the intersect kernel
    (``intersect_count_csr``) beats the binary lane: the measured lower
    edge of the mid-density band (static default: dense crossover / 4).
    Kept beside the dense crossover (key suffix ``:intersect``). Off the
    card the band never runs, so the value is 1.0 without timing."""
    dev = resolve_torch_device(torch_device)

    def intersect_lane(g):
        _, indptr, indices, _, eu, ev = g
        off = torch.from_numpy(indptr).to(dev)
        vals = torch.from_numpy(indices).to(dev)
        return lambda: intersect_ops.intersect_count_csr(off, vals, eu, off,
                                                         vals, ev)

    return _cached_crossover(
        ":intersect", nv,
        lambda: 1.0 if dev.type != "cuda" else _lowest_winning_density(
            nv, repeats, seed, dev, (0.005, 0.01, 0.02, 0.05, 0.10, 0.20),
            intersect_lane), dev)


def measure_fused_crossover(nv: int = 256, repeats: int = 3,
                            seed: int = 0, torch_device="cuda") -> float:
    """Lowest box density at which the fused count kernel (``fused_count``
    over a whole triangle box) beats the binary lane: the calibration of
    ``fused_threshold``. Kept beside the others (key suffix ``:fused``).
    Off the card the value is 1.0 without timing."""
    dev = resolve_torch_device(torch_device)

    def fused_lane(g):
        _, indptr, indices, _, _, _ = g
        deg = np.diff(indptr)
        keys = np.flatnonzero(deg > 0).astype(np.int64)
        off = np.concatenate([[0], np.cumsum(deg[keys])]).astype(np.int64)
        csr = tuple(torch.from_numpy(x).to(dev)
                    for x in (keys, off, np.asarray(indices, np.int32)))
        return lambda: fused_ops.fused_count(((0, 1), (0, 2), (1, 2)),
                                             [csr, csr, csr], 3)

    return _cached_crossover(
        ":fused", nv,
        lambda: 1.0 if dev.type != "cuda" else _lowest_winning_density(
            nv, repeats, seed, dev, (0.005, 0.01, 0.02, 0.05, 0.10, 0.20),
            fused_lane), dev)


class TriangleEngine:
    """Boxed streaming triangle counting + listing on a torch device.

    Parameters
    ----------
    src, dst : undirected edge endpoints (host numpy).
    csr : ``(indptr, indices)`` of an already-oriented graph, instead of
        ``src``/``dst`` (``orientation`` then names how it was oriented).
    store : path to a ``data.edgestore`` file (or an open ``EdgeStore``),
        instead of ``src``/``dst``: the out-of-core source. Only the
        (V+1)-word degree index stays resident; per-box slices stream
        from the file, with block I/Os measured on ``device``.
    device : optional ``core.iomodel.BlockDevice`` charging source reads.
        Defaults to a fresh device for store-backed runs (block size
        ``io_block_words``, cache sized to the memory budget); ``None``
        (no accounting) in memory.
    io_block_words : block size of the default store-backed device.
    mem_words : memory budget for the box planner; ``None`` = one box.
    cache_words : LRU slice-cache budget (``core.executor.SliceCache``) on
        top of ``mem_words``; the box plan is unchanged, so cache-on and
        cache-off runs are directly comparable. 0 disables the cache.
    orientation : 'minmax' (paper §2.3) or 'degree' (√|E| out-degree cap).
        A store carries its orientation in its header.
    backend : 'auto' (density dispatch), or force 'binary' / 'dense' /
        'intersect' / 'host' / 'fused' for every box ('host' is the
        pure-numpy binary-search lane; 'fused' runs each whole box as one
        ``kernels/lftj_fused`` invocation, falling back per box to
        intersect (card) / binary outside the kernel's envelope).
    dense_threshold : box edge-density above which 'auto' picks the dense
        lane; the string 'measured' uses the persisted calibration of the
        engine's device (``measure_dense_crossover``).
    intersect_threshold : lower edge of the mid-density band 'auto' routes
        to the intersect kernel (only on the card). Default
        ``dense_threshold / 4``; 'measured' uses
        ``measure_intersect_crossover`` (same cache).
    fused_threshold : density above which 'auto' prefers the fused lane
        over the intersect band (only on the card). Default ``None`` keeps
        density dispatch off the fused lane (heavy/light hub boxes still
        route to it on the card); 'measured' uses
        ``measure_fused_crossover`` (same cache).
    degree_bins : bin vertices by degree (power-of-4 widths) so the
        binary lane's padding is per bin instead of the box's widest row.
        In memory the lane's boxes go through the whole graph's bins; from
        a store, through each box slice's own bins in the executor. On the
        card the bins' probes run as intersect launches over the CSR, on
        the CPU through the plain per-bin-pair probe.
    skew : 'uniform' (the mass-budgeted grid cutter) or 'heavy_light':
        vertices of out-degree >= ``heavy_threshold`` are hubs, every box
        range is pure-class per axis, hub-hub boxes go to the dense lane
        (or, when the one-hot footprint cannot fit, to the fused lane on
        the card and the binary lane elsewhere) and light and mixed boxes
        to the host lane. ``EngineStats`` records the lane mix and
        ``padded_words`` vs ``actual_words``.
    heavy_threshold : hub degree cut for ``skew='heavy_light'``; default
        ``boxing.heavy_threshold_default`` (√(2·|E|)).
    chunk : edge-chunk length of the binary lane (peak memory
        O(chunk · K)).
    prefetch_depth : how many box slices the host builds ahead of the
        device (``data.pipeline.Prefetcher``).
    workers : worker threads of the async box scheduler. 1 (default) is
        the sequential oracle; with ``workers > 1`` the box work-queue
        drains LPT-first across a thread pool and counts and listings are
        reduced in fixed box order, so the output is identical to the
        ``workers=1`` run. The pool is clamped to ``os.cpu_count()``.
    inflight_boxes : in-flight window of the async scheduler (default
        ``2 * workers``), with resident raw words capped at
        ``inflight_boxes * mem_words`` when a budget is set.
    torch_device : where the lanes run: ``"cuda"`` (default; raises when
        no CUDA device is available) or ``"cpu"``. On CUDA the dense,
        intersect and fused lanes launch the hand-written kernels
        (``use_kernels``) and 'auto' routes the mid-density band to the
        intersect kernel and hub boxes to the fused kernel; on the CPU the
        kernel wrappers run their plain torch versions.
    tracer : optional ``obs.trace.Tracer``: ``engine.count`` /
        ``engine.list`` spans, ``box.fetch`` / ``box.build`` /
        ``box.compute`` spans per box, ``kernel.launch`` and ``cache.*``
        events. Read-only: counts and ledgers are unchanged.
    metrics : optional ``obs.metrics.MetricsRegistry``: ``kernel.*`` and
        ``box.*`` series and the run's ``EngineStats`` as ``engine.*``
        gauges.
    devices : the shard devices of a sharded run (default
        ``[torch_device]``), all of ``torch_device``'s kind; a device may
        repeat, and shards that share one run one after the other.
    shard : True, False or 'auto' (shard exactly when ``devices`` holds
        more than one device). A sharded run keeps the dense (and, on the
        card, intersect) boxes on the local executor and schedules every
        other box's edges onto the shards (LPT on edge counts, on slice
        mass under ``skew='heavy_light'``). Each shard holds only the rows
        its edges reference, as compact CSR on its device: a count is one
        ``intersect_count_csr`` call a shard (the intersect kernel on the
        card), the partials summed as int64 with one host read; a listing
        is the plain chunked listing over that CSR, or with
        ``degree_bins`` one ``_list_pairs_chunked`` per (bin_u, bin_v)
        pair. ``EngineStats`` records ``n_shards``, ``shard_edges``,
        ``shard_rows`` and the reference's padded ``local_npad_shape``,
        which is never allocated. A store-backed graph is staged through
        host memory in one charged sequential pass first.
    """

    def __init__(self, src: Optional[np.ndarray] = None,
                 dst: Optional[np.ndarray] = None, *,
                 csr: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 store=None,
                 device: Optional[BlockDevice] = None,
                 io_block_words: int = 4096,
                 mem_words: Optional[int] = None,
                 cache_words: int = 0,
                 orientation: str = "minmax",
                 backend: str = "auto",
                 dense_threshold=0.05,
                 intersect_threshold=None,
                 fused_threshold=None,
                 degree_bins: bool = False,
                 skew: str = "uniform",
                 heavy_threshold: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 shard="auto",
                 chunk: int = 2048,
                 prefetch_depth: int = 2,
                 workers: int = 1,
                 inflight_boxes: Optional[int] = None,
                 torch_device="cuda",
                 tracer=None,
                 metrics=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if skew not in ("uniform", "heavy_light"):
            raise ValueError(
                f"skew {skew!r} not in ('uniform', 'heavy_light')")
        if shard not in ("auto", False, True):
            raise ValueError(f"shard {shard!r} not in ('auto', False, True)")
        self.torch_device = resolve_torch_device(torch_device)
        self.devices = box_mesh(devices, self.torch_device)
        if self.devices[0].type != self.torch_device.type:
            raise ValueError(f"devices {self.devices} are not of "
                             f"torch_device {self.torch_device}'s kind")
        self.shard = len(self.devices) > 1 if shard == "auto" \
            else bool(shard)
        # observability: span/event recorder (obs.trace.Tracer) and the
        # metrics registry; None by default — the traced-off path is one
        # attribute check per site
        self.tracer = tracer
        self.metrics = metrics
        # the port's counterpart of the reference's use_pallas_kernels:
        # kernels run on the card, their plain versions on the CPU
        self.use_kernels = self.torch_device.type == "cuda"
        self.backend = backend
        self.degree_bins = bool(degree_bins)
        self.skew = skew
        self.heavy_threshold = heavy_threshold
        self.chunk = int(chunk)
        self.mem_words = mem_words
        self.prefetch_depth = int(prefetch_depth)
        self.workers = max(1, int(workers))
        self.inflight_boxes = max(1, int(inflight_boxes)) \
            if inflight_boxes is not None else max(2, 2 * self.workers)
        if dense_threshold == "measured":
            dense_threshold = measure_dense_crossover(
                torch_device=self.torch_device)
        self.dense_threshold = float(dense_threshold)
        # lower edge of the mid-density band 'auto' routes to the intersect
        # kernel (card only): the static crossover/4 by default, 'measured'
        # the persisted calibration
        if intersect_threshold == "measured":
            intersect_threshold = measure_intersect_crossover(
                torch_device=self.torch_device)
        self.intersect_threshold = self.dense_threshold / 4.0 \
            if intersect_threshold is None else float(intersect_threshold)
        # density gate of the fused lane (card only): None keeps density
        # dispatch off it (hub boxes still take it), 'measured' uses the
        # :fused calibration
        if fused_threshold == "measured":
            fused_threshold = measure_fused_crossover(
                torch_device=self.torch_device)
        self.fused_threshold = None if fused_threshold is None \
            else float(fused_threshold)
        if (src is not None or dst is not None) + (csr is not None) \
                + (store is not None) > 1:
            raise ValueError("pass one of (src, dst), csr= or store=")
        self.orientation = orientation
        self.device = device
        if store is not None:
            self.source = store if isinstance(store, EdgeStore) \
                else EdgeStore(store)
            if device is None:
                cache = max(2, (mem_words or (1 << 22)) // io_block_words)
                device = BlockDevice(block_words=io_block_words,
                                     cache_blocks=cache)
            self.source.attach_device(device)
            self.device = device
            self.orientation = self.source.orientation
            self.nv = self.source.n_nodes
            self.indptr = self.source.indptr
            self.indices = None          # never resident: streamed per box
            self.a = self.b = None
        elif csr is not None:
            self.indptr = np.asarray(csr[0], dtype=np.int64)
            self.indices = np.asarray(csr[1], dtype=np.int32)
            self.nv = len(self.indptr) - 1
            self.a = np.repeat(np.arange(self.nv, dtype=np.int64),
                               np.diff(self.indptr))
            self.b = self.indices.astype(np.int64)
        else:
            if src is None or dst is None:
                raise ValueError(
                    "TriangleEngine needs (src, dst) edge arrays, csr= or "
                    "store=<edge store path>")
            a, b = orient_edges(np.asarray(src), np.asarray(dst),
                                orientation)
            self.a, self.b = a, b
            self.nv = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
            self.indptr, self.indices = \
                csr_from_edges(a, b, n_nodes=self.nv) if self.nv \
                else (np.zeros(1, np.int64), np.zeros(0, np.int32))
        if store is None:
            self.source = InMemoryEdgeSource(self.indptr, self.indices,
                                             device=device,
                                             orientation=self.orientation)
        self.cache_words = int(cache_words)
        self._slice_cache: Optional[SliceCache] = None
        if self.cache_words > 0:
            self._slice_cache = SliceCache(self.source, self.cache_words,
                                           tracer=tracer)
            self.source = self._slice_cache
        if self.shard and self.indices is None:
            warnings.warn(
                "sharded execution stages the store-backed neighbor stream "
                "through host memory (one full sequential pass); for graphs "
                "larger than host RAM pass shard=False to keep the "
                "bounded-memory streaming path.", stacklevel=2)
        self._bins = None
        # spill runs of the external sort when ``ingest`` built the store
        self.n_spill_runs = 0
        self._plan_cache: Optional[Tuple[Optional[int], list]] = None
        # box -> lane ("hub"/"light"/"mixed"), filled by the heavy_light
        # planner; the lane steers _pick_backend for planned boxes
        self._box_lane: dict = {}
        self._skew_threshold = 0
        self.stats = EngineStats(dense_threshold=self.dense_threshold,
                                 skew=self.skew)

    # -- lazy derived state --------------------------------------------------

    @property
    def bins(self):
        """The in-memory graph's degree-binned layout
        (``pad_neighbors_binned`` of its CSR)."""
        if self._bins is None:
            self._bins = pad_neighbors_binned(self.indptr, self.indices)
        return self._bins

    def _resident_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """The whole graph's CSR: the resident one in memory; from a store,
        one sequential read of every row, charged, that bypasses the slice
        cache (a single pass cannot hit and would churn its LRU)."""
        if self.indices is not None:
            return self.indptr, self.indices
        src = self._slice_cache.source if self._slice_cache is not None \
            else self.source
        _, indices = src.read_rows(0, self.nv - 1)
        return self.indptr, indices

    def _staged_source(self):
        """Source of the sharded paths. They concatenate every box's edges
        on the host before any shard runs, so a store-backed graph is
        staged through host memory with ONE sequential charged pass
        (|E|/B block reads) instead of re-reading overlapping x-slabs per
        box and again per shard gather. In memory it is the engine's own
        source. Bounded-memory execution is the non-sharded streaming
        path."""
        if self.indices is not None:
            return self.source
        indptr, indices = self._resident_csr()
        return InMemoryEdgeSource(indptr, indices,
                                  orientation=self.orientation)

    # -- streaming ingest ------------------------------------------------------

    @classmethod
    def ingest(cls, store_path, edges, *,
               orientation: str = "minmax",
               chunk_rows: int = 4096,
               align_words: int = 1024,
               ingest_budget_words: int = 1 << 22,
               prefetch_batches: bool = True,
               **engine_kw) -> "TriangleEngine":
        """Stream undirected edges into a chunked-CSR store, bounded-memory,
        and return a store-backed engine over it.

        ``edges`` is either an iterable of ``(src, dst)`` array batches or a
        single ``(src, dst)`` pair of arrays (sliced into batches here).
        The batches flow through ``data.edgestore.EdgeStoreWriter``: spill
        runs under ``ingest_budget_words`` (4-byte words), then an external
        merge, so the graph never has to fit in RAM during ingest. With
        ``prefetch_batches`` the producer runs one batch ahead on a
        ``data.pipeline.Prefetcher`` thread. The remaining keyword arguments
        (``mem_words``, ``cache_words``, ``torch_device``, ...) go to the
        returned engine.
        """
        if isinstance(edges, tuple) and len(edges) == 2 \
                and np.ndim(edges[0]) == 1:
            edges = edge_batches(*edges)
        writer = EdgeStoreWriter(store_path, orientation=orientation,
                                 chunk_rows=chunk_rows,
                                 align_words=align_words,
                                 budget_words=ingest_budget_words)
        it = Prefetcher(iter(edges), depth=1) if prefetch_batches \
            else iter(edges)
        try:
            with writer:
                for src, dst in it:
                    writer.add_edges(src, dst)
        finally:
            if isinstance(it, Prefetcher):
                it.close()
        eng = cls(store=writer.path, **engine_kw)
        eng.n_spill_runs = writer.n_spill_runs
        return eng

    # -- box planning ---------------------------------------------------------

    def plan(self) -> List[Tuple[int, int, int, int]]:
        """Box plan [(lx, hx, ly, hy)]; one unbounded box without a budget.

        Cached per ``mem_words`` — the probe/provision pass is the expensive
        host-side step and the plan is deterministic. In-memory graphs use
        the faithful TrieArray prober; store-backed graphs plan from the
        resident degree index (``plan_boxes_from_degrees``), so planning
        itself stays out of core.
        """
        if self._plan_cache is not None \
                and self._plan_cache[0] == self.mem_words:
            return self._plan_cache[1]
        boxes = self._plan_uncached()
        self._plan_cache = (self.mem_words, boxes)
        return boxes

    def _plan_uncached(self) -> List[Tuple[int, int, int, int]]:
        if self.nv == 0 or self.source.n_edges == 0:
            self._box_lane = {}
            return []
        # hy < lx pruning is only sound when every edge has x < y (minmax)
        prune = self.orientation == "minmax"
        if self.skew == "heavy_light":
            # pure-class ranges per axis from the degree index, lane
            # metadata per box
            from .boxing import plan_boxes_heavy_light
            sp = plan_boxes_heavy_light(self.indptr, self.mem_words,
                                        monotone_prune=prune,
                                        heavy_threshold=self.heavy_threshold)
            self._box_lane = dict(zip(sp.boxes, sp.lanes))
            self._skew_threshold = sp.threshold
            return sp.boxes
        self._box_lane = {}
        if self.mem_words is None:
            return [(0, self.nv - 1, 0, self.nv - 1)]
        if self.indices is None:
            from .boxing import plan_boxes_from_degrees
            return plan_boxes_from_degrees(self.indptr, self.mem_words,
                                           monotone_prune=prune)
        from .boxing import plan_boxes
        from .triearray import TrieArray
        ta = TrieArray.from_edges(self.a, self.b)
        if ta.words() <= self.mem_words:
            return [(0, self.nv - 1, 0, self.nv - 1)]
        return plan_boxes(ta, self.mem_words, monotone_prune=prune)

    def _pick_backend(self, n_edges: int, wx: int, wy: int,
                      box=None) -> str:
        """Density dispatch: dense above the crossover, the fused lane
        above ``fused_threshold`` (when set), the intersect kernel for the
        mid-density band, binary-search otherwise.

        With ``skew="heavy_light"`` a planned ``box`` overrides density:
        hub-hub boxes go to the dense lane, or to the fused lane (binary
        off the card) when the one-hot footprint cannot fit; light and
        mixed boxes go to the host lane.

        The fused and intersect bands are taken **only when**
        ``use_kernels`` is set (running on the card), exactly as the
        reference takes its kernel bands only where the kernels compile;
        force ``backend="fused"`` / ``"intersect"`` to run those lanes
        anywhere.
        """
        if self.backend != "auto":
            return self.backend
        lane = self._box_lane.get(box) if box is not None else None
        if lane is not None:
            if lane == "hub":
                est_rows = min(wx, n_edges) + min(wy, n_edges)
                est_cols = min(self.nv, 16 * max(1, n_edges))
                if est_rows * est_cols <= _DENSE_WORDS_CAP:
                    return "dense"
                # hub boxes too big for the one-hot footprint run whole as
                # one fused launch on the card
                return "fused" if self.use_kernels else "binary"
            return "host"
        density = n_edges / max(1, wx * wy)
        # feasibility of the dense one-hots: the executor compacts rows to
        # the referenced endpoints (≤ min(width, edges) per side) and
        # columns to the z values occurring in the slice (≤ min(V, slice
        # neighbor entries)), so the cap is slice-scaled, not O(V)
        est_rows = min(wx, n_edges) + min(wy, n_edges)
        est_cols = min(self.nv, 16 * max(1, n_edges))
        if density > self.dense_threshold \
                and est_rows * est_cols <= _DENSE_WORDS_CAP:
            return "dense"
        if self.use_kernels and self.fused_threshold is not None \
                and density > self.fused_threshold:
            return "fused"
        if self.use_kernels and density > self.intersect_threshold:
            return "intersect"
        return "binary"

    # -- executor / stats plumbing --------------------------------------------

    def _make_executor(self, source=None) -> StreamingExecutor:
        # total resident slice words of the parallel window are bounded by
        # window-size × per-box budget (each planned slice is itself under
        # mem_words, modulo pinned spill rows)
        inflight_words = self.inflight_boxes * self.mem_words \
            if self.mem_words is not None else None
        return StreamingExecutor(self.source if source is None else source,
                                 pick_backend=self._pick_backend,
                                 torch_device=self.torch_device,
                                 chunk=self.chunk,
                                 prefetch_depth=self.prefetch_depth,
                                 dense_words_cap=_DENSE_WORDS_CAP,
                                 stats=self.stats,
                                 workers=self.workers,
                                 # store-backed binning is per box slice, in
                                 # the executor; in memory it is global
                                 degree_bins=self.degree_bins
                                 and self.indices is None,
                                 inflight_boxes=self.inflight_boxes,
                                 inflight_words=inflight_words,
                                 tracer=self.tracer,
                                 metrics=self.metrics)

    def _reset_stats(self, n_boxes: int) -> None:
        self.stats = EngineStats(dense_threshold=self.dense_threshold,
                                 n_boxes=n_boxes,
                                 n_workers=self.workers,
                                 skew=self.skew,
                                 heavy_threshold=self._skew_threshold,
                                 source="edgestore" if self.indices is None
                                 else "memory")
        if self._box_lane:
            lanes = list(self._box_lane.values())
            self.stats.n_hub_boxes = lanes.count("hub")
            self.stats.n_light_boxes = lanes.count("light")
            self.stats.n_mixed_boxes = lanes.count("mixed")

    def _io_mark(self):
        cache = self._slice_cache
        cm = (cache.hits, cache.misses, cache.hit_words) if cache else None
        if self.device is None:
            return (None, cm)
        s = self.device.stats
        return ((s.block_reads, s.block_writes, s.word_reads), cm)

    def _io_collect(self, mark) -> None:
        io_mark, cm = mark
        if self.device is not None and io_mark is not None:
            s = self.device.stats
            self.stats.block_reads = s.block_reads - io_mark[0]
            self.stats.block_writes = s.block_writes - io_mark[1]
            self.stats.word_reads = s.word_reads - io_mark[2]
        if self._slice_cache is not None and cm is not None:
            cache = self._slice_cache
            self.stats.cache_hits = cache.hits - cm[0]
            self.stats.cache_misses = cache.misses - cm[1]
            self.stats.cache_hit_words = cache.hit_words - cm[2]

    # -- counting and listing --------------------------------------------------

    def count(self) -> int:
        if self.tracer is not None:
            with self.tracer.span("engine.count", nv=self.nv,
                                  workers=self.workers):
                total = self._count_impl()
        else:
            total = self._count_impl()
        if self.metrics is not None:
            self.metrics.publish_stats(self.stats, "engine", mode="count")
        return total

    def _count_impl(self) -> int:
        boxes = self.plan()
        self._reset_stats(len(boxes))
        mark = self._io_mark()
        if not self.shard:
            ex = self._make_executor()
            if self.degree_bins and self.indices is not None:
                total = self._count_binned_boxes(boxes, ex)
            else:
                total = ex.run_count(boxes)
            self._io_collect(mark)
            return total
        # sharded: dense and intersect boxes run locally through the
        # executor; every other box's edges join the shards' work-lists.
        # The neighbor stream is staged through host memory once
        # (_staged_source).
        total = 0
        staged = self._staged_source()
        ex = self._make_executor(source=staged)
        sparse: List[Tuple[np.ndarray, np.ndarray]] = []
        sparse_boxes: List[Tuple[int, int, int, int]] = []
        local: List[Tuple[int, int, int, int]] = []
        for box in boxes:
            eu, ev, wx, wy, slab = self._box_edges_full(box, staged)
            if len(eu) == 0:
                continue
            be = self._pick_backend(len(eu), wx, wy, box)
            if be in ("dense", "intersect"):
                if self.workers > 1 \
                        and getattr(staged, "device", None) is None:
                    # the local boxes take the async queue of the unsharded
                    # path, but only over an uncharged source: the queue's
                    # fresh x-slab read would bill the read the slab reuse
                    # saves a second time
                    local.append(box)
                else:
                    total += ex.count_box(box, x_slab=slab)
            else:
                sparse.append((eu, ev))
                sparse_boxes.append(box)
                self.stats.n_binary_boxes += 1
        if local:
            total += ex.run_count(local)
        if sparse:
            if self.degree_bins:
                total += self._count_sharded_binned(sparse, staged,
                                                    boxes=sparse_boxes)
            else:
                total += self._count_sharded(sparse, staged,
                                             boxes=sparse_boxes)
        self._io_collect(mark)
        return total

    def _box_edges_full(self, box, source=None):
        """In-box oriented edges (x ∈ [lx,hx], y ∈ [ly,hy]) read from
        ``source`` (default: the engine's), the box widths and the raw
        x-range slab, so a follow-up ``StreamingExecutor.count_box`` reuses
        the already-charged read."""
        src = self.source if source is None else source
        lx, hx, ly, hy = box
        lx_, hx_ = max(lx, 0), min(hx, self.nv - 1)
        ly_, hy_ = max(ly, 0), min(hy, self.nv - 1)
        if hx_ < lx_ or hy_ < ly_:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64), 0, 0, None)
        ip, vals = src.read_rows(lx_, hx_)
        eu = np.repeat(np.arange(lx_, hx_ + 1), np.diff(ip))
        ev = vals.astype(np.int64)
        sel = (ev >= ly_) & (ev <= hy_)
        return (eu[sel], ev[sel], hx_ - lx_ + 1, hy_ - ly_ + 1, (ip, vals))

    def _count_binned_boxes(self, boxes, ex: StreamingExecutor) -> int:
        """Degree-binned in-memory path: dense and intersect boxes stream
        through the executor; every other box's edges join one binned
        probe over the whole graph's bins (padding per bin, not per
        widest row)."""
        total = 0
        eus, evs = [], []
        for box in boxes:
            eu, ev, wx, wy, slab = self._box_edges_full(box)
            if len(eu) == 0:
                continue
            be = self._pick_backend(len(eu), wx, wy, box)
            if be in ("dense", "intersect"):
                total += ex.count_box(box, x_slab=slab)
            else:
                eus.append(eu)
                evs.append(ev)
                self.stats.n_binary_boxes += 1
        if eus:
            total += self._count_binned(np.concatenate(eus),
                                        np.concatenate(evs))
        return total

    def _count_binned(self, eu: np.ndarray, ev: np.ndarray) -> int:
        """Σ over edges of |N(u) ∩ N(v)| through the degree bins. On the
        card one ``intersect_count_csr`` launch over the resident CSR at
        the live edges (no bin matrix is built); on the CPU the plain
        probe per (bin_u, bin_v) pair of the bins' padded matrices, the
        narrower rows into the wider, as in the reference."""
        dev = self.torch_device
        if self.use_kernels:
            live = np.diff(self.indptr)[ev] > 0   # sinks intersect empty
            off = torch.from_numpy(self.indptr).to(dev)
            vals = torch.from_numpy(self.indices).to(dev)
            return int(intersect_ops.intersect_count_csr(
                off, vals, torch.from_numpy(eu[live]).to(dev),
                off, vals, torch.from_numpy(ev[live]).to(dev)))
        row_bin, bins = self.bins
        bin_pos = np.zeros(self.nv, dtype=np.int64)
        for rows, _ in bins:
            bin_pos[rows] = np.arange(len(rows))
        bu = row_bin[eu]
        bv = row_bin[ev]
        total = 0
        live = bv >= 0   # sink y-endpoints (out-degree 0) intersect empty
        for i, (_, npad_i) in enumerate(bins):
            for j, (_, npad_j) in enumerate(bins):
                sel = live & (bu == i) & (bv == j)
                if not sel.any():
                    continue
                total += int(_count_rows_chunked(
                    torch.from_numpy(npad_i[bin_pos[eu[sel]]]).to(dev),
                    torch.from_numpy(npad_j[bin_pos[ev[sel]]]).to(dev),
                    chunk=self.chunk))
        return total

    # -- sharded execution ---------------------------------------------------

    def _schedule(self, edge_lists, boxes=None) -> List[List[int]]:
        """LPT shard schedule. The uniform planner balances on in-box edge
        counts; under ``skew="heavy_light"`` the cost is the box's slice
        mass (``box_mass_costs``): on skewed graphs a hub box's work is
        its neighbor mass, not its edge count."""
        if boxes is not None and self.skew == "heavy_light":
            return balanced_box_schedule(
                box_mass_costs(self.indptr, boxes), len(self.devices))
        return balanced_box_schedule([len(eu) for eu, _ in edge_lists],
                                     len(self.devices))

    def _gather(self, rows: np.ndarray, source=None) -> Tuple[np.ndarray,
                                                              np.ndarray]:
        """(deg, concat neighbor values) for sorted global rows, reading
        contiguous runs from the source (charged when it is)."""
        src = self.source if source is None else source
        if len(rows) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        splits = np.flatnonzero(np.diff(rows) > 1) + 1
        degs, vals = [], []
        for run in np.split(rows, splits):
            ip, v = src.read_rows(int(run[0]), int(run[-1]))
            # runs are consecutive ids, so every row in [run0, run-1] is ours
            degs.append(np.diff(ip))
            vals.append(v)
        return np.concatenate(degs), np.concatenate(vals)

    def _shard_slices(self, edge_lists, schedule, source=None):
        """Each shard's local slice (``iter_shard_local_csr``: its rows
        gathered from ``source``, charged), yielded in schedule order so a
        shard's device work overlaps the next shard's gather. Fills
        ``n_shards``, ``shard_edges``, ``shard_rows`` and the reference's
        padded ``local_npad_shape`` once the last shard is out."""
        slices = []
        for slc in iter_shard_local_csr(
                edge_lists, schedule, lambda rows: self._gather(rows,
                                                                source)):
            slices.append(slc)
            yield slc
        self.stats.n_shards = len(self.devices)
        self.stats.shard_edges = [len(slc.eu) for slc in slices]
        self.stats.shard_rows = [len(slc.rows) for slc in slices]
        self.stats.local_npad_shape = local_slice_shape(slices)

    @staticmethod
    def _to_device(slc: ShardSlice, dev: torch.device):
        """The slice's CSR and local edge ids on ``dev``: (offsets int64,
        values int32, eu int64, ev int64)."""
        return (torch.from_numpy(slc.offsets).to(dev),
                torch.from_numpy(np.asarray(slc.vals, np.int32)).to(dev),
                torch.from_numpy(np.asarray(slc.eu, np.int64)).to(dev),
                torch.from_numpy(np.asarray(slc.ev, np.int64)).to(dev))

    @staticmethod
    def _sum_partials(parts: List[torch.Tensor]) -> int:
        """The exact int64 sum of per-shard 0-d partials, each on its own
        device, with one host read."""
        if not parts:
            return 0
        dev = parts[0].device
        return int(torch.stack([p.to(dev) for p in parts]).sum())

    def _count_shard(self, slc: ShardSlice, dev: torch.device
                     ) -> torch.Tensor:
        """Σ |N(u) ∩ N(v)| over one shard's edges as a 0-d int64 tensor on
        ``dev``: one ``intersect_count_csr`` call over the shard's compact
        CSR (the kernel on the card, its plain version on the CPU)."""
        if len(slc.eu) == 0:
            return torch.zeros((), dtype=torch.int64, device=dev)
        off, vals, eu, ev = self._to_device(slc, dev)
        return intersect_ops.intersect_count_csr(off, vals, eu, off, vals,
                                                 ev)

    def _count_sharded(self, edge_lists, source=None, boxes=None) -> int:
        """Data-parallel box execution with *non-replicated* neighbor data:
        every shard receives only the renumbered rows its boxes touch, so
        per-device memory is O(slice), not O(V·K)."""
        schedule = self._schedule(edge_lists, boxes=boxes)
        parts = [self._count_shard(slc, self.devices[s]) for s, slc in
                 enumerate(self._shard_slices(edge_lists, schedule, source))]
        return self._sum_partials(parts)

    def _binned_csr(self, source=None) -> Tuple[np.ndarray, np.ndarray]:
        """The CSR the binned shard paths read their rows from, uncharged,
        as the reference's bins are: the resident one in memory, the
        staged source's from a store."""
        if self.indices is not None:
            return self.indptr, self.indices
        src = self.source if source is None else source
        return np.asarray(src.indptr), np.asarray(src.indices)

    def _binned_layout(self, source=None):
        """(row_bin, bins, bin_pos) of the degree bins: the cached global
        layout in memory; from a store, built from the staged source's CSR
        (the sharded paths stage the neighbor stream through host memory
        anyway), so ``degree_bins=True`` works sharded for both."""
        row_bin, bins = self.bins if self.indices is not None \
            else pad_neighbors_binned(*self._binned_csr(source))
        bin_pos = np.zeros(self.nv, dtype=np.int64)
        for rows, _ in bins:
            bin_pos[rows] = np.arange(len(rows))
        return row_bin, bins, bin_pos

    def _count_sharded_binned(self, edge_lists, source=None,
                              boxes=None) -> int:
        """Sharded count through the degree bins. The reference runs one
        kernel per (bin_u, bin_v) width pair over per-bin padded matrices;
        the CSR kernel takes rows of unequal width, so here each shard is
        one ``intersect_count_csr`` call, as unbinned, over the rows it
        references read from the binned CSR. Stats are the reference's:
        ``n_shards`` and ``shard_edges``."""
        ip, ix = self._binned_csr(source)
        deg = np.diff(ip)
        schedule = self._schedule(edge_lists, boxes=boxes)
        self.stats.n_shards = len(schedule)
        self.stats.shard_edges = [sum(len(edge_lists[b][0]) for b in ids)
                                  for ids in schedule]
        slices = iter_shard_local_csr(
            edge_lists, schedule,
            lambda rows: (deg[rows], _rows_values(ip, ix, rows, deg[rows])))
        return self._sum_partials([self._count_shard(slc, self.devices[s])
                                   for s, slc in enumerate(slices)])

    def list(self, capacity: Optional[int] = None) -> np.ndarray:
        """Enumerate all triangles; returns canonical sorted (m, 3) rows.

        The output buffer is bounded (``capacity`` triangles per box, or
        per shard when sharded); because the lanes return the *exact*
        total alongside the buffer, overflow is detected and resolved by
        rescanning with the capacity doubled until everything fits. Only
        the sharded listing bins.
        """
        if self.tracer is not None:
            with self.tracer.span("engine.list", nv=self.nv,
                                  workers=self.workers):
                tris = self._list_impl(capacity)
        else:
            tris = self._list_impl(capacity)
        if self.metrics is not None:
            self.metrics.publish_stats(self.stats, "engine", mode="list")
        return tris

    def _list_impl(self, capacity: Optional[int] = None) -> np.ndarray:
        boxes = self.plan()
        self._reset_stats(len(boxes))
        mark = self._io_mark()
        if not self.shard:
            tris = self._make_executor().run_list(boxes, capacity)
            self._io_collect(mark)
            return self._canonical(tris)
        staged = self._staged_source()
        edge_lists, kept_boxes = [], []
        for box in boxes:
            eu, ev, _, _, _ = self._box_edges_full(box, staged)
            if len(eu):
                edge_lists.append((eu, ev))
                kept_boxes.append(box)
        if not edge_lists:
            # as in the reference, an empty sharded listing reports no I/O
            return np.zeros((0, 3), dtype=np.int64)
        if capacity is None:
            capacity = max(256, sum(len(eu) for eu, _ in edge_lists))
        cap = _pow2(max(2, capacity))
        if self.degree_bins:
            tris = self._list_sharded_binned(edge_lists, cap, staged,
                                             boxes=kept_boxes)
        else:
            tris = self._list_sharded(edge_lists, cap, staged,
                                      boxes=kept_boxes)
        self._io_collect(mark)
        return self._canonical(tris)

    def _rescan_cap(self, totals: List[int], cap: int) -> int:
        """The capacity every total fits in after the reference's rescans
        (double until no total exceeds it), counting each doubling in
        ``n_rescans``. The totals are exact, so the overflowed calls rerun
        once, at that capacity."""
        while max(totals, default=0) > cap:
            self.stats.n_rescans += 1
            cap *= 2
        return cap

    def _list_sharded(self, edge_lists, cap: int, source=None,
                      boxes=None) -> np.ndarray:
        """Sharded listing: each shard's slice gathered (charged) and put
        on its device once, then listed by ``_list_csr_chunked`` over that
        compact CSR (edge order, z ascending) into a (cap, 3) buffer; the
        shards whose exact total overflowed rerun at the doubled
        capacity. Local row ids map back to global vertices on the
        host."""
        chunk = min(self.chunk, 1024)
        schedule = self._schedule(edge_lists, boxes=boxes)
        slices = list(self._shard_slices(edge_lists, schedule, source))
        on_dev = [self._to_device(slc, dev)
                  for slc, dev in zip(slices, self.devices)]
        outs = [_list_csr_chunked(*t, cap=cap, chunk=chunk) for t in on_dev]
        cap_all = self._rescan_cap([t for t, _ in outs], cap)
        outs = [_list_csr_chunked(*t, cap=cap_all, chunk=chunk)
                if out[0] > cap else out for t, out in zip(on_dev, outs)]
        parts = []
        for slc, (total, buf) in zip(slices, outs):
            if total == 0:
                continue
            tris = buf[:total].cpu().numpy().astype(np.int64)
            tris[:, 0] = slc.rows[tris[:, 0]]   # local -> global ids
            tris[:, 1] = slc.rows[tris[:, 1]]   # (z is already global)
            parts.append(tris)
        tris = np.concatenate(parts) if parts \
            else np.zeros((0, 3), np.int64)
        if self.device is not None:
            self.device.write_words(3 * len(tris))
        return tris

    def _list_sharded_binned(self, edge_lists, cap: int, source=None,
                             boxes=None) -> np.ndarray:
        """Sharded listing through the degree bins (the listing analogue
        of ``_count_sharded_binned``): one ``_list_pairs_chunked`` call per
        (bin_u, bin_v) width pair and shard, each shard holding only the
        bin rows its edges reference. The lane emits *global* (u, v, z)
        triangles directly; a pair whose exact total overflowed reruns
        at the doubled capacity."""
        row_bin, bins, bin_pos = self._binned_layout(source)
        per_shard = []
        for shard_boxes in self._schedule(edge_lists, boxes=boxes):
            if shard_boxes:
                eu = np.concatenate([edge_lists[b][0] for b in shard_boxes])
                ev = np.concatenate([edge_lists[b][1] for b in shard_boxes])
            else:
                eu = ev = np.zeros(0, np.int64)
            per_shard.append((eu, ev))
        self.stats.n_shards = len(per_shard)
        self.stats.shard_edges = [len(eu) for eu, _ in per_shard]
        pairs = set()
        for eu, ev in per_shard:
            if len(eu):
                live = (row_bin[eu] >= 0) & (row_bin[ev] >= 0)
                pairs |= set(zip(row_bin[eu[live]].tolist(),
                                 row_bin[ev[live]].tolist()))
        chunk = min(self.chunk, 1024)
        parts: List[np.ndarray] = []
        for (i, j) in sorted(pairs):
            npa_i, npb_j = bins[i][1], bins[j][1]
            calls = []
            for (eu, ev), dev in zip(per_shard, self.devices):
                sel = (row_bin[eu] == i) & (row_bin[ev] == j)
                if not sel.any():
                    continue
                eu_s, ev_s = eu[sel], ev[sel]
                ur, vr = np.unique(eu_s), np.unique(ev_s)
                calls.append(tuple(torch.from_numpy(x).to(dev) for x in (
                    npa_i[bin_pos[ur]], npb_j[bin_pos[vr]],
                    np.searchsorted(ur, eu_s), np.searchsorted(vr, ev_s),
                    eu_s, ev_s)))
            outs = [_list_pairs_chunked(*c, cap=cap, chunk=chunk)
                    for c in calls]
            cap_p = self._rescan_cap([t for t, _ in outs], cap)
            outs = [_list_pairs_chunked(*c, cap=cap_p, chunk=chunk)
                    if out[0] > cap else out for c, out in zip(calls, outs)]
            for total, buf in outs:
                if total:
                    parts.append(buf[:total].cpu().numpy().astype(np.int64))
        tris = np.concatenate(parts) if parts \
            else np.zeros((0, 3), np.int64)
        if self.device is not None:
            self.device.write_words(3 * len(tris))
        return tris

    @staticmethod
    def _canonical(tris: np.ndarray) -> np.ndarray:
        if len(tris) == 0:
            return np.zeros((0, 3), dtype=np.int64)
        tris = np.sort(np.asarray(tris, dtype=np.int64), axis=1)
        order = np.lexsort((tris[:, 2], tris[:, 1], tris[:, 0]))
        return tris[order]


def _rows_values(indptr: np.ndarray, indices: np.ndarray, rows: np.ndarray,
                 deg: np.ndarray) -> np.ndarray:
    """The neighbor lists of sorted ``rows`` (degrees ``deg``) of a CSR,
    concatenated, without a source read."""
    n = int(deg.sum())
    if n == 0:
        return np.zeros(0, np.int32)
    start = np.repeat(indptr[rows], deg)
    within = np.arange(n) - np.repeat(np.cumsum(deg) - deg, deg)
    return np.asarray(indices[start + within], np.int32)


# ---------------------------------------------------------------------------
# module-level conveniences
# ---------------------------------------------------------------------------

def engine_count(src, dst, **kw) -> int:
    return TriangleEngine(src, dst, **kw).count()


def engine_list(src, dst, **kw) -> np.ndarray:
    return TriangleEngine(src, dst, **kw).list()
