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

Out of core (``store=``), only the (V+1)-word degree index is resident and
every box's slice is read from the store, charged to a ``BlockDevice``.
With ``cache_words > 0`` the source is wrapped in an LRU
``core.executor.SliceCache``, so row blocks that adjacent boxes re-read
are served from host memory. ``TriangleEngine.ingest`` builds the store
itself with bounded memory (``data.edgestore.EdgeStoreWriter``).

The lanes run on ``torch_device``, which is the CUDA card unless the
caller asks for the CPU: there the dense, intersect and fused lanes launch
the hand-written CUDA kernels of ``kernels/``. Counts are int64 end to
end.

Usage::

    eng = TriangleEngine(src, dst, mem_words=1 << 16)        # on the card
    eng = TriangleEngine(src, dst, torch_device="cpu")       # on the CPU
    eng = TriangleEngine.ingest("graph.csr", (src, dst),     # out of core
                                mem_words=1 << 16, cache_words=1 << 14,
                                degree_bins=True)
    n   = eng.count()
    tri = eng.list()          # (n, 3) canonical (min, mid, max) rows
    eng.stats                 # boxes, lanes, padding, launches, block I/Os
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.edgestore import (EdgeStore, EdgeStoreWriter,
                                        InMemoryEdgeSource)
from repro_torch.data.pipeline import Prefetcher, edge_batches
from repro_torch.kernels.intersect import ops as intersect_ops

from .executor import SliceCache, StreamingExecutor
from .iomodel import BlockDevice
from .lftj_torch import (_count_rows_chunked, csr_from_edges, orient_edges,
                         pad_neighbors_binned)

BACKENDS = ("auto", "binary", "dense", "intersect", "host", "fused")

# dense-path feasibility guard: one-hot words per box (slice-scaled estimate)
_DENSE_WORDS_CAP = 64_000_000


def _not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"TriangleEngine: {feature} is not ported to repro_torch yet")


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
    # sharded-path shapes (not ported yet: always empty)
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
        lane.
    intersect_threshold : lower edge of the mid-density band 'auto' routes
        to the intersect kernel (only on the card). Default
        ``dense_threshold / 4``.
    fused_threshold : density above which 'auto' prefers the fused lane
        over the intersect band (only on the card). Default ``None`` keeps
        density dispatch off the fused lane (heavy/light hub boxes still
        route to it on the card).
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

    Options of the reference engine that are not ported yet raise
    ``NotImplementedError``: sharding (``shard=True``),
    ``tracer``/``metrics`` and the ``'measured'`` thresholds.
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
        for given, feature in (
                (shard is True, "sharded execution (shard=True)"),
                (tracer is not None, "tracer="),
                (metrics is not None, "metrics="),
                (dense_threshold == "measured", "dense_threshold='measured'"),
                (intersect_threshold == "measured",
                 "intersect_threshold='measured'"),
                (fused_threshold == "measured",
                 "fused_threshold='measured'")):
            if given:
                raise _not_ported(feature)
        # one torch device per engine: the reference's shard="auto" rule
        # (shard across more than one device) never fires
        if shard not in ("auto", False):
            raise ValueError(f"shard {shard!r} not in ('auto', False, True)")
        self.torch_device = resolve_torch_device(torch_device)
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
        self.dense_threshold = float(dense_threshold)
        # lower edge of the mid-density band 'auto' routes to the intersect
        # kernel (card only): the static crossover/4 by default
        self.intersect_threshold = self.dense_threshold / 4.0 \
            if intersect_threshold is None else float(intersect_threshold)
        # density gate of the fused lane (card only): None keeps density
        # dispatch off it; hub boxes still take it
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
            self._slice_cache = SliceCache(self.source, self.cache_words)
            self.source = self._slice_cache
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

    def _make_executor(self) -> StreamingExecutor:
        # total resident slice words of the parallel window are bounded by
        # window-size × per-box budget (each planned slice is itself under
        # mem_words, modulo pinned spill rows)
        inflight_words = self.inflight_boxes * self.mem_words \
            if self.mem_words is not None else None
        return StreamingExecutor(self.source,
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
                                 inflight_words=inflight_words)

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
        boxes = self.plan()
        self._reset_stats(len(boxes))
        mark = self._io_mark()
        ex = self._make_executor()
        if self.degree_bins and self.indices is not None:
            total = self._count_binned_boxes(boxes, ex)
        else:
            total = ex.run_count(boxes)
        self._io_collect(mark)
        return total

    def _box_edges_full(self, box):
        """In-box oriented edges (x ∈ [lx,hx], y ∈ [ly,hy]), the box widths
        and the raw x-range slab, so a follow-up
        ``StreamingExecutor.count_box`` reuses the already-charged read."""
        lx, hx, ly, hy = box
        lx_, hx_ = max(lx, 0), min(hx, self.nv - 1)
        ly_, hy_ = max(ly, 0), min(hy, self.nv - 1)
        if hx_ < lx_ or hy_ < ly_:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64), 0, 0, None)
        ip, vals = self.source.read_rows(lx_, hx_)
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

    def list(self, capacity: Optional[int] = None) -> np.ndarray:
        """Enumerate all triangles; returns canonical sorted (m, 3) rows.

        The output buffer is bounded (``capacity`` triangles per box);
        because the lanes return the *exact* total alongside the buffer,
        overflow is detected and resolved by rescanning with the capacity
        doubled until everything fits. Listing never bins.
        """
        boxes = self.plan()
        self._reset_stats(len(boxes))
        mark = self._io_mark()
        tris = self._make_executor().run_list(boxes, capacity)
        self._io_collect(mark)
        return self._canonical(tris)

    @staticmethod
    def _canonical(tris: np.ndarray) -> np.ndarray:
        if len(tris) == 0:
            return np.zeros((0, 3), dtype=np.int64)
        tris = np.sort(np.asarray(tris, dtype=np.int64), axis=1)
        order = np.lexsort((tris[:, 2], tris[:, 1], tris[:, 0]))
        return tris[order]


# ---------------------------------------------------------------------------
# module-level conveniences
# ---------------------------------------------------------------------------

def engine_count(src, dst, **kw) -> int:
    return TriangleEngine(src, dst, **kw).count()


def engine_list(src, dst, **kw) -> np.ndarray:
    return TriangleEngine(src, dst, **kw).list()
