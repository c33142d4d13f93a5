"""QueryEngine: boxed, multi-worker LFTJ for conjunctive queries on a torch
device.

The generic counterpart of ``core.engine.TriangleEngine``: any validated
``core.queries.Query`` over *binary* relations (graph patterns: 4-cliques,
diamonds, paths, cycles — and the triangle as a special case) executes
through the same boxed machinery the triangle engine uses:

* **planning** — ``query.planner.plan_query_boxes`` cuts the n-dimensional
  variable space into boxes from the *resident degree indexes* alone
  (never touching the neighbor streams), budgeted per Thm. 13's rank-r
  bound. The triangle special case reproduces the triangle planner's boxes
  cut for cut.
* **fetching** — per box, each owned dimension's row ranges are read
  through the relation's ``EdgeSource`` (``data.edgestore.EdgeStore`` on
  disk, ``InMemoryEdgeSource`` in RAM, optionally behind a
  ``core.executor.SliceCache``), with already-covered intervals deduped
  (§5 slice sharing) and a full-conjunctive early exit: an atom whose
  box-restricted slice is empty kills the box before further reads. With
  a charged ``core.iomodel.BlockDevice`` the reads are the reference's,
  block for block.
* **executing** — ``query.vectorized.VectorizedBoxJoin`` runs the batched
  leapfrog over the per-atom slices (numpy ``searchsorted`` lanes that
  release the GIL); the innermost two-atom intersection goes to the
  ``kernels/intersect`` CUDA kernel and hub boxes whole to the
  ``kernels/lftj_fused`` kernels, on ``torch_device``.
* **scheduling** — boxes drain on the shared worker pool
  (``core.executor.run_box_queue``) under the workers=1-oracle determinism
  contract: serialized fetches in queue order, fixed box-order reduction,
  in-flight (boxes, words) window.

Usage::

    from repro_torch.query import QueryEngine, patterns

    eng = QueryEngine.from_graph(patterns.four_clique(), src, dst,
                                 mem_words=1 << 16)          # on the card
    n   = eng.count()
    eng = QueryEngine(patterns.diamond(), store="graph.csr",
                      mem_words=1 << 16, cache_words=1 << 14)
    rows = eng.list()              # (m, 4) bindings in head order
    eng.stats                      # boxes, rank, lanes, launches, I/O, cache

``tracer=`` (an ``obs.trace.Tracer``) records ``query.plan`` and
``query.boxes`` spans, ``box.fetch`` / ``box.build`` / ``box.compute``
spans per box and ``kernel.launch`` / ``cache.*`` events; ``metrics=`` (an
``obs.metrics.MetricsRegistry``) gets the ``kernel.*`` and ``box.*`` series
and the run's ``QueryStats`` as ``query.*`` gauges. Every option of the
reference engine is ported.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import resolve_torch_device
from repro_torch.core.executor import (SliceCache, _pow2,
                                       merge_queue_telemetry, run_box_queue,
                                       run_box_serial)
from repro_torch.core.iomodel import BlockDevice
from repro_torch.core.leapfrog import Atom
from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
from repro_torch.core.queries import Query, is_consistent, validate
from repro_torch.data.edgestore import EdgeStore, InMemoryEdgeSource
from repro_torch.data.graphs import unique_pairs
from repro_torch.kernels import ledger as kernel_ledger
from repro_torch.parallel.sharding import (box_queue_order, interval_gaps,
                                           merge_interval)

from .planner import QueryPlan, plan_query_boxes
from .vectorized import BoundAtom, VectorizedBoxJoin, build_atom_slice

# the reference's TPU-named "pallas" backend is the intersect kernel here
BACKENDS = ("auto", "host", "intersect", "fused")


@dataclass
class QueryStats:
    """One ``count()`` / ``list()`` run of the QueryEngine, faithfully:
    plan size and rank, backend lane mix, streaming working-set peaks,
    measured block I/O, and the shared box-scheduler telemetry (the
    ``merge_queue_telemetry`` contract)."""

    order: Tuple[str, ...] = ()
    rank: int = 0
    n_boxes: int = 0
    n_results: int = 0
    n_rescans: int = 0                 # bounded-listing overflow rescans
    # skew-aware planning (skew="heavy_light"): the plan's lane mix
    skew: str = "uniform"
    heavy_threshold: int = 0
    n_hub_boxes: int = 0
    n_light_boxes: int = 0
    n_mixed_boxes: int = 0
    # per-box execution
    n_streamed_boxes: int = 0
    slice_words_read: int = 0          # raw CSR words fetched across boxes
    max_slice_words: int = 0           # largest single-box fetch
    max_frontier: int = 0              # peak binding-frontier rows
    n_kernel_boxes: int = 0            # innermost pair on kernels/intersect
    n_host_boxes: int = 0              # innermost stage on the host lane
    n_fused_boxes: int = 0             # whole box on the fused lane
    # per-box device ledger (kernels/ledger): launches + transfer bytes
    # across every kernel lane; the bytes are the port's own account
    device_invocations: int = 0
    device_transfer_bytes: int = 0
    max_box_device_invocations: int = 0
    # async scheduler (workers > 1)
    n_workers: int = 1
    inflight_boxes: int = 0
    queue_wait_s: float = 0.0
    build_s: float = 0.0
    compute_s: float = 0.0
    overlap_s: float = 0.0
    # busy/(pool*wall); None when the run was too short to measure
    # (wall == 0 at perf_counter granularity) — see merge_queue_telemetry
    worker_utilization: Optional[float] = None
    max_inflight_boxes: int = 0
    max_inflight_words: int = 0
    # measured block I/O on the attached BlockDevice
    block_reads: int = 0
    block_writes: int = 0
    word_reads: int = 0
    # LRU slice cache (cache_words > 0), summed over the relations' caches
    cache_hits: int = 0
    cache_misses: int = 0
    cache_hit_words: int = 0
    source: str = "memory"

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0


@dataclass
class _AtomMeta:
    """A resolved body atom: relation source key + dims in the order."""

    idx: int
    key: str                           # key into the engine's source table
    vars: Tuple[str, str]
    first_dim: int
    second_dim: int
    direction: int                     # +1: val0 < val1 on every tuple,
    #                                    -1: reversed index of one, 0: unknown


def _extract_rows(slabs: List[Tuple[int, int, np.ndarray, np.ndarray]],
                  lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """(local indptr, values) of rows [lo, hi] out of covering slabs."""
    parts_ip, parts_v = [], []
    for slo, shi, ip, vals in sorted(slabs, key=lambda s: s[0]):
        a, b = max(lo, slo), min(hi, shi)
        if b < a:
            continue
        s, e = int(ip[a - slo]), int(ip[b - slo + 1])
        parts_ip.append(np.diff(ip[a - slo:b - slo + 2]))
        parts_v.append(vals[s:e])
    if not parts_ip:
        return np.zeros(1, np.int64), np.zeros(0, np.int32)
    deg = np.concatenate(parts_ip)
    ip_out = np.concatenate([np.zeros(1, np.int64),
                             np.cumsum(deg, dtype=np.int64)])
    return ip_out, np.concatenate(parts_v)


class QueryEngine:
    """Boxed execution of a binary-atom conjunctive query on a torch device.

    Parameters
    ----------
    query : a ``core.queries.Query`` whose atoms are all binary (graph
        patterns); general-arity queries stay on the scalar
        ``core.queries.run_query`` reference path.
    relations : mapping relation name -> source: an ``EdgeStore`` (or a
        path to one), an ``InMemoryEdgeSource``, or a ``(src, dst)`` pair
        of *directed* edge arrays. Use ``from_graph`` to orient an
        undirected graph the way ``TriangleEngine`` does. An entry
        ``"<rel>~rev"`` supplies the reversed index of an atom
        inconsistent with the order instead of deriving it.
    store : shortcut for single-relation queries: the one relation name
        maps to this edge store path or instance.
    order : variable order; default = the minimum-rank order
        (``core.queries.best_order``), restricted to orders keeping every
        atom consistent when any relation is store-backed (reordered
        indexes need the relation in memory).
    mem_words : box-planner budget; ``None`` = one box.
    cache_words : per-relation LRU ``SliceCache`` budget (0 disables).
    device : ``core.iomodel.BlockDevice`` charging source reads; defaults
        to a fresh device for store-backed runs (block size
        ``io_block_words``), ``None`` (no accounting) in memory.
    backend : 'auto', 'host' (pure numpy), 'intersect' (force the
        ``kernels/intersect`` lowering of the innermost two-atom step) or
        'fused' (force whole-box dispatch to the ``kernels/lftj_fused``
        kernels — one device invocation per box; boxes outside their
        envelope fall back to the staged path).
    use_kernels : with ``backend='auto'``, route as the reference does on
        its accelerator (default True): the innermost pair of non-light
        boxes to the intersect kernel for counts, hub boxes to the fused
        lane. False routes every 'auto' box to the host lane, as the
        reference does off the TPU.
    torch_device : where the kernel lanes run: ``"cuda"`` (default; raises
        when no CUDA device is available) or ``"cpu"``, where the kernel
        wrappers run their plain torch versions.
    workers / inflight_boxes / prefetch_depth : the shared box scheduler
        knobs — identical semantics to ``TriangleEngine``.
    dim_ratio : per-variable budget weights for the §5 split (default:
        4:1 in favour of the first owned dimension).
    skew : 'uniform' (default) or 'heavy_light': break each owned
        dimension's cuts at heavy/light class transitions
        (``query.planner``), carry a lane per box, and route hub boxes
        whole to the fused lane (with ``use_kernels``) while light/mixed
        boxes stay on the host searchsorted lane.
    heavy_threshold : hub degree cut for ``skew='heavy_light'``; default
        √(2·Σdeg)-style per owned dimension.
    plan : a previously computed ``QueryPlan`` for this (query, sources,
        mem_words, skew) — skips re-planning (``convert`` carries the
        reference's plan in this way).
    cancel : optional ``threading.Event``; once set, no further box is
        claimed, in-progress boxes finish, and the run raises
        ``core.executor.BoxQueueCancelled``.
    tracer / metrics : optional ``obs.trace.Tracer`` and
        ``obs.metrics.MetricsRegistry`` (see the module note); read-only,
        so counts, listings and ledgers are unchanged.
    """

    def __init__(self, query: Query, *,
                 relations: Optional[Dict[str, object]] = None,
                 store=None,
                 order: Optional[Sequence[str]] = None,
                 mem_words: Optional[int] = None,
                 cache_words: int = 0,
                 device: Optional[BlockDevice] = None,
                 io_block_words: int = 4096,
                 backend: str = "auto",
                 workers: int = 1,
                 inflight_boxes: Optional[int] = None,
                 prefetch_depth: int = 2,
                 dim_ratio: Optional[Dict[str, float]] = None,
                 chunk_entries: int = 4_000_000,
                 skew: str = "uniform",
                 heavy_threshold: Optional[int] = None,
                 plan: Optional[QueryPlan] = None,
                 cancel: Optional[threading.Event] = None,
                 use_kernels: bool = True,
                 torch_device="cuda",
                 tracer=None,
                 metrics=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if skew not in ("uniform", "heavy_light"):
            raise ValueError(
                f"skew {skew!r} not in ('uniform', 'heavy_light')")
        for a in query.atoms:
            if len(a.vars) != 2:
                raise ValueError(
                    f"atom {a.rel}{a.vars}: QueryEngine executes binary "
                    "(graph-pattern) atoms; use core.queries.run_query for "
                    "general arities")
        self.query = query
        # observability: span/event recorder and metrics registry, both
        # None by default (one attribute check per site)
        self.tracer = tracer
        self.metrics = metrics
        self.backend = backend
        self.mem_words = mem_words
        self.cache_words = int(cache_words)
        self.dim_ratio = dim_ratio
        self.chunk_entries = int(chunk_entries)
        self.skew = skew
        self.heavy_threshold = heavy_threshold
        self._lane: Dict[object, str] = {}
        self.workers = max(1, int(workers))
        self.inflight_boxes = max(1, int(inflight_boxes)) \
            if inflight_boxes is not None else max(2, 2 * self.workers)
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.use_kernels = bool(use_kernels)
        self.torch_device = resolve_torch_device(torch_device)

        # -- resolve relation sources ------------------------------------
        rel_names: List[str] = []
        for a in query.atoms:
            if a.rel not in rel_names:
                rel_names.append(a.rel)
        if store is not None:
            if relations is not None:
                raise ValueError("pass either relations= or store=, not both")
            if len(rel_names) != 1:
                raise ValueError(
                    f"store= shorthand needs a single-relation query; this "
                    f"one uses {rel_names}")
            relations = {rel_names[0]: store}
        if relations is None:
            raise ValueError("QueryEngine needs relations= or store=")
        missing = [r for r in rel_names if r not in relations]
        if missing:
            raise ValueError(f"no source given for relation(s) {missing}")

        raw: Dict[str, object] = {}
        any_store = False
        for name in rel_names:
            src = relations[name]
            if isinstance(src, (str, os.PathLike)):
                src = EdgeStore(src)
            if isinstance(src, EdgeStore):
                any_store = True
            elif not (isinstance(src, tuple) and len(src) == 2) \
                    and not hasattr(src, "read_rows"):
                raise ValueError(
                    f"relation {name!r}: unsupported source {type(src)}")
            raw[name] = src
        if device is None and any_store:
            cache = max(2, (mem_words or (1 << 22)) // io_block_words)
            device = BlockDevice(block_words=io_block_words,
                                 cache_blocks=cache)
        self.device = device
        for name, src in raw.items():
            if isinstance(src, EdgeStore):
                if device is not None:
                    src.attach_device(device)
                continue
            if isinstance(src, tuple):
                # deduplicate the directed pairs: set semantics, matching
                # the TrieArray reference path (and from_graph's
                # orient_edges) so scalar run_query and the engine agree
                u = np.asarray(src[0], dtype=np.int64)
                v = np.asarray(src[1], dtype=np.int64)
                nv = int(max(u.max(initial=-1), v.max(initial=-1))) + 1
                if len(u):
                    u, v = unique_pairs(u, v)
                ip, ix = csr_from_edges(u, v, n_nodes=nv) if nv else \
                    (np.zeros(1, np.int64), np.zeros(0, np.int32))
                # the device (given or store-created) charges these reads
                # too — the ledger stays symmetric with reversed indexes
                raw[name] = InMemoryEdgeSource(ip, ix, orientation="raw",
                                               device=device)
        # pre-seeded reversed indexes: a relations entry "<rel>~rev"
        # supplies the reordered index of an order-inconsistent atom
        # directly, skipping ``_reversed_source``
        for name, src in relations.items():
            if not name.endswith("~rev") or name in raw:
                continue
            if name[:-len("~rev")] not in rel_names:
                raise ValueError(
                    f"reversed-index source {name!r} matches no relation "
                    f"of this query ({rel_names})")
            if not hasattr(src, "read_rows"):
                raise ValueError(
                    f"reversed-index source {name!r}: unsupported source "
                    f"{type(src)} (needs the EdgeSource interface)")
            raw[name] = src
        self._any_store = any_store

        # -- resolve the variable order and per-atom metadata -------------
        self.order = validate(query, order, require_consistent=any_store)
        self.n = len(self.order)
        pos = {v: i for i, v in enumerate(self.order)}
        # every registered source, unwrapped (derived reversed indexes land
        # here too): the fabric ships shard slices out of these
        self._raw = raw
        metas: List[_AtomMeta] = []
        for i, a in enumerate(query.atoms):
            ori = getattr(raw[a.rel], "orientation", "raw")
            if is_consistent(a, self.order):
                key, vars_, direction = a.rel, tuple(a.vars), \
                    (1 if ori == "minmax" else 0)
            else:
                key = f"{a.rel}~rev"
                vars_ = (a.vars[1], a.vars[0])
                direction = -1 if ori == "minmax" else 0
                if key not in raw:
                    raw[key] = self._reversed_source(raw[a.rel])
            metas.append(_AtomMeta(i, key, vars_, pos[vars_[0]],
                                   pos[vars_[1]], direction))
        self._atoms = metas
        self._owned: List[List[_AtomMeta]] = [[] for _ in range(self.n)]
        for m in metas:
            self._owned[m.first_dim].append(m)

        # -- cache wrap ---------------------------------------------------
        self._caches: List[SliceCache] = []
        self._sources: Dict[str, object] = {}
        used_keys = {m.key for m in metas}
        for key in list(raw):
            if key not in used_keys:
                continue
            src = raw[key]
            if self.cache_words > 0:
                src = SliceCache(src, self.cache_words, tracer=tracer)
                self._caches.append(src)
            self._sources[key] = src
        self._nv_all = max((s.n_nodes for s in self._sources.values()),
                           default=0)
        # plan injection: planning inputs (degree indexes, budget, skew)
        # must match the plan's
        self._plan_cache: Optional[Tuple[Optional[int], QueryPlan]] = \
            (mem_words, plan) if plan is not None else None
        self.cancel = cancel
        self._stats_lock = threading.Lock()
        self.stats = QueryStats(order=self.order)

    # -- construction helpers -------------------------------------------------

    @classmethod
    def from_graph(cls, query: Query, src, dst, *,
                   orientation: str = "minmax", **kw) -> "QueryEngine":
        """Engine over one undirected graph: orient (exactly as
        ``TriangleEngine`` does), build the CSR source, and bind it to the
        query's single relation name."""
        rel_names = {a.rel for a in query.atoms}
        if len(rel_names) != 1:
            raise ValueError(
                f"from_graph needs a single-relation query; got {rel_names}")
        a, b = orient_edges(np.asarray(src), np.asarray(dst), orientation)
        nv = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
        ip, ix = csr_from_edges(a, b, n_nodes=nv) if nv else \
            (np.zeros(1, np.int64), np.zeros(0, np.int32))
        source = InMemoryEdgeSource(ip, ix, orientation=orientation)
        return cls(query, relations={rel_names.pop(): source}, **kw)

    def _reversed_source(self, src) -> InMemoryEdgeSource:
        """In-memory reversed index R(y, x) for an inconsistent atom.

        The reversed CSR is memoized on the source object (the analogue of
        ``core.queries.reordered_index`` at the EdgeSource layer), so
        repeated engines over the same relation re-sort once."""
        if isinstance(src, EdgeStore):
            raise ValueError(
                "an atom inconsistent with the variable order needs a "
                "reordered index, which requires the relation in memory; "
                "choose a consistent order or load the store's edges")
        csr = getattr(src, "_reverse_csr", None)
        if csr is None:
            indptr = np.asarray(src.indptr, dtype=np.int64)
            indices = np.asarray(src.indices, dtype=np.int64)
            rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                             np.diff(indptr))
            nv = max(src.n_nodes, int(indices.max(initial=-1)) + 1)
            csr = csr_from_edges(indices, rows, n_nodes=nv)
            src._reverse_csr = csr
        return InMemoryEdgeSource(csr[0], csr[1], orientation="raw",
                                  device=self.device)

    # -- planning -------------------------------------------------------------

    def plan(self) -> QueryPlan:
        """The n-dimensional box plan (cached per ``mem_words``), derived
        from the resident degree indexes only."""
        if self._plan_cache is not None \
                and self._plan_cache[0] == self.mem_words:
            plan = self._plan_cache[1]
        elif self.tracer is not None:
            with self.tracer.span("query.plan", n_vars=self.n,
                                  skew=self.skew):
                plan = self._plan_uncached()
            self._plan_cache = (self.mem_words, plan)
        else:
            plan = self._plan_uncached()
            self._plan_cache = (self.mem_words, plan)
        self._lane = dict(zip(plan.boxes, plan.lanes)) \
            if plan.lanes else {}
        return plan

    def _plan_uncached(self) -> QueryPlan:
        atoms = [Atom(m.key, m.vars) for m in self._atoms]
        directions = {m.idx: m.direction for m in self._atoms}
        rel_indptr = {k: np.asarray(s.indptr)
                      for k, s in self._sources.items()}
        plan = plan_query_boxes(atoms, self.order, rel_indptr,
                                self.mem_words, dim_ratio=self.dim_ratio,
                                directions=directions,
                                skew=self.skew,
                                heavy_threshold=self.heavy_threshold)
        if self._nv_all == 0 or all(s.n_edges == 0
                                    for s in self._sources.values()):
            plan.boxes = []
            plan.lanes = []
        return plan

    # -- per-box stages (fetch serialized; build/work parallel) ----------------

    def _est_box_words(self, box) -> int:
        """Raw words ``_fetch_box`` will read: the same per-dimension gap
        walk over the resident degree indexes, without the reads."""
        covered: Dict[str, List[Tuple[int, int]]] = {}
        words = 0
        for d in range(self.n):
            atoms_d = self._owned[d]
            if not atoms_d:
                continue
            lo, hi = box[d]
            for key in self._dim_keys(atoms_d):
                src = self._sources[key]
                ip = np.asarray(src.indptr)
                lo_, hi_ = max(int(lo), 0), min(int(hi), src.n_nodes - 1)
                if hi_ < lo_:
                    continue
                for glo, ghi in interval_gaps(covered.get(key, []),
                                              lo_, hi_):
                    words += int(ip[ghi + 1] - ip[glo])
                covered[key] = merge_interval(covered.get(key, []),
                                              lo_, hi_)
        return words

    @staticmethod
    def _dim_keys(atoms_d: Sequence[_AtomMeta]) -> List[str]:
        keys: List[str] = []
        for m in atoms_d:
            if m.key not in keys:
                keys.append(m.key)
        return keys

    def _fetch_box(self, box):
        """All source reads of one box (the serialized scheduler stage),
        dim by dim with §5 interval dedup, plus the per-atom slice builds
        needed for the full-conjunctive early exit: an empty atom slice
        stops the box before any later dimension is read — exactly the
        triangle executor's read stream on the triangle query. Returns
        ``(payload, words_read)``; payload ``None`` for an empty box."""
        slabs: Dict[str, list] = {}
        covered: Dict[str, List[Tuple[int, int]]] = {}
        slices: Dict[int, object] = {}
        words = 0
        for d in range(self.n):
            atoms_d = self._owned[d]
            if not atoms_d:
                continue
            lo, hi = box[d]
            for key in self._dim_keys(atoms_d):
                src = self._sources[key]
                lo_, hi_ = max(int(lo), 0), min(int(hi), src.n_nodes - 1)
                if hi_ < lo_:
                    continue
                for glo, ghi in interval_gaps(covered.get(key, []),
                                              lo_, hi_):
                    ip, vals = src.read_rows(glo, ghi)
                    slabs.setdefault(key, []).append((glo, ghi, ip, vals))
                    words += len(vals)
                covered[key] = merge_interval(covered.get(key, []),
                                              lo_, hi_)
            for m in atoms_d:
                src = self._sources[m.key]
                lo_, hi_ = max(int(lo), 0), min(int(hi), src.n_nodes - 1)
                if hi_ < lo_:
                    return None, words
                ip, vals = _extract_rows(slabs.get(m.key, []), lo_, hi_)
                l2, h2 = box[m.second_dim]
                slc = build_atom_slice(
                    ip, vals, lo_,
                    val_lo=int(l2) if l2 > 0 else None,
                    val_hi=int(h2) if h2 < self._nv_all - 1 else None)
                if slc.n_keys == 0:
                    return None, words
                slices[m.idx] = slc
        return (box, slices, words), words

    def _build_box(self, payload):
        """Assemble the box's work item (parallel stage; no source access)."""
        if payload is None:
            return None
        box, slices, words = payload
        s = self.stats
        with self._stats_lock:
            s.n_streamed_boxes += 1
            s.slice_words_read += words
            s.max_slice_words = max(s.max_slice_words, words)
        bound = [BoundAtom(m.first_dim, m.second_dim, slices[m.idx])
                 for m in self._atoms]
        return (box, bound)

    def _make_join(self, bound, mode: str, lane: Optional[str] = None,
                   capacity: Optional[int] = None) -> VectorizedBoxJoin:
        # heavy_light lane routing: hub boxes dispatch whole to the fused
        # lane, falling back per box to the staged path when outside its
        # envelope; light and mixed boxes are pinned to the host
        # searchsorted lane. backend="fused" forces the fused lane for
        # every box.
        fused = self.backend == "fused" or (
            self.backend == "auto" and self.use_kernels and lane == "hub")
        kernel_lane = self.backend == "intersect" or (
            self.backend == "auto" and self.use_kernels
            and lane not in ("light", "mixed"))
        return VectorizedBoxJoin(
            bound, self.n, mode,
            kernel_lane=kernel_lane and mode == "count",
            torch_device=self.torch_device,
            device="fused" if fused else "host",
            chunk_entries=self.chunk_entries,
            capacity=capacity)

    def _note_join(self, vj: VectorizedBoxJoin,
                   kl: kernel_ledger.KernelLedger) -> None:
        with self._stats_lock:
            self.stats.max_frontier = max(self.stats.max_frontier,
                                          vj.max_frontier)
            if vj.used_fused:
                self.stats.n_fused_boxes += 1
            elif vj.used_kernel:
                self.stats.n_kernel_boxes += 1
            else:
                self.stats.n_host_boxes += 1
            if kl.invocations:
                self.stats.device_invocations += kl.invocations
                self.stats.device_transfer_bytes += kl.transfer_bytes
                self.stats.max_box_device_invocations = max(
                    self.stats.max_box_device_invocations, kl.invocations)
        if self.metrics is not None:
            self.metrics.note_kernel(kl, op=self._join_op(vj))

    @staticmethod
    def _join_op(vj: VectorizedBoxJoin) -> str:
        """The ``kernel.*{op=..}`` label of a finished box join: the lane
        that actually ran, fallbacks resolved."""
        if vj.used_fused:
            return "fused"
        if vj.used_kernel:
            return "staged"
        return "host"

    def _work_count(self, built) -> int:
        box, bound = built
        vj = self._make_join(bound, "count", lane=self._lane.get(box))
        with kernel_ledger.attach(tracer=self.tracer) as kl:
            out = vj.run()
        self._note_join(vj, kl)
        return out

    def _work_list(self, built,
                   capacity: Optional[int] = None) -> Optional[np.ndarray]:
        """One box's bindings through the bounded buffer: at most ``cap``
        rows are materialized per pass; the join's exact count detects
        overflow, which rescans *this box* at doubled capacity (the
        triangle executor's box-granular overflow→rescan protocol)."""
        box, bound = built
        cap = capacity
        with kernel_ledger.attach(tracer=self.tracer) as kl:
            while True:
                vj = self._make_join(bound, "list",
                                     lane=self._lane.get(box),
                                     capacity=cap)
                total = vj.run()
                if cap is None or total <= cap:
                    break
                with self._stats_lock:
                    self.stats.n_rescans += 1
                cap *= 2
        self._note_join(vj, kl)
        rows = vj.bindings()
        if len(rows) == 0:
            return None
        if self.device is not None:
            self.device.write_words(rows.size)
        return rows

    # -- run plumbing ----------------------------------------------------------

    def _reset_stats(self, plan: QueryPlan) -> None:
        self.stats = QueryStats(order=self.order, rank=plan.rank,
                                n_boxes=len(plan.boxes),
                                n_workers=self.workers,
                                skew=self.skew,
                                heavy_threshold=plan.heavy_threshold,
                                n_hub_boxes=plan.lanes.count("hub"),
                                n_light_boxes=plan.lanes.count("light"),
                                n_mixed_boxes=plan.lanes.count("mixed"),
                                source="edgestore" if self._any_store
                                else "memory")

    def _io_mark(self):
        cm = [(c.hits, c.misses, c.hit_words) for c in self._caches]
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
        for cache, (h, m, w) in zip(self._caches, cm):
            self.stats.cache_hits += cache.hits - h
            self.stats.cache_misses += cache.misses - m
            self.stats.cache_hit_words += cache.hit_words - w

    def _queue_order(self, boxes) -> List[int]:
        ledger = bool(self._caches) or any(
            getattr(s, "device", None) is not None
            for s in self._sources.values())
        return box_queue_order([self._est_box_words(b) for b in boxes],
                               ledger_sensitive=ledger)

    def default_list_capacity(self) -> Optional[int]:
        """The bounded-buffer per-box listing capacity ``list()`` derives
        from the memory budget (the output buffer is part of the §5
        working set); ``None`` when no budget is set."""
        if self.mem_words is None:
            return None
        return _pow2(max(256, self.mem_words // max(1, self.n)))

    def head_columns(self, rows: np.ndarray) -> np.ndarray:
        """Project raw binding rows (variable-order columns) to the
        query's head order — the last step of ``list()``."""
        head_cols = [self.order.index(h) for h in self.query.head]
        return rows[:, head_cols]

    # -- serving-layer hooks ------------------------------------------------
    # a serving layer drives the engine's per-box stages through its own
    # run_box_queue round (fault capture, I/O attribution, result
    # streaming); these public accessors are that contract — the stages
    # themselves stay the single implementation.

    def queue_order(self, boxes) -> List[int]:
        """Queue drain order for ``boxes`` (``sharding.box_queue_order``
        policy: plan order whenever an I/O ledger is attached)."""
        return self._queue_order(boxes)

    def box_stages(self, mode: str, capacity: Optional[int] = None):
        """``(est_words, fetch, build, work)`` stage callables for
        ``run_box_queue`` — ``mode`` 'count' or 'list'; ``capacity`` is
        the bounded-listing per-box buffer (None = unbounded)."""
        if mode == "count":
            work = self._work_count
        elif mode == "list":
            work = lambda built: self._work_list(built, capacity)  # noqa: E731
        else:
            raise ValueError(f"mode {mode!r} not in ('count', 'list')")
        return self._est_box_words, self._fetch_box, self._build_box, work

    def io_mark(self):
        """Snapshot of the device + cache counters (pair with
        ``io_collect``). Only meaningful when this engine is the device's
        sole client in the window."""
        return self._io_mark()

    def io_collect(self, mark) -> None:
        self._io_collect(mark)

    # -- fabric hooks -------------------------------------------------------
    # ``parallel.fabric`` plans once on a full-source engine, ships each
    # shard only the byte ranges its boxes touch, and re-runs a restricted
    # plan per shard; these accessors expose exactly the plan inputs that
    # shipping needs (relation keys incl. reversed indexes, which dimension
    # provisions which key) without reaching into privates.

    def source_keys(self) -> List[str]:
        """Relation source keys actually read by this engine's atoms, in
        registration order — forward relation names plus any derived
        ``"<rel>~rev"`` reversed indexes."""
        return list(self._sources)

    def source_for(self, key: str):
        """The (possibly cache-wrapped) EdgeSource behind ``key``; the
        unwrapped source is at ``.source`` when a cache is attached."""
        return self._sources[key]

    def owned_dim_keys(self) -> List[Tuple[int, List[str]]]:
        """Per owned dimension, the distinct relation keys whose rows it
        provisions — the ``dim_keys`` input of the fabric's
        ``sharding.box_mass_costs_nd`` / ``shard_shipped_ranges``."""
        return [(d, self._dim_keys(self._owned[d]))
                for d in range(self.n) if self._owned[d]]

    def _run(self, boxes, work) -> List:
        """Per-box results in plan order — serial Prefetcher pipeline for
        ``workers=1`` (the oracle), the shared pool otherwise."""
        if self.workers > 1 and len(boxes) > 1:
            inflight_words = self.inflight_boxes * self.mem_words \
                if self.mem_words is not None else None
            results, tele = run_box_queue(
                boxes, order=self._queue_order(boxes),
                est_words=self._est_box_words,
                fetch=self._fetch_box,
                build=self._build_box,
                work=work,
                workers=self.workers,
                inflight_items=self.inflight_boxes,
                inflight_words=inflight_words,
                cancel=self.cancel,
                tracer=self.tracer)
            merge_queue_telemetry(self.stats, tele, self._stats_lock,
                                  inflight_boxes=self.inflight_boxes,
                                  metrics=self.metrics)
            return results
        return run_box_serial(boxes, fetch=self._fetch_box,
                              build=self._build_box, work=work,
                              prefetch_depth=self.prefetch_depth,
                              cancel=self.cancel,
                              tracer=self.tracer)

    def run_boxes(self, mode: str = "count",
                  capacity: Optional[int] = None) -> List:
        """Execute the plan and return PER-BOX results in plan order
        (``None`` for empty boxes): counts for ``mode='count'``, raw
        binding rows (variable-order columns, unprojected) for
        ``mode='list'``. ``count()`` and ``list()`` reduce them in plan
        order; so does ``parallel.fabric`` across shards, in global box
        order, which keeps a distributed run byte-identical to this
        engine's."""
        plan = self.plan()
        self._reset_stats(plan)
        if mode == "count":
            work = self._work_count
        elif mode == "list":
            cap0 = capacity if capacity is not None \
                else self.default_list_capacity()
            work = lambda built: self._work_list(built, cap0)  # noqa: E731
        else:
            raise ValueError(f"mode {mode!r} not in ('count', 'list')")
        mark = self._io_mark()
        if self.tracer is not None:
            with self.tracer.span("query.boxes", mode=mode,
                                  n_boxes=len(plan.boxes)):
                results = self._run(plan.boxes, work)
        else:
            results = self._run(plan.boxes, work)
        self._io_collect(mark)
        if mode == "count":
            self.stats.n_results = sum(int(r) for r in results
                                       if r is not None)
        else:
            self.stats.n_results = sum(len(r) for r in results
                                       if r is not None)
        if self.metrics is not None:
            self.metrics.publish_stats(self.stats, "query", mode=mode)
        return results

    # -- public entry points ----------------------------------------------------

    def count(self) -> int:
        self.run_boxes("count")
        return self.stats.n_results

    def list(self, capacity: Optional[int] = None) -> np.ndarray:
        """All result bindings as an (m, len(head)) int64 array, columns in
        the query's head order (bag semantics: one row per LFTJ binding).

        Per-box result buffers are *bounded*: at most ``capacity`` rows
        materialize per box pass (default derived from ``mem_words`` —
        the output buffer is part of the §5 working set). A box whose
        exact count exceeds the buffer rescans at doubled capacity
        (``stats.n_rescans``), so results stay complete and deterministic
        while peak result memory respects the budget."""
        results = self.run_boxes("list", capacity)
        parts = [r for r in results if r is not None]
        rows = np.concatenate(parts) if parts \
            else np.zeros((0, self.n), dtype=np.int64)
        return self.head_columns(rows)


def query_count(query: Query, src, dst, **kw) -> int:
    """One-shot: count a pattern on an undirected graph (minmax DAG)."""
    return QueryEngine.from_graph(query, src, dst, **kw).count()
