"""Distributed multi-device box fabric for the ``QueryEngine``.

The worker pool parallelizes one host; this module is the cross-device
tier the paper points at ("the single-thread gap ... can be alleviated by
parallelization"): the n-dimensional ``QueryPlan`` box list is partitioned
into shards, each shard receives ONLY the edge-store byte ranges its boxes
touch, and every shard re-runs the restricted plan through an ordinary
single-host ``QueryEngine`` — so the whole distributed run inherits the
engine's workers=1 oracle contract instead of inventing a new execution
path.

Layout (``Fabric.layout``)
    One *planner* engine over the full sources computes the box plan;
    ``sharding.box_mass_costs_nd`` prices every box in raw CSR words from
    the resident degree indexes, ``balanced_box_schedule`` LPT-packs boxes
    onto ``n_shards`` shards (each shard's box ids then sorted back to
    plan order), and ``sharding.shard_shipped_ranges`` derives, per shard
    and relation key (including derived ``~rev`` reversed indexes), the
    disjoint vertex-row intervals whose neighbor bytes must ship.

Shipping (``ShippedEdgeSource``)
    A shard-local EdgeSource holding the FULL resident ``indptr`` but only
    the shipped value ranges (the backing array is allocated full-length
    and zero-filled — the OS commits pages lazily, so resident memory
    scales with the shipped bytes). Its ``read_rows`` charges the shard's
    fresh ``BlockDevice`` with byte-identical block addresses to the
    original source (chunked charging for a store base, one read for an
    in-memory base), and raises ``FabricShippingError`` on any read
    outside the shipped intervals — under-shipping is loud, never wrong.

Determinism / oracle contract
    Per shard, the restricted plan + shipped sources + a fresh device
    reproduce, byte for byte, the ledger of a solo single-host engine
    running the same boxes over the full data (``Fabric.oracle_engine``
    builds exactly that engine); the global count is the sum of per-box
    counts and the global listing is the per-box row concatenation in
    GLOBAL plan-box order — identical to the single-host ``count()`` /
    ``list()``, which are the same reductions over the same per-box
    results.

Devices and reduction
    Shard engines run their lanes on ``torch_device`` (the card unless the
    caller asks for the CPU). With a mesh attached (``mesh=``, a list of
    torch devices from ``launch.mesh.fabric_mesh``; a device may repeat)
    shard s runs on ``mesh[s % len(mesh)]``, shards that share a device one
    after the other in schedule order, and the count reduction puts each
    shard's partial on its device as an int64 tensor and sums them with
    one host read. Otherwise the partials are summed on the host. Both
    are exact in int64. Multi-process runs (one process per slice of the
    shards; ``launch.mesh.maybe_init_distributed`` forms a
    ``torch.distributed`` group when configured) exchange JSON
    ``partial()`` payloads merged by ``merge_partials`` — the worker CLI
    at the bottom is that protocol:

        python -m repro_torch.parallel.fabric --pattern triangle --nv 96 \\
            --ne 400 --shards 4 --process-index 0 --n-processes 2 \\
            --out part0.json [--torch-device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_torch_device
from repro_torch.core.iomodel import BlockDevice, IOStats
from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
from repro_torch.core.queries import Query
from repro_torch.data.edgestore import EdgeStore, InMemoryEdgeSource
from repro_torch.launch.mesh import (fabric_mesh, maybe_init_distributed,
                                     resolve_fabric_shards)
from repro_torch.parallel.sharding import (balanced_box_schedule,
                                           box_mass_costs_nd, interval_gaps,
                                           merge_interval,
                                           shard_shipped_ranges)
from repro_torch.query.executor import QueryEngine, QueryStats
from repro_torch.query.planner import QueryPlan


class FabricShippingError(RuntimeError):
    """A shard read vertex rows outside its shipped byte ranges — the
    shipping planner under-provisioned. Raised instead of silently serving
    zeros, because a quiet miss would corrupt counts downstream."""


class ShippedEdgeSource:
    """Shard-local EdgeSource over shipped byte ranges (module docstring).

    ``base`` is the origin source (an ``EdgeStore`` or in-memory CSR — any
    object with ``indptr`` + ``read_rows``); ``ranges`` the sorted
    disjoint inclusive vertex-row intervals to ship. Shipping reads go
    through ``base.read_rows``, so they are charged to the ORIGIN device
    (the shipping cost is real, measured I/O); serving reads are charged
    to this source's own (shard) device at the same virtual block
    addresses the origin layout would use.
    """

    def __init__(self, base, ranges: Sequence[Tuple[int, int]],
                 device: Optional[BlockDevice] = None):
        self.indptr = np.asarray(base.indptr, dtype=np.int64)
        self.n_nodes = len(self.indptr) - 1
        self.n_edges = int(self.indptr[-1]) if len(self.indptr) else 0
        self.orientation = getattr(base, "orientation", "raw")
        if isinstance(base, EdgeStore):
            # mirror the store's chunked file layout so charged block
            # addresses (incl. chunk padding) match the origin byte for
            # byte; exposing ``chunk_rows`` also keeps SliceCache's
            # block_rows derivation identical to a store-backed oracle
            self.chunk_rows = base.chunk_rows
            self._chunk_off = np.asarray(base._chunk_off, dtype=np.int64)
            total = int(self._chunk_off[-1])
        else:
            self._chunk_off = None
            total = self.n_edges
        self._total_words = total
        # full-length backing: virtual addresses equal the origin layout;
        # zeros pages stay uncommitted until a range actually ships
        self._vals = np.zeros(total, dtype=np.int32)
        self._covered: List[Tuple[int, int]] = []
        self.shipped_words = 0
        self.device: Optional[BlockDevice] = None
        if device is not None:
            self.attach_device(device)
        for lo, hi in ranges:
            self._ship(base, int(lo), int(hi))

    # -- construction ---------------------------------------------------------

    def attach_device(self, device: Optional[BlockDevice]) -> None:
        self.device = device
        if device is not None and self._total_words:
            device.register(self._vals)

    def _chunk_spans(self, lo: int, hi: int):
        """(start, end) backing positions of rows [lo, hi], one per store
        chunk they cross (chunk padding is skipped, as the store's reader
        skips it)."""
        c0, c1 = lo // self.chunk_rows, hi // self.chunk_rows
        for c in range(c0, c1 + 1):
            r0 = max(lo, c * self.chunk_rows)
            r1 = min(hi, (c + 1) * self.chunk_rows - 1)
            cbase = int(self._chunk_off[c]) \
                - int(self.indptr[c * self.chunk_rows])
            yield (cbase + int(self.indptr[r0]),
                   cbase + int(self.indptr[r1 + 1]))

    def _ship(self, base, lo: int, hi: int) -> None:
        """Copy rows [lo, hi] out of the origin source into the backing
        array at their home positions (charging the origin's device)."""
        lo = max(0, lo)
        hi = min(self.n_nodes - 1, hi)
        if hi < lo:
            return
        _ip, vals = base.read_rows(lo, hi)
        self.shipped_words += len(vals)
        if self._chunk_off is None:
            s, e = int(self.indptr[lo]), int(self.indptr[hi + 1])
            self._vals[s:e] = vals
        else:
            off = 0
            for s, e in self._chunk_spans(lo, hi):
                if e > s:
                    self._vals[s:e] = vals[off:off + (e - s)]
                    off += e - s
        self._covered = merge_interval(self._covered, lo, hi)

    # -- EdgeSource interface -------------------------------------------------

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def words(self) -> int:
        return self.n_edges

    def read_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        lo = max(0, int(lo))
        hi = min(self.n_nodes - 1, int(hi))
        if hi < lo:
            return np.zeros(1, np.int64), np.zeros(0, np.int32)
        if interval_gaps(self._covered, lo, hi):
            raise FabricShippingError(
                f"rows [{lo}, {hi}] not fully shipped to this shard "
                f"(covered: {self._covered})")
        if self._chunk_off is not None:
            parts = []
            for s, e in self._chunk_spans(lo, hi):
                if e > s:
                    if self.device is not None:
                        self.device.read_range(self._vals, s, e)
                    parts.append(np.asarray(self._vals[s:e]))
            vals = np.concatenate(parts) if parts else np.zeros(0, np.int32)
            return self.indptr[lo:hi + 2] - self.indptr[lo], vals
        s, e = int(self.indptr[lo]), int(self.indptr[hi + 1])
        if self.device is not None and e > s:
            self.device.read_range(self._vals, s, e)
        return self.indptr[lo:hi + 2] - self.indptr[lo], self._vals[s:e]


@dataclass
class FabricLayout:
    """The fabric's static execution layout: plan + costs + schedule +
    per-shard shipped row intervals per relation key."""

    plan: QueryPlan
    costs: List[int]
    schedule: List[List[int]]
    shipped: List[Dict[str, List[Tuple[int, int]]]]


@dataclass
class ShardReport:
    """One shard execution: its box ids (global plan indices, ascending),
    per-box results in that order, the shard engine's ``QueryStats``, and
    the shard device's raw ledger."""

    shard: int
    box_ids: List[int]
    results: List
    stats: QueryStats
    io: IOStats
    shipped_words: int
    engine: QueryEngine


@dataclass
class FabricStats:
    """One distributed ``count()`` / ``list()`` run, per shard and summed."""

    n_shards: int = 0
    n_boxes: int = 0
    n_results: int = 0
    total_mass: int = 0
    shard_boxes: List[int] = field(default_factory=list)
    shard_mass: List[int] = field(default_factory=list)
    shipped_words: List[int] = field(default_factory=list)
    shard_block_reads: List[int] = field(default_factory=list)
    shard_word_reads: List[int] = field(default_factory=list)
    sum_block_reads: int = 0
    sum_word_reads: int = 0
    balance: float = 1.0               # max shard mass / mean nonzero mass


class Fabric:
    """Facade over a distributed box-fabric run (module docstring).

    Parameters mirror ``QueryEngine`` where they share meaning; the extra
    knobs are ``n_shards`` (default: ``launch.mesh.resolve_fabric_shards``
    — one shard per device of ``torch_device``'s kind, overridable via
    ``REPRO_FABRIC_SHARDS``), ``mesh`` (a list of torch devices, e.g.
    ``launch.mesh.fabric_mesh``; attaching one runs shard s on
    ``mesh[s % len(mesh)]`` and switches the count reduction to per-device
    int64 partials), and the multi-process pair ``process_index`` /
    ``n_processes`` (this process executes shards with ``shard %
    n_processes == process_index``; cross-process merging goes through
    ``partial()`` / ``merge_partials``). ``use_kernels`` and
    ``torch_device`` go to every engine, as in ``QueryEngine``.
    """

    def __init__(self, query: Query, relations: Optional[Dict] = None, *,
                 store=None,
                 order: Optional[Sequence[str]] = None,
                 n_shards: Optional[int] = None,
                 mesh: Optional[Sequence] = None,
                 mem_words: Optional[int] = None,
                 cache_words: int = 0,
                 io_block_words: int = 4096,
                 backend: str = "auto",
                 workers: int = 1,
                 skew: str = "uniform",
                 heavy_threshold: Optional[int] = None,
                 device: Optional[BlockDevice] = None,
                 process_index: int = 0,
                 n_processes: int = 1,
                 use_kernels: bool = True,
                 torch_device="cuda",
                 tracer=None,
                 metrics=None):
        self.query = query
        # observability: one tracer spans planning and every shard run
        # (each shard on its own trace lane); the registry picks up each
        # shard engine's queue/kernel series
        self.tracer = tracer
        self.metrics = metrics
        self.mem_words = mem_words
        self.cache_words = int(cache_words)
        self.io_block_words = int(io_block_words)
        self.backend = backend
        self.workers = max(1, int(workers))
        self.skew = skew
        self.heavy_threshold = heavy_threshold
        self.torch_device = resolve_torch_device(torch_device)
        self.mesh = None if mesh is None \
            else [resolve_torch_device(d) for d in mesh]
        if self.mesh is not None and not self.mesh:
            raise ValueError("mesh: empty device list")
        self.process_index = int(process_index)
        self.n_processes = max(1, int(n_processes))
        if not (0 <= self.process_index < self.n_processes):
            raise ValueError(
                f"process_index {process_index} outside [0, {n_processes})")
        # the planner runs plan + shipping over the FULL sources; its
        # device (if any) is charged the shipping reads
        self.planner = QueryEngine(
            query, relations=relations, store=store, order=order,
            mem_words=mem_words, cache_words=0, device=device,
            io_block_words=io_block_words, backend=backend, workers=1,
            skew=skew, heavy_threshold=heavy_threshold,
            use_kernels=use_kernels, torch_device=self.torch_device,
            tracer=tracer)
        if n_shards is None and self.mesh is not None:
            n_shards = len(self.mesh)
        self.n_shards = resolve_fabric_shards(
            n_shards, torch_device=self.torch_device)
        self._layout: Optional[FabricLayout] = None
        self.stats = FabricStats()
        self.reports: List[ShardReport] = []

    @classmethod
    def from_graph(cls, query: Query, src, dst, *,
                   orientation: str = "minmax", **kw) -> "Fabric":
        """Fabric over one undirected graph, oriented exactly as
        ``QueryEngine.from_graph`` orients it."""
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

    # -- layout ---------------------------------------------------------------

    def _all_keys(self) -> List[str]:
        """Every relation key a shard (and its oracle) must provision, in
        the planner's registration order: forward relation names first,
        then derived reversed indexes — shard and oracle construct sources
        in this exact order so their devices' region layouts coincide."""
        fwd = []
        for a in self.query.atoms:
            if a.rel not in fwd:
                fwd.append(a.rel)
        return fwd + [k for k in self.planner.source_keys()
                      if k.endswith("~rev")]

    def _base_source(self, key: str):
        srcs = self.planner._sources
        return srcs[key] if key in srcs else self.planner._raw[key]

    def layout(self) -> FabricLayout:
        """Plan + LPT schedule + per-shard shipped row intervals (cached;
        pure metadata — no neighbor bytes move until ``run_local``)."""
        if self._layout is not None:
            return self._layout
        plan = self.planner.plan()
        dim_keys = self.planner.owned_dim_keys()
        indptr_by_key, nv_by_key = {}, {}
        for _d, keys in dim_keys:
            for key in keys:
                if key not in indptr_by_key:
                    src = self._base_source(key)
                    indptr_by_key[key] = np.asarray(src.indptr)
                    nv_by_key[key] = src.n_nodes
        costs = box_mass_costs_nd(plan.boxes, dim_keys, indptr_by_key)
        # sort each shard's boxes back to plan order: the shard engine
        # drains them in plan order (the ledger-sensitive queue policy),
        # and the global reduction re-merges by ascending global box id
        schedule = [sorted(s)
                    for s in balanced_box_schedule(costs, self.n_shards)]
        shipped = shard_shipped_ranges(plan.boxes, schedule, dim_keys,
                                       nv_by_key)
        self._layout = FabricLayout(plan, costs, schedule, shipped)
        return self._layout

    def describe(self) -> dict:
        """JSON-able layout summary (the scaling benchmark's balance
        report) — planning only, no shard executes."""
        lay = self.layout()
        shards = []
        for ids, ranges in zip(lay.schedule, lay.shipped):
            words = 0
            for key, ivals in ranges.items():
                ip = np.asarray(self._base_source(key).indptr, np.int64)
                for lo, hi in ivals:
                    words += int(ip[hi + 1] - ip[lo])
            shards.append({"boxes": len(ids),
                           "mass": int(sum(lay.costs[i] for i in ids)),
                           "shipped_words": int(words)})
        return {"n_shards": int(self.n_shards),
                "n_boxes": len(lay.plan.boxes),
                "rank": int(lay.plan.rank),
                "order": list(lay.plan.order),
                "total_mass": int(sum(lay.costs)),
                "shards": shards}

    # -- per-shard execution --------------------------------------------------

    def my_shards(self) -> List[int]:
        return [s for s in range(self.n_shards)
                if s % self.n_processes == self.process_index]

    def shard_torch_device(self, shard: int) -> torch.device:
        """Where shard ``shard``'s engine runs its lanes: its mesh device
        when a mesh is attached, else ``torch_device``."""
        if self.mesh is None:
            return self.torch_device
        return self.mesh[shard % len(self.mesh)]

    def _shard_device(self) -> BlockDevice:
        # same geometry the engine would auto-create for a store-backed
        # run at this budget — and what oracle_engine builds, so the
        # frame-level LRU behaviour matches frame for frame
        return BlockDevice(
            block_words=self.io_block_words,
            cache_blocks=max(2, (self.mem_words or (1 << 22))
                             // self.io_block_words))

    def _engine_over(self, rels: Dict[str, object], dev: BlockDevice,
                     shard: int, workers: Optional[int] = None
                     ) -> QueryEngine:
        lay = self.layout()
        box_ids = lay.schedule[shard]
        sub = dataclasses.replace(
            lay.plan,
            boxes=[lay.plan.boxes[i] for i in box_ids],
            lanes=[lay.plan.lanes[i] for i in box_ids]
            if lay.plan.lanes else [])
        return QueryEngine(
            self.query, relations=rels, order=self.planner.order,
            mem_words=self.mem_words, cache_words=self.cache_words,
            device=dev, io_block_words=self.io_block_words,
            backend=self.backend,
            workers=self.workers if workers is None else workers,
            skew=self.skew, heavy_threshold=self.heavy_threshold,
            plan=sub, use_kernels=self.planner.use_kernels,
            torch_device=self.shard_torch_device(shard),
            tracer=self.tracer, metrics=self.metrics)

    def shard_engine(self, shard: int) -> QueryEngine:
        """The shard's engine: fresh device, shipped sources, restricted
        plan. Public so tests can drive it box by box."""
        lay = self.layout()
        dev = self._shard_device()
        rels: Dict[str, object] = {}
        for key in self._all_keys():
            rels[key] = ShippedEdgeSource(
                self._base_source(key), lay.shipped[shard].get(key, []),
                device=dev)
        return self._engine_over(rels, dev, shard)

    def oracle_engine(self, shard: int,
                      workers: Optional[int] = None) -> QueryEngine:
        """The shard's solo oracle: the SAME restricted plan over FULL
        rebuilt sources on a fresh identically-configured device — what a
        single host running just this shard's boxes would do. The fabric's
        byte-identity contract is ``shard_engine(s)`` ledgers ==
        ``oracle_engine(s)`` ledgers, at any worker count."""
        dev = self._shard_device()
        rels: Dict[str, object] = {}
        for key in self._all_keys():
            base = self._base_source(key)
            if isinstance(base, EdgeStore):
                rels[key] = EdgeStore(base.path, device=dev)
            else:
                rels[key] = InMemoryEdgeSource(
                    base.indptr, base.indices, device=dev,
                    orientation=getattr(base, "orientation", "raw"))
        return self._engine_over(rels, dev, shard, workers=workers)

    def run_local(self, shard: int, mode: str = "count",
                  capacity: Optional[int] = None) -> ShardReport:
        """Execute one shard end to end; per-box results come back in the
        shard's (ascending global) box order."""
        lay = self.layout()
        eng = self.shard_engine(shard)
        if self.tracer is not None:
            # each shard gets its own trace lane (a Chrome process row):
            # stragglers and shipping skew line up side by side
            with self.tracer.lane(f"shard{shard}"), \
                    self.tracer.span("fabric.shard", shard=shard,
                                     mode=mode,
                                     n_boxes=len(lay.schedule[shard])):
                results = eng.run_boxes(mode, capacity)
        else:
            results = eng.run_boxes(mode, capacity)
        shipped = sum(getattr(s, "shipped_words", 0)
                      for s in (eng.source_for(k)
                                for k in eng.source_keys()))
        return ShardReport(shard=shard, box_ids=list(lay.schedule[shard]),
                           results=results, stats=eng.stats,
                           io=eng.device.stats, shipped_words=int(shipped),
                           engine=eng)

    # -- reduction ------------------------------------------------------------

    def _collect(self, reports: List[ShardReport]) -> None:
        lay = self.layout()
        st = FabricStats(n_shards=self.n_shards,
                         n_boxes=len(lay.plan.boxes),
                         total_mass=int(sum(lay.costs)))
        for rep in reports:
            mass = int(sum(lay.costs[i] for i in rep.box_ids))
            st.shard_boxes.append(len(rep.box_ids))
            st.shard_mass.append(mass)
            st.shipped_words.append(rep.shipped_words)
            st.shard_block_reads.append(rep.stats.block_reads)
            st.shard_word_reads.append(rep.stats.word_reads)
            st.n_results += rep.stats.n_results
        st.sum_block_reads = sum(st.shard_block_reads)
        st.sum_word_reads = sum(st.shard_word_reads)
        nonzero = [m for m in st.shard_mass if m] or [1]
        st.balance = max(st.shard_mass, default=0) / \
            (sum(nonzero) / len(nonzero))
        self.stats = st
        self.reports = reports

    def _mesh_sum(self, shards: Sequence[int],
                  partials: Sequence[int]) -> int:
        """Count reduction over the fabric mesh: each shard's partial as an
        int64 tensor on its mesh device, summed on the first with one host
        read (int64 lanes: counts past 2^31 stay exact)."""
        mesh = self.mesh if self.mesh is not None \
            else fabric_mesh(self.n_shards, torch_device=self.torch_device)
        devs = [mesh[s % len(mesh)] for s in shards]
        if not devs:
            return 0
        lanes = [torch.tensor(int(p), dtype=torch.int64, device=d)
                 for p, d in zip(partials, devs)]
        return int(torch.stack([x.to(devs[0]) for x in lanes]).sum())

    def count(self, reduce: str = "auto") -> int:
        """Distributed count over this process's shards. ``reduce``:
        'host' (plain sum), 'mesh' (per-device int64 partials summed over
        the fabric mesh), or 'auto' (mesh when one is attached). With
        ``n_processes > 1`` this is the LOCAL partial — merge across
        processes with ``partial()`` / ``merge_partials``."""
        if reduce not in ("auto", "host", "mesh"):
            raise ValueError(f"reduce {reduce!r} not in "
                             "('auto', 'host', 'mesh')")
        if reduce == "auto":
            reduce = "mesh" if self.mesh is not None else "host"
        if reduce == "mesh" and self.n_processes != 1:
            raise ValueError("mesh reduction needs every shard's "
                             "partial in-process (n_processes == 1)")
        shards = self.my_shards()
        reports = [self.run_local(s, "count") for s in shards]
        self._collect(reports)
        partials = [sum(int(r) for r in rep.results if r is not None)
                    for rep in reports]
        if reduce == "mesh":
            return self._mesh_sum(shards, partials)
        return int(sum(partials))

    def list(self, capacity: Optional[int] = None) -> np.ndarray:
        """Distributed listing: per-box rows merged in GLOBAL plan-box
        order, then projected to head columns — byte-identical to the
        single-host ``QueryEngine.list`` on the same sources."""
        reports = [self.run_local(s, "list", capacity)
                   for s in self.my_shards()]
        self._collect(reports)
        by_box: Dict[int, np.ndarray] = {}
        for rep in reports:
            for bid, rows in zip(rep.box_ids, rep.results):
                if rows is not None:
                    by_box[bid] = rows
        parts = [by_box[b] for b in sorted(by_box)]
        rows = np.concatenate(parts) if parts \
            else np.zeros((0, self.planner.n), dtype=np.int64)
        return self.planner.head_columns(rows)

    # -- multi-process protocol ----------------------------------------------

    def partial(self, mode: str = "count",
                capacity: Optional[int] = None) -> dict:
        """This process's JSON-able shard partials. Listing rows are
        head-projected per box (projection commutes with the box-order
        concatenation ``merge_partials`` performs)."""
        shards = []
        for s in self.my_shards():
            rep = self.run_local(s, mode, capacity)
            ent: dict = {"shard": rep.shard,
                         "box_ids": [int(b) for b in rep.box_ids],
                         "block_reads": int(rep.stats.block_reads),
                         "shipped_words": int(rep.shipped_words)}
            if mode == "count":
                ent["counts"] = [int(r) if r is not None else 0
                                 for r in rep.results]
            else:
                ent["rows"] = {
                    str(b): (self.planner.head_columns(r).tolist()
                             if r is not None else [])
                    for b, r in zip(rep.box_ids, rep.results)}
            shards.append(ent)
        return {"mode": mode,
                "n_shards": int(self.n_shards),
                "n_head": len(self.query.head),
                "process_index": int(self.process_index),
                "n_processes": int(self.n_processes),
                "shards": shards}

    @staticmethod
    def merge_partials(partials: Sequence[dict]):
        """Merge ``partial()`` payloads from every process: checks shard
        coverage, then sums counts or concatenates listing rows in global
        box order. Returns an int (count) or an (m, n_head) array."""
        if not partials:
            raise ValueError("no partials to merge")
        mode = partials[0]["mode"]
        n_shards = int(partials[0]["n_shards"])
        seen: Dict[int, dict] = {}
        for p in partials:
            if p["mode"] != mode or int(p["n_shards"]) != n_shards:
                raise ValueError("partials disagree on mode/n_shards")
            for ent in p["shards"]:
                seen[int(ent["shard"])] = ent
        missing = [s for s in range(n_shards) if s not in seen]
        if missing:
            raise ValueError(f"missing shard partial(s): {missing}")
        if mode == "count":
            return sum(sum(ent["counts"]) for ent in seen.values())
        by_box: Dict[int, list] = {}
        for ent in seen.values():
            for bid, rows in ent["rows"].items():
                if rows:
                    by_box[int(bid)] = rows
        merged: list = []
        for b in sorted(by_box):
            merged.extend(by_box[b])
        n_head = int(partials[0]["n_head"])
        return np.asarray(merged, dtype=np.int64) if merged \
            else np.zeros((0, n_head), dtype=np.int64)


# ---------------------------------------------------------------------------
# worker CLI (one process per slice of the shards)
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="box-fabric worker: run this process's shards of a "
                    "pattern query and emit a JSON partial")
    ap.add_argument("--pattern", default="triangle")
    ap.add_argument("--graph", default="random",
                    choices=["random", "rmat", "clustered"])
    ap.add_argument("--nv", type=int, default=96)
    ap.add_argument("--ne", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mem-words", type=int, default=1 << 12)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--mode", default="count", choices=["count", "list"])
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--process-index", type=int, default=0)
    ap.add_argument("--n-processes", type=int, default=1)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the shards' lanes run (default: the card)")
    ap.add_argument("--out", default=None,
                    help="write the JSON partial here (default: stdout)")
    args = ap.parse_args(argv)

    from repro_torch.data import graphs
    from repro_torch.query.patterns import PATTERNS

    distributed = maybe_init_distributed()
    gen = {"random": graphs.random_graph, "rmat": graphs.rmat_graph}.get(
        args.graph)
    if gen is not None:
        src, dst = gen(args.nv, args.ne, seed=args.seed)
    else:
        src, dst = graphs.clustered_graph(max(1, args.nv // 16), 16,
                                          seed=args.seed)
    fab = Fabric.from_graph(PATTERNS[args.pattern](), src, dst,
                            n_shards=args.shards,
                            mem_words=args.mem_words,
                            workers=args.workers,
                            backend=args.backend,
                            process_index=args.process_index,
                            n_processes=args.n_processes,
                            torch_device=args.torch_device)
    part = fab.partial(args.mode)
    part["distributed"] = bool(distributed)
    if distributed:
        torch.distributed.destroy_process_group()
    payload = json.dumps(part)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    else:
        sys.stdout.write(payload + "\n")
    print(f"FABRIC-PARTIAL-OK shards={len(part['shards'])}"
          f"/{part['n_shards']} process={args.process_index}"
          f"/{args.n_processes}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
