"""Streaming box executor: per-box slice pipeline feeding the torch lanes.

The planner half of the engine (``core.engine.TriangleEngine``) produces a
box plan; this module executes it as a stream. For each box (lx,hx,ly,hy)
the executor

  1. pulls the box from the work queue,
  2. *materializes* a vertex-renumbered, compacted neighbor slice on the
     host: only the rows referenced by in-box edges, in compact CSR form
     (the paper's "feed input data to LFTJ" boxing idea applied at the
     storage layer),
  3. dispatches the slice to a lane chosen by the planner's density rule:
     ``binary`` (plain torch row-batched binary search), ``dense`` (the
     masked dense count, a CUDA kernel on the card), ``intersect`` (the
     per-edge intersection CUDA kernel on the card), ``fused`` (the whole
     box's LFTJ loop nest, a CUDA kernel on the card) or ``host`` (numpy).

The device lanes copy only the slice's real CSR words to the torch device;
the binary and listing lanes build the box-local padded matrix there, the
intersect and fused lanes read the CSR as it is. On a CUDA device the
dense, intersect and fused lanes launch the kernels of ``kernels/``; on
the CPU the kernel wrappers run their plain torch versions. With
``degree_bins`` the binary lane counts through the reference's per-box
degree bins (``_count_binned_slice``): the plain per-bin-pair probe on the
CPU, one intersect launch over the slice's CSR on the card.

Slices are built host-side from an EdgeSource (``data.edgestore.EdgeStore``
on disk, or ``InMemoryEdgeSource``), optionally behind a ``SliceCache``.
Every source read is charged to the attached ``core.iomodel.BlockDevice``,
giving measured block I/Os per run.

Two execution modes share the per-box machinery:

* ``workers=1`` (the sequential oracle): the box stream runs through a
  single ``data.pipeline.Prefetcher`` — one box in flight, host slice
  construction of the next box overlapping device compute of the current
  one.
* ``workers>1`` (async scheduler): a bounded pool of worker threads drains
  a shared work queue, LPT-first (``parallel.sharding.box_queue_order``),
  in plan order when a ``SliceCache`` or a charged ``BlockDevice`` is
  attached. Slice *fetches* are serialized in queue order behind an
  in-flight (boxes, words) budget, so the source read stream — and the I/O
  ledger and the cache's hit sequence — is identical to a serial walk of
  the same order. Lane compute runs in
  parallel across workers, and results are reduced in *fixed box order*
  (never arrival order): counts sum and listings concatenate exactly as
  the sequential oracle would.
"""

from __future__ import annotations

import inspect
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import Prefetcher
from repro_torch.kernels import ledger as kernel_ledger
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.lftj_fused import ops as fused_ops
from repro_torch.kernels.triangle_dense import ops as dense_ops
from repro_torch.parallel.sharding import box_queue_order

from .lftj_torch import (SENTINEL, _count_chunked, _count_rows_chunked,
                         _list_chunked, bin_layout, pad_neighbors_binned)

_ROW_BUCKET = 64


class BoxQueueCancelled(RuntimeError):
    """Raised by ``run_box_queue`` when its ``cancel`` event fires before
    the queue drains: remaining boxes are abandoned, in-progress stages
    finish, every worker is joined."""


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(1, n)))))


@dataclass
class BoxSlice:
    """One box's renumbered, compacted work item.

    ``rows`` maps local row id -> global vertex id (sorted);
    ``row_off``/``row_vals`` are the slice's compact CSR form (offsets +
    concatenated sorted neighbor values per local row); ``eu``/``ev`` are
    *local* row ids of the in-box edges. ``words_read`` counts raw CSR
    words read from the source.

    ``padded(device)`` builds the (R, K) box-local padded neighbor matrix
    ``pad_shape`` on a torch device — all-SENTINEL pad rows from index
    ``len(rows)`` — from the compact CSR, and caches it: the binary and
    listing lanes need it, while the host and dense lanes never
    materialize it. ``charge_padded`` says whether the reference's lane for
    this slice builds that matrix: set by ``padded`` and by the intersect
    lane, which reads the compact CSR and builds none.
    """

    box: Tuple[int, int, int, int]
    rows: np.ndarray
    eu: np.ndarray
    ev: np.ndarray
    n_edges: int
    wx: int
    wy: int
    words_read: int
    row_off: np.ndarray
    row_vals: np.ndarray
    pad_shape: Tuple[int, int]
    _npad: Optional[torch.Tensor] = None
    _deg: Optional[torch.Tensor] = None
    charge_padded: bool = False

    def padded(self, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(npad, deg) on ``device``: the padded matrix and each row's real
        length (0 on pad rows). Only the real words cross to the device."""
        if self._npad is None:
            n_rows, k = self.pad_shape
            off = torch.from_numpy(self.row_off).to(device)
            vals = torch.from_numpy(self.row_vals).to(device)
            nnz = int(vals.shape[0])
            deg_r = off[1:] - off[:-1]
            npad = torch.full((n_rows, k), SENTINEL, dtype=torch.int32,
                              device=device)
            if nnz:
                rr = torch.repeat_interleave(
                    torch.arange(len(deg_r), device=device), deg_r,
                    output_size=nnz)
                cc = torch.arange(nnz, device=device) \
                    - torch.repeat_interleave(off[:-1], deg_r,
                                              output_size=nnz)
                npad[rr, cc] = vals
            deg = torch.zeros(n_rows, dtype=torch.int64, device=device)
            deg[:len(deg_r)] = deg_r
            self._npad, self._deg = npad, deg
            self.charge_padded = True
        return self._npad, self._deg

    def edges(self, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The in-box edges' local row ids (int32) on ``device``."""
        return (torch.from_numpy(self.eu).to(device),
                torch.from_numpy(self.ev).to(device))

    @property
    def padded_words(self) -> int:
        return int(self.pad_shape[0] * self.pad_shape[1])


def _gather_rows(rows: np.ndarray, slabs: list) -> Tuple[np.ndarray, np.ndarray]:
    """(deg, concat values) for sorted global ``rows`` out of range slabs.

    ``slabs`` is [(lo, hi, indptr_local, values)] with disjoint row ranges
    covering every requested row.
    """
    deg = np.zeros(len(rows), dtype=np.int64)
    starts = np.zeros(len(rows), dtype=np.int64)
    slab_of = np.full(len(rows), -1, dtype=np.int64)
    for si, (lo, hi, ip, _vals) in enumerate(slabs):
        m = (rows >= lo) & (rows <= hi)
        if not m.any():
            continue
        r = rows[m] - lo
        starts[m] = ip[r]
        deg[m] = ip[r + 1] - ip[r]
        slab_of[m] = si
    parts = []
    for si, (_lo, _hi, _ip, vals) in enumerate(slabs):
        m = slab_of == si
        if not m.any():
            continue
        s, d = starts[m], deg[m]
        total = int(d.sum())
        if total == 0:
            continue
        idx = np.repeat(s, d) + np.arange(total) \
            - np.repeat(np.cumsum(d) - d, d)
        parts.append((np.flatnonzero(m), vals[idx], d))
    # reassemble in row order (one vectorized scatter per slab)
    out = np.zeros(int(deg.sum()), dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(deg)])
    for where, vals, d in parts:
        tgt = np.repeat(offs[where], d) + np.arange(int(d.sum())) \
            - np.repeat(np.cumsum(d) - d, d)
        out[tgt] = vals
    return deg, out


class SliceCache:
    """LRU cache of row-range slices over an EdgeSource, budgeted in words.

    The box plan walks a grid: every box in one x-stripe re-reads the same
    x-slab, and boxes in adjacent x-stripes re-read the same y-slices. The
    cache exploits that locality *above* the ``iomodel.BlockDevice``. A
    ``read_rows(lo, hi)`` request is decomposed against row blocks of
    ``block_rows`` rows (aligned, sized from the budget by default):

    * **interior blocks** (fully inside the request) are the cacheable
      unit. Cached ones are served from host memory — no source read, no
      block I/O charged, which is how hits reduce
      ``EngineStats.block_reads``. Runs of consecutive *missing* interior
      blocks are fetched with ONE source read and split into per-block
      entries.
    * **partial edge blocks** pass straight through to the source, trimmed
      to the request. The cache therefore never reads a word the uncached
      engine would not have read.

    Eviction is LRU past ``budget_words`` (raw CSR words: values + one
    indptr word per row); a single block wider than the whole budget is
    still cached alone. Words served by hits are also recorded on the
    attached device (``IOStats.cache_served_words``).

    Exposes the EdgeSource interface; everything else (``n_nodes``,
    ``indptr``, ``degrees``, ...) proxies to the wrapped source.
    ``read_rows`` serializes on an internal lock, so the cache ledger stays
    consistent when the scheduler's workers share one cache; the scheduler
    also serializes slice fetches in plan order whenever a cache is
    attached, so the hit/miss sequence matches the serial run's.
    """

    def __init__(self, source, budget_words: int,
                 block_rows: Optional[int] = None):
        self.source = source
        self._lock = threading.RLock()
        self.budget_words = max(1, int(budget_words))
        if block_rows is None:
            # hits only happen on fully-covered blocks, so blocks are fine
            # (~32 words); the budget/4096 floor bounds the entry count
            chunk = int(getattr(source, "chunk_rows", 256))
            avg = source.n_edges / max(1, source.n_nodes) + 2.0
            target = max(32, self.budget_words // 4096)
            block_rows = int(min(chunk, max(2.0, round(target / avg))))
        self.block_rows = max(1, int(block_rows))
        self._blocks: OrderedDict = OrderedDict()  # block id -> (ip, vals)
        self._words = 0
        self.hits = 0
        self.misses = 0
        self.hit_words = 0      # words served from cache
        self.miss_words = 0     # words read from the source into the cache
        self.passthrough_words = 0   # partial-edge words (never cached)

    # -- EdgeSource interface ------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.source, name)

    def _read_through(self, lo: int, hi: int):
        """Uncached trimmed read (partial edge blocks)."""
        ip, vals = self.source.read_rows(lo, hi)
        self.passthrough_words += len(vals)
        return ip, vals

    def _fetch_run(self, b0: int, b1: int) -> list:
        """One sequential source read covering missing blocks b0..b1, split
        into per-block cache entries, returned in block order (the caller
        assembles from them directly, so an insert-time eviction inside
        this very request never forces a re-read)."""
        br = self.block_rows
        ip, vals = self.source.read_rows(b0 * br, b1 * br + br - 1)
        self.misses += b1 - b0 + 1
        self.miss_words += len(vals)
        entries = []
        for bid in range(b0, b1 + 1):
            r0 = (bid - b0) * br
            s, e = int(ip[r0]), int(ip[r0 + br])
            ent = (np.asarray(ip[r0:r0 + br + 1] - ip[r0]),
                   np.asarray(vals[s:e]))
            self._insert(bid, ent)
            entries.append(ent)
        return entries

    def read_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return self._read_rows_locked(lo, hi)

    def _read_rows_locked(self, lo: int,
                          hi: int) -> Tuple[np.ndarray, np.ndarray]:
        nv = self.source.n_nodes
        lo = max(0, int(lo))
        hi = min(nv - 1, int(hi))
        if hi < lo:
            return np.zeros(1, np.int64), np.zeros(0, np.int32)
        br = self.block_rows
        # interior = the aligned blocks fully covered by [lo, hi]
        ib0 = -(-lo // br)                   # first block starting >= lo
        ib1 = (hi + 1) // br - 1             # last block ending <= hi
        if ib1 < ib0:
            return self._read_through(lo, hi)
        dev = getattr(self.source, "device", None)
        parts = []                            # (ip_local, vals) in row order
        if lo < ib0 * br:
            parts.append(self._read_through(lo, ib0 * br - 1))
        bid = ib0
        while bid <= ib1:
            ent = self._blocks.get(bid)
            if ent is not None:
                self._blocks.move_to_end(bid)
                self.hits += 1
                self.hit_words += len(ent[1])
                if dev is not None:
                    dev.serve_from_cache(len(ent[1]))
                parts.append(ent)
                bid += 1
            else:
                run_end = bid
                while run_end + 1 <= ib1 \
                        and run_end + 1 not in self._blocks:
                    run_end += 1
                parts.extend(self._fetch_run(bid, run_end))
                bid = run_end + 1
        if hi >= (ib1 + 1) * br:
            parts.append(self._read_through((ib1 + 1) * br, hi))
        if len(parts) == 1:
            return parts[0]
        deg = np.concatenate([np.diff(p[0]) for p in parts])
        ip_out = np.concatenate([np.zeros(1, np.int64),
                                 np.cumsum(deg, dtype=np.int64)])
        return ip_out, np.concatenate([p[1] for p in parts])

    # -- LRU bookkeeping -----------------------------------------------------

    @staticmethod
    def _entry_words(ent) -> int:
        return len(ent[1]) + len(ent[0])

    def _insert(self, bid: int, ent) -> None:
        self._blocks[bid] = ent
        self._words += self._entry_words(ent)
        while self._words > self.budget_words and len(self._blocks) > 1:
            _, old = self._blocks.popitem(last=False)
            self._words -= self._entry_words(old)

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._words = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def run_box_serial(items: List, *,
                   fetch: Callable[[object], Tuple[object, int]],
                   build: Callable[[object], object],
                   work: Callable[[object], object],
                   prefetch_depth: int = 2,
                   cancel: Optional[threading.Event] = None) -> List:
    """The ``workers=1`` oracle drain: one ``Prefetcher`` pipeline (fetch
    + build of the next item overlap the current item's ``work``), items
    strictly in list order, per-item results in list order (``None`` for
    skipped items). This is the serial counterpart of ``run_box_queue``;
    ``cancel`` aborts with ``BoxQueueCancelled`` exactly like the pooled
    scheduler."""
    results: List = [None] * len(items)
    pf = Prefetcher((build(fetch(it)[0]) for it in items),
                    depth=max(1, int(prefetch_depth)))
    try:
        for i, built in enumerate(pf):
            if cancel is not None and cancel.is_set():
                raise BoxQueueCancelled(
                    "query cancelled before draining its boxes")
            if built is None:
                continue
            results[i] = work(built)
    finally:
        pf.close()
    return results


def run_box_queue(items: List, *, order: List[int],
                  est_words: Callable[[object], int],
                  fetch: Callable[[object], Tuple[object, int]],
                  build: Callable[[object], object],
                  work: Callable[[object], object],
                  workers: int,
                  inflight_items: int,
                  inflight_words: Optional[int] = None,
                  cancel: Optional[threading.Event] = None):
    """Drain a box work queue on a bounded worker pool.

    A pool of ``workers`` threads (clamped to the hardware parallelism and
    the item count) drains ``items`` in ``order``, with the three per-item
    stages split so the determinism contract holds for ANY workload:

    * ``fetch(item) -> (payload, actual_words)`` — all *source reads* of
      one item. Serialized in queue order behind the in-flight
      (items, words) window, so the read stream — and every ledger derived
      from it (``BlockDevice`` I/Os) — is identical to a serial walk of
      ``order``.
    * ``build(payload) -> obj | None`` — pure host-side construction (no
      source access); runs concurrently across workers. ``None`` skips the
      item (empty box).
    * ``work(obj) -> result`` — the lane; concurrent across workers.

    Admission charges ``est_words(item)`` against the window up front and
    corrects to the fetch's actual words once known; an item wider than the
    whole window is admitted alone (pinned-spill rule) so the queue cannot
    deadlock on it. A stage exception cancels the remaining queue, every
    worker is joined, and the first error re-raises here. An optional
    ``cancel`` event aborts the same way from outside: no new item is
    claimed once it is set, in-progress stages finish, workers join, and
    ``BoxQueueCancelled`` raises (unless a stage error got there first).

    Returns ``(results, telemetry)``: per-item results in *item order*
    (``None`` for skipped items) for deterministic reduction, plus the
    telemetry dict (wait/build/compute worker-seconds, in-flight peaks,
    wall time, pool size) the caller folds into its stats object.
    """
    n = len(items)
    results: List = [None] * n
    max_boxes = max(1, int(inflight_items))
    max_words = inflight_words
    # the pool never exceeds the hardware parallelism: beyond it, extra
    # runnable threads only thrash caches and the GIL
    pool = max(1, min(workers, n, os.cpu_count() or workers))
    cond = threading.Condition()
    state = {"next": 0, "building": False, "res_boxes": 0,
             "res_words": 0, "err": None, "stop": False}
    tele = {"wait": 0.0, "build": 0.0, "compute": 0.0,
            "hi_boxes": 0, "hi_words": 0, "wall": 0.0, "pool": 0}

    def loop():
        try:
            _loop_body()
        except BaseException as e:  # noqa: BLE001 — never strand waiters
            with cond:
                if state["err"] is None:
                    state["err"] = e
                state["stop"] = True
                state["building"] = False
                cond.notify_all()

    def _loop_body():
        while True:
            t0 = time.perf_counter()
            with cond:
                while True:
                    if cancel is not None and cancel.is_set():
                        state["stop"] = True
                        cond.notify_all()
                    if state["stop"] or state["next"] >= n:
                        tele["wait"] += time.perf_counter() - t0
                        return
                    if not state["building"]:
                        est = est_words(items[order[state["next"]]])
                        fits = (state["res_boxes"] < max_boxes
                                and (max_words is None
                                     or state["res_words"] + est
                                     <= max_words))
                        # an item wider than the whole window (pinned
                        # spill row) is admitted alone, or the queue
                        # would deadlock on it
                        if fits or state["res_boxes"] == 0:
                            break
                    # poll so an externally-set cancel event is noticed even
                    # when no stage completion notifies the condition
                    cond.wait(timeout=0.05 if cancel is not None else None)
                bi = order[state["next"]]
                state["next"] += 1
                state["building"] = True
                state["res_boxes"] += 1
                state["res_words"] += est
                tele["wait"] += time.perf_counter() - t0
                tele["hi_boxes"] = max(tele["hi_boxes"],
                                       state["res_boxes"])
            actual = 0
            try:
                t1 = time.perf_counter()
                # serialized stage: only the source reads. build and work
                # run outside the turnstile, concurrently across workers.
                payload, actual = fetch(items[bi])
                with cond:
                    state["building"] = False
                    state["res_words"] += actual - est
                    tele["hi_words"] = max(tele["hi_words"],
                                           state["res_words"])
                    cond.notify_all()
                obj = build(payload)
                t3 = time.perf_counter()
                with cond:
                    tele["build"] += t3 - t1
                if obj is not None:
                    out = work(obj)
                    with cond:
                        tele["compute"] += time.perf_counter() - t3
                    results[bi] = out
                with cond:
                    state["res_boxes"] -= 1
                    state["res_words"] -= actual
                    cond.notify_all()
            except BaseException as e:  # noqa: BLE001
                with cond:
                    if state["err"] is None:
                        state["err"] = e
                    state["stop"] = True      # cancel remaining items
                    state["building"] = False
                    state["res_boxes"] -= 1
                    state["res_words"] -= actual
                    cond.notify_all()
                return

    t_start = time.perf_counter()
    threads = [threading.Thread(target=loop, daemon=True,
                                name=f"box-worker-{i}")
               for i in range(pool)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tele["wall"] = time.perf_counter() - t_start
    tele["pool"] = len(threads)
    if state["err"] is not None:
        raise state["err"]
    if cancel is not None and cancel.is_set():
        raise BoxQueueCancelled("box queue cancelled before draining")
    return results, tele


def merge_queue_telemetry(stats, tele: dict, lock: threading.Lock,
                          inflight_boxes: int) -> None:
    """Fold one ``run_box_queue`` telemetry dict into a stats object that
    carries the scheduler fields (``EngineStats`` does).

    ``worker_utilization`` is ``busy / (pool * wall)``; a sub-millisecond
    run can finish with ``wall == 0.0`` (perf_counter granularity) or a
    degenerate pool, in which case the ratio is undefined — it is
    reported as ``None``, never a garbage division.
    """
    busy = tele["build"] + tele["compute"]
    wall = tele["wall"]
    with lock:
        stats.n_workers = tele["pool"]
        stats.inflight_boxes = inflight_boxes
        stats.queue_wait_s += tele["wait"]
        stats.build_s += tele["build"]
        stats.compute_s += tele["compute"]
        stats.overlap_s += max(0.0, busy - wall)
        stats.worker_utilization = busy / (tele["pool"] * wall) \
            if wall > 0.0 and tele["pool"] > 0 else None
        stats.max_inflight_boxes = max(stats.max_inflight_boxes,
                                       tele["hi_boxes"])
        stats.max_inflight_words = max(stats.max_inflight_words,
                                       tele["hi_words"])


class StreamingExecutor:
    """Pulls boxes from a work queue, materializes slices, runs lanes.

    ``torch_device`` is where the binary, dense, intersect, fused and
    listing lanes run; on a CUDA device the dense, intersect and fused
    lanes launch the port's kernels (``use_kernels``), on the CPU their
    wrappers run the plain torch versions. ``degree_bins`` sends the
    binary lane's boxes through ``_count_binned_slice``. ``workers=1`` is
    the sequential oracle (single Prefetcher pipeline); ``workers>1`` runs
    the async scheduler described in the module docstring. ``inflight_boxes``/``inflight_words`` bound the
    window of materialized-but-unreduced slices (defaults: ``2*workers``
    boxes, unbounded words — the engine passes a word cap derived from its
    memory budget).
    """

    def __init__(self, source, *,
                 pick_backend: Callable[[int, int, int], str],
                 torch_device="cuda",
                 chunk: int = 2048,
                 prefetch_depth: int = 2,
                 dense_words_cap: int = 64_000_000,
                 stats=None,
                 workers: int = 1,
                 degree_bins: bool = False,
                 inflight_boxes: Optional[int] = None,
                 inflight_words: Optional[int] = None):
        self.source = source
        self.pick_backend = pick_backend
        # a box-aware dispatcher takes the box as a fourth argument; plain
        # (n_edges, wx, wy) callables keep working
        try:
            params = inspect.signature(pick_backend).parameters.values()
            self._backend_takes_box = any(
                p.name == "box"
                or p.kind is inspect.Parameter.VAR_POSITIONAL
                for p in params)
        except (TypeError, ValueError):
            self._backend_takes_box = False
        self.torch_device = torch.device(torch_device)
        self.use_kernels = self.torch_device.type == "cuda"
        self.degree_bins = bool(degree_bins)
        self.chunk = int(chunk)
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.dense_words_cap = int(dense_words_cap)
        self.stats = stats
        self.workers = max(1, int(workers))
        self.inflight_boxes = max(1, int(inflight_boxes)) \
            if inflight_boxes is not None else max(2, 2 * self.workers)
        self.inflight_words = int(inflight_words) \
            if inflight_words is not None else None
        # serializes every EngineStats mutation: workers note slices and
        # lane counters concurrently against the one shared stats object
        self._stats_lock = threading.Lock()

    # -- slice materialization (host side, overlapped via Prefetcher) --------

    def _fetch(self, box, x_slab=None):
        """All *source reads* of one box — the stage the async scheduler
        serializes in queue order, so the read stream (and every derived
        ledger: device I/Os, cache hits) is identical to a serial walk.
        ``x_slab`` is an optional pre-read ``read_rows(lx, hx)`` result so
        a caller that already extracted the box's edges doesn't charge the
        x-range read twice. Returns ``None`` for a degenerate box, else the
        raw slabs + in-box edges for ``_compact``."""
        nv = self.source.n_nodes
        lx, hx, ly, hy = box
        lx_, hx_ = max(int(lx), 0), min(int(hx), nv - 1)
        ly_, hy_ = max(int(ly), 0), min(int(hy), nv - 1)
        if hx_ < lx_ or hy_ < ly_:
            return None
        ip_x, vx = x_slab if x_slab is not None \
            else self.source.read_rows(lx_, hx_)
        words = len(vx)
        eu_g = np.repeat(np.arange(lx_, hx_ + 1), np.diff(ip_x))
        ev_g = vx.astype(np.int64)
        sel = (ev_g >= ly_) & (ev_g <= hy_)
        eu_g, ev_g = eu_g[sel], ev_g[sel]
        slabs = [(lx_, hx_, ip_x, vx)]
        if len(eu_g):
            # provision the y slice too (E(y, z) rows); dedup the x
            # overlap (§5)
            for seg_lo, seg_hi in ((ly_, min(hy_, lx_ - 1)),
                                   (max(ly_, hx_ + 1), hy_)):
                if seg_hi >= seg_lo:
                    ip_s, vs = self.source.read_rows(seg_lo, seg_hi)
                    words += len(vs)
                    slabs.append((seg_lo, seg_hi, ip_s, vs))
        return (box, (lx_, hx_, ly_, hy_), slabs, eu_g, ev_g, words)

    def _compact(self, fetched) -> Optional[BoxSlice]:
        """Pure-numpy renumber/compact of a fetched box — no source access,
        so the scheduler runs it concurrently across workers (numpy's
        sort/unique/searchsorted kernels release the GIL)."""
        if fetched is None:
            return None
        box, (lx_, hx_, ly_, hy_), slabs, eu_g, ev_g, words = fetched
        if len(eu_g) == 0:
            return BoxSlice(box, np.zeros(0, np.int64),
                            np.zeros(0, np.int32), np.zeros(0, np.int32),
                            0, hx_ - lx_ + 1, hy_ - ly_ + 1, words,
                            row_off=np.zeros(1, np.int64),
                            row_vals=np.zeros(0, np.int32),
                            pad_shape=(0, 0))
        rows = np.unique(np.concatenate([eu_g, ev_g]))
        deg, vals = _gather_rows(rows, slabs)
        k = _pow2(int(deg.max(initial=1)), lo=8)
        n_rows = -(-(len(rows) + 1) // _ROW_BUCKET) * _ROW_BUCKET
        eu = np.searchsorted(rows, eu_g).astype(np.int32)
        ev = np.searchsorted(rows, ev_g).astype(np.int32)
        off = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(deg, dtype=np.int64)])
        return BoxSlice(box, rows, eu, ev, len(eu),
                        hx_ - lx_ + 1, hy_ - ly_ + 1, words,
                        row_off=off, row_vals=vals, pad_shape=(n_rows, k))

    def _materialize(self, box, x_slab=None) -> Optional[BoxSlice]:
        """Build the box slice (fetch + compact in one step — the serial
        pipeline and one-off ``count_box`` path)."""
        return self._compact(self._fetch(box, x_slab=x_slab))

    def _stream(self, boxes) -> Iterator[Optional[BoxSlice]]:
        return Prefetcher((self._materialize(b) for b in boxes),
                          depth=self.prefetch_depth)

    def _note(self, slc: BoxSlice) -> None:
        s = self.stats
        if s is None:
            return
        with self._stats_lock:
            s.n_streamed_boxes += 1
            s.slice_words_read += slc.words_read
            s.max_slice_words = max(s.max_slice_words, slc.words_read)
            s.max_slice_padded_words = max(s.max_slice_padded_words,
                                           slc.padded_words)

    def _note_padding(self, slc: BoxSlice, extra: int = 0) -> None:
        """Charge the padded-vs-actual ledger for one finished slice.

        ``padded_words`` is the reference's figure: the padded
        neighbor-matrix words its lanes materialize, charged iff the slice
        ran a lane that builds one there (``charge_padded``), plus the
        per-bin matrices of the binned lane (``extra``). The host and dense
        lanes build none. It is not the port's device memory: the port's
        intersect and binned lanes on the card build no padded matrix but
        charge the ones the reference's build.
        """
        s = self.stats
        if s is None:
            return
        with self._stats_lock:
            if slc.charge_padded:
                s.padded_words += slc.padded_words
            s.padded_words += int(extra)
            s.actual_words += len(slc.row_vals)

    def _backend_for(self, slc: BoxSlice) -> str:
        if self._backend_takes_box:
            return self.pick_backend(slc.n_edges, slc.wx, slc.wy, slc.box)
        return self.pick_backend(slc.n_edges, slc.wx, slc.wy)

    # -- lanes ---------------------------------------------------------------

    def _count_binary(self, slc: BoxSlice) -> int:
        chunk = min(self.chunk, _pow2(slc.n_edges, lo=256))
        npad, deg = slc.padded(self.torch_device)
        eu, ev = slc.edges(self.torch_device)
        return int(_count_chunked(npad, eu, ev, chunk=chunk, deg=deg))

    def _count_host(self, slc: BoxSlice) -> int:
        """Σ_edges |N(u) ∩ N(v)| on the host, pure numpy.

        Binary-search probing vectorized as ONE ``searchsorted`` per edge
        chunk: each edge's b-row is lifted into a disjoint int64 key range
        (row_id · (SENTINEL+1) + value), so the flattened key array stays
        sorted and a row-local probe becomes a global one. numpy's
        searchsorted/compare kernels release the GIL, so this lane scales
        across the async scheduler's workers.
        """
        m = slc.n_edges
        if m == 0:
            return 0
        off, vals = slc.row_off, slc.row_vals
        deg = np.diff(off)
        # keys lift each edge's sorted neighbor run into a disjoint range
        # (edge_pos · stride + value), so the concatenation stays sorted
        # and ONE global lower-bound probes every edge at once. stride only
        # has to clear the value domain — int32 keys when (chunk_edges ·
        # stride) fits, halving the memory traffic of the lift
        stride = np.int64(max(int(vals.max(initial=0)) + 1, 1))
        max32 = int((np.iinfo(np.int32).max - stride + 1) // stride)

        def lift(rows: np.ndarray) -> np.ndarray:
            d = deg[rows]
            n = int(d.sum())
            if n == 0:
                return np.zeros(0, np.int64)
            r0 = np.repeat(off[rows], d)
            within = np.arange(n) - np.repeat(np.cumsum(d) - d, d)
            if len(rows) <= max32:
                rid = np.repeat(
                    np.arange(len(rows), dtype=np.int32)
                    * np.int32(stride), d)
                return vals[r0 + within] + rid
            rid = np.repeat(np.arange(len(rows), dtype=np.int64), d)
            return vals[r0 + within].astype(np.int64) + rid * stride

        # chunk the edge list so the lifted key arrays stay ~bounded; the
        # probe work scales with real neighbor entries (CSR), never the
        # padded width a box hub row inflates
        load = np.cumsum(deg[slc.eu] + deg[slc.ev])
        total = 0
        s = 0
        while s < m:
            base = int(load[s - 1]) if s else 0
            e = int(np.searchsorted(load, base + 4_000_000, side="right"))
            e = min(max(e, s + 1), s + max(1, max32))
            ak = lift(slc.eu[s:e])
            bk = lift(slc.ev[s:e])
            if len(ak) > len(bk):
                ak, bk = bk, ak          # probe the smaller into the larger
            if len(ak) and len(bk):
                pos = np.searchsorted(bk, ak)
                np.minimum(pos, bk.size - 1, out=pos)
                total += int((bk[pos] == ak).sum())
            s = e
        return total

    def _count_dense(self, slc: BoxSlice) -> Optional[int]:
        """Σ mask ⊙ (Ax Ayᵀ) over the *compacted* z domain.

        Columns span only the z values that actually occur in the slice's
        neighbor lists (renumbered), so the one-hot rows scale with the box,
        not with V. The one-hots are scattered as uint8 straight from the
        slice's compact CSR (``row_off``/``row_vals``) — the dense lane
        never materializes the padded matrix. Returns ``None`` when the
        exact one-hot footprint would exceed ``dense_words_cap``; the caller
        then falls back to the intersect (card) or binary lane.
        """
        off, vals = slc.row_off, slc.row_vals
        zdom = np.unique(vals)
        if len(zdom) == 0:
            return 0
        rows_x = np.unique(slc.eu)
        rows_y = np.unique(slc.ev)
        if (len(rows_x) + len(rows_y)) * len(zdom) > self.dense_words_cap:
            return None
        deg_all = np.diff(off)

        # zero columns past the z domain are inert; a width that is a
        # multiple of 16 keeps every row's start 16-byte aligned for the
        # kernel's word loads
        width = -(-len(zdom) // 16) * 16

        def one_hot(rows_local):
            a = np.zeros((len(rows_local), width), dtype=np.uint8)
            d = deg_all[rows_local]
            n = int(d.sum())
            if n:
                rr = np.repeat(np.arange(len(rows_local)), d)
                idx = np.repeat(off[rows_local], d) + np.arange(n) \
                    - np.repeat(np.cumsum(d) - d, d)
                a[rr, np.searchsorted(zdom, vals[idx])] = 1
            return a

        ax, ay = one_hot(rows_x), one_hot(rows_y)
        mask = np.zeros((len(rows_x), len(rows_y)), dtype=np.uint8)
        mask[np.searchsorted(rows_x, slc.eu),
             np.searchsorted(rows_y, slc.ev)] = 1
        dev = self.torch_device
        return int(dense_ops.triangle_count(
            torch.from_numpy(ax).to(dev), torch.from_numpy(ay).to(dev),
            torch.from_numpy(mask).to(dev)))

    def _count_intersect(self, slc: BoxSlice) -> int:
        """One intersect launch over every in-box edge: the kernel reads
        the slice's compact CSR at the edges' local row ids, so no padded
        matrix is built. The kernel ledger gets the reference's one note
        per box, for the padded matrix its lane reads."""
        dev = self.torch_device
        off = torch.from_numpy(slc.row_off).to(dev)
        vals = torch.from_numpy(slc.row_vals).to(dev)
        eu, ev = slc.edges(dev)
        total = intersect_ops.intersect_count_csr(off, vals, eu.long(), off,
                                                  vals, ev.long())
        slc.charge_padded = True
        intersect_ops.note_padded(slc.padded_words, slc.n_edges)
        return int(total)

    def _count_binned_slice(self, slc: BoxSlice) -> int:
        """Per-box degree-binned count (``degree_bins=True``): the slice's
        rows grouped into the power-of-4 width classes of
        ``pad_neighbors_binned``, each edge probing its (bin_u, bin_v)
        pair. On the CPU that is the plain ``_count_rows_chunked`` over the
        bin matrices, pair by pair, as in the reference; on the card one
        ``intersect_count_csr`` launch over the slice's compact CSR at the
        live edges' rows, with no bin matrix built. Either way the
        reference's per-bin padded words are charged, and no kernel-ledger
        note is made (the reference's binned lane is not a kernel
        launch)."""
        if slc.n_edges == 0:
            return 0
        row_bin, widths = bin_layout(np.diff(slc.row_off))
        extra = int(np.dot(np.bincount(row_bin[row_bin >= 0],
                                       minlength=len(widths)), widths))
        bu = row_bin[slc.eu]
        bv = row_bin[slc.ev]
        live = (bu >= 0) & (bv >= 0)   # deg-0 rows intersect to nothing
        dev = self.torch_device
        if self.use_kernels:
            off = torch.from_numpy(slc.row_off).to(dev)
            vals = torch.from_numpy(slc.row_vals).to(dev)
            total = int(intersect_ops.intersect_count_csr(
                off, vals, torch.from_numpy(slc.eu[live]).to(dev).long(),
                off, vals, torch.from_numpy(slc.ev[live]).to(dev).long()))
        else:
            _, bins = pad_neighbors_binned(slc.row_off, slc.row_vals)
            bin_pos = np.zeros(max(1, len(row_bin)), dtype=np.int64)
            for rows_b, _ in bins:
                bin_pos[rows_b] = np.arange(len(rows_b))
            total = 0
            for i, j in sorted(set(zip(bu[live].tolist(),
                                       bv[live].tolist()))):
                sel = np.flatnonzero(live & (bu == i) & (bv == j))
                a_rows = bins[i][1][bin_pos[slc.eu[sel]]]
                b_rows = bins[j][1][bin_pos[slc.ev[sel]]]
                chunk = min(self.chunk, _pow2(len(sel), lo=256))
                total += int(_count_rows_chunked(
                    torch.from_numpy(a_rows).to(dev),
                    torch.from_numpy(b_rows).to(dev), chunk=chunk))
        self._note_padding(slc, extra=extra)
        return total

    def _count_fused(self, slc: BoxSlice) -> Optional[int]:
        """Whole-box triangle count in ONE device invocation: the fused
        LFTJ lane (``kernels.lftj_fused``). The triangle query ships as
        three box-restricted atoms in compact CSR form — the in-box edge
        list as R(x, y) plus the slice's neighbor lists re-keyed by the
        edge endpoints as S(x, z) and T(y, z) — so the whole loop nest
        runs on the device. Returns ``None`` when the box falls outside the
        kernel's envelope; the caller falls back to the staged lanes."""
        if slc.n_edges == 0:
            return 0
        off, vals = slc.row_off, slc.row_vals
        deg = np.diff(off)

        def sub_csr(local_rows: np.ndarray):
            d = deg[local_rows]
            n = int(d.sum())
            so = np.concatenate([np.zeros(1, np.int64),
                                 np.cumsum(d, dtype=np.int64)])
            if n == 0:
                return so, vals[:0]
            r0 = np.repeat(off[local_rows], d)
            within = np.arange(n) - np.repeat(np.cumsum(d) - d, d)
            return so, vals[r0 + within]

        # R(x, y): the in-box edges, grouped by global source id (rows is
        # sorted, so local-id order == global-id order)
        gu = slc.rows[slc.eu]
        gv = slc.rows[slc.ev]
        order = np.lexsort((gv, gu))
        gu_s, gv_s = gu[order], gv[order]
        keys0, counts0 = np.unique(gu_s, return_counts=True)
        off0 = np.concatenate([np.zeros(1, np.int64),
                               np.cumsum(counts0, dtype=np.int64)])
        uniq_u = np.unique(slc.eu)
        uniq_v = np.unique(slc.ev)
        off1, vals1 = sub_csr(uniq_u)
        off2, vals2 = sub_csr(uniq_v)
        dev = self.torch_device
        csrs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in csr)
                for csr in ((keys0, off0, gv_s),
                            (slc.rows[uniq_u], off1, vals1),
                            (slc.rows[uniq_v], off2, vals2))]
        try:
            return fused_ops.fused_count(((0, 1), (0, 2), (1, 2)), csrs, 3)
        except fused_ops.FusedUnsupported:
            return None

    def _count_slice(self, slc: BoxSlice) -> int:
        with kernel_ledger.attach() as kl:
            out = self._count_slice_dispatch(slc)
        if self.stats is not None and kl.invocations:
            with self._stats_lock:
                self.stats.device_invocations += kl.invocations
                self.stats.device_transfer_bytes += kl.transfer_bytes
                self.stats.max_box_device_invocations = max(
                    self.stats.max_box_device_invocations, kl.invocations)
        return out

    def _count_slice_dispatch(self, slc: BoxSlice) -> int:
        be = self._backend_for(slc)
        if be == "fused":
            out = self._count_fused(slc)
            if out is not None:
                if self.stats is not None:
                    with self._stats_lock:
                        self.stats.n_fused_boxes += 1
                self._note_padding(slc)
                return out
            # box outside the fused kernel's envelope: fall back to the
            # staged kernel lane on the card, the binary lane elsewhere
            be = "intersect" if self.use_kernels else "binary"
        if be == "dense":
            out = self._count_dense(slc)
            if out is not None:
                if self.stats is not None:
                    with self._stats_lock:
                        self.stats.n_dense_boxes += 1
                self._note_padding(slc)
                return out
            # one-hot footprint over the cap: fall back. The box is above
            # the dense crossover, hence inside the intersect mid-band —
            # keep the kernel lane when running on the card
            be = "intersect" if self.use_kernels else "binary"
        if self.stats is not None:
            with self._stats_lock:
                if be == "intersect":
                    self.stats.n_intersect_boxes += 1
                elif be == "host":
                    self.stats.n_host_boxes += 1
                else:
                    self.stats.n_binary_boxes += 1
        if be == "intersect":
            out = self._count_intersect(slc)
        elif be == "host":
            out = self._count_host(slc)
        elif self.degree_bins:
            # the binned lane charges its own padded words
            return self._count_binned_slice(slc)
        else:
            out = self._count_binary(slc)
        self._note_padding(slc)
        return out

    def _list_slice(self, slc: BoxSlice,
                    capacity: Optional[int]) -> Optional[np.ndarray]:
        """One box's triangles (global vertex ids), bounded buffer +
        overflow→rescan. Deterministic per slice, so serial and parallel
        runs produce identical per-box arrays."""
        # listing always runs the intersection path (dense is count-only),
        # so no lane counters are recorded here
        chunk = min(self.chunk, 1024)
        npad, deg = slc.padded(self.torch_device)
        eu, ev = slc.edges(self.torch_device)
        cap = _pow2(capacity if capacity is not None
                    else max(256, slc.n_edges))
        while True:
            total, buf = _list_chunked(npad, eu, ev, cap=cap, chunk=chunk,
                                       deg=deg)
            if total <= cap:
                break
            if self.stats is not None:
                with self._stats_lock:
                    self.stats.n_rescans += 1
            cap *= 2
        self._note_padding(slc)
        if total == 0:
            return None
        tris = buf[:total].cpu().numpy().astype(np.int64)
        tris[:, 0] = slc.rows[tris[:, 0]]   # local -> global ids
        tris[:, 1] = slc.rows[tris[:, 1]]   # (z is already global)
        device = getattr(self.source, "device", None)
        if device is not None:
            device.write_words(3 * total)
        return tris

    # -- async scheduler (workers > 1) ----------------------------------------

    def _est_slice_words(self, box) -> int:
        """Raw CSR words ``_materialize`` will read for ``box``, estimated
        from the resident degree index (exact for an uncached source: the
        same row ranges are summed that the materializer reads)."""
        ip = np.asarray(self.source.indptr)
        nv = self.source.n_nodes
        lx, hx, ly, hy = box
        lx_, hx_ = max(int(lx), 0), min(int(hx), nv - 1)
        ly_, hy_ = max(int(ly), 0), min(int(hy), nv - 1)
        if hx_ < lx_ or hy_ < ly_:
            return 0
        words = int(ip[hx_ + 1] - ip[lx_])
        for seg_lo, seg_hi in ((ly_, min(hy_, lx_ - 1)),
                               (max(ly_, hx_ + 1), hy_)):
            if seg_hi >= seg_lo:
                words += int(ip[seg_hi + 1] - ip[seg_lo])
        return words

    def _queue_order(self, boxes: List) -> List[int]:
        """Priority order the shared queue is drained in
        (``sharding.box_queue_order``): LPT-first for uncharged in-memory
        sources, plan order when a ``SliceCache`` or a charged
        ``BlockDevice`` is attached (fetches are serialized in queue order,
        so the device's LRU frame hits and the cache's hit/miss sequence
        then match the ``workers=1`` run)."""
        ledger = isinstance(self.source, SliceCache) \
            or getattr(self.source, "device", None) is not None
        return box_queue_order([self._est_slice_words(b) for b in boxes],
                               ledger_sensitive=ledger)

    def _fetch_with_words(self, box) -> Tuple[object, int]:
        """``run_box_queue`` fetch stage: the box's source reads + their
        raw word count (the window-admission correction)."""
        fetched = self._fetch(box)
        return fetched, (fetched[-1] if fetched is not None else 0)

    def _build_slice(self, fetched) -> Optional[BoxSlice]:
        """``run_box_queue`` build stage: numpy compaction (no source
        access); ``None`` drops empty boxes before the lane runs."""
        slc = self._compact(fetched)
        if slc is None or slc.n_edges == 0:
            return None
        self._note(slc)
        return slc

    def _run_parallel(self, boxes: List, work: Callable) -> List:
        """Run ``work(slc)`` for every box on the shared worker pool
        (``run_box_queue``): per-box results in *plan order* (``None`` for
        empty boxes) so callers reduce deterministically regardless of
        completion order."""
        results, tele = run_box_queue(
            boxes, order=self._queue_order(boxes),
            est_words=self._est_slice_words,
            fetch=self._fetch_with_words,
            build=self._build_slice,
            work=work,
            workers=self.workers,
            inflight_items=self.inflight_boxes,
            inflight_words=self.inflight_words)
        if self.stats is not None:
            merge_queue_telemetry(self.stats, tele, self._stats_lock,
                                  inflight_boxes=self.inflight_boxes)
        return results

    # -- public entry points --------------------------------------------------

    def count_box(self, box, x_slab=None) -> int:
        """One-off execution of a single box (no prefetch pipeline)."""
        slc = self._materialize(box, x_slab=x_slab)
        if slc is None or slc.n_edges == 0:
            return 0
        self._note(slc)
        return self._count_slice(slc)

    def run_count(self, boxes) -> int:
        boxes = list(boxes)
        if self.workers > 1 and len(boxes) > 1:
            results = self._run_parallel(boxes, self._count_slice)
            # deterministic reduction: fixed box order, not arrival order
            return sum(r for r in results if r is not None)
        total = 0
        pf = self._stream(boxes)
        try:
            for slc in pf:
                if slc is None or slc.n_edges == 0:
                    continue
                self._note(slc)
                total += self._count_slice(slc)
        finally:
            # a consumer-side error must not leave the producer thread
            # reading the source (and charging the device) in the background
            pf.close()
        return total

    def run_list(self, boxes, capacity: Optional[int] = None) -> np.ndarray:
        """Enumerate triangles across the box stream (global vertex ids).

        Per box, a bounded buffer holds candidates; the lane returns the
        exact per-box total alongside, so overflow is resolved by rescanning
        *that box* at doubled capacity (the engine's overflow→rescan
        protocol, box-granular). With ``workers>1`` boxes run on the async
        scheduler and the per-box arrays concatenate in fixed box order —
        identical output to the sequential run.
        """
        boxes = list(boxes)
        if self.workers > 1 and len(boxes) > 1:
            parts = self._run_parallel(
                boxes, lambda slc: self._list_slice(slc, capacity))
            parts = [p for p in parts if p is not None]
            if not parts:
                return np.zeros((0, 3), dtype=np.int64)
            return np.concatenate(parts)
        out: List[np.ndarray] = []
        pf = self._stream(boxes)
        try:
            for slc in pf:
                if slc is None or slc.n_edges == 0:
                    continue
                self._note(slc)
                tris = self._list_slice(slc, capacity)
                if tris is not None:
                    out.append(tris)
        finally:
            pf.close()
        if not out:
            return np.zeros((0, 3), dtype=np.int64)
        return np.concatenate(out)
