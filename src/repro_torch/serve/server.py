"""Persistent in-process query serving: ``Server`` + ``Session``.

The one-shot engines (``TriangleEngine``, ``QueryEngine``) pay their warm-up
on every call: open the store, plan the boxes, cold caches. A resident
``Server`` keeps everything warm and serves *concurrent* queries against one
memory budget without giving up the paper's per-query I/O envelopes:

* **warm stores** — every relation is opened once (mmap ``EdgeStore`` /
  in-memory CSR), registered on ONE shared ``BlockDevice``;
* **admission control** (``serve.admission``) — a query is admitted with a
  reservation ``m_i`` partitioning ``mem_words``; its boxes are planned
  against ``m_i`` (never the global budget), so Thm. 10/13 hold per query;
  oversubscription queues (bounded) or rejects gracefully;
* **per-query device partitions** — the shared device's frames are split
  with ``BlockDevice.open_tag``: each query's reads run under
  ``device.attributed(qid)`` against a private ``m_i/B``-frame LRU, so one
  query's scan can't thrash another's frames and the global ledger is the
  exact sum over queries;
* **shared slice cache** (``serve.cache``) — per relation, ONE
  ``SharedSliceCache`` spanning queries: floor-protected eviction keeps
  each tenant's guaranteed slice resident while overlapping queries feed
  each other hits;
* **plan cache** — box plans are memoized per (pattern shape, order,
  budget, skew) the same way ``core.engine`` keys its crossover cache, so
  a repeated pattern shape skips planning entirely;
* **retry rounds** (``runtime.straggler.BoxScheduler``) — boxes are
  idempotent, so a failed stage (I/O error, fault injection) is captured
  per box, the completed boxes keep their results, and only the failed
  ones re-queue — with completion dedup by box id — for up to
  ``box_retries`` extra rounds;
* **streamed listing** — ``submit(..., stream=True)`` pages bindings out
  in plan order through a bounded queue (the engines' bounded-buffer
  listing protocol one level up: per-box buffers bound memory inside a
  box, the page queue bounds it across boxes; a full queue backpressures
  the worker pool).

Everything runs in-process on threads (the shared box worker pool
underneath): query runners × box workers, every kernel launch on the
device's default stream. ``Session`` is the blocking convenience facade.
The kernel lanes run on ``torch_device`` (``"cuda"`` by default, which
raises at construction when no CUDA device is available; ``"cpu"`` runs
the kernel wrappers' plain torch versions).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import resolve_torch_device
from repro_torch.core.executor import (BoxQueueCancelled,
                                       merge_queue_telemetry, run_box_queue)
from repro_torch.core.iomodel import BlockDevice
from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
from repro_torch.core.queries import Query, validate
from repro_torch.data.edgestore import EdgeStore, InMemoryEdgeSource
from repro_torch.data.graphs import unique_pairs
from repro_torch.query.executor import BACKENDS, QueryEngine, QueryStats
from repro_torch.query.patterns import PATTERNS
from repro_torch.runtime.straggler import BoxScheduler

from .admission import AdmissionController, AdmissionError
from .cache import SharedSliceCache, TenantView

if TYPE_CHECKING:
    # loaded in fabric_run, so ``python -m repro_torch.parallel.fabric``
    # runs its module once
    from repro_torch.parallel.fabric import FabricStats


class QueryError(RuntimeError):
    """Base class of per-query serving failures."""


class QueryCancelled(QueryError):
    """The query's ``cancel()`` fired before its boxes drained."""


class QueryFailed(QueryError):
    """The query exhausted its retry rounds; ``cause`` is the last box
    error. The failure is contained: the server keeps serving, and the
    shared caches hold only blocks written through normal reads."""

    def __init__(self, msg: str, cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.cause = cause


class _BoxError:
    """Captured per-box stage exception: a marker *result* instead of a
    raised error, so one bad box never cancels the whole queue — the
    round loop re-queues exactly the marked boxes."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()                      # page-stream terminator


class _PageStream:
    """Plan-order reorder buffer feeding a bounded page queue.

    Boxes complete out of order across the worker pool; listing pages must
    stream in plan order (the determinism contract). ``offer(idx, rows)``
    parks results until the next-expected plan index arrives, then emits
    its pages — split to ``page_rows`` — into a bounded ``queue.Queue``.
    A full queue *blocks the offering worker* (backpressure on the pool);
    the block is cancellable, so an abandoned consumer can't wedge the
    server. The pages of one offer are put under ``_emit``, taken before
    the reorder lock is released, so two workers' runs of boxes leave in
    plan order even while the first blocks on a full queue (the
    reference's stream puts them unordered: its pages interleave across
    boxes when several workers drive one listing)."""

    def __init__(self, head_fn, cancel: threading.Event,
                 page_rows: int, depth: int):
        self._head = head_fn
        self._cancel = cancel
        self._page_rows = max(1, int(page_rows))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._lock = threading.Lock()
        self._emit = threading.Lock()
        self._pending: Dict[int, Optional[np.ndarray]] = {}
        self._offered: set = set()
        self._next = 0
        self.n_pages = 0

    def offer(self, idx: int, rows: Optional[np.ndarray]) -> None:
        ready: List[np.ndarray] = []
        with self._lock:
            if idx in self._offered:     # a straggler duplicate / retry
                return
            self._offered.add(idx)
            self._pending[idx] = rows
            while self._next in self._pending:
                r = self._pending.pop(self._next)
                self._next += 1
                if r is not None and len(r):
                    proj = self._head(r)
                    for s in range(0, len(proj), self._page_rows):
                        ready.append(proj[s:s + self._page_rows])
            if not ready:
                return
            self._emit.acquire()
        try:
            for page in ready:
                self._put(page)
        finally:
            self._emit.release()

    def _put(self, item) -> None:
        while True:
            if self._cancel.is_set():
                return               # consumer abandoned: drop, don't wedge
            try:
                self._q.put(item, timeout=0.05)
                self.n_pages += item is not _END and not \
                    isinstance(item, BaseException)
                return
            except queue.Full:
                continue

    def finish(self, error: Optional[BaseException] = None) -> None:
        self._put(error if error is not None else _END)

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._cancel.is_set():
                    raise QueryCancelled("query cancelled") from None
                continue
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class QueryHandle:
    """One submitted query: status, result, pages, cancel, stats."""

    def __init__(self, qid: str, query: Query, mode: str):
        self.qid = qid
        self.query = query
        self.mode = mode
        self.status = "queued"       # -> running -> done|error|cancelled
        self.admitted_words: int = 0
        self.cache_floor: int = 0
        self.stats: Optional[QueryStats] = None
        self.retry_rounds: int = 0
        self._cancel = threading.Event()
        self._done = threading.Event()
        self.submitted_at: Optional[float] = None  # perf_counter at submit
        self._result = None
        self._error: Optional[BaseException] = None
        self._stream: Optional[_PageStream] = None
        self._thread: Optional[threading.Thread] = None

    def cancel(self) -> None:
        """Cooperative cancel: no further box is claimed, in-progress boxes
        finish (they're idempotent — resubmitting re-runs them exactly),
        admission and cache registrations release."""
        self._cancel.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        """Block for the final result: the count (mode='count') or the
        (m, len(head)) binding rows (mode='list'). Raises
        ``QueryCancelled`` / ``QueryFailed`` / ``TimeoutError``."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"query {self.qid} still "
                               f"{self.status} after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def pages(self):
        """Iterate listing pages in plan order (``stream=True`` handles
        only): each page is an (≤page_rows, len(head)) array. Raises the
        query's failure/cancellation mid-iteration."""
        if self._stream is None:
            raise QueryError(
                f"query {self.qid} was not submitted with stream=True; "
                "use result()")
        return iter(self._stream)


class Server:
    """Resident concurrent query service over warm relations (module doc).

    Parameters
    ----------
    relations : mapping name -> relation source: an ``EdgeStore`` or a
        path to one (mmap, warm), an ``InMemoryEdgeSource``, or a directed
        ``(src, dst)`` edge-array pair.
    mem_words : the TOTAL working-memory budget concurrent queries
        partition (admission grants ``m_i`` slices of it).
    cache_words : shared per-relation ``SharedSliceCache`` budget;
        default ``mem_words`` (the resident slice memory mirrors the
        working budget). 0 disables the shared cache.
    max_active / queue_depth / min_words : admission knobs
        (``serve.admission.AdmissionController``).
    workers_per_query : box-pool threads each query runs on.
    box_retries : extra rounds re-queuing failed boxes before the query
        errors out.
    page_rows / page_queue_depth : streamed-listing pagination.
    backend / skew / heavy_threshold / use_kernels / torch_device :
        forwarded to every ``QueryEngine`` and ``Fabric``; ``backend`` is
        one of ``query.executor.BACKENDS`` (the reference's "pallas" is
        "intersect" here). ``torch_device`` is resolved once, here: the
        default ``"cuda"`` raises when no CUDA device is available.
    """

    def __init__(self, relations: Dict[str, object], *,
                 mem_words: int,
                 cache_words: Optional[int] = None,
                 io_block_words: int = 4096,
                 min_words: int = 1 << 12,
                 max_active: int = 8,
                 queue_depth: int = 8,
                 workers_per_query: int = 1,
                 box_retries: int = 2,
                 page_rows: int = 4096,
                 page_queue_depth: int = 4,
                 backend: str = "auto",
                 skew: str = "uniform",
                 heavy_threshold: Optional[int] = None,
                 use_kernels: bool = True,
                 torch_device="cuda",
                 tracer=None,
                 metrics=None):
        if not relations:
            raise ValueError("Server needs at least one relation")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        # observability: one obs.trace.Tracer spanning every query this
        # server runs (admission -> plan -> boxes -> pages), and one
        # MetricsRegistry adopting the server's ledgers (device tags,
        # shared caches, per-query latency histograms)
        self.tracer = tracer
        self.metrics = metrics
        self.mem_words = int(mem_words)
        self.cache_words = self.mem_words if cache_words is None \
            else int(cache_words)
        self.workers_per_query = max(1, int(workers_per_query))
        self.box_retries = max(0, int(box_retries))
        self.page_rows = int(page_rows)
        self.page_queue_depth = int(page_queue_depth)
        self.backend = backend
        self.skew = skew
        self.heavy_threshold = heavy_threshold
        self.use_kernels = bool(use_kernels)
        self.torch_device = resolve_torch_device(torch_device)

        self.device = BlockDevice(
            block_words=io_block_words,
            cache_blocks=max(2, self.mem_words // io_block_words))
        self.admission = AdmissionController(
            self.mem_words, min_words=min_words,
            max_active=max_active, queue_depth=queue_depth)
        # per-tenant guaranteed cache slice: the shared budget split by the
        # admission concurrency bound (Σ floors ≤ budget by construction)
        self.floor_words = self.cache_words // max(1, max_active) \
            if self.cache_words > 0 else 0

        # -- warm the relations -------------------------------------------
        self._sources: Dict[str, object] = {}
        self._specs: Dict[str, tuple] = {}   # how solo_run rebuilds them
        for name, spec in relations.items():
            self._sources[name] = self._open_source(name, spec, self.device)
        self.caches: Dict[str, SharedSliceCache] = {}
        if self.cache_words > 0:
            for name, src in self._sources.items():
                self.caches[name] = SharedSliceCache(src, self.cache_words,
                                                     tracer=tracer)
        if metrics is not None:
            metrics.adopt_device(self.device)
            for name, cache in self.caches.items():
                metrics.adopt_shared_cache(cache, relation=name)

        self._plans: Dict[str, object] = {}
        self._orders: Dict[tuple, Tuple[str, ...]] = {}
        self.plan_hits = 0
        self.plan_misses = 0
        self._lock = threading.Lock()
        self._qid = itertools.count()
        self._handles: Dict[str, QueryHandle] = {}
        self._closed = False
        # test hook: callable(stage, qid, plan_idx) run at the head of a
        # box stage; raising injects a fault into exactly that box attempt
        self.fault_hook = None

    # -- relation warm-up -----------------------------------------------------

    def _open_source(self, name: str, spec, device: BlockDevice):
        if isinstance(spec, (str, os.PathLike)):
            src = EdgeStore(spec, device=device)
            self._specs[name] = ("store", src.path)
            return src
        if hasattr(spec, "read_rows"):
            src = spec
            if isinstance(src, EdgeStore):
                src.attach_device(device)
                self._specs[name] = ("store", src.path)
            else:
                if getattr(src, "device", None) is None:
                    src.device = device
                    if src.n_edges:
                        device.register(src.indices)
                self._specs[name] = ("memory", src.indptr, src.indices,
                                     getattr(src, "orientation", "raw"))
            return src
        if isinstance(spec, tuple) and len(spec) == 2 \
                and not isinstance(spec[0], str):
            u = np.asarray(spec[0], dtype=np.int64)
            v = np.asarray(spec[1], dtype=np.int64)
            nv = int(max(u.max(initial=-1), v.max(initial=-1))) + 1
            if len(u):
                u, v = unique_pairs(u, v)
            ip, ix = csr_from_edges(u, v, n_nodes=nv) if nv else \
                (np.zeros(1, np.int64), np.zeros(0, np.int32))
            src = InMemoryEdgeSource(ip, ix, orientation="raw",
                                     device=device)
            self._specs[name] = ("memory", ip, ix, "raw")
            return src
        raise ValueError(f"relation {name!r}: unsupported source "
                         f"{type(spec)}")

    @classmethod
    def from_graph(cls, src, dst, *, relation: str = "E",
                   orientation: str = "minmax", **kw) -> "Server":
        """Server over one undirected graph, oriented exactly as
        ``TriangleEngine`` / ``QueryEngine.from_graph`` orient it."""
        a, b = orient_edges(np.asarray(src), np.asarray(dst), orientation)
        nv = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
        ip, ix = csr_from_edges(a, b, n_nodes=nv) if nv else \
            (np.zeros(1, np.int64), np.zeros(0, np.int32))
        return cls({relation: InMemoryEdgeSource(ip, ix,
                                                 orientation=orientation)},
                   **kw)

    # -- plan / order caches ---------------------------------------------------

    @staticmethod
    def _resolve_query(query) -> Query:
        if isinstance(query, str):
            try:
                return PATTERNS[query]()
            except KeyError:
                raise ValueError(
                    f"unknown pattern {query!r}; known: {list(PATTERNS)}")
        return query

    def _shape_sig(self, query: Query) -> tuple:
        return (tuple((a.rel, tuple(a.vars)) for a in query.atoms),
                tuple(query.head))

    def _order_for(self, query: Query) -> Tuple[str, ...]:
        """Variable order memoized per pattern shape. Consistency with
        every atom is REQUIRED (store-backed relations can't build
        reordered indexes), so an order-less shape without one is rejected
        at submit, not mid-run."""
        sig = self._shape_sig(query)
        with self._lock:
            order = self._orders.get(sig)
        if order is None:
            order = validate(query, None, require_consistent=True)
            with self._lock:
                self._orders[sig] = order
        return order

    def _plan_key(self, query: Query, order: Sequence[str],
                  m_words: int) -> str:
        """Plan-cache key, keyed the way ``core.engine`` keys its
        crossover cache: every planning input that changes the boxes —
        pattern shape, variable order, budget, skew lane policy — in one
        string (the degree indexes are fixed for a server's lifetime)."""
        sig = self._shape_sig(query)
        return (f"{sig}:{tuple(order)}:m{m_words}:{self.skew}"
                f":h{self.heavy_threshold}")

    # -- submission ------------------------------------------------------------

    def submit(self, query, mode: str = "count", *,
               want_words: Optional[int] = None,
               workers: Optional[int] = None,
               capacity: Optional[int] = None,
               stream: bool = False,
               block: bool = True,
               timeout: Optional[float] = None) -> QueryHandle:
        """Admit and launch one query; returns its handle immediately.

        Admission happens HERE, synchronously: ``AdmissionRejected`` /
        ``AdmissionTimeout`` raise from ``submit`` (graceful rejection —
        nothing was started), with ``block``/``timeout`` selecting between
        immediate rejection and bounded queueing. ``mode`` is 'count' or
        'list'; ``stream=True`` (list only) pages results through
        ``handle.pages()``."""
        if self._closed:
            raise QueryError("server is closed")
        if mode not in ("count", "list"):
            raise ValueError(f"mode {mode!r} not in ('count', 'list')")
        if stream and mode != "list":
            raise ValueError("stream=True needs mode='list'")
        query = self._resolve_query(query)
        missing = [a.rel for a in query.atoms if a.rel not in self._sources]
        if missing:
            raise ValueError(f"unknown relation(s) {sorted(set(missing))}; "
                             f"serving {sorted(self._sources)}")
        order = self._order_for(query)     # rejects unservable shapes early

        qid = f"q{next(self._qid)}"
        h = QueryHandle(qid, query, mode)
        h.submitted_at = time.perf_counter()
        h.workers = self.workers_per_query if workers is None \
            else max(1, int(workers))
        h.capacity = capacity
        h.order = order
        # the admission gate: may queue (bounded) or raise AdmissionError
        if self.tracer is not None:
            with self.tracer.span("serve.admission", qid=qid, mode=mode):
                reservation = self.admission.acquire(
                    want_words, timeout=timeout, block=block, tag=qid)
        else:
            reservation = self.admission.acquire(
                want_words, timeout=timeout, block=block, tag=qid)
        h.admitted_words = reservation.words
        h.cache_floor = self.floor_words
        if stream:
            h._stream = _PageStream(
                lambda rows: rows,      # rebound once the engine exists
                h._cancel, self.page_rows, self.page_queue_depth)
        with self._lock:
            self._handles[qid] = h
        t = threading.Thread(target=self._runner, args=(h, reservation),
                             name=f"serve-{qid}", daemon=True)
        h._thread = t
        h.status = "running"
        t.start()
        return h

    # -- the per-query runner --------------------------------------------------

    def _runner(self, h: QueryHandle, reservation) -> None:
        try:
            if self.tracer is not None:
                with self.tracer.span("serve.query", qid=h.qid,
                                      mode=h.mode,
                                      words=reservation.words):
                    self._runner_impl(h, reservation)
            else:
                self._runner_impl(h, reservation)
        finally:
            # end-to-end latency (admission wait included: measured from
            # submit) feeding the serve.latency_s p50/p90/p99 histograms
            if self.metrics is not None and h.submitted_at is not None:
                self.metrics.observe(
                    "serve.latency_s",
                    time.perf_counter() - h.submitted_at,
                    mode=h.mode, status=h.status)

    def _runner_impl(self, h: QueryHandle, reservation) -> None:
        views: Dict[str, TenantView] = {}
        tag_opened = False
        try:
            qid, m = h.qid, reservation.words
            rel_names: List[str] = []
            for a in h.query.atoms:
                if a.rel not in rel_names:
                    rel_names.append(a.rel)
            # register this query as a tenant of every relation cache it
            # reads; if the floors are momentarily oversubscribed (admission
            # races a finishing query's unregister) fall back to floor 0 —
            # correctness is unaffected, only the residency guarantee.
            sources: Dict[str, object] = {}
            for name in rel_names:
                cache = self.caches.get(name)
                if cache is None:
                    sources[name] = self._sources[name]
                    continue
                try:
                    views[name] = cache.register(qid, h.cache_floor)
                except ValueError:
                    views[name] = cache.register(qid, 0)
                sources[name] = views[name]
            self.device.open_tag(qid, max(2, m // self.device.B))
            tag_opened = True

            plan_key = self._plan_key(h.query, h.order, m)
            with self._lock:
                plan0 = self._plans.get(plan_key)
            eng = QueryEngine(h.query, relations=sources, order=h.order,
                              mem_words=m, cache_words=0,
                              device=self.device, backend=self.backend,
                              workers=h.workers, skew=self.skew,
                              heavy_threshold=self.heavy_threshold,
                              plan=plan0, cancel=h._cancel,
                              use_kernels=self.use_kernels,
                              torch_device=self.torch_device,
                              tracer=self.tracer, metrics=self.metrics)
            plan = eng.plan()
            with self._lock:
                if plan0 is not None:
                    self.plan_hits += 1
                else:
                    self.plan_misses += 1
                    self._plans[plan_key] = plan
            if h._stream is not None:
                h._stream._head = eng.head_columns
            eng._reset_stats(plan)
            self._drive(h, eng, plan)
            self._finalize(h, eng, qid, views)
            h.status = "done"
        except BoxQueueCancelled as e:
            h.status = "cancelled"
            h._error = QueryCancelled(str(e))
        except AdmissionError as e:       # cache floor races, defensive
            h.status = "error"
            h._error = QueryFailed(f"query {h.qid}: {e}", e)
        except QueryError as e:
            h.status = "error"
            h._error = e
        except BaseException as e:
            h.status = "error"
            h._error = QueryFailed(f"query {h.qid} failed: {e}", e)
        finally:
            for name, view in views.items():
                self.caches[name].unregister(h.qid)
            if tag_opened:
                self.device.close_tag(h.qid)
            reservation.release()
            if h._stream is not None:
                h._stream.finish(h._error)
            h._done.set()

    def _drive(self, h: QueryHandle, eng: QueryEngine, plan) -> None:
        """Rounds of the shared box queue with per-box fault capture:
        completed boxes keep their results (dedup by box id in the
        scheduler), failed ones re-queue for the next round."""
        qid = h.qid
        cap = h.capacity if h.capacity is not None \
            else eng.default_list_capacity()
        est, fetch, build, work = eng.box_stages(h.mode, cap)
        sched = BoxScheduler(plan.boxes, n_workers=h.workers)
        hook = self.fault_hook

        def fetch_w(item):
            i, box = item
            try:
                if hook is not None:
                    hook("fetch", qid, i)
                with self.device.attributed(qid):
                    payload, words = fetch(box)
                return (i, payload), words
            except BaseException as e:          # noqa: BLE001 — captured
                return (i, _BoxError(e)), 0

        def build_w(payload):
            i, p = payload
            if p is None or isinstance(p, _BoxError):
                return (i, p)
            try:
                if hook is not None:
                    hook("build", qid, i)
                return (i, build(p))
            except BaseException as e:          # noqa: BLE001 — captured
                return (i, _BoxError(e))

        def work_w(built):
            i, b = built
            if b is None or isinstance(b, _BoxError):
                out = (i, b)
            else:
                try:
                    if hook is not None:
                        hook("work", qid, i)
                    with self.device.attributed(qid):
                        out = (i, work(b))
                except BaseException as e:      # noqa: BLE001 — captured
                    out = (i, _BoxError(e))
            if h._stream is not None and not isinstance(out[1], _BoxError):
                h._stream.offer(out[0], out[1])
                tr = self.tracer
                if tr is not None:
                    tr.event("serve.page.offer", qid=qid, box=out[0])
            return out

        last_err: Optional[BaseException] = None
        rounds = 0
        while True:
            pending = sched.pending()
            if not pending:
                break
            if h._cancel.is_set():
                raise BoxQueueCancelled(f"query {qid} cancelled")
            items = [(i, sched.tasks[i].payload) for i in pending]
            results, tele = run_box_queue(
                items,
                order=eng.queue_order([b for _, b in items]),
                est_words=lambda it: est(it[1]),
                fetch=fetch_w, build=build_w, work=work_w,
                workers=h.workers,
                inflight_items=eng.inflight_boxes,
                inflight_words=eng.inflight_boxes * eng.mem_words
                if eng.mem_words is not None else None,
                cancel=h._cancel,
                tracer=self.tracer)
            merge_queue_telemetry(eng.stats, tele, eng._stats_lock,
                                  inflight_boxes=eng.inflight_boxes,
                                  metrics=self.metrics)
            failed: List[int] = []
            for out in results:
                if out is None:
                    continue
                i, r = out
                if isinstance(r, _BoxError):
                    failed.append(i)
                    last_err = r.exc
                else:
                    sched.complete(0, i, r)
            if failed:
                rounds += 1
                if rounds > self.box_retries:
                    raise QueryFailed(
                        f"query {qid}: {len(failed)} box(es) still failing "
                        f"after {self.box_retries} retry round(s): "
                        f"{last_err}", last_err)
                sched.requeue(failed)
        h.retry_rounds = rounds
        h._sched = sched

    def _finalize(self, h: QueryHandle, eng: QueryEngine, qid: str,
                  views: Dict[str, TenantView]) -> None:
        results = h._sched.results()
        if h.mode == "count":
            # exact: each box's count read once as a Python int, summed
            # as Python ints (never through a 32-bit accumulator)
            h._result = sum(int(r) for r in results if r is not None)
            eng.stats.n_results = h._result
        else:
            parts = [r for r in results if r is not None]
            rows = np.concatenate(parts) if parts \
                else np.zeros((0, eng.n), dtype=np.int64)
            eng.stats.n_results = len(rows)
            h._result = eng.head_columns(rows)
        # per-query I/O from the device partition (the shared device's
        # global mark/collect would mix concurrent queries)
        t = self.device.tag_stats(qid)
        eng.stats.block_reads = t.block_reads
        eng.stats.block_writes = t.block_writes
        eng.stats.word_reads = t.word_reads
        for view in views.values():
            st = view.stats
            eng.stats.cache_hits += st.hits
            eng.stats.cache_misses += st.misses
            eng.stats.cache_hit_words += st.hit_words
        h.stats = eng.stats
        if self.metrics is not None:
            # QueryStats published as query.*{qid=..} gauges: the run-level
            # dataclass becomes a view the registry also holds
            self.metrics.publish_stats(eng.stats, "query", qid=qid,
                                       mode=h.mode)

    # -- solo oracle -----------------------------------------------------------

    def solo_run(self, query, mode: str = "count", *,
                 words: int, capacity: Optional[int] = None):
        """The per-query *solo envelope*: the same query on a fresh
        isolated stack — its own device with ``words/B`` frames, fresh
        sources, a private slice cache at this server's per-tenant floor —
        at budget ``words``. ``(result, QueryStats)``; the serving suite
        pins result exactness against it and the load benchmark bounds
        aggregate ``block_reads`` by the sum of these envelopes."""
        query = self._resolve_query(query)
        dev = BlockDevice(block_words=self.device.B,
                          cache_blocks=max(2, words // self.device.B))
        rels: Dict[str, object] = {}
        for name, spec in self._specs.items():
            if spec[0] == "store":
                rels[name] = EdgeStore(spec[1], device=dev)
            else:
                rels[name] = InMemoryEdgeSource(spec[1], spec[2],
                                                device=dev,
                                                orientation=spec[3])
        eng = QueryEngine(query, relations=rels,
                          order=self._order_for(query),
                          mem_words=words,
                          cache_words=self.floor_words,
                          device=dev, backend=self.backend,
                          workers=1, skew=self.skew,
                          heavy_threshold=self.heavy_threshold,
                          use_kernels=self.use_kernels,
                          torch_device=self.torch_device)
        out = eng.count() if mode == "count" else eng.list(capacity)
        return out, eng.stats

    # -- fabric-backed sessions ------------------------------------------------

    def fabric_run(self, query, mode: str = "count", *,
                   n_shards: Optional[int] = None,
                   want_words: Optional[int] = None,
                   workers: Optional[int] = None,
                   capacity: Optional[int] = None,
                   block: bool = True,
                   timeout: Optional[float] = None
                   ) -> Tuple[object, FabricStats]:
        """One query through the distributed box fabric
        (``parallel.fabric``) over this server's warm relations.

        Admission reserves ``want_words`` exactly like ``submit`` — the
        reservation is the PER-SHARD working budget (each shard models a
        remote host's local memory) and bounds the planning/shipping
        footprint on this server; shipping reads are charged to the
        server's shared device under a per-run attribution tag, while
        every shard executes against its own fresh device (the per-shard
        ledgers in the returned ``FabricStats`` keep the solo-oracle
        contract). Blocking call; returns ``(result, FabricStats)``."""
        from repro_torch.parallel.fabric import Fabric
        if self._closed:
            raise QueryError("server is closed")
        if mode not in ("count", "list"):
            raise ValueError(f"mode {mode!r} not in ('count', 'list')")
        query = self._resolve_query(query)
        missing = [a.rel for a in query.atoms if a.rel not in self._sources]
        if missing:
            raise ValueError(f"unknown relation(s) {sorted(set(missing))}; "
                             f"serving {sorted(self._sources)}")
        order = self._order_for(query)
        tag = f"fab{next(self._qid)}"
        reservation = self.admission.acquire(
            want_words, timeout=timeout, block=block, tag=tag)
        self.device.open_tag(tag, max(2, reservation.words // self.device.B))
        try:
            fab = Fabric(query, relations=dict(self._sources), order=order,
                         n_shards=n_shards, mem_words=reservation.words,
                         cache_words=self.floor_words,
                         io_block_words=self.device.B,
                         backend=self.backend,
                         workers=self.workers_per_query
                         if workers is None else max(1, int(workers)),
                         skew=self.skew,
                         heavy_threshold=self.heavy_threshold,
                         device=self.device,
                         use_kernels=self.use_kernels,
                         torch_device=self.torch_device,
                         tracer=self.tracer, metrics=self.metrics)
            with self.device.attributed(tag):
                out = fab.count() if mode == "count" else fab.list(capacity)
            return out, fab.stats
        finally:
            self.device.close_tag(tag)
            reservation.release()

    # -- lifecycle -------------------------------------------------------------

    def handles(self) -> List[QueryHandle]:
        with self._lock:
            return list(self._handles.values())

    def close(self, timeout: float = 30.0) -> None:
        """Cancel every live query and join all runner threads."""
        self._closed = True
        for h in self.handles():
            if not h.done():
                h.cancel()
        for h in self.handles():
            if h._thread is not None:
                h._thread.join(timeout)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Session:
    """Blocking convenience facade over one ``Server``: ``count`` /
    ``list`` submit-and-wait; per-session defaults for the submit knobs."""

    def __init__(self, server: Server, **defaults):
        self.server = server
        self.defaults = defaults
        self._live: List[QueryHandle] = []

    def submit(self, query, mode: str = "count", **kw) -> QueryHandle:
        merged = dict(self.defaults)
        merged.update(kw)
        h = self.server.submit(query, mode, **merged)
        self._live.append(h)
        return h

    def count(self, query, **kw) -> int:
        return self.submit(query, "count", **kw).result()

    def list(self, query, **kw) -> np.ndarray:
        return self.submit(query, "list", **kw).result()

    def fabric_count(self, query, **kw) -> int:
        """Distributed count through the server's box fabric
        (``Server.fabric_run``); session defaults apply."""
        merged = dict(self.defaults)
        merged.update(kw)
        return self.server.fabric_run(query, "count", **merged)[0]

    def fabric_list(self, query, **kw) -> np.ndarray:
        merged = dict(self.defaults)
        merged.update(kw)
        return self.server.fabric_run(query, "list", **merged)[0]

    def close(self) -> None:
        for h in self._live:
            if not h.done():
                h.cancel()
        for h in self._live:
            h.wait(30.0)
        self._live.clear()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
