"""Structured tracing: nestable spans, ring buffer, Perfetto export.

One :class:`Tracer` instance is shared by every layer of a run (engine,
query executor, box scheduler, serving layer, fabric shards). Design
constraints, in order:

1. **Zero cost when off.** Instrumented code holds ``self.tracer``
   (``None`` by default) and guards every emission with one attribute
   check — no wrapper objects, no dummy context managers on the hot
   path. Attaching a tracer must not change execution order, issue
   source reads, or touch any ledger: counts, listings and measured
   ``block_reads`` are byte-identical traced-on vs traced-off (the CI
   trace-smoke gate).
2. **Thread-correct nesting.** The span stack is thread-local (the
   pattern of ``kernels/ledger``): the async box scheduler's workers
   each see their own parent chain, and every event records the emitting
   thread id, so the Chrome/Perfetto timeline renders one lane per
   worker.
3. **Bounded memory.** Events land in a ring buffer (``capacity``
   begin/end/instant records, default 2^16); a long-running server
   keeps the most recent window instead of growing without bound.
   ``dropped`` counts what the ring evicted.

Spans record begin ("B") and end ("E") events with monotonic
microsecond timestamps relative to the tracer's epoch; ``event()``
records an instant ("i"). ``export_chrome(path)`` writes the standard
``trace_event`` JSON (loadable in Perfetto / ``chrome://tracing``);
``snapshot()`` returns the raw event dicts for tests.

**Lanes.** A fabric run merges shard executions into one trace:
``with tracer.lane("shard3"): ...`` assigns every event emitted by the
current thread to a named lane, exported as its own Chrome *process*
row (with a ``process_name`` metadata record), so stragglers and
shipping skew are visible side by side on one timeline.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Tracer", "wrap_stage"]

_DEFAULT_CAPACITY = 1 << 16


class _Span:
    """Reusable span context manager (one allocation per span)."""

    __slots__ = ("_tracer", "_sid")

    def __init__(self, tracer: "Tracer", sid: int):
        self._tracer = tracer
        self._sid = sid

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._end_span(self._sid)
        return False


class _Lane:
    """Thread-local lane context (``with tracer.lane("shard0"):``)."""

    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._prev = getattr(tracer._tls, "lane", None)
        tracer._tls.lane = name

    def __enter__(self) -> "_Lane":
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._tls.lane = self._prev
        return False


class Tracer:
    """Thread-safe span/event recorder with a bounded ring buffer."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = max(16, int(capacity))
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._t0 = time.perf_counter()
        self._len_before = 0       # events ever appended (for `dropped`)

    # -- emission -------------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _emit(self, rec: dict) -> None:
        with self._lock:
            self._len_before += 1
            self._events.append(rec)

    def span(self, name: str, **attrs) -> _Span:
        """Open a nested span; use as ``with tracer.span("box.fetch"): ...``.

        The begin event is recorded here (monotonic µs, thread id,
        parent span id from this thread's stack); the matching end event
        on exit. ``attrs`` are attached to the begin event's ``args``.
        """
        stack = self._stack()
        sid = next(self._ids)
        rec = {"ph": "B", "name": name, "ts": self._now_us(),
               "tid": threading.get_ident(), "sid": sid,
               "parent": stack[-1] if stack else None,
               "lane": getattr(self._tls, "lane", None)}
        if attrs:
            rec["args"] = attrs
        stack.append(sid)
        self._emit(rec)
        return _Span(self, sid)

    def _end_span(self, sid: int) -> None:
        stack = self._stack()
        # tolerate exception-unwound nesting: pop through to this span
        while stack and stack[-1] != sid:
            stack.pop()
        if stack:
            stack.pop()
        self._emit({"ph": "E", "ts": self._now_us(),
                    "tid": threading.get_ident(), "sid": sid,
                    "lane": getattr(self._tls, "lane", None)})

    def event(self, name: str, **attrs) -> None:
        """Record an instant event (cache hit, kernel launch, ...)."""
        stack = self._stack()
        rec = {"ph": "i", "name": name, "ts": self._now_us(),
               "tid": threading.get_ident(), "sid": None,
               "parent": stack[-1] if stack else None,
               "lane": getattr(self._tls, "lane", None)}
        if attrs:
            rec["args"] = attrs
        self._emit(rec)

    def lane(self, name: str) -> _Lane:
        """Assign this thread's subsequent events to lane ``name`` (a
        Chrome *process* row in the export) until the context exits."""
        return _Lane(self, str(name))

    # -- introspection --------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events evicted by the ring buffer so far."""
        with self._lock:
            return max(0, self._len_before - len(self._events))

    def snapshot(self) -> List[dict]:
        """The buffered events as plain dicts (oldest first)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def span_names(self) -> List[str]:
        """Distinct begin-event span names in buffer order (tests)."""
        seen: Dict[str, None] = {}
        for e in self.snapshot():
            if e["ph"] == "B":
                seen.setdefault(e["name"], None)
        return list(seen)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._len_before = 0

    # -- export ---------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON object for the
        buffered events: B/E duration events per span, instant events
        with thread scope, plus ``process_name`` metadata for lanes."""
        events = self.snapshot()
        # map span id -> name so orphaned E events (B evicted by the
        # ring) can be dropped instead of emitting unmatched pairs
        names: Dict[int, str] = {e["sid"]: e["name"] for e in events
                                 if e["ph"] == "B"}
        lanes: Dict[Optional[str], int] = {None: 1}
        out: List[dict] = []
        for e in events:
            lane = e.get("lane")
            pid = lanes.setdefault(lane, len(lanes) + 1)
            if e["ph"] == "B":
                rec = {"ph": "B", "name": e["name"], "cat": "repro",
                       "ts": e["ts"], "pid": pid, "tid": e["tid"]}
                if e.get("args"):
                    rec["args"] = {k: _jsonable(v)
                                   for k, v in e["args"].items()}
            elif e["ph"] == "E":
                if e["sid"] not in names:
                    continue            # begin fell off the ring
                rec = {"ph": "E", "name": names[e["sid"]], "cat": "repro",
                       "ts": e["ts"], "pid": pid, "tid": e["tid"]}
            else:
                rec = {"ph": "i", "name": e["name"], "cat": "repro",
                       "ts": e["ts"], "pid": pid, "tid": e["tid"],
                       "s": "t"}
                if e.get("args"):
                    rec["args"] = {k: _jsonable(v)
                                   for k, v in e["args"].items()}
            out.append(rec)
        meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": lane if lane is not None else "main"}}
                for lane, pid in lanes.items()]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        """Write the ``trace_event`` JSON to ``path``; returns ``path``
        (load it in Perfetto or ``chrome://tracing``)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def _jsonable(v):
    """Args values must survive json.dump; numpy scalars and the like
    degrade to their repr instead of failing the export."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        return repr(v)


def wrap_stage(tracer: Optional[Tracer], name: str, fn):
    """Wrap a one-argument stage callable in a span — or return it
    untouched when ``tracer`` is None, so the traced-off path is the
    original callable with zero indirection (the box scheduler wraps
    its fetch/build/work stages through this once per run)."""
    if tracer is None:
        return fn

    def traced(x):
        with tracer.span(name):
            return fn(x)
    return traced
