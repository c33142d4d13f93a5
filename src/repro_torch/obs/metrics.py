"""Cross-layer metrics registry: one namespace over the existing ledgers.

The repo's telemetry grew one ledger per subsystem — ``EngineStats`` /
``QueryStats`` (per-run), ``IOStats`` + ``BlockDevice`` tag partitions
(measured I/O), ``kernels/ledger.KernelLedger`` (device launches),
``serve.cache.TenantStats`` (per-tenant cache), the box-queue telemetry
dict. :class:`MetricsRegistry` does NOT replace their accounting: it
*adopts* them. Each ledger stays the single source of truth for its own
counters; registered adapters snapshot it into one labeled namespace on
``collect()``:

======================  ====================================================
series                  source ledger
======================  ====================================================
``io.*{tag=...}``       ``BlockDevice`` global + per-tag ``IOStats``
``cache.*{tenant=..}``  ``SharedSliceCache`` global + per-tenant ledgers
``kernel.*{op=...}``    ``KernelLedger`` totals folded per attach site
``box.*{lane=...}``     ``run_box_queue`` telemetry via the engines
``serve.*``             per-query latency histograms (p50/p90/p99)
``engine.* / query.*``  ``EngineStats`` / ``QueryStats`` published as gauges
======================  ====================================================

**Exact-sum invariants.** Adapters emit per-partition series *and* the
global, plus an explicit ``_untagged`` / ``_unattributed`` residual
(global minus the partition sum) — so per-tag/per-tenant series sum to
the global ledger exactly, by construction, and the residual being
nonzero is itself a signal (reads issued outside any attribution
window). The parity tests check both directions against the raw ledgers.

Direct instruments (``inc`` / ``set`` / ``observe``) exist for values
with no pre-existing ledger (per-query latency, benchmark gate
numbers). ``to_prom_text()`` renders the Prometheus textfile format;
``snapshot()`` returns plain nested dicts for tests and JSON records.

A process-wide default registry (``set_default_registry``) lets the
benchmark harness collect series from instrumented code it does not
construct; it is ``None`` unless something opts in, so library use pays
one module-global check.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["MetricsRegistry", "default_registry", "set_default_registry"]

_LabelKey = Tuple[Tuple[str, str], ...]

_IO_FIELDS = ("block_reads", "block_writes", "word_reads", "probes",
              "cache_served_words")
_CACHE_FIELDS = ("hits", "misses", "hit_words", "miss_words",
                 "passthrough_words")


def _labels_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Named counters / gauges / histograms with string labels."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> labels_key -> value
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self._hists: Dict[str, Dict[_LabelKey, List[float]]] = {}
        self._adapters: List[Callable[[], None]] = []

    # -- direct instruments ---------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[_labels_key(labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._hists.setdefault(name, {}).setdefault(
                _labels_key(labels), []).append(float(value))

    # -- reads ----------------------------------------------------------------

    def get(self, name: str, **labels) -> Optional[float]:
        key = _labels_key(labels)
        with self._lock:
            for table in (self._gauges, self._counters):
                if name in table and key in table[name]:
                    return table[name][key]
        return None

    def series(self, name: str) -> Dict[_LabelKey, float]:
        """Every labeled value of one counter/gauge name."""
        with self._lock:
            out: Dict[_LabelKey, float] = {}
            out.update(self._counters.get(name, {}))
            out.update(self._gauges.get(name, {}))
            return out

    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        """Empirical quantile of one histogram series (q in [0, 1])."""
        with self._lock:
            vals = self._hists.get(name, {}).get(_labels_key(labels))
            if not vals:
                return None
            vals = sorted(vals)
        idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
        return vals[idx]

    # -- ledger adapters ------------------------------------------------------
    # each adapter re-snapshots its ledger on collect(): the ledger keeps
    # accounting exactly as before, the registry only mirrors it.

    def add_adapter(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._adapters.append(fn)

    def adopt_device(self, device, prefix: str = "io") -> None:
        """Mirror a ``BlockDevice``: global ``io.*`` gauges, per-tag
        ``io.*{tag=...}`` (partitions survive ``close_tag``), and the
        ``tag="_untagged"`` residual, so Σ_tags == global exactly."""

        def _collect(dev=device, pfx=prefix):
            tags = dev.all_tag_stats()
            for f in _IO_FIELDS:
                g = int(getattr(dev.stats, f))
                self.set(f"{pfx}.{f}", g)
                attributed = 0
                for tag, st in tags.items():
                    v = int(getattr(st, f))
                    attributed += v
                    self.set(f"{pfx}.{f}", v, tag=str(tag))
                self.set(f"{pfx}.{f}", g - attributed, tag="_untagged")
        self.add_adapter(_collect)

    def adopt_shared_cache(self, cache, relation: str = "E") -> None:
        """Mirror a ``SharedSliceCache``: global ``cache.*{relation=..}``,
        per-tenant ``cache.*{relation=.., tenant=..}`` (departed tenants
        included — their ledgers are kept), and the ``tenant="_shared"``
        residual, so Σ_tenants == global exactly."""

        def _collect(c=cache, rel=relation):
            tenants = c.all_tenant_stats()
            for f in _CACHE_FIELDS:
                g = int(getattr(c, f))
                self.set(f"cache.{f}", g, relation=rel)
                attributed = 0
                for tenant, st in tenants.items():
                    v = int(getattr(st, f))
                    attributed += v
                    self.set(f"cache.{f}", v, relation=rel,
                             tenant=str(tenant))
                self.set(f"cache.{f}", g - attributed, relation=rel,
                         tenant="_shared")
            self.set("cache.cross_hits", int(c.cross_hits), relation=rel)
        self.add_adapter(_collect)

    def adopt_slice_cache(self, cache, relation: str = "E") -> None:
        """Mirror a single-tenant ``SliceCache`` (no tenant label)."""

        def _collect(c=cache, rel=relation):
            for f in _CACHE_FIELDS:
                self.set(f"cache.{f}", int(getattr(c, f)), relation=rel)
        self.add_adapter(_collect)

    def note_kernel(self, ledger, op: str = "staged") -> None:
        """Fold one detached ``KernelLedger`` into the ``kernel.*{op=..}``
        counters (called once per box by the executors — the ledger
        object itself stays per-box/thread-local)."""
        if not ledger.invocations:
            return
        self.inc("kernel.invocations", ledger.invocations, op=op)
        self.inc("kernel.bytes_in", ledger.bytes_in, op=op)
        self.inc("kernel.bytes_out", ledger.bytes_out, op=op)

    def note_queue(self, tele: dict, lane: str = "all") -> None:
        """Fold one ``run_box_queue`` telemetry dict into ``box.*``."""
        self.inc("box.wait_s", tele.get("wait", 0.0), lane=lane)
        self.inc("box.build_s", tele.get("build", 0.0), lane=lane)
        self.inc("box.compute_s", tele.get("compute", 0.0), lane=lane)
        self.set("box.pool", tele.get("pool", 0), lane=lane)

    def publish_stats(self, stats, prefix: str, **labels) -> None:
        """Publish every numeric field of a stats object (``EngineStats``
        / ``QueryStats`` / ``FabricStats``) as ``<prefix>.<field>``
        gauges — the run-level dataclasses become views over the
        registry instead of a parallel bookkeeping system."""
        for f in getattr(stats, "__dataclass_fields__", {}):
            v = getattr(stats, f)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.set(f"{prefix}.{f}", float(v), **labels)

    def collect(self) -> "MetricsRegistry":
        """Run every ledger adapter (re-snapshotting the live ledgers
        into gauges); returns self for chaining."""
        with self._lock:
            adapters = list(self._adapters)
        for fn in adapters:
            fn()
        return self

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, dict]]:
        """Plain-dict view: ``{"counters": {name: {label_str: v}}, ...}``
        with histograms summarized to count/sum/p50/p90/p99."""
        self.collect()
        with self._lock:
            def flat(table):
                return {name: {_label_str(k): v for k, v in series.items()}
                        for name, series in table.items()}
            hists = {}
            for name, series in self._hists.items():
                hists[name] = {}
                for k, vals in series.items():
                    s = sorted(vals)

                    def pick(q):
                        return s[min(len(s) - 1,
                                     max(0, int(round(q * (len(s) - 1)))))]
                    hists[name][_label_str(k)] = {
                        "count": len(s), "sum": sum(s),
                        "p50": pick(0.50), "p90": pick(0.90),
                        "p99": pick(0.99)}
            return {"counters": flat(self._counters),
                    "gauges": flat(self._gauges),
                    "histograms": hists}

    def to_prom_text(self) -> str:
        """Prometheus textfile exposition of every series (counters and
        gauges verbatim; histograms as _count/_sum plus quantile
        gauges)."""
        snap = self.snapshot()
        lines: List[str] = []
        for kind in ("counters", "gauges"):
            for name in sorted(snap[kind]):
                prom = _prom_name(name)
                lines.append(f"# TYPE {prom} "
                             f"{'counter' if kind == 'counters' else 'gauge'}")
                for label_str, v in sorted(snap[kind][name].items()):
                    lines.append(f"{prom}{label_str} {_prom_num(v)}")
        for name in sorted(snap["histograms"]):
            prom = _prom_name(name)
            lines.append(f"# TYPE {prom} summary")
            for label_str, h in sorted(snap["histograms"][name].items()):
                base = label_str[1:-1] if label_str else ""
                for q in ("p50", "p90", "p99"):
                    qlab = f'quantile="0.{q[1:]}"'
                    lab = f"{{{base},{qlab}}}" if base else f"{{{qlab}}}"
                    lines.append(f"{prom}{lab} {_prom_num(h[q])}")
                lines.append(f"{prom}_count{label_str} {h['count']}")
                lines.append(f"{prom}_sum{label_str} {_prom_num(h['sum'])}")
        return "\n".join(lines) + "\n"


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_num(v: float) -> str:
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


# -- process-wide default registry (benchmark harness opt-in) ----------------

_default: Optional[MetricsRegistry] = None


def default_registry() -> Optional[MetricsRegistry]:
    return _default


def set_default_registry(reg: Optional[MetricsRegistry]) -> None:
    global _default
    _default = reg
