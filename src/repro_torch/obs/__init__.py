"""Observability: structured tracing and a metrics registry.

A copy of the reference package's ``obs`` (pure Python, no torch):

* :mod:`repro_torch.obs.trace` — a thread-safe, nestable :class:`Tracer`
  whose ``span()`` context managers record begin/end events (monotonic
  timestamps, thread id, parent span) into a bounded ring buffer, with a
  Chrome/Perfetto ``trace_event`` JSON exporter and a plain-dict
  snapshot for tests. Tracing is off by default: every instrumented hot
  path pays one ``is None`` check when no tracer is attached, and
  instrumentation never reorders or adds source reads, so counts,
  listings and I/O ledgers are identical traced on and off.
* :mod:`repro_torch.obs.metrics` — a :class:`MetricsRegistry` of labeled
  counters/gauges/histograms that *adopts* the existing ledgers
  (``IOStats``/``BlockDevice`` tag partitions, ``KernelLedger``,
  box-queue telemetry) instead of duplicating them: adapters snapshot
  each ledger into one namespace (``io.block_reads{tag=...}``,
  ``kernel.invocations{op=...}``, ``box.compute_s{lane=...}``) with
  exact-sum invariants. Exports Prometheus textfile format via
  ``to_prom_text()``.

``TriangleEngine`` and ``QueryEngine`` take optional ``tracer=`` and
``metrics=`` knobs that wire one tracer and registry through every stage
of a run: ``engine.count`` / ``engine.list`` / ``query.plan`` /
``query.boxes`` spans, ``box.fetch`` / ``box.build`` / ``box.compute``
spans per box, ``kernel.launch`` and ``cache.*`` events.
"""

from .trace import Tracer, wrap_stage  # noqa: F401
from .metrics import (MetricsRegistry, default_registry,  # noqa: F401
                      set_default_registry)
