"""repro_torch.obs (a copy of the reference's ``obs``) and the tracer /
metrics hooks of the port's engines, on the CPU.

The tracer, registry and queue-telemetry unit cases of
``tests/test_obs.py`` run on the port's copy. Then the parity cases: the
port's ``TriangleEngine`` (count and list) and ``QueryEngine`` on the same
graph and plan as the reference's, at 1 and 4 workers, traced; each case
checks the same multiset of span names and of instant events, as many
``kernel.launch`` events as the reference with their invocations summing
to ``stats.device_invocations``, the same non-time series in
``metrics.snapshot()`` (queue and stage seconds, in-flight peaks and
transfer bytes only for presence), and counts and listings unchanged with
tracing on. The reference calls the intersect lane "pallas" (and counts
it in ``n_pallas_boxes``); the comparison maps those names, in this file.
Tolerance: none — names, counts and series values are exact. Served runs
(``tests/test_obs.py``'s serve cases): a served query records the span
taxonomy (``serve.admission`` / ``serve.query`` / ``query.plan`` / box
spans, cache and kernel events) and the ``serve.latency_s`` histogram,
with the reference's multisets of names; the registry's ``io.*`` and
``cache.*`` series sum exactly to the raw device and shared-cache
ledgers, departed tenants included, and equal the reference server's
series after the same serial queries.
"""

import json
import threading
from collections import Counter

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.engine import TriangleEngine as RefEngine
from repro.data.graphs import random_graph, rmat_graph
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import Tracer as RefTracer
from repro.query import QueryEngine as RefQueryEngine
from repro.query import patterns as ref_patterns
from repro.serve import Server as RefServer
from repro_torch import QueryEngine, Server, TriangleEngine, patterns
from repro_torch.core.engine import EngineStats
from repro_torch.core.executor import merge_queue_telemetry
from repro_torch.obs import (MetricsRegistry, Tracer, default_registry,
                             set_default_registry, wrap_stage)

SMALL = random_graph(200, 1500, seed=7)
GRAPH = rmat_graph(256, 2500, seed=21)


# ---------------------------------------------------------------------------
# tracer unit behaviour
# ---------------------------------------------------------------------------

class TestTracer:
    def test_nesting_records_parent_chain(self):
        tr = Tracer()
        with tr.span("outer", n=1):
            with tr.span("inner"):
                tr.event("leaf", k=3)
        ev = tr.snapshot()
        begins = {e["name"]: e for e in ev if e["ph"] == "B"}
        assert begins["outer"]["parent"] is None
        assert begins["inner"]["parent"] == begins["outer"]["sid"]
        leaf = next(e for e in ev if e["ph"] == "i")
        assert leaf["parent"] == begins["inner"]["sid"]
        assert begins["outer"]["args"] == {"n": 1}
        # two ends, popping innermost first
        ends = [e for e in ev if e["ph"] == "E"]
        assert [e["sid"] for e in ends] == [begins["inner"]["sid"],
                                            begins["outer"]["sid"]]

    def test_span_names_in_order(self):
        tr = Tracer()
        with tr.span("a"):
            pass
        with tr.span("b"):
            with tr.span("a"):
                pass
        assert tr.span_names() == ["a", "b"]

    def test_ring_buffer_bounds_memory_and_counts_dropped(self):
        tr = Tracer(capacity=16)
        for i in range(50):
            tr.event("tick", i=i)
        assert len(tr.snapshot()) == 16
        assert tr.dropped == 34
        # the surviving window is the most recent one
        assert [e["args"]["i"] for e in tr.snapshot()] == list(range(34, 50))
        tr.clear()
        assert tr.snapshot() == [] and tr.dropped == 0

    def test_exception_unwinds_span_stack(self):
        tr = Tracer()
        with pytest.raises(RuntimeError):
            with tr.span("outer"):
                with tr.span("inner"):
                    raise RuntimeError("boom")
        with tr.span("after"):
            pass
        after = next(e for e in tr.snapshot()
                     if e["ph"] == "B" and e["name"] == "after")
        assert after["parent"] is None

    def test_threads_get_independent_stacks(self):
        tr = Tracer()
        seen = {}

        def worker():
            with tr.span("child"):
                seen["parent"] = next(
                    e["parent"] for e in reversed(tr.snapshot())
                    if e["ph"] == "B" and e["name"] == "child")

        with tr.span("main-span"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        # the other thread's span must NOT parent under this thread's
        assert seen["parent"] is None

    def test_to_chrome_is_valid_and_balanced(self, tmp_path):
        tr = Tracer()
        with tr.lane("shard0"), tr.span("fabric.shard", shard=0):
            tr.event("cache.hit", words=8)
        with tr.span("engine.count"):
            pass
        doc = tr.to_chrome()
        json.loads(json.dumps(doc))       # round-trips
        ev = doc["traceEvents"]
        assert sum(1 for e in ev if e["ph"] == "B") \
            == sum(1 for e in ev if e["ph"] == "E")
        for e in ev:
            assert {"ph", "pid", "tid", "name"} <= set(e)
        lanes = {e["args"]["name"] for e in ev if e["ph"] == "M"}
        assert lanes == {"main", "shard0"}
        # lane events live in their own pid row
        pid_of = {e["args"]["name"]: e["pid"] for e in ev if e["ph"] == "M"}
        shard_b = next(e for e in ev
                       if e["ph"] == "B" and e["name"] == "fabric.shard")
        assert shard_b["pid"] == pid_of["shard0"]
        path = tr.export_chrome(str(tmp_path / "trace.json"))
        with open(path) as f:
            assert json.load(f)["traceEvents"]

    def test_to_chrome_drops_orphaned_ends(self):
        tr = Tracer(capacity=16)
        with tr.span("long"):
            for i in range(40):          # evicts the "long" begin
                tr.event("tick", i=i)
        ev = tr.to_chrome()["traceEvents"]
        assert sum(1 for e in ev if e["ph"] == "B") \
            == sum(1 for e in ev if e["ph"] == "E")

    def test_args_degrade_to_jsonable(self):
        tr = Tracer()
        tr.event("k", arr=np.int32(7), obj=object(), s="x", none=None)
        ev = tr.to_chrome()["traceEvents"]
        rec = next(e for e in ev if e["ph"] == "i")
        json.dumps(rec)
        assert rec["args"]["arr"] == 7
        assert isinstance(rec["args"]["obj"], str)

    def test_wrap_stage_is_identity_when_off(self):
        def fn(x):
            return x + 1
        assert wrap_stage(None, "box.fetch", fn) is fn
        tr = Tracer()
        wrapped = wrap_stage(tr, "box.fetch", fn)
        assert wrapped(1) == 2
        assert tr.span_names() == ["box.fetch"]


# ---------------------------------------------------------------------------
# metrics registry unit behaviour
# ---------------------------------------------------------------------------

class TestMetricsRegistry:
    def test_counters_gauges_histograms(self):
        reg = MetricsRegistry()
        reg.inc("kernel.invocations", 2, op="staged")
        reg.inc("kernel.invocations", 3, op="staged")
        reg.inc("kernel.invocations", 5, op="fused")
        reg.set("box.pool", 4, lane="all")
        for v in (1.0, 2.0, 10.0):
            reg.observe("serve.latency_s", v, mode="count")
        assert reg.get("kernel.invocations", op="staged") == 5
        assert reg.get("box.pool", lane="all") == 4
        assert reg.get("missing") is None
        assert sum(reg.series("kernel.invocations").values()) == 10
        assert reg.quantile("serve.latency_s", 0.5, mode="count") == 2.0
        assert reg.quantile("serve.latency_s", 1.0, mode="count") == 10.0
        assert reg.quantile("serve.latency_s", 0.5, mode="list") is None

    def test_snapshot_and_prom_text(self):
        reg = MetricsRegistry()
        reg.inc("io.block_reads", 7, tag="q0")
        reg.set("engine.n_boxes", 3.0)
        reg.observe("serve.latency_s", 0.25, mode="count")
        snap = reg.snapshot()
        assert snap["counters"]["io.block_reads"]['{tag="q0"}'] == 7
        assert snap["gauges"]["engine.n_boxes"][""] == 3.0
        h = snap["histograms"]["serve.latency_s"]['{mode="count"}']
        assert h["count"] == 1 and h["sum"] == 0.25
        text = reg.to_prom_text()
        assert '# TYPE io_block_reads counter' in text
        assert 'io_block_reads{tag="q0"} 7' in text
        assert 'serve_latency_s_count{mode="count"} 1' in text
        assert 'quantile="0.50"' in text

    def test_publish_stats_only_numeric_fields(self):
        reg = MetricsRegistry()
        stats = EngineStats()
        stats.n_boxes = 9
        reg.publish_stats(stats, "engine", mode="count")
        assert reg.get("engine.n_boxes", mode="count") == 9.0
        # non-numeric dataclass fields (lists, strings, None) are skipped
        for key in reg.series("engine.backend"):
            raise AssertionError(f"non-numeric field published: {key}")

    def test_default_registry_opt_in(self):
        assert default_registry() is None
        reg = MetricsRegistry()
        set_default_registry(reg)
        try:
            assert default_registry() is reg
        finally:
            set_default_registry(None)
        assert default_registry() is None


# ---------------------------------------------------------------------------
# queue-telemetry folding + the worker_utilization guard
# ---------------------------------------------------------------------------

def _tele(**kw):
    tele = dict(wait=0.0, build=0.0, compute=0.0, wall=0.0, pool=1,
                hi_boxes=0, hi_words=0)
    tele.update(kw)
    return tele


class TestQueueTelemetry:
    def test_zero_wall_reports_none(self):
        stats = EngineStats()
        merge_queue_telemetry(stats, _tele(pool=4), threading.Lock(), 2)
        assert stats.worker_utilization is None

    def test_zero_pool_reports_none(self):
        stats = EngineStats()
        merge_queue_telemetry(stats, _tele(wall=1.0, pool=0),
                              threading.Lock(), 2)
        assert stats.worker_utilization is None

    def test_regular_ratio(self):
        stats = EngineStats()
        merge_queue_telemetry(stats, _tele(build=1.0, compute=1.0,
                                           wall=1.0, pool=4),
                              threading.Lock(), 2)
        assert stats.worker_utilization == pytest.approx(0.5)

    def test_folds_into_registry(self):
        stats = EngineStats()
        reg = MetricsRegistry()
        merge_queue_telemetry(stats, _tele(build=0.5, wall=1.0, pool=3),
                              threading.Lock(), 2, metrics=reg,
                              lane="shard1")
        assert reg.get("box.pool", lane="shard1") == 3
        assert reg.get("box.build_s", lane="shard1") == pytest.approx(0.5)

    def test_folds_into_default_registry(self):
        stats = EngineStats()
        reg = MetricsRegistry()
        set_default_registry(reg)
        try:
            merge_queue_telemetry(stats, _tele(wall=1.0), threading.Lock(), 2)
        finally:
            set_default_registry(None)
        assert reg.get("box.pool", lane="all") == 1



# ---------------------------------------------------------------------------
# traced-off identity and parity with the reference
# ---------------------------------------------------------------------------

# the reference's names of the port's intersect lane, mapped in the test
REF_NAMES = {"pallas": "intersect", "n_pallas_boxes": "n_intersect_boxes"}
# series whose values are wall-clock or scheduling dependent (or the port's
# own transfer account): compared for presence only
PRESENCE_ONLY = ("_s", "worker_utilization", "max_inflight", "bytes")


def _canon_series(snap, ref):
    """{kind: {(name, labels): value}} with the reference's lane names
    mapped to the port's; presence-only series valued None."""
    out = {}
    for kind in ("counters", "gauges"):
        table = {}
        for name, series in snap[kind].items():
            prefix, _, field = name.partition(".")
            if ref:
                field = REF_NAMES.get(field, field)
            key_name = f"{prefix}.{field}"
            for labels, v in series.items():
                if ref:
                    for old, new in REF_NAMES.items():
                        labels = labels.replace(f'"{old}"', f'"{new}"')
                keep = not any(t in key_name for t in PRESENCE_ONLY)
                table[(key_name, labels)] = v if keep else None
        out[kind] = table
    return out


def _events(tracer):
    snap = tracer.snapshot()
    spans = Counter(e["name"] for e in snap if e["ph"] == "B")
    instants = Counter(e["name"] for e in snap if e["ph"] == "i")
    launches = sum(e["args"]["invocations"] for e in snap
                   if e["ph"] == "i" and e["name"] == "kernel.launch")
    return spans, instants, launches


def _engine_pair(backend, workers, cache):
    src, dst = GRAPH
    kw = dict(mem_words=1500, workers=workers, cache_words=cache)
    ref_backend = {"intersect": "pallas"}.get(backend, backend)
    return (lambda **o: RefEngine(src, dst, shard=False,
                                  backend=ref_backend, **kw, **o),
            lambda **o: TriangleEngine(src, dst, backend=backend,
                                       torch_device="cpu", **kw, **o))


def _query_pair(pattern, backend, workers):
    src, dst = GRAPH
    kw = dict(mem_words=1 << 9, workers=workers)
    ref_backend = {"intersect": "pallas"}.get(backend, backend)
    return (lambda **o: RefQueryEngine.from_graph(
                ref_patterns.PATTERNS[pattern](), src, dst,
                backend=ref_backend, use_pallas_kernels=False, **kw, **o),
            lambda **o: QueryEngine.from_graph(
                patterns.PATTERNS[pattern](), src, dst, backend=backend,
                use_kernels=False, torch_device="cpu", **kw, **o))


CASES = []
for _w in (1, 4):
    for _be, _cache in (("auto", 0), ("intersect", 0), ("auto", 512)):
        CASES.append(("engine", "count", _be, _cache, _w))
    CASES.append(("engine", "list", "auto", 0, _w))
    CASES.append(("engine", "list", "auto", 512, _w))
    CASES.append(("triangle", "count", "intersect", 0, _w))
    CASES.append(("four_clique", "count", "auto", 0, _w))
    CASES.append(("diamond", "list", "host", 0, _w))


def _result(eng, mode):
    return eng.count() if mode == "count" else eng.list()


@pytest.mark.parametrize("target,mode,backend,cache,workers", CASES)
def test_traced_run_matches_reference(target, mode, backend, cache, workers):
    if target == "engine":
        make_ref, make_port = _engine_pair(backend, workers, cache)
    else:
        make_ref, make_port = _query_pair(target, backend, workers)
    plain = _result(make_port(), mode)
    r_tr, r_reg = RefTracer(), RefRegistry()
    p_tr, p_reg = Tracer(), MetricsRegistry()
    ref = make_ref(tracer=r_tr, metrics=r_reg)
    port = make_port(tracer=p_tr, metrics=p_reg)
    want, got = _result(ref, mode), _result(port, mode)
    if mode == "count":
        assert got == want == plain
    else:
        assert got.tobytes() == want.tobytes() == plain.tobytes()
    r_spans, r_inst, r_launch = _events(r_tr)
    p_spans, p_inst, p_launch = _events(p_tr)
    assert p_spans == r_spans
    assert p_inst == r_inst
    assert p_launch == r_launch == port.stats.device_invocations \
        == ref.stats.device_invocations
    if backend == "intersect":
        assert p_launch > 0
    if cache:
        assert p_inst["cache.miss"] > 0
    top = "engine." + mode if target == "engine" else "query.boxes"
    assert p_spans[top] == 1
    n_boxes = sum(1 for _ in port.plan()) if target == "engine" \
        else len(port.plan().boxes)
    assert p_spans["box.fetch"] == n_boxes
    r_snap = _canon_series(r_reg.snapshot(), ref=True)
    p_snap = _canon_series(p_reg.snapshot(), ref=False)
    assert p_snap == r_snap
    prefix = "engine" if target == "engine" else "query"
    assert p_reg.get(f"{prefix}.n_boxes", mode=mode) == port.stats.n_boxes
    assert n_boxes > 1
    if workers > 1:
        assert p_reg.get("box.compute_s", lane="all") is not None
        assert p_reg.get("box.pool", lane="all") == port.stats.n_workers


def test_triangle_engine_byte_identical():
    src, dst = SMALL
    base = TriangleEngine(src, dst, mem_words=4096, torch_device="cpu")
    want = base.count()
    want_reads = base.stats.block_reads
    tr = Tracer()
    reg = MetricsRegistry()
    eng = TriangleEngine(src, dst, mem_words=4096, tracer=tr, metrics=reg,
                         torch_device="cpu")
    assert eng.count() == want
    assert eng.stats.block_reads == want_reads
    names = tr.span_names()
    assert "engine.count" in names
    assert "box.fetch" in names and "box.compute" in names
    assert reg.get("engine.n_boxes", mode="count") == eng.stats.n_boxes


def test_query_engine_kernel_events():
    src, dst = SMALL
    q = patterns.PATTERNS["triangle"]()
    base = QueryEngine.from_graph(q, src, dst, mem_words=1 << 14,
                                  backend="intersect", torch_device="cpu")
    want = base.count()
    tr = Tracer()
    reg = MetricsRegistry()
    eng = QueryEngine.from_graph(q, src, dst, mem_words=1 << 14,
                                 backend="intersect", tracer=tr,
                                 metrics=reg, torch_device="cpu")
    assert eng.count() == want
    names = tr.span_names()
    assert "query.plan" in names and "query.boxes" in names
    launches = [e for e in tr.snapshot()
                if e["ph"] == "i" and e["name"] == "kernel.launch"]
    assert launches, "intersect-lane run recorded no kernel launches"
    assert sum(reg.series("kernel.invocations").values()) \
        == eng.stats.device_invocations > 0


def test_chrome_export_of_an_engine_run(tmp_path):
    src, dst = GRAPH
    tr = Tracer()
    TriangleEngine(src, dst, mem_words=1500, workers=4, tracer=tr,
                   torch_device="cpu").count()
    doc = tr.to_chrome()
    ev = doc["traceEvents"]
    assert sum(1 for e in ev if e["ph"] == "B") \
        == sum(1 for e in ev if e["ph"] == "E")
    path = tr.export_chrome(str(tmp_path / "engine.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_slice_cache_events_match_its_counters():
    src, dst = GRAPH
    tr = Tracer()
    eng = TriangleEngine(src, dst, mem_words=1500, cache_words=512,
                         tracer=tr, torch_device="cpu")
    eng.count()
    snap = tr.snapshot()
    hits = [e for e in snap if e["ph"] == "i" and e["name"] == "cache.hit"]
    misses = [e for e in snap
              if e["ph"] == "i" and e["name"] == "cache.miss"]
    assert len(hits) == eng.stats.cache_hits
    assert sum(e["args"]["blocks"] for e in misses) == eng.stats.cache_misses
    assert sum(e["args"]["words"] for e in hits) == eng.stats.cache_hit_words


# ---------------------------------------------------------------------------
# served runs: span taxonomy + registry/ledger exact-sum invariants
# ---------------------------------------------------------------------------

IO_FIELDS = ("block_reads", "block_writes", "word_reads", "probes",
             "cache_served_words")
CACHE_FIELDS = ("hits", "misses", "hit_words", "miss_words",
                "passthrough_words")


def labeled_sum(reg, name, label):
    """Sum of every series of ``name`` carrying ``label`` (any value)."""
    return sum(v for key, v in reg.series(name).items()
               if any(k == label for k, _ in key))


def unlabeled_value(reg, name, label):
    """The one series of ``name`` with no ``label`` label (the global)."""
    vals = [v for key, v in reg.series(name).items()
            if not any(k == label for k, _ in key)]
    assert len(vals) == 1, (name, vals)
    return vals[0]


class TestServeObservability:
    def test_span_taxonomy_and_latency_histogram(self, thread_guard):
        """One served run on the intersect lane records the acceptance
        taxonomy (admission, planning, per-box fetch/compute, a cache
        event, a kernel launch) with the reference's span and event
        multisets, and a latency histogram."""
        r_tr, p_tr = RefTracer(), Tracer()
        r_reg, p_reg = RefRegistry(), MetricsRegistry()
        # the reference's "pallas" backend is the port's "intersect"
        ref = RefServer.from_graph(*SMALL, mem_words=1 << 15,
                                   backend="pallas",
                                   use_pallas_kernels=False, tracer=r_tr,
                                   metrics=r_reg)
        port = Server.from_graph(*SMALL, mem_words=1 << 15,
                                 backend="intersect", torch_device="cpu",
                                 tracer=p_tr, metrics=p_reg)
        with ref, port:
            want = ref.submit("triangle", "count").result(timeout=300)
            got = port.submit("triangle", "count").result(timeout=300)
        assert got == want == QueryEngine.from_graph(
            patterns.triangle(), *SMALL, mem_words=1 << 14,
            torch_device="cpu").count()
        names = p_tr.span_names()
        for required in ("serve.admission", "serve.query", "query.plan",
                         "box.fetch", "box.compute"):
            assert required in names, (required, names)
        events = {e["name"] for e in p_tr.snapshot() if e["ph"] == "i"}
        assert any(n.startswith("cache.") for n in events), events
        assert "kernel.launch" in events, events
        r_spans, r_inst, r_launch = _events(r_tr)
        p_spans, p_inst, p_launch = _events(p_tr)
        assert p_spans == r_spans
        assert p_inst == r_inst
        assert p_launch == r_launch > 0
        assert p_reg.quantile("serve.latency_s", 0.5, mode="count",
                              status="done") is not None

    def test_streamed_listing_records_page_offers(self, thread_guard):
        tr = Tracer()
        # tests/test_serve.py's graph: several boxes at 2^12 words
        graph = rmat_graph(512, 6000, seed=21)
        with Server.from_graph(*graph, mem_words=1 << 12, page_rows=64,
                               torch_device="cpu", tracer=tr) as srv:
            h = srv.submit("path3", "list", stream=True)
            n_rows = sum(len(p) for p in h.pages())
            assert h.wait(60)
        offers = [e for e in tr.snapshot()
                  if e["ph"] == "i" and e["name"] == "serve.page.offer"]
        assert len(offers) == h.stats.n_boxes > 1
        assert n_rows == h.stats.n_results

    @settings(max_examples=5, deadline=None)
    @given(st.lists(st.sampled_from(["triangle", "path3", "four_clique"]),
                    min_size=1, max_size=3),
           st.sampled_from(["count", "list"]))
    def test_registry_sums_match_raw_ledgers(self, names, mode):
        reg = MetricsRegistry()
        with Server.from_graph(*SMALL, mem_words=1 << 15,
                               torch_device="cpu", metrics=reg) as srv:
            handles = [srv.submit(n, mode) for n in names]
            for h in handles:
                h.result(timeout=300)
            reg.collect()
            for f in IO_FIELDS:
                raw = int(getattr(srv.device.stats, f))
                assert unlabeled_value(reg, f"io.{f}", "tag") == raw
                assert labeled_sum(reg, f"io.{f}", "tag") == raw, f
            tags = {dict(k).get("tag")
                    for k in reg.series("io.block_reads") if k}
            assert "_untagged" in tags
            for rel, cache in srv.caches.items():
                for f in CACHE_FIELDS:
                    raw = int(getattr(cache, f))
                    series = {k: v for k, v in
                              reg.series(f"cache.{f}").items()
                              if dict(k).get("relation") == rel}
                    tenant_sum = sum(
                        v for k, v in series.items()
                        if any(lk == "tenant" for lk, _ in k))
                    assert tenant_sum == raw, (rel, f)
                tenants = {dict(k).get("tenant")
                           for k in reg.series("cache.hits")
                           if dict(k).get("relation") == rel}
                assert "_shared" in tenants

    def test_departed_tenants_keep_summing(self, thread_guard):
        reg = MetricsRegistry()
        with Server.from_graph(*SMALL, mem_words=1 << 15,
                               torch_device="cpu", metrics=reg) as srv:
            for _ in range(2):
                srv.submit("triangle", "count").result(timeout=300)
            reg.collect()
            cache = srv.caches["E"]
            assert cache.hits > 0
            assert labeled_sum(reg, "cache.hits", "tenant") == cache.hits
            assert set(cache.all_tenant_stats()) == {"q0", "q1"}

    def test_served_series_equal_reference(self, thread_guard):
        """The same queries served one at a time on both host lanes: the
        same io.*, cache.* and query.* series (times for presence only),
        so the registry adopts the port's ledgers as it does the
        reference's."""
        r_reg, p_reg = RefRegistry(), MetricsRegistry()
        ref = RefServer.from_graph(*SMALL, mem_words=1 << 13,
                                   use_pallas_kernels=False, metrics=r_reg)
        port = Server.from_graph(*SMALL, mem_words=1 << 13,
                                 use_kernels=False, torch_device="cpu",
                                 metrics=p_reg)
        with ref, port:
            for name, mode in (("triangle", "count"), ("path3", "list"),
                               ("triangle", "count")):
                want = ref.submit(name, mode).result(timeout=300)
                got = port.submit(name, mode).result(timeout=300)
                if mode == "count":
                    assert got == want
                else:
                    assert got.tobytes() == want.tobytes()
            r_reg.collect()
            p_reg.collect()
        r_snap = _canon_series(r_reg.snapshot(), ref=True)
        p_snap = _canon_series(p_reg.snapshot(), ref=False)
        assert p_snap == r_snap
        assert any(k[0].startswith("cache.") for k in p_snap["counters"]) \
            or any(k[0].startswith("cache.") for k in p_snap["gauges"])
