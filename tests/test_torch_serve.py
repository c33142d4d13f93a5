"""The port's serving layer (``repro_torch.serve``: ``Server`` / ``Session``
over warm relations, admission, the shared slice cache, streamed listing,
retry rounds) against the reference's ``repro.serve``, on the CPU.

Both packages get the same graphs (``tests/test_serve.py``'s ``GRAPH`` and
``SMALL``, made with numpy from their seeds). The reference serves with
``use_pallas_kernels=False``; the port with ``torch_device="cpu"``, where
the kernel wrappers run their plain versions. One query at a time, a port
server and a reference server give the same results (listings row for row
in plan order), the same ``QueryStats`` ledgers, the same admitted budgets,
plan-cache hits and solo envelopes, in memory and over a store the
reference wrote. The same ``acquire`` / ``release`` sequence gives the same
grants, rejections, timeouts and peaks on both admission controllers. The
port's counterparts of ``tests/test_serve.py``'s concurrency, envelope,
admission, cancellation, fault-injection and pagination cases are held to
the reference's results on the same graph. Tolerance: none — results are
integers and bytes. Every test that starts threads checks that none is
left running, and every join has a timeout.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data.edgestore import write_edge_store_csr as ref_write_csr
from repro.data.graphs import random_graph, rmat_graph
from repro.query import QueryEngine as RefQueryEngine
from repro.query.patterns import PATTERNS as REF_PATTERNS
from repro.serve import AdmissionController as RefAdmission
from repro.serve import AdmissionRejected as RefRejected
from repro.serve import AdmissionTimeout as RefTimeout
from repro.serve import Server as RefServer
from repro.serve import Session as RefSession
import repro.serve as ref_serve
import repro_torch
from repro_torch import serve
from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
from repro_torch.query.patterns import PATTERNS
from repro_torch.serve import (AdmissionController, AdmissionRejected,
                               AdmissionTimeout, QueryCancelled,
                               QueryFailed, Server, Session)

from conftest import ThreadGuard

ENV_WORKERS = max(2, int(os.environ.get("REPRO_TEST_WORKERS", "2")))

GRAPH = rmat_graph(512, 6000, seed=21)
SMALL = random_graph(200, 1500, seed=7)

NAMES = ["triangle", "four_clique", "path3"]

# QueryStats fields that are the same on both packages for one plan
LEDGER = ("n_boxes", "rank", "n_results", "n_rescans", "n_streamed_boxes",
          "slice_words_read", "max_slice_words", "block_reads",
          "block_writes", "word_reads", "cache_hits", "cache_misses",
          "cache_hit_words", "source")

_ORACLE = {}


def oracle(name, mode="count", graph=GRAPH):
    """The reference's single-query engine (cached): a count, or the
    listing's rows in lexicographic order."""
    key = (name, mode, id(graph))
    if key not in _ORACLE:
        eng = RefQueryEngine.from_graph(REF_PATTERNS[name](), *graph,
                                        mem_words=1 << 14)
        _ORACLE[key] = eng.count() if mode == "count" \
            else canon(eng.list())
    return _ORACLE[key]


def canon(rows):
    if len(rows) == 0:
        return rows
    return rows[np.lexsort(rows.T[::-1])]


def ref_server(graph=GRAPH, **kw):
    kw.setdefault("mem_words", 1 << 15)
    kw.setdefault("use_pallas_kernels", False)
    if "backend" in kw:
        kw["backend"] = {"intersect": "pallas"}.get(kw["backend"],
                                                      kw["backend"])
    return RefServer.from_graph(*graph, **kw)


def port_server(graph=GRAPH, **kw):
    kw.setdefault("mem_words", 1 << 15)
    return Server.from_graph(*graph, torch_device="cpu", **kw)


def ledger(stats):
    return {f: getattr(stats, f) for f in LEDGER}


def assert_same_result(got, want, mode):
    if mode == "count":
        assert isinstance(got, int)
        assert got == want
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# one query at a time: the port's server == the reference's
# ---------------------------------------------------------------------------

class TestSingleQueryParity:
    @pytest.mark.parametrize("name", NAMES)
    @pytest.mark.parametrize("mode", ["count", "list"])
    def test_single_query_equals_reference(self, name, mode, thread_guard):
        with ref_server() as ref, port_server() as port:
            hr, hp = ref.submit(name, mode), port.submit(name, mode)
            want, got = hr.result(300), hp.result(300)
            assert_same_result(got, want, mode)
            if mode == "count":
                assert got == oracle(name)
            else:
                np.testing.assert_array_equal(canon(got),
                                              oracle(name, "list"))
            assert hp.status == hr.status == "done"
            assert hp.admitted_words == hr.admitted_words
            assert hp.cache_floor == hr.cache_floor
            assert hp.retry_rounds == hr.retry_rounds == 0
            assert ledger(hp.stats) == ledger(hr.stats)
            assert hp.stats.n_boxes >= 1
            assert port.device.stats.block_reads \
                == ref.device.stats.block_reads
            assert port.device.stats.word_reads \
                == ref.device.stats.word_reads
            for rel in ref.caches:
                assert port.caches[rel].snapshot() == \
                    ref.caches[rel].snapshot()

    def test_repeated_shapes_hit_the_plan_cache_as_the_reference(
            self, thread_guard):
        with ref_server() as ref, port_server() as port:
            for name in ("triangle", "triangle", "path3", "triangle",
                         "path3"):
                hr, hp = ref.submit(name), port.submit(name)
                assert hp.result(300) == hr.result(300) == oracle(name)
                assert ledger(hp.stats) == ledger(hr.stats)
                assert (port.plan_hits, port.plan_misses) == \
                    (ref.plan_hits, ref.plan_misses)
            assert (port.plan_hits, port.plan_misses) == (3, 2)

    @pytest.mark.parametrize("name", NAMES)
    @pytest.mark.parametrize("mode", ["count", "list"])
    def test_solo_run_equals_reference(self, name, mode, thread_guard):
        with ref_server() as ref, port_server() as port:
            for words in (1 << 12, 1 << 14):
                want, want_st = ref.solo_run(name, mode, words=words)
                got, got_st = port.solo_run(name, mode, words=words)
                assert_same_result(got, want, mode)
                assert ledger(got_st) == ledger(want_st)

    def test_session_facade_equals_reference(self, thread_guard):
        with ref_server() as ref, port_server() as port, \
                RefSession(ref) as rs, Session(port) as ps:
            assert ps.count("triangle") == rs.count("triangle") \
                == oracle("triangle")
            got, want = ps.list("path3"), rs.list("path3")
            assert got.tobytes() == want.tobytes()
            assert ps.count("four_clique", want_words=1 << 13) == \
                rs.count("four_clique", want_words=1 << 13)

    @pytest.mark.parametrize("name", NAMES)
    def test_store_backed_server_equals_reference(self, name, tmp_path,
                                                  thread_guard):
        """A store written by the reference's ``write_edge_store_csr``,
        served by both: the same counts, listings and ledgers (the store's
        reads charged to each server's shared device)."""
        a, b = orient_edges(*GRAPH)
        ip, ix = csr_from_edges(a, b)
        path = str(tmp_path / "g.csr")
        ref_write_csr(path, ip, ix, orientation="minmax", chunk_rows=64)
        kw = dict(mem_words=1 << 14, cache_words=1 << 12)
        with RefServer({"E": path}, use_pallas_kernels=False, **kw) as ref, \
                Server({"E": path}, torch_device="cpu", **kw) as port:
            for mode in ("count", "list"):
                hr, hp = ref.submit(name, mode), port.submit(name, mode)
                assert_same_result(hp.result(300), hr.result(300), mode)
                assert ledger(hp.stats) == ledger(hr.stats)
                assert hp.stats.block_reads > 0
            got, got_st = port.solo_run(name, words=1 << 13)
            want, want_st = ref.solo_run(name, words=1 << 13)
            assert got == want == oracle(name)
            assert ledger(got_st) == ledger(want_st)

    def test_edge_pair_relation_builds_the_reference_csr(self, thread_guard):
        """A directed ``(src, dst)`` relation with duplicate pairs: the
        port's dedupe (``unique_pairs``) builds the reference's CSR byte
        for byte, and the served counts agree."""
        rng = np.random.default_rng(5)
        u = rng.integers(0, 150, 2500)
        v = rng.integers(0, 150, 2500)
        keep = u < v
        u, v = np.concatenate([u[keep], u[keep][:300]]), \
            np.concatenate([v[keep], v[keep][:300]])
        with RefServer({"E": (u, v)}, mem_words=1 << 14,
                       use_pallas_kernels=False) as ref, \
                Server({"E": (u, v)}, mem_words=1 << 14,
                       torch_device="cpu") as port:
            rs, ps = ref._sources["E"], port._sources["E"]
            assert ps.indptr.tobytes() == rs.indptr.tobytes()
            assert ps.indices.tobytes() == rs.indices.tobytes()
            for name in NAMES:
                assert port.submit(name).result(300) == \
                    ref.submit(name).result(300)

    @pytest.mark.parametrize("backend", ["auto", "host", "intersect",
                                         "fused"])
    def test_backends_equal_reference(self, backend, thread_guard):
        """The port's ``BACKENDS`` ("intersect" is the reference's
        "pallas"), on a graph the budget covers in a few boxes."""
        kw = dict(graph=SMALL, backend=backend, mem_words=1 << 15)
        with ref_server(**kw) as ref, port_server(**kw) as port:
            for name, mode in (("triangle", "count"), ("path3", "list")):
                hr, hp = ref.submit(name, mode), port.submit(name, mode)
                assert_same_result(hp.result(300), hr.result(300), mode)
                assert ledger(hp.stats) == ledger(hr.stats)
            if backend == "fused":
                assert hp.stats.n_fused_boxes > 0

    def test_argument_checks(self, thread_guard):
        with pytest.raises(ValueError, match="backend"):
            port_server(backend="pallas")
        with pytest.raises(ValueError, match="at least one relation"):
            Server({}, mem_words=1 << 14, torch_device="cpu")
        with port_server() as srv:
            with pytest.raises(ValueError, match="unknown pattern"):
                srv.submit("pentagon")
            q = PATTERNS["triangle"]()
            bad = type(q)(head=q.head,
                          atoms=[type(a)("R", a.vars) for a in q.atoms])
            with pytest.raises(ValueError, match="unknown relation"):
                srv.submit(bad)
            with pytest.raises(ValueError, match="mode"):
                srv.submit("triangle", "sum")
            with pytest.raises(ValueError, match="stream"):
                srv.submit("triangle", "count", stream=True)

    def test_default_device_is_the_card(self):
        """Without ``torch_device`` the server runs on CUDA, and on a host
        without it construction raises: nothing carries on on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device; the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Server.from_graph(*SMALL, mem_words=1 << 14)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Server({"E": SMALL}, mem_words=1 << 14)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Server.from_graph(*SMALL, mem_words=1 << 14,
                              torch_device="cuda:0", use_kernels=False)

    def test_exports_match_the_reference(self):
        assert serve.__all__ == ref_serve.__all__
        assert repro_torch.Server is Server
        assert repro_torch.Session is Session
        assert "Server" in repro_torch.__all__
        assert "Session" in repro_torch.__all__


# ---------------------------------------------------------------------------
# the shared slice cache: the same accesses, the same resident blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cache_store(tmp_path_factory):
    """``tests/test_ingest.py``'s cache store, written by the reference."""
    from repro.data.edgestore import write_edge_store
    path = tmp_path_factory.mktemp("cachestore") / "g.csr"
    return str(write_edge_store(path, *GRAPH, chunk_rows=64,
                                align_words=32))


CACHE_EVENTS = st.lists(st.one_of(
    st.tuples(st.just("read"), st.integers(0, 3), st.integers(0, 511),
              st.integers(0, 511)),
    st.tuples(st.just("leave"), st.integers(0, 3), st.just(0),
              st.just(0))), min_size=1, max_size=40)


def _cache_state(c):
    tenants = {t: s.as_dict() for t, s in c.all_tenant_stats().items()}
    return (list(c._blocks), c.snapshot(), c._words, c.hits, c.misses,
            c.hit_words, c.miss_words, c.passthrough_words, c.cross_hits,
            tenants, dict(c._owner))


class TestSharedCacheParity:
    @settings(max_examples=40, deadline=None)
    @given(events=CACHE_EVENTS, block_rows=st.integers(2, 16),
           budget=st.integers(128, 4096), floor_div=st.sampled_from(
               [2, 4, 8, 1 << 30]))
    def test_tenant_sequences_equal_reference(self, cache_store, events,
                                              block_rows, budget, floor_div):
        """Tenants reading windows, leaving and coming back, on the
        reference's and the port's shared caches over one store: after
        every event the same resident blocks in the same LRU order and
        bytes, the same owners, the same global and per-tenant ledgers —
        so the port's indexed victim search evicts exactly the blocks
        the reference's walk evicts."""
        from repro.data.edgestore import EdgeStore as RefStore
        from repro.serve import SharedSliceCache as RefCache
        from repro_torch.data.edgestore import EdgeStore
        from repro_torch.serve import SharedSliceCache
        floor = budget // floor_div
        ref = RefCache(RefStore(cache_store), budget, block_rows)
        port = SharedSliceCache(EdgeStore(cache_store), budget, block_rows)
        live = {}
        gen = {}
        for op, t, lo, hi in events:
            if op == "leave":
                if t in live:
                    for c in (ref, port):
                        c.unregister(live[t])
                    del live[t]
                continue
            if t not in live:
                gen[t] = gen.get(t, -1) + 1
                name = (t, gen[t])
                views = []
                for c in (ref, port):
                    try:
                        views.append(c.register(name, floor))
                    except ValueError:
                        views.append(c.register(name, 0))
                live[t] = name
            lo, hi = min(lo, hi), max(lo, hi)
            ip_r, v_r = ref.read_rows_for(live[t], lo, hi)
            ip_p, v_p = port.read_rows_for(live[t], lo, hi)
            assert ip_p.tobytes() == ip_r.tobytes()
            assert v_p.tobytes() == v_r.tobytes()
            assert _cache_state(port) == _cache_state(ref)
            assert sum(s.words for s in port._tenants.values()) <= \
                port._words
        port.clear()
        ref.clear()
        assert _cache_state(port) == _cache_state(ref)

    def test_two_tenants_at_their_floors_evict_as_the_reference(
            self, cache_store):
        """Two tenants each at its floor (half the budget) scanning the
        whole store in turns: the floor-protected eviction of every
        insert picks the reference's victim."""
        from repro.data.edgestore import EdgeStore as RefStore
        from repro.serve import SharedSliceCache as RefCache
        from repro_torch.data.edgestore import EdgeStore
        from repro_torch.serve import SharedSliceCache
        caches = [RefCache(RefStore(cache_store), 2048, 4),
                  SharedSliceCache(EdgeStore(cache_store), 2048, 4)]
        for c in caches:
            c.register("a", 1024)
            c.register("b", 1024)
        for lo in range(0, 472, 24):
            for t, (a, b) in (("a", (lo, lo + 40)),
                              ("b", (471 - lo, 511 - lo))):
                for c in caches:
                    c.read_rows_for(t, a, b)
                assert _cache_state(caches[1]) == _cache_state(caches[0])
        port = caches[1]
        assert port.misses > len(port._blocks)          # it evicted
        assert min(port.tenant_stats(t).words for t in ("a", "b")) > 0
        caches[0].unregister("a")
        caches[1].unregister("a")
        for c in caches:
            c.read_rows_for("b", 0, 511)
        assert _cache_state(caches[1]) == _cache_state(caches[0])


# ---------------------------------------------------------------------------
# admission: the same call sequence, the same grants
# ---------------------------------------------------------------------------

def _ctrl_state(c):
    return (c.reserved_words, c.active, c.waiting, c.peak_active,
            c.peak_reserved, c.n_admitted, c.n_rejected, c.n_timeouts,
            c.n_queued)


ADMISSION_OPS = st.lists(
    st.tuples(st.sampled_from(["acquire", "reject", "timeout", "release"]),
              st.one_of(st.none(), st.integers(1, 1 << 17)),
              st.integers(0, 15)),
    max_size=30)


class TestAdmissionParity:
    @settings(max_examples=60, deadline=None)
    @given(total=st.sampled_from([1 << 12, 3 << 12, 1 << 16, 100_000]),
           min_exp=st.integers(6, 12),
           max_active=st.one_of(st.none(), st.integers(1, 5)),
           queue_depth=st.integers(0, 3), ops=ADMISSION_OPS)
    def test_call_sequences_equal_reference(self, total, min_exp,
                                            max_active, queue_depth, ops):
        """Acquire (non-blocking, or queued with a zero timeout) and
        release in the same order on both controllers: the same grants,
        the same AdmissionRejected / AdmissionTimeout, the same counters
        and peaks after every call."""
        kw = dict(min_words=1 << min_exp, max_active=max_active,
                  queue_depth=queue_depth)
        port, ref = AdmissionController(total, **kw), RefAdmission(total,
                                                                    **kw)
        held = {id(port): [], id(ref): []}
        for op, want, pick in ops:
            outs = []
            for c, rej, tmo in ((port, AdmissionRejected, AdmissionTimeout),
                                (ref, RefRejected, RefTimeout)):
                mine = held[id(c)]
                if op == "release":
                    if mine:
                        mine.pop(pick % len(mine)).release()
                    outs.append(None)
                    continue
                try:
                    if op == "timeout":
                        res = c.acquire(want, timeout=0.0)
                    else:
                        res = c.acquire(want, block=False)
                    mine.append(res)
                    outs.append(("granted", res.words))
                except rej as e:
                    outs.append(("rejected", str(e)))
                except tmo as e:
                    outs.append(("timeout", str(e)))
            assert outs[0] == outs[1], (op, want)
            assert _ctrl_state(port) == _ctrl_state(ref)
            assert port.reserved_words <= port.total_words
        for c in (port, ref):
            for res in held[id(c)]:
                res.release()
        assert _ctrl_state(port) == _ctrl_state(ref)
        assert port.reserved_words == port.active == 0

    def test_min_words_above_total_rejected_as_reference(self):
        with pytest.raises(ValueError, match="min_words"):
            AdmissionController(100, min_words=200)
        with pytest.raises(ValueError, match="min_words"):
            RefAdmission(100, min_words=200)

    def test_fair_share_shrinks_under_contention(self):
        ctrl = AdmissionController(1 << 16, min_words=1 << 8)
        alone = ctrl.acquire()
        assert alone.words == 1 << 16
        alone.release()
        r1 = ctrl.acquire(want_words=1 << 14)
        assert r1.words == 1 << 14
        r2 = ctrl.acquire()
        assert r2.words == 1 << 15
        r3 = ctrl.acquire()
        assert r3.words == 1 << 14
        for r in (r1, r2, r3):
            r.release()
        assert ctrl.reserved_words == 0

    def test_nonblocking_reject_and_timeout(self):
        ctrl = AdmissionController(1 << 12, min_words=1 << 12)
        held = ctrl.acquire()
        with pytest.raises(AdmissionRejected):
            ctrl.acquire(block=False)
        with pytest.raises(AdmissionTimeout):
            ctrl.acquire(timeout=0.05)
        held.release()
        ctrl.acquire(block=False).release()

    def test_queue_depth_bounds_waiters(self, thread_guard):
        ctrl = AdmissionController(1 << 12, min_words=1 << 12,
                                   queue_depth=1)
        held = ctrl.acquire()
        waiter_err = []

        def waiter():
            try:
                ctrl.acquire(timeout=5).release()
            except Exception as e:               # noqa: BLE001
                waiter_err.append(e)

        t = threading.Thread(target=waiter)
        t.start()
        deadline = time.monotonic() + 5
        while ctrl.waiting < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(AdmissionRejected, match="queue full"):
            ctrl.acquire(timeout=5)
        held.release()
        t.join(10)
        assert not t.is_alive()
        assert not waiter_err

    def test_release_is_idempotent(self):
        ctrl = AdmissionController(1 << 12, min_words=1 << 10)
        res = ctrl.acquire()
        res.release()
        res.release()
        with ctrl.acquire() as res2:
            assert ctrl.active == 1 and res2.words == 1 << 12
        assert ctrl.reserved_words == 0 and ctrl.active == 0

    @settings(max_examples=5, deadline=None)
    @given(seeds=st.lists(st.integers(0, 1 << 30), min_size=2, max_size=8),
           max_active=st.one_of(st.none(), st.integers(1, 4)))
    def test_reservations_bounded_under_hammering(self, seeds, max_active):
        guard = ThreadGuard()
        ctrl = AdmissionController(1 << 16, min_words=1 << 10,
                                   max_active=max_active, queue_depth=64)
        over, errors = [], []

        def hammer(seed):
            rng = np.random.default_rng(seed)
            for _ in range(20):
                try:
                    res = ctrl.acquire(
                        int(rng.integers(1 << 10, 1 << 15)), timeout=30)
                except AdmissionTimeout:
                    continue
                except Exception as e:           # noqa: BLE001
                    errors.append(e)
                    return
                if ctrl.reserved_words > ctrl.total_words:
                    over.append(ctrl.reserved_words)
                if max_active is not None and ctrl.active > max_active:
                    over.append(("active", ctrl.active))
                time.sleep(0.0005)
                res.release()

        threads = [threading.Thread(target=hammer, args=(s,))
                   for s in seeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors and not over
        assert ctrl.reserved_words == 0 and ctrl.active == 0
        assert ctrl.peak_reserved <= ctrl.total_words
        assert ctrl.n_admitted + ctrl.n_timeouts == 20 * len(seeds)
        guard.assert_clean()


# ---------------------------------------------------------------------------
# concurrency, envelopes, admission, cancellation, faults, pagination:
# the port's server held to the reference's results
# ---------------------------------------------------------------------------

class TestConcurrencyStress:
    @settings(max_examples=4, deadline=None)
    @given(mix=st.lists(st.tuples(st.sampled_from(NAMES),
                                  st.sampled_from(["count", "list"])),
                        min_size=2, max_size=6),
           workers=st.sampled_from([1, ENV_WORKERS]),
           cache_on=st.booleans())
    def test_random_mix_from_threads(self, mix, workers, cache_on):
        guard = ThreadGuard()
        srv = port_server(graph=SMALL, mem_words=1 << 15,
                          cache_words=(1 << 15) if cache_on else 0,
                          workers_per_query=workers, max_active=4,
                          queue_depth=16)
        errors, results = [], {}
        over = []
        stop = threading.Event()

        def sampler():
            while not stop.is_set():
                r = srv.admission.reserved_words
                if r > srv.mem_words:
                    over.append(r)
                time.sleep(0.002)

        def client(i, name, mode):
            try:
                h = srv.submit(name, mode, timeout=120)
                results[i] = (name, mode, h.result(timeout=300),
                              h.admitted_words, h.retry_rounds)
            except Exception as e:               # noqa: BLE001
                errors.append((i, name, mode, e))

        st_t = threading.Thread(target=sampler)
        st_t.start()
        threads = [threading.Thread(target=client, args=(i, nm, md))
                   for i, (nm, md) in enumerate(mix)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stop.set()
        st_t.join(10)
        try:
            assert not errors, errors
            assert not over, over
            assert len(results) == len(mix)
            for i, (name, mode, got, m_i, rounds) in results.items():
                assert m_i >= srv.admission.min_words
                assert rounds == 0
                if mode == "count":
                    assert got == oracle(name, graph=SMALL), (name, got)
                else:
                    np.testing.assert_array_equal(
                        canon(got), oracle(name, "list", graph=SMALL))
            assert srv.admission.reserved_words == 0
            assert srv.admission.active == 0
            assert srv.admission.peak_reserved <= srv.mem_words
            # the device's per-query partitions sum to its global ledger
            tags = srv.device.all_tag_stats()
            for f in ("block_reads", "word_reads"):
                assert sum(getattr(t, f) for t in tags.values()) == \
                    getattr(srv.device.stats, f), f
        finally:
            srv.close()
        guard.assert_clean()

    def test_concurrent_results_equal_serial_reference_runs(self,
                                                            thread_guard):
        """Four queries at once at a fixed budget each: every result equals
        the reference server's serial run of the same query, listings row
        for row in plan order."""
        mix = [("triangle", "count"), ("path3", "count"),
               ("triangle", "list"), ("four_clique", "count")]
        with ref_server(mem_words=1 << 15) as ref:
            want = [ref.submit(n, m, want_words=1 << 13).result(300)
                    for n, m in mix]
        with port_server(mem_words=1 << 15, max_active=4,
                         workers_per_query=ENV_WORKERS) as srv:
            handles = [srv.submit(n, m, want_words=1 << 13)
                       for n, m in mix]
            for h, w, (_, m) in zip(handles, want, mix):
                assert_same_result(h.result(300), w, m)
                assert h.admitted_words == 1 << 13
            assert srv.admission.peak_active >= 2
            assert srv.admission.peak_reserved <= srv.mem_words


class TestSoloEnvelope:
    def test_block_reads_within_solo_envelope(self, thread_guard):
        with ref_server() as ref, port_server() as srv:
            for name in NAMES:
                h = srv.submit(name, "count")
                got = h.result(300)
                solo, solo_stats = srv.solo_run(name, "count",
                                                words=h.admitted_words)
                ref_solo, ref_stats = ref.solo_run(name, "count",
                                                   words=h.admitted_words)
                assert got == solo == ref_solo == oracle(name)
                assert ledger(solo_stats) == ledger(ref_stats)
                assert h.stats.block_reads <= solo_stats.block_reads, name

    def test_warm_cache_strictly_reduces_repeat_reads(self, thread_guard):
        with ref_server() as ref, port_server() as srv:
            stats = []
            for s in (srv, ref):
                h1 = s.submit("triangle")
                h1.result(300)
                h2 = s.submit("triangle")
                h2.result(300)
                stats.append((ledger(h1.stats), ledger(h2.stats)))
            assert stats[0] == stats[1]
            (p1, p2), _ = stats
            assert p2["cache_hits"] > 0
            assert p2["block_reads"] <= p1["block_reads"]


class TestServerAdmission:
    def test_oversubscription_rejects_then_recovers(self, thread_guard):
        with port_server(mem_words=1 << 14, min_words=1 << 14,
                         max_active=1, queue_depth=0) as srv:
            gate = threading.Event()
            srv.fault_hook = lambda stage, qid, i: gate.wait(30)
            slow = srv.submit("triangle")
            deadline = time.monotonic() + 10
            while srv.admission.active < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            with pytest.raises(AdmissionRejected):
                srv.submit("triangle", block=False)
            gate.set()
            srv.fault_hook = None
            assert slow.result(300) == oracle("triangle")
            assert srv.submit("triangle").result(300) == oracle("triangle")
            assert srv.admission.n_rejected == 1

    def test_queued_submission_times_out(self, thread_guard):
        with port_server(mem_words=1 << 14, min_words=1 << 14,
                         max_active=1, queue_depth=2) as srv:
            gate = threading.Event()
            srv.fault_hook = lambda stage, qid, i: gate.wait(30)
            slow = srv.submit("triangle")
            with pytest.raises(AdmissionTimeout):
                srv.submit("triangle", timeout=0.05)
            gate.set()
            srv.fault_hook = None
            assert slow.result(300) == oracle("triangle")
            assert srv.admission.n_timeouts == 1


class TestCancellation:
    def test_cancel_mid_query_leaves_server_serving(self):
        guard = ThreadGuard()
        srv = port_server(mem_words=1 << 13, max_active=4,
                          workers_per_query=ENV_WORKERS)
        try:
            boxes_seen = []
            gate = threading.Event()

            def slow_hook(stage, qid, i):
                if stage == "work" and qid == "q0":
                    boxes_seen.append(i)
                    gate.wait(0.05)

            srv.fault_hook = slow_hook
            victim = srv.submit("four_clique")
            deadline = time.monotonic() + 30
            while not boxes_seen and time.monotonic() < deadline:
                time.sleep(0.002)
            victim.cancel()
            assert victim.wait(60)
            srv.fault_hook = None
            assert victim.status == "cancelled"
            with pytest.raises(QueryCancelled):
                victim.result(5)
            assert srv.admission.reserved_words == 0
            assert srv.submit("triangle").result(300) == oracle("triangle")
        finally:
            srv.close()
        guard.assert_clean()

    def test_close_cancels_everything_without_leaks(self):
        guard = ThreadGuard()
        srv = port_server(mem_words=1 << 13, max_active=8)
        srv.fault_hook = lambda stage, qid, i: time.sleep(0.01)
        handles = [srv.submit("four_clique") for _ in range(3)]
        srv.close()
        for h in handles:
            assert h.done()
        with pytest.raises(Exception, match="closed"):
            srv.submit("triangle")
        guard.assert_clean()


class TestFaultInjection:
    @pytest.mark.parametrize("stage", ["fetch", "build", "work"])
    def test_flaky_stage_recovers_as_the_reference(self, stage,
                                                   thread_guard):
        """A box whose ``stage`` raises twice recovers through the retry
        rounds on both servers: the same result, the same retry rounds and
        the same attempts per box (the flaky box three times, every other
        box once)."""
        def make_hook(attempts, lock):
            def flaky(stg, qid, i):
                if stg != stage:
                    return
                with lock:
                    attempts[i] = attempts.get(i, 0) + 1
                    if i == 0 and attempts[i] <= 2:
                        raise OSError(f"injected {stage} fault")
            return flaky

        seen = []
        for make in (ref_server, port_server):
            attempts, lock = {}, threading.Lock()
            with make(mem_words=1 << 13, box_retries=2) as srv:
                srv.fault_hook = make_hook(attempts, lock)
                h = srv.submit("triangle")
                seen.append((h.result(300), h.retry_rounds, h.status,
                             attempts))
        assert seen[0] == seen[1]
        got, rounds, status, attempts = seen[1]
        assert got == oracle("triangle") and status == "done"
        assert rounds == 2 and attempts[0] == 3
        assert all(n == 1 for i, n in attempts.items() if i != 0), attempts

    def test_flaky_listing_recovers(self, thread_guard):
        calls = {"n": 0}

        def flaky(stg, qid, i):
            if stg == "fetch" and i == 1:
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise OSError("injected read fault")

        # at 2^12 words the listing has several boxes, so box 1 exists
        with port_server(mem_words=1 << 12, box_retries=2) as srv, \
                ref_server(mem_words=1 << 12) as ref:
            srv.fault_hook = flaky
            h = srv.submit("path3", "list")
            rows = h.result(300)
            want = ref.submit("path3", "list").result(300)
            assert rows.tobytes() == want.tobytes()
            assert h.stats.n_boxes > 1
            assert h.retry_rounds == 2 and calls["n"] == 3

    def test_exhausted_retries_fail_cleanly_without_poisoning_cache(
            self, thread_guard):
        with port_server(mem_words=1 << 14, cache_words=1 << 20,
                         box_retries=1) as srv:
            warm = srv.submit("triangle")
            assert warm.result(300) == oracle("triangle")
            before = {n: c.snapshot() for n, c in srv.caches.items()}
            assert any(before.values())

            def always_fail(stg, qid, i):
                if stg == "fetch":
                    raise OSError("store is gone")

            srv.fault_hook = always_fail
            victim = srv.submit("triangle")
            with pytest.raises(QueryFailed, match="still failing") as e:
                victim.result(300)
            assert isinstance(e.value.cause, OSError)
            assert victim.status == "error"
            srv.fault_hook = None
            after = {n: c.snapshot() for n, c in srv.caches.items()}
            assert before == after
            assert srv.admission.reserved_words == 0
            assert srv.submit("triangle").result(300) == oracle("triangle")

    def test_failure_does_not_disturb_concurrent_query(self, thread_guard):
        def fail_q(stg, qid, i):
            if qid == "q0" and stg == "work":
                raise RuntimeError("victim box explodes")

        with port_server(mem_words=1 << 15, max_active=4,
                         box_retries=0) as srv:
            srv.fault_hook = fail_q
            victim = srv.submit("triangle")
            bystander = srv.submit("path3")
            with pytest.raises(QueryFailed):
                victim.result(300)
            assert bystander.result(300) == oracle("path3")
            assert bystander.retry_rounds == 0


class TestPagination:
    @pytest.mark.parametrize("name", ["path3", "four_clique"])
    def test_pages_concatenate_to_the_reference_listing(self, name,
                                                        thread_guard):
        """Streamed pages in plan order: concatenated, the bytes of the
        reference server's listing (and of the port's own result)."""
        with port_server(mem_words=1 << 14, page_rows=256,
                         page_queue_depth=2) as srv, \
                ref_server(mem_words=1 << 14) as ref:
            want = ref.submit(name, "list").result(300)
            h = srv.submit(name, "list", stream=True)
            pages = list(h.pages())
            assert all(0 < len(p) <= 256 for p in pages)
            got = np.concatenate(pages) if pages \
                else np.zeros((0, want.shape[1]), np.int64)
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()
            assert h.result(60).tobytes() == want.tobytes()
            assert h._stream.n_pages == len(pages)

    def test_pages_keep_plan_order_with_several_workers(self,
                                                        thread_guard):
        """Four box workers feed one stream through a one-page queue: the
        pages still leave in plan order, so they concatenate to the
        reference server's listing. (The reference's own stream puts each
        box's pages outside its reorder lock, and with several workers
        they interleave across boxes; the port keeps the order.)"""
        with ref_server(mem_words=1 << 12) as ref:
            want = ref.submit("path3", "list").result(300)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)          # switch threads often
        try:
            with port_server(mem_words=1 << 12, workers_per_query=4,
                             page_rows=256, page_queue_depth=1) as srv:
                for _ in range(2):
                    h = srv.submit("path3", "list", stream=True)
                    got = np.concatenate(list(h.pages()))
                    assert h.stats.n_boxes > 1
                    assert got.tobytes() == want.tobytes()
                    assert h.result(60).tobytes() == want.tobytes()
        finally:
            sys.setswitchinterval(interval)

    def test_slow_consumer_backpressure(self, thread_guard):
        with port_server(mem_words=1 << 13, page_rows=64,
                         page_queue_depth=1) as srv:
            h = srv.submit("triangle", "list", stream=True)
            total = 0
            for page in h.pages():
                total += len(page)
                time.sleep(0.002)
            assert total == oracle("triangle")
            assert h._stream.n_pages >= -(-total // 64)

    def test_cancel_mid_stream_raises_for_consumer(self, thread_guard):
        with port_server(mem_words=1 << 12, page_rows=8,
                         page_queue_depth=1) as srv:
            srv.fault_hook = lambda stg, qid, i: time.sleep(0.005)
            h = srv.submit("path3", "list", stream=True)
            with pytest.raises(QueryCancelled):
                for i, _page in enumerate(h.pages()):
                    if i == 1:
                        h.cancel()
            assert h.wait(60)
            assert h.status == "cancelled"
            srv.fault_hook = None
            assert srv.submit("triangle").result(300) == oracle("triangle")

    def test_pages_requires_stream_submission(self, thread_guard):
        with port_server() as srv:
            h = srv.submit("triangle", "count")
            h.result(300)
            with pytest.raises(Exception, match="stream"):
                h.pages()
