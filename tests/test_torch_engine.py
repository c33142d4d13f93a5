"""repro_torch.TriangleEngine against repro.core.TriangleEngine on the CPU.

The port runs with ``torch_device="cpu"`` (its kernel wrappers then take
their plain torch versions); the reference runs its own CPU lanes, with the
Pallas intersect lane in interpret mode. Counts, ``list()`` bytes, the box
plan, the per-lane box counts, ``n_rescans``, ``padded_words`` /
``actual_words`` and ``device_invocations`` must all be equal.
"""

import numpy as np
import pytest

from repro.core import TriangleEngine as RefEngine
from repro.core.iomodel import BlockDevice as RefDevice
from repro.data import graphs as r_graphs
from repro_torch import TriangleEngine, engine_count, engine_list
from repro_torch.convert import engine_from_state
from repro_torch.core.iomodel import BlockDevice

GRAPHS = {
    "er": lambda: r_graphs.random_graph(150, 1200, seed=4),
    "rmat": lambda: r_graphs.rmat_graph(200, 1800, seed=1),
    "clustered": lambda: r_graphs.clustered_graph(4, 32, seed=2, p_in=0.5),
}

# the port's lane names; the reference calls the intersect lane "pallas"
REF_BACKEND = {"intersect": "pallas"}

STAT_FIELDS = ("n_boxes", "n_dense_boxes", "n_binary_boxes", "n_host_boxes",
               "n_rescans", "padded_words", "actual_words",
               "device_invocations", "max_box_device_invocations",
               "n_streamed_boxes", "slice_words_read", "max_slice_words",
               "max_slice_padded_words", "block_reads", "block_writes",
               "word_reads")


def _cases():
    cases = []
    for g in sorted(GRAPHS):
        for orient in ("minmax", "degree"):
            for mem in (None, 800):
                cases.append((g, orient, mem, 1, "auto"))
        cases.append((g, "minmax", 800, 4, "auto"))
    for g in ("rmat", "clustered"):
        for be in ("binary", "dense", "host", "intersect"):
            cases.append((g, "minmax", 800, 1, be))
    cases.append(("rmat", "degree", 800, 1, "intersect"))
    cases.append(("rmat", "minmax", 800, 4, "intersect"))
    cases.append(("er", "minmax", 800, 4, "host"))
    return cases


def _stats(stats, ref):
    out = {f: getattr(stats, f) for f in STAT_FIELDS}
    out["n_intersect_boxes"] = stats.n_pallas_boxes if ref \
        else stats.n_intersect_boxes
    return out


def _run(make, capacity=None):
    eng = make()
    count = eng.count()
    count_stats = eng.stats
    tris = eng.list(capacity=capacity)
    return eng, count, count_stats, tris, eng.stats


def _assert_same(ref, port):
    r_eng, r_count, r_cs, r_tris, r_ls = ref
    p_eng, p_count, p_cs, p_tris, p_ls = port
    assert p_eng.plan() == r_eng.plan()
    assert p_count == r_count
    assert p_tris.dtype == r_tris.dtype and p_tris.shape == r_tris.shape
    assert p_tris.tobytes() == r_tris.tobytes()
    assert len(p_tris) == p_count
    assert _stats(p_cs, False) == _stats(r_cs, True)
    assert _stats(p_ls, False) == _stats(r_ls, True)


@pytest.mark.parametrize("graph,orient,mem,workers,backend", _cases())
def test_engine_matches_reference(graph, orient, mem, workers, backend):
    src, dst = GRAPHS[graph]()
    kw = dict(mem_words=mem, orientation=orient, workers=workers)
    ref = _run(lambda: RefEngine(src, dst, shard=False,
                                 backend=REF_BACKEND.get(backend, backend),
                                 **kw))
    port = _run(lambda: TriangleEngine(src, dst, backend=backend,
                                       torch_device="cpu", **kw))
    _assert_same(ref, port)
    if backend == "intersect":
        n_box = port[2].n_intersect_boxes
        assert n_box > 0 and port[2].device_invocations == n_box


@pytest.mark.parametrize("graph", ["rmat", "clustered"])
def test_forced_rescans_match_reference(graph):
    src, dst = GRAPHS[graph]()
    ref = _run(lambda: RefEngine(src, dst, mem_words=800, shard=False),
               capacity=64)
    port = _run(lambda: TriangleEngine(src, dst, mem_words=800,
                                       torch_device="cpu"), capacity=64)
    _assert_same(ref, port)
    assert port[4].n_rescans > 0


@pytest.mark.parametrize("workers", [1, 3])
def test_block_device_ledger_matches_reference(workers):
    src, dst = GRAPHS["rmat"]()
    ref = _run(lambda: RefEngine(
        src, dst, mem_words=800, shard=False, workers=workers,
        device=RefDevice(block_words=64, cache_blocks=16)))
    port = _run(lambda: TriangleEngine(
        src, dst, mem_words=800, workers=workers, torch_device="cpu",
        device=BlockDevice(block_words=64, cache_blocks=16)))
    _assert_same(ref, port)
    assert port[2].block_reads > 0 and port[4].block_writes > 0


@pytest.mark.parametrize("orient,backend", [("minmax", "auto"),
                                            ("degree", "intersect"),
                                            ("minmax", "host")])
def test_engine_from_state_runs_reference_plan(orient, backend):
    src, dst = GRAPHS["rmat"]()
    r_eng = RefEngine(src, dst, mem_words=700, orientation=orient,
                      shard=False, backend=REF_BACKEND.get(backend, backend))
    state = {"indptr": r_eng.indptr, "indices": r_eng.indices,
             "orientation": r_eng.orientation, "nv": r_eng.nv,
             "plan": r_eng.plan()}
    ref = _run(lambda: r_eng)
    port = _run(lambda: engine_from_state(state, mem_words=700,
                                          backend=backend,
                                          torch_device="cpu"))
    _assert_same(ref, port)
    # without a plan the port plans for itself, to the same boxes
    state.pop("plan")
    assert engine_from_state(state, mem_words=700,
                             torch_device="cpu").plan() == r_eng.plan()


def test_engine_from_state_rejects_inconsistent_nv():
    src, dst = GRAPHS["er"]()
    r_eng = RefEngine(src, dst, shard=False)
    state = {"indptr": r_eng.indptr, "indices": r_eng.indices,
             "orientation": "minmax", "nv": r_eng.nv + 1}
    with pytest.raises(ValueError, match="nv"):
        engine_from_state(state, torch_device="cpu")


def test_dispatch_on_the_card_routes_like_reference_on_tpu():
    """With kernels on (the card), 'auto' routes exactly as the reference
    routes with use_pallas_kernels: dense / intersect band / binary."""
    src, dst = GRAPHS["er"]()
    ref = RefEngine(src, dst, use_pallas_kernels=True, shard=False)
    port = TriangleEngine(src, dst, torch_device="cpu")
    assert not port.use_kernels
    port.use_kernels = True        # the routing rule alone, no launch
    assert port.intersect_threshold == ref.pallas_threshold
    for n_edges in (0, 1, 5, 20, 60, 200, 5000, 10 ** 7):
        for wx, wy in ((32, 32), (100, 100), (1000, 17), (4000, 4000)):
            want = ref._pick_backend(n_edges, wx, wy)
            got = port._pick_backend(n_edges, wx, wy)
            assert REF_BACKEND.get(got, got) == want, (n_edges, wx, wy)


def test_conveniences_and_canonical_rows():
    i, j = np.triu_indices(7, k=1)
    assert engine_count(i, j, torch_device="cpu") == 35
    tris = engine_list(i, j, torch_device="cpu")
    assert tris.shape == (35, 3) and (np.diff(tris, axis=1) > 0).all()
    empty = TriangleEngine(np.array([0, 1]), np.array([1, 2]),
                           torch_device="cpu")
    assert empty.count() == 0 and empty.list().shape == (0, 3)


@pytest.mark.parametrize("kw", [
    dict(shard=True), dict(tracer=object()), dict(metrics=object()),
    dict(dense_threshold="measured"), dict(intersect_threshold="measured"),
    dict(fused_threshold="measured")])
def test_unported_options_raise(kw):
    src, dst = GRAPHS["er"]()
    with pytest.raises(NotImplementedError, match="not ported"):
        TriangleEngine(src, dst, torch_device="cpu", **kw)


def test_reference_lane_name_is_rejected():
    src, dst = GRAPHS["er"]()
    with pytest.raises(ValueError, match="backend"):
        TriangleEngine(src, dst, backend="pallas", torch_device="cpu")


@pytest.mark.parametrize("workers", [1, 4])
def test_box_queue_drains_match_reference(workers):
    """run_box_serial / run_box_queue: per-item results in item order and
    the same fetch order (serialized in queue order) as the reference."""
    from repro.core import executor as r_ex
    from repro_torch.core import executor as p_ex
    items = list(range(23))
    order = [int(i) for i in np.random.default_rng(3).permutation(23)]

    def drain(mod):
        fetched = []

        def fetch(i):
            fetched.append(i)
            return i, i + 1

        kw = dict(fetch=fetch, build=lambda i: None if i % 5 == 0 else i,
                  work=lambda i: i * i)
        serial = mod.run_box_serial(items, prefetch_depth=2, **kw)
        pooled, tele = mod.run_box_queue(
            items, order=order, est_words=lambda i: i, workers=workers,
            inflight_items=3, inflight_words=40, **kw)
        return serial, pooled, fetched, tele["pool"]

    r_serial, r_pooled, r_fetched, r_pool = drain(r_ex)
    p_serial, p_pooled, p_fetched, p_pool = drain(p_ex)
    assert p_serial == r_serial and p_pooled == r_pooled
    assert p_fetched == r_fetched == items + order
    assert p_pool == r_pool


def test_box_queue_cancel_and_errors():
    import threading
    from repro_torch.core.executor import BoxQueueCancelled, run_box_queue
    ev = threading.Event()
    ev.set()
    with pytest.raises(BoxQueueCancelled):
        run_box_queue(list(range(5)), order=list(range(5)),
                      est_words=lambda i: 1, fetch=lambda i: (i, 1),
                      build=lambda i: i, work=lambda i: i, workers=2,
                      inflight_items=2, cancel=ev)

    def work(i):
        if i == 3:
            raise KeyError("lane failed")
        return i

    with pytest.raises(KeyError):
        run_box_queue(list(range(8)), order=list(range(8)),
                      est_words=lambda i: 1, fetch=lambda i: (i, 1),
                      build=lambda i: i, work=work, workers=3,
                      inflight_items=2)


@pytest.mark.parametrize("backend", ["binary", "intersect", "dense"])
def test_count_box_matches_reference(backend):
    src, dst = GRAPHS["clustered"]()
    r_eng = RefEngine(src, dst, mem_words=800, shard=False,
                      backend=REF_BACKEND.get(backend, backend))
    p_eng = TriangleEngine(src, dst, mem_words=800, backend=backend,
                           torch_device="cpu")
    r_ex, p_ex = r_eng._make_executor(), p_eng._make_executor()
    for box in r_eng.plan():
        assert p_ex.count_box(box) == r_ex.count_box(box)
    assert _stats(p_ex.stats, False) == _stats(r_ex.stats, True)
