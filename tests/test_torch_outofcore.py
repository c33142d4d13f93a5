"""The port's out-of-core main path against the reference's, on the CPU.

``TriangleEngine(store=...)`` and ``QueryEngine(store=...)`` of
``repro_torch`` (``torch_device="cpu"``: the kernel wrappers run their
plain torch versions) against ``repro.core.TriangleEngine`` and
``repro.query.QueryEngine`` on the same edge store, with the slice cache
and degree bins on and off and one or four workers; the in-memory
``degree_bins=True`` engine; ``TriangleEngine.ingest``. Inputs are
fixed-seed graphs, and every comparison is exact (tolerance 0): counts,
``list()`` bytes, and the ``EngineStats`` / ``QueryStats`` ledgers — block
reads, writes and word reads on the charged ``BlockDevice``, the cache's
hits, misses and hit words, the boxes per lane, padded and actual words
and ``device_invocations``. The reference's binned totals are int32, so the
graphs keep them far below 2^31.
"""

import numpy as np
import pytest

import repro.query.executor as ref_query_executor
from repro.core import TriangleEngine as RefEngine
from repro.core.iomodel import BlockDevice as RefDevice
from repro.data import edgestore as r_store
from repro.data.graphs import clustered_graph, rmat_graph
from repro.query import QueryEngine as RefQuery
from repro.query import patterns as ref_patterns
from repro.query.vectorized import VectorizedBoxJoin as RefJoin
from repro_torch import EdgeStore, QueryEngine, TriangleEngine, patterns
from repro_torch.core.iomodel import BlockDevice
from repro_torch.core.leapfrog import Atom
from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
from repro_torch.core.queries import Query
from repro_torch.data.edgestore import InMemoryEdgeSource


def er_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, k=1))
    return src.astype(np.int64), dst.astype(np.int64)


GRAPHS = {
    "rmat": lambda: rmat_graph(256, 2400, seed=5),
    "er": lambda: er_graph(96, 0.3, seed=11),
    "clustered": lambda: clustered_graph(4, 32, seed=2, p_in=0.5),
}
ORIENT = {"rmat": "minmax", "er": "degree", "clustered": "minmax"}
MEM, IO_BLOCK = 400, 64
# the port's lane names; the reference calls the intersect lane "pallas"
REF_BACKEND = {"intersect": "pallas"}

LEDGER = ("block_reads", "block_writes", "word_reads", "cache_hits",
          "cache_misses", "cache_hit_words")
STATS = LEDGER + ("n_boxes", "n_dense_boxes", "n_binary_boxes",
                  "n_host_boxes", "n_fused_boxes", "n_rescans",
                  "padded_words", "actual_words", "device_invocations",
                  "max_box_device_invocations", "n_streamed_boxes",
                  "slice_words_read", "max_slice_words",
                  "max_slice_padded_words", "source")


def _stats(stats, ref):
    out = {f: getattr(stats, f) for f in STATS}
    out["n_intersect_boxes"] = stats.n_pallas_boxes if ref \
        else stats.n_intersect_boxes
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One reference-written store per graph, in its orientation."""
    d = tmp_path_factory.mktemp("stores")
    return {name: str(r_store.write_edge_store(
        d / f"{name}.csr", *make(), orientation=ORIENT[name], chunk_rows=64,
        align_words=32)) for name, make in GRAPHS.items()}


def _both(path, backend="auto", mem=MEM, **kw):
    ref = RefEngine(store=path, mem_words=mem, io_block_words=IO_BLOCK,
                    backend=REF_BACKEND.get(backend, backend), **kw)
    port = TriangleEngine(store=path, mem_words=mem, io_block_words=IO_BLOCK,
                          backend=backend, torch_device="cpu", **kw)
    return ref, port


def _assert_count_and_list(ref, port):
    """Equal plans, counts, listings and ledgers; the count's stats."""
    assert port.plan() == ref.plan()
    assert port.count() == ref.count()
    count_stats = port.stats
    assert _stats(count_stats, False) == _stats(ref.stats, True)
    assert count_stats.source == "edgestore"
    r_tris, p_tris = ref.list(), port.list()
    assert p_tris.dtype == r_tris.dtype and p_tris.shape == r_tris.shape
    assert p_tris.tobytes() == r_tris.tobytes()
    assert _stats(port.stats, False) == _stats(ref.stats, True)
    return count_stats


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("cache_words", [0, 8 * MEM])
@pytest.mark.parametrize("degree_bins", [False, True])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_store_backed_engine_equals_reference(stores, graph, degree_bins,
                                              cache_words, workers):
    ref, port = _both(stores[graph], degree_bins=degree_bins,
                      cache_words=cache_words, workers=workers)
    stats = _assert_count_and_list(ref, port)
    if cache_words:
        assert stats.cache_hits > 0
    if degree_bins and graph != "clustered":   # clustered: dense boxes
        assert stats.n_binary_boxes > 0


@pytest.mark.parametrize("backend", ["binary", "dense", "intersect", "host"])
@pytest.mark.parametrize("graph", ["rmat", "clustered"])
def test_store_backed_lanes_equal_reference(stores, graph, backend):
    # a wider budget: fewer boxes, fewer programs for the reference to
    # compile
    ref, port = _both(stores[graph], backend=backend, mem=3 * MEM,
                      degree_bins=True, cache_words=4 * MEM)
    _assert_count_and_list(ref, port)


@pytest.mark.parametrize("cache_words", [0, 8 * MEM])
@pytest.mark.parametrize("degree_bins", [False, True])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_one_and_four_workers_have_one_ledger(stores, graph, degree_bins,
                                              cache_words):
    """Fetches are serialized in plan order whenever the reads are charged
    or cached, so four workers read the store block for block as one does:
    the same I/O and cache ledger, count and listing."""
    runs = []
    for workers in (1, 4):
        eng = TriangleEngine(store=stores[graph], mem_words=MEM,
                             io_block_words=IO_BLOCK, workers=workers,
                             degree_bins=degree_bins,
                             cache_words=cache_words, torch_device="cpu")
        count = eng.count()
        count_stats = eng.stats
        tris = eng.list()
        runs.append((count, [getattr(count_stats, f) for f in LEDGER],
                     tris.tobytes(), [getattr(eng.stats, f) for f in LEDGER]))
    assert runs[0] == runs[1]


def test_queue_order_follows_a_cache(stores):
    """With a SliceCache and no charged device the queue still drains in
    plan order (the reference's rule), not LPT-first."""
    src, dst = GRAPHS["rmat"]()
    eng = TriangleEngine(src, dst, mem_words=MEM, cache_words=4 * MEM,
                         workers=4, torch_device="cpu")
    ex = eng._make_executor()
    boxes = eng.plan()
    assert ex._queue_order(boxes) == list(range(len(boxes)))
    bare = TriangleEngine(src, dst, mem_words=MEM, workers=4,
                          torch_device="cpu")._make_executor()
    assert bare._queue_order(boxes) != list(range(len(boxes)))


@pytest.mark.parametrize("backend", ["auto", "binary", "dense", "intersect",
                                     "host"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_in_memory_degree_bins_equal_reference(graph, backend):
    """The in-memory binned path on a charged BlockDevice: count,
    ``n_binary_boxes``, the lane mix, padding and the block I/O ledger."""
    src, dst = GRAPHS[graph]()
    kw = dict(mem_words=MEM, degree_bins=True, orientation=ORIENT[graph])
    ref = RefEngine(src, dst, device=RefDevice(block_words=IO_BLOCK,
                                               cache_blocks=8),
                    backend=REF_BACKEND.get(backend, backend), **kw)
    port = TriangleEngine(src, dst, device=BlockDevice(block_words=IO_BLOCK,
                                                       cache_blocks=8),
                          backend=backend, torch_device="cpu", **kw)
    assert port.count() == ref.count()
    assert _stats(port.stats, False) == _stats(ref.stats, True)
    assert port.stats.source == "memory"
    assert port.stats.block_reads > 0
    if backend in ("auto", "binary", "host"):
        assert port.stats.n_binary_boxes > 0
    assert port.list().tobytes() == ref.list().tobytes()


def test_binned_csr_route_equals_the_padded_bins(stores):
    """The card's route through the bins (one ``intersect_count_csr`` over
    the CSR, no bin matrix) gives the per-bin-pair probe's count and
    charges the same padded words, box by box from a store and over the
    whole in-memory graph; here ``intersect_count_csr`` runs its plain
    version."""
    eng = TriangleEngine(store=stores["rmat"], mem_words=MEM,
                         degree_bins=True, torch_device="cpu")
    ex = eng._make_executor()
    n_boxes = 0
    for box in eng.plan():
        slc = ex._materialize(box)
        if slc is None or slc.n_edges == 0:
            continue
        got = []
        for use_kernels in (False, True):
            ex.use_kernels = use_kernels
            before = eng.stats.padded_words
            got.append((ex._count_binned_slice(slc),
                        eng.stats.padded_words - before))
        assert got[0] == got[1], box
        n_boxes += 1
    assert n_boxes > 3
    src, dst = GRAPHS["rmat"]()
    mem = TriangleEngine(src, dst, degree_bins=True, torch_device="cpu")
    eu, ev = mem.a, mem.b
    want = mem._count_binned(eu, ev)
    mem.use_kernels = True
    assert mem._count_binned(eu, ev) == want == mem.count()


@pytest.mark.parametrize("batches", [False, True])
def test_ingest_equals_reference(tmp_path, batches):
    """``TriangleEngine.ingest`` spills runs under a small budget and
    writes the reference's bytes; the engines it returns agree."""
    src, dst = GRAPHS["rmat"]()

    def edges():
        if not batches:
            return (src, dst)
        return ((src[i:i + 700], dst[i:i + 700])
                for i in range(0, len(src), 700))

    kw = dict(ingest_budget_words=1024, chunk_rows=64, align_words=32,
              mem_words=MEM, cache_words=4 * MEM, degree_bins=True)
    ref = RefEngine.ingest(tmp_path / "ref.csr", edges(),
                           prefetch_batches=batches, **kw)
    port = TriangleEngine.ingest(tmp_path / "port.csr", edges(),
                                 prefetch_batches=batches,
                                 torch_device="cpu", **kw)
    with open(tmp_path / "ref.csr", "rb") as f:
        want = f.read()
    with open(tmp_path / "port.csr", "rb") as f:
        assert f.read() == want
    assert port.n_spill_runs >= 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.csr",
                                                          "ref.csr"]
    _assert_count_and_list(ref, port)


def test_store_engine_arguments(stores):
    path = stores["rmat"]
    src, dst = GRAPHS["rmat"]()
    with pytest.raises(ValueError, match="one of"):
        TriangleEngine(src, dst, store=path, torch_device="cpu")
    with pytest.raises(ValueError, match="store="):
        TriangleEngine(torch_device="cpu")
    eng = TriangleEngine(store=EdgeStore(path), torch_device="cpu")
    ref = RefEngine(store=path)
    assert eng.indices is None and eng.orientation == "minmax"
    assert eng.device.B == ref.device.B == 4096
    assert eng.device.cache_blocks == ref.device.cache_blocks
    assert eng.count() == ref.count()


# ---------------------------------------------------------------------------
# QueryEngine from a store
# ---------------------------------------------------------------------------

QSTATS = ("order", "rank", "n_boxes", "n_results", "n_rescans",
          "n_streamed_boxes", "slice_words_read", "max_slice_words",
          "max_frontier", "n_kernel_boxes", "n_host_boxes", "n_fused_boxes",
          "device_invocations", "max_box_device_invocations",
          "block_reads", "block_writes", "word_reads", "cache_hits",
          "cache_misses", "cache_hit_words", "source")


@pytest.fixture
def ref_interpret(monkeypatch):
    """The reference engine's box joins with Pallas in interpret mode."""
    monkeypatch.setattr(
        ref_query_executor, "VectorizedBoxJoin",
        lambda *a, **kw: RefJoin(*a, **dict(kw, interpret=True)))


def _qstore(tmp_path_factory, n, m, seed):
    src, dst = rmat_graph(n, m, seed=seed)
    path = tmp_path_factory.mktemp("qstore") / "g.csr"
    return str(r_store.write_edge_store(path, src, dst, chunk_rows=32,
                                        align_words=16)), src, dst


@pytest.fixture(scope="module")
def qstore(tmp_path_factory):
    return _qstore(tmp_path_factory, 120, 900, 3)


@pytest.fixture(scope="module")
def qstore_small(tmp_path_factory):
    """The reference's fused lane compiles a program per box shape (and
    per listing capacity), so its cases run on a small graph."""
    return _qstore(tmp_path_factory, 40, 200, 4)


def _qcases():
    cases = []
    for j, pattern in enumerate(("triangle", "diamond", "path3", "cycle4",
                                 "four_clique")):
        for k, backend in enumerate(("auto", "host", "intersect")):
            cases.append((pattern, backend, (1, 4)[(j + k) % 2],
                          (0, 600)[(j // 2 + k) % 2], 300, (j + k) % 2 == 0))
        cases.append((pattern, "fused", 1, 200, 200, j % 2 == 0))
    return cases


@pytest.mark.parametrize("pattern,backend,workers,cache_words,mem,by_path",
                         _qcases())
def test_store_backed_query_equals_reference(qstore, qstore_small,
                                             ref_interpret, pattern,
                                             backend, workers, cache_words,
                                             mem, by_path):
    """Counts, listings (also at a capacity forcing rescans) and the
    QueryStats ledger, ``store=`` or a path relation, cache on and off."""
    path = (qstore_small if backend == "fused" else qstore)[0]
    kw = dict(mem_words=mem, io_block_words=IO_BLOCK, workers=workers,
              cache_words=cache_words)
    ref_src = {"relations": {"E": path}} if by_path else {"store": path}
    port_src = {"relations": {"E": path}} if by_path \
        else {"store": EdgeStore(path)}
    ref = RefQuery(ref_patterns.PATTERNS[pattern](),
                   backend=REF_BACKEND.get(backend, backend),
                   use_pallas_kernels=backend != "host", **ref_src, **kw)
    port = QueryEngine(patterns.PATTERNS[pattern](), backend=backend,
                       torch_device="cpu", **port_src, **kw)
    assert port.count() == ref.count()
    assert {f: getattr(port.stats, f) for f in QSTATS} == \
        {f: getattr(ref.stats, f) for f in QSTATS}
    assert port.stats.source == "edgestore" and port.stats.block_reads > 0
    for cap in (None, 4):
        r_rows, p_rows = ref.list(capacity=cap), port.list(capacity=cap)
        assert p_rows.dtype == r_rows.dtype and \
            p_rows.tobytes() == r_rows.tobytes()
        assert {f: getattr(port.stats, f) for f in QSTATS} == \
            {f: getattr(ref.stats, f) for f in QSTATS}
    if cache_words:
        assert port.stats.cache_hits + port.stats.cache_misses > 0


def test_store_query_one_and_four_workers_have_one_ledger(qstore):
    runs = []
    for workers in (1, 4):
        eng = QueryEngine(patterns.diamond(), store=qstore[0],
                          mem_words=300, io_block_words=IO_BLOCK,
                          cache_words=600, workers=workers,
                          backend="host", torch_device="cpu")
        runs.append((eng.count(), [getattr(eng.stats, f) for f in QSTATS],
                     eng.list().tobytes()))
    assert runs[0] == runs[1]


def test_store_query_order_must_be_consistent(qstore):
    """A store-backed relation cannot be reversed: an order that makes an
    atom inconsistent raises, as in the reference, and the default order
    keeps every atom consistent."""
    path, src, dst = qstore
    for make, pats in ((QueryEngine, patterns), (RefQuery, ref_patterns)):
        kw = {"torch_device": "cpu"} if make is QueryEngine else {}
        with pytest.raises(ValueError, match="inconsistent"):
            make(pats.triangle(), store=path, order=("z", "y", "x"), **kw)
    ref_err = port_err = None
    mem = QueryEngine.from_graph(patterns.triangle(), src, dst,
                                 torch_device="cpu")
    ref_mem = RefQuery.from_graph(ref_patterns.triangle(), src, dst)
    with pytest.raises(ValueError, match="in memory") as port_err:
        mem._reversed_source(EdgeStore(path))
    with pytest.raises(ValueError, match="in memory") as ref_err:
        ref_mem._reversed_source(r_store.EdgeStore(path))
    assert str(port_err.value) == str(ref_err.value)
    eng = QueryEngine(patterns.PATTERNS["cycle4"](), store=path,
                      torch_device="cpu")
    assert eng.order == RefQuery(ref_patterns.PATTERNS["cycle4"](),
                                 store=path).order


def test_store_query_arguments(qstore):
    path = qstore[0]
    q = patterns.triangle()
    with pytest.raises(ValueError, match="not both"):
        QueryEngine(q, store=path, relations={"E": path},
                    torch_device="cpu")
    two = Query(head=("x", "y", "z"),
                atoms=[Atom("E", ("x", "y")), Atom("F", ("y", "z"))])
    with pytest.raises(ValueError, match="single-relation"):
        QueryEngine(two, store=path, torch_device="cpu")
    with pytest.raises(ValueError, match="relations= or store="):
        QueryEngine(q, torch_device="cpu")


def test_tuple_relation_is_charged_to_the_store_device(qstore):
    """A query joining a store relation with an in-memory tuple relation:
    the store creates the default device, which charges the tuple
    relation's reads too, as in the reference."""
    path, src, dst = qstore
    a, b = orient_edges(src, dst)
    keep = (a + b) % 3 != 0
    fa, fb = a[keep], b[keep]

    def query(mod_atom, mod_query):
        return mod_query(head=("x", "y", "z"),
                         atoms=[mod_atom("E", ("x", "y")),
                                mod_atom("F", ("y", "z")),
                                mod_atom("E", ("x", "z"))])

    from repro.core.leapfrog import Atom as RefAtom
    from repro.core.queries import Query as RefQ
    kw = dict(mem_words=300, io_block_words=IO_BLOCK, backend="host")
    ref = RefQuery(query(RefAtom, RefQ), relations={"E": path,
                                                    "F": (fa, fb)}, **kw)
    port = QueryEngine(query(Atom, Query), relations={"E": path,
                                                      "F": (fa, fb)},
                       torch_device="cpu", **kw)
    assert port.count() == ref.count() > 0
    assert {f: getattr(port.stats, f) for f in QSTATS} == \
        {f: getattr(ref.stats, f) for f in QSTATS}
    assert port._sources["F"].device is port.device is not None


def test_preseeded_reversed_index(qstore):
    """An ``"E~rev"`` relation supplies the reversed index of the atoms an
    order makes inconsistent, instead of deriving it; counts, listings and
    the charged ledger equal the reference's."""
    _, src, dst = qstore
    a, b = orient_edges(src, dst)
    nv = int(max(a.max(), b.max())) + 1
    fwd = csr_from_edges(a, b, n_nodes=nv)
    rev = csr_from_edges(b, a, n_nodes=nv)
    out = []
    for make, pats, dev, src_cls in (
            (QueryEngine, patterns, BlockDevice, InMemoryEdgeSource),
            (RefQuery, ref_patterns, RefDevice,
             r_store.InMemoryEdgeSource)):
        device = dev(block_words=IO_BLOCK, cache_blocks=4)
        rels = {"E": src_cls(*fwd, orientation="minmax", device=device),
                "E~rev": src_cls(*rev, orientation="raw", device=device)}
        kw = {"torch_device": "cpu"} if make is QueryEngine else {}
        eng = make(pats.triangle(), relations=rels, order=("z", "y", "x"),
                   mem_words=300, device=device, backend="host", **kw)
        assert eng._sources["E~rev"] is rels["E~rev"]
        out.append((eng.count(), eng.list().tobytes(),
                    {f: getattr(eng.stats, f) for f in QSTATS}))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="matches no relation"):
        QueryEngine(patterns.triangle(),
                    relations={"E": InMemoryEdgeSource(*fwd),
                               "F~rev": InMemoryEdgeSource(*rev)},
                    torch_device="cpu")
    with pytest.raises(ValueError, match="EdgeSource interface"):
        QueryEngine(patterns.triangle(),
                    relations={"E": InMemoryEdgeSource(*fwd),
                               "E~rev": (b, a)},
                    torch_device="cpu")
