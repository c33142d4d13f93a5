"""repro_torch.query.QueryEngine against repro.query.QueryEngine on the CPU.

The port runs with ``torch_device="cpu"`` (its kernel wrappers then take
their plain torch versions); the reference runs on the CPU with its Pallas
kernels in interpret mode where its lanes reach them, as the reference's
own tests run them. Its engine picks ``interpret=not use_pallas_kernels``,
so with ``use_pallas_kernels=True`` the ``ref_interpret`` fixture hands
its box joins ``interpret=True``; nothing else of the reference changes.

Inputs are fixed-seed graphs. Counts, ``list()`` bytes (also at a capacity
that forces rescans), ``n_rescans``, the plan (order, rank, boxes, lanes)
and the run statistics — boxes per lane, ``max_frontier``,
``slice_words_read``, ``device_invocations``, and ``block_reads`` /
``word_reads`` on a charged ``BlockDevice`` — must be equal.
``device_transfer_bytes`` is the port's own account and is only recorded.
"""

import numpy as np
import pytest
import torch

import repro.query.executor as ref_executor
from repro.core.iomodel import BlockDevice as RefDevice
from repro.data import graphs as r_graphs
from repro.kernels.intersect.ops import \
    intersect_count_rows as ref_intersect_rows
from repro.query import QueryEngine as RefEngine
from repro.query import patterns as ref_patterns
from repro.query.vectorized import VectorizedBoxJoin as RefJoin
from repro_torch import QueryEngine, patterns, query_count
from repro_torch.convert import query_engine_from_state
from repro_torch.core.iomodel import BlockDevice
from repro_torch.core.lftj_torch import orient_edges
from repro_torch.kernels import ledger
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.lftj_fused import ops as fused_ops
from repro_torch.query.vectorized import VectorizedBoxJoin, build_atom_slice


def er_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, k=1))
    return src.astype(np.int64), dst.astype(np.int64)


def star_graph(hubs, leaves, seed):
    """Hubs adjacent to every leaf plus a sprinkle of leaf-leaf edges."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(hubs), leaves)
    dst = hubs + np.tile(np.arange(leaves), hubs)
    extra = rng.integers(hubs, hubs + leaves, size=(leaves, 2))
    extra = extra[extra[:, 0] < extra[:, 1]]
    uniq = np.unique(np.concatenate([src, extra[:, 0]]) * (hubs + leaves)
                     + np.concatenate([dst, extra[:, 1]]))
    return uniq // (hubs + leaves), uniq % (hubs + leaves)


GRAPHS = {
    "er": lambda: er_graph(28, 0.25, 1),
    "rmat": lambda: r_graphs.rmat_graph(48, 300, seed=2),
    "star": lambda: star_graph(2, 20, 3),
}
PATTERNS = ("triangle", "four_clique", "diamond", "path3", "cycle4")
# the port's backend names; the reference calls the intersect lane "pallas"
REF_BACKEND = {"intersect": "pallas"}

STAT_FIELDS = ("order", "rank", "n_boxes", "n_results", "n_rescans", "skew",
               "heavy_threshold", "n_hub_boxes", "n_light_boxes",
               "n_mixed_boxes", "n_streamed_boxes", "slice_words_read",
               "max_slice_words", "max_frontier", "n_kernel_boxes",
               "n_host_boxes", "n_fused_boxes", "device_invocations",
               "max_box_device_invocations", "n_workers", "inflight_boxes",
               "block_reads", "block_writes", "word_reads", "cache_hits",
               "cache_misses", "cache_hit_words", "source")
PLAN_FIELDS = ("order", "rank", "owned_dims", "boxes", "budgets",
               "single_box", "skew", "lanes", "heavy_threshold")


@pytest.fixture
def ref_interpret(monkeypatch):
    """The reference engine's box joins with Pallas in interpret mode."""
    monkeypatch.setattr(
        ref_executor, "VectorizedBoxJoin",
        lambda *a, **kw: RefJoin(*a, **dict(kw, interpret=True)))


def _cases():
    """Every pattern on every backend; graph, workers, skew, use_kernels
    and the budget rotate so each value meets each pattern. The reference
    fused lane compiles one program per box shape, so its cases keep to a
    few boxes."""
    cases = []
    for j, pattern in enumerate(PATTERNS):
        for k, backend in enumerate(("auto", "host", "intersect", "fused")):
            graph = sorted(GRAPHS)[(j + k) % 3]
            workers = (1, 4)[(j + k) % 2]
            skew = ("uniform", "heavy_light")[(j // 2 + k) % 2]
            kernels = (True, False)[((j + 1) // 2 + k) % 2]
            mem = (None, 400)[j % 2] if backend == "fused" \
                else (150, 400)[(j + k) % 2]
            cases.append((pattern, graph, backend, workers, skew, kernels,
                          mem))
    # auto with kernels on every pattern: hub boxes to the fused lane
    for j, pattern in enumerate(PATTERNS):
        cases.append((pattern, sorted(GRAPHS)[(j + 1) % 3], "auto",
                      (4, 1)[j % 2], "heavy_light", True, 400))
    return cases


def _engines(pattern, graph, backend, workers, skew, kernels, mem):
    src, dst = GRAPHS[graph]()
    kw = dict(mem_words=mem, workers=workers, skew=skew)
    ref = RefEngine.from_graph(ref_patterns.PATTERNS[pattern](), src, dst,
                               backend=REF_BACKEND.get(backend, backend),
                               use_pallas_kernels=kernels, **kw)
    port = QueryEngine.from_graph(patterns.PATTERNS[pattern](), src, dst,
                                  backend=backend, use_kernels=kernels,
                                  torch_device="cpu", **kw)
    return ref, port


def _stats(stats):
    return {f: getattr(stats, f) for f in STAT_FIELDS}


def _plan(plan):
    return {f: getattr(plan, f) for f in PLAN_FIELDS}


def _assert_runs_equal(ref, port, capacity):
    assert _plan(port.plan()) == _plan(ref.plan())
    assert port.count() == ref.count()
    assert _stats(port.stats) == _stats(ref.stats)
    for cap in (None, capacity):
        want = ref.list(capacity=cap)
        got = port.list(capacity=cap)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), cap
        assert _stats(port.stats) == _stats(ref.stats), cap
    return port.stats


@pytest.mark.parametrize(
    "pattern,graph,backend,workers,skew,kernels,mem", _cases())
def test_query_engine_matches_reference(ref_interpret, pattern, graph,
                                        backend, workers, skew, kernels,
                                        mem):
    ref, port = _engines(pattern, graph, backend, workers, skew, kernels,
                         mem)
    stats = _assert_runs_equal(ref, port, capacity=16)
    if backend == "fused":
        assert port.stats.n_fused_boxes > 0
    if backend == "host" or (backend == "auto" and not kernels):
        assert stats.n_kernel_boxes == stats.n_fused_boxes == 0


def test_lanes_reach_their_kernel_wrappers(monkeypatch):
    """Which wrapper each lane reaches, counted on the port's own ledger:
    the intersect lane calls intersect_count_csr once per innermost
    two-atom step (the ledger notes one launch per 8,192 pairs, as the
    reference does, and no step here reaches 8,192 pairs), the fused lane
    one fused_count / fused_list per box."""
    calls = {"intersect": 0, "count": 0, "list": 0}
    real = (intersect_ops.intersect_count_csr, fused_ops.fused_count,
            fused_ops.fused_list)

    def counted(key, fn):
        def wrap(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(intersect_ops, "intersect_count_csr",
                        counted("intersect", real[0]))
    monkeypatch.setattr(fused_ops, "fused_count", counted("count", real[1]))
    monkeypatch.setattr(fused_ops, "fused_list", counted("list", real[2]))
    src, dst = GRAPHS["rmat"]()
    eng = QueryEngine.from_graph(patterns.triangle(), src, dst,
                                 mem_words=150, backend="intersect",
                                 torch_device="cpu")
    eng.count()
    assert calls["intersect"] == eng.stats.device_invocations > 0
    eng = QueryEngine.from_graph(patterns.diamond(), src, dst,
                                 mem_words=400, backend="fused",
                                 torch_device="cpu")
    eng.count()
    assert calls["count"] == eng.stats.n_fused_boxes > 0
    eng.list(capacity=4)
    assert calls["list"] >= eng.stats.n_fused_boxes + eng.stats.n_rescans


def test_no_launch_box_counts_as_fused(ref_interpret):
    """The reference failing case (seed 5704, rmat, four_clique, one
    worker): a box whose depth-0 or starts-only intersection is empty
    returns before any launch and still counts as fused, in the port as in
    the reference, so device_invocations < n_fused_boxes."""
    src, dst = r_graphs.rmat_graph(64, 500, seed=5704 % 997)
    ref = RefEngine.from_graph(ref_patterns.four_clique(), src, dst,
                               mem_words=300, backend="fused")
    port = QueryEngine.from_graph(patterns.four_clique(), src, dst,
                                  mem_words=300, backend="fused",
                                  torch_device="cpu")
    host = QueryEngine.from_graph(patterns.four_clique(), src, dst,
                                  mem_words=300, backend="host",
                                  torch_device="cpu")
    assert port.count() == ref.count() == host.count()
    assert _stats(port.stats) == _stats(ref.stats)
    assert port.stats.device_invocations < port.stats.n_fused_boxes
    rows = port.list()
    want = host.list()
    assert len(rows) == len(want)
    assert np.array_equal(np.unique(rows, axis=0), np.unique(want, axis=0))


@pytest.mark.parametrize("pattern", ["triangle", "diamond", "cycle4"])
def test_charged_block_device_ledger(ref_interpret, pattern):
    """Tuple relation sources and reversed indexes charge an attached
    BlockDevice: block and word reads equal the reference's, read for
    read, at workers 1 and 4."""
    src, dst = GRAPHS["rmat"]()
    a, b = orient_edges(src, dst)
    for workers in (1, 4):
        ref = RefEngine(ref_patterns.PATTERNS[pattern](),
                        relations={"E": (a, b)}, mem_words=200,
                        workers=workers, use_pallas_kernels=True,
                        device=RefDevice(block_words=16, cache_blocks=4))
        port = QueryEngine(patterns.PATTERNS[pattern](),
                           relations={"E": (a, b)}, mem_words=200,
                           workers=workers, torch_device="cpu",
                           device=BlockDevice(block_words=16,
                                              cache_blocks=4))
        stats = _assert_runs_equal(ref, port, capacity=8)
        assert stats.block_reads > 0 and stats.word_reads > 0


def test_engine_from_reference_state(ref_interpret):
    """query_engine_from_state runs a reference plan, box for box and lane
    for lane, even when the port is asked for other planning knobs."""
    src, dst = GRAPHS["rmat"]()
    ref = RefEngine.from_graph(ref_patterns.diamond(), src, dst,
                               mem_words=150, skew="heavy_light",
                               heavy_threshold=12, use_pallas_kernels=True)
    plan = ref.plan()
    e = ref._sources["E"]
    state = {"head": ref.query.head,
             "atoms": [(a.rel, a.vars) for a in ref.query.atoms],
             "relations": {"E": {"indptr": e.indptr, "indices": e.indices,
                                 "orientation": e.orientation}},
             "order": plan.order, "rank": plan.rank,
             "boxes": [list(map(list, box)) for box in plan.boxes],
             "lanes": list(plan.lanes), "skew": plan.skew,
             "budgets": dict(plan.budgets), "single_box": plan.single_box,
             "heavy_threshold": plan.heavy_threshold, "mem_words": 150}
    port = query_engine_from_state(state, torch_device="cpu",
                                   dim_ratio={"w": 9.0})
    assert port.plan().boxes == plan.boxes
    assert port.plan().lanes == plan.lanes
    assert port.plan().owned_dims == plan.owned_dims
    stats = _assert_runs_equal(ref, port, capacity=16)
    assert stats.n_hub_boxes > 0
    with pytest.raises(ValueError, match="mem_words"):
        query_engine_from_state(state, torch_device="cpu", mem_words=64)
    with pytest.raises(ValueError, match="lanes"):
        query_engine_from_state(dict(state, lanes=["hub"]),
                                torch_device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_count_rows_matches_reference(seed):
    """The innermost two-atom step: padded tiles built on the tensors'
    device from compact CSR, the reference's 8,192-pair chunks (one
    ledger note each), the int64 total."""
    rng = np.random.default_rng(seed)
    slices = []
    for _ in range(2):
        n = 300
        deg = rng.integers(0, 40, size=n)
        deg[::17] = 0
        ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        vals = np.concatenate([np.sort(rng.choice(200, size=k,
                                                  replace=False))
                               for k in deg]).astype(np.int32)
        slices.append(build_atom_slice(ip, vals, 0))
    sa, sb = slices
    pos_a = rng.integers(0, sa.n_keys, size=20_000)
    pos_b = rng.integers(0, sb.n_keys, size=20_000)
    want = ref_intersect_rows(sa.off, sa.vals, pos_a, sb.off, sb.vals,
                              pos_b, use_pallas=False)
    _, off_a, vals_a = sa.on(torch.device("cpu"))
    _, off_b, vals_b = sb.on(torch.device("cpu"))
    with ledger.attach() as kl:
        got = intersect_ops.intersect_count_rows(
            off_a, vals_a, torch.from_numpy(pos_a), off_b, vals_b,
            torch.from_numpy(pos_b))
    assert got == want > 0
    assert kl.invocations == 3                  # ceil(20,000 / 8,192)
    assert intersect_ops.intersect_count_rows(
        off_a, vals_a, torch.zeros(0, dtype=torch.int64), off_b, vals_b,
        torch.zeros(0, dtype=torch.int64)) == 0


def test_options_not_ported_and_devices():
    """Unported options raise NotImplementedError; the default device is
    the card and raises without CUDA; the reference's 'pallas' backend is
    called 'intersect'."""
    src, dst = GRAPHS["er"]()
    q = patterns.triangle()
    for kw in ({"tracer": object()}, {"metrics": object()}):
        with pytest.raises(NotImplementedError, match="not ported"):
            QueryEngine.from_graph(q, src, dst, torch_device="cpu", **kw)
    with pytest.raises(ValueError, match="backend"):
        QueryEngine.from_graph(q, src, dst, backend="pallas",
                               torch_device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            QueryEngine.from_graph(q, src, dst)
    assert query_count(q, src, dst, torch_device="cpu") == \
        RefEngine.from_graph(ref_patterns.triangle(), src, dst).count()


def test_box_join_defaults_to_the_card():
    """VectorizedBoxJoin, which repro_torch.query exports, runs on the card
    unless the caller asks for the CPU, as the engines do: its default
    device is "cuda", which raises without CUDA; "cpu" is taken as asked
    and other devices raise ValueError."""
    join = VectorizedBoxJoin([], 2, torch_device="cpu")
    assert join.torch_device == torch.device("cpu")
    if torch.cuda.is_available():
        assert VectorizedBoxJoin([], 2).torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VectorizedBoxJoin([], 2)
    with pytest.raises(ValueError, match="only 'cuda' and 'cpu'"):
        VectorizedBoxJoin([], 2, torch_device="meta")
