"""The port's distributed box fabric (``repro_torch.parallel.fabric``)
against the reference's (``repro.parallel.fabric``), on the CPU.

The matrix of ``tests/test_fabric.py``, held to the reference ``Fabric``
on the same inputs, exactly (tolerance 0): counts and listings of the
triangle, four-clique, diamond and path3 patterns at 1, 2, 4 and 8
shards; the global plan and each shard's sub-plan; per-shard ledgers,
byte-identical to the shard's ``oracle_engine`` and to the reference
shard's, in memory and from a store, with a slice cache, at 1 and 4
workers and under the skew planner; ``ShippedEdgeSource`` refusing reads
outside its ranges; the mesh reduction (a list of CPU devices, repeated)
equal to the host sum; ``partial`` / ``merge_partials`` in both modes;
the two-process worker CLI with ``--torch-device cpu``; and the argument
checks. The port's engines run on the CPU (``torch_device="cpu"``), where
the kernel wrappers run their plain versions.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data.edgestore import write_edge_store
from repro.data.graphs import random_graph, rmat_graph
from repro.parallel.fabric import Fabric as RefFabric
from repro.query.executor import QueryEngine as RefQuery
from repro.query.patterns import PATTERNS as REF_PATTERNS
from repro_torch import Fabric as TopFabric
from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
from repro_torch.data.edgestore import EdgeStore, InMemoryEdgeSource
from repro_torch.launch.mesh import fabric_mesh
from repro_torch.parallel.fabric import (Fabric, FabricShippingError,
                                         ShippedEdgeSource)
from repro_torch.query.patterns import PATTERNS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PATTERN_NAMES = ("triangle", "four_clique", "diamond", "path3")
MESH_SHAPES = (1, 2, 4, 8)
SMALL = random_graph(96, 400, seed=7)
GRAPH = rmat_graph(128, 600, seed=3)

_ORACLE = {}


def oracle(name, mode="count"):
    """The reference single-host QueryEngine on SMALL (cached)."""
    key = (name, mode)
    if key not in _ORACLE:
        eng = RefQuery.from_graph(REF_PATTERNS[name](), *SMALL,
                                  mem_words=1 << 12)
        _ORACLE[key] = eng.count() if mode == "count" else eng.list()
    return _ORACLE[key]


def both(name, shards, graph=SMALL, store=None, **kw):
    """(reference Fabric, port Fabric) on the same inputs."""
    kw.setdefault("mem_words", 1 << 12)
    if store is not None:
        return (RefFabric(REF_PATTERNS[name](), store=store,
                          n_shards=shards, **kw),
                Fabric(PATTERNS[name](), store=store, n_shards=shards,
                       torch_device="cpu", **kw))
    return (RefFabric.from_graph(REF_PATTERNS[name](), *graph,
                                 n_shards=shards, **kw),
            Fabric.from_graph(PATTERNS[name](), *graph, n_shards=shards,
                              torch_device="cpu", **kw))


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fabric") / "g.csr")
    write_edge_store(path, *GRAPH, orientation="minmax", chunk_rows=32)
    return path


# ---------------------------------------------------------------------------
# acceptance matrix: the port's fabric == the reference's == single host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", MESH_SHAPES)
@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_count_equals_reference(pattern, shards):
    ref, port = both(pattern, shards)
    got = port.count()
    assert got == ref.count() == oracle(pattern)
    assert port.layout().schedule == ref.layout().schedule
    assert port.layout().costs == ref.layout().costs
    assert port.layout().shipped == ref.layout().shipped
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.stats.n_shards == shards
    flat = sorted(b for ids in port.layout().schedule for b in ids)
    assert flat == list(range(len(port.layout().plan.boxes)))


@pytest.mark.parametrize("shards", (1, 4, 8))
@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_listing_equals_reference(pattern, shards):
    ref, port = both(pattern, shards)
    got, want = port.list(), ref.list()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got, oracle(pattern, "list"))


@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_plan_and_sub_plans_equal_reference(pattern):
    ref, port = both(pattern, 4)
    rp, pp = ref.layout().plan, port.layout().plan
    assert (pp.order, pp.rank, pp.boxes, pp.lanes) == \
        (rp.order, rp.rank, rp.boxes, rp.lanes)
    assert port.describe() == ref.describe()
    for s in range(4):
        assert port.shard_engine(s).plan().boxes == \
            ref.shard_engine(s).plan().boxes == \
            [pp.boxes[i] for i in port.layout().schedule[s]]


# ---------------------------------------------------------------------------
# per-shard ledgers: shard == its oracle engine == the reference's shard
# ---------------------------------------------------------------------------

LEDGER_FIELDS = ("block_reads", "block_writes", "word_reads", "cache_hits",
                 "cache_misses", "cache_hit_words", "slice_words_read",
                 "n_results")
CONFIGS = {
    "mem": dict(store=False, cache_words=0, workers=1, skew="uniform"),
    "store": dict(store=True, cache_words=0, workers=1, skew="uniform"),
    "store_cache": dict(store=True, cache_words=1 << 10, workers=1,
                        skew="uniform"),
    "store_workers": dict(store=True, cache_words=0, workers=4,
                          skew="uniform"),
    "store_skew": dict(store=True, cache_words=0, workers=1,
                       skew="heavy_light"),
}


def _same_results(got, want, mode):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif mode == "count":
            assert int(g) == int(w)
        else:
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("pattern", ["triangle", "diamond"])
def test_shard_ledgers_equal_oracle_and_reference(pattern, cfg, store_path):
    c = CONFIGS[cfg]
    kw = dict(mem_words=1 << 11, cache_words=c["cache_words"],
              io_block_words=64, workers=c["workers"], skew=c["skew"])
    mode = "list" if cfg == "store" else "count"
    for shards in (2, 4):
        ref, port = both(pattern, shards, graph=GRAPH,
                         store=store_path if c["store"] else None, **kw)
        for s in range(shards):
            rep, r_rep = port.run_local(s, mode), ref.run_local(s, mode)
            for workers in (1, 4):
                orc = port.oracle_engine(s, workers=workers)
                want = orc.run_boxes(mode)
                _same_results(rep.results, want, mode)
                for f in LEDGER_FIELDS:
                    assert getattr(rep.stats, f) == getattr(orc.stats, f), \
                        (cfg, pattern, shards, s, workers, f)
                assert rep.io.block_reads == orc.device.stats.block_reads
                assert rep.io.word_reads == orc.device.stats.word_reads
            _same_results(rep.results, r_rep.results, mode)
            for f in LEDGER_FIELDS:
                assert getattr(rep.stats, f) == getattr(r_rep.stats, f), \
                    (cfg, pattern, shards, s, f)
            assert rep.shipped_words == r_rep.shipped_words


def test_summed_shard_reads_equal_solo_sum():
    """The fabric's aggregate block reads are exactly the sum of the
    per-shard solo runs — distribution adds no hidden I/O."""
    fab = Fabric.from_graph(PATTERNS["triangle"](), *GRAPH, n_shards=4,
                            mem_words=1 << 11, io_block_words=64,
                            torch_device="cpu")
    fab.count()
    solo = 0
    for s in range(4):
        orc = fab.oracle_engine(s)
        orc.run_boxes("count")
        solo += orc.stats.block_reads
    assert fab.stats.sum_block_reads == solo > 0


# ---------------------------------------------------------------------------
# shipping safety
# ---------------------------------------------------------------------------

def _base():
    src, dst = random_graph(64, 200, seed=1)
    a, b = orient_edges(src, dst)
    nv = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
    ip, ix = csr_from_edges(a, b, n_nodes=nv)
    return InMemoryEdgeSource(ip, ix)


def test_shipped_reads_match_base():
    base = _base()
    s = ShippedEdgeSource(base, [(0, 9)])
    ip_got, vals_got = s.read_rows(0, 9)
    ip_want, vals_want = base.read_rows(0, 9)
    np.testing.assert_array_equal(ip_got, ip_want)
    np.testing.assert_array_equal(vals_got, vals_want)
    assert s.shipped_words == len(vals_want)


def test_reads_outside_shipped_ranges_raise():
    base = _base()
    s = ShippedEdgeSource(base, [(0, 5)])
    with pytest.raises(FabricShippingError):
        s.read_rows(3, 10)
    s = ShippedEdgeSource(base, [(0, 3), (8, 9)])
    with pytest.raises(FabricShippingError):
        s.read_rows(2, 9)
    # both covered ends still serve
    np.testing.assert_array_equal(s.read_rows(8, 9)[1],
                                  base.read_rows(8, 9)[1])


def test_shipped_store_rows_keep_their_block_addresses(store_path):
    """Over a store, the shipped source charges the block reads the store
    itself would, chunk padding included."""
    from repro_torch.core.iomodel import BlockDevice
    store = EdgeStore(store_path)
    dev_s, dev_o = BlockDevice(64, 4), BlockDevice(64, 4)
    shipped = ShippedEdgeSource(store, [(0, store.n_nodes - 1)],
                                device=dev_s)
    origin = EdgeStore(store_path, device=dev_o)
    for lo, hi in ((0, 40), (33, 90), (64, 127)):
        got, want = shipped.read_rows(lo, hi), origin.read_rows(lo, hi)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert dev_s.stats.block_reads == dev_o.stats.block_reads > 0
    assert dev_s.stats.word_reads == dev_o.stats.word_reads


# ---------------------------------------------------------------------------
# mesh reduction
# ---------------------------------------------------------------------------

def test_mesh_reduce_equals_host_sum():
    mesh = fabric_mesh(4, devices=["cpu"] * 4)
    fab = Fabric.from_graph(PATTERNS["triangle"](), *SMALL,
                            mem_words=1 << 12, mesh=mesh,
                            torch_device="cpu")
    assert fab.n_shards == 4
    assert all(fab.shard_torch_device(s) == torch.device("cpu")
               for s in range(4))
    assert fab.count(reduce="mesh") == oracle("triangle")
    # auto picks the mesh when one is attached
    assert fab.count() == fab.count(reduce="host") == oracle("triangle")
    # without a mesh, "mesh" needs one device per shard
    fab = Fabric.from_graph(PATTERNS["triangle"](), *SMALL, n_shards=2,
                            mem_words=1 << 12, torch_device="cpu")
    with pytest.raises(ValueError, match="only 1 device"):
        fab.count(reduce="mesh")


def test_mesh_reduce_rejects_partial_process():
    _, fab = both("triangle", 2, process_index=0, n_processes=2)
    with pytest.raises(ValueError, match="n_processes"):
        fab.count(reduce="mesh")


# ---------------------------------------------------------------------------
# multi-process protocol
# ---------------------------------------------------------------------------

def test_worker_cli_two_processes_merge(tmp_path):
    """Two worker processes at once, each running its ``shard % 2 ==
    process_index`` slice of a 5-shard fabric on the CPU; the merged
    count equals the reference's single host."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep \
        + env.get("PYTHONPATH", "")
    procs, outs = [], []
    for p in range(2):
        out = tmp_path / f"part{p}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.parallel.fabric",
             "--pattern", "triangle", "--nv", "96", "--ne", "400",
             "--seed", "7", "--shards", "5", "--mem-words", "4096",
             "--process-index", str(p), "--n-processes", "2",
             "--torch-device", "cpu", "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-2000:]
            assert "FABRIC-PARTIAL-OK" in stdout
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    parts = [json.loads(out.read_text()) for out in outs]
    assert [len(p["shards"]) for p in parts] == [3, 2]
    assert not any(p["distributed"] for p in parts)
    assert Fabric.merge_partials(parts) == oracle("triangle")
    with pytest.raises(ValueError, match="missing shard"):
        Fabric.merge_partials(parts[:1])


@pytest.mark.parametrize("mode", ["count", "list"])
def test_partial_merge_equals_reference(mode):
    """partial()/merge_partials round-trip through JSON, byte-identical to
    the reference's payloads and merge."""
    got, want = [], []
    for p in range(2):
        ref, port = both("diamond", 4, process_index=p, n_processes=2)
        got.append(json.loads(json.dumps(port.partial(mode))))
        want.append(json.loads(json.dumps(ref.partial(mode))))
    assert got == want
    merged = Fabric.merge_partials(got)
    if mode == "count":
        assert merged == RefFabric.merge_partials(want) == oracle("diamond")
    else:
        assert merged.tobytes() == RefFabric.merge_partials(want).tobytes()
        np.testing.assert_array_equal(merged, oracle("diamond", "list"))


def test_argument_checks():
    with pytest.raises(ValueError, match="process_index"):
        both("triangle", 4, process_index=3, n_processes=2)
    _, fab = both("triangle", 2)
    with pytest.raises(ValueError, match="reduce"):
        fab.count(reduce="bogus")
    with pytest.raises(ValueError, match="no partials"):
        Fabric.merge_partials([])
    a = {"mode": "count", "n_shards": 1, "shards": []}
    b = {"mode": "list", "n_shards": 1, "shards": []}
    with pytest.raises(ValueError, match="disagree"):
        Fabric.merge_partials([a, b])
    with pytest.raises(ValueError, match="single-relation"):
        from repro_torch.core.leapfrog import Atom
        from repro_torch.core.queries import Query
        q = Query(head=("x", "y", "z"),
                  atoms=[Atom("E", ("x", "y")), Atom("F", ("y", "z"))])
        Fabric.from_graph(q, *SMALL, torch_device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        Fabric.from_graph(PATTERNS["triangle"](), *SMALL, mesh=[],
                          torch_device="cpu")
    assert TopFabric is Fabric
    if not torch.cuda.is_available():
        # the default device is the card, which this host does not have
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Fabric.from_graph(PATTERNS["triangle"](), *SMALL, n_shards=2)


# ---------------------------------------------------------------------------
# serving layer integration (admission-gated fabric runs)
# ---------------------------------------------------------------------------

class TestServeFabric:
    def test_fabric_run_equals_reference(self, thread_guard):
        """``Server.fabric_run`` and ``Session.fabric_count`` /
        ``fabric_list`` over the port's ``Fabric``: the reference server's
        results, shard stats and shipping-read ledger, and the admission
        reservation returned afterwards."""
        from repro.serve import Server as RefServer
        from repro.serve import Session as RefSession
        from repro_torch.serve import Server, Session

        ref = RefServer.from_graph(*SMALL, mem_words=1 << 15,
                                   use_pallas_kernels=False)
        srv = Server.from_graph(*SMALL, mem_words=1 << 15,
                                torch_device="cpu")
        try:
            want = srv.submit("triangle").result(timeout=300)
            assert want == ref.submit("triangle").result(timeout=300)
            for mode in ("count", "list"):
                for shards in (1, 4):
                    got, stats = srv.fabric_run("triangle", mode,
                                                n_shards=shards)
                    r_got, r_stats = ref.fabric_run("triangle", mode,
                                                    n_shards=shards)
                    if mode == "count":
                        assert got == r_got == want == oracle("triangle")
                    else:
                        assert got.tobytes() == r_got.tobytes()
                        np.testing.assert_array_equal(
                            got, oracle("triangle", "list"))
                    assert stats.n_shards == shards
                    assert dataclasses.asdict(stats) == \
                        dataclasses.asdict(r_stats)
            assert srv.device.stats.block_reads == \
                ref.device.stats.block_reads
            assert srv.admission.reserved_words == 0
            assert srv.admission.active == 0
            with Session(srv) as ses, RefSession(ref) as rses:
                assert ses.fabric_count("triangle", n_shards=2) == want
                rows = ses.fabric_list("diamond", n_shards=2)
                assert rows.tobytes() == \
                    rses.fabric_list("diamond", n_shards=2).tobytes()
                # the server's order keeps every atom consistent, so
                # its rows come in another order than the oracle's
                want_rows = oracle("diamond", "list")
                np.testing.assert_array_equal(
                    rows[np.lexsort(rows.T[::-1])],
                    want_rows[np.lexsort(want_rows.T[::-1])])
        finally:
            srv.close()
            ref.close()

    def test_fabric_run_over_a_store_equals_reference(self, store_path,
                                                      thread_guard):
        """A store-backed server: the fabric's per-shard ledgers equal
        each shard's oracle engine's and the reference's."""
        from repro.serve import Server as RefServer
        from repro_torch.serve import Server

        kw = dict(mem_words=1 << 13, cache_words=1 << 12)
        with RefServer({"E": store_path}, use_pallas_kernels=False,
                       **kw) as ref, \
                Server({"E": store_path}, torch_device="cpu", **kw) as srv:
            got, stats = srv.fabric_run("diamond", n_shards=4,
                                        want_words=1 << 12)
            want, r_stats = ref.fabric_run("diamond", n_shards=4,
                                           want_words=1 << 12)
            assert got == want
            assert dataclasses.asdict(stats) == dataclasses.asdict(r_stats)
            assert srv.admission.reserved_words == 0

    def test_fabric_run_rejects_as_submit_does(self):
        from repro_torch.serve import Server
        with Server.from_graph(*SMALL, mem_words=1 << 14,
                               torch_device="cpu") as srv:
            with pytest.raises(ValueError, match="mode"):
                srv.fabric_run("triangle", "sum")
            with pytest.raises(ValueError, match="unknown pattern"):
                srv.fabric_run("pentagon")
        with pytest.raises(Exception, match="closed"):
            srv.fabric_run("triangle")
