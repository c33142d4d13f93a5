"""repro_torch's numpy host modules against the reference on the CPU: the
box planners, the TrieArray prober, the block-I/O model, the graph
generators, the in-memory edge source, the prefetch pipeline and the box
queue order. Same inputs in, identical outputs and I/O ledgers out."""

import numpy as np
import pytest

from repro.core import boxing as r_boxing
from repro.core import iomodel as r_io
from repro.core import triearray as r_trie
from repro.core.lftj_jax import orient_edges
from repro.data import edgestore as r_store
from repro.data import graphs as r_graphs
from repro.data import pipeline as r_pipe
from repro.parallel import sharding as r_shard
from repro_torch.core import boxing as p_boxing
from repro_torch.core import iomodel as p_io
from repro_torch.core import triearray as p_trie
from repro_torch.data import edgestore as p_store
from repro_torch.data import graphs as p_graphs
from repro_torch.data import pipeline as p_pipe
from repro_torch.parallel import sharding as p_shard


def er_graph(graphs, seed):
    return graphs.random_graph(120, 900, seed=seed)


def rmat(graphs, seed):
    return graphs.rmat_graph(256, 3000, seed=seed)


def clustered(graphs, seed):
    return graphs.clustered_graph(4, 32, seed=seed, p_in=0.5)


GRAPHS = {"er": er_graph, "rmat": rmat, "clustered": clustered}


def oriented(name, mode="minmax"):
    return orient_edges(*GRAPHS[name](r_graphs, 1), mode)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_same_edges_for_same_seed(name, seed):
    r_src, r_dst = GRAPHS[name](r_graphs, seed)
    p_src, p_dst = GRAPHS[name](p_graphs, seed)
    np.testing.assert_array_equal(r_src, p_src)
    np.testing.assert_array_equal(r_dst, p_dst)
    s = np.array([3, 1, 1, 2, 5])
    d = np.array([1, 3, 1, 0, 2])
    for r, p in zip(r_graphs.simplify_edges(s, d),
                    p_graphs.simplify_edges(s, d)):
        np.testing.assert_array_equal(r, p)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["minmax", "degree"])
@pytest.mark.parametrize("mem_words", [150, 600, 5000])
def test_plans_identical(name, mode, mem_words):
    a, b = oriented(name, mode)
    prune = mode == "minmax"
    r_ta = r_trie.TrieArray.from_edges(a, b)
    p_ta = p_trie.TrieArray.from_edges(a, b)
    assert r_boxing.plan_boxes(r_ta, mem_words, monotone_prune=prune) \
        == p_boxing.plan_boxes(p_ta, mem_words, monotone_prune=prune)
    from repro.core.lftj_jax import csr_from_edges
    indptr, _ = csr_from_edges(a, b)
    assert r_boxing.plan_boxes_from_degrees(indptr, mem_words, monotone_prune=prune) \
        == p_boxing.plan_boxes_from_degrees(indptr, mem_words,
                                            monotone_prune=prune)
    r_sp = r_boxing.plan_boxes_heavy_light(indptr, mem_words,
                                           monotone_prune=prune)
    p_sp = p_boxing.plan_boxes_heavy_light(indptr, mem_words,
                                           monotone_prune=prune)
    assert (r_sp.boxes, r_sp.lanes, r_sp.threshold, r_sp.n_heavy) \
        == (p_sp.boxes, p_sp.lanes, p_sp.threshold, p_sp.n_heavy)
    deg = np.diff(indptr)
    cost = np.where(deg > 0, deg + 2, 0)
    heavy, _ = r_boxing.classify_heavy(indptr)
    assert r_boxing.class_cuts(cost, mem_words // 5, heavy) \
        == p_boxing.class_cuts(cost, mem_words // 5, heavy)


@pytest.mark.parametrize("name", ["rmat", "clustered"])
def test_triearray_probes_and_io_stats_agree(name):
    a, b = oriented(name)
    r_ta = r_trie.TrieArray.from_edges(a, b)
    p_ta = p_trie.TrieArray.from_edges(a, b)
    for r, p in zip(r_ta.val + r_ta.idx, p_ta.val + p_ta.idx):
        np.testing.assert_array_equal(r, p)
    r_dev = r_io.BlockDevice(block_words=64, cache_blocks=8)
    p_dev = p_io.BlockDevice(block_words=64, cache_blocks=8)
    r_dev.register_triearray(r_ta)
    p_dev.register_triearray(p_ta)
    r_rd, p_rd = r_io.CountingReader(r_dev), p_io.CountingReader(p_dev)
    lows = [-1, 0, 5, int(a.max()) // 2, int(a.max())]
    for low in lows:
        for budget in (3, 40, 500):
            assert r_ta.probe((), low, budget, reader=r_rd) \
                == p_ta.probe((), low, budget, reader=p_rd)
        for s in ((), (int(a[0]),)):
            assert r_ta.slice_words(s, low, low + 9, reader=r_rd) \
                == p_ta.slice_words(s, low, low + 9, reader=p_rd)
    assert vars(r_dev.stats) == vars(p_dev.stats)


@pytest.mark.parametrize("mem_words", [200, 1000])
def test_boxed_lftj_count_and_ledger_agree(mem_words):
    a, b = oriented("rmat")
    results = []
    for boxing, trie, io in ((r_boxing, r_trie, r_io),
                             (p_boxing, p_trie, p_io)):
        dev = io.BlockDevice(block_words=128, cache_blocks=4)
        count, stats = boxing.boxed_triangle_count(
            trie.TrieArray.from_edges(a, b), mem_words, device=dev)
        results.append((count, vars(stats), vars(dev.stats)))
    assert results[0] == results[1]


def test_in_memory_source_reads_and_charges_identically():
    from repro.core.lftj_jax import csr_from_edges
    indptr, indices = csr_from_edges(*oriented("er"))
    r_dev = r_io.BlockDevice(block_words=32, cache_blocks=4)
    p_dev = p_io.BlockDevice(block_words=32, cache_blocks=4)
    r_src = r_store.InMemoryEdgeSource(indptr, indices, device=r_dev)
    p_src = p_store.InMemoryEdgeSource(indptr, indices, device=p_dev)
    assert (r_src.n_nodes, r_src.n_edges, r_src.words()) \
        == (p_src.n_nodes, p_src.n_edges, p_src.words())
    np.testing.assert_array_equal(r_src.degrees, p_src.degrees)
    for lo, hi in ((0, 10), (5, 5), (40, 200), (30, 20), (-3, 2)):
        for r, p in zip(r_src.read_rows(lo, hi), p_src.read_rows(lo, hi)):
            np.testing.assert_array_equal(r, p)
    r_dev.write_words(1000)
    p_dev.write_words(1000)
    assert vars(r_dev.stats) == vars(p_dev.stats)


def test_pipeline_and_queue_order_agree():
    src = np.arange(10)
    dst = np.arange(10) + 1
    r_b = list(r_pipe.edge_batches(src, dst, batch_edges=3))
    p_b = list(p_pipe.edge_batches(src, dst, batch_edges=3))
    assert len(r_b) == len(p_b) == 4
    for (rs, rd), (ps, pd) in zip(r_b, p_b):
        np.testing.assert_array_equal(rs, ps)
        np.testing.assert_array_equal(rd, pd)
    pf = p_pipe.Prefetcher(iter(range(20)), depth=2)
    assert list(pf) == list(range(20))
    pf.close()
    costs = [5, 1, 5, 9, 0, 3]
    assert r_shard.lpt_order(costs) == p_shard.lpt_order(costs)
    for ledger in (False, True):
        assert r_shard.box_queue_order(costs, ledger) \
            == p_shard.box_queue_order(costs, ledger)


def test_prefetcher_propagates_errors_and_closes_early():
    def boom():
        yield 1
        raise KeyError("producer failed")

    pf = p_pipe.Prefetcher(boom(), depth=1)
    assert next(pf) == 1
    with pytest.raises(KeyError):
        next(pf)
    pf = p_pipe.Prefetcher(iter(range(10 ** 6)), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf.thread.is_alive()
