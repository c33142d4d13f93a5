"""repro_torch's on-disk edge store, slice cache and binned row count
against the reference's, on the CPU.

The port keeps its own copy of the reference's store
(``docs/EDGESTORE_FORMAT.md``). Inputs are fixed-seed graphs and windows
made with numpy; every comparison is exact (tolerance 0): the port opens
the reference's files row for row, both packages' writers give the same
bytes (the streaming writer spilling at least three runs), both readers
refuse the same broken files, reads charge the same block I/Os, the
``SliceCache`` ledger equals the reference's after every request, and
``_count_rows_chunked`` gives the reference's totals.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import SliceCache as RefCache
from repro.core.iomodel import BlockDevice as RefDevice
from repro.core.lftj_jax import SENTINEL
from repro.core.lftj_jax import _count_rows_chunked as ref_count_rows
from repro.data import edgestore as r_store
from repro.data.graphs import random_graph, rmat_graph
from repro.data.pipeline import edge_batches as ref_edge_batches
from repro_torch import (EdgeStore, EdgeStoreWriter, SliceCache,
                         write_edge_store, write_edge_store_csr,
                         write_edge_store_streaming)
from repro_torch.core.iomodel import BlockDevice
from repro_torch.core.lftj_torch import (_count_rows_chunked, csr_from_edges,
                                         orient_edges)
from repro_torch.data.pipeline import edge_batches


def er_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, k=1))
    return src.astype(np.int64), dst.astype(np.int64)


def noisy(src, dst):
    """The edges with reversals, duplicates and self-loops added: both
    writers must drop them identically."""
    return (np.concatenate([src, dst, src[:50], np.arange(20)]),
            np.concatenate([dst, src, dst[:50], np.arange(20)]))


GRAPHS = {
    "er": lambda: er_graph(96, 0.3, seed=11),
    "rmat": lambda: rmat_graph(512, 6000, seed=11),
    "rand": lambda: random_graph(300, 4000, seed=11),
    "empty": lambda: (np.zeros(0, np.int64), np.zeros(0, np.int64)),
}
LAYOUTS = [(19, 16), (64, 32), (4096, 1024)]     # (chunk_rows, align_words)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("chunk_rows,align_words", LAYOUTS)
@pytest.mark.parametrize("orientation", ["minmax", "degree"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_port_reads_reference_stores(tmp_path, graph, orientation,
                                     chunk_rows, align_words):
    """A store the reference writes opens in the port with the same header
    fields and the same rows, for the whole graph and for random
    windows."""
    src, dst = GRAPHS[graph]()
    path = r_store.write_edge_store(tmp_path / "g.csr", src, dst,
                                    orientation=orientation,
                                    chunk_rows=chunk_rows,
                                    align_words=align_words)
    ref, port = r_store.EdgeStore(path), EdgeStore(path)
    for f in ("n_nodes", "n_edges", "chunk_rows", "n_chunks",
              "align_words", "k_max", "orientation"):
        assert getattr(port, f) == getattr(ref, f), f
    np.testing.assert_array_equal(port.indptr, ref.indptr)
    assert port.words() == ref.words()
    rng = np.random.default_rng(0)
    nv = max(1, port.n_nodes)
    windows = [(0, port.n_nodes - 1), (-3, 2), (nv - 2, nv + 5), (5, 4)]
    windows += [tuple(sorted(rng.integers(0, nv, 2))) for _ in range(25)]
    for lo, hi in windows:
        ip_p, v_p = port.read_rows(lo, hi)
        ip_r, v_r = ref.read_rows(lo, hi)
        assert ip_p.dtype == ip_r.dtype and v_p.dtype == v_r.dtype
        np.testing.assert_array_equal(ip_p, ip_r)
        np.testing.assert_array_equal(v_p, v_r)


@pytest.mark.parametrize("orientation", ["minmax", "degree"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_writers_give_the_reference_bytes(tmp_path, graph, orientation):
    """``write_edge_store``, ``write_edge_store_csr`` and the streaming
    writer (at a budget that spills at least three runs) write the
    reference's bytes; the reference opens the port's file."""
    src, dst = noisy(*GRAPHS[graph]())
    kw = dict(orientation=orientation, chunk_rows=19, align_words=16)
    want = _bytes(r_store.write_edge_store(tmp_path / "ref.csr", src, dst,
                                           **kw))
    assert _bytes(write_edge_store(tmp_path / "mem.csr", src, dst,
                                   **kw)) == want
    a, b = orient_edges(src, dst, orientation)
    nv = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
    ip, ix = csr_from_edges(a, b, n_nodes=nv) if nv else \
        (np.zeros(1, np.int64), np.zeros(0, np.int32))
    assert _bytes(write_edge_store_csr(tmp_path / "csr.csr", ip, ix,
                                       **kw)) == want
    budget = 1024          # the writer's floor: 341 edges a run
    ref_stream = r_store.write_edge_store_streaming(
        tmp_path / "ref_stream.csr",
        ref_edge_batches(src, dst, batch_edges=501), budget_words=budget,
        **kw)
    assert _bytes(ref_stream) == want
    w = EdgeStoreWriter(tmp_path / "stream.csr", budget_words=budget, **kw)
    with w:
        for s, d in edge_batches(src, dst, batch_edges=501):
            w.add_edges(s, d)
    assert _bytes(w.path) == want
    if len(a):
        assert w.n_spill_runs >= 3, w.n_spill_runs
    assert _bytes(write_edge_store_streaming(
        tmp_path / "stream2.csr", edge_batches(src, dst, batch_edges=97),
        budget_words=budget, **kw)) == want
    # spill runs and the temporary store are gone
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["ref.csr", "mem.csr", "csr.csr", "ref_stream.csr", "stream.csr",
         "stream2.csr"])
    ref = r_store.EdgeStore(tmp_path / "stream.csr")
    np.testing.assert_array_equal(ref.read_rows(0, nv)[1],
                                  EdgeStore(w.path).read_rows(0, nv)[1])


def _break(path, how):
    size = os.path.getsize(path)
    if how == "truncated_header":
        with open(path, "wb") as f:
            f.write(b"RPRCSR01")              # magic only
        return
    with open(path, "r+b") as f:
        if how == "bad_magic":
            f.write(b"NOTASTOR")
        elif how == "version":
            f.seek(8)                         # version field (after magic)
            f.write((99).to_bytes(4, "little"))
        elif how == "corrupt_header":
            f.seek(16)                        # n_nodes field
            f.write((-5).to_bytes(8, "little", signed=True))
        elif how == "chunk_count":
            f.seek(40)                        # n_chunks field
            f.write((12345).to_bytes(8, "little"))
        elif how == "truncated_indices":
            f.truncate(size - 64)


@pytest.mark.parametrize("how,match", [
    ("bad_magic", "bad magic"), ("version", "version 99"),
    ("truncated_header", "truncated header"),
    ("truncated_indices", "truncated indices"),
    ("corrupt_header", "corrupt header"),
    ("chunk_count", "corrupt header")])
def test_reader_refuses_broken_stores_as_the_reference(tmp_path, how, match):
    src, dst = er_graph(32, 0.3, seed=0)
    path = write_edge_store(tmp_path / "g.csr", src, dst)
    _break(path, how)
    with pytest.raises(ValueError, match=match) as port_err:
        EdgeStore(path)
    with pytest.raises(ValueError, match=match) as ref_err:
        r_store.EdgeStore(path)
    assert str(port_err.value) == str(ref_err.value)


def test_writer_rejects_what_the_reference_rejects(tmp_path):
    for cls in (EdgeStoreWriter, r_store.EdgeStoreWriter):
        with pytest.raises(ValueError, match="orientation"):
            cls(tmp_path / "x.csr", orientation="raw")
        w = cls(tmp_path / "x.csr")
        with pytest.raises(ValueError, match="differ in length"):
            w.add_edges(np.arange(3), np.arange(2))
        with pytest.raises(ValueError, match="vertex ids"):
            w.add_edges(np.array([-1]), np.array([2]))
        w.finalize()
        with pytest.raises(RuntimeError, match="finalized"):
            w.add_edges(np.array([0]), np.array([1]))


@pytest.mark.parametrize("block_words,cache_blocks", [(16, 4), (64, 2)])
def test_reads_charge_the_reference_block_ios(tmp_path, block_words,
                                              cache_blocks):
    src, dst = rmat_graph(512, 6000, seed=5)
    path = write_edge_store(tmp_path / "g.csr", src, dst, chunk_rows=64,
                            align_words=32)
    port = EdgeStore(path, device=BlockDevice(block_words=block_words,
                                              cache_blocks=cache_blocks))
    ref = r_store.EdgeStore(path, device=RefDevice(
        block_words=block_words, cache_blocks=cache_blocks))
    rng = np.random.default_rng(1)
    for lo, hi in [tuple(sorted(rng.integers(0, 512, 2)))
                   for _ in range(40)]:
        port.read_rows(lo, hi)
        ref.read_rows(lo, hi)
        assert port.device.stats.block_reads == ref.device.stats.block_reads
        assert port.device.stats.word_reads == ref.device.stats.word_reads


def _cache_state(cache):
    return (cache.hits, cache.misses, cache.hit_words, cache.miss_words,
            cache.passthrough_words, cache._words, list(cache._blocks),
            cache.block_rows, cache.device.stats.block_reads,
            cache.device.stats.word_reads,
            cache.device.stats.cache_served_words)


@pytest.mark.parametrize("block_rows,budget,seed", [
    (None, 1024, 0), (None, 1 << 16, 1), (5, 512, 2), (2, 128, 3),
    (16, 2048, 4), (3, 40, 5)])
def test_slice_cache_trace_equals_the_reference(tmp_path, block_rows, budget,
                                                seed):
    """After every request of fixed-seed windows (wide, narrow, repeated,
    out of range), the port's cache holds the reference's ledger: hits,
    misses, words served, missed and passed through, resident words, the
    LRU order of its blocks and the device's block I/Os; the rows equal
    the uncached store's."""
    src, dst = rmat_graph(512, 6000, seed=21)
    path = write_edge_store(tmp_path / "g.csr", src, dst, chunk_rows=64,
                            align_words=32)
    port = SliceCache(EdgeStore(path, device=BlockDevice(
        block_words=32, cache_blocks=4)), budget, block_rows=block_rows)
    ref = RefCache(r_store.EdgeStore(path, device=RefDevice(
        block_words=32, cache_blocks=4)), budget, block_rows=block_rows)
    plain = EdgeStore(path)
    rng = np.random.default_rng(seed)
    windows = [(0, 511), (0, 4), (3, 3), (17, 93), (-5, 600), (9, 2)]
    windows += [tuple(sorted(rng.integers(0, 512, 2))) for _ in range(40)]
    windows += windows[:10]
    for lo, hi in windows:
        ip_p, v_p = port.read_rows(lo, hi)
        ip_r, v_r = ref.read_rows(lo, hi)
        np.testing.assert_array_equal(ip_p, ip_r)
        np.testing.assert_array_equal(v_p, v_r)
        np.testing.assert_array_equal(v_p, plain.read_rows(lo, hi)[1])
        assert _cache_state(port) == _cache_state(ref), (lo, hi)
    assert port.hit_rate == ref.hit_rate
    assert port.n_nodes == plain.n_nodes          # proxied attributes
    port.clear()
    assert port._words == 0 and not port._blocks


def _padded_rows(rng, e, k, hi, empty_share=0.3):
    out = np.full((e, k), SENTINEL, np.int32)
    lens = rng.integers(0, k + 1, size=e)
    lens[rng.random(e) < empty_share] = 0
    for i, n in enumerate(lens):
        out[i, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    return out


@pytest.mark.parametrize("ka,kb,e,chunk", [
    (4, 64, 300, 256), (64, 4, 300, 128), (16, 16, 1000, 256),
    (1, 256, 50, 256), (8, 32, 0, 256)])
def test_count_rows_chunked_equals_the_reference(ka, kb, e, chunk):
    """Unequal widths, all-SENTINEL rows, a ragged last chunk: the plain
    torch count equals the reference's (whose int32 total is exact at
    these sizes) and is int64."""
    rng = np.random.default_rng(ka * 1000 + kb + e)
    a, b = _padded_rows(rng, e, ka, 300), _padded_rows(rng, e, kb, 300)
    got = _count_rows_chunked(torch.from_numpy(a), torch.from_numpy(b),
                              chunk=chunk)
    assert got.dtype == torch.int64 and got.dim() == 0
    if e:
        want = int(ref_count_rows(jnp.asarray(a), jnp.asarray(b),
                                  chunk=chunk))
    else:
        want = 0
    assert int(got) == want
    assert int(got) == sum(len(set(a[i]) & set(b[i]) - {SENTINEL})
                           for i in range(e))
