"""``TriangleEngine(shard=True)`` of the port against the reference's, on
the CPU.

The port's shards are CPU devices, repeated (``devices=["cpu"] * n``);
each holds its slice as compact CSR and counts through the intersect
wrapper's plain version, lists through the plain chunked listing, and
with ``degree_bins`` through ``_list_pairs_chunked``. The reference runs
in process at one device, and once, in a module-scoped subprocess, at 8
forced host devices (as ``tests/test_engine.py`` does), which returns its
results as JSON. Every comparison is exact (tolerance 0): counts,
canonical listing bytes, ``n_shards``, ``shard_edges``, ``shard_rows``,
``local_npad_shape``, ``n_rescans``, the lane mix and the block ledger
(block reads, writes and word reads), in memory (on a charged
``BlockDevice``) and from a store. ``_list_pairs_chunked`` is held to the
JAX function itself, below and above its capacity.
"""

import hashlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import TriangleEngine as RefEngine
from repro.core import lftj_jax
from repro.core.iomodel import BlockDevice as RefDevice
from repro.data.edgestore import write_edge_store
from repro.data.graphs import rmat_graph
from repro_torch import TriangleEngine
from repro_torch.core import lftj_torch
from repro_torch.core.iomodel import BlockDevice

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def er_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, k=1))
    return src.astype(np.int64), dst.astype(np.int64)


GRAPHS = {"er": lambda: er_graph(120, 0.05, seed=3),
          "rmat": lambda: rmat_graph(128, 1500, seed=0)}


# the shard cases of tests/test_engine.py's ENGINE_CONFIGS, and the skew
# planner's schedule on slice mass
CONFIGS = {
    "shard": dict(shard=True),
    "budget": dict(mem_words=200, shard=True),
    "bins": dict(mem_words=200, shard=True, degree_bins=True),
    "skew": dict(mem_words=200, shard=True, skew="heavy_light"),
}
# the reference compiles one program per degree-bin pair (and per
# capacity), so its binned cases run on the sparse ER graph, whose few
# bins make few pairs
CASES = [("rmat", "budget"), ("rmat", "skew"), ("er", "bins")]
STATS = ("n_boxes", "n_dense_boxes", "n_binary_boxes", "n_host_boxes",
         "n_fused_boxes", "n_shards", "shard_edges", "shard_rows",
         "local_npad_shape", "n_rescans", "block_reads", "block_writes",
         "word_reads", "cache_hits", "cache_misses", "padded_words",
         "actual_words", "source")
# listing capacities below the shard totals: the listings rescan (a
# degree-bin pair of the ER graph lists a few triangles)
CAPACITY = {"er": 4, "rmat": 256}


def _stats(stats) -> dict:
    out = {f: getattr(stats, f) for f in STATS}
    if out["local_npad_shape"] is not None:
        out["local_npad_shape"] = list(out["local_npad_shape"])
    return out


def _run(make, capacity) -> dict:
    """count, the count's stats, list(capacity), the listing's stats."""
    eng = make()
    count = eng.count()
    count_stats = _stats(eng.stats)
    tris = eng.list(capacity=capacity)
    return {"count": count, "count_stats": count_stats,
            "list_sha": hashlib.sha256(tris.tobytes()).hexdigest(),
            "listed": len(tris), "list_stats": _stats(eng.stats)}


def _make(kind, src, dst, store, cfg, **extra):
    """An engine of ``kind`` ("ref" or "port") over the graph in memory
    (``store is None``, reads charged to a fresh BlockDevice) or over the
    store."""
    if kind == "ref":
        cls, dev, extra = RefEngine, RefDevice, extra
    else:
        cls, dev = TriangleEngine, BlockDevice
        extra = dict(extra, torch_device="cpu")
    if store is None:
        return lambda: cls(src, dst, device=dev(64, 16), **cfg, **extra)
    return lambda: cls(store=store, io_block_words=64, **cfg, **extra)


_REF8 = r"""
import hashlib, json, sys, warnings
warnings.simplefilter("ignore")
import jax
import numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.core import TriangleEngine
from repro.core.iomodel import BlockDevice
from repro.data.graphs import rmat_graph
stats_fields, configs, cases, capacity, stores = json.loads(sys.argv[1])
rng = np.random.default_rng(3)
er = [x.astype(np.int64) for x in
      np.nonzero(np.triu(rng.random((120, 120)) < 0.05, k=1))]
graphs = {"er": er, "rmat": rmat_graph(128, 1500, seed=0)}

def stats(s):
    out = {f: getattr(s, f) for f in stats_fields}
    if out["local_npad_shape"] is not None:
        out["local_npad_shape"] = list(out["local_npad_shape"])
    return out

out = {}
for graph, name in cases:
    src, dst = graphs[graph]
    cfg = configs[name]
    for where in ("memory", "store"):
        eng = TriangleEngine(src, dst, device=BlockDevice(64, 16), **cfg) \
            if where == "memory" else \
            TriangleEngine(store=stores[graph], io_block_words=64, **cfg)
        assert eng.shard and len(eng.devices) == 8
        count = eng.count()
        count_stats = stats(eng.stats)
        tris = eng.list(capacity=capacity[graph])
        out[f"{graph}/{name}/{where}"] = {
            "count": count, "count_stats": count_stats,
            "list_sha": hashlib.sha256(tris.tobytes()).hexdigest(),
            "listed": len(tris), "list_stats": stats(eng.stats)}
print("REF8-JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    out = {}
    for name, make in GRAPHS.items():
        out[name] = str(d / f"{name}.csr")
        write_edge_store(out[name], *make(), orientation="minmax",
                         chunk_rows=16)
    return out


@pytest.fixture(scope="module")
def ref8(stores):
    """The reference engine at 8 forced host devices, every case, in
    memory and from the store, in one subprocess."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep \
        + env.get("PYTHONPATH", "")
    arg = json.dumps([STATS, CONFIGS, CASES, CAPACITY, stores])
    res = subprocess.run([sys.executable, "-c", _REF8, arg],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = next(x for x in res.stdout.splitlines()
                if x.startswith("REF8-JSON "))
    return json.loads(line[len("REF8-JSON "):])


@pytest.mark.parametrize("where", ["memory", "store"])
@pytest.mark.parametrize("graph,config", CASES)
def test_eight_devices_equal_reference(ref8, stores, graph, config, where):
    want = ref8[f"{graph}/{config}/{where}"]
    src, dst = GRAPHS[graph]()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _run(_make("port", src, dst, stores[graph] if where == "store"
                         else None, CONFIGS[config], devices=["cpu"] * 8),
                   CAPACITY[graph])
    assert got == want
    assert want["count_stats"]["n_shards"] == 8
    assert want["list_stats"]["n_shards"] == 8
    assert want["list_stats"]["n_rescans"] > 0
    if where == "store":
        assert want["count_stats"]["block_reads"] > 0


@pytest.mark.parametrize("where", ["memory", "store"])
@pytest.mark.parametrize("graph,config", CASES + [("rmat", "shard")])
def test_one_device_equals_reference(stores, graph, config, where):
    """In process, the reference at its one device against the port at
    one CPU device, listings at a capacity that forces rescans."""
    src, dst = GRAPHS[graph]()
    store = stores[graph] if where == "store" else None
    cfg = CONFIGS[config]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _run(_make("ref", src, dst, store, cfg), CAPACITY[graph])
        got = _run(_make("port", src, dst, store, cfg), CAPACITY[graph])
    assert got == want
    assert got["count_stats"]["n_shards"] == 1
    assert got["list_stats"]["n_rescans"] > 0


def test_sharded_counts_do_not_depend_on_the_device_count():
    """1..8 repeated CPU devices, auto sharding: one count, one listing
    (the reduction is exact and order-free), the edges partitioned."""
    src, dst = rmat_graph(128, 1500, seed=2)
    base = TriangleEngine(src, dst, mem_words=300, torch_device="cpu")
    want, want_tris = base.count(), base.list()
    for n in (2, 3, 8):
        for bins in (False, True):
            eng = TriangleEngine(src, dst, mem_words=300, degree_bins=bins,
                                 devices=["cpu"] * n, torch_device="cpu")
            assert eng.shard           # "auto": more than one device
            assert eng.count() == want
            assert eng.stats.n_shards == n
            assert len(eng.stats.shard_edges) == n
            assert eng.list(capacity=32).tobytes() == want_tris.tobytes()
    assert not TriangleEngine(src, dst, devices=["cpu"],
                              torch_device="cpu").shard


def test_local_boxes_on_the_async_queue_with_workers():
    """``workers > 1`` over an uncharged source sends the dense boxes
    through the executor's queue; the count and stats are the reference's
    at one device."""
    src, dst = rmat_graph(128, 1500, seed=0)
    kw = dict(mem_words=300, shard=True, workers=4)
    ref = RefEngine(src, dst, **kw)
    port = TriangleEngine(src, dst, torch_device="cpu", **kw)
    assert port.count() == ref.count()
    assert port.stats.n_dense_boxes == ref.stats.n_dense_boxes > 0
    assert _stats(port.stats) == _stats(ref.stats)


def test_store_staging_is_one_sequential_pass(stores):
    """A sharded engine over a store reads it once, in order: its ledger
    is a fresh device's full read of every row, and it warns."""
    rmat_store = stores["rmat"]
    with pytest.warns(UserWarning, match="stages the store-backed"):
        eng = TriangleEngine(store=rmat_store, io_block_words=64,
                             shard=True, torch_device="cpu")
    eng.count()
    from repro_torch.data.edgestore import EdgeStore
    dev = BlockDevice(eng.device.B, eng.device.cache_blocks)
    one_pass = EdgeStore(rmat_store, device=dev)
    one_pass.read_rows(0, one_pass.n_nodes - 1)
    assert eng.stats.block_reads == dev.stats.block_reads > 0
    assert eng.stats.word_reads == dev.stats.word_reads


def test_shard_arguments():
    src, dst = er_graph(30, 0.2, seed=3)
    with pytest.raises(ValueError, match="shard"):
        TriangleEngine(src, dst, shard="yes", torch_device="cpu")
    with pytest.raises(ValueError, match="empty"):
        TriangleEngine(src, dst, devices=[], torch_device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TriangleEngine(src, dst, devices=["cuda:0"] * 2,
                           torch_device="cpu")


def _pairs_case(seed, ka, kb, m):
    """Sorted SENTINEL-padded matrices of widths ka and kb, each with a
    last all-SENTINEL row (the reference's pad row), and m edges."""
    rng = np.random.default_rng(seed)
    sentinel = lftj_torch.SENTINEL

    def matrix(rows, k):
        out = np.full((rows + 1, k), sentinel, np.int32)
        for r in range(rows):
            d = int(rng.integers(0, k + 1))
            out[r, :d] = np.sort(rng.choice(40, size=d, replace=False))
        return out

    npa, npb = matrix(12, ka), matrix(9, kb)
    eu = rng.integers(0, 13, size=m).astype(np.int32)
    ev = rng.integers(0, 10, size=m).astype(np.int32)
    us = rng.integers(0, 1000, size=m).astype(np.int32)
    vs = rng.integers(0, 1000, size=m).astype(np.int32)
    return npa, npb, eu, ev, us, vs


@pytest.mark.parametrize("ka,kb", [(4, 16), (16, 4)])
@pytest.mark.parametrize("cap", [8, 1 << 12])
def test_list_pairs_chunked_equals_jax(ka, kb, cap):
    """The exact total and the buffer (the first min(total, cap) rows in
    traversal order, zeros after) equal the JAX function's, with the
    sides swapped when ``npa`` is the wider and with an overflowing
    capacity; the port's total is an exact Python int."""
    import jax.numpy as jnp
    arrays = _pairs_case(ka * 7 + kb, ka, kb, m=300)
    want_total, want_buf = lftj_jax._list_pairs_chunked(
        *(jnp.asarray(x) for x in arrays), cap=cap, chunk=64)
    got_total, got_buf = lftj_torch._list_pairs_chunked(
        *(torch.from_numpy(x) for x in arrays), cap=cap, chunk=64)
    assert isinstance(got_total, int)
    assert got_total == int(want_total) > 0
    assert (got_total > cap) == (cap == 8)
    n = min(got_total, cap)
    got_buf, want_buf = got_buf.numpy(), np.asarray(want_buf)
    assert got_buf.dtype == want_buf.dtype == np.int32
    np.testing.assert_array_equal(got_buf[:n], want_buf[:n])
    np.testing.assert_array_equal(got_buf, want_buf)


def test_list_csr_chunked_equals_padded_listing():
    """The sharded listing's CSR form lists what ``_list_chunked`` lists
    over the same rows padded, in the same order, with the same total."""
    src, dst = rmat_graph(64, 600, seed=4)
    a, b = lftj_torch.orient_edges(src, dst)
    ip, ix = lftj_torch.csr_from_edges(a, b)
    npad = torch.from_numpy(lftj_torch.pad_neighbors(ip, ix))
    eu, ev = torch.from_numpy(a), torch.from_numpy(b)
    for cap in (16, 1 << 14):
        want = lftj_torch._list_chunked(npad, eu, ev, cap=cap, chunk=100)
        got = lftj_torch._list_csr_chunked(torch.from_numpy(ip),
                                           torch.from_numpy(ix), eu, ev,
                                           cap=cap, chunk=100)
        assert got[0] == want[0] > 16
        assert torch.equal(got[1], want[1])
