"""The port's box scheduling (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``), on the CPU.

Every function is numpy in, numpy out, so each is held to the reference
exactly (tolerance 0) on the same seeded inputs: the box pricing
(``box_mass_costs``, ``box_mass_costs_nd`` on real ``QueryEngine`` plans),
the LPT schedule, the fabric's shipping planner, the interval algebra and
the padded per-shard slices (``shard_local_slices``), plus the port's own
compact form of those slices (``iter_shard_local_csr``) and the device list
(``box_mesh``) that takes the place of the reference's ``box_mesh``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data.graphs import random_graph, rmat_graph
from repro.parallel import sharding as ref
from repro.query.executor import QueryEngine as RefQuery
from repro.query.patterns import PATTERNS as REF_PATTERNS
from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
from repro_torch.parallel import sharding as port
from repro_torch.query import QueryEngine, patterns


def _csr(seed, nv=48, ne=160, gen=random_graph):
    src, dst = gen(nv, ne, seed=seed)
    a, b = orient_edges(src, dst)
    n = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
    ip, ix = csr_from_edges(a, b, n_nodes=n)
    return a, b, np.asarray(ip, np.int64), np.asarray(ix, np.int64)


def _boxes(rng, nv, n):
    raw = rng.integers(-2, nv + 2, size=(n, 4))
    return [(int(min(a, b)), int(max(a, b)), int(min(c, d)), int(max(c, d)))
            for a, b, c, d in raw]


@pytest.mark.parametrize("seed", range(6))
def test_box_mass_costs_equal_reference(seed):
    _a, _b, ip, _ix = _csr(seed, gen=rmat_graph if seed % 2 else
                           random_graph)
    boxes = _boxes(np.random.default_rng(seed), len(ip) - 1, 12)
    assert port.box_mass_costs(ip, boxes) == ref.box_mass_costs(ip, boxes)


@pytest.mark.parametrize("pattern", ["triangle", "four_clique", "diamond",
                                     "path3"])
def test_nd_costs_and_shipping_equal_reference(pattern):
    """On each pattern's plan: the port engine's fabric hooks
    (``owned_dim_keys``, ``source_keys``, ``source_for``) equal the
    reference engine's, the n-d prices equal the reference's and the port
    engine's own fetch estimate, and the LPT schedule and shipped ranges
    at 1..8 shards equal the reference's."""
    src, dst = random_graph(96, 400, seed=11)
    r_eng = RefQuery.from_graph(REF_PATTERNS[pattern](), src, dst,
                                mem_words=1 << 10)
    p_eng = QueryEngine.from_graph(patterns.PATTERNS[pattern](), src, dst,
                                   mem_words=1 << 10, torch_device="cpu")
    plan = r_eng.plan()
    assert p_eng.plan().boxes == plan.boxes
    dim_keys = r_eng.owned_dim_keys()
    assert p_eng.owned_dim_keys() == dim_keys
    assert p_eng.source_keys() == r_eng.source_keys()
    ips = {k: np.asarray(r_eng.source_for(k).indptr)
           for _d, keys in dim_keys for k in keys}
    for k, ip in ips.items():
        np.testing.assert_array_equal(p_eng.source_for(k).indptr, ip)
    costs = port.box_mass_costs_nd(plan.boxes, dim_keys, ips)
    assert costs == ref.box_mass_costs_nd(plan.boxes, dim_keys, ips)
    assert costs == [p_eng._est_box_words(b) for b in plan.boxes]
    nv = {k: r_eng.source_for(k).n_nodes for k in ips}
    for n_shards in range(1, 9):
        sched = port.balanced_box_schedule(costs, n_shards)
        assert sched == ref.balanced_box_schedule(costs, n_shards)
        assert port.shard_shipped_ranges(plan.boxes, sched, dim_keys, nv) \
            == ref.shard_shipped_ranges(plan.boxes, sched, dim_keys, nv)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, 1000), min_size=0, max_size=40),
       st.integers(0, 9))
def test_balanced_schedule_equals_reference(costs, n_shards):
    assert port.balanced_box_schedule(costs, n_shards) == \
        ref.balanced_box_schedule(costs, n_shards)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 60), st.integers(0, 60)),
                max_size=8),
       st.integers(0, 60), st.integers(0, 60))
def test_interval_algebra_equals_reference(raw, qlo, qhi):
    p_cov, r_cov = [], []
    for a, b in raw:
        p_cov = port.merge_interval(p_cov, min(a, b), max(a, b))
        r_cov = ref.merge_interval(r_cov, min(a, b), max(a, b))
        assert p_cov == r_cov
    lo, hi = min(qlo, qhi), max(qlo, qhi)
    assert port.interval_gaps(p_cov, lo, hi) == \
        ref.interval_gaps(r_cov, lo, hi)


def _edges_and_gather(seed):
    a, b, ip, ix = _csr(seed)
    n = len(ip) - 1
    edge_lists = []
    for lo in range(0, n, 12):
        mask = (a >= lo) & (a <= min(lo + 11, n - 1))
        edge_lists.append((a[mask].astype(np.int64),
                           b[mask].astype(np.int64)))
    calls = []

    def gather(rows):
        calls.append(np.asarray(rows).copy())
        deg = np.diff(ip)[rows] if len(rows) else np.zeros(0, np.int64)
        vals = np.concatenate([ix[ip[r]:ip[r + 1]] for r in rows]) \
            if len(rows) else np.zeros(0, np.int64)
        return deg, vals

    return edge_lists, gather, calls


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("pad_multiple", [1, 8])
def test_shard_local_slices_equal_reference(pad_multiple, n_shards):
    """The padded per-shard layout is the reference's array for array, the
    gathers are the same calls in the same order, and the port's compact
    slices are the same rows and neighbor lists unpadded."""
    edge_lists, gather, p_calls = _edges_and_gather(2)
    _, r_gather, r_calls = _edges_and_gather(2)
    sched = port.balanced_box_schedule([len(eu) for eu, _ in edge_lists],
                                       n_shards)
    got = port.shard_local_slices(edge_lists, sched, gather,
                                  pad_multiple=pad_multiple)
    want = ref.shard_local_slices(edge_lists, sched, r_gather,
                                  pad_multiple=pad_multiple)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert len(p_calls) == len(r_calls) == n_shards
    for g, w in zip(p_calls, r_calls):
        np.testing.assert_array_equal(g, w)
    slices = list(port.iter_shard_local_csr(edge_lists, sched, gather))
    assert port.local_slice_shape(slices) == want[3].shape
    eu_s, ev_s, ok_s, npad_s, rows_s = want
    for s, slc in enumerate(slices):
        n = int(ok_s[s].sum())
        assert len(slc.eu) == n
        np.testing.assert_array_equal(slc.eu, eu_s[s, :n])
        np.testing.assert_array_equal(slc.ev, ev_s[s, :n])
        np.testing.assert_array_equal(slc.rows, rows_s[s, :len(slc.rows)])
        np.testing.assert_array_equal(
            slc.rows[slc.eu], np.concatenate(
                [edge_lists[b][0] for b in sched[s]] or [np.zeros(0)]))
        off = slc.offsets
        for r in range(len(slc.rows)):
            row = npad_s[s, r]
            np.testing.assert_array_equal(slc.vals[off[r]:off[r + 1]],
                                          row[row != port.SENTINEL])


def test_box_mesh_is_a_device_list():
    """``box_mesh`` takes the place of the reference's 1-D "boxes" mesh: a
    list of torch devices, which may repeat; the card raises without
    CUDA, and one kind per list."""
    assert port.box_mesh(torch_device="cpu") == [torch.device("cpu")]
    assert port.box_mesh(["cpu"] * 8) == [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="empty"):
        port.box_mesh([])
    with pytest.raises(ValueError, match="only 'cuda' and 'cpu'"):
        port.box_mesh(["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.box_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.box_mesh(["cpu", "cuda"])
