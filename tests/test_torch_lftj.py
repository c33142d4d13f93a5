"""repro_torch.core.lftj_torch against repro.core.lftj_jax on the CPU.

Host helpers must give identical arrays; the torch device primitives
(``_count_chunked``, ``_list_chunked``, ``triangle_count_dense``) must give
identical totals and identical listing buffers, row for row, for every
capacity. Inputs are made with numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lftj_jax as ref
from repro_torch.core import lftj_torch as port


def er_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((n, n)) < p, k=1)
    src, dst = np.nonzero(adj)
    return src.astype(np.int64), dst.astype(np.int64)


def rmat(seed):
    from repro.data.graphs import rmat_graph
    return rmat_graph(128, 1500, seed=seed)


GRAPHS = {"er": lambda: er_graph(60, 0.2, 3), "rmat": lambda: rmat(2)}


def oriented_csr(name, mode="minmax"):
    a, b = ref.orient_edges(*GRAPHS[name](), mode)
    indptr, indices = ref.csr_from_edges(a, b)
    return a, b, indptr, indices


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("mode", ["minmax", "degree"])
def test_host_helpers_identical(name, mode):
    src, dst = GRAPHS[name]()
    # unsimplified input: self loops and both directions of an edge
    src = np.concatenate([src, dst[:5], [3]])
    dst = np.concatenate([dst, src[:5], [3]])
    ra, rb = ref.orient_edges(src, dst, mode)
    pa, pb = port.orient_edges(src, dst, mode)
    np.testing.assert_array_equal(ra, pa)
    np.testing.assert_array_equal(rb, pb)
    r_csr = ref.csr_from_edges(ra, rb)
    p_csr = port.csr_from_edges(pa, pb)
    for r, p in zip(r_csr, p_csr):
        assert r.dtype == p.dtype
        np.testing.assert_array_equal(r, p)
    np.testing.assert_array_equal(ref.pad_neighbors(*r_csr),
                                  port.pad_neighbors(*p_csr))
    k = int(np.diff(r_csr[0]).max()) + 5
    np.testing.assert_array_equal(ref.pad_neighbors(*r_csr, k=k),
                                  port.pad_neighbors(*p_csr, k=k))
    r_bin, r_bins = ref.pad_neighbors_binned(*r_csr)
    p_bin, p_bins = port.pad_neighbors_binned(*p_csr)
    np.testing.assert_array_equal(r_bin, p_bin)
    assert len(r_bins) == len(p_bins)
    for (rr, rn), (pr, pn) in zip(r_bins, p_bins):
        np.testing.assert_array_equal(rr, pr)
        np.testing.assert_array_equal(rn, pn)


@pytest.mark.parametrize("case,dtype", [
    (c, d) for c in ("empty", "small", "wide", "negative")
    for d in (np.int32, np.int64)] + [("huge", np.int64)])
def test_unique_pairs_equals_row_unique(case, dtype):
    """``orient_edges``, ``simplify_edges`` and tuple relations dedupe
    through ``unique_pairs``: the same columns, order and dtype as the
    reference's row ``np.unique(..., axis=0)``, on the int64-key route and
    on the row-sort fallback (negative ids, ids past 2^31)."""
    from repro_torch.data.graphs import unique_pairs
    rng = np.random.default_rng(7)
    n = {"empty": 0, "small": 5, "wide": 3000, "negative": 50,
         "huge": 50}[case]
    a = rng.integers(0, max(1, n), size=4 * n).astype(np.int64)
    b = rng.integers(0, max(1, n), size=4 * n).astype(np.int64)
    if case == "negative":
        a[::7] = -a[::7] - 1
    if case == "huge":
        a[::5] += 1 << 40
    a, b = a.astype(dtype), b.astype(dtype)
    want = np.unique(np.stack([a, b], axis=1), axis=0)
    got = unique_pairs(a, b)
    for g, w in zip(got, (want[:, 0], want[:, 1])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pad_neighbors_rejects_truncation():
    _, _, indptr, indices = oriented_csr("rmat")
    with pytest.raises(ValueError, match="truncate"):
        port.pad_neighbors(indptr, indices, k=2)


def _device_inputs(indptr, indices):
    npad = port.pad_neighbors(indptr, indices)
    deg = torch.from_numpy(np.diff(indptr))
    return npad, torch.from_numpy(npad), deg


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("chunk", [7, 64, 2048])
def test_count_chunked_equal(name, chunk):
    a, b, indptr, indices = oriented_csr(name)
    npad, t_npad, deg = _device_inputs(indptr, indices)
    eu = a.astype(np.int32)
    ev = b.astype(np.int32)
    want = int(ref._count_chunked(jnp.asarray(npad), jnp.asarray(eu),
                                  jnp.asarray(ev), chunk=chunk))
    teu, tev = torch.from_numpy(eu), torch.from_numpy(ev)
    full = port._count_chunked(t_npad, teu, tev, chunk=chunk)
    trimmed = port._count_chunked(t_npad, teu, tev, chunk=chunk, deg=deg)
    assert full.dtype == torch.int64 and trimmed.dtype == torch.int64
    assert int(full) == want
    assert int(trimmed) == want


def test_row_intersect_count_matches_reference():
    _, _, indptr, indices = oriented_csr("er")
    npad = port.pad_neighbors(indptr, indices)
    rng = np.random.default_rng(5)
    u = rng.integers(0, len(npad), 300)
    v = rng.integers(0, len(npad), 300)
    want = [int(ref._row_intersect_count(jnp.asarray(npad[i]),
                                         jnp.asarray(npad[j])))
            for i, j in zip(u, v)]
    got = port._row_intersect_count(torch.from_numpy(npad[u]),
                                    torch.from_numpy(npad[v]))
    assert got.tolist() == want


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("cap_kind", ["below", "equal", "above"])
def test_list_chunked_buffer_equal_row_for_row(name, cap_kind):
    a, b, indptr, indices = oriented_csr(name)
    npad, t_npad, deg = _device_inputs(indptr, indices)
    eu = a.astype(np.int32)
    ev = b.astype(np.int32)
    total = int(ref._count_chunked(jnp.asarray(npad), jnp.asarray(eu),
                                   jnp.asarray(ev)))
    assert total > 10
    cap = {"below": total // 3, "equal": total, "above": 2 * total}[cap_kind]
    r_total, r_buf = ref._list_chunked(jnp.asarray(npad), jnp.asarray(eu),
                                       jnp.asarray(ev), cap=cap, chunk=64)
    r_buf = np.asarray(r_buf)
    teu, tev = torch.from_numpy(eu), torch.from_numpy(ev)
    for kw in ({}, {"deg": deg}):
        p_total, p_buf = port._list_chunked(t_npad, teu, tev, cap=cap,
                                            chunk=64, **kw)
        assert p_total == int(r_total) == total
        assert p_buf.dtype == torch.int32 and p_buf.shape == (cap, 3)
        np.testing.assert_array_equal(p_buf.numpy(), r_buf)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_triangle_count_dense_equal(name):
    a, b, indptr, _ = oriented_csr(name)
    n = len(indptr) - 1
    adj = np.zeros((n, n), np.float32)
    adj[a, b] = 1.0
    want = int(ref.triangle_count_dense(jnp.asarray(adj)))
    got = port.triangle_count_dense(torch.from_numpy(adj))
    assert got.dtype == torch.int64
    assert int(got) == want
