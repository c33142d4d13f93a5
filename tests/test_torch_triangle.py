"""repro_torch's public triangle API against repro.core's on the CPU.

``count_triangles`` (all seven methods), ``list_triangles``,
``brute_force_count``, ``triangle_count_vectorized`` and
``triangle_count_boxed_vectorized`` of the port, with
``torch_device="cpu"`` (the kernel wrappers then run their plain torch
versions), against the reference's functions on the same numpy inputs
(JAX on the CPU; its Pallas paths off, as its own tests run them).
Tolerance: none — counts, listing bytes and info dicts must be equal.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro import core as ref
from repro.data.graphs import clustered_graph, random_graph, rmat_graph
from repro_torch import (brute_force_count, count_triangles,
                         list_triangles)
from repro_torch.core import (dense_adjacency,
                              triangle_count_boxed_vectorized,
                              triangle_count_vectorized)

ALL_METHODS = ["faithful", "boxed", "vectorized", "boxed_vec", "dense",
               "mgt", "auto"]
GENERATORS = {
    "random": (random_graph, dict(n_nodes=80, n_edges=600)),
    "rmat": (rmat_graph, dict(n_nodes=64, n_edges=600)),
    "clustered": (clustered_graph, dict(n_clusters=4, cluster_size=12,
                                        p_in=0.8)),
}
CPU = dict(torch_device="cpu")


def _graph(name, seed=7):
    gen, kw = GENERATORS[name]
    return gen(**kw, seed=seed)


@pytest.mark.parametrize("method", ALL_METHODS)
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_methods_agree_with_reference(gen, method):
    src, dst = _graph(gen)
    want = ref.count_triangles(src, dst, method=method, mem_words=128)
    got = count_triangles(src, dst, method=method, mem_words=128, **CPU)
    assert got == want == ref.brute_force_count(src, dst), (got, want)
    assert type(got) is int


@pytest.mark.parametrize("method", ["vectorized", "boxed"])
@settings(max_examples=15, deadline=None)
@given(st.integers(2, 200), st.integers(0, 10))
def test_random_sizes(method, n_edges, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 30, n_edges)
    dst = rng.integers(0, 30, n_edges)
    mem = 40 if method == "boxed" else None
    want = ref.count_triangles(src, dst, method=method, mem_words=mem)
    assert count_triangles(src, dst, method=method, mem_words=mem,
                           **CPU) == want == brute_force_count(src, dst)


@pytest.mark.parametrize("method", ["vectorized", "boxed_vec", "dense",
                                    "faithful", "mgt"])
def test_orientation_invariance(method):
    src, dst = rmat_graph(128, 1500, seed=3)
    counts = {o: count_triangles(src, dst, method=method, mem_words=256,
                                 orientation=o, **CPU)
              for o in ("minmax", "degree")}
    want = ref.count_triangles(src, dst, method=method, mem_words=256,
                               orientation="degree")
    assert counts["minmax"] == counts["degree"] == want


@pytest.mark.parametrize("mem", [128, 10**9])
@pytest.mark.parametrize("method", ["auto", "boxed_vec", "mgt"])
def test_budget_defaults_and_auto_rule(method, mem):
    """``auto`` takes boxed_vec above the budget and vectorized at or
    below it; boxed_vec and mgt take the reference's default budget when
    none is given."""
    src, dst = _graph("rmat", seed=11)
    for m in (mem, None):
        assert count_triangles(src, dst, method=method, mem_words=m,
                               **CPU) == ref.count_triangles(
            src, dst, method=method, mem_words=m)


def test_unknown_method_raises():
    src, dst = _graph("random")
    with pytest.raises(ValueError, match="unknown method"):
        count_triangles(src, dst, method="nope", **CPU)


@pytest.mark.parametrize("mem", [None, 10**9, 200, 60])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_list_triangles_byte_identical(gen, mem):
    """At and above the budget (boxed emission above it)."""
    src, dst = _graph(gen, seed=5)
    want = ref.list_triangles(src, dst, mem_words=mem)
    got = list_triangles(src, dst, mem_words=mem)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert len(got) == brute_force_count(src, dst)


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_brute_force_count_equal(gen):
    src, dst = _graph(gen, seed=3)
    assert brute_force_count(src, dst) == ref.brute_force_count(src, dst)


@pytest.mark.parametrize("orientation", ["minmax", "degree"])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_triangle_count_vectorized(gen, orientation):
    src, dst = _graph(gen, seed=9)
    want = ref.triangle_count_vectorized(src, dst, orientation)
    for chunk in (2048, 7):
        assert triangle_count_vectorized(src, dst, orientation, chunk=chunk,
                                         **CPU) == want


def test_triangle_count_vectorized_empty_graph():
    """Only self loops: no oriented edge, so no padded row at all (the
    reference's padded gather fails on such an input; the port counts
    0)."""
    src = dst = np.array([3, 5, 5])
    assert triangle_count_vectorized(src, dst, **CPU) == 0
    assert count_triangles(src, dst, method="mgt", **CPU) == 0


@pytest.mark.parametrize("mem", [400, 1 << 20])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_triangle_count_boxed_vectorized(gen, mem):
    src, dst = _graph(gen, seed=9)
    want = ref.triangle_count_boxed_vectorized(src, dst, mem_words=mem)
    got = triangle_count_boxed_vectorized(src, dst, mem_words=mem, **CPU)
    assert got == want
    assert isinstance(got[0], int) and got[1]["n_boxes"] >= 1


def test_dense_adjacency_copy():
    from repro.core.lftj_jax import dense_adjacency as ref_dense_adjacency
    src, dst = np.array([0, 2, 1]), np.array([1, 3, 3])
    want = ref_dense_adjacency(src, dst, 5)
    got = dense_adjacency(src, dst, 5)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("method", ["faithful", "boxed", "mgt"])
def test_device_charges_match_reference(method):
    """The methods that charge a BlockDevice charge the port's exactly as
    the reference's."""
    from repro.core.iomodel import BlockDevice as RefDevice
    from repro_torch.core.iomodel import BlockDevice
    src, dst = rmat_graph(256, 2500, seed=4)
    r_dev = RefDevice(block_words=16, cache_blocks=8)
    p_dev = BlockDevice(block_words=16, cache_blocks=8)
    want = ref.count_triangles(src, dst, method=method, mem_words=300,
                               device=r_dev)
    got = count_triangles(src, dst, method=method, mem_words=300,
                          device=p_dev, **CPU)
    assert got == want
    assert vars(p_dev.stats) == vars(r_dev.stats)
    assert p_dev.stats.block_reads > 0
