"""repro_torch's Prop. 4 instance against the reference's on the CPU.

``adversarial_graph`` must give the reference's arrays, and the host LFTJ
methods of the port's ``count_triangles`` must charge a ``BlockDevice``
exactly as the reference's do: the faithful join on G_N at the sizes of
``tests/test_boxing.py`` (the thrashing of Prop. 4: at least one block
read per tuple) and the boxed join on G_N and on the RMAT graphs of the
same file. Tolerance: none — arrays, counts and I/O statistics are equal.
"""

import pytest

from repro.core import adversarial_graph as ref_adversarial_graph
from repro.core import boxed_triangle_count as ref_boxed
from repro.core import count_triangles as ref_count_triangles
from repro.core import orient_edges as ref_orient
from repro.core import TrieArray as RefTrieArray
from repro.core.iomodel import BlockDevice as RefDevice
from repro.data.graphs import rmat_graph
from repro_torch import adversarial_graph, count_triangles
from repro_torch.core import TrieArray, boxed_triangle_count, orient_edges
from repro_torch.core.iomodel import BlockDevice

CPU = dict(torch_device="cpu")


@pytest.mark.parametrize("n,m,b", [(1600, 400, 16), (80, 64, 16),
                                   (4096, 256, 64), (1000, 7, 3)])
def test_arrays_equal(n, m, b):
    want = ref_adversarial_graph(n, m, b)
    got = adversarial_graph(n, m, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_too_small_raises_as_reference():
    with pytest.raises(ValueError, match="N >= M"):
        ref_adversarial_graph(10, 8, 4)
    with pytest.raises(ValueError, match="N >= M"):
        adversarial_graph(10, 8, 4)


def _devices(block, cache):
    return (RefDevice(block_words=block, cache_blocks=cache),
            BlockDevice(block_words=block, cache_blocks=cache))


@pytest.mark.parametrize("method", ["faithful", "boxed"])
def test_g_n_block_reads_equal_reference(method):
    """The test_boxing.py G_N (N = 1600, M = 400, B = 16): the port's
    block reads are the reference's; vanilla LFTJ thrashes (≥ |E|)."""
    m, bsz = 400, 16
    src, dst = adversarial_graph(1600, m, bsz)
    r_dev, p_dev = _devices(bsz, m // bsz)
    want = ref_count_triangles(src, dst, method=method, mem_words=m,
                               device=r_dev)
    got = count_triangles(src, dst, method=method, mem_words=m,
                          device=p_dev, **CPU)
    assert got == want
    assert vars(p_dev.stats) == vars(r_dev.stats)
    if method == "faithful":
        assert p_dev.stats.block_reads >= len(src)


@pytest.mark.parametrize("seed,frac", [(0, 0.1), (1, 0.1), (1, 0.3)])
def test_boxed_io_on_rmat_equals_reference(seed, frac):
    """The RMAT graphs and budgets of test_boxing.py (Fig. 9 and the
    Thm. 13 bound): boxed LFTJ over a registered TrieArray charges the
    port's device exactly as the reference's."""
    src, dst = rmat_graph(1 << 11, 22000, seed=seed)
    ra, rb = ref_orient(src, dst)
    a, b = orient_edges(src, dst)
    assert a.tobytes() == ra.tobytes() and b.tobytes() == rb.tobytes()
    rta, ta = RefTrieArray.from_edges(ra, rb), TrieArray.from_edges(a, b)
    words, bsz = ta.words(), 64
    assert words == rta.words()
    m = int(words * frac)
    r_dev, p_dev = _devices(bsz, max(2, m // bsz))
    r_dev.register_triearray(rta)
    p_dev.register_triearray(ta)
    want, _ = ref_boxed(rta, m, block_words=bsz, device=r_dev)
    got, _ = boxed_triangle_count(ta, m, block_words=bsz, device=p_dev)
    assert got == want
    assert vars(p_dev.stats) == vars(r_dev.stats)
    bound = words * words / (m * bsz) + words / bsz
    assert p_dev.stats.block_reads <= 12 * bound


def test_faithful_on_rmat_equals_reference():
    """Vanilla LFTJ at 10 % memory on an RMAT graph (a quarter of the
    Fig. 9 graph's scale, to keep the host join short): the port's LRU
    block reads are the reference's."""
    src, dst = rmat_graph(1 << 9, 5500, seed=0)
    a, b = orient_edges(src, dst)
    words, bsz = TrieArray.from_edges(a, b).words(), 64
    m = int(words * 0.1)
    r_dev, p_dev = _devices(bsz, max(2, m // bsz))
    want = ref_count_triangles(src, dst, method="faithful", device=r_dev)
    got = count_triangles(src, dst, method="faithful", device=p_dev, **CPU)
    assert got == want
    assert vars(p_dev.stats) == vars(r_dev.stats)


@pytest.mark.parametrize("method", ["vectorized", "boxed_vec", "mgt",
                                    "dense"])
def test_g_n_counts_agree_across_methods(method):
    """G_N is a bipartite-like star family: every method counts the same
    (the reference's count) on it."""
    src, dst = adversarial_graph(2000, 256, 16)
    want = ref_count_triangles(src, dst, method=method, mem_words=256)
    assert count_triangles(src, dst, method=method, mem_words=256,
                           **CPU) == want
