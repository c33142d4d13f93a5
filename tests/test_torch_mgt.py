"""repro_torch.core.mgt against repro.core.mgt on the CPU.

The port's MGT keeps the reference's pivot-range chunking, inverted index
and ``BlockDevice`` charges and replaces the padded L matrix by one
CSR intersect call per chunk; on the CPU that call runs its plain torch
version. Tolerance: none — the count, ``info`` (``n_chunks``,
``stream_scans``, ``io_reads``) and the device's ``IOStats`` must equal
the reference's; the Thm.-style I/O bound of ``tests/test_iomodel.py`` is
asserted on the port.
"""

import numpy as np
import pytest

from repro.core import mgt_triangle_count as ref_mgt
from repro.core.iomodel import BlockDevice as RefDevice
from repro.data.graphs import clustered_graph, random_graph, rmat_graph
from repro_torch import brute_force_count, mgt_triangle_count
from repro_torch.core.iomodel import BlockDevice
from repro_torch.core.lftj_torch import orient_edges

GRAPHS = {
    "random": lambda: random_graph(120, 900, seed=2),
    "rmat": lambda: rmat_graph(256, 3000, seed=0),
    "clustered": lambda: clustered_graph(4, 16, seed=1, p_in=0.6),
}
CPU = dict(torch_device="cpu")


@pytest.mark.parametrize("orientation", ["minmax", "degree"])
@pytest.mark.parametrize("mem", [16, 100, 700, 1 << 20])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_count_and_info_without_device(graph, mem, orientation):
    src, dst = GRAPHS[graph]()
    want, want_info = ref_mgt(src, dst, mem, orientation=orientation)
    got, info = mgt_triangle_count(src, dst, mem, orientation=orientation,
                                   **CPU)
    assert (got, info) == (want, want_info)
    assert got == brute_force_count(src, dst)
    assert info["io_reads"] is None and info["stream_scans"] == 0


@pytest.mark.parametrize("block,cache", [(16, 4), (64, 32)])
@pytest.mark.parametrize("mem", [64, 500])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_count_info_and_device_stats_with_device(graph, mem, block, cache):
    src, dst = GRAPHS[graph]()
    r_dev = RefDevice(block_words=block, cache_blocks=cache)
    p_dev = BlockDevice(block_words=block, cache_blocks=cache)
    want = ref_mgt(src, dst, mem, device=r_dev)
    got = mgt_triangle_count(src, dst, mem, device=p_dev, **CPU)
    assert got == want
    assert vars(p_dev.stats) == vars(r_dev.stats)
    assert got[1]["stream_scans"] == got[1]["n_chunks"]


@pytest.mark.parametrize("frac", [0.10, 0.25])
def test_block_reads_within_constant_of_bound(frac):
    """The sizes and budgets of the reference's MGT I/O-bound test: the
    port's block and word reads equal the reference's, and its block reads
    stay within a constant of O(|E|²/(MB) + |E|/B)."""
    src, dst = rmat_graph(256, 3000, seed=0)
    a, _ = orient_edges(src, dst)
    e = len(a)
    B = 16
    mem = max(4 * B, int(e * frac))
    r_dev = RefDevice(block_words=B, cache_blocks=max(2, mem // B))
    dev = BlockDevice(block_words=B, cache_blocks=max(2, mem // B))
    want, want_info = ref_mgt(src, dst, mem, device=r_dev)
    cnt, info = mgt_triangle_count(src, dst, mem, device=dev, **CPU)
    assert (cnt, info) == (want, want_info)
    assert dev.stats.block_reads == r_dev.stats.block_reads
    assert dev.stats.word_reads == r_dev.stats.word_reads
    assert cnt > 0 and info["n_chunks"] >= 1
    bound = e * e / (mem * B) + e / B
    assert dev.stats.block_reads <= 8 * bound + 64, \
        (frac, dev.stats.block_reads, bound)
    assert dev.stats.block_reads >= e / B / 8


def test_one_chunk_per_pivot_when_every_list_overflows():
    """mem_words below every out-degree: each pivot with an edge is its
    own chunk, as in the reference."""
    src, dst = GRAPHS["clustered"]()
    want = ref_mgt(src, dst, 1)
    got = mgt_triangle_count(src, dst, 1, **CPU)
    assert got == want
    assert got[1]["n_chunks"] > 10


def test_hub_graph_matches_reference():
    """A star plus a clique: one pivot's list is far wider than the rest,
    the case the padded L of the reference is widest for."""
    hub = np.zeros(60, np.int64)
    leaves = np.arange(1, 61)
    ci, cj = np.triu_indices(12, k=1)
    src = np.concatenate([hub, ci + 1])
    dst = np.concatenate([leaves, cj + 1])
    r_dev = RefDevice(block_words=8, cache_blocks=4)
    p_dev = BlockDevice(block_words=8, cache_blocks=4)
    want = ref_mgt(src, dst, 40, device=r_dev)
    got = mgt_triangle_count(src, dst, 40, device=p_dev, **CPU)
    assert got == want and got[0] == brute_force_count(src, dst)
    assert vars(p_dev.stats) == vars(r_dev.stats)


def test_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    src, dst = GRAPHS["random"]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgt_triangle_count(src, dst, 100)
