"""MGT baseline: Massive Graph Triangulation [Hu, Tao, Chung SIGMOD'13].

The specialized out-of-core competitor the paper benchmarks against
(paper §6, Fig. 11): the in-memory-chunk + edge-stream pattern that gives
MGT its O(|E|²/(MB) + K/B) I/O bound:

  repeat until all pivot nodes processed:
    load into memory the adjacency lists of the next node range R such that
    they fit in M;
    stream every edge (b, c) of E from disk once; for each, report
    |{a ∈ R : b ∈ N(a) ∧ c ∈ N(a)}| triangles (a is the pivot; with the DAG
    orientation a < b < c each triangle is counted exactly once).

The membership test uses an inverted index L(v) = {a ∈ R : v ∈ N(a)}, so
each streamed edge costs one sorted-list intersection |L(b) ∩ L(c)|. The
pivot-range chunking, the inverted index and the ``BlockDevice`` charges
are the reference's, step for step. The intersections are one
``intersect_count_csr`` call per chunk over L as CSR (offsets ``l_ptr``,
values the sorted pivots) at every streamed edge: a CUDA kernel launch on
the card, its plain version on the CPU. The reference pads L to the widest
list instead, nv × max|L(v)| words, which at RMAT scale 20 does not fit on
a card. The chunk totals stay on the device and are read once at the end,
as int64.

As in the reference, MGT's degree-splitting preprocessing and its
result-dependent optimizations are omitted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.intersect import ops as intersect_ops

from .iomodel import BlockDevice
from .lftj_torch import csr_from_edges, orient_edges


def mgt_triangle_count(src: np.ndarray, dst: np.ndarray,
                       mem_words: int,
                       device: Optional[BlockDevice] = None,
                       orientation: str = "minmax",
                       torch_device="cuda") -> Tuple[int, dict]:
    """Count triangles; returns (count, info with io/chunk stats).

    ``device`` charges the pivot-range loads and the edge-stream scans;
    ``torch_device`` is where the intersections run (``"cuda"`` by
    default, raising without a card, or ``"cpu"``)."""
    from .engine import resolve_torch_device
    dev = resolve_torch_device(torch_device)
    a, b = orient_edges(src, dst, orientation)
    indptr, indices = csr_from_edges(a, b)
    nv = len(indptr) - 1
    ne = len(indices)
    if device is not None:
        device.register(indices)

    # partition pivots into ranges whose adjacency fits the memory budget
    deg = np.diff(indptr)
    chunks = []
    start = 0
    acc = 0
    for v in range(nv):
        d = int(deg[v])
        if acc + d > mem_words and acc > 0:
            chunks.append((start, v))
            start, acc = v, 0
        acc += d
    chunks.append((start, nv))

    # the streamed edges (b, c) go to the device once, not once per chunk
    eu = torch.from_numpy(a.astype(np.int64)).to(dev)
    ev = torch.from_numpy(b.astype(np.int64)).to(dev)
    parts = []
    stream_ios = 0
    for (r0, r1) in chunks:
        # "load" adjacency of pivots in [r0, r1): counted as sequential read
        lo, hi = int(indptr[r0]), int(indptr[r1])
        if device is not None and hi > lo:
            device.read_range(indices, lo, hi)
        # inverted index L: for each vertex v, sorted pivots a∈R with v∈N(a)
        piv = np.repeat(np.arange(r0, r1), deg[r0:r1]).astype(np.int64)
        nbr = indices[lo:hi].astype(np.int64)
        order = np.lexsort((piv, nbr))
        nbr_s, piv_s = nbr[order], piv[order]
        l_ptr = np.searchsorted(nbr_s, np.arange(nv + 1)).astype(np.int64)
        if device is not None:
            # one full sequential scan of the edge file per chunk
            device.clear_cache()   # streaming evicts; model as cold scan
            device.read_range(indices, 0, ne)
            stream_ios += 1
        if hi == lo:
            continue               # every L(v) is empty
        off = torch.from_numpy(l_ptr).to(dev)
        vals = torch.from_numpy(piv_s.astype(np.int32)).to(dev)
        # per streamed edge (b, c): |L(b) ∩ L(c)|
        parts.append(intersect_ops.intersect_count_csr(off, vals, eu,
                                                       off, vals, ev))
    total = int(torch.stack(parts).sum()) if parts else 0
    info = {"n_chunks": len(chunks), "stream_scans": stream_ios,
            "io_reads": device.stats.block_reads if device else None}
    return total, info
