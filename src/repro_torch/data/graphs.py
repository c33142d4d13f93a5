"""Graph generators: the paper's RAND and RMAT datasets plus a planted
partition graph.

RAND and RMAT are the paper's synthetic datasets (§6, Fig. 6): RAND picks
endpoints uniformly; RMAT follows Chakrabarti et al. [5] with the standard
(a,b,c,d) = (0.57, 0.19, 0.19, 0.05) parameters. Graphs are simplified
(self/duplicate edges removed) exactly as in the paper. The same seed gives
the same edges as the reference package's generators.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def unique_pairs(a: np.ndarray, b: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct (a[i], b[i]) pairs in lexicographic order, as the two
    columns of ``np.unique(np.stack([a, b], axis=1), axis=0)``. Non-negative
    ids below 2^31 are sorted as one int64 key a·n + b, which is the same
    order and an order of magnitude faster than sorting rows; other ids
    take the row sort."""
    a, b = np.asarray(a), np.asarray(b)
    dtype = np.result_type(a, b)
    n = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
    if a.size == 0 or min(a.min(), b.min()) < 0 or n > (1 << 31):
        e = np.unique(np.stack([a, b], axis=1), axis=0)
        return e[:, 0], e[:, 1]
    key = np.unique(a.astype(np.int64) * n + b.astype(np.int64))
    return (key // n).astype(dtype), (key % n).astype(dtype)


def simplify_edges(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Remove self loops and duplicate (undirected) edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return unique_pairs(np.minimum(src, dst), np.maximum(src, dst))


def random_graph(n_nodes: int, n_edges: int, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The paper's RAND dataset: uniform endpoints, then simplified."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
    dst = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
    return simplify_edges(src, dst)


def rmat_graph(n_nodes: int, n_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> Tuple[np.ndarray, np.ndarray]:
    """R-MAT generator [Chakrabarti et al. 2004], vectorized.

    Each edge picks one quadrant per scale via categorical draws; node ids
    are the accumulated bit paths. Power-law degrees, community structure —
    the paper's hard synthetic case (hub nodes stress boxing)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(2, n_nodes))))
    p = np.asarray([a, b, c, 1.0 - a - b - c])
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for bit in range(scale):
        q = rng.choice(4, size=n_edges, p=p)
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
    src %= n_nodes
    dst %= n_nodes
    return simplify_edges(src, dst)


def clustered_graph(n_clusters: int, cluster_size: int, seed: int = 0,
                    p_in: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Triangle-rich planted-partition graph (tests/benchmarks oracle).

    Arboricity scales with cluster density — used for the Thm. 17
    arboricity-scaling benchmark (cliques pack α ≈ cluster_size/2)."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for ci in range(n_clusters):
        base = ci * cluster_size
        m = rng.random((cluster_size, cluster_size)) < p_in
        iu, ju = np.triu_indices(cluster_size, k=1)
        sel = m[iu, ju]
        srcs.append(base + iu[sel])
        dsts.append(base + ju[sel])
    # sparse inter-cluster chain keeps it connected
    chain = np.arange(n_clusters - 1) * cluster_size
    srcs.append(chain)
    dsts.append(chain + cluster_size)
    return simplify_edges(np.concatenate(srcs), np.concatenate(dsts))
