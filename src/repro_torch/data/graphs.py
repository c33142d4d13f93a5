"""Graph generators: the paper's RAND and RMAT datasets, a planted
partition graph, the GNN batches built on them, and GraphCast's
icosahedral multimesh.

RAND and RMAT are the paper's synthetic datasets (§6, Fig. 6): RAND picks
endpoints uniformly; RMAT follows Chakrabarti et al. [5] with the standard
(a,b,c,d) = (0.57, 0.19, 0.19, 0.05) parameters. Graphs are simplified
(self/duplicate edges removed) exactly as in the paper. The same seed gives
the same edges as the reference package's generators.

``synthetic_features`` and ``make_gnn_batch`` give a GNN its fixed-shape
padded batch (``configs.base.gnn_input_specs``), and ``icosahedral_mesh``
builds GraphCast's refinement-r multimesh [arXiv:2212.12794]: a
recursively subdivided icosahedron with the union of every refinement
level's edges. For the same arguments each returns the reference's arrays
bit for bit (``src/repro/data/graphs.py:83``, ``:94``, ``:138``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def synthetic_features(n_nodes: int, d_feat: int, n_classes: int,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """Class-conditioned Gaussian features (GNN train smoke/examples)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    centers = rng.standard_normal((n_classes, d_feat)) * 2.0
    feats = centers[labels] + rng.standard_normal((n_nodes, d_feat))
    return {"node_feat": feats.astype(np.float32),
            "labels": labels.astype(np.int32)}


def make_gnn_batch(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   d_feat: int, n_classes: int = 0, d_target: int = 0,
                   pad_to: int = 0, seed: int = 0,
                   pos: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Fixed-shape padded GNN batch matching configs.base.gnn_input_specs:
    node and edge counts rounded up to multiples of ``pad_to``; padding
    edges point node 0 at node 0 with ``edge_mask`` 0. ``d_target`` makes
    a regression batch (targets, positions, ``graph_id``), else labels."""
    n, e = n_nodes, len(src)
    n_pad, e_pad = n, e
    if pad_to:
        n_pad = ((n + pad_to - 1) // pad_to) * pad_to
        e_pad = ((e + pad_to - 1) // pad_to) * pad_to
    rng = np.random.default_rng(seed)
    batch = {
        "node_feat": np.zeros((n_pad, d_feat), np.float32),
        "edge_src": np.zeros((e_pad,), np.int32),
        "edge_dst": np.zeros((e_pad,), np.int32),
        "edge_mask": np.zeros((e_pad,), np.float32),
        "node_mask": np.zeros((n_pad,), np.float32),
    }
    feats = synthetic_features(n, d_feat, max(2, n_classes), seed)
    batch["node_feat"][:n] = feats["node_feat"]
    batch["edge_src"][:e] = src
    batch["edge_dst"][:e] = dst
    batch["edge_mask"][:e] = 1.0
    batch["node_mask"][:n] = 1.0
    if d_target:
        batch["targets"] = np.zeros((n_pad, d_target), np.float32)
        batch["targets"][:n] = rng.standard_normal((n, d_target))
        if pos is None:
            pos = rng.standard_normal((n, 3)).astype(np.float32)
        batch["pos"] = np.zeros((n_pad, 3), np.float32)
        batch["pos"][:n] = pos
        batch["graph_id"] = np.zeros((n_pad,), np.int32)
    else:
        batch["labels"] = np.zeros((n_pad,), np.int32)
        batch["labels"][:n] = feats["labels"] % n_classes
        batch["label_mask"] = batch["node_mask"].copy()
    return batch


# ---------------------------------------------------------------------------
# GraphCast icosahedral multimesh
# ---------------------------------------------------------------------------

def _face_edges(faces: np.ndarray) -> np.ndarray:
    """The distinct undirected edges of ``faces`` as sorted (a < b) rows."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    a, b = unique_pairs(np.minimum(e[:, 0], e[:, 1]),
                        np.maximum(e[:, 0], e[:, 1]))
    return np.stack([a, b], 1)


def icosahedral_mesh(refinement: int = 2):
    """Vertices + multimesh edges of a recursively refined icosahedron.

    Returns (verts (V,3) float32 unit sphere, src, dst) where the edge set
    is the union over refinement levels 0..r (GraphCast's multimesh), each
    edge once with src < dst, in lexicographic order. refinement=6 gives
    40,962 nodes and 163,830 edges (the arch card's mesh size). A level's
    new vertices are numbered in the order its faces first name their
    edges, each edge's midpoint pushed out to the unit sphere."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.asarray([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
        dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])

    all_edges = [_face_edges(faces)]
    for _ in range(refinement):
        new_verts = []
        midpoint = {}
        nv = len(verts)

        def mid(i, j):
            nonlocal nv
            key = (min(i, j), max(i, j))
            if key not in midpoint:
                m = verts[i] + verts[j]
                new_verts.append((m / np.linalg.norm(m))[None])
                midpoint[key] = nv
                nv += 1
            return midpoint[key]

        new_faces = []
        for (i, j, k) in faces:
            a = mid(i, j)
            b = mid(j, k)
            c = mid(k, i)
            new_faces += [[i, a, c], [j, b, a], [k, c, b], [a, b, c]]
        verts = np.concatenate([verts] + new_verts)
        faces = np.asarray(new_faces)
        all_edges.append(_face_edges(faces))

    edges = np.concatenate(all_edges)
    a, b = unique_pairs(edges[:, 0], edges[:, 1])
    return verts.astype(np.float32), a.astype(np.int64), b.astype(np.int64)
