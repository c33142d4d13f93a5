"""Fanout neighbor sampler for minibatch GNN training (minibatch_lg shape).

The port of ``src/repro/data/sampler.py``: numpy only, and for the same
CSR, fanout and seed the same blocks bit for bit. GraphSAGE-style layered
sampling over CSR: per seed, sample up to fanout[0] 1-hop neighbors, then
fanout[1] per 1-hop node, etc. Output is the padded fixed-shape block that
configs.base.gnn_input_specs describes (static shapes, masks for
validity).

The CSR here is the same TrieArray val/idx layout the triangle engine
uses.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 fanout: Sequence[int] = (15, 10), seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.fanout = tuple(fanout)
        self.rng = np.random.default_rng(seed)
        self.n_nodes = len(indptr) - 1

    def sample_block(self, seeds: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Returns (nodes, src, dst): local subgraph with original node ids;
        edges point sampled-neighbor -> parent (message direction)."""
        frontier = np.asarray(seeds, dtype=np.int64)
        nodes = [frontier]
        srcs, dsts = [], []
        for f in self.fanout:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            # vectorized per-node sampling: draw f slots, mask short rows
            draw = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                     size=(len(frontier), f))
            valid = draw < deg[:, None]
            flat_parent = np.repeat(frontier, f)[valid.ravel()]
            offs = (self.indptr[frontier][:, None] + draw)[valid]
            nbrs = self.indices[offs]
            srcs.append(nbrs)
            dsts.append(flat_parent)
            frontier = np.unique(nbrs)
            nodes.append(frontier)
        all_nodes = np.unique(np.concatenate(nodes))
        return all_nodes, np.concatenate(srcs), np.concatenate(dsts)

    def padded_batch(self, seeds: np.ndarray, feats: np.ndarray,
                     labels: np.ndarray, blk_nodes: int, blk_edges: int
                     ) -> Dict[str, np.ndarray]:
        """One sampled block as a padded batch: the first ``blk_nodes``
        nodes (by id) and the first ``blk_edges`` edges between them;
        labels supervise the seeds only."""
        nodes, src, dst = self.sample_block(seeds)
        nodes = nodes[:blk_nodes]
        remap = -np.ones(self.n_nodes, dtype=np.int64)
        remap[nodes] = np.arange(len(nodes))
        ls, ld = remap[src], remap[dst]
        ok = (ls >= 0) & (ld >= 0)
        ls, ld = ls[ok][:blk_edges], ld[ok][:blk_edges]
        d_feat = feats.shape[1]
        batch = {
            "node_feat": np.zeros((blk_nodes, d_feat), np.float32),
            "edge_src": np.zeros((blk_edges,), np.int32),
            "edge_dst": np.zeros((blk_edges,), np.int32),
            "edge_mask": np.zeros((blk_edges,), np.float32),
            "node_mask": np.zeros((blk_nodes,), np.float32),
            "labels": np.zeros((blk_nodes,), np.int32),
            "label_mask": np.zeros((blk_nodes,), np.float32),
        }
        batch["node_feat"][:len(nodes)] = feats[nodes]
        batch["node_mask"][:len(nodes)] = 1.0
        batch["edge_src"][:len(ls)] = ls
        batch["edge_dst"][:len(ld)] = ld
        batch["edge_mask"][:len(ls)] = 1.0
        batch["labels"][:len(nodes)] = labels[nodes]
        # supervise seeds only (standard sampled-training semantics)
        seed_local = remap[np.asarray(seeds)]
        seed_local = seed_local[seed_local >= 0]
        batch["label_mask"][seed_local] = 1.0
        return batch
