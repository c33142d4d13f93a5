#!/usr/bin/env python3
"""Sizes of the serve smoke phase's Server A mix on two candidate graphs.

For the listing phase's RMAT graph (scale 16, seed 1) and the query
phase's (scale 13, seed 0), minmax-oriented as ``Server.from_graph``
orients them, prints one JSON line per graph: the boxes the server's plan
cuts for the triangle and path3 patterns at one query's admitted budget
(``chip_smoke.SERVE_WANT_WORDS``), the triangles, and the oriented
2-paths, which the path3 count materialises as its frontier on the host
lane before summing the last atom's degrees. Plans only, on the host:

    PYTHONPATH=src python scripts/serve_sizing.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GRAPHS = (("listing", 16, 1), ("query", 13, 0))


def main() -> int:
    import scipy.sparse as sp
    from chip_smoke import SERVE_WANT_WORDS
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    from repro_torch.core.queries import validate
    from repro_torch.data.edgestore import InMemoryEdgeSource
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.query import QueryEngine, patterns
    for phase, scale, seed in GRAPHS:
        src, dst = rmat_graph(1 << scale, 16 << scale, seed=seed)
        a, b = orient_edges(src, dst)
        nv = int(max(a.max(), b.max())) + 1
        ip, ix = csr_from_edges(a, b, n_nodes=nv)
        boxes = {}
        for name in ("triangle", "path3"):
            q = patterns.PATTERNS[name]()
            eng = QueryEngine(q, relations={"E": InMemoryEdgeSource(
                ip, ix, orientation="minmax")},
                order=validate(q, None, require_consistent=True),
                mem_words=SERVE_WANT_WORDS, torch_device="cpu")
            boxes[name] = len(eng.plan().boxes)
        adj = sp.csr_matrix((np.ones(len(a), np.int64), (a, b)),
                            shape=(nv, nv))
        indeg = np.asarray(adj.sum(axis=0)).ravel()
        outdeg = np.asarray(adj.sum(axis=1)).ravel()
        print(json.dumps({
            "phase": phase, "scale": scale, "edges": int(len(a)),
            "words": SERVE_WANT_WORDS, "boxes": boxes,
            "triangles": int(adj.multiply(adj @ adj.T).sum()),
            "two_paths": int((indeg * outdeg).sum())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
