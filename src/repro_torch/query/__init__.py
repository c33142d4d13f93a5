"""General-purpose join subsystem: boxed, multi-worker LFTJ for arbitrary
binary-atom conjunctive queries (paper §2 generalization), on a torch
device.

``QueryEngine`` executes any validated ``core.queries.Query`` — 4-cliques,
diamonds, paths, cycles, the triangle as a special case — through the same
boxed machinery as ``core.engine.TriangleEngine``: degree-index box
planning under the Thm. 13 rank-r I/O bound (``planner``), per-atom slice
streaming over ``InMemoryEdgeSource`` with the shared worker-pool
scheduler (``executor``), and batched numpy leapfrog inner loops with the
CUDA intersect and fused kernels on the card (``vectorized``).
``patterns`` holds the canonical pattern queries.
"""

from . import patterns
from .executor import BACKENDS, QueryEngine, QueryStats, query_count
from .planner import QueryPlan, plan_query_boxes, thm13_io_bound
from .vectorized import AtomSlice, BoundAtom, VectorizedBoxJoin, \
    build_atom_slice

__all__ = [
    "BACKENDS", "QueryEngine", "QueryStats", "query_count", "QueryPlan",
    "plan_query_boxes", "thm13_io_bound", "patterns", "AtomSlice",
    "BoundAtom", "VectorizedBoxJoin", "build_atom_slice",
]
