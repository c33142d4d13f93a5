"""PyTorch/CUDA port of the boxed Leapfrog-Triejoin engine.

Runs ``TriangleEngine.count()`` / ``.list()`` and ``QueryEngine`` (any
binary-atom pattern: 4-clique, diamond, path, cycle) on an in-memory graph
on an NVIDIA card, with hand-written CUDA kernels for the intersect, dense
and fused lanes, and the ``embedding_bag`` entry point
(``kernels/embedding_bag/ops.py``). It imports ``torch`` and numpy only.
Entry points run on the card unless the caller passes
``torch_device="cpu"`` (or CPU tensors, for ``embedding_bag``).
"""

from repro_torch.core.engine import (EngineStats, TriangleEngine,
                                     engine_count, engine_list)
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.query import QueryEngine, QueryStats, patterns, query_count

__all__ = ["EngineStats", "QueryEngine", "QueryStats", "TriangleEngine",
           "embedding_bag", "engine_count", "engine_list", "patterns",
           "query_count"]
