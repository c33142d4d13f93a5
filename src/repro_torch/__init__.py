"""PyTorch/CUDA port of the boxed Leapfrog-Triejoin engine.

Runs the paper's public triangle API (``count_triangles`` with the
faithful, boxed, vectorized, boxed_vec, dense, mgt and auto methods;
``list_triangles``), its out-of-core competitor MGT
(``mgt_triangle_count``), ``TriangleEngine.count()`` / ``.list()`` and
``QueryEngine`` (any binary-atom pattern: 4-clique, diamond, path, cycle)
on an in-memory graph or out of core on an on-disk ``EdgeStore`` (written
by the bounded-memory ``EdgeStoreWriter`` or ``write_edge_store*``, read
through an optional ``SliceCache``) on an NVIDIA card, with hand-written
CUDA kernels for the intersect, dense and fused lanes, and the
``embedding_bag`` entry point (``kernels/embedding_bag/ops.py``). Both
engines take ``tracer=`` / ``metrics=`` (``obs``) and ``'measured'``
density thresholds calibrated on the card. ``TriangleEngine(shard=True,
devices=[...])`` shards its boxes over several devices (or one device,
repeated), and ``Fabric`` runs a ``QueryEngine`` plan as shards, each on
only the byte ranges its boxes touch, in one process or across several
(``python -m repro_torch.parallel.fabric``). ``Server`` / ``Session``
(``serve``) keep relations warm and serve concurrent pattern queries, each
within its admitted share of one memory budget. Off the paper's path, ``models.dlrm``
serves DLRM at the full dlrm-mlperf width (``configs``), its bfloat16
tables looked up by ``embedding_bag``, ``models.gnn`` trains GCN, GIN,
SchNet and GraphCast (``GNN``) with every message-passing sum on the
hand-written sorted-sum kernel (``segment_sum``, ``gather``), and
``launch.dryrun`` plans a fabric without running it. It imports ``torch`` and
numpy only. Entry points run on the card unless the caller passes
``torch_device="cpu"`` (or CPU tensors, for ``embedding_bag``).
"""

from repro_torch.core.adversarial import adversarial_graph
from repro_torch.core.engine import (EngineStats, TriangleEngine,
                                     engine_count, engine_list,
                                     measure_dense_crossover,
                                     measure_fused_crossover,
                                     measure_intersect_crossover)
from repro_torch.core.executor import SliceCache
from repro_torch.core.mgt import mgt_triangle_count
from repro_torch.core.triangle import (brute_force_count, count_triangles,
                                       list_triangles)
from repro_torch.data.edgestore import (EdgeStore, EdgeStoreWriter,
                                        write_edge_store,
                                        write_edge_store_csr,
                                        write_edge_store_streaming)
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.launch.mesh import (fabric_mesh, maybe_init_distributed,
                                     resolve_fabric_shards)
from repro_torch.models.gnn import GNN, gather, segment_sum
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.query import QueryEngine, QueryStats, patterns, query_count
from repro_torch.serve import Server, Session

__all__ = ["EdgeStore", "EdgeStoreWriter", "EngineStats", "Fabric",
           "FabricShippingError", "GNN", "MetricsRegistry", "QueryEngine",
           "QueryStats", "Server", "Session", "ShippedEdgeSource",
           "SliceCache", "Tracer",
           "TriangleEngine", "adversarial_graph", "brute_force_count",
           "count_triangles", "embedding_bag", "engine_count", "engine_list",
           "fabric_mesh", "gather", "list_triangles", "maybe_init_distributed",
           "measure_dense_crossover", "measure_fused_crossover",
           "measure_intersect_crossover", "mgt_triangle_count", "patterns",
           "query_count", "resolve_fabric_shards", "segment_sum",
           "write_edge_store",
           "write_edge_store_csr", "write_edge_store_streaming"]

# the fabric loads on first use, so ``python -m repro_torch.parallel.fabric``
# runs its module once
_FABRIC = ("Fabric", "FabricShippingError", "ShippedEdgeSource")


def __getattr__(name):
    if name in _FABRIC:
        from repro_torch.parallel import fabric
        return getattr(fabric, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
