"""Models of the port: DLRM (``dlrm``), the GNN family (``gnn``: GCN,
GIN, SchNet, GraphCast), the LM family (``transformer``: dense GQA, MLA
and MoE (``moe``) transformers, served by ``launch/serve.py``) and the
layers they use (``layers``)."""

from .gnn import GNN, GNNConfig, edge_orders, gather, segment_sum
from .transformer import LM, LayerSpec, TransformerConfig

__all__ = ["GNN", "GNNConfig", "LM", "LayerSpec", "TransformerConfig",
           "edge_orders", "gather", "segment_sum"]
