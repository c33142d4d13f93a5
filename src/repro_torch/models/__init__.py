"""Models of the port: DLRM (``dlrm``), the GNN family (``gnn``: GCN,
GIN, SchNet, GraphCast) and the layer helpers they use (``layers``)."""

from .gnn import GNN, GNNConfig, edge_orders, gather, segment_sum

__all__ = ["GNN", "GNNConfig", "edge_orders", "gather", "segment_sum"]
