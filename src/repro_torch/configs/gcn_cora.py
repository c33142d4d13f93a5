"""gcn-cora [arXiv:1609.02907; paper]: 2-layer GCN, sym-normalized."""

from repro_torch.models.gnn import GNNConfig

from .base import GNN_SHAPES, ArchBundle, register

CONFIG = GNNConfig(
    name="gcn-cora", kind="gcn", n_layers=2, d_hidden=16,
    d_in=1433, d_out=7, aggregator="mean")

SMOKE_CONFIG = GNNConfig(
    name="gcn-cora-smoke", kind="gcn", n_layers=2, d_hidden=8,
    d_in=1433, d_out=7, aggregator="mean")

register(ArchBundle(
    arch_id="gcn-cora", family="gnn", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES,
    notes="norm=sym; d_hidden=16 means full-batch cells are wholly "
          "bandwidth/collective bound — a roofline stress case."))
