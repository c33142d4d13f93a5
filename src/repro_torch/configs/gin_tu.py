"""gin-tu [arXiv:1810.00826; paper]: 5-layer GIN with learnable eps."""

from repro_torch.models.gnn import GNNConfig

from .base import GNN_SHAPES, ArchBundle, register

CONFIG = GNNConfig(
    name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
    d_in=30, d_out=2, aggregator="sum")

SMOKE_CONFIG = GNNConfig(
    name="gin-tu-smoke", kind="gin", n_layers=2, d_hidden=16,
    d_in=30, d_out=2, aggregator="sum")

register(ArchBundle(
    arch_id="gin-tu", family="gnn", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES,
    notes="sum aggregator; eps learnable per layer."))
