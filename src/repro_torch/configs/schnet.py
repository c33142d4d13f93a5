"""schnet [arXiv:1706.08566; paper]: continuous-filter conv GNN.

n_interactions=3 d_hidden=64 rbf=300 cutoff=10. On shapes without
positions, unit distances are synthesized (DESIGN.md §Arch-applicability).
"""

from repro_torch.models.gnn import GNNConfig

from .base import GNN_SHAPES, ArchBundle, register

CONFIG = GNNConfig(
    name="schnet", kind="schnet", n_layers=3, d_hidden=64,
    d_in=30, d_out=1, n_rbf=300, cutoff=10.0)

SMOKE_CONFIG = GNNConfig(
    name="schnet-smoke", kind="schnet", n_layers=2, d_hidden=16,
    d_in=30, d_out=1, n_rbf=16, cutoff=10.0)

register(ArchBundle(
    arch_id="schnet", family="gnn", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES,
    notes="triplet-gather regime (kernel_taxonomy B.3); the RBF filter "
          "MLP dominates flops on molecule batches."))
