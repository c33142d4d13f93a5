"""graphcast [arXiv:2212.12794; unverified]: encoder-processor-decoder GNN.

n_layers=16 d_hidden=512 mesh_refinement=6 aggregator=sum n_vars=227.
On the assigned generic graph shapes the EPD stack runs over the given
graph; the native refinement-6 icosahedral multimesh (40962 nodes) is
generated by data/graphs.icosahedral_mesh for examples/weather_sim.py.
"""

from repro_torch.models.gnn import GNNConfig

from .base import GNN_SHAPES, ArchBundle, register

CONFIG = GNNConfig(
    name="graphcast", kind="graphcast", n_layers=16, d_hidden=512,
    d_in=227, d_out=227, aggregator="sum", d_edge=4)

SMOKE_CONFIG = GNNConfig(
    name="graphcast-smoke", kind="graphcast", n_layers=2, d_hidden=16,
    d_in=227, d_out=227, aggregator="sum", d_edge=4)

register(ArchBundle(
    arch_id="graphcast", family="gnn", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES,
    notes="paper technique applies at the substrate level: mesh edges are "
          "TrieArray CSR; triangle features available via core.triangle."))
