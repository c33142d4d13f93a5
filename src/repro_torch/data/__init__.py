"""Graph generators (with the GNN batches and GraphCast's multimesh), edge
sources, the host prefetch pipeline, the GNN neighbor sampler
(``sampler``), the Criteo-like recsys batches (``recsys``) and the LM
token stream (``tokens``)."""

from .tokens import TokenStream

__all__ = ["TokenStream"]
