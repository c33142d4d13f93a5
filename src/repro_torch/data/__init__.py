"""Graph generators (with the GNN batches and GraphCast's multimesh), edge
sources, the host prefetch pipeline, the GNN neighbor sampler
(``sampler``) and the Criteo-like recsys batches (``recsys``)."""
