"""Graph generators, edge sources, the host prefetch pipeline and the
Criteo-like recsys batches (``recsys``)."""
