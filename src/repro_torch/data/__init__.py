"""Graph generators, edge sources and the host prefetch pipeline."""
