"""Adversarial instance G_N of paper Prop. 4 (§3, Fig. 12).

E = {(x, y) | x = 0..N, y = N - B·(x mod T)},  T = M/B + 1.

Second-column values are spaced B words apart so every level-z lookup of
vanilla LFTJ touches a distinct block, and they repeat in groups of T —
one more than fits in the cache — so LRU evicts each block just before its
reuse. Vanilla LFTJ-Δ therefore incurs ≥ 2|E| block I/Os (thrashing);
boxed LFTJ reads the input O(|E|/M) times sequentially instead.
"""

from __future__ import annotations

import numpy as np


def adversarial_graph(n_edges: int, mem_words: int, block_words: int):
    """Return (src, dst) of G_N. Requires N >= M + B (paper)."""
    n = int(n_edges)
    m, b = int(mem_words), int(block_words)
    if n < m + b:
        raise ValueError(f"need N >= M + B (N={n}, M={m}, B={b})")
    t = m // b + 1
    x = np.arange(n + 1, dtype=np.int64)
    y = n - b * (x % t)
    return x, y
