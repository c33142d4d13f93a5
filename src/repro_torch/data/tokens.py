"""Synthetic LM token pipeline: deterministic, shardable, packed sequences.
The port of ``src/repro/data/tokens.py`` (numpy only): the same arrays,
bit for bit, for the same vocab and seed.

A Zipfian unigram stream with injected bigram structure — enough signal
that the end-to-end training example shows a falling loss, while remaining
fully reproducible offline (no datasets ship with the container).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenStream:
    """Deterministic pseudo-corpus: Zipf unigrams + Markov bigram signal."""

    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()
        # sparse deterministic bigram table: each token prefers a successor
        self.succ = (np.arange(vocab) * 31 + 17) % vocab

    def batch(self, batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
        draws = self.rng.choice(self.vocab, size=(batch_size, seq_len + 1),
                                p=self.p)
        # 50% of positions follow the bigram successor of the previous token
        follow = self.rng.random((batch_size, seq_len)) < 0.5
        toks = draws.copy()
        for t in range(1, seq_len + 1):
            toks[:, t] = np.where(follow[:, t - 1],
                                  self.succ[toks[:, t - 1]], draws[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def batches(self, batch_size: int, seq_len: int, n: int
                ) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n):
            yield self.batch(batch_size, seq_len)
