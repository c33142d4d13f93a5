"""Criteo-like synthetic generator for DLRM (train + serve batches)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class CriteoLikeGenerator:
    """Power-law categorical draws + dense log-normal features with a
    planted linear CTR signal (training examples show decreasing BCE)."""

    def __init__(self, table_sizes: Sequence[int], n_dense: int = 13,
                 hot: int = 1, seed: int = 0):
        self.table_sizes = tuple(table_sizes)
        self.n_dense = n_dense
        self.hot = hot
        self.rng = np.random.default_rng(seed)
        self.w_dense = self.rng.standard_normal(n_dense) * 0.4
        self.hot_bias = [self.rng.standard_normal(min(1000, v)) * 0.3
                         for v in self.table_sizes]

    def _zipf_draw(self, v: int, size) -> np.ndarray:
        u = self.rng.random(size)
        # truncated zipf via inverse-CDF approximation
        x = np.floor((v ** u - 1)).astype(np.int64)
        return np.clip(x, 0, v - 1)

    def batch(self, batch_size: int, with_labels: bool = True
              ) -> Dict[str, np.ndarray]:
        dense = self.rng.lognormal(0.0, 1.0,
                                   (batch_size, self.n_dense)).astype(np.float32)
        dense = np.log1p(dense)
        sparse = np.stack(
            [self._zipf_draw(v, (batch_size, self.hot))
             for v in self.table_sizes], axis=1).astype(np.int32)
        out = {"dense": dense, "sparse": sparse}
        if with_labels:
            logit = dense @ self.w_dense
            for t, bias in enumerate(self.hot_bias):
                logit += bias[np.minimum(sparse[:, t, 0], len(bias) - 1)]
            p = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
            out["labels"] = (self.rng.random(batch_size) < p).astype(np.float32)
        return out
