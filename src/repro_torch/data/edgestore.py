"""Edge sources behind the EdgeSource interface the streaming executor
reads from (``read_rows``, ``indptr``, ``n_nodes``, ``n_edges``).

Only the in-memory source is ported so far; the on-disk ``EdgeStore`` and
its writer come with the out-of-core slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class InMemoryEdgeSource:
    """Host (indptr, indices) arrays behind the EdgeSource interface.

    With a ``device`` attached the same block-I/O accounting applies as for
    the on-disk store (useful for modeling runs); without one, reads are
    free — pure in-memory execution.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 device=None, orientation: str = "minmax",
                 tracer=None):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.n_nodes = len(self.indptr) - 1
        self.n_edges = len(self.indices)
        self.orientation = orientation
        self.device = device
        self.tracer = tracer
        if device is not None and self.n_edges:
            device.register(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def words(self) -> int:
        return self.n_edges

    def read_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        lo = max(0, int(lo))
        hi = min(self.n_nodes - 1, int(hi))
        if hi < lo:
            return np.zeros(1, np.int64), np.zeros(0, np.int32)
        s, e = int(self.indptr[lo]), int(self.indptr[hi + 1])
        if self.device is not None and e > s:
            self.device.read_range(self.indices, s, e)
        tr = self.tracer
        if tr is not None:
            tr.event("io.read_rows", lo=lo, hi=hi, words=e - s)
        return self.indptr[lo:hi + 2] - self.indptr[lo], self.indices[s:e]
