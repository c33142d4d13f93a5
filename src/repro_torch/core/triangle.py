"""Public triangle-listing API (the paper's workload, all altitudes).

    count_triangles(src, dst, method=...)   -> int
    list_triangles(src, dst)                -> (m, 3) array

methods:
  'faithful'    exact sequential LFTJ-Δ (paper Alg. 1/4) on the host
  'boxed'       boxed LFTJ-Δ (paper Alg. 2) with memory budget, on the host
  'vectorized'  every edge's |N(u) ∩ N(v)| at once: one intersect kernel
                launch over the oriented CSR on the card
  'boxed_vec'   box plan from the paper's prober + ``TriangleEngine``'s
                per-box lanes
  'dense'       Σ A ⊙ (A Aᵀ): the ``triangle_dense`` kernel on the card
                (small/dense graphs)
  'mgt'         the specialized out-of-core competitor [10]
  'auto'        vectorized, falling back to boxed_vec when a memory budget
                is given and the input exceeds it

``torch_device`` (default ``"cuda"``, raising without a card; or
``"cpu"``) is where the vectorized, boxed_vec, dense and mgt methods run;
on the CPU the kernels' plain versions run. Counts are exact int64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.triangle_dense import ops as dense_ops

from .boxing import boxed_triangle_count
from .engine import resolve_torch_device
from .iomodel import BlockDevice, CountingReader
from .leapfrog import lftj_triangle_count
from .lftj_torch import (dense_adjacency, orient_edges,
                         triangle_count_boxed_vectorized,
                         triangle_count_dense, triangle_count_vectorized)
from .mgt import mgt_triangle_count
from .triearray import TrieArray


def _oriented_ta(src, dst, orientation="minmax") -> TrieArray:
    a, b = orient_edges(src, dst, orientation)
    return TrieArray.from_edges(a, b)


def _count_dense(a: np.ndarray, b: np.ndarray, dev: torch.device) -> int:
    """Σ A ⊙ (A Aᵀ) of the oriented graph's n × n adjacency: on the card
    one ``triangle_dense`` call on the uint8 adjacency built there, on the
    CPU the plain float64 product."""
    n = int(max(a.max(initial=0), b.max(initial=0))) + 1
    if dev.type == "cuda":
        adj = torch.zeros((n, n), dtype=torch.uint8, device=dev)
        adj[torch.from_numpy(a.astype(np.int64)).to(dev),
            torch.from_numpy(b.astype(np.int64)).to(dev)] = 1
        return int(dense_ops.triangle_count(adj, adj, adj))
    return int(triangle_count_dense(torch.from_numpy(dense_adjacency(a, b,
                                                                     n))))


def count_triangles(src: np.ndarray, dst: np.ndarray,
                    method: str = "auto",
                    mem_words: Optional[int] = None,
                    device: Optional[BlockDevice] = None,
                    orientation: str = "minmax",
                    torch_device="cuda") -> int:
    src = np.asarray(src)
    dst = np.asarray(dst)
    dev = resolve_torch_device(torch_device)
    if method == "auto":
        ta_words = 0
        if mem_words is not None:
            ta_words = _oriented_ta(src, dst, orientation).words()
        if mem_words is not None and ta_words > mem_words:
            method = "boxed_vec"
        else:
            method = "vectorized"
    if method == "faithful":
        ta = _oriented_ta(src, dst, orientation)
        if device is not None:
            device.register_triearray(ta)
        return lftj_triangle_count(ta, reader=CountingReader(device))
    if method == "boxed":
        ta = _oriented_ta(src, dst, orientation)
        mw = mem_words if mem_words is not None else max(64, ta.words())
        cnt, _ = boxed_triangle_count(ta, mw, device=device)
        return cnt
    if method == "vectorized":
        return triangle_count_vectorized(src, dst, orientation,
                                         torch_device=dev)
    if method == "boxed_vec":
        mw = mem_words if mem_words is not None else 1 << 20
        cnt, _ = triangle_count_boxed_vectorized(src, dst, mw, orientation,
                                                 torch_device=dev)
        return cnt
    if method == "dense":
        a, b = orient_edges(src, dst, orientation)
        return _count_dense(a, b, dev)
    if method == "mgt":
        mw = mem_words if mem_words is not None else 1 << 20
        # minmax, whatever ``orientation`` says, as in the reference
        cnt, _ = mgt_triangle_count(src, dst, mw, device=device,
                                    torch_device=dev)
        return cnt
    raise ValueError(f"unknown method {method!r}")


def list_triangles(src: np.ndarray, dst: np.ndarray,
                   mem_words: Optional[int] = None) -> np.ndarray:
    """Enumerate triangles (a < b < c) via (boxed) LFTJ-Δ on the host."""
    out = []
    ta = _oriented_ta(src, dst)
    if mem_words is None or ta.words() <= mem_words:
        lftj_triangle_count(ta, emit=out.append)
    else:
        boxed_triangle_count(ta, mem_words, emit=out.append)
    return np.asarray(out, dtype=np.int64).reshape(-1, 3)


def brute_force_count(src: np.ndarray, dst: np.ndarray) -> int:
    """O(V³)-ish oracle for tests (small graphs only)."""
    a, b = orient_edges(src, dst)
    n = int(max(a.max(initial=0), b.max(initial=0))) + 1
    adj = np.zeros((n, n), dtype=bool)
    adj[a, b] = True
    cnt = 0
    for x, y in zip(a, b):
        cnt += int(np.sum(adj[x] & adj[y]))
    return cnt
