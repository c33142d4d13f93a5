"""Vectorized LFTJ-Δ in PyTorch: host graph preparation plus the plain
torch device primitives of the binary-search and listing lanes.

The level-z leapfrog joins of LFTJ-Δ compute |D(x) ∩ D(y)| for every edge
(x, y) of the DAG orientation (paper Alg. 1). They are batched into a
data-parallel primitive over fixed shapes:

  * neighbor lists padded to K = max out-degree, sorted, SENTINEL-terminated;
  * per edge, one row is probed into the other with a row-batched
    ``torch.searchsorted``;
  * a Python loop over edge chunks keeps peak memory at O(chunk · K).

Every function that takes tensors runs on the device its inputs live on;
counts are int64 throughout. ``triangle_count_dense`` is the dense
formulation Σ A ⊙ (A Aᵀ) (``kernels/triangle_dense`` is its kernel).
``triangle_count_vectorized`` and ``triangle_count_boxed_vectorized`` are
the whole-graph entry points (numpy edges in, a count out) on
``torch_device``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.graphs import unique_pairs

SENTINEL = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# host-side graph preparation (numpy)
# ---------------------------------------------------------------------------

def orient_edges(src: np.ndarray, dst: np.ndarray,
                 mode: str = "minmax") -> Tuple[np.ndarray, np.ndarray]:
    """Make the undirected graph a DAG (paper §2.3 G*).

    'minmax'  — (min, max) per edge: the paper's orientation.
    'degree'  — lower-degree endpoint first (ties by id): the standard
                out-degree ≤ O(√|E|) bound, which caps the padded width K.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if mode == "minmax":
        a = np.minimum(src, dst)
        b = np.maximum(src, dst)
    elif mode == "degree":
        n = int(max(src.max(initial=0), dst.max(initial=0))) + 1
        deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
        key_s = deg[src] * (n + 1) + src
        key_d = deg[dst] * (n + 1) + dst
        swap = key_s > key_d
        a = np.where(swap, dst, src)
        b = np.where(swap, src, dst)
    else:
        raise ValueError(mode)
    return unique_pairs(a, b)


def csr_from_edges(src: np.ndarray, dst: np.ndarray,
                   n_nodes: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, indices) with sorted rows — the TrieArray of E."""
    if n_nodes is None:
        n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, dst.astype(np.int32)


def pad_neighbors(indptr: np.ndarray, indices: np.ndarray,
                  k: Optional[int] = None) -> np.ndarray:
    """(V, K) padded, sorted neighbor matrix with SENTINEL fill.

    ``k`` < max degree would silently drop neighbors (and miscount every
    downstream intersection), so it is a hard error; rows that must be
    capped belong in ``pad_neighbors_binned``.
    """
    n = len(indptr) - 1
    deg = np.diff(indptr)
    if k is None:
        k = int(deg.max(initial=1))
    k = max(int(k), 1)
    if deg.max(initial=0) > k:
        raise ValueError(
            f"pad_neighbors: k={k} < max degree {int(deg.max())}; this would "
            "silently truncate neighbor lists. Pass k=None or use "
            "pad_neighbors_binned for degree-capped rows.")
    out = np.full((n, k), SENTINEL, dtype=np.int32)
    for_rows = np.repeat(np.arange(n), deg)
    cols = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
    out[for_rows, cols] = indices
    return out


def bin_layout(deg: np.ndarray, bin_growth: int = 4
               ) -> Tuple[np.ndarray, List[int]]:
    """``(row_bin, widths)`` of the degree bins: bin b holds the rows of
    degree in (widths[b] / bin_growth, widths[b]] (degree 1 in bin 0),
    widths are the powers of ``bin_growth`` up to the first that reaches
    the largest degree, and degree-0 rows are in bin -1. It needs the
    degrees only, so a lane can charge the bins' padded words without
    building them."""
    row_bin = np.full(len(deg), -1, dtype=np.int64)
    widths: List[int] = []
    if len(deg) and int(deg.max()) > 0:
        k, kmax = 1, int(deg.max())
        while True:
            widths.append(k)
            if k >= kmax:
                break
            k *= bin_growth
        for b, khi in enumerate(widths):
            klo = khi // bin_growth + 1 if khi > 1 else 1
            row_bin[(deg >= klo) & (deg <= khi)] = b
    return row_bin, widths


def pad_neighbors_binned(indptr: np.ndarray, indices: np.ndarray,
                         bin_growth: int = 4):
    """Degree-binned padding: rows grouped into power-of-``bin_growth`` width
    classes (``bin_layout``) so the per-bin K caps the O(V·K_max) padding
    waste on skewed graphs (a hub no longer forces every row to its width).

    Returns ``(row_bin, bins)`` where ``row_bin[v]`` is the bin id of vertex
    v and ``bins[i] = (rows, npad)`` holds the vertex ids in bin i plus
    their (len(rows), K_i) padded neighbor matrix. Vertices with degree 0
    get bin -1 (they cannot participate in any intersection).
    """
    deg = np.diff(indptr)
    row_bin, widths = bin_layout(deg, bin_growth)
    bins = []
    for b, khi in enumerate(widths):
        rows = np.flatnonzero(row_bin == b)
        npad = np.full((len(rows), khi), SENTINEL, dtype=np.int32)
        if len(rows):
            d = deg[rows]
            rr = np.repeat(np.arange(len(rows)), d)
            cc = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
            npad[rr, cc] = indices[np.repeat(indptr[rows], d) + cc]
        bins.append((rows, npad))
    return row_bin, bins


# ---------------------------------------------------------------------------
# intersection primitives (plain torch, on the inputs' device)
# ---------------------------------------------------------------------------

def _row_intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row |a_i ∩ b_i| (int64) for sorted SENTINEL-padded rows: every
    entry of ``a`` is binary-searched in the matching row of ``b``."""
    if a.shape[1] == 0 or b.shape[1] == 0:
        return torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    pos = torch.searchsorted(b, a).clamp_(max=b.shape[1] - 1)
    hit = (torch.gather(b, 1, pos) == a) & (a != SENTINEL)
    return hit.sum(dim=1)


def _chunk_widths(npad: torch.Tensor, eu: torch.Tensor, ev: torch.Tensor,
                  chunk: int, deg: Optional[torch.Tensor]) -> List[List[int]]:
    """[[ka, kb]] per edge chunk: the widest real row on each side. Columns
    past it hold only SENTINEL in every row of the chunk, so a probe
    trimmed to them gives the same hits as the full padded width. ``deg``
    (per-row real lengths) is counted from ``npad`` when not given. One
    host sync for the whole edge list."""
    if deg is None:
        deg = (npad != SENTINEL).sum(dim=1)
    m = eu.shape[0]
    n = -(-m // chunk)
    pad = n * chunk - m
    du = torch.nn.functional.pad(deg[eu], (0, pad)).view(n, chunk).amax(1)
    dv = torch.nn.functional.pad(deg[ev], (0, pad)).view(n, chunk).amax(1)
    return torch.stack([du, dv], 1).tolist()


def _count_chunked(npad: torch.Tensor, eu: torch.Tensor, ev: torch.Tensor,
                   chunk: int = 2048,
                   deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_edges |N(u) ∩ N(v)| over fixed-size edge chunks (0-d int64).

    Each chunk is trimmed to its widest real rows (``deg``: per-row real
    lengths of ``npad``, counted when not given) and the narrower side is
    probed into the wider — the min(d_x, d_y) accounting of Thm. 17; rows
    are sets, so the count equals the full-width probe of ``npad[u]`` into
    ``npad[v]``.
    """
    m = eu.shape[0]
    total = torch.zeros((), dtype=torch.int64, device=npad.device)
    if m == 0:
        return total
    widths = _chunk_widths(npad, eu, ev, chunk, deg)
    for i, s in enumerate(range(0, m, chunk)):
        ka, kb = widths[i]
        if min(ka, kb) == 0:
            continue
        a, b = npad[eu[s:s + chunk], :ka], npad[ev[s:s + chunk], :kb]
        if a.shape[1] > b.shape[1]:
            a, b = b, a
        total += _row_intersect_count(a, b).sum()
    return total


def _count_rows_chunked(a_rows: torch.Tensor, b_rows: torch.Tensor,
                        chunk: int = 2048) -> torch.Tensor:
    """Σ_i |a_rows[i] ∩ b_rows[i]| for pre-gathered row pairs (0-d int64).

    The two sides may have different padded widths (degree-binned
    padding): the narrower rows are probed into the wider with
    ``torch.searchsorted``, the min(d_x, d_y) accounting of Thm. 17.
    All-SENTINEL rows add zero. The reference's total is int32; this one
    is int64.
    """
    if a_rows.shape[1] > b_rows.shape[1]:      # intersection is symmetric
        a_rows, b_rows = b_rows, a_rows
    total = torch.zeros((), dtype=torch.int64, device=a_rows.device)
    for s in range(0, a_rows.shape[0], chunk):
        total += _row_intersect_count(a_rows[s:s + chunk],
                                      b_rows[s:s + chunk]).sum()
    return total


# ---------------------------------------------------------------------------
# listing (enumeration) — bounded output buffer, overflow detected by caller
# ---------------------------------------------------------------------------

def _write_hits(buf: torch.Tensor, total: int, cap: int, a: torch.Tensor,
                b: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> int:
    """Probe every row of ``a`` into the matching row of ``b`` (sorted,
    SENTINEL-padded) and write each hit z as the row (u[r], v[r], z) of
    ``buf``, from slot ``total`` on, in row then z order; slots at or past
    ``cap`` land on the spill row ``buf[cap]``. Returns the number of
    hits."""
    pos = torch.searchsorted(b, a).clamp_(max=b.shape[1] - 1)
    hit = (torch.gather(b, 1, pos) == a) & (a != SENTINEL)
    r, c = hit.nonzero(as_tuple=True)          # row-major: edge, then z
    n_hit = int(r.shape[0])
    if n_hit:
        slot = torch.arange(total, total + n_hit, device=buf.device) \
            .clamp_(max=cap)
        buf[slot] = torch.stack([u[r].to(torch.int32), v[r].to(torch.int32),
                                 a[r, c]], dim=1)
    return n_hit


def _list_chunked(npad: torch.Tensor, eu: torch.Tensor, ev: torch.Tensor,
                  cap: int, chunk: int = 1024,
                  deg: Optional[torch.Tensor] = None
                  ) -> Tuple[int, torch.Tensor]:
    """Enumerate triangles (u, v, z) with z ∈ N(u) ∩ N(v) for each edge.

    Returns ``(total, buf)`` where ``buf`` is a (cap, 3) int32 tensor
    holding the first ``min(total, cap)`` triangles in traversal order
    (edge order, then z ascending) and zeros after them. ``total`` is
    always the exact count: when ``total > cap`` the buffer overflowed and
    the caller rescans with a larger cap (the engine's overflow→rescan
    protocol). Each hit lands at its exclusive prefix position; positions
    at or past ``cap`` go to one spill row past the end, which is cut off.
    Chunks are trimmed as in ``_count_chunked``: both rows are sorted sets,
    so the hits of either side, in order, are the same z sequence.
    """
    dev = npad.device
    buf = torch.zeros((cap + 1, 3), dtype=torch.int32, device=dev)
    m = eu.shape[0]
    total = 0
    if m == 0:
        return total, buf[:cap]
    widths = _chunk_widths(npad, eu, ev, chunk, deg)
    for i, s in enumerate(range(0, m, chunk)):
        ka, kb = widths[i]
        if min(ka, kb) == 0:
            continue
        u, v = eu[s:s + chunk], ev[s:s + chunk]
        a, b = npad[u, :ka], npad[v, :kb]
        if a.shape[1] > b.shape[1]:
            a, b = b, a
        total += _write_hits(buf, total, cap, a, b, u, v)
    return total, buf[:cap]


def _list_csr_chunked(off: torch.Tensor, vals: torch.Tensor,
                      eu: torch.Tensor, ev: torch.Tensor, cap: int,
                      chunk: int = 1024) -> Tuple[int, torch.Tensor]:
    """``_list_chunked`` over a compact CSR (int64 offsets ``off``, sorted
    int32 rows ``vals``) instead of a padded matrix: each edge chunk
    gathers only its own rows, as wide as the chunk's widest one, so
    memory is O(chunk · K) and no (rows, K) matrix is ever built. Same
    ``(total, buf)``, traversal order and spill row; ``eu``/``ev`` are
    int64 row ids, emitted as they are."""
    from repro_torch.kernels.intersect.ref import _tile

    dev = vals.device
    buf = torch.zeros((cap + 1, 3), dtype=torch.int32, device=dev)
    m = eu.shape[0]
    total = 0
    if m == 0:
        return total, buf[:cap]
    deg = off[1:] - off[:-1]
    n = -(-m // chunk)
    pad = n * chunk - m
    du = torch.nn.functional.pad(deg[eu], (0, pad)).view(n, chunk).amax(1)
    dv = torch.nn.functional.pad(deg[ev], (0, pad)).view(n, chunk).amax(1)
    for i, (ka, kb) in enumerate(torch.stack([du, dv], 1).tolist()):
        if min(ka, kb) == 0:
            continue
        u, v = eu[i * chunk:(i + 1) * chunk], ev[i * chunk:(i + 1) * chunk]
        a, b = _tile(off, vals, u, deg[u], ka), _tile(off, vals, v, deg[v], kb)
        if a.shape[1] > b.shape[1]:
            a, b = b, a
        total += _write_hits(buf, total, cap, a, b, u, v)
    return total, buf[:cap]


def _list_pairs_chunked(npa: torch.Tensor, npb: torch.Tensor,
                        eu: torch.Tensor, ev: torch.Tensor,
                        us: torch.Tensor, vs: torch.Tensor,
                        cap: int, chunk: int = 1024
                        ) -> Tuple[int, torch.Tensor]:
    """Enumerate (us[i], vs[i], z) with z ∈ npa[eu[i]] ∩ npb[ev[i]].

    The degree-binned listing analogue of ``_count_rows_chunked`` +
    ``_list_chunked``: the two padded neighbor matrices may have different
    widths (per-bin K), the narrower side is probed into the wider (the
    sides swap when ``npa`` is the wider, as in the reference), and the
    emitted triangle carries the caller-supplied *global* edge endpoints
    ``us``/``vs``, so no local-row remap is needed afterwards. Edges whose
    row is all SENTINEL on either side contribute nothing. Returns
    ``(total, buf)``: the exact total as a Python int (the reference's is
    int32) and a (cap, 3) int32 buffer holding the first ``min(total,
    cap)`` triangles in traversal order (edge, then z ascending) and zeros
    after them; positions at or past ``cap`` go to a spill row that is cut
    off, so the caller rescans on ``total > cap``.
    """
    if npa.shape[1] > npb.shape[1]:     # z values are symmetric in a∩b
        npa, npb = npb, npa
        eu, ev = ev, eu
    buf = torch.zeros((cap + 1, 3), dtype=torch.int32, device=npa.device)
    total = 0
    if npa.shape[1] == 0 or npb.shape[1] == 0:
        return total, buf[:cap]
    for s in range(0, eu.shape[0], chunk):
        a = npa[eu[s:s + chunk].long()]
        b = npb[ev[s:s + chunk].long()]
        total += _write_hits(buf, total, cap, a, b, us[s:s + chunk],
                             vs[s:s + chunk])
    return total, buf[:cap]


def triangle_count_vectorized(src: np.ndarray, dst: np.ndarray,
                              orientation: str = "minmax",
                              chunk: int = 2048,
                              torch_device="cuda") -> int:
    """End-to-end vectorized LFTJ-Δ triangle count of an undirected graph:
    Σ over the oriented edges (u, v) of |N(u) ∩ N(v)|.

    On the CPU it is the plain ``_count_chunked`` over the padded neighbor
    matrix, as in the reference. On the card it is ONE
    ``intersect_count_csr`` launch over the oriented CSR at every edge:
    the reference's matrix is as wide as the widest row, which at RMAT
    scale 20 under minmax cannot fit on a card. The total is int64 (the
    reference's is int32 without x64).
    """
    from repro_torch.kernels.intersect import ops as intersect_ops

    from .engine import resolve_torch_device
    dev = resolve_torch_device(torch_device)
    a, b = orient_edges(src, dst, orientation)
    indptr, indices = csr_from_edges(a, b)
    eu = torch.from_numpy(a.astype(np.int64)).to(dev)
    ev = torch.from_numpy(b.astype(np.int64)).to(dev)
    if dev.type == "cuda":
        off = torch.from_numpy(indptr).to(dev)
        vals = torch.from_numpy(indices).to(dev)
        return int(intersect_ops.intersect_count_csr(off, vals, eu, off,
                                                     vals, ev))
    npad = torch.from_numpy(pad_neighbors(indptr, indices)).to(dev)
    return int(_count_chunked(npad, eu, ev, chunk=chunk))


# ---------------------------------------------------------------------------
# dense formulation
# ---------------------------------------------------------------------------

def triangle_count_dense(adj: torch.Tensor) -> torch.Tensor:
    """Σ A ⊙ (A Aᵀ) for a dense 0/1 DAG adjacency block (0-d int64).

    The product runs in float64, so it is exact while every partial sum
    stays below 2^53 (TF32 never applies to float64 products).
    """
    a = adj.to(torch.float64)
    return (a * (a @ a.T)).sum().to(torch.int64)


def dense_adjacency(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=np.float32)
    adj[src, dst] = 1.0
    return adj


# ---------------------------------------------------------------------------
# per-box execution (the legacy single-host entry point)
# ---------------------------------------------------------------------------

def triangle_count_boxed_vectorized(src: np.ndarray, dst: np.ndarray,
                                    mem_words: int,
                                    orientation: str = "minmax",
                                    dense_threshold: float = 0.05,
                                    chunk: int = 2048,
                                    torch_device="cuda") -> Tuple[int, dict]:
    """Boxed execution with the per-box lanes of ``core.engine.
    TriangleEngine`` (box plan from the paper's prober, per-box lane
    dispatch). Returns ``(count, info)``."""
    from .engine import TriangleEngine

    eng = TriangleEngine(src, dst, mem_words=mem_words,
                         orientation=orientation,
                         dense_threshold=dense_threshold,
                         chunk=chunk, shard=False,
                         torch_device=torch_device)
    count = eng.count()
    return count, eng.stats.as_info()
