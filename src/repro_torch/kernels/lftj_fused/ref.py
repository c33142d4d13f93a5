"""Plain versions of the fused per-box LFTJ lane: the scalar numpy oracle
``fused_ref`` and the plain PyTorch count and listing programs.

An atom is a box-restricted binary relation; ``atom_dims[i] = (first_dim,
second_dim)`` places atom ``i`` in the variable order (``first_dim <
second_dim``). Semantics per depth ``d >= 1``: candidates are the
adjacency row of the first atom bound at ``d`` (first atom with
``second_dim == d``), pruned by row membership in every further bound
atom; a depth no atom binds (a *starts-only* depth) takes a
binding-independent constant row. Depth 0 candidates are the key-set
intersection of the atoms starting at 0. A binding whose row is absent
from a later atom's key set gathers an empty row there and dies at that
atom's ``second_dim``.

* ``fused_ref`` is the reference package's scalar oracle, copied: a
  depth-first recursion over compact-CSR triples ``(keys, off, vals)``.
* ``fused_count_ref`` / ``fused_list_ref`` take the padded layout of the
  reference's fused listing program: SENTINEL-padded sorted keys ``(R,)``
  and adjacency ``(R, K)`` int32 per atom, a depth-0 frontier ``(T,)`` and
  one SENTINEL-padded constant row per starts-only depth. Rows are looked
  up and probed with row-batched ``torch.searchsorted``; counts are int64.
  The fused wrapper runs them for CPU tensors, and ``chip_smoke.py`` holds
  the CUDA kernel against ``fused_count_ref`` on the card.

``fused_list_ref`` emits in the reference program's order, which is not
``fused_ref``'s depth-first order: that program walks the candidate slots
of depths 1..n-2 for all depth-0 rows at once and flattens the innermost
``(T, K)`` block row-major, so bindings are ordered by (slot_1, ...,
slot_{n-2}, depth-0 row, innermost slot).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SENTINEL = 2 ** 31 - 1

# elements per gathered (rows, K) temporary of the plain torch programs
_CHUNK_ELEMS = 1 << 23


def _row(csr, v: int) -> np.ndarray:
    keys, off, vals = csr
    i = int(np.searchsorted(keys, v))
    if i >= len(keys) or keys[i] != v:
        return np.zeros(0, np.int64)
    return np.asarray(vals[off[i]:off[i + 1]], dtype=np.int64)


def fused_ref(atom_dims: Sequence[Tuple[int, int]],
              atom_csrs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              n_vars: int, mode: str = "count",
              ) -> Tuple[int, Optional[np.ndarray]]:
    """(exact count, bindings or None) of the box join.

    ``mode == "list"`` materializes every binding as a row of an
    ``(count, n_vars)`` int64 matrix, in depth-first binding order."""
    by_second: List[List[int]] = [[] for _ in range(n_vars)]
    by_first: List[List[int]] = [[] for _ in range(n_vars)]
    for ai, (fd, sd) in enumerate(atom_dims):
        if not 0 <= fd < sd < n_vars:
            raise ValueError(f"atom {ai}: bad dims ({fd}, {sd})")
        by_second[sd].append(ai)
        by_first[fd].append(ai)

    def key_intersection(d: int) -> np.ndarray:
        cand: Optional[np.ndarray] = None
        for ai in by_first[d]:
            keys = np.asarray(atom_csrs[ai][0], dtype=np.int64)
            cand = keys if cand is None else cand[np.isin(cand, keys)]
        return cand if cand is not None else np.zeros(0, np.int64)

    cand0 = key_intersection(0)
    count = 0
    rows: List[List[int]] = []

    def expand(d: int, binding: List[int]) -> np.ndarray:
        if not by_second[d]:
            # starts-only depth: binding-independent constant candidates
            return key_intersection(d)
        cand: Optional[np.ndarray] = None
        for ai in by_second[d]:
            r = _row(atom_csrs[ai], binding[atom_dims[ai][0]])
            cand = r if cand is None else cand[np.isin(cand, r)]
            if len(cand) == 0:
                break
        return cand if cand is not None else np.zeros(0, np.int64)

    def rec(d: int, binding: List[int]) -> None:
        nonlocal count
        cand = expand(d, binding)
        if d == n_vars - 1:
            count += len(cand)
            if mode == "list":
                for v in cand:
                    rows.append(binding + [int(v)])
            return
        for v in cand:
            rec(d + 1, binding + [int(v)])

    for v in cand0:
        rec(1, [int(v)])

    if mode != "list":
        return count, None
    out = (np.asarray(rows, dtype=np.int64).reshape(count, n_vars)
           if count else np.zeros((0, n_vars), np.int64))
    return count, out


# ---------------------------------------------------------------------------
# plain torch programs over the padded layout
# ---------------------------------------------------------------------------

def _by_dims(atom_dims, n_vars):
    by_second: List[List[int]] = [[] for _ in range(n_vars)]
    by_first: List[List[int]] = [[] for _ in range(n_vars)]
    for ai, (fd, sd) in enumerate(atom_dims):
        by_second[sd].append(ai)
        by_first[fd].append(ai)
    return by_second, by_first


def _lookup(keys: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row index of each ``v`` in the sorted key vector, -1 when absent
    (SENTINEL never matches)."""
    if keys.numel() == 0:
        return torch.full(v.shape, -1, dtype=torch.int64, device=v.device)
    pos = torch.searchsorted(keys, v).clamp_(max=keys.numel() - 1)
    ok = (keys[pos] == v) & (v != SENTINEL)
    return torch.where(ok, pos, torch.full_like(pos, -1))


def _gather(adj: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, K) adjacency rows of the row indices ``idx``; -1 -> SENTINEL."""
    if adj.shape[0] == 0:
        return torch.full((idx.numel(), adj.shape[1]), SENTINEL,
                          dtype=adj.dtype, device=adj.device)
    return adj[idx.clamp(min=0)].masked_fill_((idx < 0)[:, None], SENTINEL)


def _member(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row membership ``a[i, j] in b[i, :]`` of sorted SENTINEL-padded
    rows (a SENTINEL entry is never a member)."""
    if b.shape[1] == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    pos = torch.searchsorted(b, a).clamp_(max=b.shape[1] - 1)
    return (torch.gather(b, 1, pos) == a) & (a != SENTINEL)


def _walk(atom_dims, c0, atoms, consts, n_vars: int,
          emit: Callable, keep_bindings: bool) -> None:
    """Breadth-first frontier walk of the whole loop nest, chunked so each
    gathered (rows, K) temporary holds at most ``_CHUNK_ELEMS`` entries.
    ``emit(row0, vals, slots, cand)`` receives each innermost block: the
    depth-0 row of every frontier entry, its bound values and candidate
    slots at depths 1..n-2 (when ``keep_bindings``), and the innermost
    candidate rows with pruned slots set to SENTINEL."""
    by_second, by_first = _by_dims(atom_dims, n_vars)
    so_depths = [d for d in range(1, n_vars - 1) if not by_second[d]]

    def width(d: int) -> int:
        if not by_second[d]:
            return int(consts[so_depths.index(d)].numel())
        return max(int(atoms[ai][1].shape[1]) for ai in by_second[d])

    def candidates(d: int, idx: Dict[int, torch.Tensor], n: int):
        if not by_second[d]:
            c = consts[so_depths.index(d)]
            return c[None, :].expand(n, c.numel())
        first = by_second[d][0]
        cand = _gather(atoms[first][1], idx[first])
        for ai in by_second[d][1:]:
            hit = _member(cand, _gather(atoms[ai][1], idx[ai]))
            cand = cand.masked_fill(~hit, SENTINEL)
        return cand

    def rec(d: int, row0, vals, slots, idx) -> None:
        n = int(row0.numel())
        if n == 0:
            return
        step = max(1, _CHUNK_ELEMS // max(1, width(d)))
        for s in range(0, n, step):
            sl = slice(s, s + step)
            sub = {ai: t[sl] for ai, t in idx.items()}
            r0 = row0[sl]
            cand = candidates(d, sub, int(r0.numel()))
            if d == n_vars - 1:
                emit(r0, [v[sl] for v in vals], [j[sl] for j in slots],
                     cand)
                continue
            i, j = torch.nonzero(cand != SENTINEL, as_tuple=True)
            v = cand[i, j]
            nxt = {ai: t[i] for ai, t in sub.items()}
            for ai in by_first[d]:
                nxt[ai] = _lookup(atoms[ai][0], v)
            if keep_bindings:
                rec(d + 1, r0[i], [x[sl][i] for x in vals] + [v],
                    [x[sl][i] for x in slots] + [j], nxt)
            else:
                rec(d + 1, r0[i], [], [], nxt)

    live = c0 != SENTINEL
    row0 = torch.nonzero(live, as_tuple=True)[0]
    v0 = c0[row0]
    idx0 = {ai: _lookup(atoms[ai][0], v0) for ai in by_first[0]}
    rec(1, row0, [v0] if keep_bindings else [], [], idx0)


def fused_count_ref(atom_dims: Sequence[Tuple[int, int]],
                    c0: torch.Tensor,
                    atoms: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    consts: Sequence[torch.Tensor],
                    n_vars: int) -> torch.Tensor:
    """(T,) int64 per-depth-0-row binding counts of the box join.

    ``c0`` (T,) int32 is the depth-0 frontier (SENTINEL rows count 0);
    ``atoms[i] = (keys (R_i,), adj (R_i, K_i))`` int32, SENTINEL-padded and
    sorted; ``consts`` holds one SENTINEL-padded sorted row per starts-only
    depth, in depth order."""
    counts = torch.zeros(c0.numel(), dtype=torch.int64, device=c0.device)

    def emit(row0, _vals, _slots, cand):
        counts.index_add_(0, row0,
                          (cand != SENTINEL).sum(dim=1, dtype=torch.int64))

    _walk(atom_dims, c0, atoms, consts, n_vars, emit, keep_bindings=False)
    return counts


def fused_list_ref(atom_dims: Sequence[Tuple[int, int]],
                   c0: torch.Tensor,
                   atoms: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   consts: Sequence[torch.Tensor],
                   n_vars: int, capacity: int
                   ) -> Tuple[int, torch.Tensor]:
    """(exact total, first ``min(total, capacity)`` bindings) as an
    ``(m, n_vars)`` int64 tensor, in the reference listing program's
    emission order (module docstring). Same inputs as
    ``fused_count_ref``."""
    parts: List[Tuple[List[torch.Tensor], torch.Tensor]] = []

    def emit(row0, vals, slots, cand):
        i, k = torch.nonzero(cand != SENTINEL, as_tuple=True)
        cols = [v[i].long() for v in vals] + [cand[i, k].long()]
        keys = [j[i] for j in slots] + [row0[i], k]
        parts.append((keys, torch.stack(cols, dim=1)))

    _walk(atom_dims, c0, atoms, consts, n_vars, emit, keep_bindings=True)
    dev = c0.device
    if not parts:
        return 0, torch.zeros((0, n_vars), dtype=torch.int64, device=dev)
    rows = torch.cat([p[1] for p in parts])
    total = int(rows.shape[0])
    # stable sorts from the least significant key up give the lexicographic
    # (slot_1, ..., slot_{n-2}, row, innermost slot) order
    order = torch.arange(total, device=dev)
    for key in reversed([torch.cat([p[0][c] for p in parts])
                         for c in range(len(parts[0][0]))]):
        order = order[torch.sort(key[order], stable=True).indices]
    return total, rows[order[:min(total, int(capacity))]]
