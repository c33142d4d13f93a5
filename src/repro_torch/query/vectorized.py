"""Vectorized (batched) leapfrog primitives for the generic QueryEngine.

The scalar reference (``core.leapfrog.LeapfrogTriejoin``) walks the binding
trie one value at a time. This module replaces that inner loop with a
*frontier* formulation: all partial bindings at one depth are held as
columns of a matrix, and one variable is expanded for the whole frontier at
once with numpy ``searchsorted`` kernels — the same lifted-key idiom as the
triangle executor's GIL-releasing host lane (``StreamingExecutor._count_host``),
so worker threads of the shared box scheduler scale on CPU hosts.

Per depth ``d`` of the variable order:

* atoms whose *second* variable is ``d`` expand the frontier (candidates =
  the adjacency row of the bound first endpoint) and then prune it (every
  further such atom is a batched membership probe into its lifted CSR);
* atoms whose *first* variable is ``d`` contribute their key set (vertices
  with a non-empty in-range row) as a sorted-membership filter — the level
  the scalar LFTJ intersects lazily, applied eagerly here;
* at the innermost depth a count-only query never materializes bindings:
  one incident atom degenerates to a degree sum, two lower onto a pairwise
  sorted-intersection — the host lane's lifted ``searchsorted``, or the
  ``kernels/intersect`` CUDA kernel (``intersect_count_rows``) on the
  torch device — and three or more materialize the pairwise intersection
  once and filter.

Frontiers are split recursively when the projected expansion exceeds
``chunk_entries``, so peak host memory is bounded by the chunk, not the
result size; splits preserve binding order, keeping counts, listings and
their order deterministic for any split points.

Every slice here is *box-local* (built by the executor from EdgeSource
reads already restricted to the box), so values never need re-clipping:
an atom's candidate values were filtered to its second variable's box
range at slice-build time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_torch_device
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.lftj_fused import ops as fused_ops


@dataclass
class AtomSlice:
    """One atom's box-restricted relation in compact CSR form.

    ``keys`` are the sorted global vertex ids of the atom's first variable
    having at least one in-range value; ``off``/``vals`` the concatenated
    sorted in-range adjacency. ``stride`` lifts (row, value) pairs into
    disjoint int64 key ranges for the one-probe membership tests; it must
    clear the whole id domain (membership queries carry values from OTHER
    atoms' expansions, not just this slice's own), so it is the 2**31
    vertex-id ceiling the edge store enforces — row_pos · stride + value
    stays well inside int64 for any slice.
    """

    keys: np.ndarray                     # int64, sorted
    off: np.ndarray                      # int64, len(keys) + 1
    vals: np.ndarray                     # int32
    stride: int = 1 << 31
    _lifted: Optional[np.ndarray] = None
    _on: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = field(
        default_factory=dict)

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    @property
    def words(self) -> int:
        return len(self.vals) + len(self.off)

    @property
    def deg(self) -> np.ndarray:
        return np.diff(self.off)

    @property
    def lifted(self) -> np.ndarray:
        """Row-position-lifted sorted value keys (built once per box)."""
        if self._lifted is None:
            rid = np.repeat(np.arange(self.n_keys, dtype=np.int64),
                            self.deg)
            self._lifted = rid * self.stride + self.vals
        return self._lifted

    def on(self, device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(keys int64, off int64, vals int32) tensors on ``device``,
        copied once per slice: a box's CSR moves to the device once,
        whichever lanes and frontier chunks read it."""
        got = self._on.get(device)
        if got is None:
            got = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (self.keys, self.off, self.vals))
            self._on[device] = got
        return got


def build_atom_slice(ip_local: np.ndarray, vals: np.ndarray, row_lo: int,
                     val_lo: Optional[int] = None,
                     val_hi: Optional[int] = None) -> AtomSlice:
    """AtomSlice for rows ``row_lo..row_lo+len(ip_local)-2`` with values
    optionally restricted to ``[val_lo, val_hi]`` (the second variable's
    box range)."""
    ip_local = np.asarray(ip_local, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.int32)
    n_rows = len(ip_local) - 1
    deg = np.diff(ip_local)
    if val_lo is not None or val_hi is not None:
        lo = -1 if val_lo is None else int(val_lo)
        hi = np.iinfo(np.int64).max if val_hi is None else int(val_hi)
        rid = np.repeat(np.arange(n_rows), deg)
        mask = (vals >= lo) & (vals <= hi)
        deg = np.bincount(rid[mask], minlength=n_rows).astype(np.int64)
        vals = vals[mask]
    keep = deg > 0
    keys = (row_lo + np.flatnonzero(keep)).astype(np.int64)
    off = np.concatenate([np.zeros(1, np.int64),
                          np.cumsum(deg[keep], dtype=np.int64)])
    return AtomSlice(keys=keys, off=off, vals=vals)


# ---------------------------------------------------------------------------
# batched probes (host lane)
# ---------------------------------------------------------------------------

def in_sorted(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Boolean membership of each query in the sorted unique ``keys``."""
    if len(keys) == 0 or len(queries) == 0:
        return np.zeros(len(queries), dtype=bool)
    pos = np.searchsorted(keys, queries)
    np.minimum(pos, len(keys) - 1, out=pos)
    return keys[pos] == queries


def row_lookup(slc: AtomSlice, u: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, present) of vertex ids ``u`` in ``slc.keys``."""
    if slc.n_keys == 0 or len(u) == 0:
        return np.zeros(len(u), dtype=np.int64), np.zeros(len(u), dtype=bool)
    pos = np.searchsorted(slc.keys, u)
    np.minimum(pos, slc.n_keys - 1, out=pos)
    return pos, slc.keys[pos] == u


def gather(slc: AtomSlice, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """(deg, concatenated values, source index per value) for key
    positions ``pos`` (each must be a valid key position)."""
    deg = slc.deg[pos]
    total = int(deg.sum())
    if total == 0:
        return deg, np.zeros(0, np.int32), np.zeros(0, np.int64)
    starts = slc.off[pos]
    idx = np.repeat(starts, deg) + np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(deg) - deg, deg)
    rep = np.repeat(np.arange(len(pos), dtype=np.int64), deg)
    return deg, slc.vals[idx], rep


def member_rows(slc: AtomSlice, pos: np.ndarray,
                values: np.ndarray) -> np.ndarray:
    """Per (row-position, value) pair: value ∈ row? One lifted probe."""
    if len(pos) == 0:
        return np.zeros(0, dtype=bool)
    lifted = slc.lifted
    if len(lifted) == 0:
        return np.zeros(len(pos), dtype=bool)
    q = pos.astype(np.int64) * slc.stride + values.astype(np.int64)
    p = np.searchsorted(lifted, q)
    np.minimum(p, len(lifted) - 1, out=p)
    return lifted[p] == q


def intersect_rows_host(a: AtomSlice, pos_a: np.ndarray,
                        b: AtomSlice, pos_b: np.ndarray,
                        counts_only: bool = False):
    """Pairwise row intersections: for each i, row ``pos_a[i]`` of ``a``
    against row ``pos_b[i]`` of ``b`` (positions must be valid).

    ``counts_only`` returns the total match count; otherwise
    ``(pair_ids, values)`` of every intersection element, in pair-major
    ascending-value order. The smaller side is probed into the larger
    (the min(d_x, d_y) accounting of Thm. 17)."""
    _, av, ra = gather(a, pos_a)
    _, bv, rb = gather(b, pos_b)
    stride = np.int64(max(int(av.max(initial=0)), int(bv.max(initial=0))) + 1)
    ak = ra * stride + av
    bk = rb * stride + bv
    small_v, small_r = av, ra
    if len(ak) > len(bk):
        ak, bk = bk, ak
        small_v, small_r = bv, rb
    if len(ak) == 0 or len(bk) == 0:
        if counts_only:
            return 0
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    p = np.searchsorted(bk, ak)
    np.minimum(p, len(bk) - 1, out=p)
    hit = bk[p] == ak
    if counts_only:
        return int(hit.sum())
    return small_r[hit], small_v[hit]


# ---------------------------------------------------------------------------
# the frontier machine
# ---------------------------------------------------------------------------

@dataclass
class BoundAtom:
    """An atom as the box executor sees it: its slice plus the dims of its
    first/second variable in the chosen order."""

    first_dim: int
    second_dim: int
    slc: AtomSlice


class VectorizedBoxJoin:
    """Execute one box of a binary-atom conjunctive query.

    ``mode`` is ``"count"`` or ``"list"``; ``kernel_lane`` lowers the
    innermost two-atom intersection onto ``kernels/intersect`` on
    ``torch_device`` (the CUDA kernel on the card, its plain torch version
    on the CPU) instead of the host ``searchsorted`` lane.
    ``torch_device`` defaults to ``"cuda"`` and raises without CUDA, as
    the engines do; pass ``"cpu"`` to run the plain versions.

    ``device`` picks the box-level lane: ``"host"`` (this module's staged
    per-level frontier machine) or ``"fused"``, which dispatches the
    *whole box* to the ``kernels/lftj_fused`` kernels on ``torch_device``
    — one device invocation per box instead of one per frontier level.
    Boxes or patterns outside the fused kernel's envelope (depth bound,
    unbound intermediate variable, ids or rows it does not take, see
    ``fused_ops.FusedUnsupported``) fall back to the staged path;
    ``used_fused`` records which lane actually ran. A failed kernel build
    or launch raises.

    ``capacity`` bounds the materialized listing buffer: at most that many
    binding rows are kept (``emitted``), while ``count`` stays the *exact*
    result count — the caller detects overflow from ``count > capacity``
    and rescans at doubled capacity, exactly the triangle engine's
    overflow→rescan protocol. Emitted rows are always the deterministic
    prefix of the full binding order, so a rescan extends, never reorders
    (the fused lane has its own fixed traversal order with the same
    prefix guarantee).
    """

    def __init__(self, atoms: Sequence[BoundAtom], n_vars: int,
                 mode: str = "count", *,
                 kernel_lane: bool = False,
                 torch_device="cuda",
                 device: str = "host",
                 chunk_entries: int = 4_000_000,
                 capacity: Optional[int] = None):
        if device not in ("host", "fused"):
            raise ValueError(f"unknown device lane {device!r}")
        self.n = n_vars
        self.mode = mode
        self.kernel_lane = kernel_lane
        self.torch_device = resolve_torch_device(torch_device)
        self.device = device
        self.chunk_entries = int(chunk_entries)
        self.capacity = None if capacity is None else int(capacity)
        self.atoms = list(atoms)
        self.by_second: List[List[BoundAtom]] = [[] for _ in range(n_vars)]
        self.by_first: List[List[BoundAtom]] = [[] for _ in range(n_vars)]
        for a in atoms:
            self.by_second[a.second_dim].append(a)
            self.by_first[a.first_dim].append(a)
        self.count = 0
        self.emitted = 0
        self.rows_out: List[np.ndarray] = []
        self.used_kernel = False
        self.used_fused = False
        self.max_frontier = 0

    # -- public --------------------------------------------------------------

    def run(self):
        """Returns the result count; ``rows_out`` holds the bindings
        (columns in variable order) when ``mode == 'list'``."""
        if self.device == "fused" and self._run_fused():
            return self.count
        cand = self._key_intersection(self.by_first[0])
        if len(cand) == 0:
            return 0
        self._eval(1, [cand])
        return self.count

    def _run_fused(self) -> bool:
        """Whole-box dispatch to the fused megakernel; False -> the box
        is outside its envelope and the staged path should run."""
        dims = [(a.first_dim, a.second_dim) for a in self.atoms]
        if fused_ops.fused_supported(dims, self.n) is not None:
            return False
        csrs = [a.slc.on(self.torch_device) for a in self.atoms]
        try:
            if self.mode == "count":
                self.count = fused_ops.fused_count(dims, csrs, self.n)
            else:
                cap = self.capacity
                if cap is None:
                    # unbounded listing: probe at a small cap, then rerun
                    # sized to the exact total the probe returned
                    total, rows = fused_ops.fused_list(dims, csrs, self.n,
                                                       capacity=1024)
                    if total > 1024:
                        total, rows = fused_ops.fused_list(
                            dims, csrs, self.n, capacity=total)
                else:
                    total, rows = fused_ops.fused_list(dims, csrs, self.n,
                                                       capacity=cap)
                self.count = total
                self.emitted = len(rows)
                if len(rows):
                    self.rows_out = [rows]
        except fused_ops.FusedUnsupported:
            return False
        self.used_fused = True
        return True

    def bindings(self) -> np.ndarray:
        if not self.rows_out:
            return np.zeros((0, self.n), dtype=np.int64)
        return np.concatenate(self.rows_out, axis=0)

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _key_intersection(atoms: Sequence[BoundAtom]) -> np.ndarray:
        cand = None
        for a in atoms:
            k = a.slc.keys
            cand = k if cand is None \
                else cand[in_sorted(k, cand)]
            if len(cand) == 0:
                break
        return cand if cand is not None else np.zeros(0, np.int64)

    def _eval(self, d: int, cols: List[np.ndarray]) -> None:
        n_f = len(cols[0])
        if n_f == 0:
            return
        self.max_frontier = max(self.max_frontier, n_f)
        bound = self.by_second[d]
        # projected expansion: split the frontier so the lifted arrays and
        # candidate buffers stay bounded regardless of the result size
        if n_f > 1 and bound:
            a0 = bound[0]
            pos, ok = row_lookup(a0.slc, cols[a0.first_dim])
            est = int(a0.slc.deg[pos[ok]].sum())
            if est > self.chunk_entries:
                mid = n_f // 2
                self._eval(d, [c[:mid] for c in cols])
                self._eval(d, [c[mid:] for c in cols])
                return
        if d == self.n - 1 and self.mode == "count":
            self._final_count(cols, bound)
            return
        rep, cand = self._expand(d, cols, bound)
        if len(cand) == 0:
            return
        if d == self.n - 1:
            # count is exact regardless of capacity; only the materialized
            # rows are clipped (deterministic prefix -> rescan-safe)
            self.count += len(cand)
            take = len(cand)
            if self.capacity is not None:
                take = min(take, self.capacity - self.emitted)
            if take > 0:
                new_cols = [c[rep[:take]] for c in cols] \
                    + [cand[:take].astype(np.int64)]
                self.emitted += take
                self.rows_out.append(np.stack(new_cols, axis=1))
            return
        new_cols = [c[rep] for c in cols] + [cand.astype(np.int64)]
        self._eval(d + 1, new_cols)

    def _expand(self, d: int, cols: List[np.ndarray],
                bound: Sequence[BoundAtom]):
        """Candidates for depth ``d``: (frontier index per candidate,
        candidate values), after every incident-atom filter."""
        starts = self.by_first[d]
        if bound:
            a0 = bound[0]
            pos, ok = row_lookup(a0.slc, cols[a0.first_dim])
            live = np.flatnonzero(ok)
            _, cand, rep_local = gather(a0.slc, pos[live])
            rep = live[rep_local]
            mask = np.ones(len(cand), dtype=bool)
            for ai in bound[1:]:
                pos_i, ok_i = row_lookup(ai.slc, cols[ai.first_dim][rep])
                mask &= ok_i & member_rows(ai.slc, pos_i, cand)
        else:
            # the variable only *starts* atoms here: candidates are the
            # intersection of their key sets, crossed with the frontier
            cand0 = self._key_intersection(starts)
            n_f = len(cols[0])
            rep = np.repeat(np.arange(n_f, dtype=np.int64), len(cand0))
            cand = np.tile(cand0, n_f)
            return rep, cand
        for aj in starts:
            mask &= in_sorted(aj.slc.keys, cand.astype(np.int64))
        return rep[mask], cand[mask]

    def _final_count(self, cols: List[np.ndarray],
                     bound: Sequence[BoundAtom]) -> None:
        """Innermost depth, count only: never materialize the bindings."""
        a0 = bound[0]
        pos0, ok0 = row_lookup(a0.slc, cols[a0.first_dim])
        if len(bound) == 1:
            self.count += int(a0.slc.deg[pos0[ok0]].sum())
            return
        a1 = bound[1]
        pos1, ok1 = row_lookup(a1.slc, cols[a1.first_dim])
        live = np.flatnonzero(ok0 & ok1)
        if len(live) == 0:
            return
        if len(bound) == 2:
            if self.kernel_lane:
                self.count += self._kernel_pair_count(
                    a0, pos0[live], a1, pos1[live])
            else:
                self.count += intersect_rows_host(
                    a0.slc, pos0[live], a1.slc, pos1[live],
                    counts_only=True)
            return
        # >= 3 incident atoms (e.g. the 4-clique's last variable):
        # materialize the pairwise intersection once, then filter
        pair_ids, values = intersect_rows_host(a0.slc, pos0[live],
                                               a1.slc, pos1[live])
        mask = np.ones(len(values), dtype=bool)
        for ai in bound[2:]:
            pos_i, ok_i = row_lookup(ai.slc,
                                     cols[ai.first_dim][live][pair_ids])
            mask &= ok_i & member_rows(ai.slc, pos_i, values)
        self.count += int(mask.sum())

    def _kernel_pair_count(self, a: BoundAtom, pos_a,
                           b: BoundAtom, pos_b) -> int:
        self.used_kernel = True
        dev = self.torch_device
        _, off_a, vals_a = a.slc.on(dev)
        _, off_b, vals_b = b.slc.on(dev)
        return intersect_ops.intersect_count_rows(
            off_a, vals_a, torch.from_numpy(pos_a).to(dev),
            off_b, vals_b, torch.from_numpy(pos_b).to(dev))
