"""TrieArray: flat-array trie encoding of sorted relations (paper §2.2).

A relation R(x_0, .., x_{n-1}) with arity n is stored as:
  * n value arrays   val[0..n-1]   -- val[i][j] is the value of the j-th trie
                                      node at depth i (depth 0 = children of
                                      the root, i.e. distinct x_0 values).
  * n-1 index arrays idx[0..n-2]   -- children of node j at depth i live at
                                      val[i+1][idx[i][j] : idx[i][j+1]]
                                      (CSR convention, exclusive end; the
                                      paper uses inclusive ends, an encoding
                                      detail only).

For a binary edge relation this is exactly CSR: val[0] = distinct sources,
idx[0] = offset array, val[1] = concatenated sorted neighbor lists.

TrieArraySlice (paper Def. 6 / Prop. 7): a range-restriction of R at level k
for a fixed k-prefix ``s``: { t in R | t[:k] == s and l <= t[k] <= h }.
Slices reference *copies* of contiguous sub-arrays (eager provisioning) and
carry per-level index offsets so idx values can be reused unmodified
("dynamic index-adaptation", Example 5).

All host-side structures are numpy; the torch lanes copy what they need
onto the device per box (``core.executor``).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

# Sentinel returned by probe() when even a single-value slice exceeds the
# memory budget (paper Fig. 3).
SPILL = "SPILL"


def _lexsort_rows(tuples: np.ndarray) -> np.ndarray:
    """Sort rows of a 2-D int array lexicographically."""
    if tuples.size == 0:
        return tuples.reshape(0, tuples.shape[1] if tuples.ndim == 2 else 0)
    keys = tuple(tuples[:, c] for c in range(tuples.shape[1] - 1, -1, -1))
    order = np.lexsort(keys)
    return tuples[order]


def _dedup_sorted_rows(tuples: np.ndarray) -> np.ndarray:
    if len(tuples) == 0:
        return tuples
    keep = np.ones(len(tuples), dtype=bool)
    keep[1:] = np.any(tuples[1:] != tuples[:-1], axis=1)
    return tuples[keep]


@dataclass
class TrieArray:
    """An n-ary relation in TrieArray form.

    ``idx_offset[i]`` is subtracted from raw ``idx[i]`` entries on access;
    0 for a freshly built TrieArray, nonzero for slices (paper Example 5).
    """

    arity: int
    val: list  # list[np.ndarray], one per level
    idx: list  # list[np.ndarray], one per level < arity-1 (len == len(val[i]) + 1)
    idx_offset: list = field(default_factory=list)  # int per idx array

    def __post_init__(self):
        if not self.idx_offset:
            self.idx_offset = [0] * (self.arity - 1)

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_tuples(tuples: np.ndarray, arity: Optional[int] = None) -> "TrieArray":
        """Build from an (m, arity) array of tuples. O(sort) time (Prop. 3)."""
        tuples = np.asarray(tuples)
        if tuples.ndim == 1:
            tuples = tuples.reshape(-1, 1)
        if arity is None:
            arity = tuples.shape[1]
        if tuples.shape[0] == 0:
            val = [np.zeros(0, dtype=np.int64) for _ in range(arity)]
            idx = [np.zeros(1, dtype=np.int64) for _ in range(arity - 1)]
            return TrieArray(arity, val, idx)
        tuples = _dedup_sorted_rows(_lexsort_rows(tuples.astype(np.int64)))

        val: list = []
        idx: list = []
        # Nodes at depth i are the distinct prefixes of length i+1. For each
        # depth compute the "new group" boundary mask w.r.t. prefix i+1.
        m = len(tuples)
        new_at = np.zeros((arity, m), dtype=bool)  # new_at[i] : row starts a new (i+1)-prefix
        prev_diff = np.zeros(m, dtype=bool)
        prev_diff[0] = True
        for i in range(arity):
            diff = prev_diff.copy()
            diff[1:] |= tuples[1:, i] != tuples[:-1, i]
            diff[0] = True
            new_at[i] = diff
            prev_diff = diff
        for i in range(arity):
            sel = new_at[i]
            val.append(tuples[sel, i].copy())
        for i in range(arity - 1):
            # idx[i][j]..idx[i][j+1] : children range of the j-th depth-i node
            # children are depth-(i+1) nodes; map each depth-(i+1) node to its
            # parent group and take group starts.
            parent_starts = np.flatnonzero(new_at[i])          # row index of each depth-i node
            child_rows = np.flatnonzero(new_at[i + 1])          # row index of each depth-(i+1) node
            # idx[i][j] = number of depth-(i+1) nodes strictly before parent j's first row
            starts = np.searchsorted(child_rows, parent_starts, side="left")
            idx.append(np.concatenate([starts, [len(child_rows)]]).astype(np.int64))
        return TrieArray(arity, val, idx)

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray) -> "TrieArray":
        return TrieArray.from_tuples(np.stack([src, dst], axis=1))

    @staticmethod
    def from_csr(indptr: np.ndarray, indices: np.ndarray,
                 sources: Optional[np.ndarray] = None) -> "TrieArray":
        """Zero-copy adoption of a CSR graph (all rows present, possibly empty)."""
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        n = len(indptr) - 1
        if sources is None:
            sources = np.arange(n, dtype=np.int64)
        deg = np.diff(indptr)
        keep = deg > 0
        val0 = np.asarray(sources)[keep]
        # rebuild compacted indptr over non-empty rows
        idx0 = np.concatenate([[0], np.cumsum(deg[keep])]).astype(np.int64)
        if not np.array_equal(idx0[-1:], [len(indices)]):
            # rows were compacted but indices must match concatenation order;
            # CSR guarantees that as long as we drop only empty rows.
            pass
        return TrieArray(2, [val0, indices], [idx0])

    # -- basic accessors ----------------------------------------------------

    def n_tuples(self) -> int:
        return int(len(self.val[self.arity - 1]))

    def words(self) -> int:
        """Total storage in words (the paper's unit for |R| and M)."""
        return int(sum(len(v) for v in self.val) + sum(len(x) for x in self.idx))

    def idx_at(self, level: int, j: int) -> int:
        return int(self.idx[level][j]) - self.idx_offset[level]

    def child_range(self, level: int, j: int) -> tuple:
        """Children of node j at ``level`` live in val[level+1][lo:hi]."""
        lo = self.idx_at(level, j)
        hi = int(self.idx[level][j + 1]) - self.idx_offset[level]
        return lo, hi

    def to_tuples(self) -> np.ndarray:
        """Enumerate the represented relation (lexicographic)."""
        out = []

        def rec(level, lo, hi, prefix):
            for j in range(lo, hi):
                v = int(self.val[level][j])
                if level == self.arity - 1:
                    out.append(prefix + [v])
                else:
                    clo, chi = self.child_range(level, j)
                    rec(level + 1, clo, chi, prefix + [v])
        if self.arity > 0 and len(self.val[0]):
            rec(0, 0, len(self.val[0]), [])
        return np.asarray(out, dtype=np.int64).reshape(-1, self.arity)

    # -- slicing (paper Def. 6, Prop. 7) -------------------------------------

    def _bsearch(self, arr, lo: int, hi: int, v, side: str, reader=None) -> int:
        """Binary search with optional block-I/O accounting: when a reader
        is given, every probed element is touched on the simulated device —
        the honest Prop. 7/8 cost (upper search levels stay LRU-cached)."""
        if reader is None:
            return lo + int(np.searchsorted(arr[lo:hi], v, side=side))
        while lo < hi:
            mid = (lo + hi) // 2
            x = reader.get(arr, mid)
            if x < v or (side == "right" and x == v):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _get(self, arr, i: int, reader=None) -> int:
        return int(arr[i]) if reader is None else reader.get(arr, i)

    def _locate_prefix(self, s: Sequence[int], reader=None):
        """Find (level, lo, hi) of the sibling range for the level ``len(s)``
        after descending the prefix ``s``. Returns None if prefix absent.
        Costs O(len(s) * log) — the binary searches of Prop. 7."""
        lo, hi = 0, len(self.val[0])
        for k, v in enumerate(s):
            arr = self.val[k]
            p = self._bsearch(arr, lo, hi, v, "left", reader)
            if p >= hi or self._get(arr, p, reader) != v:
                return None
            lo = self._get(self.idx[k], p, reader) - self.idx_offset[k]
            hi = self._get(self.idx[k], p + 1, reader) - self.idx_offset[k]
        return lo, hi

    def slice_bounds(self, s: Sequence[int], l: int, h: int, reader=None):
        """Per-level [lo, hi) ranges of the slice R^s_{l->h}; None if empty."""
        k = len(s)
        rng = self._locate_prefix(s, reader)
        if rng is None:
            return None
        lo, hi = rng
        arr = self.val[k]
        a = self._bsearch(arr, lo, hi, l, "left", reader)
        b = self._bsearch(arr, lo, hi, h, "right", reader)
        if a >= b:
            return None
        bounds = [(a, b)]
        for lev in range(k, self.arity - 1):
            lo2 = self._get(self.idx[lev], bounds[-1][0], reader) \
                - self.idx_offset[lev]
            hi2 = self._get(self.idx[lev], bounds[-1][1], reader) \
                - self.idx_offset[lev]
            bounds.append((lo2, hi2))
        return bounds

    def slice_words(self, s: Sequence[int], l: int, h: int, reader=None) -> int:
        """Words of memory the slice would occupy (for probing). O(arity)."""
        bounds = self.slice_bounds(s, l, h, reader)
        if bounds is None:
            return 0
        total = 0
        for i, (a, b) in enumerate(bounds):
            total += b - a                      # values
            if len(s) + i < self.arity - 1:
                total += (b - a) + 1            # idx entries for this level
        return total

    def make_slice(self, s: Sequence[int], l: int, h: int) -> "TrieArraySlice":
        """Materialize the slice (eager provisioning: contiguous copies)."""
        k = len(s)
        bounds = self.slice_bounds(s, l, h)
        sub_arity = self.arity - k
        if bounds is None:
            val = [np.zeros(0, dtype=np.int64) for _ in range(sub_arity)]
            idx = [np.zeros(1, dtype=np.int64) for _ in range(sub_arity - 1)]
            return TrieArraySlice(sub_arity, val, idx, [0] * (sub_arity - 1),
                                  prefix=tuple(s), low=l, high=h, words_loaded=0)
        val, idx, offs = [], [], []
        for i, (a, b) in enumerate(bounds):
            lev = k + i
            val.append(self.val[lev][a:b])       # numpy view == DMA'd copy
            if lev < self.arity - 1:
                idx.append(self.idx[lev][a:b + 1])
                # Raw idx entries point into the *source's raw* coordinate
                # space; subtracting the raw first entry re-bases them onto
                # the copied sub-array regardless of how deeply the source
                # itself was sliced.
                offs.append(int(self.idx[lev][a]))
        words = sum(len(v) for v in val) + sum(len(x) for x in idx)
        return TrieArraySlice(sub_arity, val, idx, offs, prefix=tuple(s),
                              low=l, high=h, words_loaded=int(words))

    # -- probing (paper Prop. 8 / Fig. 3) ------------------------------------

    def probe(self, s: Sequence[int], l: int, budget_words: int, reader=None):
        """Maximal h >= l such that slice R^s_{l->h} fits ``budget_words``.

        Returns (h, words) or (SPILL, single_value_words). O(log |R|) probes,
        each O(arity) via the idx prefix pointers (Prop. 8). With a reader,
        every probed element is charged on the block device.
        """
        k = len(s)
        rng = self._locate_prefix(s, reader)
        if rng is None:
            return np.inf, 0  # nothing to load; slice empty -> h unbounded
        lo, hi = rng
        arr = self.val[k]
        a = self._bsearch(arr, lo, hi, l, "left", reader)
        if a >= hi:
            return np.inf, 0
        first_val = self._get(arr, a, reader)
        w1 = self.slice_words(s, first_val, first_val, reader)
        if w1 > budget_words:
            return SPILL, w1
        # binary search the largest position p in [a, hi) with fitting slice
        lo_p, hi_p = a, hi - 1
        best = a
        while lo_p <= hi_p:
            mid = (lo_p + hi_p) // 2
            w = self.slice_words(s, first_val, self._get(arr, mid, reader),
                                 reader)
            if w <= budget_words:
                best = mid
                lo_p = mid + 1
            else:
                hi_p = mid - 1
        h = self._get(arr, best, reader)
        if best == hi - 1:
            # everything from l on fits: the upper bound is unbounded
            return np.inf, self.slice_words(s, first_val, h)
        return h, self.slice_words(s, first_val, h)


@dataclass
class TrieArraySlice(TrieArray):
    """A provisioned slice; behaves as a TrieArray of reduced arity.

    ``prefix`` records the bound values for the removed leading attributes,
    ``low``/``high`` the range restriction on its (new) first attribute.
    """

    prefix: tuple = ()
    low: int = 0
    high: int = 0
    words_loaded: int = 0


def max_value(ta: TrieArray, level: int = 0) -> int:
    return int(ta.val[level][-1]) if len(ta.val[level]) else 0


def successor(v) -> int:
    """succ(h) in the boxing loop (integer domains)."""
    return int(v) + 1
