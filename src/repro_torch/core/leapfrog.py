"""Faithful Leapfrog Triejoin (paper Apx. A, Algorithms 3 & 4; [Veldhuizen'14]).

This is the *reference altitude*: the exact sequential algorithm with
TrieIterators over TrieArrays, generic in the query (any arity, any number of
atoms, any consistent variable order). All element accesses go through a
``CountingReader`` so the same code runs in-memory (no accounting) or on the
simulated block device (out-of-core accounting for Prop. 4 / Fig. 9).

Complexities honoured (paper §2.1): VALUE/ATEND O(1); SEEK amortized
O(1 + log(N/m)) via galloping (exponential probe 1,4,16,.. then bisect),
NEXT O(1) amortized.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from .iomodel import CountingReader
from .triearray import TrieArray


class TrieIterator:
    """Navigates the trie of a TrieArray (paper Apx. A.1)."""

    __slots__ = ("ta", "rd", "depth", "_lo", "_hi", "_pos")

    def __init__(self, ta: TrieArray, reader: Optional[CountingReader] = None):
        self.ta = ta
        self.rd = reader or CountingReader(None)
        self.depth = -1                      # -1 == at root
        self._lo = [0] * ta.arity            # sibling range per depth
        self._hi = [0] * ta.arity
        self._pos = [0] * ta.arity

    # -- vertical -----------------------------------------------------------

    def open(self) -> None:
        ta, d = self.ta, self.depth
        if d == -1:
            lo, hi = 0, len(ta.val[0])
        else:
            j = self._pos[d]
            # child range: idx[d][j] .. idx[d][j+1] (offset-adjusted)
            raw_lo = self.rd.get(ta.idx[d], j)
            raw_hi = self.rd.get(ta.idx[d], j + 1)
            lo = raw_lo - ta.idx_offset[d]
            hi = raw_hi - ta.idx_offset[d]
        d += 1
        self.depth = d
        self._lo[d], self._hi[d], self._pos[d] = lo, hi, lo

    def close(self) -> None:
        self.depth -= 1

    # -- linear iterator (current depth) --------------------------------------

    def at_end(self) -> bool:
        d = self.depth
        return self._pos[d] >= self._hi[d]

    def value(self) -> int:
        d = self.depth
        return self.rd.get(self.ta.val[d], self._pos[d])

    def next(self) -> None:
        self._pos[self.depth] += 1

    def seek(self, v: int) -> None:
        """Forward-position to the least element >= v (galloping search)."""
        d = self.depth
        arr = self.ta.val[d]
        pos, hi = self._pos[d], self._hi[d]
        if pos >= hi:
            return
        # gallop: probe pos+1, pos+4, pos+16, ... until >= v or past end
        step = 1
        lo_b = pos
        hi_b = pos
        while hi_b < hi and self.rd.get(arr, hi_b) < v:
            lo_b = hi_b + 1
            step *= 4
            hi_b = min(pos + step, hi - 1) if pos + step < hi else hi - 1
            if lo_b > hi_b:
                break
        if hi_b >= hi or (hi_b == hi - 1 and self.rd.get(arr, hi_b) < v):
            self._pos[d] = hi
            return
        # binary search in [lo_b, hi_b]
        while lo_b < hi_b:
            mid = (lo_b + hi_b) // 2
            if self.rd.get(arr, mid) < v:
                lo_b = mid + 1
            else:
                hi_b = mid
        self._pos[d] = lo_b


class LeapfrogJoin:
    """Intersection of the current levels of k TrieIterators (Alg. 3)."""

    __slots__ = ("iters", "i", "at_end")

    def __init__(self, iters: Sequence[TrieIterator]):
        self.iters = list(iters)
        self.i = 0
        self.at_end = False

    def init(self) -> None:
        self.at_end = False
        for it in self.iters:
            if it.at_end():
                self.at_end = True
                return
        self.iters.sort(key=lambda it: it.value())
        self.i = 0
        self.search()

    def search(self) -> None:
        iters, k = self.iters, len(self.iters)
        i = self.i
        max_val = iters[(i - 1) % k].value() if not iters[(i - 1) % k].at_end() else None
        if max_val is None:
            self.at_end = True
            return
        while True:
            it = iters[i]
            if it.at_end():
                self.at_end = True
                return
            v = it.value()
            if v == max_val:
                self.i = i
                return  # all k agree
            it.seek(max_val)
            if it.at_end():
                self.at_end = True
                return
            max_val = it.value()
            i = (i + 1) % k

    def next(self) -> None:
        it = self.iters[self.i]
        it.next()
        if it.at_end():
            self.at_end = True
            return
        self.i = (self.i + 1) % len(self.iters)
        self.search()

    def seek(self, v: int) -> None:
        it = self.iters[self.i]
        it.seek(v)
        if it.at_end():
            self.at_end = True
            return
        self.i = (self.i + 1) % len(self.iters)
        self.search()

    def value(self) -> int:
        return self.iters[self.i].value()


@dataclass
class Atom:
    """A body atom: relation name + variable tuple, e.g. E(x, y)."""

    rel: str
    vars: tuple

    def __post_init__(self):
        if len(set(self.vars)) != len(self.vars):
            raise ValueError(
                f"atom {self.rel}{self.vars}: repeated variable in one atom; "
                "rewrite with Eq() per paper §2.1")


class LeapfrogTriejoin:
    """Generic LFTJ over a full-conjunctive query (Alg. 4).

    ``relations`` maps relation name -> TrieArray whose attribute order is
    consistent with ``var_order`` (create reordered indexes upstream if not;
    paper §2.1 'Leapfrog TrieJoin Restrictions').
    """

    def __init__(self, atoms: Sequence[Atom], var_order: Sequence[str],
                 relations: dict, reader: Optional[CountingReader] = None,
                 bounds: Optional[dict] = None):
        self.atoms = list(atoms)
        self.var_order = list(var_order)
        self.reader = reader or CountingReader(None)
        self.bounds = bounds or {}
        for a in self.atoms:
            positions = [self.var_order.index(v) for v in a.vars]
            if positions != sorted(positions):
                raise ValueError(
                    f"atom {a.rel}{a.vars} inconsistent with order {var_order}; "
                    "pre-create a reordered index for it")
        # One TrieIterator per atom (paper: even for repeated relations).
        self.iters = [TrieIterator(relations[a.rel], self.reader) for a in self.atoms]
        n = len(self.var_order)
        self.openers: list = [[] for _ in range(n)]
        for a, it in zip(self.atoms, self.iters):
            for v in a.vars:
                self.openers[self.var_order.index(v)].append(it)
        self.lfjs = [LeapfrogJoin(self.openers[d]) for d in range(n)]
        for d in range(n):
            if not self.openers[d]:
                raise ValueError(f"variable {self.var_order[d]} appears in no atom")

    def run(self, emit: Callable[[tuple], None] | None = None,
            count_only: bool = False) -> int:
        """DFS over the binding trie; returns #results, optionally emitting."""
        n = len(self.var_order)
        binding = [0] * n
        count = 0
        d = 0
        self._open(0)
        self._apply_lower_bound(0)
        while True:
            if self.lfjs[d].at_end:
                self._close(d)
                d -= 1
                if d < 0:
                    break
                self.lfjs[d].next()
                continue
            v = self.lfjs[d].value()
            ub = self.bounds.get(self.var_order[d])
            if ub is not None and v > ub[1]:
                # monotone pruning: past the box's upper bound at this level
                self.lfjs[d].at_end = True
                continue
            binding[d] = v
            if d == n - 1:
                count += 1
                if emit is not None and not count_only:
                    emit(tuple(binding))
                self.lfjs[d].next()
            else:
                d += 1
                self._open(d)
                self._apply_lower_bound(d)
        return count

    def _apply_lower_bound(self, d: int) -> None:
        lb = self.bounds.get(self.var_order[d])
        if lb is not None and not self.lfjs[d].at_end:
            if self.lfjs[d].value() < lb[0]:
                self.lfjs[d].seek(lb[0])

    def _open(self, d: int) -> None:
        for it in self.openers[d]:
            it.open()
        self.lfjs[d].init()

    def _close(self, d: int) -> None:
        for it in self.openers[d]:
            it.close()


def triangle_query_atoms() -> list:
    """T(x,y,z) <- E(x,y), E(x,z), E(y,z)   (paper eq. Δ)."""
    return [Atom("E", ("x", "y")), Atom("E", ("x", "z")), Atom("E", ("y", "z"))]


def lftj_query_count(atoms: Sequence[Atom], var_order: Sequence[str],
                     relations: dict, device=None,
                     emit: Optional[Callable] = None) -> int:
    """Scalar LFTJ over any consistent atom list, optionally charging every
    element access to a ``core.iomodel.BlockDevice``.

    The reference-altitude I/O measurement for general queries: registers
    each relation's arrays on the device and routes all trie navigation
    through a ``CountingReader``, so the measured block reads are the
    vanilla (un-boxed) cost the Thm. 13 boxed bound is compared against
    (the boxed engine, ``core.engine.TriangleEngine``, is the production
    path)."""
    reader = None
    if device is not None:
        for ta in relations.values():
            device.register_triearray(ta)
        reader = CountingReader(device)
    j = LeapfrogTriejoin(atoms, list(var_order), relations, reader=reader)
    return j.run(emit=emit)


def lftj_triangle_count(edges_ta: TrieArray,
                        reader: Optional[CountingReader] = None,
                        emit: Optional[Callable] = None) -> int:
    """In-memory LFTJ-Δ on a DAG-oriented edge TrieArray."""
    j = LeapfrogTriejoin(triangle_query_atoms(), ["x", "y", "z"],
                         {"E": edges_ta}, reader=reader)
    return j.run(emit=emit)
