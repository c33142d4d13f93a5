"""Boxing for LFTJ (paper §3, Algorithm 2).

Partitions the n-dimensional variable search space into boxes whose
provisioned TrieArraySlices fit a memory budget, then runs in-memory LFTJ
per box. Faithful to Algorithm 2 including:

  * per-dimension probe -> provision -> recurse loop,
  * budget split across dimensions that own atoms (paper §5: no budget for
    dimensions with no atom having x_j as first variable; configurable
    ratios, default 4:1 for the triangle query's x:y as in §5),
  * leftoverMem pass-down,
  * slice dedup for atoms sharing (relation, first variable) (§5),
  * SPILL handling: a value whose single-value slice exceeds its budget pins
    the box at that value and defers the atom to the dimension of its next
    variable (§3.3 "General joins"); deferral is sound because a full
    conjunctive query has no results where the spilling atom has no data,
  * monotone pruning hook (§5: skip provisioning boxes that provably cannot
    contain results, e.g. x < y < z for the triangle query),
  * block-I/O accounting on a simulated device (core.iomodel) validating
    Thm. 10 / Thm. 13 / Cor. 15.

Each box is independent (boxes partition the search space), so the box
list produced by ``plan_boxes`` is the work-list the streaming executor
(``core.executor``) drains.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .iomodel import BlockDevice, CountingReader
from .leapfrog import Atom, LeapfrogTriejoin
from .triearray import SPILL, TrieArray, TrieArraySlice

INF = float("inf")


@dataclass
class BoxingConfig:
    mem_words: int                       # available memory M (words)
    block_words: int = 4096              # B
    dim_ratio: Optional[dict] = None     # var -> relative budget weight
    monotone_prune: bool = False         # x<y<z style pruning (triangle DAG)
    count_only: bool = True


@dataclass
class BoxStats:
    n_boxes: int = 0
    n_spills: int = 0
    provisioned_words: int = 0
    probe_ios: int = 0
    results: int = 0
    max_box_words: int = 0


@dataclass
class _Pending:
    """An atom waiting to be provisioned at dimension ``dim``.

    ``prefix`` holds values already bound for the atom's leading variables
    (non-empty only after spills). ``vars_left`` are the atom's unbound
    variables, the first of which is ``var_order[dim]``.
    """

    atom: Atom
    rel: TrieArray
    prefix: tuple
    vars_left: tuple
    atom_id: int


class BoxedLFTJ:
    """Algorithm 2. ``relations``: name -> TrieArray on 'secondary storage'."""

    def __init__(self, atoms: Sequence[Atom], var_order: Sequence[str],
                 relations: dict, config: BoxingConfig,
                 device: Optional[BlockDevice] = None,
                 emit: Optional[Callable] = None,
                 prune: Optional[Callable] = None):
        self.atoms = list(atoms)
        self.var_order = list(var_order)
        self.relations = relations
        self.cfg = config
        self.device = device
        self.emit = emit
        self.prune = prune  # prune(low, high) -> True to skip the box
        self.stats = BoxStats()
        self.n = len(self.var_order)
        if device is not None:
            for ta in relations.values():
                device.register_triearray(ta)

        # group atoms by the dimension of their first variable
        self._initial: list = [[] for _ in range(self.n)]
        for aid, a in enumerate(self.atoms):
            d = self.var_order.index(a.vars[0])
            self._initial[d].append(
                _Pending(a, relations[a.rel], (), tuple(a.vars), aid))

        # budget weights (paper §5): only dims owning atoms get budget
        ratio = config.dim_ratio or {}
        weights = []
        for d in range(self.n):
            if self._initial[d]:
                weights.append(ratio.get(self.var_order[d], 1.0))
            else:
                weights.append(0.0)
        wsum = sum(weights) or 1.0
        self.budget = [int(config.mem_words * w / wsum) for w in weights]

    # -- probing helpers -----------------------------------------------------

    def _probe_reader(self):
        """Reader charging probe touches on the device (Prop. 8 honest cost:
        the binary-search path; upper levels stay LRU-cached)."""
        if self.device is None:
            return None
        from .iomodel import CountingReader
        return CountingReader(self.device)

    def _charge_probe(self, rel: TrieArray) -> None:
        self.stats.probe_ios += 1

    def _charge_provision(self, slc: TrieArraySlice) -> None:
        self.stats.provisioned_words += slc.words_loaded
        if self.device is not None:
            for arr in list(slc.val) + list(slc.idx):
                if len(arr):
                    self.device.read_range(arr, 0, len(arr))

    # -- the recursion (BoxUp) ------------------------------------------------

    def run(self) -> int:
        pend0 = {d: list(self._initial[d]) for d in range(self.n)}
        self._box_up(0, 0, {}, pend0, {})
        return self.stats.results

    def _box_up(self, dim: int, leftover: int, low_high: dict,
                pending: dict, slices: dict) -> None:
        """Iterate boxes along ``dim``; recurse; run LFTJ at the last dim."""
        if dim == self.n:
            self._run_box(low_high, slices)
            return
        atms = pending.get(dim, [])
        if not atms:
            # no atom owns this dim: single unbounded box along it
            lh = dict(low_high)
            lh[dim] = (-INF, INF)
            self._box_up(dim + 1, leftover, lh, pending, slices)
            return

        mem = self.budget[dim] + leftover
        per_atom = max(1, mem // max(1, len(atms)))
        low = -np.iinfo(np.int64).max
        while True:
            # ---- probe all atoms owned by this dim (Alg. 2 line 12)
            plan = []   # (pending, h_or_SPILL, first_val)
            rd = self._probe_reader()
            for p in atms:
                self._charge_probe(p.rel)
                res, _w = p.rel.probe(p.prefix, low, per_atom, reader=rd)
                first = self._first_value(p.rel, p.prefix, low)
                plan.append((p, res, first))
            if all(first is None for _p, _r, first in plan):
                break  # no atom has data >= low: dimension exhausted

            spills = [(p, first) for p, r, first in plan
                      if r == SPILL and first is not None]
            if not spills:
                hs = [r for _p, r, _f in plan if r != SPILL]
                high = min(hs) if hs else INF
                self._emit_boxes_normal(dim, low, high, plan, leftover,
                                        low_high, pending, slices, mem)
                if high == INF or high == np.inf:
                    break
                low = int(high) + 1
            else:
                pin = min(first for _p, first in spills)
                self.stats.n_spills += 1
                ok = self._emit_box_pinned(dim, pin, atms, per_atom, leftover,
                                           low_high, pending, slices, mem)
                low = pin + 1
                del ok

    @staticmethod
    def _first_value(rel: TrieArray, prefix: tuple, low):
        rng = rel._locate_prefix(prefix)
        if rng is None:
            return None
        lo, hi = rng
        arr = rel.val[len(prefix)]
        a = lo + int(np.searchsorted(arr[lo:hi], low, side="left"))
        if a >= hi:
            return None
        return int(arr[a])

    def _emit_boxes_normal(self, dim, low, high, plan, leftover,
                           low_high, pending, slices, mem) -> None:
        lh = dict(low_high)
        lh[dim] = (low, high)
        if self.prune is not None and self.prune(self.var_order, lh):
            return
        used = 0
        new_slices = dict(slices)
        owner = {}  # dedup (§5): same (rel, prefix) at this dim => one slice
        for p, _r, first in plan:
            key = (id(p.rel), p.prefix)
            if key in owner:
                # share the slice object but keep THIS atom's variable tuple
                new_slices[p.atom_id] = (new_slices[owner[key]][0], p)
                continue
            hi = np.iinfo(np.int64).max if high in (INF, np.inf) else int(high)
            slc = p.rel.make_slice(p.prefix, low, hi)
            self._charge_provision(slc)
            used += slc.words_loaded
            new_slices[p.atom_id] = (slc, p)
            owner[key] = p.atom_id
        self.stats.max_box_words = max(self.stats.max_box_words, used)
        self._box_up(dim + 1, max(0, mem - used), lh, pending, new_slices)

    def _emit_box_pinned(self, dim, pin, atms, per_atom, leftover,
                         low_high, pending, slices, mem) -> bool:
        """Box pinned at x_dim == pin; defer oversized atoms (spill path)."""
        lh = dict(low_high)
        lh[dim] = (pin, pin)
        if self.prune is not None and self.prune(self.var_order, lh):
            return True
        new_slices = dict(slices)
        new_pending = {d: list(v) for d, v in pending.items()}
        new_pending[dim] = []
        used = 0
        rd = self._probe_reader()
        for p in atms:
            self._charge_probe(p.rel)
            res, w = p.rel.probe(p.prefix, pin, per_atom, reader=rd)
            first = self._first_value(p.rel, p.prefix, pin)
            if first is None or first != pin:
                return True  # this atom has no data at pin -> box empty, skip
            if res == SPILL:
                # defer to the dimension of the atom's next variable
                rest = p.vars_left[1:]
                if not rest:
                    # unary relation spilling cannot happen (single value is
                    # one word); guard anyway
                    continue
                tgt = self.var_order.index(rest[0])
                q = _Pending(p.atom, p.rel, p.prefix + (pin,), rest, p.atom_id)
                new_pending.setdefault(tgt, []).append(q)
                new_slices[p.atom_id] = ("DEFERRED", q)
            else:
                slc = p.rel.make_slice(p.prefix, pin, pin)
                self._charge_provision(slc)
                used += slc.words_loaded
                new_slices[p.atom_id] = (slc, p)
        self.stats.max_box_words = max(self.stats.max_box_words, used)
        self._box_up(dim + 1, max(0, mem - used), lh, new_pending, new_slices)
        return False

    # -- leaf: run in-memory LFTJ on the box's slices -------------------------

    def _run_box(self, low_high: dict, slices: dict) -> None:
        self.stats.n_boxes += 1
        atoms, rels = [], {}
        pinned_vars = {}
        for aid, a in enumerate(self.atoms):
            entry = slices.get(aid)
            if entry is None or entry[0] == "DEFERRED":
                return  # defensive: nothing provisioned => treat as empty box
            slc, p = entry
            vars_left = p.vars_left
            name = f"{a.rel}#{aid}"
            rels[name] = slc
            atoms.append(Atom(name, tuple(vars_left)))
            for v, val in zip(a.vars, p.prefix):
                pinned_vars[v] = val
        # variables pinned by spills participate via 1-tuple constant atoms
        for v, val in pinned_vars.items():
            name = f"__pin_{v}"
            rels[name] = TrieArray.from_tuples(np.asarray([[val]]))
            atoms.append(Atom(name, (v,)))
        order = [v for v in self.var_order
                 if any(v in a.vars for a in atoms)]
        if len(order) != self.n:
            return  # some variable wholly unconstrained in this box: no atoms
        if any(len(r.val[0]) == 0 for r in rels.values()):
            return  # an empty slice: box has no results
        j = LeapfrogTriejoin(atoms, order, rels)
        emitted = []

        def _emit(t):
            if self.emit is not None:
                self.emit(t)
            if self.device is not None:
                emitted.append(t)

        cnt = j.run(emit=_emit if (self.emit or self.device) else None)
        self.stats.results += cnt
        if self.device is not None:
            self.device.write_words(3 * cnt)


def plan_boxes(edges_ta: TrieArray, mem_words: int,
               ratio_xy: float = 4.0, monotone_prune: bool = True) -> list:
    """Triangle-query box plan [(lx,hx,ly,hy)] without running LFTJ.

    This is the host-side planner the distributed triangle engine shards over
    devices: boxes are independent work items (§3.3: the partitioning is
    overlap-free). ``monotone_prune`` drops boxes with hy < lx, which is
    sound only when every oriented edge has x < y numerically (the minmax
    orientation); pass False for orientations that break that invariant
    (e.g. 'degree').
    """
    boxes = []
    n_max = np.iinfo(np.int64).max
    bx = int(mem_words * ratio_xy / (1 + ratio_xy))
    by = max(1, mem_words - bx)
    lx = -n_max
    while True:
        hx, _ = edges_ta.probe((), lx, max(1, bx))
        if hx == SPILL:
            first = BoxedLFTJ._first_value(edges_ta, (), lx)
            hx = first  # pinned box (degenerate; no deferral needed for plan)
        fv = BoxedLFTJ._first_value(edges_ta, (), lx)
        if fv is None:
            break
        hx_i = n_max if hx in (INF, np.inf) else int(hx)
        ly = -n_max
        while True:
            hy, _ = edges_ta.probe((), ly, max(1, by))
            if hy == SPILL:
                hy = BoxedLFTJ._first_value(edges_ta, (), ly)
            fy = BoxedLFTJ._first_value(edges_ta, (), ly)
            if fy is None:
                break
            hy_i = n_max if hy in (INF, np.inf) else int(hy)
            if hy_i >= lx or not monotone_prune:
                boxes.append((lx, hx_i, ly, hy_i))
            if hy_i == n_max:
                break
            ly = hy_i + 1
        if hx_i == n_max:
            break
        lx = hx_i + 1
    return boxes


def _greedy_degree_cuts(cost: np.ndarray, budget: int) -> list:
    """Contiguous row ranges [(lo, hi)] with Σ cost ≤ budget each.

    The degree-prefix-sum analogue of ``TrieArray.probe``: ranges grow until
    the next row would overflow the budget; a single row whose cost exceeds
    the budget becomes its own pinned range (the plan-level spill, matching
    ``plan_boxes``). Zero-cost rows are absorbed for free, so the ranges
    always cover [0, n)."""
    n = len(cost)
    cum = np.concatenate([[0], np.cumsum(cost, dtype=np.int64)])
    cuts = []
    lo = 0
    while lo < n:
        # largest hi with cum[hi+1] - cum[lo] <= budget
        hi = int(np.searchsorted(cum, cum[lo] + budget, side="right")) - 2
        hi = max(hi, lo)  # pinned row when a single row overflows
        cuts.append((lo, hi))
        lo = hi + 1
    if not cuts:
        cuts = [(0, max(0, n - 1))]
    return cuts


# public name: the generic n-dimensional planner (query.planner) cuts
# every owned dimension of a conjunctive query with the same primitive the
# triangle plan uses, so its 2-D special case reproduces plan_boxes_from_
# degrees cut for cut (the I/O-parity contract the query tests pin).
greedy_degree_cuts = _greedy_degree_cuts


def plan_boxes_from_degrees(indptr: np.ndarray, mem_words: int,
                            ratio_xy: float = 4.0,
                            monotone_prune: bool = True,
                            row_overhead: int = 2) -> list:
    """Triangle-query box plan from the resident degree index alone.

    The out-of-core analogue of ``plan_boxes``: instead of probing a
    TrieArray (which requires the whole relation in memory), the plan is
    derived from the (V+1)-word ``indptr`` prefix sums — the only structure
    the streaming engine keeps resident. Slice cost per present row is
    ``deg + row_overhead`` words, mirroring ``TrieArray.slice_words``
    (values + idx entries). Budget split and hy < lx pruning follow §5.
    """
    nv = len(indptr) - 1
    if nv <= 0:
        return []
    deg = np.diff(np.asarray(indptr, dtype=np.int64))
    cost = np.where(deg > 0, deg + row_overhead, 0)
    if int(cost.sum()) <= mem_words:
        return [(0, nv - 1, 0, nv - 1)]
    bx = max(1, int(mem_words * ratio_xy / (1 + ratio_xy)))
    by = max(1, mem_words - bx)
    xcuts = _greedy_degree_cuts(cost, bx)
    ycuts = _greedy_degree_cuts(cost, by)
    boxes = []
    for lx, hx in xcuts:
        for ly, hy in ycuts:
            if hy >= lx or not monotone_prune:
                boxes.append((lx, hx, ly, hy))
    return boxes


# ---------------------------------------------------------------------------
# skew-resistant planning: heavy/light decomposition ("Skew Strikes Back")
# ---------------------------------------------------------------------------

def heavy_threshold_default(total_degree: int) -> int:
    """Default hub threshold: deg >= sqrt(2·|E|) (the √E-style split of
    worst-case-optimal join analyses; ``total_degree`` is Σ deg = |E| for
    an oriented CSR)."""
    return max(2, int(math.isqrt(max(0, 2 * int(total_degree)))))


def classify_heavy(indptr: np.ndarray,
                   threshold: Optional[int] = None
                   ) -> tuple[np.ndarray, int]:
    """(heavy mask, threshold) from a resident degree index.

    A vertex is *heavy* (a hub) when its out-degree reaches the threshold
    (default ``heavy_threshold_default``); everything else — including
    zero-degree rows — is light.
    """
    deg = np.diff(np.asarray(indptr, dtype=np.int64))
    thr = heavy_threshold_default(int(deg.sum())) if threshold is None \
        else max(1, int(threshold))
    return deg >= thr, thr


def class_cuts(cost: np.ndarray, budget: int,
               heavy: np.ndarray) -> list:
    """``greedy_degree_cuts`` that never mixes heavy and light rows.

    Returns ``[(lo, hi, is_heavy)]``: the same contiguous mass-budgeted
    ranges as the uniform cutter, with an additional break at every
    heavy/light class transition so each range is pure-class. Zero-cost
    rows carry no class (they are absorbed free into whichever range they
    fall in), so an isolated hub between absent rows still gets its own
    pinned range without fragmenting the plan.
    """
    n = len(cost)
    if n == 0:
        return []
    cls = np.where(np.asarray(heavy, dtype=bool), 1, 0)
    wild = np.asarray(cost) == 0
    real = np.flatnonzero(~wild)
    if len(real) == 0:
        return [(0, n - 1, False)]
    # forward-fill the wildcard rows with the previous real class (head
    # rows take the first real class), so runs break only on real changes
    last_real = np.maximum.accumulate(np.where(~wild, np.arange(n), -1))
    filled = np.where(last_real >= 0, cls[np.maximum(last_real, 0)],
                      cls[real[0]])
    breaks = np.flatnonzero(np.diff(filled) != 0) + 1
    bounds = np.concatenate([[0], breaks, [n]])
    cuts = []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        is_h = bool(filled[b0])
        for lo, hi in _greedy_degree_cuts(cost[b0:b1], budget):
            cuts.append((int(b0 + lo), int(b0 + hi), is_h))
    return cuts


def _pair_lane(x_heavy: Optional[bool], y_heavy: Optional[bool]) -> str:
    if x_heavy and y_heavy:
        return "hub"
    if x_heavy is False and y_heavy is False:
        return "light"
    return "mixed"


@dataclass
class SkewPlan:
    """A heavy/light box plan plus its per-box lane metadata.

    ``lanes[i]`` classifies ``boxes[i]``: ``"hub"`` (both ranges heavy —
    near-dense by construction, routed to the dense/intersect lanes),
    ``"light"`` (both ranges light — routed to the host searchsorted lane,
    which never materializes a padded matrix), or ``"mixed"``.
    """

    boxes: list = field(default_factory=list)
    lanes: list = field(default_factory=list)
    threshold: int = 0
    n_heavy: int = 0

    def lane_of(self, box) -> Optional[str]:
        try:
            return self.lanes[self.boxes.index(box)]
        except ValueError:
            return None


def plan_boxes_heavy_light(indptr: np.ndarray,
                           mem_words: Optional[int],
                           ratio_xy: float = 4.0,
                           monotone_prune: bool = True,
                           row_overhead: int = 2,
                           heavy_threshold: Optional[int] = None) -> SkewPlan:
    """Skew-resistant triangle box plan (``skew="heavy_light"``).

    Same contract as ``plan_boxes_from_degrees`` — contiguous
    ``(lx, hx, ly, hy)`` boxes partitioning the oriented edge set, sized by
    actual slice mass (Σ deg + overhead ≤ budget per range) — but every cut
    additionally breaks at heavy/light class transitions
    (``classify_heavy``), so each box is pure hub-hub, pure light-light, or
    a hub×light mixture, and the per-box lane is known at plan time. Hubs
    whose single row overflows the budget become pinned ranges exactly as
    in the uniform planner (the plan-level spill).
    """
    nv = len(indptr) - 1
    if nv <= 0:
        return SkewPlan()
    deg = np.diff(np.asarray(indptr, dtype=np.int64))
    heavy, thr = classify_heavy(indptr, heavy_threshold)
    n_heavy = int(heavy.sum())
    cost = np.where(deg > 0, deg + row_overhead, 0)
    if mem_words is None or int(cost.sum()) <= mem_words:
        any_h, any_l = n_heavy > 0, bool((~heavy[deg > 0]).any())
        lane = _pair_lane(any_h and not any_l, any_h and not any_l) \
            if not (any_h and any_l) else "mixed"
        return SkewPlan(boxes=[(0, nv - 1, 0, nv - 1)], lanes=[lane],
                        threshold=thr, n_heavy=n_heavy)
    bx = max(1, int(mem_words * ratio_xy / (1 + ratio_xy)))
    by = max(1, mem_words - bx)
    xcuts = class_cuts(cost, bx, heavy)
    ycuts = class_cuts(cost, by, heavy)
    plan = SkewPlan(threshold=thr, n_heavy=n_heavy)
    for lx, hx, xh in xcuts:
        for ly, hy, yh in ycuts:
            if hy >= lx or not monotone_prune:
                plan.boxes.append((lx, hx, ly, hy))
                plan.lanes.append(_pair_lane(xh, yh))
    return plan


def boxed_triangle_count(edges_ta: TrieArray, mem_words: int,
                         block_words: int = 4096,
                         device: Optional[BlockDevice] = None,
                         emit: Optional[Callable] = None,
                         monotone_prune: bool = True):
    """Boxed LFTJ-Δ (paper §4.1). Returns (count, BoxStats)."""
    from .leapfrog import triangle_query_atoms

    def prune(var_order, lh):
        # x < y < z in the DAG orientation: a box with hy < lx is empty (§5)
        if not monotone_prune:
            return False
        if 0 in lh and 1 in lh:
            _lx, _hx = lh[0]
            _ly, _hy = lh[1]
            return _hy < _lx
        return False

    cfg = BoxingConfig(mem_words=mem_words, block_words=block_words,
                       dim_ratio={"x": 4.0, "y": 1.0})
    bj = BoxedLFTJ(triangle_query_atoms(), ["x", "y", "z"],
                   {"E": edges_ta}, cfg, device=device, emit=emit,
                   prune=prune)
    count = bj.run()
    return count, bj.stats
