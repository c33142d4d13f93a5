"""n-dimensional box planner for conjunctive queries (paper §3.3, Thm. 13).

Generalizes the triangle planner (``core.boxing.plan_boxes_from_degrees``)
to any validated ``core.queries.Query``: the variable search space is cut
into n-dimensional boxes along every dimension that *owns* at least one
atom (an atom is owned by the dimension of its first unbound variable —
only those dimensions need provisioned slices, paper §5), budgeted so that
the per-box working set fits ``mem_words``.

Planning is done entirely from the *resident degree indexes* (the (V+1)-word
``indptr`` arrays every ``EdgeSource`` keeps in memory), never by touching
the neighbor streams — the same out-of-core contract the triangle engine's
store-backed planner honours. Each owned dimension is cut with the shared
``core.boxing.greedy_degree_cuts`` primitive, so the triangle query's 2-D
special case reproduces ``plan_boxes_from_degrees`` *cut for cut* (and
therefore read for read — the I/O-parity contract ``tests/test_query_engine.py``
pins against ``TriangleEngine``).

The budget split follows §5: only owned dimensions get budget, weighted
4:1 in favour of the first owned dimension by default (the paper's x:y
ratio for the triangle query), with the last owned dimension taking the
integer remainder — again matching the triangle planner exactly.

``thm13_io_bound`` evaluates the paper's rank-r no-spill envelope
O(|I|^r / (M^{r-1} B) + K/B) that ``benchmarks/query_patterns.py`` compares
measured block reads against.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.boxing import greedy_degree_cuts
from repro_torch.core.leapfrog import Atom
from repro_torch.core.queries import rank_for_order

Box = Tuple[Tuple[int, int], ...]        # per-dimension (lo, hi), inclusive


@dataclass
class QueryPlan:
    """A box plan plus the metadata the executor and benchmarks consume."""

    order: Tuple[str, ...]
    rank: int
    owned_dims: Tuple[int, ...]          # dims owning >= 1 atom
    boxes: List[Box]
    budgets: Dict[int, int] = field(default_factory=dict)
    single_box: bool = False
    # skew="heavy_light" metadata: lanes[i] classifies boxes[i] by the
    # heavy/light class of its *owned* ranges ("hub"/"light"/"mixed");
    # heavy_threshold is the hub degree cut the cutter used
    skew: str = "uniform"
    lanes: List[str] = field(default_factory=list)
    heavy_threshold: int = 0

    @property
    def n_boxes(self) -> int:
        return len(self.boxes)

    def lane_of(self, box: Box) -> Optional[str]:
        try:
            return self.lanes[self.boxes.index(box)]
        except ValueError:
            return None


def owned_atoms_by_dim(atoms: Sequence[Atom],
                       order: Sequence[str]) -> List[List[Atom]]:
    """Atoms grouped by the dimension of their first variable."""
    out: List[List[Atom]] = [[] for _ in order]
    pos = {v: i for i, v in enumerate(order)}
    for a in atoms:
        out[pos[a.vars[0]]].append(a)
    return out


def slice_cost(indptr: np.ndarray, row_overhead: int = 2) -> np.ndarray:
    """Per-row provisioning cost in words: deg + row_overhead for present
    rows (values + idx entries, mirroring ``TrieArray.slice_words``)."""
    deg = np.diff(np.asarray(indptr, dtype=np.int64))
    return np.where(deg > 0, deg + row_overhead, 0)


def dim_budgets(mem_words: int, owned: Sequence[int],
                order: Sequence[str],
                dim_ratio: Optional[Dict[str, float]] = None) -> Dict[int, int]:
    """§5 budget split over owned dimensions.

    Default weights: 4.0 for the first owned dimension, 1.0 for the rest
    (the paper's triangle x:y ratio); the last owned dimension takes the
    integer remainder so the split sums to ``mem_words`` exactly — both
    choices match ``plan_boxes_from_degrees`` on two owned dimensions.
    """
    if not owned:
        return {}
    if dim_ratio:
        weights = [float(dim_ratio.get(order[d], 1.0)) for d in owned]
    else:
        weights = [4.0] + [1.0] * (len(owned) - 1)
    wsum = sum(weights) or 1.0
    budgets: Dict[int, int] = {}
    spent = 0
    for d, w in zip(owned[:-1], weights[:-1]):
        b = max(1, int(mem_words * w / wsum))
        budgets[d] = b
        spent += b
    budgets[owned[-1]] = max(1, mem_words - spent)
    return budgets


def monotone_prune_pairs(atoms: Sequence[Atom], order: Sequence[str],
                         directions: Dict[int, int]) -> List[Tuple[int, int]]:
    """(u_dim, v_dim) pairs such that a box with hi_v < lo_u is provably
    empty: atom value monotonicity (§5) from the storage orientation.

    ``directions[atom_index]`` is +1 when every stored tuple of that atom
    satisfies val(first) < val(second) (a minmax-oriented edge relation),
    -1 for the reversed index of one, 0 when unknown (no pruning).
    """
    pos = {v: i for i, v in enumerate(order)}
    pairs = []
    for i, a in enumerate(atoms):
        sign = directions.get(i, 0)
        if sign == 0 or len(a.vars) != 2:
            continue
        lo_var, hi_var = (a.vars[0], a.vars[1]) if sign > 0 \
            else (a.vars[1], a.vars[0])
        pairs.append((pos[lo_var], pos[hi_var]))
    return sorted(set(pairs))


def plan_query_boxes(atoms: Sequence[Atom], order: Sequence[str],
                     rel_indptr: Dict[str, np.ndarray],
                     mem_words: Optional[int],
                     *,
                     dim_ratio: Optional[Dict[str, float]] = None,
                     directions: Optional[Dict[int, int]] = None,
                     monotone_prune: bool = True,
                     row_overhead: int = 2,
                     skew: str = "uniform",
                     heavy_threshold: Optional[int] = None) -> QueryPlan:
    """Box plan for a consistent atom list over resident degree indexes.

    ``rel_indptr`` maps relation name -> (V+1)-word CSR prefix sums (the
    resident index of each ``EdgeSource``). Returns boxes as per-dimension
    inclusive (lo, hi) tuples; unowned dimensions span their full domain.

    ``skew="heavy_light"`` classifies each owned dimension's rows heavy
    (combined degree >= ``heavy_threshold``, default √(2·Σdeg)-style) vs
    light and breaks that dimension's cuts at class transitions
    (``core.boxing.class_cuts``), so each box range is pure-class per
    owned dimension. The plan then carries a lane per box ("hub" = every
    owned range heavy, "light" = every owned range light, else "mixed")
    that the executor's dispatch consumes.
    """
    if skew not in ("uniform", "heavy_light"):
        raise ValueError(
            f"skew {skew!r} not in ('uniform', 'heavy_light')")
    order = tuple(order)
    n = len(order)
    owned_lists = owned_atoms_by_dim(atoms, order)
    owned = tuple(d for d in range(n) if owned_lists[d])
    r = rank_for_order(Query_shim(atoms), order)

    # full per-dimension domains: values are vertex ids of the relations
    nv_all = max((len(ip) - 1 for ip in rel_indptr.values()), default=0)
    full: List[Tuple[int, int]] = [(0, max(0, nv_all - 1))] * n
    plan = QueryPlan(order=order, rank=r, owned_dims=owned, boxes=[],
                     single_box=True, skew=skew)
    if nv_all <= 0 or any(len(ip) < 2 for ip in rel_indptr.values()):
        return plan

    def dim_cost_deg(d):
        """(cost, degree) per row of dim d, combined over owning rels."""
        rels = []
        for a in owned_lists[d]:
            if a.rel not in rels:
                rels.append(a.rel)
        nv_d = max(len(rel_indptr[rn]) - 1 for rn in rels)
        cost = np.zeros(nv_d, dtype=np.int64)
        deg = np.zeros(nv_d, dtype=np.int64)
        for rn in rels:
            c = slice_cost(rel_indptr[rn], row_overhead)
            cost[:len(c)] += c
            dd = np.diff(np.asarray(rel_indptr[rn], dtype=np.int64))
            deg[:len(dd)] += dd
        return cost, deg

    heavy_by_dim: Dict[int, np.ndarray] = {}
    if skew == "heavy_light":
        from repro_torch.core.boxing import heavy_threshold_default
        thr = 0
        for d in owned:
            _, deg = dim_cost_deg(d)
            t = int(heavy_threshold) if heavy_threshold is not None \
                else heavy_threshold_default(int(deg.sum()))
            heavy_by_dim[d] = deg >= t
            thr = max(thr, t)
        plan.heavy_threshold = thr

    def lane_for(classes) -> str:
        """Lane of one box from its owned ranges' classes (None = the
        range was never classified, e.g. the unbounded single box)."""
        if classes and all(c is True for c in classes):
            return "hub"
        if classes and all(c is False for c in classes):
            return "light"
        return "mixed"

    # §5 slice dedup at the cost level too: a relation read once per box
    # serves every atom sharing it, so each distinct relation is charged
    # once in the fits-in-memory test and once per owning dimension
    total = sum(int(slice_cost(ip, row_overhead).sum())
                for ip in rel_indptr.values())
    if mem_words is None or total <= mem_words:
        plan.boxes = [tuple(full)]
        if skew == "heavy_light":
            classes = []
            for d in owned:
                live = heavy_by_dim[d][dim_cost_deg(d)[1] > 0]
                if len(live) and live.all():
                    classes.append(True)
                elif len(live) and not live.any():
                    classes.append(False)
                else:
                    classes.append(None)
            plan.lanes = [lane_for(classes)]
        return plan

    plan.single_box = False
    budgets = dim_budgets(mem_words, owned, order, dim_ratio)
    plan.budgets = budgets
    cuts: List[List[Tuple[int, int, Optional[bool]]]] = []
    for d in range(n):
        if d not in budgets:
            cuts.append([(full[d][0], full[d][1], None)])
            continue
        cost, deg = dim_cost_deg(d)
        if skew == "heavy_light":
            from repro_torch.core.boxing import class_cuts
            cuts.append(class_cuts(cost, budgets[d], heavy_by_dim[d]))
        else:
            cuts.append([(lo, hi, None)
                         for lo, hi in greedy_degree_cuts(cost,
                                                          budgets[d])])

    prune_pairs = monotone_prune_pairs(atoms, order, directions or {}) \
        if monotone_prune else []
    for combo in itertools.product(*cuts):
        if any(combo[v][1] < combo[u][0] for u, v in prune_pairs):
            continue
        plan.boxes.append(tuple((lo, hi) for lo, hi, _cls in combo))
        if skew == "heavy_light":
            plan.lanes.append(
                lane_for([combo[d][2] for d in owned]))
    return plan


class Query_shim:
    """Minimal duck-typed Query (atoms only) for ``rank_for_order``."""

    def __init__(self, atoms: Sequence[Atom]):
        self.atoms = list(atoms)


def thm13_io_bound(input_words: int, mem_words: int, block_words: int,
                   r: int, output_words: int = 0) -> float:
    """The paper's Thm. 13 no-spill envelope for a rank-r query:
    O(|I|^r / (M^{r-1} B) + K/B), in block I/Os."""
    m = max(1, int(mem_words))
    b = max(1, int(block_words))
    return float(input_words) ** r / (float(m) ** (r - 1) * b) \
        + float(output_words) / b
