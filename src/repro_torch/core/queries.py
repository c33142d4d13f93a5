"""Generic full-conjunctive query utilities (paper §2.1, Def. 12).

Queries are given in a Datalog-ish form: a head variable tuple plus body
atoms over named relations. Utilities here:

  * variable-order validation and automatic index creation — an atom whose
    variables are not a subsequence of the chosen order gets a reordered
    TrieArray index T_{π} built for it (paper: "indexes are created in a
    preprocessing step", O(SORT) each);
  * rank r_π(Q) and r(Q) (Def. 12): the largest position (1-based) of a
    variable that is the *first* variable of some atom; governs the
    no-spill I/O bound O(|I|^r / (M^{r-1} B) + K/B) (Thm. 13);
  * repeated-variable rewrites are rejected with guidance (infinite Eq
    predicates are out of scope for the TrieArray backend).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .leapfrog import Atom
from .triearray import TrieArray


@dataclass
class Query:
    head: Tuple[str, ...]
    atoms: List[Atom]

    def variables(self) -> List[str]:
        seen: List[str] = []
        for a in self.atoms:
            for v in a.vars:
                if v not in seen:
                    seen.append(v)
        return seen


def is_consistent(atom: Atom, order: Sequence[str]) -> bool:
    pos = [order.index(v) for v in atom.vars]
    return pos == sorted(pos)


def rank_for_order(q: Query, order: Sequence[str]) -> int:
    """r_π(Q), 1-based (Def. 12). Triangle query with (x,y,z): 2."""
    r = 0
    for a in q.atoms:
        r = max(r, list(order).index(a.vars[0]) + 1)
    return r


def best_order(q: Query, allow_reorder: bool = True) -> Tuple[int, Tuple[str, ...]]:
    """Minimum-rank variable order; exhaustive (queries are small: data
    complexity treats the query as fixed, paper §1).

    With ``allow_reorder`` any permutation is feasible — an inconsistent
    atom gets a reordered index T_π, so its effective first variable is its
    earliest variable in the order. With ``allow_reorder=False`` (e.g. the
    atom's relation is a disk-resident edge store that cannot be cheaply
    re-sorted) only orders keeping every atom consistent as-written are
    considered; raises if none exists. Ties break lexicographically on the
    order tuple, so the choice is deterministic."""
    vs = q.variables()
    best: Optional[Tuple[int, Tuple[str, ...]]] = None
    for perm in itertools.permutations(vs):
        if allow_reorder:
            r = 0
            for a in q.atoms:
                first = min(perm.index(v) for v in a.vars)
                r = max(r, first + 1)
        else:
            if not all(is_consistent(a, perm) for a in q.atoms):
                continue
            r = rank_for_order(q, perm)
        if best is None or (r, perm) < best:
            best = (r, perm)
    if best is None:
        raise ValueError(
            "no variable order keeps every atom consistent; pass in-memory "
            "relations (reordered indexes can then be built, Prop. 3) or "
            "choose an order and pre-create the reordered stores")
    return best


def best_rank(q: Query) -> Tuple[int, Tuple[str, ...]]:
    """r(Q) = min over key orders (Def. 12), reordered indexes allowed."""
    return best_order(q, allow_reorder=True)


def validate(q: Query, order: Optional[Sequence[str]] = None,
             require_consistent: bool = False) -> Tuple[str, ...]:
    """Check a query is executable and resolve its variable order.

    Raises ``ValueError`` when the query is malformed (a head variable
    missing from the body, an order that is not a permutation of the body
    variables, or — with ``require_consistent`` — an atom inconsistent
    with the order). Returns the resolved order: the given one, or the
    minimum-rank order from ``best_order`` when ``order`` is ``None``.
    """
    vs = q.variables()
    if not q.atoms:
        raise ValueError("query has no body atoms")
    missing = [h for h in q.head if h not in vs]
    if missing:
        raise ValueError(f"head variables {missing} appear in no body atom")
    if order is None:
        return best_order(q, allow_reorder=not require_consistent)[1]
    order = tuple(order)
    if sorted(order) != sorted(vs):
        raise ValueError(
            f"order {order} is not a permutation of the query variables {vs}")
    if require_consistent:
        for a in q.atoms:
            if not is_consistent(a, order):
                raise ValueError(
                    f"atom {a.rel}{a.vars} inconsistent with order {order}; "
                    "pre-create a reordered index for it")
    return order


def rank(q: Query, order: Optional[Sequence[str]] = None) -> int:
    """Rank of a query (Def. 12): ``r_π(Q)`` for the given order, else the
    optimal ``r(Q)`` over all orders (reordered indexes allowed). Governs
    the Thm. 13 no-spill I/O bound O(|I|^r / (M^{r-1} B) + K/B)."""
    if order is not None:
        return rank_for_order(q, order)
    return best_rank(q)[0]


def reordered_index(rel: TrieArray, perm: Tuple[int, ...]) -> TrieArray:
    """T_π for a column permutation of ``rel`` (Prop. 3: one re-sort).

    Built indexes are memoized *on the source TrieArray* keyed by the
    permutation, so multi-atom queries sharing a relation (and repeated
    queries against the same relation) rebuild each T_π once, not per
    atom per call. The cache lives on the relation object itself — it is
    garbage-collected with the relation, and two relations never share
    entries even if one is freed and the other reuses its address."""
    cache = getattr(rel, "_reorder_cache", None)
    if cache is None:
        cache = {}
        rel._reorder_cache = cache
    ta = cache.get(perm)
    if ta is None:
        ta = TrieArray.from_tuples(rel.to_tuples()[:, list(perm)])
        cache[perm] = ta
    return ta


def build_indexes(q: Query, order: Sequence[str],
                  relations: Dict[str, TrieArray]):
    """Return (atoms', relations') where every atom is order-consistent.

    For an inconsistent atom R(y, x) a new index R__pi(x, y) is built by
    column permutation + re-sort (Prop. 3 cost) via ``reordered_index``,
    which memoizes per (relation, permutation): atoms sharing a relation
    and permutation share one T_π, across calls too."""
    out_atoms: List[Atom] = []
    out_rels: Dict[str, TrieArray] = dict(relations)
    for a in q.atoms:
        if is_consistent(a, order):
            out_atoms.append(a)
            continue
        perm = tuple(sorted(range(len(a.vars)),
                            key=lambda i: order.index(a.vars[i])))
        new_vars = tuple(a.vars[i] for i in perm)
        new_name = f"{a.rel}__{''.join(map(str, perm))}"
        if new_name not in out_rels:
            out_rels[new_name] = reordered_index(relations[a.rel], perm)
        out_atoms.append(Atom(new_name, new_vars))
    return out_atoms, out_rels


def run_query(q: Query, order: Sequence[str],
              relations: Dict[str, TrieArray],
              mem_words: Optional[int] = None,
              emit=None, device=None) -> int:
    """Execute a query: in-memory LFTJ, or boxed when mem_words is given.

    With a ``core.iomodel.BlockDevice`` the relations (including any
    reordered indexes) are registered on it and every element access runs
    through a ``CountingReader`` — the scalar-reference I/O measurement the
    Thm. 13 comparison uses (``query.QueryEngine`` is the production path)."""
    from .boxing import BoxedLFTJ, BoxingConfig
    from .iomodel import CountingReader
    from .leapfrog import LeapfrogTriejoin

    atoms, rels = build_indexes(q, order, relations)
    if mem_words is None:
        reader = None
        if device is not None:
            for ta in rels.values():
                device.register_triearray(ta)
            reader = CountingReader(device)
        j = LeapfrogTriejoin(atoms, list(order), rels, reader=reader)
        return j.run(emit=emit)
    cfg = BoxingConfig(mem_words=mem_words)
    bj = BoxedLFTJ(atoms, list(order), rels, cfg, emit=emit, device=device)
    return bj.run()
