"""Canonical graph-pattern queries over the oriented edge relation.

Every pattern is a full conjunctive query (paper §2.1, Def. 12) over ONE
binary relation — by convention named ``"E"`` — holding the DAG-oriented
edge set G* (paper §2.3). Semantics are the standard CQ bag-of-bindings
semantics over that *directed* relation:

* ``triangle`` and ``k_clique`` counts are orientation-invariant: an
  undirected k-clique maps to exactly one increasing binding under any
  acyclic orientation, so the CQ count equals the undirected subgraph
  count (this is why ``QueryEngine`` on the triangle query reproduces
  ``TriangleEngine`` exactly).
* ``diamond`` / ``path`` / ``cycle`` are DAG patterns: their counts depend
  on the orientation (a 2-path x→y→z exists only where the orientation
  chains), and distinct variables may bind equal values when no atom
  separates them (e.g. the diamond's two middle variables) — exactly what
  LFTJ enumerates. The brute-force references in the test suite implement
  the same semantics over the same oriented relation.

All patterns are consistent with their natural variable order, so they run
against a disk-resident edge store without reordered indexes; ``rank``
values (Def. 12): triangle 2, k-clique k-1, diamond 3, k-path ≤ k-1.
"""

from __future__ import annotations

from itertools import combinations
from typing import List

from repro_torch.core.leapfrog import Atom
from repro_torch.core.queries import Query

EDGE_REL = "E"


def triangle() -> Query:
    """T(x,y,z) <- E(x,y), E(x,z), E(y,z)   (paper eq. Δ)."""
    return Query(head=("x", "y", "z"),
                 atoms=[Atom(EDGE_REL, ("x", "y")),
                        Atom(EDGE_REL, ("x", "z")),
                        Atom(EDGE_REL, ("y", "z"))])


def k_clique(k: int) -> Query:
    """All-pairs-adjacent on k variables; k=3 is the triangle, k=4 the
    4-clique with rank 3 (the Thm. 13 showcase beyond triangles)."""
    if k < 2:
        raise ValueError("k_clique needs k >= 2")
    vs = tuple(f"v{i}" for i in range(k))
    atoms = [Atom(EDGE_REL, (vs[i], vs[j]))
             for i, j in combinations(range(k), 2)]
    return Query(head=vs, atoms=atoms)


def four_clique() -> Query:
    return k_clique(4)


def diamond() -> Query:
    """D(x,y,z,w) <- E(x,y), E(x,z), E(y,w), E(z,w): the directed diamond
    (out-fan x→{y,z} closing on w) — the classic WCOJ benchmark pattern;
    on a minmax-oriented graph each undirected 4-cycle {a<b,c<d} appears
    as its two (y,z) orderings plus the degenerate y=z two-paths."""
    return Query(head=("x", "y", "z", "w"),
                 atoms=[Atom(EDGE_REL, ("x", "y")),
                        Atom(EDGE_REL, ("x", "z")),
                        Atom(EDGE_REL, ("y", "w")),
                        Atom(EDGE_REL, ("z", "w"))])


def path(k: int = 3) -> Query:
    """k-edge directed path v0→v1→...→vk over the DAG orientation."""
    if k < 1:
        raise ValueError("path needs k >= 1 edges")
    vs = tuple(f"v{i}" for i in range(k + 1))
    atoms = [Atom(EDGE_REL, (vs[i], vs[i + 1])) for i in range(k)]
    return Query(head=vs, atoms=atoms)


def cycle(k: int = 4) -> Query:
    """k-cycle as a DAG pattern: an increasing (k-1)-edge chain closed by
    the chord E(v0, v_{k-1}); k=3 degenerates to the triangle."""
    if k < 3:
        raise ValueError("cycle needs k >= 3")
    vs = tuple(f"v{i}" for i in range(k))
    atoms = [Atom(EDGE_REL, (vs[i], vs[i + 1])) for i in range(k - 1)]
    atoms.append(Atom(EDGE_REL, (vs[0], vs[k - 1])))
    return Query(head=vs, atoms=atoms)


PATTERNS = {
    "triangle": triangle,
    "four_clique": four_clique,
    "diamond": diamond,
    "path3": lambda: path(3),
    "cycle4": lambda: cycle(4),
}


def pattern_names() -> List[str]:
    return list(PATTERNS)
