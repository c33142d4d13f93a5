"""Box work-queue ordering and interval bookkeeping shared by the
streaming executor and the QueryEngine.

Only the numpy scheduling policies (``lpt_order`` and ``box_queue_order``)
and the §5 interval helpers (``merge_interval``, ``interval_gaps``) are
ported so far; multi-device sharding comes with its own slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def lpt_order(costs: Sequence[float]) -> List[int]:
    """Box indices in Longest-Processing-Time-first order (descending cost,
    ties broken by index so the order is deterministic).

    The async streaming scheduler (``core.executor.StreamingExecutor``)
    drains its work queue in this order, so the long-pole box starts first
    and its device compute overlaps every later slice build."""
    return sorted(range(len(costs)), key=lambda i: (-float(costs[i]), i))


def box_queue_order(costs: Sequence[float],
                    ledger_sensitive: bool) -> List[int]:
    """Priority order the triangle ``StreamingExecutor`` drains its box
    work-queue in.

    ``ledger_sensitive=False`` (pure in-memory source): LPT-first — only
    makespan matters, so the long-pole box starts first. With a slice
    cache or a charged block device attached (``ledger_sensitive=True``)
    the queue folds back to plan order: adjacent boxes share row blocks in
    plan order, and because fetches are serialized in queue order this
    keeps the device's LRU frame hits and the cache's hit/miss *sequence*
    identical to the ``workers=1`` oracle (the determinism contract the
    property tests pin).

    The plan-order fallback applies *whenever* a ledger is attached — even
    for a ``workers=1`` caller, where LPT would be equally safe (a serial
    drain IS the oracle in any order). That is deliberate, not an
    oversight: the drain order must be a function of the engine's
    configuration alone, never of its worker count, so a query's measured
    I/O ledger is reproducible across ``workers`` settings."""
    if ledger_sensitive:
        return list(range(len(costs)))
    return lpt_order(costs)


# ---------------------------------------------------------------------------
# interval bookkeeping (§5 slice dedup) — the QueryEngine's per-box
# fetch walk
# ---------------------------------------------------------------------------

def merge_interval(covered: List[Tuple[int, int]], lo: int,
                   hi: int) -> List[Tuple[int, int]]:
    """Insert the inclusive interval [lo, hi] into a sorted disjoint
    interval list, coalescing adjacent/overlapping entries."""
    out: List[Tuple[int, int]] = []
    placed = False
    for a, b in covered:
        if b + 1 < lo:
            out.append((a, b))
        elif hi + 1 < a:
            if not placed:
                out.append((lo, hi))
                placed = True
            out.append((a, b))
        else:
            lo, hi = min(lo, a), max(hi, b)
    if not placed:
        out.append((lo, hi))
    return sorted(out)


def interval_gaps(covered: List[Tuple[int, int]], lo: int,
                  hi: int) -> List[Tuple[int, int]]:
    """Sub-intervals of [lo, hi] not covered yet, ascending."""
    gaps = []
    cur = lo
    for a, b in covered:
        if b < cur:
            continue
        if a > hi:
            break
        if a > cur:
            gaps.append((cur, a - 1))
        cur = max(cur, b + 1)
        if cur > hi:
            break
    if cur <= hi:
        gaps.append((cur, hi))
    return gaps
