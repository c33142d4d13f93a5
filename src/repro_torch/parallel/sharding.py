"""Box work-queue ordering shared by the streaming executor.

Only the numpy scheduling policies are ported so far (``lpt_order`` and
``box_queue_order``); multi-device sharding comes with its own slice.
"""

from __future__ import annotations

from typing import List, Sequence


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
