"""Admission control: N concurrent queries partition one memory budget.

The paper's I/O envelopes (Thm. 10 for triangles, Thm. 13 rank-r for
general patterns) are statements about a *single* execution with memory
``M``: the box planner cuts the variable space so every box's working set
fits ``M``, and the measured block reads stay within ``O(|E|^{3/2}/(MB))``
(resp. ``O(|I|^r/(M^{r-1}B))``). A resident service breaks that silently
if every concurrent query assumes the whole budget — N queries each
planned against ``M`` jointly hold ``N·M`` words and the per-query
envelope means nothing.

``AdmissionController`` restores the invariant by *partitioning*: a query
is admitted with a reservation ``m_i`` carved out of the global
``total_words``, plans its boxes against ``m_i`` (never the global
budget), and holds the reservation until it finishes. The controller
guarantees

    Σ_i m_i  ≤  total_words          (never oversubscribed)
    m_i      ≥  min_words            (a grant you can actually plan with)

Grant sizing is *fair-share*: an arrival under contention is offered
``total // (active + waiting + 1)`` (floored at ``min_words``, rounded
down to a power of two so the per-budget plan/compile caches converge on
a handful of distinct budgets instead of one per admission). Reclaiming
is release-driven: a finishing query's words return to the pool and every
waiter is re-notified — the fair share grows back as load drains.

When admission would oversubscribe, callers either *queue* (bounded by
``queue_depth``; a full queue rejects immediately) or time out:
``AdmissionRejected`` / ``AdmissionTimeout`` are the graceful-degradation
surface the server maps to per-query errors.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional


class AdmissionError(RuntimeError):
    """Base class of admission failures (never raised itself)."""


class AdmissionRejected(AdmissionError):
    """No capacity and no queue slot: the submission is turned away."""


class AdmissionTimeout(AdmissionError):
    """Queued for admission but capacity did not free up in time."""


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


@dataclass
class Reservation:
    """One admitted query's slice of the budget. Release exactly once
    (idempotent); ``words`` is the planning budget ``m_i``."""

    words: int
    tag: object = None
    _ctrl: Optional["AdmissionController"] = field(default=None, repr=False)
    _released: bool = field(default=False, repr=False)

    def release(self) -> None:
        if self._released or self._ctrl is None:
            return
        self._released = True
        self._ctrl._release(self)

    def __enter__(self) -> "Reservation":
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class AdmissionController:
    """Partitions ``total_words`` into per-query reservations."""

    def __init__(self, total_words: int, *,
                 min_words: int = 1 << 12,
                 max_active: Optional[int] = None,
                 queue_depth: int = 8):
        self.total_words = int(total_words)
        self.min_words = max(1, int(min_words))
        if self.min_words > self.total_words:
            raise ValueError(
                f"min_words {self.min_words} exceeds the total budget "
                f"{self.total_words}: nothing could ever be admitted")
        self.max_active = max_active if max_active is None \
            else max(1, int(max_active))
        self.queue_depth = max(0, int(queue_depth))
        self._cond = threading.Condition()
        self._reserved = 0
        self._active = 0
        self._waiting = 0
        # telemetry for the load benchmark / stress suite
        self.peak_active = 0
        self.peak_reserved = 0
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_timeouts = 0
        self.n_queued = 0

    # -- introspection (the stress suite's invariants) -----------------------

    @property
    def reserved_words(self) -> int:
        with self._cond:
            return self._reserved

    @property
    def active(self) -> int:
        with self._cond:
            return self._active

    @property
    def waiting(self) -> int:
        with self._cond:
            return self._waiting

    # -- admission -----------------------------------------------------------

    def _grant_locked(self, want: Optional[int]) -> Optional[int]:
        """Grant size if admissible right now, else ``None``. The offer is
        the fair share under current contention, power-of-two floored,
        clipped to the remaining pool; ``want`` caps it from above."""
        if self.max_active is not None and self._active >= self.max_active:
            return None
        avail = self.total_words - self._reserved
        if avail < self.min_words:
            return None
        share = self.total_words // (self._active + self._waiting + 1)
        grant = max(self.min_words, _pow2_floor(share))
        if want is not None:
            grant = min(grant, max(self.min_words, int(want)))
        grant = min(grant, avail)
        if grant >= self.min_words and grant > _pow2_floor(grant):
            # keep the pow2 quantization whenever it doesn't starve the
            # grant below min_words (distinct budgets stay logarithmic)
            q = _pow2_floor(grant)
            if q >= self.min_words:
                grant = q
        return grant

    def acquire(self, want_words: Optional[int] = None, *,
                timeout: Optional[float] = None,
                block: bool = True,
                tag: object = None) -> Reservation:
        """Admit one query: returns its ``Reservation`` (budget ``m_i``).

        ``want_words`` caps the grant (e.g. a known-small query declining
        the full fair share). ``block=False`` turns a would-queue into an
        immediate ``AdmissionRejected``; otherwise the caller queues —
        bounded by ``queue_depth`` — until capacity frees or ``timeout``
        (seconds) elapses (``AdmissionTimeout``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            grant = self._grant_locked(want_words)
            if grant is None:
                if not block:
                    self.n_rejected += 1
                    raise AdmissionRejected(
                        f"admission would oversubscribe: {self._reserved}"
                        f"/{self.total_words} words reserved, "
                        f"{self._active} active")
                if self._waiting >= self.queue_depth:
                    self.n_rejected += 1
                    raise AdmissionRejected(
                        f"admission queue full ({self._waiting} waiting, "
                        f"depth {self.queue_depth})")
                self._waiting += 1
                self.n_queued += 1
                try:
                    while grant is None:
                        remaining = None if deadline is None \
                            else deadline - time.monotonic()
                        if remaining is not None and remaining <= 0:
                            self.n_timeouts += 1
                            raise AdmissionTimeout(
                                f"no capacity within {timeout}s "
                                f"({self._reserved}/{self.total_words} "
                                "words reserved)")
                        self._cond.wait(remaining)
                        grant = self._grant_locked(want_words)
                finally:
                    self._waiting -= 1
            self._reserved += grant
            self._active += 1
            self.n_admitted += 1
            self.peak_active = max(self.peak_active, self._active)
            self.peak_reserved = max(self.peak_reserved, self._reserved)
            assert self._reserved <= self.total_words, \
                "admission invariant violated: Σ reservations > total"
            return Reservation(words=grant, tag=tag, _ctrl=self)

    def _release(self, res: Reservation) -> None:
        with self._cond:
            self._reserved -= res.words
            self._active -= 1
            assert self._reserved >= 0 and self._active >= 0
            self._cond.notify_all()
