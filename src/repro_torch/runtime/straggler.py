"""Straggler detection + work-stealing for idempotent work items.

Two mechanisms (DESIGN.md §5):

* ``StepTimeWatchdog`` — records per-step wall times; flags a straggling
  step when it exceeds ``k`` × a robust (median-based) baseline. On a real
  fleet the flag triggers hot-spare swap / checkpoint-restart; here the
  policy object is what we test.

* ``BoxScheduler`` — the paper's boxes are overlap-free, idempotent work
  items (§3.3), which makes straggler mitigation trivial and *exact*:
  unfinished boxes are re-queued and duplicated results are deduplicated
  by box id. This is the triangle engine's distribution layer; the same
  scheduler drives multi-process CPU runs and the 512-chip plan.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set


class StepTimeWatchdog:
    def __init__(self, window: int = 32, threshold: float = 2.5,
                 min_samples: int = 8):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.min_samples = min_samples
        self.flagged: List[int] = []
        self._step = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self._step += 1
        if len(self.times) >= self.min_samples:
            med = sorted(self.times)[len(self.times) // 2]
            if seconds > self.threshold * med:
                self.flagged.append(self._step)
                self.times.append(seconds)
                return True
        self.times.append(seconds)
        return False


@dataclass
class BoxTask:
    box_id: int
    payload: object = None
    assigned_to: Optional[int] = None
    t_assigned: float = 0.0
    done: bool = False
    result: object = None


class BoxScheduler:
    """Work-stealing scheduler over idempotent boxes.

    Thread-safe: the serving layer (``repro_torch.serve``) drives one
    scheduler per query from several box-pool worker threads — completion
    dedup and re-queuing serialize on an internal lock, so a box that a
    retry round and a straggler duplicate both finish is counted exactly
    once (``complete`` returns whether this completion was the effective
    one, ``duplicates``/``requeues`` tally the rest)."""

    def __init__(self, boxes: Sequence, n_workers: int,
                 steal_after_s: float = 60.0):
        self.tasks = {i: BoxTask(i, b) for i, b in enumerate(boxes)}
        self.queue = deque(self.tasks)
        self.n_workers = n_workers
        self.steal_after_s = steal_after_s
        self.inflight: Dict[int, Set[int]] = {w: set() for w in range(n_workers)}
        self.duplicates = 0
        self.requeues = 0
        self._lock = threading.RLock()

    def next_for(self, worker: int, now: Optional[float] = None) -> Optional[BoxTask]:
        now = time.monotonic() if now is None else now
        with self._lock:
            while self.queue:
                tid = self.queue.popleft()
                t = self.tasks[tid]
                if t.done:
                    continue
                t.assigned_to = worker
                t.t_assigned = now
                self.inflight[worker].add(tid)
                return t
            # steal the longest-outstanding task from another worker
            victim = None
            for w, tids in self.inflight.items():
                if w == worker:
                    continue
                for tid in tids:
                    t = self.tasks[tid]
                    if t.done or now - t.t_assigned < self.steal_after_s:
                        continue
                    if victim is None or t.t_assigned < victim.t_assigned:
                        victim = t
            if victim is not None:
                self.duplicates += 1
                self.inflight[worker].add(victim.box_id)
                return victim
            return None

    def complete(self, worker: int, box_id: int, result) -> bool:
        """Idempotent completion: the first result wins; returns whether
        this completion was the effective one."""
        with self._lock:
            t = self.tasks[box_id]
            self.inflight[worker].discard(box_id)
            if t.done:
                return False
            t.done = True
            t.result = result
            return True

    def requeue(self, box_ids: Sequence[int]) -> int:
        """Re-queue not-yet-done boxes (a failed/cancelled attempt handing
        its work back — boxes are idempotent, so re-running is exact).
        Returns how many were actually re-queued; already-done boxes are
        skipped, which is the dedup-by-box-id contract."""
        n = 0
        with self._lock:
            for tid in box_ids:
                t = self.tasks[tid]
                if t.done:
                    continue
                t.assigned_to = None
                self.queue.append(tid)
                self.requeues += 1
                n += 1
        return n

    def pending(self) -> List[int]:
        """Box ids not yet effectively completed, in box order."""
        with self._lock:
            return [i for i in sorted(self.tasks) if not self.tasks[i].done]

    def all_done(self) -> bool:
        with self._lock:
            return all(t.done for t in self.tasks.values())

    def results(self):
        with self._lock:
            return [self.tasks[i].result for i in sorted(self.tasks)]


def fail_worker(sched: BoxScheduler, worker: int) -> int:
    """Simulated worker death: re-queue its in-flight boxes. Returns count."""
    with sched._lock:
        tids = list(sched.inflight[worker])
        for tid in tids:
            sched.inflight[worker].discard(tid)
            if not sched.tasks[tid].done:
                sched.queue.append(tid)
        return len(tids)
