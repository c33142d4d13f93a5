"""Per-box device-invocation / transfer-bytes ledger for the kernel lanes.

Launch counts are measured, not asserted: the kernel wrapper whose lane
the reference also notes (``kernels/intersect``) calls :func:`note` once
per kernel launch, with the byte counts it moved in and out. The dense,
binary and listing lanes note nothing, exactly as in the reference, so
``EngineStats.device_invocations`` matches it box for box. Executors
attach a :class:`KernelLedger` around each box's join and fold the totals
into ``EngineStats``.

The attachment is thread-local so the multi-worker box scheduler's
concurrent joins each see only their own box's launches; ledgers nest
(an outer run-level ledger and an inner per-box one both accumulate), and
:func:`note` is a no-op when nothing is attached, so the kernels stay
usable standalone.
"""

from __future__ import annotations

import threading
from typing import List, Optional


class KernelLedger:
    """Accumulated device launches and padded transfer bytes."""

    __slots__ = ("invocations", "bytes_in", "bytes_out")

    def __init__(self) -> None:
        self.invocations = 0
        self.bytes_in = 0
        self.bytes_out = 0

    @property
    def transfer_bytes(self) -> int:
        return self.bytes_in + self.bytes_out


_tls = threading.local()


def _stack() -> List[KernelLedger]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class attach:
    """Context manager scoping kernel launches to ``ledger`` (current
    thread only). ``with attach() as kl: ...`` creates a fresh ledger.
    Passing ``tracer=`` additionally mirrors every :func:`note` inside
    the scope as a ``kernel.launch`` instant event on that tracer (the
    observability layer's per-launch timeline marks)."""

    def __init__(self, ledger: Optional[KernelLedger] = None, tracer=None):
        self.ledger = ledger if ledger is not None else KernelLedger()
        self.tracer = tracer

    def __enter__(self) -> KernelLedger:
        _stack().append((self.ledger, self.tracer))
        return self.ledger

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        return False


def note(invocations: int = 1, bytes_in: int = 0, bytes_out: int = 0) -> None:
    """Record ``invocations`` device launches on every attached ledger
    (and emit a ``kernel.launch`` trace event per tracer-carrying
    attachment)."""
    for kl, tracer in _stack():
        kl.invocations += invocations
        kl.bytes_in += bytes_in
        kl.bytes_out += bytes_out
        if tracer is not None:
            tracer.event("kernel.launch", invocations=invocations,
                         bytes_in=bytes_in, bytes_out=bytes_out)
