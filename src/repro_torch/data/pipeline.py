"""Host-side input pipeline: prefetching and edge batching.

Two consumers share this module:

* the **streaming executor** (``core.executor``) wraps its per-box slice
  materialization in a ``Prefetcher`` so host DMA overlaps device compute;
* the **ingest path** (``TriangleEngine.ingest`` ->
  ``data.edgestore.EdgeStoreWriter``) wraps the edge-batch producer in a
  depth-1 ``Prefetcher`` so reading/generating the next batch overlaps the
  writer's sort-and-spill work, and uses ``edge_batches`` to slice big
  in-memory arrays into bounded batches.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np


def edge_batches(src, dst, batch_edges: int = 1 << 20) -> Iterator:
    """Yield ``(src, dst)`` batches of at most ``batch_edges`` edges.

    Convenience for feeding already-materialized arrays to the streaming
    ingest path; each yielded pair is a view, so the generator itself
    allocates nothing.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if len(src) != len(dst):
        raise ValueError("src and dst differ in length")
    batch_edges = max(1, int(batch_edges))
    for i in range(0, len(src), batch_edges):
        yield src[i:i + batch_edges], dst[i:i + batch_edges]


class Prefetcher:
    """Runs ``producer()`` on a background thread, ``depth`` batches ahead.

    Iteration order is preserved; exceptions propagate to the consumer.
    """

    _SENTINEL = object()

    def __init__(self, producer: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.err: Optional[BaseException] = None
        self._stop = False
        self._closed = False

        def run():
            try:
                for item in producer:
                    while not self._stop:
                        try:
                            self.q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop:
                        break
            except BaseException as e:  # noqa: BLE001
                self.err = e
            finally:
                while True:
                    try:
                        self.q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        if self._stop:
                            break

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._SENTINEL:
            if self.err is not None:
                raise self.err
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer early (consumer abandons the stream).

        The background thread stops at its next queue hand-off; already
        queued items are discarded and the thread is joined, so a closed
        prefetcher never leaks its producer. Idempotent: double-close (or
        close after exhaustion) is a cheap no-op."""
        self._stop = True
        if self._closed:
            return
        # drain until the producer exits: it may be blocked mid-put, so one
        # drain pass is not enough to guarantee progress
        deadline = time.monotonic() + timeout
        while True:
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)
            if not self.thread.is_alive() or time.monotonic() > deadline:
                break
        self._closed = True
