"""Persistent concurrent query serving on a torch device.

``Server`` keeps relations warm (mmap ``EdgeStore`` / in-memory CSR on one
shared ``BlockDevice``) and serves concurrent pattern queries with the
paper's per-query I/O envelopes intact: admission control partitions
``mem_words`` into per-query reservations (boxes planned against the
partition, Thm. 10/13 per query), a floor-protected ``SharedSliceCache``
spans queries per relation, box plans are memoized per pattern shape, and
failed/cancelled boxes re-queue idempotently through the straggler
scheduler. Queries run as threads in one process; their kernel launches
(intersect, fused count, fused listing) share the card's default stream.
See ``serve.server`` / ``serve.admission`` / ``serve.cache``.

    with Server.from_graph(src, dst, mem_words=1 << 20) as srv:  # the card
        h = srv.submit("triangle", "count")
        n = h.result()
        for page in srv.submit("four_clique", "list",
                               stream=True).pages():
            ...

``Server(..., torch_device="cpu")`` runs the kernel wrappers' plain
versions instead.
"""

from .admission import (AdmissionController, AdmissionError,
                        AdmissionRejected, AdmissionTimeout, Reservation)
from .cache import SharedSliceCache, TenantStats, TenantView
from .server import (QueryCancelled, QueryError, QueryFailed, QueryHandle,
                     Server, Session)

__all__ = [
    "AdmissionController", "AdmissionError", "AdmissionRejected",
    "AdmissionTimeout", "Reservation",
    "SharedSliceCache", "TenantStats", "TenantView",
    "QueryCancelled", "QueryError", "QueryFailed", "QueryHandle",
    "Server", "Session",
]
