"""Multi-tenant shared ``SliceCache`` for the serving layer.

One warm graph serves many concurrent queries, and adjacent queries walk
overlapping row ranges — the whole point of a resident server is that
query B hits the slabs query A just pulled in. But a naively shared LRU
lets one scan-heavy query evict everything, silently destroying the
budget-partition contract admission control just established.

``SharedSliceCache`` extends the single-query
:class:`~repro_torch.core.executor.SliceCache` with *tenants*:

* every admitted query registers with a **floor** — a slice of the cache
  budget reserved for it (``Σ floors ≤ budget_words``, checked);
* every cached block has an **owner**: the tenant whose miss fetched it
  (blocks of departed tenants become ownerless);
* eviction is **floor-protected LRU**: walking blocks in global LRU
  order, a block is evictable only if it is ownerless or its owner holds
  strictly more cached words than its floor *after* the eviction. A
  tenant therefore always keeps at least ``floor`` words of its own
  hottest blocks resident no matter what its neighbours do — its miss
  count is bounded by a solo run with a ``floor``-sized cache
  (inclusion), while everything above the floors is genuinely shared
  (cross-tenant hits are free wins, and the stress suite checks they
  only ever *reduce* cache-layer misses).

Accounting is two-level: per-tenant ``{hits, misses, hit_words,
miss_words, passthrough_words, words}`` plus the inherited global
counters — the property tests assert the tenant ledgers sum exactly to
the global one. ``snapshot()`` byte-captures the cache contents so the
fault-injection suite can prove a failed query never poisons what its
neighbours see.

Tenants access the cache through :class:`TenantView`, which looks like an
EdgeSource (it IS what the server hands ``QueryEngine`` as a relation):
``read_rows`` routes through the shared cache with this tenant's
attribution; every other attribute proxies to the underlying source.

The victim is the reference's, found through an index rather than by
walking the global LRU order: each live tenant's blocks and the ownerless
ones are kept in their own LRU orders, and by size, with each block's
last touch, so the first evictable block of each owner is found without
walking past the blocks the other tenants' floors protect, and the
earliest-touched of those few is the block the walk would reach first.
The walk costs a pass over every protected block per eviction: with two
tenants at their floors over a store larger than the cache, two store
diamonds at 2^16 words served at once took 68.6 s on an H100 host
against 2.8 s alone, and 9.4 s with the index (``chip_smoke.py``'s serve
phase).
"""

from __future__ import annotations

import bisect
import heapq
import itertools
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.executor import SliceCache


class TenantStats:
    """Mutable per-tenant cache ledger (kept after ``unregister``)."""

    __slots__ = ("floor", "words", "hits", "misses",
                 "hit_words", "miss_words", "passthrough_words")

    def __init__(self, floor: int):
        self.floor = int(floor)
        self.words = 0
        self.hits = 0
        self.misses = 0
        self.hit_words = 0
        self.miss_words = 0
        self.passthrough_words = 0

    def as_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.__slots__}


class _Blocks:
    """One owner's cached blocks (a live tenant's, or the ownerless ones)
    in LRU order, and by size: for each size present, its blocks in LRU
    order, with the sizes kept sorted."""

    __slots__ = ("lru", "by_size", "sizes")

    def __init__(self):
        self.lru: OrderedDict = OrderedDict()       # block id -> words
        self.by_size: Dict[int, OrderedDict] = {}
        self.sizes: list = []

    def add(self, bid: int, words: int) -> None:
        self.lru[bid] = words
        same = self.by_size.get(words)
        if same is None:
            same = self.by_size[words] = OrderedDict()
            bisect.insort(self.sizes, words)
        same[bid] = None

    def touch(self, bid: int) -> None:
        self.lru.move_to_end(bid)
        self.by_size[self.lru[bid]].move_to_end(bid)

    def remove(self, bid: int) -> None:
        words = self.lru.pop(bid)
        same = self.by_size[words]
        del same[bid]
        if not same:
            del self.by_size[words]
            del self.sizes[bisect.bisect_left(self.sizes, words)]

    def first(self, exclude: int, slack: Optional[int], touch: dict):
        """The least recently touched block other than ``exclude`` of at
        most ``slack`` words (any size when ``slack`` is None)."""
        for bid, words in self.lru.items():     # the LRU head, usually
            if bid == exclude:
                continue
            if slack is None or words <= slack:
                return bid
            break
        if slack is None:
            return None
        best = None
        for words in self.sizes[:bisect.bisect_right(self.sizes, slack)]:
            for bid in self.by_size[words]:
                if bid != exclude:
                    if best is None or touch[bid] < touch[best]:
                        best = bid
                    break
        return best


class SharedSliceCache(SliceCache):
    """One cache, many queries; floor-protected eviction (module doc)."""

    def __init__(self, source, budget_words: int,
                 block_rows: Optional[int] = None, tracer=None):
        super().__init__(source, budget_words, block_rows, tracer=tracer)
        self._owner: Dict[int, object] = {}       # block id -> tenant | None
        self._tenants: Dict[object, TenantStats] = {}
        self._gone: Dict[object, TenantStats] = {}  # stats after unregister
        self._cur: Optional[object] = None          # tenant of current read
        self.cross_hits = 0      # hits on a block some other tenant fetched
        # the victim index: per live tenant (None: the ownerless blocks)
        # its blocks, and each block's owner key and last touch
        self._index: Dict[object, _Blocks] = {None: _Blocks()}
        self._key: Dict[int, object] = {}
        self._touch: Dict[int, int] = {}
        self._ticks = itertools.count()

    # -- tenant lifecycle ----------------------------------------------------

    def register(self, tenant, floor_words: int = 0) -> "TenantView":
        with self._lock:
            if tenant in self._tenants:
                raise ValueError(f"tenant {tenant!r} already registered")
            floors = sum(t.floor for t in self._tenants.values())
            floor_words = int(floor_words)
            if floors + floor_words > self.budget_words:
                raise ValueError(
                    f"floor {floor_words} would oversubscribe the cache: "
                    f"{floors}/{self.budget_words} words already reserved")
            self._tenants[tenant] = TenantStats(floor_words)
            self._index[tenant] = _Blocks()
            return TenantView(self, tenant)

    def unregister(self, tenant) -> TenantStats:
        """Drop a tenant: its blocks stay cached (warm for neighbours) but
        become ownerless — freely evictable. Returns its final ledger."""
        with self._lock:
            st = self._tenants.pop(tenant)
            for bid, owner in list(self._owner.items()):
                if owner == tenant:
                    self._owner[bid] = None
            self._gone[tenant] = st
            # its blocks join the ownerless ones, in touch order
            mine, free = self._index.pop(tenant), _Blocks()
            words = {**self._index[None].lru, **mine.lru}
            for bid in heapq.merge(self._index[None].lru, mine.lru,
                                   key=self._touch.__getitem__):
                free.add(bid, words[bid])
                self._key[bid] = None
            self._index[None] = free
            return st

    def tenant_stats(self, tenant) -> TenantStats:
        with self._lock:
            return self._tenants.get(tenant) or self._gone[tenant]

    def all_tenant_stats(self) -> Dict[object, TenantStats]:
        """Every tenant's ledger, live AND departed (``unregister`` keeps
        the final stats). The observability registry mirrors this into
        ``cache.*{tenant=...}`` series; because every ``read_rows_for``
        is attributed, the per-tenant counters sum exactly to the
        inherited global ones."""
        with self._lock:
            out: Dict[object, TenantStats] = dict(self._gone)
            out.update(self._tenants)
            return out

    # -- attributed reads ----------------------------------------------------

    def read_rows_for(self, tenant, lo: int,
                      hi: int) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            if tenant not in self._tenants:
                raise KeyError(f"tenant {tenant!r} not registered")
            prev, self._cur = self._cur, tenant
            try:
                return self._read_rows_locked(lo, hi)
            finally:
                self._cur = prev

    # -- SliceCache hooks: per-tenant attribution ----------------------------

    def _hit(self, bid: int, ent) -> None:
        super()._hit(bid, ent)
        self._index[self._key[bid]].touch(bid)
        self._touch[bid] = next(self._ticks)
        st = self._tenants.get(self._cur)
        if st is not None:
            st.hits += 1
            st.hit_words += len(ent[1])
        if self._owner.get(bid) != self._cur:
            self.cross_hits += 1

    def _miss(self, n_blocks: int, n_words: int) -> None:
        super()._miss(n_blocks, n_words)
        st = self._tenants.get(self._cur)
        if st is not None:
            st.misses += n_blocks
            st.miss_words += n_words

    def _read_through(self, lo: int, hi: int):
        ip, vals = super()._read_through(lo, hi)
        st = self._tenants.get(self._cur)
        if st is not None:
            st.passthrough_words += len(vals)
        return ip, vals

    # -- floor-protected eviction --------------------------------------------

    def _victim_locked(self, exclude: int) -> Optional[int]:
        """The first block other than ``exclude``, in global LRU order,
        that is ownerless or whose owner keeps at least its floor after
        losing it (``None``: every other block is floor-protected). Each
        owner's first such block is found in that owner's own LRU order;
        the earliest-touched of them is the global first."""
        best = None
        for key, blocks in self._index.items():
            slack = None
            if key is not None:
                st = self._tenants[key]
                slack = st.words - st.floor
            vbid = blocks.first(exclude, slack, self._touch)
            if vbid is not None and (
                    best is None or self._touch[vbid] < self._touch[best]):
                best = vbid
        return best

    def _insert(self, bid: int, ent) -> None:
        # (re)charge the inserting tenant for this block
        old = self._blocks.pop(bid, None)
        if old is not None:
            self._words -= self._entry_words(old)
            self._uncharge(bid, old)
        self._blocks[bid] = ent
        self._words += self._entry_words(ent)
        self._owner[bid] = self._cur
        key = self._cur if self._cur in self._tenants else None
        self._key[bid] = key
        self._index[key].add(bid, self._entry_words(ent))
        self._touch[bid] = next(self._ticks)
        st = self._tenants.get(self._cur)
        if st is not None:
            st.words += self._entry_words(ent)
        while self._words > self.budget_words and len(self._blocks) > 1:
            victim = self._victim_locked(bid)
            if victim is None:
                # every other resident block sits inside some tenant's
                # floor: soft-exceed the budget rather than break the
                # reservation contract (the floors sum ≤ budget, so the
                # overshoot is bounded by one block per tenant)
                break
            vent = self._blocks.pop(victim)
            self._words -= self._entry_words(vent)
            self._uncharge(victim, vent)
            tr = self.tracer
            if tr is not None:
                tr.event("cache.evict", block=victim,
                         words=self._entry_words(vent))

    def _uncharge(self, bid: int, ent) -> None:
        owner = self._owner.pop(bid, None)
        st = self._tenants.get(owner) if owner is not None else None
        if st is not None:
            st.words -= self._entry_words(ent)
        self._index[self._key.pop(bid)].remove(bid)
        del self._touch[bid]

    def clear(self) -> None:
        with self._lock:
            super().clear()
            self._owner.clear()
            for st in self._tenants.values():
                st.words = 0
            for key in self._index:
                self._index[key] = _Blocks()
            self._key.clear()
            self._touch.clear()

    # -- fault-injection forensics -------------------------------------------

    def snapshot(self) -> Dict[int, Tuple[bytes, bytes]]:
        """Byte-exact capture of the cache contents (LRU order implicit in
        key iteration): the poisoning test diffs this across a failed
        neighbour query."""
        with self._lock:
            return {bid: (ent[0].tobytes(), ent[1].tobytes())
                    for bid, ent in self._blocks.items()}


class TenantView:
    """EdgeSource facade binding one tenant to the shared cache.

    ``read_rows`` goes through the shared cache with this tenant's
    attribution; all other attributes (``n_nodes``, ``degrees``,
    ``indptr``, ``device``, ...) proxy to the wrapped source, so a
    ``QueryEngine`` can use a view anywhere it accepts an EdgeSource.
    """

    def __init__(self, shared: SharedSliceCache, tenant):
        self._shared = shared
        self._tenant = tenant

    def read_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._shared.read_rows_for(self._tenant, lo, hi)

    @property
    def stats(self) -> TenantStats:
        return self._shared.tenant_stats(self._tenant)

    def __getattr__(self, name):
        return getattr(self._shared.source, name)
