"""Block-granular I/O cost model (paper §1 'Model & Assumptions').

The container is CPU-only, so instead of timing a disk we *count* block I/Os
in the paper's own model: data lives on a virtual block device with block
size ``B`` words; an access to a word not resident in the ``M/B``-frame
cache costs one I/O; the replacement policy is LRU (what Prop. 4's
adversarial construction targets).

numpy views share memory with their base buffer, so registering the *base*
array by data pointer makes every slice/view alias the correct device
blocks automatically — provisioning reads of a TrieArraySlice are charged to
the region of the source TrieArray, exactly like a DMA from disk.

Thread safety: the async box scheduler (``core.executor``) charges reads and
output writes from several worker threads against ONE shared device, so all
accounting entry points (``register`` / ``touch`` / ``read_range`` /
``write_words`` / ``serve_from_cache``) serialize on an internal lock — the
``IOStats`` counters and the LRU frame list never tear under concurrency.
The lock is uncontended in single-threaded runs (scalar LFTJ probing pays
one fast acquire per ``touch``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np


def _nd_base(arr: np.ndarray) -> np.ndarray:
    """Outermost *ndarray* owning the buffer. An ``np.memmap``'s base chain
    bottoms out in a raw ``mmap.mmap`` (no array interface), so the walk
    stops at the last ndarray — views of plain arrays and of memmaps alike
    resolve to one canonical base."""
    base = arr
    while isinstance(base.base, np.ndarray):
        base = base.base
    return base


@dataclass
class IOStats:
    block_reads: int = 0
    block_writes: int = 0
    word_reads: int = 0
    probes: int = 0
    # words a host-side cache above the device served *without* issuing a
    # read (core.executor.SliceCache hits) — the device's counters stay
    # honest, and the saved traffic is still visible in one place
    cache_served_words: int = 0

    def reset(self):
        self.block_reads = self.block_writes = self.word_reads = self.probes = 0
        self.cache_served_words = 0


class BlockDevice:
    """Virtual block device + LRU buffer cache, counting block I/Os.

    **Tagged attribution (the serving layer's partitioned-memory model).**
    ``open_tag(tag, cache_blocks=k)`` creates a *partition*: its own
    ``k``-frame LRU and its own ``IOStats``. While a thread runs inside
    ``with device.attributed(tag):`` every access it issues consults the
    tag's private frames (not the shared ones) and is charged to *both*
    the tag's stats and the global ``stats`` — so N concurrent queries
    each see exactly the frame behaviour of a solo run with ``m_i/B``
    frames (Pagh & Silvestri's bound applied per partition of M), while
    the global ledger stays the plain sum over partitions. Attribution is
    thread-local: each query's worker threads tag their own reads against
    one shared device without interfering.
    """

    def __init__(self, block_words: int = 4096, cache_blocks: int = 1024):
        self.B = int(block_words)
        self.cache_blocks = int(cache_blocks)
        self._regions = {}          # base data ptr -> (start_word, n_words, itemsize)
        self._next_word = 0
        self._cache: OrderedDict = OrderedDict()  # block id -> True
        self.stats = IOStats()
        # per-tag partitions: tag -> (frame OrderedDict, frame budget, stats)
        self._tags: dict = {}
        self._tls = threading.local()
        # all accounting serializes here: concurrent slice builders and
        # listing writers share one device ledger (see module docstring)
        self._lock = threading.Lock()

    # -- tagged attribution --------------------------------------------------

    def open_tag(self, tag, cache_blocks: int) -> None:
        """Create (or resize) the ``tag`` partition: a private LRU of
        ``cache_blocks`` frames plus a private ``IOStats`` ledger."""
        with self._lock:
            if tag in self._tags:
                frames, _, stats = self._tags[tag]
                self._tags[tag] = (frames, max(1, int(cache_blocks)), stats)
            else:
                self._tags[tag] = (OrderedDict(), max(1, int(cache_blocks)),
                                   IOStats())

    def close_tag(self, tag) -> IOStats:
        """Drop the partition's frames; its final stats are returned (and
        remain readable via ``tag_stats`` until the tag is reopened)."""
        with self._lock:
            frames, budget, stats = self._tags.get(
                tag, (OrderedDict(), 1, IOStats()))
            self._tags[tag] = (OrderedDict(), 0, stats)
            return stats

    def tag_stats(self, tag) -> IOStats:
        with self._lock:
            if tag not in self._tags:
                self._tags[tag] = (OrderedDict(), 1, IOStats())
            return self._tags[tag][2]

    def all_tag_stats(self) -> dict:
        """Every tag partition's ``IOStats`` (closed tags included —
        ``close_tag`` keeps the ledger readable). The observability
        registry mirrors this into ``io.*{tag=...}`` series; per-tag
        counters sum to ``stats`` minus whatever ran unattributed."""
        with self._lock:
            return {tag: ent[2] for tag, ent in self._tags.items()}

    @contextmanager
    def attributed(self, tag):
        """Attribute this thread's accesses to ``tag`` (nestable; restores
        the previous tag on exit). The tag must have been ``open_tag``-ed
        for its partition frames to apply; an unknown tag only accumulates
        stats."""
        prev = getattr(self._tls, "tag", None)
        self._tls.tag = tag
        try:
            yield
        finally:
            self._tls.tag = prev

    # -- registration -------------------------------------------------------

    def register(self, arr: np.ndarray) -> None:
        base = _nd_base(arr)
        ptr = base.__array_interface__["data"][0]
        with self._lock:
            if ptr in self._regions:
                return
            n_words = base.size
            self._regions[ptr] = (self._next_word, n_words, base.itemsize)
            # round region starts to block boundaries (file layout)
            self._next_word += n_words
            self._next_word = ((self._next_word + self.B - 1) // self.B) * self.B

    def register_triearray(self, ta) -> None:
        for a in list(ta.val) + list(ta.idx):
            if len(a):
                self.register(a)

    def _word_addr(self, arr: np.ndarray, i: int) -> int:
        base = _nd_base(arr)
        bptr = base.__array_interface__["data"][0]
        start, n, itemsize = self._regions[bptr]
        off_bytes = arr.__array_interface__["data"][0] - bptr
        return start + off_bytes // itemsize + i

    # -- accounting ---------------------------------------------------------

    def _tag_entry(self):
        """(frames, budget, stats) of this thread's active tag partition,
        or ``None`` when untagged / the tag has no partition."""
        tag = getattr(self._tls, "tag", None)
        if tag is None:
            return None
        ent = self._tags.get(tag)
        if ent is None or ent[1] <= 0:
            return None
        return ent

    def _touch_block(self, blk: int) -> None:
        ent = self._tag_entry()
        if ent is not None:
            frames, budget, stats = ent
            if blk in frames:
                frames.move_to_end(blk)
                return
            stats.block_reads += 1
            self.stats.block_reads += 1
            frames[blk] = True
            if len(frames) > budget:
                frames.popitem(last=False)
            return
        cache = self._cache
        if blk in cache:
            cache.move_to_end(blk)
            return
        self.stats.block_reads += 1
        cache[blk] = True
        if len(cache) > self.cache_blocks:
            cache.popitem(last=False)

    def _tag_words(self, n: int) -> None:
        ent = self._tag_entry()
        if ent is not None:
            ent[2].word_reads += n

    def touch(self, arr: np.ndarray, i: int) -> None:
        """Random access to element i of a registered (view of an) array."""
        with self._lock:
            self.stats.word_reads += 1
            self._tag_words(1)
            self._touch_block(self._word_addr(arr, i) // self.B)

    def read_range(self, arr: np.ndarray, lo: int, hi: int) -> None:
        """Sequential read of arr[lo:hi] (slice provisioning DMA)."""
        if hi <= lo:
            return
        with self._lock:
            a = self._word_addr(arr, lo) // self.B
            b = self._word_addr(arr, hi - 1) // self.B
            for blk in range(a, b + 1):
                self._touch_block(blk)
            self.stats.word_reads += hi - lo
            self._tag_words(hi - lo)

    def write_words(self, n_words: int) -> None:
        """Append-only output stream (counts ceil(n/B) over time)."""
        blocks = (n_words + self.B - 1) // self.B
        with self._lock:
            self.stats.block_writes += blocks
            ent = self._tag_entry()
            if ent is not None:
                ent[2].block_writes += blocks

    def serve_from_cache(self, n_words: int) -> None:
        """Record ``n_words`` served by a cache layer above the device —
        traffic that would have been ``read_range`` calls without it."""
        with self._lock:
            self.stats.cache_served_words += n_words
            ent = self._tag_entry()
            if ent is not None:
                ent[2].cache_served_words += n_words

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()


class CountingReader:
    """Accessor handed to TrieIterators: reads an element, charging the device.

    ``None`` device = pure in-memory execution (no accounting).
    """

    def __init__(self, device: BlockDevice | None = None):
        self.device = device

    def get(self, arr: np.ndarray, i: int):
        if self.device is not None:
            self.device.touch(arr, i)
        return int(arr[i])
