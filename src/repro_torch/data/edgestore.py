"""Spillable edge store: memory-mapped chunked-CSR on disk (writer + reader).

The port keeps its own copy of the reference's numpy-only store
(``repro.data.edgestore``), byte for byte the same format
(``docs/EDGESTORE_FORMAT.md``): a store either package writes, the other
opens, and both writers produce the same bytes for the same edges.

The paper's out-of-core setting (§1 "Model & Assumptions") keeps the edge
relation on secondary storage and charges block I/Os for every word pulled
into the memory budget M. This module is that storage layer for the
streaming triangle engine:

  * ``write_edge_store`` lays the oriented CSR graph out as *chunked CSR*:
    the ``indices`` stream is split into fixed row-count chunks, each
    aligned to a block boundary, with a chunk directory mapping chunk id to
    its word offset. A reader can therefore fetch any vertex row range by
    touching only the chunks that overlap it — the paper's contiguous slice
    provisioning (Def. 6) as literal file reads.
  * ``EdgeStore`` memory-maps the file and serves ``read_rows`` range reads.
    Every read is charged to a ``core.iomodel.BlockDevice`` when one is
    attached, so ``EngineStats`` reports *measured* block I/Os that
    benchmarks compare against the Thm. 10 prediction.
  * ``InMemoryEdgeSource`` wraps host (indptr, indices) arrays behind the
    same interface, so the streaming executor is agnostic to where the
    graph lives.

Two writers produce the same file, byte for byte:

  * ``write_edge_store`` — in-memory: orient + sort the whole edge list in
    RAM, then lay it out. Simple, but peak memory is O(|E|).
  * ``EdgeStoreWriter`` / ``write_edge_store_streaming`` — bounded-memory
    ingest: edges are appended in batches, spilled to sorted run files
    whenever the in-RAM buffer reaches the word budget (pass 1), then
    k-way-merged directly into the chunked-CSR layout (pass 2). Peak
    ingest allocations scale with the budget — ~2x the budget bytes plus
    the O(V) resident degree index and fixed per-batch/merge floors (which
    dominate only at toy budgets) — so graphs larger than RAM are
    ingestable, not just queryable, out of core.

Only the (V+1)-word ``indptr`` prefix array is kept resident (the paper's
planner likewise assumes the index structure of E is probe-able); the
neighbor stream itself is paged in per box.

File layout (little-endian; the full spec with field offsets lives in
``docs/EDGESTORE_FORMAT.md``)::

    [0:64)       header: magic 'RPRCSR01', version, orientation flag,
                 n_nodes, n_edges, chunk_rows, n_chunks, align_words, k_max
    [64:...)     indptr   int64[n_nodes + 1]
    [...]        chunk directory int64[n_chunks + 1]  (word offsets)
    [...]        indices  int32, per chunk, padded to align_words
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Optional, Tuple

import numpy as np

from repro_torch.core.lftj_torch import csr_from_edges, orient_edges

MAGIC = b"RPRCSR01"
VERSION = 1

_ORIENT_FLAGS = {"minmax": 0, "degree": 1, "raw": 2}
_FLAG_ORIENTS = {v: k for k, v in _ORIENT_FLAGS.items()}

_HEADER = np.dtype([
    ("magic", "S8"), ("version", "<i4"), ("orient", "<i4"),
    ("n_nodes", "<i8"), ("n_edges", "<i8"), ("chunk_rows", "<i8"),
    ("n_chunks", "<i8"), ("align_words", "<i8"), ("k_max", "<i8"),
])
assert _HEADER.itemsize == 64


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def write_edge_store_csr(path, indptr: np.ndarray, indices: np.ndarray, *,
                         orientation: str = "raw", chunk_rows: int = 4096,
                         align_words: int = 1024) -> str:
    """Write a (sorted-row) CSR graph as a chunked-CSR edge store file."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    n_nodes = len(indptr) - 1
    n_edges = len(indices)
    chunk_rows = max(1, int(chunk_rows))
    align_words = max(1, int(align_words))
    n_chunks = max(1, -(-n_nodes // chunk_rows))
    deg = np.diff(indptr)

    offsets = np.zeros(n_chunks + 1, dtype=np.int64)
    chunks = []
    off = 0
    for c in range(n_chunks):
        r0, r1 = c * chunk_rows, min(n_nodes, (c + 1) * chunk_rows)
        data = indices[indptr[r0]:indptr[r1]]
        pad = (-len(data)) % align_words
        if pad:
            data = np.concatenate([data, np.zeros(pad, np.int32)])
        offsets[c] = off
        off += len(data)
        chunks.append(data)
    offsets[n_chunks] = off

    hdr = np.zeros((), dtype=_HEADER)
    hdr["magic"] = MAGIC
    hdr["version"] = VERSION
    hdr["orient"] = _ORIENT_FLAGS.get(orientation, _ORIENT_FLAGS["raw"])
    hdr["n_nodes"] = n_nodes
    hdr["n_edges"] = n_edges
    hdr["chunk_rows"] = chunk_rows
    hdr["n_chunks"] = n_chunks
    hdr["align_words"] = align_words
    hdr["k_max"] = int(deg.max(initial=0))

    path = os.fspath(path)
    with open(path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(indptr.tobytes())
        f.write(offsets.tobytes())
        for data in chunks:
            f.write(data.tobytes())
    return path


def write_edge_store(path, src: np.ndarray, dst: np.ndarray, *,
                     orientation: str = "minmax", chunk_rows: int = 4096,
                     align_words: int = 1024) -> str:
    """Orient an undirected edge list and write it as an edge store.

    The stored graph is the oriented DAG G* (paper §2.3), which is what the
    triangle engine consumes; ``orientation`` is recorded in the header so
    the engine can recover sound pruning rules when it opens the file.
    """
    a, b = orient_edges(np.asarray(src), np.asarray(dst), orientation)
    nv = int(max(a.max(initial=-1), b.max(initial=-1))) + 1
    if nv:
        indptr, indices = csr_from_edges(a, b, n_nodes=nv)
    else:
        indptr, indices = np.zeros(1, np.int64), np.zeros(0, np.int32)
    return write_edge_store_csr(path, indptr, indices,
                                orientation=orientation,
                                chunk_rows=chunk_rows,
                                align_words=align_words)


# ---------------------------------------------------------------------------
# streaming writer (bounded-memory two-pass external-sort ingest)
# ---------------------------------------------------------------------------

class _RunReader:
    """Buffered sequential reader over one sorted spill-run file."""

    def __init__(self, path: str, buf_edges: int):
        self.path = path
        # unbuffered: with k runs open at once, per-file Python I/O buffers
        # (~4-8 KiB each) would dwarf the merge's own word budget
        self.f = open(path, "rb", buffering=0)
        self.buf_edges = max(64, int(buf_edges))
        self.buf = np.zeros(0, np.int64)
        self.eof = False

    def fill(self) -> None:
        if self.eof or len(self.buf) >= self.buf_edges:
            return
        want = self.buf_edges - len(self.buf)
        new = np.fromfile(self.f, dtype=np.int64, count=want)
        if len(new) < want:
            self.eof = True
        self.buf = np.concatenate([self.buf, new]) if len(self.buf) else new

    def close(self) -> None:
        self.f.close()


class EdgeStoreWriter:
    """Bounded-memory streaming edge-store builder (two-pass external sort).

    The in-memory ``write_edge_store`` materializes the whole oriented edge
    list — which makes "graphs larger than RAM" hold only *after* ingest.
    This writer keeps peak ingest allocations at ~2x ``budget_words``
    (4-byte words, the store's unit) plus the O(V) degree index and small
    fixed floors (minimum buffer/batch sizes — relevant only when the
    budget itself is tiny):

    * **pass 1 (spill runs)** — ``add_edges`` batches are self-loop-filtered,
      canonicalized to (min, max) 64-bit keys and appended to a fixed-size
      buffer. A full buffer is sorted in place, deduplicated, and spilled as
      one sorted run file.
    * **pass 2 (merge)** — ``finalize`` k-way-merges the runs (deduplicating
      across runs) straight into the chunked-CSR layout: the merge yields
      edges in CSR order, so chunks stream to their final file offsets and
      only the header / indptr / chunk directory are back-patched at the end.

    The output is byte-identical to ``write_edge_store`` for the same edge
    multiset. For ``orientation='degree'`` the orientation key needs global
    degree counts, which are only known after pass 1 — runs are then
    re-oriented and re-sorted block-wise (an extra pass over the spill
    files) before the merge; ``'minmax'`` orients on the fly.

    Not thread-safe; one writer per output file. Use as a context manager
    to clean up spill runs on error.
    """

    def __init__(self, path, *, orientation: str = "minmax",
                 chunk_rows: int = 4096, align_words: int = 1024,
                 budget_words: int = 1 << 22, tmpdir: Optional[str] = None):
        if orientation not in ("minmax", "degree"):
            raise ValueError(f"orientation {orientation!r} not in "
                             "('minmax', 'degree')")
        self.path = os.fspath(path)
        self.orientation = orientation
        self.chunk_rows = max(1, int(chunk_rows))
        self.align_words = max(1, int(align_words))
        self.budget_words = max(1024, int(budget_words))
        # buffer of int64 keys: flush peak is ~17 bytes/buffered edge
        # (8 buffer + 1 dedup mask + 8 unique copy), so cap = budget/3
        # edges keeps the pass-1 peak near 1.4x the byte budget
        self._cap = max(1024, self.budget_words // 3)
        self._buf = np.empty(self._cap, dtype=np.int64)
        self._fill = 0
        self._runs: list = []
        self._max_id = -1
        self._n_raw = 0
        self.n_spill_runs = 0        # total pass-1 runs (telemetry)
        self._deg = np.zeros(0, dtype=np.int64)   # degree orientation only
        self._tmpdir = tmpdir
        self._own_tmpdir: Optional[str] = None
        self._finalized = False

    # -- pass 1: batch append + spill ----------------------------------------

    def add_edges(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Append one batch of undirected edges (duplicates/self-loops ok)."""
        if self._finalized:
            raise RuntimeError("writer already finalized")
        src = np.asarray(src, dtype=np.int64).ravel()
        dst = np.asarray(dst, dtype=np.int64).ravel()
        if len(src) != len(dst):
            raise ValueError("src and dst batches differ in length")
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if len(src) == 0:
            return
        lo = int(min(src.min(), dst.min()))
        hi = int(max(src.max(), dst.max()))
        if lo < 0 or hi >= 1 << 31:
            raise ValueError("vertex ids must be in [0, 2**31)")
        self._max_id = max(self._max_id, hi)
        self._n_raw += len(src)
        if self.orientation == "degree":
            # the orientation key uses *raw* (pre-dedup) degree counts,
            # exactly as orient_edges does
            if hi >= len(self._deg):
                grown = np.zeros(max(hi + 1, 2 * len(self._deg)), np.int64)
                grown[:len(self._deg)] = self._deg
                self._deg = grown
            self._deg[:hi + 1] += np.bincount(src, minlength=hi + 1)
            self._deg[:hi + 1] += np.bincount(dst, minlength=hi + 1)
        keys = (np.minimum(src, dst) << 32) | np.maximum(src, dst)
        pos = 0
        while pos < len(keys):
            take = min(len(keys) - pos, self._cap - self._fill)
            self._buf[self._fill:self._fill + take] = keys[pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == self._cap:
                self._spill()

    def _spill(self) -> None:
        if self._fill == 0:
            return
        view = self._buf[:self._fill]
        view.sort()        # in-place introsort: no O(run) temp (radix
        #                    'stable' would allocate a working buffer)
        mask = np.empty(self._fill, dtype=bool)
        mask[0] = True
        np.not_equal(view[1:], view[:-1], out=mask[1:])
        uniq = view[mask]
        if self._own_tmpdir is None and self._tmpdir is None:
            self._own_tmpdir = tempfile.mkdtemp(
                prefix=".ingest-", dir=os.path.dirname(self.path) or ".")
        rundir = self._tmpdir or self._own_tmpdir
        rp = os.path.join(rundir, f"run{len(self._runs):05d}.i64")
        uniq.tofile(rp)
        self._runs.append(rp)
        self.n_spill_runs += 1
        self._fill = 0

    # -- degree orientation: re-key runs once global degrees are known -------

    def _reorient_runs_by_degree(self) -> None:
        n = self._max_id + 1
        deg = self._deg[:n]
        out_runs = []
        block = max(256, self._cap // 3)
        for rp in self._runs:
            with open(rp, "rb") as f:
                part = 0
                while True:
                    keys = np.fromfile(f, dtype=np.int64, count=block)
                    if len(keys) == 0:
                        break
                    a = keys >> 32
                    b = keys & 0xFFFFFFFF
                    swap = deg[a] * (n + 1) + a > deg[b] * (n + 1) + b
                    keys = np.where(swap, (b << 32) | a, (a << 32) | b)
                    keys.sort()
                    op = rp + f".o{part}"
                    keys.tofile(op)
                    out_runs.append(op)
                    part += 1
            os.unlink(rp)
        self._runs = out_runs

    # -- pass 2: k-way merge -> chunked-CSR stream ---------------------------

    def finalize(self) -> str:
        """Merge the spill runs into the final store file; returns the path."""
        if self._finalized:
            return self.path
        self._spill()
        self._buf = np.empty(0, dtype=np.int64)   # pass 1 done: free it
        if self.orientation == "degree" and self._runs:
            self._reorient_runs_by_degree()
        n_nodes = self._max_id + 1
        n_chunks = max(1, -(-n_nodes // self.chunk_rows))
        self._outdeg = np.zeros(n_nodes, dtype=np.int64)
        self._offsets = np.zeros(n_chunks + 1, dtype=np.int64)
        self._n_chunks = n_chunks
        self._cur_chunk = 0
        self._cur_chunk_words = 0
        self._total_words = 0
        self._n_edges = 0
        idx_off = _HEADER.itemsize + 8 * (n_nodes + 1) + 8 * (n_chunks + 1)
        # write to a sibling temp file and rename on success: a mid-merge
        # failure (disk full, ...) must never leave a half-written store at
        # the destination path masquerading as a valid file
        tmp_path = self.path + ".ingest-tmp"
        with open(tmp_path, "wb") as f:
            f.seek(idx_off)
            self._merge(f)
            self._close_chunks_upto(f, n_chunks)
            hdr = np.zeros((), dtype=_HEADER)
            hdr["magic"] = MAGIC
            hdr["version"] = VERSION
            hdr["orient"] = _ORIENT_FLAGS[self.orientation]
            hdr["n_nodes"] = n_nodes
            hdr["n_edges"] = self._n_edges
            hdr["chunk_rows"] = self.chunk_rows
            hdr["n_chunks"] = n_chunks
            hdr["align_words"] = self.align_words
            hdr["k_max"] = int(self._outdeg.max(initial=0))
            f.seek(0)
            f.write(hdr.tobytes())
            indptr = np.concatenate(
                [np.zeros(1, np.int64),
                 np.cumsum(self._outdeg, dtype=np.int64)])
            f.write(indptr.tobytes())
            f.write(self._offsets.tobytes())
        os.replace(tmp_path, self.path)
        self._cleanup()
        self._finalized = True
        return self.path

    def _merge(self, f) -> None:
        if not self._runs:
            return
        per = max(64, (self._cap // 2) // len(self._runs))
        readers = [_RunReader(rp, per) for rp in self._runs]
        last_key = -1
        try:
            while readers:
                for r in readers:
                    r.fill()
                readers = [r for r in readers
                           if len(r.buf) or not r.eof]
                live = [r for r in readers if len(r.buf)]
                if not live:
                    if not readers:
                        break
                    continue
                pending = [r for r in live if not r.eof]
                frontier = min(int(r.buf[-1]) for r in pending) if pending \
                    else max(int(r.buf[-1]) for r in live)
                parts = []
                for r in live:
                    cnt = int(np.searchsorted(r.buf, frontier, side="right"))
                    if cnt:
                        parts.append(r.buf[:cnt])
                        r.buf = r.buf[cnt:]
                if len(parts) == 1:
                    block = parts[0]         # one run: already sorted
                else:
                    block = np.concatenate(parts)
                    block.sort()             # in place on the concat copy
                mask = np.empty(len(block), dtype=bool)
                mask[0] = int(block[0]) != last_key
                np.not_equal(block[1:], block[:-1], out=mask[1:])
                block = block[mask]
                if len(block):
                    self._emit_sorted(block, f)
                    last_key = int(block[-1])
        finally:
            for r in readers:
                r.close()

    def _emit_sorted(self, keys: np.ndarray, f) -> None:
        """Write one globally-sorted, deduplicated block of oriented edges."""
        a = keys >> 32
        b = (keys & 0xFFFFFFFF).astype(np.int32)
        self._n_edges += len(keys)
        self._outdeg += np.bincount(a, minlength=len(self._outdeg))
        cids = a // self.chunk_rows
        uc, starts = np.unique(cids, return_index=True)
        ends = np.append(starts[1:], len(cids))
        for cid, s, e in zip(uc, starts, ends):
            if cid != self._cur_chunk:
                self._close_chunks_upto(f, int(cid))
            f.write(b[s:e].tobytes())
            self._cur_chunk_words += int(e - s)
            self._total_words += int(e - s)

    def _close_chunks_upto(self, f, upto: int) -> None:
        """Pad the open chunk to ``align_words`` and record the chunk
        directory start offsets for every chunk in (cur, upto]."""
        pad = (-self._cur_chunk_words) % self.align_words
        if pad:
            f.write(np.zeros(pad, np.int32).tobytes())
            self._total_words += pad
        self._offsets[self._cur_chunk + 1:upto + 1] = self._total_words
        self._cur_chunk = upto
        self._cur_chunk_words = 0

    # -- cleanup -------------------------------------------------------------

    def _cleanup(self) -> None:
        try:
            os.unlink(self.path + ".ingest-tmp")
        except OSError:
            pass
        for rp in self._runs:
            try:
                os.unlink(rp)
            except OSError:
                pass
        self._runs = []
        if self._own_tmpdir is not None:
            try:
                os.rmdir(self._own_tmpdir)
            except OSError:
                pass
            self._own_tmpdir = None

    def __enter__(self) -> "EdgeStoreWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            try:
                self.finalize()
            except BaseException:
                self._cleanup()      # a failed merge must not leave the
                raise                # temp store or spill runs behind
        else:
            self._cleanup()


def write_edge_store_streaming(path, batches: Iterable, *,
                               orientation: str = "minmax",
                               chunk_rows: int = 4096,
                               align_words: int = 1024,
                               budget_words: int = 1 << 22) -> str:
    """Build an edge store from an iterable of (src, dst) batches with
    bounded memory; byte-identical to ``write_edge_store`` on the same
    edges. See ``EdgeStoreWriter`` for the budget semantics."""
    w = EdgeStoreWriter(path, orientation=orientation, chunk_rows=chunk_rows,
                        align_words=align_words, budget_words=budget_words)
    with w:
        for src, dst in batches:
            w.add_edges(src, dst)
    return w.path


# ---------------------------------------------------------------------------
# readers (EdgeSource implementations)
# ---------------------------------------------------------------------------

class EdgeStore:
    """Memory-mapped chunked-CSR reader, charging reads to a BlockDevice.

    ``read_rows(lo, hi)`` returns ``(indptr_local, values)`` for vertex rows
    ``lo..hi`` inclusive, where ``indptr_local`` is 0-based over the
    returned ``values`` — the provisioning DMA of a contiguous x- or
    y-slice. Chunk padding never reaches the caller.

    Safe for concurrent ``read_rows`` calls from multiple threads (the
    async box scheduler's slice builders): the reader holds no mutable
    per-read state — ``indptr``, the chunk directory and the read-only
    mmap are only ever read, the returned arrays are fresh copies that
    never alias another call's result, and device charging serializes on
    the ``BlockDevice``'s internal lock.
    """

    def __init__(self, path, device=None):
        self.path = os.fspath(path)
        raw = np.fromfile(self.path, dtype=_HEADER, count=1)
        if len(raw) == 0:
            raise ValueError(
                f"{self.path}: truncated header "
                f"(< {_HEADER.itemsize} bytes) — not an edge store")
        hdr = raw[0]
        # fail loudly on format mismatch: misreading a wrong-version file
        # would silently corrupt every downstream triangle count
        if bytes(hdr["magic"]) != MAGIC:
            raise ValueError(f"{self.path}: not an edge store "
                             f"(bad magic {bytes(hdr['magic'])!r}, "
                             f"expected {MAGIC!r})")
        if int(hdr["version"]) != VERSION:
            raise ValueError(
                f"{self.path}: unsupported edge store format version "
                f"{int(hdr['version'])} (this reader supports {VERSION}); "
                "refusing to misread — rewrite the store with this "
                "library's writer")
        self.n_nodes = int(hdr["n_nodes"])
        self.n_edges = int(hdr["n_edges"])
        self.chunk_rows = int(hdr["chunk_rows"])
        self.n_chunks = int(hdr["n_chunks"])
        self.align_words = int(hdr["align_words"])
        self.k_max = int(hdr["k_max"])
        self.orientation = _FLAG_ORIENTS.get(int(hdr["orient"]), "raw")
        if (self.n_nodes < 0 or self.n_edges < 0 or self.chunk_rows < 1
                or self.align_words < 1
                or self.n_chunks != max(1, -(-self.n_nodes
                                             // self.chunk_rows))):
            raise ValueError(f"{self.path}: corrupt header "
                             f"(n_nodes={self.n_nodes}, "
                             f"n_edges={self.n_edges}, "
                             f"chunk_rows={self.chunk_rows}, "
                             f"n_chunks={self.n_chunks})")

        off = _HEADER.itemsize
        # indptr is the resident index structure: V+1 words, read once
        self.indptr = np.fromfile(self.path, dtype=np.int64,
                                  count=self.n_nodes + 1, offset=off)
        off += 8 * (self.n_nodes + 1)
        self._chunk_off = np.fromfile(self.path, dtype=np.int64,
                                      count=self.n_chunks + 1, offset=off)
        if (len(self.indptr) != self.n_nodes + 1
                or len(self._chunk_off) != self.n_chunks + 1):
            raise ValueError(f"{self.path}: truncated index region")
        off += 8 * (self.n_chunks + 1)
        total_words = int(self._chunk_off[-1])
        if os.path.getsize(self.path) < off + 4 * total_words:
            raise ValueError(
                f"{self.path}: truncated indices region (directory claims "
                f"{total_words} words past byte {off})")
        # an edgeless graph has no indices region at all — mmap of length
        # max(1, 0) would point past EOF and raise
        self._idx = np.memmap(self.path, dtype=np.int32, mode="r",
                              offset=off, shape=(total_words,)) \
            if total_words else np.zeros(0, np.int32)
        self.device = None
        # optional obs.trace.Tracer: every read_rows emits an io.read_rows
        # instant event (rows + words) when attached; None = no overhead
        self.tracer = None
        if device is not None:
            self.attach_device(device)

    # -- device accounting ---------------------------------------------------

    def attach_device(self, device) -> None:
        """Register the on-disk indices region with a virtual block device."""
        self.device = device
        if device is not None and len(self._idx):
            device.register(self._idx)

    # -- EdgeSource interface ------------------------------------------------

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def words(self) -> int:
        """Storage words of the neighbor stream (the paper's |R| unit)."""
        return self.n_edges

    def read_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        """Neighbor data of vertex rows ``lo..hi`` inclusive (one DMA)."""
        lo = max(0, int(lo))
        hi = min(self.n_nodes - 1, int(hi))
        if hi < lo:
            return np.zeros(1, np.int64), np.zeros(0, np.int32)
        parts = []
        c0, c1 = lo // self.chunk_rows, hi // self.chunk_rows
        for c in range(c0, c1 + 1):
            r0 = max(lo, c * self.chunk_rows)
            r1 = min(hi, (c + 1) * self.chunk_rows - 1)
            base = int(self._chunk_off[c]) \
                - int(self.indptr[c * self.chunk_rows])
            s = base + int(self.indptr[r0])
            e = base + int(self.indptr[r1 + 1])
            if e > s:
                if self.device is not None:
                    self.device.read_range(self._idx, s, e)
                parts.append(np.asarray(self._idx[s:e]))
        # concatenate copies out of the mmap even for a single part, so the
        # caller's slice never aliases the file mapping (concurrent readers
        # each get private buffers)
        vals = np.concatenate(parts) if parts \
            else np.zeros(0, np.int32)
        indptr_local = self.indptr[lo:hi + 2] - self.indptr[lo]
        tr = self.tracer
        if tr is not None:
            tr.event("io.read_rows", lo=lo, hi=hi, words=len(vals))
        return indptr_local, vals


class InMemoryEdgeSource:
    """Host (indptr, indices) arrays behind the EdgeSource interface.

    With a ``device`` attached the same block-I/O accounting applies as for
    the on-disk store (useful for modeling runs); without one, reads are
    free — pure in-memory execution.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 device=None, orientation: str = "minmax",
                 tracer=None):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.n_nodes = len(self.indptr) - 1
        self.n_edges = len(self.indices)
        self.orientation = orientation
        self.device = device
        self.tracer = tracer
        if device is not None and self.n_edges:
            device.register(self.indices)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def words(self) -> int:
        return self.n_edges

    def read_rows(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        lo = max(0, int(lo))
        hi = min(self.n_nodes - 1, int(hi))
        if hi < lo:
            return np.zeros(1, np.int64), np.zeros(0, np.int32)
        s, e = int(self.indptr[lo]), int(self.indptr[hi + 1])
        if self.device is not None and e > s:
            self.device.read_range(self.indices, s, e)
        tr = self.tracer
        if tr is not None:
            tr.event("io.read_rows", lo=lo, hi=hi, words=e - s)
        return self.indptr[lo:hi + 2] - self.indptr[lo], self.indices[s:e]
