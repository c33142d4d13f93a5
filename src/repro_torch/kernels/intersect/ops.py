"""Public wrappers of the intersect kernel: checks, dispatch, ledger.

For CUDA tensors they launch ``csrc/intersect.cu`` (built with ``nvcc`` at
first use) or raise; for CPU tensors they run the plain versions in
``ref.py``. The kernel reads compact CSR and splits its work by probes,
not by rows (see the note at the head of the source):

* :func:`intersect_count_csr` -> the int64 total over pairs of CSR rows,
  a 0-d tensor on the inputs' device, not synchronised;
* :func:`intersect_count` -> per-row int32 counts of SENTINEL-padded
  matrices, the counterpart of the reference's ``intersect_count``; it
  reads the matrices as CSR (row r starts at r * stride and holds its
  non-SENTINEL values) and notes one launch on the kernel ledger, as the
  reference does;
* :func:`intersect_count_rows` -> the QueryEngine's innermost two-atom
  count as a Python int: one kernel call and one host read, with the
  reference's one ledger note per 8,192-pair chunk;
* :func:`note_padded` -> the ledger note of one reference launch on
  padded matrices, for callers that count through the CSR form where the
  reference's lane reads a padded matrix.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, ledger
from .ref import SENTINEL, intersect_count_ref, intersect_rows_ref

__all__ = ["LAUNCHES", "SENTINEL", "intersect_count", "intersect_count_csr",
           "intersect_count_rows", "note_padded"]

LAUNCHES = _build.LaunchCounter()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "intersect_launch": ((_P, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P,
                          _P), ctypes.c_int),
    "intersect_work_launch": ((_P, _P, _P, _P, _P, _P, _LL, _P, _P),
                              ctypes.c_int),
    "intersect_n_partials": ((), ctypes.c_int),
}


def _check(a, b, ia, ib) -> int:
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 2 or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"intersect_count: {name} must be a contiguous "
                             f"2-D int32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if (ia is None) != (ib is None):
        raise ValueError("intersect_count: pass both ia and ib, or neither")
    tensors = [a, b]
    if ia is None:
        if a.shape[0] != b.shape[0]:
            raise ValueError("intersect_count: a and b need the same row "
                             f"count without an index ({a.shape[0]} vs "
                             f"{b.shape[0]})")
        e = a.shape[0]
    else:
        for name, t in (("ia", ia), ("ib", ib)):
            if t.dim() != 1 or t.dtype != torch.int32 \
                    or not t.is_contiguous():
                raise ValueError(f"intersect_count: {name} must be a "
                                 "contiguous 1-D int32 tensor")
        if ia.shape[0] != ib.shape[0]:
            raise ValueError("intersect_count: ia and ib differ in length")
        e = ia.shape[0]
        tensors += [ia, ib]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("intersect_count: all tensors must share a device")
    return e


def _launch(side_a, side_b, n: int, per_pair: bool):
    """One call of the kernel over ``n`` pairs. ``side_*`` is (beg, end,
    vals, pos) on one CUDA device. A small kernel writes each pair's work
    min(d_a, d_b), a cumsum scans it into ``work_off`` on the device, and
    the intersect kernel splits that space. Returns (per-block int64
    partials, per-pair int32 counts or None)."""
    dev = side_a[2].device
    lib = _build.load("intersect", _SIGNATURES)
    work_off = torch.empty(n + 1, dtype=torch.int64, device=dev)
    partials = torch.empty(lib.intersect_n_partials(), dtype=torch.int64,
                           device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev) \
        if per_pair else None
    (beg_a, end_a, _, pos_a), (beg_b, end_b, _, pos_b) = side_a, side_b
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        rc = lib.intersect_work_launch(
            beg_a.data_ptr(), end_a.data_ptr(), pos_a.data_ptr(),
            beg_b.data_ptr(), end_b.data_ptr(), pos_b.data_ptr(), n,
            work_off.data_ptr(), stream)
        _build.check_launch("intersect", rc)
        work_off[1:].cumsum_(0)
        rc = lib.intersect_launch(
            *(t.data_ptr() for t in side_a), *(t.data_ptr() for t in side_b),
            n, work_off.data_ptr(), partials.data_ptr(),
            counts.data_ptr() if per_pair else None, stream)
    _build.check_launch("intersect", rc)
    LAUNCHES.add()
    return partials, counts


def _row_spans(m: torch.Tensor):
    """(beg, end) int64 value indices of every row of a padded matrix read
    as CSR: beg = r * stride, end = beg + the row's real length (its
    values below SENTINEL, which a sorted padded row holds in front)."""
    beg = torch.arange(m.shape[0], dtype=torch.int64, device=m.device) \
        * m.stride(0)
    return beg, beg + (m != SENTINEL).sum(1)


def _launch_padded(a, b, ia, ib, e: int) -> torch.Tensor:
    if e == 0 or a.shape[1] == 0 or b.shape[1] == 0:
        return torch.zeros(e, dtype=torch.int32, device=a.device)
    beg_a, end_a = _row_spans(a)
    beg_b, end_b = (beg_a, end_a) if b is a else _row_spans(b)
    if ia is None:
        pos_a = pos_b = torch.arange(e, dtype=torch.int64, device=a.device)
    else:
        pos_a, pos_b = ia.long(), ib.long()
    _, counts = _launch((beg_a, end_a, a, pos_a), (beg_b, end_b, b, pos_b),
                        e, per_pair=True)
    return counts


def note_padded(words: int, e: int, indexed: bool = True) -> None:
    """Note one launch of the reference's padded intersect kernel on the
    kernel ledger: ``words`` padded int32 words read (a matrix passed as
    both sides counts once), the 2·``e`` index words when ``indexed``, and
    ``e`` int32 counts written."""
    ledger.note(1, bytes_in=4 * (words + (2 * e if indexed else 0)),
                bytes_out=4 * e)


def intersect_count(a: torch.Tensor, b: torch.Tensor,
                    ia: Optional[torch.Tensor] = None,
                    ib: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row sorted-set intersection counts, (E,) int32.

    ``a`` (Ra, Ka) and ``b`` (Rb, Kb) hold sorted SENTINEL-padded rows
    (sets). Without an index, row i of ``a`` meets row i of ``b``
    (Ra == Rb == E); with the int32 index vectors ``ia``/``ib`` of length
    E, pair i is ``a[ia[i]]`` and ``b[ib[i]]`` (the indices must be in
    range: the kernel does not check them). The widths may differ.
    """
    e = _check(a, b, ia, ib)
    if a.device.type == "cpu":
        out = intersect_count_ref(a, b, ia, ib)
    elif a.device.type == "cuda":
        out = _launch_padded(a, b, ia, ib, e)
    else:
        raise ValueError(f"intersect_count: unsupported device {a.device}")
    note_padded(a.numel() + (b.numel() if b is not a else 0), e,
                indexed=ia is not None)
    return out


def _check_csr(off_a, vals_a, pos_a, off_b, vals_b, pos_b) -> None:
    for name, t, dtype in (("off_a", off_a, torch.int64),
                           ("vals_a", vals_a, torch.int32),
                           ("pos_a", pos_a, torch.int64),
                           ("off_b", off_b, torch.int64),
                           ("vals_b", vals_b, torch.int32),
                           ("pos_b", pos_b, torch.int64)):
        if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"intersect_count_csr: {name} must be a "
                             f"contiguous 1-D {dtype} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if pos_a.numel() != pos_b.numel():
        raise ValueError("intersect_count_csr: pos_a and pos_b differ in "
                         "length")
    if len({t.device for t in (off_a, vals_a, pos_a, off_b, vals_b,
                               pos_b)}) != 1:
        raise ValueError("intersect_count_csr: all tensors must share a "
                         "device")


def intersect_count_csr(off_a: torch.Tensor, vals_a: torch.Tensor,
                        pos_a: torch.Tensor, off_b: torch.Tensor,
                        vals_b: torch.Tensor, pos_b: torch.Tensor
                        ) -> torch.Tensor:
    """Σ_i |row_a(pos_a[i]) ∩ row_b(pos_b[i])| of two compact-CSR
    relations as a 0-d int64 tensor on their device, not synchronised.

    ``off_*`` are int64 offsets, ``vals_*`` int32 sorted rows and
    ``pos_*`` int64 key positions (in range: the kernel does not check
    them), all contiguous on one device. Notes nothing on the kernel
    ledger: its callers note the launches the reference makes."""
    _check_csr(off_a, vals_a, pos_a, off_b, vals_b, pos_b)
    dev = vals_a.device
    if dev.type == "cpu":
        return intersect_rows_ref(off_a, vals_a, pos_a, off_b, vals_b,
                                  pos_b).sum(dtype=torch.int64)
    if dev.type != "cuda":
        raise ValueError(f"intersect_count_csr: unsupported device {dev}")
    if pos_a.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    # CSR offsets give each row's end as the next row's start: end = off[1:]
    partials, _ = _launch((off_a, off_a[1:], vals_a, pos_a),
                          (off_b, off_b[1:], vals_b, pos_b), pos_a.numel(),
                          per_pair=False)
    return partials.sum()


def _chunk_max(deg: torch.Tensor, chunk: int) -> torch.Tensor:
    n = deg.numel()
    pad = -n % chunk
    return torch.nn.functional.pad(deg, (0, pad)).view(-1, chunk).amax(1)


def intersect_count_rows(off_a: torch.Tensor, vals_a: torch.Tensor,
                         pos_a: torch.Tensor, off_b: torch.Tensor,
                         vals_b: torch.Tensor, pos_b: torch.Tensor, *,
                         chunk: int = 8192) -> int:
    """Σ_i |row_a(pos_a[i]) ∩ row_b(pos_b[i])| from two compact-CSR
    relations: the QueryEngine's innermost two-atom step, as a Python int.

    ``off_*`` are int64 offsets, ``vals_*`` the concatenated sorted int32
    rows and ``pos_*`` the int64 key positions of each pair, all on one
    device. One :func:`intersect_count_csr` call counts every pair; the
    kernel ledger gets the reference's one note per ``chunk``-pair batch,
    with the bytes of that batch's SENTINEL-padded tiles (as wide as its
    widest row), computed from the row lengths without building them. The
    total and the batch widths reach the host in one read."""
    n = pos_a.numel()
    if n == 0:
        return 0
    deg_a = off_a[pos_a + 1] - off_a[pos_a]
    deg_b = off_b[pos_b + 1] - off_b[pos_b]
    total = intersect_count_csr(off_a, vals_a, pos_a, off_b, vals_b, pos_b)
    read = torch.cat([total.view(1), _chunk_max(deg_a, chunk),
                      _chunk_max(deg_b, chunk)]).tolist()
    n_chunks = (len(read) - 1) // 2
    for c in range(n_chunks):
        e = min(chunk, n - c * chunk)
        ka, kb = max(1, read[1 + c]), max(1, read[1 + n_chunks + c])
        note_padded(e * (ka + kb), e, indexed=False)
    return int(read[0])
