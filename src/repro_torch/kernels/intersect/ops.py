"""Public wrapper of the intersect kernel: checks, dispatch, ledger.

For CUDA tensors it launches ``csrc/intersect.cu`` (built with ``nvcc`` at
first use) or raises; for CPU tensors it runs the plain version in
``ref.py``. Either way it notes one launch on the kernel ledger, exactly
where the reference wrapper does, so ``EngineStats.device_invocations``
matches the reference box for box.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, ledger
from .ref import SENTINEL, intersect_count_ref

__all__ = ["LAUNCHES", "SENTINEL", "intersect_count",
           "intersect_count_rows"]

LAUNCHES = _build.LaunchCounter()

_P = ctypes.c_void_p
_SIGNATURES = {
    "intersect_count_launch": (
        (_P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_longlong,
         ctypes.c_int, _P, _P, ctypes.c_longlong, _P, _P), ctypes.c_int),
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


def _launch(a, b, ia, ib, e: int) -> torch.Tensor:
    out = torch.empty(e, dtype=torch.int32, device=a.device)
    if e == 0:
        return out
    lib = _build.load("intersect", _SIGNATURES)
    with torch.cuda.device(a.device):
        rc = lib.intersect_count_launch(
            a.data_ptr(), a.stride(0), a.shape[1],
            b.data_ptr(), b.stride(0), b.shape[1],
            ia.data_ptr() if ia is not None else None,
            ib.data_ptr() if ib is not None else None,
            e, out.data_ptr(), _build.stream_ptr(a.device))
    _build.check_launch("intersect", rc)
    LAUNCHES.add()
    return out


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
        out = _launch(a, b, ia, ib, e)
    else:
        raise ValueError(f"intersect_count: unsupported device {a.device}")
    moved = a.numel() + (b.numel() if b is not a else 0) \
        + (2 * e if ia is not None else 0)
    ledger.note(1, bytes_in=4 * moved, bytes_out=4 * e)
    return out


def _pad_rows(off: torch.Tensor, vals: torch.Tensor, pos: torch.Tensor,
              deg: torch.Tensor, k: int, total: int) -> torch.Tensor:
    """(len(pos), k) SENTINEL-padded int32 value rows gathered on the
    tensors' device from compact CSR (``off``/``vals``) at key positions
    ``pos``, whose rows hold ``deg`` (``total`` in all) values."""
    out = torch.full((pos.numel(), k), SENTINEL, dtype=torch.int32,
                     device=vals.device)
    if total:
        rr = torch.repeat_interleave(
            torch.arange(pos.numel(), device=vals.device), deg,
            output_size=total)
        cc = torch.arange(total, device=vals.device) \
            - (torch.cumsum(deg, 0) - deg)[rr]
        out[rr, cc] = vals[off[pos][rr] + cc].to(torch.int32)
    return out


def intersect_count_rows(off_a: torch.Tensor, vals_a: torch.Tensor,
                         pos_a: torch.Tensor, off_b: torch.Tensor,
                         vals_b: torch.Tensor, pos_b: torch.Tensor, *,
                         chunk: int = 8192) -> int:
    """Σ_i |row_a(pos_a[i]) ∩ row_b(pos_b[i])| from two compact-CSR
    relations: the QueryEngine's innermost two-atom step.

    ``off_*`` are int64 offsets, ``vals_*`` the concatenated sorted rows and
    ``pos_*`` the int64 key positions of each pair, all on one device. The
    pairs are counted in ``chunk``-pair batches, one ``intersect_count``
    call each, as the reference batches them; each batch's rows are
    gathered there into SENTINEL-padded tiles as wide as the batch's widest
    row (the reference pads every batch to the widest row of all pairs,
    for its compiled shapes; the kernel takes any width). Returns the int64
    total as a Python int."""
    n = pos_a.numel()
    if n == 0:
        return 0
    deg_a = (off_a[1:] - off_a[:-1])[pos_a]
    deg_b = (off_b[1:] - off_b[:-1])[pos_b]
    total = torch.zeros((), dtype=torch.int64, device=vals_a.device)
    for s in range(0, n, chunk):
        da, db = deg_a[s:s + chunk], deg_b[s:s + chunk]
        ka, kb, ta, tb = torch.stack([da.max(), db.max(), da.sum(),
                                      db.sum()]).tolist()
        a = _pad_rows(off_a, vals_a, pos_a[s:s + chunk], da, max(1, ka), ta)
        b = _pad_rows(off_b, vals_b, pos_b[s:s + chunk], db, max(1, kb), tb)
        total += intersect_count(a, b).sum(dtype=torch.int64)
    return int(total)
