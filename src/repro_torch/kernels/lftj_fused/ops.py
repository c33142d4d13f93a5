"""Public wrapper of the fused per-box LFTJ lane: gate, checks, dispatch,
ledger.

Takes one box's atoms as compact-CSR tensor triples ``(keys, off, vals)``
on one device and runs the whole box join as a single device invocation:

* :func:`fused_count` -> exact count. On CUDA tensors it launches
  ``csrc/lftj_fused.cu`` (built with ``nvcc`` at first use) or raises; on
  CPU tensors it runs ``ref.fused_count_ref`` over the padded layout.
* :func:`fused_list` -> (exact total, bounded deterministic-prefix binding
  buffer) in the reference listing program's order. On CUDA tensors it
  launches the listing entry points of ``csrc/lftj_fused.cu`` or raises;
  on CPU tensors it runs ``ref.fused_list_ref``.

:func:`fused_supported` is the reference's static pattern gate. The CUDA
kernel adds its own envelope, checked for every call on any device so that
CPU and card runs take the same boxes: vertex ids in ``[0, 2^31 - 1)``
(int32, SENTINEL excluded), keys and every adjacency row strictly
increasing (sets), and at most ``MAX_ATOMS`` atoms (the kernel's by-value
descriptor). Offsets are int64 and the work split counts in int64, so no
box is too large. A call outside the envelope raises
:class:`FusedUnsupported`; the engine then takes the staged lanes.

An empty depth-0 frontier, or an empty starts-only depth, returns 0 (or an
empty buffer) with no launch and no ledger note, as in the reference;
every other call notes exactly one device invocation, with the compact
CSR bytes the kernel reads.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build, ledger
from .ref import SENTINEL, fused_count_ref, fused_list_ref

__all__ = ["LAUNCHES", "LIST_LAUNCHES", "MAX_ATOMS", "MAX_DEPTH", "SENTINEL",
           "FusedUnsupported", "fused_count", "fused_list",
           "fused_supported", "padded_layout", "starts_only_depths"]

# the fixed depth bound of the kernel's per-thread DFS stack: patterns with
# more variables fall back to the staged lanes (fused_supported)
MAX_DEPTH = 6
# atoms in the kernel's by-value descriptor (csrc/lftj_fused.cu kMaxAtoms)
MAX_ATOMS = 16

LAUNCHES = _build.LaunchCounter()
# launches of the listing kernel (one per fused_list call on the card)
LIST_LAUNCHES = _build.LaunchCounter()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "lftj_fused_rows_launch": ((_P, _P, _LL, _P, _P), ctypes.c_int),
    "lftj_fused_count_launch": ((_P, _P, _LL, _P, _P, _P), ctypes.c_int),
    "lftj_fused_n_partials": ((), ctypes.c_int),
    "lftj_fused_desc_words": ((), ctypes.c_int),
    "lftj_list_rows_launch": ((_P, ctypes.c_int, _P, _LL, _P, _P),
                              ctypes.c_int),
    "lftj_list_expand_launch": ((_P, ctypes.c_int, _P, _P, _LL, _P, _P, _P,
                                 ctypes.c_int, _LL, _P, _P, _P),
                                ctypes.c_int),
    "lftj_list_count_launch": ((_P, _P, _LL, _P, _P), ctypes.c_int),
    "lftj_list_write_launch": ((_P, _P, _LL, _P, _P, _LL, _LL, _P, _P),
                               ctypes.c_int),
}


class FusedUnsupported(ValueError):
    """Box or pattern outside the fused kernel's envelope — callers fall
    back to the staged lanes."""


def fused_supported(atom_dims: Sequence[Tuple[int, int]],
                    n_vars: int) -> Optional[str]:
    """None if the pattern fits the fused kernel, else the reason."""
    if n_vars < 2:
        return "fused kernel needs at least two variables"
    if n_vars > MAX_DEPTH:
        return (f"pattern depth {n_vars} exceeds the fused kernel's "
                f"MAX_DEPTH={MAX_DEPTH} stack bound")
    if not atom_dims:
        return "no atoms"
    seen_second = set()
    seen_first = set()
    for fd, sd in atom_dims:
        if not 0 <= fd < sd < n_vars:
            return f"atom dims ({fd}, {sd}) not forward-ordered"
        seen_second.add(sd)
        seen_first.add(fd)
    if (n_vars - 1) not in seen_second:
        return "innermost variable has no bound atom"
    for d in range(1, n_vars - 1):
        # a starts-only depth expands to a binding-independent constant
        # row (fine); a variable touching no atom at all is a free cross
        # product
        if d not in seen_second and d not in seen_first:
            return (f"variable {d} touches no atom — unbounded Cartesian "
                    "expansion")
    return None


def starts_only_depths(n_vars: int,
                       atom_dims: Sequence[Tuple[int, int]]) -> List[int]:
    """Intermediate depths whose variable only *starts* atoms: their
    candidate set is a binding-independent key intersection, passed to the
    kernel as one constant row per depth."""
    seen_second = {sd for _, sd in atom_dims}
    return [d for d in range(1, n_vars - 1) if d not in seen_second]


def _key_intersection(atom_dims, keys: Sequence[torch.Tensor],
                      depth: int) -> torch.Tensor:
    """Sorted key intersection of the atoms starting at ``depth``."""
    cand: Optional[torch.Tensor] = None
    for (fd, _), k in zip(atom_dims, keys):
        if fd != depth:
            continue
        cand = k if cand is None else cand[torch.isin(cand, k)]
        if cand.numel() == 0:
            break
    if cand is None:
        return torch.zeros(0, dtype=torch.int32, device=keys[0].device)
    return cand


def _envelope(atom_dims, atom_csrs):
    """Checked int32 keys / int64 offsets / int32 values per atom, all on
    one device; raises FusedUnsupported outside the kernel's envelope."""
    if len(atom_dims) > MAX_ATOMS:
        raise FusedUnsupported(f"{len(atom_dims)} atoms exceed the fused "
                               f"kernel's MAX_ATOMS={MAX_ATOMS}")
    if len(atom_csrs) != len(atom_dims):
        raise ValueError(f"fused: {len(atom_csrs)} CSRs for "
                         f"{len(atom_dims)} atoms")
    devices = {t.device for csr in atom_csrs for t in csr}
    if len(devices) != 1:
        raise ValueError("fused: all atom tensors must share one device")
    out = []
    for ai, (keys, off, vals) in enumerate(atom_csrs):
        for name, t in (("keys", keys), ("off", off), ("vals", vals)):
            if t.dim() != 1 or t.dtype not in (torch.int32, torch.int64):
                raise ValueError(f"fused: atom {ai} {name} must be a 1-D "
                                 f"int32/int64 tensor, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        if off.numel() != keys.numel() + 1:
            raise ValueError(f"fused: atom {ai} has {keys.numel()} keys "
                             f"but {off.numel()} offsets")
        off = off.to(torch.int64).contiguous()
        if int(off[0]) != 0 or int(off[-1]) != vals.numel() \
                or bool((off[1:] < off[:-1]).any()):
            raise ValueError(f"fused: atom {ai} offsets do not index its "
                             f"{vals.numel()} values")
        for name, t in (("keys", keys), ("vals", vals)):
            if t.numel() and (int(t.min()) < 0 or int(t.max()) >= SENTINEL):
                raise FusedUnsupported(
                    f"atom {ai} {name}: vertex ids must lie in "
                    f"[0, {SENTINEL})")
        # strictly increasing keys, and within every row strictly
        # increasing values: rows are sets
        step = vals[1:] > vals[:-1]
        if vals.numel() > 1:
            inner = torch.ones(vals.numel() - 1, dtype=torch.bool,
                               device=vals.device)
            starts = off[1:-1]
            starts = starts[(starts > 0) & (starts < vals.numel())]
            inner[starts - 1] = False
            step = step | ~inner
        if not bool(step.all()) or not bool((keys[1:] > keys[:-1]).all()):
            raise FusedUnsupported(f"atom {ai}: keys and adjacency rows must "
                                   "be strictly increasing sets")
        out.append((keys.to(torch.int32).contiguous(), off,
                    vals.to(torch.int32).contiguous()))
    return out


def _prepare(atom_dims, atom_csrs, n_vars: int):
    """(checked CSRs, depth-0 frontier, constant rows), or None when the
    box result is empty without a launch (empty frontier or an empty
    starts-only depth)."""
    atom_dims = tuple((int(fd), int(sd)) for fd, sd in atom_dims)
    reason = fused_supported(atom_dims, n_vars)
    if reason is not None:
        raise FusedUnsupported(reason)
    csrs = _envelope(atom_dims, atom_csrs)
    keys = [c[0] for c in csrs]
    c0 = _key_intersection(atom_dims, keys, 0)
    if c0.numel() == 0:
        return None
    consts = []
    for d in starts_only_depths(n_vars, atom_dims):
        c = _key_intersection(atom_dims, keys, d)
        if c.numel() == 0:
            return None
        consts.append(c)
    return atom_dims, csrs, c0, consts


def _layout_bytes(csrs, c0, consts) -> int:
    return (sum(k.numel() * 4 + o.numel() * 8 + v.numel() * 4
                for k, o, v in csrs)
            + 4 * c0.numel() + sum(4 * c.numel() for c in consts))


def _padded(csrs) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(keys, (R, K) SENTINEL-padded adjacency) per atom, K >= 1."""
    out = []
    for keys, off, vals in csrs:
        deg = off[1:] - off[:-1]
        k = max(1, int(deg.max()) if deg.numel() else 1)
        adj = torch.full((keys.numel(), k), SENTINEL, dtype=torch.int32,
                         device=keys.device)
        if vals.numel():
            rr = torch.repeat_interleave(
                torch.arange(keys.numel(), device=keys.device), deg,
                output_size=vals.numel())
            cc = torch.arange(vals.numel(), device=keys.device) - off[rr]
            adj[rr, cc] = vals
        out.append((keys, adj))
    return out


def padded_layout(atom_dims, atom_csrs, n_vars: int):
    """The plain versions' inputs for one box: ``(c0, atoms, consts)`` as
    ``fused_count_ref`` / ``fused_list_ref`` take them, on the atoms'
    device; None when the box result is empty without a launch."""
    prep = _prepare(atom_dims, atom_csrs, n_vars)
    if prep is None:
        return None
    _, csrs, c0, consts = prep
    return c0, _padded(csrs), consts


def _descriptor(atom_dims, csrs, consts, n_vars: int) -> np.ndarray:
    """The kernel's by-value descriptor as int64 words (layout in
    csrc/lftj_fused.cu: n_vars, n_atoms, per atom (fd, sd, keys, off,
    vals, n_keys), per depth (const row, its length))."""
    desc = np.zeros(2 + 6 * MAX_ATOMS + 2 * MAX_DEPTH, dtype=np.int64)
    desc[0], desc[1] = n_vars, len(atom_dims)
    for ai, ((fd, sd), (keys, off, vals)) in enumerate(zip(atom_dims, csrs)):
        desc[2 + 6 * ai:8 + 6 * ai] = (fd, sd, keys.data_ptr(),
                                       off.data_ptr(), vals.data_ptr(),
                                       keys.numel())
    base = 2 + 6 * MAX_ATOMS
    for d, c in zip(starts_only_depths(n_vars, atom_dims), consts):
        desc[base + 2 * d:base + 2 * d + 2] = (c.data_ptr(), c.numel())
    return desc


def _library():
    lib = _build.load("lftj_fused", _SIGNATURES)
    if lib.lftj_fused_desc_words() != 2 + 6 * MAX_ATOMS + 2 * MAX_DEPTH:
        raise RuntimeError("lftj_fused: descriptor layout of the built "
                           "library differs from ops.py")
    return lib


def launch_count(prep) -> torch.Tensor:
    """Run the CUDA kernel on a prepared box (``_prepare``'s result, CUDA
    tensors): one scalar int64 tensor on the card, not synchronised.
    ``fused_count`` calls it once per box; ``chip_smoke.py`` times it."""
    atom_dims, csrs, c0, consts = prep
    n_vars = max(sd for _, sd in atom_dims) + 1
    dev = c0.device
    lib = _library()
    desc = _descriptor(atom_dims, csrs, consts, n_vars)
    c0 = c0.contiguous()
    t = c0.numel()
    row_len = torch.empty(t, dtype=torch.int64, device=dev)
    pair_off = torch.zeros(t + 1, dtype=torch.int64, device=dev)
    n_part = lib.lftj_fused_n_partials()
    partials = torch.empty(n_part, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        # pass 1 writes each depth-0 row's depth-1 candidate count; the
        # exclusive scan places its (row, slot) pairs; pass 2 counts them
        rc = lib.lftj_fused_rows_launch(
            desc.ctypes.data, c0.data_ptr(), t, row_len.data_ptr(), stream)
        _build.check_launch("lftj_fused", rc)
        torch.cumsum(row_len, 0, out=pair_off[1:])
        rc = lib.lftj_fused_count_launch(
            desc.ctypes.data, c0.data_ptr(), t, pair_off.data_ptr(),
            partials.data_ptr(), stream)
    _build.check_launch("lftj_fused", rc)
    LAUNCHES.add()
    return partials.sum()


def launch_list(prep, capacity: int) -> Tuple[int, torch.Tensor]:
    """Run the CUDA listing kernel on a prepared box (CUDA tensors):
    ``(exact total, (min(total, capacity), n_vars) int32 rows on the
    card)`` in the reference listing program's order. ``fused_list``
    calls it once per box; ``chip_smoke.py`` times it.

    The frontier grows breadth first, one depth at a time (candidate
    counts, a scan, live flags, a scan, the compacted next frontier), so it
    stays in (depth-0 row, slot_1, ..., slot_d) order. Stable sorts by
    slot_{n-2}, ..., slot_1 then put the prefixes in the reference's
    (slot_1, ..., slot_{n-2}, depth-0 row) order, and a scan of their
    innermost counts in that order gives each its output offset
    (``csrc/lftj_fused.cu``, "Listing")."""
    atom_dims, csrs, c0, consts = prep
    n_vars = max(sd for _, sd in atom_dims) + 1
    dev = c0.device
    lib = _library()
    desc = _descriptor(atom_dims, csrs, consts, n_vars)
    i32, i64 = torch.int32, torch.int64
    vals = c0.to(i32).reshape(1, -1).contiguous()
    slots = torch.empty((0, vals.shape[1]), dtype=i32, device=dev)
    n = vals.shape[1]
    empty = torch.empty((0, n_vars), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)

        def run(entry, *args):
            _build.check_launch("lftj_fused_list",
                                entry(desc.ctypes.data, *args, stream))

        for d in range(1, n_vars - 1):
            row_len = torch.empty(n, dtype=i64, device=dev)
            run(lib.lftj_list_rows_launch, d, vals.data_ptr(), n,
                row_len.data_ptr())
            pair_off = torch.zeros(n + 1, dtype=i64, device=dev)
            torch.cumsum(row_len, 0, out=pair_off[1:])
            n_pairs = int(pair_off[-1])
            if n_pairs == 0:
                LIST_LAUNCHES.add()
                return 0, empty
            live = torch.empty(n_pairs, dtype=torch.uint8, device=dev)
            run(lib.lftj_list_expand_launch, d, vals.data_ptr(),
                slots.data_ptr(), n, pair_off.data_ptr(), live.data_ptr(),
                None, 0, 0, None, None)
            pos = torch.cumsum(live, 0, dtype=i64)
            n_next = int(pos[-1])
            if n_next == 0:
                LIST_LAUNCHES.add()
                return 0, empty
            pos -= live                                    # exclusive scan
            next_vals = torch.empty((d + 1, n_next), dtype=i32, device=dev)
            next_slots = torch.empty((d, n_next), dtype=i32, device=dev)
            run(lib.lftj_list_expand_launch, d, vals.data_ptr(),
                slots.data_ptr(), n, pair_off.data_ptr(), live.data_ptr(),
                pos.data_ptr(), 1, n_next, next_vals.data_ptr(),
                next_slots.data_ptr())
            vals, slots, n = next_vals, next_slots, n_next
        counts = torch.empty(n, dtype=i64, device=dev)
        run(lib.lftj_list_count_launch, vals.data_ptr(), n,
            counts.data_ptr())
        order = torch.nonzero(counts).squeeze(1)
        for j in reversed(range(slots.shape[0])):
            order = order[torch.sort(slots[j][order], stable=True).indices]
        cnt = counts[order]
        offset = torch.cumsum(cnt, 0)
        total = int(offset[-1]) if offset.numel() else 0
        m = min(total, int(capacity))
        out = torch.empty((m, n_vars), dtype=i32, device=dev)
        if m:
            offset -= cnt                                  # exclusive scan
            n_write = int((offset < m).sum())
            run(lib.lftj_list_write_launch, vals.data_ptr(), n,
                order.data_ptr(), offset.data_ptr(), n_write, m,
                out.data_ptr())
    LIST_LAUNCHES.add()
    return total, out


def fused_count(atom_dims: Sequence[Tuple[int, int]],
                atom_csrs: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]],
                n_vars: int) -> int:
    """Exact box-join count in ONE device invocation.

    ``atom_csrs[i] = (keys, off, vals)``: sorted int keys (R,), int64
    offsets (R+1,) and the concatenated sorted adjacency rows, all on one
    device. Raises :class:`FusedUnsupported` outside the envelope."""
    prep = _prepare(atom_dims, atom_csrs, n_vars)
    if prep is None:
        return 0
    atom_dims, csrs, c0, consts = prep
    dev = c0.device
    if dev.type == "cpu":
        total = int(fused_count_ref(atom_dims, c0, _padded(csrs), consts,
                                    n_vars).sum())
    elif dev.type == "cuda":
        total = int(launch_count(prep))
    else:
        raise ValueError(f"fused_count: unsupported device {dev}")
    ledger.note(1, bytes_in=_layout_bytes(csrs, c0, consts), bytes_out=8)
    return total


def fused_list(atom_dims: Sequence[Tuple[int, int]],
               atom_csrs: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]],
               n_vars: int, capacity: int) -> Tuple[int, np.ndarray]:
    """(exact total, first ``min(total, capacity)`` bindings) of the box
    join in ONE invocation: an ``(m, n_vars)`` int64 array holding the
    deterministic prefix of the reference listing program's order, so
    ``total > capacity`` signals overflow and the caller rescans."""
    capacity = int(capacity)
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    prep = _prepare(atom_dims, atom_csrs, n_vars)
    if prep is None:
        return 0, np.zeros((0, n_vars), np.int64)
    atom_dims, csrs, c0, consts = prep
    dev = c0.device
    if dev.type == "cpu":
        total, rows = fused_list_ref(atom_dims, c0, _padded(csrs), consts,
                                     n_vars, capacity)
    elif dev.type == "cuda":
        total, rows = launch_list(prep, capacity)
    else:
        raise ValueError(f"fused_list: unsupported device {dev}")
    ledger.note(1, bytes_in=_layout_bytes(csrs, c0, consts),
                bytes_out=rows.numel() * 8 + 8)
    return total, rows.cpu().numpy().astype(np.int64)
