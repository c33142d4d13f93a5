"""Public wrapper of the fused per-box LFTJ lane: gate, checks, dispatch,
ledger.

Takes one box's atoms as compact-CSR tensor triples ``(keys, off, vals)``
on one device and runs the whole box join as a single device invocation:

* :func:`fused_count` -> exact count. On CUDA tensors it launches
  ``csrc/lftj_fused.cu`` (built with ``nvcc`` at first use) or raises; on
  CPU tensors it runs ``ref.fused_count_ref`` over the padded layout.
* :func:`fused_list` -> (exact total, bounded deterministic-prefix binding
  buffer) in the reference listing program's order. On CUDA tensors it
  launches the cooperative listing kernel of ``csrc/lftj_fused.cu`` (one
  launch and one host read per call) or raises; on CPU tensors it runs
  ``ref.fused_list_ref``.

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
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    "lftj_list_grid": ((ctypes.POINTER(ctypes.c_int),), ctypes.c_int),
    "lftj_list_base_words": ((ctypes.c_int,), _LL),
    "lftj_list_header_words": ((), ctypes.c_int),
    "lftj_list_launch": ((_P, _P, _LL, _P, _LL, _LL, ctypes.c_int, _P),
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
    if lib.lftj_fused_desc_words() != 2 + 6 * MAX_ATOMS + 2 * MAX_DEPTH \
            or lib.lftj_list_header_words() < _HEAD:
        raise RuntimeError("lftj_fused: descriptor or workspace layout of "
                           "the built library differs from ops.py")
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


# the listing kernel's workspace header (csrc/lftj_fused.cu, "Listing"):
# int64 words bump, overflow, need, total, rows_at, rows
_HEAD = 6
# one workspace per device, grown on overflow and never shrunk; the lock
# keeps a call's launch, header read and row copy together
_workspaces: Dict[torch.device, torch.Tensor] = {}
_grids: Dict[torch.device, int] = {}
_ws_lock = threading.Lock()


def _workspace(dev: torch.device, words: int) -> torch.Tensor:
    """The device's kept workspace, grown to at least ``words`` int64
    words."""
    ws = _workspaces.get(dev)
    if ws is None or ws.numel() < words:
        _workspaces.pop(dev, None)
        ws = _workspaces[dev] = torch.empty(int(words), dtype=torch.int64,
                                            device=dev)
    return ws


def _list_grid(lib, dev: torch.device) -> int:
    """The listing kernel's co-resident grid on ``dev`` (raises when the
    card cannot launch cooperatively)."""
    grid = _grids.get(dev)
    if grid is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _build.check_launch("lftj_fused_list",
                                lib.lftj_list_grid(ctypes.byref(out)))
        grid = _grids[dev] = out.value
    return grid


def _run_listing(dev: torch.device, words: int,
                 run: Callable[[torch.Tensor], List[int]]):
    """The listing protocol: ``run(ws)`` launches one call into workspace
    ``ws`` and returns its header, read in one copy. On overflow the
    workspace grows to the words the kernel reported and the call runs
    once more; a second overflow raises. Returns (workspace, header)."""
    ws = _workspace(dev, words)
    head = run(ws)
    if head[1]:
        ws = _workspace(dev, head[2])
        head = run(ws)
        if head[1]:
            raise RuntimeError("lftj_fused_list: the workspace overflowed "
                               f"again after growing to {ws.numel()} words")
    return ws, head


def _launch_list(lib, desc: np.ndarray, c0: torch.Tensor, ws: torch.Tensor,
                 capacity: int, grid: int) -> List[int]:
    """One cooperative launch of the listing kernel; its header, read to
    the host in one copy (the call's one synchronisation)."""
    with torch.cuda.device(ws.device):
        rc = lib.lftj_list_launch(desc.ctypes.data, c0.data_ptr(),
                                  c0.numel(), ws.data_ptr(), ws.numel(),
                                  capacity, grid, _build.stream_ptr(ws.device))
    _build.check_launch("lftj_fused_list", rc)
    return ws[:_HEAD].tolist()


def _start_words(lib, grid: int, c0: torch.Tensor, csrs, capacity: int,
                 n_vars: int) -> int:
    """The int64 words a listing call asks of the kept workspace before
    its first launch: the kernel's fixed words, room for the frontiers
    (eight words a depth-0 row or atom value) and for the rows up to the
    capacity (at most 2^22 of them)."""
    return lib.lftj_list_base_words(grid) + 8 * (
        c0.numel() + sum(v.numel() for _, _, v in csrs)) \
        + (min(capacity, 1 << 22) * n_vars + 1) // 2


def launch_list(prep, capacity: int) -> Tuple[int, torch.Tensor]:
    """Run the CUDA listing kernel on a prepared box (CUDA tensors):
    ``(exact total, (min(total, capacity), n_vars) int32 rows on the
    card)`` in the reference listing program's order. ``fused_list``
    calls it once per box; ``chip_smoke.py`` times it.

    One cooperative launch runs every stage (expansion per depth, innermost
    counts, ordering, offsets, the write; ``csrc/lftj_fused.cu``,
    "Listing") in a workspace kept per device, and one copy brings its
    header (total, overflow, words needed) to the host. The workspace
    starts at ``_start_words`` (from the capacity and the atoms' sizes);
    on overflow it grows to the reported need and the call runs once
    more."""
    atom_dims, csrs, c0, consts = prep
    n_vars = max(sd for _, sd in atom_dims) + 1
    dev = c0.device
    lib = _library()
    grid = _list_grid(lib, dev)
    desc = _descriptor(atom_dims, csrs, consts, n_vars)
    c0 = c0.to(torch.int32).contiguous()
    capacity = int(capacity)
    words = _start_words(lib, grid, c0, csrs, capacity, n_vars)
    with _ws_lock:
        ws, head = _run_listing(
            dev, words,
            lambda w: _launch_list(lib, desc, c0, w, capacity, grid))
        total, rows_at, m = head[3], head[4], head[5]
        rows = ws.view(torch.int32)[2 * rows_at:2 * rows_at + m * n_vars] \
            .view(m, n_vars).clone()
    LIST_LAUNCHES.add()
    return total, rows


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
