"""Public wrapper of the fused per-box LFTJ lane: gate, checks, dispatch,
ledger.

Takes one box's atoms as compact-CSR tensor triples ``(keys, off, vals)``
on one device and runs the whole box join as a single device invocation:

* :func:`fused_count` -> exact count. On CUDA tensors it launches the
  count kernel of ``csrc/lftj_fused.cu`` (built with ``nvcc`` at first
  use; one cooperative launch over a workspace kept per device) or
  raises; on CPU tensors it runs ``ref.fused_count_ref`` over the padded
  layout. A call on the card reads it twice: once for every envelope
  check and the sizes of the depth-0 and starts-only candidate sets, once
  for the total.
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
:class:`FusedUnsupported`; the engine then takes the staged lanes. The
checks run on the atoms' device and reach the host in one read; the first
failing check, in atom order, raises the exception it would raise alone.

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
    "lftj_count_grid": ((ctypes.c_int, ctypes.POINTER(ctypes.c_int)),
                        ctypes.c_int),
    "lftj_count_words": ((_P, _LL, _LL, ctypes.c_int), _LL),
    "lftj_count_n_partials": ((ctypes.c_int,), _LL),
    "lftj_count_launch": ((_P, _P, _LL, _P, _LL, _LL, ctypes.c_int, _P, _P),
                          ctypes.c_int),
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


def _key_mask(atom_dims, keys: Sequence[torch.Tensor], depth: int):
    """(keys of the first atom starting at ``depth``, mask of those in
    every other such atom's keys, or None when there is no other), or None
    when no atom starts there. Keys are sorted; nothing synchronises."""
    starting = [k for (fd, _), k in zip(atom_dims, keys) if fd == depth]
    if not starting:
        return None
    base, mask = starting[0], None
    for k in starting[1:]:
        if k.numel() == 0:
            hit = torch.zeros(base.shape, dtype=torch.bool,
                              device=base.device)
        else:
            pos = torch.searchsorted(k, base).clamp_(max=k.numel() - 1)
            hit = k[pos] == base
        mask = hit if mask is None else mask & hit
    return base, mask


def _compact(base: torch.Tensor, mask: Optional[torch.Tensor],
             n: int) -> torch.Tensor:
    """The ``n`` entries of ``base`` that ``mask`` keeps, in order, without
    a host read: each kept entry is scattered to its rank, the others all
    to one spare slot past the end."""
    if mask is None:
        return base
    rank = torch.where(mask, torch.cumsum(mask, 0) - 1, n)
    out = torch.empty(n + 1, dtype=base.dtype, device=base.device)
    out.scatter_(0, rank, base)
    return out[:n]


def _shape_error(ai: int, keys, off, vals) -> Optional[ValueError]:
    """The malformed-input error that atom ``ai``'s metadata alone shows,
    or None."""
    for name, t in (("keys", keys), ("off", off), ("vals", vals)):
        if t.dim() != 1 or t.dtype not in (torch.int32, torch.int64):
            return ValueError(f"fused: atom {ai} {name} must be a 1-D "
                              f"int32/int64 tensor, got {t.dtype} "
                              f"{tuple(t.shape)}")
    if off.numel() != keys.numel() + 1:
        return ValueError(f"fused: atom {ai} has {keys.numel()} keys "
                          f"but {off.numel()} offsets")
    return None


# an atom's checks on its device, in the order they raise
_CHECKS = ("offsets", "keys", "vals", "sets")


def _atom_flags(keys, off, vals) -> torch.Tensor:
    """(4,) int64 flags of an atom's device checks in ``_CHECKS`` order, 1
    where it fails: offsets that do not index the values; key or value ids
    outside ``[0, SENTINEL)``; keys or a row not strictly increasing.
    Malformed offsets are clamped, so the later checks never fault."""
    dev = vals.device
    nv = vals.numel()
    off = off.to(torch.int64)
    bad_off = (off[0] != 0) | (off[-1] != nv) | (off[1:] < off[:-1]).any()

    def out_of_range(t):
        if t.numel() == 0:
            return torch.zeros((), dtype=torch.bool, device=dev)
        return (t.min() < 0) | (t.max() >= SENTINEL)

    # strictly increasing keys, and within every row strictly increasing
    # values (the step onto a row's first value is exempt): rows are sets
    step = vals[1:] > vals[:-1]
    if nv > 1:
        starts = torch.zeros(nv + 1, dtype=torch.bool, device=dev)
        starts.index_fill_(0, off.clamp(0, nv), True)
        step = step | starts[1:nv]
    not_set = ~step.all() | ~(keys[1:] > keys[:-1]).all()
    return torch.stack([bad_off, out_of_range(keys), out_of_range(vals),
                        not_set]).to(torch.int64)


def _check_error(ai: int, check: str, n_vals: int) -> ValueError:
    """The exception of atom ``ai``'s failed device check."""
    if check == "offsets":
        return ValueError(f"fused: atom {ai} offsets do not index its "
                          f"{n_vals} values")
    if check in ("keys", "vals"):
        return FusedUnsupported(f"atom {ai} {check}: vertex ids must lie "
                                f"in [0, {SENTINEL})")
    return FusedUnsupported(f"atom {ai}: keys and adjacency rows must be "
                            "strictly increasing sets")


def _prepare(atom_dims, atom_csrs, n_vars: int):
    """(checked CSRs, depth-0 frontier, constant rows), or None when the
    box result is empty without a launch (empty frontier or an empty
    starts-only depth).

    One host read covers the envelope: every atom's device checks and the
    sizes of the depth-0 and starts-only candidate sets come to the host
    together. The first failure in atom order (its metadata, then
    ``_CHECKS``) raises: ``ValueError`` for malformed inputs,
    :class:`FusedUnsupported` outside the envelope. Atoms after the first
    one with malformed metadata are not examined."""
    atom_dims = tuple((int(fd), int(sd)) for fd, sd in atom_dims)
    reason = fused_supported(atom_dims, n_vars)
    if reason is not None:
        raise FusedUnsupported(reason)
    if len(atom_dims) > MAX_ATOMS:
        raise FusedUnsupported(f"{len(atom_dims)} atoms exceed the fused "
                               f"kernel's MAX_ATOMS={MAX_ATOMS}")
    if len(atom_csrs) != len(atom_dims):
        raise ValueError(f"fused: {len(atom_csrs)} CSRs for "
                         f"{len(atom_dims)} atoms")
    devices = {t.device for csr in atom_csrs for t in csr}
    if len(devices) != 1:
        raise ValueError("fused: all atom tensors must share one device")
    shape_error, checked = None, []
    for ai, csr in enumerate(atom_csrs):
        shape_error = _shape_error(ai, *csr)
        if shape_error is not None:
            break
        checked.append(csr)
    parts = [_atom_flags(*csr) for csr in checked]
    csrs = [(k.to(torch.int32).contiguous(), o.to(torch.int64).contiguous(),
             v.to(torch.int32).contiguous()) for k, o, v in checked]
    sets = []
    if shape_error is None:
        keys = [c[0] for c in csrs]
        sets = [_key_mask(atom_dims, keys, d)
                for d in [0] + starts_only_depths(n_vars, atom_dims)]
        parts += [mask.sum(dtype=torch.int64).view(1)
                  for _, mask in filter(None, sets) if mask is not None]
    read = torch.cat(parts).tolist() if parts else []
    for ai, csr in enumerate(checked):
        for ci, check in enumerate(_CHECKS):
            if read[len(_CHECKS) * ai + ci]:
                raise _check_error(ai, check, csr[2].numel())
    if shape_error is not None:
        raise shape_error
    sizes = iter(read[len(_CHECKS) * len(checked):])
    found = []
    for s in sets:
        if s is None:
            return None
        base, mask = s
        n = base.numel() if mask is None else int(next(sizes))
        if n == 0:
            return None
        found.append(_compact(base, mask, n))
    return atom_dims, csrs, found[0], found[1:]


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


_lib = None


def _library():
    """The built library, its descriptor and header layout checked against
    this module once."""
    global _lib
    if _lib is None:
        lib = _build.load("lftj_fused", _SIGNATURES)
        if lib.lftj_fused_desc_words() != 2 + 6 * MAX_ATOMS + 2 * MAX_DEPTH \
                or lib.lftj_list_header_words() < _HEAD:
            raise RuntimeError("lftj_fused: descriptor or workspace layout "
                               "of the built library differs from ops.py")
        _lib = lib
    return _lib


# the listing kernel's workspace header (csrc/lftj_fused.cu, "Listing"):
# int64 words bump, overflow, need, total, rows_at, rows
_HEAD = 6
# one workspace per (device, stream), shared by the count and listing
# kernels launched on that stream, grown when a call needs more and never
# shrunk. Kernels on one stream run in order, so they may share it; calls
# on two streams run at once and each has its own. ``_ws_lock`` guards the
# table only; each slot's lock keeps one call's enqueue (and a listing's
# header read and row copy) together against other threads enqueueing on
# the same stream.
_workspaces: Dict[Tuple[torch.device, int], "_Slot"] = {}
# co-resident grids of the cooperative kernels, by (device, "list") and
# (device, n_vars) for the count
_grids: Dict[tuple, int] = {}
_ws_lock = threading.Lock()
# the count kernel's region of a depth >= 2 frontier holds at least
# 2^20 and at most 2^22 entries; a larger frontier is expanded in chunks
# (every chunk but the last counts its innermost depth on the cooperative
# grid, so fewer chunks pay: the median diamond box of the query phase
# took 0.42 ms on the card at 2^17 entries, 0.24 at 2^20,
# scripts/fused_count_probe.py)
_COUNT_CAP = (1 << 20, 1 << 22)


class _Slot:
    """The workspace of one (device, stream) and the lock of its calls."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ws: Optional[torch.Tensor] = None


def _slot(dev: torch.device, stream: int) -> _Slot:
    """The slot of launches on ``stream`` (a CUDA stream pointer,
    ``_build.stream_ptr``) of ``dev``, made at first use."""
    with _ws_lock:
        slot = _workspaces.get((dev, stream))
        if slot is None:
            slot = _workspaces[(dev, stream)] = _Slot()
    return slot


def _workspace(slot: _Slot, dev: torch.device, words: int) -> torch.Tensor:
    """``slot``'s workspace, grown to at least ``words`` int64 words; the
    caller holds ``slot.lock`` and the slot's stream is current on
    ``dev``. A grow allocates on that stream and drops only this slot's
    old buffer: the caching allocator gives its memory only to later
    allocations on the same stream, whose kernels run after the ones
    already enqueued there, and a call still holding the old tensor keeps
    it alive."""
    if slot.ws is None or slot.ws.numel() < words:
        slot.ws = None
        slot.ws = torch.empty(int(words), dtype=torch.int64, device=dev)
    return slot.ws


def _coop_grid(dev: torch.device, key, query: Callable) -> int:
    """A cooperative kernel's co-resident grid on ``dev``, asked once with
    ``query(byref(out))`` (raises when the card cannot launch
    cooperatively)."""
    grid = _grids.get((dev, key))
    if grid is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _build.check_launch("lftj_fused", query(ctypes.byref(out)))
        grid = _grids[(dev, key)] = out.value
    return grid


def _list_grid(lib, dev: torch.device) -> int:
    """The listing kernel's co-resident grid on ``dev``."""
    return _coop_grid(dev, "list", lib.lftj_list_grid)


def _leading(atom_dims, n_vars: int, consts) -> List[int]:
    """Sizes of the constant rows of the starts-only depths 1, 2, ... that
    follow depth 0 without a bound depth between."""
    out = []
    for d, c in zip(starts_only_depths(n_vars, atom_dims), consts):
        if d != len(out) + 1:
            break
        out.append(c.numel())
    return out


def _count_cap(c0: torch.Tensor, csrs, leading: Sequence[int]) -> int:
    """Entries of each depth >= 2 frontier region of the count kernel for
    a box: the power of two that holds the depth-0 rows and every atom
    value (a triangle box's whole depth-1 expansion), or, when depths 1,
    2, ... are starts-only (``leading``, the sizes of their constant
    rows), the cross product of the depth-0 rows and those rows (their
    whole expansion: a diamond box ordered from w has |c0| · |x keys|
    (w, x) entries), within ``_COUNT_CAP``."""
    front = c0.numel()
    for n in leading:
        front *= n
    need = max(front, c0.numel() + sum(v.numel() for _, _, v in csrs))
    lo, hi = _COUNT_CAP
    return min(hi, max(lo, 1 << max(0, need - 1).bit_length()))


def launch_count(prep) -> torch.Tensor:
    """Run the CUDA count kernel on a prepared box (``_prepare``'s result,
    CUDA tensors): one scalar int64 tensor on the card, not synchronised.
    ``fused_count`` calls it once per box; ``chip_smoke.py`` times it.

    A cooperative launch (``count_kernel<n_vars>``, csrc/lftj_fused.cu)
    walks the box in the device's kept workspace, sized here from the
    call's sizes so that it never overflows, and a tile launch counts the
    innermost depth it leaves; both write int64 partials per block,
    summed on the card."""
    atom_dims, csrs, c0, consts = prep
    n_vars = max(sd for _, sd in atom_dims) + 1
    dev = c0.device
    lib = _library()
    desc = _descriptor(atom_dims, csrs, consts, n_vars)
    c0 = c0.to(torch.int32).contiguous()
    cap = _count_cap(c0, csrs, _leading(atom_dims, n_vars, consts))
    # the whole co-resident grid: a box's later frontiers can outgrow its
    # atoms by orders of magnitude (the median diamond box: 1.28 ms on the
    # card on 17 blocks, 0.42 on 264; the median four-clique box pays
    # 0.007 ms for the wider grid's syncs, scripts/fused_count_probe.py)
    grid = _coop_grid(dev, n_vars,
                      lambda out: lib.lftj_count_grid(n_vars, out))
    words = lib.lftj_count_words(desc.ctypes.data, c0.numel(), cap, grid)
    partials = torch.empty(lib.lftj_count_n_partials(grid),
                           dtype=torch.int64, device=dev)
    stream = _build.stream_ptr(dev)
    slot = _slot(dev, stream)
    with slot.lock:
        ws = _workspace(slot, dev, words)
        with _build.on_device(dev):
            rc = lib.lftj_count_launch(
                desc.ctypes.data, c0.data_ptr(), c0.numel(), ws.data_ptr(),
                ws.numel(), cap, grid, partials.data_ptr(), stream)
    _build.check_launch("lftj_fused", rc)
    LAUNCHES.add()
    return partials.sum()


def _run_listing(slot: _Slot, dev: torch.device, words: int,
                 run: Callable[[torch.Tensor], List[int]]):
    """The listing protocol (the caller holds ``slot.lock``): ``run(ws)``
    launches one call into workspace ``ws`` and returns its header, read
    in one copy. On overflow the workspace grows to the words the kernel
    reported and the call runs once more; a second overflow raises.
    Returns (workspace, header)."""
    ws = _workspace(slot, dev, words)
    head = run(ws)
    if head[1]:
        ws = _workspace(slot, dev, head[2])
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
                                  capacity, grid,
                                  _build.stream_ptr(ws.device))
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
    slot = _slot(dev, _build.stream_ptr(dev))
    with slot.lock:
        ws, head = _run_listing(
            slot, dev, words,
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
