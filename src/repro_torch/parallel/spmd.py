"""Single-controller SPMD execution over a named device grid.

The counterpart of the reference's ``jax.jit(fn, in_shardings,
out_shardings)`` on a mesh (``src/repro/launch/steps.py:42-48``): one
Python process drives every place of a ``launch.mesh.DeviceGrid``. A place
is a ``torch.device``, and places may repeat (``["cuda:0"] * 4`` puts four
places on one card, ``["cpu"] * 4`` on the CPU); on distinct cards blocks
move by peer copies and launches overlap because they are asynchronous.
There is no ``torch.distributed`` here and no NCCL.

* ``Sharded``: a value's global shape, its ``NamedSharding`` and one block
  per place, in the grid's flat (C) order. ``place`` cuts a tensor into
  its blocks (a block on the device its source lies on is a view, not a
  copy, and places on one device share a replicated block); ``gather``
  puts the blocks back together. ``place_tree`` / ``gather_tree`` do the
  same for trees.
* Collectives over named axes, on lists of per-place tensors:
  ``all_gather``, ``reduce_scatter``, ``all_reduce``, ``all_to_all`` and
  ``fetch`` (column or row ranges pulled from the places that hold them,
  XLA's collective-permute). A group's sum is taken in grid order, place
  0 first (in float32 for lower-precision floats, rounded once), on the
  group's first place, and copied to the others, so a step gives the same
  bits on every run and on every place of a group. All five are
  ``torch.autograd.Function``s whose backward is the dual collective
  (all-gather <-> reduce-scatter, all-reduce <-> all-reduce, all-to-all <->
  its inverse, fetch <-> each piece's gradient sent back to the place that
  holds it and added there in grid order), so gradients cross places in
  grid order too.
* ``LEDGER`` counts every collective by XLA's opcode name in the
  reference's record shape, ``{"all-gather": {"count": n, "bytes": b},
  ...}``: one op per device per call, and ``bytes`` the operand bytes of
  one device's operand (for ``fetch``, the bytes place 0 receives from
  other places), forward and backward alike. A collective over a
  one-place group moves nothing and is not counted.
* ``lockstep(grid, gens)``: each place's step is a generator that
  ``yield``s a ``Request`` (``AllGather(x, axes, dim)``, ...) at each
  collective and receives its own result; the driver runs the places in
  grid order up to the next collective, runs it over all of them, and
  goes on, so each place's code reads as a sequential program.
* Grid-wide remat: a layer's forward meets collectives with every other
  place, so one place's layer cannot be recomputed alone.
  ``lockstep_fn(grid, make)`` is one function of every place's input
  that runs ``make(p, x_p)`` on all places in lockstep and returns all
  their outputs; checkpointing that function (``torch.utils.checkpoint``)
  recomputes the layer over the whole grid in the backward, collectives
  included, as XLA's remat re-runs a rematerialized all-gather. The
  ledger counts the recomputed collectives. Autograd runs each device's
  nodes on a thread of its own, and a checkpoint's recompute is not safe
  against two threads starting it at once, so the outputs pass through
  one node (``_Join``) whose backward starts the recompute before any
  place's backward in the layer can.
* ``place_leaves`` lays out a tree made one leaf at a time (each block
  copied to its place, the whole leaf freed before the next is made), and
  ``zeros`` makes a value's blocks directly on their places: arguments
  that do not fit one device whole.

An abstract grid (``devices=None``) is represented by one place, place 0,
whose blocks are tensors on the ``meta`` device: every collective knows
its group's size from the grid, gives the shapes place 0 would get and
counts what place 0 would move. So the same step, run on an abstract
grid, reckons a cell's collectives without a card and without data.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.pytree import tree_map

OPCODES = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
           "collective-permute")
LEDGER: Dict[str, Dict[str, int]] = {}
# autograd runs each card's backward nodes on a thread of its own, so two
# collectives' backwards may count at once
_LEDGER_LOCK = threading.Lock()


def reset_ledger() -> None:
    LEDGER.clear()


def ledger() -> Dict[str, Dict[str, int]]:
    """A copy of the counts since the last ``reset_ledger``."""
    return {k: dict(v) for k, v in LEDGER.items()}


def _count(op: str, nbytes: int) -> None:
    with _LEDGER_LOCK:
        rec = LEDGER.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(nbytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# the grid's places and groups
# ---------------------------------------------------------------------------

def axes_of(entry) -> Tuple[str, ...]:
    """An axis name, a tuple of names, or None as a tuple of names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def is_abstract(grid) -> bool:
    return grid.devices is None


def places(grid) -> List[torch.device]:
    """The places this process drives: every device of the grid in flat
    order, or the one ``meta`` place standing for an abstract grid."""
    if is_abstract(grid):
        return [torch.device("meta")]
    return list(grid.devices.flat)


def axis_size(grid, axes) -> int:
    return math.prod(grid.shape[a] for a in axes_of(axes))


def _index_grid(grid) -> np.ndarray:
    return np.arange(grid.size).reshape([grid.shape[a]
                                         for a in grid.axis_names])


def groups(grid, axes) -> List[List[int]]:
    """The places of each group over ``axes``, each group in order along
    ``axes`` (the first axis major, as a partition spec's tuple entry
    flattens), the groups in grid order; ``[[0]]`` on an abstract grid."""
    axes = axes_of(axes)
    if is_abstract(grid):
        return [[0]]
    names = list(grid.axis_names)
    perm = [i for i, a in enumerate(names) if a not in axes] \
        + [names.index(a) for a in axes]
    return _index_grid(grid).transpose(perm).reshape(
        -1, axis_size(grid, axes)).tolist()


def coord(grid, p: int, axes) -> int:
    """Place ``p``'s index along ``axes`` (0 for an abstract grid's
    place)."""
    axes = axes_of(axes)
    if is_abstract(grid) or not axes:
        return 0
    at = np.unravel_index(p, [grid.shape[a] for a in grid.axis_names])
    pos = dict(zip(grid.axis_names, at))
    k = 0
    for a in axes:
        k = k * grid.shape[a] + int(pos[a])
    return k


def even_sizes(n: int, k: int) -> List[int]:
    """``n`` rows cut into ``k`` contiguous parts, the first ``n % k`` one
    longer: how a step splits the work of a dimension the rules leave
    whole."""
    return [n // k + (1 if i < n % k else 0) for i in range(k)]


def part_range(n: int, k: int, i: int) -> Tuple[int, int]:
    sizes = even_sizes(n, k)
    lo = sum(sizes[:i])
    return lo, lo + sizes[i]


# ---------------------------------------------------------------------------
# sharded values
# ---------------------------------------------------------------------------

@dataclass
class Sharded:
    """A value of global ``shape`` laid out by ``sharding`` (a
    ``parallel.sharding.NamedSharding``): ``blocks[p]`` is place ``p``'s
    block (module docstring)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Any
    blocks: List[torch.Tensor]

    @property
    def grid(self):
        return self.sharding.mesh

    @property
    def spec(self):
        return self.sharding.spec


def block_slices(sharding, shape, p: int) -> Tuple[slice, ...]:
    """Place ``p``'s block of a ``shape`` array under ``sharding``."""
    bshape = sharding.shard_shape(shape)
    out = []
    for i, n in enumerate(shape):
        entry = sharding.spec[i] if i < len(sharding.spec) else None
        k = coord(sharding.mesh, p, entry)
        out.append(slice(k * bshape[i], (k + 1) * bshape[i])
                   if entry is not None else slice(0, n))
    return tuple(out)


def place(x: torch.Tensor, sharding, copy: bool = False) -> Sharded:
    """``x`` cut into its blocks under ``sharding``; raises
    ``ValueError`` where a split dimension does not divide. A block on
    ``x``'s device is a view of it, or with ``copy`` a copy, so that
    ``x`` can be freed."""
    grid = sharding.mesh
    shape = tuple(x.shape)
    bshape = sharding.shard_shape(shape)
    if is_abstract(grid) or x.device.type == "meta":
        blocks = [torch.empty(bshape, dtype=x.dtype, device="meta")
                  for _ in places(grid)]
        return Sharded(shape, x.dtype, sharding, blocks)
    made: Dict[Tuple, torch.Tensor] = {}
    blocks = []
    for p, dev in enumerate(places(grid)):
        sl = block_slices(sharding, shape, p)
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        if key not in made:
            blk = x[sl]
            made[key] = blk.to(dev, copy=copy or blk.device != dev)
        blocks.append(made[key])
    return Sharded(shape, x.dtype, sharding, blocks)


def zeros(shape, dtype: torch.dtype, sharding) -> Sharded:
    """A zero value of ``shape`` laid out by ``sharding``, its blocks
    made on their places (places on one device share a replicated
    block)."""
    grid = sharding.mesh
    shape = tuple(shape)
    bshape = sharding.shard_shape(shape)
    made: Dict[Tuple, torch.Tensor] = {}
    blocks = []
    for p, dev in enumerate(places(grid)):
        sl = block_slices(sharding, shape, p)
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        if key not in made:
            made[key] = torch.zeros(bshape, dtype=dtype, device=dev)
        blocks.append(made[key])
    return Sharded(shape, dtype, sharding, blocks)


def place_leaves(made, shardings):
    """A tree of ``Sharded`` values from ``made``, an iterable of ``(path,
    tensor)`` in the order of the tree ``shardings`` (``pytree`` paths),
    each tensor's blocks copied to their places before the next is drawn:
    a device that makes the leaves holds one whole leaf at a time."""
    from repro_torch.pytree import flatten_with_path, tree_map_with_path
    is_ns = lambda x: hasattr(x, "spec")
    want = dict(flatten_with_path(shardings, is_leaf=is_ns))
    out = {}
    for path, x in made:
        out[path] = place(x, want[path], copy=True)
        del x
    if set(out) != set(want):
        raise ValueError(f"made {sorted(out)} for {sorted(want)}")
    return tree_map_with_path(lambda path, _: out[path], shardings,
                              is_leaf=is_ns)


def gather(s: Sharded) -> torch.Tensor:
    """The whole tensor of ``s`` on its first place's device (a ``meta``
    tensor on an abstract grid)."""
    if is_abstract(s.grid) or s.blocks[0].device.type == "meta":
        return torch.empty(s.shape, dtype=s.dtype, device="meta")
    out = torch.empty(s.shape, dtype=s.dtype, device=s.blocks[0].device)
    seen = set()
    for p, blk in enumerate(s.blocks):
        sl = block_slices(s.sharding, s.shape, p)
        key = tuple((x.start, x.stop) for x in sl)
        if key not in seen:
            seen.add(key)
            out[sl].copy_(blk)
    return out


def _is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def place_tree(tree, shardings):
    """Every tensor of ``tree`` placed by the sharding at its place in
    ``shardings`` (a tree of the same structure)."""
    return tree_map(lambda x, ns: place(x, ns), tree, shardings)


def gather_tree(tree):
    return tree_map(gather, tree, is_leaf=_is_sharded)


def blocks_at(tree, p: int):
    """Place ``p``'s blocks of a tree of ``Sharded`` values."""
    return tree_map(lambda s: s.blocks[p], tree, is_leaf=_is_sharded)


def assemble(tree_per_place: Sequence, shardings):
    """A tree of ``Sharded`` values from one tree of blocks per place and
    the matching tree of shardings."""
    def leaf(ns, *blocks):
        shape = list(blocks[0].shape)
        for i, entry in enumerate(ns.spec):
            if entry is not None:
                shape[i] *= axis_size(ns.mesh, entry)
        return Sharded(tuple(shape), blocks[0].dtype, ns, list(blocks))
    return tree_map(leaf, shardings, *tree_per_place,
                    is_leaf=lambda x: hasattr(x, "spec"))


# ---------------------------------------------------------------------------
# collectives on lists of per-place tensors
# ---------------------------------------------------------------------------

def _sizes(sizes, k: int, n: int) -> List[int]:
    if sizes is not None:
        return list(sizes)
    if n % k:
        raise ValueError(f"{n} does not divide by {k}")
    return [n // k] * k


def _lowp(x: torch.Tensor) -> bool:
    return x.is_floating_point() and x.element_size() < 4


def _group_sum(xs: Sequence[torch.Tensor], members: Sequence[int]
               ) -> torch.Tensor:
    """Σ xs[m] over ``members`` in order on the first member's device, in
    float32 for lower-precision floats, rounded once."""
    first = xs[members[0]]
    acc_dtype = torch.float32 if _lowp(first) else first.dtype
    acc = first.to(dtype=acc_dtype, copy=True)
    for m in members[1:]:
        acc.add_(_to(xs[m], first.device).to(acc_dtype))
    return acc.to(first.dtype)


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev)


def _ag(xs, grid, axes, dim: int, sizes=None) -> List[torch.Tensor]:
    k = axis_size(grid, axes)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    if k > 1:
        _count("all-gather", _nbytes(xs[0]))
    for g in groups(grid, axes):
        if len(g) < k:                  # the abstract grid's one place
            x = xs[g[0]]
            n = sum(_sizes(sizes, k, x.shape[dim] * k))
            shape = list(x.shape)
            shape[dim] = n
            full = torch.empty(shape, dtype=x.dtype, device=x.device)
        else:
            dev0 = xs[g[0]].device
            full = torch.cat([_to(xs[m], dev0) for m in g], dim) \
                if k > 1 else xs[g[0]]
        for m in g:
            out[m] = _to(full, xs[m].device)
    return out


def _rs(xs, grid, axes, dim: int, sizes=None) -> List[torch.Tensor]:
    k = axis_size(grid, axes)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    if k > 1:
        _count("reduce-scatter", _nbytes(xs[0]))
    for g in groups(grid, axes):
        x0 = xs[g[0]]
        parts = _sizes(sizes, k, x0.shape[dim])
        if len(g) < k:
            total = x0
        else:
            total = _group_sum(xs, g) if k > 1 else x0
        chunks = torch.split(total, parts, dim)
        for i, m in enumerate(g):
            out[m] = _to(chunks[i], xs[m].device)
    return out


def _ar(xs, grid, axes) -> List[torch.Tensor]:
    k = axis_size(grid, axes)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    if k > 1:
        _count("all-reduce", _nbytes(xs[0]))
    for g in groups(grid, axes):
        total = xs[g[0]] if len(g) < k or k == 1 else _group_sum(xs, g)
        for m in g:
            out[m] = _to(total, xs[m].device)
    return out


def _a2a(xs, grid, axes, split_dim: int, concat_dim: int
         ) -> List[torch.Tensor]:
    k = axis_size(grid, axes)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    if k > 1:
        _count("all-to-all", _nbytes(xs[0]))
    for g in groups(grid, axes):
        if k == 1:
            out[g[0]] = xs[g[0]]
            continue
        chunks = {m: torch.chunk(xs[m], k, split_dim) for m in g}
        for r, m_r in enumerate(g):
            dev = xs[m_r].device
            src = g if len(g) == k else [g[0]] * k
            out[m_r] = torch.cat([_to(chunks[m][r], dev) for m in src],
                                 concat_dim)
    return out


def _pieces(want_m, block: int):
    """The pieces of one place's ranges: (holder index c, start, stop) in
    global coordinates, each inside one block."""
    out = []
    for a, b in want_m:
        while a < b:
            c = a // block
            hi = min(b, (c + 1) * block)
            out.append((c, a, hi))
            a = hi
    return out


def _fetch(xs, grid, axes, dim: int, block: int, want: Sequence
           ) -> List[torch.Tensor]:
    k = axis_size(grid, axes)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    recv0 = 0
    for g in groups(grid, axes):
        for i, m in enumerate(g):
            x, dev = xs[m], xs[m].device
            pieces = []
            for c, a, hi in _pieces(want[m], block):
                if len(g) < k:       # abstract: a piece of its shape
                    shape = list(x.shape)
                    shape[dim] = hi - a
                    piece = torch.empty(shape, dtype=x.dtype, device=dev)
                else:
                    piece = _to(xs[g[c]].narrow(dim, a - c * block, hi - a),
                                dev)
                if c != i and m == 0:
                    recv0 += _nbytes(piece)
                pieces.append(piece)
            out[m] = pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                                  dim)
    if recv0:
        _count("collective-permute", recv0)
    return out


def _fetch_transpose(grads, shapes, grid, axes, dim: int, block: int,
                     want: Sequence) -> List[torch.Tensor]:
    """The gradient of ``_fetch``: each received piece's gradient sent
    back to the place that holds it and added into that place's zeros,
    the receivers in grid order (in float32 for lower-precision floats,
    rounded once). Counted as a collective-permute, ``bytes`` what place 0
    receives (on an abstract grid, what it received in the forward: the
    pieces it sends back)."""
    k = axis_size(grid, axes)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    recv0 = 0
    for g in groups(grid, axes):
        if len(g) < k:
            m = g[0]
            shape, dtype, dev = shapes[m]
            out[m] = torch.zeros(shape, dtype=dtype, device=dev)
            recv0 += sum(_nbytes(grads[m].narrow(dim, 0, hi - a))
                         for c, a, hi in _pieces(want[m], block) if c != 0)
            continue
        acc = {}
        for m in g:
            at = 0
            for c, a, hi in _pieces(want[m], block):
                piece = grads[m].narrow(dim, at, hi - a)
                at += hi - a
                holder = g[c]
                shape, dtype, dev = shapes[holder]
                if holder not in acc:
                    acc[holder] = torch.zeros(
                        shape, dtype=torch.float32 if _lowp(piece)
                        else dtype, device=dev)
                if holder == 0 and m != 0:
                    recv0 += _nbytes(piece)
                acc[holder].narrow(dim, a - c * block, hi - a).add_(
                    _to(piece, dev).to(acc[holder].dtype))
        for m in g:
            shape, dtype, dev = shapes[m]
            out[m] = acc[m].to(dtype) if m in acc else \
                torch.zeros(shape, dtype=dtype, device=dev)
    if recv0:
        _count("collective-permute", recv0)
    return out


def _shapes(outs) -> List[Tuple]:
    return [(o.shape, o.dtype, o.device) for o in outs]


def _zeros_for(grads, shapes):
    """The output gradients, zeros for an output that received none."""
    return [torch.zeros(s, dtype=t, device=d) if g is None else g
            for g, (s, t, d) in zip(grads, shapes)]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, dim, sizes, *xs):
        ctx.args = (grid, axes, dim, sizes)
        outs = _ag(list(xs), grid, axes, dim, sizes)
        ctx.outs = _shapes(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        grid, axes, dim, sizes = ctx.args
        gs = _rs(_zeros_for(grads, ctx.outs), grid, axes, dim, sizes)
        return (None, None, None, None, *gs)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, dim, sizes, *xs):
        ctx.args = (grid, axes, dim, sizes)
        outs = _rs(list(xs), grid, axes, dim, sizes)
        ctx.outs = _shapes(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        grid, axes, dim, sizes = ctx.args
        gs = _ag(_zeros_for(grads, ctx.outs), grid, axes, dim, sizes)
        return (None, None, None, None, *gs)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, *xs):
        ctx.args = (grid, axes)
        outs = _ar(list(xs), grid, axes)
        ctx.outs = _shapes(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        grid, axes = ctx.args
        return (None, None, *_ar(_zeros_for(grads, ctx.outs), grid, axes))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, split_dim, concat_dim, *xs):
        ctx.args = (grid, axes, split_dim, concat_dim)
        outs = _a2a(list(xs), grid, axes, split_dim, concat_dim)
        ctx.outs = _shapes(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        grid, axes, split_dim, concat_dim = ctx.args
        gs = _a2a(_zeros_for(grads, ctx.outs), grid, axes, concat_dim,
                  split_dim)
        return (None, None, None, None, *gs)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, axes, dim, block, want, *xs):
        ctx.args = (grid, axes, dim, block, want)
        ctx.ins = _shapes(xs)
        outs = _fetch(list(xs), grid, axes, dim, block, want)
        ctx.outs = _shapes(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        gs = _fetch_transpose(_zeros_for(grads, ctx.outs), ctx.ins,
                              *ctx.args)
        return (None, None, None, None, None, *gs)


def _dim(xs, dim: int) -> int:
    return dim % xs[0].dim()


def all_gather(xs, grid, axes, dim: int = 0, sizes=None):
    """Each place gets its group's blocks joined along ``dim`` in order
    (``sizes``: the members' lengths along ``dim`` where they differ)."""
    return list(_AllGather.apply(grid, axes_of(axes), _dim(xs, dim), sizes,
                                 *xs))


def reduce_scatter(xs, grid, axes, dim: int = 0, sizes=None):
    """Each place gets its part (``sizes``, else equal parts) along
    ``dim`` of its group's sum in grid order."""
    return list(_ReduceScatter.apply(grid, axes_of(axes), _dim(xs, dim),
                                     sizes, *xs))


def all_reduce(xs, grid, axes):
    """Each place gets its group's sum in grid order."""
    return list(_AllReduce.apply(grid, axes_of(axes), *xs))


def all_to_all(xs, grid, axes, split_dim: int, concat_dim: int):
    """Member ``r`` of a group gets chunk ``r`` along ``split_dim`` of each
    member's tensor, joined in order along ``concat_dim``."""
    return list(_AllToAll.apply(grid, axes_of(axes), _dim(xs, split_dim),
                                _dim(xs, concat_dim), *xs))


def fetch(xs, grid, axes, dim: int, block: int, want: Sequence):
    """Place ``p`` gets the global ranges ``want[p]`` (a list of ``(a,
    b)``) along ``dim`` of a value split over ``axes`` in blocks of
    ``block`` (``xs[p]`` holds ``[c·block, (c+1)·block)``, ``c`` its index
    along ``axes``), each range cut from the places that hold it and the
    pieces joined in order. Pieces from other places are counted as one
    collective-permute a call, ``bytes`` what place 0 receives. The
    gradient sends each piece's gradient back to the place that holds it
    (``_fetch_transpose``)."""
    want = tuple(tuple((int(a), int(b)) for a, b in w) for w in want)
    return list(_Fetch.apply(grid, axes_of(axes), _dim(xs, dim), block,
                             want, *xs))


# ---------------------------------------------------------------------------
# lockstep execution of per-place generators
# ---------------------------------------------------------------------------

@dataclass
class Request:
    """A collective a place's generator yields: ``op`` and its operand
    ``x``; ``kw`` the collective's other arguments (``want`` differs per
    place, the rest must agree)."""
    op: str
    x: torch.Tensor
    axes: Tuple[str, ...]
    kw: Dict[str, Any]


def AllGather(x, axes, dim: int = 0, sizes=None) -> Request:
    return Request("all_gather", x, axes_of(axes), dict(dim=dim,
                                                        sizes=sizes))


def ReduceScatter(x, axes, dim: int = 0, sizes=None) -> Request:
    return Request("reduce_scatter", x, axes_of(axes),
                   dict(dim=dim, sizes=sizes))


def AllReduce(x, axes) -> Request:
    return Request("all_reduce", x, axes_of(axes), {})


def AllToAll(x, axes, split_dim: int, concat_dim: int) -> Request:
    return Request("all_to_all", x, axes_of(axes),
                   dict(split_dim=split_dim, concat_dim=concat_dim))


def Fetch(x, axes, dim: int, block: int, want) -> Request:
    return Request("fetch", x, axes_of(axes),
                   dict(dim=dim, block=block, want=list(want)))


_RUN: Dict[str, Callable] = {"all_gather": all_gather,
                             "reduce_scatter": reduce_scatter,
                             "all_reduce": all_reduce,
                             "all_to_all": all_to_all,
                             "fetch": fetch}


def _execute(grid, reqs: List[Request]) -> List[torch.Tensor]:
    op, axes = reqs[0].op, reqs[0].axes
    for r in reqs[1:]:
        if r.op != op or r.axes != axes or (
                op != "fetch" and r.kw != reqs[0].kw):
            raise RuntimeError(f"places disagree at a collective: {op} "
                               f"{axes} {reqs[0].kw} against {r.op} "
                               f"{r.axes} {r.kw}")
    xs = [r.x for r in reqs]
    if op == "fetch":
        kw = reqs[0].kw
        return _RUN[op](xs, grid, axes, kw["dim"], kw["block"],
                        [r.kw["want"] for r in reqs])
    return _RUN[op](xs, grid, axes, **reqs[0].kw)


def lockstep(grid, gens: Sequence) -> list:
    """Run one generator a place (module docstring) to their ends; their
    return values, by place."""
    gens = list(gens)
    if len(gens) != len(places(grid)):
        raise ValueError(f"{len(gens)} programs for "
                         f"{len(places(grid))} places")
    send: List[Any] = [None] * len(gens)
    while True:
        reqs, done = [], []
        for g, s in zip(gens, send):
            try:
                reqs.append(g.send(s))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if reqs:
                raise RuntimeError("some places ended while others wait "
                                   "at a collective")
            return done
        send = _execute(grid, reqs)


class _Join(torch.autograd.Function):
    """Every place's output unchanged, through one autograd node: its
    backward runs once, after every place's gradient has arrived, and
    unpacks a saved tensor first, so under a checkpoint the recompute
    runs there, on one thread (module docstring)."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(xs[0])
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors
        return grads


def lockstep_fn(grid, make: Callable) -> Callable:
    """One function of every place's input, ``fn(x_0, x_1, ...)``, that
    runs the generators ``make(p, x_p)`` in lockstep and returns every
    place's output as a tuple: what a grid-wide checkpoint wraps (module
    docstring)."""
    def run(*xs):
        return _Join.apply(*lockstep(grid, [make(p, x) for p, x in
                                            enumerate(xs)]))
    return run


__all__ = ["AllGather", "AllReduce", "AllToAll", "Fetch", "LEDGER",
           "OPCODES", "ReduceScatter", "Request", "Sharded", "all_gather",
           "all_reduce", "all_to_all", "assemble", "axes_of", "axis_size",
           "block_slices", "blocks_at", "coord", "even_sizes", "fetch",
           "gather", "gather_tree", "groups", "is_abstract", "ledger",
           "lockstep", "lockstep_fn", "part_range", "place", "place_leaves",
           "place_tree", "places", "reduce_scatter", "reset_ledger",
           "zeros"]
