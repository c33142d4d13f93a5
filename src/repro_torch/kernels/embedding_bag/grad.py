"""The lookup's gradient: the backward kernel's wrapper, and the autograd
Function that makes ``embedding_bag`` differentiable in its table.

``embedding_bag_backward(grad_out, idx, v, dtype, order=None)`` returns the
(v, D) table gradient ``grad_table[r] = Σ grad_out[b]`` over the slots
(b, s) with ``idx[b, s] == r < v``: each row summed in float32 in
ascending (b, s) order from 0 and cast once to ``dtype`` (the table's:
float32 or bfloat16). On CUDA tensors it launches
``csrc/embedding_bag_backward.cu`` on a stable sort of the flattened
indices: ``order=(keys, perm)`` when the caller holds that sort already
(the train step sorts each field to find its unique rows), else
``torch.sort`` here (no host synchronisation either way). The kernel
finds the runs of equal keys on the card, splits each run of more than
``LONG_RUN`` slots into column slices that several SMs sum at once from
``cp.async`` rings in shared memory, streams the shorter runs a warp
at a time across run boundaries, and writes zeros to the rows no slot
names, so the output is left unfilled: it and the kernel's scratch are
one ``torch.empty``. No atomics on values. For CPU tensors it runs the
plain version (``ref.embedding_bag_backward_ref``), whose ordered
``index_add_`` gives the same bits, after checking that a given
``order`` is the stable sort.
``BACKWARD_LAUNCHES`` counts calls of the C entry point (one memset and
two kernels each).

The reference differentiates ``jnp.take`` instead, and XLA scatter-adds
the gradient in the table's type: bfloat16 for bfloat16 tables, where
this sum is float32 rounded once (``PERF.md`` §6 records the departure).

:func:`segment_rows` is the same sum for a gradient of one row a slot
(L = 1: ``out[r] = Σ x[e]`` over ``seg[e] == r``), and :func:`gather_rows`
is a row gather ``h[idx]`` whose backward is that ordered sum: the GNN's
message passing and the LM's token embedding take their gradients through
it, never through an unordered scatter.

``EmbeddingBagFunction`` (through :func:`embedding_bag_grad`) has the
forward ``embedding_bag`` (the kernels on the card) and this backward, or
with ``use_kernels=False`` the two plain versions on any device; an
``order`` goes to the kernel's backward. Indices get no gradient. The
wrapper takes no per-slot weights, so no weight gradient is asked of it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ops import embedding_bag
from .ref import embedding_bag_backward_ref, embedding_bag_ref

__all__ = ["BACKWARD_LAUNCHES", "EmbeddingBagFunction", "GatherFunction",
           "LONG_RUN", "SPAN", "embedding_bag_backward",
           "embedding_bag_backward_ref", "embedding_bag_grad", "gather_rows",
           "segment_rows"]

BACKWARD_LAUNCHES = _build.LaunchCounter()
GRAD_DTYPES = (torch.float32, torch.bfloat16)
# sorted positions whose runs one warp of the kernel streams (kTile)
SPAN = 32
# runs of more slots are split into column slices over several SMs
# (kLongRun)
LONG_RUN = 64

Order = Tuple[torch.Tensor, torch.Tensor]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "embedding_bag_backward_launch": ((_P, _LL, _P, _I, _P, _LL, _LL, _LL,
                                       _LL, _P, _I, _P, _LL, _P),
                                      ctypes.c_int),
    "embedding_bag_backward_workspace": ((_LL, _LL, _LL), _LL),
}


def _check(grad_out: torch.Tensor, idx: torch.Tensor, v: int) -> None:
    if idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError("embedding_bag_backward: idx must be a 2-D "
                        f"int32/int64 tensor, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if grad_out.dim() != 2 or grad_out.shape[0] != idx.shape[0]:
        raise ValueError("embedding_bag_backward: grad_out must be (B, D) "
                         f"for {idx.shape[0]} bags, got "
                         f"{tuple(grad_out.shape)}")
    if grad_out.device != idx.device:
        raise ValueError("embedding_bag_backward: grad_out and idx must "
                         "share a device")
    if not 1 <= v < 2 ** 31:
        raise ValueError("embedding_bag_backward: the table needs 1 to "
                         f"2^31 - 1 rows, got {v}")


def _check_order(idx: torch.Tensor, order: Order) -> Order:
    """``order`` as the kernel reads it: (keys, perm) of B·L elements on
    ``idx``'s device, keys of ``idx``'s dtype, perm int64. On CPU tensors
    it must also be the stable sort of ``idx.reshape(-1)``: keys ascend,
    ``flat[perm] == keys``, perm a permutation ascending within equal
    keys."""
    keys, perm = order
    n = idx.numel()
    if keys.dtype != idx.dtype or perm.dtype != torch.int64:
        raise TypeError("embedding_bag_backward: order must be (keys of "
                        f"idx's dtype {idx.dtype}, int64 perm), got "
                        f"({keys.dtype}, {perm.dtype})")
    if keys.shape != (n,) or perm.shape != (n,):
        raise ValueError(f"embedding_bag_backward: order must hold {n} "
                         f"keys and positions, got {tuple(keys.shape)}, "
                         f"{tuple(perm.shape)}")
    if keys.device != idx.device or perm.device != idx.device:
        raise ValueError("embedding_bag_backward: order must be on idx's "
                         "device")
    if idx.device.type == "cpu" and n:
        flat = idx.reshape(-1)
        tie = keys[1:] == keys[:-1]
        if not (bool((keys[1:] >= keys[:-1]).all())
                and bool((perm >= 0).all()) and bool((perm < n).all())
                and bool((torch.bincount(perm, minlength=n) == 1).all())
                and torch.equal(flat[perm], keys)
                and bool((perm[1:][tie] > perm[:-1][tie]).all())):
            raise ValueError("embedding_bag_backward: order is not the "
                             "stable sort of idx.reshape(-1)")
    return keys.contiguous(), perm.contiguous()


def _workspace_bytes(n: int, v: int, d: int) -> int:
    """Bytes of scratch the C entry needs for n sorted slots, v rows of d
    columns."""
    lib = _build.load("embedding_bag_backward", _SIGNATURES)
    need = lib.embedding_bag_backward_workspace(n, v, d)
    if need < 0:
        raise ValueError(f"embedding_bag_backward: no workspace for n={n}, "
                         f"v={v}, d={d}")
    return need


def _launch_sorted(grad_out: torch.Tensor, keys: torch.Tensor,
                   perm: torch.Tensor, ll: int, v: int,
                   dtype: torch.dtype = torch.float32, *,
                   out: Optional[torch.Tensor] = None,
                   work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One call of the C entry point on CUDA tensors: the (v, D) gradient
    from ``grad_out`` (float32, rows read in place where they are
    contiguous) and the stable sort (``keys``, ``perm``) of the B·L
    indices of bags of ``ll`` slots, which the caller has checked
    (``_check_order``). The output and the scratch share one allocation
    unless ``out`` ((v, D), contiguous, of ``dtype``) and ``work`` (uint8
    scratch) are given, as a CUDA graph's replays need."""
    if grad_out.dtype != torch.float32 or dtype not in GRAD_DTYPES:
        raise TypeError("embedding_bag_backward: the kernel takes a float32 "
                        f"grad_out and returns float32 or bfloat16, got "
                        f"{grad_out.dtype} -> {dtype}")
    if grad_out.stride(1) != 1 or grad_out.stride(0) < grad_out.shape[1]:
        grad_out = grad_out.contiguous()
    dev = grad_out.device
    n, d = keys.numel(), grad_out.shape[1]
    need = _workspace_bytes(n, v, d)
    if out is None and work is None:
        # one allocation: the output, then the scratch from a 256-byte
        # boundary
        item = 4 if dtype == torch.float32 else 2
        at = -(-v * d * item // 256) * 256
        buf = torch.empty(-(-(at + need) // item), dtype=dtype, device=dev)
        out = buf.as_strided((v, d), (d, 1))
        work_ptr = buf.data_ptr() + at
    else:
        if out is None:
            out = torch.empty((v, d), dtype=dtype, device=dev)
        if work is None:
            work = torch.empty(need, dtype=torch.uint8, device=dev)
        if (out.shape != (v, d) or out.dtype != dtype
                or not out.is_contiguous() or out.device != dev):
            raise ValueError(f"embedding_bag_backward: out must be a "
                             f"contiguous ({v}, {d}) {dtype} tensor on "
                             f"{dev}")
        if (work.dtype != torch.uint8 or work.device != dev
                or not work.is_contiguous() or work.numel() < need):
            raise ValueError(f"embedding_bag_backward: work must be {need} "
                             f"contiguous uint8 bytes on {dev}")
        work_ptr = work.data_ptr()
    lib = _build.load("embedding_bag_backward", _SIGNATURES)
    with _build.on_device(dev):
        rc = lib.embedding_bag_backward_launch(
            grad_out.data_ptr(), grad_out.stride(0), keys.data_ptr(),
            keys.element_size(), perm.data_ptr(), n, ll, v, d,
            out.data_ptr(), out.element_size(), work_ptr, need,
            _build.stream_ptr(dev))
    _build.check_launch("embedding_bag_backward", rc)
    BACKWARD_LAUNCHES.add()
    return out


def embedding_bag_backward(grad_out: torch.Tensor, idx: torch.Tensor,
                           v: int, dtype: torch.dtype = torch.float32,
                           order: Optional[Order] = None) -> torch.Tensor:
    """The (v, D) table gradient of ``embedding_bag(table, idx)`` for the
    output gradient ``grad_out`` (B, D) (module docstring): the kernel on
    CUDA tensors, the plain version on CPU tensors. ``order``: the stable
    sort ``(keys, perm)`` of ``idx.reshape(-1)``, where the caller has it.
    A negative index raises ``ValueError`` on the CPU; on the card the
    kernel skips it (the forward has trapped on it already)."""
    _check(grad_out, idx, v)
    if order is not None:
        order = _check_order(idx, order)
    if grad_out.device.type == "cpu":
        if idx.numel() and int(idx.min()) < 0:
            raise ValueError("embedding_bag_backward: negative index")
        return embedding_bag_backward_ref(grad_out, idx, v, dtype)
    if order is None:
        order = torch.sort(idx.reshape(-1), stable=True)
    return _launch_sorted(grad_out, *order, idx.shape[1], v, dtype)


class EmbeddingBagFunction(torch.autograd.Function):
    """``embedding_bag`` with the table's gradient (module docstring)."""

    @staticmethod
    def forward(ctx, table, idx, use_kernels, order=None):
        ctx.save_for_backward(idx, *(order or ()))
        ctx.table = (table.shape[0], table.dtype, use_kernels)
        if use_kernels:
            return embedding_bag(table, idx)
        return embedding_bag_ref(table, idx)

    @staticmethod
    def backward(ctx, grad_out):
        idx, *order = ctx.saved_tensors
        v, dtype, use_kernels = ctx.table
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if not use_kernels:
            return (embedding_bag_backward_ref(grad_out, idx, v, dtype),
                    None, None, None)
        return (embedding_bag_backward(grad_out, idx, v, dtype,
                                       order=tuple(order) or None),
                None, None, None)


def embedding_bag_grad(table: torch.Tensor, idx: torch.Tensor, *,
                       use_kernels: bool = True,
                       order: Optional[Order] = None) -> torch.Tensor:
    """``embedding_bag(table, idx)`` (or its plain version with
    ``use_kernels=False``), differentiable in ``table``; ``order``, the
    stable sort of ``idx.reshape(-1)`` (``embedding_bag_backward``), goes
    to the kernel's backward."""
    return EmbeddingBagFunction.apply(table, idx, use_kernels, order)


def segment_rows(x: torch.Tensor, seg: torch.Tensor, n: int,
                 order: Optional[Order] = None, *, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(n, ...) rows ``out[r] = Σ x[e]`` over ``seg[e] == r``, for a 1-D
    or 2-D float32 ``x`` and (E,) ids ``seg``, summed in float32 in ``e``
    order and returned in ``dtype`` (``x``'s by default):
    :func:`embedding_bag_backward` with L = 1 (the kernel on CUDA tensors,
    on ``order`` where given) or, with ``use_kernels=False``, its plain
    version."""
    x2d = x.unsqueeze(1) if x.dim() == 1 else x
    idx = seg.unsqueeze(1)
    dtype = x.dtype if dtype is None else dtype
    if use_kernels:
        out = embedding_bag_backward(x2d, idx, n, dtype, order=order)
    else:
        out = embedding_bag_backward_ref(x2d, idx, n, dtype)
    return out.squeeze(1) if x.dim() == 1 else out


class GatherFunction(torch.autograd.Function):
    """``h.index_select(0, idx)``; the backward is :func:`segment_rows` of
    the output gradient (widened to float32) by ``idx``, in ``h``'s
    dtype."""

    @staticmethod
    def forward(ctx, h, idx, order, use_kernels):
        ctx.save_for_backward(idx, *(order or ()))
        ctx.rows, ctx.dtype, ctx.use_kernels = h.shape[0], h.dtype, \
            use_kernels
        return h.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        idx, *order = ctx.saved_tensors
        return (segment_rows(grad.float(), idx, ctx.rows,
                             tuple(order) or None,
                             use_kernels=ctx.use_kernels, dtype=ctx.dtype),
                None, None, None)


def gather_rows(h: torch.Tensor, idx: torch.Tensor,
                order: Optional[Order] = None, *,
                use_kernels: bool = True) -> torch.Tensor:
    """``h[idx]`` for (E,) int32/int64 ``idx``, differentiable in ``h``:
    its gradient is the ordered sum of the output gradient's rows by
    ``idx`` (:func:`segment_rows`, on ``order``, the stable sort of
    ``idx``, where given), so the scatter of a gather's gradient runs on
    the kernel, in index order, with no atomics."""
    return GatherFunction.apply(h, idx, order, use_kernels)
