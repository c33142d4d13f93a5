"""The lookup's gradient: the backward kernel's wrapper, and the autograd
Function that makes ``embedding_bag`` differentiable in its table.

``embedding_bag_backward(grad_out, idx, v, dtype)`` returns the (v, D)
table gradient ``grad_table[r] = Σ grad_out[b]`` over the slots (b, s)
with ``idx[b, s] == r < v``: each row summed in float32 in ascending
(b, s) order from 0 and cast once to ``dtype`` (the table's: float32 or
bfloat16). On CUDA tensors it sorts the flattened indices with a stable
sort (``torch.sort``: no host synchronisation) and launches
``csrc/embedding_bag_backward.cu``, one warp per run of equal indices,
no atomics; for CPU tensors it runs the plain version
(``ref.embedding_bag_backward_ref``), whose ordered ``index_add_`` gives
the same bits. ``BACKWARD_LAUNCHES`` counts the launches.

The reference differentiates ``jnp.take`` instead, and XLA scatter-adds
the gradient in the table's type: bfloat16 for bfloat16 tables, where
this sum is float32 rounded once (``PERF.md`` §6 records the departure).

``EmbeddingBagFunction`` (through :func:`embedding_bag_grad`) has the
forward ``embedding_bag`` (the kernels on the card) and this backward, or
with ``use_kernels=False`` the two plain versions on any device. Indices
get no gradient. The wrapper takes no per-slot weights, so no weight
gradient is asked of it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ops import embedding_bag
from .ref import embedding_bag_backward_ref, embedding_bag_ref

__all__ = ["BACKWARD_LAUNCHES", "EmbeddingBagFunction",
           "embedding_bag_backward", "embedding_bag_backward_ref",
           "embedding_bag_grad"]

BACKWARD_LAUNCHES = _build.LaunchCounter()
GRAD_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "embedding_bag_backward_launch": ((_P, _LL, _P, _I, _P, _LL, _LL, _LL,
                                       _LL, _P, _I, _P), ctypes.c_int),
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


def _launch(grad_out: torch.Tensor, idx: torch.Tensor, v: int,
            dtype: torch.dtype) -> torch.Tensor:
    """One launch on CUDA tensors (``grad_out`` float32, read in place
    where its rows are contiguous)."""
    if grad_out.dtype != torch.float32 or dtype not in GRAD_DTYPES:
        raise TypeError("embedding_bag_backward: the kernel takes a float32 "
                        f"grad_out and returns float32 or bfloat16, got "
                        f"{grad_out.dtype} -> {dtype}")
    if grad_out.stride(1) != 1 or grad_out.stride(0) < grad_out.shape[1]:
        grad_out = grad_out.contiguous()
    b, ll = idx.shape
    d = grad_out.shape[1]
    out = torch.zeros((v, d), dtype=dtype, device=grad_out.device)
    n = b * ll
    if n == 0 or d == 0:
        return out
    keys, perm = torch.sort(idx.reshape(-1), stable=True)
    lib = _build.load("embedding_bag_backward", _SIGNATURES)
    with _build.on_device(grad_out.device):
        rc = lib.embedding_bag_backward_launch(
            grad_out.data_ptr(), grad_out.stride(0), keys.data_ptr(),
            keys.element_size(), perm.data_ptr(), n, ll, v, d,
            out.data_ptr(), out.element_size(),
            _build.stream_ptr(grad_out.device))
    _build.check_launch("embedding_bag_backward", rc)
    BACKWARD_LAUNCHES.add()
    return out


def embedding_bag_backward(grad_out: torch.Tensor, idx: torch.Tensor,
                           v: int, dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The (v, D) table gradient of ``embedding_bag(table, idx)`` for the
    output gradient ``grad_out`` (B, D) (module docstring): the kernel on
    CUDA tensors, the plain version on CPU tensors. A negative index
    raises ``ValueError`` on the CPU; on the card the kernel skips it (the
    forward has trapped on it already)."""
    _check(grad_out, idx, v)
    if grad_out.device.type == "cpu":
        if idx.numel() and int(idx.min()) < 0:
            raise ValueError("embedding_bag_backward: negative index")
        return embedding_bag_backward_ref(grad_out, idx, v, dtype)
    return _launch(grad_out, idx, v, dtype)


class EmbeddingBagFunction(torch.autograd.Function):
    """``embedding_bag`` with the table's gradient (module docstring)."""

    @staticmethod
    def forward(ctx, table, idx, use_kernels):
        ctx.save_for_backward(idx)
        ctx.table = (table.shape[0], table.dtype, use_kernels)
        if use_kernels:
            return embedding_bag(table, idx)
        return embedding_bag_ref(table, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        v, dtype, use_kernels = ctx.table
        if not ctx.needs_input_grad[0]:
            return None, None, None
        back = embedding_bag_backward if use_kernels \
            else embedding_bag_backward_ref
        return back(grad_out, idx, v, dtype), None, None


def embedding_bag_grad(table: torch.Tensor, idx: torch.Tensor, *,
                       use_kernels: bool = True) -> torch.Tensor:
    """``embedding_bag(table, idx)`` (or its plain version with
    ``use_kernels=False``), differentiable in ``table``."""
    return EmbeddingBagFunction.apply(table, idx, use_kernels)
