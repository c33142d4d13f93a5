"""Public wrapper of the dense triangle-count kernel: checks and dispatch.

For CUDA tensors it launches ``csrc/triangle_dense.cu`` (built with
``nvcc`` at first use; int8 tensor-core products; its last block sums the
per-block int64 partials), or raises; for CPU tensors it runs the plain
version in ``ref.py``. The kernel takes rows whose width is a multiple of
16 bytes, each starting on a 16-byte boundary, as the executor's one-hots
are; any other input is copied, zero-padded, into such a buffer first
(zero columns add nothing to the count). Like the reference's dense lane
it notes nothing on the kernel ledger.
"""

from __future__ import annotations

import ctypes
import torch

from .. import _build
from .ref import triangle_count_ref

__all__ = ["LAUNCHES", "triangle_count"]

LAUNCHES = _build.LaunchCounter()

_P = ctypes.c_void_p
_SIGNATURES = {
    "triangle_dense_launch": (
        (_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P, _P,
         _P, _P), ctypes.c_int),
    "triangle_dense_n_partials": ((ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong), ctypes.c_longlong),
}


def _check(a, b, mask) -> None:
    for name, t in (("a", a), ("b", b), ("mask", mask)):
        if t.dim() != 2 or t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"triangle_count: {name} must be a contiguous "
                             f"2-D uint8 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"triangle_count: a and b widths differ "
                         f"({a.shape[1]} vs {b.shape[1]})")
    if tuple(mask.shape) != (a.shape[0], b.shape[0]):
        raise ValueError(f"triangle_count: mask must be {(a.shape[0], b.shape[0])}"
                         f", got {tuple(mask.shape)}")
    if len({a.device, b.device, mask.device}) != 1:
        raise ValueError("triangle_count: all tensors must share a device")
    if max(a.shape[0], b.shape[0]) >= 2 ** 31:
        raise ValueError("triangle_count: more than 2^31 - 1 rows")


# the kernel's row alignment and width granule, in bytes
ALIGN = 16


def _aligned(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` itself when its rows are ``width`` bytes wide and start on
    ALIGN-byte boundaries, else a zero-padded copy that is."""
    if t.shape[1] == width and t.data_ptr() % ALIGN == 0:
        return t
    out = torch.zeros((t.shape[0], width), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def _launch(a, b, mask) -> torch.Tensor:
    width = -(-a.shape[1] // ALIGN) * ALIGN
    a, b = _aligned(a, width), _aligned(b, width)
    nx, d = a.shape
    ny = b.shape[0]
    lib = _build.load("triangle_dense", _SIGNATURES)
    n_part = lib.triangle_dense_n_partials(nx, ny, d)
    if n_part == 0:
        return torch.zeros((), dtype=torch.int64, device=a.device)
    dev = a.device
    # the block partials, the total, and the zero word the blocks count
    # themselves on (its last block sums the partials into the total)
    partials = torch.zeros(n_part + 2, dtype=torch.int64, device=dev)
    with _build.on_device(dev):
        rc = lib.triangle_dense_launch(
            a.data_ptr(), b.data_ptr(), mask.data_ptr(), nx, ny, d,
            partials.data_ptr(), partials[n_part + 1:].data_ptr(),
            partials[n_part:].data_ptr(), _build.stream_ptr(dev))
    _build.check_launch("triangle_dense", rc)
    LAUNCHES.add()
    return partials[n_part]


def triangle_count(a: torch.Tensor, b: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked dense triangle count Σ mask ⊙ (A Bᵀ), exact, as a 0-d int64
    tensor. ``a`` (nx, d), ``b`` (ny, d) and ``mask`` (nx, ny) are 0/1
    uint8; any shape is taken (see the module note on widths)."""
    _check(a, b, mask)
    if a.device.type == "cpu":
        return triangle_count_ref(a, b, mask)
    if a.device.type == "cuda":
        return _launch(a, b, mask)
    raise ValueError(f"triangle_count: unsupported device {a.device}")
