"""Public wrapper of the EmbeddingBag kernel: checks, mode, dispatch.

``embedding_bag(table, idx, mode=...)`` keeps the reference's ``mode``
values and its ``"auto"`` rule (``"onehot"`` for a table of at most
2^22 bytes, else ``"dma"``). On the TPU the two modes are two kernels: a
per-row HBM->VMEM DMA gather, and a one-hot MXU product for small tables.
On this card a table of at most 4 MB sits in L2, so both modes launch the
same gather-and-sum kernel (``csrc/embedding_bag.cu``); each mode keeps
its own launch count, so a run shows which modes it launched. For CPU
tensors the wrapper runs the plain version in ``ref.py``.

The wrapper takes float32 tables (the type every caller of the reference
uses) and raises on any other, and on negative indices. Any index >= V is
an empty slot, as the reference's PAD (== V) is.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import embedding_bag_ref

__all__ = ["LAUNCHES", "MODES", "embedding_bag", "embedding_bag_ref",
           "resolve_mode"]

MODES = ("auto", "dma", "onehot")
# the reference's "auto" rule: the one-hot formulation for tables of at
# most this many bytes
ONEHOT_MAX_BYTES = 1 << 22

LAUNCHES = {"dma": _build.LaunchCounter(), "onehot": _build.LaunchCounter()}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "embedding_bag_launch": ((_P, _LL, _LL, _P, _LL, _LL, _P, _P),
                             ctypes.c_int),
}


def resolve_mode(table: torch.Tensor, mode: str) -> str:
    """The mode ``embedding_bag`` runs: ``mode`` itself, or for ``"auto"``
    the reference's rule by table bytes."""
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r} not in {MODES}")
    if mode != "auto":
        return mode
    v, d = table.shape
    return "onehot" if v * d * table.element_size() <= ONEHOT_MAX_BYTES \
        else "dma"


def _check(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int32 contiguous indices with every PAD (>= V) set to V."""
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError("embedding_bag: table must be a 2-D float32 tensor, "
                        f"got {table.dtype} {tuple(table.shape)}")
    if not 1 <= table.shape[0] < 2 ** 31:
        raise ValueError("embedding_bag: the table needs 1 to 2^31 - 1 "
                         f"rows, got {table.shape[0]}")
    if idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError("embedding_bag: idx must be a 2-D int32/int64 "
                        f"tensor, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError("embedding_bag: table and idx must share a device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    if idx.numel() and int(idx.min()) < 0:
        raise ValueError("embedding_bag: negative index")
    return idx.clamp(max=table.shape[0]).to(torch.int32).contiguous()


def _launch(table: torch.Tensor, idx: torch.Tensor,
            mode: str) -> torch.Tensor:
    table = table.contiguous()
    b, ll = idx.shape
    v, d = table.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    lib = _build.load("embedding_bag", _SIGNATURES)
    with torch.cuda.device(table.device):
        rc = lib.embedding_bag_launch(
            table.data_ptr(), v, d, idx.data_ptr(), b, ll, out.data_ptr(),
            _build.stream_ptr(table.device))
    _build.check_launch("embedding_bag", rc)
    LAUNCHES[mode].add()
    return out


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "auto") -> torch.Tensor:
    """Bag-sum embedding lookup: ``out[b] = Σ_l table[idx[b, l]]`` over the
    slots with ``idx[b, l] < V``, summed in float32 in slot order.

    ``table`` (V, D) float32, ``idx`` (B, L) int32/int64 on the same
    device; returns (B, D) float32. ``mode`` is 'dma', 'onehot' or 'auto'
    (by table size, as in the reference)."""
    idx = _check(table, idx)
    mode = resolve_mode(table, mode)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, idx)
    return _launch(table, idx, mode)
