"""Public wrapper of the EmbeddingBag kernels: checks, mode, routing,
dispatch.

``embedding_bag(table, idx, mode=...)`` keeps the reference's ``mode``
values and its ``"auto"`` rule (``"onehot"`` for a table of at most
2^22 bytes, else ``"dma"``). On the TPU the two modes are two kernels: a
per-row HBM->VMEM DMA gather, and a one-hot MXU product for small tables.
On this card (``csrc/embedding_bag.cu``):

* ``"dma"`` launches the row gather (``rows_kernel``): one warp per bag,
  each live slot's row read from global memory;
* ``"onehot"`` launches the column-sliced kernel (``slices_kernel``),
  which holds a column slice of the table in each block's shared memory,
  where :func:`onehot_route` takes it: the slice that
  :func:`onehot_slice_width` finds (the widest power of two from one
  16-byte vector, 4 float32 or 8 bfloat16 values, to 128 that fits, on a
  16-byte aligned table) is at least ``SLICE_ROUTE_MIN_W`` of the table's
  type wide; elsewhere (narrower slices, which the row gather beats or
  ties on the card, a table too tall for any slice, a width no slice
  divides, an unaligned view) it launches the row gather too. The rule is
  by shape, type and alignment, not a fallback.

Each mode keeps its own launch count (``LAUNCHES``), and each "onehot"
variant its own (``ONEHOT_LAUNCHES``), so a run shows what it launched.
Both kernels add a bag's slots in order from 0 in float32, so "onehot"
and "dma" give the same bits. For CPU tensors the wrapper runs the plain
version in ``ref.py``.

The wrapper takes float32 or bfloat16 tables and int32 or int64 indices,
which the kernels read in place: no copy, no cast and no host
synchronisation on the card. The output is float32 for both table types:
a bfloat16 row is widened to float32 and then added, which is what the
reference DLRM computes (``vec.astype(float32)`` then the bag sum). The
TPU's dma kernel adds in the table's type instead; the port's kernels do
not (``PERF.md`` §6 records the departure). Any index >= V is
an empty slot, as the reference's PAD (== V) is. A negative index raises
``ValueError`` on the CPU; on the card it traps in either kernel (a
device-side fault), which surfaces at the next synchronisation and leaves
the CUDA context unusable, as a device-side assert of PyTorch's own index
kernels does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import embedding_bag_ref

__all__ = ["LAUNCHES", "MODES", "ONEHOT_LAUNCHES", "embedding_bag",
           "embedding_bag_ref", "onehot_grid", "onehot_route",
           "onehot_slice_width", "resolve_mode"]

MODES = ("auto", "dma", "onehot")
# the reference's "auto" rule: the one-hot formulation for tables of at
# most this many bytes
ONEHOT_MAX_BYTES = 1 << 22
TABLE_DTYPES = (torch.float32, torch.bfloat16)
# the column slices: the shared memory one block of an H100 may take
# (227 KB, opt-in), all of it for the slice: the index stage takes none
# (each thread holds its bag's indices, or 8 bags' at L = 1, in registers);
# slices of one 16-byte vector (4 float32, 8 bfloat16 values) to 128
# values, so a row's slice is at least one 16-byte copy and a bag's w / 4
# threads (4 values each) sit in one warp
SLICE_SMEM_BYTES = 232_448
SLICE_VECTOR_BYTES, SLICE_MAX_W = 16, 128
# the H100's SMs: the grid's default when no card is asked
H100_SMS = 132
# where "onehot" takes the column-sliced kernel (onehot_route): slices of
# at least 32 floats. Narrower slices tie with the row gather (w = 16: -3 %
# to +2 % over three calls) or lose to it: each block copies a whole slice
# (229 KB at V = 7,168, w = 8) before it gathers, output pieces of w < 32
# floats are partial-line writes, and at w = 8 the random rows of 4 bags
# meet bank conflicts in each 128 bytes of shared memory read. ms of the
# launch alone, slices / rows, at D = 128, B = 65,536 int64 bags (~10 %
# PAD at L = 8), one H100 80GB HBM3 at 700 W (scripts/kernel_ab_probe.py
# --runs bag_sweep, two launches of each in turns):
#   V = 512 (w = 64):    L = 1 0.0121 / 0.0140, L = 8 0.0249 / 0.0261
#   V = 1,024 (w = 32):  L = 1 0.0123 / 0.0137, L = 8 0.0249 / 0.0267
#   V = 2,048 (w = 16):  L = 1 0.0141 / 0.0142, L = 8 0.0274 / 0.0278
#   V = 2,560 (w = 16):  L = 1 0.0145 / 0.0145, L = 8 0.0280 / 0.0282
#   V = 7,168 (w = 8):   L = 1 0.0218 / 0.0152, L = 8 0.0408 / 0.0314
#   V = 7,680 (w = 4):   L = 1 0.0507 / 0.0158, L = 8 0.0582 / 0.0315
# bfloat16 tables, measured on their own (a bfloat16 slice of w values is
# half the bytes of a float32 one; its output piece is the same w floats):
# the slices win from w = 32 on at both bag lengths, as at float32; at
# w = 16 they lose at L = 1 and tie at L = 8, at w = 8 they lose. The
# same measure, bfloat16 tables (scripts/kernel_ab_probe.py --runs
# bag_sweep --dtype bfloat16, one H100 80GB HBM3 at 700 W):
#   V = 512 (w = 128):   L = 1 0.0122 / 0.0147, L = 8 0.0249 / 0.0322
#   V = 1,024 (w = 64):  L = 1 0.0126 / 0.0150, L = 8 0.0267 / 0.0330
#   V = 2,048 (w = 32):  L = 1 0.0137 / 0.0149, L = 8 0.0280 / 0.0334
#   V = 2,560 (w = 32):  L = 1 0.0138 / 0.0147, L = 8 0.0282 / 0.0333
#   V = 7,168 (w = 16):  L = 1 0.0190 / 0.0154, L = 8 0.0337 / 0.0340
#   V = 7,680 (w = 8):   L = 1 0.0226 / 0.0154, L = 8 0.0356 / 0.0342
#   V = 13,312 (w = 8):  L = 1 0.0278 / 0.0159, L = 8 0.0421 / 0.0343
# The threshold in values, by the table's element size in bytes.
SLICE_ROUTE_MIN_W = {4: 32, 2: 32}

LAUNCHES = {"dma": _build.LaunchCounter(), "onehot": _build.LaunchCounter()}
ONEHOT_LAUNCHES = {"slices": _build.LaunchCounter(),
                   "rows": _build.LaunchCounter()}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "embedding_bag_rows_launch": ((_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P,
                                   _P), ctypes.c_int),
    "embedding_bag_slices_launch": ((_P, _I, _LL, _LL, _I, _I, _P, _I, _LL,
                                     _LL, _P, _P), ctypes.c_int),
}
_SMS = {}


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


def onehot_slice_width(v: int, d: int, aligned: bool = True,
                       elem: int = 4) -> int:
    """The "onehot" route's slice width for a (v, d) table of ``elem``-byte
    values (4: float32, 2: bfloat16): the widest power of two w from
    ``SLICE_VECTOR_BYTES / elem`` to SLICE_MAX_W with ``d % w == 0`` and
    ``v * w * elem <= SLICE_SMEM_BYTES``, or 0 (the row gather) when there
    is none or the table is not ``aligned`` to 16 bytes. At d = 128,
    float32: w = 128 up to v = 454, 64 up to 908, 32 up to 1,816, 16 up to
    3,632, 8 up to 7,264, 4 up to 14,528, then 0; bfloat16: 128 up to 908,
    64 up to 1,816, 32 up to 3,632, 16 up to 7,264, 8 up to 14,528."""
    if not aligned:
        return 0
    w = SLICE_MAX_W
    while w >= SLICE_VECTOR_BYTES // elem:
        if d % w == 0 and v * w * elem <= SLICE_SMEM_BYTES:
            return w
        w //= 2
    return 0


def onehot_route(v: int, d: int, aligned: bool = True,
                 elem: int = 4) -> int:
    """The "onehot" variant for a (v, d) table of ``elem``-byte values: the
    slice width of the column-sliced kernel where
    :func:`onehot_slice_width` finds one of at least
    ``SLICE_ROUTE_MIN_W[elem]`` values (at d = 128, float32: up to v =
    1,816), else 0 for the row gather. The same at every bag length
    measured (L = 1 and 8)."""
    w = onehot_slice_width(v, d, aligned, elem)
    return w if w >= SLICE_ROUTE_MIN_W[elem] else 0


def onehot_grid(b: int, d: int, w: int, n_sm: int = H100_SMS):
    """(slices, bag ranges) of the column-sliced kernel's persistent grid:
    d / w slices times floor(n_sm / slices) ranges (at least 1, at most
    one a bag), one block each. At d = 128 on 132 SMs: w = 8 gives
    16 x 8 = 128 blocks."""
    n_slices = d // w
    return n_slices, max(1, min(b, n_sm // n_slices))


@functools.lru_cache(maxsize=1024)
def _onehot_plan(v: int, d: int, b: int, aligned: bool, n_sm: int,
                 elem: int):
    """(slice width, bag ranges) of one "onehot" call; (0, 0) for the row
    gather."""
    w = onehot_route(v, d, aligned, elem)
    return (w, onehot_grid(b, d, w, n_sm)[1]) if w else (0, 0)


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype not in TABLE_DTYPES:
        raise TypeError("embedding_bag: table must be a 2-D float32 or "
                        f"bfloat16 tensor, got {table.dtype} "
                        f"{tuple(table.shape)}")
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


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _launch(table: torch.Tensor, idx: torch.Tensor,
            mode: str) -> torch.Tensor:
    """One launch on CUDA tensors: ``mode``'s kernel, the indices read in
    place (a copy only where ``idx`` is not contiguous)."""
    table = table.contiguous()
    idx = idx.contiguous()
    b, ll = idx.shape
    v, d = table.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    lib = _build.load("embedding_bag", _SIGNATURES)
    elem = table.element_size()
    w, n_ranges = _onehot_plan(v, d, b, table.data_ptr() % 16 == 0,
                               _sm_count(table.device), elem) \
        if mode == "onehot" else (0, 0)
    with _build.on_device(table.device):
        stream = _build.stream_ptr(table.device)
        if w:
            rc = lib.embedding_bag_slices_launch(
                table.data_ptr(), elem, v, d, w, n_ranges, idx.data_ptr(),
                idx.element_size(), b, ll, out.data_ptr(), stream)
        else:
            rc = lib.embedding_bag_rows_launch(
                table.data_ptr(), elem, v, d, idx.data_ptr(),
                idx.element_size(), b, ll, out.data_ptr(), stream)
    _build.check_launch("embedding_bag", rc)
    LAUNCHES[mode].add()
    if mode == "onehot":
        ONEHOT_LAUNCHES["slices" if w else "rows"].add()
    return out


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "auto") -> torch.Tensor:
    """Bag-sum embedding lookup: ``out[b] = Σ_l table[idx[b, l]]`` over the
    slots with ``idx[b, l] < V``, summed in float32 in slot order.

    ``table`` (V, D) float32 or bfloat16, ``idx`` (B, L) int32/int64 on
    the same device; returns (B, D) float32 (a bfloat16 row widened, then
    added). ``mode`` is 'dma', 'onehot' or 'auto'
    (by table size, as in the reference)."""
    _check(table, idx)
    mode = resolve_mode(table, mode)
    if table.device.type == "cpu":
        if idx.numel() and int(idx.min()) < 0:
            raise ValueError("embedding_bag: negative index")
        return embedding_bag_ref(table, idx)
    return _launch(table, idx, mode)
