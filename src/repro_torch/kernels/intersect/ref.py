"""Plain PyTorch versions of the intersect kernel (row-batched
``torch.searchsorted``): the lanes the wrappers run for CPU tensors, and
the oracles ``chip_smoke.py`` holds the CUDA kernel against on the card.

* ``intersect_count_ref``: ``a`` (Ra, Ka) and ``b`` (Rb, Kb) int32
  matrices of sorted, SENTINEL-padded rows (sets) -> (E,) int32 per-row
  intersection sizes |a[ia[i]] ∩ b[ib[i]]|, with ``ia = ib = arange(E)``
  when no index is given.
* ``intersect_rows_ref``: the same over compact CSR (int64 offsets, int32
  values, int64 key positions per pair), by gathering each batch of pairs
  into SENTINEL-padded tiles as wide as the batch's widest row.

This is the batched form of the paper's leapfrog join at trie level z
(Alg. 1 line 3): each element of the x-row is probed into the y-row.
"""

from __future__ import annotations

from typing import Optional

import torch

SENTINEL = 2 ** 31 - 1

# rows per batched probe: bounds the gathered (rows, K) temporaries
_CHUNK_ELEMS = 1 << 24


def intersect_count_ref(a: torch.Tensor, b: torch.Tensor,
                        ia: Optional[torch.Tensor] = None,
                        ib: Optional[torch.Tensor] = None) -> torch.Tensor:
    e = a.shape[0] if ia is None else ia.shape[0]
    out = torch.zeros(e, dtype=torch.int32, device=a.device)
    ka, kb = a.shape[1], b.shape[1]
    if e == 0 or ka == 0 or kb == 0:
        return out
    rows = max(1, _CHUNK_ELEMS // max(ka, kb))
    for s in range(0, e, rows):
        ra = a[s:s + rows] if ia is None else a[ia[s:s + rows].long()]
        rb = b[s:s + rows] if ib is None else b[ib[s:s + rows].long()]
        pos = torch.searchsorted(rb, ra).clamp_(max=kb - 1)
        hit = (torch.gather(rb, 1, pos) == ra) & (ra != SENTINEL)
        out[s:s + rows] = hit.sum(dim=1, dtype=torch.int32)
    return out


def _tile(off: torch.Tensor, vals: torch.Tensor, pos: torch.Tensor,
          deg: torch.Tensor, k: int) -> torch.Tensor:
    """(len(pos), k) SENTINEL-padded int32 rows of CSR ``off``/``vals`` at
    key positions ``pos``, whose rows hold ``deg`` values."""
    out = torch.full((pos.numel(), k), SENTINEL, dtype=torch.int32,
                     device=vals.device)
    total = int(deg.sum())
    if total:
        rr = torch.repeat_interleave(
            torch.arange(pos.numel(), device=vals.device), deg,
            output_size=total)
        cc = torch.arange(total, device=vals.device) \
            - (torch.cumsum(deg, 0) - deg)[rr]
        out[rr, cc] = vals[off[pos][rr] + cc].to(torch.int32)
    return out


def intersect_rows_ref(off_a: torch.Tensor, vals_a: torch.Tensor,
                       pos_a: torch.Tensor, off_b: torch.Tensor,
                       vals_b: torch.Tensor, pos_b: torch.Tensor
                       ) -> torch.Tensor:
    """(n,) int32 counts |row_a(pos_a[i]) ∩ row_b(pos_b[i])| of two
    compact-CSR relations (``off_*`` int64 offsets, ``vals_*`` sorted
    rows, ``pos_*`` int64 key positions)."""
    n = pos_a.numel()
    out = torch.zeros(n, dtype=torch.int32, device=vals_a.device)
    if n == 0:
        return out
    deg_a = (off_a[1:] - off_a[:-1])[pos_a]
    deg_b = (off_b[1:] - off_b[:-1])[pos_b]
    width = int(torch.maximum(deg_a, deg_b).max())
    if width == 0:
        return out
    rows = max(1, _CHUNK_ELEMS // width)
    for s in range(0, n, rows):
        sl = slice(s, s + rows)
        ka = max(1, int(deg_a[sl].max()))
        kb = max(1, int(deg_b[sl].max()))
        a = _tile(off_a, vals_a, pos_a[sl], deg_a[sl], ka)
        b = _tile(off_b, vals_b, pos_b[sl], deg_b[sl], kb)
        out[sl] = intersect_count_ref(a, b)
    return out
