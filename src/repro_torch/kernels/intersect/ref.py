"""Plain PyTorch version of the intersect kernel (row-batched
``torch.searchsorted``): the lane the wrapper runs for CPU tensors, and
the oracle ``chip_smoke.py`` holds the CUDA kernel against on the card.

Inputs: ``a`` (Ra, Ka) and ``b`` (Rb, Kb) int32 matrices of sorted,
SENTINEL-padded rows (sets). Output: (E,) int32 per-row intersection sizes
|a[ia[i]] ∩ b[ib[i]]|, with ``ia = ib = arange(E)`` when no index is given.
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
