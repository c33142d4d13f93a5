"""Plain PyTorch version of the dense triangle-count kernel: the lane the
wrapper runs for CPU tensors, and the oracle ``chip_smoke.py`` holds the
CUDA kernel against on the card.

count = Σ_{x,y} M[x,y] · (A Bᵀ)[x,y]: A (nx, d) = 0/1 rows of the x-slice,
B (ny, d) = 0/1 rows of the y-slice, M (nx, ny) = in-box edge indicator —
the number of (x, y, z) with (x, y), (x, z), (y, z) ∈ E (paper query Δ).

The product runs in float64, so the count is exact while every partial
sum stays below 2^53. TF32 never applies to float64 products; callers that
time a float32 product beside it set
``torch.backends.cuda.matmul.allow_tf32 = False`` themselves.
"""

from __future__ import annotations

import torch


def triangle_count_ref(a: torch.Tensor, b: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """0-d int64 Σ mask ⊙ (a · bᵀ)."""
    paths = a.to(torch.float64) @ b.to(torch.float64).T
    return (mask.to(torch.float64) * paths).sum().to(torch.int64)
