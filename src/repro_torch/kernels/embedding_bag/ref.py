"""Plain PyTorch version of the EmbeddingBag kernel (gather + bag sum):
the lane the wrapper runs for CPU tensors, and the oracle
``chip_smoke.py`` holds the CUDA kernel against on the card.

Inputs:
  table   (V, D)      embedding table
  idx     (B, L)      per-bag row indices (>= 0); any index >= V (the
                      reference's PAD == V) marks an empty slot
  weights (B, L) opt  per-slot weights
Output:
  (B, D) bag sums, accumulated in float32 and returned in the table's
  dtype, or in float32 for a bfloat16 table (each row widened, then
  added: the reference DLRM's ``vec.astype(float32)`` and bag sum, and
  what the kernels return).
"""

from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    v = table.shape[0]
    safe = idx.clamp(max=v - 1).long()
    gathered = table[safe].float()                       # (B, L, D)
    mask = (idx < v).float()
    if weights is not None:
        mask = mask * weights.float()
    out = (gathered * mask[..., None]).sum(dim=1)
    return out.to(torch.promote_types(table.dtype, torch.float32))
