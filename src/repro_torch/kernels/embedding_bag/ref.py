"""Plain PyTorch versions of the EmbeddingBag kernels (gather + bag sum,
and its table gradient): the lane the wrappers run for CPU tensors, and
the oracles ``chip_smoke.py`` holds the CUDA kernels against on the card.

Inputs:
  table   (V, D)      embedding table
  idx     (B, L)      per-bag row indices (>= 0); any index >= V (the
                      reference's PAD == V) marks an empty slot
  weights (B, L) opt  per-slot weights
Output:
  (B, D) bag sums, accumulated in float32 (float64 for a float64 table)
  and returned in that type, so in float32 for a bfloat16 table (each row widened, then
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
    acc = torch.promote_types(table.dtype, torch.float32)
    safe = idx.clamp(max=v - 1).long()
    gathered = table[safe].to(acc)                       # (B, L, D)
    mask = (idx < v).to(acc)
    if weights is not None:
        mask = mask * weights.to(acc)
    return (gathered * mask[..., None]).sum(dim=1)


def embedding_bag_backward_ref(grad_out: torch.Tensor, idx: torch.Tensor,
                               v: int, dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """The table's gradient of ``embedding_bag_ref(table, idx)`` for a
    (v, D) table: ``grad_table[r] = Σ grad_out[b]`` over the slots (b, s)
    with ``idx[b, s] == r < v`` (a slot >= v is empty, as in the forward),
    summed in float32 (float64 for a float64 ``grad_out``) into zeros by
    ``index_add_``, returned in ``dtype``. On CPU tensors ``index_add_``
    adds in index order, so each row's sum runs in ascending (b, s) order
    from 0: the order of the backward kernel. A negative index raises."""
    acc = torch.promote_types(grad_out.dtype, torch.float32)
    b, ll = idx.shape
    d = grad_out.shape[1]
    flat = idx.reshape(-1).long()
    live = flat < v
    src = grad_out.to(acc).unsqueeze(1).expand(b, ll, d).reshape(-1, d)
    out = torch.zeros((v, d), dtype=acc, device=grad_out.device)
    out.index_add_(0, flat[live], src[live])
    return out.to(dtype)
