"""Mixture-of-Experts FFN (top-k routing, shared experts): the port of
``src/repro/models/moe.py``.

Three dispatch forms, as in the reference:
  * ``moe_ffn``: the dense einsum form (every expert sees every token,
    weighted; drop-free), which the smoke configs use;
  * ``moe_ffn_gathered``: GShard capacity per batch row, ranks within an
    expert from a cumsum over the (B, S·k, E) one-hot;
  * ``moe_ffn_sorted``: the same capacity semantics with ranks from a
    stable sort of the expert keys and ``searchsorted`` (O(T) memory).
    Its ranks, and so its drop set, are the gathered form's.

Routing: softmax-then-top-k with renormalization. ``jax.lax.top_k`` puts
the lower index first on a tie and ``torch.topk`` promises no order, so
the top k come from a stable descending sort. An auxiliary load-balance
loss (Switch-style) is returned beside the output.

The capacity forms combine each token's k expert outputs by adding them
into zeros in the activation dtype, rounding at every add, in the order
of the reference's scatter-add (``moe.py:116-121``, ``:189-194``): top-k
rank order for the gathered form, ascending expert id for the sorted
form (its updates come in sorted order). They are gathered per token and
added in that order, not with ``index_add_``, which adds with atomics on
the card; so a forward gives the same bits on every run, and so does a
backward: the dispatch reads x through an ``expand`` (its gradient a
fixed-order sum over each token's k routes), every other gather of the
gradient's path either reads each position once or adds only zeros.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from . import layers as L
from .layers import mm_as, mm_f32, swiglu


def moe_shapes(d_model: int, d_ff: int, n_experts: int,
               n_shared: int) -> Dict[str, Any]:
    s = {
        "router": ((d_model, n_experts), L.NDTYPE),
        "wi": ((n_experts, d_model, 2 * d_ff), L.PDTYPE),
        "wo": ((n_experts, d_ff, d_model), L.PDTYPE),
    }
    if n_shared:
        s["shared_wi"] = ((d_model, 2 * d_ff * n_shared), L.PDTYPE)
        s["shared_wo"] = ((d_ff * n_shared, d_model), L.PDTYPE)
    return s


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, the lower
    index first on a tie (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Dict[str, torch.Tensor], x: torch.Tensor, k: int):
    """(probs, top_w, top_i) of tokens x (..., D): float32 router logits,
    softmax, the top k renormalized to sum to 1."""
    logits = L.linear(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    return probs, top_w, top_i


def _expert_act(p, ge: torch.Tensor, dtype) -> torch.Tensor:
    """Each expert's gated activation of its rows, ge (E, N, D) -> (E, N,
    F) in ``dtype``; h and gate·up in float32."""
    gate, up = torch.chunk(mm_f32(ge, p["wi"]), 2, dim=-1)
    return (F.silu(gate) * up).to(dtype)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot of ``idx`` over n classes (``F.one_hot`` checks its
    range on the host, a wait for the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).int()


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, top_k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss): the dense einsum form."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, top_w, top_i = route(p, xt, top_k)                   # (T, E)
    n_e = probs.shape[-1]
    # dense combine weights: (T, E), zero outside the top-k
    combine = torch.zeros_like(probs).scatter_(-1, top_i, top_w)

    act = _expert_act(p, xt.expand(n_e, -1, -1), x.dtype)      # (E, T, F)
    eo = mm_f32(act, p["wo"])                                   # (E, T, D)
    out = torch.einsum("etd,te->td", eo, combine).to(x.dtype)

    if "shared_wi" in p:
        out = out + swiglu(xt, p["shared_wi"], p["shared_wo"])

    # Switch-style load-balance aux: E * Σ_e f_e · P_e
    f = torch.mean((combine > 0).float(), dim=0)   # fraction routed per expert
    pbar = torch.mean(probs, dim=0)
    aux = n_e * torch.sum(f * pbar)
    return out.reshape(b, s, d), aux.float()


def _capacity(s: int, top_k: int, n_e: int, capacity_factor: float) -> int:
    """C = cf·S·k/E slots an expert per batch row (``moe.py:87``)."""
    return max(1, int(capacity_factor * s * top_k / n_e))


def _ranks_cumsum(flat_e: torch.Tensor, n_e: int) -> torch.Tensor:
    """Each (B, S·k) entry's rank among the earlier entries of its row
    routed to the same expert, from the per-row cumsum of the one-hot."""
    onehot = _one_hot(flat_e, n_e)                              # (B, T, E)
    return torch.sum(torch.cumsum(onehot, dim=1) * onehot, dim=-1) - 1


def _ranks_sorted(flat_e: torch.Tensor) -> torch.Tensor:
    """The same ranks from a stable sort of each row's expert keys: rank =
    index in the sorted row − first index of its expert
    (``searchsorted``), scattered back to the entries' own places."""
    t = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=1, stable=True)           # (B, T)
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_s = torch.arange(t, device=flat_e.device)[None, :] - first
    return torch.empty_like(pos_s).scatter_(1, order, pos_s)


def _capacity_ffn(p, x, top_k: int, capacity_factor: float,
                  sorted_ranks: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered and sorted forms: capacity dispatch per batch row,
    ranks by ``_ranks_sorted`` or ``_ranks_cumsum``, and the combine in
    the form's order (module docstring)."""
    b, s, d = x.shape
    n_e = p["router"].shape[-1]
    cap = _capacity(s, top_k, n_e, capacity_factor)

    probs, top_w, top_i = route(p, x, top_k)                    # (B, S, ·)
    flat_e = top_i.reshape(b, s * top_k)                        # (B, S·k)
    flat_w = top_w.reshape(b, s * top_k)
    pos = _ranks_sorted(flat_e) if sorted_ranks \
        else _ranks_cumsum(flat_e, n_e)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, n_e * cap)     # (B, S·k)
    rows = torch.arange(b, device=x.device)[:, None]

    # dispatch: every slot is written once, but the drop row n_e·cap,
    # which is thrown away. Entry t·k + r is token t's r-th route, so the
    # routed rows are x repeated k times along S (the reference's
    # x[flat_t]); as an expand, their gradient is each token's k rows
    # summed in a fixed order, not an accumulating index-put
    ge = x.new_zeros((b, n_e * cap + 1, d))
    ge[rows, slot] = x[:, :, None, :].expand(b, s, top_k, d).reshape(
        b, s * top_k, d)
    ge = ge[:, :-1].reshape(b, n_e, cap, d)
    act = _expert_act(p, ge.transpose(0, 1).reshape(n_e, b * cap, d),
                      x.dtype)
    eo = mm_as(act, p["wo"], x.dtype)                           # (E, B·C, D)
    flat_out = eo.view(n_e, b, cap, d).transpose(0, 1).reshape(
        b, n_e * cap, d)

    # combine: each token's k contributions, added into zeros in the
    # reference's update order, rounded at every add. A dropped entry
    # reads the clamped last slot with weight 0, so in the gradient it
    # adds only zeros there, and the sum at that slot is its one kept
    # entry's (or zero) in any order
    w = torch.where(keep, flat_w, 0.0)[..., None].to(flat_out.dtype)
    contrib = (w * flat_out[rows, slot.clamp(max=n_e * cap - 1)]) \
        .view(b, s, top_k, d)
    if sorted_ranks:
        by_expert = torch.argsort(top_i, dim=-1)                # distinct ids
        contrib = torch.gather(contrib, 2, by_expert[..., None]
                               .expand(-1, -1, -1, d))
    out = torch.zeros((b, s, d), dtype=flat_out.dtype, device=x.device)
    for r in range(top_k):
        out = out + contrib[:, :, r]

    if "shared_wi" in p:
        out = out + swiglu(x.reshape(b * s, d), p["shared_wi"],
                           p["shared_wo"]).reshape(b, s, d)
    f = torch.mean(_one_hot(top_i, n_e).float(), dim=(0, 1, 2))
    aux = n_e * torch.sum(f * torch.mean(probs, dim=(0, 1)))
    return out, aux.float()


def moe_ffn_gathered(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     top_k: int, capacity_factor: float = 1.25
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped capacity dispatch: tokens are routed within
    each batch row, C = cf·S·k/E slots an expert, ranks from the row's
    cumsum; overflow tokens are dropped. Expert flops are
    O(B·S·k·cf·D·F), never O(T·E·F) like the dense form."""
    return _capacity_ffn(p, x, top_k, capacity_factor, sorted_ranks=False)


def moe_ffn_sorted(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   top_k: int, capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based grouped dispatch: the gathered form's capacity and drop
    set, with ranks from a stable sort and ``searchsorted`` instead of a
    (B, S·k, E) cumsum; its combine adds in ascending expert id."""
    return _capacity_ffn(p, x, top_k, capacity_factor, sorted_ranks=True)


__all__ = ["moe_ffn", "moe_ffn_gathered", "moe_ffn_sorted",
           "moe_shapes", "route", "top_k"]
