"""Dense-LM serving and training split over a named device grid
(``parallel.spmd``).

The reference's prefill, decode and train cells run under ``jax.jit``
with the params under ``lm_param_sharding`` (FSDP rows over ``dp``,
tensor parallelism over ``model``), the KV cache's sequence split over
``model`` (``lm_cache_sharding``), the batch over ``dp``
(``lm_batch_sharding``), the AdamW moments as the params
(``opt_state_sharding``) and the logits' vocabulary split over
``model``; XLA inserts the collectives. Here each place runs its part of
``models.transformer``'s step (``spmd.lockstep``), the activation
layouts the port's own and the arguments and outputs the reference's,
block for block:

* FSDP: a layer's weights are all-gathered over ``dp`` a layer at a time;
  in training the all-gather's backward reduce-scatters each weight's
  gradient to the place's own rows (FSDP's gradient reduce-scatter).
* The embedding's vocabulary is split over ``model``: each place looks
  its tokens up in its rows, the others' slots zero, and the rows are
  all-reduced over ``model`` (one nonzero each, so exact). The block's
  gradient is the ordered sum of the rows' gradients by token id on
  ``embedding_bag_backward`` (``_VocabRows``, as the whole model's
  ``gather_rows``), an id outside the block adding nothing. The logits
  come from the place's ``lm_head`` columns and stay vocabulary-split, as
  the out-sharding says; ``greedy`` takes the argmax over places, ties to
  the lowest index as ``torch.argmax``.
* Attention, prefill and training: heads split over ``model`` (Megatron
  column / row parallelism). Where a column block is not whole heads (a
  head count the axis does not divide), the columns are all-gathered to
  whole heads and the heads cut in ``spmd.even_sizes`` parts. In prefill
  ``wk`` / ``wv`` are all-gathered over ``model`` (each place needs its
  query heads' key heads, which a quarter or half of a head per block
  does not give), and each place projects its own sequence block of the
  cache with them, as the whole prefill's projection pass does: the
  cache comes out in its out-sharding without moving activations.
* Attention, decode: the cache is split by sequence, so the new token's
  q / k / v are the place's column blocks all-gathered over ``model``
  (activations, whole heads whatever the blocks), the new K/V are written
  on the place that owns ``pos``, each place attends its sequence block
  for every head, and the blocks' (max, sum, output) are all-gathered and
  combined in grid order (flash-decoding; the reference's ``attn_s``
  rule).
* ``wo`` row-parallel: each place's partial output in float32,
  all-reduced over ``model``, rounded once.
* SwiGLU: ``wi`` is one (d, 2f) weight, gate columns then up columns, so
  a contiguous column block over ``model`` does not hold a gate/up pair.
  Each place fetches the gate and up columns of its own f-range (the rows
  of ``ffn/wo`` it holds) from the places that hold them (a
  collective-permute, whose gradient goes back the same way), and its
  ``wo`` rows match that range.
* The loss (training): the logits stay vocabulary-split; each token's
  log-sum-exp combines the blocks' (max, sum of exp), all-gathered over
  ``model``, in grid order, and its gold logit comes from the block that
  holds the target, all-reduced over ``model``; the NLL's sum and its
  token count are all-reduced over the batch axes. The loss's gradient is
  taken at place 0, so the duals of the all-reduces hand every place its
  share. A block replicated along axes its spec leaves out (the norms
  everywhere, ``bq`` / ``bk`` / ``bv`` over ``dp``) has its gradient
  all-reduced over those axes, in grid order. The clip's norm is the sum
  of squares of each distinct block, counted once, all-reduced in grid
  order; ``adamw.apply`` updates each distinct block once (places on one
  device share a replicated block), in place.
* remat: a repeated layer runs on every place in lockstep as one function
  of all places' inputs (``spmd.lockstep_fn``), wrapped by
  ``transformer._remat``: ``"layer"`` recomputes the whole grid layer in
  the backward, its collectives included (the ledger counts them again),
  ``"dots"`` keeps its GEMMs' outputs, ``"none"`` keeps everything. The
  three give the same bits.

A dimension the rules leave whole is cut inside the step where the work
is summed (heads, f, the decode's sequence) so it is counted once; the
batch, where ``dp`` does not divide it, is computed on every place of a
``model`` row in serving, and cut in ``spmd.even_sizes`` parts over
``dp`` in training, so each token's loss is counted once. MLA, MoE and
tied embeddings are not run on a grid (``ValueError``, ROADMAP §1 item
3). On an abstract grid (one ``meta`` place) the same steps reckon the
cells' collectives without data.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.embedding_bag import grad as bag_grad
from repro_torch.optim import adamw
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import dp_axes
from repro_torch.pytree import leaves, tree_map

from . import layers as L
from . import transformer as TF


def check_config(cfg: TF.TransformerConfig) -> None:
    """Raise ``ValueError`` for a config this module does not run."""
    moe = any(s.ffn == "moe" for s in cfg.prefix + cfg.pattern)
    if cfg.mla or moe or cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: MLA, MoE and tied embeddings are not "
                         f"run on a grid (ROADMAP §1 item 3)")


def _is_dp(entry) -> bool:
    return entry is not None and entry != "model"


def _entry(spec, i: int):
    return spec[i] if i < len(spec) else None


class _Place:
    """One place's view of the grid: its coordinates and its params'
    blocks and specs by layer."""

    def __init__(self, cfg, grid, params, p: int, blocks=None):
        self.cfg = cfg
        self.dp = dp_axes(grid)
        self.m = spmd.axis_size(grid, "model")
        self.j = spmd.coord(grid, p, "model")
        self.blocks = spmd.blocks_at(params, p) if blocks is None else blocks
        self.specs = tree_map(lambda s: tuple(s.spec), params,
                              is_leaf=lambda x: isinstance(x, spmd.Sharded))

    def layers(self, cache=None):
        """(LayerSpec, weights, specs[, cache]) of each layer in order;
        a stacked leaf's spec without its layer entry."""
        cfg = self.cfg
        trees = [self.blocks, self.specs] + ([cache] if cache is not None
                                             else [])
        for i, spec in enumerate(cfg.prefix):
            yield (spec, *(t[f"prefix{i}"] for t in trees))
        stacked = [TF._unstack(self.blocks[f"block{i}"], cfg.n_repeats)
                   for i in range(len(cfg.pattern))]
        caches = [TF._unstack(cache[f"block{i}"], cfg.n_repeats)
                  for i in range(len(cfg.pattern))] if cache is not None \
            else None
        for r in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.pattern):
                specs = tree_map(lambda s: s[1:], self.specs[f"block{i}"],
                                 is_leaf=lambda x: isinstance(x, tuple))
                out = (spec, stacked[i][r], specs)
                yield out + ((caches[i][r],) if caches is not None else ())

    def dp_full(self, w, spec, dim: int):
        """``w`` with its ``dp``-split dimension ``dim`` all-gathered (a
        generator)."""
        if _is_dp(_entry(spec, dim)):
            w = yield spmd.AllGather(w, self.dp, dim)
        return w

    def model_full(self, w, spec, dim: int):
        if _entry(spec, dim) == "model":
            w = yield spmd.AllGather(w, "model", dim)
        return w

    def heads(self, n: int) -> Tuple[int, int]:
        """The place's share of ``n`` heads (or FFN columns)."""
        if n % self.m == 0:
            return self.j * n // self.m, (self.j + 1) * n // self.m
        return spmd.part_range(n, self.m, self.j)


class _VocabRows(torch.autograd.Function):
    """The rows of a vocabulary block ``[lo, lo + n)`` for token ids, zero
    rows for ids outside it; the block's gradient is the ordered float32
    sum of the rows' gradients by id (``bag_grad.segment_rows``:
    ``embedding_bag_backward`` with L = 1 on the card), rounded once to the
    table's dtype, an id outside the block adding nothing (the sum skips
    ids >= n)."""

    @staticmethod
    def forward(ctx, table, ids, lo: int):
        n = table.shape[0]
        local = ids - lo
        ok = (local >= 0) & (local < n)
        ctx.save_for_backward(torch.where(ok, local, n))
        ctx.n, ctx.dtype = n, table.dtype
        rows = table.index_select(0, local.clamp(0, n - 1))
        return torch.where(ok[:, None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, grad):
        seg, = ctx.saved_tensors
        if grad.is_meta:
            out = torch.zeros((ctx.n, grad.shape[1]), dtype=ctx.dtype,
                              device="meta")
        else:
            out = bag_grad.segment_rows(grad.float(), seg, ctx.n,
                                        dtype=ctx.dtype)
        return out, None, None


def _embed(pl: _Place, tokens: torch.Tensor):
    table = yield from pl.dp_full(pl.blocks["embed"], pl.specs["embed"], 1)
    flat = tokens.reshape(-1).long()
    if _entry(pl.specs["embed"], 0) == "model":
        rows = _VocabRows.apply(table, flat, pl.j * table.shape[0])
        rows = yield spmd.AllReduce(rows, "model")
    elif table.is_meta:
        rows = table.index_select(0, flat)
    else:
        rows = bag_grad.gather_rows(table, flat)
    return rows.view(*tokens.shape, -1).to(L.ADTYPE)


def _logits(pl: _Place, x: torch.Tensor):
    """The place's vocabulary block of the logits of ``x`` (B, d)."""
    x = L.rms_norm(x, pl.blocks["final_norm"])
    head = yield from pl.dp_full(pl.blocks["lm_head"], pl.specs["lm_head"],
                                 0)
    return L.linear(x, head, torch.float32)


def _row_parallel(pl: _Place, a: torch.Tensor, wo, spec, rows, dtype):
    """``a @ wo`` for the place's rows ``rows`` of a row-parallel ``wo``:
    the float32 partial all-reduced over ``model``, rounded once."""
    wo = yield from pl.dp_full(wo, spec, 1)
    if _entry(spec, 0) == "model":
        blk = wo.shape[0]
        if (rows[0], rows[1]) != (pl.j * blk, (pl.j + 1) * blk):
            wo = yield spmd.AllGather(wo, "model", 0)
            wo = wo[rows[0]:rows[1]]
    else:
        wo = wo[rows[0]:rows[1]]
    part = L.linear(a, wo, torch.float32)
    out = yield spmd.AllReduce(part, "model")
    return out.to(dtype)


def _ffn(pl: _Place, p, specs, h: torch.Tensor):
    """SwiGLU on the place's f-range (module docstring)."""
    b, s, d = h.shape
    f = pl.cfg.d_ff
    lo, hi = pl.heads(f)
    wi = yield from pl.dp_full(p["wi"], specs["wi"], 0)
    if _entry(specs["wi"], 1) == "model":
        wi = yield spmd.Fetch(wi, "model", 1, wi.shape[1],
                              [(lo, hi), (f + lo, f + hi)])
    else:
        wi = torch.cat([wi[:, lo:hi], wi[:, f + lo:f + hi]], dim=1)
    hh = L.linear(h.reshape(b * s, d), wi, torch.float32)
    gate, up = torch.chunk(hh, 2, dim=-1)
    act = (torch.nn.functional.silu(gate) * up).to(h.dtype)
    out = yield from _row_parallel(pl, act, p["wo"], specs["wo"], (lo, hi),
                                   h.dtype)
    return out.reshape(b, s, d)


def _column(pl: _Place, h, p, specs, name: str, cols: Tuple[int, int]):
    """``h @ w[:, cols] (+ b[cols])`` for a column-parallel ``w``: the
    place's block where ``cols`` is it, else the columns all-gathered
    over ``model`` and cut."""
    w = yield from pl.dp_full(p[name], specs[name], 0)
    bias = p.get("b" + name[1:])
    blk = w.shape[1]
    local = _entry(specs[name], 1) == "model" and \
        cols == (pl.j * blk, (pl.j + 1) * blk)
    if not local:
        w = yield from pl.model_full(w, specs[name], 1)
        w = w[:, cols[0]:cols[1]]
        if bias is not None:
            bias = yield from pl.model_full(bias, specs["b" + name[1:]], 0)
            bias = bias[cols[0]:cols[1]]
    y = L.linear(h, w)
    return y if bias is None else y + bias.to(h.dtype)


def _prefill_attention(pl: _Place, spec, p, specs, h, positions):
    cfg = pl.cfg
    b, s, _ = h.shape
    dh, n_kv = cfg.d_head, cfg.n_kv_heads
    g = cfg.n_heads // n_kv
    h0, h1 = pl.heads(cfg.n_heads)
    kv0, kv1 = h0 // g, (h1 - 1) // g + 1
    q = yield from _column(pl, h, p, specs, "wq", (h0 * dh, h1 * dh))
    k = yield from _column(pl, h, p, specs, "wk", (kv0 * dh, kv1 * dh))
    v = yield from _column(pl, h, p, specs, "wv", (kv0 * dh, kv1 * dh))
    q = q.reshape(b, s, h1 - h0, dh)
    k = k.reshape(b, s, kv1 - kv0, dh)
    v = v.reshape(b, s, kv1 - kv0, dh)
    if spec.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    n_kv_here = kv1 - kv0
    if h0 % g or (h1 - h0) % g:
        # a head group cut between places: one key head per query head
        at = torch.tensor([hh // g - kv0 for hh in range(h0, h1)],
                          device=k.device)
        k, v = k.index_select(2, at), v.index_select(2, at)
        n_kv_here = h1 - h0
    mask = L._causal_mask(s, s, 0, spec.chunk, h.device)
    out = L._sdpa(q, k, v, h1 - h0, n_kv_here, mask, q_chunk=cfg.attn_q_chunk)
    return (yield from _row_parallel(
        pl, out.reshape(b, s, (h1 - h0) * dh), p["wo"], specs["wo"],
        (h0 * dh, h1 * dh), h.dtype))


def _layer(pl: _Place, spec, w, specs, x, positions):
    """One layer on the place's heads and f-range (a generator): the
    residual stream after attention and SwiGLU, whole on every place of
    a ``model`` row."""
    hn = L.rms_norm(x, w["norm1"])
    x = x + (yield from _prefill_attention(pl, spec, w["attn"],
                                           specs["attn"], hn, positions))
    hn = L.rms_norm(x, w["norm2"])
    return x + (yield from _ffn(pl, w["ffn"], specs["ffn"], hn))


def _project_block(pl: _Place, spec, p, specs, x, lo: int, hi: int):
    """The cache's K/V of positions [lo, hi) of the layer input ``x``,
    every key head (the whole prefill's projection pass)."""
    cfg = pl.cfg
    b = x.shape[0]
    hn = L.rms_norm(x[:, lo:hi], p["norm1"])
    cols = (0, cfg.n_kv_heads * cfg.d_head)
    k = yield from _column(pl, hn, p["attn"], specs["attn"], "wk", cols)
    v = yield from _column(pl, hn, p["attn"], specs["attn"], "wv", cols)
    k = k.reshape(b, hi - lo, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, hi - lo, cfg.n_kv_heads, cfg.d_head)
    if spec.use_rope:
        pos = TF._positions(b, hi - lo, x.device, lo)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    return k, v


def _seq_range(pl: _Place, cache_spec, s: int) -> Tuple[int, int]:
    """The positions of the place's cache block (S split over ``model``),
    or of its part of a whole cache's sequence."""
    if _entry(cache_spec, 1) == "model":
        blk = s // pl.m
        return pl.j * blk, (pl.j + 1) * blk
    return spmd.part_range(s, pl.m, pl.j)


def _prefill_place(cfg, grid, params, tokens, cache_specs, max_len: int,
                   p: int):
    pl = _Place(cfg, grid, params, p)
    x = yield from _embed(pl, tokens)
    b, s, _ = x.shape
    positions = TF._positions(b, s, x.device)
    cache: Dict[str, Any] = {}
    per_layer: List[Dict[str, torch.Tensor]] = []
    leaf_spec = cache_specs["block0"]["k"][1:] if "block0" in cache_specs \
        else cache_specs["prefix0"]["k"]
    split = _entry(leaf_spec, 1) == "model"
    lo, hi = _seq_range(pl, leaf_spec, max_len)
    for spec, w, specs in pl.layers():
        # the block's positions past the prompt stay zero
        k, v = yield from _project_block(pl, spec, w, specs, x, min(lo, s),
                                         min(hi, s))
        if hi - lo > k.shape[1]:
            pad = (0, 0, 0, 0, 0, hi - lo - k.shape[1])
            k, v = (torch.nn.functional.pad(t, pad) for t in (k, v))
        if not split:          # a whole cache: every position on every place
            kk = yield spmd.AllGather(k, "model", 1,
                                      spmd.even_sizes(max_len, pl.m))
            vv = yield spmd.AllGather(v, "model", 1,
                                      spmd.even_sizes(max_len, pl.m))
            k, v = kk, vv
        per_layer.append({"k": k, "v": v})
        x = yield from _layer(pl, spec, w, specs, x, positions)
    at = 0
    for i in range(len(cfg.prefix)):
        cache[f"prefix{i}"] = per_layer[at]
        at += 1
    body = per_layer[at:]
    for i in range(len(cfg.pattern)):
        mine = body[i::len(cfg.pattern)]
        cache[f"block{i}"] = {key: torch.stack([c[key] for c in mine])
                              for key in ("k", "v")}
    logits = yield from _logits(pl, x[:, -1, :])
    return cache, logits


def prefill(cfg: TF.TransformerConfig, params, tokens: spmd.Sharded,
            cache_shardings, max_len: Optional[int] = None) -> list:
    """The prefill cell on a grid: one (cache blocks, logits block) a
    place, the cache of ``max_len`` positions (default the prompt's; the
    first S filled, the rest zero, as ``transformer.prefill``) in
    ``cache_shardings`` (the cell's out-sharding) and the last position's
    logits vocabulary-split."""
    check_config(cfg)
    grid = tokens.grid
    specs = tree_map(lambda ns: tuple(ns.spec), cache_shardings,
                     is_leaf=lambda x: hasattr(x, "spec"))
    max_len = max_len or tokens.shape[1]
    with torch.no_grad():
        return spmd.lockstep(grid, [
            _prefill_place(cfg, grid, params, tokens.blocks[p], specs,
                           max_len, p)
            for p in range(len(spmd.places(grid)))])


def _decode_attention(pl: _Place, spec, p, specs, h, positions, cache,
                      cache_spec, pos: int, s: int):
    cfg = pl.cfg
    b = h.shape[0]
    dh, n_kv, n_h = cfg.d_head, cfg.n_kv_heads, cfg.n_heads
    g = n_h // n_kv

    def proj(name):
        y = yield from _column(pl, h, p, specs, name, _block_cols(pl, specs,
                                                                  name, p))
        if _entry(specs[name], 1) == "model":
            y = yield spmd.AllGather(y, "model", -1)
        return y
    q = (yield from proj("wq")).reshape(b, 1, n_h, dh)
    k = (yield from proj("wk")).reshape(b, 1, n_kv, dh)
    v = (yield from proj("wv")).reshape(b, 1, n_kv, dh)
    if spec.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    lo, hi = _seq_range(pl, cache_spec, s)
    if _entry(cache_spec, 1) == "model":
        if lo <= pos < hi:
            L._write_cache(ck, k, pos - lo)
            L._write_cache(cv, v, pos - lo)
        keys, vals = ck, cv
    else:
        L._write_cache(ck, k, pos)
        L._write_cache(cv, v, pos)
        keys, vals = ck[:, lo:hi], cv[:, lo:hi]
    sb = keys.shape[1]
    qm = q.reshape(b * n_kv, g, dh)
    km = keys.permute(0, 2, 3, 1).reshape(b * n_kv, dh, sb)
    lg = L.mm_f32(qm, km).view(b, n_kv, g, sb) / math.sqrt(dh)
    kpos = lo + torch.arange(sb, device=h.device)
    ok = kpos <= pos
    if spec.chunk is not None:
        ok = ok & (kpos // spec.chunk == pos // spec.chunk)
    lg = lg.masked_fill(~ok, L.NEG)
    mx = lg.amax(-1, keepdim=True)
    e = torch.exp(lg - mx)
    vm = vals.permute(0, 2, 1, 3).reshape(b * n_kv, sb, dh)
    o = L.mm_f32(e.to(q.dtype).view(b * n_kv, g, sb), vm).view(
        b, n_kv, g, dh)
    part = torch.cat([o, mx, e.sum(-1, keepdim=True)], dim=-1)
    parts = yield spmd.AllGather(part[None], "model", 0)
    top = parts[..., dh].amax(0)
    num = den = None
    for i in range(parts.shape[0]):          # grid order
        w = torch.exp(parts[i, ..., dh] - top)
        t_num = parts[i, ..., :dh] * w[..., None]
        t_den = parts[i, ..., dh + 1] * w
        num = t_num if num is None else num + t_num
        den = t_den if den is None else den + t_den
    out = (num / den[..., None]).to(h.dtype).reshape(b, 1, n_h * dh)
    rows = pl.heads(n_h * dh)
    return (yield from _row_parallel(pl, out[..., rows[0]:rows[1]], p["wo"],
                                     specs["wo"], rows, h.dtype))


def _block_cols(pl: _Place, specs, name: str, p) -> Tuple[int, int]:
    """The columns of ``name``'s block on the place (all where whole)."""
    w = p[name]
    if _entry(specs[name], 1) == "model":
        return pl.j * w.shape[1], (pl.j + 1) * w.shape[1]
    return 0, w.shape[1]


def _decode_place(cfg, grid, params, cache, cache_specs, token, pos: int,
                  s: int, p: int):
    pl = _Place(cfg, grid, params, p)
    x = yield from _embed(pl, token)
    positions = TF._positions(x.shape[0], 1, x.device, pos)
    leaf = cache_specs["block0"]["k"][1:] if "block0" in cache_specs \
        else cache_specs["prefix0"]["k"]
    for spec, w, specs, c in pl.layers(cache):
        hn = L.rms_norm(x, w["norm1"])
        x = x + (yield from _decode_attention(pl, spec, w["attn"],
                                              specs["attn"], hn, positions,
                                              c, leaf, pos, s))
        hn = L.rms_norm(x, w["norm2"])
        x = x + (yield from _ffn(pl, w["ffn"], specs["ffn"], hn))
    logits = yield from _logits(pl, x[:, -1, :])
    return logits, cache


def decode_step(cfg: TF.TransformerConfig, params, cache, token: spmd.Sharded,
                pos: spmd.Sharded) -> list:
    """The decode cell on a grid: one (logits block, cache blocks) a
    place; the new token's K/V written into the cache blocks in place, on
    the place that owns ``pos``."""
    check_config(cfg)
    grid = token.grid
    first = pos.blocks[0]
    leaf = cache["block0"]["k"] if "block0" in cache else \
        cache["prefix0"]["k"]
    s = leaf.shape[2] if "block0" in cache else leaf.shape[1]
    at = s - 1 if first.is_meta else int(first)
    specs = tree_map(lambda x: tuple(x.spec), cache,
                     is_leaf=lambda x: isinstance(x, spmd.Sharded))
    with torch.no_grad():
        return spmd.lockstep(grid, [
            _decode_place(cfg, grid, params, spmd.blocks_at(cache, p), specs,
                          token.blocks[p], at, s, p)
            for p in range(len(spmd.places(grid)))])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch_rows(s: spmd.Sharded, p: int, dp) -> torch.Tensor:
    """Place ``p``'s rows of a batch array: its block, or where ``dp``
    does not split the batch its ``spmd.even_sizes`` part of it."""
    blk = s.blocks[p]
    k = spmd.axis_size(s.grid, dp)
    if _entry(s.spec, 0) is not None or k == 1:
        return blk
    lo, hi = spmd.part_range(blk.shape[0], k, spmd.coord(s.grid, p, dp))
    return blk[lo:hi]


def _nll_place(pl: _Place, x: torch.Tensor, targets: torch.Tensor):
    """The mean next-token NLL over the grid (a generator; module
    docstring): the same value on every place."""
    lg = yield from _logits(pl, x)
    v_blk = lg.shape[-1]
    lg = lg.reshape(-1, v_blk)
    tgt = targets.reshape(-1).long()
    if _entry(pl.specs["lm_head"], 1) == "model":
        # log-sum-exp over the blocks: m and the combined maximum are
        # constants of the function, so they carry no gradient
        mx = lg.detach().amax(-1)
        se = torch.exp(lg - mx[:, None]).sum(-1)
        parts = yield spmd.AllGather(torch.stack([mx, se])[None], "model", 0)
        top = parts[:, 0].detach().amax(0)
        tot = None
        for i in range(parts.shape[0]):           # grid order
            t = parts[i, 1] * torch.exp(parts[i, 0] - top)
            tot = t if tot is None else tot + t
        lse = top + torch.log(tot)
        local = tgt - pl.j * v_blk
        ok = (local >= 0) & (local < v_blk)
        gold = torch.gather(lg, 1, local.clamp(0, v_blk - 1)[:, None])[:, 0]
        gold = yield spmd.AllReduce(
            torch.where(ok, gold, torch.zeros_like(gold)), "model")
    else:
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, 1, tgt[:, None])[:, 0]
    part = torch.stack([torch.sum(lse - gold),
                        lse.new_full((), float(tgt.numel()))])
    tot = yield spmd.AllReduce(part, pl.dp)
    return tot[0] / tot[1]


def _spec_axes(spec) -> set:
    return {a for entry in spec for a in spmd.axes_of(entry)}


def _is_sharded(x) -> bool:
    return isinstance(x, spmd.Sharded)


def loss_and_grad(cfg: TF.TransformerConfig, params, batch):
    """The loss and its gradient on a grid (module docstring): ``params``
    a tree of ``spmd.Sharded`` under ``lm_param_sharding``, ``batch``
    ``{"tokens", "targets"}`` under ``lm_batch_sharding``. Returns (one
    0-d loss a place, the gradient as a tree of ``spmd.Sharded`` in the
    params' shardings, one clip norm a place); every place's loss and norm
    have the same bits. Nothing is updated."""
    check_config(cfg)
    grid = batch["tokens"].grid
    n = len(spmd.places(grid))
    dp = dp_axes(grid)
    live = [tree_map(lambda t: t.detach().requires_grad_(),
                     spmd.blocks_at(params, p)) for p in range(n)]
    pls = [_Place(cfg, grid, params, p, blocks=live[p]) for p in range(n)]
    tokens = [_batch_rows(batch["tokens"], p, dp) for p in range(n)]
    targets = [_batch_rows(batch["targets"], p, dp) for p in range(n)]
    xs = spmd.lockstep(grid, [_embed(pl, t) for pl, t in zip(pls, tokens)])
    positions = [TF._positions(x.shape[0], x.shape[1], x.device) for x in xs]
    walks = [pl.layers() for pl in pls]
    for i in range(cfg.n_layers):
        here = [next(w) for w in walks]

        def make(p, x, here=here):
            spec, w, specs = here[p]
            return _layer(pls[p], spec, w, specs, x, positions[p])
        run = spmd.lockstep_fn(grid, make)
        if i >= len(cfg.prefix):                  # the repeated blocks
            run = TF._remat(cfg, run)
        xs = list(run(*xs))
    losses = spmd.lockstep(grid, [_nll_place(pl, x, t) for pl, x, t in
                                  zip(pls, xs, targets)])
    flat = [leaves(t) for t in live]
    k = len(flat[0])
    got = torch.autograd.grad(losses[0], [x for f in flat for x in f],
                              allow_unused=True)
    grads = [[torch.zeros_like(x) if g is None else g
              for x, g in zip(flat[p], got[p * k:(p + 1) * k])]
             for p in range(n)]
    sharded = leaves(params, is_leaf=_is_sharded)
    with torch.no_grad():
        ss = [torch.zeros((), dtype=torch.float32, device=x.device)
              for x in xs]
        for j, sh in enumerate(sharded):
            missing = tuple(a for a in grid.axis_names
                            if a not in _spec_axes(sh.spec))
            if spmd.axis_size(grid, missing) > 1:
                summed = spmd.all_reduce([g[j] for g in grads], grid,
                                         missing)
                for p in range(n):
                    grads[p][j] = summed[p]
            seen = set()
            for p in range(n):                    # each block counted once
                key = tuple((b.start, b.stop) for b in spmd.block_slices(
                    sh.sharding, sh.shape, p))
                if key not in seen:
                    seen.add(key)
                    ss[p] = ss[p] + adamw.sum_squares(grads[p][j])
        norms = [torch.sqrt(t) for t in
                 spmd.all_reduce(ss, grid, grid.axis_names)]
    trees = []
    for p in range(n):
        at = {id(t): g for t, g in zip(flat[p], grads[p])}
        trees.append(tree_map(lambda t: at[id(t)], live[p]))
    shardings = tree_map(lambda sh: sh.sharding, params, is_leaf=_is_sharded)
    return ([x.detach() for x in losses], spmd.assemble(trees, shardings),
            norms)


def train_step(cfg: TF.TransformerConfig, opt_cfg: adamw.AdamWConfig, params,
               opt_state: adamw.OptState, batch):
    """The train cell on a grid (module docstring), under
    ``layers.float32_accumulation``: ``params`` and ``opt_state`` trees of
    ``spmd.Sharded`` in the cell's in-shardings, updated in place (the
    cell donates them). Returns one (params, opt_state, metrics) of blocks
    a place, the metrics the reference's: ``loss``, ``nll``, ``aux``,
    ``grad_norm``, ``lr``."""
    with L.float32_accumulation():
        losses, grads, norms = loss_and_grad(cfg, params, batch)
        grid = batch["tokens"].grid
        devs = spmd.places(grid)
        trees = [leaves(t, is_leaf=_is_sharded)
                 for t in (params, grads, opt_state.m, opt_state.v)]
        # each distinct block once, on its device: places of one device
        # share a replicated block
        by_dev: Dict[str, Any] = {}
        seen = set()
        for p, dev in enumerate(devs):
            _, ps, gs, ms, vs = by_dev.setdefault(str(dev),
                                                  (p, [], [], [], []))
            for j, sh in enumerate(trees[0]):
                t = sh.blocks[p]
                key = (p, j) if t.is_meta else (
                    str(dev), t.data_ptr(), tuple(t.shape), t.stride())
                if key in seen:
                    continue
                seen.add(key)
                for out, tree in zip((ps, gs, ms, vs), trees):
                    out.append(tree[j].blocks[p])
        lr = {}
        for dev, (p0, ps, gs, ms, vs) in by_dev.items():
            state = adamw.OptState(opt_state.step.blocks[p0], ms, vs)
            _, _, om = adamw.apply(opt_cfg, ps, gs, state, norm=norms[p0])
            lr[dev] = om["lr"]
    out = []
    for p, dev in enumerate(devs):
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {"loss": losses[p] + 0.01 * aux, "nll": losses[p],
                   "aux": aux, "grad_norm": norms[p], "lr": lr[str(dev)]}
        out.append((spmd.blocks_at(params, p), spmd.blocks_at(opt_state, p),
                    metrics))
    return out


def _greedy_place(logits: torch.Tensor, grid, p: int):
    val, idx = logits.max(-1, keepdim=True)
    idx = idx + spmd.coord(grid, p, "model") * logits.shape[-1]
    vals = yield spmd.AllGather(val, "model", 1)
    idxs = yield spmd.AllGather(idx, "model", 1)
    return torch.gather(idxs, 1, vals.argmax(-1, keepdim=True))


def greedy(logits: spmd.Sharded) -> list:
    """The greedy next token of vocabulary-split logits: (B_place, 1) ids
    a place, the first place's on a tie, so the lowest index as
    ``torch.argmax``."""
    grid = logits.grid
    with torch.no_grad():
        return spmd.lockstep(grid, [_greedy_place(b, grid, p)
                                    for p, b in enumerate(logits.blocks)])


__all__ = ["check_config", "decode_step", "greedy", "loss_and_grad",
           "prefill", "train_step"]
