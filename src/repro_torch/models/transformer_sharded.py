"""Dense-LM serving split over a named device grid (``parallel.spmd``).

The reference's prefill and decode cells run under ``jax.jit`` with the
params under ``lm_param_sharding`` (FSDP rows over ``dp``, tensor
parallelism over ``model``), the KV cache's sequence split over ``model``
(``lm_cache_sharding``) and the logits' vocabulary split over ``model``;
XLA inserts the collectives. Here each place runs its part of
``models.transformer``'s prefill or decode step (``spmd.lockstep``), the
activation layouts the port's own and the arguments and outputs the
reference's, block for block:

* FSDP: a layer's weights are all-gathered over ``dp`` a layer at a time.
* The embedding's vocabulary is split over ``model``: each place looks
  its tokens up in its rows, the others' slots zero, and the rows are
  all-reduced over ``model`` (one nonzero each, so exact). The logits
  come from the place's ``lm_head`` columns and stay vocabulary-split, as
  the out-sharding says; ``greedy`` takes the argmax over places, ties to
  the lowest index as ``torch.argmax``.
* Attention, prefill: heads split over ``model`` (Megatron column /
  row parallelism). Where a column block is not whole heads (a head count
  the axis does not divide), the columns are all-gathered to whole heads
  and the heads cut in ``spmd.even_sizes`` parts. ``wk`` / ``wv`` are
  all-gathered over ``model`` (each place needs its query heads' key
  heads, which a quarter or half of a head per block does not give), and
  each place projects its own sequence block of the cache with them, as
  the whole prefill's projection pass does: the cache comes out in its
  out-sharding without moving activations.
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
  collective-permute), and its ``wo`` rows match that range.

A dimension the rules leave whole is cut inside the step where the work
is summed (heads, f, the decode's sequence) so it is counted once; the
batch, where ``dp`` does not divide it, is computed on every place of a
``model`` row. MLA, MoE and tied embeddings are not run on a grid
(``ValueError``, ROADMAP §1 item 3).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import dp_axes
from repro_torch.pytree import tree_map

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

    def __init__(self, cfg, grid, params, p: int):
        self.cfg = cfg
        self.dp = dp_axes(grid)
        self.m = spmd.axis_size(grid, "model")
        self.j = spmd.coord(grid, p, "model")
        self.blocks = spmd.blocks_at(params, p)
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


def _embed(pl: _Place, tokens: torch.Tensor):
    table = yield from pl.dp_full(pl.blocks["embed"], pl.specs["embed"], 1)
    flat = tokens.reshape(-1).long()
    if _entry(pl.specs["embed"], 0) == "model":
        blk = table.shape[0]
        local = flat - pl.j * blk
        ok = (local >= 0) & (local < blk)
        rows = table.index_select(0, local.clamp(0, blk - 1))
        rows = torch.where(ok[:, None], rows, torch.zeros_like(rows))
        rows = yield spmd.AllReduce(rows, "model")
    else:
        rows = table.index_select(0, flat)
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
        hn = L.rms_norm(x, w["norm1"])
        x = x + (yield from _prefill_attention(pl, spec, w["attn"],
                                               specs["attn"], hn, positions))
        hn = L.rms_norm(x, w["norm2"])
        x = x + (yield from _ffn(pl, w["ffn"], specs["ffn"], hn))
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


__all__ = ["check_config", "decode_step", "greedy", "prefill"]
