"""LM transformer family: dense GQA, MLA and MoE variants; the port of
``src/repro/models/transformer.py``.

Structure is pattern-based: an optional ``prefix`` of layers (DeepSeek's
dense first layer), then ``pattern`` repeated ``n_repeats`` times
(Llama-4's interleaved MoE / chunked-local / NoPE layers), each pattern
position's params stacked along a leading axis (``block{i}``). The
reference scans over that axis with ``lax.scan``; the port walks it in a
Python loop over one ``unbind(0)`` of each stacked tensor a call (so a
layer's gradient is one slice of one ``stack``, not a zeroed copy of the
whole stack a layer). The reference's ``constrain`` calls (the identity
off a mesh) are left out, and so is its ``scan_unroll`` field, which
tunes the scan.

``remat`` is the reference's (``transformer.py:207-211``), on the
repeated blocks only, never the prefix, and only where autograd records
the forward: ``"layer"`` keeps each layer's input and recomputes the
layer in the backward (``torch.utils.checkpoint``, non-reentrant),
``"dots"`` keeps the outputs of the layer's GEMMs (``aten.mm`` /
``aten.bmm``) and recomputes the rest (selective checkpointing),
``"none"`` keeps everything. The three give the same bits.

The token embedding's gradient is the ordered float32 sum of the
embedded rows' gradients by token id (``bag_grad.gather_rows``: the
sorted-sum kernel ``embedding_bag_backward`` with L = 1 on the card),
rounded once to the table's dtype, never an unordered scatter.

API (functional, params a nested dict of tensors):
  param_shapes(cfg) / init_params(cfg, generator, device) / param_specs(cfg)
  forward(cfg, params, tokens)                  -> (logits, aux)
  loss_fn(cfg, params, batch)                   -> (loss, metrics)
  train_step(cfg, opt_cfg, params, opt_state, batch)
                                                -> (params, opt_state, metrics)
  prefill(cfg, params, tokens, max_len)         -> (cache, last_logits)
  decode_step(cfg, params, cache, token, pos)   -> (logits, cache)
and the ``LM`` module over them.

Departure: ``decode_step`` writes the new position's K/V (or MLA latent
and rope key) into the cache tensors it is given, in place, and returns
that same cache; the reference returns new arrays, and copying a 32k
cache at every step is not affordable. Callers that reuse a cache clone
it first.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.engine import resolve_torch_device
from repro_torch.kernels.embedding_bag import grad as bag_grad
from repro_torch.optim import adamw
from repro_torch.pytree import leaves, tree_map

from . import layers as L
from .moe import moe_ffn, moe_ffn_gathered, moe_ffn_sorted, moe_shapes


@dataclass(frozen=True)
class LayerSpec:
    ffn: str = "dense"                  # "dense" | "moe"
    use_rope: bool = True               # False => NoPE (Llama-4 global layers)
    chunk: Optional[int] = None         # chunked-local attention window


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    prefix: Tuple[LayerSpec, ...] = ()
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_moe: int = 0
    moe_impl: str = "gathered"          # gathered | gathered_sort | dense
    # MLA (DeepSeek-V2)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    tie_embeddings: bool = False
    remat: str = "layer"                # "none" | "layer" | "dots"
    attn_q_chunk: Optional[int] = None  # blockwise attention query chunk

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.prefix)
        assert body % len(self.pattern) == 0, (self.n_layers, self.pattern)
        return body // len(self.pattern)

    def params_count(self) -> int:
        """Total parameters (for 6ND model-flops accounting)."""
        return sum(math.prod(s[0]) for s in leaves(param_shapes(self),
                                                   is_leaf=L._is_shape))

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        total = self.params_count()
        if self.n_experts == 0:
            return total
        n_moe_layers = sum(1 for s in self.pattern if s.ffn == "moe") \
            * self.n_repeats + sum(1 for s in self.prefix if s.ffn == "moe")
        per_expert = self.d_model * 2 * self.d_ff_moe \
            + self.d_ff_moe * self.d_model
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return total - inactive


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig, spec: LayerSpec) -> Dict[str, Any]:
    if cfg.mla:
        attn = L.mla_shapes(cfg.d_model, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
                            cfg.qk_nope, cfg.qk_rope, cfg.v_head)
    else:
        attn = L.attention_shapes(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, cfg.qkv_bias)
    if spec.ffn == "moe":
        ffn = moe_shapes(cfg.d_model, cfg.d_ff_moe, cfg.n_experts, cfg.n_shared)
    else:
        ffn = {"wi": ((cfg.d_model, 2 * cfg.d_ff), L.PDTYPE),
               "wo": ((cfg.d_ff, cfg.d_model), L.PDTYPE)}
    return {"attn": attn, "ffn": ffn,
            "norm1": ((cfg.d_model,), L.NDTYPE),
            "norm2": ((cfg.d_model,), L.NDTYPE)}


def _stack_shapes(tree: Dict[str, Any], n: int) -> Dict[str, Any]:
    return tree_map(lambda x: ((n,) + x[0], x[1]), tree, is_leaf=L._is_shape)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    shapes: Dict[str, Any] = {
        "embed": ((cfg.vocab, cfg.d_model), L.PDTYPE),
        "final_norm": ((cfg.d_model,), L.NDTYPE),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((cfg.d_model, cfg.vocab), L.PDTYPE)
    for i, spec in enumerate(cfg.prefix):
        shapes[f"prefix{i}"] = _layer_shapes(cfg, spec)
    for i, spec in enumerate(cfg.pattern):
        shapes[f"block{i}"] = _stack_shapes(_layer_shapes(cfg, spec),
                                            cfg.n_repeats)
    return shapes


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda"):
    """Random params from ``generator`` (a ``torch.Generator`` on the
    device's kind) on ``device``, by the reference's name-aware rule
    (``layers.materialize``)."""
    return L.materialize(param_shapes(cfg), generator,
                         resolve_torch_device(device))


def param_specs(cfg: TransformerConfig):
    """The params' shapes and dtypes as tensors on the ``meta`` device."""
    return L.abstractify(param_shapes(cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _unstack(tree, n: int) -> list:
    """The n layers of a stacked block's tree, each a tree of views, from
    one ``unbind(0)`` of every leaf."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[r], parts,
                     is_leaf=lambda x: isinstance(x, tuple))
            for r in range(n)]


def _layers(cfg: TransformerConfig, *trees):
    """(spec, repeated, layer r of each tree) in execution order: the
    prefix (``prefix{i}``'s trees themselves), then the pattern repeated
    (``block{i}``'s stacked trees, unstacked once)."""
    for i, spec in enumerate(cfg.prefix):
        yield (spec, False, *(t[f"prefix{i}"] for t in trees))
    blocks = [[_unstack(t[f"block{i}"], cfg.n_repeats) for t in trees]
              for i in range(len(cfg.pattern))]
    for r in range(cfg.n_repeats):
        for i, spec in enumerate(cfg.pattern):
            yield (spec, True, *(b[r] for b in blocks[i]))


def _save_dots(ctx, op, *args, **kwargs):
    """remat ``"dots"``'s policy: keep the outputs of the GEMMs, recompute
    every other op (the reference's ``checkpoint_dots``)."""
    if getattr(op, "overloadpacket", None) in (torch.ops.aten.mm,
                                               torch.ops.aten.bmm):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn):
    """``fn`` (a repeated layer) under ``cfg.remat`` where autograd records
    the forward (module docstring)."""
    if cfg.remat not in ("none", "layer", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: none | layer | dots")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def _apply_layer(cfg: TransformerConfig, spec: LayerSpec, p, x, positions,
                 kv_cache=None, cache_len=None):
    h = L.rms_norm(x, p["norm1"])
    if cfg.mla:
        attn_out, new_cache = L.mla_attention(
            p["attn"], h, positions, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
            cfg.qk_nope, cfg.qk_rope, cfg.v_head, theta=cfg.rope_theta,
            kv_cache=kv_cache, cache_len=cache_len, q_chunk=cfg.attn_q_chunk)
    else:
        attn_out, new_cache = L.gqa_attention(
            p["attn"], h, positions, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            theta=cfg.rope_theta, use_rope=spec.use_rope, chunk=spec.chunk,
            kv_cache=kv_cache, cache_len=cache_len, q_chunk=cfg.attn_q_chunk)
    x = x + attn_out
    h = L.rms_norm(x, p["norm2"])
    aux = 0.0
    if spec.ffn == "moe":
        if cfg.moe_impl == "dense":
            ffn_out, aux = moe_ffn(p["ffn"], h, cfg.top_k)
        elif cfg.moe_impl == "gathered_sort":
            ffn_out, aux = moe_ffn_sorted(p["ffn"], h, cfg.top_k)
        else:
            ffn_out, aux = moe_ffn_gathered(p["ffn"], h, cfg.top_k)
    else:
        b, s, d = h.shape
        ffn_out = L.swiglu(h.reshape(b * s, d), p["ffn"]["wi"],
                           p["ffn"]["wo"]).reshape(b, s, d)
    return x + ffn_out, aux, new_cache


def _embed(params, tokens) -> torch.Tensor:
    """Token ids (an array or a tensor, (B, S)) -> (B, S, D) activations;
    the table's gradient is the ordered sum by token id
    (``bag_grad.gather_rows``)."""
    table = params["embed"]
    tokens = torch.as_tensor(tokens, device=table.device)
    rows = bag_grad.gather_rows(table, tokens.reshape(-1))
    return rows.view(*tokens.shape, -1).to(L.ADTYPE)


def _positions(b: int, s: int, device, start: int = 0) -> torch.Tensor:
    return (start + torch.arange(s, device=device))[None, :].expand(b, s)


def _logits(cfg: TransformerConfig, params, x) -> torch.Tensor:
    """Final norm and the vocabulary projection, float32 (..., V)."""
    x = L.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.linear(x, head, torch.float32)


def forward(cfg: TransformerConfig, params, tokens, last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V) [or (B, V) when last_only],
    aux): float32 logits, the MoE layers' load-balance loss summed."""
    x = _embed(params, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, repeated, p in _layers(cfg, params):
        fn = functools.partial(_apply_layer, cfg, spec)
        if repeated:
            fn = _remat(cfg, fn)
        x, aux, _ = fn(p, x, positions)
        aux_total = aux_total + aux
    return _logits(cfg, params, x[:, -1, :] if last_only else x), aux_total


def loss_fn(cfg: TransformerConfig, params, batch: Dict[str, Any]):
    """batch: tokens (B, S), targets (B, S). Returns (loss, metrics): the
    mean next-token NLL plus 0.01 × the load-balance aux."""
    logits, aux = forward(cfg, params, batch["tokens"])
    tgt = L.batch_tensor(batch, "targets", logits.device, torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}


def train_step(cfg: TransformerConfig, opt_cfg: adamw.AdamWConfig, params,
               opt_state: adamw.OptState, batch):
    """The reference's LM step (``src/repro/launch/train.py:93-98``): the
    gradient of ``loss_fn`` through every param, then ``adamw.apply``, in
    place. Returns (params, opt_state, {"loss", "nll", "aux", "grad_norm",
    "lr"}), the metrics of the reference's cell step
    (``src/repro/launch/steps.py:109-114``)."""
    loss, metrics, grads = L.value_and_grad(
        lambda p: loss_fn(cfg, p, batch), params)
    params, opt_state, om = adamw.apply(opt_cfg, params, grads, opt_state)
    return params, opt_state, {"loss": loss, **{
        k: v.detach() for k, v in metrics.items()}, **om}


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def _cache_layer_shapes(cfg: TransformerConfig, batch: int, max_len: int):
    if cfg.mla:
        return {"latent": ((batch, max_len, cfg.kv_lora), L.ADTYPE),
                "rope": ((batch, max_len, cfg.qk_rope), L.ADTYPE)}
    return {"k": ((batch, max_len, cfg.n_kv_heads, cfg.d_head), L.ADTYPE),
            "v": ((batch, max_len, cfg.n_kv_heads, cfg.d_head), L.ADTYPE)}


def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int):
    """Per-layer KV cache shapes (stacked for the repeated blocks)."""
    per = _cache_layer_shapes(cfg, batch, max_len)
    shapes = {}
    for i in range(len(cfg.prefix)):
        shapes[f"prefix{i}"] = per
    for i in range(len(cfg.pattern)):
        shapes[f"block{i}"] = _stack_shapes(per, cfg.n_repeats)
    return shapes


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda"):
    """A zeroed cache on ``device``."""
    dev = resolve_torch_device(device)
    return tree_map(lambda x: torch.zeros(x[0], dtype=x[1], device=dev),
                    cache_shapes(cfg, batch, max_len), is_leaf=L._is_shape)


def cache_specs(cfg: TransformerConfig, batch: int, max_len: int):
    """The cache's shapes and dtypes as tensors on the ``meta`` device."""
    return L.abstractify(cache_shapes(cfg, batch, max_len))


def _cache_tuple(cfg, c):
    return (c["latent"], c["rope"]) if cfg.mla else (c["k"], c["v"])


def decode_step(cfg: TransformerConfig, params, cache, token, pos):
    """token (B, 1) ids, pos an int (or anything ``int()`` takes) ->
    (logits (B, V) float32, cache): the new token's K/V are written into
    ``cache`` at ``pos`` in place, and ``cache`` itself is returned."""
    pos = int(pos)
    x = _embed(params, token)
    positions = _positions(x.shape[0], 1, x.device, pos)
    for spec, _, p, c in _layers(cfg, params, cache):
        x, _, _ = _apply_layer(cfg, spec, p, x, positions,
                               kv_cache=_cache_tuple(cfg, c), cache_len=pos)
    return _logits(cfg, params, x[:, -1, :]), cache


def _project_kv(cfg: TransformerConfig, spec: LayerSpec, p, h, positions):
    """The cache's entries of a layer's input h (B, S, D): its K/V (or MLA
    latent and rope key), recomputed by a projection pass as the
    reference's prefill does (``transformer.py:332-356``)."""
    b, s, _ = h.shape
    hn = L.rms_norm(h, p["norm1"])
    if cfg.mla:
        kv_a = L.linear(hn, p["attn"]["wkv_a"])
        lat = L.rms_norm(kv_a[..., :cfg.kv_lora], p["attn"]["kv_a_norm"])
        kr = L.apply_rope(kv_a[..., None, cfg.kv_lora:], positions,
                          cfg.rope_theta)[..., 0, :]
        return (lat, kr)
    k = L.linear(hn, p["attn"]["wk"])
    v = L.linear(hn, p["attn"]["wv"])
    if "bk" in p["attn"]:
        k = k + p["attn"]["bk"].to(h.dtype)
        v = v + p["attn"]["bv"].to(h.dtype)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if spec.use_rope:
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return (k, v)


def prefill(cfg: TransformerConfig, params, tokens,
            max_len: Optional[int] = None):
    """Full-sequence prefill: (cache of ``max_len`` positions, the first
    S filled, the rest zero; last-token logits (B, V) float32)."""
    x = _embed(params, tokens)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, max_len, x.device)
    for spec, _, p, layer_cache in _layers(cfg, params, cache):
        for c, new in zip(_cache_tuple(cfg, layer_cache),
                          _project_kv(cfg, spec, p, x, positions)):
            c[:, :s] = new
        x, _, _ = _apply_layer(cfg, spec, p, x, positions)
    return cache, _logits(cfg, params, x[:, -1, :])


class LM(nn.Module):
    """The module idiom over the functions above: the params (random from
    ``generator`` on ``device``, or given) held as frozen parameters."""

    def __init__(self, cfg: TransformerConfig,
                 params: Optional[Dict[str, Any]] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, generator, device)
        self.params = L.ParamTree(params)

    def param_tree(self) -> Dict[str, Any]:
        return self.params.tree()

    def forward(self, tokens, last_only: bool = False):
        return forward(self.cfg, self.param_tree(), tokens, last_only)

    def prefill(self, tokens, max_len: Optional[int] = None):
        return prefill(self.cfg, self.param_tree(), tokens, max_len)

    def decode_step(self, cache, token, pos):
        return decode_step(self.cfg, self.param_tree(), cache, token, pos)

    def train_step(self, opt_cfg: adamw.AdamWConfig,
                   opt_state: adamw.OptState, batch):
        """One :func:`train_step` on the module's params, in place; returns
        (opt_state, metrics). ``opt_state`` is ``adamw.init`` of
        ``param_tree()``, on its device."""
        _, opt_state, metrics = train_step(self.cfg, opt_cfg,
                                           self.param_tree(), opt_state,
                                           batch)
        return opt_state, metrics


__all__ = ["LM", "LayerSpec", "TransformerConfig", "cache_shapes",
           "cache_specs", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "param_shapes", "param_specs",
           "prefill", "train_step"]
