"""Shared model layers: the parameter dtypes, the init helpers
(``src/repro/models/layers.py:25-76``), the gradient of a loss through a
tree of params, and the LM family's layers (``:79-369``): RMSNorm,
SwiGLU, RoPE, GQA attention (QKV bias, NoPE, Llama-4's chunked-local
mask, blockwise query chunks, decode against a KV cache) and DeepSeek-V2's
MLA with its latent cache.

Conventions (the reference's):
  * params are bf16 (``PDTYPE``); norm scales and biases float32
    (``NDTYPE``); dense layers keep float32 (``FDTYPE``).
  * a product the reference takes with ``preferred_element_type=float32``
    accumulates in float32 here too: :func:`mm_f32` keeps the float32
    result (attention logits, SwiGLU's and MoE's ``h``, the final
    logits), :func:`mm_as` rounds it once to the activation dtype. On
    CUDA that is cuBLAS with a float32 accumulator (``out_dtype=float32``,
    or a bfloat16 GEMM with bfloat16 reduced-precision reductions off:
    :func:`float32_accumulation`, which the serve and train CLIs hold);
    on the CPU the operands are widened to float32, which is exact. Its
    gradient is two more such products (``_ProductF32``).
  * attention masks with ``finfo(float32).min``, never ``-inf``.
  * a model has ``param_shapes(cfg) -> {name: (shape, dtype)}``, a tree
    of nested dicts, used both by real init (``materialize``) and by the
    shape-only path (``abstractify``: tensors on torch's ``meta`` device,
    no allocation, where the reference builds ``jax.ShapeDtypeStruct``s).
  * modules read ``layers.PDTYPE`` as a module attribute at call time, not
    by value, so ``set_dtypes`` takes effect.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.pytree import (flatten_with_path, leaves, tree_map,
                                tree_map_with_path)

PDTYPE = torch.bfloat16   # parameter dtype
NDTYPE = torch.float32    # norm-scale dtype
FDTYPE = torch.float32    # dense-layer and accumulation dtype
ADTYPE = torch.bfloat16   # activation dtype


def set_dtypes(params=torch.bfloat16, acts=torch.bfloat16) -> None:
    """Switch the global param/activation dtypes (the reference's
    ``set_dtypes``; its CPU tests run ``set_dtypes(float32, float32)``)."""
    global PDTYPE, ADTYPE
    PDTYPE = params
    ADTYPE = acts


def _is_zero_init(name: str, shape) -> bool:
    """The reference's bias-like rule: ``eps``, a 1-D key starting with
    ``b``, or any key holding ``_b``."""
    return name == "eps" or name.startswith("b") and len(shape) == 1 \
        or "_b" in name


def _is_shape(x) -> bool:
    """A leaf of a shapes tree: ``(shape tuple, dtype)``."""
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def materialize(shapes: Dict[str, Any], generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Turn a ``{name: (shape, dtype)}`` tree (nested dicts) into
    initialized tensors on ``device``, drawn from ``generator`` (a
    ``torch.Generator`` on that device's kind) leaf by leaf in pytree
    order (sorted keys at every level; ``repro_torch.pytree``), as the
    reference splits its key over its flattened tree. A flat dict is drawn
    in sorted key order.

    Name-aware, as the reference: a leaf's name is its last key; names
    containing 'norm' get ones; bias-like names (``eps``, 1-D ``b*``,
    ``*_b*``) zeros; every other leaf a normal draw times 1/sqrt(fan_in),
    fan_in = ``shape[-2]`` (``shape[-1]`` for 1-D). The draw is made in
    the parameter's own dtype, in place (a float32 temporary of a
    39,980,032 x 128 table would take 20.5 GB)."""
    made = dict(iter_materialize(shapes, generator, device))
    return tree_map_with_path(lambda path, _: made[path], shapes,
                              is_leaf=_is_shape)


def _draw(name: str, shape, dtype, generator, device) -> torch.Tensor:
    if "norm" in name:
        return torch.ones(shape, dtype=dtype, device=device)
    if _is_zero_init(name, shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(1, fan_in))
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=generator)


def iter_materialize(shapes: Dict[str, Any], generator: torch.Generator,
                     device="cpu"):
    """:func:`materialize`'s leaves one at a time, ``(path, tensor)`` in
    pytree order, the same draws: a consumer that lets each leaf go
    before asking for the next holds one whole leaf at a time."""
    for path, (shape, dtype) in flatten_with_path(shapes, is_leaf=_is_shape):
        yield path, _draw(path[-1] if path else "", shape, dtype, generator,
                          device)


def abstractify(shapes: Dict[str, Any]) -> Dict[str, Any]:
    """The same tree as tensors on the ``meta`` device: shapes and dtypes,
    zero allocation."""
    return tree_map(lambda x: torch.empty(x[0], dtype=x[1], device="meta"),
                    shapes, is_leaf=_is_shape)


def batch_tensor(batch, key: str, device, dtype=None) -> torch.Tensor:
    """``batch[key]`` (an array or a tensor) as a tensor on ``device``, in
    ``dtype`` when given: the tensor itself when it is already there."""
    return torch.as_tensor(batch[key], dtype=dtype, device=device)


def value_and_grad(fn: Callable, params):
    """(value, aux, grads) of ``value, aux = fn(params)``: the gradient of
    ``value`` with respect to every leaf of the ``params`` tree, in a tree
    of its structure. The leaves enter ``fn`` detached, so ``params``
    themselves need no gradient and autograd keeps no graph after."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)
    value, aux = fn(live)
    grads = torch.autograd.grad(value, flat, allow_unused=True)
    # a leaf the value does not use gets zeros, as jax.grad gives it
    grads = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)}
    return value.detach(), aux, tree_map(lambda p: grads[id(p)], live)


class ParamTree(torch.nn.Module):
    """A nested dict of tensors as nested modules of frozen parameters
    (the tensors themselves, not copies); ``tree()`` gives the dict back."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, torch.nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        return {**dict(self._parameters),
                **{k: m.tree() for k, m in self._modules.items()}}


# ---------------------------------------------------------------------------
# products accumulated in float32
# ---------------------------------------------------------------------------

def _product(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) accumulated in float32 and rounded
    once to ``dtype``, outside autograd. A float32 pair is one float32
    GEMM; on CUDA a pair of ``dtype`` is one GEMM in it (cuBLAS
    accumulates in float32), any other pair is cuBLAS with
    ``out_dtype=float32``; on the CPU, which has no kernel for that, the
    operands are widened (exact)."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.dtype == b.dtype and (a.dtype == torch.float32
                               or a.is_cuda and a.dtype == dtype):
        out = mm(a, b)
    elif a.is_cuda:
        out = mm(a, b, out_dtype=torch.float32)
    else:
        out = mm(a.float(), b.float())
    return out.to(dtype)


class _ProductF32(torch.autograd.Function):
    """:func:`mm_f32` of a pair that is not all float32. Forward: the
    float32 product. Backward: ``grad_a = g @ b^T`` and ``grad_b = a^T @
    g``, each with the float32 cotangent ``g`` rounded to the other
    operand's dtype, accumulated in float32 and returned in its own
    operand's dtype: for a bfloat16 pair, two bfloat16 GEMMs with float32
    accumulation. (``torch.mm(..., out_dtype=float32)`` itself has no
    derivative.)"""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(a, b, torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _product(g.to(b.dtype), b.transpose(-1, -2), a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _product(a.transpose(-1, -2), g.to(a.dtype), b.dtype)
        return ga, gb


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) accumulated in float32, returned
    in float32: the reference's ``preferred_element_type=float32`` kept
    without a cast. A float32 pair is a plain GEMM; any other pair goes
    through ``_ProductF32`` (cuBLAS with ``out_dtype=float32`` on CUDA,
    widened operands on the CPU), whose backward is two GEMMs accumulating
    in float32."""
    if a.dtype == b.dtype == torch.float32:
        return torch.mm(a, b) if a.dim() == 2 else torch.bmm(a, b)
    return _ProductF32.apply(a, b)


def mm_as(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` accumulated in float32 and rounded once to ``dtype``:
    the reference's ``einsum(..., preferred_element_type=float32)
    .astype(dtype)``. Where both operands are already ``dtype``, on CUDA
    (and for float32 anywhere) that is one GEMM in ``dtype``: cuBLAS
    accumulates in float32 and rounds its result once."""
    if a.dtype == b.dtype == dtype and (a.is_cuda or dtype == torch.float32):
        return torch.mm(a, b) if a.dim() == 2 else torch.bmm(a, b)
    return mm_f32(a, b).to(dtype)


@contextlib.contextmanager
def float32_accumulation():
    """Within it, cuBLAS accumulates every GEMM in float32 and rounds once,
    as the reference's ``preferred_element_type=float32`` asks: bfloat16
    reduced-precision reductions and TF32 off. The flags are the
    process's; they are restored on exit."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32 = saved


def linear(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """``einsum("...d,df->...f", x, w)`` accumulated in float32, returned
    in ``dtype`` (``x``'s by default; ``torch.float32`` keeps the float32
    result)."""
    y = mm_as(x.reshape(-1, x.shape[-1]), w,
              x.dtype if dtype is None else dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
           ) -> torch.Tensor:
    """Fused gate+up projection: wi (d, 2*f), wo (f, d); gate·up formed
    in float32."""
    h = linear(x, wi, torch.float32)
    gate, up = torch.chunk(h, 2, dim=-1)
    act = torch.nn.functional.silu(gate) * up
    return linear(act.to(x.dtype), wo)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float = 10000.0) -> np.ndarray:
    """The reference's numpy expression (``layers.py:104``), so the float32
    frequencies are its bits."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32)
                            / d_head))


@functools.lru_cache(maxsize=64)
def _freqs_on(d_head: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once: a copy from host
    memory at every layer would wait for the card each time."""
    return torch.from_numpy(rope_freqs(d_head, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = _freqs_on(dh, float(theta), x.device)          # (Dh/2,)
    ang = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

NEG = torch.finfo(torch.float32).min   # the reference's mask value


def attention_shapes(d_model: int, n_heads: int, n_kv: int, d_head: int,
                     qkv_bias: bool) -> Dict[str, Any]:
    s = {
        "wq": ((d_model, n_heads * d_head), PDTYPE),
        "wk": ((d_model, n_kv * d_head), PDTYPE),
        "wv": ((d_model, n_kv * d_head), PDTYPE),
        "wo": ((n_heads * d_head, d_model), PDTYPE),
    }
    if qkv_bias:
        s["bq"] = ((n_heads * d_head,), NDTYPE)
        s["bk"] = ((n_kv * d_head,), NDTYPE)
        s["bv"] = ((n_kv * d_head,), NDTYPE)
    return s


def _causal_mask(sq: int, skv: int, q_off: int, chunk: Optional[int],
                 device) -> torch.Tensor:
    qpos = q_off + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if chunk is not None:
        m = m & (kpos // chunk == qpos // chunk)  # Llama-4 chunked locality
    return m


def _write_cache(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write the one new position ``new`` (B, 1, ...) into ``cache`` (B,
    Skv, ...) at ``pos``, in place (the reference's
    ``dynamic_update_slice`` returns a new array instead)."""
    cache[:, pos] = new[:, 0]


def gqa_attention(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  positions: torch.Tensor, n_heads: int, n_kv: int,
                  d_head: int, *, theta: float = 10000.0,
                  use_rope: bool = True, chunk: Optional[int] = None,
                  kv_cache: Optional[Tuple] = None,
                  cache_len: Optional[int] = None,
                  q_chunk: Optional[int] = None):
    """x: (B, S, D). With kv_cache=(k, v) of (B, Skv, n_kv, Dh): decode mode
    -- with S == 1 the new K/V are written into the cache at
    ``cache_len`` (in place) and (out, (k, v)) returned; else causal
    self-attention over x, (out, None)."""
    b, s, _ = x.shape
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, n_heads, d_head)
    k = k.reshape(b, s, n_kv, d_head)
    v = v.reshape(b, s, n_kv, d_head)
    if use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)

    if kv_cache is not None:
        ck, cv = kv_cache
        skv = ck.shape[1]
        idx = int(cache_len) if cache_len is not None else skv - 1
        if s == 1:
            _write_cache(ck, k, idx)
            _write_cache(cv, v, idx)
        mask = _causal_mask(1, skv, idx, chunk, x.device)     # (1, Skv)
        out = _sdpa(q, ck, cv, n_heads, n_kv, mask[:, None, :])
        y = linear(out.reshape(b, s, n_heads * d_head), p["wo"])
        return y, (ck, cv)

    mask = _causal_mask(s, s, 0, chunk, x.device)
    out = _sdpa(q, k, v, n_heads, n_kv, mask, q_chunk=q_chunk)
    y = linear(out.reshape(b, s, n_heads * d_head), p["wo"])
    return y, None


def _scores(lg: torch.Tensor, m: torch.Tensor, *, add=None, mul=None,
            div=None) -> torch.Tensor:
    """The float32 attention scores ``((lg + add) * mul) / div`` (each
    step where given), masked with ``NEG`` outside ``m``. Without autograd
    (serving) they are taken in place, so a prefill holds one score buffer;
    under autograd out of place, since remat ``"dots"`` keeps the products
    as computed."""
    inplace = not lg.requires_grad
    if add is not None:
        lg = lg.add_(add) if inplace else lg + add
    if mul is not None:
        lg = lg.mul_(mul) if inplace else lg * mul
    if div is not None:
        lg = lg.div_(div) if inplace else lg / div
    return lg.masked_fill_(~m, NEG) if inplace else lg.masked_fill(~m, NEG)


def _sdpa(q, k, v, n_heads, n_kv, mask, q_chunk: Optional[int] = None):
    """Grouped scaled dot-product attention; float32 logits and softmax.

    q_chunk: blockwise query chunking, as the reference's ``lax.scan``
    over chunks (a Python loop here): the score buffer shrinks from
    O(Sq·Skv) to O(q_chunk·Skv) per step. The reference takes it only when
    ``q_chunk`` divides Sq; so does the port."""
    b, sq, _, dh = q.shape
    skv = k.shape[1]
    g = n_heads // n_kv
    q = q.reshape(b, sq, n_kv, g, dh)

    if q_chunk is not None and sq > q_chunk and sq % q_chunk == 0:
        if mask.dim() != 2:
            raise ValueError("q_chunk expects a (Sq, Skv) mask")
        outs = [_sdpa_core(q[:, c:c + q_chunk], k, v, g, dh,
                           mask[c:c + q_chunk])
                for c in range(0, sq, q_chunk)]
        return torch.cat(outs, dim=1).reshape(b, sq, n_heads, dh)

    m = mask if mask.dim() == 2 else mask[:, None, None, :, :]
    return _sdpa_core(q, k, v, g, dh, m).reshape(b, sq, n_heads, dh)


def _sdpa_core(q, k, v, g, dh, m):
    """One (q-block × full-KV) attention tile: (B, qc, kv, g, d) x
    (B, S, kv, d) -> (B, qc, kv, g, d). ``m`` broadcasts against the
    (B, kv, g, qc, S) logits; as batched products over B·kv with the
    group's g·qc query rows stacked."""
    b, qc, n_kv, _, _ = q.shape
    s = k.shape[1]
    qm = q.permute(0, 2, 3, 1, 4).reshape(b * n_kv, g * qc, dh)
    km = k.permute(0, 2, 3, 1).reshape(b * n_kv, dh, s)
    logits = _scores(mm_f32(qm, km).view(b, n_kv, g, qc, s), m,
                     div=math.sqrt(dh))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    del logits
    vm = v.permute(0, 2, 1, 3).reshape(b * n_kv, s, dh)
    out = mm_as(w.view(b * n_kv, g * qc, s), vm, q.dtype)
    return out.view(b, n_kv, g, qc, dh).permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 Multi-head Latent Attention)
# ---------------------------------------------------------------------------

def mla_shapes(d_model: int, n_heads: int, q_lora: int, kv_lora: int,
               qk_nope: int, qk_rope: int, v_head: int) -> Dict[str, Any]:
    return {
        "wq_a": ((d_model, q_lora), PDTYPE),
        "q_a_norm": ((q_lora,), NDTYPE),
        "wq_b": ((q_lora, n_heads * (qk_nope + qk_rope)), PDTYPE),
        "wkv_a": ((d_model, kv_lora + qk_rope), PDTYPE),
        "kv_a_norm": ((kv_lora,), NDTYPE),
        "wkv_b": ((kv_lora, n_heads * (qk_nope + v_head)), PDTYPE),
        "wo": ((n_heads * v_head, d_model), PDTYPE),
    }


def mla_attention(p, x, positions, n_heads, q_lora, kv_lora, qk_nope,
                  qk_rope, v_head, *, theta: float = 10000.0,
                  kv_cache=None, cache_len=None,
                  q_chunk: Optional[int] = None):
    """DeepSeek-V2 MLA. The decode cache holds the *compressed* latent
    (B, S, kv_lora) and the rope key (B, S, qk_rope); with S == 1 the new
    position is written into them in place."""
    b, s, _ = x.shape
    qa = rms_norm(linear(x, p["wq_a"]), p["q_a_norm"])
    q = linear(qa, p["wq_b"]).reshape(b, s, n_heads, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, theta)

    kv_a = linear(x, p["wkv_a"])
    latent, k_rope_in = kv_a[..., :kv_lora], kv_a[..., kv_lora:]
    latent = rms_norm(latent, p["kv_a_norm"])
    k_rope = apply_rope(k_rope_in[..., None, :], positions, theta)  # (B,S,1,r)

    if kv_cache is not None:
        c_lat, c_kr = kv_cache
        skv = c_lat.shape[1]
        idx = int(cache_len) if cache_len is not None else skv - 1
        if s == 1:
            _write_cache(c_lat, latent, idx)
            _write_cache(c_kr, k_rope[..., 0, :], idx)
        latent_all, k_rope_all = c_lat, c_kr
        mask = _causal_mask(1, skv, idx, None, x.device)[:, None, :]
    else:
        latent_all, k_rope_all = latent, k_rope[..., 0, :]
        mask = _causal_mask(s, s, 0, None, x.device)
    skv = latent_all.shape[1]

    kv = linear(latent_all, p["wkv_b"])
    kv = kv.reshape(b, skv, n_heads, qk_nope + v_head)
    # (B·H, d, Skv) keys and (B·H, Skv, d) values
    k_nope = kv[..., :qk_nope].permute(0, 2, 3, 1).reshape(
        b * n_heads, qk_nope, skv)
    v = kv[..., qk_nope:].permute(0, 2, 1, 3).reshape(
        b * n_heads, skv, v_head)
    k_rope_t = k_rope_all.transpose(1, 2)                  # (B, r, Skv)
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)

    def tile(qn, qr, m):
        """(B, qc, H, ·) query rows -> (B, qc, H, v_head)."""
        qc = qn.shape[1]
        lg = mm_f32(qn.permute(0, 2, 1, 3).reshape(b * n_heads, qc, qk_nope),
                    k_nope).view(b, n_heads, qc, skv)
        lg = _scores(lg, m, add=mm_f32(
            qr.permute(0, 2, 1, 3).reshape(b, n_heads * qc, qk_rope),
            k_rope_t).view(b, n_heads, qc, skv), mul=scale)
        w = torch.softmax(lg, dim=-1).to(x.dtype)
        del lg
        o = mm_as(w.view(b * n_heads, qc, skv), v, x.dtype)
        return o.view(b, n_heads, qc, v_head).permute(0, 2, 1, 3)

    if q_chunk is not None and s > q_chunk and s % q_chunk == 0 \
            and kv_cache is None:
        # blockwise query chunking (boxing applied to attention): the
        # (B, H, S, S) score buffer becomes (B, H, qc, S) per step
        out = torch.cat([tile(q_nope[:, c:c + q_chunk],
                              q_rope[:, c:c + q_chunk], mask[c:c + q_chunk])
                         for c in range(0, s, q_chunk)], dim=1)
    else:
        out = tile(q_nope, q_rope, mask if mask.dim() == 2 else mask[:, None])
    y = linear(out.reshape(b, s, n_heads * v_head), p["wo"])
    if kv_cache is not None:
        return y, (c_lat, c_kr)
    return y, None
