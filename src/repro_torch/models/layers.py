"""Shared model layers: the parameter dtypes, the init helpers DLRM and
the GNNs use (``src/repro/models/layers.py:25-76``), and the gradient of
a loss through a tree of params.

Conventions (the reference's):
  * params are bf16 (``PDTYPE``); dense layers keep float32 (``FDTYPE``).
  * a model has ``param_shapes(cfg) -> {name: (shape, dtype)}``, a tree
    of nested dicts, used both by real init (``materialize``) and by the
    shape-only path (``abstractify``: tensors on torch's ``meta`` device,
    no allocation, where the reference builds ``jax.ShapeDtypeStruct``s).
  * modules read ``layers.PDTYPE`` as a module attribute at call time, not
    by value, so ``set_dtypes`` takes effect.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from repro_torch.pytree import (flatten_with_path, leaves, tree_map,
                                tree_map_with_path)

PDTYPE = torch.bfloat16   # parameter dtype
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
    made = {}
    for path, (shape, dtype) in flatten_with_path(shapes, is_leaf=_is_shape):
        name = path[-1] if path else ""
        if "norm" in name:
            made[path] = torch.ones(shape, dtype=dtype, device=device)
        elif _is_zero_init(name, shape):
            made[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 1.0 / math.sqrt(max(1, fan_in))
            made[path] = torch.empty(shape, dtype=dtype, device=device) \
                .normal_(0.0, std, generator=generator)
    return tree_map_with_path(lambda path, _: made[path], shapes,
                              is_leaf=_is_shape)


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
