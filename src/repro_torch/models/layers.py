"""Shared model layers: the parameter dtypes and the init helpers DLRM
uses (``src/repro/models/layers.py:25-76``).

Conventions (the reference's):
  * params are bf16 (``PDTYPE``); dense layers keep float32 (``FDTYPE``).
  * a model has ``param_shapes(cfg) -> {name: (shape, dtype)}``, used both
    by real init (``materialize``) and by the shape-only path
    (``abstractify``: tensors on torch's ``meta`` device, no allocation,
    where the reference builds ``jax.ShapeDtypeStruct``s).
  * modules read ``layers.PDTYPE`` as a module attribute at call time, not
    by value, so ``set_dtypes`` takes effect.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

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


def materialize(shapes: Dict[str, Any], generator: torch.Generator,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Turn a flat ``{name: (shape, dtype)}`` dict into initialized tensors
    on ``device``, drawn from ``generator`` (a ``torch.Generator`` on that
    device's kind) in sorted key order, as the reference splits its key
    over its flattened (sorted) tree.

    Name-aware, as the reference: keys containing 'norm' get ones; bias-like
    keys (``eps``, 1-D ``b*``, ``*_b*``) zeros; every other key a normal
    draw times 1/sqrt(fan_in), fan_in = ``shape[-2]`` (``shape[-1]`` for
    1-D). The draw is made in the parameter's own dtype, in place (a
    float32 temporary of a 39,980,032 x 128 table would take 20.5 GB)."""
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(shapes):
        shape, dtype = shapes[name]
        if "norm" in name:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif _is_zero_init(name, shape):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 1.0 / math.sqrt(max(1, fan_in))
            out[name] = torch.empty(shape, dtype=dtype, device=device) \
                .normal_(0.0, std, generator=generator)
    return {name: out[name] for name in shapes}


def abstractify(shapes: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The same dict as tensors on the ``meta`` device: shapes and dtypes,
    zero allocation."""
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, (shape, dtype) in shapes.items()}
