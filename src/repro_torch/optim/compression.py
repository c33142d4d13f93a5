"""Gradient compression with error feedback.

The port of ``src/repro/optim/compression.py``. Two codecs, each a map
over a tree of gradients:

  * bf16: a cast (2x), no state.
  * int8: per-tensor symmetric quantization with error-feedback residuals:
    the quantization error is added back into the next step's gradient.
    Codes round half to even (``torch.round``, as ``jnp.round``).

``launch/train.py`` applies them between the gradient and the optimizer.
"""

from __future__ import annotations

import torch

from repro_torch.pytree import tree_map


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return tree_map(lambda g: g.to(torch.float32), grads)


def init_error_feedback(grads_template):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)


def _packed(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2


def compress_int8_ef(grads, residuals):
    """Returns ((q, scale) per leaf, new residuals): q int8, scale a
    float32 0-d tensor per tensor."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return (q, scale), gf - q.to(torch.float32) * scale

    both = tree_map(one, grads, residuals)
    return (tree_map(lambda x: x[0], both, is_leaf=_packed),
            tree_map(lambda x: x[1], both, is_leaf=_packed))


def decompress_int8(packed):
    return tree_map(lambda p: p[0].to(torch.float32) * p[1], packed,
                    is_leaf=_packed)
