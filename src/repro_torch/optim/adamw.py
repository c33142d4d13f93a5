"""AdamW + schedules + global-norm clipping over trees of tensors.

The port of ``src/repro/optim/adamw.py``. Moments are float32 whatever the
param dtype: a bfloat16 param updates through float32 math and is cast
back, with no master copy. Weight decay applies to params of two or more
dimensions only. ``step`` is an int32 0-d tensor, and the schedule and the
bias corrections are float32 tensors on the params' device, as ``jnp``
computes them, so a step makes no host synchronisation. Trees are walked
in the reference's order (``repro_torch.pytree``: sorted dict keys), which
fixes the order of the global norm's sum.

This is not ``torch.optim.AdamW``: that one decays before its step, keeps
its moments in the param's dtype, and has no clip and no schedule.

``apply`` updates in place: each param, its moments and ``state.step``
are written where they lie (the moments of a DLRM's tables would not fit
the card twice), and the returned params and state are the same tensors.
A leaf of more than ``CHUNK`` elements is updated in slices along its
leading axes (``pieces``), each slice's float32 temporaries at most
``CHUNK`` elements, and the clip's scale is applied slice by slice, so
no second copy of the gradients is made: an LM's stacked leaves (18 x
3,584 x 37,888 for qwen2-7b's FFN at 18 layers) would need 9.8 GB for
each whole-leaf float32 temporary. The update is elementwise, so every
bit is the whole-leaf update's; the global norm sums a large leaf's
slices' sums of squares, and a leaf of at most ``CHUNK`` elements whole,
as before.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.pytree import leaves, tree_map

# elements of a leaf's slice that one update step takes at once (float32
# temporaries of 512 MB)
CHUNK = 1 << 27


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init(params) -> OptState:
    """Zero float32 moments shaped and placed like each param, and step 0
    (int32, on the first param's device)."""
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32)."""
    s = step.to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    t = (s - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    """(1 - beta1^step, 1 - beta2^step) in float32."""
    s = step.to(torch.float32)
    return 1 - cfg.beta1 ** s, 1 - cfg.beta2 ** s


def pieces(shape, chunk: Optional[int] = None) -> List[Tuple]:
    """Index tuples that cut a tensor of ``shape`` into slices of at most
    ``chunk`` elements (default ``CHUNK``) along its leading axes, in
    order: the whole tensor (``()``) when it is small enough, else runs of
    whole rows, and a row of more than ``chunk`` elements cut along its
    own leading axis."""
    chunk = CHUNK if chunk is None else chunk
    n = math.prod(shape)
    if n <= chunk or not shape:
        return [()]
    row = n // shape[0]
    if row > chunk:
        return [(i, *rest) for i in range(shape[0])
                for rest in pieces(shape[1:], chunk)]
    step = max(1, chunk // row)
    return [(slice(i, i + step),) for i in range(0, shape[0], step)]


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in float32, a large leaf's slices (``pieces``) summed in
    order."""
    return sum(torch.sum(torch.square(x[at].to(torch.float32)))
               for at in pieces(x.shape))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(sum_squares(x) for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The clip's product of one gradient (slice), in its own dtype."""
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in their own
    dtypes; the norm before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), norm


def apply(cfg: AdamWConfig, params, grads, state: OptState,
          norm: Optional[torch.Tensor] = None):
    """One AdamW step, in place (module docstring); returns (params, state,
    {"grad_norm", "lr"}). ``norm``: the clip's norm where it is computed
    elsewhere (a grid step's blocks are not the whole model: its norm is
    summed over every place), else the global norm of ``grads``."""
    with torch.no_grad():
        gnorm = global_norm(grads) if norm is None else norm
        scale = _clip_scale(gnorm, cfg.clip_norm)
        state.step.add_(1)
        lr = schedule(cfg, state.step)
        bc1, bc2 = bias_corrections(cfg, state.step)
        b1, b2 = cfg.beta1, cfg.beta2
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            decay = cfg.weight_decay and p.dim() >= 2   # matrices only
            for at in pieces(p.shape):
                ps, ms, vs = p[at], m[at], v[at]
                gf = _clipped(g[at], scale).to(torch.float32)
                ms.mul_(b1).add_((1 - b1) * gf)
                vs.mul_(b2).add_((1 - b2) * gf * gf)
                delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
                if decay:
                    delta = delta + cfg.weight_decay * ps.to(torch.float32)
                ps.copy_(ps.to(torch.float32) - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
