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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.pytree import leaves, tree_map


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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in their own
    dtypes; the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def apply(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step, in place (module docstring); returns (params, state,
    {"grad_norm", "lr"})."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        state.step.add_(1)
        lr = schedule(cfg, state.step)
        bc1, bc2 = bias_corrections(cfg, state.step)
        b1, b2 = cfg.beta1, cfg.beta2
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            gf = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and p.dim() >= 2:   # decay matrices only
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
