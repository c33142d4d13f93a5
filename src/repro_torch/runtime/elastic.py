"""Elastic scaling + failure recovery (simulated control plane).

On a real cluster the coordinator detects missing heartbeats; here the
same state machine runs against a simulated device pool so the recovery
logic (the part that is *our* code, not the infra's) is exercised by tests:

  1. failure detected -> drop the failed hosts' devices,
  2. choose the largest feasible mesh from the survivors (power-of-two
     slices along the data axis; the model axis is preserved because TP
     shards are interdependent),
  3. rebuild shardings for the new mesh,
  4. restore params from the last checkpoint into the new sharding,
  5. rescale grad-accumulation so the *global* batch is invariant
     (elastic semantics: same optimization trajectory, longer steps).

Boxes (the paper's triangle engine) recover even more cheaply: boxes are
idempotent work items, so unfinished boxes are simply re-queued
(runtime.straggler handles reassignment).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class DevicePool:
    """Simulated fleet: device ids grouped by host."""

    n_hosts: int
    devices_per_host: int = 4
    failed_hosts: set = field(default_factory=set)

    def alive_devices(self) -> List[int]:
        out = []
        for h in range(self.n_hosts):
            if h in self.failed_hosts:
                continue
            out.extend(range(h * self.devices_per_host,
                             (h + 1) * self.devices_per_host))
        return out

    def fail(self, host: int) -> None:
        self.failed_hosts.add(host)

    def recover(self, host: int) -> None:
        self.failed_hosts.discard(host)


@dataclass
class MeshPlan:
    data: int
    model: int
    pod: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pod

    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    def shape(self) -> Tuple[int, ...]:
        return ((self.pod, self.data, self.model) if self.pod > 1
                else (self.data, self.model))


def plan_mesh(n_alive: int, model_parallel: int, prefer_pods: int = 1
              ) -> Optional[MeshPlan]:
    """Largest power-of-two data axis that fits the surviving devices while
    preserving the model axis (TP shards can't shrink without resharding
    params — that path goes through checkpoint restore anyway, step 4)."""
    if n_alive < model_parallel:
        return None
    budget = n_alive // model_parallel
    data = 1 << int(math.floor(math.log2(budget)))
    pod = prefer_pods
    while pod > 1 and data // pod < 1:
        pod //= 2
    data //= pod
    return MeshPlan(data=data, model=model_parallel, pod=pod)


@dataclass
class ElasticState:
    pool: DevicePool
    model_parallel: int
    global_batch: int
    plan: Optional[MeshPlan] = None
    generation: int = 0

    def __post_init__(self):
        self.plan = plan_mesh(len(self.pool.alive_devices()),
                              self.model_parallel)

    def grad_accum_steps(self, per_device_batch: int = 1) -> int:
        """Micro-steps to keep the global batch invariant (step 5)."""
        return accum_steps_for(self.global_batch, self.plan, per_device_batch)

    def on_failure(self, host: int) -> MeshPlan:
        """Steps 1-2: drop host, re-plan. Caller rebuilds shardings (3),
        restores from checkpoint (4) and queries accum rescale (5)."""
        self.pool.fail(host)
        new_plan = plan_mesh(len(self.pool.alive_devices()),
                             self.model_parallel)
        if new_plan is None:
            raise RuntimeError("insufficient devices for model parallelism")
        self.plan = new_plan
        self.generation += 1
        return new_plan

    def on_recovery(self, host: int) -> MeshPlan:
        self.pool.recover(host)
        self.plan = plan_mesh(len(self.pool.alive_devices()),
                              self.model_parallel)
        self.generation += 1
        return self.plan


def accum_steps_for(global_batch: int, plan: MeshPlan,
                    per_device_batch: int) -> int:
    """Micro-batches per optimizer step so DP-size changes never change the
    effective global batch: ceil(global / (dp_size * per_device))."""
    dp = plan.data * plan.pod
    return max(1, -(-global_batch // (dp * per_device_batch)))
