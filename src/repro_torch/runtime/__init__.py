"""Fault tolerance around idempotent work: the straggler watchdog and the
work-stealing box scheduler (``straggler``, which the serving layer's
retry rounds drive), and the simulated elastic control plane
(``elastic``). Copies of the reference package's ``runtime`` modules:
pure Python and numpy, no torch."""

from .elastic import (DevicePool, ElasticState, MeshPlan, accum_steps_for,
                      plan_mesh)
from .straggler import BoxScheduler, BoxTask, StepTimeWatchdog, fail_worker

__all__ = ["BoxScheduler", "BoxTask", "DevicePool", "ElasticState",
           "MeshPlan", "StepTimeWatchdog", "accum_steps_for", "fail_worker",
           "plan_mesh"]
