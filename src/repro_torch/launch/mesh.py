"""Device lists and process groups of the distributed box fabric
(``repro_torch.parallel.fabric``).

A "mesh" here is a plain list of torch devices, one per fabric shard. A
device may repeat: several shards then share it and run one after the
other. That is how one card, or the CPU, hosts a many-shard fabric (the
counterpart of a forced host-platform device count). Nothing in this
module touches a device when it is imported.

Multi-process runs (one process per slice of the shards, the worker CLI
of ``parallel.fabric``) merge JSON partials; ``maybe_init_distributed``
joins those processes into a ``torch.distributed`` process group when the
three ``REPRO_FABRIC_*`` variables configure one.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch

FABRIC_AXIS = "shards"
FABRIC_SHARDS_ENV = "REPRO_FABRIC_SHARDS"
COORDINATOR_ENV = "REPRO_FABRIC_COORDINATOR"
NUM_PROCESSES_ENV = "REPRO_FABRIC_NUM_PROCESSES"
PROCESS_ID_ENV = "REPRO_FABRIC_PROCESS_ID"
# how long a configured process waits for its peers before it raises
_INIT_TIMEOUT_S = 300


def local_devices(torch_device="cuda") -> List[torch.device]:
    """Every device of ``torch_device``'s kind in this process: each card
    for ``"cuda"`` (raises when there is none), the one CPU for
    ``"cpu"``."""
    from repro_torch.core.engine import resolve_torch_device

    dev = resolve_torch_device(torch_device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def resolve_fabric_shards(requested: Optional[int] = None,
                          devices: Optional[Sequence] = None,
                          torch_device="cuda") -> int:
    """Number of fabric shards for this process: an explicit request wins,
    then the ``REPRO_FABRIC_SHARDS`` env override, then one shard per
    device of ``devices`` (default: every device of ``torch_device``'s
    kind). Always >= 1. More shards than devices is legal — the fabric
    executes shards as host partitions and needs one device per shard
    only for the mesh reduction."""
    if requested is not None:
        return max(1, int(requested))
    env = os.environ.get(FABRIC_SHARDS_ENV, "").strip()
    if env:
        return max(1, int(env))
    if devices is None:
        devices = local_devices(torch_device)
    return max(1, len(devices))


def fabric_mesh(n_shards: Optional[int] = None,
                devices: Optional[Sequence] = None,
                torch_device="cuda") -> List[torch.device]:
    """The fabric's reduction mesh: the first ``n_shards`` devices of
    ``devices`` (default: every device of ``torch_device``'s kind), one
    per shard partial. Raises ``ValueError`` when fewer devices are given
    than shards; an explicit list may repeat a device, so
    ``devices=["cuda:0"] * 8`` gives eight shards on one card."""
    from repro_torch.core.engine import resolve_torch_device

    devices = local_devices(torch_device) if devices is None \
        else [resolve_torch_device(d) for d in devices]
    n = resolve_fabric_shards(n_shards, devices)
    if n > len(devices):
        raise ValueError(
            f"fabric_mesh: {n} shards but only {len(devices)} device(s); "
            f"pass devices= with a device repeated to put several shards "
            f"on one device")
    return list(devices[:n])


def maybe_init_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Gated ``torch.distributed.init_process_group`` for multi-process
    fabrics.

    Configuration comes from the arguments or the environment
    (``REPRO_FABRIC_COORDINATOR`` as ``host:port`` or a ``tcp://`` URL,
    ``REPRO_FABRIC_NUM_PROCESSES``, ``REPRO_FABRIC_PROCESS_ID``). Returns
    False when unconfigured (the worker CLI then merges file-based
    partials with ``fabric.merge_partials``, which needs no process group
    at all), True when the group is, or already was, initialized. A
    configured group that fails to form (within ``_INIT_TIMEOUT_S``)
    raises. The backend is ``nccl`` where this process has a card and
    ``gloo`` where it has none; NCCL refuses two ranks on one card."""
    coordinator = coordinator or os.environ.get(COORDINATOR_ENV)
    if num_processes is None:
        env = os.environ.get(NUM_PROCESSES_ENV, "").strip()
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get(PROCESS_ID_ENV, "").strip()
        process_id = int(env) if env else None
    if not coordinator or num_processes is None or process_id is None:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S))
    return True
