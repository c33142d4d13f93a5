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

The model cells of ``launch.steps`` and ``launch.dryrun`` lay their
arguments out on a named grid of devices instead (``DeviceGrid``): the
production grids of the reference (``make_production_mesh``: 16 x 16
``("data", "model")``, or 2 x 16 x 16 with ``"pod"``), the one-card
grid that runs a cell whole (``make_host_mesh``), and any grid over a
device list (``make_grid``), on which ``parallel.spmd`` runs a cell split. ``HW`` holds the card's
published peaks for the dry run's roofline terms.
"""

from __future__ import annotations

import datetime
import math
import os
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# named device grids of the model cells (the reference's Mesh)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class DeviceGrid:
    """A named grid of devices, the counterpart of ``jax.sharding.Mesh``.

    ``shape`` maps each axis name to its size, in ``axis_names`` order, as
    the reference's ``mesh.shape`` does. ``devices`` is a numpy object
    array of ``torch.device`` of that shape (a device may repeat, as in
    ``fabric_mesh``), or ``None`` for an abstract grid: one that gives
    partition specs, shard shapes and byte reckonings but runs nothing."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _grid(dims: Tuple[int, ...], axes: Tuple[str, ...],
          devices: Optional[Sequence]) -> DeviceGrid:
    from repro_torch.core.engine import resolve_torch_device

    arr = None
    if devices is not None:
        devs = [resolve_torch_device(d) for d in devices]
        if len(devs) != math.prod(dims):
            raise ValueError(f"a {dims} grid needs {math.prod(dims)} "
                             f"devices, got {len(devs)} (repeat a device "
                             f"to put several grid places on it)")
        arr = np.empty(len(devs), dtype=object)
        arr[:] = devs
        arr = arr.reshape(dims)
    return DeviceGrid(tuple(axes), dict(zip(axes, dims)), arr)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> DeviceGrid:
    """(16, 16) 'data' x 'model' single pod (256 places), or (2, 16, 16)
    'pod' x 'data' x 'model' for 2 pods (512 places). Abstract unless
    ``devices`` (one per place, in grid order, repeats allowed) is
    given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices)


def make_grid(dims: Sequence[int], devices: Optional[Sequence] = None
              ) -> DeviceGrid:
    """A ``("data", "model")`` grid of ``dims`` (or ``("pod", "data",
    "model")`` for three dims) over ``devices`` in grid order, repeats
    allowed (``["cuda:0"] * 4`` for four places on one card); abstract
    when ``devices`` is None."""
    dims = tuple(int(d) for d in dims)
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if axes is None:
        raise ValueError(f"a grid has 2 or 3 dims, not {dims}")
    return _grid(dims, axes, devices)


def make_host_mesh(torch_device="cuda") -> DeviceGrid:
    """The (1, 1) 'data' x 'model' grid over the local card (raises where
    there is none), or over the CPU when ``torch_device="cpu"``."""
    return _grid((1, 1), ("data", "model"), [torch_device])


# The card's published peaks (NVIDIA H100 SXM5 80GB data sheet, dense, at
# the 700 W limit) for the dry run's roofline terms; the memory size is the
# card's own (``hbm_bytes``), and every record that uses these carries
# ``nvidia_smi_line()`` beside them.
HW = dict(
    peak_bf16_flops=989e12,      # per card
    hbm_bandwidth=3.35e12,       # bytes/s per card, HBM3
)


def hbm_bytes(torch_device="cuda") -> int:
    """The memory of the card ``torch_device`` names, in bytes, read from
    ``torch.cuda.get_device_properties`` (raises where there is no
    card)."""
    from repro_torch.core.engine import resolve_torch_device

    dev = resolve_torch_device(torch_device)
    if dev.type != "cuda":
        raise ValueError(f"hbm_bytes: {dev} is not a card")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card's line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
