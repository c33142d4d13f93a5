"""The port's fabric mesh helpers (``repro_torch.launch.mesh``) against the
reference's (``repro.launch.mesh``), on the CPU.

A mesh is a list of torch devices here; a device may repeat, which is the
port's counterpart of XLA's forced host-platform device count. Shard
counts follow the reference's rules (request, then ``REPRO_FABRIC_SHARDS``,
then one per device), ``fabric_mesh`` raises below the shard count, and
``maybe_init_distributed`` is unconfigured → False as in the reference;
configured, it forms a real ``torch.distributed`` group (``gloo`` here:
two processes, one all-reduce).
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from repro.launch import mesh as ref
from repro_torch.launch import mesh as port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DIST_ENV = (port.COORDINATOR_ENV, port.NUM_PROCESSES_ENV,
            port.PROCESS_ID_ENV)


def test_names_equal_reference():
    assert port.FABRIC_AXIS == ref.FABRIC_AXIS
    assert port.FABRIC_SHARDS_ENV == ref.FABRIC_SHARDS_ENV


@pytest.mark.parametrize("requested", [None, 0, 1, 3, 48])
@pytest.mark.parametrize("env", [None, "6"])
def test_resolve_fabric_shards_equals_reference(requested, env,
                                                monkeypatch):
    """Explicit request first (clamped to 1), then the env override, then
    one shard per device of the list given."""
    if env is None:
        monkeypatch.delenv(port.FABRIC_SHARDS_ENV, raising=False)
    else:
        monkeypatch.setenv(port.FABRIC_SHARDS_ENV, env)
    devices = ["cpu"] * 5
    got = port.resolve_fabric_shards(requested, devices=devices)
    assert got == ref.resolve_fabric_shards(requested,
                                            devices=[object()] * 5)
    assert got == (max(1, requested) if requested is not None
                   else int(env) if env else 5)


def test_default_shards_are_the_devices_of_the_kind(monkeypatch):
    monkeypatch.delenv(port.FABRIC_SHARDS_ENV, raising=False)
    assert port.resolve_fabric_shards(torch_device="cpu") == 1
    assert port.local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        # the default kind is the card, which this host does not have
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.resolve_fabric_shards()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.fabric_mesh(2)


def test_fabric_mesh_repeats_devices_and_raises_below_the_shards(
        monkeypatch):
    monkeypatch.delenv(port.FABRIC_SHARDS_ENV, raising=False)
    mesh = port.fabric_mesh(4, devices=["cpu"] * 8)
    assert mesh == [torch.device("cpu")] * 4
    assert port.fabric_mesh(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    assert port.fabric_mesh(torch_device="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="only 1 device"):
        port.fabric_mesh(2, torch_device="cpu")
    with pytest.raises(ValueError, match="only 3 device"):
        port.fabric_mesh(4, devices=["cpu"] * 3)
    monkeypatch.setenv(port.FABRIC_SHARDS_ENV, "2")
    assert len(port.fabric_mesh(devices=["cpu"] * 3)) == 2


def test_maybe_init_distributed_unconfigured_is_false(monkeypatch):
    for var in DIST_ENV:
        monkeypatch.delenv(var, raising=False)
    assert port.maybe_init_distributed() is False
    assert ref.maybe_init_distributed() is False
    # partial configuration is still unconfigured
    monkeypatch.setenv(port.COORDINATOR_ENV, "127.0.0.1:9999")
    assert port.maybe_init_distributed() is False
    monkeypatch.setenv(port.NUM_PROCESSES_ENV, "2")
    assert port.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()


_WORKER = r"""
import torch
from repro_torch.launch.mesh import maybe_init_distributed
assert maybe_init_distributed() is True
assert maybe_init_distributed() is True          # idempotent
rank = torch.distributed.get_rank()
x = torch.tensor([rank + 1], dtype=torch.int64)
torch.distributed.all_reduce(x)
assert torch.distributed.get_backend() == "gloo"
print(f"DIST-OK rank={rank} sum={int(x)}", flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group():
    """Two processes configured through the three REPRO_FABRIC_* variables
    form one gloo group (no card here) and all-reduce across it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep \
        + env.get("PYTHONPATH", "")
    env[port.COORDINATOR_ENV] = f"127.0.0.1:{_free_port()}"
    env[port.NUM_PROCESSES_ENV] = "2"
    procs = []
    for rank in range(2):
        env[port.PROCESS_ID_ENV] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=dict(env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert sorted(o.split()[-2] for o in outs) == ["rank=0", "rank=1"]
    assert all("sum=3" in o for o in outs)
