"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, bound with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edit rebuilds and an unchanged source loads the library
already built. ``build()`` starts one
``nvcc`` per source, all at once. Nothing here falls back: a missing
``nvcc`` or a failed compile raises.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; the
wrappers raise when that is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("intersect", "triangle_dense", "lftj_fused", "embedding_bag",
           "embedding_bag_backward")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CUDA_HOME_DEFAULT = "/usr/local/cuda"

# nvcc output (ptxas register / shared-memory / spill report) per kernel
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Plain-integer count of kernel launches (``n``), safe to bump from
    the box scheduler's worker threads."""

    def __init__(self) -> None:
        self.n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$PATH``, then ``$CUDA_HOME/bin``, then the
    toolkit's default prefix. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 CUDA_HOME_DEFAULT):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (searched $PATH, $CUDA_HOME/bin and "
        f"{CUDA_HOME_DEFAULT}/bin): the CUDA kernels of repro_torch are "
        "compiled from csrc/*.cu at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    library path of each name."""
    names = list(KERNELS if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), with
    ``signatures`` ({symbol: (argtypes, restype)}) applied once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for sym, (argtypes, restype) in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _libs[name] = lib
        return lib


def check_launch(name: str, rc: int) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device: torch.device):
    """A context that makes ``device`` the current CUDA device for a
    launch, or nothing when it is current already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
