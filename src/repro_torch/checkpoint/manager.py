"""Checkpointing: atomic, keep-k, async, restart-safe.

The port of ``src/repro/checkpoint/manager.py``, on its layout, so either
package restores the other's float32 checkpoints:
  * a tree of tensors (params, ``optim.adamw.OptState``, nested dicts,
    lists and tuples) is flattened to key -> array in the reference's
    pytree order and keys (``repro_torch.pytree``: ``0/table0``,
    ``1/.step``, ``1/.m/bot_w0``);
  * writes go to ``step_<n>.tmp/`` then ``os.replace()`` to ``step_<n>/``,
    so a crashed save is never taken for a complete one;
  * ``arrays.npz`` holds the arrays and ``manifest.json`` (step, time,
    each array's shape and dtype, ``extra``) is written last;
  * async mode hands the host copies to a writer thread, and ``wait()``
    joins it before the next save;
  * keep-k garbage collection.

A bfloat16 tensor is written as the reference writes one (numpy's
``ml_dtypes`` bfloat16 saved by ``np.savez``): its raw 2-byte bits, dtype
``|V2`` in the file and ``bfloat16`` in the manifest. ``restore`` reads a
``|V2`` array back as bfloat16 bits. (The reference's own ``restore``
cannot read that leaf back: ``jnp.asarray`` refuses ``|V2``.)
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.pytree import (flatten_with_path, path_key,
                                tree_map_with_path)

__all__ = ["CheckpointManager"]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(a host array of ``leaf``, its manifest dtype): a bfloat16 tensor as
    its bits (``|V2``, ``"bfloat16"``)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device; a ``|V2``
    array is bfloat16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    arrays, dtypes = {}, {}
    for path, leaf in flatten_with_path(tree):
        key = path_key(path)
        arrays[key], dtypes[key] = _to_numpy(leaf)
    return arrays, dtypes


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        flat = _flatten(tree)     # host copies happen here, synchronously
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, extra)

    def _write(self, step: int, flat, extra: Optional[dict]) -> None:
        arrays, dtypes = flat
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in arrays.items()},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)    # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into the structure of ``template``: each tensor leaf
        replaced by the saved array in its dtype and on its device, any
        other leaf by the saved numpy array."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        with np.load(path / "arrays.npz") as data:
            def one(keys, leaf):
                arr = data[path_key(keys)]
                return _from_numpy(arr, leaf) \
                    if isinstance(leaf, torch.Tensor) else arr
            tree = tree_map_with_path(one, template)
        return tree, step
