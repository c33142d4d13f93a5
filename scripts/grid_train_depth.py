#!/usr/bin/env python3
"""How deep qwen2-7b trains at full width split over four places of one card.

Runs chip_smoke.py's grid_train step (``grid_train_run``: qwen2-7b's
train_4k cell on a (2, 2) grid of four places on ``cuda:0``, the
arguments made on their places, two 4,096-token sequences a step, remat
"layer", bfloat16 params and gradients, float32 moments, GEMMs
accumulating in float32) at each depth of ``--layers`` in turn, two
steps each, and prints one JSON line a depth: the peak of allocated
memory while the arguments are made and in the steps, the memory the
caching allocator held, the step's milliseconds and its params, or the
out-of-memory error a depth met (the smoke's 75-GB limit is not applied
here). The smoke's ``GRID_TRAIN_LAYERS`` is the deepest depth whose peak
stays below that limit. Run from the repository root on a machine with
a CUDA card:

    python3 scripts/grid_train_depth.py [--layers 6,8,10,12]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", default="6,8,10,12")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("grid_train_depth: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import grad as grad_ops
    from repro_torch.models import layers as L
    print(S.nvidia_smi_line(), flush=True)
    _build.build()
    torch.cuda.init()
    ops = {"embedding_bag_backward": grad_ops.BACKWARD_LAUNCHES}
    one = ["cuda:0"] * S.GRID_PLACES
    saved = L.PDTYPE, L.ADTYPE
    with L.float32_accumulation():
        L.set_dtypes(torch.bfloat16, torch.bfloat16)
        try:
            for n in (int(x) for x in args.layers.split(",")):
                line = {"layers": n}
                try:
                    out, _, _ = S.grid_train_run(
                        torch, np, ops, grad_ops, one, n, 2,
                        peak_limit=float("inf"))
                    line.update({k: out[k] for k in (
                        "params", "state_bytes", "init_peak_bytes",
                        "peak_bytes", "ms_per_step", "ledger_bytes_per_step")})
                except torch.OutOfMemoryError as e:
                    line["out_of_memory"] = str(e).splitlines()[0]
                    line["max_memory_allocated"] = \
                        torch.cuda.max_memory_allocated()
                line["max_memory_reserved"] = torch.cuda.max_memory_reserved()
                print(json.dumps(line), flush=True)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                if "out_of_memory" in line:
                    break
        finally:
            L.set_dtypes(*saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
