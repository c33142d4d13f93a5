#!/usr/bin/env python3
"""How deep qwen2-7b trains at full width on one card.

Runs chip_smoke.py's lm_train step (``lm_train_full``: qwen2-7b's full
width, one 4,096-token sequence a step, remat "layer", bfloat16 params
and gradients, float32 moments, GEMMs accumulating in float32) at each
depth of ``--layers`` in turn, two steps each, and prints one JSON line a
depth: the peak of allocated memory, the memory the caching allocator
held, the step's milliseconds and its params, or the out-of-memory error
a depth met (the smoke's 75-GB limit is not applied here). The smoke's
``LM_TRAIN_LAYERS`` is the deepest depth that stays below that limit.
Run from the repository root on a machine with a CUDA card:

    python3 scripts/lm_train_depth.py [--layers 4,8,16,18]
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
    ap.add_argument("--layers", default="4,8,16,18")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lm_train_depth: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import grad as grad_ops
    from repro_torch.models import layers as L
    print(S.nvidia_smi_line(), flush=True)
    _build.build()
    ops = {"embedding_bag_backward": grad_ops.BACKWARD_LAUNCHES}
    S.LM_TRAIN_STEPS, S.LM_TRAIN_PEAK_LIMIT = 2, float("inf")
    saved = L.PDTYPE, L.ADTYPE
    with L.float32_accumulation():
        L.set_dtypes(torch.bfloat16, torch.bfloat16)
        try:
            for n in (int(x) for x in args.layers.split(",")):
                S.LM_TRAIN_LAYERS = n
                line = {"layers": n}
                try:
                    out, _ = S.lm_train_full(torch, np, ops, grad_ops)
                    line.update({k: out[k] for k in (
                        "params", "state_bytes", "max_memory_allocated",
                        "ms_per_step", "host_syncs_per_step")})
                    line["idle_share"] = out["profile"]["idle_share"]
                except torch.OutOfMemoryError as e:
                    line["out_of_memory"] = str(e).splitlines()[0]
                    line["max_memory_allocated"] = \
                        torch.cuda.max_memory_allocated()
                line["max_memory_reserved"] = torch.cuda.max_memory_reserved()
                print(json.dumps(line), flush=True)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        finally:
            L.set_dtypes(*saved)
    print(json.dumps({"sync_sites": dict(S.SYNC_SITES)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
