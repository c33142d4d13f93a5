#!/usr/bin/env python3
"""Time repro_torch.QueryEngine counts and listings on the card at rising
RMAT scales, to choose the scales of chip_smoke.py's query and
query_listing phases (PERF.md §4).

For scales 12..15 (``rmat_graph(2^s, 16·2^s, seed=0)``, ``mem_words =
2^(s+1)``, one worker) it counts the four-clique and the diamond on
``backend="auto"`` and ``"fused"`` against scipy oracles, and stops raising
a (pattern, backend) pair's scale once a count passed 50 s. For scales
11..14 (seed 1, ``mem_words = 2^(s+2)``) it lists four-cliques on
``"fused"`` and, up to scale 12, on the CPU. Then, if time is left, the
triangle at scale 20. One JSON line per run; the whole probe stops
starting runs after ``--budget`` seconds. Run from the repository root on
a machine with a CUDA card:

    python3 scripts/query_scale_probe.py [--budget 900]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=float, default=900.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("query_scale_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (diamond_oracle, four_clique_oracle,
                            oriented_adjacency)
    import numpy as np
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels.intersect import ops as iops
    from repro_torch.kernels.lftj_fused import ops as fops
    from repro_torch.query import QueryEngine, patterns

    t_start = time.perf_counter()

    def left() -> float:
        return args.budget - (time.perf_counter() - t_start)

    slow = set()
    for s in (12, 13, 14, 15):
        if left() < 300:
            break
        src, dst = rmat_graph(1 << s, 16 << s, seed=0)
        adj = oriented_adjacency(np, src, dst)
        t0 = time.perf_counter()
        oracles = {"diamond": diamond_oracle(adj)}
        t_dia = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracles["four_clique"] = four_clique_oracle(np, adj) \
            if s <= 14 else None
        emit({"scale": s, "oracle_diamond": oracles["diamond"], "t": t_dia,
              "oracle_k4": oracles["four_clique"],
              "t_k4": time.perf_counter() - t0})
        for pat in ("four_clique", "diamond"):
            for backend in ("auto", "fused"):
                if (pat, backend) in slow or left() < 200:
                    continue
                iops.LAUNCHES.reset()
                fops.LAUNCHES.reset()
                eng = QueryEngine.from_graph(
                    patterns.PATTERNS[pat](), src, dst,
                    mem_words=1 << (s + 1), backend=backend)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                count = eng.count()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = eng.stats
                emit({"scale": s, "pat": pat, "be": backend, "count": count,
                      "s": wall, "boxes": st.n_boxes,
                      "kernel_boxes": st.n_kernel_boxes,
                      "fused_boxes": st.n_fused_boxes,
                      "host_boxes": st.n_host_boxes,
                      "intersect": iops.LAUNCHES.n, "fused": fops.LAUNCHES.n,
                      "oracle_ok": count == oracles[pat]})
                if wall > 50:
                    slow.add((pat, backend))
    for s in (11, 12, 13, 14):
        if left() < 200:
            break
        src, dst = rmat_graph(1 << s, 16 << s, seed=1)
        mem = 1 << (s + 2)
        fops.LIST_LAUNCHES.reset()
        eng = QueryEngine.from_graph(patterns.four_clique(), src, dst,
                                     mem_words=mem, backend="fused")
        t0 = time.perf_counter()
        rows = eng.list()
        wall = time.perf_counter() - t0
        st = eng.stats
        t0 = time.perf_counter()
        cpu = QueryEngine.from_graph(patterns.four_clique(), src, dst,
                                     mem_words=mem, backend="fused",
                                     torch_device="cpu").list() \
            if s <= 12 else None
        emit({"list_scale": s, "mem_words": mem, "rows": len(rows),
              "s": wall, "boxes": st.n_boxes, "rescans": st.n_rescans,
              "list_launches": fops.LIST_LAUNCHES.n,
              "cpu_s": time.perf_counter() - t0,
              "cpu_equal": None if cpu is None
              else rows.tobytes() == cpu.tobytes()})
        if wall > 60:
            break
    if left() > 250:
        t0 = time.perf_counter()
        src, dst = rmat_graph(1 << 20, 16 << 20, seed=0)
        t_gen = time.perf_counter() - t0
        iops.LAUNCHES.reset()
        t0 = time.perf_counter()
        eng = QueryEngine.from_graph(patterns.triangle(), src, dst,
                                     mem_words=1 << 21)
        plan = eng.plan()
        t_plan = time.perf_counter() - t0
        t0 = time.perf_counter()
        count = eng.count()
        torch.cuda.synchronize()
        emit({"triangle20": count, "gen_s": t_gen, "plan_s": t_plan,
              "count_s": time.perf_counter() - t0, "boxes": len(plan.boxes),
              "intersect": iops.LAUNCHES.n})
    emit({"done": time.perf_counter() - t_start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
