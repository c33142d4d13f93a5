#!/usr/bin/env python3
"""Out-of-core count of the smoke's scale-20 RMAT store at several slice
cache budgets, on one NVIDIA card.

Ingests ``rmat_graph(2^20, 16·2^20, seed=0)`` (the smoke's rmat graph)
into an edge store in a temporary directory, then counts it with
``TriangleEngine(store=…, mem_words=2^21, degree_bins=True)`` at each
``--cache-words`` budget, in turns (``--rounds`` passes over the list),
and prints one JSON line per count: wall seconds, the I/O ledger (block
and word reads, cache hits, misses and hit words) and the host seconds of
the box fetches alone (``StreamingExecutor._fetch`` over the plan, no
lane). Run from the repository root:

    python3 scripts/outofcore_probe.py --cache-words 0,1048576,16777216
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache-words", default="0,1048576,16777216")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("outofcore_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import TriangleEngine
    from repro_torch.data.graphs import rmat_graph
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    src, dst = rmat_graph(1 << 20, 16 << 20, seed=0)
    budgets = [int(x) for x in args.cache_words.split(",")]
    with tempfile.TemporaryDirectory(prefix="outofcore-probe-") as tmp:
        path = Path(tmp) / "g.csr"
        t0 = time.perf_counter()
        TriangleEngine.ingest(path, (src, dst), mem_words=1 << 21)
        print(json.dumps({"nvidia_smi": smi, "edges": int(len(src)),
                          "ingest_s": time.perf_counter() - t0}),
              flush=True)
        for rnd in range(args.rounds):
            order = budgets if rnd % 2 == 0 else budgets[::-1]
            for cache_words in order:
                def engine():
                    return TriangleEngine(store=path, mem_words=1 << 21,
                                          degree_bins=True,
                                          cache_words=cache_words,
                                          workers=args.workers)
                eng = engine()
                ex = eng._make_executor()
                t0 = time.perf_counter()
                for box in eng.plan():
                    ex._fetch(box)
                fetch_s = time.perf_counter() - t0
                eng = engine()        # a cold cache and device for count()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                count = eng.count()
                torch.cuda.synchronize()
                s = eng.stats
                print(json.dumps({
                    "round": rnd, "cache_words": cache_words,
                    "workers": args.workers, "count": count,
                    "count_s": time.perf_counter() - t0,
                    "fetch_only_s": fetch_s, "boxes": s.n_boxes,
                    "block_reads": s.block_reads,
                    "word_reads": s.word_reads,
                    "cache_hits": s.cache_hits,
                    "cache_misses": s.cache_misses,
                    "cache_hit_words": s.cache_hit_words,
                    "cache_hit_rate": s.cache_hit_rate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
