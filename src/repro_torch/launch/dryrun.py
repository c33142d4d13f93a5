"""Dry run of the distributed box fabric: plan, schedule and lay out a
fabric without running a shard.

The port of the reference's ``fabric_dryrun`` and the ``--fabric`` branch
of its ``main`` (``src/repro/launch/dryrun.py:268-293``, ``:305-312``).
Nothing here launches a kernel or touches a card: the ``Fabric`` is built
with ``torch_device="cpu"`` because no shard executes, only the planner's
host work (plan, LPT schedule, shipped byte ranges) runs, so this works on
a host with no accelerator at all.

Usage:
  python -m repro_torch.launch.dryrun --fabric [--fabric-shards N] [--out DIR]

The reference module's model cells (lower + compile every arch × shape ×
mesh, with an HLO roofline against a TPU) and its import-time
``XLA_FLAGS`` guard are not part of the port: no XLA flag carries over,
and the model cells wait for the model slices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def fabric_dryrun(out_dir: Path, *, n_shards: int = 4,
                  pattern: str = "triangle", nv: int = 96, ne: int = 400,
                  mem_words: int = 1 << 12, seed: int = 7) -> dict:
    """Smoke the distributed box fabric's planning path without touching
    any device: plan the query, schedule boxes over ``n_shards`` host
    partitions, and record the shipped byte-range layout per shard in
    ``out_dir/fabric__<pattern>__s<n_shards>.json``. No shard is executed
    and no mesh is built (the ``Fabric``'s device is the CPU, which only
    the shards would use)."""
    from repro_torch.data.graphs import random_graph
    from repro_torch.parallel.fabric import Fabric
    from repro_torch.query.patterns import PATTERNS

    t0 = time.time()
    src, dst = random_graph(nv, ne, seed=seed)
    fab = Fabric.from_graph(PATTERNS[pattern](), src, dst,
                            n_shards=n_shards, mem_words=mem_words,
                            torch_device="cpu")
    rec = fab.describe()
    rec.update(ok=True, pattern=pattern, nv=int(nv), ne=int(ne),
               wall_s=round(time.time() - t0, 2))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"fabric__{pattern}__s{n_shards}"
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    print(f"[OK] {tag} boxes={rec['n_boxes']} shards={rec['n_shards']} "
          f"wall={rec['wall_s']}s", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--fabric", action="store_true",
                    help="smoke the box-fabric planning path (no devices)")
    ap.add_argument("--fabric-shards", type=int, default=4)
    args = ap.parse_args(argv)
    if not args.fabric:
        ap.error("only the fabric dry run (--fabric) is ported")
    rec = fabric_dryrun(Path(args.out), n_shards=args.fabric_shards)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
