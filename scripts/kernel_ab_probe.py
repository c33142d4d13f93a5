#!/usr/bin/env python3
"""Time the intersect and fused-listing paths of one ``repro_torch`` tree on
the card, so that two trees (a parent commit unpacked beside the checkout,
and the checkout) can be compared in one call on one card.

Runs, each on a graph made from a fixed seed:

* ``listing``: ``QueryEngine`` four-clique ``list()`` on ``backend="fused"``
  at RMAT scale 12 (chip_smoke.py's query_listing phase): the wall of a
  warm ``list()``, and ``fused_ops.launch_list`` timed with CUDA events at
  the largest (by rows) and the median ``fused_list`` call it made;
* ``query_triangle``: ``QueryEngine`` triangle count on ``auto`` (8
  workers) at RMAT scale ``--scale``: the wall of a warm ``count()``, and
  ``intersect_count_rows`` timed at its largest and median call;
* ``engine_intersect``: ``TriangleEngine(backend="intersect")`` count at
  RMAT scale ``--scale``: the wall of a warm ``count()``, and the lane's
  intersect call timed at its largest and median box;
* ``rmat_box``: ``TriangleEngine`` on ``auto`` at RMAT scale 20 with
  ``mem_words=2^21`` (chip_smoke.py's rmat phase): the lane's intersect
  call timed at its largest box (the smoke's "rmat box") and its median
  box.

A box's intersect call is timed as the tree's own lane makes it: through
``intersect_count_csr`` on the box's compact CSR where the tree has that
wrapper, else through ``intersect_count`` on the box's padded matrix
(built before the timing).

Counts and listing sizes are printed so the trees can be checked against
each other. One JSON line per run, tagged with ``--tag``. Run from the
repository root on a machine with a CUDA card, e.g. parent, change, change,
parent:

    python3 scripts/kernel_ab_probe.py --src build/parent/src --tag parent
    python3 scripts/kernel_ab_probe.py --tag change

``--runs`` picks the runs (default: listing, query_triangle,
engine_intersect).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Calls:
    """Wraps ``module.attr``: keeps every call's arguments with a size."""

    def __init__(self, module, attr: str, size):
        self.module, self.attr, self.size = module, attr, size
        self.orig = getattr(module, attr)
        self.calls = []
        setattr(module, attr, self)

    def __call__(self, *args, **kw):
        out = self.orig(*args, **kw)
        self.calls.append((self.size(args, out), args, kw))
        return out

    def pick(self):
        """(largest, median) calls by size."""
        ranked = sorted(self.calls, key=lambda c: c[0])
        return ranked[-1], ranked[(len(ranked) - 1) // 2]

    def restore(self):
        setattr(self.module, self.attr, self.orig)


class Boxes:
    """Wraps ``StreamingExecutor._count_intersect``: keeps the slice of
    the largest box (by in-box edges) and the first slice of each
    power-of-two size bucket, for the median."""

    def __init__(self, cls):
        self.cls, self.orig = cls, cls._count_intersect
        self.sizes, self.by_bucket, self.largest = [], {}, None
        boxes = self

        def record(executor, slc):
            boxes.sizes.append(slc.n_edges)
            boxes.by_bucket.setdefault(slc.n_edges.bit_length(), slc)
            if boxes.largest is None or slc.n_edges > boxes.largest.n_edges:
                boxes.largest = slc
            return boxes.orig(executor, slc)

        cls._count_intersect = record

    def pick(self):
        """(largest, median) slices."""
        med = statistics.median_low(self.sizes)
        return self.largest, self.by_bucket[med.bit_length()]

    def restore(self):
        self.cls._count_intersect = self.orig


def box_call(torch, iops, slc, dev):
    """The tree's own intersect call for one box, as its lane makes it."""
    eu, ev = slc.edges(dev)
    if hasattr(iops, "intersect_count_csr"):
        off = torch.from_numpy(slc.row_off).to(dev)
        vals = torch.from_numpy(slc.row_vals).to(dev)
        args = (off, vals, eu.long(), off, vals, ev.long())
        return lambda: iops.intersect_count_csr(*args)
    npad, _ = slc.padded(dev)
    return lambda: iops.intersect_count(npad, npad, eu, ev).sum(
        dtype=torch.int64)


def time_boxes(torch, iops, boxes) -> dict:
    """ms of the lane's intersect call at the largest and median box."""
    dev = torch.device("cuda")
    out = {"boxes": len(boxes.sizes)}
    for name, slc in zip(("largest", "median"), boxes.pick()):
        fn = box_call(torch, iops, slc, dev)
        out[name] = {"edges": int(slc.n_edges),
                     "pad_shape": list(slc.pad_shape),
                     "count": int(fn()), "ms": cuda_ms(torch, fn)}
    return out


def walled(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the tree to time")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--runs", default="listing,query_triangle,"
                    "engine_intersect",
                    help="comma list of listing, query_triangle, "
                    "engine_intersect, rmat_box")
    args = ap.parse_args()
    runs = set(args.runs.split(","))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import TriangleEngine
    from repro_torch.core.executor import StreamingExecutor
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    from repro_torch.data.edgestore import InMemoryEdgeSource
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels.intersect import ops as iops
    from repro_torch.kernels.lftj_fused import ops as fops
    from repro_torch.query import QueryEngine, patterns
    tag = {"tag": args.tag, "package": str(Path(repro_torch.__file__)
                                           .resolve().parent)}

    def relations(src, dst):
        a, b = orient_edges(src, dst)
        csr = csr_from_edges(a, b, n_nodes=int(max(a.max(), b.max())) + 1)
        return {"E": InMemoryEdgeSource(*csr, orientation="minmax")}

    if "listing" in runs:
        src, dst = rmat_graph(1 << 12, 16 << 12, seed=1)
        eng = QueryEngine(patterns.four_clique(),
                          relations=relations(src, dst), mem_words=1 << 14,
                          backend="fused")
        eng.list()
        calls = Calls(fops, "fused_list", lambda a, out: len(out[1]))
        rows, wall = walled(torch, eng.list)
        calls.restore()
        timed = {}
        for name, (size, (dims, csrs, n), kw) in zip(("largest", "median"),
                                                     calls.pick()):
            prep = fops._prepare(dims, csrs, n)
            cap = kw["capacity"]
            timed[name] = {"rows": size, "capacity": cap,
                           "ms": cuda_ms(torch,
                                         lambda: fops.launch_list(prep, cap))}
        emit(dict(tag, run="listing", rows=len(rows), list_s=wall,
                  calls=len(calls.calls), launch_list=timed))

    if runs & {"query_triangle", "engine_intersect"}:
        src, dst = rmat_graph(1 << args.scale, 16 << args.scale, seed=0)
    if "query_triangle" in runs:
        eng = QueryEngine(patterns.triangle(), relations=relations(src, dst),
                          mem_words=1 << (args.scale + 1), workers=8)
        eng.count()
        calls = Calls(iops, "intersect_count_rows",
                      lambda a, out: int(a[2].numel()))
        count, wall = walled(torch, eng.count)
        calls.restore()
        timed = {}
        for name, (size, a, kw) in zip(("largest", "median"), calls.pick()):
            timed[name] = {"pairs": size,
                           "ms": cuda_ms(torch,
                                         lambda: iops.intersect_count_rows(
                                             *a))}
        emit(dict(tag, run="query_triangle", scale=args.scale, count=count,
                  count_s=wall, calls=len(calls.calls),
                  intersect_count_rows=timed))

    if "engine_intersect" in runs:
        # every box through the intersect lane
        eng = TriangleEngine(src, dst, mem_words=1 << (args.scale + 1),
                             backend="intersect")
        eng.count()
        boxes = Boxes(StreamingExecutor)
        count, wall = walled(torch, eng.count)
        boxes.restore()
        emit(dict(tag, run="engine_intersect", scale=args.scale, count=count,
                  count_s=wall, boxes=eng.stats.n_boxes,
                  intersect_boxes=eng.stats.n_intersect_boxes,
                  box_call=time_boxes(torch, iops, boxes)))

    if "rmat_box" in runs:
        src, dst = rmat_graph(1 << 20, 16 << 20, seed=0)
        eng = TriangleEngine(src, dst, mem_words=1 << 21)
        eng.plan()
        boxes = Boxes(StreamingExecutor)
        count, wall = walled(torch, eng.count)
        boxes.restore()
        emit(dict(tag, run="rmat_box", count=count, count_s=wall,
                  intersect_boxes=eng.stats.n_intersect_boxes,
                  box_call=time_boxes(torch, iops, boxes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
