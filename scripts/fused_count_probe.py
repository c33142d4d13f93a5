#!/usr/bin/env python3
"""Split the fused count's time on the card between its two launches.

Drives the main path's fused count calls and profiles the count kernel at
six of them:

* the largest triangle box of ``TriangleEngine(backend="fused")`` on
  chip_smoke.py's clustered graph (two 4096-vertex clusters, ``p_in=0.5``,
  ``mem_words=2^20``), with the work of its innermost depth: prefixes,
  probes (the scan of the narrowest bound rows) and the bound rows' mean
  lengths;
* the median and the largest (by atom words) ``QueryEngine`` four-clique
  and diamond boxes on ``backend="fused"`` at RMAT scale 13 (chip_smoke.py's
  query phase), and the diamond box of the smoke's median call (19,202
  atom words, or the nearest).

For each it prints ``launch_count``'s time between CUDA events (the call
as a whole) and, from ``torch.profiler``, the device time of each kernel
per call (``count_kernel``, ``tiles_kernel``, the partials' sum), the
count kernel's frontier region (``cap``) and grid, and the ptxas report of
the count kernels, the depth-0 rows and the constant rows of leading
starts-only depths (a diamond box ordered from w: every (w, x) is a
depth-1 entry) with their cross product and the chunks of ``cap`` entries
it takes, and ``launch_count`` once more with each of the sizing knobs
changed: sized as before (region and grid from the atom words alone, a
region of at least 2^16 entries, at least 16 blocks) and with regions of
2^22 entries. With
``--count-variant NAME`` the count kernels are built a second time with
``-DNAME`` (``LFTJ_COUNT_BLOCK_TILES``: the innermost depth on the
intersect kernel's block tiles instead of warp chunks) and every box is
timed with both libraries, own, variant, variant, own. Run from the
repository root on a machine with a CUDA card:

    python3 scripts/fused_count_probe.py [--count-variant NAME]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TRIANGLE = ((0, 1), (0, 2), (1, 2))


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


def device_ms(torch, fn, reps: int = 5) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:48]: ev.self_device_time_total / 1e3 / reps
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0}


def innermost_work(torch, prep) -> dict:
    """A triangle box's last frontier: its (x, y) prefixes, the probes of
    their narrowest bound rows, and the mean lengths of the two rows."""
    (kr, orr, vr), (ks, os_, _), (kt, ot, _) = prep[1]

    def degree(keys, off, v):
        pos = torch.searchsorted(keys, v).clamp_(max=keys.numel() - 1)
        return torch.where(keys[pos] == v, off[pos + 1] - off[pos],
                           torch.zeros_like(off[pos]))

    x = torch.repeat_interleave(kr, orr[1:] - orr[:-1])
    du, dv = degree(ks, os_, x), degree(kt, ot, vr)
    lo, hi = torch.minimum(du, dv), torch.maximum(du, dv)
    return {"prefixes": int(lo.numel()), "probes": int(lo.sum()),
            "narrow_mean": float(lo.double().mean()),
            "wide_mean": float(hi.double().mean())}


# the atom words of chip_smoke.py's median fused_count call (a diamond box)
SMOKE_MEDIAN_WORDS = 19202


def words_sizing(c0, csrs, max_grid):
    """(region, grid) as the count was sized before: from the depth-0 rows
    and atom values alone, a region of at least 2^16 entries, a block per
    4,096 of them and at least 16."""
    need = c0.numel() + sum(v.numel() for _, _, v in csrs)
    cap = min(1 << 22, max(1 << 16, 1 << max(0, need - 1).bit_length()))
    return cap, min(max_grid, max(16, -(-need // 4096)))


def knob_ms(torch, fops, prep) -> dict:
    """launch_count's ms (between CUDA events, and the device time of its
    kernels) with the count's sizing changed: as before (``words_sizing``)
    and with frontier regions of 2^22 entries (the most ``_COUNT_CAP``
    allows)."""
    cap, count_cap, coop = fops._COUNT_CAP, fops._count_cap, fops._coop_grid
    old = words_sizing(prep[2], prep[1], 1 << 20)
    out = {}
    try:
        for name in ("words_sizing", "region_2^22"):
            if name == "words_sizing":
                fops._count_cap = lambda *a: old[0]
                fops._coop_grid = lambda dev, key, query: min(
                    old[1], coop(dev, key, query))
            else:
                fops._COUNT_CAP = (cap[1], cap[1])
            out[name] = {"count": int(fops.launch_count(prep)),
                         "ms": cuda_ms(torch,
                                       lambda: fops.launch_count(prep)),
                         "device_ms": sum(device_ms(
                             torch, lambda: fops.launch_count(prep)
                         ).values())}
            fops._count_cap, fops._coop_grid = count_cap, coop
    finally:
        fops._COUNT_CAP = cap
        fops._count_cap, fops._coop_grid = count_cap, coop
    return out


def count_variant(fops, build, define: str):
    """(own, variant) count libraries: the tree's, and the same source
    built with ``-D<define>``; the own one stays loaded."""
    own = fops._library()
    flags = build.NVCC_FLAGS
    build.NVCC_FLAGS = flags + (f"-D{define}",)
    try:
        del build._libs["lftj_fused"]
        fops._lib = None
        variant = fops._library()
    finally:
        build.NVCC_FLAGS = flags
        build._libs["lftj_fused"] = own
        fops._lib = own
    return own, variant


def variant_ms(torch, fops, prep, libs) -> dict:
    """launch_count's ms and tiles_kernel's device ms with the own and the
    variant library, in the order own, variant, variant, own; the counts
    must agree."""
    want = int(fops.launch_count(prep))
    out = {"own": [], "variant": []}
    try:
        for which in ("own", "variant", "variant", "own"):
            fops._lib = libs[0] if which == "own" else libs[1]
            if int(fops.launch_count(prep)) != want:
                raise AssertionError(f"{which} count differs")
            dev = device_ms(torch, lambda: fops.launch_count(prep))
            out[which].append({
                "ms": cuda_ms(torch, lambda: fops.launch_count(prep)),
                "tiles_device_ms": sum(v for k, v in dev.items()
                                       if "tiles_kernel" in k)})
    finally:
        fops._lib = libs[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--count-variant", default=None,
                    help="a macro to build the count kernels a second time "
                    "with (LFTJ_COUNT_BLOCK_TILES: the innermost depth on "
                    "the intersect kernel's block tiles), timed beside the "
                    "tree's at every box")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fused_count_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch import TriangleEngine
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    from repro_torch.data.edgestore import InMemoryEdgeSource
    from repro_torch.data.graphs import clustered_graph, rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.lftj_fused import ops as fops
    from repro_torch.query import QueryEngine, patterns

    t0 = time.perf_counter()
    _build.build(["lftj_fused"])
    log = _build.BUILD_LOG.get("lftj_fused")
    emit({"build_s": time.perf_counter() - t0,
          "ptxas": "built before this run" if log is None else
          {k: v for k, v in chip_smoke.ptxas_report(log).items()
           if "count" in k or "tiles" in k}})
    libs = None
    if args.count_variant:
        libs = count_variant(fops, _build, args.count_variant)
        emit({"variant": args.count_variant, "ptxas": {
            k: v for k, v in chip_smoke.ptxas_report(
                _build.BUILD_LOG.get("lftj_fused", "")).items()
            if "tiles" in k}})
    calls = []
    orig = fops.fused_count

    def record(dims, csrs, n):
        calls.append((sum(int(k.numel()) + int(v.numel())
                          for k, _, v in csrs), tuple(dims), (dims, csrs, n)))
        return orig(dims, csrs, n)

    fops.fused_count = record
    src, dst = clustered_graph(2, 4096, seed=0, p_in=0.5)
    count = TriangleEngine(src, dst, mem_words=1 << 20,
                           backend="fused").count()
    triangle = max((c for c in calls if c[1] == TRIANGLE),
                   key=lambda c: c[0])
    emit({"run": "engine_fused", "count": count, "calls": len(calls)})
    calls.clear()
    src, dst = rmat_graph(1 << 13, 16 << 13, seed=0)
    a, b = orient_edges(src, dst)
    csr = csr_from_edges(a, b, n_nodes=int(max(a.max(), b.max())) + 1)
    count = QueryEngine(
        patterns.four_clique(),
        relations={"E": InMemoryEdgeSource(*csr, orientation="minmax")},
        mem_words=1 << 14, backend="fused", workers=1).count()
    emit({"run": "query_four_clique", "count": count, "calls": len(calls)})
    four = sorted(calls, key=lambda c: c[0])
    calls.clear()
    count = QueryEngine(
        patterns.diamond(),
        relations={"E": InMemoryEdgeSource(*csr, orientation="minmax")},
        mem_words=1 << 14, backend="fused", workers=1).count()
    emit({"run": "query_diamond", "count": count, "calls": len(calls)})
    diamond = sorted(calls, key=lambda c: c[0])
    fops.fused_count = orig
    smoke_median = min(diamond,
                       key=lambda c: abs(c[0] - SMOKE_MEDIAN_WORDS))
    for name, call in (("largest_triangle", triangle),
                       ("median_four_clique", four[(len(four) - 1) // 2]),
                       ("largest_four_clique", four[-1]),
                       ("median_diamond", diamond[(len(diamond) - 1) // 2]),
                       ("smoke_median_diamond", smoke_median),
                       ("largest_diamond", diamond[-1])):
        prep = fops._prepare(*call[2])
        c0, csrs = prep[2], prep[1]
        n_vars = max(sd for _, sd in call[1]) + 1
        leading = fops._leading(prep[0], n_vars, prep[3])
        cap = fops._count_cap(c0, csrs, leading)
        grid = fops._coop_grid(
            c0.device, n_vars,
            lambda out: fops._library().lftj_count_grid(n_vars, out))
        out = {"box": name, "atom_words": call[0], "cap": cap, "grid": grid,
               "count": int(fops.launch_count(prep)),
               "ms": cuda_ms(torch, lambda: fops.launch_count(prep)),
               "device_ms": device_ms(torch,
                                      lambda: fops.launch_count(prep))}
        if call[1] == TRIANGLE:
            out["innermost"] = innermost_work(torch, prep)
        front = int(c0.numel())
        for n in leading:
            front *= n
        out.update(dims=call[1], n0=int(c0.numel()), leading=leading,
                   cross_product=front, chunks=-(-front // cap))
        out["knobs"] = knob_ms(torch, fops, prep)
        if libs is not None:
            out["variant"] = variant_ms(torch, fops, prep, libs)
        emit(out)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
