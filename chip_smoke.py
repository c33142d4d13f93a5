#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``repro_torch.TriangleEngine.count()`` / ``.list()`` on the card,
builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, holds
every kernel against its plain PyTorch version, and checks the counts
against independent oracles. Every phase prints one JSON line; any failure
raises and exits non-zero. Run from the repository root:

    python3 chip_smoke.py                 # full run (one card)
    python3 chip_smoke.py --quick         # build + kernel checks only

Phases:
  1. device     — card name and power limit, kernel build (one nvcc per
                  source, in parallel) with the ptxas report.
  2. kernels    — each kernel against its plain version on ragged and edge
                  shapes (exact integer equality).
  3. rmat       — Graph500-style RMAT, ``backend="auto"`` on the card: the
                  intersect kernel must launch; the count must equal the
                  plain torch ``binary`` lane on the card.
  4. clustered  — triangle-rich planted-partition graph: the dense kernel
                  must launch; the int64 count (> 2^31) must equal an
                  independent per-cluster float64 oracle.
  5. listing    — ``list()`` on the card equals ``list()`` on the CPU byte
                  for byte, with forced rescans; counts equal the host lane
                  and a scipy-sparse oracle.
  6. timing     — each kernel at the largest inputs the main path gave it
                  (phases 3-5), against its plain version, a library call
                  where one exists, and its roofline bound.

The last three lines are the ``kernels`` JSON line, the ``nvidia-smi``
name/power-limit line and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, int8
# tensor-core rate, and the float32 rate outside the tensor cores (used as
# the scalar integer-operation peak of the intersect kernel)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SCALAR_OPS_PER_S = 67e12

# the main-path graphs (sizes and the reasons for them are in PERF.md §4):
# Graph500-style RMAT at scale 20 with edge factor 16, planned at 2^21
# words (2^22 leaves no box in the intersect band); two 4096-vertex
# clusters at p_in = 0.5 (~2.86e9 triangles, above 2^31, and a vertex
# count small enough for the dense lane's feasibility guard); the listing
# graph, RMAT at scale 16
RMAT_SCALE, RMAT_MEM_WORDS = 20, 1 << 21
CLUSTERS, CLUSTER_SIZE, P_IN, CLUSTERED_MEM_WORDS = 2, 4096, 0.5, 1 << 20
LIST_SCALE, LIST_MEM_WORDS = 16, 1 << 18
TIMING_REPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    import torch
    for _ in range(warmup):
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


class Recorder:
    """Wraps a kernel wrapper in its ops module: records the shapes of every
    call the main path makes and keeps the inputs of the largest one."""

    def __init__(self, module, attr: str, size):
        self.module, self.attr, self.size = module, attr, size
        self.orig = getattr(module, attr)
        self.shapes = Counter()
        self.largest = None
        self.largest_size = -1
        setattr(module, attr, self)

    def summary(self) -> dict:
        """Launch count, distinct shapes, and the largest extent of every
        argument dimension over the recorded calls."""
        dims = {}
        for shape in self.shapes:
            for i, s in enumerate(shape):
                for j, n in enumerate(s):
                    dims[f"arg{i}.dim{j}"] = max(dims.get(f"arg{i}.dim{j}", 0),
                                                 n)
        largest = None if self.largest is None else \
            [list(a.shape) for a in self.largest if a is not None]
        return {"calls": sum(self.shapes.values()),
                "distinct_shapes": len(self.shapes), "max_extent": dims,
                "largest": largest}

    def __call__(self, *args, **kw):
        shape = tuple(tuple(a.shape) for a in args if a is not None)
        self.shapes[shape] += 1
        size = self.size(*args)
        if size > self.largest_size:
            self.largest_size, self.largest = size, args
        return self.orig(*args, **kw)


def profile_count(torch, eng, label: str, top: int = 10) -> dict:
    """Device time by kernel name over one more ``eng.count()`` under
    ``torch.profiler``; ``idle_share`` is the share of the wall time in
    which no kernel or copy ran."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.count()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the operator
    # events that launched them report the same time again
    rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"phase": "profile", "of": label, "wall_ms": wall_ms,
            "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
            "top": [{"name": k[:80], "calls": c, "ms": ms}
                    for ms, k, c in rows[:top]]}


def lane_stats(stats) -> dict:
    return {"binary": stats.n_binary_boxes, "dense": stats.n_dense_boxes,
            "intersect": stats.n_intersect_boxes, "host": stats.n_host_boxes}


def reset_launches(*ops) -> None:
    for op in ops:
        op.LAUNCHES.reset()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions on ragged and edge shapes
# ---------------------------------------------------------------------------

def sorted_rows(rng, e: int, k: int, hi: int, np):
    """(e, k) int32 rows: sorted distinct values < hi, SENTINEL-padded, of
    random real length (empty and full rows included)."""
    out = np.full((e, k), 2 ** 31 - 1, np.int32)
    lens = rng.integers(0, min(k, hi) + 1, size=e)
    lens[:: 7] = 0
    lens[1:: 11] = min(k, hi)
    for i, n in enumerate(lens):
        out[i, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    return out


def phase_kernel_cases(torch, np, intersect_ops, dense_ops) -> dict:
    from repro_torch.kernels.intersect.ref import intersect_count_ref
    from repro_torch.kernels.triangle_dense.ref import triangle_count_ref
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    n_cases = 0
    for e, ka, kb, hi in ((1, 1, 1, 4), (37, 13, 100, 120),
                          (1000, 128, 128, 500), (513, 300, 7, 900),
                          (4099, 1024, 33, 5000)):
        a = torch.from_numpy(sorted_rows(rng, e, ka, hi, np)).to(dev)
        b = torch.from_numpy(sorted_rows(rng, e, kb, hi, np)).to(dev)
        got = intersect_ops.intersect_count(a, b)
        want = intersect_count_ref(a, b)
        assert torch.equal(got, want), ("intersect", e, ka, kb)
        # index form: random pairs of rows, as the engine lane passes them
        ia = torch.from_numpy(rng.integers(0, e, 3 * e).astype(np.int32))
        ib = torch.from_numpy(rng.integers(0, e, 3 * e).astype(np.int32))
        ia, ib = ia.to(dev), ib.to(dev)
        got = intersect_ops.intersect_count(a, b, ia, ib)
        want = intersect_count_ref(a, b, ia, ib)
        assert torch.equal(got, want), ("intersect idx", e, ka, kb)
        n_cases += 2
    for nx, ny, d, p in ((1, 7, 64, 0.3), (100, 140, 300, 0.15),
                         (257, 129, 641, 0.2), (64, 64, 1, 0.5),
                         (65, 3, 4099, 0.9), (300, 500, 2, 1.0)):
        a = torch.from_numpy((rng.random((nx, d)) < p).astype(np.uint8))
        b = torch.from_numpy((rng.random((ny, d)) < p).astype(np.uint8))
        m = torch.from_numpy((rng.random((nx, ny)) < 0.5).astype(np.uint8))
        a, b, m = a.to(dev), b.to(dev), m.to(dev)
        got = dense_ops.triangle_count(a, b, m)
        want = triangle_count_ref(a, b, m)
        assert int(got) == int(want), ("dense", nx, ny, d, int(got),
                                       int(want))
        # a view offset by one byte takes the kernel's unaligned loads
        buf = torch.zeros(nx * d + 1, dtype=torch.uint8, device=dev)
        a_off = buf[1:].view(nx, d)
        a_off.copy_(a)
        assert int(dense_ops.triangle_count(a_off, b, m)) == int(want)
        n_cases += 2
    torch.cuda.synchronize()
    return {"phase": "kernels", "cases": n_cases, "exact": True}


# ---------------------------------------------------------------------------
# phases 3-5: the main path through TriangleEngine
# ---------------------------------------------------------------------------

def phase_rmat(torch, np, intersect_ops, dense_ops, scale: int,
               mem_words: int, profile: bool) -> dict:
    from repro_torch.core.engine import TriangleEngine
    from repro_torch.data.graphs import rmat_graph
    t0 = time.perf_counter()
    src, dst = rmat_graph(1 << scale, 16 << scale, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = TriangleEngine(src, dst, mem_words=mem_words)
    eng.plan()
    t_plan = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(intersect_ops, dense_ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"intersect": intersect_ops.LAUNCHES.n,
                "triangle_dense": dense_ops.LAUNCHES.n}
    stats = eng.stats
    assert stats.n_intersect_boxes > 0, lane_stats(stats)
    assert launches["intersect"] > 0, launches
    peak = torch.cuda.max_memory_allocated()
    if profile:
        emit(profile_count(torch, eng, "rmat"))
    eng.backend = "binary"
    t0 = time.perf_counter()
    want = eng.count()
    torch.cuda.synchronize()
    wall_binary = time.perf_counter() - t0
    assert count == want, (count, want)
    return {"phase": "rmat", "scale": scale, "edges": int(len(src)),
            "mem_words": mem_words, "boxes": stats.n_boxes,
            "lanes": lane_stats(stats), "count": count,
            "count_binary_lane": want, "launches": launches,
            "device_invocations": stats.device_invocations,
            "padded_words": stats.padded_words,
            "actual_words": stats.actual_words, "gen_s": t_gen,
            "plan_s": t_plan, "count_s": wall, "binary_count_s": wall_binary,
            "max_memory_allocated": peak}


def cluster_oracle(torch, src, dst, n_clusters: int, size: int) -> int:
    """Σ over clusters of Σ A_c ⊙ (A_c A_cᵀ) on each oriented size×size
    block, in float64 on the card; the inter-cluster chain closes no
    triangle."""
    dev = torch.device("cuda")
    a = torch.from_numpy(src).to(dev)
    b = torch.from_numpy(dst).to(dev)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    same = (lo // size) == (hi // size)
    lo, hi = lo[same], hi[same]
    total = 0
    for c in range(n_clusters):
        sel = (lo // size) == c
        blk = torch.zeros((size, size), dtype=torch.float64, device=dev)
        blk[lo[sel] - c * size, hi[sel] - c * size] = 1.0
        total += int((blk * (blk @ blk.T)).sum().item())
    return total


def phase_clustered(torch, np, intersect_ops, dense_ops, n_clusters: int,
                    size: int, p_in: float, mem_words: int,
                    profile: bool) -> dict:
    from repro_torch.core.engine import TriangleEngine
    from repro_torch.data.graphs import clustered_graph
    t0 = time.perf_counter()
    src, dst = clustered_graph(n_clusters, size, seed=0, p_in=p_in)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = TriangleEngine(src, dst, mem_words=mem_words)
    eng.plan()
    t_plan = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(intersect_ops, dense_ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"intersect": intersect_ops.LAUNCHES.n,
                "triangle_dense": dense_ops.LAUNCHES.n}
    stats = eng.stats
    assert stats.n_dense_boxes > 0, lane_stats(stats)
    assert launches["triangle_dense"] > 0, launches
    peak = torch.cuda.max_memory_allocated()
    if profile:
        emit(profile_count(torch, eng, "clustered"))
    want = cluster_oracle(torch, src, dst, n_clusters, size)
    assert count == want, (count, want)
    assert count > 2 ** 31, count
    return {"phase": "clustered", "clusters": n_clusters,
            "cluster_size": size, "p_in": p_in, "edges": int(len(src)),
            "mem_words": mem_words, "boxes": stats.n_boxes,
            "lanes": lane_stats(stats), "count": count, "oracle": want,
            "launches": launches,
            "device_invocations": stats.device_invocations,
            "gen_s": t_gen, "plan_s": t_plan, "count_s": wall,
            "max_memory_allocated": peak}


def phase_listing(torch, np, intersect_ops, dense_ops, scale: int,
                  mem_words: int) -> dict:
    import scipy.sparse as sp
    from repro_torch.core.engine import TriangleEngine
    from repro_torch.core.lftj_torch import orient_edges
    from repro_torch.data.graphs import rmat_graph
    src, dst = rmat_graph(1 << scale, 16 << scale, seed=1)
    reset_launches(intersect_ops, dense_ops)
    eng = TriangleEngine(src, dst, mem_words=mem_words)
    t0 = time.perf_counter()
    count = eng.count()
    t_count = time.perf_counter() - t0
    count_lanes = lane_stats(eng.stats)
    t0 = time.perf_counter()
    tris = eng.list()
    t_list = time.perf_counter() - t0
    rescans_default = eng.stats.n_rescans
    # a capacity well below the mean per-box total forces rescans in the
    # boxes above it
    cap = max(1, min(256, count // (4 * max(1, eng.stats.n_boxes))))
    forced = eng.list(capacity=cap)
    rescans_forced = eng.stats.n_rescans
    launches = {"intersect": intersect_ops.LAUNCHES.n,
                "triangle_dense": dense_ops.LAUNCHES.n}
    assert rescans_forced > 0, rescans_forced
    assert forced.tobytes() == tris.tobytes()
    assert len(tris) == count, (len(tris), count)
    t0 = time.perf_counter()
    cpu = TriangleEngine(src, dst, mem_words=mem_words, torch_device="cpu")
    tris_cpu = cpu.list()
    t_cpu = time.perf_counter() - t0
    assert tris.dtype == tris_cpu.dtype and tris.shape == tris_cpu.shape
    assert tris.tobytes() == tris_cpu.tobytes()
    eng.backend = "host"
    count_host = eng.count()
    assert count_host == count, (count_host, count)
    a, b = orient_edges(src, dst)
    n = int(max(a.max(), b.max())) + 1
    adj = sp.csr_matrix((np.ones(len(a), np.int64), (a, b)), shape=(n, n))
    oracle = int(adj.multiply(adj @ adj.T).sum())
    assert oracle == count, (oracle, count)
    return {"phase": "listing", "scale": scale, "edges": int(len(src)),
            "mem_words": mem_words, "count": count, "listed": len(tris),
            "count_lanes": count_lanes, "launches": launches,
            "rescans_default": rescans_default,
            "forced_capacity": cap, "rescans_forced": rescans_forced,
            "count_s": t_count, "list_s": t_list, "cpu_list_s": t_cpu,
            "count_host_lane": count_host, "scipy_oracle": oracle}


# ---------------------------------------------------------------------------
# phase 6: kernel timing at the main path's largest inputs
# ---------------------------------------------------------------------------

def time_intersect(torch, rec, launches: int, reps: int) -> dict:
    from repro_torch.kernels.intersect.ref import intersect_count_ref
    a, b, ia, ib = rec.largest
    got = rec.orig(a, b, ia, ib)
    want = intersect_count_ref(a, b, ia, ib)
    err = int((got.long() - want.long()).abs().max()) if len(got) else 0
    ms = cuda_ms(lambda: rec.orig(a, b, ia, ib), reps)
    plain_ms = cuda_ms(lambda: intersect_count_ref(a, b, ia, ib),
                       max(1, reps // 10))
    # least bytes: each referenced row's real entries once, the two index
    # vectors and the output; least operations: one probe step per
    # narrower-row element per level of the wider row's binary search
    deg = (a != 2 ** 31 - 1).sum(dim=1)
    rows = torch.unique(torch.cat([ia, ib]).long())
    du, dv = deg[ia.long()], deg[ib.long()]
    lo, hi = torch.minimum(du, dv), torch.maximum(du, dv)
    steps = torch.ceil(torch.log2(hi.double() + 1))
    n_bytes = 4 * int(deg[rows].sum()) + 4 * (len(ia) + len(ib) + len(got))
    n_ops = float((lo.double() * steps).sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return {"name": "intersect", "route": "cuda",
            "source": "src/repro_torch/csrc/intersect.cu",
            "replaces": "src/repro/kernels/intersect/kernel.py:33",
            "launches": launches, "max_abs_err": err, "exact": err == 0,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "shape": {"a": list(a.shape), "b": list(b.shape),
                      "pairs": int(len(ia))},
            "bytes": n_bytes, "ops": n_ops}


def time_dense(torch, rec, launches: int, reps: int) -> dict:
    from repro_torch.kernels.triangle_dense.ref import triangle_count_ref
    a, b, m = rec.largest
    got = int(rec.orig(a, b, m))
    want = int(triangle_count_ref(a, b, m))
    ms = cuda_ms(lambda: rec.orig(a, b, m), reps)
    plain_ms = cuda_ms(lambda: triangle_count_ref(a, b, m), reps)
    # one PyTorch call computing the same function: a float32 product (TF32
    # off, so every partial sum below 2^24 is exact) and the masked sum
    torch.backends.cuda.matmul.allow_tf32 = False
    af, bf, mf = a.float(), b.float(), m.float()
    lib_ms = cuda_ms(lambda: (mf * (af @ bf.T)).sum(), reps)
    nx, d = a.shape
    ny = b.shape[0]
    n_bytes = nx * d + ny * d + nx * ny + 8
    n_ops = 2.0 * nx * ny * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return {"name": "triangle_dense", "route": "cuda",
            "source": "src/repro_torch/csrc/triangle_dense.cu",
            "replaces": "src/repro/kernels/triangle_dense/kernel.py:29",
            "launches": launches, "max_abs_err": abs(got - want),
            "exact": got == want, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "shape": {"a": list(a.shape), "b": list(b.shape)},
            "bytes": n_bytes, "ops": n_ops}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel checks only")
    ap.add_argument("--phases", default="rmat,clustered,listing",
                    help="main-path phases to run (default: all three)")
    ap.add_argument("--profile", action="store_true",
                    help="repeat the rmat and clustered counts under "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.intersect import ops as intersect_ops
    from repro_torch.kernels.triangle_dense import ops as dense_ops

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.BUILD_LOG.items()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_flags": list(_build.NVCC_FLAGS),
          "ptxas": ptxas})
    emit(phase_kernel_cases(torch, np, intersect_ops, dense_ops))

    kernels = []
    if not args.quick:
        rec_i = Recorder(intersect_ops, "intersect_count",
                         lambda a, b, ia=None, ib=None:
                         (len(ia) if ia is not None else a.shape[0])
                         * max(a.shape[1], b.shape[1]))
        rec_d = Recorder(dense_ops, "triangle_count",
                         lambda a, b, m: a.shape[0] * b.shape[0]
                         * a.shape[1])
        phases = {
            "rmat": lambda: phase_rmat(
                torch, np, intersect_ops, dense_ops, RMAT_SCALE,
                RMAT_MEM_WORDS, args.profile),
            "clustered": lambda: phase_clustered(
                torch, np, intersect_ops, dense_ops, CLUSTERS, CLUSTER_SIZE,
                P_IN, CLUSTERED_MEM_WORDS, args.profile),
            "listing": lambda: phase_listing(
                torch, np, intersect_ops, dense_ops, LIST_SCALE,
                LIST_MEM_WORDS),
        }
        runs = []
        for name in args.phases.split(","):
            t0 = time.perf_counter()
            runs.append(phases[name]())
            runs[-1]["phase_s"] = time.perf_counter() - t0
            emit(runs[-1])
        launches = {k: sum(r["launches"][k] for r in runs)
                    for k in ("intersect", "triangle_dense")}
        emit({"phase": "launch_shapes",
              "intersect": rec_i.summary(), "triangle_dense": rec_d.summary()})
        kernels = []
        if rec_i.largest is not None:
            kernels.append(time_intersect(torch, rec_i,
                                          launches["intersect"], TIMING_REPS))
        if rec_d.largest is not None:
            kernels.append(time_dense(torch, rec_d,
                                      launches["triangle_dense"], TIMING_REPS))
        for k in kernels:
            assert k["exact"], k
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
