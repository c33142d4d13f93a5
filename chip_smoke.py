#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``repro_torch.TriangleEngine.count()`` / ``.list()`` on the card,
builds the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, holds
every kernel against its plain PyTorch version, and checks the counts
against independent oracles. Every phase prints one JSON line; any failure
raises and exits non-zero. Each main-path phase sets every kernel's launch
count to 0 just before it drives the engine and reads the counts just
after. Run from the repository root:

    python3 chip_smoke.py                 # full run (one card)
    python3 chip_smoke.py --quick         # build + kernel checks only

Phases:
  1. device     — card name and power limit, kernel build (one nvcc per
                  source, in parallel) with the ptxas report.
  2. kernels    — each kernel against its plain version on ragged and edge
                  shapes (exact integer equality); the fused kernel also
                  against the scalar ``fused_ref`` on triangle, four-clique
                  and diamond atoms over ER, RMAT and star graphs.
  3. rmat       — Graph500-style RMAT, ``backend="auto"`` on the card: the
                  intersect kernel must launch; the count must equal the
                  plain torch ``binary`` lane on the card.
  4. clustered  — triangle-rich planted-partition graph: the dense kernel
                  must launch; the int64 count (> 2^31) must equal an
                  independent per-cluster float64 oracle.
  5. listing    — ``list()`` on the card equals ``list()`` on the CPU byte
                  for byte, with forced rescans; counts equal the host lane
                  and a scipy-sparse oracle.
  6. skew       — phase 3's graph, hub-first labels, ``skew="heavy_light"``:
                  hub boxes past the one-hot cap launch the fused kernel,
                  light and mixed boxes take the host lane; the count must
                  equal phase 3's.
  7. fused      — ``backend="fused"`` on phase 4's and phase 5's graphs:
                  the counts must equal their oracles.
  8. timing     — each kernel at the largest inputs the main path gave it
                  (phases 3-7), against its plain version, a library call
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
# the skew phase's worker threads: the host lane it routes light and mixed
# boxes to is numpy, which releases the GIL
SKEW_WORKERS = 8
TIMING_REPS = 20
# the fused kernel's plain version is timed on the largest main-path input
# whose padded (R, K) atoms hold at most this many words
FUSED_PLAIN_WORDS_CAP = 1 << 30



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


def tensor_shapes(*args):
    return tuple(tuple(a.shape) for a in args if a is not None)


class Recorder:
    """Wraps a kernel wrapper in its ops module: records the shapes of every
    call the main path makes and keeps the inputs of the largest one (and,
    with ``fits``, of the largest one ``fits`` accepts)."""

    def __init__(self, module, attr: str, size, shape=tensor_shapes,
                 fits=None):
        self.module, self.attr, self.size = module, attr, size
        self.shape, self.fits = shape, fits
        self.orig = getattr(module, attr)
        self.shapes = Counter()
        self.largest = None
        self.largest_size = -1
        self.largest_fitting = None
        self.largest_fitting_size = -1
        setattr(module, attr, self)

    def summary(self) -> dict:
        """Call count, distinct shapes, and the largest extent of every
        argument dimension over the recorded calls."""
        dims = {}
        for shape in self.shapes:
            for i, s in enumerate(shape):
                for j, n in enumerate(s):
                    dims[f"arg{i}.dim{j}"] = max(dims.get(f"arg{i}.dim{j}", 0),
                                                 n)
        largest = None if self.largest is None else self.shape(*self.largest)
        return {"calls": sum(self.shapes.values()),
                "distinct_shapes": len(self.shapes), "max_extent": dims,
                "largest": largest}

    def __call__(self, *args, **kw):
        self.shapes[self.shape(*args)] += 1
        size = self.size(*args)
        if size > self.largest_size:
            self.largest_size, self.largest = size, args
        if self.fits is not None and size > self.largest_fitting_size \
                and self.fits(*args):
            self.largest_fitting_size, self.largest_fitting = size, args
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
            "intersect": stats.n_intersect_boxes, "host": stats.n_host_boxes,
            "fused": stats.n_fused_boxes}


def reset_launches(ops: dict) -> None:
    for op in ops.values():
        op.LAUNCHES.reset()


def read_launches(ops: dict) -> dict:
    return {name: op.LAUNCHES.n for name, op in ops.items()}


def state_of(eng) -> dict:
    """An engine's CSR and box plan, for ``engine_from_state``: a later
    phase reuses a graph without generating or planning it again."""
    return {"indptr": eng.indptr, "indices": eng.indices,
            "orientation": eng.orientation, "nv": eng.nv,
            "plan": eng.plan()}


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
    return {"phase": "kernels", "of": ["intersect", "triangle_dense"],
            "cases": n_cases, "exact": True}


# atom shapes over the variable order, as the reference's query planner
# emits them: the diamond leaves variable 1 starts-only
FUSED_DIMS = {
    "triangle": ((0, 1), (0, 2), (1, 2)),
    "four_clique": ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
    "diamond": ((1, 2), (1, 3), (0, 2), (0, 3)),
}
TRIANGLE = FUSED_DIMS["triangle"]


def er_graph(np, n: int, p: float, seed: int):
    rng = np.random.default_rng(seed)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < p, k=1))
    return src.astype(np.int64), dst.astype(np.int64)


def star_graph(np, hubs: int, leaves: int, seed: int):
    """A few hubs adjacent to every leaf plus a sprinkle of leaf-leaf
    edges: a couple of huge rows over tiny ones."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(hubs), leaves)
    dst = hubs + np.tile(np.arange(leaves), hubs)
    extra = rng.integers(hubs, hubs + leaves, size=(leaves, 2))
    extra = extra[extra[:, 0] < extra[:, 1]]
    uniq = np.unique(np.concatenate([src, extra[:, 0]]) * (hubs + leaves)
                     + np.concatenate([dst, extra[:, 1]]))
    return uniq // (hubs + leaves), uniq % (hubs + leaves)


def graph_csr(np, src, dst):
    """Oriented (u < v) adjacency as (keys, off, vals) compact CSR."""
    u, v = np.minimum(src, dst), np.maximum(src, dst)
    keep = u != v
    stride = int(max(v.max(initial=0), 1)) + 1
    uniq = np.unique(u[keep] * stride + v[keep])
    u, v = uniq // stride, uniq % stride
    keys, counts = np.unique(u, return_counts=True)
    off = np.concatenate([np.zeros(1, np.int64),
                          np.cumsum(counts, dtype=np.int64)])
    return keys.astype(np.int64), off, v.astype(np.int32)


def phase_fused_cases(torch, np, fused_ops) -> dict:
    """The fused kernel against its plain version on the card and against
    the scalar oracle ``fused_ref``: every pattern on every graph, plus an
    empty frontier, an empty starts-only depth, one depth-0 row with a
    hub-sized depth-1 list, and two-variable patterns."""
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels.lftj_fused.ref import fused_count_ref, fused_ref
    dev = torch.device("cuda")

    def on_card(csrs):
        return [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in csr) for csr in csrs]

    def check(dims, csrs, want=None):
        n = max(sd for _, sd in dims) + 1
        card = on_card(csrs)
        before = fused_ops.LAUNCHES.n
        got = fused_ops.fused_count(dims, card, n)
        launched = fused_ops.LAUNCHES.n - before
        layout = fused_ops.padded_layout(dims, card, n)
        plain = 0 if layout is None else \
            int(fused_count_ref(dims, *layout, n).sum())
        if want is None:
            want = fused_ref(dims, csrs, n)[0]
        assert got == plain == want, (dims, got, plain, want)
        assert launched == (0 if layout is None else 1), launched
        return got

    graphs = {"er": lambda seed: er_graph(np, 150, 0.08, seed),
              "rmat": lambda seed: rmat_graph(256, 2000, seed=seed),
              "star": lambda seed: star_graph(np, 3, 100, seed)}
    n_cases = 0
    counts = {}
    for gname, make in sorted(graphs.items()):
        for seed in (0, 1):
            csr = graph_csr(np, *make(seed))
            for pname, dims in sorted(FUSED_DIMS.items()):
                counts[f"{pname}/{gname}/{seed}"] = check(dims,
                                                          [csr] * len(dims))
                n_cases += 1
    csr = graph_csr(np, *er_graph(np, 120, 0.2, 3))
    shifted = (csr[0] + 10_000, csr[1], csr[2])
    # empty depth-0 frontier, and an empty starts-only depth: no launch
    assert check(TRIANGLE, [csr, shifted, csr]) == 0
    assert check(FUSED_DIMS["diamond"], [csr, shifted, csr, csr]) == 0
    # one depth-0 row whose depth-1 list is hub-sized: vertex 0 adjacent to
    # 1..hub, the leaves a path i -> i+1, so the triangles are (0, i, i+1)
    hub = 1 << 15
    row0 = (np.zeros(1, np.int64), np.array([0, hub], np.int64),
            np.arange(1, hub + 1, dtype=np.int32))
    path = (np.arange(1, hub, dtype=np.int64),
            np.arange(hub, dtype=np.int64),
            np.arange(2, hub + 1, dtype=np.int32))
    counts["hub_row"] = check(TRIANGLE, [row0, row0, path], want=hub - 1)
    # two variables: one atom, and two atoms on (0, 1) pruning each other
    other = graph_csr(np, *er_graph(np, 120, 0.2, 4))
    counts["two_vars"] = check(((0, 1),), [csr])
    counts["two_vars_pruned"] = check(((0, 1), (0, 1)), [csr, other])
    n_cases += 5
    torch.cuda.synchronize()
    return {"phase": "kernels", "of": ["lftj_fused"], "cases": n_cases,
            "exact": True, "counts": counts}


# ---------------------------------------------------------------------------
# phases 3-7: the main path through TriangleEngine
# ---------------------------------------------------------------------------

def phase_rmat(torch, np, ops, shared, scale: int, mem_words: int,
               profile: bool) -> dict:
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
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ops)
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
    shared["rmat"] = {"src": src, "dst": dst, "count": count,
                      "csr": (eng.indptr, eng.indices),
                      "padded_words": stats.padded_words,
                      "actual_words": stats.actual_words,
                      "boxes": stats.n_boxes}
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


def phase_clustered(torch, np, ops, shared, n_clusters: int, size: int,
                    p_in: float, mem_words: int, profile: bool) -> dict:
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
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ops)
    stats = eng.stats
    assert stats.n_dense_boxes > 0, lane_stats(stats)
    assert launches["triangle_dense"] > 0, launches
    peak = torch.cuda.max_memory_allocated()
    if profile:
        emit(profile_count(torch, eng, "clustered"))
    want = cluster_oracle(torch, src, dst, n_clusters, size)
    assert count == want, (count, want)
    assert count > 2 ** 31, count
    shared["clustered"] = {"state": state_of(eng), "oracle": want,
                           "mem_words": mem_words, "count_s": wall}
    return {"phase": "clustered", "clusters": n_clusters,
            "cluster_size": size, "p_in": p_in, "edges": int(len(src)),
            "mem_words": mem_words, "boxes": stats.n_boxes,
            "lanes": lane_stats(stats), "count": count, "oracle": want,
            "launches": launches,
            "device_invocations": stats.device_invocations,
            "gen_s": t_gen, "plan_s": t_plan, "count_s": wall,
            "max_memory_allocated": peak}


def phase_listing(torch, np, ops, shared, scale: int,
                  mem_words: int) -> dict:
    import scipy.sparse as sp
    from repro_torch.core.engine import TriangleEngine
    from repro_torch.core.lftj_torch import orient_edges
    from repro_torch.data.graphs import rmat_graph
    src, dst = rmat_graph(1 << scale, 16 << scale, seed=1)
    reset_launches(ops)
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
    launches = read_launches(ops)
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
    shared["listing"] = {"state": state_of(eng), "oracle": oracle,
                         "mem_words": mem_words, "count_s": t_count}
    return {"phase": "listing", "scale": scale, "edges": int(len(src)),
            "mem_words": mem_words, "count": count, "listed": len(tris),
            "count_lanes": count_lanes, "launches": launches,
            "rescans_default": rescans_default,
            "forced_capacity": cap, "rescans_forced": rescans_forced,
            "count_s": t_count, "list_s": t_list, "cpu_list_s": t_cpu,
            "count_host_lane": count_host, "scipy_oracle": oracle}


def hub_first_csr(np, src, dst):
    """The graph in degree orientation (each edge from its lower- to its
    higher-degree end, ``orient_edges(..., "degree")``) with vertices
    renumbered by descending out-degree, edge directions kept. The hubs
    then hold one contiguous id range, so heavy/light class cuts leave
    whole hub ranges; raw RMAT ids scatter the hubs over the ids with few
    one-bits and cut every hub range to a few ids. The orientation stays
    acyclic, so every triangle is counted once, as in phase 3; its edges
    no longer run from a smaller to a larger id, so the engine is told
    ``orientation="degree"`` and plans without the minmax pruning."""
    from repro_torch.core.lftj_torch import csr_from_edges, orient_edges
    a, b = orient_edges(src, dst, "degree")
    n = int(max(a.max(), b.max())) + 1
    outdeg = np.bincount(a, minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.argsort(-outdeg, kind="stable")] = np.arange(n)
    return csr_from_edges(rank[a], rank[b], n_nodes=n)


def hub_box_routes(np, eng) -> dict:
    """Boxes of a heavy_light engine's plan, its hub boxes, and the hub
    boxes ``_pick_backend`` sends to the fused lane, from the plan and
    the CSR alone (nothing is counted)."""
    ip, ind, nv = eng.indptr, eng.indices, eng.nv
    plan = eng.plan()
    n_hub = n_fused = fused_edges = 0
    for box in plan:
        if eng._box_lane.get(box) != "hub":
            continue
        n_hub += 1
        lx, hx, ly, hy = box
        hx, hy = min(hx, nv - 1), min(hy, nv - 1)
        v = ind[ip[lx]:ip[hx + 1]]
        n_edges = int(((v >= ly) & (v <= hy)).sum())
        if n_edges and eng._pick_backend(n_edges, hx - lx + 1, hy - ly + 1,
                                         box) == "fused":
            n_fused += 1
            fused_edges += n_edges
    return {"threshold": eng._skew_threshold, "boxes": len(plan),
            "hub": n_hub, "fused": n_fused, "fused_edges": fused_edges}


def reckon_heavy_threshold(np, make_engine, degrees) -> tuple:
    """The default hub threshold when it routes a hub box to the fused
    lane, else the largest out-degree value that does (bisection over the
    sorted distinct values, taking fewer hubs as routing fewer boxes).
    Returns (threshold, every probe's routes)."""
    probes = [hub_box_routes(np, make_engine(None))]
    if probes[0]["fused"]:
        return None, probes
    values = np.unique(degrees[degrees > 0])
    lo, hi = 0, len(values) - 1          # values[lo] must route one
    probes.append(hub_box_routes(np, make_engine(int(values[lo]))))
    if not probes[-1]["fused"]:
        raise AssertionError(f"no heavy_threshold routes a hub box to the "
                             f"fused lane: {probes}")
    while hi > lo:
        mid = (lo + hi + 1) // 2
        probes.append(hub_box_routes(np, make_engine(int(values[mid]))))
        if probes[-1]["fused"]:
            lo = mid
        else:
            hi = mid - 1
    return int(values[lo]), probes


def phase_skew(torch, np, ops, shared, mem_words: int, workers: int,
               profile: bool) -> dict:
    from repro_torch.core.engine import TriangleEngine
    rmat = shared["rmat"]
    # raw ids, the reference plan at the default cut: how many hub boxes
    # reach the fused lane without the hub-first labels
    raw = TriangleEngine(csr=rmat["csr"], orientation="minmax",
                         mem_words=mem_words, skew="heavy_light")
    raw_routes = hub_box_routes(np, raw)
    del raw
    t0 = time.perf_counter()
    indptr, indices = hub_first_csr(np, rmat["src"], rmat["dst"])
    t_relabel = time.perf_counter() - t0

    def make_engine(thr):
        eng = TriangleEngine(csr=(indptr, indices), orientation="degree",
                             mem_words=mem_words, skew="heavy_light",
                             heavy_threshold=thr, workers=workers)
        eng.plan()
        return eng

    t0 = time.perf_counter()
    thr, probes = reckon_heavy_threshold(np, make_engine, np.diff(indptr))
    t_reckon = time.perf_counter() - t0
    eng = make_engine(thr)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = eng.count()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ops)
    stats = eng.stats
    assert stats.n_fused_boxes > 0, lane_stats(stats)
    assert launches["lftj_fused"] > 0, launches
    assert count == rmat["count"], (count, rmat["count"])
    if profile:
        emit(profile_count(torch, eng, "skew"))
    return {"phase": "skew", "scale": RMAT_SCALE, "mem_words": mem_words,
            "orientation": "degree, hub-first ids", "workers": workers,
            "heavy_threshold": stats.heavy_threshold,
            "threshold_probes": probes, "raw_ids_default_cut": raw_routes,
            "boxes": stats.n_boxes, "hub_boxes": stats.n_hub_boxes,
            "light_boxes": stats.n_light_boxes,
            "mixed_boxes": stats.n_mixed_boxes, "lanes": lane_stats(stats),
            "count": count, "count_rmat_phase": rmat["count"],
            "launches": launches,
            "device_invocations": stats.device_invocations,
            "padded_words": stats.padded_words,
            "actual_words": stats.actual_words,
            "uniform_plan": {"boxes": rmat["boxes"],
                             "padded_words": rmat["padded_words"],
                             "actual_words": rmat["actual_words"]},
            "relabel_s": t_relabel, "reckon_s": t_reckon, "count_s": wall,
            "compute_s": stats.compute_s,
            "worker_utilization": stats.worker_utilization,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_fused(torch, np, ops, shared, profile: bool) -> dict:
    """``backend="fused"`` on the clustered and listing graphs, with their
    CSRs and plans carried over (no generation or planning again)."""
    from repro_torch.convert import engine_from_state
    out = {"phase": "fused"}
    for name in ("clustered", "listing"):
        g = shared[name]
        eng = engine_from_state(g["state"], mem_words=g["mem_words"],
                                backend="fused")
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = eng.count()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(ops)
        stats = eng.stats
        assert stats.n_fused_boxes > 0, lane_stats(stats)
        assert launches["lftj_fused"] > 0, launches
        assert count == g["oracle"], (name, count, g["oracle"])
        if profile:
            emit(profile_count(torch, eng, f"fused/{name}"))
        out[name] = {"boxes": stats.n_boxes, "lanes": lane_stats(stats),
                     "count": count, "oracle": g["oracle"],
                     "launches": launches,
                     "device_invocations": stats.device_invocations,
                     "count_s": wall, "auto_count_s": g["count_s"],
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated()}
    assert out["clustered"]["count"] > 2 ** 31
    out["launches"] = {k: out["clustered"]["launches"][k]
                       + out["listing"]["launches"][k]
                       for k in out["clustered"]["launches"]}
    return out


# ---------------------------------------------------------------------------
# phase 8: kernel timing at the main path's largest inputs
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


def fused_csr_words(dims, csrs, n_vars) -> int:
    return sum(int(k.numel()) + int(v.numel()) for k, _, v in csrs)


def fused_shape(dims, csrs, n_vars) -> tuple:
    return tuple((int(k.numel()), int(v.numel())) for k, _, v in csrs)


def fused_padded_fits(dims, csrs, n_vars) -> bool:
    """The plain version's padded (R, K) atoms hold at most
    FUSED_PLAIN_WORDS_CAP words."""
    words = 0
    for k, o, _ in csrs:
        deg = o[1:] - o[:-1]
        words += int(k.numel()) * max(1, int(deg.max()) if deg.numel()
                                      else 1)
    return words <= FUSED_PLAIN_WORDS_CAP


def fused_bound(torch, prep) -> tuple:
    """(bytes, dependent probe steps) the triangle box join needs: each
    touched CSR row's real entries once plus the frontier and the output;
    per in-box edge (x, y), min(deg) · ⌈log2(max deg + 1)⌉ probe steps."""
    dims, csrs, c0, _ = prep
    assert dims == TRIANGLE, dims
    (kr, orr, vr), (ks, os_, vs), (kt, ot, vt) = csrs

    def degree_of(keys, off, v):
        pos = torch.searchsorted(keys, v).clamp_(max=max(0, keys.numel() - 1))
        hit = keys[pos] == v
        return torch.where(hit, off[pos + 1] - off[pos],
                           torch.zeros_like(off[pos]))

    x = torch.repeat_interleave(kr, orr[1:] - orr[:-1])
    du, dv = degree_of(ks, os_, x), degree_of(kt, ot, vr)
    lo, hi = torch.minimum(du, dv), torch.maximum(du, dv)
    steps = torch.ceil(torch.log2(hi.double() + 1))
    n_ops = float((lo.double() * steps).sum())
    touched = int(vr.numel()) + int(degree_of(ks, os_, c0).sum()) \
        + int(degree_of(kt, ot, torch.unique(vr)).sum())
    return 4 * touched + 4 * int(c0.numel()) + 8, n_ops


def time_fused(torch, rec, launches: int, reps: int) -> dict:
    from repro_torch.kernels.lftj_fused import ops as fused_ops
    from repro_torch.kernels.lftj_fused.ref import fused_count_ref

    def run(args):
        dims, csrs, n = args
        prep = fused_ops._prepare(dims, csrs, n)
        got = int(fused_ops.launch_count(prep))
        ms = cuda_ms(lambda: fused_ops.launch_count(prep), reps)
        return prep, got, ms

    prep, got, ms = run(rec.largest)
    plain_args = rec.largest if rec.largest_fitting is rec.largest \
        else rec.largest_fitting
    pdims, pcsrs, pn = plain_args
    layout = fused_ops.padded_layout(pdims, pcsrs, pn)
    want = int(fused_count_ref(pdims, *layout, pn).sum())
    plain_ms = cuda_ms(lambda: fused_count_ref(pdims, *layout, pn),
                       max(1, reps // 10))
    out = {}
    if plain_args is rec.largest:
        err = abs(got - want)
    else:
        # the plain version does not fit at the largest input: both are
        # compared and the plain one timed at the largest input that fits
        _, got_fit, ms_fit = run(plain_args)
        err = abs(got_fit - want)
        out["plain_at"] = {"shape": fused_shape(*plain_args),
                           "kernel_ms": ms_fit,
                           "padded_words_cap": FUSED_PLAIN_WORDS_CAP}
    n_bytes, n_ops = fused_bound(torch, prep)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    out.update({
        "name": "lftj_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/lftj_fused.cu",
        "replaces": "src/repro/kernels/lftj_fused/kernel.py:110",
        "launches": launches, "max_abs_err": err, "exact": err == 0,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "count": got,
        "shape": {"atoms_keys_vals": fused_shape(*rec.largest),
                  "frontier": int(prep[2].numel())},
        "bytes": n_bytes, "ops": n_ops})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel checks only")
    ap.add_argument("--phases", default="rmat,clustered,listing,skew,fused",
                    help="main-path phases to run (default: all five; skew "
                         "needs rmat, fused needs clustered and listing)")
    ap.add_argument("--profile", action="store_true",
                    help="repeat each main-path count under "
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
    from repro_torch.kernels.lftj_fused import ops as fused_ops
    from repro_torch.kernels.triangle_dense import ops as dense_ops
    ops = {"intersect": intersect_ops, "triangle_dense": dense_ops,
           "lftj_fused": fused_ops}

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
    t0 = time.perf_counter()
    emit(phase_kernel_cases(torch, np, intersect_ops, dense_ops))
    emit(dict(phase_fused_cases(torch, np, fused_ops),
              phase_s=time.perf_counter() - t0))

    kernels = []
    if not args.quick:
        rec_i = Recorder(intersect_ops, "intersect_count",
                         lambda a, b, ia=None, ib=None:
                         (len(ia) if ia is not None else a.shape[0])
                         * max(a.shape[1], b.shape[1]))
        rec_d = Recorder(dense_ops, "triangle_count",
                         lambda a, b, m: a.shape[0] * b.shape[0]
                         * a.shape[1])
        rec_f = Recorder(fused_ops, "fused_count", fused_csr_words,
                         shape=fused_shape, fits=fused_padded_fits)
        shared = {}
        phases = {
            "rmat": lambda: phase_rmat(
                torch, np, ops, shared, RMAT_SCALE, RMAT_MEM_WORDS,
                args.profile),
            "clustered": lambda: phase_clustered(
                torch, np, ops, shared, CLUSTERS, CLUSTER_SIZE, P_IN,
                CLUSTERED_MEM_WORDS, args.profile),
            "listing": lambda: phase_listing(
                torch, np, ops, shared, LIST_SCALE, LIST_MEM_WORDS),
            "skew": lambda: phase_skew(
                torch, np, ops, shared, RMAT_MEM_WORDS, SKEW_WORKERS,
                args.profile),
            "fused": lambda: phase_fused(torch, np, ops, shared,
                                         args.profile),
        }
        runs = []
        for name in args.phases.split(","):
            t0 = time.perf_counter()
            runs.append(phases[name]())
            runs[-1]["phase_s"] = time.perf_counter() - t0
            emit(runs[-1])
        launches = {k: sum(r["launches"][k] for r in runs) for k in ops}
        emit({"phase": "launch_shapes", "intersect": rec_i.summary(),
              "triangle_dense": rec_d.summary(),
              "lftj_fused": rec_f.summary()})
        if rec_i.largest is not None:
            kernels.append(time_intersect(torch, rec_i,
                                          launches["intersect"], TIMING_REPS))
        if rec_d.largest is not None:
            kernels.append(time_dense(torch, rec_d,
                                      launches["triangle_dense"], TIMING_REPS))
        if rec_f.largest is not None:
            kernels.append(time_fused(torch, rec_f, launches["lftj_fused"],
                                      TIMING_REPS))
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
