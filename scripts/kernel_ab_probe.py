#!/usr/bin/env python3
"""Time the kernel paths of one ``repro_torch`` tree on the card, so that
two trees (a parent commit unpacked beside the checkout, and the checkout)
can be compared in one call on one card.

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
  box;
* ``engine_fused``: ``TriangleEngine(backend="fused")`` on chip_smoke.py's
  clustered graph (two 4096-vertex clusters, ``p_in=0.5``,
  ``mem_words=2^20``): the wall of a warm ``count()``, and
  ``fused_ops.launch_count`` timed at its largest and median box;
* ``query_fused``: ``QueryEngine`` four-clique and diamond counts on
  ``backend="fused"`` (one worker, as chip_smoke.py's query phase) at RMAT
  scale 13 with ``mem_words=2^14``: the wall of each ``count()``, and
  ``launch_count`` at its largest and median call; with ``--workers8``
  the four-clique once more on eight workers (wall only);
* ``dense``: ``TriangleEngine`` on ``auto`` on the clustered graph: the
  wall of a warm ``count()``, and ``triangle_count`` timed at its largest
  and median call;
* ``dense_listing``: ``TriangleEngine`` on ``auto`` on chip_smoke.py's
  listing graph (RMAT scale 16, ``seed=1``, ``mem_words=2^18``), whose
  dense box is the main path's largest ``triangle_count`` call
  (427 × 227 × 31,184): that call timed.
* ``bag``: ``embedding_bag`` on chip_smoke.py's dlrm-mlperf tables (D =
  128, B = 65,536 bags, L = 1 and L = 8 with ~10 % PAD, int64 indices):
  "onehot" on the seventh field (7,168 rows) and the eighteenth (1,024
  rows), "dma" on the largest field (39,980,032 rows, 20.5 GB). Per input:
  ``ms``, the public call between CUDA events; ``host_us``, the host time
  a public call takes to enqueue its work; ``kernel_ms``, the tree's
  launch alone (``bag_ops._launch`` on the indices it takes: as they are,
  or the int32 clamped copy an older wrapper made), a CUDA graph of
  BAG_GRAPH_LAUNCHES launches replayed, per launch; the host
  synchronisations of a public call; whether "onehot" equals "dma" bit
  for bit;
* ``bag_backward``: ``embedding_bag_backward`` at chip_smoke.py's two
  train shapes (the step's inverse indices of a power-law draw of B =
  65,536 slots, L = 1, int32, over 2^23 rows and over 512 rows) and with
  every slot on one row (``chain``: the ordered adds alone); D = 128,
  bfloat16 out: ``ms``, the wrapper with its own sort; where the tree's
  wrapper takes the step's sort, ``ms_with_order`` and its
  ``host_us_with_order``; ``kernel_ms``, the C entry alone on the
  prepared sort (a CUDA graph of BAG_GRAPH_LAUNCHES calls, per call; an
  older tree's kernel into zeros made once); one ``index_add_`` on the
  same inputs, eager between events (``index_add_ms``) and in a CUDA
  graph (``index_add_graph_ms``); the output equal to the plain version
  on the CPU bit for bit. With ``--bag-variant NAME=CONST:VALUE,...``
  (repeatable) the kernel is built once more per variant with those
  ``constexpr`` constants (``kStage:256``, ``kLongRun:32``, ...) and its
  ``kernel_ms`` timed beside the tree's, in the order own, variants,
  variants reversed, own, each into NaN and checked bit for bit;
* ``bag_sweep``: at each padded row count of the dlrm-mlperf "onehot"
  fields (BAG_SWEEP_V; with ``--dtype bfloat16`` the fields "auto" sends
  to "onehot" at bfloat16, BAG_SWEEP_V_BF16), L = 1 and 8, the
  column-sliced kernel (forced) and the row gather, launch alone, in
  turns, each checked equal to the other bit for bit: the data of the
  routing rule (``ops.onehot_route``) for the table's type.

With ``--intersect-variant NAME`` the tree's intersect kernel is built a
second time with ``-DNAME`` (``INTERSECT_WARP_CHUNKS``: the fused count's
warp-chunk scheduler in place of the block tiles), and ``rmat_box`` and
``engine_intersect`` time every box call with both libraries in one
process, in the order own, variant, variant, own, checking that the
counts agree.

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
engine_intersect). Every kernel is built before the first run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
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


def intersect_variant(build, iops, define: str):
    """(own, variant) intersect libraries: the tree's, and the same source
    built with ``-D<define>``; the own one stays loaded."""
    own = build.load("intersect", iops._SIGNATURES)
    flags = build.NVCC_FLAGS
    build.NVCC_FLAGS = flags + (f"-D{define}",)
    try:
        del build._libs["intersect"]
        variant = build.load("intersect", iops._SIGNATURES)
    finally:
        build.NVCC_FLAGS = flags
        build._libs["intersect"] = own
    return own, variant


def time_boxes(torch, iops, boxes, libs=None, build=None) -> dict:
    """ms of the lane's intersect call at the largest and median box; with
    ``libs`` (own, variant), ms of each library in the order own, variant,
    variant, own."""
    dev = torch.device("cuda")
    out = {"boxes": len(boxes.sizes)}
    for name, slc in zip(("largest", "median"), boxes.pick()):
        fn = box_call(torch, iops, slc, dev)
        out[name] = {"edges": int(slc.n_edges),
                     "pad_shape": list(slc.pad_shape),
                     "count": int(fn()), "ms": cuda_ms(torch, fn)}
        if libs is None:
            continue
        own, variant = libs
        # the per-pair counts of the padded API, from both libraries
        npad, _ = slc.padded(dev)
        eu, ev = slc.edges(dev)
        ab = {"own": [], "variant": []}
        per_pair = {}
        try:
            for which in ("own", "variant", "variant", "own"):
                build._libs["intersect"] = own if which == "own" else variant
                if int(fn()) != out[name]["count"]:
                    raise AssertionError(f"{which} intersect count differs "
                                         f"at the {name} box")
                per_pair.setdefault(which, iops.intersect_count(
                    npad, npad, eu, ev))
                ab[which].append(cuda_ms(torch, fn))
        finally:
            build._libs["intersect"] = own
        if not torch.equal(per_pair["own"], per_pair["variant"]):
            raise AssertionError(f"per-pair counts differ at the {name} box")
        out[name]["ab_ms"] = ab
    return out


def fused_words(args, out) -> int:
    """A fused_count call's size: its atoms' keys and values."""
    return sum(int(k.numel()) + int(v.numel()) for k, _, v in args[1])


def time_fused_calls(torch, fops, calls) -> dict:
    """ms of launch_count (the tree's count kernel alone) at the largest
    and median fused_count call."""
    out = {}
    for name, (size, args, _) in zip(("largest", "median"), calls.pick()):
        prep = fops._prepare(*args)
        out[name] = {"words": size, "count": int(fops.launch_count(prep)),
                     "ms": cuda_ms(torch, lambda: fops.launch_count(prep))}
    return out


# the bag run's inputs (chip_smoke.py's embedding_bag phase): dlrm-mlperf
# tables of D = 128 float32, B = 65,536 bags, ~10 % PAD slots at L > 1
BAG_D, BAG_B, BAG_PAD_SHARE = 128, 65_536, 0.1
BAG_FIELDS = (("seventh", 7_168, "onehot"), ("eighteenth", 1_024, "onehot"),
              ("largest", 39_980_032, "dma"))
BAG_GRAPH_LAUNCHES = 20


def bag_indices(torch, gen, v: int, ll: int):
    idx = torch.randint(0, v, (BAG_B, ll), generator=gen, device="cuda")
    if ll > 1:
        pad = torch.rand((BAG_B, ll), generator=gen,
                         device="cuda") < BAG_PAD_SHARE
        idx[pad] = v
    return idx


def per_launch_ms(torch, fn, n: int = BAG_GRAPH_LAUNCHES) -> float:
    """ms a launch of ``fn``'s kernels without its host work: ``n`` calls
    captured in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(torch, graph.replay) / n


def count_syncs(torch, fn) -> int:
    """Host synchronisations of one ``fn()``, by PyTorch's sync debug
    mode."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def host_us(torch, fn, calls: int = 200) -> float:
    """Microseconds of host time a call of ``fn`` takes to enqueue its
    work (``calls`` calls back to back, then one synchronisation)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bag_run(torch, bag_ops, tag: dict) -> None:
    """The ``bag`` run: one JSON line per (table, mode, L)."""
    in_place = hasattr(bag_ops, "onehot_slice_width")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for field, v, mode in BAG_FIELDS:
        table = torch.rand((v, BAG_D), generator=gen, device="cuda")
        for ll in (1, 8):
            idx = bag_indices(torch, gen, v, ll)
            arg = idx if in_place else \
                idx.clamp(max=v).to(torch.int32)

            def call():
                return bag_ops.embedding_bag(table, idx, mode=mode)

            got = call()
            line = dict(tag, run="bag", field=field, V=v, mode=mode, L=ll,
                        syncs=count_syncs(torch, call),
                        ms=cuda_ms(torch, call), host_us=host_us(torch, call),
                        kernel_ms=per_launch_ms(
                            torch, lambda: bag_ops._launch(table, arg, mode)))
            if mode == "onehot":
                line["equals_dma"] = torch.equal(
                    got, bag_ops.embedding_bag(table, idx, mode="dma"))
            emit(line)
        del table
        torch.cuda.empty_cache()


# the bag_sweep run: the dlrm-mlperf "onehot" fields' padded row counts,
# float32 (at most 2^22 bytes: 8,192 rows of 128) and bfloat16 (16,384)
BAG_SWEEP_V = (512, 1024, 2048, 2560, 7168, 7680)
BAG_SWEEP_V_BF16 = BAG_SWEEP_V + (12_288, 13_312)


def bag_sweep(torch, bag_ops, tag: dict, dtype: str) -> None:
    """The ``bag_sweep`` run: at each of BAG_SWEEP_V (bfloat16:
    BAG_SWEEP_V_BF16) rows, L = 1 and 8, the launch alone of the
    column-sliced kernel (forced, whatever the routing rule says) and of
    the row gather, in the order slices, rows, rows, slices; the two
    outputs must be equal bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    route = bag_ops.onehot_route
    table_dtype = getattr(torch, dtype)
    for v in BAG_SWEEP_V_BF16 if dtype == "bfloat16" else BAG_SWEEP_V:
        table = torch.rand((v, BAG_D), generator=gen, device="cuda") \
            .to(table_dtype)
        w = bag_ops.onehot_slice_width(v, BAG_D, elem=table.element_size())
        for ll in (1, 8):
            idx = bag_indices(torch, gen, v, ll)
            out = {"slices": [], "rows": []}
            try:
                bag_ops.onehot_route = lambda *a: w
                bag_ops._onehot_plan.cache_clear()
                equal = torch.equal(bag_ops._launch(table, idx, "onehot"),
                                    bag_ops._launch(table, idx, "dma"))
                assert equal, (v, w, ll, dtype)
                for which in ("slices", "rows", "rows", "slices"):
                    mode = "onehot" if which == "slices" else "dma"
                    out[which].append(per_launch_ms(
                        torch, lambda: bag_ops._launch(table, idx, mode)))
            finally:
                bag_ops.onehot_route = route
                bag_ops._onehot_plan.cache_clear()
            emit(dict(tag, run="bag_sweep", dtype=dtype, V=v, w=w, L=ll,
                      equal=equal, ms=out))
        del table
        torch.cuda.empty_cache()


# the bag_backward run: the train phase's two fields (TRAIN_FIELDS) as
# power-law draws (CriteoLikeGenerator's) over their capped row counts,
# and every slot on one row (the chain of ordered adds alone)
BAG_BWD_SHAPES = (("largest", 1 << 23), ("smallest", 512), ("chain", 1))


def bag_variants(build, specs) -> dict:
    """{name: library}: the tree's backward kernel built once more per
    ``NAME=CONST:VALUE,...`` spec, with those constexpr constants set to
    other values (one ``nvcc`` each, all started together)."""
    if not specs:
        return {}
    from repro_torch.kernels.embedding_bag import grad as grad_ops
    source = (build.SRC_DIR / "embedding_bag_backward.cu").read_text()
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in specs:
        name, _, consts = spec.partition("=")
        text = source
        for const, value in (c.split(":") for c in consts.split(",") if c):
            text, n = re.subn(rf"(constexpr \w+(?: \w+)? {const} = )[^;]+;",
                              rf"\g<1>{value};", text)
            if n != 1:
                raise SystemExit(f"no constexpr {const} in "
                                 "embedding_bag_backward.cu")
        cu = out / f"embedding_bag_backward_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, proc), spec in zip(procs.items(), specs):
        log, _ = proc.communicate()
        emit({"run": "bag_variant", "variant": spec, "nvcc_rc":
              proc.returncode, "ptxas": [line.strip() for line in
                                         log.splitlines() if "Used" in line
                                         or "stack frame" in line]})
        if proc.returncode:
            raise SystemExit(log[-2000:])
        lib = ctypes.CDLL(str(out / f"embedding_bag_backward_{name}.so"))
        for sym, (argtypes, restype) in grad_ops._SIGNATURES.items():
            getattr(lib, sym).argtypes = list(argtypes)
            getattr(lib, sym).restype = restype
        libs[name] = lib
    return libs


def bag_backward_run(torch, np, tag: dict, variants: dict) -> None:
    """The ``bag_backward`` run: one JSON line per shape."""
    import inspect

    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import grad as grad_ops
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    from repro_torch.models import dlrm
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    takes_order = "order" in inspect.signature(
        grad_ops.embedding_bag_backward).parameters
    dtype, d = torch.bfloat16, 128
    for name, rows in BAG_BWD_SHAPES:
        u = rng.random(BAG_B)
        x = torch.from_numpy(np.clip(np.floor(rows ** u - 1), 0, rows - 1)
                             .astype(np.int32)).cuda()
        if hasattr(dlrm, "unique_with_order"):
            uniq, inv, (keys, perm) = dlrm.unique_with_order(x)
        else:  # a tree whose step does not hand its sort on
            uniq, inv = torch.unique(x, sorted=True, return_inverse=True)
            keys, perm = torch.sort(inv.to(torch.int32), stable=True)
        idx, v = inv.to(torch.int32).view(-1, 1), uniq.numel()
        g = torch.randn((BAG_B, d), generator=gen, device="cuda")
        want = embedding_bag_backward_ref(g.cpu(), idx.cpu(), v, dtype)
        got = grad_ops.embedding_bag_backward(g, idx, v, dtype)
        line = dict(tag, run="bag_backward", field=name, rows=v,
                    longest_run=int(torch.bincount(inv).max()),
                    exact=bool(torch.equal(got.cpu(), want)),
                    ms=cuda_ms(torch, lambda: grad_ops.embedding_bag_backward(
                        g, idx, v, dtype)))
        if takes_order:
            def with_order():
                return grad_ops.embedding_bag_backward(g, idx, v, dtype,
                                                       order=(keys, perm))
            line["ms_with_order"] = cuda_ms(torch, with_order)
            line["host_us_with_order"] = host_us(torch, with_order)
            out = torch.empty((v, d), dtype=dtype, device="cuda")
            own = _build.load("embedding_bag_backward", grad_ops._SIGNATURES)
            work = torch.empty(max(
                lib.embedding_bag_backward_workspace(BAG_B, v, d)
                for lib in (own, *variants.values())), dtype=torch.uint8,
                device="cuda")

            def launch():
                grad_ops._launch_sorted(g, keys, perm, 1, v, dtype, out=out,
                                        work=work)
        else:
            lib = _build.load("embedding_bag_backward", grad_ops._SIGNATURES)
            out = torch.zeros((v, d), dtype=dtype, device="cuda")

            def launch():
                rc = lib.embedding_bag_backward_launch(
                    g.data_ptr(), d, keys.data_ptr(), 4, perm.data_ptr(),
                    BAG_B, 1, v, d, out.data_ptr(), 2,
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

        line["kernel_ms"] = per_launch_ms(torch, launch)
        line["exact"] &= bool(torch.equal(out.cpu(), want))
        if variants:
            # the tree's kernel and each variant in the order own,
            # variant, variant, own, each checked against the plain version
            ab = {}
            try:
                for which in ("own", *variants, *reversed(variants), "own"):
                    _build._libs["embedding_bag_backward"] = \
                        variants.get(which, own)
                    out.fill_(float("nan"))
                    ab.setdefault(which, []).append(
                        per_launch_ms(torch, launch))
                    if not torch.equal(out.cpu(), want):
                        raise AssertionError(f"{which} differs from the "
                                             f"plain version at {name}")
            finally:
                _build._libs["embedding_bag_backward"] = own
            line["variant_kernel_ms"] = ab
        acc = torch.zeros((v, d), device="cuda")
        line["index_add_ms"] = cuda_ms(
            torch, lambda: acc.index_add_(0, inv, g))
        line["index_add_graph_ms"] = per_launch_ms(
            torch, lambda: acc.index_add_(0, inv, g))
        emit(line)


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
                    "engine_intersect, rmat_box, engine_fused, "
                    "query_fused, dense, dense_listing, bag, bag_sweep, "
                    "bag_backward")
    ap.add_argument("--intersect-variant", default=None,
                    help="a macro to build the intersect kernel a second "
                    "time with (INTERSECT_WARP_CHUNKS), timed beside the "
                    "tree's at the rmat_box and engine_intersect boxes")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bag_sweep: the tables' type")
    ap.add_argument("--bag-variant", action="append", default=[],
                    help="bag_backward: NAME=CONST:VALUE,... (repeatable), "
                    "the backward kernel built once more with those "
                    "constexpr constants, timed beside the tree's")
    ap.add_argument("--workers8", action="store_true",
                    help="query_fused: the four-clique once more on eight "
                    "workers")
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
    from repro_torch.convert import engine_from_state
    from repro_torch.data.graphs import clustered_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.intersect import ops as iops
    from repro_torch.kernels.lftj_fused import ops as fops
    from repro_torch.kernels.triangle_dense import ops as dops
    from repro_torch.query import QueryEngine, patterns
    tag = {"tag": args.tag, "package": str(Path(repro_torch.__file__)
                                           .resolve().parent)}
    t0 = time.perf_counter()
    _build.build()
    libs = None
    if args.intersect_variant:
        libs = intersect_variant(_build, iops, args.intersect_variant)
        emit(dict(tag, run="variant", define=args.intersect_variant,
                  ptxas=[line.strip() for line in
                         _build.BUILD_LOG.get("intersect", "").splitlines()
                         if "Used" in line or "stack frame" in line]))
    emit(dict(tag, run="build", build_s=time.perf_counter() - t0))

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
                  box_call=time_boxes(torch, iops, boxes, libs,
                                            _build)))

    if runs & {"engine_fused", "dense"}:
        src, dst = rmat_graph(1 << 10, 1 << 12, seed=0)  # warm-up graph
        TriangleEngine(src, dst, mem_words=1 << 12, backend="fused").count()
        src, dst = clustered_graph(2, 4096, seed=0, p_in=0.5)
        eng = TriangleEngine(src, dst, mem_words=1 << 20)
        state = {"indptr": eng.indptr, "indices": eng.indices,
                 "orientation": eng.orientation, "nv": eng.nv,
                 "plan": eng.plan()}

    if "engine_fused" in runs:
        eng = engine_from_state(state, mem_words=1 << 20, backend="fused")
        eng.count()
        calls = Calls(fops, "fused_count", fused_words)
        count, wall = walled(torch, eng.count)
        calls.restore()
        emit(dict(tag, run="engine_fused", count=count, count_s=wall,
                  fused_boxes=eng.stats.n_fused_boxes,
                  calls=len(calls.calls),
                  launch_count=time_fused_calls(torch, fops, calls)))

    if "dense" in runs:
        eng = engine_from_state(state, mem_words=1 << 20)
        eng.count()
        calls = Calls(dops, "triangle_count",
                      lambda a, out: a[0].shape[0] * a[1].shape[0]
                      * a[0].shape[1])
        count, wall = walled(torch, eng.count)
        calls.restore()
        timed = {}
        for name, (size, a, kw) in zip(("largest", "median"), calls.pick()):
            timed[name] = {"shape": [list(a[0].shape), list(a[1].shape)],
                           "ms": cuda_ms(torch,
                                         lambda: dops.triangle_count(*a))}
        emit(dict(tag, run="dense", count=count, count_s=wall,
                  dense_boxes=eng.stats.n_dense_boxes,
                  calls=len(calls.calls), triangle_count=timed))

    if "dense_listing" in runs:
        src, dst = rmat_graph(1 << 16, 16 << 16, seed=1)
        eng = TriangleEngine(src, dst, mem_words=1 << 18)
        calls = Calls(dops, "triangle_count",
                      lambda a, out: a[0].shape[0] * a[1].shape[0]
                      * a[0].shape[1])
        count = eng.count()
        calls.restore()
        (size, a, kw), _ = calls.pick()
        want = int(dops.triangle_count(*a))
        emit(dict(tag, run="dense_listing", count=count,
                  calls=len(calls.calls),
                  triangle_count={"shape": [list(a[0].shape),
                                            list(a[1].shape)],
                                  "count": want,
                                  "ms": cuda_ms(torch, lambda:
                                                dops.triangle_count(*a))}))

    if "query_fused" in runs:
        src, dst = rmat_graph(1 << 10, 1 << 14, seed=2)  # warm-up graph
        QueryEngine(patterns.four_clique(), relations=relations(src, dst),
                    mem_words=1 << 12, backend="fused").count()
        src, dst = rmat_graph(1 << 13, 16 << 13, seed=0)
        rel = relations(src, dst)
        for name in ("four_clique", "diamond"):
            eng = QueryEngine(patterns.PATTERNS[name](), relations=rel,
                              mem_words=1 << 14, backend="fused", workers=1)
            calls = Calls(fops, "fused_count", fused_words)
            count, wall = walled(torch, eng.count)
            calls.restore()
            emit(dict(tag, run="query_fused", pattern=name, workers=1,
                      count=count, count_s=wall, calls=len(calls.calls),
                      fused_boxes=eng.stats.n_fused_boxes,
                      launch_count=time_fused_calls(torch, fops, calls)))
        if args.workers8:
            eng = QueryEngine(patterns.four_clique(), relations=rel,
                              mem_words=1 << 14, backend="fused", workers=8)
            count, wall = walled(torch, eng.count)
            emit(dict(tag, run="query_fused", pattern="four_clique",
                      workers=8, count=count, count_s=wall))

    if "bag_sweep" in runs:
        bag_sweep(torch, bag_ops, tag, args.dtype)

    if "bag" in runs:
        bag_run(torch, bag_ops, tag)

    if "bag_backward" in runs:
        import numpy as np
        bag_backward_run(torch, np, tag,
                         bag_variants(_build, args.bag_variant))

    if "rmat_box" in runs:
        src, dst = rmat_graph(1 << 20, 16 << 20, seed=0)
        eng = TriangleEngine(src, dst, mem_words=1 << 21)
        eng.plan()
        boxes = Boxes(StreamingExecutor)
        count, wall = walled(torch, eng.count)
        boxes.restore()
        emit(dict(tag, run="rmat_box", count=count, count_s=wall,
                  intersect_boxes=eng.stats.n_intersect_boxes,
                  box_call=time_boxes(torch, iops, boxes, libs,
                                            _build)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
