"""Dry run: reckon every (arch × shape × grid) cell, run on the card each
one that fits, and plan the distributed box fabric without running it.

The port of ``src/repro/launch/dryrun.py``. Its model cells take three
grids (``--mesh``):

  * ``single`` / ``multi`` — the production grids (16 x 16, and 2 x 16 x
    16 with a pod axis), the counterpart of the reference's compile-only
    analysis. No card is needed: each record has the grid's
    ``n_chips``, the per-device ``argument_size_in_bytes`` (the sum over
    the arguments of each one's ``shard_shape`` times its itemsize, under
    the reference's sharding rules), the whole arguments' bytes,
    ``model_flops_global`` and ``scan_repeats``.
  * ``card`` — the cell run on one card (``make_host_mesh``), whole, on
    arguments made from a seeded generator by the port's own makers: a
    warm-up step, ``TIMED_STEPS`` steps timed with CUDA events, one more step
    whose operations ``torch.utils.flop_counter.FlopCounterMode`` counts
    (``counted_flops``, the counterpart of the reference's HLO flops;
    ``flop_counter``),
    the allocator's peak (``peak_bytes``), ``useful_flops_ratio``,
    ``t_compute_s`` against the card's bfloat16 peak (``mesh.HW``), the
    share of that peak the step reached, and ``t_memory_s``, the
    arguments read once at the card's memory rate (the reference counts
    XLA's bytes accessed; eager PyTorch has no such count, so this is a
    floor). With ``probes``, a cell of R > 2 repeated layers is also run
    at 2 and 3 repeats (``PROBE_TIMED_STEPS`` timed steps each), and its
    step time, flops and peak extrapolated linearly to R, as the reference
    extrapolates XLA's counts; the probes run even where the whole cell
    does not fit. The extrapolated step time carries its spread
    (``_extrapolated_step``) and is left unresolved where the difference
    of the two probes does not clear it.

Not fitting is a result, not a failure. A cell whose arguments alone
exceed the card is not attempted (``ran: false``, with its reckoned
bytes); a ``torch.cuda.OutOfMemoryError`` inside the step is recorded as
``fits_one_card: false`` with the allocator's numbers, and the card is
emptied before the next cell. Any other exception fails the cell, and
``main`` exits 1 when a cell failed.

Collectives. The reference counts them in the compiled per-device HLO
(``collective_bytes_from_hlo``). The port counts what its grid runtime
moves (``parallel.spmd.LEDGER``, the reference's record shape
``{"all-gather": {"count", "bytes"}, ...}``, operand bytes per device):

  * ``single`` / ``multi`` records of the cells ``Cell.sharded`` runs (GNN
    training, DLRM serving and retrieval, the dense LMs' training, prefill
    and decode) carry ``collectives`` of one step run on the abstract
    production grid with ``meta`` blocks (shapes only): a cell of R > 2
    repeated layers is run at 1 and 2 repeats and extrapolated to R,
    exactly, since each repeat makes the same collectives (the reference
    extrapolates its HLO counts from probes too); other cells leave the
    term out.
  * ``card`` with ``grid`` (``--grid 2x2 --devices cuda:0,cuda:0,...``)
    runs the cell split over that grid of devices (places may repeat):
    the whole arguments made on the first device, laid out by the cell's
    in-shardings (views where a block lies on its source's device); an LM
    cell's params are made on their places instead (``make_placed_args``:
    leaf by leaf, the first device holding one whole leaf at a time) and
    its AdamW state as zeros there, so a cell whose arguments exceed one
    card runs on several. The step is timed with every device
    synchronised, and the record carries
    the ledger's ``collectives`` of one step, ``n_places``, ``n_chips``
    (distinct devices) and each device's peak. Without ``grid`` a card
    record is one place, whole, with ``collectives: {}``; only such a run
    takes probes.

The reference's import-time ``XLA_FLAGS`` guard does not carry over.

Usage:
  python -m repro_torch.launch.dryrun --all              # 40 cells x 2 grids
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape long_500k \\
      --mesh card                                         # on the card
  python -m repro_torch.launch.dryrun --arch graphcast --shape molecule \\
      --mesh card --grid 2x2 --devices cuda:0,cuda:0,cuda:0,cuda:0
  python -m repro_torch.launch.dryrun --fabric [--fabric-shards N]

The fabric dry run (``fabric_dryrun``) plans, schedules and lays out a
fabric on the host only: the ``Fabric`` is built with
``torch_device="cpu"`` because no shard executes.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import sys
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

PROBE_REPEATS = (2, 3)
# steps a run on the card times, after one warm-up step; a probe times
# more, because the extrapolation multiplies its noise by R - 2
TIMED_STEPS = 3
PROBE_TIMED_STEPS = 10


def model_flops_for(cell) -> float:
    """MODEL_FLOPS: 6·N·D for LM (N = active params), analytic for others."""
    cfg = cell.cfg
    if cell.step_kind in ("train",) and hasattr(cfg, "active_params_count"):
        n = cfg.active_params_count()
        toks = cell.meta.get("tokens", 0)
        return 6.0 * n * toks
    if cell.step_kind == "prefill" and hasattr(cfg, "active_params_count"):
        return 2.0 * cfg.active_params_count() * cell.meta.get("tokens", 0)
    if cell.step_kind == "decode" and hasattr(cfg, "active_params_count"):
        return 2.0 * cfg.active_params_count() * cell.meta.get("tokens", 0)
    if hasattr(cfg, "kind"):  # GNN: ~6 · E · d_hidden² per MP layer (train)
        e = cell.meta.get("n_edges", 0)
        nn = cell.meta.get("n_nodes", 0)
        mults = {"gcn": 1, "gin": 2, "schnet": 4, "graphcast": 6}
        per = mults.get(cfg.kind, 2) * cfg.d_hidden * cfg.d_hidden
        fwd = (e + nn) * per * cfg.n_layers * 2
        return 3.0 * fwd  # fwd + bwd ~ 3x
    if hasattr(cfg, "table_sizes"):  # DLRM: MLP flops dominate
        b = cell.meta.get("batch", cell.meta.get("candidates", 0))
        dims = [cfg.n_dense] + list(cfg.bot_mlp)
        f = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        n_int = cfg.n_sparse + 1
        d_top = cfg.embed_dim + n_int * (n_int - 1) // 2
        dims = [d_top] + list(cfg.top_mlp)
        f += sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        f += n_int * n_int * cfg.embed_dim  # interaction
        mult = 6.0 if cell.step_kind == "train" else 2.0
        return mult * b * f
    return 0.0


def _scan_repeats(cfg) -> int:
    """Repeats of the layer stack (1 => no extrapolation needed)."""
    if hasattr(cfg, "n_repeats"):
        return int(cfg.n_repeats)
    if getattr(cfg, "kind", None) == "graphcast":
        return int(cfg.n_layers)
    return 1


def _repeats_transform(cfg, k: int):
    """Probe config: k repeats of the layer stack (the port has no layer
    scan to unroll, so only ``n_layers`` changes)."""
    if hasattr(cfg, "n_repeats"):
        return dataclasses.replace(
            cfg, n_layers=len(cfg.prefix) + len(cfg.pattern) * k)
    if getattr(cfg, "kind", None) == "graphcast":
        return dataclasses.replace(cfg, n_layers=k)
    return cfg


def _probe_transform(cfg_transform: Optional[Callable], k: int) -> Callable:
    def tf(c):
        if cfg_transform is not None:
            c = cfg_transform(c)
        return _repeats_transform(c, k)
    return tf


def argument_bytes(cell, per_device: bool = False) -> int:
    """Bytes of the cell's arguments: whole, or one device's blocks
    (each leaf's ``shard_shape`` under its in-sharding)."""
    from repro_torch.pytree import leaves

    specs = leaves(cell.arg_specs)
    total = 0
    if not per_device:
        for x in specs:
            total += x.numel() * x.element_size()
        return total
    shards = leaves(cell.in_shardings)
    if len(shards) != len(specs):
        raise ValueError(f"{len(specs)} arguments but {len(shards)} "
                         f"shardings")
    for x, ns in zip(specs, shards):
        n = 1
        for d in ns.shard_shape(x.shape):
            n *= d
        total += n * x.element_size()
    return total


# ---------------------------------------------------------------------------
# arguments for a run on the card
# ---------------------------------------------------------------------------

def _shape_dims(cell, dims: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    from repro_torch.configs import get_arch
    return {**get_arch(cell.arch_id).shapes[cell.shape_name].dims,
            **(dims or {})}


def _lm_args(cell, gen, dev, seed: int, params=None, opt_state=None):
    """An LM cell's arguments on ``dev``; ``params`` and ``opt_state``
    where they are made already (on their places), else here, whole."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_map

    cfg = cell.cfg
    if params is None:
        params = TF.init_params(cfg, gen, dev)
    stream = TokenStream(cfg.vocab, seed=seed)
    as_dev = lambda a: torch.from_numpy(a).to(dev)
    if cell.step_kind == "train":
        b, s = cell.arg_specs[2]["tokens"].shape
        batch = {k: as_dev(v) for k, v in stream.batch(b, s).items()}
        return (params, adamw.init(params) if opt_state is None
                else opt_state, batch)
    if cell.step_kind == "prefill":
        b, s = cell.arg_specs[1].shape
        return (params, as_dev(stream.batch(b, s)["tokens"]))
    # decode: a random cache, the new token at its last position, so that
    # attention reads the whole cache
    _, cache_specs, token_spec, _ = cell.arg_specs
    cache = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device=dev).normal_(
        generator=gen), cache_specs)
    b = token_spec.shape[0]
    token = as_dev(stream.batch(b, 1)["tokens"])
    pos = torch.tensor(cell.meta["kv_len"] - 1, dtype=torch.int32,
                       device=dev)
    return (params, cache, token, pos)


def _gnn_batch(cell, dims, gen, dev) -> Dict[str, torch.Tensor]:
    """A random graph at the shape's sizes, padded to the spec's: uniform
    endpoints among the live nodes (within each graph for ``molecule``),
    Gaussian features, labels or targets, masks zero on the padding."""
    specs = cell.arg_specs[2]
    n, e = specs["node_feat"].shape[0], specs["edge_src"].shape[0]
    if "batch" in dims:                     # molecule: batched graphs
        per_n, per_e = dims["n_nodes"], dims["n_edges"]
        live_n, live_e = per_n * dims["batch"], per_e * dims["batch"]
    elif "blk_nodes" in dims:               # a padded sampled block
        live_n, live_e = dims["blk_nodes"], dims["blk_edges"]
        per_n = per_e = None
    else:
        live_n, live_e = dims["n_nodes"], dims["n_edges"]
        per_n = per_e = None
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def ints(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, **i32)

    if per_n is None:
        src, dst = ints(live_n, live_e), ints(live_n, live_e)
    else:
        base = torch.arange(live_e, **i32) // per_e * per_n
        src, dst = base + ints(per_n, live_e), base + ints(per_n, live_e)
    pad_e = torch.zeros(e - live_e, **i32)
    node_mask = torch.zeros(n, **f32)
    node_mask[:live_n] = 1.0
    feat = torch.zeros(n, specs["node_feat"].shape[1], **f32)
    feat[:live_n].normal_(generator=gen)
    batch = {"node_feat": feat,
             "edge_src": torch.cat([src, pad_e]),
             "edge_dst": torch.cat([dst, pad_e]),
             "edge_mask": torch.cat([torch.ones(live_e, **f32),
                                     torch.zeros(e - live_e, **f32)]),
             "node_mask": node_mask}
    if "targets" in specs:
        batch["pos"] = torch.zeros(n, 3, **f32)
        batch["pos"][:live_n].normal_(generator=gen)
        batch["graph_id"] = torch.zeros(n, **i32)
        batch["graph_id"][:live_n] = torch.arange(live_n, **i32) // per_n
        batch["targets"] = torch.zeros(n, specs["targets"].shape[1], **f32)
        batch["targets"][:live_n].normal_(generator=gen)
    else:
        batch["labels"] = torch.zeros(n, **i32)
        batch["labels"][:live_n] = ints(dims["n_classes"], live_n)
        batch["label_mask"] = node_mask.clone()
    return batch


def _gnn_args(cell, dims, gen, dev):
    from repro_torch.models import gnn as GNN
    from repro_torch.optim import adamw

    params = GNN.init_params(cell.cfg, gen, dev)
    return (params, adamw.init(params), _gnn_batch(cell, dims, gen, dev))


def _dlrm_args(cell, gen, dev, seed: int):
    from repro_torch.data.recsys import CriteoLikeGenerator
    from repro_torch.models import dlrm as DLRM
    from repro_torch.optim import adamw

    cfg = cell.cfg
    params = DLRM.init_params(cfg, gen, dev)
    specs = cell.arg_specs[-1]
    data = CriteoLikeGenerator(cfg.table_sizes, n_dense=cfg.n_dense,
                               hot=cfg.hot, seed=seed)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(
        specs["dense"].shape[0],
        with_labels=cell.step_kind == "train").items()}
    if "candidates" in specs:
        batch["candidates"] = torch.empty(
            specs["candidates"].shape, dtype=torch.float32,
            device=dev).normal_(generator=gen)
    if cell.step_kind == "train":
        return (params, adamw.init(params), batch)
    return (params, batch)


def make_args(cell, dev, dims: Optional[Dict[str, Any]] = None,
              seed: int = 0) -> tuple:
    """Real arguments of ``cell`` on ``dev`` from a generator seeded
    ``seed``, by the port's makers (``init_params``, ``adamw.init``,
    ``TokenStream``, a random graph at the shape's sizes,
    ``CriteoLikeGenerator``); each leaf at its spec's shape and dtype.
    ``dims``: the overrides the cell was built with."""
    from repro_torch.configs import get_arch
    from repro_torch.pytree import flatten_with_path

    gen = torch.Generator(device=dev).manual_seed(seed)
    fam = get_arch(cell.arch_id).family
    if fam == "lm":
        args = _lm_args(cell, gen, dev, seed)
    elif fam == "gnn":
        args = _gnn_args(cell, _shape_dims(cell, dims), gen, dev)
    else:
        args = _dlrm_args(cell, gen, dev, seed)
    got, want = flatten_with_path(args), flatten_with_path(cell.arg_specs)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError(f"{cell.arch_id} {cell.shape_name}: arguments "
                         f"{[p for p, _ in got]} != specs "
                         f"{[p for p, _ in want]}")
    for (path, a), (_, s) in zip(got, want):
        if a.shape != s.shape or a.dtype != s.dtype:
            raise ValueError(f"{path}: {a.shape} {a.dtype} != spec "
                             f"{s.shape} {s.dtype}")
    return args


def make_placed_args(cell, seed: int = 0) -> tuple:
    """An LM cell's arguments on its grid's places, by ``make_args``'s
    makers from the same generator, so every block has the bits of the
    whole argument's: the params drawn leaf by leaf on the grid's first
    device (``layers.iter_materialize``), each leaf's blocks copied to
    their places and the leaf freed before the next is drawn
    (``spmd.place_leaves``), so that device holds one whole leaf at a
    time; AdamW's moments and step as zeros on their places
    (``spmd.zeros``); the batch, tokens or cache made on the first device
    and laid out by the in-shardings."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.parallel import spmd
    from repro_torch.pytree import tree_map

    if get_arch(cell.arch_id).family != "lm" or cell.grid.devices is None:
        raise ValueError(f"{cell.arch_id} {cell.shape_name}: arguments are "
                         f"made on their places for LM cells on a grid of "
                         f"devices only")
    dev = cell.grid.devices.flat[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = spmd.place_leaves(
        L.iter_materialize(TF.param_shapes(cell.cfg), gen, dev),
        cell.in_shardings[0])
    state = None
    if cell.step_kind == "train":
        o_sh = cell.in_shardings[1]
        zeros = lambda tree: tree_map(
            lambda s, ns: spmd.zeros(s.shape, torch.float32, ns), params,
            tree, is_leaf=lambda x: isinstance(x, spmd.Sharded))
        state = adamw.OptState(spmd.zeros((), torch.int32, o_sh.step),
                               zeros(o_sh.m), zeros(o_sh.v))
    args = _lm_args(cell, gen, dev, seed, params, state)
    return args[:1] + tuple(
        a if i == 1 and state is not None else spmd.place_tree(a, ns)
        for i, (a, ns) in enumerate(zip(args[1:], cell.in_shardings[1:]),
                                    start=1))


# ---------------------------------------------------------------------------
# a run on the card
# ---------------------------------------------------------------------------

def _result_of(cell, out):
    """The part of a step's output the record checks: the metrics of a
    train step, the logits of prefill and decode, the scores of serving
    and retrieval."""
    if cell.step_kind == "train":
        return out[2]
    if cell.step_kind == "prefill":
        return out[1]
    if cell.step_kind in ("decode", "retrieval"):
        return out[0]
    return out


def _distinct(devs) -> list:
    out = []
    for d in devs:
        if d not in out:
            out.append(d)
    return out


def _placed_on_grid(cell) -> bool:
    """Whether ``_measure_on`` makes the cell's arguments on their places
    (``make_placed_args``) rather than whole on the first device."""
    from repro_torch.configs import get_arch
    return cell.grid.size > 1 and get_arch(cell.arch_id).family == "lm"


def _measure_on(cell, dev, dims, check, n_timed) -> Dict[str, Any]:
    """Arguments made, a warm-up step, ``n_timed`` timed steps and one
    counted step of ``cell`` on ``dev`` (whole), or on its grid's devices
    (split, ``Cell.sharded``: an LM cell's arguments made on their places,
    ``make_placed_args``, another cell's made on the first device and laid
    out by the in-shardings); the arguments die with this frame. ``check``
    gets the whole arguments, or an LM cell's placed ones, and the step's
    output (its blocks, on a grid)."""
    from repro_torch.parallel import spmd
    from repro_torch.pytree import leaves

    devs = [dev] if cell.grid.size == 1 else _distinct(
        list(cell.grid.devices.flat))
    cuda = devs[0].type == "cuda"
    if cell.grid.size == 1:
        whole = make_args(cell, devs[0], dims)
        fn, args = cell.fn, whole
    elif _placed_on_grid(cell):
        whole = args = make_placed_args(cell)
        fn = cell.sharded()
    else:
        whole = make_args(cell, devs[0], dims)
        fn, args = cell.sharded(), cell.place(whole)

    def sync():
        if cuda:
            for d in devs:
                torch.cuda.synchronize(d)
    sync()
    if cuda:
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
    out = fn(*args)
    times = []
    for _ in range(n_timed):
        out = None                  # the last step's output, freed first
        if cuda and len(devs) == 1:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            times.append((start, end))
        else:
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
    sync()
    if cuda and len(devs) == 1:
        times = [s.elapsed_time(e) for s, e in times]
    out = None
    spmd.reset_ledger()
    with flop_counter() as counter:
        out = fn(*args)
    res = {"step_calls": n_timed + 2, "step_ms_all": times,
           "step_ms": statistics.median(times),
           "counted_flops": float(counter.get_total_flops())}
    checked = _result_of(cell, out)
    if cell.grid.size > 1:
        res["collectives"] = spmd.ledger()
        # only the checked part made whole: a train step's params and
        # moments may not fit one device
        checked = spmd.gather_tree(checked)
    result = [x for x in leaves(checked)
              if torch.is_tensor(x) and x.is_floating_point()]
    res["finite"] = bool(all(torch.isfinite(x).all() for x in result))
    if cell.step_kind == "train":
        res["loss"] = float(checked["loss"])
    if cuda:
        sync()
        peaks = {str(d): int(torch.cuda.max_memory_allocated(d))
                 for d in devs}
        res["peak_bytes"] = max(peaks.values())
        if cell.grid.size > 1:
            res["peak_bytes_by_device"] = peaks
    if check is not None:
        res["check"] = check(cell, whole, out)
    return res


def _product_flops(a_shape, b_shape, *rest, out_shape=None, **kw) -> int:
    """2·m·n·k of an ``mm`` or ``bmm`` of any overload. The port's
    float32-accumulating products (``layers.mm_f32``) call the
    ``out_dtype`` overload, whose dtype arrives positionally, where
    torch's own ``bmm`` formula takes the output's shape (a ``TypeError``
    in torch 2.11 and 2.13)."""
    return 2 * math.prod(out_shape) * a_shape[-1]


def flop_counter():
    """A ``FlopCounterMode`` that counts the port's products (above)."""
    from torch.utils.flop_counter import FlopCounterMode
    aten = torch.ops.aten
    return FlopCounterMode(display=False, custom_mapping={
        aten.mm: _product_flops, aten.bmm: _product_flops})


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def grid_collectives(cell) -> Optional[Dict[str, Dict[str, int]]]:
    """The collectives of one step of ``cell`` on its grid, reckoned by
    running ``Cell.sharded`` on ``meta`` blocks of its argument specs
    (module docstring); None for a cell not run on a grid."""
    from repro_torch.parallel import spmd

    try:
        step = cell.sharded()
    except ValueError:
        return None
    spmd.reset_ledger()
    step(*cell.place(cell.arg_specs))
    return spmd.ledger()


def _reckoned_collectives(cell, probe: Callable):
    """``grid_collectives`` of ``cell``; for a cell of R > 2 repeated
    layers, of its probes at 1 and 2 repeats (``probe(k)`` builds them)
    extrapolated linearly to R, which is exact because every repeat
    makes the same collectives."""
    r = _scan_repeats(cell.cfg)
    if r <= 2:
        return grid_collectives(cell)
    c1 = grid_collectives(probe(1))
    if c1 is None:
        return None
    c2 = grid_collectives(probe(2))
    zero = {"count": 0, "bytes": 0}
    return {op: {key: c1.get(op, zero)[key] + (r - 1) * (
        c2.get(op, zero)[key] - c1.get(op, zero)[key])
        for key in ("count", "bytes")} for op in sorted(set(c1) | set(c2))}


def _allocator(dev) -> Dict[str, int]:
    if dev.type != "cuda":
        return {}
    return {"allocated": int(torch.cuda.memory_allocated(dev)),
            "max_allocated": int(torch.cuda.max_memory_allocated(dev)),
            "reserved": int(torch.cuda.memory_reserved(dev))}


def _run_on(cell, dev, card_bytes: Optional[int], dims, check,
            n_timed: int = TIMED_STEPS) -> Dict[str, Any]:
    """One cell on ``dev`` (``_measure_on``), or why it did not run: the
    arguments a card holds (the whole arguments, or where they are made
    on their places each place's blocks times the places of the busiest
    card) exceed ``card_bytes``."""
    need = argument_bytes(cell)
    out: Dict[str, Any] = {"argument_size_in_bytes": need,
                           "model_flops_global": model_flops_for(cell)}
    if _placed_on_grid(cell):
        per_card = max(Counter(str(d) for d in cell.grid.devices.flat)
                       .values())
        need = argument_bytes(cell, True) * per_card
        out["argument_bytes_on_a_card"] = need
    if card_bytes is not None and need > card_bytes:
        return dict(out, ran=False, fits_one_card=False,
                    reason="arguments exceed the card")
    try:
        out.update(_measure_on(cell, dev, dims, check, n_timed), ran=True,
                   fits_one_card=True)
    except torch.cuda.OutOfMemoryError as e:
        out.update(ran=False, fits_one_card=False,
                   reason="out of memory in the step",
                   oom=str(e).strip().splitlines()[0][:400],
                   allocator=_allocator(dev))
    finally:
        for d in ([dev] if cell.grid.size == 1
                  else _distinct(list(cell.grid.devices.flat))):
            _free(d)
    if out.get("counted_flops"):
        out["useful_flops_ratio"] = (out["model_flops_global"]
                                     / out["counted_flops"])
    return out


def _card_terms(rec: Dict[str, Any]) -> None:
    """The roofline terms (module docstring) and the achieved share of the
    card's bfloat16 peak, from the counted flops, the arguments' bytes and
    the measured step."""
    from repro_torch.launch.mesh import HW
    if rec.get("argument_size_in_bytes") is not None:
        rec["t_memory_s"] = rec["argument_size_in_bytes"] / HW["hbm_bandwidth"]
    if rec.get("counted_flops") is None or not rec.get("step_ms"):
        return
    rec["t_compute_s"] = rec["counted_flops"] / HW["peak_bf16_flops"]
    rec["bf16_peak_share"] = rec["t_compute_s"] / (rec["step_ms"] / 1e3)


def _extrapolated_step(lo, hi, r: int) -> Dict[str, Any]:
    """The step time of ``r`` repeats from the probes at 2 (``lo``) and 3
    (``hi``), with its spread: a probe's spread is the range of its timed
    steps, the per-repeat difference's the sum of the two, and the
    extrapolation's R - 2 times that. Where the difference does not clear
    its spread, noise decides the extrapolation: ``step_ms`` is None and
    the value stands as ``step_ms_unresolved``."""
    diff = hi["step_ms"] - lo["step_ms"]
    spread = sum(max(x["step_ms_all"]) - min(x["step_ms_all"])
                 for x in (lo, hi))
    value = lo["step_ms"] + (r - 2) * diff
    out = {"step_ms_per_repeat": diff, "step_ms_per_repeat_spread": spread,
           "step_ms_spread": (r - 2) * spread, "step_ms": value}
    if diff <= spread:
        out.update(step_ms=None, step_ms_unresolved=value)
    return out


def _card_cell(arch_id, shape_name, smoke, cfg_transform, dims, probes,
               torch_device, card_bytes, check, grid=None,
               devices=None) -> Dict[str, Any]:
    from repro_torch.launch.mesh import (hbm_bytes, make_grid,
                                         make_host_mesh, nvidia_smi_line)
    from repro_torch.launch.steps import build_cell

    if grid is None:
        mesh = make_host_mesh(torch_device)
    else:
        n = math.prod(grid)
        mesh = make_grid(grid, list(devices) if devices is not None
                         else [torch_device] * n)
    dev = mesh.devices.flat[0]
    cuda = dev.type == "cuda"
    if card_bytes is None and cuda:
        card_bytes = hbm_bytes(dev)
    cell = build_cell(arch_id, shape_name, mesh, smoke=smoke,
                      cfg_transform=cfg_transform, dims=dims)
    rec: Dict[str, Any] = {
        "ok": True, "step_kind": cell.step_kind,
        "n_chips": len(_distinct(list(mesh.devices.flat))),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card_bytes": card_bytes, "collectives": {},
        "scan_repeats": _scan_repeats(cell.cfg)}
    if grid is not None:
        rec.update(grid=list(grid), n_places=mesh.size,
                   devices=[str(d) for d in mesh.devices.flat])
        cell.sharded()                  # a cell not run on a grid: raise
        probes = False
    if cuda:
        rec["nvidia_smi"] = nvidia_smi_line()
    rec.update(_run_on(cell, dev, card_bytes, dims, check))
    if cuda:
        _card_terms(rec)
    r = rec["scan_repeats"]
    if probes and r > 2:
        runs = {}
        for k in PROBE_REPEATS:
            probe = build_cell(arch_id, shape_name, mesh, smoke=smoke,
                               cfg_transform=_probe_transform(cfg_transform,
                                                              k), dims=dims)
            runs[k] = _run_on(probe, dev, card_bytes, dims, None,
                              PROBE_TIMED_STEPS)
            if cuda:
                _card_terms(runs[k])
        rec["probes"] = {f"k{k}": v for k, v in runs.items()}
        lo, hi = (runs[k] for k in PROBE_REPEATS)
        if lo["ran"] and hi["ran"]:
            ext = _extrapolated_step(lo, hi, r)
            for key in ("counted_flops", "peak_bytes"):
                if lo.get(key) is not None and hi.get(key) is not None:
                    ext[key] = lo[key] + (r - 2) * (hi[key] - lo[key])
            ext["useful_flops_ratio"] = (rec["model_flops_global"]
                                         / ext["counted_flops"])
            if cuda:
                _card_terms(ext)
                ext["fits_one_card"] = ext["peak_bytes"] <= card_bytes
            rec["extrapolated"] = ext
    return rec


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             out_dir: Path, smoke: bool = False, force: bool = False,
             probes: bool = True, cfg_transform=None, variant: str = "", *,
             dims: Optional[Dict[str, Any]] = None,
             reduced: Optional[Dict[str, Any]] = None,
             torch_device="cuda", card_bytes: Optional[int] = None,
             check: Optional[Callable] = None,
             grid: Optional[tuple] = None,
             devices: Optional[list] = None) -> dict:
    """Reckon one cell on a production grid (``single`` / ``multi``) or
    run it on one card (``card``; module docstring), and write its record
    to ``out_dir/<arch>__<shape>__<mesh>[__smoke][__variant].json``
    (returned as it stands there unless ``force``). ``dims`` and
    ``reduced``: a cut of the shape and its description, kept in the
    record; ``card_bytes``: the card's memory (default: read from the
    card); ``check(cell, args, out)``: called after the counted step, its
    value recorded (on a grid with the whole arguments and the gathered
    output). ``grid`` (dims, e.g. ``(2, 2)``) and ``devices`` (one a
    place, repeats allowed; default ``torch_device`` repeated): run the
    ``card`` cell split over that grid (module docstring); the record's
    name then ends in ``__grid<dims>``."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    tag = f"{arch_id}__{shape_name}__{mesh_kind}" + ("__smoke" if smoke
                                                     else "")
    if variant:
        tag += f"__{variant}"
    if grid is not None:
        tag += "__grid" + "x".join(str(d) for d in grid)
    out_dir = Path(out_dir)
    out_path = out_dir / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    rec: Dict[str, Any] = {"arch": arch_id, "shape": shape_name,
                           "mesh": mesh_kind, "ok": False}
    if variant:
        rec["variant"] = variant
    if reduced:
        rec["reduced"] = reduced
    t0 = time.time()
    try:
        if mesh_kind in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
            cell = build_cell(arch_id, shape_name, mesh, smoke=smoke,
                              cfg_transform=cfg_transform, dims=dims)
            rec.update(ok=True, step_kind=cell.step_kind, n_chips=mesh.size,
                       argument_size_in_bytes=argument_bytes(cell, True),
                       argument_bytes_whole=argument_bytes(cell),
                       model_flops_global=model_flops_for(cell),
                       scan_repeats=_scan_repeats(cell.cfg))
            coll = _reckoned_collectives(
                cell, lambda k: build_cell(
                    arch_id, shape_name, mesh, smoke=smoke,
                    cfg_transform=_probe_transform(cfg_transform, k),
                    dims=dims))
            if coll is not None:
                rec["collectives"] = coll
                rec["collective_bytes_per_device"] = sum(
                    v["bytes"] for v in coll.values())
        elif mesh_kind == "card":
            rec.update(_card_cell(arch_id, shape_name, smoke, cfg_transform,
                                  dims, probes, torch_device, card_bytes,
                                  check, grid, devices))
        else:
            raise ValueError(f"mesh {mesh_kind!r}: single | multi | card")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    status = "OK" if rec["ok"] else "FAIL"
    if rec["ok"] and mesh_kind == "card" and not rec["ran"]:
        status = "NOT RUN"
    print(f"[{status}] {tag} wall={rec['wall_s']}s "
          f"{rec.get('reason', '')}{'err=' + rec['error'] if 'error' in rec else ''}",
          flush=True)
    return rec


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
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "card"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--torch-device", default="cuda",
                    help="the card of --mesh card (cpu: run on the CPU)")
    ap.add_argument("--grid", default=None,
                    help="--mesh card split over a grid, e.g. 2x2")
    ap.add_argument("--devices", default=None,
                    help="the grid's devices in order, comma-separated "
                         "(repeats allowed; default --torch-device "
                         "repeated)")
    ap.add_argument("--fabric", action="store_true",
                    help="smoke the box-fabric planning path (no devices)")
    ap.add_argument("--fabric-shards", type=int, default=4)
    args = ap.parse_args(argv)

    if args.fabric:
        rec = fabric_dryrun(Path(args.out), n_shards=args.fabric_shards)
        return 0 if rec["ok"] else 1
    if not args.all and args.arch is None:
        ap.error("name a cell (--arch [--shape]), --all, or --fabric")

    from repro_torch.configs import all_arch_ids, get_arch

    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    grid = tuple(int(d) for d in args.grid.split("x")) if args.grid \
        else None
    devices = args.devices.split(",") if args.devices else None
    if grid is None and devices is not None:
        ap.error("--devices needs --grid")
    if grid is not None and meshes != ["card"]:
        ap.error("--grid runs a cell on devices: it needs --mesh card")
    if "card" in meshes:
        from repro_torch.core.engine import resolve_torch_device
        resolve_torch_device(args.torch_device)     # no card: raise here
    if args.all:
        cells = [(aid, shp) for aid in all_arch_ids()
                 for shp in get_arch(aid).shape_names()]
    else:
        shapes = [args.shape] if args.shape \
            else get_arch(args.arch).shape_names()
        cells = [(args.arch, s) for s in shapes]

    n_ok = n_fail = 0
    for aid, shp in cells:
        for mk in meshes:
            # probes (two runs more) only on the card: the port's roofline
            # grid, as the reference's are on its single pod
            rec = run_cell(aid, shp, mk, out_dir, smoke=args.smoke,
                           force=args.force, probes=(mk == "card"),
                           torch_device=args.torch_device, grid=grid,
                           devices=devices)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
