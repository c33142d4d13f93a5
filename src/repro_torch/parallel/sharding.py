"""Box scheduling for the streaming executor, the QueryEngine and the
multi-device tier.

Boxes are overlap-free, independent work items (paper §3.3), so sharding
them is pure data parallelism: a list of torch devices (``box_mesh``), a
greedy size-balanced (LPT) assignment of boxes to shards
(``balanced_box_schedule``), and per shard a renumbered *local* neighbor
slice covering only the rows its boxes reference (``iter_shard_local_csr``)
— nothing is replicated. ``TriangleEngine(shard=True)`` runs each shard's
slice as compact CSR on its device; ``shard_local_slices`` is the
reference's padded (n_shards, R, K) layout of the same slices, for small
inputs and parity, and ``local_slice_shape`` its shape from metadata.

The rank-r helpers (``box_mass_costs_nd``, ``shard_shipped_ranges`` and
the §5 interval algebra ``merge_interval`` / ``interval_gaps``) price the
``QueryEngine``'s n-dimensional boxes and plan the byte ranges each
``parallel.fabric`` shard must hold. All of it is numpy in, numpy out.

``dlrm_param_placement`` places DLRM's tables over a device list as row
blocks (``models.dlrm`` sums the per-block bags), and
``dlrm_opt_state_placement`` their AdamW moments in the same blocks.

The per-family sharding rules of the model cells (``launch.steps``) are
the reference's (``src/repro/parallel/sharding.py:30-279``, ``:561-578``),
under its names and contracts, on a named grid
(``launch.mesh.DeviceGrid``) with ``P`` and ``NamedSharding`` standing for
jax's ``PartitionSpec`` and ``NamedSharding``. Grid axes: ("pod", "data",
"model") for two pods or ("data", "model") for one; ``dp`` = the
data-parallel super-axis, ("pod", "data") where the pod axis exists.

  LM   : FSDP over dp + tensor parallelism over model (column/row-parallel
         pairs); MoE experts over model; KV cache sequence-sharded over
         model.
  GNN  : node and edge rows over every axis (flattened); params
         replicated.
  DLRM : embedding tables row(vocab)-sharded over model; MLPs replicated;
         batch over dp.

A dimension an axis does not divide stays whole (``_evenly``), as in the
reference. ``set_rules`` / ``constrain`` keep the reference's activation
rules: ``constraint_spec`` resolves a rule for a shape exactly as the
reference's ``constrain`` does, and ``constrain`` returns its tensor
unchanged: nothing here moves data. A cell split over a grid
(``launch.steps.Cell.sharded``, ``parallel.spmd``) takes its arguments
and gives its outputs under these rules, and lays its activations out by
its own scheme inside the step, so the port's models do not call
``constrain``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch.pytree import (flatten_with_path, leaves, tree_map,
                               tree_map_with_path)

# core.lftj_torch's padding value (imported there from here would cycle:
# core's executor imports this module)
SENTINEL = np.iinfo(np.int32).max


def box_mesh(devices: Optional[Sequence] = None,
             torch_device="cuda") -> List[torch.device]:
    """The shard devices of a box-sharded run: ``devices`` as torch devices
    (a device may repeat: several shards then share it), or
    ``[torch_device]``. Every device is resolved, so ``"cuda"`` raises
    where there is no card, and all must be of one kind."""
    from repro_torch.core.engine import resolve_torch_device

    devs = [resolve_torch_device(d) for d in
            ([torch_device] if devices is None else list(devices))]
    if not devs:
        raise ValueError("box_mesh: empty device list")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"box_mesh: devices of more than one kind: {devs}")
    return devs


def lpt_order(costs: Sequence[float]) -> List[int]:
    """Box indices in Longest-Processing-Time-first order (descending cost,
    ties broken by index so the order is deterministic).

    This is the shared priority order of both box-parallel paths: the
    shard schedule (``balanced_box_schedule`` hands boxes to shards in
    this order) and the async streaming scheduler
    (``core.executor.StreamingExecutor`` drains its work queue in this
    order, so the long-pole box starts first and its device compute
    overlaps every later slice build)."""
    return sorted(range(len(costs)), key=lambda i: (-float(costs[i]), i))


def box_queue_order(costs: Sequence[float],
                    ledger_sensitive: bool) -> List[int]:
    """Priority order a box work-queue is drained in — shared by the
    triangle ``StreamingExecutor`` and the generic ``query.QueryEngine``.

    ``ledger_sensitive=False`` (pure in-memory source): LPT-first — only
    makespan matters, so the long-pole box starts first. With a slice
    cache or a charged block device attached (``ledger_sensitive=True``)
    the queue folds back to plan order: adjacent boxes share row blocks in
    plan order, and because fetches are serialized in queue order this
    keeps the device's LRU frame hits and the cache's hit/miss *sequence*
    identical to the ``workers=1`` oracle (the determinism contract the
    property tests pin).

    The plan-order fallback applies *whenever* a ledger is attached — even
    for a ``workers=1`` caller, where LPT would be equally safe (a serial
    drain IS the oracle in any order). That is deliberate, not an
    oversight: the drain order must be a function of the engine's
    configuration alone, never of its worker count, so a query's measured
    I/O ledger is reproducible across ``workers`` settings and a shard of
    a distributed run (``parallel.fabric``) can be re-executed solo at any
    worker count and land on byte-identical ledgers."""
    if ledger_sensitive:
        return list(range(len(costs)))
    return lpt_order(costs)


# ---------------------------------------------------------------------------
# interval bookkeeping (§5 slice dedup) — shared by the QueryEngine's
# per-box fetch walk and the fabric's rank-r byte-range shipping planner
# ---------------------------------------------------------------------------

def merge_interval(covered: List[Tuple[int, int]], lo: int,
                   hi: int) -> List[Tuple[int, int]]:
    """Insert the inclusive interval [lo, hi] into a sorted disjoint
    interval list, coalescing adjacent/overlapping entries."""
    out: List[Tuple[int, int]] = []
    placed = False
    for a, b in covered:
        if b + 1 < lo:
            out.append((a, b))
        elif hi + 1 < a:
            if not placed:
                out.append((lo, hi))
                placed = True
            out.append((a, b))
        else:
            lo, hi = min(lo, a), max(hi, b)
    if not placed:
        out.append((lo, hi))
    return sorted(out)


def interval_gaps(covered: List[Tuple[int, int]], lo: int,
                  hi: int) -> List[Tuple[int, int]]:
    """Sub-intervals of [lo, hi] not covered yet, ascending."""
    gaps = []
    cur = lo
    for a, b in covered:
        if b < cur:
            continue
        if a > hi:
            break
        if a > cur:
            gaps.append((cur, a - 1))
        cur = max(cur, b + 1)
        if cur > hi:
            break
    if cur <= hi:
        gaps.append((cur, hi))
    return gaps


# ---------------------------------------------------------------------------
# box pricing and shard schedules
# ---------------------------------------------------------------------------

def box_mass_costs_nd(boxes: Sequence[Tuple[Tuple[int, int], ...]],
                      dim_keys: Sequence[Tuple[int, Sequence[str]]],
                      indptr_by_key: Dict[str, np.ndarray]) -> List[int]:
    """Rank-r generalization of ``box_mass_costs``: per-box slice mass in
    raw CSR words for n-dimensional ``QueryPlan`` boxes, from the resident
    degree indexes alone.

    ``dim_keys`` lists, per *owned* dimension, the distinct relation keys
    whose rows that dimension provisions (``QueryEngine.owned_dim_keys()``
    hands exactly this); ``indptr_by_key`` maps each key to its resident
    (V+1)-word prefix sums. Per box, each key's row intervals are walked
    dimension by dimension with the same §5 interval dedup the engine's
    ``_fetch_box`` / ``_est_box_words`` use, so the cost of a box equals
    the raw words its fetch will actually read — the LPT input of
    ``balanced_box_schedule`` and the shipping mass of
    ``shard_shipped_ranges``."""
    costs: List[int] = []
    ips = {k: np.asarray(ip, dtype=np.int64) for k, ip in
           indptr_by_key.items()}
    for box in boxes:
        covered: Dict[str, List[Tuple[int, int]]] = {}
        words = 0
        for d, keys in dim_keys:
            lo, hi = box[d]
            for key in keys:
                ip = ips[key]
                lo_, hi_ = max(int(lo), 0), min(int(hi), len(ip) - 2)
                if hi_ < lo_:
                    continue
                for glo, ghi in interval_gaps(covered.get(key, []),
                                              lo_, hi_):
                    words += int(ip[ghi + 1] - ip[glo])
                covered[key] = merge_interval(covered.get(key, []),
                                              lo_, hi_)
        costs.append(words)
    return costs


def shard_shipped_ranges(boxes: Sequence[Tuple[Tuple[int, int], ...]],
                         schedule: Sequence[Sequence[int]],
                         dim_keys: Sequence[Tuple[int, Sequence[str]]],
                         nv_by_key: Dict[str, int]
                         ) -> List[Dict[str, List[Tuple[int, int]]]]:
    """Per-shard byte-range shipping plan: the rank-r generalization of
    ``shard_local_slices`` at the CSR row-interval layer.

    For every shard in ``schedule`` (lists of box ids) and every relation
    key, returns the sorted disjoint list of vertex-row intervals that
    shard's boxes touch through their owned dimensions — exactly the rows
    whose neighbor bytes a ``fabric.ShippedEdgeSource`` must hold for the
    shard to execute its boxes without reaching back to the origin store.
    Nothing is replicated: a row outside every assigned box's owned ranges
    appears in no interval. The union over shards covers every row some
    box touches (shards may overlap where their boxes share rows — slices
    are read-only)."""
    out: List[Dict[str, List[Tuple[int, int]]]] = []
    for box_ids in schedule:
        ranges: Dict[str, List[Tuple[int, int]]] = {}
        for b in box_ids:
            box = boxes[b]
            for d, keys in dim_keys:
                lo, hi = box[d]
                for key in keys:
                    nv = int(nv_by_key[key])
                    lo_, hi_ = max(int(lo), 0), min(int(hi), nv - 1)
                    if hi_ < lo_:
                        continue
                    ranges[key] = merge_interval(ranges.get(key, []),
                                                 lo_, hi_)
        out.append(ranges)
    return out


def box_mass_costs(indptr: np.ndarray,
                   boxes: Sequence[Tuple[int, int, int, int]]) -> List[int]:
    """Per-box *slice mass* (raw CSR words the box's slice provisions),
    computed from the resident degree index alone: the x-slab's neighbor
    words plus the y-range's, with the x/y overlap deduped (§5) — the same
    accounting ``StreamingExecutor._est_slice_words`` uses for its queue
    window. This is the LPT cost the skew-aware scheduler balances on:
    under a heavy/light plan, a one-row hub box carries its true hub mass
    instead of looking as cheap as its edge count."""
    ip = np.asarray(indptr, dtype=np.int64)
    nv = len(ip) - 1
    costs: List[int] = []
    for (lx, hx, ly, hy) in boxes:
        lx_, hx_ = max(int(lx), 0), min(int(hx), nv - 1)
        ly_, hy_ = max(int(ly), 0), min(int(hy), nv - 1)
        if hx_ < lx_ or hy_ < ly_:
            costs.append(0)
            continue
        words = int(ip[hx_ + 1] - ip[lx_])
        for seg_lo, seg_hi in ((ly_, min(hy_, lx_ - 1)),
                               (max(ly_, hx_ + 1), hy_)):
            if seg_hi >= seg_lo:
                words += int(ip[seg_hi + 1] - ip[seg_lo])
        costs.append(words)
    return costs


def balanced_box_schedule(costs: Sequence[float],
                          n_shards: int) -> List[List[int]]:
    """Greedy LPT: assign each box (descending cost) to the least-loaded
    shard. Returns ``n_shards`` lists of box indices. Classic 4/3-OPT
    makespan bound — good enough given per-box costs are themselves
    estimates (in-box edge counts)."""
    shards: List[List[int]] = [[] for _ in range(max(1, n_shards))]
    loads = np.zeros(max(1, n_shards))
    for i in lpt_order(costs):
        s = int(np.argmin(loads))
        shards[s].append(i)
        loads[s] += costs[i]
    return shards


# ---------------------------------------------------------------------------
# per-shard local slices
# ---------------------------------------------------------------------------

class ShardSlice(NamedTuple):
    """One shard's renumbered local slice in compact CSR form: its boxes'
    edges concatenated in schedule order as local row ids ``eu``/``ev``,
    the distinct rows they reference (sorted global ids: ``rows[eu]`` are
    the edges' global sources) and those rows' neighbor lists (``deg``,
    ``vals``)."""

    eu: np.ndarray
    ev: np.ndarray
    rows: np.ndarray
    deg: np.ndarray
    vals: np.ndarray

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([np.zeros(1, np.int64),
                               np.cumsum(self.deg, dtype=np.int64)])


def iter_shard_local_csr(edge_lists: Sequence[Tuple[np.ndarray,
                                                    np.ndarray]],
                         schedule: Sequence[Sequence[int]],
                         gather: Callable[[np.ndarray],
                                          Tuple[np.ndarray, np.ndarray]]
                         ) -> Iterator[ShardSlice]:
    """Per-shard renumbered local slices, nothing replicated, one at a
    time in schedule order: its boxes' (eu, ev) edges, the distinct
    endpoint rows, and their neighbor lists fetched through
    ``gather(rows) -> (deg, concat_values)`` (charged there when the
    source is). Per-device memory scales with the shard's slice, not the
    graph; no padded matrix is built."""
    for boxes in schedule:
        if boxes:
            gu = np.concatenate([edge_lists[b][0] for b in boxes])
            gv = np.concatenate([edge_lists[b][1] for b in boxes])
            rows = np.unique(np.concatenate([gu, gv]))
        else:
            gu = gv = np.zeros(0, np.int64)
            rows = np.zeros(0, np.int64)
        deg, vals = gather(rows)
        yield ShardSlice(np.searchsorted(rows, gu), np.searchsorted(rows, gv),
                         rows, np.asarray(deg, np.int64), vals)


def local_slice_shape(slices: Sequence[ShardSlice]) -> Tuple[int, int, int]:
    """(n_shards, R, K) of the reference's padded layout of ``slices``:
    R = the most rows a shard references + 1 (the all-SENTINEL pad row),
    K = the widest referenced row (at least 1). Host metadata only."""
    r = max([len(s.rows) for s in slices] + [0]) + 1
    k = max([int(s.deg.max(initial=1)) for s in slices] + [1])
    return len(slices), r, k


def shard_local_slices(edge_lists: Sequence[Tuple[np.ndarray, np.ndarray]],
                       schedule: Sequence[Sequence[int]],
                       gather,
                       pad_multiple: int = 1):
    """Per-shard *renumbered local* neighbor slices in the reference's
    padded layout (``iter_shard_local_csr`` padded out). Device arrays scale
    with the shard's slice — rows×K_local — instead of the global V×K_max
    matrix, but K_local is still the widest row any shard references, so
    on a skewed graph this layout is for small inputs and metadata only.

    Returns ``(eu, ev, valid, npad, rows)``:

      * ``eu``/``ev``/``valid``: (n_shards, L) local edge endpoints (row ids
        into the shard's slice); padded slots reference the shard's
        all-SENTINEL pad row and carry valid == 0;
      * ``npad``: (n_shards, R, K) per-shard padded neighbor matrices, where
        R = max referenced rows + 1 (pad row) and K = max referenced degree;
      * ``rows``: (n_shards, R) local row id -> global vertex id (-1 pads).
    """
    slices = list(iter_shard_local_csr(edge_lists, schedule, gather))
    n_shards, R, K = local_slice_shape(slices)
    lmax = max([len(s.eu) for s in slices] + [1])
    L = int(-(-lmax // pad_multiple) * pad_multiple)

    npad_s = np.full((n_shards, R, K), SENTINEL, np.int32)
    rows_s = np.full((n_shards, R), -1, np.int64)
    eu_s = np.zeros((n_shards, L), np.int32)
    ev_s = np.zeros((n_shards, L), np.int32)
    ok_s = np.zeros((n_shards, L), np.int32)
    for s, slc in enumerate(slices):
        pad_row = len(slc.rows)        # all-SENTINEL: intersects to zero
        eu_s[s, :] = pad_row
        ev_s[s, :] = pad_row
        rows_s[s, :len(slc.rows)] = slc.rows
        if len(slc.rows):
            deg = slc.deg
            rr = np.repeat(np.arange(len(slc.rows)), deg)
            cc = np.arange(int(deg.sum())) \
                - np.repeat(np.cumsum(deg) - deg, deg)
            npad_s[s, rr, cc] = slc.vals
        if len(slc.eu):
            eu_s[s, :len(slc.eu)] = slc.eu
            ev_s[s, :len(slc.ev)] = slc.ev
            ok_s[s, :len(slc.eu)] = 1
    return eu_s, ev_s, ok_s, npad_s, rows_s


# ---------------------------------------------------------------------------
# DLRM tables over a device list (the reference's dlrm_param_sharding run:
# tables vocab-sharded over the model axis, everything else replicated)
# ---------------------------------------------------------------------------

def table_row_block(v: int, n_devices: int) -> int:
    """Rows of each device's block of a ``v``-row table sharded over
    ``n_devices``, or 0 when the table stays whole (one device, or ``v``
    not a multiple of ``n_devices``)."""
    return v // n_devices if n_devices > 1 and v % n_devices == 0 else 0


def dlrm_param_placement(params: Dict[str, torch.Tensor],
                         devices: Sequence) -> Dict[str, List[torch.Tensor]]:
    """DLRM params placed over ``devices`` (repeats allowed), per name one
    tensor per device: a ``table*`` whose row count divides by
    ``len(devices)`` cut into equal contiguous row blocks, block i on
    ``devices[i]``; every other param replicated. A block or replica on
    the device its param already lies on is a view of it, not a copy.
    ``models.dlrm``'s ``forward(..., devices=devices)`` reads this layout:
    batch and candidate sharding are not ported."""
    devs = box_mesh(devices)
    out: Dict[str, List[torch.Tensor]] = {}
    for name, p in params.items():
        blk = table_row_block(p.shape[0], len(devs)) \
            if name.startswith("table") else 0
        if blk:
            out[name] = [p[i * blk:(i + 1) * blk].to(dev)
                         for i, dev in enumerate(devs)]
        else:
            out[name] = [p.to(dev) for dev in devs]
    return out


def dlrm_opt_state_placement(state, devices: Sequence):
    """An ``optim.adamw.OptState`` of DLRM params placed as
    ``dlrm_param_placement`` places the params: each ``table*`` moment cut
    into the same row blocks, every other moment replicated, the step on
    ``devices[0]``. ``models.dlrm.make_sparse_train_step(...,
    devices=devices)`` reads this layout. (The reference's
    ``shard_moments_2d`` shards the moments over (model, dp); a device list
    has one axis, so the moments follow the tables.)"""
    devs = box_mesh(devices)
    return type(state)(state.step.to(devs[0]),
                       dlrm_param_placement(state.m, devs),
                       dlrm_param_placement(state.v, devs))


# ---------------------------------------------------------------------------
# partition specs on a named grid (jax's PartitionSpec and NamedSharding)
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry per leading dimension, each ``None``
    (whole), an axis name, or a tuple of axis names (split over their
    product). Dimensions past the last entry stay whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` over the grid ``mesh`` (a ``launch.mesh.DeviceGrid``)."""
    mesh: Any
    spec: P

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's block of a ``shape`` array; raises
        ``ValueError`` where a split dimension does not divide."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {shape}")
        out = list(shape)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            n = math.prod(self.mesh.shape[a] for a in _axes(entry))
            if shape[i] % n:
                raise ValueError(f"dimension {i} of {shape} does not divide "
                                 f"by {n} ({entry!r})")
            out[i] = shape[i] // n
        return tuple(out)


def _ns(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def _is_shape_leaf(x) -> bool:
    """A leaf of a ``param_shapes`` tree: ``(shape tuple, dtype)``."""
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def _evenly(dim: int, mesh, axes) -> bool:
    return dim % math.prod(mesh.shape[a] for a in _axes(axes)) == 0


# ---------------------------------------------------------------------------
# activation rules: the reference's models call ``constrain(x, kind)`` and
# its cells set a rule set for the cell's grid (module docstring)
# ---------------------------------------------------------------------------

_RULES: Optional[Dict[str, Any]] = None
_RULES_MESH = None


def set_rules(mesh, family: Optional[str]) -> None:
    global _RULES, _RULES_MESH
    if mesh is None or family is None:
        _RULES, _RULES_MESH = None, None
        return
    dp = dp_axes(mesh)
    alln = all_axes(mesh)
    if family == "lm":
        _RULES = {
            "lm_act": (dp, "model", None),         # (B, S, D)
            "lm_logits": (dp, None, "model"),      # (B, S, V)
            "lm_logits2": (dp, "model"),           # (B, V)
            "moe_ge": (dp, "model", None, None),   # (B, E, cap, D)
            "moe_x_local": (dp, None, None),
            "attn_q": (dp, None, None, "model", None),   # (B, KV, G, Q, S)
            "attn_s": (dp, None, None, None, "model"),
            "mla_scores": (dp, "model", None, None),     # (B, H, Q, S)
        }
    elif family == "gnn":
        _RULES = {"gnn_nodes": (alln, None)}       # (N, D)
    elif family == "recsys":
        _RULES = {"dlrm_act": (dp, None),          # (B, D)
                  "dlrm_rows": (None, None)}
    _RULES_MESH = mesh


def constraint_spec(shape, kind: str) -> Optional[P]:
    """The spec the reference's ``constrain`` would put on an array of
    ``shape`` under the rules set now: the rule's entries for the leading
    dimensions, an entry whose axes do not divide its dimension dropped to
    ``None``; ``None`` when no rule applies."""
    if _RULES is None or kind not in _RULES:
        return None
    resolved = []
    for i, a in enumerate(_RULES[kind][:len(shape)]):
        resolved.append(a if a is not None
                        and _evenly(shape[i], _RULES_MESH, a) else None)
    return P(*resolved)


def constrain(x, kind: str):
    """``x`` itself: the constraint is resolved (``constraint_spec``) and
    moves nothing (module docstring)."""
    constraint_spec(x.shape, kind)
    return x


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def _lm_leaf_spec(name: str, shape, mesh) -> P:
    dp = dp_axes(mesh)
    nd = len(shape)
    # stacked blocks carry a leading layer axis -> never sharded
    lead = (None,) if name.startswith("block") else ()
    core = shape[len(lead):]
    key = name.split("/")[-1]

    def fit(dim, axes):
        return _evenly(dim, mesh, axes)

    if key in ("norm1", "norm2", "final_norm", "q_a_norm", "kv_a_norm"):
        return P(*lead, None)
    if key in ("bq", "bk", "bv"):
        return P(*lead, "model") if fit(core[0], "model") else P(*lead, None)
    if key == "embed":
        return P("model" if fit(core[0], "model") else None,
                 dp if fit(core[1], dp) else None)
    if key == "lm_head":
        return P(dp if fit(core[0], dp) else None,
                 "model" if fit(core[1], "model") else None)
    if key == "router":
        return P(*lead, dp if fit(core[0], dp) else None, None)
    if key in ("wi", "shared_wi", "wq", "wk", "wv", "wq_b", "wkv_b"):
        if len(core) == 3:  # MoE expert-stacked (E, D, F): experts over model
            return P(*lead, "model" if fit(core[0], "model") else None,
                     dp if fit(core[1], dp) else None, None)
        return P(*lead, dp if fit(core[0], dp) else None,
                 "model" if fit(core[1], "model") else None)
    if key in ("wo", "shared_wo"):
        if len(core) == 3:  # (E, F, D)
            return P(*lead, "model" if fit(core[0], "model") else None,
                     None, dp if fit(core[2], dp) else None)
        return P(*lead, "model" if fit(core[0], "model") else None,
                 dp if fit(core[1], dp) else None)
    if key in ("wq_a", "wkv_a"):
        return P(*lead, dp if fit(core[0], dp) else None, None)
    # fallback: shard the largest fitting dim over dp
    spec = [None] * nd
    for i in np.argsort([-s for s in shape]):
        if fit(shape[i], dp):
            spec[i] = dp
            break
    return P(*spec)


def lm_param_sharding(mesh, shapes_tree) -> Any:
    """Map the {name: (shape, dtype)} tree to NamedShardings."""
    def leaf(path, x):
        top, name = path[0], path[-1]
        if top.startswith("block"):
            name = f"{top}/{name}"
        return _ns(mesh, _lm_leaf_spec(name, x[0], mesh))
    return tree_map_with_path(leaf, shapes_tree, is_leaf=_is_shape_leaf)


def lm_batch_sharding(mesh, specs: Dict[str, Any]) -> Any:
    dp = dp_axes(mesh)

    def spec_for(k, v):
        if k in ("tokens", "targets", "token"):
            ax = dp if _evenly(v.shape[0], mesh, dp) else None
            return _ns(mesh, P(ax, *([None] * (len(v.shape) - 1))))
        if k == "pos":
            return _ns(mesh, P())
        raise KeyError(k)

    return {k: spec_for(k, v) if k != "cache" else None
            for k, v in specs.items()}


def lm_cache_sharding(mesh, cache_tree) -> Any:
    """KV caches: batch->dp, sequence->model (flash-decode style).
    Stacked-vs-unstacked is decided by the tree path ('block*' subtrees
    carry a leading layer axis, 'prefix*' do not)."""
    dp = dp_axes(mesh)

    def leaf(path, x):
        nd = len(x.shape)
        if path[0].startswith("block"):      # stacked (L, B, S, ...)
            spec = [None, dp, "model"] + [None] * (nd - 3)
        else:                                # (B, S, ...)
            spec = [dp, "model"] + [None] * (nd - 2)
        for i, a in enumerate(spec):
            if a is not None and not _evenly(x.shape[i], mesh, a):
                spec[i] = None
        return _ns(mesh, P(*spec))
    return tree_map_with_path(leaf, cache_tree)


# ---------------------------------------------------------------------------
# GNN / DLRM
# ---------------------------------------------------------------------------

def gnn_param_sharding(mesh, shapes_tree) -> Any:
    return tree_map(lambda x: _ns(mesh, P()), shapes_tree,
                    is_leaf=_is_shape_leaf)


def gnn_batch_sharding(mesh, specs: Dict[str, Any]) -> Any:
    axes = all_axes(mesh)

    def leaf(v):
        if not hasattr(v, "shape") or len(v.shape) == 0:
            return _ns(mesh, P())
        if _evenly(v.shape[0], mesh, axes):
            return _ns(mesh, P(axes, *([None] * (len(v.shape) - 1))))
        return _ns(mesh, P())

    return {k: leaf(v) for k, v in specs.items()}


def dlrm_param_sharding(mesh, shapes_tree) -> Any:
    """Tables over 'model' by rows where it divides them; the rest
    replicated."""
    def leaf(path, x):
        if path[-1].startswith("table") and _evenly(x[0][0], mesh, "model"):
            return _ns(mesh, P("model", None))
        return _ns(mesh, P())
    return tree_map_with_path(leaf, shapes_tree, is_leaf=_is_shape_leaf)


def dlrm_batch_sharding(mesh, specs: Dict[str, Any]) -> Any:
    dp = dp_axes(mesh)

    def leaf(k, v):
        if k == "candidates":
            ax = "model" if _evenly(v.shape[0], mesh, "model") else None
            return _ns(mesh, P(ax, None))
        if len(v.shape) == 0 or not _evenly(v.shape[0], mesh, dp):
            return _ns(mesh, P())
        return _ns(mesh, P(dp, *([None] * (len(v.shape) - 1))))

    return {k: leaf(k, v) for k, v in specs.items()}


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------

def replicate(mesh, tree) -> Any:
    return tree_map(lambda _: _ns(mesh, P()), tree)


def like_tree(sharding_tree, template_tree) -> Any:
    """Re-key a sharding tree onto an identically-structured template:
    the i-th leaf of one, in the reference's order, at the i-th leaf of
    the other."""
    paths = [path for path, _ in flatten_with_path(template_tree)]
    at = dict(zip(paths, leaves(sharding_tree)))
    return tree_map_with_path(lambda path, _: at[path], template_tree)


def opt_state_sharding(param_sharding, opt_state_tree):
    """Moments shard like params; the step counter is replicated."""
    from repro_torch.optim.adamw import OptState
    first = leaves(param_sharding)[0]
    return OptState(step=_ns(first.mesh, P()), m=param_sharding,
                    v=param_sharding)
