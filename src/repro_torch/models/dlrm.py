"""DLRM (MLPerf config): sparse embedding tables + dot interaction + MLPs.

The port of ``src/repro/models/dlrm.py``: serving (``forward``,
``serve_step``, ``retrieval_score``), ``loss_fn`` and training
(``make_sparse_train_step``, and ``train_step``, the dense step). The embedding lookup is the hot path. The reference takes
``jnp.take(tab, jnp.minimum(idx, V - 1))`` and a float32 sum over the bag;
here each index is clamped to V - 1 the same way and the bag summed by
``embedding_bag(table, idx, mode="auto")``: on the card one of the two
hand-written kernels (``csrc/embedding_bag.cu``, bfloat16 rows widened to
float32 and added in slot order), on CPU tensors its plain version.
``use_kernels=False`` takes the plain version on any device (the smoke
test's yardstick). Without the clamp an index >= V would be an empty slot
there, not the last row; with it, the gradient of an index >= V goes to
row V - 1, as the reference's clamped ``jnp.take`` sends it.

A table that requires a gradient is looked up through
``kernels.embedding_bag.grad.embedding_bag_grad``, whose backward is the
hand-written ``csrc/embedding_bag_backward.cu`` on the card: each row's
gradient summed in float32 in slot order and cast once to the table's
type (the reference's XLA scatter-add sums a bfloat16 table's gradient in
bfloat16).

Tables may be row-sharded over a device list (``devices=[...]`` with the
params of ``parallel.sharding.dlrm_param_placement``): a bag-sum over a
row-sharded table is a local masked bag-sum per shard followed by a sum of
the partial bags on ``devices[0]`` (the reference's psum over the
``model`` axis): the sum over bag slots commutes with the shard sum, so no
rows move between devices. On a named grid (``grid_serve``, under the
cell's shardings, ``launch.steps.Cell.sharded``) the batch rows follow the
places' ``dp`` index, the candidates are split over ``model``, and the
partial bags are all-reduced over ``model`` in grid order, their sum on
every place of the row.

The dense parts are plain PyTorch: the MLPs are ``x @ w + b`` in float32,
the interaction one ``torch.bmm`` and fixed lower-triangle indices, as the
reference leaves them to XLA outside any Pallas kernel. TF32 stays at
PyTorch's default (off), so the products are full float32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core.engine import resolve_torch_device
from repro_torch.kernels.embedding_bag.grad import embedding_bag_grad
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import table_row_block

from . import layers as L
from .layers import abstractify, batch_tensor, materialize

FDTYPE = torch.float32

# Criteo-1TB per-field vocabulary sizes (MLPerf DLRM benchmark config).
CRITEO_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    embed_dim: int = 128
    table_sizes: Tuple[int, ...] = CRITEO_TABLE_SIZES
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    hot: int = 1                      # multi-hot size per field
    sparse_optimizer: bool = False    # row-sparse table updates (§Perf)
    shard_moments_2d: bool = False    # ZeRO-style (model, dp) moment shard

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    def params_count(self) -> int:
        n = sum(self.table_sizes) * self.embed_dim
        dims = [self.n_dense] + list(self.bot_mlp)
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        n_int = self.n_sparse + 1
        d_top = self.embed_dim + n_int * (n_int - 1) // 2
        dims = [d_top] + list(self.top_mlp)
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return n


def param_shapes(cfg: DLRMConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    for t, v in enumerate(cfg.table_sizes):
        s[f"table{t}"] = ((v, cfg.embed_dim), L.PDTYPE)
    dims = [cfg.n_dense] + list(cfg.bot_mlp)
    for i in range(len(dims) - 1):
        s[f"bot_w{i}"] = ((dims[i], dims[i + 1]), FDTYPE)
        s[f"bot_b{i}"] = ((dims[i + 1],), FDTYPE)
    n_int = cfg.n_sparse + 1
    d_top = cfg.embed_dim + n_int * (n_int - 1) // 2
    dims = [d_top] + list(cfg.top_mlp)
    for i in range(len(dims) - 1):
        s[f"top_w{i}"] = ((dims[i], dims[i + 1]), FDTYPE)
        s[f"top_b{i}"] = ((dims[i + 1],), FDTYPE)
    return s


def init_params(cfg: DLRMConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Random params on ``device`` (``"cuda"`` raises without CUDA), drawn
    from ``generator`` (default: a generator on that device seeded 0) by
    the reference's name-aware rule (``layers.materialize``)."""
    dev = resolve_torch_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return materialize(param_shapes(cfg), generator, dev)


def param_specs(cfg: DLRMConfig) -> Dict[str, torch.Tensor]:
    return abstractify(param_shapes(cfg))


def _mlp(params, x, prefix, n):
    for i in range(n):
        x = x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


@functools.lru_cache(maxsize=64)
def _clamp_bounds(sizes: Tuple[int, ...], device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """(1, T, 1) of V_t - 1: every field's clamp in one op."""
    return torch.tensor([v - 1 for v in sizes], dtype=dtype,
                        device=device).view(1, -1, 1)


@functools.lru_cache(maxsize=16)
def _tril_flat(n: int, device: torch.device) -> torch.Tensor:
    """Flat positions i * n + j of the strict lower triangle of an (n, n)
    matrix, in ``torch.tril_indices`` order (the reference's
    ``np.tril_indices(n, k=-1)``)."""
    iu, ju = torch.tril_indices(n, n, offset=-1, device=device)
    return iu * n + ju


def _dense_params(params, devices) -> Dict[str, torch.Tensor]:
    """The MLP params: as they are, or (sharded params) their copies on
    ``devices[0]``."""
    if devices is None:
        return params
    return {k: v[0] for k, v in params.items() if not k.startswith("table")}


def _bag_of(use_kernels: bool):
    """The bag-sum ``embedding_lookups`` runs: through the autograd
    Function for a table that requires a gradient (with grad mode on),
    else the wrapper or its plain version directly."""
    plain = embedding_bag if use_kernels else embedding_bag_ref

    def bag(table, idx):
        if table.requires_grad and torch.is_grad_enabled():
            return embedding_bag_grad(table, idx, use_kernels=use_kernels)
        return plain(table, idx)
    return bag


def _sharded_bag(bag, shards: Sequence[torch.Tensor], idx: torch.Tensor,
                 blk: int, devices: Sequence) -> torch.Tensor:
    """One field's bags over a row-sharded table: per shard, the indices
    outside its block sent to PAD (= its row count) before the launch, the
    local bag-sum, then the partial bags summed on ``devices[0]`` in shard
    order."""
    out = None
    for i, (shard, dev) in enumerate(zip(shards, devices)):
        local = idx.to(dev) - i * blk
        local = torch.where((local >= 0) & (local < blk), local, blk)
        part = bag(shard, local).to(devices[0])
        out = part if out is None else out + part
    return out


def embedding_lookups(cfg: DLRMConfig, params, sparse: torch.Tensor, *,
                      use_kernels: bool = True,
                      devices: Optional[Sequence] = None
                      ) -> List[torch.Tensor]:
    """The 26 (here ``cfg.n_sparse``) bag-sums of ``sparse`` (B, T, hot):
    per field t, ``table_t[min(idx, V_t - 1)]`` widened to float32 and
    summed over the bag, a (B, D) float32 tensor. ``use_kernels`` picks
    ``embedding_bag`` (the kernels on the card) or its plain version.
    With ``devices``, ``params`` are ``dlrm_param_placement``'s per-device
    lists and every result lies on ``devices[0]``."""
    bag = _bag_of(use_kernels)
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    bounds = _clamp_bounds(tuple(cfg.table_sizes), sparse.device,
                           sparse.dtype)
    # (T, B, hot): each field's clamped indices contiguous
    clamped = torch.minimum(sparse, bounds).transpose(0, 1).contiguous()
    out = []
    for t, v in enumerate(cfg.table_sizes):
        tab = params[f"table{t}"]
        if devices is None:
            out.append(bag(tab, clamped[t]))
            continue
        blk = table_row_block(v, len(devices))
        if blk:
            out.append(_sharded_bag(bag, tab, clamped[t], blk, devices))
        else:
            out.append(bag(tab[0], clamped[t]))
    return out


def forward(cfg: DLRMConfig, params, batch: Dict[str, Any], *,
            use_kernels: bool = True,
            devices: Optional[Sequence] = None) -> torch.Tensor:
    """batch: dense (B, 13) f32, sparse (B, 26, hot) int32 -> logits (B,).
    Arrays or tensors; moved to the params' device (``devices[0]`` when
    the tables are sharded)."""
    p = _dense_params(params, devices)
    dev = p["bot_w0"].device
    dense = batch_tensor(batch, "dense", dev, FDTYPE)
    sparse = batch_tensor(batch, "sparse", dev)
    x_dense = _mlp(p, dense, "bot", len(cfg.bot_mlp))            # (B, D)
    embs = embedding_lookups(cfg, params, sparse, use_kernels=use_kernels,
                             devices=devices)
    return _interact_top(cfg, p, x_dense, embs)


def _interact_top(cfg: DLRMConfig, p, x_dense: torch.Tensor,
                  embs: List[torch.Tensor]) -> torch.Tensor:
    """The logits (B,) from the bottom tower's output and the bags."""
    z = torch.stack([x_dense] + embs, dim=1)                     # (B, 27, D)
    # dot interaction: lower-triangular pairwise dots, gathered from the
    # flattened (B, 27 * 27) products by one index_select (whose backward
    # is one index_add; advanced indexing's took 5.5 ms of a train step on
    # the card)
    zz = torch.bmm(z, z.transpose(1, 2))                         # (B, 27, 27)
    pairs = zz.flatten(1).index_select(
        1, _tril_flat(cfg.n_sparse + 1, z.device))               # (B, 351)
    top_in = torch.cat([x_dense, pairs], dim=-1)
    return _mlp(p, top_in, "top", len(cfg.top_mlp))[:, 0]


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The mean BCE-with-logits, in the reference's numerically stable
    form."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * y +
                      torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(cfg: DLRMConfig, params, batch, **kw):
    """(loss, {"bce": loss}): the mean BCE-with-logits of ``forward``,
    differentiable in every param that requires a gradient, the tables
    included."""
    logits = forward(cfg, params, batch, **kw)
    loss = _bce(logits, batch_tensor(batch, "labels", logits.device, FDTYPE))
    return loss, {"bce": loss}


def train_step(cfg: DLRMConfig, opt_cfg: adamw.AdamWConfig, params,
               opt_state: adamw.OptState, batch, *, use_kernels: bool = True):
    """The reference's dense DLRM step (``src/repro/launch/steps.py:223-228``):
    the gradient of ``loss_fn`` through every param, the tables included,
    then ``adamw.apply``, in place. Returns (params, opt_state, {"loss",
    "grad_norm", "lr"})."""
    loss, _, grads = L.value_and_grad(
        lambda p: loss_fn(cfg, p, batch, use_kernels=use_kernels), params)
    params, opt_state, om = adamw.apply(opt_cfg, params, grads, opt_state)
    return params, opt_state, {"loss": loss, **om}


def serve_step(cfg: DLRMConfig, params, batch, **kw) -> torch.Tensor:
    """Online/offline scoring: forward only, sigmoid CTR."""
    return torch.sigmoid(forward(cfg, params, batch, **kw))


def retrieval_score(cfg: DLRMConfig, params, batch, *,
                    use_kernels: bool = True,
                    devices: Optional[Sequence] = None):
    """retrieval_cand shape: one query against n_candidates item vectors.

    query: dense (1, 13) + sparse (1, 26, hot) -> user vector via the bottom
    tower plus each field's bag, added one by one in field order;
    candidates (C, D) scored by one product, the top min(100, C) returned
    as (scores, indices), each (1, k), best first."""
    p = _dense_params(params, devices)
    dev = p["bot_w0"].device
    dense = batch_tensor(batch, "dense", dev, FDTYPE)
    x_user = _mlp(p, dense, "bot", len(cfg.bot_mlp))             # (1, D)
    sparse = batch_tensor(batch, "sparse", dev)
    for vec in embedding_lookups(cfg, params, sparse,
                                 use_kernels=use_kernels, devices=devices):
        x_user = x_user + vec
    cand = batch_tensor(batch, "candidates", dev, FDTYPE)         # (C, D)
    scores = x_user @ cand.T                                     # (1, C)
    k = min(100, cand.shape[0])
    top_s, top_i = torch.topk(scores, k, dim=-1)
    return top_s, top_i


# ---------------------------------------------------------------------------
# serving on a named device grid (parallel.spmd)
# ---------------------------------------------------------------------------

def _grid_bag(table, idx):
    """The serving bag-sum on a place (``embedding_bag``), or its shape on
    an abstract grid's ``meta`` blocks."""
    if table.is_meta:
        return torch.empty((idx.shape[0], table.shape[1]),
                           dtype=torch.float32, device="meta")
    return embedding_bag(table, idx)


def _grid_lookups(cfg: DLRMConfig, tables, split, sparse, grid, p: int):
    """One place's 26 bags (a generator, ``spmd.lockstep``): a table
    split over ``model`` is looked up in the place's row block with the
    other rows' slots sent to PAD (the block's row count), and the partial
    bags all-reduced over ``model`` in grid order; a whole table is looked
    up whole."""
    from repro_torch.parallel import spmd

    k = spmd.axis_size(grid, "model")
    m = spmd.coord(grid, p, "model")
    bounds = _clamp_bounds(tuple(cfg.table_sizes), sparse.device,
                           sparse.dtype)
    clamped = torch.minimum(sparse, bounds).transpose(0, 1).contiguous()
    out = []
    for t, v in enumerate(cfg.table_sizes):
        tab = tables[f"table{t}"]
        if not split[t]:
            out.append(_grid_bag(tab, clamped[t]))
            continue
        blk = v // k
        local = clamped[t] - m * blk
        local = torch.where((local >= 0) & (local < blk), local, blk)
        out.append((yield spmd.AllReduce(_grid_bag(tab, local), "model")))
    return out


def _grid_place(cfg: DLRMConfig, kind: str, params, split, batch, grid,
                p: int):
    """One place's serving step (a generator): ``serve_step``'s scores of
    its batch rows, or ``retrieval_score``'s top candidates, the
    candidates split over ``model`` where the rules split them."""
    from repro_torch.parallel import spmd

    x = _mlp(params, batch["dense"], "bot", len(cfg.bot_mlp))
    embs = yield from _grid_lookups(cfg, params, split, batch["sparse"],
                                    grid, p)
    if kind == "serve":
        return torch.sigmoid(_interact_top(cfg, params, x, embs))
    for vec in embs:
        x = x + vec
    cand = batch["candidates"]
    scores = x @ cand.T
    n_all = batch["n_candidates"]
    k = min(100, n_all)
    if cand.shape[0] == n_all:
        return tuple(torch.topk(scores, k, dim=-1))
    top_s, top_i = torch.topk(scores, min(k, cand.shape[0]), dim=-1)
    top_i = top_i + spmd.coord(grid, p, "model") * cand.shape[0]
    all_s = yield spmd.AllGather(top_s, "model", 1)
    all_i = yield spmd.AllGather(top_i, "model", 1)
    best_s, at = torch.topk(all_s, k, dim=-1)
    return best_s, torch.gather(all_i, 1, at)


def grid_serve(cfg: DLRMConfig, kind: str, params, batch) -> list:
    """``serve_step`` (``kind="serve"``) or ``retrieval_score``
    (``"retrieval"``) on a grid: ``params`` and ``batch`` dicts of
    ``spmd.Sharded`` under ``dlrm_param_sharding`` /
    ``dlrm_batch_sharding``; one output a place (the scores of its batch
    rows, or the (scores, indices) of the top candidates). A split table
    is looked up per block with its partial bags all-reduced over
    ``model``; the batch rows follow the places' ``dp`` index; the
    candidates' blocks are scored where they lie and the blocks' best
    all-gathered over ``model``."""
    from repro_torch.parallel import spmd

    grid = batch["dense"].grid
    split = [params[f"table{t}"].spec[:1] == ("model",)
             for t in range(cfg.n_sparse)]
    n_places = len(spmd.places(grid))
    progs = []
    for p in range(n_places):
        local = spmd.blocks_at(batch, p)
        if kind == "retrieval":
            local["n_candidates"] = batch["candidates"].shape[0]
        progs.append(_grid_place(cfg, kind, spmd.blocks_at(params, p),
                                 split, local, grid, p))
    return spmd.lockstep(grid, progs)


# ---------------------------------------------------------------------------
# row-sparse embedding training
# ---------------------------------------------------------------------------

def _gather_rows(shards: Sequence[torch.Tensor], safe: torch.Tensor,
                 blk: int, devices: Sequence) -> torch.Tensor:
    """Rows ``safe`` (on ``devices[0]``) of a table row-sharded in blocks
    of ``blk`` rows, each gathered from the shard that holds it and
    selected (not added) into one tensor on ``devices[0]``."""
    out = None
    for i, (shard, dev) in enumerate(zip(shards, devices)):
        local = safe.to(dev) - i * blk
        part = shard.index_select(0, local.clamp(0, blk - 1)).to(devices[0])
        if out is None:
            out = part
        else:
            inb = ((local >= 0) & (local < blk)).to(devices[0])
            out = torch.where(inb[:, None], part, out)
    return out


def _scatter_add(shards: Sequence[torch.Tensor], safe: torch.Tensor,
                 delta: torch.Tensor, blk: int, devices: Sequence) -> None:
    """``shard[safe - i * blk] += delta`` in place on the shard that holds
    each row; the other shards add -0.0, which changes no value."""
    for i, (shard, dev) in enumerate(zip(shards, devices)):
        local = safe.to(dev) - i * blk
        inb = (local >= 0) & (local < blk)
        d = torch.where(inb[:, None], delta.to(dev),
                        torch.full((), -0.0, dtype=delta.dtype, device=dev))
        shard.index_add_(0, local.clamp(0, blk - 1), d)


def _sync_replicas(replicas: Sequence[torch.Tensor]) -> None:
    """Copy replica 0 into every other replica that is not the same memory
    (on a repeated device list the replicas are views of one tensor, and
    updating each would apply a step twice)."""
    first = replicas[0]
    for r in replicas[1:]:
        if r.device != first.device or r.data_ptr() != first.data_ptr():
            r.copy_(first)


def unique_with_order(x: torch.Tensor):
    """``torch.unique(x, sorted=True, return_inverse=True)`` of a 1-D
    ``x`` from one stable sort, and that sort of the inverse: ``(uniq,
    inv, (keys, perm))`` with ``keys = inv[perm]`` ascending (int32) and
    ``perm`` ascending within equal keys, the ``order`` that
    ``embedding_bag_backward`` takes. ``torch.unique`` sorts as well, so
    this spares the backward a sort of its own. One host synchronisation
    (the count of unique values)."""
    vals, perm = torch.sort(x, stable=True)
    uniq, inv_sorted = torch.unique_consecutive(vals, return_inverse=True)
    inv = torch.empty_like(inv_sorted).scatter_(0, perm, inv_sorted)
    return uniq, inv, (inv_sorted.to(torch.int32), perm)


def make_sparse_train_step(cfg: DLRMConfig, opt_cfg: adamw.AdamWConfig, *,
                           use_kernels: bool = True,
                           devices: Optional[Sequence] = None):
    """Train step whose table updates touch only the rows in the batch: the
    port of the reference's ``make_sparse_train_step``.

    ``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``. Per step:

      1. per table the unique rows of the batch (``unique_with_order``:
         ``torch.unique``'s values from one stable sort, one host
         synchronisation a table; the reference pads to B·hot with V, and
         its pad rows add 0, so the port does not pad) and the gathered
         rows ``table[min(uniq, V - 1)]``;
      2. the loss from the MLP params and the gathered rows, each field's
         bags ``embedding_bag_grad(rows, inverse, order=...)`` (on the
         card the forward kernels and the backward kernel, one launch each
         a field; the backward reads the sort of step 1, so a field is
         sorted once), and ``torch.autograd.grad`` of it: the MLP grads
         and each field's rows' grad. The tables never enter the autograd
         graph;
      3. ``adamw.apply`` over the MLP params alone, clipped over those
         alone;
      4. row-wise lazy AdamW on the live rows (``uniq < V``), no weight
         decay, no clip, in the reference's delta form:
         ``table[safe] += bf16(-lr * delta * live)``, ``m[safe] += (m2 -
         m_rows) * live``, ``v`` likewise (plain PyTorch ops, as the
         reference leaves them to XLA). Untouched rows' moments do not
         decay that step.

    Everything is updated in place (``index_add_`` for the tables and
    their moments: two copies of the dlrm-mlperf state would not fit one
    card), and the returned params and state are the ones passed in.

    ``devices``: params from ``parallel.sharding.dlrm_param_placement`` and
    the state from ``dlrm_opt_state_placement`` over the same list. The
    ``table*`` moments are cut into the tables' row blocks: a device list
    has one axis, so the reference's ``shard_moments_2d`` (moments over
    (model, dp)) has nothing more to cut and the moments follow the
    tables. Rows are gathered from the shard that holds each and
    combined on ``devices[0]``, where the step is computed; each shard
    then updates the live rows of its block in place. The replicated
    params and their moments are updated once, on ``devices[0]``'s
    replica, and copied to the other replicas (not to a replica that is
    the same memory: on a repeated device list they are views of one
    tensor)."""
    tables = [f"table{t}" for t in range(cfg.n_sparse)]
    devs = None if devices is None else [torch.device(d) for d in devices]

    def rows_of(tree, name, safe, v):
        """(the blocks or replicas of ``tree[name]``, their row block) and
        the rows ``safe`` gathered from them."""
        if devs is None:
            return [tree[name]], 0, tree[name].index_select(0, safe)
        blk = table_row_block(v, len(devs))
        if not blk:
            return tree[name], 0, tree[name][0].index_select(0, safe)
        return tree[name], blk, _gather_rows(tree[name], safe, blk, devs)

    def scatter(parts, blk, safe, delta):
        if blk:
            _scatter_add(parts, safe, delta, blk, devs)
        else:
            parts[0].index_add_(0, safe, delta)
            _sync_replicas(parts)

    def step(params, opt_state, batch):
        p = _dense_params(params, devs)
        dev = p["bot_w0"].device
        dense = batch_tensor(batch, "dense", dev, FDTYPE)
        sparse = batch_tensor(batch, "sparse", dev)
        y = batch_tensor(batch, "labels", dev, FDTYPE)
        b = sparse.shape[0]
        fields = []
        for t, name in enumerate(tables):
            v = cfg.table_sizes[t]
            uniq, inv, order = unique_with_order(
                sparse[:, t, :].reshape(-1))
            safe = uniq.clamp(max=v - 1).long()
            parts, blk, rows = rows_of(params, name, safe, v)
            fields.append((name, v, uniq, safe, parts, blk,
                           rows.detach().requires_grad_(),
                           inv.to(torch.int32).view(b, -1), order))

        dense_p = {k: t for k, t in p.items() if not k.startswith("table")}
        leaves = {k: t.detach().requires_grad_() for k, t in dense_p.items()}
        x_dense = _mlp(leaves, dense, "bot", len(cfg.bot_mlp))
        embs = [embedding_bag_grad(rows, inv, use_kernels=use_kernels,
                                   order=order)
                for _, _, _, _, _, _, rows, inv, order in fields]
        loss = _bce(_interact_top(cfg, leaves, x_dense, embs), y)
        grads = torch.autograd.grad(
            loss, list(leaves.values()) + [f[6] for f in fields])
        g_dense = dict(zip(leaves, grads[:len(leaves)]))
        g_rows = grads[len(leaves):]
        del embs, x_dense, leaves

        # dense side: plain AdamW over the MLP params alone, in place on
        # devices[0]'s replica
        first = (lambda x: x) if devs is None else (lambda x: x[0])
        sub = adamw.OptState(opt_state.step,
                             {k: first(opt_state.m[k]) for k in dense_p},
                             {k: first(opt_state.v[k]) for k in dense_p})
        _, _, om = adamw.apply(opt_cfg, dense_p, g_dense, sub)
        if devs is not None:
            with torch.no_grad():
                for k in dense_p:
                    for tree in (params, opt_state.m, opt_state.v):
                        _sync_replicas(tree[k])

        # table side: row-wise lazy AdamW (delta scatters; pads add 0)
        b1, b2, eps = opt_cfg.beta1, opt_cfg.beta2, opt_cfg.eps
        lr = om["lr"]
        bc1, bc2 = adamw.bias_corrections(opt_cfg, opt_state.step)
        with torch.no_grad():
            for (name, v, uniq, safe, parts, blk, *_), g_r in zip(fields,
                                                                g_rows):
                live = (uniq < v).to(torch.float32)[:, None]
                g = g_r.to(torch.float32) * live
                m_parts, _, m_rows = rows_of(opt_state.m, name, safe, v)
                v_parts, _, v_rows = rows_of(opt_state.v, name, safe, v)
                m2 = b1 * m_rows + (1 - b1) * g
                v2 = b2 * v_rows + (1 - b2) * g * g
                delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                scatter(parts, blk, safe,
                        (-lr * delta * live).to(parts[0].dtype))
                scatter(m_parts, blk, safe, (m2 - m_rows) * live)
                scatter(v_parts, blk, safe, (v2 - v_rows) * live)
        return params, opt_state, {"loss": loss.detach(), **om}

    return step


class DLRM(nn.Module):
    """The module idiom over the functions above: the params (random from
    ``generator`` on ``device``, or given) held as frozen parameters, which
    ``train_step`` updates in place."""

    def __init__(self, cfg: DLRMConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, generator, device)
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in params.items()})

    def forward(self, batch, *, use_kernels: bool = True) -> torch.Tensor:
        return forward(self.cfg, dict(self.params), batch,
                       use_kernels=use_kernels)

    def serve_step(self, batch, *, use_kernels: bool = True) -> torch.Tensor:
        return serve_step(self.cfg, dict(self.params), batch,
                          use_kernels=use_kernels)

    def retrieval_score(self, batch, *, use_kernels: bool = True):
        return retrieval_score(self.cfg, dict(self.params), batch,
                               use_kernels=use_kernels)

    def train_step(self, opt_cfg: adamw.AdamWConfig,
                   opt_state: adamw.OptState, batch, *,
                   use_kernels: bool = True):
        """One ``make_sparse_train_step`` step on the module's params, in
        place; returns (opt_state, metrics). ``opt_state`` is
        ``adamw.init`` of the params, on their device."""
        step = make_sparse_train_step(self.cfg, opt_cfg,
                                      use_kernels=use_kernels)
        _, opt_state, metrics = step(dict(self.params), opt_state, batch)
        return opt_state, metrics
