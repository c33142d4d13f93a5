"""GNN training split over a named device grid (``parallel.spmd``).

The reference's GNN cell runs under ``jax.jit`` with the batch's node and
edge rows split over every grid axis where they divide and the params
replicated (``parallel.sharding.gnn_batch_sharding`` /
``gnn_param_sharding``); XLA inserts the collectives. Here each place runs
``models.gnn``'s forward on its own rows (``spmd.lockstep``), with the
collectives written out:

* node features are all-gathered over every axis before the layer's
  gathers (one all-gather of ``h`` serves both sides), each gather reads
  the whole table, and its backward (the segment sum of its gradient) runs
  on the sorted-sum kernel into the whole table, which the all-gather's
  backward reduce-scatters to node rows;
* each place's message sums run on ``embedding_bag_backward`` over its
  own edges, on its own sorts (``gnn.edge_orders`` of its edge slice), into
  a partial node table that is reduce-scattered to node rows;
* the loss's numerator and denominator are all-reduced, and the loss's
  gradient is taken at place 0, so the backward all-reduces (the
  all-reduce's dual) hand every place its share;
* the replicated params' gradients are all-reduced in grid order, and
  ``adamw.apply`` runs on each distinct replica with the same bits.

A dimension the rules leave whole (a node or edge count that the grid
does not divide) lies whole on every place; the step cuts its rows into
``spmd.even_sizes`` contiguous parts, one a place, so every row is
computed and counted once. Every sum is ordered and every cross-place sum
is in grid order, so a step repeated gives the same bits.

On an abstract grid (one ``meta`` place, ``spmd``) the sums and gathers
are their shape-only counterparts (``index_add`` and ``index_select``),
which keep the backward's collectives: that run reckons the cell's
collectives without data.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.optim import adamw
from repro_torch.parallel import spmd
from repro_torch.pytree import leaves, tree_map

from . import gnn as GNN
from .gnn import FDTYPE, _mlp

EDGE_KEYS = ("edge_src", "edge_dst", "edge_mask", "edge_feat")


def _split(s: spmd.Sharded) -> bool:
    return len(s.spec) > 0 and s.spec[0] is not None


def _rows(s: spmd.Sharded, p: int, sizes) -> torch.Tensor:
    """Place ``p``'s rows of ``s``: its block, or its part of a whole
    array."""
    blk = s.blocks[p]
    if _split(s):
        return blk
    i = spmd.coord(s.grid, p, s.grid.axis_names)
    return blk[sum(sizes[:i]):sum(sizes[:i + 1])]


def _sizes(s: spmd.Sharded, k: int):
    n = s.shape[0]
    return [n // k] * k if _split(s) else spmd.even_sizes(n, k)


def _segsum(x, seg, n, order):
    if x.is_meta:
        return torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device="meta").index_add(0, seg.long(), x)
    return GNN.segment_sum(x, seg, n, order)


def _take(h, idx, order):
    if h.is_meta:
        return h.index_select(0, idx.long())
    return GNN.gather(h, idx, order)


def _forward(cfg, params, b: Dict[str, torch.Tensor], n: int, axes,
             sizes):
    """``gnn.forward`` on one place's rows (a generator, ``spmd``): the
    place's output rows."""
    k = cfg.kind
    x, src, dst = b["node_feat"], b["edge_src"], b["edge_dst"]
    dev = x.device
    emask = b.get("edge_mask")
    orders = {"src": None, "dst": None} if x.is_meta else \
        GNN.edge_orders({"edge_src": src, "edge_dst": dst})
    sides = {"src": (src, orders["src"]), "dst": (dst, orders["dst"])}

    def full(h):
        return (yield spmd.AllGather(h, axes, 0, sizes))

    def take(hf, side):
        return _take(hf, *sides[side])

    def rsum(v, side):
        seg, order = sides[side]
        return (yield spmd.ReduceScatter(_segsum(v, seg, n, order), axes, 0,
                                         sizes))

    def agg(msgs, side, mode="sum"):
        if emask is not None:
            msgs = msgs * emask[:, None]
        out = yield from rsum(msgs, side)
        if mode == "mean":
            ones = torch.ones((msgs.shape[0],), dtype=msgs.dtype, device=dev)
            if emask is not None:
                ones = ones * emask
            deg = yield from rsum(ones, side)
            out = out / torch.clamp_min(deg, 1.0)[:, None]
        return out

    if k == "gcn":
        ones = torch.ones((src.shape[0],), dtype=FDTYPE, device=dev)
        if emask is not None:
            ones = ones * emask
        deg = (yield from rsum(ones, "dst")) + (yield from rsum(ones, "src"))
        inv = torch.rsqrt(torch.clamp_min(deg, 1.0))
        inv_f = yield from full(inv)
        coef = (inv_f.index_select(0, src) * inv_f.index_select(0, dst))[:, None]
        for i in range(cfg.n_layers):
            h = x @ params[f"w{i}"] + params[f"b{i}"]
            hf = yield from full(h)
            a = yield from agg(take(hf, "src") * coef, "dst")
            a = a + (yield from agg(take(hf, "dst") * coef, "src"))
            x = a + h * (inv * inv)[:, None]
            if i < cfg.n_layers - 1:
                x = torch.relu(x)
        return x

    if k == "gin":
        x = torch.relu(x @ params["embed_w"] + params["embed_b"])
        for i in range(cfg.n_layers):
            p = params[f"layer{i}"]
            xf = yield from full(x)
            a = (yield from agg(take(xf, "src"), "dst", cfg.aggregator)) + \
                (yield from agg(take(xf, "dst"), "src", cfg.aggregator))
            x = _mlp(p, (1.0 + p["eps"]) * x + a, 2, final_act=True)
        return x @ params["readout_w"] + params["readout_b"]

    if k == "schnet":
        if "pos" in b:
            pos = yield from full(b["pos"])
            d = torch.linalg.norm(pos.index_select(0, src)
                                  - pos.index_select(0, dst) + 1e-9, dim=-1)
        else:
            d = torch.ones((src.shape[0],), dtype=FDTYPE, device=dev)
        centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=FDTYPE,
                                 device=dev)
        rbf = torch.exp(-10.0 * (d[:, None] - centers[None, :]) ** 2)
        cos_cut = 0.5 * (torch.cos(math.pi * torch.clamp_max(d, cfg.cutoff)
                                   / cfg.cutoff) + 1.0)
        x = x @ params["embed_w"] + params["embed_b"]
        for i in range(cfg.n_layers):
            p = params[f"inter{i}"]
            w = _mlp(p, rbf, 2, "filt_", act=F.softplus) * cos_cut[:, None]
            hf = yield from full(x @ p["in_w"])
            a = (yield from agg(take(hf, "src") * w, "dst")) + \
                (yield from agg(take(hf, "dst") * w, "src"))
            x = x + _mlp(p, a, 2, "out_", act=F.softplus)
        return _mlp(params, x, 2, "head_", act=F.softplus)

    if k == "graphcast":
        h = _mlp(params, x, 2, "enc_n_")
        if "edge_feat" in b:
            e = _mlp(params, b["edge_feat"], 2, "enc_e_")
        else:
            e = torch.zeros((src.shape[0], cfg.d_hidden), dtype=FDTYPE,
                            device=dev)
        names = sorted(params["proc"])
        for layer in zip(*(params["proc"][name].unbind(0)
                           for name in names)):
            p = dict(zip(names, layer))
            hf = yield from full(h)
            msg_in = torch.cat([e, take(hf, "src"), take(hf, "dst")], dim=-1)
            e = e + _mlp(p, msg_in, 2, "e_")
            a = yield from agg(e, "dst", cfg.aggregator)
            h = h + _mlp(p, torch.cat([h, a], dim=-1), 2, "n_")
        return _mlp(params, h, 2, "dec_")

    raise ValueError(k)


def _loss(cfg, params, b, n, axes, sizes):
    """``gnn.loss_fn`` on one place's rows (a generator): the numerator
    and denominator all-reduced, the loss on every place."""
    out = yield from _forward(cfg, params, b, n, axes, sizes)
    count = lambda t: torch.tensor(float(t.numel()), device=t.device)
    if "targets" in b:
        err = (out - b["targets"]) ** 2
        mask = b.get("node_mask")
        masked = mask is not None and err.shape[0] == mask.shape[0]
        num, den = (torch.sum(err * mask[:, None]), torch.sum(mask)) \
            if masked else (torch.sum(err), count(err))
    else:
        labels = b["labels"].long()
        nll = torch.logsumexp(out, dim=-1) - torch.take_along_dim(
            out, labels[..., None], dim=-1)[..., 0]
        mask = b.get("label_mask")
        masked = mask is not None
        num, den = (torch.sum(nll * mask), torch.sum(mask)) if masked \
            else (torch.sum(nll), count(nll))
    tot = yield spmd.AllReduce(torch.stack([num, den]), axes)
    return tot[0] / (torch.clamp_min(tot[1], 1.0) if masked else tot[1])


def train_step(cfg: GNN.GNNConfig, opt_cfg: adamw.AdamWConfig, params,
               opt_state: adamw.OptState, batch: Dict[str, Any]):
    """One step of the GNN cell on a grid (module docstring): ``params``
    and ``opt_state`` trees of replicated ``spmd.Sharded`` values,
    ``batch`` a dict of them under ``gnn_batch_sharding``. In place, as
    ``gnn.train_step``; returns one (params, opt_state, metrics) of
    blocks a place."""
    if cfg.graph_level:
        raise ValueError(f"{cfg.name}: a graph-level readout is not run on "
                         f"a grid (ROADMAP §1 item 3)")
    grid = batch["node_feat"].grid
    axes = tuple(grid.axis_names)
    k = spmd.axis_size(grid, axes)
    n = batch["node_feat"].shape[0]
    node_sizes = _sizes(batch["node_feat"], k)
    edge_sizes = _sizes(batch["edge_src"], k)
    n_places = len(spmd.places(grid))

    def local(p):
        return {key: _rows(s, p, edge_sizes if key in EDGE_KEYS
                           else node_sizes)
                for key, s in batch.items() if isinstance(s, spmd.Sharded)
                and len(s.shape) > 0}

    live = [tree_map(lambda t: t.detach().requires_grad_(),
                     spmd.blocks_at(params, p)) for p in range(n_places)]
    losses = spmd.lockstep(grid, [
        _loss(cfg, live[p], local(p), n, axes, node_sizes)
        for p in range(n_places)])
    flat = [leaves(t) for t in live]
    got = torch.autograd.grad(losses[0], [x for f in flat for x in f],
                              allow_unused=True)
    m = len(flat[0])
    grads = [[torch.zeros_like(x) if g is None else g
              for x, g in zip(flat[p], got[p * m:(p + 1) * m])]
             for p in range(n_places)]
    with torch.no_grad():
        summed = [spmd.all_reduce([grads[p][j] for p in range(n_places)],
                                  grid, axes) for j in range(m)]
    metrics_at: Dict[Any, Dict[str, torch.Tensor]] = {}
    per_place = []
    for p in range(n_places):
        p_tree = spmd.blocks_at(params, p)
        s_tree = spmd.blocks_at(opt_state, p)
        key = (str(spmd.places(grid)[p]),) + tuple(
            t.data_ptr() for t in leaves((p_tree, s_tree)))
        if key not in metrics_at or spmd.is_abstract(grid):
            treedef = leaves(p_tree)
            at = {id(t): summed[j][p] for j, t in enumerate(treedef)}
            g_tree = tree_map(lambda t: at[id(t)], p_tree)
            _, _, om = adamw.apply(opt_cfg, p_tree, g_tree, s_tree)
            metrics_at[key] = {"loss": losses[p].detach(), **om}
        per_place.append(metrics_at[key])
    return [(spmd.blocks_at(params, p), spmd.blocks_at(opt_state, p),
             per_place[p]) for p in range(n_places)]


__all__ = ["train_step"]
