"""GNN family: GCN, GIN, SchNet, GraphCast-style encoder-processor-decoder.

The port of ``src/repro/models/gnn.py``. Message passing is built on
segment sums over edge lists, where the reference calls
``jax.ops.segment_sum``: gather -> reduce is the system substrate. Here
both steps are autograd Functions, :func:`segment_sum` and :func:`gather`,
whose sums run on the port's hand-written sorted-sum kernel
(``csrc/embedding_bag_backward.cu``, ``kernels/embedding_bag/grad.py``):
``embedding_bag_backward(x, seg[:, None], n)`` with L = 1 is ``out[v] =
Σ x[e]`` over the edges with ``seg[e] == v``, each row summed in float32
in edge order from 0. The backward of a segment sum is the gather
``grad[seg]`` (``index_select``); the backward of a gather is the segment
sum of the output gradient by the gathered index. So every sum of a train
step, forward and backward, is ordered and free of atomics, and the step
gives the same bits on every run, where ``torch.index_add_`` on CUDA adds
with atomics in no fixed order.

The kernel reads a stable sort of the segment ids: ``forward`` sorts
``edge_dst`` and ``edge_src`` once a call (:func:`edge_orders`; on the
card two sorts and no host sync) and every sum of the call, forward and
backward, by those ids reuses the two sorts.
On CUDA tensors the sums launch the kernel or raise; with
``use_kernels=False``, and on CPU tensors, they take its plain version
(``embedding_bag_backward_ref``: ``index_add_``, which on the CPU adds in
index order, so the same bits). Gathers that need no gradient
(``inv[src]``, ``pos[src]``) are plain ``index_select``.

Graph batches are dicts of fixed-shape tensors or arrays, moved to the
params' device (padding edges point at a dead node, with mask 0):
  node_feat (N, F) · edge_src (E,) · edge_dst (E,) · [pos (N, 3)]
  [labels]  · node_mask (N,) · edge_mask (E,) · [edge_feat (E, d_edge)]

All four archs run on all four assigned graph shapes; SchNet synthesizes
unit distances when positions are absent, and GraphCast's
encoder-processor-decoder runs over the given graph (its native
icosahedral multimesh is ``data.graphs.icosahedral_mesh``). The
reference's ``lax.scan`` over GraphCast's stacked processor layers is a
loop over the layer index here, and its ``constrain(h2, "gnn_nodes")``,
the identity off a mesh, is left out. The dense parts are plain PyTorch in
float32 (``x @ w + b``, TF32 at PyTorch's default, off).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.engine import resolve_torch_device
from repro_torch.kernels.embedding_bag import grad as bag_grad
from repro_torch.optim import adamw
from repro_torch.pytree import leaves

from .layers import (ParamTree, abstractify, batch_tensor, materialize,
                     value_and_grad)

FDTYPE = torch.float32   # GNNs train in f32 (small models, full-batch grads)

Order = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                    # gcn | gin | schnet | graphcast
    n_layers: int
    d_hidden: int
    d_in: int = 128
    d_out: int = 16              # classes / target vars
    aggregator: str = "sum"      # sum | mean
    # schnet
    n_rbf: int = 300
    cutoff: float = 10.0
    # graphcast
    d_edge: int = 4
    graph_level: bool = False    # readout to one vector per graph


def _mlp_shapes(d_in, d_hidden, d_out, n=2, prefix=""):
    s = {}
    dims = [d_in] + [d_hidden] * (n - 1) + [d_out]
    for i in range(n):
        s[f"{prefix}w{i}"] = ((dims[i], dims[i + 1]), FDTYPE)
        s[f"{prefix}b{i}"] = ((dims[i + 1],), FDTYPE)
    return s


def _mlp(p, x, n=2, prefix="", act=torch.relu, final_act=False):
    for i in range(n):
        x = x @ p[f"{prefix}w{i}"] + p[f"{prefix}b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------

def param_shapes(cfg: GNNConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    k = cfg.kind
    if k == "gcn":
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
        for i in range(cfg.n_layers):
            s[f"w{i}"] = ((dims[i], dims[i + 1]), FDTYPE)
            s[f"b{i}"] = ((dims[i + 1],), FDTYPE)
    elif k == "gin":
        s["embed_w"] = ((cfg.d_in, cfg.d_hidden), FDTYPE)
        s["embed_b"] = ((cfg.d_hidden,), FDTYPE)
        for i in range(cfg.n_layers):
            s[f"layer{i}"] = {**_mlp_shapes(cfg.d_hidden, cfg.d_hidden,
                                            cfg.d_hidden, 2),
                              "eps": ((1,), FDTYPE)}
        s["readout_w"] = ((cfg.d_hidden, cfg.d_out), FDTYPE)
        s["readout_b"] = ((cfg.d_out,), FDTYPE)
    elif k == "schnet":
        s["embed_w"] = ((cfg.d_in, cfg.d_hidden), FDTYPE)
        s["embed_b"] = ((cfg.d_hidden,), FDTYPE)
        for i in range(cfg.n_layers):
            s[f"inter{i}"] = {
                **_mlp_shapes(cfg.n_rbf, cfg.d_hidden, cfg.d_hidden, 2, "filt_"),
                "in_w": ((cfg.d_hidden, cfg.d_hidden), FDTYPE),
                **_mlp_shapes(cfg.d_hidden, cfg.d_hidden, cfg.d_hidden, 2, "out_"),
            }
        s.update(_mlp_shapes(cfg.d_hidden, cfg.d_hidden // 2, cfg.d_out, 2,
                             "head_"))
    elif k == "graphcast":
        s.update(_mlp_shapes(cfg.d_in, cfg.d_hidden, cfg.d_hidden, 2, "enc_n_"))
        s.update(_mlp_shapes(cfg.d_edge, cfg.d_hidden, cfg.d_hidden, 2, "enc_e_"))
        # processor layers are homogeneous -> stacked on a leading axis
        proc = {
            **_mlp_shapes(3 * cfg.d_hidden, cfg.d_hidden, cfg.d_hidden, 2, "e_"),
            **_mlp_shapes(2 * cfg.d_hidden, cfg.d_hidden, cfg.d_hidden, 2, "n_"),
        }
        s["proc"] = {name: ((cfg.n_layers,) + shape, dtype)
                     for name, (shape, dtype) in proc.items()}
        s.update(_mlp_shapes(cfg.d_hidden, cfg.d_hidden, cfg.d_out, 2, "dec_"))
    else:
        raise ValueError(k)
    return s


def init_params(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random params on ``device`` (``"cuda"`` raises without CUDA), drawn
    from ``generator`` (default: a generator on that device seeded 0) by
    the reference's name-aware rule (``layers.materialize``)."""
    dev = resolve_torch_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return materialize(param_shapes(cfg), generator, dev)


def param_specs(cfg: GNNConfig):
    return abstractify(param_shapes(cfg))


# ---------------------------------------------------------------------------
# message passing: ordered segment sums and gathers
# ---------------------------------------------------------------------------

class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, n, order, use_kernels):
        ctx.save_for_backward(seg)
        return bag_grad.segment_rows(x, seg, n, order,
                                     use_kernels=use_kernels)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        seg, = ctx.saved_tensors
        return grad.index_select(0, seg), None, None, None, None


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int,
                order: Optional[Order] = None, *,
                use_kernels: bool = True) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=n)`` for ``x`` (E,) or
    (E, D) float32 and ``seg`` (E,) int32 in [0, n): (n,) or (n, D), each
    row summed in edge order. On CUDA tensors it launches
    ``embedding_bag_backward`` on ``order``, the stable sort of ``seg``
    (``edge_orders``; sorted here when None), or raises. Differentiable
    in ``x``: its backward is the gather ``grad[seg]``."""
    return _SegmentSum.apply(x, seg, n, order, use_kernels)


def gather(h: torch.Tensor, idx: torch.Tensor,
           order: Optional[Order] = None, *,
           use_kernels: bool = True) -> torch.Tensor:
    """``h[idx]`` (``index_select`` of rows), differentiable in ``h``: its
    backward is :func:`segment_sum` of the output gradient by ``idx`` (on
    ``order``, the stable sort of ``idx``), so the scatter of a gather's
    gradient runs on the kernel too, in index order
    (``bag_grad.gather_rows``, which the LM's token embedding shares)."""
    return bag_grad.gather_rows(h, idx, order, use_kernels=use_kernels)


def edge_orders(batch) -> Dict[str, Order]:
    """The stable sorts ``(keys, positions)`` of the batch's ``edge_src``
    and ``edge_dst`` (tensors), by side: ``{"src": ..., "dst": ...}``. On
    the card they are two sorts and no host sync; ``forward`` makes them
    once a call."""
    return {side: tuple(torch.sort(batch[f"edge_{side}"], stable=True))
            for side in ("src", "dst")}


def _aggregate(msgs, dst, n, mode, edge_mask=None, order=None,
               use_kernels=True):
    if edge_mask is not None:
        msgs = msgs * edge_mask[:, None]
    out = segment_sum(msgs, dst, n, order, use_kernels=use_kernels)
    if mode == "mean":
        ones = torch.ones((msgs.shape[0],), dtype=msgs.dtype,
                          device=msgs.device)
        if edge_mask is not None:
            ones = ones * edge_mask
        deg = segment_sum(ones, dst, n, order, use_kernels=use_kernels)
        out = out / torch.clamp_min(deg, 1.0)[:, None]
    return out


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward(cfg: GNNConfig, params, batch: Dict[str, Any], *,
            use_kernels: bool = True) -> torch.Tensor:
    """The model's output for ``batch`` (module docstring): (N, d_out), or
    (n_graphs, d_out) with ``graph_level``. Every sum by ``edge_src`` or
    ``edge_dst`` reuses the call's ``edge_orders``."""
    k = cfg.kind
    dev = leaves(params)[0].device
    x = batch_tensor(batch, "node_feat", dev, FDTYPE)
    src = batch_tensor(batch, "edge_src", dev)
    dst = batch_tensor(batch, "edge_dst", dev)
    n = x.shape[0]
    emask = batch_tensor(batch, "edge_mask", dev) if "edge_mask" in batch \
        else None
    o_src = o_dst = None
    if use_kernels:
        orders = edge_orders({"edge_src": src, "edge_dst": dst})
        o_src, o_dst = orders["src"], orders["dst"]
    sides = {"src": (src, o_src), "dst": (dst, o_dst)}

    def take(h, side):
        return gather(h, *sides[side], use_kernels=use_kernels)

    def agg(msgs, side, mode="sum"):
        seg, order = sides[side]
        return _aggregate(msgs, seg, n, mode, emask, order, use_kernels)

    def readout(y):
        gid = batch_tensor(batch, "graph_id", dev)
        mask = batch_tensor(batch, "node_mask", dev, FDTYPE)
        return segment_sum(y * mask[:, None], gid, int(batch["n_graphs"]),
                           use_kernels=use_kernels)

    if k == "gcn":
        ones = torch.ones((src.shape[0],), dtype=FDTYPE, device=dev)
        if emask is not None:
            ones = ones * emask
        deg = segment_sum(ones, dst, n, o_dst, use_kernels=use_kernels) + \
            segment_sum(ones, src, n, o_src, use_kernels=use_kernels)
        inv = torch.rsqrt(torch.clamp_min(deg, 1.0))
        coef = (inv.index_select(0, src) * inv.index_select(0, dst))[:, None]
        for i in range(cfg.n_layers):
            h = x @ params[f"w{i}"] + params[f"b{i}"]
            m = take(h, "src") * coef
            a = agg(m, "dst")
            m_rev = take(h, "dst") * coef
            a = a + agg(m_rev, "src")
            x = a + h * (inv * inv)[:, None]     # sym-norm self loop
            if i < cfg.n_layers - 1:
                x = torch.relu(x)
        return x

    if k == "gin":
        x = torch.relu(x @ params["embed_w"] + params["embed_b"])
        for i in range(cfg.n_layers):
            p = params[f"layer{i}"]
            a = agg(take(x, "src"), "dst", cfg.aggregator) + \
                agg(take(x, "dst"), "src", cfg.aggregator)
            h = (1.0 + p["eps"]) * x + a
            x = _mlp(p, h, 2, final_act=True)
        if cfg.graph_level:
            return readout(x) @ params["readout_w"] + params["readout_b"]
        return x @ params["readout_w"] + params["readout_b"]

    if k == "schnet":
        if "pos" in batch:
            pos = batch_tensor(batch, "pos", dev, FDTYPE)
            d = torch.linalg.norm(pos.index_select(0, src)
                                  - pos.index_select(0, dst) + 1e-9, dim=-1)
        else:
            d = torch.ones((src.shape[0],), dtype=FDTYPE, device=dev)
        centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=FDTYPE,
                                 device=dev)
        gamma = 10.0
        rbf = torch.exp(-gamma * (d[:, None] - centers[None, :]) ** 2)
        cos_cut = 0.5 * (torch.cos(math.pi * torch.clamp_max(d, cfg.cutoff)
                                   / cfg.cutoff) + 1.0)
        x = x @ params["embed_w"] + params["embed_b"]
        for i in range(cfg.n_layers):
            p = params[f"inter{i}"]
            w = _mlp(p, rbf, 2, "filt_", act=F.softplus) * cos_cut[:, None]
            h = x @ p["in_w"]
            a = agg(take(h, "src") * w, "dst") + agg(take(h, "dst") * w, "src")
            x = x + _mlp(p, a, 2, "out_", act=F.softplus)
        out = _mlp(params, x, 2, "head_", act=F.softplus)
        if cfg.graph_level:
            return readout(out)
        return out

    if k == "graphcast":
        # encode
        h = _mlp(params, x, 2, "enc_n_")
        if "edge_feat" in batch:
            e = _mlp(params, batch_tensor(batch, "edge_feat", dev, FDTYPE),
                     2, "enc_e_")
        else:
            e = torch.zeros((src.shape[0], cfg.d_hidden), dtype=FDTYPE,
                            device=dev)
        # process: interaction-network layers over the stacked params
        names = sorted(params["proc"])
        for layer in zip(*(params["proc"][name].unbind(0)
                           for name in names)):
            p = dict(zip(names, layer))
            msg_in = torch.cat([e, take(h, "src"), take(h, "dst")], dim=-1)
            e = e + _mlp(p, msg_in, 2, "e_")
            a = agg(e, "dst", cfg.aggregator)
            h = h + _mlp(p, torch.cat([h, a], dim=-1), 2, "n_")
        return _mlp(params, h, 2, "dec_")

    raise ValueError(k)


def loss_fn(cfg: GNNConfig, params, batch, **kw):
    """Dispatch on batch contents: 'targets' => masked MSE regression,
    'labels' => masked softmax-CE node classification. ``kw``: ``forward``'s
    ``use_kernels``."""
    out = forward(cfg, params, batch, **kw)
    dev = out.device
    if "targets" in batch:
        tgt = batch_tensor(batch, "targets", dev, FDTYPE)
        mask = batch_tensor(batch, "node_mask", dev) if "node_mask" in batch \
            else None
        err = (out - tgt) ** 2
        if mask is not None and err.shape[0] == mask.shape[0]:
            err = err * mask[:, None]
            return torch.sum(err) / torch.clamp_min(torch.sum(mask), 1.0), {}
        return torch.mean(err), {}
    labels = batch_tensor(batch, "labels", dev, torch.int64)
    logz = torch.logsumexp(out, dim=-1)
    gold = torch.take_along_dim(out, labels[..., None], dim=-1)[..., 0]
    nll = logz - gold
    if "label_mask" in batch:
        mask = batch_tensor(batch, "label_mask", dev)
        nll = nll * mask
        return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0), {}
    return torch.mean(nll), {}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_step(cfg: GNNConfig, opt_cfg: adamw.AdamWConfig, params,
               opt_state: adamw.OptState, batch, *, use_kernels: bool = True):
    """The reference's GNN step (``src/repro/launch/steps.py:188-192``):
    the gradient of ``loss_fn`` through every param, then
    ``adamw.apply``, in place. Returns (params, opt_state, {"loss",
    "grad_norm", "lr"})."""
    loss, _, grads = value_and_grad(
        lambda p: loss_fn(cfg, p, batch, use_kernels=use_kernels), params)
    params, opt_state, om = adamw.apply(opt_cfg, params, grads, opt_state)
    return params, opt_state, {"loss": loss, **om}


class GNN(nn.Module):
    """The module idiom over the functions above: the params (random from
    ``generator`` on ``device``, or given) held as frozen parameters, which
    ``train_step`` updates in place."""

    def __init__(self, cfg: GNNConfig, params: Optional[Dict[str, Any]] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, generator, device)
        self.params = ParamTree(params)

    def param_tree(self) -> Dict[str, Any]:
        return self.params.tree()

    def forward(self, batch, *, use_kernels: bool = True) -> torch.Tensor:
        return forward(self.cfg, self.param_tree(), batch,
                       use_kernels=use_kernels)

    def train_step(self, opt_cfg: adamw.AdamWConfig,
                   opt_state: adamw.OptState, batch, *,
                   use_kernels: bool = True):
        """One :func:`train_step` on the module's params, in place; returns
        (opt_state, metrics). ``opt_state`` is ``adamw.init`` of
        ``param_tree()``, on its device."""
        _, opt_state, metrics = train_step(
            self.cfg, opt_cfg, self.param_tree(), opt_state, batch,
            use_kernels=use_kernels)
        return opt_state, metrics


__all__ = ["GNN", "GNNConfig", "edge_orders", "forward",
           "gather", "init_params", "loss_fn", "param_shapes", "param_specs",
           "segment_sum", "train_step"]
