"""Cells: one step function per (arch × shape × grid) cell.

The port of ``src/repro/launch/steps.py``. ``build_cell`` returns what
``launch.dryrun`` and ``launch.perf`` need: the step (``fn``), its
arguments' specs (tensors on the ``meta`` device) and matching in/out
shardings (``parallel.sharding.NamedSharding`` on a
``launch.mesh.DeviceGrid``), under the reference's rules.

``fn`` calls the port's own steps: ``transformer.train_step``,
``prefill`` and ``decode_step``; ``gnn.train_step``; DLRM's
``make_sparse_train_step`` when ``sparse_optimizer`` is set, else its
dense ``train_step``, its ``serve_step`` and ``retrieval_score``. ``donate_argnums`` names the
arguments the step may overwrite in place, which the port's train and
decode steps do.

``Cell.sharded()`` is the counterpart of the reference's ``Cell.jit()``
(``jax.jit(fn, in_shardings, out_shardings, donate_argnums)``): a step
over ``parallel.spmd.Sharded`` arguments laid out by ``in_shardings`` on
the cell's grid, returning its outputs laid out by ``out_shardings``,
block for block, with ``donate_argnums`` kept (the train and decode steps
write those arguments' blocks in place). One process drives every place
of the grid (``parallel.spmd``); inside the step the port chooses its own
scheme (``models.gnn_sharded``, ``models.dlrm.grid_serve``,
``models.transformer_sharded``), so ``constrain`` stays a marker. It
covers GNN training, DLRM serving and retrieval, and the dense LMs'
training (``train_4k``: FSDP and tensor parallelism, the gradient
through every collective), prefill and decode; another cell (MLA, MoE,
DLRM training) raises ``ValueError`` (ROADMAP §1 item 3).
``Cell.place`` lays whole arguments out for it, and on an abstract
grid places their ``meta`` specs, so the same step reckons the cell's
collectives without a card (``launch.dryrun``). ``fn`` runs the cell
whole, in one process, as before.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs import config_for_shape, get_arch, input_specs
from repro_torch.models import dlrm as DLRM
from repro_torch.models import gnn as GNN
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import P, NamedSharding
from repro_torch.pytree import leaves, tree_map_with_path


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    step_kind: str
    fn: Callable
    arg_specs: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    cfg: Any
    meta: Dict[str, Any]

    @property
    def grid(self):
        return leaves(self.in_shardings)[0].mesh

    def place(self, args):
        """``args`` (whole tensors, or the ``arg_specs``) laid out by
        ``in_shardings``: trees of ``parallel.spmd.Sharded``."""
        return tuple(spmd.place_tree(a, ns)
                     for a, ns in zip(args, self.in_shardings))

    def sharded(self) -> Callable:
        """The step on the cell's grid, the one ``build_cell`` was given
        (module docstring). Raises ``ValueError`` for a cell this slice
        does not cover."""
        run = _grid_step(self)
        in_sh, out_sh = self.in_shardings, self.out_shardings

        def step(*args):
            for a, ns in zip(args, in_sh):
                _check_layout(a, ns)
            per_place = run(*args)
            return spmd.assemble(per_place, out_sh)
        return step


def _check_layout(arg, shardings) -> None:
    """Raise ``ValueError`` where an argument's blocks are not laid out
    as the cell's in-sharding says."""
    got = leaves(arg, is_leaf=lambda x: isinstance(x, spmd.Sharded))
    want = leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    if len(got) != len(want):
        raise ValueError(f"{len(got)} arguments for {len(want)} shardings")
    for a, ns in zip(got, want):
        if not isinstance(a, spmd.Sharded) or \
                tuple(a.spec) != tuple(ns.spec) or \
                a.grid.shape != ns.mesh.shape:
            raise ValueError(f"an argument is not laid out as {ns.spec}")


def _grid_step(cell: "Cell") -> Callable:
    """The cell's step on a grid: one output tree a place."""
    from repro_torch.models import gnn_sharded
    from repro_torch.models import transformer_sharded as TFS

    fam = get_arch(cell.arch_id).family
    cfg, kind = cell.cfg, cell.step_kind
    if fam == "gnn" and kind == "train":
        return functools.partial(gnn_sharded.train_step, cfg, OPT_CFG)
    if fam == "recsys" and kind in ("serve", "retrieval"):
        return functools.partial(DLRM.grid_serve, cfg, kind)
    if fam == "lm" and kind in ("train", "prefill", "decode"):
        TFS.check_config(cfg)
        if kind == "train":
            return functools.partial(TFS.train_step, cfg, OPT_CFG)
        if kind == "prefill":
            return functools.partial(TFS.prefill, cfg,
                                     cache_shardings=cell.out_shardings[0])
        return functools.partial(TFS.decode_step, cfg)
    raise ValueError(f"{cell.arch_id} {cell.shape_name}: a {fam} {kind} "
                     f"cell is not run on a grid yet (ROADMAP §1 item 3)")


def _rep(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _batched(mesh, dim0: int, ndim: int, tail_axis=None, tail_dim=None):
    """P(dp, ..., tail_axis at tail_dim) with divisibility fallbacks."""
    dp = SH.dp_axes(mesh)
    spec = [None] * ndim
    if SH._evenly(dim0, mesh, dp):
        spec[0] = dp
    if tail_axis is not None and tail_dim is not None:
        spec[tail_dim] = tail_axis
    return NamedSharding(mesh, P(*spec))


OPT_CFG = adamw.AdamWConfig()


def _with_rules(fn, mesh, family):
    """Set the family's activation rules around each call."""
    def wrapped(*args):
        SH.set_rules(mesh, family)
        try:
            return fn(*args)
        finally:
            SH.set_rules(None, None)
    return wrapped


def build_cell(arch_id: str, shape_name: str, mesh, smoke: bool = False,
               cfg_transform: Optional[Callable] = None,
               dims: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell of ``arch_id`` at ``shape_name`` on ``mesh``. ``dims``
    overrides entries of the shape's dims (``configs.input_specs``)."""
    bundle = get_arch(arch_id)
    cfg = config_for_shape(arch_id, shape_name, smoke=smoke)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    step_kind, in_specs = input_specs(arch_id, shape_name, smoke=smoke,
                                      cfg=cfg, dims=dims)
    fam = bundle.family

    if fam == "lm":
        cell = _build_lm(arch_id, shape_name, step_kind, cfg, in_specs, mesh)
    elif fam == "gnn":
        cell = _build_gnn(arch_id, shape_name, step_kind, cfg, in_specs, mesh)
    elif fam == "recsys":
        cell = _build_dlrm(arch_id, shape_name, step_kind, cfg, in_specs, mesh)
    else:
        raise ValueError(fam)
    cell.fn = _with_rules(cell.fn, mesh, fam)
    return cell


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _build_lm(arch_id, shape_name, step_kind, cfg, in_specs, mesh) -> Cell:
    shapes_tree = TF.param_shapes(cfg)
    p_specs = TF.param_specs(cfg)
    p_shard = SH.lm_param_sharding(mesh, shapes_tree)

    if step_kind == "train":
        def train_step(params, opt_state, batch):
            return TF.train_step(cfg, OPT_CFG, params, opt_state, batch)

        o_specs = adamw.init(p_specs)        # meta tensors
        o_shard = SH.opt_state_sharding(p_shard, o_specs)
        b_shard = SH.lm_batch_sharding(mesh, in_specs)
        metrics_shard = {k: _rep(mesh) for k in
                         ("loss", "nll", "aux", "grad_norm", "lr")}
        return Cell(arch_id, shape_name, step_kind, train_step,
                    (p_specs, o_specs, in_specs),
                    (p_shard, o_shard, b_shard),
                    (p_shard, o_shard, metrics_shard),
                    donate_argnums=(0, 1), cfg=cfg,
                    meta=dict(tokens=in_specs["tokens"].numel()))

    if step_kind == "prefill":
        b, s = in_specs["tokens"].shape
        if s >= 8192 and getattr(cfg, "attn_q_chunk", None) is None:
            # blockwise attention by default for a long prefill, as the
            # reference's cell does
            cfg = dataclasses.replace(cfg, attn_q_chunk=1024)

        def prefill_step(params, tokens):
            return TF.prefill(cfg, params, tokens)

        cache_specs = TF.cache_specs(cfg, b, s)
        c_shard = SH.lm_cache_sharding(mesh, cache_specs)
        tok_shard = _batched(mesh, b, 2)
        logits_shard = _batched(mesh, b, 2, "model", 1)
        return Cell(arch_id, shape_name, step_kind, prefill_step,
                    (p_specs, in_specs["tokens"]),
                    (p_shard, tok_shard),
                    (c_shard, logits_shard),
                    donate_argnums=(), cfg=cfg,
                    meta=dict(tokens=b * s))

    if step_kind == "decode":
        b, _ = in_specs["token"].shape
        # cache max_len: read from the cache specs (k: (L,B,S,kv,dh))
        leaf = leaves(in_specs["cache"])[0]
        max_len = leaf.shape[2] if leaf.ndim >= 4 else leaf.shape[1]

        def serve_step(params, cache, token, pos):
            return TF.decode_step(cfg, params, cache, token, pos)

        c_shard = SH.lm_cache_sharding(mesh, in_specs["cache"])
        tok_shard = _batched(mesh, b, 2)
        pos_shard = _rep(mesh)
        logits_shard = _batched(mesh, b, 2, "model", 1)
        return Cell(arch_id, shape_name, step_kind, serve_step,
                    (p_specs, in_specs["cache"], in_specs["token"],
                     in_specs["pos"]),
                    (p_shard, c_shard, tok_shard, pos_shard),
                    (logits_shard, c_shard),
                    donate_argnums=(1,), cfg=cfg,
                    meta=dict(tokens=b, kv_len=max_len))

    raise ValueError(step_kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _build_gnn(arch_id, shape_name, step_kind, cfg, in_specs, mesh) -> Cell:
    shapes_tree = GNN.param_shapes(cfg)
    p_specs = GNN.param_specs(cfg)
    p_shard = SH.gnn_param_sharding(mesh, shapes_tree)

    def train_step(params, opt_state, batch):
        return GNN.train_step(cfg, OPT_CFG, params, opt_state, batch)

    o_specs = adamw.init(p_specs)        # meta tensors
    o_shard = SH.opt_state_sharding(p_shard, o_specs)
    b_shard = SH.gnn_batch_sharding(mesh, in_specs)
    metrics_shard = {k: _rep(mesh) for k in ("loss", "grad_norm", "lr")}
    n_edges = in_specs["edge_src"].shape[0]
    return Cell(arch_id, shape_name, step_kind, train_step,
                (p_specs, o_specs, in_specs),
                (p_shard, o_shard, b_shard),
                (p_shard, o_shard, metrics_shard),
                donate_argnums=(0, 1), cfg=cfg,
                meta=dict(n_edges=n_edges,
                          n_nodes=in_specs["node_feat"].shape[0]))


# ---------------------------------------------------------------------------
# DLRM cells
# ---------------------------------------------------------------------------

def _build_dlrm(arch_id, shape_name, step_kind, cfg, in_specs, mesh) -> Cell:
    shapes_tree = DLRM.param_shapes(cfg)
    p_specs = DLRM.param_specs(cfg)
    p_shard = SH.dlrm_param_sharding(mesh, shapes_tree)
    b_shard = SH.dlrm_batch_sharding(mesh, in_specs)
    dp = SH.dp_axes(mesh)

    if step_kind == "train":
        if getattr(cfg, "sparse_optimizer", False):
            train_step = DLRM.make_sparse_train_step(cfg, OPT_CFG)
        else:
            train_step = functools.partial(DLRM.train_step, cfg, OPT_CFG)

        o_specs = adamw.init(p_specs)        # meta tensors
        o_shard = SH.opt_state_sharding(p_shard, o_specs)
        if getattr(cfg, "shard_moments_2d", False):
            # the tables' moments split over (model, dp): the optimizer
            # state of the tables divides by the whole grid
            def _m2(tree):
                return tree_map_with_path(
                    lambda path, ns: NamedSharding(mesh, P("model", dp))
                    if path[-1].startswith("table") else ns, tree)
            o_shard = adamw.OptState(o_shard.step, _m2(o_shard.m),
                                     _m2(o_shard.v))
        metrics_shard = {k: _rep(mesh) for k in ("loss", "grad_norm", "lr")}
        return Cell(arch_id, shape_name, step_kind, train_step,
                    (p_specs, o_specs, in_specs),
                    (p_shard, o_shard, b_shard),
                    (p_shard, o_shard, metrics_shard),
                    donate_argnums=(0, 1), cfg=cfg,
                    meta=dict(batch=in_specs["dense"].shape[0]))

    if step_kind == "serve":
        def serve_step(params, batch):
            return DLRM.serve_step(cfg, params, batch)

        out_shard = NamedSharding(mesh, P(dp))
        return Cell(arch_id, shape_name, step_kind, serve_step,
                    (p_specs, in_specs), (p_shard, b_shard), out_shard,
                    donate_argnums=(), cfg=cfg,
                    meta=dict(batch=in_specs["dense"].shape[0]))

    if step_kind == "retrieval":
        def retrieval_step(params, batch):
            return DLRM.retrieval_score(cfg, params, batch)

        out_shard = (_rep(mesh), _rep(mesh))
        return Cell(arch_id, shape_name, step_kind, retrieval_step,
                    (p_specs, in_specs), (p_shard, b_shard), out_shard,
                    donate_argnums=(), cfg=cfg,
                    meta=dict(candidates=in_specs["candidates"].shape[0]))

    raise ValueError(step_kind)
