"""repro_torch's launch layer against the reference's, on the CPU.

  * Cells: ``launch.steps.build_cell`` for all 40 (arch x shape) cells on
    both production grids (the reference's on ``jax.sharding.AbstractMesh``
    of the same shape) equals the reference's in ``step_kind``,
    ``donate_argnums``, ``meta``, the config's ``attn_q_chunk``, every
    argument spec's path, shape and dtype, and every in- and out-sharding
    leaf's spec (a 1-tuple axis equated with its name) and
    ``shard_shape``; ``dryrun.model_flops_for`` and the repeat count equal
    the reference's; ``run_cell``'s ``single`` / ``multi`` byte sums equal
    the sums over the reference's shard shapes.
  * Constraints: ``constraint_spec`` equals the spec the reference's
    ``constrain`` hands to ``jax.lax.with_sharding_constraint``
    (monkeypatched here to capture it), for every rule kind, on shapes
    that divide and shapes that do not.
  * Steps: one smoke-config cell per (family x step kind), 7 in all: the
    port's ``cell.fn`` and the reference's ``cell.jit()`` on the one-device
    grid, on the same inputs made with numpy from fixed seeds, the params
    carried across by ``convert``. Tolerances (float32, both packages'
    ``set_dtypes(float32, float32)``): LM and GNN losses within rtol
    ``LOSS_RTOL``, LM outputs within ``LM_SMOKE_REL`` × the largest |value|
    of the reference's tensor (as ``tests/test_torch_lm.py``), updated
    params and moments after a step within ``STEP_TOL`` (as the LM and GNN
    training tests), DLRM's within rtol 1e-5 / atol 1e-6 and its scores
    within ``DLRM_TOL`` (as the DLRM tests); retrieval's top indices equal.
  * ``run_cell`` on the card's path, run here on the CPU: a cell whose
    arguments exceed a given card size is not run, an injected
    ``torch.cuda.OutOfMemoryError`` is recorded as ``fits_one_card:
    false``, any other exception makes ``main`` exit 1; probes extrapolate
    linearly.
  * ``perf``: each variant's config fields equal the reference's, the cuts,
    and ``summarize``.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh

from repro.launch import steps as RS
from repro.models import layers as RL
from repro.models import transformer as RTF
from repro.models import gnn as RGNN
from repro.models import dlrm as RDLRM
from repro.optim import adamw as RA
from repro.parallel import sharding as RSH
from repro_torch.configs import all_arch_ids, get_arch
from repro_torch.convert import (cache_from_reference,
                                 opt_state_from_reference,
                                 params_from_reference)
from repro_torch.data.graphs import make_gnn_batch, random_graph
from repro_torch.data.recsys import CriteoLikeGenerator
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf
from repro_torch.launch import steps
from repro_torch.launch.mesh import (HW, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import gnn as GNN
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as SH
from repro_torch.pytree import flatten_with_path, leaves

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in all_arch_ids() for s in get_arch(a).shape_names()]
GRIDS = ["single", "multi"]
LOSS_RTOL = 1e-5
LM_SMOKE_REL = 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
DLRM_TOL = dict(rtol=1e-5, atol=1e-5)
# the step's AdamW count: a fresh state's step 0 has a learning rate of 0
# under the default warmup, so the steps start from a later one
OPT_STEP = 50


def _set_dtypes(name):
    RL.set_dtypes(getattr(jnp, name), getattr(jnp, name))
    L.set_dtypes(getattr(torch, name), getattr(torch, name))


@pytest.fixture
def dtypes():
    """Both packages' global dtypes restored after the test (the
    reference's conftest pins float32 for the whole run)."""
    saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    try:
        yield _set_dtypes
    finally:
        RL.set_dtypes(*saved[0])
        L.set_dtypes(*saved[1])


@pytest.fixture
def bf16(dtypes):
    """The production dtypes, as the reference's dry run keeps them."""
    dtypes("bfloat16")


@pytest.fixture
def f32(dtypes):
    dtypes("float32")


@pytest.fixture
def ref_dryrun(monkeypatch):
    """The reference's dry-run module. It appends a forced device count to
    XLA_FLAGS when first imported: the variable is restored after the
    test, before any later test of the process can start JAX's backend
    with it."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun
    return dryrun


@pytest.fixture
def ref_perf(monkeypatch):
    """The reference's ``launch.perf``. Importing it sets XLA_FLAGS to a
    forced device count of 512 where the variable is unset, which would
    give every later JAX backend of the process 512 devices: it is
    imported inside a test, never at collection, and the variable is
    restored after the test."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import perf as ref
    return ref


def _jax_grid(grid):
    if grid == "multi":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _port_grid(grid):
    return make_production_mesh(multi_pod=(grid == "multi"))


def _jpath(path):
    """A jax key path in ``repro_torch.pytree``'s form."""
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(str(k.idx))
        else:
            out.append("." + k.name)
    return tuple(out)


def _ref_flat(tree):
    return [(_jpath(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _entry(e):
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _spec(spec):
    return tuple(_entry(e) for e in spec)


def _dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


def _out_shapes(cell):
    """The shapes of the step's outputs, in the order of
    ``cell.out_shardings``' leaves."""
    kind = cell.step_kind
    if kind == "train":
        params, opt, _ = cell.arg_specs
        n_metrics = len(leaves(cell.out_shardings[2]))
        return [tuple(x.shape) for x in leaves((params, opt))] \
            + [()] * n_metrics
    if kind == "prefill":
        b, s = cell.arg_specs[1].shape
        from repro_torch.models import transformer as TF
        return [tuple(x.shape) for x in leaves(TF.cache_specs(cell.cfg, b, s))] \
            + [(b, cell.cfg.vocab)]
    if kind == "decode":
        b = cell.arg_specs[2].shape[0]
        return [(b, cell.cfg.vocab)] \
            + [tuple(x.shape) for x in leaves(cell.arg_specs[1])]
    if kind == "serve":
        return [(cell.meta["batch"],)]
    k = min(100, cell.meta["candidates"])
    return [(1, k), (1, k)]


# ---------------------------------------------------------------------------
# cells on the production grids
# ---------------------------------------------------------------------------

def test_forty_cells_of_ten_archs():
    assert len(CELLS) == 40 and len(all_arch_ids()) == 10
    from repro.configs import all_arch_ids as ref_ids, get_arch as ref_get
    assert CELLS == [(a, s) for a in ref_ids()
                     for s in ref_get(a).shape_names()]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_equals_reference(bf16, arch, shape, grid):
    ref = RS.build_cell(arch, shape, _jax_grid(grid))
    got = steps.build_cell(arch, shape, _port_grid(grid))
    assert (got.arch_id, got.shape_name) == (arch, shape)
    assert got.step_kind == ref.step_kind
    assert got.donate_argnums == ref.donate_argnums
    assert got.meta == ref.meta
    assert getattr(got.cfg, "attn_q_chunk", None) == \
        getattr(ref.cfg, "attn_q_chunk", None)
    ref_args, got_args = _ref_flat(ref.arg_specs), \
        flatten_with_path(got.arg_specs)
    assert [p for p, _ in got_args] == [p for p, _ in ref_args]
    assert [(tuple(x.shape), _dtype_name(x)) for _, x in got_args] == \
        [(tuple(x.shape), x.dtype.name) for _, x in ref_args]
    assert all(x.device.type == "meta" for _, x in got_args)
    in_shapes = [tuple(x.shape) for _, x in got_args]
    for which, shapes in (("in_shardings", in_shapes),
                          ("out_shardings", _out_shapes(got))):
        r = _ref_flat(getattr(ref, which))
        g = flatten_with_path(getattr(got, which))
        assert [p for p, _ in g] == [p for p, _ in r], which
        assert len(shapes) == len(g), which
        for (path, rs), (_, gs), shp in zip(r, g, shapes):
            assert isinstance(gs, SH.NamedSharding)
            assert _spec(gs.spec) == _spec(rs.spec), (which, path)
            assert gs.shard_shape(shp) == tuple(rs.shard_shape(shp)), \
                (which, path, shp)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(bf16, ref_dryrun, arch, shape):
    ref = RS.build_cell(arch, shape, _jax_grid("single"))
    got = steps.build_cell(arch, shape, _port_grid("single"))
    assert D.model_flops_for(got) == ref_dryrun.model_flops_for(ref)
    r = D._scan_repeats(got.cfg)
    assert r == ref_dryrun._scan_repeats(ref.cfg)
    for k in D.PROBE_REPEATS:
        pc = D._repeats_transform(got.cfg, k)
        rc = ref_dryrun._repeats_transform(ref.cfg, k)
        assert getattr(pc, "n_layers", None) == getattr(rc, "n_layers", None)
        assert D._scan_repeats(pc) == ref_dryrun._scan_repeats(rc)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_bytes_equal_reference_shard_shapes(bf16, tmp_path, arch,
                                                     shape, grid):
    """The ``single`` / ``multi`` record: per-device bytes = Σ over the
    arguments of the reference's shard shape × itemsize, whole bytes = Σ of
    the whole shapes, and per-device ≤ whole ≤ per-device × n_chips."""
    rec = D.run_cell(arch, shape, grid, tmp_path)
    ref = RS.build_cell(arch, shape, _jax_grid(grid))
    per_dev = whole = 0
    for x, ns in zip(jax.tree_util.tree_leaves(ref.arg_specs),
                     jax.tree_util.tree_leaves(ref.in_shardings)):
        per_dev += math.prod(ns.shard_shape(x.shape)) * x.dtype.itemsize
        whole += math.prod(x.shape) * x.dtype.itemsize
    n = 512 if grid == "multi" else 256
    assert rec["ok"] and rec["n_chips"] == n and rec["mesh"] == grid
    assert rec["argument_size_in_bytes"] == per_dev
    assert rec["argument_bytes_whole"] == whole
    assert per_dev <= whole <= per_dev * n
    assert rec["step_kind"] == ref.step_kind
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__{grid}.json")
                         .read_text())
    assert on_disk == rec


def test_grids():
    single, multi = make_production_mesh(), \
        make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert single.devices is None and multi.devices is None
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices.shape == (1, 1)
    assert host.devices[0, 0] == torch.device("cpu")
    grid = make_production_mesh(devices=["cpu"] * 256)
    assert grid.devices.shape == (16, 16)
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=["cpu"] * 4)
    assert HW["peak_bf16_flops"] == 989e12 and HW["hbm_bandwidth"] == 3.35e12
    assert SH.dp_axes(multi) == ("pod", "data") and \
        SH.all_axes(single) == ("data", "model")


def test_shard_shape_needs_a_divisor():
    ns = SH.NamedSharding(make_production_mesh(), SH.P(("data", "model"),
                                                       None))
    assert ns.shard_shape((512, 3, 5)) == (2, 3, 5)
    with pytest.raises(ValueError, match="does not divide"):
        ns.shard_shape((100, 3))
    with pytest.raises(ValueError, match="more entries"):
        SH.NamedSharding(make_production_mesh(), SH.P(None, None)) \
            .shard_shape((4,))


def test_tree_helpers_equal_reference(bf16):
    """``replicate``, ``like_tree`` and ``opt_state_sharding`` on an LM
    smoke config's params, against the reference's."""
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    cfg = get_arch("deepseek-v2-236b").smoke_config
    rcfg = _ref_cfg("deepseek-v2-236b", smoke=True)
    jm, pm = _jax_grid("single"), _port_grid("single")
    p_specs, r_specs = TF.param_specs(cfg), RTF.param_specs(rcfg)
    rep, rrep = SH.replicate(pm, p_specs), RSH.replicate(jm, r_specs)
    assert [_spec(s.spec) for s in leaves(rep)] == \
        [_spec(s.spec) for s in jax.tree_util.tree_leaves(rrep)]
    shard = SH.lm_param_sharding(pm, TF.param_shapes(cfg))
    rshard = RSH.lm_param_sharding(jm, RTF.param_shapes(rcfg))
    like = SH.like_tree(shard, p_specs)
    assert [p for p, _ in flatten_with_path(like)] == \
        [p for p, _ in flatten_with_path(p_specs)]
    assert [s.spec for s in leaves(like)] == [s.spec for s in leaves(shard)]
    o = SH.opt_state_sharding(shard, adamw.init(p_specs))
    ro = RSH.opt_state_sharding(rshard, jax.eval_shape(RA.init, r_specs))
    assert [(p, _spec(s.spec)) for p, s in flatten_with_path(o)] == \
        [(p, _spec(s.spec)) for p, s in _ref_flat(ro)]


def _ref_cfg(arch, smoke=False):
    from repro.configs import get_arch as ref_get
    b = ref_get(arch)
    return b.smoke_config if smoke else b.config


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

RULE_CASES = [
    ("lm", "lm_act", (64, 4096, 3584)), ("lm", "lm_act", (3, 5, 7)),
    ("lm", "lm_act", (32, 4096)),
    ("lm", "lm_logits", (32, 16, 152064)), ("lm", "lm_logits", (1, 16, 99)),
    ("lm", "lm_logits2", (128, 152064)), ("lm", "lm_logits2", (1, 32000)),
    ("lm", "moe_ge", (32, 160, 64, 5120)), ("lm", "moe_ge", (2, 6, 4, 8)),
    ("lm", "moe_x_local", (32, 4096, 5120)), ("lm", "moe_x_local", (5, 4, 2)),
    ("lm", "attn_q", (32, 4, 7, 1024, 32768)), ("lm", "attn_q", (1, 4, 7, 9, 3)),
    ("lm", "attn_s", (128, 4, 7, 1, 32768)), ("lm", "attn_s", (1, 1, 1, 1, 5)),
    ("lm", "mla_scores", (32, 128, 1024, 4096)),
    ("lm", "mla_scores", (1, 6, 3, 9)),
    ("lm", "dlrm_act", (64, 128)),
    ("gnn", "gnn_nodes", (2449408, 128)), ("gnn", "gnn_nodes", (2708, 16)),
    ("recsys", "dlrm_act", (65536, 128)), ("recsys", "dlrm_act", (3, 128)),
    ("recsys", "dlrm_rows", (4096, 128)), ("recsys", "gnn_nodes", (512, 4)),
]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("family,kind,shape", RULE_CASES)
def test_constraint_spec_equals_reference(monkeypatch, family, kind, shape,
                                          grid):
    seen = []

    def capture(x, sharding):
        seen.append(sharding.spec)
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    RSH.set_rules(_jax_grid(grid), family)
    SH.set_rules(_port_grid(grid), family)
    try:
        RSH.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
        got = SH.constraint_spec(shape, kind)
        t = torch.empty(shape, device="meta")
        assert SH.constrain(t, kind) is t
    finally:
        RSH.set_rules(None, None)
        SH.set_rules(None, None)
    if not seen:                         # no rule of that kind: no-op
        assert got is None
        return
    assert len(seen) == 1
    assert _spec(got) == _spec(seen[0])


def test_constrain_without_rules_is_the_identity():
    SH.set_rules(None, None)
    t = torch.zeros(4, 8)
    assert SH.constrain(t, "lm_act") is t
    assert SH.constraint_spec((4, 8), "lm_act") is None


# ---------------------------------------------------------------------------
# the steps of seven smoke cells, port against reference
# ---------------------------------------------------------------------------

def _ref_host_mesh():
    """The reference's ``make_host_mesh`` on this process's first device."""
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_rel(got, want, rel=LM_SMOKE_REL, err=""):
    want = _f32(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(_f32(got), want, rtol=rel, atol=rel * scale,
                               err_msg=err)


def _cells(arch, shape):
    return (RS.build_cell(arch, shape, _ref_host_mesh(), smoke=True),
            steps.build_cell(arch, shape, make_host_mesh("cpu"), smoke=True))


def _states(ref_cell, init):
    """The reference's params and an AdamW state at ``OPT_STEP``, and the
    same carried across to the port."""
    rp = init(ref_cell.cfg, jax.random.PRNGKey(3))
    ro = RA.init(rp)._replace(step=jnp.asarray(OPT_STEP, jnp.int32))
    pp = params_from_reference(_np_tree(rp))
    po = opt_state_from_reference(RA.OptState(
        np.asarray(ro.step), _np_tree(ro.m), _np_tree(ro.v)))
    return (rp, ro), (pp, po)


def _assert_step(rout, pout, tol=STEP_TOL):
    """(params, opt_state, metrics) of both: the loss, the gradient norm
    and lr, every param and moment."""
    (rp, ro, rm), (pp, po, pm) = rout, pout
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-4)
    assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert float(pm["lr"]) > 0
    assert int(po.step) == int(ro.step) == OPT_STEP + 1
    got = dict(flatten_with_path((pp, po.m, po.v)))
    for path, want in _ref_flat((rp, ro.m, ro.v)):
        np.testing.assert_allclose(_f32(got[path]), _f32(want),
                                   err_msg=str(path), **tol)


def test_lm_train_cell_step_equals_reference(f32):
    ref, got = _cells("qwen2-7b", "train_4k")
    (rp, ro), (pp, po) = _states(ref, RTF.init_params)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, got.cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    pout = got.fn(pp, po, {k: torch.from_numpy(v) for k, v in batch.items()})
    rout = ref.jit()(rp, ro, {k: jnp.asarray(v) for k, v in batch.items()})
    assert pout[0] is pp and pout[1] is po             # in place
    assert set(pout[2]) == set(rout[2]) == set(got.out_shardings[2])
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(pout[2][k]), float(rout[2][k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    _assert_step(rout, pout)


def test_lm_prefill_cell_equals_reference(f32):
    """yi-6b's smoke config at 2,048 tokens: the cell's attn_q_chunk of
    1,024 (set because prefill_32k's sequence is long) splits the queries
    in two on both sides."""
    ref, got = _cells("yi-6b", "prefill_32k")
    assert got.cfg.attn_q_chunk == ref.cfg.attn_q_chunk == 1024
    rp = RTF.init_params(ref.cfg, jax.random.PRNGKey(4))
    pp = params_from_reference(_np_tree(rp))
    toks = np.random.default_rng(12).integers(
        0, got.cfg.vocab, (1, 2048)).astype(np.int32)
    rcache, rlogits = ref.jit()(rp, jnp.asarray(toks))
    pcache, plogits = got.fn(pp, torch.from_numpy(toks))
    _close_rel(plogits, rlogits, err="logits")
    got_c = dict(flatten_with_path(pcache))
    for path, want in _ref_flat(rcache):
        _close_rel(got_c[path], want, err=str(path))


def test_lm_decode_cell_equals_reference(f32):
    """deepseek-v2-236b's smoke config (MLA, MoE): one token at the last
    position of a random 64-position cache."""
    ref, got = _cells("deepseek-v2-236b", "decode_32k")
    rp = RTF.init_params(ref.cfg, jax.random.PRNGKey(5))
    pp = params_from_reference(_np_tree(rp))
    rng = np.random.default_rng(13)
    b, s = 2, 64
    cache = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        RTF.cache_specs(ref.cfg, b, s))
    pcache = cache_from_reference(cache)
    token = rng.integers(0, got.cfg.vocab, (b, 1)).astype(np.int32)
    rlogits, rcache = ref.jit()(rp, jax.tree_util.tree_map(jnp.asarray,
                                                           cache),
                                jnp.asarray(token), jnp.int32(s - 1))
    plogits, pc = got.fn(pp, pcache, torch.from_numpy(token),
                         torch.tensor(s - 1, dtype=torch.int32))
    assert pc is pcache                                  # in place
    _close_rel(plogits, rlogits, err="logits")
    got_c = dict(flatten_with_path(pc))
    for path, want in _ref_flat(rcache):
        _close_rel(got_c[path], want, err=str(path))


def test_gnn_cell_step_equals_reference(f32):
    """graphcast's smoke config on a molecule-like batch: 4 graphs of
    RAND(30, 64), regression targets."""
    ref, got = _cells("graphcast", "molecule")
    (rp, ro), (pp, po) = _states(ref, RGNN.init_params)
    parts = [random_graph(30, 64, seed=i) for i in range(4)]
    src = np.concatenate([s + 30 * i for i, (s, _) in enumerate(parts)])
    dst = np.concatenate([d + 30 * i for i, (_, d) in enumerate(parts)])
    batch = make_gnn_batch(src, dst, 120, got.cfg.d_in, d_target=1,
                           pad_to=64, seed=14)
    batch["graph_id"][:120] = np.repeat(np.arange(4), 30)
    pout = got.fn(pp, po, {k: torch.from_numpy(v) for k, v in batch.items()})
    rout = ref.jit()(rp, ro, {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(pout[2]) == set(rout[2]) == set(got.out_shardings[2])
    _assert_step(rout, pout)


def _dlrm_batch(cfg, b, seed, labels=True):
    data = CriteoLikeGenerator(cfg.table_sizes, cfg.n_dense, cfg.hot,
                               seed=seed)
    return data.batch(b, with_labels=labels)


def test_dlrm_train_cell_step_equals_reference(f32):
    """The smoke config (no ``sparse_optimizer``): the dense step, the
    tables' gradients included."""
    ref, got = _cells("dlrm-mlperf", "train_batch")
    assert not got.cfg.sparse_optimizer
    (rp, ro), (pp, po) = _states(ref, RDLRM.init_params)
    batch = _dlrm_batch(got.cfg, 32, 15)
    pout = got.fn(pp, po, {k: torch.from_numpy(v) for k, v in batch.items()})
    rout = ref.jit()(rp, ro, {k: jnp.asarray(v) for k, v in batch.items()})
    assert pout[0] is pp and pout[1] is po
    _assert_step(rout, pout, dict(rtol=1e-5, atol=1e-6))


def test_dlrm_serve_cell_equals_reference(f32):
    ref, got = _cells("dlrm-mlperf", "serve_p99")
    rp = RDLRM.init_params(ref.cfg, jax.random.PRNGKey(6))
    pp = params_from_reference(_np_tree(rp))
    batch = _dlrm_batch(got.cfg, 64, 16, labels=False)
    want = ref.jit()(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    out = got.fn(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(_f32(out), _f32(want), **DLRM_TOL)


def test_dlrm_retrieval_cell_equals_reference(f32):
    ref, got = _cells("dlrm-mlperf", "retrieval_cand")
    rp = RDLRM.init_params(ref.cfg, jax.random.PRNGKey(7))
    pp = params_from_reference(_np_tree(rp))
    batch = _dlrm_batch(got.cfg, 1, 17, labels=False)
    batch["candidates"] = np.random.default_rng(17).standard_normal(
        (300, got.cfg.embed_dim)).astype(np.float32)
    rs, ri = ref.jit()(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    ps, pi = got.fn(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(_f32(ps), _f32(rs), **DLRM_TOL)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


# ---------------------------------------------------------------------------
# run_cell on the card's path, here on the CPU
# ---------------------------------------------------------------------------

def test_card_cell_runs_on_the_cpu(f32, tmp_path):
    """A smoke cell end to end: made arguments at the spec's shapes, timed
    steps, counted flops, a finite result, its record on disk."""
    rec = D.run_cell("dlrm-mlperf", "serve_p99", "card", tmp_path,
                     smoke=True, torch_device="cpu")
    assert rec["ok"] and rec["ran"] and rec["fits_one_card"], rec
    assert rec["device"] == "cpu" and rec["n_chips"] == 1
    assert rec["collectives"] == {} and rec["finite"]
    assert rec["step_calls"] == 5 and len(rec["step_ms_all"]) == 3
    assert rec["counted_flops"] > 0 and rec["useful_flops_ratio"] > 0
    assert "t_compute_s" not in rec     # the card's terms: on a card only
    assert json.loads((tmp_path / "dlrm-mlperf__serve_p99__card__smoke.json")
                      .read_text()) == rec


def test_card_cell_not_run_when_arguments_exceed_the_card(f32, tmp_path):
    rec = D.run_cell("gcn-cora", "full_graph_sm", "card", tmp_path,
                     smoke=True, torch_device="cpu", card_bytes=1 << 20)
    cell = steps.build_cell("gcn-cora", "full_graph_sm",
                            make_host_mesh("cpu"), smoke=True)
    assert rec["ok"] and not rec["ran"] and not rec["fits_one_card"]
    assert rec["reason"] == "arguments exceed the card"
    assert rec["argument_size_in_bytes"] == D.argument_bytes(cell) > 1 << 20
    assert "step_ms" not in rec


def test_card_cell_records_out_of_memory(f32, tmp_path, monkeypatch):
    def oom(*args, **kw):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(GNN, "train_step", oom)
    rec = D.run_cell("gcn-cora", "full_graph_sm", "card", tmp_path,
                     smoke=True, torch_device="cpu")
    assert rec["ok"] and not rec["ran"] and not rec["fits_one_card"], rec
    assert rec["reason"] == "out of memory in the step"
    assert rec["oom"].startswith("CUDA out of memory")
    assert "error" not in rec


def test_main_exits_1_when_a_cell_fails(f32, tmp_path, monkeypatch, capsys):
    def broken(*args, **kw):
        raise RuntimeError("a fault in the step")

    argv = ["--arch", "gcn-cora", "--shape", "full_graph_sm", "--mesh",
            "card", "--smoke", "--torch-device", "cpu", "--out",
            str(tmp_path)]
    assert D.main(argv) == 0
    monkeypatch.setattr(GNN, "train_step", broken)
    assert D.main(argv + ["--force"]) == 1
    rec = json.loads((tmp_path / "gcn-cora__full_graph_sm__card__smoke.json")
                     .read_text())
    assert not rec["ok"] and "a fault in the step" in rec["error"]
    assert "1 failed" in capsys.readouterr().out


def test_probes_extrapolate_linearly(f32, tmp_path):
    """qwen2-7b's smoke config at 4 layers (R = 4 > 2): the probes at 2 and
    3 layers run, and the flops extrapolated to 4 equal the whole run's
    (a decode step's flops are linear in the layers)."""
    rec = D.run_cell("qwen2-7b", "decode_32k", "card", tmp_path, smoke=True,
                     torch_device="cpu",
                     cfg_transform=lambda c: dataclasses.replace(
                         c, n_layers=4),
                     dims={"batch": 1, "seq": 16})
    assert rec["ok"] and rec["ran"] and rec["scan_repeats"] == 4, rec
    k2, k3 = rec["probes"]["k2"], rec["probes"]["k3"]
    assert k2["ran"] and k3["ran"]
    ext = rec["extrapolated"]
    assert ext["counted_flops"] == k2["counted_flops"] + 2 * (
        k3["counted_flops"] - k2["counted_flops"]) == rec["counted_flops"]
    assert len(k2["step_ms_all"]) == len(k3["step_ms_all"]) == \
        D.PROBE_TIMED_STEPS
    diff = k3["step_ms"] - k2["step_ms"]
    spread = sum(max(k["step_ms_all"]) - min(k["step_ms_all"])
                 for k in (k2, k3))
    assert ext["step_ms_per_repeat"] == pytest.approx(diff)
    assert ext["step_ms_spread"] == pytest.approx(2 * spread)
    # a difference inside its spread leaves the extrapolation unresolved
    value = ext["step_ms"] if diff > spread else ext["step_ms_unresolved"]
    assert (ext["step_ms"] is None) == (diff <= spread)
    assert value == pytest.approx(k2["step_ms"] + 2 * diff)
    assert rec["finite"]


def test_extrapolated_step_carries_its_spread():
    """R = 10: eight per-repeat differences added to the 2-repeat probe;
    the spread is the two probes' ranges summed, times R - 2; a difference
    inside that spread is left unresolved."""
    lo = {"step_ms": 5.0, "step_ms_all": [4.9, 5.0, 5.1]}
    hi = {"step_ms": 6.5, "step_ms_all": [6.4, 6.5, 6.6]}
    ext = D._extrapolated_step(lo, hi, 10)
    assert ext["step_ms"] == pytest.approx(5.0 + 8 * 1.5)
    assert ext["step_ms_per_repeat"] == pytest.approx(1.5)
    assert ext["step_ms_per_repeat_spread"] == pytest.approx(0.4)
    assert ext["step_ms_spread"] == pytest.approx(3.2)
    assert "step_ms_unresolved" not in ext
    hi = {"step_ms": 5.2, "step_ms_all": [4.8, 5.2, 5.6]}
    ext = D._extrapolated_step(lo, hi, 10)
    assert ext["step_ms"] is None
    assert ext["step_ms_unresolved"] == pytest.approx(5.0 + 8 * 0.2)


def test_card_terms_against_the_card_peaks():
    """t_memory_s: the arguments read once at 3.35 TB/s; t_compute_s: the
    counted flops at 989 TFLOP/s, and its share of the measured step."""
    rec = {"argument_size_in_bytes": 3.35e9, "counted_flops": 989e9,
           "step_ms": 2.0}
    D._card_terms(rec)
    assert rec["t_memory_s"] == pytest.approx(1e-3)
    assert rec["t_compute_s"] == pytest.approx(1e-3)
    assert rec["bf16_peak_share"] == pytest.approx(0.5)
    ext = {"counted_flops": 989e9, "step_ms": None}
    D._card_terms(ext)
    assert ext == {"counted_flops": 989e9, "step_ms": None}


def test_flop_counter_counts_the_float32_products():
    """``mm`` / ``bmm`` with ``out_dtype`` (``layers.mm_f32`` on the card)
    and without: 2·m·n·k each."""
    a = torch.empty(4, 3, 5, dtype=torch.bfloat16, device="meta")
    b = torch.empty(4, 5, 7, dtype=torch.bfloat16, device="meta")
    with D.flop_counter() as counter:
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.mm(a[0], b[0], out_dtype=torch.float32)
        torch.bmm(a, b)
        torch.mm(a[0], b[0])
    assert counter.get_total_flops() == 2 * (2 * 4 * 3 * 5 * 7 + 2 * 3 * 5 * 7)


def test_made_arguments_match_the_specs(f32):
    """``make_args`` of a cell of each family and step kind, smoke configs
    at cut shapes: every leaf at its spec's shape and dtype (it checks)."""
    grid = make_host_mesh("cpu")
    for arch, shape, dims in (
            ("yi-6b", "train_4k", {"batch": 2, "seq": 8}),
            ("yi-6b", "prefill_32k", {"batch": 1, "seq": 8}),
            ("llama4-maverick-400b-a17b", "long_500k", {"seq": 8}),
            ("schnet", "molecule", {"batch": 3}),
            ("gin-tu", "minibatch_lg", {"blk_nodes": 700, "blk_edges": 900}),
            ("dlrm-mlperf", "retrieval_cand", {"n_candidates": 10})):
        cell = steps.build_cell(arch, shape, grid, smoke=True, dims=dims)
        args = D.make_args(cell, torch.device("cpu"), dims)
        assert len(leaves(args)) == len(leaves(cell.arg_specs))
    batch = args[1]
    assert batch["candidates"].shape == (10, cell.cfg.embed_dim)


def test_dryrun_cli_writes_80_records_with_no_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "dry-run complete: 80 ok, 0 failed" in res.stdout
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 80
    assert all(json.loads(f.read_text())["ok"] for f in files)


# ---------------------------------------------------------------------------
# perf
# ---------------------------------------------------------------------------

PERF_FIELDS = ("attn_q_chunk", "moe_impl", "sparse_optimizer",
               "shard_moments_2d", "n_layers", "table_sizes")


@pytest.mark.parametrize("key", sorted(perf.CELLS))
def test_perf_variants_give_reference_fields(ref_perf, key):
    assert sorted(ref_perf.CELLS) == sorted(perf.CELLS)
    ra, rs, rv = ref_perf.CELLS[key]
    pa, ps, pv = perf.CELLS[key]
    assert (pa, ps) == (ra, rs)
    assert [n for n, _ in pv()] == [n for n, _ in rv()]
    rcfg, pcfg = _ref_cfg(ra), get_arch(pa).config
    for (name, rtf), (_, ptf) in zip(rv(), pv()):
        r, p = rtf(rcfg), ptf(pcfg)
        for f in PERF_FIELDS:
            assert getattr(p, f, None) == getattr(r, f, None), (name, f)


def test_perf_cuts():
    """One named cut a cell, widths kept: the qwen2 prefill's batch, the
    deepseek train's batch and depth (the most layers whose 12 B a param
    fits: 2 of 60 on an 80-GB card, none on a 10-GB one), dlrm's table
    rows."""
    tf, dims, red = perf.card_cut("qwen2_prefill", 80 * 10 ** 9)
    assert tf is None and dims == {"batch": 1}
    cell = steps.build_cell("qwen2-7b", "prefill_32k", make_production_mesh(),
                            dims=dims)
    assert cell.arg_specs[1].shape == (1, 32768)
    tf, dims, red = perf.card_cut("deepseek_train", 80 * 10 ** 9)
    cfg = tf(get_arch("deepseek-v2-236b").config)
    assert cfg.n_layers == 2 and red["fits"] and dims == {"batch": 1}
    assert cfg.d_model == get_arch("deepseek-v2-236b").config.d_model
    assert cfg.params_count() * perf.TRAIN_BYTES_PER_PARAM <= 80 * 10 ** 9
    assert dataclasses.replace(cfg, n_layers=3).params_count() \
        * perf.TRAIN_BYTES_PER_PARAM > 80 * 10 ** 9
    assert not perf.card_cut("deepseek_train", 10 ** 10)[2]["fits"]
    tf, dims, red = perf.card_cut("dlrm_train", 80 * 10 ** 9)
    cfg = tf(get_arch("dlrm-mlperf").config)
    assert max(cfg.table_sizes) == perf.DLRM_TABLE_CAP
    assert red["rows"] == [187_775_488, sum(cfg.table_sizes)]


def test_perf_main_records_a_cell_no_cut_fits(tmp_path, capsys,
                                              monkeypatch):
    import repro_torch.launch.mesh as mesh
    monkeypatch.setattr(mesh, "hbm_bytes", lambda torch_device: 1000)
    assert perf.main(["--cell", "deepseek_train", "--torch-device", "cpu",
                      "--out", str(tmp_path)]) == 0
    recs = [json.loads(f.read_text()) for f in sorted(tmp_path.glob("*"))]
    assert len(recs) == 4 and not any(r["ran"] for r in recs)
    assert "NOT RUN" in capsys.readouterr().out


def test_summarize_formats_a_record():
    ran = {"ok": True, "ran": True, "step_ms": 12.5, "peak_bytes": 2 ** 31,
           "counted_flops": 1e12, "useful_flops_ratio": 0.5,
           "bf16_peak_share": 0.08,
           "extrapolated": {"step_ms": 40.0, "step_ms_spread": 1.5,
                            "peak_bytes": 2 ** 33}}
    line = perf.summarize(ran)
    assert "step=12.500ms" in line and "peak=2.0GiB" in line
    assert "useful=0.500" in line and "bf16_peak=0.080" in line
    assert "extrapolated step=40.000ms +-1.500ms peak=8.0GiB" in line
    ran["extrapolated"].update(step_ms=None, step_ms_unresolved=30.0)
    assert "extrapolated step=unresolved (30.000ms) +-1.500ms" in \
        perf.summarize(ran)
    assert perf.summarize({"ok": True, "ran": False,
                           "reason": "arguments exceed the card"}) == \
        "NOT RUN: arguments exceed the card"
    assert perf.summarize({"ok": False, "error": "E: x"}).startswith("FAIL")
