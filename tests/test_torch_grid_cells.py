"""repro_torch's cells split over a named device grid, against the
reference's cells under ``jax.jit`` on a mesh of the same shape.

The reference runs in one subprocess with four forced host devices
(``--xla_force_host_platform_device_count=4``), on ``jax.make_mesh`` of
(2, 2) and (1, 4) ``("data", "model")``; the port runs
``Cell.sharded()`` on ``make_grid(dims, ["cpu"] * 4)``. Inputs are made
with numpy from fixed seeds here and read by both; the reference's params
are carried across by ``convert``. Float32 on both sides
(``set_dtypes(float32, float32)``). The tolerances are
``tests/test_torch_launch.py``'s: losses within rtol ``LOSS_RTOL``,
params and moments after a step within ``STEP_TOL``, DLRM scores within
``DLRM_TOL``, LM outputs within ``LM_SMOKE_REL`` × the largest |value| of
the reference's output.

  * GNN training, one step of each arch on (2, 2), and gcn-cora on (1, 4)
    with node and edge counts the grid does not divide (both stay whole
    and each place takes its part): against the reference's sharded step
    and against the port's whole ``cell.fn``; run twice, bit for bit.
  * DLRM serving (serve_p99, serve_bulk, retrieval_cand) on (2, 2):
    scores within ``DLRM_TOL`` of the reference's, block for block;
    retrieval's top indices equal; at hot = 1 the grid's lookups equal
    the whole lookups bit for bit.
  * Dense-LM serving: prefill (2 x 64 tokens in four query chunks, the
    cells' chunk cut from 1,024 to ``Q_CHUNK`` on both sides) and decode (a random 64-position cache, the token at
    position 40) for qwen2-7b, yi-6b and qwen1.5-32b's smoke configs on
    (2, 2), and qwen2-7b's on (1, 4), where a key head's columns are
    split in halves: logits and each cache block against the
    reference's block at that place, greedy tokens equal to the whole
    model's. The (2, 2) grid's 2-wide ``model`` axis puts all of SwiGLU's
    gate columns on one place and all of its up columns on the other.
  * Grid records: ``run_cell(..., "single")`` of each of the slice's
    cells carries collectives (DLRM's and GraphCast's equal to their
    closed forms); a ``card`` record on a CPU grid carries the ledger of
    one step; a cell outside the slice raises ``ValueError``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.data.graphs import make_gnn_batch, random_graph
from repro_torch.data.recsys import CriteoLikeGenerator
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_grid
from repro_torch.models import dlrm as DLRM
from repro_torch.models import layers as L
from repro_torch.models import transformer_sharded as TFS
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import spmd
from repro_torch.pytree import flatten_with_path, leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
# tests/test_torch_launch.py's tolerances and AdamW step
LOSS_RTOL = 1e-5
LM_SMOKE_REL = 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
DLRM_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_STEP = 50
PREFILL = (2, 64)
# the prefill cells' blockwise attention cut to 16-query chunks on both
# sides (the cells set 1,024 for their 32k sequence), so a short prompt
# runs four chunks
Q_CHUNK = 16
DECODE = (2, 64, 40)          # batch, cache length, position

GNN_CASES = [("gcn-cora", "full_graph_sm", (2, 2)),
             ("gin-tu", "minibatch_lg", (2, 2)),
             ("schnet", "molecule", (2, 2)),
             ("graphcast", "molecule", (2, 2)),
             ("gcn-cora", "full_graph_sm", (1, 4))]
DLRM_CASES = [("dlrm-mlperf", s, (2, 2))
              for s in ("serve_p99", "serve_bulk", "retrieval_cand")]
LM_CASES = [(a, s, g) for a, g in (("qwen2-7b", (2, 2)), ("yi-6b", (2, 2)),
                                   ("qwen1.5-32b", (2, 2)),
                                   ("qwen2-7b", (1, 4)))
            for s in ("prefill_32k", "decode_32k")]
FAMILY = {"gcn-cora": "gnn", "gin-tu": "gnn", "schnet": "gnn",
          "graphcast": "gnn", "dlrm-mlperf": "recsys", "qwen2-7b": "lm",
          "yi-6b": "lm", "qwen1.5-32b": "lm"}


def _name(arch, shape, dims):
    return f"{arch}__{shape}__{dims[0]}x{dims[1]}"


@pytest.fixture(autouse=True)
def f32():
    saved = L.PDTYPE, L.ADTYPE
    L.set_dtypes(torch.float32, torch.float32)
    try:
        yield
    finally:
        L.set_dtypes(*saved)


def _chunked(cfg):
    return dataclasses.replace(cfg, attn_q_chunk=Q_CHUNK)


def _grid_cell(arch, shape, dims):
    return steps.build_cell(arch, shape, make_grid(dims, ["cpu"] * 4),
                            smoke=True, cfg_transform=_chunked
                            if shape == "prefill_32k" else None)


# ---------------------------------------------------------------------------
# inputs, made here with numpy
# ---------------------------------------------------------------------------

def _gnn_batch(cfg, shape, dims, seed):
    if dims == (1, 4):                       # 30 nodes, 62 edges: neither
        rng = np.random.default_rng(seed)    # divides by 4
        src = rng.integers(0, 30, 62)
        dst = rng.integers(0, 30, 62)
        return make_gnn_batch(src, dst, 30, cfg.d_in, n_classes=cfg.d_out,
                              seed=seed)
    if shape == "molecule":
        parts = [random_graph(30, 64, seed=seed + i) for i in range(4)]
        src = np.concatenate([s + 30 * i for i, (s, _) in enumerate(parts)])
        dst = np.concatenate([d + 30 * i for i, (_, d) in enumerate(parts)])
        batch = make_gnn_batch(src, dst, 120, cfg.d_in, d_target=1,
                               pad_to=64, seed=seed)
        batch["graph_id"][:120] = np.repeat(np.arange(4), 30)
        return batch
    src, dst = random_graph(100, 400, seed=seed)
    return make_gnn_batch(src, dst, 100, cfg.d_in, n_classes=cfg.d_out,
                          pad_to=64, seed=seed)


def _inputs(arch, shape, dims, seed):
    cell = _grid_cell(arch, shape, dims)
    cfg, fam = cell.cfg, FAMILY[arch]
    if fam == "gnn":
        return {f"batch/{k}": v for k, v in
                _gnn_batch(cfg, shape, dims, seed).items()}
    if fam == "recsys":
        data = CriteoLikeGenerator(cfg.table_sizes, cfg.n_dense, cfg.hot,
                                   seed=seed)
        b = 1 if shape == "retrieval_cand" else 64
        batch = data.batch(b, with_labels=False)
        if shape == "retrieval_cand":
            batch["candidates"] = np.random.default_rng(seed).standard_normal(
                (300, cfg.embed_dim)).astype(np.float32)
        return {f"batch/{k}": v for k, v in batch.items()}
    rng = np.random.default_rng(seed)
    if cell.step_kind == "prefill":
        return {"tokens": rng.integers(0, cfg.vocab, PREFILL)
                .astype(np.int32)}
    b, s, _ = DECODE
    from repro_torch.models import transformer as TF
    out = {f"cache/{'/'.join(path)}": rng.standard_normal(tuple(x.shape))
           .astype(np.float32)
           for path, x in flatten_with_path(TF.cache_specs(cfg, b, s))}
    out["token"] = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    return out


def _nested(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/"):
            node = tree
            parts = k[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    return tree


_REF = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch import steps as RS
from repro.models import layers as RL
from repro.models import transformer as RTF, gnn as RGNN, dlrm as RDLRM
from repro.optim import adamw as RA
from repro.parallel import sharding as RSH
from repro.launch.dryrun import collective_bytes_from_hlo

RL.set_dtypes(jnp.float32, jnp.float32)
cases, folder = json.loads(sys.argv[1]), sys.argv[2]
INIT = {"lm": RTF.init_params, "gnn": RGNN.init_params,
        "recsys": RDLRM.init_params}


def key(path):
    return "/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                    if hasattr(k, "idx") else "." + k.name for k in path)


def put(store, prefix, tree, mesh=None):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        k = prefix + "/" + key(path)
        store[k] = np.asarray(leaf)
        if mesh is None:
            continue
        for p, dev in enumerate(mesh.devices.flat):
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            store[f"{k}@{p}"] = np.asarray(shard.data)


def compiled(store, jitted, *args):
    # the jitted step compiled once, its HLO collectives kept, then run
    exe = jitted.lower(*args).compile()
    store["hlo_collectives"] = np.asarray(json.dumps(
        collective_bytes_from_hlo(exe.as_text())))
    return exe(*args)


def nested(npz, prefix):
    tree = {}
    for k in npz.files:
        if k.startswith(prefix + "/"):
            node = tree
            parts = k[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(npz[k])
    return tree


for c in cases:
    mesh = jax.make_mesh(tuple(c["dims"]), ("data", "model"))
    chunk = c["q_chunk"] if c["shape"] == "prefill_32k" else None
    cell = RS.build_cell(c["arch"], c["shape"], mesh, smoke=True,
                         cfg_transform=chunk and (
                             lambda cfg: dataclasses.replace(
                                 cfg, attn_q_chunk=chunk)))
    inp = np.load(f"{folder}/{c['name']}.in.npz")
    store = {}
    params = INIT[c["family"]](cell.cfg, jax.random.PRNGKey(c["seed"]))
    put(store, "params", params)
    if c["family"] == "gnn":
        batch = nested(inp, "batch")
        opt = RA.init(params)._replace(
            step=jnp.asarray(c["opt_step"], jnp.int32))
        fn = jax.jit(cell.fn, in_shardings=(
            cell.in_shardings[0], cell.in_shardings[1],
            RSH.gnn_batch_sharding(mesh, batch)),
            out_shardings=cell.out_shardings)
        p2, o2, m = compiled(store, fn, params, opt, batch)
        put(store, "out_params", p2)
        put(store, "out_m", o2.m)
        put(store, "out_v", o2.v)
        for k in ("loss", "grad_norm", "lr"):
            store[k] = np.asarray(m[k])
    elif c["family"] == "recsys":
        put(store, "out", compiled(store, cell.jit(), params,
                                   nested(inp, "batch")), mesh)
    elif cell.step_kind == "prefill":
        cache, logits = compiled(store, cell.jit(), params,
                                 jnp.asarray(inp["tokens"]))
        put(store, "cache", cache, mesh)
        put(store, "logits", {"x": logits}, mesh)
    else:
        logits, cache = compiled(store, cell.jit(), params,
                                 nested(inp, "cache"),
                                 jnp.asarray(inp["token"]),
                                 jnp.int32(c["pos"]))
        put(store, "cache", cache, mesh)
        put(store, "logits", {"x": logits}, mesh)
    np.savez(f"{folder}/{c['name']}.out.npz", **store)
print("REF-GRID-OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's inputs, and the reference's params and outputs from
    one subprocess at four forced host devices."""
    folder = tmp_path_factory.mktemp("grid")
    cases, inputs = [], {}
    for i, (arch, shape, dims) in enumerate(GNN_CASES + DLRM_CASES
                                            + LM_CASES):
        name = _name(arch, shape, dims)
        inputs[name] = _inputs(arch, shape, dims, seed=20 + i)
        np.savez(folder / f"{name}.in.npz", **inputs[name])
        cases.append(dict(name=name, arch=arch, shape=shape, dims=dims,
                          family=FAMILY[arch], seed=20 + i,
                          opt_step=OPT_STEP, pos=DECODE[2],
                          q_chunk=Q_CHUNK))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    # LLVM's optimisation passes cost most of the compile time of these
    # small programs and change no result beyond float32 rounding
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4"
                        + " --xla_backend_optimization_level=0")
    res = subprocess.run([sys.executable, "-c", _REF, json.dumps(cases),
                          str(folder)], capture_output=True, text=True,
                         env=env, timeout=900)
    assert res.returncode == 0 and "REF-GRID-OK" in res.stdout, \
        res.stderr[-3000:]
    return {c["name"]: (inputs[c["name"]], dict(np.load(
        folder / f"{c['name']}.out.npz"))) for c in cases}


def _np(x):
    return x.detach().float().numpy()


def _close_rel(got, want, scale, err=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=LM_SMOKE_REL,
                               atol=LM_SMOKE_REL * scale, err_msg=err)


def _equal_trees(a, b):
    for (pa, x), (pb, y) in zip(flatten_with_path(a), flatten_with_path(b)):
        assert pa == pb
        assert torch.equal(x, y), pa


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# ---------------------------------------------------------------------------
# GNN training
# ---------------------------------------------------------------------------

def _gnn_setup(ref, arch, shape, dims):
    inputs, out = ref[_name(arch, shape, dims)]
    cell = _grid_cell(arch, shape, dims)
    batch = {k: torch.from_numpy(v)
             for k, v in _nested(inputs, "batch").items()}
    cell = dataclasses.replace(cell, in_shardings=(
        cell.in_shardings[0], cell.in_shardings[1],
        SH.gnn_batch_sharding(cell.grid, batch)))
    params = params_from_reference(_nested(out, "params"))
    state = adamw.init(params)
    state.step.fill_(OPT_STEP)
    return cell, (params, state, batch), out


def _run_grid(cell, args):
    args = _clone(args)
    return spmd.gather_tree(cell.sharded()(*cell.place(args)))


def _assert_step(got, want_params, want_m, want_v, want_loss):
    params, state, metrics = got
    np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                               rtol=LOSS_RTOL)
    assert int(state.step) == OPT_STEP + 1
    for tree, want in ((params, want_params), (state.m, want_m),
                       (state.v, want_v)):
        flat = dict(flatten_with_path(tree))
        for path, w in flatten_with_path(want):
            np.testing.assert_allclose(_np(flat[path]), w,
                                       err_msg=str(path), **STEP_TOL)


@pytest.mark.parametrize("arch,shape,dims", GNN_CASES,
                         ids=[_name(*c) for c in GNN_CASES])
def test_gnn_grid_step_equals_reference_and_whole(ref, arch, shape, dims):
    cell, args, out = _gnn_setup(ref, arch, shape, dims)
    if dims == (1, 4):
        specs = [tuple(ns.spec) for ns in cell.in_shardings[2].values()]
        assert all(s == () for s in specs), specs   # nothing divides
    got = _run_grid(cell, args)
    _assert_step(got, _nested(out, "out_params"), _nested(out, "out_m"),
                 _nested(out, "out_v"), float(out["loss"]))
    whole = cell.fn(*_clone(args))
    _assert_step(got, tree_map(_np, whole[0]), tree_map(_np, whole[1].m),
                 tree_map(_np, whole[1].v), float(whole[2]["loss"]))
    again = _run_grid(cell, args)
    _equal_trees(got, again)


def test_gnn_grid_step_writes_in_place_and_counts(ref):
    cell, args, _ = _gnn_setup(ref, "graphcast", "molecule", (2, 2))
    placed = cell.place(_clone(args))
    first = placed[0]["proc"]["e_w0"].blocks[0]
    spmd.reset_ledger()
    out = cell.sharded()(*placed)
    assert out[0]["proc"]["e_w0"].blocks[0] is first       # donated
    assert all(len(v) == 4 for v in (out[2]["loss"].blocks,))
    led = spmd.ledger()
    # every layer all-gathers h and reduce-scatters its sum, and the
    # backward runs each dual once; the loss is all-reduced (and its
    # dual), and each param's gradient
    n_layers = cell.cfg.n_layers
    assert led["all-gather"]["count"] == 2 * n_layers
    assert led["reduce-scatter"]["count"] == 2 * n_layers
    assert led["all-reduce"]["count"] == 2 + len(leaves(args[0]))


# ---------------------------------------------------------------------------
# DLRM serving
# ---------------------------------------------------------------------------

def _dlrm_setup(ref, shape):
    inputs, out = ref[_name("dlrm-mlperf", shape, (2, 2))]
    cell = _grid_cell("dlrm-mlperf", shape, (2, 2))
    batch = {k: torch.from_numpy(v)
             for k, v in _nested(inputs, "batch").items()}
    return cell, (params_from_reference(_nested(out, "params")), batch), out


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_dlrm_grid_serving_equals_reference(ref, shape):
    cell, args, out = _dlrm_setup(ref, shape)
    got = cell.sharded()(*cell.place(args))
    whole = cell.fn(*args)
    if shape == "retrieval_cand":
        for i, g in enumerate(got):
            for p, blk in enumerate(g.blocks):
                want = out[f"out/{i}@{p}"]
                if i == 0:
                    np.testing.assert_allclose(_np(blk), want, **DLRM_TOL)
                else:
                    np.testing.assert_array_equal(blk.numpy(), want)
        np.testing.assert_array_equal(spmd.gather(got[1]).numpy(),
                                      whole[1].numpy())
        return
    for p, blk in enumerate(got.blocks):
        np.testing.assert_allclose(_np(blk), out[f"out/@{p}"], **DLRM_TOL)
    np.testing.assert_allclose(_np(spmd.gather(got)), _np(whole), **DLRM_TOL)
    again = cell.sharded()(*cell.place(args))
    assert torch.equal(spmd.gather(again), spmd.gather(got))


def test_dlrm_hot1_grid_lookups_equal_the_whole_lookups():
    cell = _grid_cell("dlrm-mlperf", "serve_p99", (2, 2))
    cfg = dataclasses.replace(cell.cfg, hot=1)
    params = DLRM.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    data = CriteoLikeGenerator(cfg.table_sizes, cfg.n_dense, 1, seed=4)
    sparse = torch.from_numpy(data.batch(64, with_labels=False)["sparse"])
    whole = DLRM.embedding_lookups(cfg, params, sparse)
    grid = cell.grid
    placed = spmd.place_tree(params, cell.in_shardings[0])
    split = [cell.in_shardings[0][f"table{t}"].spec[:1] == ("model",)
             for t in range(cfg.n_sparse)]
    assert any(split) and not all(split)
    rows = spmd.place(sparse, cell.in_shardings[1]["sparse"])
    got = spmd.lockstep(grid, [DLRM._grid_lookups(
        cfg, spmd.blocks_at(placed, p), split, rows.blocks[p], grid, p)
        for p in range(4)])
    for p, bags in enumerate(got):
        d = spmd.coord(grid, p, ("data",))
        for t, bag in enumerate(bags):
            assert torch.equal(bag, whole[t][d * 32:(d + 1) * 32]), (p, t)


# ---------------------------------------------------------------------------
# dense-LM serving
# ---------------------------------------------------------------------------

def _lm_args(ref, arch, shape, dims):
    inputs, out = ref[_name(arch, shape, dims)]
    cell = _grid_cell(arch, shape, dims)
    params = params_from_reference(_nested(out, "params"))
    if cell.step_kind == "prefill":
        return cell, (params, torch.from_numpy(inputs["tokens"])), out
    cache = cache_from_reference(_nested(inputs, "cache"))
    return cell, (params, cache, torch.from_numpy(inputs["token"]),
                  torch.tensor(DECODE[2], dtype=torch.int32)), out


def _blocks_close(got: spmd.Sharded, out, prefix, whole_want, err):
    scale = float(np.max(np.abs(whole_want)))
    for p, blk in enumerate(got.blocks):
        _close_rel(blk, out[f"{prefix}@{p}"], scale, f"{err} place {p}")


@pytest.mark.parametrize("arch,shape,dims", LM_CASES,
                         ids=[_name(*c) for c in LM_CASES])
def test_lm_grid_serving_equals_reference(ref, arch, shape, dims):
    cell, args, out = _lm_args(ref, arch, shape, dims)
    got = cell.sharded()(*cell.place(_clone(args)))
    whole = cell.fn(*_clone(args))
    if cell.step_kind == "prefill":
        cache, logits = got
        w_cache, w_logits = whole
    else:
        logits, cache = got
        w_logits, w_cache = whole
    _blocks_close(logits, out, "logits/x", out["logits/x"], "logits")
    for path, sh in flatten_with_path(cache, is_leaf=lambda x: isinstance(
            x, spmd.Sharded)):
        key = "cache/" + "/".join(path)
        _blocks_close(sh, out, key, out[key], key)
    # against the port's whole step
    _close_rel(spmd.gather(logits), _np(w_logits),
               float(w_logits.abs().max()), "whole logits")
    for (path, sh), w in zip(flatten_with_path(
            cache, is_leaf=lambda x: isinstance(x, spmd.Sharded)),
            leaves(w_cache)):
        _close_rel(spmd.gather(sh), _np(w), float(w.abs().max()),
                   "/".join(path))
    tokens = spmd.assemble(TFS.greedy(logits), cell.in_shardings[-1]
                           if cell.step_kind == "prefill" else
                           cell.in_shardings[2])
    assert torch.equal(spmd.gather(tokens)[:, 0], w_logits.argmax(-1))
    again = cell.sharded()(*cell.place(_clone(args)))
    _equal_trees(spmd.gather_tree(again), spmd.gather_tree(got))


def test_decode_writes_the_new_position_on_its_owner_only(ref):
    cell, args, _ = _lm_args(ref, "qwen2-7b", "decode_32k", (1, 4))
    placed = cell.place(_clone(args))
    before = [b.clone() for b in placed[1]["block0"]["k"].blocks]
    cell.sharded()(*placed)
    after = placed[1]["block0"]["k"].blocks
    blk = DECODE[1] // 4
    for p in range(4):
        changed = (after[p] != before[p]).any(-1).any(-1).any(0).any(0)
        want = torch.zeros(blk, dtype=torch.bool)
        if p == DECODE[2] // blk:
            want[DECODE[2] - p * blk] = True
        assert torch.equal(changed, want), p


def test_grid_prefill_into_a_longer_cache_then_decode():
    """The smoke's serving flow on a grid: a prompt of 30 tokens
    prefilled into a 36-position cache split over four places (the
    prompt ends inside the last block, whose tail stays zero), then three
    decode steps of the decode cell fed the whole model's greedy tokens;
    logits and caches against ``transformer.prefill(..., max_len)`` and
    ``decode_step``."""
    from repro_torch.models import transformer as TF
    pre = _grid_cell("qwen2-7b", "prefill_32k", (1, 4))
    dec = _grid_cell("qwen2-7b", "decode_32k", (1, 4))
    cfg = dec.cfg
    params = TF.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 30)).astype(np.int32))
    cache, last = TF.prefill(cfg, params, tok, max_len=36)
    p_sh = pre.place((params, tok))
    cache_sh = SH.lm_cache_sharding(dec.grid, TF.cache_specs(cfg, 2, 36))
    per_place = TFS.prefill(cfg, p_sh[0], p_sh[1], cache_sh, 36)
    cache_g = spmd.assemble([c for c, _ in per_place], cache_sh)
    logits_g = spmd.assemble([lg for _, lg in per_place],
                             pre.out_shardings[1])
    step = dec.sharded()
    for i in range(3):
        _close_rel(spmd.gather(logits_g), _np(last),
                   float(last.abs().max()), f"step {i}")
        for a, b in zip(leaves(spmd.gather_tree(cache_g)), leaves(cache)):
            _close_rel(a, _np(b), float(b.abs().max()), f"cache {i}")
        cur = last.argmax(-1).to(torch.int32)[:, None]
        last, cache = TF.decode_step(cfg, params, cache, cur, 30 + i)
        logits_g, cache_g = step(
            p_sh[0], cache_g, spmd.place(cur, dec.in_shardings[2]),
            spmd.place(torch.tensor(30 + i, dtype=torch.int32),
                       dec.in_shardings[3]))


def _port_ledger(ref, arch, shape, dims):
    if FAMILY[arch] == "gnn":
        cell, args, _ = _gnn_setup(ref, arch, shape, dims)
    elif FAMILY[arch] == "recsys":
        cell, args, _ = _dlrm_setup(ref, shape)
    else:
        cell, args, _ = _lm_args(ref, arch, shape, dims)
    placed = cell.place(_clone(args))
    spmd.reset_ledger()
    cell.sharded()(*placed)
    return spmd.ledger()


def test_collectives_beside_the_reference_hlo(ref):
    """The port's ledger of each (2, 2) case beside the collectives in the
    reference's compiled HLO of the same cell at the same shapes
    (``collective_bytes_from_hlo``: result bytes, where the ledger counts
    operand bytes; printed for ``PERF.md``). Where both take the same
    scheme the bytes agree exactly: DLRM serving all-reduces each split
    table's partial bags over ``model`` (XLA in one combined op). Each
    side moves something in every case."""
    rows = []
    for arch, shape, dims in GNN_CASES + DLRM_CASES + LM_CASES:
        if dims != (2, 2):
            continue
        _, out = ref[_name(arch, shape, dims)]
        hlo = json.loads(str(out["hlo_collectives"]))
        port = _port_ledger(ref, arch, shape, dims)
        assert hlo and port, (arch, shape, hlo, port)
        if shape in ("serve_p99", "serve_bulk"):
            # XLA's combiner fuses the tables' all-reduces into one op
            assert set(port) == set(hlo) == {"all-reduce"}
            assert port["all-reduce"]["bytes"] == \
                hlo["all-reduce"]["bytes"], (shape, port, hlo)
        rows.append((f"{arch}/{shape}", port, hlo))
    for name, port, hlo in rows:
        print(f"GRID-LEDGER {name} port={json.dumps(port, sort_keys=True)} "
              f"reference={json.dumps(hlo, sort_keys=True)}")


# ---------------------------------------------------------------------------
# grid records and the cells outside the slice
# ---------------------------------------------------------------------------

SLICE_CELLS = [(a, s) for a in ("gcn-cora", "gin-tu", "schnet", "graphcast")
               for s in ("full_graph_sm", "minibatch_lg", "ogb_products",
                         "molecule")] + \
    [("dlrm-mlperf", s) for s in ("serve_p99", "serve_bulk",
                                  "retrieval_cand")] + \
    [(a, s) for a in ("qwen2-7b", "yi-6b", "qwen1.5-32b")
     for s in ("prefill_32k", "decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape", SLICE_CELLS)
def test_grid_record_carries_collectives(arch, shape, tmp_path):
    rec = D.run_cell(arch, shape, "single", tmp_path)
    assert rec["ok"], rec.get("traceback")
    coll = rec["collectives"]
    assert coll and set(coll) <= set(spmd.OPCODES)
    assert all(v["count"] > 0 and v["bytes"] > 0 for v in coll.values())
    assert rec["collective_bytes_per_device"] == sum(
        v["bytes"] for v in coll.values())
    assert rec["wall_s"] < 10


@pytest.mark.parametrize("grid", ["single", "multi"])
def test_dlrm_serve_collectives_are_the_closed_form(grid, tmp_path):
    """serve_p99 (B = 512): each table split over ``model`` all-reduces
    its (B / dp, 128) float32 bags once."""
    rec = D.run_cell("dlrm-mlperf", "serve_p99", grid, tmp_path)
    dp = 16 if grid == "single" else 32
    assert rec["collectives"] == {"all-reduce": {
        "count": 26, "bytes": 26 * (512 // dp) * 128 * 4}}


def _graphcast_closed_form(shape, places, smoke, dims=None):
    """graphcast's collectives a step on a grid of ``places``: a layer
    all-gathers h (its node rows) and reduce-scatters its sum (the whole
    table); the backward runs each dual once; the loss and its dual, and
    each param's gradient, all-reduce (float32)."""
    from repro_torch.configs import config_for_shape, input_specs
    from repro_torch.models import gnn as GNN
    cfg = config_for_shape("graphcast", shape, smoke=smoke)
    _, specs = input_specs("graphcast", shape, smoke=smoke, cfg=cfg,
                           dims=dims)
    n, h, nl = specs["node_feat"].shape[0], cfg.d_hidden, cfg.n_layers
    params = leaves(GNN.param_specs(cfg))
    return {
        "all-gather": {"count": 2 * nl,
                       "bytes": 2 * nl * (n // places) * h * 4},
        "reduce-scatter": {"count": 2 * nl, "bytes": 2 * nl * n * h * 4},
        "all-reduce": {"count": 2 + len(params), "bytes": 16 + sum(
            p.numel() * 4 for p in params)}}


def test_graphcast_collectives_are_the_closed_form(tmp_path):
    """graphcast ogb_products on the 256-place grid."""
    rec = D.run_cell("graphcast", "ogb_products", "single", tmp_path)
    assert rec["collectives"] == _graphcast_closed_form("ogb_products", 256,
                                                         False)


def test_card_record_on_a_cpu_grid(tmp_path):
    """graphcast molecule (smoke, cut to 4 graphs: 512 nodes and edges
    padded) on a (2, 2) grid of the CPU: the record's ledger of one step
    is the closed form on four places."""
    dims = {"batch": 4}
    rec = D.run_cell("graphcast", "molecule", "card", tmp_path, smoke=True,
                     torch_device="cpu", grid=(2, 2), dims=dims)
    assert rec["ok"] and rec["ran"], rec
    assert rec["n_places"] == 4 and rec["n_chips"] == 1
    assert rec["devices"] == ["cpu"] * 4 and rec["finite"]
    assert rec["collectives"] == _graphcast_closed_form("molecule", 4, True,
                                                         dims)
    assert "probes" not in rec
    assert (tmp_path / "graphcast__molecule__card__smoke__grid2x2.json"
            ).exists()


def test_dryrun_cli_runs_a_cell_on_a_cpu_grid(tmp_path):
    assert D.main(["--arch", "dlrm-mlperf", "--shape", "serve_p99",
                   "--mesh", "card", "--smoke", "--torch-device", "cpu",
                   "--grid", "1x4", "--devices", "cpu,cpu,cpu,cpu",
                   "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dlrm-mlperf__serve_p99__card__smoke"
                      "__grid1x4.json").read_text())
    assert rec["ran"] and rec["collectives"]["all-reduce"]["count"] > 0


@pytest.mark.parametrize("arch,shape", [("deepseek-v2-236b", "train_4k"),
                                        ("deepseek-v2-236b", "decode_32k"),
                                        ("llama4-maverick-400b-a17b", "prefill_32k"),
                                        ("dlrm-mlperf", "train_batch")])
def test_cells_outside_the_slice_raise(arch, shape, tmp_path):
    cell = _grid_cell(arch, shape, (2, 2))
    with pytest.raises(ValueError, match="ROADMAP"):
        cell.sharded()
    rec = D.run_cell(arch, shape, "single", tmp_path)
    assert rec["ok"] and "collectives" not in rec
