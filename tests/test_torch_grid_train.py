"""repro_torch's dense-LM training split over a named device grid, against
the reference's ``train_4k`` cell under ``jax.jit`` on a mesh of the same
shape.

The reference runs in one subprocess with four forced host devices
(``--xla_force_host_platform_device_count=4``), on ``jax.make_mesh`` of
(2, 2) and (1, 4) ``("data", "model")``; the port runs
``Cell.sharded()`` on ``make_grid(dims, ["cpu"] * 4)``. The cells are
the smoke configs' ``train_4k`` with the batch cut to 4 x 32 tokens
(``dims``; the reference's cell takes the batch's shape from its
arguments under the same in-shardings), made with numpy from fixed seeds;
the reference's params are carried across by ``convert``; AdamW starts at
step ``OPT_STEP``. Float32 on both sides. The tolerances are
``tests/test_torch_grid_cells.py``'s: the loss within rtol ``LOSS_RTOL``,
params and moments after a step within ``STEP_TOL``, block for block,
and the gradient norm within ``NORM_RTOL``. ``STEP_TOL`` is about the
size of one update at step 51 (lr 1.53e-4 times ~0.43), so each leaf's
update (params after less before) is also held within ``UPDATE_REL_L2``
relative L2 and each moment within ``MOMENT_REL_L2``: a block left
un-updated, or updated twice, reads ~1 on both.

  * qwen2-7b, yi-6b and qwen1.5-32b on (2, 2), and qwen2-7b on (1, 4),
    where a key head's columns split in halves: against the reference's
    step at every place, against the port's whole ``cell.fn``, and
    repeated bit for bit.
  * remat ``"none"``, ``"layer"`` and ``"dots"`` give the same bits on
    the grid, and the recomputed layers' collectives are counted.
  * ``fetch``'s gradient equals its plain loop (each received piece's
    gradient added into its holder's zeros, receivers in grid order) bit
    for bit.
  * Arguments made on their places: the first device holds one whole
    leaf at a time, and the blocks have the whole init's bits.
  * The collectives: qwen2-7b's FSDP all-gathers and reduce-scatters at
    full width on (2, 2) equal their closed form; the train records of the
    production grids carry collectives (MLA and MoE cells raise); the
    ledger beside the reference's HLO collectives.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_reference
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_grid
from repro_torch.models import layers as L
from repro_torch.models import transformer_sharded as TFS
from repro_torch.optim import adamw
from repro_torch.parallel import spmd
from repro_torch.pytree import flatten_with_path, leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_RTOL = 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
NORM_RTOL = 1e-5
# AdamW's first update from zero moments is nearly the gradient's sign, so
# a component whose gradient is at rounding size flips: the port's whole
# step reads up to 3.4e-4 from the reference's, the moments 1.5e-6
UPDATE_REL_L2 = 2e-3
MOMENT_REL_L2 = 1e-5
OPT_STEP = 50
DIMS = dict(batch=4, seq=32)
CASES = [("qwen2-7b", (2, 2)), ("yi-6b", (2, 2)), ("qwen1.5-32b", (2, 2)),
         ("qwen2-7b", (1, 4))]


def _name(arch, dims):
    return f"{arch}__{dims[0]}x{dims[1]}"


@pytest.fixture(autouse=True)
def f32():
    saved = L.PDTYPE, L.ADTYPE
    L.set_dtypes(torch.float32, torch.float32)
    try:
        yield
    finally:
        L.set_dtypes(*saved)


def _cell(arch, dims, remat=None):
    tf = None if remat is None else \
        (lambda c: dataclasses.replace(c, remat=remat))
    return steps.build_cell(arch, "train_4k", make_grid(dims, ["cpu"] * 4),
                            smoke=True, dims=DIMS, cfg_transform=tf)


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    shape = (DIMS["batch"], DIMS["seq"])
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "targets": rng.integers(0, vocab, shape).astype(np.int32)}


_REF = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch import steps as RS
from repro.models import layers as RL
from repro.models import transformer as RTF
from repro.optim import adamw as RA
from repro.launch.dryrun import collective_bytes_from_hlo

RL.set_dtypes(jnp.float32, jnp.float32)
cases, folder = json.loads(sys.argv[1]), sys.argv[2]


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


for c in cases:
    mesh = jax.make_mesh(tuple(c["dims"]), ("data", "model"))
    cell = RS.build_cell(c["arch"], "train_4k", mesh, smoke=True)
    inp = np.load(f"{folder}/{c['name']}.in.npz")
    store = {}
    params = RTF.init_params(cell.cfg, jax.random.PRNGKey(c["seed"]))
    put(store, "params", params)
    opt = RA.init(params)._replace(step=jnp.asarray(c["opt_step"],
                                                    jnp.int32))
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "targets")}
    # the cell's in-shardings hold for the cut batch: dp divides 4
    exe = cell.jit().lower(params, opt, batch).compile()
    store["hlo_collectives"] = np.asarray(json.dumps(
        collective_bytes_from_hlo(exe.as_text())))
    p2, o2, m = exe(params, opt, batch)
    put(store, "out_params", p2, mesh)
    put(store, "out_m", o2.m, mesh)
    put(store, "out_v", o2.v, mesh)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        store[k] = np.asarray(m[k])
    np.savez(f"{folder}/{c['name']}.out.npz", **store)
print("REF-GRID-TRAIN-OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case's batch, and the reference's params and outputs from one
    subprocess at four forced host devices."""
    folder = tmp_path_factory.mktemp("grid_train")
    cases, inputs = [], {}
    for i, (arch, dims) in enumerate(CASES):
        name = _name(arch, dims)
        inputs[name] = _batch(_cell(arch, dims).cfg.vocab, seed=40 + i)
        np.savez(folder / f"{name}.in.npz", **inputs[name])
        cases.append(dict(name=name, arch=arch, dims=dims, seed=40 + i,
                          opt_step=OPT_STEP))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4"
                        + " --xla_backend_optimization_level=0")
    res = subprocess.run([sys.executable, "-c", _REF, json.dumps(cases),
                          str(folder)], capture_output=True, text=True,
                         env=env, timeout=900)
    assert res.returncode == 0 and "REF-GRID-TRAIN-OK" in res.stdout, \
        res.stderr[-3000:]
    return {c["name"]: (inputs[c["name"]], dict(np.load(
        folder / f"{c['name']}.out.npz"))) for c in cases}


def _nested(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        if k.startswith(prefix + "/") and "@" not in k:
            node = tree
            parts = k[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    return tree


def _np(x):
    return x.detach().float().numpy()


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _args(ref, arch, dims, remat=None):
    inputs, out = ref[_name(arch, dims)]
    cell = _cell(arch, dims, remat)
    params = params_from_reference(_nested(out, "params"))
    state = adamw.init(params)
    state.step.fill_(OPT_STEP)
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    return cell, (params, state, batch), out


def _run_grid(cell, args):
    return cell.sharded()(*cell.place(_clone(args)))


def _is_sharded(x):
    return isinstance(x, spmd.Sharded)


def _rel_l2(got, want):
    return float(np.linalg.norm((got - want).ravel())
                 / np.linalg.norm(want.ravel()))


def _check_updates(before, got, want, err):
    """Each leaf's update and moments of ``got`` (params, state) against
    ``want`` (dicts of whole numpy arrays by prefix and key), by relative
    L2 a leaf."""
    for prefix, tree, bound in (("out_params", got[0], UPDATE_REL_L2),
                                ("out_m", got[1].m, MOMENT_REL_L2),
                                ("out_v", got[1].v, MOMENT_REL_L2)):
        for path, t in flatten_with_path(tree):
            key = "/".join(path)
            a, b = _np(t), want[prefix + "/" + key]
            if prefix == "out_params":
                a, b = a - before[key], b - before[key]
            assert _rel_l2(a, b) <= bound, (err, prefix, key, _rel_l2(a, b))


@pytest.mark.parametrize("arch,dims", CASES, ids=[_name(*c) for c in CASES])
def test_grid_train_step_equals_reference_and_whole(ref, arch, dims):
    cell, args, out = _args(ref, arch, dims)
    got = _run_grid(cell, args)
    params, state, metrics = got
    # against the reference's step, block for block
    np.testing.assert_allclose(_np(metrics["loss"].blocks[0]),
                               float(out["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(metrics["grad_norm"].blocks[0]),
                               float(out["grad_norm"]), rtol=NORM_RTOL)
    assert float(metrics["aux"].blocks[0]) == float(out["aux"]) == 0.0
    for name in ("loss", "nll", "grad_norm", "lr"):
        first = metrics[name].blocks[0]
        assert all(torch.equal(b, first) for b in metrics[name].blocks)
    np.testing.assert_allclose(_np(metrics["lr"].blocks[0]),
                               float(out["lr"]), rtol=1e-6)
    for prefix, tree in (("out_params", params), ("out_m", state.m),
                         ("out_v", state.v)):
        for path, sh in flatten_with_path(tree, is_leaf=_is_sharded):
            key = prefix + "/" + "/".join(path)
            for p, blk in enumerate(sh.blocks):
                np.testing.assert_allclose(_np(blk), out[f"{key}@{p}"],
                                           err_msg=f"{key}@{p}", **STEP_TOL)
    assert all(int(b) == OPT_STEP + 1 for b in state.step.blocks)
    # against the port's whole step
    whole = cell.fn(*_clone(args))
    gathered = spmd.gather_tree(got)
    np.testing.assert_allclose(_np(gathered[2]["loss"]),
                               float(whole[2]["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(gathered[2]["grad_norm"]),
                               float(whole[2]["grad_norm"]), rtol=NORM_RTOL)
    for (path, a), (_, b) in zip(flatten_with_path(gathered[:2]),
                                 flatten_with_path(whole[:2])):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=str(path),
                                   **STEP_TOL)
    # each leaf's update and moments, against the reference's and the
    # whole step's
    before = {"/".join(p): _np(t) for p, t in flatten_with_path(args[0])}
    _check_updates(before, gathered, out, "reference")
    _check_updates(before, gathered, {
        prefix + "/" + "/".join(p): _np(t)
        for prefix, tree in (("out_params", whole[0]), ("out_m", whole[1].m),
                             ("out_v", whole[1].v))
        for p, t in flatten_with_path(tree)}, "whole")
    # repeated, bit for bit
    again = spmd.gather_tree(_run_grid(cell, args))
    for (path, a), (_, b) in zip(flatten_with_path(again),
                                 flatten_with_path(gathered)):
        assert torch.equal(a, b), path


def test_grid_train_step_writes_in_place(ref):
    cell, args, _ = _args(ref, "qwen2-7b", (2, 2))
    placed = cell.place(_clone(args))
    first = placed[0]["block0"]["ffn"]["wi"].blocks[0]
    moment = placed[1].m["embed"].blocks[3]
    before = first.clone()
    out = cell.sharded()(*placed)
    assert out[0]["block0"]["ffn"]["wi"].blocks[0] is first       # donated
    assert out[1].m["embed"].blocks[3] is moment
    assert not torch.equal(first, before)


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)])
def test_remat_settings_give_the_same_bits_on_the_grid(ref, dims):
    """remat none / layer / dots: the loss and every gradient block equal
    bit for bit; "layer" and "dots" recompute each grid layer's
    collectives in the backward, and the ledger counts them."""
    runs, ledgers = {}, {}
    for remat in ("none", "layer", "dots"):
        cell, args, _ = _args(ref, "qwen2-7b", dims, remat)
        placed = cell.place(_clone(args))
        spmd.reset_ledger()
        losses, grads, norms = TFS.loss_and_grad(cell.cfg, placed[0],
                                                 placed[2])
        ledgers[remat] = spmd.ledger()
        runs[remat] = [losses[0], norms[0]] + [
            b for sh in leaves(grads, is_leaf=_is_sharded)
            for b in sh.blocks]
    for remat in ("layer", "dots"):
        assert len(runs[remat]) == len(runs["none"])
        for a, b in zip(runs[remat], runs["none"]):
            assert torch.equal(a, b), remat
    n_layers = _cell("qwen2-7b", dims).cfg.n_layers
    weights = 6 if dims[0] > 1 else 0   # a layer's FSDP all-gathers
    for remat in ("layer", "dots"):
        assert ledgers[remat]["reduce-scatter"] == \
            ledgers["none"]["reduce-scatter"]
        extra = ledgers[remat]["all-gather"]["count"] \
            - ledgers["none"]["all-gather"]["count"]
        assert extra >= weights * n_layers and extra > 0, ledgers
        assert ledgers[remat]["collective-permute"]["count"] == \
            ledgers["none"]["collective-permute"]["count"] + n_layers


# ---------------------------------------------------------------------------
# fetch's gradient
# ---------------------------------------------------------------------------

def _fetch_transpose_loop(cots, xs, g, axes, dim, block, want):
    """The plain loop: zeros of each input; for each group, each receiver
    in grid order, each piece: the piece's cotangent added at its offset
    in its holder's block, in float32, rounded once."""
    outs = [torch.zeros(x.shape, dtype=torch.float32) for x in xs]
    for members in spmd.groups(g, axes):
        for m in members:
            at = 0
            for a, b in want[m]:
                while a < b:
                    c = a // block
                    hi = min(b, (c + 1) * block)
                    piece = cots[m].narrow(dim, at, hi - a).float()
                    outs[members[c]].narrow(dim, a - c * block,
                                            hi - a).add_(piece)
                    at += hi - a
                    a = hi
    return [o.to(x.dtype) for o, x in zip(outs, xs)]


@pytest.mark.parametrize("dims", [(2, 2), (1, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fetch_gradient_is_its_plain_loop(dims, dtype):
    """Each place pulls ranges that overlap other places' (so a holder
    adds several receivers' pieces), across block edges; the backward
    equals the loop bit for bit, and is counted as one more
    collective-permute of the bytes place 0 receives."""
    g = make_grid(dims, ["cpu"] * 4)
    k = spmd.axis_size(g, "model")
    block = 6
    gen = torch.Generator().manual_seed(11)
    xs = [torch.randn(3, block, generator=gen).to(dtype).requires_grad_()
          for _ in range(4)]
    want = []
    for p in range(4):
        c = spmd.coord(g, p, "model")
        nb = (c + 1) % k
        want.append([(nb * block + 1, nb * block + 5),
                     (c * block + 3, min(k * block, c * block + 9)),
                     (0, 2)])
    spmd.reset_ledger()
    outs = spmd.fetch(xs, g, "model", 1, block, want)
    fwd = spmd.ledger()
    cots = [torch.randn(o.shape, generator=gen).to(dtype) for o in outs]
    torch.autograd.backward(outs, cots)
    want_grads = _fetch_transpose_loop(cots, xs, g, "model", 1, block, want)
    for x, w in zip(xs, want_grads):
        assert x.grad.dtype == dtype
        assert torch.equal(x.grad, w)
    led = spmd.ledger()
    if k == 1:
        assert led == {}
        return
    recv0 = 0
    for members in spmd.groups(g, "model"):
        for m in members:
            if m == 0:
                continue
            for a, b in want[m]:
                while a < b:
                    c = a // block
                    hi = min(b, (c + 1) * block)
                    if members[c] == 0:
                        recv0 += 3 * (hi - a) * xs[0].element_size()
                    a = hi
    assert led["collective-permute"] == {
        "count": 2, "bytes": fwd["collective-permute"]["bytes"] + recv0}


def test_fetch_forward_is_unchanged_under_autograd():
    """The same pieces with and without autograd recording."""
    g = make_grid((2, 2), ["cpu"] * 4)
    gen = torch.Generator().manual_seed(12)
    xs = [torch.randn(2, 8, generator=gen) for _ in range(4)]
    want = [[(0, 3), (10, 16)]] * 4
    with torch.no_grad():
        plain = spmd.fetch(xs, g, "model", 1, 8, want)
    live = spmd.fetch([x.clone().requires_grad_() for x in xs], g, "model",
                      1, 8, want)
    for a, b in zip(plain, live):
        assert torch.equal(a, b.detach())


# ---------------------------------------------------------------------------
# arguments made on their places
# ---------------------------------------------------------------------------

def test_placed_arguments_hold_one_leaf_at_a_time(monkeypatch):
    """``make_placed_args`` draws the params leaf by leaf and frees each
    before the next (every earlier leaf is dead when one is drawn, and no
    block is a view of a whole leaf), the moments are zeros on their
    places, and everything has the whole arguments' bits."""
    cell = _cell("qwen2-7b", (2, 2))
    drawn, alive_at_draw = [], []
    real = L.iter_materialize

    def watched(shapes, gen, dev):
        for path, t in real(shapes, gen, dev):
            gc.collect()
            alive_at_draw.append(sum(r() is not None for r in drawn))
            drawn.append(weakref.ref(t))
            yield path, t
            del t

    monkeypatch.setattr(L, "iter_materialize", watched)
    placed = D.make_placed_args(cell, seed=7)
    gc.collect()
    assert len(drawn) == len(leaves(cell.arg_specs[0]))
    assert alive_at_draw == [0] * len(drawn), alive_at_draw
    assert all(r() is None for r in drawn)
    whole = D.make_args(cell, torch.device("cpu"), seed=7)
    for (path, a), (_, b) in zip(flatten_with_path(spmd.gather_tree(placed)),
                                 flatten_with_path(whole)):
        assert torch.equal(a, b), path
    for sh in leaves(placed[1], is_leaf=_is_sharded):
        assert all(not b.any() for b in sh.blocks)
    # replicated blocks shared by the places of one device
    norm = placed[0]["final_norm"].blocks
    assert all(b is norm[0] for b in norm)


def test_placed_arguments_on_an_abstract_stand_in():
    """An abstract (2, 2) grid's specs reckon a place's share of qwen2-7b's
    arguments (bfloat16 params and float32 moments, 10 B a param) at about
    a quarter, where the whole, with the gradients' 2 B a param more, does
    not fit one card."""
    from repro_torch.configs import config_for_shape
    cfg = config_for_shape("qwen2-7b", "train_4k")
    L.set_dtypes(torch.bfloat16, torch.bfloat16)      # the fixture restores
    cell = steps.build_cell("qwen2-7b", "train_4k", make_grid((2, 2)))
    n = cfg.params_count()
    per_place = D.argument_bytes(cell, per_device=True)
    assert n * 12 > 80e9
    assert n * 10 <= 4 * per_place < n * 10 + 1e9


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _fsdp_closed_form(cfg, b, s):
    """qwen2-7b's all-gathers and reduce-scatters a step on an abstract
    (2, 2) grid under remat "layer": each layer's six weight matrices
    all-gathered over ``data`` from a quarter of the layer's matrix params
    a place, in the forward and again in the recompute, and their
    gradients (the gathered halves) reduce-scattered once; the embedding
    and ``lm_head`` blocks likewise once; the loss's (max, sum) rows
    all-gathered over ``model`` and their dual."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    q, kv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    layer = d * q + 2 * d * kv + q * d + d * 2 * f + f * d
    blk = layer // 4 * 2                      # bfloat16
    emb = v * d // 4 * 2
    n = b // 2 * s                            # a place's tokens
    nl = cfg.n_layers
    return {"all-gather": {"count": 12 * nl + 3,
                           "bytes": 2 * nl * blk + 2 * emb + 8 * n},
            "reduce-scatter": {"count": 6 * nl + 3,
                               "bytes": nl * 2 * blk + 2 * 2 * emb
                               + 2 * 8 * n}}


def test_qwen2_fsdp_collectives_are_the_closed_form():
    """qwen2-7b's full CONFIG at 2 layers on an abstract (2, 2) grid,
    B = 256 x 4,096 on ``meta`` blocks, bfloat16: 233.0 M matrix params a
    layer, 116.5 MB a place a layer all-gathered twice (forward and
    recompute) and reduce-scattered once; at 28 layers 6.52 GB each a
    step a device."""
    saved = L.PDTYPE, L.ADTYPE
    L.set_dtypes(torch.bfloat16, torch.bfloat16)
    try:
        cell = steps.build_cell(
            "qwen2-7b", "train_4k", make_grid((2, 2)),
            cfg_transform=lambda c: dataclasses.replace(c, n_layers=2))
        led = D.grid_collectives(cell)
    finally:
        L.set_dtypes(*saved)
    cfg = cell.cfg
    want = _fsdp_closed_form(cfg, 256, 4096)
    assert {k: led[k] for k in want} == want
    layer_blk = (want["all-gather"]["bytes"]
                 - _fsdp_closed_form(dataclasses.replace(
                     cfg, n_layers=0), 256, 4096)["all-gather"]["bytes"]) // 4
    assert layer_blk == 116_523_008
    assert 2 * 28 * layer_blk == 6_525_288_448


DENSE = ("qwen2-7b", "yi-6b", "qwen1.5-32b")


@pytest.mark.parametrize("arch", DENSE)
def test_train_records_carry_collectives(arch, tmp_path):
    rec = D.run_cell(arch, "train_4k", "single", tmp_path)
    assert rec["ok"], rec.get("traceback")
    coll = rec["collectives"]
    assert set(coll) == {"all-gather", "reduce-scatter", "all-reduce",
                         "collective-permute"}
    assert all(v["count"] > 0 and v["bytes"] > 0 for v in coll.values())
    assert rec["collective_bytes_per_device"] == sum(
        v["bytes"] for v in coll.values())
    assert rec["wall_s"] < 10


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_mla_and_moe_train_cells_still_raise(arch, tmp_path):
    cell = steps.build_cell(arch, "train_4k", make_grid((2, 2), ["cpu"] * 4),
                            smoke=True)
    with pytest.raises(ValueError, match="ROADMAP §1 item 3"):
        cell.sharded()
    rec = D.run_cell(arch, "train_4k", "single", tmp_path)
    assert rec["ok"] and "collectives" not in rec


def test_card_record_of_a_train_cell_on_a_cpu_grid(tmp_path):
    """``run_cell(..., "card", grid=(2, 2))`` of qwen2-7b train_4k (smoke,
    4 x 32): the arguments made on their places, the ledger of one step,
    a finite loss."""
    rec = D.run_cell("qwen2-7b", "train_4k", "card", tmp_path, smoke=True,
                     torch_device="cpu", grid=(2, 2), dims=DIMS)
    assert rec["ok"] and rec["ran"] and rec["finite"], rec
    assert rec["n_places"] == 4 and rec["n_chips"] == 1
    assert set(rec["collectives"]) == {"all-gather", "reduce-scatter",
                                       "all-reduce", "collective-permute"}
    assert np.isfinite(rec["loss"])
    assert rec["argument_bytes_on_a_card"] >= rec["argument_size_in_bytes"]


def test_collectives_beside_the_reference_hlo(ref):
    """The port's ledger of qwen2-7b's train step (smoke, (2, 2), 4 x 32)
    beside the collectives in the reference's compiled HLO of the same
    cell at the same shapes (printed for ``PERF.md``): both all-gather,
    reduce-scatter or all-reduce, and move something."""
    cell, args, out = _args(ref, "qwen2-7b", (2, 2))
    hlo = json.loads(str(out["hlo_collectives"]))
    placed = cell.place(_clone(args))
    spmd.reset_ledger()
    cell.sharded()(*placed)
    port = spmd.ledger()
    assert hlo and port
    assert {"all-gather", "reduce-scatter"} <= set(port)
    print(f"GRID-LEDGER qwen2-7b/train_4k "
          f"port={json.dumps(port, sort_keys=True)} "
          f"reference={json.dumps(hlo, sort_keys=True)}")
