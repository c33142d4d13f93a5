"""repro_torch's GNN family against the reference's, on the CPU.

The port's ``models.gnn`` runs the reference's materialized params, carried
across bit for bit by ``convert.params_from_reference``, on batches
made with numpy from fixed seeds. Tolerances (float32; the same products
and sums, taken in other orders):
  * outputs within rtol 1e-5 and atol 1e-5;
  * the loss and every gradient within rtol 1e-4 and atol 1e-5;
  * three AdamW steps of the ``GNN`` module against the reference's step
    (``jax.value_and_grad`` + ``adamw.apply``, lr 1e-2): losses within
    rtol 1e-4, params within rtol 1e-4 and atol 1e-4 (1 % of one step:
    AdamW divides each gradient element by its root second moment, so an
    element near zero whose last bits differ between the two sums moves
    its param by a visibly different share of lr);
  * the train CLI's losses against the reference CLI's within rtol 1e-4.
The message-passing Functions (``segment_sum``, ``gather``) are held to
``jax.ops.segment_sum`` and ``jax.vjp`` of a gather within atol 1e-6, and
their two routes (the kernel's wrapper, which on CPU tensors runs the plain
version, and ``use_kernels=False``) to each other bit for bit, with and
without a given ``order``. On the card the kernel is held to the plain
version bit for bit by ``chip_smoke.py``.

Also: graphcast's full ``CONFIG`` forward on a small multimesh (within
rtol 1e-5 of the outputs' largest magnitude), ``param_shapes`` at every
full ``CONFIG``, ``materialize``'s draw
order (flat and nested), a checkpoint round trip of nested params and
optimizer state, and the card as every entry point's default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs import get_arch as ref_get_arch
from repro.models import gnn as RM
from repro.optim import adamw as RA
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference)
from repro_torch.models import gnn as M
from repro_torch.models import layers as L
from repro_torch.optim import adamw as A
from repro_torch.pytree import flatten_with_path, leaves, tree_map

GNN_ARCHS = ["gcn-cora", "gin-tu", "graphcast", "schnet"]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(lr=1e-2, warmup_steps=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref(batch):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _batch(d_in, n=48, e=160, with_labels=True, seed=0):
    """The reference's ``TestGNNSmoke._batch``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {
        "node_feat": rng.standard_normal((n, d_in)).astype(np.float32),
        "edge_src": rng.integers(0, n, e).astype(np.int32),
        "edge_dst": rng.integers(0, n, e).astype(np.int32),
        "edge_mask": np.ones(e, np.float32),
        "node_mask": np.ones(n, np.float32),
    }
    if with_labels:
        batch["labels"] = rng.integers(0, 3, n).astype(np.int32)
        batch["label_mask"] = np.ones(n, np.float32)
    else:
        batch["pos"] = rng.standard_normal((n, 3)).astype(np.float32)
        batch["graph_id"] = np.zeros(n, np.int32)
        batch["targets"] = rng.standard_normal((n, 1)).astype(np.float32)
    return batch


def _configs(arch, **kw):
    """The reference's and the port's smoke config of ``arch``, replaced
    by ``kw``."""
    return (dataclasses.replace(ref_get_arch(arch).smoke_config, **kw),
            dataclasses.replace(get_arch(arch).smoke_config, **kw))


def _params(ref_cfg, seed=0):
    rp = RM.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return rp, params_from_reference(_np(rp))


def assert_trees_close(got, want, **tol):
    got = flatten_with_path(got)
    want = flatten_with_path(_np(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=str(path),
                                   **tol)


def assert_matches_reference(ref_cfg, cfg, rp, pp, batch):
    """Forward, loss and every gradient of the port against the
    reference's on ``batch``."""
    rb = _ref(batch)
    np.testing.assert_allclose(M.forward(cfg, pp, batch).detach().numpy(),
                               np.asarray(RM.forward(ref_cfg, rp, rb)),
                               **FWD_TOL)
    r_loss, r_grads = jax.value_and_grad(
        lambda p: RM.loss_fn(ref_cfg, p, rb)[0])(rp)
    loss, _, grads = L.value_and_grad(lambda p: M.loss_fn(cfg, p, batch),
                                      pp)
    np.testing.assert_allclose(float(loss), float(r_loss), **GRAD_TOL)
    assert_trees_close(grads, r_grads, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the reference's TestGNNSmoke, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GNN_ARCHS)
class TestGNNSmoke:
    def test_classification_step(self, arch):
        ref_cfg, cfg = _configs(arch, d_in=12, d_out=3)
        rp, pp = _params(ref_cfg)
        batch = _batch(12)
        out = M.forward(cfg, pp, batch)
        assert out.shape == (48, 3)
        assert_matches_reference(ref_cfg, cfg, rp, pp, batch)

    def test_regression_step(self, arch):
        ref_cfg, cfg = _configs(arch, d_in=12, d_out=1)
        rp, pp = _params(ref_cfg)
        batch = _batch(12, with_labels=False)
        loss, _ = M.loss_fn(cfg, pp, batch)
        assert np.isfinite(float(loss))
        assert_matches_reference(ref_cfg, cfg, rp, pp, batch)

    def test_edge_mask_zeroes_messages(self, arch):
        """Masked edges must not affect outputs (padding correctness)."""
        ref_cfg, cfg = _configs(arch, d_in=6, d_out=2)
        rp, pp = _params(ref_cfg)
        b1 = _batch(6, n=32, e=64, seed=3)
        b2 = dict(b1)
        rng = np.random.default_rng(9)
        extra = 32
        b2["edge_src"] = np.concatenate(
            [b1["edge_src"], rng.integers(0, 32, extra).astype(np.int32)])
        b2["edge_dst"] = np.concatenate(
            [b1["edge_dst"], rng.integers(0, 32, extra).astype(np.int32)])
        b2["edge_mask"] = np.concatenate(
            [b1["edge_mask"], np.zeros(extra, np.float32)])
        o1 = M.forward(cfg, pp, b1).numpy()
        o2 = M.forward(cfg, pp, b2).numpy()
        np.testing.assert_allclose(o1, o2, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            o2, np.asarray(RM.forward(ref_cfg, rp, _ref(b2))), **FWD_TOL)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_param_shapes_equal_reference_at_full_config(arch):
    cfg, ref_cfg = get_arch(arch).config, ref_get_arch(arch).config
    is_leaf = lambda x: isinstance(x, tuple) and len(x) == 2 \
        and isinstance(x[0], tuple)
    got = flatten_with_path(M.param_shapes(cfg), is_leaf=is_leaf)
    want = flatten_with_path(RM.param_shapes(ref_cfg), is_leaf=is_leaf)
    assert [(p, s, str(d).replace("torch.", "")) for p, (s, d) in got] == \
        [(p, s, jnp.dtype(d).name) for p, (s, d) in want]
    specs = M.param_specs(cfg)
    assert all(t.device.type == "meta" for t in leaves(specs))
    assert [tuple(t.shape) for t in leaves(specs)] == [s for _, (s, _) in got]


def test_graphcast_full_config_forward_on_a_small_multimesh():
    """graphcast's full ``CONFIG`` (16 layers, 512 wide, 227 variables) on
    the refinement-1 multimesh: the outputs reach ~1e5 (the residual sums
    grow layer over layer; the reference has no normalisation), and the
    port's equal the reference's within rtol 1e-5 of their largest
    magnitude."""
    from repro_torch.data.graphs import icosahedral_mesh
    ref_cfg, cfg = ref_get_arch("graphcast").config, \
        get_arch("graphcast").config
    verts, src, dst = icosahedral_mesh(1)
    n, e = len(verts), len(src)
    rng = np.random.default_rng(0)
    batch = {"node_feat": rng.standard_normal((n, 227)).astype(np.float32),
             "edge_src": src.astype(np.int32),
             "edge_dst": dst.astype(np.int32),
             "edge_feat": rng.standard_normal((e, 4)).astype(np.float32),
             "edge_mask": np.ones(e, np.float32),
             "node_mask": np.ones(n, np.float32)}
    rp, pp = _params(ref_cfg)
    want = np.asarray(RM.forward(ref_cfg, rp, _ref(batch)))
    got = M.forward(cfg, pp, batch).numpy()
    scale = float(np.abs(want).max())
    assert scale > 1e3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_gin_mean_aggregator_with_graph_readout():
    ref_cfg, cfg = _configs("gin-tu", d_in=12, d_out=2, aggregator="mean",
                            graph_level=True)
    rp, pp = _params(ref_cfg, seed=3)
    batch = _batch(12, with_labels=False, seed=4)
    batch["graph_id"] = np.repeat(np.arange(3), 16).astype(np.int32)
    batch["node_mask"][-5:] = 0.0
    batch["n_graphs"] = 3
    batch["targets"] = np.random.default_rng(5).standard_normal(
        (3, 2)).astype(np.float32)
    assert M.forward(cfg, pp, batch).shape == (3, 2)
    assert_matches_reference(ref_cfg, cfg, rp, pp, batch)


# ---------------------------------------------------------------------------
# message passing
# ---------------------------------------------------------------------------

def _seg_case(seed, e, n, d, n_pad=0):
    """(E,) or (E, D) values, segment ids that leave some of the n
    segments empty, and ``n_pad`` padding edges on segment 0 with mask 0
    (the batches' padding)."""
    rng = np.random.default_rng(seed)
    shape = (e + n_pad,) if d == 0 else (e + n_pad, d)
    x = rng.standard_normal(shape).astype(np.float32)
    lo = 1 if n > 2 else 0
    seg = np.concatenate([rng.integers(lo, max(lo + 1, n // 2), e),
                          np.zeros(n_pad, np.int64)]).astype(np.int32)
    mask = np.concatenate([np.ones(e), np.zeros(n_pad)]).astype(np.float32)
    return x, seg, mask


@pytest.mark.parametrize("d", [0, 1, 7, 16])
@pytest.mark.parametrize("e,n,n_pad", [(1, 1, 0), (200, 40, 0),
                                       (300, 64, 50), (130, 3, 7)])
def test_segment_sum_matches_jax_and_its_routes_agree(d, e, n, n_pad):
    x, seg, mask = _seg_case(e + d, e, n, d, n_pad)
    xm = x * (mask if d == 0 else mask[:, None])
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(xm), jnp.asarray(seg),
                                          num_segments=n))
    xt, st = torch.from_numpy(xm), torch.from_numpy(seg)
    order = tuple(torch.sort(st, stable=True))
    outs = [M.segment_sum(xt, st, n), M.segment_sum(xt, st, n, order),
            M.segment_sum(xt, st, n, use_kernels=False)]
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=0, atol=1e-6)
    assert outs[0].shape == want.shape
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    # the gradient: the gather of the output gradient (jax.vjp)
    g = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda v: jax.ops.segment_sum(v, jnp.asarray(seg),
                                                   num_segments=n),
                     jnp.asarray(xm))
    xr = xt.clone().requires_grad_()
    M.segment_sum(xr, st, n, order).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xr.grad.numpy(), np.asarray(vjp(g)[0]))


@pytest.mark.parametrize("d", [1, 5, 16])
@pytest.mark.parametrize("e,n", [(1, 1), (200, 40), (500, 7)])
def test_gather_gradient_matches_jax_vjp(d, e, n):
    rng = np.random.default_rng(e * d)
    h = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, e).astype(np.int32)
    g = rng.standard_normal((e, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: v[jnp.asarray(idx)], jnp.asarray(h))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    it = torch.from_numpy(idx)
    grads = []
    for order, use_kernels in ((None, True),
                               (tuple(torch.sort(it, stable=True)), True),
                               (None, False)):
        ht = torch.from_numpy(h).requires_grad_()
        y = M.gather(ht, it, order, use_kernels=use_kernels)
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
        y.backward(torch.from_numpy(g))
        grads.append(ht.grad)
    np.testing.assert_allclose(grads[0].numpy(), want, rtol=0, atol=1e-6)
    assert all(torch.equal(x, grads[0]) for x in grads[1:])


def test_segment_sum_is_the_ordered_sum():
    """Each row is the float32 sum of its edges in edge order from 0."""
    x, seg, _ = _seg_case(7, 400, 9, 3)
    got = M.segment_sum(torch.from_numpy(x), torch.from_numpy(seg), 9)
    want = np.zeros((9, 3), np.float32)
    for e in range(len(seg)):
        want[seg[e]] = want[seg[e]] + x[e]
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sum_rejects_an_order_that_is_not_the_stable_sort():
    x, seg, _ = _seg_case(2, 50, 10, 4)
    st = torch.from_numpy(seg)
    keys, perm = torch.sort(st, stable=True)
    with pytest.raises(ValueError, match="stable sort"):
        M.segment_sum(torch.from_numpy(x), st, 10, (keys, perm.flip(0)))


def test_edge_orders_are_the_stable_sorts():
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    orders = M.edge_orders(batch)
    for side in ("src", "dst"):
        keys, perm = orders[side]
        want = torch.sort(batch[f"edge_{side}"], stable=True)
        assert torch.equal(keys, want.values) and torch.equal(perm,
                                                             want.indices)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_orders_and_plain_route_give_the_same_bits(arch):
    """A step's loss and gradients on the kernels' route (the wrapper on
    the call's ``edge_orders``) and with ``use_kernels=False`` are equal
    bit for bit on the CPU."""
    _, cfg = _configs(arch, d_in=12, d_out=3)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(12, seed=2).items()}
    runs = [L.value_and_grad(lambda p: M.loss_fn(cfg, p, batch, **kw),
                             params)
            for kw in ({}, {"use_kernels": False})]
    (loss, _, grads), (plain_loss, _, plain_grads) = runs
    assert torch.equal(loss, plain_loss)
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads),
                                                 leaves(plain_grads)))


# ---------------------------------------------------------------------------
# init, training, checkpoints
# ---------------------------------------------------------------------------

def test_materialize_keeps_the_flat_draw_order():
    """A flat dict (DLRM's) is drawn in sorted key order from one
    generator, one leaf after another: the order the port's DLRM params
    have been drawn in since they were ported."""
    from repro_torch.configs.dlrm_mlperf import SMOKE_CONFIG
    from repro_torch.models import dlrm
    shapes = dlrm.param_shapes(SMOKE_CONFIG)
    got = L.materialize(shapes, torch.Generator().manual_seed(3))
    assert list(got) == list(shapes)
    gen = torch.Generator().manual_seed(3)
    for name in sorted(shapes):
        shape, dtype = shapes[name]
        if L._is_zero_init(name, shape):
            want = torch.zeros(shape, dtype=dtype)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            want = torch.empty(shape, dtype=dtype).normal_(
                0.0, fan_in ** -0.5, generator=gen)
        assert torch.equal(got[name], want), name


def test_materialize_draws_nested_trees_in_pytree_order():
    """GraphCast's params: the nested ``proc`` leaves drawn where ``proc``
    sorts among the top-level keys, each leaf's rule by its last key."""
    cfg = get_arch("graphcast").smoke_config
    shapes = M.param_shapes(cfg)
    got = M.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    flat = flatten_with_path(got)
    assert [p for p, _ in flat][:4] == [("dec_b0",), ("dec_b1",),
                                        ("dec_w0",), ("dec_w1",)]
    gen = torch.Generator().manual_seed(4)
    for path, t in flat:
        name = path[-1]
        shape = tuple(t.shape)
        if L._is_zero_init(name, shape):
            assert not t.any(), path
            continue
        want = torch.empty(shape).normal_(0.0, shape[-2] ** -0.5,
                                          generator=gen)
        assert torch.equal(t, want), path
    assert got["proc"]["e_w0"].shape == shapes["proc"]["e_w0"][0]


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_module_steps_match_the_reference_step(arch):
    """Three AdamW steps of ``GNN.train_step`` (lr 1e-2 from the first
    step, so params move by ~1e-2) against the reference's jitted step
    from the same params and optimizer state."""
    ref_cfg, cfg = _configs(arch, d_in=12, d_out=3)
    rp, pp = _params(ref_cfg, seed=1)
    model = M.GNN(cfg, pp)
    ro = RA.init(rp)
    opt = A.init(model.param_tree())
    batch = _batch(12, seed=6)
    rb = _ref(batch)
    ref_opt = RA.AdamWConfig(**OPT)

    @jax.jit
    def ref_step(p, o):
        loss, g = jax.value_and_grad(
            lambda q: RM.loss_fn(ref_cfg, q, rb)[0])(p)
        p, o, _ = RA.apply(ref_opt, p, g, o)
        return p, o, loss

    for _ in range(3):
        rp, ro, r_loss = ref_step(rp, ro)
        opt, m = model.train_step(A.AdamWConfig(**OPT), opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(r_loss),
                                   rtol=1e-4)
    assert_trees_close(model.param_tree(), rp, **STEP_TOL)
    assert int(opt.step) == 3
    assert not any(p.requires_grad for p in model.parameters())


def test_module_step_equals_the_function_step():
    _, cfg = _configs("schnet", d_in=12, d_out=1)
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    model = M.GNN(cfg, tree_map(torch.clone, params))
    mo, fo = A.init(model.param_tree()), A.init(params)
    batch = _batch(12, with_labels=False, seed=8)
    opt_cfg = A.AdamWConfig(**OPT)
    for _ in range(2):
        mo, mm = model.train_step(opt_cfg, mo, batch)
        _, fo, fm = M.train_step(cfg, opt_cfg, params, fo, batch)
        assert torch.equal(mm["loss"], fm["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(model.param_tree()), leaves(params)))


def test_nested_checkpoint_round_trip(tmp_path):
    """GraphCast's nested params and an ``OptState`` after two steps:
    saved by the port and restored by the port and by the reference bit
    for bit; the reference's own checkpoint restores in the port."""
    ref_cfg, cfg = _configs("graphcast", d_in=12, d_out=3)
    rp, pp = _params(ref_cfg, seed=2)
    opt = A.init(pp)
    for _ in range(2):
        pp, opt, _ = M.train_step(cfg, A.AdamWConfig(**OPT), pp, opt,
                                  _batch(12, seed=7))
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(2, (pp, opt))
    mgr.wait()
    template = (M.init_params(cfg, torch.Generator().manual_seed(9), "cpu"),)
    template = (template[0], A.init(template[0]))
    (got_p, got_o), step = CheckpointManager(tmp_path / "port").restore(
        template)
    assert step == 2
    assert all(torch.equal(a, b) for a, b in zip(leaves((got_p, got_o)),
                                                 leaves((pp, opt))))
    ref_template = (rp, RA.init(rp))
    (rp2, ro2), _ = RefManager(tmp_path / "port").restore(ref_template)
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in
               zip(leaves((pp, opt)), jax.tree_util.tree_leaves((rp2, ro2))))
    ref_mgr = RefManager(tmp_path / "ref")
    ref_mgr.save(2, (rp2, ro2))
    ref_mgr.wait()
    (p3, o3), _ = CheckpointManager(tmp_path / "ref").restore(template)
    want_o = opt_state_from_reference(RA.OptState(
        np.asarray(ro2.step), _np(ro2.m), _np(ro2.v)))
    assert all(torch.equal(a, b) for a, b in zip(leaves((p3, o3)),
                                                 leaves((pp, want_o))))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _from_reference_init(monkeypatch):
    """The CLI's init_params replaced by the reference's PRNGKey(0) params
    of the same config (what the reference's CLI starts from)."""
    def init(cfg, gen, device):
        ref_cfg = dataclasses.replace(ref_get_arch(cfg.name.replace(
            "-smoke", "")).smoke_config, d_in=cfg.d_in, d_out=cfg.d_out)
        return params_from_reference(
            _np(RM.init_params(ref_cfg, jax.random.PRNGKey(0))), device)
    monkeypatch.setattr(M, "init_params", init)


@pytest.fixture
def restore_dtypes():
    """Both packages' global dtypes as they were before the test: the CLIs
    call ``set_dtypes(float32, float32)`` under ``--smoke``, as the
    reference's does."""
    from repro.models import layers as RL
    saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    try:
        yield
    finally:
        RL.set_dtypes(*saved[0])
        L.set_dtypes(*saved[1])


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_cli_losses_match_the_reference(monkeypatch, restore_dtypes, arch,
                                        compress):
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main
    argv = ["--arch", arch, "--smoke", "--steps", "20", "--log-every",
            "100", "--compress", compress]
    want = ref_main(argv)
    _from_reference_init(monkeypatch)
    got = main(argv + ["--torch-device", "cpu"])
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    cfg = get_arch("gcn-cora").smoke_config
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.GNN(cfg)
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "gcn-cora", "--smoke", "--steps", "1"])
