"""repro_torch's DLRM training path against the reference's, on the CPU.

* The lookup's gradient (``kernels.embedding_bag.grad``): the Function's
  table gradient against ``jax.grad`` of the reference's lookup
  (``jnp.take`` of the clamped indices, then the float32 bag sum) at L = 1
  and 3 with duplicates, PAD and indices >= V, within atol 1e-6 at
  float32 (the same sums in another order). At bfloat16 tables the
  reference scatter-adds in bfloat16, rounding at every add, and the port
  sums in float32 and rounds once: the port's gradient is within half a
  bfloat16 ulp of the exact (float64) sum and never farther from it than
  the reference's. The plain version is equal bit for bit to an ordered
  Python loop, also at the run lengths where the kernel changes path;
  ``gradcheck`` in float64. A caller's stable sort (``order``) gives the
  same bits and one that is not the stable sort raises; the train step's
  one sort a field (``unique_with_order``) gives ``torch.unique``'s values
  and inverse.
* The dense step (``loss_fn``'s gradient + ``adamw.apply``) and
  ``make_sparse_train_step`` on ``SMOKE_CONFIG`` (hot = 3) against the
  reference's, from the reference's params and optimizer state carried
  across, for 3 steps with ``lr = 1e-2`` and one warmup step (so each
  step moves params by ~1e-2, far above the tolerance): loss, every param,
  m, v and step, at float32 within rtol 1e-5 and atol 1e-6 (the same
  float32 operations, sums in other orders). At bfloat16 tables the row
  gradients differ by the reference's bfloat16 rounding at each add; the
  tolerances of those tests say how far that carries.
* The sparse step over ``["cpu"] * 2`` and ``["cpu"] * 3`` equal to the
  unsharded one bit for bit.
* ``launch.train.main`` on ``dlrm-mlperf --smoke``: from the reference's
  initial params its losses equal the reference's ``main``'s within rtol
  1e-4 over 30 steps and fall as they do (plain and ``--compress int8``);
  from the port's own initial params the held-out loss falls; checkpoint
  and ``--resume``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm_mlperf import SMOKE_CONFIG as REF_SMOKE
from repro.models import dlrm as RM
from repro.models import layers as RL
from repro.optim import adamw as RA
from repro_torch.configs import get_arch
from repro_torch.configs.dlrm_mlperf import SMOKE_CONFIG
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference)
from repro_torch.data.recsys import CriteoLikeGenerator
from repro_torch.kernels.embedding_bag import grad as bag_grad
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_ref
from repro_torch.models import dlrm as M
from repro_torch.models import layers as L
from repro_torch.optim import adamw as A
from repro_torch.parallel.sharding import (dlrm_opt_state_placement,
                                           dlrm_param_placement,
                                           table_row_block)

TABLE_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}
OPT = dict(lr=1e-2, warmup_steps=1)


@pytest.fixture(params=sorted(TABLE_DTYPES))
def table_dtype(request):
    """The reference's and the port's table dtype for one test, restored
    after it."""
    ref_dt, port_dt = TABLE_DTYPES[request.param]
    ref_saved = (RL.PDTYPE, RL.ADTYPE)
    port_saved = (L.PDTYPE, L.ADTYPE)
    RL.set_dtypes(ref_dt, jnp.float32)
    L.set_dtypes(port_dt, torch.float32)
    try:
        yield request.param
    finally:
        RL.set_dtypes(*ref_saved)
        L.set_dtypes(*port_saved)


@pytest.fixture
def float32_dtypes():
    port_saved = (L.PDTYPE, L.ADTYPE)
    L.set_dtypes(torch.float32, torch.float32)
    try:
        yield
    finally:
        L.set_dtypes(*port_saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _bag_case(seed, v, b, ll, d=16, dtype=np.int64):
    """(B, ll) indices below 1.3 v (some >= v, among them PAD == v), with
    duplicates, and a (B, D) output gradient."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, int(v * 1.3) + 1, (b, ll)).astype(dtype)
    idx[0, :] = v                          # a bag with no live slot
    idx[1, :] = 2                          # every slot on one row
    g = rng.standard_normal((b, d)).astype(np.float32)
    return idx, g


# ---------------------------------------------------------------------------
# the lookup's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ll", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_grad_matches_jax_grad_of_reference_lookup(table_dtype, ll,
                                                          seed):
    v, d = 37, 16
    idx, g = _bag_case(seed, v, 64, ll, d)
    rng = np.random.default_rng(seed + 10)
    tab = rng.standard_normal((v, d)).astype(np.float32)
    ref_dt, port_dt = TABLE_DTYPES[table_dtype]
    rtab = jnp.asarray(tab, ref_dt)

    def ref_loss(t):
        vec = jnp.take(t, jnp.minimum(jnp.asarray(idx), v - 1), axis=0)
        return jnp.sum(jnp.sum(vec.astype(jnp.float32), axis=1) * g)

    want = jax.grad(ref_loss)(rtab)
    ptab = torch.from_numpy(np.array(rtab.astype(jnp.float32))) \
        .to(port_dt).requires_grad_()
    clamped = torch.from_numpy(idx).clamp(max=v - 1)
    out = bag_grad.embedding_bag_grad(ptab, clamped)
    (got,) = torch.autograd.grad(out, [ptab], torch.from_numpy(g))
    assert got.dtype == port_dt and got.shape == (v, d)
    if table_dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        # the port: the float32 sum rounded once, so within half a
        # bfloat16 ulp of the exact sum, and never farther from it than
        # the reference's bfloat16 scatter-add
        f32 = embedding_bag_backward_ref(torch.from_numpy(g), clamped, v)
        assert torch.equal(got, f32.to(torch.bfloat16))
        exact = np.zeros((v, d))
        np.add.at(exact, clamped.numpy().reshape(-1),
                  np.repeat(g.astype(np.float64), ll, axis=0))
        port_err = np.abs(_np(got) - exact)
        ref_err = np.abs(_np(want) - exact)
        assert (port_err <= 2 ** -8 * np.abs(exact) + 1e-6).all()
        assert (port_err <= np.maximum(ref_err, 2 ** -8 * np.abs(exact))
                + 1e-6).all()


def _loop_oracle(g, idx, v):
    out = np.zeros((v, g.shape[1]), np.float32)
    for b in range(idx.shape[0]):
        for s in range(idx.shape[1]):
            r = int(idx[b, s])
            if r < v:
                out[r] = out[r] + g[b]
    return out


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("v,b,ll", [(3, 200, 1), (3, 50, 8), (41, 64, 1),
                                    (41, 64, 8), (1000, 16, 3), (1, 10, 2)])
def test_backward_plain_version_is_the_ordered_sum(idx_dtype, v, b, ll):
    """Each row summed in float32 in (b, s) order from 0; slots >= v empty;
    untouched rows zero; bfloat16 output = the float32 sum rounded once;
    the wrapper takes the plain version on CPU tensors and counts no
    launch."""
    idx, g = _bag_case(v + b, v, b, ll, dtype=idx_dtype)
    want = _loop_oracle(g, idx, v)
    before = bag_grad.BACKWARD_LAUNCHES.n
    got = bag_grad.embedding_bag_backward(torch.from_numpy(g),
                                          torch.from_numpy(idx), v)
    assert bag_grad.BACKWARD_LAUNCHES.n == before
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    touched = np.unique(idx[idx < v])
    assert not got.numpy()[np.setdiff1d(np.arange(v), touched)].any()
    bf = bag_grad.embedding_bag_backward(torch.from_numpy(g),
                                         torch.from_numpy(idx), v,
                                         torch.bfloat16)
    assert torch.equal(bf, torch.from_numpy(want).to(torch.bfloat16))


def test_backward_reads_a_strided_gradient():
    idx, g = _bag_case(5, 20, 32, 2)
    wide = torch.from_numpy(np.concatenate([g, g * 3], axis=1))
    got = bag_grad.embedding_bag_backward(wide[:, :16],
                                          torch.from_numpy(idx), 20)
    np.testing.assert_array_equal(got.numpy(), _loop_oracle(g, idx, 20))


def test_backward_checks_its_inputs():
    g = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        bag_grad.embedding_bag_backward(g, torch.zeros(4, 2), 5)
    with pytest.raises(ValueError):
        bag_grad.embedding_bag_backward(g, torch.zeros(3, 2,
                                                       dtype=torch.int64), 5)
    with pytest.raises(ValueError):
        bag_grad.embedding_bag_backward(g, torch.zeros(4, 2,
                                                       dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="negative"):
        bag_grad.embedding_bag_backward(
            g, torch.full((4, 2), -1, dtype=torch.int64), 5)


@pytest.mark.parametrize("ll", [1, 4])
def test_gradcheck_of_the_plain_function(ll):
    v, d = 6, 3
    idx, _ = _bag_case(ll, v, 5, ll, d)
    tab = torch.randn(v, d, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(ll),
                      requires_grad=True)
    fn = lambda t: bag_grad.embedding_bag_grad(  # noqa: E731
        t, torch.from_numpy(idx), use_kernels=False)
    assert torch.autograd.gradcheck(fn, (tab,))


def test_function_on_cpu_kernels_route_equals_plain_route():
    """use_kernels=True on CPU tensors is the wrapper's plain version:
    the same forward and backward as use_kernels=False."""
    idx, g = _bag_case(3, 30, 40, 3)
    tab = torch.randn(30, 16, generator=torch.Generator().manual_seed(0))
    outs = []
    for use in (True, False):
        t = tab.clone().requires_grad_()
        out = bag_grad.embedding_bag_grad(t, torch.from_numpy(idx),
                                          use_kernels=use)
        outs.append((out, torch.autograd.grad(out, [t],
                                              torch.from_numpy(g))[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _stable_sort(idx):
    keys, perm = torch.sort(idx.reshape(-1), stable=True)
    return keys, perm


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("v,b,ll", [(41, 64, 1), (41, 64, 8), (3, 50, 8),
                                    (1000, 16, 3)])
def test_backward_with_the_callers_sort_equals_its_own(idx_dtype, v, b, ll):
    """``order`` (the stable sort of the flattened indices) changes
    nothing: the same bits at both outputs."""
    idx, g = _bag_case(v + 7 * b, v, b, ll, dtype=idx_dtype)
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    for dtype in (torch.float32, torch.bfloat16):
        want = bag_grad.embedding_bag_backward(tg, ti, v, dtype)
        got = bag_grad.embedding_bag_backward(tg, ti, v, dtype,
                                              order=_stable_sort(ti))
        assert torch.equal(got, want)


def test_backward_rejects_an_order_that_is_not_the_stable_sort():
    idx, g = _bag_case(3, 20, 32, 2)
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    keys, perm = _stable_sort(ti)
    with pytest.raises(TypeError):                 # keys of another dtype
        bag_grad.embedding_bag_backward(tg, ti, 20,
                                        order=(keys.int(), perm))
    with pytest.raises(TypeError):                 # int32 positions
        bag_grad.embedding_bag_backward(tg, ti, 20,
                                        order=(keys, perm.int()))
    with pytest.raises(ValueError):                # another length
        bag_grad.embedding_bag_backward(tg, ti, 20,
                                        order=(keys[1:], perm[1:]))
    with pytest.raises(ValueError, match="stable sort"):   # ties reversed
        tie = int(torch.nonzero(keys[1:] == keys[:-1])[0, 0])
        swapped = perm.clone()
        swapped[tie], swapped[tie + 1] = perm[tie + 1], perm[tie]
        bag_grad.embedding_bag_backward(tg, ti, 20, order=(keys, swapped))
    with pytest.raises(ValueError, match="stable sort"):   # not sorted
        bag_grad.embedding_bag_backward(tg, ti, 20,
                                        order=(keys.flip(0), perm.flip(0)))
    with pytest.raises(ValueError, match="stable sort"):   # keys != idx[perm]
        bag_grad.embedding_bag_backward(tg, ti, 20, order=(keys + 1, perm))
    with pytest.raises(ValueError, match="stable sort"):   # not a permutation
        bag_grad.embedding_bag_backward(
            tg, ti, 20, order=(keys, torch.zeros_like(perm)))


@pytest.mark.parametrize("lengths", [
    [bag_grad.LONG_RUN - 1, 2, bag_grad.LONG_RUN, 1, bag_grad.LONG_RUN + 1],
    [bag_grad.SPAN - 1, bag_grad.LONG_RUN + 1, bag_grad.SPAN + 1],
    [4096]])
def test_backward_plain_version_at_the_kernels_run_lengths(lengths):
    """The plain version equals the ordered loop at the run lengths where
    the kernel changes path: around LONG_RUN (runs of more slots are split
    by columns), a run starting at a tile's last position, one run taking
    all 4,096 slots."""
    rng = np.random.default_rng(len(lengths))
    idx = np.repeat(np.arange(len(lengths)), lengths)
    rng.shuffle(idx)
    idx = idx.reshape(-1, 1)
    g = rng.standard_normal((idx.shape[0], 16)).astype(np.float32)
    v = len(lengths) + 1
    got = bag_grad.embedding_bag_backward(torch.from_numpy(g),
                                          torch.from_numpy(idx), v,
                                          order=_stable_sort(
                                              torch.from_numpy(idx)))
    np.testing.assert_array_equal(got.numpy(), _loop_oracle(g, idx, v))


@pytest.mark.parametrize("const,value", [("kLongRun", bag_grad.LONG_RUN),
                                         ("kTile", bag_grad.SPAN)])
def test_backward_run_constants_match_the_kernel(const, value):
    """The wrapper's LONG_RUN and SPAN, which the run-length cases above
    and the smoke's build on, are the kernel's constexpr constants."""
    src = (Path(bag_grad.__file__).resolve().parents[2] / "csrc"
           / "embedding_bag_backward.cu").read_text()
    found = re.findall(rf"constexpr (?:int|long long) {const} = (\d+);", src)
    assert found == [str(value)]


@pytest.mark.parametrize("use_kernels", [True, False])
def test_function_with_the_callers_sort(use_kernels):
    """``embedding_bag_grad(..., order=...)``: the same lookup and table
    gradient as without it, on both routes."""
    idx, g = _bag_case(11, 30, 40, 3)
    ti = torch.from_numpy(idx)
    tab = torch.randn(30, 16, generator=torch.Generator().manual_seed(1))
    outs = []
    for order in (None, _stable_sort(ti)):
        t = tab.clone().requires_grad_()
        out = bag_grad.embedding_bag_grad(t, ti, use_kernels=use_kernels,
                                          order=order)
        outs.append((out, torch.autograd.grad(out, [t],
                                              torch.from_numpy(g))[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("past_v", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_sort_gives_torch_uniques_values(seed, past_v):
    """The train step's one sort a field (``unique_with_order``): the
    values and inverse ``torch.unique`` gives, and the stable sort of the
    inverse that the backward takes, at the test batches (with indices
    past V when ``past_v``) and at a power-law draw over 2^20 rows."""
    fields = [b["sparse"][:, t, :].reshape(-1)
              for b in _batches(2, 64, seed, past_v)
              for t in range(SMOKE_CONFIG.n_sparse)]
    fields.append(CriteoLikeGenerator((1 << 20,), seed=seed)
                  .batch(4096)["sparse"].reshape(-1))
    for x in fields:
        tx = torch.from_numpy(x)
        uniq, inv, (keys, perm) = M.unique_with_order(tx)
        want_u, want_inv = torch.unique(tx, sorted=True, return_inverse=True)
        assert torch.equal(uniq, want_u) and torch.equal(inv, want_inv)
        assert keys.dtype == torch.int32
        sort_keys, sort_perm = _stable_sort(inv.to(torch.int32))
        assert torch.equal(keys, sort_keys) and torch.equal(perm, sort_perm)


def test_lookup_gradient_of_a_clamped_index_goes_to_the_last_row(
        float32_dtypes):
    """An index >= V reads row V - 1 and sends its gradient there, as the
    reference's clamped jnp.take does."""
    cfg = SMOKE_CONFIG
    params = M.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    sparse = (torch.tensor(cfg.table_sizes, dtype=torch.int32) + 3) \
        .view(1, -1, 1).expand(4, -1, cfg.hot).contiguous()
    leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
    embs = M.embedding_lookups(cfg, leaves, sparse)
    grads = torch.autograd.grad(sum(e.sum() for e in embs),
                                [leaves[f"table{t}"]
                                 for t in range(cfg.n_sparse)])
    for t, gt in enumerate(grads):
        v = cfg.table_sizes[t]
        assert bool((gt[v - 1] == 4 * cfg.hot).all())
        assert not gt[:v - 1].any()


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------

def _start(seed=0):
    """The reference's smoke params and fresh OptState, and the port's
    copies."""
    rp = RM.init_params(REF_SMOKE, jax.random.PRNGKey(seed))
    ro = RA.init(rp)
    pp = params_from_reference({k: np.asarray(v) for k, v in rp.items()})
    po = opt_state_from_reference(RA.OptState(
        np.asarray(ro.step), {k: np.asarray(x) for k, x in ro.m.items()},
        {k: np.asarray(x) for k, x in ro.v.items()}))
    return (rp, ro), (pp, po)


def _batches(n, b, seed, past_v=False):
    gen = CriteoLikeGenerator(SMOKE_CONFIG.table_sizes, SMOKE_CONFIG.n_dense,
                              SMOKE_CONFIG.hot, seed=seed)
    out = [gen.batch(b) for _ in range(n)]
    if past_v:   # a few indices past V (rows the step reads, never updates)
        for batch in out:
            batch["sparse"][:3, :, 0] = np.array(SMOKE_CONFIG.table_sizes)
    return out


def _assert_state_close(rp, ro, pp, po):
    """float32: every param and moment within rtol 1e-5, atol 1e-6."""
    assert int(po.step) == int(ro.step)
    for k in rp:
        for got, want in ((pp[k], rp[k]), (po.m[k], ro.m[k]),
                          (po.v[k], ro.v[k])):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _ref_dense_step(rcfg):
    @jax.jit
    def step(p, o, batch):
        (loss, _), g = jax.value_and_grad(
            lambda q: RM.loss_fn(REF_SMOKE, q, batch), has_aux=True)(p)
        p, o, om = RA.apply(rcfg, p, g, o)
        return p, o, {"loss": loss, **om}
    return step


def _port_dense_step(pcfg):
    """``loss_fn``'s gradient through every param (the tables' through the
    lookup's backward) and ``adamw.apply``: the CLI's plain step."""
    def step(pp, po, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in pp.items()}
        loss, _ = M.loss_fn(SMOKE_CONFIG, leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        assert grads["table0"].dtype == pp["table0"].dtype
        _, _, om = A.apply(pcfg, pp, grads, po)
        return pp, po, {"loss": loss.detach(), **om}
    return step


def _run_both(kind, opt, past_v=False):
    """3 steps of the reference's and the port's ``kind`` step ("sparse":
    make_sparse_train_step, "dense": the CLI's) from one state; the
    per-step losses, both final states and the start."""
    seed = {"sparse": 0, "dense": 1}[kind]
    (rp, ro), (pp, po) = _start(seed)
    rcfg, pcfg = RA.AdamWConfig(**opt), A.AdamWConfig(**opt)
    if kind == "sparse":
        rstep = jax.jit(RM.make_sparse_train_step(REF_SMOKE, rcfg))
        pstep = M.make_sparse_train_step(SMOKE_CONFIG, pcfg)
        batches = _batches(3, 48, 1, past_v)
    else:
        rstep, pstep = _ref_dense_step(rcfg), _port_dense_step(pcfg)
        batches = _batches(3, 32, 2)
    start = {k: v.clone() for k, v in pp.items()}
    losses = []
    for batch in batches:
        rp, ro, rm = rstep(rp, ro, _ref(batch))
        pp2, po2, pm = pstep(pp, po, batch)
        assert pp2 is pp and po2 is po          # updated in place
        assert float(pm["lr"]) == float(rm["lr"])
        losses.append((float(pm["loss"]), float(rm["loss"])))
    assert int(po.step) == int(ro.step) == 3
    return losses, (rp, ro), (pp, po), start


@pytest.mark.parametrize("kind,past_v", [("sparse", False),
                                         ("sparse", True),
                                         ("dense", False)])
def test_step_matches_reference_at_float32(float32_dtypes, kind, past_v):
    losses, (rp, ro), (pp, po), start = _run_both(kind, OPT, past_v)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    _assert_state_close(rp, ro, pp, po)
    # the typical update is far above the tolerance
    assert float((pp["bot_w0"] - start["bot_w0"]).abs().median()) > 1e-3
    assert pp["table0"].dtype == torch.float32


# the linear regime: eps = 1 makes each step about lr * m (no division by
# a near-zero sqrt(v)), so a step's difference stays the size of the
# gradients' difference
LINEAR = dict(lr=1.0, eps=1.0, warmup_steps=1)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_step_matches_reference_at_bfloat16_within_rounding(kind):
    """bfloat16 tables: the reference scatter-adds each row's gradient in
    bfloat16 (up to ~1 % off for the smoke config's 7-row table, whose
    rows take ~20 slots of a 48-bag batch each), the port sums in float32
    and rounds once. In the linear regime the losses agree within rtol
    1e-4, every param, m and v within a tenth of the largest move of its
    tensor (its largest |start - reference|), and 90 % of table elements
    within two bfloat16 ulps."""
    saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    RL.set_dtypes(jnp.bfloat16, jnp.float32)
    L.set_dtypes(torch.bfloat16, torch.float32)
    try:
        losses, (rp, ro), (pp, po), start = _run_both(kind, LINEAR)
    finally:
        RL.set_dtypes(*saved[0])
        L.set_dtypes(*saved[1])
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert pp["table0"].dtype == torch.bfloat16
    for k in rp:
        move = np.abs(_np(start[k]) - _np(rp[k])).max()
        assert move > 1e-2, k
        err = np.abs(_np(pp[k]) - _np(rp[k]))
        assert err.max() <= 0.1 * move, k
        if k.startswith("table"):
            assert np.mean(err <= 2 ** -7 * np.abs(_np(rp[k])) + 1e-6) \
                >= 0.9, k
        for got, want in ((po.m[k], ro.m[k]), (po.v[k], ro.v[k])):
            assert np.abs(_np(got) - _np(want)).max() \
                <= 0.1 * np.abs(_np(want)).max(), k


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_step_at_bfloat16_under_adamw_normalisation(kind):
    """bfloat16 tables at lr = 1e-2: AdamW's first steps move each element
    by about lr * sign(gradient), so where the float32 sum and the
    reference's bfloat16 sum of a near-zero row gradient differ in sign,
    an element moves the other way. The losses still agree within rtol
    1e-3 and no element is further from the reference's than two such
    steps per step (2 * lr * 3)."""
    saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    RL.set_dtypes(jnp.bfloat16, jnp.float32)
    L.set_dtypes(torch.bfloat16, torch.float32)
    try:
        losses, (rp, ro), (pp, po), _ = _run_both(kind, OPT)
    finally:
        RL.set_dtypes(*saved[0])
        L.set_dtypes(*saved[1])
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-3)
    for k in rp:
        assert np.abs(_np(pp[k]) - _np(rp[k])).max() <= 2 * OPT["lr"] * 3


def test_train_step_smoke(float32_dtypes):
    """The reference's TestDLRMSmoke::test_train_step on the port: the loss
    of a smoke batch is in (0, 20) and no gradient is NaN."""
    cfg = get_arch("dlrm-mlperf").smoke_config
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    batch = {"dense": rng.standard_normal((16, cfg.n_dense))
             .astype(np.float32),
             "sparse": rng.integers(0, 5, (16, cfg.n_sparse, cfg.hot))
             .astype(np.int32),
             "labels": rng.integers(0, 2, 16).astype(np.float32)}
    leaves = {k: p.requires_grad_() for k, p in params.items()}
    loss, _ = M.loss_fn(cfg, leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert 0 < float(loss.detach()) < 20
    assert not any(bool(torch.isnan(g).any()) for g in grads)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_sparse_step_equals_unsharded(table_dtype, n):
    """Over ["cpu"] * n: tables whose V divides by n cut into row blocks
    (their moments too), the others and the MLP replicated (here views of
    one tensor: updated once); params, moments and step equal the
    unsharded step's bit for bit over 3 steps."""
    _, (pp, po) = _start(2)
    devices = ["cpu"] * n
    sp = dlrm_param_placement({k: v.clone() for k, v in pp.items()}, devices)
    so = dlrm_opt_state_placement(A.OptState(
        po.step.clone(), {k: v.clone() for k, v in po.m.items()},
        {k: v.clone() for k, v in po.v.items()}), devices)
    cfg = A.AdamWConfig(**OPT)
    step = M.make_sparse_train_step(SMOKE_CONFIG, cfg)
    sstep = M.make_sparse_train_step(SMOKE_CONFIG, cfg, devices=devices)
    for batch in _batches(3, 40, 3):
        _, _, m = step(pp, po, batch)
        _, _, sm = sstep(sp, so, batch)
        assert torch.equal(m["loss"], sm["loss"])
    assert torch.equal(so.step, po.step)

    def whole(parts, v):
        blk = table_row_block(v, n)
        return torch.cat(parts) if blk else parts[0]

    n_cut = 0
    for k in pp:
        v = pp[k].shape[0]
        cut = k.startswith("table") and table_row_block(v, n) > 0
        n_cut += cut
        for got, want in ((sp[k], pp[k]), (so.m[k], po.m[k]),
                          (so.v[k], po.v[k])):
            assert torch.equal(whole(got, v) if cut else got[0], want), k
            if not cut:
                assert all(torch.equal(r, got[0]) for r in got)
    assert n_cut == {2: 3, 3: 0}[n]


def test_use_kernels_false_is_the_same_step_on_the_cpu(float32_dtypes):
    _, (pp, po) = _start(3)
    p2 = {k: v.clone() for k, v in pp.items()}
    o2 = A.OptState(po.step.clone(), {k: v.clone() for k, v in po.m.items()},
                    {k: v.clone() for k, v in po.v.items()})
    cfg = A.AdamWConfig(**OPT)
    for batch in _batches(2, 32, 4):
        M.make_sparse_train_step(SMOKE_CONFIG, cfg)(pp, po, batch)
        M.make_sparse_train_step(SMOKE_CONFIG, cfg, use_kernels=False)(
            p2, o2, batch)
    for k in pp:
        assert torch.equal(pp[k], p2[k]) and torch.equal(po.m[k], o2.m[k])


def test_module_train_step_equals_the_function(float32_dtypes):
    _, (pp, po) = _start(4)
    model = M.DLRM(SMOKE_CONFIG, {k: v.clone() for k, v in pp.items()})
    mo = A.init(dict(model.params))
    cfg = A.AdamWConfig(**OPT)
    step = M.make_sparse_train_step(SMOKE_CONFIG, cfg)
    for batch in _batches(2, 32, 5):
        mo, mm = model.train_step(cfg, mo, batch)
        _, po, pm = step(pp, po, batch)
        assert torch.equal(mm["loss"], pm["loss"])
    for k in pp:
        assert torch.equal(model.params[k], pp[k])
    assert not any(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _from_reference_init(monkeypatch):
    """The CLI's init_params replaced by the reference's PRNGKey(0) params
    (what the reference's CLI starts from), carried across."""
    rp = RM.init_params(REF_SMOKE, jax.random.PRNGKey(0))
    pp = params_from_reference({k: np.asarray(v) for k, v in rp.items()})
    monkeypatch.setattr(M, "init_params", lambda cfg, gen, device: {
        k: v.clone().to(device) for k, v in pp.items()})


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_cli_loss_decreases_like_the_reference(monkeypatch, compress,
                                               float32_dtypes):
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main
    argv = ["--arch", "dlrm-mlperf", "--smoke", "--steps", "30", "--batch",
            "64", "--log-every", "100", "--compress", compress]
    want = ref_main(argv)
    _from_reference_init(monkeypatch)
    got = main(argv + ["--torch-device", "cpu"])
    assert len(got) == len(want) == 30
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_cli_checkpoint_resume_and_held_out_loss(tmp_path, capsys,
                                                 float32_dtypes):
    """The port's own init (seed 0): 30 steps with checkpoints, then
    --resume to 40 from step 30; the held-out loss of the step-40 params
    is below that of the initial params."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import main
    argv = ["--arch", "dlrm-mlperf", "--smoke", "--batch", "64",
            "--log-every", "100", "--ckpt-dir", str(tmp_path),
            "--torch-device", "cpu"]
    first = main(argv + ["--steps", "30"])
    assert len(first) == 30
    assert CheckpointManager(tmp_path).all_steps() == [30]
    more = main(argv + ["--steps", "40", "--resume"])
    assert len(more) == 10
    assert "resumed from step 30" in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest_step() == 40
    cfg = SMOKE_CONFIG
    init = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    (trained, _), _ = CheckpointManager(tmp_path).restore((init,
                                                           A.init(init)))
    held = CriteoLikeGenerator(cfg.table_sizes, cfg.n_dense, cfg.hot,
                               seed=7).batch(4096)
    with torch.no_grad():
        before = float(M.loss_fn(cfg, init, held)[0])
        after = float(M.loss_fn(cfg, trained, held)[0])
    assert after < before


def test_cli_names_an_arch_it_cannot_train(float32_dtypes):
    # every registered family trains (the LMs since their training slice);
    # an arch the registry does not hold is named in the KeyError
    from repro_torch.launch.train import main
    with pytest.raises(KeyError, match="no-such-arch"):
        main(["--arch", "no-such-arch", "--smoke", "--torch-device", "cpu"])


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "dlrm-mlperf", "--smoke", "--steps", "1"])
