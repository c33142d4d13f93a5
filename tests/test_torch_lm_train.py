"""repro_torch's LM training against the reference's, on the CPU.

The port's ``transformer.loss_fn`` gradient (``layers.value_and_grad``),
``transformer.train_step`` and the ``lm`` branch of ``launch.train`` run
the reference's materialized params, carried across bit for bit by
``convert.params_from_reference``, on token batches made with numpy from
fixed seeds; the reference's gradients are ``jax.value_and_grad`` of its
``loss_fn``. Tolerances:
  * float32 (both packages' ``set_dtypes(float32, float32)``): the loss
    within rtol 1e-5; every gradient within rtol 1e-4 and an atol of
    1e-5 × the largest |gradient| of the tree (the same products and sums
    taken in other orders);
  * bfloat16 params and activations (the three dense archs; JAX's CPU
    backend cannot run the MoE archs' bfloat16 dots): the loss within
    2^-5 relative, each gradient within 2^-5 relative L2 error of the
    reference's (the port rounds the float32 cotangent of a float32-output
    product to bfloat16 before its two bfloat16 GEMMs; the reference
    takes them at float32);
  * one AdamW step (``train_step`` against ``adamw.apply`` after the
    reference's gradient, lr 1e-2): the loss within rtol 1e-5, params
    within rtol 1e-4 and atol 1e-4, moments within the gradients' bound
    and its square;
  * the train CLI's losses (plain, ``--compress int8``, and a run resumed
    from its checkpoint) against the reference CLI's within rtol 1e-4.
Bit for bit: the three ``remat`` settings, ``mm_f32``'s Function against
autograd of the widened product (for a cotangent that bfloat16 holds
exactly), the token embedding's gradient against the ordered plain sum,
and the module's step against the function's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import layers as RL
from repro.models import moe as RMoE
from repro.models import transformer as RM
from repro.optim import adamw as RA
from repro_torch.configs import get_arch
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference)
from repro_torch.kernels.embedding_bag import grad as bag_grad
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as M
from repro_torch.optim import adamw as A
from repro_torch.pytree import flatten_with_path, leaves, tree_map

LM_ARCHS = ["qwen2-7b", "yi-6b", "qwen1.5-32b", "deepseek-v2-236b",
            "llama4-maverick-400b-a17b"]
DENSE_ARCHS = LM_ARCHS[:3]
MOE_ARCHS = LM_ARCHS[3:]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
BF16_REL = 2.0 ** -5
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(lr=1e-2, warmup_steps=1)


def _set_dtypes(name):
    RL.set_dtypes(getattr(jnp, name), getattr(jnp, name))
    L.set_dtypes(getattr(torch, name), getattr(torch, name))


@pytest.fixture
def restore_dtypes():
    """Both packages' global dtypes as they were before the test (the
    reference's conftest pins float32 for the session; the CLIs set
    float32 under ``--smoke``)."""
    saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    try:
        yield
    finally:
        RL.set_dtypes(*saved[0])
        L.set_dtypes(*saved[1])


@pytest.fixture
def float32(restore_dtypes):
    _set_dtypes("float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _model(arch, seed=0, **changes):
    cfg = dataclasses.replace(get_arch(arch).smoke_config, **changes)
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke_config, **changes)
    ref = RM.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return cfg, ref_cfg, ref, params_from_reference(_np(ref))


def _batch(vocab, seed, shape=(2, 16)):
    return {"tokens": _tokens(vocab, shape, seed),
            "targets": _tokens(vocab, shape, seed + 1)}


def _ref_value_and_grad(ref_cfg, ref, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(ref_cfg, p, b), has_aux=True))
    (loss, _), grads = fn(ref, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, grads


def _by_path(tree):
    return {"/".join(path): t for path, t in flatten_with_path(tree)}


def _ref_by_path(tree):
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_close(got, want, dtype="float32"):
    """Every leaf of the port's gradient tree against the reference's
    (module docstring's bounds)."""
    got, want = _by_path(got), _ref_by_path(want)
    assert set(got) == set(want)
    scale = max(float(np.max(np.abs(_f32(w)))) for w in want.values())
    for name, w in want.items():
        g, w = _f32(got[name]), _f32(w)
        assert g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_REL * scale,
                                       err_msg=name)
        else:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= BF16_REL, (name, err)


# ---------------------------------------------------------------------------
# the float32-accumulating product's Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [((5, 7), (7, 3)),
                                    ((2, 5, 7), (2, 7, 3))])
def test_mm_f32_function_against_autograd_of_the_widened_product(shapes):
    """For a bfloat16 pair: the float32 product, and gradients equal bit
    for bit to autograd of ``a.float() @ b.float()`` for a cotangent that
    bfloat16 holds exactly (the Function rounds the cotangent to the other
    operand's dtype, here without loss), each in its operand's dtype."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(shapes[0], generator=gen).bfloat16().requires_grad_()
    b = torch.randn(shapes[1], generator=gen).bfloat16().requires_grad_()
    out_shape = shapes[0][:-1] + shapes[1][-1:]
    cot = torch.randn(out_shape, generator=gen).bfloat16().float()
    got = L.mm_f32(a, b)
    assert got.dtype == torch.float32
    ga, gb = torch.autograd.grad(got, (a, b), cot)
    a2 = a.detach().requires_grad_()
    b2 = b.detach().requires_grad_()
    want = a2.float() @ b2.float()
    wa, wb = torch.autograd.grad(want, (a2, b2), cot)
    assert torch.equal(got, want)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa) and torch.equal(gb, wb)
    # a cotangent bfloat16 does not hold: rounded once, then the same
    full = torch.randn(out_shape, generator=gen)
    ga, gb = torch.autograd.grad(L.mm_f32(a, b), (a, b), full)
    wa, wb = torch.autograd.grad(a2.float() @ b2.float(), (a2, b2),
                                 full.bfloat16().float())
    assert torch.equal(ga, wa) and torch.equal(gb, wb)


def test_mm_f32_of_a_float32_pair_is_the_plain_product():
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(4, 6, generator=gen, requires_grad=True)
    b = torch.randn(6, 5, generator=gen, requires_grad=True)
    got = L.mm_f32(a, b)
    assert got.grad_fn.name() == "MmBackward0"
    assert torch.equal(got, a @ b)
    y = L.mm_as(a.bfloat16(), b.bfloat16(), torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.requires_grad


# ---------------------------------------------------------------------------
# the loss's gradient against jax.value_and_grad
# ---------------------------------------------------------------------------

def _grad_cases():
    return [(a, "float32", False) for a in LM_ARCHS] + \
        [("qwen2-7b", "float32", True)] + \
        [(a, "bfloat16", False) for a in DENSE_ARCHS]


@pytest.mark.parametrize("arch,dtype,tied", _grad_cases(),
                         ids=[f"{a}-{d}{'-tied' if t else ''}"
                              for a, d, t in _grad_cases()])
def test_loss_and_grads_match_reference(restore_dtypes, arch, dtype, tied):
    """Every gradient of ``loss_fn`` against the reference's, at float32
    for the five smoke configs (and qwen2-7b's with tied embeddings: the
    table's gradient is the embedding's ordered sum plus the head's GEMM),
    at bfloat16 for the three dense ones."""
    _set_dtypes(dtype)
    cfg, ref_cfg, ref, port = _model(arch, seed=2,
                                     **({"tie_embeddings": True}
                                        if tied else {}))
    batch = _batch(cfg.vocab, 40)
    want_loss, want = _ref_value_and_grad(ref_cfg, ref, batch)
    loss, metrics, grads = L.value_and_grad(
        lambda p: M.loss_fn(cfg, p, batch), port)
    assert loss.dtype == torch.float32 and "nll" in metrics
    rtol = LOSS_RTOL if dtype == "float32" else BF16_REL
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=rtol)
    assert_grads_close(grads, want, dtype)
    for name, g in _by_path(grads).items():
        assert g.dtype == _by_path(port)[name].dtype, name


MOE_FORMS = {"gathered": (RMoE.moe_ffn_gathered, MoE.moe_ffn_gathered),
             "gathered_sort": (RMoE.moe_ffn_sorted, MoE.moe_ffn_sorted)}


@pytest.mark.parametrize("n_e,k,n_shared", [(4, 1, 1), (6, 3, 2)])
@pytest.mark.parametrize("form", sorted(MOE_FORMS))
def test_capacity_moe_grads_match_reference(float32, form, n_e, k,
                                            n_shared):
    """The capacity forms' gradients in x and every param, with most
    tokens routed to one expert past its capacity (routes dropped),
    against ``jax.grad`` of the reference's form."""
    d, f = 24, 16
    ref = RL.materialize(RMoE.moe_shapes(d, f, n_e, n_shared),
                         jax.random.PRNGKey(13))
    r = np.asarray(ref["router"]).copy()
    r[:, 1] += 0.6
    ref["router"] = jnp.asarray(r)
    port = params_from_reference(_np(ref))
    x = np.random.default_rng(14).standard_normal((3, 16, d)).astype(
        np.float32)
    cot = np.random.default_rng(15).standard_normal((3, 16, d)).astype(
        np.float32)
    ref_fn, port_fn = MOE_FORMS[form]

    def ref_obj(p, xx):
        out, aux = ref_fn(p, xx, k)
        return jnp.sum(out * cot) + aux

    want_gp, want_gx = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(
        ref, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    live = tree_map(lambda t: t.detach().requires_grad_(), port)
    out, aux = port_fn(live, xt, k)
    obj = torch.sum(out * torch.from_numpy(cot)) + aux
    grads = torch.autograd.grad(obj, [xt] + leaves(live))
    assert_grads_close({"x": grads[0], **dict(zip(
        ["/".join(p) for p, _ in flatten_with_path(live)], grads[1:]))},
        {"x": want_gx, **want_gp})
    # routes were dropped at capacity
    _, _, top_i = MoE.route(port, torch.from_numpy(x), k)
    cap = MoE._capacity(16, k, n_e, 1.25)
    assert not bool((MoE._ranks_cumsum(top_i.reshape(3, 16 * k), n_e)
                     < cap).all())


@pytest.mark.parametrize("impl", sorted(MOE_FORMS))
def test_capacity_model_grads_match_reference(restore_dtypes, impl):
    """deepseek-v2's smoke config on a capacity form (its own is the dense
    form), routes dropped at the default capacity factor: every gradient
    against the reference's."""
    _set_dtypes("float32")
    arch = "deepseek-v2-236b"
    cfg, ref_cfg, ref, port = _model(arch, seed=3, moe_impl=impl)
    batch = _batch(cfg.vocab, 42)
    want_loss, want = _ref_value_and_grad(ref_cfg, ref, batch)
    log = []
    route = MoE.route

    def recorded(p, x, kk):
        res = route(p, x, kk)
        log.append(res[2].detach())
        return res

    MoE.route = recorded
    try:
        loss, _, grads = L.value_and_grad(
            lambda p: M.loss_fn(cfg, p, batch), port)
    finally:
        MoE.route = route
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert_grads_close(grads, want)
    b, s = batch["tokens"].shape
    cap = MoE._capacity(s, cfg.top_k, cfg.n_experts, 1.25)
    dropped = sum(int((MoE._ranks_cumsum(t.reshape(b, s * cfg.top_k),
                                         cfg.n_experts) >= cap).sum())
                  for t in log)
    assert log and dropped > 0


# ---------------------------------------------------------------------------
# remat, the embedding's gradient, the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_settings_give_equal_bits(float32, arch):
    cfg = get_arch(arch).smoke_config
    assert cfg.remat == "layer"
    params = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    batch = _batch(cfg.vocab, 44)
    runs = {}
    for remat in ("none", "layer", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = L.value_and_grad(lambda p: M.loss_fn(c, p, batch),
                                          params)
        runs[remat] = [loss] + leaves(grads)
    for remat in ("layer", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(runs[remat], runs["none"])), remat


def test_remat_rejects_an_unknown_setting(float32):
    cfg = dataclasses.replace(get_arch("yi-6b").smoke_config, remat="all")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat"):
        L.value_and_grad(lambda p: M.loss_fn(cfg, p, _batch(cfg.vocab, 1)),
                         params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_gradient_is_the_ordered_sum(restore_dtypes, dtype):
    """The table's gradient is the plain ordered sum of the embedded rows'
    cotangents by token id (float32, in token order, rounded once to the
    table's dtype), the sum the kernel equals bit for bit on the card; a
    Zipfian batch repeats ids, as ``TokenStream``'s does."""
    from repro_torch.data.tokens import TokenStream
    _set_dtypes(dtype)
    cfg = get_arch("qwen2-7b").smoke_config
    params = M.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    batch = TokenStream(cfg.vocab, seed=1).batch(4, 32)
    seen = []
    backward = bag_grad.embedding_bag_backward

    def recorded(grad_out, idx, v, dt, order=None):
        seen.append((grad_out, idx, v, dt))
        return backward(grad_out, idx, v, dt, order=order)

    bag_grad.embedding_bag_backward = recorded
    try:
        _, _, grads = L.value_and_grad(lambda p: M.loss_fn(cfg, p, batch),
                                       params)
    finally:
        bag_grad.embedding_bag_backward = backward
    assert len(seen) == 1
    grad_out, idx, v, dt = seen[0]
    assert grad_out.dtype == torch.float32 and dt == params["embed"].dtype
    assert v == cfg.vocab and idx.shape == (4 * 32, 1)
    np.testing.assert_array_equal(idx[:, 0].numpy(),
                                  batch["tokens"].reshape(-1))
    want = torch.zeros((v, cfg.d_model), dtype=torch.float64)
    for row, tok in zip(grad_out.double(), idx[:, 0].tolist()):
        want[tok] += row
    assert torch.equal(grads["embed"], bag_grad.embedding_bag_backward_ref(
        grad_out, idx, v, dt))
    np.testing.assert_allclose(grads["embed"].double().numpy(),
                               want.to(dt).double().numpy(),
                               rtol=2.0 ** -7 if dtype == "bfloat16"
                               else 1e-6, atol=1e-7)
    assert bool((np.bincount(batch["tokens"].reshape(-1)) > 1).any())


def test_train_step_matches_the_reference_step(float32):
    """One ``train_step`` from the reference's params and a non-zero
    optimizer state against ``jax.value_and_grad`` + ``adamw.apply``."""
    cfg, ref_cfg, ref, port = _model("yi-6b", seed=7)
    opt_cfg, ref_opt_cfg = A.AdamWConfig(**OPT), RA.AdamWConfig(**OPT)
    first, batch = _batch(cfg.vocab, 46), _batch(cfg.vocab, 48)
    _, g0 = _ref_value_and_grad(ref_cfg, ref, first)
    ref, ref_opt, _ = RA.apply(ref_opt_cfg, ref, g0, RA.init(ref))
    port = params_from_reference(_np(ref))
    opt = opt_state_from_reference(RA.OptState(
        np.asarray(ref_opt.step), _np(ref_opt.m), _np(ref_opt.v)))
    want_loss, g1 = _ref_value_and_grad(ref_cfg, ref, batch)
    want_p, want_o, want_m = RA.apply(ref_opt_cfg, ref, g1, ref_opt)
    got_p, got_o, m = M.train_step(cfg, opt_cfg, port, opt, batch)
    assert got_p is port and got_o is opt          # in place
    np.testing.assert_allclose(float(m["loss"]), float(want_loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=GRAD_RTOL)
    assert int(got_o.step) == int(want_o.step) == 2
    for name, w in _ref_by_path(want_p).items():
        np.testing.assert_allclose(_f32(_by_path(got_p)[name]), _f32(w),
                                   err_msg=name, **STEP_TOL)
    scale_m = max(float(np.max(np.abs(_f32(w))))
                  for w in jax.tree_util.tree_leaves(want_o.m))
    for got, want, scale in ((got_o.m, want_o.m, scale_m),
                             (got_o.v, want_o.v, scale_m ** 2)):
        for name, w in _ref_by_path(want).items():
            np.testing.assert_allclose(
                _f32(_by_path(got)[name]), _f32(w), rtol=GRAD_RTOL,
                atol=GRAD_ATOL_REL * scale, err_msg=name)


def test_module_step_equals_the_function_step(float32):
    cfg = get_arch("deepseek-v2-236b").smoke_config
    lm = M.LM(cfg, generator=torch.Generator().manual_seed(8), device="cpu")
    params = tree_map(torch.clone, lm.param_tree())
    opt_cfg = A.AdamWConfig(**OPT)
    batch = _batch(cfg.vocab, 50)
    opt_m = A.init(lm.param_tree())
    opt_f = A.init(params)
    opt_m, mm = lm.train_step(opt_cfg, opt_m, batch)
    _, opt_f, mf = M.train_step(cfg, opt_cfg, params, opt_f, batch)
    assert torch.equal(mm["loss"], mf["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(leaves((lm.param_tree(), opt_m)), leaves((params, opt_f))))
    assert not all(torch.equal(a, b) for a, b in zip(
        leaves(lm.param_tree()), leaves(M.init_params(
            cfg, torch.Generator().manual_seed(8), "cpu"))))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

CLI_ARGV = ["--arch", "qwen2-7b", "--smoke", "--steps", "15", "--batch", "4",
            "--seq", "64", "--log-every", "100"]


def _from_reference_init(monkeypatch):
    """The CLI's init_params replaced by the reference's PRNGKey(0) params
    of the same config (what the reference's CLI starts from)."""
    def init(cfg, gen, device):
        ref_cfg = ref_get_arch(cfg.name.replace("-smoke", "")).smoke_config
        return params_from_reference(
            _np(RM.init_params(ref_cfg, jax.random.PRNGKey(0))), device)
    monkeypatch.setattr(M, "init_params", init)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_cli_losses_match_the_reference(monkeypatch, restore_dtypes,
                                        compress):
    """``--arch qwen2-7b --smoke --steps 15 --batch 4 --seq 64`` (the
    reference's ``test_lm_loss_decreases``): the losses fall, and equal
    the reference CLI's from the same params and batches."""
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main
    argv = CLI_ARGV + ["--compress", compress]
    want = ref_main(argv)
    _from_reference_init(monkeypatch)
    got = main(argv + ["--torch-device", "cpu"])
    assert len(got) == len(want) == 15
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cli_resume_continues_as_the_reference(monkeypatch, restore_dtypes,
                                               tmp_path, capsys):
    """8 steps with a checkpoint, then ``--resume`` to 15, in each
    package: the resumed run restores step 8's params and optimizer state
    and its losses equal the reference's resumed run's."""
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main
    argv = CLI_ARGV[:4] + ["8"] + CLI_ARGV[5:]
    want = [ref_main(argv + ["--ckpt-dir", str(tmp_path / "ref")]),
            ref_main(CLI_ARGV + ["--ckpt-dir", str(tmp_path / "ref"),
                                 "--resume"])]
    _from_reference_init(monkeypatch)
    port = argv + ["--ckpt-dir", str(tmp_path / "port"), "--torch-device",
                   "cpu"]
    got = [main(port), main(CLI_ARGV + port[len(argv):] + ["--resume"])]
    assert "resumed from step 8" in capsys.readouterr().out
    assert [len(x) for x in got] == [len(x) for x in want] == [8, 7]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4)


def test_train_cli_defaults_to_the_card(restore_dtypes):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    from repro_torch.launch.train import main
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction, flags.allow_tf32
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen2-7b", "--smoke", "--steps", "1"])
    # the matmul flags the lm branch turns off are restored
    assert (flags.allow_bf16_reduced_precision_reduction,
            flags.allow_tf32) == saved
