"""repro_torch's LM family against the reference's, on the CPU.

The port's ``models.layers`` (RMSNorm, SwiGLU, RoPE, GQA and MLA
attention), ``models.moe`` (the dense, gathered and sorted dispatch forms)
and ``models.transformer`` (``forward``, ``loss_fn``, ``prefill``,
``decode_step``) run the reference's materialized params, carried across
bit for bit by ``convert.params_from_reference`` (caches by
``convert.cache_from_reference``), on inputs made with numpy from fixed
seeds. Tolerances:
  * float32 (both packages' ``set_dtypes(float32, float32)``): within
    rtol 1e-5 and an atol of 1e-5 × the largest |value| of the reference's
    result; the RoPE frequencies bit for bit;
  * bfloat16 params and activations (the three dense archs; JAX's CPU
    backend cannot run the MoE archs' bf16 × bf16 → f32 dots): float32
    logits within 2^-5 × the row's largest |logit|, the bfloat16 layer
    outputs and caches within 2 bfloat16 ulps of each value, or of the
    tensor's largest |value| (the same products accumulated in float32 in
    another order, each rounded once to bfloat16: a one-ulp difference in
    a layer's input carries into every sum of the next);
  * greedy ``generate`` equal token for token.
The capacity forms must drop exactly the reference's routes: one case
routes most tokens to one expert, past its capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.serve import generate as ref_generate
from repro.models import layers as RL
from repro.models import moe as RMoE
from repro.models import transformer as RM
from repro_torch.configs import get_arch
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.launch.serve import generate
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as M
from repro_torch.pytree import flatten_with_path

LM_ARCHS = ["qwen2-7b", "yi-6b", "qwen1.5-32b", "deepseek-v2-236b",
            "llama4-maverick-400b-a17b"]
DENSE_ARCHS = LM_ARCHS[:3]
F32_RTOL = 1e-5
BF16_LOGIT_REL = 2.0 ** -5
BF16_ULP = 2.0 ** -7


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request):
    """Both packages' global param/activation dtypes for one test, then
    back (the reference's conftest pins float32 for the session)."""
    ref_saved, port_saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    RL.set_dtypes(getattr(jnp, request.param), getattr(jnp, request.param))
    L.set_dtypes(getattr(torch, request.param), getattr(torch, request.param))
    try:
        yield request.param
    finally:
        RL.set_dtypes(*ref_saved)
        L.set_dtypes(*port_saved)


@pytest.fixture
def float32():
    ref_saved, port_saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    RL.set_dtypes(jnp.float32, jnp.float32)
    L.set_dtypes(torch.float32, torch.float32)
    try:
        yield
    finally:
        RL.set_dtypes(*ref_saved)
        L.set_dtypes(*port_saved)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_tree(tree):
    return params_from_reference(_np_tree(tree))


def assert_close(got, want, rtol=F32_RTOL, atol_rel=F32_RTOL):
    """float32: within rtol and atol_rel × the largest |want|."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = float(np.max(np.abs(w))) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * scale)


def assert_bf16_close(got, want, ulps=2):
    """bfloat16 results: within ``ulps`` bfloat16 ulps of |want|, or of
    the largest |want|."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = float(np.max(np.abs(w)))
    np.testing.assert_allclose(g, w, rtol=ulps * BF16_ULP,
                               atol=ulps * BF16_ULP * scale)


def assert_logits_close(got, want, dtype):
    if dtype == "float32":
        assert_close(got, want)
        return
    g, w = _f32(got), _f32(want)
    bound = BF16_LOGIT_REL * np.max(np.abs(w), axis=-1, keepdims=True)
    assert np.all(np.abs(g - w) <= bound), float(np.max(np.abs(g - w)
                                                         / bound))


def assert_tree_close(got, want, close):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        close(g, w)


def _materialize(shapes, seed):
    """The reference's init of ``shapes`` and the same params in the port."""
    ref = RL.materialize(shapes, jax.random.PRNGKey(seed))
    return ref, _port_tree(ref)


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _positions(b, s, start=0):
    pos = np.tile(np.arange(start, start + s, dtype=np.int32)[None], (b, 1))
    return jnp.asarray(pos), torch.from_numpy(pos)


# ---------------------------------------------------------------------------
# norms, activations, rotary embeddings
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference(dtype):
    rx, px = _x((3, 5, 48), 0, dtype)
    scale = np.random.default_rng(1).standard_normal(48).astype(np.float32)
    want = RL.rms_norm(rx, jnp.asarray(scale))
    got = L.rms_norm(px, torch.from_numpy(scale))
    assert got.dtype == getattr(torch, dtype)
    (assert_close if dtype == "float32" else assert_bf16_close)(got, want)


def test_swiglu_matches_reference(dtype):
    shapes = {"wi": ((32, 96), RL.PDTYPE), "wo": ((48, 32), RL.PDTYPE)}
    ref, port = _materialize(shapes, 2)
    rx, px = _x((7, 32), 3, dtype)
    want = RL.swiglu(rx, ref["wi"], ref["wo"])
    got = L.swiglu(px, port["wi"], port["wo"])
    (assert_close if dtype == "float32" else assert_bf16_close)(got, want)


@pytest.mark.parametrize("theta", [1e4, 1e6, 5e6])
@pytest.mark.parametrize("d_head", [16, 128])
def test_rope_matches_reference(theta, d_head):
    np.testing.assert_array_equal(L.rope_freqs(d_head, theta),
                                  RL.rope_freqs(d_head, theta))
    assert L.rope_freqs(d_head, theta).dtype == np.float32
    rx, px = _x((2, 9, 3, d_head), 4)
    rp, pp = _positions(2, 9, start=4090)
    assert_close(L.apply_rope(px, pp, theta), RL.apply_rope(rx, rp, theta))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

GQA_CASES = {
    "bias": dict(bias=True),
    "no_bias": dict(bias=False),
    "nope": dict(bias=False, use_rope=False),
    "chunk": dict(bias=True, chunk=4),
    "q_chunk": dict(bias=True, q_chunk=4),
    "chunk_q_chunk": dict(bias=False, chunk=8, q_chunk=4),
}


def _gqa_params(bias, seed=5, d=32, h=4, kv=2, dh=8):
    shapes = RL.attention_shapes(d, h, kv, dh, bias)
    ref, port = _materialize(shapes, seed)
    if bias:   # non-zero biases, so their add is exercised
        for k in ("bq", "bk", "bv"):
            b = np.random.default_rng(seed + 1).standard_normal(
                ref[k].shape).astype(np.float32)
            ref[k], port[k] = jnp.asarray(b), torch.from_numpy(b)
    return ref, port


@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_attention_matches_reference(case, float32):
    kw = dict(GQA_CASES[case])
    ref, port = _gqa_params(kw.pop("bias"))
    rx, px = _x((2, 16, 32), 6)
    rp, pp = _positions(2, 16)
    want, _ = RL.gqa_attention(ref, rx, rp, 4, 2, 8, theta=1e6, **kw)
    got, cache = L.gqa_attention(port, px, pp, 4, 2, 8, theta=1e6, **kw)
    assert cache is None
    assert_close(got, want)


@pytest.mark.parametrize("chunk", [None, 4])
def test_gqa_decode_against_a_converted_cache(chunk, float32):
    ref, port = _gqa_params(True)
    rng = np.random.default_rng(7)
    ck = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    rx, px = _x((2, 1, 32), 8)
    rp, pp = _positions(2, 1, start=9)
    want, (wk, wv) = RL.gqa_attention(
        ref, rx, rp, 4, 2, 8, chunk=chunk, kv_cache=(jnp.asarray(ck),
                                                     jnp.asarray(cv)),
        cache_len=jnp.int32(9))
    pk, pv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = L.gqa_attention(port, px, pp, 4, 2, 8, chunk=chunk,
                                    kv_cache=(pk, pv), cache_len=9)
    assert gk is pk and gv is pv          # written in place
    assert_close(got, want)
    assert_close(gk, wk)
    assert_close(gv, wv)
    # only position 9 changed
    np.testing.assert_array_equal(np.delete(gk.numpy(), 9, axis=1),
                                  np.delete(ck, 9, axis=1))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_DIMS = (4, 16, 12, 8, 4, 8)   # heads, q_lora, kv_lora, nope, rope, v


def _mla_params(seed=9, d=32):
    return _materialize(RL.mla_shapes(d, *MLA_DIMS), seed)


@pytest.mark.parametrize("q_chunk", [None, 4])
def test_mla_attention_matches_reference(q_chunk, float32):
    ref, port = _mla_params()
    rx, px = _x((2, 16, 32), 10)
    rp, pp = _positions(2, 16)
    want, _ = RL.mla_attention(ref, rx, rp, *MLA_DIMS, q_chunk=q_chunk)
    got, cache = L.mla_attention(port, px, pp, *MLA_DIMS, q_chunk=q_chunk)
    assert cache is None
    assert_close(got, want)


def test_mla_decode_against_a_converted_cache(float32):
    ref, port = _mla_params()
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((2, 10, 12)).astype(np.float32)
    kr = rng.standard_normal((2, 10, 4)).astype(np.float32)
    rx, px = _x((2, 1, 32), 12)
    rp, pp = _positions(2, 1, start=6)
    want, (wl, wr) = RL.mla_attention(
        ref, rx, rp, *MLA_DIMS, kv_cache=(jnp.asarray(lat), jnp.asarray(kr)),
        cache_len=jnp.int32(6))
    got, (gl, gr) = L.mla_attention(
        port, px, pp, *MLA_DIMS,
        kv_cache=(torch.from_numpy(lat.copy()), torch.from_numpy(kr.copy())),
        cache_len=6)
    assert_close(got, want)
    assert_close(gl, wl)
    assert_close(gr, wr)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_FORMS = {"dense": (RMoE.moe_ffn, MoE.moe_ffn),
             "gathered": (RMoE.moe_ffn_gathered, MoE.moe_ffn_gathered),
             "sorted": (RMoE.moe_ffn_sorted, MoE.moe_ffn_sorted)}


def _moe_params(n_e, n_shared, skew, seed=13, d=24, f=16):
    ref, port = _materialize(RMoE.moe_shapes(d, f, n_e, n_shared), seed)
    if skew:   # most tokens prefer expert 1: it overflows its capacity
        r = np.asarray(ref["router"]).copy()
        r[:, 1] += 0.6
        ref["router"], port["router"] = jnp.asarray(r), torch.from_numpy(r)
    return ref, port


def _ref_keep(ref, rx, k, n_e, cf=1.25):
    """The reference's kept routes (``moe.py:87-102``): ranks from the
    per-row cumsum of its own top-k."""
    b, s, _ = rx.shape
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", rx, ref["router"]), -1)
    _, top_i = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_i.reshape(b, s * k), n_e, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
    return np.asarray(pos < max(1, int(cf * s * k / n_e)))


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("form", sorted(MOE_FORMS))
@pytest.mark.parametrize("n_e,k,n_shared", [(4, 1, 1), (8, 2, 0),
                                            (6, 3, 2)])
def test_moe_forms_match_reference(form, n_e, k, n_shared, skew, float32):
    ref, port = _moe_params(n_e, n_shared, skew)
    rx, px = _x((3, 16, 24), 14)
    ref_fn, port_fn = MOE_FORMS[form]
    want, want_aux = ref_fn(ref, rx, k)
    got, aux = port_fn(port, px, k)
    assert_close(got, want)
    assert_close(aux, want_aux)
    if form == "dense":
        return
    # the same routes dropped as the reference's, by both rank rules
    keep = _ref_keep(ref, rx, k, n_e)
    _, _, top_i = MoE.route(port, px, k)
    flat_e = top_i.reshape(3, 16 * k)
    cap = MoE._capacity(16, k, n_e, 1.25)
    for ranks in (MoE._ranks_cumsum(flat_e, n_e), MoE._ranks_sorted(flat_e)):
        np.testing.assert_array_equal((ranks < cap).numpy(), keep)
    if skew:
        assert not keep.all()     # the case drops routes at capacity


def test_top_k_puts_the_lower_index_first_on_a_tie():
    probs = np.array([[0.1, 0.3, 0.3, 0.05, 0.3, 0.0],
                      [0.2, 0.2, 0.2, 0.2, 0.1, 0.1]], np.float32)
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = MoE.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_sorted_combine_adds_in_ascending_expert_order():
    """The sorted form's k contributions a token are added into zeros in
    ascending expert id, the gathered form's in rank order: with bfloat16
    rounding at every add the two can differ, and each equals its own
    order's sum bit for bit."""
    torch.manual_seed(0)
    d, n_e, k = 8, 4, 3
    p = {"router": torch.randn(d, n_e),
         "wi": torch.randn(n_e, d, 2 * d).bfloat16(),
         "wo": (torch.randn(n_e, d, d) * 30).bfloat16()}
    x = torch.randn(2, 8, d).bfloat16()
    _, top_w, top_i = MoE.route(p, x, k)
    outs = {}
    for name, fn in (("gathered", MoE.moe_ffn_gathered),
                     ("sorted", MoE.moe_ffn_sorted)):
        outs[name], _ = fn(p, x, k, capacity_factor=8.0)   # nothing drops
    for b in range(2):
        for t in range(8):
            terms = []
            for r in range(k):
                e = int(top_i[b, t, r])
                xe = x[b, t][None]
                h = L.mm_f32(xe, p["wi"][e])
                gate, up = torch.chunk(h, 2, dim=-1)
                act = (torch.nn.functional.silu(gate) * up).bfloat16()
                y = L.mm_f32(act, p["wo"][e]).bfloat16()[0]
                terms.append((e, top_w[b, t, r].bfloat16() * y))
            for name, order in (("gathered", terms),
                                ("sorted", sorted(terms, key=lambda z: z[0]))):
                acc = torch.zeros(d, dtype=torch.bfloat16)
                for _, c in order:
                    acc = acc + c
                assert torch.equal(outs[name][b, t], acc), (name, b, t)
    # the two orders round differently here, so each order is pinned
    assert not torch.equal(outs["gathered"], outs["sorted"])


# ---------------------------------------------------------------------------
# the whole model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------

def _model(arch, seed=0):
    cfg, ref_cfg = get_arch(arch).smoke_config, ref_get_arch(arch).smoke_config
    ref = RM.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return cfg, ref_cfg, ref, _port_tree(ref)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _cases():
    return [(a, "float32") for a in LM_ARCHS] + \
        [(a, "bfloat16") for a in DENSE_ARCHS]


@pytest.fixture
def model_dtype(request):
    """(arch, dtype) with both packages' dtypes set for the test."""
    arch, dt = request.param
    ref_saved, port_saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    RL.set_dtypes(getattr(jnp, dt), getattr(jnp, dt))
    L.set_dtypes(getattr(torch, dt), getattr(torch, dt))
    try:
        yield arch, dt
    finally:
        RL.set_dtypes(*ref_saved)
        L.set_dtypes(*port_saved)


def _close_for(dt):
    return assert_close if dt == "float32" else assert_bf16_close


@pytest.mark.parametrize("model_dtype", _cases(), indirect=True,
                         ids=[f"{a}-{d}" for a, d in _cases()])
def test_forward_and_loss_match_reference(model_dtype):
    arch, dt = model_dtype
    cfg, ref_cfg, ref, port = _model(arch)
    toks = _tokens(cfg.vocab, (2, 16), 20)
    tgts = _tokens(cfg.vocab, (2, 16), 21)
    want, want_aux = RM.forward(ref_cfg, ref, jnp.asarray(toks))
    got, aux = M.forward(cfg, port, toks)
    assert got.dtype == torch.float32
    assert_logits_close(got, want, dt)
    assert_close(aux, want_aux, atol_rel=1e-5)
    last, _ = M.forward(cfg, port, toks, last_only=True)
    assert_logits_close(last, want[:, -1], dt)
    (want_loss, want_m) = RM.loss_fn(ref_cfg, ref, {
        "tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    loss, m = M.loss_fn(cfg, port, {"tokens": toks, "targets": tgts})
    tol = F32_RTOL if dt == "float32" else BF16_LOGIT_REL
    for g, w in ((loss, want_loss), (m["nll"], want_m["nll"]),
                 (m["aux"], want_m["aux"])):
        np.testing.assert_allclose(float(g), float(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("model_dtype", _cases(), indirect=True,
                         ids=[f"{a}-{d}" for a, d in _cases()])
def test_prefill_and_decode_match_reference(model_dtype):
    arch, dt = model_dtype
    cfg, ref_cfg, ref, port = _model(arch, seed=1)
    toks = _tokens(cfg.vocab, (2, 12), 22)
    want_cache, want_last = RM.prefill(ref_cfg, ref, jnp.asarray(toks),
                                       max_len=16)
    cache, last = M.prefill(cfg, port, toks, max_len=16)
    assert_logits_close(last, want_last, dt)
    close = _close_for(dt)
    assert_tree_close(cache, want_cache, close)
    # decode from the reference's own cache, carried across
    port_cache = cache_from_reference(_np_tree(want_cache))
    rc, pc = want_cache, port_cache
    for i, pos in enumerate(range(12, 16)):
        tok = _tokens(cfg.vocab, (2, 1), 30 + i)
        want, rc = RM.decode_step(ref_cfg, ref, rc, jnp.asarray(tok),
                                  jnp.int32(pos))
        got, same = M.decode_step(cfg, port, pc, tok, pos)
        assert same is pc           # written in place
        assert_logits_close(got, want, dt)
    assert_tree_close(pc, rc, close)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_matches_reference_greedy(arch, float32):
    cfg, ref_cfg, ref, port = _model(arch, seed=3)
    prompts = _tokens(cfg.vocab, (2, 10), 40)
    want = ref_generate(ref_cfg, ref, prompts, 6)
    got = generate(cfg, port, prompts, 6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
class TestLMSmoke:
    """The reference's ``tests/test_models_smoke.py::TestLMSmoke`` serving
    cases, on the port with the reference's params and tokens."""

    def test_prefill_decode(self, arch, float32):
        cfg, _, _, params = _model(arch, seed=1)
        toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12),
                                             0, cfg.vocab))
        cache, logits = M.prefill(cfg, params, toks, max_len=16)
        assert logits.shape == (2, cfg.vocab)
        logits2, cache = M.decode_step(cfg, params, cache, toks[:, :1], 12)
        assert logits2.shape == (2, cfg.vocab)
        assert not bool(torch.any(torch.isnan(logits2)))

    def test_decode_consistency_with_forward(self, arch, float32):
        """Greedy decode after prefill matches teacher-forced forward."""
        cfg, _, _, params = _model(arch, seed=2)
        toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (1, 8),
                                             0, cfg.vocab))
        full_logits, _ = M.forward(cfg, params, toks)
        cache, last = M.prefill(cfg, params, toks[:, :-1], max_len=8)
        dec, _ = M.decode_step(cfg, params, cache, toks[:, -1:], 7)
        # prefill's last-token logits == forward logits at position -2
        np.testing.assert_allclose(last.numpy(), full_logits[:, -2].numpy(),
                                   rtol=2e-2, atol=2e-3)
        # and the decoded token's logits == forward's at the last position
        np.testing.assert_allclose(dec.numpy(), full_logits[:, -1].numpy(),
                                   rtol=2e-2, atol=2e-3)


def test_q_chunk_prefill_equals_unchunked(float32):
    import dataclasses
    for arch in ("qwen2-7b", "deepseek-v2-236b", "llama4-maverick-400b-a17b"):
        cfg, _, _, params = _model(arch, seed=4)
        toks = _tokens(cfg.vocab, (2, 32), 50)
        c0, l0 = M.prefill(cfg, params, toks)
        c1, l1 = M.prefill(dataclasses.replace(cfg, attn_q_chunk=8), params,
                           toks)
        assert_close(l1, l0)
        f0, _ = M.forward(cfg, params, toks)
        f1, _ = M.forward(dataclasses.replace(cfg, attn_q_chunk=8), params,
                          toks)
        assert_close(f1, f0)


def test_lm_module_equals_the_functions(float32):
    cfg = get_arch("deepseek-v2-236b").smoke_config
    lm = M.LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = lm.param_tree()
    assert set(params) == set(M.param_shapes(cfg))
    toks = _tokens(cfg.vocab, (2, 8), 60)
    want, _ = M.forward(cfg, params, toks)
    got, _ = lm(toks)
    assert torch.equal(got, want)
    cache, last = lm.prefill(toks, max_len=10)
    c2, l2 = M.prefill(cfg, params, toks, max_len=10)
    assert torch.equal(last, l2)
    d1, _ = lm.decode_step(cache, toks[:, :1], 8)
    d2, _ = M.decode_step(cfg, params, c2, toks[:, :1], 8)
    assert torch.equal(d1, d2)


def test_init_params_draws_the_reference_tree(float32):
    """The port's own init: the reference's tree of names and shapes, norm
    scales one and biases zero (its draws are torch's, not JAX's)."""
    arch = "llama4-maverick-400b-a17b"
    params = M.init_params(get_arch(arch).smoke_config,
                           torch.Generator().manual_seed(0), device="cpu")
    ref = RM.init_params(ref_get_arch(arch).smoke_config,
                         jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {"/".join(path): tuple(t.shape)
           for path, t in flatten_with_path(params)}
    assert got == want
    for path, t in flatten_with_path(params):
        if "norm" in path[-1]:
            assert torch.all(t == 1)
        elif path[-1] in ("bq", "bk", "bv"):
            assert torch.all(t == 0)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    cfg = get_arch("yi-6b").smoke_config
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.LM(cfg, generator=torch.Generator().manual_seed(0))
