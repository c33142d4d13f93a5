"""repro_torch.optim (AdamW, gradient compression) against the reference's
``repro.optim`` on the CPU.

The same trees, made with numpy from fixed seeds, go through both. At
float32 the two run the same float32 operations in the same order. Two
differ in the last bit: the global norm (the libraries reduce a tensor's
squares in different orders) and the schedule's cosine (two libm's). So
the norm, the schedule and every param and moment that went through a
clip or a cosine are held within rtol 1e-6 (a few float32 ulps), the
bias corrections and the warmup equal, and the int8 codes and residuals
equal. A bfloat16 param updates through float32 and is cast back in
both.
Also the reference's own ``TestAdamW`` and ``TestCompression`` cases, on
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compression as RC
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.pytree import flatten_with_path, leaves


def _tree(seed, shapes=(("w", (8, 4)), ("b", (4,)), ("a", (3, 2, 2)))):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes}


def _ref(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _port(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-9)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


CFGS = {
    "default": {},
    "warm1_lr1e-2": dict(lr=1e-2, warmup_steps=1),
    "no_decay_tight_clip": dict(lr=5e-2, weight_decay=0.0, clip_norm=0.1,
                                warmup_steps=3, total_steps=8),
}


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_apply_matches_reference(cfg_name):
    kw = CFGS[cfg_name]
    rcfg, pcfg = RA.AdamWConfig(**kw), A.AdamWConfig(**kw)
    p = _tree(0)
    rp, pp = _ref(p), _port(p)
    ro, po = RA.init(rp), A.init(pp)
    for i in range(6):
        g = _tree(10 + i)
        rp, ro, rm = RA.apply(rcfg, rp, _ref(g), ro)
        pp2, po2, pm = A.apply(pcfg, pp, _port(g), po)
        assert pp2 is pp and po2 is po          # updated in place
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert po.step.dtype == torch.int32 and int(po.step) == int(ro.step) == 6
    for k in p:
        _close(pp[k], rp[k])
        _close(po.m[k], ro.m[k])
        _close(po.v[k], ro.v[k])


def test_bf16_param_updates_through_float32_like_reference():
    p = _tree(1, (("w", (6, 5)), ("b", (5,))))
    rp, pp = _ref(p, jnp.bfloat16), _port(p, torch.bfloat16)
    ro, po = RA.init(rp), A.init(pp)
    assert all(m.dtype == torch.float32 for m in leaves(po.m))
    cfg = dict(lr=1e-2, warmup_steps=1)
    for i in range(3):
        g = _tree(20 + i, (("w", (6, 5)), ("b", (5,))))
        rp, ro, _ = RA.apply(RA.AdamWConfig(**cfg), rp, _ref(g, jnp.bfloat16),
                             ro)
        A.apply(A.AdamWConfig(**cfg), pp, _port(g, torch.bfloat16), po)
    for k in p:
        assert pp[k].dtype == torch.bfloat16
        _close(pp[k], rp[k])
        _close(po.m[k], ro.m[k])
        _close(po.v[k], ro.v[k])


@pytest.mark.parametrize("warmup,total", [(100, 10000), (10, 100), (0, 50),
                                          (5, 5)])
def test_schedule_and_bias_corrections_match_reference(warmup, total):
    kw = dict(lr=0.7, warmup_steps=warmup, total_steps=total)
    for s in list(range(0, 40)) + [99, 100, 101, 5000, 10000, 20000]:
        want = float(RA.schedule(RA.AdamWConfig(**kw), jnp.int32(s)))
        got = A.schedule(A.AdamWConfig(**kw), torch.tensor(s,
                                                           dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=s)
        if s < warmup:
            assert float(got) == want
        bc1, bc2 = A.bias_corrections(A.AdamWConfig(), torch.tensor(s))
        assert float(bc1) == float(1 - 0.9 ** jnp.float32(s))
        assert float(bc2) == float(1 - 0.95 ** jnp.float32(s))


def test_global_norm_and_clip_match_reference():
    g = _tree(3)
    want = float(RA.global_norm(_ref(g)))
    np.testing.assert_allclose(float(A.global_norm(_port(g))), want,
                               rtol=1e-6)
    for max_norm in (0.5, 1e9):
        rc, rn = RA.clip_by_global_norm(_ref(g), max_norm)
        pc, pn = A.clip_by_global_norm(_port(g), max_norm)
        np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(pc[k].numpy(), _np(rc[k]), rtol=1e-6)
        if max_norm > 1e6:
            for k in g:
                np.testing.assert_array_equal(pc[k].numpy(), g[k])


@pytest.mark.parametrize("shape,chunk", [((8, 4), 32), ((8, 4), 12),
                                         ((4, 6, 5), 7), ((4, 6, 5), 40),
                                         ((3, 2, 9), 4), ((11,), 3), ((), 1)])
def test_pieces_cover_every_element_once(shape, chunk):
    seen = torch.zeros(shape, dtype=torch.int64)
    at = A.pieces(shape, chunk)
    for i in at:
        assert seen[i].numel() <= max(chunk, 1)
        seen[i] += 1
    assert bool((seen == 1).all())
    assert (at == [()]) == (seen.numel() <= chunk)


def _whole_leaf_apply(cfg, params, grads, state):
    """``apply`` as it was before leaves were sliced: the clipped copy of
    every gradient first, then each leaf's update on the whole leaf."""
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in leaves(grads)))
        scale = torch.clamp(cfg.clip_norm / (norm + 1e-9), max=1.0)
        grads = [(g.to(torch.float32) * scale).to(g.dtype)
                 for g in leaves(grads)]
        state.step.add_(1)
        lr = A.schedule(cfg, state.step)
        bc1, bc2 = A.bias_corrections(cfg, state.step)
        b1, b2 = cfg.beta1, cfg.beta2
        for p, g, m, v in zip(leaves(params), grads, leaves(state.m),
                              leaves(state.v)):
            gf = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
    return norm


@pytest.mark.parametrize("chunk", [None, 7, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_update_gives_the_whole_leaf_bits(monkeypatch, dtype, chunk):
    """The sliced update against the whole-leaf one, bit for bit in every
    param and moment over three steps: at the default ``CHUNK`` (every
    leaf here, and every DLRM and GNN leaf, is one piece), and at chunks
    that cut leaves into rows and rows into slices, with a clip norm the
    gradients stay under (the slices' sums of squares add in another
    order, so the norm may differ in its last bits; its scale is then 1
    in both)."""
    if chunk is not None:
        monkeypatch.setattr(A, "CHUNK", chunk)
    shapes = (("w", (8, 4)), ("b", (4,)), ("a", (3, 2, 9)), ("s", ()))
    kw = dict(lr=1e-2, warmup_steps=1) if chunk is None else \
        dict(lr=1e-2, warmup_steps=1, clip_norm=1e6)
    cfg = A.AdamWConfig(**kw)
    got, want = _port(_tree(4, shapes), dtype), _port(_tree(4, shapes), dtype)
    go, wo = A.init(got), A.init(want)
    for i in range(3):
        g = _port(_tree(30 + i, shapes), dtype)
        _, _, m = A.apply(cfg, got, g, go)
        norm = _whole_leaf_apply(cfg, want, g, wo)
        if chunk is None:
            assert torch.equal(m["grad_norm"], norm)
        else:
            np.testing.assert_allclose(float(m["grad_norm"]), float(norm),
                                       rtol=1e-6)
    for a, b in zip(leaves((got, go)), leaves((want, wo))):
        assert torch.equal(a, b)


def test_trees_walk_in_the_reference_order():
    tree = ({"b": 1, "a": [2, {"z": 3, "y": 4}]},
            A.OptState(step=5, m={"k": 6}, v=None))
    got = [("/".join(p), x) for p, x in flatten_with_path(tree)]
    ref, _ = jax.tree_util.tree_flatten_with_path(
        ({"b": 1, "a": [2, {"z": 3, "y": 4}]},
         RA.OptState(step=5, m={"k": 6}, v=None)))
    from repro.checkpoint.manager import _path_str
    want = [("/".join(_path_str(q) for q in p), x) for p, x in ref]
    assert got == want


# ---------------------------------------------------------------------------
# the reference's TestAdamW, on the port
# ---------------------------------------------------------------------------

class TestAdamW:
    def test_converges_quadratic(self):
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
        target = torch.tensor([[1.0], [-2.0], [0.5], [3.0]])
        y = a @ target
        cfg = A.AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=5,
                            total_steps=400)
        p = {"w": torch.zeros((4, 1))}
        o = A.init(p)
        for _ in range(400):
            w = p["w"].detach().requires_grad_()
            (g,) = torch.autograd.grad(torch.mean((a @ w - y) ** 2), [w])
            p, o, m = A.apply(cfg, p, {"w": g}, o)
        np.testing.assert_allclose(p["w"].numpy(), target.numpy(), atol=0.05)

    def test_clip_global_norm(self):
        g = {"a": torch.full((10,), 100.0), "b": torch.full((10,), -100.0)}
        clipped, norm = A.clip_by_global_norm(g, 1.0)
        assert float(norm) > 400
        np.testing.assert_allclose(float(A.global_norm(clipped)), 1.0,
                                   rtol=1e-4)

    def test_schedule_shape(self):
        cfg = A.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
        lrs = [float(A.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
               for s in range(0, 101, 10)]
        assert lrs[0] == 0.0
        assert abs(lrs[1] - 1.0) < 1e-6          # end of warmup
        assert lrs[-1] == pytest.approx(0.1, rel=1e-3)  # floor
        assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))

    def test_bf16_params_updated_via_f32(self):
        p = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
        g = {"w": torch.full((4, 4), 1e-3, dtype=torch.bfloat16)}
        o = A.init(p)
        assert o.m["w"].dtype == torch.float32
        p2, o2, _ = A.apply(A.AdamWConfig(clip_norm=1e9), p, g, o)
        assert p2["w"].dtype == torch.bfloat16
        assert float(torch.sum(torch.abs(p2["w"].float()))) > 0


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_int8_codes_and_residuals_equal_reference(scale):
    shapes = (("w", (32, 32)), ("b", (7,)), ("c", (3, 5, 2)))
    ref_ef = RC.init_error_feedback(_ref(_tree(0, shapes)))
    ef = C.init_error_feedback(_port(_tree(0, shapes)))
    for i in range(4):
        g = {k: v * scale for k, v in _tree(30 + i, shapes).items()}
        rq, ref_ef = RC.compress_int8_ef(_ref(g), ref_ef)
        pq, ef = C.compress_int8_ef(_port(g), ef)
        for k in g:
            assert pq[k][0].dtype == torch.int8
            np.testing.assert_array_equal(pq[k][0].numpy(),
                                          np.asarray(rq[k][0]))
            assert float(pq[k][1]) == float(rq[k][1])
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(ref_ef[k]))
        back, rback = C.decompress_int8(pq), RC.decompress_int8(rq)
        for k in g:
            np.testing.assert_array_equal(back[k].numpy(),
                                          np.asarray(rback[k]))


def test_bf16_codec_equals_reference():
    g = _tree(4)
    want = RC.decompress_bf16(RC.compress_bf16(_ref(g)))
    packed = C.compress_bf16(_port(g))
    assert all(x.dtype == torch.bfloat16 for x in packed.values())
    got = C.decompress_bf16(packed)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_int8_rounds_half_to_even():
    # 2.5 and -0.5 code units: jnp.round and torch.round both go to even
    g = {"w": torch.tensor([127.0, 2.5, -0.5, 3.5])}
    packed, _ = C.compress_int8_ef(g, C.init_error_feedback(g))
    q, s = packed["w"]
    assert float(s) == 1.0
    assert q.tolist() == [127, 2, 0, 4]


class TestCompression:
    def test_bf16_roundtrip_small_error(self):
        rng = np.random.default_rng(1)
        g = {"w": torch.from_numpy(rng.standard_normal((64, 64))
                                   .astype(np.float32))}
        back = C.decompress_bf16(C.compress_bf16(g))
        assert float(torch.max(torch.abs(back["w"] - g["w"]))) < 0.02

    def test_int8_error_feedback_accumulates(self):
        rng = np.random.default_rng(2)
        g = {"w": torch.from_numpy((rng.standard_normal((32, 32)) * 1e-3)
                                   .astype(np.float32))}
        ef = C.init_error_feedback(g)
        total = torch.zeros_like(g["w"])
        n = 50
        for _ in range(n):
            packed, ef = C.compress_int8_ef(g, ef)
            total = total + C.decompress_int8(packed)["w"]
        np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                                   atol=2e-5)

    def test_int8_single_shot_bounded_error(self):
        g = {"w": torch.from_numpy(np.linspace(-1, 1, 256)
                                   .astype(np.float32))}
        ef = C.init_error_feedback(g)
        packed, ef2 = C.compress_int8_ef(g, ef)
        back = C.decompress_int8(packed)
        assert float(torch.max(torch.abs(back["w"] - g["w"]))) \
            <= 1.0 / 127.0 + 1e-6
        np.testing.assert_allclose(ef2["w"].numpy(),
                                   (g["w"] - back["w"]).numpy(), atol=1e-7)
