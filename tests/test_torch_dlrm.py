"""repro_torch's DLRM serving path against the reference's, on the CPU.

The port's ``models.dlrm`` (``forward``, ``serve_step``,
``retrieval_score`` and the value of ``loss_fn``) runs the reference's
materialized ``SMOKE_CONFIG`` params, carried across bit for bit by
``convert.params_from_reference``, on batches made with numpy from
fixed seeds, at float32 tables (the reference's CPU default, set by
``tests/conftest.py``) and at bfloat16 tables (the reference's own
``layers.PDTYPE``, set inside the test and restored after). Tolerances:
logits, scores and the loss within atol 1e-5 and rtol 1e-5 (the same
float32 products and sums, taken in another order); the top-100 indices
equal. On CPU tensors ``embedding_bag`` runs its plain version; the card's
kernels are held to it by ``chip_smoke.py``.

Also: the Criteo-like batches bit for bit, the config registry's param
and input shapes and dtypes, ``params_count``, the table row-sharding
over a list of CPU devices, and the init rule.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import input_specs as ref_input_specs
from repro.configs.dlrm_mlperf import CONFIG as REF_CONFIG
from repro.configs.dlrm_mlperf import SMOKE_CONFIG as REF_SMOKE
from repro.data.recsys import CriteoLikeGenerator as RefCriteo
from repro.models import dlrm as RM
from repro.models import layers as RL
from repro_torch.configs import (all_arch_ids, config_for_shape, get_arch,
                                 input_specs)
from repro_torch.configs.base import RECSYS_SHAPES
from repro_torch.configs.dlrm_mlperf import CONFIG, SMOKE_CONFIG
from repro_torch.convert import params_from_reference
from repro_torch.data.recsys import CriteoLikeGenerator
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models import dlrm as M
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (dlrm_param_placement,
                                           table_row_block)

RTOL = ATOL = 1e-5
TABLE_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _batch(cfg, b, seed, candidates=0):
    """dense, sparse (indices up to 1.2 V of the largest field: some past
    V, which both sides clamp to V - 1), labels; optional candidates."""
    rng = np.random.default_rng(seed)
    hi = int(max(cfg.table_sizes) * 1.2)
    out = {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
           "sparse": rng.integers(0, hi, (b, cfg.n_sparse, cfg.hot))
           .astype(np.int32),
           "labels": rng.integers(0, 2, b).astype(np.float32)}
    if candidates:
        out["candidates"] = rng.standard_normal(
            (candidates, cfg.embed_dim)).astype(np.float32)
    return out


def _ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _models(seed=0):
    """The reference's params under the current dtypes and the port's
    copy of them."""
    rp = RM.init_params(REF_SMOKE, jax.random.PRNGKey(seed))
    pp = params_from_reference({k: np.asarray(v) for k, v in rp.items()})
    return rp, pp


def test_params_cross_bit_for_bit(table_dtype):
    rp, pp = _models()
    for name, value in rp.items():
        arr = np.asarray(value)
        got = pp[name]
        assert tuple(got.shape) == arr.shape
        if arr.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                arr.view(np.uint16))
        else:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), arr)
    assert pp["table0"].dtype == TABLE_DTYPES[table_dtype][1]


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(table_dtype, seed):
    rp, pp = _models(seed)
    batch = _batch(SMOKE_CONFIG, 32, seed)
    want = np.asarray(RM.forward(REF_SMOKE, rp, _ref(batch)))
    got = M.forward(SMOKE_CONFIG, pp, batch)
    assert got.dtype == torch.float32 and got.shape == (32,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_serve_step_matches_reference(table_dtype):
    rp, pp = _models()
    batch = _batch(SMOKE_CONFIG, 16, 3)
    want = np.asarray(RM.serve_step(REF_SMOKE, rp, _ref(batch)))
    got = M.serve_step(SMOKE_CONFIG, pp, batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert bool(((got >= 0) & (got <= 1)).all())


def test_loss_value_matches_reference(table_dtype):
    rp, pp = _models()
    batch = _batch(SMOKE_CONFIG, 64, 5)
    want, want_m = RM.loss_fn(REF_SMOKE, rp, _ref(batch))
    got, got_m = M.loss_fn(SMOKE_CONFIG, pp, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    assert float(got_m["bce"]) == float(got)


@pytest.mark.parametrize("n_candidates", [300, 64])
def test_retrieval_matches_reference(table_dtype, n_candidates):
    rp, pp = _models()
    q = {k: v[:1] for k, v in _batch(SMOKE_CONFIG, 4, 7).items()}
    q["candidates"] = np.random.default_rng(1).standard_normal(
        (n_candidates, SMOKE_CONFIG.embed_dim)).astype(np.float32)
    ts, ti = RM.retrieval_score(REF_SMOKE, rp, _ref(q))
    gs, gi = M.retrieval_score(SMOKE_CONFIG, pp, q)
    k = min(100, n_candidates)
    assert gi.shape == gs.shape == (1, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ti))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ts), rtol=RTOL,
                               atol=ATOL)
    assert bool((gs[0, 1:] <= gs[0, :-1]).all())


def test_lookup_clamps_past_v_to_the_last_row():
    """An index >= V reads row V - 1, as the reference's jnp.minimum
    clamp does (the kernel alone would take it for an empty slot)."""
    _, pp = _models()
    batch = _batch(SMOKE_CONFIG, 8, 9)
    sparse = torch.from_numpy(batch["sparse"])
    last = torch.tensor([v - 1 for v in SMOKE_CONFIG.table_sizes],
                        dtype=torch.int32).view(1, -1, 1)
    past = sparse.clone()
    past[:, :, 0] = torch.tensor(SMOKE_CONFIG.table_sizes) + 5
    at = sparse.clone()
    at[:, :, 0] = last[:, :, 0]
    for a, b in zip(M.embedding_lookups(SMOKE_CONFIG, pp, past),
                    M.embedding_lookups(SMOKE_CONFIG, pp, at)):
        assert torch.equal(a, b)


def test_use_kernels_false_is_the_same_function_on_the_cpu(table_dtype):
    _, pp = _models()
    batch = _batch(SMOKE_CONFIG, 16, 11)
    before = {m: c.n for m, c in bag_ops.LAUNCHES.items()}
    a = M.serve_step(SMOKE_CONFIG, pp, batch)
    b = M.serve_step(SMOKE_CONFIG, pp, batch, use_kernels=False)
    assert torch.equal(a, b)
    assert {m: c.n for m, c in bag_ops.LAUNCHES.items()} == before


def test_module_idiom_equals_the_functions():
    _, pp = _models()
    batch = _batch(SMOKE_CONFIG, 8, 13)
    model = M.DLRM(SMOKE_CONFIG, pp)
    assert torch.equal(model(batch), M.forward(SMOKE_CONFIG, pp, batch))
    assert torch.equal(model.serve_step(batch),
                       M.serve_step(SMOKE_CONFIG, pp, batch))
    assert not any(p.requires_grad for p in model.parameters())
    own = M.DLRM(SMOKE_CONFIG, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    assert set(dict(own.params)) == set(pp)


# ---------------------------------------------------------------------------
# sharding over a device list
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,n,sharded", [
    ((100, 50, 20, 7), 4, (0, 2)),
    ((96, 50, 21, 7), 4, (0,)),
    ((96, 50, 21, 7), 3, (0, 2)),
    ((100, 50, 20, 7), 3, ()),
])
@pytest.mark.parametrize("hot", [1, 3])
def test_sharded_serve_step_equals_unsharded(sizes, n, sharded, hot):
    """Row-sharded over ["cpu"] * n: the tables whose V divides by n are
    cut into n row blocks, the others replicated; the scores equal the
    unsharded ones (bit for bit at hot = 1, where each bag is one row;
    within 1e-6 at hot = 3, where the partial bags add in another
    order)."""
    cfg = dataclasses.replace(SMOKE_CONFIG, table_sizes=sizes, hot=hot)
    params = M.init_params(cfg, torch.Generator().manual_seed(n),
                           device="cpu")
    devices = ["cpu"] * n
    sh = dlrm_param_placement(params, devices)
    for t, v in enumerate(sizes):
        blocks = sh[f"table{t}"]
        assert len(blocks) == n
        if t in sharded:
            assert table_row_block(v, n) == v // n
            assert all(b.shape == (v // n, cfg.embed_dim) for b in blocks)
            for i, b in enumerate(blocks):     # views, not copies
                assert b.data_ptr() == params[f"table{t}"][i * (v // n)] \
                    .data_ptr()
        else:
            assert table_row_block(v, n) == 0
            assert all(b is params[f"table{t}"] for b in blocks)
    assert all(x is params["bot_w0"] for x in sh["bot_w0"])
    batch = _batch(cfg, 40, n + hot)
    want = M.serve_step(cfg, params, batch)
    got = M.serve_step(cfg, sh, batch, devices=devices)
    if hot == 1:
        assert torch.equal(got, want)
        for a, b in zip(M.embedding_lookups(cfg, sh,
                                            torch.from_numpy(batch["sparse"]),
                                            devices=devices),
                        M.embedding_lookups(
                            cfg, params, torch.from_numpy(batch["sparse"]))):
            assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    q = {k: v[:1] for k, v in batch.items()}
    q["candidates"] = np.random.default_rng(0).standard_normal(
        (50, cfg.embed_dim)).astype(np.float32)
    ws, wi = M.retrieval_score(cfg, params, q)
    gs, gi = M.retrieval_score(cfg, sh, q, devices=devices)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_allclose(gs.numpy(), ws.numpy(), atol=1e-6)


def test_sharded_reference_params_match_reference(table_dtype):
    """The reference's params, sharded over four CPU devices, give the
    reference's scores."""
    rp, pp = _models()
    batch = _batch(SMOKE_CONFIG, 16, 17)
    want = np.asarray(RM.serve_step(REF_SMOKE, rp, _ref(batch)))
    sh = dlrm_param_placement(pp, ["cpu"] * 4)
    got = M.serve_step(SMOKE_CONFIG, sh, batch, devices=["cpu"] * 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# data, configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,hot,seed", [
    ((100, 50, 20), 2, 0), (REF_CONFIG.table_sizes, 1, 3),
    ((7, 1000, 3, 40_000_000), 3, 11)])
def test_criteo_batches_equal_reference_bit_for_bit(sizes, hot, seed):
    ref = RefCriteo(sizes, n_dense=13, hot=hot, seed=seed)
    port = CriteoLikeGenerator(sizes, n_dense=13, hot=hot, seed=seed)
    for b, labels in ((64, True), (5, False), (300, True)):
        want, got = ref.batch(b, with_labels=labels), \
            port.batch(b, with_labels=labels)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("cfg_name", ["CONFIG", "SMOKE_CONFIG"])
def test_param_specs_match_reference(table_dtype, cfg_name):
    ref_cfg = {"CONFIG": REF_CONFIG, "SMOKE_CONFIG": REF_SMOKE}[cfg_name]
    cfg = {"CONFIG": CONFIG, "SMOKE_CONFIG": SMOKE_CONFIG}[cfg_name]
    want = RM.param_specs(ref_cfg)
    got = M.param_specs(cfg)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert _dtype_name(got[name].dtype) == str(spec.dtype), name


def test_params_count_and_table_bytes():
    for ref_cfg, cfg in ((REF_CONFIG, CONFIG), (REF_SMOKE, SMOKE_CONFIG)):
        assert cfg.params_count() == ref_cfg.params_count()
        assert cfg == M.DLRMConfig(**dataclasses.asdict(ref_cfg))
    assert sum(CONFIG.table_sizes) == 187_775_488
    # bfloat16 (the reference's layers.PDTYPE) fits one 80 GB card;
    # float32 does not
    assert sum(CONFIG.table_sizes) * CONFIG.embed_dim * 2 == 48_070_524_928
    assert M.CRITEO_TABLE_SIZES == RM.CRITEO_TABLE_SIZES


@pytest.mark.parametrize("shape", sorted(RECSYS_SHAPES))
@pytest.mark.parametrize("smoke", [False, True])
def test_input_specs_match_reference(shape, smoke):
    ref_step, ref_specs = ref_input_specs("dlrm-mlperf", shape, smoke=smoke)
    step, specs = input_specs("dlrm-mlperf", shape, smoke=smoke)
    assert step == ref_step
    assert list(specs) == list(ref_specs)
    for k, spec in ref_specs.items():
        assert specs[k].device.type == "meta"
        assert tuple(specs[k].shape) == tuple(spec.shape), (shape, k)
        assert _dtype_name(specs[k].dtype) == str(spec.dtype), (shape, k)


def test_registry_holds_only_ported_archs():
    # every arch of the reference is ported: the LMs since serving
    assert all_arch_ids() == ["deepseek-v2-236b", "dlrm-mlperf", "gcn-cora",
                              "gin-tu", "graphcast",
                              "llama4-maverick-400b-a17b", "qwen1.5-32b",
                              "qwen2-7b", "schnet", "yi-6b"]
    bundle = get_arch("dlrm-mlperf")
    ref = ref_get_arch("dlrm-mlperf")
    assert bundle.family == ref.family == "recsys"
    assert bundle.shape_names() == ref.shape_names()
    assert {k: (s.step, s.dims) for k, s in bundle.shapes.items()} == \
        {k: (s.step, s.dims) for k, s in ref.shapes.items()}
    assert config_for_shape("dlrm-mlperf", "serve_bulk") is CONFIG
    assert config_for_shape("dlrm-mlperf", "serve_p99", smoke=True) \
        is SMOKE_CONFIG
    with pytest.raises(KeyError, match="no-such-arch"):
        get_arch("no-such-arch")


def test_shape_tables_equal_reference():
    from repro.configs import base as ref_base
    from repro_torch.configs import base
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        want, got = getattr(ref_base, name), getattr(base, name)
        assert {k: (s.name, s.step, s.dims) for k, s in got.items()} == \
            {k: (s.name, s.step, s.dims) for k, s in want.items()}, name


def test_materialize_rule_and_seed():
    """Ones for 'norm', zeros for bias-like names, normal x 1/sqrt(fan_in)
    (fan_in = shape[-2]) for the rest, in each key's dtype; the same seed
    gives the same params, another seed others."""
    shapes = {"w": ((512, 256), torch.float32),
              "table": ((4096, 16), torch.bfloat16),
              "attn_norm": ((64,), torch.float32),
              "b0": ((32,), torch.float32), "top_b1": ((32,), torch.float32),
              "eps": ((1,), torch.float32),
              "v": ((20_000,), torch.float32)}
    out = L.materialize(shapes, torch.Generator().manual_seed(0))
    assert list(out) == list(shapes)
    for name, (shape, dtype) in shapes.items():
        assert tuple(out[name].shape) == shape and out[name].dtype == dtype
    assert torch.equal(out["attn_norm"], torch.ones(64))
    for name in ("b0", "top_b1", "eps"):
        assert not out[name].any()
    for name, fan_in in (("w", 512), ("table", 4096), ("v", 20_000)):
        x = out[name].float()
        std = 1 / math.sqrt(fan_in)
        assert abs(float(x.std()) / std - 1) < 0.05, name
        assert abs(float(x.mean())) < 0.1 * std, name
    again = L.materialize(shapes, torch.Generator().manual_seed(0))
    other = L.materialize(shapes, torch.Generator().manual_seed(1))
    assert all(torch.equal(out[k], again[k]) for k in shapes)
    assert not torch.equal(out["w"], other["w"])


def test_init_params_rule_dtypes_and_device():
    cfg = dataclasses.replace(SMOKE_CONFIG, table_sizes=(2000, 50, 20, 7))
    params = M.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    shapes = M.param_shapes(cfg)
    assert list(params) == list(shapes)
    assert params["table0"].dtype == L.PDTYPE == torch.bfloat16
    assert params["bot_w0"].dtype == torch.float32
    for name, t in params.items():
        assert t.device.type == "cpu"
        if "_b" in name:
            assert not t.any(), name
    x = params["table0"].float()
    assert abs(float(x.std()) * math.sqrt(2000) - 1) < 0.05
    again = M.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            M.init_params(cfg)
