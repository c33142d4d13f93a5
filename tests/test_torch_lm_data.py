"""repro_torch's LM data, configs, registry and serve CLI against the
reference's, on the CPU.

``data.tokens.TokenStream`` gives the reference's arrays bit for bit
(values and dtypes) for several vocabs and seeds, and the reference's
``test_token_stream`` holds on the port. The five LM configs equal the
reference's field for field (less ``REF_ONLY_FIELDS``), with the same
notes; the registry holds all ten archs, four shapes each;
``params_count`` and ``active_params_count`` equal the reference's; and
``param_specs``, ``cache_specs`` and ``input_specs`` of every LM arch at
every LM shape equal the reference's in names, shapes and dtypes, at the
full configs too (tensors on the ``meta`` device, nothing allocated).
The serve CLI runs at ``--smoke --torch-device cpu`` and, with no card,
raises by default. No tolerance: everything here is compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids as ref_all_arch_ids
from repro.configs import get_arch as ref_get_arch
from repro.configs import input_specs as ref_input_specs
from repro.data.tokens import TokenStream as RefTokenStream
from repro.models import layers as RL
from repro.models import transformer as RM
from repro_torch.configs import all_arch_ids, get_arch, input_specs
from repro_torch.configs.base import LM_SHAPES
from repro_torch.data import TokenStream
from repro_torch.models import layers as L
from repro_torch.models import transformer as M
from repro_torch.pytree import leaves

LM_ARCHS = ["qwen2-7b", "yi-6b", "qwen1.5-32b", "deepseek-v2-236b",
            "llama4-maverick-400b-a17b"]
PARAMS = {"qwen2-7b": (7_615_616_512, 7_615_616_512),
          "yi-6b": (6_061_035_520, 6_061_035_520),
          "qwen1.5-32b": (35_197_096_960, 35_197_096_960),
          "deepseek-v2-236b": (235_741_434_880, 21_375_800_320),
          "llama4-maverick-400b-a17b": (397_691_950_080, 14_164_792_320)}


@pytest.fixture
def bfloat16():
    """Both packages at their full-size dtypes (the reference's conftest
    pins float32 for the session), then back."""
    ref_saved, port_saved = (RL.PDTYPE, RL.ADTYPE), (L.PDTYPE, L.ADTYPE)
    RL.set_dtypes(jnp.bfloat16, jnp.bfloat16)
    L.set_dtypes(torch.bfloat16, torch.bfloat16)
    try:
        yield
    finally:
        RL.set_dtypes(*ref_saved)
        L.set_dtypes(*port_saved)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed", [(100, 0), (256, 1), (64000, 2),
                                        (152064, 0), (7, 5)])
def test_token_stream_equals_reference(vocab, seed):
    got, want = TokenStream(vocab, seed=seed), RefTokenStream(vocab,
                                                              seed=seed)
    np.testing.assert_array_equal(got.p, want.p)
    np.testing.assert_array_equal(got.succ, want.succ)
    for bs, sl in ((4, 32), (2, 8), (1, 1)):   # the state carries over
        g, w = got.batch(bs, sl), want.batch(bs, sl)
        assert list(g) == list(w) == ["tokens", "targets"]
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
    for g, w in zip(got.batches(3, 5, 2), want.batches(3, 5, 2)):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_token_stream():
    """The reference's ``tests/test_data.py::TestDataPipeline::
    test_token_stream``, on the port."""
    ts = TokenStream(vocab=100, seed=0)
    b = ts.batch(4, 32)
    assert b["tokens"].shape == (4, 32)
    assert b["targets"].shape == (4, 32)
    # next-token alignment
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    b2 = ts.batch(2, 8)
    assert b2["tokens"].max() < 100


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

def test_all_archs_registered():
    """The reference's ``tests/test_models_smoke.py::
    test_all_archs_registered``, on the port."""
    assert len(all_arch_ids()) == 10
    assert all_arch_ids() == ref_all_arch_ids()
    for aid in all_arch_ids():
        b = get_arch(aid)
        assert len(b.shapes) == 4
        assert b.smoke_config is not None


# Fields of the reference's TransformerConfig that the port leaves out:
# ``scan_unroll`` unrolls the ``lax.scan`` over layers, which the port runs
# as a Python loop. (``remat`` is compared: the port's training honours it.)
REF_ONLY_FIELDS = ("scan_unroll",)


def _ref_fields(cfg):
    assert not cfg.scan_unroll
    d = dataclasses.asdict(cfg)
    for k in REF_ONLY_FIELDS:
        d.pop(k)
    return d


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_reference(arch):
    got, want = get_arch(arch), ref_get_arch(arch)
    assert got.family == want.family == "lm"
    assert got.notes == want.notes
    for cfg, ref_cfg in ((got.config, want.config),
                         (got.smoke_config, want.smoke_config)):
        assert dataclasses.asdict(cfg) == _ref_fields(ref_cfg)
        assert cfg.n_repeats == ref_cfg.n_repeats
    assert {k: (s.step, s.dims) for k, s in got.shapes.items()} == \
        {k: (s.step, s.dims) for k, s in want.shapes.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_count_equals_reference(arch, bfloat16):
    cfg, ref_cfg = get_arch(arch).config, ref_get_arch(arch).config
    assert (cfg.params_count(), cfg.active_params_count()) == PARAMS[arch]
    assert cfg.params_count() == ref_cfg.params_count()
    assert cfg.active_params_count() == ref_cfg.active_params_count()
    smoke, ref_smoke = get_arch(arch).smoke_config, \
        ref_get_arch(arch).smoke_config
    assert smoke.params_count() == ref_smoke.params_count()
    assert smoke.active_params_count() == ref_smoke.active_params_count()


def _assert_specs_equal(got, want, where):
    """A port tree of meta tensors against a reference tree of
    ShapeDtypeStructs: the same paths, shapes and dtypes."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    n = 0
    for path, spec in flat:
        g = got
        for k in path:
            g = g[k.key]
        assert isinstance(g, torch.Tensor) and g.device.type == "meta", \
            (where, path)
        assert tuple(g.shape) == tuple(spec.shape), (where, path)
        assert _dtype_name(g.dtype) == str(spec.dtype), (where, path)
        n += 1
    assert len(leaves(got)) == n, where


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_cache_specs_equal_reference(arch, smoke, bfloat16):
    b = get_arch(arch)
    cfg = b.smoke_config if smoke else b.config
    ref_cfg = ref_get_arch(arch).smoke_config if smoke \
        else ref_get_arch(arch).config
    _assert_specs_equal(M.param_specs(cfg), RM.param_specs(ref_cfg),
                        (arch, "params"))
    _assert_specs_equal(M.cache_specs(cfg, 3, 40),
                        RM.cache_specs(ref_cfg, 3, 40), (arch, "cache"))


@pytest.mark.parametrize("shape", sorted(LM_SHAPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_input_specs_equal_reference(arch, shape, bfloat16):
    for smoke in (False, True):
        ref_step, ref_specs = ref_input_specs(arch, shape, smoke=smoke)
        step, specs = input_specs(arch, shape, smoke=smoke)
        assert step == ref_step
        assert list(specs) == list(ref_specs)
        _assert_specs_equal(specs, ref_specs, (arch, shape, smoke))


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_dtypes():
    """The port's global dtypes as they were: the CLI calls
    ``set_dtypes(float32, float32)`` under ``--smoke``, as the
    reference's does."""
    saved = (L.PDTYPE, L.ADTYPE)
    try:
        yield
    finally:
        L.set_dtypes(*saved)


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-236b"])
def test_serve_cli_runs_on_the_cpu(arch, restore_dtypes, capsys):
    from repro_torch.launch.serve import main
    toks = main(["--arch", arch, "--smoke", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4", "--torch-device", "cpu"])
    assert toks.shape == (2, 4)
    assert toks.min() >= 0 and toks.max() < get_arch(arch).smoke_config.vocab
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "tok/s" in out
    assert L.PDTYPE == L.ADTYPE == torch.float32


def test_serve_cli_refuses_a_family_it_cannot_serve(restore_dtypes):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--arch", "gcn-cora", "--smoke", "--torch-device", "cpu"])


def test_serve_cli_defaults_to_the_card(restore_dtypes):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "yi-6b", "--smoke"])
