"""repro_torch's embedding_bag against the reference's on the CPU.

The port runs CPU tensors (its wrapper then takes the plain torch
version); the reference runs both Pallas kernels in interpret mode and its
plain ``embedding_bag_ref``. Inputs are made with numpy from fixed seeds.
Tolerance: atol 1e-4, the reference test's own bound
(``tests/test_kernels.py``): the sums are taken in another order. The CUDA
kernel is held against the same plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm_mlperf import CONFIG as DLRM_MLPERF
from repro.kernels.embedding_bag.ops import embedding_bag as ref_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as ref_plain
from repro_torch import embedding_bag
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

ATOL = 1e-4
# the reference test's shapes (tests/test_kernels.py, TestEmbeddingBag)
SHAPES = [(100, 16, 8, 3), (1000, 64, 32, 7), (512, 128, 16, 1)]


def _inputs(v, d, b, ll, seed):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v + 1, (b, ll)).astype(np.int32)   # v == PAD
    return tab, idx


def _port(tab, idx, mode):
    out = embedding_bag(torch.from_numpy(tab), torch.from_numpy(idx),
                        mode=mode)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("mode", ["onehot", "dma", "auto"])
@pytest.mark.parametrize("v,d,b,ll", SHAPES)
def test_modes_match_reference_kernels(mode, v, d, b, ll):
    tab, idx = _inputs(v, d, b, ll, v + b)
    got = _port(tab, idx, mode)
    want = np.asarray(ref_bag(tab, idx, mode=mode, interpret=True))
    plain = np.asarray(ref_plain(jnp.asarray(tab), jnp.asarray(idx)))
    assert got.shape == want.shape == (b, d)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, plain, atol=ATOL)


@pytest.mark.parametrize("mode", ["onehot", "dma"])
def test_all_pad_bag_indices_past_v_and_duplicates(mode):
    """An all-PAD bag sums to 0; any index > V is an empty slot as PAD is;
    a row twice in one bag counts twice."""
    rng = np.random.default_rng(7)
    v, d = 50, 8
    tab = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (6, 5)).astype(np.int32)
    idx[0, :] = v                        # all PAD
    idx[1, :] = v + 3                    # past PAD: empty too
    idx[2, :] = 7                        # one row five times
    idx[3, 1:] = v + 100                 # one real slot
    got = _port(tab, idx, mode)
    want = np.asarray(ref_bag(tab, np.minimum(idx, v), mode=mode,
                              interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[0], np.zeros(d, np.float32))
    np.testing.assert_array_equal(got[1], np.zeros(d, np.float32))
    np.testing.assert_allclose(got[2], 5 * tab[7], atol=ATOL)
    np.testing.assert_array_equal(got[3], tab[idx[3, 0]])


def test_weighted_plain_version_matches_reference():
    rng = np.random.default_rng(3)
    tab = rng.standard_normal((30, 4)).astype(np.float32)
    idx = rng.integers(0, 31, (6, 3)).astype(np.int32)
    w = rng.random((6, 3)).astype(np.float32)
    got = embedding_bag_ref(torch.from_numpy(tab), torch.from_numpy(idx),
                            torch.from_numpy(w)).numpy()
    want = np.asarray(ref_plain(jnp.asarray(tab), jnp.asarray(idx),
                                jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_auto_rule_and_checks():
    """'auto' is the reference's rule (one-hot up to 2^22 table bytes);
    the wrapper takes float32 tables and raises on other types, negative
    indices and devices other than the CPU and CUDA."""
    small = torch.zeros((8192, 128))                  # 4 MiB exactly
    big = torch.zeros((8193, 128))
    assert bag_ops.resolve_mode(small, "auto") == "onehot"
    assert bag_ops.resolve_mode(big, "auto") == "dma"
    assert bag_ops.resolve_mode(big, "onehot") == "onehot"
    with pytest.raises(ValueError, match="mode"):
        bag_ops.resolve_mode(small, "mxu")
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        embedding_bag(torch.zeros((4, 2), dtype=torch.float64), idx)
    with pytest.raises(TypeError, match="idx"):
        embedding_bag(torch.zeros((4, 2)), idx.float())
    with pytest.raises(ValueError, match="negative"):
        embedding_bag(torch.zeros((4, 2)), idx - 1)
    with pytest.raises(ValueError, match="unsupported device"):
        embedding_bag(torch.zeros((4, 2), device="meta"),
                      torch.zeros((2, 3), dtype=torch.int32, device="meta"))


def _counts():
    return {m: c.n for m, c in
            {**bag_ops.LAUNCHES, **{f"onehot_{k}": c for k, c in
                                    bag_ops.ONEHOT_LAUNCHES.items()}}.items()}


def test_cpu_runs_the_plain_version_and_launches_nothing():
    tab, idx = _inputs(100, 16, 8, 3, 0)
    before = _counts()
    for mode in ("dma", "onehot"):
        _port(tab, idx, mode)
    assert _counts() == before


# the dlrm-mlperf tables "auto" sends to "onehot" (at most 2^22 bytes):
# 13 of its 26 fields, at their padded row counts
ONEHOT_FIELDS = [v for v in DLRM_MLPERF.table_sizes
                 if v * DLRM_MLPERF.embed_dim * 4 <= bag_ops.ONEHOT_MAX_BYTES]


def test_dlrm_mlperf_has_thirteen_onehot_fields():
    assert len(ONEHOT_FIELDS) == 13
    assert sorted(set(ONEHOT_FIELDS)) == [512, 1024, 2048, 2560, 7168, 7680]


@pytest.mark.parametrize("field", range(13))
def test_slice_rule_on_dlrm_mlperf_onehot_fields(field):
    """Every "onehot" field of dlrm-mlperf has a slice of at least 4 floats
    that divides D and fits a block's shared memory, the widest one that
    does; the slices of at least 32 floats (V <= 1,024) take the
    column-sliced kernel, the narrower ones (V = 2,048 and 2,560: w = 16;
    V = 7,168: w = 8; V = 7,680: w = 4) the row gather."""
    v, d = ONEHOT_FIELDS[field], DLRM_MLPERF.embed_dim
    w = bag_ops.onehot_slice_width(v, d)
    assert w >= 4 and d % w == 0 and w & (w - 1) == 0
    assert v * w * 4 <= bag_ops.SLICE_SMEM_BYTES == 232_448
    assert 2 * w > bag_ops.SLICE_MAX_W or d % (2 * w) \
        or v * 2 * w * 4 > bag_ops.SLICE_SMEM_BYTES
    want = {512: 64, 1024: 32, 2048: 16, 2560: 16, 7168: 8, 7680: 4}[v]
    assert w == want
    assert bag_ops.onehot_route(v, d) == (w if v <= 1024 else 0)


@pytest.mark.parametrize("v,d,aligned", [
    (14_529, 128, True),    # too tall for a 4-float slice
    (5000, 130, True),      # no power of two >= 4 divides D
    (1000, 128, False),     # an offset view: no 16-byte copies
    (7168, 128, True),      # w = 8: narrower than the route takes
    (7680, 128, True),      # w = 4
    (2560, 128, True),      # w = 16
    (1817, 128, True),      # one row past the tallest w = 32 table
    (100, 8, True),         # D = 8 allows no wider slice
    (10, 2, True),          # D < 4
])
def test_shapes_that_take_the_row_gather(v, d, aligned):
    assert bag_ops.onehot_route(v, d, aligned) == 0


@pytest.mark.parametrize("v,d,w", [(3632, 128, 16), (1816, 128, 32),
                                   (908, 128, 64), (454, 128, 128),
                                   (3632, 16, 16), (14_528, 128, 4)])
def test_slice_width_edges(v, d, w):
    """The tallest table of each width (V * w * 4 = 232,448 bytes
    exactly): one row more takes half the width, or none."""
    assert bag_ops.onehot_slice_width(v, d) == w
    assert bag_ops.onehot_slice_width(v + 1, d) in (w // 2, 0)


@pytest.mark.parametrize("b,d,w,grid", [
    (65_536, 128, 16, (8, 16)),    # 128 blocks
    (65_536, 128, 32, (4, 33)),    # 132
    (65_536, 128, 128, (1, 132)),
    (5, 128, 32, (4, 5)),          # at most one range a bag
    (65_536, 1024, 4, (256, 1)),   # more slices than SMs: one range
])
def test_onehot_grid(b, d, w, grid):
    assert bag_ops.onehot_grid(b, d, w) == grid


@pytest.mark.parametrize("mode", ["onehot", "dma"])
def test_int64_pads_past_int32_and_all_pad_bags(mode):
    """int64 indices >= 2^31 are empty slots, as PAD (== V) is; a bag of
    them sums to 0. Held against the reference's kernels (interpret mode)
    on the same bags with those indices set to PAD."""
    rng = np.random.default_rng(11)
    v, d = 64, 16
    tab = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (9, 6)).astype(np.int64)
    idx[0, :] = 2 ** 31                  # all past int32
    idx[1, :] = v                        # all PAD
    idx[2, ::2] = 2 ** 62
    idx[3, 1] = 2 ** 31 + 7
    idx[4, :] = 2 ** 63 - 1
    got = _port(tab, idx, mode)
    want = np.asarray(ref_bag(tab, np.minimum(idx, v).astype(np.int32),
                              mode=mode, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    for bag in (0, 1, 4):
        np.testing.assert_array_equal(got[bag], np.zeros(d, np.float32))


def test_wrapper_makes_no_clamped_copy(monkeypatch):
    """A CPU int64 input reaches the plain version as it is: no clamp, no
    cast, no copy."""
    seen = []

    def plain(table, idx, weights=None):
        seen.append(idx)
        return embedding_bag_ref(table, idx, weights)

    monkeypatch.setattr(bag_ops, "embedding_bag_ref", plain)
    tab, idx = _inputs(100, 16, 8, 3, 1)
    idx = torch.from_numpy(idx.astype(np.int64))
    idx[0, 0] = 2 ** 40
    for mode in ("onehot", "dma", "auto"):
        embedding_bag(torch.from_numpy(tab), idx, mode=mode)
    assert len(seen) == 3
    assert all(s is idx for s in seen)
    assert int(idx[0, 0]) == 2 ** 40


# ---------------------------------------------------------------------------
# bfloat16 tables: the reference DLRM's table type (layers.PDTYPE)
# ---------------------------------------------------------------------------

def _bf16_inputs(v, d, b, ll, seed):
    """A bfloat16 table (as torch bfloat16 and as its float32 widening)
    and int64 indices with ~10 % PAD (== V)."""
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)) \
        .to(torch.bfloat16)
    idx = rng.integers(0, v, (b, ll))
    idx[rng.random((b, ll)) < 0.1] = v
    return tab, tab.float().numpy(), idx


def _slot_order_sum(wide, idx):
    """The float32 sum of each bag's widened rows, slot 0 first (the
    kernels' order), PAD slots skipped."""
    v = wide.shape[0]
    out = np.zeros((idx.shape[0], wide.shape[1]), np.float32)
    for s in range(idx.shape[1]):
        live = idx[:, s] < v
        out[live] = out[live] + wide[idx[live, s]]
    return out


@pytest.mark.parametrize("v,d,b", [(100, 16, 64), (1024, 128, 300),
                                   (7, 130, 50)])
def test_bf16_plain_version_is_the_float32_sum(v, d, b):
    """``embedding_bag_ref`` on a bfloat16 table returns float32: the
    float32 sum of the widened rows, exactly at L = 1 (a bag is one row)
    and within 1 float32 ulp at L = 3."""
    for ll, maxulp in ((1, 0), (3, 1)):
        tab, wide, idx = _bf16_inputs(v, d, b, ll, v + ll)
        got = embedding_bag_ref(tab, torch.from_numpy(idx))
        assert got.dtype == torch.float32
        want = _slot_order_sum(wide, idx)
        if maxulp == 0:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=maxulp)


def test_float32_plain_version_keeps_its_dtype():
    tab, idx = _inputs(50, 8, 6, 3, 2)
    assert embedding_bag_ref(torch.from_numpy(tab),
                             torch.from_numpy(idx)).dtype == torch.float32
    assert embedding_bag_ref(torch.from_numpy(tab).double(),
                             torch.from_numpy(idx)).dtype == torch.float64


@pytest.mark.parametrize("mode", ["onehot", "dma", "auto"])
@pytest.mark.parametrize("v,d,b,ll", SHAPES)
def test_bf16_modes_match_reference_float32_sum(mode, v, d, b, ll):
    """Every mode on a bfloat16 table gives float32 bags equal to the
    reference's plain version on the widened (float32) table within ATOL:
    the reference DLRM's lookup (``vec.astype(float32)``, then the sum).
    The reference's TPU dma kernel adds in the table's type instead; the
    port does not (PERF.md §6)."""
    tab, wide, idx = _bf16_inputs(v, d, b, ll, v + b)
    got = embedding_bag(tab, torch.from_numpy(idx), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    want = np.asarray(ref_plain(jnp.asarray(wide),
                                jnp.asarray(idx.astype(np.int32))))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    ref_bf16 = np.asarray(ref_bag(jnp.asarray(wide).astype(jnp.bfloat16),
                                  idx.astype(np.int32), mode="dma",
                                  interpret=True)).astype(np.float32)
    if ll == 1:                 # one row a bag: no sum to round
        np.testing.assert_array_equal(got.numpy(), ref_bf16)


def test_bf16_checks_and_no_launch_on_the_cpu():
    tab, _, idx = _bf16_inputs(64, 16, 8, 3, 0)
    before = _counts()
    out = embedding_bag(tab, torch.from_numpy(idx))
    assert out.dtype == torch.float32 and _counts() == before
    with pytest.raises(TypeError, match="bfloat16"):
        embedding_bag(tab.half(), torch.from_numpy(idx))
    # the "auto" rule is by bytes: a bfloat16 table of 16,384 x 128 is 4 MiB
    assert bag_ops.resolve_mode(torch.zeros((16_384, 128),
                                            dtype=torch.bfloat16),
                                "auto") == "onehot"
    assert bag_ops.resolve_mode(torch.zeros((16_385, 128),
                                            dtype=torch.bfloat16),
                                "auto") == "dma"


# the dlrm-mlperf tables "auto" sends to "onehot" at bfloat16: 15 of 26
BF16_ONEHOT_FIELDS = [v for v in DLRM_MLPERF.table_sizes
                      if v * DLRM_MLPERF.embed_dim * 2
                      <= bag_ops.ONEHOT_MAX_BYTES]


def test_dlrm_mlperf_has_fifteen_bf16_onehot_fields():
    assert len(BF16_ONEHOT_FIELDS) == 15
    assert max(BF16_ONEHOT_FIELDS) == 13_312
    assert sorted(set(BF16_ONEHOT_FIELDS)) == [
        512, 1024, 2048, 2560, 7168, 7680, 12_288, 13_312]


@pytest.mark.parametrize("v,w", [(512, 128), (1024, 64), (2048, 32),
                                 (2560, 32), (7168, 16), (7680, 8),
                                 (12_288, 8), (13_312, 8)])
def test_bf16_slice_rule_on_dlrm_mlperf_onehot_fields(v, w):
    """At bfloat16 a slice row is w * 2 bytes: every "onehot" field has a
    slice of at least 8 values (one 16-byte copy), the widest that fits;
    the route takes the column-sliced kernel from w = 32 on (measured at
    bfloat16: up to V = 3,632 at D = 128), the row gather below."""
    d = DLRM_MLPERF.embed_dim
    assert bag_ops.onehot_slice_width(v, d, elem=2) == w
    assert v * w * 2 <= bag_ops.SLICE_SMEM_BYTES
    assert bag_ops.SLICE_ROUTE_MIN_W[2] == 32
    assert bag_ops.onehot_route(v, d, elem=2) == (w if v <= 3632 else 0)


@pytest.mark.parametrize("v,d,w", [(908, 128, 128), (1816, 128, 64),
                                   (3632, 128, 32), (7264, 128, 16),
                                   (14_528, 128, 8), (7264, 16, 16),
                                   (14_528, 8, 8)])
def test_bf16_slice_width_edges(v, d, w):
    """The tallest bfloat16 table of each width (V * w * 2 = 232,448
    bytes); one row more takes half the width, or none below 8 values."""
    assert bag_ops.onehot_slice_width(v, d, elem=2) == w
    assert bag_ops.onehot_slice_width(v + 1, d, elem=2) in (w // 2, 0)
    assert bag_ops.onehot_slice_width(v, d, aligned=False, elem=2) == 0
    assert bag_ops.onehot_slice_width(100, 4, elem=2) == 0   # D < 8
