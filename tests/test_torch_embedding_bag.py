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
