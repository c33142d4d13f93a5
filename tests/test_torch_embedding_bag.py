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


def test_cpu_runs_the_plain_version_and_launches_nothing():
    tab, idx = _inputs(100, 16, 8, 3, 0)
    before = {m: c.n for m, c in bag_ops.LAUNCHES.items()}
    for mode in ("dma", "onehot"):
        _port(tab, idx, mode)
    assert {m: c.n for m, c in bag_ops.LAUNCHES.items()} == before
