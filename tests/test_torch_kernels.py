"""repro_torch kernel wrappers against the reference kernels on the CPU.

On a CPU tensor each wrapper runs its plain torch version; it must equal
the reference Pallas kernel run in interpret mode exactly (integers), on
ragged shapes, and note the kernel ledger exactly as the reference does.
The CUDA kernels themselves are held against the same plain versions on
the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ledger as ref_ledger
from repro.kernels.intersect.ops import intersect_count as ref_intersect
from repro.kernels.triangle_dense.ops import triangle_count as ref_dense
from repro_torch.kernels import ledger as port_ledger
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.intersect.ref import SENTINEL, intersect_count_ref
from repro_torch.kernels.triangle_dense import ops as dense_ops


def sorted_rows(rng, e, k, hi, lens=None):
    out = np.full((e, k), SENTINEL, np.int32)
    if lens is None:
        lens = rng.integers(0, min(k, hi) + 1, size=e)
    for i, n in enumerate(lens):
        out[i, :n] = np.sort(rng.choice(hi, size=n, replace=False))
    return out


INTERSECT_CASES = {
    # (E, Ka, Kb, value range, row lengths)
    "ragged": (37, 13, 29, 60, None),
    "unequal_widths": (50, 5, 130, 200, None),
    "not_pow2": (129, 100, 100, 150, None),
    "empty_rows": (20, 16, 16, 40, np.zeros(20, np.int64)),
    "full_rows": (9, 24, 24, 24, np.full(9, 24)),
    "one_row": (1, 3, 7, 10, None),
}


@pytest.mark.parametrize("case", sorted(INTERSECT_CASES))
def test_intersect_matches_reference_kernel(case):
    e, ka, kb, hi, lens = INTERSECT_CASES[case]
    rng = np.random.default_rng(e * ka + kb)
    a = sorted_rows(rng, e, ka, hi, lens)
    b = sorted_rows(rng, e, kb, hi, None if lens is None else lens)
    if case == "empty_rows":
        b[:] = SENTINEL                       # all-SENTINEL on both sides
    want = np.asarray(ref_intersect(a, b, use_pallas=True, interpret=True))
    got = intersect_ops.intersect_count(torch.from_numpy(a),
                                        torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    brute = [len(set(a[i][a[i] != SENTINEL]) & set(b[i][b[i] != SENTINEL]))
             for i in range(e)]
    assert got.tolist() == brute


@pytest.mark.parametrize("e", [1, 33, 200])
def test_intersect_index_form_matches_gathered_reference(e):
    rng = np.random.default_rng(e)
    npad = sorted_rows(rng, 45, 19, 70)
    ia = rng.integers(0, 45, e).astype(np.int32)
    ib = rng.integers(0, 45, e).astype(np.int32)
    want = np.asarray(ref_intersect(npad[ia], npad[ib], use_pallas=True,
                                    interpret=True))
    t = torch.from_numpy(npad)
    got = intersect_ops.intersect_count(t, t, torch.from_numpy(ia),
                                        torch.from_numpy(ib))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        intersect_count_ref(t, t, torch.from_numpy(ia),
                            torch.from_numpy(ib)).numpy(), want)


def test_intersect_notes_ledger_like_reference():
    rng = np.random.default_rng(1)
    a = sorted_rows(rng, 10, 8, 30)
    b = sorted_rows(rng, 10, 8, 30)
    with ref_ledger.attach() as rl:
        ref_intersect(a, b, use_pallas=True, interpret=True)
        ref_intersect(a, b, use_pallas=False)
    with port_ledger.attach() as pl:
        intersect_ops.intersect_count(torch.from_numpy(a),
                                      torch.from_numpy(b))
        intersect_ops.intersect_count(torch.from_numpy(a),
                                      torch.from_numpy(b))
    assert pl.invocations == rl.invocations == 2
    assert pl.transfer_bytes > 0


def test_intersect_rejects_bad_inputs():
    a = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        intersect_ops.intersect_count(a.long(), a)
    with pytest.raises(ValueError, match="same row count"):
        intersect_ops.intersect_count(a, a[:2])
    with pytest.raises(ValueError, match="both ia and ib"):
        intersect_ops.intersect_count(a, a, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        intersect_ops.intersect_count(a.T, a.T)


DENSE_SHAPES = [(64, 64, 128), (100, 140, 300), (1, 7, 64), (257, 129, 641),
                (3, 5, 1), (130, 2, 1000)]


@pytest.mark.parametrize("nx,ny,d", DENSE_SHAPES)
def test_dense_matches_reference_kernel(nx, ny, d):
    rng = np.random.default_rng(nx * ny + d)
    a = (rng.random((nx, d)) < 0.2).astype(np.uint8)
    b = (rng.random((ny, d)) < 0.2).astype(np.uint8)
    m = (rng.random((nx, ny)) < 0.4).astype(np.uint8)
    want = float(ref_dense(a.astype(np.float32), b.astype(np.float32),
                           m.astype(np.float32), use_pallas=True,
                           interpret=True))
    got = dense_ops.triangle_count(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(m))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(round(want))
    exact = int((m.astype(np.int64) * (a.astype(np.int64)
                                       @ b.astype(np.int64).T)).sum())
    assert int(got) == exact


def test_dense_exact_past_float32_mantissa():
    """A count above 2^24 stays exact in int64 (float32 sums would not)."""
    a = torch.ones((300, 300), dtype=torch.uint8)
    m = torch.ones((300, 300), dtype=torch.uint8)
    got = dense_ops.triangle_count(a, a, m)
    assert int(got) == 300 ** 3 and 300 ** 3 > 2 ** 24


def test_dense_notes_nothing_like_reference():
    a = np.ones((8, 16), np.uint8)
    m = np.ones((8, 8), np.uint8)
    with ref_ledger.attach() as rl:
        ref_dense(a.astype(np.float32), a.astype(np.float32),
                  m.astype(np.float32), use_pallas=True, interpret=True)
    with port_ledger.attach() as pl:
        dense_ops.triangle_count(torch.from_numpy(a), torch.from_numpy(a),
                                 torch.from_numpy(m))
    assert pl.invocations == rl.invocations == 0


def test_dense_rejects_bad_inputs():
    a = torch.zeros((4, 3), dtype=torch.uint8)
    m = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        dense_ops.triangle_count(a.float(), a, m)
    with pytest.raises(ValueError, match="widths differ"):
        dense_ops.triangle_count(a, a[:, :2].contiguous(), m)
    with pytest.raises(ValueError, match="mask must be"):
        dense_ops.triangle_count(a, a, m[:3])


def test_cpu_wrappers_do_not_count_launches():
    """The launch counters move only where a CUDA kernel launches."""
    intersect_ops.LAUNCHES.reset()
    dense_ops.LAUNCHES.reset()
    t = torch.zeros((2, 2), dtype=torch.int32)
    intersect_ops.intersect_count(t, t)
    u = torch.zeros((2, 2), dtype=torch.uint8)
    dense_ops.triangle_count(u, u, u)
    assert intersect_ops.LAUNCHES.n == 0 and dense_ops.LAUNCHES.n == 0
