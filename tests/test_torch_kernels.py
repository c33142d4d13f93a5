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
from repro.kernels.intersect.ops import \
    intersect_count_rows as ref_intersect_rows
from repro.kernels.triangle_dense.ops import triangle_count as ref_dense
from repro_torch.kernels import ledger as port_ledger
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.intersect.ref import (SENTINEL, intersect_count_ref,
                                               intersect_rows_ref)
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


# ragged shapes, and the CUDA kernel's tile edges: nx and ny at and
# around multiples of 64 and 128 (a warpgroup's rows, a block's tile), d
# at multiples of 16 around its 128-byte stage, up to a few thousand
DENSE_SHAPES = [(64, 64, 128), (100, 140, 300), (1, 7, 64), (257, 129, 641),
                (3, 5, 1), (130, 2, 1000), (63, 65, 16), (64, 128, 112),
                (127, 129, 128), (128, 127, 144), (129, 256, 512),
                (255, 257, 1008), (256, 64, 2048), (192, 64, 4096)]


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
    off = torch.zeros(3, dtype=torch.int64)
    intersect_ops.intersect_count_csr(off, t[0], off[:1], off, t[0], off[:1])
    u = torch.zeros((2, 2), dtype=torch.uint8)
    dense_ops.triangle_count(u, u, u)
    assert intersect_ops.LAUNCHES.n == 0 and dense_ops.LAUNCHES.n == 0


# ---------------------------------------------------------------------------
# the CSR form: intersect_rows_ref, intersect_count_csr, intersect_count_rows
# ---------------------------------------------------------------------------

# the kernel's largest work tile and its grid (csrc/intersect_core.cuh
# kTileMax, csrc/intersect.cu kBlocks)
KERNEL_TILE = 2048
KERNEL_GRID = 132 * 8


def csr_rows(rng, degs, hi):
    """Compact CSR (int64 offsets, int32 values) whose row r holds degs[r]
    sorted distinct values below hi."""
    off = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    vals = np.concatenate(
        [np.sort(rng.choice(hi, size=int(d), replace=False))
         for d in degs] + [np.zeros(0, np.int64)]).astype(np.int32)
    return off, vals


def csr_pairs(seed, n_pairs, n_keys, max_deg, hi, zero_share=0.2):
    """Two CSR relations of n_keys rows (about zero_share of them empty)
    and n_pairs random key positions on each side."""
    rng = np.random.default_rng(seed)
    sides = []
    for _ in range(2):
        degs = rng.integers(0, max_deg + 1, size=n_keys)
        degs[rng.random(n_keys) < zero_share] = 0
        off, vals = csr_rows(rng, degs, hi)
        pos = rng.integers(0, n_keys, size=n_pairs).astype(np.int64)
        sides.append((off, vals, pos))
    return sides


def hub_pair(wide, narrow, hi, seed):
    """One pair: a wide row of `wide` values and a narrow one of `narrow`,
    both drawn from [0, hi)."""
    rng = np.random.default_rng(seed)
    sides = []
    for deg in (wide, narrow):
        off, vals = csr_rows(rng, [deg], hi)
        sides.append((off, vals, np.zeros(1, np.int64)))
    return sides


def straddling_pairs(seed):
    """Pairs whose probe counts put tile edges inside pairs, at pair
    boundaries and on pairs without work."""
    rng = np.random.default_rng(seed)
    degs_a = np.array([2047, 1, 0, 2048, 3000, 5, 4096, 1, 2049, 0, 700])
    degs_b = np.array([2100, 1, 9, 2048, 3100, 2, 4200, 3, 2049, 4, 800])
    sides = []
    for degs in (degs_a, degs_b):
        off, vals = csr_rows(rng, degs, 12_000)
        sides.append((off, vals, np.arange(len(degs), dtype=np.int64)))
    return sides


def empty_side(seed):
    (off_a, vals_a, pos_a), b = csr_pairs(seed, 50, 30, 6, 40)
    return [(np.zeros(31, np.int64), np.zeros(0, np.int32), pos_a), b]


CSR_CASES = {
    # name: (input maker, also run the reference's Pallas kernel in
    # interpret mode)
    "empty_rows": (lambda: empty_side(1), True),
    "degree0_positions": (lambda: csr_pairs(2, 64, 20, 9, 30, 0.5), True),
    "pairs_0": (lambda: csr_pairs(3, 0, 10, 4, 20), False),
    "pairs_1": (lambda: csr_pairs(4, 1, 10, 40, 60, 0.0), True),
    "pairs_8191": (lambda: csr_pairs(5, 8191, 300, 5, 40), False),
    "pairs_8192": (lambda: csr_pairs(6, 8192, 300, 5, 40), False),
    "pairs_8193": (lambda: csr_pairs(7, 8193, 300, 5, 40), False),
    "hub_wide_window": (lambda: hub_pair(60_000, 50_000, 1_000_000, 8),
                        False),
    "hub_dense": (lambda: hub_pair(60_000, 50_000, 80_000, 9), False),
    "many_tiny": (lambda: csr_pairs(10, 100_000, 5000, 3, 8, 0.1), False),
    "tile_edges": (lambda: straddling_pairs(11), False),
}


def brute_pairs(sides):
    (off_a, vals_a, pos_a), (off_b, vals_b, pos_b) = sides
    return np.array([len(np.intersect1d(vals_a[off_a[i]:off_a[i + 1]],
                                        vals_b[off_b[j]:off_b[j + 1]]))
                     for i, j in zip(pos_a, pos_b)], dtype=np.int64)


def torch_sides(sides):
    return [t for side in sides for t in map(torch.from_numpy, side)]


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_intersect_rows_match_reference(case):
    """intersect_rows_ref (the CPU lane and the card's oracle) per pair,
    and intersect_count_csr / intersect_count_rows totals, against brute
    force and the reference's intersect_count_rows (its plain version, and
    its Pallas kernel in interpret mode on the small cases)."""
    build, interpret = CSR_CASES[case]
    sides = build()
    (off_a, vals_a, pos_a), (off_b, vals_b, pos_b) = sides
    brute = brute_pairs(sides)
    want = ref_intersect_rows(off_a, vals_a, pos_a, off_b, vals_b, pos_b,
                              use_pallas=False)
    assert want == int(brute.sum())
    if interpret:
        assert ref_intersect_rows(off_a, vals_a, pos_a, off_b, vals_b,
                                  pos_b, use_pallas=True,
                                  interpret=True) == want
    t = torch_sides(sides)
    per_pair = intersect_rows_ref(*t)
    assert per_pair.dtype == torch.int32
    np.testing.assert_array_equal(per_pair.numpy(), brute)
    total = intersect_ops.intersect_count_csr(*t)
    assert total.dtype == torch.int64 and total.dim() == 0
    assert int(total) == want
    with ref_ledger.attach() as rl:
        ref_intersect_rows(off_a, vals_a, pos_a, off_b, vals_b, pos_b,
                           use_pallas=False)
    with port_ledger.attach() as pl:
        assert intersect_ops.intersect_count_rows(*t) == want
    assert pl.invocations == rl.invocations == -(-len(pos_a) // 8192)


def test_intersect_rows_note_the_padded_tile_bytes():
    """intersect_count_rows notes each 8,192-pair chunk with the bytes of
    its SENTINEL-padded tiles as wide as the chunk's widest row (at least
    1), computed without building them."""
    t = torch_sides(csr_pairs(12, 20_000, 400, 30, 200))
    off_a, _, pos_a, off_b, _, pos_b = t
    deg_a = (off_a[1:] - off_a[:-1])[pos_a]
    deg_b = (off_b[1:] - off_b[:-1])[pos_b]
    want_in = want_out = 0
    for s in range(0, len(pos_a), 8192):
        e = len(pos_a[s:s + 8192])
        ka = max(1, int(deg_a[s:s + 8192].max()))
        kb = max(1, int(deg_b[s:s + 8192].max()))
        want_in += 4 * e * (ka + kb)
        want_out += 4 * e
    with port_ledger.attach() as pl:
        intersect_ops.intersect_count_rows(*t)
    assert (pl.invocations, pl.bytes_in, pl.bytes_out) == \
        (3, want_in, want_out)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_work_split_matches_brute_force(seed):
    """The kernel's split of the work space, the exclusive scan of each
    pair's min(deg_a, deg_b) (csrc/intersect.cu), covers every probe of
    every pair exactly once: tiles of the least multiple of 256 probes
    that spreads the work over the grid (at most KERNEL_TILE), each
    tile's first and last pair by binary search; one pair's slice in runs
    of tile / 256 probes per thread, or a warp per pair with its lanes
    striding the pair's probes (tiles of at least 8 pairs), or thread t
    taking the tile's probes t, t + 256, ..., each finding its pair by
    binary search after the thread's last pair."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    deg_a = rng.integers(0, 3 * KERNEL_TILE, size=n)
    deg_b = rng.integers(0, 3 * KERNEL_TILE, size=n)
    deg_a[rng.random(n) < 0.3] = 0
    if seed == 3:  # short pairs: small tiles of many pairs
        deg_a, deg_b = deg_a % 40, deg_b % 40
    w = np.minimum(deg_a, deg_b)
    work_off = np.concatenate([[0], np.cumsum(w)])
    total = int(work_off[n])
    per_block = -(-total // KERNEL_GRID)
    tile = min(KERNEL_TILE, max(1, -(-per_block // 256)) * 256)
    covered = []
    for t in range(-(-total // tile)):
        g0 = t * tile
        g1 = min(total, g0 + tile)
        p0 = int(np.searchsorted(work_off[:n], g0, side="right")) - 1
        p1 = int(np.searchsorted(work_off[:n], g1 - 1, side="right")) - 1
        # one pair whose window fits: one run per thread (a one-pair tile
        # takes either path, by its window: the check alternates them)
        if p0 == p1 and t % 2 == 0:
            base = int(work_off[p0])
            run = tile // 256
            for r0 in range(g0, g1, run):
                covered += [(p0, g - base)
                            for g in range(r0, min(g1, r0 + run))]
        elif p1 - p0 + 1 >= 8:  # a warp per pair, lanes striding by 32
            for warp in range(8):
                for p in range(p0 + warp, p1 + 1, 8):
                    base = int(work_off[p])
                    s, e = max(g0, base) - base, \
                        min(g1, int(work_off[p + 1])) - base
                    for lane in range(32):
                        covered += [(p, j) for j in range(s + lane, e, 32)]
        else:  # strided probes, each finding its pair
            for thread in range(256):
                p, nxt = p0 - 1, -1
                for g in range(g0 + thread, g1, 256):
                    if g >= nxt:
                        lo = max(p + 1, p0)
                        p = lo + int(np.searchsorted(work_off[lo:p1 + 1], g,
                                                     side="right")) - 1
                        nxt = int(work_off[p + 1])
                    covered.append((p, g - int(work_off[p])))
    covered.sort()
    brute = [(p, k) for p in range(n) for k in range(int(w[p]))]
    assert covered == brute


def test_intersect_csr_rejects_bad_inputs():
    t = torch_sides(csr_pairs(13, 5, 6, 3, 10))
    off_a, vals_a, pos_a, off_b, vals_b, pos_b = t
    with pytest.raises(ValueError, match="vals_a must be"):
        intersect_ops.intersect_count_csr(off_a, vals_a.long(), pos_a,
                                          off_b, vals_b, pos_b)
    with pytest.raises(ValueError, match="pos_b must be"):
        intersect_ops.intersect_count_csr(off_a, vals_a, pos_a, off_b,
                                          vals_b, pos_b.int())
    with pytest.raises(ValueError, match="differ in length"):
        intersect_ops.intersect_count_csr(off_a, vals_a, pos_a, off_b,
                                          vals_b, pos_b[:2])
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="unsupported device"):
        intersect_ops.intersect_count_csr(*meta)
