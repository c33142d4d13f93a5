"""repro_torch's fused LFTJ lane against the reference on the CPU.

Kernel layer: the port's ``fused_count`` / ``fused_list`` on CPU tensors
(their plain torch versions) against the reference's interpret-mode
megakernel and listing program and its scalar ``fused_ref``, over the
triangle, four-clique and diamond atom shapes on ER, RMAT and star graphs
from fixed seeds. Listings must equal the reference's buffer row for row,
also at a capacity below the total. Engine layer:
``TriangleEngine(backend="fused")`` against the reference's, plan, count,
``list()`` bytes and stats. Every quantity is an integer: equality is
exact. The CUDA kernel is held against the same plain versions on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import TriangleEngine as RefEngine
from repro.data import graphs as r_graphs
from repro.kernels import ledger as ref_ledger
from repro.kernels.lftj_fused import ops as ref_ops
from repro.kernels.lftj_fused.ref import fused_ref as reference_fused_ref
from repro_torch import TriangleEngine
from repro_torch.kernels import ledger as port_ledger
from repro_torch.kernels.lftj_fused import ops as fused_ops
from repro_torch.kernels.lftj_fused.ops import (FusedUnsupported, fused_count,
                                                fused_list, fused_supported)
from repro_torch.kernels.lftj_fused.ref import (SENTINEL, fused_count_ref,
                                                fused_list_ref, fused_ref)

# atom shapes over the variable order, as the reference's planner emits
# them (tests/test_lftj_fused.py): the diamond leaves variable 1
# starts-only
DIMS = {
    "triangle": ((0, 1), (0, 2), (1, 2)),
    "four_clique": ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
    "diamond": ((1, 2), (1, 3), (0, 2), (0, 3)),
}


def er_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((n, n)) < p, k=1)
    src, dst = np.nonzero(adj)
    return src.astype(np.int64), dst.astype(np.int64)


def star_graph(hubs, leaves, seed):
    """A few hubs adjacent to every leaf plus a sprinkle of leaf-leaf
    edges: a couple of huge rows over tiny ones."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(hubs), leaves)
    dst = hubs + np.tile(np.arange(leaves), hubs)
    extra = rng.integers(hubs, hubs + leaves, size=(leaves, 2))
    extra = extra[extra[:, 0] < extra[:, 1]]
    src = np.concatenate([src, extra[:, 0]])
    dst = np.concatenate([dst, extra[:, 1]])
    uniq = np.unique(src * (hubs + leaves) + dst)
    return (uniq // (hubs + leaves)).astype(np.int64), \
        (uniq % (hubs + leaves)).astype(np.int64)


GRAPHS = {
    "er": lambda seed: er_graph(40, 0.2, seed),
    "rmat": lambda seed: r_graphs.rmat_graph(64, 500, seed=seed),
    "star": lambda seed: star_graph(3, 24, seed),
}


def graph_csr(src, dst):
    """Oriented (u < v) adjacency as (keys, off, vals) compact CSR."""
    u, v = np.minimum(src, dst), np.maximum(src, dst)
    keep = u != v
    stride = int(max(v.max(initial=0), 1)) + 1
    uniq = np.unique(u[keep] * stride + v[keep])
    u, v = uniq // stride, uniq % stride
    keys, counts = np.unique(u, return_counts=True)
    off = np.concatenate([np.zeros(1, np.int64),
                          np.cumsum(counts, dtype=np.int64)])
    return keys.astype(np.int64), off, v.astype(np.int32)


def tensors(csrs):
    return [tuple(torch.from_numpy(np.asarray(a)) for a in c) for c in csrs]


def canonical(rows):
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return rows
    return rows[np.lexsort(tuple(rows[:, c] for c in
                                 range(rows.shape[1] - 1, -1, -1)))]


def n_vars_of(dims):
    return max(sd for _, sd in dims) + 1


# ---------------------------------------------------------------------------
# kernel layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("pattern", sorted(DIMS))
def test_count_and_list_match_reference(pattern, graph, seed):
    csr = graph_csr(*GRAPHS[graph](seed))
    dims = DIMS[pattern]
    n = n_vars_of(dims)
    csrs = [csr] * len(dims)
    want, want_rows = reference_fused_ref(dims, csrs, n, mode="list")
    assert fused_ref(dims, csrs, n, mode="list")[0] == want
    with ref_ledger.attach() as r_kl:
        assert ref_ops.fused_count(dims, csrs, n, interpret=True) == want
    with port_ledger.attach() as p_kl:
        assert fused_count(dims, tensors(csrs), n) == want
    assert p_kl.invocations == r_kl.invocations == 1
    # the full listing, then a capacity below the total: both must equal
    # the reference program's buffer row for row (its traversal order)
    for cap in (max(1, want), max(1, want // 3), 1):
        r_total, r_rows = ref_ops.fused_list(dims, csrs, n, capacity=cap,
                                             interpret=True)
        p_total, p_rows = fused_list(dims, tensors(csrs), n, capacity=cap)
        assert p_total == r_total == want
        assert p_rows.dtype == np.int64 and p_rows.shape == r_rows.shape
        np.testing.assert_array_equal(p_rows, r_rows)
        if cap >= want:
            np.testing.assert_array_equal(canonical(p_rows),
                                          canonical(want_rows))


@pytest.mark.parametrize("pattern", sorted(DIMS))
def test_per_row_counts_of_the_plain_version(pattern):
    """fused_count_ref's per-depth-0-row counts sum to the oracle and are
    int64; SENTINEL padding of the frontier counts 0."""
    csr = graph_csr(*er_graph(36, 0.25, 5))
    dims = DIMS[pattern]
    n = n_vars_of(dims)
    c0, atoms, consts = fused_ops.padded_layout(
        dims, tensors([csr] * len(dims)), n)
    padded = torch.cat([c0, torch.full((5,), SENTINEL, dtype=torch.int32)])
    counts = fused_count_ref(dims, padded, atoms, consts, n)
    assert counts.dtype == torch.int64 and counts.shape == padded.shape
    assert int(counts.sum()) == fused_ref(dims, [csr] * len(dims), n)[0]
    assert not counts[-5:].any()


def test_two_variable_patterns():
    """n_vars = 2: the depth-1 candidates are the innermost ones; with two
    atoms on (0, 1) the second one prunes the first."""
    a = graph_csr(*er_graph(30, 0.3, 1))
    b = graph_csr(*er_graph(30, 0.3, 2))
    for dims, csrs in ((((0, 1),), [a]), (((0, 1), (0, 1)), [a, b])):
        want = reference_fused_ref(dims, csrs, 2)[0]
        assert want > 0
        assert ref_ops.fused_count(dims, csrs, 2, interpret=True) == want
        assert fused_count(dims, tensors(csrs), 2) == want
        r_total, r_rows = ref_ops.fused_list(dims, csrs, 2, capacity=want,
                                             interpret=True)
        p_total, p_rows = fused_list(dims, tensors(csrs), 2, capacity=want)
        assert p_total == r_total == want
        np.testing.assert_array_equal(p_rows, r_rows)


def test_bounded_capacity_is_exact_prefix():
    csr = graph_csr(*er_graph(30, 0.3, 7))
    dims = DIMS["triangle"]
    want, _ = fused_ref(dims, [csr] * 3, 3)
    assert want > 4
    total, rows = fused_list(dims, tensors([csr] * 3), 3, capacity=2)
    assert total == want and len(rows) == 2
    full_total, full = fused_list(dims, tensors([csr] * 3), 3,
                                  capacity=want)
    assert full_total == want
    np.testing.assert_array_equal(rows, full[:2])


def test_empty_graph_and_empty_frontier_launch_nothing():
    empty = (np.zeros(0, np.int64), np.zeros(1, np.int64),
             np.zeros(0, np.int32))
    dims = DIMS["triangle"]
    a = graph_csr(*er_graph(20, 0.3, 1))
    shifted = (a[0] + 1_000, a[1], a[2])
    with port_ledger.attach() as kl:
        assert fused_count(dims, tensors([empty] * 3), 3) == 0
        total, rows = fused_list(dims, tensors([empty] * 3), 3, capacity=4)
        assert total == 0 and rows.shape == (0, 3)
        # disjoint key sets: the depth-0 intersection is empty
        assert fused_count(dims, tensors([a, shifted, a]), 3) == 0
        assert fused_ops.padded_layout(dims, tensors([a, shifted, a]),
                                       3) is None
    assert kl.invocations == 0
    assert ref_ops.fused_count(dims, [a, shifted, a], 3, interpret=True) == 0


def test_starts_only_constant_depth():
    """Diamond dims leave variable 1 unbound by any atom: its candidates
    are a binding-independent key intersection, a constant row; an empty
    one ends the box without a launch."""
    csr = graph_csr(*er_graph(28, 0.25, 3))
    dims = DIMS["diamond"]
    want, want_rows = fused_ref(dims, [csr] * 4, 4, mode="list")
    assert fused_count(dims, tensors([csr] * 4), 4) == want
    total, rows = fused_list(dims, tensors([csr] * 4), 4,
                             capacity=max(1, want))
    assert total == want
    np.testing.assert_array_equal(canonical(rows), canonical(want_rows))
    # atoms starting at 1 with disjoint keys: the constant row is empty
    shifted = (csr[0] + 1_000, csr[1], csr[2])
    csrs = [csr, shifted, csr, csr]
    with port_ledger.attach() as kl:
        assert fused_count(dims, tensors(csrs), 4) == 0
    assert kl.invocations == 0
    assert ref_ops.fused_count(dims, csrs, 4, interpret=True) == 0


def test_supported_gate_matches_reference():
    cases = [(DIMS["triangle"], 3), (DIMS["diamond"], 4), ((), 3),
             (((0, 1),), 1), (((1, 0),), 2), (((0, 1),), 3),
             (((0, 2), (2, 3)), 4), (tuple((d, d + 1) for d in range(7)), 8)]
    for dims, n in cases:
        assert (fused_supported(dims, n) is None) \
            == (ref_ops.fused_supported(dims, n) is None), (dims, n)
    assert "MAX_DEPTH" in fused_supported(cases[-1][0], 8)
    with pytest.raises(FusedUnsupported):
        fused_count(((1, 0),), tensors([graph_csr(*er_graph(10, 0.3, 0))]),
                    2)


@pytest.mark.parametrize("case", ["id_range", "not_a_set", "atoms"])
def test_outside_the_envelope_raises(case):
    """The port's envelope: int32 vertex ids below SENTINEL, rows that are
    sets, at most MAX_ATOMS atoms. Outside it FusedUnsupported is raised
    on every device, so the engine falls back the same way everywhere."""
    csr = graph_csr(*er_graph(20, 0.3, 4))
    dims = DIMS["triangle"]
    csrs = [csr] * 3
    if case == "id_range":
        big = (csr[0] + 2 ** 31, csr[1], csr[2])
        csrs = [big, big, csr]
    elif case == "not_a_set":
        vals = csr[2].copy()
        row = int(np.argmax(np.diff(csr[1]) >= 2))
        vals[csr[1][row] + 1] = vals[csr[1][row]]       # a repeated value
        csrs = [csr, (csr[0], csr[1], vals), csr]
    else:
        dims = DIMS["triangle"] * 6
        csrs = [csr] * len(dims)
        # the reference has no atom limit and still answers
        assert ref_ops.fused_count(dims, csrs, 3, interpret=True) \
            == fused_ref(dims, csrs, 3)[0]
    with pytest.raises(FusedUnsupported):
        fused_count(dims, tensors(csrs), 3)
    with pytest.raises(FusedUnsupported):
        fused_list(dims, tensors(csrs), 3, capacity=8)


def test_malformed_inputs_raise_value_error():
    csr = tensors([graph_csr(*er_graph(20, 0.3, 4))])[0]
    dims = DIMS["triangle"]
    with pytest.raises(ValueError, match="offsets"):
        fused_count(dims, [csr, csr, (csr[0], csr[1][:-1], csr[2])], 3)
    with pytest.raises(ValueError, match="CSRs"):
        fused_count(dims, [csr, csr], 3)
    with pytest.raises(ValueError, match="capacity"):
        fused_list(dims, [csr] * 3, 3, capacity=0)


def _envelope_case(case):
    """(atom CSRs of a triangle box, the exception type and message the
    envelope raises for them): each check on its own, and several failing
    atoms, where the first failure in atom order (its metadata, then
    offsets, key ids, value ids, sets) decides."""
    csr = graph_csr(*er_graph(20, 0.3, 4))
    keys, off, vals = (np.asarray(a).copy() for a in csr)
    nv, nk = len(vals), len(keys)
    row = int(np.argmax(np.diff(off) >= 2))
    sets = "keys and adjacency rows must be strictly increasing sets"
    ids = "vertex ids must lie in [0, 2147483647)"
    bad = {}
    if case == "offsets_start":
        o = off.copy()
        o[0] = 1
        bad[1] = (keys, o, vals)
        return bad, ValueError, f"fused: atom 1 offsets do not index its " \
            f"{nv} values"
    if case == "offsets_end":
        o = off.copy()
        o[-1] = nv - 1
        bad[2] = (keys, o, vals)
        return bad, ValueError, f"fused: atom 2 offsets do not index its " \
            f"{nv} values"
    if case == "offsets_decrease":
        o = off.copy()
        o[row + 1], o[row] = o[row], o[row + 1]
        bad[0] = (keys, o, vals)
        return bad, ValueError, f"fused: atom 0 offsets do not index its " \
            f"{nv} values"
    if case == "key_negative":
        k = keys.copy()
        k[0] = -1
        bad[1] = (k, off, vals)
        return bad, FusedUnsupported, f"atom 1 keys: {ids}"
    if case == "value_too_large":
        v = vals.astype(np.int64)
        v[-1] = 2 ** 31
        bad[0] = (keys, off, v)
        return bad, FusedUnsupported, f"atom 0 vals: {ids}"
    if case == "keys_not_increasing":
        k = keys.copy()
        k[1], k[2] = k[2], k[1]
        bad[2] = (k, off, vals)
        return bad, FusedUnsupported, f"atom 2: {sets}"
    if case == "row_decreasing":
        v = vals.copy()
        v[off[row]], v[off[row] + 1] = v[off[row] + 1], v[off[row]]
        bad[1] = (keys, off, v)
        return bad, FusedUnsupported, f"atom 1: {sets}"
    if case == "offset_count":
        bad[1] = (keys, off[:-1], vals)
        return bad, ValueError, f"fused: atom 1 has {nk} keys but {nk} " \
            "offsets"
    if case == "dtype":
        bad[0] = (keys.astype(np.float32), off, vals)
        return bad, ValueError, "fused: atom 0 keys must be a 1-D " \
            f"int32/int64 tensor, got torch.float32 ({nk},)"
    if case == "first_of_several":
        # atom 0 holds a repeated value, atom 1 malformed offsets, atom 2
        # a float value array: atom 0's failure raises
        v = vals.copy()
        v[off[row] + 1] = v[off[row]]
        o = off.copy()
        o[0] = 3
        bad = {0: (keys, off, v), 1: (keys, o, vals),
               2: (keys, off, vals.astype(np.float64))}
        return bad, FusedUnsupported, f"atom 0: {sets}"
    if case == "metadata_after_values":
        # atom 1 holds an id out of range, atom 2 a float value array
        k = keys.copy()
        k[-1] = 2 ** 31 - 1
        bad = {1: (k, off, vals), 2: (keys, off, vals.astype(np.float64))}
        return bad, FusedUnsupported, f"atom 1 keys: {ids}"
    assert case == "metadata_before_values"
    # atom 0 has a float key array, atom 1 a decreasing row: atom 0 raises
    v = vals.copy()
    v[off[row]], v[off[row] + 1] = v[off[row] + 1], v[off[row]]
    bad = {0: (keys.astype(np.float64), off, vals), 1: (keys, off, v)}
    return bad, ValueError, "fused: atom 0 keys must be a 1-D int32/int64 " \
        f"tensor, got torch.float64 ({nk},)"


ENVELOPE_CASES = ("offsets_start", "offsets_end", "offsets_decrease",
                  "key_negative", "value_too_large", "keys_not_increasing",
                  "row_decreasing", "offset_count", "dtype",
                  "first_of_several", "metadata_after_values",
                  "metadata_before_values")


@pytest.mark.parametrize("case", ENVELOPE_CASES)
def test_envelope_checks_raise_in_atom_order(case):
    """The envelope's checks reach the host in one read; each raises the
    same exception type and message as when it was checked on its own,
    and with several failing atoms the first in atom order raises."""
    import re
    bad, exc, msg = _envelope_case(case)
    csr = graph_csr(*er_graph(20, 0.3, 4))
    csrs = [bad.get(ai, csr) for ai in range(3)]
    dims = DIMS["triangle"]
    with pytest.raises(exc, match=f"^{re.escape(msg)}$"):
        fused_count(dims, tensors(csrs), 3)
    with pytest.raises(exc, match=f"^{re.escape(msg)}$"):
        fused_list(dims, tensors(csrs), 3, capacity=8)


# the count kernel's tile launch: its warps (csrc/lftj_fused.cu
# kTileBlocks, eight warps a block) and a warp's slice of shared memory in
# 32-bit words (kCountWarpWin): a bitmap of up to 32 times as many ids, or
# a copy of up to WIDE values (csrc/intersect_core.cuh warp_chunks)
TILE_WARPS = 132 * 4 * 8
WARP_WIN = 1024
BITS = 32 * WARP_WIN
WIDE = WARP_WIN - 4


def _row(csr, v):
    keys, off, vals = csr
    i = int(np.searchsorted(keys, v))
    if i < len(keys) and keys[i] == v:
        return np.asarray(vals[off[i]:off[i + 1]], dtype=np.int64)
    return np.zeros(0, np.int64)


def mirror_warp_chunks(items, warps=TILE_WARPS):
    """The count kernel's innermost split in numpy: items are (narrow,
    wide, further rows) of the last frontier's prefixes; each prefix's
    work, the length of its narrow row, is scanned, and warp g takes the
    probes [g·c, (g + 1)·c), c = ceil(total / warps), item by item. A warp
    prepares an item's wide row once and keeps it while the next items
    share it: a bitmap when its ids span at most BITS values, a copy when
    it holds at most WIDE values (its lanes take contiguous runs), else,
    per item, the window [lb(wide, first probe), lb(wide, last probe) + 1)
    when that fits (it must hold every hit), or lanes striding the probes.
    Returns (bindings, the (prefix, probe) pairs covered, the modes
    taken)."""
    work = np.array([len(n) for n, _, _ in items], dtype=np.int64)
    work_off = np.concatenate([[0], np.cumsum(work)])
    total, n = int(work_off[-1]), len(items)
    chunk = -(-total // warps)
    count, covered, modes = 0, [], set()
    for gw in range(warps):
        g, g1 = min(total, gw * chunk), min(total, (gw + 1) * chunk)
        if g >= g1:
            continue
        p = int(np.searchsorted(work_off[:n], g, side="right")) - 1
        kept = None
        while g < g1:
            while work_off[p + 1] <= g:
                p += 1
            base = int(work_off[p])
            s, e = g - base, min(g1, int(work_off[p + 1])) - base
            narrow, wide, rest = items[p]
            if kept is not wide:
                kept = wide
                span = int(wide[-1]) - int(wide[0]) + 1
                mode = "bitmap" if span <= BITS else \
                    "copy" if len(wide) <= WIDE else "window"
            found = set(wide.tolist())
            if mode == "window":
                lo = int(np.searchsorted(wide, narrow[s]))
                hi = min(len(wide), int(np.searchsorted(wide,
                                                        narrow[e - 1])) + 1)
                if hi - lo <= WIDE:
                    window = set(wide[lo:hi].tolist())
                    # every hit of the item's probes lies in the window
                    assert found & set(narrow[s:e].tolist()) <= window
                    found = window
                    kept = None  # a window, not the row: not kept
                else:
                    mode = "global"
            modes.add(mode)
            for j in range(s, e):
                x = int(narrow[j])
                covered.append((p, j))
                count += x in found and all(x in set(r.tolist())
                                            for r in rest)
            g = base + e
    return count, sorted(covered), modes


def mirror_count(dims, csrs, n_vars, cap):
    """The count kernel's walk in numpy (csrc/lftj_fused.cu count_walk):
    each frontier resolves its entries' bound rows once (the narrowest the
    candidate source, lowest atom on ties; a starts-only depth's constant
    row), scans the source lengths, and expands its (entry, candidate)
    pairs in chunks of at most ``cap`` into the next frontier, depth first
    over the chunks; the last depth goes through mirror_warp_chunks
    (an item whose only bound row is its source stands in with that row
    as its wide one: every candidate is a binding). Asserts
    that no frontier outgrows ``cap`` and that the tiles cover every
    probe once."""
    by_second = [[a for a, (_, sd) in enumerate(dims) if sd == d]
                 for d in range(n_vars)]

    def key_set(d):
        cand = None
        for a, (fd, _) in enumerate(dims):
            if fd == d:
                k = np.asarray(csrs[a][0], dtype=np.int64)
                cand = k if cand is None else cand[np.isin(cand, k)]
        return np.zeros(0, np.int64) if cand is None else cand

    def resolve(d, vals):
        n = len(vals[0])
        srcs, others = [], []
        for i in range(n):
            if not by_second[d]:
                srcs.append(key_set(d))
                others.append([])
                continue
            rows = [_row(csrs[a], vals[dims[a][0]][i]) for a in by_second[d]]
            k = min(range(len(rows)), key=lambda j: (len(rows[j]), j))
            srcs.append(rows[k])
            others.append([r for j, r in enumerate(rows) if j != k])
        return srcs, others

    def walk(d, vals):
        srcs, others = resolve(d, vals)
        if d == n_vars - 1:
            items = [(s, o[0] if o else s, o[1:])
                     for s, o in zip(srcs, others)]
            count, covered, _ = mirror_warp_chunks(items)
            assert covered == [(p, j) for p, (s, _, _) in enumerate(items)
                               for j in range(len(s))]
            return count
        work_off = np.concatenate([[0], np.cumsum([len(s) for s in srcs])])
        acc = 0
        for p0 in range(0, int(work_off[-1]), cap):
            nxt = [[] for _ in range(d + 1)]
            for p in range(p0, min(int(work_off[-1]), p0 + cap)):
                e = int(np.searchsorted(work_off[:-1], p, side="right")) - 1
                v = srcs[e][p - work_off[e]]
                if all(v in set(r.tolist()) for r in others[e]):
                    for j in range(d):
                        nxt[j].append(vals[j][e])
                    nxt[d].append(v)
            assert len(nxt[d]) <= cap
            if nxt[d]:
                acc += walk(d + 1, [np.asarray(c) for c in nxt])
        return acc

    c0 = key_set(0)
    return walk(1, [c0]) if len(c0) else 0


@pytest.mark.parametrize("cap", [1, 3, 64, 1 << 16])
@pytest.mark.parametrize("pattern", sorted(DIMS))
def test_count_walk_and_tiles_mirror_match_oracle(pattern, cap):
    """The count kernel's chunked walk and innermost work split, mirrored
    in numpy, give fused_ref's count on every pattern, with frontier
    regions from one entry to the kernel's smallest default."""
    dims = DIMS[pattern]
    n = n_vars_of(dims)
    for seed, make in ((0, lambda: er_graph(24, 0.3, 6)),
                       (1, lambda: star_graph(3, 18, 2))):
        csrs = [graph_csr(*make())] * len(dims)
        assert mirror_count(dims, csrs, n, cap) == fused_ref(dims, csrs,
                                                             n)[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_warp_split_matches_brute_force(seed):
    """The innermost split on prefixes as the main path gives them (runs
    of prefixes sharing a wide row, a few hub prefixes over long rows,
    rows whose ids span more than a bitmap, rows past a warp's copy):
    every probe covered once and the count equal to brute force, on the
    tile launch's warps and on a few (long shares, many items each), with
    every way of holding the wide row taken."""
    rng = np.random.default_rng(seed)
    items = []
    while len(items) < 120:
        ln_w = int(rng.integers(1, 2600))
        # ids spread over up to 40 times the row's length (a sparse row)
        # or packed within BITS (a dense box's row)
        hi = 40 * ln_w if rng.random() < 0.5 else min(BITS, 4 * ln_w)
        wide = np.sort(rng.choice(hi, size=ln_w, replace=False))
        for _ in range(int(rng.integers(1, 6))):  # prefixes sharing it
            ln = int(rng.integers(0, min(ln_w, 3000 if rng.random() < 0.1
                                         else 50) + 1))
            narrow = np.sort(rng.choice(hi, size=ln, replace=False))
            rest = [np.sort(rng.choice(hi, size=min(hi, ln_w),
                                       replace=False))
                    for _ in range(int(rng.integers(0, 2)))]
            items.append((narrow, wide, rest))
    want = sum(len(set(n.tolist()) & set(w.tolist()).intersection(
        *[set(r.tolist()) for r in rest])) for n, w, rest in items)
    modes = set()
    for warps in (TILE_WARPS, 7):
        count, covered, taken = mirror_warp_chunks(items, warps)
        assert count == want
        assert covered == [(p, j) for p, (n, _, _) in enumerate(items)
                           for j in range(len(n))]
        modes |= taken
    assert modes == {"bitmap", "copy", "window", "global"}


@pytest.mark.parametrize("pattern", sorted(DIMS))
def test_count_region_holds_leading_starts_only_expansion(pattern,
                                                          monkeypatch):
    """The count kernel's frontier region: a box whose depth 1 is
    starts-only (the diamond ordered from w) is sized by its depth-1
    expansion |c0| · |constant row|, which its walk then takes in one
    chunk; a box without one by its depth-0 rows and atom values; both
    within ``_COUNT_CAP``. The mirrored walk at the box's own region
    equals fused_ref."""
    dims = DIMS[pattern]
    n = n_vars_of(dims)
    csrs = [graph_csr(*er_graph(40, 0.3, 5))] * len(dims)
    atom_dims, tcsrs, c0, consts = fused_ops._prepare(dims, tensors(csrs), n)
    leading = fused_ops._leading(atom_dims, n, consts)
    words = c0.numel() + sum(v.numel() for _, _, v in tcsrs)
    if pattern == "diamond":
        assert leading == [consts[0].numel()]
        need = max(words, c0.numel() * consts[0].numel())
    else:
        assert leading == []
        need = words
    lo, hi = fused_ops._COUNT_CAP
    assert fused_ops._count_cap(c0, tcsrs, leading) == \
        min(hi, max(lo, 1 << (need - 1).bit_length()))
    # with no floor, the box's own size shows
    monkeypatch.setattr(fused_ops, "_COUNT_CAP", (1, hi))
    cap = fused_ops._count_cap(c0, tcsrs, leading)
    assert cap == 1 << (need - 1).bit_length()
    assert mirror_count(dims, csrs, n, cap) == fused_ref(dims, csrs, n)[0]


def test_kernel_descriptor_layout():
    """The int64 descriptor the wrapper hands the CUDA launcher: n_vars,
    n_atoms, per atom (fd, sd, pointers, key count), per depth the
    constant row of a starts-only depth."""
    csr = tensors([graph_csr(*er_graph(28, 0.25, 3))])[0]
    dims = DIMS["diamond"]
    _, csrs, c0, consts = fused_ops._prepare(dims, [csr] * 4, 4)
    desc = fused_ops._descriptor(dims, csrs, consts, 4)
    assert desc.shape == (2 + 6 * fused_ops.MAX_ATOMS
                          + 2 * fused_ops.MAX_DEPTH,)
    assert list(desc[:2]) == [4, 4]
    for ai, (fd, sd) in enumerate(dims):
        e = desc[2 + 6 * ai:8 + 6 * ai]
        assert (e[0], e[1], e[5]) == (fd, sd, csrs[ai][0].numel())
        assert e[2] == csrs[ai][0].data_ptr()
    base = 2 + 6 * fused_ops.MAX_ATOMS
    assert desc[base + 2] == consts[0].data_ptr()       # depth 1
    assert desc[base + 3] == consts[0].numel() > 0
    assert not desc[base + 4:].any() and not desc[base:base + 2].any()


# ---------------------------------------------------------------------------
# engine layer: backend="fused"
# ---------------------------------------------------------------------------

ENGINE_GRAPHS = {
    "rmat": lambda: r_graphs.rmat_graph(200, 1800, seed=1),
    "star": lambda: star_graph(4, 60, 3),
    "clustered": lambda: r_graphs.clustered_graph(4, 32, seed=2, p_in=0.5),
}

STAT_FIELDS = ("n_boxes", "n_dense_boxes", "n_binary_boxes", "n_host_boxes",
               "n_fused_boxes", "n_rescans", "padded_words", "actual_words",
               "device_invocations", "max_box_device_invocations",
               "n_streamed_boxes", "slice_words_read", "max_slice_words",
               "max_slice_padded_words", "block_reads", "block_writes",
               "word_reads")


def run_engine(eng):
    count = eng.count()
    count_stats = {f: getattr(eng.stats, f) for f in STAT_FIELDS}
    tris = eng.list()
    return count, count_stats, tris, {f: getattr(eng.stats, f)
                                      for f in STAT_FIELDS}


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("mem", [None, 800])
@pytest.mark.parametrize("graph", sorted(ENGINE_GRAPHS))
def test_fused_engine_matches_reference(graph, mem, workers):
    src, dst = ENGINE_GRAPHS[graph]()
    kw = dict(mem_words=mem, workers=workers, backend="fused")
    r_eng = RefEngine(src, dst, shard=False, **kw)
    p_eng = TriangleEngine(src, dst, torch_device="cpu", **kw)
    ref, port = run_engine(r_eng), run_engine(p_eng)
    assert p_eng.plan() == r_eng.plan()
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2].tobytes() == ref[2].tobytes() and len(port[2]) == port[0]
    assert port[3] == ref[3]
    assert port[1]["n_fused_boxes"] > 0
    assert port[1]["device_invocations"] == port[1]["n_fused_boxes"]
    assert port[0] == RefEngine(src, dst, shard=False).count()


def test_fused_lane_outside_envelope_falls_back(monkeypatch):
    """A box outside the fused envelope takes the binary lane off the card
    and the intersect lane on it, and still gives the reference's count."""
    src, dst = ENGINE_GRAPHS["rmat"]()
    want = RefEngine(src, dst, shard=False, mem_words=800,
                     backend="fused").count()

    def outside(*args, **kw):
        raise FusedUnsupported("box outside the envelope")

    monkeypatch.setattr(fused_ops, "fused_count", outside)
    eng = TriangleEngine(src, dst, mem_words=800, backend="fused",
                         torch_device="cpu")
    assert eng.count() == want
    s = eng.stats
    assert s.n_fused_boxes == 0 and s.device_invocations == 0
    assert s.n_binary_boxes == s.n_streamed_boxes > 0
    # the card's fallback lane: the intersect kernel (its plain version
    # here, since the tensors lie on the CPU)
    ex = eng._make_executor()
    ex.use_kernels = True
    assert sum(ex.count_box(box) for box in eng.plan()) == want
    assert ex.stats.n_intersect_boxes > 0 and ex.stats.n_fused_boxes == 0


def test_fused_count_box_matches_reference():
    src, dst = ENGINE_GRAPHS["clustered"]()
    r_eng = RefEngine(src, dst, mem_words=800, shard=False, backend="fused")
    p_eng = TriangleEngine(src, dst, mem_words=800, backend="fused",
                           torch_device="cpu")
    r_ex, p_ex = r_eng._make_executor(), p_eng._make_executor()
    for box in r_eng.plan():
        assert p_ex.count_box(box) == r_ex.count_box(box)
    for f in ("n_fused_boxes", "device_invocations", "padded_words",
              "actual_words"):
        assert getattr(p_ex.stats, f) == getattr(r_ex.stats, f), f


def test_listing_hands_card_tensors_to_its_kernel(monkeypatch):
    """fused_list runs its plain version for CPU tensors and hands CUDA
    tensors to the listing kernel's launcher, whose rows it returns as
    int64 (no fallback to the plain version); any other device raises
    ValueError, as fused_count does."""
    csr = tensors([graph_csr(*er_graph(20, 0.3, 4))])[0]
    dims = DIMS["triangle"]
    _, csrs, c0, consts = fused_ops._prepare(dims, [csr] * 3, 3)

    class OnCard:
        """The depth-0 frontier as the wrapper sees a CUDA tensor."""
        device = torch.device("cuda")

        def numel(self):
            return c0.numel()

    launched = []

    def launch_list(prep, capacity):
        launched.append((prep[2], capacity))
        return 5, torch.arange(9, dtype=torch.int32).reshape(3, 3)

    monkeypatch.setattr(fused_ops, "launch_list", launch_list)
    card = OnCard()
    monkeypatch.setattr(fused_ops, "_prepare",
                        lambda *a: (dims, csrs, card, consts))
    total, rows = fused_list(dims, [csr] * 3, 3, capacity=8)
    assert launched == [(card, 8)]
    assert total == 5 and rows.dtype == np.int64
    assert np.array_equal(rows, np.arange(9).reshape(3, 3))
    meta = c0.to("meta")
    monkeypatch.setattr(fused_ops, "_prepare",
                        lambda *a: (dims, csrs, meta, consts))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_list(dims, [csr] * 3, 3, capacity=8)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_count(dims, [csr] * 3, 3)


def test_listing_workspace_regrows_and_reruns_once(monkeypatch):
    """launch_list's protocol around the listing kernel, with a launcher
    that computes the call with the plain version: one launch and one
    header read per call; when the kept workspace is too small the kernel
    reports overflow and the words it needs, the workspace grows to that
    and the call runs once more (rows byte-equal to the plain version);
    the workspace is kept and never shrinks; a second overflow raises."""
    csr = tensors([graph_csr(*er_graph(40, 0.3, 5))])[0]
    dims = DIMS["four_clique"]
    prep = fused_ops._prepare(dims, [csr] * 6, 4)
    layout = fused_ops.padded_layout(dims, [csr] * 6, 4)
    base, need = 16, [1 << 16]
    runs = []

    class Lib:
        @staticmethod
        def lftj_list_base_words(grid):
            return base

    def launch(lib, desc, c0, ws, capacity, grid):
        runs.append(ws.numel())
        if ws.numel() < need[0]:
            ws[:6] = torch.tensor([base, 1, need[0], 0, 0, 0])
        else:
            total, rows = fused_list_ref(dims, *layout, 4, capacity)
            flat = rows.to(torch.int32).flatten()
            ws.view(torch.int32)[2 * base:2 * base + flat.numel()] = flat
            ws[:6] = torch.tensor([base + flat.numel(), 0, need[0], total,
                                   base, rows.shape[0]])
        return ws[:6].tolist()

    monkeypatch.setattr(fused_ops, "_library", lambda: Lib)
    monkeypatch.setattr(fused_ops, "_list_grid", lambda lib, dev: 4)
    monkeypatch.setattr(fused_ops, "_launch_list", launch)
    monkeypatch.setattr(fused_ops, "_workspaces", {})
    # the listing's workspace is the one kept for the caller's stream
    monkeypatch.setattr(fused_ops._build, "stream_ptr", lambda dev: 7)
    before = fused_ops.LIST_LAUNCHES.n
    for cap in (7, 10_000):
        want_total, want = fused_list_ref(dims, *layout, 4, cap)
        total, rows = fused_ops.launch_list(prep, cap)
        assert total == want_total > 7
        assert rows.dtype == torch.int32
        assert rows.long().numpy().tobytes() == want.numpy().tobytes()
    # the first call overflowed the first workspace and ran again in one
    # of the reported size; the second ran once in the kept workspace
    assert len(runs) == 3 and runs[0] < need[0] and runs[1:] == [need[0]] * 2
    assert fused_ops.LIST_LAUNCHES.n - before == 2
    assert list(fused_ops._workspaces) == [(torch.device("cpu"), 7)]
    need[0] = 1 << 10                   # a smaller call keeps the workspace
    fused_ops.launch_list(prep, 7)
    assert runs[-1] == 1 << 16
    need[0] = 1 << 30
    Lib.lftj_list_base_words = staticmethod(lambda grid: 1 << 17)

    def always_short(lib, desc, c0, ws, capacity, grid):
        runs.append(ws.numel())
        return [base, 1, ws.numel() + 1, 0, 0, 0]

    monkeypatch.setattr(fused_ops, "_launch_list", always_short)
    with pytest.raises(RuntimeError, match="overflowed again"):
        fused_ops.launch_list(prep, 7)


def test_workspace_is_kept_per_device_and_stream(monkeypatch):
    """The fused kernels' workspace is keyed by (device, stream): calls on
    one stream share a buffer that only grows, another stream gets its
    own, and a grow on one stream leaves every other stream's buffer (which
    a launch there may still read) as it was. Fake stream pointers go
    through the same helpers the launches use."""
    monkeypatch.setattr(fused_ops, "_workspaces", {})
    cpu = torch.device("cpu")
    s1, s2 = fused_ops._slot(cpu, 0x1000), fused_ops._slot(cpu, 0x2000)
    assert s1 is fused_ops._slot(cpu, 0x1000) and s1 is not s2
    assert s1.lock is not s2.lock
    a = fused_ops._workspace(s1, cpu, 64)
    b = fused_ops._workspace(s2, cpu, 64)
    assert a.data_ptr() != b.data_ptr()
    assert fused_ops._workspace(s1, cpu, 32) is a       # kept, not shrunk
    grown = fused_ops._workspace(s1, cpu, 128)
    assert grown.numel() == 128 and grown is not a
    assert fused_ops._workspace(s2, cpu, 64) is b       # other stream kept
    assert set(fused_ops._workspaces) == {(cpu, 0x1000), (cpu, 0x2000)}
