"""repro_torch's GNN data and configs against the reference's, on the CPU.

``data.graphs.synthetic_features``, ``make_gnn_batch`` and
``icosahedral_mesh`` (refinements 0-3) and ``data.sampler.NeighborSampler``
give the reference's arrays bit for bit (values and dtypes) for the same
arguments; the reference's ``TestSampler`` and ``TestIcoMesh`` assertions
hold on the port. The four GNN configs equal the reference's field for
field, the registry holds the five ported archs, and ``input_specs`` of
every GNN arch at every GNN shape equals the reference's
``gnn_input_specs`` in names, shapes and dtypes (tensors on the ``meta``
device). No tolerance: everything here is compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import config_for_shape as ref_config_for_shape
from repro.configs import get_arch as ref_get_arch
from repro.configs import input_specs as ref_input_specs
from repro.core import csr_from_edges as ref_csr_from_edges
from repro.data import graphs as RG
from repro.data.sampler import NeighborSampler as RefSampler
from repro_torch.configs import (all_arch_ids, config_for_shape, get_arch,
                                 input_specs)
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.core.lftj_torch import csr_from_edges
from repro_torch.data import graphs as G
from repro_torch.data.sampler import NeighborSampler

GNN_ARCHS = ["gcn-cora", "gin-tu", "graphcast", "schnet"]


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def assert_arrays_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# generators and batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,c,seed", [(1, 1, 2, 0), (48, 12, 3, 1),
                                        (500, 30, 7, 5)])
def test_synthetic_features_equal_reference(n, d, c, seed):
    assert_arrays_equal(G.synthetic_features(n, d, c, seed),
                        RG.synthetic_features(n, d, c, seed))


@pytest.mark.parametrize("kw", [
    dict(n_classes=5, seed=1),
    dict(n_classes=7, pad_to=512, seed=0),
    dict(d_target=1, pad_to=64, seed=3),
    dict(d_target=2, seed=4, with_pos=True),
    dict(n_classes=1, pad_to=100, seed=2),
])
def test_make_gnn_batch_equals_reference(kw):
    kw = dict(kw)
    src, dst = RG.random_graph(300, 1200, seed=kw["seed"])
    if kw.pop("with_pos", False):
        kw["pos"] = np.random.default_rng(9).standard_normal(
            (300, 3)).astype(np.float32)
    assert_arrays_equal(G.make_gnn_batch(src, dst, 300, 16, **kw),
                        RG.make_gnn_batch(src, dst, 300, 16, **kw))


@pytest.mark.parametrize("refinement", [0, 1, 2, 3])
def test_icosahedral_mesh_equals_reference(refinement):
    got = G.icosahedral_mesh(refinement)
    want = RG.icosahedral_mesh(refinement)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


class TestIcoMesh:
    """The reference's ``tests/test_data.py::TestIcoMesh``, on the port."""

    def test_refinement_counts(self):
        verts, src, dst = G.icosahedral_mesh(2)
        # V(r) = 10*4^r + 2
        assert len(verts) == 10 * 4 ** 2 + 2
        assert np.all(src < dst)
        np.testing.assert_allclose(np.linalg.norm(verts, axis=1), 1.0,
                                   rtol=1e-5)

    def test_multimesh_includes_coarse_edges(self):
        _, s1, d1 = G.icosahedral_mesh(0)
        _, s2, d2 = G.icosahedral_mesh(1)
        e1 = set(zip(s1.tolist(), d1.tolist()))
        e2 = set(zip(s2.tolist(), d2.tolist()))
        assert e1 <= e2     # multimesh = union over levels


# ---------------------------------------------------------------------------
# the neighbor sampler
# ---------------------------------------------------------------------------

def _sym_csr(n, m, seed, port=True):
    src, dst = RG.random_graph(n, m, seed=seed)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    return (csr_from_edges if port else ref_csr_from_edges)(s2, d2, n)


@pytest.mark.parametrize("fanout,seed", [((5, 3), 0), ((15, 10), 1),
                                         ((4,), 2), ((2, 2, 2), 3)])
def test_sampler_blocks_equal_reference(fanout, seed):
    indptr, indices = _sym_csr(500, 4000, seed)
    ref_indptr, ref_indices = _sym_csr(500, 4000, seed, port=False)
    np.testing.assert_array_equal(indptr, ref_indptr)
    np.testing.assert_array_equal(indices, ref_indices)
    samp = NeighborSampler(indptr, indices, fanout=fanout, seed=seed)
    ref = RefSampler(ref_indptr, ref_indices, fanout=fanout, seed=seed)
    seeds = np.random.default_rng(seed).choice(500, 40, replace=False)
    for _ in range(2):   # the generator's state carries to the next block
        for g, w in zip(samp.sample_block(seeds), ref.sample_block(seeds)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((500, 16)).astype(np.float32)
    labels = rng.integers(0, 7, 500).astype(np.int32)
    assert_arrays_equal(
        samp.padded_batch(seeds, feats, labels, blk_nodes=600,
                          blk_edges=700),
        ref.padded_batch(seeds, feats, labels, blk_nodes=600, blk_edges=700))


class TestSampler:
    """The reference's ``tests/test_data.py::TestSampler``, on the port."""

    def test_block_shapes_and_masks(self):
        indptr, indices = _sym_csr(500, 4000, 1)
        samp = NeighborSampler(indptr, indices, fanout=(5, 3), seed=0)
        feats = np.random.default_rng(0).standard_normal(
            (500, 16)).astype(np.float32)
        labels = np.zeros(500, np.int32)
        batch = samp.padded_batch(np.arange(32), feats, labels,
                                  blk_nodes=32 * 24, blk_edges=32 * 20)
        assert batch["node_feat"].shape == (768, 16)
        ne = int(batch["edge_mask"].sum())
        assert 0 < ne <= 640
        # all masked-in edges reference masked-in nodes
        es = batch["edge_src"][batch["edge_mask"] > 0]
        ed = batch["edge_dst"][batch["edge_mask"] > 0]
        nn = int(batch["node_mask"].sum())
        assert es.max() < nn and ed.max() < nn
        # only seeds supervised
        assert batch["label_mask"].sum() <= 32

    def test_fanout_bound(self):
        indptr, indices = _sym_csr(200, 3000, 2)
        samp = NeighborSampler(indptr, indices, fanout=(4,), seed=0)
        nodes, es, ed = samp.sample_block(np.arange(10))
        assert len(es) <= 10 * 4


# ---------------------------------------------------------------------------
# configs, registry and input specs
# ---------------------------------------------------------------------------

def test_registry_holds_the_five_ported_archs():
    # the five of DLRM and the GNNs, beside the five LMs ported since
    assert [a for a in all_arch_ids() if get_arch(a).family != "lm"] == \
        ["dlrm-mlperf", "gcn-cora", "gin-tu", "graphcast", "schnet"]
    assert len(all_arch_ids()) == 10
    for arch in ("llama4-maverick", "no-such-arch"):
        with pytest.raises(KeyError, match=arch):
            get_arch(arch)


# Fields of the reference's GNNConfig that the port leaves out: its
# ``learn_eps`` is read nowhere (GIN's eps is always a trained param, there
# as here), and ``scan_unroll`` tunes a ``lax.scan`` the port runs as a
# Python loop.
REF_ONLY_FIELDS = ("learn_eps", "scan_unroll")


def _ref_fields(cfg):
    """The reference config's fields without REF_ONLY_FIELDS, which must
    hold what the port always does: eps learned, no scan to unroll."""
    assert cfg.learn_eps and not cfg.scan_unroll, cfg
    d = dataclasses.asdict(cfg)
    for k in REF_ONLY_FIELDS:
        d.pop(k)
    return d


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_configs_equal_reference(arch):
    got, want = get_arch(arch), ref_get_arch(arch)
    assert got.family == want.family == "gnn"
    assert got.notes == want.notes
    for cfg, ref_cfg in ((got.config, want.config),
                         (got.smoke_config, want.smoke_config)):
        assert dataclasses.asdict(cfg) == _ref_fields(ref_cfg)
    assert {k: (s.step, s.dims) for k, s in got.shapes.items()} == \
        {k: (s.step, s.dims) for k, s in want.shapes.items()}
    for shape in GNN_SHAPES:
        assert dataclasses.asdict(config_for_shape(arch, shape)) == \
            _ref_fields(ref_config_for_shape(arch, shape))


@pytest.mark.parametrize("shape", sorted(GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_input_specs_equal_reference(arch, shape):
    for smoke in (False, True):
        ref_step, ref_specs = ref_input_specs(arch, shape, smoke=smoke)
        step, specs = input_specs(arch, shape, smoke=smoke)
        assert step == ref_step == "train"
        assert list(specs) == list(ref_specs)
        for k, spec in ref_specs.items():
            assert specs[k].device.type == "meta"
            assert tuple(specs[k].shape) == tuple(spec.shape), (shape, k)
            assert _dtype_name(specs[k].dtype) == str(spec.dtype), (shape, k)


def test_make_gnn_batch_fits_the_full_graph_spec():
    """``full_graph_sm`` as the smoke builds it: the padded batch has the
    spec's names and dtypes, and at most its node and edge counts."""
    src, dst = G.random_graph(2708, 10556, seed=0)
    batch = G.make_gnn_batch(src, dst, 2708, 1433, n_classes=7, pad_to=512)
    _, specs = input_specs("gcn-cora", "full_graph_sm")
    assert list(batch) == list(specs)
    for k, spec in specs.items():
        assert batch[k].dtype.name == _dtype_name(spec.dtype), k
        assert batch[k].shape[0] <= spec.shape[0], k
        assert batch[k].shape[1:] == tuple(spec.shape[1:]), k
