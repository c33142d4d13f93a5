"""repro_torch.checkpoint.manager against the reference's
``repro.checkpoint.manager`` on the CPU.

Both write the same layout for the same tree: the manifest's keys, shapes
and dtypes are equal for DLRM's ``(params, OptState)``, and a float32
checkpoint written by either restores in the other bit for bit. A
bfloat16 leaf is written as the reference writes one (raw ``|V2`` bits,
``bfloat16`` in the manifest) and restores in the port; the reference's
own restore refuses it (a reference-side fault the port does not copy).
Also the reference's ``TestCheckpoint`` cases, on the port, with
``test_train_resume_equivalence`` on the port's AdamW and on DLRM's
sparse train step.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs.dlrm_mlperf import SMOKE_CONFIG as REF_SMOKE
from repro.models import dlrm as RM
from repro.optim import adamw as RA
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.dlrm_mlperf import SMOKE_CONFIG
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference)
from repro_torch.data.recsys import CriteoLikeGenerator
from repro_torch.models import dlrm as M
from repro_torch.models import layers as L
from repro_torch.optim import adamw as A
from repro_torch.pytree import leaves


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((8, 4))
                                  .astype(np.float32)),
            "nested": {"b": torch.from_numpy(rng.integers(0, 9, (3,))
                                             .astype(np.int32)),
                       "c": [torch.ones((2, 2)), torch.zeros((5,))]}}


def trees_equal(x, y):
    return all(torch.equal(a, b) for a, b in zip(leaves(x), leaves(y)))


def _manifest(d, step):
    return json.loads((Path(d) / f"step_{step:010d}" / "manifest.json")
                      .read_text())


def _dlrm_state(seed=0):
    """The reference's DLRM smoke params and an OptState after two sparse
    steps, and the port's copies of both."""
    rp = RM.init_params(REF_SMOKE, jax.random.PRNGKey(seed))
    ro = RA.init(rp)
    step = jax.jit(RM.make_sparse_train_step(REF_SMOKE, RA.AdamWConfig(
        lr=1e-2, warmup_steps=1)))
    gen = CriteoLikeGenerator(SMOKE_CONFIG.table_sizes, SMOKE_CONFIG.n_dense,
                              SMOKE_CONFIG.hot, seed=seed)
    for _ in range(2):
        rp, ro, _ = step(rp, ro, {k: jnp.asarray(v)
                                  for k, v in gen.batch(16).items()})
    np_p = {k: np.asarray(v) for k, v in rp.items()}
    pp = params_from_reference(np_p)
    po = opt_state_from_reference(RA.OptState(
        np.asarray(ro.step), {k: np.asarray(v) for k, v in ro.m.items()},
        {k: np.asarray(v) for k, v in ro.v.items()}))
    return (rp, ro), (pp, po)


def test_opt_state_carries_across_bit_for_bit():
    (rp, ro), (pp, po) = _dlrm_state()
    assert po.step.dtype == torch.int32 and po.step.shape == ()
    assert int(po.step) == int(ro.step) == 2
    for k in rp:
        assert po.m[k].dtype == po.v[k].dtype == torch.float32
        np.testing.assert_array_equal(po.m[k].numpy(), np.asarray(ro.m[k]))
        np.testing.assert_array_equal(po.v[k].numpy(), np.asarray(ro.v[k]))


def test_manifest_keys_and_dtypes_equal_reference(tmp_path):
    (rp, ro), (pp, po) = _dlrm_state()
    RefManager(tmp_path / "ref", async_save=False).save(2, (rp, ro))
    CheckpointManager(tmp_path / "port", async_save=False).save(2, (pp, po))
    want = _manifest(tmp_path / "ref", 2)["arrays"]
    got = _manifest(tmp_path / "port", 2)["arrays"]
    assert got == want
    for key in ("0/table0", "1/.step", "1/.m/bot_w0", "1/.v/table3"):
        assert key in got
    assert got["1/.step"] == {"shape": [], "dtype": "int32"}
    with np.load(tmp_path / "port" / "step_0000000002" / "arrays.npz") as a:
        assert sorted(a.files) == sorted(got)


def test_reference_checkpoint_restores_in_port(tmp_path):
    (rp, ro), (pp, po) = _dlrm_state(1)
    RefManager(tmp_path, async_save=False).save(7, (rp, ro))
    fresh = {k: torch.full(v.shape, 7.0, dtype=v.dtype)
             for k, v in pp.items()}
    (gp, go), step = CheckpointManager(tmp_path).restore((fresh,
                                                          A.init(fresh)))
    assert step == 7
    assert trees_equal(gp, pp) and trees_equal(go, po)
    assert go.step.dtype == torch.int32


def test_port_checkpoint_restores_in_reference(tmp_path):
    (rp, ro), (pp, po) = _dlrm_state(2)
    CheckpointManager(tmp_path, async_save=False).save(4, (pp, po))
    template = (RM.init_params(REF_SMOKE, jax.random.PRNGKey(9)), None)
    template = (template[0], RA.init(template[0]))
    (gp, go), step = RefManager(tmp_path).restore(template)
    assert step == 4 and int(go.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves((gp, go)),
                    jax.tree_util.tree_leaves((rp, ro))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("async_save", [False, True])
def test_bf16_leaf_roundtrips_as_the_reference_writes_it(tmp_path,
                                                         async_save):
    t = {"w": torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16), "m": torch.zeros(5, 3)}
    mgr = CheckpointManager(tmp_path / "port", async_save=async_save)
    mgr.save(1, t)
    mgr.wait()
    got, _ = mgr.restore({"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                          "m": torch.ones(5, 3)})
    assert got["w"].dtype == torch.bfloat16 and trees_equal(got, t)
    # the reference writes a bfloat16 leaf the same way: |V2 bits,
    # "bfloat16" in the manifest, and the port restores its file
    ref_w = jnp.asarray(t["w"].float().numpy(), jnp.bfloat16)
    RefManager(tmp_path / "ref", async_save=False).save(
        1, {"w": ref_w, "m": jnp.zeros((5, 3))})
    assert _manifest(tmp_path / "ref", 1)["arrays"] == \
        _manifest(tmp_path / "port", 1)["arrays"]
    for d in ("ref", "port"):
        with np.load(tmp_path / d / "step_0000000001" / "arrays.npz") as a:
            assert a["w"].dtype == np.dtype("V2")
    got, _ = CheckpointManager(tmp_path / "ref").restore(t)
    assert trees_equal(got, t)
    # the reference's own restore cannot read that leaf back
    with pytest.raises(TypeError):
        RefManager(tmp_path / "ref").restore({"w": ref_w,
                                              "m": jnp.zeros((5, 3))})


def test_restore_places_leaves_on_the_template_device_and_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"x": torch.arange(6, dtype=torch.int64).view(2, 3)})
    got, _ = mgr.restore({"x": torch.zeros(2, 3, dtype=torch.float32)})
    assert got["x"].dtype == torch.float32
    assert got["x"].tolist() == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]


# ---------------------------------------------------------------------------
# the reference's TestCheckpoint, on the port
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_save=False)
        t = tree(1)
        mgr.save(5, t)
        got, step = mgr.restore(tree(2))
        assert step == 5
        assert trees_equal(got, t)

    def test_async_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_save=True)
        t = tree(3)
        mgr.save(1, t)
        mgr.wait()
        got, _ = mgr.restore(tree(4))
        assert trees_equal(got, t)

    def test_keep_k(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, tree(s))
        assert mgr.all_steps() == [3, 4]

    def test_latest_and_resume(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_save=False)
        mgr.save(10, tree(1))
        mgr.save(20, tree(2))
        got, step = mgr.restore(tree(0))
        assert step == 20
        assert trees_equal(got, tree(2))
        got, step = mgr.restore(tree(0), step=10)
        assert trees_equal(got, tree(1))

    def test_partial_save_ignored(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_save=False)
        mgr.save(1, tree(1))
        crashed = Path(tmp_path) / "step_0000000009.tmp"
        crashed.mkdir()
        (crashed / "arrays.npz").write_bytes(b"garbage")
        half = Path(tmp_path) / "step_0000000008"
        half.mkdir()
        assert mgr.latest_step() == 1
        got, step = mgr.restore(tree(0))
        assert step == 1

    def test_extra_metadata(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_save=False)
        mgr.save(7, tree(1), extra={"loss": 1.5})
        man = _manifest(tmp_path, 7)
        assert man["extra"]["loss"] == 1.5
        assert man["step"] == 7

    def test_train_resume_equivalence(self, tmp_path):
        """Training N steps == training k, restoring, training N-k (exact
        state recovery: params + opt moments + step count)."""
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
        y = x @ torch.tensor([[1.], [2.], [-1.], [0.5]])
        cfg = A.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)

        def step(p, o):
            w = p["w"].detach().requires_grad_()
            (g,) = torch.autograd.grad(torch.mean((x @ w - y) ** 2), [w])
            return A.apply(cfg, p, {"w": g}, o)[:2]

        p = {"w": torch.zeros((4, 1))}
        o = A.init(p)
        for _ in range(10):
            p, o = step(p, o)
        ref = p["w"].clone()

        p2 = {"w": torch.zeros((4, 1))}
        o2 = A.init(p2)
        mgr = CheckpointManager(tmp_path, async_save=False)
        for _ in range(4):
            p2, o2 = step(p2, o2)
        mgr.save(4, (p2, o2))
        (p3, o3), _ = mgr.restore((p2, o2))
        for _ in range(6):
            p3, o3 = step(p3, o3)
        np.testing.assert_allclose(p3["w"].numpy(), ref.numpy(), rtol=1e-5)
        assert torch.equal(p3["w"], ref)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_sparse_train_resume_equivalence(tmp_path, table_dtype):
    """DLRM's sparse step: 5 steps straight equal 2 steps, a save and a
    restore into fresh tensors, then 3 steps, bit for bit (bfloat16
    tables through their |V2 bits)."""
    saved = L.PDTYPE, L.ADTYPE
    L.set_dtypes(table_dtype, torch.float32)
    try:
        cfg = A.AdamWConfig(lr=1e-2, warmup_steps=1)
        step = M.make_sparse_train_step(SMOKE_CONFIG, cfg)

        def start():
            p = M.init_params(SMOKE_CONFIG, torch.Generator().manual_seed(0),
                              device="cpu")
            return p, A.init(p)

        gen = CriteoLikeGenerator(SMOKE_CONFIG.table_sizes, 13,
                                  SMOKE_CONFIG.hot, seed=4)
        batches = [gen.batch(24) for _ in range(5)]
        p, o = start()
        for b in batches:
            p, o, _ = step(p, o, b)
        p2, o2 = start()
        for b in batches[:2]:
            p2, o2, _ = step(p2, o2, b)
        mgr = CheckpointManager(tmp_path, async_save=True)
        mgr.save(2, (p2, o2))
        mgr.wait()
        (p3, o3), at = mgr.restore(start())
        assert at == 2 and int(o3.step) == 2
        assert p3["table0"].dtype == table_dtype
        for b in batches[2:]:
            p3, o3, _ = step(p3, o3, b)
        assert trees_equal(p3, p) and trees_equal(o3, o)
    finally:
        L.set_dtypes(*saved)
