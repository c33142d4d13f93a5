"""repro_torch's fabric dry run (``launch.dryrun``) against the
reference's, on the CPU: the record ``fabric_dryrun`` returns and the JSON
file it writes equal the reference's, every key but ``wall_s`` (exact:
both are the same integer plan), at the sizes of
``tests/test_launch_mesh.py::TestDryrunFabric`` and a few more; the CLI
runs on a host that sees no card; no kernel is launched."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.intersect import ops as intersect_ops
from repro_torch.kernels.lftj_fused import ops as fused_ops
from repro_torch.kernels.triangle_dense import ops as dense_ops
from repro_torch.launch.dryrun import fabric_dryrun, main

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = [intersect_ops.LAUNCHES, dense_ops.LAUNCHES, fused_ops.LAUNCHES,
            fused_ops.LIST_LAUNCHES, *bag_ops.LAUNCHES.values(),
            *bag_ops.ONEHOT_LAUNCHES.values()]


@pytest.fixture
def ref_dryrun(monkeypatch):
    """The reference's ``fabric_dryrun``. Its module appends a forced
    device count to XLA_FLAGS when first imported: the variable is
    restored after the test."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.dryrun import fabric_dryrun as ref
    return ref


def _without_wall(rec):
    return {k: v for k, v in rec.items() if k != "wall_s"}


@pytest.mark.parametrize("kw", [
    dict(n_shards=3, nv=64, ne=200),            # the reference test's
    dict(),                                     # the CLI's defaults
    dict(n_shards=2, pattern="diamond", nv=80, ne=500, mem_words=1 << 7),
    dict(n_shards=5, pattern="four_clique", nv=60, ne=600,
         mem_words=1 << 8, seed=3),
], ids=["test_size", "defaults", "diamond", "four_clique"])
def test_record_and_file_equal_reference(tmp_path, ref_dryrun, kw):
    before = [c.n for c in COUNTERS]
    got = fabric_dryrun(tmp_path / "port", **kw)
    assert [c.n for c in COUNTERS] == before     # nothing launched
    want = ref_dryrun(tmp_path / "ref", **kw)
    assert _without_wall(got) == _without_wall(want)
    assert got["ok"] and got["n_shards"] == kw.get("n_shards", 4)
    assert sum(s["boxes"] for s in got["shards"]) == got["n_boxes"]
    assert sum(s["mass"] for s in got["shards"]) == got["total_mass"]
    name = f"fabric__{kw.get('pattern', 'triangle')}__" \
           f"s{kw.get('n_shards', 4)}.json"
    on_disk = json.loads((tmp_path / "port" / name).read_text())
    ref_disk = json.loads((tmp_path / "ref" / name).read_text())
    assert on_disk == got
    assert _without_wall(on_disk) == _without_wall(ref_disk)
    assert list(on_disk) == list(ref_disk)


def test_cli_runs_with_no_card(tmp_path, ref_dryrun):
    """``python -m repro_torch.launch.dryrun --fabric`` with
    CUDA_VISIBLE_DEVICES="" writes the reference's record."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--fabric",
         "--fabric-shards", "2", "--out", str(tmp_path / "cli")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[OK] fabric__triangle__s2" in res.stdout
    got = json.loads((tmp_path / "cli" / "fabric__triangle__s2.json")
                     .read_text())
    want = ref_dryrun(tmp_path / "ref", n_shards=2)
    assert _without_wall(got) == _without_wall(want)


def test_main_needs_fabric(tmp_path, capsys):
    assert main(["--fabric", "--fabric-shards", "3",
                 "--out", str(tmp_path)]) == 0
    assert (tmp_path / "fabric__triangle__s3.json").exists()
    with pytest.raises(SystemExit) as exc:
        main(["--out", str(tmp_path)])
    assert exc.value.code == 2
    assert "--fabric" in capsys.readouterr().err
