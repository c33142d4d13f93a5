"""The port's crossover calibration cache and the 'measured' thresholds.

The cases of ``tests/test_crossover_cache.py`` run against
``repro_torch.core.engine``'s own cache (``$REPRO_TORCH_CACHE_DIR/
crossover.json``, default ``~/.cache/repro_torch``, keys
``cpu:cpu:...`` or ``cuda:<card name>:...``): the directory override, a
file hit, a corrupt file, atomic stores, threads, the two-process
lost-update race and a remeasure of the active device only. Beside them:
the port never reads or writes the reference's ``$REPRO_CACHE_DIR``; off
the card the intersect and fused calibrations return 1.0 without timing;
``'measured'`` resolves on ``TriangleEngine``. Tolerance: none — values
and key names are exact.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch import TriangleEngine
from repro_torch.core import engine as eng

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "repro-torch-cache"
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(d))
    # the process-level memo would shadow the file under test
    monkeypatch.setattr(eng, "_crossover_memo", {})
    return d


def _load(cache_dir) -> dict:
    with open(cache_dir / "crossover.json") as f:
        return json.load(f)


def _env(cache_dir, **extra):
    env = {**os.environ, "REPRO_TORCH_CACHE_DIR": str(cache_dir),
           "PYTHONPATH": SRC}
    env.update(extra)
    return env


class TestCacheFile:
    def test_cache_dir_override_is_honoured(self, cache_dir):
        assert eng._crossover_cache_file() == \
            str(cache_dir / "crossover.json")
        calls = []
        v = eng._cached_crossover(":t_override", 64,
                                  lambda: calls.append(1) or 0.25)
        assert v == 0.25 and calls == [1]
        data = _load(cache_dir)
        assert any(k.endswith(":t_override") for k in data), data

    def test_default_dir_is_the_ports_own(self, tmp_path, monkeypatch):
        monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))
        assert eng._crossover_cache_file() == str(
            tmp_path / ".cache" / "repro_torch" / "crossover.json")

    def test_file_hit_skips_measure(self, cache_dir):
        eng._cached_crossover(":t_hit", 64, lambda: 0.25)
        eng._crossover_memo.clear()          # simulate a fresh process
        v = eng._cached_crossover(
            ":t_hit", 64,
            lambda: pytest.fail("measure ran despite a cached value"))
        assert v == 0.25

    def test_corrupt_file_degrades_to_remeasure(self, cache_dir):
        os.makedirs(cache_dir, exist_ok=True)
        with open(cache_dir / "crossover.json", "w") as f:
            f.write('{"trunca')             # a torn write without os.replace
        assert eng._crossover_load() == {}
        assert eng._cached_crossover(":t_corrupt", 64, lambda: 0.5) == 0.5
        assert any(k.endswith(":t_corrupt") for k in _load(cache_dir))

    def test_out_of_range_entry_is_remeasured(self, cache_dir):
        os.makedirs(cache_dir, exist_ok=True)
        key = f"{eng._active_prefix()}:nv64:t_range"
        with open(cache_dir / "crossover.json", "w") as f:
            json.dump({key: 0.0}, f)
        assert eng._cached_crossover(":t_range", 64, lambda: 0.5) == 0.5
        assert _load(cache_dir)[key] == 0.5

    def test_store_leaves_no_tmp_droppings(self, cache_dir):
        eng._crossover_store({"a": 0.5})
        eng._crossover_store({"a": 0.5, "b": 0.25})
        assert _load(cache_dir) == {"a": 0.5, "b": 0.25}
        assert [p for p in os.listdir(cache_dir)
                if p.endswith(".tmp")] == []

    def test_keys_name_the_device(self, cache_dir):
        assert eng._active_prefix("cpu") == "cpu:cpu"
        eng._cached_crossover(":t_key", 32, lambda: 0.5, "cpu")
        assert "cpu:cpu:nv32:t_key" in _load(cache_dir)

    def test_reference_cache_is_never_read_or_written(self, cache_dir,
                                                      tmp_path, monkeypatch):
        """A crossover file under the reference's ``$REPRO_CACHE_DIR`` (and
        under ``~/.cache/repro``) holding the very key the port looks up is
        ignored, and neither directory changes."""
        ref_dir = tmp_path / "repro-cache"
        home = tmp_path / "home"
        ref_home = home / ".cache" / "repro"
        key = f"{eng._active_prefix()}:nv64:t_ref"
        for d in (ref_dir, ref_home):
            os.makedirs(d)
            with open(d / "crossover.json", "w") as f:
                json.dump({key: 0.125, "cpu:cpu:nv256": 0.125}, f)
        monkeypatch.setenv("REPRO_CACHE_DIR", str(ref_dir))
        monkeypatch.setenv("HOME", str(home))
        before = {d: sorted(os.listdir(d)) for d in (ref_dir, ref_home)}
        mtimes = {d: os.stat(d / "crossover.json").st_mtime_ns
                  for d in (ref_dir, ref_home)}
        assert eng._cached_crossover(":t_ref", 64, lambda: 0.5) == 0.5
        assert _load(cache_dir)[key] == 0.5
        for d in (ref_dir, ref_home):
            assert sorted(os.listdir(d)) == before[d]
            assert os.stat(d / "crossover.json").st_mtime_ns == mtimes[d]
            assert json.load(open(d / "crossover.json"))[key] == 0.125


class TestConcurrentRemeasure:
    def test_threads_measuring_distinct_keys_all_persist(self, cache_dir):
        errs = []

        def measure(i):
            try:
                eng._cached_crossover(f":t_thr{i}", 64, lambda: 0.25)
            except Exception as e:               # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=measure, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs
        data = _load(cache_dir)
        for i in range(8):
            assert any(k.endswith(f":t_thr{i}") for k in data), (i, data)

    def test_two_process_lost_update_race(self, cache_dir, tmp_path):
        """Process A holds the file lock across its whole read-modify-write
        (having loaded before B stores anything) while process B runs a
        complete ``_cached_crossover``: B serializes behind A, and the
        file ends with both keys."""
        a_ready = tmp_path / "a_ready"
        b_started = tmp_path / "b_started"
        env = _env(cache_dir)

        proc_a = subprocess.Popen([sys.executable, "-c", f"""
import os, time
from repro_torch.core import engine as eng
with eng._crossover_file_lock():
    data = eng._crossover_load()          # stale view, pre-B
    open({str(a_ready)!r}, "w").close()
    deadline = time.monotonic() + 30
    while not os.path.exists({str(b_started)!r}) \\
            and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.5)      # B is now inside _cached_crossover, blocked
    data["procA:manual"] = 0.5
    eng._crossover_store(data)
"""], env=env)

        deadline = time.monotonic() + 60
        while not a_ready.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert a_ready.exists(), "process A never took the lock"

        proc_b = subprocess.Popen([sys.executable, "-c", f"""
import os
open({str(b_started)!r}, "w").close()
from repro_torch.core import engine as eng
eng._cached_crossover(":t_raceB", 64, lambda: 0.25)
"""], env=env)
        assert proc_b.wait(timeout=120) == 0
        assert proc_a.wait(timeout=120) == 0

        data = _load(cache_dir)
        assert "procA:manual" in data, data
        assert any(k.endswith(":t_raceB") for k in data), \
            f"B's entry was clobbered by A's store (lost update): {data}"

    def test_remeasure_clears_only_active_device(self, cache_dir):
        """``REPRO_TORCH_CROSSOVER_REMEASURE=1`` in a fresh process drops
        the active device's entries and measures again; another device's
        calibration in the shared file survives."""
        os.makedirs(cache_dir, exist_ok=True)
        prefix = eng._active_prefix()
        with open(cache_dir / "crossover.json", "w") as f:
            json.dump({f"{prefix}:nv64:t_rm": 0.9,
                       f"{prefix}:nv64:t_other": 0.9,
                       "cuda:NVIDIA H100 80GB HBM3:nv64:t_rm": 0.125}, f)
        out = subprocess.run([sys.executable, "-c", """
from repro_torch.core import engine as eng
print(eng._cached_crossover(":t_rm", 64, lambda: 0.25))
"""], env=_env(cache_dir, REPRO_TORCH_CROSSOVER_REMEASURE="1"),
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().endswith("0.25")
        data = _load(cache_dir)
        assert data["cuda:NVIDIA H100 80GB HBM3:nv64:t_rm"] == 0.125
        assert data[f"{prefix}:nv64:t_rm"] == 0.25     # remeasured
        assert f"{prefix}:nv64:t_other" not in data     # dropped

    def test_reference_remeasure_switch_is_ignored(self, cache_dir):
        os.makedirs(cache_dir, exist_ok=True)
        prefix = eng._active_prefix()
        with open(cache_dir / "crossover.json", "w") as f:
            json.dump({f"{prefix}:nv64:t_rm": 0.5}, f)
        out = subprocess.run([sys.executable, "-c", """
from repro_torch.core import engine as eng
print(eng._cached_crossover(":t_rm", 64, lambda: 0.25))
"""], env=_env(cache_dir, REPRO_CROSSOVER_REMEASURE="1"),
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().endswith("0.5")


class TestMeasurements:
    def test_off_card_kernel_lanes_return_one_untimed(self, cache_dir,
                                                      monkeypatch):
        def no_timing(*a, **kw):
            raise AssertionError("timed a kernel lane off the card")
        monkeypatch.setattr(eng, "_lowest_winning_density", no_timing)
        assert eng.measure_intersect_crossover(torch_device="cpu") == 1.0
        assert eng.measure_fused_crossover(torch_device="cpu") == 1.0
        data = _load(cache_dir)
        assert data["cpu:cpu:nv256:intersect"] == 1.0
        assert data["cpu:cpu:nv256:fused"] == 1.0

    def test_dense_is_timed_on_the_cpu_with_plain_versions(self, cache_dir):
        v = eng.measure_dense_crossover(nv=48, repeats=1,
                                        torch_device="cpu")
        assert v in (0.01, 0.02, 0.05, 0.10, 0.20, 0.40, 1.0)
        assert _load(cache_dir)["cpu:cpu:nv48"] == v
        # a second call is the memo's
        assert eng.measure_dense_crossover(nv=48, torch_device="cpu") == v

    def test_lowest_winning_density_rule(self, monkeypatch):
        """The first grid density whose lane time beats the binary lane's
        wins; 1.0 when none does. Times are stubbed: the binary lane takes
        1 unit, the lane ``lane_t[density]``."""
        import torch
        dev = torch.device("cpu")
        ran = []
        real_count = eng._count_chunked
        monkeypatch.setattr(eng, "_count_chunked", lambda *a, **kw: (
            ran.append("binary"), real_count(*a, **kw))[1])

        def fake_time(fn):
            ran.clear()
            fn()
            return 1.0 if ran == ["binary"] else ran[0]
        monkeypatch.setattr(eng, "_time", fake_time)

        def run(densities, lane_t):
            seen = {}

            def make(g):
                d = densities[len(seen)]
                seen[d] = True
                return lambda: ran.append(lane_t[d])
            return eng._lowest_winning_density(32, 2, 0, dev, densities,
                                               make)

        assert run((0.1, 0.5), {0.1: 0.5, 0.5: 0.5}) == 0.1
        assert run((0.1, 0.5), {0.1: 2.0, 0.5: 0.5}) == 0.5
        assert run((0.1, 0.5), {0.1: 2.0, 0.5: 1.0}) == 1.0   # ties lose
        # an edgeless grid point is skipped
        seen = []

        def make(g):
            seen.append(True)
            return lambda: ran.append(0.5)
        assert eng._lowest_winning_density(32, 1, 0, dev, (0.0, 0.5),
                                           make) == 0.5
        assert len(seen) == 1

    def test_measured_thresholds_resolve_on_the_engine(self, cache_dir,
                                                       monkeypatch):
        grid = {}

        def fake(nv, repeats, seed, dev, densities, make_lane):
            grid[len(grid)] = densities
            return 0.125
        monkeypatch.setattr(eng, "_lowest_winning_density", fake)
        rng = np.random.default_rng(3)
        src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
        e = TriangleEngine(src, dst, mem_words=200, torch_device="cpu",
                           dense_threshold="measured",
                           intersect_threshold="measured",
                           fused_threshold="measured")
        assert e.dense_threshold == 0.125          # timed: plain versions
        assert e.intersect_threshold == 1.0         # off the card
        assert e.fused_threshold == 1.0
        assert e.stats.dense_threshold == 0.125
        assert len(grid) == 1
        want = TriangleEngine(src, dst, mem_words=200, torch_device="cpu",
                              dense_threshold=0.125).count()
        assert e.count() == want
        data = _load(cache_dir)
        assert data == {"cpu:cpu:nv256": 0.125,
                        "cpu:cpu:nv256:intersect": 1.0,
                        "cpu:cpu:nv256:fused": 1.0}
