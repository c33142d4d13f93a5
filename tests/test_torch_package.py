"""Guards of the port's boundaries: repro_torch and chip_smoke.py import
neither JAX nor the reference package, entry points never carry on on the
CPU without being asked, and a kernel build without nvcc fails loudly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_module_pulls_in_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('IMPORT_OK', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "IMPORT_OK" in out.stdout


@pytest.mark.parametrize("module", ["repro_torch.kernels.lftj_fused.ops",
                                    "repro_torch.kernels.lftj_fused.ref",
                                    "repro_torch.core.executor",
                                    "repro_torch.core.engine",
                                    "repro_torch.data.edgestore",
                                    "repro_torch.convert",
                                    "repro_torch.core.queries",
                                    "repro_torch.query",
                                    "repro_torch.query.executor",
                                    "repro_torch.query.vectorized",
                                    "repro_torch.query.planner",
                                    "repro_torch.query.patterns",
                                    "repro_torch.kernels.embedding_bag.ops",
                                    "repro_torch.kernels.embedding_bag.ref",
                                    "repro_torch.core.triangle",
                                    "repro_torch.core.mgt",
                                    "repro_torch.core.adversarial",
                                    "repro_torch.obs",
                                    "repro_torch.obs.trace",
                                    "repro_torch.obs.metrics"])
def test_fused_lane_modules_import_no_jax_and_no_reference(module):
    """The fused lane's and the QueryEngine's modules, the embedding_bag
    entry point, the executor and converter that reach them, the public
    triangle API with MGT and the adversarial instance, and ``obs``, load
    on a host without JAX: importing each alone pulls in neither ``jax``
    nor ``repro``."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('IMPORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "IMPORT_OK" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_has_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_point_defaults_to_the_card():
    """Without torch_device the engines run on CUDA; on a host without it,
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default runs there")
    from repro_torch import (QueryEngine, TriangleEngine, engine_count,
                             patterns, query_count)
    src, dst = np.array([0, 1, 0]), np.array([1, 2, 2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine.from_graph(patterns.triangle(), src, dst)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        query_count(patterns.triangle(), src, dst)
    assert query_count(patterns.triangle(), src, dst,
                       torch_device="cpu") == 1
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TriangleEngine(src, dst)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_count(src, dst)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TriangleEngine(src, dst, torch_device="cuda:0")
    with pytest.raises(ValueError, match="torch_device"):
        TriangleEngine(src, dst, torch_device="meta")
    assert TriangleEngine(src, dst, torch_device="cpu").count() == 1


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("intersect", {})
    assert not (tmp_path / "build").exists() \
        or not any((tmp_path / "build").iterdir())


def test_kernel_sources_and_library_names():
    """Every kernel has its source; the library name follows the source
    hash, so an edited source is rebuilt, never a stale library loaded."""
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        src = _build.SRC_DIR / f"{name}.cu"
        assert src.exists()
        text = src.read_text()
        assert "src/repro/kernels/" in text      # names the TPU kernel
        assert "cudaGetLastError" in text
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_core_exports_every_reference_name():
    """``repro_torch.core`` exports the reference core's public names, with
    the GPU name ``measure_intersect_crossover`` for
    ``measure_pallas_crossover``; the package root exports the public
    triangle API, MGT, the adversarial instance, the calibrations and
    ``obs``."""
    import repro.core as ref_core
    import repro_torch
    import repro_torch.core as core
    renamed = {"measure_pallas_crossover": "measure_intersect_crossover"}
    for name in ref_core.__all__:
        port_name = renamed.get(name, name)
        assert port_name in core.__all__, name
        assert getattr(core, port_name) is not None
    for name in ("count_triangles", "list_triangles", "brute_force_count",
                 "mgt_triangle_count", "adversarial_graph",
                 "measure_dense_crossover", "measure_intersect_crossover",
                 "measure_fused_crossover", "Tracer", "MetricsRegistry"):
        assert name in repro_torch.__all__, name
        assert getattr(repro_torch, name) is getattr(
            core if hasattr(core, name) else repro_torch.obs, name)


def _not_ported_features(path):
    """String arguments of every ``_not_ported(...)`` call and every
    ``NotImplementedError(...)`` raised in a module's source."""
    tree = ast.parse((PKG / path).read_text(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) \
                in ("_not_ported", "NotImplementedError") \
                and node.args and isinstance(node.args[0], ast.Constant):
            found.append(node.args[0].value)
    return found


def test_shard_is_the_only_option_not_ported():
    """No option of the engines raises NotImplementedError any more: the
    last one, ``shard=True``, is ported, and ``tracer=``, ``metrics=`` and
    the ``'measured'`` thresholds work."""
    for path in ("core/engine.py", "query/executor.py",
                 "parallel/fabric.py", "parallel/sharding.py",
                 "launch/mesh.py"):
        assert _not_ported_features(path) == [], path
    from repro_torch import MetricsRegistry, QueryEngine, Tracer, patterns
    from repro_torch import TriangleEngine
    src, dst = np.array([0, 1, 0, 2]), np.array([1, 2, 2, 3])
    eng = TriangleEngine(src, dst, shard=True, torch_device="cpu")
    assert eng.count() == 1 and eng.stats.n_shards == 1
    tr, reg = Tracer(), MetricsRegistry()
    assert TriangleEngine(src, dst, torch_device="cpu", tracer=tr,
                          metrics=reg).count() == 1
    assert QueryEngine.from_graph(patterns.triangle(), src, dst,
                                  torch_device="cpu", tracer=tr,
                                  metrics=reg).count() == 1
    assert "engine.count" in tr.span_names()
    assert "query.boxes" in tr.span_names()


def test_serve_and_runtime_import_no_jax_and_no_reference():
    """The serving layer and the runtime load on a host without JAX:
    importing ``repro_torch.serve`` and ``repro_torch.runtime`` (and the
    package root, which exports ``Server`` / ``Session``) in a fresh
    interpreter pulls in neither ``jax`` nor ``repro``, and leaves the
    fabric to load on first use."""
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.runtime\n"
        "from repro_torch import Server, Session\n"
        "from repro_torch.serve import server\n"
        "from repro_torch.runtime import straggler, elastic\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.parallel.fabric' not in sys.modules\n"
        "assert Server is server.Server\n"
        "print('IMPORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "IMPORT_OK" in out.stdout
    for path in ("serve/server.py", "serve/cache.py", "serve/admission.py",
                 "runtime/straggler.py", "runtime/elastic.py"):
        assert _not_ported_features(path) == [], path
