"""Nothing the benchmark runs loads JAX or the JAX package (compared by whole
top-level module names: ``pregen_pde_tpu_torch`` is the port and passes),
and without a card ``run.py`` fails instead of falling back to the CPU."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from bench_fixture import BENCH, ROOT

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pregen_pde_tpu"}


def _top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path
    reference = _top_level_imports(BENCH / "reference" / "spectral.py")
    for path in [*(BENCH / "reference").glob("*.py"),
                 *(BENCH / "tests" / "fixtures" / "reference").glob("*.py")]:
        assert "pregen_pde_tpu_torch" not in _top_level_imports(path), path
    assert reference <= {"__future__", "numpy", "torch"}


def test_what_a_run_loads_holds_no_jax(tmp_path):
    """Every driver, reader and the reference imported, and a tiny CPU run
    of each fixture cell, in a fresh process: then ``sys.modules``."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})
from pathlib import Path
import torch
from bench_fixture import cpu_cell, fixture_root
from portbench import run, limits
from portbench.reference import geometry, plan, projection, schedules, spectral
root = fixture_root(Path({str(tmp_path)!r}))
for cell in ("tiny_spectral.a", "tiny_masked.a", "tiny_train.a"):
    run.run_cell(cpu_cell(cell, root), 5, 0.0, False, torch.device("cpu"))
print("loaded:", ",".join(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "loaded:", out.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pregen_pde_tpu_torch_x", sys)
    assert "pregen_pde_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in run.forbidden_modules()


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the check is for one without")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "ns_spectral_256.main", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_outside_a_checkout_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is not there, so the run fails before any result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, str(tmp_path / "portbench" / "run.py"),
                          "--workload", "ns_spectral_256.main", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
