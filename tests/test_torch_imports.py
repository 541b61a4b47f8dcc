"""The port imports nothing of JAX and nothing of the JAX package: every
module of ``pregen_pde_tpu_torch`` and ``chip_smoke.py`` is imported in a
fresh interpreter, and their sources are scanned for such imports."""

import ast
import subprocess
import sys
from pathlib import Path

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pregen_pde_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "pregen_pde_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_port_modules_import_no_jax_package():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_port_sources_have_no_jax_package_imports():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_scan_covers_every_slice_module():
    """The two checks above walk the package; the modules each slice adds
    are among what they import and scan (the validation checks, FNO and
    FFNO; CNO, its ops, the Fourier features and fine-tuning)."""
    modules = set(_modules())
    for m in ("pregen_pde_tpu_torch.solvers.validation", "pregen_pde_tpu_torch.models.fno",
              "pregen_pde_tpu_torch.models.ffno", "pregen_pde_tpu_torch.models.cno",
              "pregen_pde_tpu_torch.models.fourier_features",
              "pregen_pde_tpu_torch.training.finetune",
              *(f"pregen_pde_tpu_torch.ops.{op}" for op in (
                  "filter_design", "bias_act", "upfirdn2d", "filtered_lrelu", "conv2d_resample")),
              "pregen_pde_tpu_torch.models.convert", "pregen_pde_tpu_torch.__main__"):
        assert m in modules, m
    sources = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"pregen_pde_tpu_torch/models/fno.py", "pregen_pde_tpu_torch/models/ffno.py",
            "chip_smoke.py"} <= sources


def test_port_tests_share_one_torch_thread_fixture():
    """Every ``tests/test_torch_*.py`` but the card's own file takes the one
    fixture of ``tests/torch_threads.py``, and no other test file sets
    torch's thread count itself."""
    tests = ROOT / "tests"
    missing, own = [], []
    for path in sorted(tests.glob("*.py")):
        if path.name == "torch_threads.py":
            continue
        takes = False
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.ImportFrom) and node.module == "torch_threads":
                takes |= "_one_torch_thread" in [a.name for a in node.names]
            elif isinstance(node, ast.FunctionDef) and node.name == "_one_torch_thread":
                own.append(f"{path.name}:{node.lineno} def")
            elif isinstance(node, ast.Attribute) and node.attr == "set_num_threads":
                own.append(f"{path.name}:{node.lineno} set_num_threads")
        port = path.name.startswith("test_torch_")
        if takes != (port and path.name != "test_torch_cuda.py"):
            missing.append(path.name)
    assert not missing, missing
    assert not own, own
