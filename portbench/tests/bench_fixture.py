"""Helpers of the benchmark's CPU tests: the repository's root on the path,
and a benchmark root made of the test fixture's cells beside the real
drivers and metric readers (files only, nothing of ``portbench/`` edited)."""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def fixture_root(tmp: Path) -> Path:
    """``tmp`` with the fixture's ``BENCHMARK.json`` and its folder
    ``bench/``: copies of the real drivers and metrics, then the fixture's
    configurations, traffic and extra metric reader."""
    shutil.copytree(BENCH / "drivers", tmp / "bench" / "drivers")
    shutil.copytree(BENCH / "metrics", tmp / "bench" / "metrics")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(FIXTURES / sub, tmp / "bench" / sub, dirs_exist_ok=True)
    shutil.copy(FIXTURES / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp
