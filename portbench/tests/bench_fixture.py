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


# end-to-end metrics that only a card reads (the CPU has no allocator peak):
# a CPU run of a cell that reports them leaves them out
CARD_ONLY = ("peak_mem_gib",)


def fixture_root(tmp: Path) -> Path:
    """``tmp`` with the fixture's ``BENCHMARK.json`` and its folder
    ``bench/``: copies of the real drivers and metrics, then the fixture's
    configurations, traffic, extra metric reader, training driver and its
    plain reference."""
    shutil.copytree(BENCH / "drivers", tmp / "bench" / "drivers")
    shutil.copytree(BENCH / "metrics", tmp / "bench" / "metrics")
    for sub in ("configs", "traffic", "metrics", "drivers", "reference"):
        shutil.copytree(FIXTURES / sub, tmp / "bench" / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(FIXTURES / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def cpu_cell(name: str, root: Path) -> dict:
    """``run.load_cell(name, root)`` without the end-to-end metrics that
    only a card reads."""
    from portbench import run

    spec = run.load_cell(name, root)
    spec["end_to_end"] = [m for m in spec["end_to_end"] if m["name"] not in CARD_ONLY]
    return spec
