"""``BENCHMARK.json`` against the benchmark's contract, and every entry found
by name: configurations, traffic, drivers and metric readers; a cell, a
configuration and a metric that only a fixture defines load and run with no
edit to ``portbench/``."""

from __future__ import annotations

import importlib.util
import json
import math
import re

import pytest
import torch
from bench_fixture import BENCH, ROOT, fixture_root

from portbench import run

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expan")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16 and 1 <= len(MANIFEST["command"]) <= 32
    assert MANIFEST["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert 1 <= MANIFEST["run_seconds"] <= 51
    n = 24  # the most cells a later change may bring, at this length
    assert (2 + 14 * n) * (MANIFEST["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]])
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in MANIFEST["workloads"]]:
        assert NAME.match(name), name
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    lines = ([c["why"] for c in MANIFEST["configs"]] + [c["source"] for c in MANIFEST["configs"]]
             + [w["why"] for w in MANIFEST["workloads"]]
             + [m["layer"] for m in MANIFEST["per_layer"]])
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs_resolve_and_keep_their_widths():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/configs/")
        cfg = json.loads(path.read_text())
        assert (BENCH / "drivers" / f"{cfg['driver']}.py").is_file()
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


# drivers whose cells keep the generators' contract; any other driver's cell
# meets the general one
GENERATORS = ("spectral", "masked")


def cell_contract(spec: dict) -> None:
    """Assert the contract of a cell as ``run.load_cell`` gives it. Every
    cell: its keys, its name, one chip, ``setup_s`` and ``traj_per_s``, a
    per-layer metric, a reader file for each metric. A generator's cell:
    the CLI's batch of 128 and its three limits, ``aux_gap`` and
    ``lost_rows`` exact. Any other cell: a positive whole batch, 1 to 4
    finite limits of at least 0, and ``peak_mem_gib`` too."""
    w = spec["cell"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert e2e >= {"setup_s", "traj_per_s"}
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (spec["folder"] / "metrics" / f"{m['name']}.py").is_file()
    t = spec["traffic"]
    if spec["driver"] in GENERATORS:
        assert t["batch_size"] == 128
        assert len(t["limits"]) == 3
        assert t["limits"]["aux_gap"] == 0.0 and t["limits"]["lost_rows"] == 0.0
        return
    B = t["batch_size"]
    assert isinstance(B, int) and not isinstance(B, bool) and B > 0
    assert 1 <= len(t["limits"]) <= 4
    for v in t["limits"].values():
        assert isinstance(v, float) and math.isfinite(v) and v >= 0.0
    assert "peak_mem_gib" in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    cell_contract(run.load_cell(cell))


def test_a_fixture_training_cell_passes_the_general_contract(tmp_path):
    """``tiny_train.a``, a cell of new files only, meets the general
    contract, also at batch 16 with its two limits; a generator's cell at
    batch 16 still fails its own."""
    root = fixture_root(tmp_path)
    spec = run.load_cell("tiny_train.a", root)
    assert spec["driver"] not in GENERATORS and len(spec["traffic"]["limits"]) == 2
    cell_contract(spec)
    cell_contract({**spec, "traffic": {**spec["traffic"], "batch_size": 16}})
    limits = spec["traffic"]["limits"]
    for traffic in ({"batch_size": 0}, {"batch_size": 16.0},
                    {"limits": {**limits, "loss_gap": float("nan")}},
                    {"limits": {**limits, **{f"gap{i}": 1.0 for i in range(3)}}}):
        with pytest.raises(AssertionError):
            cell_contract({**spec, "traffic": {**spec["traffic"], **traffic}})
    with pytest.raises(AssertionError):
        cell_contract({**spec, "end_to_end": [m for m in spec["end_to_end"]
                                              if m["name"] != "peak_mem_gib"]})
    masked = run.load_cell("tiny_masked.a", root)
    masked["traffic"] = {**masked["traffic"], "batch_size": 16}
    with pytest.raises(AssertionError):
        cell_contract(masked)


def test_metric_entries():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "traj_per_s" and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in MANIFEST["per_layer"])


def test_every_module_is_found_by_name():
    for kind in ("drivers", "metrics"):
        for path in (BENCH / kind).glob("[a-z]*.py"):
            mod = run.load_module(BENCH, kind, path.stem)
            assert hasattr(mod, "Driver" if kind == "drivers" else "read"), path
    assert importlib.util.find_spec("portbench.reference.spectral") is not None


def test_a_fixture_cell_runs_from_new_files_only(tmp_path):
    """A cell, two configurations and an end-to-end metric that only the
    fixture defines: found by name and run on the CPU at a tiny size."""
    root = fixture_root(tmp_path)
    spec = run.load_cell("tiny_masked.a", root)
    assert [m["name"] for m in spec["end_to_end"]] == ["traj_per_s", "setup_s",
                                                        "batches_per_s"]
    assert [m["name"] for m in spec["per_layer"]] == ["retry_share"]
    result, extra = run.run_cell(spec, 2**31 + 7, 0.2, False, torch.device("cpu"))
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"traj_per_s", "setup_s", "batches_per_s"}
    assert list(result)[-1] == "check" and extra["check_info"]["rows_compared"] > 0
    spec = run.load_cell("tiny_spectral.a", root)
    assert [m["name"] for m in spec["end_to_end"]] == ["traj_per_s", "setup_s"]
