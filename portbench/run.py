"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything of a cell is found by name: the cell in ``BENCHMARK.json``, its
configuration's file (which names its driver, ``portbench/drivers/<driver>.py``),
its traffic ``portbench/traffic/<cell>.json`` and each per-layer metric's
reader ``portbench/metrics/<metric>.py``. A new cell, configuration or metric
is new files and entries, with no edit here.

A run: set-up (imports, the card, the driver's inputs drawn from the seed on
the device, one warm-up batch of every shape) → a closed-loop window, one
caller running batch after batch through the port's batch entry until the
first batch that ends after ``--seconds`` → the device's peak memory → with
``--trace 1`` the per-layer metrics from the profiler's trace, else the
end-to-end metrics → the program's state freed → the check of the kept rows,
and of a sample of the rows left non-finite, against the plain reference in
``portbench/reference`` → the result line,
last on standard output, and the numbers compared beside their limits, last
on standard error. It needs a CUDA card: without one it exits with code 2
and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pregen_pde_tpu")
# rows left non-finite that the check runs through the reference (each a
# whole trajectory): a program that keeps a finishable row from its users fails
LOST_SAMPLE = 2


def process_age() -> float:
    """Seconds since this process started, from the kernel's clock."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
    return float(Path("/proc/uptime").read_text().split()[0]) - start


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json``: its entry, its
    configuration (the file's contents), its traffic, the benchmark's folder,
    and the end-to-end and per-layer metric entries it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    folder = root / bench["paths"][0]

    # an end-to-end metric without "workloads" is every cell's; a per-layer
    # metric names its cells
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", (name,))]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    cfg = json.loads((root / conf["file"]).read_text())
    return {"cell": cell, "config": cfg, "folder": folder, "driver": cfg["driver"],
            "traffic": json.loads((folder / "traffic" / f"{name}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer}


def load_module(folder: Path, kind: str, name: str):
    """``folder/kind/name.py`` as a module (a driver or a metric's reader)."""
    path = folder / kind / f"{name}.py"
    if not path.is_file():
        fail(f"no {kind} file {path}", 3)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(entries: list, folder: Path, ctx: dict) -> dict:
    """Each metric's reader's value; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in entries:
        v = load_module(folder, "metrics", m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def window(driver, seconds: float, kept: dict, lost: dict, tally: dict, infos: list,
           batch_s: list, profiled: bool) -> tuple[float, object]:
    """Batches back to back until the first that ends after ``seconds``; →
    (window seconds, the profiler or None). ``kept``: the finite kept rows of
    each batch and their values; ``lost``: its rows left non-finite."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.trace import BATCH_SPAN

    prof = None
    if profiled:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    B = driver.batch_size
    t_start = time.perf_counter()
    b = 0
    while True:
        t0 = time.perf_counter()
        with record_function(BATCH_SPAN):
            try:
                out = driver.run(b)
            except Exception:  # a batch that raises fails all its rows
                print(f"portbench: batch {b} raised\n{traceback.format_exc()}",
                      file=sys.stderr, flush=True)
                out = None
            flat = None
            if out is None or out.shape[0] != B:
                finite = np.zeros(B, dtype=bool)
            else:
                # a row is delivered when every value is finite (generate
                # drops the others)
                flat = torch.from_numpy(out).reshape(B, -1)
                finite = torch.isfinite(flat.sum(dim=1, dtype=torch.float32)).numpy()
                rows = driver.keep(b)
                rows = rows[finite[rows]]
                if len(rows):
                    kept[b] = (rows, out[rows])
            del out, flat
        t1 = time.perf_counter()
        tally["attempted"] += B
        tally["failed"] += int((~finite).sum())
        if not finite.all():
            lost[b] = np.nonzero(~finite)[0]
        infos.append(driver.batch_info(b, finite))
        batch_s.append(t1 - t0)
        b += 1
        if t1 - t_start >= seconds:
            break
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    win = time.perf_counter() - t_start
    if prof is not None:
        prof.__exit__(None, None, None)
    return win, prof


def lost_sample(lost: dict, seed: int) -> list:
    """Up to ``LOST_SAMPLE`` of the rows the program left non-finite, drawn
    from the seed, as [(window batch, rows), ...]."""
    import numpy as np

    pairs = [(b, r) for b, rows in sorted(lost.items()) for r in rows]
    pick = np.random.default_rng([seed, len(pairs)]).choice(
        len(pairs), size=min(LOST_SAMPLE, len(pairs)), replace=False)
    by_batch: dict = {}
    for k in sorted(pick):
        by_batch.setdefault(pairs[k][0], []).append(pairs[k][1])
    return [(b, np.array(rows, dtype=np.int64)) for b, rows in by_batch.items()]


def run_cell(spec: dict, seed: int, seconds: float, trace_on: bool,
             device) -> tuple[dict, dict]:
    """Set-up, the window, the metrics and the check of one run; → (the
    result line, what the run prints before it). On a CPU device (the tests)
    the memory readings are 0."""
    import numpy as np
    import torch

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    folder = spec["folder"]
    driver = load_module(folder, "drivers", spec["driver"]).Driver(
        spec["config"], spec["traffic"], seed, device)
    driver.warm_up()
    sync()
    counters0 = driver.counters()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()

    kept: dict = {}
    tally = {"attempted": 0, "failed": 0}
    infos: list = []
    batch_s: list = []
    lost: dict = {}
    win, prof = window(driver, seconds, kept, lost, tally, infos, batch_s, trace_on)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    counters = {k: v - counters0.get(k, 0) for k, v in driver.counters().items()}
    counters["trajectories"] = tally["attempted"]
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": spec["cell"]["chips"], "memory_peak_bytes": peak}
    ctx = {"window_s": win, "setup_s": setup_s, "memory_peak_bytes": peak,
           "delivered": tally["attempted"] - tally["failed"], "batches": infos,
           "counters": counters}
    breakdown = None
    if prof is None:
        metrics = read_metrics(spec["end_to_end"], folder, ctx)
        missing = [m["name"] for m in spec["end_to_end"] if m["name"] not in metrics]
        if missing:
            fail(f"no reading of end-to-end metric(s) {missing}", 3)
    else:
        from portbench import trace

        dev, host = trace.events(prof)
        spans = trace.batch_spans(host)
        lo, hi = spans[0][0], spans[-1][1]
        ctx.update(dev=dev, host=host, spans=spans, window=(lo, hi))
        metrics = read_metrics(spec["per_layer"], folder, ctx)
        device_info["busy_s"] = trace.busy_seconds(dev, lo, hi)
        device_info["window_s"] = hi - lo
        breakdown = trace.breakdown(dev, host, lo, hi)
        del prof, dev, host
    del ctx

    # the check: after the window and the peak, the program's state freed;
    # the reference's products in float32, never TF32
    driver.release()
    sync()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    limits = spec["traffic"]["limits"]
    numbers = {k: 0.0 for k in limits}
    items = [(b, rows) for b, (rows, _) in sorted(kept.items())]
    info = {"rows_compared": sum(len(rows) for _, rows in items)}
    if items:
        got = np.concatenate([kept[b][1] for b, _ in items])
        kept.clear()
        for k, v in driver.compare(items, got, limits).items():
            # a reading with no bound (a row no dt explains) as the largest float
            (numbers if k in numbers else info)[k] = v if math.isfinite(v) else sys.float_info.max
        del got
    if "lost_rows" in limits and lost:
        numbers["lost_rows"] = float(driver.finishable(lost_sample(lost, seed)))
    correct = info["rows_compared"] > 0 and all(numbers[k] <= limits[k] for k in limits)
    result = {"correct": bool(correct), "attempted": tally["attempted"],
              "failed": tally["failed"], "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    extra = {"batch_seconds": batch_s, "window_s": win, "setup_s": setup_s,
             "batches": len(batch_s), "counters": counters, "check_info": info}
    return result, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's and the toolchains' caches, at fixed paths in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    spec = load_cell(args.workload)

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    result, extra = run_cell(spec, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or of the JAX package are loaded: {bad}", 4)
    print(json.dumps(extra), flush=True)
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
