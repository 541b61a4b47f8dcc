"""Readings that the check's limits are set from, on the card, at a cell's
own size (not run by the benchmark's runs):

    python3 portbench/limits.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--batches 4] [--control-batches 1] [--retried] [--json out.json]

For each seed: the driver's inputs, ``--batches`` batches through the
port's batch entry at the cell's load, the kept rows compared with the plain
reference as a run compares them, under the cell's own limits (the lower
readings). For each control seed: the same, with the program's own
lower-precision path switched on, its contract stored in float16 (the upper
readings). Prints one JSON line per seed and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402

CONTROL_DTYPE = "float16"


def first_pass_failures(driver, b: int):
    """The rows of batch ``b`` that the masked pipeline's first pass leaves
    non-finite (the rows its retries re-run): the batch run once with no
    retries."""
    import dataclasses

    import numpy as np

    r = b % len(driver.z)
    cfg = dataclasses.replace(driver.prog_cfg, nonfinite_retries=0)
    out = driver.entry(driver.z[r], driver.masks[r], cfg, driver.cfg["storage_dtype"])
    return np.nonzero(~np.isfinite(out.reshape(len(out), -1)).all(axis=1))[0]


def readings(driver, batches: int, limits: dict, with_retried: bool) -> dict:
    """The widest gaps over ``batches`` window batches' kept rows (with
    ``with_retried``, and, apart, the rows the pipeline retried)."""
    import numpy as np
    import torch

    items, got, retried = [], [], []
    for b in range(batches):
        rows = driver.keep(b)
        extra = first_pass_failures(driver, b) if with_retried else np.zeros(0, np.int64)
        items.append((b, rows))
        full = driver.run(b)
        got.append(full[rows])
        if len(extra):
            retried.append(((b, extra), full[extra]))
        del full
    torch.cuda.synchronize()
    out = driver.compare(items, np.concatenate(got), limits)
    if retried:
        # the retried rows alone, judged as a run judges them
        sub = driver.compare([it for it, _ in retried], np.concatenate([g for _, g in retried]),
                             limits)
        out.update({"retried." + k: v for k, v in sub.items()})
        out["retried.rows"] = sum(len(it[1]) for it, _ in retried)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--retried", action="store_true",
                    help="masked cells: also compare every row the pipeline retried")
    ap.add_argument("--control-batches", type=int, default=1)
    ap.add_argument("--json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        run.fail("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = run.load_cell(args.workload)
    limits = spec["traffic"]["limits"]
    mod = run.load_module(spec["folder"], "drivers", spec["driver"])
    dev = torch.device("cuda", 0)
    rec = {"workload": args.workload, "card": torch.cuda.get_device_name(dev),
           "program": {}, "control": {}}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        control = kind == "control"
        cfg = {**spec["config"], "storage_dtype": CONTROL_DTYPE} if control else spec["config"]
        for seed in seeds:
            t0 = time.perf_counter()
            driver = mod.Driver(cfg, spec["traffic"], seed, dev)
            r = readings(driver, args.control_batches if control else args.batches, limits,
                         args.retried and not control)
            r["seconds"] = time.perf_counter() - t0
            rec[kind][seed] = r
            print(json.dumps({kind: seed, **r}), flush=True)
            del driver
            torch.cuda.empty_cache()
    summary = {kind: {k: [rec[kind][s][k] for s in rec[kind] if k in rec[kind][s]]
                      for k in limits} for kind in ("program", "control")}
    summary["lower"] = {k: max(v, default=None) for k, v in summary["program"].items()}
    summary["upper"] = {k: min(v, default=None) for k, v in summary["control"].items()}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rec, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
