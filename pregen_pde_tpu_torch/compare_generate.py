"""Wall of the ``generate`` main paths in two checkouts, in turns.

    python -m pregen_pde_tpu_torch.compare_generate PARENT_DIR CHANGE_DIR \
        [--pairs 3] [--json out.json]

Each checkout (e.g. a ``git archive`` of a commit) runs ``generate
--workload ns_spectral --n 32 --resolution 256 --batch-size 32`` and
``--workload fpo_multi_hole --n 32 --resolution 128 --batch-size 32
--time-scale 1.0`` as the CLI is run, in a fresh process each. One
untimed warm-up run per checkout builds its kernels; then ``--pairs``
pairs alternate the order (parent first, then change first, ...), so a
drift of the host shows on both sides. Prints the card line and one JSON
line with every wall in seconds and the medians. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

WORKLOADS = {
    "ns_spectral": ["--workload", "ns_spectral", "--n", "32", "--resolution", "256",
                    "--batch-size", "32"],
    "fpo_multi_hole": ["--workload", "fpo_multi_hole", "--n", "32", "--resolution", "128",
                       "--batch-size", "32", "--time-scale", "1.0"],
}


def _wall(tree: str, args: list[str]) -> float:
    """Seconds of one ``generate`` in ``tree``, its shards written under the
    checkout's git-ignored ``_build/`` and removed after."""
    out = os.path.join(tree, "pregen_pde_tpu_torch", "_build", "compare_generate")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pregen_pde_tpu_torch", "generate", *args,
                        "--out", out], cwd=tree, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    if r.returncode != 0:
        raise RuntimeError(f"generate in {tree} rc {r.returncode}:\n{r.stderr[-4000:]}")
    return wall


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch.compare_generate")
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--json", help="also write the result here")
    args = p.parse_args(argv)

    from pregen_pde_tpu_torch.profile_k1 import _card

    card = _card()
    print(card, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    for tree in trees.values():  # warm-up: each checkout builds its kernels
        for wl_args in WORKLOADS.values():
            _wall(tree, wl_args)
    walls = {side: {wl: [] for wl in WORKLOADS} for side in trees}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            for wl, wl_args in WORKLOADS.items():
                walls[side][wl].append(_wall(trees[side], wl_args))
    res = {"card": card, "pairs": args.pairs, "walls_s": walls,
           "median_s": {side: {wl: statistics.median(v) for wl, v in w.items()}
                        for side, w in walls.items()}}
    print(json.dumps(res), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
