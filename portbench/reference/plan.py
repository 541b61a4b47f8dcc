"""The masked generator's CFL plan, frozen: each trajectory's CFL dt, the
horizon buckets split into power-of-two dt levels, a sub-bucket at the
smallest dt of its members, and the inner steps a snapshot.

Copied from ``pregen_pde_tpu_torch/datagen/masked_ns.py`` at commit 92d189c
(``cfl_dt``, ``plan_sub_buckets``, ``inner_steps_for``, ``plan_rows``), with
the config as a dict. Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import numpy as np


def cfl_dt(cfg: dict, u_max: float) -> float:
    """min(cfg dt, safety·dx/(speedup·u_max))."""
    dx = cfg["length"] / cfg["resolution"]
    return min(cfg["dt"], cfg["cfl_safety"] * dx / max(cfg["cfl_speedup"] * u_max, 1e-9))


def inner_steps_for(horizon, dt, n_snapshots: int) -> np.ndarray:
    """round(horizon/dt) // n_snapshots, at least 1."""
    total = np.round(np.asarray(horizon, np.float64) / np.asarray(dt, np.float64))
    return np.maximum(total.astype(np.int64) // n_snapshots, 1)


def plan_rows(u_max: np.ndarray, end_t: np.ndarray, cfg: dict) -> dict:
    """Per batch row: ``dt`` (its sub-bucket's, the smallest CFL dt of the
    rows of its horizon at its power-of-two level k = ceil(log2(cfg dt /
    dt_i))), ``horizon`` and ``inner`` steps a snapshot; indexed by row."""
    B = len(u_max)
    dt = np.empty(B)
    for horizon in np.unique(end_t):
        idx_h = np.nonzero(end_t == horizon)[0]
        dt_i = np.array([cfl_dt(cfg, float(u)) for u in u_max[idx_h]])
        lvl = np.ceil(np.log2(cfg["dt"] / dt_i)).clip(min=0).astype(int)
        for k in np.unique(lvl):
            sub = lvl == k
            dt[idx_h[sub]] = dt_i[sub].min()
    return {"dt": dt, "horizon": end_t.copy(),
            "inner": inner_steps_for(end_t, dt, cfg["n_snapshots"])}
