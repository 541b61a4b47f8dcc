"""Masked-geometry NS dataset pipelines (port of ``datagen/masked_ns.py``):

| pipeline          | geometry                          | difficulty axis |
|-------------------|-----------------------------------|-----------------|
| `fpo_regular`     | fixed central cylinder (channel)  | physics (Re)    |
| `fpo_hole`        | one random 16² hole (channel)     | geometry        |
| `fpo_multi_hole`  | 2–10 random holes (channel)       | geometry        |
| `ldc_regular`     | none (lid-driven cavity)          | physics (Re)    |

Per batch: Re ~ clip(N(5000, 2000²)) → Umax = Re·ν/L → the band-law horizon
× ``time_scale`` → masks and their SDFs → horizon buckets, each split into
sub-buckets by the power-of-two level of its members' own CFL dt; each
trajectory runs at the smallest dt of its sub-bucket, and the whole batch
runs as ONE call with per-trajectory dt and inner steps, longest trajectory
first, writing its frames in place into the (N, T, H, W, 6) contract ``[u,
v, p, Re_norm, mask, SDF]`` on the device → Re_norm, masks and SDFs
broadcast into channels 3-5 there → one finiteness flag a row read back →
the dt/2 retry of only the non-finite rows, all of them in one call per
attempt, into the same contract (``nonfinite_retries`` times, so the count
stays exact) → the storage cast on the device and one fetch into a reused
page-locked host buffer (``datagen/fetch.py``). The plan and each row's dt
and steps are the JAX package's, which ran the sub-buckets one by one (one
compiled executable needed a scalar dt).

The draws are split from the compute: ``draw_masked_inputs`` makes the Re
normal ``z`` and the masks from an explicit ``torch.Generator``, and
``generate_masked_ns_batch_from_inputs`` is a pure function of them, so a
test can feed it JAX's own draws. On a CUDA device the batch runs through
the hand-written CUDA stepper (``ns_projection_cuda``, one launch a call),
and a config it does not handle raises; on the CPU the plain version runs.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from pregen_pde_tpu_torch.datagen.fetch import to_host
from pregen_pde_tpu_torch.fields.geometry import (
    disk_mask,
    sample_multi_holes,
    sample_multi_holes_overlap,
    sample_single_hole,
    sdf_from_mask,
)
from pregen_pde_tpu_torch.solvers import schedules
from pregen_pde_tpu_torch.solvers.ns_projection import ProjectionConfig, ProjectionSolver
from pregen_pde_tpu_torch.utils.trace import span

def cfl_dt(cfg: "MaskedNSConfig", u_max: float, safety: float = 0.5,
           speedup: float | None = None) -> float:
    """Explicit-CFL step dt ≤ safety·dx/(speedup·u_max), capped at cfg.dt;
    ``speedup`` (default cfg.cfl_speedup) budgets the local acceleration in
    constrictions between holes."""
    dx = cfg.length / cfg.resolution
    if speedup is None:
        speedup = cfg.cfl_speedup
    return min(cfg.dt, safety * dx / max(speedup * u_max, 1e-9))


@dataclasses.dataclass(frozen=True)
class MaskedNSConfig:
    """Same fields and defaults as the JAX package's ``MaskedNSConfig``."""

    pipeline: str = "fpo_regular"  # fpo_regular | fpo_hole | fpo_multi_hole | ldc_regular
    resolution: int = 128
    length: float = 2.0
    viscosity: float = 1.5e-5  # reference ν
    dt: float = 0.2  # reference deltaT; the CFL dt caps it
    n_snapshots: int = 20
    re_mean: float = 5000.0
    re_std: float = 2000.0
    time_scale: float = 1.0  # multiplies the schedule's horizons
    penalization_eta: float = 1e-3
    cg_iters: int = 150
    batch_size: int = 128
    # fpo_multi_hole only: all holes share a central sub-box of side
    # overlap_fraction·hole (the reference's allow_overlap=True)
    hole_overlap: bool = False
    overlap_fraction: float = 0.3
    cfl_speedup: float = 3.5
    nonfinite_retries: int = 2
    # False = the legacy one-dt-per-horizon-bucket rule; not ported (it only
    # regenerates old datasets bit-identically, which needs JAX's RNG)
    per_traj_dt: bool = True


def sample_masks(generator: torch.Generator, cfg: MaskedNSConfig, n: int) -> torch.Tensor:
    """(n, res, res) float32 geometry masks on the generator's device."""
    res = cfg.resolution
    dev = generator.device
    if cfg.pipeline == "fpo_regular":
        # fixed central cylinder: a penalised disk of diameter res/8 at x = res/4
        m = disk_mask(res, res / 2.0, res / 4.0, res / 16.0, device=dev)
        return m[None].expand(n, res, res).contiguous()
    if cfg.pipeline == "fpo_hole":
        return sample_single_hole(generator, n, res)
    if cfg.pipeline == "fpo_multi_hole":
        hole_cells = max(res // 8, 4)  # 16 cells at 128²
        if cfg.hole_overlap:
            return sample_multi_holes_overlap(generator, n, res, hole_cells=hole_cells,
                                              overlap_fraction=cfg.overlap_fraction)[0]
        return sample_multi_holes(generator, n, res, hole_cells=hole_cells)[0]
    if cfg.pipeline == "ldc_regular":
        return torch.zeros((n, res, res), dtype=torch.float32, device=dev)
    raise ValueError(cfg.pipeline)


def _solver_for(cfg: MaskedNSConfig, u_max: float, t_end: float) -> ProjectionSolver:
    domain = "cavity" if cfg.pipeline == "ldc_regular" else "channel"
    return ProjectionSolver(ProjectionConfig(
        resolution=cfg.resolution, length=cfg.length, viscosity=cfg.viscosity,
        domain=domain, u_max=u_max, dt=cfg.dt, t_end=t_end,
        n_snapshots=cfg.n_snapshots, penalization_eta=cfg.penalization_eta,
        cg_iters=cfg.cg_iters,
    ))


def check_device_supported(cfg: MaskedNSConfig, device: torch.device) -> None:
    """On a CUDA device the CUDA stepper must handle the config: raise,
    naming the size, instead of running the plain version there."""
    if torch.device(device).type != "cuda":
        return
    from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc

    solver = _solver_for(cfg, 1.0, 1.0)
    if not npc.supported(solver):
        raise ValueError(f"{cfg.pipeline} on CUDA: {npc.unsupported_reason(solver)}")


def _batched_traj_for(solver: ProjectionSolver, device: torch.device):
    """The CUDA stepper on a CUDA device (it raises for a config it does not
    handle), the plain batched trajectory elsewhere."""
    if torch.device(device).type == "cuda":
        from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc

        return npc.build_batched_traj(solver)
    return solver.make_batched_trajectory_fn()


def plan_sub_buckets(u_max: np.ndarray, end_t: np.ndarray,
                     cfg: MaskedNSConfig) -> list[tuple[np.ndarray, float, float]]:
    """(indices, horizon, dt) of every sub-bucket, in launch order: one
    bucket per horizon, split by the power-of-two level k = ceil(log2(cfg.dt /
    dt_i)) of each trajectory's own CFL dt; a sub-bucket runs at the smallest
    dt of its members, so a fast inlet taxes only its own sub-bucket."""
    plan = []
    for horizon in np.unique(end_t):
        idx_h = np.nonzero(end_t == horizon)[0]
        dt_i = np.array([cfl_dt(cfg, float(u)) for u in u_max[idx_h]])
        lvl = np.ceil(np.log2(cfg.dt / dt_i)).clip(min=0).astype(int)
        for k in np.unique(lvl):
            sub = lvl == k
            plan.append((idx_h[sub], float(horizon), float(dt_i[sub].min())))
    return plan


def inner_steps_for(horizon, dt, n_snapshots: int) -> np.ndarray:
    """Inner steps per snapshot of a trajectory of ``horizon`` at ``dt``:
    round(horizon/dt) // n_snapshots, at least 1 (the JAX package's rule)."""
    total = np.round(np.asarray(horizon, np.float64) / np.asarray(dt, np.float64))
    return np.maximum(total.astype(np.int64) // n_snapshots, 1)


def plan_rows(u_max: np.ndarray, end_t: np.ndarray, cfg: MaskedNSConfig) -> dict:
    """``plan_sub_buckets`` flattened to one entry per trajectory: ``rows``
    (batch indices), ``sub`` (its sub-bucket), ``horizon``, ``dt`` (its
    sub-bucket's) and ``inner`` steps per snapshot, plus the ``plan``."""
    plan = plan_sub_buckets(u_max, end_t, cfg)
    rows = np.concatenate([idx for idx, _, _ in plan])
    sub = np.concatenate([np.full(len(idx), k) for k, (idx, _, _) in enumerate(plan)])
    horizon = np.concatenate([np.full(len(idx), h) for idx, h, _ in plan])
    dt = np.concatenate([np.full(len(idx), d) for idx, _, d in plan])
    return {"plan": plan, "rows": rows, "sub": sub, "horizon": horizon, "dt": dt,
            "inner": inner_steps_for(horizon, dt, cfg.n_snapshots)}


def draw_masked_inputs(generator: torch.Generator, cfg: MaskedNSConfig,
                       n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(z_re (n,) float64, masks (n, res, res) float32) on the generator's
    device."""
    n = n or cfg.batch_size
    z_re = torch.randn((n,), generator=generator, dtype=torch.float64,
                       device=generator.device)
    return z_re, sample_masks(generator, cfg, n)


def new_stats() -> dict:
    """Counters ``generate_masked_ns_batch`` adds to. In the JAX package's
    meaning: the plan's sub-buckets, the retries (per attempt, the
    sub-buckets with a non-finite row) and the trajectories retried. Of
    the port: the stepper calls, one per batch and one per retry attempt
    (on a card, one K2 launch each)."""
    return {"sub_buckets": 0, "retries": 0, "retried_trajectories": 0, "calls": 0}


def finite_rows(contract: torch.Tensor, store: torch.dtype) -> torch.Tensor:
    """(N,) bool on the contract's device: whether channels 0:3 of each row
    of an (N, T, n, n, C) contract are all finite once cast to ``store``,
    exactly ``np.isfinite(row.astype(store)).all()``. ``amax`` and ``amin``
    propagate NaN and the cast rounds monotonically, so a row is finite iff
    its largest and smallest values are; the reductions read the strided
    view in place and allocate two values a row."""
    uvp = contract.view(contract.shape[0], -1, contract.shape[-1])[..., 0:3]
    return (torch.isfinite(uvp.amax(dim=(1, 2)).to(store))
            & torch.isfinite(uvp.amin(dim=(1, 2)).to(store)))


def generate_masked_ns_batch_from_inputs(z_re: torch.Tensor, masks: torch.Tensor,
                                         cfg: MaskedNSConfig,
                                         storage_dtype: str = "float32",
                                         stats: dict | None = None) -> np.ndarray:
    """One batch from pre-drawn inputs, computed on ``masks.device``; →
    (N, n_snapshots+1, res, res, 6) in ``storage_dtype`` on the host.

    The contract is one float32 device buffer: the stepper writes each
    trajectory's frames in place into channels 0:3 of its batch row, Re_norm,
    the mask and the SDF are broadcast into channels 3-5, each pass reads
    back one finiteness flag a row it ran, and the whole contract is cast to
    the storage dtype and fetched once."""
    if not cfg.per_traj_dt:
        raise NotImplementedError(
            "per_traj_dt=False (the legacy one-dt-per-bucket rule) is not ported")
    stats = new_stats() if stats is None else stats
    dev = masks.device
    n_traj = masks.shape[0]
    with span("pregen.masked.inputs"):
        re = schedules.sample_reynolds(z=z_re.to(torch.float64), mean=cfg.re_mean,
                                       std=cfg.re_std)
        re_np = re.cpu().numpy()
        u_max_np = re_np * cfg.viscosity / cfg.length  # Umax = Re·ν/L
        end_t_np = schedules.end_time_from_re(re).cpu().numpy() * cfg.time_scale
        re_norm_np = schedules.normalize_re(re).cpu().numpy()

        masks = masks.to(torch.float32)
        sdfs = sdf_from_mask(masks)

    res = cfg.resolution
    # t_end is pinned: traj always gets explicit inner steps and dt
    solver = _solver_for(cfg, 1.0, 1.0)
    traj = _batched_traj_for(solver, dev)
    store = getattr(torch, np.dtype(storage_dtype).name)

    with span("pregen.masked.plan"):
        pr = plan_rows(u_max_np, end_t_np, cfg)
    plan, rows, sub, horizon = pr["plan"], pr["rows"], pr["sub"], pr["horizon"]
    stats["sub_buckets"] += len(plan)
    # Re_norm in the storage dtype from its float64 values, as numpy casts
    # it; exact in the float32 buffer and through the final cast
    re_norm = torch.as_tensor(re_norm_np.astype(storage_dtype), dtype=torch.float32, device=dev)
    # allocated once the SDFs' EDT has freed its intermediate
    contract = torch.empty((n_traj, cfg.n_snapshots + 1, res, res, 6), dtype=torch.float32,
                           device=dev)

    def _launch(sel: np.ndarray, dt_sel: np.ndarray) -> tuple[np.ndarray, torch.Tensor]:
        """One call for the rows ``sel`` of the plan, each at its own dt and
        inner steps, longest trajectory first, each into its batch row of
        the contract; → the launch order and the batch rows in it."""
        inner = inner_steps_for(horizon[sel], dt_sel, cfg.n_snapshots)
        order = np.argsort(-inner, kind="stable")
        idx = rows[sel][order]
        idx_d = torch.as_tensor(idx, device=dev)
        with span("pregen.masked.k2"):
            traj(masks[idx_d], torch.as_tensor(u_max_np[idx], dtype=torch.float32, device=dev),
                 torch.as_tensor(inner[order]), torch.as_tensor(dt_sel[order]),
                 out=contract, out_rows=idx)
        stats["calls"] += 1
        return order, idx_d

    def _finite(order: np.ndarray, idx_d: torch.Tensor) -> np.ndarray:
        """Whether each row of a launch is finite, in the order of its
        ``sel``; the fetch of the flags waits for the launch."""
        with span("pregen.masked.finite"):
            flags = finite_rows(contract, store)[idx_d]
        with span("pregen.masked.fetch", flags.numel()):
            got = np.empty(len(order), dtype=bool)
            got[order] = to_host(flags)
        return got

    dt_now = pr["dt"].copy()
    first = _launch(np.arange(len(rows)), dt_now)
    with span("pregen.masked.assemble"):  # an enqueue: channels 3-5 of every row
        contract[..., 3].copy_(re_norm[:, None, None, None])
        contract[..., 4].copy_(masks[:, None])
        contract[..., 5].copy_(sdfs[:, None])
    finite = _finite(*first)
    # trajectories that go non-finite (severe constrictions) re-run together
    # at dt/2 per attempt, each at its own sub-bucket's dt/2^attempt, so the
    # count stays; a retry counts once per sub-bucket with a bad row
    for attempt in range(cfg.nonfinite_retries):
        if finite.all():
            break
        bad = np.nonzero(~finite)[0]
        dt_now[bad] /= 2.0
        for k in np.unique(sub[bad]):
            logging.getLogger("pregen_pde_tpu_torch.datagen").warning(
                "masked_ns horizon %s: %d/%d non-finite, retrying at dt=%g (attempt %d)",
                plan[k][1], int((sub[bad] == k).sum()), len(plan[k][0]),
                dt_now[bad][sub[bad] == k][0], attempt + 1)
        with span("pregen.masked.retry"):
            finite[bad] = _finite(*_launch(bad, dt_now[bad]))
        stats["retries"] += len(np.unique(sub[bad]))
        stats["retried_trajectories"] += len(bad)
    with span("pregen.masked.fetch", contract.numel() * store.itemsize):
        if store != contract.dtype:
            contract = contract.to(store)  # cast on the device before the fetch
        return to_host(contract)


def generate_masked_ns_batch(generator: torch.Generator, cfg: MaskedNSConfig,
                             n_traj: int | None = None, storage_dtype: str = "float32",
                             stats: dict | None = None) -> np.ndarray:
    """Draw one batch's inputs from ``generator`` and generate it on the
    generator's device."""
    z_re, masks = draw_masked_inputs(generator, cfg, n_traj)
    return generate_masked_ns_batch_from_inputs(z_re, masks, cfg, storage_dtype, stats)
