"""Physical validation of the masked-geometry projection solver (port of
``solvers/validation.py``): the three classical benchmarks of the JAX
package, with its signatures, defaults and returned keys (plus ``steps``).

1. ``run_cavity``: the lid-driven cavity against the Ghia–Ghia–Shin (1982)
   centreline tables at Re 100 and 400. It integrates to steady state as one
   batched trajectory with one snapshot per 1000 steps and applies the JAX
   package's steady test (max |Δu| between consecutive 1000-step chunks <
   ``steady_tol``) to the snapshots: the result is the first snapshot that
   passes it, or the last.
2. ``run_cylinder``: vortex shedding behind a penalised cylinder in the FPO
   channel, the Strouhal number from a wake probe and the mean drag
   coefficient from the Brinkman momentum sink, read from a frame every step.
3. ``convergence_order``: the observed spatial order on the developing
   cavity flow from a Richardson triplet.

Each solve is one call of the batched trajectory: on a CUDA device through
the hand-written CUDA stepper (``ns_projection_cuda``), elsewhere through
its plain version; a CUDA device that is absent raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pregen_pde_tpu_torch.fields.geometry import disk_mask
from pregen_pde_tpu_torch.solvers.ns_projection import ProjectionConfig, ProjectionSolver
from pregen_pde_tpu_torch.utils.device import resolve_device

# Ghia, Ghia & Shin, J. Comput. Phys. 48 (1982), tables I & II: u along the
# vertical centreline (x=0.5) at stations GHIA_Y, v along the horizontal
# centreline (y=0.5) at stations GHIA_X; lid speed 1, cavity side 1.
GHIA_Y = np.array([0.0000, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813,
                   0.4531, 0.5000, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609,
                   0.9688, 0.9766, 1.0000])
GHIA_U = {
    100: np.array([0.0, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150,
                   -0.15662, -0.21090, -0.20581, -0.13641, 0.00332, 0.23151,
                   0.68717, 0.73722, 0.78871, 0.84123, 1.0]),
    400: np.array([0.0, -0.08186, -0.09266, -0.10338, -0.14612, -0.24299,
                   -0.32726, -0.17119, -0.11477, 0.02135, 0.16256, 0.29093,
                   0.55892, 0.61756, 0.68439, 0.75837, 1.0]),
}
GHIA_X = np.array([0.0000, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266,
                   0.2344, 0.5000, 0.8047, 0.8594, 0.9063, 0.9453, 0.9531,
                   0.9609, 0.9688, 1.0000])
GHIA_V = {
    100: np.array([0.0, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077, 0.17507,
                   0.17527, 0.05454, -0.24533, -0.22445, -0.16914, -0.10313,
                   -0.08864, -0.07391, -0.05906, 0.0]),
    400: np.array([0.0, 0.18360, 0.19713, 0.20920, 0.22965, 0.28124, 0.30203,
                   0.30174, 0.05186, -0.38598, -0.44993, -0.33827, -0.22847,
                   -0.19254, -0.15663, -0.12146, 0.0]),
}
CHUNK = 1000  # steps between steady-state checks; the cylinder runs whole chunks


def _batched_traj(sol: ProjectionSolver, device: torch.device):
    """The batched trajectory on ``device``: the CUDA stepper on the card,
    the plain version elsewhere."""
    if device.type == "cuda":
        from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc

        return npc.build_batched_traj(sol)
    return sol.make_batched_trajectory_fn()


def _cavity_solver(re: float, n: int, advection: str) -> tuple:
    nu = 1.0 / re
    cfg = ProjectionConfig(resolution=n, length=1.0, viscosity=nu, domain="cavity",
                           u_max=1.0, pressure_solver="direct", advection=advection)
    dx = 1.0 / n
    dt = min(0.4 * dx / 2.0, 0.2 * dx * dx / nu)
    return ProjectionSolver(cfg), dx, dt


def run_cavity(re: float, n: int = 128, advection: str = "muscl",
               t_end: float | None = None, steady_tol: float = 1e-6,
               device: str | torch.device = "cuda") -> dict:
    """Integrate the lid-driven cavity to steady state on ``device`` (the
    card by default; raises where there is none) → the centreline profiles
    at the Ghia stations and their deviations."""
    sol, _, dt = _cavity_solver(re, n, advection)
    t_end = t_end or (30.0 if re <= 100 else 50.0)
    chunks = max(int(t_end / dt) // CHUNK, 1)
    sol = ProjectionSolver(dataclasses.replace(sol.cfg, n_snapshots=chunks))
    device = resolve_device(device)
    mask = torch.zeros((1, n, n), dtype=torch.float32, device=device)
    frames = _batched_traj(sol, device)(mask, torch.ones((1,), device=device), CHUNK, dt)[0]
    u_all = frames[..., 0].cpu().numpy()
    used = chunks
    for s in range(1, chunks + 1):
        if float(np.abs(u_all[s] - u_all[s - 1]).max()) < steady_tol:
            used = s
            break
    u = u_all[used]
    v = frames[used, ..., 1].cpu().numpy()
    yc = (np.arange(n) + 0.5) / n
    u_c = 0.5 * (u[:, n // 2 - 1] + u[:, n // 2])
    v_c = 0.5 * (v[n // 2 - 1, :] + v[n // 2, :])
    u_i = np.interp(GHIA_Y, np.r_[0, yc, 1], np.r_[0, u_c, 1.0])
    v_i = np.interp(GHIA_X, np.r_[0, yc, 1], np.r_[0, v_c, 0.0])
    gu, gv = GHIA_U[int(re)], GHIA_V[int(re)]
    return {
        "Re": re, "n": n, "advection": advection, "steps": used * CHUNK, "dt": dt,
        "u_model": u_i, "v_model": v_i, "u_ghia": gu, "v_ghia": gv,
        "max_abs_dev_u": float(np.max(np.abs(u_i - gu))),
        "max_abs_dev_v": float(np.max(np.abs(v_i - gv))),
        "u_min_model": float(u_c.min()), "u_min_ghia": float(gu.min()),
        "v_min_model": float(v_c.min()), "v_min_ghia": float(gv.min()),
        "v_max_model": float(v_c.max()), "v_max_ghia": float(gv.max()),
    }


def run_cylinder(re_d: float = 150.0, n: int = 128, advection: str = "muscl",
                 t_end: float = 80.0, diameter_cells: int = 12, u_max: float = 1.0,
                 device: str | torch.device = "cuda") -> dict:
    """Flow past a penalised circular cylinder in the FPO channel on
    ``device`` (the card by default; raises where there is none): the
    vortex-shedding Strouhal number from the wake v-velocity probe and the
    mean drag coefficient from the Brinkman momentum sink.

    The definitions are the JAX package's: the incident velocity is u_max,
    Re_d = u_max·d/ν, St = f·d/u_max and Cd = 2·F_x/(u_max²·d) with F_x =
    Σ χ·u/η·dx², u read after each step; the cylinder sits one cell off the
    centreline, which triggers the shedding deterministically. It runs
    ``(int(t_end/dt) // 1000) · 1000`` steps from rest, as the JAX package's
    whole chunks of 1000 do, in one trajectory call with a frame every step:
    (steps + 1)·n²·3 float32 values, 6.7 GB at the defaults (34,000 steps at
    128²), on the device. The probe and drag series are reduced there and
    only they are fetched; St, the amplitude and Cd come from the last 40 %
    of them, with the JAX package's spectrum and definitions."""
    length = 2.0
    dx = length / n
    d = diameter_cells * dx
    nu = u_max * d / re_d
    dt = 0.3 * dx / (2.0 * u_max)
    steps = int(t_end / dt) // CHUNK * CHUNK
    if steps == 0:
        raise ValueError(f"t_end {t_end} is shorter than one chunk of {CHUNK} steps of dt {dt}")
    cfg = ProjectionConfig(resolution=n, length=length, viscosity=nu, domain="channel",
                           u_max=u_max, pressure_solver="direct", advection=advection,
                           n_snapshots=steps)
    sol = ProjectionSolver(cfg)
    device = resolve_device(device)
    # centre offset by ~1 cell breaks the symmetric (unstable) equilibrium
    mask = disk_mask(n, n / 2.0 + 1.0, n / 4.0, diameter_cells / 2.0, device=device)
    probe = (n // 2, int(n / 4.0 + 3 * diameter_cells))  # 3 diameters behind
    frames = _batched_traj(sol, device)(mask[None], None, 1, dt)[0, 1:]
    sig = frames[:, probe[0], probe[1], 1].cpu().numpy()
    drags = ((mask * frames[..., 0]).sum((-2, -1)) / cfg.penalization_eta * dx * dx
             ).cpu().numpy()
    del frames

    # frequency of the established shedding: last 40% of the run
    tail = sig[int(0.6 * len(sig)):]
    tail = tail - tail.mean()
    spec = np.abs(np.fft.rfft(tail))
    freqs = np.fft.rfftfreq(len(tail), d=dt)
    f_shed = float(freqs[1:][np.argmax(spec[1:])])  # skip DC
    cd_tail = drags[int(0.6 * len(drags)):]
    return {
        "re_d": re_d, "n": n, "advection": advection, "diameter": d,
        "strouhal": f_shed * d / u_max,
        "shedding_amplitude": float(tail.std()),
        "cd_mean": float(2.0 * cd_tail.mean() / (u_max**2 * d)),
        "dt": dt, "t_end": t_end, "steps": steps,
    }


def convergence_order(re: float = 100.0, t_end: float = 1.0, ns: tuple = (32, 64, 128),
                      advection: str = "muscl", device: str | torch.device = "cuda") -> dict:
    """Observed spatial order on the developing cavity flow on ``device``
    (the card by default; raises where there is none) via a Richardson
    triplet: integrate to ``t_end`` at three resolutions with ONE shared
    small dt (the finest grid's bound; time error subdominant), each grid one
    trajectory call with a single snapshot at the end, restrict fine → coarse
    by 2×2 block averaging, order = log2(|e_coarse|/|e_fine|)."""
    n0, n1, n2 = ns
    nu = 1.0 / re
    dt = min(0.4 / n2 / 2.0, 0.2 / (n2 * n2) / nu)  # finest grid's bound
    steps = int(round(t_end / dt))
    device = resolve_device(device)

    def solve(n):
        cfg = ProjectionConfig(resolution=n, length=1.0, viscosity=nu, domain="cavity",
                               u_max=1.0, pressure_solver="direct", advection=advection,
                               n_snapshots=1)
        mask = torch.zeros((1, n, n), dtype=torch.float32, device=device)
        frames = _batched_traj(ProjectionSolver(cfg), device)(mask, None, steps, dt)
        return frames[0, -1, ..., 0].cpu().numpy()

    def coarsen(a, factor):
        n = a.shape[0] // factor
        return a.reshape(n, factor, n, factor).mean((1, 3))

    u0, u1, u2 = solve(n0), solve(n1), solve(n2)
    e0 = np.abs(u0 - coarsen(u2, n2 // n0))[1:-1, 1:-1].mean()
    e1 = np.abs(u1 - coarsen(u2, n2 // n1))[1:-1, 1:-1].mean()
    return {"ns": ns, "e_coarse": float(e0), "e_fine": float(e1),
            "order": float(np.log2(e0 / e1)), "advection": advection, "steps": steps}
