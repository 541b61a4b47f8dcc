"""2-D heat / diffusion-reaction transient FD solver, 128² periodic (port of
``solvers/heat.py``).

    u_t = D Δu + R(u),  R(u) = k·u(1−u²)  (Allen-Cahn-type reaction; k = 0 is
    pure heat)

Heun (RK2) time stepping, periodic boundaries. ``HeatSolver(cfg, impl)``
picks the route; ``impl`` takes the place of the JAX ``use_pallas``:

- ``"plain"``: ``laplacian_roll`` in an eager Heun step (JAX's
  ``use_pallas=False``, the XLA route);
- ``"laplacian"``: K5a (``ops/stencil.laplacian_cuda``) inside the eager
  Heun step (JAX's ``use_pallas=True``);
- ``"fused"``: K5b (``ops/stencil.heat_trajectory``), the whole Heun step
  in one kernel, the whole trajectory of a batch in one call (one launch on
  the resident route);
- ``"auto"``: ``"fused"`` on a CUDA device, ``"plain"`` elsewhere.

On the CPU the K5a and K5b routes run the kernels' plain versions; on a
CUDA tensor they launch the kernels or raise (float32 only).
"""

from __future__ import annotations

import dataclasses

import torch

from pregen_pde_tpu_torch.ops import stencil

IMPLS = ("auto", "plain", "laplacian", "fused")


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    """Same fields and defaults as the JAX package's ``HeatConfig``."""

    resolution: int = 128
    diffusivity: float = 1e-2
    reaction: float = 0.0  # k in k·u(1−u²); 0 → pure heat
    length: float = 1.0
    dt: float = 1e-4
    t_end: float = 1.0
    n_snapshots: int = 20


def laplacian_roll(u: torch.Tensor, dx: float) -> torch.Tensor:
    """5-point periodic Laplacian in the XLA route's order, divided by dx²
    (``heat.py:36-42``)."""
    return (
        torch.roll(u, 1, -1) + torch.roll(u, -1, -1)
        + torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
        - 4.0 * u
    ) / (dx * dx)


@dataclasses.dataclass(frozen=True)
class HeatSolver:
    cfg: HeatConfig
    impl: str = "auto"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")

    @property
    def dx(self) -> float:
        return self.cfg.length / self.cfg.resolution

    def route(self, device: torch.device | str) -> str:
        """The route ``impl`` resolves to on ``device``."""
        if self.impl == "auto":
            return "fused" if torch.device(device).type == "cuda" else "plain"
        return self.impl

    def _lap(self, u: torch.Tensor) -> torch.Tensor:
        if self.impl == "laplacian":
            return stencil.laplacian_cuda(u, self.dx)
        return laplacian_roll(u, self.dx)

    def rhs(self, u: torch.Tensor) -> torch.Tensor:
        out = self.cfg.diffusivity * self._lap(u)
        if self.cfg.reaction != 0.0:
            out = out + self.cfg.reaction * u * (1.0 - u * u)
        return out

    def step_heun(self, u: torch.Tensor, dt: float) -> torch.Tensor:
        """One Heun step; the fused route is one K5b launch."""
        if self.route(u.device) == "fused":
            return stencil.heat_step_cuda(u, self.dx, self.cfg.diffusivity, dt,
                                          self.cfg.reaction)
        k1 = self.rhs(u)
        k2 = self.rhs(u + dt * k1)
        return u + 0.5 * dt * (k1 + k2)

    def steps(self) -> tuple[int, int]:
        """(snapshots S, steps a snapshot): round(t_end/dt) steps in all,
        S·(total // S) of them run (at least one a snapshot)."""
        total = int(round(self.cfg.t_end / self.cfg.dt))
        return self.cfg.n_snapshots, max(total // self.cfg.n_snapshots, 1)

    def make_batched_trajectory_fn(self):
        """``traj(u0 (B, n, n)) -> (B, S+1, n, n)``, frame 0 = u0, in u0's
        dtype (dt is cast to it, as the JAX solver does)."""
        S, inner = self.steps()
        cfg = self.cfg

        def traj(u0: torch.Tensor) -> torch.Tensor:
            dt = torch.tensor(cfg.dt, dtype=u0.dtype).item()
            if self.route(u0.device) == "fused":
                return stencil.heat_trajectory(u0, S, inner, self.dx, cfg.diffusivity, dt,
                                               cfg.reaction)
            out = torch.empty((u0.shape[0], S + 1, *u0.shape[1:]), dtype=u0.dtype,
                              device=u0.device)
            out[:, 0] = u0
            u = u0
            for s in range(S):
                for _ in range(inner):
                    u = self.step_heun(u, dt)
                out[:, s + 1] = u
            return out

        return traj

    def make_trajectory_fn(self):
        """``traj(u0 (n, n)) -> (S+1, n, n)``."""
        batched = self.make_batched_trajectory_fn()
        return lambda u0: batched(u0[None])[0]
