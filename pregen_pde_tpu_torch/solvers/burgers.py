"""1-D viscous Burgers, periodic pseudo-spectral (port of
``solvers/burgers.py``): ν = 0.1, 1024-point grid by default.

    u_t + u u_x = ν u_xx,  conservative form: u_t = −∂x(u²/2) + ν u_xx

IMEX: Crank-Nicolson diffusion + Heun advection, 2/3 dealiasing, on
``torch.fft.rfft/irfft`` batched over the leading axis. The JAX package
computes this with ``jnp.fft`` outside any kernel, so it stays plain
PyTorch here.
"""

from __future__ import annotations

import dataclasses

import torch

from pregen_pde_tpu_torch.core import BurgersConfig, SpectralGrid1D


@dataclasses.dataclass(frozen=True)
class BurgersSolver:
    cfg: BurgersConfig

    @property
    def grid(self) -> SpectralGrid1D:
        return SpectralGrid1D(self.cfg.resolution, self.cfg.length)

    def _constants(self, dtype: torch.dtype, device) -> dict:
        """k_deriv, the dealias mask and the CN factors, computed in float64
        numpy and cast to ``dtype`` (``burgers.py:51-55``)."""
        g = self.grid
        nu_k2 = self.cfg.viscosity * g.k**2
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return {
            "k": as_t(g.k_deriv),
            "mask": as_t(g.dealias_mask),
            "num": as_t(1.0 - 0.5 * self.cfg.dt * nu_k2),
            "den": as_t(1.0 / (1.0 + 0.5 * self.cfg.dt * nu_k2)),
        }

    def _nonlinear_hat(self, u_hat: torch.Tensor, c: dict) -> torch.Tensor:
        u = torch.fft.irfft(u_hat, n=self.grid.n)
        flux_hat = torch.fft.rfft(0.5 * u * u)
        return -1j * c["k"] * (flux_hat * c["mask"])

    def step_cn_heun(self, u_hat: torch.Tensor, dt: float, c: dict) -> torch.Tensor:
        n1 = self._nonlinear_hat(u_hat, c)
        u_pred = (u_hat * c["num"] + dt * n1) * c["den"]
        n2 = self._nonlinear_hat(u_pred, c)
        return (u_hat * c["num"] + 0.5 * dt * (n1 + n2)) * c["den"]

    def make_batched_trajectory_fn(self):
        """``traj(u0 (B, n)) -> (B, S+1, n)``, frame 0 = u0, in u0's dtype:
        round(t_end/dt) steps in all, S·max(total // S, 1) of them run."""
        cfg = self.cfg
        n = self.grid.n
        S = cfg.n_snapshots
        inner = max(int(round(cfg.t_end / cfg.dt)) // S, 1)

        def traj(u0: torch.Tensor) -> torch.Tensor:
            c = self._constants(u0.dtype, u0.device)
            dt = torch.tensor(cfg.dt, dtype=u0.dtype).item()
            out = torch.empty((u0.shape[0], S + 1, n), dtype=u0.dtype, device=u0.device)
            out[:, 0] = u0
            u_hat = torch.fft.rfft(u0)
            for s in range(S):
                for _ in range(inner):
                    u_hat = self.step_cn_heun(u_hat, dt, c)
                out[:, s + 1] = torch.fft.irfft(u_hat, n=n)
            return out

        return traj
