"""Dataset factories of the heat, Burgers and Darcy workloads (port of
``datagen/simple.py``):

- 1-D viscous Burgers (ν = 0.1, GRF initial conditions) → (N, S+1, X);
- 2-D heat / diffusion-reaction FD, periodic, GRF initial conditions →
  (N, S+1, n, n), stepped through K5b on a CUDA device
  (``HeatSolver(impl="auto")``);
- 2-D steady Darcy, lognormal (or thresholded) GRF permeability →
  (N, 2, n, n), channel 0 the coefficient a, channel 1 the solution u.

Each ``generate_*_batch`` draws its white noise from a ``torch.Generator``
on the generator's device and hands it to a ``*_from_noise`` function, which
is pure: the tests feed it JAX's own noise. The cast to the storage dtype
happens on the device, before the host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from pregen_pde_tpu_torch.core import BurgersConfig, SpectralGrid1D, SpectralGrid2D
from pregen_pde_tpu_torch.datagen.fetch import to_host
from pregen_pde_tpu_torch.fields.grf import (
    draw_grf_1d_noise,
    draw_grf_noise,
    grf_1d_filter,
    grf_filter,
    lognormal_grf_2d,
    piecewise_constant_grf_2d,
)
from pregen_pde_tpu_torch.solvers.burgers import BurgersSolver
from pregen_pde_tpu_torch.solvers.darcy import DarcyConfig, solve_darcy
from pregen_pde_tpu_torch.solvers.heat import HeatConfig, HeatSolver


def _fetch(arr: torch.Tensor, storage_dtype: str) -> np.ndarray:
    """Cast to the storage dtype on the device, then copy to the host
    (through the page-locked pool for a CUDA tensor)."""
    store = getattr(torch, np.dtype(storage_dtype).name)
    if arr.dtype != store:
        arr = arr.to(store)
    return to_host(arr)


def generate_burgers_batch_from_noise(xi: torch.Tensor, cfg: BurgersConfig,
                                      grf_alpha: float = 2.0, grf_tau: float = 5.0,
                                      storage_dtype: str = "float32") -> np.ndarray:
    """White noise (N, X) → (N, S+1, X) Burgers trajectories."""
    grid = SpectralGrid1D(cfg.resolution, cfg.length)
    u0 = grf_1d_filter(xi, grid, alpha=grf_alpha, tau=grf_tau)
    return _fetch(BurgersSolver(cfg).make_batched_trajectory_fn()(u0), storage_dtype)


def generate_burgers_batch(generator: torch.Generator, cfg: BurgersConfig, n_traj: int,
                           grf_alpha: float = 2.0, grf_tau: float = 5.0,
                           storage_dtype: str = "float32") -> np.ndarray:
    xi = draw_grf_1d_noise(generator, n_traj, cfg.resolution)
    return generate_burgers_batch_from_noise(xi, cfg, grf_alpha, grf_tau, storage_dtype)


def generate_heat_batch_from_noise(xi: torch.Tensor, cfg: HeatConfig,
                                   grf_alpha: float = 2.5, grf_tau: float = 7.0,
                                   storage_dtype: str = "float32") -> np.ndarray:
    """White noise (N, n, n) → (N, S+1, n, n) heat trajectories."""
    grid = SpectralGrid2D(cfg.resolution, cfg.length)
    u0 = grf_filter(xi, grid, alpha=grf_alpha, tau=grf_tau)
    traj = HeatSolver(cfg).make_batched_trajectory_fn()
    return _fetch(traj(u0), storage_dtype)


def generate_heat_batch(generator: torch.Generator, cfg: HeatConfig, n_traj: int,
                        grf_alpha: float = 2.5, grf_tau: float = 7.0,
                        storage_dtype: str = "float32") -> np.ndarray:
    xi = draw_grf_noise(generator, n_traj, cfg.resolution)
    return generate_heat_batch_from_noise(xi, cfg, grf_alpha, grf_tau, storage_dtype)


def generate_darcy_batch_from_noise(xi: torch.Tensor, cfg: DarcyConfig,
                                    lognormal: bool = True,
                                    storage_dtype: str = "float32") -> np.ndarray:
    """White noise (N, n, n) → (N, 2, n, n) stacked [a, u]."""
    grid = SpectralGrid2D(cfg.resolution, cfg.length)
    a = lognormal_grf_2d(xi, grid) if lognormal else piecewise_constant_grf_2d(xi, grid)
    u = solve_darcy(a, cfg)
    return _fetch(torch.stack([a, u], dim=1), storage_dtype)


def generate_darcy_batch(generator: torch.Generator, cfg: DarcyConfig, n_traj: int,
                         lognormal: bool = True,
                         storage_dtype: str = "float32") -> np.ndarray:
    xi = draw_grf_noise(generator, n_traj, cfg.resolution)
    return generate_darcy_batch_from_noise(xi, cfg, lognormal, storage_dtype)
