"""Difficulty schedules, frozen: Re sampling, the band-law horizons, Re
normalisation and ν = 1/Re.

Copied from ``pregen_pde_tpu_torch/solvers/schedules.py`` at commit 92d189c.
Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

RE_MIN = 100.0
RE_MAX = 10000.0

SCHEDULE_L = 2.0
SCHEDULE_NU = 1.5e-5
LOW_RE_END_TIME = 2700.0

BAND_EDGES = (100.0, 200.0, 300.0, 400.0, 500.0, 1000.0, 2500.0, 4000.0, 5000.0)
BAND_MULTS = (1.0, 2.0, 3.0, 4.0, 5.0, 10.0, 20.0, 30.0, 40.0)


def reynolds(z: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Re = clip(mean + std·z, RE_MIN, RE_MAX), in z's dtype."""
    return torch.clamp(mean + std * z, RE_MIN, RE_MAX)


def end_time_from_re(re: torch.Tensor) -> torch.Tensor:
    """The reference's horizon law: ceil(mult·L²/(Re·ν)/100)·100 s, the
    multiplier of the highest band edge ≤ Re; 2700 s below Re = 100. The
    1e-6 relative slack before the ceil keeps exact band edges from rounding
    up a whole 100 s."""
    re = torch.clamp(torch.as_tensor(re), 10.0, RE_MAX)
    edges = torch.as_tensor(BAND_EDGES, dtype=re.dtype, device=re.device)
    mults = torch.as_tensor(BAND_MULTS, dtype=re.dtype, device=re.device)
    idx = torch.clamp(torch.searchsorted(edges, re, right=True) - 1, 0, len(BAND_MULTS) - 1)
    raw_band = mults[idx] * (SCHEDULE_L**2) / (re * SCHEDULE_NU)
    raw = torch.where(re < RE_MIN, torch.full_like(re, LOW_RE_END_TIME), raw_band)
    q = raw / 100.0
    return torch.ceil(q - q * 1e-6) * 100.0


def normalize_re(re):
    return (re - RE_MIN) / (RE_MAX - RE_MIN)


def viscosity_from_re(re):
    """ν = U·L/Re with U = L = 1."""
    return 1.0 / re


def spectral_inner_steps(end_t: np.ndarray, dt: float, n_snapshots: int) -> np.ndarray:
    """Solver steps a snapshot interval of each horizon (schedule seconds
    already scaled): max(round(h/dt) // n_snapshots, 1)."""
    return np.array([max(int(round(float(h) / dt)) // n_snapshots, 1) for h in end_t],
                    dtype=np.int64)
