"""Difficulty schedules (port of ``solvers/schedules.py``).

- Re ~ clip(N(mean, std²), 100, 10⁴);
- the reference's band-law Re → horizon table (first match wins in the
  reference's descending list ≡ the multiplier of the highest lower edge ≤ Re),
  endTime = ceil(mult · L² / (Re·ν) / 100) · 100 s, 2700 s below Re = 100;
- Re normalisation (Re − 100) / 9900 and ν = U·L/Re.

All functions act on tensors of any float dtype on any device; the pipeline
runs them in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RE_MIN = 100.0
RE_MAX = 10000.0

SCHEDULE_L = 2.0
SCHEDULE_NU = 1.5e-5
LOW_RE_END_TIME = 2700.0

_BAND_EDGES = np.asarray([100.0, 200.0, 300.0, 400.0, 500.0, 1000.0, 2500.0, 4000.0, 5000.0])
_BAND_MULTS = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 10.0, 20.0, 30.0, 40.0])


def sample_reynolds(generator: torch.Generator | None = None, n: int | None = None,
                    mean=5000.0, std=2000.0, z: torch.Tensor | None = None,
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Re ~ clip(N(mean, std²), RE_MIN, RE_MAX), shape (n,). Pass either a
    ``generator`` and ``n`` or a pre-drawn standard normal ``z``."""
    if z is None:
        if generator is None or n is None:
            raise ValueError("sample_reynolds needs (generator, n) or z")
        z = torch.randn((n,), generator=generator, dtype=dtype,
                        device=generator.device)
    return torch.clamp(mean + std * z, RE_MIN, RE_MAX)


def end_time_from_re_py(re: float) -> float:
    """Scalar float64 mirror of the reference horizon law; Re in [10, 10⁴]."""
    if not 10.0 <= re <= RE_MAX:
        raise ValueError(f"Re={re} outside the reference schedule's [10, 10000]")
    if re < RE_MIN:
        raw = LOW_RE_END_TIME
    else:
        idx = int(np.searchsorted(_BAND_EDGES, re, side="right")) - 1
        raw = _BAND_MULTS[idx] * SCHEDULE_L**2 / (re * SCHEDULE_NU)
    return math.ceil(raw / 100.0) * 100.0


def end_time_from_re(re: torch.Tensor) -> torch.Tensor:
    """Vectorised horizon law; the 1e-6 relative slack before the ceil keeps
    exact band-edge values from rounding up a whole 100 s."""
    re = torch.clamp(torch.as_tensor(re), 10.0, RE_MAX)
    edges = torch.as_tensor(_BAND_EDGES, dtype=re.dtype, device=re.device)
    mults = torch.as_tensor(_BAND_MULTS, dtype=re.dtype, device=re.device)
    idx = torch.clamp(torch.searchsorted(edges, re, right=True) - 1, 0, len(_BAND_MULTS) - 1)
    raw_band = mults[idx] * (SCHEDULE_L**2) / (re * SCHEDULE_NU)
    raw = torch.where(re < RE_MIN, torch.full_like(re, LOW_RE_END_TIME), raw_band)
    q = raw / 100.0
    return torch.ceil(q - q * 1e-6) * 100.0


def normalize_re(re):
    return (re - RE_MIN) / (RE_MAX - RE_MIN)


def denormalize_re(re_norm):
    return re_norm * (RE_MAX - RE_MIN) + RE_MIN


def viscosity_from_re(re, velocity_scale=1.0, length_scale=1.0):
    """ν = U·L/Re on the unit-torus benchmark."""
    return velocity_scale * length_scale / re


def steps_for_horizon(end_time: torch.Tensor, dt: float) -> torch.Tensor:
    return torch.round(end_time / dt).to(torch.int32)
