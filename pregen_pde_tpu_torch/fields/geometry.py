"""No-hole mask and the mask → SDF construction (port of ``fields/geometry.py``).

Only what the spectral-NS path needs: the all-fluid mask and ``sdf_from_mask``
with its exact two-phase squared EDT (``geometry.py:29-70``). The random hole
samplers belong to the masked-geometry slice and are not ported yet.

Mask convention: 1 = hole/obstacle, 0 = fluid.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

_INF = 1.0e12


def _edt_sq(zero_set: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance from every pixel to the nearest True
    pixel of ``zero_set`` (+INF-ish where none): d²(i,j) = min_j' [g(i,j') +
    (j−j')²], g(i,j') = min_{i': zero(i',j')} (i−i')². Dense (n,n,n) min
    reductions, O(n³) flops."""
    n_r, n_c = zero_set.shape
    dev = zero_set.device
    rows = torch.arange(n_r, dtype=torch.float32, device=dev)
    d_rr = (rows[:, None] - rows[None, :]) ** 2
    blocked = torch.where(zero_set, 0.0, _INF)
    g = torch.amin(d_rr[:, :, None] + blocked[None, :, :], dim=1)
    cols = torch.arange(n_c, dtype=torch.float32, device=dev)
    d_cc = (cols[:, None] - cols[None, :]) ** 2
    return torch.amin(g[:, None, :] + d_cc.T[None, :, :], dim=2)


def sdf_from_mask(mask: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Signed distance: positive in fluid, negative in holes, normalised by
    max |sdf|. The all-fluid mask yields a constant 1.0."""
    mask = mask.to(torch.float32)
    is_hole = mask > 0.5
    cap = math.sqrt(2.0) * mask.shape[0]
    outside = torch.clamp(torch.sqrt(_edt_sq(is_hole)), max=cap)
    inside = torch.clamp(torch.sqrt(_edt_sq(~is_hole)), max=cap)
    sdf = outside - inside
    if normalize:
        sdf = sdf / torch.clamp(sdf.abs().max(), min=1e-6)
    return sdf


def no_hole_mask(n: int = 128, device: str | torch.device = "cpu") -> torch.Tensor:
    """The 'easy' geometry: all fluid."""
    return torch.zeros((n, n), dtype=torch.float32, device=device)


@lru_cache(maxsize=8)
def no_hole_mask_and_sdf(n: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, sdf) of the no-hole geometry, built once per (n, device) and
    shared read-only by every bucket."""
    mask = no_hole_mask(n, device)
    return mask, sdf_from_mask(mask)
