"""Gaussian Fourier features of coordinate inputs (port of the JAX
package's ``models/fourier_features.py``).

B ~ scale · N(0, 1) of shape (mapping_size, coord_dim), drawn on the host
from ``np.random.default_rng(seed)`` exactly as in JAX and held as a
non-persistent buffer (a constant: no parameter, nothing in the
state_dict); the features are [sin(2π x Bᵀ), cos(2π x Bᵀ)], and scale 0
returns x unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn


class FourierFeatures(nn.Module):
    """x: (..., coord_dim) coordinates → (..., 2·mapping_size) features (or
    x unchanged when scale == 0)."""

    def __init__(self, scale: float, mapping_size: int, coord_dim: int = 2, seed: int = 0):
        super().__init__()
        self.scale = scale
        if scale != 0:
            b = scale * np.random.default_rng(seed).standard_normal(
                (mapping_size, coord_dim)).astype(np.float32)
            self.register_buffer("B", torch.from_numpy(b), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale == 0:
            return x
        proj = (2.0 * math.pi * x) @ self.B.T.to(x.dtype)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
