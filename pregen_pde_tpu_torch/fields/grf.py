"""Gaussian random fields (port of ``fields/grf.py``): the 2-D initial
vorticity and heat fields, the 1-D Burgers initial condition, and the
lognormal and thresholded Darcy coefficients.

X ~ N(0, σ² (−Δ + τ² I)^(−α)) on the periodic torus, sampled by spectrally
filtering white noise: X = irfft2(rfft2(ξ) · h(k)), h = n·σ·(|k|² + τ²)^(−α/2),
h[0,0] = 0 (zero mean). Pointwise variance is Σ_k S(k), S = σ²(|k|²+τ²)^(−α).

The JAX sampler draws ξ from a threefry key inside the function; torch cannot
reproduce that stream, so the draw and the filter are two functions here:
``draw_grf_noise`` (explicit ``torch.Generator``) and ``grf_filter`` (pure),
and a parity test feeds JAX's own ξ through ``grf_filter``; the same for 1-D
(``draw_grf_1d_noise``, ``grf_1d_filter``). The Darcy coefficients are
functions of the noise on top of ``grf_filter``.
"""

from __future__ import annotations

import numpy as np
import torch

from pregen_pde_tpu_torch.core import SpectralGrid1D, SpectralGrid2D


def _default_sigma(tau: float, alpha: float, d: int) -> float:
    return float(tau ** (0.5 * (2.0 * alpha - d)))


def grf_spectrum_filter(grid: SpectralGrid2D, alpha: float = 2.5, tau: float = 7.0,
                        sigma: float | None = None, zero_mean: bool = True) -> np.ndarray:
    """h(k) in rfft2 layout, float64 (``grf.py:45-52``)."""
    if sigma is None:
        sigma = _default_sigma(tau, alpha, 2)
    h = grid.n * sigma * (grid.k2 + tau**2) ** (-alpha / 2.0)
    if zero_mean:
        h = h.copy()
        h[0, 0] = 0.0
    return h


def draw_grf_noise(generator: torch.Generator, batch: int, n: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """White noise ξ ~ N(0, 1), shape (batch, n, n), on the generator's device."""
    return torch.randn((batch, n, n), generator=generator, dtype=dtype,
                       device=generator.device)


def grf_filter(xi: torch.Tensor, grid: SpectralGrid2D, alpha: float = 2.5,
               tau: float = 7.0, sigma: float | None = None,
               zero_mean: bool = True) -> torch.Tensor:
    """Filter white noise (..., n, n) into GRF samples of the same shape/dtype."""
    n = grid.n
    h = torch.as_tensor(grf_spectrum_filter(grid, alpha, tau, sigma, zero_mean),
                        dtype=xi.dtype, device=xi.device)
    return torch.fft.irfft2(torch.fft.rfft2(xi) * h, s=(n, n)).to(xi.dtype)


def grf_2d(generator: torch.Generator, grid: SpectralGrid2D, batch: int,
           alpha: float = 2.5, tau: float = 7.0, sigma: float | None = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(batch, n, n) GRF samples: ``draw_grf_noise`` then ``grf_filter``."""
    xi = draw_grf_noise(generator, batch, grid.n, dtype)
    return grf_filter(xi, grid, alpha, tau, sigma)


def grf_1d_spectrum_filter(grid: SpectralGrid1D, alpha: float = 2.0, tau: float = 5.0,
                           sigma: float | None = None, zero_mean: bool = True) -> np.ndarray:
    """h(k) in rfft layout, float64: √n·σ·(k² + τ²)^(−α/2) (``grf.py:70-75``)."""
    if sigma is None:
        sigma = _default_sigma(tau, alpha, 1)
    h = np.sqrt(grid.n) * sigma * (grid.k**2 + tau**2) ** (-alpha / 2.0)
    if zero_mean:
        h = h.copy()
        h[0] = 0.0
    return h


def draw_grf_1d_noise(generator: torch.Generator, batch: int, n: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """White noise ξ ~ N(0, 1), shape (batch, n), on the generator's device."""
    return torch.randn((batch, n), generator=generator, dtype=dtype, device=generator.device)


def grf_1d_filter(xi: torch.Tensor, grid: SpectralGrid1D, alpha: float = 2.0,
                  tau: float = 5.0, sigma: float | None = None,
                  zero_mean: bool = True) -> torch.Tensor:
    """Filter white noise (..., n) into 1-D GRF samples of the same shape/dtype."""
    h = torch.as_tensor(grf_1d_spectrum_filter(grid, alpha, tau, sigma, zero_mean),
                        dtype=xi.dtype, device=xi.device)
    return torch.fft.irfft(torch.fft.rfft(xi) * h, n=grid.n).to(xi.dtype)


def grf_1d(generator: torch.Generator, grid: SpectralGrid1D, batch: int,
           alpha: float = 2.0, tau: float = 5.0, sigma: float | None = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(batch, n) 1-D GRF samples: ``draw_grf_1d_noise`` then ``grf_1d_filter``."""
    return grf_1d_filter(draw_grf_1d_noise(generator, batch, grid.n, dtype), grid, alpha,
                         tau, sigma)


def lognormal_grf_2d(xi: torch.Tensor, grid: SpectralGrid2D, alpha: float = 2.0,
                     tau: float = 3.0, sigma: float | None = None) -> torch.Tensor:
    """Lognormal permeability exp(GRF) from white noise (..., n, n): the
    Darcy coefficient."""
    return torch.exp(grf_filter(xi, grid, alpha, tau, sigma))


def piecewise_constant_grf_2d(xi: torch.Tensor, grid: SpectralGrid2D, hi: float = 12.0,
                              lo: float = 3.0, alpha: float = 2.0,
                              tau: float = 3.0) -> torch.Tensor:
    """Thresholded GRF from white noise: ``hi`` where the field is ≥ 0, else
    ``lo`` (the classic FNO Darcy coefficient)."""
    g = grf_filter(xi, grid, alpha, tau)
    return torch.where(g >= 0, torch.full_like(g, hi), torch.full_like(g, lo))
