"""Plain reference of the spectral generator: the periodic grid's tables, the
GRF filter, the CN+AB2 pseudo-spectral vorticity stepper and the (u, v, p)
fields of a vorticity snapshot, in plain ``torch`` (``torch.fft``).

Copied from the port at commit 92d189c: ``core/grid.py`` (the full-layout
and rfft2 tables), ``fields/grf.py`` (``grf_spectrum_filter``,
``grf_filter``), ``solvers/spectral_ns.py`` (``fno_forcing``,
``_rhs_explicit_full``, ``_build_traj_packed(scheme="ab2")``,
``fields_from_vorticity``). One change, not in the arithmetic: the stepper
takes one step count per row (a row's state stops changing once its steps
are done). Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


class Grid:
    """Wavenumber tables of the periodic [0, length)² grid, float64 numpy;
    axis 0 is y (full FFT), axis 1 is x."""

    def __init__(self, n: int, length: float):
        self.n, self.length = n, length
        k_full = np.fft.fftfreq(n, d=length / n) * TWO_PI
        kd = k_full.copy()
        kd[n // 2] = 0.0  # odd-derivative convention: Nyquist zeroed
        self.kx_full_deriv = kd.reshape(1, n)
        self.ky_full_deriv = kd.reshape(n, 1).copy()
        self.k2_full = k_full.reshape(1, -1) ** 2 + k_full.reshape(-1, 1) ** 2
        k2 = self.k2_full.copy()
        k2[0, 0] = 1.0
        self.inv_k2_full = 1.0 / k2
        self.inv_k2_full[0, 0] = 0.0
        cutoff = (2.0 / 3.0) * (n // 2) * (TWO_PI / length)
        self.dealias_full = ((np.abs(k_full.reshape(-1, 1)) <= cutoff)
                             & (np.abs(k_full.reshape(1, -1)) <= cutoff)).astype(np.float32)
        # rfft2 layout
        ky = k_full.reshape(n, 1)
        kx = (np.fft.rfftfreq(n, d=length / n) * TWO_PI).reshape(1, n // 2 + 1)
        self.k2 = kx**2 + ky**2
        kx_d = kx.copy()
        kx_d[0, -1] = 0.0
        ky_d = ky.copy()
        ky_d[n // 2, 0] = 0.0
        self.kx_deriv, self.ky_deriv = kx_d, ky_d
        k2r = self.k2.copy()
        k2r[0, 0] = 1.0
        self.inv_k2 = 1.0 / k2r
        self.inv_k2[0, 0] = 0.0
        c = np.arange(n) * (length / n)
        self.x = np.stack(np.meshgrid(c, c, indexing="ij"), axis=0)


def grf_filter(xi: torch.Tensor, grid: Grid, alpha: float, tau: float,
               sigma: float | None = None) -> torch.Tensor:
    """GRF samples X = irfft2(rfft2(ξ)·h), h = n·σ·(|k|² + τ²)^(−α/2),
    h[0, 0] = 0, σ = τ^(α − 1) by default; in ξ's dtype."""
    n = grid.n
    if sigma is None:
        sigma = float(tau ** (0.5 * (2.0 * alpha - 2)))
    h = grid.n * sigma * (grid.k2 + tau**2) ** (-alpha / 2.0)
    h[0, 0] = 0.0
    h_t = torch.as_tensor(h, dtype=xi.dtype, device=xi.device)
    return torch.fft.irfft2(torch.fft.rfft2(xi) * h_t, s=(n, n)).to(xi.dtype)


def fno_forcing(grid: Grid, amplitude: float) -> np.ndarray:
    """f = A (sin 2π(x+y) + cos 2π(x+y))."""
    s = TWO_PI * (grid.x[0] + grid.x[1]) / grid.length
    return amplitude * (np.sin(s) + np.cos(s))


def trajectory(w0: torch.Tensor, nu: torch.Tensor, inner: np.ndarray, cfg: dict) -> torch.Tensor:
    """(B, n, n) initial vorticity, (B,) ν, (B,) steps a snapshot →
    (B, T, n, n) vorticity snapshots (T = n_snapshots + 1 with the initial
    frame). CN on ν|k|², AB2 on the advection (the history starts as
    rhs(ŵ0), so the first step is forward Euler, and it carries across
    snapshots), 2/3 dealiasing, the FNO forcing."""
    n = w0.shape[-1]
    grid = Grid(n, cfg["length"])
    dev, rdt = w0.device, w0.dtype
    c = lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=dev)
    kx, ky = c(grid.kx_full_deriv), c(grid.ky_full_deriv)
    inv_k2, dealias, k2 = c(grid.inv_k2_full), c(grid.dealias_full), c(grid.k2_full)
    dt = torch.tensor(cfg["dt"], dtype=rdt, device=dev)
    nu_k2 = nu.to(device=dev, dtype=rdt)[:, None, None] * k2
    visc_num = 1.0 - 0.5 * dt * nu_k2
    visc_den = 1.0 / (1.0 + 0.5 * dt * nu_k2)
    f_hat = None
    if cfg["forcing"] == "fno":
        f_hat = torch.fft.fft2(c(fno_forcing(grid, cfg["forcing_amplitude"])))
    elif cfg["forcing"] != "none":
        raise ValueError(f"forcing {cfg['forcing']!r} has no reference")
    drag = float(cfg["drag"])

    def rhs(wh):
        psi = wh * inv_k2
        uv = torch.fft.ifft2(1j * ky * psi + 1j * (-1j * kx * psi))
        wxy = torch.fft.ifft2(1j * kx * wh + 1j * (1j * ky * wh))
        adv_hat = torch.fft.fft2(uv.real * wxy.real + uv.imag * wxy.imag)
        if cfg["dealias"]:
            adv_hat = adv_hat * dealias
        out = -adv_hat
        if f_hat is not None:
            out = out + f_hat
        if drag != 0.0:
            out = out - drag * wh
        return out

    steps = torch.as_tensor(np.asarray(inner), device=dev)[:, None, None]
    w_hat = torch.fft.fft2(w0)
    nprev = rhs(w_hat)
    snaps = [w0] if cfg["include_initial"] else []
    for _ in range(cfg["n_snapshots"]):
        for k in range(int(np.max(inner))):
            n1 = rhs(w_hat)
            new = (w_hat * visc_num + dt * (1.5 * n1 - 0.5 * nprev)) * visc_den
            live = steps > k
            w_hat = torch.where(live, new, w_hat)
            nprev = torch.where(live, n1, nprev)
        snaps.append(torch.fft.ifft2(w_hat).real)
    return torch.stack(snaps, dim=1)


def fields(w: torch.Tensor, length: float) -> torch.Tensor:
    """Physical vorticity (..., n, n) → (..., n, n, 3) [u, v, p]: u = ∂y ψ,
    v = −∂x ψ, −Δψ = ω; Δp = 2(u_x v_y − u_y v_x)."""
    n = w.shape[-1]
    grid = Grid(n, length)
    c = lambda a: torch.as_tensor(np.asarray(a), dtype=w.dtype, device=w.device)
    kx, ky, inv_k2 = c(grid.kx_deriv), c(grid.ky_deriv), c(grid.inv_k2)
    w_hat = torch.fft.rfft2(w)
    psi_hat = w_hat * inv_k2
    u_hat, v_hat = 1j * ky * psi_hat, -1j * kx * psi_hat
    irf = lambda a: torch.fft.irfft2(a, s=(n, n))
    u, v = irf(u_hat), irf(v_hat)
    ux, uy = irf(1j * kx * u_hat), irf(1j * ky * u_hat)
    vx, vy = irf(1j * kx * v_hat), irf(1j * ky * v_hat)
    p = irf(-torch.fft.rfft2(2.0 * (ux * vy - uy * vx)) * inv_k2)
    return torch.stack([u, v, p], dim=-1)
