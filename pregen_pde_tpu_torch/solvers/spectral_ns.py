"""Pseudo-spectral 2-D incompressible Navier–Stokes in vorticity form
(port of ``solvers/spectral_ns.py``), on ``torch.fft``.

    dω/dt + u·∇ω = ν Δω + f − μ ω,    u = (∂y ψ, −∂x ψ),   −Δψ = ω

on the periodic [0, L)². Axis 0 is y (full-FFT axis), axis 1 is x.

Everything here is dtype-polymorphic (float32/complex64 and
float64/complex128) and acts on any leading batch shape ``(..., n, n)``:
where the JAX package ``vmap``s a single-trajectory function, the batch
dimension is written out. ``_build_traj_packed(scheme="ab2")`` is the plain
PyTorch version of the CUDA CN+AB2 kernel (``spectral_ns_cuda``). The rfft2
``cn_heun`` / ``cn_euler`` steppers are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pregen_pde_tpu_torch.core import NSVorticityConfig, SpectralGrid2D
from pregen_pde_tpu_torch.utils.device import real_dtype as _real_dtype

# hand-written CUDA CN+AB2 stepper variants -> precision tier
CUDA_METHODS = {
    "cn_ab2_cuda": "fast",
    "cn_ab2_cuda_high": "high",
    "cn_ab2_cuda_exact": "exact",
}
PACKED_SCHEMES = {"cn_ab2_packed": "ab2", "cn_heun_packed": "heun"}


def fno_forcing(grid: SpectralGrid2D, amplitude: float = 0.1) -> np.ndarray:
    """f = A (sin 2π(x+y) + cos 2π(x+y)), the FNO-dataset forcing."""
    s = 2.0 * np.pi * (grid.x[0] + grid.x[1]) / grid.length
    return amplitude * (np.sin(s) + np.cos(s))


def kolmogorov_forcing(grid: SpectralGrid2D, wavenumber: int = 4,
                       amplitude: float = 1.0) -> np.ndarray:
    """Curl of A sin(k y) x̂ → −A k cos(k y); axis 0 is y."""
    k = 2.0 * np.pi * wavenumber / grid.length
    return -amplitude * k * np.cos(k * grid.x[0])


def make_forcing(cfg: NSVorticityConfig, grid: SpectralGrid2D) -> np.ndarray | None:
    if cfg.forcing == "none":
        return None
    if cfg.forcing == "fno":
        return fno_forcing(grid, cfg.forcing_amplitude)
    if cfg.forcing == "kolmogorov":
        return kolmogorov_forcing(grid, cfg.forcing_wavenumber, cfg.forcing_amplitude)
    raise ValueError(f"unknown forcing {cfg.forcing!r}")


def constants(grid: SpectralGrid2D, dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Full-fft-layout spectral constants in ``dtype`` on ``device``.

    ``kx``/``ky`` are the Nyquist-zeroed derivative wavenumbers (they keep the
    packed spectra Hermitian); ``k2`` is the TRUE |k|² including Nyquist, used
    only by the Crank–Nicolson factors; ``inv_k2`` is 1/|k|² with the zero mode
    zeroed; ``dealias`` the 2/3-rule mask."""
    c = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return {
        "kx": c(grid.kx_full_deriv),
        "ky": c(grid.ky_full_deriv),
        "inv_k2": c(grid.inv_k2_full),
        "dealias": c(grid.dealias_mask_full),
        "k2": c(grid.k2_full),
    }


def forcing_hat(cfg: NSVorticityConfig, grid: SpectralGrid2D, dtype: torch.dtype,
                device: str | torch.device) -> torch.Tensor | None:
    """fft2 of the forcing, computed in ``dtype`` (as the JAX path does)."""
    forcing = make_forcing(cfg, grid)
    if forcing is None:
        return None
    return torch.fft.fft2(torch.as_tensor(forcing, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class NSVorticitySolver:
    """Functional solver. State convention of the rfft2 helpers: ``w_hat``
    complex, shape (..., n, n//2+1); the packed path keeps full fft2 layout."""

    cfg: NSVorticityConfig

    @property
    def grid(self) -> SpectralGrid2D:
        return SpectralGrid2D(self.cfg.resolution, self.cfg.length)

    # -- spectral operators (rfft2 layout) ------------------------------------

    def _consts(self, dtype, device):
        g = self.grid
        c = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return c(g.kx_deriv), c(g.ky_deriv), c(g.inv_k2), c(g.dealias_mask)

    def velocity_hat(self, w_hat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(û, v̂) via the streamfunction: ψ̂ = ŵ/|k|², u = ∂y ψ, v = −∂x ψ."""
        kx, ky, inv_k2, _ = self._consts(_real_dtype(w_hat.dtype), w_hat.device)
        psi_hat = w_hat * inv_k2
        return 1j * ky * psi_hat, -1j * kx * psi_hat

    def velocity(self, w_hat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        n = self.grid.n
        u_hat, v_hat = self.velocity_hat(w_hat)
        return torch.fft.irfft2(u_hat, s=(n, n)), torch.fft.irfft2(v_hat, s=(n, n))

    def pressure(self, w_hat: torch.Tensor) -> torch.Tensor:
        """Δp = 2(u_x v_y − u_y v_x) → p̂ = −rhŝ/|k|²."""
        n = self.grid.n
        kx, ky, inv_k2, _ = self._consts(_real_dtype(w_hat.dtype), w_hat.device)
        u_hat, v_hat = self.velocity_hat(w_hat)
        ux = torch.fft.irfft2(1j * kx * u_hat, s=(n, n))
        uy = torch.fft.irfft2(1j * ky * u_hat, s=(n, n))
        vx = torch.fft.irfft2(1j * kx * v_hat, s=(n, n))
        vy = torch.fft.irfft2(1j * ky * v_hat, s=(n, n))
        rhs = 2.0 * (ux * vy - uy * vx)
        p_hat = -torch.fft.rfft2(rhs) * inv_k2
        return torch.fft.irfft2(p_hat, s=(n, n))

    def fields_from_vorticity(self, w: torch.Tensor) -> dict[str, torch.Tensor]:
        """Physical (u, v, p) from physical vorticity (..., n, n)."""
        w_hat = torch.fft.rfft2(w)
        u, v = self.velocity(w_hat)
        return {"u": u, "v": v, "p": self.pressure(w_hat), "w": w}

    # -- packed-FFT path (full fft2 layout) -----------------------------------
    # ifft2(A + iB) = a + ib for Hermitian A, B: (u, v) in one inverse, (ω_x,
    # ω_y) in another, one forward fft2 of the advection product.

    def _rhs_explicit_full(self, w_hat, f_hat, kx, ky, inv_k2, dealias):
        psi = w_hat * inv_k2
        uv = torch.fft.ifft2(1j * ky * psi + 1j * (-1j * kx * psi))
        u, v = uv.real, uv.imag
        wxy = torch.fft.ifft2(1j * kx * w_hat + 1j * (1j * ky * w_hat))
        wx, wy = wxy.real, wxy.imag
        adv_hat = torch.fft.fft2(u * wx + v * wy)
        if self.cfg.dealias:
            adv_hat = adv_hat * dealias
        out = -adv_hat
        if f_hat is not None:
            out = out + f_hat
        if self.cfg.drag != 0.0:
            out = out - self.cfg.drag * w_hat
        return out

    def default_inner_steps(self) -> int:
        total_steps = int(round(self.cfg.t_end / self.cfg.dt))
        return max(total_steps // self.cfg.n_snapshots, 1)

    def _build_traj_packed(self, inner_steps: int | None = None, scheme: str = "heun"):
        """``traj(w0 (..., n, n), nu=None, inner_steps=None) -> (..., T, n, n)``.

        ``nu`` is None (cfg.viscosity), a float, or a tensor of the batch
        shape ``w0.shape[:-2]`` (one viscosity per trajectory).

        ``scheme``: "heun" (CN + RK2, 2 RHS evaluations a step) or "ab2"
        (CN + Adams–Bashforth-2, 1 evaluation a step; the history starts as
        rhs(ŵ0), so the first step is exactly forward Euler, and it carries
        across snapshot intervals)."""
        if scheme not in ("heun", "ab2"):
            raise ValueError(f"unknown packed scheme {scheme!r}")
        cfg = self.cfg
        grid = self.grid
        default_inner = self.default_inner_steps() if inner_steps is None else inner_steps

        def traj(w0: torch.Tensor, nu=None, inner_steps=None) -> torch.Tensor:
            steps = int(default_inner if inner_steps is None else inner_steps)
            rdt = w0.dtype
            dev = w0.device
            dt = torch.tensor(cfg.dt, dtype=rdt, device=dev)
            c = constants(grid, rdt, dev)
            kx, ky, inv_k2, dealias = c["kx"], c["ky"], c["inv_k2"], c["dealias"]
            nu_v = torch.as_tensor(cfg.viscosity if nu is None else nu, dtype=rdt,
                                   device=dev)
            nu_k2 = nu_v[..., None, None] * c["k2"]
            visc_num = 1.0 - 0.5 * dt * nu_k2
            visc_den = 1.0 / (1.0 + 0.5 * dt * nu_k2)
            f_hat = forcing_hat(cfg, grid, rdt, dev)
            w_hat = torch.fft.fft2(w0)

            def rhs(wh):
                return self._rhs_explicit_full(wh, f_hat, kx, ky, inv_k2, dealias)

            snaps = []
            if scheme == "heun":
                for _ in range(cfg.n_snapshots):
                    for _ in range(steps):
                        n1 = rhs(w_hat)
                        pred = (w_hat * visc_num + dt * n1) * visc_den
                        n2 = rhs(pred)
                        w_hat = (w_hat * visc_num + 0.5 * dt * (n1 + n2)) * visc_den
                    snaps.append(torch.fft.ifft2(w_hat).real)
            else:
                nprev = rhs(w_hat)
                for _ in range(cfg.n_snapshots):
                    for _ in range(steps):
                        n1 = rhs(w_hat)
                        w_hat = (w_hat * visc_num
                                 + dt * (1.5 * n1 - 0.5 * nprev)) * visc_den
                        nprev = n1
                    snaps.append(torch.fft.ifft2(w_hat).real)
            out = torch.stack(snaps, dim=-3)
            if cfg.include_initial:
                out = torch.cat([w0.unsqueeze(-3), out], dim=-3)
            return out

        return traj

    def make_trajectory_fn_nu(self, method: str = "cn_ab2_packed",
                              inner_steps: int | None = None):
        """``traj(w0, nu, inner_steps=None)``; the packed steppers are batched
        over any leading dims, so this also serves batches."""
        if method in PACKED_SCHEMES:
            return self._build_traj_packed(inner_steps, scheme=PACKED_SCHEMES[method])
        raise NotImplementedError(
            f"method {method!r} is not ported; use one of {sorted(PACKED_SCHEMES)}"
        )

    def make_batched_trajectory_fn_nu(self, method: str = "cn_ab2_packed",
                                      inner_steps: int | None = None):
        """(B, n, n) ICs and (B,) viscosities → (B, T, n, n). The CUDA methods
        run the hand-written CN+AB2 kernel (``spectral_ns_cuda``)."""
        if method in CUDA_METHODS:
            from pregen_pde_tpu_torch.solvers.spectral_ns_cuda import build_batched_traj

            return build_batched_traj(self, inner_steps, precision=CUDA_METHODS[method])
        return self.make_trajectory_fn_nu(method, inner_steps)


def cfl_dt(solver: NSVorticitySolver, w0: torch.Tensor, safety: float = 0.5) -> float:
    """Advisory CFL bound (host-side helper)."""
    u, v = solver.velocity(torch.fft.rfft2(w0))
    umax = float(torch.sqrt(u**2 + v**2).max())
    dx = solver.cfg.length / solver.cfg.resolution
    return safety * dx / max(umax, 1e-12)
