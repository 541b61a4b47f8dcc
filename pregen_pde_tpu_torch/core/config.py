"""Solver and field configurations (the port's copy of the JAX package's
``core/config.py`` dataclasses it uses; the same fields and defaults)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NSVorticityConfig:
    """2-D incompressible NS in vorticity form, pseudo-spectral. Defaults
    are the north-star workload: 256², ν = 1e-4, snapshots thinned to a
    fixed count (20 writes + the initial frame)."""

    resolution: int = 256
    viscosity: float = 1e-4
    length: float = 1.0
    dt: float = 1e-4
    t_end: float = 10.0
    n_snapshots: int = 20
    include_initial: bool = True
    forcing: str = "fno"  # "none" | "fno" | "kolmogorov"
    forcing_amplitude: float = 0.1
    forcing_wavenumber: int = 4  # only for kolmogorov
    drag: float = 0.0
    dealias: bool = True


@dataclasses.dataclass(frozen=True)
class GRFConfig:
    """Gaussian random field N(0, sigma^2 (-Δ + tau^2 I)^(-alpha))."""

    alpha: float = 2.5
    tau: float = 7.0
    sigma: float | None = None  # default: tau^(0.5*(2*alpha - d))


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    """1-D viscous Burgers: ν = 0.1, 1024-point spectral grid."""

    resolution: int = 1024
    viscosity: float = 0.1
    length: float = 1.0
    dt: float = 1e-4
    t_end: float = 1.0
    n_snapshots: int = 20
