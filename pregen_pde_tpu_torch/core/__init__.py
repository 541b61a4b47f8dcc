"""Config dataclasses and spectral grids (numpy only): the port's own copy
of what it uses from the JAX package's ``core``."""

from pregen_pde_tpu_torch.core.config import BurgersConfig, GRFConfig, NSVorticityConfig
from pregen_pde_tpu_torch.core.grid import SpectralGrid1D, SpectralGrid2D

__all__ = ["BurgersConfig", "GRFConfig", "NSVorticityConfig", "SpectralGrid1D", "SpectralGrid2D"]
