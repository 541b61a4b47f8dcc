"""Config dataclasses and spectral grids, shared with the JAX package.

Both are numpy-only (``pregen_pde_tpu/__init__.py`` imports nothing but
``core``), so the port builds its constants from the very same objects.
"""

from pregen_pde_tpu.core.config import GRFConfig, NSVorticityConfig
from pregen_pde_tpu.core.grid import SpectralGrid1D, SpectralGrid2D

__all__ = ["GRFConfig", "NSVorticityConfig", "SpectralGrid1D", "SpectralGrid2D"]
