"""Relative-position-bias expansion (counterpart of ``ops/cpb_bias.py``).

Swin-V2's continuous position bias indexes a ((2w-1)^2, h) CPB table with
a static (n^2,)-index map (n = w^2 tokens per window) to build the per-head
(h, n, n) attention bias. The port has the gather forward; the JAX
package's closed-form Toeplitz adjoint comes with training.
"""

from __future__ import annotations

import numpy as np
import torch


def rel_index(ws: int) -> np.ndarray:
    """Static (n^2,) map token pair -> flat (2w-1)^2 relative offset
    (row-major), the reference's relative_position_index."""
    ci = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"), 0).reshape(2, -1)
    rel = ci[:, :, None] - ci[:, None, :] + (ws - 1)  # (2, n, n)
    return (rel[0] * (2 * ws - 1) + rel[1]).reshape(-1)


def relative_position_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """((2w-1)^2, h) CPB table -> (n^2, h) bias rows, n = w^2."""
    return table[torch.as_tensor(rel_index(ws), device=table.device)]
