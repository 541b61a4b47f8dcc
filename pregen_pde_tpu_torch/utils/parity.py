"""numpy ↔ torch helpers and the per-snapshot relative-L2 metric.

Used by the parity tests (JAX outputs arrive as numpy arrays) and by
``chip_smoke.py``. Free of ``jax``.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device: str | torch.device = "cpu", dtype: torch.dtype | None = None):
    """numpy (or anything ``np.asarray`` takes) → tensor on ``device``."""
    t = torch.from_numpy(np.array(a, copy=True, order="C"))  # JAX arrays are read-only
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def rel_l2(got, ref) -> float:
    """‖got − ref‖₂ / ‖ref‖₂ over the whole array, in float64."""
    g = to_numpy(got).astype(np.float64)
    r = to_numpy(ref).astype(np.float64)
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-300))


def per_snapshot_rel_l2(got, ref) -> np.ndarray:
    """(B, T, ...) arrays → (T,) relative L2 per snapshot, worst over the batch."""
    g = to_numpy(got).astype(np.float64)
    r = to_numpy(ref).astype(np.float64)
    if g.shape != r.shape:
        raise ValueError(f"shape mismatch {g.shape} vs {r.shape}")
    b, t = g.shape[:2]
    num = np.linalg.norm((g - r).reshape(b, t, -1), axis=-1)
    den = np.maximum(np.linalg.norm(r.reshape(b, t, -1), axis=-1), 1e-300)
    return (num / den).max(axis=0)
