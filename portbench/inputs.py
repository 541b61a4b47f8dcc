"""Input draws shared by the drivers.

Each batch's Re normals are the B midpoint quantiles of N(0, 1),
Φ⁻¹((i + ½)/B), in an order drawn from the seed: every batch of every seed
holds the same set of Reynolds numbers, and so the same set of horizons and
step counts, spread over its rows differently. The work of a window is then
the same from seed to seed, while the fields (ξ, the holes) and which row
gets which horizon change with it. The marginal law of a row is
the generator's N(mean, std²) before the clip.
"""

from __future__ import annotations

import numpy as np
import torch


def stratified_normals(generator: torch.Generator, batches: int, batch: int) -> torch.Tensor:
    """(batches, batch) float64 on the generator's device."""
    dev = generator.device
    q = (torch.arange(batch, dtype=torch.float64, device=dev) + 0.5) / batch
    z = torch.special.ndtri(q)
    perm = torch.stack([torch.randperm(batch, generator=generator, device=dev)
                        for _ in range(batches)])
    return z[perm]


def kept_rows(seed: int, b: int, steps: np.ndarray, per_batch: int) -> np.ndarray:
    """The rows of window batch ``b`` that the check compares: the row with
    the most steps, and ``per_batch − 1`` others drawn from the seed."""
    longest = int(np.argmax(steps))
    others = np.delete(np.arange(len(steps)), longest)
    rng = np.random.default_rng([seed, b])
    pick = rng.choice(others, size=min(per_batch - 1, len(others)), replace=False)
    return np.sort(np.concatenate([[longest], pick]).astype(np.int64))


def rel_l2(a: torch.Tensor, ref: torch.Tensor, dims) -> torch.Tensor:
    """‖a − ref‖₂ / ‖ref‖₂ over ``dims`` (0/0 reads 0, x/0 reads inf)."""
    num = torch.linalg.vector_norm((a - ref).to(torch.float64), dim=dims)
    den = torch.linalg.vector_norm(ref.to(torch.float64), dim=dims)
    return torch.where(num == 0, torch.zeros_like(num), num / den)
