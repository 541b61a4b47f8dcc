"""Obstacle geometry: box and disk masks, hole samplers and the mask → SDF
construction (port of ``fields/geometry.py``).

Each hole sampler is split into a draw and a placement. The draw takes an
explicit ``torch.Generator`` and makes the integer hole count and positions;
the placement (``place_*``) is a pure function of them, so a test can feed
it the positions ``jax.random`` drew and compare masks exactly:

- ``draw_single_hole`` / ``place_single_hole``: one hole_size² hole, integer
  centre uniform in [12, n−8] per axis (``geometry.py:88-95``);
- ``draw_multi_holes`` / ``place_multi_holes``: 2..max_holes non-overlapping
  hole_cells² holes on a hole_cells/2 lattice with a one-step margin, by the
  bounded acceptance scan over ``max_attempts`` candidates
  (``geometry.py:98-141``);
- ``draw_multi_holes_overlap`` / ``place_multi_holes_overlap``: every hole
  covers a common central sub-box (``geometry.py:144-197``).

``sdf_from_mask`` is batched over ``(..., n, n)`` and runs the exact O(n³)
two-phase EDT on the masks' device in chunks of images, so that its
``(b, n, n, n)`` intermediate stays under ``EDT_CHUNK_BYTES``.

Mask convention: 1 = hole/obstacle, 0 = fluid.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

_INF = 1.0e12
# bound of the EDT's (b, n, n, n) float32 intermediate per chunk of images
EDT_CHUNK_BYTES = 1 << 30


def _edt_sq(zero_set: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance from every pixel to the nearest True
    pixel of ``zero_set`` (b, n, n) (+INF-ish where none): d²(i,j) =
    min_j' [g(i,j') + (j−j')²], g(i,j') = min_{i': zero(i',j')} (i−i')².
    Dense (b, n, n, n) min reductions, O(n³) flops per image."""
    _, n_r, n_c = zero_set.shape
    dev = zero_set.device
    rows = torch.arange(n_r, dtype=torch.float32, device=dev)
    d_rr = (rows[:, None] - rows[None, :]) ** 2
    blocked = torch.where(zero_set, 0.0, _INF)
    g = torch.amin(d_rr[None, :, :, None] + blocked[:, None, :, :], dim=2)
    cols = torch.arange(n_c, dtype=torch.float32, device=dev)
    d_cc = (cols[:, None] - cols[None, :]) ** 2
    return torch.amin(g[:, :, None, :] + d_cc.T[None, None, :, :], dim=3)


def sdf_from_mask(mask: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Signed distance of (..., n, n) masks: positive in fluid, negative in
    holes, each image normalised by its own max |sdf|. The all-fluid mask
    yields a constant 1.0."""
    mask = mask.to(torch.float32)
    lead, (n_r, n_c) = mask.shape[:-2], mask.shape[-2:]
    flat = mask.reshape(-1, n_r, n_c)
    chunk = max(1, EDT_CHUNK_BYTES // (4 * n_r * n_r * n_c))
    cap = math.sqrt(2.0) * n_r
    parts = []
    for m in flat.split(chunk):
        is_hole = m > 0.5
        outside = torch.clamp(torch.sqrt(_edt_sq(is_hole)), max=cap)
        inside = torch.clamp(torch.sqrt(_edt_sq(~is_hole)), max=cap)
        sdf = outside - inside
        if normalize:
            sdf = sdf / torch.clamp(sdf.abs().amax(dim=(-2, -1), keepdim=True), min=1e-6)
        parts.append(sdf)
    return torch.cat(parts).reshape(*lead, n_r, n_c)


def _lead(x, device) -> torch.Tensor:
    """A scalar or tensor argument as a tensor with two trailing unit axes."""
    t = torch.as_tensor(x, device=device)
    return t.reshape(*t.shape, 1, 1)


def box_mask(n: int, row0, col0, height, width,
             device: str | torch.device = "cpu") -> torch.Tensor:
    """Axis-aligned box obstacle (1 inside). ``row0``/``col0`` may be ints or
    integer tensors of a shape S; the result is S + (n, n)."""
    r = torch.arange(n, device=device)
    r0, c0 = _lead(row0, device), _lead(col0, device)
    rows = (r[:, None] >= r0) & (r[:, None] < r0 + height)
    cols = (r[None, :] >= c0) & (r[None, :] < c0 + width)
    return (rows & cols).to(torch.float32)


def disk_mask(n: int, row_c, col_c, radius,
              device: str | torch.device = "cpu") -> torch.Tensor:
    """Disk obstacle (the FPO cylinder analogue on the regular grid),
    computed in float32 as the JAX package does."""
    r = torch.arange(n, dtype=torch.float32, device=device)
    d2 = (r[:, None] - row_c) ** 2 + (r[None, :] - col_c) ** 2
    return (d2 <= radius**2).to(torch.float32)


def no_hole_mask(n: int = 128, device: str | torch.device = "cpu") -> torch.Tensor:
    """The 'easy' geometry: all fluid."""
    return torch.zeros((n, n), dtype=torch.float32, device=device)


@lru_cache(maxsize=8)
def no_hole_mask_and_sdf(n: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, sdf) of the no-hole geometry, built once per (n, device) and
    shared read-only by every bucket."""
    mask = no_hole_mask(n, device)
    return mask, sdf_from_mask(mask)


def _randint(generator: torch.Generator, lo: int, hi_incl: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi_incl + 1, shape, generator=generator,
                         device=generator.device)


# -- one hole -------------------------------------------------------------------

def draw_single_hole(generator: torch.Generator, batch: int,
                     n: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """(row centres, column centres), each (batch,) uniform in [12, n−8]."""
    lo, hi = 12, n - 8
    return (_randint(generator, lo, hi, (batch,)), _randint(generator, lo, hi, (batch,)))


def place_single_hole(n: int, row_c: torch.Tensor, col_c: torch.Tensor,
                      hole_size: int = 16) -> torch.Tensor:
    """(batch, n, n) masks of one hole_size² hole centred at each (row, col)."""
    h = hole_size // 2
    return box_mask(n, row_c - h, col_c - h, hole_size, hole_size, row_c.device)


def sample_single_hole(generator: torch.Generator, batch: int, n: int = 128,
                       hole_size: int = 16) -> torch.Tensor:
    return place_single_hole(n, *draw_single_hole(generator, batch, n), hole_size)


# -- several non-overlapping holes ------------------------------------------------

def _multi_lattice(n: int, hole_cells: int) -> tuple[int, int, int]:
    """(step, margin, n_slots) of the hole_cells/2 lattice with a one-step
    margin from every boundary (the reference's randomize_holes margin)."""
    step = hole_cells // 2
    margin = step
    return step, margin, (n - hole_cells - 2 * margin) // step + 1


def draw_multi_holes(generator: torch.Generator, batch: int, n: int = 128,
                     min_holes: int = 2, max_holes: int = 10, hole_cells: int = 16,
                     max_attempts: int = 32):
    """(target counts (batch,), candidate rows (batch, max_attempts),
    candidate columns (batch, max_attempts)): lower-left lattice corners."""
    step, margin, n_slots = _multi_lattice(n, hole_cells)
    target = _randint(generator, min_holes, max_holes, (batch,))
    rows = margin + _randint(generator, 0, n_slots - 1, (batch, max_attempts)) * step
    cols = margin + _randint(generator, 0, n_slots - 1, (batch, max_attempts)) * step
    return target, rows, cols


def place_multi_holes(n: int, target: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor, hole_cells: int = 16):
    """The acceptance scan: candidate a is placed iff it overlaps no hole
    placed before it and fewer than ``target`` are placed. → (masks (batch,
    n, n), placed (batch,))."""
    batch, attempts = rows.shape
    dev = rows.device
    mask = torch.zeros((batch, n, n), dtype=torch.float32, device=dev)
    placed = torch.zeros((batch,), dtype=torch.int64, device=dev)
    for a in range(attempts):
        cand = box_mask(n, rows[:, a], cols[:, a], hole_cells, hole_cells, dev)
        overlaps = ((cand > 0) & (mask > 0)).flatten(1).any(dim=1)
        accept = ~overlaps & (placed < target)
        mask = torch.where(accept[:, None, None], torch.maximum(mask, cand), mask)
        placed = placed + accept.to(torch.int64)
    return mask, placed


def sample_multi_holes(generator: torch.Generator, batch: int, n: int = 128,
                       min_holes: int = 2, max_holes: int = 10, hole_cells: int = 16,
                       max_attempts: int = 32):
    draws = draw_multi_holes(generator, batch, n, min_holes, max_holes, hole_cells,
                             max_attempts)
    return place_multi_holes(n, *draws, hole_cells)


# -- forced overlap -----------------------------------------------------------------

def _overlap_range(n: int, hole_cells: int, overlap_fraction: float) -> tuple[int, int]:
    """[lo, hi] of the lower-left corners whose hole covers the common central
    sub-box of side overlap_fraction·hole (clamped to a one-cell margin)."""
    if overlap_fraction <= 0:
        raise ValueError("overlap_fraction must be > 0 (reference :1085-1088)")
    box = overlap_fraction * hole_cells
    c = n / 2.0
    lo = max(1, math.ceil(c + box / 2.0 - hole_cells))
    hi = min(n - hole_cells - 1, math.floor(c - box / 2.0))
    if lo > hi:
        raise ValueError("cannot place holes sharing a sub-region; reduce "
                         "overlap_fraction (reference :1113-1117)")
    return lo, hi


def draw_multi_holes_overlap(generator: torch.Generator, batch: int, n: int = 128,
                             min_holes: int = 2, max_holes: int = 10,
                             hole_cells: int = 16, overlap_fraction: float = 0.3):
    """(target counts (batch,), rows (batch, max_holes), cols (batch,
    max_holes)), corners uniform in the range that covers the common box."""
    lo, hi = _overlap_range(n, hole_cells, overlap_fraction)
    target = _randint(generator, min_holes, max_holes, (batch,))
    rows = _randint(generator, lo, hi, (batch, max_holes))
    cols = _randint(generator, lo, hi, (batch, max_holes))
    return target, rows, cols


def place_multi_holes_overlap(n: int, target: torch.Tensor, rows: torch.Tensor,
                              cols: torch.Tensor, hole_cells: int = 16):
    """Holes i < target, unioned. → (masks (batch, n, n), placed (batch,))."""
    batch, max_holes = rows.shape
    dev = rows.device
    mask = torch.zeros((batch, n, n), dtype=torch.float32, device=dev)
    placed = torch.zeros((batch,), dtype=torch.int64, device=dev)
    for i in range(max_holes):
        cand = box_mask(n, rows[:, i], cols[:, i], hole_cells, hole_cells, dev)
        accept = i < target
        mask = torch.where(accept[:, None, None], torch.maximum(mask, cand), mask)
        placed = placed + accept.to(torch.int64)
    return mask, placed


def sample_multi_holes_overlap(generator: torch.Generator, batch: int, n: int = 128,
                               min_holes: int = 2, max_holes: int = 10,
                               hole_cells: int = 16, overlap_fraction: float = 0.3):
    draws = draw_multi_holes_overlap(generator, batch, n, min_holes, max_holes,
                                     hole_cells, overlap_fraction)
    return place_multi_holes_overlap(n, *draws, hole_cells)
