"""Hole masks and their signed distance, frozen: the multi-hole sampler the
benchmark draws its masks with, and the SDF the reference checks the
contract's SDF channel against.

Copied from ``pregen_pde_tpu_torch/fields/geometry.py`` at commit 92d189c
(``box_mask``, ``_multi_lattice``, ``draw_multi_holes``,
``place_multi_holes``, ``_edt_sq``, ``sdf_from_mask``). Imports nothing of
the port and nothing of JAX. Mask convention: 1 = hole, 0 = fluid.
"""

from __future__ import annotations

import math

import torch

_INF = 1.0e12
EDT_CHUNK_BYTES = 1 << 30


def box_mask(n: int, row0, col0, height: int, width: int, device) -> torch.Tensor:
    """Axis-aligned boxes (1 inside); ``row0``/``col0`` integer tensors of a
    shape S → S + (n, n)."""
    r = torch.arange(n, device=device)
    r0 = torch.as_tensor(row0, device=device)
    c0 = torch.as_tensor(col0, device=device)
    r0, c0 = r0.reshape(*r0.shape, 1, 1), c0.reshape(*c0.shape, 1, 1)
    rows = (r[:, None] >= r0) & (r[:, None] < r0 + height)
    cols = (r[None, :] >= c0) & (r[None, :] < c0 + width)
    return (rows & cols).to(torch.float32)


def sample_multi_holes(generator: torch.Generator, batch: int, n: int, min_holes: int,
                       max_holes: int, hole_cells: int, max_attempts: int) -> torch.Tensor:
    """(batch, n, n) masks of min_holes..max_holes non-overlapping
    hole_cells² holes on a hole_cells/2 lattice with a one-step margin: a
    target count and max_attempts candidate corners per image, candidate a
    placed iff it overlaps no hole placed before it and fewer than the
    target are placed."""
    dev = generator.device
    step = hole_cells // 2
    margin = step
    n_slots = (n - hole_cells - 2 * margin) // step + 1
    rint = lambda lo, hi, shape: torch.randint(lo, hi + 1, shape, generator=generator,
                                               device=dev)
    target = rint(min_holes, max_holes, (batch,))
    rows = margin + rint(0, n_slots - 1, (batch, max_attempts)) * step
    cols = margin + rint(0, n_slots - 1, (batch, max_attempts)) * step
    mask = torch.zeros((batch, n, n), dtype=torch.float32, device=dev)
    placed = torch.zeros((batch,), dtype=torch.int64, device=dev)
    for a in range(max_attempts):
        cand = box_mask(n, rows[:, a], cols[:, a], hole_cells, hole_cells, dev)
        overlaps = ((cand > 0) & (mask > 0)).flatten(1).any(dim=1)
        accept = ~overlaps & (placed < target)
        mask = torch.where(accept[:, None, None], torch.maximum(mask, cand), mask)
        placed = placed + accept.to(torch.int64)
    return mask


def _edt_sq(zero_set: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance to the nearest True pixel (b, n, n)."""
    _, n_r, n_c = zero_set.shape
    dev = zero_set.device
    rows = torch.arange(n_r, dtype=torch.float32, device=dev)
    d_rr = (rows[:, None] - rows[None, :]) ** 2
    blocked = torch.where(zero_set, 0.0, _INF)
    g = torch.amin(d_rr[None, :, :, None] + blocked[:, None, :, :], dim=2)
    cols = torch.arange(n_c, dtype=torch.float32, device=dev)
    d_cc = (cols[:, None] - cols[None, :]) ** 2
    return torch.amin(g[:, :, None, :] + d_cc.T[None, None, :, :], dim=3)


def sdf_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """Signed distance of (..., n, n) masks, positive in fluid, negative in
    holes, each image divided by its own max |sdf| (the all-fluid mask gives
    1.0 everywhere)."""
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
        sdf = sdf / torch.clamp(sdf.abs().amax(dim=(-2, -1), keepdim=True), min=1e-6)
        parts.append(sdf)
    return torch.cat(parts).reshape(*lead, n_r, n_c)
