"""2-D steady Darcy flow (port of ``solvers/darcy.py``):

    −∇·(a ∇u) = f  on the unit square, u = 0 on ∂Ω,

on an n² interior grid with dx = L/(n+1). Matrix-free Jacobi-preconditioned
conjugate gradients with a fixed trip count (``cg_iters``, no early exit;
``tol`` is unused, as in the JAX solver), batched over (B, n, n): every dot
product is per sample, so no reduction mixes the samples of a batch. The
operator is a 5-point flux stencil with arithmetic face averages of ``a``
(boundary faces replicate the edge cell) and zero Dirichlet ghosts for u.
The JAX package runs this as a ``fori_loop`` outside any kernel, so it
stays plain PyTorch here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DarcyConfig:
    """Same fields and defaults as the JAX package's ``DarcyConfig``."""

    resolution: int = 128  # interior grid
    length: float = 1.0
    source: float = 1.0  # constant f (classic FNO Darcy: f ≡ 1)
    cg_iters: int = 500
    tol: float = 1e-8


def _shift_edge(a: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """``a`` shifted by one cell along ``axis`` (0 = rows, 1 = columns of the
    trailing (n, n)), the vacated edge replicating the boundary cell."""
    dim = a.ndim - 2 + axis
    n = a.shape[dim]
    if direction > 0:
        return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim=dim)
    return torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim=dim)


def _face_coeffs(a: torch.Tensor):
    """Arithmetic face averages (east, west, north, south)."""
    ax_e = 0.5 * (a + _shift_edge(a, 1, +1))
    ax_w = 0.5 * (a + _shift_edge(a, 1, -1))
    ay_n = 0.5 * (a + _shift_edge(a, 0, +1))
    ay_s = 0.5 * (a + _shift_edge(a, 0, -1))
    return ax_e, ax_w, ay_n, ay_s


def make_operator(a: torch.Tensor, dx: float):
    """(A, diag): A(u) = −∇·(a∇u) with zero Dirichlet ghosts, on (..., n, n)."""
    ax_e, ax_w, ay_n, ay_s = _face_coeffs(a)
    inv_dx2 = 1.0 / (dx * dx)

    def A(u: torch.Tensor) -> torch.Tensor:
        u_e = F.pad(u, (0, 1))[..., :, 1:]  # east neighbour (0 at the boundary)
        u_w = F.pad(u, (1, 0))[..., :, :-1]
        u_n = F.pad(u, (0, 0, 0, 1))[..., 1:, :]
        u_s = F.pad(u, (0, 0, 1, 0))[..., :-1, :]
        flux = (
            ax_e * (u_e - u) - ax_w * (u - u_w)
            + ay_n * (u_n - u) - ay_s * (u - u_s)
        )
        return -flux * inv_dx2

    diag = (ax_e + ax_w + ay_n + ay_s) * inv_dx2
    return A, diag


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample dot product over the trailing (n, n), kept broadcastable."""
    return (x * y).sum(dim=(-2, -1), keepdim=True)


def solve_darcy(a: torch.Tensor, cfg: DarcyConfig) -> torch.Tensor:
    """Solve for u given coefficient fields a, (B, n, n) or (n, n)."""
    n = cfg.resolution
    if tuple(a.shape[-2:]) != (n, n):
        raise ValueError(f"a must be (..., {n}, {n}), got {tuple(a.shape)}")
    dx = cfg.length / (n + 1)
    A, diag = make_operator(a, dx)
    f = torch.full_like(a, cfg.source)
    minv = 1.0 / diag
    u = torch.zeros_like(f)
    r = f
    z = minv * r
    p = z
    rz = _dot(r, z)
    for _ in range(cfg.cg_iters):
        Ap = A(p)
        alpha = rz / (_dot(p, Ap) + 1e-30)
        u = u + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz_new = _dot(r, z)
        beta = rz_new / (rz + 1e-30)
        p = z + beta * p
        rz = rz_new
    return u


def residual_norm(a: torch.Tensor, u: torch.Tensor, cfg: DarcyConfig) -> torch.Tensor:
    """‖A(u) − f‖ / ‖f‖ per sample: shape a.shape[:-2]."""
    n = cfg.resolution
    A, _ = make_operator(a, cfg.length / (n + 1))
    f = torch.full_like(a, cfg.source)
    return (torch.linalg.vector_norm(A(u) - f, dim=(-2, -1))
            / torch.linalg.vector_norm(f, dim=(-2, -1)))
