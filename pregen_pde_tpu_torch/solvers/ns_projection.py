"""Masked-geometry incompressible Navier–Stokes on a regular grid (port of
``solvers/ns_projection.py``): the Brinkman-penalised Chorin projection
solver behind the FPO (channel) and LDC (cavity) generators,

    u_t + (u·∇)u = −∇p + ν Δu − (χ/η) u,     ∇·u = 0,

one step = explicit advection (MUSCL, upwind2 or upwind1) + central
diffusion → implicit penalisation u/(1 + dt·χ/η) → boundary conditions →
pressure Poisson (the exact DCT eigen solve, or Jacobi-CG) → correction →
boundary conditions → penalisation.

Everything here is natively batched: a field is ``(..., n, n)`` with axis −2
= y and axis −1 = x, and ``u_max`` is a scalar or one value per image. This
module is the plain PyTorch version of the hand-written CUDA stepper
(``ns_projection_cuda``); ``constants`` is the record of the constants that
stepper reads.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """Same fields and defaults as the JAX package's ``ProjectionConfig``."""

    resolution: int = 128
    length: float = 2.0  # reference L = 2 m
    viscosity: float = 1.5e-5  # reference ν
    domain: str = "channel"  # "channel" | "cavity"
    u_max: float = 1.0  # inlet peak / lid speed (set from Re upstream)
    dt: float = 1e-3
    t_end: float = 1.0
    n_snapshots: int = 20
    penalization_eta: float = 1e-3  # Brinkman permeability
    pressure_solver: str = "direct"  # "direct" (DCT eigen solve) | "cg"
    cg_iters: int = 200
    advection: str = "muscl"  # "muscl" | "upwind2" | "upwind1"


def parabolic_inlet(n: int, u_max: float) -> np.ndarray:
    """u(y) = 4·Umax·y(H−y)/H² on cell centres, float32."""
    y = (np.arange(n) + 0.5) / n
    return (4.0 * u_max * y * (1.0 - y)).astype(np.float32)


@lru_cache(maxsize=8)
def eigen_basis(n: int, domain: str):
    """Orthonormal cosine bases of −D∘G, built in float64: (cy, ly, cx, lx),
    rows of cy/cx = eigenvectors along y/x, l = eigenvalues × dx². DCT-II
    along every Neumann axis; DCT-IV along the channel's x axis (Neumann
    inlet, Dirichlet outlet)."""
    j = np.arange(n)
    c2 = np.cos(np.pi * j[:, None] * (j[None, :] + 0.5) / n) * np.sqrt(2.0 / n)
    c2[0] *= np.sqrt(0.5)
    lam2 = 2.0 - 2.0 * np.cos(np.pi * j / n)
    if domain == "channel":
        c4 = np.cos(np.pi * (j[:, None] + 0.5) * (j[None, :] + 0.5) / n) * np.sqrt(2.0 / n)
        lam4 = 2.0 - 2.0 * np.cos(np.pi * (j + 0.5) / n)
        return c2, lam2, c4, lam4
    return c2, lam2, c2, lam2


@lru_cache(maxsize=16)
def _constants(n: int, domain: str, length: float, dtype: torch.dtype,
               device: str) -> dict:
    cy, ly, cx, lx = eigen_basis(n, domain)
    dx = length / n
    denom = (ly[:, None] + lx[None, :]) / (dx * dx)
    if domain == "cavity":
        denom = denom.copy()
        denom[0, 0] = 1.0  # the zero mode is set to 0 after the division
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    return {"cy": t(cy), "cyT": t(cy.T), "cx": t(cx), "cxT": t(cx.T), "denom": t(denom),
            "inlet": t(parabolic_inlet(n, 1.0))}


def constants(solver: "ProjectionSolver", dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cpu") -> dict:
    """The pressure solve's and the BCs' constants, built in float64 and cast
    once: the bases ``cy``, ``cx`` and their transposes, ``denom`` =
    (ly + lx)/dx² (``[0, 0]`` = 1 for the cavity) and the unit parabolic
    ``inlet`` (float32 values, as the JAX package's). Shared read-only."""
    cfg = solver.cfg
    return _constants(cfg.resolution, cfg.domain, float(cfg.length), dtype, str(device))


def contract_rows(solver: "ProjectionSolver", out: torch.Tensor, out_rows, B: int,
                  device: torch.device) -> torch.Tensor:
    """``out_rows``, B distinct rows of ``out`` given on the host, as a (B,)
    int32 tensor on ``device``, once ``out`` is checked to be a contiguous
    float32 (rows, S+1, n, n, C) tensor there with C >= 3 (a trajectory
    writes (u, v, p) into channels 0:3 of its row)."""
    n, S = solver.cfg.resolution, int(solver.cfg.n_snapshots)
    if (out.dtype != torch.float32 or out.device != torch.device(device)
            or out.ndim != 5 or tuple(out.shape[1:4]) != (S + 1, n, n) or out.shape[4] < 3
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 (rows, {S + 1}, {n}, {n}, >=3) "
                         f"tensor on {device}, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if out_rows is None:
        raise ValueError("out needs out_rows, the row of out of each image")
    if isinstance(out_rows, torch.Tensor) and out_rows.device.type != "cpu":
        raise ValueError("out_rows must be given on the host, where they are checked")
    rows = np.asarray(out_rows)
    if (rows.shape != (B,) or (rows < 0).any() or (rows >= out.shape[0]).any()
            or len(np.unique(rows)) != B):
        raise ValueError(f"out_rows must be {B} distinct rows of out's {out.shape[0]}, "
                         f"got {rows.tolist()}")
    return torch.as_tensor(rows, dtype=torch.int32, device=device)


def _is_scalar(a) -> bool:
    return a is None or np.ndim(a.cpu() if isinstance(a, torch.Tensor) else a) == 0


def per_image_steps(solver: "ProjectionSolver", inner_steps, B: int) -> np.ndarray:
    """``inner_steps`` (None = the config's, a scalar, or one per image) as
    a (B,) int64 array; raises on a negative count."""
    if inner_steps is None:
        inner_steps = solver.default_inner_steps()
    a = inner_steps.cpu().numpy() if isinstance(inner_steps, torch.Tensor) else inner_steps
    steps = np.broadcast_to(np.asarray(a, dtype=np.int64), (B,)).copy()
    if (steps < 0).any():
        raise ValueError(f"inner_steps must be >= 0, got {steps.min()}")
    return steps


def per_image_dt(solver: "ProjectionSolver", dt, B: int) -> np.ndarray:
    """``dt`` (None = the config's, a scalar, or one per image) as a (B,)
    float32 array: each value rounded once to the float32 JAX computes
    with."""
    if dt is None:
        dt = solver.cfg.dt
    a = dt.cpu().numpy() if isinstance(dt, torch.Tensor) else dt
    return np.broadcast_to(np.asarray(a, dtype=np.float64).astype(np.float32), (B,)).copy()


def _per_image(u_max, like: torch.Tensor):
    """u_max as a python float or a tensor shaped (..., 1) to broadcast
    against a (..., n) boundary line."""
    if isinstance(u_max, torch.Tensor):
        t = u_max.to(device=like.device, dtype=like.dtype)
        return t.reshape(*t.shape, 1)
    return float(u_max)


@dataclasses.dataclass(frozen=True)
class ProjectionSolver:
    """State: (u, v) on an (n, n) collocated grid, batched over leading axes."""

    cfg: ProjectionConfig

    # -- BCs --------------------------------------------------------------------

    def apply_velocity_bc(self, u: torch.Tensor, v: torch.Tensor, u_max=None):
        """Impose the BCs in the JAX package's set order (so the corners
        match); ``u_max`` (scalar or per image) overrides cfg.u_max."""
        cfg = self.cfg
        um = _per_image(cfg.u_max if u_max is None else u_max, u)
        u, v = u.clone(), v.clone()
        if cfg.domain == "channel":
            inlet = constants(self, u.dtype, u.device)["inlet"]
            u[..., :, 0] = inlet * um  # inlet (left)
            v[..., :, 0] = 0.0
            u[..., :, -1] = u[..., :, -2]  # outflow: zero gradient
            v[..., :, -1] = v[..., :, -2]
            u[..., 0, :] = 0.0  # bottom wall
            v[..., 0, :] = 0.0
            u[..., -1, :] = 0.0  # top wall
            v[..., -1, :] = 0.0
        elif cfg.domain == "cavity":
            u[..., 0, :] = 0.0
            v[..., 0, :] = 0.0
            u[..., :, 0] = 0.0
            v[..., :, 0] = 0.0
            u[..., :, -1] = 0.0
            v[..., :, -1] = 0.0
            u[..., -1, :] = um  # moving lid
            v[..., -1, :] = 0.0
        else:
            raise ValueError(cfg.domain)
        return u, v

    # -- spatial operators: edge-replicated shifts -------------------------------

    @staticmethod
    def _shift(q: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
        """Neighbour along axis (0 = y, 1 = x) with edge replication."""
        d = axis - 2
        n = q.shape[d]
        if direction > 0:
            return torch.cat([q.narrow(d, 1, n - 1), q.narrow(d, n - 1, 1)], dim=d)
        return torch.cat([q.narrow(d, 0, 1), q.narrow(d, 0, n - 1)], dim=d)

    def _grad_upwind(self, q, vel, axis: int, dx: float):
        """First-order upwind derivative of q along axis w.r.t. carrier vel."""
        fwd = (self._shift(q, axis, +1) - q) / dx
        bwd = (q - self._shift(q, axis, -1)) / dx
        return torch.where(vel > 0, bwd, fwd)

    def _grad_upwind2(self, q, vel, axis: int, dx: float):
        """Second-order upwind (Beam–Warming), first order on the two cells
        nearest each boundary."""
        qm1 = self._shift(q, axis, -1)
        qp1 = self._shift(q, axis, +1)
        qm2 = self._shift(qm1, axis, -1)
        qp2 = self._shift(qp1, axis, +1)
        bwd1 = (q - qm1) / dx
        fwd1 = (qp1 - q) / dx
        bwd2 = (3.0 * q - 4.0 * qm1 + qm2) / (2.0 * dx)
        fwd2 = (-3.0 * q + 4.0 * qp1 - qp2) / (2.0 * dx)
        d = axis - 2
        n = q.shape[d]
        idx = torch.arange(n, device=q.device).reshape((n, 1) if axis == 0 else (n,))
        bwd = torch.where(idx >= 2, bwd2, bwd1)
        fwd = torch.where(idx <= n - 3, fwd2, fwd1)
        return torch.where(vel > 0, bwd, fwd)

    def _grad_muscl(self, q, vel, axis: int, dx: float):
        """Van-Leer-limited MUSCL upwind derivative (2nd order where smooth,
        1st order at extrema; edge-replicated shifts zero the boundary
        slopes)."""
        a = self._shift(q, axis, +1) - q
        b = q - self._shift(q, axis, -1)
        ab = a * b
        slope = torch.where(ab > 0, 2.0 * ab / torch.where(ab > 0, a + b, 1.0), 0.0)
        s_m1 = self._shift(slope, axis, -1)
        s_p1 = self._shift(slope, axis, +1)
        grad_pos = (b + 0.5 * (slope - s_m1)) / dx
        grad_neg = (a - 0.5 * (s_p1 - slope)) / dx
        return torch.where(vel > 0, grad_pos, grad_neg)

    def _grad_adv(self, q, vel, axis, dx):
        adv = self.cfg.advection
        if adv == "muscl":
            return self._grad_muscl(q, vel, axis, dx)
        if adv == "upwind2":
            return self._grad_upwind2(q, vel, axis, dx)
        if adv == "upwind1":
            return self._grad_upwind(q, vel, axis, dx)
        raise ValueError(adv)

    def _laplacian(self, q, dx: float):
        return (
            self._shift(q, 0, +1) + self._shift(q, 0, -1)
            + self._shift(q, 1, +1) + self._shift(q, 1, -1) - 4.0 * q
        ) / (dx * dx)

    def predictor(self, u, v, dx: float, dt):
        nu = self.cfg.viscosity
        adv_u = u * self._grad_adv(u, u, 1, dx) + v * self._grad_adv(u, v, 0, dx)
        adv_v = u * self._grad_adv(v, u, 1, dx) + v * self._grad_adv(v, v, 0, dx)
        u_star = u + dt * (-adv_u + nu * self._laplacian(u, dx))
        v_star = v + dt * (-adv_v + nu * self._laplacian(v, dx))
        return u_star, v_star

    # -- pressure Poisson: the adjoint-consistent (D, G) pair ---------------------
    # G = forward difference, D = backward difference with a zero ghost;
    # A = −(D∘G) is the exact 5-point Laplacian.

    def _Gx(self, p, dx: float):
        g = (self._shift(p, 1, +1) - p) / dx
        if self.cfg.domain == "channel":
            # outlet: p = 0 at the face half a cell out → gradient −2p/dx
            g = torch.cat([g[..., :, :-1], -2.0 * p[..., :, -1:] / dx], dim=-1)
        return g

    def _Gy(self, p, dx: float):
        return (self._shift(p, 0, +1) - p) / dx

    @staticmethod
    def _shift_zero(q: torch.Tensor, axis: int) -> torch.Tensor:
        """Previous neighbour with a zero ghost at the low edge (flux form)."""
        d = axis - 2
        n = q.shape[d]
        return torch.cat([torch.zeros_like(q.narrow(d, 0, 1)), q.narrow(d, 0, n - 1)], dim=d)

    def _Dx(self, u, dx: float):
        return (u - self._shift_zero(u, 1)) / dx

    def _Dy(self, v, dx: float):
        return (v - self._shift_zero(v, 0)) / dx

    def _poisson_A(self, p, dx: float):
        return -(self._Dx(self._Gx(p, dx), dx) + self._Dy(self._Gy(p, dx), dx))

    # -- direct (eigen) pressure solve ---------------------------------------------

    def solve_pressure_direct(self, rhs: torch.Tensor, dx: float) -> torch.Tensor:
        """p = CYᵀ · ((CY · rhs · CXᵀ) / denom) · CX, per image (plain
        ``torch.matmul``; the CUDA stepper runs its own GEMMs)."""
        c = constants(self, rhs.dtype, rhs.device)
        cavity = self.cfg.domain == "cavity"
        if cavity:
            rhs = rhs - rhs.mean(dim=(-2, -1), keepdim=True)
        rhs_hat = torch.matmul(c["cy"], torch.matmul(rhs, c["cxT"]))
        p_hat = rhs_hat / c["denom"]
        if cavity:
            p_hat = p_hat.clone()
            p_hat[..., 0, 0] = 0.0
        return torch.matmul(c["cyT"], torch.matmul(p_hat, c["cx"]))

    def solve_pressure(self, rhs: torch.Tensor, dx: float,
                       p_init: torch.Tensor | None = None) -> torch.Tensor:
        """Jacobi-preconditioned CG with warm start; each image stops once
        ||r|| ≤ 1e-4·||rhs|| or at cfg.cg_iters and is then frozen while the
        others go on, as JAX's batched ``while_loop`` does."""
        cfg = self.cfg
        if cfg.domain == "cavity":
            rhs = rhs - rhs.mean(dim=(-2, -1), keepdim=True)
        dims = (-2, -1)
        dot = lambda a, b: (a * b).sum(dim=dims, keepdim=True)
        minv = dx * dx / 4.0
        tol2 = (1e-4) ** 2 * (dot(rhs, rhs) + 1e-30)
        p = torch.zeros_like(rhs) if p_init is None else p_init
        r = rhs - self._poisson_A(p, dx)
        z = minv * r
        d = z
        rz = dot(r, z)
        it = torch.zeros_like(rz, dtype=torch.int64)
        active = (it < cfg.cg_iters) & (dot(r, r) > tol2)
        while bool(active.any()):
            Ad = self._poisson_A(d, dx)
            alpha = rz / (dot(d, Ad) + 1e-30)
            p_n = p + alpha * d
            r_n = r - alpha * Ad
            z_n = minv * r_n
            rz_n = dot(r_n, z_n)
            d_n = z_n + rz_n / (rz + 1e-30) * d
            p, r, d, rz = (torch.where(active, new, old) for new, old in
                           ((p_n, p), (r_n, r), (d_n, d), (rz_n, rz)))
            it = it + active.to(torch.int64)
            active = (it < cfg.cg_iters) & (dot(r, r) > tol2)
        if cfg.domain == "cavity":
            p = p - p.mean(dim=dims, keepdim=True)
        return p

    def divergence(self, u, v, dx: float):
        """The discrete divergence the projection enforces (D pair)."""
        return self._Dx(u, dx) + self._Dy(v, dx)

    # -- full step ---------------------------------------------------------------------

    def step(self, u, v, mask, dx: float, dt, u_max=None, p_prev=None):
        cfg = self.cfg
        u_star, v_star = self.predictor(u, v, dx, dt)
        pen = 1.0 / (1.0 + dt * mask / cfg.penalization_eta)  # implicit Brinkman
        u_star = u_star * pen
        v_star = v_star * pen
        u_star, v_star = self.apply_velocity_bc(u_star, v_star, u_max)

        div = self._Dx(u_star, dx) + self._Dy(v_star, dx)
        if cfg.domain == "channel":
            # the inlet face carries the prescribed inflow flux (the flux-form
            # D has a zero ghost); without it the projection blocks the channel
            um = _per_image(cfg.u_max if u_max is None else u_max, u_star)
            inlet = constants(self, u_star.dtype, u_star.device)["inlet"] * um
            div = div.clone()
            div[..., :, 0] = div[..., :, 0] + (-inlet / dx)
        rhs = -div / dt
        if cfg.pressure_solver == "direct":
            p = self.solve_pressure_direct(rhs, dx)
        else:
            p = self.solve_pressure(rhs, dx, p_init=p_prev)

        u = u_star - dt * self._Gx(p, dx)
        v = v_star - dt * self._Gy(p, dx)
        u, v = self.apply_velocity_bc(u, v, u_max)
        return u * pen, v * pen, p

    # -- trajectories --------------------------------------------------------------------

    def default_inner_steps(self) -> int:
        cfg = self.cfg
        return max(int(round(cfg.t_end / cfg.dt)) // cfg.n_snapshots, 1)

    def make_trajectory_fn(self):
        """``traj(mask (..., n, n), u_max=None, inner_steps=None, dt=None)`` →
        (..., n_snapshots+1, n, n, 3) float32 [u, v, p] snapshots from rest
        (frame 0 = rest + BCs; float64 for a float64 mask, the tests' case). ``inner_steps`` and ``dt`` are scalars shared
        by the batch; ``u_max`` is a scalar or one value per image."""
        cfg = self.cfg
        dx = cfg.length / cfg.resolution

        def traj(mask: torch.Tensor, u_max=None, inner_steps=None, dt=None):
            inner = self.default_inner_steps() if inner_steps is None else int(inner_steps)
            # dt as the float32 value JAX computes with
            dt = float(np.float32(cfg.dt if dt is None else float(dt)))
            if mask.dtype != torch.float64:  # float64 masks keep a float64 state
                mask = mask.to(torch.float32)
            if isinstance(u_max, torch.Tensor):
                u_max = u_max.to(device=mask.device, dtype=mask.dtype)
            z = torch.zeros_like(mask)
            u, v = self.apply_velocity_bc(z, z, u_max)
            p = z
            frames = [torch.stack([u, v, p], dim=-1)]
            for _ in range(cfg.n_snapshots):
                for _ in range(inner):
                    u, v, p = self.step(u, v, mask, dx, dt, u_max, p_prev=p)
                frames.append(torch.stack([u, v, p], dim=-1))
            return torch.stack(frames, dim=-4)

        return traj

    def make_batched_trajectory_fn(self):
        """The batched ``traj(masks (B, n, n), u_max (B,) | None, inner_steps,
        dt, out=None, out_rows=None)`` → (B, S+1, n, n, 3): the plain PyTorch
        version of K2. ``inner_steps`` and ``dt`` are scalars or one value
        per image; the images are grouped by (dt, inner_steps) and each group
        runs through ``make_trajectory_fn`` (natively batched; JAX's is its
        ``vmap``). Given a (rows, S+1, n, n, C) ``out`` and host ``out_rows``
        (B,), image b's frames go into ``out[out_rows[b], ..., 0:3]`` instead,
        and ``out`` is returned."""
        one = self.make_trajectory_fn()

        def traj(masks: torch.Tensor, u_max=None, inner_steps=None, dt=None, out=None,
                 out_rows=None):
            if out is not None:
                rows = contract_rows(self, out, out_rows, masks.shape[0], masks.device)
                out[rows.long(), ..., 0:3] = traj(masks, u_max, inner_steps, dt).to(out.dtype)
                return out
            if _is_scalar(inner_steps) and _is_scalar(dt):
                return one(masks, u_max, inner_steps, dt)
            B = masks.shape[0]
            if B == 0:
                return one(masks, u_max, 0, None)
            steps = per_image_steps(self, inner_steps, B)
            dts = per_image_dt(self, dt, B)
            um = u_max
            if isinstance(u_max, torch.Tensor) and u_max.ndim > 0:
                um = u_max.to(masks.device).reshape(B)
            out = None
            for d, k in sorted(set(zip(dts.tolist(), steps.tolist()))):
                idx = np.nonzero((dts == np.float32(d)) & (steps == k))[0]
                sel = torch.as_tensor(idx, device=masks.device)
                frames = one(masks[sel], um[sel] if isinstance(um, torch.Tensor) and
                             um.ndim > 0 else um, int(k), d)
                if out is None:
                    out = frames.new_empty((B, *frames.shape[1:]))
                out[sel] = frames
            return out

        return traj
