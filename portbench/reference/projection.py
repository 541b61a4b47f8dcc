"""Plain reference of the masked generator's stepper: the Brinkman-penalised
Chorin projection on the channel (parabolic inlet, zero-gradient outlet,
no-slip walls), MUSCL advection, central diffusion, and the exact DCT eigen
solve of the pressure Poisson equation, in plain ``torch``.

Copied from ``pregen_pde_tpu_torch/solvers/ns_projection.py`` at commit
92d189c (``parabolic_inlet``, ``eigen_basis``, ``apply_velocity_bc``,
``_shift``, ``_grad_muscl``, ``_laplacian``, ``predictor``, ``_Gx``, ``_Gy``,
``_Dx``, ``_Dy``, ``solve_pressure_direct``, ``step``), for the channel
with the direct solve and MUSCL, the masked generator's settings. Changes,
none in the arithmetic: ``advance`` takes one dt and one step count per
image (an image stops changing once its steps are done), and ``dtype`` runs
the same steps in float64 (the check's yardstick).
Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def parabolic_inlet(n: int) -> np.ndarray:
    """u(y) = 4·y(1−y) on cell centres for Umax = 1, float32."""
    y = (np.arange(n) + 0.5) / n
    return (4.0 * y * (1.0 - y)).astype(np.float32)


@lru_cache(maxsize=8)
def _tables(n: int, length: float, device: str, dtype: torch.dtype) -> dict:
    """The channel's eigen bases (DCT-II along y, DCT-IV along x), built in
    float64 and cast to ``dtype`` once, and the unit inlet (float32 values)."""
    j = np.arange(n)
    c2 = np.cos(np.pi * j[:, None] * (j[None, :] + 0.5) / n) * np.sqrt(2.0 / n)
    c2[0] *= np.sqrt(0.5)
    lam2 = 2.0 - 2.0 * np.cos(np.pi * j / n)
    c4 = np.cos(np.pi * (j[:, None] + 0.5) * (j[None, :] + 0.5) / n) * np.sqrt(2.0 / n)
    lam4 = 2.0 - 2.0 * np.cos(np.pi * (j + 0.5) / n)
    dx = length / n
    denom = (lam2[:, None] + lam4[None, :]) / (dx * dx)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    return {"cy": t(c2), "cyT": t(c2.T), "cx": t(c4), "cxT": t(c4.T), "denom": t(denom),
            "inlet": t(parabolic_inlet(n))}


def _shift(q: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """Neighbour along axis (0 = y, 1 = x) with edge replication."""
    d = axis - 2
    n = q.shape[d]
    if direction > 0:
        return torch.cat([q.narrow(d, 1, n - 1), q.narrow(d, n - 1, 1)], dim=d)
    return torch.cat([q.narrow(d, 0, 1), q.narrow(d, 0, n - 1)], dim=d)


def _shift_zero(q: torch.Tensor, axis: int) -> torch.Tensor:
    d = axis - 2
    n = q.shape[d]
    return torch.cat([torch.zeros_like(q.narrow(d, 0, 1)), q.narrow(d, 0, n - 1)], dim=d)


def _grad_muscl(q, vel, axis: int, dx: float):
    """Van-Leer-limited MUSCL upwind derivative."""
    a = _shift(q, axis, +1) - q
    b = q - _shift(q, axis, -1)
    ab = a * b
    slope = torch.where(ab > 0, 2.0 * ab / torch.where(ab > 0, a + b, 1.0), 0.0)
    s_m1 = _shift(slope, axis, -1)
    s_p1 = _shift(slope, axis, +1)
    grad_pos = (b + 0.5 * (slope - s_m1)) / dx
    grad_neg = (a - 0.5 * (s_p1 - slope)) / dx
    return torch.where(vel > 0, grad_pos, grad_neg)


def _laplacian(q, dx: float):
    return (_shift(q, 0, +1) + _shift(q, 0, -1) + _shift(q, 1, +1) + _shift(q, 1, -1)
            - 4.0 * q) / (dx * dx)


def apply_bc(u, v, um, inlet):
    """Channel BCs in the port's order: inlet, outlet, bottom, top."""
    u, v = u.clone(), v.clone()
    u[..., :, 0] = inlet * um
    v[..., :, 0] = 0.0
    u[..., :, -1] = u[..., :, -2]
    v[..., :, -1] = v[..., :, -2]
    u[..., 0, :] = 0.0
    v[..., 0, :] = 0.0
    u[..., -1, :] = 0.0
    v[..., -1, :] = 0.0
    return u, v


class Channel:
    """The masked generator's channel stepper for a batch of images, each
    with its mask (B, n, n), inlet peak u_max (B,) and dt (B,), given as
    float32 values and computed in ``dtype`` (float32 as the port; float64
    for the check's floor)."""

    def __init__(self, cfg: dict, mask: torch.Tensor, u_max: torch.Tensor,
                 dt: torch.Tensor, dtype: torch.dtype = torch.float32):
        n = mask.shape[-1]
        self.nu, self.eta = float(cfg["viscosity"]), float(cfg["penalization_eta"])
        self.dx = float(cfg["length"]) / n
        self.c = _tables(n, float(cfg["length"]), str(mask.device), dtype)
        f32 = lambda t: t.to(device=mask.device, dtype=torch.float32).to(dtype)
        self.mask = f32(mask)
        self.um = f32(u_max)[:, None]
        self.dt = f32(dt)[:, None, None]
        self.pen = 1.0 / (1.0 + self.dt * self.mask / self.eta)

    def rest(self):
        z = torch.zeros_like(self.mask)
        u, v = apply_bc(z, z, self.um, self.c["inlet"])
        return u, v, z

    def _gx(self, p):
        g = (_shift(p, 1, +1) - p) / self.dx
        return torch.cat([g[..., :, :-1], -2.0 * p[..., :, -1:] / self.dx], dim=-1)

    def step(self, u, v):
        dx, dt, nu, c = self.dx, self.dt, self.nu, self.c
        adv_u = u * _grad_muscl(u, u, 1, dx) + v * _grad_muscl(u, v, 0, dx)
        adv_v = u * _grad_muscl(v, u, 1, dx) + v * _grad_muscl(v, v, 0, dx)
        u_s = u + dt * (-adv_u + nu * _laplacian(u, dx))
        v_s = v + dt * (-adv_v + nu * _laplacian(v, dx))
        u_s, v_s = apply_bc(u_s * self.pen, v_s * self.pen, self.um, c["inlet"])
        div = (u_s - _shift_zero(u_s, 1)) / dx + (v_s - _shift_zero(v_s, 0)) / dx
        div = div.clone()
        div[..., :, 0] = div[..., :, 0] + (-(c["inlet"] * self.um) / dx)
        rhs = -div / dt
        p_hat = torch.matmul(c["cy"], torch.matmul(rhs, c["cxT"])) / c["denom"]
        p = torch.matmul(c["cyT"], torch.matmul(p_hat, c["cx"]))
        u = u_s - dt * self._gx(p)
        v = v_s - dt * (_shift(p, 0, +1) - p) / dx
        u, v = apply_bc(u, v, self.um, c["inlet"])
        return u * self.pen, v * self.pen, p

    def advance(self, u, v, steps: np.ndarray):
        """Each image ``steps[i]`` steps from (u, v) → (u, v, p) of its last
        step (p = 0 for an image that takes none). On a card the step is
        captured once as a CUDA graph and replayed (the same kernels, without
        the interpreter's cost per operation)."""
        live_n = torch.as_tensor(np.asarray(steps), device=u.device)[:, None, None]
        n = int(np.max(steps)) if len(steps) else 0
        state = (u.clone(), v.clone(), torch.zeros_like(u))
        k = torch.zeros((), dtype=torch.int64, device=u.device)

        def one():
            live = live_n > k
            for old, new in zip(state, self.step(state[0], state[1])):
                old.copy_(torch.where(live, new, old))
            k.add_(1)

        if u.is_cuda and n > 1:
            side = torch.cuda.Stream(u.device)
            side.wait_stream(torch.cuda.current_stream(u.device))
            with torch.cuda.stream(side):
                k.fill_(n)  # warm-up with no image live: the state stays
                one()
            torch.cuda.current_stream(u.device).wait_stream(side)
            k.zero_()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                one()
            for _ in range(n):
                graph.replay()
        else:
            for _ in range(n):
                one()
        return state
