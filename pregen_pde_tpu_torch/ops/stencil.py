"""Periodic stencils of the heat solver: the 5-point Laplacian (K5a) and the
fused Heun step (K5b), each a hand-written CUDA kernel with its plain PyTorch
version beside it (counterpart of ``pregen_pde_tpu/ops/stencil.py``).

The kernels (``csrc/stencil.cu``) replace the Pallas TPU kernels
``laplacian_pallas`` and ``heat_step_pallas``. The plain versions
``laplacian``, ``heat_step`` and ``heat_trajectory_plain`` repeat those
kernels' arithmetic on (..., n, n) tensors: the neighbour order up, down,
left, right (up = ``roll(u, 1)`` along H), the multiply by ``inv_dx2 =
1/(dx·dx)``, and the reaction term k·u(1−u²) only when k ≠ 0.

K5b has two routes on the card. ``heat_trajectory`` runs a whole
trajectory (S snapshots of ``inner`` steps) as ONE launch of the resident
kernel, each image held on chip for all its steps, when the kernel can hold
an n × n image (``trajectory_route(n) == "resident"``, n up to about 320);
above that it takes the tiled route, ``heat_advance`` once a snapshot, one
launch a step. ``heat_step_cuda`` (one step) and ``heat_advance`` are the
tiled kernel.

``laplacian_cuda``, ``heat_step_cuda``, ``heat_advance`` and
``heat_trajectory`` run the plain version for a tensor on the CPU; for a
CUDA tensor they launch a kernel or raise. ``launches`` counts the CUDA
kernels enqueued: each C entry point reports its own count and the wrapper
adds it once the call returned without an error.
"""

from __future__ import annotations

import ctypes

import torch

from pregen_pde_tpu_torch.kernels import build as _build

__all__ = ["LIB_NAME", "laplacian", "heat_step", "heat_trajectory_plain", "laplacian_cuda",
           "heat_step_cuda", "heat_advance", "heat_trajectory", "resident_cluster",
           "trajectory_route", "launches", "reset_launches"]

LIB_NAME = "stencil"

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_N = ctypes.POINTER(ctypes.c_int)  # out: kernels launched
_ARGTYPES = {
    "stencil_laplacian": [_P, _P, _I, _I, _F, _P, _N],
    "stencil_heat_advance": [_P] * 4 + [_L] + [_I] * 3 + [_F] * 5 + [_P, _N],
    "stencil_heat_trajectory": [_P, _P] + [_I] * 4 + [_F] * 5 + [_I, _P, _N],
}
_typed: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0


def laplacian(u: torch.Tensor, dx: float) -> torch.Tensor:
    """Plain K5a: (up + down + left + right − 4u)·inv_dx2 on (..., n, n)."""
    inv_dx2 = 1.0 / (dx * dx)
    up = torch.roll(u, 1, -2)
    down = torch.roll(u, -1, -2)
    left = torch.roll(u, 1, -1)
    right = torch.roll(u, -1, -1)
    return (up + down + left + right - 4.0 * u) * inv_dx2


def heat_step(u: torch.Tensor, dx: float, diffusivity: float, dt: float,
              reaction: float = 0.0) -> torch.Tensor:
    """Plain K5b: one Heun step of u_t = DΔu + k·u(1−u²) on (..., n, n)."""

    def rhs(v):
        out = diffusivity * laplacian(v, dx)
        if reaction != 0.0:
            out = out + reaction * v * (1.0 - v * v)
        return out

    k1 = rhs(u)
    k2 = rhs(u + dt * k1)
    return u + 0.5 * dt * (k1 + k2)


def heat_trajectory_plain(u0: torch.Tensor, n_snapshots: int, inner: int, dx: float,
                          diffusivity: float, dt: float, reaction: float = 0.0) -> torch.Tensor:
    """Plain K5b trajectory: (B, S+1, n, n) with frame 0 = u0 and frame s the
    state after s·inner ``heat_step``s."""
    out = torch.empty((u0.shape[0], n_snapshots + 1, *u0.shape[1:]), dtype=u0.dtype,
                      device=u0.device)
    out[:, 0] = u0
    u = u0
    for s in range(n_snapshots):
        for _ in range(inner):
            u = heat_step(u, dx, diffusivity, dt, reaction)
        out[:, s + 1] = u
    return out


def _lib() -> ctypes.CDLL:
    """The loaded library, its entry points typed once."""
    lib = _build.load(LIB_NAME)
    if _typed.get("lib") is not lib:
        for fn, argtypes in _ARGTYPES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.stencil_heat_resident_cluster.argtypes = [_I, _I]
        lib.stencil_heat_resident_cluster.restype = ctypes.c_int
        _typed["lib"] = lib
    return lib


def _call(fn: str, *args) -> None:
    """Call a C entry point, raise on its ``cudaGetLastError()`` code, then
    add the kernels it launched."""
    global launches
    n = ctypes.c_int(0)
    rc = getattr(_lib(), fn)(*args, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME}.{fn} failed with CUDA error {rc}")
    launches += n.value


def _as_batch(u: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor the kernels take, as contiguous (B, n, n); raise otherwise."""
    if u.device.type != "cuda":
        raise ValueError(f"the stencil kernels run on CUDA tensors, got {u.device}")
    if u.dtype != torch.float32:
        raise ValueError(f"the stencil kernels take float32, got {u.dtype}")
    if u.ndim < 2 or u.shape[-1] != u.shape[-2]:
        raise ValueError(f"the stencil kernels take (..., n, n), got {tuple(u.shape)}")
    n = u.shape[-1]
    b = u.reshape(-1, n, n).contiguous()
    if not 1 <= b.shape[0] <= 65535 or n * n >= 2**31:
        raise ValueError(f"the stencil kernels take 1-65535 images below 2^31 points, "
                         f"got {tuple(u.shape)}")
    return b


def laplacian_cuda(u: torch.Tensor, dx: float) -> torch.Tensor:
    """K5a on a CUDA tensor (..., n, n) float32; the plain version on the CPU."""
    if u.device.type == "cpu":
        return laplacian(u, dx)
    b = _as_batch(u)
    out = torch.empty_like(b)
    with torch.cuda.device(b.device):
        st = torch.cuda.current_stream(b.device).cuda_stream
        _call("stencil_laplacian", b.data_ptr(), out.data_ptr(), b.shape[0], b.shape[-1],
              1.0 / (dx * dx), st)
    return out.reshape(u.shape)


def heat_advance(u: torch.Tensor, steps: int, dx: float, diffusivity: float, dt: float,
                 reaction: float = 0.0, frame: torch.Tensor | None = None) -> torch.Tensor:
    """``steps`` fused Heun steps (K5b) from ``u`` (..., n, n), which is not
    written; → the new state. On a CUDA tensor the C entry point loops the
    steps over ping-pong buffers, and the last step also writes into
    ``frame`` (a (B, n, n) view with rows of n contiguous floats, e.g. one
    snapshot of a (B, S+1, n, n) output). On the CPU the plain version runs
    ``steps`` times and the result is copied into ``frame``."""
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if u.device.type == "cpu":
        for _ in range(steps):
            u = heat_step(u, dx, diffusivity, dt, reaction)
        if frame is not None:
            frame.copy_(u.reshape(frame.shape))
        return u
    b = _as_batch(u)
    B, n = b.shape[0], b.shape[-1]
    frame_ptr, frame_stride = None, 0
    if frame is not None:
        if (frame.device != b.device or frame.dtype != torch.float32
                or tuple(frame.shape) != (B, n, n) or frame.stride()[1:] != (n, 1)):
            raise ValueError(f"frame must be a float32 ({B}, {n}, {n}) view with rows of n "
                             f"contiguous floats on {b.device}, got {tuple(frame.shape)} "
                             f"{frame.dtype} strides {frame.stride()} on {frame.device}")
        frame_ptr, frame_stride = frame.data_ptr(), frame.stride(0)
    a = torch.empty_like(b)
    c = torch.empty_like(b) if steps > 1 else a
    with torch.cuda.device(b.device):
        st = torch.cuda.current_stream(b.device).cuda_stream
        _call("stencil_heat_advance", b.data_ptr(), a.data_ptr(), c.data_ptr(), frame_ptr,
              frame_stride, B, n, steps, dt, 0.5 * dt, diffusivity,
              reaction, 1.0 / (dx * dx), st)
    return (a if steps % 2 else c).reshape(u.shape)


def heat_step_cuda(u: torch.Tensor, dx: float, diffusivity: float, dt: float,
                   reaction: float = 0.0) -> torch.Tensor:
    """K5b, one step, on a CUDA tensor (..., n, n) float32; the plain version
    on the CPU."""
    return heat_advance(u, 1, dx, diffusivity, dt, reaction)


def resident_cluster(n: int, cluster: int = 0) -> int:
    """The cluster size (blocks an image) the resident trajectory kernel takes
    for n × n (``cluster`` 0: its default, else that size if it fits); 0 when
    it cannot hold the image. Needs the built library."""
    return int(_lib().stencil_heat_resident_cluster(int(n), int(cluster)))


def trajectory_route(n: int) -> str:
    """``heat_trajectory``'s route on the card for n × n images."""
    return "resident" if resident_cluster(n) else "tiled"


def heat_trajectory(u0: torch.Tensor, n_snapshots: int, inner: int, dx: float,
                    diffusivity: float, dt: float, reaction: float = 0.0,
                    out: torch.Tensor | None = None, *, cluster: int = 0) -> torch.Tensor:
    """K5b over a whole trajectory: → ``out`` (B, S+1, n, n), frame 0 = u0,
    frame s the state after s·inner Heun steps; u0 (B, n, n) is not written.
    On a CUDA tensor the resident route is one launch, the tiled route
    (n above the resident kernel's reach) ``heat_advance`` once a snapshot;
    ``cluster`` forces the resident kernel's blocks an image (timing only).
    On the CPU the plain version runs and is copied into ``out``."""
    S, inner = int(n_snapshots), int(inner)
    if S < 0 or inner < 1:
        raise ValueError(f"need n_snapshots >= 0 and inner >= 1, got {S}, {inner}")
    if u0.device.type == "cpu":
        traj = heat_trajectory_plain(u0, S, inner, dx, diffusivity, dt, reaction)
        return traj if out is None else out.copy_(traj)
    b = _as_batch(u0)
    B, n = b.shape[0], b.shape[-1]
    if out is None:
        out = torch.empty((B, S + 1, n, n), dtype=torch.float32, device=b.device)
    elif (out.device != b.device or out.dtype != torch.float32
          or tuple(out.shape) != (B, S + 1, n, n) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({B}, {S + 1}, {n}, {n}) tensor on "
                         f"{b.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    with torch.cuda.device(b.device):
        if resident_cluster(n, cluster):
            st = torch.cuda.current_stream(b.device).cuda_stream
            _call("stencil_heat_trajectory", b.data_ptr(), out.data_ptr(), B, n, S, inner, dt,
                  0.5 * dt, diffusivity, reaction, 1.0 / (dx * dx), cluster, st)
            return out
        if cluster:
            raise ValueError(f"the resident kernel cannot hold {n}^2 in clusters of {cluster}")
        out[:, 0] = b
        u = b
        for s in range(S):
            u = heat_advance(u, inner, dx, diffusivity, dt, reaction, frame=out[:, s + 1])
    return out
