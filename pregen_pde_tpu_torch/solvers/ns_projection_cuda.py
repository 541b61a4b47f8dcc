"""Hand-written CUDA Chorin projection stepper (counterpart of
``ns_projection_pallas.py``).

The kernel (``csrc/ns_projection_step.cu``) replaces the Pallas TPU kernel
``pregen_pde_tpu/solvers/ns_projection_pallas.py::build_batched_traj`` and
computes ``ProjectionSolver.step`` iterated as in ``make_trajectory_fn``
with the direct (DCT eigen) pressure solve. A step is seven launches
(predictor, divergence, four shared-memory tiled SGEMMs for the two DCT
transforms, correction) looped over ``inner_steps`` by the C entry point;
a snapshot is one more launch.

For a CPU tensor ``traj`` runs the plain PyTorch version
(``ProjectionSolver.make_batched_trajectory_fn``); for a CUDA tensor it
launches the kernel or raises. ``launches`` counts the CUDA kernels the
stepper enqueued: each C entry point reports its own count and the wrapper
adds it once the call returned without an error.

Not ported from the TPU kernel: the image grouping and the bf16 solve with
its refinement step (TPU-only: the CUDA kernel solves in float32).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pregen_pde_tpu_torch.kernels import build as _build
from pregen_pde_tpu_torch.solvers.ns_projection import ProjectionSolver, constants

__all__ = ["LIB_NAME", "build_batched_traj", "supported", "launches", "reset_launches"]

LIB_NAME = "ns_projection_step"
ADVECTIONS = ("muscl", "upwind1")  # upwind2 exists only in the plain version
MAX_N = 256

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_N = ctypes.POINTER(ctypes.c_int)  # out: kernels launched
_ARGTYPES = {
    "nsp_init": [_P] * 5 + [_I] * 3 + [_P, _L, _P, _N],
    "nsp_advance": [_P] * 15 + [_I] * 5 + [_F] * 5 + [_P, _L, _P, _N],
}


def supported(solver: ProjectionSolver) -> bool:
    """Configs the CUDA kernel handles: the direct pressure solve, MUSCL or
    upwind1 advection, and n a multiple of 32 (the GEMM tile) up to 256."""
    cfg = solver.cfg
    n = cfg.resolution
    return (cfg.pressure_solver == "direct" and cfg.advection in ADVECTIONS
            and cfg.domain in ("channel", "cavity")
            and n % 32 == 0 and 32 <= n <= MAX_N)


def unsupported_reason(solver: ProjectionSolver) -> str:
    cfg = solver.cfg
    return (f"the CUDA projection stepper handles the direct pressure solver, "
            f"advection in {ADVECTIONS} and n a multiple of 32 up to {MAX_N}; got "
            f"{cfg.pressure_solver!r}, {cfg.advection!r}, n = {cfg.resolution}")


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME)
    for fn, argtypes in _ARGTYPES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def _call_stepper(fn: str, *args) -> None:
    """Call one of the stepper's entry points, raise on its
    ``cudaGetLastError()`` code, then add the kernels it launched."""
    global launches
    n = ctypes.c_int(0)
    rc = getattr(_lib(), fn)(*args, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME}.{fn} failed with CUDA error {rc}")
    launches += n.value


def build_batched_traj(solver: ProjectionSolver):
    """``traj(masks (B, n, n), u_max (B,) | None, inner_steps=None, dt=None)``
    → (B, n_snapshots+1, n, n, 3) float32 [u, v, p], frame 0 = rest + BCs;
    the same contract as the plain batched trajectory. ``inner_steps`` and
    ``dt`` are scalars shared by the batch and runtime arguments of the
    kernel: one build serves every bucket and every dt."""
    cfg = solver.cfg
    if not supported(solver):
        raise ValueError(unsupported_reason(solver))
    n = cfg.resolution
    S = int(cfg.n_snapshots)
    dx = cfg.length / n
    plain = solver.make_batched_trajectory_fn()

    def traj(masks: torch.Tensor, u_max=None, inner_steps=None, dt=None) -> torch.Tensor:
        if masks.ndim != 3 or tuple(masks.shape[1:]) != (n, n):
            raise ValueError(f"masks must be (B, {n}, {n}), got {tuple(masks.shape)}")
        B = masks.shape[0]
        dev = masks.device
        steps = solver.default_inner_steps() if inner_steps is None else int(inner_steps)
        dt_f = float(np.float32(cfg.dt if dt is None else float(dt)))
        um = torch.as_tensor(cfg.u_max if u_max is None else u_max, dtype=torch.float32,
                             device=dev)
        um = (um.expand(B) if um.ndim == 0 else um.reshape(B)).contiguous()
        if dev.type == "cpu":
            return plain(masks, um, steps, dt_f)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if steps < 0:
            raise ValueError(f"inner_steps must be >= 0, got {steps}")
        m = masks.to(torch.float32).contiguous()
        c = constants(solver, torch.float32, dev)
        U, V, US, VS, R, T, P = (torch.empty((B, n, n), dtype=torch.float32, device=dev)
                                 for _ in range(7))
        out = torch.empty((B, S + 1, n, n, 3), dtype=torch.float32, device=dev)
        img_stride = (S + 1) * n * n * 3
        frame_bytes = n * n * 3 * 4
        channel = int(cfg.domain == "channel")
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream(dev).cuda_stream
            _call_stepper("nsp_init", U.data_ptr(), V.data_ptr(), P.data_ptr(),
                          um.data_ptr(), c["inlet"].data_ptr(), B, n, channel,
                          out.data_ptr(), img_stride, st)
            for s in range(S):
                _call_stepper(
                    "nsp_advance", U.data_ptr(), V.data_ptr(), US.data_ptr(),
                    VS.data_ptr(), R.data_ptr(), T.data_ptr(), P.data_ptr(),
                    m.data_ptr(), um.data_ptr(), c["inlet"].data_ptr(),
                    c["cy"].data_ptr(), c["cyT"].data_ptr(), c["cx"].data_ptr(),
                    c["cxT"].data_ptr(), c["denom"].data_ptr(), B, n, channel,
                    int(cfg.advection == "muscl"), steps, dt_f, float(cfg.viscosity),
                    float(cfg.penalization_eta), dx, dx * dx,
                    out.data_ptr() + (s + 1) * frame_bytes, img_stride, st)
        # the scratch planes may be freed while kernels are queued: the
        # caching allocator reuses them only in this stream's order
        return out

    return traj
