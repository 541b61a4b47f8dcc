"""Hand-written CUDA Chorin projection stepper (counterpart of
``ns_projection_pallas.py``).

The kernel (``csrc/ns_projection_step.cu``) replaces the Pallas TPU kernel
``pregen_pde_tpu/solvers/ns_projection_pallas.py::build_batched_traj`` and
computes ``ProjectionSolver.step`` iterated as in ``make_trajectory_fn``
with the direct (DCT eigen) pressure solve. A call is one launch: each
image is held by a thread-block cluster of n/16 blocks in shared memory for
all of its steps, with the four DCT products on tensor cores (3xTF32), and
its frames are written straight into the output. ``inner_steps`` and ``dt``
are scalars or one value per image, read by the kernel from device arrays,
so images of different CFL sub-buckets and retry attempts share a launch.

For a CPU tensor ``traj`` runs the plain PyTorch version
(``ProjectionSolver.make_batched_trajectory_fn``); for a CUDA tensor it
launches the kernel or raises. ``launches`` counts the CUDA kernels the
stepper enqueued: the C entry point reports its own count and the wrapper
adds it once the call returned without an error.

Not ported from the TPU kernel: the image grouping and the bf16 solve with
its refinement step (TPU-only: the CUDA kernel solves at float32 accuracy).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from pregen_pde_tpu_torch.kernels import build as _build
from pregen_pde_tpu_torch.solvers.ns_projection import (
    ProjectionSolver, constants, contract_rows, per_image_dt, per_image_steps)

__all__ = ["LIB_NAME", "build_batched_traj", "supported", "launches", "reset_launches",
           "max_active_clusters", "fragment_order"]

LIB_NAME = "ns_projection_step"
ADVECTIONS = ("muscl", "upwind1")  # upwind2 exists only in the plain version
MAX_N = 256
NOT_RESIDENT = -2  # nsp_traj's code when no cluster of the size fits the card

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_N = ctypes.POINTER(ctypes.c_int)  # out: kernels launched / clusters
_ARGTYPES = {
    "nsp_traj": [_P] * 10 + [_I] * 5 + [_F] * 4 + [_P, _P, _I, _P, _N],
    "nsp_max_active_clusters": [_I, _N],
}


def supported(solver: ProjectionSolver) -> bool:
    """Configs the CUDA kernel handles: the direct pressure solve, MUSCL or
    upwind1 advection, and n a multiple of 32 up to 256 (a cluster of n/16
    blocks, 16 rows each; above 128 a non-portable cluster of up to 16).
    Every such n runs through the one cluster-resident kernel; there is no
    other route."""
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


def _check(fn: str, rc: int, n: int) -> None:
    if rc == NOT_RESIDENT:
        raise RuntimeError(f"{LIB_NAME}.{fn}: no cluster of {n // 16} blocks for "
                           f"n = {n} fits this card (cudaOccupancyMaxActiveClusters = 0)")
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME}.{fn} failed with CUDA error {rc}")


def fragment_order(m: torch.Tensor) -> torch.Tensor:
    """An (n, n) B operand in the kernel's fragment order, (n/16, n/8, 32,
    4): ``[kp, j, 4g + t, e] = m[16 kp + 8 (e // 2) + 4 (e % 2) + t, 8 j + g]``,
    the m16n8k8 B fragments of lane 4g + t for the two k-steps of k-pair kp
    and the 8-column tile j (``frag_index`` in the kernel source)."""
    n = m.shape[0]
    kp = torch.arange(n // 16, device=m.device).view(-1, 1, 1, 1)
    j = torch.arange(n // 8, device=m.device).view(1, -1, 1, 1)
    lane = torch.arange(32, device=m.device).view(1, 1, -1, 1)
    e = torch.arange(4, device=m.device).view(1, 1, 1, -1)
    return m[16 * kp + 8 * (e // 2) + 4 * (e % 2) + lane % 4, 8 * j + lane // 4].contiguous()


@lru_cache(maxsize=16)
def _kernel_bases(solver: ProjectionSolver, device: str) -> dict:
    """The constants plus CX and CX^T in fragment order and 1/denom (from
    float64, rounded once; read-only)."""
    c = dict(constants(solver, torch.float32, device))
    c["inv_denom"] = (1.0 / constants(solver, torch.float64, "cpu")["denom"]).to(
        device=device, dtype=torch.float32)
    c["cx_frag"] = fragment_order(c["cx"])
    c["cxT_frag"] = fragment_order(c["cxT"])
    return c


def max_active_clusters(n: int) -> int:
    """How many n² clusters (images) the card holds at once."""
    out = ctypes.c_int(0)
    _check("nsp_max_active_clusters", _lib().nsp_max_active_clusters(n, ctypes.byref(out)), n)
    return out.value


def build_batched_traj(solver: ProjectionSolver):
    """``traj(masks (B, n, n), u_max (B,) | None, inner_steps=None, dt=None,
    out=None, out_rows=None)`` → (B, n_snapshots+1, n, n, 3) float32 [u, v,
    p], frame 0 = rest + BCs; the same contract as the plain batched
    trajectory. ``inner_steps`` and ``dt`` are scalars shared by the batch or
    one value per image (dt is rounded once to float32); the kernel reads
    both from device arrays, so one build serves every bucket, every dt and
    every mix of them. Given a contiguous float32 (rows, n_snapshots+1, n, n,
    C) ``out``, C >= 3, and ``out_rows`` (B,) on the host, the kernel stores
    image b's frames in place into channels 0:3 of ``out[out_rows[b]]``
    (a channel stride of C), leaves the other channels alone, and ``out`` is
    returned."""
    cfg = solver.cfg
    if not supported(solver):
        raise ValueError(unsupported_reason(solver))
    n = cfg.resolution
    S = int(cfg.n_snapshots)
    dx = cfg.length / n
    plain = solver.make_batched_trajectory_fn()

    def traj(masks: torch.Tensor, u_max=None, inner_steps=None, dt=None, out=None,
             out_rows=None) -> torch.Tensor:
        global launches
        if masks.ndim != 3 or tuple(masks.shape[1:]) != (n, n):
            raise ValueError(f"masks must be (B, {n}, {n}), got {tuple(masks.shape)}")
        B = masks.shape[0]
        dev = masks.device
        if dev.type == "cpu":
            return plain(masks, u_max, inner_steps, dt, out=out, out_rows=out_rows)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        steps = per_image_steps(solver, inner_steps, B)
        dts = per_image_dt(solver, dt, B)
        um = torch.as_tensor(cfg.u_max if u_max is None else u_max, dtype=torch.float32,
                             device=dev)
        um = (um.expand(B) if um.ndim == 0 else um.reshape(B)).contiguous()
        m = masks.to(torch.float32).contiguous()
        c = _kernel_bases(solver, str(dev))
        steps_d = torch.as_tensor(steps, dtype=torch.int32).to(dev)
        dt_d = torch.as_tensor(dts, dtype=torch.float32).to(dev)
        if out is None:
            out, rows_d = torch.empty((B, S + 1, n, n, 3), dtype=torch.float32, device=dev), None
        else:
            rows_d = contract_rows(solver, out, out_rows, B, dev)
        launched = ctypes.c_int(0)
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().nsp_traj(
                m.data_ptr(), um.data_ptr(), dt_d.data_ptr(), steps_d.data_ptr(),
                c["inlet"].data_ptr(), c["cy"].data_ptr(), c["cyT"].data_ptr(),
                c["cx_frag"].data_ptr(), c["cxT_frag"].data_ptr(), c["inv_denom"].data_ptr(), B, n,
                int(cfg.domain == "channel"), int(cfg.advection == "muscl"), S,
                float(cfg.viscosity), float(cfg.penalization_eta), dx, dx * dx,
                out.data_ptr(), None if rows_d is None else rows_d.data_ptr(), out.shape[-1],
                st, ctypes.byref(launched))
        _check("nsp_traj", rc, n)
        launches += launched.value
        # the argument arrays may be freed while the kernel is queued: the
        # caching allocator reuses them only in this stream's order
        return out

    return traj
