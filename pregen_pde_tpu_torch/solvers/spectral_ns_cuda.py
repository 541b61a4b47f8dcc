"""Hand-written CUDA CN+AB2 stepper (counterpart of ``spectral_ns_pallas.py``).

The kernels (``csrc/spectral_ns_step.cu``) replace the Pallas TPU kernel
``pregen_pde_tpu/solvers/spectral_ns_pallas.py::build_batched_traj`` and
compute ``NSVorticitySolver._build_traj_packed(scheme="ab2")`` (plus
``fields_from_vorticity`` for ``output="fields"``). Two routes, chosen by
the grid alone:

- n in ``RESIDENT_N`` (128, 256): ``sns_cluster_kernel``, ONE launch a
  call. Each image is a thread-block cluster of n/16 blocks holding its
  spectrum and AB2 history in shared memory for all its steps; the 2-D
  FFTs run inside the cluster (two DSMEM exchanges a step), the frames are
  written from the kernel, and each image has its own ν and step count.
- n in (512, 1024): the three-launch chain a step (row pass with the pack
  prologue, column pass with the advection product, row pass with the
  CN+AB2 epilogue). At 512² the state (4 MB of complex64 for ω̂ and the
  history) and two packed physical planes exceed what a 16-block cluster
  holds (16 × 227 KB), so these grids stay on the chain.

``route="chain"`` runs the chain at 128/256 too (for comparison only; the
main path never asks for it). There is no fallback: a resident kernel that
the card cannot hold raises.

For a CPU tensor ``traj`` runs the plain PyTorch version (in float64 for a
float64 input), one call per distinct step count; for a CUDA tensor it
launches a kernel or raises. ``launches`` counts the CUDA kernels the
stepper enqueued (each C entry point reports its own count and the wrapper
adds it once the call returned without an error); the stand-alone
``fft2`` passes do not count.

Not ported from the TPU kernel: image grouping, VMEM diets and limits (the
TPU-only knobs), and the chunked ``carry`` variant and
``build_sharded_traj`` (later work, see ROADMAP.md). The ``precision``
tiers "fast", "high" and "exact" are accepted for the JAX package's API and
map to one float32 CUDA-core path (``PRECISIONS``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pregen_pde_tpu_torch.kernels import build as _build

__all__ = ["build_batched_traj", "supported", "fft2", "launches", "reset_launches",
           "max_active_clusters", "to_kernel_layout"]

LIB_NAME = "spectral_ns_step"
SUPPORTED_N = (128, 256, 512, 1024)
# grids of the cluster-resident kernel; the larger ones run the chain
RESIDENT_N = (128, 256)
ROUTES = ("auto", "chain")
NOT_RESIDENT = -2  # sns_traj's code when the card cannot hold one cluster
# precision tier -> the kernel path that runs it; the tensor-core tiers are
# later work, so every tier runs the float32 CUDA-core path
PRECISIONS = dict.fromkeys(("fast", "high", "exact"), "f32-cuda-core")

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_N = ctypes.POINTER(ctypes.c_int)  # out: kernels launched
_ARGTYPES = {
    "sns_fft2": [_P, _P, _I, _I, _I, _P, _P],
    "sns_init": [_P] * 13 + [_I, _I, _F, _F, _I, _P, _N],
    "sns_advance": [_P] * 12 + [_I, _I, _I, _F, _F, _I, _P, _N],
    "sns_snapshot": [_P] * 8 + [_I, _I, _I, _P, ctypes.c_longlong, _I, _P, _N],
    "sns_traj": [_P] * 9 + [_I] * 5 + [_F, _F, _I, _P, _P, _N],
    "sns_max_active_clusters": [_I, _N],
}


def supported(n: int) -> bool:
    """Grids the CUDA kernel handles: the powers of two 128–1024 (radix-2
    line FFTs in shared memory). The other multiples of 128 that the TPU
    kernel takes (384, 640, 768, 896) wait for an odd-radix stage."""
    return n in SUPPORTED_N


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


def _call(fn: str, *args) -> None:
    """Call a C entry point and raise on its ``cudaGetLastError()`` code."""
    rc = getattr(_lib(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME}.{fn} failed with CUDA error {rc}")


def _call_stepper(fn: str, *args) -> None:
    """Call one of the stepper's entry points and add the kernels it
    launched to ``launches``, after its return code was checked."""
    global launches
    n = ctypes.c_int(0)
    _call(fn, *args, ctypes.byref(n))
    launches += n.value


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} CUDA tensor of shape {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


def twiddles(n: int, device) -> torch.Tensor:
    """exp(−2πi j/n), j < n/2 (the chain's radix-2 passes), built in
    float64, stored complex64."""
    tw = np.exp(-2j * np.pi * np.arange(n // 2) / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def resident_twiddles(n: int) -> np.ndarray:
    """The resident kernel's line-transform twiddles W_n^{t k1} as a table
    [k1][t] (k1 < n/16, t < 16; lane t reads row k1), built in float64,
    stored complex64."""
    k1, t = np.meshgrid(np.arange(n // 16), np.arange(16), indexing="ij")
    return np.exp(-2j * np.pi * k1 * t / n).astype(np.complex64).reshape(n)


def to_kernel_layout(a: np.ndarray) -> np.ndarray:
    """An (..., n, n) spectrum in fft2 order (ky, kx) → the resident
    kernel's layout, a line per kx along ky: element [kx, ky]. The transpose
    is its own inverse, so the same function maps back."""
    return np.ascontiguousarray(np.swapaxes(a, -1, -2))


def max_active_clusters(n: int) -> int:
    """How many clusters of the resident kernel at n² the card holds at
    once (0: none)."""
    out = ctypes.c_int(0)
    _call("sns_max_active_clusters", n, ctypes.byref(out))
    return out.value


def fft2(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """2-D (i)FFT over the last two axes of a (B, n, n) complex64 tensor with
    the chain's row and column passes (``torch.fft`` on the CPU)."""
    if x.device.type == "cpu":
        return torch.fft.ifft2(x) if inverse else torch.fft.fft2(x)
    B, n = x.shape[0], x.shape[-1]
    if not supported(n):
        raise ValueError(f"CUDA FFT handles n in {SUPPORTED_N}, got {n}")
    _check_cuda(x, "x", torch.complex64, (B, n, n))
    out = torch.empty_like(x)
    tw = twiddles(n, x.device)
    with torch.cuda.device(x.device):
        _call("sns_fft2", x.data_ptr(), out.data_ptr(), B, n, int(inverse),
              tw.data_ptr(), _stream(x.device))
    return out


class _DeviceConsts:
    """Spectral constants of one grid on one device (built in float64)."""

    def __init__(self, solver, device):
        from pregen_pde_tpu_torch.solvers.spectral_ns import make_forcing

        g = solver.grid
        n = g.n
        f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
        kmax = (n // 2) * (2.0 * np.pi / g.length)
        self.kxd = f32(np.asarray(g.kx_full_deriv).reshape(n))
        self.k2v = f32(np.asarray(g.k_full) ** 2)
        self.de = f32(np.abs(g.k_full) <= (2.0 / 3.0) * kmax)
        self.tw = twiddles(n, device)
        self.tw_res = torch.from_numpy(resident_twiddles(n)).to(device)
        forcing = make_forcing(solver.cfg, g)
        f_hat = None if forcing is None else np.fft.fft2(
            np.asarray(forcing, np.float64)).astype(np.complex64)
        self.F = None if f_hat is None else torch.from_numpy(f_hat).to(device)
        # the resident kernel reads the forcing spectrum a line per kx
        self.Fk = None if f_hat is None else torch.from_numpy(
            to_kernel_layout(f_hat)).to(device)

    def f_ptr(self) -> int | None:
        return None if self.F is None else self.F.data_ptr()

    def fk_ptr(self) -> int | None:
        return None if self.Fk is None else self.Fk.data_ptr()


def _steps_per_image(inner_steps, default: int, B: int) -> torch.Tensor:
    """An int, None (the default) or a (B,) integer tensor → (B,) int64 on
    the CPU; every count ≥ 1."""
    if inner_steps is None:
        inner_steps = default
    if isinstance(inner_steps, torch.Tensor) and inner_steps.ndim > 0:
        if inner_steps.dtype.is_floating_point or tuple(inner_steps.shape) != (B,):
            raise ValueError(f"inner_steps must be an int or a ({B},) integer tensor, "
                             f"got {inner_steps.dtype} {tuple(inner_steps.shape)}")
        steps = inner_steps.detach().to("cpu", torch.int64)
    else:
        steps = torch.full((B,), int(inner_steps), dtype=torch.int64)
    if B and int(steps.min()) < 1:
        raise ValueError(f"inner_steps must be >= 1, got {steps.tolist()}")
    return steps


def build_batched_traj(solver, inner_steps: int | None = None,
                       precision: str = "fast", output: str = "vorticity",
                       route: str = "auto"):
    """``traj(w0 (B, n, n), nu (B,) | float | None, inner_steps=None)`` →
    (B, T, n, n) vorticity, or (B, T, n, n, 3) [u, v, p] with
    ``output="fields"``; T = n_snapshots (+1 with ``include_initial``, whose
    first frame is w0, or its fields). ``inner_steps`` is an int or a (B,)
    integer tensor (image b writes frame s after s · inner_steps[b] steps).
    One build serves every ``inner_steps``.

    ``route``: "auto" (the resident kernel at n ∈ ``RESIDENT_N``, the chain
    above) or "chain" (the chain at every n: comparison runs only)."""
    cfg = solver.cfg
    n = cfg.resolution
    if not supported(n):
        raise ValueError(f"CUDA stepper handles n in {SUPPORTED_N}, got {n}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {tuple(PRECISIONS)}, got {precision!r}")
    if output not in ("vorticity", "fields"):
        raise ValueError(f"output must be 'vorticity' or 'fields', got {output!r}")
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    resident = route == "auto" and n in RESIDENT_N
    fields_out = output == "fields"
    S = int(cfg.n_snapshots)
    inc = int(bool(cfg.include_initial))
    ch = 3 if fields_out else 1
    default_inner = solver.default_inner_steps() if inner_steps is None else int(inner_steps)
    dt, drag, dealias = float(cfg.dt), float(cfg.drag), int(bool(cfg.dealias))
    consts: dict[str, _DeviceConsts] = {}

    def plain(w0, nu, steps):
        snaps = solver._build_traj_packed(steps, scheme="ab2")(w0, nu)
        if not fields_out:
            return snaps
        f = solver.fields_from_vorticity(snaps)
        return torch.stack([f["u"], f["v"], f["p"]], dim=-1)

    def by_steps(run, w0, nu, steps):
        """``run(w0, nu, steps: int)`` once per distinct step count, the
        results scattered back to their rows."""
        values = torch.unique(steps)
        if len(values) == 1:
            return run(w0, nu, int(values[0]))
        out = None
        for v in values.tolist():
            rows = torch.nonzero(steps == v).flatten().to(w0.device)
            res = run(w0[rows], nu[rows], v)
            if out is None:
                out = res.new_empty((w0.shape[0], *res.shape[1:]))
            out[rows] = res
        return out

    def chain(w0f, nu_b, steps, c, out):
        """The three-launch chain, every image at ``steps`` steps a snapshot."""
        B = w0f.shape[0]
        dev = w0f.device
        planes = [torch.empty((B, n, n), dtype=torch.complex64, device=dev)
                  for _ in range(6)]
        W, Np, T0, T1, T2, A = (p.data_ptr() for p in planes)
        img_stride = (S + inc) * n * n * ch
        frame_bytes = n * n * ch * 4
        st = _stream(dev)
        consts_args = (c.kxd.data_ptr(), c.k2v.data_ptr(), c.de.data_ptr(),
                       c.tw.data_ptr())

        def snapshot(t):
            _call_stepper("sns_snapshot", W, T0, T1, T2, A, c.kxd.data_ptr(),
                          c.k2v.data_ptr(), c.tw.data_ptr(), B, n, int(fields_out),
                          out.data_ptr() + t * frame_bytes, img_stride, ch, st)

        _call_stepper("sns_init", w0f.data_ptr(), W, Np, T0, T1, T2, A, c.f_ptr(),
                      nu_b.data_ptr(), *consts_args, B, n, dt, drag, dealias, st)
        if inc:
            if fields_out:
                snapshot(0)
            else:
                out[:, 0, :, :, 0].copy_(w0f)
        for s in range(S):
            _call_stepper("sns_advance", W, Np, T0, T1, T2, A, c.f_ptr(),
                          nu_b.data_ptr(), *consts_args, B, n, steps, dt, drag,
                          dealias, st)
            snapshot(s + inc)
        # the scratch planes may be freed while kernels are queued: the
        # caching allocator reuses them only in this stream's order

    def resident_call(w0f, nu_b, steps, c, out):
        """One launch of the cluster kernel for the whole batch, the
        clusters ordered longest trajectory first."""
        B = w0f.shape[0]
        dev = w0f.device
        order = torch.argsort(-steps, stable=True).to(device=dev, dtype=torch.int32)
        steps_d = steps.to(device=dev, dtype=torch.int32)
        n_launched = ctypes.c_int(0)
        rc = _lib().sns_traj(w0f.data_ptr(), nu_b.data_ptr(), steps_d.data_ptr(),
                             order.data_ptr(), c.kxd.data_ptr(), c.k2v.data_ptr(),
                             c.de.data_ptr(), c.fk_ptr(), c.tw_res.data_ptr(), B, n, S,
                             inc, int(fields_out), dt, drag, dealias, out.data_ptr(),
                             _stream(dev), ctypes.byref(n_launched))
        if rc == NOT_RESIDENT:
            raise RuntimeError(
                f"{LIB_NAME}.sns_traj: the card cannot hold one cluster of the "
                f"{n}^2 resident kernel ({n // 16} blocks)")
        if rc != 0:
            raise RuntimeError(f"{LIB_NAME}.sns_traj failed with CUDA error {rc}")
        global launches
        launches += n_launched.value

    def traj(w0: torch.Tensor, nu=None, inner_steps=None) -> torch.Tensor:
        if w0.ndim != 3 or tuple(w0.shape[1:]) != (n, n):
            raise ValueError(f"w0 must be (B, {n}, {n}), got {tuple(w0.shape)}")
        B = w0.shape[0]
        steps = _steps_per_image(inner_steps, default_inner, B)
        # the kernels run float32; the plain version keeps a float64 input
        cpu64 = w0.device.type == "cpu" and w0.dtype == torch.float64
        w0f = w0 if cpu64 else w0.to(torch.float32)
        nu_b = torch.as_tensor(cfg.viscosity if nu is None else nu,
                               dtype=w0f.dtype, device=w0.device)
        nu_b = nu_b.expand(B).contiguous() if nu_b.ndim == 0 else nu_b.contiguous()
        if w0.device.type == "cpu":
            return by_steps(plain, w0f, nu_b, steps)
        if w0.device.type != "cuda":
            raise ValueError(f"unsupported device {w0.device}")
        dev = w0.device
        w0f = w0f.contiguous()
        _check_cuda(w0f, "w0", torch.float32, (B, n, n))
        _check_cuda(nu_b, "nu", torch.float32, (B,))
        c = consts.get(str(dev))
        if c is None:
            c = consts[str(dev)] = _DeviceConsts(solver, dev)
        with torch.cuda.device(dev):
            if resident:
                out = torch.empty((B, S + inc, n, n, ch), dtype=torch.float32, device=dev)
                resident_call(w0f, nu_b, steps, c, out)
            else:
                def run(w, nu_g, k):
                    o = torch.empty((w.shape[0], S + inc, n, n, ch), dtype=torch.float32,
                                    device=dev)
                    chain(w.contiguous(), nu_g.contiguous(), k, c, o)
                    return o

                out = by_steps(run, w0f, nu_b, steps)
        return out if fields_out else out[..., 0]

    return traj
