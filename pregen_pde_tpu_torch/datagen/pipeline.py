"""Difficulty-aware NS dataset generation (port of ``datagen/pipeline.py``).

Output contract: float32 (or float16) (N, T, H, W, 6) with channels
[Ux, Uy, p, Re_norm, mask, SDF], Re_norm = (Re − 100)/9900, mask 1 = hole.

With ``vary_difficulty`` each trajectory draws Re ~ clip(N(5000, 2000²)),
ν = 1/Re, and a band-law horizon. On the plain methods trajectories are
bucketed by horizon, each bucket padded to a power of two by repeating its
first index (the padded rows are dropped), and each bucket runs as one
batched solve, as in the JAX package. The CUDA kernel takes a step count
per image, so there the whole batch is one call, each row at its bucket's
inner steps: every row equals its bucket's result, and no padded row is
computed.

The random draws are split from the compute: ``draw_batch_inputs`` makes the
GRF white noise ξ and the Re normal z from an explicit ``torch.Generator``,
and ``generate_ns_batch_from_inputs(xi, z_re, ...)`` is a pure function of
them, so a test can feed it JAX's own draws. The host fetch is synchronous
(the JAX path's depth-2 solve/fetch overlap is later work).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from pregen_pde_tpu_torch.core import NSVorticityConfig
from pregen_pde_tpu_torch.fields.geometry import no_hole_mask_and_sdf
from pregen_pde_tpu_torch.fields.grf import draw_grf_noise, grf_filter
from pregen_pde_tpu_torch.solvers import schedules
from pregen_pde_tpu_torch.solvers.spectral_ns import CUDA_METHODS, NSVorticitySolver
from pregen_pde_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Difficulty-aware dataset generation settings (same fields as the JAX
    package's ``GenerationConfig``)."""

    solver: NSVorticityConfig = NSVorticityConfig()
    batch_size: int = 128
    re_mean: float = 5000.0
    re_std: float = 2000.0
    vary_difficulty: bool = True  # sample Re & horizons; False → cfg.viscosity/t_end
    grf_alpha: float = 2.5
    grf_tau: float = 7.0
    grf_sigma: float | None = None
    # multiplies the Re→horizon schedule (in "schedule seconds") before it
    # maps onto solver steps via dt; 5e-4 gives 5,500–13,500 steps
    time_scale: float = 1.0
    # "float16" halves the host fetch and shard size (cast on device)
    storage_dtype: str = "float32"
    # "auto" → the CUDA CN+AB2 kernel on a CUDA device (a grid it does not
    # handle raises), "cn_ab2_packed" (the plain torch.fft stepper) on the CPU
    method: str = "auto"
    # bounded-program (chunked) mode of the TPU kernel; not ported yet, so
    # only None is accepted
    max_steps_per_program: int | None = None


def resolve_method(method: str, resolution: int, device: torch.device) -> str:
    """``"auto"`` → ``cn_ab2_cuda`` on a CUDA device, ``cn_ab2_packed`` on
    the CPU. On a CUDA device a grid the kernel does not handle raises: the
    plain stepper runs there only when asked for by name."""
    if method != "auto":
        return method
    if torch.device(device).type != "cuda":
        return "cn_ab2_packed"
    from pregen_pde_tpu_torch.solvers.spectral_ns_cuda import SUPPORTED_N, supported

    if not supported(resolution):
        raise ValueError(
            f"method 'auto' on CUDA: the CUDA CN+AB2 kernel handles n in "
            f"{SUPPORTED_N}, not {resolution} (the odd-radix FFT stage for the "
            f"other multiples of 128 is on ROADMAP.md); pass method "
            f"'cn_ab2_packed' to run the plain torch.fft stepper instead"
        )
    return "cn_ab2_cuda"


def _pack_contract(w_snaps: torch.Tensor, solver: NSVorticitySolver,
                   re_norm: torch.Tensor, mask: torch.Tensor,
                   sdf: torch.Tensor) -> torch.Tensor:
    """(B, T, n, n) vorticity → (B, T, n, n, 6) float32."""
    f = solver.fields_from_vorticity(w_snaps)
    uvp = torch.stack([f["u"], f["v"], f["p"]], dim=-1).to(torch.float32)
    return _pack_contract_uvp(uvp, re_norm, mask, sdf)


def _pack_contract_uvp(uvp: torch.Tensor, re_norm: torch.Tensor,
                       mask: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
    """(B, T, n, n, 3) [u, v, p] + (B,) Re_norm + (n, n) or (B, n, n)
    mask/SDF → (B, T, n, n, 6) float32."""
    b, t, n, _, _ = uvp.shape
    re_ch = re_norm.to(torch.float32)[:, None, None, None, None].expand(b, t, n, n, 1)
    if mask.ndim == 2:
        mask = mask[None].expand(b, n, n)
        sdf = sdf[None].expand(b, n, n)
    mask_ch = mask.to(torch.float32)[:, None, :, :, None].expand(b, t, n, n, 1)
    sdf_ch = sdf.to(torch.float32)[:, None, :, :, None].expand(b, t, n, n, 1)
    return torch.cat([uvp.to(torch.float32), re_ch, mask_ch, sdf_ch], dim=-1)


def _to_storage(arr: torch.Tensor, gen_cfg: GenerationConfig) -> torch.Tensor:
    """Cast to the storage dtype on the device, before the host fetch."""
    dt = getattr(torch, np.dtype(gen_cfg.storage_dtype).name)
    return arr if arr.dtype == dt else arr.to(dt)


def _pad_pow2(idx: np.ndarray) -> tuple[np.ndarray, int]:
    """Pad a bucket's index set to the next power of two by repeating its
    first element; returns (padded, number of real rows)."""
    n = len(idx)
    size = 1 << (n - 1).bit_length()
    return np.concatenate([idx, np.full(size - n, idx[0])]), n


def _inner_steps(horizon: float, cfg: NSVorticityConfig) -> int:
    """A horizon in schedule seconds → solver steps a snapshot interval."""
    return max(int(round(float(horizon) / cfg.dt)) // cfg.n_snapshots, 1)


def draw_batch_inputs(generator: torch.Generator, gen_cfg: GenerationConfig,
                      n_traj: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ξ (B, n, n) float32, z_re (B,) float64) on the generator's device."""
    n_traj = n_traj or gen_cfg.batch_size
    z_re = torch.randn((n_traj,), generator=generator, dtype=torch.float64,
                       device=generator.device)
    xi = draw_grf_noise(generator, n_traj, gen_cfg.solver.resolution)
    return xi, z_re


def generate_ns_batch_from_inputs(xi: torch.Tensor, z_re: torch.Tensor,
                                  gen_cfg: GenerationConfig) -> np.ndarray:
    """One batch from pre-drawn inputs, computed on ``xi.device``; returns the
    packed contract on the host in ``gen_cfg.storage_dtype``."""
    if gen_cfg.max_steps_per_program:
        raise NotImplementedError(
            "max_steps_per_program (the chunked stepper) is not ported yet"
        )
    cfg = gen_cfg.solver
    solver = NSVorticitySolver(cfg)
    dev = xi.device
    n = cfg.resolution
    n_traj = xi.shape[0]
    method = resolve_method(gen_cfg.method, n, dev)
    with span("pregen.ns.grf"):
        w0_all = grf_filter(xi.to(torch.float32), solver.grid, gen_cfg.grf_alpha,
                            gen_cfg.grf_tau, gen_cfg.grf_sigma)
    mask, sdf = no_hole_mask_and_sdf(n, str(dev))
    if method in CUDA_METHODS:
        from pregen_pde_tpu_torch.solvers.spectral_ns_cuda import build_batched_traj

        # the kernel emits (u, v, p) per snapshot directly
        traj = build_batched_traj(solver, precision=CUDA_METHODS[method],
                                  output="fields")

        def pack(uvp, re_norm):
            return _pack_contract_uvp(uvp, re_norm, mask, sdf)
    else:
        traj = solver.make_trajectory_fn_nu(method)

        def pack(w, re_norm):
            return _pack_contract(w, solver, re_norm, mask, sdf)

    def bucket(w0, nu, re_norm, inner):
        with span("pregen.ns.k1"):  # on a card it only enqueues K1
            got = traj(w0, nu, inner)
        with span("pregen.ns.pack"):
            return pack(got, re_norm)

    itemsize = np.dtype(gen_cfg.storage_dtype).itemsize

    def fetch(arr):
        with span("pregen.ns.fetch", arr.numel() * itemsize):
            return _to_storage(arr, gen_cfg).cpu().numpy()

    if not gen_cfg.vary_difficulty:
        nu = torch.full((n_traj,), cfg.viscosity, dtype=torch.float32, device=dev)
        # Re channel: the fixed-ν benchmark's effective Re = U·L/ν, U = L = 1
        re_fixed = min(max(1.0 / cfg.viscosity, schedules.RE_MIN), schedules.RE_MAX)
        re_norm = torch.full((n_traj,), schedules.normalize_re(re_fixed),
                             dtype=torch.float32, device=dev)
        return fetch(bucket(w0_all, nu, re_norm, solver.default_inner_steps()))

    re = schedules.sample_reynolds(z=z_re.to(device=dev, dtype=torch.float64),
                                   mean=gen_cfg.re_mean, std=gen_cfg.re_std)
    end_t = (schedules.end_time_from_re(re) * gen_cfg.time_scale).cpu().numpy()
    re_norm = schedules.normalize_re(re)
    nu = schedules.viscosity_from_re(re)
    if method in CUDA_METHODS:
        # the kernel takes a step count per image: the whole batch is one
        # call, each row at its own bucket's inner steps (no padding)
        inner_rows = torch.as_tensor([_inner_steps(h, cfg) for h in end_t])
        return fetch(bucket(w0_all, nu, re_norm, inner_rows))
    out = np.empty((n_traj, cfg.n_snapshots + int(cfg.include_initial), n, n, 6),
                   np.dtype(gen_cfg.storage_dtype))
    for horizon in np.unique(end_t):
        idx_raw = np.nonzero(end_t == horizon)[0]
        idx, n_real = _pad_pow2(idx_raw)
        inner = _inner_steps(horizon, cfg)
        sel = torch.as_tensor(idx, device=dev)
        res = bucket(w0_all[sel], nu[sel], re_norm[sel], inner)
        out[idx_raw] = fetch(res)[:n_real]
    return out


def generate_ns_batch(generator: torch.Generator, gen_cfg: GenerationConfig,
                      n_traj: int | None = None) -> np.ndarray:
    """Draw one batch's inputs from ``generator`` and generate it on the
    generator's device."""
    xi, z_re = draw_batch_inputs(generator, gen_cfg, n_traj)
    return generate_ns_batch_from_inputs(xi, z_re, gen_cfg)


def drop_nonfinite_trajectories(arr: np.ndarray, label: str = "batch"):
    """Drop (and log) non-finite trajectories; the rest of the batch survives."""
    finite = np.isfinite(arr).all(axis=tuple(range(1, arr.ndim)))
    n_bad = int((~finite).sum())
    if n_bad:
        logging.getLogger("pregen_pde_tpu_torch.datagen").warning(
            "%s: dropping %d/%d non-finite trajectories", label, n_bad, len(finite)
        )
        arr = arr[finite]
    return arr, n_bad


def generate_ns_dataset(generator: torch.Generator, gen_cfg: GenerationConfig,
                        n_traj: int, writer=None) -> np.ndarray | None:
    """``n_traj`` trajectories in ``batch_size`` batches. With a ``writer``
    each batch streams to a shard and None is returned; otherwise the whole
    array is assembled on the host."""
    if (
        writer is not None
        and gen_cfg.storage_dtype != "float32"
        and type(writer).__name__ == "NativeShardWriter"
    ):
        raise ValueError(
            "the native shard writer is float32-only; construct "
            f"ShardWriter(..., dtype={gen_cfg.storage_dtype!r}) so the "
            "Python writer is selected (failing now, before any compute)"
        )
    batches = []
    n_done = 0
    while n_done < n_traj:
        take = min(gen_cfg.batch_size, n_traj - n_done)
        arr, _ = drop_nonfinite_trajectories(generate_ns_batch(generator, gen_cfg, take))
        n_done += take
        if writer is not None:
            writer.write_batch(arr)
        else:
            batches.append(arr)
    if writer is not None:
        writer.close()
        return None
    return np.concatenate(batches, axis=0)
