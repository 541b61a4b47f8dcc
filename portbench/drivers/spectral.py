"""Driver of the spectral generator: the port's
``datagen.pipeline.generate_ns_batch_from_inputs(xi, z_re, gen_cfg)``, what
``generate --workload ns_spectral`` calls a batch (the GRF filter, Re → ν
and the horizons, the K1 call, the contract's packing, the storage cast and
the fetch to host memory).

Inputs, drawn in set-up from the seed on the device: a ring of batches of
white noise ξ (B, n, n) float32 and Re normals z (B,) float64
(``inputs.stratified_normals``). The check runs the frozen plain reference
(``reference.spectral``) over the kept rows from the same ξ and z.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import inputs, roofline
from portbench.reference import geometry, schedules
from portbench.reference import spectral as ref

SOLVER_KEYS = ("resolution", "length", "dt", "n_snapshots", "include_initial", "forcing",
               "forcing_amplitude", "forcing_wavenumber", "drag", "dealias")
GEN_KEYS = ("re_mean", "re_std", "vary_difficulty", "grf_alpha", "grf_tau", "grf_sigma",
            "storage_dtype", "method")


def program_config(cfg: dict, traffic: dict):
    from pregen_pde_tpu_torch.core import NSVorticityConfig
    from pregen_pde_tpu_torch.datagen.pipeline import GenerationConfig

    solver = NSVorticityConfig(**{k: cfg[k] for k in SOLVER_KEYS})
    return GenerationConfig(solver=solver, batch_size=traffic["batch_size"],
                            time_scale=traffic["time_scale"],
                            **{k: cfg[k] for k in GEN_KEYS})


class Driver:
    kernel = "k1"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from pregen_pde_tpu_torch.datagen import pipeline

        if not cfg["vary_difficulty"]:
            raise ValueError("the spectral driver runs vary_difficulty configs")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.entry = pipeline.generate_ns_batch_from_inputs
        self.gen_cfg = program_config(cfg, traffic)
        B, n, R = traffic["batch_size"], cfg["resolution"], traffic["ring_batches"]
        self.batch_size = B
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.z = inputs.stratified_normals(gen, R, B)
        self.xi = torch.randn((R, B, n, n), generator=gen, dtype=torch.float32,
                              device=device)
        # the benchmark's own reckoning of each row's steps a snapshot
        re = schedules.reynolds(self.z, cfg["re_mean"], cfg["re_std"])
        end_t = (schedules.end_time_from_re(re) * traffic["time_scale"]).cpu().numpy()
        self.inner = np.stack([schedules.spectral_inner_steps(e, cfg["dt"],
                                                              cfg["n_snapshots"])
                               for e in end_t])
        self.frames = cfg["n_snapshots"] + int(cfg["include_initial"])
        self.itemsize = np.dtype(cfg["storage_dtype"]).itemsize

    def warm_up(self) -> None:
        """Every shape of the window once, at one step a snapshot."""
        tiny = dataclasses.replace(self.gen_cfg, time_scale=1e-12)
        self.entry(self.xi[0], self.z[0], tiny)

    def run(self, b: int) -> np.ndarray:
        r = b % len(self.z)
        return self.entry(self.xi[r], self.z[r], self.gen_cfg)

    def counters(self) -> dict:
        return {}

    def batch_info(self, b: int, finite: np.ndarray) -> dict:
        n, B, T = self.cfg["resolution"], self.batch_size, self.frames
        row_flop = (roofline.k1_flop_per_image_step(n) * self.cfg["n_snapshots"]
                    * self.inner[b % len(self.z)].astype(np.float64))
        return {"kernel": self.kernel, "kernel_flop": float(row_flop.sum()),
                "kernel_bytes": roofline.k1_bytes(B, n, T),
                "delivered_flop": float(row_flop[finite].sum()),
                # the contract, and the horizons the pipeline reads back
                "fetch_bytes": float(B * T * n * n * 6 * self.itemsize + B * 8)}

    def keep(self, b: int) -> np.ndarray:
        return inputs.kept_rows(self.seed, b, self.inner[b % len(self.z)],
                                self.traffic["check_rows_per_batch"])

    def release(self) -> None:
        """Drop what only the program needed; keep the inputs."""
        if self.xi.is_cuda:
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def reference(self, items: list) -> torch.Tensor:
        """(N, T, n, n, 6) float32 contract rows by the plain reference for the
        rows of ``items`` [(window batch, rows), ...], concatenated in order,
        computed together."""
        cfg, R = self.cfg, len(self.z)
        r = np.concatenate([np.full(len(rows), b % R) for b, rows in items])
        i = np.concatenate([rows for _, rows in items])
        dev = self.xi.device
        rt, it = torch.as_tensor(r, device=dev), torch.as_tensor(i, device=dev)
        grid = ref.Grid(cfg["resolution"], cfg["length"])
        w0 = ref.grf_filter(self.xi[rt, it], grid, cfg["grf_alpha"], cfg["grf_tau"],
                            cfg["grf_sigma"])
        re = schedules.reynolds(self.z[rt, it], cfg["re_mean"], cfg["re_std"])
        nu = schedules.viscosity_from_re(re).to(torch.float32)
        w = ref.trajectory(w0, nu, self.inner[r, i], cfg)
        uvp = ref.fields(w, cfg["length"])
        n = cfg["resolution"]
        aux = torch.empty((len(i), w.shape[1], n, n, 3), dtype=torch.float32, device=dev)
        aux[..., 0] = schedules.normalize_re(re).to(torch.float32)[:, None, None, None]
        mask = torch.zeros((n, n), dtype=torch.float32, device=dev)
        aux[..., 1] = mask
        aux[..., 2] = geometry.sdf_from_mask(mask)
        return torch.cat([uvp, aux], dim=-1)

    def finishable(self, items: list) -> int:
        """How many rows of ``items`` (rows the program left non-finite) the
        reference runs to their horizon with every value finite."""
        want = self.reference(items)
        return int(torch.isfinite(want).flatten(1).all(dim=1).sum())

    def compare(self, items: list, got: np.ndarray, limits: dict) -> dict:
        """The gaps of ``got`` (the program's rows of ``items``, concatenated)
        from the reference: the widest relative L2 of u, v, p over rows,
        frames and channels, and the largest absolute difference of Re_norm,
        mask and SDF."""
        want = self.reference(items)
        g = torch.as_tensor(got, device=want.device).to(torch.float32)
        uvp = inputs.rel_l2(g[..., :3], want[..., :3], dims=(2, 3))
        aux = (g[..., 3:] - want[..., 3:]).abs()
        return {"uvp_gap": float(uvp.max()), "aux_gap": float(aux.max())}
