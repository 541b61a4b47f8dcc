"""Driver of the masked-geometry generator: the port's
``datagen.masked_ns.generate_masked_ns_batch_from_inputs(z_re, masks, cfg,
storage_dtype, stats)``, what ``generate --workload fpo_multi_hole`` calls a
batch (Re → Umax and the horizons, the SDFs, the CFL plan, the K2 call, the
storage cast, the fetch, the dt/2 retries of non-finite rows and the
contract's assembly on the host).

Inputs, drawn in set-up from the seed on the device: a ring of batches of
Re normals z (B,) float64 (``inputs.stratified_normals``) and hole masks
(B, n, n) by the frozen sampler (``reference.geometry``).

The check follows the program's own frames: the flow sheds vortices, and two
right float32 solvers drift apart over a whole trajectory of 10⁴ steps, so
the plain reference (``reference.projection``) starts each snapshot interval
from the program's frame and is compared with its next frame. Frame 0 (rest
and the boundary conditions), Re_norm, the mask and the SDF are compared
exactly. A row's dt is the reference's own plan's; a row whose frames no
run at that dt explains is judged at dt/2, and so on, as the pipeline's
retries would have re-run it. A row the program leaves non-finite is a
fault where the reference, run whole from rest, finishes it at some dt of
the pipeline's ladder.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import inputs, roofline
from portbench.reference import geometry, plan, projection, schedules

# the least float32 gap a ratio divides by: below the smallest that plain
# float32 read from float64 on a row on the card, 1.8e-6 (PERF.md)
RATIO_FLOOR = 1e-6
PROGRAM_KEYS = ("pipeline", "resolution", "length", "viscosity", "dt", "n_snapshots",
                "re_mean", "re_std", "penalization_eta", "cg_iters", "hole_overlap",
                "cfl_speedup", "nonfinite_retries", "per_traj_dt")


def program_config(cfg: dict, traffic: dict):
    from pregen_pde_tpu_torch.datagen.masked_ns import MaskedNSConfig

    return MaskedNSConfig(batch_size=traffic["batch_size"], time_scale=traffic["time_scale"],
                          **{k: cfg[k] for k in PROGRAM_KEYS})


class Driver:
    kernel = "k2"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from pregen_pde_tpu_torch.datagen import masked_ns

        if cfg["pipeline"] != "fpo_multi_hole" or cfg["hole_overlap"]:
            raise ValueError("the masked driver runs fpo_multi_hole without overlap")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.entry = masked_ns.generate_masked_ns_batch_from_inputs
        self.prog_cfg = program_config(cfg, traffic)
        self.stats = masked_ns.new_stats()
        B, n, R = traffic["batch_size"], cfg["resolution"], traffic["ring_batches"]
        self.batch_size = B
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.z = inputs.stratified_normals(gen, R, B)
        self.masks = geometry.sample_multi_holes(
            gen, R * B, n, cfg["min_holes"], cfg["max_holes"], cfg["hole_cells"],
            cfg["max_attempts"]).reshape(R, B, n, n)
        # the benchmark's own plan of every row
        re = schedules.reynolds(self.z, cfg["re_mean"], cfg["re_std"])
        self.re = re.cpu().numpy()
        self.u_max = self.re * cfg["viscosity"] / cfg["length"]
        end_t = (schedules.end_time_from_re(re).cpu().numpy() * traffic["time_scale"])
        self.plans = [plan.plan_rows(self.u_max[r], end_t[r], cfg) for r in range(R)]
        self.frames = cfg["n_snapshots"] + 1
        self.itemsize = np.dtype(cfg["storage_dtype"]).itemsize
        self._retried_before = 0

    def warm_up(self) -> None:
        """Every shape of the first pass once, at one step a snapshot."""
        tiny = dataclasses.replace(self.prog_cfg, time_scale=1e-12)
        self.entry(self.z[0], self.masks[0], tiny, self.cfg["storage_dtype"])

    def run(self, b: int) -> np.ndarray:
        self._retried_before = self.stats["retried_trajectories"]
        r = b % len(self.z)
        return self.entry(self.z[r], self.masks[r], self.prog_cfg, self.cfg["storage_dtype"],
                          self.stats)

    def counters(self) -> dict:
        return dict(self.stats)

    def batch_info(self, b: int, finite: np.ndarray) -> dict:
        n, B, T, S = self.cfg["resolution"], self.batch_size, self.frames, self.cfg["n_snapshots"]
        inner = self.plans[b % len(self.z)]["inner"].astype(np.float64)
        row_flop = roofline.k2_flop_per_image_step(n) * S * inner
        retried = self.stats["retried_trajectories"] - self._retried_before
        frame_bytes = T * n * n * 3 * self.itemsize
        return {"kernel": self.kernel, "kernel_flop": float(row_flop.sum()),
                "kernel_bytes": roofline.k2_bytes(B, n, T),
                "delivered_flop": float(row_flop[finite].sum()),
                # the first pass's and the retries' frames, the masks and
                # SDFs, and Re, the horizons and Re_norm read back
                "fetch_bytes": float((B + retried) * frame_bytes + 2 * B * n * n * 4
                                     + 3 * B * 8)}

    def keep(self, b: int) -> np.ndarray:
        return inputs.kept_rows(self.seed, b, self.plans[b % len(self.z)]["inner"],
                                self.traffic["check_rows_per_batch"])

    def release(self) -> None:
        if self.masks.is_cuda:
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def _index(self, items: list) -> tuple[np.ndarray, np.ndarray]:
        """(ring batch, row) of each row of ``items`` [(window batch, rows), ...]."""
        R = len(self.z)
        return (np.concatenate([np.full(len(rows), b % R) for b, rows in items]),
                np.concatenate([rows for _, rows in items]))

    def _row(self, key: str, r: np.ndarray, i: np.ndarray) -> np.ndarray:
        return np.array([self.plans[a][key][b] for a, b in zip(r, i)])

    def _channel(self, r, i, attempt, repeat: int = 1, dtype: torch.dtype = torch.float32):
        dev = self.masks.device
        rep = lambda t: t.repeat_interleave(repeat, dim=0)
        rt, it = torch.as_tensor(r, device=dev), torch.as_tensor(i, device=dev)
        dt = self._row("dt", r, i) / 2.0 ** attempt
        return projection.Channel(
            self.cfg, rep(self.masks[rt, it]),
            rep(torch.as_tensor(self.u_max[r, i], dtype=torch.float32, device=dev)),
            rep(torch.as_tensor(dt, dtype=torch.float32, device=dev)), dtype=dtype)

    def _inner(self, r, i, attempt) -> np.ndarray:
        return plan.inner_steps_for(self._row("horizon", r, i),
                                    self._row("dt", r, i) / 2.0 ** attempt,
                                    self.cfg["n_snapshots"])

    def _exact(self, r, i) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, n, n, 3) [Re_norm, mask, SDF] and (N, n, n, 3) frame 0."""
        dev = self.masks.device
        mask = self.masks[torch.as_tensor(r, device=dev), torch.as_tensor(i, device=dev)]
        n = mask.shape[-1]
        re = torch.as_tensor(self.re[r, i], dtype=torch.float64, device=dev)
        re_norm = schedules.normalize_re(re).to(torch.float32)[:, None, None]
        aux = torch.stack([re_norm.expand(len(i), n, n), mask, geometry.sdf_from_mask(mask)],
                          dim=-1)
        u, v, p = self._channel(r, i, np.zeros(len(i))).rest()
        return aux, torch.stack([u, v, p], dim=-1)

    def finishable(self, items: list) -> int:
        """How many rows of ``items`` (rows the program left non-finite) the
        plain reference, in float32 from rest, runs to their horizon with
        every snapshot finite (the pipeline's test of a pass) at some dt of
        the pipeline's ladder: the plan's, then /2 per retry."""
        r, i = self._index(items)
        done = np.zeros(len(i), dtype=bool)
        for a in range(self.cfg["nonfinite_retries"] + 1):
            todo = np.nonzero(~done)[0]
            if not len(todo):
                break
            at = np.full(len(todo), a)
            ch = self._channel(r[todo], i[todo], at)
            inner = self._inner(r[todo], i[todo], at)
            u, v, _ = ch.rest()
            ok = torch.ones(len(todo), dtype=torch.bool, device=u.device)
            for _ in range(self.cfg["n_snapshots"]):
                u, v, p = ch.advance(u, v, inner)
                ok &= torch.isfinite(torch.stack([u, v, p], dim=1)).flatten(1).all(dim=1)
                if not bool(ok.any()):
                    break
            done[todo] = ok.cpu().numpy()
        return int(done.sum())

    def compare(self, items: list, got: np.ndarray, limits: dict) -> dict:
        """The gaps of ``got`` (the program's rows of ``items``, concatenated).

        ``uvp_ratio``: each snapshot interval is run from the program's frame
        before it by the plain reference in float64 and in float32; the
        program's relative L2 gap from the float64 run, over the float32
        run's own gap from it (at least ``RATIO_FLOOR``), is the program's
        distance from exact arithmetic in units of a sound float32
        solver's. Its widest over intervals and u, v, p is a row's reading at
        a dt. A row is read at its plan's dt, then, while its reading is
        above the limit of ``uvp_ratio`` in ``limits``, at dt/2 and dt/4 (a
        retry's dt): the first dt within the limit is the attempt its frames
        show, and a row that none explains keeps its least reading. The
        number is the widest row's. ``aux_gap``: the largest absolute
        difference of frame 0 and of Re_norm, mask and SDF."""
        stop = limits["uvp_ratio"]
        r, i = self._index(items)
        dev = self.masks.device
        g = torch.as_tensor(got, device=dev).to(torch.float32)
        S = self.cfg["n_snapshots"]
        aux, frame0 = self._exact(r, i)
        aux_gap = max(float((g[..., 3:] - aux[:, None]).abs().max()),
                      float((g[:, 0, ..., :3] - frame0).abs().max()))
        best = np.full(len(i), np.inf)
        shown = np.zeros(len(i), dtype=np.int64)
        todo = np.arange(len(i))
        for a in range(self.cfg["nonfinite_retries"] + 1):
            if not len(todo):
                break
            at = np.full(len(todo), a)
            steps = np.repeat(self._inner(r[todo], i[todo], at), S)
            start = g[todo, :S].reshape(len(todo) * S, *g.shape[2:])
            runs = []
            for dtype in (torch.float64, torch.float32):
                ch = self._channel(r[todo], i[todo], at, repeat=S, dtype=dtype)
                x = start.to(dtype)
                runs.append(torch.stack(ch.advance(x[..., 0], x[..., 1], steps), dim=-1)
                            .reshape(len(todo), S, *g.shape[2:4], 3))
            w64, w32 = runs
            prog = g[todo, 1:, ..., :3].to(torch.float64)
            gap_prog = inputs.rel_l2(prog, w64, dims=(2, 3))
            gap_f32 = inputs.rel_l2(w32.to(torch.float64), w64, dims=(2, 3))
            ratio = gap_prog / gap_f32.clamp(min=RATIO_FLOOR)
            ratio = torch.where(torch.isfinite(ratio), ratio, torch.full_like(ratio, np.inf))
            reading = ratio.flatten(1).amax(dim=1).cpu().numpy()
            within = reading <= stop
            shown[todo[within]] = a
            better = within | (reading < best[todo])
            best[todo[better]] = reading[better]
            todo = todo[~within]
        return {"uvp_ratio": float(best.max()), "aux_gap": aux_gap,
                "retried_rows": float((shown > 0).sum())}
