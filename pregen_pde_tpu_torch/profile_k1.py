"""Where the time goes: K1 and the main path on one CUDA card.

    python -m pregen_pde_tpu_torch.profile_k1 [--json out.json]

Three measurements, each printed as one line (the card's name and power
limit first) and, with ``--json``, written in full:

1. ``torch.profiler`` over K1 at the north star (256², B=32, 500 CN+AB2
   steps in 10 snapshot intervals) in vorticity and fields output: device
   busy time (the union of the kernels' intervals), host wall, idle share,
   and the row / column passes' share;
2. ms per step against batch for K1 and for the plain ``torch.fft`` stepper
   (CUDA events; the difference of a 300-step and a 100-step call, so the
   set-up and snapshot cost cancel);
3. ``torch.profiler`` over ``generate_ns_batch`` (B=32, 256², time-scale
   5e-4, seed 0): the horizon buckets, real against computed image-steps,
   wall, device busy, idle share, K1's kernels and the host fetch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _device_summary(prof, wall_s: float, top: int = 8) -> dict:
    """Busy time = union of the device events' intervals; per-name totals
    (the ``top`` names by device time)."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict[str, dict] = {}
    for e in evs:
        key = e.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
        d = by_name.setdefault(key, {"n": 0, "ms": 0.0})
        d["n"] += 1
        d["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    kernels = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:top])
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / wall_s, "top": kernels}


def _profiled(fn, top: int = 8):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, _device_summary(prof, wall, top)


def _ms_per_step(fn, short: int = 100, long: int = 300) -> float:
    def run(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(steps)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    run(short)  # warm-up
    return (run(long) - run(short)) / (long - short)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch.profile_k1")
    p.add_argument("--json", help="write the full results here")
    p.add_argument("--batches", default="1,2,4,8,16,32,64")
    args = p.parse_args(argv)

    from pregen_pde_tpu_torch.core import NSVorticityConfig
    from pregen_pde_tpu_torch.datagen.pipeline import (
        GenerationConfig, _pad_pow2, draw_batch_inputs, generate_ns_batch)
    from pregen_pde_tpu_torch.fields.grf import grf_2d
    from pregen_pde_tpu_torch.solvers import schedules
    from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as snc
    from pregen_pde_tpu_torch.solvers.spectral_ns import NSVorticitySolver
    from pregen_pde_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda:0")
    card = _card()
    res: dict = {"card": card, "torch": torch.__version__}
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1. K1 at the north star, profiled
    sol = NSVorticitySolver(NSVorticityConfig(resolution=256, viscosity=1e-4, dt=1e-4,
                                              t_end=0.05, n_snapshots=10, forcing="fno"))
    w0 = grf_2d(gen, sol.grid, 32)
    for output in ("vorticity", "fields"):
        traj = snc.build_batched_traj(sol, output=output)
        traj(w0, None, 1)  # warm-up: build, constants, allocator
        snc.reset_launches()
        _, summ = _profiled(lambda: traj(w0))
        summ["launches"] = snc.launches
        res[f"north_star_{output}"] = summ
        print(f"north star K1 {output} B=32 500 steps + 10 snapshots: "
              f"{json.dumps(summ)} | {card}", flush=True)

    # 2. ms per step against batch
    sweep = {}
    for b in (int(x) for x in args.batches.split(",")):
        sol1 = NSVorticitySolver(NSVorticityConfig(resolution=256, n_snapshots=1,
                                                   include_initial=False))
        wb = grf_2d(gen, sol1.grid, b)
        k1 = snc.build_batched_traj(sol1)
        k1_ms = _ms_per_step(lambda s: k1(wb, None, s))
        plain_ms = _ms_per_step(lambda s: sol1._build_traj_packed(s, scheme="ab2")(wb, None))
        sweep[b] = {"k1_ms_per_step": k1_ms, "plain_ms_per_step": plain_ms}
        print(f"B={b}: K1 {k1_ms:.5f} ms/step | plain {plain_ms:.5f} ms/step | {card}",
              flush=True)
    res["ms_per_step"] = sweep

    # 3. the main path's batch, profiled
    cfg = GenerationConfig(solver=NSVorticityConfig(resolution=256), batch_size=32,
                           time_scale=5e-4)
    xi, z_re = draw_batch_inputs(torch.Generator(device=dev).manual_seed(0), cfg)
    re = schedules.sample_reynolds(z=z_re, mean=cfg.re_mean, std=cfg.re_std)
    end_t = (schedules.end_time_from_re(re) * cfg.time_scale).cpu().numpy()
    buckets = []
    for h in np.unique(end_t):
        idx, n_real = _pad_pow2(np.nonzero(end_t == h)[0])
        inner = max(int(round(float(h) / cfg.solver.dt)) // cfg.solver.n_snapshots, 1)
        buckets.append({"real": n_real, "padded": len(idx),
                        "steps": inner * cfg.solver.n_snapshots})
    real = sum(b["real"] * b["steps"] for b in buckets)
    computed = sum(b["padded"] * b["steps"] for b in buckets)
    generate_ns_batch(torch.Generator(device=dev).manual_seed(0), cfg, 1)  # warm-up
    snc.reset_launches()
    out, summ = _profiled(
        lambda: generate_ns_batch(torch.Generator(device=dev).manual_seed(0), cfg))
    summ.update(launches=snc.launches, buckets=buckets, image_steps_real=real,
                image_steps_computed=computed, traj_per_s=32 / (summ["wall_ms"] / 1e3),
                out_shape=list(out.shape))
    t0 = time.perf_counter()
    generate_ns_batch(torch.Generator(device=dev).manual_seed(0), cfg)
    summ["unprofiled_wall_s"] = time.perf_counter() - t0
    res["main_path"] = summ
    print(f"main path generate_ns_batch B=32 256^2 time-scale 5e-4: {json.dumps(summ)} "
          f"| {card}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
