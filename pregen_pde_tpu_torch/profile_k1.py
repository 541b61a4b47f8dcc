"""Where the time goes: K1 and the main path on one CUDA card.

    python -m pregen_pde_tpu_torch.profile_k1 [--json out.json]

Four measurements, each printed as one line (the card's name and power
limit first) and, with ``--json``, written in full:

1. ``torch.profiler`` over K1 at the north star (256², B=32, 500 CN+AB2
   steps in 10 snapshot intervals) in vorticity and fields output: device
   busy time (the union of the kernels' intervals), host wall, idle share,
   and the time by kernel (the resident kernel is one launch a call);
2. ms per step against batch at 256² for the resident kernel, the chain
   and the plain ``torch.fft`` stepper (CUDA events; the difference of a
   300-step and a 100-step call, so the set-up and snapshot cost cancel);
3. the main path's batch (B=32, 256², time-scale 5e-4, seed 0): its
   horizon buckets, real against padded image-steps; ``torch.profiler``
   over the stepper alone as the one call ``generate_ns_batch`` makes,
   as per-bucket calls of the resident kernel (padded to powers of two, as
   the buckets ran before), and as per-bucket calls of the chain: wall,
   device busy, idle share, and the time by CUDA events of a second,
   unprofiled run; then ``generate_ns_batch`` itself, profiled
   and unprofiled (the contract packing and the host fetch included);
4. where a step's time goes inside the resident kernel: a second build
   with ``-DSNS_PHASE_CLOCKS`` adds up clock64 per phase in thread 0 of
   block 0 of the first cluster (packs and the inverse FFT along y, the
   barriers with their wait, the two exchanges' DSMEM reads, the line
   transforms, the product, the update) over 300 steps at B = 1 and
   B = 32, reported in SM cycles a step beside the step's time from CUDA
   events. A phase ends when its last instruction issues: a DSMEM read is
   waited for in the transform that uses it.
"""

from __future__ import annotations

import argparse
import ctypes
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


PHASES = ("loop, frames", "packs, inverse y, X1 writes", "barrier A", "exchange: X1 reads",
          "inverse x", "product", "forward x, G writes", "barrier B", "exchange: G reads",
          "forward y", "update")


def _phase_clocks(sol, w0, steps: int = 300) -> dict:
    """SM cycles a step per phase, from the SNS_PHASE_CLOCKS build of the
    resident kernel, with the step's time by CUDA events."""
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as snc

    lib = build.load(snc.LIB_NAME, defines=("SNS_PHASE_CLOCKS",))
    lib.sns_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sns_phase_clocks.restype = ctypes.c_int
    saved = build._loaded.get(snc.LIB_NAME)
    build._loaded[snc.LIB_NAME] = lib  # the wrapper launches this build
    try:
        traj = snc.build_batched_traj(sol)
        traj(w0, None, 10)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        if lib.sns_phase_clocks(buf, 1) != 0:
            raise RuntimeError("sns_phase_clocks failed")
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        traj(w0, None, steps)
        e.record()
        torch.cuda.synchronize()
        if lib.sns_phase_clocks(buf, 0) != 0:
            raise RuntimeError("sns_phase_clocks failed")
    finally:
        if saved is None:
            build._loaded.pop(snc.LIB_NAME, None)
        else:
            build._loaded[snc.LIB_NAME] = saved
    cycles = {name: buf[k] / steps for k, name in enumerate(PHASES)}
    return {"us_per_step": a.elapsed_time(e) / steps * 1e3,
            "cycles_per_step": sum(cycles.values()), "cycles_by_phase": cycles}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch.profile_k1")
    p.add_argument("--json", help="write the full results here")
    p.add_argument("--batches", default="1,2,4,8,16,32,64")
    args = p.parse_args(argv)

    from pregen_pde_tpu_torch.core import NSVorticityConfig
    from pregen_pde_tpu_torch.datagen.pipeline import (
        GenerationConfig, _inner_steps, _pad_pow2, draw_batch_inputs, generate_ns_batch)
    from pregen_pde_tpu_torch.fields.grf import grf_2d, grf_filter
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
    sol1 = NSVorticitySolver(NSVorticityConfig(resolution=256, n_snapshots=1,
                                               include_initial=False))
    for b in (int(x) for x in args.batches.split(",")):
        wb = grf_2d(gen, sol1.grid, b)
        k1 = snc.build_batched_traj(sol1)
        k1c = snc.build_batched_traj(sol1, route="chain")
        k1_ms = _ms_per_step(lambda s: k1(wb, None, s))
        chain_ms = _ms_per_step(lambda s: k1c(wb, None, s))
        plain_ms = _ms_per_step(lambda s: sol1._build_traj_packed(s, scheme="ab2")(wb, None))
        sweep[b] = {"resident_ms_per_step": k1_ms, "chain_ms_per_step": chain_ms,
                    "plain_ms_per_step": plain_ms}
        print(f"B={b}: K1 resident {k1_ms:.5f} ms/step | chain {chain_ms:.5f} ms/step | "
              f"plain {plain_ms:.5f} ms/step | {card}", flush=True)
    res["ms_per_step"] = sweep

    # 3. the main path's batch: one call against per-bucket calls
    cfg = GenerationConfig(solver=NSVorticityConfig(resolution=256), batch_size=32,
                           time_scale=5e-4)
    xi, z_re = draw_batch_inputs(torch.Generator(device=dev).manual_seed(0), cfg)
    re = schedules.sample_reynolds(z=z_re, mean=cfg.re_mean, std=cfg.re_std)
    end_t = (schedules.end_time_from_re(re) * cfg.time_scale).cpu().numpy()
    S = cfg.solver.n_snapshots
    buckets = []
    for h in np.unique(end_t):
        idx, n_real = _pad_pow2(np.nonzero(end_t == h)[0])
        buckets.append({"real": n_real, "padded": len(idx), "idx": idx.tolist(),
                        "inner": _inner_steps(h, cfg.solver)})
    real = sum(b["real"] * b["inner"] * S for b in buckets)
    padded = sum(b["padded"] * b["inner"] * S for b in buckets)
    msol = NSVorticitySolver(cfg.solver)
    w0_all = grf_filter(xi.to(torch.float32), msol.grid, cfg.grf_alpha, cfg.grf_tau,
                        cfg.grf_sigma)
    nu = schedules.viscosity_from_re(re).to(torch.float32)
    inner_rows = torch.as_tensor([_inner_steps(h, cfg.solver) for h in end_t])
    main: dict = {"buckets": [{k: v for k, v in b.items() if k != "idx"} for b in buckets],
                  "image_steps_real": real, "image_steps_padded": padded,
                  "longest_trajectory_steps": int(inner_rows.max()) * S}
    routes = {"resident": snc.build_batched_traj(msol, output="fields"),
              "chain": snc.build_batched_traj(msol, output="fields", route="chain")}
    routes["resident"](w0_all[:1], nu[:1], 1)  # warm-up
    routes["chain"](w0_all[:1], nu[:1], 1)

    def per_bucket(traj):
        for bk in buckets:
            sel = torch.as_tensor(bk["idx"], device=dev)
            traj(w0_all[sel], nu[sel], bk["inner"])

    for label, fn in (("one_call", lambda: routes["resident"](w0_all, nu, inner_rows)),
                      ("per_bucket_resident", lambda: per_bucket(routes["resident"])),
                      ("per_bucket_chain", lambda: per_bucket(routes["chain"]))):
        snc.reset_launches()
        _, summ = _profiled(fn)
        summ["launches"] = snc.launches
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        summ["event_ms"] = a.elapsed_time(e)  # unprofiled, CUDA events
        main[label] = summ
        print(f"main path's batch, stepper only, {label}: {json.dumps(summ)} | {card}",
              flush=True)
    generate_ns_batch(torch.Generator(device=dev).manual_seed(0), cfg, 1)  # warm-up
    snc.reset_launches()
    out, summ = _profiled(
        lambda: generate_ns_batch(torch.Generator(device=dev).manual_seed(0), cfg))
    summ.update(launches=snc.launches, traj_per_s=32 / (summ["wall_ms"] / 1e3),
                out_shape=list(out.shape))
    t0 = time.perf_counter()
    generate_ns_batch(torch.Generator(device=dev).manual_seed(0), cfg)
    summ["unprofiled_wall_s"] = time.perf_counter() - t0
    main["generate_ns_batch"] = summ
    res["main_path"] = main
    print(f"main path generate_ns_batch B=32 256^2 time-scale 5e-4: {json.dumps(summ)} "
          f"| {card}", flush=True)

    # 4. clock64 per phase of a step inside the resident kernel
    clocks = {}
    for b in (1, 32):
        clocks[b] = _phase_clocks(sol1, grf_2d(gen, sol1.grid, b))
        print(f"phase clocks 256^2 B={b} (SM cycles a step, thread 0 of block 0 of the "
              f"first cluster): {json.dumps(clocks[b])} | {card}", flush=True)
    res["phase_clocks"] = clocks
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
