"""Where the time goes: K2 and the masked-geometry main path on one CUDA card.

    python -m pregen_pde_tpu_torch.profile_k2 [--json out.json]

Three measurements, each printed as one line (the card's name and power
limit first) and, with ``--json``, written in full:

1. ms per step against batch for K2 and for the plain PyTorch version at
   128² with ``fpo_multi_hole`` masks (CUDA events; the difference of a
   long and a short call, so the set-up and snapshot cost cancel);
2. ``torch.profiler`` over K2 at B = 1 and B = 32 (200 steps): device busy
   time, host wall, idle share and the time by kernel. K2 is one
   cluster-resident kernel a call (``nsp_cluster_kernel``), so the trace
   names that one kernel; its phases (predictor, divergence, the four
   products, correction) run inside it and the profiler cannot split them;
3. the main path, ``generate_masked_ns_batch`` (``fpo_multi_hole``, B = 32,
   128², seed 0): its sub-buckets (size, steps, dt), the image-steps of the
   plan and of its longest trajectory (one call runs them all, so the
   longest sets the device time when the card holds every image),
   ``torch.profiler`` over the same batch at time-scale 0.05 (the same
   sub-buckets and dt with 1/20 of the steps, so the trace stays small), and
   the unprofiled wall at time-scale 1.0;
4. where a step's time goes inside the kernel: a second build of K2 with
   ``-DNSP_PHASE_CLOCKS`` adds up clock64 per phase in block 0 of image 0
   (predictor, divergence, the four products, the barriers with their
   wait, correction, halo) over 200 steps at B = 1 and B = 32, reported in
   SM cycles a step beside the step's time from CUDA events.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import time

import torch

from pregen_pde_tpu_torch.profile_k1 import _card, _ms_per_step, _profiled


PHASES = ("loop", "predictor", "divergence", "T1 = rhs CX^T", "barrier B",
          "R = (CY T1) / denom", "T2 = R CX", "barrier C", "p = CY^T T2", "barrier D",
          "correction", "barrier E", "halo")


def _phase_clocks(traj_for, masks, um, dt, steps: int = 200) -> dict:
    """SM cycles a step per phase, from the NSP_PHASE_CLOCKS build of K2,
    with the step's time by CUDA events."""
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc

    lib = build.load(npc.LIB_NAME, defines=("NSP_PHASE_CLOCKS",))
    lib.nsp_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nsp_phase_clocks.restype = ctypes.c_int
    saved = build._loaded.get(npc.LIB_NAME)
    build._loaded[npc.LIB_NAME] = lib  # the wrapper launches this build
    try:
        traj = traj_for()
        traj(masks, um, 10, dt)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        if lib.nsp_phase_clocks(buf, 1) != 0:
            raise RuntimeError("nsp_phase_clocks failed")
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        traj(masks, um, steps, dt)
        e.record()
        torch.cuda.synchronize()
        if lib.nsp_phase_clocks(buf, 0) != 0:
            raise RuntimeError("nsp_phase_clocks failed")
    finally:
        if saved is None:
            build._loaded.pop(npc.LIB_NAME, None)
        else:
            build._loaded[npc.LIB_NAME] = saved
    cycles = {name: buf[k] / steps for k, name in enumerate(PHASES)}
    return {"us_per_step": a.elapsed_time(e) / steps * 1e3,
            "cycles_per_step": sum(cycles.values()), "cycles_by_phase": cycles}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch.profile_k2")
    p.add_argument("--json", help="write the full results here")
    p.add_argument("--batches", default="1,2,4,8,16,32,64")
    args = p.parse_args(argv)

    from pregen_pde_tpu_torch.datagen.masked_ns import (
        MaskedNSConfig, draw_masked_inputs, generate_masked_ns_batch, inner_steps_for,
        new_stats, plan_rows, sample_masks)
    from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc
    from pregen_pde_tpu_torch.solvers import schedules
    from pregen_pde_tpu_torch.solvers.ns_projection import ProjectionConfig, ProjectionSolver
    from pregen_pde_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda:0")
    card = _card()
    res: dict = {"card": card, "torch": torch.__version__}
    print(card, flush=True)
    cfg = MaskedNSConfig(pipeline="fpo_multi_hole", batch_size=32)
    sol = ProjectionSolver(ProjectionConfig(resolution=128, n_snapshots=1))
    u0, dt0 = 0.0375, 0.0595  # Re 5000 and its CFL dt

    # 1. ms per step against batch
    sweep = {}
    for b in (int(x) for x in args.batches.split(",")):
        masks = sample_masks(torch.Generator(device=dev).manual_seed(b), cfg, b)
        um = torch.full((b,), u0, device=dev)
        k2 = npc.build_batched_traj(sol)
        plain = sol.make_batched_trajectory_fn()
        k2_ms = _ms_per_step(lambda s: k2(masks, um, s, dt0))
        plain_ms = _ms_per_step(lambda s: plain(masks, um, s, dt0), short=10, long=30)
        sweep[b] = {"k2_ms_per_step": k2_ms, "plain_ms_per_step": plain_ms,
                    "k2_us_per_traj_step": k2_ms * 1e3 / b,
                    "plain_us_per_traj_step": plain_ms * 1e3 / b}
        print(f"B={b}: K2 {k2_ms:.5f} ms/step ({k2_ms * 1e3 / b:.3f} us/traj-step) | "
              f"plain {plain_ms:.5f} ms/step | {card}", flush=True)
    res["ms_per_step"] = sweep

    # 2. K2 alone, profiled
    for b in (1, 32):
        masks = sample_masks(torch.Generator(device=dev).manual_seed(b), cfg, b)
        um = torch.full((b,), u0, device=dev)
        k2 = npc.build_batched_traj(sol)
        k2(masks, um, 10, dt0)  # warm-up
        npc.reset_launches()
        _, summ = _profiled(lambda: k2(masks, um, 200, dt0))
        summ["launches"] = npc.launches
        res[f"k2_B{b}"] = summ
        print(f"K2 B={b} 200 steps: {json.dumps(summ)} | {card}", flush=True)

    # 3. the main path's batch
    z_re, _ = draw_masked_inputs(torch.Generator(device=dev).manual_seed(0), cfg)
    re = schedules.sample_reynolds(z=z_re, mean=cfg.re_mean, std=cfg.re_std).cpu().numpy()
    u_max = re * cfg.viscosity / cfg.length
    end_t = schedules.end_time_from_re(torch.as_tensor(re)).numpy() * cfg.time_scale
    pr = plan_rows(u_max, end_t, cfg)
    subs = [{"size": len(idx), "horizon": h, "dt": dt,
             "steps": int(inner_steps_for(h, dt, cfg.n_snapshots)) * cfg.n_snapshots}
            for idx, h, dt in pr["plan"]]
    real = int((pr["inner"] * cfg.n_snapshots).sum())
    main = {"sub_buckets": subs, "image_steps": real,
            "longest_steps": int(pr["inner"].max()) * cfg.n_snapshots,
            "max_active_clusters": npc.max_active_clusters(128)}
    gen = lambda c, st=None: generate_masked_ns_batch(
        torch.Generator(device=dev).manual_seed(0), c, stats=st)
    short = dataclasses.replace(cfg, time_scale=0.05)
    gen(dataclasses.replace(cfg, time_scale=1e-3))  # warm-up
    npc.reset_launches()
    _, summ = _profiled(lambda: gen(short))
    summ["launches"] = npc.launches
    main["profiled_time_scale_0.05"] = summ
    stats = new_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen(cfg, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main.update(stats=stats, wall_s=wall, traj_per_s=cfg.batch_size / wall,
                us_per_image_step=wall / real * 1e6)
    res["main_path"] = main
    print(f"main path generate_masked_ns_batch fpo_multi_hole B=32 128^2 time-scale 1.0: "
          f"{json.dumps(main)} | {card}", flush=True)

    # 4. the phases of a step inside K2
    for b in (1, 32):
        masks = sample_masks(torch.Generator(device=dev).manual_seed(b), cfg, b)
        um = torch.full((b,), u0, device=dev)
        ph = _phase_clocks(lambda: npc.build_batched_traj(sol), masks, um, dt0)
        res[f"phases_B{b}"] = ph
        print(f"K2 phases B={b} 128^2 (block 0 of image 0, SM cycles a step): "
              f"{json.dumps(ph)} | {card}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
