#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure exits nonzero; no phase catches a failure):

1. identify the card (``nvidia-smi`` name and power limit);
2. build the CUDA kernels from ``pregen_pde_tpu_torch/csrc`` (seconds printed);
3. the kernel's 2-D forward/inverse FFT passes vs ``torch.fft`` in float64,
   n ∈ {128, 256, 512, 1024}: relative L2 ≤ 2e-6;
4. K1 (the CN+AB2 stepper) vs its plain version at the north-star
   configuration (256², ν-scan, dt 1e-4, 2500 steps, 50 snapshots, FNO
   forcing), B=4: per-snapshot relative L2 against the float64 plain
   version (worst over the batch), in vorticity and fields output; bars at
   snapshot 50: ≤ 2× the plain float32 path's own error and ≤ 2.6e-4 (the
   f32 floor on record is 1.28e-4, PERF_TPU_HISTORY.md:792-818); and K1
   against the plain float32 version on the same inputs, ≤ 1e-5 at every
   snapshot. Then the main path's shape: B=8, fields, 20 snapshots × 275
   steps (the shortest horizon at time-scale 5e-4), ν = 1/Re across the
   Re range, K1 vs plain float32 ≤ 1e-5 at every snapshot;
5. the main path: ``python -m pregen_pde_tpu_torch generate --workload
   ns_spectral --n 32 --resolution 256 --batch-size 32`` in a subprocess,
   whose shard must be (32, 21, 256, 256, 6), finite, mask ≡ 0, SDF ≡ 1,
   Re_norm in [0, 1], and whose K1 launch count must be > 0;
6. north-star throughput (B=32) of K1 and of the plain version in both
   outputs, and K1 vs plain float32 on those inputs (relative L2 ≤ 1e-5 at
   every snapshot).

The 1e-5 bar of K1 against the plain float32 version is about 30× what the
two differ by when both are right (2.4e-7 vorticity, 3.6e-7 fields at the
north star, NVIDIA H100): a kernel error of its own of 1e-5 fails it.

Prints a kernels JSON line and the card line, then, as its last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FFT_BAR = 2e-6
K1_ABS_BAR = 2.6e-4
K1_VS_PLAIN_BAR = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: rc {r.returncode} {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 1):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to test",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    try:
        import pregen_pde_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        sys.exit(3)
    import numpy as np

    from pregen_pde_tpu_torch.core import NSVorticityConfig
    from pregen_pde_tpu_torch.datagen.writer import load_shards
    from pregen_pde_tpu_torch.fields.grf import grf_2d
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.solvers import schedules
    from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as snc
    from pregen_pde_tpu_torch.solvers.spectral_ns import NSVorticitySolver
    from pregen_pde_tpu_torch.utils.device import resolve_device, set_precision_policy
    from pregen_pde_tpu_torch.utils.parity import per_snapshot_rel_l2, rel_l2

    # -- 1. the card ----------------------------------------------------------
    card = card_line()
    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    say(f"[1] card: {card} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {json.dumps(set_precision_policy(dev))}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.load(snc.LIB_NAME)
    say(f"[2] built {snc.LIB_NAME} (sm_90a) in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds[snc.LIB_NAME]:.2f} s)")

    # -- 3. FFT passes vs torch.fft in float64 ----------------------------------
    gcpu = torch.Generator().manual_seed(0)
    for n in snc.SUPPORTED_N:
        x = torch.complex(torch.randn(2, n, n, generator=gcpu),
                          torch.randn(2, n, n, generator=gcpu))
        x64 = x.to(torch.complex128)
        xd = x.to(dev)
        for inverse, ref in ((False, torch.fft.fft2(x64)), (True, torch.fft.ifft2(x64))):
            got = snc.fft2(xd, inverse=inverse)
            torch.cuda.synchronize()
            err = rel_l2(torch.view_as_real(got.cpu()), torch.view_as_real(ref))
            say(f"[3] fft2 n={n} {'inverse' if inverse else 'forward'}: "
                f"rel L2 {err:.3e} (bar {FFT_BAR:.0e})")
            if not err <= FFT_BAR:
                fail(f"fft2 n={n} inverse={inverse} rel L2 {err} > {FFT_BAR}")

    # -- 4. K1 vs its plain version at the north-star configuration ------------
    cfg = NSVorticityConfig(resolution=256, viscosity=1e-4, dt=1e-4, t_end=0.25,
                            n_snapshots=50, forcing="fno", include_initial=True)
    sol = NSVorticitySolver(cfg)
    gdev = torch.Generator(device=dev).manual_seed(0)
    w0_4 = grf_2d(gdev, sol.grid, 4)
    nu_4 = torch.tensor([1e-4, 2e-4, 5e-4, 1e-3], device=dev)

    def plain(solver, w0, nu, fields, steps=None):
        snaps = solver._build_traj_packed(steps, scheme="ab2")(w0, nu)
        if not fields:
            return snaps
        f = solver.fields_from_vorticity(snaps)
        return torch.stack([f["u"], f["v"], f["p"]], dim=-1)

    def k1_vs_plain(k1, p32, label):
        """K1 against the plain float32 version on the same inputs."""
        err = per_snapshot_rel_l2(k1, p32)
        if not err.max() <= K1_VS_PLAIN_BAR:
            fail(f"K1 vs plain f32 ({label}): worst snapshot {err.max():.3e} > "
                 f"{K1_VS_PLAIN_BAR:.0e} (per snapshot: {err.tolist()})")
        return err

    for output in ("vorticity", "fields"):
        fields = output == "fields"
        oracle = plain(sol, w0_4.double(), nu_4.double(), fields)
        p32 = plain(sol, w0_4, nu_4, fields)
        k1 = snc.build_batched_traj(sol, output=output)(w0_4, nu_4)
        torch.cuda.synchronize()
        if not torch.isfinite(k1).all():
            fail(f"K1 {output}: non-finite output")
        e_k1 = per_snapshot_rel_l2(k1, oracle)
        e_p32 = per_snapshot_rel_l2(p32, oracle)
        e_kp = k1_vs_plain(k1, p32, f"north star, {output}, B=4")
        for s in (1, 25, 50):
            say(f"[4] {output} snapshot {s}: K1 {e_k1[s]:.3e} | plain f32 "
                f"{e_p32[s]:.3e} (vs plain f64) | K1 vs plain f32 {e_kp[s]:.3e}")
        if not (e_k1[50] <= 2 * e_p32[50] and e_k1[50] <= K1_ABS_BAR):
            fail(f"K1 {output} snapshot 50 error {e_k1[50]:.3e} vs plain f32 "
                 f"{e_p32[50]:.3e} (bars: ≤ 2× plain, ≤ {K1_ABS_BAR})")
        say(f"[4] {output}: K1 vs plain f32 worst snapshot {e_kp.max():.3e} "
            f"(bar {K1_VS_PLAIN_BAR:.0e})")

    # the main path's shape: what one horizon bucket of `generate` runs
    sol_m = NSVorticitySolver(NSVorticityConfig(resolution=256, forcing="fno"))
    w0_8 = grf_2d(gdev, sol_m.grid, 8)
    re_8 = torch.linspace(schedules.RE_MIN, schedules.RE_MAX, 8, dtype=torch.float64)
    nu_8 = schedules.viscosity_from_re(re_8).to(device=dev, dtype=torch.float32)
    k1 = snc.build_batched_traj(sol_m, output="fields")(w0_8, nu_8, 275)
    p32 = plain(sol_m, w0_8, nu_8, True, steps=275)
    torch.cuda.synchronize()
    if not torch.isfinite(k1).all():
        fail("K1 fields at the main path's shape: non-finite output")
    e_kp = k1_vs_plain(k1, p32, "main-path shape, fields, B=8")
    say(f"[4] main-path shape (fields, B=8, 20 × 275 steps, Re 100…10000): "
        f"K1 vs plain f32 snapshots 1 / 10 / 20: {e_kp[1]:.3e} / {e_kp[10]:.3e} / "
        f"{e_kp[20]:.3e}, worst {e_kp.max():.3e} (bar {K1_VS_PLAIN_BAR:.0e})")
    say(f"[4] precision tiers -> kernel path: {json.dumps(snc.PRECISIONS)} "
        f"(all three run the one float32 CUDA-core path)")

    # -- 5. the main path, through the CLI ----------------------------------------
    snc.reset_launches()
    work = tempfile.mkdtemp(prefix="smoke_", dir=build.BUILD_DIR)
    try:
        env = dict(os.environ, PREGEN_PDE_TPU_CACHE=os.path.join(work, "native"))
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "generate",
               "--workload", "ns_spectral", "--n", "32", "--resolution", "256",
               "--batch-size", "32", "--out", os.path.join(work, "ns")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=900)
        gen_s = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"generate rc {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        counts = [json.loads(l)["kernel_launches"] for l in r.stdout.splitlines()
                  if l.startswith('{"kernel_launches"')]
        if len(counts) != 1:
            fail(f"generate printed no launch line:\n{r.stdout[-2000:]}")
        launches = int(counts[0][snc.LIB_NAME])
        data = load_shards(os.path.join(work, "ns"))
        if data.shape != (32, 21, 256, 256, 6):
            fail(f"shard shape {data.shape}")
        if not np.isfinite(data).all():
            fail("shard holds non-finite values")
        if not ((data[..., 4] == 0).all() and (data[..., 5] == 1).all()):
            fail("mask/SDF channels are not 0/1")
        re = data[..., 3]
        if not ((re >= 0).all() and (re <= 1).all()):
            fail("Re_norm outside [0, 1]")
        if launches <= 0:
            fail("the main path never launched K1")
        say(f"[5] generate --n 32 --resolution 256 --batch-size 32 (time-scale "
            f"5e-4, varied difficulty): {gen_s:.2f} s wall incl. start-up and "
            f"build, {32 / gen_s:.3f} traj/s; K1 launches {launches}; shard "
            f"{data.shape} finite, mask 0, SDF 1, Re_norm in "
            f"[{re.min():.4f}, {re.max():.4f}] | {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 6. north-star throughput, B=32 -------------------------------------------
    w0 = grf_2d(gdev, sol.grid, 32)
    times = {}
    outs = {}
    for output in ("vorticity", "fields"):
        fields = output == "fields"
        k1 = snc.build_batched_traj(sol, output=output)
        k1(w0, None, 1)  # warm-up: constants, allocator, FFT plans
        plain(sol, w0, None, fields, steps=1)
        outs[output, "k1"], times[output, "k1"] = timed(lambda: k1(w0))
        outs[output, "plain"], times[output, "plain"] = timed(
            lambda: plain(sol, w0, None, fields))
        err = k1_vs_plain(outs[output, "k1"], outs[output, "plain"],
                          f"north star, {output}, B=32")
        say(f"[6] north star {output} B=32 2500 steps: K1 "
            f"{32 / times[output, 'k1']:.3f} traj/s ({times[output, 'k1'] * 1e3:.1f} ms) | "
            f"plain {32 / times[output, 'plain']:.3f} traj/s "
            f"({times[output, 'plain'] * 1e3:.1f} ms) | K1 vs plain f32 max "
            f"per-snapshot rel L2 {err.max():.3e} | {card}")
    max_abs = float((outs["fields", "k1"] - outs["fields", "plain"]).abs().max())

    say(json.dumps({"kernels": [{
        "name": snc.LIB_NAME,
        "route": "cuda",
        "source": "pregen_pde_tpu_torch/csrc/spectral_ns_step.cu",
        "replaces": "pregen_pde_tpu/solvers/spectral_ns_pallas.py:511",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": times["fields", "k1"] * 1e3,
        "plain_ms": times["fields", "plain"] * 1e3,
    }]}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
