"""CLI of the PyTorch port:

    python -m pregen_pde_tpu_torch generate --workload ns_spectral --n 256 --out dir/
    python -m pregen_pde_tpu_torch generate --workload fpo_multi_hole --n 128 \
        --time-scale 1.0 --out dir/

Same ``generate`` flags as ``python -m pregen_pde_tpu generate`` for the
spectral-NS workload and the four masked-geometry workloads (fpo_regular,
fpo_hole, fpo_multi_hole, ldc_regular), plus ``--device`` (default
``cuda``; raises when CUDA is asked for and absent). ``--method`` applies to
ns_spectral only; ``--max-steps-per-program`` is not ported. Prints the
kernel launch counts on a line of its own (and, for a masked workload, the
sub-bucket and retry counts on another), then one JSON summary line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _masked_config(args):
    from pregen_pde_tpu_torch.datagen.masked_ns import MaskedNSConfig

    return MaskedNSConfig(pipeline=args.workload, resolution=args.resolution,
                          batch_size=args.batch_size, time_scale=args.time_scale)


def _generate_masked(generator, args, writer) -> dict:
    """Batches of ``batch_size`` as ``pregen_pde_tpu generate`` loops them;
    → the sub-bucket and retry counts."""
    from pregen_pde_tpu_torch.datagen.masked_ns import generate_masked_ns_batch, new_stats

    cfg = _masked_config(args)
    stats = new_stats()
    done = 0
    while done < args.n:
        take = min(args.batch_size, args.n - done)
        writer.write_batch(generate_masked_ns_batch(
            generator, cfg, take, storage_dtype=args.storage_dtype, stats=stats))
        done += take
    writer.close()
    return stats


def _cmd_generate(args):
    import torch

    from pregen_pde_tpu_torch.core import NSVorticityConfig
    from pregen_pde_tpu_torch.datagen.masked_ns import check_device_supported
    from pregen_pde_tpu_torch.datagen.pipeline import (
        GenerationConfig,
        generate_ns_dataset,
        resolve_method,
    )
    from pregen_pde_tpu_torch.datagen.writer import (
        ShardWriter,
        scan_existing_h5,
        scan_existing_shards,
    )
    from pregen_pde_tpu_torch.solvers import ns_projection_cuda, spectral_ns_cuda
    from pregen_pde_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    masked = args.workload != "ns_spectral"
    # before any draw or file: what the device's kernels do not handle raises
    if masked:
        if args.method != "auto":
            raise SystemExit("--method applies to --workload ns_spectral only")
        check_device_supported(_masked_config(args), device)
        method = None
    else:
        method = resolve_method(args.method, args.resolution, device)
    start_index = 0
    resume_point = 0
    if args.resume:
        if args.format == "npy":
            start_index, n_done = scan_existing_shards(args.out, args.prefix)
            resume_point = start_index
        else:
            n_done = scan_existing_h5(args.out, args.prefix)
            resume_point = n_done
        if n_done >= args.n:
            print(json.dumps({"generated": 0, "already_done": n_done,
                              "out": args.out}), flush=True)
            return
        args.n -= n_done
    # the continuation of a resumed run draws a fresh stream
    seed = int(np.random.SeedSequence([args.seed, resume_point]).generate_state(1)[0])
    generator = torch.Generator(device=device).manual_seed(seed)
    writer = ShardWriter(args.out, prefix=args.prefix, fmt=args.format,
                         dtype=args.storage_dtype, start_index=start_index,
                         resume=args.resume)
    spectral_ns_cuda.reset_launches()
    ns_projection_cuda.reset_launches()
    stats = None
    if masked:
        stats = _generate_masked(generator, args, writer)
    else:
        gen = GenerationConfig(
            solver=NSVorticityConfig(resolution=args.resolution, forcing=args.forcing,
                                     viscosity=args.viscosity),
            batch_size=args.batch_size,
            vary_difficulty=not args.fixed_difficulty,
            storage_dtype=args.storage_dtype,
            method=method,
            time_scale=args.time_scale,
        )
        generate_ns_dataset(generator, gen, args.n, writer=writer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps({"kernel_launches": {
        spectral_ns_cuda.LIB_NAME: spectral_ns_cuda.launches,
        ns_projection_cuda.LIB_NAME: ns_projection_cuda.launches}}), flush=True)
    if stats is not None:
        print(json.dumps({"masked_ns": stats}), flush=True)
    print(json.dumps({"generated": args.n, "out": args.out, "device": str(device),
                      "workload": args.workload, "method": method}),
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    g.add_argument("--workload", default="ns_spectral",
                   choices=["ns_spectral", "fpo_regular", "fpo_hole", "fpo_multi_hole",
                            "ldc_regular"])
    g.add_argument("--n", type=int, default=128)
    g.add_argument("--out", required=True)
    g.add_argument("--prefix", default="results")
    g.add_argument("--format", default="npy", choices=["npy", "h5"])
    g.add_argument("--storage-dtype", default="float32",
                   choices=["float32", "float16"],
                   help="dataset dtype; float16 halves transfer + shard size")
    g.add_argument("--resume", action="store_true",
                   help="continue an interrupted run: skip trajectories "
                        "already in existing shards, keep numbering (npy)")
    g.add_argument("--resolution", type=int, default=128)
    g.add_argument("--batch-size", type=int, default=128)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--fixed-difficulty", action="store_true")
    g.add_argument("--viscosity", type=float, default=1e-4,
                   help="viscosity with --fixed-difficulty (lower nu = harder)")
    g.add_argument("--forcing", default="fno", choices=["fno", "kolmogorov", "none"])
    g.add_argument("--time-scale", type=float, default=5e-4,
                   help="multiplies the Re->horizon difficulty schedule; the "
                        "default 5e-4 gives ns_spectral 5,500-13,500 steps per "
                        "trajectory; the masked workloads are meant for 1.0, the "
                        "reference's own horizons (13,500-37,000 CFL steps)")
    g.add_argument("--method", default="auto",
                   choices=["auto", "cn_ab2_cuda", "cn_ab2_cuda_high",
                            "cn_ab2_cuda_exact", "cn_ab2_packed", "cn_heun_packed"],
                   help="ns_spectral stepper: auto = the hand-written CUDA CN+AB2 kernel on a "
                        "CUDA device (n in 128, 256, 512, 1024; other grids raise), "
                        "cn_ab2_packed (torch.fft) on the CPU; the three "
                        "cn_ab2_cuda* tiers run one float32 path for now")
    g.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    g.set_defaults(fn=_cmd_generate)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
