"""CLI of the PyTorch port:

    python -m pregen_pde_tpu_torch generate --workload ns_spectral --n 256 --out dir/
    python -m pregen_pde_tpu_torch generate --workload fpo_multi_hole --n 128 \
        --time-scale 1.0 --out dir/
    python -m pregen_pde_tpu_torch evaluate --model scot-B --data d.npy --ckpt w.npz

``generate``: the same flags as ``python -m pregen_pde_tpu generate`` for the
spectral-NS workload and the four masked-geometry workloads (fpo_regular,
fpo_hole, fpo_multi_hole, ldc_regular). ``--method`` applies to ns_spectral
only; ``--max-steps-per-program`` is not ported. Prints the kernel launch
counts on a line of its own (and, for a masked workload, the sub-bucket and
retry counts on another), then one JSON summary line.

``evaluate``: the contract-npy form of ``python -m pregen_pde_tpu
evaluate`` for scOT (``--model scot`` or ``scot-T/S/B/L``): AR rollout
patterns and the accumulation error on the test split, printed as the same
``{"patterns": ..., "accumulation": ...}`` JSON after a line with the K3 and
K4 launch counts. ``--ckpt`` is an ``.npz`` of the flax parameter tree
flattened with ``/`` or a ``.pt`` state_dict of the port.

Both take ``--device`` (default ``cuda``; raises when CUDA is asked for and
absent; ``cpu`` runs the plain versions of the kernels).
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


def _make_model(name: str, in_size: int, in_channels: int = 7, out_channels: int = 3,
                impl: str = "auto"):
    """scOT from dataset-derived dims (``_make_model`` of the JAX CLI); the
    other model families wait for later slices. ``impl`` sets both
    lowerings (``models/scot.py``): "auto" is the kernels on a CUDA device."""
    from pregen_pde_tpu_torch.models.scot import MODEL_SIZES, ScOT, ScOTConfig

    size = name.split("-")[1].upper() if "-" in name else "T"
    if not name.startswith("scot") or size not in MODEL_SIZES:
        raise SystemExit(f"model {name!r} is not ported; evaluate takes scot or "
                         f"scot-{{{','.join(MODEL_SIZES)}}}")
    return ScOT(ScOTConfig(image_size=in_size, num_channels=in_channels,
                           num_out_channels=out_channels, attention_impl=impl, block_impl=impl,
                           **MODEL_SIZES[size]))


def _evaluate_ckpt(ckpt, model_name, data, patterns_str, batch_size, device,
                   label_description=None, impl: str = "auto") -> dict:
    """Rollout-pattern + accumulation-error evaluation of one checkpoint on
    the test split of a contract array (``_evaluate_ckpt`` of the JAX CLI)."""
    from pregen_pde_tpu_torch.evalx.inference import accumulation_error
    from pregen_pde_tpu_torch.evalx.rollout import evaluate_patterns
    from pregen_pde_tpu_torch.models.convert import load_checkpoint
    from pregen_pde_tpu_torch.training.datasets import TimePairConfig, TimePairDataset

    t_steps = data.shape[1] - 1
    cfg = TimePairConfig(max_num_time_steps=t_steps, allowed_transitions=None,
                         n_val=max(2, data.shape[0] // 10), n_test=max(2, data.shape[0] // 10))
    train = TimePairDataset(data, cfg, "train")
    test = TimePairDataset(data, cfg, "test", mean=train.mean, std=train.std)
    model = _make_model(model_name, data.shape[2], impl=impl)
    load_checkpoint(model, ckpt)
    model = model.to(device).eval()
    patterns = [[int(x) for x in p.strip("[] ").split(",")] for p in patterns_str.split(";")]
    patterns = [p for p in patterns if sum(p) <= t_steps]
    res = evaluate_patterns(model, test, patterns, batch_size=batch_size,
                            label_description=label_description, device=device)
    acc = accumulation_error(model, test, max_steps=min(7, t_steps), batch_size=batch_size,
                             device=device)
    return {"patterns": res, "accumulation": acc}


def _cmd_evaluate(args):
    import os

    import torch

    from pregen_pde_tpu_torch.ops import swin_block, window_attention
    from pregen_pde_tpu_torch.utils.device import resolve_device

    if args.dataset or args.data_dir or args.ar_steps:
        raise SystemExit("evaluate on the benchmark datasets (--dataset/--data-dir, "
                         "--ar-steps) is not ported yet; pass a contract .npy with --data")
    if args.data is None:
        raise SystemExit("evaluate needs --data <contract.npy>")
    if ":" in args.data and not os.path.exists(args.data):
        raise SystemExit("evaluate on a benchmark dataset ('<name>:<path>') is not ported yet")
    if os.path.isdir(args.ckpt):
        raise SystemExit("orbax checkpoint directories are not read yet; export the params "
                         "to an .npz (README) or pass a .pt state_dict")
    device = resolve_device(args.device)
    data = np.asarray(np.load(args.data, mmap_mode="r"))
    swin_block.reset_launches()
    window_attention.reset_launches()
    try:
        with torch.inference_mode():
            res = _evaluate_ckpt(args.ckpt, args.model, data, args.patterns, args.batch_size,
                                 device, label_description=args.label_description)
    except FileNotFoundError as e:  # clean CLI error, no traceback
        raise SystemExit(str(e)) from None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps({"kernel_launches": {swin_block.LIB_NAME: swin_block.launches,
                                          window_attention.LIB_NAME: window_attention.launches}}),
          flush=True)
    print(json.dumps(res), flush=True)


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

    e = sub.add_parser("evaluate")
    e.add_argument("--model", required=True, help="scot, or scot-T/S/B/L (scot = scot-T)")
    e.add_argument("--data", default=None, help="contract .npy path")
    e.add_argument("--dataset", default=None, help="not ported yet (raises)")
    e.add_argument("--data-dir", default=None, help="not ported yet (raises)")
    e.add_argument("--ckpt", required=True,
                   help="an .npz of the flax params flattened with '/', or a .pt state_dict")
    e.add_argument("--patterns", default="[7];[2,2,2,1];[1,1,1,1,1,1,1]")
    e.add_argument("--ar-steps", default=None, help="not ported yet (raises)")
    e.add_argument("--label-description", default=None,
                   help="per-variable-group error reporting, e.g. '[Ux,Uy],[p]'")
    e.add_argument("--batch-size", type=int, default=16)
    e.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    e.set_defaults(fn=_cmd_evaluate)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
