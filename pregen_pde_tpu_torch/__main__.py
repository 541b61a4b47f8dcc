"""CLI of the PyTorch port:

    python -m pregen_pde_tpu_torch generate --workload ns_spectral --n 256 --out dir/
    python -m pregen_pde_tpu_torch generate --workload fpo_multi_hole --n 128 \
        --time-scale 1.0 --out dir/
    python -m pregen_pde_tpu_torch generate --workload heat --n 128 --out dir/
    python -m pregen_pde_tpu_torch train --data d.npy --ckpt dir/        # FNO
    python -m pregen_pde_tpu_torch evaluate --data d.npy --ckpt dir/best.pt
    python -m pregen_pde_tpu_torch train --model scot-B --data d.npy --ckpt dir/
    python -m pregen_pde_tpu_torch mix-sweep --model ffno --hard h.npy --easy e.npy
    python -m pregen_pde_tpu_torch train --model cno --data d.npy --ckpt dir/
    python -m pregen_pde_tpu_torch finetune --pretrained base.pt --data d.npy  # CNO

``generate``: the same flags as ``python -m pregen_pde_tpu generate`` for the
spectral-NS workload, the four masked-geometry workloads (fpo_regular,
fpo_hole, fpo_multi_hole, ldc_regular) and burgers, heat and darcy (their
configs take only ``--resolution``; heat steps through the fused Heun
kernel K5b on a CUDA device). ``--method`` applies to ns_spectral only;
``--max-steps-per-program`` is not ported. Prints the kernel launch counts
on a line of its own (and, for a masked workload, the sub-bucket and retry
counts on another), then one JSON summary line; on standard error, after the
last batch, ``{"spans": ...}``: each ``pregen.*`` span's calls, seconds and
bytes (``utils/trace.py``).

``--model`` of ``evaluate``, ``train`` and ``mix-sweep`` is ``fno`` (the
default, as in the JAX CLI), ``ffno``, ``cno``, ``scot`` or ``scot-T/S/B/L``
(scot = scot-T), each built from the dataset's channels and grid.

``evaluate``: the contract-npy form of ``python -m pregen_pde_tpu
evaluate``: AR rollout patterns and the accumulation error on the test
split, printed as the same ``{"patterns": ..., "accumulation": ...}`` JSON
after a line with the K3 and K4 launch counts (0 for FNO and FFNO, which
run no kernel). ``--ckpt`` is an ``.npz`` of the flax parameter tree
flattened with ``/`` or a ``.pt`` state_dict of the port.

``train``: the contract-npy form of ``python -m pregen_pde_tpu train``:
the time-pair split and transition grammar, the trainer with the JAX
defaults (and the scOT learning-rate tiers with ``--lr-embedding`` /
``--lr-time-embedding``), the loader with seed 0, ``fit`` with a val
loader. Prints the K3/K4 forward and backward launch counts, then one JSON
record per epoch and ``{"best_mean_val_rel_%": ...}``. ``--ckpt DIR`` writes
the best parameters as ``DIR/best.pt`` (a state_dict that ``evaluate
--ckpt`` reads); ``--resume`` loads it before training (parameters only,
the epochs restart).

``mix-sweep``: ``python -m pregen_pde_tpu mix-sweep``: per α a hard/easy
mix, a fresh model, ``fit`` with hard and easy val loaders, the best
parameters, then the hard and easy test splits; one JSON line per α and
the results.

``finetune``: the contract-npy form of ``python -m pregen_pde_tpu
finetune`` (``--model`` cno by default): the base built with
``--base-in-size/-in-channels/-out-channels`` and ``--pretrained`` (an
``.npz`` of the flax tree or a ``.pt``, as ``evaluate --ckpt`` takes) loaded
into it, wrapped in 1×1-conv adapters where the dataset's channels differ,
trained with the three fine-tuning tiers. Prints the launch line, the
parameters per tier, one JSON record per epoch and ``{"best_mean_val_rel_%":
...}``; ``--ckpt DIR`` writes the wrapper's best parameters as ``DIR/best.pt``.

All take ``--device`` (default ``cuda``; raises when CUDA is asked for and
absent; ``cpu`` runs the plain versions of the kernels). What the training
slice does not port yet raises ``SystemExit`` naming it (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _masked_config(args):
    from pregen_pde_tpu_torch.datagen.masked_ns import MaskedNSConfig

    return MaskedNSConfig(pipeline=args.workload, resolution=args.resolution,
                          batch_size=args.batch_size, time_scale=args.time_scale)


def _write_batches(args, writer, make_batch) -> None:
    """Batches of ``batch_size`` as ``pregen_pde_tpu generate`` loops them:
    ``make_batch(take)`` → one array, written as one shard."""
    done = 0
    while done < args.n:
        take = min(args.batch_size, args.n - done)
        writer.write_batch(make_batch(take))
        done += take
    writer.close()


def _generate_masked(generator, args, writer) -> dict:
    """The masked workloads' batches; → the sub-bucket and retry counts."""
    from pregen_pde_tpu_torch.datagen.masked_ns import generate_masked_ns_batch, new_stats

    cfg = _masked_config(args)
    stats = new_stats()
    _write_batches(args, writer, lambda take: generate_masked_ns_batch(
        generator, cfg, take, storage_dtype=args.storage_dtype, stats=stats))
    return stats


SIMPLE_WORKLOADS = ("burgers", "heat", "darcy")


def _simple_batch(generator, args, take: int) -> np.ndarray:
    """One batch of a heat, Burgers or Darcy workload, the configs taking
    only ``--resolution`` (as the JAX CLI passes them)."""
    from pregen_pde_tpu_torch.core import BurgersConfig
    from pregen_pde_tpu_torch.datagen import simple
    from pregen_pde_tpu_torch.solvers.darcy import DarcyConfig
    from pregen_pde_tpu_torch.solvers.heat import HeatConfig

    if args.workload == "burgers":
        return simple.generate_burgers_batch(generator, BurgersConfig(resolution=args.resolution),
                                             take, storage_dtype=args.storage_dtype)
    if args.workload == "heat":
        return simple.generate_heat_batch(generator, HeatConfig(resolution=args.resolution),
                                          take, storage_dtype=args.storage_dtype)
    return simple.generate_darcy_batch(generator, DarcyConfig(resolution=args.resolution),
                                       take, storage_dtype=args.storage_dtype)


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
    from pregen_pde_tpu_torch.ops import stencil
    from pregen_pde_tpu_torch.solvers import ns_projection_cuda, spectral_ns_cuda
    from pregen_pde_tpu_torch.utils import trace
    from pregen_pde_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    spectral = args.workload == "ns_spectral"
    simple = args.workload in SIMPLE_WORKLOADS
    masked = not (spectral or simple)
    # before any draw or file: what the device's kernels do not handle raises
    if not spectral and args.method != "auto":
        raise SystemExit("--method applies to --workload ns_spectral only")
    if masked:
        check_device_supported(_masked_config(args), device)
    method = resolve_method(args.method, args.resolution, device) if spectral else None
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
    stencil.reset_launches()
    trace.reset()
    stats = None
    if simple:
        _write_batches(args, writer, lambda take: _simple_batch(generator, args, take))
    elif masked:
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
        ns_projection_cuda.LIB_NAME: ns_projection_cuda.launches,
        stencil.LIB_NAME: stencil.launches}}), flush=True)
    if stats is not None:
        print(json.dumps({"masked_ns": stats}), flush=True)
    print(json.dumps({"generated": args.n, "out": args.out, "device": str(device),
                      "workload": args.workload, "method": method}),
          flush=True)
    print(json.dumps({"spans": trace.totals()}), file=sys.stderr, flush=True)


PORTED_MODELS = "fno, ffno, cno, scot or scot-{T,S,B,L}"
MODEL_HELP = ("fno (the default, as in the JAX CLI), ffno, cno, scot or scot-T/S/B/L (scot = "
              "scot-T)")


def _scot_size(name: str) -> str:
    """The scOT size letter of ``--model scot[-X]``; an unknown size raises."""
    from pregen_pde_tpu_torch.models.scot import MODEL_SIZES

    size = name.split("-")[1].upper() if "-" in name else "T"
    if size not in MODEL_SIZES:
        raise SystemExit(f"unknown scOT size in {name!r}; the port takes {PORTED_MODELS}")
    return size


def _check_model(name: str) -> None:
    """``--model`` as the JAX CLI's dispatch reads it; unknown names raise
    before any data is read."""
    if name.startswith("scot"):
        _scot_size(name)
    elif name not in ("fno", "ffno", "cno"):
        raise SystemExit(f"unknown model {name!r}; the port takes {PORTED_MODELS}")


def _make_model(name: str, in_size: int, in_channels: int = 7, out_channels: int = 3,
                impl: str = "auto"):
    """The model from dataset-derived dims (``_make_model`` of the JAX CLI):
    FNO and FFNO at the JAX defaults (their spectral convolutions through
    ``torch.fft``), CNO at the JAX defaults (``expand_input`` when the grid
    is not a multiple of 8), or scOT. ``impl`` sets scOT's two lowerings
    (``models/scot.py``): "auto" is the kernels on a CUDA device."""
    _check_model(name)
    if impl != "auto" and not name.startswith("scot"):
        raise ValueError(f"impl {impl!r} applies to scOT only, not {name!r}")
    if name == "fno":
        from pregen_pde_tpu_torch.models.fno import FNO2d

        return FNO2d(in_channels=in_channels, out_channels=out_channels)
    if name == "ffno":
        from pregen_pde_tpu_torch.models.ffno import FFNO2d

        return FFNO2d(in_channels=in_channels, out_channels=out_channels)
    if name == "cno":
        from pregen_pde_tpu_torch.models.cno import CNO

        return CNO(in_size, in_channels, out_dim=out_channels, expand_input=bool(in_size % 8))
    from pregen_pde_tpu_torch.models.scot import MODEL_SIZES, ScOT, ScOTConfig

    return ScOT(ScOTConfig(image_size=in_size, num_channels=in_channels,
                           num_out_channels=out_channels, attention_impl=impl, block_impl=impl,
                           **MODEL_SIZES[_scot_size(name)]))


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
    model = _make_model(model_name, data.shape[2], in_channels=train.in_channels,
                        out_channels=train.out_channels, impl=impl)
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

    _check_model(args.model)
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


def _kernel_launches() -> dict:
    from pregen_pde_tpu_torch.ops import swin_block, window_attention

    return {swin_block.LIB_NAME: swin_block.launches,
            f"{swin_block.LIB_NAME}_bwd": swin_block.bwd_launches,
            window_attention.LIB_NAME: window_attention.launches,
            f"{window_attention.LIB_NAME}_bwd": window_attention.bwd_launches}


def _reset_kernel_launches() -> None:
    from pregen_pde_tpu_torch.ops import swin_block, window_attention

    swin_block.reset_launches()
    window_attention.reset_launches()


def _refuse_benchmark_data(args, what: str) -> None:
    """The benchmark datasets (ROADMAP.md, Queue 1, item 4.5) raise, naming
    the slice; a contract .npy is needed."""
    import os

    if (args.dataset or args.data_dir or args.num_trajectories is not None
            or (args.data and ":" in args.data and not os.path.exists(args.data))):
        raise SystemExit(f"{what} on the benchmark datasets (--dataset/--data-dir, --data "
                         "<name>:<path>, --num-trajectories) is a later slice (ROADMAP.md, "
                         "Queue 1, item 4.5); pass a contract .npy with --data")
    if args.data is None:
        raise SystemExit(f"{what} needs --data <contract.npy>")


def _refuse_unported_train(args) -> None:
    """What the training slice does not port yet raises, naming the slice."""
    _refuse_benchmark_data(args, "training")
    later = [
        (args.ar_steps is not None or args.teacher_forcing or args.ar_final_label_only,
         "AR-rollout training (--ar-steps, --teacher-forcing, --ar-final-label-only; "
         "training/ar.py) is a later slice"),
        (args.device_resident, "--device-resident (training/device_data.py) is a later slice"),
        (args.compute_dtype == "bfloat16",
         "--compute-dtype bfloat16 waits for a tested bf16 K3 backward (a later slice); "
         "float32 is the default"),
        (args.zero_stage is not None or args.remat,
         "--zero-stage and --remat are a later slice"),
    ]
    for bad, why in later:
        if bad:
            raise SystemExit(why)
    _check_model(args.model)


def _build_trainer(args, model, device, ckpt=None):
    """Trainer with the scOT learning-rate tiers when they are asked for
    (``_build_trainer`` of the JAX CLI)."""
    from pregen_pde_tpu_torch.training.tiers import SCOT_TIER_DECAY, scot_main_tiers, scot_tier_of
    from pregen_pde_tpu_torch.training.trainer import Trainer, TrainerConfig

    lr_emb = getattr(args, "lr_embedding", None)
    lr_time = getattr(args, "lr_time_embedding", None)
    tiered = lr_emb is not None or lr_time is not None
    if tiered and not args.model.startswith("scot"):
        raise SystemExit(
            "--lr-embedding/--lr-time-embedding mirror the scOT main-path param groups "
            "(scOT/trainer.py:77-227); for CNO use `finetune` (its reference tiers are "
            "FT-only, CNO_timeModule_CIN.py:983-994)")
    cfg = TrainerConfig(learning_rate=args.lr, epochs=args.epochs, batch_size=args.batch_size,
                        ckpt_dir=ckpt, warmup_frac=getattr(args, "warmup", 0.0) or 0.0,
                        lr_tiers=scot_main_tiers(args.lr, lr_emb, lr_time) if tiered else None)
    return Trainer(model, cfg, tier_fn=scot_tier_of if tiered else None,
                   tier_decay=SCOT_TIER_DECAY if tiered else None, device=device)


def _seeded_model(name: str, in_size: int, **kw):
    """The model under torch's init with seed 0 (the JAX trainer's init key)."""
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return _make_model(name, in_size, **kw)


def _cmd_train(args):
    import torch

    from pregen_pde_tpu_torch.training.datasets import BatchLoader, TimePairConfig, TimePairDataset
    from pregen_pde_tpu_torch.utils.device import resolve_device

    _refuse_unported_train(args)
    device = resolve_device(args.device)
    data = np.asarray(np.load(args.data, mmap_mode="r"))
    t_steps = data.shape[1] - 1
    # transition grammar of `TrainCNO_time_L.py:151-163`
    allowed = {"one": [1], "one2all": None, "all": list(range(1, t_steps + 1))}[
        args.transitions or "one"]
    cfg = TimePairConfig(max_num_time_steps=t_steps, allowed_transitions=allowed,
                         n_val=max(2, data.shape[0] // 10), n_test=max(2, data.shape[0] // 10))
    train = TimePairDataset(data, cfg, "train")
    val = TimePairDataset(data, cfg, "val", mean=train.mean, std=train.std)
    model = _seeded_model(args.model, data.shape[2], in_channels=train.in_channels,
                          out_channels=train.out_channels)
    trainer = _build_trainer(args, model, device, ckpt=args.ckpt)
    loader = BatchLoader(train, args.batch_size, seed=0)
    if args.resume:
        if not args.ckpt:
            raise SystemExit("--resume requires --ckpt")
        trainer.init_state(next(iter(loader)), steps_per_epoch=len(loader))
        print(json.dumps({"resumed_from": args.ckpt,
                          "ckpt_file": str(trainer.restore_latest())}), flush=True)
    _reset_kernel_launches()
    records = []
    result = trainer.fit(loader, val_loaders={"val": BatchLoader(val, args.batch_size,
                                                                  shuffle=False)},
                         log_fn=records.append)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps({"kernel_launches": _kernel_launches()}), flush=True)
    for rec in records:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"best_mean_val_rel_%": result["best_metric"]}), flush=True)


def _cmd_mix_sweep(args):
    import torch

    from pregen_pde_tpu_torch.training.datasets import (
        BatchLoader,
        TimePairConfig,
        make_mixed_datasets,
    )
    from pregen_pde_tpu_torch.training.trainer import Trainer, TrainerConfig
    from pregen_pde_tpu_torch.utils.device import resolve_device

    _check_model(args.model)  # an unported --model raises before any load
    device = resolve_device(args.device)
    hard = np.asarray(np.load(args.hard, mmap_mode="r"))
    easy = np.asarray(np.load(args.easy, mmap_mode="r"))
    t_steps = hard.shape[1] - 1
    cfg = TimePairConfig(max_num_time_steps=t_steps, allowed_transitions=[1, 2],
                         n_val=max(2, hard.shape[0] // 10), n_test=max(2, hard.shape[0] // 10))
    _reset_kernel_launches()
    results = {}
    for alpha in [float(a) for a in args.alphas.split(",")]:
        train, vh, ve, th, te = make_mixed_datasets(hard, easy, alpha, args.total_trajectories, cfg)
        model = _seeded_model(args.model, hard.shape[2], in_channels=vh.in_channels,
                              out_channels=vh.out_channels)
        trainer = Trainer(model,
                          TrainerConfig(learning_rate=args.lr, epochs=args.epochs,
                                        batch_size=args.batch_size), device=device)
        loader = lambda ds: BatchLoader(ds, args.batch_size, shuffle=False)
        trainer.fit(BatchLoader(train, args.batch_size, seed=0),
                    val_loaders={"val_hard": loader(vh), "val_easy": loader(ve)})
        trainer.restore_best()
        results[alpha] = {"test_hard": trainer.evaluate(loader(th)),
                          "test_easy": trainer.evaluate(loader(te))}
        print(json.dumps({"alpha": alpha, **results[alpha]}), flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps({"kernel_launches": _kernel_launches()}), flush=True)
    print(json.dumps(results), flush=True)


def _cmd_finetune(args):
    import os

    import torch

    from pregen_pde_tpu_torch.models.convert import load_checkpoint
    from pregen_pde_tpu_torch.training.datasets import BatchLoader, TimePairConfig, TimePairDataset
    from pregen_pde_tpu_torch.training.finetune import (
        DEFAULT_FT_TIERS,
        AdapterWrapper,
        finetune_tier_of,
    )
    from pregen_pde_tpu_torch.training.trainer import Trainer, TrainerConfig
    from pregen_pde_tpu_torch.utils.device import resolve_device

    _refuse_benchmark_data(args, "fine-tuning")
    _check_model(args.model)
    if os.path.isdir(args.pretrained):
        raise SystemExit("orbax checkpoint directories are not read yet; export the params "
                         "to an .npz (README) or pass a .pt state_dict")
    device = resolve_device(args.device)
    data = np.asarray(np.load(args.data, mmap_mode="r"))
    t_steps = data.shape[1] - 1
    cfg = TimePairConfig(max_num_time_steps=t_steps, allowed_transitions=[1],
                         n_val=max(2, data.shape[0] // 10), n_test=max(2, data.shape[0] // 10))
    train = TimePairDataset(data, cfg, "train")
    val = TimePairDataset(data, cfg, "val", mean=train.mean, std=train.std)
    # the pretrained base keeps its own geometry; the adapters bridge the
    # target task's channel counts
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        base = _make_model(args.model, args.base_in_size, in_channels=args.base_in_channels,
                           out_channels=args.base_out_channels)
        model = AdapterWrapper(base, base_in_channels=args.base_in_channels,
                               in_channels=train.in_channels,
                               base_out_channels=args.base_out_channels,
                               out_channels=train.out_channels)
    try:
        load_checkpoint(base, args.pretrained)  # into the base only, as JAX grafts params["base"]
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from None
    tcfg = TrainerConfig(learning_rate=DEFAULT_FT_TIERS["base"], epochs=args.epochs,
                         batch_size=args.batch_size, ckpt_dir=args.ckpt,
                         lr_tiers=DEFAULT_FT_TIERS)
    trainer = Trainer(model, tcfg, tier_fn=finetune_tier_of, device=device)
    trainer.init_state(steps_per_epoch=max(len(train) // args.batch_size, 1))
    tiers = {t: 0 for t in DEFAULT_FT_TIERS}
    for name, prm in model.named_parameters():
        tiers[finetune_tier_of(name)] += prm.numel()
    print(json.dumps({"tier_parameters": tiers}), flush=True)
    _reset_kernel_launches()
    result = trainer.fit(BatchLoader(train, args.batch_size, seed=0),
                         val_loaders={"val": BatchLoader(val, args.batch_size, shuffle=False)},
                         log_fn=lambda rec: print(json.dumps(rec), flush=True))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps({"kernel_launches": _kernel_launches()}), flush=True)
    print(json.dumps({"best_mean_val_rel_%": result["best_metric"]}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    g.add_argument("--workload", default="ns_spectral",
                   choices=["ns_spectral", "fpo_regular", "fpo_hole", "fpo_multi_hole",
                            "ldc_regular", *SIMPLE_WORKLOADS])
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
    e.add_argument("--model", default="fno", help=MODEL_HELP)
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

    t = sub.add_parser("train")
    t.add_argument("--model", default="fno", help=MODEL_HELP)
    t.add_argument("--data", default=None, help="contract .npy path")
    t.add_argument("--dataset", default=None, help="not ported yet (raises)")
    t.add_argument("--data-dir", default=None, help="not ported yet (raises)")
    t.add_argument("--num-trajectories", type=int, default=None,
                   help="benchmark datasets only; not ported yet (raises)")
    t.add_argument("--epochs", type=int, default=10)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--lr", type=float, default=5e-5)
    t.add_argument("--warmup", type=float, default=0.0,
                   help="LR warmup fraction of total steps (warmup_ratio, scOT main path)")
    t.add_argument("--lr-embedding", type=float, default=None,
                   help="embedding/patch-recovery LR group (learning_rate_embedding_recovery)")
    t.add_argument("--lr-time-embedding", type=float, default=None,
                   help="conditional-norm time-embedding LR group (learning_rate_time_embedding)")
    t.add_argument("--transitions", default=None, choices=["one", "one2all", "all"])
    t.add_argument("--ckpt", default=None,
                   help="directory; the best parameters are written to DIR/best.pt")
    t.add_argument("--resume", action="store_true",
                   help="load DIR/best.pt before training (parameters only)")
    t.add_argument("--ar-steps", default=None, help="not ported yet (raises)")
    t.add_argument("--teacher-forcing", action="store_true", help="not ported yet (raises)")
    t.add_argument("--ar-final-label-only", action="store_true",
                   help="not ported yet (raises)")
    t.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"],
                   help="float32 only; bfloat16 is not ported yet (raises)")
    t.add_argument("--zero-stage", type=int, default=None, choices=[1, 3],
                   help="not ported yet (raises)")
    t.add_argument("--remat", action="store_true", help="not ported yet (raises)")
    t.add_argument("--device-resident", action="store_true", help="not ported yet (raises)")
    t.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    t.set_defaults(fn=_cmd_train)

    m = sub.add_parser("mix-sweep")
    m.add_argument("--model", default="fno", help=MODEL_HELP)
    m.add_argument("--hard", required=True)
    m.add_argument("--easy", required=True)
    m.add_argument("--alphas", default="0.0,0.25,0.5,0.75,1.0")
    m.add_argument("--total-trajectories", type=int, default=100)
    m.add_argument("--epochs", type=int, default=10)
    m.add_argument("--batch-size", type=int, default=16)
    m.add_argument("--lr", type=float, default=5e-5)
    m.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is absent")
    m.set_defaults(fn=_cmd_mix_sweep)

    ft = sub.add_parser("finetune")
    ft.add_argument("--model", default="cno", help="base (pretrained) model family: " + MODEL_HELP)
    ft.add_argument("--pretrained", required=True,
                    help="the pretrained base: an .npz of the flax params flattened with '/', "
                         "or a .pt state_dict")
    ft.add_argument("--data", default=None, help="contract .npy path")
    ft.add_argument("--dataset", default=None, help="not ported yet (raises)")
    ft.add_argument("--data-dir", default=None, help="not ported yet (raises)")
    ft.add_argument("--num-trajectories", type=int, default=None,
                    help="benchmark datasets only; not ported yet (raises)")
    ft.add_argument("--base-in-channels", type=int, default=7,
                    help="input channels the pretrained base expects")
    ft.add_argument("--base-in-size", type=int, default=128,
                    help="grid size the pretrained base was built for")
    ft.add_argument("--base-out-channels", type=int, default=3,
                    help="output channels the pretrained base produces")
    ft.add_argument("--epochs", type=int, default=10)
    ft.add_argument("--batch-size", type=int, default=16)
    ft.add_argument("--ckpt", default=None,
                    help="directory; the best parameters are written to DIR/best.pt")
    ft.add_argument("--seed", type=int, default=0)
    ft.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    ft.set_defaults(fn=_cmd_finetune)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
