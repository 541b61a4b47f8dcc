"""Where the time goes: the scOT-B forward and train step on one CUDA card.

    python -m pregen_pde_tpu_torch.profile_scot [--json out.json]

scOT-B at 128², 7 → 3 channels, seeded weights (``seeded_scot``), at
batch 16 and at batch 3 (what ``evaluate`` runs on a 32-trajectory shard).
Printed as one line each (the card's name and power limit first) and, with
``--json``, written in full:

1. one forward per route — auto (K3 at C ≤ 384, K4 in stage 3),
   attention-only (K4 everywhere) and plain — in ms (CUDA events, 5 runs);
2. ``torch.profiler`` over one auto forward: device busy time, host wall,
   idle share and the time by kernel;
3. the ``evaluate`` main path in-process (``_evaluate_ckpt`` on a random
   (32, 21, 128², 6) contract, seeded ``.pt`` weights, batch size 16: 3 test
   trajectories, 19 forwards): the seconds to build the model and load the
   checkpoint, the whole evaluation's wall, and ``torch.profiler`` over it;
4. the train step at batch 16 (``Trainer.train_step``: the numpy batch to
   the card, forward, relative-L1 loss, backward, clip, AdamW), drop-path
   on: ms per step in each route (CUDA events, 5 steps), the kernel route
   also at batch 16, 4 and 1 in two rounds, and
   ``torch.profiler`` over two steps of the kernel route: device busy
   against wall, the idle share, and the device ms of the top kernels by
   name, forward and backward;
5. the optimizer alone on scOT-B's 1,580 leaves (N(0, 0.02²) weights, one
   N(0, 10⁻⁸) gradient set, the clip on and not engaged), the fused AdamW
   (``ops/adamw.py``) against the ``_foreach`` route and torch's own fused
   AdamW kernel (``library_adamw``): the host's ms a step (enqueue, no
   sync), ms a step by CUDA events, ``torch.profiler`` over 5 steps (device
   busy time and the kernels by name) and the bytes a step allocates above
   the resting state.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from pregen_pde_tpu_torch.profile_k1 import _card, _profiled

ROUTES = {"auto": ("auto", "auto"), "attention-only": ("auto", "plain"),
          "plain": ("plain", "plain")}


def seeded_scot(name: str = "scot-B", image_size: int = 128, seed: int = 0):
    """A scOT with torch's default init under ``seed``, every parameter then
    moved by N(0, 0.02²) (the CondLN time maps start at zero). On the CPU."""
    from pregen_pde_tpu_torch.__main__ import _make_model

    torch.manual_seed(seed)
    model = _make_model(name, image_size)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def set_route(model, route: str) -> None:
    attention_impl, block_impl = ROUTES[route]
    for _, layer in model.swin_layers():
        layer.attention.impl, layer.block_impl = attention_impl, block_impl


def event_ms(fn, reps: int = 5) -> float:
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _evaluate_main_path(model, dev) -> dict:
    from pregen_pde_tpu_torch.__main__ import _evaluate_ckpt, _make_model
    from pregen_pde_tpu_torch.models.convert import load_checkpoint

    data = np.random.default_rng(0).normal(size=(32, 21, 128, 128, 6)).astype(np.float32)
    patterns = "[7];[2,2,2,1];[1,1,1,1,1,1,1]"
    with tempfile.TemporaryDirectory() as work:
        ckpt = os.path.join(work, "w.pt")
        torch.save(model.state_dict(), ckpt)
        t0 = time.perf_counter()
        m = _make_model("scot-B", 128)
        t1 = time.perf_counter()
        load_checkpoint(m, ckpt)
        t2 = time.perf_counter()
        m.to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del m
        with torch.inference_mode():
            _evaluate_ckpt(ckpt, "scot-B", data, patterns, 16, dev)  # warm-up
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            _evaluate_ckpt(ckpt, "scot-B", data, patterns, 16, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t4
            _, prof = _profiled(lambda: _evaluate_ckpt(ckpt, "scot-B", data, patterns, 16, dev))
    return {"build_model_s": t1 - t0, "load_ckpt_s": t2 - t1, "to_device_s": t3 - t2,
            "evaluate_ckpt_s": wall, "profiled": prof}


def _train_step_part(model, dev) -> dict:
    from pregen_pde_tpu_torch.training.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(2)
    batch = {"input": rng.normal(size=(16, 128, 128, 7)).astype(np.float32),
             "time": rng.uniform(0.05, 1.0, 16).astype(np.float32),
             "label": rng.normal(size=(16, 128, 128, 3)).astype(np.float32)}
    trainer = Trainer(model, TrainerConfig(epochs=1), device=dev)
    trainer.init_state(steps_per_epoch=100)
    out: dict = {}
    for route in ROUTES:
        set_route(model, route)
        out[f"{route}_ms"] = event_ms(lambda: trainer.train_step(batch))
    set_route(model, "auto")
    # the kernel route against batch, two rounds in turn: host-clock noise
    # shows as the spread between rounds
    out["auto_ms_by_batch"] = {b: [] for b in (16, 4, 1)}
    for _ in range(2):
        for b, times in out["auto_ms_by_batch"].items():
            part = {k: v[:b] for k, v in batch.items()}
            times.append(event_ms(lambda: trainer.train_step(part)))
    _, out["auto_profiled"] = _profiled(lambda: [trainer.train_step(batch) for _ in range(2)],
                                        top=20)
    return out


def library_adamw(opt):
    """torch's own fused AdamW kernel (``torch._fused_adamw_``, what
    ``torch.optim.AdamW(fused=True)`` calls) over ``opt``'s leaves and
    moments, as a step function to time beside the port's kernels: a call
    per group and decay subset, the clip's factor as its ``grad_scale``
    (the kernel divides each gradient by max(1, norm / clip); ``.grad`` is
    left as it is). Its update is p·(1 − lr·wd) − lr·u, optax's
    p − lr·(u + wd·p) up to rounding: not bit-equal to the ``_foreach``
    route. Every leaf needs a gradient."""
    from pregen_pde_tpu_torch.training.optim import B1, B2, EPS

    dev = opt.params[0].device
    subsets = []
    for g in opt.groups:
        for decay in (True, False):
            ps = [p for p, d in zip(g["params"], g["decay"]) if d == decay]
            if ps:
                subsets.append((g["schedule"], opt.weight_decay if decay else 0.0, ps,
                                [opt.m[id(p)] for p in ps], [opt.v[id(p)] for p in ps],
                                [torch.zeros((), device=dev) for _ in ps]))

    @torch.no_grad()
    def step():
        scale = None
        if opt.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                [p.grad for p in opt.params])))
            scale = torch.clamp(norm / opt.grad_clip, min=1.0)
        for schedule, wd, ps, m, v, counts in subsets:
            torch._foreach_add_(counts, 1.0)
            torch._fused_adamw_(ps, [p.grad for p in ps], m, v, [], counts,
                                lr=schedule(opt.count), beta1=B1, beta2=B2, weight_decay=wd,
                                eps=EPS, amsgrad=False, maximize=False, grad_scale=scale)
        opt.count += 1

    return step


def optimizer_part(dev, steps: int = 10) -> dict:
    """Part 5: each route's host ms, event ms, profile and allocation a step."""
    from pregen_pde_tpu_torch.__main__ import _make_model
    from pregen_pde_tpu_torch.training.optim import build_optimizer
    from pregen_pde_tpu_torch.training.trainer import TrainerConfig

    with torch.device("meta"):
        shapes = [(n, p.shape) for n, p in _make_model("scot-B", 128, in_channels=7,
                                                              out_channels=3).named_parameters()]
    gen = torch.Generator(device=dev).manual_seed(5)
    out: dict = {"leaves": len(shapes), "parameters": sum(math.prod(s) for _, s in shapes)}
    for route in ("fused", "foreach", "library"):
        named = [(n, torch.nn.Parameter(0.02 * torch.randn(s, generator=gen, device=dev)))
                 for n, s in shapes]
        opt = build_optimizer(TrainerConfig(epochs=1), 100, named)
        step = opt.step
        if route != "fused":
            opt.fused = None
        if route == "library":
            step = library_adamw(opt)
        for _, p in named:
            p.grad = 1e-4 * torch.randn(p.shape, generator=gen, device=dev)
        step()  # warm-up: the library's load, the allocator's pools
        torch.cuda.synchronize()
        host = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = {"host_ms": [h * 1e3 for h in host], "event_ms": event_ms(step, steps)}
        torch.cuda.synchronize()
        res["step_alloc_bytes"] = torch.cuda.max_memory_allocated() - base
        _, res["profiled_5_steps"] = _profiled(lambda: [step() for _ in range(5)])
        out[route] = res
        del named, opt
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch.profile_scot")
    p.add_argument("--json", help="write the full results here")
    args = p.parse_args(argv)

    from pregen_pde_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda:0")
    card = _card()
    print(card, flush=True)
    res: dict = {"card": card, "torch": torch.__version__}
    model = seeded_scot().to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    for batch in (16, 3):
        x = torch.randn(batch, 128, 128, 7, generator=gen, device=dev)
        t = torch.rand(batch, generator=gen, device=dev)
        out: dict = {}
        with torch.inference_mode():
            for route in ROUTES:
                set_route(model, route)
                out[f"{route}_ms"] = event_ms(lambda: model(x, t))
            set_route(model, "auto")
            _, out["auto_profiled"] = _profiled(lambda: model(x, t))
        res[f"B{batch}"] = out
        print(f"scOT-B 128^2 B={batch} one forward: {json.dumps(out)} | {card}", flush=True)
    res["evaluate"] = _evaluate_main_path(model, dev)
    print(f"evaluate main path (in-process): {json.dumps(res['evaluate'])} | {card}", flush=True)
    res["train_step_B16"] = _train_step_part(model, dev)
    print(f"scOT-B 128^2 B=16 train step: {json.dumps(res['train_step_B16'])} | {card}",
          flush=True)
    del model
    res["optimizer"] = optimizer_part(dev)
    print(f"scOT-B optimizer step: {json.dumps(res['optimizer'])} | {card}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
