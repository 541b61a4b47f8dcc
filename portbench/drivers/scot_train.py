"""Driver of scOT training: the port's normal train path, as ``python -m
pregen_pde_tpu_torch train --model scot-B`` runs it. The model is
``__main__._make_model`` at the configuration's grid and channels, the
trainer ``__main__._build_trainer`` (``TrainerConfig`` with the
configuration's rate and epochs; the cosine schedule over epochs × the
loader's batches, the global-norm clip, relative L1), and the loader
``BatchLoader`` (seed 0, ``drop_last``) over ``TimePairDataset``'s train
split, peeked once before the first epoch as ``Trainer.fit`` does. The
port's precision policy is set as ``train`` sets it (``resolve_device``):
no TF32 in matmuls or cuDNN convolutions.

Set-up, from the seed: a shard of the contract made by the port's masked
generator (``generate_masked_ns_batch_from_inputs``, what ``generate
--workload fpo_multi_hole`` calls) at the configuration named by the
traffic's ``shard``, checked finite, the generator's memory then freed; the
weights, one normal draw for the weight matrices and convolutions at the
init law of the JAX package (N(0, 0.02²), zero biases, the conditioned
norms' time maps at scale 1 and shift 0, logit scales log 10, layer scales
1e-6). Step 0 is the warm-up.

A window batch is one ``Trainer.train_step`` on the loader's next batch (a
new epoch reshuffles, as ``fit``). A row is one sample of the step. For the
steps the check keeps ``run`` returns (B, 1 + 2P), each row the step's
loss, each parameter's gradient norm as ``.grad`` holds it after the step,
and each parameter's ‖θ − θ₀‖₂, in ``reference/scot.py::param_shapes``'
order; for every later step (B, 2), the loss and the sum of the
parameters' norms, which is finite only when every parameter is. The norms
are multi-tensor launches and the row one fetch a step.

The check follows the steps as a sequence: ``keep`` keeps the window's
first ``check_steps`` steps. A view of the train split records which
samples each of those steps and the warm-up drew. After ``release``,
``compare`` draws the weights again and replays the warm-up and the kept
steps with the plain reference (``reference/scot.py``) on the shard kept
from set-up, in float32 with TF32 off, drop-path drawn from a generator
seeded as the trainer's.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from portbench import inputs, scot_roofline
from portbench import run as harness
from portbench.drivers.masked import program_config
from portbench.reference import geometry

BENCH = Path(__file__).resolve().parents[1]
# a leaf whose first gradient is under this share of the median leaf's moves
# under Adam by round-off alone, and its change is left out of param_gap
NOUGHT_GRAD = 1e-3
INIT_STD = 0.02  # the JAX package's init law (HF Swinv2 initializer_range)
MODEL_KEYS = {"image_size": "image_size", "patch_size": "patch_size",
              "in_channels": "num_channels", "out_channels": "num_out_channels",
              "embed_dim": "embed_dim", "depths": "depths", "num_heads": "num_heads",
              "window_size": "window_size", "mlp_ratio": "mlp_ratio",
              "skip_connections": "skip_connections", "drop_path_rate": "drop_path_rate",
              "layer_norm_eps": "layer_norm_eps"}


def reference():
    return harness.load_module(BENCH, "reference", "scot")


def draw_weights(shapes: list, seed: int, device: torch.device) -> dict:
    """The initial weights from the seed, one normal draw for every drawn
    leaf (weight matrices and convolutions, in ``shapes``' order)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fixed = {".time_scale.weight": 0.0, ".time_bias.weight": 0.0, ".time_scale.bias": 1.0,
             ".logit_scale": math.log(10.0), ".layer_scale": 1e-6}

    def law(name, shape):
        for end, value in fixed.items():
            if name.endswith(end):
                return value
        return None if len(shape) >= 2 else 0.0

    total = sum(math.prod(s) for n, s in shapes if law(n, s) is None)
    normal = torch.randn(total, generator=gen, device=device) * INIT_STD
    out, at = {}, 0
    for name, shape in shapes:
        value = law(name, shape)
        if value is None:
            out[name] = normal[at:at + math.prod(shape)].reshape(shape)
            at += math.prod(shape)
        else:
            out[name] = torch.full(shape, value, device=device)
    return out


def make_shard(traffic: dict, seed: int, device: torch.device) -> np.ndarray:
    """(N, frames, n, n, 6) float32 from the port's masked generator at the
    configuration ``traffic["shard"]["config"]``: Re normals at the N
    midpoint quantiles in a seeded order, hole masks by the benchmark's
    frozen sampler, one batch of N."""
    from pregen_pde_tpu_torch.datagen.masked_ns import generate_masked_ns_batch_from_inputs

    shard = traffic["shard"]
    cfg = json.loads((BENCH / "configs" / f"{shard['config']}.json").read_text())
    N, n = shard["trajectories"], cfg["resolution"]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = inputs.stratified_normals(gen, 1, N)[0]
    masks = geometry.sample_multi_holes(gen, N, n, cfg["min_holes"], cfg["max_holes"],
                                        cfg["hole_cells"], cfg["max_attempts"])
    prog = program_config(cfg, {"batch_size": N, "time_scale": shard["time_scale"]})
    return generate_masked_ns_batch_from_inputs(z, masks, prog, cfg["storage_dtype"])


class Drawn:
    """The train split as the loader indexes it, recording each index."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.indices: list[int] = []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        self.indices.append(int(i))
        return self.dataset[i]


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from pregen_pde_tpu_torch.__main__ import _build_trainer, _make_model
        from pregen_pde_tpu_torch.training.datasets import (BatchLoader, TimePairConfig,
                                                            TimePairDataset)
        from pregen_pde_tpu_torch.utils.device import set_precision_policy

        set_precision_policy(device)
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        B = self.batch_size = traffic["batch_size"]
        self.shard = make_shard(traffic, seed, device)
        if not np.isfinite(self.shard).all():
            raise RuntimeError("the masked generator left the training shard non-finite")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        N, frames = self.shard.shape[:2]
        split = max(2, N // 10)  # `train`'s val and test splits
        if traffic["transitions"] != "one":
            raise ValueError("the cell trains on transitions 'one'")
        pairs = TimePairConfig(max_num_time_steps=frames - 1, allowed_transitions=[1],
                               n_val=split, n_test=split)
        train = TimePairDataset(self.shard, pairs, "train")
        self.drawn = Drawn(train)
        self.loader = BatchLoader(self.drawn, B, seed=cfg["loader_seed"])

        model = _make_model(cfg["model"], cfg["image_size"], in_channels=train.in_channels,
                            out_channels=train.out_channels)
        flat = lambda v: tuple(v) if isinstance(v, (list, tuple)) else v
        got = {k: flat(getattr(model.config, v)) for k, v in MODEL_KEYS.items()}
        want = {k: flat(cfg[k]) for k in MODEL_KEYS}
        if got != want:
            raise ValueError(f"{cfg['model']} builds {got}, the configuration states {want}")
        self.shapes = reference().param_shapes(cfg)
        model.to(device).load_state_dict(draw_weights(self.shapes, seed, device))
        args = argparse.Namespace(model=cfg["model"], lr=cfg["learning_rate"],
                                  epochs=cfg["epochs"], batch_size=B)
        self.trainer = _build_trainer(args, model, device)
        if self.trainer.cfg.seed != cfg["trainer_seed"] or (
                self.trainer.cfg.weight_decay != cfg["weight_decay"]
                or self.trainer.cfg.grad_clip != cfg["grad_clip"]
                or self.trainer.cfg.schedule != cfg["schedule"]):
            raise ValueError(f"the trainer is {self.trainer.cfg}, not the configuration's")
        # fit's peek, so the epochs' shuffles stand where fit's do
        self.trainer.init_state(next(iter(self.loader)), steps_per_epoch=len(self.loader))
        self.total_steps = cfg["epochs"] * len(self.loader)
        self.epoch = iter(self.loader)
        named = dict(model.named_parameters())
        self.params = [named[n] for n, _ in self.shapes]
        self.start = [p.detach().clone() for p in self.params]
        self.samples: dict[int, list[int]] = {}  # step → the samples it drew
        self.steps = 0  # window steps entered
        bounds = scot_roofline.step_bound_seconds(cfg, B)
        self.info = {"train_flop_per_sample": scot_roofline.train_flop_per_sample(cfg, B),
                     "k3_bound_s": bounds["k3"], "k4_bound_s": bounds["k4"]}

    def _step(self, s: int) -> torch.Tensor:
        """Train step s on the loader's next batch (a new epoch when it ends)."""
        self.drawn.indices = []
        try:
            batch = next(self.epoch)
        except StopIteration:
            self.epoch = iter(self.loader)
            batch = next(self.epoch)
        if s <= self.traffic["check_steps"]:
            self.samples[s] = self.drawn.indices
        return self.trainer.train_step(batch)

    def _grads(self) -> list:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def warm_up(self) -> None:
        """Step 0; its gradient norms are kept for the check (the one step
        whose gradients no update has touched yet)."""
        self._step(0)
        with torch.no_grad():
            self.warm_grads = torch.stack(torch._foreach_norm(self._grads()))

    def run(self, b: int) -> np.ndarray:
        self.steps = b + 1
        loss = self._step(b + 1).reshape(1).float()
        with torch.no_grad():
            if b < self.traffic["check_steps"]:
                norms = torch._foreach_norm(self._grads()) + torch._foreach_norm(
                    torch._foreach_sub(self.params, self.start))
            else:  # not kept: the parameters' finiteness in one number
                norms = [torch.stack(torch._foreach_norm(self.params)).sum()]
            row = torch.cat([loss, torch.stack(norms)]).cpu().numpy()
        return np.repeat(row[None], self.batch_size, axis=0)

    def keep(self, b: int) -> np.ndarray:
        if b < self.traffic["check_steps"]:
            return np.arange(self.batch_size)
        return np.zeros(0, dtype=np.int64)

    def counters(self) -> dict:
        from pregen_pde_tpu_torch.ops import swin_block, window_attention

        return {"optimizer_steps": self.trainer.optimizer.count,
                "k3_launches": swin_block.launches, "k3_bwd_launches": swin_block.bwd_launches,
                "k4_launches": window_attention.launches,
                "k4_bwd_launches": window_attention.bwd_launches}

    def batch_info(self, b: int, finite: np.ndarray) -> dict:
        return {"delivered_flop": self.info["train_flop_per_sample"] * int(finite.sum()),
                "k3_bound_s": self.info["k3_bound_s"], "k4_bound_s": self.info["k4_bound_s"]}

    def release(self) -> None:
        del self.trainer, self.params, self.start, self.epoch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, items: list, got: np.ndarray, limits: dict) -> dict:
        """The program's kept rows against the plain replay of the warm-up
        and the kept steps, from the same weights and samples.

        ``loss_gap``: the widest relative gap of a kept step's loss.
        ``grad_gap``: the widest, over the kept steps and the parameters, of
        the gap between the program's gradient norm and the reference's,
        over the reference's or the median parameter's, whichever is larger:
        Adam's update is nearly scale-free, so a wrong backward can pass the
        other two over a few steps and only the gradients show it.
        ``param_gap``: the same for ‖θ − θ₀‖, leaving out parameters whose
        first gradient is nought to rounding. A kept step that the window
        entered and that left no finite row reads an unbounded gap.
        ``warmup_grad_gap``, reported with no limit: ``grad_gap`` at the
        warm-up step, where both sides start from the same weights, so it
        reads the arithmetic alone, before Adam's near-sign first updates
        carry rounding into the weights."""
        ref_mod = reference()
        check = min(self.traffic["check_steps"], self.steps)
        pairs = ref_mod.time_pairs(self.shard.shape[1], self.traffic["transitions"])
        stats = ref_mod.shard_stats(self.shard, self.cfg["out_channels"])
        batches = [ref_mod.assemble(self.shard, stats, pairs, self.samples[s],
                                    self.cfg["out_channels"]) for s in range(check + 1)]
        ref = ref_mod.replay(self.cfg, draw_weights(self.shapes, self.seed, self.device),
                             batches, self.total_steps, self.cfg["trainer_seed"] + 1)
        P = len(self.shapes)
        at = np.concatenate([np.full(len(rows), b + 1) for b, rows in items])
        got = got.astype(np.float64)

        def gap(mine, want):
            return np.abs(mine - want) / np.maximum(want, np.median(want, axis=1, keepdims=True))

        loss_gap = np.abs(got[:, 0] - ref["loss"][at]) / np.abs(ref["loss"][at])
        grad_gap = gap(got[:, 1:1 + P], ref["grad"][at])
        warm = gap(self.warm_grads.double().cpu().numpy()[None], ref["grad"][:1])
        moves = ref["grad"][0] >= NOUGHT_GRAD * np.median(ref["grad"][0])
        param_gap = gap(got[:, 1 + P:], ref["moved"][at])[:, moves]
        lost = set(range(check)) - {b for b, _ in items}
        unbounded = float("inf") if lost else 0.0
        return {"loss_gap": max(float(loss_gap.max()), unbounded),
                "grad_gap": max(float(grad_gap.max()), unbounded),
                "param_gap": max(float(param_gap.max()), unbounded),
                "warmup_grad_gap": float(warm.max()),
                "steps_compared": float(len(items)), "steps_lost": float(len(lost)),
                "leaves_left_out": float((~moves).sum())}
