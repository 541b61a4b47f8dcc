"""Test fixture: a training driver, the shape of a model cell's. It runs
the port's ``training/trainer.py::Trainer.train_step`` on the port's
``FNO2d`` at a tiny size, one optimizer step a window batch.

A row is one sample of the step's batch: ``run`` returns (B, 1 + P), each
row the step's loss and each parameter's ‖θ − θ₀‖₂ after the update (θ₀ the
weights drawn in set-up), so a row is delivered (finite) only when the
step's loss and its updated parameters are. ``traj_per_s`` then reads
samples per second.

Inputs, drawn in set-up from the seed: the weights (``draw_weights``, in
the reference's parameter order, two large draws) and a ring of batches in
the sample layout of ``training/datasets.py`` (``draw_batches``). Step s
of the run (s = 0 the warm-up, s = b + 1 window batch b) trains on ring
batch s mod R, and R exceeds the steps the check follows, so those all
train on different samples.

The check follows the steps a sequence makes: step b depends on every step
before it, the warm-up's too. ``keep`` keeps the window's first
``check_steps`` steps only, so the replay's length does not grow with the
window; after ``release`` ``compare`` draws the weights and batches again
from the seed and replays the warm-up and those steps with the plain
reference (``reference/tiny_train.py``, beside this folder).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench import run as harness

# a leaf whose first gradient is under this share of the median leaf's moves
# under Adam by round-off alone, and its change is left out of param_gap
NOUGHT_GRAD = 1e-3


def reference():
    return harness.load_module(Path(__file__).resolve().parents[1], "reference", "tiny_train")


def draw_weights(shapes: list, seed: int, device: torch.device) -> dict:
    """The model's initial weights from the seed: Dense weights a normal
    over √fan_in, biases zero, spectral weights uniform on [0, 1/(C·O)),
    the laws of the model's own init, from one normal and one uniform draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(int(np.prod(s)) for _, s in shapes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        size = int(np.prod(shape))
        if name.endswith(".bias"):
            w = torch.zeros(shape, device=device)
        elif name.startswith("SpectralConv2d"):
            w = uniform[at:at + size].reshape(shape) / (shape[0] * shape[-1])
        else:
            w = normal[at:at + size].reshape(shape) / shape[1] ** 0.5
        out[name] = w
        at += size
    return out


def draw_batches(cfg: dict, traffic: dict, seed: int, device: torch.device) -> list:
    """``ring_batches`` batches {"time": (B,), "input": (B, n, n, 7),
    "label": (B, n, n, 3)} as numpy float32, the loaders' layout: input the
    contract's six channels [Ux, Uy, p (z-scored), Re_norm, mask, SDF] and
    the constant lead-time channel (t2 − t1)/19."""
    R, B, n = traffic["ring_batches"], traffic["batch_size"], cfg["resolution"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    fields = torch.randn(R, B, n, n, 4, generator=gen, device=device)  # Ux, Uy, p, SDF
    re_norm = torch.randn(R, B, 1, 1, 1, generator=gen, device=device)
    mask = (torch.rand(R, B, n, n, 1, generator=gen, device=device) < 0.2).float()
    lead = torch.randint(1, 21, (R, B), generator=gen, device=device).float() / 19.0
    label = torch.randn(R, B, n, n, 3, generator=gen, device=device)
    inp = torch.cat([fields[..., :3], re_norm.expand(R, B, n, n, 1), mask, fields[..., 3:],
                     lead[..., None, None, None].expand(R, B, n, n, 1)], dim=-1)
    inp, label, lead = inp.cpu().numpy(), label.cpu().numpy(), lead.cpu().numpy()
    return [{"time": lead[r], "input": inp[r], "label": label[r]} for r in range(R)]


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        from pregen_pde_tpu_torch.models.fno import FNO2d
        from pregen_pde_tpu_torch.training.trainer import Trainer, TrainerConfig

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch_size = traffic["batch_size"]
        self.shapes = reference().param_shapes(cfg)
        model = FNO2d(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                      modes=cfg["modes"], width=cfg["width"], n_layers=cfg["n_layers"],
                      pad_frac=cfg["pad_frac"], head_width=cfg["head_width"])
        model.to(device).load_state_dict(draw_weights(self.shapes, seed, device))
        self.trainer = Trainer(model, TrainerConfig(
            learning_rate=cfg["learning_rate"], weight_decay=cfg["weight_decay"],
            schedule=cfg["schedule"], grad_clip=cfg["grad_clip"], loss_p=1,
            batch_size=self.batch_size, seed=seed), device=device)
        self.trainer.init_state()
        self.ring = draw_batches(cfg, traffic, seed, device)
        named = dict(model.named_parameters())
        self.params = [named[n] for n, _ in self.shapes]
        self.start = [p.detach().clone() for p in self.params]
        self.steps = 0  # window steps entered

    def warm_up(self) -> None:
        """Step 0, on ring batch 0: the replay counts it."""
        self.trainer.train_step(self.ring[0])

    def run(self, b: int) -> np.ndarray:
        self.steps = b + 1
        loss = self.trainer.train_step(self.ring[(b + 1) % len(self.ring)])
        with torch.no_grad():
            moved = [torch.linalg.vector_norm(p - s) for p, s in zip(self.params, self.start)]
            row = torch.cat([loss.reshape(1).float(), torch.stack(moved)]).cpu().numpy()
        return np.repeat(row[None], self.batch_size, axis=0)

    def keep(self, b: int) -> np.ndarray:
        if b < self.traffic["check_steps"]:
            return np.arange(self.batch_size)
        return np.zeros(0, dtype=np.int64)

    def counters(self) -> dict:
        return {"optimizer_steps": self.trainer.optimizer.count}

    def batch_info(self, b: int, finite: np.ndarray) -> dict:
        return {}

    def release(self) -> None:
        del self.trainer, self.params, self.start, self.ring
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, items: list, got: np.ndarray, limits: dict) -> dict:
        """The program's kept rows against the plain replay of the same
        steps from the same seed. ``loss_gap``: the widest relative gap of
        a step's loss. ``param_gap``: the widest, over the kept steps and the
        parameters, of the gap between the program's ‖θ − θ₀‖ and the
        reference's, over the reference's or the median parameter's,
        whichever is larger (parameters whose first gradient is nought to
        rounding left out). A kept step that the window entered and that
        left no finite row (it raised, or its loss or parameters went
        non-finite) reads an unbounded gap."""
        check = min(self.traffic["check_steps"], self.steps)
        ring = draw_batches(self.cfg, self.traffic, self.seed, self.device)
        ref = reference().replay(self.cfg, draw_weights(self.shapes, self.seed, self.device),
                                 [ring[s % len(ring)] for s in range(check + 1)])
        at = np.concatenate([np.full(len(rows), b + 1) for b, rows in items])
        want_loss, want_moved = ref["loss"][at], ref["moved"][at]
        got = got.astype(np.float64)
        loss_gap = np.abs(got[:, 0] - want_loss) / np.abs(want_loss)
        moves = ref["grad0"] >= NOUGHT_GRAD * np.median(ref["grad0"])
        scale = np.maximum(want_moved, np.median(want_moved, axis=1, keepdims=True))
        param_gap = (np.abs(got[:, 1:] - want_moved) / scale)[:, moves]
        lost = set(range(check)) - {b for b, _ in items}
        unbounded = float("inf") if lost else 0.0
        return {"loss_gap": max(float(loss_gap.max()), unbounded),
                "param_gap": max(float(param_gap.max()), unbounded),
                "steps_compared": float(len(items)), "steps_lost": float(len(lost))}
