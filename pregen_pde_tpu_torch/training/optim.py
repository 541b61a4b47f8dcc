"""The optimizer of the trainer: AdamW with tiered learning rates, the JAX
package's schedules and global-norm clipping (counterpart of
``build_optimizer``, ``pregen_pde_tpu/training/trainer.py:93-146``).

The update is optax's arithmetic, written out in torch ``_foreach`` ops:

- ``optax.clip_by_global_norm(max)`` over every gradient, outside the
  tiers: the gradients are replaced by ``(g / ‖g‖) · max`` only when
  ``‖g‖ ≥ max`` (``torch.nn.utils.clip_grad_norm_`` would scale by
  ``max / (‖g‖ + 1e-6)`` whenever it exceeds max);
- then per tier ``optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8,
  weight_decay, mask)``: ``m = (1−b1) g + b1 m``, ``v = (1−b2) g² + b2 v``,
  ``u = m̂ / (√v̂ + eps)`` with the bias corrections at t = count + 1,
  ``u += wd · p`` where the tier decays the parameter (decoupled, the
  pre-update parameter), ``p += −lr(count) · u``;
- the schedule is evaluated at the count *before* the update (0 at the
  first step), with ``total_steps = epochs × steps_per_epoch``.

On a CUDA device the same arithmetic runs as the hand-written kernels of
``ops/adamw.py`` (``csrc/adamw.cu``): the clip's norm and the update of
every leaf in two launches, operation by operation as the ``_foreach``
route rounds them, so the results are bit-equal to it unless the clip
engages (then the norm's order of summation differs). A CUDA leaf that is
not float32 and contiguous raises; leaves on the CPU take the ``_foreach``
route.

Decay semantics of a tier: "all" decays every member (biases too),
"none" nothing, "matrix" the parameters of two or more dimensions (the
port's parameters have the flax leaves' ranks).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pregen_pde_tpu_torch.ops import adamw

B1, B2, EPS = 0.9, 0.999, 1e-8


def make_schedule(kind: str, lr: float, total_steps: int,
                  warmup_frac: float = 0.0) -> Callable[[int], float]:
    """count → learning rate: optax's ``cosine_decay_schedule`` (or
    ``warmup_cosine_decay_schedule(0, lr, warmup, total)``, whose warmup
    counts inside ``total``), ``exponential_decay(lr, total // 3, 0.1,
    staircase=True)`` for "step", else constant."""
    total = max(total_steps, 1)

    def cosine(peak: float, decay_steps: int):
        if decay_steps <= 0:
            raise ValueError(f"the cosine schedule needs positive decay steps, got {decay_steps}")
        return lambda c: peak * 0.5 * (1.0 + math.cos(math.pi * min(c, decay_steps) / decay_steps))

    if kind == "cosine":
        warmup = int(warmup_frac * total)
        if warmup > 0:
            decay = cosine(lr, total - warmup)
            return lambda c: (lr * min(max(c, 0), warmup) / warmup if c < warmup
                              else decay(c - warmup))
        return cosine(lr, total)
    if kind == "step":
        every = max(total // 3, 1)
        return lambda c: lr if c <= 0 else lr * 0.1 ** math.floor(c / every)
    if kind == "constant":
        return lambda c: lr
    raise ValueError(f"unknown schedule {kind!r}; one of cosine, step, constant")


class TieredAdamW:
    """AdamW over parameter groups, each with its own schedule and decay
    flags, after one global-norm clip of all gradients. ``step()`` reads
    ``p.grad``; a parameter without a gradient takes a zero gradient, as a
    leaf of a JAX gradient tree would."""

    def __init__(self, groups: list[dict], weight_decay: float, grad_clip: float | None):
        """``groups``: dicts with "name", "params" (list), "decay" (list of
        bool, one per parameter) and "schedule" (count → lr)."""
        self.groups = groups
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.params = [p for g in groups for p in g["params"]]
        self.reset()

    def reset(self) -> None:
        """Moments to zero and the count to 0 (``tx.init``); on a CUDA device
        the kernels' rows over the new moments."""
        self.count = 0
        self.m = {id(p): torch.zeros_like(p) for p in self.params}
        self.v = {id(p): torch.zeros_like(p) for p in self.params}
        self.fused = None
        if adamw.on_card(self.params):
            self.fused = adamw.FusedAdamW(
                self.params, [self.m[id(p)] for p in self.params],
                [self.v[id(p)] for p in self.params],
                [i for i, g in enumerate(self.groups) for _ in g["params"]],
                [d for g in self.groups for d in g["decay"]])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        if self.fused is not None:
            t = self.count + 1
            self.fused.step(self.m.values(), self.v.values(),
                            [-g["schedule"](self.count) for g in self.groups], 1.0 - B1 ** t,
                            1.0 - B2 ** t, B1, B2, EPS, self.weight_decay, self.grad_clip)
            self.count += 1
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.grad_clip
            one = torch.ones((), dtype=norm.dtype, device=norm.device)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip))
        by_id = {id(p): g for p, g in zip(self.params, grads)}
        t = self.count + 1
        bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
        for group in self.groups:
            lr = group["schedule"](self.count)
            for decay in (True, False):
                ps = [p for p, d in zip(group["params"], group["decay"]) if d == decay]
                if not ps:
                    continue
                g = [by_id[id(p)] for p in ps]
                m = [self.m[id(p)] for p in ps]
                v = [self.v[id(p)] for p in ps]
                new_m = torch._foreach_add(torch._foreach_mul(g, 1.0 - B1),
                                           torch._foreach_mul(m, B1))
                new_v = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2),
                                           torch._foreach_mul(v, B2))
                for dst, src in ((m, new_m), (v, new_v)):
                    torch._foreach_copy_(dst, src)
                denom = torch._foreach_sqrt(torch._foreach_div(new_v, bc2))
                torch._foreach_add_(denom, EPS)
                u = torch._foreach_div(torch._foreach_div(new_m, bc1), denom)
                if decay and self.weight_decay:
                    torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
                torch._foreach_add_(ps, torch._foreach_mul(u, -lr))
        self.count += 1


def build_optimizer(cfg, steps_per_epoch: int, named_params, tier_fn=None,
                    tier_decay: dict[str, str] | None = None) -> TieredAdamW:
    """``cfg``: a ``TrainerConfig``. With ``cfg.lr_tiers`` and ``tier_fn``
    (parameter name → tier) one group per tier, each with its lr and the
    decay semantics of ``tier_decay`` (default "matrix"); else one group at
    ``cfg.learning_rate`` with ``cfg.decay_mask_mode``."""
    total = max(cfg.epochs * steps_per_epoch, 1)
    named = list(named_params)

    def decays(mode: str, p) -> bool:
        if mode not in ("all", "none", "matrix"):
            raise ValueError(f"unknown decay mode {mode!r}")
        return mode == "all" or (mode == "matrix" and p.ndim >= 2)

    def group(name, lr, members, mode):
        return {"name": name, "params": [p for _, p in members],
                "decay": [decays(mode, p) for _, p in members],
                "schedule": make_schedule(cfg.schedule, lr, total, cfg.warmup_frac)}

    if cfg.lr_tiers and tier_fn is not None:
        labels = {n: tier_fn(n) for n, _ in named}
        unknown = set(labels.values()) - set(cfg.lr_tiers)
        if unknown:
            raise ValueError(f"parameters labelled with tiers {sorted(unknown)} that "
                             f"lr_tiers {sorted(cfg.lr_tiers)} does not name")
        groups = [group(t, lr, [(n, p) for n, p in named if labels[n] == t],
                        (tier_decay or {}).get(t, "matrix"))
                  for t, lr in cfg.lr_tiers.items()]
    else:
        groups = [group("all", cfg.learning_rate, named, cfg.decay_mask_mode)]
    return TieredAdamW([g for g in groups if g["params"]], cfg.weight_decay, cfg.grad_clip)
