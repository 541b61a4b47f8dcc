"""The training harness (counterpart of the JAX package's
``training/trainer.py``) for the port's models.

- AdamW with the JAX package's schedules, tiered learning rates and the
  global-norm clip outside the tiers (``training/optim.py``);
- the train step: ``model.train()``, forward, relative-Lp loss in float32,
  backward (through the kernels' backward on a CUDA device), clip, update;
  its phases are the spans ``pregen.train.h2d`` (the batch onto the
  device), ``.forward`` (the model and the loss), ``.backward`` (the last
  step's gradients dropped, then ``loss.backward()``) and ``.optimizer``
  (the clip and the update), each around what it enqueues, with no sync
  (``utils/trace.py``);
- the eval step: the per-sample relative-Lp error in %, reduced on the
  device, so only (B,) numbers per batch leave it;
- ``fit``: the epoch mean of the loss, ``mean_val_rel_%`` over the val
  loaders, best-parameter tracking (a copy of the state_dict on the
  device), early stopping, and the best parameters written as a ``.pt``
  state_dict, ``<ckpt_dir>/best.pt``, on every improvement (in place of the
  JAX package's orbax manager);
- drop-path draws from a ``torch.Generator`` on the model's device seeded
  from ``seed + 1`` and owned by the trainer (the JAX trainer's dropout
  key); its stream differs from JAX's threefry, its law does not.

The JAX fields this slice does not port (``compute_dtype`` other than
float32, ``remat``, ``zero_stage``, ``fused_optimizer``) raise when set.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from pregen_pde_tpu_torch.training.losses import relative_lp_loss
from pregen_pde_tpu_torch.training.metrics import summarize_rel_errors
from pregen_pde_tpu_torch.training.optim import build_optimizer
from pregen_pde_tpu_torch.utils.trace import span

CKPT_NAME = "best.pt"


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX ``TrainerConfig``: the same fields and defaults."""

    learning_rate: float = 5e-5
    weight_decay: float = 1e-10
    epochs: int = 10
    batch_size: int = 16
    schedule: str = "cosine"  # "cosine" | "constant" | "step"
    warmup_frac: float = 0.0
    grad_clip: float = 5.0
    early_stop_patience: int | None = 100
    loss_p: int = 1
    seed: int = 0
    ckpt_dir: str | None = None
    lr_tiers: dict[str, float] | None = None
    decay_mask_mode: str = "matrix"
    compute_dtype: str | None = None
    remat: bool = False
    zero_stage: int | None = None
    fused_optimizer: bool = False

    def __post_init__(self):
        later = {
            "compute_dtype": (self.compute_dtype not in (None, "float32"),
                              "bfloat16 compute waits for a tested bf16 K3 backward"),
            "remat": (self.remat, "activation recomputation is a later slice"),
            "zero_stage": (self.zero_stage is not None, "ZeRO/FSDP comes with the parallelism "
                           "slice"),
            "fused_optimizer": (self.fused_optimizer, "the bucketed optimizer is not ported "
                                "(a measured loser in JAX)"),
        }
        for field, (bad, why) in later.items():
            if bad:
                raise NotImplementedError(f"TrainerConfig.{field} is not ported: {why}")


class Trainer:
    def __init__(self, model: torch.nn.Module, cfg: TrainerConfig, loss_fn: Callable | None = None,
                 tier_fn: Callable[[str], str] | None = None,
                 tier_decay: dict[str, str] | None = None, device=None):
        """``tier_fn``: parameter name → tier (``tiers.scot_tier_of``), used
        with ``cfg.lr_tiers``; ``tier_decay``: tier → decay semantics.
        ``device``: where the model trains (default: where it is)."""
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self.model = model.to(self.device)
        self.loss_fn = loss_fn or (lambda pred, lab: relative_lp_loss(pred, lab, p=cfg.loss_p))
        self.tier_fn = tier_fn
        self.tier_decay = tier_decay
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        if hasattr(model, "set_dropout_generator"):
            model.set_dropout_generator(self.generator)
        self.optimizer = None
        self.steps_per_epoch = 1
        self.history: list[dict] = []
        self.best_metric = float("inf")
        self.best_params: dict[str, torch.Tensor] | None = None
        self.ckpt_path = Path(cfg.ckpt_dir) / CKPT_NAME if cfg.ckpt_dir else None

    # -- setup ---------------------------------------------------------------

    def init_state(self, sample_batch: dict | None = None, steps_per_epoch: int = 1):
        """The optimizer over the model's parameters as they stand (its own
        init, or weights loaded into it). ``sample_batch`` is not needed by
        a torch model and is accepted for the JAX signature."""
        self.steps_per_epoch = steps_per_epoch
        self.optimizer = build_optimizer(self.cfg, steps_per_epoch, self.model.named_parameters(),
                                         self.tier_fn, self.tier_decay)
        return self.optimizer

    def replace_params(self, state_dict: dict) -> None:
        """Load new parameters and restart the optimizer on them (moments
        at zero, the schedule at count 0), as the JAX ``replace_params``."""
        self.model.load_state_dict(state_dict)
        if self.optimizer is None:
            self.init_state(steps_per_epoch=self.steps_per_epoch)
        else:
            self.optimizer.reset()

    # -- steps ---------------------------------------------------------------

    def _batch(self, batch: dict):
        put = lambda a: torch.as_tensor(np.asarray(a)).to(self.device)
        return put(batch["input"]), put(batch["time"]), put(batch["label"])

    def train_step(self, batch: dict) -> torch.Tensor:
        """One update; returns the loss as a device scalar (no host sync)."""
        with span("pregen.train.h2d"):
            inp, time, lab = self._batch(batch)
        self.model.train()
        with span("pregen.train.forward"):
            loss = self.loss_fn(self.model(inp, time).float(), lab)
        with span("pregen.train.backward"):
            self.optimizer.zero_grad()
            loss.backward()
        with span("pregen.train.optimizer"):
            self.optimizer.step()
        return loss.detach()

    @torch.inference_mode()
    def eval_step(self, batch: dict) -> torch.Tensor:
        """Per-sample relative-Lp errors (%), shape (B,), on the device."""
        inp, time, lab = self._batch(batch)
        self.model.eval()
        pred = self.model(inp, time).float()
        lab = lab.float()
        p = self.cfg.loss_p
        axes = tuple(range(1, pred.ndim))
        num = ((pred - lab).abs() ** p).sum(axes) ** (1.0 / p)
        den = (lab.abs() ** p).sum(axes) ** (1.0 / p) + 1e-10
        return num / den * 100.0

    # -- loops ---------------------------------------------------------------

    def evaluate(self, loader) -> dict:
        rel = [self.eval_step(batch) for batch in loader]
        return summarize_rel_errors(torch.cat(rel).cpu().numpy())

    def fit(self, train_loader, val_loaders: dict[str, Any] | None = None,
            log_fn: Callable[[dict], None] | None = None) -> dict:
        cfg = self.cfg
        if self.optimizer is None:
            # the JAX fit peeks one batch to initialise; so does this one, so
            # that the loader's shuffle stream stands where the JAX one does
            self.init_state(next(iter(train_loader)), steps_per_epoch=len(train_loader))
        patience_left = cfg.early_stop_patience or np.inf
        for epoch in range(cfg.epochs):
            t0 = _time.time()
            losses = [self.train_step(batch) for batch in train_loader]
            train_loss = float(torch.stack(losses).mean()) if losses else np.nan
            rec = {"epoch": epoch, "train_loss": train_loss, "time_s": _time.time() - t0}
            if val_loaders:
                vals = []
                for name, vl in val_loaders.items():
                    s = self.evaluate(vl)
                    rec[f"{name}_median_rel_%"] = s["median_rel_%"]
                    rec[f"{name}_mean_rel_%"] = s["mean_rel_%"]
                    vals.append(s["mean_rel_%"])
                mean_val = float(np.mean(vals))
                rec["mean_val_rel_%"] = mean_val
                if mean_val < self.best_metric:
                    self.best_metric = mean_val
                    self.best_params = {k: v.detach().clone()
                                        for k, v in self.model.state_dict().items()}
                    patience_left = cfg.early_stop_patience or np.inf
                    self._save_ckpt()
                else:
                    patience_left -= 1
            self.history.append(rec)
            if log_fn:
                log_fn(rec)
            if patience_left <= 0:
                break
        return {"best_metric": self.best_metric, "history": self.history}

    # -- checkpointing -------------------------------------------------------

    def _save_ckpt(self) -> None:
        if self.ckpt_path is None:
            return
        self.ckpt_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.ckpt_path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({k: v.cpu() for k, v in self.best_params.items()}, tmp)
        os.replace(tmp, self.ckpt_path)

    def restore_best(self) -> None:
        if self.best_params is not None:
            self.model.load_state_dict(self.best_params)

    def restore_latest(self) -> Path | None:
        """Load ``<ckpt_dir>/best.pt`` into the model (parameters only, as
        the JAX resume); None when there is none yet."""
        if self.ckpt_path is None:
            raise RuntimeError("no ckpt_dir configured")
        if not self.ckpt_path.is_file():
            return None
        self.model.load_state_dict(torch.load(self.ckpt_path, map_location=self.device,
                                              weights_only=True))
        return self.ckpt_path
