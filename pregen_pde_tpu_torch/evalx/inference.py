"""Inference tools beyond plain rollouts (counterpart of
``evalx/inference.py``): ``accumulation_error``, the per-step error growth
under homogeneous AR rollout, and the model's FFT resolution transfer
``fft_resize``. The resolution study, sample dumps and the benchmark AR
evaluation wait for later slices.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pregen_pde_tpu_torch.models.scot import fft_resize
from pregen_pde_tpu_torch.training.datasets import TIME_NORMALIZER
from pregen_pde_tpu_torch.training.metrics import relative_lp_error
from pregen_pde_tpu_torch.utils.device import resolve_device

__all__ = ["accumulation_error", "fft_resize"]


def _prep_inputs(dataset, idx, out_channels):
    frames0 = dataset.data[idx, 0].astype(np.float32).copy()
    frames0[..., :out_channels] = (frames0[..., :out_channels] - dataset.mean) / dataset.std
    if dataset.cfg.time_input:
        tch = np.zeros((*frames0.shape[:3], 1), np.float32)
        frames0 = np.concatenate([frames0, tch], axis=-1)
    return frames0


@torch.inference_mode()
def accumulation_error(
    model: Callable,
    dataset,
    max_steps: int = 7,
    batch_size: int = 16,
    out_channels: int = 3,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """Roll 1-step jumps ``max_steps`` times; report the error against the
    truth at each step. ``device`` defaults to the card and raises where
    there is none; pass ``"cpu"`` for the CPU."""
    device = resolve_device(device)
    n, start = dataset.n_traj, dataset.start
    ts = dataset.cfg.time_step_size
    lead = ts / TIME_NORMALIZER  # one time_step_size jump per AR step
    errors = [[] for _ in range(max_steps)]
    for s in range(0, n, batch_size):
        idx = np.arange(start + s, start + min(s + batch_size, n))
        x = torch.from_numpy(_prep_inputs(dataset, idx, out_channels)).to(device)
        t = torch.full((x.shape[0],), lead, dtype=x.dtype, device=x.device)
        for step in range(1, max_steps + 1):
            if dataset.cfg.time_input:
                x = torch.cat([x[..., :-1], torch.full_like(x[..., -1:], lead)], dim=-1)
            pred = model(x, t)
            lab = dataset.data[idx, step * ts, :, :, :out_channels].astype(np.float32)
            lab = (lab - dataset.mean) / dataset.std
            errors[step - 1].append(relative_lp_error(pred.float().cpu().numpy(), lab))
            x = torch.cat([pred.to(x.dtype), x[..., out_channels:]], dim=-1)
    return [
        {"step": i + 1,
         "median_rel_%": float(np.median(np.concatenate(e))),
         "mean_rel_%": float(np.mean(np.concatenate(e)))}
        for i, e in enumerate(errors)
    ]
