"""Autoregressive rollout evaluation (counterpart of ``evalx/rollout.py``).

A pattern is a list of time jumps: direct prediction ([k]), heterogeneous
AR ([2, 2, 2, 1]) or homogeneous AR ([1]*k). After each jump the prediction
replaces the physical channels of the input while the static channels (Re,
mask, SDF) are kept and the lead-time channel is rewritten.

``model`` is any callable ``model(x, t) -> prediction`` on NHWC tensors (a
``ScOT`` in eval mode); inputs go to ``device``, errors are computed on the
host in numpy. The evaluations run under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from pregen_pde_tpu_torch.training.datasets import TIME_NORMALIZER
from pregen_pde_tpu_torch.utils.device import resolve_device
from pregen_pde_tpu_torch.training.metrics import error_summary, grouped_error_summary


def rollout_pattern(
    model: Callable,
    inp: torch.Tensor,  # (B, H, W, Cin), normalised, time channel last if present
    pattern: Sequence[int],
    time_channel: bool = True,
    out_channels: int = 3,
    time_step_size: int = 1,
    time_normalizer: float = TIME_NORMALIZER,
) -> list[torch.Tensor]:
    """Run the AR pattern, returning the prediction after each jump. The
    lead time of a jump is jump·time_step_size/time_normalizer. (The JAX
    function's prediction forcing, ``pixel_mask``, waits for a caller.)"""
    preds = []
    x = inp
    for jump in pattern:
        lead = jump * time_step_size / time_normalizer
        t = torch.full((x.shape[0],), lead, dtype=x.dtype, device=x.device)
        if time_channel:
            x = torch.cat([x[..., :-1], torch.full_like(x[..., -1:], lead)], dim=-1)
        pred = model(x, t)
        preds.append(pred)
        x = torch.cat([pred.to(x.dtype), x[..., out_channels:]], dim=-1)
    return preds


@torch.inference_mode()
def evaluate_patterns(
    model: Callable,
    dataset,
    patterns: Sequence[Sequence[int]],
    batch_size: int = 16,
    out_channels: int = 3,
    label_description: str | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, dict]:
    """For each pattern, roll out from the t = 0 inputs of the dataset's
    trajectories and score the final state against the true frame at
    t = sum(pattern). ``device`` defaults to the card and raises where
    there is none; pass ``"cpu"`` for the CPU."""
    device = resolve_device(device)
    from pregen_pde_tpu_torch.evalx.inference import _prep_inputs

    start, n = dataset.start, dataset.n_traj
    results = {}
    for pattern in patterns:
        t_final = int(np.sum(pattern)) * dataset.cfg.time_step_size
        preds_all, labs_all = [], []
        for s in range(0, n, batch_size):
            idx = np.arange(start + s, start + min(s + batch_size, n))
            inp = torch.from_numpy(_prep_inputs(dataset, idx, out_channels)).to(device)
            preds = rollout_pattern(model, inp, pattern, time_channel=dataset.cfg.time_input,
                                    out_channels=out_channels,
                                    time_step_size=dataset.cfg.time_step_size)
            lab = dataset.data[idx, t_final, :, :, :out_channels].astype(np.float32)
            preds_all.append(preds[-1].float().cpu().numpy())
            labs_all.append((lab - dataset.mean) / dataset.std)
        pa, la = np.concatenate(preds_all), np.concatenate(labs_all)
        key = str(list(pattern))
        results[key] = (grouped_error_summary(pa, la, label_description)
                        if label_description is not None else error_summary(pa, la))
    return results
