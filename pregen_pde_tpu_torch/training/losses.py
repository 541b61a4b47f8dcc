"""Relative-Lp losses and per-channel-group variants (counterpart of the JAX
package's ``training/losses.py``).

Loss of record across the reference's stacks: relative L1
(`CNO_timeModule_CIN.py:938-939`), per-channel-group normalised L1/L2
(`scOT/model.py:1376-1435`), masked MSE (`scripts/train.py:161-169`).
"""

from __future__ import annotations

from typing import Sequence

import torch


def relative_lp_loss(pred: torch.Tensor, target: torch.Tensor, p: int = 1, eps: float = 1e-10,
                     reduce_batch: bool = True) -> torch.Tensor:
    """mean over batch of ||pred − target||_p / (||target||_p + eps), norms
    over all non-batch axes."""
    axes = tuple(range(1, pred.ndim))
    if p == 1:
        num = (pred - target).abs().sum(axes)
        den = target.abs().sum(axes)
    else:
        num = ((pred - target).abs() ** p).sum(axes) ** (1.0 / p)
        den = (target.abs() ** p).sum(axes) ** (1.0 / p)
    rel = num / (den + eps)
    return rel.mean() if reduce_batch else rel


def grouped_relative_lp_loss(pred: torch.Tensor, target: torch.Tensor,
                             channel_groups: Sequence[Sequence[int]], p: int = 1,
                             eps: float = 1e-10) -> torch.Tensor:
    """Mean of per-group relative Lp over channel groups (scOT's
    `channel_slice_list_normalized_loss`)."""
    losses = [relative_lp_loss(pred[..., list(g)], target[..., list(g)], p=p, eps=eps)
              for g in channel_groups]
    return torch.stack(losses).mean()


def masked_mse(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """MSE over valid (fluid) pixels only; valid broadcastable to pred, 1 =
    count."""
    num = (((pred - target) ** 2) * valid).sum()
    den = torch.broadcast_to(valid, pred.shape).sum() + eps
    return num / den
