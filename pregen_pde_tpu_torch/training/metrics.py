"""Evaluation metrics: median/mean relative Lp errors (%), per channel (the
port's copy of the JAX package's ``training/metrics.py``).

Mirrors `scOT/metrics.py` (`lp_error :4`, `relative_lp_error :12`) and the
CNO median/mean validation tracking (`CNO_timeModule_CIN.py:1379-1439`).
Pure numpy — runs on host over accumulated predictions.
"""

from __future__ import annotations

import numpy as np


def lp_error(pred: np.ndarray, target: np.ndarray, p: int = 1) -> np.ndarray:
    """Per-sample absolute Lp error, summed over all non-batch axes."""
    axes = tuple(range(1, pred.ndim))
    return (np.abs(pred - target) ** p).sum(axis=axes) ** (1.0 / p)


def relative_lp_error(
    pred: np.ndarray, target: np.ndarray, p: int = 1, percent: bool = True,
    eps: float = 1e-10,
) -> np.ndarray:
    """Per-sample relative Lp error (optionally in %)."""
    num = lp_error(pred, target, p)
    den = lp_error(np.zeros_like(target), target, p) + eps
    rel = num / den
    return rel * 100.0 if percent else rel


def error_summary(pred: np.ndarray, target: np.ndarray, p: int = 1) -> dict:
    return summarize_rel_errors(relative_lp_error(pred, target, p))


def summarize_rel_errors(rel: np.ndarray) -> dict:
    """Summary stats over per-sample relative errors (already in %). Lets
    evaluation STREAM batches — only the (B,) per-sample scalars are kept per
    batch, never the full prediction fields (`Trainer.evaluate`)."""
    rel = np.asarray(rel)
    return {
        "median_rel_%": float(np.median(rel)),
        "mean_rel_%": float(np.mean(rel)),
        "std_rel_%": float(np.std(rel)),
        "min_rel_%": float(np.min(rel)),
        "max_rel_%": float(np.max(rel)),
    }


def parse_label_description(label_description: str):
    """Reference channel-group grammar → (names, channel slices).

    ``"[rho],[u,v],[p]"`` → (["rho", "uv", "p"], [slice(0,1), slice(1,3),
    slice(3,4)]) — ≡ `scOT/problems/base.py::get_channel_lists :284-296`
    (offsets list there; concrete slices here) and the CNO stacks'
    ``separate_dim`` convention (`TestCNO_ALL.py:98-101`: [1,2,1] → the same
    cumulative channel blocks)."""
    import re

    matches = re.findall(r"\[([^\[\]]+)\]", label_description)
    names, slices, off = [], [], 0
    for m in matches:
        parts = m.split(",")
        names.append("".join(parts) if len(parts) > 1 else m)
        slices.append(slice(off, off + len(parts)))
        off += len(parts)
    return names, slices


def grouped_error_summary(
    pred: np.ndarray, target: np.ndarray, label_description: str, p: int = 1,
) -> dict:
    """Per-channel-group error summaries (the reference's per-variable
    reporting: scOT `compute_metrics` per `channel_slice_list`
    (`scOT/train.py:455-523`); CNO `separate_dim` branches
    (`TestCNO_ALL.py:166-186`)). Channels on the LAST axis (NHWC)."""
    names, slices = parse_label_description(label_description)
    out = {}
    for name, sl in zip(names, slices):
        out[name] = summarize_rel_errors(
            relative_lp_error(pred[..., sl], target[..., sl], p=p)
        )
    out["all"] = error_summary(pred, target, p=p)
    return out
