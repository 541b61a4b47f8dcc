"""Bias + activation + gain + clamp (port of the JAX package's
``ops/bias_act.py``), the activation table with its default alphas and
gains.

The JAX package computes this in XLA, fused into its neighbours, and
differentiates it by autodiff; the port computes it in plain PyTorch and
autograd gives the gradient. The port works in NCHW, so the channel axis
defaults to 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class _Act:
    func: Callable
    def_alpha: float
    def_gain: float


def _leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    # jax.nn.leaky_relu: slope 1 at exactly 0 (torch's takes alpha there)
    return torch.where(x >= 0, x, x * alpha)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20
    return torch.logaddexp(x, torch.zeros_like(x))


activation_funcs: dict[str, _Act] = {
    "linear": _Act(lambda x, alpha: x, 0.0, 1.0),
    "relu": _Act(lambda x, alpha: torch.relu(x), 0.0, float(np.sqrt(2))),
    "lrelu": _Act(_leaky_relu, 0.2, float(np.sqrt(2))),
    "tanh": _Act(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _Act(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _Act(lambda x, alpha: torch.nn.functional.elu(x), 0.0, 1.0),
    "selu": _Act(lambda x, alpha: torch.selu(x), 0.0, 1.0),
    "softplus": _Act(lambda x, alpha: _softplus(x), 0.0, 1.0),
    "swish": _Act(lambda x, alpha: torch.sigmoid(x) * x, 0.0, float(np.sqrt(2))),
}


def bias_act(
    x: torch.Tensor,
    b: torch.Tensor | None = None,
    dim: int = 1,
    act: str = "linear",
    alpha: float | None = None,
    gain: float | None = None,
    clamp: float | None = None,
) -> torch.Tensor:
    """act(x + b broadcast along `dim`) * gain, then clamp to ±clamp."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    if b is not None:
        assert b.ndim == 1 and b.shape[0] == x.shape[dim]
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        assert clamp >= 0
        x = torch.clamp(x, -clamp, clamp)
    return x
