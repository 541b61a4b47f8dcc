"""FNO, the 2-D Fourier Neural Operator (port of ``models/fno.py``), NHWC.

Lift (a Dense on [input channels, x-grid, y-grid]) → zero-pad the domain by
``pad_frac`` at the bottom and right → n_layers × (truncated-mode spectral
conv + Dense, GELU between layers only) → crop → a two-layer head → the
output, re-masked by the validity channel when ``mask_channel`` is set.

The parameters keep flax's names, creation order and layouts, so a flax tree
maps onto the state_dict by joining its paths (``models/convert.py``): the
lift ``Dense_0``, then ``SpectralConv2d_k`` and ``Dense_{k+1}`` for each
layer, then the head's ``Dense_{n+1}`` and ``Dense_{n+2}``; the spectral
weights ``w_pos_re``, ``w_pos_im``, ``w_neg_re``, ``w_neg_im`` of shape (C,
modes1, modes2, O). flax infers input widths when it first sees data and
``nn.Linear`` cannot, so the lift takes ``in_channels`` (the dataset's
channels; the grid's two are added here).

The JAX package computes this in XLA with no Pallas kernel, by default
through truncated-DFT matmuls; the port computes the same function with
``torch.fft``, which was faster end to end on an H100 (``PERF.md``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu is the tanh form


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's lecun_normal in place: a normal truncated at ±2σ, σ =
    1/√fan_in corrected for the truncation."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def dense(in_features: int, out_features: int, bias: bool = True) -> nn.Linear:
    """``nn.Linear`` under flax Dense's init: lecun_normal kernel, zero
    bias."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(layer.weight, in_features)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


def uniform_param(shape: tuple, scale: float) -> nn.Parameter:
    """flax ``uniform(scale)``: U[0, scale), not symmetric."""
    return nn.Parameter(torch.rand(shape) * scale)


@lru_cache(maxsize=16)
def _grid(h: int, w: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    gx, gy = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    with torch.inference_mode(False):  # the cache serves training and evaluation
        return torch.from_numpy(np.stack([gx, gy], -1)).to(device=device, dtype=dtype)


def append_grid(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, C + 2): the [0, 1]² coordinates appended,
    built in float32 (``indexing="ij"``) and cast to x's dtype, as in JAX."""
    b, h, w, _ = x.shape
    return torch.cat([x, _grid(h, w, x.device, x.dtype).expand(b, h, w, 2)], dim=-1)


class SpectralConv2d(nn.Module):
    """Truncated-mode spectral convolution: rfft2 → the complex channel mix
    on the lowest modes1×modes2 modes (two corner blocks, positive and
    negative H-frequencies) → irfft2."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        shape = (in_channels, modes1, modes2, out_channels)
        scale = 1.0 / (in_channels * out_channels)
        for name in ("w_pos_re", "w_pos_im", "w_neg_re", "w_neg_im"):
            self.register_parameter(name, uniform_param(shape, scale))

    def _weights(self, m1: int, m2: int):
        """(re, im) of the positive and negative blocks a grid supporting
        m1 ≤ modes1, m2 ≤ modes2 uses. Row k of w_neg multiplies frequency
        k − modes1, so the surviving −m1..−1 are its tail."""
        pos = (self.w_pos_re[:, :m1, :m2], self.w_pos_im[:, :m1, :m2])
        tail = slice(self.modes1 - m1, None)
        neg = (self.w_neg_re[:, tail, :m2], self.w_neg_im[:, tail, :m2])
        return pos, neg

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        b, h, w, _ = x.shape
        m1 = min(self.modes1, h // 2)
        m2 = min(self.modes2, w // 2 + 1)
        pos, neg = self._weights(m1, m2)
        mix = lambda a, wt: torch.einsum("bxyi,ixyo->bxyo", a, wt)
        x_hat = torch.fft.rfft2(x, dim=(1, 2))
        top = mix(x_hat[:, :m1, :m2], torch.complex(*pos))
        bot = mix(x_hat[:, h - m1:, :m2], torch.complex(*neg))
        o = top.shape[-1]
        mid = top.new_zeros((b, h - 2 * m1, m2, o))
        out_hat = torch.cat([top, mid, bot], dim=1)
        out_hat = torch.cat([out_hat, out_hat.new_zeros((b, h, w // 2 + 1 - m2, o))], dim=2)
        return torch.fft.irfft2(out_hat, s=(h, w), dim=(1, 2))


class FNO2d(nn.Module):
    """in: (B, H, W, in_channels), out: (B, H, W, out_channels); the lead
    time is accepted and unused, as in JAX. The JAX defaults."""

    def __init__(self, in_channels: int, out_channels: int = 3, modes: int = 12,
                 width: int = 32, n_layers: int = 4, pad_frac: float = 0.25,
                 head_width: int = 128, append_grid: bool = True,
                 mask_channel: int | None = None):
        super().__init__()
        self.n_layers, self.pad_frac = n_layers, pad_frac
        self.append_grid, self.mask_channel = append_grid, mask_channel
        self.Dense_0 = dense(in_channels + 2 * append_grid, width)
        for k in range(n_layers):
            self.add_module(f"SpectralConv2d_{k}", SpectralConv2d(width, width, modes, modes))
            self.add_module(f"Dense_{k + 1}", dense(width, width))
        self.add_module(f"Dense_{n_layers + 1}", dense(width, head_width))
        self.add_module(f"Dense_{n_layers + 2}", dense(head_width, out_channels))

    def forward(self, x: torch.Tensor, lead_time: torch.Tensor | None = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        mc = self.mask_channel
        valid = x[..., mc:mc + 1] if mc is not None else None
        if self.append_grid:
            x = append_grid(x)
        x = self.Dense_0(x)
        # `FNO.py:113-115`: int(round(size * frac)), bottom and right only
        pad_h, pad_w = int(round(h * self.pad_frac)), int(round(w * self.pad_frac))
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        n = self.n_layers
        for k in range(n):
            x = getattr(self, f"SpectralConv2d_{k}")(x) + getattr(self, f"Dense_{k + 1}")(x)
            if k != n - 1:  # GELU between layers only
                x = gelu(x)
        x = x[:, :h, :w, :]
        x = getattr(self, f"Dense_{n + 2}")(gelu(getattr(self, f"Dense_{n + 1}")(x)))
        if valid is not None:
            x = x * valid
        return x
