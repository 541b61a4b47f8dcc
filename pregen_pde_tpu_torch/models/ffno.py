"""FFNO, the Factorized Fourier Neural Operator (port of ``models/ffno.py``),
NHWC.

Per layer: separate 1-D spectral convolutions along W and H, summed, with
weights shared across the layers by default; a backcast FeedForward
(width → factor·width → width, GELU and dropout between) with a residual;
the [0, 1]² coordinates appended inside the model; a fixed zero pad of 8 at
the bottom and right; and a two-layer head with no activation between,
applied to the final backcast, not to the residual stream. Every linear is
weight-normalised (``WNDense``). The contract's hole mask (channel 4, 1 =
hole) gives validity = 1 − clip(mask, 0, 1), which zeroes the physical
channels before the lift and multiplies the output.

The parameters keep flax's names and layouts (``in_proj``, ``w_x_*`` and
``w_y_*`` at the model when shared, ``spectral_i``, ``ff_i_0``, ``ff_i_1``,
``head_0``, ``head_1``; ``WNDense``'s ``v`` (in, out), ``g`` and ``bias``),
so a flax tree maps onto the state_dict by joining its paths.

The backcast dropout is on only in ``train()`` mode and draws from the
explicit ``torch.Generator`` that ``set_dropout_generator`` sets (the
trainer's); its stream differs from JAX's threefry, its law does not.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pregen_pde_tpu_torch.models.fno import append_grid, gelu, uniform_param


class WNDense(nn.Module):
    """Weight-normalised Dense: w = v / √(Σ_in v² + ε²) · g, v of shape (in,
    out), ε inside the square root (finite gradients at v = 0). Init as in
    JAX: v ~ U(±1/√in), g = 1/√3, bias 0."""

    def __init__(self, in_features: int, features: int, eps: float = 1e-6,
                 use_bias: bool = True):
        super().__init__()
        self.eps = eps
        bound = 1.0 / math.sqrt(in_features)
        self.v = nn.Parameter(torch.empty(in_features, features).uniform_(-bound, bound))
        self.g = nn.Parameter(torch.full((features,), 1.0 / math.sqrt(3.0)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.v
        w = v / torch.sqrt((v * v).sum(0, keepdim=True) + self.eps**2) * self.g[None, :]
        y = x @ w
        return y + self.bias if self.bias is not None else y


class FactorizedSpectralLayer(nn.Module):
    """Separate 1-D spectral convolutions along H and W, summed. ``weights``
    in ``forward`` supplies the model's shared complex pairs ((w_x_re,
    w_x_im), (w_y_re, w_y_im)); the layer owns its own when it is built with
    ``own_weights``. w_x (c, modes, out) multiplies the axis-2 (W) transform,
    w_y the axis-1 (H) one."""

    def __init__(self, in_channels: int, channels: int, modes: int, own_weights: bool = False):
        super().__init__()
        self.modes = modes
        if own_weights:
            shape, scale = (in_channels, modes, channels), 1.0 / in_channels
            for name in ("w_x_re", "w_x_im", "w_y_re", "w_y_im"):
                self.register_parameter(name, uniform_param(shape, scale))

    def _axis(self, x: torch.Tensor, wre, wim, axis: int) -> torch.Tensor:
        """The spectral convolution along ``axis`` (1 = H, 2 = W) with the
        first m modes of (wre, wim)."""
        n = x.shape[axis]
        m = min(self.modes, n // 2 + 1)
        wre, wim = wre[:, :m], wim[:, :m]
        sub = "bhmi,imo->bhmo" if axis == 2 else "bmwi,imo->bmwo"
        mix = lambda a, wt: torch.einsum(sub, a, wt)
        x_hat = torch.fft.rfft(x, dim=axis).narrow(axis, 0, m)
        out = mix(x_hat, torch.complex(wre, wim))
        shape = list(out.shape)
        shape[axis] = n // 2 + 1 - m
        return torch.fft.irfft(torch.cat([out, out.new_zeros(shape)], dim=axis), n=n, dim=axis)

    def forward(self, x: torch.Tensor, weights=None) -> torch.Tensor:  # (B, H, W, C)
        if weights is None:
            weights = ((self.w_x_re, self.w_x_im), (self.w_y_re, self.w_y_im))
        (wxr, wxi), (wyr, wyi) = weights
        return self._axis(x, wxr, wxi, 2) + self._axis(x, wyr, wyi, 1)


class FFNO2d(nn.Module):
    """in: (B, H, W, in_channels), out: (B, H, W, out_channels); the lead
    time is accepted and unused, as in JAX. The JAX defaults."""

    def __init__(self, in_channels: int, out_channels: int = 3, modes: int = 12,
                 width: int = 48, n_layers: int = 4, factor: int = 4, padding: int = 8,
                 share_weight: bool = True, append_grid: bool = True,
                 dropout_rate: float = 0.1, head_width: int = 128,
                 hole_mask_channel: int | None = 4):
        super().__init__()
        self.n_layers, self.padding, self.share_weight = n_layers, padding, share_weight
        self.append_grid, self.dropout_rate = append_grid, dropout_rate
        self.hole_mask_channel = hole_mask_channel
        self.generator: torch.Generator | None = None
        self.in_proj = WNDense(in_channels + 2 * append_grid, width)
        if share_weight:
            for name in ("w_x_re", "w_x_im", "w_y_re", "w_y_im"):
                self.register_parameter(name, uniform_param((width, modes, width), 1.0 / width))
        for i in range(n_layers):
            self.add_module(f"spectral_{i}", FactorizedSpectralLayer(
                width, width, modes, own_weights=not share_weight))
            self.add_module(f"ff_{i}_0", WNDense(width, factor * width))
            self.add_module(f"ff_{i}_1", WNDense(factor * width, width))
        self.head_0 = WNDense(width, head_width)
        self.head_1 = WNDense(head_width, out_channels)

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator the backcast dropout draws from in training."""
        self.generator = generator

    def _dropout(self, z: torch.Tensor) -> torch.Tensor:
        """flax ``Dropout``: keep each element with probability 1 − rate and
        scale it by 1/(1 − rate); identity at eval or at rate 0."""
        rate = self.dropout_rate
        if rate == 0.0 or not self.training:
            return z
        if self.generator is None:
            raise RuntimeError("dropout in training draws from an explicit torch.Generator; "
                               "set one with FFNO2d.set_dropout_generator (the Trainer does)")
        keep = 1.0 - rate
        kept = torch.rand(z.shape, generator=self.generator, device=z.device,
                          dtype=z.dtype) < keep
        return torch.where(kept, z / keep, torch.zeros_like(z))

    def forward(self, x: torch.Tensor, lead_time: torch.Tensor | None = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        hm = self.hole_mask_channel
        valid = None
        if hm is not None and x.shape[-1] > hm:
            valid = 1.0 - torch.clamp(x[..., hm:hm + 1], 0.0, 1.0)
            # zero the physical fields (the channels before the mask) inside
            # obstacles before lifting; mask, SDF and time stay as features
            x = torch.cat([x[..., :hm] * valid, x[..., hm:]], dim=-1)
        if self.append_grid:
            x = append_grid(x)
        x = self.in_proj(x)
        p = self.padding
        x = F.pad(x, (0, 0, 0, p, 0, p))
        shared = (((self.w_x_re, self.w_x_im), (self.w_y_re, self.w_y_im))
                  if self.share_weight else None)
        b = x
        for i in range(self.n_layers):
            z = getattr(self, f"spectral_{i}")(x, shared)
            z = self._dropout(gelu(getattr(self, f"ff_{i}_0")(z)))
            b = getattr(self, f"ff_{i}_1")(z)
            x = x + b  # backcast residual
        # the head reads the final backcast, unpadded; no activation between
        y = self.head_1(self.head_0(b[:, :h, :w, :]))
        if valid is not None:
            y = y * valid
        return y
