"""Fine-tuning a pretrained model: dimension adapters and tiered learning
rates (port of the JAX package's ``training/finetune.py``).

When the pretrained model's channel counts differ from the target task's,
1×1-convolution adapters wrap it: ``in_adapter_1/2`` before it,
``out_adapter_1/2`` after it, the tanh GELU between each pair. Training
uses three learning-rate tiers (base / norm-conditioning / adapters); a
frozen backbone is a zero-rate tier, no parameter surgery.

The adapters keep flax's names and Conv's init (lecun-normal kernel, zero
bias), and the wrapped model is the submodule ``base``, so the parameter
names are the flax paths joined with ``.`` and ``finetune_tier_of`` labels
each as JAX's ``finetune_tier_fn`` labels its flax path.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pregen_pde_tpu_torch.models.fno import gelu, lecun_normal_
from pregen_pde_tpu_torch.training.tiers import flax_path


class Conv1x1(nn.Conv2d):
    """flax ``Conv(features, (1, 1))`` on an NHWC tensor: a product over the
    channels, with the OIHW weight of the converter's layout."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)
        lecun_normal_(self.weight, in_channels)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


class AdapterWrapper(nn.Module):
    """[1×1-conv in-adapter] → base model → [1×1-conv out-adapter], NHWC.

    The in-adapter maps ``in_channels`` to ``base_in_channels`` and exists
    only when they differ; the out-adapter maps ``base_out_channels`` to
    ``out_channels`` (None: keep the base's) likewise. flax decides this
    from the shapes it sees; a torch module is told them."""

    def __init__(self, base: nn.Module, base_in_channels: int, in_channels: int,
                 base_out_channels: int, out_channels: int | None = None, hidden: int = 64):
        super().__init__()
        self.base = base
        self.has_in = in_channels != base_in_channels
        self.has_out = out_channels is not None and out_channels != base_out_channels
        if self.has_in:
            self.in_adapter_1 = Conv1x1(in_channels, hidden)
            self.in_adapter_2 = Conv1x1(hidden, base_in_channels)
        if self.has_out:
            self.out_adapter_1 = Conv1x1(base_out_channels, hidden)
            self.out_adapter_2 = Conv1x1(hidden, out_channels)

    def forward(self, x: torch.Tensor, time: torch.Tensor | None = None) -> torch.Tensor:
        if self.has_in:
            x = self.in_adapter_2(gelu(self.in_adapter_1(x)))
        x = self.base(x, time)
        if self.has_out:
            x = self.out_adapter_2(gelu(self.out_adapter_1(x)))
        return x


def finetune_tier_fn(path: tuple[str, ...]) -> str:
    """A flax parameter path → one of the three fine-tuning tiers:
    'adapter' (the new lift/project), 'norm' (FILM and the conditional
    norms), 'base'."""
    joined = "/".join(path)
    if "in_adapter" in joined or "out_adapter" in joined:
        return "adapter"
    if "FILM" in joined or "time_scale" in joined or "time_bias" in joined or \
            "norm" in joined.lower():
        return "norm"
    return "base"


def finetune_tier_of(name: str) -> str:
    """A port parameter name → its tier (``finetune_tier_fn`` of its flax
    path)."""
    return finetune_tier_fn(flax_path(name))


DEFAULT_FT_TIERS = {
    # the reference's fine-tuning rates: lr (base) / lr_norms / lr_embeddings
    "base": 1e-5,
    "norm": 1e-4,
    "adapter": 1e-3,
}
