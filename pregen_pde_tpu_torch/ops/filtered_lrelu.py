"""filtered_lrelu: the anti-aliased leaky ReLU (port of the JAX package's
``ops/filtered_lrelu.py``), NCHW. Per channel:

  1. add bias,  2. zero-stuff upsample ×up,  3. pad (neg = crop),
  4. FIR filter `fu`,  5. ×gain,  6. leaky-ReLU(slope),  7. clamp,
  8. FIR filter `fd`,  9. decimate ×down.

The JAX package composes this from ``bias_act`` and two ``upfirdn2d``
calls in XLA, outside any Pallas kernel, and XLA's transpose rules give the
gradient; the port composes the same calls in plain PyTorch and autograd
gives the gradient. ``impl`` picks the ``upfirdn2d`` route of both filter
passes (``"auto"``, as JAX, takes the dense operators for separable
filters).
"""

from __future__ import annotations

import numpy as np
import torch

from pregen_pde_tpu_torch.ops.bias_act import bias_act
from pregen_pde_tpu_torch.ops.upfirdn2d import parse_padding, upfirdn2d


def _filter_size(f) -> tuple[int, int]:
    if f is None:
        return 1, 1
    if f.ndim == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[1]), int(f.shape[0])  # (fw, fh)


def filtered_lrelu(
    x: torch.Tensor,
    fu=None,
    fd=None,
    b: torch.Tensor | None = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = float(np.sqrt(2)),
    slope: float = 0.2,
    clamp: float | None = None,
    flip_filter: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """x: float NCHW [batch, C, H, W]; fu/fd: float32 [taps] (separable),
    [fh, fw] (full), or None; b: [C] bias. Returns NCHW."""
    assert x.ndim == 4
    fu_w, fu_h = _filter_size(fu)
    fd_w, fd_h = _filter_size(fd)
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    px0, px1, py0, py1 = parse_padding(padding)
    assert slope >= 0.0 and gain > 0.0

    batch, ch, in_h, in_w = x.shape
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down

    x = bias_act(x, b, dim=1)  # bias only (linear act)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up**2,
                  flip_filter=flip_filter, impl=impl)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    x = upfirdn2d(x, fd, down=down, flip_filter=flip_filter, impl=impl)

    assert x.shape == (batch, ch, out_h, out_w), (x.shape, (batch, ch, out_h, out_w))
    return x
