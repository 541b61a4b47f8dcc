"""conv2d_resample: a 2-D convolution with optional FIR up/downsampling
(port of the JAX package's ``ops/conv2d_resample.py``), NCHW activations,
OIHW weights.

One generic composition, as in JAX: pad once w.r.t. the upsampled image,
upfirdn-upsample, convolve, upfirdn-downsample.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pregen_pde_tpu_torch.ops.upfirdn2d import parse_padding, upfirdn2d


def _filter_size(f) -> tuple[int, int]:
    if f is None:
        return 1, 1
    if f.ndim == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[1]), int(f.shape[0])  # (fw, fh)


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f=None,
    up: int = 1,
    down: int = 1,
    padding=0,
    groups: int = 1,
    flip_weight: bool = True,
    flip_filter: bool = False,
) -> torch.Tensor:
    """``x``: float NCHW; ``w``: OIHW ``[out_ch, in_ch//groups, kh, kw]``;
    ``f``: separable ``[taps]`` or full ``[fh, fw]`` float32 FIR filter (None =
    identity). ``padding`` is w.r.t. the upsampled image, applied once up
    front. ``flip_weight=True`` means correlation (``F.conv2d``'s own
    convention), False true convolution; ``flip_filter`` likewise for ``f``.
    """
    assert x.ndim == 4 and w.ndim == 4
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    assert isinstance(groups, int) and groups >= 1
    fw, fh = _filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)

    # padding adjustments that keep the FIR stages' output-size arithmetic
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    x = upfirdn2d(
        x,
        f if up > 1 else None,
        up=up,
        padding=[px0, px1, py0, py1],
        gain=up**2,
        flip_filter=flip_filter,
    )
    ww = w if flip_weight else torch.flip(w, dims=(2, 3))
    x = F.conv2d(x, ww.to(x.dtype), groups=groups)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
