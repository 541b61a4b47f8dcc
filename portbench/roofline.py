"""The yardstick's peaks and the work the generators' kernels need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full
700 W power limit): 165 TFLOP/s is TF32's 495 TFLOP/s over three, the
fastest rate at which the card gives float32-accurate products (3xTF32);
3.35 TB/s is the HBM bandwidth. Every share of a peak in this benchmark
uses these two numbers, whatever implements the work, so no share can pass
100% when a kernel moves to the tensor cores or to another algorithm.

The work is counted by the algorithm, once:

- K1, the CN+AB2 spectral step: three complex 2-D FFTs of n² points an
  image-step, 5·n²·log2(n²) FLOP each; the pointwise algebra is not
  counted (the model of ``chip_smoke.py`` at commit 92d189c, lines
  866-870). Bytes: w0 and ν read once, the (B, T, n, n, 3) fields written
  once.
- K2, the Chorin projection step: the four n×n products of the DCT eigen
  pressure solve, 8·n³ FLOP an image-step (``PERF.md``'s K2 row at commit
  92d189c). Bytes: the masks, u_max, dt and step counts read once, the
  (B, T, n, n, 3) frames written once.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 165e12  # float32-accurate products: 495 TFLOP/s TF32 / 3
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def k1_flop_per_image_step(n: int) -> float:
    return 3 * 5 * n * n * math.log2(n * n)


def k2_flop_per_image_step(n: int) -> float:
    return 8.0 * n**3


def k1_bytes(batch: int, n: int, frames: int) -> float:
    """w0 (B, n, n) and ν (B,) float32 in, (B, frames, n, n, 3) float32 out."""
    return 4.0 * (batch * n * n + batch + batch * frames * n * n * 3)


def k2_bytes(batch: int, n: int, frames: int) -> float:
    """masks (B, n, n), u_max, dt, steps (B,) in, (B, frames, n, n, 3) out."""
    return 4.0 * (batch * n * n + 3 * batch + batch * frames * n * n * 3)


def bound_seconds(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flop / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
