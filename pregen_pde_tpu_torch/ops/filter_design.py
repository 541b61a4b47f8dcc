"""FIR low-pass filter design on the host (numpy and scipy, at module
construction), the port's copy of the JAX package's ``ops/filter_design.py``.

Kaiser-windowed ``scipy.signal.firwin`` for separable filters, a jinc-based
radial variant, and ``setup_filter``'s normalisation conventions. The taps
are float32 numpy arrays, as the JAX module returns them, so both packages
build the same operators from the same rounded taps.
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import scipy.special


def design_lowpass_filter(
    numtaps: int, cutoff: float, width: float, fs: float, radial: bool = False
) -> np.ndarray | None:
    """Kaiser low-pass FIR filter; None = identity (numtaps==1).

    Args match scipy.signal.firwin: cutoff/width in the same units as fs.
    """
    assert numtaps >= 1
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return f.astype(np.float32)
    # radially symmetric jinc-based filter
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f = np.nan_to_num(f, nan=float(cutoff))  # r=0 limit: j1(z)/z → 1/2 · 2c = c
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2))
    )
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return f.astype(np.float32)


def setup_filter(
    f,
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1.0,
    separable: bool | None = None,
) -> np.ndarray:
    """Normalize/flip/scale an FIR filter for `upfirdn2d` (1-D = separable,
    2-D = full)."""
    if f is None:
        f = 1.0
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f).copy()
    f = f * (gain ** (f.ndim / 2))
    return f.astype(np.float32)
