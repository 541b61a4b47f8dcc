"""Periodic spectral grids: host-side (numpy) wavenumber tables and 2/3
dealiasing masks (the port's copy of the JAX package's ``core/grid.py``;
the same tables bit for bit). float32 by default; every table is numpy and
the callers cast it to the dtype they compute in.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

_TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class SpectralGrid1D:
    """Periodic 1-D grid on [0, length)."""

    n: int
    length: float = 1.0

    @cached_property
    def x(self) -> np.ndarray:
        return np.arange(self.n) * (self.length / self.n)

    @cached_property
    def k(self) -> np.ndarray:
        """Wavenumbers for rfft layout, shape (n//2+1,)."""
        return np.fft.rfftfreq(self.n, d=self.length / self.n) * _TWO_PI

    @cached_property
    def k_deriv(self) -> np.ndarray:
        """Wavenumbers for odd derivatives: Nyquist mode zeroed.

        The first derivative of a real signal has an ambiguous (±) Nyquist
        coefficient; the symmetric convention is zero. This also makes rfft
        and full-fft implementations agree bit-for-bit."""
        k = self.k.copy()
        if self.n % 2 == 0:
            k[-1] = 0.0
        return k

    @cached_property
    def dealias_mask(self) -> np.ndarray:
        """2/3-rule mask in rfft layout."""
        kmax = (self.n // 2) * (_TWO_PI / self.length)
        return (np.abs(self.k) <= (2.0 / 3.0) * kmax).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SpectralGrid2D:
    """Periodic 2-D grid on [0, length)^2, rfft2 layout (full y axis, half x axis).

    Arrays are shaped (n, n//2 + 1) matching the ``rfft2`` output of an
    (n, n) real input: axis 0 is the full-FFT axis, axis 1 the real-FFT axis.
    """

    n: int
    length: float = 1.0

    @cached_property
    def x(self) -> np.ndarray:
        """Meshgrid coordinates, each (n, n)."""
        c = np.arange(self.n) * (self.length / self.n)
        return np.stack(np.meshgrid(c, c, indexing="ij"), axis=0)

    @cached_property
    def ky(self) -> np.ndarray:
        """Wavenumber along axis 0 (full FFT), shape (n, 1)."""
        return (np.fft.fftfreq(self.n, d=self.length / self.n) * _TWO_PI).reshape(
            self.n, 1
        )

    @cached_property
    def kx(self) -> np.ndarray:
        """Wavenumber along axis 1 (real FFT), shape (1, n//2+1)."""
        return (np.fft.rfftfreq(self.n, d=self.length / self.n) * _TWO_PI).reshape(
            1, self.n // 2 + 1
        )

    @cached_property
    def kx_deriv(self) -> np.ndarray:
        """kx with the Nyquist column zeroed — for odd (first) derivatives.

        Odd derivatives of real fields have sign-ambiguous Nyquist modes; the
        symmetric convention (zero) makes rfft2 and full-fft2 implementations
        agree exactly and is standard pseudo-spectral practice."""
        k = self.kx.copy()
        if self.n % 2 == 0:
            k[0, -1] = 0.0
        return k

    @cached_property
    def ky_deriv(self) -> np.ndarray:
        """ky with the Nyquist row zeroed — for odd (first) derivatives."""
        k = self.ky.copy()
        if self.n % 2 == 0:
            k[self.n // 2, 0] = 0.0
        return k

    @cached_property
    def k2(self) -> np.ndarray:
        """|k|^2, shape (n, n//2+1)."""
        return self.kx**2 + self.ky**2

    @cached_property
    def inv_k2(self) -> np.ndarray:
        """1/|k|^2 with the k=0 mode zeroed (used for streamfunction solves)."""
        k2 = self.k2.copy()
        k2[0, 0] = 1.0
        inv = 1.0 / k2
        inv[0, 0] = 0.0
        return inv

    @cached_property
    def dealias_mask(self) -> np.ndarray:
        """2/3-rule mask in rfft2 layout, float32 {0,1}."""
        kmax = (self.n // 2) * (_TWO_PI / self.length)
        cutoff = (2.0 / 3.0) * kmax
        return ((np.abs(self.ky) <= cutoff) & (np.abs(self.kx) <= cutoff)).astype(
            np.float32
        )

    @property
    def rfft_shape(self) -> tuple[int, int]:
        return (self.n, self.n // 2 + 1)

    # -- full-fft layout (for the packed-FFT solver path) ---------------------

    @cached_property
    def k_full(self) -> np.ndarray:
        """1-D wavenumbers in full-fft order, shape (n,)."""
        return np.fft.fftfreq(self.n, d=self.length / self.n) * _TWO_PI

    @cached_property
    def kx_full_deriv(self) -> np.ndarray:
        """(1, n) kx in full layout, Nyquist zeroed (odd-derivative convention)."""
        k = self.k_full.copy()
        if self.n % 2 == 0:
            k[self.n // 2] = 0.0
        return k.reshape(1, self.n)

    @cached_property
    def ky_full_deriv(self) -> np.ndarray:
        """(n, 1) ky in full layout, Nyquist zeroed."""
        return self.kx_full_deriv.reshape(self.n, 1).copy()

    @cached_property
    def k2_full(self) -> np.ndarray:
        k = self.k_full
        return (k.reshape(1, -1) ** 2 + k.reshape(-1, 1) ** 2)

    @cached_property
    def inv_k2_full(self) -> np.ndarray:
        k2 = self.k2_full.copy()
        k2[0, 0] = 1.0
        inv = 1.0 / k2
        inv[0, 0] = 0.0
        return inv

    @cached_property
    def dealias_mask_full(self) -> np.ndarray:
        kmax = (self.n // 2) * (_TWO_PI / self.length)
        cutoff = (2.0 / 3.0) * kmax
        k = self.k_full
        return (
            (np.abs(k.reshape(-1, 1)) <= cutoff)
            & (np.abs(k.reshape(1, -1)) <= cutoff)
        ).astype(np.float32)
