"""upfirdn2d: pad, zero-stuff upsample, FIR filter, downsample (port of the
JAX package's ``ops/upfirdn2d.py``), NCHW.

The contract, per channel:

1. upsample by inserting up−1 zeros after each pixel,
2. pad (negative = crop) w.r.t. the upsampled image,
3. convolve with the FIR filter (flip_filter=False means true convolution),
4. keep every down-th pixel.

A filter is ``[taps]`` (separable, applied along W then H, each pass
carrying √gain), ``[fh, fw]`` (full, carrying gain) or None (identity).
Three routes, as in JAX:

- ``"matmul"`` (what ``"auto"`` takes for a separable filter): each 1-D pass
  is a dense ``(n_in, n_out)`` operator built on the host in numpy from the
  contract applied to the identity basis, rounded to float32, cached, and
  applied by ``torch.matmul``;
- ``"conv"`` (a 2-D filter, or ``"auto"``'s other case): zero-stuffing,
  padding, a depthwise ``F.conv2d`` with ``groups=C`` and the decimation as
  its stride;
- ``"blocked"``: the banded operator cut into output blocks of 128, each
  contracted with the input rows it touches (gathered windows, batched
  products), dense where blocking saves less than 2×.

The JAX package computes these in XLA, outside any Pallas kernel; autograd
gives the gradient here as XLA's transpose rules do there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(scaling) -> tuple[int, int]:
    if isinstance(scaling, int):
        return scaling, scaling
    sx, sy = scaling
    return int(sx), int(sy)


def parse_padding(padding) -> tuple[int, int, int, int]:
    """→ (px0, px1, py0, py1); accepts int, [x, y], or [x0, x1, y0, y1]."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


# ---------------------------------------------------------------------------
# dense per-axis operators (the "matmul" route), built on the host
# ---------------------------------------------------------------------------
_MATRIX_CACHE: dict = {}


def _upfirdn1d_matrix(
    n_in: int, f: np.ndarray, up: int, down: int, p0: int, p1: int,
    flip_filter: bool, gain: float,
) -> np.ndarray:
    """(n_in, n_out) operator: columns are upfirdn applied to basis vectors."""
    f = np.asarray(f, np.float64) * (gain ** 0.5)  # separable: √gain per pass
    if not flip_filter:
        f = f[::-1]
    taps = f.shape[0]
    # basis rows processed together: zero-stuff the identity
    eye = np.eye(n_in)
    up_arr = np.zeros((n_in, n_in * up))
    up_arr[:, ::up] = eye
    # pad / crop
    up_arr = np.pad(up_arr, ((0, 0), (max(p0, 0), max(p1, 0))))
    up_arr = up_arr[:, max(-p0, 0): up_arr.shape[1] - max(-p1, 0)]
    # correlate with (possibly pre-flipped) f, 'valid'
    L = up_arr.shape[1]
    n_valid = L - taps + 1
    out = np.zeros((n_in, n_valid))
    for k in range(taps):
        out += f[k] * up_arr[:, k: k + n_valid]
    # decimate
    return np.ascontiguousarray(out[:, ::down]).astype(np.float32)


def _get_matrix(n_in, f, up, down, p0, p1, flip_filter, gain):
    key = (n_in, f.tobytes(), up, down, p0, p1, flip_filter, round(gain, 12))
    m = _MATRIX_CACHE.get(key)
    if m is None:
        m = _upfirdn1d_matrix(n_in, f, up, down, p0, p1, flip_filter, gain)
        _MATRIX_CACHE[key] = m
    return m


_BLOCK_CACHE: dict = {}


def _blocked_operator(n_in, f, up, down, p0, p1, flip_filter, gain,
                      block_out: int = 128):
    """→ (index (nJ, Bi) int32 gather rows, T (nJ, Bi, Bo) float32, n_out),
    or None when no useful blocking exists (tiny outputs or no divisor)."""
    key = ("blk", n_in, f.tobytes(), up, down, p0, p1, flip_filter,
           round(gain, 12), block_out)
    hit = _BLOCK_CACHE.get(key, "miss")
    if hit != "miss":
        return hit
    M = _upfirdn1d_matrix(n_in, f, up, down, p0, p1, flip_filter, gain)
    n_out = M.shape[1]
    bo = block_out
    n_blocks = -(-n_out // bo)  # ragged: last block zero-padded, then sliced
    result = None
    if n_blocks >= 2:
        Mp = np.pad(M, ((0, 0), (0, n_blocks * bo - n_out)))
        starts, widths = [], []
        for j in range(n_blocks):
            nz = np.nonzero(np.any(Mp[:, j * bo:(j + 1) * bo] != 0, axis=1))[0]
            if len(nz) == 0:
                starts.append(0)
                widths.append(1)
            else:
                starts.append(int(nz[0]))
                widths.append(int(nz[-1] - nz[0] + 1))
        bi = min(-(-max(widths) // 8) * 8, n_in)  # the window rounded up to 8 rows
        if bi * 2 <= n_in:  # only worth it when ≥2x FLOP savings
            starts = np.asarray([min(s, n_in - bi) for s in starts], np.int64)
            t = np.stack(
                [Mp[s:s + bi, j * bo:(j + 1) * bo]
                 for j, s in enumerate(starts)]
            ).astype(np.float32)
            index = (starts[:, None] + np.arange(bi)[None, :]).astype(np.int32)
            result = (index, t, n_out)
    _BLOCK_CACHE[key] = result
    return result


# the host operators as tensors, one per (operator, device, dtype)
_TENSOR_CACHE: dict = {}


def _tensor(key, a: np.ndarray, like: torch.Tensor, dtype: torch.dtype | None = None):
    """``a`` (a cached host operator or index, named by ``key``) on
    ``like``'s device, in ``dtype`` (default ``like``'s), made once."""
    dtype = dtype or like.dtype
    k = (key, str(like.device), dtype)
    t = _TENSOR_CACHE.get(k)
    if t is None:
        with torch.inference_mode(False):  # the cache serves training and evaluation
            t = torch.from_numpy(a).to(device=like.device, dtype=dtype)
        _TENSOR_CACHE[k] = t
    return t


def _matrix(x, n_in, f_np, up, down, p0, p1, flip_filter, gain):
    m = _get_matrix(n_in, f_np, up, down, p0, p1, flip_filter, gain)
    return _tensor(("mat", n_in, f_np.tobytes(), up, down, p0, p1, flip_filter,
                    round(gain, 12)), m, x)


def _upfirdn2d_matmul(x, f_np, upx, upy, downx, downy, px0, px1, py0, py1,
                      flip_filter, gain):
    mw = _matrix(x, x.shape[3], f_np, upx, downx, px0, px1, flip_filter, gain)
    mh = _matrix(x, x.shape[2], f_np, upy, downy, py0, py1, flip_filter, gain)
    x = torch.matmul(x, mw)  # W pass: (B, C, H, W) @ (W, W') → (B, C, H, W')
    return torch.matmul(mh.mT, x)  # H pass: (H', H) @ (B, C, H, W') → (B, C, H', W')


def _apply_blocked_w(x, index, t, n_out):
    """x (B,C,H,W) → (B,C,H,n_out) via the blocked operator along W."""
    b, c, h, _ = x.shape
    nj, bi, bo = t.shape
    xw = x[..., index]  # (B, C, H, nJ, Bi)
    y = torch.einsum("bchji,jio->bchjo", xw, t)
    return y.reshape(b, c, h, nj * bo)[..., :n_out]


def _apply_blocked_h(x, index, t, n_out):
    """x (B,C,H,W) → (B,C,n_out,W) via the blocked operator along H."""
    b, c, _, w = x.shape
    nj, bi, bo = t.shape
    xh = x[:, :, index, :]  # (B, C, nJ, Bi, W)
    y = torch.einsum("bcjiw,jio->bcjow", xh, t)
    return y.reshape(b, c, nj * bo, w)[:, :, :n_out, :]


def _blocked_pass(x, axis, f_np, up, down, p0, p1, flip_filter, gain):
    """One axis (3 = W, 2 = H) through its blocked operator, or its dense
    one where blocking does not pay."""
    n_in = x.shape[axis]
    blk = _blocked_operator(n_in, f_np, up, down, p0, p1, flip_filter, gain)
    if blk is None:
        m = _matrix(x, n_in, f_np, up, down, p0, p1, flip_filter, gain)
        return torch.matmul(x, m) if axis == 3 else torch.matmul(m.mT, x)
    index, t, n_out = blk
    key = ("blk", n_in, f_np.tobytes(), up, down, p0, p1, flip_filter, round(gain, 12))
    index_t = _tensor(key + ("index",), index, x, torch.long)
    t_t = _tensor(key + ("t",), t, x)
    apply = _apply_blocked_w if axis == 3 else _apply_blocked_h
    return apply(x, index_t, t_t, n_out)


def _upfirdn2d_blocked(x, f_np, upx, upy, downx, downy, px0, px1, py0, py1,
                       flip_filter, gain):
    """Blocked pass per axis where profitable, dense product otherwise."""
    x = _blocked_pass(x, 3, f_np, upx, downx, px0, px1, flip_filter, gain)
    return _blocked_pass(x, 2, f_np, upy, downy, py0, py1, flip_filter, gain)


# ---------------------------------------------------------------------------
# the depthwise-convolution route
# ---------------------------------------------------------------------------
def _depthwise_conv(x, f, up, down, pad):
    """x (B,C,H,W); f (fh, fw) in x's dtype, pre-flipped for correlation;
    up, down (y, x); pad (py0, py1, px0, px1) w.r.t. the zero-stuffed image."""
    b, c, h, w = x.shape
    upy, upx = up
    if upy > 1 or upx > 1:  # zeros after each pixel: length h·upy, w·upx
        z = x.new_zeros((b, c, h * upy, w * upx))
        z[:, :, ::upy, ::upx] = x
        x = z
    x = F.pad(x, (pad[2], pad[3], pad[0], pad[1]))  # negative padding crops
    weight = f[None, None].expand(c, 1, *f.shape)
    return F.conv2d(x, weight, stride=down, groups=c)


def upfirdn2d(
    x: torch.Tensor,
    f,
    up=1,
    down=1,
    padding=0,
    flip_filter: bool = False,
    gain: float = 1.0,
    impl: str = "auto",
) -> torch.Tensor:
    """``x``: float NCHW ``[batch, channels, in_height, in_width]``; ``f``: a
    float32 ``[fh, fw]`` (full), ``[taps]`` (separable), or None
    (identity), on the host. ``up``, ``down``: int or (x, y);
    ``padding``: int, [x, y] or [x0, x1, y0, y1]. Returns
    ``[batch, channels, out_height, out_width]``.
    """
    assert x.ndim == 4
    assert impl in ("auto", "conv", "matmul", "blocked")
    f_np = np.ones((1, 1), np.float32) if f is None else np.asarray(f, np.float32)
    assert f_np.ndim in (1, 2)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)

    if impl in ("auto", "matmul", "blocked") and f_np.ndim == 1:
        taps = f_np.shape[0]
        _check_min_size(x, upx, upy, px0, px1, py0, py1, taps, taps)
        route = _upfirdn2d_blocked if impl == "blocked" else _upfirdn2d_matmul
        return route(x, f_np, upx, upy, downx, downy, px0, px1, py0, py1, flip_filter, gain)
    if impl in ("matmul", "blocked"):
        raise ValueError(f"{impl} impl requires a concrete separable filter")

    # contract: f scaled by gain^(ndim/2) — a separable (1-D) filter is applied
    # twice, so each pass carries gain^(1/2); a full 2-D filter carries gain^1.
    # In float32, as JAX scales its float32 taps.
    f_np = f_np * np.float32(gain ** (f_np.ndim / 2.0))
    if not flip_filter:  # contract: False = convolution → pre-flip for correlation
        f_np = np.flip(f_np)
    ft = torch.from_numpy(f_np.copy()).to(device=x.device, dtype=x.dtype)

    if ft.ndim == 2:
        fh, fw = ft.shape
        _check_min_size(x, upx, upy, px0, px1, py0, py1, fw, fh)
        return _depthwise_conv(x, ft, (upy, upx), (downy, downx), (py0, py1, px0, px1))
    # separable: x-pass then y-pass
    taps = ft.shape[0]
    _check_min_size(x, upx, upy, px0, px1, py0, py1, taps, taps)
    x = _depthwise_conv(x, ft[None, :], (1, upx), (1, downx), (0, 0, px0, px1))
    return _depthwise_conv(x, ft[:, None], (upy, 1), (downy, 1), (py0, py1, 0, 0))


def _check_min_size(x, upx, upy, px0, px1, py0, py1, fw, fh):
    up_w = x.shape[3] * upx + px0 + px1
    up_h = x.shape[2] * upy + py0 + py1
    if up_w < fw or up_h < fh:
        raise ValueError(
            f"upsampled size ({up_h}, {up_w}) smaller than filter ({fh}, {fw})"
        )


def upfirdn2d_output_shape(in_h, in_w, f_shape, up=1, down=1, padding=0):
    """Output spatial dims per the contract."""
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    if f_shape is None:
        fh = fw = 1
    elif len(f_shape) == 1:
        fh = fw = f_shape[0]
    else:
        fh, fw = f_shape
    out_h = (in_h * upy + py0 + py1 - fh) // downy + 1
    out_w = (in_w * upx + px0 + px1 - fw) // downx + 1
    return out_h, out_w
