"""Relative-position-bias expansion (counterpart of ``ops/cpb_bias.py``).

Swin-V2's continuous position bias indexes a ((2w-1)^2, h) CPB table with
a static (n^2,)-index map (n = w^2 tokens per window) to build the per-head
(h, n, n) attention bias. The forward is the gather; its gradient is the
JAX package's closed-form Toeplitz adjoint instead of the gather's
scatter-add: the index map is rel(p, q) = (row_p - row_q, col_p - col_q),
so the adjoint factorises over rows and columns into two dense einsums
against a static (w, w, 2w-1) 0/1 "diagonal extractor".
"""

from __future__ import annotations

import numpy as np
import torch


def rel_index(ws: int) -> np.ndarray:
    """Static (n^2,) map token pair -> flat (2w-1)^2 relative offset
    (row-major), the reference's relative_position_index."""
    ci = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"), 0).reshape(2, -1)
    rel = ci[:, :, None] - ci[:, None, :] + (ws - 1)  # (2, n, n)
    return (rel[0] * (2 * ws - 1) + rel[1]).reshape(-1)


def diag_extractor(ws: int) -> np.ndarray:
    """R[i, j, a] = 1 iff i - j + (w-1) == a; shape (w, w, 2w-1)."""
    i = np.arange(ws)
    out = np.zeros((ws, ws, 2 * ws - 1), np.float32)
    out[i[:, None], i[None, :], i[:, None] - i[None, :] + (ws - 1)] = 1.0
    return out


class _RelativePositionBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ws: int):
        ctx.ws = ws
        return table[torch.as_tensor(rel_index(ws), device=table.device)]

    @staticmethod
    def backward(ctx, g):
        # g: (n^2, h) cotangent of the gathered rows
        ws = ctx.ws
        h = g.shape[-1]
        g5 = g.reshape(ws, ws, ws, ws, h)  # [row_p, col_p, row_q, col_q, h]
        R = torch.as_tensor(diag_extractor(ws), dtype=g.dtype, device=g.device)
        t = torch.einsum("pcqdh,pqa->acdh", g5, R)  # contract the row pair
        dt = torch.einsum("acdh,cdb->abh", t, R)    # then the column pair
        return dt.reshape((2 * ws - 1) ** 2, h), None


def relative_position_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """((2w-1)^2, h) CPB table -> (n^2, h) bias rows, n = w^2; the same
    value as ``table[rel_index(ws)]``, with the Toeplitz adjoint."""
    return _RelativePositionBias.apply(table, ws)
