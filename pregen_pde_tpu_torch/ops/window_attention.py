"""Window attention, K4 (counterpart of ``ops/window_attention.py``).

``window_attention(q, k, v, bias)`` computes, per (row, head),
``softmax(q kᵀ + bias[row % nw]) v`` on q, k, v of shape (nb, h, n, hd),
with q and k already cosine-normalised and q already scaled by the per-head
logit scale, and an additive (nw, h, n, n) bias (16σ(CPB) plus the −100
shift mask) shared across images: window w of image b is row b·nw + w.

It is a ``torch.autograd.Function``. For a CPU tensor the forward and the
backward run their plain versions (``window_attention_plain``,
``window_attention_bwd_plain``); for a CUDA tensor they launch the
hand-written kernels of ``csrc/window_attention.cu`` (replacing the Pallas
TPU kernels of ``pregen_pde_tpu/ops/window_attention.py``: ``_fwd_kernel``
and ``_bwd_kernel``) or raise. ``launches`` counts the forward kernels
enqueued (1 a call), ``bwd_launches`` the backward's (3 a call: the row
pass writing dq and the score gradient, the key pass writing dk and dv, and
the bias-gradient sum over images).
"""

from __future__ import annotations

import ctypes

import torch

from pregen_pde_tpu_torch.kernels import build as _build

__all__ = ["LIB_NAME", "window_attention", "window_attention_plain",
           "window_attention_bwd_plain", "launches", "bwd_launches", "reset_launches",
           "HEAD_DIMS", "BWD_KERNELS_PER_CALL"]

LIB_NAME = "window_attention"
HEAD_DIMS = (8, 16, 32, 64)  # the kernels' template instances
MAX_SMEM = 227 * 1024
BWD_KERNELS_PER_CALL = 3

launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME)
    f = lib.window_attention_fwd
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    f = lib.window_attention_bwd
    f.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    f.restype = ctypes.c_int
    return lib


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The same function as eager torch ops (the JAX test oracle's math)."""
    nb, h, n, _ = q.shape
    nw = bias.shape[0]
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k)
    logits = (logits.reshape(nb // nw, nw, h, n, n) + bias[None]).reshape(nb, h, n, n)
    return torch.einsum("bhnm,bhmd->bhnd", torch.softmax(logits, dim=-1), v)


def window_attention_bwd_plain(q, k, v, bias, do):
    """(dq, dk, dv, dbias): the JAX ``_bwd_kernel`` math as eager torch ops.
    dbias is float32 (nw, h, n, n), each window's block summed over the
    images (with nw = 1 every row sums into the one block)."""
    nb, h, n, _ = q.shape
    nw = bias.shape[0]
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k)
    logits = (logits.reshape(nb // nw, nw, h, n, n) + bias[None]).reshape(nb, h, n, n)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhnm,bhnd->bhmd", p, do)
    dp = torch.einsum("bhnd,bhmd->bhnm", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, k)
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, q)
    dbias = ds.to(torch.float32).reshape(nb // nw, nw, h, n, n).sum(0)
    return dq, dk, dv, dbias


def _check_kernel_shape(hd: int, n: int) -> None:
    if hd not in HEAD_DIMS or n > 1024 or 8 * n * hd + 8 * n + 128 > MAX_SMEM:
        raise ValueError(f"the K4 kernels take hd in {HEAD_DIMS} and n <= 1024 with "
                         f"2 n hd floats <= 227 KB; got hd = {hd}, n = {n}")


def _forward_kernel(q, k, v, bias):
    global launches
    nb, h, n, hd = q.shape
    _check_kernel_shape(hd, n)
    args = [t.to(torch.float32).contiguous() for t in (q, k, v, bias)]
    out = torch.empty((nb, h, n, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        st = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().window_attention_fwd(*(a.data_ptr() for a in args), out.data_ptr(),
                                         nb, h, n, hd, bias.shape[0], st)
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} failed with CUDA error {rc}")
    launches += 1
    return out


def _backward_kernel(q, k, v, bias, out, do):
    global bwd_launches
    nb, h, n, hd = q.shape
    nw = bias.shape[0]
    _check_kernel_shape(hd, n)
    dev = q.device
    args = [t.to(torch.float32).contiguous() for t in (q, k, v, bias, out, do)]
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    dq, dk, dv = empty(nb, h, n, hd), empty(nb, h, n, hd), empty(nb, h, n, hd)
    dbias = empty(nw, h, n, n)
    ds, stats = empty(nb, h, n, n), empty(nb, h, n, 2)  # scratch
    count = ctypes.c_int(0)
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().window_attention_bwd(
            *(t.data_ptr() for t in args + [dq, dk, dv, dbias, ds, stats]), nb, h, n, hd, nw, st,
            ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} backward failed with CUDA error {rc}")
    bwd_launches += count.value
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        if q.device.type == "cpu":
            out = window_attention_plain(q, k, v, bias)
        else:
            out = _forward_kernel(q, k, v, bias).to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = window_attention_bwd_plain(q, k, v, bias, do)
        else:
            grads = _backward_kernel(q, k, v, bias, out, do)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, bias)))


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    nb, h, n, hd = q.shape
    nw = bias.shape[0]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if tuple(bias.shape) != (nw, h, n, n) or nb % nw:
        raise ValueError(f"bias must be (nw, {h}, {n}, {n}) with nb % nw == 0; got "
                         f"{tuple(bias.shape)} for nb = {nb}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return _WindowAttention.apply(q, k, v, bias)
