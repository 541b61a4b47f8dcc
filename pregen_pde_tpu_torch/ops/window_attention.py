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
and ``_bwd_kernel``) or raise. On the card the forward also writes each
row's log-sum-exp when autograd records the call, and the backward rebuilds
P from it (``window_attention_bwd_lse_plain`` is that arithmetic as torch
ops); with no input that requires a gradient, or under
``torch.inference_mode()``, the forward saves nothing and makes no autograd
node. ``launches`` counts the forward kernels enqueued (1 a call),
``bwd_launches`` the backward's: ``BWD_KERNELS_PER_CALL[bwd_route(n)]`` a
call, 1 on the "small" route (n ≤ 32: a block per window slot and head,
dbias summed in the block) and 2 on the "wide" route (the tensor-core
attention backward, then the dbias sum of its score-gradient scratch).
"""

from __future__ import annotations

import ctypes

import torch

from pregen_pde_tpu_torch.kernels import build as _build

__all__ = ["LIB_NAME", "window_attention", "window_attention_plain",
           "window_attention_lse_plain", "window_attention_bwd_plain",
           "window_attention_bwd_lse_plain", "launches", "bwd_launches", "reset_launches",
           "HEAD_DIMS", "BWD_KERNELS_PER_CALL", "SMALL_MAX_N", "bwd_route"]

LIB_NAME = "window_attention"
HEAD_DIMS = (8, 16, 32, 64)  # the kernels' template instances
MAX_SMEM = 227 * 1024
SMALL_MAX_N = 32  # the backward's small route takes n <= 32, the wide route the rest
BWD_KERNELS_PER_CALL = {"small": 1, "wide": 2}

launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


_typed: dict = {}


def _lib() -> ctypes.CDLL:
    """The loaded library, its entry points typed once."""
    lib = _build.load(LIB_NAME)
    if _typed.get("lib") is not lib:
        lib.window_attention_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                             + [ctypes.c_void_p])
        lib.window_attention_bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                                             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        lib.window_attention_bwd_smem.argtypes = [ctypes.c_int] * 3
        for f in (lib.window_attention_fwd, lib.window_attention_bwd,
                  lib.window_attention_bwd_smem):
            f.restype = ctypes.c_int
        _typed["lib"] = lib
    return lib


def bwd_route(n: int) -> str:
    """The backward kernel's route for windows of n tokens."""
    return "small" if n <= SMALL_MAX_N else "wide"


def _logits(q, k, bias):
    nb, h, n, _ = q.shape
    nw = bias.shape[0]
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k)
    return (logits.reshape(nb // nw, nw, h, n, n) + bias[None]).reshape(nb, h, n, n)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The same function as eager torch ops (the JAX test oracle's math)."""
    return torch.einsum("bhnm,bhmd->bhnd", torch.softmax(_logits(q, k, bias), dim=-1), v)


def window_attention_lse_plain(q, k, v, bias):
    """(out, lse): the forward and each row's log-sum-exp (nb, h, n), what the
    kernel's forward saves for its backward."""
    logits = _logits(q, k, bias)
    out = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(logits, dim=-1), v)
    return out, torch.logsumexp(logits, dim=-1)


def window_attention_bwd_lse_plain(q, k, v, bias, out, lse, do):
    """(dq, dk, dv, dbias) as the backward kernel forms them: P rebuilt from
    the saved lse, D = rowsum(do · out), ds = P (do vᵀ − D)."""
    nb, h, n, _ = q.shape
    nw = bias.shape[0]
    p = torch.exp(_logits(q, k, bias) - lse[..., None])
    dv = torch.einsum("bhnm,bhnd->bhmd", p, do)
    ds = p * (torch.einsum("bhnd,bhmd->bhnm", do, v) - (do * out).sum(-1)[..., None])
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, k)
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, q)
    dbias = ds.to(torch.float32).reshape(nb // nw, nw, h, n, n).sum(0)
    return dq, dk, dv, dbias


def window_attention_bwd_plain(q, k, v, bias, do):
    """(dq, dk, dv, dbias): the JAX ``_bwd_kernel`` math as eager torch ops.
    dbias is float32 (nw, h, n, n), each window's block summed over the
    images (with nw = 1 every row sums into the one block)."""
    nb, h, n, _ = q.shape
    nw = bias.shape[0]
    p = torch.softmax(_logits(q, k, bias), dim=-1)
    dv = torch.einsum("bhnm,bhnd->bhmd", p, do)
    dp = torch.einsum("bhnd,bhmd->bhnm", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, k)
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, q)
    dbias = ds.to(torch.float32).reshape(nb // nw, nw, h, n, n).sum(0)
    return dq, dk, dv, dbias


def _check_kernel_shape(hd: int, n: int) -> None:
    if hd not in HEAD_DIMS or n > 1024 or 8 * n * hd > MAX_SMEM:
        raise ValueError(f"the K4 kernels take hd in {HEAD_DIMS} and n <= 1024 with "
                         f"2 n hd floats <= 227 KB; got hd = {hd}, n = {n}")


def _launch(dev, fn, *args, tail=()):
    """``fn(*args, stream, *tail)``, the C entry points' order, on ``dev``'s
    current stream, with ``dev`` made the current device when it is not."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream, *tail)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream, *tail)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _forward_kernel(q, k, v, bias, save: bool = False):
    """(out, lse): K4's forward on CUDA tensors; lse (nb, h, n) only when
    ``save`` (else None)."""
    global launches
    nb, h, n, hd = q.shape
    _check_kernel_shape(hd, n)
    args = [_f32(t) for t in (q, k, v, bias)]
    out = torch.empty((nb, h, n, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((nb, h, n), dtype=torch.float32, device=q.device) if save else None
    rc = _launch(q.device, _lib().window_attention_fwd, *(a.data_ptr() for a in args),
                 out.data_ptr(), lse.data_ptr() if save else None, nb, h, n, hd, bias.shape[0])
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} failed with CUDA error {rc}")
    launches += 1
    return out, lse


_bwd_smem: dict = {}


def _backward_kernel(q, k, v, bias, out, lse, do):
    """(dq, dk, dv, dbias) of K4 from the forward's out and lse, on CUDA. q,
    k, v, bias, out and lse are the forward's float32 contiguous operands
    and results (as ``_WindowAttention`` saves them); ``do`` is made so."""
    global bwd_launches
    nb, h, n, hd = q.shape
    nw = bias.shape[0]
    lib = _lib()
    key = (n, hd, nb // nw)
    smem = _bwd_smem.get(key)
    if smem is None:
        _check_kernel_shape(hd, n)
        smem = _bwd_smem[key] = lib.window_attention_bwd_smem(*key)
    if not 0 < smem <= MAX_SMEM:
        raise ValueError(f"the K4 backward cannot hold n = {n}, hd = {hd} in 227 KB of "
                         f"shared memory ({smem} bytes)")
    do = _f32(do)
    grads = torch.empty((3, nb, h, n, hd), dtype=torch.float32, device=q.device)
    dbias = torch.empty((nw, h, n, n), dtype=torch.float32, device=q.device)
    # the wide route's score-gradient scratch, freed on return
    ds = (torch.empty((nb, h, n, n), dtype=torch.float32, device=q.device)
          if n > SMALL_MAX_N else None)
    g = grads.data_ptr()
    step = q.numel() * 4
    count = ctypes.c_int(0)
    rc = _launch(q.device, lib.window_attention_bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), do.data_ptr(), lse.data_ptr(), bias.data_ptr(), g, g + step,
                 g + 2 * step, dbias.data_ptr(), None if ds is None else ds.data_ptr(), nb, h,
                 n, hd, nw, tail=(ctypes.byref(count),))
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} backward failed with CUDA error {rc}")
    bwd_launches += count.value
    dq, dk, dv = grads.unbind(0)
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        if q.device.type == "cpu":
            out = window_attention_plain(q, k, v, bias)
            ctx.save_for_backward(q, k, v, bias, out)
            return out
        args = [_f32(t) for t in (q, k, v, bias)]
        out, lse = _forward_kernel(*args, save=True)
        ctx.save_for_backward(*args, out, lse)
        ctx.dtypes = (q.dtype, k.dtype, v.dtype, bias.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        if do.device.type == "cpu":
            q, k, v, bias, out = ctx.saved_tensors
            grads = window_attention_bwd_plain(q, k, v, bias, do)
            return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, bias)))
        q, k, v, bias, out, lse = ctx.saved_tensors
        grads = _backward_kernel(q, k, v, bias, out, lse, do)
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes))


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
    if q.device.type == "cuda" and not (torch.is_grad_enabled()
                                        and any(t.requires_grad for t in (q, k, v, bias))):
        return _forward_kernel(q, k, v, bias)[0].to(q.dtype)  # nothing saved, no node
    return _WindowAttention.apply(q, k, v, bias)
