"""Window attention forward, K4 (counterpart of ``ops/window_attention.py``).

``window_attention(q, k, v, bias)`` computes, per (row, head),
``softmax(q kᵀ + bias[row % nw]) v`` on q, k, v of shape (nb, h, n, hd),
with q and k already cosine-normalised and q already scaled by the per-head
logit scale, and an additive (nw, h, n, n) bias (16σ(CPB) plus the −100
shift mask) shared across images: window w of image b is row b·nw + w.

For a CPU tensor it runs the plain version (``window_attention_plain``);
for a CUDA tensor it launches the hand-written kernel
(``csrc/window_attention.cu``, replacing the Pallas TPU kernel
``pregen_pde_tpu/ops/window_attention.py::window_attention``) or raises.
``launches`` counts the kernels enqueued. Forward only: the backward kernel
comes with the training slice, and a CUDA input that requires a gradient
raises.
"""

from __future__ import annotations

import ctypes

import torch

from pregen_pde_tpu_torch.kernels import build as _build

__all__ = ["LIB_NAME", "window_attention", "window_attention_plain", "launches",
           "reset_launches", "HEAD_DIMS"]

LIB_NAME = "window_attention"
HEAD_DIMS = (8, 16, 32, 64)  # the kernel's template instances
MAX_SMEM = 227 * 1024

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME)
    f = lib.window_attention_fwd
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return lib


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """The CUDA kernels are forward only until the training slice ports
    their backward kernels: never compute a gradient silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; its backward kernel comes with the "
            "scOT training slice (ROADMAP Queue 1 item 7b). Run under torch.no_grad() or "
            "torch.inference_mode().")


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The same function as eager torch ops (the JAX test oracle's math)."""
    nb, h, n, _ = q.shape
    nw = bias.shape[0]
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k)
    logits = (logits.reshape(nb // nw, nw, h, n, n) + bias[None]).reshape(nb, h, n, n)
    return torch.einsum("bhnm,bhmd->bhnd", torch.softmax(logits, dim=-1), v)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    global launches
    nb, h, n, hd = q.shape
    nw = bias.shape[0]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if tuple(bias.shape) != (nw, h, n, n) or nb % nw:
        raise ValueError(f"bias must be (nw, {h}, {n}, {n}) with nb % nw == 0; got "
                         f"{tuple(bias.shape)} for nb = {nb}")
    dev = q.device
    if dev.type == "cpu":
        return window_attention_plain(q, k, v, bias)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_no_grad("window_attention", q, k, v, bias)
    if hd not in HEAD_DIMS or n > 1024 or 8 * n * hd > MAX_SMEM:
        raise ValueError(f"the K4 kernel takes hd in {HEAD_DIMS} and n <= 1024 with "
                         f"2 n hd floats <= 227 KB; got hd = {hd}, n = {n}")
    args = [t.to(torch.float32).contiguous() for t in (q, k, v, bias)]
    out = torch.empty((nb, h, n, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().window_attention_fwd(*(a.data_ptr() for a in args), out.data_ptr(),
                                         nb, h, n, hd, nw, st)
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} failed with CUDA error {rc}")
    launches += 1
    return out.to(q.dtype)
