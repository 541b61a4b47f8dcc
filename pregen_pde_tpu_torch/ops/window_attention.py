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
node.

On the card the kernels read every operand in place, through its strides:
q, k and v must be float32 with their last dim contiguous and each row of
hd floats 16-byte aligned (``operand_strides`` checks that and raises
otherwise; the model's ``reshape(nb, n, h, hd).permute(0, 2, 1, 3)`` views
of its projections pass), the bias float32 with any strides. The forward
writes ``out`` into an (nb, n, h, hd) buffer and returns it as the (nb, h,
n, hd) view, so the model's ``permute(0, 2, 1, 3).reshape(nb, n, c)`` is a
view; the backward returns dq, dk, dv the same way and reads ``do`` in
place. A forward call launches its kernel and nothing else: no copies, no
casts. The backward copies only what its kernels cannot read: a ``do``
not laid out as above, and on the wide route a bias whose rows are not
contiguous (the model's).

``launches`` counts the forward kernels enqueued (1 a call),
``bwd_launches`` the backward's: ``BWD_KERNELS_PER_CALL[bwd_route(n)]`` a
call, 1 on the "small" route (n ≤ 32: a block per window slot and head,
dbias summed in the block) and 2 on the "wide" route (the tensor-core
attention backward, then the dbias sum of its score-gradient scratch). The
forward's routes split at the same n (``SMALL_MAX_N``): a warp per (row,
head) on the CUDA cores, or query tiles with P·V on 3xTF32 tensor cores.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import torch

from pregen_pde_tpu_torch.kernels import build as _build

__all__ = ["LIB_NAME", "window_attention", "window_attention_plain",
           "window_attention_lse_plain", "window_attention_bwd_plain",
           "window_attention_bwd_lse_plain", "operand_strides", "launches", "bwd_launches",
           "reset_launches", "HEAD_DIMS", "BWD_KERNELS_PER_CALL", "SMALL_MAX_N", "bwd_route"]

LIB_NAME = "window_attention"
HEAD_DIMS = (8, 16, 32, 64)  # the kernels' template instances
MAX_SMEM = 227 * 1024
SMALL_MAX_N = 32  # the small routes take n <= 32, the wide routes the rest
BWD_KERNELS_PER_CALL = {"small": 1, "wide": 2}

launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F32 = torch.float32
# the entry points take their arguments packed as int64 behind one pointer:
# ctypes converts every argument of every call, and the forward's call is
# host bound (at scOT-B's stage 3 the wrapper took 31.0 µs of host time a
# call packed, 36.5 with 28 typed arguments; NVIDIA H100, CHANGES.md's entry
# on K4's forward redesign)
_FWD_ARGS, _BWD_ARGS = struct.Struct("28q"), struct.Struct("46q")
_typed: dict = {}


class _ArgBuffers(threading.local):
    """A thread's argument buffers: each thread packs into its own, so two
    threads in K4 at once (a forward beside autograd's backward thread)
    never launch with each other's arguments."""

    def __init__(self):
        self.fwd, self.bwd = (_L * 28)(), (_L * 46)()
        self.fwd_addr, self.bwd_addr = ctypes.addressof(self.fwd), ctypes.addressof(self.bwd)


_bufs = _ArgBuffers()


def _lib() -> ctypes.CDLL:
    """The loaded library, its entry points typed once."""
    lib = _build.load(LIB_NAME)
    if _typed.get("lib") is not lib:
        lib.window_attention_fwd.argtypes = [_P]
        lib.window_attention_bwd.argtypes = [_P, ctypes.POINTER(_I)]
        lib.window_attention_smem.argtypes = [_I] * 4
        for f in (lib.window_attention_fwd, lib.window_attention_bwd,
                  lib.window_attention_smem):
            f.restype = ctypes.c_int
        _typed.update(
            fwd=lib.window_attention_fwd, bwd=lib.window_attention_bwd,
            # torch's own accessors of the current stream's handle and the
            # current device, where the build has them (no Stream object a call)
            stream=getattr(torch._C, "_cuda_getCurrentRawStream", None)
            or (lambda i: torch.cuda.current_stream(i).cuda_stream),
            device=getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device,
            lib=lib)
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


def _in_place(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(row, head, token) strides of a (nb, h, n, hd) tensor the kernels
    can read in place, else None."""
    s = t.stride()
    if t.dtype != _F32 or s[3] != 1 or t.data_ptr() & 15:
        return None
    # the common case at a glance; else the strides of dims of size 1,
    # which are never used, may be anything
    if (s[0] | s[1] | s[2]) & 3 and any(st % 4 for st, size in zip(s[:3], t.shape[:3])
                                        if size > 1):
        return None
    return s[0], s[1], s[2]


def operand_strides(t: torch.Tensor, name: str = "operand") -> tuple[int, int, int]:
    """(row, head, token) strides of a K4 operand (nb, h, n, hd) as the
    kernels read it in place: float32, the last dim contiguous and every row
    of hd floats 16-byte aligned. Raises ValueError otherwise. It reads only
    the tensor's metadata, so it runs on any device."""
    s = _in_place(t)
    if s is None:
        raise ValueError(f"K4 reads {name} in place: it must be float32 with its last dim "
                         f"contiguous and rows 16-byte aligned; got {t.dtype}, strides "
                         f"{tuple(t.stride())}, data pointer mod 16 = {t.data_ptr() % 16}")
    return s


_smem_ok: set = set()


def _check_kernel_shape(fwd: bool, n: int, hd: int, nimg: int = 0) -> None:
    """Raise unless the kernel (forward or backward) takes n and hd, with
    the shared memory it needs within the card's (cached per shape)."""
    key = (fwd, n, hd, nimg)
    if key in _smem_ok:
        return
    if hd not in HEAD_DIMS or not 1 <= n <= 1024:
        raise ValueError(f"the K4 kernels take hd in {HEAD_DIMS} and 1 <= n <= 1024; got "
                         f"hd = {hd}, n = {n}")
    smem = _lib().window_attention_smem(int(fwd), n, hd, nimg)
    if not 0 < smem <= MAX_SMEM:
        raise ValueError(f"the K4 {'forward' if fwd else 'backward'} cannot hold n = {n}, "
                         f"hd = {hd} in 227 KB of shared memory ({smem} bytes)")
    _smem_ok.add(key)


def _forward_kernel(q, k, v, bias, save: bool = False):
    """(out, lse): K4's forward on CUDA tensors, read in place; out (nb, h,
    n, hd) laid out as (nb, n, h, hd), lse (nb, h, n) only when ``save``
    (else None). Allocates out and lse and nothing else."""
    global launches
    if "fwd" not in _typed:
        _lib()
    t = _typed
    dev = q.device
    if k.device != dev or v.device != dev or bias.device != dev:
        raise ValueError(f"K4's operands must share one device, got q {dev}, k {k.device}, "
                         f"v {v.device}, bias {bias.device}")
    if dev.index != t["device"]():
        with torch.cuda.device(dev):
            return _forward_kernel(q, k, v, bias, save)
    nb, h, n, hd = q.shape
    sq, sk, sv = operand_strides(q, "q"), operand_strides(k, "k"), operand_strides(v, "v")
    if bias.dtype != _F32:
        raise ValueError(f"K4 reads the bias in place: it must be float32, got {bias.dtype}")
    _check_kernel_shape(True, n, hd)
    out = torch.empty_strided((nb, h, n, hd), (n * h * hd, hd, h * hd, 1), dtype=_F32,
                              device=dev)
    lse = torch.empty((nb, h, n), dtype=_F32, device=dev) if save else None
    sb = bias.stride()
    buf = _bufs
    _FWD_ARGS.pack_into(buf.fwd, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(), out.data_ptr(),
                        lse.data_ptr() if save else 0, sq[0], sq[1], sq[2], sk[0], sk[1], sk[2],
                        sv[0], sv[1], sv[2], n * h * hd, hd, h * hd, sb[0], sb[1], sb[2], sb[3],
                        nb, h, n, hd, bias.shape[0], t["stream"](dev.index))
    rc = t["fwd"](buf.fwd_addr)
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} failed with CUDA error {rc}")
    launches += 1
    return out, lse


def _backward_kernel(q, k, v, bias, out, lse, do):
    """(dq, dk, dv, dbias) of K4 from the forward's out and lse, on CUDA. q,
    k, v, bias, out, lse and do are read in place, but for two copies made
    here: a ``do`` the kernels cannot read, and on the wide route (n > 32)
    a bias whose rows are not contiguous (the model's, heads fastest: its
    column stride in the kernel's hot loops cost more than the 3 MB copy
    at scOT-B stage 0). dq, dk, dv are (nb, h, n, hd) laid out as (nb, n,
    h, hd), dbias (nw, h, n, n) float32."""
    global bwd_launches
    if "bwd" not in _typed:
        _lib()
    t = _typed
    if q.device.index != t["device"]():
        with torch.cuda.device(q.device):
            return _backward_kernel(q, k, v, bias, out, lse, do)
    nb, h, n, hd = q.shape
    nw = bias.shape[0]
    _check_kernel_shape(False, n, hd, nb // nw)
    if _in_place(do) is None:
        do = do.to(_F32).contiguous()
    if n > SMALL_MAX_N and bias.stride(3) != 1:
        bias = bias.contiguous()  # the wide route reads contiguous bias rows
    strides = [*operand_strides(q, "q"), *operand_strides(k, "k"), *operand_strides(v, "v"),
               *operand_strides(out, "out"), *operand_strides(do, "do")]
    res = (n * h * hd, hd, h * hd, 1)
    dev = q.device
    dq, dk, dv = (torch.empty_strided((nb, h, n, hd), res, dtype=_F32, device=dev)
                  for _ in range(3))
    dbias = torch.empty((nw, h, n, n), dtype=_F32, device=dev)
    # the wide route's score-gradient scratch, freed on return
    ds = torch.empty((nb, h, n, n), dtype=_F32, device=dev) if n > SMALL_MAX_N else None
    count = ctypes.c_int(0)
    buf = _bufs
    _BWD_ARGS.pack_into(
        buf.bwd, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), bias.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dbias.data_ptr(), 0 if ds is None else ds.data_ptr(), *strides,
        *res[:3] * 3, *bias.stride(), nb, h, n, hd, nw, t["stream"](dev.index))
    rc = t["bwd"](buf.bwd_addr, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} backward failed with CUDA error {rc}")
    bwd_launches += count.value
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        if q.device.type == "cpu":
            out = window_attention_plain(q, k, v, bias)
            ctx.save_for_backward(q, k, v, bias, out)
            return out
        out, lse = _forward_kernel(q, k, v, bias, save=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)  # as they are: no copies
        return out

    @staticmethod
    def backward(ctx, do):
        if do.device.type == "cpu":
            q, k, v, bias, out = ctx.saved_tensors
            grads = window_attention_bwd_plain(q, k, v, bias, do)
            return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v, bias)))
        return _backward_kernel(*ctx.saved_tensors, do)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    nb, h, n, hd = q.shape
    nw = bias.shape[0]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if bias.shape != (nw, h, n, n) or nb % nw:
        raise ValueError(f"bias must be (nw, {h}, {n}, {n}) with nb % nw == 0; got "
                         f"{tuple(bias.shape)} for nb = {nb}")
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad
                                        or bias.requires_grad):
            return _WindowAttention.apply(q, k, v, bias)
        return _forward_kernel(q, k, v, bias)[0]  # nothing saved, no node
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return _WindowAttention.apply(q, k, v, bias)
