"""Swin-V2 block, K3 (counterpart of ``ops/swin_block.py``).

``swin_block`` runs one post-norm Swin-V2 layer on a (B, H, W, C) token
grid, cyclically shifted by ``shift``: q/k/v, cosine attention × logit
scale + bias, the output projection, a conditional LayerNorm with the
drop-path residual, the GELU-tanh MLP, a second conditional LayerNorm and
residual. It takes the weights in ``nn.Linear``'s (out, in) layout and the
biases as stored (``None``: no bias), so the model passes its parameters as
they are. The grid stays in its own order: the shift only changes which
tokens a window gathers (the same as rolling the grid by −shift, running the
block and rolling back). ``fused_swin_block`` keeps the JAX function's
signature (per-head packs, an already rolled grid) and maps its packs onto
those layouts.

It is a ``torch.autograd.Function``. For a CPU tensor the forward runs the
plain version (``swin_block_fwd_plain``) and the backward
``swin_block_bwd_linear_plain``; for a CUDA tensor they launch the
hand-written kernels of ``csrc/swin_block.cu`` (replacing the Pallas TPU
kernels of ``pregen_pde_tpu/ops/swin_block.py``, ``_fwd_kernel`` and
``_bwd_kernel``) or raise. When autograd records the call the forward saves
what the backward needs (qkv, o, the attention's log-sum-exps, both
LayerNorms' x̂ and rstd, x2, the MLP pre-activation), so the backward
recomputes nothing; otherwise (``evaluate``'s inference mode) it saves
nothing. The kernels take each window's mean rows of k̂ and v out of the
attention's products (the same values in exact arithmetic, float32's
accuracy where a window's tokens are alike), so the log-sum-exps the card
saves are of the logits less the row constant c q̂·k̄; the plain versions
keep the uncentred form. ``launches`` counts the forward kernels enqueued
(``KERNELS_PER_CALL`` a call), ``bwd_launches`` the backward's
(``BWD_KERNELS_PER_CALL``); the C entry points report them.

Gate: the kernels take C ≤ ``MAX_FUSED_DIM`` = 384 (a block of the row
products owns whole C-wide rows), hd in ``HEAD_DIMS`` and windows of n a
multiple of 16 up to 256. The JAX package fuses its backward only up to
C = 192 (``MAX_FUSED_BWD_DIM``, the TPU's VMEM); the port has no such limit.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

from pregen_pde_tpu_torch.kernels import build as _build
from pregen_pde_tpu_torch.ops.window_attention import HEAD_DIMS

__all__ = ["LIB_NAME", "MAX_FUSED_DIM", "swin_block", "fused_swin_block", "swin_block_fwd_plain",
           "swin_block_bwd_linear_plain", "swin_block_plain", "swin_block_bwd_plain",
           "linear_from_packs", "launches", "bwd_launches", "reset_launches", "KERNELS_PER_CALL",
           "BWD_KERNELS_PER_CALL", "COTANGENTS"]

LIB_NAME = "swin_block"
# the JAX package's gate (`swin_block.py:62`): wider stages take the unfused
# layer. Carried over as it is; a later change sets it from measurements on the card.
MAX_FUSED_DIM = 384
KERNELS_PER_CALL = 5
BWD_KERNELS_PER_CALL = 8
# the names of the 19 operands' cotangents, in operand order
COTANGENTS = ("dx dbias dscale dwq dbq dwk dwv dbv dwp dbp dln1w dln1b "
              "dw1 db1 dw2 db2 dln2w dln2b ddp").split()

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
        tail = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.swin_block_fwd.argtypes = [ctypes.c_void_p] * 29 + tail
        lib.swin_block_fwd.restype = ctypes.c_int
        lib.swin_block_bwd.argtypes = [ctypes.c_void_p] * 44 + tail
        lib.swin_block_bwd.restype = ctypes.c_int
        lib.swin_block_bwd_workspace.argtypes = [ctypes.c_int] * 7
        lib.swin_block_bwd_workspace.restype = ctypes.c_longlong
        _typed["lib"] = lib
    return lib


def _launch(dev, fn, *args):
    """``fn(*args[:-1], stream, args[-1])``, the C entry points' order, on
    ``dev``'s current stream, with ``dev`` made the current device when it
    is not."""
    if dev.index == torch.cuda.current_device():
        return fn(*args[:-1], torch.cuda.current_stream(dev).cuda_stream, args[-1])
    with torch.cuda.device(dev):
        return fn(*args[:-1], torch.cuda.current_stream(dev).cuda_stream, args[-1])


# ---- the plain versions -------------------------------------------------------------------

def _ln_fwd(t, eps):
    """(normalised t, rstd) with var = E[t²] − mean², as the JAX block."""
    mean = t.mean(-1, keepdim=True)
    var = (t * t).mean(-1, keepdim=True) - mean * mean
    r = torch.rsqrt(var + eps)
    return (t - mean) * r, r


def _ln_bwd(dxhat, xhat, r):
    """LayerNorm backward per row, unit affine (the JAX ``_ln_bwd``)."""
    return r * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def _gelu_tanh_grad(h):
    c = 0.7978845608028654  # sqrt(2/pi)
    t = torch.tanh(c * (h + 0.044715 * h ** 3))
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * (c * (1.0 + 3 * 0.044715 * h * h))


def _cosine_norm_bwd(dy, x, nrm):
    """d/dx of x / (|x| + 1e-6) applied to dy, with the JAX kernel's guard."""
    xdot = (dy * x).sum(-1, keepdim=True)
    return dy / (nrm + 1e-6) - x * (xdot / (nrm.clamp(min=1e-30) * (nrm + 1e-6) ** 2))


def _linear(t, w, b):
    y = t @ w.T
    return y if b is None else y + b


def _heads(t, ws, shift, num_heads):
    """(B, H, W, C) in the grid's order → (B, windows, h, n, hd) of the
    grid rolled by −shift."""
    b, hh, ww, c = t.shape
    if shift:
        t = torch.roll(t, (-shift, -shift), (1, 2))
    t = t.reshape(b, hh // ws, ws, ww // ws, ws, num_heads, c // num_heads)
    t = t.permute(0, 1, 3, 5, 2, 4, 6)
    return t.reshape(b, (hh // ws) * (ww // ws), num_heads, ws * ws, -1)


def _grid(t, hh, ww, ws, shift):
    """The inverse of ``_heads``."""
    b, _, h, _, hd = t.shape
    t = t.reshape(b, hh // ws, ww // ws, h, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6)
    t = t.reshape(b, hh, ww, h * hd)
    return torch.roll(t, (shift, shift), (1, 2)) if shift else t


def _window_bias(bias):
    """(nw, h, n, n) → broadcast over (B, windows, h, n, n): per window slot
    when nw > 1 (shift mask), shared otherwise."""
    return bias[None] if bias.shape[0] > 1 else bias[None, 0][:, None]


def _per_sample(t):
    return t[:, None, None, :]


def swin_block_fwd_plain(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                         ln2w, ln2b, dp, num_heads: int, window: int, eps: float, shift: int = 0,
                         save: bool = False):
    """The block as eager torch ops in the ``nn.Linear`` layouts, the
    kernels' dataflow. → (y, what the backward needs or None): qkv (B, H, W,
    3C), o (B, H, W, C), lse (R, h, n) over the R = B·windows windows of
    the shifted grid, x̂₁, x̂₂ (B, H, W, C), rstd₁, rstd₂ (B, H, W), x2, hpre
    (B, H, W, F)."""
    b, hh, ww, c = x.shape
    ws = window
    q, k, v = _linear(x, wq, bq), _linear(x, wk, None), _linear(x, wv, bv)
    qh, kh, vh = (_heads(t, ws, shift, num_heads) for t in (q, k, v))
    qn = qh / (torch.sqrt((qh * qh).sum(-1, keepdim=True)) + 1e-6)
    kn = kh / (torch.sqrt((kh * kh).sum(-1, keepdim=True)) + 1e-6)
    logits = (torch.einsum("bwhnd,bwhmd->bwhnm", qn, kn) * scale[None, None, :, None, None]
              + _window_bias(bias))
    o = _grid(torch.einsum("bwhnm,bwhmd->bwhnd", torch.softmax(logits, dim=-1), vh), hh, ww, ws,
              shift)
    ahat, r1 = _ln_fwd(_linear(o, wp, bp), eps)
    x2 = x + dp[:, 0, None, None, None] * (ahat * _per_sample(ln1w) + _per_sample(ln1b))
    hpre = _linear(x2, w1, b1)
    mhat, r2 = _ln_fwd(_linear(F.gelu(hpre, approximate="tanh"), w2, b2), eps)
    y = x2 + dp[:, 1, None, None, None] * (mhat * _per_sample(ln2w) + _per_sample(ln2b))
    if not save:
        return y, None
    lse = torch.logsumexp(logits, -1).reshape(-1, num_heads, ws * ws)
    return y, (torch.cat([q, k, v], -1), o, lse, ahat, r1[..., 0], x2, hpre, mhat, r2[..., 0])


def swin_block_bwd_linear_plain(x, dy, bias, scale, wq, wk, wv, wp, w1, w2, ln1w, ln1b, ln2w,
                                ln2b, dp, saved, num_heads: int, window: int, eps: float,
                                shift: int = 0, biases=(True,) * 5):
    """The 19 cotangents of ``swin_block_fwd_plain`` for the output gradient
    ``dy``, from what it saved (nothing recomputed but P from the
    log-sum-exps): the kernels' dataflow as eager torch ops, in the
    operands' layouts. ``biases`` says which of bq, bv, bp, b1, b2 exist;
    a missing bias gets None. ``dbias`` is float32 (nw, h, n, n): each
    window slot's block summed over images, or with nw = 1 every window of
    every image in the one block."""
    b, hh, ww, c = x.shape
    ws, n, nw = window, window * window, bias.shape[0]
    qkv, o, lse, ahat, r1, x2, hpre, mhat, r2 = saved
    d1, d2 = dp[:, 0, None, None, None], dp[:, 1, None, None, None]
    dmm = d2 * dy
    dln2w, dln2b = (dmm * mhat).sum((1, 2)), dmm.sum((1, 2))
    dd2 = (dy * (mhat * _per_sample(ln2w) + _per_sample(ln2b))).sum((1, 2, 3))
    dm = _ln_bwd(dmm * _per_sample(ln2w), mhat, r2[..., None])
    dw2 = torch.einsum("bhwc,bhwf->cf", dm, F.gelu(hpre, approximate="tanh"))
    dh = (dm @ w2) * _gelu_tanh_grad(hpre)
    dx2 = dy + dh @ w1
    dw1 = torch.einsum("bhwf,bhwc->fc", dh, x2)
    da = d1 * dx2
    dd1 = (dx2 * (ahat * _per_sample(ln1w) + _per_sample(ln1b))).sum((1, 2, 3))
    dln1w, dln1b = (da * ahat).sum((1, 2)), da.sum((1, 2))
    dattn = _ln_bwd(da * _per_sample(ln1w), ahat, r1[..., None])
    dwp = torch.einsum("bhwc,bhwd->cd", dattn, o)
    # the attention, per window of the shifted grid
    heads = lambda t: _heads(t, ws, shift, num_heads)
    q, k, v = (heads(t) for t in qkv.split(c, -1))
    do, oh = heads(dattn @ wp), heads(o)
    qnorm = torch.sqrt((q * q).sum(-1, keepdim=True))
    knorm = torch.sqrt((k * k).sum(-1, keepdim=True))
    qn, kn = q / (qnorm + 1e-6), k / (knorm + 1e-6)
    s_pre = torch.einsum("bwhnd,bwhmd->bwhnm", qn, kn)
    sc = scale[None, None, :, None, None]
    p = torch.exp(s_pre * sc + _window_bias(bias) - lse.reshape(b, -1, num_heads, n, 1))
    dv = torch.einsum("bwhnm,bwhnd->bwhmd", p, do)
    dpm = torch.einsum("bwhnd,bwhmd->bwhnm", do, v)
    ds = p * (dpm - (do * oh).sum(-1, keepdim=True))
    dbias = (ds.sum(0) if nw > 1 else ds.sum((0, 1))[None]).to(torch.float32)
    dscale = (ds * s_pre).sum((0, 1, 3, 4))
    dq = _cosine_norm_bwd(torch.einsum("bwhnm,bwhmd->bwhnd", ds, kn) * sc, q, qnorm)
    dk = _cosine_norm_bwd(torch.einsum("bwhnm,bwhnd->bwhmd", ds, qn) * sc, k, knorm)
    dq, dk, dv = (_grid(t, hh, ww, ws, shift) for t in (dq, dk, dv))
    dx = dx2 + dq @ wq + dk @ wk + dv @ wv
    wgrad = lambda g: torch.einsum("bhwo,bhwi->oi", g, x)
    bsum = lambda g, has: g.sum((0, 1, 2)) if has else None
    has_bq, has_bv, has_bp, has_b1, has_b2 = biases
    return (dx, dbias, dscale, wgrad(dq), bsum(dq, has_bq), wgrad(dk), wgrad(dv), bsum(dv, has_bv),
            dwp, bsum(dattn, has_bp), dln1w, dln1b, dw1, bsum(dh, has_b1), dw2, bsum(dm, has_b2),
            dln2w, dln2b, torch.stack([dd1, dd2], dim=1))


def linear_from_packs(wq, bq, wk, wv, bv, wp, bp, w1, b1, w2, b2):
    """The JAX package's per-head packs → the ``nn.Linear`` layouts:
    wq/wk/wv (h, C, hd) column splits of (in, out) kernels, wp (h, hd, C)
    row split, bq/bv (h, 1, hd), bp (1, C), w1 (C, F), b1 (1, F), w2 (F, C),
    b2 (1, C) → (out, in) weights and flat biases, contiguous."""
    c = wq.shape[1]
    dense = lambda w: w.permute(1, 0, 2).reshape(c, c)
    lin = (dense(wq).T, bq.reshape(c), dense(wk).T, dense(wv).T, bv.reshape(c),
           wp.reshape(c, c).T, bp.reshape(c), w1.T, b1.reshape(-1), w2.T, b2.reshape(-1))
    return tuple(t.contiguous() for t in lin)


def _packs_from_linear(grads, num_heads):
    """The cotangents of ``linear_from_packs``' outputs back in the packs."""
    dwq, dbq, dwk, dwv, dbv, dwp, dbp, dw1, db1, dw2, db2 = grads
    c = dwq.shape[0]
    hd = c // num_heads
    col = lambda g: g.T.reshape(c, num_heads, hd).permute(1, 0, 2)
    return (col(dwq), dbq.reshape(num_heads, 1, hd), col(dwk), col(dwv),
            dbv.reshape(num_heads, 1, hd), dwp.T.reshape(num_heads, hd, c), dbp[None], dw1.T,
            db1[None], dw2.T, db2[None])


def swin_block_plain(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                     ln2w, ln2b, dp, num_heads: int, window: int, eps: float):
    """The block on the JAX package's packed operands (``_ref_impl``)."""
    wq, bq, wk, wv, bv, wp, bp, w1, b1, w2, b2 = linear_from_packs(wq, bq, wk, wv, bv, wp, bp, w1,
                                                                   b1, w2, b2)
    return swin_block_fwd_plain(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2,
                                b2, ln2w, ln2b, dp, num_heads, window, eps)[0]


def swin_block_bwd_plain(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                         ln2w, ln2b, dp, dy, num_heads: int, window: int, eps: float):
    """The 19 cotangents of ``swin_block_plain`` for the output gradient
    ``dy`` in the operands' packed layouts (the JAX ``_bwd_kernel``'s):
    ``swin_block_fwd_plain`` saving, then ``swin_block_bwd_linear_plain``."""
    lin = linear_from_packs(wq, bq, wk, wv, bv, wp, bp, w1, b1, w2, b2)
    lq, lbq, lk, lv, lbv, lp, lbp, l1, lb1, l2, lb2 = lin
    _, saved = swin_block_fwd_plain(x, bias, scale, lq, lbq, lk, lv, lbv, lp, lbp, ln1w, ln1b, l1,
                                    lb1, l2, lb2, ln2w, ln2b, dp, num_heads, window, eps,
                                    save=True)
    g = swin_block_bwd_linear_plain(x, dy, bias, scale, lq, lk, lv, lp, l1, l2, ln1w, ln1b, ln2w,
                                    ln2b, dp, saved, num_heads, window, eps)
    dwq, dbq, dwk, dwv, dbv, dwp, dbp, dw1, db1, dw2, db2 = _packs_from_linear(
        (g[3], g[4], g[5], g[6], g[7], g[8], g[9], g[12], g[13], g[14], g[15]), num_heads)
    return (g[0], g[1], g[2], dwq, dbq, dwk, dwv, dbv, dwp, dbp, g[10], g[11], dw1, db1, dw2, db2,
            g[16], g[17], g[18])


# ---- the kernels ----------------------------------------------------------------------------

def _check_kernel_operands(tensors, C, hd, n, F_):
    if hd not in HEAD_DIMS or n % 16 or n > 256 or C > MAX_FUSED_DIM or F_ % 4:
        raise ValueError(f"the K3 kernels take hd in {HEAD_DIMS}, n a multiple of 16 up to 256, "
                         f"C <= {MAX_FUSED_DIM} and a hidden width that is a multiple of 4; got "
                         f"hd = {hd}, n = {n}, C = {C}, F = {F_}")
    for t in tensors:
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the K3 kernels take contiguous, 16-byte aligned float32 tensors; "
                             f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward_kernel(args, num_heads, window, eps, shift, save):
    """K3's forward on CUDA tensors in the ``nn.Linear`` layouts → (y, the
    tensors ``swin_block_fwd_plain`` saves, in its order, or None)."""
    global launches
    x, bias = args[0], args[1]
    B, H, W, C = x.shape
    Fh, n, nw = args[12].shape[0], window * window, bias.shape[0]
    _check_kernel_operands(args, C, C // num_heads, n, Fh)
    M, R = B * H * W, B * (H // window) * (W // window)
    # qkv, o, x2, hpre (scratch, or saved), then lse, x^1, rstd1, x^2, rstd2
    # when saving: one allocation; every piece a multiple of 16 bytes
    shapes = [(B, H, W, 3 * C), (B, H, W, C), (B, H, W, C), (B, H, W, Fh)]
    if save:
        shapes += [(R, num_heads, n), (B, H, W, C), (B, H, W), (B, H, W, C), (B, H, W)]
    sizes = [math.prod(s) for s in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    offs = list(itertools.accumulate([0] + sizes[:-1]))
    ptrs = [buf.data_ptr() + 4 * o for o in offs] + [None] * (9 - len(shapes))
    y = torch.empty((B, H, W, C), dtype=torch.float32, device=x.device)
    count = ctypes.c_int(0)
    rc = _launch(x.device, _lib().swin_block_fwd, *map(_ptr, args), *ptrs[:4], y.data_ptr(),
                 ptrs[4], ptrs[5], ptrs[6], ptrs[7], ptrs[8], B, H, W, C, num_heads, window, nw,
                 Fh, shift, float(eps), ctypes.byref(count))
    # the scratch may be freed while the kernels are queued: the caching
    # allocator reuses it only in this stream's order
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} failed with CUDA error {rc}")
    launches += count.value
    if not save:
        return y, None
    qkv, o, x2, hpre, lse, xhat1, rstd1, xhat2, rstd2 = (
        buf.narrow(0, off, size).view(shape) for off, size, shape in zip(offs, sizes, shapes))
    return y, (qkv, o, lse, xhat1, rstd1, x2, hpre, xhat2, rstd2)


def _backward_kernel(args, saved, dy, num_heads, window, eps, shift):
    """K3's backward on CUDA tensors: the 19 cotangents of ``args`` (the
    forward's operands in the ``nn.Linear`` layouts) from what the forward
    saved; None for a bias the layer does not have."""
    global bwd_launches
    (x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
     dp) = args
    B, H, W, C = x.shape
    Fh, n, nw = w1.shape[0], window * window, bias.shape[0]
    dy = dy.contiguous()
    _check_kernel_operands(list(args) + list(saved) + [dy], C, C // num_heads, n, Fh)
    lib = _lib()
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=x.device)
    maybe = lambda b: None if b is None else empty(*b.shape)
    outs = (empty(B, H, W, C), empty(nw, num_heads, n, n), empty(num_heads), empty(C, C),
            maybe(bq), empty(C, C), empty(C, C), maybe(bv), empty(C, C), maybe(bp), empty(B, C),
            empty(B, C), empty(Fh, C), maybe(b1), empty(C, Fh), maybe(b2), empty(B, C),
            empty(B, C), empty(B, 2))
    work = empty(lib.swin_block_bwd_workspace(B, H, W, C, num_heads, window, Fh))
    count = ctypes.c_int(0)
    rc = _launch(x.device, lib.swin_block_bwd,
                 *map(_ptr, (x, dy, bias, scale, wq, wk, wv, wp, w1, w2, ln1w, ln1b, ln2w, ln2b,
                             dp)),
                 *map(_ptr, saved), *map(_ptr, outs), work.data_ptr(), B, H, W, C, num_heads,
                 window, nw, Fh, shift, float(eps), ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} backward failed with CUDA error {rc}")
    bwd_launches += count.value
    return outs


class _SwinBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                ln2w, ln2b, dp, num_heads, window, eps, shift):
        args = (x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w,
                ln2b, dp)
        if x.device.type == "cpu":
            y, saved = swin_block_fwd_plain(*args, num_heads, window, eps, shift, True)
        else:
            y, saved = _forward_kernel(args, num_heads, window, eps, shift, True)
        ctx.static = (num_heads, window, eps, shift)
        ctx.biases = tuple(t is not None for t in (bq, bv, bp, b1, b2))
        ctx.save_for_backward(*args, *saved)
        return y

    @staticmethod
    def backward(ctx, dy):
        tensors = ctx.saved_tensors
        args, saved = tensors[:19], tensors[19:]
        num_heads, window, eps, shift = ctx.static
        if dy.device.type == "cpu":
            (x, bias, scale, wq, _, wk, wv, _, wp, _, ln1w, ln1b, w1, _, w2, _, ln2w, ln2b,
             dp) = args
            grads = swin_block_bwd_linear_plain(x, dy, bias, scale, wq, wk, wv, wp, w1, w2, ln1w,
                                                ln1b, ln2w, ln2b, dp, saved, num_heads, window,
                                                eps, shift, ctx.biases)
        else:
            grads = _backward_kernel(args, saved, dy, num_heads, window, eps, shift)
        return tuple(None if g is None else g.to(a.dtype)
                     for g, a in zip(grads, args)) + (None,) * 4


def _check_shapes(x, bias, num_heads, window):
    B, H, W, C = x.shape
    ws = window
    n = ws * ws
    nwin = (H // ws) * (W // ws)
    nw = bias.shape[0]
    if H % ws or W % ws or C % num_heads:
        raise ValueError(f"x {tuple(x.shape)} must tile into {ws}x{ws} windows and "
                         f"{num_heads} heads")
    if tuple(bias.shape) != (nw, num_heads, n, n) or nw not in (1, nwin):
        raise ValueError(f"bias must be (1 or {nwin}, {num_heads}, {n}, {n}); got "
                         f"{tuple(bias.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def swin_block(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
               dp, num_heads: int, window: int, eps: float, shift: int = 0):
    """One Swin-V2 post-norm block on a (B, H, W, C) token grid.

    x        : (B, H, W, C) in the grid's order; the block acts on the grid
               rolled by −shift and returns it in the grid's order
    bias     : (nw, h, n, n) additive logits (16σ(CPB) + shift mask) over the
               rolled grid's windows; nw = windows per image, or 1 when shared
    scale    : (h,) exp-clamped per-head logit scale
    wq/wk/wv/wp : (C, C) ``nn.Linear`` weights (out, in); bq/bv/bp (C,) or None
    w1/b1/w2/b2 : (F, C) / (F,) / (C, F) / (C,) MLP ``nn.Linear`` weights and biases
    ln1w/ln1b/ln2w/ln2b : (B, C) per-sample CondLN affines
    dp       : (B, 2) drop-path keep multipliers for the two residual adds
    """
    _check_shapes(x, bias, num_heads, window)
    tensors = (x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
               dp)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return _SwinBlock.apply(*tensors, num_heads, window, eps, shift)
    # nothing to differentiate: no graph, nothing saved
    if x.device.type == "cpu":
        return swin_block_fwd_plain(*tensors, num_heads, window, eps, shift)[0]
    return _forward_kernel(tensors, num_heads, window, eps, shift, False)[0]


def fused_swin_block(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                     ln2w, ln2b, dp, num_heads: int, window: int, eps: float):
    """The JAX package's signature: an already rolled (B, H, W, C) grid and
    the per-head packs of ``pack_heads`` (wq/wk/wv (h, C, hd), bq/bv
    (h, 1, hd), wp (h, hd, C), bp (1, C)), the MLP as (in, out) kernels
    w1 (C, F), b1 (1, F), w2 (F, C), b2 (1, C). The packs are mapped onto
    ``swin_block``'s layouts (differentiably: gradients reach the packs)."""
    wq, bq, wk, wv, bv, wp, bp, w1, b1, w2, b2 = linear_from_packs(wq, bq, wk, wv, bv, wp, bp, w1,
                                                                   b1, w2, b2)
    return swin_block(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                      ln2w, ln2b, dp, num_heads, window, eps)
