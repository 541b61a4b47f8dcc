"""Swin-V2 block, K3 (counterpart of ``ops/swin_block.py``).

``fused_swin_block`` runs one post-norm Swin-V2 layer on a (B, H, W, C)
token grid (already cyclically shifted when the layer shifts): per-head
q/k/v, cosine attention × logit scale + bias, the output projection, a
conditional LayerNorm with the drop-path residual, the GELU-tanh MLP, a
second conditional LayerNorm and residual. Its operands are those of the
JAX function, packed per head by ``pack_heads``.

It is a ``torch.autograd.Function``. For a CPU tensor the forward runs
the plain version (``swin_block_plain``, the counterpart of ``_ref_impl``)
and the backward ``swin_block_bwd_plain`` (the JAX ``_bwd_kernel`` math);
for a CUDA tensor they launch the hand-written kernels of
``csrc/swin_block.cu`` (replacing the Pallas TPU kernels of
``pregen_pde_tpu/ops/swin_block.py``, ``_fwd_kernel`` and ``_bwd_kernel``:
launches over all tokens, see the source) or raise. The backward returns
the 19 cotangents in the operands' packed layouts. ``launches`` counts the
forward kernels enqueued (7 a call), ``bwd_launches`` the backward's (the
forward recomputed, then about 40 a call; the C entry point reports them).

Gate: the backward kernel takes every shape the forward kernel takes, so
a layer that runs K3 forward (C ≤ ``MAX_FUSED_DIM`` = 384 in the model)
runs K3 backward. The JAX package fuses its backward only up to C = 192
(``MAX_FUSED_BWD_DIM``, the TPU's VMEM); the port's all-token kernels have
no such limit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pregen_pde_tpu_torch.kernels import build as _build
from pregen_pde_tpu_torch.ops.window_attention import HEAD_DIMS, MAX_SMEM

__all__ = ["LIB_NAME", "MAX_FUSED_DIM", "fused_swin_block", "swin_block_plain",
           "swin_block_bwd_plain", "pack_heads", "launches", "bwd_launches", "reset_launches",
           "KERNELS_PER_CALL", "bwd_kernels_per_call", "COTANGENTS"]

LIB_NAME = "swin_block"
# the JAX package's gate (`swin_block.py:62`): wider stages take the unfused
# layer. Carried over as it is; a later change sets it from measurements on the card.
MAX_FUSED_DIM = 384
KERNELS_PER_CALL = 7
# the backward's weight gradients reduce over the B·H·W tokens in split-K
# partials of this many rows (16,384 tokens at scOT-B stage 0, batch 16)
SPLIT_ROWS = 512


def bwd_kernels_per_call(tokens: int) -> int:
    """Backward kernels enqueued a call on B·H·W ``tokens``: the forward's
    first 6 recomputed, 28 of the backward proper, and, when the tokens
    exceed SPLIT_ROWS, the 4 sums of the weight gradients' split-K
    partials."""
    return 38 if tokens > SPLIT_ROWS else 34
# the names of the 19 operands' cotangents, in operand order
COTANGENTS = ("dx dbias dscale dwq dbq dwk dwv dbv dwp dbp dln1w dln1b "
              "dw1 db1 dw2 db2 dln2w dln2b ddp").split()

launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME)
    f = lib.swin_block_fwd
    f.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p,
                                                                 ctypes.POINTER(ctypes.c_int)])
    f.restype = ctypes.c_int
    f = lib.swin_block_bwd
    f.argtypes = ([ctypes.c_void_p] * 34 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p,
                                                                 ctypes.POINTER(ctypes.c_int)])
    f.restype = ctypes.c_int
    f = lib.swin_block_bwd_workspace
    f.argtypes = [ctypes.c_int] * 8
    f.restype = ctypes.c_longlong
    return lib


def pack_heads(wq, wk, wv, wproj, num_heads: int):
    """(C, C) dense kernels (in, out) -> per-head packs: q/k/v as (h, C, hd)
    column splits, proj as (h, hd, C) row splits."""
    c = wq.shape[0]
    hd = c // num_heads
    col = lambda w: w.reshape(c, num_heads, hd).permute(1, 0, 2)
    return col(wq), col(wk), col(wv), wproj.reshape(num_heads, hd, c)


def _ln_fwd(t, eps):
    """(normalised t, rstd) with var = E[t²] − mean², as the JAX block."""
    mean = t.mean(-1, keepdim=True)
    var = (t * t).mean(-1, keepdim=True) - mean * mean
    r = torch.rsqrt(var + eps)
    return (t - mean) * r, r


def _layer_norm(t, w_aff, b_aff, eps):
    """Per-sample (B, C) affine over (B, windows, n, C)."""
    return _ln_fwd(t, eps)[0] * w_aff[:, None, None] + b_aff[:, None, None]


def swin_block_plain(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                     ln2w, ln2b, dp, num_heads: int, window: int, eps: float):
    """The block as eager torch ops on the packed operands (``_ref_impl``)."""
    b, hh, ww, c = x.shape
    ws = window
    n = ws * ws
    nwh, nww = hh // ws, ww // ws
    nw = bias.shape[0]
    xt = x.reshape(b, nwh, ws, nww, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nwh * nww, n, c)
    q = torch.einsum("bwnc,hcd->bwhnd", xt, wq) + bq[None, None]
    k = torch.einsum("bwnc,hcd->bwhnd", xt, wk)
    v = torch.einsum("bwnc,hcd->bwhnd", xt, wv) + bv[None, None]
    qn = q / (torch.sqrt((q * q).sum(-1, keepdim=True)) + 1e-6)
    kn = k / (torch.sqrt((k * k).sum(-1, keepdim=True)) + 1e-6)
    logits = torch.einsum("bwhnd,bwhmd->bwhnm", qn, kn) * scale[None, None, :, None, None]
    # bias rows: per window when nw > 1 (shift mask), shared otherwise
    logits = logits + (bias[None] if nw > 1 else bias[None, 0][:, None])
    o = torch.einsum("bwhnm,bwhmd->bwhnd", torch.softmax(logits, dim=-1), v)
    attn = torch.einsum("bwhnd,hdc->bwnc", o, wp) + bp[0]
    x2 = xt + dp[:, 0, None, None, None] * _layer_norm(attn, ln1w, ln1b, eps)
    hid = F.gelu(torch.einsum("bwnc,cf->bwnf", x2, w1) + b1[0], approximate="tanh")
    m = torch.einsum("bwnf,fc->bwnc", hid, w2) + b2[0]
    y = x2 + dp[:, 1, None, None, None] * _layer_norm(m, ln2w, ln2b, eps)
    return y.reshape(b, nwh, nww, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c)


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


def swin_block_bwd_plain(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                         ln2w, ln2b, dp, dy, num_heads: int, window: int, eps: float):
    """The 19 cotangents of ``swin_block_plain`` for the output gradient
    ``dy``: the JAX ``_bwd_kernel`` math as eager torch ops over all windows
    at once, in the operands' packed layouts (the per-sample LN affines
    summed over windows, ``ddp`` (B, 2), ``dbias`` float32 (nw, h, n, n):
    each window's block summed over images, or with nw = 1 every window of
    every image in the one block)."""
    b, hh, ww, c = x.shape
    ws = window
    n = ws * ws
    nwh, nww = hh // ws, ww // ws
    nw = bias.shape[0]
    win = lambda t: t.reshape(b, nwh, ws, nww, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(
        b, nwh * nww, n, -1)
    xt, dyt = win(x), win(dy)
    per_b = lambda t: t[:, None, None]  # (B, ·) over (B, windows, n, ·)
    q = torch.einsum("bwnc,hcd->bwhnd", xt, wq) + bq[None, None]
    k = torch.einsum("bwnc,hcd->bwhnd", xt, wk)
    v = torch.einsum("bwnc,hcd->bwhnd", xt, wv) + bv[None, None]
    qnorm = torch.sqrt((q * q).sum(-1, keepdim=True))
    knorm = torch.sqrt((k * k).sum(-1, keepdim=True))
    qn, kn = q / (qnorm + 1e-6), k / (knorm + 1e-6)
    s_pre = torch.einsum("bwhnd,bwhmd->bwhnm", qn, kn)
    sc = scale[None, None, :, None, None]
    p = torch.softmax(s_pre * sc + (bias[None] if nw > 1 else bias[None, 0][:, None]), dim=-1)
    o = torch.einsum("bwhnm,bwhmd->bwhnd", p, v)
    ahat, r1 = _ln_fwd(torch.einsum("bwhnd,hdc->bwnc", o, wp) + bp[0], eps)
    a_aff = ahat * per_b(ln1w) + per_b(ln1b)
    d1, d2 = dp[:, 0, None, None, None], dp[:, 1, None, None, None]
    x2 = xt + d1 * a_aff
    h = torch.einsum("bwnc,cf->bwnf", x2, w1) + b1[0]
    gl = F.gelu(h, approximate="tanh")
    mhat, r2 = _ln_fwd(torch.einsum("bwnf,fc->bwnc", gl, w2) + b2[0], eps)
    m_aff = mhat * per_b(ln2w) + per_b(ln2b)

    dmm = d2 * dyt
    dln2w, dln2b = (dmm * mhat).sum((1, 2)), dmm.sum((1, 2))
    dd2 = (dyt * m_aff).sum((1, 2, 3))
    dm = _ln_bwd(dmm * per_b(ln2w), mhat, r2)
    dw2, db2 = torch.einsum("bwnf,bwnc->fc", gl, dm), dm.sum((0, 1, 2))
    dh = torch.einsum("bwnc,fc->bwnf", dm, w2) * _gelu_tanh_grad(h)
    dx2 = dyt + torch.einsum("bwnf,cf->bwnc", dh, w1)
    dw1, db1 = torch.einsum("bwnc,bwnf->cf", x2, dh), dh.sum((0, 1, 2))
    da = d1 * dx2
    dd1 = (dx2 * a_aff).sum((1, 2, 3))
    dln1w, dln1b = (da * ahat).sum((1, 2)), da.sum((1, 2))
    dattn = _ln_bwd(da * per_b(ln1w), ahat, r1)
    dbp = dattn.sum((0, 1, 2))
    do = torch.einsum("bwnc,hdc->bwhnd", dattn, wp)
    dwp = torch.einsum("bwhnd,bwnc->hdc", o, dattn)
    dpm = torch.einsum("bwhnd,bwhmd->bwhnm", do, v)
    dv = torch.einsum("bwhnm,bwhnd->bwhmd", p, do)
    ds = p * (dpm - (p * dpm).sum(-1, keepdim=True))
    dbias = (ds.sum(0) if nw > 1 else ds.sum((0, 1))[None]).to(torch.float32)
    dscale = (ds * s_pre).sum((0, 1, 3, 4))
    dq = _cosine_norm_bwd(torch.einsum("bwhnm,bwhmd->bwhnd", ds, kn) * sc, q, qnorm)
    dk = _cosine_norm_bwd(torch.einsum("bwhnm,bwhnd->bwhmd", ds, qn) * sc, k, knorm)
    dxt = dx2 + sum(torch.einsum("bwhnd,hcd->bwnc", g, w) for g, w in ((dq, wq), (dk, wk), (dv, wv)))
    wgrad = lambda g: torch.einsum("bwnc,bwhnd->hcd", xt, g)
    bgrad = lambda g: g.sum((0, 1, 3))[:, None]
    dx = dxt.reshape(b, nwh, nww, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c)
    return (dx, dbias, dscale, wgrad(dq), bgrad(dq), wgrad(dk), wgrad(dv), bgrad(dv), dwp,
            dbp[None], dln1w, dln1b, dw1, db1[None], dw2, db2[None], dln2w, dln2b,
            torch.stack([dd1, dd2], dim=1))


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


def _kernel_operands(args, num_heads):
    """The C entry points' float32 operands: the per-head packs joined into
    one (C, 3C) qkv weight and a (3C,) bias with a zero key block."""
    x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, dp = args
    B, H, W, C = x.shape
    hd = C // num_heads
    n = bias.shape[-1]
    if hd not in HEAD_DIMS or n > 1024 or 8 * n * hd + 8 * n + 128 > MAX_SMEM:
        raise ValueError(f"the K3 kernels take hd in {HEAD_DIMS} and n <= 1024; got hd = "
                         f"{hd}, n = {n}")
    f32 = lambda t: t.to(torch.float32).contiguous()
    dense = lambda w: w.permute(1, 0, 2).reshape(C, C)  # (h, C, hd) -> (C, C)
    wqkv = f32(torch.cat([dense(wq), dense(wk), dense(wv)], dim=1))
    bqkv = f32(torch.cat([bq.reshape(C), torch.zeros_like(bq.reshape(C)), bv.reshape(C)]))
    Fh = w1.shape[1]
    return [f32(t) for t in (x, bias, scale.reshape(num_heads))] + [wqkv, bqkv] + [
        f32(t) for t in (wp.reshape(C, C), bp.reshape(C), ln1w, ln1b, w1, b1.reshape(Fh), w2,
                         b2.reshape(C), ln2w, ln2b, dp)]


def _forward_kernel(args, num_heads, window, eps):
    global launches
    x, bias = args[0], args[1]
    B, H, W, C = x.shape
    dev = x.device
    ops = _kernel_operands(args, num_heads)
    Fh = args[12].shape[1]
    M = B * H * W
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    scratch = [empty(M, 3 * C), empty(M, C), empty(M, C), empty(M, C), empty(M, Fh)]
    y = empty(B, H, W, C)
    count = ctypes.c_int(0)
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().swin_block_fwd(*(t.data_ptr() for t in ops + scratch), y.data_ptr(), B, H, W,
                                   C, num_heads, window, bias.shape[0], Fh, float(eps), st,
                                   ctypes.byref(count))
    # the scratch may be freed while the kernels are queued: the caching
    # allocator reuses it only in this stream's order
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} failed with CUDA error {rc}")
    launches += count.value
    return y


def _backward_kernel(args, dy, num_heads, window, eps):
    global bwd_launches
    x, bias = args[0], args[1]
    B, H, W, C = x.shape
    dev = x.device
    ops = _kernel_operands(args, num_heads)
    ops.insert(1, dy.to(torch.float32).contiguous())
    Fh = args[12].shape[1]
    nw, hd, n = bias.shape[0], C // num_heads, window * window
    splits = -(-(B * H * W) // SPLIT_ROWS)
    lib = _lib()
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    outs = [empty(B, H, W, C), empty(nw, num_heads, n, n), empty(num_heads), empty(C, 3 * C),
            empty(3 * C), empty(C, C), empty(C), empty(C, Fh), empty(Fh), empty(Fh, C), empty(C),
            empty(B, C), empty(B, C), empty(B, C), empty(B, C), empty(B, 2)]
    work = empty(lib.swin_block_bwd_workspace(B, H, W, C, num_heads, window, Fh, splits))
    count = ctypes.c_int(0)
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swin_block_bwd(*(t.data_ptr() for t in ops + outs + [work]), B, H, W, C,
                                num_heads, window, nw, Fh, splits, float(eps), st,
                                ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} backward failed with CUDA error {rc}")
    bwd_launches += count.value
    (dx, dbias, dscale, dwqkv, dbqkv, dwp, dbp, dw1, db1, dw2, db2,
     dln1w, dln1b, dln2w, dln2b, ddp) = outs
    packs = [dwqkv[:, i * C:(i + 1) * C].reshape(C, num_heads, hd).permute(1, 0, 2)
             for i in range(3)]
    dbq, dbv = (dbqkv[i * C:(i + 1) * C].reshape(num_heads, 1, hd) for i in (0, 2))
    return (dx, dbias, dscale, packs[0], dbq, packs[1], packs[2], dbv,
            dwp.reshape(num_heads, hd, C), dbp[None], dln1w, dln1b, dw1, db1[None], dw2,
            db2[None], dln2w, dln2b, ddp)


class _SwinBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                ln2w, ln2b, dp, num_heads, window, eps):
        args = (x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w,
                ln2b, dp)
        ctx.static = (num_heads, window, eps)
        ctx.save_for_backward(*args)
        if x.device.type == "cpu":
            return swin_block_plain(*args, num_heads, window, eps)
        return _forward_kernel(args, num_heads, window, eps).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        args = ctx.saved_tensors
        if dy.device.type == "cpu":
            grads = swin_block_bwd_plain(*args, dy, *ctx.static)
        else:
            grads = _backward_kernel(args, dy, *ctx.static)
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None, None, None)


def fused_swin_block(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                     ln2w, ln2b, dp, num_heads: int, window: int, eps: float):
    """One Swin-V2 post-norm block on a (B, H, W, C) token grid.

    x        : (B, H, W, C), already rolled when the layer shifts
    bias     : (nw, h, n, n) additive logits (16σ(CPB) + shift mask); nw =
               windows per image, or 1 when shared
    scale    : (h,) exp-clamped per-head logit scale
    wq/wk/wv : (h, C, hd) per-head column packs; bq/bv: (h, 1, hd)
    wp       : (h, hd, C) per-head row pack of proj; bp: (1, C)
    w1/b1/w2/b2 : MLP (C, F)/(1, F)/(F, C)/(1, C)
    ln1w/ln1b/ln2w/ln2b : (B, C) per-sample CondLN affines
    dp       : (B, 2) drop-path keep multipliers for the two residual adds
    """
    _check_shapes(x, bias, num_heads, window)
    return _SwinBlock.apply(x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2,
                            ln2w, ln2b, dp, num_heads, window, eps)
