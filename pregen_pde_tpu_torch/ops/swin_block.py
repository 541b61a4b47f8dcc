"""Swin-V2 block forward, K3 (counterpart of ``ops/swin_block.py``).

``fused_swin_block`` runs one post-norm Swin-V2 layer on a (B, H, W, C)
token grid (already cyclically shifted when the layer shifts): per-head
q/k/v, cosine attention × logit scale + bias, the output projection, a
conditional LayerNorm with the drop-path residual, the GELU-tanh MLP, a
second conditional LayerNorm and residual. Its operands are those of the
JAX function, packed per head by ``pack_heads``.

For a CPU tensor it runs the plain version (``swin_block_plain``, the
counterpart of ``_ref_impl``); for a CUDA tensor it launches the
hand-written kernel (``csrc/swin_block.cu``, replacing the Pallas TPU kernel
``pregen_pde_tpu/ops/swin_block.py::fused_swin_block``: seven launches over
all tokens, see the source) or raises. ``launches`` counts the kernels
enqueued (7 a call). Forward only: a CUDA input that requires a gradient
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pregen_pde_tpu_torch.kernels import build as _build
from pregen_pde_tpu_torch.ops.window_attention import HEAD_DIMS, MAX_SMEM, check_no_grad

__all__ = ["LIB_NAME", "MAX_FUSED_DIM", "fused_swin_block", "swin_block_plain", "pack_heads",
           "launches", "reset_launches", "KERNELS_PER_CALL"]

LIB_NAME = "swin_block"
# the JAX package's gate (`swin_block.py:62`): wider stages take the unfused
# layer. Carried over as it is; a later change sets it from measurements on the card.
MAX_FUSED_DIM = 384
KERNELS_PER_CALL = 7

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(LIB_NAME)
    f = lib.swin_block_fwd
    f.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p,
                                                                 ctypes.POINTER(ctypes.c_int)])
    f.restype = ctypes.c_int
    return lib


def pack_heads(wq, wk, wv, wproj, num_heads: int):
    """(C, C) dense kernels (in, out) -> per-head packs: q/k/v as (h, C, hd)
    column splits, proj as (h, hd, C) row splits."""
    c = wq.shape[0]
    hd = c // num_heads
    col = lambda w: w.reshape(c, num_heads, hd).permute(1, 0, 2)
    return col(wq), col(wk), col(wv), wproj.reshape(num_heads, hd, c)


def _layer_norm(t, w_aff, b_aff, eps):
    """var = E[t²] − mean², as the JAX block; per-sample (B, C) affine over
    (B, windows, n, C)."""
    mean = t.mean(-1, keepdim=True)
    var = (t * t).mean(-1, keepdim=True) - mean * mean
    return (t - mean) * torch.rsqrt(var + eps) * w_aff[:, None, None] + b_aff[:, None, None]


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
    global launches
    args = (x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, dp)
    B, H, W, C = x.shape
    ws = window
    n = ws * ws
    hd = C // num_heads
    nwin = (H // ws) * (W // ws)
    nw = bias.shape[0]
    if H % ws or W % ws or C % num_heads:
        raise ValueError(f"x {tuple(x.shape)} must tile into {ws}x{ws} windows and "
                         f"{num_heads} heads")
    if tuple(bias.shape) != (nw, num_heads, n, n) or nw not in (1, nwin):
        raise ValueError(f"bias must be (1 or {nwin}, {num_heads}, {n}, {n}); got "
                         f"{tuple(bias.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return swin_block_plain(*args, num_heads, window, eps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_no_grad("fused_swin_block", *args)
    if hd not in HEAD_DIMS or n > 1024 or 8 * n * hd > MAX_SMEM:
        raise ValueError(f"the K3 kernel takes hd in {HEAD_DIMS} and n <= 1024; got hd = "
                         f"{hd}, n = {n}")
    f32 = lambda t: t.to(torch.float32).contiguous()
    dense = lambda w: w.permute(1, 0, 2).reshape(C, C)  # (h, C, hd) -> (C, C)
    wqkv = f32(torch.cat([dense(wq), dense(wk), dense(wv)], dim=1))
    bqkv = f32(torch.cat([bq.reshape(C), torch.zeros_like(bq.reshape(C)), bv.reshape(C)]))
    Fh = w1.shape[1]
    ops = [f32(t) for t in (x, bias, scale.reshape(num_heads))] + [wqkv, bqkv] + [
        f32(t) for t in (wp.reshape(C, C), bp.reshape(C), ln1w, ln1b, w1, b1.reshape(Fh), w2,
                         b2.reshape(C), ln2w, ln2b, dp)]
    M = B * H * W
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    scratch = [empty(M, 3 * C), empty(M, C), empty(M, C), empty(M, C), empty(M, Fh)]
    y = empty(B, H, W, C)
    count = ctypes.c_int(0)
    with torch.cuda.device(dev):
        st = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().swin_block_fwd(*(t.data_ptr() for t in ops + scratch), y.data_ptr(), B, H, W,
                                   C, num_heads, ws, nw, Fh, float(eps), st,
                                   ctypes.byref(count))
    # the scratch may be freed while the kernels are queued: the caching
    # allocator reuses it only in this stream's order
    if rc != 0:
        raise RuntimeError(f"{LIB_NAME} failed with CUDA error {rc}")
    launches += count.value
    return y.to(x.dtype)
