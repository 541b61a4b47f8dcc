"""Plain reference of the fixture's training cell: FNO's forward written
out on a dict of tensors, the relative-L1 loss, and ``torch.optim.AdamW``
after optax's global-norm clip, in plain ``torch``.

Written from the model's and the optimizer's published arithmetic, not
copied from the port: FNO (Li et al. 2021) with the JAX package's layout
(the [0, 1]² grid appended, the domain zero-padded at the bottom and right,
GELU between layers only, a two-layer head), flax's parameter names and
layouts; AdamW with decoupled decay on the parameters of two or more
dimensions; ``optax.clip_by_global_norm``, which scales the gradients by
``max / ‖g‖`` only when ``‖g‖ ≥ max``. Imports nothing of the port and
nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def param_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, in the model's order: the lift
    ``Dense_0``, then ``SpectralConv2d_k`` and ``Dense_{k+1}`` a layer, then
    the head ``Dense_{L+1}``, ``Dense_{L+2}``; a Dense's weight is (out, in)."""
    w, m, L = cfg["width"], cfg["modes"], cfg["n_layers"]
    dense = lambda name, i, o: [(f"{name}.weight", (o, i)), (f"{name}.bias", (o,))]
    out = dense("Dense_0", cfg["in_channels"] + 2, w)
    for k in range(L):
        out += [(f"SpectralConv2d_{k}.{part}", (w, m, m, w))
                for part in ("w_pos_re", "w_pos_im", "w_neg_re", "w_neg_im")]
        out += dense(f"Dense_{k + 1}", w, w)
    return (out + dense(f"Dense_{L + 1}", w, cfg["head_width"])
            + dense(f"Dense_{L + 2}", cfg["head_width"], cfg["out_channels"]))


def _dense(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _spectral(p: dict, k: int, modes: int, x: torch.Tensor) -> torch.Tensor:
    """rfft2, the channel mix on the lowest modes (rows 0..m1-1 by the
    positive weights, rows −m1..−1 by the last m1 rows of the negative
    ones), every other mode zero, irfft2."""
    b, h, w, _ = x.shape
    xh = torch.fft.rfft2(x, dim=(1, 2))
    m1, m2 = min(modes, h // 2), min(modes, w // 2 + 1)
    name = f"SpectralConv2d_{k}"
    pos = torch.complex(p[f"{name}.w_pos_re"], p[f"{name}.w_pos_im"])[:, :m1, :m2]
    neg = torch.complex(p[f"{name}.w_neg_re"], p[f"{name}.w_neg_im"])[:, modes - m1:, :m2]
    out = xh.new_zeros(b, h, w // 2 + 1, pos.shape[-1])
    out[:, :m1, :m2] = torch.einsum("bxyi,ixyo->bxyo", xh[:, :m1, :m2], pos)
    out[:, h - m1:, :m2] = torch.einsum("bxyi,ixyo->bxyo", xh[:, h - m1:, :m2], neg)
    return torch.fft.irfft2(out, s=(h, w), dim=(1, 2))


def forward(p: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, in_channels) → (B, H, W, out_channels)."""
    b, h, w, _ = x.shape
    axis = lambda n: torch.linspace(0.0, 1.0, n, dtype=torch.float64).to(x)
    grid = torch.stack(torch.meshgrid(axis(h), axis(w), indexing="ij"), dim=-1)
    x = _dense(p, "Dense_0", torch.cat([x, grid.expand(b, h, w, 2)], dim=-1))
    pad_h, pad_w = int(round(h * cfg["pad_frac"])), int(round(w * cfg["pad_frac"]))
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    L = cfg["n_layers"]
    for k in range(L):
        x = _spectral(p, k, cfg["modes"], x) + _dense(p, f"Dense_{k + 1}", x)
        if k < L - 1:
            x = _gelu(x)
    x = x[:, :h, :w]
    return _dense(p, f"Dense_{L + 2}", _gelu(_dense(p, f"Dense_{L + 1}", x)))


def relative_l1(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of Σ|pred − label| / (Σ|label| + 1e-10)."""
    dims = tuple(range(1, pred.ndim))
    return ((pred - label).abs().sum(dims) / (label.abs().sum(dims) + 1e-10)).mean()


def replay(cfg: dict, weights: dict, batches: list) -> dict:
    """The training steps of ``batches`` (dicts of numpy arrays "input",
    "label") from ``weights``, one after another, at a constant learning
    rate. → "loss" (S,), each step's loss before its update; "moved" (S, P),
    each parameter's ‖θ − θ₀‖₂ after the step, in ``param_shapes``' order;
    "grad0" (P,), each parameter's gradient norm at the first step, before
    the clip."""
    if cfg["schedule"] != "constant":
        raise ValueError(f"the reference replays a constant rate, not {cfg['schedule']!r}")
    names = [n for n, _ in param_shapes(cfg)]
    p = {n: weights[n].detach().clone().requires_grad_(True) for n in names}
    start = {n: t.detach().clone() for n, t in p.items()}
    opt = torch.optim.AdamW(
        [{"params": [p[n] for n in names if p[n].ndim >= 2], "weight_decay": cfg["weight_decay"]},
         {"params": [p[n] for n in names if p[n].ndim < 2], "weight_decay": 0.0}],
        lr=cfg["learning_rate"], betas=(0.9, 0.999), eps=1e-8, foreach=False)
    dev = weights[names[0]].device
    loss_s, moved, grad0 = [], [], None
    for batch in batches:
        inp, lab = (torch.as_tensor(batch[k], device=dev) for k in ("input", "label"))
        loss = relative_l1(forward(p, cfg, inp).float(), lab)
        opt.zero_grad()
        loss.backward()
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(p[n].grad) for n in names])
            if grad0 is None:
                grad0 = norms.cpu().numpy().astype(np.float64)
            total = torch.linalg.vector_norm(norms)
            if total >= cfg["grad_clip"]:
                for n in names:
                    p[n].grad.mul_(cfg["grad_clip"] / total)
        opt.step()
        loss_s.append(float(loss.detach()))
        with torch.no_grad():
            moved.append([float(torch.linalg.vector_norm(p[n] - start[n])) for n in names])
    return {"loss": np.array(loss_s), "moved": np.array(moved), "grad0": grad0}
