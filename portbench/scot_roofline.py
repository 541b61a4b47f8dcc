"""The work of scOT's training step, counted from the configuration layer
by layer, for the ``scot_b.train`` cell's per-layer metrics. Peaks and
``bound_seconds`` are ``roofline``'s (165 TFLOP/s, 3.35 TB/s).

- ``forward_flop``: the products of one forward at batch B: every linear
  map and convolution (2·M·K·N), and the attention's two products per
  window and head (2·n²·hd each), as ``torch.utils.flop_counter`` counts
  the plain route; elementwise work is not counted. The CPB MLP and the
  time-conditioning maps are counted once a step. A training step is
  three forwards' worth (``train_flop_per_sample``): the backward's
  activation and weight gradients are two more.
- K3, the whole Swin layer (stages with C ≤ 384): forward FLOP the four
  C×C maps, the MLP and the attention's two products, 2·M·C·(4C + 2F) +
  4·M·n·C; bytes x in and y out, the weights, the bias and the per-sample
  affines, once. Backward FLOP twice the forward's products plus the
  attention's five (P again, dv, dp, dq, dk), 4·M·C·(4C + 2F) + 10·M·n·C;
  bytes x, dy in and dx out, the weights in and their gradients out, the
  bias in and out, what the forward saved. (``chip_smoke.py``'s model of
  the same calls.)
- K4, the window attention of the wider stages: forward 4·nb·h·n²·hd FLOP,
  q, k, v, out and the bias; backward 10·nb·h·n²·hd, q, k, v, o, do in and
  dq, dk, dv out, the bias in and dbias out, the log-sum-exps.
"""

from __future__ import annotations

from portbench import roofline
from portbench.reference import scot as ref

MAX_FUSED_DIM = 384  # the port's gate between K3 and the unfused layer (K4)
CPB_HIDDEN = 512


def _stage_shapes(cfg: dict, batch: int, s: dict, shift: int) -> dict:
    g, C, ws = s["grid"], s["dim"], s["window"]
    n = ws * ws
    windows = (g // ws) ** 2
    return {"B": batch, "M": batch * g * g, "C": C, "h": s["heads"], "n": n,
            "F": int(C * cfg["mlp_ratio"]), "nb": batch * windows,
            "bias": (windows if shift else 1) * s["heads"] * n * n}


def k3_forward(x: dict) -> tuple[float, float]:
    M, C, F, n, B = x["M"], x["C"], x["F"], x["n"], x["B"]
    flop = 2.0 * M * C * (4 * C + 2 * F) + 4.0 * M * n * C
    nbytes = 4.0 * (2 * M * C + 4 * C * C + 2 * C * F + 5 * C + F + x["bias"] + 4 * B * C)
    return flop, nbytes


def k3_backward(x: dict) -> tuple[float, float]:
    M, C, F, n, B = x["M"], x["C"], x["F"], x["n"], x["B"]
    flop = 4.0 * M * C * (4 * C + 2 * F) + 10.0 * M * n * C
    nbytes = 4.0 * (3 * M * C + 2 * (4 * C * C + 2 * C * F + 5 * C + F + x["bias"])
                    + 8 * B * C + 4 * B + M * (7 * C + F + 2) + x["nb"] * x["h"] * n)
    return flop, nbytes


def k4_forward(x: dict) -> tuple[float, float]:
    q = x["M"] * x["C"]  # nb·h·n·hd
    flop = 4.0 * x["M"] * x["n"] * x["C"]
    return flop, 4.0 * (4 * q + x["bias"])


def k4_backward(x: dict) -> tuple[float, float]:
    q = x["M"] * x["C"]
    flop = 10.0 * x["M"] * x["n"] * x["C"]
    return flop, 4.0 * (8 * q + 2 * x["bias"] + x["nb"] * x["h"] * x["n"])


def kernel_calls(cfg: dict, batch: int) -> dict:
    """{"k3": [...], "k4": [...]}: (FLOP, bytes) of each call a training step
    makes, forward and backward, one pair a Swin layer."""
    st = ref.stages(cfg)
    out: dict = {"k3": [], "k4": []}
    for _, i, shift, _ in ref.swin_layers(cfg):
        x = _stage_shapes(cfg, batch, st[i], shift)
        if x["C"] <= MAX_FUSED_DIM:
            out["k3"] += [k3_forward(x), k3_backward(x)]
        else:
            out["k4"] += [k4_forward(x), k4_backward(x)]
    return out


def step_bound_seconds(cfg: dict, batch: int) -> dict:
    """{"k3": s, "k4": s}: the sum over the step's calls of each call's
    least time on the card."""
    return {k: sum(roofline.bound_seconds(f, b) for f, b in calls)
            for k, calls in kernel_calls(cfg, batch).items()}


def _linear(rows: int, i: int, o: int) -> float:
    return 2.0 * rows * i * o


def _norm(batch: int, dim: int) -> float:
    return 2 * _linear(batch, 1, dim)  # the time maps to scale and shift


def swin_layer_flop(cfg: dict, batch: int, s: dict) -> float:
    """One Swin layer's forward products, the CPB MLP included."""
    x = _stage_shapes(cfg, batch, s, 0)
    M, C, F, n, h = x["M"], x["C"], x["F"], x["n"], x["h"]
    ws = s["window"]
    table = (2 * ws - 1) ** 2
    cpb = _linear(table, 2, CPB_HIDDEN) + _linear(table, CPB_HIDDEN, h)
    return (4 * _linear(M, C, C) + _linear(M, C, F) + _linear(M, F, C) + 4.0 * M * n * C
            + cpb + 2 * _norm(batch, C))


def forward_flop(cfg: dict, batch: int) -> float:
    """One forward's products at ``batch``, layer by layer."""
    st = ref.stages(cfg)
    p, E = cfg["patch_size"], cfg["embed_dim"]
    g0 = st[0]["grid"]
    flop = _linear(batch * g0 * g0, cfg["in_channels"] * p * p, E) + _norm(batch, E)
    for i, s in enumerate(st):
        M, C = batch * s["grid"] ** 2, s["dim"]
        flop += 2 * s["depth"] * swin_layer_flop(cfg, batch, s)  # encoder and decoder
        if i < len(st) - 1:
            flop += _linear(M // 4, 4 * C, 2 * C) + _norm(batch, 2 * C)
        if i > 0:
            flop += (_linear(M, C, 2 * C) + _linear(4 * M, C // 2, C // 2)
                     + _norm(batch, C // 2))
        flop += s["skips"] * (_linear(M, 49, C) + _linear(M, C, 4 * C)
                              + _linear(M, 4 * C, C) + _norm(batch, C))
    out = cfg["out_channels"]
    return (flop + _linear(batch * g0 * g0, E, out * p * p)
            + _linear(batch * cfg["image_size"] ** 2, out * 25, out))


def train_flop_per_sample(cfg: dict, batch: int) -> float:
    return 3.0 * forward_flop(cfg, batch) / batch


# K3's and K4's kernels as the card's trace names them (NVIDIA H100, torch
# 2.11): each lives in an anonymous namespace of its library
# (csrc/swin_block.cu, csrc/window_attention.cu); a template's name starts
# with its return type, a plain function's does not
K3_KERNELS = ("void (anonymous namespace)::gemm_kernel<", "(anonymous namespace)::ln_bwd_rows_kernel(",
              "(anonymous namespace)::wgrad_kernel(", "void (anonymous namespace)::attn_fwd_kernel<",
              "void (anonymous namespace)::attn_bwd_kernel<", "(anonymous namespace)::reduce_kernel(")
K4_KERNELS = ("void (anonymous namespace)::attn_fwd_small_kernel<",
              "void (anonymous namespace)::attn_fwd_wide_kernel<",
              "void (anonymous namespace)::attn_bwd_small_kernel<",
              "void (anonymous namespace)::attn_bwd_wide_kernel<",
              "(anonymous namespace)::dbias_sum_kernel(")


def kernel_share(ctx: dict, names: tuple, bound_key: str) -> float | None:
    """A kernel's share of its roofline over a traced window (%): the sum of
    the batches' bounds (``bound_key`` of each batch's info, the step's
    calls) over the device time of the events named ``names`` inside the
    batch spans. Batches with none of those events are left out."""
    from portbench import trace

    spent = bound = 0.0
    for (lo, hi), info in zip(ctx["spans"], ctx["batches"]):
        if bound_key not in info:
            continue
        t = sum(e - s for name, s, e in ctx["dev"]
                if s >= lo and e <= hi and name.startswith(names))
        if t > 0:
            spent += t
            bound += info[bound_key]
    return 100.0 * bound / spent if spent > 0 else None
