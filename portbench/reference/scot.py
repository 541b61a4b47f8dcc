"""Plain reference of the scOT training cell: the scOT forward written out on
a dict of tensors, the sample assembly from the contract, the relative-L1
loss with autograd, and optax's global-norm clip followed by
``torch.optim.AdamW`` at the cosine rate, in plain ``torch``.

Written from the published descriptions, not copied from the port: Swin-V2
(Liu et al. 2022, arXiv:2111.09883) and scOT/Poseidon (Herde et al. 2024,
arXiv:2405.19101, Sections 2-3 and Appendix C):

- patch embedding: a p×p convolution of stride p, then the time-conditioned
  LayerNorm, whose scale and shift are affine maps of the lead time;
- Swin-V2 layers, post-norm: the residual adds the normed attention output
  and then the normed MLP output; scaled cosine attention, with
  cos(q, k) times a per-head logit scale clamped at log 100, plus 16·σ of a
  continuous position bias (a two-layer ReLU MLP over log-spaced relative
  coordinates); windows of w×w tokens, w clamped to the stage's grid,
  every second layer cyclically shifted by w/2 (with the −100 mask
  between regions) when the grid is wider than the window; per-sample
  stochastic depth at rates ``linspace(0, rate, 2·Σdepths)``;
- a U-shaped encoder and decoder: patch merging (2×2 neighbours
  concatenated, a bias-free 4C → 2C map, the conditioned norm) and patch
  unmerging (a bias-free C → 2C map, the pixel shuffle, the conditioned
  norm, a bias-free C/2 mix); ConvNeXt blocks on the skips (7×7 depthwise
  conv, conditioned norm, 4× MLP, layer scale); recovery by a transposed
  p×p convolution and a bias-free 5×5 convolution.

Departures from those descriptions, each shared with the program (the
check holds the program to this arithmetic):

- GELU in its tanh form (flax's default, which the JAX package uses);
  Poseidon's configuration names the erf form;
- the cosine's norms are ‖x‖ + 1e-6 (the JAX package's), not
  ``max(‖x‖, 1e-12)``;
- the stage residual: the input of each downsample is the stage's output
  plus its input; decoder stages after the first add the encoder's skip;
  a decoder stage's execution-order block d shifts as block depth−1−d;
- the decoder's stochastic-depth rates are the second half of the
  linspace, stage by stage from the deepest;
- the lead time is (t2 − t1)/19 and a constant input channel besides.

The parameters take the port's names (its modules carry the flax names),
so one state dict drawn from a seed loads into both. Drop-path masks are
drawn, two a layer with a non-zero rate in execution order, from a
``torch.Generator`` on the tensors' device, the same call the program
makes. Imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TIME_NORMALIZER = 19.0
LN_EPS = 1e-5
COSINE_EPS = 1e-6
MASK_VALUE = -100.0
ADAM = {"betas": (0.9, 0.999), "eps": 1e-8}


# -- shapes ------------------------------------------------------------------


def stages(cfg: dict) -> list[dict]:
    """Each stage's grid, width, heads, window and depth."""
    grid = cfg["image_size"] // cfg["patch_size"]
    out = []
    for i, depth in enumerate(cfg["depths"]):
        g = grid // 2**i
        out.append({"grid": g, "dim": cfg["embed_dim"] * 2**i, "heads": cfg["num_heads"][i],
                    "window": min(cfg["window_size"], g), "depth": depth,
                    "skips": cfg["skip_connections"][i]})
    return out


def shift_of(stage: dict, odd: bool) -> int:
    return stage["window"] // 2 if odd and stage["grid"] > stage["window"] else 0


def swin_layers(cfg: dict) -> list[tuple[str, int, int, float]]:
    """(name, stage, shift, drop-path rate) of every Swin layer, in
    execution order: the encoder, then the decoder from the deepest stage."""
    st = stages(cfg)
    total = 2 * sum(cfg["depths"])
    rates = np.linspace(0.0, cfg["drop_path_rate"], total) if total else np.zeros(0)
    half = total // 2
    enc, dec = [], []
    for i, s in enumerate(st):
        off, lo = sum(cfg["depths"][:i]), sum(cfg["depths"][i + 1:])
        for d in range(s["depth"]):
            enc.append((f"enc_{i}_blk_{d}", i, shift_of(s, d % 2 == 1), float(rates[off + d])))
            dec.append((f"dec_{i}_blk_{d}", i, shift_of(s, (s["depth"] - 1 - d) % 2 == 1),
                        float(rates[half + lo + d])))
    order = {i: [r for r in dec if r[1] == i] for i in range(len(st))}
    return enc + [r for i in reversed(range(len(st))) for r in order[i]]


def param_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter under the port's names; a linear
    map's weight is (out, in), a convolution's OIHW, the transposed one's
    (in, out, kh, kw)."""
    p, E = cfg["patch_size"], cfg["embed_dim"]
    out: list[tuple[str, tuple]] = []

    def lin(name, i, o, bias=True):
        out.append((f"{name}.weight", (o, i)))
        if bias:
            out.append((f"{name}.bias", (o,)))

    def norm(name, dim):
        for part in ("time_scale", "time_bias"):
            lin(f"{name}.{part}", 1, dim)

    def layer(name, s):
        C, h = s["dim"], s["heads"]
        hidden = int(C * cfg["mlp_ratio"])
        a = f"{name}.attention"
        out.append((f"{a}.logit_scale", (h, 1, 1)))
        lin(f"{a}.query", C, C)
        lin(f"{a}.key", C, C, bias=False)
        lin(f"{a}.value", C, C)
        lin(f"{a}.cpb_mlp1", 2, 512)
        lin(f"{a}.cpb_mlp2", 512, h, bias=False)
        lin(f"{a}.proj", C, C)
        norm(f"{name}.norm1", C)
        lin(f"{name}.mlp1", C, hidden)
        lin(f"{name}.mlp2", hidden, C)
        norm(f"{name}.norm2", C)

    out.append(("patch_embed.weight", (E, cfg["in_channels"], p, p)))
    out.append(("patch_embed.bias", (E,)))
    norm("embed_norm", E)
    st = stages(cfg)
    L = len(st)
    for i, s in enumerate(st):
        for d in range(s["depth"]):
            layer(f"enc_{i}_blk_{d}", s)
        if i < L - 1:
            lin(f"enc_{i}_merge.reduction", 4 * s["dim"], 2 * s["dim"], bias=False)
            norm(f"enc_{i}_merge.norm", 2 * s["dim"])
    for i, s in enumerate(st):
        C = s["dim"]
        for d in range(s["skips"]):
            b = f"skip_{i}_blk_{d}"
            out.append((f"{b}.layer_scale", (C,)))
            out.append((f"{b}.dwconv.weight", (C, 1, 7, 7)))
            out.append((f"{b}.dwconv.bias", (C,)))
            norm(f"{b}.norm", C)
            lin(f"{b}.pwconv1", C, 4 * C)
            lin(f"{b}.pwconv2", 4 * C, C)
    for i in reversed(range(L)):
        s = st[i]
        for d in range(s["depth"]):
            layer(f"dec_{i}_blk_{d}", s)
        if i > 0:
            C = s["dim"]
            lin(f"dec_{i}_unmerge.upsample", C, 2 * C, bias=False)
            norm(f"dec_{i}_unmerge.norm", C // 2)
            lin(f"dec_{i}_unmerge.mixup", C // 2, C // 2, bias=False)
    out.append(("patch_recovery.weight", (E, cfg["out_channels"], p, p)))
    out.append(("patch_recovery.bias", (cfg["out_channels"],)))
    out.append(("recovery_mixup.weight", (cfg["out_channels"], cfg["out_channels"], 5, 5)))
    return out


# -- the forward ---------------------------------------------------------------


def _linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _norm(p: dict, name: str, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis whose scale and shift are affine maps
    of the lead time, per sample."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    t = time.reshape(-1, 1).to(x.dtype)
    scale = _linear(p, f"{name}.time_scale", t)
    shift = _linear(p, f"{name}.time_bias", t)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale.reshape(shape) + shift.reshape(shape)


def _nhwc_conv(x: torch.Tensor, conv) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def log_cpb_coords(ws: int, device) -> torch.Tensor:
    """((2w−1)², 2) log-spaced relative coordinates, in float32 as Swin-V2
    builds them: offsets over w−1 (1 at w = 1), ×8, sign·log2(1+|x|)/3."""
    c = torch.arange(-(ws - 1), ws, device=device).float()
    t = torch.stack(torch.meshgrid(c, c, indexing="ij"), -1) / max(ws - 1, 1) * 8.0
    return (torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)).reshape(-1, 2)


def relative_index(ws: int, device) -> torch.Tensor:
    """(n, n) flat index into the ((2w−1)², ·) table of each token pair."""
    r = torch.arange(ws, device=device)
    rows, cols = torch.meshgrid(r, r, indexing="ij")
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    dr = rows[:, None] - rows[None, :] + ws - 1
    dc = cols[:, None] - cols[None, :] + ws - 1
    return dr * (2 * ws - 1) + dc


def shift_mask(grid: int, ws: int, shift: int, device) -> torch.Tensor:
    """(windows, n, n) additive mask of a shifted layer: −100 between
    tokens of different regions of the rolled grid."""
    region = torch.zeros(grid, grid, device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    k = 0
    for hs in cuts:
        for wsl in cuts:
            region[hs, wsl] = k
            k += 1
    win = region.reshape(grid // ws, ws, grid // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def _windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _unwindows(x: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _attention(p: dict, a: str, x: torch.Tensor, heads: int, ws: int,
               mask: torch.Tensor | None) -> torch.Tensor:
    """Scaled cosine attention in windows: x (windows·B, n, C)."""
    nb, n, c = x.shape
    split = lambda t: t.reshape(nb, n, heads, c // heads).transpose(1, 2)
    q, k, v = (split(_linear(p, f"{a}.{m}", x)) for m in ("query", "key", "value"))
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + COSINE_EPS)
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + COSINE_EPS)
    scale = torch.exp(torch.clamp(p[f"{a}.logit_scale"], max=math.log(100.0)))
    logits = (q @ k.transpose(-2, -1)) * scale
    table = _linear(p, f"{a}.cpb_mlp2", F.relu(_linear(p, f"{a}.cpb_mlp1",
                                                        log_cpb_coords(ws, x.device).to(x.dtype))))
    bias = table[relative_index(ws, x.device)].permute(2, 0, 1)  # (h, n, n)
    logits = logits + 16.0 * torch.sigmoid(bias)
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(nb // nw, nw, heads, n, n) + mask[None, :, None]).reshape(
            nb, heads, n, n)
    out = torch.softmax(logits, dim=-1) @ v
    return _linear(p, f"{a}.proj", out.transpose(1, 2).reshape(nb, n, c))


class DropPath:
    """Per-sample stochastic depth: a Bernoulli(1 − rate) draw per sample
    from ``generator``, x·draw/(1 − rate); identity at rate 0 (no draw)."""

    def __init__(self, generator: torch.Generator | None):
        self.generator = generator
        self.draws: list[torch.Tensor] = []

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0 or self.generator is None:
            return x
        keep = 1.0 - rate
        draw = torch.bernoulli(torch.full((x.shape[0],), keep, device=x.device),
                               generator=self.generator)
        self.draws.append(draw)
        return x * (draw / keep).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def _swin_layer(p: dict, name: str, s: dict, shift: int, rate: float, x: torch.Tensor,
                time: torch.Tensor, drop: DropPath) -> torch.Tensor:
    b, h, w, c = x.shape
    ws = s["window"]
    y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    mask = shift_mask(h, ws, shift, x.device).to(x.dtype) if shift else None
    y = _unwindows(_attention(p, f"{name}.attention", _windows(y, ws), s["heads"], ws, mask),
                   ws, b, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + drop(_norm(p, f"{name}.norm1", y, time), rate)
    y = _linear(p, f"{name}.mlp2", _gelu(_linear(p, f"{name}.mlp1", x)))
    return x + drop(_norm(p, f"{name}.norm2", y, time), rate)


def _merge(p: dict, name: str, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return _norm(p, f"{name}.norm", _linear(p, f"{name}.reduction", x), time)


def _unmerge(p: dict, name: str, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = _linear(p, f"{name}.upsample", x).reshape(b, h, w, 2, 2, c // 2)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c // 2)
    return _linear(p, f"{name}.mixup", _norm(p, f"{name}.norm", x, time))


def _convnext(p: dict, name: str, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    C = x.shape[-1]
    y = _nhwc_conv(x, lambda t: F.conv2d(t, p[f"{name}.dwconv.weight"], p[f"{name}.dwconv.bias"],
                                         padding=3, groups=C))
    y = _linear(p, f"{name}.pwconv2", _gelu(_linear(p, f"{name}.pwconv1",
                                                    _norm(p, f"{name}.norm", y, time))))
    return x + p[f"{name}.layer_scale"] * y


def forward(p: dict, cfg: dict, x: torch.Tensor, time: torch.Tensor,
            drop: DropPath | None = None) -> torch.Tensor:
    """(B, S, S, in_channels) and the lead time (B,) → (B, S, S,
    out_channels) at S = image_size. ``drop``: stochastic depth in
    training (None: inference)."""
    drop = drop or DropPath(None)
    ps = cfg["patch_size"]
    st = stages(cfg)
    L = len(st)
    layers = {name: (i, shift, rate) for name, i, shift, rate in swin_layers(cfg)}

    def run(name, x):
        i, shift, rate = layers[name]
        return _swin_layer(p, name, st[i], shift, rate, x, time, drop)

    x = _nhwc_conv(x, lambda t: F.conv2d(t, p["patch_embed.weight"], p["patch_embed.bias"],
                                         stride=ps))
    x = _norm(p, "embed_norm", x, time)
    skips = []
    for i, s in enumerate(st):
        stage_in = x
        for d in range(s["depth"]):
            x = run(f"enc_{i}_blk_{d}", x)
        skips.append(x)
        if i < L - 1:
            x = _merge(p, f"enc_{i}_merge", x + stage_in, time)
    for i, s in enumerate(st):
        for d in range(s["skips"]):
            skips[i] = _convnext(p, f"skip_{i}_blk_{d}", skips[i], time)
    x = skips[-1]
    for j, i in enumerate(reversed(range(L))):
        if j:
            x = x + skips[i]
        for d in range(st[i]["depth"]):
            x = run(f"dec_{i}_blk_{d}", x)
        if i > 0:
            x = _unmerge(p, f"dec_{i}_unmerge", x, time)
    x = _nhwc_conv(x, lambda t: F.conv_transpose2d(t, p["patch_recovery.weight"],
                                                   p["patch_recovery.bias"], stride=ps))
    return _nhwc_conv(x, lambda t: F.conv2d(t, p["recovery_mixup.weight"], padding=2))


def relative_l1(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of Σ|pred − label| / (Σ|label| + 1e-10)."""
    dims = tuple(range(1, pred.ndim))
    return ((pred - label).abs().sum(dims) / (label.abs().sum(dims) + 1e-10)).mean()


# -- the samples -----------------------------------------------------------------


def time_pairs(frames: int, transitions: str) -> list[tuple[int, int]]:
    """(t1, t2) of each sample of a trajectory: "one" is every t → t + 1."""
    if transitions != "one":
        raise ValueError(f"the reference assembles transitions 'one', not {transitions!r}")
    return [(t, t + 1) for t in range(frames - 1)]


def shard_stats(shard: np.ndarray, channels: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Mean and standard deviation of the first ``channels`` over the whole
    shard, in float64, stored as float32 (a deviation under 1e-10 as 1)."""
    x = np.asarray(shard[..., :channels], np.float64).reshape(-1, channels)
    mean = x.mean(0)
    std = np.sqrt(((x - mean) ** 2).mean(0))
    std = np.where(std < 1e-10, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)


def assemble(shard: np.ndarray, stats: tuple, pairs: list, indices, out_channels: int = 3,
             start: int = 0) -> dict:
    """The samples ``indices`` of a split that starts at trajectory
    ``start``: sample k is trajectory k // len(pairs), pair k % len(pairs).
    → {"time" (B,), "input" (B, S, S, C + 1), "label" (B, S, S, out)} float32:
    the frame at t1 with its first ``out_channels`` z-scored and the lead
    time (t2 − t1)/19 as a last channel; the z-scored frame at t2."""
    mean, std = stats
    times, inps, labs = [], [], []
    for k in indices:
        traj, (t1, t2) = start + k // len(pairs), pairs[k % len(pairs)]
        lead = np.float32((t2 - t1) / TIME_NORMALIZER)
        inp = shard[traj, t1].astype(np.float32)
        inp[..., :out_channels] = (inp[..., :out_channels] - mean) / std
        lab = (shard[traj, t2, ..., :out_channels].astype(np.float32) - mean) / std
        times.append(lead)
        inps.append(np.concatenate([inp, np.full(inp.shape[:2] + (1,), lead, np.float32)], -1))
        labs.append(lab)
    return {"time": np.stack(times), "input": np.stack(inps), "label": np.stack(labs)}


# -- training -------------------------------------------------------------------------


def cosine_rate(cfg: dict, count: int, total_steps: int) -> float:
    """optax's cosine decay from the peak rate to 0 over ``total_steps``."""
    c = min(count, total_steps)
    return cfg["learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * c / total_steps))


def replay(cfg: dict, weights: dict, batches: list, total_steps: int, drop_seed: int,
           dtype: torch.dtype = torch.float32) -> dict:
    """The training steps of ``batches`` (dicts of numpy "time", "input",
    "label") from ``weights``, one after another: the forward in
    ``dtype``, the loss in float32, autograd, optax's clip by the global
    norm, AdamW with decay on the parameters of two or more dimensions at
    the cosine rate of the step's count. Drop-path draws come from a
    generator seeded ``drop_seed`` on the weights' device.

    → "loss" (S,), each step's loss before its update; "grad" (S, P), each
    parameter's gradient norm before the clip; "moved" (S, P), each
    parameter's ‖θ − θ₀‖₂ after the step; "params", the parameters after
    the last step; P in ``param_shapes``' order."""
    names = [n for n, _ in param_shapes(cfg)]
    p = {n: weights[n].detach().to(dtype).clone().requires_grad_(True) for n in names}
    start = [p[n].detach().clone() for n in names]
    dev = start[0].device
    opt = torch.optim.AdamW(
        [{"params": [p[n] for n in names if p[n].ndim >= 2], "weight_decay": cfg["weight_decay"]},
         {"params": [p[n] for n in names if p[n].ndim < 2], "weight_decay": 0.0}],
        lr=cfg["learning_rate"], foreach=False, **ADAM)
    drop = DropPath(torch.Generator(device=dev).manual_seed(drop_seed))
    losses, grads, moved = [], [], []
    for count, batch in enumerate(batches):
        inp, time, lab = (torch.as_tensor(batch[k], device=dev) for k in ("input", "time", "label"))
        pred = forward(p, cfg, inp.to(dtype), time.to(dtype), drop)
        loss = relative_l1(pred.float(), lab)
        opt.zero_grad()
        loss.backward()
        with torch.no_grad():
            g = [p[n].grad for n in names]
            norms = torch.stack([torch.linalg.vector_norm(t) for t in g])
            total = torch.linalg.vector_norm(norms)
            if total >= cfg["grad_clip"]:
                for t in g:
                    t.mul_(cfg["grad_clip"] / total)
            for group in opt.param_groups:
                group["lr"] = cosine_rate(cfg, count, total_steps)
            opt.step()
            losses.append(float(loss))
            grads.append(norms.double().cpu().numpy())
            moved.append(torch.stack([torch.linalg.vector_norm(p[n] - s)
                                      for n, s in zip(names, start)]).double().cpu().numpy())
    return {"loss": np.array(losses), "grad": np.array(grads), "moved": np.array(moved),
            "params": {n: t.detach() for n, t in p.items()}}
