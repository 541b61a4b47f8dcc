"""CNO, the Convolutional Neural Operator with anti-aliased activations
(port of the JAX package's ``models/cno.py``): NHWC in and out, NCHW inside.

lift → n_layers × [n_res ResidualBlocks → (D) CNOBlock, skip saved] →
optional ViT bottleneck → n_res_neck residual neck → n_layers × [(I)
expansion CNOBlock on the skip + concat → inverse CNOBlock → (U) CNOBlock]
→ concat skip 0 → projection. Channels ``[mult/2, mult·2^i]``; filters
cutoff = size/2.0001, half-width = 0.8·size − cutoff; FILM lead-time
conditioning, identity at init.

The parameters keep flax's names, creation order and layouts, so a flax
tree maps onto the state_dict by joining its paths (``models/convert.py``):
each class is numbered per parent in the order JAX creates it
(``LiftProjectBlock_0/CNOBlock_0/Conv_0``, ``ResidualBlock_k/FILM_1/
GroupNorm_0``, ``CNOBlock_k/AntiAliasedLReLu_0/bias``, ``FILM_j/Dense_0..3``)
and the ViT's are its explicit names (``embed_norm1``, ``attn_{d}_qkv``,
``pos_embedding``, …); the norms' affines are ``scale`` and ``bias``. flax
infers the lift's input width from data and ``nn.Conv2d`` cannot, so the
model takes ``in_channels``.

The anti-aliased activation is ``ops.filtered_lrelu`` with Kaiser filters
designed on the host at construction from the same float32 taps as JAX.
The JAX package runs all of this in XLA with no Pallas kernel; the port
runs it in plain PyTorch (``F.conv2d``, ``torch.matmul``).

``norm``: "instance" is flax ``GroupNorm(group_size=1, epsilon=1e-5)``,
"layer" ``LayerNorm(reduction_axes=(-3, -2, -1))`` (statistics over C, H,
W; a per-channel affine), both with flax's variance E[x²] − E[x]² clipped
at 0; "batch" is stateless (the batch's statistics in training and
evaluation, a two-pass variance, ``bn_scale``/``bn_bias``); "none".
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pregen_pde_tpu_torch.models.fno import dense, gelu
from pregen_pde_tpu_torch.ops.bias_act import bias_act
from pregen_pde_tpu_torch.ops.filter_design import design_lowpass_filter
from pregen_pde_tpu_torch.ops.filtered_lrelu import filtered_lrelu

SQRT2 = float(np.sqrt(2))


class FlaxNorm(nn.Module):
    """flax's normalisation of ``x`` over ``axes``: the variance E[x²] −
    E[x]² clipped at 0 (``use_fast_variance``), then (x − mean) ·
    (rsqrt(var + eps) · scale) + bias, with ``scale`` and ``bias`` of shape
    (channels,) on ``channel_axis``."""

    def __init__(self, channels: int, axes: tuple, channel_axis: int, eps: float = 1e-5):
        super().__init__()
        self.axes, self.channel_axis, self.eps = axes, channel_axis, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[self.channel_axis] = -1
        mean = x.mean(self.axes, keepdim=True)
        var = torch.clamp((x * x).mean(self.axes, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.reshape(shape)
        return (x - mean) * mul + self.bias.reshape(shape)


def layer_norm(dim: int) -> FlaxNorm:
    """flax ``LayerNorm(epsilon=1e-5)`` over the last axis."""
    return FlaxNorm(dim, (-1,), -1)


def _conv(in_ch: int, out_ch: int, k: int) -> nn.Conv2d:
    """flax ``Conv(padding="SAME")`` under torch's own Conv2d init, U(±1/√fan_in)
    for weight and bias, which is what JAX's ``_torch_conv_init`` draws."""
    return nn.Conv2d(in_ch, out_ch, k, padding="same")


def _filter_params(size: int, cutoff_den: float, half_width_mult: float):
    cutoff = size / cutoff_den
    half_width = half_width_mult * size - cutoff
    return cutoff, half_width


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
class AntiAliasedLReLu(nn.Module):
    """Kaiser FIR up/down filters designed per layer, the symmetric
    interpretation's padding, filtered_lrelu with gain √2, slope 0.2 and a
    learnable bias (NCHW)."""

    def __init__(self, channels: int, in_size: int, out_size: int, in_cutoff: float,
                 out_cutoff: float, in_half_width: float, out_half_width: float,
                 filter_size: int = 6, lrelu_upsampling: int = 2):
        super().__init__()
        tmp_rate = max(in_size, out_size) * lrelu_upsampling
        self.up = int(np.rint(tmp_rate / in_size))
        up_taps = filter_size * self.up if self.up > 1 else 1
        self.fu = design_lowpass_filter(up_taps, cutoff=in_cutoff, width=in_half_width * 2,
                                        fs=tmp_rate)
        self.down = int(np.rint(tmp_rate / out_size))
        down_taps = filter_size * self.down if self.down > 1 else 1
        self.fd = design_lowpass_filter(down_taps, cutoff=out_cutoff, width=out_half_width * 2,
                                        fs=tmp_rate)
        # padding per the symmetric interpretation
        pad_total = (out_size - 1) * self.down + 1
        pad_total -= in_size * self.up
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)]
        self.in_size, self.out_size = in_size, out_size
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = filtered_lrelu(x, self.fu, self.fd, self.bias.to(x.dtype), up=self.up,
                           down=self.down, padding=self.padding, gain=SQRT2, slope=0.2)
        assert y.shape[2] == self.out_size and y.shape[3] == self.out_size, (
            y.shape, self.out_size)
        return y


class StandardLReLu(nn.Module):
    """Leaky ReLU with bilinear resampling. ``jax.image.resize`` antialiases
    when it downsamples, hence ``antialias=True``."""

    def __init__(self, channels: int, in_size: int, out_size: int):
        super().__init__()
        self.in_size, self.out_size = in_size, out_size
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = bias_act(x, self.bias, act="lrelu", alpha=0.2, gain=1.0)
        if self.out_size != self.in_size:
            x = F.interpolate(x, size=(self.out_size, self.out_size), mode="bilinear",
                              align_corners=False, antialias=True)
        return x


# ---------------------------------------------------------------------------
# FILM lead-time conditioning
# ---------------------------------------------------------------------------
class FILM(nn.Module):
    """A norm, then per-channel scale and bias MLPs of the scalar lead time.
    Dense kernels start at zero, so the layer starts as the norm alone; the
    two ``inp2lat`` biases (``Dense_0``, ``Dense_2``) are U(−1, 1), the
    scale head's bias ones, the bias head's zeros."""

    def __init__(self, channels: int, norm: str = "instance", intermediate: int = 128):
        super().__init__()
        self.norm = norm
        if norm == "instance":
            self.GroupNorm_0 = FlaxNorm(channels, (2, 3), 1)
        elif norm == "layer":
            self.LayerNorm_0 = FlaxNorm(channels, (1, 2, 3), 1)
        elif norm == "batch":
            self.bn_scale = nn.Parameter(torch.ones(channels))
            self.bn_bias = nn.Parameter(torch.zeros(channels))
        elif norm != "none":
            raise ValueError(norm)
        self.Dense_0 = nn.Linear(1, intermediate)
        self.Dense_1 = nn.Linear(intermediate, channels)
        self.Dense_2 = nn.Linear(1, intermediate)
        self.Dense_3 = nn.Linear(intermediate, channels)
        with torch.no_grad():
            for k in range(4):
                getattr(self, f"Dense_{k}").weight.zero_()
            self.Dense_0.bias.uniform_(-1.0, 1.0)
            self.Dense_1.bias.fill_(1.0)
            self.Dense_2.bias.uniform_(-1.0, 1.0)
            self.Dense_3.bias.zero_()

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        if self.norm == "instance":
            x = self.GroupNorm_0(x)
        elif self.norm == "layer":
            x = self.LayerNorm_0(x)
        elif self.norm == "batch":  # per-channel statistics over (batch, H, W)
            mu = x.mean((0, 2, 3), keepdim=True)
            var = ((x - mu) ** 2).mean((0, 2, 3), keepdim=True)
            x = (x - mu) * torch.rsqrt(var + 1e-5)
            x = x * self.bn_scale.reshape(1, -1, 1, 1) + self.bn_bias.reshape(1, -1, 1, 1)
        t = time.reshape(-1, 1).to(x.dtype)
        scale = self.Dense_1(self.Dense_0(t))
        bias = self.Dense_3(self.Dense_2(t))
        return x * scale[:, :, None, None] + bias[:, :, None, None]


# ---------------------------------------------------------------------------
# blocks (NCHW)
# ---------------------------------------------------------------------------
def _activation(activation: str, channels: int, in_size: int, out_size: int,
                cutoff_den: float, filter_size: int, lrelu_upsampling: int,
                half_width_mult: float) -> tuple[str, nn.Module]:
    if activation == "lrelu":
        return "StandardLReLu_0", StandardLReLu(channels, in_size, out_size)
    in_cut, in_hw = _filter_params(in_size, cutoff_den, half_width_mult)
    out_cut, out_hw = _filter_params(out_size, cutoff_den, half_width_mult)
    return "AntiAliasedLReLu_0", AntiAliasedLReLu(
        channels, in_size, out_size, in_cut, out_cut, in_hw, out_hw,
        filter_size=filter_size, lrelu_upsampling=lrelu_upsampling)


class CNOBlock(nn.Module):
    """conv → FILM(time) → activation with in → out resampling."""

    def __init__(self, in_channels: int, out_channels: int, in_size: int, out_size: int,
                 cutoff_den: float = 2.0001, conv_kernel: int = 3, filter_size: int = 6,
                 lrelu_upsampling: int = 2, half_width_mult: float = 0.8,
                 use_time: bool = True, norm: str = "instance",
                 activation: str = "cno_lrelu"):
        super().__init__()
        self.use_time = use_time
        self.Conv_0 = _conv(in_channels, out_channels, conv_kernel)
        if use_time:
            self.FILM_0 = FILM(out_channels, norm=norm)
        self.act_name, act = _activation(activation, out_channels, in_size, out_size,
                                         cutoff_den, filter_size, lrelu_upsampling,
                                         half_width_mult)
        self.add_module(self.act_name, act)

    def forward(self, x: torch.Tensor, time: torch.Tensor | None = None) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.use_time:
            x = self.FILM_0(x, time)
        return getattr(self, self.act_name)(x)


class LiftProjectBlock(nn.Module):
    """CNOBlock(in → latent, no time, the default activation and kernel) →
    conv(latent → out)."""

    def __init__(self, in_channels: int, out_channels: int, in_size: int, out_size: int,
                 latent_dim: int = 64, conv_kernel: int = 3):
        super().__init__()
        self.CNOBlock_0 = CNOBlock(in_channels, latent_dim, in_size, out_size, use_time=False)
        self.Conv_0 = _conv(latent_dim, out_channels, conv_kernel)

    def forward(self, x: torch.Tensor, time: torch.Tensor | None = None) -> torch.Tensor:
        return self.Conv_0(self.CNOBlock_0(x))


class ResidualBlock(nn.Module):
    """2 × (conv → FILM → activation after the first) + skip, constant size."""

    def __init__(self, channels: int, size: int, cutoff_den: float = 2.0001,
                 conv_kernel: int = 3, filter_size: int = 6, lrelu_upsampling: int = 2,
                 half_width_mult: float = 0.8, use_time: bool = True, norm: str = "instance",
                 activation: str = "cno_lrelu"):
        super().__init__()
        self.use_time = use_time
        self.Conv_0 = _conv(channels, channels, conv_kernel)
        if use_time:
            self.FILM_0 = FILM(channels, norm=norm)
        self.act_name, act = _activation(activation, channels, size, size, cutoff_den,
                                         filter_size, lrelu_upsampling, half_width_mult)
        self.add_module(self.act_name, act)
        self.Conv_1 = _conv(channels, channels, conv_kernel)
        if use_time:
            self.FILM_1 = FILM(channels, norm=norm)

    def forward(self, x: torch.Tensor, time: torch.Tensor | None = None) -> torch.Tensor:
        out = self.Conv_0(x)
        if self.use_time:
            out = self.FILM_0(out, time)
        out = self.Conv_1(getattr(self, self.act_name)(out))
        if self.use_time:
            out = self.FILM_1(out, time)
        return x + out


# ---------------------------------------------------------------------------
# optional ViT bottleneck
# ---------------------------------------------------------------------------
class ViTBottleneck(nn.Module):
    """patchify → [LayerNorm, Dense(patch_dim → dim), LayerNorm] + a N(0, 1)
    position embedding → depth × [pre-norm attention (bias-free fused qkv,
    scale dim_head^-1/2, an out projection unless heads == 1 and dim_head
    == dim) + pre-norm FeedForward(dim → mlp_dim → dim, tanh GELU)] →
    LayerNorm → [Dense(dim → patch_dim), LayerNorm] → depatchify. dim =
    dim_multiplier·p²·C, dim_head = dim_head_multiplier·dim, mlp_dim =
    mlp_dim_multiplier·dim. flax infers C and the token count from data;
    here they come from ``channels`` and ``size``."""

    def __init__(self, channels: int, size: int, patch_size: int = 1, depth: int = 4,
                 heads: int = 4, dim_multiplier: float = 1.0, dim_head_multiplier: float = 1.0,
                 mlp_dim_multiplier: float = 1.0):
        super().__init__()
        p = self.patch_size = patch_size
        self.depth, self.heads = depth, heads
        patch_dim = channels * p * p
        dim = int(dim_multiplier * patch_dim)
        self.dim_head = int(dim_head_multiplier * dim)
        mlp_dim = int(mlp_dim_multiplier * dim)
        inner = self.dim_head * heads
        self.out_proj = not (heads == 1 and self.dim_head == dim)
        self.embed_norm1 = layer_norm(patch_dim)
        self.embed = dense(patch_dim, dim)
        self.embed_norm2 = layer_norm(dim)
        self.pos_embedding = nn.Parameter(torch.randn(1, (size // p) ** 2, dim))
        for d in range(depth):
            self.add_module(f"attn_{d}_norm", layer_norm(dim))
            self.add_module(f"attn_{d}_qkv", dense(dim, inner * 3, bias=False))
            if self.out_proj:
                self.add_module(f"attn_{d}_out", dense(inner, dim))
            self.add_module(f"ff_{d}_norm", layer_norm(dim))
            self.add_module(f"ff_{d}_1", dense(dim, mlp_dim))
            self.add_module(f"ff_{d}_2", dense(mlp_dim, dim))
        self.final_norm = layer_norm(dim)
        self.unembed = dense(dim, patch_dim)
        self.unembed_norm = layer_norm(patch_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        b, c, h, w = x.shape
        p = self.patch_size
        # 'b c (h p1) (w p2) -> b (h w) (p1 p2 c)'
        t = x.permute(0, 2, 3, 1).reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        t = t.reshape(b, (h // p) * (w // p), c * p * p)
        t = self.embed_norm2(self.embed(self.embed_norm1(t))) + self.pos_embedding
        scale = self.dim_head ** -0.5
        heads = lambda z: z.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)
        for d in range(self.depth):
            y = getattr(self, f"attn_{d}_norm")(t)
            q, k, v = (heads(z) for z in getattr(self, f"attn_{d}_qkv")(y).chunk(3, dim=-1))
            attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale, dim=-1)
            out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
            out = out.transpose(1, 2).reshape(b, -1, self.heads * self.dim_head)
            if self.out_proj:
                out = getattr(self, f"attn_{d}_out")(out)
            t = t + out
            y = getattr(self, f"ff_{d}_norm")(t)
            y = getattr(self, f"ff_{d}_2")(gelu(getattr(self, f"ff_{d}_1")(y)))
            t = t + y
        t = self.unembed_norm(self.unembed(self.final_norm(t)))
        x = t.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class CNO(nn.Module):
    """U-shaped operator: (B, in_size, in_size, in_channels) + lead time (B,)
    → (B, out_size, out_size, out_dim). The JAX defaults; ``expand_input``
    pads the latent grid up to the next multiple of 2^n_layers (the lift's
    activation resamples in_size → latent, the projection's back)."""

    def __init__(self, in_size: int, in_channels: int, out_dim: int = 3, n_layers: int = 3,
                 n_res: int = 1, n_res_neck: int = 6, channel_multiplier: int = 32,
                 latent_lift_proj_dim: int = 64, conv_kernel: int = 3, add_inv: bool = True,
                 use_time: bool = True, norm: str = "instance", activation: str = "cno_lrelu",
                 use_attention: bool = False, attention_patch_size: int = 1,
                 attention_depth: int = 4, attention_heads: int = 4,
                 attention_dim_multiplier: float = 1.0,
                 attention_dim_head_multiplier: float = 1.0,
                 attention_mlp_dim_multiplier: float = 1.0, out_size: int | None = None,
                 expand_input: bool = False):
        super().__init__()
        nl = n_layers
        out_size = out_size or in_size
        enc_feat = [channel_multiplier // 2] + [(2**i) * channel_multiplier for i in range(nl)]
        dec_feat_in = list(reversed(enc_feat[1:]))
        dec_feat_out = list(reversed(enc_feat[:-1]))
        for i in range(1, nl):
            dec_feat_in[i] *= 2  # concat with expanded skips
        inv_feat = list(dec_feat_in) + [enc_feat[0] + dec_feat_out[-1]]

        def latent(size):
            if not expand_input:
                return size
            de = 2**nl
            return size - (size % de) + de

        latent_in, latent_out = latent(in_size), latent(out_size)
        enc_sizes = [latent_in // 2**i for i in range(nl + 1)]
        dec_sizes = [latent_out // 2 ** (nl - i) for i in range(nl + 1)]
        kw = dict(use_time=use_time, norm=norm, activation=activation, conv_kernel=conv_kernel)

        count = Counter()

        def add(module: nn.Module) -> str:
            """Register ``module`` under flax's auto-name: its class, numbered
            in creation order."""
            cls = type(module).__name__
            name = f"{cls}_{count[cls]}"
            count[cls] += 1
            self.add_module(name, module)
            return name

        self.lift = add(LiftProjectBlock(in_channels, enc_feat[0], in_size, enc_sizes[0],
                                         latent_lift_proj_dim, conv_kernel))
        self.encoder = []  # (residual block names, downsampling block name) a level
        for i in range(nl):
            res = [add(ResidualBlock(enc_feat[i], enc_sizes[i], **kw)) for _ in range(n_res)]
            down = add(CNOBlock(enc_feat[i], enc_feat[i + 1], enc_sizes[i], enc_sizes[i + 1],
                                **kw))
            self.encoder.append((res, down))
        self.vit = add(ViTBottleneck(
            enc_feat[nl], enc_sizes[nl], patch_size=attention_patch_size,
            depth=attention_depth, heads=attention_heads,
            dim_multiplier=attention_dim_multiplier,
            dim_head_multiplier=attention_dim_head_multiplier,
            mlp_dim_multiplier=attention_mlp_dim_multiplier)) if use_attention else None
        self.neck = [add(ResidualBlock(enc_feat[nl], enc_sizes[nl], **kw))
                     for _ in range(n_res_neck)]

        def expansion(level: int, size: int) -> str:
            """(I) block: the skip at encoder ``level`` resized to ``size``."""
            return add(CNOBlock(enc_feat[level], enc_feat[level], enc_sizes[level], size, **kw))

        self.decoder = []  # (expansion, inverse or None, upsampling) block names a level
        for i in range(nl):
            if i == 0:
                exp, ch = expansion(nl, dec_sizes[0]), enc_feat[nl]
            else:
                exp = expansion(nl - i, dec_sizes[i])
                ch += enc_feat[nl - i]
            inv = None
            if add_inv:
                inv = add(CNOBlock(ch, inv_feat[i], dec_sizes[i], dec_sizes[i], **kw))
                ch = inv_feat[i]
            up = add(CNOBlock(ch, dec_feat_out[i], dec_sizes[i], dec_sizes[i + 1], **kw))
            ch = dec_feat_out[i]
            self.decoder.append((exp, inv, up))
        self.last_expansion = expansion(0, dec_sizes[nl])
        self.project = add(LiftProjectBlock(ch + enc_feat[0], out_dim, dec_sizes[nl], out_size,
                                            latent_lift_proj_dim, conv_kernel))

    def forward(self, x: torch.Tensor, time: torch.Tensor | None = None) -> torch.Tensor:
        block = lambda name: getattr(self, name)
        x = block(self.lift)(x.permute(0, 3, 1, 2).contiguous(), time)
        skips = []
        for res, down in self.encoder:
            for name in res:
                x = block(name)(x, time)
            skips.append(x)
            x = block(down)(x, time)
        if self.vit is not None:
            x = block(self.vit)(x)
        for name in self.neck:
            x = block(name)(x, time)
        for i, (exp, inv, up) in enumerate(self.decoder):
            if i == 0:
                x = block(exp)(x, time)
            else:
                x = torch.cat([x, block(exp)(skips[-i], time)], dim=1)
            if inv is not None:
                x = block(inv)(x, time)
            x = block(up)(x, time)
        x = torch.cat([x, block(self.last_expansion)(skips[0], time)], dim=1)
        return block(self.project)(x, time).permute(0, 2, 3, 1)
