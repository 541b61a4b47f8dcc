"""scOT / Poseidon — Swin-V2 U-shaped operator transformer (counterpart of
``models/scot.py``), NHWC at the public interface as in JAX.

Modules and their parameters carry the flax names, so a flax tree maps onto
the state_dict path for path (``models/convert.py``): Dense layers are
``nn.Linear`` (weight = kernelᵀ), convolutions ``nn.Conv2d`` (OIHW), the
patch recovery an ``nn.ConvTranspose2d`` (flax's kernel flipped, axes
swapped). Dropout and drop-path are inert at eval; in training drop-path
draws from an explicit ``torch.Generator`` (``ScOT.set_dropout_generator``,
which the trainer calls), never from torch's global generator.

Dispatch of each Swin layer (``ScOTConfig.attention_impl`` / ``block_impl``):
``"auto"`` means the hand-written CUDA kernels on a CUDA tensor and the plain
torch chain on the CPU; ``"xla"`` (alias ``"plain"``) always the plain chain;
``"fused"`` always the kernel's wrapper (on a CPU tensor the wrapper runs the
kernel's plain version). A layer takes the whole-block kernel K3 when its
width C ≤ ``MAX_FUSED_DIM`` (384), else the unfused layer with its attention
through K4. That gate is the JAX package's (`scot.py:449-450`), carried over
unmeasured; a later change sets it from measurements on the card. Both
kernels have backward kernels, so training on a CUDA tensor runs through
them too (a layer with active dropout takes the plain chain, as in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pregen_pde_tpu_torch.ops.cpb_bias import relative_position_bias
from pregen_pde_tpu_torch.ops.swin_block import MAX_FUSED_DIM, swin_block
from pregen_pde_tpu_torch.ops.window_attention import window_attention

IMPLS = ("auto", "xla", "plain", "fused")


@dataclasses.dataclass(frozen=True)
class ScOTConfig:
    """The JAX ``ScOTConfig``: the same fields and defaults."""

    image_size: int = 128
    patch_size: int = 4
    num_channels: int = 6
    num_out_channels: int = 3
    embed_dim: int = 48
    depths: Sequence[int] = (4, 4, 4, 4)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    skip_connections: Sequence[int] = (2, 2, 2, 0)
    window_size: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    use_conditioning: bool = True
    learn_residual: bool = False
    use_absolute_embeddings: bool = False
    layer_norm_eps: float = 1e-5
    drop_path_rate: float = 0.1
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    use_mask_token: bool = False
    residual_model: str = "convnext"
    pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0)
    attention_impl: str = "auto"
    block_impl: str = "auto"


MODEL_SIZES = {
    "T": dict(embed_dim=48, depths=(4, 4, 4, 4)),
    "S": dict(embed_dim=48, depths=(8, 8, 8, 8)),
    "B": dict(embed_dim=96, depths=(8, 8, 8, 8)),
    "L": dict(embed_dim=192, depths=(8, 8, 8, 8)),
}


def use_kernel(impl: str, device_type: str) -> bool:
    """Whether a layer of lowering ``impl`` on a tensor of ``device_type``
    calls the kernel's wrapper."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    return impl == "fused" or (impl == "auto" and device_type == "cuda")


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu is the tanh form


class CondLayerNorm(nn.Module):
    """LayerNorm whose affine is Linear(1→dim) of the lead time; with
    ``use_conditioning=False`` a plain learnable LayerNorm."""

    def __init__(self, dim: int, use_conditioning: bool = True, eps: float = 1e-5):
        super().__init__()
        self.dim, self.use_conditioning, self.eps = dim, use_conditioning, eps
        if use_conditioning:
            self.time_scale = nn.Linear(1, dim)
            self.time_bias = nn.Linear(1, dim)
            with torch.no_grad():  # zero maps: scale 1, bias 0 at init
                self.time_scale.weight.zero_()
                self.time_scale.bias.fill_(1.0)
                self.time_bias.weight.zero_()
                self.time_bias.bias.zero_()
        else:
            self.scale = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def affine(self, time, batch: int):
        """Per-sample (B, dim) scale and bias."""
        if not self.use_conditioning:
            return self.scale.expand(batch, -1), self.bias.expand(batch, -1)
        if time is None:
            raise ValueError("a conditioned LayerNorm needs the lead time")
        t = time.reshape(-1, 1).to(self.time_scale.weight.dtype)
        return self.time_scale(t), self.time_bias(t)

    def forward(self, x, time=None):
        mean = x.mean(-1, keepdim=True)
        var = (x * x).mean(-1, keepdim=True) - mean * mean
        xn = (x - mean) * torch.rsqrt(var + self.eps)
        w, b = self.affine(time, x.shape[0])
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (self.dim,)
        return xn * w.reshape(shape) + b.reshape(shape)


class DropPath(nn.Module):
    """Per-sample stochastic depth (the JAX ``DropPath``): in training one
    Bernoulli(keep) draw per sample, x/keep where it keeps the sample and 0
    elsewhere; identity at eval or at rate 0. The draws come from
    ``generator``, which ``ScOT.set_dropout_generator`` sets."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def keep_mask(self, batch: int, device) -> torch.Tensor:
        """(B,) multipliers: 1 at eval, mask/keep in training."""
        if self.rate == 0.0 or not self.training:
            return torch.ones(batch, device=device)
        if self.generator is None:
            raise RuntimeError("drop-path in training draws from an explicit torch.Generator; "
                               "set one with ScOT.set_dropout_generator (the Trainer does)")
        keep = 1.0 - self.rate
        draw = torch.bernoulli(torch.full((batch,), keep, device=device),
                               generator=self.generator)
        return draw / keep

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        kept = self.keep_mask(x.shape[0], x.device).reshape((-1,) + (1,) * (x.ndim - 1)) > 0
        return torch.where(kept, x / (1.0 - self.rate), torch.zeros_like(x))


def _cpb_table(ws: int, pretrained_window_size: int) -> np.ndarray:
    """Log-spaced relative coordinates ((2w-1)², 2), float32 numpy as in JAX."""
    coords = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), -1)
    norm_w = pretrained_window_size - 1 if pretrained_window_size > 0 else max(ws - 1, 1)
    table = table / norm_w * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


class WindowAttentionV2(nn.Module):
    """Swin-V2 window attention: cosine similarity × clamped per-head logit
    scale + continuous relative-position bias from a log-CPB MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 attn_dropout: float = 0.0, proj_dropout: float = 0.0,
                 pretrained_window_size: int = 0, impl: str = "auto"):
        super().__init__()
        self.dim, self.num_heads, self.window_size, self.impl = dim, num_heads, window_size, impl
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=False)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), float(np.log(10.0))))
        self.cpb_mlp1 = nn.Linear(2, 512)
        self.cpb_mlp2 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop = nn.Dropout(attn_dropout)
        self.proj_drop = nn.Dropout(proj_dropout)
        self.register_buffer("cpb_table", torch.from_numpy(
            _cpb_table(window_size, pretrained_window_size)), persistent=False)

    def scale(self) -> torch.Tensor:
        """(h,) exp of the logit scale clamped at log 100."""
        return torch.exp(torch.clamp(self.logit_scale, max=float(np.log(100.0)))).reshape(-1)

    def bias16(self) -> torch.Tensor:
        """(h, n, n) 16σ of the gathered CPB."""
        ws, h = self.window_size, self.num_heads
        n = ws * ws
        cpb = self.cpb_mlp2(F.relu(self.cpb_mlp1(self.cpb_table)))
        bias = relative_position_bias(cpb, ws).reshape(n, n, h).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias)

    def forward(self, x, mask=None):
        """x (windows·B, n, C); mask (nw, n, n) additive or None."""
        nb, n, c = x.shape
        h = self.num_heads
        hd = c // h
        heads = lambda t: t.reshape(nb, n, h, hd).permute(0, 2, 1, 3)
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
        bias16 = self.bias16()
        dropout_active = self.training and self.attn_drop.p > 0.0
        if use_kernel(self.impl, x.device.type) and not dropout_active:
            # the kernel computes plain q·kᵀ + bias: fold the scale into q
            q = q * self.scale().reshape(1, h, 1, 1)
            total = bias16[None] if mask is None else bias16[None] + mask[:, None]
            out = window_attention(q, k, v, total)
        else:
            attn = torch.einsum("bhnd,bhmd->bhnm", q, k) * self.scale().reshape(h, 1, 1)
            attn = attn + bias16[None]
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.reshape(nb // nw, nw, h, n, n) + mask[None, :, None]).reshape(
                    nb, h, n, n)
            out = torch.einsum("bhnm,bhmd->bhnd", self.attn_drop(torch.softmax(attn, -1)), v)
        out = out.permute(0, 2, 1, 3).reshape(nb, n, c)
        return self.proj_drop(self.proj(out))


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins, ws: int, h: int, w: int):
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive (−100/0) mask for shifted windows, (nw, n, n) float32."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wss] = cnt
            cnt += 1
    m = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class SwinLayerV2(nn.Module):
    """One Swin-V2 post-norm block in NHWC: windowed attention (+ cyclic
    shift), CondLN, drop-path residuals, GELU MLP. The window is
    ``min(window_size, h, w)``, fixed by the grid the layer is built for;
    the layer shifts only when the grid is wider than the window."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool, grid: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, use_conditioning: bool = True,
                 drop_path: float = 0.0, hidden_dropout: float = 0.0, attn_dropout: float = 0.0,
                 pretrained_window_size: int = 0, attention_impl: str = "auto",
                 block_impl: str = "auto"):
        super().__init__()
        ws = min(window_size, grid)
        self.dim, self.num_heads, self.ws = dim, num_heads, ws
        self.shift = ws // 2 if (shift and grid > ws) else 0
        self.block_impl = block_impl
        self.attention = WindowAttentionV2(dim, num_heads, ws, qkv_bias, attn_dropout,
                                           hidden_dropout, pretrained_window_size,
                                           attention_impl)
        self.norm1 = CondLayerNorm(dim, use_conditioning)
        self.drop_path1 = DropPath(drop_path)
        self.mlp1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.hidden_drop = nn.Dropout(hidden_dropout)
        self.norm2 = CondLayerNorm(dim, use_conditioning)
        self.drop_path2 = DropPath(drop_path)
        mask = shift_attn_mask(grid, grid, ws, self.shift) if self.shift else None
        self.register_buffer("attn_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)

    def takes_block_kernel(self, device_type: str) -> bool:
        """K3 for the whole layer (else the unfused layer, whose attention
        takes K4 by the attention lowering)."""
        dropout_active = self.training and (self.hidden_drop.p > 0.0
                                            or self.attention.attn_drop.p > 0.0)
        return (use_kernel(self.block_impl, device_type) and self.dim <= MAX_FUSED_DIM
                and not dropout_active)

    def forward(self, x, time=None):
        b, h, w, c = x.shape
        s = self.shift
        if self.takes_block_kernel(x.device.type):
            a = self.attention
            bias = a.bias16()[None]
            if s:
                bias = bias + self.attn_mask[:, None]
            ln1w, ln1b = self.norm1.affine(time, b)
            ln2w, ln2b = self.norm2.affine(time, b)
            dp = torch.stack([self.drop_path1.keep_mask(b, x.device),
                              self.drop_path2.keep_mask(b, x.device)], dim=1)
            # the parameters as they are; the shift is folded into the kernel's
            # token addressing (no roll of the grid)
            return swin_block(x.contiguous(), bias.contiguous(), a.scale(), a.query.weight,
                              a.query.bias, a.key.weight, a.value.weight, a.value.bias,
                              a.proj.weight, a.proj.bias, ln1w.contiguous(), ln1b.contiguous(),
                              self.mlp1.weight, self.mlp1.bias, self.mlp2.weight, self.mlp2.bias,
                              ln2w.contiguous(), ln2b.contiguous(), dp, self.num_heads, self.ws,
                              self.norm1.eps, s)

        shortcut = x
        if s:
            x = torch.roll(x, (-s, -s), (1, 2))
        wins = self.attention(window_partition(x, self.ws), self.attn_mask)
        x = window_reverse(wins, self.ws, h, w)
        if s:
            x = torch.roll(x, (s, s), (1, 2))
        x = shortcut + self.drop_path1(self.norm1(x, time))
        y = self.hidden_drop(self.mlp2(_gelu(self.mlp1(x))))
        return x + self.drop_path2(self.norm2(y, time))


class PatchMerging(nn.Module):
    """2×2 space-to-channel concat → Linear(4C→2C) → norm."""

    def __init__(self, dim: int, use_conditioning: bool = True):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = CondLayerNorm(2 * dim, use_conditioning)

    def forward(self, x, time=None):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        # order: (0::2,0::2), (1::2,0::2), (0::2,1::2), (1::2,1::2)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]],
                      dim=-1)
        return self.norm(self.reduction(x), time)


class PatchUnmerging(nn.Module):
    """Linear(C→2C) → pixel shuffle ×2 (JAX's channel order) → norm →
    bias-free mixup Linear."""

    def __init__(self, dim: int, use_conditioning: bool = True):
        super().__init__()
        self.upsample = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = CondLayerNorm(dim // 2, use_conditioning)
        self.mixup = nn.Linear(dim // 2, dim // 2, bias=False)

    def forward(self, x, time=None):
        b, h, w, c = x.shape
        x = self.upsample(x).reshape(b, h, w, 2, 2, c // 2)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c // 2)
        return self.mixup(self.norm(x, time))


def _conv_nhwc(conv: nn.Module, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    """Skip-path block: 7×7 depthwise conv → norm → Linear(4×) → GELU →
    Linear → layer scale → + residual."""

    def __init__(self, dim: int, use_conditioning: bool = True, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = CondLayerNorm(dim, use_conditioning)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.layer_scale = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x, time=None):
        y = self.norm(_conv_nhwc(self.dwconv, x), time)
        return x + self.layer_scale * self.pwconv2(_gelu(self.pwconv1(y)))


class ResNetBlock(nn.Module):
    """Skip-path alternative: two 3×3 convs with a stateless batch-stat norm
    (current-batch statistics, as the JAX block) and leaky ReLU, + residual."""

    def __init__(self, dim: int, use_conditioning: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)
        self.bn1_scale = nn.Parameter(torch.ones(dim))
        self.bn1_bias = nn.Parameter(torch.zeros(dim))
        self.bn2_scale = nn.Parameter(torch.ones(dim))
        self.bn2_bias = nn.Parameter(torch.zeros(dim))

    @staticmethod
    def _bnorm(z, gamma, beta):
        mu = z.mean((0, 1, 2), keepdim=True)
        var = z.var((0, 1, 2), keepdim=True, unbiased=False)
        return (z - mu) * torch.rsqrt(var + 1e-5) * gamma + beta

    def forward(self, x, time=None):
        y = F.leaky_relu(self._bnorm(_conv_nhwc(self.conv1, x), self.bn1_scale, self.bn1_bias),
                         0.01)
        return x + self._bnorm(_conv_nhwc(self.conv2, y), self.bn2_scale, self.bn2_bias)


def scot_drop_path_rates(depths: Sequence[int], rate: float):
    """Per-layer stochastic-depth rates of the reference: linspace(0, rate,
    2·sum(depths)); the encoder takes the first half in layer order, the
    decoder the second half sliced per stage. → (enc, dec) dicts keyed by
    (stage, execution-order block)."""
    total = 2 * sum(depths)
    full = np.linspace(0.0, rate, total) if total else np.zeros(0)
    half = total // 2
    enc_flat, dec_flat = full[:half], full[half:]
    enc, dec = {}, {}
    for i, d in enumerate(depths):
        off = sum(depths[:i])
        lo = sum(depths[i + 1:])
        for b in range(d):
            enc[(i, b)] = float(enc_flat[off + b])
            dec[(i, b)] = float(dec_flat[lo + b])
    return enc, dec


def fft_resize(image: torch.Tensor, target_size: int) -> torch.Tensor:
    """FFT up/downsampling of square NHWC images."""
    size = image.shape[1]
    if size == target_size:
        return image
    x_hat = torch.fft.fft2(image, dim=(1, 2), norm="forward")
    if target_size < size:
        freqs = np.fft.fftfreq(size, d=1.0 / size)
        sel = torch.as_tensor(np.nonzero((freqs >= -target_size / 2)
                                         & (freqs <= target_size / 2 - 1))[0],
                              device=image.device)
        x_hat = x_hat[:, sel][:, :, sel]
        return torch.fft.ifft2(x_hat, dim=(1, 2), norm="forward").real
    pad = (target_size - size) // 2
    x_hat = torch.fft.fftshift(x_hat, dim=(1, 2))
    x_hat = F.pad(x_hat, (0, 0, pad, pad, pad, pad))
    x_hat = torch.fft.ifftshift(x_hat, dim=(1, 2))
    return torch.fft.ifft2(x_hat, dim=(1, 2), norm="forward").real


class ScOT(nn.Module):
    """Input (B, S, S, num_channels) + lead time (B,) → (B, S, S,
    num_out_channels); other resolutions are FFT-resized to
    ``config.image_size`` and back. ``bool_masked_pos`` (B, grid, grid)
    replaces masked patch embeddings by the mask token; ``pixel_mask`` forces
    those output pixels to ``labels``."""

    def __init__(self, config: ScOTConfig):
        super().__init__()
        cfg = self.config = config
        for impl in (cfg.attention_impl, cfg.block_impl):
            if impl not in IMPLS:
                raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
        uc = cfg.use_conditioning
        L = len(cfg.depths)
        grid = cfg.image_size // cfg.patch_size
        enc_dpr, dec_dpr = scot_drop_path_rates(cfg.depths, cfg.drop_path_rate)
        res_block = {"convnext": ConvNeXtBlock, "resnet": ResNetBlock}[cfg.residual_model]
        p = cfg.patch_size
        self.patch_embed = nn.Conv2d(cfg.num_channels, cfg.embed_dim, p, stride=p)
        self.embed_norm = CondLayerNorm(cfg.embed_dim, uc)
        if cfg.use_mask_token:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, cfg.embed_dim))
        if cfg.use_absolute_embeddings:
            self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, cfg.embed_dim))
        self.embed_drop = nn.Dropout(cfg.hidden_dropout_prob)

        def layer(i, d, shift, rate):
            return SwinLayerV2(
                cfg.embed_dim * 2**i, cfg.num_heads[i], cfg.window_size, shift, grid // 2**i,
                cfg.mlp_ratio, cfg.qkv_bias, uc, rate, cfg.hidden_dropout_prob,
                cfg.attention_probs_dropout_prob, cfg.pretrained_window_sizes[i],
                cfg.attention_impl, cfg.block_impl)

        for i in range(L):
            for d in range(cfg.depths[i]):
                self.add_module(f"enc_{i}_blk_{d}", layer(i, d, d % 2 == 1, enc_dpr[(i, d)]))
            if i < L - 1:
                self.add_module(f"enc_{i}_merge", PatchMerging(cfg.embed_dim * 2**i, uc))
        for i in range(L):
            for d in range(cfg.skip_connections[i]):
                self.add_module(f"skip_{i}_blk_{d}", res_block(cfg.embed_dim * 2**i, uc))
        for i in reversed(range(L)):
            for d in range(cfg.depths[i]):
                # decode-stage blocks are built reversed in the reference, so
                # execution-order block d shifts as block depth-1-d
                self.add_module(f"dec_{i}_blk_{d}", layer(
                    i, d, (cfg.depths[i] - 1 - d) % 2 == 1, dec_dpr[(i, d)]))
            if i > 0:
                self.add_module(f"dec_{i}_unmerge", PatchUnmerging(cfg.embed_dim * 2**i, uc))
        self.patch_recovery = nn.ConvTranspose2d(cfg.embed_dim, cfg.num_out_channels, p,
                                                 stride=p)
        self.recovery_mixup = nn.Conv2d(cfg.num_out_channels, cfg.num_out_channels, 5,
                                        padding=2, bias=False)

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """The generator every drop-path of the model draws from in training
        (the fused layers' (B, 2) multipliers too, in the same order as the
        plain chain's two draws, so both routes see the same masks)."""
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = generator

    def swin_layers(self):
        """(name, layer) of every Swin layer, in execution order."""
        cfg = self.config
        L = len(cfg.depths)
        names = [f"enc_{i}_blk_{d}" for i in range(L) for d in range(cfg.depths[i])]
        names += [f"dec_{i}_blk_{d}" for i in reversed(range(L)) for d in range(cfg.depths[i])]
        return [(n, getattr(self, n)) for n in names]

    def forward(self, x, time=None, bool_masked_pos=None, pixel_mask=None, labels=None):
        cfg = self.config
        in_size = x.shape[1]
        pixel_input = x
        if in_size != cfg.image_size:
            x = fft_resize(x, cfg.image_size)
        L = len(cfg.depths)
        x = self.embed_norm(_conv_nhwc(self.patch_embed, x), time)
        if cfg.use_mask_token:
            if bool_masked_pos is not None:
                m = bool_masked_pos[..., None].to(x.dtype)
                x = x * (1.0 - m) + self.mask_token * m
        elif bool_masked_pos is not None:
            raise ValueError("bool_masked_pos requires config.use_mask_token")
        if cfg.use_absolute_embeddings:
            x = x + self.pos_embed
        x = self.embed_drop(x)

        # skips are collected before each downsample; the downsample input
        # carries the stage-level residual x + stage_in
        skips = []
        for i in range(L):
            stage_in = x
            for d in range(cfg.depths[i]):
                x = getattr(self, f"enc_{i}_blk_{d}")(x, time)
            skips.append(x)
            if i < L - 1:
                x = getattr(self, f"enc_{i}_merge")(x + stage_in, time)
        for i in range(L):
            for d in range(cfg.skip_connections[i]):
                skips[i] = getattr(self, f"skip_{i}_blk_{d}")(skips[i], time)
        x = skips[-1]
        for j, i in enumerate(reversed(range(L))):
            if j != 0:
                x = x + skips[i]  # additive skips from the second stage on
            for d in range(cfg.depths[i]):
                x = getattr(self, f"dec_{i}_blk_{d}")(x, time)
            if i > 0:
                x = getattr(self, f"dec_{i}_unmerge")(x, time)

        x = _conv_nhwc(self.recovery_mixup, _conv_nhwc(self.patch_recovery, x))
        if cfg.learn_residual:
            x = x + fft_resize(pixel_input[..., :cfg.num_out_channels], cfg.image_size)
        if in_size != cfg.image_size:
            x = fft_resize(x, in_size)
        if pixel_mask is not None:
            if labels is None:
                raise ValueError("pixel_mask forcing requires labels")
            x = torch.where(pixel_mask, labels.to(x.dtype), x)
        return x
