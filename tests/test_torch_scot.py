"""Port parity: scOT inference — K4 and K3 (their plain versions, which the
wrappers run on CPU tensors) against the Pallas kernels in interpret mode,
the layout-sensitive modules, the whole ``ScOT`` in every JAX lowering, and
the dispatch of a layer on a CUDA device.

Every flax parameter is drawn from a seeded numpy normal (the tree's
shapes from ``jax.eval_shape`` of the init; N(0, 0.1) around 1 for scales,
log 10 for the logit scale, 0 elsewhere, so the CondLN time maps, zero at
init, are exercised) and carried across with ``state_dict_from_flax``;
the same numpy inputs go to both packages. The whole JAX model runs jitted
(one compile is cheaper than the first eager call of its few hundred ops). The kernels themselves run only on a card
(``tests/test_torch_cuda.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pregen_pde_tpu.models import scot as jscot
from pregen_pde_tpu.ops import swin_block as jsb
from pregen_pde_tpu.ops.window_attention import window_attention as jax_window_attention
from pregen_pde_tpu_torch.models import scot as tscot
from pregen_pde_tpu_torch.models.convert import state_dict_from_flax
from pregen_pde_tpu_torch.ops import swin_block as tsb
from pregen_pde_tpu_torch.ops import window_attention as twa

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

# the small config of tests/test_window_attention.py with the contract's
# 7 -> 3 channels: grid 8, window 4, so every odd block shifts (nw = 4)
KW = dict(image_size=16, patch_size=2, num_channels=7, num_out_channels=3, embed_dim=16,
          depths=(2, 2), num_heads=(2, 4), skip_connections=(1, 0), window_size=4)
# float32 kernels against float32 torch ops: summation order only (~1e-6
# measured on the CPU); the bar leaves 10x
KERNEL_TOL = 2e-5
# the whole model: 8 layers of such roundoff, compounded (2-3e-6 measured)
MODEL_TOL = 5e-5
# single layout-sensitive modules: a few float32 ops
LAYOUT_TOL = 1e-6


def _centre(path) -> float:
    keys = [getattr(k, "key", str(k)) for k in path]
    if keys[-1] == "logit_scale":
        return float(np.log(10.0))
    if keys[-1] in ("scale", "bn1_scale", "bn2_scale") or keys[-2:] == ["time_scale", "bias"]:
        return 1.0
    return 0.0


def _flax_params(module, *inputs, seed=0):
    """A seeded flax parameter tree of ``module`` (no init is run)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *inputs)["params"], jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (_centre(path) + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        shapes)


def _inputs(seed=1, b=2, s=16, c=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, s, c)).astype(np.float32),
            rng.uniform(0.1, 1.0, (b,)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _scot_params(use_conditioning):
    x, t = _inputs()
    return _flax_params(jscot.ScOT(jscot.ScOTConfig(**KW, use_conditioning=use_conditioning)),
                        jnp.asarray(x), jnp.asarray(t))


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(params))
    return module.eval()


@pytest.mark.parametrize("nw", [1, 4])
def test_k4_plain_matches_pallas_interpret(nw):
    rng = np.random.default_rng(nw)
    q, k, v = (rng.normal(size=(8, 2, 16, 8)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(nw, 2, 16, 16)).astype(np.float32)
    ref = np.asarray(jax_window_attention(*map(jnp.asarray, (q, k, v, bias))))
    twa.reset_launches()
    got = twa.window_attention(*map(torch.from_numpy, (q, k, v, bias)))
    assert twa.launches == 0  # CPU tensors never reach the CUDA library
    np.testing.assert_allclose(got.numpy(), ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("nw", [1, 4], ids=["unshifted", "shifted"])
def test_k3_plain_matches_pallas_interpret_and_ref(nw):
    """The operands of tests/test_swin_block.py:104-118."""
    rng = np.random.default_rng(5)
    b, hw, c, heads, ws = 2, 8, 32, 4, 4
    n, hd = ws * ws, c // heads
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.1
    args = (mk(b, hw, hw, c) * 10, mk(nw, heads, n, n) * 10,
            rng.uniform(1, 3, (heads,)).astype(np.float32), mk(heads, c, hd), mk(heads, 1, hd),
            mk(heads, c, hd), mk(heads, c, hd), mk(heads, 1, hd), mk(heads, hd, c), mk(1, c),
            mk(b, c) + 1, mk(b, c), mk(c, 4 * c), mk(1, 4 * c), mk(4 * c, c), mk(1, c),
            mk(b, c) + 1, mk(b, c), rng.uniform(0.5, 1.5, (b, 2)).astype(np.float32))
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jsb.fused_swin_block(*jargs, heads, ws, 1e-5))
    ref = np.asarray(jsb._ref_on_args(jargs, heads, ws, 1e-5))
    tsb.reset_launches()
    got = tsb.fused_swin_block(*map(torch.from_numpy, args), heads, ws, 1e-5).numpy()
    assert tsb.launches == 0
    np.testing.assert_allclose(got, kernel, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    np.testing.assert_allclose(got, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("use_conditioning", [True, False])
@pytest.mark.parametrize("lowering", ["xla", "attention_fused", "block_fused"])
def test_scot_matches_jax(use_conditioning, lowering):
    """Same weights, same input: the port's route of each JAX lowering (xla
    -> the plain chain; attention fused -> K4's wrapper at every layer;
    block fused -> K3's wrapper at every layer)."""
    impl = {"xla": {}, "attention_fused": {"attention_impl": "fused"},
            "block_fused": {"block_impl": "fused"}}[lowering]
    x, t = _inputs()
    params = _scot_params(use_conditioning)
    jm = jscot.ScOT(jscot.ScOTConfig(**KW, use_conditioning=use_conditioning, **impl))
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = _port(tscot.ScOT(tscot.ScOTConfig(**KW, use_conditioning=use_conditioning, **impl)),
                  params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, ref, rtol=MODEL_TOL, atol=MODEL_TOL)


def test_scot_mask_token_forcing_residual_and_resize_match_jax():
    """The optional paths: the mask token over masked patches, the learned
    residual, an input at 32² FFT-resized to the model's 16² and back, and
    the prediction forced to the labels under a pixel mask."""
    kw = dict(KW, use_mask_token=True, learn_residual=True)
    rng = np.random.default_rng(7)
    x, t = _inputs(seed=8, s=32)
    masked = rng.uniform(size=(2, 8, 8)) < 0.3
    pixel_mask = rng.uniform(size=(2, 32, 32, 3)) < 0.2
    labels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jscot.ScOT(jscot.ScOTConfig(**kw))
    params = _flax_params(jm, jnp.asarray(x), jnp.asarray(t), seed=9)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                       bool_masked_pos=jnp.asarray(masked),
                                       pixel_mask=jnp.asarray(pixel_mask),
                                       labels=jnp.asarray(labels)))
    model = _port(tscot.ScOT(tscot.ScOTConfig(**kw)), params)
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (x, t)), bool_masked_pos=torch.from_numpy(masked),
                    pixel_mask=torch.from_numpy(pixel_mask),
                    labels=torch.from_numpy(labels)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got[pixel_mask], labels[pixel_mask])
    np.testing.assert_allclose(got, ref, rtol=MODEL_TOL, atol=MODEL_TOL)


def _module_parity(jmod, tmod, *inputs, seed=3):
    jin = [jnp.asarray(a) for a in inputs]
    params = _flax_params(jmod, *jin, seed=seed)
    ref = np.asarray(jmod.apply({"params": params}, *jin))
    with torch.inference_mode():
        got = _port(tmod, params)(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=LAYOUT_TOL, atol=LAYOUT_TOL)


def test_patch_merging_unmerging_and_cond_ln_layouts():
    x, t = _inputs(seed=4, b=2, s=8, c=12)
    _module_parity(jscot.PatchMerging(12, True), tscot.PatchMerging(12, True), x, t)
    _module_parity(jscot.PatchUnmerging(12, True), tscot.PatchUnmerging(12, True), x, t)
    _module_parity(jscot.CondLayerNorm(12, True), tscot.CondLayerNorm(12, True), x, t)
    _module_parity(jscot.CondLayerNorm(12, False), tscot.CondLayerNorm(12, False), x)
    _module_parity(jscot.ConvNeXtBlock(12, True), tscot.ConvNeXtBlock(12, True), x, t)
    _module_parity(jscot.ResNetBlock(12), tscot.ResNetBlock(12), x, t)


class _JaxRecovery(fnn.Module):
    patch: int

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(3, (self.patch, self.patch), strides=(self.patch, self.patch),
                                 name="patch_recovery")(x)


class _Recovery(torch.nn.Module):
    def __init__(self, cin, patch):
        super().__init__()
        self.patch_recovery = torch.nn.ConvTranspose2d(cin, 3, patch, stride=patch)

    def forward(self, x):
        return tscot._conv_nhwc(self.patch_recovery, x)


@pytest.mark.parametrize("patch", [2, 4])
def test_patch_recovery_conv_transpose_layout(patch):
    """flax ConvTranspose (no kernel flip) against the port's
    ConvTranspose2d with the converter's flipped, axis-swapped kernel."""
    x, _ = _inputs(seed=6, b=2, s=8, c=12)
    _module_parity(_JaxRecovery(patch), _Recovery(12, patch), x)


@pytest.mark.parametrize("ws,pretrained", [(4, 0), (8, 0), (4, 8)])
def test_cpb_table_and_bias(ws, pretrained):
    """The log-spaced CPB table, the gather and 16σ: the port's bias16 vs
    the fused JAX path's, on the same CPB MLP weights."""
    jmod = jscot._WindowAttentionParams(dim=16, num_heads=2, window_size=ws,
                                        pretrained_window_size=pretrained)
    params = _flax_params(jmod)
    ref = np.asarray(jmod.apply({"params": params})["bias16"])
    tmod = _port(tscot.WindowAttentionV2(16, 2, ws, pretrained_window_size=pretrained), params)
    with torch.inference_mode():
        got = tmod.bias16().numpy()
    assert got.shape == ref.shape == (2, ws * ws, ws * ws)
    np.testing.assert_allclose(got, ref, rtol=LAYOUT_TOL, atol=LAYOUT_TOL)


def test_layer_dispatch_on_cuda():
    """On a CUDA tensor "auto" takes K3 for C <= 384 (scOT-B stages 0-2)
    and the unfused layer with K4 above (stage 3, C = 768); on the CPU the
    plain chain; "xla"/"plain" never the kernels, "fused" always."""
    with torch.device("meta"):  # the layer structure only, no weights
        model = tscot.ScOT(tscot.ScOTConfig(image_size=128, **tscot.MODEL_SIZES["B"],
                                            num_channels=7))
    routes = {name: (layer.dim, layer.takes_block_kernel("cuda"), layer.ws, layer.shift)
              for name, layer in model.swin_layers()}
    assert len(routes) == 64
    assert sum(r[1] for r in routes.values()) == 48
    for name, (dim, k3, ws, shift) in routes.items():
        assert k3 == (dim <= tsb.MAX_FUSED_DIM == 384), name
    assert routes["enc_0_blk_1"][2:] == (16, 8) and routes["enc_1_blk_1"][2:] == (16, 0)
    assert routes["enc_2_blk_0"][2] == 8 and routes["enc_3_blk_0"][2] == 4
    assert routes["dec_0_blk_0"][3] == 8  # the decoder starts each stage shifted
    assert tscot.use_kernel("auto", "cuda") and not tscot.use_kernel("auto", "cpu")
    assert tscot.use_kernel("fused", "cpu")
    assert not tscot.use_kernel("xla", "cuda") and not tscot.use_kernel("plain", "cuda")
    layer = model.enc_0_blk_0
    assert not layer.takes_block_kernel("cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        tscot.use_kernel("pallas", "cuda")
