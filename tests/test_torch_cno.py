"""The port's CNO (``pregen_pde_tpu_torch/models/cno.py``) and
``FourierFeatures`` against the JAX package's flax modules on the CPU, in
float64.

Weights come from the port's own init, perturbed so that every parameter
matters (FILM's zero kernels included), and reach flax as a parameter tree
by the inverse of the converter (``flax_tree``); flax's ``init`` is not
needed, and its parameter tree's structure is checked by ``jax.eval_shape``.
Inputs are numpy draws from fixed seeds. Both sides build the same filters
and operators from the same float32 taps, so the bars are float64
roundoff: 1e-12 relative L2 for every block and the whole model, forward
and each parameter's gradient (measured ≤ 5e-15 forward, ≤ 2.3e-14 the
worst gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pregen_pde_tpu.models import cno as jcno
from pregen_pde_tpu.models.fourier_features import FourierFeatures as JFourierFeatures
from pregen_pde_tpu_torch.models import cno as tcno
from pregen_pde_tpu_torch.models.convert import load_checkpoint, state_dict_from_flax
from pregen_pde_tpu_torch.models.fourier_features import FourierFeatures
from pregen_pde_tpu_torch.utils.parity import rel_l2

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

BAR = 1e-12  # float64 roundoff; measured ≤ 5e-15 forward, ≤ 2.3e-14 gradients
# the small CNO of tests/test_cno.py:77-107
SMALL = dict(n_layers=2, n_res=1, n_res_neck=1, channel_multiplier=8, latent_lift_proj_dim=8)


def flax_tree(named) -> dict:
    """The port's ``(name, tensor)`` pairs (parameters or their gradients)
    → the nested flax tree of float64 numpy arrays: the converter's
    inverse (``weight`` (out, in) or OIHW → ``kernel`` (in, out) or HWIO)."""
    flat = {}
    for name, t in named:
        parts = name.split(".")
        a = t.detach().double().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        flat[tuple(parts)] = a
    return traverse_util.unflatten_dict(flat)


def perturbed(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """``module`` in float64 with N(0, 0.1²) added to every parameter."""
    gen = torch.Generator().manual_seed(seed)
    module = module.double()
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=p.dtype))
    return module


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape)


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


T2 = np.array([0.3, 0.8])


def _block_case(name):
    """(flax module, port module, NHWC input, takes the time) of a block."""
    cut, hw = jcno._filter_params(16, 2.0001, 0.8)
    cut8, hw8 = jcno._filter_params(8, 2.0001, 0.8)
    cut32, hw32 = jcno._filter_params(32, 2.0001, 0.8)
    aa = lambda s_in, s_out, c_in, c_out, h_in, h_out: (
        jcno.AntiAliasedLReLu(4, s_in, s_out, c_in, c_out, h_in, h_out),
        tcno.AntiAliasedLReLu(4, s_in, s_out, c_in, c_out, h_in, h_out), (2, s_in, s_in, 4),
        False)
    cases = {
        "aa-same": lambda: aa(16, 16, cut, cut, hw, hw),
        "aa-down": lambda: aa(16, 8, cut, cut8, hw, hw8),
        "aa-up": lambda: aa(16, 32, cut, cut32, hw, hw32),
        "standard-down": lambda: (jcno.StandardLReLu(4, 16, 8), tcno.StandardLReLu(4, 16, 8),
                                  (2, 16, 16, 4), False),
        "standard-up": lambda: (jcno.StandardLReLu(4, 8, 16), tcno.StandardLReLu(4, 8, 16),
                                (2, 8, 8, 4), False),
        "cno-block": lambda: (jcno.CNOBlock(8, 16, 8), tcno.CNOBlock(4, 8, 16, 8),
                              (2, 16, 16, 4), True),
        "cno-block-lrelu-layer": lambda: (
            jcno.CNOBlock(8, 8, 16, norm="layer", activation="lrelu"),
            tcno.CNOBlock(4, 8, 8, 16, norm="layer", activation="lrelu"), (2, 8, 8, 4), True),
        "residual": lambda: (jcno.ResidualBlock(4, 16), tcno.ResidualBlock(4, 16),
                             (2, 16, 16, 4), True),
        "lift": lambda: (jcno.LiftProjectBlock(6, 16, 16, latent_dim=8),
                         tcno.LiftProjectBlock(5, 6, 16, 16, latent_dim=8), (2, 16, 16, 5),
                         True),
        "vit": lambda: (jcno.ViTBottleneck(depth=2), tcno.ViTBottleneck(16, 4, depth=2),
                        (2, 4, 4, 16), False),
        "vit-patch2-one-head": lambda: (
            jcno.ViTBottleneck(patch_size=2, depth=1, heads=1, mlp_dim_multiplier=2.0),
            tcno.ViTBottleneck(8, 4, patch_size=2, depth=1, heads=1, mlp_dim_multiplier=2.0),
            (2, 4, 4, 8), False),
    }
    cases.update({f"film-{norm}": (lambda norm=norm: (
        jcno.FILM(4, norm=norm), tcno.FILM(4, norm=norm), (3, 8, 8, 4), True))
        for norm in ("instance", "layer", "batch", "none")})
    return cases[name]()


BLOCKS = ["aa-same", "aa-down", "aa-up", "standard-down", "standard-up", "film-instance",
          "film-layer", "film-batch", "film-none", "cno-block", "cno-block-lrelu-layer",
          "residual", "lift", "vit", "vit-patch2-one-head"]


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_flax(name):
    """Each block's forward against its flax counterpart (NHWC there, NCHW
    here), with perturbed weights; the activations down, same-size and up."""
    jm, tm, shape, timed = _block_case(name)
    torch.manual_seed(0)
    tm = perturbed(tm)
    x = 2.0 * _x(shape) + 0.5
    t = T2 if shape[0] == 2 else np.array([0.3, 0.8, 0.1])
    args = (jnp.asarray(x), jnp.asarray(t)) if timed else (jnp.asarray(x),)
    ref = np.asarray(jm.apply({"params": flax_tree(tm.named_parameters())}, *args))
    targs = (_nchw(x), torch.from_numpy(t)) if timed else (_nchw(x),)
    out = tm(*targs)
    assert _nhwc(out).shape == ref.shape
    assert rel_l2(_nhwc(out), ref) <= BAR


def _small_cno(**kw):
    torch.manual_seed(0)
    return tcno.CNO(32, 7, out_dim=3, **{**SMALL, **kw})


def test_cno_forward_and_gradients_match_flax():
    """The small CNO (32², 2 layers, multiplier 8, one neck block), forward
    and every parameter's gradient of a relative-L2 loss against
    ``jax.value_and_grad``; the parameter tree's names and shapes against
    flax's own ``init`` (by ``jax.eval_shape``)."""
    tm = perturbed(_small_cno())
    x, t = _x((2, 32, 32, 7)), T2
    y = _x((2, 32, 32, 3), seed=9)
    jm = jcno.CNO(in_size=32, out_dim=3, **SMALL)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x), jnp.asarray(t))["params"]
    params = flax_tree(tm.named_parameters())
    flat_shapes = traverse_util.flatten_dict(shapes)
    assert {k: v.shape for k, v in flat_shapes.items()} == {
        k: v.shape for k, v in traverse_util.flatten_dict(params).items()}

    def loss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.linalg.norm(pred - y) / jnp.linalg.norm(y), pred

    (ref_loss, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pred = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert pred.shape == (2, 32, 32, 3) and rel_l2(pred, np.asarray(ref)) <= BAR
    yt = torch.from_numpy(y)
    (torch.linalg.vector_norm(pred - yt) / torch.linalg.vector_norm(yt)).backward()
    ours = traverse_util.flatten_dict(flax_tree((k, p.grad) for k, p in tm.named_parameters()))
    ref_g = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, grads))
    assert set(ours) == set(ref_g)
    # a convolution's bias before a per-channel norm has no gradient: both
    # sides read roundoff there (≤ 4e-17 of the whole gradient), so those
    # leaves are held to 1e-12 of the whole, the rest by their own norm
    total = np.sqrt(sum(np.sum(g ** 2) for g in ref_g.values()))
    for k in ours:
        if np.linalg.norm(ref_g[k]) <= BAR * total:
            assert k[-1] == "bias" and np.linalg.norm(ours[k]) <= BAR * total, k
        else:
            assert rel_l2(ours[k], ref_g[k]) <= BAR, k


@pytest.mark.parametrize("kw,s,cin", [
    (dict(use_attention=True), 16, 4),
    (dict(expand_input=True), 50, 6),
    (dict(activation="lrelu", add_inv=False, use_time=False), 32, 7),
], ids=["attention", "expand-input-50", "lrelu-no-inv-no-time"])
def test_cno_variants_forward_match_flax(kw, s, cin):
    """The ViT bottleneck, ``expand_input`` at 50² (latent 52, the lift
    resampling 50 → 52 and the projection back), the plain activation with
    no inverse blocks and no time: forward against flax (the norms other
    than "instance" are held in the FILM block tests)."""
    torch.manual_seed(0)
    tm = perturbed(tcno.CNO(s, cin, out_dim=3, **{**SMALL, **kw}))
    x = _x((2, s, s, cin))
    jm = jcno.CNO(in_size=s, out_dim=3, **{**SMALL, **kw})
    ref = np.asarray(jm.apply({"params": flax_tree(tm.named_parameters())}, jnp.asarray(x),
                              jnp.asarray(T2)))
    out = tm(torch.from_numpy(x), torch.from_numpy(T2))
    assert out.shape == (2, s, s, 3) and rel_l2(out, ref) <= BAR
    if kw.get("expand_input"):
        lift = tm.LiftProjectBlock_0.CNOBlock_0.AntiAliasedLReLu_0
        assert (lift.up, lift.down, lift.out_size) == (2, 2, 52)


def test_flax_checkpoint_round_trip(tmp_path):
    """A flax CNO tree in float32, flattened with '/' into an ``.npz``, read
    by ``load_checkpoint``: the state_dict equal to the bit, and the same
    forward as flax on those weights."""
    tm = perturbed(_small_cno()).float()
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                  flax_tree(tm.named_parameters()))
    npz = tmp_path / "cno.npz"
    np.savez(npz, **traverse_util.flatten_dict(tree, sep="/"))
    loaded = _small_cno()
    load_checkpoint(loaded, npz)
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in tm.state_dict().items())
    assert all(torch.equal(v, tm.state_dict()[k])
               for k, v in state_dict_from_flax(tree).items())
    x = _x((2, 32, 32, 7))
    jm = jcno.CNO(in_size=32, out_dim=3, **SMALL)
    ref = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(T2)))
    out = loaded.double()(torch.from_numpy(x), torch.from_numpy(T2))
    assert rel_l2(out, ref) <= BAR


def test_init_laws():
    """The JAX init laws, as laws (the RNG streams differ): convolutions
    U(±1/√fan_in) for weight and bias; FILM's Dense kernels 0, its inp2lat
    biases U(−1, 1), the scale head's bias 1, the bias head's 0; the norms'
    scale 1 and bias 0; the activations' biases 0; the ViT's position
    embedding N(0, 1) and its Dense kernels lecun-normal with zero biases."""
    torch.manual_seed(0)
    m = tcno.CNO(32, 7, n_layers=2, n_res_neck=1, channel_multiplier=16,
                 use_attention=True).requires_grad_(False)
    conv = m.ResidualBlock_0.Conv_0  # fan_in 8·3·3 = 72
    bound = 72 ** -0.5
    assert float(conv.bias.abs().max()) <= bound
    assert bound >= float(conv.weight.abs().max()) > 0.9 * bound  # 576 draws
    assert abs(float(conv.weight.std()) - bound / 3 ** 0.5) < 0.1 * bound
    film = m.CNOBlock_0.FILM_0
    for k in range(4):
        assert torch.equal(getattr(film, f"Dense_{k}").weight,
                           torch.zeros_like(getattr(film, f"Dense_{k}").weight))
    for b in (film.Dense_0.bias, film.Dense_2.bias):  # 128 draws of U(-1, 1)
        assert float(b.abs().max()) <= 1.0 and float(b.min()) < -0.8 and float(b.max()) > 0.8
    ones, zeros = torch.ones(16), torch.zeros(16)  # CNOBlock_0 maps 8 → 16 channels
    assert torch.equal(film.Dense_1.bias, ones) and torch.equal(film.Dense_3.bias, zeros)
    assert torch.equal(film.GroupNorm_0.scale, ones)
    assert torch.equal(film.GroupNorm_0.bias, zeros)
    assert torch.equal(m.CNOBlock_0.AntiAliasedLReLu_0.bias, zeros)
    vit = m.ViTBottleneck_0
    pos = vit.pos_embedding  # (1, 8², 32): 32 channels at 8² at the bottleneck
    assert pos.shape == (1, 64, 32)
    assert abs(float(pos.mean())) < 0.05 and abs(float(pos.std()) - 1.0) < 0.05
    qkv = vit.attn_0_qkv.weight  # (3·4·32, 32): lecun-normal, truncated at 2σ
    assert abs(float(qkv.std()) - 32 ** -0.5) < 0.05 * 32 ** -0.5
    assert float(qkv.abs().max()) <= 2 * 32 ** -0.5 / 0.87962566103423978
    assert vit.attn_0_qkv.bias is None and torch.equal(vit.embed.bias, torch.zeros(32))


def test_fourier_features_match_flax():
    """B from the seed as in JAX, a constant outside the state_dict; scale 0
    is the identity."""
    coords = _x((3, 5, 2))
    for scale, size, seed in ((1.5, 6, 0), (10.0, 4, 3)):
        ff = FourierFeatures(scale, size, seed=seed).double()
        assert not list(ff.parameters()) and not ff.state_dict()
        jm = JFourierFeatures(scale, size, seed=seed)
        ref = np.asarray(jm.apply({}, jnp.asarray(coords)))
        out = ff(torch.from_numpy(coords))
        assert out.shape == (3, 5, 2 * size) and rel_l2(out, ref) <= BAR
    x = torch.from_numpy(coords)
    assert FourierFeatures(0.0, 6)(x) is x
