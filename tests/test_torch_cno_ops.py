"""The port's CNO ops (``pregen_pde_tpu_torch/ops/{filter_design,bias_act,
upfirdn2d,filtered_lrelu,conv2d_resample}.py``) against the JAX package's
on the CPU, in float64.

The port works in NCHW, JAX in NHWC; inputs are numpy draws from fixed
seeds, moved between the layouts. Both packages build every filter and
operator from the same float32 taps, so the bars are float64 roundoff: 1e-12
relative L2 for the forwards and the gradients (measured ≤ 5.6e-16; the
gradient against ``jax.vjp`` of the same route, by autograd). The filter
design is compared bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX package's ops/__init__ binds its functions over the module names
jba, jcr, jfd, jfl, jup = (importlib.import_module(f"pregen_pde_tpu.ops.{m}") for m in (
    "bias_act", "conv2d_resample", "filter_design", "filtered_lrelu", "upfirdn2d"))
from pregen_pde_tpu_torch.ops import bias_act as tba
from pregen_pde_tpu_torch.ops import conv2d_resample as tcr
from pregen_pde_tpu_torch.ops import filter_design as tfd
from pregen_pde_tpu_torch.ops import filtered_lrelu as tfl
from pregen_pde_tpu_torch.ops import upfirdn2d as tup
from pregen_pde_tpu_torch.utils.parity import rel_l2

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

BAR = 1e-12  # float64 roundoff; measured ≤ 5.6e-16 forward and gradient


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def nchw(a) -> torch.Tensor:
    """An NHWC array → an NCHW float64 tensor that requires a gradient."""
    return torch.from_numpy(np.moveaxis(np.asarray(a), -1, 1).copy()).requires_grad_()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _vs_jax(jfn, tfn, x, seed=99):
    """(forward, gradient) relative L2 of ``tfn`` (NCHW) against ``jfn``
    (NHWC) on ``x``: the gradient of ⟨out, g⟩ for a random cotangent g,
    ``jax.vjp`` against autograd."""
    ref, vjp = jax.vjp(jfn, jnp.asarray(x))
    g = _rand(ref.shape, seed)
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = nchw(x)
    out = tfn(xt)
    out.backward(nchw(g).detach())
    return rel_l2(nhwc(out), np.asarray(ref)), rel_l2(nhwc(xt.grad), np.asarray(ref_dx)), out


# ---------------------------------------------------------------------------
# filter design
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("numtaps,cutoff,width,fs,radial", [
    (12, 64 / 2.0001, 2 * (0.8 * 64 - 64 / 2.0001), 256, False),  # CNO's same-size layer at 64²
    (24, 32 / 2.0001, 2 * (0.8 * 32 - 32 / 2.0001), 256, False),  # its 64 → 32 layer
    (8, 0.3, 0.3, 2.0, False),
    (7, 0.4, 0.3, 2.0, True),
    (1, 0.3, 0.3, 2.0, False),  # identity
])
def test_design_lowpass_filter_bit_equal(numtaps, cutoff, width, fs, radial):
    got = tfd.design_lowpass_filter(numtaps, cutoff, width, fs, radial=radial)
    ref = jfd.design_lowpass_filter(numtaps, cutoff, width, fs, radial=radial)
    if ref is None:
        assert got is None
        return
    assert got.dtype == np.float32 and np.array_equal(got, ref)


@pytest.mark.parametrize("f,kw", [
    (None, {}), ([1, 3, 3, 1], {}), ([1, 2, 3, 4, 4, 3, 2, 1], dict(gain=4.0)),
    ([1, 2, 1], dict(flip_filter=True, separable=True, gain=2.0)),
    (np.arange(12.0).reshape(3, 4), dict(flip_filter=True, gain=3.0)),
    ([2.0, 1.0], dict(normalize=False)),
])
def test_setup_filter_bit_equal(f, kw):
    got, ref = tfd.setup_filter(f, **kw), jfd.setup_filter(f, **kw)
    assert got.dtype == np.float32 and got.shape == ref.shape and np.array_equal(got, ref)


# ---------------------------------------------------------------------------
# bias_act
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", list(jba.activation_funcs))
def test_bias_act_every_activation(act):
    """Each of the nine activations with a bias, a gain and a clamp, and
    with its defaults alone; the table's default alphas and gains equal."""
    x, b = 3.0 * _rand((2, 5, 6, 4), 1), _rand((4,), 2)
    x[0, 0, :4, 0] = [30.0, -30.0, 0.0, 25.0]  # softplus's far tail, lrelu's 0
    spec, tspec = jba.activation_funcs[act], tba.activation_funcs[act]
    assert (tspec.def_alpha, tspec.def_gain) == (spec.def_alpha, spec.def_gain)
    for kw in (dict(gain=1.7, clamp=2.5, alpha=0.3), {}):
        bj, bt = jnp.asarray(b), torch.from_numpy(b).requires_grad_()
        fwd, grad, _ = _vs_jax(lambda z: jba.bias_act(z, bj, dim=-1, act=act, **kw),
                               lambda z: tba.bias_act(z, bt, act=act, **kw), x)
        assert fwd <= BAR and grad <= BAR, (kw, fwd, grad)
        db = jax.grad(lambda bb: jnp.sum(jba.bias_act(jnp.asarray(x), bb, dim=-1, act=act, **kw)
                                         * jnp.asarray(_rand(x.shape, 99))))(bj)
        assert rel_l2(bt.grad, np.asarray(db)) <= BAR, kw


# ---------------------------------------------------------------------------
# upfirdn2d
# ---------------------------------------------------------------------------
F8 = jfd.design_lowpass_filter(8, 0.3, 0.3, 2.0)
F12 = jfd.design_lowpass_filter(12, 0.35, 0.3, 2.0)
RADIAL = jfd.design_lowpass_filter(5, 0.4, 0.3, 2.0, radial=True)
ASYM = _rand((3, 4), 7).astype(np.float32)  # a full filter with no symmetry
# (shape NHWC, filter, up, down, padding, flip_filter, gain)
UPFIRDN_CASES = {
    "up2": ((2, 10, 12, 3), F8, 2, 1, 4, False, 4.0),
    "down2-flip": ((2, 10, 12, 3), F8, 1, 2, 4, True, 1.0),
    "up2-down2": ((2, 10, 12, 3), F8, 2, 2, 7, False, 2.0),
    "down4-mixed-pad": ((2, 12, 10, 3), F8, 1, 4, [3, -1, 2, 5], False, 1.5),
    "up2-down4-crop-flip": ((2, 10, 12, 3), F8, 2, 4, [-2, 3, 1, -1], True, 2.0),
    "xy-scaling": ((2, 10, 12, 3), F8, (2, 1), (1, 2), [4, 3, 2, 5], False, 3.0),
    "radial-2d": ((2, 9, 8, 3), RADIAL, 2, 2, [5, 4, 3, 4], False, 4.0),
    "asym-2d-flip": ((2, 8, 9, 2), ASYM, 1, 1, [1, 3, 2, -1], True, 1.0),
    "asym-2d-up-down": ((2, 8, 9, 2), ASYM, 2, 2, [-1, 2, 0, 3], False, 2.0),
    "identity-crop": ((2, 7, 5, 3), None, 1, 1, [-1, -2, 0, -1], False, 1.5),
    # W 150 → 299 and H 160 → 319 outputs: three blocks a pass, which blocking halves
    "blocked-size": ((1, 160, 150, 2), F12, 2, 1, 5, False, 4.0),
}


@pytest.mark.parametrize("case", list(UPFIRDN_CASES))
def test_upfirdn2d_every_route_matches_jax(case):
    """Each route of the port against JAX's same route (forward and
    gradient) and against JAX's "conv" route (forward); a 2-D or identity
    filter has only "auto" and "conv", and "matmul"/"blocked" raise."""
    shape, f, up, down, pad, flip, gain = UPFIRDN_CASES[case]
    x = _rand(shape, 3)
    kw = dict(up=up, down=down, padding=pad, flip_filter=flip, gain=gain)
    separable = f is not None and f.ndim == 1
    conv_ref = np.asarray(jup.upfirdn2d(jnp.asarray(x), f, impl="conv", **kw))
    routes = ("auto", "conv", "matmul", "blocked") if separable else ("auto", "conv")
    for impl in routes:
        fwd, grad, out = _vs_jax(lambda z: jup.upfirdn2d(z, f, impl=impl, **kw),
                                 lambda z: tup.upfirdn2d(z, f, impl=impl, **kw), x)
        assert fwd <= BAR and grad <= BAR, (impl, fwd, grad)
        # each dense operator entry is tap·√gain rounded to float32, the conv
        # route's tap·float32(√gain): 1.8e-7 apart at gain 1.5 (the worst case)
        assert rel_l2(nhwc(out), conv_ref) <= (BAR if impl == "conv" or not separable
                                               else 2e-6), impl
        h, w = tup.upfirdn2d_output_shape(shape[1], shape[2], None if f is None else f.shape,
                                          up=up, down=down, padding=pad)
        assert out.shape == (shape[0], shape[3], h, w)
    if not separable:
        for impl in ("matmul", "blocked"):
            with pytest.raises(ValueError, match="separable"):
                tup.upfirdn2d(nchw(x), f, impl=impl, **kw)
    if case == "blocked-size":  # the blocked route really blocks here
        for n in (150, 160):
            assert tup._blocked_operator(n, F12, 2, 1, 5, 5, False, 4.0) is not None


def test_upfirdn2d_contract_traps():
    """Zeros are stuffed after each pixel; flip_filter=False is true
    convolution; the gain is gain^(ndim/2) a filter, √gain a separable
    pass."""
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64).reshape(1, 1, 1, 3)
    y = tup.upfirdn2d(x, None, up=(2, 1), impl="conv")
    assert y.flatten().tolist() == [1.0, 0.0, 2.0, 0.0, 3.0, 0.0]
    impulse = torch.zeros(1, 1, 1, 5, dtype=torch.float64)
    impulse[..., 0] = 1.0
    f = np.array([[1.0, 2.0, 3.0]], np.float32)  # (fh, fw) = (1, 3)
    conv = tup.upfirdn2d(impulse, f, padding=[2, 0, 0, 0])
    corr = tup.upfirdn2d(impulse, f, padding=[2, 0, 0, 0], flip_filter=True)
    assert conv.flatten().tolist()[:3] == [1.0, 2.0, 3.0]  # the response in order
    assert corr.flatten().tolist()[:3] == [3.0, 2.0, 1.0]
    ones = torch.ones(1, 1, 12, 12, dtype=torch.float64)
    for f, impl in ((np.full(8, 1 / 8, np.float32), "matmul"),
                    (np.full(8, 1 / 8, np.float32), "conv"),
                    (np.full((3, 3), 1 / 9, np.float32), "conv")):
        interior = tup.upfirdn2d(ones, f, gain=4.0, impl=impl)[0, 0, 1:-1, 1:-1]
        assert torch.allclose(interior, torch.full_like(interior, 4.0), rtol=1e-6), impl
    m = tup._upfirdn1d_matrix(12, np.full(8, 1 / 8, np.float32), 1, 1, 0, 0, False, 4.0)
    assert np.allclose(m.sum(axis=0), 2.0)  # √4 a pass


def test_upfirdn2d_min_size_raises():
    x = nchw(_rand((1, 3, 3, 1), 4))
    for impl in ("auto", "conv", "matmul"):
        with pytest.raises(ValueError, match="smaller than filter"):
            tup.upfirdn2d(x, F12, padding=-1, impl=impl)


# ---------------------------------------------------------------------------
# filtered_lrelu, conv2d_resample
# ---------------------------------------------------------------------------
FU24 = jfd.design_lowpass_filter(24, 16 / 2.0001, 2 * (0.8 * 16 - 16 / 2.0001), 64)


@pytest.mark.parametrize("fu,fd,up,down,pad,clamp,flip", [
    (F12, F12, 2, 2, [11, 10, 11, 10], None, False),  # CNO's same-size layer
    (F12, FU24, 2, 4, [11, 10, 11, 10], None, False),  # a CNO downsampling layer's taps
    (FU24, F12, 4, 2, [13, 12, 13, 12], 0.8, True),
    (RADIAL, None, 2, 1, 6, None, False),
])
def test_filtered_lrelu_matches_jax(fu, fd, up, down, pad, clamp, flip):
    """Forward and the gradients in x and the bias, on every route the
    filters allow, against JAX's (auto) filtered_lrelu."""
    x, b = _rand((2, 12, 12, 4), 8), _rand((4,), 9)
    kw = dict(up=up, down=down, padding=pad, clamp=clamp, flip_filter=flip)
    bj = jnp.asarray(b)
    separable = fu.ndim == 1 and (fd is None or fd.ndim == 1)
    for impl in ("auto", "conv", "matmul", "blocked") if separable else ("auto", "conv"):
        bt = torch.from_numpy(b).requires_grad_()
        fwd, grad, out = _vs_jax(lambda z: jfl.filtered_lrelu(z, fu, fd, bj, **kw),
                                 lambda z: tfl.filtered_lrelu(z, fu, fd, bt, impl=impl, **kw), x)
        g = _rand(nhwc(out).shape, 99)
        db = jax.grad(lambda bb: jnp.sum(jfl.filtered_lrelu(jnp.asarray(x), fu, fd, bb, **kw)
                                         * jnp.asarray(g)))(bj)
        # the conv route too: at gain up² its taps round as the operators do
        assert fwd <= BAR and grad <= BAR and rel_l2(bt.grad, np.asarray(db)) <= BAR, (
            impl, fwd, grad)


@pytest.mark.parametrize("up,down,k,pad,groups,flip_w", [
    (1, 1, 3, 1, 1, True), (2, 1, 3, 0, 1, True), (1, 2, 1, 0, 2, True),
    (2, 2, 3, 2, 1, False), (1, 1, 1, 0, 4, True),
])
def test_conv2d_resample_matches_jax(up, down, k, pad, groups, flip_w):
    """Forward and the gradients in x and the weight; OIHW against JAX's
    HWIO."""
    f = jfd.design_lowpass_filter(4, 0.4, 0.4, 2.0)
    cin, cout = 4, 8
    x = _rand((2, 10, 12, cin), up * 100 + down * 10 + k)
    w = 0.3 * _rand((k, k, cin // groups, cout), k)
    kw = dict(up=up, down=down, padding=pad, groups=groups, flip_weight=flip_w)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    fwd, grad, out = _vs_jax(lambda z: jcr.conv2d_resample(z, jnp.asarray(w), f, **kw),
                             lambda z: tcr.conv2d_resample(z, wt, f, **kw), x)
    assert fwd <= BAR and grad <= BAR, (fwd, grad)
    g = _rand(nhwc(out).shape, 99)
    dw = jax.grad(lambda ww: jnp.sum(jcr.conv2d_resample(jnp.asarray(x), ww, f, **kw)
                                     * jnp.asarray(g)))(jnp.asarray(w))
    assert rel_l2(wt.grad.permute(2, 3, 1, 0), np.asarray(dw)) <= BAR
