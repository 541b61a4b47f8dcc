"""K3 in the layouts the model passes: the plain versions of the kernels'
dataflow (``swin_block_fwd_plain`` saving qkv, o, the log-sum-exps, both
LayerNorms' x̂ and rstd, x2 and the MLP pre-activation;
``swin_block_bwd_linear_plain`` from those alone) against the JAX package's
reference (``_ref_on_args`` and ``jax.vjp`` of it) in float64, the shift
folded into the window addressing against roll → block → roll, the map of
``fused_swin_block``'s per-head packs onto the ``nn.Linear`` layouts, and a
model of the kernels' 3xTF32 products.

Inputs are seeded numpy arrays handed to both packages. The kernels
themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.ops import swin_block as jsb
from pregen_pde_tpu_torch.models.scot import shift_attn_mask
from pregen_pde_tpu_torch.ops import swin_block as tsb

from test_torch_scot_grad import K3_ATOL, K3_RTOL
from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

EPS = 1e-5


def _packed(b, hw, c, heads, ws, shift, seed):
    """The JAX package's packed operands (float64) with the real shift mask
    when the layer shifts, and a cotangent."""
    rng = np.random.default_rng(seed)
    n, hd = ws * ws, c // heads
    mk = lambda *s: rng.normal(size=s) * 0.1
    bias = 16.0 / (1.0 + np.exp(-mk(1, heads, n, n) * 10))
    if shift:
        bias = bias + shift_attn_mask(hw, hw, ws, shift)[:, None].astype(np.float64)
    args = (mk(b, hw, hw, c) * 10, bias, rng.uniform(1, 3, (heads,)), mk(heads, c, hd),
            mk(heads, 1, hd), mk(heads, c, hd), mk(heads, c, hd), mk(heads, 1, hd),
            mk(heads, hd, c), mk(1, c), mk(b, c) + 1, mk(b, c), mk(c, 4 * c), mk(1, 4 * c),
            mk(4 * c, c), mk(1, c), mk(b, c) + 1, mk(b, c), rng.uniform(0.5, 1.5, (b, 2)))
    return args, mk(b, hw, hw, c) * 10


def _jax_block(args, heads, ws, shift):
    """roll → the JAX reference block → roll back."""
    x = jnp.roll(args[0], (-shift, -shift), (1, 2))
    y = jsb._ref_on_args((x,) + tuple(args[1:]), heads, ws, EPS)
    return jnp.roll(y, (shift, shift), (1, 2))


def _linear(args):
    """Packed operands → ``swin_block``'s (torch, nn.Linear layouts)."""
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    lin = tsb.linear_from_packs(t[3], t[4], t[5], t[6], t[7], t[8], t[9], t[12], t[13], t[14],
                                t[15])
    lq, lbq, lk, lv, lbv, lp, lbp, l1, lb1, l2, lb2 = lin
    return (t[0], t[1], t[2], lq, lbq, lk, lv, lbv, lp, lbp, t[10], t[11], l1, lb1, l2, lb2, t[16],
            t[17], t[18])


CASES = [(2, 16, 32, 4, 8, 4), (1, 16, 64, 2, 8, 0), (2, 16, 16, 2, 4, 2), (1, 32, 32, 4, 8, 4)]


@pytest.mark.parametrize("b,hw,c,heads,ws,shift", CASES)
def test_forward_plain_matches_jax_reference(b, hw, c, heads, ws, shift):
    """``swin_block_fwd_plain`` in the nn.Linear layouts, the shift folded
    into its addressing, against roll → ``_ref_on_args`` → roll (float64);
    what it saves is the forward's own: x2 and x̂ rebuild y."""
    args, _ = _packed(b, hw, c, heads, ws, shift, seed=hw + c + shift)
    ref = np.asarray(jax.jit(_jax_block, static_argnums=(1, 2, 3))(
        [jnp.asarray(a) for a in args], heads, ws, shift))
    lin = _linear(args)
    y, saved = tsb.swin_block_fwd_plain(*lin, heads, ws, EPS, shift, save=True)
    # the reference rounds x to float32 (`_ref_impl`), so float32 roundoff
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)
    y0, none = tsb.swin_block_fwd_plain(*lin, heads, ws, EPS, shift)
    assert none is None and torch.equal(y0, y)
    qkv, o, lse, xhat1, rstd1, x2, hpre, xhat2, rstd2 = saved
    n = ws * ws
    assert qkv.shape == (b, hw, hw, 3 * c) and hpre.shape == (b, hw, hw, 4 * c)
    assert lse.shape == (b * (hw // ws) ** 2, heads, n) and rstd1.shape == (b, hw, hw)
    dp, ln2w, ln2b = lin[18], lin[16], lin[17]
    rebuilt = x2 + dp[:, 1, None, None, None] * (xhat2 * ln2w[:, None, None] + ln2b[:, None, None])
    np.testing.assert_allclose(rebuilt.numpy(), y.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b,hw,c,heads,ws,shift", CASES[:3])
def test_folded_shift_equals_roll_block_roll(b, hw, c, heads, ws, shift):
    """The shift folded into the window addressing gives roll(−s) → block
    (shift 0) → roll(s), forward and every cotangent."""
    args, g = _packed(b, hw, c, heads, ws, shift or 4, seed=7)
    lin = _linear(args)
    s = shift or 4
    x = lin[0].clone().requires_grad_()
    rest = [t.clone().requires_grad_() for t in lin[1:]]
    y_f = tsb.swin_block(x, *rest, heads, ws, EPS, s)
    gf = torch.autograd.grad(y_f, [x, *rest], torch.from_numpy(g))
    y_r = torch.roll(tsb.swin_block(torch.roll(x, (-s, -s), (1, 2)), *rest, heads, ws, EPS),
                     (s, s), (1, 2))
    gr = torch.autograd.grad(y_r, [x, *rest], torch.from_numpy(g))
    np.testing.assert_allclose(y_f.detach().numpy(), y_r.detach().numpy(), rtol=1e-12, atol=1e-12)
    for name, a, r in zip(tsb.COTANGENTS, gf, gr):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-10, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("b,hw,c,heads,ws,shift", CASES)
def test_backward_dataflow_matches_jax_vjp(b, hw, c, heads, ws, shift):
    """``swin_block_bwd_linear_plain`` from the saved tensors alone (P from
    the log-sum-exps, D = do·o) against ``jax.vjp`` of roll → reference →
    roll, all 19 cotangents mapped back to the packs (float64, the K3
    tolerances of tests/test_torch_scot_grad.py)."""
    args, g = _packed(b, hw, c, heads, ws, shift, seed=hw * c + shift)
    f = lambda a, gg: jax.vjp(lambda *x: _jax_block(x, heads, ws, shift), *a)[1](gg)
    ref = jax.jit(f)([jnp.asarray(a) for a in args], jnp.asarray(g))
    lin = _linear(args)
    _, saved = tsb.swin_block_fwd_plain(*lin, heads, ws, EPS, shift, save=True)
    (x, bias, scale, wq, _, wk, wv, _, wp, _, ln1w, ln1b, w1, _, w2, _, ln2w, ln2b, dp) = lin
    got = tsb.swin_block_bwd_linear_plain(x, torch.from_numpy(g), bias, scale, wq, wk, wv, wp, w1,
                                          w2, ln1w, ln1b, ln2w, ln2b, dp, saved, heads, ws, EPS,
                                          shift)
    assert got[1].dtype == torch.float32
    packs = tsb._packs_from_linear([got[i] for i in (3, 4, 5, 6, 7, 8, 9, 12, 13, 14, 15)], heads)
    full = list(got[:3]) + list(packs[:7]) + list(got[10:12]) + list(packs[7:]) + list(got[16:])
    for name, a, r in zip(tsb.COTANGENTS, full, ref):
        assert a.shape == np.shape(r), name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=K3_RTOL, atol=K3_ATOL,
                                   err_msg=name)


def test_layer_without_qkv_bias():
    """A layer without q/v biases passes None: its forward equals zero
    biases, and its backward runs with no gradient for them."""
    args, g = _packed(1, 16, 32, 2, 8, 4, seed=3)
    lin = list(_linear(args))
    zero = torch.zeros_like(lin[4])
    lin_none = [t.clone().requires_grad_() if t is not None else None for t in lin]
    lin_none[4] = lin_none[7] = None
    lin_zero = list(lin)
    lin_zero[4] = lin_zero[7] = zero
    y_none = tsb.swin_block(*lin_none, 2, 8, EPS, 4)
    y_zero = tsb.swin_block(*lin_zero, 2, 8, EPS, 4)
    np.testing.assert_allclose(y_none.detach().numpy(), y_zero.numpy(), rtol=1e-14, atol=1e-14)
    y_none.backward(torch.from_numpy(g))
    assert lin_none[0].grad is not None and lin_none[3].grad is not None


def test_fused_swin_block_packs_round_trip():
    """``linear_from_packs`` inverts the JAX ``pack_heads`` (and the MLP's
    (in, out) kernels) exactly, and the autograd of ``fused_swin_block``
    brings the cotangents back onto the packs: they equal
    ``swin_block_bwd_plain``'s to the bit and ``jax.vjp`` at the K3
    tolerances."""
    heads, ws = 4, 8
    args, g = _packed(2, 16, 32, heads, ws, 0, seed=11)
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    lq, lbq, lk, lv, lbv, lp, lbp, l1, lb1, l2, lb2 = tsb.linear_from_packs(
        t[3], t[4], t[5], t[6], t[7], t[8], t[9], t[12], t[13], t[14], t[15])
    repacked = jsb.pack_heads(lq.numpy().T, lk.numpy().T, lv.numpy().T, lp.numpy().T, heads)
    for a, r in zip(repacked, (args[3], args[5], args[6], args[8])):
        np.testing.assert_array_equal(np.asarray(a), r)
    np.testing.assert_array_equal(l1.numpy().T, args[12])
    np.testing.assert_array_equal(l2.numpy().T, args[14])
    ins = [a.clone().requires_grad_() for a in t]
    tsb.reset_launches()
    y = tsb.fused_swin_block(*ins, heads, ws, EPS)
    got = torch.autograd.grad(y, ins, torch.from_numpy(g))
    assert tsb.launches == tsb.bwd_launches == 0
    plain = tsb.swin_block_bwd_plain(*t, torch.from_numpy(g), heads, ws, EPS)
    ref = jax.jit(lambda a, gg: jax.vjp(lambda *x: jsb._ref_on_args(x, heads, ws, EPS), *a)[1](
        gg))([jnp.asarray(a) for a in args], jnp.asarray(g))
    for name, a, p, r in zip(tsb.COTANGENTS, got, plain, ref):
        assert a.shape == p.shape == np.shape(r), name
        np.testing.assert_array_equal(a.numpy(), p.numpy().astype(a.numpy().dtype), err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=K3_RTOL, atol=K3_ATOL,
                                   err_msg=name)


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernels' ``tf32_rna``."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_3xtf32_split_model_keeps_float32_accuracy():
    """The kernels' products on a (256, 96) × (96, 288) qkv-shaped product:
    a = a_hi + a_lo, each rounded to TF32, and a_lo b_hi + a_hi b_lo +
    a_hi b_hi in float32 stays within 2× plain float32's error against
    float64; a single TF32 pass does not."""
    rng = np.random.default_rng(0)
    a64, b64 = rng.normal(size=(256, 96)), rng.normal(size=(96, 288)) * 0.2
    a, b = torch.from_numpy(a64).float(), torch.from_numpy(b64).float()
    ref = a64 @ b64
    err = lambda c: float(np.linalg.norm(c.double().numpy() - ref) / np.linalg.norm(ref))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    three = al @ bh + ah @ bl + ah @ bh
    plain, single = err(a @ b), err(ah @ bh)
    assert err(three) <= 2 * plain
    assert single > 2 * plain and single > 1e-4
