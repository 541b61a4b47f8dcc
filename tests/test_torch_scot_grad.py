"""Port parity: the gradients of scOT training — the CPB bias's Toeplitz
adjoint, the plain versions of the K4 and K3 backward kernels against the
JAX package's Pallas backward kernels (interpret mode) and ``jax.vjp`` of
its reference, the port's ``autograd.Function``s on CPU tensors, and the
whole model's loss and parameter gradients against ``jax.value_and_grad``.

Inputs are seeded numpy arrays handed to both packages; the JAX weights
are carried across with ``state_dict_from_flax`` (the same linear
layout maps take the gradient trees across). The kernels themselves run
only on a card (``tests/test_torch_cuda.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.models import scot as jscot
from pregen_pde_tpu.ops import cpb_bias as jcpb
from pregen_pde_tpu.ops import swin_block as jsb
from pregen_pde_tpu.ops.window_attention import window_attention as jax_window_attention
from pregen_pde_tpu.training.losses import relative_lp_loss as jax_relative_lp_loss
from pregen_pde_tpu_torch.models import scot as tscot
from pregen_pde_tpu_torch.models.convert import state_dict_from_flax
from pregen_pde_tpu_torch.ops import cpb_bias as tcpb
from pregen_pde_tpu_torch.ops import swin_block as tsb
from pregen_pde_tpu_torch.ops import window_attention as twa
from pregen_pde_tpu_torch.training.losses import relative_lp_loss
from pregen_pde_tpu_torch.utils.parity import rel_l2

from test_torch_scot import _flax_params
from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

# the `_small_scot` shape of tests/test_window_attention.py: grid 8, window
# 4 (every odd block shifts), 4 -> 2 channels, stages of C = 8 and 16
SMALL = dict(image_size=16, patch_size=2, num_channels=4, num_out_channels=2, embed_dim=8,
             depths=(2, 2), num_heads=(2, 4), skip_connections=(1, 0), window_size=4,
             drop_path_rate=0.0)
# K4 and K3: the tolerances of tests/test_window_attention.py and
# tests/test_swin_block.py (float32, the same math in another order)
K4_TOL = 5e-6
K3_RTOL, K3_ATOL = 2e-4, 5e-5
# the whole model: relative L2 of each parameter's gradient
MODEL_GRAD_TOL = 1e-4


@pytest.mark.parametrize("ws,h", [(4, 3), (8, 6), (5, 2)])
def test_cpb_adjoint_matches_gather_grad(ws, h):
    """The Toeplitz adjoint against the gather's own autograd gradient, in
    float64 at 1e-12 (tests/test_scot.py pins the JAX one the same way)."""
    table = torch.tensor(np.random.default_rng(ws).normal(size=((2 * ws - 1) ** 2, h)),
                         requires_grad=True)
    cot = torch.tensor(np.random.default_rng(ws + 1).normal(size=(ws ** 4, h)))
    idx = torch.as_tensor(tcpb.rel_index(ws))
    assert np.array_equal(tcpb.rel_index(ws), jcpb._rel_index(ws))
    assert np.array_equal(tcpb.diag_extractor(ws), jcpb._diag_extractor(ws))
    out = tcpb.relative_position_bias(table, ws)
    assert torch.equal(out, table[idx])
    (g_new,) = torch.autograd.grad((out * cot).sum(), table)
    (g_ref,) = torch.autograd.grad((table[idx] * cot).sum(), table)
    np.testing.assert_allclose(g_new.numpy(), g_ref.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("nb,n,c,h,nw", [(8, 16, 8, 2, 4), (4, 64, 24, 3, 1)])
def test_k4_backward_plain_matches_pallas_interpret(nb, n, c, h, nw):
    """``window_attention_bwd_plain`` and the autograd of the port's
    ``window_attention`` on CPU tensors against ``jax.grad`` of the JAX
    ``window_attention`` (its Pallas backward in interpret mode)."""
    rng = np.random.default_rng(0)
    hd = c // h
    q, k, v = (rng.normal(size=(nb, h, n, hd)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(nw, h, n, n)).astype(np.float32)
    w = rng.normal(size=(nb, h, n, hd)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jax_window_attention(*a) * w), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias))
    plain = twa.window_attention_bwd_plain(tq, tk, tv, tb, torch.from_numpy(w))
    twa.reset_launches()
    auto = torch.autograd.grad((twa.window_attention(tq, tk, tv, tb) * torch.from_numpy(w)).sum(),
                               (tq, tk, tv, tb))
    assert twa.launches == twa.bwd_launches == 0  # CPU tensors never reach the CUDA library
    assert plain[3].dtype == torch.float32 and plain[3].shape == (nw, h, n, n)
    for name, r, a, b in zip(("dq", "dk", "dv", "dbias"), ref, plain, auto):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), rtol=K4_TOL, atol=K4_TOL,
                                   err_msg=name)
        np.testing.assert_array_equal(b.numpy(), a.detach().numpy(), err_msg=name)


@pytest.mark.parametrize("nb,n,hd,h,nw", [(4, 16, 32, 3, 1), (8, 16, 32, 2, 4)],
                         ids=["stage3", "shifted"])
def test_k4_backward_from_lse_matches_pallas_interpret(nb, n, hd, h, nw):
    """The card's backward arithmetic, P rebuilt from the forward's saved
    log-sum-exp (``window_attention_lse_plain`` then
    ``window_attention_bwd_lse_plain``), and the autograd of
    ``window_attention`` on CPU tensors, against ``jax.grad`` of the JAX
    ``window_attention`` (its Pallas backward in interpret mode), at the
    main path's n = 16, hd = 32 and with a shifted bias (nw > 1); then the
    lse route against the softmax route in float64 at a logit scale of 10."""
    rng = np.random.default_rng(nb + nw)
    # q and k as the contract passes them: cosine-normalised, q times the
    # logit scale; the bias 16 sigmoid(CPB), plus the -100 shift mask
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    qn = unit(rng.normal(size=(nb, h, n, hd)))
    k = unit(rng.normal(size=(nb, h, n, hd)))
    v = rng.normal(size=(nb, h, n, hd))
    bias = 16.0 / (1.0 + np.exp(-rng.normal(size=(nw, h, n, n))))
    if nw > 1:
        bias = bias - 100.0 * (rng.random(size=(nw, 1, n, n)) < 0.3)
    w = rng.normal(size=(nb, h, n, hd))
    # float32 at a logit scale of 1: the tolerance of the test above holds
    # the float32 roundoff of both sides (at a scale of 10 it alone reads
    # ~1e-5 on dk, against float64, in the JAX kernel and the port alike)
    f32 = [a.astype(np.float32) for a in (qn, k, v, bias, w)]
    ref = jax.grad(lambda *a: jnp.sum(jax_window_attention(*a) * f32[4]), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, f32[:4]))
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_() for a in f32[:4])
    tw = torch.from_numpy(f32[4])
    with torch.no_grad():
        out, lse = twa.window_attention_lse_plain(tq, tk, tv, tb)
        lse_grads = twa.window_attention_bwd_lse_plain(tq, tk, tv, tb, out, lse, tw)
    np.testing.assert_allclose(out.numpy(), twa.window_attention_plain(tq, tk, tv, tb).detach(),
                               rtol=K4_TOL, atol=K4_TOL)
    twa.reset_launches()
    auto = torch.autograd.grad((twa.window_attention(tq, tk, tv, tb) * tw).sum(),
                               (tq, tk, tv, tb))
    assert twa.launches == twa.bwd_launches == 0
    assert twa.bwd_route(n) == "small" and lse_grads[3].shape == (nw, h, n, n)
    for name, r, a, b in zip(("dq", "dk", "dv", "dbias"), ref, lse_grads, auto):
        for got in (a, b):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(r), rtol=K4_TOL,
                                       atol=K4_TOL, err_msg=name)
    # float64, a logit scale of 10: the same gradients by either route
    t64 = [torch.from_numpy(a) for a in (10.0 * qn, k, v, bias, w)]
    out, lse = twa.window_attention_lse_plain(*t64[:4])
    for name, a, b in zip(("dq", "dk", "dv", "dbias"),
                          twa.window_attention_bwd_lse_plain(*t64[:4], out, lse, t64[4]),
                          twa.window_attention_bwd_plain(*t64)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12, err_msg=name)


def _k3_operands(nw, c=32, heads=4, b=2, hw=8, ws=4, seed=5):
    """The operands of tests/test_swin_block.py:104-120 and a cotangent."""
    rng = np.random.default_rng(seed)
    n, hd = ws * ws, c // heads
    mk = lambda *s: rng.normal(size=s).astype(np.float32) * 0.1
    args = (mk(b, hw, hw, c) * 10, mk(nw, heads, n, n) * 10,
            rng.uniform(1, 3, (heads,)).astype(np.float32), mk(heads, c, hd), mk(heads, 1, hd),
            mk(heads, c, hd), mk(heads, c, hd), mk(heads, 1, hd), mk(heads, hd, c), mk(1, c),
            mk(b, c) + 1, mk(b, c), mk(c, 4 * c), mk(1, 4 * c), mk(4 * c, c), mk(1, c),
            mk(b, c) + 1, mk(b, c), rng.uniform(0.5, 1.5, (b, 2)).astype(np.float32))
    return args, mk(b, hw, hw, c) * 10, heads, ws


def _ref_vjp(args, g, heads, ws):
    """``jax.vjp`` of ``_ref_on_args`` at the operands, jitted (one compile
    is cheaper than the eager dispatch of its ops)."""
    f = lambda a, gg: jax.vjp(lambda *x: jsb._ref_on_args(x, heads, ws, 1e-5), *a)[1](gg)
    return jax.jit(f)([jnp.asarray(a) for a in args], jnp.asarray(g))


def _assert_cotangents(got, ref, what):
    assert len(got) == len(ref) == len(tsb.COTANGENTS) == 19
    for name, g, r in zip(tsb.COTANGENTS, got, ref):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == np.shape(r), (what, name)
        np.testing.assert_allclose(g, np.asarray(r), rtol=K3_RTOL, atol=K3_ATOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("nw", [1, 4], ids=["unshifted", "shifted"])
def test_k3_backward_plain_matches_pallas_interpret_and_vjp(nw):
    """``swin_block_bwd_plain`` against the JAX fused backward kernel
    (``_fused_bwd_call`` in interpret mode) and ``jax.vjp`` of
    ``_ref_on_args``: all 19 cotangents in the packed layouts, with the
    shared (nw = 1) and per-window (nw = 4) bias accumulation."""
    args, g, heads, ws = _k3_operands(nw)
    jargs = [jnp.asarray(a) for a in args]
    ref_vjp = _ref_vjp(args, g, heads, ws)
    ref_kernel = jsb._fused_bwd_call(jargs, jnp.asarray(g), heads, ws, 1e-5, True)
    got = tsb.swin_block_bwd_plain(*map(torch.from_numpy, args), torch.from_numpy(g), heads, ws,
                                   1e-5)
    assert got[1].dtype == torch.float32
    _assert_cotangents(got, ref_kernel, "vs the Pallas backward")
    _assert_cotangents(got, ref_vjp, "vs jax.vjp of the reference")


def test_k3_backward_plain_above_the_jax_fused_width():
    """C = 256 (> the JAX package's 192 fused-backward limit, inside the
    port's 384 gate): against ``jax.vjp`` of ``_ref_on_args``, both in
    float64 (at this width the float32 per-sample ``ddp`` sums of 16,384
    products cancel to ~1e-3 relative in either package, whatever the
    order)."""
    args, g, heads, ws = _k3_operands(4, c=256, heads=8, seed=6)
    args, g = [a.astype(np.float64) for a in args], g.astype(np.float64)
    assert 256 > jsb.MAX_FUSED_BWD_DIM and 256 <= tsb.MAX_FUSED_DIM
    got = tsb.swin_block_bwd_plain(*map(torch.from_numpy, args), torch.from_numpy(g), heads, ws,
                                   1e-5)
    ref = _ref_vjp(args, g, heads, ws)
    assert got[1].dtype == torch.float32  # dbias accumulates in float32 whatever the input
    _assert_cotangents(got, ref, "C = 256 vs jax.vjp, float64")


@pytest.mark.parametrize("nw", [1, 4])
def test_k3_autograd_on_cpu_is_the_plain_backward(nw):
    """The port's autograd through ``fused_swin_block`` on CPU tensors
    returns ``swin_block_bwd_plain``'s 19 cotangents: both back the same
    ``autograd.Function``, and nothing reaches the CUDA library."""
    args, g, heads, ws = _k3_operands(nw, seed=7)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tsb.reset_launches()
    y = tsb.fused_swin_block(*targs, heads, ws, 1e-5)
    got = torch.autograd.grad(y, targs, torch.from_numpy(g))
    assert tsb.launches == tsb.bwd_launches == 0
    ref = tsb.swin_block_bwd_plain(*map(torch.from_numpy, args), torch.from_numpy(g), heads, ws,
                                   1e-5)
    for name, a, b in zip(tsb.COTANGENTS, got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_model_grads():
    """Seeded weights, inputs and labels; the JAX model's relative-L1 loss
    and parameter gradients (default lowering, jitted)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    t = rng.uniform(0.1, 1.0, (2,)).astype(np.float32)
    y = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    jm = jscot.ScOT(jscot.ScOTConfig(**SMALL))
    params = _flax_params(jm, jnp.asarray(x), jnp.asarray(t), seed=22)
    loss = lambda p: jax_relative_lp_loss(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
                                          .astype(jnp.float32), jnp.asarray(y))
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return (x, t, y), params, float(value), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("route", ["plain", "attention_fused", "block_fused"])
def test_scot_loss_and_gradients_match_jax(route):
    """A small scOT (drop-path 0) in train mode, JAX weights: the relative-L1
    loss and every parameter's gradient against ``jax.value_and_grad`` of
    the JAX model, per leaf by relative L2 <= 1e-4. The port runs its plain
    chain, or every layer through K4's or K3's wrapper (whose CPU backward
    is the plain version)."""
    (x, t, y), params, ref_loss, ref_grads = _jax_model_grads()
    impl = {"plain": {}, "attention_fused": {"attention_impl": "fused"},
            "block_fused": {"block_impl": "fused"}}[route]
    model = tscot.ScOT(tscot.ScOTConfig(**SMALL, **impl))
    model.load_state_dict(state_dict_from_flax(params))
    model.train()
    loss = relative_lp_loss(model(torch.from_numpy(x), torch.from_numpy(t)).float(),
                            torch.from_numpy(y))
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    ref = state_dict_from_flax(ref_grads)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    errs = {n: rel_l2(p.grad, ref[n]) for n, p in model.named_parameters()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= MODEL_GRAD_TOL, (worst, errs[worst])
