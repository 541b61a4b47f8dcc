"""The port's FNO and FFNO (``pregen_pde_tpu_torch/models/{fno,ffno}.py``)
against the JAX package's flax models on the CPU, and the CLI with FNO as
its default model.

Weights come from a flax ``init`` and reach the port through the one
converter (``models/convert.state_dict_from_flax``), as an ``.npz``
checkpoint does. Inputs are numpy draws from fixed seeds, 7 channels with a
binary hole mask in channel 4. The port runs in float64; the JAX models run
their spectral convolutions in float32 whatever the input's dtype (they
cast to it), so the bars are about 10× what the two differ by here:

- FNO forward 1e-7 relative L2 (measured 2.1e-9 at 32², 8.4e-9 at 24²),
  FFNO forward 2e-6 (2.1e-7);
- the gradient of a relative-L2 loss, per parameter, against ``jax.grad``:
  FNO 2e-6 (worst 2.2e-7), FFNO 5e-6 (worst 5.2e-7).

The 24² cases hold fewer modes than the weights: FNO at modes 16 pads to
30², so 15 of the 16 H-modes survive and ``w_neg``'s tail is used; FFNO at
modes 20 pads to 32², 17 of 20 modes. JAX's ``FNO2d`` and ``FFNO2d`` take
their truncated-DFT route by default, so the port's ``torch.fft`` route is
held against it as the same function; the spectral convolution alone is
also held against both of JAX's routes.
"""

import json
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pregen_pde_tpu.models import ffno as jffno
from pregen_pde_tpu.models import fno as jfno
from pregen_pde_tpu_torch.__main__ import _make_model, main
from pregen_pde_tpu_torch.models.convert import state_dict_from_flax
from pregen_pde_tpu_torch.models.ffno import FFNO2d
from pregen_pde_tpu_torch.models.fno import FNO2d, SpectralConv2d
from pregen_pde_tpu_torch.utils.parity import rel_l2

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

FWD_BAR = {"fno": 1e-7, "ffno": 2e-6}
GRAD_BAR = {"fno": 2e-6, "ffno": 5e-6}
SMALL = dict(width=8, n_layers=2)
# (model, grid, modes, share_weight)
CASES = [("fno", 32, 4, True), ("fno", 24, 16, True), ("ffno", 32, 4, True),
         ("ffno", 24, 20, True), ("ffno", 32, 4, False)]


def _input(s: int, seed: int = 0, c: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, s, c))
    x[..., 4] = rng.random((2, s, s)) < 0.2  # the contract's hole mask
    return x


def _flax_model(name: str, modes: int, share: bool):
    if name == "fno":
        return jfno.FNO2d(out_channels=3, modes=modes, mask_channel=4, **SMALL)
    return jffno.FFNO2d(out_channels=3, modes=modes, share_weight=share, **SMALL)


def _port_model(name: str, modes: int, share: bool):
    if name == "fno":
        return FNO2d(7, 3, modes=modes, mask_channel=4, **SMALL)
    return FFNO2d(7, 3, modes=modes, share_weight=share, **SMALL)


def _rel_loss(pred, y, norm):
    return norm(pred - y) / norm(y)


def _flax_run(name: str, s: int, modes: int, share: bool):
    """(x, y, params, forward, gradient of the relative-L2 loss) of the
    flax model, as numpy."""
    x = _input(s)
    y = np.random.default_rng(9).standard_normal((2, s, s, 3))
    jm = _flax_model(name, modes, share)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    out = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    loss = lambda p: _rel_loss(jm.apply({"params": p}, jnp.asarray(x)), y, jnp.linalg.norm)
    grads = jax.jit(jax.grad(loss))(params)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return x, y, as_np(params), np.asarray(out), as_np(grads)


def _loaded(name, modes, share, params):
    model = _port_model(name, modes, share)
    model.load_state_dict(state_dict_from_flax(params))
    return model.double().eval()


@pytest.mark.parametrize("name,s,modes,share", CASES)
def test_forward_and_gradients_match_flax(name, s, modes, share):
    x, y, params, out, grads = _flax_run(name, s, modes, share)
    model = _loaded(name, modes, share, params)
    pred = model(torch.from_numpy(x))
    assert pred.shape == out.shape and pred.dtype == torch.float64
    assert rel_l2(pred, out) <= FWD_BAR[name]
    _rel_loss(pred, torch.from_numpy(y), torch.linalg.vector_norm).backward()
    ref = state_dict_from_flax(grads)
    assert set(ref) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        assert rel_l2(p.grad, ref[k]) <= GRAD_BAR[name], k


@pytest.mark.parametrize("jax_impl", ["matmul", "fft"])
@pytest.mark.parametrize("s", [32, 10])
def test_spectral_conv_matches_both_flax_routes(jax_impl, s):
    """SpectralConv2d alone against JAX's truncated-DFT and FFT routes; at
    10² only 5 of the 6 modes survive on H, 6 of 6 on W."""
    x = np.random.default_rng(s).standard_normal((2, s, s, 3))
    jm = jfno.SpectralConv2d(5, 6, 6, impl=jax_impl)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    out = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = SpectralConv2d(3, 5, 6, 6)
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    # the JAX layer computes in float32 (~1e-7)
    assert rel_l2(tm.double()(torch.from_numpy(x)), out) <= 1e-6


def test_init_laws():
    """The flax init laws: spectral weights in [0, 1/(C·O)) (flax's
    ``uniform(scale)``, not symmetric), Dense biases zero, WNDense's g
    1/√3 and v within ±1/√in."""
    torch.manual_seed(0)
    fno = FNO2d(7, 3, **SMALL).requires_grad_(False)
    w = fno.SpectralConv2d_0.w_pos_re
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0 / 64
    assert float(w.max()) > 0.9 / 64  # the whole interval is drawn
    assert torch.equal(fno.Dense_0.bias, torch.zeros(8))
    assert fno.Dense_0.weight.shape == (8, 9)  # 7 channels + the grid's 2
    ffno = FFNO2d(7, 3, **SMALL).requires_grad_(False)
    assert torch.allclose(ffno.in_proj.g, torch.full((8,), 3 ** -0.5))
    assert float(ffno.in_proj.v.abs().max()) <= 9 ** -0.5
    assert float(ffno.w_x_re.min()) >= 0.0 and float(ffno.w_x_re.max()) < 1.0 / 8


def test_ffno_dropout():
    """Off in ``eval()``; in ``train()`` it draws from the generator that
    ``set_dropout_generator`` sets: the same seed gives the same output, and
    another seed another; without a generator training raises."""
    torch.manual_seed(0)
    model = FFNO2d(7, 3, **SMALL).double()
    x = torch.from_numpy(_input(16, seed=3))
    with torch.no_grad():
        eval_out = model.eval()(x)
        assert torch.equal(model(x), eval_out)
        model.train()
        with pytest.raises(RuntimeError, match="Generator"):
            model(x)
        runs = {}
        for seed in (1, 1, 2):
            model.set_dropout_generator(torch.Generator().manual_seed(seed))
            runs.setdefault(seed, []).append(model(x))
    assert torch.equal(runs[1][0], runs[1][1])
    assert not torch.equal(runs[1][0], runs[2][0])
    assert not torch.equal(runs[1][0], eval_out)
    # the law: a fraction ~0.1 of the hidden units dropped, the rest scaled
    model.set_dropout_generator(torch.Generator().manual_seed(4))
    z = torch.ones(200_000, dtype=torch.float64)
    dropped = model._dropout(z)
    assert abs(float((dropped == 0).double().mean()) - 0.1) < 0.005
    assert torch.allclose(dropped[dropped != 0], torch.full((), 1 / 0.9, dtype=torch.float64))


def _contract(n=8, t=3, s=16, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, t, s, s, 6)).astype(np.float32)
    data[..., 3:] = rng.uniform(0, 1, size=(n, 1, s, s, 3)).astype(np.float32)
    data[..., 4] = data[..., 4] > 0.8  # a binary hole mask
    return data


def _cli_lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def test_cli_fno_default_and_ffno(tmp_path, capsys):
    """``train`` with no ``--model`` trains FNO; ``evaluate`` with no
    ``--model`` reads its ``best.pt``; ``evaluate --model ffno`` reads an
    ``.npz`` of a flax FFNO tree; ``mix-sweep --model ffno`` runs; an
    unknown ``--model`` raises before any data is read. All on ``--device
    cpu``."""
    hard, easy = tmp_path / "h.npy", tmp_path / "e.npy"
    np.save(hard, _contract(seed=5))
    np.save(easy, _contract(seed=6))
    ckpt = tmp_path / "ck"
    main(["train", "--data", str(hard), "--epochs", "1", "--batch-size", "4", "--ckpt",
          str(ckpt), "--device", "cpu"])
    lines = _cli_lines(capsys)
    assert set(lines[0]["kernel_launches"].values()) == {0}
    assert lines[1]["epoch"] == 0 and np.isfinite(lines[1]["train_loss"])
    best = torch.load(ckpt / "best.pt", weights_only=True)
    assert best["Dense_0.weight"].shape == (32, 9)  # FNO's lift: 6 + time + the grid's 2
    assert "SpectralConv2d_3.w_neg_im" in best
    main(["evaluate", "--data", str(hard), "--ckpt", str(ckpt / "best.pt"), "--patterns",
          "[2];[1,1]", "--batch-size", "4", "--device", "cpu"])
    res = _cli_lines(capsys)[1]
    assert list(res["patterns"]) == ["[2]", "[1, 1]"]
    assert all(np.isfinite(v) for r in res["patterns"].values() for v in r.values())
    # an FFNO checkpoint written from a flax tree (the dataset's 7 input channels)
    jm = jffno.FFNO2d(out_channels=3)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 7)))["params"]
    npz = tmp_path / "ffno.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in
                     traverse_util.flatten_dict(params, sep="/").items()})
    main(["evaluate", "--model", "ffno", "--data", str(hard), "--ckpt", str(npz), "--patterns",
          "[1]", "--batch-size", "4", "--device", "cpu"])
    res = _cli_lines(capsys)[1]
    assert all(np.isfinite(v) for v in res["patterns"]["[1]"].values())
    main(["mix-sweep", "--model", "ffno", "--hard", str(hard), "--easy", str(easy), "--alphas",
          "0.5", "--total-trajectories", "4", "--epochs", "1", "--batch-size", "4", "--device",
          "cpu"])
    lines = _cli_lines(capsys)
    assert lines[0]["alpha"] == 0.5
    assert np.isfinite(lines[-1]["0.5"]["test_hard"]["mean_rel_%"])
    for cmd in (["train", "--data", str(hard)], ["evaluate", "--data", str(hard), "--ckpt",
                                                 str(npz)],
                ["mix-sweep", "--hard", str(hard), "--easy", str(easy)]):
        with pytest.raises(SystemExit, match="unknown model"):
            main([*cmd, "--model", "unet", "--device", "cpu"])
    with pytest.raises(ValueError, match="scOT only"):
        _make_model("fno", 16, impl="plain")
