"""Port parity: the Burgers and Darcy solvers, the 1-D and Darcy GRF
samplers, the heat/Burgers/Darcy dataset factories and their CLI.

The same inputs (numpy arrays, or the white noise ``jax.random`` draws
inside the JAX samplers) go through the JAX function and its PyTorch
counterpart. Where the JAX side runs in float64 (``conftest.py`` turns x64
on) the comparison is in float64.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.core.config import BurgersConfig as JaxBurgersConfig
from pregen_pde_tpu.core.grid import SpectralGrid1D as JaxGrid1D
from pregen_pde_tpu.core.grid import SpectralGrid2D as JaxGrid2D
from pregen_pde_tpu.datagen import simple as jsimple
from pregen_pde_tpu.fields import grf as jgrf
from pregen_pde_tpu.solvers import darcy as jdarcy
from pregen_pde_tpu.solvers.burgers import BurgersSolver as JaxBurgersSolver
from pregen_pde_tpu.solvers.heat import HeatConfig as JaxHeatConfig
from pregen_pde_tpu_torch.core import BurgersConfig, SpectralGrid1D, SpectralGrid2D
from pregen_pde_tpu_torch.datagen import simple as tsimple
from pregen_pde_tpu_torch.datagen.writer import load_shards
from pregen_pde_tpu_torch.fields import grf as tgrf
from pregen_pde_tpu_torch.solvers import darcy as tdarcy
from pregen_pde_tpu_torch.solvers.burgers import BurgersSolver
from pregen_pde_tpu_torch.solvers.heat import HeatConfig
from pregen_pde_tpu_torch.utils.parity import rel_l2, to_numpy

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _jax_noise(key, n_traj: int, shape) -> np.ndarray:
    """The white noise each JAX sampler draws from its split key
    (``fields/grf.py:54, 78``), float32."""
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))
                     for k in jax.random.split(key, n_traj)])


@pytest.mark.parametrize("n,alpha,tau", [(128, 2.0, 5.0), (100, 2.5, 3.0)])
def test_grf_1d_filter_matches_jax_on_jax_noise(n, alpha, tau):
    key = jax.random.key(3)
    xi = _jax_noise(key, 3, (n,))
    ref = np.stack([np.asarray(jgrf.grf_1d(k, JaxGrid1D(n), alpha=alpha, tau=tau))
                    for k in jax.random.split(key, 3)])
    got = tgrf.grf_1d_filter(torch.from_numpy(xi), SpectralGrid1D(n), alpha=alpha, tau=tau)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # float32 FFTs of two libraries: roundoff only
    assert rel_l2(got, ref) <= 1e-5


def test_grf_1d_draw_pointwise_variance():
    """The port's own 1-D draw: pointwise variance within 10% of Σ_k S(k),
    S = σ²(k² + τ²)^(−α) over the full spectrum, the zero mode removed."""
    n, B = 256, 512
    x = to_numpy(tgrf.grf_1d(torch.Generator().manual_seed(0), SpectralGrid1D(n), B))
    assert x.shape == (B, n) and x.dtype == np.float32
    k = np.fft.fftfreq(n, d=1.0 / n) * 2 * np.pi
    sigma = 5.0 ** (0.5 * (2 * 2.0 - 1))
    s = sigma**2 * (k**2 + 25.0) ** (-2.0)
    s[0] = 0.0
    x = x.astype(np.float64)
    assert abs(x.var() / s.sum() - 1.0) < 0.10, (x.var(), s.sum())
    assert np.abs(x.mean(axis=1)).max() < 1e-5 * np.sqrt(s.sum())  # h[0] = 0


@pytest.mark.parametrize("n", [32, 48])
def test_darcy_coefficients_match_jax_on_jax_noise(n):
    key = jax.random.key(n)
    keys = jax.random.split(key, 3)
    xi = torch.from_numpy(_jax_noise(key, 3, (n, n)))
    grid = SpectralGrid2D(n)
    ref = np.stack([np.asarray(jgrf.lognormal_grf_2d(k, JaxGrid2D(n))) for k in keys])
    got = tgrf.lognormal_grf_2d(xi, grid)
    assert got.dtype == torch.float32 and rel_l2(got, ref) <= 1e-5
    ref = np.stack([np.asarray(jgrf.piecewise_constant_grf_2d(k, JaxGrid2D(n))) for k in keys])
    got = to_numpy(tgrf.piecewise_constant_grf_2d(xi, grid))
    assert set(np.unique(got)) == {3.0, 12.0}
    np.testing.assert_array_equal(got, ref)


def test_burgers_matches_jax_in_f64():
    n = 128
    kw = dict(resolution=n, t_end=0.01, n_snapshots=4)
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(3, n))
    u0 = to_numpy(tgrf.grf_1d_filter(torch.from_numpy(xi), SpectralGrid1D(n)))
    ref = np.asarray(jax.vmap(JaxBurgersSolver(JaxBurgersConfig(**kw)).make_trajectory_fn())(
        jnp.asarray(u0)))
    sol = BurgersSolver(BurgersConfig(**kw))
    got = to_numpy(sol.make_batched_trajectory_fn()(torch.from_numpy(u0)))
    assert got.shape == ref.shape == (3, 5, n) and got.dtype == np.float64
    np.testing.assert_array_equal(got[:, 0], u0)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * np.abs(u0).max())
    assert rel_l2(got[:, -1], u0) > 1e-3  # the flow moved


def test_darcy_matches_jax_in_f64():
    n = 32
    jcfg = jdarcy.DarcyConfig(resolution=n, cg_iters=400)
    tcfg = tdarcy.DarcyConfig(resolution=n, cg_iters=400)
    xi = np.random.default_rng(1).normal(size=(3, n, n))
    a = to_numpy(tgrf.lognormal_grf_2d(torch.from_numpy(xi), SpectralGrid2D(n)))
    ref = np.asarray(jax.vmap(lambda ai: jdarcy.solve_darcy(ai, jcfg))(jnp.asarray(a)))
    got = tdarcy.solve_darcy(torch.from_numpy(a), tcfg)
    assert got.dtype == torch.float64 and tuple(got.shape) == (3, n, n)
    np.testing.assert_allclose(to_numpy(got), ref, rtol=1e-8, atol=1e-8 * np.abs(ref).max())
    res = to_numpy(tdarcy.residual_norm(torch.from_numpy(a), got, tcfg))
    assert res.shape == (3,) and res.max() < 1e-5
    for i in range(3):
        np.testing.assert_allclose(
            res[i], float(jdarcy.residual_norm(jnp.asarray(a[i]), jnp.asarray(ref[i]), jcfg)),
            rtol=1e-3, atol=1e-12)
    assert to_numpy(got).min() >= 0.0  # maximum principle, f > 0
    # per-sample reductions: one sample solved alone is the same solution
    alone = tdarcy.solve_darcy(torch.from_numpy(a[1]), tcfg)
    np.testing.assert_allclose(to_numpy(alone), to_numpy(got[1]), rtol=1e-12, atol=1e-15)


def test_darcy_constant_coefficient_centre():
    """a ≡ 1, f ≡ 1: the box Poisson solution, u(½, ½) ≈ 0.07367 (as
    ``test_heat_darcy.py:75-84``)."""
    n = 64
    cfg = tdarcy.DarcyConfig(resolution=n, cg_iters=800)
    a = torch.ones((1, n, n), dtype=torch.float64)
    u = tdarcy.solve_darcy(a, cfg)
    assert float(tdarcy.residual_norm(a, u, cfg)[0]) < 1e-6
    np.testing.assert_allclose(float(u[0, n // 2, n // 2]), 0.07367, rtol=2e-2)
    with pytest.raises(ValueError):
        tdarcy.solve_darcy(torch.ones((1, n, n + 1)), cfg)


@pytest.mark.parametrize("storage_dtype", ["float32", "float16"])
def test_heat_factory_matches_jax(storage_dtype):
    n, n_traj = 32, 3
    kw = dict(resolution=n, t_end=0.01)
    key = jax.random.key(5)
    ref = jsimple.generate_heat_batch(key, JaxHeatConfig(**kw), n_traj,
                                      storage_dtype=storage_dtype)
    got = tsimple.generate_heat_batch_from_noise(torch.from_numpy(_jax_noise(key, n_traj, (n, n))),
                                                 HeatConfig(**kw), storage_dtype=storage_dtype)
    assert got.dtype == ref.dtype == np.dtype(storage_dtype)
    assert got.shape == ref.shape == (n_traj, 21, n, n)
    # float32: FFT roundoff in the initial field; float16: its own rounding
    assert rel_l2(got, ref) <= (1e-5 if storage_dtype == "float32" else 1e-3)


@pytest.mark.parametrize("storage_dtype", ["float32", "float16"])
def test_burgers_factory_matches_jax(storage_dtype):
    n, n_traj = 128, 3
    kw = dict(resolution=n, t_end=0.02)
    key = jax.random.key(6)
    ref = jsimple.generate_burgers_batch(key, JaxBurgersConfig(**kw), n_traj,
                                         storage_dtype=storage_dtype)
    got = tsimple.generate_burgers_batch_from_noise(torch.from_numpy(_jax_noise(key, n_traj, (n,))),
                                                    BurgersConfig(**kw),
                                                    storage_dtype=storage_dtype)
    assert got.dtype == ref.dtype == np.dtype(storage_dtype)
    assert got.shape == ref.shape == (n_traj, 21, n)
    assert rel_l2(got, ref) <= (1e-5 if storage_dtype == "float32" else 1e-3)


@pytest.mark.parametrize("storage_dtype", ["float32", "float16"])
def test_darcy_factory_matches_jax(storage_dtype):
    n, n_traj = 32, 3
    key = jax.random.key(7)
    ref = jsimple.generate_darcy_batch(key, jdarcy.DarcyConfig(resolution=n), n_traj,
                                       storage_dtype=storage_dtype)
    got = tsimple.generate_darcy_batch_from_noise(torch.from_numpy(_jax_noise(key, n_traj, (n, n))),
                                                  tdarcy.DarcyConfig(resolution=n),
                                                  storage_dtype=storage_dtype)
    assert got.dtype == ref.dtype == np.dtype(storage_dtype)
    assert got.shape == ref.shape == (n_traj, 2, n, n)
    assert rel_l2(got, ref) <= (1e-5 if storage_dtype == "float32" else 1e-3)


def test_factories_draw_on_the_generator():
    """The generator's own draws: the shapes, finite values, a > 0, and the
    same seed gives the same batch."""
    gen = lambda: torch.Generator().manual_seed(4)
    cfg = tdarcy.DarcyConfig(resolution=16, cg_iters=50)
    a = tsimple.generate_darcy_batch(gen(), cfg, 2)
    assert a.shape == (2, 2, 16, 16) and np.isfinite(a).all() and (a[:, 0] > 0).all()
    np.testing.assert_array_equal(a, tsimple.generate_darcy_batch(gen(), cfg, 2))
    pw = tsimple.generate_darcy_batch(gen(), cfg, 2, lognormal=False)
    assert set(np.unique(pw[:, 0])) <= {3.0, 12.0}
    b = tsimple.generate_burgers_batch(gen(), BurgersConfig(resolution=32, t_end=1e-3), 2)
    h = tsimple.generate_heat_batch(gen(), HeatConfig(resolution=16, t_end=1e-3), 2,
                                    storage_dtype="float16")
    assert b.shape == (2, 21, 32) and h.shape == (2, 21, 16, 16) and h.dtype == np.float16
    assert np.isfinite(b).all() and np.isfinite(h).all()


def test_cli_simple_workloads_write_shards(tmp_path, capsys):
    from pregen_pde_tpu_torch.__main__ import main

    base = ["--resolution", "16", "--batch-size", "2", "--device", "cpu"]
    for workload, shape in (("heat", (3, 21, 16, 16)), ("burgers", (3, 21, 16)),
                            ("darcy", (3, 2, 16, 16))):
        out = tmp_path / workload
        main(["generate", "--workload", workload, "--n", "3", "--out", str(out), *base])
        data = load_shards(out)
        assert data.shape == shape and data.dtype == np.float32 and np.isfinite(data).all()
        lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
        assert lines[0] == {"kernel_launches": {"spectral_ns_step": 0,
                                                "ns_projection_step": 0, "stencil": 0}}
        assert lines[1]["generated"] == 3 and lines[1]["workload"] == workload
    out = tmp_path / "darcy"
    data = load_shards(out)
    main(["generate", "--workload", "darcy", "--n", "5", "--resume", "--out", str(out), *base])
    assert load_shards(out).shape == (5, 2, 16, 16)
    np.testing.assert_array_equal(load_shards(out)[:3], data)
    for workload in ("heat", "burgers", "darcy"):
        with pytest.raises(SystemExit):
            main(["generate", "--workload", workload, "--method", "cn_ab2_packed",
                  "--out", str(tmp_path / "x"), *base])
