"""Port parity: the periodic stencils (K5a, K5b) and the heat solver.

The plain versions of the two kernels are held against the JAX package's
Pallas kernels in interpret mode on the CPU (as ``test_heat_darcy.py`` runs
them), and ``HeatSolver`` against the JAX solver in float64, on the same
numpy inputs. The CUDA kernels themselves are held against the plain
versions on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.ops.stencil import heat_step_pallas, laplacian_pallas
from pregen_pde_tpu.solvers.heat import HeatConfig as JaxHeatConfig
from pregen_pde_tpu.solvers.heat import HeatSolver as JaxHeatSolver
from pregen_pde_tpu_torch.core import SpectralGrid2D
from pregen_pde_tpu_torch.fields.grf import grf_filter
from pregen_pde_tpu_torch.ops import stencil
from pregen_pde_tpu_torch.solvers.heat import HeatConfig, HeatSolver, laplacian_roll
from pregen_pde_tpu_torch.utils.parity import rel_l2, to_numpy, to_torch

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _grf(n: int, batch: int, seed: int, dtype=np.float64) -> np.ndarray:
    """Smooth periodic fields (the heat workload's initial conditions)."""
    xi = np.random.default_rng(seed).normal(size=(batch, n, n))
    return to_numpy(grf_filter(torch.from_numpy(xi), SpectralGrid2D(n))).astype(dtype)


# 30, 33, 5, 7: n not a multiple of 4 (odd for the last three), the card's
# general route; 32 its row route's float4 width
@pytest.mark.parametrize("n", [32, 30, 33, 5, 7])
def test_plain_laplacian_matches_pallas_kernel(n):
    u = _grf(n, 2, seed=n, dtype=np.float32)
    dx = 1.0 / n
    ref = np.stack([np.asarray(laplacian_pallas(jnp.asarray(ui), dx)) for ui in u])
    got = stencil.laplacian(torch.from_numpy(u), dx)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # the same float32 operations in the same order: roundoff only
    assert rel_l2(got, ref) <= 1e-6


@pytest.mark.parametrize("reaction", [0.0, 1.0])
@pytest.mark.parametrize("n", [32, 30])
def test_plain_heat_step_matches_pallas_kernel(n, reaction):
    u = _grf(n, 2, seed=7 + n, dtype=np.float32)
    dx, D, dt = 1.0 / n, 1e-2, 1e-4
    ref = np.stack([np.asarray(heat_step_pallas(jnp.asarray(ui), dx, D, dt, reaction))
                    for ui in u])
    got = stencil.heat_step(torch.from_numpy(u), dx, D, dt, reaction)
    assert got.dtype == torch.float32
    assert rel_l2(got, ref) <= 1e-6
    # the step moved the field by far more than the tolerance
    assert rel_l2(ref, u) > 1e-4


def test_cpu_wrappers_run_the_plain_versions():
    """For a CPU tensor the wrappers are the plain versions, bit for bit, and
    launch nothing; ``heat_advance`` leaves its input unwritten and fills
    ``frame``."""
    n = 24
    u = torch.from_numpy(_grf(n, 3, seed=3, dtype=np.float32))
    u_copy = u.clone()
    stencil.reset_launches()
    torch.testing.assert_close(stencil.laplacian_cuda(u, 1 / n), stencil.laplacian(u, 1 / n),
                               rtol=0, atol=0)
    torch.testing.assert_close(stencil.heat_step_cuda(u, 1 / n, 1e-2, 1e-4, 1.0),
                               stencil.heat_step(u, 1 / n, 1e-2, 1e-4, 1.0), rtol=0, atol=0)
    out = torch.zeros((3, 4, n, n))
    got = stencil.heat_advance(u, 3, 1 / n, 1e-2, 1e-4, 1.0, frame=out[:, 2])
    ref = u
    for _ in range(3):
        ref = stencil.heat_step(ref, 1 / n, 1e-2, 1e-4, 1.0)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(out[:, 2], ref, rtol=0, atol=0)
    assert (out[:, [0, 1, 3]] == 0).all()
    torch.testing.assert_close(u, u_copy, rtol=0, atol=0)
    assert stencil.launches == 0
    with pytest.raises(ValueError, match="steps"):
        stencil.heat_advance(u, 0, 1 / n, 1e-2, 1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        stencil._as_batch(u)


@pytest.mark.parametrize("reaction", [0.0, 1.0])
def test_heat_solver_matches_jax_in_f64(reaction):
    n = 32
    kw = dict(resolution=n, diffusivity=1e-2, reaction=reaction, t_end=0.02, n_snapshots=4)
    jsol = JaxHeatSolver(JaxHeatConfig(**kw))
    tsol = HeatSolver(HeatConfig(**kw), impl="plain")
    u0 = _grf(n, 2, seed=11)
    ut = torch.from_numpy(u0)
    assert ut.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(tsol.rhs(ut)),
                               np.stack([np.asarray(jsol.rhs(jnp.asarray(x))) for x in u0]),
                               rtol=1e-10, atol=1e-10 * np.abs(u0).max() * n * n)
    np.testing.assert_allclose(
        to_numpy(tsol.step_heun(ut, 1e-4)),
        np.stack([np.asarray(jsol.step_heun(jnp.asarray(x), jnp.float64(1e-4))) for x in u0]),
        rtol=1e-10)
    ref = np.asarray(jsol.make_batched_trajectory_fn()(jnp.asarray(u0)))
    got = to_numpy(tsol.make_batched_trajectory_fn()(ut))
    assert got.shape == ref.shape == (2, 5, n, n)
    np.testing.assert_array_equal(got[:, 0], u0)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * np.abs(u0).max())
    single = to_numpy(tsol.make_trajectory_fn()(ut[0]))
    np.testing.assert_allclose(single, ref[0], rtol=1e-10, atol=1e-12 * np.abs(u0).max())


@pytest.mark.parametrize("reaction", [0.0, 1.0])
def test_plain_heat_trajectory_matches_jax_in_f64(reaction):
    """K5b's trajectory, plain (``heat_trajectory`` on a CPU tensor), against
    the JAX solver's batched trajectory in float64: frame 0 is u0, then one
    frame a snapshot."""
    n = 32
    kw = dict(resolution=n, diffusivity=1e-2, reaction=reaction, t_end=0.003, n_snapshots=3)
    jsol = JaxHeatSolver(JaxHeatConfig(**kw))
    S, inner = HeatSolver(HeatConfig(**kw)).steps()
    u0 = _grf(n, 2, seed=13)
    ref = np.asarray(jsol.make_batched_trajectory_fn()(jnp.asarray(u0)))
    got = to_numpy(stencil.heat_trajectory(torch.from_numpy(u0), S, inner, 1.0 / n, 1e-2, 1e-4,
                                           reaction))
    assert got.shape == ref.shape == (2, S + 1, n, n) and inner == 10
    np.testing.assert_array_equal(got[:, 0], u0)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * np.abs(u0).max())


def test_cpu_heat_trajectory_is_the_plain_version():
    """For a CPU tensor ``heat_trajectory`` is ``heat_trajectory_plain`` bit
    for bit, fills ``out``, leaves u0 unwritten and launches nothing."""
    n = 20
    u0 = torch.from_numpy(_grf(n, 3, seed=4, dtype=np.float32))
    u_copy = u0.clone()
    stencil.reset_launches()
    ref = stencil.heat_trajectory_plain(u0, 3, 4, 1 / n, 1e-2, 1e-4, 1.0)
    got = stencil.heat_trajectory(u0, 3, 4, 1 / n, 1e-2, 1e-4, 1.0)
    out = torch.zeros((3, 4, n, n))
    assert stencil.heat_trajectory(u0, 3, 4, 1 / n, 1e-2, 1e-4, 1.0, out=out) is out
    for x in (got, out):
        torch.testing.assert_close(x, ref, rtol=0, atol=0)
    manual = u0
    for _ in range(8):
        manual = stencil.heat_step(manual, 1 / n, 1e-2, 1e-4, 1.0)
    torch.testing.assert_close(ref[:, 2], manual, rtol=0, atol=0)
    torch.testing.assert_close(ref[:, 0], u0, rtol=0, atol=0)
    torch.testing.assert_close(u0, u_copy, rtol=0, atol=0)
    assert stencil.launches == 0
    with pytest.raises(ValueError, match="inner"):
        stencil.heat_trajectory(u0, 3, 0, 1 / n, 1e-2, 1e-4)


@pytest.mark.parametrize("reaction", [0.0, 1.0])
def test_kernel_routes_agree_with_plain_on_cpu(reaction):
    """The K5a ("laplacian") and K5b ("fused") routes run their plain
    versions on the CPU: the same trajectory to float64 roundoff."""
    n = 32
    cfg = HeatConfig(resolution=n, diffusivity=1e-2, reaction=reaction, t_end=0.02,
                     n_snapshots=4)
    u0 = torch.from_numpy(_grf(n, 2, seed=5))
    ref = HeatSolver(cfg, impl="plain").make_batched_trajectory_fn()(u0)
    for impl in ("laplacian", "fused", "auto"):
        got = HeatSolver(cfg, impl=impl).make_batched_trajectory_fn()(u0)
        assert rel_l2(got, ref) <= 1e-10, impl


def test_routes_and_step_count():
    sol = HeatSolver(HeatConfig())
    assert sol.route("cpu") == "plain" and sol.route(torch.device("cuda")) == "fused"
    assert HeatSolver(HeatConfig(), impl="laplacian").route("cuda") == "laplacian"
    # round(t_end/dt) = 10,000 steps, not 9,999; 20 snapshots of 500
    assert sol.steps() == (20, 500)
    # the remainder of total // S is dropped; at least one step a snapshot
    assert HeatSolver(HeatConfig(t_end=0.0023, n_snapshots=4)).steps() == (4, 5)
    assert HeatSolver(HeatConfig(t_end=1e-4, n_snapshots=4)).steps() == (4, 1)
    with pytest.raises(ValueError, match="impl"):
        HeatSolver(HeatConfig(), impl="pallas")


def test_laplacian_roll_matches_jax_formula():
    from pregen_pde_tpu.solvers.heat import laplacian_roll as jax_laplacian_roll

    u = _grf(30, 2, seed=2)
    np.testing.assert_array_equal(to_numpy(laplacian_roll(torch.from_numpy(u), 1 / 30)),
                                  np.asarray(jax_laplacian_roll(jnp.asarray(u), 1 / 30)))


def test_heat_analytic_mode_decay():
    """sin·sin decays at the discrete operator's eigenvalue (as
    ``test_heat_darcy.py:60-72``), through every route on the CPU."""
    n, D = 64, 1e-2
    cfg = HeatConfig(resolution=n, diffusivity=D, dt=1e-4, t_end=0.1, n_snapshots=2)
    x = np.arange(n) / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    u0 = np.sin(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    lam = (2.0 * n**2) * (1 - np.cos(2 * np.pi / n)) * 2
    expected = u0 * np.exp(-D * lam * 0.1)
    for impl in ("plain", "fused"):
        snaps = to_numpy(HeatSolver(cfg, impl=impl).make_trajectory_fn()(to_torch(u0)))
        np.testing.assert_allclose(snaps[-1], expected, atol=2e-5)


def test_heat_decay_to_mean():
    """Diffusion shrinks the variance and conserves the mean (as
    ``test_heat_darcy.py:47-57``)."""
    cfg = HeatConfig(resolution=32, diffusivity=0.05, dt=1e-4, t_end=0.05, n_snapshots=5)
    u0 = torch.from_numpy(_grf(32, 2, seed=0))
    for impl in ("plain", "fused"):
        snaps = to_numpy(HeatSolver(cfg, impl=impl).make_batched_trajectory_fn()(u0))
        var = snaps.var(axis=(2, 3))
        assert np.all(np.diff(var, axis=1) < 0)
        mean = snaps.mean(axis=(2, 3))
        assert np.abs(mean - mean[:, :1]).max() <= 1e-10
