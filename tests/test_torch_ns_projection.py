"""Port parity: the masked-geometry projection solver, module by module in
float64 at 32², the CUDA stepper's plain path against the Pallas kernel in
interpret mode at 128², and the cavity validation (``run_cavity``).

The JAX solver works on one image; the port is batched, so each check runs
a batch of two images with their own u_max through the port and each image
through JAX.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.fields.geometry import disk_mask as jdisk
from pregen_pde_tpu.solvers import ns_projection as jnsp
from pregen_pde_tpu.solvers import ns_projection_pallas as npp
from pregen_pde_tpu.solvers import validation as jval
from pregen_pde_tpu_torch.solvers import ns_projection as tnsp
from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc
from pregen_pde_tpu_torch.solvers import validation as tval
from pregen_pde_tpu_torch.utils.parity import to_numpy, to_torch

N = 32
F64_BAR = 1e-10
DOMAINS = ["channel", "cavity"]


def _solvers(domain, **kw):
    j = jnsp.ProjectionConfig(resolution=N, domain=domain, viscosity=0.01, **kw)
    t = tnsp.ProjectionConfig(**dataclasses.asdict(j))
    return jnsp.ProjectionSolver(j), tnsp.ProjectionSolver(t)


def _inputs(seed=0):
    """Two images of random u, v, rhs and masks (a disk and none), float64."""
    rng = np.random.default_rng(seed)
    u, v, rhs = (rng.normal(size=(2, N, N)) for _ in range(3))
    mask = np.stack([np.asarray(jdisk(N, 16.0, 8.0, 4.0), np.float64), np.zeros((N, N))])
    return u, v, rhs, mask, np.asarray([0.7, 1.3])


def _close(got, refs, bar=F64_BAR):
    """got: the port's batch; refs: JAX's per-image results."""
    ref = np.stack([np.asarray(r) for r in refs])
    got = to_numpy(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float64
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)
    assert err <= bar, err


def _t(a):
    return to_torch(a, dtype=torch.float64)


@pytest.mark.parametrize("domain", DOMAINS)
def test_constants_match_jax(domain):
    jsol, tsol = _solvers(domain)
    c = tnsp.constants(tsol, torch.float64)
    cy, ly, cx, lx = jnsp.ProjectionSolver._eigen_basis(N, domain)
    dx = 2.0 / N
    denom = (ly[:, None] + lx[None, :]) / (dx * dx)
    if domain == "cavity":
        denom[0, 0] = 1.0
    for name, ref in (("cy", cy), ("cyT", cy.T), ("cx", cx), ("cxT", cx.T),
                      ("denom", denom), ("inlet", jnsp.parabolic_inlet(N, 1.0))):
        np.testing.assert_array_equal(to_numpy(c[name]), np.asarray(ref, np.float64), name)
    # float32 constants are the float64 ones cast once
    c32 = tnsp.constants(tsol, torch.float32)
    np.testing.assert_array_equal(to_numpy(c32["cx"]), cx.astype(np.float32))
    np.testing.assert_array_equal(tnsp.parabolic_inlet(N, 2.0), jnsp.parabolic_inlet(N, 2.0))


@pytest.mark.parametrize("domain", DOMAINS)
def test_bc_gradients_laplacian_predictor_f64(domain):
    u, v, _, _, um = _inputs(1)
    for adv in ("muscl", "upwind2", "upwind1"):
        jsol, tsol = _solvers(domain, advection=adv)
        dx, dt = 2.0 / N, 0.01
        for k in (0, 1):
            _close(tsol.apply_velocity_bc(_t(u), _t(v), _t(um))[k],
                   [jsol.apply_velocity_bc(jnp.asarray(u[i]), jnp.asarray(v[i]), um[i])[k]
                    for i in range(2)])
        for axis in (0, 1):
            _close(tsol._grad_adv(_t(u), _t(v), axis, dx),
                   [jsol._grad_adv(jnp.asarray(u[i]), jnp.asarray(v[i]), axis, dx)
                    for i in range(2)])
        _close(tsol._laplacian(_t(u), dx), [jsol._laplacian(jnp.asarray(u[i]), dx)
                                            for i in range(2)])
        for k in (0, 1):
            _close(tsol.predictor(_t(u), _t(v), dx, dt)[k],
                   [jsol.predictor(jnp.asarray(u[i]), jnp.asarray(v[i]), dx, dt)[k]
                    for i in range(2)])


@pytest.mark.parametrize("domain", DOMAINS)
def test_pressure_solves_f64(domain):
    _, _, rhs, _, _ = _inputs(2)
    jsol, tsol = _solvers(domain, cg_iters=200)
    dx = 2.0 / N
    _close(tsol._poisson_A(_t(rhs), dx), [jsol._poisson_A(jnp.asarray(r), dx) for r in rhs])
    p = tsol.solve_pressure_direct(_t(rhs), dx)
    _close(p, [jsol.solve_pressure_direct(jnp.asarray(r), dx) for r in rhs])
    # the eigen solve inverts the discrete operator to machine precision
    expected = _t(rhs) - (_t(rhs).mean(dim=(-2, -1), keepdim=True)
                          if domain == "cavity" else 0.0)
    assert float((tsol._poisson_A(p, dx) - expected).abs().max()) < 1e-10
    # CG, cold and warm started; images converge after different counts
    _close(tsol.solve_pressure(_t(rhs), dx),
           [jsol.solve_pressure(jnp.asarray(r), dx) for r in rhs])
    warm = 0.9 * to_numpy(p)
    _close(tsol.solve_pressure(_t(rhs), dx, p_init=_t(warm)),
           [jsol.solve_pressure(jnp.asarray(r), dx, p_init=jnp.asarray(w))
            for r, w in zip(rhs, warm)])


@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("solver", ["direct", "cg"])
def test_step_f64(domain, solver):
    u, v, _, mask, um = _inputs(3)
    u, v = 0.1 * u, 0.1 * v
    jsol, tsol = _solvers(domain, pressure_solver=solver, cg_iters=100)
    dx, dt = 2.0 / N, 0.004
    got = tsol.step(_t(u), _t(v), _t(mask), dx, dt, _t(um), p_prev=_t(0 * u))
    refs = [jsol.step(jnp.asarray(u[i]), jnp.asarray(v[i]), jnp.asarray(mask[i]), dx, dt,
                      um[i], p_prev=jnp.zeros((N, N), jnp.float64)) for i in range(2)]
    for k in range(3):
        _close(got[k], [r[k] for r in refs])
    div = tsol.divergence(got[0], got[1], dx)
    _close(div, [jsol.divergence(r[0], r[1], dx) for r in refs])


@pytest.mark.parametrize("domain", DOMAINS)
def test_k2_plain_path_matches_pallas_interpret(domain):
    """The CUDA stepper's wrapper on CPU tensors (its plain version) against
    the Pallas kernel in interpret mode (tests/test_ns_projection_pallas.py)."""
    n = 128
    cfg = dict(resolution=n, domain=domain, dt=0.02, t_end=0.2, n_snapshots=2,
               pressure_solver="direct")
    jsol = jnsp.ProjectionSolver(jnsp.ProjectionConfig(**cfg))
    tsol = tnsp.ProjectionSolver(tnsp.ProjectionConfig(**cfg))
    mask = (np.asarray(jdisk(n, 64.0, 32.0, 8.0), np.float32) if domain == "channel"
            else np.zeros((n, n), np.float32))
    masks = np.broadcast_to(mask, (2, n, n))
    umax = np.asarray([0.0375, 0.05], np.float32)
    ref = np.asarray(npp.build_batched_traj(jsol)(
        jnp.asarray(masks), jnp.asarray(umax), jnp.asarray(3, jnp.int32),
        jnp.asarray(0.02, jnp.float32)))
    npc.reset_launches()
    got = to_numpy(npc.build_batched_traj(tsol)(to_torch(masks), to_torch(umax), 3, 0.02))
    assert npc.launches == 0  # CPU tensors run the plain version
    assert got.shape == ref.shape == (2, 3, n, n, 3) and got.dtype == np.float32
    # the Pallas kernel's refinement step reorders float32 roundoff (~1e-5)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


def test_k2_supported_gating():
    cfg = tnsp.ProjectionConfig
    ok = lambda **kw: npc.supported(tnsp.ProjectionSolver(cfg(**kw)))
    assert ok(resolution=128) and ok(resolution=256) and ok(resolution=32)
    assert ok(resolution=128, domain="cavity", advection="upwind1")
    assert not ok(resolution=128, pressure_solver="cg")
    assert not ok(resolution=128, advection="upwind2")
    assert not ok(resolution=96 + 16) and not ok(resolution=512)
    with pytest.raises(ValueError, match="n = 512"):
        npc.build_batched_traj(tnsp.ProjectionSolver(cfg(resolution=512)))


def test_trajectory_single_and_batched_match_jax():
    """make_trajectory_fn on one image and the batched form against JAX's
    make_trajectory_fn (float32)."""
    jsol, tsol = _solvers("channel", dt=0.01, t_end=0.04, n_snapshots=2)
    _, _, _, mask, um = _inputs(4)
    mask32 = mask.astype(np.float32)
    ref = [np.asarray(jsol.make_trajectory_fn()(jnp.asarray(mask32[i]), jnp.float32(um[i])))
           for i in range(2)]
    one = to_numpy(tsol.make_trajectory_fn()(to_torch(mask32[0]), float(np.float32(um[0]))))
    assert one.shape == ref[0].shape == (3, N, N, 3) and one.dtype == np.float32
    batch = to_numpy(tsol.make_batched_trajectory_fn()(to_torch(mask32),
                                                       to_torch(um, dtype=torch.float32)))
    for got, r in ((one, ref[0]), (batch[0], ref[0]), (batch[1], ref[1])):
        assert np.abs(got - r).max() / np.abs(r).max() <= 1e-5


def test_run_cavity_matches_jax_and_ghia_tables():
    for name in ("GHIA_Y", "GHIA_X"):
        np.testing.assert_array_equal(getattr(tval, name), getattr(jval, name))
    for re in (100, 400):
        np.testing.assert_array_equal(tval.GHIA_U[re], jval.GHIA_U[re])
        np.testing.assert_array_equal(tval.GHIA_V[re], jval.GHIA_V[re])
    # one 1000-step chunk at 32² (t_end 12 / dt 0.00625 → 1920 steps → 1 chunk)
    ref = jval.run_cavity(100, n=32, t_end=12.0)
    got = tval.run_cavity(100, n=32, t_end=12.0)
    assert got["steps"] == 1000
    for key in ("u_model", "v_model"):
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-5)
    for key in ("max_abs_dev_u", "max_abs_dev_v", "u_min_model", "v_min_model"):
        assert abs(got[key] - ref[key]) <= 1e-5, key
