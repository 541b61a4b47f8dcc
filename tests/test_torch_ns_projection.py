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

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

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
    got = tval.run_cavity(100, n=32, t_end=12.0, device="cpu")
    assert got["steps"] == 1000
    for key in ("u_model", "v_model"):
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-5)
    for key in ("max_abs_dev_u", "max_abs_dev_v", "u_min_model", "v_min_model"):
        assert abs(got[key] - ref[key]) <= 1e-5, key


# per-image (dt, inner_steps): two groups, interleaved in the batch
MIXED_DT = np.array([0.004, 0.002, 0.004, 0.002])
MIXED_STEPS = np.array([2, 3, 2, 3])


def _mixed_inputs(dtype):
    rng = np.random.default_rng(5)
    mask = np.stack([np.asarray(jdisk(N, 16.0, 8.0 + 2 * i, 4.0), np.float64)
                     for i in range(4)])
    um = rng.uniform(0.5, 1.5, size=4)
    return to_torch(mask, dtype=dtype), to_torch(um, dtype=dtype)


@pytest.mark.parametrize("domain", DOMAINS)
def test_batched_per_image_dt_steps_equals_grouped_calls(domain):
    """The plain batched trajectory with one (dt, inner_steps) per image is
    the scalar call of each group, stacked, to the bit; the CUDA wrapper
    runs it for CPU tensors."""
    _, tsol = _solvers(domain, n_snapshots=2)
    masks, um = _mixed_inputs(torch.float32)
    traj = tsol.make_batched_trajectory_fn()
    got = traj(masks, um, torch.as_tensor(MIXED_STEPS), torch.as_tensor(MIXED_DT))
    assert got.shape == (4, 3, N, N, 3) and got.dtype == torch.float32
    for dt, k in ((0.004, 2), (0.002, 3)):
        idx = torch.as_tensor(np.nonzero(MIXED_DT == dt)[0])
        ref = traj(masks[idx], um[idx], k, dt)
        assert torch.equal(got[idx], ref)
    npc.reset_launches()
    wrapped = npc.build_batched_traj(tsol)(masks, um, MIXED_STEPS, MIXED_DT)
    assert npc.launches == 0 and torch.equal(wrapped, got)
    # scalars and (B,) arrays of one value give the same batch
    same = traj(masks, um, np.full(4, 2), np.full(4, 0.004))
    assert torch.equal(same, traj(masks, um, 2, 0.004))
    with pytest.raises(ValueError, match="inner_steps"):
        traj(masks, um, np.array([2, -1, 2, 2]), MIXED_DT)


def test_plain_trajectory_writes_into_contract_rows():
    """Given a 6- or 4-channel contract and permuted rows, the plain batched
    trajectory (and the CUDA wrapper on CPU tensors) stores each image's
    frames into channels 0:3 of its row, byte-equal to the default route
    scattered there, and leaves every other byte alone; a contract or rows
    it cannot write raise."""
    _, tsol = _solvers("channel", n_snapshots=2)
    masks, um = _mixed_inputs(torch.float32)
    traj = tsol.make_batched_trajectory_fn()
    ref = traj(masks, um, torch.as_tensor(MIXED_STEPS), torch.as_tensor(MIXED_DT)).numpy()
    rows = np.array([5, 0, 3, 1])
    for fn in (traj, npc.build_batched_traj(tsol)):
        for c in (6, 4):
            out = torch.full((6, 3, N, N, c), 7.0)
            got = fn(masks, um, torch.as_tensor(MIXED_STEPS), torch.as_tensor(MIXED_DT),
                     out=out, out_rows=torch.as_tensor(rows, dtype=torch.int32))
            want = np.full((6, 3, N, N, c), 7.0, np.float32)
            want[rows, ..., 0:3] = ref
            assert got is out and got.numpy().tobytes() == want.tobytes()
    ok = torch.zeros((6, 3, N, N, 6))
    for bad_out, bad_rows, match in (
            (torch.zeros((6, 3, N, N, 2)), rows, "contiguous float32"),
            (torch.zeros((6, 4, N, N, 6)), rows, "contiguous float32"),
            (ok.double(), rows, "contiguous float32"),
            (torch.zeros((6, 3, N, N, 12))[..., ::2], rows, "contiguous float32"),
            (ok, None, "out_rows"),
            (ok, np.array([5, 0, 3, 5]), "distinct rows"),
            (ok, np.array([5, 0, 3, 6]), "distinct rows"),
            (ok, np.array([5, 0, -1, 1]), "distinct rows"),
            (ok, rows[:3], "distinct rows")):
        with pytest.raises(ValueError, match=match):
            traj(masks, um, 2, 0.004, out=bad_out, out_rows=bad_rows)


def _jax_traj_f64(jsol, mask, u_max, inner, dt):
    """make_trajectory_fn's loop (rest + BCs, then ``inner`` JAX steps per
    snapshot) in float64: JAX's own function fixes a float32 carry."""
    n = jsol.cfg.resolution
    dx = jsol.cfg.length / n
    z = jnp.zeros((n, n), jnp.float64)
    u, v = jsol.apply_velocity_bc(z, z, u_max)
    p = z
    frames = [jnp.stack([u, v, p], axis=-1)]
    for _ in range(jsol.cfg.n_snapshots):
        for _ in range(inner):
            u, v, p = jsol.step(u, v, mask, dx, dt, u_max, p_prev=p)
        frames.append(jnp.stack([u, v, p], axis=-1))
    return jnp.stack(frames)


@pytest.mark.parametrize("domain", DOMAINS)
def test_batched_per_image_dt_steps_matches_jax_f64(domain):
    """Each image of the per-image batch against JAX on that image with its
    own dt and inner steps: make_trajectory_fn's loop in float64 (dt rounded
    to float32 in both) at 1e-10, and make_trajectory_fn itself in float32."""
    jsol, tsol = _solvers(domain, n_snapshots=2)
    traj = tsol.make_batched_trajectory_fn()
    steps, dts = torch.as_tensor(MIXED_STEPS), torch.as_tensor(MIXED_DT)
    masks, um = _mixed_inputs(torch.float64)
    got = traj(masks, um, steps, dts)
    _close(got, [_jax_traj_f64(jsol, jnp.asarray(to_numpy(masks[i])), float(um[i]),
                               int(MIXED_STEPS[i]), float(np.float32(MIXED_DT[i])))
                 for i in range(4)])
    masks, um = _mixed_inputs(torch.float32)
    got = to_numpy(traj(masks, um, steps, dts))
    jtraj = jsol.make_trajectory_fn()
    for i in range(4):
        ref = np.asarray(jtraj(jnp.asarray(to_numpy(masks[i])), jnp.float32(um[i]),
                               int(MIXED_STEPS[i]), float(MIXED_DT[i])))
        assert np.abs(got[i] - ref).max() / np.abs(ref).max() <= 1e-5


@pytest.mark.parametrize("n", [32, 128])
def test_k2_fragment_order_layout(n):
    """The bases the CUDA stepper reads in fragment order: the float4 of
    (k-pair kp, tile j, lane 4g + t) holds the lane's m16n8k8 B fragments of
    k-steps 2kp and 2kp + 1, and the flat layout is the kernel's
    ``frag_index``."""
    m = torch.as_tensor(np.random.default_rng(n).normal(size=(n, n)), dtype=torch.float32)
    f = npc.fragment_order(m)
    assert f.shape == (n // 16, n // 8, 32, 4) and f.is_contiguous()
    for kp, j, g, t in ((0, 0, 0, 0), (n // 16 - 1, n // 8 - 1, 7, 3), (1, 2, 5, 1)):
        want = [m[16 * kp + t, 8 * j + g], m[16 * kp + t + 4, 8 * j + g],
                m[16 * kp + 8 + t, 8 * j + g], m[16 * kp + 12 + t, 8 * j + g]]
        assert f[kp, j, 4 * g + t].tolist() == [float(w) for w in want]
    # frag_index(r, c) of a 16-row slab (csrc/ns_projection_step.cu)
    r, c = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    idx = ((((c >> 3) * 32 + (c & 7) * 4 + (r & 3)) << 2) + ((r >> 3) << 1) + ((r >> 2) & 1))
    flat = f.reshape(n // 16, -1).numpy()
    for kp in range(n // 16):
        np.testing.assert_array_equal(flat[kp][idx], m[16 * kp:16 * kp + 16].numpy())
