"""The frozen plain reference against the port's plain path on the CPU at
32²–64²: the same inputs give the same answers."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from bench_fixture import ROOT  # noqa: F401  (puts the repository on the path)

from portbench.reference import geometry, plan, projection, schedules
from portbench.reference import spectral as ref

CFG = {"length": 1.0, "dt": 1e-4, "n_snapshots": 3, "include_initial": True,
       "forcing": "fno", "forcing_amplitude": 0.1, "drag": 0.0, "dealias": True}


@pytest.mark.parametrize("n", [32, 64])
def test_spectral_trajectory_and_fields(n):
    from pregen_pde_tpu_torch.core import NSVorticityConfig, SpectralGrid2D
    from pregen_pde_tpu_torch.fields.grf import grf_filter
    from pregen_pde_tpu_torch.solvers.spectral_ns import NSVorticitySolver

    g = torch.Generator().manual_seed(n)
    xi = torch.randn((3, n, n), generator=g)
    w0 = ref.grf_filter(xi, ref.Grid(n, 1.0), 2.5, 7.0)
    assert torch.equal(w0, grf_filter(xi, SpectralGrid2D(n, 1.0), 2.5, 7.0))
    nu = torch.tensor([1e-3, 2e-4, 1e-2])
    solver = NSVorticitySolver(NSVorticityConfig(resolution=n, n_snapshots=3))
    inner = np.array([4, 2, 3])
    got = ref.trajectory(w0, nu, inner, CFG)
    for i, k in enumerate(inner):
        want = solver._build_traj_packed(int(k), scheme="ab2")(w0[i:i + 1], nu[i:i + 1])
        torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)
        f = solver.fields_from_vorticity(want)
        torch.testing.assert_close(ref.fields(want, 1.0),
                                   torch.stack([f["u"], f["v"], f["p"]], dim=-1),
                                   rtol=0, atol=0)


def test_projection_steps_match_the_port():
    from pregen_pde_tpu_torch.solvers.ns_projection import ProjectionConfig, ProjectionSolver

    n = 32
    g = torch.Generator().manual_seed(3)
    mask = geometry.sample_multi_holes(g, 2, n, 2, 4, 4, 8)
    cfg = {"viscosity": 1.5e-5, "penalization_eta": 1e-3, "length": 2.0}
    for um, dt in ((0.04, 0.2), (0.07, 0.05)):
        ch = projection.Channel(cfg, mask, torch.full((2,), um), torch.full((2,), dt))
        solver = ProjectionSolver(ProjectionConfig(resolution=n, u_max=um, dt=dt))
        u, v, _ = ch.rest()
        got = ch.advance(u, v, np.array([5, 5]))
        uu, vv, pp = u, v, torch.zeros_like(u)
        for _ in range(5):
            uu, vv, pp = solver.step(uu, vv, mask, 2.0 / n, float(np.float32(dt)), um, pp)
        for a, b in zip(got, (uu, vv, pp)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        traj = solver.make_trajectory_fn()(mask, um, 5, dt)
        torch.testing.assert_close(torch.stack(ch.rest(), dim=-1), traj[:, 0], rtol=0, atol=0)


def test_geometry_and_sdf_match_the_port():
    from pregen_pde_tpu_torch.fields import geometry as port

    for n, cells in ((32, 4), (64, 8)):
        g1 = torch.Generator().manual_seed(n)
        g2 = torch.Generator().manual_seed(n)
        mine = geometry.sample_multi_holes(g1, 5, n, 2, 10, cells, 32)
        theirs, _ = port.sample_multi_holes(g2, 5, n, 2, 10, cells, 32)
        assert torch.equal(mine, theirs)
        assert torch.equal(geometry.sdf_from_mask(mine), port.sdf_from_mask(theirs))


def test_schedules_and_plan_match_the_port():
    from pregen_pde_tpu_torch.datagen import masked_ns
    from pregen_pde_tpu_torch.solvers import schedules as port

    z = torch.linspace(-3.0, 3.0, 41, dtype=torch.float64)
    re = schedules.reynolds(z, 5000.0, 2000.0)
    assert torch.equal(re, port.sample_reynolds(z=z, mean=5000.0, std=2000.0))
    assert torch.equal(schedules.end_time_from_re(re), port.end_time_from_re(re))
    assert torch.equal(schedules.normalize_re(re), port.normalize_re(re))
    cfg = masked_ns.MaskedNSConfig(pipeline="fpo_multi_hole", resolution=64)
    mine = {"length": 2.0, "resolution": 64, "dt": 0.2, "cfl_speedup": 3.5,
            "cfl_safety": 0.5, "n_snapshots": 20}
    u_max = re.numpy() * 1.5e-5 / 2.0
    end_t = schedules.end_time_from_re(re).numpy() * 0.3
    theirs = masked_ns.plan_rows(u_max, end_t, cfg)
    got = plan.plan_rows(u_max, end_t, mine)
    rows = theirs["rows"]
    np.testing.assert_array_equal(got["dt"][rows], theirs["dt"])
    np.testing.assert_array_equal(got["inner"][rows], theirs["inner"])
