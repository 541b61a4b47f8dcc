"""The port's cylinder and grid-convergence checks
(``pregen_pde_tpu_torch/solvers/validation.py``) against the JAX package's,
on the CPU through the plain projection stepper.

Both packages run the same float32 solver from rest on the same geometry,
so the short-horizon results agree to float32 roundoff (measured: equal to
the last bit for the cylinder, 1e-7 relative for the convergence errors).
The cylinder's full horizon (34,000 steps at 128², 6.7 GB of frames) runs
on the card only (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from pregen_pde_tpu.solvers import validation as jval
from pregen_pde_tpu_torch.solvers import validation as tval

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

# n = 64, 6-cell cylinder: a t_end of exactly 2,000 steps of its dt
CYL_N, CYL_D = 64, 6
CYL_DT = 0.3 * (2.0 / CYL_N) / 2.0
CYL_T_END = 2000.5 * CYL_DT
CYL_RTOL = 1e-4    # cd_mean and the amplitude, relative (measured 0)
ERR_RTOL = 1e-5    # e_coarse and e_fine, relative (measured 1.0e-7)


def test_run_cylinder_short_horizon_matches_jax():
    """2,000 steps at n = 64 with a 6-cell cylinder: the drag coefficient and
    the probe's amplitude within 1e-4 relative, and the Strouhal number in
    the same spectral bin."""
    t = tval.run_cylinder(150.0, n=CYL_N, t_end=CYL_T_END, diameter_cells=CYL_D, device="cpu")
    j = jval.run_cylinder(150.0, n=CYL_N, t_end=CYL_T_END, diameter_cells=CYL_D)
    assert t["steps"] == 2000
    assert set(j) <= set(t)
    for key in ("re_d", "n", "advection", "diameter", "dt", "t_end"):
        assert t[key] == j[key], key
    for key in ("cd_mean", "shedding_amplitude"):
        assert np.isfinite(t[key])
        assert abs(t[key] - j[key]) <= CYL_RTOL * abs(j[key]), (key, t[key], j[key])
    # one bin of the 800-sample tail is 1/(800 dt) wide: the same bin is the same value
    bin_st = 1.0 / (800 * CYL_DT) * (CYL_D * 2.0 / CYL_N)
    assert abs(t["strouhal"] - j["strouhal"]) < 1e-3 * bin_st, (t["strouhal"], j["strouhal"])


def test_run_cylinder_counts_whole_chunks():
    """JAX runs whole chunks of 1000 steps; a horizon under one chunk has
    nothing to measure and raises."""
    with pytest.raises(ValueError, match="chunk"):
        tval.run_cylinder(150.0, n=32, t_end=999.5 * 0.3 * (2.0 / 32) / 2.0, device="cpu")


def test_convergence_order_short_matches_jax():
    """The Richardson triplet at t_end 0.05 (41 steps of the shared dt):
    the coarse and fine errors within 1e-5 relative of JAX's."""
    t = tval.convergence_order(t_end=0.05, device="cpu")
    j = jval.convergence_order(t_end=0.05)
    assert t["steps"] == 41 and t["ns"] == j["ns"]
    for key in ("e_coarse", "e_fine"):
        assert abs(t[key] - j[key]) <= ERR_RTOL * j[key], (key, t[key], j[key])
    assert abs(t["order"] - j["order"]) <= 1e-4


def test_convergence_order_full():
    """The JAX package's tier-1 bar on the port's plain route: the observed
    spatial order on 32/64/128 at t_end 1.0 (819 steps) above 1.3
    (measured 1.497)."""
    r = tval.convergence_order(device="cpu")
    assert r["steps"] == 819
    assert r["order"] > 1.3, r


def test_validation_raises_for_an_absent_card():
    """The card is the default and is never replaced by the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for fn in (tval.run_cylinder, tval.convergence_order, tval.run_cavity):
        args = (100.0,) if fn is tval.run_cavity else ()
        with pytest.raises(RuntimeError, match="cuda"):
            fn(*args)
