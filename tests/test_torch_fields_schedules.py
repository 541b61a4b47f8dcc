"""Port parity: GRF sampler, difficulty schedules and the no-hole SDF.

The same inputs, made with numpy or with ``jax.random`` exactly as the JAX
package draws them, go through the JAX function and its PyTorch counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.core.grid import SpectralGrid2D as JaxGrid
from pregen_pde_tpu.fields import geometry as jgeo
from pregen_pde_tpu.fields.grf import grf_2d as jax_grf_2d
from pregen_pde_tpu.solvers import schedules as jsched
from pregen_pde_tpu_torch.core import SpectralGrid2D
from pregen_pde_tpu_torch.fields import geometry as tgeo
from pregen_pde_tpu_torch.fields.grf import draw_grf_noise, grf_filter, grf_spectrum_filter
from pregen_pde_tpu_torch.solvers import schedules as tsched
from pregen_pde_tpu_torch.utils.parity import rel_l2, to_numpy, to_torch

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("n,alpha,tau", [(32, 2.5, 7.0), (64, 2.0, 3.0)])
def test_grf_filter_matches_jax_on_jax_noise(n, alpha, tau):
    grid = SpectralGrid2D(n)
    keys = jax.random.split(jax.random.key(11), 3)
    # the white noise grf_2d draws internally (`fields/grf.py:54`)
    xi = np.stack([np.asarray(jax.random.normal(k, (n, n), dtype=jnp.float32))
                   for k in keys])
    ref = np.stack([np.asarray(jax_grf_2d(k, JaxGrid(n), alpha=alpha, tau=tau)) for k in keys])
    got = grf_filter(to_torch(xi), grid, alpha=alpha, tau=tau)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # f32 FFTs of two libraries: roundoff only
    assert rel_l2(got, ref) <= 1e-5


def test_grf_draw_pointwise_variance():
    """The port's own draw: pointwise variance within 10% of Σ_k S(k),
    S = σ²(|k|² + τ²)^(−α) with the zero mode removed."""
    n, B = 32, 64
    grid = SpectralGrid2D(n)
    gen = torch.Generator().manual_seed(0)
    xi = draw_grf_noise(gen, B, n)
    assert xi.dtype == torch.float32 and tuple(xi.shape) == (B, n, n)
    x = to_numpy(grf_filter(xi, grid)).astype(np.float64)
    h = grf_spectrum_filter(grid)  # rfft2 layout, n·sqrt(S)
    k_full = np.fft.fftfreq(n, d=1.0 / n) * 2 * np.pi
    k2 = k_full[:, None] ** 2 + k_full[None, :] ** 2
    sigma = 7.0 ** (0.5 * (2 * 2.5 - 2))
    s = sigma**2 * (k2 + 49.0) ** (-2.5)
    s[0, 0] = 0.0
    expected = s.sum()
    assert abs(h[0, 0]) == 0.0
    assert abs(x.var() / expected - 1.0) < 0.10, (x.var(), expected)
    assert abs(x.mean()) < 0.05 * np.sqrt(expected)


RE_GRID = np.asarray(
    [100.0, 150.0, 199.999, 200.0, 333.3, 500.0, 999.0, 1000.0, 2500.0, 3999.9,
     4000.0, 4567.0, 5000.0, 7777.7, 9999.0, 10000.0, 50.0, 12000.0]
)


def test_schedules_exact_in_f64():
    re_t = torch.as_tensor(RE_GRID, dtype=torch.float64)
    re_j = jnp.asarray(RE_GRID, jnp.float64)
    np.testing.assert_array_equal(to_numpy(tsched.end_time_from_re(re_t)),
                                  np.asarray(jsched.end_time_from_re(re_j)))
    np.testing.assert_array_equal(to_numpy(tsched.normalize_re(re_t)),
                                  np.asarray(jsched.normalize_re(re_j)))
    np.testing.assert_array_equal(to_numpy(tsched.denormalize_re(re_t)),
                                  np.asarray(jsched.denormalize_re(re_j)))
    np.testing.assert_array_equal(to_numpy(tsched.viscosity_from_re(re_t)),
                                  np.asarray(jsched.viscosity_from_re(re_j)))
    end = jsched.end_time_from_re(re_j)
    np.testing.assert_array_equal(
        to_numpy(tsched.steps_for_horizon(to_torch(end), 0.2)),
        np.asarray(jsched.steps_for_horizon(end, 0.2)),
    )
    for re in RE_GRID[(RE_GRID >= 10) & (RE_GRID <= 1e4)]:
        assert tsched.end_time_from_re_py(float(re)) == jsched.end_time_from_re_py(float(re))


def test_sample_reynolds_from_jax_normal():
    key = jax.random.key(5)
    ref = np.asarray(jsched.sample_reynolds(key, 256))
    z = np.asarray(jax.random.normal(key, (256,)))  # the draw sample_reynolds makes
    got = tsched.sample_reynolds(z=to_torch(z))
    np.testing.assert_array_equal(to_numpy(got), ref)
    # the generator form: same law, right shape and range
    g = tsched.sample_reynolds(torch.Generator().manual_seed(0), 4096)
    assert g.shape == (4096,) and g.dtype == torch.float64
    assert float(g.min()) >= tsched.RE_MIN and float(g.max()) <= tsched.RE_MAX
    assert abs(float(g.mean()) - 5000.0) < 150.0
    with pytest.raises(ValueError):
        tsched.sample_reynolds()


@pytest.mark.parametrize("kind", ["box", "no_hole"])
def test_sdf_from_mask_matches_jax(kind):
    n = 32
    if kind == "box":
        mask = np.asarray(jgeo.box_mask(n, 10, 7, 9, 12), np.float32)
    else:
        mask = np.asarray(jgeo.no_hole_mask(n), np.float32)
    ref = np.asarray(jgeo.sdf_from_mask(jnp.asarray(mask)))
    got = to_numpy(tgeo.sdf_from_mask(to_torch(mask)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if kind == "no_hole":
        np.testing.assert_array_equal(to_numpy(tgeo.no_hole_mask(n)), mask)
        m, s = tgeo.no_hole_mask_and_sdf(n, "cpu")
        assert float(m.abs().max()) == 0.0 and bool((s == 1.0).all())
