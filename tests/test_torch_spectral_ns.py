"""Port parity: the pseudo-spectral NS solver and the CN+AB2 stepper (K1).

The solver's operators and packed steppers run in float64 against the JAX
package (bar 1e-10). K1's wrapper, on CPU tensors, runs its plain version
and is held against the JAX Pallas kernel run in interpret mode (bar 5e-5,
as in ``tests/test_spectral_ns_pallas.py``). The kernel itself runs only on
a CUDA card: its tests are in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.core.config import NSVorticityConfig as JaxConfig
from pregen_pde_tpu.solvers import spectral_ns_pallas as jsnp
from pregen_pde_tpu.solvers.spectral_ns import NSVorticitySolver as JaxSolver
from pregen_pde_tpu.solvers.spectral_ns import cfl_dt as jax_cfl_dt
from pregen_pde_tpu_torch.core import NSVorticityConfig
from pregen_pde_tpu_torch.solvers import spectral_ns as tsn
from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as tsnc
from pregen_pde_tpu_torch.utils.parity import rel_l2, to_numpy, to_torch

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

F64 = 1e-10  # float64 parity bar: same algorithm, two FFT libraries


def _solvers(**fields):
    """The JAX solver and the port's, each on its own package's config of
    the same fields."""
    return JaxSolver(JaxConfig(**fields)), tsn.NSVorticitySolver(NSVorticityConfig(**fields))


def _w0(n, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, n, n))


@pytest.mark.parametrize("forcing", ["fno", "kolmogorov", "none"])
def test_constants_and_forcing_match_jax(forcing):
    jsol, tsol = _solvers(resolution=32, forcing=forcing)
    cfg = tsol.cfg
    c = tsn.constants(tsol.grid, torch.float64)
    kx, ky, ik2, de = (np.asarray(a) for a in jsol._consts_full(jnp.float64))
    np.testing.assert_array_equal(to_numpy(c["kx"]), kx)
    np.testing.assert_array_equal(to_numpy(c["ky"]), ky)
    np.testing.assert_array_equal(to_numpy(c["inv_k2"]), ik2)
    np.testing.assert_array_equal(to_numpy(c["dealias"]), de)
    np.testing.assert_array_equal(to_numpy(c["k2"]), jsol.grid.k2_full)
    from pregen_pde_tpu.solvers.spectral_ns import make_forcing as jax_make_forcing

    fj = jax_make_forcing(jsol.cfg, jsol.grid)
    ft = tsn.forcing_hat(cfg, tsol.grid, torch.float64, "cpu")
    if fj is None:
        assert ft is None
    else:
        np.testing.assert_array_equal(tsn.make_forcing(cfg, tsol.grid), fj)
        ref = np.asarray(jnp.fft.fft2(jnp.asarray(fj, jnp.float64)))
        assert np.max(np.abs(to_numpy(ft) - ref)) <= F64 * np.max(np.abs(ref))


def test_operators_match_jax_f64():
    jsol, tsol = _solvers(resolution=32, drag=0.05)
    w = _w0(32, 2, seed=1)
    wj, wt = jnp.asarray(w), to_torch(w)
    jf = jax.vmap(jsol.fields_from_vorticity)(wj)
    tf = tsol.fields_from_vorticity(wt)
    for k in ("u", "v", "p", "w"):
        assert tf[k].dtype == torch.float64
        assert rel_l2(tf[k], np.asarray(jf[k])) <= F64, k
    uj, vj = jax.vmap(jsol.velocity)(jnp.fft.rfft2(wj))
    ut, vt = tsol.velocity(torch.fft.rfft2(wt))
    assert rel_l2(ut, np.asarray(uj)) <= F64 and rel_l2(vt, np.asarray(vj)) <= F64
    pj = jax.vmap(jsol.pressure)(jnp.fft.rfft2(wj))
    assert rel_l2(tsol.pressure(torch.fft.rfft2(wt)), np.asarray(pj)) <= F64
    assert abs(tsn.cfl_dt(tsol, wt[0]) - jax_cfl_dt(jsol, wj[0])) <= F64


@pytest.mark.parametrize("scheme", ["ab2", "heun"])
def test_packed_trajectory_matches_jax_f64(scheme):
    jsol, tsol = _solvers(resolution=32, viscosity=1e-3, dt=1e-3, t_end=6e-3,
                          n_snapshots=3, include_initial=True, forcing="fno", drag=0.1)
    method = {"ab2": "cn_ab2_packed", "heun": "cn_heun_packed"}[scheme]
    w0 = _w0(32, 3, seed=2)
    nu = np.array([1e-3, 3e-3, 2e-2])
    ref = np.asarray(jax.vmap(jsol.make_trajectory_fn_nu(method), in_axes=(0, 0, None))(
        jnp.asarray(w0), jnp.asarray(nu), 2))
    got = tsol.make_trajectory_fn_nu(method)(to_torch(w0), to_torch(nu), 2)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape == (3, 4, 32, 32)
    assert rel_l2(got, ref) <= F64
    # the batched entry point serves the same function
    got_b = tsol.make_batched_trajectory_fn_nu(method)(to_torch(w0), to_torch(nu), 2)
    np.testing.assert_array_equal(to_numpy(got_b), to_numpy(got))
    with pytest.raises(NotImplementedError):
        tsol.make_trajectory_fn_nu("cn_heun")


@pytest.mark.parametrize("output", ["vorticity", "fields"])
def test_k1_plain_path_matches_pallas_interpret(output):
    """K1's wrapper on CPU tensors (its plain version) vs the JAX Pallas
    kernel in interpret mode: 128², B=2, 3 snapshots × 1 step, f32."""
    n = 128
    jsol, tsol = _solvers(resolution=n, viscosity=1e-3, dt=1e-3, t_end=3e-3,
                          n_snapshots=3, include_initial=True, forcing="fno")
    w0 = _w0(n, 2, seed=3).astype(np.float32)
    nu = np.array([1e-3, 2e-3], np.float32)
    ref = np.asarray(jsnp.build_batched_traj(jsol, output=output)(
        jnp.asarray(w0), jnp.asarray(nu)))
    tsnc.reset_launches()
    traj = tsnc.build_batched_traj(tsol, output=output)
    got = traj(to_torch(w0), to_torch(nu))
    assert tsnc.launches == 0  # CPU tensors never reach the CUDA library
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # the Pallas fast tier's snapshot epilogue is 3-pass split-bf16 (~1e-5)
    err = np.max(np.abs(to_numpy(got) - ref)) / np.max(np.abs(ref))
    assert err < 5e-5, err


def test_k1_wrapper_validates():
    cfg = NSVorticityConfig(resolution=96)
    with pytest.raises(ValueError, match="handles n"):
        tsnc.build_batched_traj(tsn.NSVorticitySolver(cfg))
    cfg = NSVorticityConfig(resolution=128)
    sol = tsn.NSVorticitySolver(cfg)
    with pytest.raises(ValueError, match="precision"):
        tsnc.build_batched_traj(sol, precision="tf32")
    with pytest.raises(ValueError, match="output"):
        tsnc.build_batched_traj(sol, output="uvp")
    with pytest.raises(ValueError, match="w0 must be"):
        tsnc.build_batched_traj(sol)(torch.zeros(2, 64, 64))
    with pytest.raises(ValueError, match="route"):
        tsnc.build_batched_traj(sol, route="cpu")
    with pytest.raises(ValueError, match="inner_steps"):
        tsnc.build_batched_traj(sol)(torch.zeros(2, 128, 128), None, torch.ones(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="inner_steps"):
        tsnc.build_batched_traj(sol)(torch.zeros(2, 128, 128), None, torch.tensor([1, 0]))
    assert tsnc.RESIDENT_N == (128, 256)
    assert [tsnc.supported(n) for n in (64, 128, 256, 384, 512, 1024, 2048)] == [
        False, True, True, False, True, True, False]
    x = torch.randn(2, 128, 128, dtype=torch.complex64)
    torch.testing.assert_close(tsnc.fft2(x), torch.fft.fft2(x))
    torch.testing.assert_close(tsnc.fft2(x, inverse=True), torch.fft.ifft2(x))


def test_k1_per_image_steps_match_bucket_calls():
    """A (B,) ``inner_steps`` tensor equals separate calls per step count,
    row for row (the wrapper's plain version in float64)."""
    _, tsol = _solvers(resolution=128, viscosity=1e-3, dt=1e-3, n_snapshots=2,
                       include_initial=True, forcing="fno", drag=0.05)
    w0 = to_torch(_w0(128, 4, seed=6))
    nu = to_torch(np.array([1e-3, 2e-3, 5e-4, 1e-3]))
    steps = torch.tensor([2, 1, 2, 3])
    for output in ("vorticity", "fields"):
        traj = tsnc.build_batched_traj(tsol, output=output)
        got = traj(w0, nu, steps)
        assert got.dtype == torch.float64
        for k in (1, 2, 3):
            rows = torch.nonzero(steps == k).flatten()
            np.testing.assert_array_equal(to_numpy(got[rows]),
                                          to_numpy(traj(w0[rows], nu[rows], k)))
        # an int is every image's count
        np.testing.assert_array_equal(to_numpy(traj(w0, nu, 2)),
                                      to_numpy(traj(w0, nu, torch.full((4,), 2))))


def test_kernel_layout_roundtrip():
    """The resident kernel's spectral layout (a line per kx along ky) holds
    fft2's element (ky, kx) at [kx, ky], and maps back to natural order."""
    n = 128
    a = np.fft.fft2(_w0(n, 2, seed=7))
    k = tsnc.to_kernel_layout(a)
    assert k.shape == a.shape and k.flags.c_contiguous
    ky, kx = 5, 77
    assert k[1, kx, ky] == a[1, ky, kx]
    np.testing.assert_array_equal(tsnc.to_kernel_layout(k), a)
    # the forcing spectrum handed to the kernel, in float64 before the cast
    _, tsol = _solvers(resolution=n, forcing="fno")
    f_hat = np.fft.fft2(tsn.make_forcing(tsol.cfg, tsol.grid))
    np.testing.assert_array_equal(tsnc.to_kernel_layout(f_hat).T, f_hat)


def _line_fft_model(x, inverse):
    """The kernel's line transform (``line_fft``), n = 16 R: lane t takes an
    R-point DFT of x[t + 16m] and multiplies by W_n^{t k1}; lane k1 takes a
    16-point DFT over the lanes, giving X[k1 + R k2]."""
    n = x.shape[-1]
    R = n // 16
    sgn = 1.0 if inverse else -1.0
    dft = lambda m: np.exp(sgn * 2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    xm = x.reshape(*x.shape[:-1], R, 16)                  # [m, t] = x[t + 16m]
    y = np.einsum("...mt,mk->...tk", xm, dft(R))          # [t, k1]
    y = y * np.exp(sgn * 2j * np.pi * np.outer(np.arange(16), np.arange(R)) / n)
    out = np.einsum("...tk,tj->...jk", y, dft(16))        # [k2, k1]
    return out.reshape(*x.shape[:-1], n)                  # index k2 R + k1


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_line_fft_radix_split_model(n, inverse):
    x = _w0(n, 3, seed=8) + 1j * _w0(n, 3, seed=9)
    ref = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    err = np.max(np.abs(_line_fft_model(x, inverse) - ref)) / np.max(np.abs(ref))
    assert err <= 1e-12


@pytest.mark.parametrize("n", [128, 256])
def test_exchange_tiles_model(n):
    """The kernel's two exchanges, modelled with its index formulas: the
    inverse 2-D transform from the kx slabs through the X1 tiles, and the
    forward one from the rows through the G tiles, against numpy."""
    C = n // 16
    spec = np.fft.fft2(_w0(n, 1, seed=10)[0])
    slab = tsnc.to_kernel_layout(spec)                    # block kx >> 4, line kx & 15
    cols = np.fft.ifft(slab, axis=-1) * n                 # inverse along ky
    # put_x1: X1[source block][dest block][y & 15][kx & 15]
    x1 = np.zeros((C, C, 16, 16), complex)
    kx, y = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    x1[kx >> 4, y >> 4, y & 15, kx & 15] = cols[kx, y]
    # x1_peer: dest block r, line l (y = 16r + l), lane t, peer m: x = 16m + t
    rows = np.zeros((n, n), complex)
    r, l, m, t = np.meshgrid(*(np.arange(C), np.arange(16), np.arange(C), np.arange(16)),
                             indexing="ij")
    rows[16 * r + l, 16 * m + t] = x1[m, r, l, t]
    phys = np.fft.ifft(rows, axis=-1) * n
    np.testing.assert_allclose(phys, np.fft.ifft2(spec) * n * n, rtol=0, atol=1e-9)
    # forward: put_g G[source block][dest block][kx & 15][y & 15], g_peer
    fx = np.fft.fft(phys, axis=-1)                        # [y, kx]
    g = np.zeros((C, C, 16, 16), complex)
    g[y >> 4, kx >> 4, kx & 15, y & 15] = fx[y, kx]
    back = np.zeros((n, n), complex)                      # kernel layout [kx, ky]
    back[16 * r + l, 16 * m + t] = g[m, r, l, t]
    back = np.fft.fft(back, axis=-1) / (n * n)
    np.testing.assert_allclose(tsnc.to_kernel_layout(back), spec, rtol=0, atol=1e-9)
