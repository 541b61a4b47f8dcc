"""Port parity: box and disk masks, the three hole samplers (placements fed
the positions ``jax.random`` drew, exactly as the JAX samplers draw them),
statistics of the port's own draws, and the batched SDF."""

import jax
import numpy as np
import pytest
import torch

from pregen_pde_tpu.fields import geometry as jgeo
from pregen_pde_tpu_torch.fields import geometry as tgeo
from pregen_pde_tpu_torch.utils.parity import to_numpy, to_torch

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("n,r0,c0,h,w", [(32, 10, 7, 9, 12), (64, 0, 50, 16, 16),
                                         (16, -3, 3, 20, 2)])
def test_box_mask_exact(n, r0, c0, h, w):
    ref = np.asarray(jgeo.box_mask(n, r0, c0, h, w))
    np.testing.assert_array_equal(to_numpy(tgeo.box_mask(n, r0, c0, h, w)), ref)
    got = tgeo.box_mask(n, torch.tensor([r0, r0 + 1]), torch.tensor([c0, c0 - 1]), h, w)
    np.testing.assert_array_equal(to_numpy(got[0]), ref)
    np.testing.assert_array_equal(to_numpy(got[1]),
                                  np.asarray(jgeo.box_mask(n, r0 + 1, c0 - 1, h, w)))


@pytest.mark.parametrize("n,rc,cc,rad", [(64, 32.0, 16.0, 4.0), (128, 64.0, 32.0, 8.0),
                                         (64, 32.0, 20.0, 7.5), (33, 10.5, 3.25, 5.1)])
def test_disk_mask_exact(n, rc, cc, rad):
    np.testing.assert_array_equal(to_numpy(tgeo.disk_mask(n, rc, cc, rad)),
                                  np.asarray(jgeo.disk_mask(n, rc, cc, rad)))


def _jax_single_draws(key, n):
    """The draws of `sample_single_hole` (`geometry.py:91-94`)."""
    kr, kc = jax.random.split(key)
    lo, hi = 12, n - 8
    return (int(jax.random.randint(kr, (), lo, hi + 1)),
            int(jax.random.randint(kc, (), lo, hi + 1)))


def _jax_multi_draws(key, n, hole_cells, max_attempts=32):
    """The draws of `sample_multi_holes` (`geometry.py:116-130`)."""
    step = hole_cells // 2
    n_slots = (n - hole_cells - 2 * step) // step + 1
    k_count, k_pos = jax.random.split(key)
    target = int(jax.random.randint(k_count, (), 2, 11))
    rows, cols = [], []
    for k in jax.random.split(k_pos, max_attempts):
        kr, kc = jax.random.split(k)
        rows.append(step + int(jax.random.randint(kr, (), 0, n_slots)) * step)
        cols.append(step + int(jax.random.randint(kc, (), 0, n_slots)) * step)
    return target, rows, cols


def _jax_overlap_draws(key, n, hole_cells, frac, max_holes=10):
    """The draws of `sample_multi_holes_overlap` (`geometry.py:165-185`)."""
    lo, hi = tgeo._overlap_range(n, hole_cells, frac)
    k_count, k_pos = jax.random.split(key)
    target = int(jax.random.randint(k_count, (), 2, max_holes + 1))
    rows, cols = [], []
    for k in jax.random.split(k_pos, max_holes):
        kr, kc = jax.random.split(k)
        rows.append(int(jax.random.randint(kr, (), lo, hi + 1)))
        cols.append(int(jax.random.randint(kc, (), lo, hi + 1)))
    return target, rows, cols


@pytest.mark.parametrize("n", [64, 128])
def test_placements_on_jax_draws_exact(n):
    keys = jax.random.split(jax.random.key(n), 4)
    hole_cells = n // 8
    # one hole
    rc, cc = zip(*(_jax_single_draws(k, n) for k in keys))
    got = tgeo.place_single_hole(n, torch.tensor(rc), torch.tensor(cc))
    ref = np.stack([np.asarray(jgeo.sample_single_hole(k, n)) for k in keys])
    np.testing.assert_array_equal(to_numpy(got), ref)
    # several non-overlapping holes
    t, r, c = zip(*(_jax_multi_draws(k, n, hole_cells) for k in keys))
    got, placed = tgeo.place_multi_holes(n, torch.tensor(t), torch.tensor(r),
                                         torch.tensor(c), hole_cells)
    refs = [jgeo.sample_multi_holes(k, n, hole_cells=hole_cells) for k in keys]
    np.testing.assert_array_equal(to_numpy(got), np.stack([np.asarray(m) for m, _ in refs]))
    np.testing.assert_array_equal(to_numpy(placed), [int(p) for _, p in refs])
    # forced overlap
    t, r, c = zip(*(_jax_overlap_draws(k, n, hole_cells, 0.4) for k in keys))
    got, placed = tgeo.place_multi_holes_overlap(n, torch.tensor(t), torch.tensor(r),
                                                 torch.tensor(c), hole_cells)
    refs = [jgeo.sample_multi_holes_overlap(k, n, hole_cells=hole_cells,
                                            overlap_fraction=0.4) for k in keys]
    np.testing.assert_array_equal(to_numpy(got), np.stack([np.asarray(m) for m, _ in refs]))
    np.testing.assert_array_equal(to_numpy(placed), [int(p) for _, p in refs])


def test_own_draws_statistics():
    n, hc, B = 128, 16, 64
    g = torch.Generator().manual_seed(0)
    single = to_numpy(tgeo.sample_single_hole(g, B, n))
    assert (single.sum(axis=(1, 2)) == 16 * 16).all()  # never clipped
    masks, placed = tgeo.sample_multi_holes(g, B, n, hole_cells=hc)
    masks, placed = to_numpy(masks), to_numpy(placed)
    assert masks.shape == (B, n, n) and set(np.unique(masks)) <= {0.0, 1.0}
    assert placed.min() >= 2 and placed.max() <= 10 and len(set(placed)) > 3
    # no overlap: the area is exactly placed · hole²; margin of one step
    np.testing.assert_array_equal(masks.sum(axis=(1, 2)), placed * hc * hc)
    step = hc // 2
    edge = np.ones((n, n), bool)
    edge[step:n - step, step:n - step] = False
    assert masks[:, edge].max() == 0.0
    # forced overlap: the common central box is always covered
    om, op = tgeo.sample_multi_holes_overlap(g, B, n, hole_cells=hc, overlap_fraction=0.3)
    om = to_numpy(om)
    assert (om[:, n // 2 - 2:n // 2 + 2, n // 2 - 2:n // 2 + 2] == 1.0).all()
    assert (to_numpy(op) >= 2).all() and (to_numpy(op) <= 10).all()
    with pytest.raises(ValueError):
        tgeo.sample_multi_holes_overlap(g, 1, n, overlap_fraction=0.0)


def test_batched_sdf_matches_jax_vmap(monkeypatch):
    n = 64
    ms, _ = jgeo.sample_multi_holes(jax.random.key(7), n, hole_cells=8)
    masks = np.stack([np.asarray(ms), np.asarray(jgeo.disk_mask(n, 32.0, 20.0, 7.5)),
                      np.asarray(jgeo.no_hole_mask(n)),
                      np.asarray(jgeo.box_mask(n, 0, 0, n, n))]).astype(np.float32)
    ref = np.asarray(jax.vmap(jgeo.sdf_from_mask)(masks))
    got = to_numpy(tgeo.sdf_from_mask(to_torch(masks)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # chunks of one image give the same result; leading axes are kept
    monkeypatch.setattr(tgeo, "EDT_CHUNK_BYTES", 1)
    one = tgeo.sdf_from_mask(to_torch(masks).reshape(2, 2, n, n))
    np.testing.assert_array_equal(to_numpy(one).reshape(4, n, n), got)
