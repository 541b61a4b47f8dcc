"""Port parity: the masked-geometry generators as a whole (JAX's own draws
through the port against ``generate_masked_ns_batch``), their sub-bucket and
retry logic, the device guard and the CLI."""

import json

import jax
import numpy as np
import pytest
import torch

from pregen_pde_tpu.datagen import masked_ns as jm
from pregen_pde_tpu_torch.datagen import masked_ns as tm
from pregen_pde_tpu_torch.datagen.writer import load_shards
from pregen_pde_tpu_torch.solvers import schedules as tsched
from pregen_pde_tpu_torch.utils.parity import rel_l2, to_numpy, to_torch

# the setup of tests/test_masked_ns_datagen.py: 32², 3 snapshots, horizons
# 1100..2700 s × 2e-4 → 4..10 steps per snapshot
FAST = dict(resolution=32, dt=0.05, n_snapshots=3, time_scale=2e-4, cg_iters=60)


def _jax_draws(key, cfg, n):
    """The draws `generate_masked_ns_batch` makes (`masked_ns.py:169-177`)."""
    k_re, k_geo = jax.random.split(key)
    z = np.asarray(jax.random.normal(k_re, (n,)))
    return z, np.asarray(jm.sample_masks(k_geo, cfg, n))


@pytest.mark.parametrize("pipeline", ["fpo_regular", "fpo_multi_hole", "ldc_regular"])
def test_slice_matches_jax_on_jax_draws(pipeline):
    jcfg = jm.MaskedNSConfig(pipeline=pipeline, **FAST)
    key = jax.random.key(11)
    ref = jm.generate_masked_ns_batch(key, jcfg, 4)
    z, masks = _jax_draws(key, jcfg, 4)
    stats = tm.new_stats()
    got = tm.generate_masked_ns_batch_from_inputs(
        to_torch(z), to_torch(masks), tm.MaskedNSConfig(pipeline=pipeline, **FAST),
        stats=stats)
    assert got.shape == ref.shape == (4, 4, 32, 32, 6) and got.dtype == ref.dtype
    assert np.isfinite(got).all() and stats["sub_buckets"] >= 1 and stats["retries"] == 0
    assert rel_l2(got[..., :3], ref[..., :3]) <= 1e-4
    np.testing.assert_allclose(got[..., 3:], ref[..., 3:], rtol=0, atol=1e-6)


def test_cfl_dt_masks_and_guards():
    for u in (1e-4, 0.0375, 0.075, 3.0):
        assert tm.cfl_dt(tm.MaskedNSConfig(), u) == jm.cfl_dt(jm.MaskedNSConfig(), u)
    g = torch.Generator().manual_seed(0)
    key = jax.random.key(0)
    reg = tm.sample_masks(g, tm.MaskedNSConfig(pipeline="fpo_regular", resolution=64), 3)
    np.testing.assert_array_equal(
        to_numpy(reg), np.asarray(jm.sample_masks(key, jm.MaskedNSConfig(
            pipeline="fpo_regular", resolution=64), 3)))
    hole = to_numpy(tm.sample_masks(g, tm.MaskedNSConfig(pipeline="fpo_hole",
                                                          resolution=64), 3))
    assert hole.shape == (3, 64, 64) and not np.array_equal(hole[0], hole[1])
    multi = tm.sample_masks(g, tm.MaskedNSConfig(pipeline="fpo_multi_hole",
                                                 resolution=64, hole_overlap=True), 2)
    assert float(multi[:, 32, 32].min()) == 1.0
    assert float(tm.sample_masks(g, tm.MaskedNSConfig(pipeline="ldc_regular",
                                                      resolution=64), 2).abs().max()) == 0
    with pytest.raises(NotImplementedError):
        tm.generate_masked_ns_batch(g, tm.MaskedNSConfig(per_traj_dt=False, **FAST), 1)
    # on CUDA a grid the kernel does not handle raises, naming the size
    tm.check_device_supported(tm.MaskedNSConfig(resolution=128), torch.device("cuda"))
    tm.check_device_supported(tm.MaskedNSConfig(resolution=48), torch.device("cpu"))
    with pytest.raises(ValueError, match="n = 48"):
        tm.check_device_supported(tm.MaskedNSConfig(resolution=48), torch.device("cuda"))


def _fake_traj_factory(calls, poison_first=False):
    def factory(solver, device):
        def traj(masks, u_max, inner, dt):
            calls.append((to_numpy(u_max).copy(), to_numpy(dt).astype(np.float64),
                          to_numpy(inner).astype(np.int64)))
            out = torch.ones((masks.shape[0], solver.cfg.n_snapshots + 1,
                              masks.shape[1], masks.shape[2], 3))
            if poison_first and len(calls) == 1:
                out[0] = float("nan")
            return out

        return traj

    return factory


def test_per_trajectory_cfl_dt_subbuckets(monkeypatch):
    """Port of test_masked_ns_datagen.py's sub-bucket test: trajectories of
    one horizon bucket whose CFL dt differ by a power-of-two level form
    separate sub-buckets, each row at its sub-bucket's dt; the batch runs as
    one call with per-row dt and inner steps, longest first."""
    calls = []
    monkeypatch.setattr(tm, "_batched_traj_for", _fake_traj_factory(calls))
    re_vals = np.array([2000.0, 20000.0, 20000.0, 2000.0])
    monkeypatch.setattr(tsched, "sample_reynolds",
                        lambda z, mean, std: torch.as_tensor(re_vals))
    monkeypatch.setattr(tsched, "end_time_from_re",
                        lambda re: torch.full_like(torch.as_tensor(re), 1000.0))
    cfg = tm.MaskedNSConfig(pipeline="fpo_regular", resolution=16, n_snapshots=2,
                            time_scale=1e-3)
    stats = tm.new_stats()
    out = tm.generate_masked_ns_batch(torch.Generator().manual_seed(0), cfg, 4, stats=stats)
    assert np.isfinite(out).all()
    assert len(calls) == 1  # one call for the whole batch
    assert stats == {"sub_buckets": 2, "retries": 0, "retried_trajectories": 0, "calls": 1}
    u_slow = 2000.0 * cfg.viscosity / cfg.length
    u_fast = 20000.0 * cfg.viscosity / cfg.length
    # the plan: two sub-buckets, one per dt level, at their members' own dt
    plan = tm.plan_sub_buckets(re_vals * cfg.viscosity / cfg.length, np.full(4, 1.0), cfg)
    assert [sorted(idx.tolist()) for idx, _, _ in plan] == [[0, 3], [1, 2]]
    assert plan[0][2] == pytest.approx(tm.cfl_dt(cfg, u_slow)) == pytest.approx(cfg.dt)
    assert plan[1][2] == pytest.approx(tm.cfl_dt(cfg, u_fast)) and plan[1][2] < cfg.dt
    u, dt, inner = calls[0]
    assert len(u) == len(dt) == len(inner) == 4
    fast = np.isclose(u, u_fast, rtol=1e-6)
    assert fast.sum() == 2 and np.isclose(u[~fast], u_slow, rtol=1e-6).all()
    np.testing.assert_allclose(dt[fast], tm.cfl_dt(cfg, u_fast), rtol=1e-12)
    np.testing.assert_allclose(dt[~fast], cfg.dt, rtol=1e-12)
    # each row's inner steps from its own dt: round(horizon/dt) // n_snapshots
    for d, k in zip(dt, inner):
        assert k == max(int(round(1.0 / d)) // cfg.n_snapshots, 1)
    assert inner[~fast].max() < inner[fast].min()
    assert fast[:2].all()  # longest trajectories first
    assert (np.diff(inner) <= 0).all()


def test_nonfinite_bucket_retry(monkeypatch):
    """Port of test_masked_ns_datagen.py's retry test: a non-finite row
    re-runs alone at its dt/2, so the count stays exact; the retry counts
    once for its sub-bucket."""
    calls = []
    monkeypatch.setattr(tm, "_batched_traj_for", _fake_traj_factory(calls, True))
    cfg = tm.MaskedNSConfig(pipeline="fpo_regular", resolution=16, n_snapshots=2,
                            time_scale=1e-4, re_std=0.0)  # one horizon bucket
    stats = tm.new_stats()
    out = tm.generate_masked_ns_batch(torch.Generator().manual_seed(0), cfg, 4, stats=stats)
    assert np.isfinite(out).all()
    assert len(calls) == 2 and stats == {"sub_buckets": 1, "retries": 1,
                                         "retried_trajectories": 1, "calls": 2}
    (u0, dt0, inner0), (u1, dt1, inner1) = calls
    assert len(u0) == 4 and len(u1) == 1  # only the bad row re-runs
    assert u1[0] == u0[0]
    assert dt1[0] == pytest.approx(dt0[0] / 2.0)
    horizon = float(tsched.end_time_from_re(torch.tensor([cfg.re_mean]))[0]) * cfg.time_scale
    assert inner1[0] == max(int(round(horizon / dt1[0])) // cfg.n_snapshots, 1)


def test_nonfinite_retry_span_holds_its_attempt(monkeypatch):
    """The retry of test_nonfinite_bucket_retry under a profiler: one
    ``pregen.masked.retry`` span holding the attempt's own K2 call, fetch
    and reorder; the fetches' bytes are the frames' bytes."""
    from torch.profiler import ProfilerActivity, profile

    from pregen_pde_tpu_torch.utils import trace

    calls = []
    monkeypatch.setattr(tm, "_batched_traj_for", _fake_traj_factory(calls, True))
    cfg = tm.MaskedNSConfig(pipeline="fpo_regular", resolution=16, n_snapshots=2,
                            time_scale=1e-4, re_std=0.0)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tm.generate_masked_ns_batch(torch.Generator().manual_seed(0), cfg, 4)
    ev = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name.startswith("pregen.masked.")), key=lambda r: (r[1], -r[2]))
    names = [r[0] for r in ev]
    assert names == ["pregen.masked.inputs", "pregen.masked.plan", "pregen.masked.k2",
                     "pregen.masked.fetch", "pregen.masked.reorder", "pregen.masked.finite",
                     "pregen.masked.retry", "pregen.masked.k2", "pregen.masked.fetch",
                     "pregen.masked.reorder", "pregen.masked.finite",
                     "pregen.masked.assemble",
                     "pregen.masked.assemble.frames", "pregen.masked.assemble.channels"]
    retry = ev[6]
    inside = [r[0] for r in ev if retry[1] <= r[1] and r[2] <= retry[2] and r is not retry]
    assert inside == ["pregen.masked.k2", "pregen.masked.fetch", "pregen.masked.reorder"]
    frames = out[..., :3]
    tot = trace.totals()
    # the first pass's four rows and the retried one
    assert tot["pregen.masked.fetch"]["bytes"] == frames.nbytes + frames[:1].nbytes
    assert tot["pregen.masked.fetch"]["calls"] == len(calls) == 2


def test_cli_masked_generate_writes_readable_shards(tmp_path, capsys):
    from pregen_pde_tpu_torch.__main__ import main

    out = tmp_path / "fpo"
    base = ["generate", "--workload", "fpo_hole", "--resolution", "32", "--batch-size", "2",
            "--time-scale", "2e-4", "--device", "cpu", "--out", str(out)]
    main(base + ["--n", "3"])
    data = load_shards(out)
    assert data.shape == (3, 21, 32, 32, 6) and np.isfinite(data).all()
    assert (data[..., 4].sum(axis=(2, 3)) == 256).all()  # one 16² hole, every frame
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"kernel_launches": {"spectral_ns_step": 0, "ns_projection_step": 0,
                                            "stencil": 0}}
    assert lines[1]["masked_ns"]["sub_buckets"] >= 2 and lines[1]["masked_ns"]["retries"] == 0
    assert lines[1]["masked_ns"]["calls"] == 2  # one a batch: 3 trajectories in batches of 2
    main(base + ["--n", "5", "--resume"])
    assert load_shards(out).shape == (5, 21, 32, 32, 6)
    np.testing.assert_array_equal(load_shards(out)[:3], data)
    with pytest.raises(SystemExit):
        main(["generate", "--workload", "ldc_regular", "--method", "cn_ab2_packed",
              "--device", "cpu", "--out", str(tmp_path / "x")])
