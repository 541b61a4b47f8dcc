"""The yardstick's counts against hand counts at small n, and the readers'
arithmetic on a made-up trace."""

from __future__ import annotations

import numpy as np
import pytest
from bench_fixture import BENCH

from portbench import roofline, run, trace


def test_k1_counts_by_hand():
    # three complex FFTs of 16 points: 3 · 5 · 16 · log2(16) = 960
    assert roofline.k1_flop_per_image_step(4) == 960
    # B = 2 at 4², 3 frames: w0 2·16 + ν 2 + fields 2·3·16·3 = 322 floats
    assert roofline.k1_bytes(2, 4, 3) == 4 * 322


def test_k2_counts_by_hand():
    # four 4×4×4 products of 2·64 FLOP each
    assert roofline.k2_flop_per_image_step(4) == 512
    # masks 2·16 + u_max, dt, steps 3·2 + frames 2·3·16·3 = 326 floats
    assert roofline.k2_bytes(2, 4, 3) == 4 * 326


def test_bound_takes_the_slower_side():
    assert roofline.bound_seconds(165e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_seconds(0.0, 3.35e12 * 2) == pytest.approx(2.0)
    assert roofline.PEAK_FLOPS == 495e12 / 3


def test_union_and_gaps():
    dev = [("k", 0.0, 2.0), ("k", 1.0, 3.0), ("Memcpy DtoH (Device -> Pageable)", 5.0, 6.0)]
    host = [("portbench.batch", 0.0, 10.0), ("aten::cat", 3.0, 4.5)]
    assert trace.busy_seconds(dev, 0.0, 10.0) == pytest.approx(4.0)
    assert trace.busy_seconds(dev, 1.5, 5.5) == pytest.approx(2.0)
    gaps = trace.idle_gaps(dev, host, 0.0, 10.0)
    assert gaps[0] == ["host code outside torch ops, in the batch call", 4.0]
    assert gaps[1] == ["aten::cat", 2.0]
    b = trace.breakdown(dev, host, 0.0, 10.0)
    assert b["device_ops"][0] == ["k", 4.0]


def _ctx():
    n, B, T = 8, 2, 3
    dev = [("void sns_cluster_kernel<8>(CArgs)", 1.0, 3.0),
           ("void nsp_cluster_kernel<8, 256>(Args)", 1.0, 2.0),
           ("void nsp_cluster_kernel<8, 256>(Args)", 2.5, 2.9),
           ("Memcpy DtoH (Device -> Pageable)", 3.0, 4.0)]
    batches = [{"kernel": k, "kernel_flop": 1.65e12, "kernel_bytes": 100.0,
                "delivered_flop": 0.825e12, "fetch_bytes": 2e9} for k in ("k1",)]
    return {"dev": dev, "host": [], "spans": [(0.0, 5.0)], "window": (0.0, 5.0),
            "batches": batches, "counters": {"trajectories": B}, "n": n, "T": T}


def _read(name, ctx):
    return run.load_module(BENCH, "metrics", name).read(ctx)


def test_readers_on_a_made_up_trace():
    ctx = _ctx()
    # 1.65e12 FLOP bound 0.01 s over 2 s of K1
    assert _read("k1_roofline", ctx) == pytest.approx(0.5)
    assert _read("k2_roofline", ctx) is None  # no batch counted by K2's model
    ctx["batches"][0]["kernel"] = "k2"
    # only the first K2 launch of the span: 0.01 s over 1 s
    assert _read("k2_roofline", ctx) == pytest.approx(1.0)
    assert _read("pipeline_mfu", ctx) == pytest.approx(100 * 0.825e12 / (5 * 165e12))
    assert _read("device_idle_share", ctx) == pytest.approx(100 * (1 - 3.0 / 5.0))
    assert _read("fetch_gb_per_s", ctx) == pytest.approx(2.0)
    assert _read("retry_share", ctx) is None
    ctx["counters"]["retried_trajectories"] = 1
    assert _read("retry_share", ctx) == pytest.approx(50.0)


def test_e2e_readers():
    ctx = {"delivered": 300, "window_s": 30.0, "memory_peak_bytes": 3 * 2**30,
           "setup_s": 9.5}
    assert _read("traj_per_s", ctx) == pytest.approx(10.0)
    assert _read("peak_mem_gib", ctx) == pytest.approx(3.0)
    assert _read("setup_s", ctx) == 9.5


def test_driver_counts_follow_the_schedule():
    """The spectral driver's image-steps: 20 snapshots × each row's inner
    steps, the band law at the cell's time scale."""
    from portbench.reference import schedules

    re = np.array([5000.0, 2500.0, 100.0])
    import torch
    end_t = schedules.end_time_from_re(torch.as_tensor(re)).numpy()
    # 40·4/(5000·1.5e-5) = 2133.3 → 2200; 20·4/(2500·1.5e-5) = 2133.3 → 2200; 1·4/1.5e-3
    assert list(end_t) == [2200.0, 2200.0, 2700.0]
    inner = schedules.spectral_inner_steps(end_t * 5e-4, 1e-4, 20)
    assert list(inner) == [550, 550, 675]
