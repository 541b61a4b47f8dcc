"""The port's spans (``utils/trace.py``): host ``cpu_op`` events under a
profiler, nesting kept, totals of calls, seconds and bytes; the spans of the
two generator batch entries in order, ``generate``'s ``spans`` line on
standard error, and the kernel loader's build and load spans."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pregen_pde_tpu_torch.core import NSVorticityConfig
from pregen_pde_tpu_torch.datagen import masked_ns as tm
from pregen_pde_tpu_torch.datagen import pipeline as tpipe
from pregen_pde_tpu_torch.kernels import build as kbuild
from pregen_pde_tpu_torch.utils import trace
from pregen_pde_tpu_torch.utils.trace import span

# names the benchmark's readers match on device events or take for its own
FORBIDDEN = ("portbench.", "sns_cluster_kernel", "nsp_cluster_kernel", "Memcpy")


def _events(prof):
    """The profiler's ``pregen.*`` events as (name, start, end, event), in
    order of start (an outer span before the one it holds)."""
    ev = [(e.name, e.time_range.start, e.time_range.end, e) for e in prof.events()
          if e.name.startswith(trace.PREFIX)]
    return sorted(ev, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_a_host_op_without_a_device_mirror():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("pregen.test.outer"):
            with span("pregen.test.inner"):
                torch.ones(8).sum()
        with pytest.raises(KeyError):
            with span("pregen.test.raises"):
                raise KeyError("body")
    ev = _events(prof)
    assert [r[0] for r in ev] == ["pregen.test.outer", "pregen.test.inner",
                                  "pregen.test.raises"]
    for _, _, _, e in ev:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
    assert _inside(ev[1], ev[0]) and not _inside(ev[2], ev[0])
    assert ev[2][2] >= ev[2][1]  # closed though its body raised


def test_totals_count_calls_seconds_and_bytes():
    trace.reset()
    for k in range(3):
        with span("pregen.test.a", nbytes=10 * k) as s:
            pass
        assert s.seconds >= 0.0
    with span("pregen.test.b"):
        pass
    got = trace.totals()
    assert list(got) == ["pregen.test.a", "pregen.test.b"]
    assert got["pregen.test.a"]["calls"] == 3 and got["pregen.test.a"]["bytes"] == 30
    assert got["pregen.test.b"]["calls"] == 1 and got["pregen.test.b"]["bytes"] == 0
    assert all(v["seconds"] >= 0.0 for v in got.values())
    trace.reset()
    assert trace.totals() == {}


def test_totals_lose_no_update_across_threads():
    """Kernels are built from several threads: every span of every thread
    is counted."""
    import sys
    import threading

    threads, per = 8, 2000

    def work():
        for _ in range(per):
            with span("pregen.test.threads", nbytes=1):
                pass

    trace.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = trace.totals()["pregen.test.threads"]
    assert got["calls"] == got["bytes"] == threads * per


def test_span_names_keep_their_prefix():
    with pytest.raises(ValueError, match="pregen."):
        span("portbench.batch")


def _assert_names_are_safe(names):
    for name in names:
        assert name.startswith(trace.PREFIX)
        assert not any(bad in name for bad in FORBIDDEN), name


def test_spectral_entry_spans_in_order():
    """The plain method's bucket loop: the GRF filter, then per bucket the
    stepper call, the packing and the fetch (its bytes the bucket's)."""
    cfg = tpipe.GenerationConfig(solver=NSVorticityConfig(resolution=32, n_snapshots=2),
                                 batch_size=4, time_scale=5e-6, method="cn_ab2_packed")
    xi, z_re = tpipe.draw_batch_inputs(torch.Generator().manual_seed(2), cfg)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tpipe.generate_ns_batch_from_inputs(xi, z_re, cfg)
    names = [r[0] for r in _events(prof)]
    buckets = (len(names) - 1) // 3
    assert buckets > 1
    assert names == ["pregen.ns.grf"] + ["pregen.ns.k1", "pregen.ns.pack",
                                         "pregen.ns.fetch"] * buckets
    tot = trace.totals()
    assert {k: v["calls"] for k, v in tot.items()} == {
        "pregen.ns.grf": 1, "pregen.ns.k1": buckets, "pregen.ns.pack": buckets,
        "pregen.ns.fetch": buckets}
    # the buckets are padded to powers of two, so at least the batch is fetched
    assert tot["pregen.ns.fetch"]["bytes"] >= out.nbytes
    assert tot["pregen.ns.fetch"]["bytes"] % (out.nbytes // len(out)) == 0
    _assert_names_are_safe(tot)


def test_spectral_cuda_method_spans_once_a_batch():
    """The CUDA method's one call a batch (its plain version on these CPU
    tensors): one stepper span, one packing, one fetch of exactly the batch."""
    cfg = tpipe.GenerationConfig(solver=NSVorticityConfig(resolution=128, n_snapshots=2),
                                 batch_size=4, time_scale=5e-7, method="cn_ab2_cuda",
                                 storage_dtype="float16")
    xi, z_re = tpipe.draw_batch_inputs(torch.Generator().manual_seed(2), cfg)
    trace.reset()
    out = tpipe.generate_ns_batch_from_inputs(xi, z_re, cfg)
    tot = trace.totals()
    assert list(tot) == ["pregen.ns.grf", "pregen.ns.k1", "pregen.ns.pack", "pregen.ns.fetch"]
    assert all(v["calls"] == 1 for v in tot.values())
    assert out.dtype == np.float16 and tot["pregen.ns.fetch"]["bytes"] == out.nbytes


def test_masked_entry_spans_in_order():
    """Inputs, plan, the first pass's K2 call, fetch and reorder, the finite
    scan, the assembly; no retry on a sound batch."""
    cfg = tm.MaskedNSConfig(pipeline="fpo_multi_hole", resolution=32, dt=0.05,
                            n_snapshots=3, time_scale=2e-4, cg_iters=60)
    z_re, masks = tm.draw_masked_inputs(torch.Generator().manual_seed(3), cfg, 3)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tm.generate_masked_ns_batch_from_inputs(z_re, masks, cfg)
    assert np.isfinite(out).all()
    names = [r[0] for r in _events(prof)]
    assert names == ["pregen.masked.inputs", "pregen.masked.plan", "pregen.masked.k2",
                     "pregen.masked.fetch", "pregen.masked.reorder",
                     "pregen.masked.finite", "pregen.masked.assemble",
                     "pregen.masked.assemble.frames", "pregen.masked.assemble.channels"]
    tot = trace.totals()
    assert tot["pregen.masked.fetch"]["bytes"] == out[..., :3].nbytes
    _assert_names_are_safe(tot)


def test_cli_generate_prints_spans_on_stderr(tmp_path, capsys):
    """Standard output's lines stay as they were; standard error's last line
    is the spans' totals: the masked entry's phases and the writer's."""
    from pregen_pde_tpu_torch.__main__ import main

    main(["generate", "--workload", "fpo_hole", "--resolution", "32", "--batch-size", "2",
          "--time-scale", "2e-4", "--device", "cpu", "--n", "3", "--out", str(tmp_path)])
    cap = capsys.readouterr()
    lines = [json.loads(l) for l in cap.out.splitlines()]
    assert [list(l) for l in lines] == [["kernel_launches"], ["masked_ns"],
                                        ["generated", "out", "device", "workload", "method"]]
    spans = json.loads(cap.err.splitlines()[-1])["spans"]
    assert spans["pregen.masked.k2"]["calls"] == 2  # two batches, no retry
    assert spans["pregen.write"]["calls"] == 2
    assert spans["pregen.write"]["bytes"] == 3 * 21 * 32 * 32 * 6 * 4
    _assert_names_are_safe(spans)


def _fake_nvcc(folder):
    """An ``nvcc`` that writes an empty file where ``-o`` says."""
    folder.mkdir()
    nvcc = folder / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    return nvcc


def test_kernel_build_span_only_when_nvcc_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep + os.environ["PATH"])
    monkeypatch.delenv("CUDA_HOME", raising=False)
    _fake_nvcc(tmp_path / "bin")
    monkeypatch.setattr(kbuild, "build_seconds", {})
    trace.reset()
    so = kbuild.build("stencil", build_dir=tmp_path / "build")
    assert so.exists()
    tot = trace.totals()
    assert tot["pregen.kernel.build"]["calls"] == 1
    assert kbuild.build_seconds["stencil"] == pytest.approx(
        tot["pregen.kernel.build"]["seconds"])
    assert kbuild.build_seconds["stencil"] > 0.0
    # the artifact is there: no nvcc run, no build span, zero seconds
    kbuild.build_seconds.clear()
    trace.reset()
    assert kbuild.build("stencil", build_dir=tmp_path / "build") == so
    assert "pregen.kernel.build" not in trace.totals()
    assert kbuild.build_seconds == {"stencil": 0.0}


def test_kernel_load_span_once_a_library(monkeypatch, tmp_path):
    monkeypatch.setattr(kbuild, "_loaded", {})
    monkeypatch.setattr(kbuild, "build", lambda name, defines=(): tmp_path / f"{name}.so")
    monkeypatch.setattr(kbuild.ctypes, "CDLL", lambda path: ("lib", path))
    trace.reset()
    first = kbuild.load("stencil")
    assert kbuild.load("stencil") is first
    kbuild.load("stencil", defines=("X",))
    assert trace.totals()["pregen.kernel.load"]["calls"] == 2


@pytest.mark.parametrize("attempt_rows", [(0, 2), (1, 2, 3)])
def test_masked_retry_fetch_bytes_follow_the_rows(monkeypatch, attempt_rows):
    """A retry fetches only the rows it re-runs: the first pass's bytes plus
    each retried row's."""
    seen = []

    def factory(solver, device):
        def traj(masks, u_max, inner, dt):
            seen.append(masks.shape[0])
            out = torch.ones((masks.shape[0], solver.cfg.n_snapshots + 1,
                              masks.shape[1], masks.shape[2], 3))
            if len(seen) == 1:
                out[list(attempt_rows)] = float("nan")
            return out

        return traj

    monkeypatch.setattr(tm, "_batched_traj_for", factory)
    cfg = tm.MaskedNSConfig(pipeline="fpo_regular", resolution=16, n_snapshots=2,
                            time_scale=1e-4, re_std=0.0)
    trace.reset()
    out = tm.generate_masked_ns_batch(torch.Generator().manual_seed(0), cfg, 4)
    tot = trace.totals()
    row = out[0, ..., :3].nbytes
    assert seen == [4, len(attempt_rows)]
    assert tot["pregen.masked.retry"]["calls"] == 1
    assert tot["pregen.masked.k2"]["calls"] == tot["pregen.masked.fetch"]["calls"] == 2
    assert tot["pregen.masked.fetch"]["bytes"] == (4 + len(attempt_rows)) * row
    assert tot["pregen.masked.finite"]["calls"] == 2

