"""The readers of the program's spans (``masked_host_share``,
``retry_k2_share``) on made-up traces, and the program's spans kept off the
device's timeline by ``trace.events``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from bench_fixture import BENCH

from portbench import run, trace

K2 = "void nsp_cluster_kernel<128, 256>(Args)"
K2_RETRY = "void nsp_cluster_kernel<128, 512>(Args)"


def _read(name, ctx):
    return run.load_module(BENCH, "metrics", name).read(ctx)


def _ctx(host, dev=(), window=(0.0, 10.0)):
    host = sorted([("portbench.batch", 0.0, 5.0), ("portbench.batch", 5.0, 10.0), *host],
                  key=lambda r: r[1])
    return {"host": host, "dev": sorted(dev, key=lambda r: r[1]),
            "spans": trace.batch_spans(host), "window": window}


def test_masked_host_share_is_the_union_clipped_to_the_window():
    host = [("pregen.masked.assemble", 1.0, 3.0),
            ("pregen.masked.finite", 2.0, 2.5),       # nested in the assembly's stretch
            ("pregen.masked.reorder", 2.8, 4.0),      # overlaps it
            ("pregen.masked.plan", 6.0, 6.5),
            ("pregen.masked.inputs", 9.5, 11.0),      # runs past the window
            ("pregen.masked.k2", 4.0, 6.0),           # launches work: not host-only
            ("pregen.masked.fetch", 7.0, 8.0),
            ("aten::sum", 8.0, 9.0)]
    # [1, 4] + [6, 6.5] + [9.5, 10] = 4 s of 10
    assert _read("masked_host_share", _ctx(host)) == pytest.approx(40.0)
    assert _read("masked_host_share", _ctx(host, window=(2.0, 7.0))) == pytest.approx(50.0)


def test_masked_host_share_reads_nothing_without_the_spans():
    assert _read("masked_host_share", _ctx([("aten::sum", 1.0, 2.0)])) is None


def test_retry_k2_share_reads_zero_without_a_retry():
    host = [("pregen.masked.k2", 0.1, 0.2), ("pregen.masked.k2", 5.1, 5.2)]
    dev = [(K2, 0.2, 2.0), (K2, 5.2, 7.0), ("Memcpy DtoH (Device -> Pageable)", 2.0, 3.0)]
    assert _read("retry_k2_share", _ctx(host, dev)) == 0.0


def test_retry_k2_share_counts_the_launches_inside_retry_spans():
    host = [("pregen.masked.k2", 0.1, 0.2), ("pregen.masked.retry", 3.0, 4.5),
            ("pregen.masked.k2", 3.1, 3.2), ("pregen.masked.k2", 5.1, 5.2)]
    dev = [(K2, 0.2, 2.0),              # first pass, batch 0: 1.8 s
           (K2_RETRY, 3.2, 4.0),        # its retry: 0.8 s
           ("Memcpy DtoH (Device -> Pageable)", 4.0, 4.4),  # inside the retry, not K2
           (K2, 5.2, 6.6),              # first pass, batch 1: 1.4 s
           (K2, 10.5, 11.0)]            # after the window's batches: left out
    assert _read("retry_k2_share", _ctx(host, dev)) == pytest.approx(100.0 * 0.8 / 4.0)


def test_retry_k2_share_reads_nothing_without_the_program_spans():
    dev = [(K2, 0.2, 2.0)]
    assert _read("retry_k2_share", _ctx([], dev)) is None


def test_program_spans_are_host_events():
    """A ``cpu_op`` event (what the program's spans record) goes to the host
    list; only a device event, or a span mirror of the benchmark's own, is
    sorted as the device's."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, device, start, end):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start, end=end))

    prof = SimpleNamespace(events=lambda: [
        ev("pregen.masked.assemble", cpu, 1e6, 2e6),
        ev(K2, cuda, 0.0, 1e6),
        ev("portbench.batch", cuda, 0.0, 3e6)])
    dev, host = trace.events(prof)
    assert [r[0] for r in dev] == [K2]
    assert host == [("pregen.masked.assemble", 1.0, 2.0)]
    # a gap under the span is named by it
    assert trace.idle_gaps(dev, host, 0.0, 2.0)[0] == ["pregen.masked.assemble", 1.0]


def test_a_real_span_is_a_host_event():
    from torch.profiler import ProfilerActivity, profile

    from pregen_pde_tpu_torch.utils.trace import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("pregen.masked.assemble"):
            torch.ones(4).sum()
    dev, host = trace.events(prof)
    assert dev == []
    assert "pregen.masked.assemble" in [r[0] for r in host]
