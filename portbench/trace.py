"""Reduction of a ``torch.profiler`` session to what the per-layer metrics
and the breakdown read.

The busy time is the union of the device events' intervals, and the time
by kernel name their sum: the arithmetic of
``pregen_pde_tpu_torch/profile_k1.py::_device_summary`` at commit 92d189c,
copied. Times are in seconds, on the profiler's clock.
"""

from __future__ import annotations

SPAN_PREFIX = "portbench."
BATCH_SPAN = SPAN_PREFIX + "batch"


def events(prof) -> tuple[list, list]:
    """(device events, host events), each a list of (name, start_s, end_s)
    sorted by start. The device-side copies of the benchmark's own spans
    (the profiler mirrors a span onto the device's timeline) are no device
    work and are left out."""
    import torch

    dev, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif not e.name.startswith(SPAN_PREFIX):
            dev.append(rec)
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return dev, host


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_seconds(dev, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(clip([(s, e) for _, s, e in dev], lo, hi)))


def short_name(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()[:80]


def by_name(dev) -> dict[str, float]:
    """Device seconds by (shortened) name."""
    out: dict[str, float] = {}
    for name, s, e in dev:
        k = short_name(name)
        out[k] = out.get(k, 0.0) + (e - s)
    return out


def idle_gaps(dev, host, lo: float, hi: float, top: int = 10) -> list[list]:
    """The ``top`` longest stretches of [lo, hi] with no device event, each
    named by what the host was doing over it: the innermost host op that
    covers at least half of the gap."""
    busy = merged(clip([(s, e) for _, s, e in dev], lo, hi))
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        cover = [(min(he, e) - max(hs, s), he - hs, name) for name, hs, he in host
                 if he > s and hs < e]
        half = [c for c in cover if c[0] >= 0.5 * (e - s)]
        if half:
            label = min(half, key=lambda c: c[1])[2]
        elif cover:
            label = max(cover)[2]
        else:
            label = "no host op"
        if label == BATCH_SPAN:
            label = "host code outside torch ops, in the batch call"
        out.append([short_name(label), e - s])
    return out


def breakdown(dev, host, lo: float, hi: float, top: int = 10) -> dict:
    ops = sorted(by_name(dev).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": idle_gaps(dev, host, lo, hi, top)}


def batch_spans(host) -> list[tuple[float, float]]:
    """The benchmark's own spans around each batch call, in order."""
    return [(s, e) for name, s, e in host if name == BATCH_SPAN]


def in_span(dev, span, pattern: str) -> list:
    """Device events of ``span`` whose name holds ``pattern``."""
    lo, hi = span
    return [r for r in dev if pattern in r[0] and r[1] >= lo and r[2] <= hi]
