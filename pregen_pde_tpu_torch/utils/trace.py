"""Named spans of the port's host phases.

``with span("pregen.masked.fetch", nbytes):`` does two things:

- it enters ``torch._C._profiler._RecordFunctionFast(name)``, so a running
  ``torch.profiler`` session records the span as a host ``cpu_op`` on the
  same clock as the kernels and copies it launched. Unlike
  ``torch.profiler.record_function``, it makes no user annotation, so the
  profiler mirrors nothing onto the device's timeline: a span that launches
  work on both sides of a host stretch does not fill that idle stretch;
- it adds one call, its seconds (``time.perf_counter_ns``) and ``nbytes``
  to ``totals()``, process-wide and keyed by name, under a lock (kernels are
  built from several threads); ``reset()`` clears them (in the style of the
  kernel wrappers' ``launches`` and ``reset_launches``).

There is no switch: with no profiler running, a span costs the fast record
function and two clock reads. Every name starts with ``pregen.``, so no name
is taken for the benchmark's own spans (``portbench.``) or matched by a
reader that looks for a kernel's or a copy's name on device events.
"""

from __future__ import annotations

import threading
import time

from torch._C._profiler import _RecordFunctionFast

PREFIX = "pregen."

# name → [calls, nanoseconds, bytes]
_totals: dict[str, list[int]] = {}
_lock = threading.Lock()


class span:
    """A context manager timing one phase; ``seconds`` holds its elapsed
    time once it has closed (also when its body raised)."""

    __slots__ = ("name", "nbytes", "seconds", "_rf", "_t0")

    def __init__(self, name: str, nbytes: int = 0):
        if not name.startswith(PREFIX):
            raise ValueError(f"span name {name!r} does not start with {PREFIX!r}")
        self.name = name
        self.nbytes = int(nbytes)
        self.seconds = 0.0
        self._rf = _RecordFunctionFast(name)

    def __enter__(self) -> "span":
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        self.seconds = ns * 1e-9
        with _lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += ns
            t[2] += self.nbytes


def totals() -> dict[str, dict]:
    """{name: {"calls", "seconds", "bytes"}} of every span closed since the
    last ``reset()``, in the order each name first closed."""
    with _lock:
        return {k: {"calls": c, "seconds": ns * 1e-9, "bytes": b}
                for k, (c, ns, b) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()
