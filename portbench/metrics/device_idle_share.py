"""The device's idle share of the traced window (%): one minus the union
of the device events' intervals (kernels and copies) over the window."""

from portbench import trace


def read(ctx: dict) -> float | None:
    lo, hi = ctx["window"]
    if hi <= lo or not ctx["dev"]:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(ctx["dev"], lo, hi) / (hi - lo))
