"""Trajectories delivered (every value finite) over the window's seconds on
the host's clock: all the window's work over all its time."""


def read(ctx: dict) -> float | None:
    return ctx["delivered"] / ctx["window_s"] if ctx["window_s"] > 0 else None
