"""Rows delivered over the window's seconds on the host's clock: all the
window's work over all its time.

A row is one row of what a driver's ``run`` returns, and it is delivered
when every value in it is finite. For a generator a row is a trajectory.
For a training driver a row is one sample of the step's batch, delivered
only when that step's loss and its updated parameters are finite, so a
training cell's ``traj_per_s`` is samples per second."""


def read(ctx: dict) -> float | None:
    return ctx["delivered"] / ctx["window_s"] if ctx["window_s"] > 0 else None
