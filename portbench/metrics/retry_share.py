"""The share of trajectories the masked pipeline re-ran at dt/2 (%), from
the program's own counter ``retried_trajectories`` over the window: work
spent again."""


def read(ctx: dict) -> float | None:
    c = ctx["counters"]
    if "retried_trajectories" not in c or not c.get("trajectories"):
        return None
    return 100.0 * c["retried_trajectories"] / c["trajectories"]
