"""Test fixture: a metric that only the fixture's benchmark names."""


def read(ctx: dict) -> float | None:
    return len(ctx["batches"]) / ctx["window_s"]
