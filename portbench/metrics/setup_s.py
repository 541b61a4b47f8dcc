"""Seconds from the process's start (the kernel's clock) to the first timed
batch: imports, the card, the kernels' build or load, the inputs drawn from
the seed, and the warm-up batch."""


def read(ctx: dict) -> float | None:
    return ctx["setup_s"]
