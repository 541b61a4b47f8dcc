"""The device's peak of allocated memory over the window (GiB), from the
CUDA caching allocator's counter (``torch.cuda.max_memory_allocated``, reset
when the window opens), read by the benchmark."""


def read(ctx: dict) -> float | None:
    return ctx["memory_peak_bytes"] / 2**30 if ctx["memory_peak_bytes"] > 0 else None
