"""A kernel's share of its roofline over a traced window, shared by the
``*_roofline`` readers: the least time the card could take for the calls'
work (``roofline.bound_seconds`` of each batch's counted FLOP and bytes),
over the device time of the kernel's events in those batches."""

from __future__ import annotations

from portbench import roofline, trace


def share(ctx: dict, kernel: str, pattern: str, first_only: bool) -> float | None:
    """``kernel`` names the model the driver counted the batch's work by
    ("k1", "k2"); ``pattern`` is the kernel's name in the trace. With
    ``first_only`` only the first launch of each batch counts (a retry's
    launches are left out)."""
    spent = bound = 0.0
    for span, b in zip(ctx["spans"], ctx["batches"]):
        if b["kernel"] != kernel:
            continue
        ev = trace.in_span(ctx["dev"], span, pattern)
        if not ev:
            continue
        if first_only:
            ev = ev[:1]
        spent += sum(e - s for _, s, e in ev)
        bound += roofline.bound_seconds(b["kernel_flop"], b["kernel_bytes"])
    return 100.0 * bound / spent if spent > 0 else None
