"""The whole batch's share of the peak (%): the kernel FLOP that the
delivered (finite) trajectories need, by the algorithm's count in
``roofline`` (K1's or K2's first pass, whichever the driver counted), over
the traced window's seconds times 165 TFLOP/s. It still bounds a gain once
a later change takes a kernel off the path."""

from portbench import roofline


def read(ctx: dict) -> float | None:
    lo, hi = ctx["window"]
    flop = sum(b["delivered_flop"] for b in ctx["batches"])
    if hi <= lo or flop <= 0:
        return None
    return 100.0 * flop / ((hi - lo) * roofline.PEAK_FLOPS)
