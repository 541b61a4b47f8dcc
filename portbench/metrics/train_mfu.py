"""The training step's share of the peak (%): the delivered samples times
the model's training FLOP a sample (three forwards' products, counted layer
by layer from the configuration by ``scot_roofline.train_flop_per_sample``),
over the traced window's seconds times 165 TFLOP/s. It counts the work the
model needs, whatever runs it, so it still bounds a gain once a kernel
leaves the path."""

from portbench import roofline


def read(ctx: dict) -> float | None:
    lo, hi = ctx["window"]
    flop = sum(b.get("delivered_flop", 0.0) for b in ctx["batches"])
    if hi <= lo or flop <= 0:
        return None
    return 100.0 * flop / ((hi - lo) * roofline.PEAK_FLOPS)
