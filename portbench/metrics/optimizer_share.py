"""The optimizer's share of a training window (%): the union of the
program's ``pregen.train.optimizer`` spans (``Trainer.train_step``'s clip
and tiered AdamW, as the host enqueues them;
``pregen_pde_tpu_torch/utils/trace.py``), clipped to the window, over the
window's seconds. A program without the span reads nothing."""

from portbench import trace

SPAN = "pregen.train.optimizer"


def read(ctx: dict) -> float | None:
    lo, hi = ctx["window"]
    spans = [(s, e) for name, s, e in ctx["host"] if name == SPAN]
    if hi <= lo or not spans:
        return None
    return 100.0 * sum(e - s for s, e in trace.merged(trace.clip(spans, lo, hi))) / (hi - lo)
