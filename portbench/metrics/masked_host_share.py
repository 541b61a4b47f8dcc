"""The masked pipeline's host share of the traced window (%): the union of
the intervals of the masked batch entry's host-only spans (the program's
``pregen.masked.`` inputs, plan, reorder, finite and assemble spans, at any
nesting; ``pregen_pde_tpu_torch/utils/trace.py``), clipped to the window,
over the window's seconds. A program without those spans reads nothing."""

from portbench import trace

HOST_SPANS = tuple(f"pregen.masked.{p}" for p in ("inputs", "plan", "reorder", "finite",
                                                  "assemble"))


def read(ctx: dict) -> float | None:
    lo, hi = ctx["window"]
    spans = [(s, e) for name, s, e in ctx["host"] if name in HOST_SPANS]
    if hi <= lo or not spans:
        return None
    return 100.0 * sum(e - s for s, e in trace.merged(trace.clip(spans, lo, hi))) / (hi - lo)
