"""The dt/2 retries' share of K2's device time (%): the device seconds of
the ``nsp_cluster_kernel`` events that lie inside the program's
``pregen.masked.retry`` spans (a retry attempt's launch, its fetch and its
reorder; ``pregen_pde_tpu_torch/utils/trace.py``), over those of every
``nsp_cluster_kernel`` event inside the window's batch spans. A window with
no retry reads 0; a program without the masked entry's spans reads
nothing."""

from portbench import trace

KERNEL = "nsp_cluster_kernel"


def read(ctx: dict) -> float | None:
    host = ctx["host"]
    if not any(name == "pregen.masked.k2" for name, _, _ in host):
        return None

    def seconds(spans) -> float:
        return sum(e - s for span in spans for _, s, e in trace.in_span(ctx["dev"], span, KERNEL))

    total = seconds(ctx["spans"])
    if total <= 0:
        return None
    retries = [(s, e) for name, s, e in host if name == "pregen.masked.retry"]
    return 100.0 * seconds(retries) / total
