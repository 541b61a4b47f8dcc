"""K2's share of its roofline (%): the first launch of each traced batch
(``nsp_cluster_kernel``), against the first pass's work from the
benchmark's own CFL plan (``roofline.k2_flop_per_image_step`` times each
row's steps; the masks' and frames' bytes) at the peaks of ``roofline``
(165 TFLOP/s, 3.35 TB/s). The dt/2 retries' launches are left out:
``retry_share`` counts them."""

from portbench.metrics._kernel_share import share


def read(ctx: dict) -> float | None:
    return share(ctx, "k2", "nsp_cluster_kernel", first_only=True)
