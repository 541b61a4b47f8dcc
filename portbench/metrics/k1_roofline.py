"""K1's share of its roofline (%): the CN+AB2 work of the traced batches
(``roofline.k1_flop_per_image_step`` times each row's steps, which the
driver works out from the benchmark's own schedules; w0, ν and the fields'
bytes) at the peaks of ``roofline``, over the device time of the
``sns_cluster_kernel`` events. Peaks: 165 TFLOP/s, 3.35 TB/s."""

from portbench.metrics._kernel_share import share


def read(ctx: dict) -> float | None:
    return share(ctx, "k1", "sns_cluster_kernel", first_only=False)
