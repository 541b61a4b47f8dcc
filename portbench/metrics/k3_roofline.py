"""K3's share of its roofline over a training window (%): the least time of
each traced step's K3 calls, 48 forward and 48 backward in scOT-B (the
Swin layers of C ≤ 384), each the larger of its FLOP at 165 TFLOP/s and
its bytes at 3.35 TB/s (``scot_roofline.k3_forward``, ``k3_backward``),
over the device time of K3's kernels inside the batch spans. A window with
no K3 kernel, or a driver that counts no K3 call, reads nothing."""

from portbench.scot_roofline import K3_KERNELS, kernel_share


def read(ctx: dict) -> float | None:
    return kernel_share(ctx, K3_KERNELS, "k3_bound_s")
