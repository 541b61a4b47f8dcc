"""K4's share of its roofline over a training window (%): the least time of
each traced step's K4 calls, the window attention of the Swin layers wider
than K3 takes (scOT-B's 16 stage-3 layers: n 16, 24 heads, hd 32), forward
and backward (``scot_roofline.k4_forward``, ``k4_backward``), over the
device time of K4's kernels inside the batch spans. A window with no K4
kernel, or a driver that counts no K4 call, reads nothing."""

from portbench.scot_roofline import K4_KERNELS, kernel_share


def read(ctx: dict) -> float | None:
    return kernel_share(ctx, K4_KERNELS, "k4_bound_s")
