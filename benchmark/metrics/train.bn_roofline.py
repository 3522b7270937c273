"""The batch norm's kernels against their roofline: the least time of the
slice's batch-norm work, forward and backward (metrics/work/<model>.py's
``bounds["bn"]``: each call's inputs and outputs once at their padded
shapes over the card's HBM), over the device time of the kernels that
carry it out (ops/csrc/bn_fused.cu), found by these names."""

KERNELS = ("bn_forward", "bn_backward")


def read(ctx):
    t, w = ctx.trace, ctx.work
    if t is None or w is None or "bn" not in w["bounds"]:
        return None
    device_us = t.kernel_time_us(*KERNELS)
    if not device_us:
        return None
    return 100.0 * w["bounds"]["bn"] * t.units / (device_us * 1e-6)
