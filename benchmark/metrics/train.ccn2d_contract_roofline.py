"""CCN-2D's promotion-contraction against its roofline: the least time of
the slice's promotion-contraction work, forward and backward
(metrics/work/ccn2d.py, counted from the layer's shapes), over the device
time of the kernels that carry it out, found by these names."""

KERNELS = ("ccn2d_forward", "ccn2d_backward")


def read(ctx):
    t, w = ctx.trace, ctx.work
    if t is None or w is None or "ccn2d_contract" not in w["bounds"]:
        return None
    device_us = t.kernel_time_us(*KERNELS)
    if not device_us:
        return None
    return 100.0 * w["bounds"]["ccn2d_contract"] * t.units / (device_us * 1e-6)
