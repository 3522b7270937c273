"""Kernel launches a training step: the kernel events of the traced slice
(the kernels of replayed CUDA graphs included) over the steps it holds."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.units or not t.launches:
        return None
    return t.launches / t.units
