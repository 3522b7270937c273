"""The device's idle share over the traced slice of a training window:
one minus the union of its kernel, copy and fill intervals."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
