"""The mean wait of a request in the window, from its due time to the
start of its predict call (the benchmark's own span)."""


def read(ctx):
    w = ctx.spans.get("queue_wait_s")
    if not w:
        return None
    return 1e3 * sum(w) / len(w)
