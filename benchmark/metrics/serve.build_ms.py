"""The batch build's host time a request: the benchmark's span around
ServingModel.build_batch (the padded batch or the chi tables, and its
copy to the card), summed over a request's chunks, averaged over the
window's requests."""


def read(ctx):
    b = ctx.spans.get("build_s")
    if not b:
        return None
    return 1e3 * sum(b) / len(b)
