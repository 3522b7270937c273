"""The whole training step's share of the card's float32 peak: the model
FLOPs of the slice's steps (metrics/work/<model>.py: forward x 3 over the
real atoms) over the traced slice's seconds and the data-sheet 67 TFLOP/s
(benchmark.frozen.PEAK_F32_FLOPS; TF32 is off)."""

from benchmark import frozen


def read(ctx):
    t, w = ctx.trace, ctx.work
    if t is None or w is None or not t.units or not w["flops"]:
        return None
    return 100.0 * w["flops"] * t.units / t.window_s / frozen.PEAK_F32_FLOPS
