"""The serving forward's model operations per second in the traced window
over the bf16 peak, in %."""

from benchmark.layer_metrics.common import mfu


def read(ctx):
    return mfu(ctx, "forward_per_clip")
