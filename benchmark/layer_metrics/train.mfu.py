"""The train step's model operations (generator forward and backward, the
pose encoder's two forwards, the mel) per second in the traced window over the
bf16 peak, in %."""

from benchmark.layer_metrics.common import mfu


def read(ctx):
    return mfu(ctx, "train_step_per_clip")
