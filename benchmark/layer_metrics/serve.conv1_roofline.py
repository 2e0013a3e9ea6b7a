"""B3 (csrc/conv1.cu): the least time of one call at the cell's shape
(counts/conv1.py) over its device time per call, in %."""

from benchmark.counts import conv1, mel
from benchmark.layer_metrics.common import roofline


def read(ctx):
    return roofline(ctx, "B3 conv1+IN1", lambda b, s: conv1.count(b, mel.frames(s)))
