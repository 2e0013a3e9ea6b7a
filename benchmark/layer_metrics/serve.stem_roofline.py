"""B2 (csrc/stem.cu): the least time of one call at the cell's shape
(counts/stem.py) over its device time per call, in %."""

from benchmark.counts import mel, stem
from benchmark.layer_metrics.common import roofline


def read(ctx):
    return roofline(ctx, "B2 stem", lambda b, s: stem.count(b, mel.frames(s)))
