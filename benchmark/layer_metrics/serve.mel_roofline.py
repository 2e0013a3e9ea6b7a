"""B1 (csrc/mel.cu): the least time of one call at the cell's shape
(counts/mel.py) over its device time per call, in %."""

from benchmark.counts import mel
from benchmark.layer_metrics.common import roofline


def read(ctx):
    return roofline(ctx, "B1 mel", mel.count)
