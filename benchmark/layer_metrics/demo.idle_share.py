"""The share of the traced window in which no operation ran on the card, in %."""

from benchmark.layer_metrics.common import idle_share


def read(ctx):
    return idle_share(ctx)
