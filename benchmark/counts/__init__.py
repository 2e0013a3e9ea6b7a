"""Operation and byte counts, functions of the configurations' shapes alone:
the same whatever implements a layer. Bytes: each input byte read once and
each output byte written once. Operations: the least the function needs,
convolutions at 2 x MACs, the mel at the FFT's count. Shares are taken
against ``peaks.json``; operations against the bf16 peak."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def bound_s(flops: float, nbytes: float, chip: str = "H100_SXM") -> float:
    """The least time the chip could take: the larger of the two bounds."""
    p = PEAKS[chip]
    return max(flops / p["bf16_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
