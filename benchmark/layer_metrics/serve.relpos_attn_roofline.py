"""The speech encoder's gated relative-position attention (the forced
biased SDPA backend on the card): the least time a call of its attention at
the cell's shape (counts/wavlm.py: the operations and Q, K, V and O once, no
bias) over the device time a call of cuDNN's attention rows, by the names
the card prints for them (``cudnn_generated_...sdpa...``), in %. The rows of
the generic ops that build each layer's bias from the table and the gate (a
batched matmul, elementwise products) are not in it. None where no such rows
ran or the configuration has no relative-position bias."""

import re

from benchmark import counts
from benchmark.counts import wavlm

KERNEL = re.compile(r"cudnn\w*(sdpa|fmha)|(sdpa|fmha)\w*cudnn")


def read(ctx):
    model = ctx["config"]["model"]
    calls = ctx["work"].get("calls", 0)
    seconds = sum(s for name, (s, _) in ctx["rows"].items() if KERNEL.search(name))
    if not model.get("num_buckets") or seconds <= 0 or not calls:
        return None
    flops, nbytes = wavlm.attention_count(model, ctx["work"]["batch"], ctx["work"]["samples"],
                                          2 if model["precision"] == "bf16" else 4)
    return 100.0 * counts.bound_s(flops, nbytes) / (seconds / calls)
