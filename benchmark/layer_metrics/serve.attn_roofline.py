"""The speech encoder's attention (flash attention through SDPA on the
card): its least time a call at the cell's shape (counts/speech_encoder.py)
over the device time a call of the attention kernel's rows, by the name the
card prints, in %. None where no such rows ran or the configuration has no
speech encoder."""

import re

from benchmark import counts
from benchmark.counts import speech_encoder

KERNEL = re.compile(r"\bflash_fwd\w*kernel\b")


def read(ctx):
    model = ctx["config"]["model"]
    calls = ctx["work"].get("calls", 0)
    seconds = sum(s for name, (s, _) in ctx["rows"].items() if KERNEL.search(name))
    if "hidden_size" not in model or seconds <= 0 or not calls:
        return None
    flops, nbytes = speech_encoder.attention_count(model, ctx["work"]["batch"],
                                                   ctx["work"]["samples"],
                                                   2 if model["precision"] == "bf16" else 4)
    return 100.0 * counts.bound_s(flops, nbytes) / (seconds / calls)
