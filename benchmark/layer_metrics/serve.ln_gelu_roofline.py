"""sdt::ln_gelu (csrc/ln_gelu.cu): the least time of one call's seven
feature-encoder norms of the speech encoder at the cell's shape
(counts/ln_gelu.py) over their device time per call, in %. Its rows are the
kernel's own, by name; a program without the kernel has none, and gives
nothing, as does a configuration without a feature encoder (no
``conv_dim``)."""

import re

from benchmark import counts
from benchmark.counts import ln_gelu

KERNEL = re.compile(r"\bln_gelu_kernel\b")


def read(ctx):
    model = ctx["config"]["model"]
    seconds = sum(s for name, (s, _) in ctx["rows"].items() if KERNEL.search(name))
    calls = ctx["work"].get("calls", 0)
    if "conv_dim" not in model or seconds <= 0 or not calls:
        return None
    flops, nbytes = ln_gelu.count(model, ctx["work"]["batch"], ctx["work"]["samples"],
                                  2 if model["precision"] == "bf16" else 4)
    return 100.0 * counts.bound_s(flops, nbytes) / (seconds / calls)
