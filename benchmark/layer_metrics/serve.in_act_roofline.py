"""sdt::in_act (csrc/in_act.cu): the least time of one call's IN layers after
the stem at the cell's shape (counts/in_act.py) over their device time per
call, in %. Its rows are the kernel's own, by name; a program without the
kernel has none, and gives nothing."""

import re

from benchmark import counts
from benchmark.counts import in_act, mel

KERNEL = re.compile(r"\bin_act_kernel\b")


def read(ctx):
    seconds = sum(s for name, (s, _) in ctx["rows"].items() if KERNEL.search(name))
    calls = ctx["work"].get("calls", 0)
    if seconds <= 0 or not calls:
        return None
    model = ctx["config"]["model"]
    flops, nbytes = in_act.count(ctx["work"]["batch"], mel.frames(ctx["work"]["samples"]),
                                 model["num_frames"], 2 if model["precision"] == "bf16" else 4)
    return 100.0 * counts.bound_s(flops, nbytes) / (seconds / calls)
